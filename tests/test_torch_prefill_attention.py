"""The prefill kernel's plain version (prefill_attention_ref, with the fused
KV write as the plain scatter) against the JAX TPU kernel
ragged_paged_attention_prefill(interpret=True, fused_write=True), on the
cases of tests/test_pallas_prefill.py.

Attention outputs agree to 2e-5 in f32 (another fold order) and 3e-2 in
bf16; the pools after the fused write must be byte-identical to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops import quant as jquant
from production_stack_tpu.ops.pallas.prefill_attention import ragged_paged_attention_prefill
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _case(B, T, computed, chunks, page=8, maxp=8, P=64, NH=8, KH=2, D=64, L=None, seed=0):
    """Row b has computed[b] tokens in its pages and a chunk of chunks[b]
    fresh tokens (0 = padded row); numpy f32 arrays."""
    rng = np.random.RandomState(seed)
    lead = () if L is None else (L,)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos[b, : chunks[b]] = np.arange(computed[b], computed[b] + chunks[b])
    return {
        "q": rng.randn(B, T, NH, D).astype(np.float32),
        "kp": rng.randn(*lead, P, page, KH, D).astype(np.float32),
        "vp": rng.randn(*lead, P, page, KH, D).astype(np.float32),
        "pt": rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32),
        "pos": pos,
        "lens": np.array([c + n for c, n in zip(computed, chunks)], np.int32),
        "kc": rng.randn(B, T, KH, D).astype(np.float32),
        "vc": rng.randn(B, T, KH, D).astype(np.float32),
        "cl": np.array(chunks, np.int32),
    }


ORDER = ("q", "kp", "vp", "pt", "pos", "lens", "kc", "vc", "cl")


def _both(arrs, dtype="float32", **kw):
    """(port out, port pools, JAX out, JAX pools), all numpy."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(arrs[k], jd if arrs[k].dtype == np.float32 else jnp.int32) for k in ORDER]
    t = [torch.from_numpy(arrs[k].copy()).to(td if arrs[k].dtype == np.float32 else torch.int32) for k in ORDER]
    jout, jk, jv = ragged_paged_attention_prefill(*j, interpret=True, fused_write=True, q_block=16, **kw)
    tout = pmod.prefill_attention_ref(*t, fused_write=True, **kw)
    as_np = lambda x: x.float().numpy()  # noqa: E731
    return (
        as_np(tout), (t[1], t[2]),
        np.asarray(jout, np.float32), (np.asarray(jk), np.asarray(jv)),
    )


def _pool_bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


# the f32 cases share one shape (B=3, T=16) so the JAX kernel compiles once
CASES = {
    "unaligned_start_with_history": (dict(B=3, T=16, computed=(5, 13, 40), chunks=(16, 11, 7), seed=1), {}),
    "first_chunk_partial_tail_padded_row": (dict(B=3, T=16, computed=(0, 3, 0), chunks=(10, 13, 0), seed=2), {}),
    "window_softcap": (
        dict(B=2, T=16, computed=(20, 33), chunks=(16, 12), seed=3),
        dict(window=12, logit_softcap=30.0),
    ),
    "bf16": (dict(B=2, T=16, computed=(8, 16), chunks=(16, 14), seed=4), dict(dtype="bfloat16")),
    "stacked_layer": (dict(B=2, T=16, computed=(8, 16), chunks=(16, 12), L=3, seed=5), dict(layer=1)),
    # the edges of the CUDA kernel's tiles, whose warpgroups hold 64 // G
    # tokens x G heads: one head per KV head at D = 128, 7 heads (64 rows
    # do not divide), 8 heads, a chunk that is no multiple of 64 // G, and a
    # window whose first visible history slot is not page-aligned
    "g1_d128": (dict(B=2, T=16, computed=(5, 20), chunks=(16, 9), NH=2, KH=2, D=128, seed=12), {}),
    "g7": (dict(B=2, T=16, computed=(11, 30), chunks=(16, 13), NH=28, KH=4, seed=13), {}),
    "g8": (dict(B=2, T=16, computed=(7, 24), chunks=(16, 10), NH=16, KH=2, seed=14), {}),
    "chunk_not_multiple_of_tpw": (dict(B=2, T=32, computed=(3, 17), chunks=(27, 19), seed=15), {}),
    "window_unaligned_first_slot": (
        dict(B=2, T=16, computed=(29, 43), chunks=(16, 11), seed=16),
        dict(window=13),
    ),
    # a page size that is no power of two, history not page-aligned
    "page_not_power_of_two": (dict(B=2, T=16, computed=(13, 25), chunks=(16, 9), page=6, seed=22), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_kernel_and_pool_bytes(name):
    case_kw, kw = CASES[name]
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")
    arrs = _case(**case_kw)
    out, (tk, tv), ref, (jk, jv) = _both(arrs, dtype, **kw)
    np.testing.assert_allclose(out, ref, **TOL[dtype])
    assert _pool_bytes(tk) == _pool_bytes(jk)
    assert _pool_bytes(tv) == _pool_bytes(jv)
    for b, c in enumerate(case_kw["chunks"]):
        if c == 0:
            np.testing.assert_array_equal(out[b], 0.0)


def test_nan_poisoned_stale_slots():
    """Slots at or after each row's chunk start are stale during attention;
    NaN there must not reach the output, and the write leaves the pools
    byte-identical to JAX's (NaN bytes beyond the chunk included)."""
    arrs = _case(B=3, T=16, computed=(24, 8, 3), chunks=(16, 12, 9), seed=8)
    clean, _, _, _ = _both(arrs)
    page = arrs["kp"].shape[1]
    for b in range(3):
        start = int(arrs["lens"][b] - arrs["cl"][b])
        for lp in range(start // page, arrs["pt"].shape[1]):
            s0 = max(start - lp * page, 0)
            arrs["kp"][arrs["pt"][b, lp], s0:] = np.nan
            arrs["vp"][arrs["pt"][b, lp], s0:] = np.nan
    out, (tk, tv), ref, (jk, jv) = _both(arrs)
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    np.testing.assert_array_equal(out, clean)
    np.testing.assert_allclose(out, ref, **TOL["float32"])
    assert _pool_bytes(tk) == _pool_bytes(jk)
    assert _pool_bytes(tv) == _pool_bytes(jv)


def test_wrappers_take_the_plain_versions_only_for_cpu_tensors():
    arrs = _case(B=2, T=16, computed=(8, 0), chunks=(16, 5), seed=9)
    t = [torch.from_numpy(arrs[k].copy()) for k in ORDER]
    t2 = [x.clone() for x in t]
    counts = (pmod.prefill_attention_ref.calls, pmod.kv_page_write_ref.calls)
    launches = (pmod.prefill_attention.launches, pmod.prefill_attention.launches_write)
    out = pmod.prefill_attention(*t, fused_write=True)
    ref = pmod.prefill_attention_ref(*t2, fused_write=True)
    assert (pmod.prefill_attention_ref.calls, pmod.kv_page_write_ref.calls) == (counts[0] + 2, counts[1] + 2)
    assert (pmod.prefill_attention.launches, pmod.prefill_attention.launches_write) == launches
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert torch.equal(t[1], t2[1]) and torch.equal(t[2], t2[2])
    with pytest.raises(TypeError, match="come together"):  # fp pools take no scales
        pmod.prefill_attention(*t, k_scales=torch.ones(64, 2))


def test_write_covers_only_the_valid_chunk_entries():
    """The fp write (kv_page_write_ref, the fused write's plain version)
    writes entries j < cur_lens at positions[b, j] and nothing else: a
    position past cur_len (never made by the scheduler) is not written."""
    arrs = _case(B=1, T=8, computed=(3,), chunks=(5,), seed=10)
    t = {k: torch.from_numpy(arrs[k].copy()) for k in ORDER}
    pos = t["pos"].clone()
    pos[0, 5:] = torch.arange(8, 11)  # beyond cur_len: must stay unwritten
    kp0 = t["kp"].clone()
    pmod.kv_page_write_ref(t["kc"], t["vc"], pos, t["cl"], t["pt"], t["kp"], t["vp"])
    flat = t["kp"].view(-1, *t["kp"].shape[2:])
    for j in range(8):
        p = int(pos[0, j])
        slot = int(t["pt"][0, p // 8]) * 8 + p % 8
        want = t["kc"][0, j] if j < 5 else kp0.view(-1, *kp0.shape[2:])[slot]
        assert torch.equal(flat[slot], want)


# the fused write's flag on CPU tensors: a 3-token chunk over two pages
# (opt-sized chunks), and B = 2 with a padded row and an unaligned head page
FLAG_CASES = {
    "t3_two_pages": dict(B=2, T=3, computed=(6, 0), chunks=(3, 2), seed=30),
    "padded_row_unaligned_head_page": dict(B=2, T=16, computed=(13, 0), chunks=(16, 0), seed=31),
}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("name", sorted(FLAG_CASES))
def test_fused_write_flag_on_cpu_tensors_matches_jax_pools(name, quant):
    """fused_write=False leaves the pools (and scales) byte-for-byte
    untouched; fused_write=True leaves them as the JAX kernel's fused write
    does (interpret mode): fp pools, or int8 pools and their scales."""
    arrs = _case(**FLAG_CASES[name])
    scales = {}
    if quant:  # int8 pools quantized page by page, scales [P, KH]
        arrs["kp"], scales["k_scales"] = jquant.quantize_page_host(arrs["kp"])
        arrs["vp"], scales["v_scales"] = jquant.quantize_page_host(arrs["vp"])
    t = [torch.from_numpy(arrs[k].copy()) for k in ORDER]
    ts = {k: torch.from_numpy(v.copy()) for k, v in scales.items()}
    pools = lambda: [_pool_bytes(x) for x in (t[1], t[2], *ts.values())]  # noqa: E731
    before = pools()
    pmod.prefill_attention(*t, fused_write=False, **ts)
    assert pools() == before
    pmod.prefill_attention(*t, fused_write=True, **ts)
    jres = ragged_paged_attention_prefill(
        *(jnp.asarray(arrs[k]) for k in ORDER), interpret=True, fused_write=True, q_block=16,
        **{k: jnp.asarray(v) for k, v in scales.items()},
    )
    assert pools() == [_pool_bytes(np.asarray(x)) for x in jres[1:]]
    assert pools() != before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA prefill and KV-write kernels went unchecked here (chip_smoke.py checks them on the card)")
    return torch.device("cuda")


# on the card: a stacked layer with window and softcap, and the tile edges
# and page sizes of chip_smoke.py's prefill cases
CUDA_CASES = {
    "layer_window_softcap": (
        dict(B=3, T=64, computed=(37, 0, 5), chunks=(64, 40, 0), page=16, maxp=8, P=40, NH=32, KH=8, D=64, L=2,
             seed=11),
        dict(layer=1, window=40, logit_softcap=30.0),
    ),
    "g1_d128": (dict(B=2, T=150, computed=(70, 3), chunks=(150, 131), page=16, maxp=16, NH=4, KH=4, D=128,
                     seed=17), {}),
    "g7_d128": (dict(B=2, T=50, computed=(45, 16), chunks=(50, 37), page=16, maxp=8, NH=28, KH=4, D=128,
                     seed=18), {}),
    "g8": (dict(B=2, T=40, computed=(20, 0), chunks=(40, 33), page=16, maxp=8, NH=32, KH=4, seed=19), {}),
    "chunk_not_multiple_of_tpw": (dict(B=2, T=80, computed=(100, 64), chunks=(77, 45), page=64, maxp=4, NH=32,
                                       KH=8, seed=20), {}),
    "window_unaligned_first_slot": (dict(B=2, T=64, computed=(150, 99), chunks=(64, 50), page=16, maxp=16,
                                         NH=32, KH=8, seed=21), dict(window=45)),
    "page48_unaligned_history": (dict(B=2, T=96, computed=(101, 29), chunks=(96, 70), page=48, maxp=8, NH=32,
                                      KH=8, seed=23), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_kernels_match_plain_versions(cuda_device, name, dtype):
    case_kw, kw = CUDA_CASES[name]
    arrs = _case(**case_kw)
    td = getattr(torch, dtype)
    t = [torch.from_numpy(arrs[k]).to(td if arrs[k].dtype == np.float32 else torch.int32).to(cuda_device) for k in ORDER]
    t2 = [x.clone() for x in t]
    out = pmod.prefill_attention(*t, fused_write=True, **kw)
    ref = pmod.prefill_attention_ref(*t2, fused_write=True, **kw)
    tol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(t[1].view(torch.uint8), t2[1].view(torch.uint8))
    assert torch.equal(t[2].view(torch.uint8), t2[2].view(torch.uint8))
