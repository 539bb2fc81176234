"""int8 KV pools in the port against the JAX package, on the CPU.

- ops/quant.py: the host quantizers and the decode commit
  (write_kv_pages_all_layers_quant) give the JAX functions' exact bytes:
  int8 pools byte-identical, scales bitwise equal.
- The kernels' plain int8 versions against the JAX Pallas kernels run in
  interpret mode: decode and prefill outputs within 2e-5 (f32; the two fold
  in another order) or 3e-2 (bf16), and the quantizing chunk write leaves
  pools and scales byte-identical to the JAX kernel's fused int8 write.
- The llama forward and ModelRunner with int8 pools against JAX's: logits,
  pools and scales, greedy tokens over a prefill and two bursts.
- The engine: the int8 surface on /stats, twice the pages, and the v3
  offload boundary (kvoffload/), bit-exact both ways across the packages.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops import quant as jquant
from production_stack_tpu.ops.pallas.paged_attention import ragged_paged_attention_decode
from production_stack_tpu.ops.pallas.prefill_attention import ragged_paged_attention_prefill
from production_stack_tpu_torch.ops import quant as tquant
from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).copy())


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _quant_pools(rng, L, P, page, KH, D):
    """int8 pools and scales [L, P, KH] from unit-normal fp pages, quantized
    page by page (quantize_page_host)."""
    q = np.zeros((2, L, P, page, KH, D), np.int8)
    s = np.ones((2, L, P, KH), np.float32)
    for i in range(2):
        x = rng.randn(L, P, page, KH, D).astype(np.float32)
        for p in range(P):
            q[i, :, p], s[i, :, p] = jquant.quantize_page_host(x[:, p])
    return q[0], q[1], s[0], s[1]


# -- ops/quant.py ---------------------------------------------------------------


def test_host_quantizers_give_the_jax_bytes():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 16, 4, 32) * rng.uniform(0.1, 8, (2, 1, 4, 1))).astype(np.float32)
    x[1, :, 2] = 0.0  # an all-zero head: the 1e-8 floor
    q, s = tquant.quantize_page_host(x)
    jq, js = jquant.quantize_page_host(x)
    assert _same(q, jq) and _same(s, js)
    assert _same(tquant.dequantize_page_host(q, s), jquant.dequantize_page_host(jq, js))
    for args in ((16, 8, 64, 64, True, 2), (16, 8, 64, 64, False, 2), (2, 4, 32, 8, True, 4)):
        assert tquant.kv_bytes_per_token(*args) == jquant.kv_bytes_per_token(*args)


def test_gather_dequant_matches_jax():
    rng = np.random.RandomState(2)
    qk, qv, sk, sv = _quant_pools(rng, 1, 5, 4, 2, 8)
    pt = np.array([[0, 2], [1, 3]], np.int32)
    k, v = tquant.gather_kv_pages_quant(_t(qk[0]), _t(qv[0]), _t(sk[0]), _t(sv[0]), _t(pt))
    jk, jv = jquant.gather_kv_pages_quant(*(jnp.asarray(a) for a in (qk[0], qv[0], sk[0], sv[0], pt)))
    assert _same(k.numpy(), jk) and _same(v.numpy(), jv)


# the JAX commit as the JAX runner runs it: compiled (XLA turns amax / 127
# into a multiply by f32(1 / 127) there, and ops/quant.py follows it)
_jax_commit = jax.jit(jquant.write_kv_pages_all_layers_quant)


def _commit_both(state, k_new, v_new, pt, pos):
    """One write_kv_pages_all_layers_quant on both sides; ``state`` is the
    (torch, jax) pair of (k_pages, v_pages, k_scales, v_scales)."""
    t, j = state
    tquant.write_kv_pages_all_layers_quant(*t, _t(k_new), _t(v_new), _t(pt), _t(pos))
    j = _jax_commit(*j, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pt), jnp.asarray(pos))
    for a, b in zip(t, j):
        assert _same(a.numpy(), b)
    return t, j


def _fresh_state(L, P, page, KH, D, scale=1.0):
    t = (
        torch.zeros((L, P, page, KH, D), dtype=torch.int8), torch.zeros((L, P, page, KH, D), dtype=torch.int8),
        tquant.init_kv_scales(L, P, KH) * scale, tquant.init_kv_scales(L, P, KH) * scale,
    )
    return t, tuple(jnp.asarray(x.numpy()) for x in t)


def test_commit_fresh_pages_dead_rows_and_padding_match_jax():
    rng = np.random.RandomState(3)
    L, P, page, KH, D = 2, 12, 4, 2, 8
    state = _fresh_state(L, P, page, KH, D)
    pt = np.array([[0, 2, 4, 6], [1, 3, 5, 7], [8, 9, 10, 11]], np.int32)
    pos = np.full((3, 10), -1, np.int32)
    pos[0] = np.arange(10)       # three pages from slot 0
    pos[1, :6] = np.arange(6)    # padded tail
    # row 2 is dead (all -1)
    x = rng.randn(2, L, 3, 10, KH, D).astype(np.float32) * 3
    _commit_both(state, x[0], x[1], pt, pos)


def test_commit_growth_requant_and_page_reuse_match_jax():
    """Mid-page appends that grow the scale (the page's int8 content
    requantizes), appends that do not, and a page reused at slot 0 under a
    huge stale scale (reset): the same bytes at every step."""
    rng = np.random.RandomState(4)
    L, P, page, KH, D = 2, 6, 4, 2, 8
    state = _fresh_state(L, P, page, KH, D, scale=100.0)
    pt = np.array([[0, 2, 4], [1, 3, 5]], np.int32)
    for t in range(10):  # decode-style T = 1 appends with growing magnitudes
        x = rng.randn(2, L, 2, 1, KH, D).astype(np.float32) * (1.0 + 0.5 * t) * np.array([1, 0.3])[:, None, None, None, None, None]
        pos = np.array([[t], [t if t % 3 else -1]], np.int32)
        state = _commit_both(state, x[0], x[1], pt, pos)
    # a burst commit: three tokens mid-page, then a page reused from slot 0
    x = rng.randn(2, L, 2, 3, KH, D).astype(np.float32) * 5
    state = _commit_both(state, x[0], x[1], pt, np.array([[10, 11, -1], [5, 6, 7]], np.int32))
    x = rng.randn(2, L, 2, 2, KH, D).astype(np.float32) * 0.01
    _commit_both(state, x[0], x[1], np.array([[2, 0, 4], [3, 1, 5]], np.int32), np.array([[0, 1], [-1, -1]], np.int32))


# -- the decode kernel's int8 mode -------------------------------------------------


def _decode_case(B=3, NH=8, KH=2, D=64, page=8, P=24, maxp=6, L=1, C=0, seed=0):
    rng = np.random.RandomState(seed)
    qk, qv, sk, sv = _quant_pools(rng, L, P, page, KH, D)
    arrs = {
        "q": rng.randn(B, NH, D).astype(np.float32),
        "kp": qk, "vp": qv, "ks": sk, "vs": sv,
        "pt": rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32),
    }
    if C:
        arrs["kc"] = rng.randn(B, C, KH, D).astype(np.float32)
        arrs["vc"] = rng.randn(B, C, KH, D).astype(np.float32)
    return arrs


def _decode_both(arrs, lens, dtype="float32", cur_lens=None, **kw):
    kw.setdefault("layer", 0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fp = ("q", "kc", "vc")
    j = {k: jnp.asarray(v, jd) if k in fp else jnp.asarray(v) for k, v in arrs.items()}
    t = {k: _t(v).to(td) if k in fp else _t(v) for k, v in arrs.items()}
    jkw, tkw = dict(kw), dict(kw)
    if "kc" in arrs:
        jkw.update(k_cur=j["kc"], v_cur=j["vc"])
        tkw.update(k_cur=t["kc"], v_cur=t["vc"])
        if cur_lens is not None:
            jkw["cur_lens"] = jnp.asarray(cur_lens, jnp.int32)
            tkw["cur_lens"] = torch.tensor(cur_lens, dtype=torch.int32)
    ref = ragged_paged_attention_decode(
        j["q"], j["kp"], j["vp"], j["pt"], jnp.asarray(lens, jnp.int32), interpret=True,
        k_scales=j["ks"], v_scales=j["vs"], **jkw,
    )
    out = dmod.decode_attention(
        t["q"], t["kp"], t["vp"], t["pt"], torch.tensor(lens, dtype=torch.int32),
        k_scales=t["ks"], v_scales=t["vs"], **tkw,
    )
    return out.float().numpy(), np.asarray(ref, np.float32)


DECODE_CASES = {
    "ragged_with_padded_row": (dict(B=4, maxp=4, P=32), dict(lens=[5, 0, 19, 32])),
    "window_softcap_current_token": (dict(C=1, seed=6), dict(lens=[5, 23, 48], window=12, logit_softcap=40.0)),
    "burst_window_ragged": (dict(B=4, P=40, maxp=8, C=4, seed=7), dict(lens=[4, 19, 40, 64], cur_lens=[1, 4, 3, 2])),
    "stacked_layer_burst": (dict(B=2, NH=8, KH=4, D=32, P=16, maxp=4, L=3, C=3, seed=10),
                            dict(lens=[6, 29], cur_lens=[3, 2], layer=2)),
    "bf16_burst": (dict(C=8, page=16, maxp=4, seed=8), dict(lens=[8, 30, 64], cur_lens=[8, 5, 1], dtype="bfloat16")),
    # the split-KV edges of the CUDA kernel, at small widths: a window whose
    # first visible slot lies deep in a long row, and ragged rows of 0 and
    # with a short burst
    "window_deep_in_long_row": (dict(B=2, page=16, P=40, maxp=16, C=1, seed=14),
                                dict(lens=[250, 100], window=20, logit_softcap=30.0)),
    "ragged_zero_and_burst": (dict(B=3, page=16, P=40, maxp=12, C=4, seed=15),
                              dict(lens=[0, 5, 180], cur_lens=[0, 2, 3])),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_int8_plain_version_matches_jax_kernel(name):
    case_kw, call = DECODE_CASES[name]
    call = dict(call)
    lens = call.pop("lens")
    out, ref = _decode_both(_decode_case(**case_kw), lens, **call)
    np.testing.assert_allclose(out, ref, **(BF16 if call.get("dtype") == "bfloat16" else F32))
    for b, n in enumerate(lens):
        if n == 0:
            np.testing.assert_array_equal(out[b], 0.0)


def test_decode_int8_never_reads_the_scales_of_stale_pages():
    """A page wholly past a row's live history may hold any scale: NaN there
    leaves the output unchanged."""
    arrs = _decode_case(C=4, seed=11)
    lens, cur = [5, 20, 32], [2, 4, 1]
    clean, _ = _decode_both(arrs, lens, cur_lens=cur)
    for b in range(3):
        for lp in range(-(-(lens[b] - cur[b]) // 8), arrs["pt"].shape[1]):
            arrs["ks"][0, arrs["pt"][b, lp]] = np.nan
            arrs["vs"][0, arrs["pt"][b, lp]] = np.nan
    t = {k: _t(v) for k, v in arrs.items()}
    out = dmod.decode_attention_ref(
        t["q"], t["kp"], t["vp"], t["pt"], torch.tensor(lens, dtype=torch.int32), k_cur=t["kc"], v_cur=t["vc"],
        cur_lens=torch.tensor(cur, dtype=torch.int32), k_scales=t["ks"], v_scales=t["vs"],
    )
    np.testing.assert_array_equal(out.numpy(), clean)


# -- the prefill kernel's int8 modes: history read and quantizing write ----------


def _prefill_case(B, T, computed, chunks, page=8, maxp=6, P=16, NH=4, KH=2, D=32, L=1, seed=0):
    rng = np.random.RandomState(seed)
    qk, qv, sk, sv = _quant_pools(rng, L, P, page, KH, D)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos[b, : chunks[b]] = np.arange(computed[b], computed[b] + chunks[b])
    return {
        "q": rng.randn(B, T, NH, D).astype(np.float32),
        "kp": qk, "vp": qv,
        "pt": rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32),
        "pos": pos,
        "lens": np.array([c + n for c, n in zip(computed, chunks)], np.int32),
        "kc": rng.randn(B, T, KH, D).astype(np.float32) * rng.uniform(0.5, 4, (B, 1, KH, 1)).astype(np.float32),
        "vc": rng.randn(B, T, KH, D).astype(np.float32),
        "cl": np.array(chunks, np.int32),
        "ks": sk, "vs": sv,
    }


ORDER = ("q", "kp", "vp", "pt", "pos", "lens", "kc", "vc", "cl")


def _prefill_both(arrs, dtype="float32", **kw):
    """(port out, port pools+scales, JAX out, JAX pools+scales), numpy."""
    kw.setdefault("layer", 0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fp = ("q", "kc", "vc")
    j = [jnp.asarray(arrs[k], jd) if k in fp else jnp.asarray(arrs[k]) for k in ORDER]
    t = [_t(arrs[k]).to(td) if k in fp else _t(arrs[k]) for k in ORDER]
    ts = (_t(arrs["ks"]), _t(arrs["vs"]))
    jout, jk, jv, jks, jvs = ragged_paged_attention_prefill(
        *j, interpret=True, fused_write=True, q_block=16,
        k_scales=jnp.asarray(arrs["ks"]), v_scales=jnp.asarray(arrs["vs"]), **kw,
    )
    tout = pmod.prefill_attention(*t, fused_write=True, k_scales=ts[0], v_scales=ts[1], **kw)
    port = [x.numpy() for x in (t[1], t[2], *ts)]
    return tout.float().numpy(), port, np.asarray(jout, np.float32), [np.asarray(x) for x in (jk, jv, jks, jvs)]


# the quantizing write's four cases: an aligned chunk, a chunk ending
# mid-page, an unaligned head page, and other layers left untouched
PREFILL_CASES = {
    "aligned_chunk": (dict(B=2, T=16, computed=(16, 24), chunks=(16, 16), seed=1), {}),
    "chunk_ends_mid_page": (dict(B=2, T=16, computed=(16, 8), chunks=(13, 11), seed=2), {}),
    "unaligned_head_page": (dict(B=2, T=16, computed=(12, 20), chunks=(16, 16), seed=3), {}),
    "other_layers_untouched": (dict(B=2, T=16, computed=(5, 16), chunks=(16, 9), L=3, seed=4), dict(layer=1)),
    "window_softcap_padded_row": (
        dict(B=2, T=16, computed=(20, 9), chunks=(16, 0), seed=5), dict(window=12, logit_softcap=30.0),
    ),
    "bf16": (dict(B=2, T=16, computed=(8, 13), chunks=(16, 14), seed=6), dict(dtype="bfloat16")),
}


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_int8_plain_version_matches_jax_kernel_bytes_and_scales(name):
    case_kw, kw = PREFILL_CASES[name]
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")
    arrs = _prefill_case(**case_kw)
    out, port, ref, jax_pools = _prefill_both(arrs, dtype, **kw)
    np.testing.assert_allclose(out, ref, **(BF16 if dtype == "bfloat16" else F32))
    for a, b in zip(port, jax_pools):
        assert _same(a, b)  # int8 pages byte-identical, scales bitwise equal
    layer = kw.get("layer", 0)
    for i in range(case_kw.get("L", 1)):
        if i != layer:
            for a, b in zip(port, (arrs["kp"], arrs["vp"], arrs["ks"], arrs["vs"])):
                assert _same(a[i], b[i])
    for b, c in enumerate(case_kw["chunks"]):
        if c == 0:
            np.testing.assert_array_equal(out[b], 0.0)


def test_quantizing_write_follows_the_kernel_not_the_xla_commit():
    """Where the chunk ends mid-page, the fused write zeroes the fresh tail
    page's slots past the chunk (the XLA commit keeps their old bytes); at an
    unaligned start it clips into the head page's old scale (the XLA commit
    grows it). Both agree on page-aligned chunks."""
    for computed, chunks, differs in (((16, 24), (16, 16), False), ((16, 8), (13, 11), True), ((12, 20), (16, 16), True)):
        arrs = _prefill_case(B=2, T=16, computed=computed, chunks=chunks, seed=7)
        t = {k: _t(v) for k, v in arrs.items()}
        fused = [x.clone() for x in (t["kp"], t["vp"], t["ks"], t["vs"])]
        pmod.kv_page_write_quant_ref(t["kc"], t["vc"], t["lens"], t["cl"], t["pt"], *fused)
        commit = [x.clone() for x in (t["kp"], t["vp"], t["ks"], t["vs"])]
        pos = np.where(np.arange(16)[None] < arrs["cl"][:, None], arrs["pos"], -1).astype(np.int32)
        tquant.write_kv_pages_all_layers_quant(*commit, t["kc"][None], t["vc"][None], t["pt"], _t(pos))
        same = all(torch.equal(a, b) for a, b in zip(fused, commit))
        assert same != differs, (computed, chunks)


def test_wrappers_route_int8_to_the_plain_versions_on_cpu_and_check_scales():
    arrs = _prefill_case(B=2, T=16, computed=(8, 0), chunks=(16, 5), seed=9)
    t = [_t(arrs[k]) for k in ORDER]
    ks, vs = _t(arrs["ks"]), _t(arrs["vs"])
    calls = (pmod.prefill_attention_ref.calls, pmod.kv_page_write_quant_ref.calls, dmod.decode_attention_ref.calls)
    launches = (pmod.prefill_attention.launches_int8, pmod.prefill_attention.launches_write_int8,
                dmod.decode_attention.launches_int8)
    pmod.prefill_attention(*t, fused_write=True, k_scales=ks, v_scales=vs)
    dmod.decode_attention(t[0][:, 0], t[1], t[2], t[3], t[5], k_scales=ks, v_scales=vs)
    assert (pmod.prefill_attention_ref.calls, pmod.kv_page_write_quant_ref.calls,
            dmod.decode_attention_ref.calls) == (calls[0] + 1, calls[1] + 1, calls[2] + 1)
    assert (pmod.prefill_attention.launches_int8, pmod.prefill_attention.launches_write_int8,
            dmod.decode_attention.launches_int8) == launches  # no kernel ran
    with pytest.raises(TypeError, match="int8"):  # int8 pools without their scales
        pmod.prefill_attention(*t)
    with pytest.raises(TypeError, match="int8"):
        dmod.decode_attention(t[0][:, 0], t[1], t[2], t[3], t[5], k_scales=ks)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 modes of the CUDA kernels went unchecked here "
                    "(chip_smoke.py checks them on the card)")
    return torch.device("cuda")


def _on(arrs, keys, dtype, device):
    fp = ("q", "kc", "vc")
    return [_t(arrs[k]).to(dtype if k in fp else _t(arrs[k]).dtype).to(device) for k in keys]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_int8_kernels_match_plain_versions(cuda_device, dtype):
    """The int8 decode and prefill kernels and the quantizing write on the
    card against their plain versions on the same inputs: outputs within
    1e-4 (f32) or 3e-2 (bf16), pools and scales byte-identical."""
    td = getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else BF16
    arrs = _decode_case(B=4, NH=32, KH=8, D=64, page=16, P=40, maxp=8, L=2, C=8, seed=13)
    q, kp, vp, pt, ks, vs, kc, vc = _on(arrs, ("q", "kp", "vp", "pt", "ks", "vs", "kc", "vc"), td, cuda_device)
    kw = dict(k_cur=kc, v_cur=vc, cur_lens=torch.tensor([1, 8, 3, 8], dtype=torch.int32, device=cuda_device),
              layer=1, window=50, logit_softcap=30.0, k_scales=ks, v_scales=vs)
    lens = torch.tensor([0, 17, 64, 128], dtype=torch.int32, device=cuda_device)
    out = dmod.decode_attention(q, kp, vp, pt, lens, **kw)
    torch.testing.assert_close(out.float(), dmod.decode_attention_ref(q, kp, vp, pt, lens, **kw).float(), **tol)

    arrs = _prefill_case(B=3, T=64, computed=(37, 0, 5), chunks=(64, 40, 0), page=16, maxp=8, P=40, NH=32, KH=8,
                         D=64, L=2, seed=11)
    t = _on(arrs, ORDER + ("ks", "vs"), td, cuda_device)
    t2 = [x.clone() for x in t]
    kw = dict(layer=1, fused_write=True, window=40, logit_softcap=30.0)
    out = pmod.prefill_attention(*t[:9], k_scales=t[9], v_scales=t[10], **kw)
    ref = pmod.prefill_attention_ref(*t2[:9], k_scales=t2[9], v_scales=t2[10], **kw)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    for i in (1, 2, 9, 10):  # int8 pools and their scales
        assert torch.equal(t[i].view(torch.uint8), t2[i].view(torch.uint8))


# -- the forward and the runner with int8 pools -----------------------------------

MODEL = "llama-debug-4kv-f32"
PAGE, NUM_PAGES = 8, 24
PT = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)


def _jax_params():
    from production_stack_tpu.models import llama as jllama

    return jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))


def _port_model(params, **cfg_kw):
    from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
    from production_stack_tpu_torch.models import llama as tllama

    _, cfg, model = load_model(MODEL, device="cpu", params=params_from_jax(params, tllama.PRESETS[MODEL]))
    model.cfg = dataclasses.replace(cfg, kv_cache_dtype="int8", **cfg_kw)
    return model


def _chunks(second_start=(16, 11)):
    """Two prefill chunks of a 2-row batch (row 1 ragged and padded), as
    (input_ids, positions, kv_lens)."""
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 512, (2, 40)).astype(np.int32)
    out = []
    for start, n in (((0, 0), second_start), (second_start, (16, 13))):
        pos = np.full((2, 16), -1, np.int32)
        inp = np.zeros((2, 16), np.int32)
        for b in range(2):
            pos[b, : n[b]] = np.arange(start[b], start[b] + n[b])
            inp[b, : n[b]] = ids[b, start[b]: start[b] + n[b]]
        out.append((inp, pos, np.array([start[0] + n[0], start[1] + n[1]], np.int32)))
    return ids, out


# The two frameworks' f32 matmuls sum in another order, so K/V differ in
# the last bits, and now and then that moves a page's scale by an ulp or a
# value across a rounding boundary: 1 LSB (1/127 of the page's amax) in a
# few bytes, which the next layers and steps carry into the logits. Measured
# on these inputs (f32 twin, 2 layers): logits within 3.1e-3 of JAX's (the
# burst steps; 3.4e-4 after the prefill), pool bytes within 1 LSB, scales
# within a relative 5.0e-4 (the runner's, after two bursts of growth). The
# bounds below are about twice that.
FORWARD_TOL = dict(atol=6e-3, rtol=0.0)
POOL_LSB, SCALE_RTOL = 1, 1e-3


def _pools_close(tpools, jpools):
    for a, b in zip(tpools[:2], jpools[:2]):
        assert np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32)).max() <= POOL_LSB
    for a, b in zip(tpools[2:], jpools[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SCALE_RTOL, atol=0)


def test_forward_int8_matches_the_jax_kernels_logits_pools_and_scales():
    """The port's forward (plain int8 versions) against the JAX forward
    through its Pallas kernels in interpret mode (fused int8 prefill write,
    int8 decode), over two prefill chunks (row 1's second chunk starts
    mid-page: the head page clips into its scale) and a 3-step burst with
    its quantizing commit. Byte identity on the same inputs is the kernel
    tests' job; here K/V come out of each framework's own matmuls."""
    from production_stack_tpu.models import llama as jllama

    p = _jax_params()
    cfg_j = dataclasses.replace(jllama.PRESETS[MODEL], attn_impl="pallas_interpret", kv_cache_dtype="int8")
    model = _port_model(p)
    L, KH, D = cfg_j.num_layers, cfg_j.num_kv_heads, cfg_j.head_dim
    shape = (L, NUM_PAGES, PAGE, KH, D)
    tpools = [torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8),
              tquant.init_kv_scales(L, NUM_PAGES, KH), tquant.init_kv_scales(L, NUM_PAGES, KH)]
    jpools = [jnp.asarray(x.numpy()) for x in tpools]
    ids, chunks = _chunks()
    with torch.no_grad():
        for inp, pos, lens in chunks:
            jl, *jpools = jllama.forward(
                p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jpools[0], jpools[1], jnp.asarray(PT),
                jnp.asarray(lens), kv_scales=(jpools[2], jpools[3]),
            )
            tl = model(_t(inp), _t(pos), tpools[0], tpools[1], _t(PT), _t(lens), kv_scales=(tpools[2], tpools[3]))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FORWARD_TOL)
            _pools_close(tpools, jpools)
        C = 3
        jka = jnp.zeros((L, 2, C, KH, D), jnp.float32)
        jva = jnp.zeros_like(jka)
        tka = torch.zeros((L, 2, C, KH, D))
        tva = torch.zeros_like(tka)
        lens0 = chunks[-1][2]
        for s in range(C):
            inp = np.stack([ids[0, 32 + s], ids[1, 24 + s]])[:, None].astype(np.int32)
            pos = (lens0 + s)[:, None].astype(np.int32)
            lens = (lens0 + s + 1).astype(np.int32)
            cnt = np.full((2,), s, np.int32)
            jl, jka, jva = jllama.forward(
                p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jpools[0], jpools[1], jnp.asarray(PT),
                jnp.asarray(lens), kv_burst=(jka, jva, jnp.asarray(cnt)), kv_scales=(jpools[2], jpools[3]),
            )
            tl = model(_t(inp), _t(pos), tpools[0], tpools[1], _t(PT), _t(lens),
                       kv_burst=(tka, tva, _t(cnt)), kv_scales=(tpools[2], tpools[3]))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FORWARD_TOL)
    commit = (lens0[:, None] + np.arange(C)[None]).astype(np.int32)
    jpools = _jax_commit(*jpools, jka, jva, jnp.asarray(PT), jnp.asarray(commit))
    tquant.write_kv_pages_all_layers_quant(*tpools, tka, tva, _t(PT), _t(commit))
    _pools_close(tpools, jpools)


def _step(ids, pos, lens, pt, limits=None, cls=None):
    B = ids.shape[0]
    return cls(
        input_ids=ids, positions=pos, page_table=pt, kv_lens=lens,
        temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
        kv_limits=limits,
    )


def test_runner_int8_greedy_tokens_pages_and_scales_match_jax():
    """ModelRunner with int8 pools against the JAX runner's (its XLA path,
    whose prefill commit is the quantizing scatter: the fused write's
    semantics for page-aligned chunks on a zeroed pool) over a prefill and
    two bursts, both rows stopping mid-burst: the same greedy tokens, and
    pages and scales as close as the forward test holds them."""
    from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
    from production_stack_tpu.engine.runner import StepInput as JaxStepInput
    from production_stack_tpu.models import llama as jllama
    from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput

    p = _jax_params()
    cfg_j = dataclasses.replace(jllama.PRESETS[MODEL], attn_impl="xla", kv_cache_dtype="int8")
    jr = JaxRunner(cfg_j, params=jax.tree.map(jnp.asarray, p), num_pages=NUM_PAGES, page_size=PAGE, seed=0)
    tr = ModelRunner(_port_model(p), num_pages=NUM_PAGES, page_size=PAGE, seed=0, device="cpu")
    assert tr.kv_quant and tr.k_pages.dtype == torch.int8 and tr.k_scales.shape == (2, NUM_PAGES, 4)
    _, chunks = _chunks(second_start=(16, 16))
    got = {}
    for tag, runner, cls in (("jax", jr, JaxStepInput), ("port", tr, StepInput)):
        toks = []
        for inp, pos, lens in chunks:
            ids, _ = runner.step(_step(inp, pos, lens, PT, cls=cls))
        nxt = np.asarray(ids)
        toks.append(nxt)
        lens = chunks[-1][2].copy()
        limits = np.array([37, 33], np.int32)  # both rows stop before the end of burst 2
        for _ in range(2):
            out = np.asarray(runner.step_multi(
                _step(nxt[:, None].astype(np.int32), lens[:, None].astype(np.int32), lens + 1, PT, limits, cls), 4,
            ))
            toks.append(out)
            nxt = out[:, -1]
            lens = lens + 4
        got[tag] = np.concatenate([t.reshape(2, -1) for t in toks], 1)
    # the tokens the host keeps: a burst starting at kv_len l0 yields
    # min(k, kv_limits - l0 + 1) of them; a stopped row's later draws are
    # discarded (and differ by design between attention paths)
    keep = [np.ones((2, 1), bool)]
    for l0 in (chunks[-1][2] + 1, chunks[-1][2] + 5):
        keep.append(np.arange(4)[None] < np.minimum(4, np.array([37, 33]) - l0 + 1)[:, None])
    keep = np.concatenate(keep, 1)
    assert keep.sum() == 11
    np.testing.assert_array_equal(got["port"][keep], got["jax"][keep])
    pids = [0, 1, 2, 3, 4, 5, 6, 7, 8]
    tq, jq = tr.get_pages_quant(pids), jr.get_pages_quant(pids)
    _pools_close([torch.from_numpy(np.stack(x)) for x in tq], [np.stack(x) for x in jq])


def test_runner_quant_page_access_checks_scales_and_reset():
    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.engine.runner import ModelRunner

    _, cfg, model = load_model("llama-debug", device="cpu")
    model.cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    r = ModelRunner(model, num_pages=8, page_size=PAGE, device="cpu")
    rng = np.random.RandomState(5)
    shape = (cfg.num_layers, PAGE, cfg.num_kv_heads, cfg.head_dim)
    ks = [rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2)]
    vs = [rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2)]
    sks = [rng.rand(cfg.num_layers, cfg.num_kv_heads).astype(np.float32) for _ in range(2)]
    svs = [rng.rand(cfg.num_layers, cfg.num_kv_heads).astype(np.float32) for _ in range(2)]
    r.set_pages_quant([6, 2], ks, vs, sks, svs)
    for got, want in zip(r.get_pages_quant([6, 2]), (ks, vs, sks, svs)):
        assert all(_same(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="scales"):
        r.set_pages_quant([1], ks[:1], vs[:1], [np.ones((cfg.num_layers, 1), np.float32)], svs[:1])
    with pytest.raises(ValueError, match="pids"):
        r.set_pages_quant([1, 3], ks, vs, sks[:1], svs)
    assert r.k_pages[:, 1].eq(0).all()  # the refused writes touched nothing
    r.reset_kv()
    assert not r.k_pages.any() and float(r.k_scales.min()) == float(r.v_scales.max()) == 1.0


# -- the engine ----------------------------------------------------------------


def _engine(**kw):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine

    base = dict(model="llama-debug", max_model_len=256, max_num_seqs=8, page_size=8, prefill_chunk=32)
    return LLMEngine(EngineConfig(**dict(base, **kw)), device="cpu")


def _greedy(engine, prompt, n=6):
    from production_stack_tpu_torch.engine.scheduler import SamplingParams

    async def run():
        toks = []
        async for out in engine.generate(
            f"q-{np.random.randint(1 << 30)}", prompt=prompt,
            params=SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True),
        ):
            toks.extend(out.token_ids)
        return toks

    return asyncio.run(run())


def test_engine_int8_stats_and_pool_capacity():
    fp = _engine(kv_cache_memory_gb=0.001)
    q = _engine(kv_cache_memory_gb=0.001, kv_cache_dtype="int8")
    assert q.kv.num_pages >= 1.8 * fp.kv.num_pages  # the same memory holds ~2x the pages
    s = q.stats()
    assert s["cache_dtype"] == "int8" and s["kv_quant_pages"] == q.kv.num_pages
    assert 0 < s["kv_quant_dequant_err_max"] < 0.01
    assert s["kv_cache_dtype_bytes_per_token"] == 2 * 2 * 2 * 32 + 2 * 2 * 2 * 4 / 8
    assert fp.stats()["kv_quant_pages"] == 0 and fp.stats()["kv_cache_dtype_bytes_per_token"] == 2 * 2 * 2 * 32 * 2


@pytest.mark.parametrize("tier", ["cpu", "disk"])
def test_engine_int8_spill_and_restore_repeat_greedy_output(tier, tmp_path):
    """A small pool evicts a prompt's prefix pages to the tier (v3 blobs);
    the same prompt later restores them and repeats its greedy tokens."""
    kw = dict(kv_offload_cpu_gb=0.001) if tier == "cpu" else dict(kv_offload_dir=str(tmp_path), kv_offload_disk_gb=0.01)
    eng = _engine(num_pages=28, kv_cache_dtype="int8", kv_offload_max_io_pages=0, **kw)
    assert eng._offload.serde.name == "int8page" and eng.kv.max_io_pages == 0
    eng.start()
    try:
        prompt = "the quick brown fox jumps over the lazy dog " * 3
        first = _greedy(eng, prompt)
        for i in range(6):
            _greedy(eng, f"filler prompt number {i} with padding text " * 3)
        assert eng._offload.saved_pages > 0
        again = _greedy(eng, prompt)
        s = eng.stats()
    finally:
        eng.stop()
    assert eng.kv.offload_hits > 0 and s["kv_offload_loaded_pages_total"] > 0
    assert again == first
    assert s[f"kv_offload_{tier}_bytes"] > 0 and s["kv_corrupt_pages_total"] == 0


def _jax_runner(name, kv_cache_dtype="auto"):
    from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
    from production_stack_tpu.models import llama as jllama

    cfg = dataclasses.replace(jllama.PRESETS[name], attn_impl="xla", kv_cache_dtype=kv_cache_dtype)
    return JaxRunner(cfg, num_pages=8, page_size=PAGE, seed=0)


def _port_runner(name, kv_cache_dtype="auto"):
    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.engine.runner import ModelRunner

    _, cfg, model = load_model(name, device="cpu")
    model.cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    return ModelRunner(model, num_pages=8, page_size=PAGE, device="cpu")


@pytest.mark.parametrize("name", ["llama-debug", MODEL])
def test_v3_blobs_identical_across_packages_and_restore_both_ways(name):
    """The same int8 pages and scales in the JAX runner's pool and the
    port's serialize to identical v3 blobs through each package's
    connector, and a blob from either restores into the other's pool
    byte-exact."""
    from production_stack_tpu.kvoffload.connector import KVOffloadConnector as JaxConnector
    from production_stack_tpu_torch.kvoffload.connector import KVOffloadConnector

    jr, tr = _jax_runner(name, "int8"), _port_runner(name, "int8")
    rng = np.random.RandomState(6)
    L, KH, D = tr.cfg.num_layers, tr.cfg.num_kv_heads, tr.cfg.head_dim
    pages = [[rng.randint(-127, 128, (L, PAGE, KH, D)).astype(np.int8) for _ in range(3)] for _ in range(2)]
    scales = [[rng.uniform(0.001, 0.1, (L, KH)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    for r in (jr, tr):
        r.set_pages_quant([1, 4, 6], pages[0], pages[1], scales[0], scales[1])
    jc, tc = JaxConnector(jr, cpu_bytes=1 << 20), KVOffloadConnector(tr, cpu_bytes=1 << 20)
    jblobs, tblobs = jc._serialize_pages([1, 4, 6]), tc._serialize_pages([1, 4, 6])
    assert tc.serde.name == "int8page" and jblobs == tblobs
    hashes = [bytes([i]) * 16 for i in range(3)]
    for (src, dst, blobs) in ((jc, tc, jblobs), (tc, jc, tblobs)):
        for h, blob in zip(hashes, blobs):
            dst.store.put(h.hex(), blob)
        assert dst.load_pages(list(zip([0, 2, 3], hashes))) == 3
        for got, want in zip(dst.runner.get_pages_quant([0, 2, 3]), (pages[0], pages[1], scales[0], scales[1])):
            assert all(_same(a, b) for a, b in zip(got, want))
