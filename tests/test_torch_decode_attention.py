"""The decode kernel's plain version (decode_attention_ref) against the JAX
TPU kernel ragged_paged_attention_decode run in interpret mode, on the cases
of tests/test_pallas_attention.py; plus the wrapper's routing and checks.

Tolerances: f32 2e-5 (the two fold the online softmax in another order);
bf16 3e-2 (the JAX kernel's own bf16 bound against its oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops.pallas.paged_attention import ragged_paged_attention_decode
from production_stack_tpu_torch.ops.kernels import decode_attention as dmod

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _case(B=4, NH=8, KH=2, D=128, page=16, P=32, maxp=4, L=None, C=0, seed=0):
    rng = np.random.RandomState(seed)
    lead = () if L is None else (L,)
    arrs = {
        "q": rng.randn(B, NH, D).astype(np.float32),
        "kp": rng.randn(*lead, P, page, KH, D).astype(np.float32),
        "vp": rng.randn(*lead, P, page, KH, D).astype(np.float32),
        "pt": rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32),
    }
    if C:
        arrs["kc"] = rng.randn(B, C, KH, D).astype(np.float32)
        arrs["vc"] = rng.randn(B, C, KH, D).astype(np.float32)
    return arrs


def _both(arrs, lens, dtype="float32", cur_lens=None, **kw):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v, jd if v.dtype == np.float32 else v.dtype) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(td if v.dtype == np.float32 else torch.int32) for k, v in arrs.items()}
    jkw, tkw = dict(kw), dict(kw)
    if "kc" in arrs:
        jkw.update(k_cur=j["kc"], v_cur=j["vc"])
        tkw.update(k_cur=t["kc"], v_cur=t["vc"])
        if cur_lens is not None:
            jkw["cur_lens"] = jnp.asarray(cur_lens, jnp.int32)
            tkw["cur_lens"] = torch.tensor(cur_lens, dtype=torch.int32)
    ref = ragged_paged_attention_decode(
        j["q"], j["kp"], j["vp"], j["pt"], jnp.asarray(lens, jnp.int32), interpret=True, **jkw
    )
    out = dmod.decode_attention_ref(t["q"], t["kp"], t["vp"], t["pt"], torch.tensor(lens, dtype=torch.int32), **tkw)
    return out.float().numpy(), np.asarray(ref, np.float32)


CASES = {
    "ragged_with_padded_row": (dict(), dict(lens=[5, 0, 33, 64])),
    "gqa_d64": (dict(B=3, NH=12, KH=4, D=64, page=8, P=24, maxp=6, seed=1), dict(lens=[1, 24, 48])),
    "bf16": (dict(seed=3), dict(lens=[7, 16, 40, 64], dtype="bfloat16")),
    "window_softcap_current_token": (
        dict(B=3, NH=8, KH=2, D=64, page=8, P=24, maxp=6, C=1, seed=6),
        dict(lens=[5, 23, 48], window=12, logit_softcap=40.0),
    ),
    "burst_window_ragged": (
        dict(B=4, NH=8, KH=2, D=64, page=8, P=40, maxp=8, C=4, seed=7),
        dict(lens=[4, 19, 40, 64], cur_lens=[1, 4, 3, 2]),
    ),
    "burst_window_bf16": (
        dict(B=3, NH=8, KH=2, D=64, page=16, P=24, maxp=4, C=8, seed=8),
        dict(lens=[8, 30, 64], cur_lens=[8, 5, 1], dtype="bfloat16"),
    ),
    "stacked_layer_burst": (
        dict(B=2, NH=8, KH=4, D=32, page=8, P=16, maxp=4, L=3, C=3, seed=10),
        dict(lens=[6, 29], cur_lens=[3, 2], layer=2),
    ),
    # the split-KV edges of the CUDA kernel, at small widths: a window whose
    # first visible slot lies deep in a long row, and ragged rows of 0 and
    # with a short burst
    "window_deep_in_long_row": (
        dict(B=2, NH=8, KH=2, D=64, page=16, P=40, maxp=16, C=1, seed=14),
        dict(lens=[250, 100], window=20, logit_softcap=30.0),
    ),
    "ragged_zero_and_burst": (
        dict(B=3, NH=8, KH=2, D=64, page=16, P=40, maxp=12, C=4, seed=15),
        dict(lens=[0, 5, 180], cur_lens=[0, 2, 3]),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_kernel(name):
    case_kw, call = CASES[name]
    call = dict(call)
    lens = call.pop("lens")
    out, ref = _both(_case(**case_kw), lens, **call)
    np.testing.assert_allclose(out, ref, **TOL[call.get("dtype", "float32")])
    for b, n in enumerate(lens):
        if n == 0:
            np.testing.assert_array_equal(out[b], 0.0)


def test_stale_slots_holding_nan_are_skipped():
    """Pool slots at or after kv_len - cur_len are stale; filled with NaN
    they must not reach the output (0 * NaN would)."""
    arrs = _case(B=3, NH=8, KH=2, D=64, page=8, P=24, maxp=4, C=4, seed=11)
    lens, cur = [5, 20, 32], [2, 4, 1]
    clean, ref = _both(arrs, lens, cur_lens=cur)
    for b in range(3):
        for s in range(lens[b] - cur[b], 32):
            arrs["kp"][arrs["pt"][b, s // 8], s % 8] = np.nan
            arrs["vp"][arrs["pt"][b, s // 8], s % 8] = np.nan
    out, _ = _both(arrs, lens, cur_lens=cur)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL["float32"])
    np.testing.assert_array_equal(out, clean)


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    arrs = _case(B=2, NH=4, KH=2, D=64, page=8, P=8, maxp=2, seed=12)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    lens = torch.tensor([3, 9], dtype=torch.int32)
    calls, launches = dmod.decode_attention_ref.calls, dmod.decode_attention.launches
    out = dmod.decode_attention(t["q"], t["kp"], t["vp"], t["pt"], lens)
    assert dmod.decode_attention_ref.calls == calls + 1
    assert dmod.decode_attention.launches == launches  # no kernel ran
    np.testing.assert_array_equal(out.numpy(), dmod.decode_attention_ref(t["q"], t["kp"], t["vp"], t["pt"], lens).numpy())
    with pytest.raises(TypeError, match="come together"):  # fp pools take no scales
        dmod.decode_attention(t["q"], t["kp"], t["vp"], t["pt"], lens, k_scales=torch.ones(8, 2))


# -- the launch plan -----------------------------------------------------------

DECODE_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)  # the scheduler's decode buckets
PAGE_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _shares(plan, lo, live_end):
    """The kernel's split of a row's live slots [lo, live_end) (row_split in
    csrc/decode_attention.cu): split s takes tiles [s * per, (s + 1) * per)
    of the row's tiles, counted from lo."""
    n_tiles = -(-(live_end - lo) // plan.tile) if live_end > lo else 0
    per = -(-n_tiles // plan.splits)
    out = []
    for s in range(plan.splits):
        t0, t1 = min(s * per, n_tiles), min(s * per + per, n_tiles)
        out.append((lo + t0 * plan.tile, min(lo + t1 * plan.tile, live_end)) if t1 > t0 else None)
    return out


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B", DECODE_BATCH_BUCKETS)
def test_split_plan_covers_each_row_in_whole_tiles(B, quant):
    """For every bucket shape: at least one split, no more splits than the
    bucket's capacity has tiles, about TARGET_BLOCKS blocks; and for any
    seq_lens the one plan gives contiguous shares of whole tiles (only a
    row's last tile cut short) that cover the row's live slots exactly."""
    rng = np.random.RandomState(B)
    for KH in (1, 2, 8):
        for D in (64, 128):
            for page in (16, 48, 64):
                for maxp in PAGE_BUCKETS[::3]:
                    plan = dmod.split_plan(B, KH, maxp, page, D, quant)
                    cap = maxp * page
                    assert plan.tile == (128 if quant and D == 64 else 64)
                    cap_tiles = -(-cap // plan.tile)
                    assert 1 <= plan.splits <= cap_tiles
                    assert B * KH * plan.splits <= max(dmod.TARGET_BLOCKS, B * KH)
                    if plan.splits < cap_tiles:  # not capped by the bucket: the target is reached
                        assert B * KH * (plan.splits + 1) > dmod.TARGET_BLOCKS
                    per = -(-cap_tiles // plan.splits)
                    assert plan.splits * per * plan.tile >= cap  # a full row is covered
                    for _ in range(4):  # the same plan whatever seq_lens holds
                        kv_len = int(rng.randint(0, cap + 1))
                        lo = max(kv_len - int(rng.choice([1 << 30, 1 + rng.randint(cap + 1)])), 0)
                        live_end = min(kv_len - int(rng.randint(0, min(kv_len, 8) + 1)), cap)
                        shares = [sh for sh in _shares(plan, lo, live_end) if sh]
                        bounds = [lo] + [x for sh in shares for x in sh] + [max(live_end, lo)]
                        assert bounds[0::2] == bounds[1::2]  # contiguous, from lo to the live end
                        assert all(b > a for a, b in shares)
                        for a, b in shares[:-1]:
                            assert (a - lo) % plan.tile == 0 and (b - a) % plan.tile == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA decode kernel went unchecked here (chip_smoke.py checks it on the card)")
    return torch.device("cuda")


CUDA_CASES = {
    # name: (case kwargs, lens, cur_lens, window, softcap)
    "burst_window_softcap": (dict(B=4, NH=32, KH=8, D=64, page=16, P=40, maxp=8, L=2, C=8, seed=13),
                             [0, 17, 64, 128], [0, 8, 3, 8], 50, 30.0),
    # many splits, most empty for the short rows
    "split_edges_ragged": (dict(B=3, NH=32, KH=8, D=64, page=16, P=140, maxp=45, L=1, C=8, seed=16),
                           [0, 40, 700], [0, 3, 8], None, None),
    # a window whose first slot lies deep in the row; G = 1 at D = 128
    "split_edges_deep_window_g1_d128": (dict(B=2, NH=4, KH=4, D=128, page=16, P=90, maxp=44, L=1, C=2, seed=17),
                                        [690, 300], [2, 1], 100, 20.0),
    # G = 8, page 48
    "split_edges_g8_page48": (dict(B=2, NH=32, KH=4, D=64, page=48, P=40, maxp=19, L=1, C=8, seed=18),
                              [900, 333], [6, 8], None, None),
}


def _int8_pools(arrs):
    """The case's pools as int8 with per-page, per-KV-head scales."""
    kp, vp = arrs["kp"], arrs["vp"]
    scale = lambda x: (np.abs(x).max(axis=(-3, -1)) / 127.0).astype(np.float32) + 1e-6
    out = {}
    for name, x in (("k", kp), ("v", vp)):
        sc = scale(x)
        out[name + "p"] = np.clip(np.rint(x / sc[..., None, :, None]), -127, 127).astype(np.int8)
        out[name + "s"] = sc
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain_version(cuda_device, name, dtype, quant):
    """The kernel (and its merge) against the plain version, with the split
    edges; two calls on the same inputs give the same bytes."""
    case_kw, lens, cur, window, softcap = CUDA_CASES[name]
    arrs = _case(**case_kw)
    td = getattr(torch, dtype)
    dev = lambda v: torch.from_numpy(v).to(td if v.dtype == np.float32 else torch.int32).to(cuda_device)
    t = {k: dev(v) for k, v in arrs.items()}
    kw = dict(k_cur=t["kc"], v_cur=t["vc"], cur_lens=torch.tensor(cur, dtype=torch.int32, device=cuda_device),
              layer=case_kw["L"] - 1, window=window, logit_softcap=softcap)
    if quant:
        q8 = _int8_pools(arrs)
        t["kp"], t["vp"] = (torch.from_numpy(q8[k]).to(cuda_device) for k in ("kp", "vp"))
        kw.update(k_scales=torch.from_numpy(q8["ks"]).to(cuda_device), v_scales=torch.from_numpy(q8["vs"]).to(cuda_device))
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = dmod.decode_attention(t["q"], t["kp"], t["vp"], t["pt"], lens, **kw)
    again = dmod.decode_attention(t["q"], t["kp"], t["vp"], t["pt"], lens, **kw)
    ref = dmod.decode_attention_ref(t["q"], t["kp"], t["vp"], t["pt"], lens, **kw)
    tol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(out.view(torch.uint8), again.view(torch.uint8))
