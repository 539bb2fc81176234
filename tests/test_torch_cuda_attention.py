"""The port's CUDA attention kernels against their plain PyTorch versions, on
the card only: the decode kernel (and its split merge), the prefill kernel
with the chunk's KV write in the same launch (held to the writes' plain
versions, kv_page_write_ref and kv_page_write_quant_ref), in fp pools (f32,
bf16) and int8 pools, at head_dim 64, 128 and 256 (Gemma-2: window 4,096 or
a short one, softcap 50, sm_scale = 144**-0.5), and at the served models'
head groups: qwen2.5-7b's (D = 128, 7 query heads per KV head) and
opt-125m's (D = 64, one query head per KV head).

This file imports neither jax nor the JAX package, so it runs on the card's
machine (``pytest -m cuda tests/test_torch_cuda_attention.py``); without a
card every test skips. Tolerances: 1e-4 in f32 (another summation order),
3e-2 in bf16; pools and scales after a write byte-identical; two decode
calls on the same inputs give the same bytes. Scores that reach the
softcap (D = 256, q x 20) are held to |out - ref| <= 2^-6 |ref| + 0.02
mean|ref|, as ``chip_smoke.py``'s TOL_CAPPED.
"""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
GEMMA = dict(logit_softcap=50.0, sm_scale=144.0**-0.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA attention kernels went unchecked here "
                    "(run pytest -m cuda on the card; chip_smoke.py checks them too)")
    return torch.device("cuda")


def _int8(x):
    """Pages [..., P, page, KH, D] quantized page by page: int8 values and
    [..., P, KH] f32 scales (amax / 127 over the page's slots and D)."""
    scale = (np.abs(x).max(axis=(-3, -1)) / 127.0).astype(np.float32) + np.float32(1e-6)
    return np.clip(np.rint(x / scale[..., None, :, None]), -127, 127).astype(np.int8), scale


def _on(x, dtype, device):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return (t.to(dtype) if t.dtype == torch.float32 else t).to(device)


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _pools(rng, shape, quant, dtype, device):
    """(k_pages, v_pages, scale kwargs) on the card."""
    k, v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    if not quant:
        return _on(k, dtype, device), _on(v, dtype, device), {}
    (kq, ks), (vq, vs) = _int8(k), _int8(v)
    return _on(kq, dtype, device), _on(vq, dtype, device), dict(k_scales=_on(ks, torch.float32, device),
                                                                v_scales=_on(vs, torch.float32, device))


# -- decode ------------------------------------------------------------------------

DECODE_CASES = {
    # name: (B, NH, KH, D, page, maxp, L, C, lens, cur_lens, extra kwargs)
    "burst_window_softcap_d64": (4, 32, 8, 64, 16, 8, 2, 8, [0, 17, 64, 128], [0, 8, 3, 8],
                                 dict(window=50, logit_softcap=30.0)),
    "split_edges_ragged_d64": (3, 32, 8, 64, 16, 45, 1, 8, [0, 40, 700], [0, 3, 8], {}),
    "split_edges_deep_window_g1_d128": (2, 4, 4, 128, 16, 44, 1, 2, [690, 300], [2, 1],
                                        dict(window=100, logit_softcap=20.0)),
    "split_edges_g8_page48": (2, 32, 4, 64, 48, 19, 1, 8, [900, 333], [6, 8], {}),
    # gemma-2-2b's heads: ragged rows with the burst, the 4,096 window
    # biting, and an empty row
    "d256_ragged_burst_window": (4, 8, 4, 256, 64, 72, 2, 8, [0, 9, 700, 4500], [0, 8, 3, 5],
                                 dict(GEMMA, window=4096)),
    # one row at 8,192 behind the window: the split shares start 4,096 in
    "d256_one_row_8192_sliding": (1, 8, 4, 256, 64, 129, 1, 8, [8192], [8], dict(GEMMA, window=4096)),
    # the burst on a row whose last split has no pool slot; a global layer
    "d256_burst_last_split_empty_global": (3, 8, 4, 256, 64, 24, 1, 8, [30, 1500, 900], [3, 5, 8], GEMMA),
    # qwen2.5-7b's heads (NH = 28, KH = 4): its decode burst step at 32 x
    # 1,024, one row at 8,192, and ragged rows with an empty one
    "qwen_b32_ctx1024_g7_d128": (32, 28, 4, 128, 64, 16, 1, 8, [1024] * 32, [8] * 32, {}),
    "qwen_one_row_8192_g7_d128": (1, 28, 4, 128, 64, 129, 1, 8, [8192], [8], {}),
    "qwen_ragged_burst_g7_d128": (3, 28, 4, 128, 64, 24, 2, 8, [0, 900, 1500], [0, 8, 5], {}),
    # opt-125m's heads (NH = KH = 12): ragged rows with an empty one
    "opt_ragged_burst_g1_d64": (4, 12, 12, 64, 64, 17, 2, 8, [0, 9, 300, 1024], [0, 8, 3, 8], {}),
}


def _decode_inputs(name, dtype, quant, device, q_scale=1.0):
    """(q, k_pages, v_pages, page_table, lens) and the call's kwargs."""
    B, NH, KH, D, page, maxp, L, C, lens, cur, extra = DECODE_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), quant, dtype, device)
    pt = _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), dtype, device)
    q = _on(rng.randn(B, NH, D).astype(np.float32) * np.float32(q_scale), dtype, device)
    kc = _on(rng.randn(B, C, KH, D).astype(np.float32), dtype, device)
    vc = _on(rng.randn(B, C, KH, D).astype(np.float32), dtype, device)
    kw = dict(k_cur=kc, v_cur=vc, cur_lens=torch.tensor(cur, dtype=torch.int32, device=device), layer=L - 1,
              **skw, **extra)
    return (q, kp, vp, pt, torch.tensor(lens, dtype=torch.int32, device=device)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain_version(cuda_device, name, dtype, quant):
    (q, kp, vp, pt, lens), kw = _decode_inputs(name, getattr(torch, dtype), quant, cuda_device)
    launches = dmod.decode_attention.launches + dmod.decode_attention.launches_int8
    out = dmod.decode_attention(q, kp, vp, pt, lens, **kw)
    again = dmod.decode_attention(q, kp, vp, pt, lens, **kw)
    ref = dmod.decode_attention_ref(q, kp, vp, pt, lens, **kw)
    torch.cuda.synchronize()
    assert dmod.decode_attention.launches + dmod.decode_attention.launches_int8 == launches + 2
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert _same(out, again)  # no atomics: the same bytes every call
    for b, n in enumerate(lens.tolist()):
        if n == 0:
            assert float(out[b].float().abs().max()) == 0.0


# -- prefill with the fused write, and the writes alone -----------------------------

PREFILL_CASES = {
    # name: (B, T, NH, KH, D, page, maxp, L, computed, chunks, extra kwargs)
    "layer_window_softcap_d64": (3, 64, 32, 8, 64, 16, 8, 2, (37, 0, 5), (64, 40, 0),
                                 dict(layer=1, window=40, logit_softcap=30.0)),
    "g1_d128": (2, 150, 4, 4, 128, 16, 16, 1, (70, 3), (150, 131), {}),
    "g7_d128": (2, 50, 28, 4, 128, 16, 8, 1, (45, 16), (50, 37), {}),
    "g8_d64": (2, 40, 32, 4, 64, 16, 8, 1, (20, 0), (40, 33), {}),
    "page48_unaligned_history_d64": (2, 96, 32, 8, 64, 48, 8, 1, (101, 29), (96, 70), {}),
    # gemma-2-2b's heads: 32-key tiles, Q read by wgmma from shared memory
    "d256_history_unaligned_layer1": (3, 64, 8, 4, 256, 16, 10, 2, (37, 64, 5), (64, 59, 51), dict(GEMMA, layer=1)),
    "d256_first_chunk_padded_row": (3, 48, 8, 4, 256, 64, 2, 1, (0, 0, 0), (48, 17, 0), GEMMA),
    "d256_window_bites": (2, 96, 8, 4, 256, 64, 72, 1, (4200, 30), (96, 70), dict(GEMMA, window=4096)),
    "d256_page48_unaligned_history": (2, 96, 8, 4, 256, 48, 8, 1, (101, 29), (96, 70), GEMMA),
    # qwen2.5-7b's heads: its 512-token chunk after 1,536, and ragged rows
    # (one padded) in a stacked pool
    "qwen_t512_h1536_g7_d128": (1, 512, 28, 4, 128, 64, 32, 1, (1536,), (512,), {}),
    "qwen_ragged_padded_row_g7_d128": (3, 96, 28, 4, 128, 16, 16, 2, (100, 0, 37), (96, 61, 0), dict(layer=1)),
    # opt-125m's heads: a 3-token chunk (the JAX OPT runs XLA below 16
    # tokens, the port this kernel), and its 512-token chunk after 1,536
    "opt_t3_chunk_g1_d64": (2, 3, 12, 12, 64, 16, 4, 1, (20, 0), (3, 2), {}),
    "opt_t512_h1536_g1_d64": (1, 512, 12, 12, 64, 64, 32, 1, (1536,), (512,), {}),
}


# The write's partition over the launch's blocks: fp pools write each
# block's own tokens, int8 pools hand row b's page tasks to the lowest
# x-blocks first. Head groups G = 1, 4, 7, 8 (and gemma-2's 2) at D = 64,
# 128 and 256; a 3-token chunk (one x-block, two pages), chunks ending
# mid-page, unaligned head pages, B = 2 with a padded row, and pages larger
# than the f32 kernel's staging room.
WRITE_CASES = {
    "write_t3_two_pages_g1_d64": (2, 3, 12, 12, 64, 16, 4, 1, (15, 0), (3, 2), {}),
    "write_t3_two_pages_padded_row_g2_d256": (2, 3, 8, 4, 256, 16, 4, 1, (14, 0), (3, 0), GEMMA),
    "write_t3_two_pages_g1_d128": (1, 3, 4, 4, 128, 64, 2, 1, (62,), (3,), {}),
    "write_ends_mid_page_g4_d64": (2, 64, 32, 8, 64, 16, 8, 1, (32, 16), (50, 37), {}),
    "write_unaligned_head_page_g7_d64": (2, 20, 28, 4, 64, 16, 4, 1, (7, 0), (20, 13), {}),
    "write_unaligned_head_padded_row_g7_d128": (2, 96, 28, 4, 128, 16, 16, 2, (37, 0), (96, 0), dict(layer=1)),
    "write_unaligned_head_page_g8_d64": (2, 40, 32, 4, 64, 16, 8, 1, (21, 5), (40, 33), {}),
    "write_unaligned_head_mid_page_g2_d256": (2, 64, 8, 4, 256, 16, 10, 2, (37, 5), (60, 51), dict(GEMMA, layer=1)),
    # pages of 128 slots: the f32 kernel stages an int8 page task in slabs of
    # 64 (its K and V tiles), an unaligned head page and a fresh one
    "write_page128_slabs_g4_d64": (2, 40, 32, 8, 64, 128, 2, 1, (100, 0), (40, 33), {}),
}


def _prefill_inputs(name, dtype, quant, device, q_scale=1.0):
    B, T, NH, KH, D, page, maxp, L, computed, chunks, extra = {**PREFILL_CASES, **WRITE_CASES}[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), quant, dtype, device)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos[b, : chunks[b]] = np.arange(computed[b], computed[b] + chunks[b])
    args = [
        _on(rng.randn(B, T, NH, D).astype(np.float32) * np.float32(q_scale), dtype, device), kp, vp,
        _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), dtype, device),
        _on(pos, dtype, device),
        _on(np.array([c + n for c, n in zip(computed, chunks)], np.int32), dtype, device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), dtype, device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), dtype, device),
        _on(np.array(chunks, np.int32), dtype, device),
    ]
    return args, skw, dict(extra)


def _copies(args, skw):
    """Fresh copies of the pools (and scales) the write updates in place."""
    args = list(args)
    args[1], args[2] = args[1].clone(), args[2].clone()
    return args, {k: v.clone() for k, v in skw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_kernel_and_fused_write_match_plain_versions(cuda_device, name, dtype, quant):
    args, skw, kw = _prefill_inputs(name, getattr(torch, dtype), quant, cuda_device)
    a, sa = _copies(args, skw)
    r, sr = _copies(args, skw)
    out = pmod.prefill_attention(*a, fused_write=True, **sa, **kw)
    ref = pmod.prefill_attention_ref(*r, fused_write=True, **sr, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert _same(a[1], r[1]) and _same(a[2], r[2])
    assert all(_same(sa[k], sr[k]) for k in sa)
    for b, c in enumerate(PREFILL_CASES[name][9]):
        if c == 0:
            assert float(out[b].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["kv_page_write", "kv_page_write_quant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PREFILL_CASES) + sorted(WRITE_CASES))
def test_kv_write_kernels_alone_match_plain_versions(cuda_device, name, dtype, quant):
    """The write inside the prefill launch against its plain version alone:
    the fp write, or the quantizing write (aligned chunks, chunks ending
    mid-page, unaligned head pages, other layers untouched, as the cases give
    them), pools and scales byte-identical, in one launch; the same launch
    without the write leaves pools and scales untouched and gives the same
    attention bytes."""
    args, skw, kw = _prefill_inputs(name, getattr(torch, dtype), quant, cuda_device)
    layer = kw.get("layer", 0)
    a, sa = _copies(args, skw)
    r, sr = _copies(args, skw)
    counters = ("launches_int8", "launches_write_int8") if quant else ("launches", "launches_write")
    before = [getattr(pmod.prefill_attention, k) for k in counters]
    out = pmod.prefill_attention(*a, fused_write=True, **sa, **kw)
    torch.cuda.synchronize()
    assert [getattr(pmod.prefill_attention, k) for k in counters] == [n + 1 for n in before]  # one launch
    _, _, _, pt, pos, lens, kc, vc, cl = args
    if quant:
        pmod.kv_page_write_quant_ref(kc, vc, lens, cl, pt, r[1], r[2], layer=layer, **sr)
    else:
        pmod.kv_page_write_ref(kc, vc, pos, cl, pt, r[1], r[2], layer=layer)
    assert _same(a[1], r[1]) and _same(a[2], r[2])
    assert all(_same(sa[k], sr[k]) for k in sa)
    for i in range(args[1].shape[0]):
        if i != layer:
            assert _same(a[1][i], args[1][i]) and _same(a[2][i], args[2][i])
    torch.testing.assert_close(out.float(), pmod.prefill_attention_ref(*args, **skw, **kw).float(), **TOL[dtype])
    c, sc = _copies(args, skw)
    alone = pmod.prefill_attention(*c, fused_write=False, **sc, **kw)
    torch.cuda.synchronize()
    assert _same(c[1], args[1]) and _same(c[2], args[2]) and all(_same(sc[k], skw[k]) for k in sc)
    assert _same(alone, out)


# -- scores that reach the softcap (D = 256) ----------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_capped_scores_d256(cuda_device, kernel, quant):
    """q x 20 gives scores of std ~27 before gemma-2's cap of 50, so the
    keys that carry each softmax sit where tanh bends. The bound takes 0.02
    of mean|ref|, not bf16's 3e-2: a tanh with a relative error of 2^-11
    would move a capped score by up to 0.024 and p by up to 2.4%."""
    if kernel == "decode":  # rows of up to 1,500 keys on a global layer
        args, kw = _decode_inputs("d256_burst_last_split_empty_global", torch.bfloat16, quant, cuda_device,
                                  q_scale=20.0)
        out = dmod.decode_attention(*args, **kw)
        ref = dmod.decode_attention_ref(*args, **kw)
    else:
        # 4,200 tokens of history behind the 4,096 window
        args, skw, kw = _prefill_inputs("d256_window_bites", torch.bfloat16, quant, cuda_device, q_scale=20.0)
        out = pmod.prefill_attention(*args, **skw, **kw)
        ref = pmod.prefill_attention_ref(*args, **skw, **kw)
    torch.cuda.synchronize()
    d, r = (out.float() - ref.float()).abs(), ref.float().abs()
    bound = 2.0**-6 * r + 0.02 * r.mean()
    assert bool((d <= bound).all()), f"error {float(d.max())}, ratio to the bound {float((d / bound).max())}"
