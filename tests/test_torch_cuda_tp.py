"""The CUDA attention kernels at the per-rank head shapes of tensor-parallel
serving, on the card only: each tp rank runs the decode kernel through
``decode_attention_sharded`` and the prefill kernel (with the chunk's KV
write in its launch) on NH/tp query heads and KH/tp KV heads, shapes no
tp = 1 model gives. Held to their plain versions as
tests/test_torch_cuda_attention.py holds the tp = 1 shapes (same
tolerances; two decode calls give the same bytes; pools and scales after
the write byte-identical), in bf16 pools and int8 pools.

This file imports neither jax nor the JAX package; without a card every
test skips.
"""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod
from test_torch_cuda_attention import GEMMA, TOL, _copies, _on, _pools, _same, cuda_device  # noqa: F401

# rank shapes: (tp, NH/tp, KH/tp, D, extra kwargs)
RANK_SHAPES = {
    "llama-3.2-1b_tp2": (2, 16, 4, 64, {}),
    "llama-3.2-1b_tp4": (4, 8, 2, 64, {}),
    "qwen2.5-7b_tp2": (2, 14, 2, 128, {}),
    "gemma-2-2b_tp2": (2, 4, 2, 256, dict(GEMMA, window=4096)),
    "opt-125m_tp2": (2, 6, 6, 64, {}),
}


def _decode_inputs(name, quant, device):
    tp, NH, KH, D, extra = RANK_SHAPES[name]
    B, page, maxp, L, C = 8, 64, 17, 2, 8
    rng = np.random.RandomState(sum(map(ord, name)))
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), quant, torch.bfloat16, device)
    pt = _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, device)
    q = _on(rng.randn(B, NH, D).astype(np.float32), torch.bfloat16, device)
    kc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, device)
    vc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, device)
    lens = torch.tensor([0, 9, 300, 1024, 700, 64, 1, 1080], dtype=torch.int32, device=device)
    cur = torch.tensor([0, 8, 3, 8, 5, 8, 1, 8], dtype=torch.int32, device=device)
    kw = dict(k_cur=kc, v_cur=vc, cur_lens=cur, layer=1, tp=tp, **skw, **extra)
    return (q, kp, vp, pt, lens), kw


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(RANK_SHAPES))
def test_sharded_decode_at_rank_shapes_matches_plain_version(cuda_device, name, quant):
    args, kw = _decode_inputs(name, quant, cuda_device)
    launches = dmod.decode_attention.launches + dmod.decode_attention.launches_int8
    out = dmod.decode_attention_sharded(*args, **kw)
    again = dmod.decode_attention_sharded(*args, **kw)
    ref = dmod.decode_attention_sharded(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert dmod.decode_attention.launches + dmod.decode_attention.launches_int8 == launches + 2
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
    assert _same(out, again)
    assert float(out[0].float().abs().max()) == 0.0  # the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(RANK_SHAPES))
def test_prefill_and_fused_write_at_rank_shapes_match_plain_versions(cuda_device, name, quant):
    tp, NH, KH, D, extra = RANK_SHAPES[name]
    B, T, page, maxp, L = 3, 96, 16, 16, 2
    computed, chunks = (100, 0, 37), (96, 61, 0)
    rng = np.random.RandomState(sum(map(ord, name)) + 1)
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), quant, torch.bfloat16, cuda_device)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos[b, : chunks[b]] = np.arange(computed[b], computed[b] + chunks[b])
    args = [
        _on(rng.randn(B, T, NH, D).astype(np.float32), torch.bfloat16, cuda_device), kp, vp,
        _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, cuda_device),
        _on(pos, torch.bfloat16, cuda_device),
        _on(np.array([c + n for c, n in zip(computed, chunks)], np.int32), torch.bfloat16, cuda_device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), torch.bfloat16, cuda_device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), torch.bfloat16, cuda_device),
        _on(np.array(chunks, np.int32), torch.bfloat16, cuda_device),
    ]
    kw = dict(extra, layer=1)
    kw.pop("window", None)
    ka, sa = _copies(args, skw)
    kb, sb = _copies(args, skw)
    out = pmod.prefill_attention(*ka, fused_write=True, **sa, **kw)
    ref = pmod.prefill_attention_ref(*kb, fused_write=True, **sb, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
    assert _same(ka[1], kb[1]) and _same(ka[2], kb[2])
    for k in sa:
        assert _same(sa[k], sb[k]), k
