"""Both attention kernels' plain versions at head_dim 256 (Gemma-2) against
the JAX TPU kernels run in interpret mode, with a window, softcap 50 and
sm_scale = 144**-0.5 (a scale other than head_dim**-0.5), in fp pools and
int8 pools, f32 and bf16.

- decode: ragged_paged_attention_decode with a burst window;
- prefill: ragged_paged_attention_prefill with fused_write=True; the pools
  (and int8 scales) after the write are byte-identical to the JAX kernel's.

Tolerances are the JAX kernel tests': f32 2e-5 (the two fold the online
softmax in another order), bf16 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops import quant as jquant
from production_stack_tpu.ops.pallas.paged_attention import ragged_paged_attention_decode
from production_stack_tpu.ops.pallas.prefill_attention import ragged_paged_attention_prefill
from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
D, NH, KH, PAGE = 256, 4, 2, 8
GEMMA = dict(window=12, logit_softcap=50.0, sm_scale=144.0**-0.5)
FP = ("q", "kc", "vc")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).copy())


def _pools(rng, L, P, quant):
    """fp pools (unit normal), or int8 pools quantized page by page from
    unit-normal pages with their [L, P, KH] scales."""
    if not quant:
        return {k: rng.randn(L, P, PAGE, KH, D).astype(np.float32) for k in ("kp", "vp")}
    out = {}
    for name in ("k", "v"):
        x = rng.randn(L, P, PAGE, KH, D).astype(np.float32)
        q = np.zeros(x.shape, np.int8)
        s = np.ones((L, P, KH), np.float32)
        for p in range(P):
            q[:, p], s[:, p] = jquant.quantize_page_host(x[:, p])
        out[name + "p"], out[name + "s"] = q, s
    return out


def _to(arrs, dtype):
    """(JAX arrays, port tensors): q and the chunk/window K/V in ``dtype``,
    the rest as they are."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v, jd) if k in FP or v.dtype == np.float32 and k in ("kp", "vp") else jnp.asarray(v)
         for k, v in arrs.items()}
    t = {k: _t(v).to(td) if k in FP or v.dtype == np.float32 and k in ("kp", "vp") else _t(v)
         for k, v in arrs.items()}
    return j, t


def _same(a, b) -> bool:
    a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    b = np.asarray(b)
    b = b.view(np.int16) if b.dtype.name == "bfloat16" else b
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


MODES = [(dtype, quant) for dtype in ("float32", "bfloat16") for quant in (False, True)]
IDS = [f"{dtype}-{'int8' if quant else 'fp'}" for dtype, quant in MODES]


@pytest.mark.parametrize("dtype,quant", MODES, ids=IDS)
def test_decode_plain_version_matches_jax_kernel_at_d256(dtype, quant):
    """Ragged rows (one empty), a burst window with cur_len < C, a stacked
    pool's last layer, a window that hides the rows' first slots."""
    rng = np.random.RandomState(21)
    B, maxp, P, C, L = 3, 5, 16, 4, 2
    arrs = _pools(rng, L, P, quant)
    arrs.update(
        q=rng.randn(B, NH, D).astype(np.float32),
        pt=rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32),
        kc=rng.randn(B, C, KH, D).astype(np.float32),
        vc=rng.randn(B, C, KH, D).astype(np.float32),
    )
    lens, cur = [0, 9, 37], [0, 2, 4]
    j, t = _to(arrs, dtype)
    scales_j = dict(k_scales=j["ks"], v_scales=j["vs"]) if quant else {}
    scales_t = dict(k_scales=t["ks"], v_scales=t["vs"]) if quant else {}
    ref = ragged_paged_attention_decode(
        j["q"], j["kp"], j["vp"], j["pt"], jnp.asarray(lens, jnp.int32), interpret=True, layer=L - 1,
        k_cur=j["kc"], v_cur=j["vc"], cur_lens=jnp.asarray(cur, jnp.int32), **scales_j, **GEMMA,
    )
    out = dmod.decode_attention(
        t["q"], t["kp"], t["vp"], t["pt"], torch.tensor(lens, dtype=torch.int32), layer=L - 1,
        k_cur=t["kc"], v_cur=t["vc"], cur_lens=torch.tensor(cur, dtype=torch.int32), **scales_t, **GEMMA,
    )
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL[dtype])
    np.testing.assert_array_equal(out[0], 0.0)


@pytest.mark.parametrize("dtype,quant", MODES, ids=IDS)
def test_prefill_plain_version_matches_jax_kernel_at_d256_with_fused_write(dtype, quant):
    """A history row whose chunk starts mid-page (the int8 head page clips
    into its scale), a first chunk, and a padded row; the window hides the
    history's first slots from the chunk's later tokens."""
    rng = np.random.RandomState(22)
    B, T, maxp, P, L = 3, 16, 5, 16, 1
    computed, chunks = (13, 0, 0), (16, 11, 0)
    arrs = _pools(rng, L, P, quant)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos[b, : chunks[b]] = np.arange(computed[b], computed[b] + chunks[b])
    arrs.update(
        q=rng.randn(B, T, NH, D).astype(np.float32),
        pt=rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32),
        pos=pos,
        lens=np.array([c + n for c, n in zip(computed, chunks)], np.int32),
        kc=rng.randn(B, T, KH, D).astype(np.float32),
        vc=rng.randn(B, T, KH, D).astype(np.float32),
        cl=np.array(chunks, np.int32),
    )
    order = ("q", "kp", "vp", "pt", "pos", "lens", "kc", "vc", "cl")
    j, t = _to(arrs, dtype)
    if quant:
        jout, *jpools = ragged_paged_attention_prefill(
            *(j[k] for k in order), interpret=True, fused_write=True, q_block=16,
            k_scales=j["ks"], v_scales=j["vs"], layer=0, **GEMMA,
        )
        tpools = [t["kp"], t["vp"], t["ks"], t["vs"]]
        out = pmod.prefill_attention(*(t[k] for k in order), fused_write=True, k_scales=t["ks"], v_scales=t["vs"],
                                     layer=0, **GEMMA)
    else:
        jout, *jpools = ragged_paged_attention_prefill(
            *(j[k] for k in order), interpret=True, fused_write=True, q_block=16, layer=0, **GEMMA,
        )
        tpools = [t["kp"], t["vp"]]
        out = pmod.prefill_attention(*(t[k] for k in order), fused_write=True, layer=0, **GEMMA)
    out, ref = out.float().numpy(), np.asarray(jout, np.float32)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL[dtype])
    np.testing.assert_array_equal(out[2], 0.0)  # the padded row
    for a, b in zip(tpools, jpools):
        assert _same(a, b)  # pools (and scales) byte-identical after the fused write


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_split_plan_at_d256_fills_one_wave(quant):
    """fp pools at D = 256 run one decode block per SM (the tensor-core
    fold's ring takes 202 KB), so the plan aims at SMS blocks; int8 pools
    (100 KB) keep two per SM. Tiles stay 64 slots, no split under a tile."""
    target = dmod.SMS if not quant else dmod.TARGET_BLOCKS
    for B, KH, maxp, page in ((1, 4, 129, 64), (32, 4, 16, 64), (8, 4, 17, 64), (256, 8, 16, 16), (1, 1, 2, 16)):
        plan = dmod.split_plan(B, KH, maxp, page, D, quant)
        cap_tiles = -(-(maxp * page) // plan.tile)
        assert plan.tile == 64
        assert plan.splits == max(1, min(target // (B * KH), cap_tiles))
        assert B * KH * plan.splits <= max(target, B * KH)
