"""The port's plain ops against the JAX package's on the same inputs (numpy
from a seeded RandomState, handed to both).

Tolerances: f32 math that both sides compute the same way (rms_norm, rope,
attention in f32) agrees to 2e-5 -- only the summation order differs; index
ops (positions, gathers, the KV commit) must agree exactly, byte for byte;
sampling penalties and logit bias to 1e-6. Sampled draws cannot match: the
port draws from a torch.Generator, JAX from jax.random, so the draws are
checked as a distribution against the exact truncated softmax instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops import attention as jattn
from production_stack_tpu.ops import norms as jnorms
from production_stack_tpu.ops import rope as jrope
from production_stack_tpu.ops import sampling as jsamp
from production_stack_tpu_torch.ops import attention as tattn
from production_stack_tpu_torch.ops import norms as tnorms
from production_stack_tpu_torch.ops import rope as trope
from production_stack_tpu_torch.ops import sampling as tsamp

F32 = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jnorms.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-5), np.float32)
    out = tnorms.rms_norm(_t(x).to(td), _t(w).to(td), 1e-5).float().numpy()
    np.testing.assert_allclose(out, ref, **(F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)))


@pytest.mark.parametrize("scaling", [None, "llama3"])
def test_rope(scaling):
    rng = np.random.RandomState(1)
    pos = rng.randint(0, 9000, (2, 7)).astype(np.int32)
    x = rng.randn(2, 7, 4, 64).astype(np.float32)
    js = None if scaling is None else jrope.RopeScaling(factor=32.0)
    ts = None if scaling is None else trope.RopeScaling(factor=32.0)
    jc, jsn = jrope.rope_cos_sin(jnp.asarray(pos), 64, 500000.0, js)
    tc, tsn = trope.rope_cos_sin(_t(pos), 64, 500000.0, ts)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn), atol=2e-5)
    ref = jrope.apply_rope(jnp.asarray(x), jc, jsn)
    out = trope.apply_rope(_t(x), tc, tsn)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def _table(rng, B=3, maxp=4, P=16):
    return rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32)


def test_stale_and_burst_kv_positions_exact():
    rng = np.random.RandomState(2)
    pt = _table(rng)
    pos = np.full((3, 8), -1, np.int32)
    pos[0, :8] = np.arange(5, 13)
    pos[1, :3] = np.arange(0, 3)
    np.testing.assert_array_equal(
        tattn.stale_kv_positions(_t(pt), _t(pos), 8).numpy(),
        np.asarray(jattn.stale_kv_positions(jnp.asarray(pt), jnp.asarray(pos), 8)),
    )
    lens = np.array([20, 1, 9], np.int32)
    cur = np.array([4, 1, 8], np.int32)
    np.testing.assert_array_equal(
        tattn.burst_kv_positions(_t(lens), _t(cur), 32, 8).numpy(),
        np.asarray(jattn.burst_kv_positions(jnp.asarray(lens), jnp.asarray(cur), 32, 8)),
    )
    # the kernel's chunk masking equals stale_kv_positions on scheduler chunks
    kv_lens = np.array([13, 3, 0], np.int32)
    cl = (pos >= 0).sum(1).astype(np.int32)
    np.testing.assert_array_equal(
        tattn.chunk_kv_positions(_t(kv_lens), _t(cl), _t(pos), 32).numpy(),
        np.asarray(jattn.stale_kv_positions(jnp.asarray(pt), jnp.asarray(pos), 8)),
    )


def test_gather_kv_pages_exact():
    rng = np.random.RandomState(3)
    kp = rng.randn(16, 8, 2, 32).astype(np.float32)
    vp = rng.randn(16, 8, 2, 32).astype(np.float32)
    pt = _table(rng)
    jk, jv = jattn.gather_kv_pages(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt))
    tk, tv = tattn.gather_kv_pages(_t(kp), _t(vp), _t(pt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("window,softcap", [(None, None), (6, None), (None, 20.0), (5, 30.0)])
def test_flash_attention(window, softcap):
    rng = np.random.RandomState(4)
    B, T, S, NH, KH, D = 2, 5, 24, 8, 2, 32
    q = rng.randn(B, T, NH, D).astype(np.float32)
    k = rng.randn(B, S, KH, D).astype(np.float32)
    v = rng.randn(B, S, KH, D).astype(np.float32)
    qpos = np.array([[10, 11, 12, 13, 14], [3, 4, -1, -1, -1]], np.int32)
    lens = np.array([15, 5], np.int32)
    kvpos = np.where(np.arange(S)[None] < np.array([[18], [4]]), np.arange(S)[None], -1).astype(np.int32)
    for kv_positions in (None, kvpos):
        ref = jattn.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos), jnp.asarray(lens),
            window=window, logit_softcap=softcap,
            kv_positions=None if kv_positions is None else jnp.asarray(kv_positions),
        )
        out = tattn.flash_attention(
            _t(q), _t(k), _t(v), _t(qpos), _t(lens), window=window, logit_softcap=softcap,
            kv_positions=None if kv_positions is None else _t(kv_positions),
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_write_kv_pages_all_layers_bytes_identical():
    rng = np.random.RandomState(5)
    L, P, page, KH, D, B, T = 2, 16, 8, 2, 32, 3, 6
    kp = rng.randn(L, P, page, KH, D).astype(np.float32)
    vp = rng.randn(L, P, page, KH, D).astype(np.float32)
    kn = rng.randn(L, B, T, KH, D).astype(np.float32)
    vn = rng.randn(L, B, T, KH, D).astype(np.float32)
    pt = _table(rng, B, 4, P)
    pos = np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, -1, -1, -1], [30, 31, 32, 33, -1, -1]], np.int32)
    jk, jv = jattn.write_kv_pages_all_layers(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pt), jnp.asarray(pos)
    )
    tk, tv = _t(kp.copy()), _t(vp.copy())
    tattn.write_kv_pages_all_layers(tk, tv, _t(kn), _t(vn), _t(pt), _t(pos))
    assert tk.numpy().tobytes() == np.asarray(jk).tobytes()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()


# -- sampling ------------------------------------------------------------------


def _logits(B=4, V=300, seed=6):
    return np.random.RandomState(seed).randn(B, V).astype(np.float32) * 3


def test_greedy_ids_identical():
    lg = _logits()
    B = lg.shape[0]
    z = np.zeros(B, np.float32)
    ref = jsamp.sample(jnp.asarray(lg), jax.random.key(0), jnp.asarray(z), jnp.zeros(B, jnp.int32), jnp.ones(B))
    out = tsamp.sample(_t(lg), torch.Generator().manual_seed(0), _t(z), torch.zeros(B, dtype=torch.int32), torch.ones(B))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.dtype == torch.int32


def _jax_scaled(monkeypatch, lg, temp, top_k, top_p):
    """The JAX sampler's truncated candidate logits, captured at its
    categorical draw."""
    seen = {}
    real = jax.random.categorical

    def spy(key, logits, axis=-1):
        seen["scaled"] = np.asarray(logits)
        return real(key, logits, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", spy)
    jsamp.sample(jnp.asarray(lg), jax.random.key(0), jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p))
    return seen["scaled"]


def test_top_k_top_p_keep_masks_identical(monkeypatch):
    lg = _logits()
    temp = np.array([0.7, 1.0, 1.3, 0.5], np.float32)
    top_k = np.array([0, 5, 40, 3], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.99], np.float32)
    ref = _jax_scaled(monkeypatch, lg, temp, top_k, top_p)
    scaled, cand = tsamp.truncate_candidates(_t(lg), _t(temp), _t(top_k), _t(top_p))
    np.testing.assert_array_equal(np.isfinite(scaled.numpy()), np.isfinite(ref))
    np.testing.assert_allclose(
        np.where(np.isfinite(ref), scaled.numpy(), 0), np.where(np.isfinite(ref), ref, 0), atol=1e-5
    )
    np.testing.assert_array_equal(cand.numpy(), np.argsort(-lg, axis=1, kind="stable")[:, : cand.shape[1]])


def test_sampled_draws_follow_the_truncated_softmax(monkeypatch):
    """20,000 draws of one row (temperature 0.8, top-k 6, top-p 0.9): the
    empirical frequencies match the JAX sampler's truncated softmax within
    0.015 (about 4.5 standard errors at p = 0.5)."""
    lg = _logits(B=1, V=200, seed=7)
    temp, top_k, top_p = np.array([0.8], np.float32), np.array([6], np.int32), np.array([0.9], np.float32)
    ref = _jax_scaled(monkeypatch, lg, temp, top_k, top_p)[0]
    p = np.exp(ref - ref[np.isfinite(ref)].max())
    p = np.where(np.isfinite(ref), p, 0) / np.where(np.isfinite(ref), p, 0).sum()
    N = 20000
    ids = tsamp.sample(
        _t(np.repeat(lg, N, 0)), torch.Generator().manual_seed(1), _t(np.repeat(temp, N)),
        _t(np.repeat(top_k, N)), _t(np.repeat(top_p, N)),
    ).numpy()
    order = np.argsort(-lg[0], kind="stable")[: len(ref)]
    freq = np.array([(ids == tid).mean() for tid in order])
    assert set(ids.tolist()) <= set(order[p > 0].tolist())
    np.testing.assert_allclose(freq, p, atol=0.015)


def test_sample_with_logprobs_matches():
    lg = _logits(B=3, V=100, seed=8)
    z = np.zeros(3, np.float32)
    jid, jlp, jtids, jtlp = jsamp.sample_with_logprobs(
        jnp.asarray(lg), jax.random.key(0), jnp.asarray(z), jnp.zeros(3, jnp.int32), jnp.ones(3)
    )
    tid, tlp, ttids, ttlp = tsamp.sample_with_logprobs(
        _t(lg), torch.Generator(), _t(z), torch.zeros(3, dtype=torch.int32), torch.ones(3)
    )
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)
    np.testing.assert_array_equal(ttids.numpy(), np.asarray(jtids))
    np.testing.assert_allclose(ttlp.numpy(), np.asarray(jtlp), atol=1e-5)


def test_apply_penalties_matches():
    rng = np.random.RandomState(9)
    B, V, H = 3, 50, 12
    lg = rng.randn(B, V).astype(np.float32)
    hist = rng.randint(0, V, (B, H)).astype(np.int32)
    hlen = np.array([12, 7, 3], np.int32)
    plen = np.array([4, 7, 0], np.int32)
    pres = np.array([0.5, 0.0, 1.5], np.float32)
    freq = np.array([0.2, 0.7, 0.0], np.float32)
    rep = np.array([1.3, 1.0, 0.8], np.float32)
    args = (hist, hlen, plen, pres, freq, rep)
    ref = jsamp.apply_penalties(jnp.asarray(lg), *map(jnp.asarray, args))
    out = tsamp.apply_penalties(_t(lg), *map(_t, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_apply_logit_bias_matches():
    rng = np.random.RandomState(10)
    B, V = 3, 40
    lg = rng.randn(B, V).astype(np.float32)
    ids = np.array([[3, 3, 40, 7], [0, 39, 40, 40], [40, 40, 40, 40]], np.int32)  # 40 = unused; 3 twice
    vals = rng.randn(B, 4).astype(np.float32) * 5
    ref = jsamp.apply_logit_bias(jnp.asarray(lg), jnp.asarray(ids), jnp.asarray(vals))
    out = tsamp.apply_logit_bias(_t(lg), _t(ids), _t(vals))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
