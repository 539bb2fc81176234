"""The port's OPT family against the JAX package's, with the JAX weights
carried over by params_from_jax.

- The forward (f32 twin of opt-debug): a 3-token first chunk (below the 16
  tokens at which the JAX OPT takes its prefill kernel; the port's takes
  it for every chunk), a 40-token chunk after that history, and a 3-step
  decode burst (the port's deferred window against the JAX forward's
  write after every step), a 2-row batch with a ragged, padded row 1:
  logits to 1e-4, the JAX side through its XLA path and through its
  Pallas kernels in interpret mode. The bf16 preset: logits to 0.1 (both
  round activations to bf16, not at the same places).
- The engine: the port engine's greedy text on the f32 twin equals the
  JAX engine's on the same weights.
- LayerNorm against the JAX one; the int8 pool refusal.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import opt as jopt
from production_stack_tpu.ops.norms import layer_norm as jax_layer_norm
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.models import opt as topt
from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
from production_stack_tpu_torch.ops.norms import layer_norm

F32 = dict(atol=1e-4, rtol=0.0)
BF16 = dict(atol=0.1, rtol=0.0)
PAGE, NUM_PAGES = 8, 24
PT = np.array([[0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11]], np.int32)
BURST = 3
F32_TWIN = "opt-debug-f32"


def _jax_cfg(name, attn_impl="xla"):
    dtype = jnp.float32 if name == F32_TWIN else jnp.bfloat16
    return dataclasses.replace(jopt.PRESETS["opt-debug"], dtype=dtype, attn_impl=attn_impl)


def _params(name):
    """The JAX weights (numpy) and the port model holding the same bits."""
    p = jax.device_get(jopt.init_params(_jax_cfg(name), jax.random.key(0)))
    _, cfg, model = load_model(name, device="cpu", params=params_from_jax(p, topt.PRESETS[name]))
    return p, cfg, model


def test_presets_and_config_match_jax():
    for name in ("opt-125m", "opt-debug"):
        j, t = jopt.PRESETS[name], topt.PRESETS[name]
        for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "layer_norm_eps",
                  "max_model_len", "num_kv_heads", "head_dim", "tie_word_embeddings", "sliding_window"):
            assert getattr(t, f) == getattr(j, f), f
    assert topt.POS_OFFSET == jopt.POS_OFFSET == 2
    assert topt.PRESETS[F32_TWIN].dtype == torch.float32


def test_params_from_jax_keeps_every_bit():
    p, cfg, model = _params("opt-debug")
    sd = dict(model.named_parameters())
    assert p["embed"].dtype == ml_dtypes.bfloat16
    assert sd["pos_embed"].shape == (cfg.max_model_len + 2, cfg.hidden_size)
    for name in ("embed", "pos_embed", "final_norm_w", "final_norm_b"):
        assert torch.equal(sd[name].view(torch.int16), torch.from_numpy(p[name].view(np.int16))), name
    for name, stacked in p["layers"].items():
        for i in range(cfg.num_layers):
            got = sd[f"layers.{i}.{name}"].view(torch.int16)
            assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(stacked[i]).view(np.int16))), name


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(0)
    x, w, b = rng.randn(3, 5, 64).astype(np.float32) * 3 + 1, rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    ref = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    refb = np.asarray(jax_layer_norm(xb, jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)), np.float32)
    gotb = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), torch.from_numpy(b).bfloat16())
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_array_equal(gotb.float().numpy(), refb)  # f32 statistics, one rounding at the end


def _chunks():
    """A 3-token first chunk (row 1: 2 tokens, padded), then a 40-token
    chunk (row 1: 33), as (input_ids, positions, kv_lens)."""
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 512, (2, 48)).astype(np.int32)
    out = []
    for T, start, n in ((3, (0, 0), (3, 2)), (40, (3, 2), (40, 33))):
        pos = np.full((2, T), -1, np.int32)
        inp = np.zeros((2, T), np.int32)
        for b in range(2):
            pos[b, : n[b]] = np.arange(start[b], start[b] + n[b])
            inp[b, : n[b]] = ids[b, start[b]: start[b] + n[b]]
        out.append((inp, pos, np.array([start[0] + n[0], start[1] + n[1]], np.int32)))
    return ids, out


@pytest.mark.parametrize("name,jax_impl", [
    (F32_TWIN, "xla"),
    (F32_TWIN, "pallas_interpret"),
    ("opt-debug", "xla"),
])
def test_forward_short_and_long_chunks_and_burst_match_jax(name, jax_impl):
    p, cfg_t, model = _params(name)
    cfg_j = _jax_cfg(name, jax_impl)
    tol = F32 if name == F32_TWIN else BF16
    shape = (cfg_j.num_layers, NUM_PAGES, PAGE, cfg_j.num_heads, cfg_j.head_dim)
    jk, jv = jopt.init_kv_pages(cfg_j, NUM_PAGES, PAGE)
    tk, tv = topt.init_kv_pages(cfg_t, NUM_PAGES, PAGE, "cpu")
    assert tuple(tk.shape) == shape == tuple(jk.shape)
    ids, chunks = _chunks()
    fwd = jax.jit(jopt.forward, static_argnums=1)
    with torch.no_grad():
        for inp, pos, lens in chunks:
            jl, jk, jv = fwd(p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jk, jv, jnp.asarray(PT), jnp.asarray(lens))
            tl = model(torch.from_numpy(inp), torch.from_numpy(pos), tk, tv, torch.from_numpy(PT), torch.from_numpy(lens))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        # the decode burst: the JAX forward writes after every step, the
        # port's appends to its window and commits once at the end
        L, KH, D = cfg_t.num_layers, cfg_t.num_kv_heads, cfg_t.head_dim
        tka = torch.zeros((L, 2, BURST, KH, D), dtype=tk.dtype)
        tva = torch.zeros_like(tka)
        lens0 = chunks[-1][2]
        for s in range(BURST):
            inp = np.stack([ids[0, 43 + s], ids[1, 35 + s]])[:, None].astype(np.int32)
            pos = (lens0 + s)[:, None].astype(np.int32)
            lens = (lens0 + s + 1).astype(np.int32)
            jl, jk, jv = fwd(p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jk, jv, jnp.asarray(PT), jnp.asarray(lens))
            tl = model(torch.from_numpy(inp), torch.from_numpy(pos), tk, tv, torch.from_numpy(PT),
                       torch.from_numpy(lens), kv_burst=(tka, tva, torch.full((2,), s, dtype=torch.int32)))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    commit = (lens0[:, None] + np.arange(BURST)[None]).astype(np.int32)
    write_kv_pages_all_layers(tk, tv, tka, tva, torch.from_numpy(PT), torch.from_numpy(commit))
    if name == F32_TWIN:  # the pools after the burst's commit hold what the JAX steps wrote
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5, rtol=2e-5)


def _collect(engine, params):
    async def go():
        ids, text = [], []
        async for out in engine.generate("r1", prompt=PROMPT, params=params):
            ids += out.token_ids
            text.append(out.text_delta)
        return ids, "".join(text)

    engine.start()
    try:
        return asyncio.run(go())
    finally:
        engine.stop()


PROMPT = "The quick brown fox jumps over the lazy dog."  # 45 tokens: two 32-token chunks
SMALL = dict(max_model_len=256, max_num_seqs=4, num_pages=32, page_size=8, prefill_chunk=32)


def test_engine_greedy_text_matches_jax_engine(monkeypatch):
    # the JAX package has no f32 OPT preset: the test adds one for its run
    monkeypatch.setitem(jopt.PRESETS, F32_TWIN, _jax_cfg(F32_TWIN, "auto"))
    jeng = JaxEngine(JaxEngineConfig(model=F32_TWIN, **SMALL))
    jids, jtext = _collect(jeng, JaxSamplingParams(max_tokens=20, temperature=0.0, ignore_eos=True))
    p = jax.device_get(jeng.runner.params)
    teng = LLMEngine(EngineConfig(model=F32_TWIN, **SMALL), device="cpu",
                     params=params_from_jax(p, topt.PRESETS[F32_TWIN]))
    tids, ttext = _collect(teng, SamplingParams(max_tokens=20, temperature=0.0, ignore_eos=True))
    assert len(tids) == 20
    assert tids == jids and ttext == jtext


def test_int8_pools_are_refused_for_opt():
    with pytest.raises(ValueError, match="'opt' does not support kv_cache_dtype=int8"):
        LLMEngine(EngineConfig(model="opt-debug", kv_cache_dtype="int8", num_pages=16, page_size=8,
                               max_model_len=128), device="cpu")
