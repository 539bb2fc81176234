"""The port's Gemma-2 forward, runner and server against the JAX package's,
with the JAX weights carried over by params_from_jax.

The JAX side runs its Pallas kernels in interpret mode
(attn_impl="pallas_interpret"), the port its kernels' plain versions. Each
forward case prefills two 16-token chunks of a 2-row batch (row 1 ragged)
and then decodes an 8-step burst, so the sequences cross gemma2-debug's
sliding window of 8: layer 0 slides, layer 1 does not. The variants:

- f32 copy of gemma2-debug: logits agree to 2e-5 (the two frameworks' f32
  matmuls sum in another order), and greedy tokens through both runners
  are identical;
- the bf16 preset: logits within 0.1 (both round activations to bf16, not
  at the same places);
- a D = 256 f32 copy with query_pre_attn_scalar = 144, so a forward that
  scales by head_dim**-0.5 instead fails: logits to 2e-5;
- int8 pools (f32 copy): after every step the int8 pages are byte-identical
  to the JAX package's, and each page scale within 1e-6 of it, relative:
  a scale is amax * (1 / 127) of K/V that each framework computes with its
  own f32 matmuls, so an amax may differ in its last bits (measured: 5.1e-7
  on these inputs, in 24 of 96 scales), while every page byte agrees.
"""

import asyncio
import dataclasses
import threading

import aiohttp
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.models import gemma2 as jgemma
from production_stack_tpu.ops.attention import write_kv_pages_all_layers as jax_commit
from production_stack_tpu.ops.quant import write_kv_pages_all_layers_quant as jax_commit_quant
from production_stack_tpu.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_params, params_from_jax
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
from production_stack_tpu_torch.models import gemma2 as tgemma
from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod
from production_stack_tpu_torch.ops.quant import init_kv_scales, write_kv_pages_all_layers_quant

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=0.1, rtol=0.0)
NAME = "gemma2-debug"
PAGE, NUM_PAGES = 8, 24
PT = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)
BURST = 8

# (JAX config overrides, the port's, tolerance, int8 pools)
VARIANTS = {
    "f32": (dict(dtype=jnp.float32), dict(dtype=torch.float32), F32, False),
    "bf16": ({}, {}, BF16, False),
    "d256_qpas144_f32": (dict(dtype=jnp.float32, head_dim=256, query_pre_attn_scalar=144.0),
                         dict(dtype=torch.float32, head_dim=256, query_pre_attn_scalar=144.0), F32, False),
    "int8_f32": (dict(dtype=jnp.float32, kv_cache_dtype="int8"),
                 dict(dtype=torch.float32, kv_cache_dtype="int8"), F32, True),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _configs(variant):
    jover, tover, tol, quant = VARIANTS[variant]
    cfg_j = dataclasses.replace(jgemma.PRESETS[NAME], attn_impl="pallas_interpret", **jover)
    cfg_t = dataclasses.replace(tgemma.PRESETS[NAME], attn_impl="plain", **tover)
    return cfg_j, cfg_t, tol, quant


def _models(variant):
    """(JAX config, numpy params, the port's model with those params, tol, quant)."""
    cfg_j, cfg_t, tol, quant = _configs(variant)
    p = jax.device_get(jgemma.init_params(cfg_j, jax.random.key(0)))
    model = tgemma.Gemma2ForCausalLM(cfg_t, device="cpu")
    load_params(model, params_from_jax(p, cfg_t))
    return cfg_j, p, model, tol, quant


def _chunks():
    """Two 16-token prefill chunks of a 2-row batch (row 1 ragged, padded),
    as (input_ids, positions, kv_lens)."""
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 512, (2, 40)).astype(np.int32)
    out = []
    for start, n in (((0, 0), (16, 11)), ((16, 11), (16, 13))):
        pos = np.full((2, 16), -1, np.int32)
        inp = np.zeros((2, 16), np.int32)
        for b in range(2):
            pos[b, : n[b]] = np.arange(start[b], start[b] + n[b])
            inp[b, : n[b]] = ids[b, start[b]: start[b] + n[b]]
        out.append((inp, pos, np.array([start[0] + n[0], start[1] + n[1]], np.int32)))
    return ids, out


def _pools(cfg_j, quant):
    """The same initial pools for both sides: (port tensors, JAX arrays)."""
    shape = (cfg_j.num_layers, NUM_PAGES, PAGE, cfg_j.num_kv_heads, cfg_j.head_dim)
    if quant:
        t = [torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8),
             init_kv_scales(shape[0], NUM_PAGES, shape[3]), init_kv_scales(shape[0], NUM_PAGES, shape[3])]
        return t, [jnp.asarray(x.numpy()) for x in t]
    rng = np.random.RandomState(3)
    dt = np.dtype(cfg_j.dtype)
    arrs = [rng.randn(*shape).astype(np.float32).astype(dt) for _ in range(2)]
    if dt == np.float32:
        return [torch.from_numpy(a.copy()) for a in arrs], [jnp.asarray(a) for a in arrs]
    return [torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16) for a in arrs], [jnp.asarray(a) for a in arrs]


SCALE_RTOL = 1e-6


def _int8_pools_match(tpools, jpools):
    """int8 pages byte-identical, page scales within SCALE_RTOL."""
    for t, j in zip(tpools[:2], jpools[:2]):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype == np.int8 and t.shape == j.shape
        assert t.numpy().tobytes() == j.tobytes()
    for t, j in zip(tpools[2:], jpools[2:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=SCALE_RTOL, atol=0)


def _close_pools(tpools, jpools, tol):
    for t, j in zip(tpools, jpools):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j).astype(np.float32), **tol)


@pytest.mark.parametrize("name", sorted(tgemma.PRESETS))
def test_presets_equal_the_jax_presets(name):
    """Every preset the port declares is the JAX preset of the same name,
    field by field (dtypes mapped; the JAX package's Pallas tuning knobs and
    attn_impl names are its own)."""
    port, ref = tgemma.PRESETS[name], jgemma.PRESETS[name]
    fields = {f.name for f in dataclasses.fields(port)} - {"attn_impl", "dtype"}
    assert {k: getattr(port, k) for k in fields} == {k: getattr(ref, k) for k in fields}
    assert str(port.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name
    assert port.tie_word_embeddings and ref.tie_word_embeddings


def test_params_from_jax_keeps_every_bit():
    cfg_j, p, model, _, _ = _models("bf16")
    assert p["embed"].dtype == ml_dtypes.bfloat16 and "lm_head" not in p
    sd = dict(model.named_parameters())
    assert set(sd) == {"embed", "final_norm"} | {
        f"layers.{i}.{n}" for i in range(cfg_j.num_layers) for n in tgemma.layer_shapes(model.cfg)
    }
    assert torch.equal(sd["embed"].view(torch.int16), _t(p["embed"].view(np.int16)))
    assert torch.equal(sd["final_norm"].view(torch.int16), _t(p["final_norm"].view(np.int16)))
    for name, stacked in p["layers"].items():
        for i in range(cfg_j.num_layers):
            got = sd[f"layers.{i}.{name}"]
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16), _t(np.ascontiguousarray(stacked[i]).view(np.int16)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_prefill_chunks_and_burst_match_jax(variant):
    cfg_j, p, model, tol, quant = _models(variant)
    L, KH, D = cfg_j.num_layers, cfg_j.num_kv_heads, cfg_j.head_dim
    tpools, jpools = _pools(cfg_j, quant)
    ids, chunks = _chunks()
    pt_j, pt_t = jnp.asarray(PT), _t(PT)
    with torch.no_grad():
        for inp, pos, lens in chunks:
            jout = jgemma.forward(p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jpools[0], jpools[1], pt_j,
                                  jnp.asarray(lens), kv_scales=(jpools[2], jpools[3]) if quant else None)
            jl, jpools = jout[0], list(jout[1:])
            tl = model(_t(inp), _t(pos), tpools[0], tpools[1], pt_t, _t(lens),
                       kv_scales=(tpools[2], tpools[3]) if quant else None)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
            if quant:
                _int8_pools_match(tpools, jpools)
        # an 8-step deferred burst: pools read-only, windows grow, one commit
        dt = model.cfg.dtype
        jka = jnp.zeros((L, 2, BURST, KH, D), cfg_j.dtype)
        jva = jnp.zeros_like(jka)
        tka = torch.zeros((L, 2, BURST, KH, D), dtype=dt)
        tva = torch.zeros_like(tka)
        lens0 = chunks[-1][2]
        for s in range(BURST):
            inp = np.stack([ids[0, 32 + s], ids[1, 24 + s]])[:, None].astype(np.int32)
            pos = (lens0 + s)[:, None].astype(np.int32)
            lens = (lens0 + s + 1).astype(np.int32)
            cnt = np.full((2,), s, np.int32)
            jl, jka, jva = jgemma.forward(
                p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jpools[0], jpools[1], pt_j, jnp.asarray(lens),
                kv_burst=(jka, jva, jnp.asarray(cnt)), kv_scales=(jpools[2], jpools[3]) if quant else None,
            )
            tl = model(_t(inp), _t(pos), tpools[0], tpools[1], pt_t, _t(lens), kv_burst=(tka, tva, _t(cnt)),
                       kv_scales=(tpools[2], tpools[3]) if quant else None)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    commit = (lens0[:, None] + np.arange(BURST)[None]).astype(np.int32)
    if quant:
        jpools = list(jax_commit_quant(*jpools, jka, jva, pt_j, jnp.asarray(commit)))
        write_kv_pages_all_layers_quant(*tpools, tka, tva, pt_t, _t(commit))
        _int8_pools_match(tpools, jpools)
    else:
        jpools = list(jax_commit(jpools[0], jpools[1], jka, jva, pt_j, jnp.asarray(commit)))
        write_kv_pages_all_layers(tpools[0], tpools[1], tka, tva, pt_t, _t(commit))
        _close_pools(tpools, jpools, tol)


def test_a_forward_that_ignores_query_pre_attn_scalar_fails_the_d256_case():
    """The D = 256 copy tells sm_scale = 144**-0.5 from head_dim**-0.5: the
    same forward with the scalar set to 256 moves the logits far past F32."""
    cfg_j, p, model, _, _ = _models("d256_qpas144_f32")
    wrong = tgemma.Gemma2ForCausalLM(dataclasses.replace(model.cfg, query_pre_attn_scalar=256.0), device="cpu")
    wrong.load_state_dict(model.state_dict())
    _, chunks = _chunks()
    tpools, _ = _pools(cfg_j, False)
    wpools = [x.clone() for x in tpools]
    with torch.no_grad():
        for inp, pos, lens in chunks:
            a = model(_t(inp), _t(pos), tpools[0], tpools[1], _t(PT), _t(lens))
            b = wrong(_t(inp), _t(pos), wpools[0], wpools[1], _t(PT), _t(lens))
    assert float((a - b).abs().max()) > 100 * F32["atol"]


def _step(ids, pos, lens, limits=None, cls=StepInput):
    B = ids.shape[0]
    return cls(
        input_ids=ids, positions=pos, page_table=PT, kv_lens=lens,
        temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
        kv_limits=limits,
    )


def test_runner_greedy_tokens_over_prefill_and_two_bursts_match_jax():
    cfg_j, p, model, _, _ = _models("f32")
    jr = JaxRunner(cfg_j, params=jax.tree.map(jnp.asarray, p), num_pages=NUM_PAGES, page_size=PAGE, seed=0)
    tr = ModelRunner(model, num_pages=NUM_PAGES, page_size=PAGE, seed=0, device="cpu")
    _, chunks = _chunks()
    got = {}
    for tag, runner, cls in (("jax", jr, JaxStepInput), ("port", tr, StepInput)):
        toks = []
        for inp, pos, lens in chunks:
            ids, _ = runner.step(_step(inp, pos, lens, cls=cls))
        nxt = np.asarray(ids if tag == "jax" else ids.numpy())
        toks.append(nxt[:, None])
        lens = chunks[-1][2].copy()
        limits = np.array([40, 32], np.int32)  # both rows run both bursts to the end of their pages
        for _ in range(2):
            out = runner.step_multi(
                _step(nxt[:, None].astype(np.int32), lens[:, None].astype(np.int32), lens + 1, limits, cls), 4
            )
            out = np.asarray(out if tag == "jax" else out.numpy())
            toks.append(out)
            nxt = out[:, -1]
            lens = lens + 4
        got[tag] = np.concatenate(toks, 1)
    assert got["port"].shape == (2, 9)
    np.testing.assert_array_equal(got["port"], got["jax"])


def test_port_server_serves_gemma2_debug_on_the_cpu_through_the_plain_versions():
    """A greedy completion and a chat completion over HTTP; the launch
    counters show that only the kernels' plain versions ran."""
    cfg = EngineConfig(model=NAME, host="127.0.0.1", port=free_port(), max_model_len=256, max_num_seqs=4,
                       num_pages=32, page_size=8, prefill_chunk=32, kv_cache_memory_gb=0.01)
    kernels = [(dmod.decode_attention, "launches"), (dmod.decode_attention, "launches_int8"),
               (pmod.prefill_attention, "launches"), (pmod.prefill_attention, "launches_int8"),
               (pmod.prefill_attention, "launches_write"), (pmod.prefill_attention, "launches_write_int8")]
    plains = [dmod.decode_attention_ref, pmod.prefill_attention_ref, pmod.kv_page_write_ref]
    before = [getattr(f, a) for f, a in kernels]
    calls0 = [f.calls for f in plains]
    prompt = "Gemma two slides over eight keys on even layers, and sees everything on odd ones."

    async def run():
        srv, runner = await port_server.serve(cfg, LLMEngine(cfg, device="cpu"))
        base = f"http://127.0.0.1:{cfg.port}"
        try:
            async with aiohttp.ClientSession() as s:
                body = {"prompt": prompt, "max_tokens": 10, "temperature": 0.0, "ignore_eos": True}
                async with s.post(base + "/v1/completions", json=body) as r:
                    comp = (r.status, await r.json())
                chat = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 6, "temperature": 0.0,
                        "ignore_eos": True}
                async with s.post(base + "/v1/chat/completions", json=chat) as r:
                    reply = (r.status, await r.json())
        finally:
            await runner.cleanup()
            srv.engine.stop()
        return comp, reply

    box = {}
    th = threading.Thread(target=lambda: box.setdefault("out", asyncio.run(run())))
    th.start()
    th.join(240)
    (st, comp), (st2, reply) = box["out"]
    assert st == 200 and comp["usage"]["completion_tokens"] == 10
    assert comp["usage"]["prompt_tokens"] == len(prompt) + 1
    assert st2 == 200 and reply["choices"][0]["message"]["role"] == "assistant"
    assert reply["usage"]["completion_tokens"] == 6
    assert [getattr(f, a) for f, a in kernels] == before  # no kernel launched on the CPU
    ran = [f.calls - c for f, c in zip(plains, calls0)]
    assert ran[0] > 0 and ran[1] > 0  # decode and prefill went through the plain versions
