"""The port's batched multi-LoRA against the JAX package's: every case of
tests/test_lora.py, with the JAX side run beside the port's.

- Model math: all-zero slots give the base logits (bit for bit in the
  port); adapter logits equal the JAX forward's with the same buffers
  (``lora_from_jax``): f32 copy within 2e-5, bf16 within 0.1, on all seven
  targets and on Mixtral's attention targets; a batch mixing slots 0, 1 and
  2; runtime deltas against weights merged with ``scale * A @ B`` (the
  JAX test's bound: rtol 0.1, atol 0.15 in bf16).
- PEFT checkpoints: both packages' readers give byte-identical arrays for
  an adapter written by either package's writer; the refusals (rank above
  the maximum, partial application, no free slot, already loaded, not
  loaded, in flight) and the load / unload round trip.
- Runner and engine: ``step`` and ``step_multi`` with mixed ``lora_ids``
  give the JAX runner's greedy tokens (f32 copy); the buffers survive sleep
  level 2; the engine's greedy text under an adapter repeats, a base and an
  adapter request in flight together give the JAX engine's tokens, the
  adapter's salt keeps it off base's cached pages, and a reload gets a
  fresh salt.
- HTTP: a port and a JAX server with the same weights answer the same
  LoRA route sequence (load, /v1/models, completions under the adapter,
  the pooling routes' refusal, unload, the refusals) with the same status
  codes and JSON.
- Gemma-2 and OPT are refused with the JAX runner's words, and an unknown
  ``--lora-target-modules`` entry with the JAX engine's.
"""

import asyncio
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import gemma2 as jgemma2
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import opt as jopt
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, load_params, params_from_jax
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams, Sequence
from production_stack_tpu_torch.models import llama as tllama
from test_torch_surface import _Loop, call

ALL7 = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
ATTN = ("wq", "wk", "wv", "wo")
RANK = 4
F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=0.1, rtol=0.0)
MERGED = dict(rtol=0.1, atol=0.15)  # tests/test_lora.py's bound for merged weights in bf16
TWIN = "llama-debug-4kv-f32"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _models(name, f32=False):
    """(JAX config, numpy params, the port's model with them): ``name``'s
    preset, or its f32 copy."""
    jover = dict(dtype=jnp.float32) if f32 else {}
    tover = dict(dtype=torch.float32) if f32 else {}
    cfg_j = dataclasses.replace(jllama.PRESETS[name], attn_impl="xla", **jover)
    cfg_t = dataclasses.replace(tllama.PRESETS[name], attn_impl="plain", **tover)
    p = jax.device_get(jllama.init_params(cfg_j, jax.random.key(0)))
    model = tllama.LlamaForCausalLM(cfg_t, device="cpu")
    load_params(model, params_from_jax(p, cfg_t))
    return cfg_j, p, model


def _jax_lora(cfg_j, targets, slots, scale=0.5, seed=3, S=4):
    """JAX LoRA buffers (numpy) with random A and B in ``slots``: tests/test_lora.py's _random_lora."""
    rng = np.random.RandomState(seed)
    buf = jllama.init_lora_buffers(cfg_j, max_loras=S, max_rank=RANK, targets=targets)
    layers = {k: np.array(v, np.float32) for k, v in buf["layers"].items()}
    dims = jllama.lora_dims(cfg_j)
    for slot in slots:
        for t in targets:
            din, dout = dims[t]
            layers["a_" + t][:, slot] = 0.1 * rng.randn(cfg_j.num_layers, din, RANK)
            layers["b_" + t][:, slot] = 0.1 * rng.randn(cfg_j.num_layers, RANK, dout)
    scale_vec = np.zeros(S, np.float32)
    scale_vec[list(slots)] = scale
    return jax.device_get({"layers": {k: jnp.asarray(v, cfg_j.dtype) for k, v in layers.items()},
                           "scale": jnp.asarray(scale_vec)})


def _inputs(cfg, B=3, T=8, seed=0):
    """One prefill chunk of B rows (tests/test_lora.py's _forward_inputs), numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pt = np.arange(B * 2, dtype=np.int32).reshape(B, 2)
    return ids, pos, pt, np.full((B,), T, np.int32)


def _jax_forward(p, cfg_j, inputs, lora=None, lora_ids=None):
    ids, pos, pt, lens = inputs
    kp, vp = jllama.init_kv_pages(cfg_j, 16, 8)
    kw = {} if lora is None else dict(lora=jax.tree.map(jnp.asarray, lora), lora_ids=jnp.asarray(lora_ids))
    out, _, _ = jllama.forward(p, cfg_j, jnp.asarray(ids), jnp.asarray(pos), kp, vp, jnp.asarray(pt),
                               jnp.asarray(lens), **kw)
    return np.asarray(out)


def _port_forward(model, inputs, lora=None, lora_ids=None):
    ids, pos, pt, lens = inputs
    kp, vp = tllama.init_kv_pages(model.cfg, 16, 8, "cpu")
    kw = {} if lora is None else dict(lora=lora, lora_ids=_t(np.asarray(lora_ids, np.int32)))
    with torch.no_grad():
        return model(_t(ids), _t(pos), kp, vp, _t(pt), _t(lens), **kw).numpy()


def _merged(model, p, cfg_t, lora, slot, targets):
    """A copy of the port's model with ``slot``'s deltas folded into its
    weights (tests/test_lora.py's _merged_params, in f32 then cast)."""
    merged = tllama.LlamaForCausalLM(cfg_t, device="cpu")
    merged.load_state_dict(model.state_dict())
    scale = float(lora["scale"][slot])
    for t in targets:
        a = np.asarray(lora["layers"]["a_" + t][:, slot], np.float32)
        b = np.asarray(lora["layers"]["b_" + t][:, slot], np.float32)
        delta = np.einsum("lir,lro->lio", a, b) * scale
        for i, layer in enumerate(merged.layers):
            w = getattr(layer, t)
            w.data = (w.float() + torch.from_numpy(delta[i])).to(cfg_t.dtype)
    return merged


# -- model math ---------------------------------------------------------------


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_zero_slots_match_base(f32):
    cfg_j, p, model = _models("llama-debug", f32)
    inputs = _inputs(model.cfg)
    base = _port_forward(model, inputs)
    zeros = tllama.init_lora_buffers(model.cfg, 4, RANK, ALL7)
    got = _port_forward(model, inputs, zeros, [0, 0, 0])
    assert got.tobytes() == base.tobytes()  # slot 0 adds exact zeros
    np.testing.assert_allclose(got, _jax_forward(p, cfg_j, inputs), **(F32 if f32 else BF16))


@pytest.mark.parametrize("targets", [ALL7, ATTN], ids=["all7", "attn"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_adapter_logits_match_jax_with_the_same_buffers(f32, targets):
    cfg_j, p, model = _models("llama-debug", f32)
    jl = _jax_lora(cfg_j, targets, slots=[1, 2])
    lora = tllama.lora_from_jax(jl, model.cfg)
    assert lora["layers"][1]["a_wq"].dtype == model.cfg.dtype and lora["scale"].dtype == torch.float32
    assert lora["layers"][1]["a_wq"].view(torch.int16 if not f32 else torch.int32).numpy().tobytes() == \
        np.ascontiguousarray(jl["layers"]["a_wq"][1]).view(np.int16 if not f32 else np.int32).tobytes()
    inputs = _inputs(model.cfg)
    ids = [1, 2, 1]
    got = _port_forward(model, inputs, lora, ids)
    np.testing.assert_allclose(got, _jax_forward(p, cfg_j, inputs, jl, ids), **(F32 if f32 else BF16))
    assert float(np.abs(got - _port_forward(model, inputs)).max()) > 5 * (F32 if f32 else BF16)["atol"]


def test_lora_matches_merged_weights():
    """Runtime deltas equal the base weights merged with scale * A @ B, the
    defining LoRA identity (bf16: rounding at other places)."""
    cfg_j, p, model = _models("llama-debug")
    jl = _jax_lora(cfg_j, ALL7, slots=[1])
    lora = tllama.lora_from_jax(jl, model.cfg)
    inputs = _inputs(model.cfg)
    got = _port_forward(model, inputs, lora, [1, 1, 1])
    want = _port_forward(_merged(model, p, model.cfg, jl, 1, ALL7), inputs)
    np.testing.assert_allclose(got, want, **MERGED)


def test_mixed_batch_per_sequence_adapters():
    """Rows on slots 0, 2 and 1: row 0 is the base model's bit for bit, rows
    1 and 2 their merged models', and the batch matches JAX's."""
    cfg_j, p, model = _models("llama-debug")
    jl = _jax_lora(cfg_j, ALL7, slots=[1, 2])
    lora = tllama.lora_from_jax(jl, model.cfg)
    inputs = _inputs(model.cfg)
    got = _port_forward(model, inputs, lora, [0, 2, 1])
    assert got[0].tobytes() == _port_forward(model, inputs)[0].tobytes()
    np.testing.assert_allclose(got[1], _port_forward(_merged(model, p, model.cfg, jl, 2, ALL7), inputs)[1], **MERGED)
    np.testing.assert_allclose(got[2], _port_forward(_merged(model, p, model.cfg, jl, 1, ALL7), inputs)[2], **MERGED)
    np.testing.assert_allclose(got, _jax_forward(p, cfg_j, inputs, jl, [0, 2, 1]), **BF16)


def test_mixtral_takes_attention_targets_only_and_matches_jax():
    cfg_j, p, model = _models("mixtral-debug", f32=True)
    assert set(tllama.lora_dims(model.cfg)) == set(ATTN) == set(jllama.lora_dims(cfg_j))
    with pytest.raises(ValueError, match=r"unknown LoRA targets \['w_gate'\]"):
        tllama.init_lora_buffers(model.cfg, 2, RANK, ("wq", "w_gate"))
    jl = _jax_lora(cfg_j, ATTN, slots=[1])
    inputs = _inputs(model.cfg)
    got = _port_forward(model, inputs, tllama.lora_from_jax(jl, model.cfg), [1, 0, 1])
    np.testing.assert_allclose(got, _jax_forward(p, cfg_j, inputs, jl, [1, 0, 1]), **F32)


# -- PEFT checkpoints ----------------------------------------------------------


def _write_adapter(path, cfg, writer, rank=RANK, alpha=8.0, targets=("wq", "wv"), seed=7):
    """tests/test_lora.py's _write_adapter, with either package's writer."""
    rng = np.random.RandomState(seed)
    dims = tllama.lora_dims(cfg)
    tensors = {}
    for t in targets:
        din, dout = dims[t]
        tensors[t] = (0.2 * rng.randn(cfg.num_layers, rank, din), 0.2 * rng.randn(cfg.num_layers, dout, rank))
    writer(str(path), cfg, rank, alpha, tensors)
    return str(path), tensors


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_peft_parse_arrays_are_byte_identical(tmp_path, writer):
    cfg_t = tllama.PRESETS["llama-debug"]
    cfg_j = jllama.PRESETS["llama-debug"]
    write = jlora.save_peft_adapter if writer == "jax" else tlora.save_peft_adapter
    path, _ = _write_adapter(tmp_path / "a", cfg_t, write, targets=ALL7)
    jm = jlora.LoRAManager(types.SimpleNamespace(cfg=cfg_j, lora_targets=ALL7), max_rank=8)
    tm = tlora.LoRAManager(types.SimpleNamespace(cfg=cfg_t, lora_targets=ALL7), max_rank=8)
    (jt, js), (tt, ts) = jm.read_checkpoint(path), tm.read_checkpoint(path)
    assert js == ts == 8.0 / RANK
    assert sorted(jt) == sorted(tt) == sorted(f"{ab}_{t}" for ab in "ab" for t in ALL7)
    for k in jt:
        assert tt[k].dtype == torch.float32 and tuple(tt[k].shape) == jt[k].shape, k
        assert tt[k].numpy().tobytes() == jt[k].tobytes(), k


def _runner(cfg, targets=ATTN, max_loras=4, max_rank=8, model=None, num_pages=16):
    if model is None:
        _, _, model = load_model(cfg, device="cpu")
    return ModelRunner(model, num_pages=num_pages, page_size=8, device="cpu", enable_lora=True, max_loras=max_loras,
                       max_lora_rank=max_rank, lora_targets=targets)


def test_peft_load_unload_roundtrip(tmp_path):
    runner = _runner("llama-debug")
    mgr = tlora.LoRAManager(runner, max_loras=4, max_rank=8)
    path, tensors = _write_adapter(tmp_path / "a", runner.cfg, tlora.save_peft_adapter)
    assert mgr.load("my-adapter", path) == 1
    assert mgr.list_adapters() == ["my-adapter"]
    assert mgr.slot_for("my-adapter") == 1 and mgr.slot_for(None) == 0 and mgr.slot_for("other") == 0
    a_dev = torch.stack([layer["a_wq"][1] for layer in runner.lora["layers"]]).float().numpy()
    want = np.transpose(tensors["wq"][0], (0, 2, 1))  # [L, in, r], rounded to bf16 on the device
    np.testing.assert_allclose(a_dev[:, :, :RANK], want, rtol=0.01, atol=0.005)
    assert not a_dev[:, :, RANK:].any()  # the rank padded with zeros
    assert float(runner.lora["scale"][1]) == pytest.approx(8.0 / RANK)
    with pytest.raises(ValueError, match="already loaded"):
        mgr.load("my-adapter", path)
    mgr.unload("my-adapter")
    assert mgr.list_adapters() == []
    assert all(not layer[k][1].any() for layer in runner.lora["layers"] for k in layer)
    assert float(runner.lora["scale"][1]) == 0.0
    with pytest.raises(ValueError, match="not loaded"):
        mgr.unload("my-adapter")


def test_peft_rank_too_large_refused(tmp_path):
    runner = _runner("llama-debug", max_loras=2, max_rank=2)
    mgr = tlora.LoRAManager(runner, max_loras=2, max_rank=2)
    path, _ = _write_adapter(tmp_path / "a", runner.cfg, tlora.save_peft_adapter, rank=RANK)
    with pytest.raises(ValueError, match="rank 4 exceeds max_lora_rank 2"):
        mgr.load("big", path)


def test_max_loras_counts_adapters(tmp_path):
    runner = _runner("llama-debug", max_loras=2)
    mgr = tlora.LoRAManager(runner, max_loras=2, max_rank=8)
    paths = [_write_adapter(tmp_path / str(i), runner.cfg, tlora.save_peft_adapter)[0] for i in range(3)]
    assert mgr.load("a1", paths[0]) == 1
    assert mgr.load("a2", paths[1]) == 2
    with pytest.raises(ValueError, match="no free LoRA slots"):
        mgr.load("a3", paths[2])


def test_reload_same_name_gets_fresh_cache_salt(tmp_path):
    runner = _runner("llama-debug", max_loras=2)
    mgr = tlora.LoRAManager(runner, max_loras=2, max_rank=8)
    path, _ = _write_adapter(tmp_path / "a", runner.cfg, tlora.save_peft_adapter)
    mgr.load("x", path)
    salt1 = mgr.cache_salt("x")
    assert mgr.acquire("x") == (1, salt1) == (1, b"lora:x:1")
    mgr.release(1)
    mgr.unload("x")
    assert mgr.cache_salt("x") == b""
    mgr.load("x", path)
    salt2 = mgr.cache_salt("x")
    assert salt1 and salt2 and salt1 != salt2


def test_partially_applicable_adapter_refused(tmp_path):
    runner = _runner("llama-debug", targets=("wq", "wv"), max_loras=2)
    mgr = tlora.LoRAManager(runner, max_loras=2, max_rank=8)
    path, _ = _write_adapter(tmp_path / "a", runner.cfg, tlora.save_peft_adapter, targets=("wq", "w_gate"))
    with pytest.raises(ValueError, match="partial application"):
        mgr.load("mlp-adapter", path)


def test_an_acquired_slot_cannot_be_unloaded(tmp_path):
    runner = _runner("llama-debug")
    mgr = tlora.LoRAManager(runner, max_loras=4, max_rank=8)
    mgr.load("busy", _write_adapter(tmp_path / "a", runner.cfg, tlora.save_peft_adapter)[0])
    slot, _ = mgr.acquire("busy")
    with pytest.raises(ValueError, match="in-flight"):
        mgr.unload("busy")
    mgr.release(slot)
    mgr.unload("busy")
    with pytest.raises(ValueError, match="not loaded"):
        mgr.acquire("busy")


# -- runner --------------------------------------------------------------------


def _step(ids, pos, lens, pt, lora_ids, limits=None, cls=StepInput):
    B = ids.shape[0]
    return cls(input_ids=ids, positions=pos, page_table=pt, kv_lens=lens, temperature=np.zeros(B, np.float32),
               top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32), kv_limits=limits,
               lora_ids=np.asarray(lora_ids, np.int32))


def test_runner_steps_with_mixed_lora_ids_match_the_jax_runner(tmp_path):
    """The f32 copy, one adapter on all seven targets loaded into both
    runners from one PEFT directory: a prefill chunk and a 4-step burst on
    rows of slots 0 and 1 give the JAX runner's logits and greedy tokens;
    row 0 equals the all-base step's, row 1 does not."""
    cfg_j, p, model = _models(TWIN, f32=True)
    jr = JaxRunner(cfg_j, params=jax.tree.map(jnp.asarray, p), num_pages=16, page_size=8, enable_lora=True,
                   max_loras=4, max_lora_rank=8, lora_targets=ALL7)
    tr = _runner(TWIN, targets=ALL7, model=model)
    path, _ = _write_adapter(tmp_path / "a", model.cfg, jlora.save_peft_adapter, alpha=64.0, targets=ALL7)
    jlora.LoRAManager(jr, max_loras=4, max_rank=8).load("a1", path)
    tlora.LoRAManager(tr, max_loras=4, max_rank=8).load("a1", path)
    ids, pos, _, lens = _inputs(model.cfg, B=2)
    pt = np.arange(4, dtype=np.int32).reshape(2, 2)
    got = {}
    for tag, runner, cls in (("jax", jr, JaxStepInput), ("port", tr, StepInput)):
        first, logits = runner.step(_step(ids, pos, lens, pt, [0, 1], cls=cls))
        nxt = np.asarray(first if tag == "jax" else first.numpy())
        burst = runner.step_multi(_step(nxt[:, None].astype(np.int32), lens[:, None], lens + 1, pt, [0, 1],
                                        np.full(2, 16, np.int32), cls), 4)
        got[tag] = (np.asarray(logits if tag == "jax" else logits.numpy()), nxt,
                    np.asarray(burst if tag == "jax" else burst.numpy()))
    np.testing.assert_allclose(got["port"][0], got["jax"][0], **F32)
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])
    np.testing.assert_array_equal(got["port"][2], got["jax"][2])
    tr.reset_kv()
    _, base = tr.step(_step(ids, pos, lens, pt, [0, 0]))
    assert base[0].numpy().tobytes() == got["port"][0][0].tobytes()
    assert float(np.abs(base[1].numpy() - got["port"][0][1]).max()) > 1e-3


def test_lora_buffers_stay_on_the_device_through_sleep(tmp_path):
    runner = _runner("llama-debug")
    tlora.LoRAManager(runner, max_loras=4, max_rank=8).load(
        "a", _write_adapter(tmp_path / "a", runner.cfg, tlora.save_peft_adapter)[0])
    before = [{k: v.clone() for k, v in layer.items()} for layer in runner.lora["layers"]]
    runner.drop_kv_pools()
    runner.offload_params()
    assert all(layer["a_wq"].numel() for layer in runner.lora["layers"])
    runner.restore_params()
    runner.reset_kv()
    for layer, old in zip(runner.lora["layers"], before):
        assert all(torch.equal(layer[k], old[k]) for k in old)


def test_lora_unsupported_family_clear_error():
    for name, jmod in (("opt-debug", jopt), ("gemma2-debug", jgemma2)):
        with pytest.raises(ValueError) as jerr:
            JaxRunner(jmod.PRESETS[name], module=jmod, num_pages=16, page_size=8, enable_lora=True)
        _, _, model = load_model(name, device="cpu")
        with pytest.raises(ValueError) as terr:
            ModelRunner(model, num_pages=16, page_size=8, device="cpu", enable_lora=True)
        assert str(terr.value) == str(jerr.value)
        assert "(llama-family only)" in str(terr.value)


# -- engine ---------------------------------------------------------------------


def _cfg(**kw):
    base = dict(model="llama-debug", max_model_len=256, max_num_seqs=8, num_pages=64, page_size=8, prefill_chunk=32,
                enable_lora=True, max_loras=4, max_lora_rank=8)
    base.update(kw)
    return base


def test_enable_lora_is_accepted_and_its_flags_parse():
    check_supported(EngineConfig(**_cfg()))
    import argparse

    p = argparse.ArgumentParser()
    port_config.add_engine_args(p)
    args = p.parse_args(["--enable-lora", "--max-loras", "2", "--max-lora-rank", "8",
                         "--lora-target-modules", "q_proj,v_proj"])
    assert port_config.config_from_args(args) == EngineConfig(enable_lora=True, max_loras=2, max_lora_rank=8,
                                                               lora_target_modules="q_proj,v_proj")


def test_unknown_target_module_clear_error():
    with pytest.raises(ValueError) as jerr:
        JaxEngine(JaxEngineConfig(**_cfg(lora_target_modules="qproj")))
    with pytest.raises(ValueError) as terr:
        LLMEngine(EngineConfig(**_cfg(lora_target_modules="qproj")), device="cpu")
    assert str(terr.value) == str(jerr.value) and "lora-target-modules" in str(terr.value)


def _gen(engine, prompt, lora_name=None, cls=SamplingParams, **params):
    async def run():
        toks, text = [], ""
        async for out in engine.generate(f"t-{np.random.randint(1 << 30)}", prompt=prompt, params=cls(**params),
                                         lora_name=lora_name):
            toks.extend(out.token_ids)
            text += out.text_delta
        return text, toks

    return asyncio.run(run())


@pytest.fixture(scope="module")
def lora_engine():
    eng = LLMEngine(EngineConfig(**_cfg()), device="cpu")
    eng.start()
    yield eng
    eng.stop()


GREEDY = dict(max_tokens=12, temperature=0.0, ignore_eos=True)


def test_engine_generate_with_adapter(lora_engine, tmp_path):
    path, _ = _write_adapter(tmp_path / "a", lora_engine.model_cfg, tlora.save_peft_adapter, alpha=64.0)
    assert lora_engine.load_lora_adapter("sql-lora", path) == 1
    try:
        base = _gen(lora_engine, "select all users", **GREEDY)[0]
        tuned = _gen(lora_engine, "select all users", lora_name="sql-lora", **GREEDY)[0]
        again = _gen(lora_engine, "select all users", lora_name="sql-lora", **GREEDY)[0]
        assert tuned == again and tuned != base
        with pytest.raises(ValueError, match="not loaded"):
            _gen(lora_engine, "x", lora_name="missing", max_tokens=2)
        assert lora_engine.lora._refs == {}  # every request released its slot
    finally:
        lora_engine.unload_lora_adapter("sql-lora")


def test_engine_prefix_cache_isolated_between_adapters(lora_engine, tmp_path):
    """The same prompt under base and an adapter shares no KV page (the
    salted hash chains differ); the adapter's own repeat hits its pages."""
    path, _ = _write_adapter(tmp_path / "a", lora_engine.model_cfg, tlora.save_peft_adapter, alpha=64.0, seed=11)
    lora_engine.load_lora_adapter("iso", path)
    try:
        prompt = "tell me a story about caching " * 8  # multiple full pages
        _gen(lora_engine, prompt, max_tokens=2, temperature=0.0, ignore_eos=True)
        hits = lora_engine.kv.prefix_hits
        _gen(lora_engine, prompt, lora_name="iso", max_tokens=2, temperature=0.0, ignore_eos=True)
        assert lora_engine.kv.prefix_hits == hits
        _gen(lora_engine, prompt, lora_name="iso", max_tokens=2, temperature=0.0, ignore_eos=True)
        assert lora_engine.kv.prefix_hits > hits
    finally:
        lora_engine.unload_lora_adapter("iso")


def test_unload_in_flight_refused(tmp_path):
    eng = LLMEngine(EngineConfig(**_cfg()), device="cpu")  # not started: commands run inline
    path, _ = _write_adapter(tmp_path / "a", eng.model_cfg, tlora.save_peft_adapter)
    eng.load_lora_adapter("busy", path)
    seq = Sequence(seq_id="s1", prompt_ids=[1, 2, 3], params=SamplingParams(), lora_slot=eng.lora.slot_for("busy"))
    eng.scheduler.running.append(seq)
    with pytest.raises(ValueError, match="in-flight"):
        eng.unload_lora_adapter("busy")
    eng.scheduler.running.clear()
    eng.unload_lora_adapter("busy")
    assert eng.list_lora_adapters() == []
    plain = LLMEngine(EngineConfig(**_cfg(enable_lora=False)), device="cpu")
    with pytest.raises(ValueError, match="LoRA is not enabled"):
        plain.load_lora_adapter("x", path)
    assert plain.list_lora_adapters() == [] and plain.runner.lora is None


def test_engine_mixed_batch_tokens_match_the_jax_engine(tmp_path):
    """Both engines on the f32 copy with the JAX weights, one adapter on all
    seven targets: a base and an adapter request in flight together give
    the JAX engine's greedy tokens, and the adapter's differ from base's."""
    cfg = _cfg(model=TWIN, lora_target_modules="q_proj,k_proj,v_proj,o_proj,gate_proj,up_proj,down_proj",
               decode_steps=4)
    params = jax.device_get(jllama.init_params(jllama.PRESETS[TWIN], jax.random.key(0)))
    jeng = JaxEngine(JaxEngineConfig(**cfg))
    peng = LLMEngine(EngineConfig(**cfg), device="cpu", params=params_from_jax(params, tllama.PRESETS[TWIN]))
    path, _ = _write_adapter(tmp_path / "a", peng.model_cfg, jlora.save_peft_adapter, alpha=64.0, targets=ALL7)
    prompt = "Adapters change what a model says, " * 2
    got = {}
    for tag, eng, cls in (("jax", jeng, JaxSamplingParams), ("port", peng, SamplingParams)):
        eng.load_lora_adapter("a1", path)
        eng.start()
        try:
            async def both(eng=eng, cls=cls):
                async def one(sid, name):
                    toks = []
                    async for out in eng.generate(sid, prompt=prompt, params=cls(**GREEDY), lora_name=name):
                        toks.extend(out.token_ids)
                    return toks

                return await asyncio.gather(one("b", None), one("a", "a1"))

            got[tag] = asyncio.run(both())
        finally:
            eng.stop()
    assert [len(t) for t in got["port"]] == [12, 12]
    assert got["port"] == got["jax"]
    assert got["port"][0] != got["port"][1]


def test_engine_adapter_request_beside_base_equals_it_alone(tmp_path):
    """On the f32 copy, an adapter request in flight beside a base request
    gives the tokens it gives alone, and its two best logprobs a token
    within 2e-5 (the batch shape changes summation orders; slot ids follow
    their rows from the scheduler to the runner), and they are not base's."""
    cfg = _cfg(model=TWIN, lora_target_modules="q_proj,k_proj,v_proj,o_proj,gate_proj,up_proj,down_proj",
               decode_steps=4)
    eng = LLMEngine(EngineConfig(**cfg), device="cpu")
    path, _ = _write_adapter(tmp_path / "a", eng.model_cfg, tlora.save_peft_adapter, alpha=64.0, targets=ALL7)
    eng.load_lora_adapter("a1", path)
    prompt = "Adapters change what a model says, " * 2
    params = dict(GREEDY, logprobs=2)

    async def one(sid, name):
        toks, lps = [], []
        async for out in eng.generate(sid, prompt=prompt, params=SamplingParams(**params), lora_name=name):
            toks.extend(out.token_ids)
            lps.extend(out.logprobs)
        return toks, lps

    async def run():
        alone = [await one("b0", None), await one("a0", "a1")]
        return alone, await asyncio.gather(one("b1", None), one("a1", "a1"))

    eng.start()
    try:
        alone, pair = asyncio.run(run())
    finally:
        eng.stop()
    for (toks, lps), (toks0, lps0) in zip(pair, alone):
        assert toks == toks0
        np.testing.assert_allclose([e["top_logprobs"] for e in lps], [e["top_logprobs"] for e in lps0], **F32)
        assert [e["top_ids"] for e in lps] == [e["top_ids"] for e in lps0]
    assert pair[1][0] != alone[0][0]


# -- HTTP -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def urls():
    lp = _Loop()
    small = dict(_cfg(model=TWIN), host="127.0.0.1", kv_cache_memory_gb=0.01)
    jcfg, pcfg = JaxEngineConfig(**small, port=free_port()), EngineConfig(**small, port=free_port())
    jsrv, jrun = lp.run(jax_server.serve(jcfg))
    params = jax.device_get(jllama.init_params(jllama.PRESETS[TWIN], jax.random.key(0)))
    peng = LLMEngine(pcfg, device="cpu", params=params_from_jax(params, tllama.PRESETS[TWIN]))
    psrv, prun = lp.run(port_server.serve(pcfg, peng, device="cpu"))
    yield {"jax": f"http://127.0.0.1:{jcfg.port}", "port": f"http://127.0.0.1:{pcfg.port}"}
    lp.run(prun.cleanup())
    psrv.engine.stop()
    lp.run(jrun.cleanup())
    jsrv.engine.stop()
    lp.close()


def _strip(body):
    """A reply without what differs by design between two servers: ids and
    creation times."""
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in ("id", "created")}
    if isinstance(body, list):
        return [_strip(x) for x in body]
    return body


def test_lora_routes_answer_as_the_jax_server_does(urls, tmp_path):
    cfg = tllama.PRESETS[TWIN]
    path, _ = _write_adapter(tmp_path / "a", cfg, tlora.save_peft_adapter, alpha=64.0)
    big, _ = _write_adapter(tmp_path / "big", cfg, tlora.save_peft_adapter, rank=16)
    completion = {"model": "demo-lora", "prompt": "hello there", "max_tokens": 6, "temperature": 0.0,
                  "ignore_eos": True}
    steps = [
        ("POST", "/v1/load_lora_adapter", {"lora_name": "demo-lora"}),
        ("POST", "/v1/load_lora_adapter", {"lora_name": "big", "lora_path": big}),
        ("POST", "/v1/load_lora_adapter", {"lora_name": "nodir", "lora_path": str(tmp_path / "none")}),
        ("POST", "/v1/load_lora_adapter", {"lora_name": "demo-lora", "lora_path": path}),
        ("POST", "/v1/load_lora_adapter", {"lora_name": "demo-lora", "lora_path": path}),
        ("GET", "/v1/models", None),
        ("POST", "/v1/completions", completion),
        ("POST", "/v1/chat/completions", {"model": "demo-lora", "messages": [{"role": "user", "content": "hi"}],
                                          "max_tokens": 4, "temperature": 0.0, "ignore_eos": True}),
        ("POST", "/v1/embeddings", {"model": "demo-lora", "input": "x"}),
        ("POST", "/v1/completions", dict(completion, model="nope")),
        ("POST", "/v1/unload_lora_adapter", {}),
        ("POST", "/v1/unload_lora_adapter", {"lora_name": "demo-lora"}),
        ("POST", "/v1/unload_lora_adapter", {"lora_name": "demo-lora"}),
        ("POST", "/v1/completions", completion),
        ("GET", "/v1/models", None),
    ]
    answers = {tag: [call(base, m, route, body) for m, route, body in steps] for tag, base in urls.items()}
    for step, (p, j) in zip(steps, zip(answers["port"], answers["jax"])):
        assert p[0] == j[0], step
        assert _strip(p[1]) == _strip(j[1]), step
    codes = [status for status, _ in answers["port"]]
    assert codes == [400, 400, 400, 200, 400, 200, 200, 200, 400, 404, 400, 200, 400, 404, 200]
    models = answers["port"][5][1]["data"]
    assert [(m["id"], m.get("parent")) for m in models] == [(TWIN, None), ("demo-lora", TWIN)]
    assert answers["port"][3][1] == {"status": "success", "lora_name": "demo-lora", "slot": 1}
    assert answers["port"][6][1]["model"] == "demo-lora" and answers["port"][6][1]["usage"]["completion_tokens"] == 6
