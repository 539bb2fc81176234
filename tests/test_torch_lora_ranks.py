"""Batched multi-LoRA across the port's ranks against the JAX engine on its
8-device CPU mesh: tensor parallelism, in-engine data parallelism and both
(tests/test_torch_lora_stages.py holds pp and sp, test_torch_lora_experts.py
Mixtral at ep).

The JAX runner replicates the slot buffers and lets GSPMD shard the deltas;
each port rank holds its part of every buffer (parallel/tp.split_axis: a
column-parallel target's ``b`` on its out axis, a row-parallel one's ``a``
on its in axis) and writes it from the whole adapter that the leader's
``set_lora_slot`` sends every rank. Per mesh, on the f32 twin with the JAX
engine's weights and two PEFT adapters (rank 8 and 16, all seven targets)
loaded into both engines (the port's over HTTP):

- a four-row prefill chunk on slots 0, 1, 2, 1: logits within 2e-5 of the
  JAX runner's at the same mesh;
- greedy tokens of three concurrent requests (a prompt under base and
  under the rank-8 adapter, another under the rank-16 one) equal to the
  JAX engine's, the adapter's differing from base's;
- the rank buffers joined back (``gathered_lora``) bit-equal to a one-rank
  runner's and to the JAX runner's (``lora_from_jax``); every rank's own
  read (``lora_digest``) changed by the load and back after the unload, and
  the dp replicas equal; /v1/models lists the adapters.

Unit cases: the split rule derived from the weights' table, rank buffers
of a pp x tp layout joined (``models/llama.join_lora``) equal to one
rank's, the step stream's codec carrying an adapter, the engine's LoRA
manager on the wrapped runner, and the refusals that stay (Gemma-2, OPT).
"""

import asyncio
import dataclasses
import time
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.distributed import REPLICATED, BroadcastingRunner, _pack_call, _unpack_call
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
from production_stack_tpu_torch.engine.runner import RANK_STATS, ModelRunner, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel.tp import split_axis
from production_stack_tpu_torch.utils.arrays import numpy_from_tensor, tensor_from_numpy
from test_torch_surface import _Loop, call

F32 = dict(atol=2e-5, rtol=2e-5)
MODEL = "llama-debug-4kv-f32"  # 2 layers, NH 8, KH 4, I 256
SMALL = dict(max_model_len=128, num_pages=64, page_size=8, max_num_seqs=4, decode_steps=2, prefill_chunk=32)
GLOO = dict(tp_backend="gloo")
ALL7 = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
ATTN = ("wq", "wk", "wv", "wo")
MAX_RANK = 16
LORA = dict(enable_lora=True, max_loras=2, max_lora_rank=MAX_RANK,
            lora_target_modules=",".join(tlora._LEAF_TO_HF[t] for t in ALL7))
ADAPTER_RANKS = {"a8": 8, "a16": 16}
# the greedy requests: (prompt index, adapter); rows 0 and 1 share a prompt
REQUESTS = ((0, None), (0, "a8"), (1, "a16"))
# the prefill chunk's rows' slots: both dp groups of dp 2 hold an adapter row
CHUNK_SLOTS = (0, 1, 2, 1)
MESHES = {"tp2": dict(tensor_parallel_size=2), "dp2": dict(data_parallel_size=2),
          "dp2tp2": dict(data_parallel_size=2, tensor_parallel_size=2)}


def write_adapters(root, cfg, targets=ALL7) -> list:
    """(name, directory) of the rank-8 and rank-16 PEFT adapters on
    ``targets``, seeded, written by the port's writer (alpha 4r)."""
    out = []
    dims = tllama.lora_dims(cfg)
    for name, r in ADAPTER_RANKS.items():
        rng = np.random.RandomState(r)
        tensors = {t: (0.2 * rng.randn(cfg.num_layers, r, dims[t][0]), 0.2 * rng.randn(cfg.num_layers, dims[t][1], r))
                   for t in targets}
        path = str(root / name)
        tlora.save_peft_adapter(path, cfg, r, 4.0 * r, tensors)
        out.append((name, path))
    return out


def _prompts(vocab):
    rng = np.random.RandomState(21)
    return [[int(x) for x in rng.randint(1, vocab, n)] for n in (27, 70)]  # 70: three chunks of 32


async def _gen_all(engine, prompts, sp, n=8):
    async def one(i, prompt, name):
        out = []
        async for o in engine.generate(f"lr{i}-{time.monotonic_ns()}", prompt_token_ids=prompts[prompt],
                                       lora_name=name, params=sp(max_tokens=n, temperature=0.0, ignore_eos=True)):
            out += o.token_ids
        return out

    return await asyncio.gather(*(one(i, p, name) for i, (p, name) in enumerate(REQUESTS)))


def chunk_inputs(vocab):
    """A four-row prefill chunk on fresh pages, rows 1 and 3 ragged, on
    slots CHUNK_SLOTS."""
    rng = np.random.RandomState(5)
    B, T = 4, 16
    pos = np.full((B, T), -1, np.int32)
    for b, n in enumerate((16, 11, 16, 5)):
        pos[b, :n] = np.arange(n)
    common = dict(input_ids=rng.randint(0, vocab, (B, T)).astype(np.int32), positions=pos,
                  page_table=np.arange(1, 1 + 2 * B, dtype=np.int32).reshape(B, 2),
                  kv_lens=(pos >= 0).sum(1).astype(np.int32), temperature=np.zeros(B, np.float32),
                  top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
                  lora_ids=np.asarray(CHUNK_SLOTS, np.int32))
    return JaxStepInput(**common), StepInput(**common)


def one_rank_lora(model, adapters, targets=ALL7) -> dict:
    """A one-rank runner's LoRA buffers with ``adapters`` loaded (slots 1,
    2 in order)."""
    _, _, net = load_model(model, device="cpu")
    runner = ModelRunner(net, num_pages=8, page_size=8, device="cpu", enable_lora=True, max_loras=len(adapters),
                         max_lora_rank=MAX_RANK, lora_targets=targets)
    mgr = tlora.LoRAManager(runner, max_loras=len(adapters), max_rank=MAX_RANK)
    for name, path in adapters:
        mgr.load(name, path)
    return runner.lora


def assert_lora_bit_equal(got, want):
    assert len(got["layers"]) == len(want["layers"])
    for li, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert g.keys() == w.keys(), li
        for name in w:
            assert g[name].dtype == w[name].dtype and g[name].shape == w[name].shape, (li, name)
            assert torch.equal(g[name].view(torch.uint8), w[name].view(torch.uint8)), (li, name)
    assert torch.equal(got["scale"], want["scale"])


def run_mesh(mesh, adapters, model=MODEL, lora=LORA, planted=None):
    """The JAX engine and a port engine (its weights, served over HTTP on a
    loop thread) at ``mesh`` with ``adapters`` loaded (the port's over
    HTTP); every runner call on the port engine runs on its loop thread.
    With ``planted`` (a MoE model's experts for the chunk) the chunk runs
    again with them replayed on every rank. Returns what the tests read."""
    cfg = tllama.PRESETS[model]
    jeng = JaxEngine(JaxEngineConfig(model=model, **mesh, **SMALL, **lora))
    lp, srv, app = _Loop(), None, None
    res = {}
    try:
        res["params"] = params_from_jax(jax.device_get(jeng.runner.params), cfg)
        pcfg = EngineConfig(model=model, **mesh, **GLOO, **SMALL, **lora, host="127.0.0.1")
        peng = LLMEngine(pcfg, device="cpu", params=res["params"])
        # the HTTP port is picked once the ranks' gloo connections hold
        # theirs: a free port picked before could be taken by one of them
        pcfg = dataclasses.replace(pcfg, port=free_port())
        srv, app = lp.run(port_server.serve(pcfg, peng, device="cpu"))
        base = f"http://127.0.0.1:{pcfg.port}"

        def on_loop(fn):
            return peng._run_on_device_thread(fn)

        res["wrapped"] = (isinstance(peng.runner, BroadcastingRunner), peng.lora.runner is peng.runner)
        res["digest"] = [on_loop(peng.runner.lora_digest)]
        for name, path in adapters:
            jeng.load_lora_adapter(name, path)
            res.setdefault("loads", []).append(call(base, "POST", "/v1/load_lora_adapter",
                                                    {"lora_name": name, "lora_path": path}))
        res["models"] = call(base, "GET", "/v1/models")
        res["digest"].append(on_loop(peng.runner.lora_digest))
        res["gathered"] = on_loop(peng.runner.gathered_lora)
        res["jax_lora"] = tllama.lora_from_jax(jax.device_get(jeng.runner.lora), cfg)
        res["lora_bytes"] = on_loop(peng.runner.rank_stats)[:, RANK_STATS.index("lora_bytes")]
        jinp, tinp = chunk_inputs(cfg.vocab_size)
        res["logits"] = (on_loop(lambda: peng.runner.step(tinp)[1].numpy()), np.asarray(jeng.runner.step(jinp)[1]))
        if planted is not None:
            def replayed():
                peng.runner.replay_routes(planted)
                try:
                    return peng.runner.step(tinp)[1].numpy()
                finally:
                    peng.runner.replay_routes(None)

            res["replayed"] = on_loop(replayed)
        jeng.runner.reset_kv()
        on_loop(peng.runner.reset_kv)
        jeng.start()
        prompts = _prompts(cfg.vocab_size)
        res["jax"] = asyncio.run(_gen_all(jeng, prompts, JaxSamplingParams))
        res["port"] = asyncio.run(_gen_all(peng, prompts, SamplingParams))
        res["unloads"] = [call(base, "POST", "/v1/unload_lora_adapter", {"lora_name": name}) for name, _ in adapters]
        res["digest"].append(on_loop(peng.runner.lora_digest))
        res["after_unload"] = call(base, "GET", "/v1/models")
    finally:
        jeng.stop()
        if app is not None:
            lp.run(app.cleanup())
            srv.engine.stop()
        lp.close()
    return res


def check_mesh(res, adapters, one_rank, ranks, replicas):
    """The checks every mesh's run passes (``ranks`` processes, whose
    global ranks r and r + ``replicas[1]`` ... hold the same buffers when
    ``replicas`` = (count, stride))."""
    names = [n for n, _ in adapters]
    assert res["wrapped"] == (True, True)
    assert [st for st, _ in res["loads"]] == [200] * len(adapters)
    assert [b["slot"] for _, b in res["loads"]] == list(range(1, 1 + len(adapters)))
    st, body = res["models"]
    assert st == 200 and sorted(m["id"] for m in body["data"] if m.get("parent")) == sorted(names)
    np.testing.assert_allclose(*res["logits"], **F32)
    assert res["port"] == res["jax"]
    assert all(len(ids) == 8 for ids in res["port"])
    assert res["port"][0] != res["port"][1]  # the same prompt under base and under an adapter
    assert_lora_bit_equal(res["gathered"], one_rank)
    assert_lora_bit_equal(res["gathered"], res["jax_lora"])
    before, loaded, after = (np.asarray(d) for d in res["digest"])
    assert before.shape == (ranks, 32)
    assert all((loaded[r] != before[r]).any() for r in range(ranks))  # the load reached every rank
    np.testing.assert_array_equal(after, before)  # the unload zeroed every rank's slots
    n, stride = replicas
    for r in range(stride):
        assert len({loaded[r + i * stride].tobytes() for i in range(n)}) == 1, r
    assert [st for st, _ in res["unloads"]] == [200] * len(adapters)
    assert not [m for m in res["after_unload"][1]["data"] if m.get("parent")]


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    return write_adapters(tmp_path_factory.mktemp("lora_ranks"), tllama.PRESETS[MODEL])


@pytest.fixture(scope="module")
def one_rank(adapters):
    return one_rank_lora(MODEL, adapters)


@pytest.fixture(scope="module")
def mesh_runs(eight_devices, adapters):
    """Every mesh of MESHES in both packages, one port engine with ranks at
    a time (a process leads one engine's ranks)."""
    return {tag: run_mesh(mesh, adapters) for tag, mesh in MESHES.items()}


# (ranks, (replicas, stride)): the dp replicas of one tp place are ranks t,
# t + tp, ...
LAYOUT = {"tp2": (2, (1, 2)), "dp2": (2, (2, 1)), "dp2tp2": (4, (2, 2))}


@pytest.mark.parametrize("tag", list(MESHES))
def test_adapters_at_the_mesh_match_the_jax_engine_and_reach_every_rank(mesh_runs, adapters, one_rank, tag):
    check_mesh(mesh_runs[tag], adapters, one_rank, *LAYOUT[tag])


@pytest.mark.parametrize("tag", list(MESHES))
def test_each_rank_holds_its_share_of_the_lora_buffers(mesh_runs, one_rank, tag):
    """tp splits every target's one factor in two (a rank holds less than
    the whole and more than half of it: the other factor is every rank's);
    a dp replica holds the whole."""
    whole = sum(t.numel() * t.element_size() for layer in one_rank["layers"] for t in layer.values())
    whole += one_rank["scale"].numel() * 4
    got = mesh_runs[tag]["lora_bytes"]
    assert len(set(got)) == 1
    if "tp" in tag:
        assert whole / 2 < got[0] < whole
    else:
        assert got[0] == whole


# -- unit cases -------------------------------------------------------------------


def test_the_lora_split_rule_is_derived_from_the_projections():
    """``b`` of a column-parallel target splits on its out axis, ``a`` of a
    row-parallel one on its in axis; the other factor and an unknown or
    expert target have no rule of their own."""
    for t in ALL7:
        col = split_axis(f"layers.0.{t}") == 1
        assert split_axis(f"layers.3.a_{t}") == (None if col else 1), t
        assert split_axis(f"layers.3.b_{t}") == (2 if col else None), t
    for bad in ("layers.0.a_moe_gate", "layers.0.a_attn_norm", "layers.0.c_wq"):
        with pytest.raises(KeyError, match="no tp split rule"):
            split_axis(bad)


def _stand_in(r, n):
    return types.SimpleNamespace(rank=r, size=n)


def rank_runner(model=MODEL, targets=ALL7, p=0, pp=1, d=0, dp=1, s=0, sp=1, e=0, ep=1, t=0, tp=1):
    """A LoRA runner of place (p, d, s, e, t) of a pp x dp x sp x ep x tp
    layout, its groups stand-ins (nothing here runs a collective)."""
    stage, group = (_stand_in(p, pp) if pp > 1 else None), (_stand_in(t, tp) if tp > 1 else None)
    _, _, net = load_model(model, device="cpu", tp=group, stage=stage)
    world = pp * dp * sp * ep * tp
    ranks = types.SimpleNamespace(size=tp, rank=t, expert=types.SimpleNamespace(size=ep * tp, ep_size=ep),
                                  dp=_stand_in(d, dp), world=_stand_in((((p * dp + d) * sp + s) * ep + e) * tp + t,
                                                                       world),
                                  stage=stage, seq=_stand_in(s, sp))
    return ModelRunner(net, num_pages=8, page_size=8, device="cpu", enable_lora=True, max_loras=2,
                       max_lora_rank=MAX_RANK, lora_targets=targets, tp=ranks)


@pytest.mark.parametrize("pp,tp", [(1, 2), (1, 4), (2, 1), (2, 2)])
def test_rank_buffers_join_back_to_one_ranks_bit_for_bit(adapters, one_rank, pp, tp):
    """Each place's runner takes the whole adapter and keeps its part of
    its stage's layers; ``join_lora`` of every place's buffers is the
    one-rank runner's, bit for bit, and an unload zeroes each place."""
    runners = [rank_runner(p=p, pp=pp, t=t, tp=tp) for p in range(pp) for t in range(tp)]
    for r in runners:
        mgr = tlora.LoRAManager(r, max_loras=2, max_rank=MAX_RANK)
        for name, path in adapters:
            mgr.load(name, path)
    first = runners[0].lora["layers"][0]
    assert first["b_wq"].shape[2] == 8 * 32 // tp and first["a_wo"].shape[1] == 8 * 32 // tp
    assert first["a_wq"].shape[1] == 128 and first["b_w_down"].shape[2] == 128
    assert len(runners[0].lora["layers"]) == 2 // pp
    assert_lora_bit_equal(tllama.join_lora([r.lora for r in runners], tp), one_rank)
    for r in runners:
        r.clear_lora_slot(1)
        r.clear_lora_slot(2)
        assert not any(t.any() for layer in r.lora["layers"] for t in layer.values()) and not r.lora["scale"].any()


def test_an_adapter_that_does_not_hold_the_models_layers_is_refused(adapters):
    r = rank_runner(tp=2)
    tensors, scale = tlora.LoRAManager(r, max_loras=2, max_rank=MAX_RANK).read_checkpoint(adapters[0][1])
    with pytest.raises(ValueError, match="holds 1 layers, the model 2"):
        r.set_lora_slot(1, {k: v[:1].numpy() for k, v in tensors.items()}, scale)


def test_the_step_stream_carries_a_whole_adapter_bit_for_bit():
    """set_lora_slot's arguments as the leader sends them: a dict of f32
    and bf16 arrays and a float, back bit for bit; the four LoRA calls are
    replicated."""
    rng = np.random.RandomState(0)
    f32 = rng.randn(2, 128, 16).astype(np.float32)
    bf16 = numpy_from_tensor(torch.from_numpy(rng.randn(2, 16, 256).astype(np.float32)).to(torch.bfloat16))
    method, args, kwargs = _unpack_call(_pack_call("set_lora_slot", (2, {"a_wq": f32, "b_wq": bf16}, 0.5), {}))
    slot, tensors, scale = args
    assert (method, slot, scale, kwargs) == ("set_lora_slot", 2, 0.5, {})
    assert tensors["a_wq"].dtype == np.float32 and tensors["a_wq"].tobytes() == f32.tobytes()
    assert tensors["b_wq"].dtype == ml_dtypes.bfloat16 and tensors["b_wq"].tobytes() == bf16.tobytes()
    assert torch.equal(tensor_from_numpy(tensors["b_wq"]).view(torch.int16),
                       tensor_from_numpy(bf16).view(torch.int16))
    assert {"set_lora_slot", "clear_lora_slot", "gathered_lora", "lora_digest"} <= set(REPLICATED)


@pytest.mark.parametrize("mesh", list(MESHES.values()) + [
    dict(expert_parallel_size=2), dict(pipeline_parallel_size=2, tensor_parallel_size=2),
    dict(sequence_parallel_size=2, tensor_parallel_size=2)], ids=list(MESHES) + ["ep2", "pp2tp2", "sp2tp2"])
def test_check_supported_takes_lora_at_every_rank_layout(mesh):
    check_supported(EngineConfig(**mesh, **LORA, **GLOO))


@pytest.mark.parametrize("model", ["gemma2-debug", "opt-debug"])
def test_lora_on_gemma2_and_opt_stays_refused_on_a_tp_rank(model):
    with pytest.raises(ValueError, match=r"\(llama-family only\)"):
        rank_runner(model, t=1, tp=2)
