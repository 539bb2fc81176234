"""Mixtral across pipeline stages in the port (a stage's layers' experts split
over its expert group, parallel/pipeline.stage_routes, the runner's route
replay a stage at a time) against the JAX package on its virtual 8-device
CPU mesh (tests/test_parallel_serving.py's pipeline and expert meshes).

On an f32 copy of mixtral-debug (2 layers, 4 experts of I 256, NH 4, KH 2;
the preset replaced in both packages, the spawned ranks take the leader's
config), with the JAX engine's weights, at pp 2, pp 2 x ep 2 and pp 2 x tp
2:

- a four-row prefill chunk's logits within 2e-5 of the JAX runner's at the
  same mesh;
- the same chunk with planted experts replayed on every rank
  (``runner.replay_routes``: each stage takes its layers' routes, a
  microbatch at a time) within 2e-5 of one rank's replay, where the routers'
  own picks differ;
- greedy tokens of three concurrent prompts equal to the JAX engine's at
  the mesh and to one rank's;
- the ep replicas of a stage hold byte-identical pools; each rank holds its
  stage's layers of 1/tp of the heads; the MoE sums cross the stage's
  expert group; a page gathered over the stages is one rank's (layer 0 byte
  for byte, within 2e-5) and one rank's page written back reads back byte
  for byte; the gathered experts are the whole model's;
- adapters (LoRA on the attention) at pp 2 x ep 2: logits, tokens and
  planted experts against the JAX engine and one rank, the buffers joined
  back bit-equal.

``run_moe_mesh`` and the ``check_*`` functions are shared with
tests/test_torch_moe_seq.py.
"""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
from production_stack_tpu_torch.engine.runner import RANK_STATS, ModelRunner
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel import pipeline
from test_torch_ep import _planted, _prefill_inputs, _prompts
from test_torch_lora_ranks import ATTN, MAX_RANK, check_mesh, chunk_inputs, one_rank_lora, run_mesh, write_adapters

F32 = dict(atol=2e-5, rtol=2e-5)
MODEL = "mixtral-debug"  # 2 layers, 4 experts, NH 4, KH 2
SMALL = dict(max_model_len=128, num_pages=64, page_size=8, max_num_seqs=4, decode_steps=2, prefill_chunk=32)
GLOO = dict(tp_backend="gloo")
MESHES = {"pp2": dict(pipeline_parallel_size=2), "pp2ep2": dict(pipeline_parallel_size=2, expert_parallel_size=2),
          "pp2tp2": dict(pipeline_parallel_size=2, tensor_parallel_size=2)}
GATHERED = ["layers.0.moe_gate", "layers.1.moe_up", "layers.1.moe_down", "layers.1.moe_router", "layers.0.wk",
            "embed"]


@pytest.fixture(scope="module")
def twin():
    """The f32 copy of mixtral-debug, registered in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jllama.PRESETS, MODEL, dataclasses.replace(jllama.PRESETS[MODEL], dtype=jnp.float32))
        mp.setitem(tllama.PRESETS, MODEL, dataclasses.replace(tllama.PRESETS[MODEL], dtype=torch.float32))
        yield tllama.PRESETS[MODEL]


def _gen_all(engine, prompts, sp=SamplingParams, n=8):
    async def one(i, ids):
        out = []
        async for o in engine.generate(f"m{i}-{time.monotonic_ns()}", prompt_token_ids=ids,
                                       params=sp(max_tokens=n, temperature=0.0, ignore_eos=True)):
            out += o.token_ids
        return out

    async def run():
        return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))

    return asyncio.run(run())


def _first_page(engine):
    h = next(iter(engine.kv.hash_to_page))
    return h, [x[0] for x in engine.runner.get_pages([engine.kv.hash_to_page[h]])]


def run_moe_mesh(mesh: dict, params=None) -> dict:
    """The JAX engine and a port engine (the JAX engine's weights, or
    ``params``) at ``mesh`` (EngineConfig fields), or one rank's port engine
    for ``mesh`` {}: the chunk's logits, the chunk with planted experts
    replayed, the greedy tokens of three concurrent prompts, the replicas'
    digests, the layout, the rank stats, the first page, and at a mesh one
    rank's page restored and the gathered experts."""
    cfg = tllama.PRESETS[MODEL]
    jinp, tinp = _prefill_inputs()
    prompts = _prompts()
    res = {}
    jeng = JaxEngine(JaxEngineConfig(model=MODEL, **mesh, **SMALL)) if mesh else None
    peng = None
    try:
        if jeng is not None:
            params = params_from_jax(jax.device_get(jeng.runner.params), cfg)
            res["jax_logits"] = np.asarray(jeng.runner.step(jinp)[1])
            jeng.runner.reset_kv()
        res["params"] = params
        peng = LLMEngine(EngineConfig(model=MODEL, **mesh, **GLOO, **SMALL), device="cpu", params=params)
        res["logits"] = peng.runner.step(tinp)[1].numpy()
        peng.runner.reset_kv()
        peng.runner.replay_routes(_planted(cfg, tinp))
        tape = peng.runner.route_tape
        res["replayed"] = (peng.runner.step(tinp)[1].numpy(), tape.overridden, len(tape.picks) == len(tape.replay))
        peng.runner.replay_routes(None)
        peng.runner.reset_kv()
        if jeng is not None:
            jeng.start()
            res["jax"] = _gen_all(jeng, prompts, JaxSamplingParams)
        peng.start()
        peng.runner.rank_stats(reset=True)
        res["port"] = _gen_all(peng, prompts)
        res["digest"] = peng.runner.replica_digest()
        s = peng.stats()
        res["shape"] = (s["mesh_devices"], peng.runner.kv_pool_shard_layout(), peng.runner.rank_stats(),
                        tuple(peng.runner.k_pages.shape))
        res["page"] = _first_page(peng)
        if mesh:
            res["gathered"] = peng.runner.gathered_params(GATHERED)
    finally:
        if jeng is not None:
            jeng.stop()
        if peng is not None:
            peng.stop()
    return res


def check_logits(res: dict, one: dict) -> None:
    """The chunk's f32 logits within 2e-5 of the JAX runner's at the mesh."""
    assert res["logits"].shape == (4, tllama.PRESETS[MODEL].vocab_size)
    np.testing.assert_allclose(res["logits"], res["jax_logits"], **F32)


def check_replay(res: dict, one: dict) -> None:
    """The chunk with planted experts replayed on every rank within 2e-5 of
    one rank's replay; the leader's routers took every entry it replays,
    where their own picks differ, and the planted experts move one rank's
    logits by far more than the bound."""
    got, overridden, whole = res["replayed"]
    np.testing.assert_allclose(got, one["replayed"][0], **F32)
    assert overridden > 0 and whole
    assert np.abs(one["replayed"][0] - one["logits"]).max() > 100 * F32["atol"]


def check_tokens(res: dict, one: dict) -> None:
    """Greedy tokens of three concurrent prompts: the JAX engine's at the
    mesh and one rank's."""
    assert res["port"] == res["jax"] == one["port"]
    assert all(len(ids) == 8 for ids in res["port"])


def check_layout(res: dict, one: dict, mesh: dict) -> None:
    """The replicas of a place along ep (and sp) hold the same pools; each
    rank holds its stage's layers of 1/tp of the heads, 1/(pp x tp) of one
    rank's pool bytes; every rank ran its steps and the decode's plain
    version, its MoE sums crossed the expert group where it has more than
    one rank, its relays the stages at pp and its ring the sequence ranks
    at sp, whose chunks run no prefill kernel."""
    cfg = tllama.PRESETS[MODEL]
    pp, sp = mesh.get("pipeline_parallel_size", 1), mesh.get("sequence_parallel_size", 1)
    ep, tp = mesh.get("expert_parallel_size", 1), mesh.get("tensor_parallel_size", 1)
    ranks = pp * sp * ep * tp
    per = sp * ep * tp  # the ranks of one stage
    digests = [bytes(d) for d in res["digest"]]
    for q in range(pp):
        for t in range(tp):
            assert len({digests[q * per + r] for r in range(t, per, tp)}) == 1, (q, t)
    devices, layout, stats, shape = res["shape"]
    (_, whole), = one["shape"][1]
    assert devices == ranks and len(layout) == ranks and {b for _, b in layout} == {whole // (pp * tp)}
    assert shape == (cfg.num_layers // pp, SMALL["num_pages"], SMALL["page_size"], cfg.num_kv_heads // tp,
                     cfg.head_dim)
    col = RANK_STATS.index
    assert stats.shape == (ranks, len(RANK_STATS))
    for row in stats:
        assert row[col("decode_attention_ref")] > 0 and row[col("steps")] > 0
        assert (row[col("expert_calls")] > 0) == (ep * tp > 1)
        assert (row[col("relay_calls")] > 0) == (pp > 1) and (row[col("ring_calls")] > 0) == (sp > 1)
        assert (row[col("prefill_attention_ref")] > 0) == (sp == 1)


def check_page_and_params(res: dict, one: dict) -> None:
    """The first page of the same prompt gathered at the mesh: one rank's
    layout, layer 0 (before any MoE sum) byte for byte, within 2e-5; the
    gathered experts, router and attention are the whole model's."""
    h, page = res["page"]
    h1, page1 = one["page"]
    assert h == h1
    for a, b in zip(page, page1):
        assert a.shape == b.shape and a[0].tobytes() == b[0].tobytes()
        np.testing.assert_allclose(a, b, **F32)
    whole = res["params"]
    for name, t in res["gathered"].items():
        assert t.shape == whole[name].shape and torch.equal(t, whole[name]), name


@pytest.fixture(scope="module")
def stage_runs(eight_devices, twin):
    out = {tag: run_moe_mesh(mesh) for tag, mesh in MESHES.items()}
    out["one"] = run_moe_mesh({}, out["pp2"]["params"])
    return out


@pytest.mark.parametrize("tag", list(MESHES))
def test_prefill_logits_match_the_jax_runner_at_the_mesh(stage_runs, tag):
    check_logits(stage_runs[tag], stage_runs["one"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_planted_experts_replayed_a_stage_at_a_time_give_one_ranks_logits(stage_runs, tag):
    check_replay(stage_runs[tag], stage_runs["one"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_greedy_tokens_match_the_jax_engine_and_one_rank(stage_runs, tag):
    check_tokens(stage_runs[tag], stage_runs["one"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_the_replicas_layout_and_rank_stats_count_every_rank(stage_runs, tag):
    check_layout(stage_runs[tag], stage_runs["one"], MESHES[tag])


@pytest.mark.parametrize("tag", list(MESHES))
def test_a_page_and_the_experts_gathered_over_the_stages_are_one_ranks(stage_runs, tag):
    check_page_and_params(stage_runs[tag], stage_runs["one"])


def test_stage_routes_take_the_stages_layers_a_microbatch_at_a_time():
    """A one-rank run's routes of two forwards (4 rows, 2 layers) as each
    stage of pp 2 routes them: 4 microbatches of a row (``microbatches(4,
    2)``), the stage's one layer each; pp 1 takes them as they are."""
    picks = [np.full((4, 3, 2), 10 * f + layer) + np.arange(4)[:, None, None] * 100
             for f in range(2) for layer in range(2)]
    picks = [torch.as_tensor(p) for p in picks]
    stage = type("S", (), {"size": 2})
    for p in range(2):
        stage.rank = p
        got = pipeline.stage_routes(picks, 2, stage)
        assert pipeline.microbatches(4, 2) == 4 and len(got) == 8
        for i, g in enumerate(got):
            f, m = divmod(i, 4)
            assert torch.equal(g, picks[2 * f + p][m: m + 1])
    assert pipeline.stage_routes(picks, 2, None) == picks
    with pytest.raises(ValueError, match="not whole forwards"):
        pipeline.stage_routes(picks[:3], 2, stage)


def test_an_adapter_at_pp2_ep2_matches_the_jax_engine_and_one_rank(eight_devices, twin, tmp_path):
    """The rank-8 and rank-16 adapters on the attention at pp 2 x ep 2: the
    chunk's logits within 2e-5 of the JAX runner's, greedy tokens of base
    and adapter requests the JAX engine's, the planted experts with the
    adapter rows within 2e-5 of one rank's, the buffers joined back over the
    stages bit-equal to one rank's and the JAX runner's; every rank's slots
    written and zeroed."""
    adapters = write_adapters(tmp_path, twin, ATTN)
    lora = dict(enable_lora=True, max_loras=2, max_lora_rank=MAX_RANK)
    mesh = MESHES["pp2ep2"]
    tinp = chunk_inputs(twin.vocab_size)[1]
    res = run_mesh(mesh, adapters, MODEL, lora, _planted(twin, tinp))
    # (ranks, (replicas, stride)): the ep replicas of a stage are ranks 2p and 2p + 1
    check_mesh(res, adapters, one_rank_lora(MODEL, adapters, ATTN), 4, (2, 1))
    _, _, net = load_model(MODEL, device="cpu", params=res["params"])
    runner = ModelRunner(net, num_pages=SMALL["num_pages"], page_size=SMALL["page_size"], device="cpu",
                         enable_lora=True, max_loras=2, max_lora_rank=MAX_RANK, lora_targets=ATTN)
    mgr = tlora.LoRAManager(runner, max_loras=2, max_rank=MAX_RANK)
    for name, path in adapters:
        mgr.load(name, path)
    runner.replay_routes(_planted(twin, tinp))
    np.testing.assert_allclose(res["replayed"], runner.step(tinp)[1].numpy(), **F32)


@pytest.mark.parametrize("mesh", [dict(pipeline_parallel_size=2, expert_parallel_size=2),
                                  dict(pipeline_parallel_size=2, expert_parallel_size=2, tensor_parallel_size=2),
                                  dict(pipeline_parallel_size=2, expert_parallel_size=2, enable_lora=True)],
                         ids=["pp2ep2", "pp2ep2tp2", "pp2ep2-lora"])
def test_check_supported_takes_moe_at_pp_with_ep(mesh):
    """Once refused by name, now served: pp with ep ranks and a MoE model."""
    check_supported(EngineConfig(model=MODEL, **mesh, **GLOO))
