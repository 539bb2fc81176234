"""Sequence ranks beside dp ranks in the port (dp 2 x sp 2: a dp replica's
chunk split over its sequence ranks, the sampled ids of each dp replica's
first rank, the dp replica sync beside the sp replicas) against the JAX
package on its virtual 8-device CPU mesh; the helpers are shared with
tests/test_torch_seq_stages.py (pp 2 x sp 2).

- The forward: the JAX ``llama.forward`` with ``attn_impl="pallas_interpret"``
  on a dp 2 x sp 2 mesh against a port engine's runner step across gloo
  ranks on the same random pools (tests/test_torch_sp.py's step inputs:
  eight rows, a decode step and a prefill chunk): logits and written slots
  within 2e-5, every other slot byte for byte as it was, the sp and dp
  replicas' pools the same bytes.
- Engines on ``llama-debug-4kv-f32``: the JAX tests' prompts (one of three
  chunks) give the JAX engine's greedy ids at the same mesh; the layout,
  labels and rank stats count every rank; the replicas' digests agree
  after serving and after a page written back, which reads back byte for
  byte; an adapter's load and unload (the replicated slot writes) reach
  every rank (the engines serve LoRA, every row on the base slot).
- An 8-rank forward (pp 2 x sp 2 x tp 2) and mixtral-debug at pp 2 x sp 2
  with routes replayed: tests/test_torch_seq_wide.py.
- The eleven configurations that were refused by name and are served now
  pass ``engine_geometry``; the refusals that stay keep their words.
"""

import pathlib
import tempfile

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.engine import LLMEngine, engine_geometry
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.runner import RANK_STATS
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel.group import device_labels, rank_place
from test_torch_lora_ranks import LORA, write_adapters
from test_torch_sp import (
    F32,
    GLOO,
    MODEL,
    SMALL,
    _gen_all,
    _jax_forward,
    _pools,
    _port_forward,
    _prompts,
    _step_inputs,
    _written_slots,
)

DP_SP = dict(data_parallel_size=2, sequence_parallel_size=2)


def _shape(mesh: dict) -> tuple:
    """(pp, dp, sp) of EngineConfig fields ``mesh``."""
    return tuple(mesh.get(f, 1) for f in ("pipeline_parallel_size", "data_parallel_size", "sequence_parallel_size"))


def replicas_equal(digests: list, pp: int) -> bool:
    """The ranks of one stage (dp 1 at pp 2, tp 1 here) are the dp and sp
    replicas of its pool and must give one digest; the stages hold other
    layers."""
    per = len(digests) // pp
    return all(len({digests[p * per + r] for r in range(per)}) == 1 for p in range(pp)) and \
        len({digests[p * per] for p in range(pp)}) == pp


def compose_run(mesh: dict) -> dict:
    """The f32 llama twin at ``mesh`` (EngineConfig fields) in both
    packages: the forward of a decode step and of a prefill chunk through
    a port engine's ranks against the JAX forward on the same mesh and
    pools, then both engines' greedy tokens of the prompts, the layout,
    the rank stats, the replica digests and a page round trip."""
    cfg = jllama.PRESETS[MODEL]
    pp, dp, sp = _shape(mesh)
    res = {"mesh": mesh, "pools": _pools(cfg)}
    kp, vp = res["pools"]
    jeng = JaxEngine(JaxEngineConfig(model=MODEL, **mesh, **SMALL))
    peng = None
    try:
        jparams = jax.device_get(jeng.runner.params)
        peng = LLMEngine(EngineConfig(model=MODEL, **mesh, **GLOO, **SMALL, **LORA), device="cpu",
                         params=params_from_jax(jparams, tllama.PRESETS[MODEL]))
        jmesh = make_mesh(dp=dp, sp=sp, pp=pp)
        for kind in ("decode", "prefill"):
            common, tinp = _step_inputs(kind)
            res[kind] = (_port_forward(peng, tinp, kp, vp), _jax_forward(jparams, cfg, jmesh, common, kp, vp), common)
        res["prompts"] = _prompts(peng.tokenizer)
        jeng.start()
        peng.start()
        peng.runner.rank_stats(reset=True)
        res["jax"] = _gen_all(jeng, res["prompts"], JaxSamplingParams)
        res["port"] = _gen_all(peng, res["prompts"])
        s = peng.stats()
        res["shape"] = (s["mesh_devices"], peng.kv.num_pages, peng.runner.kv_pool_shard_layout(),
                        peng.runner.rank_stats(), tuple(peng.runner.k_pages.shape))
        res["digests"] = [bytes(d) for d in peng.runner.replica_digest()]
        pid = next(iter(peng.kv.hash_to_page.values()))
        page = [x[0] for x in peng.runner.get_pages([pid])]
        peng.runner.set_pages([1], [page[0]], [page[1]])
        res["page"] = (page, [x[0] for x in peng.runner.get_pages([1])],
                       [bytes(d) for d in peng.runner.replica_digest()])
        with tempfile.TemporaryDirectory() as tmp:
            name, path = write_adapters(pathlib.Path(tmp), tllama.PRESETS[MODEL])[0]
            before = [bytes(d) for d in peng.runner.lora_digest()]
            peng.load_lora_adapter(name, path)
            loaded = [bytes(d) for d in peng.runner.lora_digest()]
            peng.unload_lora_adapter(name)
            res["lora"] = (before, loaded, [bytes(d) for d in peng.runner.lora_digest()])
    finally:
        jeng.stop()
        if peng is not None:
            peng.stop()
    return res


def check_forward(run: dict, kind: str) -> None:
    """One step through the port's ranks against the JAX forward on the
    same mesh and pools (at T = 1 its sharded Pallas decode in interpret
    mode, each dp replica's rows or each stage's microbatch on the sp
    replicas of the pool; on the chunk its ring): f32 logits within 2e-5,
    the written slots within 2e-5, every other slot of every layer byte for
    byte the initial pool's, every replica's pools the same bytes."""
    (tl, tk, tv, digests), (jl, jk, jv), common = run[kind]
    kp, vp = run["pools"]
    np.testing.assert_allclose(tl, jl, **F32)
    written = _written_slots(common, kp)
    assert written.sum() == (common["positions"] >= 0).sum()
    for got, want, before in ((tk, jk, kp), (tv, jv, vp)):
        np.testing.assert_allclose(got, want, **F32)
        assert np.array_equal(got[:, ~written].view(np.uint32), before[:, ~written].view(np.uint32))
        assert not np.array_equal(got[:, written], before[:, written])
    assert replicas_equal(digests, _shape(run["mesh"])[0])


def check_tokens(run: dict) -> None:
    """Three concurrent prompts and a fourth of three chunks: the JAX
    engine's greedy ids at the same mesh (at dp 2 the replicas hold other
    rows, so a replica fed another replica's ids would show here)."""
    assert run["port"] == run["jax"]
    assert [len(x) for x in run["port"]] == [8] * 4
    assert max(len(p) for p in run["prompts"]) > 2 * SMALL["prefill_chunk"]


def check_replicas(run: dict) -> None:
    """After serving, and after a page written back: the ranks of a stage
    hold byte-identical pools (at dp 2 x sp 2 all four; at pp 2 x sp 2
    each stage's two sequence ranks), the stages other ones."""
    for digests in (run["digests"], run["page"][2]):
        assert replicas_equal(digests, _shape(run["mesh"])[0])


def check_layout(run: dict) -> None:
    """mesh_devices counts pp x dp x sp; each rank holds its stage's layers
    of every page (all heads at tp 1), the labels name each rank's place;
    every rank ran the decode kernel's plain version and no prefill kernel
    (chunks go through the ring), its sequence group carried the chunks,
    at pp its stage group the relays, at dp its dp group the replica
    sync."""
    pp, dp, sp = _shape(run["mesh"])
    ranks = pp * dp * sp
    devices, pages, layout, stats, pool = run["shape"]
    cfg = tllama.PRESETS[MODEL]
    assert devices == ranks and pages == SMALL["num_pages"]
    labels = device_labels([torch.device("cpu")] * ranks, dp=dp, pp=pp, sp=sp)
    assert [label for label, _ in layout] == labels
    outer = "dp" if dp > 1 else "pp"
    assert labels == [f"cpu:0/{outer}{a}sp{b}tp0" for a in range(2) for b in range(2)]
    whole = 2 * cfg.num_layers * pages * SMALL["page_size"] * cfg.num_kv_heads * cfg.head_dim * 4
    assert {b for _, b in layout} == {whole // pp}
    assert pool == (cfg.num_layers // pp, pages, SMALL["page_size"], cfg.num_kv_heads, cfg.head_dim)
    col = RANK_STATS.index
    assert stats.shape == (ranks, len(RANK_STATS))
    for row in stats:
        assert row[col("decode_attention_ref")] > 0 and row[col("steps")] > 0
        assert row[col("prefill_attention_ref")] == 0 and row[col("kv_page_write_ref")] == 0
        assert row[col("ring_calls")] > 0 and row[col("ring_bytes")] > 0
        assert (row[col("relay_calls")] > 0) == (pp > 1)
        assert (row[col("sync_bytes")] > 0) == (dp > 1)


def check_lora(run: dict) -> None:
    """An adapter loaded through the engine (``set_lora_slot``, a
    replicated call) reaches every rank: each rank's buffers change, the
    replicas of a stage hold the same bytes; its unload
    (``clear_lora_slot``) gives every rank its buffers back."""
    before, loaded, after = run["lora"]
    assert all(a != b for a, b in zip(before, loaded))
    assert replicas_equal(loaded, _shape(run["mesh"])[0])
    assert after == before


def check_page(run: dict) -> None:
    """A page gathered over the stages (the s = 0, d = 0 replica's) has
    every layer, and written back into every replica it reads back byte
    for byte."""
    page, back, _ = run["page"]
    cfg = tllama.PRESETS[MODEL]
    assert page[0].shape == (cfg.num_layers, SMALL["page_size"], cfg.num_kv_heads, cfg.head_dim)
    assert [x.tobytes() for x in back] == [x.tobytes() for x in page]


@pytest.fixture(scope="module")
def dp_sp_run(eight_devices):
    return compose_run(DP_SP)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_forward_at_dp2_sp2_matches_the_jax_forward(dp_sp_run, kind):
    check_forward(dp_sp_run, kind)


def test_greedy_tokens_at_dp2_sp2_match_the_jax_engine(dp_sp_run):
    check_tokens(dp_sp_run)


def test_the_dp_and_sp_replicas_hold_the_same_pool_bytes(dp_sp_run):
    check_replicas(dp_sp_run)


def test_the_layout_and_rank_stats_at_dp2_sp2_count_every_rank(dp_sp_run):
    check_layout(dp_sp_run)


def test_a_page_read_at_dp2_sp2_writes_back_byte_for_byte(dp_sp_run):
    check_page(dp_sp_run)


def test_an_adapter_load_and_unload_reach_every_rank_at_dp2_sp2(dp_sp_run):
    check_lora(dp_sp_run)


def test_labels_and_places_put_sequence_ranks_beside_dp_and_pp_ranks():
    """r = (((p * dp + d) * sp + s) * ep + e) * tp + t, the label naming
    each axis past 1."""
    cpu = torch.device("cpu")
    assert rank_place(5, dp=2, tp=2, sp=2) == (0, 1, 0, 0, 1)
    assert rank_place(3, dp=1, tp=1, pp=2, sp=2) == (1, 0, 1, 0, 0)
    assert rank_place(6, dp=1, tp=2, pp=2, sp=2) == (1, 0, 1, 0, 0)
    assert device_labels([cpu] * 8, pp=2, sp=2)[6] == "cpu:0/pp1sp1tp0"
    assert device_labels([cpu] * 8, dp=2, sp=2)[5] == "cpu:0/dp1sp0tp1"
    assert device_labels([cpu] * 8, dp=2, sp=2, ep=2)[5] == "cpu:0/dp1sp0ep1tp0"


# -- once refused, now served; what stays refused --------------------------------

# the configurations the port refused by name before it served sequence
# ranks beside dp and pp ranks and speculative decoding at sp and pp, each
# under the id it had in the refusal test it came from (that test's file
# first)
ONCE_REFUSED = {
    "sp-dp": dict(model="llama-debug", sequence_parallel_size=2, data_parallel_size=2),
    "sp-ep": dict(model="mixtral-debug", sequence_parallel_size=2, expert_parallel_size=2, data_parallel_size=2),
    "sp-moe": dict(model="mixtral-debug", sequence_parallel_size=2, pipeline_parallel_size=2),
    "sp-pp": dict(model="llama-debug", sequence_parallel_size=2, pipeline_parallel_size=2),
    "sp-spec": dict(model="llama-debug", sequence_parallel_size=2, speculative_k=4),
    "pp-moe": dict(model="mixtral-debug", pipeline_parallel_size=2, speculative_k=4),
    "pp-spec": dict(model="llama-debug", pipeline_parallel_size=2, speculative_k=4),
    "ep-sp": dict(model="mixtral-debug", expert_parallel_size=2, sequence_parallel_size=2, data_parallel_size=2),
    "ep-pp": dict(model="mixtral-debug", expert_parallel_size=2, pipeline_parallel_size=2, speculative_k=4),
    # and tests/test_torch_tp.py's, on its model (those cases now hold the
    # refusals that stay beside them)
    "tp-sp": dict(model=MODEL, sequence_parallel_size=2, data_parallel_size=2),
    "tp-pp": dict(model=MODEL, pipeline_parallel_size=2, speculative_k=4),
}


@pytest.mark.parametrize("overrides", list(ONCE_REFUSED.values()), ids=list(ONCE_REFUSED))
def test_once_refused_compositions_are_served(overrides):
    """Once refused by name, now served: the configuration passes
    check_supported and the refusals that read the model
    (``engine_geometry``), with gloo ranks on the CPU."""
    cfg = EngineConfig(**overrides, max_model_len=128, num_pages=16, page_size=8, **GLOO)
    check_supported(cfg, "cpu")
    model_cfg, pages = engine_geometry(cfg, "cpu")
    assert pages == 16 and model_cfg.num_layers % cfg.pipeline_parallel_size == 0


@pytest.mark.parametrize("overrides,match", [
    (dict(model="llama-debug", sequence_parallel_size=2, pipeline_parallel_size=2, data_parallel_size=2),
     "pipeline parallelism does not compose with in-engine data parallelism"),
    (dict(model="llama-debug", sequence_parallel_size=2, data_parallel_size=2, kv_cache_dtype="int8"),
     "--kv-cache-dtype int8 does not compose with sp/pp meshes"),
    (dict(model="llama-debug", pipeline_parallel_size=2, speculative_k=4, kv_cache_dtype="int8"),
     "--kv-cache-dtype int8 is not compatible with --speculative-k"),
    (dict(model="llama-debug", sequence_parallel_size=2, data_parallel_size=2, kv_transfer_device=True),
     "device KV transfer"),
], ids=["dp-pp", "int8-dpsp", "int8-spec-pp", "device-kv-dpsp"])
def test_the_refusals_around_the_new_compositions_stay(overrides, match):
    """dp with pp, int8 pools at sp or with speculative decoding (the JAX
    engine's words) and device KV transfer with ranks stay refused."""
    with pytest.raises(ValueError, match=match):
        LLMEngine(EngineConfig(**overrides, max_model_len=128, num_pages=16, page_size=8, **GLOO), device="cpu")
