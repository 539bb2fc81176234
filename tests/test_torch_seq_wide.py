"""Sequence ranks beside stages at their widest in the port, against the JAX
package on its virtual 8-device CPU mesh: eight ranks at pp 2 x sp 2 x tp
2, and Mixtral at pp 2 x sp 2 with its routes replayed a stage's
microbatch and a sequence rank's padded token slice at once
(parallel/pipeline.stage_routes composed with ring_attention.seq_routes).

- pp 2 x sp 2 x tp 2, forward only: the JAX ``llama.forward`` with
  ``attn_impl="pallas_interpret"`` on the 8-device mesh against a port
  engine's runner step across eight gloo ranks on the same random pools (a
  decode step and a prefill chunk, tests/test_torch_sp.py's inputs): logits
  and written slots within 2e-5, every other slot byte for byte as it was,
  each stage's tp column the same bytes on both sequence ranks.
- mixtral-debug (f32 copy) at pp 2 x sp 2, forward only: a four-row
  chunk's logits within 2e-5 of the JAX runner's at the mesh, and the
  chunk with planted experts replayed on every rank within 2e-5 of one
  rank's replay (tests/test_torch_moe_stages.py's checks; its engines'
  greedy tokens at pp and sp are in tests/test_torch_moe_stages.py and
  tests/test_torch_moe_seq.py).
"""

import jax
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.runner import RANK_STATS
from production_stack_tpu_torch.models import llama as tllama
from test_torch_ep import _planted, _prefill_inputs
from test_torch_moe_stages import MODEL as MOE_MODEL
from test_torch_moe_stages import check_logits, check_replay, twin  # noqa: F401 (twin: a fixture)
from test_torch_sp import F32, GLOO, MODEL, SMALL, _jax_forward, _pools, _port_forward, _step_inputs, _written_slots

WIDE = dict(pipeline_parallel_size=2, sequence_parallel_size=2, tensor_parallel_size=2)
MOE_MESH = dict(pipeline_parallel_size=2, sequence_parallel_size=2)


@pytest.fixture(scope="module")
def wide_runs(eight_devices):
    """A decode step and a prefill chunk through a port engine at pp 2 x sp
    2 x tp 2 (the JAX engine's weights) and through the JAX forward on the
    same mesh and pools."""
    cfg = jllama.PRESETS[MODEL]
    kp, vp = _pools(cfg)
    out = {"pools": (kp, vp)}
    jeng = JaxEngine(JaxEngineConfig(model=MODEL, **SMALL))
    try:
        jparams = jax.device_get(jeng.runner.params)
    finally:
        jeng.stop()
    peng = LLMEngine(EngineConfig(model=MODEL, **WIDE, **GLOO, **SMALL), device="cpu",
                     params=params_from_jax(jparams, tllama.PRESETS[MODEL]))
    try:
        for kind in ("decode", "prefill"):
            common, tinp = _step_inputs(kind)
            out[kind] = (_port_forward(peng, tinp, kp, vp),
                         _jax_forward(jparams, cfg, make_mesh(pp=2, sp=2, tp=2), common, kp, vp), common)
        out["labels"] = [label for label, _ in peng.runner.kv_pool_shard_layout()]
    finally:
        peng.stop()
    return out


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_an_eight_rank_step_at_pp2_sp2_tp2_matches_the_jax_forward(wide_runs, kind):
    """Logits and written slots within 2e-5 of the JAX forward on the
    8-device mesh, every other slot byte for byte the initial pool's; the
    two sequence ranks of each (stage, tp place) hold the same bytes, the
    four (stage, tp place) shards other ones."""
    (tl, tk, tv, digests), (jl, jk, jv), common = wide_runs[kind]
    kp, vp = wide_runs["pools"]
    np.testing.assert_allclose(tl, jl, **F32)
    written = _written_slots(common, kp)
    for got, want, before in ((tk, jk, kp), (tv, jv, vp)):
        np.testing.assert_allclose(got, want, **F32)
        assert np.array_equal(got[:, ~written].view(np.uint32), before[:, ~written].view(np.uint32))
    # r = ((p * sp + s) * tp + t: the sequence ranks of (p, t) are r and r + 2
    for p in range(2):
        for t in range(2):
            assert digests[p * 4 + t] == digests[p * 4 + 2 + t]
    assert len(set(digests)) == 4
    assert wide_runs["labels"][5] == "cpu:0/pp1sp0tp1"


def _moe_forward(mesh: dict, params=None) -> dict:
    """mixtral-debug (f32 twin) at ``mesh``, or one rank for {}: the JAX
    runner's logits of a four-row chunk at the mesh (and its weights), the
    port engine's, the same chunk with planted experts replayed on every
    rank, and the replicas' digests and rank stats after the replay."""
    cfg = tllama.PRESETS[MOE_MODEL]
    jinp, tinp = _prefill_inputs()
    res = {}
    if mesh:
        jeng = JaxEngine(JaxEngineConfig(model=MOE_MODEL, **mesh, **SMALL))
        try:
            params = params_from_jax(jax.device_get(jeng.runner.params), cfg)
            res["jax_logits"] = np.asarray(jeng.runner.step(jinp)[1])
        finally:
            jeng.stop()
    res["params"] = params
    peng = LLMEngine(EngineConfig(model=MOE_MODEL, **mesh, **GLOO, **SMALL), device="cpu", params=params)
    try:
        res["logits"] = peng.runner.step(tinp)[1].numpy()
        peng.runner.reset_kv()
        peng.runner.replay_routes(_planted(cfg, tinp))
        if mesh:
            peng.runner.rank_stats(reset=True)
        tape = peng.runner.route_tape
        res["replayed"] = (peng.runner.step(tinp)[1].numpy(), tape.overridden, len(tape.picks) == len(tape.replay))
        peng.runner.replay_routes(None)
        if mesh:
            res["stats"] = peng.runner.rank_stats()
            res["digests"] = [bytes(d) for d in peng.runner.replica_digest()]
    finally:
        peng.stop()
    return res


@pytest.fixture(scope="module")
def moe_runs(eight_devices, twin):  # noqa: F811
    out = {"mesh": _moe_forward(MOE_MESH)}
    out["one"] = _moe_forward({}, out["mesh"]["params"])
    return out


def test_mixtral_prefill_logits_at_pp2_sp2_match_the_jax_runner(moe_runs):
    """The four-row chunk's f32 logits at pp 2 x sp 2 within 2e-5 of the
    JAX runner's at the same mesh."""
    check_logits(moe_runs["mesh"], moe_runs["one"])


def test_mixtral_planted_experts_replayed_a_microbatch_and_a_token_slice_at_a_time(moe_runs):
    """Each rank replays its stage's layers of each microbatch on its
    padded token slice (``stage_routes`` then ``seq_routes``): within 2e-5
    of one rank's replay, the leader's routers overridden where they would
    pick otherwise; every rank of a stage the same pool bytes after it,
    relays and the ring on every rank."""
    check_replay(moe_runs["mesh"], moe_runs["one"])
    digests, stats = moe_runs["mesh"]["digests"], moe_runs["mesh"]["stats"]
    assert digests[0] == digests[1] and digests[2] == digests[3] and digests[0] != digests[2]
    col = RANK_STATS.index
    for row in stats:
        assert row[col("relay_calls")] > 0 and row[col("ring_calls")] > 0 and row[col("expert_calls")] == 0
