"""Speculative decoding at sequence and pipeline ranks in the port
(runner.step_spec's verify forward, T = 1 + k, through the ring at sp, a
stage's microbatches through the prefill kernel's plain version at pp; the
dp replica sync after a dispatch at dp x sp) against the JAX package on
its virtual 8-device CPU mesh. The verify forward alone, through rank
processes against the JAX forward: tests/test_torch_spec_verify.py.

Engines on ``llama-debug-4kv-f32`` with ``speculative_k=4`` at sp 2, pp 2
and dp 2 x sp 2: greedy tokens of three concurrent prompts equal to the
JAX spec engine's at the same mesh and to a one-rank port engine's
without speculation; the replicas' digests agree after serving; runner
calls (a chunk, step_spec twice from the same state, a chain after it)
give one rank's tokens, drafts accepted.
"""


import jax
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.models import llama as tllama
from test_torch_seq_compose import replicas_equal
from test_torch_sp import GLOO, MODEL, SMALL, _gen_all
from test_torch_tp import spec_then_chain

K = 4
SPEC = dict(speculative_k=K)
ENGINE_MESHES = {"sp2": dict(sequence_parallel_size=2), "pp2": dict(pipeline_parallel_size=2),
                 "dp2sp2": dict(data_parallel_size=2, sequence_parallel_size=2)}


def _prompts():
    """Three prompts whose tails repeat earlier n-grams (drafts that verify
    can accept), one of them three 32-token chunks long."""
    rng = np.random.RandomState(23)
    base = [int(x) for x in rng.randint(1, 512, 7)]
    return [base * 2, [int(x) for x in rng.randint(1, 512, 11)] + base, (base * 11)[:70]]


# -- engines with speculative_k ----------------------------------------------------------


@pytest.fixture(scope="module")
def spec_runs(eight_devices):
    """At each ENGINE_MESHES layout the JAX spec engine's greedy tokens and a
    port spec engine's (the first JAX engine's weights), its replica
    digests, and the runner calls of tests/test_torch_tp.spec_then_chain;
    the same prompts from a one-rank port engine without speculation, and
    its runner calls."""
    prompts = _prompts()
    out, params = {}, None
    for tag, mesh in {**ENGINE_MESHES, "one": {}}.items():
        res = out[tag] = {}
        if tag != "one":
            jeng = JaxEngine(JaxEngineConfig(model=MODEL, **mesh, **SPEC, **SMALL))
            if params is None:
                params = params_from_jax(jax.device_get(jeng.runner.params), tllama.PRESETS[MODEL])
            jeng.start()
            try:
                res["jax"] = _gen_all(jeng, prompts, JaxSamplingParams)
            finally:
                jeng.stop()
        peng = LLMEngine(EngineConfig(model=MODEL, **mesh, **({} if tag == "one" else SPEC), **GLOO, **SMALL),
                         device="cpu", params=params)
        try:
            res["calls"] = spec_then_chain(peng, [0.0] * 4)
            peng.runner.reset_kv()
            peng.start()
            res["port"] = _gen_all(peng, prompts)
            res["digests"] = [bytes(d) for d in peng.runner.replica_digest()]
            res["stats"] = peng.stats()
        finally:
            peng.stop()
    return out


@pytest.mark.parametrize("tag", list(ENGINE_MESHES))
def test_spec_tokens_match_the_jax_spec_engine_and_greedy(spec_runs, tag):
    """The port's spec engine at the mesh gives the JAX spec engine's
    tokens at the same mesh, which are one rank's greedy tokens without
    speculation; the decode ran as verify rounds (drafts scored; the
    runner test below holds accepted drafts)."""
    res = spec_runs[tag]
    assert res["port"] == res["jax"] == spec_runs["one"]["port"]
    assert [len(x) for x in res["port"]] == [8] * 3
    s = res["stats"]
    assert s["spec_decode_num_draft_tokens_total"] > 0
    assert s["mesh_devices"] == {"sp2": 2, "pp2": 2, "dp2sp2": 4}[tag]


@pytest.mark.parametrize("tag", list(ENGINE_MESHES))
def test_the_replicas_agree_after_spec_rounds(spec_runs, tag):
    """After serving, and after step_spec and a chain through the runner:
    every sp and dp replica of a stage holds its pool bytes (the dp sync
    after a dispatch covers what each group's rounds wrote)."""
    pp = ENGINE_MESHES[tag].get("pipeline_parallel_size", 1)
    assert replicas_equal(spec_runs[tag]["digests"], pp)
    assert replicas_equal([bytes(d) for d in spec_runs[tag]["calls"][2]], pp)


@pytest.mark.parametrize("tag", list(ENGINE_MESHES))
def test_step_spec_and_a_chain_at_the_mesh_give_one_ranks_tokens(spec_runs, tag):
    """step_spec (3 rounds, k 3, n 2) from a prompt's sampled token, the
    second time with its history primed so the first round accepts all 3
    drafts, then a chain of 3 bursts of 2: one rank's tokens."""
    spec, chain, _ = spec_runs[tag]["calls"]
    one_spec, one_chain, _ = spec_runs["one"]["calls"]
    np.testing.assert_array_equal(spec, one_spec)
    np.testing.assert_array_equal(chain, one_chain)
    assert (spec >= 0).sum() > 4 * 3  # more than one token a round somewhere
