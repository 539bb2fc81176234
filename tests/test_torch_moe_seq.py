"""Mixtral across sequence ranks in the port (a chunk's tokens split over the
sequence ranks, each rank's MoE layers on its tokens, summed over the expert
group of its sequence place; parallel/ring_attention.seq_routes, the
runner's route replay a token slice at a time) against the JAX package on
its virtual 8-device CPU mesh.

On an f32 copy of mixtral-debug (the preset replaced in both packages), with
the JAX engine's weights, at sp 2 and sp 2 x ep 2, the checks of
tests/test_torch_moe_stages.py: a four-row prefill chunk's
logits within 2e-5 of the JAX runner's at the same mesh; the chunk with
planted experts replayed on every rank (each sequence rank its tokens'
routes, pads included) within 2e-5 of one rank's replay; greedy tokens of
three concurrent prompts equal to the JAX engine's at the mesh and to one
rank's; the sp and ep replicas hold byte-identical pools; no rank runs the
prefill kernel (a chunk goes through the ring) and every rank's sequence
group carried the chunks; a gathered page is one rank's (layer 0 byte for
byte); the gathered experts are the whole model's.
"""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.parallel.ring_attention import seq_routes
from test_torch_moe_stages import (  # noqa: F401 (twin: a fixture)
    GLOO,
    MODEL,
    check_layout,
    check_logits,
    check_page_and_params,
    check_replay,
    check_tokens,
    run_moe_mesh,
    twin,
)

MESHES = {"sp2": dict(sequence_parallel_size=2), "sp2ep2": dict(sequence_parallel_size=2, expert_parallel_size=2)}


@pytest.fixture(scope="module")
def seq_runs(eight_devices, twin):  # noqa: F811
    out = {tag: run_moe_mesh(mesh) for tag, mesh in MESHES.items()}
    out["one"] = run_moe_mesh({}, out["sp2"]["params"])
    return out


@pytest.mark.parametrize("tag", list(MESHES))
def test_prefill_logits_match_the_jax_runner_at_the_mesh(seq_runs, tag):
    check_logits(seq_runs[tag], seq_runs["one"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_planted_experts_replayed_a_token_slice_at_a_time_give_one_ranks_logits(seq_runs, tag):
    check_replay(seq_runs[tag], seq_runs["one"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_greedy_tokens_match_the_jax_engine_and_one_rank(seq_runs, tag):
    check_tokens(seq_runs[tag], seq_runs["one"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_the_replicas_layout_and_rank_stats_count_every_rank(seq_runs, tag):
    check_layout(seq_runs[tag], seq_runs["one"], MESHES[tag])


@pytest.mark.parametrize("tag", list(MESHES))
def test_a_page_and_the_experts_gathered_at_the_sequence_ranks_are_one_ranks(seq_runs, tag):
    check_page_and_params(seq_runs[tag], seq_runs["one"])


def test_seq_routes_take_the_ranks_tokens_pads_included():
    """A one-rank run's routes of a 5-token chunk and a decode step as each
    of 2 sequence ranks routes them: the chunk padded to 6 (the pad routed
    to experts 0 and 1) and cut in halves; the decode step whole; without a
    group the picks as they are."""
    chunk = torch.arange(2 * 5 * 2).reshape(2, 5, 2) + 10
    step = torch.arange(2 * 1 * 2).reshape(2, 1, 2) + 50
    for s in range(2):
        g = type("G", (), {"size": 2, "rank": s})
        got = seq_routes([chunk, step], g, 2)
        assert len(got) == 2 and torch.equal(got[1], step)
        want = chunk[:, :3] if s == 0 else torch.cat([chunk[:, 3:], torch.tensor([0, 1]).expand(2, 1, 2)], dim=1)
        assert torch.equal(got[0], want), s
    assert seq_routes([chunk], None, 2) == [chunk]
    assert np.array_equal(seq_routes([chunk], type("G", (), {"size": 1, "rank": 0}), 2)[0], chunk)


@pytest.mark.parametrize("mesh", [dict(sequence_parallel_size=2, expert_parallel_size=2),
                                  dict(sequence_parallel_size=2, expert_parallel_size=2, tensor_parallel_size=2),
                                  dict(sequence_parallel_size=2)], ids=["sp2ep2", "sp2ep2tp2", "sp2-moe"])
def test_check_supported_takes_moe_at_sp_with_ep(mesh):
    """Once refused by name, now served: sp with ep ranks and a MoE model."""
    check_supported(EngineConfig(model=MODEL, **mesh, **GLOO))
