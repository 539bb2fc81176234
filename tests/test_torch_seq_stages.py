"""Sequence ranks beside pipeline stages in the port (pp 2 x sp 2: each
stage's chunk split over its sequence ranks, models/llama.py ``_chunk_sp``
inside parallel/pipeline.run, each stage's sequence rank s relaying its
token slice to the next stage's rank s, the last stage gathering what the
head reads) against the JAX package on its virtual 8-device CPU mesh, with
tests/test_torch_seq_compose.py's checks: a decode step's and a prefill
chunk's logits and written slots within 2e-5 of the JAX forward on the
same mesh and pools, every other slot byte for byte; greedy ids equal to
the JAX engine's at pp 2 x sp 2; each stage's sequence ranks one digest,
the stages two; the layout, labels and rank stats (relays and the ring on
every rank); a page gathered over the stages read back byte for byte; an
adapter's load and unload reaching every rank.
"""

import pytest

from test_torch_seq_compose import (
    check_forward,
    check_layout,
    check_lora,
    check_page,
    check_replicas,
    check_tokens,
    compose_run,
)

PP_SP = dict(pipeline_parallel_size=2, sequence_parallel_size=2)


@pytest.fixture(scope="module")
def pp_sp_run(eight_devices):
    return compose_run(PP_SP)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_forward_at_pp2_sp2_matches_the_jax_forward(pp_sp_run, kind):
    check_forward(pp_sp_run, kind)


def test_greedy_tokens_at_pp2_sp2_match_the_jax_engine(pp_sp_run):
    check_tokens(pp_sp_run)


def test_each_stages_sequence_ranks_hold_the_same_pool_bytes(pp_sp_run):
    check_replicas(pp_sp_run)


def test_the_layout_and_rank_stats_at_pp2_sp2_count_every_rank(pp_sp_run):
    check_layout(pp_sp_run)


def test_a_page_gathered_over_the_stages_at_pp2_sp2_writes_back_byte_for_byte(pp_sp_run):
    check_page(pp_sp_run)


def test_an_adapter_load_and_unload_reach_every_rank_at_pp2_sp2(pp_sp_run):
    check_lora(pp_sp_run)
