"""Batched multi-LoRA across pipeline stages and sequence ranks of the port
against the JAX engine on its 8-device CPU mesh: pp 2, pp 2 x tp 2 and
sp 2 x tp 2 (tests/test_torch_lora_ranks.py holds tp and dp, and the
checks every mesh passes).

A stage holds its L/pp layers of every slot buffer, a tp rank its part of
each; the JAX forward carries the buffers through its pipeline's
microbatches, each taking its rows' slots, and through an sp chunk whose
tokens split over the sequence ranks (the rows stay whole). On the f32
twin with the JAX engine's weights and the rank-8 and rank-16 adapters on
all seven targets: a four-row prefill chunk's logits within 2e-5 of the
JAX runner's, greedy tokens of base and adapter requests equal to the JAX
engine's at the same mesh, the buffers joined back over the stages and the
tp ranks bit-equal to one rank's, every rank's slots written by a load over
HTTP and zeroed by the unload, the sp replicas equal.
"""

import pytest

from production_stack_tpu_torch.models import llama as tllama
from test_torch_lora_ranks import MODEL, check_mesh, one_rank_lora, run_mesh, write_adapters

MESHES = {"pp2": dict(pipeline_parallel_size=2), "pp2tp2": dict(pipeline_parallel_size=2, tensor_parallel_size=2),
          "sp2tp2": dict(sequence_parallel_size=2, tensor_parallel_size=2)}
# (ranks, (replicas, stride)): a stage's ranks hold different layers; the
# sp replicas of one tp place t are ranks t and t + tp
LAYOUT = {"pp2": (2, (1, 2)), "pp2tp2": (4, (1, 4)), "sp2tp2": (4, (2, 2))}


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    return write_adapters(tmp_path_factory.mktemp("lora_stages"), tllama.PRESETS[MODEL])


@pytest.fixture(scope="module")
def mesh_runs(eight_devices, adapters):
    return {tag: run_mesh(mesh, adapters) for tag, mesh in MESHES.items()}


@pytest.mark.parametrize("tag", list(MESHES))
def test_adapters_at_the_mesh_match_the_jax_engine_and_reach_every_rank(mesh_runs, adapters, tag):
    check_mesh(mesh_runs[tag], adapters, one_rank_lora(MODEL, adapters), *LAYOUT[tag])


@pytest.mark.parametrize("tag", ["pp2", "pp2tp2"])
def test_a_stage_holds_its_layers_of_the_lora_buffers(mesh_runs, adapters, tag):
    """A stage's buffers are its L/pp layers (at tp 2, its part of them):
    every rank holds the same bytes, a pp 2 stage half of one rank's."""
    one = one_rank_lora(MODEL, adapters)
    layers = sum(t.numel() * t.element_size() for layer in one["layers"] for t in layer.values())
    got = mesh_runs[tag]["lora_bytes"]
    assert len(set(got)) == 1
    if tag == "pp2":
        assert got[0] == layers / 2 + one["scale"].numel() * 4
    else:
        assert layers / 4 < got[0] - one["scale"].numel() * 4 < layers / 2
