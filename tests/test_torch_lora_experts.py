"""Batched multi-LoRA on Mixtral across the port's expert-parallel ranks
against the JAX engine on its 8-device CPU mesh: ep 2 and ep 2 x tp 2
(tests/test_torch_lora_ranks.py holds the checks every mesh passes).

A MoE layer's experts are no LoRA target, in both packages: the adapters
take the attention's four projections, which every ep rank computes for
its tp place, so the buffers split over tp alone and the ep ranks hold
replicas. On an f32 copy of mixtral-debug (the presets replaced for the
test in both packages) with the JAX engine's weights and the rank-8 and
rank-16 adapters: a four-row prefill chunk's logits within 2e-5 of the JAX
runner's, and again with planted experts replayed on every rank
(``runner.replay_routes``) within 2e-5 of one rank's replay; greedy tokens
of base and adapter requests equal to the JAX engine's at the same mesh;
the buffers joined back bit-equal to one rank's; every rank's slots
written by a load over HTTP and zeroed by the unload, the ep replicas
equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.model_loader import load_model
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.models import llama as tllama
from test_torch_ep import _planted
from test_torch_lora_ranks import (
    ATTN,
    CHUNK_SLOTS,
    F32,
    MAX_RANK,
    SMALL,
    check_mesh,
    chunk_inputs,
    one_rank_lora,
    run_mesh,
    write_adapters,
)

MODEL = "mixtral-debug"  # 4 experts, NH 4, KH 2
# the engines' default targets: the attention's four projections
LORA = dict(enable_lora=True, max_loras=2, max_lora_rank=MAX_RANK)
MESHES = {"ep2": dict(expert_parallel_size=2), "ep2tp2": dict(expert_parallel_size=2, tensor_parallel_size=2)}
# (ranks, (replicas, stride)): the ep replicas of one tp place t are ranks t
# and t + tp
LAYOUT = {"ep2": (2, (2, 1)), "ep2tp2": (4, (2, 2))}


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    """Both meshes in both packages on the f32 copy, and one rank's
    buffers and replayed chunk."""
    jcfg = dataclasses.replace(jllama.PRESETS[MODEL], dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS[MODEL], dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jllama.PRESETS, MODEL, jcfg)
        mp.setitem(tllama.PRESETS, MODEL, tcfg)
        adapters = write_adapters(tmp_path_factory.mktemp("lora_experts"), tcfg, ATTN)
        tinp = chunk_inputs(tcfg.vocab_size)[1]
        planted = _planted(tcfg, tinp)
        out = {tag: run_mesh(mesh, adapters, MODEL, LORA, planted) for tag, mesh in MESHES.items()}
        out["adapters"] = adapters
        out["one_rank"] = one_rank_lora(MODEL, adapters, ATTN)
        _, _, net = load_model(MODEL, device="cpu", params=out["ep2"]["params"])
        runner = ModelRunner(net, num_pages=SMALL["num_pages"], page_size=SMALL["page_size"], device="cpu",
                             enable_lora=True, max_loras=2, max_lora_rank=MAX_RANK, lora_targets=ATTN)
        mgr = tlora.LoRAManager(runner, max_loras=2, max_rank=MAX_RANK)
        for name, path in adapters:
            mgr.load(name, path)
        for key, inp in (("replayed", tinp), ("replayed_base", dataclasses.replace(tinp, lora_ids=None))):
            runner.replay_routes(planted)
            out[key] = runner.step(inp)[1].numpy()
            runner.reset_kv()
    return out


@pytest.mark.parametrize("tag", list(MESHES))
def test_adapters_at_the_mesh_match_the_jax_engine_and_reach_every_rank(runs, tag):
    check_mesh(runs[tag], runs["adapters"], runs["one_rank"], *LAYOUT[tag])


@pytest.mark.parametrize("tag", list(MESHES))
def test_replayed_experts_with_adapters_give_one_ranks_logits(runs, tag):
    """The same chunk with planted experts on every rank: one rank's
    logits; there the adapter rows move off the base chunk's and the base
    row does not."""
    np.testing.assert_allclose(runs[tag]["replayed"], runs["replayed"], **F32)
    for row, slot in enumerate(CHUNK_SLOTS):
        diff = float(np.abs(runs["replayed"][row] - runs["replayed_base"][row]).max())
        assert (diff > 1e-3) if slot else (diff == 0.0), (row, diff)
    assert sorted(runs["one_rank"]["layers"][0]) == sorted(f"{ab}_{t}" for t in ATTN for ab in "ab")
