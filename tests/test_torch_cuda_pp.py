"""Pipeline-parallel serving on the card only: a pp 2 engine's forward
against pp 1's, and both CUDA kernels launched by every stage.

llama-3.2-1b at full width cut to four layers (two a stage), seeded (every
pp draws the same model), runs two rows through a 256-token prefill chunk
and six decode steps fed the seeded tokens at pp 1 and at pp 2 (two ranks
on the one card over gloo, four microbatches at eight rows, one at two):
the logits of every step within 0.25 of pp 1's and the same greedy token
on at least 90% of the rows (the bar the chip smoke holds every rank
layout to: the stages' bf16 rounding and the decode kernel's split plan,
which counts a microbatch's rows, move logits by less); every stage
launched the decode and the prefill kernel and no plain version, and the
stages relayed their microbatches. Then eight rows of one decode step:
the pp 2 stages each launch L/pp x 4 decode kernels (four microbatches of
two), pp 1 L.

This file imports neither jax nor the JAX package; without a card every
test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_cuda_attention import cuda_device  # noqa: F401

LAYERS = 4
BOUND, TOP1 = 0.25, 0.9
PROMPT, DECODES = 256, 6


def _steps(vocab, B):
    from production_stack_tpu_torch.engine.runner import StepInput

    rng = np.random.RandomState(4)
    n = PROMPT + DECODES
    ids = rng.randint(0, vocab, (B, n)).astype(np.int32)
    maxp = -(-n // 64)
    common = dict(page_table=np.arange(B * maxp, dtype=np.int32).reshape(B, maxp),
                  temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32))
    steps = [(0, PROMPT)] + [(PROMPT + s, 1) for s in range(DECODES)]
    return [StepInput(input_ids=ids[:, p: p + t], positions=np.tile(np.arange(p, p + t, dtype=np.int32), (B, 1)),
                      kv_lens=np.full(B, p + t, np.int32), **common) for p, t in steps]


def _run(pp, rows):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import RANK_STATS
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention

    name = f"llama-3.2-1b-l{LAYERS}"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=LAYERS)
    kw = dict(pipeline_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0") if pp > 1 else {}
    engine = LLMEngine(EngineConfig(model=name, num_pages=64, max_model_len=1024, **kw))
    try:
        r = engine.runner
        if pp > 1:
            r.rank_stats(reset=True)
        logits = [r.step(inp)[1].float().cpu() for inp in _steps(engine.model_cfg.vocab_size, 2)]
        stats = [dict(zip(RANK_STATS, row)) for row in r.rank_stats(reset=True)] if pp > 1 else None
        r.reset_kv()
        decode_attention.launches = 0
        r.step(_steps(engine.model_cfg.vocab_size, rows)[1])  # one decode step of ``rows`` rows
        if pp > 1:
            wide = [dict(zip(RANK_STATS, row))["decode_attention"] for row in r.rank_stats()]
        else:
            wide = [decode_attention.launches]
        return logits, stats, wide
    finally:
        engine.stop()
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_pp2_forward_matches_pp1_and_every_stage_launches_both_kernels(cuda_device):
    ref, _, wide1 = _run(1, 8)
    got, stats, wide2 = _run(2, 8)
    diffs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    top1 = float(torch.cat([a.argmax(-1) == b.argmax(-1) for a, b in zip(got, ref)]).double().mean())
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert max(diffs) <= BOUND, diffs
    assert top1 >= TOP1, top1
    assert len(stats) == 2
    for p, row in enumerate(stats):
        assert row["decode_attention"] > 0 and row["prefill_attention"] > 0, (p, row)
        assert row["decode_attention_ref"] == row["prefill_attention_ref"] == 0, (p, row)
        assert row["relay_calls"] > 0 and row["relay_bytes"] > 0, (p, row)
    # a decode step of 8 rows: four microbatches of two on each stage's two layers
    assert wide1 == [LAYERS]
    assert wide2 == [LAYERS // 2 * 4] * 2
