"""Sequence-parallel serving on the card only: the decode kernel at a
sequence rank's shapes (beside dp and pp ranks too: a dp 2 x sp 2 rank's
rows, a pp 2 x sp 2 stage rank's microbatch on its stage pool), and an sp
2 engine's forward against one rank's.

A sequence rank runs every decode step whole, through
``decode_attention_sharded`` on its sp mapping: all of llama-3.2-1b's
heads at sp 2, the tp place's 16 query and 4 KV heads at sp 2 x tp 2, over
the rank's replica of the pool. Held to the plain version as
tests/test_torch_cuda_attention.py holds the one-rank shapes (same
tolerance; two calls give the same bytes): eight ragged rows of a burst up
to one of 8,200 tokens.

llama-3.2-1b at full width cut to four layers, seeded (every sp rank draws
the same model), runs one row through a 600-token prompt in chunks of 256
(the last of 88) and six decode steps fed the seeded tokens at sp 1 and at
sp 2 (two ranks on the one card over gloo): the logits of every step within
0.25 of sp 1's and the same greedy token on at least 90% of the steps (the
bar the chip smoke holds every rank layout to: the ring's f32 blocks
against the prefill kernel's tiles, and bf16 rounding); every sequence rank
launched the decode kernel, neither the prefill kernel (a chunk goes
through the ring) nor a plain version, and moved the chunks' K/V over its
sequence group; the two ranks' pools are byte-identical after the steps.

This file imports neither jax nor the JAX package; without a card every
test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from test_torch_cuda_attention import TOL, _on, _pools, _same, cuda_device  # noqa: F401

LAYERS = 4
BOUND, TOP1 = 0.25, 0.9
PROMPT, CHUNK, DECODES = 600, 256, 6


@pytest.mark.cuda
@pytest.mark.parametrize("tp,NH,KH", [(1, 32, 8), (2, 16, 4)], ids=["sp2", "sp2tp2"])
def test_sharded_decode_at_a_sequence_ranks_shapes_matches_plain_version(cuda_device, tp, NH, KH):
    B, D, page, maxp, L, C = 8, 64, 64, 129, 2, 8
    rng = np.random.RandomState(40 + tp)
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), False, torch.bfloat16, cuda_device)
    pt = _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, cuda_device)
    q = _on(rng.randn(B, NH, D).astype(np.float32), torch.bfloat16, cuda_device)
    kc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, cuda_device)
    vc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, cuda_device)
    lens = torch.tensor([0, 9, 300, 8200, 700, 64, 1, 4100], dtype=torch.int32, device=cuda_device)
    cur = torch.tensor([0, 8, 3, 8, 5, 8, 1, 8], dtype=torch.int32, device=cuda_device)
    kw = dict(k_cur=kc, v_cur=vc, cur_lens=cur, layer=1, tp=tp, **skw)
    args = (q, kp, vp, pt, lens)
    launches = dmod.decode_attention.launches
    out = dmod.decode_attention_sharded(*args, **kw)
    again = dmod.decode_attention_sharded(*args, **kw)
    ref = dmod.decode_attention_sharded(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert dmod.decode_attention.launches == launches + 2
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
    assert _same(out, again)
    assert float(out[0].float().abs().max()) == 0.0  # the empty row


# sequence ranks beside dp and pp ranks: a dp 2 x sp 2 rank's 16 of a
# 32-row burst step over its sp replica of a 4-layer pool ([dp2sp2]), and a
# pp 2 x sp 2 stage rank's 8-row microbatch, the token's K/V beside the
# pool (C = 1), over its sp replica of the stage's 2-layer pool ([pp2sp2]);
# ragged rows (at dp 2 x sp 2 one empty; at pp 2 x sp 2 each row holds at
# least its current token): (B, L, layer, C, lens, cur_lens)
COMPOSED = {
    "dp2sp2": (16, 4, 3, 8, [0, 9, 300, 1024, 700, 64, 1, 1024] * 2, [0, 8, 3, 8, 5, 8, 1, 8] * 2),
    "pp2sp2": (8, 2, 1, 1, [1, 9, 300, 1024, 700, 64, 2, 1024], None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mapping", sorted(COMPOSED))
def test_sharded_decode_beside_dp_and_pp_ranks_matches_plain_version(cuda_device, mapping):
    """The one decode kernel on a composed rank's shard (all of
    llama-3.2-1b's heads) against its plain version, two calls the same
    bytes, the empty row 0."""
    B, L, layer, C, lens, cur = COMPOSED[mapping]
    NH, KH, D, page, maxp = 32, 8, 64, 64, 17
    rng = np.random.RandomState(sum(map(ord, mapping)))
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), False, torch.bfloat16, cuda_device)
    pt = _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, cuda_device)
    q = _on(rng.randn(B, NH, D).astype(np.float32), torch.bfloat16, cuda_device)
    kc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, cuda_device)
    vc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    kw = dict(k_cur=kc, v_cur=vc, layer=layer, **skw)
    if C > 1:
        kw["cur_lens"] = torch.tensor(cur, dtype=torch.int32, device=cuda_device)
    launches = dmod.decode_attention.launches
    out = dmod.decode_attention_sharded(q, kp, vp, pt, lens_t, **kw)
    again = dmod.decode_attention_sharded(q, kp, vp, pt, lens_t, **kw)
    ref = dmod.decode_attention_sharded(q, kp, vp, pt, lens_t, plain=True, **kw)
    torch.cuda.synchronize()
    assert dmod.decode_attention.launches == launches + 2
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
    assert _same(out, again)
    if C > 1:
        assert float(out[0].float().abs().max()) == 0.0  # the empty row (no burst entry either)


def _steps(vocab):
    from production_stack_tpu_torch.engine.runner import StepInput

    n = PROMPT + DECODES
    ids = np.random.RandomState(4).randint(0, vocab, (1, n)).astype(np.int32)
    common = dict(page_table=np.arange(-(-n // 64), dtype=np.int32)[None], temperature=np.zeros(1, np.float32),
                  top_k=np.zeros(1, np.int32), top_p=np.ones(1, np.float32))
    steps = [(p, min(CHUNK, PROMPT - p)) for p in range(0, PROMPT, CHUNK)] + [(PROMPT + s, 1) for s in range(DECODES)]
    return [StepInput(input_ids=ids[:, p: p + t], positions=np.arange(p, p + t, dtype=np.int32)[None],
                      kv_lens=np.array([p + t], np.int32), **common) for p, t in steps]


def _run(sp):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import RANK_STATS
    from production_stack_tpu_torch.models import llama

    name = f"llama-3.2-1b-l{LAYERS}"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=LAYERS)
    kw = dict(sequence_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0") if sp > 1 else {}
    engine = LLMEngine(EngineConfig(model=name, num_pages=64, max_model_len=1024, **kw))
    try:
        r = engine.runner
        if sp > 1:
            r.rank_stats(reset=True)
        logits = [r.step(inp)[1].float().cpu() for inp in _steps(engine.model_cfg.vocab_size)]
        stats = [dict(zip(RANK_STATS, row)) for row in r.rank_stats(reset=True)] if sp > 1 else None
        digests = [bytes(d) for d in r.replica_digest()] if sp > 1 else None
        return logits, stats, digests
    finally:
        engine.stop()
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_sp2_forward_matches_one_rank_and_every_rank_launches_the_decode_kernel(cuda_device):
    ref, _, _ = _run(1)
    got, stats, digests = _run(2)
    diffs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    top1 = float(torch.cat([a.argmax(-1) == b.argmax(-1) for a, b in zip(got, ref)]).double().mean())
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert max(diffs) <= BOUND, diffs
    assert top1 >= TOP1, top1
    assert len(stats) == 2
    for s, row in enumerate(stats):
        assert row["decode_attention"] == LAYERS * DECODES, (s, row)
        assert row["prefill_attention"] == row["kv_page_write"] == 0, (s, row)
        assert row["decode_attention_ref"] == row["prefill_attention_ref"] == row["kv_page_write_ref"] == 0, (s, row)
        assert row["ring_calls"] > 0 and row["ring_bytes"] > 0, (s, row)
    assert digests[0] == digests[1]
