"""The CUDA attention kernels at the per-rank shapes of expert-parallel
Mixtral, and an ep engine's replicas, on the card only.

An (ep, tp) rank of mixtral-8x7b runs the attention of its tp place,
replicated along ep: at ep 2 x tp 2 each rank holds NH/tp = 16 query heads
and KH/tp = 4 KV heads (G = 4 at D = 128); a pp 2 x ep 2 stage rank all 32
and 8 on its stage's pool, one microbatch's rows; an sp 2 x ep 2 sequence
rank all of them on its replica of the pool, a long row's whole decode
step. Qwen2.5-1.5B's tp 4 rank (3 query heads on one shared KV head) joins
them. The decode kernel runs through
``decode_attention_sharded`` (its ep axis: the same call on both ep ranks,
the same bytes), the prefill kernel with the chunk's KV write in its
launch; each is held to its plain version as tests/test_torch_cuda_tp.py
holds the tp shapes (same tolerances; two decode calls give the same
bytes; pools and scales after the write byte-identical). Then an ep 2
engine (two ranks on the one card over gloo, a seeded mixtral-8x7b at full
width cut to two layers, 4 experts a rank) serves three concurrent
requests: every rank launched both kernels and no plain version, the MoE
sums crossed the expert group, and the two ep replicas' pools have one
digest; then a pp 2 x ep 2 engine (four ranks, one layer and 4 experts a
rank) the same way: every stage rank launched both kernels and no plain
version, the stages relayed, the MoE sums crossed each stage's expert
group, and each stage's ep replicas have one digest.

This file imports neither jax nor the JAX package; without a card every
test skips.
"""

import asyncio
import dataclasses
import time

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod
from test_torch_cuda_attention import TOL, _copies, _on, _pools, _same, cuda_device  # noqa: F401

# mixtral-8x7b's rank shapes: (ep, tp, NH of the rank, KH of the rank, D,
# layers of the rank's pool, rows of its decode): an ep 2 x tp 2 rank; a
# pp 2 x ep 2 stage rank (its 2 of 4 layers, one 8-row microbatch); an sp
# 2 x ep 2 sequence rank (the whole step, one long row); and Qwen2.5-1.5B's
# tp 4 rank with its shared KV head (G = 3)
EP_SHAPES = {"ep2tp2": (2, 2, 16, 4, 128, 2, 8), "pp2ep2": (2, 1, 32, 8, 128, 2, 8),
             "sp2ep2": (2, 1, 32, 8, 128, 4, 1), "tp4kh2": (1, 4, 3, 1, 128, 2, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", sorted(EP_SHAPES))
def test_an_ep_rank_decode_matches_plain_version_on_every_ep_replica(cuda_device, quant, shape):
    ep, tp, NH, KH, D, L, rows = EP_SHAPES[shape]
    B, page, maxp, C = 8, 64, 17, 8
    rng = np.random.RandomState(17 + int(quant) + sum(map(ord, shape)))
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), quant, torch.bfloat16, cuda_device)
    pt = _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, cuda_device)
    q = _on(rng.randn(B, NH, D).astype(np.float32), torch.bfloat16, cuda_device)
    kc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, cuda_device)
    vc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, cuda_device)
    lens = torch.tensor([0, 9, 300, 1024, 700, 64, 1, 1080], dtype=torch.int32, device=cuda_device)
    cur = torch.tensor([0, 8, 3, 8, 5, 8, 1, 8], dtype=torch.int32, device=cuda_device)
    if rows == 1:  # a sequence rank's long row: its whole page table, the burst's last step
        q, kc, vc, pt = q[3:4], kc[3:4], vc[3:4], pt.reshape(1, -1)[:, : B * maxp].contiguous()
        lens, cur = torch.tensor([B * maxp * page - 9], dtype=torch.int32, device=cuda_device), cur[3:4]
    kw = dict(k_cur=kc, v_cur=vc, cur_lens=cur, layer=L - 1, tp=tp, **skw)
    launches = dmod.decode_attention.launches + dmod.decode_attention.launches_int8
    outs = [dmod.decode_attention_sharded(q, kp, vp, pt, lens, **kw) for _ in range(ep)]  # rank (e, t), each e
    ref = dmod.decode_attention_sharded(q, kp, vp, pt, lens, plain=True, **kw)
    torch.cuda.synchronize()
    assert dmod.decode_attention.launches + dmod.decode_attention.launches_int8 == launches + ep
    assert bool(torch.isfinite(outs[0].float()).all())
    torch.testing.assert_close(outs[0].float(), ref.float(), **TOL["bfloat16"])
    assert all(_same(o, outs[0]) for o in outs[1:])
    if rows > 1:
        assert float(outs[0][0].float().abs().max()) == 0.0  # the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", ["ep2tp2", "pp2ep2", "tp4kh2"])
def test_an_ep_rank_prefill_and_fused_write_match_plain_versions(cuda_device, quant, shape):
    """A four-row chunk (one row padded, one ragged) at the rank's heads
    (a pp 2 x ep 2 stage's on its 2-layer pool; at sp 2 x ep 2 a chunk goes
    through the ring, not this kernel): the output and the written pools
    against the plain versions."""
    _, _, NH, KH, D, L, _ = EP_SHAPES[shape]
    B, T, page, maxp = 4, 96, 16, 16
    computed, chunks = (100, 0, 37, 5), (96, 61, 0, 96)
    rng = np.random.RandomState(19 + int(quant) + sum(map(ord, shape)))
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), quant, torch.bfloat16, cuda_device)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos[b, : chunks[b]] = np.arange(computed[b], computed[b] + chunks[b])
    args = [
        _on(rng.randn(B, T, NH, D).astype(np.float32), torch.bfloat16, cuda_device), kp, vp,
        _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, cuda_device),
        _on(pos, torch.bfloat16, cuda_device),
        _on(np.array([c + n for c, n in zip(computed, chunks)], np.int32), torch.bfloat16, cuda_device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), torch.bfloat16, cuda_device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), torch.bfloat16, cuda_device),
        _on(np.array(chunks, np.int32), torch.bfloat16, cuda_device),
    ]
    ka, sa = _copies(args, skw)
    kb, sb = _copies(args, skw)
    launches = pmod.prefill_attention.launches + pmod.prefill_attention.launches_int8
    out = pmod.prefill_attention(*ka, fused_write=True, layer=L - 1, **sa)
    ref = pmod.prefill_attention_ref(*kb, fused_write=True, layer=L - 1, **sb)
    torch.cuda.synchronize()
    assert pmod.prefill_attention.launches + pmod.prefill_attention.launches_int8 == launches + 1
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
    assert _same(ka[1], kb[1]) and _same(ka[2], kb[2])
    for k in sa:
        assert _same(sa[k], sb[k]), k


@pytest.mark.cuda
def test_an_ep2_engine_keeps_its_replicas_equal(cuda_device):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import RANK_STATS
    from production_stack_tpu_torch.engine.scheduler import SamplingParams
    from production_stack_tpu_torch.models import llama

    name = "mixtral-8x7b-2l"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS["mixtral-8x7b"], num_layers=2)
    engine = LLMEngine(EngineConfig(model=name, expert_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0",
                                    num_pages=64, max_model_len=1024))
    engine.start()
    try:
        engine.runner.rank_stats(reset=True)

        async def one(i, n):
            ids = [int(x) for x in np.random.RandomState(i).randint(1, 1000, n)]
            out = []
            async for o in engine.generate(f"ep-{i}-{time.monotonic_ns()}", prompt_token_ids=ids,
                                           params=SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)):
                out += o.token_ids
            return out

        async def run():
            return await asyncio.gather(*(one(i, n) for i, n in enumerate((40, 300, 700))))

        outs = asyncio.run(run())
        stats = engine.runner.rank_stats()
        digests = engine.runner.replica_digest()
        experts = engine.runner.model.layers[0].moe_gate.shape
    finally:
        engine.stop()
    assert [len(o) for o in outs] == [12, 12, 12]
    assert experts == (4, 4096, 14336)  # the leader's 4 of 8 experts, whole
    assert stats.shape == (2, len(RANK_STATS))
    for r in range(2):
        row = dict(zip(RANK_STATS, stats[r]))
        assert row["decode_attention"] > 0 and row["prefill_attention"] > 0, (r, row)
        assert row["decode_attention_ref"] == row["prefill_attention_ref"] == 0, (r, row)
        assert row["expert_calls"] > 0 and row["expert_bytes"] > 0, (r, row)
        assert row["sync_pages"] == 0, (r, row)  # ep replicas write their own pages: nothing copied
    assert bytes(digests[0]) == bytes(digests[1])


@pytest.mark.cuda
def test_a_pp2_ep2_engine_runs_both_kernels_on_every_stage_rank(cuda_device):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import RANK_STATS
    from production_stack_tpu_torch.engine.scheduler import SamplingParams
    from production_stack_tpu_torch.models import llama

    name = "mixtral-8x7b-2l"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS["mixtral-8x7b"], num_layers=2)
    engine = LLMEngine(EngineConfig(model=name, pipeline_parallel_size=2, expert_parallel_size=2, tp_backend="gloo",
                                    tp_device_ids="0,0,0,0", num_pages=64, max_model_len=1024))
    engine.start()
    try:
        engine.runner.rank_stats(reset=True)

        async def one(i, n):
            ids = [int(x) for x in np.random.RandomState(i).randint(1, 1000, n)]
            out = []
            async for o in engine.generate(f"ppep-{i}-{time.monotonic_ns()}", prompt_token_ids=ids,
                                           params=SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)):
                out += o.token_ids
            return out

        async def run():
            return await asyncio.gather(*(one(i, n) for i, n in enumerate((40, 300, 700))))

        outs = asyncio.run(run())
        stats = engine.runner.rank_stats()
        digests = engine.runner.replica_digest()
        experts = engine.runner.model.layers[0].moe_gate.shape
        layers = len(engine.runner.model.layers)
    finally:
        engine.stop()
    assert [len(o) for o in outs] == [12, 12, 12]
    assert experts == (4, 4096, 14336) and layers == 1  # the leader's layer, 4 of its 8 experts
    assert stats.shape == (4, len(RANK_STATS))
    for r in range(4):
        row = dict(zip(RANK_STATS, stats[r]))
        assert row["decode_attention"] > 0 and row["prefill_attention"] > 0, (r, row)
        assert row["decode_attention_ref"] == row["prefill_attention_ref"] == 0, (r, row)
        assert row["expert_calls"] > 0 and row["relay_calls"] > 0, (r, row)
    # rank (p, e) = 2p + e: the ep replicas of each stage hold one pool, the stages different layers
    assert bytes(digests[0]) == bytes(digests[1]) and bytes(digests[2]) == bytes(digests[3])
    assert bytes(digests[0]) != bytes(digests[2])
