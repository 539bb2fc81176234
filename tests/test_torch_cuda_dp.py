"""The CUDA attention kernels at the per-rank shapes of in-engine data
parallelism, and a dp engine's replicas, on the card only.

A dp rank runs the decode kernel through ``decode_attention_sharded`` and
the prefill kernel (with the chunk's KV write in its launch) on its dp
group's B/dp rows, with all of its tp group's heads: llama-3.2-1b's at dp 2
and its tp 2 rank's at dp 2 x tp 2. Each rank's launch is held to its plain
version as tests/test_torch_cuda_tp.py holds the tp shapes (same
tolerances; two decode calls give the same bytes; pools and scales after
the write byte-identical), and the ranks' rows joined to the whole batch's
plain output. Then a dp 2 engine (two ranks on the one card over gloo,
llama-3.2-1b cut to two layers) serves three concurrent requests: every
rank launched both kernels and no plain version, and the two replicas'
pools and scales have one digest.

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
from production_stack_tpu_torch.parallel import dp as dpmod
from test_torch_cuda_attention import TOL, _copies, _on, _pools, _same, cuda_device  # noqa: F401

# the served rank shapes: (dp, NH of the rank, KH of the rank, D)
DP_SHAPES = {
    "llama-3.2-1b_dp2": (2, 32, 8, 64),
    "llama-3.2-1b_dp2tp2": (2, 16, 4, 64),
}


def _rank(d, dp):
    return dataclasses.make_dataclass("G", ["rank", "size"])(d, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(DP_SHAPES))
def test_each_dp_rank_decode_matches_plain_version(cuda_device, name, quant):
    dp, NH, KH, D = DP_SHAPES[name]
    B, page, maxp, L, C = 8, 64, 17, 2, 8
    rng = np.random.RandomState(sum(map(ord, name)))
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), quant, torch.bfloat16, cuda_device)
    pt = _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, cuda_device)
    q = _on(rng.randn(B, NH, D).astype(np.float32), torch.bfloat16, cuda_device)
    kc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, cuda_device)
    vc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, cuda_device)
    lens = torch.tensor([0, 9, 300, 1024, 700, 64, 1, 1080], dtype=torch.int32, device=cuda_device)
    cur = torch.tensor([0, 8, 3, 8, 5, 8, 1, 8], dtype=torch.int32, device=cuda_device)
    whole = dmod.decode_attention_ref(q, kp, vp, pt, lens, k_cur=kc, v_cur=vc, cur_lens=cur, layer=1, **skw)
    outs = []
    for d in range(dp):
        def rows(x, d=d):
            return dpmod.row_slice(x, _rank(d, dp))

        args = (rows(q), kp, vp, rows(pt), rows(lens))
        kw = dict(k_cur=rows(kc), v_cur=rows(vc), cur_lens=rows(cur), layer=1, **skw)
        launches = dmod.decode_attention.launches + dmod.decode_attention.launches_int8
        out = dmod.decode_attention_sharded(*args, **kw)
        again = dmod.decode_attention_sharded(*args, **kw)
        ref = dmod.decode_attention_sharded(*args, plain=True, **kw)
        torch.cuda.synchronize()
        assert dmod.decode_attention.launches + dmod.decode_attention.launches_int8 == launches + 2
        assert bool(torch.isfinite(out.float()).all())
        torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
        assert _same(out, again)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs).float(), whole.float(), **TOL["bfloat16"])
    assert float(outs[0][0].float().abs().max()) == 0.0  # the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(DP_SHAPES))
def test_each_dp_rank_prefill_and_fused_write_match_plain_versions(cuda_device, name, quant):
    """Each dp rank's chunk of a four-row step (two rows a rank; one row
    padded, one ragged) on its own pool replica: the output and the written
    pools against the plain versions."""
    dp, NH, KH, D = DP_SHAPES[name]
    B, T, page, maxp, L = 4, 96, 16, 16, 2
    computed, chunks = (100, 0, 37, 5), (96, 61, 0, 96)
    rng = np.random.RandomState(sum(map(ord, name)) + 1)
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
    for d in range(dp):
        mine = [a if i in (1, 2) else dpmod.row_slice(a, _rank(d, dp)) for i, a in enumerate(args)]
        ka, sa = _copies(mine, skw)
        kb, sb = _copies(mine, skw)
        launches = pmod.prefill_attention.launches + pmod.prefill_attention.launches_int8
        out = pmod.prefill_attention(*ka, fused_write=True, layer=1, **sa)
        ref = pmod.prefill_attention_ref(*kb, fused_write=True, layer=1, **sb)
        torch.cuda.synchronize()
        assert pmod.prefill_attention.launches + pmod.prefill_attention.launches_int8 == launches + 1
        assert bool(torch.isfinite(out.float()).all())
        torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
        assert _same(ka[1], kb[1]) and _same(ka[2], kb[2])
        for k in sa:
            assert _same(sa[k], sb[k]), k


@pytest.mark.cuda
def test_a_dp2_engine_keeps_its_replicas_equal(cuda_device):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import RANK_STATS
    from production_stack_tpu_torch.engine.scheduler import SamplingParams
    from production_stack_tpu_torch.models import llama

    name = "llama-3.2-1b-2l"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=2)
    engine = LLMEngine(EngineConfig(model=name, data_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0",
                                    num_pages=64, max_model_len=1024))
    engine.start()
    try:
        engine.runner.rank_stats(reset=True)

        async def one(i, n):
            ids = [int(x) for x in np.random.RandomState(i).randint(1, 1000, n)]
            out = []
            async for o in engine.generate(f"dp-{i}-{time.monotonic_ns()}", prompt_token_ids=ids,
                                           params=SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)):
                out += o.token_ids
            return out

        async def run():
            return await asyncio.gather(*(one(i, n) for i, n in enumerate((40, 300, 700))))

        outs = asyncio.run(run())
        stats = engine.runner.rank_stats()
        digests = engine.runner.replica_digest()
    finally:
        engine.stop()
    assert [len(o) for o in outs] == [12, 12, 12]
    assert stats.shape == (2, len(RANK_STATS))
    for r in range(2):
        row = dict(zip(RANK_STATS, stats[r]))
        assert row["decode_attention"] > 0 and row["prefill_attention"] > 0, (r, row)
        assert row["decode_attention_ref"] == row["prefill_attention_ref"] == 0, (r, row)
        assert row["sync_bytes"] > 0 and row["sync_pages"] > 0, (r, row)  # each replica took the other's pages
    assert bytes(digests[0]) == bytes(digests[1])
