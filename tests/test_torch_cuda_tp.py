"""The CUDA attention kernels at the per-rank head shapes of tensor-parallel
serving, on the card only: each tp rank runs the decode kernel through
``decode_attention_sharded`` and the prefill kernel (with the chunk's KV
write in its launch) on NH/tp query heads and KH/tp KV heads, shapes no
tp = 1 model gives (at Qwen2.5-1.5B's tp 4 one shared KV head under 3
query heads, a group of 3 in both kernels' tiles). Held to their plain versions as
tests/test_torch_cuda_attention.py holds the tp = 1 shapes (same
tolerances; two decode calls give the same bytes; pools and scales after
the write byte-identical), in bf16 pools and int8 pools. Then LoRA at
tp 2: llama-3.2-1b at full width cut to four layers, seeded, with a
seeded PEFT adapter on all seven targets, at tp 1 and at tp 2 (two ranks on
the one card over gloo, each holding its part of the slot buffers): a row
on the adapter beside a base row through a 256-token chunk and six decode
steps, the adapter row's logits within 0.25 of tp 1's with the same
greedy token on at least 90% of its steps (the bar the chip smoke holds
every rank layout to) and moved by the adapter by more than that bar;
every rank launched both kernels and no plain version.

This file imports neither jax nor the JAX package; without a card every
test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod
from test_torch_cuda_attention import GEMMA, TOL, _copies, _on, _pools, _same, cuda_device  # noqa: F401

# rank shapes: (tp, NH/tp, KH/tp, D, extra kwargs); Qwen2.5-1.5B at tp 4
# shares its 2 KV heads: 3 query heads on one KV head a rank (G = 3)
RANK_SHAPES = {
    "llama-3.2-1b_tp2": (2, 16, 4, 64, {}),
    "qwen2.5-1.5b_tp4kh2": (4, 3, 1, 128, {}),
    "llama-3.2-1b_tp4": (4, 8, 2, 64, {}),
    "qwen2.5-7b_tp2": (2, 14, 2, 128, {}),
    "gemma-2-2b_tp2": (2, 4, 2, 256, dict(GEMMA, window=4096)),
    "opt-125m_tp2": (2, 6, 6, 64, {}),
}


def _decode_inputs(name, quant, device):
    tp, NH, KH, D, extra = RANK_SHAPES[name]
    B, page, maxp, L, C = 8, 64, 17, 2, 8
    rng = np.random.RandomState(sum(map(ord, name)))
    P = B * maxp + 3
    kp, vp, skw = _pools(rng, (L, P, page, KH, D), quant, torch.bfloat16, device)
    pt = _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, device)
    q = _on(rng.randn(B, NH, D).astype(np.float32), torch.bfloat16, device)
    kc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, device)
    vc = _on(rng.randn(B, C, KH, D).astype(np.float32), torch.bfloat16, device)
    lens = torch.tensor([0, 9, 300, 1024, 700, 64, 1, 1080], dtype=torch.int32, device=device)
    cur = torch.tensor([0, 8, 3, 8, 5, 8, 1, 8], dtype=torch.int32, device=device)
    kw = dict(k_cur=kc, v_cur=vc, cur_lens=cur, layer=1, tp=tp, **skw, **extra)
    return (q, kp, vp, pt, lens), kw


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(RANK_SHAPES))
def test_sharded_decode_at_rank_shapes_matches_plain_version(cuda_device, name, quant):
    args, kw = _decode_inputs(name, quant, cuda_device)
    launches = dmod.decode_attention.launches + dmod.decode_attention.launches_int8
    out = dmod.decode_attention_sharded(*args, **kw)
    again = dmod.decode_attention_sharded(*args, **kw)
    ref = dmod.decode_attention_sharded(*args, plain=True, **kw)
    torch.cuda.synchronize()
    assert dmod.decode_attention.launches + dmod.decode_attention.launches_int8 == launches + 2
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
    assert _same(out, again)
    assert float(out[0].float().abs().max()) == 0.0  # the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(RANK_SHAPES))
def test_prefill_and_fused_write_at_rank_shapes_match_plain_versions(cuda_device, name, quant):
    tp, NH, KH, D, extra = RANK_SHAPES[name]
    B, T, page, maxp, L = 3, 96, 16, 16, 2
    computed, chunks = (100, 0, 37), (96, 61, 0)
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
    kw = dict(extra, layer=1)
    kw.pop("window", None)
    ka, sa = _copies(args, skw)
    kb, sb = _copies(args, skw)
    out = pmod.prefill_attention(*ka, fused_write=True, **sa, **kw)
    ref = pmod.prefill_attention_ref(*kb, fused_write=True, **sb, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
    assert _same(ka[1], kb[1]) and _same(ka[2], kb[2])
    for k in sa:
        assert _same(sa[k], sb[k]), k


LORA_LAYERS, LORA_PROMPT, LORA_DECODES = 4, 256, 6
BOUND, TOP1 = 0.25, 0.9


def _lora_steps(vocab, lora_ids):
    from production_stack_tpu_torch.engine.runner import StepInput

    B = len(lora_ids)
    n = LORA_PROMPT + LORA_DECODES
    ids = np.random.RandomState(4).randint(0, vocab, (B, n)).astype(np.int32)
    maxp = -(-n // 64)
    common = dict(page_table=np.arange(B * maxp, dtype=np.int32).reshape(B, maxp),
                  temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
                  lora_ids=np.asarray(lora_ids, np.int32))
    steps = [(0, LORA_PROMPT)] + [(LORA_PROMPT + s, 1) for s in range(LORA_DECODES)]
    return [StepInput(input_ids=ids[:, p: p + t], positions=np.tile(np.arange(p, p + t, dtype=np.int32), (B, 1)),
                      kv_lens=np.full(B, p + t, np.int32), **common) for p, t in steps]


def _lora_run(tp, adapter):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import RANK_STATS
    from production_stack_tpu_torch.models import llama

    name = f"llama-3.2-1b-l{LORA_LAYERS}"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=LORA_LAYERS)
    kw = dict(tensor_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0") if tp > 1 else {}
    engine = LLMEngine(EngineConfig(model=name, num_pages=64, max_model_len=1024, enable_lora=True,
                                    lora_target_modules="q_proj,k_proj,v_proj,o_proj,gate_proj,up_proj,down_proj",
                                    **kw))
    try:
        engine.load_lora_adapter("card-lora", adapter)
        r = engine.runner
        r.rank_stats(reset=True)
        vocab = engine.model_cfg.vocab_size
        logits = [r.step(inp)[1].float().cpu() for inp in _lora_steps(vocab, [0, 1])]
        stats = [dict(zip(RANK_STATS, row)) for row in r.rank_stats(reset=True)]
        r.reset_kv()
        base = [r.step(inp)[1].float().cpu() for inp in _lora_steps(vocab, [0, 0])]
        return logits, base, stats
    finally:
        engine.stop()
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_lora_at_tp2_matches_tp1_and_every_rank_launches_both_kernels(cuda_device, tmp_path):
    from production_stack_tpu_torch.engine.lora import save_peft_adapter
    from production_stack_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=LORA_LAYERS)
    gen = torch.Generator().manual_seed(5)
    tensors = {t: (torch.randn((LORA_LAYERS, 16, din), generator=gen) * din**-0.5,
                   torch.randn((LORA_LAYERS, dout, 16), generator=gen) * 16**-0.5)
               for t, (din, dout) in llama.lora_dims(cfg).items()}
    save_peft_adapter(str(tmp_path), cfg, 16, 16.0, tensors)
    ref, base, _ = _lora_run(1, str(tmp_path))
    got, _, stats = _lora_run(2, str(tmp_path))
    diffs = [float((a[1] - b[1]).abs().max()) for a, b in zip(got, ref)]
    top1 = float(np.mean([int(a[1].argmax() == b[1].argmax()) for a, b in zip(got, ref)]))
    moved = max(float((a[1] - b[1]).abs().max()) for a, b in zip(ref, base))
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert max(diffs) <= BOUND, diffs
    assert top1 >= TOP1, top1
    assert moved > BOUND, moved
    assert len(stats) == 2
    for t, row in enumerate(stats):
        assert row["decode_attention"] > 0 and row["prefill_attention"] > 0, (t, row)
        assert row["decode_attention_ref"] == row["prefill_attention_ref"] == 0, (t, row)
        assert 0 < row["lora_bytes"], (t, row)
