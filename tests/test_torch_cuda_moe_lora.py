"""Mixtral's MoE forward and batched multi-LoRA through the port's CUDA
kernels on the card (jax-free, like tests/test_torch_cuda_attention.py;
without a card every test skips).

- mixtral-8x7b at full width (H 4,096, 8 experts of I 14,336, NH 32, KH 8,
  D 128: G = 4), cut to two layers, seeded random weights: a 512-token
  prefill chunk on two rows and an 8-step decode burst, with the kernels
  and with their plain versions, into bf16 and then int8 pools: logits
  within chip_smoke.py's forward bound (0.25, top-1 at least 0.9) at every
  step, the plain run taking the experts the kernel run took (a near-tie in
  a router would otherwise send a token elsewhere in one run; models/llama.py
  ``tape_routes``), and every kernel of the pool mode launched.
- llama-3.2-1b at full width, cut to four layers, in f32 (TF32 off), with a
  rank-8 adapter on all seven targets in slot 1 (scale 1/4): a batch of
  rows on slots 0 and 1 through the kernels; row 1 within 1e-3 of the
  kernel forward over the weights merged with scale * A @ B (chip_smoke.py's
  LORA_F32_ATOL), row 0 bit-equal to the forward without LoRA buffers.
"""

import dataclasses

import pytest
import torch

from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod
from production_stack_tpu_torch.ops.quant import init_kv_scales, write_kv_pages_all_layers_quant

pytestmark = pytest.mark.cuda

BOUND, TOP1 = 0.25, 0.9  # chip_smoke.py's FORWARD_LOGIT_BOUND and FORWARD_TOP1_MIN
F32_ATOL, SCALE = 1e-3, 0.25  # its LORA_F32_ATOL and LORA_SCALE
CHUNK, BURST, PAGE = 512, 8, 64


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MoE and LoRA forwards through the kernels went unchecked here "
                    "(run bash scripts/card_tests.sh on the card; chip_smoke.py checks them too)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _model(name, layers, seed=0, **over):
    cfg = dataclasses.replace(llama.PRESETS[name], num_layers=layers, **over)
    model = llama.LlamaForCausalLM(cfg, device="cuda")
    llama.init_params(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def _run(model, impl, ids, quant=False, lora=None):
    """A prefill chunk of every row, then a teacher-forced decode burst, with
    attn_impl ``impl``: the logits of the chunk and of each burst step."""
    cfg = model.cfg = dataclasses.replace(model.cfg, attn_impl=impl, kv_cache_dtype="int8" if quant else "auto")
    B = ids.shape[0]
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    maxp = -(-(CHUNK + BURST) // PAGE)
    kp, vp = llama.init_kv_pages(cfg, B * maxp, PAGE, "cuda")
    scales = (init_kv_scales(L, B * maxp, KH, "cuda"), init_kv_scales(L, B * maxp, KH, "cuda")) if quant else None
    pt = torch.arange(B * maxp, dtype=torch.int32, device="cuda").reshape(B, maxp)
    lkw = {} if lora is None else dict(lora=lora[0], lora_ids=lora[1])
    pos = torch.arange(CHUNK, dtype=torch.int32, device="cuda").repeat(B, 1)
    lens = torch.full((B,), CHUNK, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        out = [model(ids[:, :CHUNK], pos, kp, vp, pt, lens, kv_scales=scales, **lkw)]
        k_acc = torch.zeros((L, B, BURST, KH, D), dtype=cfg.dtype, device="cuda")
        v_acc = torch.zeros_like(k_acc)
        counts = torch.zeros((B,), dtype=torch.int32, device="cuda")
        for s in range(BURST):
            out.append(model(ids[:, CHUNK + s][:, None], torch.full((B, 1), CHUNK + s, dtype=torch.int32,
                                                                     device="cuda"),
                             kp, vp, pt, lens + s + 1, kv_burst=(k_acc, v_acc, counts), kv_scales=scales, **lkw))
            counts = counts + 1
        commit = CHUNK + torch.arange(BURST, dtype=torch.int32, device="cuda").repeat(B, 1)
        if quant:
            write_kv_pages_all_layers_quant(kp, vp, *scales, k_acc, v_acc, pt, commit)
        else:
            write_kv_pages_all_layers(kp, vp, k_acc, v_acc, pt, commit)
    torch.cuda.synchronize()
    return out


def _launches():
    return {
        False: (dmod.decode_attention.launches, pmod.prefill_attention.launches, pmod.prefill_attention.launches_write),
        True: (dmod.decode_attention.launches_int8, pmod.prefill_attention.launches_int8,
               pmod.prefill_attention.launches_write_int8),
    }


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pools", "int8_pools"])
def test_mixtral_two_layers_full_width_kernels_match_plain(quant):
    _card()
    model = _model("mixtral-8x7b", 2)
    ids = torch.randint(0, 32000, (2, CHUNK + BURST), generator=torch.Generator().manual_seed(3),
                        dtype=torch.int32).cuda()
    before = _launches()[quant]
    with llama.tape_routes(model) as routes:
        kern = _run(model, "cuda", ids, quant)
    after = _launches()[quant]
    with llama.tape_routes(model, replay=routes.picks):
        plain = _run(model, "plain", ids, quant)
    assert all(bool(torch.isfinite(x).all()) and x.shape == (2, 32000) for x in kern)
    assert max(float((a - p).abs().max()) for a, p in zip(kern, plain)) <= BOUND
    assert float(torch.cat([a.argmax(-1) == p.argmax(-1) for a, p in zip(kern, plain)]).float().mean()) >= TOP1
    assert all(b > a for a, b in zip(before, after)), (before, after)  # decode, prefill, its write


def test_lora_rows_match_merged_weights_through_the_kernels():
    _card()
    model = _model("llama-3.2-1b", 4, dtype=torch.float32)
    cfg = model.cfg
    targets, rank = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"), 8
    bufs = llama.init_lora_buffers(cfg, 2, 16, targets, device="cuda")
    g = torch.Generator().manual_seed(5)
    deltas = {}
    for t in targets:
        din, dout = llama.lora_dims(cfg)[t]
        a = torch.randn((cfg.num_layers, din, rank), generator=g) * din**-0.5
        b = torch.randn((cfg.num_layers, rank, dout), generator=g) * rank**-0.5
        for li, layer in enumerate(bufs["layers"]):
            layer["a_" + t][1, :, :rank] = a[li].cuda()
            layer["b_" + t][1, :rank] = b[li].cuda()
        deltas[t] = SCALE * torch.bmm(a, b)
    bufs["scale"][1] = SCALE
    ids = torch.randint(0, cfg.vocab_size, (2, CHUNK + BURST), generator=torch.Generator().manual_seed(6),
                        dtype=torch.int32).cuda()
    slots = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    got = _run(model, "cuda", ids, lora=(bufs, slots))
    base = _run(model, "cuda", ids)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(got, base))  # slot 0 adds exact zeros
    with torch.no_grad():
        for li, layer in enumerate(model.layers):
            for t, d in deltas.items():
                getattr(layer, t).add_(d[li].cuda())
    merged = _run(model, "cuda", ids)
    assert max(float((a[1] - m[1]).abs().max()) for a, m in zip(got, merged)) <= F32_ATOL
    assert max(float((a[1] - b[1]).abs().max()) for a, b in zip(got, base)) > BOUND  # the adapter moves the output
