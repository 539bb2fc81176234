"""Speculative and chained decode of the port on the card (jax-free, like
tests/test_torch_cuda_attention.py; without a card every test skips).

- The prefill kernel at the verify shape of step_spec (T = 1 + k = 5 after
  a long history, rows inactive at -1) against its plain version, with the
  fused write leaving the pools byte-identical to the plain write's:
  llama-3.2-1b's heads (32 rows after 1,024 tokens) and gemma-2-2b's (D =
  256, softcap 50, 8 rows after 4,096, a sliding and a global layer); and
  on a pipeline stage's 2-layer pool (an 8-row microbatch, either local
  layer; the other left untouched).
- An f32 copy of llama-3.2-1b cut to two layers: step_spec's tokens are
  sequential greedy's (a differing token only where greedy's two best
  logits all but tie), and step_multi_pipelined's tokens and pools are 4
  step_multi calls' bit for bit (the same kernels at the same shapes).
- A pipelined chain's fetch groups arrive through their events, in pinned
  host memory, with no torch.cuda.synchronize.
"""

import dataclasses

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.engine.runner import HostTokens, ModelRunner, StepInput
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod
from test_torch_cuda_attention import GEMMA, TOL, _on, _pools, _same

# name: (B, T, NH, KH, D, page, maxp, computed, chunks, extra kwargs)
VERIFY_CASES = {
    "llama_b32_t5_h1024_d64": (32, 5, 32, 8, 64, 64, 17, (1024,) * 32, (5,) * 32, {}),
    "gemma_b8_t5_h4096_sliding_d256": (8, 5, 8, 4, 256, 64, 65, (4096,) * 8, (5,) * 8, dict(GEMMA, window=4096)),
    "gemma_b8_t5_h4096_global_d256": (8, 5, 8, 4, 256, 64, 65, (4096,) * 8, (5,) * 8, GEMMA),
    # ragged rows, one inactive (positions -1, kv_len 0: it writes nothing)
    "ragged_inactive_row_d64": (4, 5, 32, 8, 64, 16, 8, (37, 0, 100, 11), (5, 0, 5, 5), {}),
}
NEAR_TIE = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the verify-shape prefill and the chained fetches went unchecked here "
                    "(run pytest -m cuda on the card; chip_smoke.py checks them too)")
    return torch.device("cuda")


def _verify_inputs(name, dtype, device):
    B, T, NH, KH, D, page, maxp, computed, chunks, extra = VERIFY_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    P = B * maxp + 3
    kp, vp, _ = _pools(rng, (1, P, page, KH, D), False, dtype, device)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos[b, : chunks[b]] = np.arange(computed[b], computed[b] + chunks[b])
    lens = np.array([c + n if n else 0 for c, n in zip(computed, chunks)], np.int32)
    args = [
        _on(rng.randn(B, T, NH, D).astype(np.float32), dtype, device), kp, vp,
        _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), dtype, device),
        _on(pos, dtype, device), _on(lens, dtype, device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), dtype, device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), dtype, device),
        _on(np.array(chunks, np.int32), dtype, device),
    ]
    return args, dict(extra)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_shape_prefill_matches_its_plain_version(cuda_device, name, dtype):
    args, kw = _verify_inputs(name, getattr(torch, dtype), cuda_device)
    a, r = list(args), list(args)
    a[1], a[2], r[1], r[2] = args[1].clone(), args[2].clone(), args[1].clone(), args[2].clone()
    out = pmod.prefill_attention(*a, fused_write=True, **kw)
    ref = pmod.prefill_attention_ref(*r, fused_write=True, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert _same(a[1], r[1]) and _same(a[2], r[2])
    for b, c in enumerate(VERIFY_CASES[name][8]):
        if c == 0:
            assert float(out[b].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 1])
def test_verify_shape_prefill_on_a_stage_pool_matches_its_plain_version(cuda_device, layer):
    """The verify forward on a pipeline stage (pp 2 with speculative_k):
    an 8-row microbatch, T = 5 after 1,024 tokens and ragged rows (one
    inactive), on the stage's 2-layer pool at its local layer index: the
    output within the bf16 bound of the plain version's, the written pages
    byte-identical to the plain write's, the stage's other layer untouched."""
    rng = np.random.RandomState(49 + layer)
    B, T, NH, KH, D, page, maxp = 8, 5, 32, 8, 64, 64, 17
    computed = [1024, 1024, 37, 0, 1024, 500, 1024, 1020]
    chunks = [5, 5, 5, 0, 5, 5, 5, 5]
    P = B * maxp + 3
    kp, vp, _ = _pools(rng, (2, P, page, KH, D), False, torch.bfloat16, cuda_device)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos[b, : chunks[b]] = np.arange(computed[b], computed[b] + chunks[b])
    lens = np.array([c + n if n else 0 for c, n in zip(computed, chunks)], np.int32)
    args = [
        _on(rng.randn(B, T, NH, D).astype(np.float32), torch.bfloat16, cuda_device), kp, vp,
        _on(rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32), torch.bfloat16, cuda_device),
        _on(pos, torch.bfloat16, cuda_device), _on(lens, torch.bfloat16, cuda_device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), torch.bfloat16, cuda_device),
        _on(rng.randn(B, T, KH, D).astype(np.float32), torch.bfloat16, cuda_device),
        _on(np.array(chunks, np.int32), torch.bfloat16, cuda_device),
    ]
    a, r = list(args), list(args)
    a[1], a[2], r[1], r[2] = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    out = pmod.prefill_attention(*a, fused_write=True, layer=layer)
    ref = pmod.prefill_attention_ref(*r, fused_write=True, layer=layer)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])
    assert _same(a[1], r[1]) and _same(a[2], r[2])
    other = 1 - layer
    assert _same(a[1][other], kp[other]) and _same(a[2][other], vp[other])
    assert not _same(a[1][layer], kp[layer])
    assert float(out[3].float().abs().max()) == 0.0


# -- the runner on an f32 copy of llama-3.2-1b, two layers ----------------------

B, T, PAGE, MAXP = 4, 64, 64, 4


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: step_spec and step_multi_pipelined through the kernels went unchecked "
                    "here (run pytest -m cuda on the card; chip_smoke.py checks them too)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=2, dtype=torch.float32)
    m = llama.LlamaForCausalLM(cfg, device="cuda")
    llama.init_params(m, torch.Generator(device="cuda").manual_seed(0))
    return m


def _runner(model):
    return ModelRunner(model, num_pages=B * MAXP + 1, page_size=PAGE, seed=0, device="cuda")


def _common():
    return dict(page_table=np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP),
                temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32))


def _prompts():
    """Prompts that repeat a 3-gram cycle, so the n-gram drafts fire."""
    rng = np.random.RandomState(2)
    return np.stack([np.tile(rng.randint(1, 128000, 3), T)[:T] for _ in range(B)]).astype(np.int32)


def _prefill(runner):
    ids = _prompts()
    first, _ = runner.step(StepInput(input_ids=ids, positions=np.tile(np.arange(T, dtype=np.int32), (B, 1)),
                                     kv_lens=np.full(B, T, np.int32), **_common()), want_logits=False)
    return ids, first.cpu().numpy()


@pytest.mark.cuda
def test_step_spec_tokens_are_sequential_greedy(model):
    spec_r, seq_r = _runner(model), _runner(model)
    ids, first = _prefill(spec_r)
    _prefill(seq_r)
    steps, k = 4, 3
    inp = StepInput(input_ids=first[:, None].astype(np.int32), positions=np.full((B, 1), T, np.int32),
                    kv_lens=np.full(B, T + 1, np.int32), kv_limits=np.full(B, MAXP * PAGE, np.int32), **_common())
    cur, greedy, margins = inp, [], []
    for _ in range(steps * (k + 1)):
        nxt, logits = seq_r.step(cur)
        top = logits.topk(2, dim=-1).values
        greedy.append(nxt.cpu().numpy())
        margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
        cur = dataclasses.replace(cur, input_ids=greedy[-1][:, None].astype(np.int32), positions=cur.positions + 1,
                                  kv_lens=cur.kv_lens + 1)
    greedy, margins = np.stack(greedy, 1), np.stack(margins, 1)
    # the history: the prompt, the first token, and an earlier copy of the
    # trailing 3-gram followed by the next k greedy tokens, so that round 1
    # drafts them
    hist = np.zeros((B, 128), np.int32)
    hist[:, :T], hist[:, T] = ids, first
    hist[:, 10], hist[:, 11], hist[:, 12] = ids[:, T - 2], ids[:, T - 1], first
    hist[:, 13: 13 + k] = greedy[:, :k]
    spec_r.verify_launches = 0
    spec = spec_r.step_spec(inp, hist, steps=steps, spec_k=k, ngram=3).cpu().numpy()
    assert spec.shape == (B, steps, 1 + k)
    assert spec_r.verify_launches == 2 * steps  # one prefill launch a layer and round
    for b in range(B):
        got = spec[b][spec[b] >= 0]
        j = next((j for j, (x, y) in enumerate(zip(got, greedy[b])) if x != y), len(got))
        assert j == len(got) or margins[b, j] <= NEAR_TIE, (b, j, margins[b, j])
    assert (spec >= 0).sum() > B * steps  # some drafts were accepted


@pytest.mark.cuda
def test_step_multi_pipelined_equals_separate_bursts_bit_for_bit(model):
    chain_r, sep_r = _runner(model), _runner(model)
    _, first = _prefill(chain_r)
    _prefill(sep_r)
    k, bursts = 2, 4
    inp = StepInput(input_ids=first[:, None].astype(np.int32), positions=np.full((B, 1), T, np.int32),
                    kv_lens=np.full(B, T + 1, np.int32), kv_limits=np.full(B, T + k * bursts, np.int32), **_common())
    groups = chain_r.step_multi_pipelined(inp, k, bursts, fetch_group=2)
    assert len(groups) == 2 and all(isinstance(g, HostTokens) for g in groups)
    got = np.concatenate([g.numpy() for g in groups], axis=1)
    cur, want = inp, []
    for _ in range(bursts):
        t = sep_r.step_multi(cur, k).cpu().numpy()
        want.append(t)
        cur = dataclasses.replace(cur, input_ids=t[:, -1:].astype(np.int32), positions=cur.positions + k,
                                  kv_lens=cur.kv_lens + k)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
    torch.cuda.synchronize()
    assert _same(chain_r.k_pages, sep_r.k_pages) and _same(chain_r.v_pages, sep_r.v_pages)


@pytest.mark.cuda
def test_fetch_groups_arrive_through_their_events(model):
    """Each group's tokens land in pinned host memory behind its own
    bursts: ``numpy()`` waits on the group's event alone (no device-wide
    synchronize), group by group in order, and gives the chain's tokens."""
    r, ref = _runner(model), _runner(model)
    _, first = _prefill(r)
    _prefill(ref)
    k, bursts = 2, 6
    inp = StepInput(input_ids=first[:, None].astype(np.int32), positions=np.full((B, 1), T, np.int32),
                    kv_lens=np.full(B, T + 1, np.int32), kv_limits=np.full(B, T + k * bursts, np.int32), **_common())
    torch.cuda.synchronize()
    groups = r.step_multi_pipelined(inp, k, bursts, fetch_group=1)
    assert all(g.host.is_pinned() and not g.host.is_cuda for g in groups)
    got = []
    for g in groups:
        got.append(g.numpy())
        assert g.event.query()
    whole = np.concatenate([t.cpu().numpy() for t in ref.step_multi_pipelined(inp, k, bursts)], axis=1)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), whole)
