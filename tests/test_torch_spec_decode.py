"""Speculative decoding in the port (runner.step_spec, all-position logits,
the n-gram draft, the engine's spec branch and the server's refusals)
against the JAX package's, case for case with tests/test_spec_decode.py.

- The n-gram draft: equal to the JAX ``_ngram_draft`` on random histories.
- all_logits: the [B, T, V] logits of every position within 2e-5 of the
  JAX forward's on f32 twins of llama, gemma2 and opt; bf16 pools to the
  bf16 logit bound, and int8 pools (llama's f32 twin) to 2e-5.
- step_spec on llama-debug-4kv-f32 with the JAX weights: tokens equal to
  the JAX step_spec's and to sequential greedy, and the pages that hold
  accepted tokens within 2e-5 of the JAX pools. The port writes the verify
  forward's K/V in place; the JAX round scatters back only the pages up to
  the last accepted token, so a page past it holds stale drafts in the port
  and its old bytes in JAX (a difference by design, tested below).
- The engines on the same weights: the same greedy text at speculative_k
  as a plain engine and as the JAX spec engine, for llama, gemma2 and opt
  (f32 copies); EOS and the context limit; the acceptance counters; the
  API's 400s against the JAX server's.
"""

import asyncio
import dataclasses

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.engine.runner import _ngram_draft
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import gemma2 as jgemma
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import opt as jopt
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput, ngram_draft
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.models import gemma2 as tgemma
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import opt as topt

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=0.1, rtol=0.0)
MODEL = "llama-debug-4kv-f32"
# f32 copies of the other families' debug presets, added to both packages'
# preset tables for the tests that name them
F32_COPIES = {"gemma2-debug-f32": (jgemma, tgemma, "gemma2-debug"), "opt-debug-f32": (jopt, topt, "opt-debug")}


@pytest.fixture
def f32_presets(monkeypatch):
    for name, (jmod, tmod, base) in F32_COPIES.items():
        monkeypatch.setitem(jmod.PRESETS, name, dataclasses.replace(jmod.PRESETS[base], dtype=jnp.float32))
        monkeypatch.setitem(tmod.PRESETS, name, dataclasses.replace(tmod.PRESETS[base], dtype=torch.float32))


# -- the n-gram draft ---------------------------------------------------------


def test_ngram_draft_finds_most_recent_match():
    # ... 5 6 7 9 9 | 5 6 7 <- tail (pos 7): the match at 0 drafts 9 9; row 1
    # has no earlier occurrence of its tail and repeats its current token
    buf = np.zeros((2, 16), np.int32)
    buf[0, :8] = [5, 6, 7, 9, 9, 5, 6, 7]
    buf[1, :8] = [1, 2, 3, 4, 5, 6, 7, 8]
    draft = ngram_draft(torch.from_numpy(buf), torch.tensor([7, 7]), n=3, k=2).numpy()
    np.testing.assert_array_equal(draft, [[9, 9], [8, 8]])
    np.testing.assert_array_equal(draft, np.asarray(_ngram_draft(jnp.asarray(buf), jnp.asarray([7, 7]), 3, 2)))


def test_ngram_draft_prefers_recent():
    buf = np.zeros((1, 16), np.int32)
    buf[0, :11] = [1, 2, 7, 0, 1, 2, 8, 0, 0, 1, 2]
    draft = ngram_draft(torch.from_numpy(buf), torch.tensor([10]), n=2, k=1).numpy()
    np.testing.assert_array_equal(draft, [[8]])


@pytest.mark.parametrize("n,k", [(1, 1), (2, 3), (3, 4), (4, 2)])
def test_ngram_draft_equals_jax_on_random_histories(n, k):
    """Small alphabets, so windows match often and ties between matches
    (the most recent wins), the end of the buffer and positions too short
    for a match all occur."""
    rng = np.random.RandomState(10 * n + k)
    for _ in range(8):
        buf = rng.randint(0, 3, (6, 48)).astype(np.int32)
        pos = rng.randint(0, 48, (6,)).astype(np.int32)
        want = np.asarray(_ngram_draft(jnp.asarray(buf), jnp.asarray(pos), n, k))
        got = ngram_draft(torch.from_numpy(buf), torch.from_numpy(pos).long(), n, k).numpy()
        np.testing.assert_array_equal(got, want)


# -- all-position logits --------------------------------------------------------

# family -> (JAX module, port module, preset, config overrides for both)
FAMILIES = {
    "llama_f32": (jllama, tllama, "llama-debug-4kv-f32", {}, F32),
    "llama_bf16": (jllama, tllama, "llama-debug", {}, BF16),
    "llama_int8_f32": (jllama, tllama, "llama-debug-4kv-f32", {"kv_cache_dtype": "int8"}, F32),
    "gemma2_f32": (jgemma, tgemma, "gemma2-debug", {"dtype": "f32"}, F32),
    "opt_f32": (jopt, topt, "opt-debug", {"dtype": "f32"}, F32),
}


def _family(key):
    """(JAX config, numpy params, the port model holding them, tol, int8)."""
    jmod, tmod, name, over, tol = FAMILIES[key]
    jover, tover = dict(over), dict(over)
    if over.get("dtype") == "f32":
        jover["dtype"], tover["dtype"] = jnp.float32, torch.float32
    cfg_j = dataclasses.replace(jmod.PRESETS[name], attn_impl="xla", **jover)
    cfg_t = dataclasses.replace(tmod.PRESETS[name], attn_impl="plain", **tover)
    p = jax.device_get(jmod.init_params(cfg_j, jax.random.key(0)))
    model = tmod.CAUSAL_LM(cfg_t, device="cpu")
    from production_stack_tpu_torch.engine.model_loader import load_params

    load_params(model, tmod.params_from_jax(p, cfg_t))
    return jmod, cfg_j, p, model, tol, over.get("kv_cache_dtype") == "int8"


@pytest.mark.parametrize("key", sorted(FAMILIES))
def test_all_logits_match_jax(key):
    """A 16-token chunk, then a verify-shaped step (T = 5, a row inactive at
    -1) after it, each with all_logits: every position's logits against the
    JAX forward's, on the same pools."""
    jmod, cfg_j, p, model, tol, quant = _family(key)
    from production_stack_tpu.ops.quant import init_kv_scales as jax_scales
    from production_stack_tpu_torch.ops.quant import init_kv_scales

    L, KH, D = cfg_j.num_layers, cfg_j.num_kv_heads, cfg_j.head_dim
    P, page = 12, 8
    shape = (L, P, page, KH, D)
    jdt = jnp.int8 if quant else cfg_j.dtype
    jk, jv = jnp.zeros(shape, jdt), jnp.zeros(shape, jdt)
    tdt = torch.int8 if quant else model.cfg.dtype
    tk, tv = torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)
    jsc = (jax_scales(L, P, KH), jax_scales(L, P, KH)) if quant else None
    tsc = (init_kv_scales(L, P, KH, "cpu"), init_kv_scales(L, P, KH, "cpu")) if quant else None
    rng = np.random.RandomState(3)
    pt = np.arange(2 * 6, dtype=np.int32).reshape(2, 6)
    ids = rng.randint(0, cfg_j.vocab_size, (2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    verify_ids = rng.randint(0, cfg_j.vocab_size, (2, 5)).astype(np.int32)
    verify_pos = np.stack([np.arange(16, 21, dtype=np.int32), np.full(5, -1, np.int32)])
    steps = [(ids, pos, np.array([16, 16], np.int32)), (verify_ids, verify_pos, np.array([21, 0], np.int32))]
    jparams = jax.tree.map(jnp.asarray, p)
    for x, ps, lens in steps:
        kw = {"kv_scales": jsc} if quant else {}
        out = jmod.forward(jparams, cfg_j, jnp.asarray(x), jnp.asarray(ps), jk, jv, jnp.asarray(pt),
                           jnp.asarray(lens), all_logits=True, **kw)
        if quant:
            jl, jk, jv, *jsc = out
        else:
            jl, jk, jv = out
        tkw = {"kv_scales": tsc} if quant else {}
        tl = model(torch.from_numpy(x), torch.from_numpy(ps), tk, tv, torch.from_numpy(pt), torch.from_numpy(lens),
                   all_logits=True, **tkw)
        assert tl.shape == (2, x.shape[1], cfg_j.vocab_size) and tl.dtype == torch.float32
        valid = ps >= 0
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **tol)
    # the last-token logits are the all-position logits' last valid row
    last = model(torch.from_numpy(verify_ids[:1]), torch.from_numpy(verify_pos[:1]), tk.clone(), tv.clone(),
                 torch.from_numpy(pt[:1]), torch.tensor([21], dtype=torch.int32),
                 **({"kv_scales": tuple(s.clone() for s in tsc)} if quant else {}))
    np.testing.assert_allclose(last.numpy()[0], tl.numpy()[0, -1], **tol)


# -- step_spec ----------------------------------------------------------------


def _f32_pair(num_pages):
    cfg_j = dataclasses.replace(jllama.PRESETS[MODEL], attn_impl="xla")
    p = jax.device_get(jllama.init_params(cfg_j, jax.random.key(0)))
    _, _, model = load_model(MODEL, device="cpu", params=params_from_jax(p, tllama.PRESETS[MODEL]))
    jr = JaxRunner(cfg_j, params=jax.tree.map(jnp.asarray, p), num_pages=num_pages, page_size=8, seed=0)
    return jr, ModelRunner(model, num_pages=num_pages, page_size=8, seed=0, device="cpu"), model


def _decode_input(cls, first, B, ctx, ctx_pages, **kw):
    return cls(
        input_ids=first, positions=np.full((B, 1), ctx, np.int32),
        page_table=np.arange(B * ctx_pages, dtype=np.int32).reshape(B, ctx_pages),
        kv_lens=np.full((B,), ctx + 1, np.int32), temperature=np.zeros(B, np.float32),
        top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32), **kw,
    )


def _sequential_greedy(model, first, B, ctx, ctx_pages, n):
    r = ModelRunner(model, num_pages=B * ctx_pages, page_size=8, seed=0, device="cpu")
    inp = _decode_input(StepInput, first.copy(), B, ctx, ctx_pages)
    out = []
    for _ in range(n):
        ids, _ = r.step(inp)
        ids = ids.numpy()
        out.append(ids)
        inp.input_ids = ids[:, None].astype(np.int32)
        inp.positions = inp.positions + 1
        inp.kv_lens = inp.kv_lens + 1
    return np.stack(out, axis=1)


def test_step_spec_greedy_matches_sequential():
    """Spec-decoded greedy tokens are plain sequential greedy's, token for
    token, and the JAX step_spec's: row 0's history holds its greedy
    continuation after an earlier copy of its trailing bigram, so its first
    draft is accepted whole; row 1's drafts are rejected."""
    B, ctx_pages, ctx, steps, k, n = 2, 8, 16, 3, 3, 2
    jr, tr, model = _f32_pair(B * ctx_pages)
    rng = np.random.RandomState(0)
    hist = np.zeros((B, 64), np.int32)
    hist[:, : ctx + 1] = rng.randint(0, 512, (B, ctx + 1))
    hist[:, ctx - 1], hist[:, ctx] = hist[:, 3], hist[:, 4]  # trailing bigram == positions 3..4
    first = hist[:, ctx: ctx + 1].copy()
    seq = _sequential_greedy(model, first, B, ctx, ctx_pages, steps * (k + 1))
    hist[0, 5: 5 + k] = seq[0, :k]  # row 0 drafts its own greedy continuation
    lim = np.full((B,), ctx_pages * 8, np.int32)
    got = tr.step_spec(_decode_input(StepInput, first.copy(), B, ctx, ctx_pages, kv_limits=lim), hist,
                       steps=steps, spec_k=k, ngram=n).numpy()
    want = np.asarray(jr.step_spec(_decode_input(JaxStepInput, first.copy(), B, ctx, ctx_pages, kv_limits=lim),
                                   hist, steps=steps, spec_k=k, ngram=n))
    assert got.shape == (B, steps, 1 + k) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0] >= 0).all()  # row 0's first round accepted all k drafts and its bonus
    for i in range(B):
        emitted = [t for t in got[i].reshape(-1) if t >= 0]
        assert len(emitted) >= steps
        np.testing.assert_array_equal(emitted, seq[i, : len(emitted)])


def _prefilled(B=3, T=29, ctx_pages=8):
    """Both runners after one prefill of 3 rows (row 2 a pad row) of T
    tokens: (JAX runner, port runner, prompt ids, page table, first sampled
    token [B, 1], the step's common fields)."""
    jr, tr, _ = _f32_pair(B * ctx_pages + 2)
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 512, (B, T)).astype(np.int32)
    pt = np.arange(B * ctx_pages, dtype=np.int32).reshape(B, ctx_pages)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[2] = -1
    common = dict(page_table=pt, temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32),
                  top_p=np.ones(B, np.float32))
    firsts = []
    for r, cls in ((jr, JaxStepInput), (tr, StepInput)):
        out, _ = r.step(cls(input_ids=ids, positions=pos, kv_lens=np.array([T, T, 0], np.int32), **common))
        firsts.append(np.asarray(out) if cls is JaxStepInput else out.numpy())
    np.testing.assert_array_equal(firsts[1][:2], firsts[0][:2])
    return jr, tr, ids, pt, firsts[1][:, None].astype(np.int32), common


def _spec_after_prefill(steps, k, n=2, plant=0, limits=(200, 200, 0)):
    """step_spec on both runners after ``_prefilled``, on the same history:
    the prompt and first token, and with ``plant`` > 0 an earlier copy of
    each row's trailing bigram followed by its next ``plant`` greedy tokens
    (taken from a first spec run whose drafts found no match), so that
    round 1 accepts them. Returns (port runner, JAX runner, tokens of
    each, kv_lens, page table, final lens)."""
    T = 29
    jr, tr, ids, pt, first, common = _prefilled(T=T)
    hist = np.zeros((3, 128), np.int32)
    hist[:, :T] = ids
    hist[:, T] = first[:, 0]
    if plant:
        greedy = _spec_after_prefill(steps=plant, k=k, n=n)[2]["port"][:, :, 0]
        hist[:, 10], hist[:, 11] = ids[:, T - 1], first[:, 0]
        hist[:, 12: 12 + plant] = greedy
    dpos = np.array([[T], [T], [-1]], np.int32)
    dlens = np.array([T + 1, T + 1, 0], np.int32)
    lim = np.array(limits, np.int32)
    toks = {}
    for tag, r, cls in (("jax", jr, JaxStepInput), ("port", tr, StepInput)):
        inp = cls(input_ids=first, positions=dpos, kv_lens=dlens, kv_limits=lim, **common)
        out = r.step_spec(inp, hist, steps=steps, spec_k=k, ngram=n)
        toks[tag] = np.asarray(out) if tag == "jax" else out.numpy()
    emitted = (toks["port"] >= 0).sum(axis=(1, 2))
    return tr, jr, toks, dlens, pt, dlens + emitted


def test_step_spec_after_prefill_matches_jax_tokens_and_accepted_pages():
    """After a prefill, step_spec's tokens equal the JAX step_spec's and the
    pages from each row's first written one to the one holding its last
    accepted token are within 2e-5 of the JAX pools (a pad row writes
    nothing). Round 1 accepts the planted drafts."""
    tr, jr, toks, lens0, pt, lens_f = _spec_after_prefill(steps=4, k=3, plant=3)
    np.testing.assert_array_equal(toks["port"], toks["jax"])
    assert (toks["port"][2] == -1).all()
    assert (toks["port"][:2, 0] >= 0).all()  # 3 drafts and the bonus, both rows
    for b in range(2):
        pids = [int(pt[b, i]) for i in range((lens0[b] - 1) // 8, (lens_f[b] - 1) // 8 + 1)]
        (tks, tvs), (jks, jvs) = tr.get_pages(pids), jr.get_pages(pids)
        np.testing.assert_allclose(np.stack(tks), np.stack(jks), **F32)
        np.testing.assert_allclose(np.stack(tvs), np.stack(jvs), **F32)
    pad = [int(p) for p in pt[2]]
    assert not np.stack(tr.get_pages(pad)[0]).any() and not np.stack(jr.get_pages(pad)[0]).any()


def test_step_spec_pages_past_the_last_accepted_page_differ_by_design():
    """One round of k = 4 from position 29 writes positions 29..33. A row
    that accepts nothing ends with its bonus token at 30 (page 3), so the
    drafts at 32 and 33 sit in page 4, past its last accepted page: the
    port wrote them there (the verify forward writes in place), the JAX
    round scattered back nothing past page 3, so page 4 keeps its old bytes
    (zeros). Attention never reads those slots (kv_lens masks them) and the
    next dispatch writes over them. Pages 3 and before agree."""
    tr, jr, toks, lens0, pt, lens_f = _spec_after_prefill(steps=1, k=4, n=1)
    np.testing.assert_array_equal(toks["port"], toks["jax"])
    rows = [b for b in range(2) if lens_f[b] == lens0[b] + 1]  # no draft accepted
    assert rows, lens_f
    for b in rows:
        last = (lens_f[b] - 1) // 8
        np.testing.assert_allclose(np.stack(tr.get_pages([int(pt[b, last])])[0]),
                                   np.stack(jr.get_pages([int(pt[b, last])])[0]), **F32)
        past = int(pt[b, last + 1])
        port_page, jax_page = tr.get_pages([past])[0][0], jr.get_pages([past])[0][0]
        written = (lens0[b] - 1 + 4) - (last + 1) * 8 + 1  # slots 0 and 1
        assert written == 2 and not jax_page.any()
        assert all(port_page[:, s].any() for s in range(written)) and not port_page[:, written:].any()


def test_step_spec_refuses_int8_pools():
    _, _, model = load_model("llama-debug", device="cpu")
    model.cfg = dataclasses.replace(model.cfg, kv_cache_dtype="int8")
    r = ModelRunner(model, num_pages=8, page_size=8, device="cpu")
    inp = _decode_input(StepInput, np.zeros((1, 1), np.int32), 1, 4, 2, kv_limits=np.array([16], np.int32))
    with pytest.raises(ValueError, match="not supported with kv_cache_dtype=int8"):
        r.step_spec(inp, np.zeros((1, 16), np.int32), steps=1, spec_k=2, ngram=2)
    with pytest.raises(ValueError, match="--kv-cache-dtype int8 is not compatible with --speculative-k"):
        LLMEngine(EngineConfig(model="llama-debug", kv_cache_dtype="int8", speculative_k=2, num_pages=16,
                               page_size=8), device="cpu")


# -- the engines ----------------------------------------------------------------


def _cfg(cls=EngineConfig, **kw):
    base = dict(model=MODEL, max_model_len=96, max_num_seqs=8, num_pages=64, page_size=8, prefill_chunk=32,
                decode_steps=3)
    base.update(kw)
    return cls(**base)


def _gen(engine, prompt, sp_cls=SamplingParams, **params):
    async def run():
        ids, text, reason = [], "", None
        async for out in engine.generate(f"s-{np.random.randint(1 << 30)}", prompt=prompt,
                                         params=sp_cls(**params)):
            text += out.text_delta
            ids += list(out.token_ids)
            if out.finished:
                reason = out.finish_reason
        return text, ids, reason

    return asyncio.run(run())


def _engines(jcfg, pcfg):
    """A JAX engine and a port engine serving its weights, both started."""
    jeng = JaxEngine(jcfg)
    peng = LLMEngine(pcfg, device="cpu", params=params_from_jax(
        jax.device_get(jeng.runner.params), _port_module(pcfg.model).PRESETS[pcfg.model]))
    jeng.start(), peng.start()
    return jeng, peng


def _port_module(name):
    return next(m for m in (tllama, tgemma, topt) if name in m.PRESETS)


def test_engine_spec_matches_plain_greedy_and_the_jax_spec_engine():
    """A spec engine emits the plain engine's greedy text and token count,
    including the max_tokens cutoff, and the JAX spec engine's."""
    jeng, spec = _engines(_cfg(JaxEngineConfig, speculative_k=3, speculative_ngram=2),
                          _cfg(speculative_k=3, speculative_ngram=2))
    plain = LLMEngine(_cfg(), device="cpu", params=params_from_jax(jax.device_get(jeng.runner.params),
                                                                   tllama.PRESETS[MODEL]))
    plain.start()
    try:
        kw = dict(max_tokens=13, temperature=0.0, ignore_eos=True)
        prompt = "ab ab ab ab ab"  # repetitive, so drafts fire
        t1, ids1, r1 = _gen(plain, prompt, **kw)
        t2, ids2, r2 = _gen(spec, prompt, **kw)
        tj, idsj, rj = _gen(jeng, prompt, JaxSamplingParams, **kw)
        assert (len(ids1), r1) == (len(ids2), r2) == (len(idsj), rj) == (13, "length")
        assert ids2 == ids1 == idsj and t2 == t1 == tj
        assert spec.stats()["spec_decode_num_draft_tokens_total"] > 0
        assert spec.decode_dispatches_total == 0 and spec.spec_verify_forwards > 0
    finally:
        plain.stop(), spec.stop(), jeng.stop()


def test_engine_spec_metrics():
    """The acceptance counters in stats(), equal to the JAX engine's on the
    same weights and request."""
    jeng, peng = _engines(_cfg(JaxEngineConfig, speculative_k=3, speculative_ngram=2),
                          _cfg(speculative_k=3, speculative_ngram=2))
    try:
        for eng, sp in ((jeng, JaxSamplingParams), (peng, SamplingParams)):
            _gen(eng, "ab ab ab ab ab", sp, max_tokens=16, temperature=0.0, ignore_eos=True)
        keys = ("spec_decode_num_draft_tokens_total", "spec_decode_num_accepted_tokens_total",
                "spec_decode_draft_acceptance_rate")
        s, j = peng.stats(), jeng.stats()
        assert {k: s[k] for k in keys} == {k: j[k] for k in keys}
        assert s["spec_decode_num_draft_tokens_total"] > 0
        assert 0 <= s["spec_decode_num_accepted_tokens_total"] <= s["spec_decode_num_draft_tokens_total"]
        assert 0.0 <= s["spec_decode_draft_acceptance_rate"] <= 1.0
        assert "spec_decode_num_draft_tokens_total" not in LLMEngine(_cfg(), device="cpu").stats()
    finally:
        jeng.stop(), peng.stop()


@pytest.mark.parametrize("model", ["opt-debug-f32", "gemma2-debug-f32"])
def test_engine_spec_other_families(model, f32_presets):
    """Every family's all-position verify path: the length cutoff holds and
    the greedy tokens equal the JAX spec engine's on f32 copies."""
    kw = dict(model=model, max_model_len=96, max_num_seqs=4, num_pages=64, page_size=8, decode_steps=2,
              speculative_k=2, speculative_ngram=2)
    jeng, peng = _engines(JaxEngineConfig(**kw), EngineConfig(**kw))
    try:
        params = dict(max_tokens=9, temperature=0.0, ignore_eos=True)
        _, ids, reason = _gen(peng, "go go go go", **params)
        _, jids, jreason = _gen(jeng, "go go go go", JaxSamplingParams, **params)
        assert (len(ids), reason) == (9, "length")
        assert ids == jids and reason == jreason
    finally:
        jeng.stop(), peng.stop()


def test_engine_spec_eos_and_context_limit():
    """At a 48-token context the request ends by length within it (a round's
    drafts may run past max_model_len only in discarded slots), with the
    JAX spec engine's tokens; with EOS on, a finish is stop or length."""
    jeng, peng = _engines(_cfg(JaxEngineConfig, speculative_k=3, speculative_ngram=2, max_model_len=48),
                          _cfg(speculative_k=3, speculative_ngram=2, max_model_len=48))
    try:
        _, ids, reason = _gen(peng, "xy xy xy xy", max_tokens=500, temperature=0.0, ignore_eos=True)
        _, jids, _ = _gen(jeng, "xy xy xy xy", JaxSamplingParams, max_tokens=500, temperature=0.0,
                          ignore_eos=True)
        assert reason == "length" and len(ids) <= 48 and ids == jids
        _, ids, reason = _gen(peng, "q", max_tokens=40, temperature=0.0, ignore_eos=False)
        assert reason in ("stop", "length") and len(ids) <= 40
    finally:
        jeng.stop(), peng.stop()


BAD_REQUESTS = [
    ("penalties", {"frequency_penalty": 0.5}),
    ("logit_bias", {"logit_bias": {"5": 1.0}}),
    ("min_tokens", {"min_tokens": 2}),
    ("logprobs", {"logprobs": 1}),
]


def test_api_refuses_what_speculative_decoding_does_not_serve():
    """With speculative_k the port's server answers penalties, logit_bias,
    min_tokens and logprobs with the JAX server's 400 and message; a plain
    request is served."""
    small = dict(model="llama-debug", host="127.0.0.1", max_model_len=128, max_num_seqs=4, num_pages=32,
                 page_size=8, prefill_chunk=32, speculative_k=2)

    async def run():
        jcfg = JaxEngineConfig(**small, port=free_port())
        pcfg = EngineConfig(**small, port=free_port())
        jsrv, jrun = await jax_server.serve(jcfg)
        psrv, prun = await port_server.serve(pcfg, LLMEngine(pcfg, device="cpu"))
        out = {}
        try:
            async with aiohttp.ClientSession() as s:
                for tag, port in (("jax", jcfg.port), ("port", pcfg.port)):
                    for name, extra in BAD_REQUESTS + [("plain", {})]:
                        body = {"prompt": "hi hi hi", "max_tokens": 3, "temperature": 0.0, **extra}
                        async with s.post(f"http://127.0.0.1:{port}/v1/completions", json=body) as r:
                            out[tag, name] = (r.status, (await r.json()).get("error", {}).get("message"))
        finally:
            await prun.cleanup()
            psrv.engine.stop()
            await jrun.cleanup()
            jsrv.engine.stop()
        return out

    out = asyncio.run(run())
    for name, _ in BAD_REQUESTS:
        assert out["port", name][0] == 400 and out["port", name] == out["jax", name], name
    assert out["port", "plain"] == out["jax", "plain"] == (200, None)
