"""Chained decode bursts in the port (runner.step_multi_pipelined, the
engine's chained branch with grouped fetches and run-ahead prefills)
against the JAX package's, case for case with the chained and penalty
cases of tests/test_multistep.py.

Every case runs on llama-debug-4kv-f32 with the JAX weights
(``params_from_jax``): the port's chain gives the tokens of the JAX chain
and of separate bursts fed from the host; a row whose limit lands mid-chain
stops there and its neighbour is untouched; with penalties the device
history crosses the seam; the engines at decode_pipeline > 1 stream the
unchained engine's and the JAX chained engine's greedy text; a request that
arrives while a chain is in flight has its prefill dispatched behind the
chain (run-ahead) and gets the text it gets alone.
"""

import asyncio
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.models import llama as tllama

MODEL = "llama-debug-4kv-f32"
F32 = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def weights():
    cfg_j = dataclasses.replace(jllama.PRESETS[MODEL], attn_impl="xla")
    p = jax.device_get(jllama.init_params(cfg_j, jax.random.key(0)))
    _, _, model = load_model(MODEL, device="cpu", params=params_from_jax(p, tllama.PRESETS[MODEL]))
    return cfg_j, p, model


def _runners(weights, num_pages):
    cfg_j, p, model = weights
    jr = JaxRunner(cfg_j, params=jax.tree.map(jnp.asarray, p), num_pages=num_pages, page_size=8, seed=0)
    return jr, ModelRunner(model, num_pages=num_pages, page_size=8, seed=0, device="cpu")


def _decode_input(cls, rng, B, ctx, ctx_pages, **kw):
    return cls(
        input_ids=rng.randint(0, 512, (B, 1)).astype(np.int32), positions=np.full((B, 1), ctx, np.int32),
        page_table=np.arange(B * ctx_pages, dtype=np.int32).reshape(B, ctx_pages),
        kv_lens=np.full((B,), ctx + 1, np.int32), temperature=np.zeros(B, np.float32),
        top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32), **kw,
    )


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def test_step_multi_pipelined_matches_sequential_greedy(weights):
    """Chained bursts (each burst's input from the previous burst's device
    tokens) equal separate step_multi calls fed from the host, and the JAX
    chain; the pools the chain wrote equal the separate bursts' bit for bit
    and the JAX chain's within 2e-5."""
    B, ctx_pages, k, m, ctx = 2, 8, 3, 3, 16
    lim = np.full((B,), ctx + 1 + m * k, np.int32)
    jr, r1 = _runners(weights, B * ctx_pages)
    _, r2 = _runners(weights, B * ctx_pages)
    ref, cur = [], _decode_input(StepInput, np.random.RandomState(2), B, ctx, ctx_pages, kv_limits=lim.copy())
    for _ in range(m):
        t = r1.step_multi(cur, k).numpy()
        ref.append(t)
        cur = dataclasses.replace(cur, input_ids=t[:, -1:].astype(np.int32), positions=cur.positions + k,
                                  kv_lens=cur.kv_lens + k)
    ref = np.concatenate(ref, axis=1)
    inp = _decode_input(StepInput, np.random.RandomState(2), B, ctx, ctx_pages, kv_limits=lim.copy())
    outs = r2.step_multi_pipelined(inp, k, m)
    assert len(outs) == m and all(tuple(o.shape) == (B, k) for o in outs)
    got = np.concatenate([o.numpy() for o in outs], axis=1)
    np.testing.assert_array_equal(got, ref)
    jinp = _decode_input(JaxStepInput, np.random.RandomState(2), B, ctx, ctx_pages, kv_limits=lim.copy())
    np.testing.assert_array_equal(np.concatenate([np.asarray(d) for d in jr.step_multi_pipelined(jinp, k, m)], 1),
                                  got)
    assert r2.k_pages.equal(r1.k_pages) and r2.v_pages.equal(r1.v_pages)
    pids = list(range(B * ctx_pages))
    np.testing.assert_allclose(np.stack(r2.get_pages(pids)[0]), np.stack(jr.get_pages(pids)[0]), **F32)


def test_step_multi_pipelined_limit_mid_chain(weights):
    """A row whose kv_limit lands inside burst 2 of a 3-burst chain: its real
    tokens match the unlimited run and the JAX chain's, the neighbour row is
    unaffected, and the seam passes position -1 (the neighbour's later
    tokens attend over its own pages, so a stray write would show)."""
    B, ctx_pages, k, m, ctx = 2, 8, 3, 3, 16
    lim0 = k + 1  # row 0: one token into burst 2
    full = np.full((B,), ctx + 1 + m * k, np.int32)
    lims = np.array([ctx + 1 + lim0 - 1, ctx + 1 + m * k], np.int32)
    jr, r_ref = _runners(weights, B * ctx_pages)
    _, r_lim = _runners(weights, B * ctx_pages)
    ref = np.concatenate([o.numpy() for o in r_ref.step_multi_pipelined(
        _decode_input(StepInput, np.random.RandomState(3), B, ctx, ctx_pages, kv_limits=full), k, m)], axis=1)
    got = np.concatenate([o.numpy() for o in r_lim.step_multi_pipelined(
        _decode_input(StepInput, np.random.RandomState(3), B, ctx, ctx_pages, kv_limits=lims), k, m)], axis=1)
    jgot = np.concatenate([np.asarray(d) for d in jr.step_multi_pipelined(
        _decode_input(JaxStepInput, np.random.RandomState(3), B, ctx, ctx_pages, kv_limits=lims), k, m)], axis=1)
    np.testing.assert_array_equal(got[0, :lim0], ref[0, :lim0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0, :lim0], jgot[0, :lim0])
    np.testing.assert_array_equal(got[1], jgot[1])
    # row 0 wrote positions 16..19 and nothing after: its page 2 (slots
    # 16..23) holds four tokens, page 3 nothing
    k0 = r_lim.k_pages[:, 2]
    assert k0[:, :4].abs().sum() > 0 and not k0[:, 4:].any() and not r_lim.k_pages[:, 3].any()


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_fetch_groups_join_their_bursts(weights, groups):
    """With fetch_group g the chain comes back one array per group of g
    bursts (the last group shorter), joined on the device in order; on the
    CPU each is a plain tensor."""
    B, ctx_pages, k, m, ctx = 2, 8, 2, 5, 16
    lim = np.full((B,), ctx + 1 + m * k, np.int32)
    _, r1 = _runners(weights, B * ctx_pages)
    _, r2 = _runners(weights, B * ctx_pages)
    whole = np.concatenate([o.numpy() for o in r1.step_multi_pipelined(
        _decode_input(StepInput, np.random.RandomState(4), B, ctx, ctx_pages, kv_limits=lim), k, m)], axis=1)
    outs = r2.step_multi_pipelined(_decode_input(StepInput, np.random.RandomState(4), B, ctx, ctx_pages,
                                                 kv_limits=lim), k, m, fetch_group=groups)
    assert [o.shape[1] for o in outs] == [min(groups, m - i) * k for i in range(0, m, groups)]
    np.testing.assert_array_equal(np.concatenate([o.numpy() for o in outs], axis=1), whole)


def _penalty_input(cls, B, ctx, ctx_pages, k, m, freq):
    rng = np.random.RandomState(5)
    hist = np.zeros((B, 64), np.int32)
    prompt = rng.randint(1, 512, (B, ctx + 1))
    hist[:, : ctx + 1] = prompt
    inp = _decode_input(cls, rng, B, ctx, ctx_pages, kv_limits=np.full((B,), ctx + 1 + m * k, np.int32),
                        history=hist, prompt_lens=np.full((B,), ctx + 1, np.int32),
                        presence=np.zeros(B, np.float32), frequency=np.full(B, freq, np.float32),
                        repetition=np.ones(B, np.float32))
    inp.input_ids = prompt[:, -1:].astype(np.int32).copy()
    return inp


def test_step_multi_frequency_penalty_no_repeats(weights):
    """A huge frequency penalty bans every sampled token from reappearing
    within the burst (the history takes each token as it is drawn), and the
    tokens are the JAX burst's."""
    B, ctx_pages, k, ctx = 2, 8, 6, 16
    jr, r = _runners(weights, B * ctx_pages)
    toks = r.step_multi(_penalty_input(StepInput, B, ctx, ctx_pages, k, 1, 1000.0), k).numpy()
    for b in range(B):
        assert len(set(toks[b].tolist())) == k, toks[b]
    np.testing.assert_array_equal(toks, np.asarray(jr.step_multi(_penalty_input(JaxStepInput, B, ctx, ctx_pages,
                                                                                k, 1, 1000.0), k)))


def test_pipelined_penalties_read_the_device_history_across_the_seam(weights):
    """Over a 3-burst chain with a frequency penalty no token repeats across
    bursts (the next burst counts the previous burst's tokens from the
    history it left on the device), and the tokens equal the JAX chain's and
    separate bursts whose history the host rebuilt from fetched tokens."""
    B, ctx_pages, k, m, ctx = 2, 8, 3, 3, 16
    jr, r = _runners(weights, B * ctx_pages)
    _, r1 = _runners(weights, B * ctx_pages)
    got = np.concatenate([o.numpy() for o in r.step_multi_pipelined(
        _penalty_input(StepInput, B, ctx, ctx_pages, k, m, 1000.0), k, m)], axis=1)
    for b in range(B):
        assert len(set(got[b].tolist())) == m * k, got[b]
    jgot = np.concatenate([np.asarray(d) for d in jr.step_multi_pipelined(
        _penalty_input(JaxStepInput, B, ctx, ctx_pages, k, m, 1000.0), k, m)], axis=1)
    np.testing.assert_array_equal(got, jgot)
    cur, ref = _penalty_input(StepInput, B, ctx, ctx_pages, k, m, 1000.0), []
    for j in range(m):
        t = r1.step_multi(cur, k).numpy()
        ref.append(t)
        hist = cur.history.copy()
        hist[:, ctx + 1 + j * k: ctx + 1 + (j + 1) * k] = t
        cur = dataclasses.replace(cur, input_ids=t[:, -1:].astype(np.int32), positions=cur.positions + k,
                                  kv_lens=cur.kv_lens + k, history=hist)
    np.testing.assert_array_equal(got, np.concatenate(ref, axis=1))


# -- the engines ----------------------------------------------------------------


def _cfg(cls=EngineConfig, **kw):
    base = dict(model=MODEL, max_model_len=96, max_num_seqs=8, num_pages=64, page_size=8, prefill_chunk=32,
                decode_steps=3)
    base.update(kw)
    return cls(**base)


async def _one(engine, prompt, sp_cls, **params):
    ids, text, reason = [], "", None
    async for out in engine.generate(f"s-{np.random.randint(1 << 30)}", prompt=prompt, params=sp_cls(**params)):
        text += out.text_delta
        ids += list(out.token_ids)
        if out.finished:
            reason = out.finish_reason
    return text, ids, reason


def _gen(engine, prompt, sp_cls=SamplingParams, **params):
    return asyncio.run(_one(engine, prompt, sp_cls, **params))


def _port(jeng, **kw):
    return LLMEngine(_cfg(**kw), device="cpu", params=params_from_jax(jax.device_get(jeng.runner.params),
                                                                     tllama.PRESETS[MODEL]))


GREEDY = dict(max_tokens=14, temperature=0.0, ignore_eos=True)
PENALIZED = dict(GREEDY, frequency_penalty=1.5, presence_penalty=0.4)


@pytest.mark.parametrize("params,prompt", [(GREEDY, "pipeline me"), (PENALIZED, "penalize me please")],
                         ids=["greedy", "penalties"])
def test_engine_decode_pipeline_matches_unpipelined_and_the_jax_chain(params, prompt):
    """decode_pipeline 3 streams the unchained engine's greedy text (with
    penalties too: the device history crosses the seams) and the JAX chained
    engine's, and its dispatches chain."""
    jeng = JaxEngine(_cfg(JaxEngineConfig, decode_pipeline=3))
    e1, e3 = _port(jeng, decode_pipeline=1), _port(jeng, decode_pipeline=3)
    for e in (jeng, e1, e3):
        e.start()
    try:
        t1, ids1, r1 = _gen(e1, prompt, **params)
        t3, ids3, r3 = _gen(e3, prompt, **params)
        tj, idsj, rj = _gen(jeng, prompt, JaxSamplingParams, **params)
        assert len(ids1) == len(ids3) == 14 and r1 == r3 == rj == "length"
        assert ids3 == ids1 == idsj and t3 == t1 == tj
        assert e3.stats()["decode_chained_dispatches_total"] > 0 and e1.stats()["decode_chained_dispatches_total"] == 0
    finally:
        for e in (jeng, e1, e3):
            e.stop()


def test_engine_decode_pipeline_4_matches_the_jax_engine_text():
    """Three concurrent requests (one with logprobs, so its chains fetch
    whole) at decode_pipeline 4: the JAX engine's tokens, and the chain
    counters and loop sections of the JAX engine's stats."""
    prompts = ["the first prompt, a short one", "a second prompt " * 3, "third"]
    jeng = JaxEngine(_cfg(JaxEngineConfig, decode_pipeline=4, decode_steps=2))
    peng = _port(jeng, decode_pipeline=4, decode_steps=2)
    for e in (jeng, peng):
        e.start()
    try:
        def run(engine, sp_cls):
            async def go():
                return await asyncio.gather(*(
                    _one(engine, p, sp_cls, max_tokens=20, temperature=0.0, ignore_eos=True,
                         **({"logprobs": 2} if i == 2 else {}))
                    for i, p in enumerate(prompts)))
            return asyncio.run(go())

        got, want = run(peng, SamplingParams), run(jeng, JaxSamplingParams)
        assert [g[1] for g in got] == [w[1] for w in want] and all(len(g[1]) == 20 for g in got)
        s, j = peng.stats(), jeng.stats()
        assert s["decode_chained_dispatches_total"] > 0
        for key in ("decode_chained_dispatches_total", "runahead_prefill_dispatches_total",
                    "engine_loop_chain_dispatch_seconds_total", "engine_loop_chain_fetch_seconds_total"):
            assert key in s and key in j
    finally:
        for e in (jeng, peng):
            e.stop()


def test_a_runahead_prefill_fires_while_a_chain_is_in_flight():
    """Request B arrives while request A's chain is in flight (the test
    holds the chain's return until B is in the inbox): B's prefill is
    dispatched behind the chain (runahead_prefill_dispatches_total), and
    both get the tokens they get alone."""
    jeng = JaxEngine(_cfg(JaxEngineConfig))
    alone = _port(jeng, decode_pipeline=4)
    eng = _port(jeng, decode_pipeline=4)
    jeng.stop()
    chained, b_queued = threading.Event(), threading.Event()
    inner = eng.runner.step_multi_pipelined

    def hold(*a, **kw):
        out = inner(*a, **kw)
        if not chained.is_set():
            chained.set()
            b_queued.wait(30)  # B's sequence is in the inbox
        return out

    eng.runner.step_multi_pipelined = hold
    for e in (alone, eng):
        e.start()
    try:
        want = [_gen(alone, p, **dict(GREEDY, max_tokens=30)) for p in ("request A", "request B")]

        async def go():
            ta = asyncio.ensure_future(_one(eng, "request A", SamplingParams, **dict(GREEDY, max_tokens=30)))
            await asyncio.get_running_loop().run_in_executor(None, chained.wait, 30)
            tb = asyncio.ensure_future(_one(eng, "request B", SamplingParams, **dict(GREEDY, max_tokens=30)))
            for _ in range(300):
                if eng._inbox.qsize():
                    break
                await asyncio.sleep(0.01)
            b_queued.set()
            return await asyncio.gather(ta, tb)

        got = asyncio.run(go())
        assert chained.is_set()
        assert eng.stats()["runahead_prefill_dispatches_total"] >= 1
        assert [g[1] for g in got] == [w[1] for w in want]
    finally:
        for e in (alone, eng):
            e.stop()
