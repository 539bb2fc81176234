"""Tensor-parallel serving of the port (parallel/, engine/distributed.py,
``decode_attention_sharded``) against the JAX package's on its virtual
8-device CPU mesh (tests/test_tp_serving.py, tests/test_multihost.py,
tests/test_pallas_attention.py TestShardedKernel).

A port engine at tp > 1 runs one process per rank over gloo on the CPU: the
leader in the test process, the followers spawned by it. Its weights are
the JAX engine's (``params_from_jax``, each rank taking its part), so on
the f32 twins greedy tokens must be identical to the JAX engine's at the
same tp, and f32 logits within 2e-5. The JAX side runs its sharded Pallas
decode kernel in interpret mode where its runner takes it (llama and
Gemma-2; its OPT forward takes no mesh, so OPT runs its XLA path).
"""

import asyncio
import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import aiohttp
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.kvoffload import serde as jserde
from production_stack_tpu.models import gemma2 as jgemma
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import opt as jopt
from production_stack_tpu.ops.pallas.paged_attention import ragged_paged_attention_decode_sharded
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu.router.engine_stats import EngineStats
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine import distributed as dist_mod
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.distributed import (
    REPLICATED,
    BroadcastingRunner,
    StepBroadcaster,
    _pack_call,
    _recv_msg,
    _send_msg,
    _unpack_call,
    follower_loop,
    listen_socket,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import (
    _llama_names,
    load_from_hf,
    load_model,
    params_from_jax,
)
from production_stack_tpu_torch.engine.runner import RANK_STATS, ModelRunner, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvoffload.serde import get_serde
from production_stack_tpu_torch.models import gemma2 as tgemma
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import opt as topt
from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention_sharded
from production_stack_tpu_torch.parallel.group import check_backend
from production_stack_tpu_torch.parallel.tp import rank_slice, shard_params, split_axis
from production_stack_tpu_torch.router.engine_stats import EngineStats as PortEngineStats
from production_stack_tpu_torch.utils.arrays import tensor_from_numpy
from production_stack_tpu_torch.utils.safetensors_io import SafetensorsDir, save_file, save_sharded
from test_torch_lora_ranks import rank_runner
from test_torch_surface import _Loop

F32 = dict(atol=2e-5, rtol=2e-5)
MODEL = "llama-debug-4kv-f32"  # KH 4: splits over tp 1, 2 and 4
SMALL = dict(max_model_len=128, num_pages=64, page_size=8, max_num_seqs=4, decode_steps=2, prefill_chunk=32)
PORT_TP = dict(tp_backend="gloo")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def join_params(shards):
    """The whole parameter dict from every rank's (shard_params' inverse);
    a replicated parameter must be the same on every rank."""
    out = {}
    for name, t in shards[0].items():
        ax = split_axis(name)
        if ax is None:
            assert all(torch.equal(s[name], t) for s in shards[1:]), name
            out[name] = t
        else:
            out[name] = torch.cat([s[name] for s in shards], dim=ax)
    return out


def _rank(r, tp):
    """A stand-in for a rank's group where only its place counts (slicing,
    loading)."""
    return types.SimpleNamespace(rank=r, size=tp)


# -- the sharded decode against ragged_paged_attention_decode_sharded ---------


def _sharded_decode_case(dp, tp, burst, quant):
    """Each (d, t) shard's decode_attention_sharded on its rows (q's,
    the page table's, the lengths' and the window's B/dp) and heads (q's
    NH/tp, the pools', scales' and window's KH/tp), joined on rows and
    heads, against the JAX function on the (dp, tp) mesh in interpret
    mode."""
    rng = np.random.RandomState(7 + tp + 10 * (dp - 1))
    B, NH, KH, D, page, P, maxp, L, C = 4, 8, 4, 32, 8, 32, 4, 2, 3
    q = rng.randn(B, NH, D).astype(np.float32)
    if quant:
        kp, vp = (rng.randint(-127, 128, (L, P, page, KH, D)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, (L, P, KH)).astype(np.float32) for _ in range(2))
    else:
        kp, vp = (rng.randn(L, P, page, KH, D).astype(np.float32) for _ in range(2))
        ks = vs = None
    pt = rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32)
    lens = np.array([6, 17, 24, 31], np.int32)
    kw = {}
    if burst:
        kw = dict(k_cur=rng.randn(B, C, KH, D).astype(np.float32), v_cur=rng.randn(B, C, KH, D).astype(np.float32),
                  cur_lens=np.array([1, 3, 2, 3], np.int32))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    if quant:
        jkw.update(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    mesh = make_mesh(dp=dp, tp=tp)
    ref = jax.jit(lambda *a: ragged_paged_attention_decode_sharded(mesh, *a, interpret=True, layer=1, **jkw))(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt), jnp.asarray(lens)
    )
    rows = []
    for d in range(dp):
        rg = _rank(d, dp)

        def rw(x, rg=rg):
            return None if x is None else rank_slice(torch.from_numpy(x), 0, rg).contiguous()

        outs = []
        for t in range(tp):
            g = _rank(t, tp)

            def sl(x, dim, g=g):
                return None if x is None else rank_slice(rw(x), dim, g).contiguous()

            outs.append(decode_attention_sharded(
                sl(q, 1), torch.from_numpy(kp).narrow(3, t * KH // tp, KH // tp).contiguous(),
                torch.from_numpy(vp).narrow(3, t * KH // tp, KH // tp).contiguous(), rw(pt), rw(lens), tp=tp,
                layer=1, k_scales=None if ks is None else torch.from_numpy(ks).narrow(2, t * KH // tp, KH // tp),
                v_scales=None if vs is None else torch.from_numpy(vs).narrow(2, t * KH // tp, KH // tp),
                k_cur=sl(kw.get("k_cur"), 2), v_cur=sl(kw.get("v_cur"), 2), cur_lens=rw(kw.get("cur_lens")),
                plain=True,
            ))
        rows.append(torch.cat(outs, dim=1))
    np.testing.assert_allclose(torch.cat(rows, dim=0).numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("burst", [False, True], ids=["pool", "burst"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_decode_matches_the_jax_sharded_kernel(eight_devices, tp, burst, quant):
    """Each tp rank's decode_attention_sharded on its heads, joined on
    heads, equals the JAX function on the (dp, tp) = (1, tp) mesh in
    interpret mode."""
    _sharded_decode_case(1, tp, burst, quant)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("burst", [False, True], ids=["pool", "burst"])
@pytest.mark.parametrize("dp,tp", [(2, 1), (2, 2)])
def test_sharded_decode_on_dp_rows_matches_the_jax_sharded_kernel(eight_devices, dp, tp, burst, quant):
    """The dp axis: each (d, t) shard on its B/dp rows and its heads,
    joined on both, equals the JAX function on the (dp, tp) mesh."""
    _sharded_decode_case(dp, tp, burst, quant)


def test_sharded_decode_refuses_rows_that_disagree():
    q = torch.zeros(2, 4, 32)
    pool = torch.zeros(1, 4, 8, 2, 32)
    with pytest.raises(ValueError, match="disagree on their rows"):
        decode_attention_sharded(q, pool, pool, torch.zeros(4, 1, dtype=torch.int32), torch.ones(4, dtype=torch.int32),
                                 tp=2)


def test_sharded_decode_refuses_split_groups():
    q = torch.zeros(1, 3, 32)
    pool = torch.zeros(1, 4, 8, 2, 32)
    with pytest.raises(ValueError, match="GQA groups must stay whole"):
        decode_attention_sharded(q, pool, pool, torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
                                 tp=2)


# -- engines: greedy tokens, logits, pool shards and blobs against JAX --------


def _gen(engine, ids, n=8, sp=SamplingParams):
    async def run():
        out = []
        async for o in engine.generate(f"t-{time.monotonic_ns()}", prompt_token_ids=ids,
                                       params=sp(max_tokens=n, temperature=0.0, ignore_eos=True)):
            out += o.token_ids
        return out

    return asyncio.run(run())


def _prompts(vocab, n=2):
    rng = np.random.RandomState(11)
    return [[int(x) for x in rng.randint(1, vocab, 19 + 14 * i)] for i in range(n)]


def _prefill_inputs(vocab):
    """One two-row prefill chunk (row 1 ragged) on fresh pages."""
    rng = np.random.RandomState(3)
    ids = rng.randint(0, vocab, (2, 16)).astype(np.int32)
    pos = np.full((2, 16), -1, np.int32)
    pos[0], pos[1, :11] = np.arange(16), np.arange(11)
    common = dict(input_ids=ids, positions=pos, page_table=np.array([[1, 2], [3, 4]], np.int32),
                  kv_lens=np.array([16, 11], np.int32), temperature=np.zeros(2, np.float32),
                  top_k=np.zeros(2, np.int32), top_p=np.ones(2, np.float32))
    return JaxStepInput(**common), StepInput(**common)


def _jax_engine(model, tp, **kw):
    return JaxEngine(JaxEngineConfig(model=model, tensor_parallel_size=tp, **SMALL, **kw))


def _port_engine(model, tp, jparams, port_cfg, **kw):
    mod = {"llama": tllama, "opt": topt, "gemma2": tgemma}[port_cfg]
    return LLMEngine(EngineConfig(model=model, tensor_parallel_size=tp, **PORT_TP, **SMALL, **kw), device="cpu",
                     params=params_from_jax(jparams, mod.PRESETS[model]))


@pytest.fixture(scope="module", params=["auto", "int8"])
def llama_runs(request, eight_devices):
    """The f32 llama twin at tp 4, 2 and 1 in both packages (fp or int8
    pools), one pair at a time (a process leads one tp group): each pair's
    prefill logits, greedy tokens and pool layout; at tp 4 a registered
    page as both engines gather it, whose JAX blob the tp 2 and tp 1 port
    engines then restore and read back; at tp 2 every rank's counters and
    the gathered weights. The JAX engine runs its sharded decode kernel
    (interpret mode) with fp pools, its XLA path with int8 ones."""
    kv = request.param
    quant = kv == "int8"
    prompts = _prompts(512)
    jinp, tinp = _prefill_inputs(512)
    out = {"kv": kv, "jax": {}, "port": {}, "logits": {}, "layout": {}, "restored": {}}
    for tp in (4, 2, 1):
        jeng = _jax_engine(MODEL, tp, attn_impl="auto" if quant else "pallas_interpret", kv_cache_dtype=kv)
        peng = None
        try:
            jparams = jax.device_get(jeng.runner.params)
            peng = _port_engine(MODEL, tp, jparams, "llama", kv_cache_dtype=kv)
            if not quant:
                jl = np.asarray(jeng.runner.step(jinp)[1])
                tl = peng.runner.step(tinp)[1].numpy()
                out["logits"][tp] = (tl, jl)
                jeng.runner.reset_kv()
                peng.runner.reset_kv()
            jeng.start()
            peng.start()
            out["jax"][tp] = [_gen(jeng, p, sp=JaxSamplingParams) for p in prompts]
            out["port"][tp] = [_gen(peng, p) for p in prompts]
            s = peng.stats()
            out["layout"][tp] = (peng.runner.kv_pool_shard_layout(), peng.kv.num_pages, s["tensor_parallel"],
                                 s["mesh_devices"], peng.runner.k_pages.shape[3])
            get = peng.runner.get_pages_quant if quant else peng.runner.get_pages
            if tp == 4:
                # a registered (full, hashed) page of the same prompt in both
                h = next(iter(jeng.kv.hash_to_page))
                jget = jeng.runner.get_pages_quant if quant else jeng.runner.get_pages
                jpage = [np.asarray(x[0]) for x in jget([jeng.kv.hash_to_page[h]])]
                out["pages"] = (jpage, [x[0] for x in get([peng.kv.hash_to_page[h]])])
            else:
                # the JAX tp 4 engine's blob, read by the port's serde
                jpage = out["pages"][0]
                if quant:  # pages come as (k, v, k scales, v scales), blobs take (k, k scales, v, v scales)
                    k, v, sk, sv = jpage
                    qk, sk, qv, sv = get_serde("int8page").deserialize_quant(
                        jserde.get_serde("int8page").serialize_quant(k, sk, v, sv))
                    peng.runner.set_pages_quant([5], [qk], [qv], [sk], [sv])
                else:
                    page = get_serde("naive").deserialize(jserde.get_serde("naive").serialize(*jpage))
                    peng.runner.set_pages([5], *([x] for x in page))
                out["restored"][tp] = [x[0] for x in get([5])]
            if tp == 2:
                out["rank_stats"] = peng.runner.rank_stats()
                out["gathered"] = peng.runner.gathered_params(GATHERED)
            if tp == 1:
                own = dict(peng.runner.model.named_parameters())
                out["whole"] = {name: own[name].detach().clone() for name in GATHERED}
        finally:
            jeng.stop()
            if peng is not None:
                peng.stop()
    return out


GATHERED = ["layers.0.wq", "layers.1.w_down", "layers.1.wk", "embed", "final_norm"]


def test_greedy_tokens_match_the_jax_engine_at_every_tp(llama_runs):
    """tp 1, 2, 4 (fp and int8 pools): the port's greedy tokens are the JAX
    engine's at the same tp, and the same at every tp."""
    j, p = llama_runs["jax"], llama_runs["port"]
    for tp in (1, 2, 4):
        assert p[tp] == j[tp], tp
        assert all(len(ids) == 8 for ids in p[tp])
    assert p[1] == p[2] == p[4]


def test_prefill_logits_match_the_jax_forward_at_every_tp(llama_runs):
    """One f32 prefill chunk through the runners: logits within 2e-5 of the
    JAX forward at the same tp, fp pools (all-reduce order moves them by
    less)."""
    assert llama_runs["logits"] or llama_runs["kv"] == "int8"
    for tp, (tl, jl) in llama_runs["logits"].items():
        np.testing.assert_allclose(tl, jl, **F32, err_msg=f"tp={tp}")


def test_each_rank_holds_its_share_of_the_pool(llama_runs):
    [(one, total)], pages1 = llama_runs["layout"][1][:2]
    assert one == "cpu:0"
    for tp in (2, 4):
        layout, pages, tp_stat, mesh, kh = llama_runs["layout"][tp]
        assert [dev for dev, _ in layout] == [f"cpu:0/tp{r}" for r in range(tp)]
        assert {b for _, b in layout} == {total // tp}
        assert pages == pages1 and tp_stat == mesh == tp
        assert kh == 4 // tp  # the leader's own KV heads


def test_tp4_page_blob_matches_jax_and_restores_into_tp1_and_tp2(llama_runs):
    """A registered page a tp 4 port engine gathers (every KV head) is the
    JAX tp 4 engine's page -- within 2e-5 in f32, int8 codes within one step
    and scales within 1e-5: each framework computes K/V with its own f32
    matmuls, whose sums differ in order (tests/test_torch_llama.py) -- and
    its blob is the JAX serde's blob of the same arrays, byte for byte. The
    JAX tp 4 engine's blob restores bit-identically into tp 1 and tp 2
    port pools."""
    jpage, tpage = llama_runs["pages"]
    if llama_runs["kv"] == "int8":
        qk, qv, sk, sv = tpage
        for got, want in ((qk, jpage[0]), (qv, jpage[1])):
            assert got.dtype == np.int8 and np.abs(got.astype(int) - want.astype(int)).max() <= 1
        for got, want in ((sk, jpage[2]), (sv, jpage[3])):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        blob = (qk, sk, qv, sv)
        assert get_serde("int8page").serialize_quant(*blob) == jserde.get_serde("int8page").serialize_quant(*blob)
    else:
        for got, want in zip(tpage, jpage):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, **F32)
        assert get_serde("naive").serialize(*tpage) == jserde.get_serde("naive").serialize(*tpage)
    for tp in (1, 2):
        back = llama_runs["restored"][tp]
        assert [b.tobytes() for b in back] == [np.asarray(j).tobytes() for j in jpage], tp


def test_rank_stats_and_gathered_params_read_every_rank(llama_runs):
    stats = llama_runs["rank_stats"]
    col = RANK_STATS.index
    assert stats.shape == (2, len(RANK_STATS)) and (stats[:, col("decode_attention_ref")] > 0).all()
    assert (stats[:, col("steps")] > 0).all()  # steps on both ranks
    assert (stats[:, [col("sync_bytes"), col("sync_pages")]] == 0).all()  # no dp replicas to sync
    for name, t in llama_runs["gathered"].items():
        assert torch.equal(t, llama_runs["whole"][name]), name


def spec_then_chain(engine, temperature):
    """Runner calls through ``engine`` (every rank): a 4-row prefill chunk,
    step_spec (3 rounds, k 3, n 2) from the sampled first tokens, run twice
    from the same state: the second time each row's history holds an
    earlier copy of its trailing bigram followed by the first run's next 3
    tokens, so a greedy row's first round accepts all 3 drafts. Then a chain
    of 3 bursts of 2 from where each row's spec ended. Returns (the second
    spec's tokens [4, 3, 4], the chain's tokens [4, 6], every rank's pool
    digest after the spec)."""
    r = engine.runner
    B, T, maxp = 4, 16, 8
    base = np.random.RandomState(8).randint(1, 512, 5)
    prompts = np.stack([np.tile(np.roll(base, i), 4)[:T] for i in range(B)]).astype(np.int32)
    common = dict(page_table=(1 + np.arange(B * maxp, dtype=np.int32)).reshape(B, maxp),
                  temperature=np.asarray(temperature, np.float32), top_k=np.zeros(B, np.int32),
                  top_p=np.ones(B, np.float32))
    first = r.step(StepInput(input_ids=prompts, positions=np.tile(np.arange(T, dtype=np.int32), (B, 1)),
                             kv_lens=np.full(B, T, np.int32), **common), want_logits=False)[0].numpy()
    hist = np.zeros((B, 64), np.int32)
    hist[:, :T], hist[:, T] = prompts, first
    inp = StepInput(input_ids=first[:, None].astype(np.int32), positions=np.full((B, 1), T, np.int32),
                    kv_lens=np.full(B, T + 1, np.int32), kv_limits=np.full(B, maxp * 8, np.int32), **common)
    probe = r.step_spec(inp, hist, steps=3, spec_k=3, ngram=2).numpy()
    hist[:, 2], hist[:, 3] = prompts[:, T - 1], first
    hist[:, 4:7] = np.array([row[row >= 0][:3] for row in probe.reshape(B, -1)])
    spec = r.step_spec(inp, hist, steps=3, spec_k=3, ngram=2).numpy()
    digests = r.replica_digest()
    lens = T + 1 + (spec >= 0).sum(axis=(1, 2))
    last = np.array([row[row >= 0][-1] for row in spec.reshape(B, -1)], np.int32)
    chain = r.step_multi_pipelined(StepInput(input_ids=last[:, None], positions=(lens - 1)[:, None].astype(np.int32),
                                             kv_lens=lens.astype(np.int32), kv_limits=(lens + 5).astype(np.int32),
                                             **common), 2, 3, fetch_group=4)
    return spec, np.concatenate([c.numpy() for c in chain], axis=1), digests


def test_spec_and_chained_decode_at_tp2_match_tp1():
    """The f32 twin's greedy step_spec and chained tokens at tp 2 (every
    rank runs the calls; the drafts agree because the ids are rank 0's) are
    tp 1's, and some drafts were accepted."""
    out = {}
    for tp in (1, 2):
        engine = LLMEngine(EngineConfig(model=MODEL, tensor_parallel_size=tp, **PORT_TP, **SMALL), device="cpu")
        try:
            out[tp] = spec_then_chain(engine, [0.0] * 4)
        finally:
            engine.stop()
    np.testing.assert_array_equal(out[2][0], out[1][0])
    np.testing.assert_array_equal(out[2][1], out[1][1])
    assert (out[1][0] >= 0).sum() > 4 * 3  # more than one token per round somewhere
    assert out[2][2].shape == (2, 32)


@pytest.mark.parametrize("family,model,tp", [
    ("opt", "opt-debug-f32", 1), ("opt", "opt-debug-f32", 2), ("opt", "opt-debug-f32", 4),
    ("gemma2", "gemma2-debug-f32", 1), ("gemma2", "gemma2-debug-f32", 2),
])
def test_opt_and_gemma2_greedy_tokens_match_the_jax_engine(eight_devices, monkeypatch, family, model, tp):
    """OPT (KH 4) at tp 1, 2, 4 and Gemma-2 (KH 2) at tp 1, 2 on f32 copies
    (the JAX package has no f32 twin of either; the test adds one to each
    package, and the port's leader hands it to its followers). The JAX
    engine runs its XLA attention (its sharded kernel is held above)."""
    jmod, tmod = {"opt": (jopt, topt), "gemma2": (jgemma, tgemma)}[family]
    base = model.removesuffix("-f32")
    monkeypatch.setitem(jmod.PRESETS, model, dataclasses.replace(jmod.PRESETS[base], dtype=jnp.float32))
    monkeypatch.setitem(tmod.PRESETS, model, dataclasses.replace(tmod.PRESETS[base], dtype=torch.float32))
    prompts = _prompts(512)
    jeng = _jax_engine(model, tp)
    peng = None
    try:
        peng = _port_engine(model, tp, jax.device_get(jeng.runner.params), family)
        jeng.start()
        peng.start()
        jids = [_gen(jeng, p, sp=JaxSamplingParams) for p in prompts]
        tids = [_gen(peng, p) for p in prompts]
        layout = peng.runner.kv_pool_shard_layout()
        assert len(layout) == tp and len({b for _, b in layout}) == 1
    finally:
        jeng.stop()
        if peng is not None:
            peng.stop()
    assert tids == jids


def test_tp_past_the_kv_heads_is_refused():
    """A tp past the KV heads is served only as a multiple of them (each
    head shared by tp / KH ranks, tests/test_torch_shared_kv_heads.py):
    tp 6 over KH 4 is refused by name, and tp 16, a multiple of KH 4, by
    the query heads it does not divide."""
    with pytest.raises(ValueError, match="tensor_parallel_size 6 does not divide num_kv_heads 4"):
        LLMEngine(EngineConfig(model=MODEL, tensor_parallel_size=6, **PORT_TP, **SMALL), device="cpu")
    with pytest.raises(ValueError, match="tensor_parallel_size 16 does not divide num_heads 8"):
        LLMEngine(EngineConfig(model=MODEL, tensor_parallel_size=16, **PORT_TP, **SMALL), device="cpu")


# -- refusals -------------------------------------------------------------------


@pytest.mark.parametrize("overrides,match", [
    (dict(model="llama-debug", tensor_parallel_size=3), "does not divide num_kv_heads 2; the JAX engine replicates"),
    (dict(model="mixtral-debug", tensor_parallel_size=2, expert_parallel_size=3, **PORT_TP), "MoE"),
    (dict(model=MODEL, data_parallel_size=2, pipeline_parallel_size=2), "in-engine data parallelism"),
    (dict(model="gemma2-debug", sequence_parallel_size=2, data_parallel_size=2, **PORT_TP),
     "sequence/pipeline parallelism"),
    (dict(model=MODEL, pipeline_parallel_size=2, sequence_parallel_size=2, data_parallel_size=2),
     "pipeline parallelism"),
    (dict(model=MODEL, tensor_parallel_size=2), "tp_backend 'nccl' needs a CUDA device per rank"),
    (dict(model=MODEL, tensor_parallel_size=2, tp_backend="mpi"), "unknown tp_backend"),
    (dict(model=MODEL, tensor_parallel_size=2, tp_backend="gloo", tp_device_ids="0"), "one device index"),
])
def test_unsupported_tp_setups_are_refused_by_name(overrides, match):
    cfg = EngineConfig(**{**SMALL, **overrides})
    with pytest.raises(ValueError, match=match):
        LLMEngine(cfg, device="cpu")


@pytest.mark.parametrize("overrides", [dict(tensor_parallel_size=2), dict(expert_parallel_size=2)],
                         ids=["tp2", "ep2"])
def test_lora_with_tp_or_ep_ranks_is_served_with_rank_shaped_buffers(overrides):
    """Once refused, now served: the config passes check_supported, and a
    rank's runner holds its tp part of every slot buffer (an ep rank the
    whole; tests/test_torch_lora_ranks.py serves both against the JAX
    engine)."""
    check_supported(EngineConfig(model=MODEL, enable_lora=True, **PORT_TP, **overrides))
    tp, ep = overrides.get("tensor_parallel_size", 1), overrides.get("expert_parallel_size", 1)
    layer = rank_runner(t=tp - 1, tp=tp, e=ep - 1, ep=ep).lora["layers"][0]
    assert layer["b_wq"].shape == (3, 16, 256 // tp) and layer["a_wo"].shape == (3, 256 // tp, 16)
    assert layer["a_wq"].shape == (3, 128, 16) and layer["b_w_down"].shape == (3, 16, 128)


def test_nccl_with_two_ranks_on_one_device_is_refused_naming_gloo():
    cuda0 = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="refuses two ranks on one device.*--tp-backend gloo"):
        check_backend("nccl", [cuda0, cuda0])
    check_backend("gloo", [cuda0, cuda0])
    check_backend("nccl", [cuda0, torch.device("cuda", 1)])


# -- splitting weights -------------------------------------------------------------


@pytest.mark.parametrize("family,name", [("llama", "llama-debug"), ("llama", "qwen2-debug"),
                                         ("opt", "opt-debug"), ("gemma2", "gemma2-debug")])
def test_shard_params_joins_back_to_the_whole_tree(family, name):
    jmod, tmod = {"llama": (jllama, tllama), "opt": (jopt, topt), "gemma2": (jgemma, tgemma)}[family]
    whole = params_from_jax(jax.device_get(jmod.init_params(jmod.PRESETS[name], jax.random.key(0))),
                            tmod.PRESETS[name])
    for tp in (2, 4):
        shards = [shard_params(whole, r, tp) for r in range(tp)]
        assert shards[1]["layers.0.wq"].shape[1] == whole["layers.0.wq"].shape[1] // tp
        joined = join_params(shards)
        assert joined.keys() == whole.keys()
        for k, t in whole.items():
            assert joined[k].dtype == t.dtype and torch.equal(joined[k].view(torch.uint8), t.view(torch.uint8)), k


@pytest.mark.parametrize("name", ["llama-debug", "opt-debug", "gemma2-debug"])
def test_seeded_ranks_make_the_tp1_model(name):
    """A tp rank draws each whole tensor and keeps its part: the ranks'
    weights joined are the tp = 1 model's, bit for bit."""
    _, _, whole = load_model(name, seed=3, device="cpu")
    ranks = [dict(load_model(name, seed=3, device="cpu", tp=_rank(r, 2))[2].named_parameters()) for r in range(2)]
    joined = join_params([{k: v.detach() for k, v in r.items()} for r in ranks])
    for k, t in whole.named_parameters():
        assert torch.equal(joined[k], t.detach()), k


def test_a_sliced_read_is_the_slice_of_the_whole_read(tmp_path):
    t = torch.arange(6 * 10, dtype=torch.float32).reshape(6, 10).to(torch.bfloat16)
    save_file(str(tmp_path / "a.safetensors"), {"w": t, "b": torch.arange(8, dtype=torch.int32)})
    d = SafetensorsDir(str(tmp_path))
    for dim, start, n in ((0, 3, 3), (1, 5, 5), (1, 0, 5)):
        assert torch.equal(d.get_slice("w", dim, start, n), d.get("w").narrow(dim, start, n))
    assert torch.equal(d.get_slice("b", 0, 4, 4), torch.arange(4, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        d.get_slice("w", 0, 4, 3)


def test_hf_directory_ranks_read_their_slices(tmp_path):
    """A Qwen2-style directory (q/k/v biases, untied head) read by two ranks
    gives, joined, the model one process reads."""
    cfg = tllama.PRESETS["qwen2-debug"]
    _, _, model = load_model("qwen2-debug", seed=5, device="cpu")
    own = dict(model.named_parameters())
    hf = {"architectures": ["Qwen2ForCausalLM"], "hidden_size": cfg.hidden_size, "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads, "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_layers, "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
          "rms_norm_eps": cfg.rms_norm_eps, "max_position_embeddings": cfg.max_model_len, "head_dim": cfg.head_dim,
          "tie_word_embeddings": False}
    names = _llama_names(dataclasses.replace(cfg, attention_bias=True))
    tensors = {hfname: (own[p].detach().t() if tr else own[p].detach()).contiguous() for p, (hfname, tr) in names.items()}
    save_sharded(str(tmp_path), {k: (tuple(v.shape), v.dtype) for k, v in tensors.items()}, tensors.__getitem__,
                 max_shard_bytes=1 << 18)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    _, _, one = load_from_hf(str(tmp_path), device="cpu")
    ranks = [dict(load_from_hf(str(tmp_path), device="cpu", tp=_rank(r, 2))[2].named_parameters()) for r in range(2)]
    joined = join_params([{k: v.detach() for k, v in r.items()} for r in ranks])
    assert ranks[1]["layers.0.bq"].shape[0] == cfg.num_heads * cfg.head_dim // 2
    for k, t in one.named_parameters():
        assert torch.equal(joined[k], t.detach()), k


# -- HTTP -----------------------------------------------------------------------


def test_http_tp2_server_serves_tp1_text_and_advertises_its_shape():
    """A port server with --tensor-parallel-size 2 (gloo, CPU; seeded
    weights, the same model at every tp) answers the tp 1 server's greedy
    completion; /stats and /metrics give its shape, two shard rows."""
    body = {"prompt": "the sharded engine serves http", "max_tokens": 12, "temperature": 0.0, "ignore_eos": True}
    loop = _Loop()

    async def serve_and_ask(tp):
        cfg = EngineConfig(model=MODEL, host="127.0.0.1", port=free_port(), tensor_parallel_size=tp, **PORT_TP,
                           **SMALL)
        server, runner = await port_server.serve(cfg, device="cpu")
        try:
            base = f"http://127.0.0.1:{cfg.port}"
            async with aiohttp.ClientSession() as s:
                async with s.post(base + "/v1/completions", json=body) as r:
                    assert r.status == 200
                    out = await r.json()
                async with s.get(base + "/stats") as r:
                    stats = await r.json()
                async with s.get(base + "/metrics") as r:
                    metrics = await r.text()
            return (out["choices"][0]["text"], out["usage"]["completion_tokens"]), stats, metrics
        finally:
            await runner.cleanup()
            server.engine.stop()

    try:
        one, stats1, _ = loop.run(serve_and_ask(1))
        two, stats, m = loop.run(serve_and_ask(2))
    finally:
        loop.close()
    assert two == one and two[1] == 12
    assert stats1["tensor_parallel"] == 1
    assert stats["tensor_parallel"] == 2 and stats["mesh_devices"] == 2
    assert re.search(r"vllm:tensor_parallel_degree\{[^}]*\} 2(\.0)?\b", m)
    rows = re.findall(r'vllm:kv_pool_shard_bytes\{[^}]*device="([^"]+)"[^}]*\} (\d+)', m)
    assert [d for d, _ in rows] == ["cpu:0/tp0", "cpu:0/tp1"] and len({v for _, v in rows}) == 1
    assert EngineStats.from_scrape(m).tensor_parallel == 2
    assert PortEngineStats.from_scrape(m).tensor_parallel == 2  # the port's router reads it alike


_LEADER = """
import asyncio, sys
sys.path.insert(0, {root!r})
from production_stack_tpu_torch.engine.api_server import serve
from production_stack_tpu_torch.engine.config import EngineConfig

async def main():
    cfg = EngineConfig(model={model!r}, host="127.0.0.1", port={port}, tensor_parallel_size=2, tp_backend="gloo",
                       **{small!r})
    server, runner = await serve(cfg, device="cpu")
    print("FOLLOWERS", *(p.pid for p in server.engine._tp.procs), flush=True)
    await asyncio.Event().wait()

asyncio.run(main())
"""


def test_a_follower_killed_mid_serve_ends_the_leader():
    """The leader of a tp 2 server exits (13) when its follower is killed
    while a request streams, rather than hang or serve on."""
    port = free_port()
    leader = subprocess.Popen(
        [sys.executable, "-c", _LEADER.format(root=ROOT, model=MODEL, port=port, small=SMALL)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    pids = []
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = leader.stdout.readline()
            if line.startswith("FOLLOWERS"):
                pids = [int(x) for x in line.split()[1:]]
                break
            assert line or leader.poll() is None, "the leader died while starting"
        assert len(pids) == 1

        async def stream():
            body = {"prompt": "x" * 60, "max_tokens": 100, "temperature": 0.0, "ignore_eos": True, "stream": True}
            try:
                async with aiohttp.ClientSession() as s:
                    async with s.post(f"http://127.0.0.1:{port}/v1/completions", json=body) as r:
                        async for _ in r.content:
                            if pids:
                                os.kill(pids[0], signal.SIGKILL)
                                pids.clear()
            except aiohttp.ClientError:
                pass

        asyncio.run(asyncio.wait_for(stream(), 60))
        assert leader.wait(timeout=60) == 13
    finally:
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if leader.poll() is None:
            leader.kill()
        leader.wait(10)
        leader.stdout.close()


# -- the lockstep machinery (tests/test_multihost.py, against the port's copy) ---

SECRET = b"test-step-sync-secret"


class FakeRunner:
    def __init__(self):
        self.calls = []

    def step(self, *a, **kw):
        self.calls.append(("step", a, kw))
        return "local-result"

    def step_multi(self, *a, **kw):
        self.calls.append(("step_multi", a, kw))
        return "multi"

    def reset_kv(self):
        self.calls.append(("reset_kv", (), {}))

    def get_pages(self, pids):  # replicated (a gather over the ranks), local return
        self.calls.append(("get_pages", (pids,), {}))
        return "pages"

    def kv_pool_shard_layout(self):  # NOT replicated (shapes only)
        self.calls.append(("kv_pool_shard_layout", (), {}))
        return "layout"


def test_broadcast_and_follow():
    """Every replicated call reaches the follower in order; non-replicated
    calls stay local; local return values pass through."""
    port = free_port()
    leader_runner, follower_runner = FakeRunner(), FakeRunner()
    done = threading.Event()

    def follower():
        follower_loop(follower_runner, "127.0.0.1", port, timeout=30, secret=SECRET)
        done.set()

    t = threading.Thread(target=lambda: time.sleep(0.2) or follower(), daemon=True)
    t.start()
    bc = StepBroadcaster(listen_socket("127.0.0.1", port, 1), 1, timeout=30, secret=SECRET)
    wrapped = BroadcastingRunner(leader_runner, bc)
    arr = np.arange(6).reshape(2, 3)
    assert wrapped.step(arr, k=2) == "local-result"
    assert wrapped.step_multi("x") == "multi"
    wrapped.reset_kv()
    assert wrapped.get_pages([7]) == "pages"
    assert wrapped.kv_pool_shard_layout() == "layout"
    bc.close()
    assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    assert [c[0] for c in follower_runner.calls] == ["step", "step_multi", "reset_kv", "get_pages"]
    np.testing.assert_array_equal(follower_runner.calls[0][1][0], arr)
    assert follower_runner.calls[0][2] == {"k": 2}
    assert [c[0] for c in leader_runner.calls] == [
        "step", "step_multi", "reset_kv", "get_pages", "kv_pool_shard_layout",
    ]


def test_a_follower_that_dies_before_connecting_ends_the_wait():
    def alive():
        raise RuntimeError("tp follower(s) exited before joining the step stream")

    with pytest.raises(RuntimeError, match="exited before joining"):
        StepBroadcaster(listen_socket("127.0.0.1", 0, 1), 1, timeout=30, secret=SECRET, alive=alive)


# runner methods that run on the leader alone, and why
LOCAL_ONLY = {
    "kv_pool_shard_layout": "reads the pools' shapes, from the scrape thread",
    # disaggregated prefill's device path (CUDA IPC), refused with tp or dp ranks
    **{name: "the device KV path is refused with tp or dp ranks" for name in (
        "kv_endpoint_start", "kv_offer_page", "kv_pull_page", "kv_restore_page", "kv_unstage_page",
        "set_page_device")},
}


def test_replicated_method_list_matches_runner():
    """REPLICATED names exactly the runner's methods that change device
    state or run a collective: every public method but LOCAL_ONLY."""
    public = {n for n, v in vars(ModelRunner).items() if callable(v) and not n.startswith("_")}
    assert set(REPLICATED) == public - set(LOCAL_ONLY)
    assert set(LOCAL_ONLY) <= public


def test_framed_roundtrip_authenticated():
    a, b = socket.socketpair()
    msg = _pack_call("step", (np.zeros(4),), {})
    _send_msg(a, msg, SECRET, 0)
    assert _recv_msg(b, SECRET, 0) == msg
    a.close()
    assert _recv_msg(b, SECRET, 1) is None  # closed peer -> clean shutdown signal
    b.close()


def test_frame_rejects_wrong_secret_and_replay():
    a, b = socket.socketpair()
    msg = _pack_call("step", (), {})
    _send_msg(a, msg, SECRET, 0)
    with pytest.raises(RuntimeError, match="authentication"):
        _recv_msg(b, b"other-secret", 0)
    _send_msg(a, msg, SECRET, 0)  # replay: the receiver expects the next sequence number
    with pytest.raises(RuntimeError, match="authentication"):
        _recv_msg(b, SECRET, 1)
    a.close()
    b.close()


def test_codec_roundtrip_no_pickle():
    inp = StepInput(
        input_ids=np.arange(6, dtype=np.int32).reshape(2, 3), positions=np.zeros((2, 3), np.int32),
        page_table=np.arange(4, dtype=np.int32).reshape(2, 2), kv_lens=np.array([3, 3], np.int32),
        temperature=np.array([0.7, 0.0], np.float32), top_k=np.array([40, 0], np.int32),
        top_p=np.array([0.9, 1.0], np.float32),
    )
    method, args, kwargs = _unpack_call(_pack_call("step_multi", (inp, 4), {"want_logprobs": False, "tag": "x"}))
    assert method == "step_multi"
    got, k = args
    assert k == 4 and kwargs == {"want_logprobs": False, "tag": "x"}
    np.testing.assert_array_equal(got.input_ids, inp.input_ids)
    assert got.input_ids.dtype == np.int32
    np.testing.assert_array_equal(got.temperature, inp.temperature)
    assert got.lora_ids is None and got.kv_limits is None
    with pytest.raises(TypeError):
        _pack_call("step", (object(),), {})
    with pytest.raises(TypeError):  # a tensor crosses as numpy or not at all
        _pack_call("step", (torch.zeros(2),), {})
    assert not re.search(r"^\s*(import|from)\s+pickle\b", open(dist_mod.__file__).read(), re.M)


def test_codec_roundtrips_bfloat16_pages():
    page = (np.arange(64, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16).reshape(2, 8, 2, 2)
    _, args, _ = _unpack_call(_pack_call("set_pages", ([3], [page], [page * 2]), {}))
    pids, (k,), (v,) = args
    assert pids == [3] and k.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(k, page)
    np.testing.assert_array_equal(v, page * 2)
    s = _unpack_call(_pack_call("x", (ml_dtypes.bfloat16(1.5),), {}))[1][0]
    assert s == ml_dtypes.bfloat16(1.5) and s.dtype == ml_dtypes.bfloat16
    # a bf16 page from a port pool crosses bit for bit
    t = tensor_from_numpy(page)
    assert torch.equal(tensor_from_numpy(_unpack_call(_pack_call("x", (page,), {}))[1][0]).view(torch.int16),
                       t.view(torch.int16))


def test_check_supported_takes_tp_with_its_knobs():
    check_supported(EngineConfig(tensor_parallel_size=4, tp_backend="gloo", tp_device_ids="0,0,1,1"))
    check_supported(EngineConfig(tensor_parallel_size=2))
