"""In-engine data parallelism of the port (parallel/dp.py, the runner's dp
rows and replica sync, dp x tp rank processes) against the JAX package's
dp engines on its virtual 8-device CPU mesh (tests/test_model.py,
tests/test_pallas_attention.py TestShardedKernel, tests/test_parallel.py).

A port engine at (dp, tp) runs dp x tp processes over gloo on the CPU: the
leader in the test process, the followers spawned by it. Its weights are
the JAX engine's (``params_from_jax``), so on the f32 twin greedy tokens
must be identical to the JAX engine's at the same (dp, tp), and f32 logits
within 2e-5. The JAX side runs its sharded Pallas decode kernel in
interpret mode with fp pools and its XLA path with int8 ones.
"""

import asyncio
import dataclasses
import hashlib
import re
import time

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.kvoffload import serde as jserde
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.devicemon import DeviceMonitor
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.runner import RANK_STATS, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvoffload.serde import get_serde
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel import dp as dpmod
from production_stack_tpu_torch.parallel.group import device_labels, parse_device_ids
from test_torch_lora_ranks import rank_runner
from test_torch_tp import F32, MODEL, PORT_TP, SMALL, spec_then_chain

MESHES = [(2, 1), (2, 2)]  # (dp, tp)


def _gen_all(engine, prompts, sp=SamplingParams, n=8):
    """Greedy tokens of ``prompts`` submitted together, so the rows share
    batches (and, at dp 2, both dp groups hold real rows)."""
    async def one(i, ids):
        out = []
        async for o in engine.generate(f"r{i}-{time.monotonic_ns()}", prompt_token_ids=ids,
                                       params=sp(max_tokens=n, temperature=0.0, ignore_eos=True)):
            out += o.token_ids
        return out

    async def run():
        return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))

    return asyncio.run(run())


def _prompts(vocab):
    """Three prompts of different lengths (one over several chunks)."""
    rng = np.random.RandomState(12)
    return [[int(x) for x in rng.randint(1, vocab, n)] for n in (9, 27, 70)]


def _prefill_inputs(vocab):
    """A four-row prefill chunk on fresh pages, two rows per dp rank at dp
    2; rows 1 and 3 ragged."""
    rng = np.random.RandomState(5)
    B, T = 4, 16
    ids = rng.randint(0, vocab, (B, T)).astype(np.int32)
    pos = np.full((B, T), -1, np.int32)
    n = [16, 11, 16, 5]
    for b in range(B):
        pos[b, : n[b]] = np.arange(n[b])
    common = dict(input_ids=ids, positions=pos, page_table=np.arange(1, 1 + 2 * B, dtype=np.int32).reshape(B, 2),
                  kv_lens=np.array(n, np.int32), temperature=np.zeros(B, np.float32),
                  top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32))
    return JaxStepInput(**common), StepInput(**common)


def _port(dp, tp, jparams, **kw):
    return LLMEngine(EngineConfig(model=MODEL, data_parallel_size=dp, tensor_parallel_size=tp, **PORT_TP, **SMALL,
                                  **kw), device="cpu", params=params_from_jax(jparams, tllama.PRESETS[MODEL]))


def _leader_pools(runner, pids, quant):
    """The leader's replica of pages ``pids``, every KV head (get_pages
    gathers them over its tp group): [L, N, page, KH, D] k and v, and an
    int8 pool's [L, N, KH] k and v scales."""
    read = runner.get_pages_quant if quant else runner.get_pages
    return [np.stack(x, axis=1) for x in read(pids)]


def _shard(a, t, tp):
    """KV-head shard ``t`` of ``tp`` of a [L, N, page, KH, D] page or an
    [L, N, KH] scale array: what rank (d, t) holds."""
    axis = 3 if a.ndim == 5 else 2
    n = a.shape[axis] // tp
    return np.ascontiguousarray(np.take(a, range(t * n, (t + 1) * n), axis=axis))


class _Recorder:
    """The engine's runner, with the batches it is handed recorded."""

    def __init__(self, runner):
        self._runner = runner
        self.inputs = []

    def __getattr__(self, name):
        attr = getattr(self._runner, name)
        if name not in ("step", "step_multi"):
            return attr

        def call(inp, *a, **kw):
            self.inputs.append((name, inp, a))
            return attr(inp, *a, **kw)

        return call


@pytest.fixture(scope="module", params=["auto", "int8"])
def dp_runs(request, eight_devices):
    """The f32 llama twin at (dp, tp) = (2, 1) and (2, 2) in both packages
    (fp or int8 pools), one pair at a time (a process leads one engine's
    ranks): each pair's four-row prefill logits, greedy tokens of three
    concurrent prompts, every rank's pools read back and digested, a
    registered page as both engines read it, a JAX blob restored, the
    engine's shape as stats, rank_stats and /metrics give it; at (2, 1) one
    lone request's batch and the pages it changed."""
    kv = request.param
    quant = kv == "int8"
    prompts = _prompts(512)
    jinp, tinp = _prefill_inputs(512)
    out = {"kv": kv}
    for dp, tp in MESHES:
        jeng = JaxEngine(JaxEngineConfig(model=MODEL, data_parallel_size=dp, tensor_parallel_size=tp, **SMALL,
                                         attn_impl="auto" if quant else "pallas_interpret", kv_cache_dtype=kv))
        peng = None
        res = out[(dp, tp)] = {}
        try:
            peng = _port(dp, tp, jax.device_get(jeng.runner.params), kv_cache_dtype=kv)
            res["logits"] = (peng.runner.step(tinp)[1].numpy(), np.asarray(jeng.runner.step(jinp)[1]))
            jeng.runner.reset_kv()
            peng.runner.reset_kv()
            res["encode"] = (peng.runner.encode(tinp.input_ids, tinp.positions).numpy(),
                             np.asarray(jeng.runner.encode(jinp.input_ids, jinp.positions)))
            jeng.start()
            peng.start()
            res["jax"] = _gen_all(jeng, prompts, JaxSamplingParams)
            res["port"] = _gen_all(peng, prompts)
            all_pages = list(range(peng.kv.num_pages))
            res["digest"] = peng.runner.replica_digest()
            res["replicas"] = _leader_pools(peng.runner, all_pages, quant)
            h = next(iter(jeng.kv.hash_to_page))
            jget = jeng.runner.get_pages_quant if quant else jeng.runner.get_pages
            get = peng.runner.get_pages_quant if quant else peng.runner.get_pages
            jpage = [np.asarray(x[0]) for x in jget([jeng.kv.hash_to_page[h]])]
            res["page"] = (jpage, [x[0] for x in get([peng.kv.hash_to_page[h]])])
            # the JAX dp engine's page as a blob of the JAX serde, restored
            # into the port's pools through its serde (page 5, every replica)
            if quant:
                k, v, sk, sv = jpage
                qk, sk, qv, sv = get_serde("int8page").deserialize_quant(
                    jserde.get_serde("int8page").serialize_quant(k, sk, v, sv))
                peng.runner.set_pages_quant([5], [qk], [qv], [sk], [sv])
                res["blob"] = (qk, qv, sk, sv)
            else:
                page = get_serde("naive").deserialize(jserde.get_serde("naive").serialize(*jpage))
                peng.runner.set_pages([5], *([x] for x in page))
                res["blob"] = page
            res["restored"] = (peng.runner.replica_digest(), _leader_pools(peng.runner, [5], quant))
            s = peng.stats()
            res["shape"] = (s["mesh_devices"], s["tensor_parallel"], peng.runner.rank_stats(),
                            DeviceMonitor(peng).metrics_lines(MODEL))
            if tp == 1:
                # one request alone: a batch of 2 (the scheduler's
                # batch_multiple), whose pad row writes nothing
                def fresh():
                    peng.runner.reset_kv()
                    peng.kv = peng.scheduler.kv = type(peng.kv)(peng.kv.num_pages, peng.kv.page_size)

                peng._run_on_device_thread(fresh)
                before = _leader_pools(peng.runner, all_pages, quant)
                rec = peng.runner = _Recorder(peng.runner)
                res["lone"] = _gen_all(peng, prompts[1:2])
                res["lone_batches"] = rec.inputs
                res["lone_pools"] = (before, _leader_pools(rec, all_pages, quant), rec.replica_digest())
        finally:
            jeng.stop()
            if peng is not None:
                peng.stop()
    return out


@pytest.mark.parametrize("dp,tp", MESHES)
def test_greedy_tokens_match_the_jax_dp_engine(dp_runs, dp, tp):
    """Three concurrent prompts of 9, 27 and 70 tokens (fp and int8 pools):
    the port's greedy tokens are the JAX engine's at the same (dp, tp)."""
    res = dp_runs[(dp, tp)]
    assert res["port"] == res["jax"]
    assert all(len(ids) == 8 for ids in res["port"])


@pytest.mark.parametrize("dp,tp", MESHES)
def test_prefill_logits_match_the_jax_runner_at_dp2(dp_runs, dp, tp):
    """A four-row f32 prefill chunk on fresh pages (two rows per dp rank,
    two of them ragged), gathered over dp: within 2e-5 of the JAX runner's
    on the same mesh, with fp and with int8 pools (a chunk attends to its
    own K/V in f32, whatever the pool keeps)."""
    tl, jl = dp_runs[(dp, tp)]["logits"]
    assert tl.shape == jl.shape == (4, 512)
    np.testing.assert_allclose(tl, jl, **F32)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_encode_rows_match_the_jax_runner_at_dp2(dp_runs, dp, tp):
    """The pooled embeddings of the four rows (two per dp rank, two ragged),
    gathered over dp: within 2e-5 of the JAX runner's on the same mesh."""
    te, je = dp_runs[(dp, tp)]["encode"]
    assert te.shape == je.shape == (4, tllama.PRESETS[MODEL].hidden_size)
    np.testing.assert_allclose(te, je, **F32)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_every_dp_replica_holds_the_same_bytes(dp_runs, dp, tp):
    """After the serve, the ranks of each tp column (the dp replicas of one
    KV-head shard) hold byte-identical pools and scales: their digests
    agree, and each is the sha256 of that shard of every page read back
    directly from the leader's replica."""
    res = dp_runs[(dp, tp)]
    digests = [bytes(d) for d in res["digest"]]
    assert len(digests) == dp * tp
    for t in range(tp):
        assert len({digests[d * tp + t] for d in range(dp)}) == 1, t
    if tp > 1:
        assert digests[0] != digests[1]  # two shards, two contents
    arrays = res["replicas"]
    assert len(arrays) == (4 if dp_runs["kv"] == "int8" else 2)
    for r in range(dp * tp):
        h = hashlib.sha256()
        for a in arrays:
            shard = _shard(a, r % tp, tp)
            for layer in range(shard.shape[0]):
                h.update(shard[layer].view(np.uint8))
        assert h.digest() == digests[r], r
    assert any(a.any() for a in arrays[:2])  # the serve wrote pages


@pytest.mark.parametrize("dp,tp", MESHES)
def test_a_registered_page_matches_the_jax_dp_engine(dp_runs, dp, tp):
    """The same prompt's registered page, read from both engines (every KV
    head): f32 within 2e-5, int8 codes within one step and scales within
    1e-5 (each framework's own f32 K/V matmuls)."""
    jpage, tpage = dp_runs[(dp, tp)]["page"]
    if dp_runs["kv"] == "int8":
        for got, want in zip(tpage[:2], jpage[:2]):
            assert got.dtype == np.int8 and np.abs(got.astype(int) - want.astype(int)).max() <= 1
        for got, want in zip(tpage[2:], jpage[2:]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        for got, want in zip(tpage, jpage):
            np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_a_jax_blob_restores_into_every_replica(dp_runs, dp, tp):
    """A page blob of the JAX dp engine, written through set_pages(_quant),
    lands bit for bit in every dp replica: the leader's replica reads the
    blob back, and every replica's digest equals its tp column's (rank
    (d, t) holds the blob's t-th slice of KV heads)."""
    res = dp_runs[(dp, tp)]
    digests, restored = res["restored"]
    blob = res["blob"]  # k, v (and k, v scales): get_pages(_quant)'s order
    assert len(restored) == len(blob)
    for want, got in zip(blob, restored):
        assert got[:, 0].tobytes() == np.ascontiguousarray(want).tobytes()
    for t in range(tp):
        assert len({bytes(digests[d * tp + t]) for d in range(dp)}) == 1, t


def test_a_lone_request_runs_in_a_batch_of_dp_rows_whose_pad_writes_nothing(dp_runs):
    """One request at dp 2: every step it runs in has 2 rows (the pad row
    positions -1); the only pages that change, in either replica, are the
    ones the request's row wrote."""
    res = dp_runs[(2, 1)]
    assert res["lone"] == [res["port"][1]]  # its tokens beside the others' are its tokens alone
    batches = res["lone_batches"]
    assert batches and all(len(inp.kv_lens) == 2 for _, inp, _ in batches)
    written = set()
    for kind, inp, a in batches:
        assert (np.asarray(inp.positions)[1] == -1).all()
        pos = dpmod.burst_positions(inp.positions, inp.kv_lens, inp.kv_limits, a[0]) if kind == "step_multi" \
            else np.asarray(inp.positions)
        written |= set(dpmod.written_pages(inp.page_table[:1], pos[:1], SMALL["page_size"]).tolist())
    before, after, digests = res["lone_pools"]
    for b, a in zip(before, after):
        changed = {p for p in range(b.shape[1]) if b[:, p].tobytes() != a[:, p].tobytes()}
        assert changed <= written, sorted(changed - written)
    assert bytes(digests[0]) == bytes(digests[1])  # the pad row's replica holds the same bytes
    k_before, k_after = before[0], after[0]
    assert {p for p in range(k_before.shape[1]) if k_before[:, p].tobytes() != k_after[:, p].tobytes()} == written


@pytest.mark.parametrize("dp,tp", MESHES)
def test_stats_rank_stats_and_shard_rows_count_every_rank(dp_runs, dp, tp):
    mesh, tp_stat, stats, metrics = dp_runs[(dp, tp)]["shape"]
    assert mesh == dp * tp and tp_stat == tp
    assert stats.shape == (dp * tp, len(RANK_STATS))
    steps = stats[:, RANK_STATS.index("steps")]
    assert (steps > 0).all() and len(set(steps)) == 1  # every rank replayed every step
    assert (stats[:, RANK_STATS.index("decode_attention_ref")] > 0).all()
    assert (stats[:, RANK_STATS.index("collective_calls")] > 0).all()
    rows = re.findall(r'vllm:kv_pool_shard_bytes\{[^}]*device="([^"]+)"[^}]*\} (\d+)', "\n".join(metrics))
    assert [d for d, _ in rows] == [f"cpu:0/dp{r // tp}tp{r % tp}" for r in range(dp * tp)]
    assert len({v for _, v in rows}) == 1


def test_penalties_bias_logprobs_and_sleep_at_dp2_match_dp1():
    """Rows with penalties, a logit bias, min_tokens and logprobs beside
    plain greedy rows (every row-leading input sliced per dp group): a dp 2
    engine gives dp 1's tokens and, within 2e-5, its logprobs; after sleep
    level 2 and a wake (weights and pools on every rank) it gives the same
    tokens again, and its replicas agree."""
    prompts = _prompts(512)
    params = [
        SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True, logprobs=2, presence_penalty=0.5,
                       frequency_penalty=0.3, repetition_penalty=1.2),
        SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True, logit_bias={7: 5.0, 11: -100.0},
                       min_tokens=4),
        SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True, logprobs=1),
    ]

    def run(engine):
        async def one(i):
            ids, lps = [], []
            async for o in engine.generate(f"p{i}-{time.monotonic_ns()}", prompt_token_ids=prompts[i],
                                           params=params[i]):
                ids += o.token_ids
                lps += [e["logprob"] for e in o.logprobs or []]
            return ids, lps

        async def go():
            return await asyncio.gather(*(one(i) for i in range(len(prompts))))

        return asyncio.run(go())

    out = {}
    for dp in (1, 2):
        engine = LLMEngine(EngineConfig(model=MODEL, data_parallel_size=dp, enable_sleep_mode=True, **PORT_TP,
                                        **SMALL), device="cpu")
        engine.start()
        try:
            out[dp] = run(engine)
            if dp == 2:
                engine.sleep(2)
                engine.wake_up()
                again = run(engine)
                digests = engine.runner.replica_digest()
        finally:
            engine.stop()
    for (ids1, lp1), (ids2, lp2) in zip(out[1], out[2]):
        assert ids2 == ids1 and len(ids1) == 8
        np.testing.assert_allclose(lp2, lp1, **F32)
    assert 11 not in out[2][1][0] and len(out[1][0][1]) == 8
    assert [ids for ids, _ in again] == [ids for ids, _ in out[2]]
    assert bytes(digests[0]) == bytes(digests[1])


def test_spec_and_chained_decode_at_dp2_match_dp1():
    """step_spec and a chain at dp 2 on the f32 twin, two greedy rows and two
    sampled ones (one of each per dp group: every rank draws the whole
    batch's B x T verify noise and takes its rows'): dp 1's tokens, and
    after the spec both dp replicas hold the same pools (each group's
    written pages synced from the final lengths)."""
    out = {}
    for dp in (1, 2):
        engine = LLMEngine(EngineConfig(model=MODEL, data_parallel_size=dp, **PORT_TP, **SMALL), device="cpu")
        try:
            out[dp] = spec_then_chain(engine, [0.0, 1.0, 0.0, 1.0])
        finally:
            engine.stop()
    np.testing.assert_array_equal(out[2][0], out[1][0])
    np.testing.assert_array_equal(out[2][1], out[1][1])
    assert (out[1][0] >= 0).sum() > 4 * 3
    digests = out[2][2]
    assert digests.shape == (2, 32) and bytes(digests[0]) == bytes(digests[1])


def test_spec_positions_cover_what_step_spec_writes():
    """dp.spec_positions lists, per row that emitted, kv_lens - 1 up to
    min(final lens - 1 + k, kv_limits - 1), which covers every position a
    round wrote; a pad row and a row that ran no round list nothing."""
    B, T, k = 3, 9, 3
    pos = np.array([[T], [T], [-1]], np.int32)
    lens0 = np.array([T + 1, T + 1, 0], np.int32)
    limits = np.array([40, T + 1 + k, 0], np.int32)
    got = dpmod.spec_positions(pos, lens0, limits, np.array([T + 9, T + 2, 0]), k)
    assert got[0][got[0] >= 0].tolist() == list(range(T, T + 9 + k))
    assert got[1][got[1] >= 0].tolist() == list(range(T, T + 1 + k))  # capped by its limit
    assert (got[2] == -1).all()
    # a row that could not run a round (lens + k > limits) emitted nothing
    assert (dpmod.spec_positions(pos[:1], lens0[:1], np.array([T + 2]), lens0[:1], k) == -1).all()


def test_sampled_rows_at_dp2_draw_dp1s_noise():
    """At temperature 1 every dp rank draws the whole batch's race noise and
    takes its rows' (ops/sampling.sample's ``batch_rows``): four rows of one
    prompt, a prefill chunk then a 4-step burst, give dp 1's tokens at dp 2,
    and rows 0 and 2 (local row 0 of each dp group) do not share a draw."""
    B, T, maxp = 4, 16, 3
    prompt = np.random.RandomState(3).randint(1, 512, T).astype(np.int32)
    common = dict(page_table=(1 + np.arange(B * maxp, dtype=np.int32)).reshape(B, maxp),
                  temperature=np.ones(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32))
    chunk = StepInput(input_ids=np.tile(prompt, (B, 1)), positions=np.tile(np.arange(T, dtype=np.int32), (B, 1)),
                      kv_lens=np.full(B, T, np.int32), **common)
    out = {}
    for dp in (1, 2):
        engine = LLMEngine(EngineConfig(model=MODEL, data_parallel_size=dp, **PORT_TP, **SMALL), device="cpu")
        try:
            first = engine.runner.step(chunk, want_logits=False)[0].numpy()
            burst = StepInput(input_ids=first[:, None].astype(np.int32), positions=np.full((B, 1), T, np.int32),
                              kv_lens=np.full(B, T + 1, np.int32), **common)
            out[dp] = np.concatenate([first[:, None], engine.runner.step_multi(burst, 4).numpy()], axis=1)
        finally:
            engine.stop()
    assert out[2].shape == (B, 5)
    assert out[2].tolist() == out[1].tolist()
    assert out[2][0].tolist() != out[2][2].tolist() and out[2][1].tolist() != out[2][3].tolist()


# -- refusals and the layout ------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2])
def test_lora_with_dp_ranks_is_served_with_replicated_buffers(tp):
    """Once refused, now served: the config passes check_supported, and
    each dp replica's rank holds its tp place's part of every slot buffer,
    the same on both replicas (tests/test_torch_lora_ranks.py serves dp 2
    and dp 2 x tp 2 against the JAX engine)."""
    check_supported(EngineConfig(model=MODEL, data_parallel_size=2, tensor_parallel_size=tp, enable_lora=True,
                                 **PORT_TP))
    bufs = [rank_runner(d=d, dp=2, t=tp - 1, tp=tp).lora for d in range(2)]
    for lora in bufs:
        assert len(lora["layers"]) == 2
        assert lora["layers"][1]["b_w_up"].shape == (3, 16, 256 // tp)
        assert lora["layers"][1]["a_w_down"].shape == (3, 256 // tp, 16)
    assert all(bufs[0]["layers"][0][k].shape == bufs[1]["layers"][0][k].shape for k in bufs[0]["layers"][0])


@pytest.mark.parametrize("overrides,match", [
    (dict(data_parallel_size=0), "data_parallel_size must be >= 1"),
    (dict(data_parallel_size=2, pipeline_parallel_size=2), "does not compose with in-engine data parallelism"),
    (dict(model="mixtral-debug", data_parallel_size=2, expert_parallel_size=3, **PORT_TP),
     "expert_parallel_size 3 does not divide num_experts 4"),
    (dict(data_parallel_size=2, tensor_parallel_size=2, tp_device_ids="0,0", **PORT_TP),
     "one device index >= 0 for each of the engine's 4 ranks"),
    (dict(data_parallel_size=2), "tp_backend 'nccl' needs a CUDA device per rank"),
])
def test_unsupported_dp_setups_are_refused_by_name(overrides, match):
    cfg = EngineConfig(**{"model": MODEL, **SMALL, **overrides})
    with pytest.raises(ValueError, match=match):
        LLMEngine(cfg, device="cpu")


def test_check_supported_takes_dp_with_its_knobs():
    check_supported(EngineConfig(data_parallel_size=2, tensor_parallel_size=2, tp_backend="gloo",
                                 tp_device_ids="0,0,0,0"))
    check_supported(EngineConfig(data_parallel_size=4))
    assert parse_device_ids("0,0,1,1", 4) == [0, 0, 1, 1]


def test_labels_name_each_rank_by_its_place():
    cpu = torch.device("cpu")
    assert device_labels([cpu]) == ["cpu:0"]
    assert device_labels([cpu] * 2) == ["cpu:0/tp0", "cpu:0/tp1"]
    assert device_labels([cpu] * 2, dp=2) == ["cpu:0/dp0tp0", "cpu:0/dp1tp0"]
    assert device_labels([torch.device("cuda", i) for i in (0, 0, 1, 1)], dp=2) == [
        "cuda:0/dp0tp0", "cuda:0/dp0tp1", "cuda:1/dp1tp0", "cuda:1/dp1tp1"]


def _grp(rank, size):
    return dataclasses.make_dataclass("G", ["rank", "size"])(rank, size)


def test_row_slice_takes_contiguous_rows_and_refuses_a_ragged_split():
    x = np.arange(12).reshape(6, 2)
    assert dpmod.row_slice(x, _grp(1, 2)).tolist() == x[3:].tolist()
    assert dpmod.row_slice(x, None) is x and dpmod.row_slice(None, _grp(0, 2)) is None
    with pytest.raises(ValueError, match="a step of 6 rows does not split over 4 dp ranks"):
        dpmod.row_slice(x, _grp(0, 4))


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "burst"])
def test_the_listed_pages_are_the_pages_a_step_writes(kind, kv):
    """The pages the replica sync copies are those the runner's call
    changes, no more and no fewer: a ragged prefill chunk with a padded
    row, a single decode token, and a burst whose rows stop at their
    limits (one across a page boundary, one at once, a padded one)."""
    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.engine.runner import ModelRunner

    _, _, model = load_model(MODEL, seed=1, device="cpu")
    model.cfg = dataclasses.replace(model.cfg, kv_cache_dtype=kv)
    page, B, maxp = 4, 4, 6
    runner = ModelRunner(model, num_pages=B * maxp + 1, page_size=page, device="cpu")
    rng = np.random.RandomState(9)
    pt = (1 + np.arange(B * maxp, dtype=np.int32)).reshape(B, maxp)
    if kind == "prefill":
        T = 7
        pos = np.full((B, T), -1, np.int32)
        for b, (c, n) in enumerate([(0, 7), (3, 5), (0, 0), (9, 2)]):
            pos[b, :n] = np.arange(c, c + n)
        lens, limits, k = pos.max(axis=1) + 1, None, 1
    else:
        pos = np.array([[5], [3], [-1], [10]], np.int32)
        lens = np.where(pos[:, 0] >= 0, pos[:, 0] + 1, 0).astype(np.int32)
        limits, k = np.array([100, 5, 0, 11], np.int32), (1 if kind == "decode" else 6)
    inp = StepInput(input_ids=rng.randint(1, 500, pos.shape).astype(np.int32), positions=pos, page_table=pt,
                    kv_lens=lens, temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32),
                    top_p=np.ones(B, np.float32), kv_limits=limits)
    before = [t.clone() for t in runner._pools()]
    if kind == "burst":
        runner.step_multi(inp, k)
        listed = dpmod.burst_positions(pos, lens, limits, k)
    else:
        runner.step(inp)
        listed = pos
    changed = {p for p in range(runner.num_pages)
               if any(not torch.equal(b[:, p], a[:, p]) for b, a in zip(before, runner._pools()))}
    want = set(dpmod.written_pages(pt, listed, page).tolist())
    assert changed == want
    if kind == "burst":  # row 1 crossed into its second page, row 3 stopped at once
        assert {pt[1, 0], pt[1, 1], pt[3, 2]} <= want and pt[3, 3] not in want


def test_burst_positions_follow_the_runner_limits():
    """A burst row from p0 writes while its length stays under its limit;
    a row at -1 writes nothing."""
    pos = np.array([[7], [3], [-1], [10]], np.int32)
    lens = pos[:, 0] + 1
    got = dpmod.burst_positions(pos, lens, np.array([100, 5, 0, 11], np.int32), 4)
    assert got.tolist() == [[7, 8, 9, 10], [3, 4, -1, -1], [-1] * 4, [10, -1, -1, -1]]
    assert dpmod.burst_positions(pos, lens, None, 2)[1].tolist() == [3, 4]
    pt = np.array([[4, 5, 6], [7, 8, 9], [1, 2, 3], [10, 11, 12]], np.int32)
    assert dpmod.group_pages(pt, got, 4, 2)[0].tolist() == [5, 6, 7, 8]
    assert dpmod.group_pages(pt, got, 4, 2)[1].tolist() == [12]
