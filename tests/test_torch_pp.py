"""Pipeline-parallel serving of the port (parallel/pipeline.py, the stage
group of parallel/group.py, the llama forward's microbatches, the runner's
stage pools) against the JAX package on its virtual 8-device CPU mesh
(tests/test_parallel_serving.py TestPipelineParallelServing).

- The kernel mapping: the JAX ``llama.forward`` with
  ``attn_impl="pallas_interpret"`` on a pp 2 and a pp 2 x tp 2 mesh runs
  ``ragged_paged_attention_decode_sharded`` inside
  ``serving_layer_pipeline`` at T = 1, one microbatch's rows on a stage's
  pools; the port's forward across gloo rank processes (a port engine's
  runner, the JAX weights carried by ``params_from_jax``) on the same
  random pools gives its logits within 2e-5 and the pages it wrote within
  2e-5, every other slot byte for byte as it was. A prefill chunk the
  same way (the JAX pipeline's XLA attention; the port's prefill kernel's
  plain version with its fused write).
- Engines on ``llama-debug-4kv-f32`` at pp 2 and pp 2 x tp 2, shaped like
  the JAX tests' ``_cfg``: three concurrent prompts (one of three prefill
  chunks) give the JAX engine's greedy ids at the same mesh; the pool
  layout and rank stats count the stages; pp 2 with ``decode_pipeline=2``
  and a CPU tier gives pp 1's ids, and a prompt whose pages were spilled
  and restored repeats its uncached ids.
- Units: ``stage_range`` and ``microbatches`` against the JAX pipeline's own
  sharding and microbatch shapes; a stage's parameters bit for bit the JAX
  tree's layer slices (and its tp part); seeded stages make the pp 1
  model; a page read and written back at pp 2 byte for byte.
- An HTTP pp 2 server (its leader a subprocess) answers, reports
  ``mesh_devices`` 2 and one pool row a stage on ``/metrics``, and exits
  13 when its follower stage is killed mid-stream.
- The refusals: in the JAX package's words (pp that does not divide the
  layers, Gemma-2 and OPT at pp, int8 at pp, dp with pp; a MoE model at
  pp, with ep ranks too, is served: tests/test_torch_moe_stages.py, and
  speculative decoding at pp: tests/test_torch_spec_ranks.py).
"""

import asyncio
import dataclasses
import os
import re
import signal
import subprocess
import sys
import time
import types

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu.parallel.pipeline import serving_layer_pipeline
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
from production_stack_tpu_torch.engine.runner import RANK_STATS, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel import pipeline
from production_stack_tpu_torch.parallel.group import device_labels, parse_device_ids
from production_stack_tpu_torch.parallel.tp import shard_params
from test_torch_lora_ranks import rank_runner

F32 = dict(atol=2e-5, rtol=2e-5)
MODEL = "llama-debug-4kv-f32"  # 2 layers, KH 4
SMALL = dict(max_model_len=128, num_pages=64, page_size=8, max_num_seqs=4, decode_steps=2, prefill_chunk=32)
GLOO = dict(tp_backend="gloo")
MESHES = [(2, 1), (2, 2)]  # (pp, tp)


def _prompts():
    rng = np.random.RandomState(21)
    return [[int(x) for x in rng.randint(1, 512, n)] for n in (9, 27, 70)]  # 70: three chunks of 32


def _gen_all(engine, prompts, sp=SamplingParams, n=8):
    async def one(i, ids):
        out = []
        async for o in engine.generate(f"pp{i}-{time.monotonic_ns()}", prompt_token_ids=ids,
                                       params=sp(max_tokens=n, temperature=0.0, ignore_eos=True)):
            out += o.token_ids
        return out

    async def run():
        return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))

    return asyncio.run(run())


# -- the forward at one step: a decode and a prefill chunk --------------------------


def _pools(cfg, P_):
    rng = np.random.RandomState(8)
    shape = (cfg.num_layers, P_, SMALL["page_size"], cfg.num_kv_heads, cfg.head_dim)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _step_inputs(kind):
    """Eight rows (four microbatches of two at pp 2): a decode step after
    ragged histories (one empty), or a prefill chunk of up to 16 on top of
    them (three rows ragged)."""
    rng = np.random.RandomState(9)
    B, maxp = 8, 5
    pt = rng.permutation(SMALL["num_pages"])[: B * maxp].reshape(B, maxp).astype(np.int32)
    hist = np.array([4, 16, 30, 8, 0, 23, 11, 20], np.int32)
    if kind == "decode":
        pos = hist[:, None].copy()
        T = 1
    else:
        T = 16
        n = np.array([16, 16, 5, 16, 16, 1, 16, 9])
        pos = np.full((B, T), -1, np.int32)
        for b in range(B):
            pos[b, : n[b]] = hist[b] + np.arange(n[b])
    lens = np.where((pos >= 0).any(1), pos.max(1) + 1, hist).astype(np.int32)
    ids = rng.randint(0, 512, (B, T)).astype(np.int32)
    common = dict(input_ids=ids, positions=pos, page_table=pt, kv_lens=lens)
    return common, StepInput(**common, temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32),
                             top_p=np.ones(B, np.float32))


def _jax_forward(params, cfg, mesh, common, kp, vp):
    jcfg = dataclasses.replace(cfg, attn_impl="pallas_interpret")
    f = jax.jit(lambda p, *a: jllama.forward(p, jcfg, *a, mesh=mesh))
    logits, k2, v2 = f(params, common["input_ids"], common["positions"], kp, vp, common["page_table"],
                       common["kv_lens"])
    return np.asarray(logits), np.asarray(k2), np.asarray(v2)


def _port_forward(engine, tinp, kp, vp):
    """The step through every rank (set_pages loads the pools first);
    returns the logits and the whole pools read back after it."""
    r = engine.runner
    pids = list(range(kp.shape[1]))
    r.set_pages(pids, [kp[:, i] for i in pids], [vp[:, i] for i in pids])
    logits = r.step(tinp)[1].numpy()
    k, v = r.get_pages(pids)
    r.reset_kv()
    return logits, np.stack(k, axis=1), np.stack(v, axis=1)


@pytest.fixture(scope="module")
def pp_runs(eight_devices):
    """The f32 llama twin at pp 2 and pp 2 x tp 2 in both packages, one port
    engine with ranks at a time: the forward of a decode step and of a
    prefill chunk against the JAX forward on the same mesh, then both
    engines' greedy tokens of three concurrent prompts, the layout, the rank
    stats and a page round trip."""
    cfg = jllama.PRESETS[MODEL]
    kp, vp = _pools(cfg, SMALL["num_pages"])
    prompts = _prompts()
    out = {"pools": (kp, vp)}
    for mesh in MESHES:
        pp, tp = mesh
        res = out[mesh] = {}
        jeng = JaxEngine(JaxEngineConfig(model=MODEL, pipeline_parallel_size=pp, tensor_parallel_size=tp, **SMALL))
        peng = None
        try:
            jparams = jax.device_get(jeng.runner.params)
            out.setdefault("jparams", jparams)
            peng = LLMEngine(EngineConfig(model=MODEL, pipeline_parallel_size=pp, tensor_parallel_size=tp, **GLOO,
                                          **SMALL), device="cpu", params=params_from_jax(jparams, tllama.PRESETS[MODEL]))
            jmesh = make_mesh(pp=pp, tp=tp)
            for kind in ("decode", "prefill"):
                common, tinp = _step_inputs(kind)
                res[kind] = (_port_forward(peng, tinp, kp, vp), _jax_forward(jparams, cfg, jmesh, common, kp, vp),
                             common)
            jeng.start()
            peng.start()
            peng.runner.rank_stats(reset=True)
            res["jax"] = _gen_all(jeng, prompts, JaxSamplingParams)
            res["port"] = _gen_all(peng, prompts)
            s = peng.stats()
            res["shape"] = (s["mesh_devices"], s["tensor_parallel"], peng.kv.num_pages,
                            peng.runner.kv_pool_shard_layout(), peng.runner.rank_stats(), peng.runner.k_pages.shape)
            res["gathered"] = peng.runner.gathered_params(GATHERED)
            ids, pos = _encode_inputs()
            res["encode"] = (peng.runner.encode(ids, pos).numpy(),
                             np.asarray(jllama.encode(jparams, cfg, jnp.asarray(ids), jnp.asarray(pos))))
            pid = next(iter(peng.kv.hash_to_page.values()))
            page = [x[0] for x in peng.runner.get_pages([pid])]
            peng.runner.set_pages([1], [page[0]], [page[1]])
            res["page"] = (page, [x[0] for x in peng.runner.get_pages([1])])
        finally:
            jeng.stop()
            if peng is not None:
                peng.stop()
    return out


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("mesh", MESHES, ids=["pp2", "pp2tp2"])
def test_forward_matches_the_jax_pipeline_with_its_sharded_decode_kernel(pp_runs, mesh, kind):
    """One step through the port's stages against the JAX forward on the
    same mesh and pools (at T = 1 its sharded Pallas decode in interpret
    mode inside the pipeline): f32 logits within 2e-5, the written slots
    within 2e-5 and every other slot of every layer's pool byte for byte
    the initial pool's."""
    (tl, tk, tv), (jl, jk, jv), common = pp_runs[mesh][kind]
    kp, vp = pp_runs["pools"]
    np.testing.assert_allclose(tl, jl, **F32)
    page = SMALL["page_size"]
    written = np.zeros(kp.shape[1:3], bool)
    for b, row in enumerate(common["positions"]):
        for p_ in row[row >= 0]:
            written[common["page_table"][b, p_ // page], p_ % page] = True
    assert written.sum() == (common["positions"] >= 0).sum()
    for got, want, before in ((tk, jk, kp), (tv, jv, vp)):
        np.testing.assert_allclose(got, want, **F32)
        assert np.array_equal(got[:, ~written].view(np.uint32), before[:, ~written].view(np.uint32))
        assert not np.array_equal(got[:, written], before[:, written])


@pytest.mark.parametrize("mesh", MESHES, ids=["pp2", "pp2tp2"])
def test_greedy_tokens_match_the_jax_engine_at_the_same_mesh(pp_runs, mesh):
    jax_ids, port_ids = pp_runs[mesh]["jax"], pp_runs[mesh]["port"]
    assert port_ids == jax_ids
    assert [len(x) for x in port_ids] == [8, 8, 8]


@pytest.mark.parametrize("mesh", MESHES, ids=["pp2", "pp2tp2"])
def test_the_layout_and_rank_stats_count_the_stages(pp_runs, mesh):
    """mesh_devices counts pp x tp; each rank holds 1/(pp x tp) of every
    page (its stage's layers, its heads); every rank launched the plain
    decode and prefill of its stage's layers, and the stages relayed."""
    pp, tp = mesh
    devices, tp_stat, pages, layout, stats, pool = pp_runs[mesh]["shape"]
    cfg = tllama.PRESETS[MODEL]
    assert devices == pp * tp and tp_stat == tp and pages == SMALL["num_pages"]
    assert [label for label, _ in layout] == device_labels([torch.device("cpu")] * (pp * tp), pp=pp)
    whole = 2 * cfg.num_layers * pages * SMALL["page_size"] * cfg.num_kv_heads * cfg.head_dim * 4
    assert {b for _, b in layout} == {whole // (pp * tp)}
    assert pool == (cfg.num_layers // pp, pages, SMALL["page_size"], cfg.num_kv_heads // tp, cfg.head_dim)
    col = RANK_STATS.index
    assert stats.shape == (pp * tp, len(RANK_STATS))
    for row in stats:
        assert row[col("decode_attention_ref")] > 0 and row[col("prefill_attention_ref")] > 0
        assert row[col("relay_calls")] > 0 and row[col("relay_bytes")] > 0
        assert row[col("collective_calls")] >= row[col("relay_calls")]
    # every stage runs its own layers of each microbatch: the same count on every rank
    assert len({row[col("decode_attention_ref")] for row in stats}) == 1


def _encode_inputs():
    rng = np.random.RandomState(12)
    ids = rng.randint(0, 512, (3, 12)).astype(np.int32)
    pos = np.tile(np.arange(12, dtype=np.int32), (3, 1))
    pos[1, 7:] = -1
    return ids, pos


@pytest.mark.parametrize("mesh", MESHES, ids=["pp2", "pp2tp2"])
def test_encode_through_the_stages_matches_the_jax_encode(pp_runs, mesh):
    """The pooled embeddings, the batch through the stages as one
    microbatch, within 2e-5 of the JAX ``encode``."""
    got, want = pp_runs[mesh]["encode"]
    assert got.shape == want.shape == (3, tllama.PRESETS[MODEL].hidden_size)
    np.testing.assert_allclose(got, want, **F32)


GATHERED = ["layers.0.wq", "layers.1.wq", "layers.1.w_down", "layers.0.mlp_norm", "embed", "final_norm"]


@pytest.mark.parametrize("mesh", MESHES, ids=["pp2", "pp2tp2"])
def test_gathered_params_take_each_layer_from_its_stage(pp_runs, mesh):
    """runner.gathered_params names layers by the model's number: layer 1
    comes from stage 1 (and its tp ranks), bit for bit the JAX tree's."""
    whole = params_from_jax(pp_runs["jparams"], tllama.PRESETS[MODEL])
    got = pp_runs[mesh]["gathered"]
    assert set(got) == set(GATHERED)
    for name in GATHERED:
        assert torch.equal(got[name], whole[name]), name


@pytest.mark.parametrize("mesh", MESHES, ids=["pp2", "pp2tp2"])
def test_a_page_read_across_the_stages_writes_back_byte_for_byte(pp_runs, mesh):
    page, back = pp_runs[mesh]["page"]
    cfg = tllama.PRESETS[MODEL]
    assert page[0].shape == (cfg.num_layers, SMALL["page_size"], cfg.num_kv_heads, cfg.head_dim)
    assert [x.tobytes() for x in back] == [x.tobytes() for x in page]


def test_a_chained_pp2_engine_with_a_cpu_tier_gives_pp1_ids_and_restores_spilled_pages(eight_devices, pp_runs):
    """pp 2 at decode_pipeline 2 (chained bursts, each step committing its
    own K/V) on a 28-page pool with a CPU tier: the three prompts give pp
    1's ids (the JAX pp 2 engine's, equal to its one-device ids by the test
    above and tests/test_parallel_serving.py); after fillers evict the
    long prompt's pages, it runs again from the CPU tier with the same
    ids."""
    prompts = _prompts()
    one = LLMEngine(EngineConfig(model=MODEL, **SMALL), device="cpu",
                    params=params_from_jax(pp_runs["jparams"], tllama.PRESETS[MODEL]))
    one.start()
    try:
        want = _gen_all(one, prompts)
    finally:
        one.stop()
    eng = LLMEngine(EngineConfig(model=MODEL, pipeline_parallel_size=2, decode_pipeline=2, kv_offload_cpu_gb=0.001,
                                 kv_offload_max_io_pages=0, **GLOO, **dict(SMALL, num_pages=28)), device="cpu",
                    params=params_from_jax(pp_runs["jparams"], tllama.PRESETS[MODEL]))
    eng.start()
    try:
        got = _gen_all(eng, prompts)
        rng = np.random.RandomState(5)
        for i in range(4):  # churn the pool so the long prompt's pages are spilled
            _gen_all(eng, [[int(x) for x in rng.randint(1, 512, 60)]], n=4)
        again = _gen_all(eng, prompts[2:])
        s = eng.stats()
    finally:
        eng.stop()
    assert got == want == pp_runs[(2, 1)]["port"]  # decode_pipeline 2 gives decode_pipeline 1's ids
    assert again == want[2:]
    assert s["kv_offload_saved_pages_total"] > 0 and s["kv_offload_loaded_pages_total"] > 0
    assert s["kv_offload_hit_pages_total"] > 0 and s["kv_corrupt_pages_total"] == 0


def test_four_stages_relay_through_every_pair_and_give_pp1_ids(monkeypatch):
    """pp 4 on a 4-layer copy of the f32 twin (one layer a stage; beyond
    two stages each neighbouring pair relays over its own two-rank group):
    the greedy ids of two prompts equal pp 1's, and every stage relayed."""
    name = "llama-debug-4kv-f32-l4"
    monkeypatch.setitem(tllama.PRESETS, name, dataclasses.replace(tllama.PRESETS[MODEL], num_layers=4))
    prompts = _prompts()[:2]
    out = {}
    for pp in (1, 4):
        eng = LLMEngine(EngineConfig(model=name, pipeline_parallel_size=pp, **GLOO, **SMALL), device="cpu")
        eng.start()
        try:
            out[pp] = _gen_all(eng, prompts, n=6)
            if pp > 1:
                stats = eng.runner.rank_stats()
                pool = eng.runner.k_pages.shape
        finally:
            eng.stop()
    assert out[4] == out[1] and [len(x) for x in out[4]] == [6, 6]
    assert pool[0] == 1
    assert (stats[:, RANK_STATS.index("relay_calls")] > 0).all()


_LEADER = """
import asyncio, sys
sys.path.insert(0, {root!r})
from production_stack_tpu_torch.engine.api_server import serve
from production_stack_tpu_torch.engine.config import EngineConfig

async def main():
    cfg = EngineConfig(model={model!r}, host="127.0.0.1", port={port}, pipeline_parallel_size=2, tp_backend="gloo",
                       **{small!r})
    server, runner = await serve(cfg, device="cpu")
    print("FOLLOWERS", *(p.pid for p in server.engine._tp.procs), flush=True)
    await asyncio.Event().wait()

asyncio.run(main())
"""


def test_an_http_pp2_server_serves_and_ends_when_a_stage_dies():
    """A pp 2 server (the leader a subprocess, its follower stage spawned by
    it) answers a completion, reports its two ranks on /stats and one pool
    row a stage on /metrics; killing the follower stage while a request
    streams ends the leader with exit 13 (the watchdog), rather than a
    hang."""
    port = free_port()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
    leader = subprocess.Popen(
        [sys.executable, "-c", _LEADER.format(root=root, model=MODEL, port=port, small=SMALL)],
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
        base = f"http://127.0.0.1:{port}"

        async def ask():
            async with aiohttp.ClientSession() as s:
                body = {"prompt": "stages relay", "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
                async with s.post(f"{base}/v1/completions", json=body) as r:
                    done = await r.json()
                async with s.get(f"{base}/stats") as r:
                    stats = await r.json()
                async with s.get(f"{base}/metrics") as r:
                    metrics = await r.text()
            return done, stats, metrics

        done, stats, metrics = asyncio.run(asyncio.wait_for(ask(), 60))
        assert done["usage"]["completion_tokens"] == 6
        assert stats["mesh_devices"] == 2 and stats["tensor_parallel"] == 1
        rows = re.findall(r'vllm:kv_pool_shard_bytes\{[^}]*device="([^"]+)"[^}]*\} (\d+)', metrics)
        assert [d for d, _ in rows] == ["cpu:0/pp0tp0", "cpu:0/pp1tp0"] and len({v for _, v in rows}) == 1

        async def stream():
            body = {"prompt": "x" * 60, "max_tokens": 100, "temperature": 0.0, "ignore_eos": True, "stream": True}
            try:
                async with aiohttp.ClientSession() as s:
                    async with s.post(f"{base}/v1/completions", json=body) as r:
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


# -- units -----------------------------------------------------------------------------


@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("B", [3, 6, 32])
def test_microbatches_are_the_jax_pipelines(eight_devices, B, pp):
    """The JAX pipeline's microbatch count, read off the shape its layer
    body is traced at: B / mb."""
    seen = []

    def layer(carry, xs):
        x, aux = carry
        seen.append(x.shape[0])
        kv = jnp.zeros((*x.shape[:2], 1, 2))  # [mb, T, KH, D] of the pools below
        return (x, aux), (kv, kv)

    mesh = make_mesh(pp=pp)
    L, T, H = 2 * pp, 1, 8
    pools = jnp.zeros((L, 4, 1, 1, 2))
    jax.eval_shape(lambda x: serving_layer_pipeline(mesh, layer, x, {}, ({"w": jnp.zeros((L, 2))}, pools, pools, None)),
                   jnp.zeros((B, T, H)))
    assert seen and B // seen[0] == pipeline.microbatches(B, pp)
    assert B % pipeline.microbatches(B, pp) == 0


@pytest.mark.parametrize("pp", [2, 4])
def test_stage_range_is_the_jax_layer_shard(eight_devices, pp):
    L = 16
    mesh = make_mesh(pp=pp)
    arr = jax.device_put(jnp.arange(L), NamedSharding(mesh, P("pp")))
    for p_ in range(pp):
        dev = mesh.devices.reshape(pp, -1)[p_, 0]
        shard = next(s for s in arr.addressable_shards if s.device == dev)
        assert list(np.asarray(shard.data)) == list(pipeline.stage_range(L, pp, p_))


def _place(r, n):
    return types.SimpleNamespace(rank=r, size=n, all_reduce=lambda x: None)


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2)])
def test_stage_parameters_are_the_jax_layer_slices(pp, tp):
    """Each (p, t) rank's model from the JAX tree: its layers are the
    tree's layer slices [p * L/pp, (p + 1) * L/pp) (their tp part), the
    embedding and final norm every stage's, bit for bit."""
    cfg = dataclasses.replace(jllama.PRESETS["llama-debug-4kv"], num_layers=4)
    tcfg = dataclasses.replace(tllama.PRESETS["llama-debug-4kv"], num_layers=4)
    tree = jax.device_get(jllama.init_params(cfg, jax.random.key(3)))
    whole = params_from_jax(tree, tcfg)
    for p_ in range(pp):
        for t in range(tp):
            _, _, net = load_model("llama-debug-4kv", device="cpu", params=whole, config=tcfg,
                                   tp=_place(t, tp) if tp > 1 else None, stage=_place(p_, pp))
            own = dict(net.named_parameters())
            assert len(net.layers) == 2
            tpart = shard_params(whole, t, tp)
            for i, L_ in enumerate(pipeline.stage_range(4, pp, p_)):
                for leaf, stacked in tree["layers"].items():
                    got = own[f"layers.{i}.{leaf}"].detach()
                    want = tpart[f"layers.{L_}.{leaf}"]
                    assert torch.equal(got.view(torch.uint16), want.view(torch.uint16)), (p_, t, L_, leaf)
                    if tp == 1:
                        assert np.array_equal(got.view(torch.uint16).numpy(), stacked[L_].view(np.uint16))
            for name in ("embed", "final_norm"):
                assert torch.equal(own[name].detach().view(torch.uint16), tpart[name].view(torch.uint16))


def test_seeded_stages_make_the_pp1_model():
    """A stage draws every layer of the seeded model and keeps its own, so
    the stages of pp 2 are pp 1's layers, bit for bit."""
    cfg = dataclasses.replace(tllama.PRESETS["llama-debug"], num_layers=4)
    _, _, one = load_model("llama-debug", device="cpu", config=cfg, seed=7)
    whole = dict(one.named_parameters())
    for p_ in range(2):
        _, _, net = load_model("llama-debug", device="cpu", config=cfg, seed=7, stage=_place(p_, 2))
        for name, prm in net.named_parameters():
            glob = name if not name.startswith("layers.") else \
                f"layers.{int(name.split('.')[1]) + 2 * p_}.{name.split('.', 2)[2]}"
            assert torch.equal(prm.detach(), whole[glob].detach()), (p_, name)


def test_labels_device_ids_and_local_names_count_the_stages():
    cpu = torch.device("cpu")
    assert device_labels([cpu] * 2, pp=2) == ["cpu:0/pp0tp0", "cpu:0/pp1tp0"]
    assert device_labels([cpu] * 4, pp=2)[3] == "cpu:0/pp1tp1"
    assert parse_device_ids("0,0,0,0", 4) == [0] * 4
    with pytest.raises(ValueError, match="pipeline_parallel_size x"):
        parse_device_ids("0,0", 4)
    assert pipeline.local_name("layers.9.wq", 16, _place(1, 2)) == "layers.1.wq"
    assert pipeline.local_name("layers.7.wq", 16, _place(1, 2)) is None
    assert pipeline.local_name("embed", 16, _place(1, 2)) == "embed"
    check_supported(EngineConfig(pipeline_parallel_size=2, tensor_parallel_size=2, **GLOO,
                                 tp_device_ids="0,0,0,0"))


# -- refusals -----------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    dict(model="llama-debug", pipeline_parallel_size=4),  # 2 layers
    dict(model="gemma2-debug", pipeline_parallel_size=2),
    dict(model="opt-debug", pipeline_parallel_size=2),
    dict(model="llama-debug", pipeline_parallel_size=2, kv_cache_dtype="int8"),
], ids=["pp-past-the-layers", "gemma2", "opt", "int8"])
def test_pp_refusals_in_the_jax_engines_words(eight_devices, overrides):
    """The port refuses what the JAX engine refuses, with its message."""
    kw = dict(max_model_len=128, num_pages=16, page_size=8)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(JaxEngineConfig(**overrides, **kw))
    with pytest.raises(ValueError) as terr:
        LLMEngine(EngineConfig(**overrides, **kw, **GLOO), device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("overrides,match", [
    (dict(model="mixtral-debug", pipeline_parallel_size=2, expert_parallel_size=2, data_parallel_size=2),
     "pipeline parallelism does not compose with in-engine data parallelism"),
    (dict(model="llama-debug", pipeline_parallel_size=0), "pipeline_parallel_size must be >= 1"),
], ids=["ep", "pp-0"])
def test_unserved_pp_combinations_are_refused_by_name(overrides, match):
    """What stays refused at pp. A MoE model at pp, with or without ep
    ranks, is served (tests/test_torch_moe_stages.py), and speculative
    decoding at pp (tests/test_torch_spec_ranks.py; the cases this test
    refused before are ``test_once_refused_compositions_are_served`` in
    tests/test_torch_seq_compose.py); its case here is the combination
    around it that is not: in-engine dp (in the JAX engine's words)."""
    with pytest.raises(ValueError, match=match):
        LLMEngine(EngineConfig(**overrides, max_model_len=128, num_pages=16, page_size=8, **GLOO), device="cpu")


@pytest.mark.parametrize("tp", [1, 2])
def test_lora_at_pp_is_served_with_each_stages_layers(tp):
    """Once refused, now served: the config passes check_supported, and a
    stage's runner holds its L/pp layers of the slot buffers, its tp part
    of each (tests/test_torch_lora_stages.py serves pp 2 and pp 2 x tp 2
    against the JAX engine)."""
    check_supported(EngineConfig(model=MODEL, pipeline_parallel_size=2, tensor_parallel_size=tp, enable_lora=True,
                                 **GLOO))
    for p in range(2):
        lora = rank_runner(p=p, pp=2, t=tp - 1, tp=tp).lora
        assert len(lora["layers"]) == 1 and lora["scale"].shape == (3,)
        assert lora["layers"][0]["b_wk"].shape == (3, 16, 128 // tp)
        assert lora["layers"][0]["a_wo"].shape == (3, 256 // tp, 16)
