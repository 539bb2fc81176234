"""Expert parallelism in the port (parallel/ep.py, the MoE block summed over
the expert group, dp x ep x tp rank processes, ``decode_attention_sharded``'s
ep axis) against the JAX package on its virtual 8-device CPU mesh
(tests/test_parallel_serving.py TestExpertParallelServing,
tests/test_pallas_attention.py TestShardedKernel).

- The sharded decode on every (d, e, t) rank of (dp, ep, tp) = (1, 2, 1),
  (1, 2, 2) and (2, 2, 1): the ep replicas of a (d, t) slice return the
  same bytes, and the slices joined equal
  ``ragged_paged_attention_decode_sharded`` on the same mesh in interpret
  mode (f32 within 2e-5, bf16 within 3e-2; fp and int8 pools, with and
  without the burst window).
- The MoE block at (ep, tp) in {(2, 1), (1, 2), (2, 2)}: the ranks' partial
  outputs summed (what the expert group's all-reduce does) equal the JAX
  ``_moe_block`` on the whole experts.
- Engines on an f32 copy of mixtral-debug (the preset replaced in both
  packages; the spawned ranks take the leader's config) at (dp, ep, tp) =
  (1, 2, 1), (1, 2, 2), (1, 1, 2), (2, 1, 1) and (2, 2, 1), gloo ranks on
  the CPU, with the JAX engine's weights: greedy tokens of three concurrent
  prompts equal the JAX engine's at the same mesh and at one device; a
  four-row prefill's logits within 2e-5 of the JAX runner's on the same
  mesh; the ep and dp replicas' pools bit-equal after the serve; the pool
  layout, rank stats and gathered experts; a page blob of ep 2 x tp 2
  against ep 1's, restored both ways; planted experts replayed on every
  rank (``runner.replay_routes``) give one rank's logits.
- A dense model at ep 2 is ep 1's bit for bit (its ep ranks replicate it).
- Weight splits: ``shard_params`` and seeded ranks join back to the whole
  model; a small HF Mixtral directory read by (e, t) ranks gives the slices
  of the whole read.
- The refusals: an ep that does not divide the experts, multi-host
  without a coordinator, device ids and device KV transfer (ep at pp and
  sp is served: tests/test_torch_moe_stages.py, tests/test_torch_moe_seq.py;
  with sp beside dp ranks and spec decode at pp too:
  tests/test_torch_seq_compose.py).
- An HTTP server at --expert-parallel-size 2 answers the ep 1 server's
  greedy text and advertises its shape.
"""

import asyncio
import dataclasses
import json
import re
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
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops.pallas.paged_attention import ragged_paged_attention_decode_sharded
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import _llama_names, load_from_hf, load_model, params_from_jax
from production_stack_tpu_torch.engine.runner import RANK_STATS, ModelRunner, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvoffload.serde import get_serde
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention_sharded
from production_stack_tpu_torch.parallel import ep as epmod
from production_stack_tpu_torch.parallel import tp as tpmod
from production_stack_tpu_torch.parallel.group import device_labels, parse_device_ids
from production_stack_tpu_torch.parallel.tp import split_axis
from production_stack_tpu_torch.utils.safetensors_io import save_sharded
from test_torch_lora_ranks import rank_runner
from test_torch_surface import _Loop

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
MODEL = "mixtral-debug"  # 4 experts of I 256, NH 4, KH 2
DENSE = "llama-debug-4kv-f32"
SMALL = dict(max_model_len=128, num_pages=64, page_size=8, max_num_seqs=4, decode_steps=2, prefill_chunk=32)
GLOO = dict(tp_backend="gloo")
ENGINE_MESHES = [(1, 2, 1), (1, 2, 2), (1, 1, 2), (2, 1, 1), (2, 2, 1)]  # (dp, ep, tp)


def _rank(r, n):
    """A stand-in for a group where only its place counts (slicing,
    loading): its ``rank`` and ``size``; its all-reduce leaves ``x`` as it
    is, so a caller sums the ranks' partial results itself."""
    return types.SimpleNamespace(rank=r, size=n, all_reduce=lambda x: None)


def _experts(e, ep, t, tp):
    """An expert group stand-in of rank (e, t): its place in the group and
    on the ep axis."""
    return types.SimpleNamespace(rank=e * tp + t, size=ep * tp, ep_rank=e, ep_size=ep, all_reduce=lambda x: None)


def _groups(e, ep, t, tp):
    """(tp group, expert group) stand-ins of rank (e, t), as the engine
    hands them to a model (None for a group of one rank)."""
    return (_rank(t, tp) if tp > 1 else None), (_experts(e, ep, t, tp) if ep * tp > 1 else None)


# -- the sharded decode's ep axis against ragged_paged_attention_decode_sharded --


def _np(x, dtype):
    return x.astype(ml_dtypes.bfloat16) if dtype == "bf16" else x.astype(np.float32)


def _t(a):
    """A numpy array (bf16 as ml_dtypes') as a torch tensor, every bit kept."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


# (pools, window, dtype): every pair of the three choices appears once
DECODE_CASES = [(False, False, "f32"), (True, True, "f32"), (False, True, "bf16"), (True, False, "bf16")]


@pytest.mark.parametrize("quant,burst,dtype", DECODE_CASES,
                         ids=[f"{'int8' if q else 'fp'}-{'burst' if b else 'pool'}-{d}" for q, b, d in DECODE_CASES])
@pytest.mark.parametrize("dp,ep,tp", [(1, 2, 1), (1, 2, 2), (2, 2, 1)])
def test_sharded_decode_on_every_ep_rank_matches_the_jax_sharded_kernel(eight_devices, dp, ep, tp, burst, quant,
                                                                       dtype):
    """Rank (d, e, t) runs the decode on its B/dp rows and KH/tp heads, the
    same on every e: the ep replicas give the same bytes, and the (d, t)
    slices joined equal the JAX function on the (dp, ep, tp) mesh. Four
    cases a mesh (one interpret-mode compile each, ~4 s) cover fp and int8
    pools, the pool alone and with the burst window, f32 and bf16, each
    pair of those once."""
    rng = np.random.RandomState(11 + 3 * tp + 5 * dp + int(quant) + 2 * int(burst))
    B, NH, KH, D, page, P, maxp, L, C = 4, 8, 4, 32, 8, 32, 4, 2, 3
    q = _np(rng.randn(B, NH, D), dtype)
    if quant:
        kp, vp = (rng.randint(-127, 128, (L, P, page, KH, D)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, (L, P, KH)).astype(np.float32) for _ in range(2))
    else:
        kp, vp = (_np(rng.randn(L, P, page, KH, D), dtype) for _ in range(2))
        ks = vs = None
    pt = rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32)
    lens = np.array([6, 17, 24, 31], np.int32)
    win = {}
    if burst:
        win = dict(k_cur=_np(rng.randn(B, C, KH, D), dtype), v_cur=_np(rng.randn(B, C, KH, D), dtype),
                   cur_lens=np.array([1, 3, 2, 3], np.int32))
    jkw = {k: jnp.asarray(v) for k, v in win.items()}
    if quant:
        jkw.update(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    mesh = make_mesh(dp=dp, ep=ep, tp=tp)
    ref = jax.jit(lambda *a: ragged_paged_attention_decode_sharded(mesh, *a, interpret=True, layer=1, **jkw))(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt), jnp.asarray(lens)
    )
    n, kh = B // dp, KH // tp

    def sl(a, d, t=None, heads_axis=None, per=None):
        x = _t(a)
        x = x.narrow(0, d * n, n) if d is not None else x
        if t is not None:
            x = x.narrow(heads_axis, t * per, per)
        return x.contiguous()

    rows = []
    for d in range(dp):
        heads = []
        for t in range(tp):
            outs = [decode_attention_sharded(
                sl(q, d, t, 1, NH // tp), sl(kp, None, t, 3, kh), sl(vp, None, t, 3, kh), sl(pt, d), sl(lens, d),
                tp=tp, layer=1, plain=True,
                k_scales=None if ks is None else sl(ks, None, t, 2, kh),
                v_scales=None if vs is None else sl(vs, None, t, 2, kh),
                k_cur=sl(win["k_cur"], d, t, 2, kh) if burst else None,
                v_cur=sl(win["v_cur"], d, t, 2, kh) if burst else None,
                cur_lens=sl(win["cur_lens"], d) if burst else None,
            ) for _ in range(ep)]  # rank (d, e, t) for every e: the same inputs
            assert all(torch.equal(o.view(torch.uint8), outs[0].view(torch.uint8)) for o in outs[1:])
            heads.append(outs[0])
        rows.append(torch.cat(heads, dim=1))
    got = torch.cat(rows, dim=0)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref).astype(np.float32),
                               **(BF16 if dtype == "bf16" else F32))


# -- the MoE block over the expert group ------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("ep,tp", [(2, 1), (1, 2), (2, 2)])
def test_moe_block_summed_over_the_expert_group_matches_the_jax_block(ep, tp, dtype, tol):
    """Each (e, t) rank holds E/ep experts (8 here, 4 a rank at ep 2) and
    I/tp of each, routes over all of them and weighs its own by their gate
    columns; the ranks' outputs summed equal ``_moe_block`` on the whole
    experts (f32 within 2e-5; bf16 within 2e-2, the tolerance of
    tests/test_torch_moe.py: the ranks round their partial sums to bf16)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    cfg_j = dataclasses.replace(jllama.PRESETS[MODEL], dtype=jdt, num_experts=8)
    cfg_t = dataclasses.replace(tllama.PRESETS[MODEL], dtype=dtype, num_experts=8)
    p = jax.device_get(jllama.init_params(cfg_j, jax.random.key(5)))
    whole = params_from_jax(p, cfg_t)
    h = np.random.RandomState(6).randn(3, 7, cfg_t.hidden_size).astype(np.float32).astype(np.dtype(jdt))
    want = np.asarray(jllama._moe_block(jnp.asarray(h), {k: v[1] for k, v in p["layers"].items()}, cfg_j))
    th = _t(h)
    total = None
    for e in range(ep):
        for t in range(tp):
            tpg, experts = _groups(e, ep, t, tp)
            layer = tllama.LlamaDecoderLayer(cfg_t, "cpu", tpg, experts)
            own = tpmod.shard_params(whole, t, tp, e, ep)
            with torch.no_grad():
                for name, prm in layer.named_parameters():
                    prm.copy_(own["layers.1." + name])
                out = layer.moe(th, cfg_t)
            assert layer.moe_gate.shape == (8 // ep, cfg_t.hidden_size, cfg_t.intermediate_size // tp)
            total = out if total is None else total + out
    assert total.dtype == dtype
    np.testing.assert_allclose(total.float().numpy(), want.astype(np.float32), atol=tol, rtol=0)
    assert float(np.abs(want.astype(np.float32)).mean()) > 10 * tol


# -- engines against the JAX engine at the same mesh -------------------------------


def _prompts():
    rng = np.random.RandomState(21)
    return [[int(x) for x in rng.randint(1, 512, n)] for n in (9, 27, 70)]


def _gen_all(engine, prompts, sp=SamplingParams, n=8):
    async def one(i, ids):
        out = []
        async for o in engine.generate(f"r{i}-{time.monotonic_ns()}", prompt_token_ids=ids,
                                       params=sp(max_tokens=n, temperature=0.0, ignore_eos=True)):
            out += o.token_ids
        return out

    async def run():
        return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))

    return asyncio.run(run())


def _prefill_inputs():
    """A four-row prefill chunk on fresh pages (two rows per dp rank at dp
    2; rows 1 and 3 ragged)."""
    rng = np.random.RandomState(5)
    B, T = 4, 16
    pos = np.full((B, T), -1, np.int32)
    for b, n in enumerate((16, 11, 16, 5)):
        pos[b, :n] = np.arange(n)
    common = dict(input_ids=rng.randint(0, 512, (B, T)).astype(np.int32), positions=pos,
                  page_table=np.arange(1, 1 + 2 * B, dtype=np.int32).reshape(B, 2),
                  kv_lens=(pos >= 0).sum(1).astype(np.int32), temperature=np.zeros(B, np.float32),
                  top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32))
    return JaxStepInput(**common), StepInput(**common)


def _port(mesh, params, model=MODEL):
    dp, ep, tp = mesh
    return LLMEngine(EngineConfig(model=model, data_parallel_size=dp, expert_parallel_size=ep,
                                  tensor_parallel_size=tp, **GLOO, **SMALL), device="cpu", params=params)


def _planted(cfg, inp):
    """Experts for every token of one forward of ``inp``, [B, T, k] per
    layer: each (row, position, layer) its own pair, spread over all E."""
    B, T = np.asarray(inp.input_ids).shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    base = np.arange(B)[:, None, None] + 3 * np.arange(T)[None, :, None] + np.arange(k)[None, None, :]
    return [((base + layer) % E).astype(np.int64) for layer in range(cfg.num_layers)]


GATHERED = ["layers.0.moe_gate", "layers.1.moe_up", "layers.1.moe_down", "layers.0.moe_router", "layers.0.wq",
            "embed", "final_norm"]


@pytest.fixture(scope="module")
def ep_runs(eight_devices):
    """The f32 copy of mixtral-debug at one device and at every mesh of
    ENGINE_MESHES in both packages, one port engine with ranks at a time (a
    process leads one engine's ranks); the port's ep 1 engine stays up
    beside them, a blob's restore target."""
    jcfg = dataclasses.replace(jllama.PRESETS[MODEL], dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS[MODEL], dtype=torch.float32)
    prompts = _prompts()
    jinp, tinp = _prefill_inputs()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jllama.PRESETS, MODEL, jcfg)
        mp.setitem(tllama.PRESETS, MODEL, tcfg)
        one = None
        try:
            for mesh in [(1, 1, 1)] + ENGINE_MESHES:
                dp, ep, tp = mesh
                res = out[mesh] = {}
                jeng = JaxEngine(JaxEngineConfig(model=MODEL, data_parallel_size=dp, expert_parallel_size=ep,
                                                 tensor_parallel_size=tp, **SMALL))
                peng = None
                try:
                    if mesh == (1, 1, 1):
                        out["params"] = params_from_jax(jax.device_get(jeng.runner.params), tcfg)
                        peng = one = _port(mesh, out["params"])
                    else:
                        peng = _port(mesh, out["params"])
                    res["logits"] = (peng.runner.step(tinp)[1].numpy(), np.asarray(jeng.runner.step(jinp)[1]))
                    # the same chunk with planted experts replayed on every rank
                    peng.runner.replay_routes(_planted(tcfg, tinp))
                    res["replayed"] = (peng.runner.step(tinp)[1].numpy(), peng.runner.route_tape.overridden)
                    peng.runner.replay_routes(None)
                    jeng.runner.reset_kv()
                    peng.runner.reset_kv()
                    jeng.start()
                    peng.start()
                    res["jax"] = _gen_all(jeng, prompts, JaxSamplingParams)
                    res["port"] = _gen_all(peng, prompts)
                    res["digest"] = peng.runner.replica_digest()
                    s = peng.stats()
                    res["shape"] = (s["mesh_devices"], s["tensor_parallel"], peng.runner.kv_pool_shard_layout(),
                                    peng.runner.rank_stats())
                    h = next(iter(peng.kv.hash_to_page))
                    res["page"] = (h, [x[0] for x in peng.runner.get_pages([peng.kv.hash_to_page[h]])])
                    if mesh == (1, 2, 2):
                        res["gathered"] = peng.runner.gathered_params(GATHERED)
                        # ep 1's page of the same prompt, written into every
                        # rank of ep 2 x tp 2 and read back
                        kv1 = [x[0] for x in one.runner.get_pages([one.kv.hash_to_page[h]])]
                        page = get_serde("naive").deserialize(get_serde("naive").serialize(*kv1))
                        peng.runner.set_pages([5], *([x] for x in page))
                        res["restored"] = (page, [x[0] for x in peng.runner.get_pages([5])],
                                           peng.runner.replica_digest())
                finally:
                    jeng.stop()
                    if peng is not None and peng is not one:
                        peng.stop()
            # the ep 2 x tp 2 engine's page as a JAX serde blob, restored into ep 1
            blob = jserde.get_serde("naive").serialize(*out[(1, 2, 2)]["page"][1])
            page = get_serde("naive").deserialize(blob)
            one.runner.set_pages([6], *([x] for x in page))
            out["into_ep1"] = (blob, [x[0] for x in one.runner.get_pages([6])])
        finally:
            if one is not None:
                one.stop()
    return out


@pytest.mark.parametrize("mesh", ENGINE_MESHES, ids=[f"dp{d}ep{e}tp{t}" for d, e, t in ENGINE_MESHES])
def test_greedy_tokens_match_the_jax_engine_at_the_mesh_and_at_one_device(ep_runs, mesh):
    """Three concurrent prompts of 9, 27 and 70 tokens: the port's greedy
    tokens are the JAX engine's at the same (dp, ep, tp), and its one
    device's (tests/test_parallel_serving.py's comparison)."""
    res = ep_runs[mesh]
    assert res["port"] == res["jax"] == ep_runs[(1, 1, 1)]["jax"] == ep_runs[(1, 1, 1)]["port"]
    assert all(len(ids) == 8 for ids in res["port"])


@pytest.mark.parametrize("mesh", [(1, 1, 1)] + ENGINE_MESHES, ids=[f"dp{d}ep{e}tp{t}" for d, e, t in
                                                                   [(1, 1, 1)] + ENGINE_MESHES])
def test_prefill_logits_match_the_jax_runner_at_the_same_mesh(ep_runs, mesh):
    """A four-row f32 prefill chunk through both runners: within 2e-5 (the
    MoE sums over the expert group and the JAX psum over (ep, tp) add in
    their own orders)."""
    tl, jl = ep_runs[mesh]["logits"]
    assert tl.shape == jl.shape == (4, 512)
    np.testing.assert_allclose(tl, jl, **F32)


@pytest.mark.parametrize("mesh", ENGINE_MESHES, ids=[f"dp{d}ep{e}tp{t}" for d, e, t in ENGINE_MESHES])
def test_replayed_routes_reach_every_rank(ep_runs, mesh):
    """``replay_routes`` (a replicated call) makes every rank's routers take
    the planted experts: the mesh's logits equal one rank's replaying the
    same experts within 2e-5, where its own routers would have taken others
    (the leader's tape counts them) and the logits differ by far more."""
    got, overridden = ep_runs[mesh]["replayed"]
    one, _ = ep_runs[(1, 1, 1)]["replayed"]
    np.testing.assert_allclose(got, one, **F32)
    assert overridden > 0
    assert np.abs(one - ep_runs[(1, 1, 1)]["logits"][0]).max() > 100 * F32["atol"]


@pytest.mark.parametrize("mesh", ENGINE_MESHES, ids=[f"dp{d}ep{e}tp{t}" for d, e, t in ENGINE_MESHES])
def test_the_ep_and_dp_replicas_hold_the_same_bytes(ep_runs, mesh):
    """After the serve every rank of one tp place (the dp and ep replicas
    of its KV-head shard) holds byte-identical pools: the ep ranks wrote
    the same pages with nothing copied between them."""
    dp, ep, tp = mesh
    digests = [bytes(d) for d in ep_runs[mesh]["digest"]]
    assert len(digests) == dp * ep * tp
    for t in range(tp):
        assert len({digests[r] for r in range(t, dp * ep * tp, tp)}) == 1, t
    if tp > 1:
        assert digests[0] != digests[1]


@pytest.mark.parametrize("mesh", ENGINE_MESHES, ids=[f"dp{d}ep{e}tp{t}" for d, e, t in ENGINE_MESHES])
def test_shape_layout_and_rank_stats_count_every_rank(ep_runs, mesh):
    """``mesh_devices`` is dp x ep x tp and ``tensor_parallel`` tp; each
    rank has a labelled pool row of 1/tp of the page bytes; every rank ran
    both kernels' plain versions and its steps, and the MoE sums crossed
    its expert group where it has more than one rank."""
    dp, ep, tp = mesh
    devices, tp_stat, layout, stats = ep_runs[mesh]["shape"]
    (_, whole), = ep_runs[(1, 1, 1)]["shape"][2]
    assert devices == dp * ep * tp and tp_stat == tp
    assert [label for label, _ in layout] == device_labels([torch.device("cpu")] * (dp * ep * tp), dp, ep)
    assert {b for _, b in layout} == {whole // tp}
    col = RANK_STATS.index
    assert stats.shape == (dp * ep * tp, len(RANK_STATS))
    for name in ("decode_attention_ref", "prefill_attention_ref", "steps"):
        assert (stats[:, col(name)] > 0).all(), name
    if ep * tp > 1:
        # two layers of MoE sums a forward, [B, T, H] f32 each
        assert (stats[:, col("expert_calls")] > 0).all() and (stats[:, col("expert_bytes")] > 0).all()
    else:
        assert (stats[:, col("expert_calls")] == 0).all()
    assert (stats[:, col("sync_bytes")] > 0).all() == (dp > 1)


def test_gathered_params_join_the_experts_over_the_expert_group(ep_runs):
    """At ep 2 x tp 2 the leader's gathered experts (E/ep x I/tp blocks
    joined over the four ranks), router, attention and embeddings are the
    whole model's, bit for bit."""
    whole = ep_runs["params"]
    for name, t in ep_runs[(1, 2, 2)]["gathered"].items():
        assert t.shape == whole[name].shape and torch.equal(t, whole[name]), name


def test_a_page_blob_of_ep2_tp2_against_ep1_and_restored_both_ways(ep_runs):
    """The same prompt's first page, every KV head, read from ep 2 x tp 2
    (the leader's ep replica, gathered over its tp group) and from ep 1:
    the same layout, K/V within 2e-5 (layer 0's bit for bit: before any MoE
    sum), and a JAX serde blob of it byte-identical to the port serde's.
    ep 1's page written into ep 2 x tp 2 lands in every rank (the replicas'
    digests agree) and reads back bit for bit; ep 2 x tp 2's blob restores
    into ep 1 bit for bit."""
    h1, page1 = ep_runs[(1, 1, 1)]["page"]
    h4, page4 = ep_runs[(1, 2, 2)]["page"]
    assert h1 == h4
    for got, want in zip(page4, page1):
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        assert got[0].tobytes() == want[0].tobytes()
        np.testing.assert_allclose(got, want, **F32)
    blob, back = ep_runs["into_ep1"]
    assert blob == get_serde("naive").serialize(*page4)
    assert [b.tobytes() for b in back] == [np.ascontiguousarray(x).tobytes() for x in page4]
    page, read, digests = ep_runs[(1, 2, 2)]["restored"]
    assert [r.tobytes() for r in read] == [np.ascontiguousarray(x).tobytes() for x in page]
    assert bytes(digests[0]) == bytes(digests[2]) and bytes(digests[1]) == bytes(digests[3])


def test_a_dense_model_at_ep2_is_ep1_bit_for_bit():
    """"Dense models ignore it" (the JAX engine's words): a dense model's
    two ep ranks each run the whole model, so the prefill logits are ep
    1's bit for bit, the greedy tokens equal, and the two ranks' pools
    too."""
    _, _, model = load_model(DENSE, seed=4, device="cpu")
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    _, tinp = _prefill_inputs()
    got = {}
    for ep in (1, 2):
        eng = _port((1, ep, 1), params, model=DENSE)
        try:
            logits = eng.runner.step(tinp)[1].numpy()
            eng.runner.reset_kv()
            eng.start()
            got[ep] = (logits, _gen_all(eng, _prompts()), eng.runner.replica_digest(), eng.stats()["mesh_devices"])
        finally:
            eng.stop()
    assert got[2][0].tobytes() == got[1][0].tobytes()
    assert got[2][1] == got[1][1]
    assert bytes(got[2][2][0]) == bytes(got[2][2][1]) and got[2][3] == 2


# -- weight splits and sliced loads ------------------------------------------------


def _join(ranks, ep, tp):
    """The whole parameter dict from the (e, t) ranks' ({(e, t): dict});
    a parameter a rank holds whole must be the same on every rank."""
    out = {}
    for name in ranks[(0, 0)]:
        tax, eax = split_axis(name), tpmod.expert_axis(name)

        def over_tp(e):
            parts = [ranks[(e, t)][name] for t in range(tp)]
            if tax is None or tp == 1:
                assert all(torch.equal(p, parts[0]) for p in parts[1:]), name
                return parts[0]
            return torch.cat(parts, dim=tax)

        if eax is None:
            out[name] = over_tp(0)
            assert all(torch.equal(over_tp(e), out[name]) for e in range(1, ep)), name
        else:
            out[name] = torch.cat([over_tp(e) for e in range(ep)], dim=eax)
    return out


@pytest.mark.parametrize("ep,tp", [(2, 1), (4, 1), (2, 2)])
def test_shard_params_and_seeded_ranks_join_back_to_the_whole_model(ep, tp):
    """``shard_params`` of a whole tree (the JAX package's, carried over)
    joins back bit for bit, and so do seeded ranks: each draws the whole
    tensor and keeps its (experts, I) block."""
    whole = params_from_jax(jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0))),
                            tllama.PRESETS[MODEL])
    shards = {(e, t): tpmod.shard_params(whole, t, tp, e, ep) for e in range(ep) for t in range(tp)}
    assert shards[(0, 0)]["layers.0.moe_down"].shape == (4 // ep, 256 // tp, 128)
    joined = _join(shards, ep, tp)
    assert joined.keys() == whole.keys()
    for k, t in whole.items():
        assert torch.equal(joined[k].view(torch.uint8), t.view(torch.uint8)), k
    _, _, one = load_model(MODEL, seed=3, device="cpu")
    seeded = {}
    for e in range(ep):
        for t in range(tp):
            tpg, experts = _groups(e, ep, t, tp)
            net = load_model(MODEL, seed=3, device="cpu", tp=tpg, experts=experts)[2]
            seeded[(e, t)] = {k: v.detach() for k, v in net.named_parameters()}
    joined = _join(seeded, ep, tp)
    for k, t in one.named_parameters():
        assert torch.equal(joined[k], t.detach()), k


def test_hf_mixtral_directory_ranks_read_their_experts_and_slices(tmp_path):
    """A Mixtral directory (one HF tensor per expert and projection) read
    by the (e, t) ranks of ep 2 x tp 2 and of ep 2: joined, the model one
    process reads, every bit; a rank's experts are the E/ep it holds."""
    cfg = tllama.PRESETS[MODEL]
    _, _, model = load_model(MODEL, seed=5, device="cpu")
    own = dict(model.named_parameters())
    tensors = {}
    for pname, (hf, tr) in _llama_names(cfg).items():
        for i, name in enumerate(hf if isinstance(hf, tuple) else (hf,)):
            t = own[pname].detach()[i] if isinstance(hf, tuple) else own[pname].detach()
            tensors[name] = (t.t() if tr else t).contiguous()
    save_sharded(str(tmp_path), {k: (tuple(v.shape), v.dtype) for k, v in tensors.items()}, tensors.__getitem__,
                 max_shard_bytes=1 << 18)
    hf_cfg = {"architectures": ["MixtralForCausalLM"], "hidden_size": cfg.hidden_size,
              "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
              "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
              "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
              "max_position_embeddings": cfg.max_model_len, "head_dim": cfg.head_dim, "tie_word_embeddings": False,
              "num_local_experts": cfg.num_experts, "num_experts_per_tok": cfg.num_experts_per_tok}
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg))
    _, _, one = load_from_hf(str(tmp_path), device="cpu")
    for ep, tp in ((2, 2), (2, 1)):
        ranks = {}
        for e in range(ep):
            for t in range(tp):
                tpg, experts = _groups(e, ep, t, tp)
                net = load_from_hf(str(tmp_path), device="cpu", tp=tpg, experts=experts)[2]
                ranks[(e, t)] = {k: v.detach() for k, v in net.named_parameters()}
        assert ranks[(1, 0)]["layers.1.moe_gate"].shape == (2, cfg.hidden_size, cfg.intermediate_size // tp)
        assert torch.equal(ranks[(1, 0)]["layers.1.moe_gate"][:, :, : 256 // tp],
                           own["layers.1.moe_gate"].detach()[2:, :, : 256 // tp])
        joined = _join(ranks, ep, tp)
        for k, t in one.named_parameters():
            assert torch.equal(joined[k], t.detach()), (ep, tp, k)


# -- the layout and the refusals ----------------------------------------------------


def test_labels_and_device_ids_count_the_ep_ranks():
    cpu = torch.device("cpu")
    assert device_labels([cpu] * 2, ep=2) == ["cpu:0/dp0ep0tp0", "cpu:0/dp0ep1tp0"]
    assert device_labels([cpu] * 8, dp=2, ep=2)[5] == "cpu:0/dp1ep0tp1"
    assert parse_device_ids("0,0,0,0", 4) == [0] * 4
    with pytest.raises(ValueError, match="expert_parallel_size"):
        parse_device_ids("0,0", 4)
    check_supported(EngineConfig(expert_parallel_size=2, tensor_parallel_size=2, data_parallel_size=2,
                                 tp_backend="gloo", tp_device_ids="0,0,0,0,0,0,0,0"))
    assert epmod.expert_range(8, 2, 1) == range(4, 8)


@pytest.mark.parametrize("overrides,match", [
    (dict(model=MODEL, expert_parallel_size=3), "expert_parallel_size 3 does not divide num_experts 4"),
    (dict(model=MODEL, expert_parallel_size=0), "expert_parallel_size must be >= 1"),
    (dict(model=MODEL, expert_parallel_size=2, distributed_num_processes=2), "multi-host serving"),
    (dict(model=MODEL, expert_parallel_size=2, tp_device_ids="0,0,0", **GLOO), "one device index"),
    (dict(model=MODEL, expert_parallel_size=2, kv_transfer_device=True), "device KV transfer"),
], ids=["ep-3", "ep-0", "multihost", "device-ids", "device-kv"])
def test_unsupported_ep_setups_are_refused_by_name(overrides, match):
    cfg = EngineConfig(**{**SMALL, **overrides})
    with pytest.raises(ValueError, match=match):
        LLMEngine(cfg, device="cpu")


@pytest.mark.parametrize("tp", [1, 2])
def test_the_runner_builds_lora_buffers_on_an_ep_rank(tp):
    """Once refused, now served: an ep rank holds its tp place's part of
    every slot buffer, the same on every e (attention is every ep rank's;
    tests/test_torch_lora_experts.py serves Mixtral at ep against the JAX
    engine)."""
    check_supported(EngineConfig(model=MODEL, expert_parallel_size=2, tensor_parallel_size=tp, enable_lora=True,
                                 **GLOO))
    bufs = [rank_runner(MODEL, ("wq", "wk", "wv", "wo"), e=e, ep=2, t=tp - 1, tp=tp).lora["layers"][0]
            for e in range(2)]
    for layer in bufs:
        assert set(layer) == {f"{ab}_{t}" for ab in "ab" for t in ("wq", "wk", "wv", "wo")}
        assert layer["b_wq"].shape == (3, 16, 128 // tp) and layer["a_wo"].shape == (3, 128 // tp, 16)
    assert all(bufs[0][k].shape == bufs[1][k].shape for k in bufs[0])


# -- HTTP ----------------------------------------------------------------------------


def test_http_ep2_server_serves_ep1_text_and_advertises_its_shape(monkeypatch):
    """A port server with --expert-parallel-size 2 (gloo, CPU; seeded
    weights of the f32 copy, the same model at every ep) answers the ep 1
    server's greedy completion; /stats gives mesh_devices 2 and tp 1, and
    /metrics two pool rows of the whole page bytes."""
    monkeypatch.setitem(tllama.PRESETS, MODEL, dataclasses.replace(tllama.PRESETS[MODEL], dtype=torch.float32))
    body = {"prompt": "the experts split over two ranks", "max_tokens": 12, "temperature": 0.0, "ignore_eos": True}
    loop = _Loop()

    async def serve_and_ask(ep):
        cfg = EngineConfig(model=MODEL, host="127.0.0.1", port=free_port(), expert_parallel_size=ep, **GLOO, **SMALL)
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
    assert stats1["mesh_devices"] == 1
    assert stats["mesh_devices"] == 2 and stats["tensor_parallel"] == 1
    assert re.search(r"vllm:tensor_parallel_degree\{[^}]*\} 1(\.0)?\b", m)
    rows = re.findall(r'vllm:kv_pool_shard_bytes\{[^}]*device="([^"]+)"[^}]*\} (\d+)', m)
    assert [d for d, _ in rows] == ["cpu:0/dp0ep0tp0", "cpu:0/dp0ep1tp0"] and len({v for _, v in rows}) == 1
