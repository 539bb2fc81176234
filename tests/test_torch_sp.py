"""Sequence-parallel serving of the port (parallel/ring_attention.py, the
sequence group of parallel/group.py, the llama forward's token split, the
decode kernel's sp mapping) against the JAX package on its virtual 8-device
CPU mesh (tests/test_parallel.py TestRingAttention,
tests/test_parallel_serving.py TestSequenceParallelServing).

- The ring: ``ring_attention`` (offset mode), ``ring_attention_local`` with
  explicit positions and ``ring_attention_serving`` with T and S that sp
  does not divide, each run over gloo rank processes at sp 2 and sp 4,
  against the JAX functions on an sp mesh at f32 2e-5.
- The forward: the JAX ``llama.forward`` with ``attn_impl="pallas_interpret"``
  on an sp 2 and an sp 2 x tp 2 mesh (at T = 1 its sharded Pallas decode
  with sp mapped, on a prefill chunk its ring) against a port engine's
  runner step across gloo ranks on the same random pools: logits and
  written slots within 2e-5, every other slot byte for byte as it was.
- Engines on ``llama-debug-4kv-f32`` shaped like the JAX tests' ``_cfg``:
  the JAX tests' prompts and one of three chunks give the JAX engine's
  greedy ids at the same mesh; the sp replicas' pools are byte-identical;
  the layout and rank stats count the sequence ranks; sp 2 with
  ``decode_pipeline=2`` and a CPU tier gives sp 1's ids, and a prompt whose
  pages were spilled and restored repeats them.
- The refusals: in the JAX package's words (Gemma-2 and OPT at sp, int8 at
  sp), in the port's (device KV transfer; a MoE model at sp, with ep ranks
  too, is served: tests/test_torch_moe_seq.py; sp beside dp and pp ranks
  and with speculative decoding: tests/test_torch_seq_compose.py and
  tests/test_torch_spec_ranks.py).
"""

import asyncio
import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel import compat
from production_stack_tpu.parallel import ring_attention as jring
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
from production_stack_tpu_torch.engine.runner import RANK_STATS, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel import ring_attention as tring
from production_stack_tpu_torch.parallel.group import device_labels, parse_device_ids
from test_torch_lora_ranks import rank_runner

F32 = dict(atol=2e-5, rtol=2e-5)
MODEL = "llama-debug-4kv-f32"  # 2 layers, NH 8, KH 4
# the JAX tests' _cfg shapes
SMALL = dict(max_model_len=128, num_pages=64, page_size=8, max_num_seqs=4, decode_steps=2, prefill_chunk=32)
GLOO = dict(tp_backend="gloo")
MESHES = [(2, 1), (2, 2)]  # (sp, tp)
MESH_IDS = ["sp2", "sp2tp2"]
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


# -- the ring over gloo rank processes -------------------------------------------

_RING_RANK = """
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from production_stack_tpu_torch.parallel import ring_attention as ra
from production_stack_tpu_torch.parallel.group import TPGroup

rank, sp = {rank}, {sp}
g = TPGroup.init(rank, 1, 1, "gloo", [torch.device("cpu")] * sp, "tcp://127.0.0.1:{port}", sp=sp)
t = {{k: torch.from_numpy(v) for k, v in np.load({inputs!r}).items()}}
seq = g.seq
res = {{"offset": ra.ring_attention(seq, t["q"], t["k"], t["v"], t["q_pos"], t["kv_lens"]).numpy()}}
res["explicit"] = ra.ring_attention_local(
    seq, ra.token_slice(t["q"], seq), ra.token_slice(t["ek"], seq).contiguous(),
    ra.token_slice(t["ev"], seq).contiguous(), ra.token_slice(t["e_qpos"], seq), None,
    ra.token_slice(t["e_kvpos"], seq).contiguous()).numpy()
q = ra.token_slice(ra.pad_tokens(t["sq"], sp), seq)
qpos = ra.token_slice(ra.pad_tokens(t["s_qpos"], sp, value=-1), seq)
res["serving"] = ra.ring_attention_serving(seq, q, t["sk"], t["sv"], qpos, t["s_kvpos"]).numpy()
res["ring"] = np.array([g.ring_calls, g.ring_bytes, g.calls, g.bytes])
np.savez({out!r}, **res)
g.close()
"""


def _ring_inputs():
    """f32 inputs at B 2, NH 4, KH 2, D 32: offset mode at T = S = 24;
    explicit positions as a chunk after pool slots (the serving path's
    ``stale_kv_positions``: 16 pool slots, the rows' histories 10 and 3,
    stale slots -1, row 1's chunk padded after 19 tokens), at T = 24 and
    at T = 21 (S = 37, which neither sp divides)."""
    rng = np.random.RandomState(31)
    B, NH, KH, D = 2, 4, 2, 32

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    def explicit(T, n1):
        hist = np.array([10, 3])
        pool = np.where(np.arange(16)[None, :] < hist[:, None], np.arange(16)[None, :], -1)
        chunk = hist[:, None] + np.arange(T)[None, :]
        chunk[1, n1:] = -1
        return chunk.astype(np.int32), np.concatenate([pool, chunk], axis=1).astype(np.int32)

    out = dict(q=r(B, 24, NH, D), k=r(B, 24, KH, D), v=r(B, 24, KH, D),
               q_pos=np.tile(np.arange(24, dtype=np.int32), (B, 1)), kv_lens=np.array([24, 14], np.int32))
    out["e_qpos"], out["e_kvpos"] = explicit(24, 19)
    out["ek"], out["ev"] = r(B, 40, KH, D), r(B, 40, KH, D)
    out["s_qpos"], out["s_kvpos"] = explicit(21, 17)
    out["sq"], out["sk"], out["sv"] = r(B, 21, NH, D), r(B, 37, KH, D), r(B, 37, KH, D)
    return out


@pytest.fixture(scope="module")
def ring_runs():
    """The port's ring at sp 2 and sp 4, every rank a process over gloo
    (both sets at once), on _ring_inputs; each rank's outputs."""
    inp = _ring_inputs()
    ports = {sp: free_port() for sp in (2, 4)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.npz")
        np.savez(path, **inp)
        procs = {}
        for sp in (2, 4):
            for rank in range(sp):
                out = os.path.join(tmp, f"sp{sp}_r{rank}.npz")
                script = _RING_RANK.format(root=ROOT, rank=rank, sp=sp, port=ports[sp], inputs=path, out=out)
                procs[(sp, rank)] = (subprocess.Popen([sys.executable, "-c", script], stderr=subprocess.PIPE,
                                                      text=True), out)
        res = {}
        for key, (p, out) in procs.items():
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            res[key] = dict(np.load(out))
    return inp, res


def _jax_local_explicit(mesh, q, k, v, q_pos, kv_pos):
    """The JAX ``ring_attention_local`` with explicit positions, its inputs
    sharded over sp."""
    fn = functools.partial(jring.ring_attention_local, kv_lens=None, axis_name="sp")
    seq = P(None, "sp", None, None)
    return compat.shard_map(lambda q, k, v, qp, kp: fn(q, k, v, qp, kv_positions=kp), mesh,
                            in_specs=(seq, seq, seq, P(None, "sp"), P(None, "sp")), out_specs=seq,
                            check=False)(q, k, v, q_pos, kv_pos)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_the_jax_ring_in_offset_mode(eight_devices, ring_runs, sp):
    inp, res = ring_runs
    mesh = make_mesh(sp=sp)
    want = np.asarray(jring.ring_attention(mesh, *(jnp.asarray(inp[k]) for k in ("q", "k", "v", "q_pos",
                                                                                  "kv_lens"))))
    for rank in range(sp):
        np.testing.assert_allclose(res[(sp, rank)]["offset"], want, **F32)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_local_matches_the_jax_body_with_explicit_positions(eight_devices, ring_runs, sp):
    """Each rank's output is its token slice of the JAX per-shard body's
    under shard_map, the positions rotating with their blocks; every rank
    rotated sp - 1 times, counted under ``ring_*``."""
    inp, res = ring_runs
    want = np.asarray(_jax_local_explicit(make_mesh(sp=sp), *(jnp.asarray(inp[k]) for k in
                                                              ("q", "ek", "ev", "e_qpos", "e_kvpos"))))
    got = np.concatenate([res[(sp, r)]["explicit"] for r in range(sp)], axis=1)
    np.testing.assert_allclose(got, want, **F32)
    for rank in range(sp):
        ring_calls, ring_bytes, calls, nbytes = res[(sp, rank)]["ring"]
        assert ring_calls > 0 and ring_bytes > 0 and calls >= ring_calls and nbytes >= ring_bytes


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_serving_pads_t_and_s_as_the_jax_function(eight_devices, ring_runs, sp):
    """T = 21 and S = 37 pad to multiples of sp (pads at position -1): the
    ranks' rows joined, less the padding, are the JAX function's output."""
    inp, res = ring_runs
    mesh = make_mesh(sp=sp)  # inside jit, as the JAX forward calls it (a partial-manual shard_map)
    want = np.asarray(jax.jit(functools.partial(jring.ring_attention_serving, mesh))(
        *(jnp.asarray(inp[k]) for k in ("sq", "sk", "sv", "s_qpos", "s_kvpos"))))
    got = np.concatenate([res[(sp, r)]["serving"] for r in range(sp)], axis=1)
    assert got.shape[1] == 21 + (-21) % sp
    np.testing.assert_allclose(got[:, :21], want, **F32)


def test_one_block_without_a_group_is_plain_attention():
    """``group`` None runs the ring's one block: ops.attention.flash_attention's
    output on the same inputs (explicit positions, a poisoned stale slot
    skipped)."""
    from production_stack_tpu_torch.ops.attention import flash_attention

    inp = {k: torch.from_numpy(v) for k, v in _ring_inputs().items()}
    k, v = inp["ek"].clone(), inp["ev"].clone()
    k[1, 5], v[1, 5] = float("nan"), float("nan")  # row 1 holds 3 tokens of history: slot 5 is stale
    got = tring.ring_attention_local(None, inp["q"], k, v, inp["e_qpos"], None, inp["e_kvpos"])
    want = flash_attention(inp["q"], k, v, inp["e_qpos"], None, kv_positions=inp["e_kvpos"])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **F32)


# -- the forward at one step, and the engines -----------------------------------------


def _pools(cfg):
    rng = np.random.RandomState(8)
    shape = (cfg.num_layers, SMALL["num_pages"], SMALL["page_size"], cfg.num_kv_heads, cfg.head_dim)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _step_inputs(kind):
    """Eight rows: a decode step after ragged histories (one empty), or a
    prefill chunk of up to 16 on top of them (three rows ragged, one of a
    single token)."""
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
    """The step through every rank (set_pages loads every sp replica
    first); returns the logits, the pools read back after it and the
    ranks' pool digests."""
    r = engine.runner
    pids = list(range(kp.shape[1]))
    r.set_pages(pids, [kp[:, i] for i in pids], [vp[:, i] for i in pids])
    logits = r.step(tinp)[1].numpy()
    k, v = r.get_pages(pids)
    digests = [bytes(d) for d in r.replica_digest()]
    r.reset_kv()
    return logits, np.stack(k, axis=1), np.stack(v, axis=1), digests


def _written_slots(common, pool):
    """[pages, page_size]: the pool slots a step's positions write."""
    page = SMALL["page_size"]
    written = np.zeros(pool.shape[1:3], bool)
    for b, row in enumerate(common["positions"]):
        for p_ in row[row >= 0]:
            written[common["page_table"][b, p_ // page], p_ % page] = True
    return written


def _prompts(tok):
    """The JAX tests' prompts, and one of three 32-token prefill chunks."""
    texts = ["sequence parallel serving " * 3, "short", "ring attention with tensor parallelism",
             "a prompt long enough for three chunks of the ring, " * 2]
    return [tok.encode(t) for t in texts]


def _gen_all(engine, prompts, sp=SamplingParams, n=8):
    async def one(i, ids):
        out = []
        async for o in engine.generate(f"sp{i}-{time.monotonic_ns()}", prompt_token_ids=ids,
                                       params=sp(max_tokens=n, temperature=0.0, ignore_eos=True)):
            out += o.token_ids
        return out

    async def run():
        return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))

    return asyncio.run(run())


def _same_place_digests_equal(digests, tp):
    """The ranks of one tp place t, r = s * tp + t, are the sp replicas of
    one pool shard."""
    return all(len({digests[r] for r in range(t, len(digests), tp)}) == 1 for t in range(tp))


@pytest.fixture(scope="module")
def sp_runs(eight_devices):
    """The f32 llama twin at sp 2 and sp 2 x tp 2 in both packages, one
    port engine with ranks at a time: the forward of a decode step and of a
    prefill chunk against the JAX forward on the same mesh, then both
    engines' greedy tokens of the prompts, the layout, the rank stats, the
    replica digests and a page round trip."""
    cfg = jllama.PRESETS[MODEL]
    kp, vp = _pools(cfg)
    out = {"pools": (kp, vp)}
    for mesh in MESHES:
        sp, tp = mesh
        res = out[mesh] = {}
        jeng = JaxEngine(JaxEngineConfig(model=MODEL, sequence_parallel_size=sp, tensor_parallel_size=tp, **SMALL))
        peng = None
        try:
            jparams = jax.device_get(jeng.runner.params)
            out.setdefault("jparams", jparams)
            peng = LLMEngine(EngineConfig(model=MODEL, sequence_parallel_size=sp, tensor_parallel_size=tp, **GLOO,
                                          **SMALL), device="cpu", params=params_from_jax(jparams, tllama.PRESETS[MODEL]))
            jmesh = make_mesh(sp=sp, tp=tp)
            for kind in ("decode", "prefill"):
                common, tinp = _step_inputs(kind)
                res[kind] = (_port_forward(peng, tinp, kp, vp), _jax_forward(jparams, cfg, jmesh, common, kp, vp),
                             common)
            prompts = _prompts(peng.tokenizer)
            out.setdefault("prompts", prompts)
            jeng.start()
            peng.start()
            peng.runner.rank_stats(reset=True)
            res["jax"] = _gen_all(jeng, prompts, JaxSamplingParams)
            res["port"] = _gen_all(peng, prompts)
            s = peng.stats()
            res["shape"] = (s["mesh_devices"], s["tensor_parallel"], peng.kv.num_pages,
                            peng.runner.kv_pool_shard_layout(), peng.runner.rank_stats(), peng.runner.k_pages.shape)
            res["digests"] = [bytes(d) for d in peng.runner.replica_digest()]
            pid = next(iter(peng.kv.hash_to_page.values()))
            page = [x[0] for x in peng.runner.get_pages([pid])]
            peng.runner.set_pages([1], [page[0]], [page[1]])
            res["page"] = (page, [x[0] for x in peng.runner.get_pages([1])],
                           [bytes(d) for d in peng.runner.replica_digest()])
        finally:
            jeng.stop()
            if peng is not None:
                peng.stop()
    return out


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_forward_matches_the_jax_forward_at_sp(sp_runs, mesh, kind):
    """One step through the port's sequence ranks against the JAX forward
    on the same mesh and pools (at T = 1 its sharded Pallas decode in
    interpret mode with sp mapped, on the chunk its ring): f32 logits
    within 2e-5, the written slots within 2e-5, every other slot of every
    layer's pool byte for byte the initial pool's, and every sp replica's
    pools the same bytes after the step."""
    (tl, tk, tv, digests), (jl, jk, jv), common = sp_runs[mesh][kind]
    kp, vp = sp_runs["pools"]
    np.testing.assert_allclose(tl, jl, **F32)
    written = _written_slots(common, kp)
    assert written.sum() == (common["positions"] >= 0).sum()
    for got, want, before in ((tk, jk, kp), (tv, jv, vp)):
        np.testing.assert_allclose(got, want, **F32)
        assert np.array_equal(got[:, ~written].view(np.uint32), before[:, ~written].view(np.uint32))
        assert not np.array_equal(got[:, written], before[:, written])
    assert _same_place_digests_equal(digests, mesh[1])


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_greedy_tokens_match_the_jax_engine_at_the_same_mesh(sp_runs, mesh):
    jax_ids, port_ids = sp_runs[mesh]["jax"], sp_runs[mesh]["port"]
    assert port_ids == jax_ids
    assert [len(x) for x in port_ids] == [8] * 4
    assert max(len(p) for p in sp_runs["prompts"]) > 2 * SMALL["prefill_chunk"]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_the_sp_replicas_hold_the_same_pool_bytes(sp_runs, mesh):
    """After serving, and after a page written back: the sequence ranks of
    each tp place hold byte-identical pools (and the tp places differ)."""
    _, tp = mesh
    for digests in (sp_runs[mesh]["digests"], sp_runs[mesh]["page"][2]):
        assert _same_place_digests_equal(digests, tp)
        assert len(set(digests)) == tp


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_the_layout_and_rank_stats_count_the_sequence_ranks(sp_runs, mesh):
    """mesh_devices counts sp x tp; each rank holds 1/tp of every page
    (its tp place's heads, every layer); every rank ran the decode kernel's
    plain version and no prefill kernel (chunks go through the ring), and
    every rank's sequence group carried the chunks' K/V (``ring_*``)."""
    sp, tp = mesh
    devices, tp_stat, pages, layout, stats, pool = sp_runs[mesh]["shape"]
    cfg = tllama.PRESETS[MODEL]
    assert devices == sp * tp and tp_stat == tp and pages == SMALL["num_pages"]
    labels = device_labels([torch.device("cpu")] * (sp * tp), sp=sp)
    assert [label for label, _ in layout] == labels
    assert labels[1] == ("cpu:0/sp0tp1" if tp > 1 else "cpu:0/sp1tp0")
    whole = 2 * cfg.num_layers * pages * SMALL["page_size"] * cfg.num_kv_heads * cfg.head_dim * 4
    assert {b for _, b in layout} == {whole // tp}
    assert pool == (cfg.num_layers, pages, SMALL["page_size"], cfg.num_kv_heads // tp, cfg.head_dim)
    col = RANK_STATS.index
    assert stats.shape == (sp * tp, len(RANK_STATS))
    for row in stats:
        assert row[col("decode_attention_ref")] > 0
        assert row[col("prefill_attention_ref")] == 0 and row[col("kv_page_write_ref")] == 0
        assert row[col("ring_calls")] > 0 and row[col("ring_bytes")] > 0
        assert row[col("collective_calls")] >= row[col("ring_calls")]
        assert row[col("relay_calls")] == 0
    # every sequence rank runs every decode step whole: the same count on every rank
    assert len({row[col("decode_attention_ref")] for row in stats}) == 1


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_a_page_read_from_an_sp_replica_writes_back_byte_for_byte(sp_runs, mesh):
    page, back, _ = sp_runs[mesh]["page"]
    cfg = tllama.PRESETS[MODEL]
    assert page[0].shape == (cfg.num_layers, SMALL["page_size"], cfg.num_kv_heads, cfg.head_dim)
    assert [x.tobytes() for x in back] == [x.tobytes() for x in page]


def test_a_chained_sp2_engine_with_a_cpu_tier_gives_sp1_ids_and_restores_spilled_pages(eight_devices, sp_runs):
    """sp 2 at decode_pipeline 2 (chained bursts, each decoded whole on
    both sequence ranks) on a 28-page pool with a CPU tier: the prompts
    give sp 1's ids (the JAX sp 2 engine's, by the test above); after
    fillers evict the long prompt's pages, it runs again from the CPU tier
    (restored into both sp replicas) with the same ids."""
    prompts = sp_runs["prompts"]
    params = params_from_jax(sp_runs["jparams"], tllama.PRESETS[MODEL])
    one = LLMEngine(EngineConfig(model=MODEL, **SMALL), device="cpu", params=params)
    one.start()
    try:
        want = _gen_all(one, prompts)
    finally:
        one.stop()
    eng = LLMEngine(EngineConfig(model=MODEL, sequence_parallel_size=2, decode_pipeline=2, kv_offload_cpu_gb=0.001,
                                 kv_offload_max_io_pages=0, **GLOO, **dict(SMALL, num_pages=28)), device="cpu",
                    params=params)
    eng.start()
    try:
        got = _gen_all(eng, prompts)
        rng = np.random.RandomState(5)
        for _ in range(4):  # churn the pool so the long prompt's pages are spilled
            _gen_all(eng, [[int(x) for x in rng.randint(1, 512, 60)]], n=4)
        again = _gen_all(eng, prompts[3:])
        s = eng.stats()
        digests = [bytes(d) for d in eng.runner.replica_digest()]
    finally:
        eng.stop()
    assert got == want == sp_runs[(2, 1)]["port"]
    assert again == want[3:]
    assert s["kv_offload_saved_pages_total"] > 0 and s["kv_offload_loaded_pages_total"] > 0
    assert s["kv_offload_hit_pages_total"] > 0 and s["kv_corrupt_pages_total"] == 0
    assert digests[0] == digests[1]


WINDOWED = "mistral-debug-f32"  # llama-debug with a window of 8, in f32


@pytest.fixture(scope="module")
def window_runs(eight_devices):
    """An f32 mistral-debug (window 8) in both packages, the JAX engine's
    weights at sp 2 and in port engines at sp 1 and sp 2: the forward of
    a prefill chunk on both sides at sp 2 (the chunk takes flash_attention
    with explicit positions on the rank's queries, as the JAX forward falls
    back from the ring), then the greedy ids of a prompt of three chunks,
    far past the window, from all three engines."""
    ids = [[int(x) for x in np.random.RandomState(3).randint(1, 512, 70)]]
    common, tinp = _step_inputs("prefill")
    out = {"common": common}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jllama.PRESETS, WINDOWED, dataclasses.replace(jllama.PRESETS["mistral-debug"], dtype=jnp.float32))
        mp.setitem(tllama.PRESETS, WINDOWED, dataclasses.replace(tllama.PRESETS["mistral-debug"],
                                                                 dtype=torch.float32))
        cfg = jllama.PRESETS[WINDOWED]
        kp, vp = _pools(cfg)
        out["pools"] = (kp, vp)
        jeng = JaxEngine(JaxEngineConfig(model=WINDOWED, sequence_parallel_size=2, **SMALL))
        try:
            jparams = jax.device_get(jeng.runner.params)
            out["jax_step"] = _jax_forward(jparams, cfg, make_mesh(sp=2), common, kp, vp)
            jeng.start()
            out["jax"] = _gen_all(jeng, ids, JaxSamplingParams, n=6)
        finally:
            jeng.stop()
        params = params_from_jax(jparams, tllama.PRESETS[WINDOWED])
        for sp in (1, 2):
            eng = LLMEngine(EngineConfig(model=WINDOWED, sequence_parallel_size=sp, **GLOO, **SMALL), device="cpu",
                            params=params)
            try:
                if sp == 2:
                    out["port_step"] = _port_forward(eng, tinp, kp, vp)
                eng.start()
                out[sp] = _gen_all(eng, ids, n=6)
            finally:
                eng.stop()
    return out


def test_a_windowed_chunk_at_sp2_matches_the_jax_forward(window_runs):
    """The windowed chunk at sp 2 against the JAX forward on an sp 2 mesh
    and the same pools: logits and written slots within 2e-5, every other
    slot byte for byte the initial pool's, both sp replicas the same."""
    tl, tk, tv, digests = window_runs["port_step"]
    jl, jk, jv = window_runs["jax_step"]
    common, (kp, vp) = window_runs["common"], window_runs["pools"]
    np.testing.assert_allclose(tl, jl, **F32)
    written = _written_slots(common, kp)
    for got, want, before in ((tk, jk, kp), (tv, jv, vp)):
        np.testing.assert_allclose(got, want, **F32)
        assert np.array_equal(got[:, ~written].view(np.uint32), before[:, ~written].view(np.uint32))
    assert digests[0] == digests[1]


def test_a_windowed_chunk_at_sp2_matches_one_rank(window_runs):
    """The greedy ids of the three-chunk prompt at sp 2 equal sp 1's and
    the JAX sp 2 engine's."""
    assert window_runs[2] == window_runs[1] == window_runs["jax"] and len(window_runs[2][0]) == 6


def test_a_chunk_of_2048_tokens_runs_whole_and_sp2_gives_sp1_ids():
    """prefill_chunk 2,048 (the chip smoke's sp setting) past the JAX
    scheduler's top chunk bucket of 1,024: the port's buckets reach 8,192
    (a prefill_chunk above that is refused by name), so a 2,500-token
    prompt runs as a chunk of 2,048 and one of 452, and the greedy ids at
    sp 2 equal sp 1's."""
    check_supported(EngineConfig(prefill_chunk=8192))
    with pytest.raises(ValueError, match="prefill_chunk 16384 above 8192"):
        check_supported(EngineConfig(prefill_chunk=16384))
    ids = [[int(x) for x in np.random.RandomState(11).randint(1, 512, 2500)]]
    cfg = dict(max_model_len=4096, num_pages=256, page_size=16, prefill_chunk=2048, decode_steps=2)
    out = {}
    for sp in (1, 2):
        eng = LLMEngine(EngineConfig(model=MODEL, sequence_parallel_size=sp, **GLOO, **cfg), device="cpu")
        eng.start()
        try:
            eng.runner.rank_stats(reset=True)
            out[sp] = _gen_all(eng, ids, n=4)
            steps = eng.runner.rank_stats()[0, RANK_STATS.index("steps")]
        finally:
            eng.stop()
        assert steps >= 3  # two chunks and the decode
    assert out[2] == out[1] and len(out[2][0]) == 4


def test_seeded_and_carried_weights_are_whole_on_every_sequence_rank():
    """Nothing splits over sp: a sequence rank's model (seeded, or from a
    whole parameter dict) is the sp 1 model, bit for bit."""
    import types

    seq = types.SimpleNamespace(rank=1, size=2)
    _, _, one = load_model("llama-debug-4kv", device="cpu", seed=7)
    _, _, rank = load_model("llama-debug-4kv", device="cpu", seed=7, seq=seq)
    assert rank.seq is seq
    whole = dict(one.named_parameters())
    for name, prm in rank.named_parameters():
        assert torch.equal(prm.detach(), whole[name].detach()), name
    _, _, carried = load_model("llama-debug-4kv", device="cpu", seq=seq,
                               params={k: v.detach() for k, v in whole.items()})
    assert all(torch.equal(p.detach(), whole[n].detach()) for n, p in carried.named_parameters())


def test_labels_and_device_ids_count_the_sequence_ranks():
    cpu = torch.device("cpu")
    assert device_labels([cpu] * 2, sp=2) == ["cpu:0/sp0tp0", "cpu:0/sp1tp0"]
    assert device_labels([cpu] * 4, sp=2)[2] == "cpu:0/sp1tp0"
    assert parse_device_ids("0,0,0,0", 4) == [0] * 4
    with pytest.raises(ValueError, match="sequence_parallel_size x"):
        parse_device_ids("0,0", 4)
    check_supported(EngineConfig(sequence_parallel_size=2, tensor_parallel_size=2, **GLOO,
                                 tp_device_ids="0,0,0,0"))
    with pytest.raises(ValueError, match="one device index"):
        check_supported(EngineConfig(sequence_parallel_size=2, tensor_parallel_size=2, **GLOO, tp_device_ids="0,0"))


# -- refusals -----------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    dict(model="gemma2-debug", sequence_parallel_size=2),
    dict(model="opt-debug", sequence_parallel_size=2),
    dict(model="llama-debug", sequence_parallel_size=2, kv_cache_dtype="int8"),
], ids=["gemma2", "opt", "int8"])
def test_sp_refusals_in_the_jax_engines_words(eight_devices, overrides):
    """The port refuses what the JAX engine refuses, with its message."""
    kw = dict(max_model_len=128, num_pages=16, page_size=8)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(JaxEngineConfig(**overrides, **kw))
    with pytest.raises(ValueError) as terr:
        LLMEngine(EngineConfig(**overrides, **kw, **GLOO), device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("overrides,match", [
    (dict(model="llama-debug", sequence_parallel_size=2, kv_transfer_device=True), "device KV transfer"),
    (dict(model="llama-debug", sequence_parallel_size=0), "sequence_parallel_size must be >= 1"),
], ids=["device-kv", "sp-0"])
def test_unserved_sp_combinations_are_refused_by_name(overrides, match):
    """What stays refused at sp. A MoE model at sp, with or without ep
    ranks, is served (tests/test_torch_moe_seq.py), and sp beside dp and pp
    ranks and with speculative decoding (tests/test_torch_seq_compose.py,
    whose ``test_once_refused_compositions_are_served`` holds the cases
    this test refused before)."""
    with pytest.raises(ValueError, match=match):
        LLMEngine(EngineConfig(**overrides, max_model_len=128, num_pages=16, page_size=8, **GLOO), device="cpu")


@pytest.mark.parametrize("tp", [1, 2])
def test_lora_at_sp_is_served_with_replicated_buffers(tp):
    """Once refused, now served: the config passes check_supported, and
    both sequence ranks of a tp place hold its part of every slot buffer
    (tests/test_torch_lora_stages.py serves sp 2 x tp 2 against the JAX
    engine)."""
    check_supported(EngineConfig(model="llama-debug", sequence_parallel_size=2, tensor_parallel_size=tp,
                                 enable_lora=True, **GLOO))
    for s in range(2):
        layer = rank_runner(s=s, sp=2, t=tp - 1, tp=tp).lora["layers"][0]
        assert layer["b_wv"].shape == (3, 16, 128 // tp) and layer["a_w_down"].shape == (3, 256 // tp, 16)
