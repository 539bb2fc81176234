"""KV heads shared by tp ranks in the port (parallel/tp.py's shared KV heads:
tp a multiple of the model's KV heads, rank t holding KV head t // (tp / KH)
whole) against the JAX package on its virtual 8-device CPU mesh, where the
JAX engine replicates the whole pool (production_stack_tpu/engine/runner.py
``_kv_sharding``) and takes its XLA attention.

On an f32 twin of llama-debug (NH 4, KH 2: one query head and one shared KV
head a rank at tp 4; the preset replaced in both packages, the spawned
ranks take the leader's config), with the JAX engine's weights:

- a two-row prefill chunk's logits at tp 4 within 2e-5 of the JAX runner's
  at tp 4, and greedy tokens of two prompts equal to the JAX engine's at tp
  4 and to the port's at tp 1;
- each rank's pool holds one KV head, 1/KH of the whole page bytes, and the
  two ranks of a share hold the same bytes; a gathered page has KH heads
  (one replica of each, not tp), layer 0 byte for byte tp 1's and every
  layer within 2e-5; tp 1's page and its int8 blob written into tp 4 read
  back byte for byte, and a tp 4 int8 page's blob is tp 1's layer 0 byte
  for byte; the gathered weights are the whole model's;
- a LoRA adapter at tp 4 (tests/test_torch_lora_ranks.run_mesh): logits,
  tokens, and the slot buffers joined back bit-equal to one rank's and to
  the JAX runner's;
- a rank's decode (``decode_attention_sharded``, plain) at Qwen2.5-1.5B's
  rank shape (12 query heads over 2 KV heads at tp 4: 3 query heads on one
  KV head) against the JAX ``paged_attention_decode`` on the whole heads,
  fp and int8 pools, with and without the burst window;
- the split helpers at shared heads, the LoRA buffers joined over the ranks
  (``join_lora``), Gemma-2 at tp 4 against the JAX engine;
- a tp that neither divides the KV heads nor is a multiple of them is
  refused by name.
"""

import asyncio
import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import gemma2 as jgemma
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops.attention import paged_attention_decode as jax_paged_decode
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.runner import StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvoffload.serde import get_serde
from production_stack_tpu_torch.models import gemma2 as tgemma
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention_sharded
from production_stack_tpu_torch.parallel import tp as tpmod
from test_torch_lora_ranks import ATTN, MAX_RANK, assert_lora_bit_equal, check_mesh, one_rank_lora, rank_runner, \
    run_mesh, write_adapters

F32 = dict(atol=2e-5, rtol=2e-5)
MODEL = "llama-debug-f32"  # NH 4, KH 2, D 32, 2 layers
SMALL = dict(max_model_len=128, num_pages=64, page_size=8, max_num_seqs=4, decode_steps=2, prefill_chunk=32)
GLOO = dict(tp_backend="gloo")
TP = 4
GATHERED = ["layers.0.wk", "layers.1.wv", "layers.0.wq", "layers.1.wo", "embed"]


@pytest.fixture(scope="module")
def twin():
    """The f32 twin of llama-debug, registered in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jllama.PRESETS, MODEL, dataclasses.replace(jllama.PRESETS["llama-debug"], dtype=jnp.float32))
        mp.setitem(tllama.PRESETS, MODEL, dataclasses.replace(tllama.PRESETS["llama-debug"], dtype=torch.float32))
        yield tllama.PRESETS[MODEL]


def _gen(engine, ids, n=8, sp=SamplingParams):
    async def run():
        out = []
        async for o in engine.generate(f"s-{time.monotonic_ns()}", prompt_token_ids=ids,
                                       params=sp(max_tokens=n, temperature=0.0, ignore_eos=True)):
            out += o.token_ids
        return out

    return asyncio.run(run())


def _prompts(vocab):
    rng = np.random.RandomState(11)
    return [[int(x) for x in rng.randint(1, vocab, n)] for n in (19, 45)]


def _prefill_inputs(vocab):
    """One two-row prefill chunk (row 1 ragged) on fresh pages."""
    rng = np.random.RandomState(3)
    pos = np.full((2, 16), -1, np.int32)
    pos[0], pos[1, :11] = np.arange(16), np.arange(11)
    common = dict(input_ids=rng.randint(0, vocab, (2, 16)).astype(np.int32), positions=pos,
                  page_table=np.array([[1, 2], [3, 4]], np.int32), kv_lens=np.array([16, 11], np.int32),
                  temperature=np.zeros(2, np.float32), top_k=np.zeros(2, np.int32), top_p=np.ones(2, np.float32))
    return JaxStepInput(**common), StepInput(**common)


def _port(params, tp, **kw):
    return LLMEngine(EngineConfig(model=MODEL, tensor_parallel_size=tp, **GLOO, **SMALL, **kw), device="cpu",
                     params=params)


def _page(engine, prompt, quant=False):
    """The first full page of ``prompt`` (every layer and KV head) as the
    engine gathers it: (k, v) or, int8, (k, v, k scales, v scales)."""
    h = next(iter(engine.kv.hash_to_page))
    get = engine.runner.get_pages_quant if quant else engine.runner.get_pages
    return [x[0] for x in get([engine.kv.hash_to_page[h]])]


@pytest.fixture(scope="module")
def shared_runs(eight_devices, twin):
    """The JAX engine at tp 4 and port engines at tp 1 and tp 4 (fp and
    int8 pools) on the JAX engine's weights, one port engine with ranks at a
    time; what the tests read."""
    prompts = _prompts(twin.vocab_size)
    jinp, tinp = _prefill_inputs(twin.vocab_size)
    out = {}
    jeng = JaxEngine(JaxEngineConfig(model=MODEL, tensor_parallel_size=TP, **SMALL))
    try:
        out["params"] = params = params_from_jax(jax.device_get(jeng.runner.params), twin)
        out["jax_logits"] = np.asarray(jeng.runner.step(jinp)[1])
        jeng.runner.reset_kv()
        jeng.start()
        out["jax"] = [_gen(jeng, p, sp=JaxSamplingParams) for p in prompts]
    finally:
        jeng.stop()
    for kv in ("auto", "int8"):
        quant = kv == "int8"
        for tp in (1, TP):
            eng = _port(params, tp, kv_cache_dtype=kv)
            res = out[(kv, tp)] = {}
            try:
                if not quant:
                    res["logits"] = eng.runner.step(tinp)[1].numpy()
                    eng.runner.reset_kv()
                eng.start()
                res["ids"] = [_gen(eng, p) for p in prompts]
                res["page"] = _page(eng, prompts[0], quant)
                res["layout"] = (eng.runner.kv_pool_shard_layout(), tuple(eng.runner.k_pages.shape))
                res["digest"] = eng.runner.replica_digest()
                if tp == TP:
                    # tp 1's page (its blob, through the serde) written into every rank and read back
                    one = out[(kv, 1)]["page"]
                    if quant:
                        k, v, sk, sv = one
                        qk, sk, qv, sv = get_serde("int8page").deserialize_quant(
                            get_serde("int8page").serialize_quant(k, sk, v, sv))
                        eng.runner.set_pages_quant([7], [qk], [qv], [sk], [sv])
                        res["restored"] = [x[0] for x in eng.runner.get_pages_quant([7])]
                    else:
                        page = get_serde("naive").deserialize(get_serde("naive").serialize(*one))
                        eng.runner.set_pages([7], *([x] for x in page))
                        res["restored"] = [x[0] for x in eng.runner.get_pages([7])]
                        res["gathered"] = eng.runner.gathered_params(GATHERED)
                    res["digest_after_restore"] = eng.runner.replica_digest()
            finally:
                eng.stop()
    return out


def test_prefill_logits_at_tp4_match_the_jax_runner(shared_runs):
    """A two-row f32 chunk: tp 4's logits within 2e-5 of the JAX runner's
    at tp 4 (its pool replicated, its XLA attention), and of tp 1's."""
    got = shared_runs[("auto", TP)]["logits"]
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, shared_runs["jax_logits"], **F32)
    np.testing.assert_allclose(got, shared_runs[("auto", 1)]["logits"], **F32)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_greedy_tokens_at_tp4_match_the_jax_engine_and_tp1(shared_runs, kv):
    ids = shared_runs[(kv, TP)]["ids"]
    assert ids == shared_runs[(kv, 1)]["ids"]
    assert all(len(x) == 8 for x in ids)
    if kv == "auto":
        assert ids == shared_runs["jax"]


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_each_rank_holds_one_kv_head_and_a_share_holds_the_same_bytes(shared_runs, kv):
    """Each of the four ranks holds one KV head ([L, P, page, 1, D]), so
    1/KH of tp 1's pool bytes, and ranks 0, 1 (head 0) and 2, 3 (head 1)
    hold byte-identical pools, the two heads different ones."""
    (one, whole), = shared_runs[(kv, 1)]["layout"][0]
    layout, shape = shared_runs[(kv, TP)]["layout"]
    assert [d for d, _ in layout] == [f"cpu:0/tp{r}" for r in range(TP)]
    assert {b for _, b in layout} == {whole // 2}
    assert shape[3] == 1
    for key in ("digest", "digest_after_restore"):
        d = [bytes(x) for x in shared_runs[(kv, TP)][key]]
        assert d[0] == d[1] and d[2] == d[3] and d[0] != d[2], key


def test_a_gathered_page_is_tp1s_one_replica_a_head(shared_runs):
    """A registered page of the same prompt gathered at tp 4 has KH = 2
    heads (not tp = 4 copies), layer 0 (before any all-reduce) byte for byte
    tp 1's, every layer within 2e-5; tp 1's page written into tp 4 through
    the naive serde reads back byte for byte, and the gathered weights (a
    shared head's wk and wv among them) are the whole model's."""
    tpage, onepage = shared_runs[("auto", TP)]["page"], shared_runs[("auto", 1)]["page"]
    for got, want in zip(tpage, onepage):
        assert got.shape == want.shape == (2, SMALL["page_size"], 2, 32) and got.dtype == np.float32
        assert got[0].tobytes() == want[0].tobytes()
        np.testing.assert_allclose(got, want, **F32)
    back = shared_runs[("auto", TP)]["restored"]
    assert [b.tobytes() for b in back] == [np.ascontiguousarray(x).tobytes() for x in onepage]
    whole = shared_runs["params"]
    for name, t in shared_runs[("auto", TP)]["gathered"].items():
        assert t.shape == whole[name].shape and torch.equal(t, whole[name]), name


def test_int8_blobs_at_tp4_are_tp1s(shared_runs):
    """The int8 page of the same prompt at tp 4: KH heads, layer 0's codes
    and scales byte for byte tp 1's and so its blob's layer 0; tp 1's int8
    blob restored into tp 4 reads back (codes and scales) byte for byte."""
    tq, oq = shared_runs[("int8", TP)]["page"], shared_runs[("int8", 1)]["page"]
    for got, want in zip(tq, oq):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got[0].tobytes() == want[0].tobytes()
    assert tq[0].shape == (2, SMALL["page_size"], 2, 32) and tq[2].shape == (2, 2)
    k, v, sk, sv = tq
    blob = get_serde("int8page").serialize_quant(k[:1], sk[:1], v[:1], sv[:1])
    k1, v1, sk1, sv1 = oq
    assert blob == get_serde("int8page").serialize_quant(k1[:1], sk1[:1], v1[:1], sv1[:1])
    back = shared_runs[("int8", TP)]["restored"]
    assert [b.tobytes() for b in back] == [np.ascontiguousarray(x).tobytes() for x in oq]


def test_a_lora_adapter_at_tp4_matches_the_jax_engine_and_joins_back(eight_devices, twin, tmp_path):
    """Two adapters on the attention targets at tp 4: the chunk's logits
    within 2e-5 of the JAX runner's, greedy tokens the JAX engine's, and
    the slot buffers (a shared head's ``b_wk``/``b_wv`` columns on both
    ranks of its share) joined back bit-equal to one rank's and to the JAX
    runner's; every rank's slots written by the load and zeroed by the
    unload."""
    lora = dict(enable_lora=True, max_loras=2, max_lora_rank=MAX_RANK,
                lora_target_modules=",".join(tlora._LEAF_TO_HF[t] for t in ATTN))
    adapters = write_adapters(tmp_path, twin, ATTN)
    res = run_mesh(dict(tensor_parallel_size=TP), adapters, model=MODEL, lora=lora)
    check_mesh(res, adapters, one_rank_lora(MODEL, adapters, ATTN), TP, (1, TP))


def test_rank_buffers_at_shared_heads_join_back_to_one_ranks(twin, tmp_path):
    """Rank runners of tp 4 (stand-in groups) each keep their part of a
    whole adapter: ``b_wk`` of rank t is head t // 2's columns, the same on
    both ranks of a share; ``join_lora`` with the model's KV heads is the
    one-rank runner's, bit for bit."""
    adapters = write_adapters(tmp_path, twin, ATTN)
    runners = [rank_runner(MODEL, ATTN, t=t, tp=TP) for t in range(TP)]
    for r in runners:
        mgr = tlora.LoRAManager(r, max_loras=2, max_rank=MAX_RANK)
        for name, path in adapters:
            mgr.load(name, path)
    layers = [r.lora["layers"][0] for r in runners]
    assert layers[0]["b_wk"].shape == (3, MAX_RANK, 32) and layers[0]["b_wq"].shape == (3, MAX_RANK, 32)
    assert torch.equal(layers[0]["b_wk"], layers[1]["b_wk"]) and not torch.equal(layers[1]["b_wk"], layers[2]["b_wk"])
    assert_lora_bit_equal(tllama.join_lora([r.lora for r in runners], TP, twin.num_kv_heads),
                          one_rank_lora(MODEL, adapters, ATTN))


# -- a rank's decode at a shared head against the JAX plain decode -------------------


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("burst", [False, True], ids=["pool", "burst"])
def test_a_ranks_decode_on_its_shared_head_matches_the_jax_decode(quant, burst):
    """Qwen2.5-1.5B's heads (NH 12, KH 2) at tp 4: rank t's 3 query heads
    [3t, 3t + 3) and KV head t // 2 (of its pools, scales and window)
    through ``decode_attention_sharded`` (plain) are the JAX
    ``paged_attention_decode`` of the whole heads at those query heads,
    within 2e-5."""
    rng = np.random.RandomState(17 + int(quant) + 2 * int(burst))
    B, NH, KH, D, page, P, maxp, L, C = 3, 12, 2, 32, 8, 24, 4, 2, 3
    q = rng.randn(B, NH, D).astype(np.float32)
    if quant:
        kp, vp = (rng.randint(-127, 128, (L, P, page, KH, D)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, (L, P, KH)).astype(np.float32) for _ in range(2))
    else:
        kp, vp = (rng.randn(L, P, page, KH, D).astype(np.float32) for _ in range(2))
        ks = vs = None
    pt = rng.choice(P, B * maxp, replace=False).reshape(B, maxp).astype(np.int32)
    lens = np.array([5, 20, 31], np.int32)
    win = {}
    if burst:
        win = dict(k_cur=rng.randn(B, C, KH, D).astype(np.float32), v_cur=rng.randn(B, C, KH, D).astype(np.float32),
                   cur_lens=np.array([1, 3, 2], np.int32))
    layer = 1
    jkw = {k: jnp.asarray(v) for k, v in win.items()}
    if quant:
        jkw.update(k_scales=jnp.asarray(ks[layer]), v_scales=jnp.asarray(vs[layer]))
    want = np.asarray(jax_paged_decode(jnp.asarray(q), jnp.asarray(kp[layer]), jnp.asarray(vp[layer]),
                                       jnp.asarray(pt), jnp.asarray(lens), **jkw))
    parts = tpmod.kv_parts(TP, KH)
    for t in range(TP):
        g = types.SimpleNamespace(rank=t, size=TP)

        def head(a, ax):
            return None if a is None else tpmod.rank_slice(torch.from_numpy(a), ax, g, parts).contiguous()

        got = decode_attention_sharded(
            tpmod.rank_slice(torch.from_numpy(q), 1, g).contiguous(), head(kp, 3), head(vp, 3),
            torch.from_numpy(pt), torch.from_numpy(lens), tp=TP, plain=True, layer=layer,
            k_scales=head(ks, 2), v_scales=head(vs, 2), k_cur=head(win.get("k_cur"), 2),
            v_cur=head(win.get("v_cur"), 2), cur_lens=None if not burst else torch.from_numpy(win["cur_lens"]),
        )
        assert got.shape == (B, 3, D)
        np.testing.assert_allclose(got.numpy(), want[:, 3 * t: 3 * t + 3], **F32)


# -- the split helpers ------------------------------------------------------------------


def test_the_split_helpers_at_shared_heads():
    """KH 2 at tp 4: a KV leaf splits in 2 parts (rank t holds part t // 2),
    a query or MLP leaf in 4; shard and the exact gather are inverses, one
    replica a part; a tp that divides KH splits KV leaves in tp as before."""
    assert tpmod.kv_parts(4, 2) == 2 and tpmod.kv_parts(2, 4) == 2 and tpmod.kv_parts(4, None) == 4
    assert tpmod.kv_heads_per_rank(2, 4) == 1 and tpmod.kv_heads_per_rank(8, 2) == 4
    assert tpmod.split_parts("layers.3.wk", 4, 2) == 2 and tpmod.split_parts("layers.3.b_wv", 4, 2) == 2
    assert tpmod.split_parts("layers.3.wq", 4, 2) == 4 and tpmod.split_parts("layers.3.a_wk", 4, 2) == 4
    whole = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64)
    assert tpmod.shard_shape("layers.0.wk", whole.shape, 4, kv_heads=2) == (16, 32)
    assert tpmod.full_shape("layers.0.wk", (16, 32), 4, kv_heads=2) == (16, 64)
    parts = [tpmod.shard(whole, "layers.0.wk", t, 4, kv_heads=2) for t in range(4)]
    assert torch.equal(parts[0], parts[1]) and torch.equal(parts[2], whole[:, 32:])

    joined = []  # each rank's all-reduce input; their sum is the gather
    for t in range(4):
        g = types.SimpleNamespace(rank=t, size=4, all_reduce=lambda x: joined.append(x.clone()))
        tpmod.gather_param(parts[t], "layers.0.wk", g, kv_heads=2)
    total = sum(x for x in joined)
    assert torch.equal(total.view(torch.float32), whole)


def test_gemma2_at_tp4_shares_its_kv_heads_and_gives_the_jax_engines_tokens(eight_devices, monkeypatch):
    """Gemma-2's debug twin (NH 4, KH 2) at tp 4: its ranks share the KV
    heads as llama's do, and two prompts' greedy tokens are the JAX
    engine's at tp 4."""
    name = "gemma2-debug-f32"
    monkeypatch.setitem(jgemma.PRESETS, name, dataclasses.replace(jgemma.PRESETS["gemma2-debug"], dtype=jnp.float32))
    monkeypatch.setitem(tgemma.PRESETS, name, dataclasses.replace(tgemma.PRESETS["gemma2-debug"], dtype=torch.float32))
    prompts = _prompts(512)
    jeng = JaxEngine(JaxEngineConfig(model=name, tensor_parallel_size=TP, **SMALL))
    peng = None
    try:
        params = tgemma.params_from_jax(jax.device_get(jeng.runner.params), tgemma.PRESETS[name])
        peng = LLMEngine(EngineConfig(model=name, tensor_parallel_size=TP, **GLOO, **SMALL), device="cpu",
                         params=params)
        jeng.start()
        peng.start()
        jids = [_gen(jeng, p, sp=JaxSamplingParams) for p in prompts]
        tids = [_gen(peng, p) for p in prompts]
        shape = tuple(peng.runner.k_pages.shape)
    finally:
        jeng.stop()
        if peng is not None:
            peng.stop()
    assert tids == jids and all(len(x) == 8 for x in tids)
    assert shape[3] == 1


@pytest.mark.parametrize("tp", [3, 6])
def test_a_tp_that_neither_divides_nor_is_a_multiple_of_the_kv_heads_is_refused(twin, tp):
    """KH 4 with 12 query heads: tp 3 and 6 are refused by name; tp 2
    (dividing KH) and tp 12 (a multiple: 3 ranks a head) pass. The engine
    refuses tp 3 on the twin's KH 2 at start-up, in the same words."""
    cfg = dataclasses.replace(twin, num_heads=12, num_kv_heads=4, intermediate_size=768, vocab_size=516)
    with pytest.raises(ValueError, match=f"tensor_parallel_size {tp} does not divide num_kv_heads 4"):
        tpmod.check_tp(cfg, tp)
    tpmod.check_tp(cfg, 2)
    tpmod.check_tp(cfg, 12)
    with pytest.raises(ValueError, match="tensor_parallel_size 3 does not divide num_kv_heads 2"):
        LLMEngine(EngineConfig(model=MODEL, tensor_parallel_size=3, **GLOO, **SMALL), device="cpu")
