"""The port's Mixtral (sparse-MoE MLP) against the JAX package's, with the
JAX weights carried over by params_from_jax.

- The MoE block alone (models/llama.py ``LlamaDecoderLayer.moe`` against
  the JAX ``_moe_block``) on the same h and expert weights: f32 within
  2e-5; bf16 within 2e-2 (both round the products to bf16, the gate cast
  to bf16 before the product, as in JAX).
- The forward (mixtral-debug: 4 experts, top 2): two 16-token prefill
  chunks of a 2-row batch (row 1 ragged) and an 8-step decode burst, the
  JAX side with its Pallas kernels in interpret mode, the port with its
  kernels' plain versions, taking the experts the JAX routers took
  (models/llama.py ``tape_routes``; a near-tie in a bf16 router would
  otherwise send a token to another expert in one package). f32 copy:
  logits within 2e-5, and no router of the port's would have picked
  otherwise; bf16 preset: within 0.1; int8 pools (f32 copy): logits within 2e-5, int8 pages
  byte-identical and page scales within 1e-6 relative (test_torch_gemma2's
  bound: an amax may differ in its last bits).
- Greedy tokens of the port's engine equal the JAX engine's on an f32 copy
  of mixtral-debug (both presets replaced for the test only).
- A tiny Mixtral saved by transformers' ``save_pretrained`` (f32 and bf16)
  loads byte-identical through both loaders (experts stacked per layer),
  and its forward is within 1e-4 of the JAX forward's and within 0.1 of
  transformers' own (tests/test_model_families.py's bounds).
- ``encode`` with MoE layers within 2e-5 of the JAX ``encode`` in f32, also
  with the MLP taken one row at a time (its memory bound).
- ``init_params`` draws the expert leaves at the JAX scales (H**-0.5 for
  the router, gate and up; I**-0.5 for down), not at the leading E axis's.
- Router ties (exactly equal probabilities) pick the experts
  ``lax.top_k`` picks: the lower index first.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import model_loader as jloader
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops.attention import write_kv_pages_all_layers as jax_commit
from production_stack_tpu.ops.quant import write_kv_pages_all_layers_quant as jax_commit_quant
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_model, load_params, params_from_jax
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
from production_stack_tpu_torch.ops.quant import init_kv_scales, write_kv_pages_all_layers_quant
from test_torch_gemma2 import _chunks, _int8_pools_match, _t
from test_torch_hf_loader import _bytes, _jax_logits, _port_logits, _same_config

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=0.1, rtol=0.0)
NAME = "mixtral-debug"
PAGE, NUM_PAGES = 8, 24
PT = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)
BURST = 8

# (JAX config overrides, the port's, tolerance, int8 pools)
VARIANTS = {
    "f32": (dict(dtype=jnp.float32), dict(dtype=torch.float32), F32, False),
    "bf16": ({}, {}, BF16, False),
    "int8_f32": (dict(dtype=jnp.float32, kv_cache_dtype="int8"),
                 dict(dtype=torch.float32, kv_cache_dtype="int8"), F32, True),
}


def _models(variant):
    """(JAX config, numpy params, the port's model with those params, tol, quant)."""
    jover, tover, tol, quant = VARIANTS[variant]
    cfg_j = dataclasses.replace(jllama.PRESETS[NAME], attn_impl="pallas_interpret", **jover)
    cfg_t = dataclasses.replace(tllama.PRESETS[NAME], attn_impl="plain", **tover)
    p = jax.device_get(jllama.init_params(cfg_j, jax.random.key(0)))
    model = tllama.LlamaForCausalLM(cfg_t, device="cpu")
    load_params(model, params_from_jax(p, cfg_t))
    return cfg_j, p, model, tol, quant


def _pools(cfg_j, quant):
    """The same initial pools for both sides: (port tensors, JAX arrays)."""
    shape = (cfg_j.num_layers, NUM_PAGES, PAGE, cfg_j.num_kv_heads, cfg_j.head_dim)
    if quant:
        t = [torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8),
             init_kv_scales(shape[0], NUM_PAGES, shape[3]), init_kv_scales(shape[0], NUM_PAGES, shape[3])]
        return t, [jnp.asarray(x.numpy()) for x in t]
    rng = np.random.RandomState(3)
    dt = np.dtype(cfg_j.dtype)
    arrs = [rng.randn(*shape).astype(np.float32).astype(dt) for _ in range(2)]
    if dt == np.float32:
        return [torch.from_numpy(a.copy()) for a in arrs], [jnp.asarray(a) for a in arrs]
    torch_arrs = [torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16) for a in arrs]
    return torch_arrs, [jnp.asarray(a) for a in arrs]


def test_layer_shapes_and_params_from_jax_carry_the_expert_leaves():
    cfg_j, p, model, _, _ = _models("bf16")
    shapes = tllama.layer_shapes(model.cfg)
    H, I, E = 128, 256, 4
    assert {k: shapes[k] for k in ("moe_router", "moe_gate", "moe_up", "moe_down")} == {
        "moe_router": (H, E), "moe_gate": (E, H, I), "moe_up": (E, H, I), "moe_down": (E, I, H)}
    assert not {"w_gate", "w_up", "w_down"} & set(shapes)
    own = dict(model.named_parameters())
    for name in ("moe_router", "moe_gate", "moe_up", "moe_down"):
        for i in range(cfg_j.num_layers):
            want = np.ascontiguousarray(p["layers"][name][i])
            assert own[f"layers.{i}.{name}"].view(torch.int16).numpy().tobytes() == want.view(np.int16).tobytes()


def test_init_params_draws_the_experts_at_the_jax_scales():
    """fan_in of an [E, in, out] leaf is its in axis: at E = 4 a draw scaled
    by E**-0.5 would be 5.7x (gate/up) and 8x (down) too wide."""
    _, cfg, model = load_model("mixtral-debug", seed=0, device="cpu")
    H, I = cfg.hidden_size, cfg.intermediate_size
    for name, scale in (("moe_router", H**-0.5), ("moe_gate", H**-0.5), ("moe_up", H**-0.5), ("moe_down", I**-0.5)):
        std = float(getattr(model.layers[0], name).float().std())
        assert abs(std / scale - 1) < 0.05, (name, std, scale)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_moe_block_matches_the_jax_block(dtype, tol):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    cfg_j = dataclasses.replace(jllama.PRESETS[NAME], dtype=jdt, num_experts=8, num_experts_per_tok=2)
    cfg_t = dataclasses.replace(tllama.PRESETS[NAME], dtype=dtype, num_experts=8, num_experts_per_tok=2)
    p = jax.device_get(jllama.init_params(cfg_j, jax.random.key(5)))
    model = tllama.LlamaForCausalLM(cfg_t, device="cpu")
    load_params(model, params_from_jax(p, cfg_t))
    h = np.random.RandomState(6).randn(3, 7, cfg_t.hidden_size).astype(np.float32).astype(np.dtype(jdt))
    lp = {k: v[1] for k, v in p["layers"].items()}
    want = np.asarray(jllama._moe_block(jnp.asarray(h), lp, cfg_j)).astype(np.float32)
    th = torch.from_numpy(h.view(np.int16)).view(torch.bfloat16) if dtype == torch.bfloat16 else torch.from_numpy(h)
    with torch.no_grad():
        got = model.layers[1].moe(th, cfg_t)
    assert got.dtype == dtype and got.shape == (3, 7, cfg_t.hidden_size)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    assert float(np.abs(want).mean()) > 10 * tol  # the bound is well below the outputs


def test_router_ties_pick_the_experts_lax_top_k_picks():
    """Router logits round to the model's dtype, so in bf16 two experts can
    tie exactly. lax.top_k ranks the lower index first; the port must pick
    the same experts, or the block's output moves by O(1)."""
    cfg_j = dataclasses.replace(jllama.PRESETS[NAME], dtype=jnp.float32, num_experts=8)
    cfg_t = dataclasses.replace(tllama.PRESETS[NAME], dtype=torch.float32, num_experts=8)
    p = jax.device_get(jllama.init_params(cfg_j, jax.random.key(7)))
    lp = {k: np.array(v[0]) for k, v in p["layers"].items()}
    # rows of h pick router rows: logits [0,2,2,1,0,2,1,0] (a 3-way tie for
    # first place), [3,1,0,1,0,0,1,0] (a tie for second), [1,1,1,1,1,1,1,1]
    router = np.zeros_like(lp["moe_router"])
    router[0] = [0, 2, 2, 1, 0, 2, 1, 0]
    router[1] = [3, 1, 0, 1, 0, 0, 1, 0]
    router[2] = 1.0
    lp["moe_router"] = router
    h = np.zeros((1, 3, cfg_t.hidden_size), np.float32)
    h[0, 0, 0] = h[0, 1, 1] = h[0, 2, 2] = 1.0
    want = np.asarray(jllama._moe_block(jnp.asarray(h), lp, cfg_j))
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(h[0] @ router), axis=-1), 2)
    layer = tllama.LlamaDecoderLayer(cfg_t, "cpu")
    with torch.no_grad():
        for name in ("moe_router", "moe_gate", "moe_up", "moe_down"):
            getattr(layer, name).copy_(torch.from_numpy(lp[name]))
        _, _, topi = layer.route(torch.from_numpy(h), cfg_t)
        got = layer.moe(torch.from_numpy(h), cfg_t).numpy()
    assert topi[0].tolist() == np.asarray(jidx).tolist() == [[1, 2], [0, 1], [0, 1]]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _jax_routes(monkeypatch) -> list:
    """The experts each JAX MoE layer's router picks (``lax.top_k``'s
    indices), appended in layer order per forward call through a
    ``_moe_block`` wrapper (a test-time patch; the JAX package is not
    edited). Read after ``jax.effects_barrier()``."""
    picks = []
    orig_block = jllama._moe_block

    def block(h, lp, cfg):
        probs = jax.nn.softmax((h @ lp["moe_router"]).astype(jnp.float32), axis=-1)
        _, topi = jax.lax.top_k(probs, cfg.num_experts_per_tok)
        jax.debug.callback(lambda x: picks.append(np.array(x)), topi, ordered=True)
        return orig_block(h, lp, cfg)

    monkeypatch.setattr(jllama, "_moe_block", block)
    return picks


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_prefill_chunks_and_burst_match_jax(variant, monkeypatch):
    """Every logit of every step is held to the bound: the port's routers
    take the experts the JAX routers took. In f32 none of them would have
    picked otherwise; in bf16 the router's logits round to bf16, and where
    two experts all but tie (or tie exactly) the two packages' roundings
    could otherwise route a token apart."""
    cfg_j, p, model, tol, quant = _models(variant)
    L, KH, D = cfg_j.num_layers, cfg_j.num_kv_heads, cfg_j.head_dim
    jax_picks = _jax_routes(monkeypatch)
    tpools, jpools = _pools(cfg_j, quant)
    ids, chunks = _chunks()
    pt_j, pt_t = jnp.asarray(PT), _t(PT)
    with torch.no_grad(), tllama.tape_routes(model, replay=jax_picks) as tape:
        for inp, pos, lens in chunks:
            jout = jllama.forward(p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jpools[0], jpools[1], pt_j,
                                  jnp.asarray(lens), kv_scales=(jpools[2], jpools[3]) if quant else None)
            jl, jpools = jout[0], list(jout[1:])
            jax.effects_barrier()
            tl = model(_t(inp), _t(pos), tpools[0], tpools[1], pt_t, _t(lens),
                       kv_scales=(tpools[2], tpools[3]) if quant else None)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
            if quant:
                _int8_pools_match(tpools, jpools)
        jka = jnp.zeros((L, 2, BURST, KH, D), cfg_j.dtype)
        jva = jnp.zeros_like(jka)
        tka = torch.zeros((L, 2, BURST, KH, D), dtype=model.cfg.dtype)
        tva = torch.zeros_like(tka)
        lens0 = chunks[-1][2]
        for s in range(BURST):
            inp = np.stack([ids[0, 32 + s], ids[1, 24 + s]])[:, None].astype(np.int32)
            pos = (lens0 + s)[:, None].astype(np.int32)
            lens = (lens0 + s + 1).astype(np.int32)
            cnt = np.full((2,), s, np.int32)
            jl, jka, jva = jllama.forward(
                p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jpools[0], jpools[1], pt_j, jnp.asarray(lens),
                kv_burst=(jka, jva, jnp.asarray(cnt)), kv_scales=(jpools[2], jpools[3]) if quant else None,
            )
            jax.effects_barrier()
            tl = model(_t(inp), _t(pos), tpools[0], tpools[1], pt_t, _t(lens), kv_burst=(tka, tva, _t(cnt)),
                       kv_scales=(tpools[2], tpools[3]) if quant else None)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert len(tape.picks) == len(jax_picks) == L * (len(chunks) + BURST)
    if variant != "bf16":
        assert tape.overridden == 0  # f32: the port's routers pick what JAX's pick
    commit = (lens0[:, None] + np.arange(BURST)[None]).astype(np.int32)
    if quant:
        jpools = list(jax_commit_quant(*jpools, jka, jva, pt_j, jnp.asarray(commit)))
        write_kv_pages_all_layers_quant(*tpools, tka, tva, pt_t, _t(commit))
        _int8_pools_match(tpools, jpools)
    else:
        jpools = list(jax_commit(jpools[0], jpools[1], jka, jva, pt_j, jnp.asarray(commit)))
        write_kv_pages_all_layers(tpools[0], tpools[1], tka, tva, pt_t, _t(commit))
        for t, j in zip(tpools, jpools):
            np.testing.assert_allclose(t.float().numpy(), np.asarray(j).astype(np.float32), **tol)


def _greedy(engine, prompts, sampling, params_cls):
    async def one(i, prompt):
        toks = []
        async for out in engine.generate(f"g{i}", prompt=prompt, params=params_cls(**sampling)):
            toks.extend(out.token_ids)
        return toks

    async def run():
        return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))

    return asyncio.run(run())


def test_engine_greedy_tokens_match_the_jax_engine_on_an_f32_copy(monkeypatch):
    """Both engines serve mixtral-debug in f32 (the preset replaced for this
    test in both packages) with the JAX weights: two concurrent greedy
    requests over three prefill chunks and four decode bursts give the same
    tokens."""
    jcfg = dataclasses.replace(jllama.PRESETS[NAME], dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS[NAME], dtype=torch.float32)
    monkeypatch.setitem(jllama.PRESETS, NAME, jcfg)
    monkeypatch.setitem(tllama.PRESETS, NAME, tcfg)
    small = dict(model=NAME, max_model_len=256, max_num_seqs=4, num_pages=64, page_size=8, prefill_chunk=32,
                 decode_steps=4)
    params = jax.device_get(jllama.init_params(jcfg, jax.random.key(0)))
    jeng = JaxEngine(JaxEngineConfig(**small))
    peng = LLMEngine(EngineConfig(**small), device="cpu", params=params_from_jax(params, tcfg))
    prompts = ["Mixtral routes every token to two of its experts, " * 2, "sparse"]
    sampling = dict(max_tokens=14, temperature=0.0, ignore_eos=True)
    got = {}
    for tag, eng, cls in (("jax", jeng, JaxSamplingParams), ("port", peng, SamplingParams)):
        eng.start()
        try:
            got[tag] = _greedy(eng, prompts, sampling, cls)
        finally:
            eng.stop()
    assert [len(t) for t in got["port"]] == [14, 14]
    assert got["port"] == got["jax"]


@pytest.fixture(scope="module")
def mixtral_dirs(tmp_path_factory):
    """A tiny transformers Mixtral (f32) and its save_pretrained directories
    in f32 and bf16."""
    import transformers as tf

    torch.manual_seed(0)
    cfg = tf.MixtralConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                           num_local_experts=4, num_experts_per_tok=2, tie_word_embeddings=False,
                           attn_implementation="eager")
    model = tf.MixtralForCausalLM(cfg).eval()
    dirs = {}
    for dt in ("f32", "bf16"):
        path = tmp_path_factory.mktemp(f"mixtral-{dt}")
        (model if dt == "f32" else tf.MixtralForCausalLM(cfg).to(torch.bfloat16)).save_pretrained(
            path, safe_serialization=True)
        dirs[dt] = str(path)
    return model, dirs


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_loader_matches_the_jax_loader_bit_for_bit(mixtral_dirs, dt):
    path = mixtral_dirs[1][dt]
    jmod, jcfg, jparams = jloader.load_from_hf(path)
    mod, cfg, model = load_model(path, device="cpu")
    assert mod is tllama and jmod is jllama
    _same_config(cfg, jcfg)
    assert (cfg.num_experts, cfg.num_experts_per_tok) == (4, 2)
    ref = params_from_jax(jax.device_get(jparams), cfg)
    own = dict(model.named_parameters())
    assert set(own) == set(ref) and "layers.0.moe_gate" in own
    for name, p in own.items():
        assert p.dtype == ref[name].dtype == torch.bfloat16 and p.shape == ref[name].shape, name
        assert _bytes(p) == _bytes(ref[name]), name


def test_forward_on_the_loaded_directory_matches_jax_and_transformers(mixtral_dirs):
    hf_model, dirs = mixtral_dirs
    ids = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int32)
    _, cfg, model = load_model(dirs["f32"], device="cpu")
    ours = _port_logits(model, cfg, ids)
    np.testing.assert_allclose(ours, _jax_logits(dirs["f32"], ids), atol=1e-4, rtol=0)
    with torch.no_grad():
        theirs = hf_model(torch.from_numpy(ids).long()).logits[:, -1].float().numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0.1, atol=0.1)
    assert np.corrcoef(ours.ravel(), theirs.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("row_groups", [False, True], ids=["one_call", "row_by_row"])
def test_encode_with_moe_layers_matches_the_jax_encode(row_groups, monkeypatch):
    if row_groups:  # a budget under one row's: the attention and the MoE MLP one row a call
        monkeypatch.setattr(tllama, "ENCODE_SCORE_BYTES", 1)
    jcfg = dataclasses.replace(jllama.PRESETS[NAME], dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS[NAME], dtype=torch.float32)
    params = jax.device_get(jllama.init_params(jcfg, jax.random.key(1)))
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    load_params(model, params_from_jax(params, tcfg))
    rng = np.random.RandomState(4)
    ids = np.zeros((3, 32), np.int32)
    pos = np.full((3, 32), -1, np.int32)
    for b, n in enumerate((32, 17, 1)):
        ids[b, :n] = rng.randint(0, tcfg.vocab_size, n)
        pos[b, :n] = np.arange(n)
    want = np.asarray(jllama.encode(params, jcfg, jnp.asarray(ids), jnp.asarray(pos)))
    got = tllama.encode(model, torch.from_numpy(ids), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

