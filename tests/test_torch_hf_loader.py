"""The port's HF checkpoint loader against the JAX package's, and its
safetensors reader and writer against the ``safetensors`` package.

- The reader (utils/safetensors_io.py) returns byte-identical tensors to
  ``safe_open`` for F32, F16, BF16, I8, I32 and I64 over a two-shard
  directory, reads bf16 with ml_dtypes, safetensors and jax blocked, and
  refuses a name in two shards and an unknown dtype by name; the writer's
  files read back byte-identically through ``safe_open``.
- Loader parity: tiny Llama (llama3 rope scaling), Qwen2, Mistral
  (window), Gemma-2 and OPT models saved by transformers'
  ``save_pretrained``, once in f32 and once in bf16: the port's parameters
  are byte-identical to ``params_from_jax`` of the JAX loader's, and the
  configs agree field by field. The JAX side reads bf16 shards through
  ``safe_open(framework="np")``, which needs ml_dtypes: jax is imported here.
- Forward parity (f32 shards, weights round-tripped through bf16 as both
  loaders cast them, then run in f32, plain kernels): the port's
  last-token logits within 1e-4 of the JAX forward's, and within
  tests/test_model_families.py's bounds of transformers' own (0.1, and a
  correlation above 0.999: the bf16 round trip).
- Refusals (Mixtral by name before any weight is read, OPT past its
  position table) and the engine around a directory: its tokenizer comes
  from the directory, and ``/v1/models`` names it as the JAX server does.
"""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as st_save_file

from production_stack_tpu.engine import model_loader as jloader
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine import engine as port_engine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.model_loader import is_hf_dir, load_model, load_params, params_from_jax
from production_stack_tpu_torch.models import opt as topt
from production_stack_tpu_torch.utils import safetensors_io as sio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 512  # the byte tokenizer's ids (BOS 256) fit it
_TENSORS = {
    "f32": ((3, 5), torch.float32),
    "f16": ((2, 7), torch.float16),
    "bf16": ((4, 3), torch.bfloat16),
    "i8": ((9,), torch.int8),  # odd length: the next tensor starts unaligned
    "i32": ((2, 3), torch.int32),
    "i64": ((5,), torch.int64),
}


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, dt) in _TENSORS.items():
        if dt.is_floating_point:
            out[name] = torch.randn(shape, generator=g).to(dt)
        else:
            out[name] = torch.randint(-100, 100, shape, generator=g).to(dt)
    return out


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_reader_matches_safe_open_over_two_shards(tmp_path):
    ts = _tensors()
    names = list(ts)
    st_save_file({n: ts[n] for n in names[:3]}, str(tmp_path / "a.safetensors"))
    sio.save_sharded(str(tmp_path / "b"), {n: (tuple(ts[n].shape), ts[n].dtype) for n in names[3:]}, ts.__getitem__)
    os.rename(tmp_path / "b" / "model.safetensors", tmp_path / "b.safetensors")
    os.rmdir(tmp_path / "b")
    reader = sio.SafetensorsDir(str(tmp_path))
    assert sorted(reader.keys()) == sorted(names)
    for fname in sorted(os.listdir(tmp_path)):
        with safe_open(str(tmp_path / fname), framework="np") as f:
            for name in f.keys():
                ref = f.get_tensor(name)
                got = reader.get(name)
                assert got.dtype == ts[name].dtype and tuple(got.shape) == ref.shape
                assert _bytes(got) == ref.tobytes(), name


def test_writer_files_read_back_through_safe_open(tmp_path):
    ts = _tensors(1)
    assert sio.save_sharded(str(tmp_path), {n: (tuple(t.shape), t.dtype) for n, t in ts.items()},
                            ts.__getitem__) == ["model.safetensors"]
    with safe_open(str(tmp_path / "model.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(ts)
        for name, t in ts.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and _bytes(got) == _bytes(t), name


def test_sharded_writer_splits_and_indexes_as_hf_does(tmp_path):
    ts = _tensors(2)
    specs = {n: (tuple(t.shape), t.dtype) for n, t in ts.items()}
    files = sio.save_sharded(str(tmp_path), specs, ts.__getitem__, max_shard_bytes=48)
    assert len(files) > 1 and files[0] == f"model-00001-of-{len(files):05d}.safetensors"
    index = json.loads((tmp_path / sio.INDEX_FILE).read_text())
    assert set(index["weight_map"]) == set(ts) and set(index["weight_map"].values()) == set(files)
    assert index["metadata"]["total_size"] == sum(t.numel() * t.element_size() for t in ts.values())
    for name, fname in index["weight_map"].items():
        with safe_open(str(tmp_path / fname), framework="pt") as f:
            assert _bytes(f.get_tensor(name)) == _bytes(ts[name])
    reader = sio.SafetensorsDir(str(tmp_path))
    assert all(_bytes(reader.get(n)) == _bytes(t) for n, t in ts.items())
    with pytest.raises(ValueError, match="make\\('f32'\\) gave"):
        sio.save_sharded(str(tmp_path / "bad"), specs, lambda n: ts["i8"])


def test_reader_refuses_a_duplicate_name_and_an_unknown_dtype(tmp_path):
    ts = _tensors()
    st_save_file({"f32": ts["f32"]}, str(tmp_path / "a.safetensors"))
    st_save_file({"f32": ts["f32"]}, str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="'f32' is in both a.safetensors and b.safetensors"):
        sio.SafetensorsDir(str(tmp_path))
    other = tmp_path / "f64"
    other.mkdir()
    st_save_file({"x": torch.zeros(3, dtype=torch.float64)}, str(other / "m.safetensors"))
    with pytest.raises(ValueError, match="tensor 'x' has dtype F64"):
        sio.SafetensorsDir(str(other))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        sio.SafetensorsDir(str(tmp_path / "empty"))
    (tmp_path / "b.safetensors").unlink()
    with pytest.raises(KeyError, match="'nope' is not in the checkpoint"):
        sio.SafetensorsDir(str(tmp_path)).get("nope")


_NO_ML_DTYPES = r"""
import sys
for m in ("ml_dtypes", "safetensors", "jax", "transformers"):
    sys.modules[m] = None  # any import of them now raises
import torch
from production_stack_tpu_torch.utils.safetensors_io import SafetensorsDir
t = SafetensorsDir(sys.argv[1]).get("bf16")
assert t.dtype == torch.bfloat16
print(t.view(torch.int16).reshape(-1).tolist())
"""


def test_reader_takes_bf16_without_ml_dtypes(tmp_path):
    ts = _tensors()
    st_save_file({"bf16": ts["bf16"]}, str(tmp_path / "m.safetensors"))
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ts["bf16"].view(torch.int16).reshape(-1).tolist()


# -- tiny HF models of every family ------------------------------------------------

COMMON = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              attn_implementation="eager")


def _hf_model(family):
    import transformers as tf

    torch.manual_seed(0)
    if family == "llama":
        cfg = tf.LlamaConfig(**COMMON, tie_word_embeddings=False, rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
            "original_max_position_embeddings": 32})
        return tf.LlamaForCausalLM(cfg)
    if family == "qwen2":
        return tf.Qwen2ForCausalLM(tf.Qwen2Config(**COMMON, tie_word_embeddings=False))
    if family == "mistral":
        return tf.MistralForCausalLM(tf.MistralConfig(**COMMON, sliding_window=8, tie_word_embeddings=False))
    if family == "gemma2":
        return tf.Gemma2ForCausalLM(tf.Gemma2Config(
            **COMMON, head_dim=16, query_pre_attn_scalar=16, sliding_window=8, attn_logit_softcapping=50.0,
            final_logit_softcapping=30.0))
    assert family == "opt"
    cfg = tf.OPTConfig(vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_hidden_layers=2, num_attention_heads=4,
                       max_position_embeddings=64, word_embed_proj_dim=64, do_layer_norm_before=True,
                       attn_implementation="eager")
    return tf.OPTForCausalLM(cfg)


FAMILIES = ("llama", "qwen2", "mistral", "gemma2", "opt")


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{family: (f32 model, {"f32": dir, "bf16": dir})}, each saved once."""
    out = {}
    for family in FAMILIES:
        model = _hf_model(family).eval()
        dirs = {}
        for dt in ("f32", "bf16"):
            path = tmp_path_factory.mktemp(f"{family}-{dt}")
            (model if dt == "f32" else _hf_model(family).to(torch.bfloat16)).save_pretrained(
                path, safe_serialization=True)
            dirs[dt] = str(path)
        out[family] = (model, dirs)
    return out


def _same_config(t, j):
    """Every field of the port's config equals the JAX config's (dtype by
    name, rope scaling by its fields), and so do the uniform accessors."""
    for f in dataclasses.fields(t):
        if not hasattr(j, f.name):  # the JAX OPT config threads no pool dtype
            assert (f.name, getattr(t, f.name)) == ("kv_cache_dtype", "auto")
            continue
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dtype":
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        elif dataclasses.is_dataclass(a) or dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    for prop in ("num_kv_heads", "head_dim", "tie_word_embeddings", "sliding_window", "max_model_len"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_loader_matches_the_jax_loader_bit_for_bit(hf_dirs, family, dt):
    path = hf_dirs[family][1][dt]
    assert is_hf_dir(path)
    jmod, jcfg, jparams = jloader.load_from_hf(path)
    mod, cfg, model = load_model(path, device="cpu")
    assert mod.__name__.rsplit(".", 1)[-1] == jmod.__name__.rsplit(".", 1)[-1]
    _same_config(cfg, jcfg)
    ref = params_from_jax(jax.device_get(jparams), cfg)
    own = dict(model.named_parameters())
    assert set(own) == set(ref)
    for name, p in own.items():
        assert p.dtype == ref[name].dtype == torch.bfloat16 and p.shape == ref[name].shape, name
        assert torch.equal(p.view(torch.int16), ref[name].view(torch.int16)), name
    if family == "llama":
        assert cfg.rope_scaling is not None and not cfg.tie_word_embeddings and "lm_head" in own
    if family == "qwen2":
        assert cfg.attention_bias and cfg.sliding_window is None  # use_sliding_window is false
    if family == "mistral":
        assert cfg.sliding_window == 8


def _port_logits(model, cfg, ids):
    """The port's forward in f32 (its bf16 weights cast up), plain kernels,
    one chunk of T tokens per row."""
    mod = type(model).__module__
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, attn_impl="plain")
    net = type(model)(cfg32, device="cpu")
    load_params(net, {n: p.float() for n, p in model.named_parameters()})
    B, T = ids.shape
    page = 8
    maxp = -(-T // page)
    kp, vp = sys.modules[mod].init_kv_pages(cfg32, B * maxp + 1, page, "cpu")
    pt = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    with torch.no_grad():
        return net(torch.from_numpy(ids), pos, kp, vp, pt, torch.full((B,), T, dtype=torch.int32)).numpy()


def _jax_logits(path, ids):
    """tests/test_model_families.py's JAX run: the JAX loader, f32, XLA."""
    mod, cfg, params = jloader.load_from_hf(path)
    cfg = dataclasses.replace(cfg, attn_impl="xla", dtype=jnp.float32)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    B, T = ids.shape
    maxp = -(-T // 8)
    kp, vp = mod.init_kv_pages(cfg, num_pages=B * maxp + 1, page_size=8, dtype=jnp.float32)
    pt = jnp.arange(B * maxp, dtype=jnp.int32).reshape(B, maxp)
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    logits, _, _ = jax.jit(mod.forward, static_argnums=1)(params, cfg, jnp.asarray(ids), pos, kp, vp, pt,
                                                           jnp.full((B,), T, jnp.int32))
    return np.asarray(logits)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_on_the_loaded_directory_matches_jax_and_transformers(hf_dirs, family):
    hf_model, dirs = hf_dirs[family]
    ids = np.random.RandomState(0).randint(0, VOCAB, (2, 16)).astype(np.int32)
    _, cfg, model = load_model(dirs["f32"], device="cpu")
    ours = _port_logits(model, cfg, ids)
    np.testing.assert_allclose(ours, _jax_logits(dirs["f32"], ids), atol=1e-4, rtol=0)
    with torch.no_grad():
        theirs = hf_model(torch.from_numpy(ids).long()).logits[:, -1].float().numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0.1, atol=0.1)
    assert np.corrcoef(ours.ravel(), theirs.ravel())[0, 1] > 0.999


def test_mixtral_is_refused_by_name_before_any_weight_is_read(tmp_path):
    cfg = {"architectures": ["MixtralForCausalLM"], "vocab_size": VOCAB, "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "num_local_experts": 4, "num_experts_per_tok": 2}
    (tmp_path / "config.json").write_text(json.dumps(cfg))  # no shards at all
    with pytest.raises(NotImplementedError, match="Mixtral MoE layers are not ported"):
        load_model(str(tmp_path), device="cpu")
    (tmp_path / "config.json").write_text(json.dumps(dict(cfg, architectures=["FalconForCausalLM"])))
    with pytest.raises(ValueError, match="unsupported architecture 'FalconForCausalLM'"):
        load_model(str(tmp_path), device="cpu")


def test_opt_max_model_len_past_its_position_table_is_refused(hf_dirs):
    path = hf_dirs["opt"][1]["bf16"]
    with pytest.raises(ValueError, match="exceeds OPT position table \\(64\\)"):
        load_model(path, device="cpu", max_model_len=65)
    _, cfg, model = load_model(path, device="cpu", max_model_len=32)
    assert cfg.max_model_len == model.cfg.max_model_len == 32
    assert model.pos_embed.shape[0] == 64 + topt.POS_OFFSET  # the checkpoint's whole table stays
    with pytest.raises(ValueError, match="brings its own weights"):
        load_model(path, device="cpu", params={})


def test_engine_takes_the_tokenizer_from_the_directory_and_serves_under_its_name(hf_dirs, monkeypatch):
    path = hf_dirs["qwen2"][1]["bf16"]
    asked, real = [], port_engine.load_tokenizer
    monkeypatch.setattr(port_engine, "load_tokenizer", lambda p: asked.append(p) or real(p))
    small = dict(num_pages=16, page_size=8, max_model_len=64)
    eng = port_engine.LLMEngine(EngineConfig(model=path, **small), device="cpu")
    assert asked == [path]  # no tokenizer files there: the byte tokenizer, as in the JAX engine
    assert type(eng.tokenizer).__name__ == "ByteTokenizer"
    port_engine.LLMEngine(EngineConfig(model="llama-debug", **small), device="cpu")
    assert asked == [path, None]  # a preset has no directory to look in
    for served, name in ((None, path), ("qwen-tiny", "qwen-tiny")):
        cfg = EngineConfig(model=path, served_model_name=served, **small)
        resp = asyncio.run(port_server.EngineServer(cfg, eng).models(None))
        assert json.loads(resp.body)["data"][0]["id"] == name


@pytest.mark.parametrize("family", ["qwen2", "opt"])
def test_server_answers_from_a_directory_and_repeats_greedy_text(hf_dirs, family):
    """The card's serve phase in small, on the CPU: the port's server on a
    checkpoint directory answers a completion, and the greedy repeat over
    its cached prefix gives the same tokens."""
    import aiohttp

    from production_stack_tpu.testing.procs import free_port

    path = hf_dirs[family][1]["bf16"]
    cfg = EngineConfig(model=path, host="127.0.0.1", port=free_port(), num_pages=32, page_size=8,
                       max_model_len=64, prefill_chunk=16)
    body = {"prompt": "hello from a checkpoint dir", "max_tokens": 8, "temperature": 0.0, "ignore_eos": True,
            "logprobs": 1}

    async def run():
        server, runner = await port_server.serve(cfg, port_engine.LLMEngine(cfg, device="cpu"))
        try:
            async with aiohttp.ClientSession() as s:
                outs = []
                for _ in range(2):
                    async with s.post(f"http://127.0.0.1:{cfg.port}/v1/completions", json=body) as r:
                        assert r.status == 200
                        outs.append(await r.json())
                return outs
        finally:
            await runner.cleanup()
            server.engine.stop()

    first, second = asyncio.run(run())
    assert first["model"] == path and first["usage"]["completion_tokens"] == 8
    lps = [o["choices"][0]["logprobs"]["token_logprobs"] for o in (first, second)]
    assert len(lps[0]) == 8 and lps[0] == lps[1]
    assert first["choices"][0]["text"] == second["choices"][0]["text"]
    assert second["usage"]["prompt_tokens_details"]["cached_tokens"] >= 16


def test_a_tokenizer_that_gives_no_ids_falls_back_to_bytes(tmp_path, monkeypatch):
    """A directory with a config.json and no tokenizer files: some
    transformers versions still build a tokenizer there, with an empty
    vocabulary whose ids are None (seen on the card's machine). The engine
    must take the byte tokenizer instead of scheduling None ids."""
    import transformers

    from production_stack_tpu_torch.engine.tokenizer import load_tokenizer

    class Empty:
        bos_token_id = eos_token_id = pad_token_id = None

        def encode(self, text, add_special_tokens=True):
            return [None] * len(text.split())

        def __len__(self):
            return 0

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda *a, **k: Empty())
    tok = load_tokenizer(str(tmp_path))
    assert type(tok).__name__ == "ByteTokenizer" and tok.encode("hi") == [256, 104, 105]


def test_an_empty_prompt_without_a_bos_token_is_refused_not_scheduled():
    """Qwen2's tokenizer has no BOS: an empty prompt has no token to start
    from, and a None id would stop the engine loop at its next schedule."""
    import aiohttp

    from production_stack_tpu.testing.procs import free_port

    cfg = EngineConfig(model="llama-debug", host="127.0.0.1", port=free_port(), num_pages=16, page_size=8,
                       max_model_len=64)
    eng = port_engine.LLMEngine(cfg, device="cpu")

    class NoBos(type(eng.tokenizer)):  # bytes, and no BOS, as a Qwen2 tokenizer has it
        bos_token_id = None

        def encode(self, text, add_bos=True):
            return list(text.encode())

    eng.tokenizer = NoBos()

    async def run():
        with pytest.raises(ValueError, match="no BOS token"):
            async for _ in eng.generate("e", prompt=""):
                pass
        server, runner = await port_server.serve(cfg, eng)
        try:
            async with aiohttp.ClientSession() as s:
                url = f"http://127.0.0.1:{cfg.port}/v1/completions"
                async with s.post(url, json={"prompt": "", "max_tokens": 2}) as r:
                    assert r.status == 400 and "no BOS token" in (await r.json())["error"]["message"]
                async with s.post(url, json={"prompt": "hi", "max_tokens": 2, "temperature": 0.0}) as r:
                    assert r.status == 200  # the loop still serves
        finally:
            await runner.cleanup()
            server.engine.stop()

    asyncio.run(run())
