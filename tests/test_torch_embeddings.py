"""The port's pooled-embedding forward and its HTTP routes against the JAX
package's.

- ``encode`` (models/llama.py) against the JAX ``encode`` on the same
  weights (JAX's init_params carried over with params_from_jax) and the same
  ragged, padded batch, in f32 for the llama, Qwen2 (q/k/v biases) and
  Mistral (a sliding window that bites) debug presets, with the attention
  in one call and row by row (its memory bound): within atol 2e-5
  (JAX's XLA attention scans 512-key blocks with an online softmax, the
  port's plain attention takes one softmax: another summation order).
- Gemma-2 and OPT have no ``encode`` in either package; the port refuses
  them with the JAX engine's error text.
- ``/v1/embeddings``, ``/v1/rerank``, ``/v2/rerank`` and ``/v1/score`` of a
  port server and a JAX server serving the same weights: the same payloads
  (ids aside), vectors and scores within the same 2e-5, and each input's
  vector within 2e-5 of the same input embedded alone (another B and T
  bucket).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.models import gemma2 as jgemma2
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import opt as jopt
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import load_params, params_from_jax
from production_stack_tpu_torch.models import llama as tllama
from test_torch_surface import _Loop, call

ATOL = 2e-5
MODEL = "llama-debug-4kv-f32"
SMALL = dict(model=MODEL, host="127.0.0.1", max_model_len=256, max_num_seqs=8, num_pages=64, page_size=8,
             prefill_chunk=32, kv_cache_memory_gb=0.01)


def _ragged_batch(rng, vocab, lens, T):
    ids = np.zeros((len(lens), T), np.int32)
    pos = np.full((len(lens), T), -1, np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(0, vocab, n)
        pos[b, :n] = np.arange(n)
    return ids, pos


@pytest.mark.parametrize("row_groups", [False, True], ids=["one_call", "row_by_row"])
@pytest.mark.parametrize("name", ["llama-debug-4kv-f32", "qwen2-debug", "mistral-debug"])
def test_encode_matches_the_jax_encode(name, row_groups, monkeypatch):
    if row_groups:  # a score budget under one row's: attention one row a call
        monkeypatch.setattr(tllama, "ENCODE_SCORE_BYTES", 1)
    jcfg = dataclasses.replace(jllama.PRESETS[name], dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS[name], dtype=torch.float32)
    params = jax.device_get(jllama.init_params(jcfg, jax.random.key(1)))
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    load_params(model, params_from_jax(params, tcfg))
    # rows: full, ragged, one token, and a padding row (the B bucket's)
    ids, pos = _ragged_batch(np.random.RandomState(4), tcfg.vocab_size, [32, 17, 1, 0], 32)
    want = np.asarray(jllama.encode(params, jcfg, jnp.asarray(ids), jnp.asarray(pos)))
    got = tllama.encode(model, torch.from_numpy(ids), torch.from_numpy(pos)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, tcfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[:3], axis=1), 1.0, atol=1e-6)
    assert not got[3].any()  # a row with no token pools to zeros, as in JAX


@pytest.mark.parametrize("preset,jax_module", [("gemma2-debug", jgemma2), ("opt-debug", jopt)])
def test_families_without_encode_are_refused_with_the_jax_text(preset, jax_module):
    assert not hasattr(jax_module, "encode")
    family = jax_module.__name__.rsplit(".", 1)[-1]
    eng = LLMEngine(EngineConfig(model=preset, num_pages=16, page_size=8, max_model_len=128), device="cpu")
    with pytest.raises(ValueError) as err:
        asyncio.run(eng.embed([[1, 2, 3]]))
    assert str(err.value) == f"embeddings are not supported for model family {family!r}"
    with pytest.raises(ValueError, match="not supported for model family"):
        eng.runner.encode(np.ones((1, 16), np.int32), np.arange(16, dtype=np.int32)[None])


@pytest.fixture(scope="module")
def urls():
    lp = _Loop()
    jcfg, pcfg = JaxEngineConfig(**SMALL, port=free_port()), EngineConfig(**SMALL, port=free_port())
    jsrv, jrun = lp.run(jax_server.serve(jcfg))
    params = jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))
    peng = LLMEngine(pcfg, device="cpu", params=params_from_jax(params, tllama.PRESETS[MODEL]))
    psrv, prun = lp.run(port_server.serve(pcfg, peng, device="cpu"))
    yield {"jax": f"http://127.0.0.1:{jcfg.port}", "port": f"http://127.0.0.1:{pcfg.port}"}
    lp.run(prun.cleanup())
    psrv.engine.stop()
    lp.run(jrun.cleanup())
    jsrv.engine.stop()
    lp.close()


INPUTS = ["hello world", [256, 97, 98, 99], "a longer input, which spans more than one T bucket of sixteen tokens"]


def test_embeddings_route_matches_the_jax_server(urls):
    got = {tag: call(base, "POST", "/v1/embeddings", {"input": INPUTS}) for tag, base in urls.items()}
    (ps, p), (js, j) = got["port"], got["jax"]
    assert ps == js == 200
    vecs = np.array([d["embedding"] for d in p["data"]])
    np.testing.assert_allclose(vecs, np.array([d["embedding"] for d in j["data"]]), atol=ATOL, rtol=0)
    strip = lambda body: {**body, "data": [{k: v for k, v in d.items() if k != "embedding"} for d in body["data"]]}
    assert strip(p) == strip(j)
    assert p["usage"] == {"prompt_tokens": 12 + 4 + 69, "total_tokens": 12 + 4 + 69}
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-6)
    for i, item in enumerate(INPUTS):  # each alone: another B and T bucket
        status, alone = call(urls["port"], "POST", "/v1/embeddings", {"input": [item]})
        assert status == 200
        np.testing.assert_allclose(alone["data"][0]["embedding"], vecs[i], atol=ATOL, rtol=0)


@pytest.mark.parametrize("path", ["/v1/rerank", "/v2/rerank"])
def test_rerank_routes_match_the_jax_server(urls, path):
    body = {"query": "hello world", "documents": ["hello", "world peace", "zzz", "hello world"], "top_n": 3}
    got = {tag: call(base, "POST", path, body) for tag, base in urls.items()}
    (ps, p), (js, j) = got["port"], got["jax"]
    assert ps == js == 200
    assert [r["index"] for r in p["results"]] == [r["index"] for r in j["results"]]
    assert [r["document"] for r in p["results"]] == [r["document"] for r in j["results"]]
    np.testing.assert_allclose([r["relevance_score"] for r in p["results"]],
                               [r["relevance_score"] for r in j["results"]], atol=ATOL, rtol=0)
    assert p["results"][0]["index"] == 3 and len(p["results"]) == 3  # the query itself ranks first
    assert p["model"] == j["model"] and p["id"].startswith("rerank-")


def test_score_route_matches_the_jax_server(urls):
    body = {"text_1": "hello world", "text_2": ["hello world", "goodbye", [256, 104, 105]]}
    got = {tag: call(base, "POST", "/v1/score", body) for tag, base in urls.items()}
    (ps, p), (js, j) = got["port"], got["jax"]
    assert ps == js == 200
    np.testing.assert_allclose([d["score"] for d in p["data"]], [d["score"] for d in j["data"]], atol=ATOL, rtol=0)
    assert [d["index"] for d in p["data"]] == [0, 1, 2] and p["usage"] == j["usage"]
    assert abs(p["data"][0]["score"] - 1.0) < 1e-5


@pytest.mark.parametrize("path,body,status", [
    ("/v1/embeddings", {"input": "x", "model": "nope"}, 404),
    ("/v1/embeddings", {"input": []}, 400),
    ("/v1/embeddings", {"input": [[1] * 300]}, 400),
    ("/v1/rerank", {"query": "q"}, 400),
    ("/v1/rerank", {"query": "q", "documents": []}, 400),
    ("/v1/score", {"text_1": ["a", "b"], "text_2": ["a", "b", "c"]}, 400),
])
def test_pooling_route_errors_match_the_jax_server(urls, path, body, status):
    got = {tag: call(base, "POST", path, body) for tag, base in urls.items()}
    assert got["port"][0] == got["jax"][0] == status
    assert got["port"][1] == got["jax"][1]
