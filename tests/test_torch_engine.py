"""The port's engine behind the port's OpenAI server against the JAX engine
behind the JAX server, serving the same weights (JAX's init_params, carried
over with params_from_jax) on the f32 twin preset: the same greedy request
streams the same text and token counts from both, and the port's server
answers its other routes in the JAX server's JSON shapes."""

import asyncio
import dataclasses
import json

import aiohttp
import jax
import pytest

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import PORT_ONLY, EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.models import llama as tllama

MODEL = "llama-debug-4kv-f32"
SMALL = dict(model=MODEL, host="127.0.0.1", max_model_len=256, max_num_seqs=8, num_pages=64, page_size=8,
             prefill_chunk=32, kv_cache_memory_gb=0.01)
PROMPT = "The quick brown fox jumps over the lazy dog, twice over and back."  # 65 bytes: 3 prefill chunks
REQUEST = {"prompt": PROMPT, "max_tokens": 12, "temperature": 0.0, "ignore_eos": True}


async def _stream(client, url, body):
    text, usage, chunks = [], None, 0
    async with client.post(url + "/v1/completions", json=dict(body, stream=True)) as r:
        assert r.status == 200
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            obj = json.loads(line[6:])
            usage = obj.get("usage") or usage
            for c in obj["choices"]:
                chunks += 1
                assert obj["object"] == "text_completion"
                text.append(c["text"])
    return "".join(text), usage, chunks


def _port_engine():
    params = jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))
    return LLMEngine(EngineConfig(**SMALL), device="cpu", params=params_from_jax(params, tllama.PRESETS[MODEL]))


def test_port_server_streams_the_jax_servers_greedy_text():
    async def run():
        jcfg = JaxEngineConfig(**SMALL, port=free_port())
        pcfg = EngineConfig(**SMALL, port=free_port())
        jsrv, jrun = await jax_server.serve(jcfg)
        psrv, prun = await port_server.serve(pcfg, _port_engine())
        try:
            async with aiohttp.ClientSession() as s:
                jt = await _stream(s, f"http://127.0.0.1:{jcfg.port}", REQUEST)
                pt = await _stream(s, f"http://127.0.0.1:{pcfg.port}", REQUEST)
                async with s.post(f"http://127.0.0.1:{pcfg.port}/v1/completions", json=REQUEST) as r:
                    whole = await r.json()
        finally:
            await prun.cleanup()
            psrv.engine.stop()
            await jrun.cleanup()
            jsrv.engine.stop()
        return jt, pt, whole

    (jtext, jusage, _), (ptext, pusage, pchunks), whole = asyncio.run(run())
    assert ptext == jtext and len(ptext) > 0
    assert pusage == jusage == {
        "prompt_tokens": len(PROMPT) + 1, "completion_tokens": 12, "total_tokens": len(PROMPT) + 13,
        "prompt_tokens_details": {"cached_tokens": 0},
    }
    assert pchunks >= 2  # a chunk per engine output: the first token, then bursts
    assert whole["choices"][0]["text"] == jtext  # the repeat hits the prefix cache
    assert whole["usage"]["prompt_tokens_details"]["cached_tokens"] > 0


@pytest.fixture(scope="module")
def port_url():
    """The port's server on the CPU, on a loop of its own thread."""
    import threading

    loop = asyncio.new_event_loop()
    cfg = EngineConfig(**dict(SMALL, model="llama-debug"), port=free_port())
    box = {}

    def serve():
        asyncio.set_event_loop(loop)
        box["srv"], box["run"] = loop.run_until_complete(
            port_server.serve(cfg, LLMEngine(cfg, device="cpu"))
        )
        box["ready"].set()
        loop.run_forever()

    box["ready"] = threading.Event()
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert box["ready"].wait(120)
    yield f"http://127.0.0.1:{cfg.port}"
    asyncio.run_coroutine_threadsafe(box["run"].cleanup(), loop).result(30)
    box["srv"].engine.stop()
    loop.call_soon_threadsafe(loop.stop)
    th.join(10)


def _call(method, url, body=None):
    async def run():
        async with aiohttp.ClientSession() as s:
            async with s.request(method, url, json=body) as r:
                ctype = r.headers.get("Content-Type", "")
                return r.status, (await r.json()) if "json" in ctype else await r.text()

    return asyncio.run(run())


@pytest.mark.parametrize("path", ["/health", "/ping", "/version", "/v1/models", "/metrics"])
def test_get_routes(port_url, path):
    status, body = _call("GET", port_url + path)
    assert status == 200
    if path == "/v1/models":
        assert body["data"][0]["id"] == "llama-debug" and body["data"][0]["max_model_len"] == 256
    if path == "/metrics":
        for name in ("num_requests_running", "gpu_cache_usage_perc", "generation_tokens_total",
                     "time_to_first_token_seconds_bucket"):
            assert f"vllm:{name}" in body


def test_chat_tokenize_detokenize_and_errors(port_url):
    status, body = _call("POST", port_url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5, "temperature": 0.0,
        "ignore_eos": True, "logprobs": True, "top_logprobs": 3,
    })
    assert status == 200 and body["object"] == "chat.completion"
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant" and choice["finish_reason"] == "length"
    assert len(choice["logprobs"]["content"]) == 5 and len(choice["logprobs"]["content"][0]["top_logprobs"]) == 3
    status, body = _call("POST", port_url + "/tokenize", {"prompt": "abc"})
    assert status == 200 and body["tokens"] == [256, 97, 98, 99] and body["count"] == 4
    status, body = _call("POST", port_url + "/detokenize", {"tokens": [97, 98, 99]})
    assert status == 200 and body == {"prompt": "abc"}
    status, body = _call("POST", port_url + "/v1/completions", {"prompt": "x", "model": "nope"})
    assert status == 404
    status, body = _call("POST", port_url + "/v1/completions", {"prompt": "x", "logit_bias": {"999": 1}})
    assert status == 400 and "out of range" in body["error"]["message"]
    status, body = _call("POST", port_url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "tools": [{"type": "function", "function": {"name": "f"}}],
        "max_tokens": 3,
    })
    assert status == 200 and body["choices"][0]["message"]["role"] == "assistant"
    status, body = _call("POST", port_url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "tools": [{"type": "function"}],
    })
    assert status == 400 and "each tool must be" in body["error"]["message"]


def test_n_choices_stop_strings_and_penalties(port_url):
    status, body = _call("POST", port_url + "/v1/completions", {
        "prompt": "hello", "max_tokens": 6, "n": 3, "temperature": 0.9, "ignore_eos": True,
        "presence_penalty": 0.5, "frequency_penalty": 0.3, "repetition_penalty": 1.2, "logit_bias": {"97": 5},
    })
    assert status == 200
    assert sorted(c["index"] for c in body["choices"]) == [0, 1, 2]
    assert body["usage"]["completion_tokens"] == 18
    status, body = _call("POST", port_url + "/v1/completions", {
        "prompt": "hello", "max_tokens": 20, "temperature": 0.0, "ignore_eos": True,
        "logit_bias": {"120": 100}, "stop": ["xx"],
    })
    assert status == 200
    # every draw is "x": the stop string starts at the first byte, so the
    # text before it is empty and the output ends at the token completing it
    assert body["choices"][0]["finish_reason"] == "stop" and body["choices"][0]["text"] == ""
    assert body["usage"]["completion_tokens"] == 2


def test_engine_config_dataclass_matches_the_jax_fields():
    """Every field of the port's EngineConfig is a JAX field with the same
    default, so a flag the port takes means the same to both servers; the
    port's own deployment knobs (PORT_ONLY) are no JAX field."""
    port = {f.name: f.default for f in dataclasses.fields(EngineConfig) if f.name not in PORT_ONLY}
    jax_cfg = {f.name: f.default for f in dataclasses.fields(JaxEngineConfig)}
    assert not set(PORT_ONLY) & jax_cfg.keys()
    assert port.keys() <= jax_cfg.keys()
    assert {k: v for k, v in port.items() if k != "attn_impl"} == {
        k: jax_cfg[k] for k in port if k != "attn_impl"
    }
