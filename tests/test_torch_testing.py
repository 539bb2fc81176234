"""The port's test fleet (production_stack_tpu_torch/testing/) against the
JAX package's: the trace generator gives the same trace for the same
arguments and seed, and the fake Kubernetes apiserver gives the same
answers, and the same watch events, to the same request sequence."""

import asyncio
import dataclasses
import itertools
import json

import pytest
from aiohttp import ClientSession, web

from production_stack_tpu.testing import fake_apiserver as jax_apiserver
from production_stack_tpu.testing import trace_gen as jax_trace_gen
from production_stack_tpu_torch.testing import fake_apiserver as port_apiserver
from production_stack_tpu_torch.testing import trace_gen as port_trace_gen
from production_stack_tpu_torch.testing.procs import free_port

_TRACES = {
    "defaults": dict(seed=0, duration_s=60.0, base_qps=2.0),
    "bursty": dict(seed=7, duration_s=90.0, base_qps=1.5, burst_factor=5.0, burst_period_s=20.0,
                   burst_duration_s=4.0, diurnal_period_s=45.0, diurnal_amplitude=0.9),
    "mostly_batch": dict(seed=3, duration_s=40.0, base_qps=4.0, batch_fraction=0.8, min_context=16,
                         max_context=2048, interactive_output=(4, 8), batch_output=(32, 64)),
    "empty": dict(seed=1, duration_s=0.0, base_qps=1.0),
}


@pytest.mark.parametrize("case", list(_TRACES))
def test_trace_generator_matches_the_jax_one(case):
    jax_trace = jax_trace_gen.generate_trace(**_TRACES[case])
    port_trace = port_trace_gen.generate_trace(**_TRACES[case])
    assert [dataclasses.asdict(r) for r in port_trace] == [dataclasses.asdict(r) for r in jax_trace]
    assert port_trace_gen.trace_summary(port_trace) == jax_trace_gen.trace_summary(jax_trace)
    assert len(port_trace) > 0 or case == "empty"


_BASE = "/apis/production-stack.vllm.ai/v1alpha1/namespaces/default/vllmruntimes"


def _obj(name, labels=None, finalizers=None, spec=None):
    meta = {"name": name, "labels": labels or {}}
    if finalizers:
        meta["finalizers"] = finalizers
    return {"apiVersion": "production-stack.vllm.ai/v1alpha1", "kind": "VLLMRuntime", "metadata": meta,
            "spec": spec or {"model": name}}


# (method, path, body): every branch of FakeAPIServer.handle
_SEQUENCE = [
    ("POST", _BASE, _obj("a", {"app": "x"})),
    ("POST", _BASE, _obj("b", {"app": "y"}, finalizers=["cleanup"])),
    ("POST", _BASE, _obj("a")),                                   # 409
    ("POST", _BASE, {"metadata": {}}),                            # 400
    ("GET", _BASE + "/a", None),
    ("GET", _BASE + "/missing", None),                            # 404
    ("GET", _BASE + "?labelSelector=app%3Dy", None),
    ("GET", _BASE, None),
    ("PUT", _BASE + "/a/status", {"status": {"ready": True}}),
    ("PUT", _BASE + "/a", _obj("a", {"app": "x"}, spec={"model": "a", "replicas": 2})),  # status kept
    ("PUT", _BASE + "/missing", _obj("missing")),                 # 404
    ("DELETE", _BASE + "/b", None),                               # finalizer: terminating
    ("DELETE", _BASE + "/b", None),                               # still terminating, no new version
    ("PUT", _BASE + "/b", _obj("b", {"app": "y"})),               # finalizer cleared: gone
    ("GET", _BASE + "/b", None),                                  # 404
    ("DELETE", _BASE + "/a", None),
    ("DELETE", _BASE + "/a", None),                               # 404
    ("GET", "/api/v1/namespaces/default/pods", None),
    ("GET", "/not/a/kube/path", None),                            # 404
    ("PATCH", _BASE + "/a", {}),                                  # 405
]


async def _drive(module) -> tuple[list, list]:
    """The sequence against one package's fake apiserver, with a watch on
    the collection open throughout: each answer's status and JSON, and the
    watch's events."""
    module._COUNTER = itertools.count(1)  # resourceVersions and uids from 1 in both
    app, _ = module.make_app()
    runner = web.AppRunner(app)
    await runner.setup()
    port = free_port()
    await web.TCPSite(runner, "127.0.0.1", port, shutdown_timeout=0.5).start()  # the watch never ends itself
    base = f"http://127.0.0.1:{port}"
    answers, events = [], []
    try:
        async with ClientSession() as s:
            watch = await s.get(base + _BASE + "?watch=true")
            await asyncio.sleep(0.05)  # the watcher is registered before the first write
            for method, path, body in _SEQUENCE:
                async with s.request(method, base + path, json=body) as r:
                    answers.append((method, path, r.status, await r.json()))
            while len(events) < 6:  # ADDED a, ADDED b, MODIFIED a, MODIFIED b, DELETED b, DELETED a
                line = await asyncio.wait_for(watch.content.readline(), 5)
                events.append(json.loads(line))
            watch.close()
    finally:
        await runner.cleanup()
    return answers, events


def test_fake_apiserver_answers_as_the_jax_one(monkeypatch):
    for module in (jax_apiserver, port_apiserver):
        monkeypatch.setattr(module, "_COUNTER", module._COUNTER)  # put back after the test
    jax_answers, jax_events = asyncio.run(_drive(jax_apiserver))
    port_answers, port_events = asyncio.run(_drive(port_apiserver))
    for a, b in zip(jax_answers, port_answers):
        assert a == b
    assert len(port_answers) == len(jax_answers) == len(_SEQUENCE)
    assert port_events == jax_events
    assert [e["type"] for e in port_events] == ["ADDED", "ADDED", "MODIFIED", "MODIFIED", "DELETED", "DELETED"]
    statuses = [a[2] for a in port_answers]
    assert {201, 200, 404, 409, 400, 405} <= set(statuses)
