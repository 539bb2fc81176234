"""The PyTorch port stands alone: it imports with jax blocked, loads no module
of the JAX package, its sources name neither and start none of its modules by
name, its router and fleet controller run with jax and torch blocked, its
entry points run on the card unless the caller asks for the CPU, and it
refuses what it lacks."""

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import production_stack_tpu_torch
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported, resolve_attn_impl

PKG = pathlib.Path(production_stack_tpu_torch.__file__).parent
REPO = PKG.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
import production_stack_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m == "production_stack_tpu" or m.startswith("production_stack_tpu.")
)
assert not leaked, leaked
print(" ".join(names))
"""


def test_the_scan_finds_every_port_script():
    """The scripts that drive the port are found by what they import, so a
    new one is scanned without being listed."""
    for script in ("scripts/profile_torch_step.py", "scripts/decode_variants.py", "scripts/prefill_phase_clocks.py",
                   "scripts/chaos_check_torch.py", "scripts/kv_directory_report_torch.py",
                   "scripts/fleet_controller_torch.py"):
        assert script in PORT_SCRIPTS
    for script in ("scripts/profile_decode.py", "scripts/chaos_check.py", "scripts/kv_directory_report.py"):
        assert script not in PORT_SCRIPTS  # JAX package scripts
    # the port's test fleet is scanned with the package
    for mod in ("__init__", "procs", "trace_gen", "fake_engine", "fake_apiserver"):
        assert f"production_stack_tpu_torch/testing/{mod}.py" in _PORT_SOURCES


def test_every_module_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.strip().splitlines()[-1].split())
    # every module was walked: the int8 KV, offload, stack-service, fabric
    # and router ones among them
    assert len(names) >= 94
    for mod in ("ops.quant", "engine.linkprobe", "kvoffload.serde", "kvoffload.protocol", "kvoffload.tiers",
                "kvoffload.connector", "parallel.group", "parallel.tp", "parallel.dp", "parallel.ep", "engine.distributed",
                "tracing.context", "tracing.collector", "kvoffload.cache_server", "kvoffload.controller",
                "kvoffload.warmstart", "kvoffload.transfer", "kvfabric", "kvfabric.wire", "kvfabric.peers",
                "kvfabric.client", "kvfabric.server", "migration.controller", "utils.signals", "router", "router.app",
                "router.batch_service", "router.callbacks", "router.dynamic_config", "router.engine_stats",
                "router.feature_gates", "router.files_service", "router.hashtrie", "router.parser", "router.pii",
                "router.request_service", "router.request_stats", "router.resilience", "router.rewriter",
                "router.routing_logic", "router.semantic_cache", "router.service_discovery", "router.slo",
                "router.utils", "testing", "testing.procs", "testing.trace_gen", "testing.fake_engine",
                "testing.fake_apiserver"):
        assert f"production_stack_tpu_torch.{mod}" in names


# runs a module (``-m``) or a script of the port, its arguments after it,
# with jax and torch blocked, and prints at exit what it loaded of the JAX
# package and whether torch was loaded, then the port's modules it loaded
_BLOCKED = r"""
import atexit, runpy, sys
sys.modules["jax"] = sys.modules["torch"] = None  # an import of either raises
atexit.register(lambda: print("LOADED", sorted(
    m for m in sys.modules if m == "production_stack_tpu" or m.startswith("production_stack_tpu.")),
    sys.modules["torch"] is not None, "\nPORT", sorted(
    m for m in sys.modules if m.startswith("production_stack_tpu_torch.")), flush=True))
target, sys.argv = sys.argv[1], sys.argv[1:]
if target.endswith(".py"):
    runpy.run_path(target, run_name="__main__")
else:
    runpy.run_module(target, run_name="__main__", alter_sys=True)
"""


def test_the_router_and_the_fleet_controller_run_with_jax_and_torch_blocked():
    """``python -m production_stack_tpu_torch.router.app`` serves /health and
    /metrics with kvaware routing (the tokenizer and the directory client
    loaded) and drains on SIGTERM, scripts/fleet_controller_torch.py makes a
    tick, and ``python -m production_stack_tpu_torch.testing.fake_engine``
    with its directory, fabric and migration flags answers a completion (the
    chain hashes, the tokenizer, the serde and the directory client loaded),
    lists /migratable and drains on SIGTERM, with neither jax nor torch
    importable; none loads a module of the JAX package."""
    import signal
    import socket
    import time
    import urllib.request

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    port, dead = free_port(), f"http://127.0.0.1:{free_port()}"
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "PSTPU_DRAIN_NOTICE": "0"}
    router = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED, "production_stack_tpu_torch.router.app", "--host", "127.0.0.1", "--port",
         str(port), "--static-backends", dead, "--static-models", "m", "--routing-logic", "kvaware",
         "--kv-directory-url", "127.0.0.1:1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while True:
            assert router.poll() is None and time.time() < deadline, router.stdout.read()[-3000:]
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    assert b"vllm_router:kvaware_v2_cold_routes_total 0" in r.read()
                break
            except OSError:
                time.sleep(0.2)
        router.send_signal(signal.SIGTERM)
        out = router.communicate(timeout=60)[0]
    finally:
        router.kill()
    assert router.returncode == 0 and "LOADED [] False" in out, out[-3000:]
    ctl = subprocess.run([sys.executable, "-c", _BLOCKED, "scripts/fleet_controller_torch.py", "--engines", dead,
                          "--once"], cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert ctl.returncode == 0 and "LOADED [] False" in ctl.stdout, ctl.stdout[-2000:] + ctl.stderr[-2000:]
    assert json.loads(ctl.stdout[ctl.stdout.index("["):ctl.stdout.index("LOADED")]) == []

    fport = free_port()
    fake = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED, "production_stack_tpu_torch.testing.fake_engine", "--port", str(fport),
         "--model", "m", "--speed", "500", "--kv-directory-url", "127.0.0.1:1", "--fabric", "--migration"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{fport}"
    try:
        deadline = time.time() + 60
        while True:
            assert fake.poll() is None and time.time() < deadline, fake.stdout.read()[-3000:]
            try:
                with urllib.request.urlopen(f"{base}/health", timeout=2):
                    break
            except OSError:
                time.sleep(0.2)
        req = urllib.request.Request(f"{base}/v1/completions", data=json.dumps(
            {"model": "m", "prompt": "a prompt of two pages " * 3, "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["choices"][0]["text"]
        with urllib.request.urlopen(f"{base}/migratable", timeout=5) as r:
            json.loads(r.read())
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            assert b"fake:served_total" in r.read()
        fake.send_signal(signal.SIGTERM)
        out = fake.communicate(timeout=60)[0]
    finally:
        fake.kill()
    assert fake.returncode == 0 and "LOADED [] False" in out, out[-3000:]
    for mod in ("production_stack_tpu_torch.engine.kv_manager", "production_stack_tpu_torch.engine.tokenizer",
                "production_stack_tpu_torch.kvoffload.serde", "production_stack_tpu_torch.kvoffload.protocol"):
        assert repr(mod) in out[out.index("PORT"):], mod  # loaded on the request path


# a multi-host follower host (api_server.serve's branch for a process id
# other than 0) on the CPU with jax blocked, its coordinator dead; at exit
# what it loaded of the JAX package, then the port's modules it loaded
_FOLLOWER_HOST = r"""
import asyncio, atexit, sys
sys.modules["jax"] = None  # an import of jax raises
atexit.register(lambda: print("LOADED", sorted(
    m for m in sys.modules if m == "production_stack_tpu" or m.startswith("production_stack_tpu.")),
    "\nPORT", sorted(m for m in sys.modules if m.startswith("production_stack_tpu_torch.")), flush=True))
from production_stack_tpu_torch.engine.api_server import serve
from production_stack_tpu_torch.engine.config import EngineConfig

if __name__ == "__main__":
    asyncio.run(serve(EngineConfig(model="llama-debug", data_parallel_size=2, tensor_parallel_size=2,
                                   tp_backend="gloo", distributed_num_processes=2, distributed_process_id=1,
                                   distributed_coordinator=sys.argv[1]), device="cpu"))
"""


def test_a_follower_host_that_cannot_reach_its_leader_exits_nonzero_with_jax_blocked():
    """The multi-host path (engine.distributed's follower host, its rank
    block, parallel.group's rendezvous) with jax blocked: with no leader at
    the coordinator, the follower host and its spawned rank give up after
    the rank timeout (PSTPU_RANK_TIMEOUT_S), exit non-zero and leave no
    process behind, having loaded nothing of the JAX package."""
    import socket
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "PSTPU_RANK_TIMEOUT_S": "3"}
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", _FOLLOWER_HOST, dead], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and time.monotonic() - t0 < 90, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
    port = out.stdout[out.stdout.index("PORT"):]
    for mod in ("engine.distributed", "parallel.group", "engine.api_server"):
        assert f"'production_stack_tpu_torch.{mod}'" in port, mod
    assert "DistStoreError" in out.stderr or "TimeoutError" in out.stderr or "timed out" in out.stderr, \
        out.stderr[-3000:]


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|production_stack_tpu(?!_torch))\b", re.M)
# a script belongs to the port when it imports the port or chip_smoke.py
_PORT_SCRIPT = re.compile(r"\b(production_stack_tpu_torch|chip_smoke)\b")
PORT_SCRIPTS = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "scripts").glob("*.py") if _PORT_SCRIPT.search(p.read_text())
)


_PORT_SOURCES = sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"] + PORT_SCRIPTS


@pytest.mark.parametrize("path", _PORT_SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)


# a module of the JAX package started or loaded by its name: an argument
# after ``-m`` (in a list or a command line), importlib.import_module, or
# runpy's run_module
_STARTED = re.compile(
    r"""(-m["']?\s*,?\s*["']?|import_module\(\s*f?["']|run_module\(\s*f?["'])production_stack_tpu(?!_torch)\b""")


def test_the_started_by_name_guard_sees_each_form():
    for text in ('[sys.executable, "-m", "production_stack_tpu.router.app"]',
                 "start_proc(['-m', 'production_stack_tpu.engine.api_server'])",
                 "python -m production_stack_tpu.router.app --port 8000",
                 'importlib.import_module("production_stack_tpu.router.parser")',
                 "runpy.run_module('production_stack_tpu.router.app', run_name='__main__')"):
        assert _STARTED.search(text), text
    for text in ('[sys.executable, "-m", "production_stack_tpu_torch.router.app"]',
                 'importlib.import_module(f"production_stack_tpu_torch.{name}")',
                 '"replaces": "production_stack_tpu/ops/pallas/paged_attention.py:67"'):
        assert not _STARTED.search(text), text


@pytest.mark.parametrize("path", _PORT_SOURCES)
def test_source_starts_no_module_of_the_jax_package_by_name(path):
    text = (REPO / path).read_text()
    assert not _STARTED.search(text), _STARTED.search(text).group(0)
    # the port has its own test fleet: no port source names the JAX one
    # (whose process helpers set the JAX platform for what they start)
    assert not re.search(r"\bproduction_stack_tpu\.testing\b", text)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _load(device=None):
    from production_stack_tpu_torch.engine.model_loader import load_model

    return load_model("llama-debug") if device is None else load_model("llama-debug", device=device)


def _runner(device=None):
    from production_stack_tpu_torch.engine.runner import ModelRunner

    _, _, model = _load("cpu")
    kw = {} if device is None else {"device": device}
    return ModelRunner(model, num_pages=8, page_size=8, **kw)


def _engine(device=None):
    from production_stack_tpu_torch.engine.engine import LLMEngine

    cfg = EngineConfig(model="llama-debug", num_pages=16, page_size=8, max_model_len=128)
    return LLMEngine(cfg) if device is None else LLMEngine(cfg, device=device)


@pytest.mark.parametrize("entry", [_load, _runner, _engine], ids=["loader", "runner", "engine"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry("cuda")
    assert entry("cpu") is not None  # the CPU only when asked for


def test_runner_resolves_attention_by_device():
    r = _runner("cpu")
    assert r.cfg.attn_impl == "plain"
    assert r.device == torch.device("cpu")
    assert resolve_attn_impl("auto", "cuda:0") == "cuda"
    assert resolve_attn_impl("plain", "cuda") == "plain"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_attn_impl("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        resolve_attn_impl("pallas", "cpu")


_REFUSED = [
    # tensor, in-engine data, sequence, expert and pipeline parallelism are
    # served, LoRA on each of them too (_LORA_SERVED), sp beside dp or pp
    # ranks too; what they lack, device KV transfer with sp ranks, is
    # refused (KH % tp != 0, an ep that does not divide the experts and a
    # pp that does not divide the layers are refused by the engine, which
    # reads the model: tests/test_torch_tp.py, tests/test_torch_ep.py,
    # tests/test_torch_pp.py, tests/test_torch_sp.py). Speculative decoding
    # is served; with int8 pools it is refused in the JAX engine's words
    ("sequence_parallel_size", 2, {"kv_transfer_device": True}),
    ("speculative_k", 4, {"kv_cache_dtype": "int8"}),
    # disaggregated prefill and the fabric are served; the device path is
    # refused with tp ranks and off the card (check_supported's device)
    ("kv_transfer_device", True, {"tensor_parallel_size": 2}),
    ("kv_transfer_device", True, {"device": "cpu"}),
    ("kv_write_mode", "pre", {}),
]
# the refusals in the JAX engine's words rather than the port's
_JAX_WORDS = {"speculative_k": "--kv-cache-dtype int8 is not compatible with --speculative-k"}


@pytest.mark.parametrize("field,value,also", _REFUSED,
                         ids=[f"{f}-{v}" + (f"-{next(iter(a))}" if f == "kv_transfer_device" else "")
                              for f, v, a in _REFUSED])
def test_unported_features_are_refused(field, value, also):
    assert (field in port_config._UNSUPPORTED) != bool(also)
    kw = dict(also)
    device = kw.pop("device", None)
    with pytest.raises(ValueError, match=_JAX_WORDS.get(field, "not supported by the PyTorch port")):
        check_supported(EngineConfig(**{field: value}, **kw), device=device)
    if also:  # the field alone is served
        check_supported(EngineConfig(**{field: value}))


# LoRA across the ranks: once refused, now served on every axis (the
# rank's part of each slot buffer; tests/test_torch_lora_ranks.py and its
# two companions serve them against the JAX engine)
_LORA_SERVED = [
    ("tensor_parallel_size", 2, "t"),
    ("data_parallel_size", 2, "d"),
    ("pipeline_parallel_size", 2, "p"),
    ("expert_parallel_size", 2, "e"),
]


@pytest.mark.parametrize("field,value,axis", _LORA_SERVED, ids=[f for f, _, _ in _LORA_SERVED])
def test_lora_with_ranks_is_served(field, value, axis):
    """The config passes check_supported, and the axis's last rank (its
    groups stand-ins) builds its share of the slot buffers: at tp its part
    of each split buffer, at pp its stage's layers, at dp and ep the
    whole."""
    import types

    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.engine.runner import ModelRunner

    check_supported(EngineConfig(**{field: value}, enable_lora=True, tp_backend="gloo"))
    place = types.SimpleNamespace(rank=value - 1, size=value)
    one = types.SimpleNamespace(rank=0, size=1)
    tp, ep = (value if axis == "t" else 1), (value if axis == "e" else 1)
    stage = place if axis == "p" else None
    _, _, model = load_model("llama-debug", device="cpu", tp=place if axis == "t" else None, stage=stage)
    ranks = types.SimpleNamespace(size=tp, rank=tp - 1, expert=types.SimpleNamespace(size=ep * tp, ep_size=ep),
                                  dp=place if axis == "d" else one, world=place, stage=stage, seq=None)
    lora = ModelRunner(model, num_pages=8, page_size=8, device="cpu", enable_lora=True, tp=ranks).lora
    # llama-debug: 2 layers, NH 4 x D 32 = 128 query columns, KH 2 x 32
    assert len(lora["layers"]) == (1 if axis == "p" else 2)
    layer = lora["layers"][0]
    assert layer["b_wq"].shape == (5, 16, 128 // tp) and layer["b_wk"].shape == (5, 16, 64 // tp)
    assert layer["a_wo"].shape == (5, 128 // tp, 16) and layer["a_wq"].shape == (5, 128, 16)


# the stack services the engine talks to: the remote tier (cache server),
# the KV-index controller and warm-start manifests, with their flags
_SERVED = [
    ("kv_remote_url", "127.0.0.1:9100", ["--kv-remote-url", "127.0.0.1:9100"]),
    ("kv_controller_url", "http://127.0.0.1:9000",
     ["--kv-controller-url", "http://127.0.0.1:9000", "--kv-instance-id", "e0", "--advertise-host", "10.0.0.2"]),
    ("warm_start", True, ["--warm-start", "--warm-start-namespace", "ns", "--warm-start-interval-s", "5",
                          "--warm-start-max-pages", "32", "--kv-offload-dir", "/tmp/kv"]),
]


_SERVED += [
    # disaggregated prefill's roles and the KV fabric, with their flags
    ("kv_role", "consumer", ["--kv-role", "consumer", "--kv-transfer-port", "0", "--kv-transfer-device",
                             "--kv-transfer-stage-mb", "64"]),
    ("kv_fabric", True, ["--kv-fabric", "--kv-fabric-port", "0", "--kv-fabric-retries", "1", "--kv-fabric-peer",
                         "http://10.0.0.4:8100", "--kv-fabric-stream-layers", "4", "--kv-role", "producer",
                         "--kv-peer-url", "127.0.0.1:55555", "--kv-transfer-device-host", "10.0.0.3"]),
]


@pytest.mark.parametrize("field,value,argv", _SERVED, ids=[f for f, _, _ in _SERVED])
def test_stack_service_features_are_served(field, value, argv):
    """Once refused, now served: the switch passes check_supported and its
    flags parse into the config."""
    import argparse

    assert field not in port_config._UNSUPPORTED
    check_supported(EngineConfig(**{field: value}))
    p = argparse.ArgumentParser()
    port_config.add_engine_args(p)
    cfg = port_config.config_from_args(p.parse_args(argv))
    assert getattr(cfg, field) == value
    check_supported(cfg)


def test_chained_and_speculative_decode_flags_are_served():
    """--decode-pipeline, --speculative-k and --speculative-ngram parse into
    the config and pass check_supported (the engine reads all three)."""
    import argparse

    p = argparse.ArgumentParser()
    port_config.add_engine_args(p)
    args = p.parse_args(["--decode-pipeline", "4", "--speculative-k", "3", "--speculative-ngram", "2"])
    cfg = port_config.config_from_args(args)
    assert (cfg.decode_pipeline, cfg.speculative_k, cfg.speculative_ngram) == (4, 3, 2)
    check_supported(cfg)
    check_supported(EngineConfig(decode_pipeline=4, kv_cache_dtype="int8"))
    assert not {"decode_pipeline", "speculative_k", "speculative_ngram"} & set(port_config._UNSUPPORTED)


def test_defaults_are_supported():
    check_supported(EngineConfig())
    check_supported(EngineConfig(model="llama-3.2-1b", attn_impl="cuda"))
    with pytest.raises(ValueError, match="unknown attn_impl"):
        check_supported(EngineConfig(attn_impl="xla"))


def test_int8_kv_and_the_local_offload_tiers_are_accepted():
    check_supported(EngineConfig(kv_cache_dtype="int8", kv_offload_cpu_gb=1.0, kv_offload_dir="/tmp/kv",
                                 kv_offload_disk_gb=2.0, kv_offload_max_io_pages=8, kv_spill_watermark=0.8,
                                 kv_serde="int8"))
    for dtype in ("bf16", "fp8"):  # the JAX engine's other KV dtypes are refused by name
        with pytest.raises(ValueError, match=f"kv_cache_dtype '{dtype}' is not supported"):
            check_supported(EngineConfig(kv_cache_dtype=dtype))
    import argparse

    p = argparse.ArgumentParser()
    port_config.add_engine_args(p)
    args = p.parse_args(["--kv-cache-dtype", "int8", "--kv-offload-cpu-gb", "8", "--kv-offload-max-io-pages", "0"])
    assert port_config.config_from_args(args) == EngineConfig(kv_cache_dtype="int8", kv_offload_cpu_gb=8.0,
                                                               kv_offload_max_io_pages=0)


def test_every_config_field_is_read_or_refused():
    """No flag is accepted and then ignored: each EngineConfig field is read
    somewhere in the package outside config.py, or refused."""
    import dataclasses

    config_py = PKG / "engine" / "config.py"
    src = "\n".join(p.read_text() for p in PKG.rglob("*.py") if p != config_py)
    unread = [
        f.name for f in dataclasses.fields(EngineConfig)
        if f.name not in port_config._UNSUPPORTED and not re.search(rf"cfg\.{f.name}\b", src)
    ]
    # served_model_name is read by EngineConfig.name, which the server reads
    assert unread == ["served_model_name"]
    assert "self.served_model_name" in config_py.read_text() and "cfg.name" in src


@pytest.mark.parametrize("flag", ["--compilation-cache-dir", "--kv-directory-flush-s", "--prefill-fused-kv-write",
                                  "--decode-pages-per-block", "--kv-fabric-port", "--migrate-attach-timeout-s"])
def test_cli_does_not_register_flags_the_port_ignores(flag):
    import argparse

    p = argparse.ArgumentParser()
    port_config.add_engine_args(p)
    args = p.parse_args(["--model", "llama-3.2-1b", "--page-size", "32", "--attn-impl", "plain"])
    assert port_config.config_from_args(args) == EngineConfig(model="llama-3.2-1b", page_size=32, attn_impl="plain")
    if flag in _NOW_SERVED:  # a flag of a feature the port serves now parses into its field
        field, value = _NOW_SERVED[flag]
        assert getattr(port_config.config_from_args(p.parse_args([flag, "1"])), field) == value
        return
    with pytest.raises(SystemExit):
        p.parse_args([flag, "1"])


# flags of the list above whose features the port has come to serve (the KV
# fabric's listener port; the fleet directory's flush interval and live
# migration's attach timeout)
_NOW_SERVED = {"--kv-fabric-port": ("kv_fabric_port", 1), "--kv-directory-flush-s": ("kv_directory_flush_s", 1.0),
               "--migrate-attach-timeout-s": ("migrate_attach_timeout_s", 1.0)}


def test_unported_model_features_raise():
    import dataclasses

    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.models import llama

    # MoE is served, and all-position logits (speculative verify): the last
    # position's row is the last-token forward's logits
    _, cfg, model = load_model("mixtral-debug", device="cpu")
    ids = torch.arange(1, 5, dtype=torch.int32)[None]
    pos = torch.arange(4, dtype=torch.int32)[None]
    pt, lens = torch.zeros((1, 1), dtype=torch.int32), torch.tensor([4], dtype=torch.int32)
    out = [model(ids, pos, *llama.init_kv_pages(cfg, 2, 8, "cpu"), pt, lens, all_logits=a) for a in (True, False)]
    assert out[0].shape == (1, 4, cfg.vocab_size) and torch.isfinite(out[0]).all()
    torch.testing.assert_close(out[0][:, -1], out[1], rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="kv_write_mode"):
        llama.LlamaForCausalLM(dataclasses.replace(llama.PRESETS["llama-debug"], kv_write_mode="pre"), device="cpu")
    with pytest.raises(ValueError, match="not a preset"):
        load_model("/no/such/hf/dir", device="cpu")


@pytest.mark.parametrize("name,ok", [("llama-3.2-1b", True), ("qwen2.5-7b", True), ("llama-debug", False)])
def test_kernel_shapes_are_checked_when_the_runner_is_built(name, ok):
    """On the card, a model the CUDA kernels cannot take (the debug
    presets' head_dim 32) is refused when the runner is built, not at its
    first request."""
    from production_stack_tpu_torch.engine.runner import check_kernel_shapes
    from production_stack_tpu_torch.models import llama

    if ok:
        check_kernel_shapes(llama.PRESETS[name])
    else:
        with pytest.raises(ValueError, match="head_dim"):
            check_kernel_shapes(llama.PRESETS[name])
