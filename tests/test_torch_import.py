"""The PyTorch port stands alone: it imports with jax blocked, loads no module
of the JAX package, its sources name neither, its entry points run on the
card unless the caller asks for the CPU, and it refuses what it lacks."""

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


def test_every_module_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 26  # every module was walked, the int8 KV and offload ones among them
    for mod in ("ops.quant", "engine.linkprobe", "kvoffload.serde", "kvoffload.protocol", "kvoffload.tiers",
                "kvoffload.connector"):
        assert f"production_stack_tpu_torch.{mod}" in names


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|production_stack_tpu(?!_torch))\b", re.M)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")) + ["chip_smoke.py", "scripts/profile_torch_step.py", "scripts/decode_variants.py"],
)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)


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


@pytest.mark.parametrize(
    "field,value",
    [
        ("tensor_parallel_size", 2),
        ("pipeline_parallel_size", 2),
        ("enable_lora", True),
        ("speculative_k", 4),
        ("kv_role", "producer"),
        ("kv_fabric", True),
        ("kv_write_mode", "pre"),
        ("decode_pipeline", 4),
        ("kv_remote_url", "127.0.0.1:9100"),
        ("kv_controller_url", "http://127.0.0.1:9000"),
        ("kv_directory_url", "http://127.0.0.1:9200"),
        ("warm_start", True),
    ],
)
def test_unported_features_are_refused(field, value):
    assert field in port_config._UNSUPPORTED
    with pytest.raises(ValueError, match="not supported by the PyTorch port"):
        check_supported(EngineConfig(**{field: value}))


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


@pytest.mark.parametrize("flag", ["--compilation-cache-dir", "--tool-call-parser", "--prefill-fused-kv-write",
                                  "--decode-pages-per-block", "--kv-fabric-port", "--trace-sample-rate"])
def test_cli_does_not_register_flags_the_port_ignores(flag):
    import argparse

    p = argparse.ArgumentParser()
    port_config.add_engine_args(p)
    args = p.parse_args(["--model", "llama-3.2-1b", "--page-size", "32", "--attn-impl", "plain"])
    assert port_config.config_from_args(args) == EngineConfig(model="llama-3.2-1b", page_size=32, attn_impl="plain")
    with pytest.raises(SystemExit):
        p.parse_args([flag, "1"])


def test_unported_model_features_raise():
    import dataclasses

    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.models import llama

    with pytest.raises(NotImplementedError, match="MoE"):
        llama.LlamaForCausalLM(dataclasses.replace(llama.PRESETS["llama-debug"], num_experts=4), device="cpu")
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
