"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17
-O3 -shared -Xcompiler -fPIC``) under ``build/torch_kernels/`` at the repo
root, named by a hash of its sources and flags so an edited source rebuilds.
Nothing is built at import: the first launch of a kernel builds its library,
and ``build()`` starts one nvcc per source, all at once, for callers that
want every kernel up front. A source listed in ``UNITS`` compiles as that
many units instead (``-c -DPST_UNIT=k``, all started together, then linked
into the one library): nvcc is single-threaded, and prefill_attention.cu's
six bf16 kernels took most of the build's wall time as one unit. nvcc's
ptxas report (registers, shared memory, spills per kernel) is kept beside
each library as ``<lib>.log``.

Each build that ran nvcc adds its wall seconds and one event per source to
the process's totals (``compile_totals``): the engine's ``/metrics`` reports
them as ``vllm:compile_seconds_total`` / ``compile_events_total``
(engine/devicemon.py), and ``cache_size`` counts the libraries on disk.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("decode_attention", "prefill_attention")
# sources built as PST_UNIT = 0 .. n - 1 (the unit count the source defines)
UNITS = {"prefill_attention": 7}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# nvcc wall seconds and sources built by this process (written under _totals_lock)
_compile_seconds_total = 0.0
_compile_events_total = 0
_totals_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + f" units={UNITS.get(name, 0)}".encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no current library, one nvcc
    per source (per unit of a source in UNITS), all started together.
    Returns wall seconds per source (0.0 for one already built). Raises
    with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}  # name -> ([(process, log file, log path)], tmp, out, objects)
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = str(CSRC / f"{name}.cu")
        n = UNITS.get(name, 0)
        if n:
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            objs = [out.with_suffix(f".{os.getpid()}.{k}.o") for k in range(n)]
            cmds = [[nvcc, *flags, "-c", f"-DPST_UNIT={k}", "-I", str(CSRC), "-o", str(o), src]
                    for k, o in enumerate(objs)]
        else:
            objs = []
            cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), src]]
        runs = []
        for k, cmd in enumerate(cmds):
            log_path = out.with_suffix(f".{os.getpid()}.{k}.log")
            log = open(log_path, "w")
            runs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, log_path))
        procs[name] = (runs, tmp, out, objs)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (runs, tmp, out, objs) in procs.items():
        rcs = []
        for proc, log, _ in runs:
            rcs.append(proc.wait())
            log.close()
        if objs and not any(rcs):
            with open(runs[0][2], "a") as log:
                rcs.append(subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], stdout=log,
                                          stderr=subprocess.STDOUT).returncode)
        out.with_suffix(".log").write_text("".join(path.read_text() for _, _, path in runs))
        for path in [*(r[2] for r in runs), *objs]:
            path.unlink(missing_ok=True)
        secs[name] = time.perf_counter() - t0
        if any(rcs):
            failed.append(f"{name}: nvcc exit {max(rcs)}\n{out.with_suffix('.log').read_text()[-4000:]}")
        else:
            os.replace(tmp, out)
    if procs:
        _count_build(time.perf_counter() - t0, len(procs) - len(failed))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def _count_build(seconds: float, events: int) -> None:
    global _compile_seconds_total, _compile_events_total
    with _totals_lock:
        _compile_seconds_total += seconds
        _compile_events_total += events
    from production_stack_tpu_torch.tracing import get_flightrecorder

    get_flightrecorder().record("compile", event="nvcc_build", seconds=round(seconds, 4), sources=events)


def compile_totals() -> tuple[float, int]:
    """(nvcc wall seconds, sources built) by this process so far."""
    with _totals_lock:
        return _compile_seconds_total, _compile_events_total


def cache_size() -> tuple[int, int]:
    """(libraries, bytes) of the built kernel libraries under BUILD_DIR."""
    libs = list(BUILD_DIR.glob("*.so")) if BUILD_DIR.is_dir() else []
    return len(libs), sum(p.stat().st_size for p in libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return lib


def ptxas_report(name: str) -> str:
    """nvcc's ptxas lines for a built library (empty if not built here)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
