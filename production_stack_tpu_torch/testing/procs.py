"""Helpers to launch stack components as subprocesses for e2e tests.

The port's copy of ``production_stack_tpu/testing/procs.py``: real HTTP
servers on localhost ports, no cluster. The environment names no device: a
port process runs on the CPU only because its command line asks for it
(``device="cpu"`` in process, or a service that never touches torch).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import requests

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cpu_env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", REPO_ROOT)
    if extra:
        env.update(extra)
    return env


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_proc(argv: list[str], extra_env: dict | None = None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable] + argv,
        env=cpu_env(extra_env),
        cwd=REPO_ROOT,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def wait_healthy(url: str, proc: subprocess.Popen, timeout: float = 90.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            out = proc.stdout.read() if proc.stdout else ""
            raise RuntimeError(f"process died (rc={proc.returncode}):\n{out[-4000:]}")
        try:
            if requests.get(url, timeout=2).status_code == 200:
                return
        except requests.RequestException:
            pass
        time.sleep(0.3)
    proc.kill()
    raise TimeoutError(f"{url} not healthy after {timeout}s")


def stop_proc(proc: subprocess.Popen) -> str:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5)
    return proc.stdout.read() if proc.stdout else ""
