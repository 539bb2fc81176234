"""Multi-host serving on the card only: a pp 2 engine over two host
processes on the one card (this process the leader, process id 0; a
follower host subprocess, process id 1, that builds no engine), against
pp 1's forward.

llama-3.2-1b at full width cut to four layers (two a stage), seeded (every
host draws the same model), runs two rows through a 256-token prefill chunk
and six decode steps fed the seeded tokens (tests/test_torch_cuda_pp.py's
steps) at pp 1 and over the two hosts: the logits of every step within
0.25 of pp 1's and the same greedy token on at least 90% of the rows (the
chip smoke's bar for every rank layout); each stage, one a host, launched
the decode and the prefill kernel and no plain version, and relayed its
microbatches; the ranks sit on their hosts; the follower host exits 0
once the leader closes the step stream.

This file imports neither jax nor the JAX package; without a card every
test skips.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from test_torch_cuda_attention import cuda_device  # noqa: F401
from test_torch_cuda_pp import BOUND, LAYERS, TOP1, _steps

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)

# the follower host: the cut preset registered, then its block of ranks
_FOLLOWER = r"""
import dataclasses, json, sys
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.distributed import follower_host_main
from production_stack_tpu_torch.models import llama

if __name__ == "__main__":
    cfg = EngineConfig(**json.loads(sys.argv[1]))
    llama.PRESETS[cfg.model] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=int(sys.argv[2]))
    follower_host_main(cfg, 1)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _logits(engine):
    return [engine.runner.step(inp)[1].float().cpu() for inp in _steps(engine.model_cfg.vocab_size, 2)]


@pytest.mark.cuda
def test_pp2_over_two_host_processes_matches_pp1_and_every_stage_launches_both_kernels(cuda_device):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import RANK_STATS
    from production_stack_tpu_torch.models import llama

    name = f"llama-3.2-1b-l{LAYERS}"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=LAYERS)
    one = LLMEngine(EngineConfig(model=name, num_pages=64, max_model_len=1024))
    try:
        ref = _logits(one)
    finally:
        one.stop()
        del one
        torch.cuda.empty_cache()
    fields = dict(model=name, num_pages=64, max_model_len=1024, pipeline_parallel_size=2, tp_backend="gloo",
                  tp_device_ids="0", distributed_num_processes=2,
                  distributed_coordinator=f"127.0.0.1:{_free_port()}", worker_sync_port=_free_port())
    follower = subprocess.Popen(
        [sys.executable, "-c", _FOLLOWER, json.dumps(dict(fields, distributed_process_id=1)), str(LAYERS)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        engine = LLMEngine(EngineConfig(**fields, distributed_process_id=0))
        try:
            r = engine.runner
            r.rank_stats(reset=True)
            got = _logits(engine)
            stats = [dict(zip(RANK_STATS, row)) for row in r.rank_stats(reset=True)]
            labels = [d for d, _ in r.kv_pool_shard_layout()]
        finally:
            engine.stop()
        assert follower.wait(timeout=60) == 0
    finally:
        if follower.poll() is None:
            follower.kill()
            follower.wait(10)
        torch.cuda.empty_cache()
    diffs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    top1 = float(torch.cat([a.argmax(-1) == b.argmax(-1) for a, b in zip(got, ref)]).double().mean())
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert max(diffs) <= BOUND, diffs
    assert top1 >= TOP1, top1
    assert labels == ["host0/cuda:0/pp0tp0", "host1/cuda:0/pp1tp0"]
    for p, row in enumerate(stats):
        assert row["decode_attention"] > 0 and row["prefill_attention"] > 0, (p, row)
        assert row["decode_attention_ref"] == row["prefill_attention_ref"] == 0, (p, row)
        assert row["relay_calls"] > 0 and row["relay_bytes"] > 0, (p, row)
