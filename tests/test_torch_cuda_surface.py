"""Sleep mode and device telemetry of the port on the card (jax-free, like
tests/test_torch_cuda_attention.py; without a card every test skips).

A runner of llama-3.2-1b at full width, cut to four layers, runs a prefill
chunk and a decode burst through both CUDA kernels, then:

- level 1: dropping its pools gives the card back at least the pools'
  bytes (``torch.cuda.memory_reserved`` after ``empty_cache``), and the
  fresh pools at their new addresses give the same output bytes, through
  the kernels again;
- level 2: offloading the weights too gives back at least weights plus
  pools, restoring them puts every parameter back byte for byte with the
  tied head still the embedding itself, and the outputs repeat;
- engine/devicemon.py reports ``device="cuda:0"`` with the allocator's
  reserved bytes against the card's total, and the pools' own bytes.
"""

import dataclasses
import gc
import types

import pytest
import torch

from production_stack_tpu_torch.engine.devicemon import DeviceMonitor, pool_bytes
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod

PAGE = 64


@pytest.fixture(scope="module")
def runner():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sleep mode's freed bytes and the kernels after wake went unchecked here "
                    "(run pytest -m cuda on the card; chip_smoke.py checks them too)")
    cfg = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=4)
    model = llama.LlamaForCausalLM(cfg, device="cuda")
    llama.init_params(model, torch.Generator(device="cuda").manual_seed(0))
    return ModelRunner(model, num_pages=256, page_size=PAGE, device="cuda")


def _run(runner) -> tuple:
    """A prefill chunk of two ragged rows, then an 8-token greedy burst:
    (prefill ids, prefill logits, burst tokens, kernel launches)."""
    launches0 = dmod.decode_attention.launches + pmod.prefill_attention.launches
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 128256, (2, PAGE), generator=g, dtype=torch.int32)
    pos = torch.arange(PAGE, dtype=torch.int32).repeat(2, 1)
    pos[1, 40:] = -1
    table = [[0, 1], [2, 3]]
    first, logits = runner.step(StepInput(ids.numpy(), pos.numpy(), table, [PAGE, 40], [0.0, 0.0], [0, 0],
                                          [1.0, 1.0]))
    burst = runner.step_multi(StepInput(first[:, None].cpu().numpy(), [[PAGE], [40]], table, [PAGE + 1, 41],
                                        [0.0, 0.0], [0, 0], [1.0, 1.0]), 8)
    torch.cuda.synchronize()
    launches = dmod.decode_attention.launches + pmod.prefill_attention.launches - launches0
    return first.cpu(), logits.cpu(), burst.cpu(), launches


def _freed(fn) -> int:
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    fn()
    gc.collect()
    torch.cuda.empty_cache()
    return before - torch.cuda.memory_reserved()


@pytest.mark.cuda
def test_sleep_level_1_frees_the_pools_and_wake_repeats_the_kernels_output(runner):
    first, logits, burst, launches = _run(runner)
    assert launches == 4 + 8 * 4  # a prefill launch and eight decode launches per layer
    pool = pool_bytes(runner)
    freed = _freed(runner.drop_kv_pools)
    assert freed >= pool, (freed, pool)
    runner.reset_kv()
    again = _run(runner)
    assert torch.equal(again[0], first) and torch.equal(again[2], burst) and again[3] == launches
    assert torch.equal(again[1].view(torch.int32), logits.view(torch.int32))


@pytest.mark.cuda
def test_sleep_level_2_frees_the_weights_and_restores_them_byte_for_byte(runner):
    runner.reset_kv()
    first, logits, burst, launches = _run(runner)
    names = [n for n, _ in runner.model.named_parameters()]
    host = {n: p.detach().cpu().clone() for n, p in runner.model.named_parameters()}
    weights = sum(t.nbytes for t in host.values())
    pool = pool_bytes(runner)

    def sleep():
        runner.drop_kv_pools()
        runner.offload_params()

    freed = _freed(sleep)
    assert freed >= weights + pool, (freed, weights, pool)
    runner.restore_params()
    runner.reset_kv()
    assert [n for n, _ in runner.model.named_parameters()] == names and "lm_head" not in names  # tied
    for n, p in runner.model.named_parameters():
        assert p.is_cuda and torch.equal(p.detach().cpu().view(torch.int16), host[n].view(torch.int16)), n
    again = _run(runner)
    assert torch.equal(again[0], first) and torch.equal(again[2], burst) and again[3] == launches
    assert torch.equal(again[1].view(torch.int32), logits.view(torch.int32))


@pytest.mark.cuda
def test_devicemon_reports_the_card(runner):
    engine = types.SimpleNamespace(runner=runner, kv=types.SimpleNamespace(usage=lambda: 0.25),
                                   loop_seconds={"step": 0.0})
    mon = DeviceMonitor(engine)
    [row] = mon.device_memory()
    assert row["device"] == "cuda:0"
    assert row["bytes_limit"] == torch.cuda.mem_get_info()[1]
    assert 0 < row["bytes_in_use"] <= row["bytes_limit"]
    text = "\n".join(mon.metrics_lines("m"))
    pool = pool_bytes(runner)
    assert pool == runner.k_pages.nbytes + runner.v_pages.nbytes > 0
    assert f'vllm:kv_pool_device_bytes{{model_name="m"}} {pool}' in text
    assert f'vllm:kv_pool_used_bytes{{model_name="m"}} {pool // 4}' in text
    assert 'vllm:tpu_hbm_bytes_in_use{model_name="m",device="cuda:0"}' in text
    assert f'vllm:kv_pool_shard_bytes{{model_name="m",device="cuda:0"}} {pool}' in text  # one rank: the pool
    entries = int(text.split('vllm:compile_cache_entries{model_name="m"} ')[1].split()[0])
    assert entries >= 2  # both kernel libraries, built before the first launch
