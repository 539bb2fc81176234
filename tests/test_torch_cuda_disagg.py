"""Disaggregated prefill's device path on the card (jax-free, like
tests/test_torch_cuda_attention.py; without a card every test skips).

- A page offered by DeviceKVEndpoint in one process (a view one page into
  its allocation, so the offset in the caching allocator's block matters)
  is opened and copied in another, byte-identical.
- The producer's offer retirement: with the consumer's answer, or by
  age for an offer never answered, and the pinned bytes.
- A staged page whose restore waits behind other work on the engine's
  stream keeps its bytes while the next pulls land (the pull's copy stream
  must not take its memory back before the restore read it).
- A producer process and a consumer process on llama-debug: every full page
  of the prompt crosses over CUDA IPC (no TCP blob), the consumer's
  admission writes the staged device pages, and its greedy tokens are a
  monolithic engine's.
- A killed producer endpoint: the consumer's pull fails fast, the address
  is marked dead, and the page ships as a TCP blob with the same tokens.
"""

import asyncio
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import pytest
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvoffload.transfer import DeviceKVEndpoint

REPO = pathlib.Path(__file__).resolve().parent.parent
SHAPE = (16, 64, 8, 64)  # llama-3.2-1b's page: [L, page, KH, D]

# a producer endpoint in a process of its own: offers seeded K and V (the
# last two of three seeded pages: a view at an offset) under uuid 7, and n
# more seeded pages of the given dtype under uuids 100, 101, ...; prints its
# address, and holds them until its stdin closes
_PRODUCER = r"""
import sys, torch
from production_stack_tpu_torch.kvoffload.transfer import DeviceKVEndpoint
seed, shape = int(sys.argv[1]), tuple(int(x) for x in sys.argv[2].split(","))
n, dtype = int(sys.argv[3]), getattr(torch, sys.argv[4])
dev = torch.device("cuda")
kv = torch.randn((3,) + shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev).to(torch.bfloat16)
ep = DeviceKVEndpoint(dev)
ep.offer_fixed(7, kv[1:])
pages = torch.randn((n, 2) + shape, generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev).to(dtype)
for i in range(n):
    ep.offer_fixed(100 + i, pages[i].clone())
print(ep.address, flush=True)
sys.stdin.read()
ep.close()
"""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA IPC between two processes went unchecked here "
                    "(run pytest -m cuda on the card; chip_smoke.py's disagg phase checks it too)")
    return torch.device("cuda")


def _expected(seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((3,) + SHAPE, generator=g, device=device).to(torch.bfloat16)[1:]


def _start_producer(seed, shape=SHAPE, n=0, dtype="bfloat16"):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", _PRODUCER, str(seed), ",".join(map(str, shape)), str(n), dtype],
                            cwd=REPO, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    addr = proc.stdout.readline().strip()
    if not addr:
        proc.kill()
        pytest.fail(f"the producer endpoint did not start: {proc.stderr.read()[-2000:]}")
    return proc, addr


@pytest.mark.cuda
def test_an_offered_page_is_copied_in_another_process_byte_identical(cuda_device):
    proc, addr = _start_producer(11)
    try:
        ep = DeviceKVEndpoint(cuda_device)
        k, v = ep.pull(addr, 7, list(SHAPE), "bfloat16")
        want = _expected(11, cuda_device)
        assert k.shape == SHAPE and k.dtype == torch.bfloat16
        assert torch.equal(k.view(torch.int16), want[0].view(torch.int16))
        assert torch.equal(v.view(torch.int16), want[1].view(torch.int16))
        assert ep.pulled_pages == 1
        with pytest.raises(LookupError):
            ep.pull(addr, 8, list(SHAPE), "bfloat16")  # an uuid never offered
        with pytest.raises(ValueError):
            ep.pull(addr, 7, [16, 64, 8, 32], "bfloat16")  # not what was offered
        ep.close()
    finally:
        proc.stdin.close()
        proc.wait(timeout=30)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]


@pytest.mark.cuda
def test_offers_retire_with_their_answer_or_by_age(cuda_device):
    ep = DeviceKVEndpoint(cuda_device)
    page = torch.zeros((2,) + SHAPE, dtype=torch.bfloat16, device=cuda_device)
    nbytes = page.numel() * page.element_size()
    ep.OFFER_TTL = 0.2
    for u in range(3):
        ep.offer_fixed(u, page.clone())
    assert ep.pinned_offer_bytes() == 3 * nbytes and ep.handle(0) is not None
    ep.retire(0)
    assert ep.handle(0) is None and ep.pinned_offer_bytes() == 2 * nbytes and ep.leaked_offers == 0
    time.sleep(0.3)
    ep.OFFER_TTL = 60.0
    ep.offer_fixed(3, page.clone())  # the sweep drops the two never answered
    assert ep.leaked_offers == 2 and ep.handle(1) is None and ep.pinned_offer_bytes() == nbytes
    ep.retire(3)
    assert ep.stats()["kv_transfer_pinned_offer_bytes"] == 0
    ep.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# llama-debug's head_dim 32 is not the kernels' (64, 128, 256): its engines
# run their plain versions, the device path is what is under test
_SMALL = dict(model="llama-debug", host="127.0.0.1", max_model_len=256, max_num_seqs=4, num_pages=64, page_size=8,
              prefill_chunk=32, attn_impl="plain")
PROMPT = "a fairly long shared prompt that spans multiple kv pages " * 3


def _greedy(engine, rid, n=8):
    async def go():
        toks = []
        async for out in engine.generate(rid, prompt=PROMPT, params=SamplingParams(max_tokens=n, temperature=0.0,
                                                                                   ignore_eos=True)):
            toks.extend(out.token_ids)
        return toks

    return asyncio.run(go())


def _mono():
    mono = LLMEngine(EngineConfig(**_SMALL, port=_free_port()), device="cuda")
    mono.start()
    try:
        return _greedy(mono, "mono")
    finally:
        mono.stop()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.cuda
def test_a_producer_process_ships_every_page_over_cuda_ipc(cuda_device):
    rport, pport = _free_port(), _free_port()
    consumer = LLMEngine(EngineConfig(**_SMALL, port=_free_port(), kv_role="consumer", kv_transfer_port=rport,
                                      kv_transfer_device=True), device="cuda")
    consumer.start()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    log = tempfile.TemporaryFile()
    producer = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.api_server", "--model", "llama-debug",
         "--host", "127.0.0.1", "--port", str(pport), "--max-model-len", "256", "--max-num-seqs", "4",
         "--num-pages", "64", "--page-size", "8", "--prefill-chunk", "32", "--attn-impl", "plain",
         "--kv-role", "producer", "--kv-peer-url", f"127.0.0.1:{rport}", "--kv-transfer-device"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=log,
    )
    try:
        deadline = time.time() + 120
        while True:
            if producer.poll() is not None:
                log.seek(0)
                pytest.fail(f"the producer exited: {log.read()[-3000:].decode(errors='replace')}")
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{pport}/health", timeout=2)
                break
            except OSError:
                assert time.time() < deadline, "the producer did not start"
                time.sleep(0.5)
        _post(f"http://127.0.0.1:{pport}/v1/completions",
              {"prompt": PROMPT, "max_tokens": 1, "temperature": 0.0, "kv_transfer_params": {"request_id": "r1"}})
        with urllib.request.urlopen(f"http://127.0.0.1:{pport}/stats", timeout=30) as r:
            pst = json.loads(r.read())
        pages = len(consumer.tokenizer.encode(PROMPT)) // 8
        assert pst["kv_transfer_device_pages_total"] == pages and pst["kv_transfer_sent_chunks_total"] == 0
        assert pst["kv_transfer_pinned_offer_bytes"] == 0  # every offer retired with its answer
        toks = _greedy(consumer, "r1")
        st = consumer.stats()
        assert st["kv_transfer_device_pages_total"] == pages and st["kv_transfer_received_chunks_total"] == 0
        assert st["kv_offload_device_loaded_pages_total"] == pages and consumer.kv.offload_hits >= pages
    finally:
        producer.send_signal(signal.SIGTERM)
        producer.wait(timeout=60)
        consumer.stop()
    assert toks == _mono()


@pytest.mark.cuda
def test_a_killed_producer_fails_the_pull_fast_and_the_page_ships_as_a_blob(cuda_device):
    proc, dead = _start_producer(3)
    proc.kill()
    proc.wait(timeout=30)
    consumer = LLMEngine(EngineConfig(**_SMALL, port=_free_port(), kv_role="consumer", kv_transfer_port=0,
                                      kv_transfer_device=True), device="cuda")
    consumer.start()
    producer = LLMEngine(EngineConfig(**_SMALL, port=_free_port(), kv_role="producer", kv_transfer_device=True,
                                      kv_peer_url=f"127.0.0.1:{consumer._kv_receiver.bound_port}"), device="cuda")
    producer.start()
    try:
        producer._kv_sender._dev_addr = dead  # every pull now meets a dead endpoint
        t0 = time.perf_counter()
        _greedy(producer, "fb-1", n=1)
        assert time.perf_counter() - t0 < 2 * DeviceKVEndpoint.PROBE_TIMEOUT_S
        assert consumer.runner.kv_endpoint._dead_addrs.get(dead, 0) > time.monotonic()
        pages = len(consumer.tokenizer.encode(PROMPT)) // 8
        assert producer._kv_sender.sent_chunks == pages and producer._kv_sender.device_pages == 0
        assert consumer._kv_receiver.received_chunks == pages and consumer._kv_receiver.device_pages == 0
        toks = _greedy(consumer, "fb-2")
        assert consumer.kv.offload_hits >= pages and consumer._offload.device_loaded_pages == 0
    finally:
        producer.stop()
        consumer.stop()
    assert toks == _mono()


@pytest.mark.cuda
def test_a_restore_queued_behind_work_keeps_its_page_while_more_pulls_land(cuda_device):
    engine = LLMEngine(EngineConfig(**_SMALL, port=_free_port()), device="cuda")
    runner = engine.runner
    shape = tuple(runner.k_pages[:, 0].shape)
    dtype = str(runner.k_pages.dtype).removeprefix("torch.")
    n = 6
    proc, addr = _start_producer(5, shape, n, dtype)
    try:
        runner.kv_endpoint = DeviceKVEndpoint(cuda_device)
        for i in range(n):
            assert runner.kv_pull_page(addr, 100 + i, list(shape), dtype, f"p{i}") > 0
            # the engine's stream is busy: the restore's write is queued
            # behind this while the next pull runs on the copy stream
            torch.cuda._sleep(50_000_000)
            runner.kv_restore_page(f"p{i}", 1 + i)
        torch.cuda.synchronize()
        g = torch.Generator(device=cuda_device).manual_seed(6)
        want = torch.randn((n, 2) + shape, generator=g, device=cuda_device).to(runner.k_pages.dtype)
        for i in range(n):
            assert torch.equal(runner.k_pages[:, 1 + i], want[i, 0]), f"page {i}'s K was overwritten"
            assert torch.equal(runner.v_pages[:, 1 + i], want[i, 1]), f"page {i}'s V was overwritten"
        runner.kv_endpoint.close()
    finally:
        proc.stdin.close()
        proc.wait(timeout=30)
