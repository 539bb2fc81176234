"""Live migration between two port engines on the card (jax-free, like
tests/test_torch_cuda_attention.py; without a card every test skips).

An f32 copy of llama-3.2-1b cut to four layers, two engines in this process:
a greedy stream frozen on the source after a few tokens, its full pages
shipped to the target over the KV fabric or saved through a shared disk
tier, then restored on the target, which decodes the rest. The target's
restored device pages equal the source's bytes, the spliced ids equal the
unmigrated run's, and the target ran the prefill kernel for the tail chunk
alone (one launch a layer) and the decode kernel for the rest, no plain
version.
"""

import asyncio
import dataclasses

import pytest
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
from production_stack_tpu_torch.engine.runner import COUNTERS
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.migration import continuation_params, snapshot_from_wire, snapshot_to_wire
from production_stack_tpu_torch.models import llama

MODEL = "llama-3.2-1b-f32-l4"
LAYERS = 4
PROMPT = "".join("abcdefghijklmnopqrstuvwxyz .,"[(i * 7 + i // 5) % 29] for i in range(300))  # 4 pages and a tail
TOKENS = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: live migration through the kernels went unchecked here "
                    "(run pytest -m cuda on the card; chip_smoke.py's fleet phase checks it too)")
    llama.PRESETS[MODEL] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], dtype=torch.float32, num_layers=LAYERS)
    yield torch.device("cuda")
    llama.PRESETS.pop(MODEL, None)


def _counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in COUNTERS}


async def _collect(engine, seq_id, params, **kw):
    ids = []
    async for out in engine.generate(seq_id, params=params, **kw):
        if not (out.finished and out.finish_reason == "migrated"):
            ids.extend(out.token_ids)
    return ids


def _pages(engine, hashes):
    pids = [engine.kv.hash_to_page[h] for h in hashes]
    ks, vs = engine._run_on_device_thread(lambda: engine.runner.get_pages(pids))
    return [k.tobytes() + v.tobytes() for k, v in zip(ks, vs)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fabric", "tiers"])
def test_a_stream_migrates_between_two_engines_through_the_kernels(cuda_device, tmp_path, path):
    common = dict(model=MODEL, host="127.0.0.1", num_pages=64, max_model_len=1024)
    if path == "fabric":
        src_kw, dst_kw = dict(kv_fabric=True), dict(kv_fabric=True, kv_offload_cpu_gb=0.5, kv_offload_max_io_pages=0)
    else:
        src_kw = dst_kw = dict(kv_offload_dir=str(tmp_path), kv_offload_disk_gb=1.0, kv_offload_max_io_pages=0)
    src = LLMEngine(EngineConfig(**common, port=18501, **src_kw))
    dst = LLMEngine(EngineConfig(**common, port=18502, **dst_kw))
    src.start()
    dst.start()
    sp = SamplingParams(max_tokens=TOKENS, temperature=0.0, ignore_eos=True)
    try:
        async def run():
            loop = asyncio.get_running_loop()
            base = await _collect(src, "base", sp, prompt=PROMPT)
            got, frozen = [], asyncio.Event()

            async def source():
                async for out in src.generate("mig", prompt=PROMPT, params=sp):
                    got.extend(out.token_ids)
                    if len(got) >= 8:
                        frozen.set()

            task = asyncio.create_task(source())
            await frozen.wait()
            addr = dst._fabric_server.address if path == "fabric" else None
            snap = await loop.run_in_executor(None, src.migration.freeze_and_snapshot, "mig", {}, addr)
            snap = snapshot_from_wire(snapshot_to_wire(snap))
            await loop.run_in_executor(None, src.migration.commit, "mig", len(snap.page_hashes))
            await task
            assert await loop.run_in_executor(None, dst.migration.prefetch_pages, snap.page_hashes) == len(
                snap.page_hashes)
            before = _counts()
            cont = await _collect(dst, "mig", continuation_params(snap), prompt_token_ids=snap.tokens)
            launches = {k: v - before[k] for k, v in _counts().items()}
            return base, snap, cont, launches

        base, snap, cont, launches = asyncio.run(run())
        n = (len(snap.tokens) - 1) // 64
        assert len(snap.page_hashes) == n >= 4
        assert snap.tokens[snap.prompt_len:] + cont == base
        hashes = prefix_hashes(snap.tokens, 64)[:n]
        assert _pages(dst, hashes) == _pages(src, hashes)  # restored byte for byte
        assert dst.kv.offload_hits == n
        # the tail chunk alone was prefilled (one launch a layer), the rest decoded
        assert launches["prefill_attention"] == LAYERS and launches["kv_page_write"] == LAYERS
        assert launches["decode_attention"] > 0
        assert launches["decode_attention_ref"] == launches["prefill_attention_ref"] == 0
        if path == "fabric":
            assert src.migration.fabric_pages == n and dst._fabric_server.stats()["received_pages"] == n
    finally:
        src.stop()
        dst.stop()
