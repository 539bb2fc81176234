"""LLMEngine — the continuous-batching serving core of the port.

Execution model, as in the JAX engine: one daemon thread owns the device
(scheduler + ModelRunner) and spins the step loop; the asyncio side (HTTP
handlers) submits sequences through a thread-safe inbox and receives
``RequestOutput`` items on per-request asyncio queues.

The loop runs the main serving path: chunked prefill with prefix caching,
then fused decode bursts of ``decode_steps`` tokens, with greedy and
temperature sampling, penalties, logit bias, min_tokens, stop strings and
logprobs. Admission control (queue bound and queue deadline) sheds as the
JAX engine does. ``kv_cache_dtype="int8"`` serves from int8 pools (half the
bytes per token, about twice the pages for the same memory), and the local
offload tiers (``kv_offload_cpu_gb``, ``kv_offload_dir``) take evicted
prefix pages and give them back on a later prefix match. Not ported yet:
the remote tier, the KV-index controller, the fleet directory, warm start,
the KV fabric, migration, LoRA, speculative decoding, chained bursts,
embeddings and sleep mode (engine/config.check_supported refuses their
flags).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import os
import queue as queue_mod
import threading
import time
from typing import AsyncIterator, Optional

import numpy as np

from production_stack_tpu_torch import tracing
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.kv_manager import KVPageManager
from production_stack_tpu_torch.engine.linkprobe import derive_max_io_pages, probe_link_bandwidth
from production_stack_tpu_torch.engine.model_loader import load_model
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams, Scheduler, Sequence
from production_stack_tpu_torch.engine.tokenizer import load_tokenizer
from production_stack_tpu_torch.kvoffload.connector import KVOffloadConnector
from production_stack_tpu_torch.ops.quant import dequantize_page_host, kv_bytes_per_token, quantize_page_host
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


@dataclasses.dataclass
class RequestOutput:
    seq_id: str
    text_delta: str
    token_ids: list[int]
    finished: bool
    finish_reason: Optional[str] = None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cached_tokens: int = 0
    # per-token logprob entries aligned with token_ids (when requested):
    # {"logprob": float, "top_ids": [int], "top_logprobs": [float]}
    logprobs: Optional[list] = None


class LLMEngine:
    def __init__(self, cfg: EngineConfig, *, device="cuda", params=None):
        """``params``: a parameter dict of the port (model_loader.
        params_from_jax) to serve instead of the preset's seeded weights."""
        check_supported(cfg)
        self.cfg = cfg
        model_mod, model_cfg, model = load_model(
            cfg.model, seed=cfg.seed, device=device,
            max_model_len=cfg.max_model_len, params=params,
        )
        model.cfg = dataclasses.replace(
            model_cfg, attn_impl=cfg.attn_impl, kv_cache_dtype=cfg.kv_cache_dtype
        )
        self.kv_quant = cfg.kv_cache_dtype == "int8"
        # a checkpoint directory holds its tokenizer, as in the JAX engine
        self.tokenizer = load_tokenizer(
            cfg.tokenizer or (cfg.model if "/" in cfg.model or cfg.model.startswith(".") else None)
        )
        itemsize = model.embed.element_size()
        L, KH, D = model_cfg.num_layers, model_cfg.num_kv_heads, model_cfg.head_dim
        page_bytes = 2 * L * cfg.page_size * KH * D * (1 if self.kv_quant else itemsize)
        if self.kv_quant:
            # the pages' f32 scale rows (k and v, per KV head) ride the pool
            # budget too: int8 about doubles the pages kv_cache_memory_gb holds
            page_bytes += 2 * L * KH * 4
        self.kv_page_bytes = page_bytes
        # bytes one token costs the pool, and a startup quantize-dequantize
        # round trip on seeded normal data: the relative error bound of the
        # int8 math on this build (vllm:kv_quant_dequant_err_max)
        self.kv_bytes_per_token = kv_bytes_per_token(L, KH, D, cfg.page_size, self.kv_quant, itemsize)
        self.kv_quant_dequant_err_max = 0.0
        if self.kv_quant:
            x = np.random.RandomState(0).randn(L, cfg.page_size, KH, D).astype(np.float32)
            qx, sx = quantize_page_host(x)
            self.kv_quant_dequant_err_max = float(
                np.abs(dequantize_page_host(qx, sx) - x).max() / max(np.abs(x).max(), 1e-9)
            )
        self._fr = tracing.configure_flightrecorder(
            capacity=cfg.flight_recorder_capacity,
            enabled=cfg.flight_recorder,
            dump_dir=(
                cfg.flight_recorder_dump_dir
                or os.environ.get("PSTPU_FLIGHTRECORDER_DIR")
            ),
        )
        num_pages = cfg.num_pages or max(64, int(cfg.kv_cache_memory_gb * 1e9 / page_bytes))
        self.runner = ModelRunner(
            model, num_pages=num_pages, page_size=cfg.page_size, seed=cfg.seed,
            device=device,
        )
        self.model_cfg = self.runner.cfg
        self._offload = None
        if cfg.kv_offload_cpu_gb > 0 or cfg.kv_offload_dir:
            self._offload = KVOffloadConnector(
                self.runner,
                cpu_bytes=int(cfg.kv_offload_cpu_gb * 1e9),
                disk_path=cfg.kv_offload_dir,
                disk_bytes=int(cfg.kv_offload_disk_gb * 1e9) if cfg.kv_offload_dir else 0,
                serde=cfg.kv_serde,
            )
        # offload I/O budget: an explicit >= 0 is taken as it is; -1 derives
        # it from a startup link probe (0 = unbounded on PCIe-class links)
        self.kv_link_bandwidth_bytes_per_s = None
        max_io_pages = max(cfg.kv_offload_max_io_pages, 0)
        if cfg.kv_offload_max_io_pages < 0 and self._offload is not None:
            bw = probe_link_bandwidth(self.runner.device)
            self.kv_link_bandwidth_bytes_per_s = bw
            max_io_pages = derive_max_io_pages(bw, page_bytes)
            logger.info(
                "kv offload link probe: %s MB/s -> max_io_pages=%d",
                "?" if bw is None else f"{bw / 1e6:.1f}", max_io_pages,
            )
        self.kv = KVPageManager(
            num_pages, cfg.page_size, offload=self._offload, max_io_pages=max_io_pages,
            spill_watermark=cfg.kv_spill_watermark,
        )
        self.scheduler = Scheduler(
            self.kv,
            max_num_seqs=cfg.max_num_seqs,
            max_model_len=cfg.max_model_len,
            prefill_chunk=cfg.prefill_chunk if cfg.enable_chunked_prefill else 10**9,
            prefill_batch=cfg.prefill_batch,
            enable_prefix_caching=cfg.enable_prefix_caching,
            decode_steps=cfg.decode_steps,
            max_waiting_seqs=cfg.max_waiting_seqs,
            queue_deadline_s=cfg.queue_deadline_s,
            interactive_reserve=cfg.interactive_reserve,
            batch_queue_deadline_s=cfg.batch_queue_deadline_s,
            batch_prefill_share=cfg.batch_prefill_share,
        )
        self._inbox: queue_mod.Queue = queue_mod.Queue()
        # prefill dispatches whose results were never fetched; a deferred
        # device error taints these sequences too
        self._unfetched: list = []
        # two-writer maps (event-loop generate() registers/pops, device
        # thread _emit/_process_token reads/writes): every touch holds _lock
        self._outputs: dict[str, tuple[asyncio.AbstractEventLoop, asyncio.Queue]] = {}
        self._texts: dict[str, str] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.total_prompt_tokens = 0
        self.total_generation_tokens = 0
        self.decode_dispatches_total = 0
        # load-shed accounting, one writer per counter: requests_shed on the
        # device thread, api_requests_shed on the event loop
        self.requests_shed = {"queue_full": 0, "queue_deadline": 0}
        self.api_requests_shed = 0
        # arrival -> first prefill dispatch, ms (the ttft_hop_admission_wait
        # gauge)
        self.admission_wait_ms: collections.deque = collections.deque(maxlen=2048)
        self.loop_seconds = {"wait": 0.0, "schedule": 0.0, "step": 0.0, "apply": 0.0, "emit": 0.0}
        self.step_idx = 0

    # -- admission control --------------------------------------------------

    def saturated(self, priority: str = "interactive") -> bool:
        return self.scheduler.saturated(priority)

    def shed_retry_after(self) -> float:
        return max(0.0, self.cfg.shed_retry_after_s)

    def can_shed_queued(self) -> bool:
        return self.scheduler.queue_deadline_s > 0 or self.scheduler.max_waiting_seqs > 0

    def _shed(self, seq: Sequence, reason: str) -> None:
        self.scheduler._finish(seq, "shed")
        self.requests_shed[reason] += 1
        self._fr.record("shed", step=self.step_idx, reason=reason, seq_id=seq.seq_id)
        self._emit(seq, "")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run_loop, daemon=True, name="engine-loop")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._inbox.put(None)
        if self._thread:
            self._thread.join(timeout=10)

    # -- request api (asyncio side) -----------------------------------------

    async def generate(
        self,
        seq_id: str,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[list[int]] = None,
        params: Optional[SamplingParams] = None,
        priority: str = "interactive",
    ) -> AsyncIterator[RequestOutput]:
        params = params or SamplingParams()
        if priority not in ("interactive", "batch"):
            priority = "interactive"
        if prompt_token_ids is None:
            prompt_token_ids = self.tokenizer.encode(prompt or "")
        if not prompt_token_ids:
            if self.tokenizer.bos_token_id is None:
                # an HF tokenizer without BOS (Qwen2's): a None id would
                # stop the engine loop at its next schedule
                raise ValueError("the prompt is empty and the tokenizer has no BOS token to start from")
            prompt_token_ids = [self.tokenizer.bos_token_id]
        if len(prompt_token_ids) + 1 > self.cfg.max_model_len:
            raise ValueError(
                f"prompt has {len(prompt_token_ids)} tokens, max_model_len is "
                f"{self.cfg.max_model_len}"
            )
        out_q: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()
        with self._lock:
            self._outputs[seq_id] = (loop, out_q)
            self._texts[seq_id] = ""
        self._inbox.put(Sequence(
            seq_id=seq_id, prompt_ids=list(prompt_token_ids), params=params,
            priority=priority,
        ))
        try:
            while True:
                item = await out_q.get()
                yield item
                if item.finished:
                    break
        finally:
            with self._lock:
                self._outputs.pop(seq_id, None)
                self._texts.pop(seq_id, None)
            self._inbox.put(("abort", seq_id))

    def abort(self, seq_id: str) -> None:
        self._inbox.put(("abort", seq_id))

    # -- engine loop (device thread) ----------------------------------------

    def _drain_inbox(self, block: bool) -> None:
        timeout = 0.5 if block else None
        while True:
            try:
                item = self._inbox.get(block=block, timeout=timeout)
            except queue_mod.Empty:
                return
            block = False
            if item is None:
                return
            if isinstance(item, tuple) and item[0] == "abort":
                for s in self.scheduler.waiting + self.scheduler.running:
                    if s.seq_id == item[1] and not s.finished:
                        self.scheduler._finish(s, "abort")
                        # a consumer may still wait on its queue (POST /abort)
                        self._emit(s, "")
            elif self.scheduler.saturated(item.priority):
                # authoritative queue bound: the API layer's check races a
                # burst of arrivals the inbox has not drained yet
                self._shed(item, "queue_full")
            else:
                self.scheduler.add(item)

    def _step_input(self, batch) -> StepInput:
        inp = StepInput(
            batch.input_ids, batch.positions, batch.page_table, batch.kv_lens,
            batch.temperature, batch.top_k, batch.top_p, kv_limits=batch.kv_limits,
        )
        pad = len(batch.kv_lens) - len(batch.seqs)
        if batch.want_penalties:
            inp.history = batch.history
            inp.prompt_lens = batch.prompt_lens
            inp.presence = np.array([s.params.presence_penalty for s in batch.seqs] + [0.0] * pad, np.float32)
            inp.frequency = np.array([s.params.frequency_penalty for s in batch.seqs] + [0.0] * pad, np.float32)
            inp.repetition = np.array([s.params.repetition_penalty for s in batch.seqs] + [1.0] * pad, np.float32)
        # rows under their min_tokens floor get EOS masked out of the draw
        # for every token of this dispatch (vLLM semantics; the scheduler's
        # finish gate stays the exact backstop)
        eos = self.tokenizer.eos_token_id

        def eos_ban(s):
            return not s.params.ignore_eos and len(s.output_ids) < s.params.min_tokens

        if any(s.params.logit_bias or eos_ban(s) for s in batch.seqs):
            need = max(len(s.params.logit_bias or {}) + eos_ban(s) for s in batch.seqs)
            K = 8
            while K < need:
                K *= 2
            V = self.model_cfg.vocab_size
            bias_ids = np.full((len(batch.kv_lens), K), V, np.int32)  # V = unused slot
            bias_vals = np.zeros((len(batch.kv_lens), K), np.float32)
            for i, s in enumerate(batch.seqs):
                entries = list((s.params.logit_bias or {}).items())
                if eos_ban(s):
                    entries.append((eos, -1e9))
                for j, (tid, bv) in enumerate(entries):
                    bias_ids[i, j], bias_vals[i, j] = tid, bv
            inp.bias_ids, inp.bias_vals = bias_ids, bias_vals
        return inp

    def _dispatch(self, batch):
        """Run one scheduled batch; returns (tokens, lp_data), with tokens
        None for an all-intermediate prefill whose fetch is skipped."""
        inp = self._step_input(batch)
        runner = self.runner
        wlp = batch.want_logprobs
        if batch.kind == "decode" and self.scheduler.decode_steps > 1:
            self.decode_dispatches_total += 1
            if wlp:
                toks, lps = runner.step_multi(inp, self.scheduler.decode_steps, True)
                return toks.cpu().numpy(), tuple(x.cpu().numpy() for x in lps)
            return runner.step_multi(inp, self.scheduler.decode_steps).cpu().numpy(), None
        if batch.kind == "prefill" and not any(
            s.num_computed + c >= len(s.prompt_ids)
            for s, c in zip(batch.seqs, batch.chunk_sizes)
        ):
            # every chunk is intermediate: the sampled tokens are discarded,
            # so nothing is fetched (the launches queue behind each other)
            runner.step(inp)
            self._unfetched.append(batch)
            return None, None
        if wlp:
            ids, _, lps = runner.step(inp, want_logprobs=True)
            return ids.cpu().numpy(), tuple(x.cpu().numpy()[:, None] for x in lps)
        ids, _ = runner.step(inp)
        return ids.cpu().numpy(), None

    def _run_loop(self) -> None:
        logger.info("engine loop started (model=%s)", self.cfg.name)
        while not self._stop.is_set():
            t_sec = time.perf_counter()
            self._drain_inbox(block=not self.scheduler.has_work())
            for s in self.scheduler.expired_waiting():
                if not s.shed_exempt:
                    self._shed(s, "queue_deadline")
            t0 = time.perf_counter()
            self.loop_seconds["wait"] += t0 - t_sec
            batch = self.scheduler.schedule()
            self.loop_seconds["schedule"] += time.perf_counter() - t0
            if batch is None:
                continue
            self.step_idx += 1
            self._fr.record(
                "sched", step=self.step_idx, batch_kind=batch.kind,
                rows=len(batch.seqs),
                chunk_tokens=sum(batch.chunk_sizes) if batch.chunk_sizes else 0,
                running=self.scheduler.num_running(),
                waiting=self.scheduler.num_waiting(),
                kv_usage=round(self.kv.usage(), 4),
            )
            if batch.kind == "prefill":
                now = time.monotonic()
                for s in batch.seqs:
                    if s.first_dispatch_time is None:
                        s.first_dispatch_time = now
                        self.admission_wait_ms.append((now - s.arrival_time) * 1000)
            t_step = time.perf_counter()
            try:
                tokens, lp_data = self._dispatch(batch)
            except Exception as step_err:
                logger.exception("engine step failed; aborting batch")
                self._fr.record(
                    "error", step=self.step_idx, batch_kind=batch.kind,
                    error=repr(step_err)[:500],
                )
                self._fr.dump("engine_step_error", force=True)
                # a deferred device error may belong to an unfetched
                # prefill dispatch: those sequences' KV is suspect too
                suspect = list(batch.seqs)
                for b in self._unfetched:
                    suspect.extend(b.seqs)
                self._unfetched.clear()
                for s in suspect:
                    if not s.finished:
                        self.scheduler._finish(s, "error")
                        self._emit(s, "", error=True)
                continue
            step_wall = time.perf_counter() - t_step
            self.loop_seconds["step"] += step_wall
            self._fr.record(
                "step", step=self.step_idx, batch_kind=batch.kind,
                wall_ms=round(step_wall * 1000, 3), fetched=tokens is not None,
            )
            if tokens is None:
                tokens = np.full((len(batch.seqs),), -1, np.int32)
            else:
                self._unfetched.clear()  # a fetch retires earlier dispatches
            self._apply_and_emit(batch, tokens, lp_data)
        logger.info("engine loop exited")

    def _apply_and_emit(self, batch, tokens, lp_data=None) -> None:
        """Apply one fetched token matrix to scheduler state and stream the
        resulting deltas: one RequestOutput per sequence per dispatch,
        carrying every new token of a burst."""
        t_apply = time.perf_counter()
        events = self.scheduler.apply_step(batch, tokens, self.tokenizer.eos_token_id)
        if batch.kind == "prefill":
            self.total_prompt_tokens += sum(batch.chunk_sizes)
        t_emit = time.perf_counter()
        self.loop_seconds["apply"] += t_emit - t_apply
        grouped: dict[str, tuple[Sequence, list[int], list]] = {}
        for s, tok, i, j in events:
            g = grouped.setdefault(s.seq_id, (s, [], []))
            g[1].append(tok)
            if lp_data is not None and s.params.logprobs is not None:
                n = min(s.params.logprobs, lp_data[1].shape[2])
                g[2].append({
                    "logprob": float(lp_data[0][i, j]),
                    "top_ids": lp_data[1][i, j, :n].tolist(),
                    "top_logprobs": lp_data[2][i, j, :n].tolist(),
                })
        for s, toks, lps in grouped.values():
            self.total_generation_tokens += len(toks)
            self._process_token(s, toks, lps or None)
        self.loop_seconds["emit"] += time.perf_counter() - t_emit

    def _process_token(
        self, seq: Sequence, new_tokens: list[int], logprobs: Optional[list] = None
    ) -> None:
        """Detokenize incrementally, check stop strings, emit the delta (one
        token or a whole decode burst; ``logprobs`` aligns with
        ``new_tokens`` when requested)."""
        raw = full = self.tokenizer.decode(seq.output_ids)
        if not seq.finished and full.endswith("�"):
            # hold back a trailing incomplete byte sequence until later
            # tokens complete it; it flushes on the finishing emit
            full = full.rstrip("�")
        if not seq.finished and seq.params.stop:
            # hold back a trailing PARTIAL stop-string match, so the emitted
            # text does not depend on where a dispatch ends
            hold = 0
            for s in seq.params.stop:
                for j in range(min(len(s) - 1, len(full)), hold, -1):
                    if full.endswith(s[:j]):
                        hold = j
                        break
            if hold:
                full = full[: len(full) - hold]
        with self._lock:
            prev = self._texts.get(seq.seq_id, "")
        delta = full[len(prev):] if full.startswith(prev) else full
        if seq.params.stop and any(s in raw for s in seq.params.stop):
            # stop at the FIRST token prefix whose text holds a stop string,
            # exactly where a one-token-per-step engine would
            base = len(seq.output_ids) - len(new_tokens)
            hit = None  # (keep, text_at_keep, stop_index)
            for m in range(1, len(new_tokens) + 1):
                txt = self.tokenizer.decode(seq.output_ids[: base + m])
                for stop in seq.params.stop:
                    idx = txt.find(stop)
                    if idx >= 0:
                        hit = (m, txt, idx)
                        break
                if hit:
                    break
            if hit:
                keep, txt, idx = hit
                delta = txt[len(prev): idx] if txt.startswith(prev) else txt[:idx]
                del seq.output_ids[base + keep:]
                self.total_generation_tokens -= len(new_tokens) - keep
                new_tokens = new_tokens[:keep]
                if logprobs is not None:
                    logprobs = logprobs[:keep]
                if not seq.finished:
                    self.scheduler._finish(seq, "stop")
                elif seq.finish_reason == "length":
                    seq.finish_reason = "stop"
        with self._lock:
            # presence-gated: generate()'s finally may have popped the entry
            if seq.seq_id in self._texts:
                self._texts[seq.seq_id] = prev + delta
        self._emit(seq, delta, tokens=new_tokens, logprobs=logprobs)

    def _emit(
        self,
        seq: Sequence,
        delta: str,
        tokens: Optional[list[int]] = None,
        error: bool = False,
        logprobs: Optional[list] = None,
    ) -> None:
        with self._lock:
            entry = self._outputs.get(seq.seq_id)
        if entry is None:
            return
        loop, out_q = entry
        out = RequestOutput(
            seq_id=seq.seq_id,
            text_delta=delta,
            token_ids=(
                tokens if tokens is not None
                else [seq.output_ids[-1]] if seq.output_ids else []
            ),
            finished=seq.finished,
            finish_reason=("error" if error else seq.finish_reason) if seq.finished else None,
            prompt_tokens=len(seq.prompt_ids),
            completion_tokens=len(seq.output_ids),
            cached_tokens=seq.num_cached,
            logprobs=logprobs,
        )
        loop.call_soon_threadsafe(out_q.put_nowait, out)

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        out = {
            "num_requests_running": self.scheduler.num_running(),
            "num_requests_waiting": self.scheduler.num_waiting(),
            "num_requests_swapped": self.scheduler.num_swapped(),
            "num_preemptions_total": self.scheduler.preemptions_total,
            "num_requests_shed_total": sum(self.requests_shed.values()) + self.api_requests_shed,
            "engine_saturated": int(self.saturated()),
            "gpu_cache_usage_perc": self.kv.usage(),
            "gpu_prefix_cache_hits_total": self.kv.prefix_hits,
            "gpu_prefix_cache_queries_total": self.kv.prefix_queries,
            "gpu_prefix_cache_hit_rate": self.kv.hit_rate(),
            "prompt_tokens_total": self.total_prompt_tokens,
            "generation_tokens_total": self.total_generation_tokens,
            "decode_dispatches_total": self.decode_dispatches_total,
            "kv_evicted_pages_total": self.kv.evicted_pages_total,
            "kv_evicted_hot_pages_total": self.kv.evicted_hot_pages_total,
            "kv_proactive_spilled_pages_total": self.kv.proactive_spilled_pages_total,
            # the int8 KV surface: cache_dtype is the string form for GET
            # /stats (non-numeric: the /metrics kv_* sweep skips it)
            "cache_dtype": self.cfg.kv_cache_dtype,
            "kv_cache_dtype_bytes_per_token": round(self.kv_bytes_per_token, 3),
            "kv_quant_pages": self.kv.num_pages if self.kv_quant else 0,
            "kv_quant_dequant_err_max": round(self.kv_quant_dequant_err_max, 6),
        }
        if self._offload is not None:
            o = self._offload.stats()
            out["kv_offload_hit_pages_total"] = self.kv.offload_hits
            out["kv_offload_saved_pages_total"] = o["saved_pages"]
            out["kv_offload_loaded_pages_total"] = o["loaded_pages"]
            out["kv_offload_cpu_bytes"] = o["cpu_bytes"]
            out["kv_offload_disk_bytes"] = o["disk_bytes"]
            out["kv_corrupt_pages_total"] = o["corrupt_pages"]
            out["kv_offload_dropped_evictions_total"] = o["dropped_evictions"]
            out["kv_offload_max_io_pages"] = self.kv.max_io_pages
            if self.kv_link_bandwidth_bytes_per_s is not None:
                out["kv_offload_link_bandwidth_bytes_per_sec"] = round(self.kv_link_bandwidth_bytes_per_s)
        for section, secs in self.loop_seconds.items():
            out[f"engine_loop_{section}_seconds_total"] = round(secs, 3)
        return out
