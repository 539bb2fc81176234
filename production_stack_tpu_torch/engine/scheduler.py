"""Continuous-batching scheduler with shape bucketing.

Every jit shape is quantized: decode batches to power-of-two buckets, prefill
chunks to a small set of lengths, page tables to power-of-two widths — so XLA
compiles a bounded set of programs and steady-state serving never retraces
(SURVEY.md §7 hard part #1).

Policy (one device program per step, prefill-prioritized):
- If any admitted sequence still has uncomputed prompt tokens, run one chunked
  prefill step for up to ``prefill_batch`` such sequences (shortest-first to
  release TTFT quickly).
- Otherwise run one decode step over all running sequences.
- Admission: a waiting sequence is admitted when its prompt's non-cached pages
  fit in the allocator (prefix-cache hits make admission cheaper — KV reuse).

The reference gets this behavior from vLLM (continuous batching + chunked
prefill, enabled at helm/templates/deployment-vllm-multi.yaml:128-135); here it
is first-party.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from production_stack_tpu_torch.engine.kv_manager import KVPageManager


@dataclass
class SamplingParams:
    max_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    stop: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    # suppress EOS-driven finishes until this many tokens were generated
    # (vLLM's min_tokens; stop strings and length limits still apply)
    min_tokens: int = 0
    seed: Optional[int] = None
    # top-logprob count to report per token (None = off; device computes a
    # fixed TOP_LOGPROBS wide set, the host slices to this many)
    logprobs: Optional[int] = None
    # OpenAI penalties (0 = off) over generated tokens; vLLM repetition
    # penalty (1 = off) over prompt + generated tokens
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    # OpenAI logit_bias: token id -> additive bias in [-100, 100], applied
    # to the sampling distribution on device (reported logprobs stay raw,
    # matching the penalties convention)
    logit_bias: Optional[dict] = None

    @property
    def wants_penalties(self) -> bool:
        return (
            self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0
            or self.repetition_penalty != 1.0
        )


@dataclass
class Sequence:
    seq_id: str
    prompt_ids: list[int]
    params: SamplingParams
    arrival_time: float = field(default_factory=time.monotonic)
    output_ids: list[int] = field(default_factory=list)
    pages: list[int] = field(default_factory=list)
    # high-watermark of pages ever owned (SLO terminal records report it —
    # the request's real KV footprint, which free() at finish erases)
    pages_peak: int = 0
    num_computed: int = 0          # prompt tokens already prefilled (incl. cached)
    num_cached: int = 0            # tokens served from the prefix cache
    finished: bool = False
    finish_reason: Optional[str] = None
    first_token_time: Optional[float] = None
    first_dispatch_time: Optional[float] = None  # admission-wait instrumentation
    lora_slot: int = 0             # adapter slot (0 = base model)
    cache_salt: bytes = b""        # prefix-cache salt (adapter identity)
    # exempt from load shedding (queue bound + queue deadline): set by the
    # API layer for parallel-sampling SIBLINGS (choice > 0), which only
    # launch after choice 0's first output — their request is mid-flight,
    # a 429 is no longer possible, and shedding one choice would leak a
    # zero-token 'shed' finish into a committed stream. Choice 0 itself
    # stays sheddable: its pre-output shed converts the whole request to a
    # clean 429 and the siblings are aborted with it.
    shed_exempt: bool = False
    # SLO class ("interactive" | "batch", docs/failure-handling.md): batch
    # saturates earlier, expires earlier, yields prefill chunk slots, and
    # is preempted first under page pressure — the whole degradation order
    # under overload keys off this field
    priority: str = "interactive"
    # a migrated continuation's tokens emitted on earlier engines (the tail
    # of its prompt): its text is decoded after them, so a character or a
    # stop string split across the handoff comes out as in an unmigrated
    # stream
    text_context: list[int] = field(default_factory=list)
    # distributed-tracing context (tracing.SpanContext of the engine.request
    # span) — phase spans for this sequence parent under it; None = untraced
    trace: Optional[object] = None
    trace_done: bool = False       # phase spans recorded (guard against dupes)
    finish_time: Optional[float] = None  # monotonic, set by _finish
    # per-request SLO accounting (engine terminal records): inter-emit gaps
    # normalized per token (a burst emit of k tokens contributes gap/k), so
    # the record's itl_p99_ms reflects what a streaming client experienced.
    # Capped — a 32k-token stream must not grow an unbounded list.
    last_emit_time: Optional[float] = None
    itl_samples: list = field(default_factory=list)
    slo_done: bool = False         # terminal record emitted (guard)
    # phase-span contexts, pre-allocated at first admission attempt so
    # offload spill/restore spans triggered inside the scheduler can parent
    # under the phase whose wall window contains them (first admission ->
    # queue; post-preemption re-admission -> prefill or decode). As siblings
    # of the phase they overlap they would double-count in self-time
    # attribution. engine._record_phase_trace records the phase spans under
    # these same contexts at finish.
    queue_span: Optional[object] = None
    prefill_span: Optional[object] = None
    decode_span: Optional[object] = None

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def in_prefill(self) -> bool:
        return self.num_computed < len(self.prompt_ids)


@dataclass
class ScheduledBatch:
    kind: str                      # "prefill" | "decode"
    seqs: list[Sequence]
    # padded device inputs
    input_ids: np.ndarray
    positions: np.ndarray
    page_table: np.ndarray
    kv_lens: np.ndarray
    temperature: np.ndarray
    top_k: np.ndarray
    top_p: np.ndarray
    lora_ids: np.ndarray = None    # [B] int32 adapter slot per row
    kv_limits: np.ndarray = None   # [B] int32 KV capacity bound (multi-step)
    history: np.ndarray = None     # [B, H] token ids (speculative drafting)
    # how many tokens of each seq this step computes (prefill chunking)
    chunk_sizes: list[int] = field(default_factory=list)
    # chained decode bursts this dispatch covers (runner.step_multi_pipelined)
    bursts: int = 1
    # any sequence in the batch wants per-token logprobs
    want_logprobs: bool = False
    # any sequence in the batch has sampling penalties; history/prompt_lens
    # are set when true
    want_penalties: bool = False
    prompt_lens: np.ndarray = None  # [B] int32 (penalty batches)


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Scheduler:
    DECODE_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
    # a chunk's T up to 8,192 (the JAX scheduler's buckets end at 1,024, past
    # which its batch arrays are too narrow for the chunk); a prefill_chunk
    # above the last one is refused (engine/config.check_supported)
    CHUNK_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
    PAGE_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
    HISTORY_BUCKETS = CHUNK_BUCKETS + (16384, 32768)

    def __init__(
        self,
        kv: KVPageManager,
        *,
        max_num_seqs: int = 64,
        max_model_len: int = 4096,
        prefill_chunk: int = 512,
        prefill_batch: int = 4,
        enable_prefix_caching: bool = True,
        batch_multiple: int = 1,
        decode_steps: int = 1,
        decode_pipeline: int = 1,
        spec_k: int = 0,
        spec_ngram: int = 3,
        max_waiting_seqs: int = 0,
        queue_deadline_s: float = 0.0,
        interactive_reserve: int = 1,
        batch_queue_deadline_s: float = 0.0,
        batch_prefill_share: float = 0.5,
    ):
        self.kv = kv
        self.max_num_seqs = max_num_seqs
        self.max_model_len = max_model_len
        self.prefill_chunk = prefill_chunk
        self.prefill_batch = prefill_batch
        self.enable_prefix_caching = enable_prefix_caching
        # device batch dims must divide evenly over the dp mesh axis: round
        # every batch bucket up to a multiple of this (padded rows are inert —
        # positions -1, zero budgets)
        self.batch_multiple = max(1, batch_multiple)
        # decode burst length: tokens produced per device program (fused
        # multi-step decode, runner.step_multi); 1 = classic per-token steps.
        # With spec_k > 0 it is the number of fused draft+verify ROUNDS instead
        # (runner.step_spec), each emitting 1..spec_k+1 tokens.
        self.decode_steps = max(1, decode_steps)
        # chained bursts per decode dispatch when the batch is quiescent (no
        # waiting work): m bursts cost m*compute + 1 fetch round trip instead
        # of m of each (runner.step_multi_pipelined)
        self.decode_pipeline = max(1, decode_pipeline)
        self.spec_k = max(0, spec_k)
        self.spec_ngram = max(1, spec_ngram)
        # admission control (overload survival, docs/failure-handling.md):
        # a bounded waiting queue — the API layer sheds (429 + Retry-After)
        # once num_waiting() reaches max_waiting_seqs (0 = unbounded) — and
        # a per-request queue deadline: a request still undispatched after
        # queue_deadline_s seconds is shed by the engine loop (0 = never).
        # Unbounded queues turn overload into unbounded TTFT for EVERYONE;
        # shedding keeps the served subset's latency sane and tells clients
        # exactly when to retry.
        self.max_waiting_seqs = max(0, max_waiting_seqs)
        self.queue_deadline_s = max(0.0, queue_deadline_s)
        # SLO classes (docs/failure-handling.md "Priority classes"): the
        # last `interactive_reserve` slots of a bounded waiting queue only
        # admit interactive work, so sustained batch load can never starve
        # interactive out of admission; batch optionally expires on its own
        # (shorter) queue deadline, and its share of a prefill dispatch's
        # chunk slots is capped while interactive prefill work is waiting.
        self.interactive_reserve = max(0, interactive_reserve)
        self.batch_queue_deadline_s = max(0.0, batch_queue_deadline_s)
        self.batch_prefill_share = min(1.0, max(0.0, batch_prefill_share))
        self.waiting: list[Sequence] = []
        self.running: list[Sequence] = []
        self.preemptions_total = 0
        self._last_kind = "decode"  # prefill/decode alternation state
        # adaptive chain-depth inputs, refreshed by the engine loop each
        # iteration: recent request arrivals/sec and the measured per-burst
        # wall time. A chained dispatch delays the next scheduling decision
        # by (bursts-1) * burst_seconds, during which an arrival cannot start
        # its prefill — exactly the TTFT admission-wait tradeoff.
        self.arrival_rate = 0.0
        self.burst_seconds = 0.05
        # seconds since the engine last saw a request arrive (refreshed per
        # loop iteration); streak-based chain growth requires real
        # quiescence, not just a momentary gap in a sporadic stream
        self.last_arrival_age = float("inf")
        # streak-based chain growth: each chained dispatch pays exactly one
        # fetch round trip, so depth sets the RTT share of decode time on
        # network-attached chips. Sustained quiescence (consecutive chained
        # decode dispatches with nothing else runnable) doubles the depth up
        # to decode_pipeline_cap; any prefill, arrival, or idle pass resets.
        self._chain_streak = 0
        self.decode_pipeline_cap = (
            min(16, self.decode_pipeline * 4) if self.decode_pipeline > 1 else 1
        )
        # worst-case admission-wait budget: while admission is OPEN (free
        # seats and pages), an arrival landing right after a chained dispatch
        # cannot reach the device until the chain retires — run-ahead prefill
        # only queues BEHIND the in-flight bursts. The expected-arrival cap
        # below bounds the mean, not the tail: under sparse traffic
        # (rate ~ 1/s) it allowed long chains, and an unlucky arrival ate
        # the whole chain. Cap (bursts-1)*burst_seconds by this budget
        # whenever an arrival could actually start, so worst-case wait stays
        # ~100 ms.
        self.chain_wait_budget_s = 0.1
        # whether the driving engine loop can dispatch run-ahead prefills
        # behind an in-flight chain (LLMEngine sets this True — it owns
        # _runahead_prefills). The one-extra-burst chaining floor below the
        # wait budget is ONLY justified by run-ahead (it starts an
        # arrival's prefill DURING the chain); a caller without that path —
        # the safe default for a bare scheduler — or a batch run-ahead
        # cannot serve (logprobs dispatches fetch whole-chain) falls back
        # to bursts=1 when a single burst already exceeds the budget.
        self.runahead_available = False

    # -- api ----------------------------------------------------------------

    def add(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def abort(self, seq_id: str) -> None:
        for q in (self.waiting, self.running):
            for s in q:
                if s.seq_id == seq_id and not s.finished:
                    self._finish(s, "abort")

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def num_waiting(self) -> int:
        return len(self.waiting)

    def saturated(self, priority: str = "interactive") -> bool:
        """Waiting queue at (or past) its bound — new work should shed.

        Free seats project forward: sequences about to be admitted straight
        into running must not count against the waiting bound, or a batch
        finishing (seats free, queue momentarily still full) would shed
        arrivals a nearly-idle engine could serve — and export a spurious
        engine_saturated gauge the router honors for a whole scrape
        interval. This projection is the single saturation definition: the
        API fast path, the engine-side authoritative bound, and the
        /metrics gauge all read it.

        Class-aware: batch traffic saturates ``interactive_reserve`` waiting
        slots early, so under sustained mixed-class overload every shed
        lands on batch until only the reserved interactive slots remain —
        batch can never starve interactive out of the queue."""
        if self.max_waiting_seqs <= 0:
            return False
        free_seats = max(0, self.max_num_seqs - len(self.running))
        bound = self.max_waiting_seqs + free_seats
        if priority == "batch":
            bound = (
                max(0, self.max_waiting_seqs - self.interactive_reserve)
                + free_seats
            )
        return len(self.waiting) >= bound

    def deadline_for(self, priority: str) -> float:
        """Queue deadline for one SLO class: batch uses its own (typically
        shorter) deadline when configured, else inherits the shared one."""
        if priority == "batch" and self.batch_queue_deadline_s > 0:
            return self.batch_queue_deadline_s
        return self.queue_deadline_s

    def expired_waiting(self, now: Optional[float] = None) -> list[Sequence]:
        """Waiting sequences past their class's queue deadline that can
        still shed CLEANLY: never dispatched (no tokens streamed) and not
        preempted — a preempted sequence already delivered output, so a 429
        is no longer an honest answer and it keeps its place instead."""
        if self.queue_deadline_s <= 0 and self.batch_queue_deadline_s <= 0:
            return []
        now = time.monotonic() if now is None else now
        out = []
        for s in self.waiting:
            if s.first_dispatch_time is not None or getattr(
                s, "preempted", False
            ):
                continue
            deadline = self.deadline_for(getattr(s, "priority", "interactive"))
            if deadline > 0 and now - s.arrival_time > deadline:
                out.append(s)
        return out

    def num_running(self) -> int:
        return len(self.running)

    # -- internals ----------------------------------------------------------

    def _batch_bucket(self, n: int) -> int:
        b = _bucket(n, self.DECODE_BATCH_BUCKETS)
        m = self.batch_multiple
        return -(-b // m) * m

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.kv.page_size)

    def _try_admit(self) -> None:
        from production_stack_tpu_torch import tracing

        while self.waiting and len(self.running) < self.max_num_seqs:
            # admission order: a preempted head keeps its place (it already
            # streamed tokens — jumping it would stall a live stream), then
            # interactive before batch (FIFO within each class), then FIFO.
            head = self.waiting[0]
            if getattr(head, "preempted", False):
                seq = head
            else:
                seq = next(
                    (
                        s
                        for s in self.waiting
                        if getattr(s, "priority", "interactive") != "batch"
                    ),
                    head,
                )
            # publish a phase-span context for the admission window: offload
            # spill/restore spans recorded inside match_prefix / allocate
            # (kv_manager) nest under the phase of the request that caused
            # them. First admission falls in the queue window; a
            # preempted-then-readmitted sequence is re-admitted inside its
            # prefill (dispatched, no token yet) or decode window, and
            # parenting its restores under the already-closed queue span
            # would double-count that time in the attribution
            if seq.trace is not None and seq.queue_span is None:
                seq.queue_span = seq.trace.child()
                seq.prefill_span = seq.trace.child()
                seq.decode_span = seq.trace.child()
            if seq.first_token_time is not None:
                phase_ctx = seq.decode_span
            elif seq.first_dispatch_time is not None:
                phase_ctx = seq.prefill_span
            else:
                phase_ctx = seq.queue_span
            tr_token = tracing.set_current(phase_ctx)
            try:
                if self.enable_prefix_caching:
                    shared, cached = self.kv.match_prefix(
                        seq.prompt_ids, seq.cache_salt
                    )
                    # never serve the *entire* prompt from cache: the last
                    # token must be recomputed to produce logits
                    if cached >= len(seq.prompt_ids):
                        drop = self._pages_needed(1)
                        for pid in shared[-drop:]:
                            self.kv.free([pid])
                        shared = shared[:-drop]
                        cached = len(shared) * self.kv.page_size
                else:
                    shared, cached = [], 0
                need = self._pages_needed(
                    min(len(seq.prompt_ids) + 16, self.max_model_len + 1)
                ) - len(shared)
                fresh = self.kv.allocate(max(need, 0))
            finally:
                tracing.reset_current(tr_token)
            if fresh is None:
                self.kv.free(shared)
                return
            seq.pages = shared + fresh
            seq.pages_peak = max(seq.pages_peak, len(seq.pages))
            seq.num_cached = cached
            seq.num_computed = cached
            self.waiting.remove(seq)
            self.running.append(seq)

    def _burst_budget(self, seq: Sequence, bursts: int = 1) -> int:
        """Tokens this sequence can still usefully produce in one decode
        dispatch (``bursts`` chained bursts of decode_steps each), capped by
        its remaining max_tokens budget (so near-finished requests don't
        reserve KV for tokens that would be discarded)."""
        return max(1, min(bursts * self.decode_steps,
                          seq.params.max_tokens - len(seq.output_ids)))

    def _spec_limit(self, seq: Sequence) -> int:
        """Max KV length a fused speculative dispatch may reach for ``seq``:
        decode_steps rounds of up to spec_k+1 tokens, capped by the remaining
        max_tokens budget. Verify writes spec_k draft tokens past the current
        length every round, so the cap carries a +spec_k allowance past
        max_model_len for (discarded) overshoot writes."""
        per = self.spec_k + 1
        remaining = max(1, seq.params.max_tokens - len(seq.output_ids))
        iters = max(1, min(self.decode_steps, -(-remaining // per)))
        return min(seq.num_tokens + iters * per, self.max_model_len + self.spec_k)

    def _decode_target_len(self, seq: Sequence, bursts: int = 1) -> int:
        """KV capacity (in tokens) a decode dispatch needs for ``seq``."""
        if self.spec_k:
            return self._spec_limit(seq)
        return min(seq.num_tokens + self._burst_budget(seq, bursts),
                   self.max_model_len + 1)

    def _ensure_decode_page(self, seq: Sequence, bursts: int = 1) -> bool:
        """Make sure the next decode dispatch has KV slots; grow the page list
        if needed (one dispatch of lookahead)."""
        need = self._pages_needed(self._decode_target_len(seq, bursts)) - len(seq.pages)
        if need <= 0:
            return True
        extra = self.kv.allocate(need)
        if extra is None:
            return False
        seq.pages.extend(extra)
        seq.pages_peak = max(seq.pages_peak, len(seq.pages))
        return True

    def _finish(self, seq: Sequence, reason: str) -> None:
        seq.finished = True
        seq.finish_reason = reason
        if seq.finish_time is None:
            seq.finish_time = time.monotonic()
        if self.enable_prefix_caching:
            self.kv.register_filled(
                seq.prompt_ids + seq.output_ids, seq.pages, seq.cache_salt
            )
        self.kv.free(seq.pages)
        seq.pages = []
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)

    # -- step planning ------------------------------------------------------

    def schedule(self) -> Optional[ScheduledBatch]:
        # high-watermark proactive spill: while the pool is nearly full, copy
        # the coldest evictable pages to the offload tier BEFORE an admission
        # or decode-growth allocation forces an eviction — the eviction then
        # frees slots with zero device I/O (cheap no-op below the watermark)
        self.kv.proactive_spill()
        self._try_admit()
        prefilling = [s for s in self.running if s.in_prefill]
        decoding = [s for s in self.running if not s.in_prefill]
        # Alternate prefill chunks with decode bursts when prefill work
        # coexists with RESIDENT DECODE DEMAND: strict prefill priority
        # starves decodes under a steady long-prompt arrival stream — the
        # whole point of chunked prefill is that decode
        # latency survives long prompts. The gate is demand-driven, not
        # backlog-only: a long-prompt backlog (>= 2 chunks, e.g. one 32k
        # prompt) alternates so the in-flight decodes' inter-token latency
        # stays bounded while it streams through, AND a big resident decode
        # batch (>= prefill_batch rows) alternates even when the backlog is
        # short — each skipped interleave there stalls that many live
        # streams for a whole chunk, which is worse than the one fetch
        # round trip the interleaved burst costs. Small decode batches with
        # a short backlog keep the fast strict-priority path: the flurry
        # clears in a dispatch or two.
        backlog = sum(len(s.prompt_ids) - s.num_computed for s in prefilling)
        demand = len(decoding)
        alternate = (
            demand > 0
            and self._last_kind == "prefill"
            and (
                backlog >= 2 * self.prefill_chunk
                or demand >= max(2, self.prefill_batch)
            )
        )
        # interleave-gate decision surface (flight recorder "sched" events):
        # WHY the loop ran a chunk vs a decode burst is unreconstructable
        # after the fact without these inputs
        self.last_gate = {
            "backlog_tokens": backlog,
            "decode_demand": demand,
            "alternate": alternate,
            "waiting": len(self.waiting),
        }
        if prefilling and not alternate:
            return self._take_prefill(prefilling)
        self._last_kind = "decode"
        if self.running:
            # chain bursts when nothing admissible is waiting to join the
            # batch: a chained dispatch delays the next scheduling decision
            # by (bursts-1) * burst compute, which would hurt arrivals' TTFT.
            # When every seat is taken (running == max_num_seqs), waiting
            # requests CANNOT start regardless — chaining costs them nothing
            # and drains the running set (and so the queue) ~bursts-fold
            # faster on fetch-RTT-bound hosts, which is what decides TTFT
            # under oversubscription (the multi-round-qa shape).
            # _try_admit just ran, so a non-empty waiting queue means its head
            # is blocked — by seats OR by KV pages. Either way nothing new can
            # reach the device until running work retires, which chaining
            # accelerates; treat both as admission-blocked.
            admission_blocked = (
                len(self.running) >= self.max_num_seqs or bool(self.waiting)
            )
            # chaining engages regardless of queue state: an empty queue
            # means nothing is delayed, and a non-empty one (post-_try_admit)
            # means admission is blocked anyway — the wall-time cap below is
            # what protects arrivals while admission is OPEN
            bursts = (
                self.decode_pipeline
                if (
                    not prefilling  # a chain would delay the next chunk
                    and not self.spec_k
                    and self.decode_steps > 1
                    # penalties chain fine: the device history (updated
                    # in-scan) feeds the next burst at the seam
                    # (runner.step_multi_pipelined), so counts never go stale
                )
                else 1
            )
            if (
                bursts > 1
                and self._chain_streak > 0
                and (admission_blocked or self.last_arrival_age > 1.0)
            ):
                # sustained quiescence: double the chain depth per
                # consecutive fully-chained dispatch, up to the cap — depth
                # sets the fetch-RTT share of decode time, and a continuing
                # streak is evidence nothing else wants the device. A
                # SPORADIC arrival stream (gaps shorter than ~1 s) blocks
                # growth even when the instant queue is empty: a deep chain
                # is an admission-wait floor for whoever arrives next —
                # unless admission is blocked anyway, where depth only
                # drains the queue faster.
                bursts = min(
                    bursts << min(self._chain_streak, 4),
                    self.decode_pipeline_cap,
                )
                # don't over-chain past every row's remaining budget: a row
                # at its max_tokens cap is masked for the rest of the chain
                most_left = max(
                    (s.params.max_tokens - len(s.output_ids) for s in decoding),
                    default=1,
                )
                bursts = max(1, min(bursts, -(-most_left // self.decode_steps)))
            # adaptive depth: cap the chain so the EXPECTED number of
            # arrivals stuck waiting behind it stays under ~half a request
            # ((bursts-1) * burst_time * arrival_rate <= 0.5). Quiescent
            # traffic (rate ~ 0) keeps full chaining and its fetch-RTT
            # amortization; under a steady arrival stream chains shorten so
            # a new request's prefill starts within ~a burst of arriving.
            # Irrelevant while admission is blocked: an arrival cannot start
            # until a seat frees, which chaining accelerates.
            if not admission_blocked:
                while (
                    bursts > 1
                    and (bursts - 1) * self.burst_seconds * self.arrival_rate
                    > 0.5
                ):
                    bursts -= 1
                # worst-case bound (not just expected): while an arrival
                # COULD start immediately (free seats + pages), never chain
                # deeper than the wait budget — the expected cap above lets
                # sparse traffic (rate <= ~1/s) keep half-second chains, and
                # whoever arrives mid-chain eats the remainder whole. When a
                # single burst exceeds the budget (long-context decode can
                # run ~0.5 s/burst) a ONE-extra-burst floor survives ONLY if
                # run-ahead prefill can actually serve an arrival during the
                # chain: chained dispatches enable run-ahead
                # (engine._runahead_prefills), which starts an arrival's
                # prefill — and emits its first token — mid-chain, so a
                # 2-burst chain then beats an unchained burst of the same
                # length for exactly the arrival this cap protects. Without
                # run-ahead (engine has none, or the batch wants logprobs —
                # that path fetches whole-chain and dispatches nothing
                # behind it), the floor would make an arrival with admission
                # OPEN wait a full extra burst for nothing: fall back to an
                # unchained dispatch instead.
                extra = int(
                    self.chain_wait_budget_s / max(self.burst_seconds, 1e-4)
                )
                if extra < 1:
                    runahead_ok = self.runahead_available and not any(
                        s.params.logprobs is not None for s in decoding
                    )
                    cap = 2 if runahead_ok else 1
                else:
                    cap = 1 + extra
                bursts = min(bursts, cap)
            if bursts > 1:
                # min_tokens: the EOS ban is fixed for everything one dispatch
                # covers, so a chained dispatch could overshoot the floor by
                # bursts*decode_steps-1 tokens. Cap the chain so rows near
                # their floor get a fresh scheduling decision within one
                # burst of crossing it — the overshoot window stays at the
                # unchained bound (< decode_steps) regardless of pipeline depth.
                for s in decoding:
                    rem = s.params.min_tokens - len(s.output_ids)
                    if rem > 0:
                        bursts = min(bursts, max(1, -(-rem // self.decode_steps)))
            batch = self._plan_decode(decoding, bursts)
            self._chain_streak = (
                self._chain_streak + 1
                if batch is not None and batch.bursts > 1
                else 0
            )
            if batch is None:
                # nothing decodable this pass — fall back to prefill work.
                # RE-DERIVE the prefill set: _plan_decode's page-pressure
                # preemption may have evicted members of the list captured
                # above (freed pages, moved back to waiting), and planning a
                # chunk for a preempted seq would scatter its KV into page 0
                # — a page another live sequence owns.
                prefilling = [s for s in self.running if s.in_prefill]
                if prefilling:
                    return self._take_prefill(prefilling)
            return batch
        return None

    def schedule_prefill_runahead(
        self, exclude_ids: set, allow=None
    ) -> Optional[ScheduledBatch]:
        """Plan a prefill dispatch for sequences DISJOINT from an in-flight
        decode chain (engine run-ahead): new arrivals admit and their chunks
        dispatch while the chain still computes, so the device queues the
        prefill right behind the chain's bursts instead of idling a fetch
        round trip + scheduling turnaround. Disjointness means no mirrored
        state is needed — nothing the chain will apply touches these rows.
        ``allow`` filters candidates BEFORE planning (rows needing staging
        the run-ahead path doesn't do wait for the normal path), so a
        skipped row never perturbs _last_kind/_chain_streak."""
        self._try_admit()
        prefilling = [
            s for s in self.running if s.in_prefill and id(s) not in exclude_ids
        ]
        if allow is not None:
            prefilling = [s for s in prefilling if allow(s)]
        if not prefilling:
            return None
        return self._take_prefill(prefilling)

    def _take_prefill(self, prefilling: list[Sequence]) -> ScheduledBatch:
        """Plan the next prefill dispatch: interactive rows first (their
        TTFT is the SLO under protection), then shortest remaining prompts
        (they finish and start decoding soonest). While interactive prefill
        work is waiting — resident rows that overflow this dispatch, or
        arrivals still queued for a seat — batch's share of the chunk slots
        is capped at ``batch_prefill_share`` so a wall of long batch
        prompts cannot monopolize the prefill pipeline."""
        self._last_kind = "prefill"
        self._chain_streak = 0  # prefill work ends the quiescence streak
        prefilling.sort(
            key=lambda s: (
                getattr(s, "priority", "interactive") == "batch",
                len(s.prompt_ids) - s.num_computed,
            )
        )
        take = prefilling[: self.prefill_batch]
        interactive_waiting = any(
            getattr(s, "priority", "interactive") != "batch"
            for s in prefilling[self.prefill_batch:]
        ) or any(
            getattr(s, "priority", "interactive") != "batch"
            for s in self.waiting
        )
        if interactive_waiting and self.batch_prefill_share < 1.0:
            cap = max(1, int(self.prefill_batch * self.batch_prefill_share))
            inter = [
                s for s in take
                if getattr(s, "priority", "interactive") != "batch"
            ]
            batch_rows = [
                s for s in take
                if getattr(s, "priority", "interactive") == "batch"
            ]
            # always keep >= 1 row so the dispatch makes progress even when
            # everything resident is batch
            take = (inter + batch_rows[:cap]) or take[:1]
        return self._plan_prefill(take)

    def _plan_prefill(self, seqs: list[Sequence]) -> ScheduledBatch:
        chunks = [
            min(len(s.prompt_ids) - s.num_computed, self.prefill_chunk) for s in seqs
        ]
        T = _bucket(max(chunks), self.CHUNK_BUCKETS)
        B = self._batch_bucket(len(seqs))
        max_pages = _bucket(
            max(self._pages_needed(s.num_computed + c) for s, c in zip(seqs, chunks)),
            self.PAGE_BUCKETS,
        )
        input_ids = np.zeros((B, T), np.int32)
        positions = np.full((B, T), -1, np.int32)
        page_table = np.zeros((B, max_pages), np.int32)
        kv_lens = np.zeros((B,), np.int32)
        temperature = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        lora_ids = np.zeros((B,), np.int32)
        want_pen = any(s.params.wants_penalties for s in seqs)
        history = prompt_lens = None
        if want_pen:
            need = max(len(s.prompt_ids) for s in seqs) + 1
            if need <= self.HISTORY_BUCKETS[-1]:
                history = np.zeros(
                    (B, _bucket(need, self.HISTORY_BUCKETS)), np.int32
                )
                prompt_lens = np.zeros((B,), np.int32)
            else:
                want_pen = False  # context beyond the top bucket: skip penalties
        for i, (s, c) in enumerate(zip(seqs, chunks)):
            lo = s.num_computed
            input_ids[i, :c] = s.prompt_ids[lo : lo + c]
            positions[i, :c] = np.arange(lo, lo + c)
            pages = s.pages[:max_pages]
            page_table[i, : len(pages)] = pages
            kv_lens[i] = lo + c
            temperature[i] = s.params.temperature
            top_k[i] = s.params.top_k
            top_p[i] = s.params.top_p
            lora_ids[i] = s.lora_slot
            if history is not None:
                hn = min(len(s.prompt_ids), history.shape[1])
                history[i, :hn] = s.prompt_ids[:hn]
                prompt_lens[i] = len(s.prompt_ids)
        return ScheduledBatch(
            "prefill", list(seqs), input_ids, positions, page_table, kv_lens,
            temperature, top_k, top_p, lora_ids=lora_ids, chunk_sizes=chunks,
            want_logprobs=any(s.params.logprobs is not None for s in seqs),
            want_penalties=want_pen, history=history, prompt_lens=prompt_lens,
        )

    def _plan_decode(
        self, seqs: list[Sequence], bursts: int = 1
    ) -> Optional[ScheduledBatch]:
        ready = []
        # decode-dispatch priority: interactive rows claim their KV growth
        # pages first (stable within class), so when the pool runs dry it is
        # a batch row that fails to grow — and the preemption below evicts
        # batch before any interactive stream is touched
        seqs = sorted(
            seqs,
            key=lambda s: getattr(s, "priority", "interactive") == "batch",
        )
        for s in list(seqs):
            if s not in self.running or s.finished:
                continue  # preempted or finished earlier in this pass
            ok = self._ensure_decode_page(s, bursts)
            while not ok:
                # out of KV pages: preempt the newest other running sequence,
                # preferring batch victims over interactive ones; if there is
                # none, preempt s itself
                others = [x for x in self.running if x is not s]
                if not others:
                    self._preempt(s)
                    break
                victim = max(
                    others,
                    key=lambda x: (
                        getattr(x, "priority", "interactive") == "batch",
                        x.arrival_time,
                    ),
                )
                self._preempt(victim)
                if victim in ready:
                    ready.remove(victim)
                ok = self._ensure_decode_page(s, bursts)
            if ok:
                ready.append(s)
        if not ready:
            return None
        B = self._batch_bucket(len(ready))
        max_pages = _bucket(
            max(self._pages_needed(self._decode_target_len(s, bursts)) for s in ready),
            self.PAGE_BUCKETS,
        )
        input_ids = np.zeros((B, 1), np.int32)
        positions = np.full((B, 1), -1, np.int32)
        page_table = np.zeros((B, max_pages), np.int32)
        kv_lens = np.zeros((B,), np.int32)
        temperature = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        lora_ids = np.zeros((B,), np.int32)
        kv_limits = np.zeros((B,), np.int32)
        history = prompt_lens = None
        want_pen = any(s.params.wants_penalties for s in ready)
        need_hist = 0
        if self.spec_k:
            need_hist = max(self._spec_limit(s) for s in ready)
        elif want_pen:
            # the burst appends sampled tokens at absolute positions
            need_hist = max(
                self._decode_target_len(s, bursts) for s in ready
            )
        if need_hist:
            if need_hist <= self.HISTORY_BUCKETS[-1]:
                # Rebuilt per dispatch: O(B * num_tokens) host memcpy, bounded
                # by the largest bucket (~128 KB/row). Contexts past the top
                # bucket fall back to plain burst decode for this dispatch —
                # the buffer is position-indexed on device, so a truncated
                # head would misplace the current token.
                history = np.zeros((B, _bucket(need_hist, self.HISTORY_BUCKETS)),
                                   np.int32)
                prompt_lens = np.zeros((B,), np.int32)
            else:
                want_pen = False  # context beyond the top bucket
        for i, s in enumerate(ready):
            all_ids = s.prompt_ids + s.output_ids
            input_ids[i, 0] = all_ids[-1]
            positions[i, 0] = s.num_tokens - 1
            pages = s.pages[:max_pages]
            page_table[i, : len(pages)] = pages
            kv_lens[i] = s.num_tokens
            temperature[i] = s.params.temperature
            top_k[i] = s.params.top_k
            top_p[i] = s.params.top_p
            lora_ids[i] = s.lora_slot
            if history is not None:
                if self.spec_k:
                    # speculative: a row stays active while lens + spec_k fits
                    # under kv_limits (verify writes spec_k drafts past lens)
                    kv_limits[i] = min(
                        len(s.pages) * self.kv.page_size, self._spec_limit(s)
                    )
                else:
                    kv_limits[i] = min(
                        len(s.pages) * self.kv.page_size,
                        self.max_model_len,
                        s.num_tokens + self._burst_budget(s, bursts) - 1,
                    )
                hn = min(len(all_ids), history.shape[1])
                history[i, :hn] = all_ids[:hn]
                prompt_lens[i] = min(len(s.prompt_ids), history.shape[1])
            else:
                # device-side burst bound: never write KV past the pages this
                # seq owns, past the model context, or past its max_tokens
                # budget (host discards surplus tokens). With initial lens
                # L0 = num_tokens the burst produces (kv_limits - L0 + 1) real
                # tokens, so a budget of b tokens means kv_limits =
                # num_tokens + b - 1.
                kv_limits[i] = min(
                    len(s.pages) * self.kv.page_size,
                    self.max_model_len,
                    s.num_tokens + self._burst_budget(s, bursts) - 1,
                )
        return ScheduledBatch(
            "decode", ready, input_ids, positions, page_table, kv_lens,
            temperature, top_k, top_p, lora_ids=lora_ids, kv_limits=kv_limits,
            history=history, bursts=bursts,
            want_logprobs=any(s.params.logprobs is not None for s in ready),
            want_penalties=want_pen, prompt_lens=prompt_lens,
        )

    def _preempt(self, seq: Sequence) -> None:
        """Return a running sequence to the waiting queue, dropping its KV."""
        self.kv.free(seq.pages)
        seq.pages = []
        seq.num_computed = 0
        seq.num_cached = 0
        seq.preempted = True  # vllm:num_requests_swapped until re-admitted
        self.preemptions_total += 1
        if seq in self.running:
            self.running.remove(seq)
        self.waiting.insert(0, seq)

    def num_swapped(self) -> int:
        """Preempted sequences parked in the waiting queue — the analogue of
        vLLM's num_requests_swapped (ours drop/respill KV through the offload
        tiers instead of a dedicated swap space)."""
        return sum(1 for s in self.waiting if getattr(s, "preempted", False))

    # -- result application -------------------------------------------------

    def apply_step(self, batch: ScheduledBatch, token_ids: np.ndarray, eos_token_id: int):
        """Apply sampled tokens; returns list of (seq, new_token, row, col) —
        row/col index into ``token_ids`` so callers can align per-token
        side data (logprobs).

        ``token_ids`` is [B] (prefill / single-step decode), [B, k] (fused
        multi-step decode), or [B, steps, 1+spec_k] with -1 padding
        (speculative decode); surplus tokens after a sequence finishes
        (EOS, max_tokens, context limit) and -1 padding are discarded.
        """
        tokens = np.asarray(token_ids)
        if tokens.ndim == 3:
            tokens = tokens.reshape(tokens.shape[0], -1)
        if tokens.ndim == 1:
            tokens = tokens[:, None]
        events = []

        def consume(s, tok, i, j) -> None:
            s.output_ids.append(tok)
            events.append((s, tok, i, j))
            if (
                not s.params.ignore_eos
                and tok == eos_token_id
                and len(s.output_ids) >= s.params.min_tokens
            ):
                self._finish(s, "stop")
            elif len(s.output_ids) >= s.params.max_tokens:
                self._finish(s, "length")
            elif s.num_tokens >= self.max_model_len:
                self._finish(s, "length")

        if batch.kind == "prefill":
            for i, s in enumerate(batch.seqs):
                if s.finished:
                    continue
                c = batch.chunk_sizes[i]
                s.num_computed += c
                if s.in_prefill:
                    continue  # more prompt chunks to go
                if self.enable_prefix_caching:
                    # register the prompt's full pages NOW (not at finish):
                    # concurrent requests sharing the prompt — parallel
                    # sampling siblings, common system prompts — hit the
                    # cache immediately instead of re-prefilling. Idempotent;
                    # finish re-registers with the output included.
                    self.kv.register_filled(
                        s.prompt_ids, s.pages, s.cache_salt
                    )
                if s.first_token_time is None:
                    s.first_token_time = time.monotonic()
                consume(s, int(tokens[i, 0]), i, 0)
            return events

        for j in range(tokens.shape[1]):
            for i, s in enumerate(batch.seqs):
                tok = int(tokens[i, j])
                if tok >= 0 and not s.finished:
                    consume(s, tok, i, j)
        return events
