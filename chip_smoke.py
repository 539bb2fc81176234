#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (production_stack_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; a failing phase ends the run with a
non-zero exit (nothing is caught):

1. build    -- nvcc builds every kernel library from production_stack_tpu_torch/
               csrc/ (one nvcc per source, all started together).
2. kernels  -- each CUDA kernel against its plain PyTorch version on the card,
               fp pools and int8 pools (per-page scales), at D = 64, 128
               and 256: llama-3.2-1b's heads, qwen2.5-7b's (NH = 28,
               KH = 4: 7 query heads per KV head), opt-125m's (NH = KH =
               12), gemma-2-2b's (window 4,096, softcap 50, sm_scale
               144^-0.5) and mixtral-8x7b's (NH = 32, KH = 8, D = 128:
               G = 4): ragged, burst-window, stacked-layer,
               window+softcap, bf16/f32 and NaN-poisoned stale-slot (or
               stale-scale) cases, the decode kernel's split-KV edges
               (rows with empty splits, a deep window start, the burst on
               a row whose last split is empty, G = 1 / 4 / 7 / 8, page 48,
               one row at 8,192; each decode call made twice and held to
               the same bytes), OPT's 3-token chunk, and the timing phase's
               inputs, each held to a bound scaled to its output (TOL; D =
               256 with scores that reach the softcap, to the tighter
               TOL_CAPPED); the main cases' one-key-fewer controls must
               fail it; the chunk's KV write, inside the same launch (fp,
               and the quantizing write), must leave pools and scales
               byte-identical to the writes' plain versions and other
               layers untouched, in every prefill case and in the write
               cases (aligned chunk, chunk ending mid-page, unaligned head
               page, other layers untouched, G = 1 / 7 / 8, a 3-token
               chunk over two pages, B = 2 with a padded row, pages of
               128) at D = 64, 128 and 256, bf16 and f32, fp and int8
               pools; the launch without the write leaves them untouched,
               with the same attention bytes. The prefill kernel at
               step_spec's verify shape (T = 5 after 1,024 and 4,096
               tokens), with its one-key-fewer control. The tensor-parallel ranks'
               head shapes too (each rank's NH/tp and KH/tp: llama-3.2-1b
               at tp 2 and 4, qwen2.5-7b, gemma-2-2b and opt-125m at tp
               2), the decode through decode_attention_sharded, and the
               pipeline stages' (one 8-row microbatch on a stage's
               8-layer pool, llama-3.2-1b at pp 2 and pp 2 x tp 2) and the
               sequence ranks' (one row of 8,223 on llama-3.2-1b's pool, at
               sp 2 and sp 2 x tp 2); Qwen2.5-1.5B's tp 4 rank (3 query
               heads on one KV head shared with its neighbour, G = 3: its
               own rows, fp and int8), and mixtral-8x7b's pp 2 x ep 2
               stage rank (an 8-row microbatch and a chunk on its 2-layer
               pool) and sp 2 x ep 2 sequence rank (one row of 4,104).
3. forward  -- llama-3.2-1b (two 512-token chunks) at full width and
               depth and gemma-2-2b (nine, past its 4,096 window) at full
               width, GEMMA_LAYERS = 8 of its 26 layers (bf16, seeded
               random weights), then one 8-step decode burst, with
               the kernels and with the plain versions, into bf16 pools and
               then into int8 pools (layer 0's int8 pages and scales
               byte-identical between the two). Then llama-3.2-1b with
               two seeded LoRA adapters (rank 8 and 16, all seven
               targets) on a batch of rows on slots 0, 1 and 2: the kernel
               forward against the plain forward, each adapter's rows
               against a forward over weights merged with scale * A @ B,
               and the slot-0 row bit-equal to the same forward without
               LoRA buffers.
4. hf       -- qwen2.5-7b's HF directory (its published config.json cut
               to 4 of its 28 layers, seeded bf16 weights in shards of at
               most 5 GB with the index) written under build/hf_models/,
               loaded through the port's loader (config equal to the
               preset at that depth but for max_model_len, sampled
               parameters byte-identical to the
               tensors written), and its forward checked as in phase 3;
               then opt-125m's directory (float16, as published); after
               the serve runs below, mixtral-8x7b's (its published
               config.json cut to 4 of its 32 layers, 12 GB of bf16
               shards, written after free disk and host memory are
               checked and printed), loaded and checked the same way.
5. serve    -- the port's OpenAI server in-process on localhost, eight
               times: llama-3.2-1b with bf16 pools; with int8 pools, the
               CPU offload tier and a pool small enough to evict; gemma-2-2b
               (8 layers) with bf16 pools and one prompt of 4,301 tokens; qwen2.5-7b
               from its directory with bf16 pools, then int8 pools;
               opt-125m from its directory; llama-3.2-1b with LoRA on all
               seven targets and two adapters; and mixtral-8x7b from its
               directory with LoRA on the attention targets and one
               adapter: concurrent /v1/completions (one
               streaming) and /v1/chat/completions; a greedy request repeats
               exactly over at least 512 cached tokens (with int8 and the
               tier, after its prefix pages were spilled and restored; for
               every model but llama, its token logprobs too); the launch
               counters show each run went through its mode's kernels and
               no plain version; the int8 runs' /metrics carry the quant
               (and offload) series. The llama bf16 and qwen2.5-7b bf16
               servers run with sleep mode on and end with the engine
               surface ("surface" lines): /stats carries the JAX keys of
               the port's features; /slo_records one ok record per request
               (with TTFT, ITL p99 and queue time) and none past its head;
               /metrics the phase histograms (counts above 0), the card's
               bytes in use, the pools' own bytes and the nvcc build's
               seconds; /v1/embeddings unit vectors, each within EMBED_ATOL
               of the same input embedded alone, and the largest bucket (32
               x max_model_len tokens) with its peak memory (no kernel and
               no plain version runs); /v1/rerank, /v2/rerank, /v1/score and a chat
               request with tools answer 200; then sleep (llama level 1,
               qwen2.5-7b level 2): /is_sleeping true, a completion 503,
               torch.cuda.memory_reserved down by at least the pools' bytes
               (and the weights' at level 2); after /wake_up the greedy
               repeat returns the text (and logprobs) of before the sleep
               through the kernels, no plain version running. The LoRA
               servers load their adapters over HTTP (/v1/models lists
               them with their parent); each adapter's greedy output
               repeats and differs from base's, a base and an adapter
               request run in flight together, the same prompt under an
               adapter moves no prefix-cache hit, an unload while its
               request is in flight answers 400, a request for an
               unloaded adapter 404, and a reload gets a fresh salt. Then
               an OPT engine with int8 pools must be refused. The
               directories are deleted.
5b. tp       -- before that refusal, while qwen2.5-7b's directory exists:
               two tp ranks (two processes) on the one card over gloo,
               asked for by name (llama-3.2-1b at full width cut to
               RANK_LAYERS = 2 of its 16 layers in 5b, 5c and 5i's f32
               tokens, to keep the smoke inside its time limit): llama-3.2-1b's logits of a 512-token
               chunk and a decode step at tp 2 against tp 1's in this run
               (FORWARD_LOGIT_BOUND, FORWARD_TOP1_MIN); the server at tp 2
               with bf16 pools, then with int8 pools, the CPU tier and 40
               pages (pages spill and come back through the gathered page
               reads; the greedy repeat repeats); an f32 copy's greedy
               tokens at tp 2 against tp 1 (a flip only at a near-tie,
               its margin printed); qwen2.5-7b from its directory at tp 2
               (each rank reads its slice of every split tensor; the
               sampled parameters joined from both ranks byte-identical to
               what was written). Every rank's launches are read through
               the step stream (runner.rank_stats) and each rank must
               have launched both kernels of its mode; "tp_ranks" lines
               give each rank's step and collective seconds and bytes
               (gloo stages the collectives through the host: functional
               numbers, not a tp speed figure).
5c. dp       -- then in-engine data parallelism, every rank a process on the
               one card over gloo: "dp_forward" holds llama-3.2-1b's logits
               of four rows (two per dp rank) at dp 2 against dp 1's in
               this run (FORWARD_LOGIT_BOUND, FORWARD_TOP1_MIN; flips
               printed with dp 1's top-2 margin), and "dp_costs" gives the
               collectives and replica-sync bytes of a prefill chunk and of
               an 8-step burst; "dp_f32_tokens" holds an f32 copy's greedy
               tokens of four concurrent prompts at dp 2 against dp 1 (a
               flip only at a near-tie); the server at dp 2 with bf16 pools
               and at dp 2 x tp 2 with int8 pools, the CPU tier and 40
               pages answer over HTTP and repeat; every rank launched both
               kernels of its mode and no plain version, and after each
               serve every dp replica's pools and scales have one digest
               (runner.replica_digest).
5d. spec   -- after the tp = 1 serve runs: "spec_chain" runs an f32 copy
               of llama-3.2-1b at full width and depth through the runner:
               step_spec (8 rounds, k 4, n 3) on four rows whose prompts
               repeat 3-grams, against step_multi's greedy tokens (a
               differing token only at a near-tie, TP_NEAR_TIE; rows 0 and
               1 hold their next 4 greedy tokens after an earlier copy of
               their trailing 3-gram, so round 1 accepts them; the
               acceptance rate and tokens per verify round printed), and
               step_multi_pipelined (4 bursts of 8, fetch_group 4) against
               4 calls of step_multi: tokens equal and pools byte-identical.
               Then llama-3.2-1b served three more times over HTTP:
               decode_pipeline 4 with bf16 pools (a lone greedy request's
               token ids equal to the same request's at decode_pipeline 1, the
               "chained_lone" line; 8 streams arriving 0.5 s apart behind
               a long one must give chained and run-ahead prefill
               dispatches on /metrics), decode_pipeline 4 with int8 pools,
               the CPU tier and 40 pages (the greedy repeat across a spill
               and a restore), and speculative_k 4 with bf16 pools (the
               draft counters move, the acceptance rate in [0, 1], a
               logprobs request gets 400, a repetitive prompt ends by
               length; its decode is verify rounds: no decode kernel, and
               L prefill launches per prefill step and per round). Each
               prints output tok/s, ITL from /slo_records, the chain
               seconds and the card.
5e. stack  -- after the spec runs: the engine inside the stack's services.
               The port's cache server and KV-index controller start as
               subprocesses (``python -m production_stack_tpu_torch.
               kvoffload.{cache_server,controller}``); llama-3.2-1b (bf16,
               40 pages, the cache server as its only offload tier, warm
               start on, the debug routes on) serves a greedy request,
               then three longer ones over HTTP, one under a traceparent
               this phase made: ``/v1/traces`` holds engine.queue,
               engine.prefill and engine.decode spans whose parent chain
               reaches that span, ``/v1/debug/flightrecorder`` "sched"
               events carry its trace id, the controller's ``lookup_url``
               (what the router's kvaware routing calls) names this
               engine, and ``/metrics/reset`` empties the hop windows. The
               server drains (spilling the warm manifest) and stops; a
               fresh engine over the same namespace restores it before it
               serves, and its first request, the first prompt again, is
               a prefix hit with the first incarnation's greedy token ids;
               both kernels launched in each incarnation. Then an int8
               server with the cache server as its only tier (int8 blobs
               over TCP, restored through the kernels). The "stack" line
               gives the warm restore's pages and seconds, the first
               request's TTFT after the restart beside the cold engine's,
               each engine's second request (the same prompt, a prefix
               hit in both) and the remote tier's bytes and seconds, with
               the card.
5f. disagg -- after the stack phase: disaggregated prefill. For each of
               TCP blobs, the KV fabric (frames of 4 layers), CUDA IPC
               (``--kv-transfer-device``) and, with int8 pools, the
               fabric: a producer api_server subprocess (llama-3.2-1b
               bf16, 64-token pages) and a consumer engine behind a port
               server in this process. The phase sends the router's two
               requests itself: the 1,101-token prompt with max_tokens=1
               and ``kv_transfer_params`` to the producer, then the whole
               request (16 greedy tokens with their top-5 logprobs,
               streamed) to the consumer. The consumer must restore all 17
               full pages (1,088 cached tokens), byte-identical across the
               three bf16 transports and equal to the blobs' bytes (the
               producer's pool bytes); answer a cold monolithic engine's
               ids on the same prompt (int8: a cold int8 engine's), with
               every logprob within 0.1 of its; the producer launches the prefill kernel
               with its write and no decode, the consumer the decode
               kernel and the prefill kernel once a layer (the 13-token
               tail); the int8 pair only the int8 kernels; the device run
               ships every page over CUDA IPC with no TCP blob. A "disagg"
               line per transport: pages and MiB, the producer's push
               seconds, the consumer's TTFT beside a cold monolithic
               engine's on the same prompt, the launches, the card. After
               the TCP pair, the consumer's pools dropped (sleep, wake),
               the same prompt goes once more through the port's router
               (``production_stack_tpu_torch.router.app``,
               ``--routing-logic disaggregated_prefill``) over the same
               producer and consumer under a fresh request id: its ids
               must be the direct run's, the producer must launch the
               prefill kernel with its write and no decode, the consumer
               must restore the 17 pages, prefill the tail and decode; a
               "router" line gives the router's routes per backend and
               its TTFT beside the engines' for that request.
5g. fleet  -- after the disagg phase: the fleet KV directory and live
               migration. The port's cache server with ``--directory
               --metrics-port`` as a subprocess; engines A and B
               (llama-3.2-1b bf16, full width and depth, a CPU tier, the
               cache server as the remote tier and the directory, the
               fabric) behind port servers in this process; the port's
               router (``production_stack_tpu_torch.router.app`` with
               ``--routing-logic kvaware --kv-directory-url``) as a
               subprocess. A's first request, straight to A, is the
               unmigrated run (128 greedy tokens of a 1,091-token prompt:
               17 full pages and a tail) and a cold engine's TTFT; the
               same request streamed through the router goes to A (the
               directory names A resident); after 16 tokens A's
               ``/migrate_out`` moves it to B through the shared tier (B's
               fabric listener is down, so the ship falls back: A saves
               the 17 pages to the cache server, B fetches and restores
               them), after 8 more on B, B's moves it back to A over the
               fabric; the router splices both hops. The client's one
               stream must carry 128 tokens, one [DONE] and no control
               event, its ids equal to the unmigrated run's (a first
               difference only where that run's top-2 margin is under
               FORWARD_LOGIT_BOUND); each source listed the stream on
               ``/migratable``; each hop moved 17 pages on its own path
               (the migration and fabric counters); each target launched
               the prefill kernel for the tail chunk alone (16 launches)
               and the decode kernel; no plain version ran. A second
               request with the same 17-page prefix goes through the
               router to an engine the directory's ``dir_lookup`` names
               resident (a resident route; that engine's prefix hits move
               17 pages). Engine C boots with ``warm_prefetch_on_boot``
               64 and restores the 17 shared pages on its first request.
               The lines give each hop's freeze-to-commit seconds and
               pages, the client's gap at each splice against the stream's
               median gap, C's boot prefetch and its first TTFT against
               the cold one, the launches per engine and the phase's
               seconds, each with the card; a "router" line gives the
               router's routes per backend and its TTFT of the stream and
               the second request beside the engines' and the client's.
5h. ep     -- after the one-rank mixtral-8x7b serve (whose prepare records
               its logits of two rows, two 512-token chunks and 8 decode
               steps, and the experts its routers took) and before its
               directory is deleted: mixtral-8x7b-hf at ep 2 (4 experts a
               rank) and at ep 2 x tp 2 (4 experts of I/2, 16 query and 4
               KV heads a rank), every rank a gloo process on the one
               card: each engine's logits of the same steps, with the one
               rank's experts replayed on every rank
               (runner.replay_routes), held to FORWARD_LOGIT_BOUND and
               FORWARD_TOP1_MIN ("ep_forward"), then served over HTTP;
               then mixtral-8x7b-hf at pp 2 x ep 2 (each stage's 2 layers,
               4 experts a rank), held the same way, its adapter row
               included, with each stage replaying its layers' routes a
               microbatch at a time ("moe_stages"), and at sp 2 x ep 2
               (max_model_len 8,192): a 4,096-token row in two chunks of
               2,048 and 8 decode steps against the one rank's logits of those
               steps (taken in the same prepare, its routes taped), each
               sequence rank replaying its tokens' routes ("moe_seq", with
               "moe_seq_costs"), both served over HTTP (the sp 2 x ep 2
               main path's first prompt 4,096 tokens, in chunks of 512,
               the prefill_chunk at which the greedy repeat recomputes in
               the first run's chunk shape); then a seeded
               mixtral-8x7b at full width cut to 4 layers at dp 2 against
               its own one rank ("dp_moe_forward") and served.
               Every rank launched both kernels and no plain version; the
               ep and dp replicas' pools have one digest; "ep_ranks" and
               "dp_ranks" lines give each rank's device bytes, collective
               share, expert all-reduces and launches.
5i. pp     -- after the dp runs, while qwen2.5-7b's directory exists:
               RANK_LLAMA (llama-3.2-1b at full width, 2 of its 16 layers,
               1 a stage) at pp 2 and at pp 2 x tp 2, every rank a gloo
               process on the one card: each engine's logits of the tp
               forward's steps against the tp phase's one rank
               ("pp_forward", FORWARD_LOGIT_BOUND and FORWARD_TOP1_MIN), a
               32-row decode step whose decode launches every stage counts
               (4 microbatches x 1 layer: "pp_step"), then served over HTTP;
               the f32 copy of RANK_LLAMA's greedy tokens at pp 2 against
               pp 1 ("pp_f32_tokens"); qwen2.5-7b from its directory at pp
               2, each stage's bytes read equal to its 2 layers and the
               shared tensors, sampled parameters of both stages
               byte-identical to what was written ("pp_hf_load"), served.
               Every stage rank launched both kernels and no plain
               version; "pp_ranks" lines give each rank's device bytes,
               relays (calls, bytes, seconds) and collective share.
5j. sp     -- after the pp runs: RANK_LLAMA (llama-3.2-1b at full
               width, 2 of its 16 layers, as 5b, 5c and 5i run it),
               max_model_len 16,384 and prefill_chunk 2,048, at sp 2 and
               at sp 2 x tp 2, every rank a gloo process on the one card:
               each engine's logits of an 8,191-token row in four chunks
               (the last of 2,047, padded to a multiple of sp) and 32
               teacher-forced decode steps against one rank's
               ("sp_forward", FORWARD_LOGIT_BOUND and FORWARD_TOP1_MIN),
               with what every rank moved in those steps ("sp_costs": the
               ring's calls, bytes and seconds, the collectives' share,
               device bytes); then served over HTTP, the 8,191-token
               prompt for 32 greedy tokens beside a streamed completion
               and a chat: every sequence rank launched the decode kernel
               and neither the prefill kernel (a chunk goes through the
               ring) nor a plain version, the sequence ranks of each tp
               place hold byte-identical pools ("sp_ranks" lines); the f32
               copy of RANK_LLAMA's greedy tokens at sp 2 against one
               rank's ("sp_f32_tokens").
5k. LoRA on ranks -- inside 5b, 5c, 5h, 5i and 5j: the engines of the
               rank paths serve LoRA. Each one-rank reference loads its
               adapters (RANK_LLAMA's own two, rank 8 and 16 on all seven
               targets; llama-3.2-1b's at sp; mixtral-8x7b's on its
               attention at ep) and puts rows on them ("lora_reference":
               each adapter row moved off base by more than
               FORWARD_LOGIT_BOUND); each rank engine's logits check loads
               the same adapters first and unloads them after, and a
               "lora_ranks" line holds the adapter rows to
               FORWARD_LOGIT_BOUND of one rank's and gives each rank's LoRA
               buffer bytes (runner.rank_stats) against one rank's (tp 2,
               dp 2, pp 2, pp 2 x tp 2, sp 2, sp 2 x tp 2, ep 2, ep 2 x tp
               2); the f32 tokens run with base and adapter prompts; the tp
               2, dp 2, pp 2 x tp 2, sp 2 and ep 2 x tp 2 servers end their
               main path with the LoRA routes (_lora_requests,
               LORA_LIGHT_TOKENS a request), whose launches add to their
               kernel rows. A "phase_seconds" line sums what LoRA added.
5l. chaos  -- after the fleet phase: the stack's chaos drill with a real
               engine. Two of the port's fake engines
               (``production_stack_tpu_torch.testing.fake_engine``) as
               subprocesses, one ``--fail-rate 1.0`` and one ``--hang``,
               and llama-3.2-1b (bf16, full width and depth, max_num_seqs
               and max_waiting_seqs 4) in this process behind the port's
               router (a retry budget of 3, a 3 s TTFT deadline, a
               breaker threshold of 3 with a 300 s cooldown). 16
               sequential greedy requests of 16 tokens, each prompt sent
               straight to the engine first: every routed answer a 200
               with the direct text, no request over the budget in the
               router's /v1/traces, both fakes' breakers open and the
               engine's closed, both kernels launched. Then 24 concurrent
               streamed requests of 64 tokens: only 200s (at least 4) and
               429s with Retry-After, at least one 429, no more client 429s
               than the engine's vllm:num_requests_shed_total delta, the
               engine's breaker still closed. A "chaos" line gives the
               status counts, the most attempts, the breaker states, the
               burst's TTFT p50, the sheds, the launches and the seconds,
               with the card.
5n. shared_heads -- after the tp runs: Qwen2.5-1.5B's HF directory (its
               published config.json, 12 query and 2 KV heads, a tied head,
               cut to 4 of its 28 layers; seeded bf16) at tp 4, four gloo
               ranks on the one card, each with 3 query heads and one KV
               head shared with its neighbour: tp 1's logits of the tp
               forward's steps against tp 4's ("shared_heads"); its first
               page gathered at tp 4 (2 KV heads, tp 1's layout, layer 0
               against tp 1's), tp 1's page written into every rank and
               read back byte for byte, the two ranks of each share one
               digest, each rank's pool half of tp 1's
               ("shared_heads_pages"); served over HTTP, every rank
               launching the decode and prefill kernels and the write, no
               plain version (the [tp4kh2] rows); an f32 copy of the shape
               (a seeded preset) giving tp 1's greedy tokens at tp 4
               ("shared_heads_f32_tokens"). The directory is deleted after.
5m. multihost -- after the sp_compose runs: multi-host serving, two host
               processes (each the port's api_server.serve with its
               --distributed-process-id) on the one card over gloo,
               RANK_LLAMA at dp 2 x tp 2 (two ranks a host) and pp 2 (one
               stage a host). bf16 with RANK_ADAPTERS, this process the
               leader and the follower host a subprocess
               (``multihost_host_main``): the tp phase's one-rank logits
               ("multihost_forward", "lora_ranks"), every rank's LoRA
               slots changed by a load (the follower host's log shows the
               replayed slot write), the dp replicas' weights equal across
               hosts; then four streamed requests through the leader, one
               under an adapter loaded over HTTP: TTFT and ITL, both
               kernels and the write launched on every rank of both hosts
               and no plain version, each rank's collectives' share of its
               step, the step stream's frames and bytes by method; the
               leader's stop ends the follower host with exit 0
               ("multihost" lines; the launches go to the [tp2] and [pp2]
               rows). Then an f32 copy's greedy tokens at both layouts
               (both hosts subprocesses) against one rank's in this
               process, flips only at near-ties, and at pp 2 the follower
               host's processes killed: the leader must exit 13
               ("multihost_f32_tokens").
5o. sp_compose -- after the sp runs: RANK_LLAMA served at dp 2 x sp 2 and
               pp 2 x sp 2 (four gloo ranks on the one card), and at sp 2
               and pp 2 with speculative_k 4, each behind the port's
               router (a greedy request straight to the server and through
               the router give the same text; a "router" line): each
               server's logits of the sp phase's 8,191-token row and 32
               decode steps against one rank's on the base model
               ("sp_compose_forward"); on the spec servers step_spec's
               tokens against the server's own step_multi greedy tokens,
               flips only at near-ties, round 1 accepting planted drafts
               ("spec_greedy"); every rank's launches, no plain version,
               the replicas' digests. The decode kernel on every rank of
               the dp 2 x sp 2 and pp 2 x sp 2 servers ([dp2sp2],
               [pp2sp2]); the prefill kernel at the verify shape on each
               stage's pool on the pp 2 spec server ([pp2verify]); no
               kernel on the sp 2 spec server (its chunks and verify
               rounds go through the ring, as in the JAX forward). A
               "phase_seconds" line per server.
6. timing   -- each kernel row (three fp, three int8, at llama-3.2-1b's,
               qwen2.5-7b's and gemma-2-2b's shapes), its plain version and
               a PyTorch yardstick, with CUDA events, beside its bound (the
               prefill launch timed without and with the chunk's write: the
               write rows' time is the difference, beside the write's
               bound, and the whole launch's time beside its own); then
               the decode kernel at small batch (1 x 2,048, 8 x 1,024, 1 x
               8,192; qwen2.5-7b's 1 x 8,192), gemma-2-2b's 1 x 8,192 on a
               sliding and a global layer, both modes, opt-125m's decode
               and prefill, and mixtral-8x7b's (G = 4 at D = 128) decode
               burst step and prefill chunk, both modes, as rows of their
               own; the tp 2 ranks' rows (llama-3.2-1b's heads in both
               modes, qwen2.5-7b's in bf16); a dp 2 rank's decode rows
               (16 x 1,024, half the 32 x 1,024 row's rows, at
               llama-3.2-1b's heads and at mixtral-8x7b's, [d128,dp2]);
               the ep 2 x tp 2 rank's decode and prefill ([ep2tp2]); a
               pipeline stage's decode of one 8-row microbatch and its
               prefill chunk on its 8-layer pool, at pp 2 and pp 2 x tp 2
               ([pp2], [pp2tp2]); a sequence rank's decode of the long
               prompt's last step, at sp 2 and sp 2 x tp 2 ([sp2],
               [sp2tp2]); Qwen2.5-1.5B's tp 4 rank's decode and prefill
               ([tp4kh2]); mixtral-8x7b's pp 2 x ep 2 stage rank's decode
               and prefill ([pp2ep2]) and sp 2 x ep 2 sequence rank's
               decode ([sp2ep2]); a dp 2 x sp 2 rank's decode (16 x
               1,024 on the 2-layer pool, [dp2sp2]), a pp 2 x sp 2 stage
               rank's (one 8-row microbatch on the 1-layer stage pool,
               [pp2sp2]) and the verify shape on a stage's pool (8 x 5
               after 1,024, [pp2verify]); the prefill
               kernel at step_spec's verify shape (T = 5: llama-3.2-1b's
               32 x 1,024, the [verify] row; gemma-2-2b's 8 x 4,096 on a
               sliding and a global layer, as lines of their own).

Then the kernel table line (each row's launches from its own path's runs:
the llama and opt-125m servers for D = 64, the qwen2.5-7b and
mixtral-8x7b servers for D = 128, the gemma-2-2b server for its bf16 rows
and its int8 kernel forward for its int8 rows, which no server runs; the
[tp2] rows from the tp 2 servers, summed over both ranks, and from the dp 2
x tp 2 int8 server's four ranks; the [dp2] row from the dp 2 server's two
ranks; the [d128,dp2] row from the dp 2 mixtral server's two ranks; the
[ep2tp2] rows from mixtral's ep 2 x tp 2 server's four ranks; the [pp2]
and [pp2tp2] rows from RANK_LLAMA's pp 2 and pp 2 x tp 2 servers' ranks;
the [sp2] and [sp2tp2] rows from llama-3.2-1b's sp 2 and sp 2 x tp 2
servers' ranks; the [tp4kh2] rows from the Qwen2.5-1.5B tp 4 server's
four ranks, the [pp2ep2] and [sp2ep2] rows from mixtral's pp 2 x ep 2 and
sp 2 x ep 2 servers' ranks; the [dp2sp2] and [pp2sp2] rows from
RANK_LLAMA's dp 2 x sp 2 and pp 2 x sp 2 servers' ranks, the [pp2verify]
row from the pp 2 spec server's verify rounds (every stage's launches
inside step_spec, runner.rank_stats' "verify_launches")
(qwen2.5-7b's pp 2 server books to the [d128] rows, every stage's chunk
writes to the kv_page_write rows of its heads); the
[verify] row from the spec server's verify rounds, L a round;
the D = 64 rows also count the disagg phase's producers' and consumers'
launches, the fleet phase's engines' and the chaos phase's engine's; each phase ends with a
"phase_seconds" line), the
card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``. With
no CUDA device, or run from a directory without the package, it exits
non-zero and prints no result. f32 comparisons run with TF32 off.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16
# tensor-core FLOP/s. A card set below 700 W runs slower than these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# A kernel's output passes where every element holds
#     |out - ref| <= rtol * |ref| + k * mean|ref|,
# ref being the plain version on the same inputs, as (rtol, k) by dtype:
# - bf16: rtol 2^-6 is 2 to 4 bf16 ulps of the value (both sides round f32
#   sums, made in another order, to bf16); k * mean|ref| covers the prefill
#   kernel's rounding of the softmax weights to bf16 before P @ V, which the
#   plain version keeps in f32, and values near 0.
# - f32 (TF32 off): the card sums in another order.
# Scaled to the output, the bound stays tight at long context, where
# outputs are averages over thousands of keys and typically ~0.03. On the
# main-path cases the plain version with one key fewer per row (an
# off-by-one in the history bound) must fail the same check.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0**-6, 0.05)}
# The capped-score cases (D = 256, q scaled so that scores reach the
# softcap of 50) hold bf16 to k = 0.02: a tanh with a relative error of
# 2^-11 (PTX's bound for tanh.approx.f32) would move a capped score by up
# to 0.024 and p by up to 2.4%, which the 0.05 term could let through.
TOL_CAPPED = {"bfloat16": (2.0**-6, 0.02)}

# Where each TPU kernel's launch sits in the JAX package. Each kernel has a
# row at head_dim 64 (llama-3.2-1b, opt-125m), one at 128 ("[d128]":
# qwen2.5-7b) and one at 256 ("[d256]": gemma-2-2b).
_BASE_REPLACES = {
    "decode_attention": "production_stack_tpu/ops/pallas/paged_attention.py:67",
    "prefill_attention": "production_stack_tpu/ops/pallas/prefill_attention.py:72",
    "kv_page_write": "production_stack_tpu/ops/pallas/prefill_attention.py:396",
    "decode_attention[int8]": "production_stack_tpu/ops/pallas/paged_attention.py:97",
    "prefill_attention[int8]": "production_stack_tpu/ops/pallas/prefill_attention.py:112",
    "kv_page_write_quant": "production_stack_tpu/ops/pallas/prefill_attention.py:304",
}
_BASE_SOURCES = {
    "decode_attention": "production_stack_tpu_torch/csrc/decode_attention.cu",
    "prefill_attention": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "kv_page_write": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "decode_attention[int8]": "production_stack_tpu_torch/csrc/decode_attention.cu",
    "prefill_attention[int8]": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "kv_page_write_quant": "production_stack_tpu_torch/csrc/prefill_attention.cu",
}


def _dtag(name: str, D: int) -> str:
    """A kernel row's name at head_dim D (64 keeps the bare name):
    decode_attention[int8] at 256 -> decode_attention[int8,d256]."""
    if D == 64:
        return name
    return name[:-1] + f",d{D}]" if name.endswith("]") else name + f"[d{D}]"


def _tptag(name: str, tp: int, kh: "int | None" = None) -> str:
    """A kernel row's name at a tp rank's heads (tp 1 keeps the name):
    decode_attention[d128] at tp 2 -> decode_attention[d128,tp2]; at a tp
    that shares the model's ``kh`` KV heads (tp > kh), tp 4 over 2 ->
    decode_attention[d128,tp4kh2]."""
    if tp == 1:
        return name
    tag = f"tp{tp}" + (f"kh{kh}" if kh and tp > kh else "")
    return name[:-1] + f",{tag}]" if name.endswith("]") else name + f"[{tag}]"


def _eptag(name: str, ep: int, tp: int) -> str:
    """A kernel row's name at an (ep, tp) rank's heads (ep 1 keeps the
    name): decode_attention[d128] at ep 2 x tp 2 ->
    decode_attention[d128,ep2tp2]."""
    if ep == 1:
        return name
    tag = f"ep{ep}tp{tp}"
    return name[:-1] + f",{tag}]" if name.endswith("]") else name + f"[{tag}]"


def _pptag(name: str, pp: int, tp: int, ep: int = 1) -> str:
    """A kernel row's name at a pipeline stage rank (pp 1 keeps the name):
    decode_attention at pp 2 -> decode_attention[pp2], at pp 2 x tp 2 ->
    decode_attention[pp2tp2], decode_attention[d128] at pp 2 x ep 2 ->
    decode_attention[d128,pp2ep2]."""
    if pp == 1:
        return name
    tag = f"pp{pp}" + (f"ep{ep}" if ep > 1 else "") + (f"tp{tp}" if tp > 1 else "")
    return name[:-1] + f",{tag}]" if name.endswith("]") else name + f"[{tag}]"


def _sptag(name: str, sp: int, tp: int, ep: int = 1, dp: int = 1, pp: int = 1) -> str:
    """A kernel row's name at a sequence-parallel rank (sp 1 keeps the
    name): decode_attention at sp 2 -> decode_attention[sp2], at sp 2 x tp 2
    -> decode_attention[sp2tp2], decode_attention[d128] at sp 2 x ep 2 ->
    decode_attention[d128,sp2ep2], beside dp or pp ranks
    decode_attention[dp2sp2] and decode_attention[pp2sp2]."""
    if sp == 1:
        return name
    tag = (f"pp{pp}" if pp > 1 else "") + (f"dp{dp}" if dp > 1 else "") + f"sp{sp}" + (f"ep{ep}" if ep > 1 else "") \
        + (f"tp{tp}" if tp > 1 else "")
    return name[:-1] + f",{tag}]" if name.endswith("]") else name + f"[{tag}]"


def _dptag(name: str, dp: int) -> str:
    """A kernel row's name at a dp rank's rows (dp 1 keeps the name):
    decode_attention at dp 2 -> decode_attention[dp2]."""
    if dp == 1:
        return name
    return name[:-1] + f",dp{dp}]" if name.endswith("]") else name + f"[dp{dp}]"


HEAD_DIMS = (64, 128, 256)
REPLACES = {_dtag(k, D): v for D in HEAD_DIMS for k, v in _BASE_REPLACES.items()}
SOURCES = {_dtag(k, D): v for D in HEAD_DIMS for k, v in _BASE_SOURCES.items()}
# the rows of the tp = 2 serve runs: each rank's kernels at its heads
# (llama-3.2-1b's in fp and int8 pools, qwen2.5-7b's in bf16). A rank's
# decode is the per-shard body of the sharded decode (decode_attention_sharded
# in the port); each rank runs the prefill kernel too, where the JAX engine
# keeps XLA for a multi-device prefill
SHARDED_DECODE = "production_stack_tpu/ops/pallas/paged_attention.py:472"
TP_SERVED = ((64, False), (64, True), (128, False))  # (head_dim, int8 pools)
for _D, _quant in TP_SERVED:
    for _base in (("decode_attention[int8]", "prefill_attention[int8]", "kv_page_write_quant") if _quant
                  else ("decode_attention", "prefill_attention", "kv_page_write")):
        REPLACES[_tptag(_dtag(_base, _D), 2)] = SHARDED_DECODE if _base.startswith("decode") else _BASE_REPLACES[_base]
        SOURCES[_tptag(_dtag(_base, _D), 2)] = _BASE_SOURCES[_base]
# a dp 2 rank's decode: the sharded decode on the rank's rows (B/dp), all of
# llama-3.2-1b's heads; the dp 2 server's decode launches. Its prefill runs
# each row as tp 1 does (the rows above take those launches)
DP_ROW = _dptag("decode_attention", 2)
# the dp 2 MoE serve's decode: mixtral-8x7b's heads on a dp 2 rank's rows
DP_MIXTRAL_ROW = _dptag(_dtag("decode_attention", 128), 2)
for _row in (DP_ROW, DP_MIXTRAL_ROW):
    REPLACES[_row] = SHARDED_DECODE
    SOURCES[_row] = _BASE_SOURCES["decode_attention"]
# the prefill kernel at step_spec's verify shape (llama-3.2-1b, T = 5): the
# spec server's verify rounds, where the JAX engine runs its XLA attention
# below 16 tokens; the same TPU kernel replaced
REPLACES["prefill_attention[verify]"] = _BASE_REPLACES["prefill_attention"]
SOURCES["prefill_attention[verify]"] = _BASE_SOURCES["prefill_attention"]
# mixtral-8x7b's ep 2 x tp 2 ranks (phase_ep_ranks): each rank's decode,
# the sharded decode on its tp place's heads (the same on both ep ranks),
# and its prefill chunk; the ep 2 x tp 2 server's launches
EP_ROWS = {_eptag(_dtag(k, 128), 2, 2): k for k in ("decode_attention", "prefill_attention")}
for _row, _base in EP_ROWS.items():
    REPLACES[_row] = SHARDED_DECODE if _base.startswith("decode") else _BASE_REPLACES[_base]
    SOURCES[_row] = _BASE_SOURCES[_base]
# llama-3.2-1b's pipeline stage ranks (phase_pp_ranks): each stage's decode,
# the sharded decode on one microbatch's rows over the stage's pool (its
# pp mapping), and its prefill chunk on the stage's pool, at pp 2 (all
# heads) and pp 2 x tp 2 (the tp place's heads); the pp servers' launches
PP_ROWS = {_pptag(k, 2, tp): (k, tp) for tp in (1, 2) for k in ("decode_attention", "prefill_attention")}
for _row, (_base, _) in PP_ROWS.items():
    REPLACES[_row] = SHARDED_DECODE if _base.startswith("decode") else _BASE_REPLACES[_base]
    SOURCES[_row] = _BASE_SOURCES[_base]
# llama-3.2-1b's sequence-parallel ranks (phase_sp_ranks): each rank's
# decode, the sharded decode on its sp mapping (every sequence rank runs the
# whole step on its tp place's heads over its replica of the pool), at sp 2
# (all heads) and sp 2 x tp 2; the sp servers' decode launches. A chunk at
# sp goes through the ring, no kernel, as in the JAX forward
SP_ROWS = {_sptag("decode_attention", 2, tp): tp for tp in (1, 2)}
for _row in SP_ROWS:
    REPLACES[_row] = SHARDED_DECODE
    SOURCES[_row] = _BASE_SOURCES["decode_attention"]
# Qwen2.5-1.5B at tp 4 (phase_shared_heads): each rank's 3 query heads on
# the one KV head it shares with its neighbour, its decode (the sharded
# decode at a shared head) and its prefill chunk, the tp 4 server's
# launches. mixtral-8x7b at pp 2 x ep 2 (phase_ep_ranks' "moe_stages"): a
# stage rank's decode of one microbatch and its prefill chunk on its
# 2-layer pool, all heads; at sp 2 x ep 2 ("moe_seq"): a sequence rank's
# decode of the long prompt's step (its chunks go through the ring)
KH_ROWS = {_tptag(_dtag(k, 128), 4, 2): k for k in ("decode_attention", "prefill_attention")}
PP_EP_ROWS = {_pptag(_dtag(k, 128), 2, 1, 2): k for k in ("decode_attention", "prefill_attention")}
SP_EP_ROWS = {_sptag(_dtag("decode_attention", 128), 2, 1, 2): "decode_attention"}
for _row, _base in {**KH_ROWS, **PP_EP_ROWS, **SP_EP_ROWS}.items():
    REPLACES[_row] = SHARDED_DECODE if _base.startswith("decode") else _BASE_REPLACES[_base]
    SOURCES[_row] = _BASE_SOURCES[_base]
# sequence ranks beside dp and pp ranks (phase_sp_compose): a dp 2 x sp 2
# rank's decode (its dp replica's rows over its sp replica of the pool)
# and a pp 2 x sp 2 stage rank's (one microbatch over its sp replica of
# the stage's pool), the sharded decode on both mappings; and the prefill
# kernel at step_spec's verify shape on a stage's pool, the pp 2 spec
# server's verify rounds (the JAX pipeline keeps its XLA attention there)
DP_SP_ROW = _sptag("decode_attention", 2, 1, dp=2)
PP_SP_ROW = _sptag("decode_attention", 2, 1, pp=2)
VERIFY_PP_ROW = "prefill_attention[pp2verify]"
for _row in (DP_SP_ROW, PP_SP_ROW):
    REPLACES[_row] = SHARDED_DECODE
    SOURCES[_row] = _BASE_SOURCES["decode_attention"]
REPLACES[VERIFY_PP_ROW] = _BASE_REPLACES["prefill_attention"]
SOURCES[VERIFY_PP_ROW] = _BASE_SOURCES["prefill_attention"]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs


def _rand(gen, shape, dtype, device, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen) * scale).to(dtype).to(device)


def _page_table(gen, B, maxp, P, device):
    import torch

    return torch.randperm(P, generator=gen)[: B * maxp].reshape(B, maxp).to(torch.int32).to(device)


def _pools(gen, shape, dtype, device, quant, kv_normal=False):
    """(k_pages, v_pages, scales kwargs): random pools in ``dtype``, or with
    ``quant`` int8 pools and per-page, per-KV-head scales: uniformly random
    bytes with scales of a typical size (amax / 127 of unit-normal KV is
    ~0.025), or with ``kv_normal`` unit-normal K/V quantized as the KV write
    quantizes a page (scale = amax / 127 over the page's slots and D)."""
    import torch

    if not quant:
        return _rand(gen, shape, dtype, device), _rand(gen, shape, dtype, device), {}
    L, P, _, KH, _ = shape
    if kv_normal:
        pools, scales = [], []
        for _ in range(2):
            x = torch.randn(shape, generator=gen)
            sc = (x.abs().amax(dim=(2, 4)) / 127.0).clamp(min=1e-8)  # [L, P, KH]
            pools.append((x / sc[:, :, None, :, None]).round().clamp(-127, 127).to(torch.int8).to(device))
            scales.append(sc.to(device))
        return pools[0], pools[1], dict(k_scales=scales[0], v_scales=scales[1])
    pools = [torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(device) for _ in range(2)]
    scales = [(0.01 + 0.03 * torch.rand((L, P, KH), generator=gen)).to(device) for _ in range(2)]
    return pools[0], pools[1], dict(k_scales=scales[0], v_scales=scales[1])


def _poison_scales(kw, layer, pt, B, first_stale_page):
    """NaN scales on every page wholly past row b's live history: a kernel
    that reads a stale page's scale turns its output NaN."""
    for b in range(B):
        for lp in range(first_stale_page[b], pt.shape[1]):
            kw["k_scales"][layer, int(pt[b, lp])] = float("nan")
            kw["v_scales"][layer, int(pt[b, lp])] = float("nan")


def decode_case(seed, *, B, NH, KH, D, page, maxp, L, lens, cur_lens=None, C=0, dtype, window=None,
                softcap=None, sm_scale=None, layer=0, poison=False, quant=False, kv_normal=False, q_scale=1.0):
    """Inputs of one decode-kernel call: pools [L, P, page, KH, D] (int8
    with scales for ``quant``); with C > 0 a burst window k_cur/v_cur
    [B, C, KH, D] and its cur_lens; q unit-normal times ``q_scale``."""
    import torch

    device = "cuda"
    gen = torch.Generator().manual_seed(seed)
    P = B * maxp + 3
    kp, vp, skw = _pools(gen, (L, P, page, KH, D), dtype, device, quant, kv_normal)
    pt = _page_table(gen, B, maxp, P, device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    kw = dict(window=window, logit_softcap=softcap, sm_scale=sm_scale, layer=layer, **skw)
    if C:
        kw["k_cur"] = _rand(gen, (B, C, KH, D), dtype, device)
        kw["v_cur"] = _rand(gen, (B, C, KH, D), dtype, device)
        kw["cur_lens"] = torch.tensor(cur_lens, dtype=torch.int32, device=device)
    if poison and quant:  # int8 holds no NaN: the stale pages' scales do
        cl = cur_lens if C else [0] * B
        _poison_scales(kw, layer, pt, B, [-(-max(lens[b] - cl[b], 0) // page) for b in range(B)])
    elif poison:  # stale and out-of-range pool slots of every row hold NaN
        cl = cur_lens if C else [0] * B
        for b in range(B):
            s = torch.arange(max(lens[b] - cl[b], 0), maxp * page, device=device)
            pid = pt[b, s // page].long()
            kp[layer, pid, s % page] = float("nan")
            vp[layer, pid, s % page] = float("nan")
    q = _rand(gen, (B, NH, D), dtype, device, q_scale)
    return (q, kp, vp, pt, lens_t), kw


def prefill_case(seed, *, B, T, NH, KH, D, page, maxp, L, computed, chunks, dtype, window=None,
                 softcap=None, sm_scale=None, layer=0, poison=False, quant=False, kv_normal=False, q_scale=1.0):
    """Inputs of one prefill-kernel call: row b has computed[b] tokens in
    the pool (int8 with scales for ``quant``) and a chunk of chunks[b]
    tokens (0 = padded row); q unit-normal times ``q_scale``."""
    import torch

    device = "cuda"
    gen = torch.Generator().manual_seed(seed)
    P = B * maxp + 3
    kp, vp, skw = _pools(gen, (L, P, page, KH, D), dtype, device, quant, kv_normal)
    pt = _page_table(gen, B, maxp, P, device)
    pos = torch.full((B, T), -1, dtype=torch.int32)
    for b in range(B):
        pos[b, : chunks[b]] = torch.arange(computed[b], computed[b] + chunks[b])
    kv_lens = torch.tensor([c + n for c, n in zip(computed, chunks)], dtype=torch.int32, device=device)
    cur_lens = torch.tensor(chunks, dtype=torch.int32, device=device)
    kw = dict(window=window, logit_softcap=softcap, sm_scale=sm_scale, layer=layer, **skw)
    if poison and quant:  # the scales of pages wholly past each chunk start
        _poison_scales(kw, layer, pt, B, [-(-computed[b] // page) for b in range(B)])
    elif poison:  # every slot at or after each row's chunk start holds NaN
        for b in range(B):
            for s in range(computed[b], maxp * page):
                pid = int(pt[b, s // page])
                kp[layer, pid, s % page] = float("nan")
                vp[layer, pid, s % page] = float("nan")
    q = _rand(gen, (B, T, NH, D), dtype, device, q_scale)
    kc = _rand(gen, (B, T, KH, D), dtype, device)
    vc = _rand(gen, (B, T, KH, D), dtype, device)
    args = (q, kp, vp, pt, pos.to(device), kv_lens, kc, vc, cur_lens)
    return args, kw


def _same_bytes(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0


def _pool_err(a, b) -> float:
    """Max |a - b| over two pools; slots NaN in both count as equal, a NaN
    in one only as infinite."""
    import torch

    d = (a.float() - b.float()).abs()
    d = torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d)
    return float(d.nan_to_num(nan=float("inf")).max())


def _judge(out, ref, dtype, tol=TOL) -> dict:
    """The TOL check (or ``tol``'s): ``ratio`` is the largest |out - ref|
    over its allowed bound, so the output passes when ratio <= 1."""
    import torch

    rtol, k = tol[str(dtype).split(".")[-1]]
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    mean = float(r.mean())
    allowed = rtol * r + k * mean
    ratio = float((d / allowed).max()) if mean > 0 else (0.0 if float(d.max()) == 0 else float("inf"))
    return {"max_abs_err": _err(out, ref), "mean_abs_ref": mean, "rtol": rtol, "k_mean": k,
            "ratio_to_bound": ratio, "finite": bool(torch.isfinite(out.float()).all())}


# ---------------------------------------------------------------------------
# phases


def phase_build():
    from production_stack_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build()
    emit({
        "phase": "build", "seconds": round(time.perf_counter() - t0, 2),
        "per_source_seconds": {k: round(v, 2) for k, v in secs.items()},
        "nvcc_flags": " ".join(_build.NVCC_FLAGS),
        "card": nvidia_smi_line(),
    })
    for name in _build.SOURCES:
        # a "wgmma ... serialized" warning means ptxas made the products synchronous
        keep = ("Compiling entry function", "registers", "spill", "wgmma")
        report = [l.strip() for l in _build.ptxas_report(name).splitlines() if any(k in l for k in keep)]
        emit({"phase": "build", "ptxas": name, "lines": report[:60]})


MAIN_DECODE = "main_path_b32_ctx1024_c8_bf16"
DECODE_B1_8K = "small_batch_b1_ctx8192_c8_bf16"
DECODE_B1_2K = "small_batch_b1_ctx2048_c8_bf16"
DECODE_B8_1K = "small_batch_b8_ctx1024_c8_bf16"
MAIN_PREFILL = "main_path_t512_h1536_bf16"
INT8 = "int8_"  # the int8 pool twin of a case: same shapes, int8 pools and scales
# gemma-2-2b's attention (D = 256, G = 2): sm_scale = query_pre_attn_scalar**-0.5
# with a scalar other than D (144, so a kernel that falls back to D**-0.5
# fails), softcap 50, the sliding layers' window of 4,096. Its int8 pools
# hold unit-normal K/V quantized per page: with uniformly random bytes the
# scores spread so far (std ~2.4 after the scale) that a few keys carry each
# softmax, and a one-key-fewer output stayed inside the bound (ratio 0.86 at
# 32 x 1,024)
GEMMA = dict(NH=8, KH=4, D=256, softcap=50.0, sm_scale=144.0**-0.5, kv_normal=True)
GEMMA_WINDOW = 4096
GEMMA_DECODE = "gemma_main_b32_ctx1024_c8_bf16"
GEMMA_DECODE_B1_8K_SLIDING = "gemma_b1_ctx8192_c8_sliding_bf16"
GEMMA_DECODE_B1_8K_GLOBAL = "gemma_b1_ctx8192_c8_global_bf16"
GEMMA_PREFILL = "gemma_main_t512_h1536_bf16"
# qwen2.5-7b's attention (D = 128, G = 7: the decode fold fills 7 of its 16
# mma rows, and a prefill warpgroup's 64 rows hold 9 tokens x 7 heads and
# one padding row); its int8 pools hold unit-normal K/V quantized per page,
# as GEMMA's
QWEN = dict(NH=28, KH=4, D=128, kv_normal=True)
QWEN_DECODE = "qwen_main_b32_ctx1024_c8_bf16"
QWEN_DECODE_B1_8K = "qwen_b1_ctx8192_c8_bf16"
QWEN_PREFILL = "qwen_main_t512_h1536_bf16"
# opt-125m's (D = 64, G = 1: one row of the fold's 16, 64 tokens of one head
# in a prefill tile)
OPT = dict(NH=12, KH=12, D=64)
OPT_DECODE = "opt_b8_ctx1024_c8_g1_bf16"
OPT_PREFILL = "opt_t512_h1536_g1_bf16"
# mixtral-8x7b's (D = 128, G = 4: the decode fold fills 4 of its 16 rows, a
# prefill warpgroup's 64 rows hold 16 tokens x 4 heads); int8 pools of
# unit-normal K/V quantized per page, as QWEN's
MIXTRAL = dict(NH=32, KH=8, D=128, kv_normal=True)
MIXTRAL_DECODE = "mixtral_main_b32_ctx1024_c8_bf16"
MIXTRAL_PREFILL = "mixtral_main_t512_h1536_bf16"
# the tp ranks' heads: under tensor parallelism each rank runs both kernels
# on its NH/tp query heads and KH/tp KV heads (the decode through
# decode_attention_sharded), shapes no tp = 1 model gives; G is tp = 1's.
# llama-3.2-1b at tp 2 (KH 4) and 4 (KH 2), qwen2.5-7b at tp 2 (KH 2, G = 7),
# gemma-2-2b at tp 2 (NH 4, KH 2, D = 256), opt-125m at tp 2 (KH 6, G = 1)
TP_LLAMA = dict(NH=16, KH=4, D=64, tp=2)
TP4_LLAMA = dict(NH=8, KH=2, D=64, tp=4)
TP_QWEN = dict(NH=14, KH=2, D=128, kv_normal=True, tp=2)
TP_GEMMA = dict(GEMMA, NH=4, KH=2, tp=2)
TP_OPT = dict(NH=6, KH=6, D=64, tp=2)
TP_DECODE = "tp2_llama_b32_ctx1024_c8_bf16"
TP_PREFILL = "tp2_llama_t512_h1536_bf16"
TP_QWEN_DECODE = "tp2_qwen_b32_ctx1024_c8_bf16"
TP_QWEN_PREFILL = "tp2_qwen_t512_h1536_bf16"
# the dp ranks' rows: a dp 2 rank holds its group's B/2 rows and all of its
# tp group's heads; llama-3.2-1b at dp 2 (the [dp2] row: 16 of the 32 x
# 1,024 row's rows) and at dp 2 x tp 2
DP_LLAMA = dict(NH=32, KH=8, D=64, dp=2)
DP_TP_LLAMA = dict(NH=16, KH=4, D=64, tp=2, dp=2)
DP_DECODE = "dp2_llama_b16_ctx1024_c8_bf16"
# mixtral-8x7b at a dp 2 rank (the [d128,dp2] row: the dp 2 MoE serve's
# decode): 16 of the 32 x 1,024 row's rows, all 32 query and 8 KV heads
DP_MIXTRAL = dict(MIXTRAL, dp=2)
DP_MIXTRAL_DECODE = "dp2_mixtral_b16_ctx1024_c8_bf16"
# mixtral-8x7b at an ep 2 x tp 2 rank: NH/tp = 16 query heads and KH/tp = 4
# KV heads (G = 4, as at one rank); the attention is replicated along ep,
# so both ep ranks of a tp place run these shapes (at ep 2 alone a rank's
# are one rank's, the MIXTRAL cases)
EP_MIXTRAL = dict(NH=16, KH=4, D=128, kv_normal=True, tp=2, ep=2)
EP_DECODE = "ep2tp2_mixtral_b32_ctx1024_c8_bf16"
EP_PREFILL = "ep2tp2_mixtral_t512_h1536_bf16"
# llama-3.2-1b at a pipeline stage: the stage's pool holds 8 of the 16
# layers (L = 8, a local layer index), and a 32-row decode step runs as
# four microbatches of 8 rows (parallel/pipeline.microbatches), each row
# with its token's K/V beside the pool (C = 1, no burst window under pp);
# at pp 2 all heads, at pp 2 x tp 2 the tp place's 16 query and 4 KV
# heads. The prefill chunk: 512 after 1,536 on the stage's pool
PP_LLAMA = dict(NH=32, KH=8, D=64, pp=2)
PP_TP_LLAMA = dict(NH=16, KH=4, D=64, tp=2, pp=2)
PP_DECODE = "pp2_llama_mb8_ctx1024_stage_l8_bf16"
PP_TP_DECODE = "pp2tp2_llama_mb8_ctx1024_stage_l8_bf16"
PP_PREFILL = "pp2_llama_t512_h1536_stage_l8_bf16"
PP_TP_PREFILL = "pp2tp2_llama_t512_h1536_stage_l8_bf16"
# a sequence rank's decode after the sp phase's 8,191-token prompt: one row
# of 8,223 tokens (its last decode step), the burst window of 8, on
# llama-3.2-1b's 16-layer pool, at sp 2 (all heads) and sp 2 x tp 2 (the tp
# place's 16 query and 4 KV heads). Like the 1 x 8,192 case they have no
# one-key-fewer control: one key of 8,223 moves the output by less than
# the bound
SP_LLAMA = dict(NH=32, KH=8, D=64, sp=2)
SP_TP_LLAMA = dict(NH=16, KH=4, D=64, tp=2, sp=2)
SP_DECODE = "sp2_llama_b1_ctx8223_c8_bf16"
SP_TP_DECODE = "sp2tp2_llama_b1_ctx8223_c8_bf16"
SP_CASES = {1: SP_DECODE, 2: SP_TP_DECODE}
# Qwen2.5-1.5B at a tp 4 rank: NH 12 / 4 = 3 query heads and one of its 2
# KV heads, shared with the rank beside it (G = 3 at D = 128); ``kh`` is
# the model's KV heads, which the row's name carries
KH_QWEN15 = dict(NH=3, KH=1, D=128, kv_normal=True, tp=4, kh=2)
KH_DECODE = "tp4kh2_qwen15_b32_ctx1024_c8_bf16"
KH_PREFILL = "tp4kh2_qwen15_t512_h1536_bf16"
# mixtral-8x7b at a pp 2 x ep 2 stage rank: all 32 query and 8 KV heads
# (attention is replicated along ep), one 8-row microbatch on the stage's
# pool of 2 of the directory's 4 layers; at an sp 2 x ep 2 sequence rank:
# the long prompt's last decode step (4,096 tokens and 8 more) on the
# rank's replica of the 4-layer pool
PP_EP_MIXTRAL = dict(MIXTRAL, pp=2, ep=2)
PP_EP_DECODE = "pp2ep2_mixtral_mb8_ctx1024_stage_l2_bf16"
PP_EP_PREFILL = "pp2ep2_mixtral_t512_h1536_stage_l2_bf16"
SP_EP_MIXTRAL = dict(MIXTRAL, sp=2, ep=2)
SP_EP_DECODE = "sp2ep2_mixtral_b1_ctx4104_c8_bf16"
# a dp 2 x sp 2 rank: its dp replica's 16 of a 32-row burst step after
# 1,024 tokens, all heads, over its sp replica of RANK_LLAMA's 2-layer
# pool; a pp 2 x sp 2 stage rank: one 8-row microbatch of a 32-row step
# (the token's K/V beside the pool, C = 1) over its sp replica of the
# stage's 1-layer pool; the verify forward on a stage: the prefill kernel
# at T = 1 + k = 5 after 1,024 tokens, an 8-row microbatch, on the stage's
# 1-layer pool
DP_SP_LLAMA = dict(NH=32, KH=8, D=64, dp=2, sp=2)
PP_SP_LLAMA = dict(NH=32, KH=8, D=64, pp=2, sp=2)
DP_SP_DECODE = "dp2sp2_llama_b16_ctx1024_c8_l2_bf16"
PP_SP_DECODE = "pp2sp2_llama_mb8_ctx1024_stage_l1_bf16"
VERIFY_PP_LLAMA = "verify_pp2_llama_mb8_t5_h1024_stage_l1_bf16"
PP_CASES = {(1, "decode_attention"): PP_DECODE, (2, "decode_attention"): PP_TP_DECODE,
            (1, "prefill_attention"): PP_PREFILL, (2, "prefill_attention"): PP_TP_PREFILL}
# step_spec's verify forward: the prefill kernel at T = 1 + k = 5 (k = 4)
# after a long history, one launch per layer and round: llama-3.2-1b's heads
# at 32 rows after 1,024 tokens (the [verify] row, whose launches are the
# spec server's verify rounds) and gemma-2-2b's at 8 rows after 4,096, on a
# sliding layer (window 4,096) and a global one
VERIFY_K = 4
VERIFY_LLAMA = "verify_llama_b32_t5_h1024_bf16"
VERIFY_GEMMA_SLIDING = "verify_gemma_b8_t5_h4096_sliding_bf16"
VERIFY_GEMMA_GLOBAL = "verify_gemma_b8_t5_h4096_global_bf16"
VERIFY_ROW = "prefill_attention[verify]"
# the cases whose one-key-fewer control must fail the bound
CONTROLLED = {MAIN_DECODE, MAIN_PREFILL, GEMMA_DECODE, GEMMA_PREFILL, QWEN_DECODE, QWEN_PREFILL, OPT_DECODE,
              OPT_PREFILL, MIXTRAL_DECODE, MIXTRAL_PREFILL, TP_DECODE, TP_PREFILL, TP_QWEN_DECODE, TP_QWEN_PREFILL,
              DP_DECODE, DP_MIXTRAL_DECODE, VERIFY_LLAMA, VERIFY_GEMMA_SLIDING, VERIFY_GEMMA_GLOBAL, EP_DECODE, EP_PREFILL,
              KH_DECODE, KH_PREFILL}
CONTROLLED |= {INT8 + n for n in CONTROLLED} | set(PP_CASES.values()) | {PP_EP_DECODE, PP_EP_PREFILL}
CONTROLLED |= {DP_SP_DECODE, PP_SP_DECODE, VERIFY_PP_LLAMA}
# D = 256 with q x 20: scores of std ~27 before the cap, so most keys that
# carry a row's softmax sit where tanh bends (|s| / 50 ~ 0.3-1.5); held to
# TOL_CAPPED
GEMMA_CAPPED = "d256_capped_scores_q20_bf16"
CAPPED = {GEMMA_CAPPED, INT8 + GEMMA_CAPPED}

DECODE_CASES = [
    # name, kwargs
    ("ragged+empty_row_bf16_d64", dict(B=4, NH=32, KH=8, D=64, page=16, maxp=8, L=1,
                                        lens=[5, 0, 77, 128], dtype="bfloat16")),
    ("burst_c8_ragged_layer2_bf16", dict(B=5, NH=32, KH=8, D=64, page=64, maxp=4, L=3, layer=2,
                                         lens=[9, 70, 200, 256, 1], C=8, cur_lens=[8, 3, 5, 8, 1],
                                         dtype="bfloat16")),
    ("window+softcap_f32_d128", dict(B=3, NH=8, KH=2, D=128, page=16, maxp=6, L=2, layer=1,
                                     lens=[5, 50, 96], C=1, cur_lens=[1, 1, 1], window=20,
                                     softcap=30.0, dtype="float32")),
    ("burst_f32_d64", dict(B=3, NH=12, KH=4, D=64, page=8, maxp=6, L=1, lens=[3, 24, 48], C=8,
                           cur_lens=[2, 8, 6], dtype="float32")),
    ("gqa1_bf16_d128", dict(B=2, NH=4, KH=4, D=128, page=32, maxp=3, L=1, lens=[31, 96],
                            dtype="bfloat16")),
    ("nan_stale_slots_bf16", dict(B=3, NH=32, KH=8, D=64, page=16, maxp=6, L=2, layer=1,
                                  lens=[20, 41, 90], C=8, cur_lens=[4, 8, 1], poison=True,
                                  dtype="bfloat16")),
    # the split-KV edges (split_plan: about 264 blocks of (split, KV head,
    # row)): ragged rows of 0, under one tile and ~5,000 slots, so most
    # splits of the short rows are empty
    ("splits_ragged_0_40_5000_nan_bf16", dict(B=3, NH=32, KH=8, D=64, page=16, maxp=320, L=1,
                                              lens=[0, 40, 5000], poison=True, dtype="bfloat16")),
    # a window whose first visible slot lies thousands of slots in (the
    # shares start there), with softcap
    ("splits_deep_window+softcap_bf16", dict(B=2, NH=32, KH=8, D=64, page=16, maxp=188, L=1,
                                             lens=[3000, 700], C=1, cur_lens=[1, 1], window=256,
                                             softcap=30.0, dtype="bfloat16")),
    ("splits_window+softcap_f32_d128", dict(B=2, NH=8, KH=2, D=128, page=16, maxp=130, L=1,
                                            lens=[2050, 900], C=2, cur_lens=[2, 1], window=700,
                                            softcap=30.0, dtype="float32")),
    # the burst window (cur_len < C) on rows whose last split, which folds
    # it, has no pool slot
    ("splits_burst_last_split_empty_nan_bf16", dict(B=3, NH=32, KH=8, D=64, page=64, maxp=24, L=2, layer=1,
                                                    lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                    poison=True, dtype="bfloat16")),
    ("splits_g1_d128_bf16", dict(B=2, NH=4, KH=4, D=128, page=32, maxp=63, L=1, lens=[2000, 77], C=4,
                                 cur_lens=[2, 4], dtype="bfloat16")),
    ("splits_g8_bf16", dict(B=2, NH=32, KH=4, D=64, page=16, maxp=113, L=1, lens=[1800, 333], C=8,
                            cur_lens=[8, 1], dtype="bfloat16")),
    ("splits_page48_nan_bf16", dict(B=2, NH=32, KH=8, D=64, page=48, maxp=47, L=1, lens=[1000, 2222], C=8,
                                    cur_lens=[8, 6], poison=True, dtype="bfloat16")),
    # the small-batch timing shapes: one row at 8,192 and 2,048, eight rows
    # at 1,024 (the step profile's rows), each with a full 8-entry window
    (DECODE_B1_8K, dict(seed=10, B=1, NH=32, KH=8, D=64, page=64, maxp=129, L=1, lens=[8192], C=8,
                        cur_lens=[8], dtype="bfloat16")),
    (DECODE_B1_2K, dict(seed=11, B=1, NH=32, KH=8, D=64, page=64, maxp=33, L=1, lens=[2048], C=8,
                        cur_lens=[8], dtype="bfloat16")),
    (DECODE_B8_1K, dict(seed=12, B=8, NH=32, KH=8, D=64, page=64, maxp=17, L=1, lens=[1024] * 8, C=8,
                        cur_lens=[8] * 8, dtype="bfloat16")),
    # the timing phase's inputs: a decode burst step of the served model
    (MAIN_DECODE, dict(seed=7, B=32, NH=32, KH=8, D=64, page=64, maxp=16, L=1, lens=[1024] * 32, C=8,
                       cur_lens=[8] * 32, dtype="bfloat16")),
    # D = 256 (gemma-2-2b's heads): ragged rows with a burst window in a
    # stacked pool, the 4,096 window biting on the long rows
    ("d256_ragged_burst_layer2_window_bf16", dict(GEMMA, B=5, page=64, maxp=72, L=3, layer=2,
                                                  lens=[9, 700, 4500, 4097, 1], C=8, cur_lens=[8, 3, 5, 8, 1],
                                                  window=GEMMA_WINDOW, dtype="bfloat16")),
    ("d256_ragged_window_f32", dict(GEMMA, B=3, page=16, maxp=290, L=2, layer=1, lens=[4500, 50, 4097], C=2,
                                    cur_lens=[2, 1, 1], window=GEMMA_WINDOW, dtype="float32")),
    ("d256_empty_row_global_bf16", dict(GEMMA, B=3, page=16, maxp=8, L=1, lens=[77, 0, 128], dtype="bfloat16")),
    ("d256_nan_stale_slots_bf16", dict(GEMMA, B=3, page=16, maxp=10, L=2, layer=1, lens=[20, 41, 90], C=8,
                                       cur_lens=[4, 8, 1], poison=True, dtype="bfloat16")),
    ("d256_nan_stale_slots_f32", dict(GEMMA, B=2, page=16, maxp=6, L=1, lens=[33, 70], C=4, cur_lens=[4, 2],
                                      poison=True, dtype="float32")),
    # the split edges at D = 256: one row at 8,192 behind the window (the
    # shares start 4,096 slots in), and the burst on a row whose last split
    # is empty
    (GEMMA_DECODE_B1_8K_SLIDING, dict(GEMMA, seed=13, B=1, page=64, maxp=129, L=1, lens=[8192], C=8, cur_lens=[8],
                                      window=GEMMA_WINDOW, dtype="bfloat16")),
    (GEMMA_DECODE_B1_8K_GLOBAL, dict(GEMMA, seed=13, B=1, page=64, maxp=129, L=1, lens=[8192], C=8, cur_lens=[8],
                                     dtype="bfloat16")),
    ("d256_splits_burst_last_split_empty_nan_bf16", dict(GEMMA, B=3, page=64, maxp=24, L=2, layer=1,
                                                         lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                         poison=True, dtype="bfloat16")),
    (GEMMA_CAPPED, dict(GEMMA, B=3, page=64, maxp=24, L=1, lens=[1500, 600, 1400], C=8, cur_lens=[8, 3, 5],
                        q_scale=20.0, dtype="bfloat16")),
    # the timing phase's inputs: a decode burst step of gemma-2-2b
    (GEMMA_DECODE, dict(GEMMA, seed=14, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8, cur_lens=[8] * 32,
                        window=GEMMA_WINDOW, dtype="bfloat16")),
    # qwen2.5-7b's heads: the burst on a row whose last split is empty, with
    # NaN past each row's history; f32; one row at 8,192; and the timing
    # phase's decode burst step
    ("qwen_splits_burst_last_split_empty_nan_bf16", dict(QWEN, B=3, page=64, maxp=24, L=2, layer=1,
                                                         lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                         poison=True, dtype="bfloat16")),
    ("qwen_ragged_f32", dict(QWEN, B=2, page=16, maxp=20, L=1, lens=[300, 77], C=2, cur_lens=[2, 1],
                             dtype="float32")),
    (QWEN_DECODE_B1_8K, dict(QWEN, seed=17, B=1, page=64, maxp=129, L=1, lens=[8192], C=8, cur_lens=[8],
                             dtype="bfloat16")),
    (QWEN_DECODE, dict(QWEN, seed=18, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8, cur_lens=[8] * 32,
                       dtype="bfloat16")),
    # opt-125m's heads: ragged rows with an empty one in a stacked pool, and
    # the serve batch (8 rows at 1,024)
    ("opt_g1_ragged_empty_row_layer1_bf16", dict(OPT, B=4, page=64, maxp=8, L=2, layer=1, lens=[0, 9, 300, 512],
                                                 C=8, cur_lens=[0, 8, 3, 8], dtype="bfloat16")),
    (OPT_DECODE, dict(OPT, seed=19, B=8, page=64, maxp=17, L=1, lens=[1024] * 8, C=8, cur_lens=[8] * 8,
                      dtype="bfloat16")),
    # mixtral-8x7b's heads: the burst on a row whose last split is empty,
    # with NaN past each row's history, in a stacked pool; f32; and the
    # timing phase's decode burst step
    ("mixtral_splits_burst_last_split_empty_nan_bf16", dict(MIXTRAL, B=3, page=64, maxp=24, L=2, layer=1,
                                                            lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                            poison=True, dtype="bfloat16")),
    ("mixtral_ragged_empty_row_f32", dict(MIXTRAL, B=3, page=16, maxp=20, L=1, lens=[300, 0, 77], C=2,
                                          cur_lens=[2, 0, 1], dtype="float32")),
    (MIXTRAL_DECODE, dict(MIXTRAL, seed=22, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8,
                          cur_lens=[8] * 32, dtype="bfloat16")),
    # the tp ranks' heads: a tp = 2 rank's decode burst step of the served
    # models (the timing phase's inputs); at every rank shape ragged rows,
    # the burst on rows whose last split is empty and NaN past each row's
    # history; f32 (the f32 copy's tp run)
    (TP_DECODE, dict(TP_LLAMA, seed=24, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8, cur_lens=[8] * 32,
                     dtype="bfloat16")),
    (TP_QWEN_DECODE, dict(TP_QWEN, seed=25, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8,
                          cur_lens=[8] * 32, dtype="bfloat16")),
    ("tp2_llama_splits_burst_last_split_empty_nan_bf16", dict(TP_LLAMA, B=3, page=64, maxp=24, L=2, layer=1,
                                                              lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                              poison=True, dtype="bfloat16")),
    ("tp4_llama_splits_burst_last_split_empty_nan_bf16", dict(TP4_LLAMA, B=3, page=64, maxp=24, L=2, layer=1,
                                                              lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                              poison=True, dtype="bfloat16")),
    ("tp2_qwen_splits_burst_last_split_empty_nan_bf16", dict(TP_QWEN, B=3, page=64, maxp=24, L=2, layer=1,
                                                             lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                             poison=True, dtype="bfloat16")),
    ("tp2_gemma_ragged_burst_window_bf16", dict(TP_GEMMA, B=4, page=64, maxp=72, L=2, layer=1,
                                                lens=[9, 700, 4500, 4097], C=8, cur_lens=[8, 3, 5, 8],
                                                window=GEMMA_WINDOW, dtype="bfloat16")),
    ("tp2_opt_ragged_empty_row_bf16", dict(TP_OPT, B=4, page=64, maxp=8, L=2, layer=1, lens=[0, 9, 300, 512], C=8,
                                           cur_lens=[0, 8, 3, 8], dtype="bfloat16")),
    ("tp2_llama_ragged_f32", dict(TP_LLAMA, B=2, page=16, maxp=20, L=1, lens=[300, 77], C=2, cur_lens=[2, 1],
                                  dtype="float32")),
    # the dp ranks' rows: a dp 2 rank's burst step (the timing phase's
    # inputs) and, at dp 2 x tp 2, ragged rows with an empty one, the burst
    # on rows whose last split is empty and NaN past each row's history
    (DP_DECODE, dict(DP_LLAMA, seed=28, B=16, page=64, maxp=16, L=1, lens=[1024] * 16, C=8, cur_lens=[8] * 16,
                     dtype="bfloat16")),
    (DP_MIXTRAL_DECODE, dict(DP_MIXTRAL, seed=35, B=16, page=64, maxp=16, L=1, lens=[1024] * 16, C=8,
                             cur_lens=[8] * 16, dtype="bfloat16")),
    ("dp2tp2_llama_ragged_burst_nan_bf16", dict(DP_TP_LLAMA, B=4, page=64, maxp=24, L=2, layer=1,
                                                lens=[0, 30, 1500, 900], C=8, cur_lens=[0, 3, 5, 8], poison=True,
                                                dtype="bfloat16")),
    # mixtral-8x7b's ep 2 x tp 2 rank heads: the burst step (the timing
    # phase's inputs) and ragged rows with an empty one, the burst on rows
    # whose last split is empty and NaN past each row's history
    (EP_DECODE, dict(EP_MIXTRAL, seed=33, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8, cur_lens=[8] * 32,
                     dtype="bfloat16")),
    ("ep2tp2_mixtral_ragged_burst_nan_bf16", dict(EP_MIXTRAL, B=4, page=64, maxp=24, L=2, layer=1,
                                                  lens=[0, 30, 1500, 900], C=8, cur_lens=[0, 3, 5, 8], poison=True,
                                                  dtype="bfloat16")),
    # Qwen2.5-1.5B's tp 4 rank (3 query heads on a shared KV head): the
    # burst step (the timing phase's inputs) and ragged rows with an empty
    # one, the burst on rows whose last split is empty and NaN past each
    # row's history
    (KH_DECODE, dict(KH_QWEN15, seed=42, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8, cur_lens=[8] * 32,
                     dtype="bfloat16")),
    ("tp4kh2_qwen15_ragged_burst_nan_bf16", dict(KH_QWEN15, B=4, page=64, maxp=24, L=2, layer=1,
                                                 lens=[0, 30, 1500, 900], C=8, cur_lens=[0, 3, 5, 8], poison=True,
                                                 dtype="bfloat16")),
]
DECODE_CASES += [(INT8 + name, dict(kw, quant=True)) for name, kw in DECODE_CASES]
# the pipeline stages' decode (bf16 pools only: int8 pools are refused at
# pp): one microbatch of a 32-row step on a stage's pool (the timing
# phase's inputs), and ragged rows with an empty one on the stage's last
# layer with NaN past each row's history
DECODE_CASES += [
    (PP_DECODE, dict(PP_LLAMA, seed=36, B=8, page=64, maxp=16, L=8, layer=5, lens=[1024] * 8, C=1,
                     cur_lens=[1] * 8, dtype="bfloat16")),
    (PP_TP_DECODE, dict(PP_TP_LLAMA, seed=37, B=8, page=64, maxp=16, L=8, layer=5, lens=[1024] * 8, C=1,
                        cur_lens=[1] * 8, dtype="bfloat16")),
    ("pp2tp2_llama_ragged_stage_last_layer_nan_bf16", dict(PP_TP_LLAMA, B=4, page=64, maxp=24, L=8, layer=7,
                                                           lens=[0, 30, 1500, 900], C=1, cur_lens=[0, 1, 1, 1],
                                                           poison=True, dtype="bfloat16")),
    # mixtral-8x7b's pp 2 x ep 2 stage rank, the same two shapes
    (PP_EP_DECODE, dict(PP_EP_MIXTRAL, seed=43, B=8, page=64, maxp=16, L=2, layer=1, lens=[1024] * 8, C=1,
                        cur_lens=[1] * 8, dtype="bfloat16")),
    ("pp2ep2_mixtral_ragged_stage_last_layer_nan_bf16", dict(PP_EP_MIXTRAL, B=4, page=64, maxp=24, L=2, layer=1,
                                                             lens=[0, 30, 1500, 900], C=1, cur_lens=[0, 1, 1, 1],
                                                             poison=True, dtype="bfloat16")),
]
# the sequence ranks' decode (bf16 pools only: int8 pools are refused at
# sp): the long prompt's last decode step (the timing phase's inputs), and
# ragged burst rows with an empty one and NaN past each row's history
DECODE_CASES += [
    (SP_DECODE, dict(SP_LLAMA, seed=40, B=1, page=64, maxp=129, L=16, layer=11, lens=[8223], C=8, cur_lens=[8],
                     dtype="bfloat16")),
    (SP_TP_DECODE, dict(SP_TP_LLAMA, seed=41, B=1, page=64, maxp=129, L=16, layer=11, lens=[8223], C=8,
                        cur_lens=[8], dtype="bfloat16")),
    ("sp2tp2_llama_ragged_burst_nan_bf16", dict(SP_TP_LLAMA, B=4, page=64, maxp=24, L=2, layer=1,
                                                lens=[0, 30, 1500, 900], C=8, cur_lens=[0, 3, 5, 8], poison=True,
                                                dtype="bfloat16")),
    # mixtral-8x7b's sp 2 x ep 2 sequence rank: the long prompt's last step
    (SP_EP_DECODE, dict(SP_EP_MIXTRAL, seed=44, B=1, page=64, maxp=65, L=4, layer=3, lens=[4104], C=8,
                        cur_lens=[8], dtype="bfloat16")),
    # sequence ranks beside dp and pp ranks: a dp 2 x sp 2 rank's burst step
    # and a pp 2 x sp 2 stage rank's microbatch (the timing phase's inputs),
    # and ragged rows with an empty one and NaN past each row's history on
    # each mapping's last layer
    (DP_SP_DECODE, dict(DP_SP_LLAMA, seed=47, B=16, page=64, maxp=16, L=2, layer=1, lens=[1024] * 16, C=8,
                        cur_lens=[8] * 16, dtype="bfloat16")),
    ("dp2sp2_llama_ragged_burst_nan_bf16", dict(DP_SP_LLAMA, B=4, page=64, maxp=24, L=2, layer=1,
                                                lens=[0, 30, 1500, 900], C=8, cur_lens=[0, 3, 5, 8], poison=True,
                                                dtype="bfloat16")),
    (PP_SP_DECODE, dict(PP_SP_LLAMA, seed=48, B=8, page=64, maxp=16, L=1, layer=0, lens=[1024] * 8, C=1,
                        cur_lens=[1] * 8, dtype="bfloat16")),
    ("pp2sp2_llama_ragged_stage_layer_nan_bf16", dict(PP_SP_LLAMA, B=4, page=64, maxp=24, L=1, layer=0,
                                                           lens=[0, 30, 1500, 900], C=1, cur_lens=[0, 1, 1, 1],
                                                           poison=True, dtype="bfloat16")),
]

PREFILL_CASES = [
    ("history+unaligned+tail_bf16", dict(B=3, T=64, NH=32, KH=8, D=64, page=16, maxp=10, L=2, layer=1,
                                         computed=[37, 64, 5], chunks=[64, 59, 51], dtype="bfloat16")),
    ("first_chunk+padded_row_bf16", dict(B=3, T=48, NH=32, KH=8, D=64, page=64, maxp=2, L=1,
                                         computed=[0, 0, 0], chunks=[48, 17, 0], dtype="bfloat16")),
    ("window+softcap_f32_d128", dict(B=2, T=32, NH=8, KH=2, D=128, page=8, maxp=16, L=1,
                                     computed=[40, 64], chunks=[32, 28], window=20, softcap=30.0,
                                     dtype="float32")),
    ("window+softcap_bf16_d128_g2", dict(B=2, T=40, NH=8, KH=4, D=128, page=16, maxp=8, L=1,
                                         computed=[30, 7], chunks=[40, 33], window=25, softcap=20.0,
                                         dtype="bfloat16")),
    ("history_f32_d64", dict(B=2, T=80, NH=12, KH=4, D=64, page=16, maxp=12, L=3, layer=2,
                             computed=[100, 13], chunks=[80, 77], dtype="float32")),
    ("nan_stale_slots_bf16", dict(B=2, T=32, NH=32, KH=8, D=64, page=16, maxp=8, L=1,
                                  computed=[24, 8], chunks=[32, 20], poison=True, dtype="bfloat16")),
    # the bf16 kernel's tile edges: a warpgroup holds 64 // G tokens x G heads
    ("g1_d128_bf16", dict(B=2, T=150, NH=4, KH=4, D=128, page=16, maxp=16, L=1,
                          computed=[70, 3], chunks=[150, 131], dtype="bfloat16")),
    ("g7_d128_nan_stale_slots_bf16", dict(B=2, T=50, NH=28, KH=4, D=128, page=16, maxp=8, L=1,
                                          computed=[45, 16], chunks=[50, 37], poison=True, dtype="bfloat16")),
    ("g8_bf16", dict(B=2, T=40, NH=32, KH=4, D=64, page=16, maxp=8, L=1,
                     computed=[20, 0], chunks=[40, 33], dtype="bfloat16")),
    ("chunk_not_multiple_of_tpw_bf16", dict(B=2, T=80, NH=32, KH=8, D=64, page=64, maxp=4, L=1,
                                            computed=[100, 64], chunks=[77, 45], dtype="bfloat16")),
    ("window_unaligned_first_slot_bf16", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=16, L=1,
                                              computed=[150, 99], chunks=[64, 50], window=45,
                                              dtype="bfloat16")),
    # page sizes the kernel looks up by division: 48 slots (history not
    # page-aligned, so 64-key tiles span pages), and 8,300 tokens of
    # history over 1,038 pages of 8
    ("page48_unaligned_history_bf16", dict(B=2, T=96, NH=32, KH=8, D=64, page=48, maxp=8, L=1,
                                           computed=[101, 29], chunks=[96, 70], dtype="bfloat16")),
    ("long_history_page8_bf16", dict(B=1, T=64, NH=32, KH=8, D=64, page=8, maxp=1048, L=1,
                                     computed=[8300], chunks=[64], dtype="bfloat16")),
    # the step profile's multi-row chunk: 8 rows of 512 tokens after 512
    ("multi_row_b8_t512_h512_bf16", dict(seed=9, B=8, T=512, NH=32, KH=8, D=64, page=64, maxp=16, L=1,
                                         computed=[512] * 8, chunks=[512] * 8, dtype="bfloat16")),
    # the timing phase's inputs: a 512-token chunk after 1,536 tokens
    (MAIN_PREFILL, dict(seed=8, B=1, T=512, NH=32, KH=8, D=64, page=64, maxp=32, L=1,
                        computed=[1536], chunks=[512], dtype="bfloat16")),
    # D = 256 (32-key tiles, Q read by wgmma from shared memory)
    ("d256_history_unaligned_layer1_bf16", dict(GEMMA, B=3, T=64, page=16, maxp=10, L=2, layer=1,
                                                computed=[37, 64, 5], chunks=[64, 59, 51], dtype="bfloat16")),
    ("d256_first_chunk+padded_row_bf16", dict(GEMMA, B=3, T=48, page=64, maxp=2, L=1, computed=[0, 0, 0],
                                              chunks=[48, 17, 0], dtype="bfloat16")),
    ("d256_window_bites_bf16", dict(GEMMA, B=2, T=96, page=64, maxp=72, L=1, computed=[4200, 30],
                                    chunks=[96, 70], window=GEMMA_WINDOW, dtype="bfloat16")),
    ("d256_window_bites_f32", dict(GEMMA, B=2, T=48, page=16, maxp=266, L=1, computed=[4150, 20],
                                   chunks=[48, 33], window=GEMMA_WINDOW, dtype="float32")),
    ("d256_nan_stale_slots_bf16", dict(GEMMA, B=2, T=32, page=16, maxp=8, L=1, computed=[24, 8],
                                       chunks=[32, 20], poison=True, dtype="bfloat16")),
    ("d256_nan_stale_slots_f32", dict(GEMMA, B=2, T=40, page=16, maxp=8, L=2, layer=1, computed=[30, 3],
                                      chunks=[40, 29], poison=True, dtype="float32")),
    ("d256_page48_unaligned_history_bf16", dict(GEMMA, B=2, T=96, page=48, maxp=8, L=1, computed=[101, 29],
                                                chunks=[96, 70], dtype="bfloat16")),
    (GEMMA_CAPPED, dict(GEMMA, B=2, T=64, page=64, maxp=24, L=1, computed=[1400, 300], chunks=[64, 50],
                        q_scale=20.0, dtype="bfloat16")),
    # the forward phase's chunk where the sliding window starts to bite
    ("d256_t512_h4096_window_bf16", dict(GEMMA, seed=15, B=1, T=512, page=64, maxp=72, L=1, computed=[4096],
                                         chunks=[512], window=GEMMA_WINDOW, dtype="bfloat16")),
    # the timing phase's inputs: gemma-2-2b's 512-token chunk after 1,536
    (GEMMA_PREFILL, dict(GEMMA, seed=16, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                         window=GEMMA_WINDOW, dtype="bfloat16")),
    # qwen2.5-7b's heads: ragged rows (one padded) in a stacked pool with
    # NaN past each chunk start; f32; the timing phase's 512 after 1,536
    ("qwen_ragged_padded_row_layer1_nan_bf16", dict(QWEN, B=3, T=96, page=16, maxp=16, L=2, layer=1,
                                                    computed=[100, 0, 37], chunks=[96, 61, 0], poison=True,
                                                    dtype="bfloat16")),
    ("qwen_history_f32", dict(QWEN, B=2, T=40, page=16, maxp=8, L=1, computed=[30, 3], chunks=[40, 29],
                              dtype="float32")),
    (QWEN_PREFILL, dict(QWEN, seed=20, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                        dtype="bfloat16")),
    # opt-125m's heads: a 3-token chunk (the JAX OPT takes its XLA path
    # below 16 tokens; the port takes this kernel for every chunk), and a
    # 512-token chunk after 1,536
    ("opt_g1_t3_chunk_bf16", dict(OPT, B=2, T=3, page=16, maxp=4, L=1, computed=[20, 0], chunks=[3, 2],
                                  dtype="bfloat16")),
    (OPT_PREFILL, dict(OPT, seed=21, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                       dtype="bfloat16")),
    # mixtral-8x7b's heads: ragged rows (one padded, one chunk not a
    # multiple of a tile's 16 tokens) in a stacked pool with NaN past each
    # chunk start; f32; the timing phase's 512 after 1,536
    ("mixtral_ragged_padded_row_layer1_nan_bf16", dict(MIXTRAL, B=3, T=96, page=16, maxp=16, L=2, layer=1,
                                                       computed=[100, 0, 37], chunks=[93, 61, 0], poison=True,
                                                       dtype="bfloat16")),
    ("mixtral_history_f32", dict(MIXTRAL, B=2, T=40, page=16, maxp=8, L=1, computed=[30, 3], chunks=[40, 29],
                                 dtype="float32")),
    (MIXTRAL_PREFILL, dict(MIXTRAL, seed=23, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                           dtype="bfloat16")),
    # the tp ranks' heads: a tp = 2 rank's 512-token chunk after 1,536 (the
    # timing phase's inputs); ragged rows (one padded) in a stacked pool with
    # NaN past each chunk start; gemma-2-2b's window; opt-125m's 3-token
    # chunk; f32
    (TP_PREFILL, dict(TP_LLAMA, seed=26, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                      dtype="bfloat16")),
    (TP_QWEN_PREFILL, dict(TP_QWEN, seed=27, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                           dtype="bfloat16")),
    ("tp4_llama_ragged_padded_row_layer1_nan_bf16", dict(TP4_LLAMA, B=3, T=96, page=16, maxp=16, L=2, layer=1,
                                                         computed=[100, 0, 37], chunks=[96, 61, 0], poison=True,
                                                         dtype="bfloat16")),
    ("tp2_qwen_ragged_padded_row_layer1_nan_bf16", dict(TP_QWEN, B=3, T=96, page=16, maxp=16, L=2, layer=1,
                                                        computed=[100, 0, 37], chunks=[96, 61, 0], poison=True,
                                                        dtype="bfloat16")),
    ("tp2_gemma_window_bites_bf16", dict(TP_GEMMA, B=2, T=96, page=64, maxp=72, L=1, computed=[4200, 30],
                                         chunks=[96, 70], window=GEMMA_WINDOW, dtype="bfloat16")),
    ("tp2_opt_t3_chunk_bf16", dict(TP_OPT, B=2, T=3, page=16, maxp=4, L=1, computed=[20, 0], chunks=[3, 2],
                                   dtype="bfloat16")),
    ("tp2_llama_history_f32", dict(TP_LLAMA, B=2, T=40, page=16, maxp=8, L=1, computed=[30, 3], chunks=[40, 29],
                                   dtype="float32")),
    # a dp 2 rank's chunk of the dp_forward phase (two rows of 512 after
    # 512), and at dp 2 x tp 2 a padded row beside a ragged one
    ("dp2_llama_b2_t512_h512_bf16", dict(DP_LLAMA, seed=29, B=2, T=512, page=64, maxp=16, L=1, computed=[512, 512],
                                         chunks=[512, 512], dtype="bfloat16")),
    ("dp2tp2_llama_padded_row_nan_bf16", dict(DP_TP_LLAMA, B=2, T=96, page=16, maxp=16, L=2, layer=1,
                                              computed=[0, 100], chunks=[0, 96], poison=True, dtype="bfloat16")),
    # mixtral-8x7b's ep 2 x tp 2 rank heads: the timing phase's 512 after
    # 1,536, and ragged rows (one padded) in a stacked pool with NaN past
    # each chunk start
    (EP_PREFILL, dict(EP_MIXTRAL, seed=34, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                      dtype="bfloat16")),
    ("ep2tp2_mixtral_ragged_padded_row_layer1_nan_bf16", dict(EP_MIXTRAL, B=3, T=96, page=16, maxp=16, L=2, layer=1,
                                                              computed=[100, 0, 37], chunks=[96, 61, 0],
                                                              poison=True, dtype="bfloat16")),
    # Qwen2.5-1.5B's tp 4 rank: the timing phase's 512 after 1,536 (21
    # tokens x 3 heads, one padding row, in each 64-row warpgroup), and
    # ragged rows (one padded) with NaN past each chunk start
    (KH_PREFILL, dict(KH_QWEN15, seed=45, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                      dtype="bfloat16")),
    ("tp4kh2_qwen15_ragged_padded_row_layer1_nan_bf16", dict(KH_QWEN15, B=3, T=96, page=16, maxp=16, L=2, layer=1,
                                                             computed=[100, 0, 37], chunks=[96, 61, 0],
                                                             poison=True, dtype="bfloat16")),
]
PREFILL_CASES += [(INT8 + name, dict(kw, quant=True)) for name, kw in PREFILL_CASES]
# the pipeline stages' prefill on a stage's pool (bf16 only, as the decode
# above): the timing phase's 512 after 1,536, and ragged rows (one padded)
# on the stage's last layer with NaN past each chunk start
PREFILL_CASES += [
    (PP_PREFILL, dict(PP_LLAMA, seed=38, B=1, T=512, page=64, maxp=32, L=8, layer=3, computed=[1536],
                      chunks=[512], dtype="bfloat16")),
    (PP_TP_PREFILL, dict(PP_TP_LLAMA, seed=39, B=1, T=512, page=64, maxp=32, L=8, layer=3, computed=[1536],
                         chunks=[512], dtype="bfloat16")),
    ("pp2tp2_llama_ragged_padded_row_stage_last_layer_nan_bf16", dict(PP_TP_LLAMA, B=3, T=96, page=16, maxp=16, L=8,
                                                                      layer=7, computed=[100, 0, 37],
                                                                      chunks=[96, 61, 0], poison=True,
                                                                      dtype="bfloat16")),
    (PP_EP_PREFILL, dict(PP_EP_MIXTRAL, seed=46, B=1, T=512, page=64, maxp=32, L=2, layer=1, computed=[1536],
                         chunks=[512], dtype="bfloat16")),
]
# the verify shapes (bf16 pools only: speculative decoding refuses int8);
# ``row`` names the table row the llama case's error goes to
PREFILL_CASES += [
    (VERIFY_LLAMA, dict(seed=30, row=VERIFY_ROW, B=32, T=1 + VERIFY_K, NH=32, KH=8, D=64, page=64, maxp=17, L=1,
                        computed=[1024] * 32, chunks=[1 + VERIFY_K] * 32, dtype="bfloat16")),
    (VERIFY_GEMMA_SLIDING, dict(GEMMA, seed=31, B=8, T=1 + VERIFY_K, page=64, maxp=65, L=1, computed=[4096] * 8,
                                chunks=[1 + VERIFY_K] * 8, window=GEMMA_WINDOW, dtype="bfloat16")),
    (VERIFY_GEMMA_GLOBAL, dict(GEMMA, seed=32, B=8, T=1 + VERIFY_K, page=64, maxp=65, L=1, computed=[4096] * 8,
                               chunks=[1 + VERIFY_K] * 8, dtype="bfloat16")),
    # the verify forward on a pipeline stage: an 8-row microbatch on the
    # stage's 1-layer pool (the timing phase's inputs), and ragged rows, one
    # inactive, on a 2-layer stage pool's first layer (pp 2 of a deeper
    # model) with NaN past each row's history
    (VERIFY_PP_LLAMA, dict(seed=49, row=VERIFY_PP_ROW, B=8, T=1 + VERIFY_K, NH=32, KH=8, D=64, page=64, maxp=17,
                           L=1, layer=0, computed=[1024] * 8, chunks=[1 + VERIFY_K] * 8, dtype="bfloat16")),
    ("verify_pp2_llama_ragged_inactive_row_stage_nan_bf16",
     dict(row=VERIFY_PP_ROW, B=4, T=1 + VERIFY_K, NH=32, KH=8, D=64, page=16, maxp=8, L=2, layer=0,
          computed=[37, 0, 100, 11], chunks=[1 + VERIFY_K, 0, 1 + VERIFY_K, 1 + VERIFY_K], poison=True,
          dtype="bfloat16")),
]

# the chunk's KV write in the prefill launch, against the writes' plain
# versions alone: each case with bf16 and f32 inputs, fp and int8 pools
WRITE_CASES = [
    ("aligned_chunk", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=1, computed=[32, 0], chunks=[64, 64])),
    ("chunk_ends_mid_page", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=1, computed=[32, 16],
                                 chunks=[50, 37])),
    ("unaligned_head_page_d128", dict(B=2, T=64, NH=8, KH=2, D=128, page=16, maxp=8, L=1, computed=[37, 5],
                                      chunks=[64, 40])),
    ("other_layers_untouched", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=3, layer=1, computed=[21, 0],
                                    chunks=[60, 33])),
]
# the same four cases at gemma-2-2b's KV heads (KH = 4, D = 256)
WRITE_CASES += [("d256_" + name.replace("_d128", ""), dict(kw, NH=8, KH=4, D=256)) for name, kw in WRITE_CASES]
# the write's partition over the launch's blocks (fp: each block its own
# tokens; int8: row b's page tasks to the lowest x-blocks first): opt-125m's
# G = 1 with a 3-token chunk over two pages (one x-block), qwen2.5-7b's G = 7
# with a chunk ending mid-page beside a padded row, G = 8 with unaligned head
# pages, gemma-2-2b's heads with a padded row, and pages of 128
WRITE_CASES += [
    ("g1_t3_two_pages", dict(OPT, B=2, T=3, page=16, maxp=4, L=1, computed=[15, 0], chunks=[3, 2])),
    ("g7_d128_mid_page_padded_row_layer1", dict(QWEN, B=2, T=96, page=16, maxp=16, L=2, layer=1, computed=[37, 0],
                                                chunks=[90, 0])),
    ("g8_unaligned_head_pages", dict(B=2, T=40, NH=32, KH=4, D=64, page=16, maxp=8, L=1, computed=[21, 5],
                                     chunks=[40, 33])),
    ("d256_padded_row", dict(GEMMA, B=2, T=48, page=16, maxp=6, L=1, computed=[13, 0], chunks=[48, 0])),
    # pages of 128 slots: the f32 kernel stages an int8 page task in two
    # slabs of 64
    ("page128_slabs", dict(B=2, T=40, NH=32, KH=8, D=64, page=128, maxp=2, L=1, computed=[100, 0],
                           chunks=[40, 33])),
]


def _kernel_name(base: str, quant: bool, D: int = 64, tp: int = 1, dp: int = 1, ep: int = 1, pp: int = 1,
                 sp: int = 1, kh: "int | None" = None) -> str:
    name = _dtag(base + "[int8]" if quant else base, D)
    if sp > 1:
        return _sptag(name, sp, tp, ep, dp, pp)
    if pp > 1:
        return _pptag(name, pp, tp, ep)
    return _dptag(_eptag(name, ep, tp) if ep > 1 else _tptag(name, tp, kh), dp)


def _clone_pools(args, kw):
    """Copies of a case's pools (and scales): (kp, vp, scales kwargs)."""
    skw = {k: kw[k].clone() for k in ("k_scales", "v_scales") if k in kw}
    return args[1].clone(), args[2].clone(), skw


def phase_kernels():
    import torch

    from production_stack_tpu_torch.ops.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
        decode_attention_sharded,
        split_plan,
    )
    from production_stack_tpu_torch.ops.kernels.prefill_attention import (
        kv_page_write_quant_ref,
        kv_page_write_ref,
        prefill_attention,
        prefill_attention_ref,
    )

    # each row's largest error over its cases (the rank shapes with no row
    # of their own, such as llama-3.2-1b at tp 4, under their own names)
    worst = {name: 0.0 for name in REPLACES}

    def judged(kernel, name, out, ref, dtype, control=None, **extra):
        res = _judge(out, ref, dtype, TOL_CAPPED if name in CAPPED else TOL)
        line = {"phase": "kernels", "kernel": kernel, "case": name, **res, **extra}
        if control is not None:
            # the plain version with one history key fewer per row, held to
            # the same bound: the check must reject it
            line["one_key_fewer_ratio_to_bound"] = _judge(control, ref, dtype, TOL)["ratio_to_bound"]
        emit(line)
        check(res["finite"], f"{kernel} {name}: non-finite output")
        check(res["ratio_to_bound"] <= 1.0, f"{kernel} {name}: error {res['max_abs_err']} exceeds its bound "
                                            f"(ratio {res['ratio_to_bound']})")
        if control is not None:
            check(line["one_key_fewer_ratio_to_bound"] > 1.0,
                  f"{kernel} {name}: the bound does not reject a one-key-fewer output")
        worst[kernel] = max(worst.get(kernel, 0.0), res["max_abs_err"])

    def pools_same(a, b, skw_a, skw_b):
        """Byte-identical pools and bitwise-equal scales (NaN bytes too)."""
        return (_same_bytes(a[0], b[0]) and _same_bytes(a[1], b[1])
                and all(_same_bytes(skw_a[k], skw_b[k]) for k in skw_a))

    for name, kw in DECODE_CASES:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
        seed = kw.pop("seed", 1)
        tp, dp, ep, pp = kw.pop("tp", 1), kw.pop("dp", 1), kw.pop("ep", 1), kw.pop("pp", 1)
        sp, kh = kw.pop("sp", 1), kw.pop("kh", None)
        kernel = _kernel_name("decode_attention", kw.get("quant", False), kw["D"], tp, dp, ep, pp, sp, kh)
        args, call_kw = decode_case(seed, **kw)
        if tp > 1 or dp > 1 or ep > 1 or pp > 1 or sp > 1:
            # a (pp, dp, sp, ep, tp) rank's decode, as models/paged_step.py calls it
            kern = lambda *a, **k: decode_attention_sharded(*a, tp=tp, **k)  # noqa: E731
            plain = lambda *a, **k: decode_attention_sharded(*a, tp=tp, plain=True, **k)  # noqa: E731
        else:
            kern, plain = decode_attention, decode_attention_ref
        out = kern(*args, **call_kw)
        again = kern(*args, **call_kw)
        torch.cuda.synchronize()
        check(_same_bytes(out, again), f"decode {name}: two calls on the same inputs gave different bytes")
        ref = plain(*args, **call_kw)
        if kw.get("poison"):
            # the plain version on clean inputs: poisoned slots must be skipped
            clean, clean_kw = decode_case(seed, **dict(kw, poison=False))
            ref = plain(*clean, **clean_kw)
        control = None
        if name in CONTROLLED:
            q, kp, vp, pt, lens = args
            control = decode_attention_ref(q, kp, vp, pt, lens - 1, **call_kw)
        plan = split_plan(kw["B"], kw["KH"], kw["maxp"], kw["page"], kw["D"], kw.get("quant", False))
        judged(kernel, name, out, ref, kw["dtype"], control, splits=plan.splits, byte_identical_rerun=True)
        if 0 in kw["lens"]:
            check(float(out[kw["lens"].index(0)].float().abs().max()) == 0.0, f"decode {name}: empty row not 0")

    def fused_launch(name, kw, seed):
        """One prefill case through the launch that attends and writes, on
        its own copies of the pools: the output against the plain version
        within TOL, pools and scales against the plain write alone (other
        layers untouched), and the attention-only launch on fresh copies
        (pools untouched, the same output bytes)."""
        quant = kw.get("quant", False)
        kw = dict(kw)
        tp, dp, ep, pp = kw.pop("tp", 1), kw.pop("dp", 1), kw.pop("ep", 1), kw.pop("pp", 1)
        kh = kw.pop("kh", None)
        kernel = kw.pop("row", None) or _kernel_name("prefill_attention", quant, kw["D"], tp, dp, ep, pp, kh=kh)
        args, call_kw = prefill_case(seed, **kw)
        q, kp, vp, pt, pos, lens, kc, vc, cl = args
        layer = call_kw["layer"]
        kp_k, vp_k, skw_k = _clone_pools(args, call_kw)
        kp_r, vp_r, skw_r = _clone_pools(args, call_kw)
        out = prefill_attention(q, kp_k, vp_k, pt, pos, lens, kc, vc, cl, fused_write=True, **dict(call_kw, **skw_k))
        torch.cuda.synchronize()
        if quant:
            kv_page_write_quant_ref(kc, vc, lens, cl, pt, kp_r, vp_r, layer=layer, **skw_r)
        else:
            kv_page_write_ref(kc, vc, pos, cl, pt, kp_r, vp_r, layer=layer)
        if kw.get("poison"):  # the plain version on clean inputs: poisoned slots must be skipped
            clean, clean_kw = prefill_case(seed, **dict(kw, poison=False))
            ref = prefill_attention_ref(*clean, **clean_kw)
        else:
            ref = prefill_attention_ref(*args, **call_kw)
        control = None
        if name in CONTROLLED:
            control = prefill_attention_ref(q, kp, vp, pt, pos, lens - 1, kc, vc, cl, **call_kw)
        judged(kernel, name, out, ref, kw["dtype"], control)
        for b, c in enumerate(kw["chunks"]):
            if c == 0:
                check(float(out[b].float().abs().max()) == 0.0, f"prefill {name}: padded row not 0")
        # the write, against its plain version alone
        wkernel = _kernel_name("kv_page_write_quant" if quant else "kv_page_write", False, kw["D"], tp, dp, ep, pp,
                               kh=kh)
        same = pools_same((kp_k, vp_k), (kp_r, vp_r), skw_k, skw_r)
        untouched = all(
            _same_bytes(x[i], y[i]) for i in range(kw["L"]) if i != layer
            for x, y in [(kp_k, kp), (vp_k, vp)] + [(skw_k[k], call_kw[k]) for k in skw_k]
        )
        err = max([_pool_err(kp_k, kp_r), _pool_err(vp_k, vp_r)] + [_pool_err(skw_k[k], skw_r[k]) for k in skw_k])
        # the same launch without the write, on fresh copies
        kp_a, vp_a, skw_a = _clone_pools(args, call_kw)
        alone = prefill_attention(q, kp_a, vp_a, pt, pos, lens, kc, vc, cl, **dict(call_kw, **skw_a))
        torch.cuda.synchronize()
        kept = pools_same((kp_a, vp_a), (kp, vp), skw_a, {k: call_kw[k] for k in skw_a})
        emit({"phase": "kernels", "kernel": wkernel, "case": name, "pools_and_scales_byte_identical": same,
              "other_layers_untouched": untouched, "max_abs_err": err,
              "attention_only_pools_untouched": kept, "attention_only_same_output": _same_bytes(alone, out)})
        check(same and untouched, f"{wkernel} {name}: pools or scales differ from the plain write's, "
                                  f"or other layers changed")
        check(kept and _same_bytes(alone, out), f"prefill {name}: the launch without the write changed the pools "
                                                f"or gave other output bytes")
        worst[wkernel] = max(worst.get(wkernel, 0.0), err)

    for name, kw in PREFILL_CASES:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
        fused_launch(name, kw, kw.pop("seed", 2))

    for name, kw in WRITE_CASES:
        for dtype in ("bfloat16", "float32"):
            for quant in (False, True):
                case = dict(kw, dtype=getattr(torch, dtype), quant=quant)
                fused_launch(f"{INT8 if quant else ''}write_{name}_{dtype}", case, 3)
    return worst


def _forward_run(model, impl, ids, chunk, n_chunks, burst, quant=False, lora=None):
    """``n_chunks`` prefill chunks then one decode burst of ``burst`` steps
    through model.forward with attn_impl ``impl``, into pools of the model's
    dtype or, with ``quant``, int8 pools and their scales (and with ``lora``
    = (buffers, lora_ids) each row's adapter slot). The burst reads
    its input tokens from ``ids`` (teacher forcing), so both implementations
    see the same tokens. Returns the logits [B, V] of every chunk and burst
    step, and the pools (and scales) after the burst's commit."""
    import dataclasses

    import torch

    from production_stack_tpu_torch import models
    from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
    from production_stack_tpu_torch.ops.quant import init_kv_scales, write_kv_pages_all_layers_quant

    cfg = dataclasses.replace(model.cfg, attn_impl=impl, kv_cache_dtype="int8" if quant else "auto")
    model.cfg = cfg
    dev = ids.device
    B, page = ids.shape[0], 64
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    ctx = n_chunks * chunk
    maxp = -(-(ctx + burst) // page)
    kp, vp = models.module_for_config(cfg).init_kv_pages(cfg, B * maxp, page, dev)
    scales = (init_kv_scales(L, B * maxp, KH, dev), init_kv_scales(L, B * maxp, KH, dev)) if quant else None
    pt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp)
    lkw = {} if lora is None else dict(lora=lora[0], lora_ids=lora[1])
    logits = []
    for c in range(n_chunks):
        pos = torch.arange(c * chunk, (c + 1) * chunk, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        lens = torch.full((B,), (c + 1) * chunk, dtype=torch.int32, device=dev)
        lg = model(ids[:, c * chunk:(c + 1) * chunk], pos, kp, vp, pt, lens, kv_scales=scales, **lkw)
        logits.append(lg)
    k_acc = torch.zeros((L, B, burst, KH, D), dtype=cfg.dtype, device=dev)
    v_acc = torch.zeros_like(k_acc)
    counts = torch.zeros((B,), dtype=torch.int32, device=dev)
    for s in range(burst):
        pos = torch.full((B, 1), ctx + s, dtype=torch.int32, device=dev)
        lens = torch.full((B,), ctx + s + 1, dtype=torch.int32, device=dev)
        lg = model(ids[:, ctx + s][:, None], pos, kp, vp, pt, lens, kv_burst=(k_acc, v_acc, counts),
                   kv_scales=scales, **lkw)
        counts = counts + 1
        logits.append(lg)
    jj = torch.arange(burst, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    if quant:
        write_kv_pages_all_layers_quant(kp, vp, *scales, k_acc, v_acc, pt, ctx + jj)
    else:
        write_kv_pages_all_layers(kp, vp, k_acc, v_acc, pt, ctx + jj)
    torch.cuda.synchronize()
    return logits, (kp, vp) + (scales or ())


# the kernel forward's logits vs the plain forward's, in bf16: attention
# outputs differ by bf16 rounding (a last-bit flip after another f32
# summation order) and the layers carry it into logits of order 1, whose
# bf16 ulp is 2^-7 to 2^-5. The int8 pool runs are held to the same bound.
FORWARD_LOGIT_BOUND = 0.25
FORWARD_TOP1_MIN = 0.9
# A MoE router turns those roundings into a different expert now and then
# (where its 2nd and 3rd probabilities all but tie), and that token's
# logits then move by O(1): the plain run takes the experts the kernel run
# took (models/llama.py ``tape_routes``), and the lines count the
# (layer, token) pairs where its own router would have picked otherwise.
# (model, 512-token prefill chunks): llama-3.2-1b at two chunks; gemma-2-2b
# at nine (4,608 tokens), so its even layers' 4,096 window bites;
# qwen2.5-7b, loaded from its HF directory, at two (phase_hf_load)
# gemma-2-2b at full width with its depth cut to GEMMA_LAYERS of 26 (its
# layers alternate sliding and global, so both kinds run), to keep the
# smoke inside its time limit
GEMMA_LAYERS = 8
GEMMA_MODEL = f"gemma-2-2b-l{GEMMA_LAYERS}"
FORWARD_RUNS = (("llama-3.2-1b", 2), (GEMMA_MODEL, 9))
QWEN_FORWARD_CHUNKS = 2


def phase_forward(name: str, n_chunks: int, model=None) -> dict:
    """One model (the preset ``name``, or ``model`` as loaded) with the
    kernels and with the plain versions, first into bf16 pools, then into
    int8 pools, every compared token held to the bound (a MoE model's plain
    run takes the experts its kernel run took). Layer 0's
    K/V come before any attention, so its int8 pages
    and scales must be byte-identical between the two int8 runs (the
    quantizing write in the prefill launch against its plain version,
    inside the model).
    Returns the launch counts of the kernel run into int8 pools (every
    count set to 0 just before it)."""
    import torch

    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.models.llama import tape_routes

    t_load = time.perf_counter()
    if model is None:
        _, _, model = load_model(name, seed=0, device="cuda")
    cfg = model.cfg
    load_s = time.perf_counter() - t_load
    kernels, _ = _counters()
    gen = torch.Generator().manual_seed(3)
    B, chunk, burst = 2, 512, 8
    ids = torch.randint(0, cfg.vocab_size, (B, n_chunks * chunk + burst), generator=gen, dtype=torch.int32).cuda()
    launches = {}
    for quant in (False, True):
        t0 = time.perf_counter()
        with torch.no_grad():
            for fn, attr in kernels.values():
                setattr(fn, attr, 0)
            with tape_routes(model) as routes:
                lk, pools_k = _forward_run(model, "cuda", ids, chunk, n_chunks, burst, quant)
            launches = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
            with tape_routes(model, replay=routes.picks) as replayed:
                lp, pools_p = _forward_run(model, "plain", ids, chunk, n_chunks, burst, quant)
        finite = all(bool(torch.isfinite(x).all()) for x in lk)
        shapes_ok = all(tuple(x.shape) == (B, cfg.vocab_size) for x in lk)
        diffs = [float((a - b).abs().max()) for a, b in zip(lk, lp)]
        top1 = float(torch.cat([a.argmax(-1) == b.argmax(-1) for a, b in zip(lk, lp)]).double().mean())
        pool_diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(pools_k, pools_p))
        line = {
            "phase": "forward", "model": name, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "head_dim": cfg.head_dim, "dtype": "bfloat16", "kv_cache_dtype": "int8" if quant else "auto",
            "rows": B, "chunks": [chunk] * n_chunks, "burst": burst,
            "max_logit_diff_per_step": diffs, "max_logit_diff": max(diffs), "bound": FORWARD_LOGIT_BOUND,
            "top1_agreement": top1, "top1_min": FORWARD_TOP1_MIN, "logit_absmax": float(lk[0].abs().max()),
            "pool_max_abs_diff_after_commit": pool_diff, "finite": finite, "kernel_run_launches": launches,
            "seconds": round(time.perf_counter() - t0 + (0.0 if quant else load_s), 2),
        }
        if routes.picks:
            line.update(routed_calls=len(routes.picks),
                        replayed_tokens=sum(t.numel() // t.shape[-1] for t in routes.picks),
                        plain_router_would_differ=replayed.overridden)
        if quant:
            line["layer0_pages_and_scales_byte_identical"] = all(
                _same_bytes(a[0], b[0]) for a, b in zip(pools_k, pools_p)
            )
        emit(line)
        what = f"forward[{name}{', int8' if quant else ''}]"
        check(finite and shapes_ok, f"{what}: logits not finite or of the wrong shape")
        check(max(diffs) <= FORWARD_LOGIT_BOUND, f"{what}: logit diff {max(diffs)} > {FORWARD_LOGIT_BOUND}")
        check(top1 >= FORWARD_TOP1_MIN, f"{what}: top-1 agreement {top1} < {FORWARD_TOP1_MIN}")
        for k in SERVE_ROWS[quant]:
            check(launches[k] > 0, f"{what}: kernel {k} was not launched")
        if quant:
            check(line["layer0_pages_and_scales_byte_identical"],
                  f"{what}: layer 0's int8 pages or scales differ between the kernel and plain runs")
    del model
    torch.cuda.empty_cache()
    return launches


# batched multi-LoRA on llama-3.2-1b at full width and depth: adapters of
# rank 8 and 16 on all seven targets, in slots 1 and 2, scale alpha / r =
# 1/4: A ~ N(0, 1/in) and B ~ N(0, 1/r) make A @ B the base weight's size,
# so each delta is a quarter of it, and it moves the logits by ~5. Deltas of
# the weights' full size (scale 1) make a network whose bf16 roundings grow
# past the forward bound: kernel against plain 0.34, top-1 0.87 (this phase
# with LORA_SCALE = 1 on an NVIDIA H100 80GB HBM3, 700 W), with the same
# attention roundings that leave the base model at 0.086. In bf16 the
# adapter rows are held to the forward bound against the forward over
# merged weights (the merged weight W + s A @ B rounds once, the runtime
# path at h @ A, its product with B and the sum); in f32 (TF32 off) to
# LORA_F32_ATOL, where only summation orders differ (measured 2.3e-5).
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LORA_RANKS = (8, 16)
LORA_SCALE = 0.25
LORA_F32_ATOL = 1e-3


def _lora_tensors(cfg, rank: int, seed: int, targets=LORA_TARGETS) -> dict:
    """A seeded adapter in PEFT's orientation, f32 on the CPU: {target: (A
    [L, rank, in], B [L, out, rank])} with A ~ N(0, 1/in), B ~ N(0, 1/rank)."""
    import torch

    from production_stack_tpu_torch.models import llama

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for t in targets:
        din, dout = llama.lora_dims(cfg)[t]
        a = torch.randn((cfg.num_layers, rank, din), generator=gen) * din**-0.5
        b = torch.randn((cfg.num_layers, dout, rank), generator=gen) * rank**-0.5
        out[t] = (a, b)
    return out


def _lora_forwards(model, adapters: dict, ids, chunk: int, n_chunks: int, burst: int) -> dict:
    """On a batch of rows on slots 0, 1, 2 (``adapters``: slot -> PEFT
    tensors): the kernel and plain forwards with LoRA buffers, each row's
    kernel forward alone (``("alone", row)``), the kernel forward without
    LoRA buffers, per adapter the kernel forward over the weights merged
    with LORA_SCALE * A @ B, and layer 0's ``wq`` projection of the batch
    against each row alone (``"proj_rows"``, _lora_proj_rows)."""
    import torch

    from production_stack_tpu_torch.models import llama

    cfg = model.cfg
    bufs = llama.init_lora_buffers(cfg, 1 + len(adapters), max(LORA_RANKS), LORA_TARGETS, device="cuda")
    for slot, ad in adapters.items():
        for t, (a, b) in ad.items():
            rank = a.shape[1]
            for li, layer in enumerate(bufs["layers"]):
                layer["a_" + t][slot, :, :rank] = a[li].t().to(cfg.dtype).cuda()
                layer["b_" + t][slot, :rank, :] = b[li].t().to(cfg.dtype).cuda()
        bufs["scale"][slot] = LORA_SCALE
    slots = torch.tensor(range(len(ids)), dtype=torch.int32, device="cuda")
    kernels, _ = _counters()
    out = {}
    with torch.no_grad():
        for fn, attr in kernels.values():
            setattr(fn, attr, 0)
        out["kernel"], _ = _forward_run(model, "cuda", ids, chunk, n_chunks, burst, lora=(bufs, slots))
        out["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
        out["plain"], _ = _forward_run(model, "plain", ids, chunk, n_chunks, burst, lora=(bufs, slots))
        for row in range(len(ids)):
            out["alone", row], _ = _forward_run(model, "cuda", ids[row:row + 1], chunk, n_chunks, burst,
                                                lora=(bufs, slots[row:row + 1]))
        out["proj_rows"] = _lora_proj_rows(model, bufs, slots)
        out["base"], _ = _forward_run(model, "cuda", ids, chunk, n_chunks, burst)
        for slot, ad in adapters.items():
            saved = {}
            for li, layer in enumerate(model.layers):
                for t, (a, b) in ad.items():
                    w = getattr(layer, t)
                    saved[(li, t)] = w.detach().clone()
                    w.copy_((w.float() + LORA_SCALE * (a[li].t() @ b[li].t()).cuda()).to(w.dtype))
            out[slot], _ = _forward_run(model, "cuda", ids, chunk, n_chunks, burst)
            for (li, t), w in saved.items():
                getattr(model.layers[li], t).copy_(w)
    return out


def _lora_proj_rows(model, bufs, slots) -> dict:
    """Layer 0's ``wq`` projection of a batch of rows on ``slots`` against
    each row alone, at the shapes a server gives it (a 64-token chunk, a
    decode step), seeded inputs: per row, whether the base product ``h @ W``
    and the projection with its LoRA delta come out bit-equal, and the
    largest difference."""
    import torch

    from production_stack_tpu_torch.models import llama

    cfg, layer, lbufs = model.cfg, model.layers[0], bufs["layers"][0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {}
    for T in (64, 1):
        h = torch.randn((len(slots), T, cfg.hidden_size), generator=gen, device="cuda").to(cfg.dtype)
        base, full = h @ layer.wq, layer.proj(h, "wq", lbufs, llama.LoraStep(bufs, slots, cfg.dtype))
        rows = []
        for b in range(len(slots)):
            one = layer.proj(h[b:b + 1], "wq", lbufs, llama.LoraStep(bufs, slots[b:b + 1], cfg.dtype))[0]
            rows.append({"slot": int(slots[b]), "base_bit_equal": torch.equal(base[b], (h[b:b + 1] @ layer.wq)[0]),
                         "with_delta_bit_equal": torch.equal(full[b], one),
                         "max_abs_diff": float((full[b].float() - one.float()).abs().max())})
        res[f"T{T}"] = rows
    return res


def _rows_compared(a_steps, b_steps, row) -> tuple:
    """(max |a - b| over the steps' logits of ``row``, top-1 agreement)."""
    diff = max(float((a[row] - b[row]).abs().max()) for a, b in zip(a_steps, b_steps))
    top1 = sum(int(a[row].argmax() == b[row].argmax()) for a, b in zip(a_steps, b_steps)) / len(a_steps)
    return diff, top1


def phase_lora_forward() -> None:
    """llama-3.2-1b with two LoRA adapters on a batch of rows on slots 0, 1
    and 2 (two 512-token chunks and an 8-step burst), in bf16 and in f32:
    the kernel forward against the plain forward; each row in the batch
    against the same row alone (another batch shape, so bf16 roundings may
    differ, within the forward bound; a row given another row's slot would
    move by ``change_vs_base``); the slot-0 row bit-equal to the same kernel
    forward without LoRA buffers; each adapter's row against a kernel
    forward over the weights merged with scale * A @ B."""
    import torch

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops.kernels.decode_attention import split_plan

    B, chunk, n_chunks, burst = 1 + len(LORA_RANKS), 512, 2, 8
    gen = torch.Generator().manual_seed(4)
    base_cfg = llama.PRESETS["llama-3.2-1b"]
    ids = torch.randint(0, base_cfg.vocab_size, (B, n_chunks * chunk + burst), generator=gen,
                        dtype=torch.int32).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        t0 = time.perf_counter()
        model = llama.LlamaForCausalLM(dataclasses.replace(base_cfg, dtype=dtype), device="cuda")
        llama.init_params(model, torch.Generator(device="cuda").manual_seed(0))
        adapters = {slot: _lora_tensors(model.cfg, rank, seed=30 + slot) for slot, rank in enumerate(LORA_RANKS, 1)}
        runs = _lora_forwards(model, adapters, ids, chunk, n_chunks, burst)
        bound = FORWARD_LOGIT_BOUND if dtype == torch.bfloat16 else LORA_F32_ATOL
        rows = {}
        for row in range(B):
            kp = _rows_compared(runs["kernel"], runs["plain"], row)
            alone = runs["alone", row]
            rows[row] = {"slot": row, "kernel_vs_plain": kp,
                         "batch_vs_alone": [*_rows_compared([x[row:row + 1] for x in runs["kernel"]], alone, 0),
                                            [torch.equal(a[row], b[0]) for a, b in zip(runs["kernel"], alone)]]}
            if row:
                rows[row]["vs_merged"] = _rows_compared(runs["kernel"], runs[row], row)
                rows[row]["change_vs_base"] = _rows_compared(runs["kernel"], runs["base"], row)[0]
        row0_same = all(torch.equal(a[0], b[0]) for a, b in zip(runs["kernel"], runs["base"]))
        line = {"phase": "lora_forward", "model": "llama-3.2-1b", "dtype": str(dtype).split(".")[-1],
                "layers": model.cfg.num_layers, "targets": LORA_TARGETS, "ranks": LORA_RANKS, "scale": LORA_SCALE,
                "chunks": [chunk] * n_chunks, "burst": burst, "rows": rows, "bound": bound,
                "top1_min": FORWARD_TOP1_MIN, "slot0_row_bit_equal_without_lora": row0_same,
                "wq_batch_vs_alone": runs["proj_rows"],
                "decode_splits_batch_alone": [
                    split_plan(n, model.cfg.num_kv_heads, -(-(n_chunks * chunk + burst) // 64), 64,
                               model.cfg.head_dim, False).splits for n in (B, 1)],
                "finite": all(bool(torch.isfinite(x).all()) for x in runs["kernel"]),
                "kernel_run_launches": runs["launches"], "seconds": round(time.perf_counter() - t0, 2)}
        emit(line)
        what = f"lora_forward[{line['dtype']}]"
        check(line["finite"], f"{what}: non-finite logits")
        check(row0_same, f"{what}: the slot-0 row differs from the forward without LoRA buffers")
        for row, r in rows.items():
            for key in ("kernel_vs_plain", "batch_vs_alone", "vs_merged"):
                if key in r:
                    check(r[key][0] <= bound and r[key][1] >= FORWARD_TOP1_MIN, f"{what}: row {row} {key}: {r[key]}")
            if row:
                check(r["change_vs_base"] > FORWARD_LOGIT_BOUND, f"{what}: slot {row} moved nothing: {r}")
        kinds = SERVE_ROWS[False] if dtype == torch.bfloat16 else ("decode_attention", "prefill_attention")
        for k in kinds:
            check(runs["launches"][k] > 0, f"{what}: kernel {k} was not launched")
        del model, runs
        torch.cuda.empty_cache()


# each kernel row's launch counter, as (wrapper, attribute): the int8 modes
# of the two attention kernels count apart from their fp modes, and the
# write rows count the prefill launches that also wrote the chunk
def _counters():
    """(kernel rows -> (wrapper, attribute), plain versions -> function):
    the counters engine/runner.COUNTERS names, which runner.rank_stats reads
    on every tp rank."""
    from production_stack_tpu_torch.engine.runner import COUNTERS

    kernels = {name: (fn, attr) for name, fn, attr in COUNTERS if attr != "calls"}
    plains = {name: fn for name, fn, attr in COUNTERS if attr == "calls"}
    return kernels, plains


def _prompt(rng, n_chars: int) -> str:
    letters = "abcdefghijklmnopqrstuvwxyz     .,"
    return "".join(letters[rng.randrange(len(letters))] for _ in range(n_chars))


async def _serve_requests(port: int, metric_series: tuple = (), long_prompt: int = 0,
                          repeat_logprobs: bool = False) -> dict:
    """The serve phase's requests. ``long_prompt`` > 0 makes the first
    concurrent completion's prompt that many bytes long; with
    ``repeat_logprobs`` the greedy repeat also asks for its tokens' logprobs
    and must repeat them exactly (a model whose tokens mostly lie outside
    the byte tokenizer's 256 byte values decodes to little text)."""
    import random

    import aiohttp

    rng = random.Random(5)
    base = f"http://127.0.0.1:{port}"
    max_tokens = 32
    # 575 bytes + BOS = 576 tokens = 9 pages: the repeat hits 8 cached pages
    # and recomputes the last 64 tokens, in the same chunk shape as the first
    # run's second chunk, so greedy output must repeat bit for bit
    repeat = {"prompt": _prompt(rng, 575), "max_tokens": max_tokens, "temperature": 0.0, "ignore_eos": True}
    if repeat_logprobs:
        repeat["logprobs"] = 1
    prompts = [_prompt(rng, 590 + 7 * i) for i in range(4)]
    if long_prompt:
        prompts[0] = _prompt(rng, long_prompt)
    out = {}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        for path in ("/health", "/v1/models", "/version"):
            async with s.get(base + path) as r:
                check(r.status == 200, f"serve: GET {path} -> {r.status}")

        async def complete(body):
            async with s.post(base + "/v1/completions", json=body) as r:
                return r.status, await r.json()

        async def stream(body):
            text, usage = [], None
            async with s.post(base + "/v1/completions", json=dict(body, stream=True)) as r:
                status = r.status
                async for raw in r.content:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    chunk = json.loads(line[6:])
                    if chunk.get("usage"):
                        usage = chunk["usage"]
                    for c in chunk["choices"]:
                        text.append(c.get("text") or "")
            return status, {"choices": [{"text": "".join(text)}], "usage": usage}

        async def chat(body):
            async with s.post(base + "/v1/chat/completions", json=body) as r:
                return r.status, await r.json()

        t0 = time.perf_counter()
        st, first = await complete(repeat)
        check(st == 200, f"serve: repeat request -> {st}")
        out["repeat_first_seconds"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        bodies = [
            {"prompt": p, "max_tokens": max_tokens, "temperature": 0.0 if i % 2 == 0 else 0.8,
             "top_p": 0.95, "ignore_eos": True}
            for i, p in enumerate(prompts)
        ]
        chat_body = {"messages": [{"role": "user", "content": _prompt(rng, 200)}], "max_tokens": 16,
                     "temperature": 0.0, "ignore_eos": True}
        results = await asyncio.gather(
            stream(bodies[0]), complete(bodies[1]), complete(bodies[2]), complete(bodies[3]), chat(chat_body)
        )
        out["concurrent_seconds"] = round(time.perf_counter() - t0, 3)
        for i, (st, body) in enumerate(results[:4]):
            check(st == 200, f"serve: completion {i} -> {st}: {body}")
            u = body["usage"]
            check(u["completion_tokens"] == max_tokens, f"serve: completion {i} usage {u}")
            check(u["prompt_tokens"] == len(prompts[i]) + 1, f"serve: completion {i} prompt tokens {u}")
        st, body = results[4]
        check(st == 200, f"serve: chat -> {st}: {body}")
        check(body["usage"]["completion_tokens"] == 16, f"serve: chat usage {body['usage']}")
        check(body["choices"][0]["message"]["role"] == "assistant", "serve: chat message role")
        st, second = await complete(repeat)
        check(st == 200, f"serve: repeat request (again) -> {st}")
        same = first["choices"][0]["text"] == second["choices"][0]["text"]
        if repeat_logprobs:
            lps = [r["choices"][0]["logprobs"]["token_logprobs"] for r in (first, second)]
            check(len(lps[0]) == max_tokens, f"serve: the repeat returned {len(lps[0])} logprobs")
            same = same and lps[0] == lps[1]
            out["repeat_token_logprobs_head"] = lps[0][:4]
        out["greedy_repeat_identical"] = same
        out["repeat_cached_tokens"] = second["usage"]["prompt_tokens_details"]["cached_tokens"]
        check(same, "serve: the same greedy request returned different text")
        async with s.get(base + "/metrics") as r:
            metrics = await r.text()
        for series in ("vllm:generation_tokens_total",) + metric_series:
            check(f"{series}{{" in metrics, f"serve: /metrics lacks {series}")
        out["metrics"] = {
            line.split("{")[0]: float(line.rsplit(" ", 1)[1]) for line in metrics.splitlines()
            if line.split("{")[0] in metric_series
        }
        out["usage_example"] = results[1][1]["usage"]
        out["prompt_tokens"] = [body["usage"]["prompt_tokens"] for _, body in results]
        out["requests"] = 2 + len(results)
    return out, repeat, first


async def _engine_greedy(engine, seq_id: str, prompt: str, lora_name=None, max_tokens: int = 24) -> tuple:
    """One greedy request through ``engine.generate``: (token ids, logprob
    entries with each token's two best)."""
    from production_stack_tpu_torch.engine.scheduler import SamplingParams

    params = SamplingParams(max_tokens=max_tokens, temperature=0.0, ignore_eos=True, logprobs=2)
    ids, lps = [], []
    async for o in engine.generate(seq_id, prompt=prompt, params=params, lora_name=lora_name):
        ids.extend(o.token_ids)
        lps.extend(o.logprobs)
    return ids, lps


async def _together(engine, prompt, lora_names: tuple, max_tokens: int = 24) -> list:
    """One greedy request of ``prompt`` (or of ``prompt[i]``, given a list)
    per name in ``lora_names`` (None: base), queued while the engine's loop
    thread waits on a gate, so that the scheduler sees them at once and
    every run of the same number of requests takes the same steps at the
    same shapes. Returns each request's (token ids, logprob entries), in
    order."""
    import threading

    entered, gate = threading.Event(), threading.Event()

    def hold():
        entered.set()
        gate.wait(60)

    engine._inbox.put(("device_cmd", hold))
    for _ in range(6000):
        if entered.is_set():
            break
        await asyncio.sleep(0.01)
    check(entered.is_set(), "lora: the engine loop did not reach the gate")
    prompts = [prompt] * len(lora_names) if isinstance(prompt, str) else prompt
    tasks = [asyncio.ensure_future(_engine_greedy(engine, f"together-{i}-{m}-{time.monotonic_ns()}", p, m,
                                                  max_tokens=max_tokens))
             for i, (p, m) in enumerate(zip(prompts, lora_names))]
    for _ in range(6000):
        if engine._inbox.qsize() >= len(lora_names) or any(t.done() for t in tasks):
            break
        await asyncio.sleep(0.01)
    gate.set()
    return await asyncio.gather(*tasks)


async def _lora_requests(server, port: int, adapters: list, full: bool) -> dict:
    """The LoRA routes on a server with ``enable_lora``: ``adapters`` (name,
    PEFT directory) loaded over HTTP and listed by /v1/models with their
    parent; each adapter's greedy output (text and token logprobs) repeats
    and differs from base's; a base and an adapter request in flight
    together, over HTTP, then queued at once (``_together``): beside base,
    the adapter's tokens and logprobs bit-equal to the same request's
    beside a copy of itself, base's bit-equal to base's beside base, and
    the adapter's tokens still not base's (a request given another row's
    slot would break one of these; a request alone runs other batch
    shapes, whose roundings differ). With ``full`` also: the same prompt
    under an adapter moves no prefix-cache hit (its salt keeps it off
    base's pages) and its repeat does; an unload while the adapter's
    request is in flight answers 400; a request for an unloaded adapter
    404; a reload gets a fresh salt and none of the old pages. Without
    ``full`` each request is LORA_LIGHT_TOKENS tokens long (the rank
    servers', whose steps cost their collectives), with it 24."""
    import random

    import aiohttp

    base = f"http://127.0.0.1:{port}"
    engine = server.engine
    rng = random.Random(9)
    out = {}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        async def post(path, body):
            async with s.post(base + path, json=body) as r:
                return r.status, await r.json()

        def greedy(prompt, model=None, max_tokens=24 if full else LORA_LIGHT_TOKENS):
            body = {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0.0, "ignore_eos": True,
                    "logprobs": 1}
            return dict(body, model=model) if model else body

        def result(body):
            c = body["choices"][0]
            return c["text"], c["logprobs"]["token_logprobs"]

        for i, (name, path) in enumerate(adapters):
            st, body = await post("/v1/load_lora_adapter", {"lora_name": name, "lora_path": path})
            check(st == 200 and body == {"status": "success", "lora_name": name, "slot": i + 1},
                  f"lora: load {name} -> {st}: {body}")
        async with s.get(base + "/v1/models") as r:
            models = (await r.json())["data"]
        out["models"] = [(m["id"], m.get("parent")) for m in models]
        check(out["models"] == [(server.cfg.name, None)] + sorted((n, server.cfg.name) for n, _ in adapters),
              f"lora: /v1/models lists {out['models']}")
        # a chunk and 63 bytes + BOS (575 at the default chunk of 512): a
        # repeat hits the chunk's cached pages and recomputes the last 64
        # tokens in the first run's second chunk shape (as in
        # _serve_requests), so greedy output repeats bit for bit
        prompt = _prompt(rng, server.cfg.prefill_chunk + 63)
        st, b0 = await post("/v1/completions", greedy(prompt))
        check(st == 200, f"lora: base request -> {st}")
        solo = {None: result(b0)}
        for name, _ in adapters:
            runs = []
            for _ in range(2):
                st, body = await post("/v1/completions", greedy(prompt, name))
                check(st == 200 and body["model"] == name, f"lora: request for {name} -> {st}: {body}")
                runs.append(result(body))
            check(runs[0] == runs[1], f"lora: {name}'s greedy output did not repeat")
            check(runs[0][1] != solo[None][1], f"lora: {name}'s greedy output equals base's")
            solo[name] = runs[0]
        out["greedy_repeat_identical"] = True
        out["differs_from_base"] = {name: True for name, _ in adapters}
        out["texts"] = {str(k): v[0][:40] for k, v in solo.items()}
        # a base and an adapter request in flight together
        name = adapters[0][0]
        both = await asyncio.gather(post("/v1/completions", greedy(prompt)),
                                    post("/v1/completions", greedy(prompt, name)))
        check(all(st == 200 for st, _ in both), f"lora: base and adapter together -> {[st for st, _ in both]}")
        out["http_together_equal_solo"] = [result(both[0][1]) == solo[None], result(both[1][1]) == solo[name]]
        check(result(both[1][1])[1] != solo[None][1], f"lora: {name} in flight beside base gave base's output")
        tokens = 24 if full else LORA_LIGHT_TOKENS
        mixed = await _together(engine, prompt, (None, name), tokens)
        same_base = await _together(engine, prompt, (None, None), tokens)
        same_adapter = await _together(engine, prompt, (name, name), tokens)
        out["together"] = {"base_beside_adapter_equals_beside_base": mixed[0] == same_base[0],
                           "adapter_beside_base_equals_beside_itself": mixed[1] == same_adapter[1],
                           "adapter_tokens_differ_from_base": mixed[1][0] != mixed[0][0]}
        check(all(out["together"].values()), f"lora: base and {name} queued together: {out['together']}")
        if not full:
            return out
        # the same prompt under an adapter: none of base's cached pages
        fresh = _prompt(rng, 400)
        st, _ = await post("/v1/completions", greedy(fresh, max_tokens=2))
        hits0 = engine.kv.prefix_hits
        st2, _ = await post("/v1/completions", greedy(fresh, name, max_tokens=2))
        hits1 = engine.kv.prefix_hits
        st3, _ = await post("/v1/completions", greedy(fresh, name, max_tokens=2))
        hits2 = engine.kv.prefix_hits
        out["prefix_hits_base_adapter_adapter"] = [hits0, hits1, hits2]
        check(st == st2 == st3 == 200, "lora: the salt requests failed")
        check(hits1 == hits0, f"lora: {name} hit base's cached pages ({hits0} -> {hits1})")
        check(hits2 > hits1, f"lora: {name}'s repeat did not hit its own pages ({hits1} -> {hits2})")
        # an unload while the adapter's request is in flight
        long_req = asyncio.ensure_future(post("/v1/completions", greedy(prompt, name, max_tokens=LORA_LONG_TOKENS)))
        for _ in range(200):
            if any(q.lora_slot for q in engine.scheduler.running):
                break
            await asyncio.sleep(0.01)
        st, body = await post("/v1/unload_lora_adapter", {"lora_name": name})
        out["unload_in_flight"] = [st, body.get("error")]
        check(st == 400 and "in-flight" in body.get("error", ""), f"lora: unload in flight -> {st}: {body}")
        st, _ = await long_req
        check(st == 200, f"lora: the long adapter request -> {st}")
        salt = engine.lora.cache_salt(name)
        st, _ = await post("/v1/unload_lora_adapter", {"lora_name": name})
        check(st == 200, f"lora: unload -> {st}")
        st, body = await post("/v1/completions", greedy(prompt, name))
        out["request_after_unload"] = st
        check(st == 404, f"lora: a request for the unloaded {name} -> {st}")
        st, _ = await post("/v1/load_lora_adapter", {"lora_name": name, "lora_path": adapters[0][1]})
        check(st == 200, f"lora: reload -> {st}")
        out["salts"] = [salt.decode(), engine.lora.cache_salt(name).decode()]
        check(salt != engine.lora.cache_salt(name), f"lora: the reload kept the salt {salt}")
        hits0 = engine.kv.prefix_hits
        st, body = await post("/v1/completions", greedy(fresh, name, max_tokens=2))
        check(st == 200 and engine.kv.prefix_hits == hits0, "lora: the reload hit the old load's pages")
    return out


# /stats keys of the JAX engine's that the port's features produce (no
# offload tier on the servers the surface phase runs on)
STATS_KEYS = (
    "num_requests_running", "num_requests_waiting", "num_requests_swapped", "num_preemptions_total",
    "num_requests_shed_total", "num_requests_shed_queue_full_total", "num_requests_shed_queue_deadline_total",
    "num_requests_shed_interactive_total", "num_requests_shed_batch_total", "engine_saturated",
    "engine_saturated_batch", "tensor_parallel", "mesh_devices", "cache_dtype", "kv_cache_dtype_bytes_per_token",
    "kv_quant_pages", "kv_quant_dequant_err_max", "gpu_cache_usage_perc", "gpu_prefix_cache_hits_total",
    "gpu_prefix_cache_queries_total", "gpu_prefix_cache_hit_rate", "prompt_tokens_total", "generation_tokens_total",
    "decode_dispatches_total", "kv_evicted_pages_total", "kv_evicted_hot_pages_total",
    "kv_proactive_spilled_pages_total", "interactive_ttft_p99_ms", "interactive_itl_p99_ms",
    "engine_loop_wait_seconds_total", "engine_loop_schedule_seconds_total", "engine_loop_step_seconds_total",
    "engine_loop_apply_seconds_total", "engine_loop_emit_seconds_total",
)
PHASE_HISTOGRAMS = ("vllm:request_queue_time_seconds", "vllm:request_prefill_time_seconds",
                    "vllm:time_per_output_token_seconds", "vllm:prefill_chunk_seconds")
# an input's embedding in a batch against the same input alone (another B
# and T bucket: bf16 GEMMs of other shapes round otherwise)
EMBED_ATOL = 2e-3
EMBED_INPUTS = ["The quick brown fox jumps over the lazy dog.", "hello", "a" * 300]


def _metric(text: str, series: str) -> float:
    """The value of ``series`` (name and labels, as printed) in a scrape."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    fail(f"/metrics lacks {series}")


def _metric_total(text: str, name: str) -> float:
    """The sum of ``name``'s series over all their labels in a scrape (0
    when it has none)."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            total += float(line.rsplit(" ", 1)[1])
    return total


async def _surface(server, port: int, level: int, repeat: dict, first: dict, n_requests: int) -> dict:
    """The engine surface on a server that has answered ``n_requests``
    requests: /stats, /slo_records, /metrics (phase histograms, device
    telemetry), the embedding, rerank and score routes, a chat request with
    tools, then sleep at ``level``, wake, and the greedy repeat through the
    kernels again."""
    import aiohttp
    import numpy as np
    import torch

    from production_stack_tpu_torch.engine.devicemon import pool_bytes

    base = f"http://127.0.0.1:{port}"
    kernels, plains = _counters()
    out = {}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        async def get(path):
            async with s.get(base + path) as r:
                check(r.status == 200, f"surface: GET {path} -> {r.status}")
                return await (r.json() if "json" in r.headers.get("Content-Type", "") else r.text())

        async def post(path, body=None):
            async with s.post(base + path, json=body) as r:
                ctype = r.headers.get("Content-Type", "")
                return r.status, await (r.json() if "json" in ctype else r.text())

        stats = await get("/stats")
        missing = [k for k in STATS_KEYS if k not in stats]
        check(not missing, f"surface: /stats lacks {missing}")
        log = await get("/slo_records?since=0")
        recs = log["records"]
        check(len(recs) == n_requests and all(r["outcome"] == "ok" for r in recs),
              f"surface: {len(recs)} SLO records for {n_requests} requests: {[r['outcome'] for r in recs]}")
        for key in ("ttft_ms", "itl_p99_ms", "queue_ms"):
            check(all(r[key] is not None for r in recs), f"surface: an SLO record lacks {key}")
        tail = await get(f"/slo_records?since={log['head']}")
        check(tail["records"] == [] and tail["head"] == log["head"], f"surface: since=head gave {tail}")
        out["slo"] = {"records": len(recs), "head": log["head"],
                      "ttft_ms": [r["ttft_ms"] for r in recs], "itl_p99_ms": [r["itl_p99_ms"] for r in recs]}
        text = await get("/metrics")
        m = f'{{model_name="{server.cfg.name}"}}'
        counts = {h: _metric(text, f"{h}_count{m}") for h in PHASE_HISTOGRAMS}
        check(all(v > 0 for v in counts.values()), f"surface: a phase histogram is empty: {counts}")
        telemetry = {k: _metric(text, f"vllm:{k}{m}") for k in (
            "kv_pool_device_bytes", "kv_pool_used_bytes", "hbm_headroom_bytes", "compile_seconds_total",
            "compile_events_total", "compile_cache_entries", "engine_step_duty_cycle")}
        telemetry["tpu_hbm_bytes_in_use"] = _metric(
            text, f'vllm:tpu_hbm_bytes_in_use{{model_name="{server.cfg.name}",device="cuda:0"}}')
        pool = pool_bytes(server.engine.runner)
        check(telemetry["tpu_hbm_bytes_in_use"] > 0, "surface: no device bytes in use")
        check(telemetry["kv_pool_device_bytes"] == pool,
              f"surface: kv_pool_device_bytes {telemetry['kv_pool_device_bytes']} != the pools' {pool} bytes")
        check(telemetry["compile_seconds_total"] > 0, "surface: compile_seconds_total is 0 after the build")
        out["histogram_counts"], out["telemetry"] = counts, telemetry

        # pooling routes: no kernel runs, and no plain version either
        for fn, attr in kernels.values():
            setattr(fn, attr, 0)
        for fn in plains.values():
            fn.calls = 0
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        st, emb = await post("/v1/embeddings", {"input": EMBED_INPUTS})
        check(st == 200, f"surface: /v1/embeddings -> {st}: {emb}")
        out["embed_peak_bytes"] = torch.cuda.max_memory_allocated() - mem0
        vecs = np.array([d["embedding"] for d in emb["data"]])
        norms = np.linalg.norm(vecs, axis=1)
        check(vecs.shape == (3, server.engine.model_cfg.hidden_size) and np.allclose(norms, 1.0, atol=1e-5),
              f"surface: embeddings {vecs.shape} with norms {norms}")
        errs = []
        for i, item in enumerate(EMBED_INPUTS):
            st, alone = await post("/v1/embeddings", {"input": [item]})
            check(st == 200, f"surface: /v1/embeddings (alone) -> {st}")
            errs.append(float(np.abs(np.array(alone["data"][0]["embedding"]) - vecs[i]).max()))
        out["embed_alone_max_abs_err"] = errs
        check(max(errs) <= EMBED_ATOL, f"surface: an input alone is {max(errs)} from its batched vector")
        # the largest bucket the route takes: 32 inputs of max_model_len tokens
        text_max = ("abc " * server.cfg.max_model_len)[: server.cfg.max_model_len - 1]  # + BOS
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        st, big = await post("/v1/embeddings", {"input": [text_max] * 32})
        check(st == 200, f"surface: /v1/embeddings at the largest bucket -> {st}: {big}")
        out["embed_largest_bucket"] = {"B": 32, "T": server.cfg.max_model_len,
                                       "seconds": round(time.perf_counter() - t0, 3),
                                       "peak_bytes": torch.cuda.max_memory_allocated() - mem0}
        big = np.array([d["embedding"] for d in big["data"]])
        spread = float(np.abs(big - big[0]).max())
        check(np.allclose(np.linalg.norm(big, axis=1), 1.0, atol=1e-5) and spread <= EMBED_ATOL,
              f"surface: the largest bucket's 32 copies of one input spread {spread}")
        for path, body in (("/v1/rerank", {"query": "hello", "documents": ["hello", "fox", "a b c"]}),
                           ("/v2/rerank", {"query": "hello", "documents": ["hello", "fox"]}),
                           ("/v1/score", {"text_1": "hello", "text_2": ["hello", "fox"]})):
            st, body = await post(path, body)
            check(st == 200, f"surface: {path} -> {st}: {body}")
        out["score_hello_hello"] = body["data"][0]["score"]
        pooled = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
        pooled.update({k: fn.calls for k, fn in plains.items()})
        check(not any(pooled.values()), f"surface: the pooling routes ran a kernel or a plain version: {pooled}")
        tools = [{"type": "function", "function": {"name": "get_weather", "parameters": {
            "type": "object", "properties": {"city": {"type": "string"}}}}}]
        st, body = await post("/v1/chat/completions", {"messages": [{"role": "user", "content": "weather in SF?"}],
                                                       "tools": tools, "max_tokens": 8, "temperature": 0.0})
        check(st == 200, f"surface: chat with tools -> {st}: {body}")
        out["tools_finish_reason"] = body["choices"][0]["finish_reason"]

        # sleep, then wake and repeat the greedy request through the kernels
        params = sum(p.nbytes for p in server.engine.runner.model.parameters())
        # blocks the allocator caches from earlier phases would count as freed
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        st, _ = await post(f"/sleep?level={level}")
        check(st == 200, f"surface: /sleep -> {st}")
        out["sleep_seconds"] = round(time.perf_counter() - t0, 3)
        check((await get("/is_sleeping")) == {"is_sleeping": True}, "surface: /is_sleeping is not true")
        st, body = await post("/v1/completions", repeat)
        check(st == 503, f"surface: a completion while asleep -> {st}")
        freed = reserved0 - torch.cuda.memory_reserved()
        need = pool + (params if level >= 2 else 0)
        out.update(level=level, freed_bytes=freed, pool_bytes=pool, weight_bytes=params, need_bytes=need)
        check(freed >= need, f"surface: sleep level {level} freed {freed} bytes, under {need}")
        t0 = time.perf_counter()
        st, _ = await post("/wake_up")
        check(st == 200, f"surface: /wake_up -> {st}")
        out["wake_seconds"] = round(time.perf_counter() - t0, 3)
        for fn, attr in kernels.values():
            setattr(fn, attr, 0)
        st, again = await post("/v1/completions", repeat)
        check(st == 200, f"surface: the repeat after wake -> {st}")
        out["launches_after_wake"] = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
        out["plain_calls"] = {k: fn.calls for k, fn in plains.items()}
        same = again["choices"][0]["text"] == first["choices"][0]["text"]
        if "logprobs" in repeat:
            same = same and (again["choices"][0]["logprobs"]["token_logprobs"]
                             == first["choices"][0]["logprobs"]["token_logprobs"])
        out["greedy_repeat_after_wake_identical"] = same
        check(same, f"surface: the greedy repeat after sleep level {level} and wake differs")
        for k in SERVE_ROWS[False]:
            check(out["launches_after_wake"][k] > 0, f"surface: kernel {k} was not launched after wake")
        for k, n in out["plain_calls"].items():
            check(n == 0, f"surface: plain version {k} ran {n} times")
    return out


# The int8 server: int8 pools and the CPU offload tier, with a pool of 40
# pages (2,560 tokens) that the concurrent requests (~46 pages) overrun, so
# the repeat request's prefix pages are evicted to the tier between its two
# runs and restored from it for the second.
INT8_SERVE = dict(kv_cache_dtype="int8", kv_offload_cpu_gb=1.0, num_pages=40)
QUANT_METRICS = ("vllm:kv_cache_dtype_bytes_per_token", "vllm:kv_quant_pages", "vllm:kv_quant_dequant_err_max")
OFFLOAD_METRICS = (
    "vllm:kv_offload_saved_pages_total", "vllm:kv_offload_loaded_pages_total", "vllm:kv_offload_hit_pages_total",
    "vllm:kv_offload_max_io_pages", "vllm:kv_offload_link_bandwidth_bytes_per_sec",
)
SERVE_ROWS = {
    False: ("decode_attention", "prefill_attention", "kv_page_write"),
    True: ("decode_attention[int8]", "prefill_attention[int8]", "kv_page_write_quant"),
}


# gemma-2-2b's server: bf16 pools, a context of 8,192 so one concurrent
# prompt can run past the sliding window (4,300 bytes: nine prefill chunks)
GEMMA_SERVE = dict(max_model_len=8192)
GEMMA_LONG_PROMPT = 4300


def _rank_rows(stats) -> list:
    """runner.rank_stats' [tp, len(RANK_STATS)] as one dict per rank."""
    from production_stack_tpu_torch.engine.runner import RANK_STATS

    return [dict(zip(RANK_STATS, (float(x) for x in row))) for row in stats]


def phase_serve(label: str, overrides: dict, sleep_level: int = 0, lora: tuple = (), prepare=None,
                extra=None, sp_prompt: int = 0) -> dict:
    """The port's OpenAI server in-process on ``EngineConfig(**overrides)``
    (a preset or an HF directory as ``model``; int8 pools, the CPU offload
    tier, a longer context as the run asks): the requests of
    ``_serve_requests``, gemma-2-2b's with one prompt past its 4,096 window,
    and the greedy repeat held to its token logprobs too except for llama
    (whose byte tokens decode to text). With ``sleep_level`` the server runs
    with sleep mode on, and after the main path the engine surface is
    checked (``_surface``), ending in a sleep at that level and a wake.
    With ``lora`` = (adapters, full) the LoRA routes run on the main path
    too (``_lora_requests``). With ``tensor_parallel_size`` tp,
    ``expert_parallel_size`` ep, ``data_parallel_size`` dp or
    ``sequence_parallel_size`` sp > 1 the engine runs dp x sp x ep x tp
    processes (the followers it starts; with ``pipeline_parallel_size`` pp,
    pp x tp), the counts are read from every rank (runner.rank_stats) and
    each rank must have launched each kernel of its mode; a "tp_ranks"
    (with dp > 1 "dp_ranks", with ep > 1 "ep_ranks", with pp > 1
    "pp_ranks", with sp > 1 "sp_ranks") line gives each rank's device bytes
    allocated, step and collective seconds and bytes (and the collectives'
    share of the step), its expert group's all-reduces, its stage relays and
    its sequence group's ring (calls, bytes, seconds and their share of the
    step), the bytes its model read from a directory and its launches. With
    dp, sp or ep > 1 every dp, sp and ep replica of a stage's KV-head shard
    must hold the same pools and scales after the main path
    (runner.replica_digest). With sp > 1 the first concurrent prompt is
    ``sp_prompt`` (SP_PROMPT by default) tokens long, each chunk goes
    through the ring (no rank may
    launch the prefill kernel or the paged-KV write, and every rank's
    sequence group must have carried the chunks' K/V), and /stats and
    /metrics must count every rank. ``prepare(engine)``, when given, runs on
    the engine's loop thread before the main path (its launches are not
    counted). ``extra(server, port)``, when given, is a coroutine of more
    requests run at the end of the main path (its launches counted), whose
    result the serve line carries under "extra". With ``speculative_k`` the
    decode dispatches are verify rounds: the decode kernel must not run, and
    the prefill kernel must have run L times per prefill step and per verify
    round (engine.spec_verify_forwards), exactly; on pipeline stages L a
    microbatch (between 1 and 2 pp microbatches a step, summed over the
    stages); at sp never (chunks and rounds go through the ring). Returns
    the launch counts of the main path, summed over the ranks (a spec
    server's verify launches, runner.rank_stats' "verify_launches", under
    VERIFY_ROW, apart from its chunks')."""
    import socket

    import torch

    from production_stack_tpu_torch.engine.api_server import serve
    from production_stack_tpu_torch.engine.config import EngineConfig

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    quant = overrides.get("kv_cache_dtype") == "int8"
    offload = "kv_offload_cpu_gb" in overrides or "kv_remote_url" in overrides
    gemma = label.startswith("gemma")
    cfg = EngineConfig(host="127.0.0.1", port=port, enable_sleep_mode=sleep_level > 0, **overrides)
    tp, dp, ep = cfg.tensor_parallel_size, cfg.data_parallel_size, cfg.expert_parallel_size
    pp, sp = cfg.pipeline_parallel_size, cfg.sequence_parallel_size
    spec = cfg.speculative_k > 0
    ranks = pp * dp * sp * ep * tp
    # at sp a chunk goes through the ring: the decode kernel is a rank's
    # only one; with speculative_k no decode kernel runs (the verify rounds
    # take the prefill kernel, at sp the ring)
    want = ("decode_attention",) if sp > 1 else SERVE_ROWS[quant]
    if spec:
        want = tuple(k for k in want if k != "decode_attention")
    sp_prompt = sp_prompt or SP_PROMPT
    long_prompt = GEMMA_LONG_PROMPT if gemma else sp_prompt - 1 if sp > 1 else 0
    kernels, plains = _counters()
    series = (QUANT_METRICS if quant else ()) + (OFFLOAD_METRICS if offload else ())

    async def run():
        server, runner = await serve(cfg)
        try:
            if prepare is not None:
                res_prepare = await asyncio.get_running_loop().run_in_executor(
                    None, server.engine._run_on_device_thread, lambda: prepare(server.engine), "prepare")
            # every count to 0 right before the main path, read right after
            # (on every rank with dp or tp ranks)
            if ranks > 1:
                server.engine.runner.rank_stats(reset=True)
            server.engine.runner.verify_launches = 0
            for fn, attr in kernels.values():
                setattr(fn, attr, 0)
            for fn in plains.values():
                fn.calls = 0
            server.engine.spec_verify_forwards = 0
            steps0 = server.engine.runner.steps
            t0 = time.perf_counter()
            res, repeat, first = await _serve_requests(port, series, long_prompt,
                                                       repeat_logprobs=not label.startswith("llama"))
            if lora:
                t_lora = time.perf_counter()
                res["lora"] = await _lora_requests(server, port, *lora)
                res["lora"]["seconds"] = round(time.perf_counter() - t_lora, 3)
                if ranks > 1:
                    LORA_SECONDS[f"lora routes {label}"] = res["lora"]["seconds"]
            if extra is not None:
                res["extra"] = await extra(server, port)
            if sp > 1:
                res["mesh"] = await _mesh_rows(port, ranks)
            res["seconds"] = round(time.perf_counter() - t0, 3)
            res["runner_steps"] = server.engine.runner.steps - steps0
            res["verify_forwards"] = server.engine.spec_verify_forwards
            if ranks > 1:
                rows = _rank_rows(server.engine.runner.rank_stats())
                res["launches_by_rank"] = [{k: int(r[k]) for k in kernels} for r in rows]
                res["launches"] = {k: sum(r[k] for r in res["launches_by_rank"]) for k in kernels}
                res["verify_launches"] = int(sum(r["verify_launches"] for r in rows))
                res["plain_calls"] = {k: int(sum(r[k] for r in rows)) for k in plains}
                res["tp_ranks"] = [
                    {"rank": i, "device": dev,
                     **{k: r[k] for k in ("device_bytes", "step_seconds", "steps", "collective_calls",
                                          "collective_bytes", "collective_seconds", "expert_calls", "expert_bytes",
                                          "relay_calls", "relay_bytes", "relay_seconds", "ring_calls",
                                          "ring_bytes", "ring_seconds", "loaded_bytes")},
                     "collective_share_of_step": r["collective_seconds"] / max(r["step_seconds"], 1e-9),
                     "relay_share_of_step": r["relay_seconds"] / max(r["step_seconds"], 1e-9),
                     "ring_share_of_step": r["ring_seconds"] / max(r["step_seconds"], 1e-9),
                     "launches": res["launches_by_rank"][i]}
                    for i, (r, (dev, _)) in enumerate(zip(rows, server.engine.runner.kv_pool_shard_layout()))
                ]
                if dp * sp * ep > 1:
                    # the ranks of one tp place t of one stage p, r = p * per +
                    # ((d * sp + s) * ep + e) * tp + t (a stage's layers are its own)
                    digests = [bytes(d).hex() for d in server.engine.runner.replica_digest()]
                    per = ranks // pp
                    res["replica_digests"] = [h[:16] for h in digests]
                    res["replica_digests_equal"] = all(
                        len({digests[p * per + r] for r in range(t, per, tp)}) == 1
                        for p in range(pp) for t in range(tp))
            else:
                res["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
                res["plain_calls"] = {k: fn.calls for k, fn in plains.items()}
                res["verify_launches"] = server.engine.runner.verify_launches
            if prepare is not None:
                res["prepare"] = res_prepare
            keep = ["prompt_tokens_total", "generation_tokens_total", "decode_dispatches_total",
                    "gpu_prefix_cache_hits_total", "kv_evicted_pages_total", "num_pages"]
            if quant:
                keep += ["cache_dtype", "kv_cache_dtype_bytes_per_token", "kv_quant_pages",
                         "kv_quant_dequant_err_max"]
            if offload:
                keep += ["kv_offload_saved_pages_total", "kv_offload_loaded_pages_total",
                         "kv_offload_hit_pages_total", "kv_proactive_spilled_pages_total", "kv_offload_cpu_bytes",
                         "kv_corrupt_pages_total", "kv_offload_max_io_pages",
                         "kv_offload_link_bandwidth_bytes_per_sec"]
            stats = server.engine.stats()
            res["engine"] = {k: stats[k] for k in keep if k in stats}
            res["served_name"] = server.cfg.name
            res["num_layers"] = server.engine.model_cfg.num_layers
            if sleep_level:
                surface = await _surface(server, port, sleep_level, repeat, first, res["requests"])
                card = await asyncio.to_thread(nvidia_smi_line)
                emit({"phase": "surface", "model": label, **surface, "card": card})
            return res
        finally:
            await runner.cleanup()
            server.engine.stop()

    t0 = time.perf_counter()
    res = asyncio.run(run())
    res["seconds_with_startup"] = round(time.perf_counter() - t0, 2)
    what = f"serve[{label}]"
    tp_ranks = res.pop("tp_ranks", None)
    emit({"phase": "serve", "model": label, "kv_cache_dtype": cfg.kv_cache_dtype, "config": overrides, **res})
    if ranks > 1:
        # functional numbers of ranks over gloo, which stages every CUDA
        # collective through the host; no NCCL dp or tp speed figure
        emit({"phase": "pp_ranks" if pp > 1 else "sp_ranks" if sp > 1 else "ep_ranks" if ep > 1
              else "dp_ranks" if dp > 1 else "tp_ranks",
              "model": label, "backend": f"{cfg.tp_backend} (host-staged CUDA tensors)", "pp": pp, "dp": dp, "sp": sp,
              "ep": ep, "tp": tp,
              "ranks": tp_ranks, "main_path_seconds": res["seconds"], "card": nvidia_smi_line()})
        for r, counts in enumerate(res["launches_by_rank"]):
            for k in want:
                check(counts[k] > 0, f"{what}: kernel {k} was not launched on rank {r}")
    if dp * sp * ep > 1:
        check(res["replica_digests_equal"],
              f"{what}: the dp, sp or ep replicas' pools differ: {res['replica_digests']}")
    if sp > 1:
        for r, (counts, row) in enumerate(zip(res["launches_by_rank"], tp_ranks)):
            others = {k: n for k, n in counts.items() if k not in want and n}
            check(not others, f"{what}: rank {r} launched {others} (a chunk at sp goes through the ring)")
            check(row["ring_calls"] > 0, f"{what}: rank {r} moved nothing over its sequence group")
        check(sp_prompt in res["prompt_tokens"], f"{what}: no prompt of {sp_prompt} tokens ran")
    if gemma:
        check(max(res["prompt_tokens"]) > GEMMA_WINDOW, f"{what}: no prompt ran past the sliding window")
    if spec:
        # every decode dispatch is verify rounds through the prefill kernel:
        # L launches per prefill step and per round, the decode kernel none;
        # on pipeline stages L a microbatch (1 to 2 pp microbatches a step,
        # summed over the stages); at sp none (chunks and rounds go
        # through the ring)
        L = res["num_layers"]
        rounds = res["verify_forwards"]
        prefill_steps = res["runner_steps"] - rounds // cfg.decode_steps
        n, v = res["launches"]["prefill_attention"], res["verify_launches"]
        check(rounds > 0, f"{what}: no verify round ran")
        check(res["launches"]["decode_attention"] == 0,
              f"{what}: a spec server ran the decode kernel {res['launches']['decode_attention']} times")
        launched = f"{n} prefill launches ({v} verify) for {rounds} verify rounds and {prefill_steps} prefill steps"
        if sp > 1:
            check(n == v == 0, f"{what}: {launched} at sp")
        elif pp > 1:
            m = 2 * pp  # parallel/pipeline.microbatches' most
            check(L * rounds <= v <= m * L * rounds and L * prefill_steps <= n - v <= m * L * prefill_steps,
                  f"{what}: {launched} of {L} layers over {pp} stages")
        else:
            check(n >= L * rounds + L and n == L * (prefill_steps + rounds) and v == L * rounds,
                  f"{what}: {launched} of {L} layers")
    for k in want:
        if spec and k == "decode_attention":
            continue  # checked to be 0 above
        check(res["launches"][k] > 0, f"{what}: kernel {k} was not launched on the main path")
    for k in SERVE_ROWS[not quant]:  # an int8 pool never reaches an fp mode, nor the other way round
        check(res["launches"][k] == 0, f"{what}: kernel {k} ran {res['launches'][k]} times on the main path")
    for k, n in res["plain_calls"].items():
        check(n == 0, f"{what}: plain version {k} ran {n} times on the main path")
    check(res["repeat_cached_tokens"] >= 512, f"{what}: the repeat reused {res['repeat_cached_tokens']} tokens")
    if offload:
        e = res["engine"]
        check(e["kv_offload_saved_pages_total"] > 0, f"{what}: no page was saved to the offload tier")
        check(e["kv_offload_loaded_pages_total"] > 0 and e["kv_offload_hit_pages_total"] > 0,
              f"{what}: no page was restored from the offload tier")
        check(e["kv_corrupt_pages_total"] == 0, f"{what}: the offload tier held corrupt pages")
    torch.cuda.empty_cache()
    launches = dict(res["launches"])
    if spec:
        launches[VERIFY_ROW] = res["verify_launches"]
        launches["prefill_attention"] -= res["verify_launches"]
    return launches


# -- chained and speculative decode -----------------------------------------

# the chained server's lone greedy request, held to the same request at
# decode_pipeline 1 (one page of prompt and output, so both runs take the
# same batch, chunk and page-table buckets: the same kernels at the same
# shapes)
LONE_PROMPT = "A lone request, decoded in chained bursts: "
LONE_TOKENS = 16
SPEC_K = VERIFY_K


async def _slo_numbers(s, base: str, since: int) -> dict:
    """The server's own latency records since cursor ``since``: each
    request's mean inter-token gap ((e2e - ttft) / (tokens - 1)) and its own
    ITL p99, as p50 and p99 over the requests."""
    async with s.get(f"{base}/slo_records?since={since}") as r:
        recs = (await r.json())["records"]
    gaps = sorted((x["e2e_ms"] - x["ttft_ms"]) / (x["output_tokens"] - 1) for x in recs
                  if x["ttft_ms"] is not None and x["output_tokens"] > 1)
    p99s = sorted(x["itl_p99_ms"] for x in recs if x["itl_p99_ms"] is not None)

    def q(xs, f):
        return round(xs[min(len(xs) - 1, int(len(xs) * f))], 3) if xs else None

    return {"requests": len(recs), "itl_mean_ms_p50": q(gaps, 0.5), "itl_mean_ms_p99": q(gaps, 0.99),
            "itl_p99_ms_p50": q(p99s, 0.5), "itl_p99_ms_p99": q(p99s, 0.99)}


async def _load_numbers(s, base: str, since: int, tokens: int, wall: float) -> dict:
    async with s.get(base + "/stats") as r:
        stats = await r.json()
    return {"output_tokens": tokens, "wall_seconds": round(wall, 3),
            "output_tokens_per_second": round(tokens / wall, 2), **await _slo_numbers(s, base, since),
            "chain_dispatch_seconds": stats["engine_loop_chain_dispatch_seconds_total"],
            "chain_fetch_seconds": stats["engine_loop_chain_fetch_seconds_total"],
            "decode_chained_dispatches_total": stats["decode_chained_dispatches_total"],
            "runahead_prefill_dispatches_total": stats["runahead_prefill_dispatches_total"],
            "card": await asyncio.to_thread(nvidia_smi_line)}


async def _staggered(s, base: str, n: int = 8, gap: float = 0.5, max_tokens: int = 64) -> tuple:
    """``n`` streamed greedy completions arriving ``gap`` seconds apart
    behind one long request already decoding: (output tokens, wall). At
    two arrivals a second the scheduler's chain cap still lets the long
    request chain, so most arrivals land while a chain is being dispatched
    and run ahead; at eight a second the cap shortens the chains (their
    expected arrivals stay under half a request), and on the card one
    arrival in eight ran ahead."""
    import random

    rng = random.Random(17)

    async def stream(prompt, tokens):
        body = {"prompt": prompt, "max_tokens": tokens, "temperature": 0.0, "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}
        usage = None
        async with s.post(base + "/v1/completions", json=body) as r:
            check(r.status == 200, f"staggered: a stream -> {r.status}")
            async for raw in r.content:
                line = raw.decode().strip()
                if line.startswith("data: {"):
                    usage = json.loads(line[6:]).get("usage") or usage
        check(usage is not None and usage["completion_tokens"] == tokens, f"staggered: usage {usage}")
        return tokens

    t0 = time.perf_counter()
    tasks = [asyncio.ensure_future(stream(_prompt(rng, 300), 6 * max_tokens))]
    await asyncio.sleep(0.3)  # the long one decodes in chains by now
    for i in range(n):
        tasks.append(asyncio.ensure_future(stream(_prompt(rng, 100 + 40 * i), max_tokens)))
        await asyncio.sleep(gap)
    done = await asyncio.gather(*tasks)
    return sum(done), time.perf_counter() - t0


async def _lone_ids(engine) -> list:
    """The lone greedy request's token ids through ``engine.generate`` (the
    byte tokenizer decodes llama-3.2-1b's ids past 255 to no text, so ids
    are compared, not text)."""
    from production_stack_tpu_torch.engine.scheduler import SamplingParams

    ids = []
    async for o in engine.generate(f"lone-{time.monotonic_ns()}", prompt=LONE_PROMPT, params=SamplingParams(
            max_tokens=LONE_TOKENS, temperature=0.0, ignore_eos=True)):
        ids.extend(o.token_ids)
    return ids


async def _chained_requests(server, port: int) -> dict:
    """The chained server's own requests: the lone greedy one (its token
    ids are held to decode_pipeline 1's after the run), then 8 streams
    arriving apart behind a long one, which must make chains and run-ahead
    prefills (/metrics), with the load's numbers."""
    import aiohttp

    base = f"http://127.0.0.1:{port}"
    out = {"lone_ids": await _lone_ids(server.engine)}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        async with s.get(base + "/slo_records?since=0") as r:
            since = (await r.json())["head"]
        tokens, wall = await _staggered(s, base)
        async with s.get(base + "/metrics") as r:
            text = await r.text()
        m = f'{{model_name="{server.cfg.name}"}}'
        out["metrics"] = {k: _metric(text, f"vllm:{k}{m}") for k in (
            "decode_chained_dispatches_total", "runahead_prefill_dispatches_total", "decode_dispatches_total")}
        out["load"] = await _load_numbers(s, base, since, tokens, wall)
    check(out["metrics"]["decode_chained_dispatches_total"] > 0, f"chained: no chained dispatch: {out['metrics']}")
    check(out["metrics"]["runahead_prefill_dispatches_total"] > 0, f"chained: no run-ahead prefill: {out['metrics']}")
    return out


async def _pipelined_int8_requests(server, port: int) -> dict:
    """The int8 chained server's chain counters after the main path."""
    import aiohttp

    async with aiohttp.ClientSession() as s:
        async with s.get(f"http://127.0.0.1:{port}/stats") as r:
            stats = await r.json()
    return {k: stats[k] for k in ("decode_chained_dispatches_total", "runahead_prefill_dispatches_total",
                                  "engine_loop_chain_dispatch_seconds_total", "engine_loop_chain_fetch_seconds_total")}


async def _spec_requests(server, port: int) -> dict:
    """The spec server's own requests: a logprobs request gets 400, a
    repetitive greedy prompt ends by length, the draft counters move, and
    the load of 8 staggered streams gives its numbers."""
    import aiohttp

    base = f"http://127.0.0.1:{port}"
    out = {}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        async def post(body):
            async with s.post(base + "/v1/completions", json=body) as r:
                return r.status, await r.json()

        st, body = await post({"prompt": "hello", "max_tokens": 4, "logprobs": 1})
        out["logprobs_request"] = [st, body.get("error", {}).get("message")]
        check(st == 400, f"spec: a logprobs request -> {st}")
        st, body = await post({"prompt": "ab ab ab ab " * 20, "max_tokens": 96, "temperature": 0.0,
                               "ignore_eos": True})
        check(st == 200 and body["choices"][0]["finish_reason"] == "length"
              and body["usage"]["completion_tokens"] == 96, f"spec: the repetitive prompt -> {st}: {body}")
        async with s.get(base + "/slo_records?since=0") as r:
            since = (await r.json())["head"]
        tokens, wall = await _staggered(s, base)
        async with s.get(base + "/stats") as r:
            stats = await r.json()
        out["spec"] = {k: stats[k] for k in ("spec_decode_num_draft_tokens_total",
                                             "spec_decode_num_accepted_tokens_total",
                                             "spec_decode_draft_acceptance_rate")}
        out["load"] = await _load_numbers(s, base, since, tokens, wall)
    check(out["spec"]["spec_decode_num_draft_tokens_total"] > 0, f"spec: no draft token: {out['spec']}")
    check(0.0 <= out["spec"]["spec_decode_draft_acceptance_rate"] <= 1.0, f"spec: acceptance {out['spec']}")
    return out


def phase_lone_unchained(ids: list) -> None:
    """The chained server's lone greedy request again at decode_pipeline 1,
    through an engine in-process: the same token ids."""
    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine

    engine = LLMEngine(EngineConfig(model="llama-3.2-1b"))
    engine.start()
    try:
        unchained = asyncio.run(_lone_ids(engine))
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "chained_lone", "model": "llama-3.2-1b", "tokens": len(ids), "ids_head": ids[:6],
          "ids_equal_to_decode_pipeline_1": unchained == ids})
    check(len(ids) == LONE_TOKENS and unchained == ids,
          "chained: the lone greedy request at decode_pipeline 4 differs from decode_pipeline 1")


# step_spec held to step_multi's greedy tokens on one runner: SPEC_ROWS
# rows of SPEC_PROMPT tokens that repeat 3-grams, SPEC_PAGES pages of 64 a
# row, an n-gram of SPEC_NGRAM
SPEC_ROWS, SPEC_PROMPT, SPEC_NGRAM, SPEC_PAGES = 4, 192, 3, 8


def _spec_vs_greedy(r, vocab: int, rounds: int) -> tuple:
    """On runner ``r`` (every rank): SPEC_ROWS prompts that repeat 3-grams
    (rows 0 and 1 stop repeating halfway, so their trailing n-gram occurs
    only where it is planted), step_multi's greedy tokens with their top-2
    logprob margins, then from the same prefill step_spec (``rounds``
    rounds, k SPEC_K, n SPEC_NGRAM) with rows 0 and 1's history carrying
    their next SPEC_K greedy tokens after an earlier copy of their trailing
    n-gram, so round 1 accepts them. Returns (spec tokens, a summary with
    the flips and the reference's margin at each, prefill(), which
    reprefills and returns the sampled first tokens, and decode_input(first,
    limit))."""
    import numpy as np

    from production_stack_tpu_torch.engine.runner import StepInput

    B, T, n = SPEC_ROWS, SPEC_PROMPT, SPEC_NGRAM
    rng = np.random.RandomState(21)
    prompts = np.stack([np.tile(rng.randint(1, vocab, 3), T)[:T] for _ in range(B)]).astype(np.int32)
    prompts[:2, T // 2:] = rng.randint(1, vocab, (2, T - T // 2))
    common = dict(page_table=np.arange(B * SPEC_PAGES, dtype=np.int32).reshape(B, SPEC_PAGES),
                  temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32))
    total = rounds * (SPEC_K + 1)

    def prefill():
        r.reset_kv()
        ids, _ = r.step(StepInput(input_ids=prompts, positions=np.tile(np.arange(T, dtype=np.int32), (B, 1)),
                                  kv_lens=np.full(B, T, np.int32), **common), want_logits=False)
        return ids.cpu().numpy()

    def decode_input(first, limit):
        return StepInput(input_ids=first[:, None].astype(np.int32), positions=np.full((B, 1), T, np.int32),
                         kv_lens=np.full(B, T + 1, np.int32), kv_limits=np.full(B, limit, np.int32), **common)

    first = prefill()
    ref, (_, _, top_lp) = r.step_multi(decode_input(first, T + total), total, want_logprobs=True)
    ref, margin = ref.cpu().numpy(), (top_lp[..., 0] - top_lp[..., 1]).cpu().numpy()
    hist = np.zeros((B, SPEC_PAGES * 64), np.int32)
    hist[:, :T], hist[:, T] = prompts, first
    hist[:2, 20: 20 + n] = np.concatenate([prompts[:2, T - 2:], first[:2, None]], axis=1)
    hist[:2, 20 + n: 20 + n + SPEC_K] = ref[:2, :SPEC_K]
    prefill()
    spec = r.step_spec(decode_input(first, SPEC_PAGES * 64), hist, steps=rounds, spec_k=SPEC_K, ngram=n)
    spec = spec.cpu().numpy()
    equal, flips = 0, []
    for b in range(B):
        got = spec[b][spec[b] >= 0]
        j = next((j for j, (x, y) in enumerate(zip(got, ref[b])) if x != y), len(got))
        equal += j
        if j < len(got):
            flips.append({"row": b, "token": j, "reference_top2_margin": float(margin[b, j])})
    emitted = spec >= 0
    row_rounds = int(emitted.any(axis=2).sum())
    accepted = int(emitted.sum()) - row_rounds
    summary = {"steps": rounds, "k": SPEC_K, "ngram": n, "tokens_equal_before_a_flip": equal,
               "emitted": int(emitted.sum()), "flips": flips, "draft_tokens": row_rounds * SPEC_K,
               "accepted_tokens": accepted, "acceptance_rate": round(accepted / max(1, row_rounds * SPEC_K), 4),
               "tokens_per_verify_forward": round(int(emitted.sum()) / max(1, row_rounds), 4)}
    return spec, summary, prefill, decode_input


def _check_spec(phase: str, spec, summary: dict, near_tie: float) -> None:
    """A token that differs from greedy's sits at a near tie (the
    reference's two best logprobs within ``near_tie``); rows 0 and 1's
    round 1 accepted their planted drafts, unless a near-tie flip came
    first."""
    for f in summary["flips"]:
        check(f["reference_top2_margin"] <= near_tie, f"{phase}: a token flipped away from a near-tie: {f}")
    for b in range(2):
        flipped = any(f["row"] == b and f["token"] <= SPEC_K for f in summary["flips"])
        check(flipped or (spec[b][0] >= 0).all(), f"{phase}: row {b}'s round 1 did not accept its planted drafts")


def phase_spec_chain() -> None:
    """An f32 copy of llama-3.2-1b at full width and depth (as
    phase_f32_tokens makes it), four rows whose prompts repeat 3-grams,
    through the runner on the card: step_spec (8 rounds, k 4, n 3) against
    step_multi's greedy tokens (a token that differs must sit at a near tie:
    step_multi's two best logprobs within TP_NEAR_TIE; rows 0 and 1 carry
    their next 4 greedy tokens after an earlier copy of their trailing
    3-gram in the history, so round 1 accepts them), then
    step_multi_pipelined (4 bursts of 8, fetch_group 4) against 4 calls of
    step_multi: the same tokens and byte-identical pools (the same kernels
    at the same shapes). Prints the acceptance rate and the tokens per
    verify forward."""
    import numpy as np
    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import HostTokens
    from production_stack_tpu_torch.models import llama

    name = "llama-3.2-1b-f32"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], dtype=torch.float32)
    engine = LLMEngine(EngineConfig(model=name, num_pages=64))
    r = engine.runner
    _, plains = _counters()
    for fn in plains.values():
        fn.calls = 0
    steps, burst, bursts = 8, 8, 4
    T = SPEC_PROMPT
    t0 = time.perf_counter()
    try:
        spec, summary, prefill, decode_input = _spec_vs_greedy(r, llama.PRESETS[name].vocab_size, steps)
        # the chain against separate bursts, from the same prefill
        first = prefill()
        groups = r.step_multi_pipelined(decode_input(first, T + bursts * burst), burst, bursts, fetch_group=4)
        check(len(groups) == 1 and isinstance(groups[0], HostTokens), f"spec_chain: groups {groups}")
        chained = groups[0].numpy()
        pools = (r.k_pages.clone(), r.v_pages.clone())
        prefill()
        cur, sep = decode_input(first, T + bursts * burst), []
        for _ in range(bursts):
            t = r.step_multi(cur, burst).cpu().numpy()
            sep.append(t)
            cur = dataclasses.replace(cur, input_ids=t[:, -1:].astype(np.int32), positions=cur.positions + burst,
                                      kv_lens=cur.kv_lens + burst)
        torch.cuda.synchronize()
        pools_same = _same_bytes(pools[0], r.k_pages) and _same_bytes(pools[1], r.v_pages)
        plain = {k: fn.calls for k, fn in plains.items()}
    finally:
        engine.stop()
        del engine, r
        gc.collect()
        torch.cuda.empty_cache()
    line = {"phase": "spec_chain", "model": name, "rows": SPEC_ROWS, "prompt_tokens": T,
            "spec": dict(summary, near_tie=TP_NEAR_TIE),
            "chain": {"bursts": bursts, "k": burst, "fetch_group": 4,
                      "tokens_equal": bool((chained == np.concatenate(sep, axis=1)).all()),
                      "pools_byte_identical": pools_same},
            "plain_calls": plain, "seconds": round(time.perf_counter() - t0, 2), "card": nvidia_smi_line()}
    emit(line)
    _check_spec("spec_chain", spec, summary, TP_NEAR_TIE)
    check(line["chain"]["tokens_equal"] and pools_same, f"spec_chain: the chain differs: {line['chain']}")
    check(not any(plain.values()), f"spec_chain: a plain version ran: {plain}")


# tensor parallelism on the one card: two ranks (two processes) on cuda:0
# over gloo, asked for by name (nccl refuses two ranks on one device); the
# collectives go through the host, so the numbers of these runs are
# functional, not a tp speed figure
TP2 = dict(tensor_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0")
# the llama tp and dp phases run llama-3.2-1b at full width with its depth
# cut to RANK_LAYERS of its 16 layers (_rank_llama registers the preset):
# the host-staged collectives cost per layer, and the smoke, grown by the
# ep and pp phases, must stay well inside its time limit (a whole call
# took 927.75 s on one H100 80GB HBM3 at 700 W with 8 layers here, and
# 1,333.09 s with 4 once the sp_compose phase came, on a card whose
# untouched phases ran ~1.2x the last 997.68 s call's: 2 since)
RANK_LAYERS = 2
RANK_LLAMA = f"llama-3.2-1b-l{RANK_LAYERS}"
TP_SERVE_LLAMA_INT8 = dict(model=RANK_LLAMA, **INT8_SERVE, **TP2)
# in-engine data parallelism on the one card, the same way: dp 2 (two
# ranks) and dp 2 x tp 2 (four), every rank a process on cuda:0
DP2 = dict(data_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0")
DP2_TP2 = dict(data_parallel_size=2, tensor_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0,0,0")
DP_SERVE_LLAMA_INT8 = dict(model=RANK_LLAMA, **INT8_SERVE, **DP2_TP2)
# the f32 copy's greedy tokens at tp 2 (dp 2) against tp 1 (dp 1); a token
# may flip only where the reference's two best tokens all but tie (their
# logprobs this close)
TP_F32_TOKENS = 16
TP_NEAR_TIE = 1e-3


# the tp forward's steps, as the forward phases compare theirs: two rows,
# two 512-token prefill chunks, then 8 decode steps fed the seeded tokens
# (teacher forcing), 20 rows of logits in all; the dp forward's the same
# with four rows, two on each dp rank
TP_FORWARD_CHUNKS, TP_FORWARD_DECODES = 2, 8
DP_FORWARD_ROWS = 4
# pages of the forward engines: every row's 17 pages
FORWARD_PAGES = 128


def _tp_inputs(vocab: int, B: int = 2, lora: bool = False) -> list:
    """The runner's StepInputs of the tp (dp) forward's steps, ``B`` rows,
    on fresh pages; with ``lora`` the rows on adapter slots LORA_ROW_SLOTS."""
    import numpy as np

    from production_stack_tpu_torch.engine.runner import StepInput

    rng = np.random.RandomState(4)
    T = 512
    n = TP_FORWARD_CHUNKS * T + TP_FORWARD_DECODES
    ids = rng.randint(0, vocab, (B, n)).astype(np.int32)
    maxp = -(-n // 64)
    common = dict(page_table=np.arange(B * maxp, dtype=np.int32).reshape(B, maxp),
                  temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
                  lora_ids=np.asarray(LORA_ROW_SLOTS[:B], np.int32) if lora else None)
    steps = [(c * T, T) for c in range(TP_FORWARD_CHUNKS)]
    steps += [(TP_FORWARD_CHUNKS * T + s, 1) for s in range(TP_FORWARD_DECODES)]
    return [
        StepInput(input_ids=ids[:, p: p + t], positions=np.tile(np.arange(p, p + t, dtype=np.int32), (B, 1)),
                  kv_lens=np.full(B, p + t, np.int32), **common)
        for p, t in steps
    ]


def _tp_logits(engine, rows: int = 2, lora: "bool | None" = None) -> list:
    """The logits [B, V] of _tp_inputs' chunk and decode step through the
    engine's runner (every rank), on the CPU; the pools are reset after. On
    an engine that serves LoRA (unless ``lora`` is False) the rows take
    LORA_ROW_SLOTS."""
    runner = engine.runner
    lora = engine.lora is not None if lora is None else lora
    out = [runner.step(inp)[1].float().cpu() for inp in _tp_inputs(engine.model_cfg.vocab_size, rows, lora)]
    runner.reset_kv()
    return out


def _lora_bytes(engine) -> list:
    """Each rank's LoRA buffer bytes (runner.rank_stats)."""
    return [int(r["lora_bytes"]) for r in _rank_rows(engine.runner.rank_stats())]


def _with_adapters(engine, adapters, fn):
    """``fn()`` with ``adapters`` (name, PEFT directory) loaded into the
    engine (on its loop thread, or inline when it is not running), unloaded
    after: the main path loads them again over HTTP, into the same slots."""
    for name, path in adapters:
        engine.load_lora_adapter(name, path)
    try:
        return fn()
    finally:
        for name, _ in adapters:
            engine.unload_lora_adapter(name)


def _rank_llama() -> None:
    """Register RANK_LLAMA: llama-3.2-1b cut to RANK_LAYERS layers (the
    leader hands the config to its followers)."""
    from production_stack_tpu_torch.models import llama

    llama.PRESETS[RANK_LLAMA] = dataclasses.replace(llama.PRESETS["llama-3.2-1b"], num_layers=RANK_LAYERS)


def phase_tp_reference(model: str = RANK_LLAMA, rows: int = 2, prepare=None, adapters=()) -> list:
    """tp 1's (dp 1's) logits of _tp_inputs on ``model`` (seeded weights:
    every tp and dp draws the same model), for the tp 2 server's and the dp
    forward's checks; with ``prepare``, what ``prepare(engine)`` gives. With
    ``adapters`` the engine serves LoRA with them loaded, its rows on
    LORA_ROW_SLOTS: a "lora_reference" line gives how far the adapter rows
    move from the same rows on slot 0 (more than the ranks' bar, or
    agreeing with one rank's would show nothing) and the buffers' bytes."""
    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine

    engine = LLMEngine(EngineConfig(model=model, num_pages=FORWARD_PAGES, **(RANK_LORA if adapters else {})))
    try:
        if not adapters:
            return prepare(engine) if prepare is not None else _tp_logits(engine, rows)
        return _lora_reference(engine, model, adapters, lambda: _tp_logits(engine, rows),
                               lambda: _tp_logits(engine, rows, lora=False), LORA_ROW_SLOTS[:rows])
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def _lora_reference(engine, model: str, adapters, lora_fn, base_fn, slots) -> list:
    """One rank's logits with ``adapters`` loaded (``lora_fn()``, rows on
    ``slots``), held apart from the same rows on slot 0 (``base_fn()``):
    each adapter row must move by more than FORWARD_LOGIT_BOUND, or the
    ranks' agreement with it would not show the adapter was applied."""
    t0 = time.perf_counter()
    ref = _with_adapters(engine, adapters, lora_fn)
    base = base_fn()
    LORA_ONE_RANK_BYTES[model] = _lora_bytes(engine)[0]
    rows = [r for r, slot in enumerate(slots) if slot]
    moved = {r: max(float((a[r] - b[r]).abs().max()) for a, b in zip(ref, base)) for r in rows}
    emit({"phase": "lora_reference", "model": model, "adapters": [n for n, _ in adapters], "row_slots": list(slots),
          "adapter_row_change_vs_base": moved, "bound": FORWARD_LOGIT_BOUND,
          "lora_bytes": LORA_ONE_RANK_BYTES[model], "seconds": round(time.perf_counter() - t0, 2)})
    for r, d in moved.items():
        check(d > FORWARD_LOGIT_BOUND, f"lora_reference[{model}]: row {r}'s adapter moved its logits by {d}")
    return ref


def _logits_check(ref: list, phase: str, mesh: dict, rows: int = 2, picks=None, model: str = RANK_LLAMA,
                  logits_fn=None, steps=None, adapters=(), slots=None):
    """``run(engine)``: the engine's logits of _tp_inputs (``rows`` rows) at
    ``mesh`` ({"tp": 2} or {"dp": 2}) against one rank's (``ref``) within the
    forward phases' bar, the flips printed with the reference's top-2
    margin. ``logits_fn(engine)`` and ``steps`` (their description) take the
    place of _tp_inputs' steps. With ``picks`` (a MoE reference's routes, _moe_reference) every
    rank's routers take the experts the one rank took, each rank its own
    part of them (runner.replay_routes,
    a replicated call: no token routed apart by a near-tie, PR 10's rule),
    and the line counts the (layer, token) pairs of the leader's rows where
    its own router would have picked otherwise. With ``adapters`` (the
    reference's, _lora_reference) they are loaded for the check and
    unloaded after it, the rows on ``slots`` (LORA_ROW_SLOTS by default),
    and a "lora_ranks" line holds the adapter rows alone to the same bar
    with each rank's LoRA buffer bytes against one rank's."""
    import torch

    against = " x ".join(f"{k} 1" for k in mesh) + (", its experts replayed on every rank" if picks else "")
    slots = LORA_ROW_SLOTS[:rows] if slots is None else slots

    def logits(engine):
        fn = logits_fn or (lambda e: _tp_logits(e, rows))
        if picks is None:
            return fn(engine), None
        engine.runner.replay_routes(picks)
        try:
            return fn(engine), engine.runner.route_tape
        finally:
            engine.runner.replay_routes(None)

    def run(engine):
        t0 = time.perf_counter()
        got, tape = _with_adapters(engine, adapters, lambda: logits(engine))
        if adapters:
            _lora_ranks_line(engine, got, ref, phase, mesh, model, adapters, slots, time.perf_counter() - t0)
        diffs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        top1 = float(torch.cat([a.argmax(-1) == b.argmax(-1) for a, b in zip(got, ref)]).double().mean())
        flips = []  # where the two runs' best tokens differ: the reference's two best logits there
        for s, (a, b) in enumerate(zip(got, ref)):
            for r in torch.nonzero(a.argmax(-1) != b.argmax(-1)).flatten().tolist():
                top = b[r].topk(2).values
                flips.append({"step": s, "row": r, "reference_top2_margin": float(top[0] - top[1])})
        line = {"phase": phase, "model": model, **mesh, "against": f"{against}, same run",
                "steps": steps or [f"prefill {rows} x 512 (x{TP_FORWARD_CHUNKS})",
                                   f"decode {rows} x 1 (x{TP_FORWARD_DECODES})"],
                "max_logit_diff_per_step": diffs, "argmax_flips": flips,
                "bound": FORWARD_LOGIT_BOUND, "top1_agreement": top1, "top1_min": FORWARD_TOP1_MIN,
                "finite": all(bool(torch.isfinite(x).all()) for x in got),
                "shapes": [list(x.shape) for x in got]}
        if tape is not None:
            line.update(replayed_calls=len(tape.picks), leader_router_would_differ=tape.overridden)
        emit(line)
        check(line["finite"] and line["shapes"] == [list(x.shape) for x in ref], f"{phase}: bad logits")
        # the leader's routers took every entry it replays (a stage's layers,
        # a sequence rank's tokens: runner.replay_routes)
        check(tape is None or (len(tape.picks) == len(tape.replay) > 0),
              f"{phase}: not every routed call was replayed")
        check(max(diffs) <= FORWARD_LOGIT_BOUND, f"{phase}: logit diff {max(diffs)} > {FORWARD_LOGIT_BOUND}")
        check(top1 >= FORWARD_TOP1_MIN, f"{phase}: top-1 agreement {top1} < {FORWARD_TOP1_MIN}")
        out = {"max_logit_diff": max(diffs), "top1_agreement": top1}
        if tape is not None:
            out["leader_router_would_differ"] = tape.overridden
        return out

    return run


def _lora_ranks_line(engine, got, ref, phase, mesh, model, adapters, slots, seconds) -> None:
    """The "lora_ranks" line of a logits check with adapters: the adapter
    rows' largest logit difference from one rank's, held to
    FORWARD_LOGIT_BOUND, their top-1 agreement and flips with the
    reference's top-2 margin there (the check's line holds every row's
    top-1 to FORWARD_TOP1_MIN: an adapter row alone gives as few as ten
    steps), each rank's LoRA buffer bytes against the one-rank reference's,
    and the check's seconds (loads, steps, unloads)."""
    import torch

    rows = [r for r, slot in enumerate(slots) if slot]
    diff = max(float((a[rows] - b[rows]).abs().max()) for a, b in zip(got, ref))
    top1 = float(torch.cat([a[rows].argmax(-1) == b[rows].argmax(-1) for a, b in zip(got, ref)]).double().mean())
    flips = [{"step": s, "row": r, "reference_top2_margin": float(b[r].topk(2).values.diff().abs())}
             for s, (a, b) in enumerate(zip(got, ref)) for r in rows if a[r].argmax() != b[r].argmax()]
    per_rank = _lora_bytes(engine)
    one = LORA_ONE_RANK_BYTES.get(model)
    LORA_SECONDS[f"{phase} {mesh}"] = seconds
    emit({"phase": "lora_ranks", "model": model, **mesh, "of": phase, "adapters": [n for n, _ in adapters],
          "row_slots": list(slots), "adapter_rows": rows, "max_logit_diff": diff, "top1_agreement": top1,
          "argmax_flips": flips, "bound": FORWARD_LOGIT_BOUND, "lora_bytes_by_rank": per_rank,
          "one_rank_lora_bytes": one, "rank_share_of_one_rank": [b / one for b in per_rank] if one else None,
          "seconds": round(seconds, 2), "card": nvidia_smi_line()})
    check(diff <= FORWARD_LOGIT_BOUND, f"lora_ranks[{phase} {mesh}]: adapter rows' logit diff {diff}")
    check(one is not None and len(set(per_rank)) == 1 and 0 < per_rank[0] <= one,
          f"lora_ranks[{phase} {mesh}]: LoRA bytes by rank {per_rank} against one rank's {one}")


def _dp_costs(engine) -> dict:
    """What the dp ranks move beside the forward, for one prefill chunk of
    _tp_inputs (DP_FORWARD_ROWS rows of 512) and one 8-step burst after it,
    as each rank counted it (rank_stats): its collective calls, bytes and
    host seconds, and the replica sync's gathered bytes and the pages it
    copied into the rank's replica (parallel/dp.py; the gathered buffer
    holds dp x the largest group's pages, a page being every layer's K and
    V of the rank's KV heads). Every rank must have synced in both."""
    import dataclasses as dc

    runner = engine.runner
    inps = _tp_inputs(engine.model_cfg.vocab_size, DP_FORWARD_ROWS)
    burst = dc.replace(inps[TP_FORWARD_CHUNKS], kv_limits=None)
    runner.reset_kv()
    runner.rank_stats(reset=True)
    out = {}
    for what, run in (
        ("prefill_chunk", lambda: runner.step(inps[0], want_logits=False)),
        ("burst_8", lambda: runner.step_multi(burst, 8)),
    ):
        if what == "burst_8":
            runner.step(inps[1], want_logits=False)  # the second chunk, then the burst after it
            runner.rank_stats(reset=True)
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        rows = _rank_rows(runner.rank_stats(reset=True))
        out[what] = {
            "wall_seconds": round(wall, 4),
            "sync_gathered_bytes_by_rank": [int(r["sync_bytes"]) for r in rows],
            "sync_pages_copied_in_by_rank": [int(r["sync_pages"]) for r in rows],
            "collective_calls_by_rank": [int(r["collective_calls"]) for r in rows],
            "collective_bytes_by_rank": [int(r["collective_bytes"]) for r in rows],
            "collective_seconds_by_rank": [round(r["collective_seconds"], 4) for r in rows],
        }
        check(all(r["sync_bytes"] > 0 and r["sync_pages"] > 0 for r in rows),
              f"dp_costs: a rank did not sync its replica after the {what}: {out[what]}")
    runner.reset_kv()
    return out


def phase_dp_forward(ref: list) -> None:
    """RANK_LLAMA at dp 2 (two ranks on the one card over gloo, full width,
    RANK_LAYERS layers) with RANK_ADAPTERS: its logits of four rows, two
    per dp rank, each dp group with an adapter row, against dp 1's
    (``ref``), then what a chunk and a burst move between the ranks
    ("dp_costs"; host-staged gloo, not a speed figure)."""
    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine

    engine = LLMEngine(EngineConfig(model=RANK_LLAMA, num_pages=FORWARD_PAGES, **DP2, **RANK_LORA))
    try:
        _logits_check(ref, "dp_forward", {"dp": 2}, DP_FORWARD_ROWS, adapters=RANK_ADAPTERS)(engine)
        emit({"phase": "dp_costs", "model": RANK_LLAMA, "dp": 2, "rows": DP_FORWARD_ROWS,
              "backend": "gloo (host-staged CUDA tensors)", **_dp_costs(engine), "card": nvidia_smi_line()})
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def _token_flips(ref: list, got: list) -> tuple:
    """Two runs' greedy (ids, logprob entries) per prompt, compared up to
    each prompt's first differing token (after it the prefixes differ): the
    tokens equal before a flip, the flips (with the reference's top-2
    margin there and the runs' logprob difference) and the logprob
    differences before them."""
    flips, diffs, same = [], [], 0
    for i, ((ids1, lp1), (ids2, lp2)) in enumerate(zip(ref, got)):
        j = next((j for j, (a, b) in enumerate(zip(ids1, ids2)) if a != b), len(ids1))
        same += j
        diffs += [abs(a["logprob"] - b["logprob"]) for a, b in zip(lp1[:j], lp2[:j])]
        if j < len(ids1):
            top = lp1[j]["top_logprobs"]
            flips.append({"prompt": i, "token": j, "reference_top2_margin": top[0] - top[1],
                          "logprob_diff": abs(lp1[j]["logprob"] - lp2[j]["logprob"])})
    return same, flips, diffs


def phase_f32_tokens(phase: str, overrides: dict, n_prompts: int, together: bool, base: str = RANK_LLAMA,
                     lora: bool = True) -> None:
    """An f32 copy of ``base`` (RANK_LLAMA by default; its preset at
    float32, added here; the leader hands the config to its followers):
    greedy tokens through the engine at ``overrides`` (tp 2, dp 2, pp 2, sp
    2 or tp 4) against one rank's for TP_F32_TOKENS tokens, ``n_prompts``
    prompts, one after another or, with ``together``, queued at once
    (``_together``: at dp 2 both dp groups hold rows). With ``lora`` both
    engines serve LoRA with RANK_ADAPTERS loaded, the prompts under
    F32_LORA_NAMES (base and adapters mixed). A token that differs must sit
    where the reference's two best tokens are within TP_NEAR_TIE: its
    margin and the runs' logprob difference are printed."""
    import random

    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.models import llama

    name = f"{base}-f32"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS[base], dtype=torch.float32)
    rng = random.Random(13)
    prompts = [_prompt(rng, 300 + 400 * (i % 2) + 37 * (i // 2)) for i in range(n_prompts)]
    names = F32_LORA_NAMES[:n_prompts] if lora else (None,) * n_prompts
    runs = {}
    t0 = time.perf_counter()
    for parallel in (False, True):
        engine = LLMEngine(EngineConfig(model=name, num_pages=128, decode_steps=8, **(RANK_LORA if lora else {}),
                                        **(overrides if parallel else {})))
        for adapter, path in RANK_ADAPTERS if lora else ():
            engine.load_lora_adapter(adapter, path)
        engine.start()
        try:
            if parallel:
                engine.runner.rank_stats(reset=True)

            async def go():
                if together:
                    return await _together(engine, prompts, names, max_tokens=TP_F32_TOKENS)
                return [await _engine_greedy(engine, f"f32-{parallel}-{i}", p, m, max_tokens=TP_F32_TOKENS)
                        for i, (p, m) in enumerate(zip(prompts, names))]

            runs[parallel] = asyncio.run(go())
            if parallel:
                ranks = _rank_rows(engine.runner.rank_stats())
        finally:
            engine.stop()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    same, flips, diffs = _token_flips(runs[False], runs[True])
    mesh = {k: overrides.get(f, 1) for k, f in (("pp", "pipeline_parallel_size"), ("dp", "data_parallel_size"),
                                                ("sp", "sequence_parallel_size"), ("tp", "tensor_parallel_size"))}
    line = {"phase": phase, "model": name, **mesh, "tokens_per_prompt": TP_F32_TOKENS,
            "prompts": len(prompts), "adapters": names, "concurrent": together,
            "tokens_equal_before_a_flip": same, "flips": flips,
            "near_tie": TP_NEAR_TIE, "logprob_max_diff_before_a_flip": max(diffs, default=0.0),
            "launches_by_rank": [{k: int(r[k]) for k in ("decode_attention", "prefill_attention", "kv_page_write")}
                                 for r in ranks],
            "seconds": round(time.perf_counter() - t0, 2)}
    emit(line)
    check(all(len(ids) == TP_F32_TOKENS for run in runs.values() for ids, _ in run), f"{phase}: short output")
    for f in flips:
        check(f["reference_top2_margin"] <= TP_NEAR_TIE, f"{phase}: a token flipped away from a near-tie: {f}")
    for r, counts in enumerate(line["launches_by_rank"]):
        # at sp a chunk goes through the ring: no prefill kernel, no write
        want = {k: n for k, n in counts.items() if mesh["sp"] == 1 or k == "decode_attention"}
        check(all(n > 0 for n in want.values()), f"{phase}: rank {r} launched {counts}")
        check(mesh["sp"] == 1 or counts["prefill_attention"] == counts["kv_page_write"] == 0,
              f"{phase}: a sequence rank ran the prefill kernel: {counts}")


def _tp_qwen_slices(seed: int = 0):
    """``prepare`` for the tp 2 qwen2.5-7b server: the sampled parameters,
    joined from both ranks' slices (runner.gathered_params), byte-identical
    to the tensors written."""
    import torch

    specs = _qwen2_hf_specs(QWEN_WRITTEN_CONFIG, torch.bfloat16)

    def run(engine):
        got = engine.runner.gathered_params([p for p, _, _ in QWEN_SAMPLES])
        same = {}
        for pname, hf, transpose in QWEN_SAMPLES:
            want = _hf_value(hf, *specs[hf], seed).cpu()
            same[pname] = _same_bytes(got[pname], (want.t() if transpose else want).contiguous())
        emit({"phase": "tp_hf_load", "model": "qwen2.5-7b", "tp": 2, "rank_slices_byte_identical": same})
        check(all(same.values()), f"tp_hf_load[qwen2.5-7b]: a rank's slice differs from what was written: {same}")
        return same

    return run


def _time_ms(fn, iters=30, warmup=3) -> float:
    """Median device ms of one call, CUDA events around each launch. Before
    each launch a 128 MB read evicts the 50 MB L2 (a read, so no write-back
    of the flush competes with the timed launch), then a ~0.5 ms spin on
    the card holds the start event back until the host has enqueued the
    call: the wrapper's Python time never lands between the two events."""
    import torch

    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def _bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


SMALL_BATCH_DECODE = (DECODE_B1_2K, DECODE_B8_1K, DECODE_B1_8K)
# gemma-2-2b at one row of 8,192: a sliding layer (4,096 keys visible) and
# a global one
GEMMA_WINDOW_DECODE = (GEMMA_DECODE_B1_8K_SLIDING, GEMMA_DECODE_B1_8K_GLOBAL)


def _decode_timing(case_name: str, quant: bool) -> dict:
    """The decode kernel, its plain version and SDPA on one decode case's
    inputs (int8 pools and scales for ``quant``), beside the byte bound.
    The bound and the yardstick read only the keys the window leaves
    visible."""
    import torch
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops.attention import gather_kv_pages
    from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_ref
    from production_stack_tpu_torch.ops.quant import gather_kv_pages_quant

    bf16 = torch.bfloat16
    case = dict(dict(DECODE_CASES)[case_name], dtype=bf16, quant=quant)
    for k in ("tp", "dp", "ep", "pp", "sp", "kh"):  # a rank's shapes: the same kernel on its rows and heads
        case.pop(k, None)
    B, NH, KH, D, page, maxp = (case[k] for k in ("B", "NH", "KH", "D", "page", "maxp"))
    lens, C, cur = case["lens"], case["C"], case["cur_lens"]
    window = case.get("window") or (1 << 30)
    G = NH // KH
    args, kw = decode_case(case.pop("seed"), **case)
    q, kp, vp, pt, _ = args
    ms = _time_ms(lambda: decode_attention(*args, **kw))
    plain = _time_ms(lambda: decode_attention_ref(*args, **kw))
    if quant:  # the yardstick reads KV dequantized beforehand (the dequant is not timed)
        kg, vg = gather_kv_pages_quant(kp[0], vp[0], kw["k_scales"][0], kw["v_scales"][0], pt, dtype=bf16)
    else:
        kg, vg = gather_kv_pages(kp[0], vp[0], pt)
    ctx = lens[0]  # the timed cases have rows of one length and full windows
    lo = max(ctx - window, 0)  # first visible position
    k_all = torch.cat([kg[:, lo: ctx - C], kw["k_cur"]], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    v_all = torch.cat([vg[:, lo: ctx - C], kw["v_cur"]], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    lib = _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], k_all, v_all, scale=kw["sm_scale"]))
    el = 2
    # visible pool slots [max(n - window, 0), n - c) per row, over all rows
    hist = sum(max(0, (n - c) - max(n - window, 0)) for n, c in zip(lens, cur))
    kv_el = 1 if quant else el
    pages = sum(-(-(n - c) // page) - max(n - window, 0) // page for n, c in zip(lens, cur))
    nbytes = (2 * B * NH * D * el + 2 * hist * KH * D * kv_el + (2 * pages * KH * 4 if quant else 0)
              + 2 * sum(cur) * KH * D * el + pt.numel() * 4 + 2 * B * 4)
    b_ms, b_by = _bound(nbytes, 4 * NH * D * (hist + sum(cur)))
    pool = "int8 pool, bf16 q/window" if quant else "bf16"
    extra = "" if case.get("window") is None else f" window={case['window']}"
    extra += "" if case.get("softcap") is None else f" softcap={case['softcap']} sm_scale={kw['sm_scale']:.6g}"
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                shape=f"B={B} ctx={ctx} C={C} NH={NH} KH={KH} D={D} page={page}{extra} {pool}",
                library="scaled_dot_product_attention over the visible gathered KV, heads repeated"
                        + (", no softcap" if case.get("softcap") else "")
                        + (" (KV dequantized to bf16 beforehand, not timed)" if quant else ""))


def _prefill_timing(case_name: str, quant: bool) -> tuple[dict, dict]:
    """The prefill kernel, its plain version and SDPA with a causal-offset
    (and window) mask on one prefill case, beside the bound; the same launch
    with the chunk's write is timed in the same process. Returns the row and
    what the write row needs: the case's inputs, the launch's times with and
    without the write, and the attention's bytes and operations."""
    import torch
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops.attention import gather_kv_pages
    from production_stack_tpu_torch.ops.kernels.prefill_attention import prefill_attention, prefill_attention_ref
    from production_stack_tpu_torch.ops.quant import gather_kv_pages_quant

    bf16 = torch.bfloat16
    case = dict(dict(PREFILL_CASES)[case_name], dtype=bf16, quant=quant)
    for k in ("tp", "dp", "ep", "pp", "kh", "row"):
        case.pop(k, None)
    B, NH, KH, D, page, T = (case[k] for k in ("B", "NH", "KH", "D", "page", "T"))
    hist = case["computed"][0]  # the timed cases' rows hold one history and one chunk length each
    window = case.get("window") or (1 << 30)
    G = NH // KH
    args, kw = prefill_case(case.pop("seed"), **case)
    q, kp, vp, pt, pos, lens, kc, vc, cl = args
    ms = _time_ms(lambda: prefill_attention(*args, **kw))
    # the chunk's write rewrites the same bytes each call (fresh pages only)
    fused = _time_ms(lambda: prefill_attention(*args, fused_write=True, **kw))
    plain = _time_ms(lambda: prefill_attention_ref(*args, **kw))
    if quant:
        kg, vg = gather_kv_pages_quant(kp[0], vp[0], kw["k_scales"][0], kw["v_scales"][0], pt, dtype=bf16)
    else:
        kg, vg = gather_kv_pages(kp[0], vp[0], pt)
    kk = torch.cat([kg[:, :hist], kc], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vv = torch.cat([vg[:, :hist], vc], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    qq = q.transpose(1, 2).contiguous()
    kpos = torch.arange(hist + T, device="cuda")[None, :]
    qpos = hist + torch.arange(T, device="cuda")[:, None]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    lib = _time_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=kw["sm_scale"]))
    el = 2
    pairs = sum(min(hist + t + 1, window) for t in range(T))  # visible (query, key) pairs per head
    h_vis = hist - max(hist - window + 1, 0)  # history slots any query sees
    kv_bytes = 2 * h_vis * KH * D + 2 * (h_vis // page) * KH * 4 if quant else 2 * h_vis * KH * D * el
    nbytes = B * (2 * T * NH * D * el + kv_bytes + 2 * T * KH * D * el + T * 4 + 8) + pt.numel() * 4
    flops = B * 4 * NH * D * pairs
    b_ms, b_by = _bound(nbytes, flops)
    extra = "" if case.get("window") is None else f" window={case['window']}"
    extra += "" if case.get("softcap") is None else f" softcap={case['softcap']} sm_scale={kw['sm_scale']:.6g}"
    pool = "int8 history, bf16 q/chunk" if quant else "bf16"
    row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
               shape=f"B={B} T={T} history={hist} NH={NH} KH={KH} D={D} page={page}{extra} {pool}",
               library=("scaled_dot_product_attention over history dequantized to bf16 beforehand (dequant not "
                        "timed), causal-offset mask" if quant else
                        "scaled_dot_product_attention with a causal-offset mask")
                       + (", no softcap" if case.get("softcap") else ""),
               ms_is="the launch without the chunk's write (fused_write=False)")
    return row, dict(args=args, kw=kw, attention_ms=ms, fused_ms=fused, nbytes=nbytes, flops=flops)


def _write_timing(p: dict, quant: bool) -> dict:
    """The chunk's KV write (fp: into the slots after the history; int8:
    quantized into its fresh pages) as it runs now, inside the prefill
    launch: its time is the launch's with the write less the launch's
    without, beside the write's own byte bound; the whole launch's time
    beside its bound (the attention's, with the pools' written bytes
    added). Also the write's plain version and, for fp, the index_copy_
    yardstick."""
    from production_stack_tpu_torch.ops.kernels.prefill_attention import kv_page_write_quant_ref, kv_page_write_ref

    args, kw = p["args"], p["kw"]
    q, kp, vp, pt, pos, lens, kc, vc, cl = args
    _, T, KH, D = kc.shape
    page = kp.shape[2]
    el = 2
    if quant:
        skw = dict(k_scales=kw["k_scales"], v_scales=kw["v_scales"])
        plain = _time_ms(lambda: kv_page_write_quant_ref(kc, vc, lens, cl, pt, kp, vp, layer=0, **skw))
        lib = None
        n_pages = T // page
        written = 2 * n_pages * page * KH * D + 2 * n_pages * KH * 4
        read = 2 * T * KH * D * el + 8 + pt.numel() * 4
        shape = f"T={T} into {n_pages} fresh pages, KH={KH} D={D} page={page} bf16 -> int8"
        library = "none: no single PyTorch call quantizes per page and scatters"
    else:
        plain = _time_ms(lambda: kv_page_write_ref(kc, vc, pos, cl, pt, kp, vp, layer=0))
        p0 = pos[0].long()
        slots = pt[0, p0 // page].long() * page + p0 % page
        kflat, vflat = kp[0].view(-1, KH, D), vp[0].view(-1, KH, D)
        lib = _time_ms(lambda: (kflat.index_copy_(0, slots, kc[0]), vflat.index_copy_(0, slots, vc[0])))
        written = 2 * T * KH * D * el
        read = 2 * T * KH * D * el + T * 4 + pt.numel() * 4
        shape = f"T={T} KH={KH} D={D} page={page} bf16"
        library = "index_copy_ into the flat pool, K and V"
    b_ms, b_by = _bound(read + written, 0.0)
    f_ms, f_by = _bound(p["nbytes"] + written, p["flops"])
    return dict(ms=p["fused_ms"] - p["attention_ms"], plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                ms_is="fused_ms - attention_ms: the launch with the chunk's write less the launch without",
                attention_ms=p["attention_ms"], fused_ms=p["fused_ms"], fused_bound_ms=f_ms, fused_bound_by=f_by,
                shape=shape, library=library)


def phase_timing() -> dict:
    """Every kernel row at its model's main-path shapes: llama-3.2-1b's
    (D = 64), qwen2.5-7b's ("[d128]") and gemma-2-2b's ("[d256]"), fp and
    int8 pools; then the decode kernel at small batch, qwen2.5-7b's and
    gemma-2-2b's 1 x 8,192 (a sliding and a global layer), and opt-125m's
    decode and prefill (bf16, its only pool dtype), as rows of their own."""
    rows = {}
    for D, dec, pre in ((64, MAIN_DECODE, MAIN_PREFILL), (128, QWEN_DECODE, QWEN_PREFILL),
                        (256, GEMMA_DECODE, GEMMA_PREFILL)):
        for quant in (False, True):
            rows[_kernel_name("decode_attention", quant, D)] = _decode_timing(dec, quant)
            row, fused = _prefill_timing(INT8 + pre if quant else pre, quant)
            rows[_kernel_name("prefill_attention", quant, D)] = row
            rows[_dtag("kv_page_write_quant" if quant else "kv_page_write", D)] = _write_timing(fused, quant)
    # the tp = 2 ranks' rows: llama-3.2-1b's heads in both pool modes,
    # qwen2.5-7b's in bf16
    for D, quant in TP_SERVED:
        dec, pre = (TP_DECODE, TP_PREFILL) if D == 64 else (TP_QWEN_DECODE, TP_QWEN_PREFILL)
        rows[_kernel_name("decode_attention", quant, D, 2)] = _decode_timing(dec, quant)
        row, fused = _prefill_timing(INT8 + pre if quant else pre, quant)
        rows[_kernel_name("prefill_attention", quant, D, 2)] = row
        rows[_kernel_name("kv_page_write_quant" if quant else "kv_page_write", False, D, 2)] = _write_timing(fused, quant)
    # a dp 2 rank's decode: 16 rows of the 32 x 1,024 burst step, llama-3.2-1b's
    # heads and mixtral-8x7b's
    rows[DP_ROW] = _decode_timing(DP_DECODE, False)
    rows[DP_MIXTRAL_ROW] = _decode_timing(DP_MIXTRAL_DECODE, False)
    # an ep 2 x tp 2 rank of mixtral-8x7b: its decode burst step and its
    # prefill chunk at its tp place's heads
    for row, base in EP_ROWS.items():
        rows[row] = (_decode_timing(EP_DECODE, False) if base.startswith("decode")
                     else _prefill_timing(EP_PREFILL, False)[0])
    # llama-3.2-1b's pipeline stages: a stage's decode of one 8-row
    # microbatch and its prefill chunk, on the stage's 8-layer pool
    for row, (base, tp) in PP_ROWS.items():
        case = PP_CASES[(tp, base)]
        rows[row] = _decode_timing(case, False) if base.startswith("decode") else _prefill_timing(case, False)[0]
    # llama-3.2-1b's sequence ranks: the long prompt's last decode step on
    # the rank's replica of the pool, all heads (sp 2) or the tp place's
    for row, tp in SP_ROWS.items():
        rows[row] = _decode_timing(SP_CASES[tp], False)
    # Qwen2.5-1.5B's tp 4 rank (3 query heads on a shared KV head) and
    # mixtral-8x7b's pp 2 x ep 2 stage and sp 2 x ep 2 sequence ranks
    for row, base in KH_ROWS.items():
        rows[row] = _decode_timing(KH_DECODE, False) if base.startswith("decode") else _prefill_timing(
            KH_PREFILL, False)[0]
    for row, base in PP_EP_ROWS.items():
        rows[row] = _decode_timing(PP_EP_DECODE, False) if base.startswith("decode") else _prefill_timing(
            PP_EP_PREFILL, False)[0]
    for row in SP_EP_ROWS:
        rows[row] = _decode_timing(SP_EP_DECODE, False)
    # sequence ranks beside dp and pp ranks: a dp 2 x sp 2 rank's burst
    # step, a pp 2 x sp 2 stage rank's microbatch, and the verify forward
    # on a stage's pool (pp 2 with speculative_k)
    rows[DP_SP_ROW] = _decode_timing(DP_SP_DECODE, False)
    rows[PP_SP_ROW] = _decode_timing(PP_SP_DECODE, False)
    row, fused = _prefill_timing(VERIFY_PP_LLAMA, False)
    rows[VERIFY_PP_ROW] = dict(row, fused_ms=fused["fused_ms"])
    # step_spec's verify forward (llama-3.2-1b's heads; gemma-2-2b's below)
    row, fused = _prefill_timing(VERIFY_LLAMA, False)
    rows[VERIFY_ROW] = dict(row, fused_ms=fused["fused_ms"])
    for name, r in rows.items():
        emit({"phase": "timing", "kernel": name, **r})
    for case in SMALL_BATCH_DECODE + (QWEN_DECODE_B1_8K,) + GEMMA_WINDOW_DECODE:
        for quant in (False, True):
            D = dict(DECODE_CASES)[case]["D"]
            emit({"phase": "timing", "kernel": _kernel_name("decode_attention", quant, D), "case": case,
                  **_decode_timing(case, quant)})
    emit({"phase": "timing", "kernel": "decode_attention", "case": OPT_DECODE, **_decode_timing(OPT_DECODE, False)})
    emit({"phase": "timing", "kernel": "prefill_attention", "case": OPT_PREFILL,
          **_prefill_timing(OPT_PREFILL, False)[0]})
    for case in (VERIFY_GEMMA_SLIDING, VERIFY_GEMMA_GLOBAL):
        row, fused = _prefill_timing(case, False)
        emit({"phase": "timing", "kernel": "prefill_attention[d256]", "case": case, **row,
              "fused_ms": fused["fused_ms"]})
    for quant in (False, True):
        emit({"phase": "timing", "kernel": _kernel_name("decode_attention", quant, 128), "case": MIXTRAL_DECODE,
              **_decode_timing(MIXTRAL_DECODE, quant)})
        emit({"phase": "timing", "kernel": _kernel_name("prefill_attention", quant, 128), "case": MIXTRAL_PREFILL,
              **_prefill_timing(INT8 + MIXTRAL_PREFILL if quant else MIXTRAL_PREFILL, quant)[0]})
    return rows


# ---------------------------------------------------------------------------
# HF checkpoints: written from a seed as HF lays them out, then loaded and
# served through the port's loader


HF_ROOT = ROOT / "build" / "hf_models"
QWEN_DIR = HF_ROOT / "qwen2.5-7b"
OPT_DIR = HF_ROOT / "opt-125m"
HF_SHARD_BYTES = 5 * 10**9  # save_pretrained's default max_shard_size
# Qwen/Qwen2.5-7B's config.json as published
QWEN_HF_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 151643,
    "eos_token_id": 151643, "hidden_act": "silu", "hidden_size": 3584, "initializer_range": 0.02,
    "intermediate_size": 18944, "max_position_embeddings": 131072, "max_window_layers": 28, "model_type": "qwen2",
    "num_attention_heads": 28, "num_hidden_layers": 28, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 131072, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "use_mrope": False, "use_sliding_window": False, "vocab_size": 152064,
}
# the directory holds QWEN_LAYERS of its 28 layers (all of them until the
# multi-host phase grew the smoke, 8 until the shared-head and Mixtral
# stage and sequence phases did: the cuts keep it inside its time limit)
QWEN_LAYERS = 4
QWEN_WRITTEN_CONFIG = dict(QWEN_HF_CONFIG, num_hidden_layers=QWEN_LAYERS)
# facebook/opt-125m's config.json as published (its weights are float16)
OPT_HF_CONFIG = {
    "activation_dropout": 0.0, "activation_function": "relu", "architectures": ["OPTForCausalLM"],
    "attention_dropout": 0.0, "bos_token_id": 2, "do_layer_norm_before": True, "dropout": 0.1, "eos_token_id": 2,
    "ffn_dim": 3072, "hidden_size": 768, "init_std": 0.02, "layerdrop": 0.0, "max_position_embeddings": 2048,
    "model_type": "opt", "num_attention_heads": 12, "num_hidden_layers": 12, "pad_token_id": 1, "prefix": "</s>",
    "torch_dtype": "float16", "use_cache": True, "vocab_size": 50272, "word_embed_proj_dim": 768,
}
# the sampled parameters held byte-identical to what was written:
# (port name, HF name, transposed); layer 3 of 4
_L = "model.layers.3."
QWEN_SAMPLES = (
    ("embed", "model.embed_tokens.weight", False),
    ("layers.3.wq", _L + "self_attn.q_proj.weight", True),
    ("layers.3.bq", _L + "self_attn.q_proj.bias", False),
    ("layers.3.wk", _L + "self_attn.k_proj.weight", True),
    ("layers.3.w_down", _L + "mlp.down_proj.weight", True),
    ("lm_head", "lm_head.weight", True),
)


def _qwen2_hf_specs(c: dict, dtype) -> dict:
    """HF's Qwen2ForCausalLM tensors, {name: (shape, dtype)}, matrices [out, in]."""
    H, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    NH, KH = c["num_attention_heads"], c["num_key_value_heads"]
    q, kv = NH * (H // NH), KH * (H // NH)
    specs = {"model.embed_tokens.weight": (V, H)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs.update({
            p + "input_layernorm.weight": (H,),
            p + "self_attn.q_proj.weight": (q, H), p + "self_attn.q_proj.bias": (q,),
            p + "self_attn.k_proj.weight": (kv, H), p + "self_attn.k_proj.bias": (kv,),
            p + "self_attn.v_proj.weight": (kv, H), p + "self_attn.v_proj.bias": (kv,),
            p + "self_attn.o_proj.weight": (H, q),
            p + "post_attention_layernorm.weight": (H,),
            p + "mlp.gate_proj.weight": (I, H), p + "mlp.up_proj.weight": (I, H), p + "mlp.down_proj.weight": (H, I),
        })
    specs["model.norm.weight"] = (H,)
    if not c.get("tie_word_embeddings"):
        specs["lm_head.weight"] = (V, H)
    return {k: (v, dtype) for k, v in specs.items()}


def _opt_hf_specs(c: dict, dtype) -> dict:
    """HF's OPTForCausalLM tensors (the head is tied: no lm_head)."""
    H, I = c["hidden_size"], c["ffn_dim"]
    specs = {"model.decoder.embed_tokens.weight": (c["vocab_size"], H),
             "model.decoder.embed_positions.weight": (c["max_position_embeddings"] + 2, H)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.decoder.layers.{i}."
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            specs.update({p + f"self_attn.{proj}.weight": (H, H), p + f"self_attn.{proj}.bias": (H,)})
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            specs.update({p + f"{norm}.weight": (H,), p + f"{norm}.bias": (H,)})
        specs.update({p + "fc1.weight": (I, H), p + "fc1.bias": (I,), p + "fc2.weight": (H, I), p + "fc2.bias": (H,)})
    specs.update({"model.decoder.final_layer_norm.weight": (H,), "model.decoder.final_layer_norm.bias": (H,)})
    return {k: (v, dtype) for k, v in specs.items()}


def _hf_value(name: str, shape, dtype, seed: int, device="cuda"):
    """A tensor of the checkpoint at init_params' scales, drawn on the card
    from a seed and the tensor's name: norm weights 1, matrices (and
    embeddings) N(0, 1/in) of HF's [out, in]; biases N(0, 0.02^2), not 0,
    so the byte check of a bias reads real values."""
    import zlib

    import torch

    if len(shape) == 1 and "norm" in name and name.endswith("weight"):
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + zlib.crc32(name.encode()))
    scale = 0.02 if len(shape) == 1 else shape[1] ** -0.5
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(scale).to(dtype)


def phase_hf_write(path: Path, config: dict, specs: dict, seed: int = 0) -> dict:
    """Write an HF directory: config.json and the seeded tensors in shards of
    at most 5 GB with HF's index. Fails, with the free bytes it found, when
    the disk cannot hold it."""
    from production_stack_tpu_torch.utils.safetensors_io import save_sharded

    nbytes = sum(math.prod(shape) * dt.itemsize for shape, dt in specs.values())
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    free = shutil.disk_usage(path).free
    check(free > nbytes + (1 << 30), f"hf_write[{path.name}]: {nbytes} bytes to write, {free} bytes free at {path}")
    t0 = time.perf_counter()
    (path / "config.json").write_text(json.dumps(config, indent=2))
    files = save_sharded(str(path), specs, lambda n: _hf_value(n, specs[n][0], specs[n][1], seed), HF_SHARD_BYTES)
    secs = time.perf_counter() - t0
    line = {"phase": "hf_write", "model": path.name, "tensors": len(specs), "bytes": nbytes, "files": files,
            "free_bytes_before": free, "seconds": round(secs, 2), "gb_per_s": round(nbytes / secs / 1e9, 3)}
    emit(line)
    return line


def phase_hf_qwen(seed: int = 0) -> None:
    """qwen2.5-7b at full width, QWEN_LAYERS of its 28 layers: its HF
    directory written (bf16, sharded), loaded through the port's loader,
    its config held to the port's preset at that depth, sampled parameters
    held byte-identical to the tensors written (transposes included), then
    its kernel forward against its plain forward (phase_forward), bf16 and
    int8 pools."""
    import dataclasses

    import torch

    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.models import llama

    specs = _qwen2_hf_specs(QWEN_WRITTEN_CONFIG, torch.bfloat16)
    written = phase_hf_write(QWEN_DIR, QWEN_WRITTEN_CONFIG, specs, seed)
    t0 = time.perf_counter()
    mod, cfg, net = load_model(str(QWEN_DIR), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    preset = dataclasses.replace(llama.PRESETS["qwen2.5-7b"], num_layers=QWEN_LAYERS,
                                 max_model_len=cfg.max_model_len)
    own = dict(net.named_parameters())
    same = {}
    for pname, hf, transpose in QWEN_SAMPLES:
        want = _hf_value(hf, *specs[hf], seed)
        same[pname] = _same_bytes(own[pname], (want.t() if transpose else want).contiguous())
    emit({"phase": "hf_load", "model": "qwen2.5-7b", "module": mod.__name__, "seconds": round(load_s, 2),
          "gb_per_s": round(written["bytes"] / load_s / 1e9, 3), "config_equals_preset": cfg == preset,
          "max_model_len": cfg.max_model_len, "parameters": sum(p.numel() for p in own.values()),
          "samples_byte_identical": same})
    check(mod is llama and cfg == preset, f"hf_load[qwen2.5-7b]: config {cfg} differs from the preset {preset}")
    check(all(same.values()), f"hf_load[qwen2.5-7b]: parameters differ from the tensors written: {same}")
    phase_forward("qwen2.5-7b-hf", QWEN_FORWARD_CHUNKS, model=net)


# mistralai/Mixtral-8x7B-v0.1's config.json as published. Its 32 layers
# (93.4 GB in bf16) do not fit the card's 80 GB: the directory holds 4
# (16 until the LoRA rank serves grew the smoke, 8 until the multi-host
# phase did: each cut keeps it inside its time limit), leaving room for
# the pools, the dense expert products and the plain forward the check
# runs in the same process
MIXTRAL_DIR = HF_ROOT / "mixtral-8x7b"
MIXTRAL_HF_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 1, "eos_token_id": 2,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "model_type": "mixtral", "num_attention_heads": 32, "num_experts_per_tok": 2,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "num_local_experts": 8, "output_router_logits": False,
    "rms_norm_eps": 1e-05, "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000,
}
MIXTRAL_LAYERS = 4
MIXTRAL_FORWARD_CHUNKS = 2
_M = "model.layers.3."
MIXTRAL_SAMPLES = (
    ("embed", "model.embed_tokens.weight", False, None),
    ("layers.3.wk", _M + "self_attn.k_proj.weight", True, None),
    ("layers.3.moe_router", _M + "block_sparse_moe.gate.weight", True, None),
    ("layers.3.moe_gate", _M + "block_sparse_moe.experts.3.w1.weight", True, 3),
    ("layers.3.moe_up", _M + "block_sparse_moe.experts.0.w3.weight", True, 0),
    ("layers.3.moe_down", _M + "block_sparse_moe.experts.5.w2.weight", True, 5),
    ("lm_head", "lm_head.weight", True, None),
)


def _mixtral_hf_specs(c: dict, dtype) -> dict:
    """HF's MixtralForCausalLM tensors, {name: (shape, dtype)}, matrices [out, in]."""
    H, I, V, E = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_local_experts"]
    NH, KH = c["num_attention_heads"], c["num_key_value_heads"]
    q, kv = NH * (H // NH), KH * (H // NH)
    specs = {"model.embed_tokens.weight": (V, H)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs.update({
            p + "input_layernorm.weight": (H,),
            p + "self_attn.q_proj.weight": (q, H), p + "self_attn.k_proj.weight": (kv, H),
            p + "self_attn.v_proj.weight": (kv, H), p + "self_attn.o_proj.weight": (H, q),
            p + "post_attention_layernorm.weight": (H,),
            p + "block_sparse_moe.gate.weight": (E, H),
        })
        for e in range(E):
            x = p + f"block_sparse_moe.experts.{e}."
            specs.update({x + "w1.weight": (I, H), x + "w2.weight": (H, I), x + "w3.weight": (I, H)})
    specs.update({"model.norm.weight": (H,), "lm_head.weight": (V, H)})
    return {k: (v, dtype) for k, v in specs.items()}


def _host_bytes_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    fail("/proc/meminfo has no MemAvailable")


def phase_hf_mixtral(seed: int = 0):
    """mixtral-8x7b at full width, MIXTRAL_LAYERS of its 32 layers: the
    free disk and host memory printed (the phase fails if the disk cannot
    hold the directory), then its HF directory written (bf16, sharded),
    loaded through the port's loader, its config held to the preset at that
    depth, sampled parameters (expert slices included) held byte-identical
    to the tensors written, then its kernel forward against its plain
    forward (phase_forward), bf16 and int8 pools."""
    import torch

    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.models import llama

    HF_ROOT.mkdir(parents=True, exist_ok=True)
    free, host = shutil.disk_usage(HF_ROOT).free, _host_bytes_available()
    layer_bytes = sum(math.prod(shape) * 2 for name, (shape, _) in _mixtral_hf_specs(
        dict(MIXTRAL_HF_CONFIG, num_hidden_layers=1), torch.bfloat16).items() if name.startswith("model.layers."))
    rest = 2 * MIXTRAL_HF_CONFIG["vocab_size"] * MIXTRAL_HF_CONFIG["hidden_size"] * 2
    need = rest + MIXTRAL_LAYERS * layer_bytes + (2 << 30)  # and 2 GiB to spare
    emit({"phase": "hf_room", "model": "mixtral-8x7b", "free_disk_bytes": free, "host_available_bytes": host,
          "bytes_per_layer": layer_bytes, "layers": MIXTRAL_LAYERS, "disk_bytes_needed": need})
    check(free >= need, f"hf_room[mixtral-8x7b]: {free} bytes free on disk, {MIXTRAL_LAYERS} layers need {need}")
    layers = MIXTRAL_LAYERS
    config = dict(MIXTRAL_HF_CONFIG, num_hidden_layers=layers)
    specs = _mixtral_hf_specs(config, torch.bfloat16)
    written = phase_hf_write(MIXTRAL_DIR, config, specs, seed)
    t0 = time.perf_counter()
    mod, cfg, net = load_model(str(MIXTRAL_DIR), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    preset = dataclasses.replace(llama.PRESETS["mixtral-8x7b"], num_layers=layers, max_model_len=cfg.max_model_len)
    own = dict(net.named_parameters())
    same = {}
    for pname, hf, transpose, expert in MIXTRAL_SAMPLES:
        want = _hf_value(hf, *specs[hf], seed)
        got = own[pname] if expert is None else own[pname][expert]
        same[hf] = _same_bytes(got.contiguous(), (want.t() if transpose else want).contiguous())
    emit({"phase": "hf_load", "model": "mixtral-8x7b", "module": mod.__name__, "layers": layers,
          "seconds": round(load_s, 2), "gb_per_s": round(written["bytes"] / load_s / 1e9, 3),
          "config_equals_preset_at_depth": cfg == preset, "parameters": sum(p.numel() for p in own.values()),
          "samples_byte_identical": same, "device_bytes_allocated": torch.cuda.memory_allocated()})
    check(mod is llama and cfg == preset, f"hf_load[mixtral-8x7b]: config {cfg} differs from the preset {preset}")
    check(all(same.values()), f"hf_load[mixtral-8x7b]: parameters differ from the tensors written: {same}")
    del own
    phase_forward("mixtral-8x7b-hf", MIXTRAL_FORWARD_CHUNKS, model=net)


# -- KV heads shared by tp ranks: Qwen2.5-1.5B at tp 4 --------------------------

QWEN15_DIR = HF_ROOT / "qwen2.5-1.5b"
# Qwen/Qwen2.5-1.5B's config.json as published: 12 query heads over 2 KV
# heads, so at tp 4 each KV head is shared by 2 ranks
QWEN15_HF_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 151643,
    "eos_token_id": 151643, "hidden_act": "silu", "hidden_size": 1536, "initializer_range": 0.02,
    "intermediate_size": 8960, "max_position_embeddings": 131072, "max_window_layers": 28, "model_type": "qwen2",
    "num_attention_heads": 12, "num_hidden_layers": 28, "num_key_value_heads": 2, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 131072, "tie_word_embeddings": True, "torch_dtype": "bfloat16",
    "use_cache": True, "use_mrope": False, "use_sliding_window": False, "vocab_size": 151936,
}
# 4 of its 28 layers, as RANK_LLAMA is cut for the rank phases
QWEN15_LAYERS = 4
QWEN15_WRITTEN_CONFIG = dict(QWEN15_HF_CONFIG, num_hidden_layers=QWEN15_LAYERS)
# the same shape as a seeded preset, whose f32 copy gives the greedy tokens
QWEN15_PRESET = f"qwen2.5-1.5b-l{QWEN15_LAYERS}"
TP4 = dict(tensor_parallel_size=4, tp_backend="gloo", tp_device_ids="0,0,0,0")


def _first_chunk_page(engine) -> list:
    """Page 0 (row 0's first 64 tokens, every layer and KV head) as the
    engine gathers it after _tp_inputs' first chunk; the pools are reset
    after."""
    runner = engine.runner
    runner.reset_kv()
    runner.step(_tp_inputs(engine.model_cfg.vocab_size)[0], want_logits=False)
    page = [x[0] for x in runner.get_pages([0])]
    runner.reset_kv()
    return page


def _shared_reference(engine) -> tuple:
    """``prepare`` for the tp 1 engine: its logits of _tp_inputs and its
    page 0 after the first chunk."""
    return _tp_logits(engine), _first_chunk_page(engine)


def _shared_heads_check(ref_logits: list, ref_page: list):
    """``prepare`` for the tp 4 server: its logits against tp 1's
    ("shared_heads", the forward phases' bar), then the pages: its page 0
    after the first chunk, gathered over the ranks, has the model's 2 KV
    heads (one replica of each, not 4) in tp 1's layout, beside tp 1's
    page; tp 1's page written into every rank reads back byte for byte;
    the two ranks of each share hold byte-identical pools, the two shares
    different ones; each rank's pool is one KV head, half tp 1's bytes
    ("shared_heads_pages")."""
    import numpy as np

    def run(engine):
        out = _logits_check(ref_logits, "shared_heads", {"tp": 4}, model="qwen2.5-1.5b-hf")(engine)
        runner = engine.runner
        page = _first_chunk_page(engine)
        runner.set_pages([5], *([x] for x in ref_page))
        back = [x[0] for x in runner.get_pages([5])]
        digests = [bytes(d) for d in runner.replica_digest()]
        layout = runner.kv_pool_shard_layout()
        heads = int(runner.k_pages.shape[3])
        runner.reset_kv()
        whole = engine.kv_page_bytes * engine.kv.num_pages
        diffs = [float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max()) for a, b in zip(page, ref_page)]
        line = {"phase": "shared_heads_pages", "model": "qwen2.5-1.5b-hf", "tp": 4, "kv_heads": 2,
                "rank_kv_heads": heads, "page_shape": list(page[0].shape), "tp1_page_shape": list(ref_page[0].shape),
                "layer0_byte_identical_to_tp1": all(a[0].tobytes() == b[0].tobytes() for a, b in zip(page, ref_page)),
                "max_abs_diff_to_tp1_kv": diffs,
                "tp1_page_round_trip_byte_identical": [a.tobytes() == b.tobytes() for a, b in zip(back, ref_page)],
                "share_digests_equal": [digests[0] == digests[1], digests[2] == digests[3]],
                "shares_differ": digests[0] != digests[2],
                "pool_bytes_by_rank": [b for _, b in layout], "tp1_pool_bytes": whole,
                "card": nvidia_smi_line()}
        emit(line)
        check(line["page_shape"] == line["tp1_page_shape"] and heads == 1,
              f"shared_heads_pages: tp 4 gathers pages {line['page_shape']}, tp 1 {line['tp1_page_shape']}, "
              f"a rank holds {heads} KV heads")
        check(all(line["tp1_page_round_trip_byte_identical"]), "shared_heads_pages: tp 1's page read back differs")
        check(all(line["share_digests_equal"]) and line["shares_differ"],
              f"shared_heads_pages: the shares' pools {digests}")
        check(all(np.isfinite(a).all() for a in page), "shared_heads_pages: non-finite K/V")
        check(line["pool_bytes_by_rank"] == [whole // 2] * 4,
              f"shared_heads_pages: pool bytes by rank {line['pool_bytes_by_rank']}, tp 1's {whole}")
        return dict(out, layer0_byte_identical_to_tp1=line["layer0_byte_identical_to_tp1"])

    return run


def phase_shared_heads(serve) -> None:
    """KV heads shared by tp ranks on the one card: Qwen2.5-1.5B's HF
    directory (its published config.json cut to QWEN15_LAYERS of its 28
    layers, seeded bf16 weights, a tied head) written, tp 1's logits of the
    tp forward's steps and its first page taken from it, then served at tp
    4 (four gloo rank processes, 3 query heads and one shared KV head a
    rank) with _shared_heads_check before the main path; ``serve`` checks
    every rank's launches and the plain versions, and books the [tp4kh2]
    rows. Then an f32 copy of the same shape (a seeded preset) gives tp 1's
    greedy tokens at tp 4 ("shared_heads_f32_tokens"). The directory is
    deleted after."""
    import torch

    from production_stack_tpu_torch.models import llama

    phase_hf_write(QWEN15_DIR, QWEN15_WRITTEN_CONFIG, _qwen2_hf_specs(QWEN15_WRITTEN_CONFIG, torch.bfloat16))
    ref_logits, ref_page = phase_tp_reference(str(QWEN15_DIR), prepare=_shared_reference)
    serve("qwen2.5-1.5b-hf, tp4", dict(model=str(QWEN15_DIR), max_model_len=4096, **TP4), 128, 0, (),
          _shared_heads_check(ref_logits, ref_page), kh=2)
    llama.PRESETS[QWEN15_PRESET] = dataclasses.replace(llama.LlamaConfig.from_hf_config(QWEN15_WRITTEN_CONFIG),
                                                       max_model_len=4096)
    phase_f32_tokens("shared_heads_f32_tokens", TP4, n_prompts=2, together=False, base=QWEN15_PRESET, lora=False)
    shutil.rmtree(QWEN15_DIR)


# -- Mixtral across ranks: expert parallelism, and MoE under tp and dp ---------

# ep 2, ep 2 x tp 2 and dp 2, every rank a process on cuda:0 over gloo
EP2 = dict(expert_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0")
EP2_TP2 = dict(expert_parallel_size=2, tensor_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0,0,0")
# mixtral-8x7b across stages and sequence ranks, every rank a process on
# cuda:0 over gloo: pp 2 x ep 2 (each stage's 2 layers, 4 experts a rank),
# and sp 2 x ep 2 (a chunk's tokens over 2 sequence ranks, each with 4
# experts a rank), whose logits check runs a prompt of MOE_SP_PROMPT
# tokens in chunks of SP_CHUNK through the runner. Its server takes
# chunks of 512: the greedy repeat of _serve_requests recomputes its tail
# in the shape of the first run's second chunk only there: at 2,048 a
# 576-token chunk against a 64-token tail rounds apart in bf16, which a
# near-tied router can turn into another token
PP2_EP2 = dict(pipeline_parallel_size=2, expert_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0,0,0")
SP2_EP2 = dict(sequence_parallel_size=2, expert_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0,0,0",
               max_model_len=8192, prefill_chunk=512)
MOE_SP_PROMPT, MOE_SP_DECODES = 4096, 8
# the dp 2 serve: a seeded preset at full width with its depth cut to 4 layers
MIXTRAL_DP_LAYERS = 4
MIXTRAL_DP_PRESET = f"mixtral-8x7b-l{MIXTRAL_DP_LAYERS}"


def _moe_reference(store: dict, rows: int = 2, adapters=(), model: str = "mixtral-8x7b-hf", seq: bool = False):
    """``prepare`` for a one-rank Mixtral engine: its logits of _tp_inputs
    (``rows`` rows) and the experts its routers took ([B, T, k] per layer
    and step, numpy) into ``store``, the reference of the ranks' runs; with
    ``adapters`` (the engine serves LoRA) the rows on LORA_ROW_SLOTS with
    them loaded (_lora_reference). With ``seq`` also the logits and routes
    of the long prompt's steps (MOE_SP_PROMPT tokens in chunks of SP_CHUNK,
    then MOE_SP_DECODES; no adapter row), under "seq_logits" and
    "seq_picks": the sequence ranks' reference."""
    def run(engine):
        from production_stack_tpu_torch.models.llama import tape_routes

        def taped(fn, key):
            with tape_routes(engine.runner.model) as tape:
                logits = fn()
            store[key] = [p.cpu().numpy() for p in tape.picks]
            return logits

        def tp_steps():
            return taped(lambda: _tp_logits(engine, rows), "picks")

        store["logits"] = _lora_reference(engine, model, adapters, tp_steps, lambda: _tp_logits(engine, rows, False),
                                          LORA_ROW_SLOTS[:rows]) if adapters else tp_steps()
        out = {"reference_steps": len(store["logits"]), "rows": rows, "routed_calls": len(store["picks"])}
        if seq:
            store["seq_logits"] = taped(lambda: _sp_logits(engine, lora=False, prompt=MOE_SP_PROMPT,
                                                           decodes=MOE_SP_DECODES), "seq_picks")
            out["seq_routed_calls"] = len(store["seq_picks"])
        return out

    return run


def phase_ep_ranks(serve, ref: dict) -> None:
    """Mixtral across ranks on the one card, after its one-rank serve (whose
    logits and routes are ``ref``) and before its directory is deleted:
    mixtral-8x7b-hf served at ep 2 (4 experts a rank) and at ep 2 x tp 2
    (4 experts of I/2 a rank, 16 query and 4 KV heads), each first held to
    the one-rank logits with its routes replayed, an adapter row of
    MIXTRAL_ADAPTERS among them ("ep_forward" and "lora_ranks"; the LoRA
    routes on the ep 2 x tp 2 server's main path); at pp 2 x ep 2 (each
    stage's 2 layers, 4 experts a rank), held the same way, each stage
    replaying its layers' routes, the adapter row among them
    ("moe_stages", "lora_ranks"); at sp 2 x ep 2 on a
    MOE_SP_PROMPT-token prompt in chunks of SP_CHUNK, held to the one
    rank's logits of those steps with each sequence rank replaying its
    tokens' routes ("moe_seq", "moe_seq_costs"); then a
    seeded mixtral-8x7b at full width cut to MIXTRAL_DP_LAYERS layers at dp
    2 against its own one rank ("dp_moe_forward") and
    served. ``serve`` is main's, which checks every rank's launches, the
    replicas' digests and the plain versions, and books the [ep2tp2] rows'
    launches. An "ep_ranks" / "dp_ranks" line a serve gives each rank's
    device bytes, collective share and expert all-reduces."""
    import torch

    from production_stack_tpu_torch.models import llama

    for label, mesh, overrides in (("ep2", {"ep": 2}, EP2), ("ep2 x tp2", {"ep": 2, "tp": 2}, EP2_TP2)):
        gc.collect()
        torch.cuda.empty_cache()
        serve(f"mixtral-8x7b-hf, {label}", dict(model=str(MIXTRAL_DIR), **overrides, enable_lora=True), 128, 0,
              (MIXTRAL_ADAPTERS, False) if label == "ep2 x tp2" else (),
              _logits_check(ref["logits"], "ep_forward", mesh, picks=ref["picks"], model="mixtral-8x7b-hf",
                            adapters=MIXTRAL_ADAPTERS))
    # across stages: the one rank's steps with its experts replayed, each
    # stage its layers' routes a microbatch at a time, its adapter row on
    # MIXTRAL_ADAPTERS as the reference's ("moe_stages", "lora_ranks")
    gc.collect()
    torch.cuda.empty_cache()
    serve("mixtral-8x7b-hf, pp2 x ep2", dict(model=str(MIXTRAL_DIR), **PP2_EP2, enable_lora=True), 128, 0, (),
          _logits_check(ref["logits"], "moe_stages", {"pp": 2, "ep": 2}, picks=ref["picks"], model="mixtral-8x7b-hf",
                        adapters=MIXTRAL_ADAPTERS))
    # across sequence ranks: the long prompt's chunks and steps with the
    # one rank's experts replayed, each sequence rank its tokens' routes
    # ("moe_seq", with what the ranks moved: "moe_seq_costs")
    gc.collect()
    torch.cuda.empty_cache()
    costs = {}
    seq_logits = _logits_check(ref["seq_logits"], "moe_seq", {"sp": 2, "ep": 2}, rows=1, picks=ref["seq_picks"],
                               model="mixtral-8x7b-hf",
                               steps=[f"prefill 1 x {SP_CHUNK} (x{MOE_SP_PROMPT // SP_CHUNK})",
                                      f"decode 1 x 1 (x{MOE_SP_DECODES})"],
                               logits_fn=lambda e: _sp_logits(e, costs, lora=False, prompt=MOE_SP_PROMPT,
                                                              decodes=MOE_SP_DECODES))

    def seq_prepare(engine):
        out = seq_logits(engine)
        chunks = MOE_SP_PROMPT // SP_CHUNK
        emit({"phase": "moe_seq_costs", "model": "mixtral-8x7b-hf", "sp": 2, "ep": 2,
              "backend": "gloo (host-staged CUDA tensors)", "prefill_chunks": chunks,
              "decode_steps": MOE_SP_DECODES, "prefill": _sp_cost_rows(costs["prefill"], chunks),
              "decode": _sp_cost_rows(costs["decode"], MOE_SP_DECODES),
              "device_bytes_by_rank": [int(r["device_bytes"]) for r in costs["decode"][1]],
              "expert_bytes_by_rank": [int(r["expert_bytes"]) for r in costs["decode"][1]],
              "card": nvidia_smi_line()})
        return out

    serve("mixtral-8x7b-hf, sp2 x ep2", dict(model=str(MIXTRAL_DIR), **SP2_EP2), 128, 0, (), seq_prepare,
          sp_prompt=MOE_SP_PROMPT)
    llama.PRESETS[MIXTRAL_DP_PRESET] = dataclasses.replace(llama.PRESETS["mixtral-8x7b"], num_layers=MIXTRAL_DP_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    dp_ref = {}
    phase_tp_reference(MIXTRAL_DP_PRESET, rows=DP_FORWARD_ROWS, prepare=_moe_reference(dp_ref, DP_FORWARD_ROWS))
    serve(f"{MIXTRAL_DP_PRESET}, dp2", dict(model=MIXTRAL_DP_PRESET, **DP2), 128, 0, (),
          _logits_check(dp_ref["logits"], "dp_moe_forward", {"dp": 2}, DP_FORWARD_ROWS, dp_ref["picks"],
                        MIXTRAL_DP_PRESET))


# pipeline parallelism on the one card: pp 2 (two stage ranks) and pp 2 x
# tp 2 (four), every rank a process on cuda:0 over gloo
PP2 = dict(pipeline_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0")
PP2_TP2 = dict(pipeline_parallel_size=2, tensor_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0,0,0")
# the decode step whose launches a stage counts: 32 rows, four microbatches
# of 8 at pp 2, each running the stage's 8 layers
PP_STEP_ROWS = 32
# qwen2.5-7b at pp 2: the sampled parameters read back through the stages,
# layer 1 (stage 0's last) and layer 3 (stage 1's last)
_L1 = "model.layers.1."
QWEN_PP_SAMPLES = QWEN_SAMPLES + (
    ("layers.1.wq", _L1 + "self_attn.q_proj.weight", True),
    ("layers.1.bv", _L1 + "self_attn.v_proj.bias", False),
    ("layers.1.w_up", _L1 + "mlp.up_proj.weight", True),
)


def _pp_step_launches(engine) -> dict:
    """One decode step of PP_STEP_ROWS rows on fresh pools through every
    stage: each stage's decode launches, which must be microbatches x its
    layers (4 x 1 for RANK_LLAMA at pp 2, where pp 1 launches 2)."""
    import numpy as np

    from production_stack_tpu_torch.engine.runner import StepInput
    from production_stack_tpu_torch.parallel.pipeline import microbatches

    runner, cfg = engine.runner, engine.model_cfg
    B, pp = PP_STEP_ROWS, engine.pipeline_parallel
    maxp = 17
    inp = StepInput(input_ids=np.ones((B, 1), np.int32), positions=np.full((B, 1), 1024, np.int32),
                    page_table=np.arange(B * maxp, dtype=np.int32).reshape(B, maxp) % engine.kv.num_pages,
                    kv_lens=np.full(B, 1025, np.int32), temperature=np.zeros(B, np.float32),
                    top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32))
    runner.reset_kv()
    runner.rank_stats(reset=True)
    runner.step(inp, want_logits=False)
    rows = _rank_rows(runner.rank_stats(reset=True))
    runner.reset_kv()
    M = microbatches(B, pp)
    want = M * cfg.num_layers // pp
    got = [int(r["decode_attention"]) for r in rows]
    check(got == [want] * len(rows), f"pp_step: stage decode launches {got}, expected {want} on every rank")
    return {"step_rows": B, "microbatches": M, "rows_a_microbatch": B // M,
            "decode_launches_by_rank": got, "pp1_launches": cfg.num_layers,
            "relay_calls_by_rank": [int(r["relay_calls"]) for r in rows],
            "relay_bytes_by_rank": [int(r["relay_bytes"]) for r in rows]}


def _pp_qwen_reads(seed: int = 0):
    """``prepare`` for the pp 2 qwen2.5-7b server: each stage's bytes read
    from the directory (runner.rank_stats' loaded_bytes) equal to its
    layers' tensors and the embedding, final norm and head, as written; the
    sampled parameters of both stages, read back through them
    (runner.gathered_params), byte-identical to what was written."""
    import torch

    from production_stack_tpu_torch.parallel.pipeline import stage_range

    specs = _qwen2_hf_specs(QWEN_WRITTEN_CONFIG, torch.bfloat16)
    L = QWEN_WRITTEN_CONFIG["num_hidden_layers"]

    def nbytes(names):
        return sum(math.prod(specs[n][0]) * specs[n][1].itemsize for n in names)

    def run(engine):
        pp = engine.pipeline_parallel
        rows = _rank_rows(engine.runner.rank_stats())
        shared = [n for n in specs if not n.startswith("model.layers.")]
        want = [nbytes(shared + [n for n in specs for i in stage_range(L, pp, p)
                                 if n.startswith(f"model.layers.{i}.")]) for p in range(pp)]
        got = [int(r["loaded_bytes"]) for r in rows]
        params = engine.runner.gathered_params([p for p, _, _ in QWEN_PP_SAMPLES])
        same = {}
        for pname, hf, transpose in QWEN_PP_SAMPLES:
            w = _hf_value(hf, *specs[hf], seed).cpu()
            same[pname] = _same_bytes(params[pname], (w.t() if transpose else w).contiguous())
        line = {"phase": "pp_hf_load", "model": "qwen2.5-7b", "pp": pp, "layers_a_stage": L // pp,
                "bytes_read_by_stage": got, "expected_by_stage": want, "directory_bytes": nbytes(list(specs)),
                "samples_byte_identical": same}
        emit(line)
        check(got == want, f"pp_hf_load: stages read {got} bytes, their layers and shared tensors hold {want}")
        check(all(same.values()), f"pp_hf_load: a parameter read through the stages differs: {same}")
        return {"bytes_read_by_stage": got}

    return run


def phase_pp_ranks(serve, ref: list) -> None:
    """Pipeline parallelism on the one card, while qwen2.5-7b's directory
    exists: RANK_LLAMA (llama-3.2-1b at full width, RANK_LAYERS layers)
    held to one rank's logits (``ref``, the tp phase's, an adapter row of
    RANK_ADAPTERS among them: "pp_forward" and "lora_ranks": the tp
    forward's steps, FORWARD_LOGIT_BOUND, FORWARD_TOP1_MIN) and served at
    pp 2 and pp 2 x tp 2 (the LoRA routes on the pp 2 x tp 2 server's main
    path), each with a 32-row decode step whose launches
    every stage counts ("pp_step"); the f32 copy of RANK_LLAMA's greedy
    tokens at pp 2 against pp 1 ("pp_f32_tokens"); qwen2.5-7b from its
    directory at pp 2, each stage reading only its 2 layers
    ("pp_hf_load"). ``serve`` is main's: it checks every rank's launches
    and the plain versions, and books the [pp2] and [pp2tp2] rows'
    launches; its "pp_ranks" lines give each rank's device bytes, relays
    and collective share."""
    import torch

    for label, mesh, overrides in (("pp2", {"pp": 2}, PP2), ("pp2 x tp2", {"pp": 2, "tp": 2}, PP2_TP2)):
        gc.collect()
        torch.cuda.empty_cache()
        logits = _logits_check(ref, "pp_forward", mesh, adapters=RANK_ADAPTERS)

        def prepare(engine, logits=logits, mesh=mesh):
            out = logits(engine)
            step = _pp_step_launches(engine)
            emit({"phase": "pp_step", "model": RANK_LLAMA, **mesh, **step, "card": nvidia_smi_line()})
            return dict(out, **step)

        serve(f"{RANK_LLAMA}, {label}", dict(model=RANK_LLAMA, **overrides, **RANK_LORA), 64, 0,
              (RANK_ADAPTERS, False) if label == "pp2 x tp2" else (), prepare)
    phase_f32_tokens("pp_f32_tokens", PP2, n_prompts=2, together=False)
    gc.collect()
    torch.cuda.empty_cache()
    serve("qwen2.5-7b-hf, pp2", dict(model=str(QWEN_DIR), **PP2), 128, 0, (), _pp_qwen_reads())


# sequence parallelism on the one card: sp 2 (two ranks) and sp 2 x tp 2
# (four), every rank a process on cuda:0 over gloo (host-staged: the
# numbers of these runs are functional, not an sp speed figure)
SP2 = dict(sequence_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0")
SP2_TP2 = dict(sequence_parallel_size=2, tensor_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0,0,0")
# RANK_LLAMA (llama-3.2-1b at full width, 2 of its 16 layers, as the
# other rank phases, to keep the smoke inside its limit) on a long
# prompt: 8,191 tokens in chunks of 2,048, the last of 2,047 (its padding
# to a multiple of sp runs), then 32 decode steps; the default 4 GB pool
SP_SERVE = dict(model=RANK_LLAMA, max_model_len=16384, prefill_chunk=2048)
SP_PROMPT, SP_CHUNK, SP_DECODES = 8191, 2048, 32
SP_STEPS = [f"prefill 1 x {SP_CHUNK} (x{SP_PROMPT // SP_CHUNK}), 1 x {SP_PROMPT % SP_CHUNK}",
            f"decode 1 x 1 (x{SP_DECODES})"]


def _sp_inputs(vocab: int, lora: bool = False, prompt: int = SP_PROMPT, decodes: int = SP_DECODES,
               rows: int = 1) -> list:
    """The runner's StepInputs of the sp forward's steps: one row of seeded
    ids, ``prompt`` tokens in chunks of SP_CHUNK, then ``decodes`` decode
    steps fed the seeded tokens (teacher forcing), on fresh pages; with
    ``lora`` the row on adapter slot SP_LORA_SLOT. ``rows`` > 1 adds inert
    rows after it (positions -1: they read and write nothing), as the
    scheduler pads a batch to a multiple of data_parallel_size."""
    import numpy as np

    from production_stack_tpu_torch.engine.runner import StepInput

    n = prompt + decodes
    ids = np.zeros((rows, n), np.int32)
    ids[0] = np.random.RandomState(6).randint(0, vocab, n)
    pt = np.zeros((rows, -(-n // 64)), np.int32)
    pt[0] = np.arange(pt.shape[1])
    common = dict(page_table=pt, temperature=np.zeros(rows, np.float32), top_k=np.zeros(rows, np.int32),
                  top_p=np.ones(rows, np.float32),
                  lora_ids=np.array([SP_LORA_SLOT] + [0] * (rows - 1), np.int32) if lora else None)
    steps = [(p, min(SP_CHUNK, prompt - p)) for p in range(0, prompt, SP_CHUNK)]
    steps += [(prompt + s, 1) for s in range(decodes)]

    def pad(x, fill):
        return np.concatenate([x, np.full((rows - 1, *x.shape[1:]), fill, x.dtype)])

    return [StepInput(input_ids=ids[:, p: p + t], positions=pad(np.arange(p, p + t, dtype=np.int32)[None], -1),
                      kv_lens=pad(np.array([p + t], np.int32), 0), **common) for p, t in steps]


def _sp_logits(engine, costs: "dict | None" = None, lora: "bool | None" = None, prompt: int = SP_PROMPT,
               decodes: int = SP_DECODES) -> list:
    """The logits [1, V] of _sp_inputs' steps (``prompt`` tokens, then
    ``decodes`` steps) through the engine's runner (every rank), on the
    CPU, the row alone (under dp beside an inert row a replica); the pools
    are reset after. With ``costs``, each rank's rank_stats
    over the prefill chunks and over the decode steps, and their wall
    seconds, go into it. On an engine that serves LoRA (unless ``lora`` is
    False) the row takes SP_LORA_SLOT."""
    runner = engine.runner
    inps = _sp_inputs(engine.model_cfg.vocab_size, engine.lora is not None if lora is None else lora, prompt, decodes,
                      rows=engine.data_parallel)
    chunks = len(inps) - decodes
    runner.reset_kv()
    runner.rank_stats(reset=True)
    out = []
    t0 = time.perf_counter()
    for i, inp in enumerate(inps):
        out.append(runner.step(inp)[1][:1].float().cpu())
        if costs is not None and i == chunks - 1:
            costs["prefill"] = (time.perf_counter() - t0, _rank_rows(runner.rank_stats(reset=True)))
            t0 = time.perf_counter()
    if costs is not None:
        costs["decode"] = (time.perf_counter() - t0, _rank_rows(runner.rank_stats(reset=True)))
    runner.reset_kv()
    return out


def _sp_reference() -> tuple:
    """One rank's logits of _sp_inputs (RANK_LLAMA's seeded weights, the
    prefill kernel on every chunk): the row on SP_LORA_SLOT with
    RANK_ADAPTERS loaded (_lora_reference), and the same row on slot 0,
    the base model's (phase_sp_compose's reference)."""
    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine

    engine = LLMEngine(EngineConfig(**SP_SERVE, **RANK_LORA))
    base = []

    def base_fn():
        base.append(_sp_logits(engine, lora=False))
        return base[0]

    try:
        ref = _lora_reference(engine, RANK_LLAMA, RANK_ADAPTERS, lambda: _sp_logits(engine), base_fn,
                              (SP_LORA_SLOT,))
        return ref, base[0]
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def _sp_cost_rows(part: tuple, chunks: int) -> dict:
    """What each rank moved in one part of _sp_logits (rank_stats rows):
    the sequence group's traffic (the ring's rotations and the token
    gathers) and all collectives, their host seconds against the step's."""
    wall, rows = part
    return {
        "wall_seconds": wall,
        "ring_calls_by_rank": [int(r["ring_calls"]) for r in rows],
        "ring_bytes_by_rank": [int(r["ring_bytes"]) for r in rows],
        "ring_bytes_a_step_by_rank": [r["ring_bytes"] / chunks for r in rows],
        "ring_seconds_by_rank": [r["ring_seconds"] for r in rows],
        "collective_bytes_by_rank": [int(r["collective_bytes"]) for r in rows],
        "collective_seconds_by_rank": [r["collective_seconds"] for r in rows],
        "step_seconds_by_rank": [r["step_seconds"] for r in rows],
        "collective_share_of_step_by_rank": [r["collective_seconds"] / max(r["step_seconds"], 1e-9) for r in rows],
        "ring_share_of_step_by_rank": [r["ring_seconds"] / max(r["step_seconds"], 1e-9) for r in rows],
    }


async def _mesh_rows(port: int, ranks: int) -> dict:
    """/stats' mesh_devices and /metrics' pool rows, one a rank."""
    import re

    import aiohttp

    base = f"http://127.0.0.1:{port}"
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=60)) as s:
        async with s.get(base + "/stats") as r:
            devices = (await r.json())["mesh_devices"]
        async with s.get(base + "/metrics") as r:
            rows = re.findall(r'vllm:kv_pool_shard_bytes\{[^}]*device="([^"]+)"', await r.text())
    check(devices == ranks and len(rows) == ranks,
          f"serve: mesh_devices {devices}, pool rows {rows} for {ranks} ranks")
    return {"mesh_devices": devices, "pool_rows": rows}


def phase_sp_ranks(serve) -> list:
    """Sequence parallelism on the one card: RANK_LLAMA (full width,
    RANK_LAYERS layers) at sp 2 and sp 2 x tp 2, each server's logits of an 8,191-token
    prompt in four chunks and 32 decode steps held to one rank's before the
    main path ("sp_forward"), with what the ranks moved in those steps
    ("sp_costs"); then its main path, whose first concurrent prompt is
    SP_PROMPT tokens long. Both servers serve LoRA: the prompt's row is on
    an adapter of RANK_ADAPTERS, and the sp 2 server's main
    path ends with the LoRA routes (_lora_requests). ``serve`` is main's: it checks every rank's
    launches (the decode kernel's and no other), the plain versions and the
    sp replicas' digests, and books the [sp2] and [sp2tp2] rows' launches.
    Then the f32 copy of RANK_LLAMA's greedy tokens at sp 2 against one
    rank's ("sp_f32_tokens"). Returns one rank's logits of the same steps
    on the base model (phase_sp_compose's reference)."""
    import torch

    ref, base = _sp_reference()
    chunks = SP_PROMPT // SP_CHUNK + 1
    for label, mesh, overrides in (("sp2", {"sp": 2}, SP2), ("sp2 x tp2", {"sp": 2, "tp": 2}, SP2_TP2)):
        gc.collect()
        torch.cuda.empty_cache()
        costs = {}
        logits = _logits_check(ref, "sp_forward", mesh, rows=1, model=RANK_LLAMA,
                               logits_fn=lambda e, costs=costs: _sp_logits(e, costs), steps=SP_STEPS,
                               adapters=RANK_ADAPTERS, slots=(SP_LORA_SLOT,))

        def prepare(engine, logits=logits, costs=costs, mesh=mesh):
            out = logits(engine)
            emit({"phase": "sp_costs", "model": RANK_LLAMA, **mesh, "backend": "gloo (host-staged CUDA tensors)",
                  "prefill_chunks": chunks, "decode_steps": SP_DECODES,
                  "prefill": _sp_cost_rows(costs["prefill"], chunks),
                  "decode": _sp_cost_rows(costs["decode"], SP_DECODES),
                  "device_bytes_by_rank": [int(r["device_bytes"]) for r in costs["decode"][1]],
                  "card": nvidia_smi_line()})
            return out

        serve(f"{RANK_LLAMA}, {label}", dict(SP_SERVE, **overrides, **RANK_LORA), 64, 0,
              (RANK_ADAPTERS, False) if label == "sp2" else (), prepare)
    phase_f32_tokens("sp_f32_tokens", SP2, n_prompts=2, together=False)
    return base


# sequence ranks beside dp and pp ranks, and speculative decoding at sp
# and at pp (phase_sp_compose): four servers of RANK_LLAMA, every rank a
# gloo process on cuda:0. The first concurrent prompt of the sp servers'
# main path is SP_COMPOSE_PROMPT tokens (two chunks of SP_CHUNK); the
# logits check runs the sp phase's 8,191-token row
DP2_SP2 = dict(data_parallel_size=2, sequence_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0,0,0")
PP2_SP2 = dict(pipeline_parallel_size=2, sequence_parallel_size=2, tp_backend="gloo", tp_device_ids="0,0,0,0")
SP_COMPOSE_RUNS = (
    ("dp2 x sp2", {"dp": 2, "sp": 2}, DP2_SP2),
    ("pp2 x sp2", {"pp": 2, "sp": 2}, PP2_SP2),
    ("sp2, spec4", {"sp": 2}, dict(SP2, speculative_k=SPEC_K)),
    ("pp2, spec4", {"pp": 2}, dict(PP2, speculative_k=SPEC_K)),
)
SP_COMPOSE_PROMPT = SP_CHUNK + 900
# a spec server's step_spec against its own step_multi (_spec_vs_greedy):
# a token that differs must sit where step_multi's two best logprobs are
# within SPEC_NEAR_TIE: the verify forward (the prefill kernel, or at sp the
# ring) and the decode kernel each hold bf16 logits within
# FORWARD_LOGIT_BOUND of one plain forward, so their best tokens can part
# only where the two best are that close twice over
SPEC_ROUNDS = 6
SPEC_NEAR_TIE = 2 * FORWARD_LOGIT_BOUND


def _spec_greedy(engine, label: str) -> dict:
    """_spec_vs_greedy on a spec server's runner (every rank; SPEC_ROUNDS
    rounds): flips only at near-ties (SPEC_NEAR_TIE), round 1 accepting
    the planted drafts, and every replica of a stage the same pools
    after."""
    t0 = time.perf_counter()
    r = engine.runner
    spec, summary, _, _ = _spec_vs_greedy(r, engine.model_cfg.vocab_size, SPEC_ROUNDS)
    digests = [bytes(d).hex()[:16] for d in r.replica_digest()]
    r.reset_kv()
    _check_spec(f"spec_greedy[{label}]", spec, summary, SPEC_NEAR_TIE)
    stage = len(digests) // engine.pipeline_parallel
    check(all(len(set(digests[p * stage:(p + 1) * stage])) == 1 for p in range(engine.pipeline_parallel)),
          f"spec_greedy[{label}]: the replicas' pools differ after step_spec: {digests}")
    return dict(summary, rows=SPEC_ROWS, near_tie=SPEC_NEAR_TIE, replica_digests=digests,
                seconds=round(time.perf_counter() - t0, 2))


def _routed(label: str):
    """``extra`` for a phase_sp_compose server: the port's router as a
    subprocess in front of it, a greedy request straight to the server and
    the same through the router (the same text), and the "router" line."""
    async def run(server, port):
        import aiohttp

        loop = asyncio.get_running_loop()
        rport = _free_port()
        router, rlog = await asyncio.to_thread(
            _start_router, rport, "--static-backends", f"http://127.0.0.1:{port}", "--static-models",
            server.cfg.name, "--engine-stats-interval", "1")
        base = f"http://127.0.0.1:{rport}"
        body = {"model": server.cfg.name, "prompt": "Sequence ranks beside dp and pp ranks: ", "max_tokens": 16,
                "temperature": 0.0, "ignore_eos": True}
        rid = f"sp-compose-{label.replace(' ', '')}"
        try:
            await loop.run_in_executor(None, _wait_http, base + "/health", router, 120, "the router", rlog)
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=300)) as s:
                async with s.post(f"http://127.0.0.1:{port}/v1/completions", json=body) as r:
                    direct = (r.status, await r.json())
                t0 = time.perf_counter()
                async with s.post(base + "/v1/completions", json=body, headers={"X-Request-Id": rid}) as r:
                    routed = (r.status, await r.json())
                client = time.perf_counter() - t0
                async with s.get(base + "/metrics") as r:
                    metrics = await r.text()
                async with s.get(f"http://127.0.0.1:{port}/slo_records?since=0") as r:
                    slo = await r.json()
        finally:
            _stop_proc(router)
        check(direct[0] == routed[0] == 200, f"sp_compose[{label}]: direct {direct[0]}, routed {routed[0]}")
        same = direct[1]["choices"][0]["text"] == routed[1]["choices"][0]["text"]
        check(same, f"sp_compose[{label}]: the routed answer differs from the direct one")
        line = _router_line(f"sp_compose {label}", metrics, _first_records({"engine": slo}, [rid]), [],
                            await asyncio.to_thread(nvidia_smi_line))
        line["client_request_s"] = round(client, 4)
        emit(line)
        check(sum(line["routes"].values()) >= 1, f"sp_compose[{label}]: the router sent nothing: {line['routes']}")
        return {"routed_text_equal": same, "routed_client_s": round(client, 4)}

    return run


def phase_sp_compose(serve, ref: list) -> None:
    """Sequence ranks beside dp and pp ranks, and speculative decoding at
    sp and at pp, on the one card: RANK_LLAMA served at dp 2 x sp 2, pp 2
    x sp 2, sp 2 with speculative_k SPEC_K and pp 2 with it
    (SP_COMPOSE_RUNS), each behind the port's router. Before each main
    path its logits of the sp phase's 8,191-token row and 32 decode steps
    are held to one rank's on the base model (``ref``, "sp_compose_forward":
    FORWARD_LOGIT_BOUND, FORWARD_TOP1_MIN); a spec server's step_spec
    tokens to its own step_multi's ("spec_greedy"). ``serve`` is main's:
    it checks every rank's launches (the decode kernel on each rank of the
    dp 2 x sp 2 and pp 2 x sp 2 servers; at pp 2 with spec the prefill
    kernel and its write on every stage, its verify rounds L a microbatch;
    at sp 2 with spec no kernel: chunks and verify rounds go through the
    ring), the plain versions and the replicas' digests, and books the
    [dp2sp2], [pp2sp2] and [pp2verify] rows' launches."""
    import torch

    for label, mesh, overrides in SP_COMPOSE_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        logits = _logits_check(ref, "sp_compose_forward", mesh, rows=1, model=RANK_LLAMA,
                               logits_fn=lambda e: _sp_logits(e), steps=SP_STEPS)

        def prepare(engine, logits=logits, label=label, spec="speculative_k" in overrides):
            out = logits(engine)
            if spec:
                out["spec_greedy"] = _spec_greedy(engine, label)
                emit({"phase": "spec_greedy", "model": RANK_LLAMA, "server": label, **out["spec_greedy"],
                      "card": nvidia_smi_line()})
            return out

        serve(f"{RANK_LLAMA}, {label}", dict(SP_SERVE, **overrides), 64, 0, (), prepare, extra=_routed(label),
              sp_prompt=SP_COMPOSE_PROMPT)
        emit({"phase": "phase_seconds", "name": f"sp_compose {label}", "seconds": round(time.perf_counter() - t0, 2)})


def phase_opt_int8_refused() -> None:
    """An OPT engine with int8 pools is refused (the JAX OPT forward reads no
    pool scales)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine

    try:
        LLMEngine(EngineConfig(model=str(OPT_DIR), kv_cache_dtype="int8", max_model_len=2048))
    except ValueError as e:
        emit({"phase": "refusal", "model": "opt-125m-hf", "kv_cache_dtype": "int8", "refused": str(e)})
        check("does not support kv_cache_dtype=int8" in str(e), f"refusal[opt int8]: refused for another reason: {e}")
        return
    fail("refusal[opt int8]: an OPT engine with int8 pools started")


# PEFT adapter directories the LoRA servers load over HTTP (seeded,
# _lora_tensors): llama-3.2-1b's two on all seven targets, mixtral-8x7b's
# one on its attention targets (its experts are no LoRA target)
LORA_DIR = HF_ROOT / "lora"
LLAMA_ADAPTERS = [("llama-lora-r8", str(LORA_DIR / "llama-r8")), ("llama-lora-r16", str(LORA_DIR / "llama-r16"))]
MIXTRAL_ADAPTERS = [("mixtral-lora-r8", str(LORA_DIR / "mixtral-r8"))]
ALL_TARGET_MODULES = "q_proj,k_proj,v_proj,o_proj,gate_proj,up_proj,down_proj"

# LoRA on the rank serves: RANK_LLAMA's own adapters (its RANK_LAYERS
# layers, all seven targets, ranks 8 and 16), llama-3.2-1b's
# LLAMA_ADAPTERS at sp and mixtral-8x7b's MIXTRAL_ADAPTERS at ep, each
# loaded before a logits check and unloaded after it, then loaded over HTTP
# on the main path. The rows of _tp_inputs take slots LORA_ROW_SLOTS (row 0
# base; at four rows, two a dp group, each group holds an adapter row),
# _sp_inputs' one row SP_LORA_SLOT, the f32 copy's prompts F32_LORA_NAMES
# (base and the rank-16 adapter at two prompts, every kind at four)
RANK_ADAPTERS = [("rank-lora-r8", str(LORA_DIR / "rank-r8")), ("rank-lora-r16", str(LORA_DIR / "rank-r16"))]
RANK_LORA = dict(enable_lora=True, lora_target_modules=ALL_TARGET_MODULES)
LORA_ROW_SLOTS = (0, 1, 2, 1)
SP_LORA_SLOT = 2
LORA_LIGHT_TOKENS = 8
# the adapter request an unload meets in flight (512 until the multi-host
# phase grew the smoke: it is in flight for its whole decode either way)
LORA_LONG_TOKENS = 128
F32_LORA_NAMES = (None, RANK_ADAPTERS[1][0], RANK_ADAPTERS[0][0], None)
# each one-rank reference's LoRA buffer bytes, by model (the lora_ranks
# lines' comparison), and the seconds the LoRA additions took on the rank
# serves, by what ran
LORA_ONE_RANK_BYTES: dict = {}
LORA_SECONDS: dict = {}


def write_lora_adapters(cfg, adapters, ranks, targets) -> None:
    """Each (name, directory) of ``adapters`` as a PEFT adapter of the rank
    ``ranks`` gives it on ``targets``, lora_alpha = rank * LORA_SCALE."""
    from production_stack_tpu_torch.engine.lora import save_peft_adapter

    for i, ((_, path), rank) in enumerate(zip(adapters, ranks)):
        save_peft_adapter(path, cfg, rank, rank * LORA_SCALE, _lora_tensors(cfg, rank, seed=40 + i, targets=targets))


# (label, EngineConfig overrides, head_dim of the kernel rows whose launches it
# gives, sleep level of its surface check or 0, LoRA routes (adapters, full)
# or ()): each kernel row's launches come from its own servers' runs; the
# llama bf16 server ends with the engine surface and sleep level 1,
# qwen2.5-7b's bf16 server with level 2
SERVE_RUNS = (
    ("llama-3.2-1b", dict(model="llama-3.2-1b"), 64, 1, ()),
    ("llama-3.2-1b, int8", dict(model="llama-3.2-1b", **INT8_SERVE), 64, 0, ()),
    (GEMMA_MODEL, dict(model=GEMMA_MODEL, **GEMMA_SERVE), 256, 0, ()),
    ("qwen2.5-7b-hf", dict(model=str(QWEN_DIR)), 128, 2, ()),
    ("qwen2.5-7b-hf, int8", dict(model=str(QWEN_DIR), kv_cache_dtype="int8"), 128, 0, ()),
    # OPT's position table holds 2,048: the engine's default 4,096 is refused
    ("opt-125m-hf", dict(model=str(OPT_DIR), max_model_len=2048), 64, 0, ()),
    ("llama-3.2-1b, lora", dict(model="llama-3.2-1b", enable_lora=True, lora_target_modules=ALL_TARGET_MODULES),
     64, 0, (LLAMA_ADAPTERS, True)),
)
# after the runs above, with qwen2.5-7b's directory deleted for its room
MIXTRAL_SERVE = ("mixtral-8x7b-hf, lora", dict(model=str(MIXTRAL_DIR), enable_lora=True), 128, 0,
                 (MIXTRAL_ADAPTERS, False))


# -- the stack's services ------------------------------------------------------

STACK_NAMESPACE = "chip-stack"
STACK_POOL = dict(model="llama-3.2-1b", num_pages=40)
# the first prompt: 1,100 bytes + BOS = 17 full pages and a tail; the three
# HTTP prompts after it (900 to 1,000 bytes each, 15 to 16 pages) overrun the
# 40-page pool with it, so prefix pages spill to the cache server
STACK_FIRST_BYTES = 1100
STACK_TOKENS = 16


def _start_service(module: str, port: int, *extra: str) -> "subprocess.Popen":
    """One of the port's frame servers as a subprocess (``extra``: more of
    its flags), once it accepts connections (60 s at most)."""
    import socket

    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    log = tempfile.TemporaryFile()  # its log, read if it dies before it listens
    proc = subprocess.Popen(
        [sys.executable, "-m", f"production_stack_tpu_torch.kvoffload.{module}", "--host", "127.0.0.1",
         "--port", str(port), *extra],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=log,
    )
    deadline = time.time() + 60
    while time.time() < deadline:
        if proc.poll() is not None:
            log.seek(0)
            fail(f"stack: {module} exited with {proc.returncode}: {log.read()[-2000:].decode(errors='replace')}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return proc
        except OSError:
            time.sleep(0.2)
    proc.kill()
    fail(f"stack: {module} did not listen on {port} within 60 s")


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


class _Timed:
    """Seconds and calls of one method, summed over every instance, while
    installed (a measurement of this run, not the port's)."""

    def __init__(self, cls, name: str):
        self.cls, self.name, self.orig = cls, name, getattr(cls, name)
        self.seconds, self.calls = 0.0, 0
        orig = self.orig

        def timed(obj, *a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(obj, *a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(cls, name, timed)

    def remove(self) -> None:
        setattr(self.cls, self.name, self.orig)


def phase_stack(serve=None, launches: "dict | None" = None) -> None:
    """The engine inside the stack's services (docstring, 5e). ``serve`` is
    main's serve(), which runs phase_serve and adds its launches to the
    kernel rows; the two incarnations' launches are added to ``launches``
    here. Without them (the phase run alone) phase_serve runs directly and
    the launches are only checked."""
    if launches is None:
        launches = {}
    if serve is None:
        def serve(label, overrides, D, sleep_level, lora, prepare=None, extra=None):
            phase_serve(label, overrides, sleep_level, lora, prepare, extra)
    import random

    import aiohttp
    import torch

    from production_stack_tpu_torch.engine.api_server import serve as serve_http
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.scheduler import SamplingParams
    from production_stack_tpu_torch.kvoffload.controller import ControllerClient
    from production_stack_tpu_torch.kvoffload.protocol import BlockingClient
    from production_stack_tpu_torch.kvoffload.tiers import RemoteTier
    from production_stack_tpu_torch.kvoffload.warmstart import WarmStartManager
    from production_stack_tpu_torch.tracing import SpanContext

    kernels, plains = _counters()
    cs_port, ctl_port = _free_port(), _free_port()
    procs = [_start_service("cache_server", cs_port), _start_service("controller", ctl_port)]
    timers = [_Timed(RemoteTier, "get"), _Timed(RemoteTier, "put"), _Timed(WarmStartManager, "restore")]
    rng = random.Random(14)
    first_prompt = _prompt(rng, STACK_FIRST_BYTES)
    http_prompts = [_prompt(rng, 900 + 50 * i) for i in range(3)]
    remote = SpanContext.new_root()
    try:
        cfg = EngineConfig(host="127.0.0.1", port=_free_port(), **STACK_POOL,
                           kv_remote_url=f"127.0.0.1:{cs_port}", kv_controller_url=f"127.0.0.1:{ctl_port}",
                           warm_start=True, warm_start_namespace=STACK_NAMESPACE, warm_start_interval_s=0,
                           enable_debug_endpoints=True, kv_instance_id="chip-stack-0")
        base = f"http://127.0.0.1:{cfg.port}"
        url = f"http://127.0.0.1:{cfg.port}"

        def zero_counts():
            for fn, attr in kernels.values():
                setattr(fn, attr, 0)
            for fn in plains.values():
                fn.calls = 0

        async def greedy(engine, rid):
            """The first prompt through LLMEngine.generate: token ids, the
            cached tokens of its prefill, and its TTFT."""
            ids, cached, ttft = [], 0, None
            t0 = time.perf_counter()
            params = SamplingParams(max_tokens=STACK_TOKENS, temperature=0.0, ignore_eos=True)
            async for out in engine.generate(rid, prompt=first_prompt, params=params):
                if ttft is None:
                    ttft = time.perf_counter() - t0
                ids.extend(out.token_ids)
                cached = out.cached_tokens
            return ids, cached, ttft

        async def first_life():
            server, runner = await serve_http(cfg)
            out = {}
            try:
                zero_counts()
                out["ids"], out["cached"], out["ttft_s"] = await greedy(server.engine, "stack-first")
                # the same prompt again: a prefix hit in a live engine, to
                # set beside the restarted engine's first and second hits
                _, out["cached_again"], out["ttft_again_s"] = await greedy(server.engine, "stack-first-again")
                async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
                    async def post(i, p):
                        headers = {"traceparent": remote.to_traceparent()} if i == 0 else {}
                        body = {"prompt": p, "max_tokens": STACK_TOKENS, "temperature": 0.0, "ignore_eos": True}
                        async with s.post(base + "/v1/completions", json=body, headers=headers) as r:
                            return r.status, await r.json()

                    for st, body in await asyncio.gather(*(post(i, p) for i, p in enumerate(http_prompts))):
                        check(st == 200, f"stack: completion -> {st}: {body}")
                    async with s.get(base + "/v1/traces", params={"trace_id": remote.trace_id}) as r:
                        traces = await r.json()
                    async with s.get(base + "/v1/debug/flightrecorder",
                                     params={"trace_id": remote.trace_id, "kind": "sched"}) as r:
                        sched = await r.json()
                    # kvaware v1's call, for the last prompt served: the
                    # reporter thread sends its admits behind the request
                    last_ids = server.engine.tokenizer.encode(http_prompts[-1])
                    ctl = ControllerClient(f"127.0.0.1:{ctl_port}")
                    deadline = time.time() + 10
                    looked = None
                    while time.time() < deadline:
                        looked = await ctl.lookup(last_ids)
                        if looked.get("url") == url:
                            break
                        await asyncio.sleep(0.1)
                    await ctl.close()
                    async with s.get(base + "/metrics") as r:
                        before_reset = await r.text()
                    async with s.post(base + "/metrics/reset") as r:
                        check(r.status == 200, f"stack: POST /metrics/reset -> {r.status}")
                    async with s.get(base + "/metrics") as r:
                        after_reset = await r.text()
                out["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
                out["plain_calls"] = {k: fn.calls for k, fn in plains.items()}
                t0 = time.perf_counter()
                await server.drain(timeout=60)
                out["drain_s"] = time.perf_counter() - t0
                out["spilled_pages"] = server.engine.warm.spilled_pages_total
                out["manifest_pages"] = len(server.engine.kv.warm_candidates(cfg.warm_start_max_pages))
                out["stats"] = server.engine.stats()
            finally:
                await runner.cleanup()
                server.engine.stop()
            spans = traces["traces"][0]["spans"] if traces.get("traces") else []
            by_id = {sp["span_id"]: sp for sp in spans}

            def reaches(sp):
                seen = 0
                while sp is not None and seen < 16:
                    if sp["parent_id"] == remote.span_id:
                        return True
                    sp, seen = by_id.get(sp["parent_id"]), seen + 1
                return False

            names = {sp["name"] for sp in spans if reaches(sp)}
            out["trace_spans"] = sorted(names)
            out["sched_events"] = len(sched.get("events", []))
            out["lookup"] = looked
            out["hops_before_reset"] = "vllm:ttft_hop_" in before_reset
            out["hops_after_reset"] = "vllm:ttft_hop_" in after_reset
            return out

        async def second_life():
            # the engine is built off the event loop here only to time it
            t0 = time.perf_counter()
            engine = LLMEngine(cfg)
            build_s = time.perf_counter() - t0
            server, runner = await serve_http(cfg, engine)
            out = {"build_s": build_s, "restored_pages": engine.warm.restored_pages,
                   "generation": engine.warm.generation}
            try:
                zero_counts()
                out["ids"], out["cached"], out["ttft_s"] = await greedy(engine, "stack-again")
                _, out["cached_again"], out["ttft_again_s"] = await greedy(engine, "stack-again-2")
                out["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
                out["plain_calls"] = {k: fn.calls for k, fn in plains.items()}
                out["stats"] = engine.stats()
            finally:
                await runner.cleanup()
                engine.stop()
            return out

        one = asyncio.run(first_life())
        restore = timers[2]
        restore_s0 = restore.seconds
        two = asyncio.run(second_life())
        restore_s = restore.seconds - restore_s0
        for life, res in (("first", one), ("restarted", two)):
            for k in SERVE_ROWS[False]:
                check(res["launches"][k] > 0, f"stack: kernel {k} was not launched by the {life} engine")
            for k, n in res["plain_calls"].items():
                check(n == 0, f"stack: plain version {k} ran {n} times in the {life} engine")
        check({"engine.request", "engine.queue", "engine.prefill", "engine.decode"} <= set(one["trace_spans"]),
              f"stack: /v1/traces under the given traceparent holds {one['trace_spans']}")
        check(one["sched_events"] > 0, "stack: no flight-recorder sched event carries the trace id")
        check(one["lookup"] and one["lookup"].get("url") == url,
              f"stack: the controller's lookup names {one['lookup']}, not {url}")
        check(one["hops_before_reset"] and not one["hops_after_reset"],
              "stack: /metrics/reset did not empty the hop windows")
        check(one["stats"]["kv_offload_saved_pages_total"] > 0, "stack: no page was saved to the cache server")
        check(one["spilled_pages"] >= 0 and one["stats"]["warm_start_generation"] == 1,
              f"stack: the first engine's warm state {one['stats']}")
        check(two["restored_pages"] > 0, "stack: the restarted engine restored no page")
        check(two["generation"] == 2, f"stack: the restarted engine claimed generation {two['generation']}")
        check(two["cached"] > 0, "stack: the first request after the restart was not a prefix hit")
        check(two["ids"] == one["ids"], f"stack: greedy ids after the restart {two['ids']} != {one['ids']}")
        check(two["stats"]["kv_corrupt_pages_total"] == 0, "stack: corrupt pages after the restart")
        hdr, _ = BlockingClient("127.0.0.1", cs_port).request({"op": "stats"})
        get_t, put_t = timers[0], timers[1]
        emit({
            "phase": "stack", "model": "llama-3.2-1b", "pool_pages": STACK_POOL["num_pages"],
            "trace_spans": one["trace_spans"], "sched_events_with_trace": one["sched_events"],
            "controller_lookup": one["lookup"],
            "warm_restore_pages": two["restored_pages"], "warm_restore_s": round(restore_s, 4),
            "warm_manifest_pages": one["manifest_pages"], "drain_s": round(one["drain_s"], 4),
            "restarted_engine_build_s": round(two["build_s"], 3),
            "ttft_cold_s": round(one["ttft_s"], 4), "ttft_after_restart_s": round(two["ttft_s"], 4),
            "cached_tokens_after_restart": two["cached"], "prompt_tokens": len(first_prompt) + 1,
            # the second request of each engine, the same prompt: a prefix
            # hit in both (in the pool the first request filled, and in the
            # restored pages), each engine's first-request costs paid
            "ttft_hit_live_engine_s": round(one["ttft_again_s"], 4), "cached_tokens_live": one["cached_again"],
            "ttft_second_after_restart_s": round(two["ttft_again_s"], 4),
            "remote_tier": {
                "put_calls": put_t.calls, "put_s": round(put_t.seconds, 4),
                "get_calls": get_t.calls, "get_s": round(get_t.seconds, 4),
                "server_used_bytes": hdr["used_bytes"], "server_entries": hdr["entries"],
                "server_puts": hdr["puts"], "server_gets": hdr["gets"], "server_hits": hdr["hits"],
            },
            "launches": {"first": one["launches"], "restarted": two["launches"]},
            "card": nvidia_smi_line(),
        })
        for life in (one, two):
            for k in SERVE_ROWS[False]:
                launches[_dtag(k, 64)] = launches.get(_dtag(k, 64), 0) + life["launches"][k]
        gc.collect()
        torch.cuda.empty_cache()

        # int8 pools with the cache server as the only tier: int8 blobs
        # cross TCP and come back through the int8 kernels (phase_serve
        # holds saved, restored and hit pages above 0 and corrupt at 0)
        puts0, gets0 = put_t.calls, get_t.calls
        serve("llama-3.2-1b, int8, remote tier",
              dict(model="llama-3.2-1b", kv_cache_dtype="int8", num_pages=40, kv_remote_url=f"127.0.0.1:{cs_port}"),
              64, 0, ())
        check(put_t.calls > puts0 and get_t.calls > gets0, "stack: the int8 server moved no blob over TCP")
    finally:
        for t in timers:
            t.remove()
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)


# -- disaggregated prefill -----------------------------------------------------

# the prompt: 1,100 bytes + BOS = 17 full 64-token pages (2 MiB each in
# bf16) and a 13-token tail the consumer prefills itself
DISAGG_PROMPT_BYTES = 1100
DISAGG_TOKENS = 16
DISAGG_PAGES = (DISAGG_PROMPT_BYTES + 1) // 64
DISAGG_STREAM_LAYERS = 4
# each request asks for the top logprobs of every token: the consumer's,
# decoded over the shipped pages, must match a cold monolithic engine's on
# the same prompt within DISAGG_LOGPROB_TOL (bf16 logits; the two engines
# prefill the tail in different chunks), beside equal ids
DISAGG_LOGPROBS = 5
DISAGG_LOGPROB_TOL = 0.1
# (label, both engines' overrides, the producer's own): the KV ships as TCP
# blobs, as fabric frames of 4 layers, device to device over CUDA IPC, and,
# for int8 pools, over the fabric (their only path)
# after the direct pair of this run, the same prompt goes once more through
# the port's router (disaggregated_prefill) under this request id
DISAGG_ROUTED = ("tcp", "disagg-routed")
DISAGG_RUNS = (
    ("tcp", {}, {}),
    ("fabric", dict(kv_fabric=True), dict(kv_fabric_stream_layers=DISAGG_STREAM_LAYERS)),
    ("device", dict(kv_transfer_device=True), {}),
    ("fabric, int8", dict(kv_fabric=True, kv_cache_dtype="int8"), dict(kv_fabric_stream_layers=DISAGG_STREAM_LAYERS)),
)


def disagg_producer_main() -> None:
    """A disagg producer: the port's api_server in this process with the
    engine flags after the first argument, which names the JSON file this
    writes at SIGTERM: the kernel launches and plain-version calls of the
    process (its counts start at 0 with it), and the seconds the engine
    spent in ``_push_finished_kv`` (the finished prefill to its answer). At
    SIGUSR1 it writes the counts so far to that name with ``.usr1``
    added."""
    import argparse

    import torch

    from production_stack_tpu_torch.engine import api_server
    from production_stack_tpu_torch.engine.config import add_engine_args, config_from_args
    from production_stack_tpu_torch.engine.engine import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    out_path = sys.argv[1]
    p = argparse.ArgumentParser()
    add_engine_args(p)
    cfg = config_from_args(p.parse_args(sys.argv[2:]))
    push = _Timed(LLMEngine, "_push_finished_kv")
    parts = _disagg_timers(producer=True)
    kernels, plains = _counters()

    def counts() -> dict:
        return {"launches": {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()},
                "plain_calls": {k: fn.calls for k, fn in plains.items()},
                "push_s": push.seconds, "push_calls": push.calls,
                "parts": {name: [t.calls, round(t.seconds, 4)] for name, t in parts.items()}}

    def snapshot() -> None:
        """SIGUSR1: the counts so far, beside the final file (``.usr1``)."""
        tmp = Path(out_path + ".tmp")
        tmp.write_text(json.dumps(counts()))
        tmp.replace(out_path + ".usr1")

    async def run():
        import signal

        server, runner = await api_server.serve(cfg)
        asyncio.get_running_loop().add_signal_handler(signal.SIGUSR1, snapshot)
        await api_server._wait_for_termination()
        out = counts()
        await runner.cleanup()
        server.engine.stop()
        Path(out_path).write_text(json.dumps(out))

    asyncio.run(run())


def _disagg_timers(producer: bool) -> dict:
    """Calls and seconds of the transfer's steps in this process (installed
    for the run; a measurement, not the port's): on a producer the fabric
    push, the blob pushes, the device offers (the page copy, and the IPC
    export inside it) and their page_query/page_ready round trips; on a
    consumer the device pulls, their handle fetch from the producer and the
    handle's open (the rest of a pull is its copy, the synchronize and the
    close), and the staged pages' writes into the pool."""
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.kvoffload.transfer import DeviceKVEndpoint, KVTransferSender

    if producer:
        spots = (("fabric_push", LLMEngine, "_fabric_stream_push"), ("blob_push", KVTransferSender, "push"),
                 ("device_page", KVTransferSender, "push_device"),
                 ("offer", ModelRunner, "kv_offer_page"), ("ipc_export", DeviceKVEndpoint, "_export"))
    else:
        spots = (("pull", ModelRunner, "kv_pull_page"), ("handle_fetch", DeviceKVEndpoint, "_fetch_handle"),
                 ("ipc_open", DeviceKVEndpoint, "_open"), ("restore", ModelRunner, "kv_restore_page"))
    return {name: _Timed(cls, attr) for name, cls, attr in spots}


def _wait_http(url: str, proc, timeout: float, what: str, log) -> None:
    import urllib.request

    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            log.seek(0)
            fail(f"disagg: {what} exited with {proc.returncode}: {log.read()[-3000:].decode(errors='replace')}")
        try:
            with urllib.request.urlopen(url, timeout=2):
                return
        except OSError:
            time.sleep(0.3)
    proc.kill()
    fail(f"disagg: {what} did not answer {url} within {timeout:.0f} s")


def _stop_proc(proc) -> None:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


ROUTER_MODULE = "production_stack_tpu_torch.router.app"


def _start_router(port: int, *flags: str) -> tuple:
    """The port's router as a subprocess on ``port`` (``flags``: its
    backends and routing) and the file its log goes to. The caller waits
    for /health with _wait_http, which fails the phase if the router dies;
    nothing else is started in its place."""
    import tempfile

    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(
        [sys.executable, "-m", ROUTER_MODULE, "--host", "127.0.0.1", "--port", str(port), *flags],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), PSTPU_DRAIN_NOTICE="0"), stdout=subprocess.DEVNULL,
        stderr=log,
    )
    return proc, log


def _histogram_quantile(text: str, name: str, q: float) -> "float | None":
    """Prometheus' histogram_quantile over the histogram ``name`` of a
    /metrics page (its label sets summed): linear inside the bucket the
    rank falls in; the top finite bound when it falls in +Inf."""
    import re

    cum: dict = {}
    for line in text.splitlines():
        if line.startswith(name + "_bucket{"):
            le = re.search(r'le="([^"]+)"', line).group(1)
            cum[float(le)] = cum.get(float(le), 0.0) + float(line.rsplit(" ", 1)[1])
    total = cum.get(math.inf, 0.0)
    if not total:
        return None
    rank, lo, lo_count = q * total, 0.0, 0.0
    for le in sorted(cum):
        if cum[le] >= rank:
            if le == math.inf:
                return lo
            return lo + (le - lo) * (rank - lo_count) / (cum[le] - lo_count)
        lo, lo_count = le, cum[le]
    return lo


def _first_records(pages: dict, ids: list) -> dict:
    """For each request id, the engine and TTFT (ms) of its first SLO
    record (the earliest finished) among ``pages``: engine label ->
    GET /slo_records?since=0."""
    out = {}
    for rid in ids:
        recs = [(r["t"], label, r["ttft_ms"]) for label, page in pages.items() for r in page.get("records", [])
                if r.get("request_id") == rid]
        if recs:
            _, label, ttft = min(recs)
            out[rid] = {"engine": label, "ttft_ms": ttft}
    return out


def _router_line(of: str, text: str, engine: dict, client_ttft_s: list, card: str) -> dict:
    """A "router" line: the router's module, the requests it sent each
    backend (vllm_router:finished_requests), its own TTFT of them
    (vllm_router:time_to_first_token_seconds: p50 as histogram_quantile
    reads the buckets, and the exact mean) beside the engines' TTFT of the
    same requests (``engine``: _first_records) and the client's."""
    import re
    import statistics

    name = "vllm_router:time_to_first_token_seconds"
    routes = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^vllm_router:finished_requests\{server="([^"]+)"\} (\S+)$', text, re.M)}
    count = sum(float(v) for v in re.findall(rf"^{name}_count\{{[^}}]*\}} (\S+)$", text, re.M))
    total = sum(float(v) for v in re.findall(rf"^{name}_sum\{{[^}}]*\}} (\S+)$", text, re.M))
    ms = [e["ttft_ms"] for e in engine.values() if e["ttft_ms"] is not None]
    return {"phase": "router", "of": of, "module": ROUTER_MODULE, "routes": routes, "router_ttft_count": count,
            "router_ttft_p50_s": _histogram_quantile(text, name, 0.5),
            "router_ttft_mean_s": total / count if count else None, "engine_ttft": engine,
            "engine_ttft_p50_ms": statistics.median(ms) if ms else None,
            "client_ttft_s": [round(x, 4) for x in client_ttft_s], "card": card}


def _kv_keys(stats: dict) -> dict:
    """The transfer and fabric counters of an engine's stats."""
    return {k: v for k, v in stats.items() if k.startswith(("kv_transfer", "kv_fabric", "kv_offload_device"))}


def _page_bytes(engine, keys: list) -> list:
    """The consumer pool's bytes of the pages ``keys`` name (k, v and, in
    int8 pools, the scales), read after its request."""
    pids = [engine.kv.hash_to_page[bytes.fromhex(k)] for k in keys]
    if engine.kv_quant:
        ks, vs, sks, svs = engine.runner.get_pages_quant(pids)
        return [a.tobytes() + b.tobytes() + c.tobytes() + d.tobytes() for a, b, c, d in zip(ks, vs, sks, svs)]
    ks, vs = engine.runner.get_pages(pids)
    return [a.tobytes() + b.tobytes() for a, b in zip(ks, vs)]


def _blob_bytes(engine, keys: list) -> list:
    """The same pages as the consumer's store holds them (the blobs or
    frames the producer shipped, its exact pool bytes)."""
    from production_stack_tpu_torch.kvoffload import serde as serde_mod

    out = []
    for key in keys:
        blob = engine._offload.store.get(key)
        check(blob is not None, f"disagg: the consumer's store lacks page {key[:12]}")
        if engine.kv_quant:
            qk, sk, qv, sv = serde_mod.get_serde("int8page").deserialize_quant(blob)
            out.append(qk.tobytes() + qv.tobytes() + sk.tobytes() + sv.tobytes())
        else:
            k, v = serde_mod.deserialize(blob)
            out.append(k.tobytes() + v.tobytes())
    return out


async def _stream_ttft(base: str, body: dict, headers: "dict | None" = None) -> float:
    """One streamed completion: the seconds to its first chunk."""
    import aiohttp

    t0 = time.perf_counter()
    ttft = None
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        async with s.post(base + "/v1/completions", json=dict(body, stream=True), headers=headers) as r:
            if r.status != 200:
                fail(f"disagg: streamed completion -> {r.status}: {await r.text()}")
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data:") or line == "data: [DONE]":
                    continue
                if ttft is None:
                    ttft = time.perf_counter() - t0
    return ttft


async def _complete(to: str, req: dict, headers: "dict | None" = None, out: "dict | None" = None,
                    s=None) -> dict:
    """One completion at ``to`` through the session ``s`` (a new one when
    None): its status and Retry-After, then the JSON body, or a 200
    stream's data lines, each with its arrival time. ``out`` (a new dict
    when None) is filled as the answer arrives and returned."""
    import aiohttp

    out = {} if out is None else out
    out.update(times=[], lines=[])
    if s is None:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            return await _complete(to, req, headers, out, s)
    t0 = time.perf_counter()
    async with s.post(to + "/v1/completions", json=req, headers=headers) as r:
        out.update(status=r.status, retry_after=r.headers.get("Retry-After"))
        if r.status != 200 or not req.get("stream"):
            text = await r.text()
            try:
                out["json"] = json.loads(text)
            except ValueError:
                out["text"] = text
            return out
        async for raw in r.content:
            line = raw.decode().strip()
            if line.startswith("data:"):
                out["times"].append(time.perf_counter() - t0)
                out["lines"].append(line)
    return out


async def _get(url: str, as_json: bool = False, s=None):
    """A GET of ``url`` through the session ``s`` (a new one when None):
    its body as text, or parsed when ``as_json``."""
    import aiohttp

    if s is None:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=60)) as s:
            return await _get(url, as_json, s)
    async with s.get(url) as r:
        return await (r.json() if as_json else r.text())


def phase_disagg(launches: "dict | None" = None) -> None:
    """Disaggregated prefill on the one card (docstring, 5f): for each of
    DISAGG_RUNS a producer api_server subprocess and a consumer engine in
    this process behind a port server; the router's two requests driven
    here, then, in the DISAGG_ROUTED run, the same prompt through the port's
    router; the restored pages, ids, launches and counters checked. The
    launches of the main path are added to ``launches``' D = 64 rows."""
    if launches is None:
        launches = {}
    import random
    import tempfile

    import torch

    from production_stack_tpu_torch.engine.api_server import serve as serve_http
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.kv_manager import prefix_hashes

    kernels, plains = _counters()
    prompt = _prompt(random.Random(15), DISAGG_PROMPT_BYTES)
    body = {"model": "llama-3.2-1b", "prompt": prompt, "max_tokens": DISAGG_TOKENS, "temperature": 0.0,
            "ignore_eos": True, "logprobs": DISAGG_LOGPROBS}

    def zero_counts():
        for fn, attr in kernels.values():
            setattr(fn, attr, 0)
        for fn in plains.values():
            fn.calls = 0

    def record(engine, got: dict) -> None:
        """Keep the ids, logprobs and cached tokens ``engine`` streams."""
        orig = engine.generate

        async def recording(seq_id, *a, **kw):
            async for out in orig(seq_id, *a, **kw):
                row = got.setdefault(seq_id, {"ids": [], "logprobs": [], "cached": 0})
                row["ids"].extend(out.token_ids)
                row["logprobs"].extend(out.logprobs or [])
                row["cached"] = out.cached_tokens
                yield out

        engine.generate = recording

    async def cold(overrides: dict):
        """A monolithic engine's answer to the same prompt, the first request
        of a fresh engine: its ids and logprobs (what the consumer's must
        match) and its TTFT (the number set beside the consumer's)."""
        cfg = EngineConfig(model="llama-3.2-1b", host="127.0.0.1", port=_free_port(), **overrides)
        server, runner = await serve_http(cfg)
        got = {}
        record(server.engine, got)
        try:
            ttft = await _stream_ttft(f"http://127.0.0.1:{cfg.port}", body)
        finally:
            await runner.cleanup()
            server.engine.stop()
        (row,) = got.values()
        return dict(row, ttft_s=ttft)

    colds = {}
    for quant in (False, True):
        colds[quant] = asyncio.run(cold(dict(kv_cache_dtype="int8") if quant else {}))
        check(len(colds[quant]["ids"]) == DISAGG_TOKENS and len(colds[quant]["logprobs"]) == DISAGG_TOKENS,
              f"disagg: the cold engine answered {colds[quant]}")
        gc.collect()
        torch.cuda.empty_cache()

    def one(label: str, both: dict, prod_only: dict) -> dict:
        cport, rport, pport = _free_port(), _free_port(), _free_port()
        ccfg = EngineConfig(model="llama-3.2-1b", host="127.0.0.1", port=cport, kv_role="consumer",
                            kv_transfer_port=rport, **both)
        args = ["--model", "llama-3.2-1b", "--host", "127.0.0.1", "--port", str(pport), "--kv-role", "producer",
                "--kv-peer-url", f"127.0.0.1:{rport}"]
        for k, v in {**both, **prod_only}.items():
            flag = "--" + k.replace("_", "-")
            args += [flag] if v is True else [flag, str(v)]
        if both.get("kv_fabric"):
            args += ["--kv-fabric-peer", f"http://127.0.0.1:{cport}"]  # resolved through GET /kv_fabric
        out_json = Path(tempfile.mkdtemp()) / "producer.json"
        log = tempfile.TemporaryFile()
        env = dict(os.environ, PYTHONPATH=str(ROOT), PSTPU_LOG_LEVEL="WARNING")
        # the producer boots while the consumer is built here
        proc = subprocess.Popen(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke as c; "
             "c.disagg_producer_main()", str(out_json), *args],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=log,
        )
        res = {"label": label, "fabric_on": bool(both.get("kv_fabric"))}
        parts = _disagg_timers(producer=False)
        try:
            async def consumer():
                server, runner = await serve_http(ccfg)
                engine = server.engine
                got = {}
                record(engine, got)  # the consumer's ids and logprobs, as the server streams them
                try:
                    await asyncio.get_running_loop().run_in_executor(
                        None, _wait_http, f"http://127.0.0.1:{pport}/health", proc, 180, "the producer", log)
                    zero_counts()
                    import aiohttp

                    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
                        # the router's phase 1: the prompt with max_tokens=1
                        t0 = time.perf_counter()
                        pbody = dict(body, max_tokens=1, kv_transfer_params={"request_id": f"disagg-{label}"})
                        async with s.post(f"http://127.0.0.1:{pport}/v1/completions", json=pbody) as r:
                            if r.status != 200:
                                fail(f"disagg {label}: producer -> {r.status}: {await r.text()}")
                            await r.read()
                        res["prefill_request_s"] = time.perf_counter() - t0
                        # phase 2: the whole request to the consumer
                        res["ttft_s"] = await _stream_ttft(f"http://127.0.0.1:{cport}", body)
                        async with s.get(f"http://127.0.0.1:{pport}/stats") as r:
                            res["producer_stats"] = await r.json()
                        async with s.get(f"http://127.0.0.1:{cport}/metrics") as r:
                            res["consumer_metrics"] = await r.text()
                        async with s.get(f"http://127.0.0.1:{cport}/kv_fabric") as r:
                            res["kv_fabric"] = await r.json()
                    res["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
                    res["plain_calls"] = {k: fn.calls for k, fn in plains.items()}
                    res["stats"] = engine.stats()
                    (row,) = got.values()
                    res["ids"], res["logprobs"], res["cached"] = row["ids"], row["logprobs"], row["cached"]
                    keys = [h.hex() for h in prefix_hashes(engine.tokenizer.encode(prompt), 64)]
                    res["keys"] = keys
                    res["pages"] = _page_bytes(engine, keys)
                    if not both.get("kv_transfer_device"):
                        res["blobs"] = _blob_bytes(engine, keys)
                    res["page_bytes"] = engine.kv_page_bytes
                    if label == DISAGG_ROUTED[0]:
                        res["routed"] = await routed(engine, got)
                finally:
                    await runner.cleanup()
                    engine.stop()

            async def routed(engine, got: dict) -> dict:
                """The same prompt once more, through the port's router in
                disaggregated_prefill mode over this producer and consumer,
                under a fresh request id. The consumer's pools are dropped
                first (sleep, then wake), so it restores the pages again.
                The counts before it: the producer's (written at SIGUSR1)
                and this process's."""
                import signal

                import aiohttp

                loop = asyncio.get_running_loop()
                await loop.run_in_executor(None, engine.sleep, 1)
                await loop.run_in_executor(None, engine.wake_up)
                out = {"stats0": engine.stats(), "launches0": {k: getattr(fn, attr) for k, (fn, attr) in
                                                               kernels.items()},
                       "plain0": {k: fn.calls for k, fn in plains.items()}}
                usr1 = Path(str(out_json) + ".usr1")
                proc.send_signal(signal.SIGUSR1)
                deadline = time.time() + 60
                while not usr1.exists():
                    check(time.time() < deadline and proc.poll() is None,
                          f"disagg {label}: the producer wrote no counts at SIGUSR1")
                    await asyncio.sleep(0.05)
                out["producer0"] = json.loads(usr1.read_text())
                port = _free_port()
                urls = f"http://127.0.0.1:{pport},http://127.0.0.1:{cport}"
                router, rlog = await asyncio.to_thread(
                    _start_router, port, "--static-backends", urls, "--static-models", "llama-3.2-1b,llama-3.2-1b",
                    "--static-model-labels", "prefill,decode", "--routing-logic", "disaggregated_prefill",
                    "--prefill-model-labels", "prefill", "--decode-model-labels", "decode",
                    "--engine-stats-interval", "1")
                base = f"http://127.0.0.1:{port}"
                try:
                    await loop.run_in_executor(None, _wait_http, base + "/health", router, 120, "the router", rlog)
                    out["client_ttft_s"] = await _stream_ttft(base, body, {"X-Request-Id": DISAGG_ROUTED[1]})
                    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=60)) as s:
                        async with s.get(base + "/metrics") as r:
                            out["router_metrics"] = await r.text()
                        out["slo"] = {}
                        for who, u in (("producer", pport), ("consumer", cport)):
                            async with s.get(f"http://127.0.0.1:{u}/slo_records?since=0") as r:
                                out["slo"][who] = await r.json()
                finally:
                    _stop_proc(router)
                out["launches"] = {k: getattr(fn, attr) - out["launches0"][k] for k, (fn, attr) in kernels.items()}
                out["plain_calls"] = {k: fn.calls - out["plain0"][k] for k, fn in plains.items()}
                out["stats"] = engine.stats()
                row = got.get(DISAGG_ROUTED[1], {"ids": [], "cached": 0})
                out["ids"], out["cached"] = row["ids"], row["cached"]
                return out

            asyncio.run(consumer())
        finally:
            _stop_proc(proc)
            res["parts"] = {name: [t.calls, round(t.seconds, 4)] for name, t in parts.items()}
            for t in parts.values():
                t.remove()
        check(proc.returncode == 0 and out_json.exists(),
              f"disagg {label}: the producer exited with {proc.returncode}")
        res["producer"] = json.loads(out_json.read_text())
        gc.collect()
        torch.cuda.empty_cache()
        return res

    def lp_diff(a: list, b: list) -> float:
        """The largest gap between two answers' logprobs, position by
        position: the chosen token's and the sorted top ones'."""
        gaps = [abs(x["logprob"] - y["logprob"]) for x, y in zip(a, b)]
        gaps += [abs(p - q) for x, y in zip(a, b) for p, q in zip(x["top_logprobs"], y["top_logprobs"])]
        return max(gaps) if gaps and len(a) == len(b) else float("inf")

    runs = [one(*run) for run in DISAGG_RUNS]
    card = nvidia_smi_line()
    for r in runs:  # the lines first, then the checks
        st, pst = r["stats"], r["producer_stats"]
        c = colds["int8" in r["label"]]
        r["cold_ids"], r["lp_diff"] = c["ids"], lp_diff(r["logprobs"], c["logprobs"])
        pages = (st.get("kv_fabric_received_pages_total", 0) + st["kv_transfer_received_chunks_total"]
                 + st["kv_transfer_device_pages_total"])
        # the producer's counts of the direct pair: in the DISAGG_ROUTED run,
        # those of its SIGUSR1 snapshot, before the routed request
        prod = r["routed"]["producer0"] if "routed" in r else r["producer"]
        emit({
            "phase": "disagg", "transport": r["label"], "model": "llama-3.2-1b", "pages": pages,
            "mib": round(pages * r["page_bytes"] / 2**20, 3),
            "blob_bytes": st["kv_transfer_received_bytes_total"],
            "push_s": round(prod["push_s"], 4), "push_calls": prod["push_calls"],
            "prefill_request_s": round(r["prefill_request_s"], 4),
            "consumer_ttft_s": round(r["ttft_s"], 4), "cold_ttft_s": round(c["ttft_s"], 4),
            "cached_tokens": r["cached"], "ids": r["ids"], "cold_ids": r["cold_ids"],
            "logprob_max_diff_vs_cold": round(r["lp_diff"], 5), "logprob_tol": DISAGG_LOGPROB_TOL,
            "producer_launches": prod["launches"], "consumer_launches": r["launches"],
            # [calls, seconds] of the transfer's steps in each process
            "producer_parts": prod["parts"], "consumer_parts": r["parts"],
            "card": card,
        })
    routed_run = next(r for r in runs if r["label"] == DISAGG_ROUTED[0])
    rt = routed_run["routed"]
    final = routed_run["producer"]
    rt["producer_launches"] = {k: final["launches"][k] - rt["producer0"]["launches"][k] for k in final["launches"]}
    rt["producer_plain_calls"] = {k: final["plain_calls"][k] - rt["producer0"]["plain_calls"][k]
                                  for k in final["plain_calls"]}
    rt["restored"] = rt["stats"]["kv_offload_hit_pages_total"] - rt["stats0"]["kv_offload_hit_pages_total"]
    emit(_router_line("disagg", rt["router_metrics"],
                      {who: _first_records({who: rt["slo"][who]}, [DISAGG_ROUTED[1]])[DISAGG_ROUTED[1]]
                       for who in ("producer", "consumer")}, [rt["client_ttft_s"]], card))
    emit({"phase": "disagg", "transport": DISAGG_ROUTED[0], "through": ROUTER_MODULE, "ids": rt["ids"],
          "direct_ids": routed_run["ids"], "cached_tokens": rt["cached"], "restored_pages": rt["restored"],
          "producer_launches": rt["producer_launches"], "consumer_launches": rt["launches"], "card": card})
    fp = SERVE_ROWS[False]
    check(rt["ids"] == routed_run["ids"],
          f"disagg through the router: ids {rt['ids']} != the direct run's {routed_run['ids']}")
    check(rt["restored"] >= DISAGG_PAGES and rt["cached"] == 64 * DISAGG_PAGES,
          f"disagg through the router: the consumer restored {rt['restored']} pages, cached {rt['cached']}")
    check(rt["producer_launches"][fp[1]] > 0 and rt["producer_launches"][fp[2]] > 0
          and rt["producer_launches"][fp[0]] == 0,
          f"disagg through the router: producer launches {rt['producer_launches']}")
    check(rt["launches"][fp[0]] > 0 and rt["launches"][fp[1]] == 16,
          f"disagg through the router: consumer launches {rt['launches']}")
    check(all(n == 0 for n in list(rt["plain_calls"].values()) + list(rt["producer_plain_calls"].values())),
          f"disagg through the router: plain versions ran {rt['plain_calls']} / {rt['producer_plain_calls']}")
    for k in fp:  # the producer's are in its final counts, added below
        launches[_dtag(k, 64)] = launches.get(_dtag(k, 64), 0) + rt["launches"][k]
    for r in runs:
        label, st, pst, prod = r["label"], r["stats"], r["producer_stats"], r["producer"]
        quant = "int8" in label
        fp, q = SERVE_ROWS[False], SERVE_ROWS[True]
        check(st["kv_offload_hit_pages_total"] >= DISAGG_PAGES and r["cached"] == 64 * DISAGG_PAGES,
              f"disagg {label}: the consumer restored {st['kv_offload_hit_pages_total']} pages, cached {r['cached']}")
        check(len(r["ids"]) == DISAGG_TOKENS, f"disagg {label}: {len(r['ids'])} ids")
        # the consumer's answer over the shipped pages is the cold
        # monolithic engine's (int8 pools: a cold int8 engine's)
        check(r["ids"] == r["cold_ids"], f"disagg {label}: ids {r['ids']} != the cold engine's {r['cold_ids']}")
        check(r["lp_diff"] <= DISAGG_LOGPROB_TOL,
              f"disagg {label}: logprobs {r['lp_diff']:.4f} from the cold engine's (tolerance {DISAGG_LOGPROB_TOL})")
        check(st["kv_corrupt_pages_total"] == 0, f"disagg {label}: corrupt pages on the consumer")
        # the producer ran the prefill kernel with its fused write and no
        # decode; the consumer the decode kernel and the prefill kernel for
        # the tail only (one 13-token chunk: a launch per layer)
        rows = q if quant else fp
        other = fp if quant else q
        check(prod["launches"][rows[1]] > 0 and prod["launches"][rows[2]] > 0,
              f"disagg {label}: producer launches {prod['launches']}")
        check(prod["launches"][rows[0]] == 0, f"disagg {label}: the producer decoded {prod['launches']}")
        check(r["launches"][rows[0]] > 0 and r["launches"][rows[1]] == 16,
              f"disagg {label}: consumer launches {r['launches']}")
        for who, counts in (("producer", prod), ("consumer", r)):
            check(all(counts["launches"][k] == 0 for k in other),
                  f"disagg {label}: the {who} ran the other mode's kernels {counts['launches']}")
            check(all(n == 0 for n in counts["plain_calls"].values()),
                  f"disagg {label}: the {who} ran plain versions {counts['plain_calls']}")
        check(r["kv_fabric"].get("enabled") == r["fabric_on"], f"disagg {label}: GET /kv_fabric {r['kv_fabric']}")
        if "blobs" in r:
            check(r["pages"] == r["blobs"], f"disagg {label}: restored pages differ from the shipped bytes")
        if label.startswith("fabric"):
            # the client counts a page once per frame: 16 layers in windows of 4
            windows = -(-16 // DISAGG_STREAM_LAYERS)
            check(st["kv_fabric_received_pages_total"] == DISAGG_PAGES and pst["kv_fabric_pushed_pages_total"]
                  == windows * DISAGG_PAGES and pst["kv_fabric_fallbacks_total"] == 0
                  and st["kv_fabric_corrupt_frames_total"] == 0 and pst["kv_fabric_corrupt_frames_total"] == 0,
                  f"disagg {label}: fabric counters {_kv_keys(st)} / {_kv_keys(pst)}")
            check("vllm:kv_fabric_peer_bandwidth_bytes_per_sec" in r["consumer_metrics"],
                  f"disagg {label}: /metrics lacks the fabric bandwidth gauge")
        if label == "tcp":
            check(pst["kv_transfer_sent_chunks_total"] == DISAGG_PAGES
                  and st["kv_transfer_received_chunks_total"] == DISAGG_PAGES,
                  f"disagg tcp: {_kv_keys(pst)} / {_kv_keys(st)}")
        if label == "device":
            # every page over CUDA IPC: no blob crossed, and admission wrote
            # the staged device pages
            check(pst["kv_transfer_device_pages_total"] == DISAGG_PAGES and pst["kv_transfer_sent_chunks_total"] == 0
                  and st["kv_transfer_device_pages_total"] == DISAGG_PAGES
                  and st["kv_transfer_received_chunks_total"] == 0
                  and st["kv_offload_device_loaded_pages_total"] == DISAGG_PAGES,
                  f"disagg device: producer {_kv_keys(pst)} / consumer {_kv_keys(st)}")
        for k in rows:
            launches[_dtag(k, 64)] = launches.get(_dtag(k, 64), 0) + prod["launches"][k] + r["launches"][k]
    fp_runs = [r for r in runs if "int8" not in r["label"]]
    for r in fp_runs[1:]:
        check(r["pages"] == fp_runs[0]["pages"], f"disagg {r['label']}: restored pages differ from the tcp run's")
        check(r["ids"] == fp_runs[0]["ids"], f"disagg {r['label']}: ids {r['ids']} != tcp's {fp_runs[0]['ids']}")


# the fleet phase: the prompt (1,091 tokens with BOS: 17 full 64-token pages
# and a 3-token tail), the stream's length, the tokens each hop's source has
# emitted of the stream before its /migrate_out (the second hop must freeze
# before the stream's 62nd token, or its snapshot would hold an 18th full
# page), engine C's boot prefetch and the pool of each engine
FLEET_PROMPT_BYTES = 1090
FLEET_PAGES = (FLEET_PROMPT_BYTES + 1) // 64
FLEET_TOKENS = 128
FLEET_HOPS = (16, 8)
FLEET_PREFETCH = 64
FLEET_POOL_PAGES = 256


class _ThreadCount:
    """A kernel wrapper's launch counter that also files each launch under
    the thread that made it, an engine's loop thread, so the phase tells
    two engines of this process apart (a measurement of this run, not the
    port's: installed for the fleet phase, then the plain count is put
    back)."""

    def __init__(self, total: int):
        import collections

        self.total = total
        self.by = collections.Counter()

    def __iadd__(self, n):
        import threading

        self.total += int(n)
        self.by[threading.get_ident()] += int(n)
        return self


def _fleet_launches(counters: dict, ident: int) -> dict:
    return {name: c.by[ident] for name, c in counters.items()}


def phase_fleet(launches: "dict | None" = None) -> None:
    """The fleet KV directory and live migration (docstring, 5g): the port's
    cache server with the directory, engines A and B behind the port's
    router's kvaware routing, one stream migrated A -> B through the shared
    tier and B -> A over the fabric, a second request routed by the
    directory, and engine C's boot prefetch. The launches of its engines are
    added to ``launches``' D = 64 rows."""
    if launches is None:
        launches = {}
    import random
    import statistics

    import aiohttp
    import torch

    from production_stack_tpu_torch.engine.api_server import serve as serve_http
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.scheduler import SamplingParams
    from production_stack_tpu_torch.kvoffload.protocol import BlockingClient

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    kernels, plains = _counters()
    counters = {}
    for name, (fn, attr) in kernels.items():
        counters[name] = _ThreadCount(getattr(fn, attr))
        setattr(fn, attr, counters[name])
    plain0 = {k: fn.calls for k, fn in plains.items()}
    cport, mport, rport = _free_port(), _free_port(), _free_port()
    cache_url = f"127.0.0.1:{cport}"
    procs = [_start_service("cache_server", cport, "--directory", "--metrics-port", str(mport))]
    prompt = _prompt(random.Random(16), FLEET_PROMPT_BYTES)
    rid = "fleet-mig"
    body = {"model": "llama-3.2-1b", "prompt": prompt, "max_tokens": FLEET_TOKENS, "temperature": 0.0,
            "ignore_eos": True, "stream": True}
    legs: list = []  # one per generate call: [engine label, seq id, ids, outputs, cached tokens]

    def record(engine, label: str) -> None:
        orig = engine.generate

        async def recording(seq_id, *a, **kw):
            leg = [label, seq_id, [], 0, 0]
            legs.append(leg)
            async for out in orig(seq_id, *a, **kw):
                if not (out.finished and out.finish_reason == "migrated"):  # its repeat of the last id
                    leg[2].extend(out.token_ids)
                    leg[3] += 1
                leg[4] = out.cached_tokens
                yield out

        engine.generate = recording

    def engine_cfg(**kw):
        return EngineConfig(model="llama-3.2-1b", host="127.0.0.1", port=_free_port(), num_pages=FLEET_POOL_PAGES,
                            kv_offload_cpu_gb=2.0, kv_offload_max_io_pages=0, kv_remote_url=cache_url,
                            kv_directory_url=cache_url, kv_directory_flush_s=0.2, **kw)

    def dir_request(hdr: dict) -> dict:
        c = BlockingClient("127.0.0.1", cport, timeout=10)
        try:
            return c.request(hdr)[0]
        finally:
            c.close()

    res: dict = {}

    async def fleet():
        servers = {}
        for label in ("A", "B"):
            cfg = engine_cfg(kv_fabric=True)
            server, runner = await serve_http(cfg)
            record(server.engine, label)
            servers[label] = (server.engine, runner, f"http://127.0.0.1:{cfg.port}")
        eng = {k: v[0] for k, v in servers.items()}
        url = {k: v[2] for k, v in servers.items()}
        router, router_log = await asyncio.to_thread(
            _start_router, rport, "--static-backends", f"{url['A']},{url['B']}",
            "--static-models", "llama-3.2-1b,llama-3.2-1b",
            "--routing-logic", "kvaware", "--kv-directory-url", cache_url, "--engine-stats-interval", "1")
        procs.append(router)
        base = f"http://127.0.0.1:{rport}"
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, _wait_http, base + "/health", router, 120, "the router", router_log)
            # the unmigrated run: A's first request, straight to A
            ref: dict = {}
            await _complete(url["A"], body, {"X-Request-Id": "fleet-ref"}, ref)
            ref_ids = legs[-1][2]
            check(len(ref_ids) == FLEET_TOKENS, f"fleet: the unmigrated run gave {len(ref_ids)} ids")
            # a cold engine's first request, in a process the first one
            # warmed: B's, with a prompt of the same length and no page in
            # common (B must not hold the stream's prefix)
            cold: dict = {}
            other = _prompt(random.Random(17), FLEET_PROMPT_BYTES)
            await _complete(url["B"], dict(body, prompt=other, max_tokens=8), {"X-Request-Id": "fleet-cold"}, cold)
            res["cold_ttft_s"] = cold["times"][0]
            await asyncio.sleep(1.0)  # A's resident claims reach the directory (flush 0.2 s)
            # the stream through the router: the directory names A resident
            client: dict = {}
            task = asyncio.create_task(_complete(base, body, {"X-Request-Id": rid}, client))
            hops = []
            order = ("A", "B", "A")
            for h, at in enumerate(FLEET_HOPS):
                src, dst = order[h], order[h + 1]
                deadline = time.time() + 120
                while not any(leg[0] == src and leg[1] == rid and len(leg[2]) >= at for leg in legs[-1:]):
                    check(time.time() < deadline and not task.done(), f"fleet hop {h + 1}: the stream stalled")
                    await asyncio.sleep(0.005)
                listed = (await _get(url[src] + "/migratable", as_json=True))["requests"]
                check(any(r["request_id"] == rid and r["migratable"] for r in listed),
                      f"fleet hop {h + 1}: {src}'s /migratable lists {listed}")
                if h == 0:
                    # the first hop's target has its fabric listener down: the
                    # ship falls back to the shared tier (the cache server),
                    # as any failed fabric ship does; the second hop goes
                    # over the fabric. (The other order would not reach the
                    # shared tier: pages a fabric landed sit in the local
                    # tiers alone, where the tier save finds them and writes
                    # nothing.)
                    eng[dst]._fabric_server.stop()
                before = {k: (e.stats(), e.migration.stats(), e.migration.duration_hist._sum, e.kv.offload_hits)
                          for k, e in eng.items()}
                per_thread = {k: _fleet_launches(counters, e._thread.ident) for k, e in eng.items()}
                t0 = time.perf_counter()
                async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=300)) as s:
                    async with s.post(url[src] + "/migrate_out", json={"request_id": rid, "target_url": url[dst]}) as r:
                        mo = dict(await r.json(), status=r.status)
                hops.append(dict(h=h + 1, src=src, dst=dst, mo=mo, migrate_out_s=time.perf_counter() - t0,
                                 before=before, per_thread=per_thread))
                check(mo["status"] == 200 and mo.get("migrated"), f"fleet hop {h + 1}: /migrate_out -> {mo}")
            await asyncio.wait_for(task, 600)
            end_threads = {k: _fleet_launches(counters, e._thread.ident) for k, e in eng.items()}
            res["client"], res["hops"] = client, hops
            res["legs"] = [list(leg) for leg in legs if leg[1] == rid]
            res["ref_ids"] = ref_ids
            res["after"] = {k: (e.stats(), e.migration.stats(), e.migration.duration_hist._sum, e.kv.offload_hits)
                            for k, e in eng.items()}
            res["end_threads"] = end_threads
            res["threads"] = {k: e._thread.ident for k, e in eng.items()}
            # the margin at the first id the spliced stream differs in (bf16)
            ids = [i for leg in res["legs"] for i in leg[2]]
            j = next((j for j, (a, b) in enumerate(zip(ids, ref_ids)) if a != b), None)
            res["first_diff"] = j
            if j is not None:
                p = SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True, logprobs=2)
                top = None
                async for o in eng["A"].generate("fleet-margin", prompt_token_ids=eng["A"].tokenizer.encode(prompt)
                                                 + ref_ids[:j], params=p):
                    top = top or o.logprobs[0]["top_logprobs"]
                res["margin"] = top[0] - top[1]
            # the second request: the same 17-page prefix, another tail
            await asyncio.sleep(1.0)  # the hops' resident claims reach the directory
            prompt2 = prompt[: 64 * FLEET_PAGES - 1] + "and a question of its own about it"
            tokens2 = eng["A"].tokenizer.encode(prompt2)
            res["dir_lookup"] = await asyncio.get_running_loop().run_in_executor(
                None, dir_request, {"op": "dir_lookup", "tokens": tokens2})
            hits0 = {k: e.kv.prefix_hits for k, e in eng.items()}
            rtext0 = await _get(base + "/metrics")
            second: dict = {}
            await _complete(base, dict(body, prompt=prompt2, max_tokens=8), {"X-Request-Id": "fleet-second"}, second)
            res["second"] = {"leg": next(list(leg) for leg in legs if leg[1] == "fleet-second"),
                             "hits": {k: e.kv.prefix_hits - hits0[k] for k, e in eng.items()}, "url": url,
                             "routes": {c: _metric_total(await _get(base + "/metrics"),
                                                         f"vllm_router:kvaware_v2_{c}_routes_total")
                                        - _metric_total(rtext0, f"vllm_router:kvaware_v2_{c}_routes_total")
                                        for c in ("resident", "restorable", "cold")}}
            rtext = await _get(base + "/metrics")
            res["router"] = {n: _metric_total(rtext, f"vllm_router:{n}")
                             for n in ("session_repins_total", "migration_splice_failures_total")}
            slo = {k: await _get(url[k] + "/slo_records?since=0", as_json=True) for k in ("A", "B")}
            res["router_line"] = _router_line("fleet", rtext, _first_records(slo, [rid, "fleet-second"]),
                                              [client["times"][0], second["times"][0]], card)
            res["cache_metrics"] = await _get(f"http://127.0.0.1:{mport}/metrics")
            res["dump"] = await asyncio.get_running_loop().run_in_executor(None, dir_request, {"op": "dir_dump"})
            # engine C: boots with the fleet's warmest chunks prefetched (the
            # admission pull off, so only the boot prefetch can restore)
            ccfg = engine_cfg(warm_prefetch_on_boot=FLEET_PREFETCH, kv_directory_pull=False)
            server, crunner = await serve_http(ccfg)
            record(server.engine, "C")
            c = server.engine
            try:
                res["C_boot"] = (c.kv_directory_prefetched_pages, c.kv_directory_prefetch_seconds)
                first: dict = {}
                await _complete(f"http://127.0.0.1:{ccfg.port}", dict(body, max_tokens=8), {"X-Request-Id": "fleet-c"},
                                first)
                res["C_first"] = dict(ttft_s=first["times"][0], leg=next(list(leg) for leg in legs
                                                                          if leg[1] == "fleet-c"),
                                      offload_hits=c.kv.offload_hits, stats=c.stats(),
                                      launches=_fleet_launches(counters, c._thread.ident))
            finally:
                await crunner.cleanup()
                c.stop()
        finally:
            for engine, runner, _ in servers.values():
                await runner.cleanup()
                engine.stop()

    try:
        asyncio.run(fleet())
    finally:
        for p in procs:
            _stop_proc(p)
        for name, (fn, attr) in kernels.items():
            setattr(fn, attr, counters[name].total)
        gc.collect()
        torch.cuda.empty_cache()
    # the lines first, then the checks
    client, hops = res["client"], res["hops"]
    events = [i for i, line in enumerate(client["lines"]) if '"choices": [{' in line]
    gaps = [client["times"][b] - client["times"][a] for a, b in zip(events, events[1:])]
    median_gap = statistics.median(gaps)
    legs_out = res["legs"]
    splice_at = [sum(leg[3] for leg in legs_out[: k + 1]) for k in range(len(legs_out) - 1)]
    for k, hop in enumerate(hops):
        src, dst = hop["src"], hop["dst"]
        sa, ms, ds, oh = res["after"][src]
        sb, mb, db, _ = hop["before"][src]
        da, _, _, dh = res["after"][dst]
        dbf = hop["before"][dst]
        # the target's launches from this hop's start to the stream's end:
        # the continuation's alone (the target serves nothing else then)
        tl = {n: res["end_threads"][dst][n] - hop["per_thread"][dst][n] for n in SERVE_ROWS[False]}
        i = splice_at[k]
        hop["line"] = {
            "phase": "fleet", "hop": hop["h"], "source": src, "target": dst,
            "path": "shared tier (the target's fabric listener down)" if k == 0 else "fabric",
            "pages_moved": hop["mo"].get("pages_moved"),
            "migration_pages_moved": ms["migration_pages_moved_total"] - mb["migration_pages_moved_total"],
            "migration_fabric_pages": ms["migration_fabric_pages_total"] - mb["migration_fabric_pages_total"],
            "fabric_pushed_pages": sa["kv_fabric_pushed_pages_total"] - sb["kv_fabric_pushed_pages_total"],
            "fabric_received_pages": da["kv_fabric_received_pages_total"] - dbf[0]["kv_fabric_received_pages_total"],
            "fabric_fallbacks": sa["kv_fabric_fallbacks_total"] - sb["kv_fabric_fallbacks_total"],
            "tier_saved_pages": sa["kv_offload_saved_pages_total"] - sb["kv_offload_saved_pages_total"],
            "target_restored_pages": dh - dbf[3],
            # vllm:migration_duration_seconds (from the frozen sequence's
            # ship to its commit) and the whole /migrate_out call
            "freeze_to_commit_s": round(ds - db, 4), "migrate_out_s": round(hop["migrate_out_s"], 4),
            "target_launches": tl,
            "splice_gap_s": round(client["times"][events[i]] - client["times"][events[i - 1]], 4),
            "median_gap_s": round(median_gap, 4), "tokens_per_event": 8, "card": card,
        }
        emit(hop["line"])
    ids = [i for leg in legs_out for i in leg[2]]
    second = res["second"]
    engines_res = res["dir_lookup"].get("engines") or {}
    best = max((v["resident_tokens"] for v in engines_res.values()), default=0)
    named = sorted(u for u, v in engines_res.items() if v["resident_tokens"] == best)
    routed_url = second["url"][second["leg"][0]]
    cboot_pages, cboot_s = res["C_boot"]
    cfirst = res["C_first"]
    emit({"phase": "fleet", "stream_tokens": len(ids), "legs": [[leg[0], len(leg[2])] for leg in legs_out],
          "ids_equal_before_a_flip": res["first_diff"] if res["first_diff"] is not None else len(ids),
          "first_diff_top2_margin": res.get("margin"), "margin_bar": FORWARD_LOGIT_BOUND,
          "router": res["router"], "second_request": {"routed_to": second["leg"][0], "cached": second["leg"][4],
                                                      "directory_resident": named, "prefix_hit_pages": second["hits"],
                                                      "route_classes": second["routes"]},
          "card": card})
    emit(res["router_line"])
    emit({"phase": "fleet", "engine": "C", "boot_prefetch_pages": cboot_pages,
          "boot_prefetch_s": round(cboot_s, 4), "first_ttft_s": round(cfirst["ttft_s"], 4),
          "cold_engine_first_ttft_s": round(res["cold_ttft_s"], 4), "first_cached_tokens": cfirst["leg"][4],
          "first_restored_pages": cfirst["offload_hits"], "card": card})
    plain_calls = {k: fn.calls - plain0[k] for k, fn in plains.items()}
    all_threads = dict(res["end_threads"], C=cfirst["launches"])
    for n in SERVE_ROWS[False]:
        launches[n] = launches.get(n, 0) + sum(t[n] for t in all_threads.values())
    emit({"phase": "fleet", "launches": {k: {n: t[n] for n in SERVE_ROWS[False]} for k, t in all_threads.items()},
          "plain_calls": plain_calls, "seconds": round(time.perf_counter() - t_phase, 2), "card": card})
    # the checks
    check(client["status"] == 200 and sum('"[DONE]"' in x or x == "data: [DONE]" for x in client["lines"]) == 1
          and not any("pstpu_migration" in x for x in client["lines"]),
          f"fleet: the client's stream {client['status']} ends {client['lines'][-3:]}")
    usage = json.loads([x for x in client["lines"] if '"usage"' in x][-1][len("data: "):])["usage"]
    check(usage["completion_tokens"] == FLEET_TOKENS and len(ids) == FLEET_TOKENS,
          f"fleet: the client got {usage} and the legs {len(ids)} ids")
    check([leg[0] for leg in legs_out] == ["A", "B", "A"], f"fleet: the stream's legs {legs_out}")
    j = res["first_diff"]
    check(j is None or res["margin"] < FORWARD_LOGIT_BOUND,
          f"fleet: the spliced ids differ at {j} where the unmigrated run's top-2 margin is {res.get('margin')}")
    check(res["router"]["session_repins_total"] == 2 and res["router"]["migration_splice_failures_total"] == 0,
          f"fleet: the router's splices {res['router']}")
    for k, hop in enumerate(hops):
        line = hop["line"]
        check(line["pages_moved"] == FLEET_PAGES and line["migration_pages_moved"] == FLEET_PAGES,
              f"fleet hop {k + 1}: {line}")
        if k == 0:
            # through the cache server: saved there by the source, fetched
            # and restored by the target
            check(line["migration_fabric_pages"] == 0 and line["fabric_fallbacks"] == FLEET_PAGES
                  and line["tier_saved_pages"] == FLEET_PAGES and line["fabric_received_pages"] == 0
                  and line["target_restored_pages"] == FLEET_PAGES, f"fleet hop 1 (shared tier): {line}")
        else:
            # engine to engine; the target (the stream's first engine) still
            # holds the prefix in its pool, a prefix hit, so it restores none
            check(line["migration_fabric_pages"] == FLEET_PAGES and line["fabric_received_pages"] == FLEET_PAGES
                  and line["fabric_pushed_pages"] == FLEET_PAGES and line["tier_saved_pages"] == 0,
                  f"fleet hop 2 (fabric): {line}")
        # the target prefilled the tail chunk alone (one launch a layer) and decoded
        tl = line["target_launches"]
        check(tl["prefill_attention"] == 16 and tl["kv_page_write"] == 16 and tl["decode_attention"] > 0,
              f"fleet hop {k + 1}: the target's launches {tl}")
    check(named and routed_url in named and second["leg"][4] >= 64 * FLEET_PAGES
          and second["hits"][second["leg"][0]] >= FLEET_PAGES and second["routes"]["resident"] == 1,
          f"fleet: the second request went to {routed_url} (the directory names {named}): {second}")
    check(cboot_pages >= FLEET_PAGES and cfirst["leg"][4] >= 64 * FLEET_PAGES
          and cfirst["offload_hits"] >= FLEET_PAGES, f"fleet: engine C's boot prefetch {res['C_boot']}: {cfirst}")
    check("vllm:kv_directory_entries" in res["cache_metrics"], "fleet: the cache server's metrics page")
    check(all(n == 0 for n in plain_calls.values()), f"fleet: plain versions ran {plain_calls}")


CHAOS_REQUESTS = 16  # sequential failover requests, each with its own prompt
CHAOS_TOKENS = 16
CHAOS_BURST = 24  # concurrent requests of the overload burst
CHAOS_BURST_TOKENS = 64
CHAOS_SEATS = 4  # the engine's max_num_seqs and max_waiting_seqs
# under one 64-token page: no request shares a cached page with another, so
# each routed answer is computed as its direct twin was
CHAOS_PROMPT_BYTES = 40
CHAOS_RETRY_BUDGET = 3
CHAOS_BREAKER_THRESHOLD = 3
# scripts/chaos_check_torch.py's 1.0 s TTFT deadline is sized for fakes: a
# burst request queued on the real engine gets its first byte only once a
# seat frees (the four ahead of it decode 64 tokens), so the deadline here
# is 3 s; each of the hung fake's attempts costs that much until its
# breaker opens
CHAOS_TTFT_DEADLINE = 3.0
CHAOS_FAKE_MODULE = "production_stack_tpu_torch.testing.fake_engine"


def phase_chaos(launches: "dict | None" = None) -> None:
    """The stack's chaos drill with a real engine (docstring, 5l): two of
    the port's fake engines as subprocesses, one failing every request and
    one hanging, and an in-process llama-3.2-1b engine behind the port's
    router with retries, a TTFT deadline and circuit breakers. Sequential
    requests fail over to the engine with its own text; a concurrent burst
    past its seats sheds with 429 + Retry-After. The launches of its engine
    are added to ``launches``' D = 64 rows."""
    if launches is None:
        launches = {}
    import random
    import statistics
    import tempfile

    import aiohttp
    import torch

    from production_stack_tpu_torch.engine.api_server import serve as serve_http
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.router.resilience import CLOSED, OPEN

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    kernels, plains = _counters()
    plain0 = {k: fn.calls for k, fn in plains.items()}

    def launched() -> dict:
        return {n: getattr(*kernels[n]) for n in SERVE_ROWS[False]}

    rng = random.Random(22)
    prompts = [_prompt(rng, CHAOS_PROMPT_BYTES) for _ in range(CHAOS_REQUESTS + CHAOS_BURST)]
    fakes = {"fail": (_free_port(), "--fail-rate", "1.0"), "hang": (_free_port(), "--hang")}
    url = {k: f"http://127.0.0.1:{v[0]}" for k, v in fakes.items()}
    procs, logs = {}, {}
    for k, (port, *fault) in fakes.items():
        logs[k] = tempfile.TemporaryFile()
        procs[k] = subprocess.Popen(
            [sys.executable, "-m", CHAOS_FAKE_MODULE, "--port", str(port), "--model", "llama-3.2-1b", *fault],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.DEVNULL, stderr=logs[k])
    rport = _free_port()
    base = f"http://127.0.0.1:{rport}"
    res: dict = {}

    def body(prompt: str, n: int, stream: bool = False) -> dict:
        return {"model": "llama-3.2-1b", "prompt": prompt, "max_tokens": n, "temperature": 0.0,
                "ignore_eos": True, "stream": stream}

    def breakers(text: str) -> dict:
        return {k: int(_metric_total(text, f'vllm_router:circuit_state{{backend="{u}"}}'))
                for k, u in url.items()}

    async def chaos():
        cfg = EngineConfig(model="llama-3.2-1b", host="127.0.0.1", port=_free_port(), max_num_seqs=CHAOS_SEATS,
                           max_waiting_seqs=CHAOS_SEATS, enable_debug_endpoints=True)
        server, runner = await serve_http(cfg)
        url["engine"] = f"http://127.0.0.1:{cfg.port}"
        loop = asyncio.get_running_loop()
        try:
            for k in fakes:
                await loop.run_in_executor(None, _wait_http, url[k] + "/health", procs[k], 60, f"the {k} fake",
                                           logs[k])
            backends = [url["fail"], url["hang"], url["engine"]]
            procs["router"], logs["router"] = await asyncio.to_thread(
                _start_router, rport, "--static-backends", ",".join(backends),
                "--static-models", ",".join(["llama-3.2-1b"] * 3), "--engine-stats-interval", "1",
                "--retry-max-attempts", str(CHAOS_RETRY_BUDGET), "--retry-backoff-base", "0.01",
                "--deadline-ttft", str(CHAOS_TTFT_DEADLINE), "--deadline-inter-chunk", "2.0",
                "--breaker-failure-threshold", str(CHAOS_BREAKER_THRESHOLD), "--breaker-cooldown", "300",
                "--trace-buffer-size", "16384", "--enable-debug-endpoints")
            await loop.run_in_executor(None, _wait_http, base + "/health", procs["router"], 120, "the router",
                                       logs["router"])
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=300)) as s:
                # each prompt straight to the engine first (this warms it too)
                res["direct"] = [await _complete(url["engine"], body(p, CHAOS_TOKENS), s=s)
                                 for p in prompts[:CHAOS_REQUESTS]]
                t0, l0 = time.perf_counter(), launched()
                res["routed"] = [await _complete(base, body(p, CHAOS_TOKENS), s=s) for p in prompts[:CHAOS_REQUESTS]]
                res["failover_s"] = time.perf_counter() - t0
                res["failover_launches"] = {n: v - l0[n] for n, v in launched().items()}
                res["failover_router"] = await _get(base + "/metrics", s=s)
                res["traces"] = await _get(base + "/v1/traces?limit=16384", as_json=True, s=s)
                e0 = await _get(url["engine"] + "/metrics", s=s)
                t0 = time.perf_counter()
                res["burst"] = await asyncio.gather(*(_complete(base, body(p, CHAOS_BURST_TOKENS, stream=True), s=s)
                                                      for p in prompts[CHAOS_REQUESTS:]))
                res["burst_s"] = time.perf_counter() - t0
                e1 = await _get(url["engine"] + "/metrics", s=s)
                res["sheds"] = (_metric_total(e1, "vllm:num_requests_shed_total")
                                - _metric_total(e0, "vllm:num_requests_shed_total"))
                res["burst_router"] = await _get(base + "/metrics", s=s)
        finally:
            await runner.cleanup()
            server.engine.stop()

    l_start = launched()
    try:
        asyncio.run(chaos())
    finally:
        for k in ("router", "fail", "hang"):
            if k in procs:
                _stop_proc(procs[k])
        gc.collect()
        torch.cuda.empty_cache()
    phase_launches = {n: v - l_start[n] for n, v in launched().items()}
    for n in SERVE_ROWS[False]:
        launches[n] = launches.get(n, 0) + phase_launches[n]
    plain_calls = {k: fn.calls - plain0[k] for k, fn in plains.items()}
    # the lines first, then the checks
    attempts: dict = {}
    for trace in res["traces"].get("traces", []):
        for span in trace["spans"]:
            if span["name"] == "router.proxy":
                rid = span["attrs"].get("request_id")
                attempts[rid] = attempts.get(rid, 0) + 1
    routed, direct, burst = res["routed"], res["direct"], res["burst"]
    texts_equal = sum(r["status"] == 200 and d["status"] == 200
                      and r["json"]["choices"][0]["text"] == d["json"]["choices"][0]["text"]
                      for r, d in zip(routed, direct))
    ok_burst = [b for b in burst if b["status"] == 200]
    shed_burst = [b for b in burst if b["status"] == 429]
    ttfts = [b["times"][0] for b in ok_burst if b["times"]]
    failover_breakers, burst_breakers = breakers(res["failover_router"]), breakers(res["burst_router"])

    def statuses(rs) -> dict:
        out: dict = {}
        for r in rs:
            out[str(r["status"])] = out.get(str(r["status"]), 0) + 1
        return out

    emit({"phase": "chaos", "failover": {"statuses": statuses(routed), "texts_equal_direct": texts_equal,
                                         "max_attempts": max(attempts.values(), default=0),
                                         "traced_requests": len(attempts), "retry_budget": CHAOS_RETRY_BUDGET,
                                         "breakers": failover_breakers, "seconds": round(res["failover_s"], 4),
                                         "launches": res["failover_launches"]},
          "overload": {"statuses": statuses(burst), "ttft_p50_s": round(statistics.median(ttfts), 4) if ttfts else None,
                       "engine_sheds": res["sheds"], "breakers": burst_breakers,
                       "seats": CHAOS_SEATS, "seconds": round(res["burst_s"], 4)},
          "launches": phase_launches, "plain_calls": plain_calls,
          "seconds": round(time.perf_counter() - t_phase, 2), "card": card})
    # the checks: failover
    check(all(d["status"] == 200 for d in direct), f"chaos: the engine's direct answers {statuses(direct)}")
    check(statuses(routed) == {"200": CHAOS_REQUESTS}, f"chaos: the routed failover requests {statuses(routed)}")
    check(texts_equal == CHAOS_REQUESTS, f"chaos: {texts_equal} of {CHAOS_REQUESTS} routed texts are the direct ones")
    check(len(attempts) >= CHAOS_REQUESTS and max(attempts.values()) <= CHAOS_RETRY_BUDGET,
          f"chaos: proxy attempts per request {attempts} (budget {CHAOS_RETRY_BUDGET})")
    check(failover_breakers == {"fail": OPEN, "hang": OPEN, "engine": CLOSED},
          f"chaos: the breakers after failover {failover_breakers}")
    fl = res["failover_launches"]
    check(fl["decode_attention"] > 0 and fl["prefill_attention"] > 0,
          f"chaos: the failover requests' launches {fl}")
    # the checks: overload
    bad = [(b["status"], b.get("json")) for b in burst if b["status"] not in (200, 429)]
    check(not bad, f"chaos: the burst's other statuses {bad}")
    check(all(b["retry_after"] is not None and float(b["retry_after"]) > 0 for b in shed_burst),
          f"chaos: a 429 without Retry-After: {[b['retry_after'] for b in shed_burst]}")
    check(shed_burst and len(ok_burst) >= CHAOS_SEATS,
          f"chaos: the burst's statuses {statuses(burst)} (at least one 429 and {CHAOS_SEATS} 200s)")
    check(len(shed_burst) <= res["sheds"], f"chaos: {len(shed_burst)} client 429s, {res['sheds']} engine sheds")
    check(all(b["lines"] and b["lines"][-1] == "data: [DONE]" for b in ok_burst),
          "chaos: a 200 stream of the burst did not end with [DONE]")
    check(burst_breakers["engine"] == CLOSED, f"chaos: the breakers after the burst {burst_breakers}")
    check(all(n == 0 for n in plain_calls.values()), f"chaos: plain versions ran {plain_calls}")


# -- multi-host serving: two host processes on the one card --------------------

# RANK_LLAMA over two host processes on the one H100 over gloo, each an
# api_server.serve with its --distributed-process-id: dp 2 x tp 2 (two
# ranks a host, the JAX e2e's layout scaled down) and pp 2 (one stage a
# host, the reference's cross-node pp). The leader (process 0) of the bf16
# runs is this process, the follower host a subprocess; the f32 runs' hosts
# are both subprocesses, the last ended by killing its follower host.
MH_LAYOUTS = (
    ("dp2 x tp2", {"dp": 2, "tp": 2}, dict(data_parallel_size=2, tensor_parallel_size=2, tp_device_ids="0,0")),
    ("pp2", {"pp": 2}, dict(pipeline_parallel_size=2, tp_device_ids="0")),
)
MH_LOGS = ROOT / "build" / "multihost"
# the main path through the leader: MH_REQUESTS streamed greedy completions
# at once (the last under RANK_ADAPTERS' first adapter, loaded over HTTP)
MH_REQUESTS, MH_TOKENS, MH_PROMPT_BYTES = 4, 32, 600
MH_READY_S = 240.0  # a host's start, its ranks' spawn and the rendezvous
MH_KILL_EXIT_S = 20.0  # the leader's exit after its follower host is killed


def _mh_config(overrides: dict, pid: int, coord: int, sync: int, **extra) -> dict:
    """The EngineConfig fields of host ``pid`` of a two-host engine on this
    machine: the coordinator and the step stream on localhost."""
    return dict(overrides, **extra, host="127.0.0.1", tp_backend="gloo", distributed_num_processes=2,
                distributed_coordinator=f"127.0.0.1:{coord}", distributed_process_id=pid, worker_sync_port=sync)


def multihost_host_main() -> None:
    """A host process of phase_multihost:

        python3 -c 'import chip_smoke as c; c.multihost_host_main()' '<json>'

    registers RANK_LLAMA and its f32 copy, then runs the port's
    api_server.serve on the EngineConfig fields of the JSON's "cfg". A
    follower host (process id 1) returns when the leader closes the step
    stream (exit 0). A leader (id 0) with "ids_out" runs the f32 greedy
    requests of "prompts" through its engine, writes their ids and logprob
    entries and each rank's launches to that file, and serves until SIGTERM."""
    import signal

    import torch

    from production_stack_tpu_torch.engine.api_server import serve
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    _rank_llama()
    llama.PRESETS[f"{RANK_LLAMA}-f32"] = dataclasses.replace(llama.PRESETS[RANK_LLAMA], dtype=torch.float32)
    args = json.loads(sys.argv[1])

    async def run():
        server, site = await serve(EngineConfig(**args["cfg"]))
        engine = server.engine
        engine.runner.rank_stats(reset=True)
        runs = [await _engine_greedy(engine, f"mh-f32-{i}", p, max_tokens=TP_F32_TOKENS)
                for i, p in enumerate(args["prompts"])]
        rows = _rank_rows(engine.runner.rank_stats())
        kernels, plains = _counters()
        out = {"runs": runs, "launches_by_rank": [{k: int(r[k]) for k in SERVE_ROWS[False]} for r in rows],
               "plain_calls_by_rank": [{k: int(r[k]) for k in plains} for r in rows],
               "labels": [d for d, _ in engine.runner.kv_pool_shard_layout()]}
        tmp = Path(args["ids_out"] + ".tmp")
        tmp.write_text(json.dumps(out))
        tmp.replace(args["ids_out"])
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
        await stop.wait()
        await site.cleanup()
        engine.stop()

    asyncio.run(run())


def _mh_start(name: str, cfg: dict, **extra) -> tuple:
    """A host process (its own session, so that its loss takes all its
    processes) on ``cfg``; (process, log path). The follower host logs at
    INFO, where its replayed control calls show."""
    MH_LOGS.mkdir(parents=True, exist_ok=True)
    log = MH_LOGS / f"{name}.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT), PSTPU_LOG_LEVEL="INFO" if cfg["distributed_process_id"] else
               os.environ.get("PSTPU_LOG_LEVEL", "WARNING"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as c; c.multihost_host_main()", json.dumps(dict(cfg=cfg, **extra))],
            cwd=str(ROOT), env=env, stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    return proc, log


def _mh_end(proc, sig=None, timeout: float = 60.0) -> "int | None":
    """Send ``sig`` to the host's session (None: none), wait up to
    ``timeout`` for its exit code (None past it), then kill whatever of the
    session is left."""
    import signal

    try:
        if sig is not None and proc.poll() is None:
            os.killpg(proc.pid, sig)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=10)


def _mh_tail(log: Path) -> str:
    return log.read_text()[-3000:] if log.exists() else ""


async def _mh_requests(port: int, adapter: str) -> dict:
    """The main path through the leader: MH_REQUESTS greedy completions of
    MH_TOKENS tokens streamed at once, the last under ``adapter``; each one's
    TTFT and mean inter-token gap as the client saw them."""
    import random

    import aiohttp

    rng = random.Random(29)
    base = f"http://127.0.0.1:{port}"

    async def one(s, i):
        body = {"prompt": _prompt(rng, MH_PROMPT_BYTES + 11 * i), "max_tokens": MH_TOKENS, "temperature": 0.0,
                "ignore_eos": True, "stream": True}
        if i == MH_REQUESTS - 1:
            body["model"] = adapter
        t0 = time.perf_counter()
        first = last = None
        usage = None
        async with s.post(base + "/v1/completions", json=body) as r:
            check(r.status == 200, f"multihost: request {i} -> {r.status}")
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                chunk = json.loads(line[6:])
                usage = chunk.get("usage") or usage
                if any(c.get("text") is not None for c in chunk["choices"]):
                    last = time.perf_counter()
                    first = first or last
        n = usage["completion_tokens"] if usage else 0
        check(n == MH_TOKENS, f"multihost: request {i} gave {n} tokens")
        return first - t0, (last - first) / (n - 1)

    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=300)) as s:
        async with s.post(base + "/v1/load_lora_adapter",
                          json={"lora_name": adapter, "lora_path": dict(RANK_ADAPTERS)[adapter]}) as r:
            check(r.status == 200, f"multihost: adapter load -> {r.status}")
        t0 = time.perf_counter()
        timed = await asyncio.gather(*(one(s, i) for i in range(MH_REQUESTS)))
        wall = time.perf_counter() - t0
    ttft, itl = sorted(t for t, _ in timed), sorted(g for _, g in timed)
    return {"requests": MH_REQUESTS, "tokens_each": MH_TOKENS, "wall_seconds": round(wall, 4),
            "ttft_s": [round(t, 4) for t, _ in timed], "ttft_p50_s": round(ttft[len(ttft) // 2], 4),
            "itl_s": [round(g, 5) for _, g in timed], "itl_p50_s": round(itl[len(itl) // 2], 5)}


def _mh_serve(label: str, mesh: dict, overrides: dict, ref: list, book) -> None:
    """RANK_LLAMA bf16 with RANK_ADAPTERS over two hosts at ``overrides``:
    this process the leader (api_server.serve with process id 0), the
    follower host a subprocess. Before the main path (on the engine's loop
    thread): the logits of _tp_inputs against one rank's (``ref``) with the
    adapters loaded ("multihost_forward" and "lora_ranks" lines), every
    rank's LoRA slots changed by the load (the follower host's too:
    runner.lora_digest) and each host's weights the leader's where they are
    replicas (runner.params_digest). The main path (_mh_requests) with every
    count at 0 before it: both kernels launched on every rank of both hosts
    and no plain version, each rank's collectives' share of its step
    seconds, the step stream's frames and bytes. The leader's stop closes
    the stream and the follower host exits 0, its log showing the replayed
    slot writes. ``book(overrides, counts)`` books the launches."""
    import signal

    import torch

    from production_stack_tpu_torch.engine.api_server import serve
    from production_stack_tpu_torch.engine.config import EngineConfig

    t_start = time.perf_counter()
    coord, sync, port = _free_port(), _free_port(), _free_port()
    fields = dict(model=RANK_LLAMA, num_pages=FORWARD_PAGES, **RANK_LORA, **overrides)
    follower, log = _mh_start(f"bf16-{_mh_tag(mesh)}-host1", _mh_config(fields, 1, coord, sync))
    cfg = EngineConfig(port=port, **_mh_config(fields, 0, coord, sync))
    kernels, plains = _counters()
    want = SERVE_ROWS[False]
    logits = _logits_check(ref, "multihost_forward", mesh, adapters=RANK_ADAPTERS)
    res = {}

    def prepare(engine):
        runner = engine.runner
        res["forward"] = logits(engine)
        res["lora_digests"] = [bytes(d).hex() for d in runner.lora_digest()]
        res["lora_digests_loaded"] = [bytes(d).hex() for d in _with_adapters(engine, RANK_ADAPTERS[:1],
                                                                               runner.lora_digest)]
        res["params_digests"] = [bytes(d).hex() for d in runner.params_digest()]

    async def run():
        server, site = await serve(cfg)
        engine = server.engine
        res["startup_seconds"] = round(time.perf_counter() - t_start, 2)
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, engine._run_on_device_thread, lambda: prepare(engine), "prepare")
            runner, bc = engine.runner, engine._tp.bc
            runner.rank_stats(reset=True)
            bc.reset_stats()
            steps0 = runner.steps
            res["main_path"] = await _mh_requests(port, RANK_ADAPTERS[0][0])
            res["rows"] = _rank_rows(runner.rank_stats())
            res["stream"] = {"runner_steps": runner.steps - steps0, "followers": engine.mesh_devices - 1,
                             "method_frames": dict(bc.method_frames), "method_bytes": dict(bc.method_bytes)}
            res["labels"] = [d for d, _ in runner.kv_pool_shard_layout()]
        finally:
            await site.cleanup()
            engine.stop()

    try:
        asyncio.run(run())
        res["follower_exit"] = _mh_end(follower, timeout=60)
    finally:
        _mh_end(follower, signal.SIGKILL, timeout=10)
    gc.collect()
    torch.cuda.empty_cache()
    rows = res["rows"]
    ranks = len(rows)
    launches = [{k: int(r[k]) for k in kernels} for r in rows]
    plain = [{k: int(r[k]) for k in plains} for r in rows]
    stream = res["stream"]
    flog = log.read_text()
    # the replicas of one tp place: ranks t, t + tp, ... (at pp the stages
    # hold different layers: their logits above hold them to one rank)
    tp = overrides.get("tensor_parallel_size", 1)
    replicas = [{res["params_digests"][r] for r in range(t, ranks, tp)} for t in range(tp)] \
        if overrides.get("data_parallel_size", 1) > 1 else []
    line = {
        "phase": "multihost", "model": RANK_LLAMA, "kv_cache_dtype": "auto", **mesh, "hosts": 2,
        "ranks_a_host": ranks // 2, "backend": "gloo (host-staged CUDA tensors), both hosts on the one card",
        "labels": res["labels"], "forward": res["forward"], **res["main_path"],
        "launches_by_rank": launches, "plain_calls_by_rank": plain,
        "collective_share_of_step_by_rank": [round(r["collective_seconds"] / max(r["step_seconds"], 1e-9), 4)
                                             for r in rows],
        "step_seconds_by_rank": [round(r["step_seconds"], 4) for r in rows],
        "stream_frames": sum(stream["method_frames"].values()), "stream_bytes": sum(stream["method_bytes"].values()),
        "runner_steps": stream["runner_steps"],
        "stream_frames_by_method": stream["method_frames"], "stream_bytes_by_method": stream["method_bytes"],
        # the step calls' frames alone (the adapter's slot write is one large frame)
        "stream_bytes_a_step_frame_a_follower": sum(n for m, n in stream["method_bytes"].items() if m.startswith("step"))
        / max(sum(n for m, n in stream["method_frames"].items() if m.startswith("step")) * stream["followers"], 1),
        "lora_slot_written_by_rank": [a != b for a, b in zip(res["lora_digests_loaded"], res["lora_digests"])],
        "weights_replicas_equal": all(len(x) == 1 for x in replicas),
        "follower_replayed_set_lora_slot": "follower replayed set_lora_slot" in flog,
        "follower_host_exit": res["follower_exit"], "startup_seconds": res["startup_seconds"],
        "seconds": round(time.perf_counter() - t_start, 2), "card": nvidia_smi_line(),
    }
    emit(line)
    what = f"multihost[{label}]"
    check(line["labels"][ranks // 2].startswith("host1/"), f"{what}: no rank on the follower host: {line['labels']}")
    for r, counts in enumerate(launches):
        for k in want:
            check(counts[k] > 0, f"{what}: kernel {k} was not launched on rank {r} ({line['labels'][r]})")
        check(not any(plain[r].values()), f"{what}: rank {r} ran a plain version: {plain[r]}")
    check(all(line["lora_slot_written_by_rank"]), f"{what}: a rank's LoRA slots did not change: {line}")
    check(line["weights_replicas_equal"], f"{what}: a host's weights differ from their replica's")
    check(line["follower_replayed_set_lora_slot"], f"{what}: the follower host's log shows no slot write")
    check(res["follower_exit"] == 0, f"{what}: the follower host exited {res['follower_exit']}:\n{_mh_tail(log)}")
    check(line["stream_frames"] > 0 and stream["runner_steps"] > 0, f"{what}: nothing crossed the step stream")
    book(overrides, {k: sum(c[k] for c in launches) for k in want})


def _mh_tag(mesh: dict) -> str:
    return "".join(f"{k}{v}" for k, v in mesh.items())


def _mh_f32_start(mesh: dict, overrides: dict, prompts: list) -> dict:
    """Start the f32 copy of RANK_LLAMA over two host subprocesses at
    ``overrides``; the leader runs the greedy requests of ``prompts`` as
    soon as its engine is up and writes their ids (multihost_host_main).
    Returns what _mh_f32_end reads."""
    coord, sync, port = _free_port(), _free_port(), _free_port()
    fields = dict(model=f"{RANK_LLAMA}-f32", num_pages=128, decode_steps=8, **overrides)
    tag = _mh_tag(mesh)
    ids_out = MH_LOGS / f"f32-{tag}.json"
    ids_out.parent.mkdir(parents=True, exist_ok=True)
    ids_out.unlink(missing_ok=True)
    t_start = time.perf_counter()
    follower, flog = _mh_start(f"f32-{tag}-host1", _mh_config(fields, 1, coord, sync))
    leader, llog = _mh_start(f"f32-{tag}-host0", dict(_mh_config(fields, 0, coord, sync), port=port),
                             ids_out=str(ids_out), prompts=prompts)
    return dict(t_start=t_start, ids_out=ids_out, follower=follower, flog=flog, leader=leader, llog=llog)


def _mh_f32_end(label: str, mesh: dict, run: dict, ref: list, kill: bool) -> None:
    """A two-host f32 engine of _mh_f32_start: the leader's greedy tokens
    against one rank's (``ref``; a token may flip only at a near-tie,
    TP_NEAR_TIE), each rank's launches. Then with ``kill`` the follower
    host (every process of it) is killed and the leader must exit 13 within
    MH_KILL_EXIT_S; without, the leader's SIGTERM ends both hosts with exit
    0. Both hosts are gone when it returns."""
    import signal

    t_start, ids_out = run["t_start"], run["ids_out"]
    leader, llog, follower, flog = run["leader"], run["llog"], run["follower"], run["flog"]
    line = {"phase": "multihost_f32_tokens", "model": f"{RANK_LLAMA}-f32", **mesh, "hosts": 2}
    try:
        deadline = t_start + MH_READY_S
        while not ids_out.exists():
            states = (leader.poll(), follower.poll())
            check(states == (None, None) and time.perf_counter() < deadline,
                  f"multihost_f32[{label}]: a host ended or stalled ({states}):\n{_mh_tail(llog)}\n---\n"
                  f"{_mh_tail(flog)}")
            time.sleep(0.2)
        got = json.loads(ids_out.read_text())
        line["ready_seconds"] = round(time.perf_counter() - t_start, 2)
        if kill:
            os.killpg(follower.pid, signal.SIGKILL)
            t0 = time.perf_counter()
            line["leader_exit_after_follower_host_killed"] = _mh_end(leader, timeout=MH_KILL_EXIT_S)
            line["leader_exit_seconds"] = round(time.perf_counter() - t0, 3)
        else:
            line["leader_exit"] = _mh_end(leader, signal.SIGTERM)
            line["follower_host_exit"] = _mh_end(follower)
    finally:
        _mh_end(leader, signal.SIGKILL, timeout=10)
        _mh_end(follower, signal.SIGKILL, timeout=10)
    runs = [(ids, lps) for ids, lps in got["runs"]]
    same, flips, diffs = _token_flips(ref, runs)
    line.update(labels=got["labels"], tokens_per_prompt=TP_F32_TOKENS, prompts=len(runs),
                tokens_equal_before_a_flip=same, tokens=sum(len(ids) for ids, _ in ref), flips=flips,
                near_tie=TP_NEAR_TIE, logprob_max_diff_before_a_flip=max(diffs, default=0.0),
                launches_by_rank=got["launches_by_rank"], seconds=round(time.perf_counter() - t_start, 2),
                card=nvidia_smi_line())
    emit(line)
    what = f"multihost_f32[{label}]"
    check(all(len(ids) == TP_F32_TOKENS for ids, _ in runs), f"{what}: short output")
    for f in flips:
        check(f["reference_top2_margin"] <= TP_NEAR_TIE, f"{what}: a token flipped away from a near-tie: {f}")
    for r, counts in enumerate(got["launches_by_rank"]):
        check(all(n > 0 for n in counts.values()), f"{what}: rank {r} launched {counts}")
        check(not any(got["plain_calls_by_rank"][r].values()), f"{what}: rank {r} ran a plain version")
    if kill:
        check(line["leader_exit_after_follower_host_killed"] == 13,
              f"{what}: the leader exited {line['leader_exit_after_follower_host_killed']} after its follower host "
              f"was killed:\n{_mh_tail(llog)}")
    else:
        check(line["leader_exit"] == 0 and line["follower_host_exit"] == 0,
              f"{what}: exits {line['leader_exit']}, {line['follower_host_exit']}")


def phase_multihost(book, ref: list) -> None:
    """Multi-host serving on the one card: two host processes (each the
    port's api_server.serve with its --distributed-process-id) over gloo,
    RANK_LLAMA at dp 2 x tp 2 and at pp 2. The bf16 runs (_mh_serve: the
    logits against one rank's, ``ref`` being the tp phase's, the LoRA slots
    on both hosts, every rank's launches on the main path, TTFT and ITL
    through the leader, the collectives' share, the stream's bytes), then
    the f32 copy's greedy tokens of both layouts at once (their host
    processes start together and while this process computes one rank's
    tokens) against one rank's, the pp 2 pair ended by killing its
    follower host, whose loss must end the leader with exit 13."""
    import random
    import signal

    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.models import llama

    for label, mesh, overrides in MH_LAYOUTS:
        _mh_serve(label, mesh, overrides, ref, book)
    name = f"{RANK_LLAMA}-f32"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS[RANK_LLAMA], dtype=torch.float32)
    rng = random.Random(13)
    prompts = [_prompt(rng, 300 + 400 * i) for i in range(2)]
    runs = []
    try:
        for _, mesh, overrides in MH_LAYOUTS:
            runs.append(_mh_f32_start(mesh, overrides, prompts))
        engine = LLMEngine(EngineConfig(model=name, num_pages=128, decode_steps=8))
        engine.start()
        try:
            async def go():
                return [await _engine_greedy(engine, f"mh-ref-{i}", p, max_tokens=TP_F32_TOKENS)
                        for i, p in enumerate(prompts)]

            ref_ids = asyncio.run(go())
        finally:
            engine.stop()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        for i, ((label, mesh, _), run) in enumerate(zip(MH_LAYOUTS, runs)):
            _mh_f32_end(label, mesh, run, ref_ids, kill=i == len(MH_LAYOUTS) - 1)
    finally:
        for run in runs:
            _mh_end(run["leader"], signal.SIGKILL, timeout=10)
            _mh_end(run["follower"], signal.SIGKILL, timeout=10)


def book_launches(launches: dict, overrides: dict, counts: dict, D: int, kh: "int | None" = None) -> None:
    """Add a served run's launches (``counts``, summed over its ranks) to
    the kernel table's rows of their shapes at the run's rank layout
    (``overrides``: its EngineConfig fields), head dim ``D`` and, for a tp
    that shares them, the model's ``kh`` KV heads."""
    quant = overrides.get("kv_cache_dtype") == "int8"
    tp, dp = overrides.get("tensor_parallel_size", 1), overrides.get("data_parallel_size", 1)
    ep, pp = overrides.get("expert_parallel_size", 1), overrides.get("pipeline_parallel_size", 1)
    sp = overrides.get("sequence_parallel_size", 1)
    for k in SERVE_ROWS[quant] + ((VERIFY_ROW,) if VERIFY_ROW in counts else ()):
        # an ep rank runs its tp place's heads: the [ep2tp2] rows at ep 2
        # x tp 2, one rank's rows at ep 2 alone
        row = _eptag(_dtag(k, D), ep, tp) if ep > 1 and tp > 1 else _tptag(_dtag(k, D), tp)
        if kh and tp > kh and k != "kv_page_write":
            row = _tptag(_dtag(k, D), tp, kh)  # a rank's shared KV head: the [tp4kh2] rows
        if dp > 1 and tp == 1 and k == "decode_attention":
            row = _dptag(row, dp)  # the dp rank's rows, all heads: the [dp2] row
        if pp > 1 and D == 64 and k != "kv_page_write":
            row = _pptag(k, pp, tp)  # a stage's microbatches on its pool: the [pp2] and [pp2tp2] rows
        if pp > 1 and ep > 1 and k != "kv_page_write":
            row = _pptag(_dtag(k, D), pp, tp, ep)  # a MoE stage's ep rank: the [pp2ep2] rows
        if pp > 1 and k == VERIFY_ROW:
            row = VERIFY_PP_ROW  # a stage's verify microbatches on its pool
        if sp > 1:
            if k != "decode_attention":
                continue  # a chunk (and a verify forward) at sp goes through the ring
            # every sequence rank's whole step: the [sp2], [sp2tp2] and
            # [sp2ep2] rows, beside dp or pp ranks [dp2sp2] and [pp2sp2]
            row = _sptag(_dtag(k, D), sp, tp, ep, dp, pp)
        launches[row] = launches.get(row, 0) + counts[k]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    if not (ROOT / "production_stack_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no production_stack_tpu_torch package")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from production_stack_tpu_torch.models import gemma2

    gemma2.PRESETS[GEMMA_MODEL] = dataclasses.replace(gemma2.PRESETS["gemma-2-2b"], num_layers=GEMMA_LAYERS)
    t_start = time.perf_counter()
    t_last = [t_start]

    def clock(name: str) -> None:
        """The seconds since the last clock line: the phase that ends here."""
        now = time.perf_counter()
        emit({"phase": "phase_seconds", "name": name, "seconds": round(now - t_last[0], 2),
              "total_seconds": round(now - t_start, 2)})
        t_last[0] = now

    phase_build()
    clock("build")
    worst = phase_kernels()
    clock("kernels")
    launches = {}
    for name, n_chunks in FORWARD_RUNS:
        counts = phase_forward(name, n_chunks)
        if name.startswith("gemma"):  # gemma-2-2b's int8 rows: the launches of its int8 kernel forward
            launches.update({_dtag(k, 256): counts[k] for k in SERVE_ROWS[True]})
    phase_lora_forward()
    clock("forward")

    def serve(label, overrides, D, sleep_level, lora, prepare=None, extra=None, kh=None, sp_prompt=SP_PROMPT):
        counts = phase_serve(label, overrides, sleep_level, lora, prepare, extra, sp_prompt)
        book_launches(launches, overrides, counts, D, kh)

    try:
        phase_hf_qwen()
        gc.collect()
        torch.cuda.empty_cache()  # the blocks qwen2.5-7b's load and forward left cached
        phase_hf_write(OPT_DIR, OPT_HF_CONFIG, _opt_hf_specs(OPT_HF_CONFIG, torch.float16))
        from production_stack_tpu_torch.models import llama

        write_lora_adapters(llama.PRESETS["llama-3.2-1b"], LLAMA_ADAPTERS, LORA_RANKS, LORA_TARGETS)
        _rank_llama()
        write_lora_adapters(llama.PRESETS[RANK_LLAMA], RANK_ADAPTERS, LORA_RANKS, LORA_TARGETS)
        for run in SERVE_RUNS:
            serve(*run)
        clock("hf and serve runs")
        # chained and speculative decode: the runner on an f32 copy, then
        # llama-3.2-1b served chained (bf16, then int8 with the CPU tier)
        # and speculative
        phase_spec_chain()
        chained = {}

        async def chained_requests(server, port):
            chained.update(await _chained_requests(server, port))
            return chained

        serve("llama-3.2-1b, pipeline4", dict(model="llama-3.2-1b", decode_pipeline=4), 64, 0, (),
              extra=chained_requests)
        phase_lone_unchained(chained["lone_ids"])
        serve("llama-3.2-1b, int8, pipeline4", dict(model="llama-3.2-1b", **INT8_SERVE, decode_pipeline=4), 64, 0,
              (), extra=_pipelined_int8_requests)
        serve("llama-3.2-1b, spec4", dict(model="llama-3.2-1b", speculative_k=SPEC_K), 64, 0, (),
              extra=_spec_requests)
        clock("spec and chained")
        # the engine inside the stack's services: cache server, controller,
        # spans under a traceparent, debug routes, a warm restart
        phase_stack(serve, launches)
        clock("stack")
        # disaggregated prefill: a producer subprocess and a consumer here,
        # the KV over TCP blobs, the fabric, CUDA IPC, and int8 over the fabric
        phase_disagg(launches)
        clock("disagg")
        # the fleet: the KV directory in the cache server, two engines behind
        # the router's kvaware routing, a stream migrated there and back, the
        # directory's routing and a third engine's boot prefetch
        phase_fleet(launches)
        clock("fleet")
        # the chaos drill: a real engine behind the router beside a failing
        # and a hung fake; failover, then an overload burst that sheds
        phase_chaos(launches)
        clock("chaos")
        # tensor parallelism: two ranks (processes) on the one card over
        # gloo, with qwen2.5-7b's directory still on the disk
        tp_ref = phase_tp_reference(adapters=RANK_ADAPTERS)
        serve(f"{RANK_LLAMA}, tp2", dict(model=RANK_LLAMA, **TP2, **RANK_LORA), 64, 0, (RANK_ADAPTERS, False),
              _logits_check(tp_ref, "tp_forward", {"tp": 2}, adapters=RANK_ADAPTERS))
        serve(f"{RANK_LLAMA}, int8, tp2", TP_SERVE_LLAMA_INT8, 64, 0, ())
        phase_f32_tokens("tp_f32_tokens", TP2, n_prompts=2, together=False)
        serve("qwen2.5-7b-hf, tp2", dict(model=str(QWEN_DIR), **TP2), 128, 0, (), _tp_qwen_slices())
        clock("tp")
        # KV heads shared by tp ranks: Qwen2.5-1.5B's directory at tp 4,
        # two ranks on each of its two KV heads
        phase_shared_heads(serve)
        clock("shared_heads")
        # in-engine data parallelism: dp 2, then dp 2 x tp 2, every rank a
        # process on the one card over gloo
        phase_dp_forward(phase_tp_reference(rows=DP_FORWARD_ROWS, adapters=RANK_ADAPTERS))
        phase_f32_tokens("dp_f32_tokens", DP2, n_prompts=4, together=True)
        serve(f"{RANK_LLAMA}, dp2", dict(model=RANK_LLAMA, **DP2, **RANK_LORA), 64, 0, (RANK_ADAPTERS, False))
        serve(f"{RANK_LLAMA}, int8, dp2 x tp2", DP_SERVE_LLAMA_INT8, 64, 0, ())
        clock("dp")
        # pipeline parallelism: pp 2 and pp 2 x tp 2, every rank a process
        # on the one card over gloo, with qwen2.5-7b's directory still there
        phase_pp_ranks(serve, tp_ref)
        clock("pp_ranks")
        # sequence parallelism: sp 2 and sp 2 x tp 2 on an 8,191-token
        # prompt, every rank a process on the one card over gloo
        sp_ref = phase_sp_ranks(serve)
        clock("sp_ranks")
        # sequence ranks beside dp and pp ranks, and speculative decoding
        # at sp and pp: four servers behind the router
        phase_sp_compose(serve, sp_ref)
        clock("sp_compose")
        # multi-host serving: two host processes, each an api_server.serve
        # with its process id, at dp 2 x tp 2 and pp 2 on the one card
        phase_multihost(lambda overrides, counts: book_launches(launches, overrides, counts, 64), tp_ref)
        clock("multihost")
        phase_opt_int8_refused()
        shutil.rmtree(QWEN_DIR)  # room on the disk for mixtral-8x7b's 23 GB
        phase_hf_mixtral()
        gc.collect()
        torch.cuda.empty_cache()
        mixtral = dataclasses.replace(llama.PRESETS["mixtral-8x7b"], num_layers=MIXTRAL_LAYERS)
        write_lora_adapters(mixtral, MIXTRAL_ADAPTERS, LORA_RANKS[:1], LORA_TARGETS[:4])
        ep_ref = {}  # the one-rank server's routed logits, the ep ranks' reference
        serve(*MIXTRAL_SERVE, prepare=_moe_reference(ep_ref, adapters=MIXTRAL_ADAPTERS, seq=True))
        clock("mixtral")
        # Mixtral across ranks: ep 2 and ep 2 x tp 2 from the directory,
        # then dp 2 of a seeded cut-depth copy
        phase_ep_ranks(serve, ep_ref)
        clock("ep_ranks")
        # what the LoRA additions to the rank phases took, inside the
        # phases' own lines above
        emit({"phase": "phase_seconds", "name": "lora_ranks (within tp, dp, pp_ranks, sp_ranks, ep_ranks)",
              "seconds": round(sum(LORA_SECONDS.values()), 2), "parts": {k: round(v, 2) for k, v in
                                                                         LORA_SECONDS.items()}})
    finally:
        shutil.rmtree(HF_ROOT, ignore_errors=True)  # up to 23 GB of shards
    timing = phase_timing()
    clock("timing")

    table = []
    for name in REPLACES:
        t = timing[name]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 2)})
    emit({"kernels": table})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PSTPU_LOG_LEVEL", "WARNING")
    sys.exit(main())
