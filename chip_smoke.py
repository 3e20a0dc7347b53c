#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-ab   # direct vs HTTP serve in turns only
    python3 chip_smoke.py --quant-ab   # phase c's traffic, W8A8 vs bf16 in turns only
    python3 chip_smoke.py --sdk-graph  # phase p alone
    python3 chip_smoke.py --parallel   # phase q alone
    python3 chip_smoke.py --tp-tiers   # phase r alone
    python3 chip_smoke.py --tune       # phase s alone
    python3 chip_smoke.py --upload-causes  # phase g's upload under each candidate cause
    python3 chip_smoke.py --chaos      # phase t alone
    python3 chip_smoke.py --batch-invariance  # why phase t's engines are batch-invariant
    python3 chip_smoke.py --checkpoint # phase m's checkpoint and tokenizer steps alone

Phases, any failure exits non-zero; every phase but s runs with
DYN_DECODE_TUNE_TABLE at a path that does not exist (printed first), so
the kernels launch their built-in shapes:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from dynamo_tpu_torch/csrc with nvcc;
  3. check that the bf16 kernel bodies run on the tensor cores and the
     f32 bodies do not (HMMA instructions in cuobjdump's SASS); check each
     kernel against its plain PyTorch version at llama-3.1-8b attention
     geometry (H 32, KV 8, D 128, page size 16), at 64 rows and at the
     serve phase's own row count and table width: ragged lengths,
     zero-length and padding rows, decode contexts on and one past a
     partition boundary and across the whole 4096-token table, prefill
     chunks that are not multiples of a tile over prefixes ending mid-page,
     a mixed step's 1-token rows beside a 512-token chunk, bf16 q over
     bf16 / int8 / fp8 / f32 pages and f32 q over f32 pages, KV splits;
     rtol = atol = 1e-2 for bf16 outputs, 1e-4 for f32;
  4. time each kernel at the shapes the serving path gives it, beside its
     plain version, its bytes/flops bound, and one PyTorch library call of
     the same function (scaled_dot_product_attention over pre-gathered
     contiguous K/V at KV heads — a yardstick the port never calls); the
     kernel's output there is held against the plain version's and the
     library's; and the prefill kernel once more at a mixed step's shape
     (the 512-token chunk plus 7 one-token rows), beside a decode launch of
     those 7 rows;
  5. the paged model path in f32 (4 layers at full width, f32 pages)
     against a dense reference forward: chunked prefill over a prior
     prefix, then decode steps, at rtol = atol = 1e-4;
  6. build TorchEngine on llama-3.1-8b at full width and depth (random
     seeded bf16 weights, page size 16, decode_steps 8, prefill_chunk 512,
     pipeline_depth 2), capture every device program ahead of time
     (``run_warmup``: one CUDA graph per token bucket, two for the fused
     decode), then serve 8 concurrent greedy requests through the
     continuous pipeline, with both kernels' launch counters (advanced per
     graph replay) zeroed just before and read just after; check every
     stream, that the serve captured no graph, and the bf16 model's logits
     against the dense reference; then hold a captured prefill bucket and
     the captured fused decode (seeded and chained) against the eager
     calls on the same inputs, writes dropped: equal tokens, logprobs
     within 1e-3; then a churn serve on the same engine: 16 requests at
     max_batch 16, the back half arriving inside a live fused session, with
     staggered max_tokens, which must be admitted and retired in the loop
     with no rebuild and no new graph;
  7. serve the same model over HTTP through the CLI's own code
     (``run in=http out=torch``, a fresh engine warmed before the timed
     requests, the server's event loop in a thread of this process) to a
     standard-library client: /v1/models and /health, the same 8 prompts as
     streamed /v1/completions, one chat request unary and streamed (equal
     texts), an unknown model (404) and /metrics (the engine-dispatch
     group too), with both kernels' counters zeroed before and read after;
  a. W8A8 ops: ``qdot`` at each llama-3.1-8b projection shape (wqkv, wo,
     w_gateup, w_down, lm_head) and M = 16, 256, 2048: int32 accumulation
     equal to an exact integer reference, every output entry within 8
     standard deviations of the activations' rounding from
     x @ dequant(w), the largest error within 1.5 % of its largest entry;
     timed against bf16 ``torch.matmul`` and ``_int_mm``
     alone in both weight layouts, beside the bounds; then both kernels
     over int8 pages at the shapes of phases c and d, each held against
     its plain version and timed beside its plain version, its bound and
     SDPA over pre-gathered, dequantized K/V;
  b. the W8A8 model: llama-3.1-8b at 4 and 32 layers (int8 weights drawn
     by the engine, int8 KV scales calibrated at start — printed with the
     time calibration took) against its own tree dequantized to bf16: mean
     KL < 0.05 and decisive top-1 agreement at both depths; int8 pages vs
     bf16 pages on the W8A8 model: cosine > 0.99 at 4 layers, and at 32
     1 - cosine within 8x the bf16 tree's under the same scales; then, at
     both depths, fp8 and int8 pages (``tools/quant_quality.kv_rows``,
     scales calibrated as ``kv_scale="auto"``) against bf16 pages on the
     bf16 tree: KL, top-1 and cosine, the fp8 row's bars in
     ``w8a8_model_check``;
  c. the port's bench headline (``dynamo_tpu_torch.bench``) at its
     default geometry, one W8A8 + int8-KV ``auto`` engine (max_batch
     256, max_model_len 256, 4160 pages, prefill_chunk 512, decode_steps 8,
     pipeline_depth 8): 256 greedy requests, ISL 128, OSL 64, after its
     warmup and 4-token warm pass, with no graph captured during the
     serve; its one line must carry the JAX contract's key set and name
     the CUDA kernels (MFU against the H100's dense peaks); then a
     256-row unified step and the sampler with and without its grammar
     mask stage, which every unified step runs (all-ones words here);
  d. benchmarks/loadgen.py's self-hosted geometry through the port's
     HttpService → preprocessor → backend (W8A8 + int8 KV ``auto``,
     max_batch 24, max_model_len 4096, 6208 pages, prefill_chunk 2048,
     decode_steps 16, pipeline_depth 4): 24 concurrent streamed
     /v1/completions of 3000-token-id prompts, OSL 150, and /metrics;
  e. speculation through the port's bench in its spec mode: a fresh W8A8
     engine at phase c's geometry per mode, off then on at k 8, 32
     requests of repetitive prompts (greedy) and of random prompts
     (temperature 0.7, seed i·7+1); the streams must be identical; then
     the same traffic on the spec-on engine with drafts forced from an
     oracle of the spec-off streams (one token wrong in every other
     8-token window): identical streams again, with verification
     dispatches and both accepted and rejected drafts;
  f. the serving edge's overload and observability plane, on phase 6's
     warm engine through three HttpService instances on free ports
     (preprocessor → backend → engine): admission (max_inflight 4, queue 2,
     wait 30 s) under a burst of 12 streamed /v1/completions of 512 ids and
     64 new tokens — exactly 6 whole streams, 6 429s with Retry-After,
     counted on /metrics; a stream with ``x-deadline-s: 0.5`` and
     max_tokens 2048 ends in the SSE 504 error event and its row leaves the
     engine within one fused dispatch, no KV block held; QoS at rate 1,
     burst 2: one tenant's three requests get 200, 200, 429 (quota) and
     the brownout ladder ticks off the engine's live KV usage; 4 requests
     with ``x-trace: 1`` (2048 ids, logprobs so the first token's chunk
     reaches the client) each assemble at /traces/{id} with the edge,
     preprocess, queue-wait, prefill (first_token) and decode-chunk spans
     in order, the TTFT decomposition's terms within 10 % of the client's
     TTFT; then 8 greedy requests a pass, one at a time, traced none /
     all / all / none after a concurrent pass that fills the prefix cache:
     identical token streams and no graph captured,
     with each pass's TTFT and ITL medians (the tracing overhead, not
     gated) and both kernels' launches in the phase;
  g. the restore's CRC kernel (csrc/crc32_blocks.cu) against zlib on
     every geometry it takes, bitwise, and timed at a 128-block prefix
     beside the earlier design's time and its bound (the bytes, the INT32
     operations of slicing by 4 at 64 lanes a clock, and the shared-memory
     wavefronts at the sampled SM clock); then
     the KV memory tiers on engines sharing phase 6's weights (512 pages,
     1 GiB; host tier 1024 MiB pinned, disk 1024 MiB and object store
     2048 MiB in a temporary directory removed at the end): 12 greedy
     prompts of 2056 ids, 16 new tokens each, one at a time, the offload
     queue drained after each, so 1536 blocks demote host → disk → object
     store; then, each prompt's chain evicted from the device first, a
     re-serve whose first block is on disk under a ``kv_corrupt`` fault
     (quarantined: one disk corruption, nothing restored, the stream
     recomputed), and re-serves whose first block sits in host, on disk
     and in the object store (128 blocks restored ahead of admission);
     then a fresh engine on the same object store serves an
     object-store-resident prompt (scale from zero).  Every stream equals
     its first pass; a chosen block's restored pages equal the bytes read
     after its first prefill, bitwise; the restored counts equal the
     engine's counter and the /metrics text; the host restore's TTFT is
     below the first pass's (each restore's upload printed in its parts:
     lock wait, allocation, enqueue, and the unpinned sources, beside the
     interpreter's collections in the window); no graph is captured and no
     ``torch.cuda.synchronize`` runs while serving.  Then phase 6's 8
     concurrent requests on a host-tier engine and on one without tiers,
     in turns (the pump's cost on TTFT and ITL, not gated);
  h. the README's distributed stack (``cli hub``; ``run in=dyn://…
     out=torch`` workers; ``http --router kv``) serving llama-3.1-8b at
     phase 6's geometry but 16 of its 32 layers (PATH_CUT_LAYERS, as in
     phases i, j, k and l: the script's time): the hub, a KV-routed and a round-robin frontend
     and worker B are subprocesses of the CLI; worker A runs the CLI's own
     ``run in=dyn://`` code in this process (its launches counted), warmed
     before traffic; both draw the weights from seed 0.  8 greedy prompts
     of 1024 ids, 64 new tokens, one at a time through the kv frontend,
     each identical to the colocated engine's stream served alone (its
     text, and the output ids through the sealed blocks' chained hashes
     on the kv_events subject); then each 1024-id prefix plus 32 new ids,
     which the router's ``KVHitRateEvent`` must send to the worker of its
     first pass with at least 64 blocks of overlap, that worker's prefix
     hits rising; repeat TTFT through kv against round_robin on fresh
     prefixes in 3 turns (reported); 16 concurrent streams of 512–2048
     ids, all whole, each worker taking at least 4; then 4 greedy streams
     whose prefixes live on B, B SIGKILLed once each has 8 tokens: all 4
     finish whole on A, the frontend's resume counter rises by 4, B leaves
     discovery within the lease TTL plus 1 s and the router's index holds
     none of its blocks; on A no graph is captured and no
     ``torch.cuda.synchronize`` runs while serving, and both kernels
     launch; the router's hashing of 2048 ids is timed on this host;
  i. the README's disaggregated deployment (``cli hub``; ``run
     in=dyn://… --disagg prefill``; ``run in=dyn://… --disagg decode
     --max-local-prefill 512``; ``http``) at phase 6's geometry (16 of
     the 32 layers, as phase h): the hub,
     the frontend and the prefill worker P are subprocesses of the CLI; the
     decode worker D runs the CLI's own ``--disagg decode`` code in this
     process (its launches counted), warmed before traffic.  8 greedy
     prompts of 2040 ids (127 full blocks and an 8-id tail), 64 new tokens,
     one at a time through the frontend: each prefilled on P, its blocks
     pushed chunk by chunk into D's pages, 8 remote prefills and none
     local or degraded, 8 x 127 blocks wire-verified, each stream
     identical to D's engine serving the prompt alone in the same shapes,
     and an imported block's pages bitwise equal to D's own; the live
     threshold (``publish_config`` 4096, then 512: 4 prompts local, 4
     remote); 4 remote prompts while a long stream decodes (decode
     dispatches between D's inject entries; each inject's lock hold beside
     the fused dispatch); a byte flipped on the wire in one chunk (the
     verified prefix seals and hits, D prefills the rest, the stream
     identical, one corruption on the integrity /metrics group); no graph
     captured and no ``torch.cuda.synchronize`` on D, both kernels
     launched.  Then, P stopped, a prefill engine P' in this process and
     ``transfer_blocks_device`` of 127 blocks into D: pages bitwise equal,
     no host bytes, no graph, no sync; timed beside the host-staged path
     for the same blocks (P''s export, the wire into D's ``kv_import``,
     D's inject, by part), with the remote against local TTFT and the
     chunk sizes P's adaptive sizing reached;
  l. on phase i's stack, before P stops (``planner_path``): a fresh
     ``http`` frontend F (the edge's rolling windows are counted, not
     timed), a second decode worker D2, the ``metrics`` aggregator and the
     planner (``python -m dynamo_tpu_torch.planner run --autopilot
     --interval 0.5``, local actuation, ``DYN_PLANNER__*``: max_prefill 1,
     min_decode 1, a TTFT target below phase i's remote TTFT, an ITL target
     never reached, no scale-down in the phase), all CLI subprocesses; D
     (still this process's CLI worker, warmed for both roles first) holds
     one stream seeded at 0.7 and D2 two greedy ones; a burst of 2040-id
     prompts through F breaches the TTFT target; the planner, started
     after it, must see the pools {P} and {D, D2} and the edge's
     percentiles, then write ``flip_role(D, prefill)``: D's
     ``RoleFlipWatcher`` migrates its stream to D2 (whole, spliced or
     resumed), starts the prefill loop and acks; the pools then read {P, D}
     and {D2}; 4 prompts of 2040 ids straight to D2 are all prefilled
     remotely and identical to the same shapes served alone; the planner
     is stopped, a ``LocalActuator`` here flips D back, D's decode surface
     and ``kv_import`` return under its lease and a remote prompt on D is
     identical; the aggregator serves D's and D2's rows and the router's
     series, F's /metrics the planner group; a ``PlannerDirectiveWatcher``
     over a ``KvRouterCore`` here enacts a ``set_tier_weights`` directive;
     on D no graph is captured and no ``torch.cuda.synchronize`` runs, and
     all three kernels launch (prefill launches while D is a prefill
     worker counted apart); each tick's pressures, the put-to-ack wall, the
     drain's move and TTFT p95 before and after the flip reported;
  j. the sampler's kernel (csrc/threefry_gumbel.cu): its noise entry
     (``jax.random``'s threefry Gumbel noise bit for bit) against its plain
     version at 16 and 256 rows over the 128256-id vocabulary, uint32 bits
     exactly equal, values within 2 ulp at the scale max(|g|, 1); the
     categorical draw's Gumbel code bitwise torch.log's on all 2^23
     uniforms; the categorical draw (noise, temperature and argmax fused)
     against ``categorical_plain`` at 16 and 256 rows on edge rows
     (constant, -1e30 but one id, NaN) and seeds and at each temperature,
     equal tokens; timed in turns with the unfused path it replaced (its
     plain version once), beside its bound: the larger of x read once and
     the function's own instructions an element at the issue rate and the
     SM clock nvidia-smi reports while it runs; the kernel's SASS an
     element by pipe logged beside it (cuobjdump: ALU, FMA/IMAD, MUFU,
     conversions; the loop body over its 4 elements, the rest over a
     thread's elements) with its pipe and issue times; a launch split into
     its CTAs' row key, loop and reduction and the time outside them
     (a profiled instantiation's stamps).
     Then the distributed stack again (``cli hub``, ``http --router kv``
     and worker B as subprocesses, worker A the CLI's own ``run in=dyn://``
     code in this process with ``--kv-pull-mb 192``): a greedy and a
     sampled fused dispatch's device time on A; 4 streams of 2048-id
     prompts (2 greedy, 2 seeded at temperature 0.7) through the frontend
     on A, migrated to B by A's ``migrate_out`` once each has 32 tokens:
     every stream whole, 4 splices on the frontend's /metrics, A's rows and
     blocks released, sampled migrated blocks bitwise equal on B, each
     stream equal to its resume request served on B (how many also equal
     the never-migrated stream is reported), no graph and no
     ``torch.cuda.synchronize`` on A, all three kernels launched there;
     copy rounds, blocks, freeze-to-quiescence, the stall across the
     cutover and the wall to cutover reported; then B holds a 2048-id
     prefix and A, hinted with ``kv_pull``, pulls it at 64 and 192 MiB: the
     pulled count min(peer - local, budget), pages bitwise B's, the stream
     equal to the same split computed on A, TTFT beside A's recompute and
     B's prefix hit; a dead peer's pull prefills locally; then (after
     phase k) A is stopped with 2 live streams and drains them to B
     through migration, whole.  Phase j's transfers ride the service
     plane although every process runs with ``DYN_BULK_PLANE=1``: A's two
     bulk producers are switched to the service plane for it;
  k. on phase j's stack, before its drain, A's producers on the bulk
     plane (``bulk_health_path``): A's and B's ``bulk/addr`` and the
     frontend's ``bulk/sink/traces`` in the hub; B's kv_export fetches
     under ``bulk_conn_drop`` (B started with ``DYN_FAULTS``): dropped
     after every chunk, one fallback tick and the service plane pulls the
     same pages; dropped once, resumed with no fallback; A pulls 32 and 96
     blocks of a 2048-id prefix B holds, in turns over the bulk plane and
     the service plane (3 each): the count min(peer - local, budget), pages
     bitwise B's, the stream equal to the same split on A, the bulk bytes
     on ``dynamo_tpu_bulk_bytes_total`` with no fallback, TTFT and the
     pull's wall, and during each 96-block pull the gaps of a stream
     decoding on B (the donor) and B's resident memory; 2 streams (greedy,
     seeded at 0.7) migrated A -> B over the bulk plane through the
     frontend: whole, 2 splices, blocks bitwise on B, each equal to its
     resume request on B, the copy stream's bytes on the bulk counter and
     not on the hub's publish bytes, move times and stalls beside phase
     j's; traced requests on B with B's spans at the frontend's /traces
     through the bulk sink and no fallback; a ``HealthWatchdog`` in this
     process (default prober, drainer and latency source, fed by this
     process's routed client; an echo worker is the fleet's third member,
     since the fleet median of two workers is the slower one's own p50):
     ``slow_stream`` on A with A's decode paced to its slowed wire while A
     serves 2 streams: A quarantined as a straggler, its marker written,
     the default drainer moving both streams to B over the bulk plane,
     whole; disarmed, A reinstated before the grace ends, the marker
     cleared; then A's ``__health__`` stalled past the probe timeout with a
     1 s grace: A ejected, its registration deleted, the frontend routing
     only to B (all 200), the marker ``ejected``; A re-registered and reset;
     the ``dynamo_tpu_health_*`` counters equal to the transitions; no
     graph and no sync on A, all three kernels launched;
  m. checkpoints, the checkpoint's own tokenizer and batched multi-LoRA:
     the seeded llama-3.1-8b init written at full width and depth as bf16
     safetensors shards with config.json (``save_params_hf``, 16.06 GB),
     loaded back in bf16 and under ``quant="int8"`` (each leaf bitwise
     equal to the init tree and to ``quantize_params`` of it; write and
     load seconds, peak device memory over each load); phase n's
     sentencepiece ``tokenizer.model`` of 128256 pieces
     (``llm/sp.build_model_proto``) whose texts round-trip; in the
     checkpoint, a llama-3.1-format tokenizer.json (128000 byte-level BPE
     tokens and 256 specials) and tokenizer_config.json with a chat
     template (``tools/synth_tokenizer.py``): its load seconds, round
     trips of seeded and Unicode texts, encode ms at 512, 2048 and 4096
     ids, the template's render ms; 4 completions (3 of ids, 1 of text)
     and a chat request one at a time through ``run in=http out=torch
     --checkpoint DIR`` (no ``--tokenizer``: the server's tokenizer is the
     directory's ``HFTokenizer``), the text and the chat also streamed:
     each text equal to the tokenizer's decode of the same seeded init's
     stream served directly, the deltas joined equal to the unary text,
     prompt lengths as the tokenizer gives them, the chat's as its
     rendered template with one <|begin_of_text|>; the chat TTFT against
     its ids sent as a completion; then ``run in=http out=torch
     --lora-max-adapters 4 --lora-rank 16`` with five ``--lora
     aN=random:N`` adapters and one PEFT directory, warmed, 16 concurrent
     requests of 1024 ids and 64 new over the base and all six adapters
     (all whole, idle residents evicted for the fifth and sixth, no graph
     captured after warmup), a fresh prompt under a0 then a1 (no block
     shared) then a0 (its prefix hit), base rows of a mixed 16-row prefill
     and decode bitwise equal to the LoRA-off forward of the same batch, a
     fused decode dispatch and a 512-id prefill step timed with every row
     on an adapter, every row base and on an engine without banks; and
     ``forward_ragged`` in f32 at full width and 2 layers with slots -1..3
     in one batch against a dense reference with per-row merged weights at
     1e-4;
  n. structured output: phase m's sentencepiece model (128256 pieces)
     behind ``run in=http out=torch --tokenizer`` at phase 6's geometry;
     the compile seconds of a small JSON schema (a string, an integer and
     an enum), an enum of three words and a digits-and-letters regex at
     that vocabulary; the schema alone (a compile), again (a compile-cache
     hit), the enum and the regex alone; then one burst of 8 streamed chat
     requests under the schema, 2 under the enum, 1 under the
     ``nvext.grammar`` regex and 8 unconstrained, 64 new each: every
     constrained output a prefix of its language, parsed and matched when
     it stops, whole when it ends ``length``, the enum's ending ``stop``
     (parsed on the card); no violation; the masked
     rows equal to the constrained tokens; no graph captured after warmup;
     both kernels launched; the constrained against the unconstrained
     TTFT and ITL, a unified step's time with and without constrained
     rows and the sampler's with and without its mask stage
     (``--grammar-compile`` alone: the schema, the regex and json_object
     compiled at that vocabulary, timed);
  o. mixture-of-experts: the f32 mixtral-8x7b at full width and 2 layers
     against a dense reference running each token through its chosen
     experts (1e-4); a 1-layer Mixtral-layout checkpoint written from the
     seeded init and loaded with ``quant="int8"``, bitwise equal to the
     device quantizer's; then ``TorchEngine`` with
     ``EngineConfig(model="mixtral-8x7b", weight_quant="int8")`` at full
     width and depth (int8 experts drawn on the card, bf16 pages, 16 rows,
     1024 pages, 512-token chunks, 8 decode steps, depth 2): resident and
     peak memory, 8 greedy requests of 512..2045 ids with 64 new each
     (whole, no graph captured after warmup, both kernels launched),
     finite logits, graph replays bitwise equal to eager calls,
     ``qdot_batched``'s int32 accumulators exact against their plain
     product, and a fused decode dispatch and a 512-token prefill step
     beside their bound, the larger of the weights' bytes and the int8
     operations the routing needs (the dropless layout's operations
     reported beside it);
  p. the serving SDK and the native library: PyYAML's presence; the native
     library (dynamo_tpu_torch/csrc/native, host C++) built with g++ (its
     time and ``g++ --version``) and its chained hashes of a 131072-id
     salted prompt equal to the pure-Python chain (both timed); then the
     SDK's example graph at llama-3.1-8b's full width and depth
     (``python -m dynamo_tpu_torch.sdk.runner
     dynamo_tpu_torch.examples.llm.graphs:agg -f CFG --http-port P --router
     kv``: the runner's hub, Frontend, Processor, TorchWorker on the card,
     and the HTTP edge, each a child of the runner): the worker's boot;
     three greedy chat prompts of 32 tokens with logprobs, one at a time,
     each served cold at the edge, then again at the edge and through
     ``Processor.chat`` on the service plane: the two equal, token and
     logprob, and the cold text the same; the worker's kernel launches
     (a ``sitecustomize`` on the children's path zeroes them on SIGUSR1
     just before and writes them at exit; both attention kernels must
     launch); no other child opens a CUDA context (the same reports) and
     at most one new process holds card memory (nvidia-smi); ``model
     add`` of an alias for ``examples.TorchWorker.generate`` served at the
     edge, ``model remove`` answered 404; SIGTERM stops the graph, every
     child through its shutdown, within the supervisor's 10 s; TTFT and ITL
     at the edge, reported;
  q. tensor, expert, data and sequence parallelism and the step plane,
     with ranks that share this one card over gloo (NCCL refuses two ranks
     on one GPU; no number here measures an interconnect): the backend and
     program mode chosen and the device count; two f32 ranks
     (``--parallel-rank``) at llama-3.1-8b's width and 2 layers, each
     holding its own one-rank reference: tp 2 logits and each rank's pages
     against tp 1's head slice, W8A8 tp 2 against W8A8 tp 1, mixtral-8x7b's
     width at ep 2 against ep 1, and an sp 2 ring pass over 4096 ids (its
     first-token logits and sealed pages against the chunked path), each
     within 1e-4; the group's all-reduce of [16, 4096] and [512, 4096]
     bf16; then at 16 of 32 layers in bf16: ``run in=http out=torch --tp 2``
     (its second rank started by the command) serving 3 greedy requests
     one at a time, both ranks launching both attention kernels (the site
     hook of phase p), each rank's peak allocated memory and the card's
     used memory, TTFT, ITL, a warm-``_build``
     boot, and how many streams equal a one-rank engine's (ungated); the
     same as two commands (``--nnodes 2``, ``DYN_STEP_TOKEN`` set): the
     same texts, and the follower exits with its leader; ``run --sp 2``
     sealing a 4096-id prompt in one ring pass, its TTFT beside the
     one-rank chunked TTFT, then two more sent at once, each sealed and
     served whole; no rank process outlives its run;
  r. KV export and the whole-block KV tiers at tp 2 on one node, at 16 of
     llama-3.1-8b's 32 layers, every rank sharing this card over gloo:
     the disaggregated stack (hub, ``http``, D = the CLI's own ``--disagg
     decode`` code in this process) with ``run … --disagg prefill --tp 2``
     as its prefill worker P (the command starts its second rank): 4
     greedy prompts of 2040 ids, 64 new tokens, all remote, none local or
     degraded, every streams whole, D's imported pages of the first prompt
     bitwise the leader's gathered payload (every KV head), remote TTFT
     beside D's local TTFT, P's export by part with the gather's share (a
     SIGUSR2 snapshot from the children's site hook) and how many streams
     equal D's local prefill of the same shapes (ungated); then ``run
     in=http out=torch --tp 2`` with phase g's budgets (host 1024 MiB,
     disk 1024 MiB, object store 2048 MiB), its leader in this process: 17
     prompts of 2056 ids (8 new), then prefixes whose first block is in
     the object store, on disk and in host, each off the device, served
     again: every stream's tokens and logprobs equal its first pass, the
     restored blocks equal the counter and /metrics, the node's host-tier
     bytes summed over its ranks (the follower's from its snapshot) within
     1024 MiB, the CRC kernel launched on the leader; then a fresh
     one-rank engine on that object store restores the tp-2 prefix (scale
     from zero across tp; its stream against tp 2's ungated); no started
     rank outlives its command;
  s. the tuned launch table: ``python -m dynamo_tpu_torch.tools.tune_decode``
     (its ``main``, in this process) at the serve phase's geometry, full
     chains of 16 rows of 256 pages (bf16; the bench and loadgen
     geometries were cut for phase t's time) into a temporary table:
     every decode (splits, ppcb) and
     prefill split count printed beside the built-in launch and the bound,
     each held against the plain version (1e-2), the winners written; then
     each kernel row of phases 4 and a under its geometry's entry beside
     the built-in launch in alternating rounds, the tuned launch's shape
     checked against the entry; then ``TorchEngine`` at phase 6's geometry
     (PATH_CUT_LAYERS layers) with DYN_DECODE_TUNE_TABLE at the table: the
     installed entry equal to the serve entry, 4 greedy requests of
     512..1169 ids, 32 new each, whole, both kernels launched at the
     entry's (part, J), no graph captured after warmup, the graph check,
     DYN_DECODE_SPLITS beating the table, and a fused decode dispatch with
     and without the table (an engine on the same weights) in turns;
  t. the fault matrix and the chaos ladder on the card at 16 of
     llama-3.1-8b's 32 layers: ``dynamo_tpu_torch.tools.fault_matrix``
     with ``--engine`` (no UNEXPECTED or NOT RECOVERED row), then
     ``dynamo_tpu_torch.tools.goodput``'s rungs L0, L1, L7 and L10 on
     three ``TorchEngine`` workers sharing one weight tree (L10 spawns a
     fourth from zero), under ``--check`` and cross-checked against that
     matrix, every kernel of the ladder's path launched;
  8. print the kernels line (each kernel's int8 timings and its launches in
     phases c, d, e, f, g, h, i, j, k, l, m, n, o, p, q, r, s and t beside
     phase 6's and 7's, and its tuned time at each geometry of phase s; the
     categorical draw's in phases j, k, l, e, p and q), then the device line
     last.

Needs a CUDA device; without one it prints no result and exits 1.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak

H, KV, D, PS = 32, 8, 128, 16  # llama-3.1-8b attention geometry
G = H // KV
# The serving configuration of phase 6; phase 4 times the kernels at the
# shapes it gives them.
SERVE_CFG = dict(
    model="llama-3.1-8b", dtype="bfloat16", block_size=PS, num_blocks=2048,
    max_batch=16, max_model_len=4096, prefill_chunk=512, decode_steps=8,
    pipeline_depth=2, seed=0,
)


# The card's name and power limit as nvidia-smi gives them (set by main).
CARD = "not read"


_FAIL_RE = re.compile(r"\bFAIL")


def log(*a):
    """A line of the report on stdout; a line that reports a failed check
    goes to stderr as well, so the end of stderr names what failed."""
    print(*a, flush=True)
    line = " ".join(map(str, a))
    if _FAIL_RE.search(line):
        print(line, file=sys.stderr, flush=True)
        _FAILED_LINES.append(line)


_FAILED_LINES = []  # every failed check's line, repeated under the closing summary


_T0 = time.perf_counter()


def mark(phase):
    """When a phase starts, in seconds since the script started (its wall
    is the next mark's time less this one's)."""
    log(f"phase {phase} starts at {time.perf_counter() - _T0:.1f} s")


# ------------------------------------------------------------------ inputs


def _pages(torch, gen, dev, P, dtype, scale):
    from dynamo_tpu_torch.ops.ragged_attention import quantize_for_cache

    vals = torch.randn((P, PS, 2 * KV, D), generator=gen, device=dev)
    return quantize_for_cache(vals / scale, dtype)


def decode_case(torch, gen, dev, lens, nvalid, PP, q_dtype, page_dtype, scale):
    S = len(lens)
    q = torch.randn((S, H, D), generator=gen, device=dev).to(q_dtype)
    pages = _pages(torch, gen, dev, S * PP + 8, page_dtype, scale)
    tables = torch.randperm(S * PP, generator=gen, device=dev).view(S, PP).int()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    num = torch.tensor([nvalid], dtype=torch.int32, device=dev)
    return q, pages, kv_lens, tables, num


def prefill_case(torch, gen, dev, priors, q_lens, S, T, q_dtype, page_dtype, scale):
    kv = [p + n for p, n in zip(priors, q_lens)]
    PP = max(1, math.ceil(max(kv) / PS))
    q = torch.randn((T, H, D), generator=gen, device=dev).to(q_dtype)
    pages = _pages(torch, gen, dev, S * PP + 8, page_dtype, scale)
    tables = torch.randperm(S * PP, generator=gen, device=dev).view(S, PP).int()
    kv_lens = torch.zeros(S, dtype=torch.int32, device=dev)
    kv_lens[: len(kv)] = torch.tensor(kv, dtype=torch.int32)
    cu = [0]
    for n in q_lens:
        cu.append(cu[-1] + n)
    cu += [cu[-1]] * (S + 1 - len(cu))
    cu_t = torch.tensor(cu, dtype=torch.int32, device=dev)
    num = torch.tensor([len(q_lens)], dtype=torch.int32, device=dev)
    return q, pages, kv_lens, tables, cu_t, num


# ------------------------------------------------------------------ timing


SPIN_CYCLES = 100_000_000  # ~50 ms at the H100's clocks


def cuda_ms(torch, fn, iters, flush, spin=True):
    """Mean device ms of ``fn`` over ``iters`` launches, each timed by CUDA
    events with the L2 cache flushed before it (the serving path reads each
    layer's KV once per step, cold).  With ``spin``, a spin kernel holds
    the stream while the host queues every launch, so a timed window holds
    the device's work and not the host's time to launch it; if the spin
    ends before the last launch is queued, the run is made again with a
    longer spin.  Without it (for a function that waits on the device
    itself), a window also holds the host's time inside ``fn``."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        if spin:
            torch.cuda._sleep(SPIN_CYCLES * 4**attempt)
        spun = torch.cuda.Event()
        spun.record()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        queued_in_time = not spin or not spun.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return sum(s.elapsed_time(e) for s, e in pairs) / iters
    raise RuntimeError("the host could not queue the timed launches within the spin")


TIMING_ROUNDS = 7


def alternating_ms(torch, kernel, library, flush):
    """Kernel and library call timed in turns, TIMING_ROUNDS rounds of 20
    launches each, so that a drift of the card's clocks reaches both
    alike: the median round of each, and every round's mean."""
    rounds = {"ms": [], "library_ms": []}
    for _ in range(TIMING_ROUNDS):
        rounds["ms"].append(cuda_ms(torch, kernel, 20, flush))
        rounds["library_ms"].append(cuda_ms(torch, library, 20, flush))
    return {k: statistics.median(v) for k, v in rounds.items()}, rounds


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------ the port-only kernels' bounds
# Lanes a clock on one SM of sm_90 (the CUDA C++ Programming Guide's
# throughput table for compute capability 9.0): 32-bit integer add, logic,
# shift, compare and select on the ALU pipe 64; IMAD on the FMA pipe's
# heavy half 64, float add/multiply/FMA on both halves 128; MUFU (log2,
# exp2, reciprocal) 16; conversions 16; instruction issue 4 warps (128
# lanes).  Shared memory serves one 128-byte wavefront a clock an SM.
PIPE_LANES = {"alu": 64, "imad": 64, "fp32": 128, "mufu": 16, "xu": 16, "issue": 128}
SASS_PIPES = {
    "alu": {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "SEL", "ISETP", "LEA",
            "IMNMX", "IABS", "BMSK", "SGXT", "PLOP3", "P2R", "R2P", "MOV", "FSETP", "FSEL",
            "FMNMX", "CSET", "CSETP", "FLO", "POPC", "BREV", "LEA.HI"},
    "imad": {"IMAD", "VIADD", "IMUL", "IDP", "IMNMX3"},
    "fp32": {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I", "FCHK"},
    "mufu": {"MUFU"},
    "xu": {"I2F", "F2I", "F2F", "I2I", "FRND", "I2FP", "F2IP"},
}
CRC_OPS_PER_4_BYTES = 8  # slicing by 4: 1 xor in, 4 byte extractions, 3 xors to combine
CRC_LOOKUPS_PER_BYTE = 1  # one table lookup a byte; conflict-free, 32 a wavefront
CRC_RANDOM_BANK_WAVEFRONTS = 3.5  # 32 random lookups into one table copy: ~3.5 to a bank


def sm_count(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def during(fn):
    """``fn()`` with the card's SM clock sampled by nvidia-smi meanwhile:
    (its result, the samples in MHz)."""
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=30)
            try:
                samples.append(float(r.stdout.split()[0]))
            except (ValueError, IndexError):
                pass

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        return fn(), samples
    finally:
        stop.set()
        th.join(60)


def run_clock_hz(samples):
    """The SM clock while the kernel ran: the median sample, else the
    card's maximum SM clock (both from nvidia-smi)."""
    if samples:
        return statistics.median(samples) * 1e6
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=30)
    return float(r.stdout.split()[0]) * 1e6


def sass_functions(lib_path):
    """A built library's SASS by function (cuobjdump -sass): {function:
    [(address, opcode, text)]}, or None without the tool."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            out[fn] = []
            continue
        m = re.match(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if fn is not None and m:
            text = m.group(2)
            body = re.sub(r"^@!?U?P\w+\s+", "", text)
            out[fn].append((int(m.group(1), 16), body.split()[0].split(".")[0], text))
    return out


def sass_listing(lib_path, kernel_substr):
    """The SASS of the one function of a built library whose name holds
    ``kernel_substr``, or None (no tool, no such function)."""
    fns = sass_functions(lib_path) or {}
    return next((ins for fn, ins in fns.items() if kernel_substr in fn), None)


def pipe_of(op):
    for pipe, ops in SASS_PIPES.items():
        if op in ops:
            return pipe
    return "other"


def sass_per_element(listing, per_iteration, per_thread):
    """Instructions a thread executes for one element, by pipe, in a kernel
    whose threads loop over their elements.  The rule: the body of the
    element loop (the span of its backward branch, the largest if there
    are several) runs once for ``per_iteration`` elements and counts
    1/per_iteration; every other instruction up to the last unpredicated
    EXIT (the row key before the loop, the reduction after it) runs once
    a thread and counts 1/per_thread, the elements a thread takes.  A
    forward branch taken on a predicate around a CALL and no other branch
    (the division's slow path, for operands outside its fast range) guards
    a region that counts 0.  What follows the last unpredicated EXIT is padding or the
    subroutines called.  Returns (counts by pipe, counts by opcode,
    {region: instructions})."""
    end = max((i for i, (_, op, text) in enumerate(listing)
               if op == "EXIT" and not text.startswith("@")), default=len(listing) - 1)
    ins = listing[:end + 1]

    def target(text):
        m = re.search(r"BRA(?:\.\w+)*\s+(?:!?U?P\w+,\s*)?`?\(?(0x[0-9a-f]+)", text)
        return int(m.group(1), 16) if m else None

    loops = [(ins[i][0] - target(text), target(text), ins[i][0])
             for i, (addr, op, text) in enumerate(ins)
             if op == "BRA" and target(text) is not None and target(text) < addr]
    lo, hi = max(loops)[1:] if loops else (None, None)
    weight = [1.0 / per_iteration if lo is not None and lo <= addr <= hi else 1.0 / per_thread
              for addr, _, _ in ins]
    regions = {"loop body": sum(lo is not None and lo <= a <= hi for a, _, _ in ins),
               "once a thread": sum(not (lo is not None and lo <= a <= hi) for a, _, _ in ins)}
    for i, (addr, op, text) in enumerate(ins):
        t = target(text) if op == "BRA" and text.startswith("@") else None
        if t is None or t <= addr:
            continue
        body = [j for j in range(i + 1, len(ins)) if ins[j][0] < t]
        ops = {ins[j][1] for j in body}
        if "CALL" in ops and "BRA" not in ops:
            for j in body:
                weight[j] = 0.0
            regions["slow path"] = regions.get("slow path", 0) + len(body)
    by_pipe, by_op = {}, {}
    for w, (_, op, _) in zip(weight, ins):
        by_op[op] = by_op.get(op, 0.0) + w
        by_pipe[pipe_of(op)] = by_pipe.get(pipe_of(op), 0.0) + w
    return by_pipe, by_op, regions


def pipe_times_ms(per_element, elements, sms, clock_hz):
    """Each pipe's least time for ``elements`` threads' worth of the
    per-element counts: lanes over lanes a clock on every SM.  IMAD and
    float work share the FMA pipe: its time is the larger of IMAD on the
    heavy half and both on both halves.  'issue' counts every instruction."""
    rate = sms * clock_hz
    t = {p: elements * per_element.get(p, 0.0) / (PIPE_LANES[p] * rate) * 1e3
         for p in ("alu", "mufu", "xu")}
    imad, f32 = per_element.get("imad", 0.0), per_element.get("fp32", 0.0)
    t["fma"] = elements * max(imad / PIPE_LANES["imad"], (imad + f32) / PIPE_LANES["fp32"]) \
        / rate * 1e3
    t["issue"] = elements * sum(per_element.values()) / (PIPE_LANES["issue"] * rate) * 1e3
    return t


# ------------------------------------------------------------ kernel checks


def tensor_core_report(lib_path):
    """HMMA (tensor-core mma) instructions per kernel function in a built
    library's SASS: {function: count}, or None without cuobjdump."""
    fns = sass_functions(lib_path)
    if fns is None:
        return None
    return {fn: sum(op == "HMMA" for _, op, _ in ins) for fn, ins in fns.items()}


def check_tensor_cores(failures):
    """The bf16 bodies (``*_tc_kernel``) must run on the tensor cores and
    the f32 bodies (``*_f32_kernel``) must not."""
    from dynamo_tpu_torch.ops import _build

    for stem in ("decode_attention", "prefill_attention"):
        counts = tensor_core_report(_build._target(_build.CSRC / f"{stem}.cu"))
        if counts is None:
            log(f"sass {stem}: cuobjdump not found, not checked")
            continue
        for fn, n in sorted(counts.items()):
            m = re.search(r"\d+((?:prefill|decode)_(?:tc|f32)_kernel)I(\w+?)EEv", fn)
            if not m:
                continue
            ok = n > 0 if m.group(1).endswith("_tc_kernel") else n == 0
            log(f"sass {stem}: {m.group(1)}<{m.group(2)}> {n} HMMA {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{stem} {m.group(1)}<{m.group(2)}> tensor-core use")


class Tally:
    """Every comparison of a kernel with its plain version: the worst
    max-abs error per kernel and the labels of those that failed."""

    def __init__(self):
        self.worst = {"decode_attention": 0.0, "prefill_attention": 0.0, "threefry_gumbel": 0.0,
                      "crc32_blocks": 0.0}
        self.failures = []

    def compare(self, torch, name, label, got, want, tol, zero_rows=()):
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        self.worst[name] = max(self.worst[name], err)
        ok = bool(torch.isfinite(g).all()) and torch.allclose(g, w, rtol=tol, atol=tol)
        for r in zero_rows:
            ok = ok and bool((g[r] == 0).all())
        log(f"check {name} {label}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name} {label}")


# (q dtype, page dtype, kv_scale, tolerance) of every kernel check.
CHECK_DTYPES = [
    ("bfloat16", "bfloat16", 1.0, 1e-2),
    ("bfloat16", "int8", 0.02, 1e-2),
    ("bfloat16", "float8_e4m3fn", 0.01, 1e-2),
    ("bfloat16", "float32", 1.0, 1e-2),
    ("float32", "float32", 1.0, 1e-4),
]


def serving_decode_lens(cfg):
    """kv_lens of a fused decode dispatch of the serve phase: 8 live rows at
    576..2116 tokens, the other max_batch rows padding rows at kv_len 1."""
    live = [576 + 220 * i for i in range(8)]
    return live, live + [1] * (cfg.max_batch - len(live))


# Context lengths of the 7 decode rows that ride a mixed prefill/decode
# step beside a 512-token chunk: spread over the serve phase's decode
# lengths, 576..2116 tokens.
MIXED_DECODE_LENS = [576, 833, 1089, 1346, 1603, 1859, 2116]


def check_kernels(torch, dev, cfg, tally):
    """Phase 3: each kernel against its plain version, every page dtype."""
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sm = D**-0.5
    dt = {n: getattr(torch, n) for n in ("bfloat16", "int8", "float8_e4m3fn", "float32")}

    # Decode: S 64 with ragged kv_len up to 4096, zero-length rows and rows
    # past num_seqs; and the serve phase's own geometry (max_batch rows,
    # padding rows at kv_len 1, its table width), whose automatic split
    # count leaves an uneven last split.
    lens64 = [int(x) for x in torch.randint(1, 4097, (64,), generator=torch.Generator().manual_seed(1))]
    lens64[0], lens64[5], lens64[17] = 4096, 0, 1
    # Partition edges: kv_len on a partition boundary and one past it, a
    # row spanning the whole 4096-token table, padding rows at kv_len 1 and
    # rows past num_seqs.
    part = da.DECODE_PARTITION
    edges = [part, part + 1, 2 * part, 2 * part + 1, 4096, part - 1, 1, 1, 3000, 1]
    geometries = [
        ("S=64", lens64, 56, 4096 // PS),
        (f"S={cfg.max_batch} serving", serving_decode_lens(cfg)[1], cfg.max_batch,
         cfg.max_blocks_per_seq),
        (f"S={len(edges)} partition edges", edges, 8, 4096 // PS),
    ]
    for geo, lens, nvalid, PP in geometries:
        S = len(lens)
        zero = [r for r in range(S) if r >= nvalid or lens[r] == 0]
        for q_dt, p_dt, scale, tol in CHECK_DTYPES:
            q, pages, kv_lens, tables, num = decode_case(
                torch, gen, dev, lens, nvalid, PP, dt[q_dt], dt[p_dt], scale)
            want = da.decode_attention_plain(q, pages, kv_lens, tables, num, sm_scale=sm, kv_scale=scale)
            for splits in (1, None):
                got = da.decode_attention_cuda(q, pages, kv_lens, tables, num, sm_scale=sm,
                                               kv_scale=scale, num_kv_splits=splits)
                tally.compare(torch, "decode_attention",
                              f"{geo} q={q_dt} pages={p_dt} splits={splits or 'auto'}",
                              got, want, tol, zero)
            del q, pages, want, got

    # Prefill, at the serve phase's row count with rows past num_seqs and a
    # padded T bucket: ragged rows whose lengths are not multiples of the
    # kernel's q-block (16 tokens at G 4), of a warp's 16 rows or of its
    # 64-key tile, prior prefixes ending mid-page and on page edges, and a
    # mixed step's 512-token chunk beside 1-token rows up to 2116 tokens.
    S = cfg.max_batch
    cases = [
        ("ragged", [0, 1024, 77, 300, 2000], [37, 500, 1, 203, 61], 1024),
        ("tile edges", [16, 45, 64, 0, 1], [63, 65, 17, 128, 3], 512),
        ("mixed step", [1024] + [n - 1 for n in MIXED_DECODE_LENS], [512] + [1] * 7,
         cfg.bucket_tokens(519)),
    ]
    for label, priors, q_lens, T in cases:
        for q_dt, p_dt, scale, tol in CHECK_DTYPES:
            q, pages, kv_lens, tables, cu, num = prefill_case(
                torch, gen, dev, priors, q_lens, S, T, dt[q_dt], dt[p_dt], scale)
            want = pa.prefill_attention_plain(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                              kv_scale=scale)
            zero = list(range(sum(q_lens), T))
            for splits in (1, 3):
                got = pa.prefill_attention_cuda(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                                kv_scale=scale, num_kv_splits=splits)
                tally.compare(torch, "prefill_attention",
                              f"{label} S={S} T={T} q={q_dt} pages={p_dt} splits={splits}",
                              got, want, tol, zero)
            del q, pages, want, got
    torch.cuda.empty_cache()


# ------------------------------------------------------------ kernel timing


def time_decode(torch, dev, tally, flush, label, lens, n_live, PP, page_dtype, scale,
                lib_rtol=0.0):
    """Time one decode launch at ``lens`` (the first ``n_live`` rows real,
    the rest padding rows at kv_len 1), table width ``PP``, bf16 q over
    ``page_dtype`` pages stored at ``scale``: the kernel, held against its
    plain version, beside the plain version, the bound and the library
    yardstick — SDPA over the live rows' pre-gathered K/V, dequantized to
    bf16 and kept at KV heads, each KV head's G query heads as its G query
    positions (the gather is not timed)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    sm = D**-0.5
    S = len(lens)
    kv_scale = None if page_dtype == torch.bfloat16 else scale
    q, pages, kv_lens, tables, num = decode_case(
        torch, gen, dev, lens, S, PP, torch.bfloat16, page_dtype, scale)
    esize = pages.element_size()
    kv_bytes = sum(lens) * 2 * KV * D * esize + sum(math.ceil(n / PS) for n in lens) * 4
    b_ms, b_by = bound(kv_bytes + 2 * q.numel() * 2 + S * 4, sum(lens) * H * D * 4)

    def kernel():
        return da.decode_attention_cuda(q, pages, kv_lens, tables, num, sm_scale=sm,
                                        kv_scale=kv_scale)

    def plain():
        return da.decode_attention_plain(q, pages, kv_lens, tables, num, sm_scale=sm,
                                         kv_scale=kv_scale)

    got = kernel()
    tally.compare(torch, "decode_attention", f"{label} S={S} PP={PP} pages={page_dtype}",
                  got, plain(), 1e-2)
    W = max(lens[:n_live])
    ctx = torch.arange(W, device=dev)
    slots = tables[:n_live, (ctx // PS).clamp(max=PP - 1)].long() * PS + ctx % PS
    kvg = (pages.view(-1, 2 * KV, D)[slots].float() * (kv_scale or 1.0)).to(torch.bfloat16)
    k = kvg[:, :, 0::2].permute(0, 2, 1, 3).contiguous()  # [n, KV, W, D]
    v = kvg[:, :, 1::2].permute(0, 2, 1, 3).contiguous()
    del kvg
    mask = (ctx[None, :] < kv_lens[:n_live, None])[:, None, None, :]  # [n, 1, 1, W]
    qg = q[:n_live].reshape(n_live, KV, G, D)

    def library():
        return F.scaled_dot_product_attention(qg, k, v, attn_mask=mask, scale=sm)

    lib = library().reshape(n_live, H, D).float()
    lib_err = float((lib - got[:n_live].float()).abs().max())
    lib_ok = torch.allclose(lib, got[:n_live].float(), rtol=lib_rtol, atol=LIBRARY_ATOL)
    medians, rounds = alternating_ms(torch, kernel, library, flush)
    r = dict(**medians, rounds=rounds, plain_ms=cuda_ms(torch, plain, 3, flush, spin=False),
             library_err=lib_err, library_ok=lib_ok, lib_rtol=lib_rtol, bound_ms=b_ms,
             bound_by=b_by,
             shape=f"{label}: S={S} PP={PP} kv_lens {min(lens[:n_live])}..{W} "
                   f"({n_live} live) q bf16 pages {str(page_dtype).split('.')[-1]}; "
                   f"library: {n_live} live rows padded to {W}")
    del q, pages, k, v, got, lib
    return r


def time_prefill(torch, dev, tally, flush, label, S, T, priors, q_lens, page_dtype, scale,
                 lib_rtol=0.0):
    """Time one prefill launch of rows ``q_lens`` over prior prefixes
    ``priors`` in a ``T``-token bucket of ``S`` rows, bf16 q over
    ``page_dtype`` pages: the kernel against its plain version, beside the
    plain version, the bound and the library yardstick — one SDPA call
    over every row's pre-gathered, dequantized K/V at KV heads (query
    token t of head kv*G + g is row t*G + g of its KV head; rows padded to
    the longest, masked causally at prior + t)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import prefill_attention as pa

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    sm = D**-0.5
    kv_scale = None if page_dtype == torch.bfloat16 else scale
    q, pages, kv_lens, tables, cu, num = prefill_case(
        torch, gen, dev, priors, q_lens, S, T, torch.bfloat16, page_dtype, scale)
    ctxs = [p + n for p, n in zip(priors, q_lens)]
    nbytes = (sum(ctxs) * 2 * KV * D * pages.element_size() + 2 * sum(q_lens) * H * D * 2
              + sum(math.ceil(c / PS) for c in ctxs) * 4)
    flops = sum(sum(p + i + 1 for i in range(n)) for p, n in zip(priors, q_lens)) * H * D * 4
    b_ms, b_by = bound(nbytes, flops)

    def kernel():
        return pa.prefill_attention_cuda(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                         kv_scale=kv_scale)

    def plain():
        return pa.prefill_attention_plain(q, pages, kv_lens, tables, cu, num, sm_scale=sm,
                                          kv_scale=kv_scale)

    got = kernel()
    tally.compare(torch, "prefill_attention", f"{label} T={T} S={S} pages={page_dtype}",
                  got, plain(), 1e-2, range(sum(q_lens), T))
    R, Qm, L = len(q_lens), max(q_lens), max(ctxs)
    ctx = torch.arange(L, device=dev)
    PP = tables.shape[1]
    slots = tables[:R, (ctx // PS).clamp(max=PP - 1)].long() * PS + ctx % PS  # [R, L]
    kvg = (pages.view(-1, 2 * KV, D)[slots].float() * (kv_scale or 1.0)).to(torch.bfloat16)
    k = kvg[:, :, 0::2].permute(0, 2, 1, 3).contiguous()  # [R, KV, L, D]
    v = kvg[:, :, 1::2].permute(0, 2, 1, 3).contiguous()
    del kvg
    qg = torch.zeros((R, Qm, H, D), dtype=q.dtype, device=dev)
    for r, (start, n) in enumerate(zip(cu.tolist(), q_lens)):
        qg[r, :n] = q[start:start + n]
    qg = qg.reshape(R, Qm, KV, G, D).permute(0, 2, 1, 3, 4).reshape(R, KV, Qm * G, D).contiguous()
    t = torch.arange(Qm, device=dev)
    prior = torch.tensor(priors, device=dev)
    # Padding query rows may see key 0 only, so they stay finite.
    limit = torch.where(t[None, :] < torch.tensor(q_lens, device=dev)[:, None],
                        prior[:, None] + t[None, :], 0).repeat_interleave(G, dim=1)
    pmask = (ctx[None, None, :] <= limit[:, :, None])[:, None]  # [R, 1, Qm*G, L]

    def library():
        return F.scaled_dot_product_attention(qg, k, v, attn_mask=pmask, scale=sm)

    lib = library().reshape(R, KV, Qm, G, D).permute(0, 2, 1, 3, 4).reshape(R, Qm, H, D)
    pairs = [(lib[r, :n].float(), got[s:s + n].float())
             for r, (s, n) in enumerate(zip(cu.tolist(), q_lens))]
    lib_err = max(float((a - b).abs().max()) for a, b in pairs)
    lib_ok = all(torch.allclose(a, b, rtol=lib_rtol, atol=LIBRARY_ATOL) for a, b in pairs)
    medians, rounds = alternating_ms(torch, kernel, library, flush)
    out = dict(**medians, rounds=rounds, plain_ms=cuda_ms(torch, plain, 3, flush, spin=False),
               library_err=lib_err, library_ok=lib_ok, lib_rtol=lib_rtol, bound_ms=b_ms,
               bound_by=b_by,
               shape=f"{label}: T={T} S={S}, rows {list(q_lens)} tokens over prefixes "
                     f"{list(priors)}, q bf16 pages {str(page_dtype).split('.')[-1]}")
    del q, pages, k, v, got, lib, pairs
    return out


LIBRARY_ATOL = 1e-2


def report_times(torch, out, tally):
    """Print each timing and hold the library yardstick to the kernel's
    output (it must compute the same function)."""
    for name, r in out.items():
        ok = r["library_ok"]
        log(f"time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms (kernel/library {r['ms'] / r['library_ms']:.3f}; "
            f"vs kernel max_abs_err {r['library_err']:.3e} (atol {LIBRARY_ATOL} rtol "
            f"{r['lib_rtol']}) {'ok' if ok else 'FAIL'}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"medians of {TIMING_ROUNDS} alternating rounds: kernel "
            f"{[round(x, 4) for x in r['rounds']['ms']]} library "
            f"{[round(x, 4) for x in r['rounds']['library_ms']]}")
        if not ok:
            tally.failures.append(f"{name.split(' ')[0]} library yardstick computes another function")


def time_kernels(torch, dev, cfg, tally):
    """Phase 4, at the serving path's shapes: the rows of a fused decode
    dispatch (serving_decode_lens) and a 512-token prefill chunk over a
    1024-token prior prefix in its token bucket; then the prefill kernel at
    a mixed step's shape beside a decode launch of its one-token rows."""
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    sm = D**-0.5
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    S, PP = cfg.max_batch, cfg.max_blocks_per_seq
    live, lens = serving_decode_lens(cfg)
    out = {
        "decode_attention": time_decode(torch, dev, tally, flush, "serving shape", lens,
                                        len(live), PP, torch.bfloat16, 1.0),
        "prefill_attention": time_prefill(torch, dev, tally, flush, "serving shape", S,
                                          cfg.bucket_tokens(cfg.prefill_chunk), [1024],
                                          [cfg.prefill_chunk], torch.bfloat16, 1.0),
    }
    prior, ql = 1024, cfg.prefill_chunk

    # A mixed step: the serve cadence's 512-token chunk over its 1024-token
    # prefix beside 7 one-token decode rows (MIXED_DECODE_LENS), one prefill
    # launch.  No single library call computes it: library not measured.
    priors = [prior] + [n - 1 for n in MIXED_DECODE_LENS]
    q_lens = [ql] + [1] * len(MIXED_DECODE_LENS)
    Tm = cfg.bucket_tokens(sum(q_lens))
    q, pages, kv_lens, tables, cu, num = prefill_case(
        torch, gen, dev, priors, q_lens, S, Tm, torch.bfloat16, torch.bfloat16, 1.0)
    ctxs = [p + n for p, n in zip(priors, q_lens)]
    nbytes = (sum(ctxs) * 2 * KV * D * 2 + 2 * sum(q_lens) * H * D * 2
              + sum(math.ceil(c / PS) for c in ctxs) * 4)
    flops = (sum(prior + i + 1 for i in range(ql)) + sum(MIXED_DECODE_LENS)) * H * D * 4
    b_ms, b_by = bound(nbytes, flops)

    def kernel():
        return pa.prefill_attention_cuda(q, pages, kv_lens, tables, cu, num, sm_scale=sm)

    def plain():
        return pa.prefill_attention_plain(q, pages, kv_lens, tables, cu, num, sm_scale=sm)

    got = kernel()
    tally.compare(torch, "prefill_attention", f"mixed step shape T={Tm} S={S} bf16",
                  got, plain(), 1e-2, range(sum(q_lens), Tm))
    # What the 7 rows cost as a decode-shaped launch of their own (16 rows,
    # the rest padding rows at kv_len 1), for comparison.
    dq, dpages, dlens, dtables, dnum = decode_case(
        torch, gen, dev, MIXED_DECODE_LENS + [1] * (S - len(MIXED_DECODE_LENS)), S, PP,
        torch.bfloat16, torch.bfloat16, 1.0)

    def decode_rows():
        return da.decode_attention_cuda(dq, dpages, dlens, dtables, dnum, sm_scale=sm)

    rounds, drounds = [], []
    for _ in range(TIMING_ROUNDS):
        rounds.append(cuda_ms(torch, kernel, 20, flush))
        drounds.append(cuda_ms(torch, decode_rows, 20, flush))
    mixed = dict(ms=statistics.median(rounds), bound_ms=b_ms, bound_by=b_by,
                 plain_ms=cuda_ms(torch, plain, 3, flush, spin=False),
                 decode_rows_ms=statistics.median(drounds))
    log(f"time prefill_attention mixed step [T={Tm} S={S}: a {ql}-token chunk over a "
        f"{prior}-token prefix and 7 one-token rows at {MIXED_DECODE_LENS[0]}.."
        f"{MIXED_DECODE_LENS[-1]} tokens, bf16]: kernel {mixed['ms']:.4f} ms, plain "
        f"{mixed['plain_ms']:.4f} ms, library not measured (no single call computes it), "
        f"bound {b_ms:.4f} ms ({b_by}); the 7 rows as a decode launch "
        f"{mixed['decode_rows_ms']:.4f} ms; rounds {[round(x, 4) for x in rounds]} / "
        f"{[round(x, 4) for x in drounds]}")
    out["prefill_attention"]["mixed"] = mixed
    del q, pages, got, dq, dpages, flush
    torch.cuda.empty_cache()
    report_times(torch, out, tally)
    return out


# The int8-page shapes of this slice's two serving geometries (phases c
# and d): a fused decode step and a prefill step of each.
INT8_KV_SCALE = 0.02
# The library yardstick against the kernel there: a query early in a short
# causal context averages few values of up to ±2.54 (int8 · 0.02), where
# one bf16 ulp is 0.0156, so the check is relative as well.
INT8_LIB_RTOL = 1e-2


def time_int8_kernels(torch, dev, tally):
    """Both kernels over int8 pages (scale INT8_KV_SCALE) at the shapes of
    phase c (bench.py: 256 rows at 129..192 tokens over 16-page tables; a
    512-token step of four 128-token prompts) and phase d (loadgen: 24 rows
    at 3000..3138 tokens over 256-page tables; a 2048-token step packing a
    prompt's last 952 tokens over its 2048-token prefix with the next
    prompt's first 1096), each held against its plain version.  Returns
    {geometry: {kernel: timing}}."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    i8, sc = torch.int8, INT8_KV_SCALE
    bench_lens = [129 + (7 * i) % 64 for i in range(256)]
    loadgen_lens = [3000 + 6 * i for i in range(24)]
    out = {
        "bench": {
            "decode_attention": time_decode(torch, dev, tally, flush, "phase c fused step",
                                            bench_lens, 256, 16, i8, sc, INT8_LIB_RTOL),
            "prefill_attention": time_prefill(torch, dev, tally, flush, "phase c prefill step",
                                              256, 512, [0] * 4, [128] * 4, i8, sc,
                                              INT8_LIB_RTOL),
        },
        "loadgen": {
            "decode_attention": time_decode(torch, dev, tally, flush, "phase d fused step",
                                            loadgen_lens, 24, 256, i8, sc, INT8_LIB_RTOL),
            "prefill_attention": time_prefill(torch, dev, tally, flush, "phase d prefill step",
                                              24, 2048, [2048, 0], [952, 1096], i8, sc,
                                              INT8_LIB_RTOL),
        },
    }
    del flush
    torch.cuda.empty_cache()
    for geo, r in out.items():
        report_times(torch, {f"{k} int8 {geo}": v for k, v in r.items()}, tally)
    return out


# ------------------------------------------------------------- the model


def reference_logits(torch, params, mc, tokens, ffn=None):
    """Dense (unpaged) forward of one prompt through plain PyTorch math,
    attention in f32: the logits at every position, [n, vocab].  ``ffn(x,
    lp)`` replaces the dense SwiGLU FFN (phase o's per-token experts)."""
    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.ops.rope import apply_rope, rope_frequencies

    p = params
    dev = p["embed"].device
    n, nh, nkv, hd = len(tokens), mc.num_heads, mc.num_kv_heads, mc.head_dim
    ids = torch.tensor(tokens, device=dev)
    pos = torch.arange(n, device=dev)
    inv = rope_frequencies(mc.head_dim, mc.rope_theta, mc.rope_scaling, device=dev)
    causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    h = tl.embed_lookup(p, ids, tl.torch_dtype(mc.dtype))
    for l in range(mc.num_layers):
        lp = {k: w[l] for k, w in p["layers"].items()}
        x = tl.rms_norm(h, lp["attn_norm"], mc.rms_norm_eps)
        q, k, v = tl.qkv_proj(x, lp, nh * hd, nkv * hd)
        q = apply_rope(q.reshape(n, nh, hd), pos, inv).float()
        k = apply_rope(k.reshape(n, nkv, hd), pos, inv).float().repeat_interleave(nh // nkv, dim=1)
        v = v.reshape(n, nkv, hd).float().repeat_interleave(nh // nkv, dim=1)
        s = torch.einsum("thd,uhd->htu", q, k) * hd**-0.5
        s = s.masked_fill(~causal, float("-inf")).softmax(-1)
        a = torch.einsum("htu,uhd->thd", s, v).to(h.dtype)
        h = h + tl.linear(a.reshape(n, nh * hd), lp, "wo")
        h = h + (ffn or tl.mlp)(tl.rms_norm(h, lp["mlp_norm"], mc.rms_norm_eps), lp)
    h = tl.rms_norm(h, p["final_norm"], mc.rms_norm_eps)
    return tl.lm_logits(p, h)


def one_row_batch(torch, dev, S, table, tokens, start, decode, kv_len=None):
    """A RaggedBatch whose row 0 holds ``tokens`` at positions start.. in
    the pages of ``table``, the other rows padded as the engine pads them:
    a prefill step's at kv_len 0 past num_seqs, a fused decode step's as
    1-token rows at kv_len 1.  ``kv_len`` overrides row 0's."""
    from dynamo_tpu_torch.models.llama import RaggedBatch

    n = len(tokens)
    T = S if decode else max(16, 1 << (n - 1).bit_length())
    pos = list(range(start, start + n))
    slots = [table[p // PS] * PS + p % PS for p in pos]
    row0 = start + n if kv_len is None else kv_len
    if decode:
        kv_lens, cu, num = [row0] + [1] * (S - 1), list(range(S + 1)), S
    else:
        kv_lens, cu, num = [row0] + [0] * (S - 1), [0] + [n] * S, 1

    def t(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    return RaggedBatch(
        token_ids=t(tokens + [0] * (T - n)),
        positions=t(pos + [0] * (T - n)),
        slot_mapping=t(slots + [-1] * (T - n)),
        kv_lens=t(kv_lens),
        page_indices=t([table] + [[0] * len(table)] * (S - 1)),
        cu_q_lens=t(cu),
        num_seqs=t([num]),
    )


MODEL_CHECK_LAYERS = 4
MODEL_CHECK_TOL = 1e-4


def model_check(torch, dev, cfg):
    """Phase 5: the paged model path in f32 — llama-3.1-8b at full width,
    its first MODEL_CHECK_LAYERS layers, f32 weights (seed 0) and f32
    pages — against the dense reference (``paged_vs_reference``).
    Returns ok."""
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.llama import fuse_projections, init_params

    mc = get_config("llama-3.1-8b").with_overrides(dtype="float32", num_layers=MODEL_CHECK_LAYERS)
    params = fuse_projections(init_params(mc, 0, dev))
    ok = paged_vs_reference(torch, dev, mc, params, cfg.max_batch, "model f32")
    del params
    torch.cuda.empty_cache()
    return ok


def paged_vs_reference(torch, dev, mc, params, S, label, ffn=None):
    """``forward_ragged`` of ``params`` in f32 against ``reference_logits``
    (with ``ffn`` in place of the dense FFN when given): a 300-token prompt
    prefilled in two chunks (the second over a 200-token prior prefix),
    then two fused-decode-shaped steps, through both kernels at ``S`` rows,
    each within MODEL_CHECK_TOL.  The check must not be blind: a run whose
    row is told one position fewer than it has (as a kernel that drops the
    newest K/V would compute) is made too, and must miss the reference by
    10x the tolerance.  Returns ok."""
    from dynamo_tpu_torch.models.llama import PagedKVCache, forward_ragged

    PP = 32
    cache = PagedKVCache.create(mc, 2 * PP, PS, torch.float32, dev)
    table = torch.randperm(2 * PP, generator=torch.Generator().manual_seed(3))[:PP].tolist()
    tokens = torch.randint(1, mc.vocab_size, (302,), generator=torch.Generator().manual_seed(4)).tolist()
    want = reference_logits(torch, params, mc, tokens, ffn)

    def run(part, start, decode, kv_len=None):
        rb = one_row_batch(torch, dev, S, table, part, start, decode, kv_len)
        return forward_ragged(params, mc, rb, cache, decode=decode)[0]

    ok = True
    forward_ragged(params, mc, one_row_batch(torch, dev, S, table, tokens[:200], 0, False), cache)
    steps = [
        ("prefill chunk 200..300 over 200", run(tokens[200:300], 200, False), 299),
        ("decode at 300", run(tokens[300:301], 300, True), 300),
        ("decode at 301", run(tokens[301:302], 301, True), 301),
    ]
    for step, got, row in steps:
        w = want[row]
        err = float((got - w).abs().max())
        good = bool(torch.isfinite(got).all()) and got.shape == w.shape and torch.allclose(
            got, w, rtol=MODEL_CHECK_TOL, atol=MODEL_CHECK_TOL)
        ok = ok and good
        log(f"{label} {mc.num_layers} layers, {step}: max_abs_err {err:.3e} "
            f"(logits max |x| {float(w.abs().max()):.3f}) tol {MODEL_CHECK_TOL} "
            f"{'ok' if good else 'FAIL'}")
    # Sensitivity: the last decode step again, its row told one position
    # fewer than it has (the newest K/V left out).
    off = run(tokens[301:302], 301, True, kv_len=301)
    miss = float((off - want[301]).abs().max())
    sensitive = miss > 10 * MODEL_CHECK_TOL
    log(f"{label} sensitivity: dropping the newest position moves the logits by {miss:.3e} "
        f"({'> 10x tol, ok' if sensitive else 'within 10x tol: the check is blind — FAIL'})")
    del cache, want
    torch.cuda.empty_cache()
    return ok and sensitive


SERVE_MAX_TOKENS = 64


def serve_prompts(torch):
    """The serve phases' 8 prompts: 512, 731, ..., 2045 random ids (seed 7)."""
    rng = torch.Generator().manual_seed(7)
    return [torch.randint(1, 128000, (512 + 219 * i,), generator=rng).tolist() for i in range(8)]


async def serve(torch, engine, prompts, max_tokens):
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(p):
        req = PreprocessedRequest(
            token_ids=p,
            stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
        ).to_dict()
        t0 = time.perf_counter()
        stream = await engine.generate(Context(req))
        toks, stamps, finish = [], [], None
        async for item in stream:
            now = time.perf_counter()
            for tok in item["token_ids"]:
                toks.append(tok)
                stamps.append(now - t0)
            finish = item.get("finish_reason") or finish
        return toks, stamps, finish

    return await asyncio.gather(*(one(p) for p in prompts))


def kernel_counts():
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    return {"decode_attention": da.decode_attention_cuda.launches,
            "prefill_attention": pa.prefill_attention_cuda.launches}


def zero_kernel_counts():
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    da.decode_attention_cuda.launches = 0
    pa.prefill_attention_cuda.launches = 0


GRAPH_CHECK_TOL = 1e-3


def graph_check(torch, dev, engine, bitwise_only=False):
    """A captured prefill bucket and the captured fused decode, seeded from
    the host and chained to the device carry, each against the eager call
    on the same inputs, every write dropped (prefill slots -1; decode
    limits at the rows' positions, so no step is writable), with and
    without logprobs.  Tokens must be equal, logprobs within
    GRAPH_CHECK_TOL (``bitwise_only``: equal).  Returns ok."""
    import numpy as np

    from dynamo_tpu_torch.models.llama import RaggedBatch

    cfg = engine.cfg
    S, PP, T_steps = cfg.max_batch, cfg.max_blocks_per_seq, cfg.decode_steps
    rng = np.random.default_rng(11)
    V = engine.model_config.vocab_size
    ok = True

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(label, got, want, lp):
        nonlocal ok
        torch.cuda.synchronize()
        same = bool(torch.equal(got.tokens, want.tokens))
        err = float((got.logprob - want.logprob).abs().max()) if lp else 0.0
        top = float((got.top_logprobs - want.top_logprobs).abs().max()) if lp else 0.0
        bitwise = same and (not lp or (torch.equal(got.logprob, want.logprob)
                                       and torch.equal(got.top_logprobs, want.top_logprobs)))
        good = bitwise if bitwise_only else (
            same and err <= GRAPH_CHECK_TOL and top <= GRAPH_CHECK_TOL)
        ok = ok and good
        log(f"graph {label}: tokens equal {same}, logprob max_abs_err {err:.3e}, top-20 "
            f"{top:.3e} (tol {GRAPH_CHECK_TOL}), bitwise {bitwise} {'ok' if good else 'FAIL'}")

    def snap(out):
        return type(out)(*(x.clone() for x in out))

    with torch.inference_mode():
        for lp in (False, True):
            base = engine._sampling_arrays([])
            samp = base._replace(flags=base.flags._replace(need_logprobs=lp))
            sp = engine._samp_params({k: t(v) for k, v in samp.arrays.items()}, samp.flags)
            # Prefill: a 300-token chunk over a 200-token prefix of row 0,
            # in the 512-token bucket; the pages hold the earlier serve's KV.
            n, prior = 300, 200
            T = cfg.bucket_tokens(n)
            tok = np.zeros(T, np.int64)
            tok[:n] = rng.integers(1, V, n)
            pos = np.zeros(T, np.int32)
            pos[:n] = np.arange(prior, prior + n)
            tables = np.zeros((S, PP), np.int32)
            tables[0] = rng.permutation(cfg.num_blocks)[:PP]
            cu = np.zeros(S + 1, np.int32)
            cu[1:] = n
            rb = dict(token_ids=tok, positions=pos, slot_mapping=np.full(T, -1, np.int32),
                      kv_lens=np.asarray([prior + n] + [0] * (S - 1), np.int32),
                      page_indices=tables, cu_q_lens=cu, num_seqs=np.asarray([1], np.int32))
            got = snap(engine._run_step(rb, samp))
            want = engine._step(RaggedBatch(**{k: t(v) for k, v in rb.items()}), sp)
            compare(f"step T={T} need_logprobs={lp} vs eager", got, want, lp)
            # Fused decode over every row, positions 500.., limits at the
            # positions: kv_len stays at the limit and nothing is written.
            pos0 = (500 + 97 * np.arange(S)).astype(np.int32)
            tabs = np.stack([rng.permutation(cfg.num_blocks)[:PP] for _ in range(S)]).astype(np.int32)
            tok0 = rng.integers(1, V, S).astype(np.int64)
            got = snap(engine._run_multi(tok0, pos0, tabs, pos0.copy(), samp))
            want, carry = engine._multi(t(tok0), sp.steps, engine._zero_counts, t(pos0), t(tabs),
                                        t(pos0), sp)
            compare(f"multi seeded need_logprobs={lp} vs eager", got, want, lp)
            pos0b = pos0 + T_steps
            got = snap(engine._run_multi(None, pos0b, tabs, pos0.copy(), samp))
            want, _ = engine._multi(*carry, t(pos0b), t(tabs), t(pos0), sp)
            compare(f"multi chained need_logprobs={lp} vs eager", got, want, lp)
    return ok


def main_path(torch, dev):
    """Phase 6: TorchEngine serving llama-3.1-8b after warmup, the graph
    check and the churn serve, then phase f (edge_path) on the same warm
    engine and phase g (tier_path) on its weights.  Returns (ok, launches,
    edge ok, edge numbers, tiers ok, tier numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = EngineConfig(**SERVE_CFG)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"engine: llama-3.1-8b, {engine.model_config.num_layers} layers, bf16 random "
        f"weights (seed 0), init {time.perf_counter() - t0:.1f} s, "
        f"kernels decode={engine.dispatch_summary()['decode_kernel']} "
        f"prefill={engine.dispatch_summary()['prefill_kernel']}")
    prompts = serve_prompts(torch)
    lens = [len(p) for p in prompts]
    max_tokens = SERVE_MAX_TOKENS
    out = {}

    async def run():
        try:
            t = time.perf_counter()
            out["warm"] = await engine.run_warmup()
            out["warm_s"] = time.perf_counter() - t
            zero_kernel_counts()
            t = time.perf_counter()
            results = await serve(torch, engine, prompts, max_tokens)
            out["wall"] = time.perf_counter() - t
            out["launches"] = kernel_counts()
            out["after"] = engine.compile_counts()
            out["ok"] = report_serve(torch, engine, results, out, lens)
            # Diagnostics on the warm engine, with no request in flight.
            out["ok"] = graph_check(torch, dev, engine) and out["ok"]
            out["ok"] = (await churn_path(torch, engine)) and out["ok"]
            out["ok"] = slice_counters_zero(torch, dev) and out["ok"]
            # Phase f on the same warm engine.
            out["edge_ok"], out["edge"] = await edge_path(torch, engine)
            # Phase g on engines of its own sharing this one's weights.
            out["tiers_ok"], out["tiers"] = await tier_path(torch, engine)
        finally:
            await engine.close()

    asyncio.run(run())
    ok, launches = out["ok"], out["launches"]
    # The served model's output in bf16 at full depth: finite logits of the
    # expected shape, near the dense reference's.  Random weights give a
    # flat top of the vocabulary, so bf16 rounding over 32 layers may swap
    # the top two; the top-2 gap is printed beside the drift.  The f32
    # model check (model_check) is the tight one.
    from dynamo_tpu_torch.models.llama import forward_ragged

    with torch.inference_mode():
        prompt = prompts[0][:100]
        table = list(range(cfg.max_blocks_per_seq))
        rb = one_row_batch(torch, dev, cfg.max_batch, table, prompt, 0, False)
        got = forward_ragged(engine.params, engine.model_config, rb, engine.cache)[0]
        want = reference_logits(torch, engine.params, engine.model_config, prompt)[-1]
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    cos = float(torch.nn.functional.cosine_similarity(got, want, dim=0))
    err = float((got - want).abs().max())
    top2 = want.topk(2).values
    log(f"logits bf16 {engine.model_config.num_layers} layers: shape {tuple(got.shape)} "
        f"finite={finite} cosine vs dense reference {cos:.6f} max_abs_err {err:.4f} "
        f"(reference max |x| {float(want.abs().max()):.3f}, top-2 gap "
        f"{float(top2[0] - top2[1]):.4f}) same argmax {int(got.argmax()) == int(want.argmax())}")
    ok = ok and finite and got.shape == (engine.model_config.vocab_size,) and cos > 0.99
    return ok, launches, out["edge_ok"], out["edge"], out["tiers_ok"], out["tiers"]


def slice_counters_zero(torch, dev):
    """The prefill kernel's self-resetting arrival counters: one scratch a
    stream, shared by every graph captured on that stream.  After the
    serve's, the graph check's and the churn's replays (mixed steps among
    them) every counter must be back at zero.  Returns ok."""
    from dynamo_tpu_torch.ops import prefill_attention as pa

    torch.cuda.synchronize(dev)
    left = [int(cnt.count_nonzero()) for _, _, cnt in pa._slice_scratch.values()]
    ok = bool(left) and not any(left)
    log(f"prefill slice counters after the replays: {len(left)} scratch buffers, "
        f"nonzero counters {left} {'ok' if ok else 'FAIL'}")
    return ok


def report_serve(torch, engine, results, out, lens):
    """Print phase 6's serve line and the warmup line; returns whether
    every stream is whole, both kernels ran and no graph was captured."""
    cfg = engine.cfg
    max_tokens = SERVE_MAX_TOKENS
    launches, wall = out["launches"], out["wall"]
    per_graph = {name: {str(k): v for k, v in getattr(engine.programs, name)
                        .captured_launches().items()} for name in ("step", "multi")}
    log(f"warmup: {out['warm_s']:.2f} s, graphs per entry {out['warm']} (buckets "
        f"{engine.reachable_token_buckets()}); kernel launches a replay, by key {per_graph}")
    ok = out["after"] == out["warm"]
    if not ok:
        log(f"compile counts grew during the serve: {out['warm']} -> {out['after']} — FAIL")
    for i, (toks, stamps, finish) in enumerate(results):
        good = len(toks) == max_tokens and finish == "length"
        ok = ok and good
        if not good:
            log(f"request {i}: {len(toks)} tokens, finish {finish!r} — FAIL")
    ttft = sorted(s[0] for _, s, _ in results)
    itl = [(s[-1] - s[0]) / (len(s) - 1) for _, s, _ in results if len(s) > 1]
    total = sum(len(t) for t, _, _ in results)
    dec, pre = engine.decode_spans, engine.prefill_spans
    step_ms = dec.seconds / max(1, dec.count * cfg.decode_steps) * 1e3
    chunk_ms = pre.seconds / max(1, pre.count) * 1e3
    summ = engine.dispatch_summary()
    kinds = {k: (v["dispatches"], v["p50_ms"]) for k, v in summ["kinds"].items()}
    pipe = {k: v for k, v in summ["pipeline"].items() if k != "last_stall"}
    log(f"serve: 8 requests, prompts {lens[0]}..{lens[-1]} tokens, {max_tokens} new each, "
        f"wall {wall:.3f} s, {total / wall:.2f} output tok/s; TTFT p50 "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms; ITL mean "
        f"{sum(itl) / len(itl) * 1e3:.2f} ms; decode dispatches {dec.count} at "
        f"{step_ms:.2f} ms a fused step, prefill steps {pre.count} at {chunk_ms:.2f} ms "
        f"each (stream time); host_gap_frac {pipe['host_gap_frac']}; pipeline {pipe}; "
        f"dispatch kinds (count, p50 ms) {kinds}; launches {launches} (per replay); "
        f"graphs {out['after']}")
    return ok and all(v > 0 for v in launches.values())


CHURN_REQUESTS = 16


async def churn_path(torch, engine):
    """The churn serve on the warm phase-6 engine: 16 greedy requests at
    max_batch 16, prompts 128..848 tokens; the first 8 (48 or 64 new
    tokens) start together, the back 8 (8, 16 or 24 new tokens) are sent
    once a fused session is live.  Every stream must have its length and
    finish ``length``; the engine must admit and retire inside the loop
    with no rebuild, and capture no graph.  Returns ok."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    rng = torch.Generator().manual_seed(13)
    prompts = [torch.randint(1, 128000, (128 + 48 * i,), generator=rng).tolist()
               for i in range(CHURN_REQUESTS)]
    half = CHURN_REQUESTS // 2
    osl = [48 + 16 * (i % 2) if i < half else 8 + 8 * (i % 3) for i in range(CHURN_REQUESTS)]

    async def one(i):
        if i >= half:
            while not engine._pipeline_members:  # land inside a live session
                await asyncio.sleep(0.001)
        req = PreprocessedRequest(
            token_ids=prompts[i],
            stop_conditions=StopConditions(max_tokens=osl[i], ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
        ).to_dict()
        toks, finish = [], None
        async for item in await engine.generate(Context(req)):
            toks += item["token_ids"]
            finish = item.get("finish_reason") or finish
        return toks, finish

    async def run():
        before = engine.compile_counts()
        engine.reset_dispatch_stats()
        zero_kernel_counts()
        t = time.perf_counter()
        results = await asyncio.gather(*(one(i) for i in range(CHURN_REQUESTS)))
        return results, time.perf_counter() - t, kernel_counts(), before, engine.compile_counts()

    results, wall, launches, before, after = await run()
    pipe = engine.dispatch_summary()["pipeline"]
    ok = all(len(t) == n and f == "length" for (t, f), n in zip(results, osl))
    ok = ok and pipe["continuous_admissions"] >= 1 and pipe["continuous_retired"] >= 1
    ok = ok and pipe["rebuilds"] == 0 and after == before and all(v > 0 for v in launches.values())
    log(f"churn: {CHURN_REQUESTS} requests at max_batch {engine.cfg.max_batch}, prompts "
        f"{len(prompts[0])}..{len(prompts[-1])} tokens, new tokens {osl}, back half sent into a "
        f"live session; wall {wall:.3f} s; lengths {[len(t) for t, _ in results]} finishes "
        f"{sorted(set(f for _, f in results))}; admissions {pipe['continuous_admissions']} retired "
        f"{pipe['continuous_retired']} rebuilds {pipe['rebuilds']} sessions {pipe['sessions']} "
        f"host_gap_frac {pipe['host_gap_frac']}; graphs {before} -> {after}; launches {launches} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


# ------------------------------------------------------------ the HTTP path

HTTP_MODEL = "llama-3.1-8b"
HTTP_ARGV = [
    "run", "in=http", "out=torch", "--arch", "llama-3.1-8b", "--dtype", "bfloat16",
    "--block-size", "16", "--num-blocks", "2048", "--max-batch", "16", "--max-model-len", "4096",
    "--prefill-chunk", "512", "--decode-steps", "8", "--port", "0", "--model", HTTP_MODEL,
]
CHAT_BODY = {
    "model": HTTP_MODEL, "max_tokens": 16, "temperature": 0,
    "messages": [{"role": "user", "content": "Name three colours of the sea."}],
}


class CliServer:
    """``cli._run`` of the port on an event loop in a thread of this
    process, so this process's kernel launch counters see its work.  The
    engine the CLI builds is kept (``engine``) so it can be warmed, and so
    is the tokenizer its spec made (``tokenizer``); at more than one rank
    this process is the leader and ``ranks`` the node's started ranks."""

    def __init__(self, argv, timeout=900):
        from dynamo_tpu_torch import cli

        args = cli.parse_args(argv)
        ready = concurrent.futures.Future()
        self.loop = asyncio.new_event_loop()
        self.engine = self.ranks = self.tokenizer = None
        build, start, make_tokenizer = cli._build_engine, cli.start_ranks, cli.make_tokenizer

        def keep(out, a):
            engine, level = build(out, a)
            self.engine = engine
            return engine, level

        async def keep_ranks(a, b):
            self.engine, self.ranks = await start(a, b)
            return self.engine, self.ranks

        def keep_tokenizer(spec):
            self.tokenizer = make_tokenizer(spec)
            return self.tokenizer

        cli._build_engine = keep
        cli.start_ranks = keep_ranks
        cli.make_tokenizer = keep_tokenizer

        async def run():
            try:
                await cli._run(args, on_serving=ready.set_result)
            except BaseException as e:
                if not ready.done():
                    ready.set_exception(e)
                raise

        self.task = self.loop.create_task(run())

        def drive():
            try:
                self.loop.run_until_complete(self.task)
            except BaseException:  # the task's outcome is read by stop()
                pass

        self.thread = threading.Thread(target=drive, name="cli-server", daemon=True)
        self.thread.start()
        try:
            self.service = ready.result(timeout=timeout)
        finally:
            cli._build_engine, cli.start_ranks = build, start
            cli.make_tokenizer = make_tokenizer

    def warmup(self):
        """The engine's ``run_warmup`` on the server's loop; returns its
        compile counts."""
        return asyncio.run_coroutine_threadsafe(self.engine.run_warmup(), self.loop).result(900)

    def stop(self):
        """Cancel the server (it closes its service and engine) and raise
        whatever else ended it."""
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(120)
        if self.thread.is_alive():
            raise RuntimeError("the HTTP server did not stop")
        self.loop.close()
        if not self.task.cancelled() and self.task.exception() is not None:
            raise self.task.exception()


async def http_call(port, method, path, body=None, headers=None, on_event=None):
    """One HTTP/1.1 request over a fresh connection (standard library
    only), with extra request ``headers``.  Returns (status, headers, body
    bytes, SSE events) with each SSE event stamped on arrival, in seconds
    after the request was sent; ``on_event(t, event)`` sees each as it
    arrives."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    head = (f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n{extra}"
            f"Content-Type: application/json\r\nContent-Length: {len(payload)}\r\n\r\n")
    t0 = time.perf_counter()
    try:
        writer.write(head.encode() + payload)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        headers = {}
        while True:
            line = (await reader.readline()).decode("latin-1").strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        data, events, pending = b"", [], b""
        if headers.get("transfer-encoding") == "chunked":
            while True:
                size = int((await reader.readline()).strip(), 16)
                if size == 0:
                    await reader.readline()
                    break
                part = await reader.readexactly(size)
                await reader.readexactly(2)
                now = time.perf_counter() - t0
                data += part
                pending += part
                while b"\n\n" in pending:
                    ev, pending = pending.split(b"\n\n", 1)
                    events.append((now, ev.decode()))
                    if on_event is not None:
                        on_event(now, events[-1][1])
        else:
            data = await reader.readexactly(int(headers.get("content-length", "0")))
        return status, headers, data, events
    finally:
        writer.close()
        await writer.wait_closed()


def parse_prometheus(text):
    """Samples of a Prometheus text exposition: {(name, ((label, value), ...)):
    value}.  Raises ValueError on a line that is not a comment or a sample."""
    sample = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = sample.fullmatch(line)
        if m is None:
            raise ValueError(f"not a sample line: {line!r}")
        labels, rest = [], m.group(3) or ""
        while rest:
            lm = label.match(rest)
            if lm is None:
                raise ValueError(f"bad labels in {line!r}")
            labels.append((lm.group(1), lm.group(2)))
            rest = rest[lm.end():]
        out[(m.group(1), tuple(sorted(labels)))] = float(m.group(4))
    return out


def sse_data(events):
    """The JSON chunks of an SSE stream and whether it ended with [DONE];
    raises ValueError on an event that is not a data line of JSON."""
    chunks, done = [], False
    for t, ev in events:
        if not ev.startswith("data: "):
            raise ValueError(f"unexpected SSE event {ev[:80]!r}")
        data = ev[len("data: "):]
        if data == "[DONE]":
            done = True
            continue
        chunks.append((t, json.loads(data)))
    return chunks, done


def http_path(torch):
    """Phase 7: llama-3.1-8b served over HTTP by ``run in=http out=torch``.
    Returns (ok, launches, numbers)."""
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    fails = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"http check FAILED: {what}")

    t0 = time.perf_counter()
    server = CliServer(HTTP_ARGV)
    port = server.service.port
    log(f"http: server up on port {port} in {time.perf_counter() - t0:.1f} s "
        f"({' '.join(HTTP_ARGV)})")
    t0 = time.perf_counter()
    warm = server.warmup()
    log(f"http: engine warmed in {time.perf_counter() - t0:.1f} s, graphs {warm}")
    prompts = serve_prompts(torch)
    out = {}

    async def phase():
        st, _, body, _ = await http_call(port, "GET", "/v1/models")
        check(st == 200 and [m["id"] for m in json.loads(body)["data"]] == [HTTP_MODEL],
              f"/v1/models lists {HTTP_MODEL} ({st} {body[:200]!r})")
        st, _, body, _ = await http_call(port, "GET", "/health")
        check(st == 200, f"/health 200 ({st})")

        async def complete(p):
            return await http_call(port, "POST", "/v1/completions", {
                "model": HTTP_MODEL, "prompt": p, "max_tokens": SERVE_MAX_TOKENS,
                "temperature": 0, "stream": True, "nvext": {"ignore_eos": True}})

        da.decode_attention_cuda.launches = 0
        pa.prefill_attention_cuda.launches = 0
        t = time.perf_counter()
        results = await asyncio.gather(*(complete(p) for p in prompts))
        out["wall"] = time.perf_counter() - t
        ttft, itl, n_chunks = [], [], []
        for i, (st, headers, _, events) in enumerate(results):
            check(st == 200 and headers.get("content-type") == "text/event-stream",
                  f"request {i}: 200 text/event-stream ({st}, {headers.get('content-type')})")
            try:
                chunks, done = sse_data(events)
            except ValueError as e:
                check(False, f"request {i}: every chunk is JSON ({e})")
                continue
            check(done, f"request {i}: stream ends with data: [DONE]")
            final = chunks[-1][1] if chunks else {}
            fin = (final.get("choices") or [{}])[0].get("finish_reason")
            used = (final.get("usage") or {}).get("completion_tokens")
            check(fin == "length" and used == SERVE_MAX_TOKENS,
                  f"request {i}: final chunk length/{SERVE_MAX_TOKENS} (got {fin}/{used})")
            content = [t for t, c in chunks if c["choices"] and c["choices"][0]["text"]]
            if content:
                ttft.append(content[0])
                itl.append((chunks[-1][0] - content[0]) / (SERVE_MAX_TOKENS - 1))
                n_chunks.append(len(content))
                out.setdefault("stamps", []).append((content[0], chunks[-1][0]))
        out.update(ttft=sorted(ttft), itl=itl, chunks=n_chunks)

        # One chat request, alone: first to warm the prompt's prefix cache,
        # then unary and streamed, both over the same cached prefix.
        texts = {}
        for label, stream in (("warm", True), ("unary", False), ("stream", True)):
            st, _, body, events = await http_call(
                port, "POST", "/v1/chat/completions", dict(CHAT_BODY, stream=stream))
            check(st == 200, f"chat {label}: 200 ({st} {body[:200]!r})")
            if st != 200:
                continue
            if stream:
                chunks, done = sse_data(events)
                check(done, f"chat {label}: ends with [DONE]")
                texts[label] = "".join(c["choices"][0]["delta"].get("content") or ""
                                       for _, c in chunks if c["choices"])
            else:
                texts[label] = json.loads(body)["choices"][0]["message"]["content"]
        out["chat"] = texts
        check(texts.get("unary") is not None and texts.get("unary") == texts.get("stream"),
              f"chat unary text == streamed deltas ({texts.get('unary')!r} vs "
              f"{texts.get('stream')!r})")

        st, _, body, _ = await http_call(port, "POST", "/v1/completions",
                                         {"model": "no-such-model", "prompt": [1, 2, 3]})
        err = json.loads(body).get("error", {}) if body else {}
        check(st == 404 and err.get("code") == "model_not_found",
              f"unknown model: 404 model_not_found ({st} {body[:200]!r})")

        st, _, body, _ = await http_call(port, "GET", "/metrics")
        try:
            samples = parse_prometheus(body.decode())
        except ValueError as e:
            check(False, f"/metrics parses as Prometheus text ({e})")
            samples = {}

        def total(name, **want):
            return sum(v for (n, labels), v in samples.items()
                       if n == name and all(dict(labels).get(k) == w for k, w in want.items()))

        ns = "dynamo_tpu_http_service"
        got = total(f"{ns}_requests_total", model=HTTP_MODEL, endpoint="completions",
                    request_type="stream", status="success")
        check(got == len(prompts), f"/metrics counts {len(prompts)} streamed completions ({got})")
        got = total(f"{ns}_requests_total", model=HTTP_MODEL, endpoint="chat_completions",
                    status="success")
        check(got == 3, f"/metrics counts 3 chat requests ({got})")
        got = total(f"{ns}_time_to_first_token_seconds_count", model=HTTP_MODEL)
        check(got >= len(prompts), f"/metrics has {ns}_time_to_first_token_seconds ({got})")
        got = total("dynamo_tpu_engine_dispatch_pipeline_sessions_total")
        check(got >= 1, f"/metrics has the engine's fused sessions ({got})")
        out["host_gap_frac"] = total("dynamo_tpu_engine_dispatch_host_gap_frac")

    try:
        asyncio.run(phase())
    finally:
        launches = {
            "decode_attention": da.decode_attention_cuda.launches,
            "prefill_attention": pa.prefill_attention_cuda.launches,
        }
        server.stop()
    check(all(v > 0 for v in launches.values()), f"both kernels launched ({launches})")
    ttft, itl = out.get("ttft") or [float("nan")], out.get("itl") or [float("nan")]
    total_tokens = len(prompts) * SERVE_MAX_TOKENS
    out.update(ttft_p50_ms=ttft[len(ttft) // 2] * 1e3, ttft_max_ms=ttft[-1] * 1e3,
               itl_mean_ms=sum(itl) / len(itl) * 1e3,
               tok_s=total_tokens / out["wall"] if "wall" in out else float("nan"))
    log(f"http: {len(prompts)} streamed /v1/completions, prompts {len(prompts[0])}.."
        f"{len(prompts[-1])} tokens as ids, {SERVE_MAX_TOKENS} new each, wall "
        f"{out.get('wall', float('nan')):.3f} s, {out['tok_s']:.2f} output tok/s; TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms max {out['ttft_max_ms']:.1f} ms (request sent -> first "
        f"SSE content chunk); ITL mean {out['itl_mean_ms']:.2f} ms (finish chunk - first content "
        f"chunk, over {SERVE_MAX_TOKENS - 1}); SSE content chunks a request "
        f"{out.get('chunks')}; chat unary/stream {out.get('chat', {}).get('unary')!r} / "
        f"{out.get('chat', {}).get('stream')!r} (cold first run "
        f"{out.get('chat', {}).get('warm')!r}); launches {launches}; host_gap_frac "
        f"{out.get('host_gap_frac')} (/metrics); host clock, one call")
    return not fails, launches, out


# ---------------------------------------------- f. the serving edge's overload plane

EDGE_MODEL = "llama-3.1-8b"
EDGE_BURST, EDGE_ISL, EDGE_OSL = 12, 512, 64
EDGE_INFLIGHT, EDGE_QUEUE, EDGE_QUEUE_TIMEOUT_S = 4, 2, 30.0
EDGE_DEADLINE_S, EDGE_DEADLINE_TOKENS = 0.5, 2048
EDGE_TRACED, EDGE_TRACED_ISL, EDGE_TRACED_OSL = 4, 2048, 16
EDGE_TTFT_TOL = 0.10
EDGE_PASSES = ("warm", "none", "all", "all", "none")


def edge_prompts(torch, vocab, lens, seed):
    """Random prompt ids below the vocabulary, one per length (seeded)."""
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(1, min(128000, vocab), (n,), generator=rng).tolist() for n in lens]


class _Recorder:
    """The engine under the HTTP pipeline, recording the token ids each
    request's stream carried, keyed by its request id."""

    def __init__(self, engine):
        self.engine = engine
        self.streams = {}

    async def generate(self, request):
        from dynamo_tpu_torch.runtime.engine import ResponseStream

        stream = await self.engine.generate(request)
        toks = self.streams.setdefault(request.id, [])

        async def gen():
            try:
                async for item in stream:
                    toks.extend(item.get("token_ids") or ())
                    yield item
            finally:
                await stream.aclose()

        return ResponseStream(gen(), request.ctx)


async def edge_path(torch, engine):
    """Phase f: the port's HttpService → preprocessor → backend on the warm
    phase-6 engine, three services on free ports sharing one pipeline:
    admission control, per-request deadlines, QoS quotas with the brownout
    ladder, and request tracing with /traces.  Every check fails the phase.
    Returns (ok, numbers)."""
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.qos import BrownoutConfig, QosConfig, QosController
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.llm.trace_service import TraceAggregator
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline
    from dynamo_tpu_torch.runtime.resilience import metrics as resilience_metrics
    from dynamo_tpu_torch.runtime.engine import AsyncEngineContext
    from dynamo_tpu_torch.runtime.resilience import Deadline
    from dynamo_tpu_torch.runtime.tracing import SpanExporter, TraceSampler, TracingConfig, _wall_ms

    fails, out = [], {}
    vocab = engine.model_config.vocab_size

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"edge check FAILED: {what}")

    tok = ByteTokenizer()
    recorder = _Recorder(engine)
    pipeline = build_pipeline([OpenAIPreprocessor(tok, EDGE_MODEL), Backend(tok)], recorder)
    aggregator = TraceAggregator()
    exporter = await SpanExporter([aggregator], interval_s=0.05).start()
    qos = QosController(QosConfig(rate=1.0, burst=2.0, brownout=BrownoutConfig()))
    kv_seen = []  # what the ladder read, tick by tick, over the whole phase

    def kv_usage():
        kv_seen.append(engine.metrics().gpu_cache_usage_perc)
        return kv_seen[-1]

    services = {
        "admission": HttpService(host="127.0.0.1", port=0, max_inflight=EDGE_INFLIGHT,
                                 admission_queue=EDGE_QUEUE,
                                 admission_timeout_s=EDGE_QUEUE_TIMEOUT_S),
        "qos": HttpService(host="127.0.0.1", port=0, qos=qos, kv_usage_fn=kv_usage),
        "tracing": HttpService(host="127.0.0.1", port=0, tracing=TraceSampler(TracingConfig()),
                               trace_aggregator=aggregator),
    }
    for svc in services.values():
        svc.models.add_completion_model(EDGE_MODEL, pipeline)
        await svc.start()
    port = {k: svc.port for k, svc in services.items()}

    def completion(prompt, max_tokens, **kw):
        return dict(model=EDGE_MODEL, prompt=prompt, max_tokens=max_tokens, temperature=0,
                    stream=True, nvext={"ignore_eos": True}, **kw)

    def whole(result, max_tokens):
        st, _, _, events = result
        try:
            chunks, done = sse_data(events)
        except ValueError:
            return False
        final = chunks[-1][1] if chunks else {}
        return (st == 200 and done and (final.get("usage") or {}).get("completion_tokens")
                == max_tokens and final["choices"][0].get("finish_reason") == "length")

    def metric(name, **want):
        samples = parse_prometheus(out["metrics_text"])
        return sum(v for (n, labels), v in samples.items()
                   if n == name and all(dict(labels).get(k) == w for k, w in want.items()))

    async def get_trace(tid):
        """/traces/{tid} once the exporter has delivered its edge span."""
        trace = {}
        for _ in range(200):
            await exporter.flush()
            st, _, body, _ = await http_call(port["tracing"], "GET", f"/traces/{tid}")
            trace = json.loads(body) if st == 200 else {}
            if any(s["name"] == "edge.request" for s in trace.get("spans", ())):
                break
            await asyncio.sleep(0.01)
        return trace

    t_phase = time.perf_counter()
    zero_kernel_counts()
    try:
        # Admission: 4 in flight, 2 queued, the other 6 shed with 429.
        shed0 = resilience_metrics.admission_shed.get("429", 0)
        burst = edge_prompts(torch, vocab, [EDGE_ISL] * EDGE_BURST, 9001)
        t = time.perf_counter()
        results = await asyncio.gather(*(
            http_call(port["admission"], "POST", "/v1/completions", completion(p, EDGE_OSL))
            for p in burst))
        out["burst_wall_s"] = time.perf_counter() - t
        served = [r for r in results if whole(r, EDGE_OSL)]
        shed = [r for r in results if r[0] == 429 and r[1].get("retry-after")
                and b"admission queue full" in r[2]]
        check(len(served) == EDGE_INFLIGHT + EDGE_QUEUE and len(shed) == EDGE_BURST - len(served),
              f"admission: {EDGE_INFLIGHT + EDGE_QUEUE} whole streams and "
              f"{EDGE_BURST - EDGE_INFLIGHT - EDGE_QUEUE} 429s with Retry-After "
              f"(statuses {sorted(r[0] for r in results)}, whole {len(served)})")
        out["metrics_text"] = (await http_call(port["admission"], "GET", "/metrics"))[2].decode()
        counted = metric("dynamo_tpu_resilience_admission_shed_total", status="429") - shed0
        check(counted == len(shed), f"/metrics admission_shed_total{{status=\"429\"}} counts "
                                    f"{len(shed)} ({counted})")
        out["admission"] = {"statuses": sorted(r[0] for r in results), "whole": len(served),
                            "retry_after": sorted({r[1].get("retry-after") for r in shed}),
                            "counted": counted}

        # Deadlines: a long traced stream cut at 0.5 s ends in the SSE 504
        # event.  No fused dispatch takes its row once the edge has stopped
        # it (its trace's decode-chunk spans all start before), the edge
        # stops it within a dispatch period of its deadline, and at most one
        # dispatch starts between the two: the edge's deadline is a timer on
        # the event loop (in both packages), which runs it at the loop's next
        # turn, so a dispatch formed in the loop's current turn can start
        # after the instant.  Both instants are the harness's reads of
        # ``Deadline.after`` and the context's ``stop_generating`` for this
        # request, on the spans' clock (the deadline is set after admission,
        # so the request's start is not its origin).  None runs at all after
        # the event.  The row leaves once the dispatches
        # already in flight have landed (its KV blocks are held until then:
        # the pipeline's write barrier): they land within pipeline_depth
        # dispatch periods (an event recorded behind them on the stream),
        # and the row is gone within half a period after, before another
        # dispatch could have run.  The period is read off this stream: one
        # SSE chunk a fused dispatch, the longest gap between two of its
        # chunks after the first.
        (prompt,) = edge_prompts(torch, vocab, [EDGE_ISL], 9002)
        d_start = engine.decode_spans.count
        instants = {}
        real_after, real_stop = Deadline.__dict__["after"], AsyncEngineContext.stop_generating

        def after(cls, seconds):
            instants.setdefault("expire", time.perf_counter() + seconds)
            return real_after.__func__(cls, seconds)

        def stop_generating(ctx):
            if ctx.id.startswith("deadline-"):
                instants.setdefault("stop", time.perf_counter())
            real_stop(ctx)

        Deadline.after, AsyncEngineContext.stop_generating = classmethod(after), stop_generating
        try:
            st, headers, _, events = await http_call(
                port["tracing"], "POST", "/v1/completions",
                completion(prompt, EDGE_DEADLINE_TOKENS),
                headers={"x-deadline-s": str(EDGE_DEADLINE_S), "x-request-id": "deadline",
                         "x-trace": "1"})
        finally:
            Deadline.after, AsyncEngineContext.stop_generating = real_after, real_stop
        t_end, d_end = time.perf_counter(), engine.decode_spans.count
        # The engine's dispatches replay on the default stream; on the CPU
        # (a rehearsal) they have run when they return.
        landed = torch.cuda.Event() if engine.device.type == "cuda" else None
        if landed is not None:
            landed.record()
        t_landed = None
        sched = engine.scheduler
        while True:  # landing is read first: one poll may see both
            now = time.perf_counter()
            if t_landed is None and (landed is None or landed.query()):
                t_landed = now
            if not (sched.num_running or sched.num_waiting) or now - t_end >= 10:
                break
            await asyncio.sleep(0.001)
        t_left = time.perf_counter()
        if t_landed is None:  # the row left first: the check below fails
            if landed is not None:
                landed.synchronize()
            t_landed = time.perf_counter()
        left_ms, landed_ms = (t_left - t_end) * 1e3, (t_landed - t_end) * 1e3
        extra = engine.decode_spans.count - d_end
        last = events[-1][1].split("\n") if events else []
        err = json.loads(last[1][len("data: "):]) if len(last) == 2 else None
        check(st == 200 and last[:1] == ["event: error"]
              and err == {"error": "deadline exceeded", "code": 504},
              f"deadline: the stream ends in the SSE 504 event ({st}, {last})")
        spans = (await get_trace(headers.get("x-trace-id"))).get("spans", [])
        root = next((s["start_ms"] for s in spans if s["name"] == "edge.request"), None)
        chunks_ms = [s["start_ms"] - root for s in spans
                     if s["name"] == "engine.decode_chunk" and root is not None]
        expire_ms, stop_ms = (_wall_ms(instants[k]) - root if k in instants and root is not None
                              else float("nan") for k in ("expire", "stop"))
        late = [c for c in chunks_ms if not c < stop_ms]
        between = [c for c in chunks_ms if c >= expire_ms]
        data_t = [t for t, ev in events if ev.startswith("data: ")]
        gaps_ms = [(b - a) * 1e3 for a, b in zip(data_t[1:], data_t[2:])]
        period_ms = max(gaps_ms) if gaps_ms else float("nan")
        depth = engine.cfg.pipeline_depth
        check(len(chunks_ms) >= 2 and not late and len(between) <= 1
              and 0 <= stop_ms - expire_ms <= period_ms,
              f"deadline: no fused dispatch takes the row after the edge stopped it, the stop "
              f"within a period of {period_ms:.1f} ms of the deadline, at most one dispatch "
              f"between (decode chunks at {[round(c, 1) for c in chunks_ms]} ms after the "
              f"request; deadline at {expire_ms:.1f} ms, stopped at {stop_ms:.1f} ms)")
        check(len(gaps_ms) >= 2 and not sched.num_running and not sched.num_waiting
              and extra == 0 and landed_ms <= depth * period_ms
              and 0 <= left_ms - landed_ms <= period_ms / 2 and engine.kv.active_blocks == 0,
              f"deadline: no fused dispatch after the 504 event, the dispatches in flight "
              f"landed within pipeline_depth {depth} periods of {period_ms:.1f} ms and the "
              f"row gone within half a period after ({extra} dispatches, landed "
              f"{landed_ms:.1f} ms, gone {left_ms:.1f} ms, running {sched.num_running}, "
              f"active blocks {engine.kv.active_blocks})")
        tokens = sum(len(v) for k, v in recorder.streams.items() if k.startswith("deadline-"))
        out["deadline"] = {"events": len(events), "dispatches": d_end - d_start,
                           "tokens": tokens, "decode_chunks_ms": [round(c, 3) for c in chunks_ms],
                           "deadline_ms": expire_ms, "stopped_ms": stop_ms,
                           "chunk_gaps_ms": [round(g, 3) for g in gaps_ms],
                           "extra_dispatches": extra, "landed_after_ms": landed_ms,
                           "empty_after_ms": left_ms, "bound_ms": depth * period_ms}

        # QoS: rate 1, burst 2 under one tenant; the ladder ticks off the
        # engine's live KV usage.
        short = edge_prompts(torch, vocab, [16], 9003)[0]
        quota = []
        for _ in range(3):
            quota.append(await http_call(port["qos"], "POST", "/v1/completions",
                                         dict(model=EDGE_MODEL, prompt=short, max_tokens=1),
                                         headers={"x-tenant": "edge-qos"}))
        check([r[0] for r in quota] == [200, 200, 429] and quota[2][1].get("retry-after")
              and b"over its request quota" in quota[2][2],
              f"qos: 200, 200, 429 quota with Retry-After ({[r[0] for r in quota]} "
              f"{quota[2][2][:120]!r})")
        ticks0 = qos.ladder.tick_count
        rungs = [services["qos"].qos_tick() for _ in range(3)]
        health = json.loads((await http_call(port["qos"], "GET", "/health"))[2])
        check(rungs == [0, 0, 0] and qos.ladder.tick_count >= ticks0 + 3
              and len(kv_seen) == qos.ladder.tick_count
              and health.get("brownout", {}).get("rung") == 0,
              f"qos: the ladder ticks off the live KV usage ({rungs}, {len(kv_seen)} reads, "
              f"{health.get('brownout')})")
        out["metrics_text"] = (await http_call(port["qos"], "GET", "/metrics"))[2].decode()
        check(metric("dynamo_tpu_qos_quota_shed_total") >= 1, "qos: /metrics counts the quota shed")
        out["qos"] = {"statuses": [r[0] for r in quota], "retry_after": quota[2][1].get("retry-after"),
                      "kv_usage_max": max(kv_seen), "ticks": qos.ladder.tick_count,
                      "rung": qos.ladder.rung}

        # Tracing: 4 traced requests of 2048 ids; each asks for logprobs, so
        # the chunk of its first token reaches the client even where the
        # byte tokenizer holds the text back.  Warmed first untraced.
        def traced_body(p):
            return completion(p, EDGE_TRACED_OSL, logprobs=1)

        for seed, headers in ((9004, None), (9005, {"x-trace": "1"})):
            prompts = edge_prompts(torch, vocab, [EDGE_TRACED_ISL] * EDGE_TRACED, seed)
            traced = await asyncio.gather(*(
                http_call(port["tracing"], "POST", "/v1/completions", traced_body(p),
                          headers=headers) for p in prompts))
        out["traces"] = []
        for st, headers, _, events in traced:
            tid = headers.get("x-trace-id")
            check(st == 200 and tid and whole((st, headers, None, events), EDGE_TRACED_OSL),
                  f"tracing: a whole traced stream with x-trace-id ({st}, {tid})")
            if not tid:
                continue
            client_ttft_ms = events[0][0] * 1e3
            trace = await get_trace(tid)
            spans = trace.get("spans", [])
            names = [s["name"] for s in spans]
            order = ["edge.request", "edge.admission_wait", "edge.preprocess",
                     "engine.queue_wait", "engine.prefill"]
            starts = [next((s["start_ms"] for s in spans if s["name"] == n), None) for n in order]
            prefill = next((s for s in spans if s["name"] == "engine.prefill"), {})
            rollup = trace.get("rollup", {})
            terms = sum(rollup.get("hops", {}).values()) + rollup.get("unattributed_ms", 0.0)
            check(None not in starts and starts == sorted(starts)
                  and any(e["name"] == "first_token" for e in prefill.get("events", ()))
                  and names.count("engine.decode_chunk") >= 1,
                  f"tracing: /traces/{tid} holds the edge, preprocess, queue-wait, prefill "
                  f"(first_token) and decode-chunk spans in order ({names})")
            check(abs(terms - client_ttft_ms) <= EDGE_TTFT_TOL * client_ttft_ms,
                  f"tracing: ttft_decomposition's terms {terms:.3f} ms within "
                  f"{EDGE_TTFT_TOL:.0%} of the client's TTFT {client_ttft_ms:.3f} ms")
            out["traces"].append({"client_ttft_ms": round(client_ttft_ms, 3),
                                  "terms_ms": round(terms, 3), "rollup": rollup,
                                  "decode_chunks": names.count("engine.decode_chunk"),
                                  "spans": len(spans)})

        # Tracing on and off: 8 greedy requests a pass, identical streams, no
        # graph captured.  The first pass, concurrent, only fills the prefix
        # cache; the measured passes send one request at a time, so every
        # pass runs the same steps: a position's logits on the card depend on
        # the rows that share its step (GEMM kernels are chosen by row
        # count), and a random model's flat top tokens follow them.
        prompts = edge_prompts(torch, vocab, [512 + 219 * i for i in range(8)], 9006)
        passes, graphs0 = [], None
        for p_i, mode in enumerate(EDGE_PASSES):
            if p_i == 1:
                graphs0 = dict(engine.compile_counts())
            headers = {"x-trace": "1"} if mode == "all" else {}
            calls = [http_call(port["tracing"], "POST", "/v1/completions",
                               completion(p, EDGE_OSL),
                               headers=dict(headers, **{"x-request-id": f"p{p_i}r{i}"}))
                     for i, p in enumerate(prompts)]
            if mode == "warm":
                await asyncio.gather(*calls)
                continue
            results = [await c for c in calls]
            ttft, itl = [], []
            for st, headers_, _, events in results:
                check(whole((st, headers_, None, events), EDGE_OSL)
                      and ("x-trace-id" in headers_) == (mode == "all"),
                      f"tracing {mode}: a whole stream, x-trace-id only when traced ({st})")
                chunks, _ = sse_data(events)
                ttft.append(chunks[0][0])
                itl.append((chunks[-1][0] - chunks[0][0]) / (EDGE_OSL - 1))
            streams = [recorder.streams[k] for i in range(len(prompts)) for k in recorder.streams
                       if k.startswith(f"p{p_i}r{i}-")]
            passes.append({"mode": mode, "streams": streams,
                           "ttft_p50_ms": statistics.median(ttft) * 1e3,
                           "itl_p50_ms": statistics.median(itl) * 1e3})
        graphs1 = dict(engine.compile_counts())
        same = all(p["streams"] == passes[0]["streams"] for p in passes)
        differ = [sum(a != b for a, b in zip(p["streams"], passes[0]["streams"]))
                  for p in passes]
        check(same and all(len(s) == EDGE_OSL for s in passes[0]["streams"])
              and len(passes[0]["streams"]) == len(prompts),
              f"tracing on/off: identical greedy streams in every pass (streams differing "
              f"from the first measured pass, by pass: {differ})")
        check(graphs1 == graphs0, f"tracing on/off: no graph captured ({graphs0} -> {graphs1})")
        out["passes"] = [{k: v for k, v in p.items() if k != "streams"} for p in passes]
    finally:
        out["launches"] = kernel_counts()
        await exporter.stop(final_flush=False)
        await aggregator.stop()
        for svc in services.values():
            await svc.close()
    out["wall_s"] = time.perf_counter() - t_phase
    check(all(v > 0 for v in out["launches"].values()), f"edge: both kernels launched "
                                                        f"({out['launches']})")
    med = {mode: [p for p in out.get("passes", []) if p["mode"] == mode]
           for mode in ("none", "all")}
    log(f"edge (phase f, card {CARD}): admission {out.get('admission')}; deadline "
        f"{out.get('deadline')}; qos {out.get('qos')}; traces {out.get('traces')}")
    log(f"edge tracing overhead (card {CARD}; 8 greedy streams of {EDGE_OSL} a pass, one at a "
        f"time, prompts 512..2045, prefix-cached; client clock, one call): " + "; ".join(
            f"{mode} TTFT p50 {[round(p['ttft_p50_ms'], 3) for p in ps]} ms ITL p50 "
            f"{[round(p['itl_p50_ms'], 3) for p in ps]} ms" for mode, ps in med.items())
        + f"; phase wall {out['wall_s']:.2f} s; launches {out['launches']} "
        f"{'ok' if not fails else 'FAIL: ' + '; '.join(fails)}")
    return not fails, out


# ------------------------------------------------------- phase g: KV tiers

# Phase 6's geometry on a 512-page pool (1 GiB at llama-3.1-8b: a 16-token
# page is 2 MiB over 32 layers) with the three tiers below it.
TIER_CFG = dict(SERVE_CFG, num_blocks=512, host_cache_bytes=1024 << 20,
                disk_cache_bytes=1024 << 20, object_store_bytes=2048 << 20)
TIER_PROMPTS, TIER_LEN, TIER_NEW = 12, 2056, 16  # 128 full blocks + 8 ids each
TIER_CHECK_BLOCK = 100  # the block whose pages are held bitwise across restores
PUMP_TURNS = ("on", "off", "off", "on", "on", "off")


def tier_prompts(torch, n, seed):
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(1, 128000, (TIER_LEN,), generator=rng).tolist() for _ in range(n)]


async def drain_offload(engine):
    """The explicit drains of phase g: until the offload queue is empty."""
    while engine._offload_queue:
        await engine.drain_offload()


async def block_pages(engine, seq_hash):
    """A sealed block's pages [L, ps, 2KV, D] read back to the host by the
    harness (a stream-ordered copy under the device lock), or None."""
    async with engine._device_lock:
        bid = engine.kv._by_hash.get(seq_hash)
        return None if bid is None else engine.cache.pages[:, bid].to("cpu", copy=True)


class TierTimers:
    """Host wall of the tier work inside a restore, by part, from wrappers
    around the engine's methods (phase g's breakdown; the parts nest:
    ``promote`` holds the reads and the demotion cascade its host-tier
    puts set off; ``upload`` is the whole upload, which the restore
    entries split into its lock wait, allocation and enqueue), and
    ``gc_pause``, the interpreter's collections in the window (a
    collection holds the GIL, so every thread waits it out)."""

    PARTS = ("promote", "disk_read", "objstore_read", "demote_to_disk", "demote_to_objstore",
             "upload", "verify", "scatter_enqueue", "gc_pause")

    def __init__(self, engine):
        self.ms = dict.fromkeys(self.PARTS, 0.0)
        self._undo = []
        self._gc_t0 = None

        def on_gc(phase, info):
            if phase == "start":
                self._gc_t0 = time.perf_counter()
            elif self._gc_t0 is not None:
                self.ms["gc_pause"] += (time.perf_counter() - self._gc_t0) * 1e3
                self._gc_t0 = None

        gc.callbacks.append(on_gc)
        self._undo.append((gc.callbacks, None, on_gc))

        def wrap(obj, attr, part):
            fn = getattr(obj, attr)

            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.ms[part] += (time.perf_counter() - t0) * 1e3

            setattr(obj, attr, timed)
            self._undo.append((obj, attr, fn))

        wrap(engine, "_promote_blocks", "promote")
        wrap(engine.disk_kv, "read", "disk_read")
        wrap(engine.object_kv, "read", "objstore_read")
        wrap(engine.host_kv, "on_evict", "demote_to_disk")
        wrap(engine.disk_kv, "on_evict", "demote_to_objstore")
        wrap(engine, "_restore_upload", "upload")
        wrap(engine, "_restore_verify", "verify")
        wrap(engine, "_restore_scatter", "scatter_enqueue")

    def take(self):
        out, self.ms = self.ms, dict.fromkeys(self.PARTS, 0.0)
        return {k: round(v, 3) for k, v in out.items()}

    def close(self):
        for obj, attr, fn in reversed(self._undo):
            if attr is None:
                obj.remove(fn)
            else:
                setattr(obj, attr, fn)


# The restore's CRC kernel at phase g's shape: a 128-block prefix of
# llama-3.1-8b blocks [L, ps, 2KV, D] in bf16 (2 MiB each); its edges: int8
# pages, blocks shorter than a tile, bytes off a 16-byte boundary, full
# tiles with a short last one, and the same off the boundary.
CRC_CASES = (("prefix", 128, (32, PS, 2 * KV, D), "bfloat16", 0),
             ("int8 pages", 7, (32, PS, 2 * KV, D), "int8", 0),
             ("short slice", 5, (4100,), "uint8", 0),
             ("unaligned", 3, (2053,), "uint8", 1),
             ("tiles and a short tail", 9, (2 * 32768 + 4112,), "uint8", 0),
             ("tiles off the boundary", 4, (3 * 32768 + 7,), "uint8", 5),
             ("one byte", 2, (1,), "uint8", 0))
# The earlier design's time at the prefix (PERF.md's kernel table): for the log
# line alone, never for the kernels line, which holds this run's numbers.
CRC_PREFIX_MS = 0.2589


def crc_bound(nbytes, n, sms, clock_hz):
    """The CRC kernel's least time over ``n`` blocks of ``nbytes`` bytes in
    all: the blocks read once (and n words written), the slicing-by-4
    integer operations at the INT32 lane rate, and the shared-memory
    wavefronts (each byte's table lookup, 32 a wavefront when conflict-free
    as designed, and each byte written to and read from the ring once).
    Returns (bound ms, what bounds it, the parts in ms)."""
    rate = sms * clock_hz
    parts = {
        "bytes": (nbytes + 4 * n) / HBM_BYTES_PER_S * 1e3,
        "int32": nbytes / 4 * CRC_OPS_PER_4_BYTES / (PIPE_LANES["alu"] * rate) * 1e3,
        "smem_wavefronts": nbytes * (CRC_LOOKUPS_PER_BYTE / 32 + 2 / 128) / rate * 1e3,
    }
    # The earlier design's lookups: one table copy, ~3.5 to a bank.
    parts["smem_one_copy"] = nbytes * (CRC_LOOKUPS_PER_BYTE * CRC_RANDOM_BANK_WAVEFRONTS / 32
                                       ) / rate * 1e3
    designed = {k: v for k, v in parts.items() if k != "smem_one_copy"}
    by = max(designed, key=designed.get)
    return designed[by], "bytes" if by == "bytes" else "operations", parts


def check_crc_kernel(torch, dev, tally):
    """Phase g, part 0: csrc/crc32_blocks.cu against its plain version
    (zlib over each block's bytes on the host, the port's check before this
    kernel) on CRC_CASES, exactly; then timed at the prefix (rounds of 20
    launches, L2 flushed) beside the earlier design's time, the plain version
    on the host (the engine's 8 CRC threads) and the bound (``crc_bound``
    at the SM clock sampled while it ran).  Returns the timings."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.ops import _build, crc32

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    prefix = None
    for label, n, shape, dtype, off in CRC_CASES:
        dt = getattr(torch, dtype)
        nbytes = n * math.prod(shape) * torch.empty((), dtype=dt).element_size()
        raw = torch.randint(0, 256, (nbytes + 16,), generator=gen, device=dev, dtype=torch.uint8)
        blocks = raw[off:off + nbytes].view(dt).view(n, *shape)
        got = crc32.block_crc32_cuda(blocks)
        want = crc32.block_crc32_plain(blocks.cpu())
        err = int((got.cpu() - want).abs().max())
        ok = err == 0
        tally.worst["crc32_blocks"] = max(tally.worst["crc32_blocks"], float(err))
        log(f"check crc32_blocks {label} [{n} x {shape} {dtype}, offset {off}]: max_abs_err="
            f"{err} (exact) {'ok' if ok else 'FAIL'}")
        if not ok:
            tally.failures.append(f"crc32_blocks {label}")
        if label == "prefix":
            prefix = blocks
        del raw, got
    listing = sass_listing(_build._target(_build.CSRC / "crc32_blocks.cu"), "crc32_blocks_kernel")
    if listing:
        ops = {}
        for _, op, _ in listing:
            ops[op] = ops.get(op, 0) + 1
        log(f"sass crc32_blocks: {sum(ops.values())} instructions in the kernel, by opcode "
            f"{dict(sorted(ops.items()))}")
    host = prefix.cpu()
    nbytes = host.numel() * host.element_size()
    rounds, clocks = during(lambda: [cuda_ms(torch, lambda: crc32.block_crc32_cuda(prefix), 20,
                                             flush) for _ in range(TIMING_ROUNDS)])
    clock = run_clock_hz(clocks)
    sms = sm_count(torch)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        crc32.block_crc32_plain(host, pool)
        plain = []
        for _ in range(3):
            t0 = time.perf_counter()
            crc32.block_crc32_plain(host, pool)
            plain.append((time.perf_counter() - t0) * 1e3)
    bound_ms, bound_by, parts = crc_bound(nbytes, prefix.shape[0], sms, clock)
    per_block, per_cta, grid = crc32.tiles_of(prefix.shape[0], nbytes // prefix.shape[0], sms)
    r = dict(ms=statistics.median(rounds), rounds=rounds, bound_ms=bound_ms, bound_by=bound_by,
             bound_parts_ms=parts, clock_mhz=clock / 1e6, clock_samples=clocks,
             plain_ms=statistics.median(plain), library_ms=None,
             shape=f"{prefix.shape[0]} x {list(prefix.shape[1:])} bf16")
    log(f"time crc32_blocks [{r['shape']}, {nbytes / 2**20:.0f} MiB]: kernel {r['ms']:.4f} ms "
        f"(the earlier design {CRC_PREFIX_MS} ms), plain (zlib on the host, 8 threads) "
        f"{r['plain_ms']:.3f} ms {[round(x, 3) for x in plain]}, library none (PyTorch has no "
        f"CRC), bound {bound_ms:.4f} ms ({bound_by}; at {clock / 1e6:.0f} MHz on {sms} SMs: "
        f"{({k: round(v, 4) for k, v in parts.items()})} ms: {CRC_OPS_PER_4_BYTES} INT32 "
        f"operations per 4 bytes at {PIPE_LANES['alu']} lanes a clock, {CRC_LOOKUPS_PER_BYTE} "
        f"lookup a byte conflict-free, the one-copy design's ~{CRC_RANDOM_BANK_WAVEFRONTS} "
        f"to a bank beside it), {r['ms'] / bound_ms:.2f}x the bound; {grid} CTAs of "
        f"{per_cta} tiles, {per_block} a block [{CARD}]; rounds {[round(x, 4) for x in rounds]}")
    del flush, prefix, host
    torch.cuda.empty_cache()
    return r


def restore_parts(entries):
    """(restore passes, their host wall summed by part in ms) among an
    engine's ``transfer_parts`` entries (engine/offload.py _restore_pass);
    ``unpinned`` is a count of source blocks, summed as it is."""
    passes = [pp for kind, _, pp in entries if kind == "restore"]
    return len(passes), {k: sum(pp[k] for pp in passes) * (1 if k == "unpinned" else 1e3)
                         for k in (passes[0] if passes else {})}


UPLOAD_BLOCKS = 128  # phase g's host restore: 128 blocks of 2 MiB
UPLOAD_REPEATS = 4


def upload_causes(torch, dev):
    """``--upload-causes``: phase g's host-restore upload (128 blocks of 2
    MiB, host → device on a side stream) under each candidate cause of a
    slow upload, apart: the lock held by another thread, a pageable source,
    another Python thread holding the GIL, a collection of a large heap in
    the middle of the enqueues, and the caching allocator freeing its cache
    to make room for the buffer.  Each case times the host wall of the lock
    wait, the buffer's allocation and the enqueues, and the copy stream's
    time; first as the engine enqueued (a Python loop of ``copy_``), then
    in one call (``torch._foreach_copy_``), then into a kept buffer.
    Returns the rows."""
    shape = (32, PS, 2 * KV, D)
    pinned = [torch.empty(shape, dtype=torch.bfloat16, pin_memory=True).fill_(1.0)
              for _ in range(UPLOAD_BLOCKS)]
    pageable = [torch.ones(shape, dtype=torch.bfloat16) for _ in range(UPLOAD_BLOCKS)]
    stream = torch.cuda.Stream(dev)
    lock = threading.Lock()
    kept = torch.empty((UPLOAD_BLOCKS, *shape), dtype=torch.bfloat16, device=dev)
    rows = []

    def upload(blocks, how):
        t0 = time.perf_counter()
        with lock:
            t1 = time.perf_counter()
            with torch.cuda.stream(stream):
                a = torch.cuda.Event(enable_timing=True)
                a.record(stream)
                t2a = time.perf_counter()
                buf = kept if how == "kept" else torch.empty(
                    (len(blocks), *shape), dtype=torch.bfloat16, device=dev)
                t2 = time.perf_counter()
                if how == "loop":
                    for dst, src in zip(buf.unbind(0), blocks):
                        dst.copy_(src, non_blocking=True)
                else:
                    torch._foreach_copy_(list(buf.unbind(0)), blocks, non_blocking=True)
                t3 = time.perf_counter()
                b = torch.cuda.Event(enable_timing=True)
                b.record(stream)
        b.synchronize()
        del buf
        return {"lock_wait": (t1 - t0) * 1e3, "alloc": (t2 - t2a) * 1e3,
                "enqueue": (t3 - t2) * 1e3, "stream": a.elapsed_time(b)}

    def busy_python(stop):
        x = 0
        while not stop.is_set():
            x += 1

    def hold_lock(stop, hold_s):
        with lock:
            stop.wait(hold_s)

    def case(label, blocks, how, around=None):
        out = []
        for _ in range(UPLOAD_REPEATS):
            stop = threading.Event()
            th = threading.Thread(target=around, args=(stop,)) if around else None
            if th:
                th.start()
                time.sleep(0.02)
            try:
                out.append(upload(blocks, how))
            finally:
                stop.set()
                if th:
                    th.join()
            torch.cuda.synchronize()
        med = {k: statistics.median(r[k] for r in out) for k in out[0]}
        gib = UPLOAD_BLOCKS * 2 / 1024 / (med["stream"] / 1e3)
        rows.append(dict(label=label, how=how, **{k: round(v, 3) for k, v in med.items()},
                         gib_s=round(gib, 2), first=out[0]))
        log(f"upload cause [{label}, {how}] median of {UPLOAD_REPEATS}: lock wait "
            f"{med['lock_wait']:.3f} ms, alloc {med['alloc']:.3f} ms, enqueue "
            f"{med['enqueue']:.3f} ms, copy stream {med['stream']:.3f} ms ({gib:.2f} GiB/s); "
            f"first {({k: round(v, 3) for k, v in out[0].items()})} (card {CARD})")

    heap = [[i] for i in range(3_000_000)]  # a heap of a few million container objects

    def collect_during(stop):
        # A full collection (it holds the GIL) ~1 ms into the enqueues.
        stop.wait(0.021)
        gc.collect()

    class Hog:
        """Card memory taken so that the buffer's allocation finds no free
        segment: the allocator then frees its cache (a device-wide sync)."""

        def __enter__(self):
            cached = [torch.empty(64 << 20, dtype=torch.uint8, device=dev) for _ in range(8)]
            del cached  # 512 MiB cached on the default stream, not the side stream's
            free, _ = torch.cuda.mem_get_info(dev)
            self.held = torch.empty(int(free - (192 << 20)), dtype=torch.uint8, device=dev)
            return self

        def __exit__(self, *exc):
            del self.held
            torch.cuda.empty_cache()

    with torch.inference_mode():
        for how in ("loop", "foreach"):
            case("pinned, idle", pinned, how)
            case("pageable", pageable, how)
            case("another thread holds the GIL", pinned, how, around=busy_python)
            case("a full collection of a 3M-object heap", pinned, how, around=collect_during)
        case("the lock held 100 ms by another thread", pinned, "loop",
             around=lambda stop: hold_lock(stop, 0.1))
        torch.cuda.empty_cache()
        with Hog():
            case("the allocator frees its cache first", pinned, "loop")
        case("pinned, idle", pinned, "kept")
        case("another thread holds the GIL", pinned, "kept", around=busy_python)
    heap.clear()
    return rows


async def tier_path(torch, phase6):
    """Phase g: the KV memory tiers at llama-3.1-8b with phase 6's weights.
    12 prompts of 2056 ids (16 new tokens each) one at a time, the offload
    queue drained after each: 1536 blocks, three times the device pool, so
    blocks demote host → disk → object store.  Then re-serves whose first
    block sits on disk under a ``kv_corrupt`` fault (quarantined,
    recomputed), in host, on disk and in the object store (restored ahead of
    admission), a scale-from-zero engine on the same object store, and the
    write-behind pump's cost on phase 6's 8 concurrent requests, host tier
    on and off in turns (not gated).  Returns (ok, numbers)."""
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm import metrics as tm
    from dynamo_tpu_torch.ops import crc32
    from dynamo_tpu_torch.runtime.faultinject import faults
    from dynamo_tpu_torch.tokens import hash_token_blocks

    fails, out = [], {"rows": []}
    dev, params = phase6.device, phase6.params

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"tiers check FAILED: {what}")

    root = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    def new_engine(disk_dir, **over):
        cfg = dict(TIER_CFG, host_offload_interval=3600.0,  # drained explicitly
                   disk_cache_dir=os.path.join(root, disk_dir),
                   object_store_dir=os.path.join(root, "objects"))
        cfg.update(over)
        return TorchEngine(EngineConfig(**cfg), params=params, device=dev)

    prompts = tier_prompts(torch, TIER_PROMPTS, 17)
    chains = [[tb.sequence_hash for tb in hash_token_blocks(p, PS)] for p in prompts]
    n_blocks = TIER_LEN // PS
    first, saved = [], []
    t_phase = time.perf_counter()
    engine = new_engine("disk")
    try:
        t = time.perf_counter()
        graphs0 = await engine.run_warmup()
        out["warm_s"] = time.perf_counter() - t
        for m in (tm.kv_tier_metrics, tm.kv_integrity_metrics, tm.objstore_metrics):
            m.reset()
        zero_kernel_counts()
        crc32.block_crc32_cuda.launches = 0
        torch.cuda.synchronize = counting_sync
        t = time.perf_counter()
        for i, p in enumerate(prompts):
            toks, stamps, finish = (await serve(torch, engine, [p], TIER_NEW))[0]
            check(len(toks) == TIER_NEW and finish == "length", f"fill {i}: {len(toks)} tokens")
            first.append((toks, stamps[0]))
            saved.append(await block_pages(engine, chains[i][TIER_CHECK_BLOCK]))
            await drain_offload(engine)
        out["fill_s"] = time.perf_counter() - t
        out["fill_copies"] = engine.copy_summary()
        tiers = [engine._tier_of(c[0]) for c in chains]
        out["tiers_after_fill"] = tiers
        out["summary_after_fill"] = {k: v for k, v in engine.kv_tier_summary().items()
                                     if k != "prefix_hit_rate"}
        check("objstore" in tiers and "disk" in tiers and "host" in tiers,
              f"fill: first blocks in host, disk and object store ({tiers})")
        used = set()
        timers = TierTimers(engine)

        def pick(tier):
            """The most recent unused prompt whose first block is in ``tier``,
            one with its whole prefix there first."""
            cands = [i for i in reversed(range(TIER_PROMPTS))
                     if i not in used and engine._tier_of(chains[i][0]) == tier]
            whole = [i for i in cands if all(engine._tier_of(h) == tier for h in chains[i][:n_blocks])]
            return (whole or cands or [None])[0]

        async def reserve(label, i):
            """Re-serve prompt ``i`` alone, its chain off the device first, and
            hold it against the first pass."""
            used.add(i)
            engine.kv.evict_hashes(chains[i])
            r0, m0 = engine.host_kv.restored_blocks, tm.kv_tier_metrics.restored_blocks_total
            c0 = engine.copy_summary()
            timers.take()
            n_parts0 = len(engine.transfer_parts)
            toks, stamps, _ = (await serve(torch, engine, [prompts[i]], TIER_NEW))[0]
            parts = timers.take()
            passes = restore_parts(list(engine.transfer_parts)[n_parts0:])
            c1 = engine.copy_summary()
            restored = engine.host_kv.restored_blocks - r0
            scraped = parse_prometheus(tm.kv_tier_metrics.render())
            metric = scraped[("dynamo_tpu_kv_tier_restored_blocks_total", ())] - m0
            pages = await block_pages(engine, chains[i][TIER_CHECK_BLOCK])
            await drain_offload(engine)
            row = {"label": label, "prompt": i, "restored": restored, "metric": metric,
                   "counter": tm.kv_tier_metrics.restored_blocks_total - m0,
                   "ttft_ms": stamps[0] * 1e3, "first_ttft_ms": first[i][1] * 1e3,
                   "identical": toks == first[i][0],
                   "bitwise": pages is not None and torch.equal(pages, saved[i]),
                   "h2d_bytes": c1["h2d_bytes"] - c0["h2d_bytes"],
                   "h2d_ms": c1["h2d_ms"] - c0["h2d_ms"], "parts_ms": parts,
                   "restore_passes": passes[0], "restore_parts_ms": passes[1]}
            out["rows"].append(row)
            check(row["identical"], f"{label}: stream identical to the first pass")
            check(row["bitwise"] or not restored,  # a recompute is reported, not held
                  f"{label}: block {TIER_CHECK_BLOCK}'s restored pages bitwise equal to the "
                  f"first prefill's")
            check(restored == row["counter"] == metric,
                  f"{label}: restored blocks {restored} = counter {row['counter']} = /metrics "
                  f"{metric}")
            return row

        # A kv_corrupt fault on one disk file: quarantined, recomputed.
        i = pick("disk")
        check(i is not None, "a prompt whose first block is on disk")
        if i is not None:
            integ = tm.kv_integrity_metrics
            c0, r0 = integ.corrupt_total["disk"], integ.recomputed_total
            faults.arm("kv_corrupt", match="disk", count=1)
            try:
                row = await reserve("disk, kv_corrupt", i)
            finally:
                faults.reset()
            check(row["restored"] == 0, f"disk fault: nothing restored ({row['restored']})")
            check(integ.corrupt_total["disk"] == c0 + 1 and integ.recomputed_total == r0 + 1,
                  f"disk fault: one disk corruption, one recompute ({integ.snapshot()})")
            check(engine.integrity.banned(chains[i][0]) and not engine.disk_kv.contains(chains[i][0]),
                  "disk fault: the block quarantined (negative-cached, file gone)")
        for tier in ("host", "disk", "objstore"):
            i = pick(tier)
            check(i is not None, f"a prompt whose first block is in {tier}")
            if i is None:
                continue
            row = await reserve(tier, i)
            check(row["restored"] == n_blocks, f"{tier}: {row['restored']} of {n_blocks} restored")
            if tier == "host":
                check(row["ttft_ms"] < row["first_ttft_ms"],
                      f"host restore TTFT {row['ttft_ms']:.1f} ms below the first pass's "
                      f"{row['first_ttft_ms']:.1f} ms")
        timers.close()
        out["graphs"] = (graphs0, engine.compile_counts())
        check(engine.compile_counts() == graphs0, f"no graph captured ({out['graphs']})")
        out["copies"] = engine.copy_summary()
        out["integrity"] = tm.kv_integrity_metrics.snapshot()
        out["objstore"] = tm.objstore_metrics.snapshot()
        out["tier_counters"] = {k: v for k, v in tm.kv_tier_metrics.snapshot().items()
                                if k.endswith("_total") and "pull" not in k}
        # Scale from zero: a fresh engine, empty device, host and disk, on
        # the same object store.
        whole = [i for i in range(TIER_PROMPTS) if i not in used
                 and all(engine.object_kv.contains(h) for h in chains[i][:n_blocks])]
        s0 = whole[0] if whole else None
        check(s0 is not None, "a prompt whose whole prefix is in the object store")
        torch.cuda.synchronize = real_sync
        await engine.close()
        engine = None
        if s0 is not None:
            fresh = new_engine("disk2")
            try:
                g0 = await fresh.run_warmup()
                timers = TierTimers(fresh)
                check(len(fresh.host_kv) == len(fresh.disk_kv) == 0
                      and len(fresh.object_kv) > 0, "scale from zero: only the object store holds blocks")
                torch.cuda.synchronize = counting_sync
                toks, stamps, _ = (await serve(torch, fresh, [prompts[s0]], TIER_NEW))[0]
                pages = await block_pages(fresh, chains[s0][TIER_CHECK_BLOCK])
                torch.cuda.synchronize = real_sync
                timers.close()
                passes = restore_parts(list(fresh.transfer_parts))
                row = {"label": "scale from zero", "prompt": s0,
                       "restored": fresh.host_kv.restored_blocks,
                       "ttft_ms": stamps[0] * 1e3, "first_ttft_ms": first[s0][1] * 1e3,
                       "identical": toks == first[s0][0],
                       "bitwise": pages is not None and torch.equal(pages, saved[s0]),
                       "h2d_bytes": fresh.copy_summary()["h2d_bytes"],
                       "h2d_ms": fresh.copy_summary()["h2d_ms"], "parts_ms": timers.take(),
                       "restore_passes": passes[0], "restore_parts_ms": passes[1]}
                out["rows"].append(row)
                check(row["identical"], "scale from zero: stream identical to the first pass")
                check(row["bitwise"], "scale from zero: restored pages bitwise equal")
                check(row["restored"] == n_blocks, f"scale from zero: {row['restored']} restored")
                check(fresh.compile_counts() == g0, "scale from zero: no graph captured")
            finally:
                torch.cuda.synchronize = real_sync
                await fresh.close()
        out["launches"] = dict(kernel_counts(), crc32_blocks=crc32.block_crc32_cuda.launches)
        out["syncs"] = syncs[0]
        check(syncs[0] == 0, f"no torch.cuda.synchronize() while serving ({syncs[0]} calls)")
        check(all(v > 0 for v in out["launches"].values()), f"tiers: the attention kernels and "
                                                            f"the restore's CRC kernel launched "
                                                            f"({out['launches']})")
        out["pump"] = await pump_ab(torch, dev, params)
    finally:
        torch.cuda.synchronize = real_sync
        if engine is not None:
            await engine.close()
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    gib = 1 << 30
    log(f"tiers (phase g, card {CARD}): warmup {out['warm_s']:.2f} s; fill 12 x {TIER_LEN} ids "
        f"{out.get('fill_s', 0):.2f} s, first blocks by tier {out.get('tiers_after_fill')}, "
        f"tiers {out.get('summary_after_fill')}; fill copies {out.get('fill_copies')}")
    for r in out["rows"]:
        h2d = r["h2d_bytes"] / gib / (r["h2d_ms"] / 1e3) if r["h2d_ms"] else 0.0
        log(f"tiers restore [{r['label']}] prompt {r['prompt']}: restored {r['restored']} blocks, "
            f"TTFT {r['ttft_ms']:.1f} ms vs first pass {r['first_ttft_ms']:.1f} ms, identical "
            f"{r['identical']}, bitwise {r['bitwise']}, host->device {r['h2d_bytes']} B in "
            f"{r['h2d_ms']:.3f} ms stream time ({h2d:.2f} GiB/s); host wall by part (ms, "
            f"nested) {r['parts_ms']}; the restore passes ({r['restore_passes']}) by part (ms) "
            f"{({k: round(v, 2) for k, v in r['restore_parts_ms'].items()})}")
        rp = r["restore_parts_ms"]
        if r["restore_passes"]:
            log(f"tiers upload [{r['label']}]: lock wait {rp['upload_lock_wait']:.3f} ms, alloc "
                f"{rp['upload_alloc']:.3f} ms, enqueue {rp['upload_enqueue']:.3f} ms of "
                f"{rp['upload']:.3f} ms; {int(rp['unpinned'])} unpinned source blocks; "
                f"collections {r['parts_ms']['gc_pause']:.3f} ms in the request's window")
    log(f"tiers totals: copies {out.get('copies')}; tier counters {out.get('tier_counters')}; "
        f"integrity {out.get('integrity')}; objstore {out.get('objstore')}; graphs "
        f"{out.get('graphs')}; torch.cuda.synchronize calls while serving {out.get('syncs')}; "
        f"launches {out.get('launches')}; phase wall {out['wall_s']:.2f} s "
        f"{'ok' if not fails else 'FAIL: ' + '; '.join(fails)}")
    return not fails, out


async def pump_ab(torch, dev, params):
    """Phase g step 4: phase 6's 8 concurrent greedy requests (64 new
    tokens) on a host-tier engine (the write-behind pump at its default
    interval) and on one without tiers, in turns; fresh prompts of phase
    6's lengths each pair.  Not gated.  Returns the turns."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    engines = {
        "on": TorchEngine(EngineConfig(**dict(SERVE_CFG, num_blocks=512,
                                              host_cache_bytes=1024 << 20)), params=params, device=dev),
        "off": TorchEngine(EngineConfig(**dict(SERVE_CFG, num_blocks=512)), params=params, device=dev),
    }
    turns = []
    try:
        for e in engines.values():
            await e.run_warmup()
        for k, mode in enumerate(PUMP_TURNS):
            rng = torch.Generator().manual_seed(1000 + k // 2)
            prompts = [torch.randint(1, 128000, (512 + 219 * i,), generator=rng).tolist()
                       for i in range(8)]
            t0 = time.perf_counter()
            results = await serve(torch, engines[mode], prompts, SERVE_MAX_TOKENS)
            wall = time.perf_counter() - t0
            ttft = [s[0] for _, s, _ in results]
            itl = [(s[-1] - s[0]) / (len(s) - 1) for _, s, _ in results if len(s) > 1]
            turns.append({"mode": mode, "ttft_p50_ms": statistics.median(ttft) * 1e3,
                          "itl_mean_ms": statistics.fmean(itl) * 1e3, "wall_s": wall,
                          "host_blocks": len(engines[mode].host_kv or ())})
    finally:
        for e in engines.values():
            await e.close()
    for mode in ("on", "off"):
        ts = [t for t in turns if t["mode"] == mode]
        log(f"tiers pump cost (card {CARD}), host tier {mode}: TTFT p50 "
            f"{[round(t['ttft_p50_ms'], 3) for t in ts]} ms, ITL mean "
            f"{[round(t['itl_mean_ms'], 3) for t in ts]} ms, wall "
            f"{[round(t['wall_s'], 3) for t in ts]} s, host blocks "
            f"{[t['host_blocks'] for t in ts]}")
    return turns


# ------------------------------------------------ direct vs HTTP, in turns


def direct_stamps(torch, dev):
    """One direct serve of the 8 prompts on a fresh, warmed engine, read where the
    HTTP client reads: per request (first text, last token) in seconds,
    the first text being the token at which the byte tokenizer's
    detokenizer first releases text (it holds U+FFFD back up to 4 ids).
    Returns (wall s, stamps, first-token seconds)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    engine = TorchEngine(EngineConfig(**SERVE_CFG), device=dev)

    async def run():
        try:
            await engine.run_warmup()  # as the HTTP phase's engine is warmed
            t0 = time.perf_counter()
            results = await serve(torch, engine, serve_prompts(torch), SERVE_MAX_TOKENS)
            return results, time.perf_counter() - t0
        finally:
            await engine.close()

    results, wall = asyncio.run(run())
    stamps, first_token = [], []
    for toks, times, _ in results:
        ds = ByteTokenizer().decode_stream()
        first_text = next((i for i, t in enumerate(toks) if ds.step(t)), len(toks) - 1)
        stamps.append((times[first_text], times[-1]))
        first_token.append(times[0])
    return wall, stamps, first_token


def serve_ab(torch, dev):
    """``--serve-ab``: the direct serve and the HTTP serve in turns in one
    process — a cold direct serve first (discarded), then direct, HTTP,
    HTTP, direct — each read at the client's points: first text, ITL
    (last − first text) / (tokens − 1), and the request's end."""
    def summary(label, wall, stamps, extra=""):
        first = sorted(a for a, _ in stamps)
        done = sorted(b for _, b in stamps)
        itl = [(b - a) / (SERVE_MAX_TOKENS - 1) for a, b in stamps]
        log(f"ab {label}: wall {wall:.3f} s, {len(stamps) * SERVE_MAX_TOKENS / wall:.2f} tok/s; "
            f"first text p50 {first[len(first) // 2] * 1e3:.1f} max {first[-1] * 1e3:.1f} ms; "
            f"ITL mean {sum(itl) / len(itl) * 1e3:.2f} ms; end p50 "
            f"{done[len(done) // 2] * 1e3:.1f} max {done[-1] * 1e3:.1f} ms{extra}")

    direct_stamps(torch, dev)  # warm-up
    ok = True
    for label in ("direct", "http", "http", "direct"):
        gc.collect()
        torch.cuda.empty_cache()
        if label == "direct":
            wall, stamps, first_token = direct_stamps(torch, dev)
            ft = sorted(first_token)
            summary(label, wall, stamps, f"; first token p50 {ft[len(ft) // 2] * 1e3:.1f} "
                    f"max {ft[-1] * 1e3:.1f} ms")
        else:
            good, _, out = http_path(torch)
            ok = ok and good
            summary(label, out["wall"], out.get("stamps", []))
    return ok


# -------------------------------------------- W8A8, int8 KV, speculation

INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
# llama-3.1-8b's projections as the engine runs them (fused q|k|v and
# gate|up): (leaf, K, N).  gate|up and the head write f32, the rest bf16.
PROJECTIONS = [("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gateup", 4096, 28672),
               ("w_down", 14336, 4096), ("lm_head", 4096, 128256)]
F32_OUT = ("w_gateup", "lm_head")
GEMM_ROWS = (16, 256, 2048)
# qdot's error bars (phase a): per entry, standard deviations of the
# activations' rounding (the largest of the ~4e8 entries lies near 6); and
# the largest error's share of the largest |x @ dequant(w)|.
QDOT_SIGMAS = 8.0
QDOT_MAX_SHARE = 0.015


def w8a8_ops(torch, dev):
    """Phase a: ``qdot`` at each projection shape of llama-3.1-8b and M =
    16, 256 and 2048 rows, bf16 activations.  Its int32 accumulation must
    equal an exact integer reference of the same codes (f64 products,
    exact below 2^53).  Against ``x @ dequant(w)`` in f32 two bars hold:
    every entry within ``QDOT_SIGMAS`` standard deviations of the
    activations' rounding (each code is off by at most half a row step s,
    uniformly, so an entry's error has sd s / sqrt(12) times the column's
    L2 norm) plus the output dtype's rounding; and the largest error
    within ``QDOT_MAX_SHARE`` of the largest |x @ dequant(w)|
    (tests/test_weight_quant.py holds 1 % at 16 x 64 x 48, where a row's
    largest entry is ~2.4 sigma; at K = 4096..14336 it is ~3.8 sigma, the
    row step larger, and the share 0.87-1.11 % on the card).  Timed (L2 flushed before
    each launch): qdot (quantize + ``torch._int_mm`` + rescale), ``_int_mm``
    alone on the column-major weight the port stores and on a row-major
    copy, and bf16 ``torch.matmul`` on the dequantized weight, beside the
    bounds: max(bytes / 3.35 TB/s, 2·M·N·K / peak) with the int8 and the
    bf16 peaks.  Returns ok."""
    from dynamo_tpu_torch.models.quant import operand_layout
    from dynamo_tpu_torch.ops import quant_matmul as qm

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 reference in full f32
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ok = True
    for name, K, N in PROJECTIONS:
        w_rm = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        w_cm = operand_layout(w_rm)
        scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        w_bf = (w_rm.float() * scale).to(torch.bfloat16)
        out_dtype = torch.float32 if name in F32_OUT else None
        for M in GEMM_ROWS:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            codes, row_scale = qm.quantize_rows(x)
            acc = qm.int_mm(codes, w_cm)
            int_ok = bool(torch.equal(acc.double(), codes.double() @ w_rm.double()))
            got = qm.qdot(x, w_cm, scale, out_dtype=out_dtype)
            w_deq = w_rm.float() * scale
            ref = x.float() @ w_deq
            err = (got.float() - ref).abs()
            out_eps = 2.0**-8 if out_dtype is None else 1e-6  # bf16 / f32 output rounding
            sd = row_scale * (w_deq.norm(dim=0) / math.sqrt(12.0))
            limit = QDOT_SIGMAS * sd + out_eps * ref.abs() + 1e-5 * ref.abs().max()
            within = bool((err <= limit).all())
            sigmas = float((err / sd).max())
            rel = float(err.max() / ref.abs().max())
            good = (int_ok and within and rel <= QDOT_MAX_SHARE
                    and bool(torch.isfinite(got).all()))
            ok = ok and good
            del acc, got, ref, err, limit, w_deq, sd
            t = {
                "qdot": cuda_ms(torch, lambda: qm.qdot(x, w_cm, scale, out_dtype=out_dtype), 10,
                                flush),
                "int_mm": cuda_ms(torch, lambda: qm.int_mm(codes, w_cm), 10, flush),
                "bf16": cuda_ms(torch, lambda: torch.matmul(x, w_bf), 10, flush),
            }
            try:  # a layout the port never passes: reported, not required
                t["int_mm_row_major"] = cuda_ms(torch, lambda: qm.int_mm(codes, w_rm), 10, flush)
            except RuntimeError as e:
                t["int_mm_row_major"] = f"refused ({str(e).splitlines()[0][:80]})"
            out_b = 4 if out_dtype else 2
            q_bound = max((M * K * 2 + K * N + N * 4 + M * N * out_b) / HBM_BYTES_PER_S,
                          2 * M * N * K / INT8_OPS) * 1e3
            bf_bound = max((M * K * 2 + K * N * 2 + M * N * 2) / HBM_BYTES_PER_S,
                           2 * M * N * K / BF16_FLOPS) * 1e3
            fmt = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in t.items()}
            log(f"w8a8 {name} M={M} K={K} N={N}: int32 accumulation exact {int_ok}, every "
                f"entry within {QDOT_SIGMAS:g} sd of the activations' rounding {within} (largest "
                f"{sigmas:.2f} sd), max err {rel:.2e} of max |x @ dequant(w)| (bar "
                f"{QDOT_MAX_SHARE:g}) {'ok' if good else 'FAIL'}; "
                f"ms {fmt}; bound W8A8 {q_bound:.4f} ms, bf16 {bf_bound:.4f} ms; "
                f"qdot/bf16 {t['qdot'] / t['bf16']:.3f}")
            del x, codes
        del w_rm, w_cm, w_bf
        torch.cuda.empty_cache()
    return ok


W8A8 = dict(weight_quant="int8", cache_dtype="int8", kv_scale="auto")
MODEL_CHECK_ROWS, MODEL_CHECK_TOKENS = 8, 64
KL_TOL = 0.05
KV_COSINE = 0.99
# Full depth: the W8A8 model's int8-page 1 - cosine against its witness, the
# bf16 tree's under the same scales (~5x on the card at 4 and at 32 layers:
# W8A8's rounding turns the KV noise into whole-step code changes).
KV_DRIFT_WITNESS = 8.0
FP8_COSINE = 0.98  # phase b's fp8-page bar at 4 layers
FP8_DRIFT_WITNESS = 64.0  # and at 32: 1 - cosine against the int8 row's


def rows_batch(torch, dev, prompts, tables):
    """A prefill RaggedBatch of one row per prompt (positions from 0) in
    the pages of its table."""
    from dynamo_tpu_torch.models.llama import RaggedBatch

    n = sum(len(p) for p in prompts)
    T = max(16, 1 << (n - 1).bit_length())
    tok, pos, slots, cu = [], [], [], [0]
    for p, table in zip(prompts, tables):
        tok += p
        pos += list(range(len(p)))
        slots += [table[i // PS] * PS + i % PS for i in range(len(p))]
        cu.append(cu[-1] + len(p))

    def t(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    return RaggedBatch(
        token_ids=t(tok + [0] * (T - n)), positions=t(pos + [0] * (T - n)),
        slot_mapping=t(slots + [-1] * (T - n)), kv_lens=t([len(p) for p in prompts]),
        page_indices=t(tables), cu_q_lens=t(cu), num_seqs=t([len(prompts)]))


def w8a8_model_check(torch, dev):
    """Phase b: llama-3.1-8b at full width, W8A8 (an engine's
    ``init_params_quantized`` tree, int8 KV scales calibrated at start),
    against the same quantized tree dequantized to bf16, on 8 prompts of 64
    tokens in one prefill step, as tests/test_weight_quant.py holds it:
    mean KL below KL_TOL, and the top-1 tokens agree wherever the
    reference's top-2 gap is decisive (> 3x the largest logit error; a
    random model's top-2 gap rarely is, and the line says when the check
    was vacuous).  Then int8 pages under the calibrated scales against
    bf16 pages on the same W8A8 model, at MODEL_CHECK_LAYERS layers (the
    paged f32 check's depth): cosine above KV_COSINE on every row.  At all
    32 layers the KL bar holds as well, and the int8-page drift is held
    against its witness, the bf16 tree's drift under the same scales:
    1 - cosine within KV_DRIFT_WITNESS times the witness's, since a random
    32-layer model amplifies any perturbation (1 - cosine grows
    with the square of the per-layer noise).

    Then the kv-fp8 rows, through ``dynamo_tpu_torch.tools.quant_quality``'s
    measuring function (``kv_rows``): the same bf16 tree's float8_e4m3fn
    pages under per-layer scales calibrated as ``kv_scale="auto"`` does
    (a bf16 probe, max |K/V| over 448), against bf16 pages, on the same
    prompts one at a time, beside the tool's int8 row on the same tree:
    mean KL, top-1 (overall and decisive) and the smallest cosine.  Their
    bars, set before the first card run: at 4 layers the fp8 pages' cosine
    above FP8_COSINE on every prompt and their mean KL below KL_TOL; at 32
    layers finite logits and 1 - cosine within FP8_DRIFT_WITNESS times the
    int8 row's (e4m3's 3 mantissa bits give ~6x the relative noise of
    calibrated int8 near the scale's top, ~36x in 1 - cosine).  Returns
    ok."""
    import numpy as np

    from dynamo_tpu_torch.tools import quant_quality as qq

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.llama import PagedKVCache, forward_ragged
    from dynamo_tpu_torch.models.quant import dequantize_params

    t0 = time.perf_counter()
    engine = TorchEngine(EngineConfig(model="llama-3.1-8b", dtype="bfloat16", block_size=PS,
                                      num_blocks=64, max_batch=MODEL_CHECK_ROWS,
                                      max_model_len=1024, seed=0, **W8A8), device=dev)
    torch.cuda.synchronize()
    mc, scales = engine.model_config, np.asarray(engine.kv_scale)
    ok = scales.shape == (mc.num_layers,) and bool(np.all(np.isfinite(scales) & (scales > 0)))
    log(f"w8a8 engine: init {time.perf_counter() - t0:.1f} s; {len(scales)} calibrated int8 KV "
        f"scales min {scales.min():.6g} max {scales.max():.6g}, calibration "
        f"{engine.calibration_s:.3f} s {'ok' if ok else 'FAIL'}")
    gen = torch.Generator().manual_seed(17)
    prompts = torch.randint(1, 128000, (MODEL_CHECK_ROWS, MODEL_CHECK_TOKENS), generator=gen).tolist()
    PP = MODEL_CHECK_TOKENS // PS
    tables = [list(range(r * PP, (r + 1) * PP)) for r in range(MODEL_CHECK_ROWS)]
    rb = rows_batch(torch, dev, prompts, tables)
    with torch.inference_mode():
        deq = dequantize_params(engine.params, torch.bfloat16)
    for depth in sorted({min(MODEL_CHECK_LAYERS, mc.num_layers), mc.num_layers}):
        mcd = mc.with_overrides(num_layers=depth)

        def logits(params, dtype, kv_scale):
            sub = dict(params, layers={k: v[:depth] for k, v in params["layers"].items()})
            cache = PagedKVCache.create(mcd, MODEL_CHECK_ROWS * PP, PS, dtype, dev)
            return forward_ragged(sub, mcd, rb, cache, kv_scale=kv_scale).double().cpu()

        with torch.inference_mode():
            lq = logits(engine.params, torch.bfloat16, None)
            lq8 = logits(engine.params, torch.int8, scales[:depth])
            lr = logits(deq, torch.bfloat16, None)
            lr8 = logits(deq, torch.int8, scales[:depth])
        kls, agree, decisive = [], 0, 0
        for a, b in zip(lq, lr):
            pq, pr = a.softmax(-1), b.softmax(-1)
            kls.append(float((pr * (pr.clamp_min(1e-300).log() - pq.clamp_min(1e-300).log())).sum()))
            top2 = b.topk(2).values
            if float(top2[0] - top2[1]) > 3 * float((a - b).abs().max()):
                decisive += 1
                agree += int(a.argmax() == b.argmax())

        def cosines(x, y):
            return [float(torch.nn.functional.cosine_similarity(a, b, dim=0)) for a, b in zip(x, y)]

        cos_q, cos_r = cosines(lq8, lq), cosines(lr8, lr)
        finite = all(bool(torch.isfinite(t).all()) for t in (lq, lq8, lr, lr8))
        shallow = depth == min(MODEL_CHECK_LAYERS, mc.num_layers)
        good_w = float(np.mean(kls)) < KL_TOL and agree == decisive
        drift_q, drift_r = 1 - min(cos_q), 1 - min(cos_r)
        good_kv = (min(cos_q) > KV_COSINE if shallow
                   else drift_q <= KV_DRIFT_WITNESS * drift_r)
        good = finite and good_w and good_kv
        ok = ok and good
        kv_bar = (f"bar {KV_COSINE}" if shallow else
                  f"1 - cosine {drift_q / max(drift_r, 1e-12):.2f}x the bf16 tree's, bar "
                  f"{KV_DRIFT_WITNESS:g}x")
        top1 = (f"{agree}/{decisive} decisive rows" if decisive else
                "vacuous (no row's top-2 gap is decisive)")
        with torch.inference_mode():
            sub = dict(deq, layers={k: v[:depth] for k, v in deq["layers"].items()})
            kv = {r["config"].split(" +")[0]: r for r in qq.kv_rows(
                sub, mcd, prompts, dev, ref_dtype="bfloat16", ref_label="bf16 pages")}
        i8, f8 = kv["kv int8"], kv["kv fp8-e4m3"]
        fp8_ok = (f8["min_cosine"] > FP8_COSINE and f8["mean_kl"] < KL_TOL if shallow else
                  math.isfinite(f8["mean_kl"]) and 1 - f8["min_cosine"]
                  <= FP8_DRIFT_WITNESS * max(1 - i8["min_cosine"], 1e-12))
        ok = ok and fp8_ok
        bar = (f"cosine > {FP8_COSINE}, KL < {KL_TOL}" if shallow else
               f"1 - cosine within {FP8_DRIFT_WITNESS:g}x the int8 row's")
        for name, r in (("int8", i8), ("fp8-e4m3", f8)):
            verdict = "" if name == "int8" else f" (bar: {bar}) {'ok' if fp8_ok else 'FAIL'}"
            log(f"kv {name} pages (quant_quality.kv_rows, scales calibrated as kv_scale auto) vs "
                f"bf16 pages on the bf16 tree, {depth} layers, {MODEL_CHECK_ROWS} prompts of "
                f"{MODEL_CHECK_TOKENS}: mean KL {r['mean_kl']:.3e}, top-1 {r['top1_agree']}, "
                f"decisive top-1 {r['decisive_agree']}, cosine min {r['min_cosine']:.6f}"
                f"{verdict} [{CARD}]")
        log(f"w8a8 model {depth} layers vs its dequantized bf16 tree, {MODEL_CHECK_ROWS} prompts "
            f"of {MODEL_CHECK_TOKENS}: mean KL {np.mean(kls):.3e} (bar {KL_TOL}), top-1 agreement "
            f"{top1}, max logit err {float((lq - lr).abs().max()):.4f} "
            f"(max |logit| {float(lr.abs().max()):.3f}); int8 pages (calibrated) vs bf16 pages: "
            f"cosine min {min(cos_q):.6f} on the W8A8 model ({kv_bar}), "
            f"{min(cos_r):.6f} on the bf16 tree; same argmax "
            f"{sum(int(a.argmax() == b.argmax()) for a, b in zip(lq8, lq))}/{MODEL_CHECK_ROWS} "
            f"{'ok' if good else 'FAIL'}")
    del deq
    asyncio.run(engine.close())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return ok


# bench.py's geometry (phase c): full-depth llama-3.1-8b, 256 rows.
BENCH_CFG = dict(model="llama-3.1-8b", dtype="bfloat16", block_size=PS, num_blocks=4160,
                 max_batch=256, max_model_len=256, prefill_chunk=512, decode_steps=8,
                 pipeline_depth=8, seed=0)
BENCH_ISL, BENCH_OSL = 128, 64


def bench_prompts(vocab, n):
    """bench.py's prompts: token j of request i is (i·7919 + j·104729) % vocab."""
    return [[(i * 7919 + j * 104729) % vocab for j in range(BENCH_ISL)] for i in range(n)]


def bench_serve(torch, dev, quant):
    """Phase c: the port's bench headline (``dynamo_tpu_torch.bench``'s
    ``headline``, what ``python -m dynamo_tpu_torch.bench`` runs) on one
    engine at BENCH_CFG (W8A8 with int8 KV ``auto``, or bf16 weights and
    bf16 KV): every program captured, a 4-token warm pass, then 256
    greedy requests of BENCH_ISL tokens with BENCH_OSL new each and
    ``ignore_eos``, kernel counters zeroed just before and read just after.
    Its one line must carry the JAX contract's key set and name the CUDA
    kernels.  Returns (ok, numbers)."""
    from dynamo_tpu_torch import bench
    from dynamo_tpu_torch.engine.config import EngineConfig

    cfg = EngineConfig(**BENCH_CFG, **(W8A8 if quant else {}))
    label = "W8A8 + int8 KV auto" if quant else "bf16 + bf16 KV"
    wl = {"isl": BENCH_ISL, "osl": BENCH_OSL, "requests": cfg.max_batch}
    out = {"label": label}

    def before(engine):
        zero_kernel_counts()

    def after(engine):
        out["launches"] = kernel_counts()
        out["per_replay"] = {name: {str(k): v for k, v in getattr(engine.programs, name)
                                    .captured_launches().items()} for name in ("step", "multi")}
        dec, pre = engine.decode_spans, engine.prefill_spans
        out["fused_step_ms"] = dec.seconds / max(1, dec.count * cfg.decode_steps) * 1e3
        out["prefill_step_ms"] = pre.seconds / max(1, pre.count) * 1e3
        # Every unified step applies the grammar mask (all-ones words
        # here): its cost at this geometry's row count.
        out["mask"] = mask_stage_times(torch, engine, BENCH_ISL)

    t0 = time.perf_counter()
    try:
        line, details = bench.headline(cfg, wl, dev, before_timed=before, after_timed=after)
    except RuntimeError as e:  # a capture inside the timed window
        log(f"bench {label}: {e} FAIL")
        return False, dict(out, launches=kernel_counts())
    out["phase_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    results = details["streams"]
    ttft = sorted(s[0] for _, s, _ in results)
    itl = [(s[-1] - s[0]) / (len(s) - 1) for _, s, _ in results if len(s) > 1]
    whole = all(len(t) == BENCH_OSL and f == "length" for t, _, f in results)
    keys = set(line) == bench.HEADLINE_KEYS
    names = (line["decode_kernel"], line["prefill_kernel"]) == bench.KERNEL_NAMES["cuda"]
    ok = (whole and keys and names and details["graphs_after"] == details["graphs"]
          and all(v > 0 for v in out["launches"].values()))
    pipe = line["pipeline"]
    out.update(line=line, warm=details["graphs"], after=details["graphs_after"],
               warm_s=details["warm_s"], calibration_s=details["calibration_s"],
               wall=details["wall"], tok_s=line["value"], ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
               ttft_max_ms=ttft[-1] * 1e3, itl_ms=sum(itl) / len(itl) * 1e3,
               host_gap_frac=line["host_gap_frac"])
    peak = "int8 1979 TOP/s" if cfg.weight_quant else "bf16 989 TFLOP/s"
    log(f"bench {label} (dynamo_tpu_torch.bench headline): {len(results)} requests, ISL "
        f"{BENCH_ISL} OSL {BENCH_OSL}, max_batch {cfg.max_batch}, decode_steps "
        f"{cfg.decode_steps}, pipeline_depth {cfg.pipeline_depth}; calibration "
        f"{out['calibration_s']:.3f} s, warmup {out['warm_s']:.2f} s for graphs {out['warm']}; "
        f"phase {out['phase_s']:.1f} s; wall {out['wall']:.3f} s, {out['tok_s']:.2f} output "
        f"tok/s; TTFT p50 {out['ttft_p50_ms']:.1f} ms max {out['ttft_max_ms']:.1f} ms; ITL mean "
        f"{out['itl_ms']:.2f} ms; fused step {out['fused_step_ms']:.2f} ms and prefill step "
        f"{out['prefill_step_ms']:.2f} ms (stream time); decode MFU {line['decode_mfu']} and "
        f"prefill MFU {line['prefill_mfu']} of the H100's dense {peak} peak; host_gap_frac "
        f"{out['host_gap_frac']}; sessions {pipe['sessions']} rebuilds {pipe['rebuilds']}; "
        f"launches {out['launches']}; per replay {out['per_replay']}; graphs after the serve "
        f"{out['after']}; streams whole {whole}; the line's key set is the contract's {keys}, "
        f"its kernels {line['decode_kernel']}, {line['prefill_kernel']} [{CARD}] "
        f"{'ok' if ok else 'FAIL'}")
    log(f"bench line: {json.dumps(line)}")
    log(f"bench {label} mask stage: a {cfg.max_batch}-row decode-shaped unified step (graph "
        f"replay, the all-ones mask applied) {out['mask']['step_plain']:.3f} ms; "
        f"{mask_stage_text(out['mask'])} [{CARD}]")
    return ok, out


def quant_ab(torch, dev):
    """``--quant-ab``: phase c's traffic on W8A8 + int8 KV and on bf16 +
    bf16 KV, engines one after the other in one process, in turns (W8A8,
    bf16, bf16, W8A8)."""
    ok = True
    for quant in (True, False, False, True):
        good, _ = bench_serve(torch, dev, quant)
        ok = ok and good
    return ok


# benchmarks/loadgen.py's self-hosted geometry (phase d).
LOADGEN_CFG = dict(model="llama-3.1-8b", dtype="bfloat16", block_size=PS, num_blocks=6208,
                   max_batch=24, max_model_len=4096, prefill_chunk=2048, decode_steps=16,
                   pipeline_depth=4, prefill_chunks_per_burst=24, seed=0, **W8A8)
LOADGEN_ISL, LOADGEN_OSL, LOADGEN_CONC = 3000, 150, 24


def loadgen_prompt(i, vocab):
    """benchmarks/loadgen.py's ``_prompt_tokens``: distinct per request."""
    return [(i * 7919 + j * 104729 + 11) % (vocab - 2) + 1 for j in range(LOADGEN_ISL)]


def pct(xs, p):
    """benchmarks/loadgen.py's percentile."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p))] if xs else float("nan")


def loadgen_http(torch, dev):
    """Phase d: the port's HttpService → OpenAIPreprocessor → Backend →
    TorchEngine built in-process as benchmarks/loadgen.py builds its
    self-hosted stack, at LOADGEN_CFG, the server's event loop in a thread
    of this process; 24 concurrent streamed /v1/completions of 3000-token-id
    prompts with 150 new tokens and ``nvext.ignore_eos``, read at the
    client as loadgen reads them (a token per SSE chunk, stamped on
    arrival); then ``/metrics``.  Returns (ok, numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.metrics import engine_dispatch_metrics
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline

    t0 = time.perf_counter()
    engine = TorchEngine(EngineConfig(**LOADGEN_CFG), device=dev)
    out = {"init_s": time.perf_counter() - t0, "calibration_s": engine.calibration_s}
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="loadgen-server", daemon=True)
    thread.start()

    def on_server(coro, timeout=1200):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    async def start():
        tok = ByteTokenizer()
        pipeline = build_pipeline([OpenAIPreprocessor(tok, "bench"), Backend(tok)], engine)
        service = HttpService(host="127.0.0.1", port=0)
        service.models.add_completion_model("bench", pipeline)
        service.models.add_chat_model("bench", pipeline)
        return await service.start()

    vocab = engine.model_config.vocab_size
    fails = []
    service = None
    try:
        t = time.perf_counter()
        out["warm"] = on_server(engine.run_warmup())
        out["warm_s"] = time.perf_counter() - t
        engine_dispatch_metrics.set_source(engine.dispatch_summary)
        service = on_server(start())

        async def client():
            async def one(i):
                return await http_call(service.port, "POST", "/v1/completions", {
                    "model": "bench", "prompt": loadgen_prompt(i, vocab),
                    "max_tokens": LOADGEN_OSL, "stream": True, "nvext": {"ignore_eos": True}})

            zero_kernel_counts()
            t = time.perf_counter()
            results = await asyncio.gather(*(one(i) for i in range(LOADGEN_CONC)))
            out["wall"] = time.perf_counter() - t
            out["launches"] = kernel_counts()
            out["metrics"] = (await http_call(service.port, "GET", "/metrics"))[2].decode()
            return results

        results = asyncio.run(client())
        out["after"] = engine.compile_counts()
        dec, pre = engine.decode_spans, engine.prefill_spans
        out["fused_step_ms"] = dec.seconds / max(1, dec.count * LOADGEN_CFG["decode_steps"]) * 1e3
        out["prefill_step_ms"] = pre.seconds / max(1, pre.count) * 1e3
        out["per_replay"] = {name: {str(k): v for k, v in getattr(engine.programs, name)
                                    .captured_launches().items()} for name in ("step", "multi")}
    finally:
        engine_dispatch_metrics.set_source(None)
        if service is not None:
            on_server(service.close())
        on_server(engine.close())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ttfts, itls, per_token, tokens, n_chunks = [], [], [], 0, []
    for i, (st, _, _, events) in enumerate(results):
        chunks, done = sse_data(events)
        final = chunks[-1][1] if chunks else {}
        used = (final.get("usage") or {}).get("completion_tokens")
        fin = (final.get("choices") or [{}])[0].get("finish_reason")
        if st != 200 or not done or fin != "length" or used != LOADGEN_OSL:
            fails.append(f"request {i}: {st} done={done} {fin}/{used}")
            continue
        tokens += used
        stamps = [t for t, c in chunks
                  if c.get("choices") and not c["choices"][0].get("finish_reason")]
        ttfts.append(stamps[0])
        itls += [b - a for a, b in zip(stamps, stamps[1:])]
        per_token.append((chunks[-1][0] - stamps[0]) / (used - 1))
        n_chunks.append(len(stamps))
    samples = parse_prometheus(out["metrics"])
    gap = [v for (n, _), v in samples.items() if n == "dynamo_tpu_engine_dispatch_host_gap_frac"]
    has_spec = any(n == "dynamo_tpu_spec_decode_acceptance_rate" for n, _ in samples)
    if out["after"] != out["warm"]:
        fails.append(f"graphs captured during the serve: {out['warm']} -> {out['after']}")
    if not all(v > 0 for v in out["launches"].values()):
        fails.append(f"a kernel never launched: {out['launches']}")
    if not gap or not has_spec:
        fails.append("/metrics lacks the engine-dispatch or the spec-decode group")
    out.update(tok_s=tokens / out["wall"], ttft_p50_ms=pct(ttfts, 0.5) * 1e3,
               ttft_p99_ms=pct(ttfts, 0.99) * 1e3, itl_p50_ms=pct(itls, 0.5) * 1e3,
               itl_p99_ms=pct(itls, 0.99) * 1e3, host_gap_frac=gap[0] if gap else None,
               itl_per_token_ms=sum(per_token) / max(1, len(per_token)) * 1e3)
    log(f"loadgen W8A8 + int8 KV auto over HTTP: {LOADGEN_CONC} concurrent streamed "
        f"/v1/completions, ISL {LOADGEN_ISL} OSL {LOADGEN_OSL}, max_batch "
        f"{LOADGEN_CFG['max_batch']}, prefill_chunk {LOADGEN_CFG['prefill_chunk']}, decode_steps "
        f"{LOADGEN_CFG['decode_steps']}, pipeline_depth {LOADGEN_CFG['pipeline_depth']}; init "
        f"{out['init_s']:.1f} s (calibration {out['calibration_s']:.3f} s), warmup "
        f"{out['warm_s']:.2f} s for graphs {out['warm']}; wall {out['wall']:.3f} s, "
        f"{out['tok_s']:.2f} output tok/s; TTFT p50 {out['ttft_p50_ms']:.1f} ms p99 "
        f"{out['ttft_p99_ms']:.1f} ms; ITL p50 {out['itl_p50_ms']:.2f} ms p99 "
        f"{out['itl_p99_ms']:.2f} ms (client, per SSE chunk; chunks a request {min(n_chunks, default=0)}"
        f"..{max(n_chunks, default=0)}), per token {out['itl_per_token_ms']:.2f} ms (end - first "
        f"chunk over {LOADGEN_OSL - 1}); fused step {out['fused_step_ms']:.2f} ms, prefill step "
        f"{out['prefill_step_ms']:.2f} ms (stream time); host_gap_frac "
        f"{out['host_gap_frac']} (/metrics); launches {out['launches']}; per replay "
        f"{out['per_replay']}; graphs after {out['after']} "
        f"{'ok' if not fails else 'FAIL: ' + '; '.join(fails)}")
    return not fails, out


SPEC_K = 8


def spec_oracle(prompts, streams, vocab):
    """A stand-in for ``engine.spec.propose_ngram`` that drafts each
    request's own spec-off stream from its position (the request is found
    by its prompt's first 8 tokens, unique in both workloads), with one
    token made wrong in every other 8-token window of output, so drafts
    are both accepted and rejected on the card whatever the random model
    emits."""
    import numpy as np

    refs = {tuple(p[:8]): (len(p), out) for p, out in zip(prompts, streams)}

    def oracle(hist, ngram_min, ngram_max, k):
        n_prompt, ref = refs[tuple(int(t) for t in hist[:8])]
        pos = len(hist) - n_prompt  # output tokens committed so far
        d = [int(t) for t in ref[pos: pos + k]]
        if d and (pos // 8) % 2:
            j = min(2, len(d) - 1)
            d[j] = (d[j] + 1) % vocab
        return np.asarray(d, np.int64)

    return oracle


def spec_phase(torch, dev):
    """Phase e: the port's bench in its spec mode (``dynamo_tpu_torch.bench``'s
    ``spec_bench``, what ``BENCH_SPEC=1 python -m dynamo_tpu_torch.bench``
    runs): a fresh W8A8 + int8 KV engine at BENCH_CFG per mode
    (speculation off, then on at k SPEC_K), n = max_batch // 8 requests of
    BENCH_ISL tokens with BENCH_OSL new each — the repetitive prompts
    greedy, the random ones at temperature 0.7 — each after the bench's
    4-token warm pass (which fills the prefix cache) and its second, whole
    warm pass over the cached prompts, which captures the sampled programs
    ``run_warmup`` leaves to first use (the graphs a timed pass still
    captured are printed).  The streams must be identical between the
    modes.  The random model's greedy output seldom gives the n-gram
    proposer a match, so the spec-on engine then serves both workloads
    once more with drafts forced (``spec_oracle``): the streams must again
    equal the spec-off ones, with verification dispatches, accepted and
    rejected drafts all above 0.  Returns (ok, numbers)."""
    from dynamo_tpu_torch import bench
    from dynamo_tpu_torch.engine import spec as spec_mod
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.llm.metrics import spec_metrics

    n = max(2, BENCH_CFG["max_batch"] // 8)
    res, kv_scales, before = {}, {}, {}
    vocab = 128256

    def before_timed(engine, kind, mode):
        zero_kernel_counts()
        zero_noise_launches()
        before[(kind, mode)] = engine.compile_counts()

    def after_timed(engine, kind, mode, toks, dt, out):
        snap = spec_metrics.snapshot()
        captured = (sum(engine.compile_counts().values())
                    - sum(before[(kind, mode)].values()))
        res[(kind, mode)] = dict(tok_s=toks / dt, tokens=toks, wall=dt,
                                 launches=kernel_counts(), noise=noise_launches(),
                                 captured=captured, **snap)
        log(f"spec {kind}/{mode}: {n} requests, {toks} tokens in {dt:.3f} s "
            f"({toks / dt:.2f} tok/s), acceptance {snap['acceptance_rate']:.3f}, "
            f"tokens/dispatch {snap['tokens_per_dispatch']:.2f}, verification "
            f"dispatches {int(snap['dispatches_total'])}, fallbacks "
            f"{int(snap['fallback_total'])}, launches {res[(kind, mode)]['launches']}, "
            f"categorical kernel launches {res[(kind, mode)]['noise']}, graphs captured in "
            f"the timed pass {captured}")

    streams = {}

    async def after_mode(engine, mode):
        kv_scales[mode] = [float(s) for s in engine.kv_scale]
        if mode == "on":
            await forced(engine)

    async def forced(engine):
        """Drafts forced on the card: the proposer replaced by
        ``spec_oracle`` over the spec-off streams."""
        saved = spec_mod.propose_ngram
        try:
            for kind, temp in bench.SPEC_KINDS:
                prompts = bench.spec_prompts(kind, BENCH_ISL, n, vocab)
                spec_mod.propose_ngram = spec_oracle(prompts, streams[(kind, "off")], vocab)
                spec_metrics.reset()
                zero_kernel_counts()
                toks, dt, out = await bench.spec_run(engine, prompts, BENCH_OSL, temp)
                snap = spec_metrics.snapshot()
                rejected = snap["drafted_total"] - snap["accepted_total"]
                same = out == streams[(kind, "off")]
                good = (same and snap["dispatches_total"] > 0 and snap["accepted_total"] > 0
                        and rejected > 0)
                res[(kind, "forced")] = dict(tok_s=toks / dt, identical=same, ok=good,
                                             launches=kernel_counts(), **snap)
                log(f"spec {kind}/forced drafts ({'greedy' if temp == 0 else f'temperature {temp}'}"
                    f", oracle of the spec-off stream, one token wrong in every other "
                    f"window): streams identical to spec off {same}; {toks / dt:.2f} tok/s, "
                    f"verification dispatches {int(snap['dispatches_total'])}, drafted "
                    f"{int(snap['drafted_total'])}, accepted {int(snap['accepted_total'])}, "
                    f"rejected {int(rejected)}, acceptance {snap['acceptance_rate']:.3f}, "
                    f"tokens/dispatch {snap['tokens_per_dispatch']:.2f}, launches "
                    f"{res[(kind, 'forced')]['launches']} {'ok' if good else 'FAIL'}")
        finally:
            spec_mod.propose_ngram = saved

    def keep_streams(engine, kind, mode, toks, dt, out):
        streams[(kind, mode)] = out
        after_timed(engine, kind, mode, toks, dt, out)

    env = {"BENCH_SPEC_ISL": str(BENCH_ISL), "BENCH_SPEC_OSL": str(BENCH_OSL),
           "BENCH_SPEC_REQUESTS": str(n), "BENCH_SPEC_K": str(SPEC_K)}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        line, _, _ = bench.spec_bench(EngineConfig(**BENCH_CFG, **W8A8), dev,
                                      hooks={"before_timed": before_timed,
                                             "after_timed": keep_streams,
                                             "after_mode": after_mode})
        log(f"spec line (dynamo_tpu_torch.bench spec mode): {json.dumps(line)}")
    except RuntimeError as e:  # the modes' streams differ
        log(f"spec: {e} FAIL")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    gc.collect()
    torch.cuda.empty_cache()
    if len(kv_scales) < 2 or any((k, m) not in streams for k in ("repetitive", "random")
                                 for m in ("off", "on")) or len(res) < 6:
        log(f"spec: a mode did not finish ({sorted(res)}) FAIL")
        return False, res
    # A warm start from the object store restores int8 codes without their
    # scales: it relies on two fresh engines of one seed calibrating the
    # same scales (reported, not gated).
    diff = max(abs(a - b) for a, b in zip(kv_scales["off"], kv_scales["on"]))
    log(f"int8 kv scales (kv_scale auto), two fresh engines of one seed: equal "
        f"{kv_scales['off'] == kv_scales['on']}, max |diff| {diff:.3e} over "
        f"{len(kv_scales['off'])} layers")
    ok = True
    for kind in ("repetitive", "random"):
        same = streams[(kind, "on")] == streams[(kind, "off")]
        whole = all(len(s) == BENCH_OSL for s in streams[(kind, "on")])
        ok = ok and same and whole
        ratio = res[(kind, "on")]["tok_s"] / res[(kind, "off")]["tok_s"]
        res[kind] = dict(ratio=ratio, identical=same)
        log(f"spec {kind}: streams identical on/off {same}, whole {whole}; tok/s off "
            f"{res[(kind, 'off')]['tok_s']:.2f} on {res[(kind, 'on')]['tok_s']:.2f}, ratio "
            f"{ratio:.3f} {'ok' if same and whole else 'FAIL'}")
    # Whether drafts engage depends on the random model's output turning
    # repetitive; it is reported, the streams and launches are checked.
    launched = all(all(v > 0 for v in res[(k, m)]["launches"].values())
                   for k in ("repetitive", "random") for m in ("off", "on"))
    # The sampled (random) passes draw through the categorical kernel; the
    # all-greedy (repetitive) passes do no key work at all.
    noise_ok = all(res[("random", m)]["noise"] > 0 and res[("repetitive", m)]["noise"] == 0
                   for m in ("off", "on"))
    forced_ok = all(res[(k, "forced")]["ok"] for k in ("repetitive", "random"))
    ok = ok and launched and forced_ok and noise_ok
    rep = res[("repetitive", "on")]
    # What the proposer can match: output positions whose bigram (previous
    # token, token) already occurred in the prompt or earlier output.
    hits = 0
    for prompt, out in zip(bench.spec_prompts("repetitive", BENCH_ISL, n, vocab),
                           streams[("repetitive", "off")]):
        hist = prompt + out
        seen = {(a, b) for a, b in zip(prompt, prompt[1:])}
        for j in range(len(prompt), len(hist)):
            pair = (hist[j - 1], hist[j])
            hits += pair in seen
            seen.add(pair)
    log(f"spec: both kernels launched in every timed pass {launched}; the categorical kernel in "
        f"the sampled passes only {noise_ok}; verification dispatches "
        f"on the repetitive traffic {int(rep['dispatches_total'])}, acceptance "
        f"{rep['acceptance_rate']:.3f}, tokens/dispatch {rep['tokens_per_dispatch']:.2f}; output "
        f"tokens whose bigram was already in the history {hits} of {n * BENCH_OSL} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, res


# ------------------------------------------------- h. the distributed serving path

DIST_MODEL = "llama-3.1-8b"
DIST_ENDPOINT = "dyn://dynamo.TorchWorker.generate"
# Phase 6's geometry, as CLI flags (seed 0 is the CLI's default, so both
# workers draw identical weights).
DIST_ENGINE_ARGV = [
    "out=torch", "--arch", "llama-3.1-8b", "--model", DIST_MODEL, "--dtype", "bfloat16",
    "--block-size", "16", "--num-blocks", "2048", "--max-batch", "16",
    "--max-model-len", "4096", "--prefill-chunk", "512", "--decode-steps", "8",
    "--pipeline-depth", "2",
]
DIST_PROMPTS, DIST_ISL, DIST_OSL = 8, 1024, 64
DIST_REPEAT_NEW, DIST_REPEAT_OSL = 32, 8
DIST_TURNS, DIST_TURN_PROMPTS = 3, 4
DIST_LOAD, DIST_LOAD_MIN_PER_WORKER = 16, 4
DIST_LOAD_ISL = (512, 2048)
DIST_FAILOVER, DIST_KILL_AFTER = 4, 8
DIST_LEASE_TTL_S = 10.0  # the runtime's DEFAULT_LEASE_TTL
DIST_HASH_IDS, DIST_HASH_CALLS = 2048, 50
DIST_VOCAB = 128000  # prompt ids are drawn below this


# Phases h, i and j (with k on j's stack and l on i's) run llama-3.1-8b at
# this many of its 32 layers, at full width, to keep the script inside its
# time: the in-process workers through ``model_depth``, the CLI children
# through DEPTH_ENV, which CHILD_PRELUDE reads before it runs the module.
PATH_CUT_LAYERS = 16
DEPTH_ENV = "CHIP_SMOKE_LAYERS"
CHILD_PRELUDE = (
    "import os, runpy, sys\n"
    "module = sys.argv.pop(1)\n"
    f"layers = os.environ.get({DEPTH_ENV!r})\n"
    "if layers:\n"
    "    from dynamo_tpu_torch.models import config as mc\n"
    f"    mc._REGISTRY[{DIST_MODEL!r}] = mc._REGISTRY[{DIST_MODEL!r}].with_overrides(\n"
    "        num_layers=int(layers))\n"
    "runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
)


@contextlib.contextmanager
def model_depth(layers):
    """llama-3.1-8b at ``layers`` layers in this process and in the CLI
    children started meanwhile."""
    from dynamo_tpu_torch.models import config as mc

    full = mc._REGISTRY[DIST_MODEL]
    mc._REGISTRY[DIST_MODEL] = full.with_overrides(num_layers=layers)
    os.environ[DEPTH_ENV] = str(layers)
    try:
        yield
    finally:
        mc._REGISTRY[DIST_MODEL] = full
        os.environ.pop(DEPTH_ENV, None)


class Child:
    """A CLI subprocess of this checkout; its output lines are collected by
    a thread (the pipe never fills) and searched with ``wait_line``."""

    def __init__(self, name, argv, env=None, module="dynamo_tpu_torch.cli"):
        self.name = name
        self.p = subprocess.Popen([sys.executable, "-c", CHILD_PRELUDE, module, *argv],
                                  cwd=str(REPO), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=None if env is None else {**os.environ, **env})
        self.lines = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_line(self, prefix, timeout):
        end = time.time() + timeout
        while time.time() < end:
            for line in self.lines:
                if line.startswith(prefix):
                    return line
            if self.p.poll() is not None:
                break
            time.sleep(0.1)
        raise RuntimeError(f"{self.name}: no {prefix!r} line; last output {self.lines[-15:]}")

    def stop(self, sig=signal.SIGTERM):
        if self.p.poll() is None:
            self.p.send_signal(sig)
            try:
                self.p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait(timeout=30)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_prompts(n, isl, seed):
    rng = random.Random(seed)
    return [[rng.randrange(1, DIST_VOCAB) for _ in range(isl)] for _ in range(n)]


def dist_text(tokens):
    """The text the edge streams for ``tokens`` of a ``max_tokens`` =
    len(tokens) request (the Backend's Decoder over the byte tokenizer:
    text held back at the length limit is not sent)."""
    from dynamo_tpu_torch.llm.backend import Decoder
    from dynamo_tpu_torch.llm.protocols import StopConditions
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    dec = Decoder(ByteTokenizer(), StopConditions(max_tokens=len(tokens), ignore_eos=True))
    text = []
    for t in tokens:
        delta, finish = dec.step(t)
        text.append(delta)
        if finish is not None:
            break
    return "".join(text)


async def dist_engine_alone(engine, prompt, n):
    """``prompt`` served alone on the colocated engine, under a KV salt so
    that it neither hits nor leaves a prefix the router could match.
    Returns (tokens, ttft_s, itl_s)."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    req = PreprocessedRequest(
        token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
        annotations={"kv_salt": "colocated-reference"},
    ).to_dict()
    t0 = time.perf_counter()
    toks, stamps = [], []
    async for item in await engine.generate(Context(req)):
        now = time.perf_counter() - t0
        for tok in item["token_ids"]:
            toks.append(tok)
            stamps.append(now)
    return toks, stamps[0], (stamps[-1] - stamps[0]) / max(1, len(stamps) - 1)


async def dist_complete(port, prompt, max_tokens, on_text=None, temperature=0, seed=None,
                        logprobs=None):
    """A streamed completion (greedy unless ``temperature``; with
    ``logprobs`` every token's chunk is sent, text or not); returns
    (status, text, finish, usage tokens, ttft_s, itl_s, longest gap between
    content chunks in s).  ``on_text(text so far)`` runs on every chunk."""
    text = []
    stamps = []

    def on_event(t, ev):
        if not ev.startswith("data: ") or ev == "data: [DONE]":
            return
        c = json.loads(ev[len("data: "):])
        for ch in c.get("choices") or []:
            if ch.get("text"):
                text.append(ch["text"])
                stamps.append(t)
        if on_text is not None:
            on_text("".join(text))

    body = {"model": DIST_MODEL, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": temperature, "stream": True, "nvext": {"ignore_eos": True}}
    if seed is not None:
        body["seed"] = seed
    if logprobs is not None:
        body["logprobs"] = logprobs
    st, _, body, events = await http_call(port, "POST", "/v1/completions", body,
                                          on_event=on_event)
    finish, used = None, None
    try:
        chunks, _ = sse_data(events)
        final = chunks[-1][1] if chunks else {}
        finish = (final.get("choices") or [{}])[0].get("finish_reason")
        used = (final.get("usage") or {}).get("completion_tokens")
    except ValueError:
        pass
    ttft = stamps[0] if stamps else float("nan")
    itl = (stamps[-1] - stamps[0]) / max(1, max_tokens - 1) if stamps else float("nan")
    gap = max((b - a for a, b in zip(stamps, stamps[1:])), default=float("nan"))
    return st, "".join(text), finish, used, ttft, itl, gap


async def dist_colocated_http(engine, prompts):
    """``prompts`` one at a time through an HttpService on ``engine``'s own
    loop (preprocessor → backend → engine, no hop); (TTFT ms, ITL ms)."""
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.pipeline import build_pipeline

    tok = ByteTokenizer()
    service = await HttpService(host="127.0.0.1", port=0).start()
    service.models.add_completion_model(
        DIST_MODEL, build_pipeline([OpenAIPreprocessor(tok, DIST_MODEL), Backend(tok)], engine))
    ttft, itl = [], []
    try:
        for p in prompts:
            r = await dist_complete(service.port, p, DIST_OSL)
            ttft.append(r[4] * 1e3)
            itl.append(r[5] * 1e3)
    finally:
        await service.close()
    return ttft, itl


def dist_path(torch):
    """Phase h: the README's distributed stack on the card.  Returns (ok,
    launches, numbers)."""
    from dynamo_tpu_torch import tokens as tok_mod
    from dynamo_tpu_torch.llm.kv_router.router import KvRouterCore
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.transports.hub import HubClient

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"dist check FAILED: {what}")

    hub_port = _free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    children, server = [], None
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    t_phase = time.perf_counter()
    try:
        children.append(Child("hub", ["hub", "--host", "127.0.0.1", "--port", str(hub_port)]))
        children[-1].wait_line("hub listening", 120)
        worker_b = Child("worker B", ["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV,
                                      "--hub", hub_addr])
        children.append(worker_b)
        fronts = {}
        for router in ("kv", "round_robin"):
            c = Child(f"http {router}", ["http", "--hub", hub_addr, "--host", "127.0.0.1",
                                         "--port", "0", "--router", router])
            children.append(c)
            fronts[router] = c
        for router, c in fronts.items():
            fronts[router] = int(c.wait_line("OpenAI frontend on", 120).rsplit(":", 1)[1])
        # Worker A: the CLI's own ``run in=dyn://`` code in this process,
        # so its kernel launches are counted; warmed before any traffic.
        t = time.perf_counter()
        server = CliServer(["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV, "--hub", hub_addr])
        wid_a = server.service.worker_id
        graphs = server.warmup()
        out["a_up_s"] = time.perf_counter() - t
        wid_b = int(worker_b.wait_line("worker ", 300).split()[1])
        out["b_up_s"] = time.perf_counter() - t_phase
        engine = server.engine
        log(f"dist: hub {hub_addr}, frontends kv :{fronts['kv']} round_robin "
            f":{fronts['round_robin']}, worker A {wid_a} (in this process, up and warmed in "
            f"{out['a_up_s']:.1f} s, graphs {graphs}), worker B {wid_b} (pid {worker_b.p.pid}, "
            f"registered {out['b_up_s']:.1f} s after the phase began)")
        name = {wid_a: "A", wid_b: "B"}

        # The router's hot path on this host: fast_sequence_hashes at 2048
        # ids, on the path this host takes (the native library once built)
        # and on the numpy one (the path without the library and xxhash).
        from dynamo_tpu_torch import native

        ids = dist_prompts(1, DIST_HASH_IDS, 3)[0]
        native.available()  # the build lands before the timed calls
        out["hash_path"] = ("native" if native.get_lib() is not None else
                            "xxhash" if tok_mod.USING_XXHASH else "numpy lanes + Python chain")
        installed, hash_blocks = tok_mod.USING_XXHASH, native.hash_blocks
        for key, fallback in (("hash_ms", False), ("hash_numpy_ms", True)):
            if fallback:
                tok_mod.USING_XXHASH = False
                native.hash_blocks = lambda *a, **k: None
            times = []
            try:
                for _ in range(DIST_HASH_CALLS):
                    t = time.perf_counter()
                    tok_mod.fast_sequence_hashes(ids, PS)
                    times.append(time.perf_counter() - t)
            finally:
                tok_mod.USING_XXHASH, native.hash_blocks = installed, hash_blocks
            out[key] = statistics.median(times) * 1e3

        prompts = dist_prompts(DIST_PROMPTS, DIST_ISL, 11)

        async def phase():
            rt = await DistributedRuntime.connect(hub_addr)
            hub = rt.hub
            ns, comp, ep = parse_endpoint_path(DIST_ENDPOINT)
            endpoint = rt.namespace(ns).component(comp).endpoint(ep)
            client = await endpoint.client()
            # A router core of this process on the same event stream: its
            # index is what the kv frontend's holds, and can be read here.
            core = await KvRouterCore(endpoint.component, client, PS,
                                      publish_hit_rate=False).start()
            hits = await endpoint.component.subscribe("kv-hit-rate")
            kv_sub = await endpoint.component.subscribe("kv_events")
            fpm_sub = await endpoint.component.subscribe("kv_metrics")
            stored = {wid_a: set(), wid_b: set()}
            latest = {}

            async def pump_events():
                async for _, msg in kv_sub:
                    data = (msg.get("event") or {}).get("data") or {}
                    for blk in (data.get("stored") or {}).get("blocks", ()):
                        stored.setdefault(msg["worker_id"], set()).add(blk["block_hash"])

            async def pump_metrics():
                async for _, msg in fpm_sub:
                    latest[msg["worker_id"]] = msg["metrics"]

            tasks = [asyncio.ensure_future(pump_events()), asyncio.ensure_future(pump_metrics())]

            async def next_hit():
                _, h = await asyncio.wait_for(hits.__anext__(), 120)
                return h

            try:
                for _ in range(600):
                    if set(client.instance_ids) == {wid_a, wid_b}:
                        break
                    await asyncio.sleep(0.1)
                check(set(client.instance_ids) == {wid_a, wid_b},
                      f"both workers discovered ({client.instance_ids})")
                core.select(prompts[0])  # the core learns the live set
                kv, rr = fronts["kv"], fronts["round_robin"]
                st, _, body, _ = await http_call(kv, "GET", "/health")
                health = json.loads(body) if st == 200 else {}
                check(health.get("hub_shards") == [{"shard": hub_addr, "connected": True}],
                      f"/health hub_shards ({st} {body[:200]!r})")

                # The colocated references, served alone before any traffic.
                refs = [await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    dist_engine_alone(engine, p, DIST_OSL), server.loop)) for p in prompts]
                # The same traffic through a colocated HTTP edge on A's
                # engine (fresh prompts of the same length, one at a time):
                # the distributed path's cost over it is the hop's.
                colocated = asyncio.run_coroutine_threadsafe(
                    dist_colocated_http(engine, dist_prompts(DIST_PROMPTS, DIST_ISL, 13)),
                    server.loop)
                out["colocated_http_ttft_ms"], out["colocated_http_itl_ms"] = (
                    await asyncio.wrap_future(colocated))
                # Warm B's programs (it captures at first use) and both
                # workers' paths: the round-robin frontend alternates.
                warm = dist_prompts(4, DIST_ISL, 5)
                for p in warm:
                    await dist_complete(rr, p, DIST_OSL)
                await asyncio.sleep(1.5)

                graphs0 = dict(engine.compile_counts())
                zero_kernel_counts()
                torch.cuda.synchronize = counting_sync
                t_traffic = time.perf_counter()

                # 1. prefix routing: first passes, then each prefix again.
                first, first_ttft, first_itl = [], [], []
                for i, p in enumerate(prompts):
                    st, text, fin, used, ttft, itl, _ = await dist_complete(kv, p, DIST_OSL)
                    h = await next_hit()
                    first.append(h["worker_id"])
                    first_ttft.append(ttft)
                    first_itl.append(itl)
                    check(st == 200 and fin == "length" and used == DIST_OSL,
                          f"first pass {i}: {st} {fin}/{used}")
                    ref_toks = refs[i][0]
                    same_text = text == dist_text(ref_toks)
                    # The sealed blocks of prompt + output (the last token
                    # is never fed back) name the output ids through their
                    # chained hashes; wait for the worker's last events.
                    chain = set(tok_mod.fast_sequence_hashes(p + ref_toks[:DIST_OSL - 1], PS))
                    for _ in range(50):
                        if chain <= stored.get(h["worker_id"], set()):
                            break
                        await asyncio.sleep(0.1)
                    same_chain = chain <= stored.get(h["worker_id"], set())
                    check(same_text and same_chain,
                          f"first pass {i} on {name.get(h['worker_id'])}: identical to the "
                          f"colocated stream (text {same_text}, sealed chain of "
                          f"{len(chain)} blocks {same_chain})")
                before_b = (latest.get(wid_b) or {}).get("gpu_prefix_cache_hit_rate", 0.0)
                repeats = []
                for i, p in enumerate(prompts):
                    a0 = engine.kv.matched_blocks
                    rp = p + dist_prompts(1, DIST_REPEAT_NEW, 100 + i)[0]
                    st, _, fin, used, ttft, _, _ = await dist_complete(kv, rp, DIST_REPEAT_OSL)
                    h = await next_hit()
                    repeats.append((h["worker_id"], h["overlap_blocks"], ttft))
                    gained = engine.kv.matched_blocks - a0
                    check(st == 200 and h["worker_id"] == first[i]
                          and h["overlap_blocks"] >= DIST_ISL // PS,
                          f"repeat {i}: routed to {name.get(h['worker_id'])} with "
                          f"{h['overlap_blocks']} blocks (first pass on {name.get(first[i])})")
                    if first[i] == wid_a:
                        check(gained >= DIST_ISL // PS, f"repeat {i}: A's prefix hits +{gained}")
                    else:
                        check(gained == 0, f"repeat {i}: A's prefix hits unchanged ({gained})")
                if wid_b in first:
                    await asyncio.sleep(1.5)  # one metrics period
                    after_b = (latest.get(wid_b) or {}).get("gpu_prefix_cache_hit_rate", 0.0)
                    check(after_b > before_b, f"B's prefix hit rate rose ({before_b} -> {after_b})")
                out["first"] = [name.get(w) for w in first]
                out["first_ttft_ms"] = [x * 1e3 for x in first_ttft]
                out["first_itl_ms"] = [x * 1e3 for x in first_itl]
                out["repeats"] = [(name.get(w), o, t * 1e3) for w, o, t in repeats]
                out["colocated_ttft_ms"] = [r[1] * 1e3 for r in refs]
                out["colocated_itl_ms"] = [r[2] * 1e3 for r in refs]

                # Repeat TTFT, kv against round_robin, on fresh prefixes.
                turns = []
                for turn in range(DIST_TURNS):
                    fresh = dist_prompts(DIST_TURN_PROMPTS, DIST_ISL, 200 + turn)
                    for p in fresh:
                        await dist_complete(kv, p, 1)
                        await next_hit()
                    ttfts = {"kv": [], "round_robin": []}
                    order = ("round_robin", "kv") if turn % 2 == 0 else ("kv", "round_robin")
                    for router in order:
                        for j, p in enumerate(fresh):
                            rp = p + dist_prompts(1, DIST_REPEAT_NEW, 300 + 10 * turn + j)[0]
                            r = await dist_complete(fronts[router], rp, DIST_REPEAT_OSL)
                            check(r[0] == 200, f"turn {turn} {router} repeat {j}: {r[0]}")
                            ttfts[router].append(r[4] * 1e3)
                            if router == "kv":
                                await next_hit()
                    turns.append({k: statistics.median(v) for k, v in ttfts.items()})
                out["turns"] = turns

                # 2. load: concurrent streams of 512-2048 ids.
                await asyncio.sleep(1.5)  # idle metrics before the burst
                rng = random.Random(21)
                load = [dist_prompts(1, rng.randrange(DIST_LOAD_ISL[0], DIST_LOAD_ISL[1] + 1), 400 + i)[0]
                        for i in range(DIST_LOAD)]
                t = time.perf_counter()
                results = await asyncio.gather(*(dist_complete(kv, p, DIST_OSL) for p in load))
                out["load_wall_s"] = time.perf_counter() - t
                load_hits = [await next_hit() for _ in load]
                per = {n: sum(1 for h in load_hits if h["worker_id"] == w) for w, n in name.items()}
                out["load_per_worker"] = per
                out["load_tok_s"] = DIST_LOAD * DIST_OSL / out["load_wall_s"]
                for i, r in enumerate(results):
                    check(r[0] == 200 and r[2] == "length" and r[3] == DIST_OSL,
                          f"load stream {i}: {r[0]} {r[2]}/{r[3]}")
                check(all(v >= DIST_LOAD_MIN_PER_WORKER for v in per.values()),
                      f"each worker took at least {DIST_LOAD_MIN_PER_WORKER} streams ({per})")
                out["launches"] = kernel_counts()
                out["traffic_s"] = time.perf_counter() - t_traffic

                # 3. failover: streams whose prefixes live on B (by the
                # index), one greedy stream each; B is killed mid-stream.
                def on_b(p):
                    scores = core.indexer.find_matches(p).scores
                    return scores.get(wid_b, 0) >= len(p) // PS - 1 and not scores.get(wid_a)

                victims = [p for p in load + prompts if on_b(p)][:DIST_FAILOVER]
                check(len(victims) == DIST_FAILOVER, f"{len(victims)} prefixes on B to fail over")
                b_blocks = len(core.indexer._index._by_worker.get(wid_b, ()))
                st, _, body, _ = await http_call(kv, "GET", "/metrics")
                resumes0 = parse_prometheus(body.decode()).get(
                    ("dynamo_tpu_resilience_stream_resumes_total", ()), 0.0)
                glyphs = [0] * len(victims)
                killed = {}

                def on_text(i):
                    def f(text):
                        glyphs[i] = len(text)
                        if not killed and min(glyphs) >= DIST_KILL_AFTER:
                            worker_b.p.send_signal(signal.SIGKILL)
                            killed["at"] = time.monotonic()
                            killed["glyphs"] = list(glyphs)
                    return f

                ref_fail = [await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    dist_engine_alone(engine, p, DIST_OSL), server.loop)) for p in victims]
                t = time.perf_counter()
                fo = await asyncio.gather(*(dist_complete(kv, p, DIST_OSL, on_text(i))
                                            for i, p in enumerate(victims)))
                out["failover_wall_s"] = time.perf_counter() - t
                fo_hits = [await next_hit() for _ in victims]
                check(all(h["worker_id"] == wid_b for h in fo_hits),
                      f"the failover streams were routed to B "
                      f"({[name.get(h['worker_id']) for h in fo_hits]})")
                check(bool(killed), "B was killed mid-stream")
                for i, r in enumerate(fo):
                    check(r[0] == 200 and r[2] == "length" and r[3] == DIST_OSL,
                          f"failover stream {i}: {r[0]} {r[2]}/{r[3]}")
                out["failover_identical"] = [r[1] == dist_text(ref[0])
                                             for r, ref in zip(fo, ref_fail)]
                # The resume's stall as the client sees it: each stream's
                # longest wait between content chunks (B's death, the
                # re-dispatch, A's prefill of prompt + delivered tokens).
                out["failover_gap_ms"] = [r[6] * 1e3 for r in fo]
                out["failover_kill_glyphs"] = killed.get("glyphs")
                st, _, body, _ = await http_call(kv, "GET", "/metrics")
                resumes1 = parse_prometheus(body.decode()).get(
                    ("dynamo_tpu_resilience_stream_resumes_total", ()), 0.0)
                out["resumes"] = resumes1 - resumes0
                check(resumes1 - resumes0 == DIST_FAILOVER,
                      f"/metrics stream resumes rose by {DIST_FAILOVER} ({resumes0} -> {resumes1})")
                out["graphs"] = (graphs0, dict(engine.compile_counts()))
                out["syncs"] = syncs[0]
                torch.cuda.synchronize = real_sync
                # B leaves discovery within the lease TTL plus 1 s.
                gone = None
                while killed and time.monotonic() - killed["at"] < DIST_LEASE_TTL_S + 5:
                    keys = await hub.kv_get_prefix(f"instances/{ns}/{comp}/{ep}/")
                    if not any(k.endswith(f"/{wid_b}") for k in keys):
                        gone = time.monotonic() - killed["at"]
                        break
                    await asyncio.sleep(0.1)
                out["b_gone_s"] = gone
                check(gone is not None and gone <= DIST_LEASE_TTL_S + 1,
                      f"B left discovery within {DIST_LEASE_TTL_S + 1} s of the kill ({gone})")
                for _ in range(50):
                    if wid_b not in client.instance_ids:
                        break
                    await asyncio.sleep(0.1)
                core.select(victims[0])  # the router prunes departed workers here
                left = len(core.indexer._index._by_worker.get(wid_b, ()))
                out["b_index_blocks"] = (b_blocks, left)
                check(b_blocks > 0 and left == 0,
                      f"the router index holds no block of B afterwards ({b_blocks} -> {left})")
                r = await dist_complete(kv, victims[0], 8)
                h = await next_hit()
                check(r[0] == 200 and h["worker_id"] == wid_a,
                      f"after B left, its prefix routes to A ({r[0]}, {name.get(h['worker_id'])})")
            finally:
                torch.cuda.synchronize = real_sync
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                for sub in (hits, kv_sub, fpm_sub):
                    await sub.aclose()
                await core.stop()
                await client.close()
                await rt.close()

        asyncio.run(phase())
    finally:
        torch.cuda.synchronize = real_sync
        try:
            if server is not None:
                server.stop()
        finally:
            for c in reversed(children):
                c.stop()
    launches = out.get("launches") or {"decode_attention": 0, "prefill_attention": 0}
    check(all(v > 0 for v in launches.values()), f"worker A launched both kernels ({launches})")
    g0, g1 = out.get("graphs", ({}, {}))
    check(g0 == g1, f"worker A captured no graph while serving ({g0} -> {g1})")
    check(out.get("syncs") == 0, f"no torch.cuda.synchronize on worker A while serving "
                                 f"({out.get('syncs')})")
    out["wall_s"] = time.perf_counter() - t_phase

    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    numbers = {
        "card": CARD, "hash_ms_2048_ids": out.get("hash_ms"), "hash_path": out.get("hash_path"),
        "hash_numpy_ms_2048_ids": out.get("hash_numpy_ms"),
        "colocated_http_ttft_ms_p50": med(out.get("colocated_http_ttft_ms", [])),
        "colocated_http_itl_ms_p50": med(out.get("colocated_http_itl_ms", [])),
        "first_pass_workers": out.get("first"),
        "first_pass_ttft_ms_p50": med(out.get("first_ttft_ms", [])),
        "first_pass_itl_ms_p50": med(out.get("first_itl_ms", [])),
        "colocated_alone_ttft_ms_p50": med(out.get("colocated_ttft_ms", [])),
        "colocated_alone_itl_ms_p50": med(out.get("colocated_itl_ms", [])),
        "repeats": out.get("repeats"), "repeat_ttft_turns_ms": out.get("turns"),
        "load_tok_s": out.get("load_tok_s"), "load_per_worker": out.get("load_per_worker"),
        "failover_resumes": out.get("resumes"),
        "failover_identical": out.get("failover_identical"),
        "failover_wall_s": out.get("failover_wall_s"),
        "failover_gap_ms": out.get("failover_gap_ms"),
        "failover_kill_glyphs": out.get("failover_kill_glyphs"), "b_gone_s": out.get("b_gone_s"),
        "b_index_blocks": out.get("b_index_blocks"), "launches_a": launches,
        "graphs_a": out.get("graphs"), "syncs_a": out.get("syncs"),
        "phase_s": out["wall_s"],
    }
    log("dist " + json.dumps(numbers))
    return not fails, launches, numbers


DISAGG_PREFILL_ENDPOINT = "dyn://dynamo.TorchWorker.prefill"
DISAGG_THRESHOLD = 512  # --max-local-prefill of the decode worker
DISAGG_ISL = 2040  # 127 full blocks and an 8-id tail: D prefills the tail
DISAGG_OSL = 64
DISAGG_PROMPTS, DISAGG_LIVE, DISAGG_OVERLAP, DISAGG_WARM = 8, 4, 4, 2
# The stream decoding under the imports.  It must outlast them: a 1 s lead
# and DISAGG_OVERLAP remote prompts took up to ~9 s on a slow host, and at
# PATH_CUT_LAYERS a fused dispatch of 8 tokens takes ~40 ms, so 3072 tokens
# decode for ~15 s (1536 did at the full 32 layers).
DISAGG_LONG_ISL, DISAGG_LONG_OSL = 256, 3072
DISAGG_CHECK_BLOCK = 100  # the block whose pages are held bitwise
DISAGG_CHUNK_RE = re.compile(r"next chunk to \S+: (\d+) blocks")


def disagg_path(torch):
    """Phase i: the README's disaggregated deployment on the card.  Returns
    (ok, launches, numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.integrity import block_checksum
    from dynamo_tpu_torch.engine.transfer import transfer_blocks_device
    from dynamo_tpu_torch.llm.disagg import KV_IMPORT_ENDPOINT, DisaggConfig, publish_config
    from dynamo_tpu_torch.llm.metrics import kv_integrity_metrics
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.client import Client
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.engine import Context, collect
    from dynamo_tpu_torch.runtime.faultinject import faults
    from dynamo_tpu_torch.tokens import hash_token_blocks

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"disagg check FAILED: {what}")

    hub_port = _free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    ns_d, comp_d, _ = parse_endpoint_path(DIST_ENDPOINT)
    children, server, prefill, planner_result = [], None, None, (False, None, None)
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    def on_d(coro, timeout=600):
        """Run ``coro`` on D's event loop (its engine's locks live there)."""
        return asyncio.run_coroutine_threadsafe(coro, server.loop).result(timeout)

    async def alone(engine, prompt, n, salt=None):
        req = PreprocessedRequest(
            token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
            annotations={"kv_salt": salt} if salt else {},
        ).to_dict()
        return [t for item in await collect(await engine.generate(Context(req)))
                for t in item["token_ids"]]

    t_phase = time.perf_counter()
    try:
        children.append(Child("hub", ["hub", "--host", "127.0.0.1", "--port", str(hub_port)]))
        children[-1].wait_line("hub listening", 120)
        front = Child("http", ["http", "--hub", hub_addr, "--host", "127.0.0.1", "--port", "0"])
        children.append(front)
        prefill = Child("prefill worker P", ["run", f"in={DISAGG_PREFILL_ENDPOINT}",
                                             *DIST_ENGINE_ARGV, "--hub", hub_addr,
                                             "--disagg", "prefill"])
        children.append(prefill)
        fport = int(front.wait_line("OpenAI frontend on", 120).rsplit(":", 1)[1])
        # D: the CLI's own ``--disagg decode`` code in this process, so its
        # kernel launches are counted; warmed before any traffic.
        t = time.perf_counter()
        server = CliServer(["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV, "--hub", hub_addr,
                            "--disagg", "decode", "--max-local-prefill", str(DISAGG_THRESHOLD)])
        graphs = server.warmup()
        out["d_up_s"] = time.perf_counter() - t
        engine = server.engine
        wid_p = int(prefill.wait_line("worker ", 300).split()[1])
        out["p_up_s"] = time.perf_counter() - t_phase
        log(f"disagg: hub {hub_addr}, frontend :{fport}, decode worker D "
            f"{server.service.worker_id} (in this process, up and warmed in {out['d_up_s']:.1f} "
            f"s, graphs {graphs}), prefill worker P {wid_p} (pid {prefill.p.pid}, registered "
            f"{out['p_up_s']:.1f} s after the phase began)")

        prompts = dist_prompts(DISAGG_PROMPTS, DISAGG_ISL, 31)
        live = dist_prompts(2 * DISAGG_LIVE, DISAGG_ISL, 32)
        overlap = dist_prompts(DISAGG_OVERLAP, DISAGG_ISL, 33)
        fault_prompt = dist_prompts(1, DISAGG_ISL, 34)[0]
        warm = dist_prompts(DISAGG_WARM, DISAGG_ISL, 35)
        long_prompt = dist_prompts(1, DISAGG_LONG_ISL, 36)[0]
        chain0 = [tb.sequence_hash for tb in hash_token_blocks(prompts[0], PS)]
        salt = "disagg-reference"
        full = DISAGG_ISL // PS

        async def reference(p, hit_blocks=None, pages_of=None, n=DISAGG_OSL):
            """D's engine serving ``p`` alone, under a KV salt (no prefix
            the traffic could hit), in the shapes the path under test gives
            it (the card's GEMMs are not batch-invariant): with
            ``hit_blocks`` None one pass, prefilling the whole prompt in
            512-id chunks (local prefill); otherwise a first pass prefills
            it so in P's chunking and seals its blocks, those from
            ``hit_blocks`` on are evicted, and the stream then hits the
            rest and prefills the remainder (the remote path: all full
            blocks hit, the 8-id tail prefilled).  ``pages_of``: a block
            whose pages after the first pass are returned too."""
            pages = None
            if hit_blocks is not None:
                await alone(engine, p, 1, salt=salt)
                chain = [tb.sequence_hash for tb in hash_token_blocks(p, PS, salt)]
                if pages_of is not None:
                    pages = await block_pages(engine, chain[pages_of])
                engine.kv.evict_hashes(chain[hit_blocks:])
            return await alone(engine, p, n, salt=salt), pages

        refs = {}
        t = time.perf_counter()
        refs[tuple(prompts[0])], ref_pages = on_d(reference(prompts[0], full, DISAGG_CHECK_BLOCK))
        check(ref_pages is not None, "the reference block's pages were read")
        for p in prompts[1:] + live[DISAGG_LIVE:] + overlap:
            refs[tuple(p)] = on_d(reference(p, full))[0]
        for p in live[:DISAGG_LIVE]:
            refs[tuple(p)] = on_d(reference(p))[0]
        out["refs_s"] = time.perf_counter() - t

        async def phase():
            rt = await DistributedRuntime.connect(hub_addr)
            ns, comp, _ = parse_endpoint_path(DIST_ENDPOINT)
            stats_client = await rt.namespace(ns).component(comp).endpoint(
                "disagg_stats").client()
            await stats_client.wait_for_instances(30)

            async def stats():
                return (await collect(await stats_client.generate(Context({}))))[0]

            async def serve(p, n=DISAGG_OSL, what=""):
                r = await dist_complete(fport, p, n)
                check(r[0] == 200 and r[2] == "length" and r[3] == n,
                      f"{what}: {r[0]} {r[2]}/{r[3]}")
                return r

            def same(r, p, what):
                ok = r[1] == dist_text(refs[tuple(p)])
                check(ok, f"{what}: identical to D's local-prefill stream served alone")
                return ok

            try:
                for _ in range(300):
                    if (await rt.hub.kv_get_prefix("models/")):
                        break
                    await asyncio.sleep(0.1)
                # Warm P's programs (it captures at first use) through the
                # remote path.
                for p in warm:
                    await serve(p, 8, "warm-up")
                s0 = await stats()
                v0 = kv_integrity_metrics.verified_total["wire"]
                graphs0 = dict(engine.compile_counts())
                n_parts0 = len(engine.transfer_parts)
                zero_kernel_counts()
                torch.cuda.synchronize = counting_sync
                t_traffic = time.perf_counter()

                # 1. remote prefill, one prompt at a time.
                remote_ttft, remote_itl, identical = [], [], []
                for i, p in enumerate(prompts):
                    r = await serve(p, what=f"remote {i}")
                    remote_ttft.append(r[4] * 1e3)
                    remote_itl.append(r[5] * 1e3)
                    identical.append(same(r, p, f"remote {i}"))
                    if i == 0:
                        got = await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                            block_pages(engine, chain0[DISAGG_CHECK_BLOCK]), server.loop))
                        out["pages_equal"] = (
                            got is not None and ref_pages is not None
                            and block_checksum(got) == block_checksum(ref_pages)
                            and torch.equal(got.view(torch.uint8), ref_pages.view(torch.uint8)))
                        check(out["pages_equal"], f"imported block {DISAGG_CHECK_BLOCK}'s "
                                                  "pages bitwise equal to D's own")
                s1 = await stats()
                v1 = kv_integrity_metrics.verified_total["wire"]
                out["remote"] = {k: s1[k] - s0[k] for k in
                                 ("remote_prefills", "local_prefills", "degraded_fallbacks")}
                check(out["remote"] == {"remote_prefills": DISAGG_PROMPTS, "local_prefills": 0,
                                        "degraded_fallbacks": 0},
                      f"{DISAGG_PROMPTS} remote prefills, none local or degraded ({out['remote']})")
                out["wire_verified"] = v1 - v0
                check(v1 - v0 == DISAGG_PROMPTS * (DISAGG_ISL // PS),
                      f"wire-verified blocks {v1 - v0} == {DISAGG_PROMPTS} x {DISAGG_ISL // PS}")
                parts = list(engine.transfer_parts)[n_parts0:]
                out["chunks"] = [n for kind, n, _ in parts if kind == "inject"]
                out["inject_parts_ms"] = {
                    k: statistics.median(pp[k] for kind, _, pp in parts if kind == "inject") * 1e3
                    for k in ("parse", "verify", "upload", "hold")}
                out["remote_ttft_ms"], out["remote_itl_ms"] = remote_ttft, remote_itl

                # 2. the live threshold: 4096 (local), then back to 512.
                live_ttft = {"local": [], "remote": []}
                for j, (limit, kind) in enumerate(((4096, "local"), (DISAGG_THRESHOLD, "remote"))):
                    await publish_config(rt.hub, DIST_MODEL,
                                         DisaggConfig(max_local_prefill_length=limit))
                    await asyncio.sleep(0.5)  # the hub's watch delivers the new threshold
                    sa = await stats()
                    for p in live[j * DISAGG_LIVE:(j + 1) * DISAGG_LIVE]:
                        r = await serve(p, what=f"live {kind}")
                        live_ttft[kind].append(r[4] * 1e3)
                        same(r, p, f"live {kind}")
                    sb = await stats()
                    moved = (sb["remote_prefills"] - sa["remote_prefills"],
                             sb["local_prefills"] - sa["local_prefills"])
                    want = (0, DISAGG_LIVE) if kind == "local" else (DISAGG_LIVE, 0)
                    check(moved == want, f"threshold {limit}: (remote, local) {moved} == {want}")
                out["live_ttft_ms"] = live_ttft

                # 3. the overlap: imports while a long stream decodes.
                engine.step_trace.clear()
                long_task = asyncio.ensure_future(dist_complete(fport, long_prompt, DISAGG_LONG_OSL))
                await asyncio.sleep(1.0)
                for p in overlap:
                    r = await serve(p, what="overlap")
                    same(r, p, "overlap")
                long_done = long_task.done()
                lr = await long_task
                check(lr[0] == 200 and lr[3] == DISAGG_LONG_OSL, f"the long stream: {lr[0]} {lr[3]}")
                check(not long_done, "the long stream was still decoding after the imports")
                trace = list(engine.step_trace)
                kinds = [k for k, *_ in trace]
                inj = [i for i, k in enumerate(kinds) if k == "inject"]
                between = [k for k in kinds[inj[0]:inj[-1]] if k in ("decode_dispatch", "decode_wait")] \
                    if inj else []
                check(len(inj) >= DISAGG_OVERLAP and between,
                      f"decode dispatches between D's inject entries ({len(inj)} injects, "
                      f"{len(between)} decode entries between)")
                holds = [t for k, t, *_ in trace if k == "inject"]
                waits = [t for k, t, *_ in trace if k == "decode_wait"]
                out["overlap"] = {"injects": len(inj), "decode_between": len(between),
                                  "hold_ms_max": max(holds) * 1e3 if holds else None,
                                  "hold_ms_p50": statistics.median(holds) * 1e3 if holds else None,
                                  "decode_wait_ms_p50": statistics.median(waits) * 1e3 if waits else None,
                                  "fused_ms": engine.decode_spans.seconds * 1e3
                                  / max(1, engine.decode_spans.count)}

                # 4. the wire fault: a byte flipped in the second chunk.
                calls, armed = [0], {}
                inject = engine.inject_blocks

                async def faulty(tokens, payload, salt=None, donor=None):
                    calls[0] += 1
                    last = int(payload.get("start_block", 0)) + int(payload["n_blocks"]) >= \
                        DISAGG_ISL // PS
                    if not armed and (calls[0] == 2 or last):
                        armed["start"] = int(payload.get("start_block", 0))
                        faults.arm("kv_corrupt", match="wire", count=1)
                    return await inject(tokens, payload, salt, donor)

                engine.inject_blocks = faulty
                refs.pop(tuple(fault_prompt), None)
                wire_key = ("dynamo_tpu_kv_integrity_corrupt_total", (("plane", "wire"),))
                c0 = kv_integrity_metrics.corrupt_total["wire"]
                mc0 = parse_prometheus(kv_integrity_metrics.render()).get(wire_key)
                m0 = engine.kv.matched_blocks
                try:
                    r = await serve(fault_prompt, what="wire fault")
                finally:
                    engine.inject_blocks = inject
                    faults.reset()
                prefix = engine.kv.matched_blocks - m0
                fault_stream = r
                # The integrity group as this process's /metrics renders it.
                mc1 = parse_prometheus(kv_integrity_metrics.render()).get(wire_key)
                out["fault"] = {"armed_at_block": armed.get("start"), "prefix_hit": prefix,
                                "corrupt": kv_integrity_metrics.corrupt_total["wire"] - c0,
                                "metrics_corrupt": None if mc0 is None else mc1 - mc0}
                check(out["fault"]["corrupt"] == 1 and prefix == armed.get("start"),
                      f"the wire fault: the verified prefix ({armed.get('start')} blocks) sealed "
                      f"and hit ({prefix}), one corruption counted ({out['fault']['corrupt']})")
                check(out["fault"]["metrics_corrupt"] == 1,
                      f"the wire corruption on the integrity /metrics group "
                      f"({out['fault']['metrics_corrupt']})")
                s2 = await stats()
                out["degraded_total"] = s2["degraded_fallbacks"] - s0["degraded_fallbacks"]
                check(out["degraded_total"] == 0, f"no degraded fallback ({out['degraded_total']})")
                out["launches"] = kernel_counts()
                out["graphs"] = (graphs0, dict(engine.compile_counts()))
                out["syncs"] = syncs[0]
                torch.cuda.synchronize = real_sync
                out["traffic_s"] = time.perf_counter() - t_traffic
                # The fault's reference (after the counted window): the
                # verified prefix hit, the rest prefilled.
                refs[tuple(fault_prompt)] = (await asyncio.wrap_future(
                    asyncio.run_coroutine_threadsafe(
                        reference(fault_prompt, armed.get("start", 0)), server.loop)))[0]
                same(fault_stream, fault_prompt, "wire fault")
                out["import_path"] = (await rt.hub.kv_get_prefix(
                    f"instances/{ns}/{comp}/{KV_IMPORT_ENDPOINT}/"))
            finally:
                torch.cuda.synchronize = real_sync
                await stats_client.close()
                await rt.close()

        asyncio.run(phase())
        # Phase l rides this stack while it is up and warm; D's kv_import
        # is registered anew by its flip back, so its address is read after.
        planner_result = planner_path(torch, SimpleNamespace(
            server=server, engine=engine, hub_addr=hub_addr, front=front, children=children,
            wid_p=wid_p, reference=reference))

        async def d_import():
            rt = await DistributedRuntime.connect(hub_addr)
            try:
                return await rt.hub.kv_get_prefix(f"instances/{ns_d}/{comp_d}/{KV_IMPORT_ENDPOINT}/"
                                                  f"{server.service.worker_id}")
            finally:
                await rt.close()

        out["import_path"] = asyncio.run(d_import())
        # The largest chunk P's adaptive sizing reached, from its log.
        sizes = [int(m.group(1)) for line in prefill.lines
                 for m in [DISAGG_CHUNK_RE.search(line)] if m]
        out["p_chunk_sizes"] = sizes
        prefill.stop()

        # 5. the same-process direct path: P' beside D in this process.
        t = time.perf_counter()
        src = TorchEngine(EngineConfig(**SERVE_CFG), device=engine.device)
        out["p2_up_s"] = time.perf_counter() - t
        direct = dist_prompts(1, DISAGG_ISL, 37)[0]
        info = next(iter(out["import_path"].values()))

        async def direct_phase():
            await alone(src, direct, 1)
            chain = [tb.sequence_hash for tb in hash_token_blocks(direct, PS)]
            g0 = (dict(src.compile_counts()), dict(engine.compile_counts()))
            c0 = (src.copy_summary(), engine.copy_summary())
            torch.cuda.synchronize = counting_sync
            s0 = syncs[0]
            try:
                # Twice: cold (the first gather of this shape), then warm,
                # D's copy dropped in between.
                t_direct = []
                for _ in range(2):
                    engine.kv.evict_hashes(chain)
                    t0 = time.perf_counter()
                    covered = await transfer_blocks_device(src, engine, direct)
                    t_direct.append((time.perf_counter() - t0) * 1e3)
            finally:
                torch.cuda.synchronize = real_sync
            res = {"covered_blocks": covered // PS, "direct_ms": t_direct,
                   "syncs": syncs[0] - s0,
                   "graphs_same": g0 == (dict(src.compile_counts()), dict(engine.compile_counts()))}
            c1 = (src.copy_summary(), engine.copy_summary())
            res["host_bytes"] = sum(b[k] - a[k] for a, b in zip(c0, c1)
                                    for k in ("h2d_bytes", "d2h_bytes"))
            mism = 0
            for h in chain:
                a = await block_pages(src, h)
                b = await block_pages(engine, h)
                mism += int(a is None or b is None or not torch.equal(
                    a.view(torch.uint8), b.view(torch.uint8)))
            res["pages_mismatched"] = mism
            # The host-staged path for the same 127 blocks: P''s export,
            # then the wire into D's kv_import endpoint (codec and TCP),
            # then D's inject; D's copy dropped first.
            engine.kv.evict_hashes(chain)
            n0 = len(engine.transfer_parts)
            t0 = time.perf_counter()
            payload = await src.export_prompt_blocks(direct)
            t_export = time.perf_counter() - t0
            client = Client.static(info["address"], info["path"])
            t0 = time.perf_counter()
            acks = await collect(await client.generate(Context({
                "transfer_id": "direct-vs-host", "token_ids": list(direct),
                "payload": payload, "last": True})))
            t_wire_inject = time.perf_counter() - t0
            inj = [pp for kind, _, pp in list(engine.transfer_parts)[n0:] if kind == "inject"]
            exp = [pp for kind, _, pp in list(src.transfer_parts) if kind == "export"][-1]
            inject_s = sum(inj[-1].values()) if inj else float("nan")
            res.update(host_export_ms=t_export * 1e3,
                       host_export_parts_ms={k: v * 1e3 for k, v in exp.items()},
                       host_wire_ms=(t_wire_inject - inject_s) * 1e3,
                       host_inject_parts_ms={k: v * 1e3 for k, v in (inj[-1] if inj else {}).items()},
                       host_total_ms=(t_export + t_wire_inject) * 1e3,
                       host_acked_tokens=acks[0].get("tokens_covered") if acks else None,
                       payload_mib=2 * len(payload["k"]) / 2**20)
            await src.close()
            return res

        out["direct"] = on_d(direct_phase())
        d = out["direct"]
        check(d["covered_blocks"] == DISAGG_ISL // PS,
              f"direct transfer covered {d['covered_blocks']} blocks")
        check(d["pages_mismatched"] == 0, f"direct: pages bitwise equal "
                                          f"({d['pages_mismatched']} blocks differ)")
        check(d["host_bytes"] == 0, f"direct: no host bytes copied ({d['host_bytes']})")
        check(d["graphs_same"], "direct: no graph captured")
        check(d["syncs"] == 0, f"direct: no torch.cuda.synchronize ({d['syncs']})")
        check(d["host_acked_tokens"] == (DISAGG_ISL // PS) * PS,
              f"host-staged: D acked {d['host_acked_tokens']} tokens")
    finally:
        torch.cuda.synchronize = real_sync
        try:
            if server is not None:
                server.stop()
        finally:
            for c in reversed(children):
                c.stop()
    launches = out.get("launches") or {"decode_attention": 0, "prefill_attention": 0}
    check(all(v > 0 for v in launches.values()), f"D launched both kernels ({launches})")
    g0, g1 = out.get("graphs", ({}, {}))
    check(g0 == g1, f"D captured no graph while serving ({g0} -> {g1})")
    check(out.get("syncs") == 0, f"no torch.cuda.synchronize on D while serving "
                                 f"({out.get('syncs')})")
    out["wall_s"] = time.perf_counter() - t_phase

    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    live = out.get("live_ttft_ms", {})
    numbers = {
        "card": CARD, "remote": out.get("remote"), "wire_verified": out.get("wire_verified"),
        "pages_equal": out.get("pages_equal"),
        "remote_ttft_ms_p50": med(out.get("remote_ttft_ms", [])),
        "remote_itl_ms_p50": med(out.get("remote_itl_ms", [])),
        "live_local_ttft_ms_p50": med(live.get("local", [])),
        "live_remote_ttft_ms_p50": med(live.get("remote", [])),
        "chunks_at_d": out.get("chunks"), "p_chunk_sizes": out.get("p_chunk_sizes"),
        "inject_parts_ms_p50": out.get("inject_parts_ms"), "overlap": out.get("overlap"),
        "fault": out.get("fault"), "direct": out.get("direct"), "launches_d": launches,
        "graphs_d": out.get("graphs"), "syncs_d": out.get("syncs"),
        "d_up_s": out.get("d_up_s"), "p_up_s": out.get("p_up_s"), "phase_s": out["wall_s"],
    }
    log("disagg " + json.dumps(numbers))
    return not fails, launches, numbers, planner_result


# ----------------------------------------- l. the planner's role flip


PLAN_STREAM_ISL, PLAN_STREAM_OSL = 256, 2048  # D's one and D2's two live streams
PLAN_SEED = 4545  # D's stream: seeded at MIGRATE_TEMPERATURE, so the categorical kernel runs
PLAN_BURST, PLAN_BURST_OSL = 3, 8  # 2040-id prompts at once through the fresh frontend
PLAN_WARM_OSL = 400  # D's seeded warm-up stream, live while remote prompts land beside it
PLAN_AFTER, PLAN_AFTER_OSL = 4, 16  # remote prompts after the flip, one at a time
PLAN_INTERVAL_S = 0.5
PLAN_TTFT_SLO_MS = 1000.0  # below phase i's remote TTFT: the remote burst breaches it
PLAN_ITL_SLO_MS = 60000.0  # never reached: the decode pool reads cold
PLAN_ENV = {
    "DYN_PLANNER__MAX_PREFILL": "1",  # P alone fills the prefill pool: a breach flips
    "DYN_PLANNER__MIN_DECODE": "1",
    "DYN_PLANNER__TTFT_P95_MS": str(PLAN_TTFT_SLO_MS),
    "DYN_PLANNER__ITL_P95_MS": str(PLAN_ITL_SLO_MS),
    # Nothing enacts pool targets here (no supervisor), and a decode
    # scale-down's cooldown would hold the flip: no scale-down in the phase.
    "DYN_PLANNER__CONFIRM_DOWN_TICKS": "100000",
}
PLAN_TIER_WEIGHTS = {"hbm": 1.0, "host": 0.6, "disk": 0.3, "objstore": 0.1}


def planner_path(torch, ctx):
    """Phase l, on phase i's stack while it is up and warm (the hub, prefill
    worker P, decode worker D in this process): a fresh ``http`` frontend F
    (the edge's rolling windows are counted, not timed, so phase i's
    samples would read as load forever), a second decode worker D2, the
    ``metrics`` aggregator and the planner (``python -m
    dynamo_tpu_torch.planner run --autopilot``, local actuation), all CLI
    subprocesses.  D holds 1 live seeded stream and D2 2 greedy ones; a
    burst of 2040-id prompts through F breaches the TTFT target; the
    planner, started after it, flips D (the decode pool's coldest) to
    prefill: D's watcher drains its stream to D2 through migration and
    starts the prefill worker loop.  4 remote prompts are then prefilled
    by P or D; an operator's ``LocalActuator`` flips D back, and a remote
    prompt decodes on D; a ``PlannerDirectiveWatcher`` here enacts a
    ``set_tier_weights`` directive.  Returns (ok, launches, numbers)."""
    from dynamo_tpu_torch.llm.kv_router.router import PlannerDirectiveWatcher, make_kv_router
    from dynamo_tpu_torch.llm.migration.worker import MigratableWorker
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.planner.actuate import (
        DIRECTIVE_PREFIX, LocalActuator, role_key)
    from dynamo_tpu_torch.planner.policy import Action, Decision, flip_role
    from dynamo_tpu_torch.planner.signals import SignalCollector
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.engine import Context, collect
    from dynamo_tpu_torch.runtime.resilience import metrics as res_metrics

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"planner check FAILED: {what}")

    server, engine, hub_addr = ctx.server, ctx.engine, ctx.hub_addr
    wid_d, wid_p = server.service.worker_id, ctx.wid_p
    ns, comp, ep = parse_endpoint_path(DIST_ENDPOINT)
    real_sync, syncs = torch.cuda.synchronize, [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    def on_d(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, server.loop).result(timeout)

    def request(p, n, seed=None):
        return PreprocessedRequest(
            token_ids=list(p), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(
                temperature=MIGRATE_TEMPERATURE if seed is not None else 0.0, seed=seed),
        ).to_dict()

    # The drain's move, timed where D's watcher runs it.
    moves = []
    migrate_all = MigratableWorker.migrate_all

    async def timed_migrate_all(self, target, *a, **k):
        t0 = time.perf_counter()
        moved = await migrate_all(self, target, *a, **k)
        moves.append({"t0": t0, "t1": time.perf_counter(), "moved": len(moved)})
        return moved

    t_phase = time.perf_counter()
    ctx.front.stop()
    front = Child("http (phase l)", ["http", "--hub", hub_addr, "--host", "127.0.0.1",
                                      "--port", "0"])
    ctx.children.append(front)
    d2 = Child("decode worker D2", ["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV,
                                     "--hub", hub_addr, "--disagg", "decode",
                                     "--max-local-prefill", str(DISAGG_THRESHOLD)])
    ctx.children.append(d2)
    agg = Child("metrics", ["metrics", "--hub", hub_addr, "--component", comp,
                            "--host", "127.0.0.1", "--port", "0"])
    ctx.children.append(agg)
    fport = int(front.wait_line("OpenAI frontend on", 120).rsplit(":", 1)[1])
    aport = int(agg.wait_line("metrics aggregator on", 120).split(":")[-1].split("/")[0])
    wid_d2 = int(d2.wait_line("worker ", 300).split()[1])
    out["d2_up_s"] = time.perf_counter() - t_phase
    log(f"planner: fresh frontend :{fport}, aggregator :{aport}, D {wid_d}, D2 {wid_d2} "
        f"(up {out['d2_up_s']:.1f} s after the phase began), P {wid_p}")

    streams_d2 = dist_prompts(2, PLAN_STREAM_ISL, 41)
    stream_d = dist_prompts(1, PLAN_STREAM_ISL, 42)[0]
    burst = dist_prompts(PLAN_BURST, DISAGG_ISL, 43)
    after = dist_prompts(PLAN_AFTER + 1, DISAGG_ISL, 44)
    warm_long = dist_prompts(2, DISAGG_ISL, 45)
    full = DISAGG_ISL // PS
    planner = None
    state = SimpleNamespace(rt=None, client=None, stats=None)

    async def d_setup():
        """On D's loop (one loop per process dials each worker: the
        service plane keeps one connection per address)."""
        state.rt = await DistributedRuntime.connect(hub_addr)
        state.client = await state.rt.namespace(ns).component(comp).endpoint(ep).client()
        state.stats = await state.rt.namespace(ns).component(comp).endpoint(
            "disagg_stats").client()
        await state.client.wait_for_instances(30)
        for _ in range(300):
            if wid_d2 in state.client.instance_ids and wid_d2 in state.stats.instance_ids:
                return
            await asyncio.sleep(0.1)
        raise RuntimeError(f"D2 {wid_d2} never registered")

    async def d_stream(wid, p, n, seed=None):
        items = []
        async for item in await state.client.generate(Context(request(p, n, seed)),
                                                      worker_id=wid):
            items.append(item)
        toks = [t for it in items for t in it.get("token_ids", [])]
        return toks, (items[-1].get("finish_reason") if items else None)

    async def d_stats(wid):
        return (await collect(await state.stats.generate(Context({}), worker_id=wid)))[0]

    async def d_timed(wid, p, n):
        t0 = time.perf_counter()
        first, toks = None, []
        async for item in await state.client.generate(Context(request(p, n)), worker_id=wid):
            if item.get("token_ids") and first is None:
                first = time.perf_counter() - t0
            toks += item.get("token_ids", [])
        return toks, first

    async def prefill_role_warm(p):
        """D's engine serving ``p`` as its prefill worker loop will (the
        loop's request: no sampling options, one token), so the keys the
        prefill role runs are captured before the counted window."""
        pre = PreprocessedRequest(token_ids=list(p))
        pre.stop_conditions.max_tokens = 1
        pre.stop_conditions.ignore_eos = True
        await collect(await engine.generate(Context(pre.to_dict())))

    async def warm_beside_seeded(prompts):
        seeded = asyncio.ensure_future(d_stream(wid_d, stream_d, PLAN_WARM_OSL, PLAN_SEED))
        await asyncio.gather(*(d_stream(wid_d, p, PLAN_BURST_OSL) for p in prompts))
        await seeded

    def graph_keys():
        return {name: set(getattr(engine.programs, name)._signatures)
                for name in ("step", "multi")}

    async def d_teardown():
        for c in (state.client, state.stats):
            if c is not None:
                await c.close()
        if state.rt is not None:
            await state.rt.close()

    MigratableWorker.migrate_all = timed_migrate_all
    try:
        on_d(d_setup())
        # Warm-up, before the counted window: D2 captures at first use, so
        # it serves a greedy and a seeded stream first (the burst warms its
        # remote path); D serves a seeded stream (its sampled graph keys),
        # a prompt as its prefill loop will run it, and remote prompts
        # beside a seeded row; the references run on D's engine (phase i's same-shape
        # reference: the whole prompt in P's chunking, then the 8-id tail
        # over its 127 sealed blocks).
        t = time.perf_counter()
        on_d(d_stream(wid_d2, streams_d2[0], 24))
        on_d(d_stream(wid_d2, stream_d, 24, PLAN_SEED))
        on_d(d_stream(wid_d, stream_d, 24, PLAN_SEED))
        on_d(prefill_role_warm(warm_long[0]))
        # The burst's prompts that land on D run their tail prefill beside
        # the seeded row: steps keyed by a small bucket with sampling on.
        on_d(warm_beside_seeded(warm_long))
        refs = {tuple(p): on_d(ctx.reference(p, full, n=PLAN_AFTER_OSL))[0] for p in after}
        out["warm_s"] = time.perf_counter() - t

        async def phase():
            nonlocal planner
            rt = await DistributedRuntime.connect(hub_addr)
            component = rt.namespace(ns).component(comp)
            watcher = core = None
            collector = await SignalCollector(component, model=DIST_MODEL).start()
            try:
                graphs0 = dict(engine.compile_counts())
                keys0 = graph_keys()
                zero_kernel_counts()
                zero_noise_launches()
                torch.cuda.synchronize = counting_sync
                splices0 = res_metrics.migration_splices_total
                resumes0 = res_metrics.stream_resumes_total
                t_window = time.perf_counter()

                # 1. the live streams: 1 on D (seeded), 2 on D2 (greedy).
                def start(wid, p, seed=None):
                    return asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                        d_stream(wid, p, PLAN_STREAM_OSL, seed), server.loop))

                live = [start(wid_d, stream_d, PLAN_SEED)] + [start(wid_d2, p) for p in streams_d2]
                # 2. the burst through the fresh frontend (P alone prefills it).
                t = time.perf_counter()
                br = await asyncio.gather(*(dist_complete(fport, p, PLAN_BURST_OSL) for p in burst))
                out["burst_s"] = time.perf_counter() - t
                check(all(r[0] == 200 and r[3] == PLAN_BURST_OSL for r in br),
                      f"the burst: {[(r[0], r[3]) for r in br]}")
                out["burst_ttft_ms"] = sorted(r[4] * 1e3 for r in br)
                async def d_live():
                    return list(engine.live_request_ids())

                live_now = await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    d_live(), server.loop))
                check(len(live_now) == 1, f"D holds its one live stream ({len(live_now)})")
                # 3. the planner, live: its first ticks see the pools and the
                # edge's percentiles, then the breach.
                planner = Child("planner", ["run", "--hub", hub_addr, "--component", comp,
                                            "--model", DIST_MODEL, "--interval",
                                            str(PLAN_INTERVAL_S), "--autopilot", "--host",
                                            "127.0.0.1", "--port", "0"],
                                env=PLAN_ENV, module="dynamo_tpu_torch.planner")
                ctx.children.append(planner)
                pport = int(planner.wait_line("planner on", 120).split(":")[2].split("/")[0])
                t_planner = time.perf_counter()
                ticks, first_pools, put, ack = {}, None, None, None
                end = time.time() + 60
                while time.time() < end and ack is None:
                    st, _, body, _ = await http_call(pport, "GET", "/state")
                    stt = json.loads(body) if st == 200 else {}
                    last = stt.get("last_decision") or {}
                    if last.get("tick") and last["tick"] not in ticks:
                        ticks[last["tick"]] = {"t_s": time.perf_counter() - t_planner,
                                               "pressures": last.get("pressures"),
                                               "signals": last.get("signals"),
                                               "actions": [a.get("kind") for a in
                                                           last.get("actions", [])]}
                    if first_pools is None and ticks:
                        snap = await collector.snapshot()
                        first_pools = {k: list(v.workers) for k, v in snap.pools.items()}
                    v = await rt.hub.kv_get(role_key(wid_d))
                    if put is None and v:
                        put = (time.perf_counter(), v)
                    if v and v.get("acked"):
                        ack = (time.perf_counter(), v)
                        after_counts = kernel_counts()
                    await asyncio.sleep(0.05)
                out["ticks"] = ticks
                out["first_pools"] = first_pools
                check(first_pools == {"prefill": [wid_p], "decode": sorted([wid_d, wid_d2])},
                      f"the pools before the flip ({first_pools})")
                sig = [t_["signals"] for t_ in ticks.values() if t_.get("signals")]
                check(any(s.get("prefill_workers") == 1 and s.get("decode_workers") == 2
                          for s in sig), "the planner's /state: 1 prefill and 2 decode workers")
                check(any(isinstance(s.get("ttft_p95_ms"), (int, float)) and s["ttft_p95_ms"] > 0
                          and isinstance(s.get("itl_p95_ms"), (int, float)) for s in sig),
                      "the edge's TTFT and ITL percentiles reached the planner")
                flips = [(k, v) for k, v in ticks.items() if "flip_role" in v["actions"]]
                check(put is not None and put[1].get("role") == "prefill",
                      f"the planner wrote flip_role(D, prefill) ({put and put[1]})")
                check(ack is not None and ack[1].get("from") == "decode",
                      f"D acked the flip ({ack and ack[1]})")
                if put is None or ack is None:
                    return
                out["flip_tick"] = put[1].get("tick")
                out["put_to_ack_s"] = ack[0] - put[0]
                out["planner_to_put_s"] = put[0] - t_planner
                breaching = {k: v["pressures"] for k, v in ticks.items()
                             if (v.get("pressures") or {}).get("prefill", 0) >= 1.15}
                out["breaching_ticks"] = breaching
                check(flips or breaching, f"breaching ticks seen ({ticks})")
                out["moves"] = [{"move_s": m["t1"] - m["t0"], "moved": m["moved"]} for m in moves]
                check(len(moves) == 1 and moves[0]["moved"] == 1,
                      f"D's drain migrated its one live stream ({out['moves']})")
                # The planner's view after the flip.
                for _ in range(40):
                    snap = await collector.snapshot()
                    pools = {k: sorted(v.workers) for k, v in snap.pools.items()}
                    if pools.get("prefill") == sorted([wid_p, wid_d]):
                        break
                    await asyncio.sleep(0.25)
                out["pools_after"] = pools
                check(pools == {"prefill": sorted([wid_p, wid_d]), "decode": [wid_d2]},
                      f"the pools after the flip ({pools})")
                for _ in range(40):
                    st, _, body, _ = await http_call(pport, "GET", "/state")
                    stt = json.loads(body)
                    sig_after = ((stt.get("last_decision") or {}).get("signals") or {})
                    if sig_after.get("prefill_workers") == 2:
                        break
                    await asyncio.sleep(0.25)
                out["planner_state_decisions"] = stt.get("decisions")
                check(sig_after.get("prefill_workers") == 2 and sig_after.get("decode_workers") == 1,
                      f"the planner's /state after the flip ({sig_after})")
                # 4. the next remote prompts, one at a time, to D2.
                counts_ack = after_counts
                after_ttft = []
                stats0 = {wid_d2: await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    d_stats(wid_d2), server.loop))}
                for i, p in enumerate(after[:PLAN_AFTER]):
                    toks, first = await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                        d_timed(wid_d2, p, PLAN_AFTER_OSL), server.loop))
                    after_ttft.append(first * 1e3 if first is not None else float("nan"))
                    check(toks == refs[tuple(p)],
                          f"remote prompt {i} after the flip identical to the same shapes alone")
                out["after_ttft_ms"] = after_ttft
                s1 = await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    d_stats(wid_d2), server.loop))
                out["d2_remote"] = {k: s1[k] - stats0[wid_d2][k] for k in
                                    ("remote_prefills", "local_prefills", "degraded_fallbacks")}
                check(out["d2_remote"] == {"remote_prefills": PLAN_AFTER, "local_prefills": 0,
                                           "degraded_fallbacks": 0},
                      f"the {PLAN_AFTER} prompts prefilled remotely ({out['d2_remote']})")
                # The directives the planner wrote, then the planner stops
                # (its edge window stays high: it would flip D again).
                out["planner_directives"] = {
                    k[len(DIRECTIVE_PREFIX):]: {"tick": v.get("tick"), "reason": v.get("reason")}
                    for k, v in (await rt.hub.kv_get_prefix(DIRECTIVE_PREFIX)).items()}
                st, _, mbody, _ = await http_call(pport, "GET", "/metrics")
                out["planner_metrics_ok"] = st == 200 and b"dynamo_tpu_planner_ticks_total" in mbody
                check(out["planner_metrics_ok"], "the planner's /metrics")
                planner.stop()
                # 5. the flip back, by an operator's LocalActuator.
                counts_back = kernel_counts()
                out["prefill_role_launches"] = {k: counts_back[k] - counts_ack[k]
                                                for k in counts_back}
                t = time.perf_counter()
                await LocalActuator(rt.hub).apply(Decision(
                    tick=0, actions=[flip_role(wid_d, "decode", "operator: flip back")],
                    pressures={}))
                back = None
                for _ in range(600):
                    v = await rt.hub.kv_get(role_key(wid_d))
                    if v and v.get("acked") and v.get("from") == "prefill":
                        back = v
                        break
                    await asyncio.sleep(0.05)
                out["flip_back_s"] = time.perf_counter() - t
                check(back is not None, "D acked the flip back to decode")
                for _ in range(200):
                    infos = await rt.hub.kv_get_prefix(f"instances/{ns}/{comp}/{ep}/{wid_d}")
                    info = next(iter(infos.values()), {})
                    imports = await rt.hub.kv_get_prefix(f"instances/{ns}/{comp}/kv_import/{wid_d}")
                    if info.get("address") and imports:
                        break
                    await asyncio.sleep(0.05)
                check((info.get("metadata") or {}).get("role") == "decode" and info.get("address")
                      and imports, f"D's decode surface and kv_import back under its lease ({info})")
                await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    state.client.wait_for_instances(5), server.loop))
                p = after[PLAN_AFTER]
                toks, first = await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    d_timed(wid_d, p, PLAN_AFTER_OSL), server.loop))
                check(toks == refs[tuple(p)],
                      f"a remote prompt decoded on D after the flip back, whole and identical "
                      f"({len(toks)} tokens)")
                # The live streams, whole.
                results = await asyncio.gather(*live)
                for i, (toks, finish) in enumerate(results):
                    check(len(toks) == PLAN_STREAM_OSL and finish == "length",
                          f"live stream {i} whole ({len(toks)}, {finish})")
                out["spliced"] = res_metrics.migration_splices_total - splices0
                out["resumed"] = res_metrics.stream_resumes_total - resumes0
                check(out["spliced"] + out["resumed"] == 1,
                      f"D's stream spliced or resumed once ({out['spliced']} + {out['resumed']})")
                out["launches"] = {**kernel_counts(), "threefry_gumbel": noise_launches()}
                out["graphs"] = (graphs0, dict(engine.compile_counts()))
                out["new_keys"] = {k: sorted(map(str, v - keys0[k]))
                                   for k, v in graph_keys().items() if v - keys0[k]}
                out["syncs"] = syncs[0]
                torch.cuda.synchronize = real_sync
                out["window_s"] = time.perf_counter() - t_window
                # The signal plane's other ends: the aggregator's rows and
                # the router's series; the edge's planner group.
                st, _, body, _ = await http_call(aport, "GET", "/metrics")
                m = parse_prometheus(body.decode())
                rows = sorted(int(dict(lb)["worker_id"]) for (name, lb) in m
                              if name == "dynamo_tpu_worker_total_slots")
                out["aggregator_rows"] = rows
                check(st == 200 and {wid_d, wid_d2} <= set(rows)
                      and ("dynamo_tpu_router_isl_blocks", ()) in m,
                      f"the aggregator's ForwardPassMetrics rows for D and D2 and the router's "
                      f"hit-rate series ({rows})")
                st, _, body, _ = await http_call(fport, "GET", "/metrics")
                check(st == 200 and b"dynamo_tpu_planner_ticks_total" in body,
                      "the edge's /metrics has the planner group")
                # 6. the autopilot's router directive.
                core = await make_kv_router(component.endpoint(ep), PS)
                watcher = await PlannerDirectiveWatcher(rt.hub, core).start()
                applied0 = watcher.applied
                await LocalActuator(rt.hub).apply(Decision(tick=0, actions=[Action(
                    "set_tier_weights", reason="phase l",
                    params={"weights": dict(PLAN_TIER_WEIGHTS)})], pressures={}))
                for _ in range(100):
                    if watcher.applied > applied0:
                        break
                    await asyncio.sleep(0.05)
                tiers = dict(getattr(core.indexer, "_index", core.indexer).tier_weights)
                out["tier_weights"] = tiers
                check(tiers == PLAN_TIER_WEIGHTS,
                      f"the router's tier table equals the directive ({tiers})")
            finally:
                torch.cuda.synchronize = real_sync
                if watcher is not None:
                    await watcher.stop()
                if core is not None:
                    await core.stop()
                await collector.stop()
                await rt.close()

        asyncio.run(phase())
    finally:
        MigratableWorker.migrate_all = migrate_all
        torch.cuda.synchronize = real_sync
        if planner is not None:
            planner.stop()
        try:
            on_d(d_teardown())
        finally:
            for c in (agg, d2):
                c.stop()
    launches = out.get("launches") or {"decode_attention": 0, "prefill_attention": 0,
                                       "threefry_gumbel": 0}
    check(all(v > 0 for v in launches.values()), f"D launched all three kernels ({launches})")
    g0, g1 = out.get("graphs", ({}, {}))
    check(g0 == g1, f"D captured no graph while serving ({g0} -> {g1})")
    check(out.get("syncs") == 0, f"no torch.cuda.synchronize on D ({out.get('syncs')})")
    out["phase_s"] = time.perf_counter() - t_phase

    def p95(xs):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(len(xs) * 0.95))] if xs else float("nan")

    numbers = {
        "card": CARD, "ticks": out.get("ticks"), "breaching_ticks": out.get("breaching_ticks"),
        "flip_tick": out.get("flip_tick"), "planner_to_put_s": out.get("planner_to_put_s"),
        "put_to_ack_s": out.get("put_to_ack_s"), "moves": out.get("moves"),
        "ttft_p95_ms_before": p95(out.get("burst_ttft_ms", [])),
        "ttft_p95_ms_after": p95(out.get("after_ttft_ms", [])),
        "burst_ttft_ms": out.get("burst_ttft_ms"), "after_ttft_ms": out.get("after_ttft_ms"),
        "d2_remote": out.get("d2_remote"), "spliced": out.get("spliced"),
        "resumed": out.get("resumed"), "flip_back_s": out.get("flip_back_s"),
        "first_pools": out.get("first_pools"), "pools_after": out.get("pools_after"),
        "planner_decisions": out.get("planner_state_decisions"),
        "planner_directives": out.get("planner_directives"),
        "aggregator_rows": out.get("aggregator_rows"), "tier_weights": out.get("tier_weights"),
        "launches_d": launches, "prefill_role_launches": out.get("prefill_role_launches"),
        "graphs_d": out.get("graphs"), "new_keys_d": out.get("new_keys"),
        "syncs_d": out.get("syncs"), "d2_up_s": out.get("d2_up_s"), "warm_s": out.get("warm_s"),
        "window_s": out.get("window_s"), "phase_s": out["phase_s"],
    }
    log("planner " + json.dumps(numbers))
    return not fails, launches, numbers


# ------------------------------ j. live migration, the prefix pull, the noise


NOISE_V = 128256  # llama-3.1-8b's vocabulary
NOISE_ROWS = (16, 256)  # a serve dispatch's rows and phase c/e's
NOISE_ULP = 2.0  # the noise entry's Gumbel values: within 2 ulp at the scale max(|g|, 1)
CATEGORICAL_THREADS = 1024  # threads a CTA (csrc/threefry_gumbel.cu THREADS)
CATEGORICAL_TEMPERATURES = (1e-7, 0.7, 2.0, None)  # None: rows already scaled
# The function's own instructions an element, what any kernel that draws
# jax.random.categorical's token must issue: threefry-2x32's 20 rounds of
# add, rotate and xor, its key injections (two adds each of 5), the
# uniform (shift-or, subtract, add and the row's id), two accurate logs
# (about 17 each), the IEEE division (about 8), the add and the compare.
CATEGORICAL_FLOOR_OPS = {"threefry rounds": 60, "key injections": 10, "uniform": 5,
                         "two logf": 35, "division": 8, "add and compare": 3}


def noise_launches():
    """Launches of the sampler's kernel (csrc/threefry_gumbel.cu's
    categorical draw, the launch the main path makes)."""
    from dynamo_tpu_torch.ops import sampling as smp

    return smp.categorical_cuda.launches


def zero_noise_launches():
    from dynamo_tpu_torch.ops import sampling as smp

    smp.categorical_cuda.launches = 0


def categorical_sass():
    """The SASS of the categorical kernel the main path launches
    (``categorical_kernel<4, true, false>``: float4 rows, divided by the
    temperature, not profiled), or None without cuobjdump."""
    from dynamo_tpu_torch.ops import _build

    listing = sass_listing(_build._target(_build.CSRC / "threefry_gumbel.cu"),
                           "categorical_kernelILi4ELb1ELb0E")
    if not listing:
        log("sass threefry_gumbel: cuobjdump not found or no kernel; the bound counts bytes only")
    return listing


def categorical_case(torch, dev, B, V, temperature):
    """The checks' inputs: random logits with, from row 1 on, a constant
    row (the noise alone decides), a row at -1e30 but one id and a NaN row
    (NaNs at 7 and V - 5); seeds and steps with 0 and 2**32 - 1 among
    them; the last row at a second temperature."""
    gen = torch.Generator(device=dev).manual_seed(B * 31 + V)
    x = torch.randn((B, V), generator=gen, device=dev) * 3
    seeds = torch.randint(0, 2**32, (B,), generator=gen, device=dev, dtype=torch.int64)
    steps = torch.randint(0, 2**32, (B,), generator=gen, device=dev, dtype=torch.int64)
    seeds[0], steps[0] = 2**32 - 1, 0
    seeds[1], steps[1] = 0, 2**32 - 1
    x[1] = 0.5
    x[2] = -1e30
    x[2, V // 3] = -2.0
    x[3, [7, V - 5]] = float("nan")
    t = None
    if temperature is not None:
        t = torch.full((B,), temperature, device=dev)
        t[-1] = 0.7 if temperature != 0.7 else 2.0
    return x, t, seeds, steps


SPLIT_LAUNCHES = 5  # profiled launches of the draw, a row count


def categorical_split(torch, smp, x, temperature, seeds, steps, flush, clock_hz, kernel_ms):
    """Where a launch of the categorical draw spends its time: the kernel's
    profiled instantiation (``threefry_categorical_profile_launch``: the
    main path's code, with thread 0 of each CTA stamping its parts) on the
    timed inputs, SPLIT_LAUNCHES launches queued behind a spin kernel, each
    with L2 flushed before it and CUDA events around it.  Per launch: its
    event time, the span from the first CTA's start to the last one's end
    and the spread of the CTAs' starts (global timer), the event time less
    the span (the launch's time outside its CTAs), and per CTA the SM
    cycles of the row key, of its loop up to its last warp's end (thread
    0's own loop apart) and of the CTA's reduction and atomics, at
    ``clock_hz``; the medians over launches.  Beside them ``kernel_ms``
    (the unprofiled kernel's timed median) and an empty launch's event
    time in the same setting (``torch.cuda._sleep(0)``, one thread): the
    floor of what the events add around a launch.  The stamps cost a few
    registers and reads, and the compiler may move arithmetic across
    them, so the split is approximate.  Returns the split in
    microseconds, or raises if a profiled launch's tokens are not the
    kernel's."""
    from dynamo_tpu_torch.ops import _build

    B, V = x.shape
    dev = x.device
    sms = sm_count(torch)
    lib = smp._lib()
    ctas = lib.threefry_categorical_ctas(B, V, sms, 1)
    L = SPLIT_LAUNCHES
    want = smp.categorical_cuda(x, temperature, seeds, steps)
    prof = torch.zeros((L, B * ctas, 8), dtype=torch.int64, device=dev)
    state = torch.zeros((L, B, 2), dtype=torch.int64, device=dev)
    tokens = torch.empty((L, B), dtype=torch.int64, device=dev)
    p = _build.ptr
    torch.cuda.synchronize()
    for attempt in range(4):
        state.zero_()
        torch.cuda._sleep(SPIN_CYCLES * 4**attempt)
        spun = torch.cuda.Event()
        spun.record()
        pairs = []
        for i in range(L):
            flush.zero_()
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            code = lib.threefry_categorical_profile_launch(
                p(x), p(temperature), p(seeds), p(steps), p(state[i]), p(tokens[i]), p(prof[i]),
                B, V, sms, _build.stream_ptr(dev))
            _build.check(lib, code, "threefry_categorical_profile")
            ev[1].record()
            pairs.append(ev)
        queued_in_time = not spun.query()
        torch.cuda.synchronize()
        if queued_in_time:
            break
    else:
        raise RuntimeError("the host could not queue the profiled launches within the spin")
    if not all(torch.equal(tokens[i], want) for i in range(L)):
        raise RuntimeError(f"the profiled draw's tokens at B={B} are not the kernel's")
    parts = {k: [] for k in ("event", "span", "start_spread", "outside", "key", "key_max",
                             "loop", "loop_max", "own_loop", "reduce", "reduce_max", "cta",
                             "cta_max")}
    steps_ns = []
    us = 1e6 / clock_hz
    for i, (s, e) in enumerate(pairs):
        w = prof[i].cpu().double()
        start, end = w[:, 0], w[:, 1]
        key, own, wait, red = w[:, 2] * us, w[:, 3] * us, w[:, 4] * us, w[:, 5] * us
        cta = key + own + wait + red
        event = s.elapsed_time(e) * 1e3
        span = float(end.max() - start.min()) / 1e3
        parts["event"].append(event)
        parts["span"].append(span)
        parts["start_spread"].append(float(start.max() - start.min()) / 1e3)
        parts["outside"].append(event - span)
        for name, v in (("key", key), ("loop", own + wait), ("reduce", red), ("cta", cta)):
            parts[name].append(float(v.mean()))
            if name + "_max" in parts:
                parts[name + "_max"].append(float(v.max()))
        parts["own_loop"].append(float(own.mean()))
        gaps = torch.cat([start, end]).unique().diff()
        steps_ns.append(float(gaps.min()) if gaps.numel() else 0.0)
    split = {k: statistics.median(v) for k, v in parts.items()}
    split["timer_step_ns"] = min(steps_ns)
    split["empty_launch"] = cuda_ms(torch, lambda: torch.cuda._sleep(0), 20, flush) * 1e3
    log(f"split threefry_gumbel categorical B={B} V={V} ({ctas} CTAs a row, {B * ctas} CTAs; "
        f"median of {L} profiled launches behind a spin, L2 flushed; us): a profiled launch "
        f"{split['event']:.2f} by its events (the kernel's timed median {kernel_ms * 1e3:.2f}; "
        f"an empty launch {split['empty_launch']:.2f}); the CTAs' span {split['span']:.2f} "
        f"(their starts spread over {split['start_spread']:.2f}), so {split['outside']:.2f} "
        f"outside it (launch and drain); a CTA's row key {split['key']:.2f} (max "
        f"{split['key_max']:.2f}), its loop to its last warp {split['loop']:.2f} (max "
        f"{split['loop_max']:.2f}; thread 0's own {split['own_loop']:.2f}), its reduction and "
        f"atomics {split['reduce']:.2f} (max {split['reduce_max']:.2f}); a CTA "
        f"{split['cta']:.2f} (max {split['cta_max']:.2f}) at {clock_hz / 1e6:.0f} MHz; the "
        f"global timer's least step {split['timer_step_ns']:.0f} ns [{CARD}]")
    return split


def check_noise_kernel(torch, dev, tally):
    """Phase j, part 1: csrc/threefry_gumbel.cu.  Its noise entry against
    the plain version at B = 16 and 256 over the llama-3.1-8b vocabulary,
    on ragged seeds and steps (0 and 2**32 - 1 among them): the uint32 bits
    exactly, the Gumbel values within NOISE_ULP ulp at the scale
    max(|g|, 1), the tokens of ``argmax(logits + g)`` equal.  The
    categorical draw's Gumbel code bit for bit ``gumbel_from_bits``'s
    (torch.log on the card) on all 2^23 uniforms.  The categorical draw
    against ``categorical_plain`` at B = 16 and 256 on
    ``categorical_case``'s rows at each of CATEGORICAL_TEMPERATURES: equal
    tokens, the NaN row's its first NaN (torch.argmax's), the -1e30 row's
    its one id.  Then timed in turns (TIMING_ROUNDS rounds of 20 launches,
    L2 flushed): the kernel and the unfused path it replaced (eager
    division, the noise entry, eager add and argmax); the plain version
    once, over 3 launches.  The bound is the larger of x read once with the
    tokens written, and the function's own instructions
    (CATEGORICAL_FLOOR_OPS) at the issue rate and the SM clock sampled
    while it ran; the kernel's SASS an element by pipe
    (``sass_per_element``) and its pipe and issue times are logged beside
    it, not bound.  Then ``categorical_split``.  Returns {B: timings}."""
    from dynamo_tpu_torch.ops import sampling as smp

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    sms = sm_count(torch)
    listing = categorical_sass()
    # The draw's Gumbel code on every uniform: the 23 bits that make one.
    table = torch.arange(2**23, dtype=torch.int64, device=dev) << 9
    got = smp.gumbel_of_bits_cuda(table.to(torch.int32))
    want = smp.gumbel_from_bits(table)
    torch.cuda.synchronize()
    exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = float((got - want).abs().max())
    tally.worst["threefry_gumbel"] = max(tally.worst["threefry_gumbel"], err)
    log(f"check threefry_gumbel gumbel on all 2^23 uniforms: bitwise torch.log's {exact}, "
        f"max_abs_err={err:.3e} {'ok' if exact else 'FAIL'}")
    if not exact:
        tally.failures.append("threefry_gumbel gumbel table")
    del table, got, want
    out = {}
    for B in NOISE_ROWS:
        # -- the noise entry, bit for bit
        seeds = torch.randint(0, 2**32, (B,), generator=gen, device=dev, dtype=torch.int64)
        steps = torch.randint(0, 4096, (B,), generator=gen, device=dev, dtype=torch.int64)
        seeds[0], steps[0] = 2**32 - 1, 0
        seeds[1], steps[1] = 0, 2**32 - 1
        bits = torch.empty((B, NOISE_V), dtype=torch.int32, device=dev)
        got = smp.gumbel_noise_cuda(seeds, steps, NOISE_V, bits=bits)
        want_bits = smp.random_bits_plain(seeds, steps, NOISE_V)
        want = smp.gumbel_from_bits(want_bits)
        torch.cuda.synchronize()
        bits_ok = torch.equal(bits.to(torch.int64) & 0xFFFFFFFF, want_bits)
        scale = torch.maximum(want.abs(), torch.ones_like(want))
        ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
        ulps = float(((got.double() - want.double()).abs() / ulp.double()).max())
        err = float((got - want).abs().max())
        logits = torch.randn((B, NOISE_V), generator=gen, device=dev) * 3
        tokens_ok = torch.equal((logits + got).argmax(-1), (logits + want).argmax(-1))
        ok = bits_ok and ulps <= NOISE_ULP and tokens_ok and bool(torch.isfinite(got).all())
        tally.worst["threefry_gumbel"] = max(tally.worst["threefry_gumbel"], err)
        log(f"check threefry_gumbel noise entry B={B} V={NOISE_V}: bits equal {bits_ok}, gumbel "
            f"max_abs_err={err:.3e} ({ulps:.2f} ulp at max(|g|,1), tol {NOISE_ULP}), "
            f"categorical tokens equal {tokens_ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            tally.failures.append(f"threefry_gumbel noise B={B}")
        del bits, want_bits, want, scale, ulp, logits, got

        # -- the categorical draw against categorical_plain
        for temp in CATEGORICAL_TEMPERATURES:
            x, t, cseeds, csteps = categorical_case(torch, dev, B, NOISE_V, temp)
            got = smp.categorical_cuda(x, t, cseeds, csteps)
            want = smp.categorical_plain(x, t, cseeds, csteps)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            edges = int(got[3]) == 7 and int(got[2]) == NOISE_V // 3
            ok = equal and edges and got.dtype == torch.int64
            log(f"check threefry_gumbel categorical B={B} V={NOISE_V} temperature {temp}: tokens "
                f"equal {equal} ({int((got != want).sum())} of {B} differ), the NaN row's token "
                f"{int(got[3])} (its first NaN 7, torch.argmax {int(want[3])}), the -1e30 "
                f"row's {int(got[2])} (its one id {NOISE_V // 3}) {'ok' if ok else 'FAIL'}")
            if not ok:
                tally.failures.append(f"threefry_gumbel categorical B={B} t={temp}")
            del x, t, got, want

        # -- timed in turns: the kernel and the unfused path; the plain
        # version once (its ~38 ms a call at 256 rows)
        x = torch.randn((B, NOISE_V), generator=gen, device=dev) * 3
        temperature = torch.full((B,), MIGRATE_TEMPERATURE, device=dev)

        def kernel():
            return smp.categorical_cuda(x, temperature, seeds, steps)

        def unfused_path():
            noise = smp.gumbel_noise_cuda(seeds, steps, NOISE_V)
            return (x / temperature.clamp(min=smp.MIN_TEMPERATURE)[:, None] + noise).argmax(-1)

        def plain():
            return smp.categorical_plain(x, temperature, seeds, steps)

        def turns():
            rounds = {"ms": [], "unfused_ms": []}
            for _ in range(TIMING_ROUNDS):
                for key, fn in (("ms", kernel), ("unfused_ms", unfused_path)):
                    rounds[key].append(cuda_ms(torch, fn, 20, flush))
            return rounds

        rounds, clocks = during(turns)
        clock = run_clock_hz(clocks)
        # The plain version's ~150 launches a call overflow the launch queue
        # behind a spin: it is timed without one, its device time far above
        # the host's time to launch it.
        plain_ms = cuda_ms(torch, plain, 3, flush, spin=False)
        ctas = smp._lib().threefry_categorical_ctas(B, NOISE_V, sms, 1)
        per_thread = NOISE_V / (ctas * CATEGORICAL_THREADS)
        nbytes = B * NOISE_V * 4 + B * 8 + B * (8 + 8 + 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        floor_ops = sum(CATEGORICAL_FLOOR_OPS.values())
        t_ops = B * NOISE_V * floor_ops / (PIPE_LANES["issue"] * sms * clock) * 1e3
        bound_ms = max(t_bytes, t_ops)
        r = dict(ms=statistics.median(rounds["ms"]),
                 unfused_ms=statistics.median(rounds["unfused_ms"]), plain_ms=plain_ms,
                 rounds=rounds, bound_ms=bound_ms,
                 bound_by="bytes" if bound_ms == t_bytes else "operations", ctas=ctas,
                 clock_mhz=clock / 1e6, clock_samples=clocks, library_ms=None)
        # Diagnostics, not the bound: the kernel's own SASS by pipe.
        times = {}
        if listing:
            per_element, by_op, regions = sass_per_element(listing, 4, per_thread)
            times = pipe_times_ms(per_element, B * NOISE_V, sms, clock)
            log(f"sass threefry_gumbel categorical_kernel<4, true> at B={B} ({ctas} CTAs a row, "
                f"{per_thread:.1f} elements a thread): {sum(per_element.values()):.2f} "
                f"instructions an element (the function's {floor_ops}) by pipe "
                f"{({k: round(v, 2) for k, v in sorted(per_element.items())})}; by opcode "
                f"{({k: round(v, 2) for k, v in sorted(by_op.items())})}; regions "
                f"(instructions) {regions}; its pipe and issue times at {clock / 1e6:.0f} MHz on "
                f"{sms} SMs {({k: round(v, 4) for k, v in times.items()})} ms, the kernel "
                f"{r['ms'] / times['issue']:.2f}x its own issue time [{CARD}]")
        log(f"time threefry_gumbel categorical [B={B} V={NOISE_V}, f32 logits at temperature "
            f"{MIGRATE_TEMPERATURE} -> int64 tokens; {ctas} CTAs a row]: kernel {r['ms']:.4f} ms, "
            f"the unfused path (eager division, noise entry, eager add and argmax) "
            f"{r['unfused_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (3 launches), library none "
            f"(no one PyTorch call draws it); bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = {t_bytes:.4f} ms; the "
            f"function's {floor_ops} instructions an element {CATEGORICAL_FLOOR_OPS} at "
            f"{PIPE_LANES['issue']} lanes a clock an SM, {clock / 1e6:.0f} MHz, {sms} SMs = "
            f"{t_ops:.4f} ms), {r['ms'] / r['bound_ms']:.2f}x the bound [{CARD}]; rounds "
            f"{ {k: [round(v, 4) for v in vs] for k, vs in rounds.items()} }")
        r["split"] = categorical_split(torch, smp, x, temperature, seeds, steps, flush, clock,
                                       r["ms"])
        out[B] = r
        del x
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


MIGRATE_STREAMS, MIGRATE_ISL, MIGRATE_OSL, MIGRATE_AFTER = 4, 2048, 2040, 32
MIGRATE_TEMPERATURE = 0.7
MIGRATE_LOGPROBS = 1  # every token's chunk reaches the client: the stall is timed by token
MIGRATE_SEEDS = (None, None, 4242, 4343)  # 2 greedy, 2 seeded at MIGRATE_TEMPERATURE
MIGRATE_CHECK_BLOCKS = (0, 64)  # plus each stream's last full block B did not rewrite
DRAIN_STREAMS, DRAIN_OSL, DRAIN_AFTER = 2, 1024, 16
PULL_ISL, PULL_NEW, PULL_OSL = 2048, 32, 16
PULL_BUDGETS_MB = (64, 192)  # the EngineConfig default, then A's --kv-pull-mb 192
DISPATCH_PROMPTS, DISPATCH_ISL, DISPATCH_OSL = 4, 256, 64


def migrate_pull_path(torch, noise_times):
    """Phases j and k on one stack: live migration through the KV
    frontend, the cross-worker prefix pull and the drain through migration
    (j), and the bulk plane with its three consumers and the health
    watchdog (k, ``bulk_health_path``, before j's drain), on the README's
    distributed stack at phase 6's geometry with ``DYN_BULK_PLANE=1`` in
    every process: the hub, the KV frontend, worker B and an echo worker
    are CLI subprocesses; worker A runs the CLI's own ``run in=dyn://``
    code in this process (its launches counted), started with
    ``--kv-pull-mb 192``.  Phase j's transfers ride the service plane: A's
    two bulk producers (the puller's exporter, ``MigratableWorker.bulk``)
    are switched to it for j and to the bulk plane for k.  Returns
    ((ok, launches, numbers) of j, the same of k)."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm.kv_router.pull import make_client_exporter
    from dynamo_tpu_torch.llm.metrics import kv_tier_metrics, migration_metrics
    from dynamo_tpu_torch.llm.migration import request_migrate_out, target_from_instance
    from dynamo_tpu_torch.llm.migration.worker import MigratableWorker
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.engine import Context, collect

    fails = []
    out = {"noise": {B: {k: v for k, v in r.items() if k != "rounds"}
                     for B, r in noise_times.items()}}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"migrate check FAILED: {what}")

    hub_port = _free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    children, server, stopped = [], None, []
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    # Harness instrumentation of A's migrations (this process): per stream
    # the wall of ``migrate_out``, its pushes (copy rounds, then the final
    # delta) and blocks, and the freeze's wait for quiescence.
    per_rid, current = {}, {}
    real_migrate_out, real_push = MigratableWorker.migrate_out, MigratableWorker._push_blocks

    async def timed_migrate_out(self, request_id, target):
        current["rid"] = request_id
        rec = per_rid.setdefault(request_id, {"pushes": 0, "blocks": 0})
        rec["t0"] = time.perf_counter()
        ok = await real_migrate_out(self, request_id, target)
        rec.update(t1=time.perf_counter(), ok=ok)
        return ok

    async def counted_push(self, target, tokens, cursor, salt=None, trace=None):
        n = await real_push(self, target, tokens, cursor, salt, trace)
        rec = per_rid.get(current.get("rid"))
        if rec is not None:
            rec["pushes"] += 1
            rec["blocks"] += n
        return n

    def request(prompt, n, temperature=0.0, seed=None, annotations=None, logprobs=None):
        return PreprocessedRequest(
            token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=temperature, seed=seed,
                                             logprobs=logprobs),
            annotations=dict(annotations or {}),
        ).to_dict()

    t_phase = time.perf_counter()
    MigratableWorker.migrate_out, MigratableWorker._push_blocks = timed_migrate_out, counted_push
    # Every process of the stack runs with the bulk plane (A reads it
    # when the CLI wires its worker, the children inherit it).
    env_bulk = os.environ.get("DYN_BULK_PLANE")
    os.environ["DYN_BULK_PLANE"] = "1"
    roles_seen, real_start_decode = [], cli.WorkerRoles.start_decode

    async def recording_start_decode(self, disagg):
        roles_seen.append(self)
        return await real_start_decode(self, disagg)

    cli.WorkerRoles.start_decode = recording_start_decode
    k_result = (False, None, {})
    import logging

    mig_log = logging.getLogger("dynamo_tpu_torch.llm.migration")
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("migration log: %(levelname)s %(message)s"))
    mig_log.addHandler(handler)
    mig_log.setLevel(logging.INFO)
    try:
        children.append(Child("hub", ["hub", "--host", "127.0.0.1", "--port", str(hub_port)]))
        children[-1].wait_line("hub listening", 120)
        # B's kv_export bulk fetches meet BULK_FAULT_SPEC's drops (phase k).
        worker_b = Child("worker B", ["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV,
                                      "--hub", hub_addr], env={"DYN_FAULTS": BULK_FAULT_SPEC})
        children.append(worker_b)
        front = Child("http kv", ["http", "--hub", hub_addr, "--host", "127.0.0.1", "--port",
                                  "0", "--router", "kv"])
        children.append(front)
        # The watchdog's third fleet member (phase k): an echo worker.
        echo = Child("echo worker", ["run", f"in={ECHO_ENDPOINT}", "out=echocore", "--hub",
                                     hub_addr, "--model", "echo"])
        children.append(echo)
        fport = int(front.wait_line("OpenAI frontend on", 120).rsplit(":", 1)[1])
        t = time.perf_counter()
        server = CliServer(["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV, "--hub", hub_addr,
                            "--kv-pull-mb", str(PULL_BUDGETS_MB[1])])
        wid_a = server.service.worker_id
        graphs = server.warmup()
        engine = server.engine
        out["a_up_s"] = time.perf_counter() - t
        wid_b = int(worker_b.wait_line("worker ", 300).split()[1])
        wid_echo = int(echo.wait_line("worker ", 120).split()[1])
        log(f"migrate: hub {hub_addr}, kv frontend :{fport}, worker A {wid_a} (in this "
            f"process, up and warmed in {out['a_up_s']:.1f} s, graphs {graphs}), worker B "
            f"{wid_b} (pid {worker_b.p.pid})")
        released, freezes = {}, {}
        real_finish, real_freeze = engine.finish_migrated, engine.freeze_sequence

        def recording_finish(request_id, item=None):
            released[request_id] = item
            return real_finish(request_id, item)

        async def timed_freeze(request_id, timeout=10.0):
            t0 = time.perf_counter()
            seq = await real_freeze(request_id, timeout)
            freezes[request_id] = (time.perf_counter() - t0) * 1e3
            return seq

        engine.finish_migrated, engine.freeze_sequence = recording_finish, timed_freeze
        # A's two bulk producers, and their service-plane counterparts.
        handles = roles_seen[0]._handles["decode"]
        mig_a = handles["mig"]
        puller_a = engine._prefix_puller
        planes = {"bulk": (mig_a.bulk, puller_a.exporter),
                  "service": (None, make_client_exporter(handles["pull_client"]))}

        def set_plane(name):
            mig_a.bulk, puller_a.exporter = planes[name]

        set_plane("service")

        async def on_a(coro):
            """Await ``coro`` on A's event loop (its engine lives there)."""
            return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(coro, server.loop))

        async def a_state(fn):
            async def read():
                return fn()
            return await on_a(read())

        async def alone(req):
            """``req`` on A's engine directly; its tokens."""
            return [t for item in await collect(await engine.generate(Context(req)))
                    for t in item.get("token_ids", [])]

        async def together(reqs):
            """``reqs`` on A's engine at once; their tokens."""
            return await asyncio.gather(*(alone(r) for r in reqs))

        async def phase():
            nonlocal k_result
            rt = await DistributedRuntime.connect(hub_addr)
            ns, comp, ep = parse_endpoint_path(DIST_ENDPOINT)
            endpoint = rt.namespace(ns).component(comp).endpoint(ep)
            client = await endpoint.client()
            export = await endpoint.component.endpoint("kv_export").client()

            async def direct(wid, req, first=None):
                """``req`` direct-routed to worker ``wid``: (tokens, TTFT s)."""
                t0 = time.perf_counter()
                toks, ttft = [], None
                async for item in await client.generate(Context(req), worker_id=wid):
                    if ttft is None and item.get("token_ids"):
                        ttft = time.perf_counter() - t0
                        if first is not None:
                            first.set()
                    toks += item.get("token_ids", [])
                return toks, ttft

            async def b_block(tokens, i):
                """Block ``i`` of ``tokens`` exported from B's kv_export."""
                items = await collect(await export.generate(Context(
                    {"token_ids": list(tokens), "start_block": i, "max_blocks": 1}),
                    worker_id=wid_b))
                return (items[0] or {}).get("payload") if items else None

            async def same_block(tokens, i):
                pa_ = await on_a(engine.export_prompt_blocks(list(tokens), start_block=i,
                                                             max_blocks=1))
                pb_ = await b_block(tokens, i)
                return (pa_ is not None and pb_ is not None
                        and int(pa_["n_blocks"]) == int(pb_["n_blocks"]) == 1
                        and pa_["k"] == pb_["k"] and pa_["v"] == pb_["v"])

            async def splices(name="migration_splices_total"):
                _, _, body, _ = await http_call(fport, "GET", "/metrics")
                return parse_prometheus(body.decode()).get(
                    (f"dynamo_tpu_resilience_{name}", ()), 0.0)

            async def wait_live(n, after):
                def enough():
                    rids = engine.live_request_ids()
                    seqs = [engine.find_sequence(r) for r in rids]
                    return len(rids) == n and all(
                        s is not None and s.num_output_tokens >= after for s in seqs)
                for _ in range(3000):
                    if await a_state(enough):
                        return True
                    await asyncio.sleep(0.01)
                return False

            async def verify_moved(rids, prompts, results, label, also=None):
                """Streams ``rids`` (of ``prompts``; ``results`` the
                client's) moved A -> B, against B: every cutover carried
                its resume request; the moved blocks are bitwise B's (the
                last full block of a resume that ends on a block boundary
                is rewritten at its last position by B's admission, so the
                block before it is taken); each stream equals its resume
                request served on B, submitted in cutover order once the
                previous one's first token is out (as the cutovers
                arrived).  ``also()`` runs beside those references.
                Returns (rids in cutover order, resumes, stream -> rid,
                equal per stream, what ``also`` returned)."""
                resumes = {rid: ((released.get(rid) or {}).get("migrated") or {}).get("request")
                           for rid in rids}
                check(all(resumes.values()), f"{label}: every cutover carried its resume request")
                order = sorted([r for r in rids if resumes.get(r)],
                               key=lambda r: per_rid.get(r, {}).get("t0", 0.0))
                by_prompt = {tuple(resumes[rid]["token_ids"][:MIGRATE_ISL]): rid for rid in order}
                stream_rid = [by_prompt.get(tuple(p)) for p in prompts]
                pages_ok = []
                for rid in order:
                    toks = resumes[rid]["token_ids"]
                    last = len(toks) // PS - (1 if len(toks) % PS else 2)
                    for i in (*MIGRATE_CHECK_BLOCKS, last):
                        pages_ok.append(await same_block(toks, i))
                check(bool(pages_ok) and all(pages_ok),
                      f"{label}: migrated blocks bitwise equal on B ({pages_ok})")
                firsts = []
                for rid in order:
                    ev = asyncio.Event()
                    firsts.append(asyncio.ensure_future(direct(wid_b, dict(resumes[rid]), ev)))
                    await asyncio.wait_for(ev.wait(), 120)
                extra = asyncio.ensure_future(also()) if also is not None else None
                refs = {rid: (await task)[0] for rid, task in zip(order, firsts)}
                extra = await extra if extra is not None else None
                same = []
                for i, r in enumerate(results):
                    rid = stream_rid[i]
                    if rid is not None:
                        full = resumes[rid]["token_ids"][MIGRATE_ISL:] + refs.get(rid, [])
                        same.append(len(full) == MIGRATE_OSL and r[1] == dist_text(full))
                check(len(same) == len(prompts) and all(same),
                      f"{label}: each stream equals its resume request served on B ({same})")
                return order, resumes, stream_rid, same, extra

            try:
                for _ in range(600):
                    if set(client.instance_ids) == {wid_a, wid_b}:
                        break
                    await asyncio.sleep(0.1)
                check(set(client.instance_ids) == {wid_a, wid_b},
                      f"both workers discovered ({client.instance_ids})")
                infos = {v["worker_id"]: v for v in
                         (await rt.hub.kv_get_prefix(f"instances/{ns}/{comp}/{ep}/")).values()}
                target_b = target_from_instance(infos.get(wid_b) or {})
                check(target_b is not None
                      and bool(((infos.get(wid_a) or {}).get("metadata") or {}).get("migrate")),
                      "both workers advertise migrate")

                # -- the sampler in a fused dispatch, on A's engine --------
                async def dispatch_ms(temperature):
                    spans = engine.decode_spans
                    s0, c0 = spans.seconds, spans.count
                    prompts = dist_prompts(DISPATCH_PROMPTS, DISPATCH_ISL, 60)
                    await together([request(p, DISPATCH_OSL, temperature,
                                            100 + i if temperature else None)
                                    for i, p in enumerate(prompts)])
                    return (spans.seconds - s0) / max(1, spans.count - c0) * 1e3, spans.count - c0

                # The first sampled pass captures the sampled programs' graphs;
                # the second of each is the one reported.
                n_disp = {}
                for temp in (0.0, MIGRATE_TEMPERATURE) * 2:
                    key = "dispatch_greedy_ms" if temp == 0.0 else "dispatch_sampled_ms"
                    out[key], n_disp[key] = await on_a(dispatch_ms(temp))
                n_g, n_s = n_disp["dispatch_greedy_ms"], n_disp["dispatch_sampled_ms"]
                log(f"migrate: a fused dispatch ({DISPATCH_PROMPTS} live rows of 16, 8 steps) "
                    f"greedy {out['dispatch_greedy_ms']:.3f} ms ({n_g} dispatches), sampled at "
                    f"temperature {MIGRATE_TEMPERATURE} {out['dispatch_sampled_ms']:.3f} ms "
                    f"({n_s}); the categorical draw at 16 rows {noise_times[16]['ms']:.4f} ms a "
                    f"step")

                # -- live migration through the KV frontend ----------------
                prompts = dist_prompts(MIGRATE_STREAMS, MIGRATE_ISL, 61)
                temps = [0.0 if s is None else MIGRATE_TEMPERATURE for s in MIGRATE_SEEDS]
                # A holds each prompt's blocks, so the router sends the
                # streams there, and has captured the programs this traffic
                # reaches (the same prompts, sampled and greedy, together).
                # Each alone twice (a prefill, then a prefix hit: greedy-only
                # and sampled-only steps and fused dispatches), then all
                # together (mixed ones).
                warm = [request(p, 40, temps[i], MIGRATE_SEEDS[i], logprobs=MIGRATE_LOGPROBS)
                        for i, p in enumerate(prompts)]
                for r in warm + warm:
                    await on_a(alone(r))
                await on_a(together(warm))
                # B captures its graphs at first use: the same traffic on
                # other prompts first, so the cutovers do not wait on
                # captures there.
                warm_b = [request(p, 40, temps[i], MIGRATE_SEEDS[i], logprobs=MIGRATE_LOGPROBS)
                          for i, p in enumerate(dist_prompts(MIGRATE_STREAMS, MIGRATE_ISL, 62))]
                for r in warm_b + warm_b:
                    await direct(wid_b, r)
                await asyncio.gather(*(direct(wid_b, r) for r in warm_b))
                await asyncio.sleep(1.5)  # the router's index takes A's events
                splices0 = await splices()
                migration_metrics.reset()
                graphs0 = dict(engine.compile_counts())
                zero_kernel_counts()
                zero_noise_launches()
                torch.cuda.synchronize = counting_sync
                stamps = [[] for _ in prompts]

                def on_text(i):
                    return lambda text: stamps[i].append(time.perf_counter())

                t_streams = time.perf_counter()
                streams = [asyncio.ensure_future(dist_complete(
                    fport, p, MIGRATE_OSL, on_text(i), temps[i], MIGRATE_SEEDS[i],
                    MIGRATE_LOGPROBS)) for i, p in enumerate(prompts)]
                check(await wait_live(MIGRATE_STREAMS, MIGRATE_AFTER),
                      f"the {MIGRATE_STREAMS} streams live on A with {MIGRATE_AFTER}+ tokens")
                rids = await a_state(lambda: list(engine.live_request_ids()))
                t_req = time.perf_counter()
                resp = await request_migrate_out(infos[wid_a], target_b)
                out["migrate_request_s"] = time.perf_counter() - t_req
                results = await asyncio.gather(*streams)
                out["streams_wall_s"] = time.perf_counter() - t_streams
                out["launches"] = {**kernel_counts(), "threefry_gumbel": noise_launches()}
                out["graphs"] = (graphs0, dict(engine.compile_counts()))
                out["syncs"] = syncs[0]
                torch.cuda.synchronize = real_sync
                check(resp.get("ok") and sorted(resp.get("migrated") or []) == sorted(rids)
                      and not resp.get("failed"), f"migrate_out moved all {len(rids)} ({resp})")
                for i, r in enumerate(results):
                    check(r[0] == 200 and r[2] == "length" and r[3] == MIGRATE_OSL,
                          f"migrated stream {i}: {r[0]} {r[2]}/{r[3]}")
                n_spliced = await splices() - splices0
                check(n_spliced == MIGRATE_STREAMS,
                      f"{MIGRATE_STREAMS} splices on the frontend's /metrics ({n_spliced})")
                held = await a_state(lambda: (engine.scheduler.num_running,
                                              engine.scheduler.num_waiting,
                                              engine.kv.active_blocks))
                check(held == (0, 0, 0), f"A released the rows and blocks (running, waiting, "
                                         f"active blocks: {held})")
                log(f"migrate: per stream {[(r[:8], per_rid.get(r), freezes.get(r)) for r in rids]}")
                # Beside the references on B: the never-migrated requests
                # on A (reported).
                order, resumes, stream_rid, same, never = await verify_moved(
                    rids, prompts, results, "migrate", also=lambda: on_a(together([request(
                        p, MIGRATE_OSL, temps[i], MIGRATE_SEEDS[i], logprobs=MIGRATE_LOGPROBS)
                        for i, p in enumerate(prompts)])))
                same_never = [r[1] == dist_text(never[i]) for i, r in enumerate(results)
                              if stream_rid[i] is not None]
                recs = [per_rid.get(rid, {}) for rid in order]
                out.update(
                    identical_to_resume_reference=same,
                    identical_to_never_migrated=sum(same_never),
                    temperatures=[temps[prompts.index(list(resumes[rid]["token_ids"][
                        :MIGRATE_ISL]))] for rid in order],
                    copy_rounds=[x.get("pushes", 0) - 1 for x in recs],
                    blocks_pushed=[x.get("blocks", 0) for x in recs],
                    freeze_to_quiescence_ms=[freezes.get(rid) for rid in order],
                    cutover_pause_ms=[migration_metrics.cutover_pause_ms.percentile(q)
                                      for q in (0.5, 1.0)],
                    migrate_out_s=[x.get("t1", 0.0) - x.get("t0", 0.0) for x in recs],
                    request_to_cutover_s=[x.get("t1", 0.0) - t_req for x in recs],
                    stall_ms=[max((b - a for a, b in zip(s, s[1:])), default=float("nan")) * 1e3
                              for s in stamps],
                    spliced=n_spliced,
                )

                # -- the prefix pull: B holds a prefix, A pulls it ---------
                puller = await a_state(lambda: engine._prefix_puller)
                check(puller is not None and puller.max_bytes == PULL_BUDGETS_MB[1] << 20,
                      "A's puller at --kv-pull-mb 192")
                pulls = []
                for j, mb in enumerate(PULL_BUDGETS_MB):
                    puller.max_bytes = mb << 20  # the default budget first, then the flag's
                    prefix = dist_prompts(1, PULL_ISL, 70 + j)[0]
                    full_req = prefix + dist_prompts(1, PULL_NEW, 80 + j)[0]
                    await direct(wid_b, request(prefix, 1))
                    # B's prefix hit, the second run (the first may capture).
                    for _ in range(2):
                        _, hit_ttft = await direct(wid_b, request(full_req, 1))
                    local = await a_state(lambda: engine.local_prefix_blocks(full_req))
                    want = min(PULL_ISL // PS - local, (mb << 20) // engine.block_nbytes())
                    b0, f0 = kv_tier_metrics.pulled_blocks_total, kv_tier_metrics.pulls_failed_total
                    toks, ttft = await direct(wid_a, request(full_req, PULL_OSL, annotations={
                        "kv_pull": {"worker_id": wid_b, "blocks": PULL_ISL // PS}}))
                    got = kv_tier_metrics.pulled_blocks_total - b0
                    check(got == want and kv_tier_metrics.pulls_failed_total == f0,
                          f"pull at {mb} MiB: {got} blocks (min(peer - local, budget) = {want})")
                    page_ok = [await same_block(full_req, i) for i in (0, want // 2, want - 1)]
                    check(all(page_ok), f"pull at {mb} MiB: pulled pages bitwise B's ({page_ok})")
                    # The same split on A: its first ``want`` blocks computed
                    # as B computed them (512-id chunks), under a salt, then
                    # the request over them.
                    salt = {"kv_salt": f"pull-reference-{j}"}
                    await on_a(alone(request(full_req[: want * PS], 1, annotations=salt)))
                    ref = await on_a(alone(request(full_req, PULL_OSL, annotations=salt)))
                    check(len(toks) == PULL_OSL and toks == ref,
                          f"pull at {mb} MiB: the stream whole and equal to the same-split "
                          f"reference ({len(toks)} tokens)")
                    # A's recompute: a fresh prompt of the same shape, no hint.
                    _, recompute = await direct(wid_a, request(
                        dist_prompts(1, PULL_ISL + PULL_NEW, 90 + j)[0], 1))
                    pulls.append({"budget_mb": mb, "blocks": got, "want": want,
                                  "frame_mib": got * engine.block_nbytes() / 2**20,
                                  "ttft_pull_ms": ttft * 1e3,
                                  "ttft_a_recompute_ms": recompute * 1e3,
                                  "ttft_b_prefix_hit_ms": hit_ttft * 1e3})
                f0 = kv_tier_metrics.pulls_failed_total
                toks, dead_ttft = await direct(wid_a, request(
                    dist_prompts(1, PULL_ISL + PULL_NEW, 99)[0], PULL_OSL,
                    annotations={"kv_pull": {"worker_id": wid_b + 7919, "blocks": 128}}))
                check(len(toks) == PULL_OSL and kv_tier_metrics.pulls_failed_total == f0 + 1,
                      f"a pull from a dead peer prefilled locally ({len(toks)} tokens, failed "
                      f"+{kv_tier_metrics.pulls_failed_total - f0})")
                out["pulls"] = pulls
                out["dead_peer_ttft_ms"] = dead_ttft * 1e3

                # -- phase k on this stack, then j's drain on the service plane
                k_result = await bulk_health_path(torch, SimpleNamespace(
                    engine=engine, server=server, wid_a=wid_a, wid_b=wid_b, wid_echo=wid_echo,
                    worker_b=worker_b, fport=fport, rt=rt, client=client, infos=infos,
                    target_b=target_b, endpoint=(ns, comp, ep), request=request,
                    direct=direct, on_a=on_a, a_state=a_state, alone=alone,
                    together=together, same_block=same_block, splices=splices,
                    wait_live=wait_live, verify_moved=verify_moved, per_rid=per_rid,
                    freezes=freezes, set_plane=set_plane, puller=puller_a,
                    mig=mig_a, bulk_srv=handles.get("bulk_srv"), syncs=syncs,
                    counting_sync=counting_sync, real_sync=real_sync,
                    j_out=out))
                await a_state(lambda: set_plane("service"))

                # -- the drain: A stopped with live streams -----------------
                drain = dist_prompts(DRAIN_STREAMS, MIGRATE_ISL, 95)
                for p in drain:
                    await on_a(alone(request(p, 1)))
                await asyncio.sleep(1.5)
                splices0 = await splices()
                resumes0 = await splices("stream_resumes_total")
                dstreams = [asyncio.ensure_future(dist_complete(fport, p, DRAIN_OSL))
                            for p in drain]
                check(await wait_live(DRAIN_STREAMS, DRAIN_AFTER),
                      f"the {DRAIN_STREAMS} drain streams live on A")
                drain_rids = await a_state(lambda: list(engine.live_request_ids()))
                t0 = time.perf_counter()
                await asyncio.get_running_loop().run_in_executor(None, server.stop)
                stopped.append(True)
                out["drain_stop_s"] = time.perf_counter() - t0
                for i, r in enumerate(await asyncio.gather(*dstreams)):
                    check(r[0] == 200 and r[2] == "length" and r[3] == DRAIN_OSL,
                          f"drained stream {i}: {r[0]} {r[2]}/{r[3]}")
                # Both cut over to B; the frontend splices each, unless A's
                # shutdown right after the drain cuts a marker off, when the
                # stream resumes on B instead (reported).
                moved = [per_rid.get(r, {}).get("ok") for r in drain_rids]
                check(moved == [True] * DRAIN_STREAMS, f"the drain moved both to B ({moved})")
                out["drain_spliced"] = await splices() - splices0
                out["drain_resumed"] = await splices("stream_resumes_total") - resumes0
                check(out["drain_spliced"] + out["drain_resumed"] == DRAIN_STREAMS,
                      f"the frontend spliced or resumed both ({out['drain_spliced']} + "
                      f"{out['drain_resumed']})")
            finally:
                torch.cuda.synchronize = real_sync
                await export.close()
                await client.close()
                await rt.close()

        asyncio.run(phase())
    finally:
        torch.cuda.synchronize = real_sync
        MigratableWorker.migrate_out, MigratableWorker._push_blocks = real_migrate_out, real_push
        cli.WorkerRoles.start_decode = real_start_decode
        if env_bulk is None:
            os.environ.pop("DYN_BULK_PLANE", None)
        else:
            os.environ["DYN_BULK_PLANE"] = env_bulk
        mig_log.removeHandler(handler)
        try:
            if server is not None and not stopped:
                server.stop()
        finally:
            for c in reversed(children):
                c.stop()
    launches = out.get("launches") or {"decode_attention": 0, "prefill_attention": 0,
                                       "threefry_gumbel": 0}
    check(all(v > 0 for v in launches.values()), f"A launched all three kernels ({launches})")
    g0, g1 = out.get("graphs", ({}, {}))
    check(g0 == g1, f"A captured no graph while serving ({g0} -> {g1})")
    check(out.get("syncs") == 0, f"no torch.cuda.synchronize on A while serving "
                                 f"({out.get('syncs')})")
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = CARD
    log("migrate " + json.dumps(out, default=str))
    return (not fails, launches, out), k_result


BULK_FAULT_SPEC = "bulk_conn_drop:kv_export#5"  # B's: 4 drops end its first bulk fetch, 1 the next
BULK_PULL_BUDGETS_MB = (64, 192)  # 32 and 96 blocks of llama-3.1-8b
BULK_PULL_TURNS = ("bulk", "service", "service", "bulk", "bulk", "service")
BULK_STALL_ISL, BULK_STALL_OSL = 256, 256  # B's stream during each 96-block pull
BULK_MIGRATE_SEEDS = (None, 4444)  # greedy, and seeded at MIGRATE_TEMPERATURE
SPAN_REQUESTS, SPAN_ISL, SPAN_OSL = 3, 512, 8
ECHO_ENDPOINT = "dyn://dynamo.EchoWorker.generate"
WATCH_ISL, WATCH_OSL = 512, 400
# slow_stream on A: before every item it sends.  An item is a fused
# dispatch's tokens, ~75 ms apart on a healthy worker, so 0.3 s is past
# straggler_factor 3.0 times the fleet median.
WATCH_STREAM_DELAY_S = 0.3
WATCH_PACE_S = 0.35  # A's decode paced so that its slowed wire keeps up
WATCH_FAST, WATCH_FAST_ISL, WATCH_FAST_OSL = 4, 64, 32
WATCH_CFG = dict(probe_interval_s=0.25, probe_timeout_s=0.5, eject_grace_s=60.0)
WATCH_EJECT_GRACE_S = 1.0
WATCH_HEALTH_DELAY_S = 2.0  # A's __health__ answers after the probe's timeout: A stays sick


class RssPeak:
    """Peak resident set of process ``pid`` between ``start`` and
    ``stop`` (``/proc/<pid>/status`` read every 5 ms), beside its value at
    ``start``, in MiB."""

    def __init__(self, pid):
        self.path = f"/proc/{pid}/status"
        self.peak = self.base = 0.0
        self._stop = threading.Event()
        self._thread = None

    def _read(self):
        with open(self.path) as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
        return 0.0

    def start(self):
        self.base = self.peak = self._read()

        def run():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self._read())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(5)
        return self.base, self.peak


async def bulk_health_path(torch, c):
    """Phase k, on phase j's stack (``migrate_pull_path``) before j's
    drain, with A's producers on the bulk plane.  Returns (ok, launches,
    numbers)."""
    from dynamo_tpu_torch.llm.metrics import bulk_metrics, kv_tier_metrics, migration_metrics
    from dynamo_tpu_torch.llm.migration import request_migrate_out
    from dynamo_tpu_torch.llm.trace_service import BULK_TRACES_SINK
    from dynamo_tpu_torch.runtime.transports.bulk import bulk_addr_key, bulk_sink_prefix
    from dynamo_tpu_torch.runtime.transports.shard import shard_metrics

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"bulk check FAILED: {what}")

    async def until(cond, timeout):
        end = time.perf_counter() + timeout
        while not cond():
            if time.perf_counter() > end:
                return False
            await asyncio.sleep(0.02)
        return True

    engine, rt, client, request = c.engine, c.rt, c.client, c.request
    wid_a, wid_b = c.wid_a, c.wid_b
    ns, comp, ep = c.endpoint
    nb = engine.block_nbytes()
    t_phase = time.perf_counter()
    next_seed = [200]
    stall_prompts = {}

    def b_fallback_lines():
        return sum("falling back to the hub path" in line for line in c.worker_b.lines)

    # The pull's own walls on A: the exporter's (the transfer) and the
    # puller's (the transfer and the inject).
    export_walls, pull_walls = [], []
    real_pull = c.puller.pull

    async def timed_pull(*a, **kw):
        t0 = time.perf_counter()
        try:
            return await real_pull(*a, **kw)
        finally:
            pull_walls.append(time.perf_counter() - t0)

    def use(plane, mb):
        c.set_plane(plane)
        inner = c.puller.exporter

        async def timed_exporter(worker_id, data):
            t0 = time.perf_counter()
            try:
                return await inner(worker_id, data)
            finally:
                export_walls.append(time.perf_counter() - t0)

        c.puller.exporter = timed_exporter
        c.puller.max_bytes = mb << 20
        c.puller.pull = timed_pull

    async def pull(mb, plane, stall=False):
        """A pulls a fresh 2048-id prefix B holds, at ``mb`` MiB, over
        ``plane``; with ``stall``, a stream decodes on B meanwhile."""
        await c.a_state(lambda: use(plane, mb))
        j = next_seed[0]
        next_seed[0] += 1
        prefix = dist_prompts(1, PULL_ISL, 1000 + j)[0]
        full = prefix + dist_prompts(1, PULL_NEW, 2000 + j)[0]
        await c.direct(wid_b, request(prefix, 1))
        local = await c.a_state(lambda: engine.local_prefix_blocks(full))
        want = min(PULL_ISL // PS - local, (mb << 20) // nb)
        m0, b0 = bulk_metrics.snapshot(), kv_tier_metrics.pulled_blocks_total
        f0 = kv_tier_metrics.pulls_failed_total
        del export_walls[:], pull_walls[:]
        bstream = rss = None
        if stall:
            # A stream decoding on B meanwhile, through the frontend (its
            # prompt's prefix is B's): an SSE event per token.
            first, st = asyncio.Event(), []

            def on_event(text):
                st.append(time.perf_counter())
                first.set()

            bstream = asyncio.ensure_future(dist_complete(
                c.fport, stall_prompts[(mb, j)], BULK_STALL_OSL, on_event,
                logprobs=MIGRATE_LOGPROBS))
            await asyncio.wait_for(first.wait(), 60)
            await asyncio.sleep(0.3)
            rss = RssPeak(c.worker_b.p.pid).start()
        t0 = time.perf_counter()
        toks, ttft = await c.direct(wid_a, request(full, PULL_OSL, annotations={
            "kv_pull": {"worker_id": wid_b, "blocks": PULL_ISL // PS}}))
        m1 = bulk_metrics.snapshot()
        rec = {"plane": plane, "budget_mb": mb, "blocks": kv_tier_metrics.pulled_blocks_total - b0,
               "want": want, "failed": kv_tier_metrics.pulls_failed_total - f0,
               "ttft_ms": ttft * 1e3, "export_ms": sum(export_walls) * 1e3,
               "pull_ms": sum(pull_walls) * 1e3, "tokens": len(toks),
               **{k: m1[k] - m0[k] for k in m1}}
        if stall:
            base, peak = rss.stop()
            r = await bstream
            check(r[0] == 200 and r[3] == BULK_STALL_OSL, f"B's stream during the pull: {r[:4]}")
            gaps = [(b - a, a, b) for a, b in zip(st, st[1:])]
            during = [g for g, a, b in gaps if b >= t0 and a <= t0 + ttft]
            before = sorted(g for g, a, b in gaps if b < t0)
            rec.update(donor_itl_max_during_ms=max(during, default=float("nan")) * 1e3,
                       donor_itl_p50_before_ms=(before[len(before) // 2] * 1e3 if before
                                                else float("nan")),
                       donor_itl_max_before_ms=max(before, default=float("nan")) * 1e3,
                       donor_rss_mib=(round(base, 1), round(peak, 1)))
        return rec, full, toks

    async def pages_equal(full, n):
        return [await c.same_block(full, i) for i in sorted({0, n // 2, max(0, n - 1)})]

    await c.a_state(lambda: c.set_plane("bulk"))
    graphs0 = dict(engine.compile_counts())
    keys0 = {n: set(getattr(engine.programs, n)._signatures) for n in engine.programs.NAMES}
    zero_kernel_counts()
    zero_noise_launches()
    c.syncs[0] = 0
    torch.cuda.synchronize = c.counting_sync
    try:
        # -- 1. rendezvous ------------------------------------------------
        addrs = {n: await rt.hub.kv_get(bulk_addr_key(w)) for n, w in (("A", wid_a), ("B", wid_b))}
        sinks = await rt.hub.kv_get_prefix(bulk_sink_prefix(BULK_TRACES_SINK))
        check(all(isinstance(r, dict) and r.get("address") for r in addrs.values())
              and addrs["A"]["address"] == c.bulk_srv.address,
              f"bulk/addr of A and B in the hub ({addrs})")
        check(len(sinks) == 1 and all(r.get("address") for r in sinks.values()),
              f"the frontend's bulk/sink/traces in the hub ({sinks})")
        out["rendezvous"] = {"A": addrs["A"], "B": addrs["B"], "traces": sinks}

        # -- 3. faults on B's kv_export (BULK_FAULT_SPEC) ------------------
        fired0 = sum("fault fired: bulk_conn_drop" in line for line in c.worker_b.lines)
        faults_out = {}
        for case, want_fb, want_res in (("every chunk", 1, 3), ("once", 0, 1)):
            rec, full, toks = await pull(BULK_PULL_BUDGETS_MB[0], "bulk")
            pages = await pages_equal(full, rec["want"])
            check(rec["fallbacks_total"] == want_fb and rec["resumes_total"] == want_res
                  and rec["blocks"] == rec["want"] and rec["failed"] == 0 and all(pages)
                  and rec["tokens"] == PULL_OSL,
                  f"bulk_conn_drop {case}: fallbacks {rec['fallbacks_total']} (want {want_fb}), "
                  f"resumes {rec['resumes_total']} (want {want_res}), {rec['blocks']} of "
                  f"{rec['want']} blocks, pages {pages}, {rec['tokens']} tokens")
            faults_out[case] = rec
        fired = sum("fault fired: bulk_conn_drop" in line for line in c.worker_b.lines) - fired0
        check(fired == 5, f"B's bulk_conn_drop fired 5 times ({fired})")
        out["faults"] = faults_out

        # -- 2. the pull over the bulk plane, in turns with the service plane
        pulls = {}
        for mb in BULK_PULL_BUDGETS_MB:
            if mb == BULK_PULL_BUDGETS_MB[-1]:
                # The streams that decode on B during the 96-block pulls:
                # their prompts prefilled on B (with their programs), so the
                # frontend's KV router sends them there.
                stall_prompts.update(((mb, j), p) for j, p in zip(
                    range(next_seed[0], next_seed[0] + len(BULK_PULL_TURNS)),
                    dist_prompts(len(BULK_PULL_TURNS), BULK_STALL_ISL, 3000 + mb)))
                for p in stall_prompts.values():
                    await c.direct(wid_b, request(p, 1, logprobs=MIGRATE_LOGPROBS))
                await asyncio.sleep(1.5)
            for turn, plane in enumerate(BULK_PULL_TURNS):
                rec, full, toks = await pull(mb, plane, stall=mb == BULK_PULL_BUDGETS_MB[-1])
                ok = rec["blocks"] == rec["want"] and rec["failed"] == 0 and len(toks) == PULL_OSL
                if plane == "bulk":
                    ok = ok and rec["fallbacks_total"] == 0 and rec["bytes_total"] >= rec["blocks"] * nb
                else:
                    ok = ok and rec["bytes_total"] == 0
                check(ok, f"pull at {mb} MiB over {plane} (turn {turn}): {rec}")
                if turn == 0:
                    pages = await pages_equal(full, rec["want"])
                    salt = {"kv_salt": f"bulk-pull-reference-{mb}"}
                    await c.on_a(c.alone(request(full[: rec["want"] * PS], 1, annotations=salt)))
                    ref = await c.on_a(c.alone(request(full, PULL_OSL, annotations=salt)))
                    check(all(pages) and toks == ref,
                          f"bulk pull at {mb} MiB: pages bitwise B's ({pages}), the stream "
                          f"equal to the same-split reference")
                pulls.setdefault(mb, []).append(rec)
        out["pulls"] = pulls
        await c.a_state(lambda: c.set_plane("bulk"))

        # -- 4. migration over the bulk plane ------------------------------
        mprompts = dist_prompts(2, MIGRATE_ISL, 66)
        temps = [0.0 if s is None else MIGRATE_TEMPERATURE for s in BULK_MIGRATE_SEEDS]
        # A holds the prompts and has run their programs (as in phase j:
        # each alone twice, then together).
        warm = [request(p, 40, temps[i], BULK_MIGRATE_SEEDS[i], logprobs=MIGRATE_LOGPROBS)
                for i, p in enumerate(mprompts)]
        for r in warm + warm:
            await c.on_a(c.alone(r))
        await c.on_a(c.together(warm))
        await asyncio.sleep(1.5)  # the router's index takes A's events
        splices0 = await c.splices()
        bb0, mm0 = bulk_metrics.snapshot(), (migration_metrics.blocks_total,
                                             migration_metrics.bytes_total)
        pub0 = sum(shard_metrics.publish_bytes.values())
        stamps = [[] for _ in mprompts]
        streams = [asyncio.ensure_future(dist_complete(
            c.fport, p, MIGRATE_OSL, lambda text, i=i: stamps[i].append(time.perf_counter()),
            temps[i], BULK_MIGRATE_SEEDS[i], MIGRATE_LOGPROBS)) for i, p in enumerate(mprompts)]
        check(await c.wait_live(len(mprompts), MIGRATE_AFTER),
              f"the {len(mprompts)} streams live on A with {MIGRATE_AFTER}+ tokens")
        rids = await c.a_state(lambda: list(engine.live_request_ids()))
        t_req = time.perf_counter()
        resp = await request_migrate_out(c.infos[wid_a], c.target_b)
        results = await asyncio.gather(*streams)
        bb1 = bulk_metrics.snapshot()
        pub = sum(shard_metrics.publish_bytes.values()) - pub0
        mig_blocks = migration_metrics.blocks_total - mm0[0]
        mig_bytes = migration_metrics.bytes_total - mm0[1]
        check(resp.get("ok") and sorted(resp.get("migrated") or []) == sorted(rids)
              and not resp.get("failed"), f"migrate_out moved both over the bulk plane ({resp})")
        for i, r in enumerate(results):
            check(r[0] == 200 and r[2] == "length" and r[3] == MIGRATE_OSL,
                  f"bulk-migrated stream {i}: {r[0]} {r[2]}/{r[3]}")
        n_spliced = await c.splices() - splices0
        check(n_spliced == len(mprompts), f"{len(mprompts)} splices ({n_spliced})")
        bulk_bytes = bb1["bytes_total"] - bb0["bytes_total"]
        check(bb1["fallbacks_total"] == bb0["fallbacks_total"] and bulk_bytes >= mig_bytes > 0
              and pub * 100 < bulk_bytes,
              f"the copy stream on the bulk plane: {bulk_bytes} bulk bytes for {mig_bytes} KV "
              f"bytes, {pub} hub publish bytes, fallbacks "
              f"{bb1['fallbacks_total'] - bb0['fallbacks_total']}")
        order, _, _, same, _ = await c.verify_moved(rids, mprompts, results, "bulk migration")
        recs = [c.per_rid.get(rid, {}) for rid in order]
        out["migrate"] = dict(
            blocks_pushed=[x.get("blocks", 0) for x in recs],
            copy_rounds=[x.get("pushes", 0) - 1 for x in recs],
            migrate_out_s=[x.get("t1", 0.0) - x.get("t0", 0.0) for x in recs],
            request_to_cutover_s=[x.get("t1", 0.0) - t_req for x in recs],
            freeze_to_quiescence_ms=[c.freezes.get(rid) for rid in order],
            stall_ms=[max((b - a for a, b in zip(s, s[1:])), default=float("nan")) * 1e3
                      for s in stamps],
            bulk_bytes=bulk_bytes, bulk_transfers=bb1["transfers_total"] - bb0["transfers_total"],
            kv_bytes=mig_bytes, kv_blocks=mig_blocks, hub_publish_bytes=pub, spliced=n_spliced,
            identical_to_resume_reference=same,
            service_plane_j={k: c.j_out.get(k) for k in ("migrate_out_s", "stall_ms",
                                                         "blocks_pushed")})

        # -- 5. spans over the bulk sink -----------------------------------
        fb_lines0, fb0 = b_fallback_lines(), bulk_metrics.fallbacks_total
        sprompts = dist_prompts(SPAN_REQUESTS, SPAN_ISL, 71)
        for p in sprompts:
            await c.direct(wid_b, request(p, 1))
        await asyncio.sleep(1.5)
        spans_out = []
        for p in sprompts:
            st, hdrs, _, _ = await http_call(c.fport, "POST", "/v1/completions", {
                "model": DIST_MODEL, "prompt": p + [11, 12, 13, 14], "max_tokens": SPAN_OSL,
                "nvext": {"ignore_eos": True}}, headers={"x-trace": "1"})
            tid = hdrs.get("x-trace-id")
            trace = None
            for _ in range(200):
                s_, _, body, _ = await http_call(c.fport, "GET", f"/traces/{tid}")
                trace = json.loads(body) if s_ == 200 else None
                if trace and f"worker-{wid_b}" in trace.get("procs", []):
                    break
                await asyncio.sleep(0.05)
            procs = (trace or {}).get("procs", [])
            spans_out.append({"status": st, "trace_id": tid, "procs": procs,
                              "b_spans": sum(s.get("proc") == f"worker-{wid_b}"
                                             for s in (trace or {}).get("spans", []))})
        # The router sends each to B, which holds its prefix; a trace the
        # router sent to A carries A's spans instead (through A's sink).
        check(all(s["status"] == 200 and any(p.startswith("worker-") for p in s["procs"])
                  for s in spans_out) and any(s["b_spans"] > 0 for s in spans_out)
              and b_fallback_lines() == fb_lines0 and bulk_metrics.fallbacks_total == fb0,
              f"traced requests: the serving worker's spans at /traces through the bulk sink, "
              f"B's among them, no fallback ({spans_out}; B's fallback log lines "
              f"+{b_fallback_lines() - fb_lines0})")
        out["spans"] = spans_out

        # -- 6. the watchdog, on A's loop ------------------------------------
        # Two event loops of one process must not talk to one service
        # address at once (the service plane keeps one connection per
        # address per process, and a loop dialing it closes the other
        # loop's): the watchdog, its client and the streams it watches run
        # on A's loop, beside A's own clients.
        await c.on_a(watch_step(c, check, until, out, temps))

    finally:
        torch.cuda.synchronize = c.real_sync
        c.puller.__dict__.pop("pull", None)
    launches = {**kernel_counts(), "threefry_gumbel": noise_launches()}
    check(all(v > 0 for v in launches.values()), f"A launched all three kernels ({launches})")
    graphs1 = dict(engine.compile_counts())
    new_keys = {n: [str(k) for k in set(getattr(engine.programs, n)._signatures) - keys0[n]]
                for n in engine.programs.NAMES}
    check(graphs0 == graphs1, f"A captured no graph while serving ({graphs0} -> {graphs1}, new "
                              f"keys {new_keys})")
    check(c.syncs[0] == 0, f"no torch.cuda.synchronize on A while serving ({c.syncs[0]})")
    out.update(launches=launches, syncs=c.syncs[0], phase_s=time.perf_counter() - t_phase,
               card=CARD, failures=fails)
    log("bulk " + json.dumps(out, default=str))
    return not fails, launches, out


async def watch_step(c, check, until, out, temps):
    """Phase k, step 6, on worker A's event loop: a ``HealthWatchdog``
    over the stack's generate instances with its default prober, drainer
    and latency source, fed by a routed client on this loop; A made a
    straggler, quarantined, drained, reinstated, then made sick, ejected
    and re-registered."""
    from dynamo_tpu_torch.llm.metrics import bulk_metrics
    from dynamo_tpu_torch.runtime.engine import Context, collect
    from dynamo_tpu_torch.runtime.faultinject import faults
    from dynamo_tpu_torch.runtime.health import (
        HealthConfig, HealthWatchdog, health_metrics, quarantine_key, worker_latency)
    from dynamo_tpu_torch.runtime.resilience import metrics as res_metrics

    engine, request, art = c.engine, c.request, c.server.service
    wid_a, wid_b = c.wid_a, c.wid_b
    ns, comp, ep = c.endpoint
    client = await art.namespace(ns).component(comp).endpoint(ep).client()
    echo_client = await art.namespace("dynamo").component("EchoWorker").endpoint(
        "generate").client()
    dog = None

    async def direct(wid, req):
        return await collect(await client.generate(Context(dict(req)), worker_id=wid))

    async def marker_settles(want, timeout=5.0):
        """The watchdog sets a worker's state before it writes the hub
        marker that follows it: wait for the write."""
        end = time.perf_counter() + timeout
        while not want(await art.hub.kv_get(quarantine_key(wid_a))):
            if time.perf_counter() > end:
                return False
            await asyncio.sleep(0.02)
        return True

    try:
        await echo_client.wait_for_instances(30)
        wprompts = dist_prompts(2, WATCH_ISL, 75)
        wseeds = (None, 4545)
        wreqs = [request(p, WATCH_OSL, temps[i], wseeds[i], logprobs=MIGRATE_LOGPROBS)
                 for i, p in enumerate(wprompts)]
        warm = [request(p, 40, temps[i], wseeds[i], logprobs=MIGRATE_LOGPROBS)
                for i, p in enumerate(wprompts)]
        for r in warm + warm:
            await c.alone(r)
        await c.together(warm)
        pace_prompts = dist_prompts(2 * WATCH_FAST + 1, WATCH_FAST_ISL, 76)
        await direct(wid_b, request(pace_prompts[0], 24))  # B's programs for this shape

        async def fleet_pace(prompts):
            """A fresh latency window: the fleet's pace as this client sees
            it, B's and the echo worker's."""
            worker_latency.reset()
            for p in prompts:
                await direct(wid_b, request(p, 24))
            await collect(await echo_client.generate(Context(request(list(range(1, 25)), 24))))

        health_metrics.reset()
        await fleet_pace(pace_prompts[1:WATCH_FAST + 1])
        a_addr = c.infos[wid_a]["address"]
        splices0 = res_metrics.migration_splices_total
        bw0 = bulk_metrics.snapshot()

        async def pace():
            await asyncio.sleep(WATCH_PACE_S)

        engine.pace_hook = pace
        faults.arm("slow_stream", match=a_addr, delay_s=WATCH_STREAM_DELAY_S)
        t_arm = time.perf_counter()
        wres = [[] for _ in wreqs]

        async def consume(i):
            async for item in await client.generate(Context(dict(wreqs[i])), worker_id=wid_a):
                wres[i].append(item)

        wtasks = [asyncio.ensure_future(consume(i)) for i in range(len(wreqs))]
        dog = await HealthWatchdog(art.hub, f"instances/{ns}/{comp}/{ep}/",
                                   config=HealthConfig(**WATCH_CFG)).start()

        def state(wid):
            rec = dog.workers.get(wid)
            return rec.state if rec is not None else None

        check(await until(lambda: state(wid_a) == "quarantined", 60),
              f"A quarantined as a straggler ({state(wid_a)})")
        t_q = time.perf_counter()
        snap = worker_latency.snapshot()
        marker = await art.hub.kv_get(quarantine_key(wid_a))
        check((marker or {}).get("state") == "quarantined"
              and dog.workers[wid_a].reason == "latency_outlier",
              f"A's quarantine marker ({marker}, {dog.workers[wid_a].reason})")
        check(await until(lambda: health_metrics.drained_sequences_total >= 2, 120),
              f"the default drainer moved A's 2 live streams "
              f"({health_metrics.drained_sequences_total})")
        t_drained = time.perf_counter()
        bw1 = bulk_metrics.snapshot()
        check(bw1["transfers_total"] > bw0["transfers_total"]
              and bw1["fallbacks_total"] == bw0["fallbacks_total"],
              f"the drain's copy stream rode the bulk plane ({bw0} -> {bw1})")
        engine.pace_hook = None
        faults.disarm("slow_stream")
        await asyncio.gather(*wtasks)
        for i, items in enumerate(wres):
            n = sum(len(it.get("token_ids", [])) for it in items)
            check(n == WATCH_OSL and items and items[-1].get("finish_reason") == "length",
                  f"drained stream {i} whole ({n} tokens)")
        spliced = res_metrics.migration_splices_total - splices0
        check(spliced == 2, f"this client spliced both drained streams ({spliced})")
        check(state(wid_b) == "healthy", f"B healthy ({state(wid_b)})")
        # A's own streams are back at the fleet's pace; the window that
        # held its slow samples (and the drained streams' catch-up) is
        # replaced by a fresh one.
        await fleet_pace(pace_prompts[WATCH_FAST + 1:])
        for i in range(WATCH_FAST):
            await direct(wid_a, request(dist_prompts(1, WATCH_FAST_ISL, 77 + i)[0],
                                        WATCH_FAST_OSL))
        check(await until(lambda: state(wid_a) == "healthy", 30), f"A reinstated ({state(wid_a)})")
        t_r = time.perf_counter()
        check(t_r - t_q < WATCH_CFG["eject_grace_s"]
              and await marker_settles(lambda m: m is None),
              "A reinstated before the grace ended, its marker cleared")
        # Ejection: A's __health__ answers only after the probe's timeout.
        dog.config.eject_grace_s = WATCH_EJECT_GRACE_S
        akey = sorted(dog.workers[wid_a].keys)[0]
        calls = [0]
        real_generate = engine.generate

        async def counting_generate(req):
            calls[0] += 1
            return await real_generate(req)

        engine.generate = counting_generate
        faults.arm("delay", match="__health__", delay_s=WATCH_HEALTH_DELAY_S)
        t_sick = time.perf_counter()
        check(await until(lambda: state(wid_a) == "ejected", 30), f"A ejected ({state(wid_a)})")
        t_e = time.perf_counter()
        await marker_settles(lambda m: (m or {}).get("state") == "ejected")
        marker = await art.hub.kv_get(quarantine_key(wid_a))
        gone = await art.hub.kv_get(akey) is None
        check(gone and (marker or {}).get("state") == "ejected" and state(wid_b) == "healthy",
              f"A's registration deleted ({gone}), its marker ejected ({marker}), B "
              f"{state(wid_b)}")
        calls0 = calls[0]
        eresults = [await dist_complete(c.fport, dist_prompts(1, WATCH_FAST_ISL, 77 + i)[0], 8)
                    for i in range(WATCH_FAST)]
        check(all(r[0] == 200 and r[3] == 8 for r in eresults) and calls[0] == calls0,
              f"after the eject the frontend routes to B only: {[r[0] for r in eresults]}, "
              f"A served {calls[0] - calls0}")
        del engine.generate
        faults.disarm("delay")
        # The operator brings A back: its registration is put again.
        await art.register_key(akey, art._registrations[akey])
        check(await until(lambda: state(wid_a) == "healthy", 10)
              and await art.hub.kv_get(quarantine_key(wid_a)) is None,
              f"re-registration reset A ({state(wid_a)})")
        hm = health_metrics
        # A tick resets a re-registered record at its start and recounts
        # the state gauge at its end, after that tick's probes: wait for it.
        await until(lambda: hm.state_counts == {"healthy": 2}, 10)
        counts = dict(quarantines=hm.quarantines_total, recoveries=hm.recoveries_total,
                      ejections=hm.ejections_total, drains=hm.drains_total,
                      drained_sequences=hm.drained_sequences_total,
                      stragglers_detected=hm.stragglers_detected_total,
                      probes=hm.probes_total, probe_failures=hm.probe_failures_total,
                      corruption_quarantines=hm.corruption_quarantines_total,
                      states=dict(hm.state_counts))
        check(counts["quarantines"] == 2 and counts["recoveries"] == 1
              and counts["ejections"] == 1 and counts["drains"] == 2
              and counts["drained_sequences"] == 2 and counts["stragglers_detected"] >= 2
              and counts["probe_failures"] >= 2 and counts["corruption_quarantines"] == 0
              and counts["states"] == {"healthy": 2},
              f"dynamo_tpu_health_* match the transitions ({counts})")
        out["watchdog"] = dict(
            counts=counts, a_itl_p50_ms=(snap.get(wid_a) or {}).get("itl_p50_ms"),
            a_ttft_p50_ms=(snap.get(wid_a) or {}).get("ttft_p50_ms"),
            fleet_itl_p50_ms={str(w): (v or {}).get("itl_p50_ms") for w, v in snap.items()},
            fleet_ttft_p50_ms={str(w): (v or {}).get("ttft_p50_ms") for w, v in snap.items()},
            drain_bulk_bytes=bw1["bytes_total"] - bw0["bytes_total"],
            arm_to_quarantine_s=t_q - t_arm, quarantine_to_drained_s=t_drained - t_q,
            quarantine_to_reinstated_s=t_r - t_q, sick_to_ejected_s=t_e - t_sick,
            render_lines=len(hm.render().splitlines()))
    finally:
        engine.pace_hook = None
        engine.__dict__.pop("generate", None)
        faults.disarm("slow_stream")
        faults.disarm("delay")
        if dog is not None:
            await dog.stop()
        await echo_client.close()
        await client.close()


# ------------------------------------------------------------------ phase m
# Checkpoints, the sentencepiece tokenizer and batched multi-LoRA.
CKPT_MODEL = "llama-3.1-8b"
# The checkpoint is written at full depth: 16.06 GB of bf16 shards.
CKPT_SHARD_BYTES = 5 << 30
CKPT_ISLS = (300, 517, 1024)  # the id prompts; the fourth request is a text
CKPT_OSL = 32
SP_PIECES = 128256  # llama-3.1-8b's vocabulary, laid out as its ids are
SP_TEXTS = (
    "Name three colours of the sea.",
    "The quick brown fox jumps over the lazy dog, 42 times!",
    "tokenizers round-trip: ids -> text -> ids (sentencepiece unigram)",
    "A",
)
# The checkpoint's tokenizer.json: llama-3.1's 128000 BPE tokens and 256
# specials (tools/synth_tokenizer.py), served by --checkpoint alone.
HF_TOKENS = 128000
HF_TEXTS = ("héllo wörld — ünïcödé: 中文字符, 😀👍🏽, Ελληνικά, русский\r\n\ttabs  and  spaces",
            "def f(x):\n    return x ** 2  # 12345678\n\n\n")
HF_ENCODE_IDS = (512, 2048, 4096)
CKPT_CHAT = [{"role": "system", "content": "You are a concise assistant."},
             {"role": "user", "content": "Name three colours of the sea."}]
CKPT_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "The weather <now> in a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]
LORA_RANK = 16
LORA_SLOTS = 4
LORA_RANDOM = 5  # adapters drawn by --lora NAME=random:SEED; one more is a PEFT directory
LORA_REQUESTS = 16
LORA_ISL = 1024
LORA_OSL = 64
LORA_ARGV = [
    "run", "in=http", "out=torch", "--arch", CKPT_MODEL, "--dtype", "bfloat16",
    "--block-size", "16", "--num-blocks", "2048", "--max-batch", "16",
    "--max-model-len", "2048", "--prefill-chunk", "512", "--decode-steps", "8",
    "--port", "0", "--model", "base", "--lora-max-adapters", str(LORA_SLOTS),
    "--lora-rank", str(LORA_RANK),
]
LORA_SOLO = (0, 1, 5, 6)  # burst requests served again alone: base, a0, a4, peft
LORA_CHECK_LAYERS = 2
LORA_CHECK_TOL = 1e-4
LORA_TIME_ITERS = 20


def sp_model_proto(n, seed):
    """A sentencepiece unigram ``ModelProto`` of ``n`` pieces written by
    ``llm/sp.build_model_proto``, laid out as llama-3.1's ids are: <unk>,
    the 128 ASCII byte pieces, every printable ASCII character (so any
    ASCII text is covered), random words up to id 128000, then 256 control
    pieces with <|begin_of_text|> (bos) at 128000 and <|end_of_text|>
    (eos) at 128001.  No byte piece above 0x7f: a random stream decodes to
    valid UTF-8 piece by piece."""
    from dynamo_tpu_torch.llm.sp import BYTE, CONTROL, NORMAL, UNKNOWN, WS, build_model_proto

    rng = random.Random(seed)
    pieces = [("<unk>", 0.0, UNKNOWN)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(128)]
    pieces += [(WS, -10.0, NORMAL)] + [(chr(c), -10.0, NORMAL) for c in range(33, 127)]
    seen = {p for p, _, _ in pieces}
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(pieces) < 128000:
        w = "".join(rng.choice(letters) for _ in range(rng.randint(2, 7)))
        if rng.random() < 0.5:
            w = WS + w
        if w not in seen:
            seen.add(w)
            pieces.append((w, -1.0 - rng.random() * 8.0, NORMAL))
    specials = ["<|begin_of_text|>", "<|end_of_text|>"] + [
        f"<|reserved_special_token_{i}|>" for i in range(n - 128002)]
    pieces += [(p, 0.0, CONTROL) for p in specials]
    return build_model_proto(pieces, unk_id=0, bos_id=128000, eos_id=128001)


def leaves_equal(torch, got, want, label):
    """Leaf-by-leaf bitwise equality of two params trees; logs the first
    mismatches.  Returns (ok, leaves compared)."""
    bad, n = [], 0
    flat = lambda t: {**{k: v for k, v in t.items() if k != "layers"},  # noqa: E731
                      **{f"layers.{k}": v for k, v in t["layers"].items()}}
    g, w = flat(got), flat(want)
    if set(g) != set(w):
        log(f"{label}: leaves differ: {sorted(set(g) ^ set(w))}")
        return False, 0
    for k in sorted(w):
        n += 1
        a, b = g[k], w[k]
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad.append(k)
    if bad:
        log(f"{label}: {len(bad)} leaves differ, first {bad[:4]}")
    return not bad, n


async def engine_one_at_a_time(engine, prompts, max_tokens):
    """Greedy streams of ``prompts`` served one after another (a batch of
    one each): the shapes an HTTP client sending one at a time gets."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context, collect

    out = []
    for p in prompts:
        req = PreprocessedRequest(
            token_ids=list(p), stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0)).to_dict()
        items = await collect(await engine.generate(Context(req)))
        out.append([t for it in items for t in it["token_ids"]])
    return out


def checkpoint_path(torch, dev, tmp):
    """Phase m, steps 1-3: write llama-3.1-8b's seeded init as a sharded
    bf16 checkpoint with its config.json, load it back in bf16 and under
    ``quant="int8"`` (each held leaf by leaf, bitwise, against the init
    tree and ``quantize_params`` of it); write phase n's sentencepiece
    model and, into the checkpoint, a llama-3.1-format tokenizer.json and
    tokenizer_config.json (load, round trips, encode and render times);
    then serve through ``run in=http out=torch --checkpoint DIR``, which
    picks the tokenizer.json: 4 completions and a chat request one at a
    time, the text and the chat also streamed, texts equal to the decode
    of the same seeded init's streams served directly, prompt lengths as
    the tokenizer and template give them; then the chat TTFT against its
    ids sent as a completion.  Returns (ok, launches, numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer, SentencePieceTokenizer
    from dynamo_tpu_torch.tools import synth_tokenizer
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.llama import init_params
    from dynamo_tpu_torch.models.loader import load_params, save_params_hf
    from dynamo_tpu_torch.models.quant import quantize_params

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"checkpoint check FAILED: {what}")

    mc = get_config(CKPT_MODEL)
    ckpt = os.path.join(tmp, "ckpt")
    with torch.inference_mode():
        init = init_params(mc, 0, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        files = save_params_hf(init, ckpt, max_shard_bytes=CKPT_SHARD_BYTES, config=mc)
        out["write_s"] = time.perf_counter() - t0
        out["bytes"] = sum(os.path.getsize(f) for f in files)
        for quant in (None, "int8"):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loaded = load_params(mc, ckpt, quant=quant, device=dev)
            torch.cuda.synchronize()
            key = quant or "bf16"
            out[f"load_{key}_s"] = time.perf_counter() - t0
            out[f"load_{key}_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            out[f"load_{key}_tree_gib"] = (torch.cuda.memory_allocated() - base) / 2**30
            want = init if quant is None else quantize_params(init)
            ok, n = leaves_equal(torch, loaded, want, f"checkpoint {key}")
            check(ok and n > 0, f"{key} load equals the {'init tree' if quant is None else 'quantize_params of it'} bitwise ({n} leaves)")
            out[f"{key}_leaves"] = n
            del loaded, want
            torch.cuda.empty_cache()
    log(f"checkpoint: {len(files)} files, {out['bytes'] / 1e9:.3f} GB written in "
        f"{out['write_s']:.1f} s; load bf16 {out['load_bf16_s']:.1f} s (tree "
        f"{out['load_bf16_tree_gib']:.2f} GiB, peak {out['load_bf16_peak_gib']:.2f} GiB over it), "
        f"load int8 {out['load_int8_s']:.1f} s (tree {out['load_int8_tree_gib']:.2f} GiB, peak "
        f"{out['load_int8_peak_gib']:.2f} GiB); {out['bf16_leaves']} + {out['int8_leaves']} "
        f"leaves compared")

    # Phase n's sentencepiece tokenizer at llama-3.1's vocabulary size.
    sp_path = os.path.join(tmp, "tokenizer.model")
    with open(sp_path, "wb") as f:
        f.write(sp_model_proto(SP_PIECES, 14))
    sp = SentencePieceTokenizer(sp_path)
    check(sp.vocab_size == SP_PIECES and sp.bos_token_id == 128000
          and sp.eos_token_id == 128001, f"sentencepiece: {sp.vocab_size} pieces, bos/eos ids")
    for text in SP_TEXTS:
        ids = sp.encode(text)
        check(sp.decode(ids) == text and ids[0] == 128000 and max(ids) < SP_PIECES,
              f"sentencepiece round trip of {text!r}: {sp.decode(ids)!r}")

    # The checkpoint's own tokenizer.json and tokenizer_config.json, in
    # llama-3.1's format (tools/synth_tokenizer.py, from a seed).
    t0 = time.perf_counter()
    synth_tokenizer.write(ckpt, HF_TOKENS, 14)
    out["tokenizer_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok = HFTokenizer.from_pretrained_dir(ckpt)
    out["tokenizer_load_s"] = time.perf_counter() - t0
    check(tok.vocab_size == HF_TOKENS + 256 and tok.bos_token_id == 128000
          and tok.eos_token_id == 128009,
          f"tokenizer.json: {tok.vocab_size} tokens, bos {tok.bos_token_id}, eos {tok.eos_token_id}")
    for text in SP_TEXTS + HF_TEXTS:
        ids = tok.encode(text)
        check(tok.decode(ids) == text and ids[0] == 128000 and max(ids[1:]) < HF_TOKENS,
              f"tokenizer.json round trip of {text!r}: {tok.decode(ids)!r} ({ids[:4]}...)")
    out["encode_ms"] = hf_encode_times(tok)
    out["render_ms"] = hf_render_times(tok)
    log(f"tokenizer.json: {HF_TOKENS} BPE tokens + 256 specials written in "
        f"{out['tokenizer_write_s']:.2f} s, loaded in {out['tokenizer_load_s']:.3f} s; encode "
        + ", ".join(f"{n} ids {c:.2f} ms cold / {w:.2f} ms warm"
                    for n, (c, w) in out["encode_ms"].items())
        + f"; chat template render {out['render_ms'][0]:.3f} ms first (compile) / "
        f"{out['render_ms'][1]:.3f} ms warm")

    gen = torch.Generator().manual_seed(15)
    prompts = [torch.randint(1, 128000, (n,), generator=gen).tolist() for n in CKPT_ISLS]
    text_prompt = SP_TEXTS[1]
    prompts.append(tok.encode(text_prompt))
    # As the preprocessor renders a chat request without tools.
    chat_prompt = tok.apply_chat_template(CKPT_CHAT, add_generation_prompt=True, tools=None)
    chat_ids = tok.encode(chat_prompt, add_special_tokens=False)
    check(chat_ids[0] == 128000 and chat_ids.count(128000) == 1 and 128009 in chat_ids,
          f"chat prompt: one <|begin_of_text|> at 0 and <|eot_id|> ({chat_ids[:8]}...)")
    prompts.append(chat_ids)

    # The same seeded init served directly, one request at a time.
    cfg = EngineConfig(model=CKPT_MODEL, dtype="bfloat16", block_size=PS, num_blocks=512,
                       max_batch=4, max_model_len=2048, prefill_chunk=512, decode_steps=8, seed=0)
    engine = TorchEngine(cfg, params=init, device=dev)
    del init

    async def direct():
        try:
            return await engine_one_at_a_time(engine, prompts, CKPT_OSL)
        finally:
            await engine.close()

    want = asyncio.run(direct())
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # The checkpoint serve, as a user starts it: the CLI picks the
    # directory's tokenizer.json (no --tokenizer).
    argv = ["run", "in=http", "out=torch", "--checkpoint", ckpt,
            "--dtype", "bfloat16", "--block-size", "16", "--num-blocks", "512", "--max-batch", "4",
            "--max-model-len", "2048", "--prefill-chunk", "512", "--decode-steps", "8",
            "--port", "0", "--model", "ckpt"]
    t0 = time.perf_counter()
    server = CliServer(argv)
    out["server_up_s"] = time.perf_counter() - t0
    port = server.service.port
    check(server.engine.model_config.num_layers == mc.num_layers
          and server.engine.model_config.vocab_size == mc.vocab_size,
          f"architecture from config.json: {server.engine.model_config}")
    check(type(server.tokenizer).__name__ == "HFTokenizer",
          f"the server's tokenizer is HFTokenizer ({type(server.tokenizer).__name__})")
    served_tok = server.tokenizer if server.tokenizer is not None else tok
    body = {"model": "ckpt", "max_tokens": CKPT_OSL, "temperature": 0, "nvext": {"ignore_eos": True}}
    zero_kernel_counts()
    try:
        async def phase():
            got = []
            for i, p in enumerate(prompts[:-1]):
                req = dict(body, prompt=text_prompt if i == len(prompts) - 2 else p)
                st, _, raw, _ = await http_call(port, "POST", "/v1/completions", req)
                check(st == 200, f"checkpoint request {i}: status {st} {raw[:200]!r}")
                got.append(json.loads(raw) if st == 200 else {})
            # Each streamed request against a unary one over the same
            # cached prefix (a prefix hit changes the step's shape, and so
            # may a random model's near-tied argmax; phase 7 does the same).
            for route, req, delta in (
                    ("/v1/completions", dict(body, prompt=text_prompt), "text"),
                    ("/v1/chat/completions", dict(body, messages=CKPT_CHAT), "content")):
                if delta == "content":
                    st, _, raw, _ = await http_call(port, "POST", route, req)
                    check(st == 200, f"chat request: status {st} {raw[:200]!r}")
                    got.append(json.loads(raw) if st == 200 else {})
                st, _, _, ev = await http_call(port, "POST", route, dict(req, stream=True))
                check(st == 200, f"streamed {route}: status {st}")
                chunks, done = sse_data(ev) if st == 200 else ([], False)
                stream = "".join((c["choices"][0].get("delta") or {}).get("content") or ""
                                 if delta == "content" else c["choices"][0].get("text") or ""
                                 for _, c in chunks if c["choices"])
                st, _, raw, _ = await http_call(port, "POST", route, req)
                res = json.loads(raw) if st == 200 else {}
                unary = ((res.get("choices") or [{}])[0].get("message") or {}).get("content") \
                    if delta == "content" else (res.get("choices") or [{}])[0].get("text")
                check(done and stream == unary and unary is not None,
                      f"{route}: the streamed deltas joined equal the unary text over the same "
                      f"cached prefix ({stream[:60]!r} vs {str(unary)[:60]!r})")
            return got

        got = asyncio.run(phase())
        launches = kernel_counts()
        out["chat_ttft_ms"], out["ids_ttft_ms"] = asyncio.run(chat_vs_ids_ttft(port, chat_ids))
    finally:
        server.stop()
    n_done = len(prompts) - 1  # the completions: the id prompts, then the text
    same = 0
    for i, (res, ids) in enumerate(zip(got[:n_done], want[:n_done])):
        if not res:
            continue
        text = res["choices"][0]["text"]
        usage = res["usage"]
        good = (text == served_tok.decode(ids) and usage["completion_tokens"] == len(ids) == CKPT_OSL
                and usage["prompt_tokens"] == len(prompts[i]))
        same += good
        check(good, f"checkpoint request {i}: text equals the direct stream's decode "
                    f"({usage}, {text[:60]!r} vs {served_tok.decode(ids)[:60]!r})")
    chat = got[n_done] if len(got) > n_done else {}
    if chat:
        chat_want = served_tok.decode(want[-1])
        good = (chat["choices"][0]["message"]["content"] == chat_want
                and chat["usage"]["prompt_tokens"] == len(chat_ids))
        same += good
        check(good, f"chat: the rendered template's ids ({chat['usage']} vs {len(chat_ids)}) and "
                    f"the direct stream's decode "
                    f"({chat['choices'][0]['message']['content'][:60]!r} vs {chat_want[:60]!r})")
    log(f"checkpoint serve: {same}/{n_done + 1} streams through --checkpoint (its tokenizer.json) "
        f"equal the seeded init's served directly (prompts {[len(p) for p in prompts]}, the "
        f"fourth the text {text_prompt!r}, the last the chat template's {len(chat_ids)} ids); "
        f"server up in {out['server_up_s']:.1f} s (load and build); launches {launches}; chat TTFT "
        f"{statistics.median(out['chat_ttft_ms']):.2f} ms against "
        f"{statistics.median(out['ids_ttft_ms']):.2f} ms for its ids as a completion (medians of "
        f"{len(out['chat_ttft_ms'])}: {fmt_ms(out['chat_ttft_ms'])} / {fmt_ms(out['ids_ttft_ms'])})")
    out["launches"] = launches
    return not fails and all(v > 0 for v in launches.values()), launches, out


def fmt_ms(xs):
    return ", ".join(f"{x:.2f}" for x in xs)


def hf_encode_times(tok):
    """{ids: (first encode ms, median repeat ms)} of seeded texts cut to
    512, 2048 and 4096 ids: words drawn by ``synth_tokenizer.words`` from
    another seed than the vocabulary's (so few are whole tokens), with
    HF_TEXTS' Unicode lines between them.  The model's per-pre-token
    cache is emptied before each first encode, so that one is cold."""
    from dynamo_tpu_torch.tools.synth_tokenizer import words

    out = {}
    for n in HF_ENCODE_IDS:
        stream, parts = words(random.Random(1000 + n)), []
        for i in range(n):
            parts.append(next(stream))
            if i % 97 == 96:
                parts.append(HF_TEXTS[(i // 97) % len(HF_TEXTS)])
        ids = tok.encode("".join(parts), add_special_tokens=False)[:n]
        text = tok.decode(ids)
        tok._tok.model._cache.clear()
        t0 = time.perf_counter()
        got = tok.encode(text, add_special_tokens=False)
        cold = (time.perf_counter() - t0) * 1e3
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            tok.encode(text, add_special_tokens=False)
            warm.append((time.perf_counter() - t0) * 1e3)
        out[len(got)] = (cold, statistics.median(warm))
    return out


def hf_render_times(tok):
    """The chat template's first render (its compile included) and the
    median of 20 more, in ms, over CKPT_CHAT with a tool."""
    from dynamo_tpu_torch.llm import chat_template  # imported outside the timing

    chat_template.compile_template.cache_clear()
    times = []
    for _ in range(21):
        t0 = time.perf_counter()
        tok.apply_chat_template(CKPT_CHAT, add_generation_prompt=True, tools=CKPT_TOOLS)
        times.append((time.perf_counter() - t0) * 1e3)
    return times[0], statistics.median(times[1:])


async def chat_vs_ids_ttft(port, chat_ids, turns=3):
    """TTFT of the chat request, streamed, against its rendered ids sent
    as a streamed completion, in turns (both prefixes cached by then)."""
    chat, ids = [], []
    body = {"model": "ckpt", "max_tokens": 4, "temperature": 0, "stream": True,
            "nvext": {"ignore_eos": True}}
    for _ in range(turns):
        for route, req, sink in (("/v1/chat/completions", dict(body, messages=CKPT_CHAT), chat),
                                 ("/v1/completions", dict(body, prompt=chat_ids), ids)):
            st, _, _, ev = await http_call(port, "POST", route, req)
            chunks, _ = sse_data(ev) if st == 200 else ([], False)
            sink.append(chunks[0][0] * 1e3 if chunks else float("nan"))
    return chat, ids


def lora_prompts(torch, n, isl, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(1, 128000, (isl,), generator=gen).tolist() for _ in range(n)]


def lora_rows_check(torch, engine):
    """Base rows under LoRA equal LoRA-off rows in the same batch: the
    LoRA engine's own weights and banks (adapters resident), a 16-row
    prefill step of 64 ids a row, rows cycling through slots -1, 0, 1, 2,
    3, then a decode step of the same rows, forwarded once with the
    per-token slots and once without (the path of an engine without
    banks).  Base rows' logits must be bitwise equal; adapter rows must
    move.  Returns ok."""
    from dynamo_tpu_torch.models.llama import PagedKVCache, RaggedBatch, forward_ragged

    mc, dev, r = engine.model_config, engine.device, engine.cfg.lora.rank
    S, n = 16, 64
    prompts = lora_prompts(torch, S, n, 21)
    slots = [(i % (LORA_SLOTS + 1)) - 1 for i in range(S)]
    tables = [[i * 5 + j for j in range(5)] for i in range(S)]
    ok = True
    with torch.inference_mode():
        caches = [PagedKVCache.create(mc, 5 * S, PS, torch.bfloat16, dev) for _ in range(2)]
        rb = rows_batch(torch, dev, prompts, tables)
        tok_slots = torch.tensor([s for s in slots for _ in range(n)], dtype=torch.int32,
                                 device=dev)
        steps = [("prefill", rb._replace(adapter_slots=tok_slots), False)]
        nxt = torch.randint(1, 128000, (S,), generator=torch.Generator().manual_seed(22)).tolist()

        def t(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        drb = RaggedBatch(token_ids=t(nxt), positions=t([n] * S),
                          slot_mapping=t([tb[n // PS] * PS + n % PS for tb in tables]),
                          kv_lens=t([n + 1] * S), page_indices=t(tables),
                          cu_q_lens=t(list(range(S + 1))), num_seqs=t([S]),
                          adapter_slots=t(slots))
        steps.append(("decode", drb, True))
        for label, b, decode in steps:
            on = forward_ragged(engine.params, mc, b, caches[0], decode=decode, lora_rank=r)
            off = forward_ragged(engine.params, mc, b._replace(adapter_slots=None), caches[1],
                                 decode=decode, lora_rank=r)
            base = [i for i, s in enumerate(slots) if s < 0]
            lora = [i for i, s in enumerate(slots) if s >= 0]
            same = torch.equal(on[base], off[base])
            moved = min(float((on[i] - off[i]).abs().max()) for i in lora)
            good = same and moved > 0 and bool(torch.isfinite(on).all())
            ok = ok and good
            log(f"lora rows {label}: base rows {base} bitwise equal to the LoRA-off forward "
                f"{same}; adapter rows move the logits by >= {moved:.3e} "
                f"{'ok' if good else 'FAIL'}")
    return ok


def lora_dense_check(torch, dev):
    """Phase m, step 5: llama-3.1-8b in f32 at full width and
    LORA_CHECK_LAYERS layers, banks of LORA_SLOTS rank-LORA_RANK slots
    holding adapters of ranks 16, 8, 4 and 16: a prefill step of 5 rows
    (slots -1, 0..3, 40..72 ids) then a decode step, each row's logits
    against a dense reference whose attention weights are merged per row
    (W + A_s B_s), at rtol = atol = LORA_CHECK_TOL.  Returns ok."""
    from dynamo_tpu_torch.llm.tenancy.lora import LORA_TARGETS, LoraAdapter, padded_factors
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.llama import (
        PagedKVCache, RaggedBatch, forward_ragged, fuse_projections, init_params,
    )
    import numpy as np

    mc = get_config(CKPT_MODEL).with_overrides(dtype="float32", num_layers=LORA_CHECK_LAYERS)
    base = init_params(mc, 0, dev)
    adapters = [LoraAdapter.random(mc, f"m{i}", rank=rk, seed=300 + i)
                for i, rk in enumerate((16, 8, 4, 16))]
    layers = dict(fuse_projections(base)["layers"])
    for tgt in LORA_TARGETS:
        pads = [padded_factors(a, mc, tgt, LORA_RANK) for a in adapters]
        layers[f"lora_a_{tgt}"] = torch.from_numpy(np.concatenate([p[0] for p in pads], 2)).to(dev)
        layers[f"lora_b_{tgt}"] = torch.from_numpy(np.concatenate([p[1] for p in pads], 1)).to(dev)
    paged = dict(fuse_projections(base), layers=layers)
    slots = [-1, 0, 1, 2, 3]
    lens = [40, 48, 56, 64, 72]
    gen = torch.Generator().manual_seed(31)
    prompts = [torch.randint(1, 128000, (n + 1,), generator=gen).tolist() for n in lens]
    S = 16
    tables = [[i * 6 + j for j in range(6)] for i in range(len(prompts))]
    tables += [[0] * 6] * (S - len(prompts))
    ok = True
    with torch.inference_mode():
        want = []
        for p, sl in zip(prompts, slots):
            merged = {k: v for k, v in base.items() if k != "layers"}
            ml = dict(base["layers"])
            if sl >= 0:
                for tgt in LORA_TARGETS:
                    a, b = adapters[sl].factors[tgt]
                    ml[tgt] = ml[tgt] + torch.from_numpy(np.einsum("lir,lro->lio", a, b)).to(dev)
            merged["layers"] = ml
            want.append(reference_logits(torch, merged, mc, p))
        cache = PagedKVCache.create(mc, 6 * len(prompts), PS, torch.float32, dev)
        heads = [p[:-1] for p in prompts]
        rb = rows_batch(torch, dev, heads, tables[:len(prompts)])
        tok_slots = torch.tensor([s for s, h in zip(slots, heads) for _ in h], dtype=torch.int32,
                                 device=dev)
        T = rb.token_ids.shape[0]
        tok_slots = torch.cat([tok_slots, torch.full((T - tok_slots.numel(),), -1,
                                                     dtype=torch.int32, device=dev)])
        cu = rb.cu_q_lens.tolist() + [rb.cu_q_lens[-1].item()] * (S - len(prompts))
        pad = S - len(prompts)

        def t(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        rb = rb._replace(kv_lens=t(rb.kv_lens.tolist() + [0] * pad), page_indices=t(tables),
                         cu_q_lens=t(cu), adapter_slots=tok_slots)
        got = forward_ragged(paged, mc, rb, cache, lora_rank=LORA_RANK)
        drb = RaggedBatch(
            token_ids=t([p[-1] for p in prompts] + [0] * pad),
            positions=t(lens + [0] * pad),
            slot_mapping=t([tb[n // PS] * PS + n % PS for tb, n in zip(tables, lens)] + [-1] * pad),
            kv_lens=t([n + 1 for n in lens] + [1] * pad), page_indices=t(tables),
            cu_q_lens=t(list(range(S + 1))), num_seqs=t([S]),
            adapter_slots=t(slots + [-1] * pad))
        dgot = forward_ragged(paged, mc, drb, cache, decode=True, lora_rank=LORA_RANK)
        worst = 0.0
        for i, n in enumerate(lens):
            for label, g, w in (("prefill", got[i], want[i][n - 1]), ("decode", dgot[i], want[i][n])):
                err = float((g - w).abs().max())
                worst = max(worst, err)
                good = bool(torch.isfinite(g).all()) and torch.allclose(
                    g, w, rtol=LORA_CHECK_TOL, atol=LORA_CHECK_TOL)
                ok = ok and good
                if not good:
                    log(f"lora f32 row {i} (slot {slots[i]}) {label}: max_abs_err {err:.3e} FAIL")
        # Not blind: the adapters move the reference by far more than the tolerance.
        spread = min(float((want[i][lens[i]] - reference_logits(torch, base, mc, prompts[i])[lens[i]])
                           .abs().max()) for i in range(1, len(prompts)))
    sensitive = spread > 10 * LORA_CHECK_TOL
    log(f"lora f32 {LORA_CHECK_LAYERS} layers at full width, slots {slots} in one batch: worst "
        f"max_abs_err {worst:.3e} vs the per-row merged dense reference, tol {LORA_CHECK_TOL} "
        f"{'ok' if ok else 'FAIL'}; adapters move the reference by >= {spread:.3e} "
        f"({'ok' if sensitive else 'blind — FAIL'})")
    del base, paged, layers, cache
    torch.cuda.empty_cache()
    return ok and sensitive


def lora_dispatch_times(torch, on, off):
    """Phase m, step 6: a fused decode dispatch (16 rows at 1024 ids of
    context) and a 512-token prefill step (16 rows of 32 ids over 1024),
    each replayed on the LoRA engine with every row on an adapter, with
    every row on the base model (slot -1: the LoRA matmuls still run),
    and on an engine without banks sharing its weights, in turns.  CUDA
    events around LORA_TIME_ITERS dispatches.  Returns {label: ms}."""
    import numpy as np

    cfg = on.cfg
    S, PP, bs = cfg.max_batch, cfg.max_blocks_per_seq, cfg.block_size
    ctx, new = 1024, 32
    tables = np.zeros((S, PP), np.int32)
    per = (ctx + new) // bs + 1
    for i in range(S):
        tables[i, :per] = np.arange(i * per, (i + 1) * per)
    adapters = np.arange(S, dtype=np.int32) % LORA_SLOTS
    tok0 = np.ones((S,), np.int64)
    pos0 = np.full((S,), ctx, np.int32)
    limits = np.full((S,), per * bs, np.int32)
    T = S * new
    rb = dict(
        token_ids=np.ones((T,), np.int64),
        positions=np.tile(np.arange(ctx, ctx + new, dtype=np.int32), S),
        slot_mapping=np.concatenate([tables[i, (ctx + np.arange(new)) // bs] * bs
                                     + (ctx + np.arange(new)) % bs for i in range(S)]).astype(np.int32),
        kv_lens=np.full((S,), ctx + new, np.int32), page_indices=tables,
        cu_q_lens=np.arange(0, T + 1, new, dtype=np.int32), num_seqs=np.asarray([S], np.int32))

    def runs(eng, slots):
        samp = eng._sampling_arrays([])
        if slots is not None:
            samp = samp._replace(adapter_slots=slots)
        step = dict(rb)
        if slots is not None:
            step["adapter_slots"] = np.repeat(slots, new)
        return (lambda: eng._run_multi(tok0, pos0, tables, limits, samp),
                lambda: eng._run_step(step, samp))

    cases = {"lora": runs(on, adapters), "lora_base_rows": runs(on, np.full((S,), -1, np.int32)),
             "no_lora": runs(off, None)}
    times = {f"{k}_{w}": [] for k in cases for w in ("decode", "prefill")}
    with torch.inference_mode():
        for turn in ("lora", "no_lora", "lora_base_rows", "lora_base_rows", "no_lora", "lora"):
            for w, fn in zip(("decode", "prefill"), cases[turn]):
                fn()
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(LORA_TIME_ITERS):
                    fn()
                b.record()
                b.synchronize()
                times[f"{turn}_{w}"].append(a.elapsed_time(b) / LORA_TIME_ITERS)
    return {k: min(v) for k, v in times.items()}


def lora_path(torch, dev, tmp):
    """Phase m, steps 4 and 6: llama-3.1-8b in bf16 served by ``run in=http
    out=torch --lora-max-adapters 4 --lora-rank 16`` with five adapters by
    ``--lora aN=random:N`` and one PEFT directory (rank 16, written by
    ``save_lora_adapter``) by ``--lora peft=DIR``; warmed, then 16
    concurrent greedy /v1/completions of 1024-id prompts, 64 new ids each,
    over the base model and all six adapters (more adapters than slots:
    promotions wait for slots to free).  Every stream whole; no graph
    captured after warmup; one prompt under two adapters shares no prefix
    block and under one adapter it does; base rows equal LoRA-off rows
    (``lora_rows_check``); the dispatch times with and without LoRA.
    Returns (ok, launches, numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tenancy.lora import LoraAdapter, kv_salt_for_adapter, save_lora_adapter
    from dynamo_tpu_torch.models.config import get_config

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"lora check FAILED: {what}")

    peft = os.path.join(tmp, "peft")
    save_lora_adapter(LoraAdapter.random(get_config(CKPT_MODEL), "peft", rank=LORA_RANK, seed=77),
                      peft)
    names = [f"a{i}" for i in range(LORA_RANDOM)] + ["peft"]
    argv = list(LORA_ARGV)
    for i in range(LORA_RANDOM):
        argv += ["--lora", f"a{i}=random:{i + 1}"]
    argv += ["--lora", f"peft={peft}"]
    t0 = time.perf_counter()
    server = CliServer(argv)
    port = server.service.port
    engine = server.engine
    warm = server.warmup()
    log(f"lora: server up and warmed in {time.perf_counter() - t0:.1f} s, graphs {warm}, "
        f"adapters {engine.adapter_names()}")
    check(sorted(engine.adapter_names()) == sorted(names), f"adapters {engine.adapter_names()}")
    models = (["base"] + names) * 3
    prompts = lora_prompts(torch, LORA_REQUESTS, LORA_ISL, 19)
    fresh = lora_prompts(torch, 2, LORA_ISL, 20)

    async def complete(model, p, osl=LORA_OSL):
        st, _, raw, _ = await http_call(port, "POST", "/v1/completions", {
            "model": model, "prompt": p, "max_tokens": osl, "temperature": 0,
            "nvext": {"ignore_eos": True}})
        return st, json.loads(raw) if st == 200 else raw

    try:
        zero_kernel_counts()
        promos0 = None

        async def burst():
            return await asyncio.gather(*(complete(models[i], p) for i, p in enumerate(prompts)))

        from dynamo_tpu_torch.llm.metrics import tenancy_metrics

        promos0 = (tenancy_metrics.adapter_promotions, tenancy_metrics.adapter_evictions)
        t0 = time.perf_counter()
        res = asyncio.run(burst())
        out["burst_s"] = time.perf_counter() - t0
        out["launches"] = kernel_counts()
        whole = sum(st == 200 and r["usage"]["completion_tokens"] == LORA_OSL for st, r in res)
        check(whole == LORA_REQUESTS, f"{whole}/{LORA_REQUESTS} LoRA streams whole")
        texts = {}
        for (st, r), m in zip(res, models):
            if st == 200:
                texts.setdefault(m, []).append(r["choices"][0]["text"])
        promos = (tenancy_metrics.adapter_promotions - promos0[0],
                  tenancy_metrics.adapter_evictions - promos0[1])
        log(f"lora burst: {LORA_REQUESTS} concurrent requests of {LORA_ISL} ids, {LORA_OSL} new, "
            f"over {sorted(set(models))}: {whole} whole in {out['burst_s']:.2f} s; promotions "
            f"{promos[0]}, evictions {promos[1]}; launches {out['launches']}")
        check(promos[1] > 0, f"more adapters than slots evicted idle residents ({promos})")

        # Batched vs solo in bf16: reported, not gated (cuBLAS picks GEMM
        # kernels by row count, so a row's logits move with the batch).
        async def solo():
            return [await complete(models[i], prompts[i]) for i in LORA_SOLO]

        same = sum(st == 200 and r["choices"][0]["text"] == res[i][1]["choices"][0]["text"]
                   for i, (st, r) in zip(LORA_SOLO, asyncio.run(solo())))
        out["solo_equal"] = same
        log(f"lora bf16 batched vs solo (not gated): {same}/{len(LORA_SOLO)} streams of the burst "
            f"({[models[i] for i in LORA_SOLO]}) equal the same request served alone")

        # Prefix isolation: a fresh prompt under a0, then a1, then a0 again.
        async def isolation():
            kv = engine.kv
            got = {}
            for label, model, p in (("a0", "a0", fresh[0]), ("a1 after a0", "a1", fresh[0]),
                                    ("a0 again", "a0", fresh[0])):
                m0 = kv.matched_blocks
                st, _ = await complete(model, p, 8)
                got[label] = (st, kv.matched_blocks - m0)
            return got

        iso = asyncio.run(isolation())
        s0, s1 = kv_salt_for_adapter("a0"), kv_salt_for_adapter("a1")
        hit0 = engine.estimate_prefix_hit(fresh[0], s0)
        hit1 = engine.estimate_prefix_hit(fresh[0], s1)
        hit_base = engine.estimate_prefix_hit(fresh[0])
        log(f"lora prefix isolation: matched blocks {iso}; resident prefix under a0 {hit0}, "
            f"a1 {hit1}, base {hit_base} ids")
        check(iso["a1 after a0"] == (200, 0), f"a1 shares no block of a0's prompt ({iso})")
        check(iso["a0 again"][0] == 200 and iso["a0 again"][1] >= (LORA_ISL // PS) - 1,
              f"a0 hits its own prefix ({iso})")
        check(hit_base == 0, f"the base model sees none of the adapters' blocks ({hit_base})")
        after = engine.compile_counts()
        check(after == warm, f"no graph captured after warmup ({warm} -> {after})")
        out["graphs"] = after
        check(lora_rows_check(torch, engine), "base rows under LoRA equal LoRA-off rows")

        # Dispatch times on and off: an engine without banks on the same weights.
        shared = dict(engine.params, layers={k: v for k, v in engine.params["layers"].items()
                                             if not k.startswith("lora_")})
        off_cfg = EngineConfig(model=CKPT_MODEL, dtype="bfloat16", block_size=PS,
                               num_blocks=engine.cfg.num_blocks, max_batch=16,
                               max_model_len=2048, prefill_chunk=512, decode_steps=8)
        off = TorchEngine(off_cfg, params=shared, device=dev)
        times = lora_dispatch_times(torch, engine, off)
        out["times"] = times
        asyncio.run(off.close())
        del off, shared
        for w in ("decode", "prefill"):
            log(f"lora time {w} (16 rows{', 8 fused steps' if w == 'decode' else ', 512 ids'}): "
                f"every row on an adapter {times['lora_' + w]:.3f} ms, every row base "
                f"{times['lora_base_rows_' + w]:.3f} ms, no banks {times['no_lora_' + w]:.3f} ms "
                f"(overhead {times['lora_' + w] / times['no_lora_' + w] - 1:+.1%}) [{CARD}]")
    finally:
        server.stop()
    gc.collect()
    torch.cuda.empty_cache()
    ok = not fails and all(v > 0 for v in out.get("launches", {0: 0}).values())
    return ok, out.get("launches", {}), out


def checkpoint_lora_path(torch, dev, tmp):
    """Phase m: checkpoints, the sentencepiece tokenizer (left in ``tmp``
    as ``tokenizer.model``) and batched multi-LoRA.  Returns (ok, {"ckpt":
    launches, "lora": launches}, numbers)."""
    res = {}
    ok_ckpt, ckpt_launches, res["ckpt"] = checkpoint_path(torch, dev, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    ok_lora, lora_launches, res["lora"] = lora_path(torch, dev, tmp)
    ok_dense = lora_dense_check(torch, dev)
    return (ok_ckpt and ok_lora and ok_dense,
            {"ckpt": ckpt_launches, "lora": lora_launches}, res)


# ------------------------------------------------------------------ phase n
# Structured output: grammar-constrained decoding behind HttpService.
GRAMMAR_MODEL = "structured"
GRAMMAR_OSL = 64
# One small schema (an object of a string, an integer and an enum) and one
# regex.  Phase m's vocabulary holds random words, half of them
# "▁"-prefixed, so the keys, the enum words and the regex's letters are
# where a piece indexed without its rendered space would leave the
# language.
GRAMMAR_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "age": {"type": "integer"},
    "kind": {"enum": ["cat", "dog", "bird"]}}}
GRAMMAR_REGEX = "[0-9]{3}-[a-z]{4}"
# A schema whose language a random model must close within GRAMMAR_OSL
# tokens (every path ends in a state that admits only the end), so that
# its requests end ``stop`` and their outputs are parsed on the card.
GRAMMAR_ENUM_SCHEMA = {"enum": ["cat", "dog", "bird"]}
GRAMMAR_SCHEMA_REQUESTS = 8
GRAMMAR_ENUM_REQUESTS = 2
GRAMMAR_PLAIN_REQUESTS = 8
GRAMMAR_TIME_ITERS = 20


def grammar_argv(sp_path):
    """Phase 6's geometry behind ``run in=http out=torch``, with phase m's
    sentencepiece tokenizer."""
    argv = list(HTTP_ARGV)
    argv[argv.index("--model") + 1] = GRAMMAR_MODEL
    return argv + ["--tokenizer", sp_path]


def enum_value_ok(v):
    """Whether a parsed value is one of GRAMMAR_ENUM_SCHEMA's words."""
    return isinstance(v, str) and v in GRAMMAR_ENUM_SCHEMA["enum"]


def schema_value_ok(v):
    """Whether a parsed value satisfies GRAMMAR_SCHEMA: an object of all
    its properties in order (the schema regex requires each), each of its
    type."""
    props = GRAMMAR_SCHEMA["properties"]
    if not isinstance(v, dict) or list(v) != list(props):
        return False
    return (isinstance(v["name"], str) and isinstance(v["age"], int)
            and not isinstance(v["age"], bool) and v["kind"] in props["kind"]["enum"])


def mask_stage_times(torch, engine, ctx, automaton=None):
    """A decode-shaped unified step of ``engine``'s max_batch rows (one
    token a row at ``ctx`` ids of context, writes dropped), replayed with
    no constrained row and, given ``automaton``, with half the rows under
    its start mask (staged into the step's buffer), in turns; and the
    sampler alone on [rows, V] f32 logits with and without its mask stage
    (what every unified step adds over a sampler without masks), each with
    the bytes it allocates above what was allocated before it (the
    transient the step's graph pool holds for it).  CUDA events around
    GRAMMAR_TIME_ITERS calls.  Returns {label: ms} and {label + "_peak_mb":
    MB} for the sampler cases, with "rows" and "vocab"."""
    import numpy as np

    from dynamo_tpu_torch.ops.sampling import sample_tokens

    cfg = engine.cfg
    S, PP, bs, V = cfg.max_batch, cfg.max_blocks_per_seq, cfg.block_size, engine.model_config.vocab_size
    tables = np.zeros((S, PP), np.int32)
    per = ctx // bs + 1
    for i in range(S):
        tables[i, :per] = np.arange(i * per, (i + 1) * per) % cfg.num_blocks
    rb = dict(token_ids=np.ones((S,), np.int64), positions=np.full((S,), ctx, np.int32),
              slot_mapping=np.full((S,), -1, np.int32), kv_lens=np.full((S,), ctx + 1, np.int32),
              page_indices=tables, cu_q_lens=np.arange(S + 1, dtype=np.int32),
              num_seqs=np.asarray([S], np.int32))
    plain = engine._sampling_arrays([])
    words = np.full((S, (V + 31) // 32), 0xFFFFFFFF, np.int64)
    cases = {"step_plain": lambda: engine._run_step(rb, plain)}
    if automaton is not None:
        automaton.set_mask_context(V, engine.model_config.eos_token_ids)
        words[: S // 2] = automaton.packed_mask(automaton.start)
        masked = plain._replace(mask_words=words)
        cases["step_constrained"] = lambda: engine._run_step(rb, masked)
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(engine.device)  # noqa: E731
    sp = engine._samp_params({k: d(v) for k, v in plain.arrays.items()}, plain.flags)
    sp_mask = sp._replace(mask_words=d(words), any_mask=True)
    logits = torch.randn((S, V), generator=torch.Generator(device=engine.device).manual_seed(1),
                         device=engine.device)
    cases["sampler_no_mask"] = lambda: sample_tokens(logits, sp)
    cases["sampler_mask"] = lambda: sample_tokens(logits, sp_mask)
    times = {k: [] for k in cases}
    out = {"rows": S, "vocab": V}
    with torch.inference_mode():
        for k in ("sampler_no_mask", "sampler_mask"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            cases[k]()
            torch.cuda.synchronize()
            out[k + "_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
        for turn in [k for k in cases if k.startswith("step")] * 2 + [
                "sampler_no_mask", "sampler_mask", "sampler_mask", "sampler_no_mask"]:
            fn = cases[turn]
            fn()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(GRAMMAR_TIME_ITERS):
                fn()
            b.record()
            b.synchronize()
            times[turn].append(a.elapsed_time(b) / GRAMMAR_TIME_ITERS)
        engine._stage_mask(None)  # leave all-ones words for the next step
    out.update({k: min(v) for k, v in times.items()})
    return out


def mask_stage_text(times):
    """mask_stage_times' sampler numbers as a sentence."""
    return (f"the sampler on [{times['rows']}, {times['vocab']}] f32 "
            f"logits {times['sampler_no_mask']:.3f} ms without its mask stage, "
            f"{times['sampler_mask']:.3f} ms with it (eager); allocated above the start "
            f"{times['sampler_no_mask_peak_mb']:.1f} MB without, {times['sampler_mask_peak_mb']:.1f} "
            f"MB with")


def grammar_path(torch, dev, sp_path):
    """Phase n: structured output on llama-3.1-8b at phase 6's geometry
    behind ``run in=http out=torch --tokenizer`` phase m's 128256-piece
    sentencepiece model.  The compile seconds at that vocabulary (a fresh
    compiler, off the server); warmed, one schema request alone (a
    compile), the same schema again (a compile-cache hit), the enum schema
    and the regex alone; then one burst of 8 streamed chat requests under
    the schema, 2 under the enum schema, 1 under the ``nvext.grammar``
    regex and 8 unconstrained, 64 new tokens each.  Every constrained
    output is a viable prefix of its language, parses and matches when it
    ends ``stop`` and is whole when it ends ``length``; the enum requests
    end ``stop``, their outputs parsed and matched; no violation; the masked rows equal the constrained tokens
    sampled; no graph captured after warmup; both attention kernels
    launched.  Reports the constrained against the unconstrained TTFT and
    ITL, and a unified step's time with and without constrained rows.
    Returns (ok, launches, numbers)."""
    import re as _re

    from dynamo_tpu_torch.llm.metrics import tenancy_metrics
    from dynamo_tpu_torch.llm.tenancy.grammar import GrammarCompiler, _CharDFA, spec_regex
    from dynamo_tpu_torch.llm.tokenizer import SentencePieceTokenizer

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"grammar check FAILED: {what}")

    specs = {"schema": {"kind": "json_schema", "schema": GRAMMAR_SCHEMA},
             "enum": {"kind": "json_schema", "schema": GRAMMAR_ENUM_SCHEMA},
             "regex": {"kind": "regex", "pattern": GRAMMAR_REGEX}}
    value_ok = {"schema": schema_value_ok, "enum": enum_value_ok}
    tok = SentencePieceTokenizer(sp_path)
    comp = GrammarCompiler(tok)
    auts = {}
    for kind, spec in specs.items():
        t0 = time.perf_counter()
        auts[kind] = comp.compile(spec)
        out[f"compile_{kind}_s"] = time.perf_counter() - t0
    log(f"grammar compile at {tok.vocab_size} pieces on this host: schema "
        f"{out['compile_schema_s']:.2f} s (the vocabulary's decode included; "
        f"{len(auts['schema'].edges)} states, {sum(map(len, auts['schema'].edges))} token edges), "
        f"enum {out['compile_enum_s']:.2f} s ({len(auts['enum'].edges)} states), "
        f"regex {out['compile_regex_s']:.2f} s ({len(auts['regex'].edges)} states); host clock")
    dfas = {kind: _CharDFA(spec_regex(spec)) for kind, spec in specs.items()}

    t0 = time.perf_counter()
    server = CliServer(grammar_argv(sp_path))
    port, engine = server.service.port, server.engine
    warm = server.warmup()
    log(f"grammar: server up and warmed in {time.perf_counter() - t0:.1f} s, graphs {warm}")
    rf = {"type": "json_schema", "json_schema": {"name": "pet", "schema": GRAMMAR_SCHEMA}}

    def body(i, kind):
        b = {"model": GRAMMAR_MODEL, "max_tokens": GRAMMAR_OSL, "temperature": 0, "stream": True,
             "messages": [{"role": "user", "content": f"Describe pet number {i} in JSON."}]}
        if kind == "schema":
            b["response_format"] = rf
        elif kind == "enum":
            b["response_format"] = {"type": "json_schema",
                                    "json_schema": {"name": "pick", "schema": GRAMMAR_ENUM_SCHEMA}}
        elif kind == "regex":
            b["nvext"] = {"grammar": GRAMMAR_REGEX}
        else:
            b["nvext"] = {"ignore_eos": True}
        return b

    async def call(b):
        st, headers, raw, events = await http_call(port, "POST", "/v1/chat/completions", b)
        if st != 200:
            return {"status": st, "error": raw[:200]}
        chunks, done = sse_data(events)
        content = [(t, c["choices"][0]["delta"].get("content") or "") for t, c in chunks
                   if c.get("choices") and c["choices"][0]["delta"].get("content")]
        final = chunks[-1][1] if chunks else {}
        return {"status": st, "done": done, "text": "".join(c for _, c in content),
                "finish": (final.get("choices") or [{}])[0].get("finish_reason"),
                "tokens": (final.get("usage") or {}).get("completion_tokens"),
                "first": content[0][0] if content else None,
                "last": chunks[-1][0] if chunks else None}

    def judge(label, kind, r):
        if r["status"] != 200:
            check(False, f"{label}: status {r['status']} {r.get('error')!r}")
            return
        check(r["done"], f"{label}: stream ends with [DONE]")
        text, fin = r["text"], r["finish"]
        st = dfas[kind].walk(dfas[kind].start, text)
        check(st is not None, f"{label}: the output is a prefix of its language ({text[:80]!r})")
        if kind == "enum":
            check(fin == "stop", f"{label}: a language closed within {GRAMMAR_OSL} tokens ends "
                                 f"stop ({fin}/{r['tokens']}, {text!r})")
        if fin == "stop":
            if kind in value_ok:
                try:
                    good = value_ok[kind](json.loads(text))
                except ValueError:
                    good = False
            else:
                good = _re.fullmatch(GRAMMAR_REGEX, text) is not None
            check(good, f"{label}: a stopped output parses and matches ({text!r})")
        else:
            check(fin == "length" and r["tokens"] == GRAMMAR_OSL,
                  f"{label}: ends stop or length/{GRAMMAR_OSL} ({fin}/{r['tokens']})")

    try:
        counters = lambda: {k: getattr(tenancy_metrics, k) for k in (  # noqa: E731
            "grammar_compiles_total", "grammar_cache_hits_total", "grammar_masked_rows_total",
            "grammar_violations_total", "grammar_hash_hits_total", "grammar_hash_misses_total",
            "grammar_full_resends_total", "grammar_stub_dispatches_total")}
        c0 = counters()
        solo = {}
        for label, kind in (("cold", "schema"), ("warm", "schema"), ("enum", "enum"),
                            ("regex", "regex")):
            t0 = time.perf_counter()
            solo[label] = asyncio.run(call(body(100, kind)))
            solo[label]["wall"] = time.perf_counter() - t0
            judge(f"solo {label}", kind, solo[label])
        c1 = counters()
        check(c1["grammar_compiles_total"] - c0["grammar_compiles_total"] == 3
              and c1["grammar_cache_hits_total"] - c0["grammar_cache_hits_total"] == 1,
              f"the first schema, the enum and the regex compile, the second schema hits the cache "
              f"({c0} -> {c1})")
        # Reported, not gated: the second request's prefill is a prefix-cache
        # hit, so its steps have other shapes than the first's (PERF.md §7).
        out["solo_same_text"] = solo["warm"].get("text") == solo["cold"].get("text")
        kinds = (["schema"] * GRAMMAR_SCHEMA_REQUESTS + ["enum"] * GRAMMAR_ENUM_REQUESTS
                 + ["regex"] + ["plain"] * GRAMMAR_PLAIN_REQUESTS)
        graphs0 = dict(engine.compile_counts())
        zero_kernel_counts()
        t0 = time.perf_counter()

        async def burst():
            return await asyncio.gather(*(call(body(i, k)) for i, k in enumerate(kinds)))

        res = asyncio.run(burst())
        out["burst_s"] = time.perf_counter() - t0
        out["launches"] = kernel_counts()
        c2 = counters()
        graphs1 = dict(engine.compile_counts())
        for i, (k, r) in enumerate(zip(kinds, res)):
            if k == "plain":
                check(r["status"] == 200 and r["finish"] == "length"
                      and r["tokens"] == GRAMMAR_OSL,
                      f"unconstrained request {i}: length/{GRAMMAR_OSL} ({r.get('finish')}/"
                      f"{r.get('tokens')})")
            else:
                judge(f"burst request {i} ({k})", k, r)
        sampled = sum(r.get("tokens") or 0 for k, r in zip(kinds, res) if k != "plain")
        masked = c2["grammar_masked_rows_total"] - c1["grammar_masked_rows_total"]
        check(masked == sampled, f"masked rows {masked} == constrained tokens sampled {sampled}")
        check(c2["grammar_violations_total"] == 0, f"no violation ({c2})")
        check(c2["grammar_compiles_total"] == c1["grammar_compiles_total"],
              f"the burst compiles nothing ({c1} -> {c2})")
        check(graphs1 == graphs0 == dict(warm), f"no graph captured after warmup "
                                                f"({warm} -> {graphs0} -> {graphs1})")
        check(all(v > 0 for v in out["launches"].values()),
              f"both attention kernels launched ({out['launches']})")
        st, _, raw, _ = asyncio.run(http_call(port, "GET", "/metrics"))
        samples = parse_prometheus(raw.decode()) if st == 200 else {}
        got = {n: v for (n, _), v in samples.items() if n.startswith("dynamo_tpu_tenancy_grammar")}
        check(len(got) == 9 and got.get("dynamo_tpu_tenancy_grammar_violations_total") == 0,
              f"/metrics has the nine grammar counters, violations 0 ({got})")

        def stats(sel):
            rs = [r for k, r in zip(kinds, res) if sel(k) and r.get("first") is not None]
            ttft = sorted(r["first"] for r in rs)
            itl = sorted((r["last"] - r["first"]) / max(1, r["tokens"] - 1) for r in rs
                         if r.get("tokens"))
            return {"n": len(rs), "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3 if ttft else None,
                    "itl_p50_ms": itl[len(itl) // 2] * 1e3 if itl else None,
                    "finishes": sorted(str(r["finish"]) for r in rs)}

        out["constrained"] = stats(lambda k: k != "plain")
        out["unconstrained"] = stats(lambda k: k == "plain")
        out["counters"] = {k: c2[k] - c0[k] for k in c2}
        summ = engine.dispatch_summary()
        log(f"grammar burst: {len(kinds)} streamed chat requests ({GRAMMAR_SCHEMA_REQUESTS} "
            f"json_schema, {GRAMMAR_ENUM_REQUESTS} json_schema enum, 1 nvext.grammar regex, "
            f"{GRAMMAR_PLAIN_REQUESTS} unconstrained), "
            f"{GRAMMAR_OSL} new each, wall {out['burst_s']:.2f} s; constrained {out['constrained']}, "
            f"unconstrained {out['unconstrained']} (TTFT: request sent -> first content chunk; "
            f"ITL: (finish chunk - first content chunk) / (tokens - 1)); counters over the phase "
            f"{out['counters']}; masked rows {masked} == constrained tokens {sampled}; dispatches "
            f"by kind { {k: v['dispatches'] for k, v in summ['kinds'].items()} }; launches "
            f"{out['launches']}; graphs {graphs1}; solo walls "
            f"{ {k: round(v['wall'], 3) for k, v in solo.items()} } s (cold includes the compile); "
            f"the schema request again (its prefix cached) gives the same text "
            f"{out['solo_same_text']} (not gated); host clock, one call [{CARD}]")
        for k, r in zip(kinds, res):
            if k != "plain" and r.get("finish") == "stop":
                log(f"grammar stopped output ({k}): {r['text']!r}")
        out["times"] = times = mask_stage_times(torch, engine, 600, auts["schema"])
        log(f"grammar time: a {engine.cfg.max_batch}-row decode-shaped unified step (graph "
            f"replay) {times['step_plain']:.3f} ms with no constrained row, "
            f"{times['step_constrained']:.3f} ms with {engine.cfg.max_batch // 2} (the mask rows "
            f"staged); {mask_stage_text(times)} [{CARD}]")
    finally:
        server.stop()
    gc.collect()
    torch.cuda.empty_cache()
    return not fails, out.get("launches", {}), out


def grammar_compile_times():
    """``chip_smoke.py --grammar-compile``: the host seconds of compiling
    phase n's schema, its regex and ``json_object`` against phase m's
    128256-piece sentencepiece vocabulary, each on a fresh compiler (the
    vocabulary's decode included) and again on a compiler that has already
    decoded it; states and token edges of each automaton.  Returns ok."""
    import tempfile

    from dynamo_tpu_torch.llm.tenancy.grammar import GrammarCompiler
    from dynamo_tpu_torch.llm.tokenizer import SentencePieceTokenizer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_compile_") as tmp:
        path = os.path.join(tmp, "tokenizer.model")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(sp_model_proto(SP_PIECES, 14))
        tok = SentencePieceTokenizer(path)
        log(f"grammar compile: tokenizer of {tok.vocab_size} pieces built in "
            f"{time.perf_counter() - t0:.1f} s")
        shared = GrammarCompiler(tok)
        shared.compile({"kind": "regex", "pattern": "[0-9]"})  # decode the vocabulary once
        for kind, spec in (("schema", {"kind": "json_schema", "schema": GRAMMAR_SCHEMA}),
                           ("regex", {"kind": "regex", "pattern": GRAMMAR_REGEX}),
                           ("json_object", {"kind": "json_object"})):
            t0 = time.perf_counter()
            GrammarCompiler(tok).compile(spec)
            fresh = time.perf_counter() - t0
            t0 = time.perf_counter()
            a = shared.compile(spec)
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            wire = a.to_dict()
            wire_s = time.perf_counter() - t0
            log(f"grammar compile {kind}: {fresh:.2f} s on a fresh compiler, {warm:.2f} s with "
                f"the vocabulary decoded; {len(a.edges)} states, {sum(map(len, a.edges))} token "
                f"edges, wire dict built in {wire_s:.2f} s; host clock [{CARD}]")
    return True


# ------------------------------------------------------------------ phase o
# Mixture-of-experts: mixtral-8x7b under W8A8 on one card.
MOE_MODEL = "mixtral-8x7b"
MOE_CFG = dict(
    model=MOE_MODEL, dtype="bfloat16", weight_quant="int8", block_size=PS, num_blocks=1024,
    max_batch=16, max_model_len=4096, prefill_chunk=512, decode_steps=8, pipeline_depth=2,
    seed=0,
)
MOE_CHECK_LAYERS = 2
MOE_TIME_ITERS = 10
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak


def moe_prompts(torch, vocab):
    """Phase o's 8 prompts: 512, 731, ..., 2045 random ids below the
    vocabulary (seed 7)."""
    rng = torch.Generator().manual_seed(7)
    return [torch.randint(1, vocab, (512 + 219 * i,), generator=rng).tolist() for i in range(8)]


def moe_reference_ffn(torch, mc):
    """The experts' FFN token by token: each token's router logits in f32,
    its top-k experts, the softmax over them, and each chosen expert's
    SwiGLU run on the token alone — the plain loop the batched dropless
    dispatch must equal."""
    import torch.nn.functional as F

    K = mc.num_experts_per_token

    def ffn(x, lp):
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for t in range(x.shape[0]):
            logits = (x[t] @ lp["router"]).float()
            w, e = logits.topk(K)
            w = w.softmax(-1)
            for k in range(K):
                ex = int(e[k])
                g = F.silu((x[t] @ lp["moe_gate"][ex]).float()).to(x.dtype)
                u = x[t] @ lp["moe_up"][ex]
                out[t] += w[k] * ((g * u) @ lp["moe_down"][ex]).float()
        return out.to(x.dtype)

    return ffn


def moe_qdot_check(torch, engine, C):
    """``qdot_batched``'s int32 accumulators at mixtral's gate shape (8
    experts, C rows, 4096 -> 14336) against the plain product of the same
    int8 operands in float64 (exact: |acc| < 2**53); the rescaled output
    against f32 math on the exact accumulators.  Returns (ok, numbers)."""
    from dynamo_tpu_torch.ops.quant_matmul import int_mm, qdot_batched, quantize_rows

    lp = engine.params["layers"]
    w, s = lp["moe_gate"][0], lp["moe_gate_scale"][0]
    E, K, N = w.shape
    x = torch.randn((E, C, K), generator=torch.Generator(device=engine.device).manual_seed(5),
                    device=engine.device).to(torch.bfloat16)
    with torch.inference_mode():
        xq, ax = quantize_rows(x)
        acc = torch.stack([int_mm(xq[e], w[e]) for e in range(E)])
        exact = True
        for e in range(E):
            plain = (xq[e].double() @ w[e].double()).round().to(torch.int32)
            exact = exact and bool(torch.equal(acc[e], plain))
        got = qdot_batched(x, w, s)
        want = (acc.float() * ax * s[:, None, :]).to(torch.bfloat16)
        err = float((got.float() - want.float()).abs().max())
    torch.cuda.synchronize()
    return exact and err == 0.0, {"exact": exact, "max_abs_err": err, "shape": (E, C, K, N)}


def moe_checkpoint_check(torch, dev, tmp):
    """A 1-layer mixtral-8x7b (full width) from the seeded bf16 init,
    written as a Mixtral-layout checkpoint with its config.json and loaded
    with ``quant="int8"``: every leaf bitwise equal to the device
    quantizer's (``quantize_params`` of the init).  Returns (ok, numbers)."""
    from dynamo_tpu_torch.models.config import ModelConfig, get_config
    from dynamo_tpu_torch.models.llama import init_params
    from dynamo_tpu_torch.models.loader import load_params, save_params_hf
    from dynamo_tpu_torch.models.quant import quantize_params

    mc = get_config(MOE_MODEL).with_overrides(num_layers=1)
    path = os.path.join(tmp, "mixtral-1l")
    out = {}
    with torch.inference_mode():
        init = init_params(mc, 0, dev)
        t0 = time.perf_counter()
        files = save_params_hf(init, path, config=mc)
        out["write_s"] = time.perf_counter() - t0
        out["bytes"] = sum(os.path.getsize(f) for f in files)
        back = ModelConfig.from_local_path(path)
        arch_ok = (back.num_experts, back.num_experts_per_token, back.num_layers) == (8, 2, 1)
        t0 = time.perf_counter()
        loaded = load_params(back, path, quant="int8", device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        want = quantize_params(init)
        ok, n = leaves_equal(torch, loaded, want, "mixtral checkpoint int8")
        experts = all(torch.equal(loaded["layers"][k], want["layers"][k])
                      for k in ("moe_gate", "moe_up", "moe_down", "moe_gate_scale",
                                "moe_up_scale", "moe_down_scale"))
    del init, loaded, want
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()
    out.update(leaves=n, experts_equal=experts, arch_ok=arch_ok)
    return ok and experts and arch_ok, out


def moe_bounds(engine, ctx_rows, new_tokens, prefill):
    """The least time the card could take for one step of ``engine`` from
    this run's shapes: every weight byte read once (and the KV rows read
    and written), over the HBM rate; the int8 operations of the products
    as the dropless layout computes them (every expert over all T rows) and
    as the routing needs them (K of E experts a row), and the bf16
    attention and router operations, over their peaks.  The bound is the
    larger of the bytes and the routed operations; the dropless operations
    are the layout's waste, reported beside it.  Returns (weight bytes,
    bytes ms, dropless ms, useful ms)."""
    mc = engine.model_config
    p = engine.params
    weights = sum(t.numel() * t.element_size() for k, t in p.items() if k not in ("layers", "embed"))
    weights += sum(t.numel() * t.element_size() for t in p["layers"].values())
    T = sum(new_tokens)
    kv_tok = 2 * mc.num_kv_heads * mc.head_dim * 2 * mc.num_layers  # bf16 K and V, every layer
    nbytes = weights + kv_tok * (sum(c + n for c, n in zip(ctx_rows, new_tokens)) + T)
    D, E, K = mc.hidden_size, mc.num_experts, mc.num_experts_per_token
    F = mc.moe_intermediate_size
    attn_w = D * (mc.q_size + 2 * mc.kv_size) + mc.q_size * D
    rows = T if prefill else engine.cfg.max_batch  # a fused decode step runs every row
    int8 = mc.num_layers * 2 * rows * attn_w + 2 * engine.cfg.max_batch * D * mc.vocab_size
    experts = mc.num_layers * 2 * 3 * D * F
    attn = mc.num_layers * 4 * mc.num_heads * mc.head_dim * sum(
        n * (c + (n + 1) / 2) for c, n in zip(ctx_rows, new_tokens))
    bf16 = attn + mc.num_layers * 2 * rows * D * E
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    dropless = (int8 + experts * rows * E) / INT8_OPS * 1e3 + bf16 / BF16_FLOPS * 1e3
    useful = (int8 + experts * T * K) / INT8_OPS * 1e3 + bf16 / BF16_FLOPS * 1e3
    return weights, bytes_ms, dropless, useful


def moe_dispatch_times(torch, engine):
    """A fused decode dispatch (16 rows at 1024 ids of context, 8 steps)
    and a 512-token prefill step (one row over a 512-token prefix), each a
    graph replay timed with CUDA events over MOE_TIME_ITERS calls, beside
    moe_bounds.  Returns {label: ...}."""
    import numpy as np

    cfg = engine.cfg
    S, PP, bs = cfg.max_batch, cfg.max_blocks_per_seq, cfg.block_size
    ctx = 1024
    per = (ctx + cfg.decode_steps) // bs + 1
    tables = np.zeros((S, PP), np.int32)
    for i in range(S):
        tables[i, :per] = (np.arange(i * per, (i + 1) * per)) % cfg.num_blocks
    samp = engine._sampling_arrays([])
    tok0 = np.ones((S,), np.int64)
    pos0 = np.full((S,), ctx, np.int32)
    limits = np.full((S,), ctx, np.int32)  # nothing written
    n, prior = 512, 512
    T = cfg.bucket_tokens(n)
    tab = np.zeros((S, PP), np.int32)
    tab[0] = tables[0]
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = n
    pos = np.zeros(T, np.int32)
    pos[:n] = np.arange(prior, prior + n)
    rb = dict(token_ids=np.ones((T,), np.int64), positions=pos,
              slot_mapping=np.full((T,), -1, np.int32),
              kv_lens=np.asarray([prior + n] + [0] * (S - 1), np.int32), page_indices=tab,
              cu_q_lens=cu, num_seqs=np.asarray([1], np.int32))
    cases = {"decode": lambda: engine._run_multi(tok0, pos0, tables, limits, samp),
             "prefill": lambda: engine._run_step(rb, samp)}
    times = {k: [] for k in cases}
    with torch.inference_mode():
        for turn in ("decode", "prefill", "prefill", "decode"):
            fn = cases[turn]
            fn()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(MOE_TIME_ITERS):
                fn()
            b.record()
            b.synchronize()
            times[turn].append(a.elapsed_time(b) / MOE_TIME_ITERS)
    out = {k: min(v) for k, v in times.items()}
    steps = cfg.decode_steps
    w, dec_bytes, dec_drop, dec_use = moe_bounds(engine, [ctx] * S, [1] * S, False)
    _, pre_bytes, pre_drop, pre_use = moe_bounds(engine, [prior], [n], True)
    out.update(weight_gb=w / 1e9,
               decode_bound_ms=steps * max(dec_bytes, dec_use), decode_bytes_ms=steps * dec_bytes,
               decode_dropless_ops_ms=steps * dec_drop, decode_useful_ops_ms=steps * dec_use,
               prefill_bound_ms=max(pre_bytes, pre_use), prefill_bytes_ms=pre_bytes,
               prefill_dropless_ops_ms=pre_drop, prefill_useful_ops_ms=pre_use, prefill_T=T)
    return out


def moe_path(torch, dev):
    """Phase o: mixtral-8x7b served by ``TorchEngine`` under W8A8
    (``EngineConfig(model="mixtral-8x7b", weight_quant="int8")``, the int8
    experts drawn on the card) at full width and depth, bf16 pages, 16 rows,
    1024 pages, 512-token chunks, 8 decode steps, depth 2.  First the f32
    MoE model at full width and MOE_CHECK_LAYERS layers against the dense
    reference with per-token experts (1e-4), and a 1-layer Mixtral-layout
    checkpoint loaded with quant="int8" bitwise equal to the device
    quantizer's.  Then the engine: resident memory, warmup and its peak, 8
    greedy requests of 512..2045 ids with 64 new each (whole, no graph
    captured, both kernels launched), finite logits, graph replays bitwise
    equal to eager calls, ``qdot_batched``'s accumulators exact against
    their plain product, and a fused decode dispatch and a 512-token
    prefill step beside their bounds.  Returns (ok, launches, numbers)."""
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.llama import forward_ragged, init_params

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"moe check FAILED: {what}")

    # The f32 model at full width, MOE_CHECK_LAYERS layers.
    mc = get_config(MOE_MODEL).with_overrides(dtype="float32", num_layers=MOE_CHECK_LAYERS)
    with torch.inference_mode():
        params = init_params(mc, 0, dev)
        check(paged_vs_reference(torch, dev, mc, params, MOE_CFG["max_batch"], "moe f32",
                                 moe_reference_ffn(torch, mc)),
              "the f32 MoE model against the per-token expert reference")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_o_") as tmp:
        ok_ckpt, out["ckpt"] = moe_checkpoint_check(torch, dev, tmp)
    check(ok_ckpt, f"1-layer Mixtral checkpoint under int8 equals the device quantizer "
                   f"({out['ckpt']})")
    log(f"moe checkpoint: 1 layer at full width, {out['ckpt']['bytes'] / 1e9:.3f} GB written in "
        f"{out['ckpt']['write_s']:.1f} s, loaded with quant=int8 in {out['ckpt']['load_s']:.1f} s; "
        f"{out['ckpt']['leaves']} leaves bitwise equal, experts {out['ckpt']['experts_equal']}, "
        f"architecture from config.json {out['ckpt']['arch_ok']}")

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchEngine(EngineConfig(**MOE_CFG), device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["resident_gib"] = (torch.cuda.memory_allocated() - base) / 2**30
    out["params_gb"] = sum(t.numel() * t.element_size() for k, t in engine.params.items()
                           if k != "layers") / 1e9 + sum(
        t.numel() * t.element_size() for t in engine.params["layers"].values()) / 1e9
    prompts = moe_prompts(torch, engine.model_config.vocab_size)
    lens = [len(p) for p in prompts]

    async def run():
        try:
            t = time.perf_counter()
            out["warm"] = await engine.run_warmup()
            out["warm_s"] = time.perf_counter() - t
            out["peak_warm_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            zero_kernel_counts()
            t = time.perf_counter()
            results = await serve(torch, engine, prompts, SERVE_MAX_TOKENS)
            out["wall"] = time.perf_counter() - t
            out["launches"] = kernel_counts()
            out["after"] = engine.compile_counts()
            out["peak_serve_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            out["results"] = results
            out["dispatch"] = engine.dispatch_summary()
            out["graph_ok"] = graph_check(torch, dev, engine, bitwise_only=True)
            out["qdot_ok"], out["qdot"] = moe_qdot_check(torch, engine, engine.cfg.bucket_tokens(
                engine.cfg.prefill_chunk + engine.cfg.max_batch))
            out["times"] = moe_dispatch_times(torch, engine)
            with torch.inference_mode():
                table = list(range(engine.cfg.max_blocks_per_seq))
                rb = one_row_batch(torch, dev, engine.cfg.max_batch, table, prompts[0][:100], 0,
                                   False)
                logits = forward_ragged(engine.params, engine.model_config, rb, engine.cache)[0]
                out["finite"] = bool(torch.isfinite(logits).all())
                out["logits_shape"] = tuple(logits.shape)
        finally:
            await engine.close()

    asyncio.run(run())
    results = out.pop("results")
    whole = sum(len(t) == SERVE_MAX_TOKENS and f == "length" for t, _, f in results)
    check(whole == len(prompts), f"{whole}/{len(prompts)} mixtral streams whole")
    check(out["after"] == out["warm"], f"no graph captured after warmup ({out['warm']} -> "
                                       f"{out['after']})")
    check(all(v > 0 for v in out["launches"].values()),
          f"both attention kernels launched ({out['launches']})")
    check(out["finite"] and out["logits_shape"] == (engine.model_config.vocab_size,),
          f"finite logits of shape ({engine.model_config.vocab_size},) ({out['logits_shape']})")
    check(out["graph_ok"], "graph replays bitwise equal to eager calls")
    check(out["qdot_ok"], f"qdot_batched accumulators exact, output equal ({out['qdot']})")
    ttft = sorted(s[0] for _, s, _ in results if s)
    itl = [(s[-1] - s[0]) / (len(s) - 1) for _, s, _ in results if len(s) > 1]
    total = sum(len(t) for t, _, _ in results)
    pipe = out["dispatch"]["pipeline"]
    tm = out["times"]
    log(f"moe engine: {MOE_MODEL} W8A8, {engine.model_config.num_layers} layers, "
        f"{engine.model_config.num_experts} experts top-{engine.model_config.num_experts_per_token},"
        f" init {out['init_s']:.1f} s; params {out['params_gb']:.2f} GB; resident "
        f"{out['resident_gib']:.2f} GiB (params, 1024 bf16 pages, buffers); warmup "
        f"{out['warm_s']:.1f} s, graphs {out['warm']}, peak {out['peak_warm_gib']:.2f} GiB; "
        f"peak after the serve {out['peak_serve_gib']:.2f} GiB (max_memory_allocated over the "
        f"engine's start) [{CARD}]")
    log(f"moe serve: 8 requests, prompts {lens[0]}..{lens[-1]} ids, {SERVE_MAX_TOKENS} new each: "
        f"{whole} whole, wall {out['wall']:.3f} s, {total / out['wall']:.2f} output tok/s; TTFT "
        f"p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms; ITL mean "
        f"{sum(itl) / len(itl) * 1e3:.2f} ms; host_gap_frac {pipe['host_gap_frac']}; launches "
        f"{out['launches']}; graphs {out['after']}; qdot_batched {out['qdot']}; finite logits "
        f"{out['finite']}; host clock, one call [{CARD}]")
    log(f"moe time: fused decode dispatch (16 rows at 1024 ids, 8 steps) {tm['decode']:.3f} ms, "
        f"bound {tm['decode_bound_ms']:.3f} ms, the larger of the weights' "
        f"{tm['weight_gb']:.2f} GB a step over HBM {tm['decode_bytes_ms']:.3f} ms and the int8 "
        f"operations the routing needs {tm['decode_useful_ops_ms']:.3f} ms (the dropless layout "
        f"computes {tm['decode_dropless_ops_ms']:.3f} ms of them); prefill step (512 ids over 512, "
        f"bucket {tm['prefill_T']}) {tm['prefill']:.3f} ms, bound {tm['prefill_bound_ms']:.3f} ms "
        f"(bytes {tm['prefill_bytes_ms']:.3f} ms, routed operations "
        f"{tm['prefill_useful_ops_ms']:.3f} ms; the dropless layout's operations "
        f"{tm['prefill_dropless_ops_ms']:.3f} ms) [{CARD}]")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return not fails, out.get("launches", {}), out


# ------------------------------------------------------------------ phase p

SDK_MODEL = "llama-3.1-8b"
SDK_SERVED = "llama-3.1-8b-sdk"
SDK_ALIAS = "llama-3.1-8b-alias"
SDK_WORKER_ENDPOINT = "examples.TorchWorker.generate"
SDK_CONFIG = (
    "TorchWorker:\n"
    f"  model: {SDK_MODEL}\n"
    "  block_size: 16\n"
    "  num_blocks: 2048\n"
    "  max_batch: 16\n"
    "  max_model_len: 4096\n"
    f"  served_model_name: {SDK_SERVED}\n"
    "Processor:\n"
    f"  served_model_name: {SDK_SERVED}\n"
)
SDK_PROMPTS = ("Write a haiku about graphs.", "List three prime numbers.",
               "What does a supervisor do when a worker exits?")
SDK_MAX_TOKENS = 32
SDK_HASH_IDS = 131072
SDK_STOP_TIMEOUT_S = 10.0  # Supervisor.shutdown's timeout
# On the runner's children's PYTHONPATH: each child writes, at exit, whether
# it opened a CUDA context (and its peak allocated card memory) and (the
# worker) its kernel launch counts, and SIGUSR1 zeroes the counts.  It changes nothing the children do; another
# sitecustomize further down the path still runs.
SDK_SITE_HOOK = '''\
import atexit, json, os, signal, sys, time

_OUT = os.environ.get("CHIP_SMOKE_CHILD_DIR")


def _graphs():
    return sys.modules.get("dynamo_tpu_torch.engine.graphs")


def _zero(signum, frame):
    g = _graphs()
    if g is not None:
        for fn in g.KERNELS.values():
            fn.launches = 0


def _report():
    torch = sys.modules.get("torch")
    g = _graphs()
    cuda = bool(torch is not None and torch.cuda.is_initialized())
    rec = {"pid": os.getpid(), "argv": sys.argv, "t_exit": time.time(),
           "cuda_initialized": cuda,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
           "launches": None if g is None else g.kernel_launches()}
    with open(os.path.join(_OUT, f"{os.getpid()}.json"), "w") as f:
        json.dump(rec, f)


if _OUT:
    atexit.register(_report)
    signal.signal(signal.SIGUSR1, _zero)

_here = os.path.dirname(os.path.abspath(__file__))
for _p in sys.path:
    _cand = os.path.join(os.path.abspath(_p or "."), "sitecustomize.py")
    if os.path.dirname(_cand) != _here and os.path.isfile(_cand):
        import importlib.util as _u
        _spec = _u.spec_from_file_location("_chained_sitecustomize", _cand)
        _spec.loader.exec_module(_u.module_from_spec(_spec))
        break
'''


def sdk_native(out):
    """Phase p's host part: PyYAML's presence, the native library built
    from dynamo_tpu_torch/csrc/native (its own g++ time), and its chained
    hashes of a 131072-id prompt against the pure-Python chain.  Returns
    the failures."""
    import importlib.util

    from dynamo_tpu_torch import native, tokens

    fails = []
    spec = importlib.util.find_spec("yaml")
    if spec is None:
        log("sdk: PyYAML is not installed (the SDK config uses its built-in reader; "
            "`deploy` refuses)")
    else:
        import yaml

        log(f"sdk: PyYAML {yaml.__version__} is installed")
    out["pyyaml"] = None if spec is None else __import__("yaml").__version__
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    out["gxx"] = gxx.stdout.splitlines()[0] if gxx.returncode == 0 else None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        t0 = time.perf_counter()
        try:
            native.build(Path(tmp) / "libdyn_native.so")
        except Exception as e:  # noqa: BLE001 — reported as the phase's failure
            fails.append(f"native library build: {e!r}")
        out["native_build_s"] = time.perf_counter() - t0
    if not native.available():
        fails.append("the native library does not load")
        return fails
    rng = random.Random(11)
    ids = [rng.randrange(0, DIST_VOCAB) for _ in range(SDK_HASH_IDS)]
    t0 = time.perf_counter()
    fast = tokens.fast_sequence_hashes(ids, PS, "tenant-a")
    out["native_hash_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    py = [b.sequence_hash for b in tokens.hash_token_blocks(ids, PS, "tenant-a")]
    out["python_hash_ms"] = (time.perf_counter() - t0) * 1e3
    if fast != py or len(py) != SDK_HASH_IDS // PS:
        fails.append(f"native hashes differ from the pure-Python chain ({len(fast)}, {len(py)})")
    log(f"sdk native: {out['gxx']}; g++ build {out['native_build_s']:.2f} s; chained hashes of "
        f"{SDK_HASH_IDS} ids ({len(py)} blocks, salted): native {out['native_hash_ms']:.1f} ms, "
        f"pure-Python chain {out['python_hash_ms']:.1f} ms, equal {fast == py}; host clock "
        f"[{CARD}]")
    return fails


def compute_apps():
    """(pid, used MiB) of each process holding memory on the card, as
    nvidia-smi lists them (empty where it cannot see them)."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader,nounits"], capture_output=True, text=True,
                       timeout=60)
    apps = []
    for line in r.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps.append((int(parts[0]), parts[1]))
    return apps


def card_used_mib():
    """The card's used memory in MiB, all processes together, as nvidia-smi
    reads it (None where it cannot).  Inside a container nvidia-smi may not
    map a process to its own memory, so a rank's own figure is its peak
    allocated memory from the site hook."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    first = r.stdout.strip().splitlines()[:1]
    return int(first[0]) if first and first[0].strip().isdigit() else None


async def sdk_chat(port, prompt, model):
    """A streamed greedy chat request with logprobs (every token's chunk
    reaches the client): (status, the stream's (content, logprob) pairs,
    finish reason, TTFT s, ITL s)."""
    stamps = []

    def on_event(t, ev):
        if ev.startswith("data: {"):
            stamps.append(t)

    body = {"model": model, "messages": [{"role": "user", "content": prompt}],
            "max_tokens": SDK_MAX_TOKENS, "temperature": 0.0, "stream": True, "logprobs": True,
            "nvext": {"ignore_eos": True}}
    st, _, raw, events = await http_call(port, "POST", "/v1/chat/completions", body,
                                         on_event=on_event)
    if st != 200:
        return st, raw.decode(errors="replace")[:200], None, float("nan"), float("nan")
    chunks, _ = sse_data(events)
    return (st, sdk_tokens([c for _, c in chunks]), sdk_finish([c for _, c in chunks]),
            stamps[0] if stamps else float("nan"),
            (stamps[-1] - stamps[0]) / max(1, len(stamps) - 1) if stamps else float("nan"))


def sdk_tokens(chunks):
    """(content, logprob) of each token in a chat stream's chunks."""
    out = []
    for c in chunks:
        for ch in c.get("choices") or []:
            for lp in ((ch.get("logprobs") or {}).get("content") or []):
                out.append((lp["token"], lp["logprob"]))
    return out


def sdk_finish(chunks):
    for c in reversed(chunks):
        for ch in c.get("choices") or []:
            if ch.get("finish_reason"):
                return ch["finish_reason"]
    return None


async def sdk_processor(hub, prompt):
    """The same request through ``Processor.chat`` on the service plane."""
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context, collect

    rt = await DistributedRuntime.connect(hub)
    try:
        client = await rt.namespace("examples").component("Processor").endpoint("chat").client()
        await client.wait_for_instances(60)
        items = await collect(await client.generate(Context({
            "model": SDK_SERVED, "messages": [{"role": "user", "content": prompt}],
            "max_tokens": SDK_MAX_TOKENS, "temperature": 0.0, "stream": True, "logprobs": True,
            "nvext": {"ignore_eos": True}})))
        await client.close()
        return sdk_tokens(items), sdk_finish(items)
    finally:
        await rt.close()


async def sdk_models(port):
    st, _, raw, _ = await http_call(port, "GET", "/v1/models")
    return [m["id"] for m in json.loads(raw)["data"]] if st == 200 else []


async def sdk_wait_model(port, name, present, timeout):
    end = time.time() + timeout
    while time.time() < end:
        try:
            if (name in await sdk_models(port)) == present:
                return True
        except OSError:
            pass
        await asyncio.sleep(0.2)
    return False


def sdk_path(torch):
    """Phase p: the serving SDK's example graph at llama-3.1-8b's full width
    and depth (``python -m dynamo_tpu_torch.sdk.runner
    dynamo_tpu_torch.examples.llm.graphs:agg -f CFG --http-port P --router
    kv``: the runner's hub, Frontend, Processor, TorchWorker on the card and
    the HTTP edge), after the host part (``sdk_native``).  Greedy chat
    requests one at a time through the edge and through ``Processor.chat``
    on the service plane: the same tokens and logprobs; the worker's kernel
    launches (zeroed by SIGUSR1 just before, written at its exit); no other
    child opens a CUDA context or holds card memory; ``model add`` of an
    alias served at the edge and ``model remove`` answered 404; SIGTERM
    stops the graph within the supervisor's timeout.  Returns (ok,
    launches, numbers)."""
    fails, out = [], {}
    t_phase = time.perf_counter()

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"sdk check FAILED: {what}")

    for f in sdk_native(out):
        check(False, f)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p_") as tmp:
        site, reports = os.path.join(tmp, "site"), os.path.join(tmp, "reports")
        os.makedirs(site)
        os.makedirs(reports)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(SDK_SITE_HOOK)
        cfg = os.path.join(tmp, "graph.yaml")
        with open(cfg, "w") as f:
            f.write(SDK_CONFIG)
        port, hub = _free_port(), "127.0.0.1:6650"
        before_apps = compute_apps()
        env = {"PYTHONPATH": os.pathsep.join([site, str(REPO)]), "CHIP_SMOKE_CHILD_DIR": reports}
        t0 = time.perf_counter()
        graph = Child("sdk-graph", ["dynamo_tpu_torch.examples.llm.graphs:agg", "-f", cfg,
                                    "--http-port", str(port), "--router", "kv"],
                      env=env, module="dynamo_tpu_torch.sdk.runner")
        children = [graph]
        try:
            graph.wait_line("service TorchWorker up", 300)
            out["worker_boot_s"] = time.perf_counter() - t0
            spawned = {}
            for line in graph.lines:
                m = re.search(r"spawned (\S+)\[0\] pid=(\d+)", line)
                if m:
                    spawned[m.group(1)] = int(m.group(2))
            out["pids"] = spawned
            ok_model = asyncio.run(sdk_wait_model(port, SDK_SERVED, True, 120))
            check(ok_model, f"{SDK_SERVED} registered at the edge")
            out["serving_s"] = time.perf_counter() - t0
            during_apps = compute_apps()
            os.kill(spawned["TorchWorker"], signal.SIGUSR1)  # zero the worker's counts
            time.sleep(0.5)
            results = []
            for prompt in SDK_PROMPTS:  # one at a time: each served alone on each route
                # The first serve fills the prefix cache (and captures the
                # graphs): the two compared serves then both prefill the
                # same uncached tail, in the same shapes.
                warm = asyncio.run(sdk_chat(port, prompt, SDK_SERVED))
                http = asyncio.run(sdk_chat(port, prompt, SDK_SERVED))
                proc = asyncio.run(sdk_processor(hub, prompt))
                results.append((http, proc, warm))
                check(http[0] == 200 and warm[0] == 200,
                      f"edge chat answered {warm[0]}, {http[0]}: {http[1]}")
                check(len(http[1]) == SDK_MAX_TOKENS and http[2] == "length",
                      f"edge stream whole ({len(http[1])} tokens, {http[2]})")
                check(proc == (http[1], http[2]),
                      f"Processor.chat equals the edge's stream, tokens and logprobs "
                      f"({len(proc[0])} tokens)")
                check([t for t, _ in warm[1]] == [t for t, _ in http[1]],
                      "the cold and the prefix-hit edge serves give the same text")
            out.update(ttft_ms=[r[0][3] * 1e3 for r in results],
                       itl_ms=[r[0][4] * 1e3 for r in results],
                       cold_ttft_ms=[r[2][3] * 1e3 for r in results],
                       cold_itl_ms=[r[2][4] * 1e3 for r in results])

            # model add | remove through the CLI, seen at the edge.
            add = Child("model-add", ["model", "add", SDK_ALIAS, SDK_WORKER_ENDPOINT,
                                      "--hub", hub], env=env)
            children.append(add)
            add.p.wait(60)
            check(add.p.returncode == 0, f"model add exited {add.p.returncode}")
            check(asyncio.run(sdk_wait_model(port, SDK_ALIAS, True, 60)),
                  f"the edge lists {SDK_ALIAS} after model add")
            alias = asyncio.run(sdk_chat(port, SDK_PROMPTS[0], SDK_ALIAS))
            check(alias[0] == 200 and len(alias[1]) == SDK_MAX_TOKENS,
                  f"the alias served ({alias[0]}, {len(alias[1]) if alias[0] == 200 else 0})")
            remove = Child("model-remove", ["model", "remove", SDK_ALIAS, "--hub", hub], env=env)
            children.append(remove)
            remove.p.wait(60)
            check(remove.p.returncode == 0, f"model remove exited {remove.p.returncode}")
            check(asyncio.run(sdk_wait_model(port, SDK_ALIAS, False, 60)),
                  f"the edge drops {SDK_ALIAS} after model remove")
            gone = asyncio.run(sdk_chat(port, SDK_PROMPTS[0], SDK_ALIAS))
            check(gone[0] == 404, f"the removed alias answers {gone[0]}, not 404")
            out["alias_status"] = (alias[0], gone[0])

            # SIGTERM: the graph stops within the supervisor's timeout.
            t_term = time.time()
            t0 = time.perf_counter()
            graph.p.send_signal(signal.SIGTERM)
            try:
                graph.p.wait(SDK_STOP_TIMEOUT_S + 20)
            except subprocess.TimeoutExpired:
                pass
            out["stop_s"] = time.perf_counter() - t0
            check(graph.p.poll() is not None and out["stop_s"] < SDK_STOP_TIMEOUT_S + 2,
                  f"the runner exits within the supervisor's timeout ({out['stop_s']:.1f} s)")
            recs = []
            for name in os.listdir(reports):
                with open(os.path.join(reports, name)) as f:
                    recs.append(json.load(f))
            by_pid = {r["pid"]: r for r in recs}
            for svc, pid in spawned.items():
                check(pid in by_pid, f"{svc} exited through its shutdown (no exit report)")
            worker = by_pid.get(spawned.get("TorchWorker"), {})
            launches = worker.get("launches") or {}
            out["worker_exit_s"] = worker.get("t_exit", float("nan")) - t_term
            cuda = sorted(" ".join(r["argv"][1:2]) for r in recs if r["cuda_initialized"])
            check(cuda == ["dynamo_tpu_torch.examples.llm.components:TorchWorker"],
                  f"only TorchWorker opened a CUDA context ({cuda})")
            # nvidia-smi may show every process of this container as one
            # pid: count the entries.
            check(len(during_apps) - len(before_apps) <= 1,
                  f"at most one more process on the card while the graph served "
                  f"({before_apps} -> {during_apps})")
            out["apps"] = {"before": before_apps, "during": during_apps}
            check(launches.get("decode_attention", 0) > 0
                  and launches.get("prefill_attention", 0) > 0,
                  f"TorchWorker launched both attention kernels ({launches})")
        finally:
            for c in children:
                c.stop(signal.SIGKILL if c is not graph else signal.SIGTERM)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sdk graph: {SDK_MODEL} at full width and depth behind the runner (hub, Frontend, "
        f"Processor, TorchWorker, http --router kv); worker up {out.get('worker_boot_s', 0):.1f} "
        f"s after the runner's start, model at the edge after {out.get('serving_s', 0):.1f} s; "
        f"{len(SDK_PROMPTS)} greedy chat prompts of {SDK_MAX_TOKENS} tokens, each served cold, "
        f"then again at the edge and through Processor.chat, one at a time: cold TTFT "
        f"{[round(x, 1) for x in out.get('cold_ttft_ms', [])]} ms, ITL "
        f"{[round(x, 2) for x in out.get('cold_itl_ms', [])]} ms (the first captures the "
        f"graphs); prefix-hit edge TTFT {[round(x, 1) for x in out.get('ttft_ms', [])]} ms, ITL "
        f"{[round(x, 2) for x in out.get('itl_ms', [])]} ms; alias {out.get('alias_status')}; "
        f"worker launches "
        f"{launches}; card processes before {out.get('apps', {}).get('before')} during "
        f"{out.get('apps', {}).get('during')}; SIGTERM to runner exit "
        f"{out.get('stop_s', float('nan')):.2f} s, the worker's own exit "
        f"{out.get('worker_exit_s', float('nan')):.2f} s; phase {out['phase_s']:.1f} s; host "
        f"clock [{CARD}]")
    return not fails, launches, out


# ------------------------------------------------------------------ phase q

PAR_MODEL = "llama-3.1-8b"
PAR_CHECK_LAYERS = 2
PAR_TOL = 1e-4
PAR_RANK_TIMEOUT_S = 400
PAR_SP_IDS = 4096
PAR_SP_CHUNK = 512
PAR_ALLREDUCE_ROWS = (16, 512)
PAR_PROMPTS = 3
PAR_ISL = 64
PAR_MAX_TOKENS = 16
PAR_SERVE_TIMEOUT_S = 400
# llama-3.1-8b's ``run`` as phase q starts it (seed 0, bf16; at
# PATH_CUT_LAYERS of its layers, as phases h-l and r run, for the script's
# time): its rows, pages and length.  The sp run takes a 4096-id prompt.
PAR_RUN_FLAGS = ["--arch", PAR_MODEL, "--model", PAR_MODEL, "--max-batch", "8",
                 "--num-blocks", "1024", "--max-model-len", "8192"]


def par_state_for(base, mesh_cfg):
    """A ParallelState for another mesh over the same two ranks: every
    group of two ranks is the world's group."""
    from dynamo_tpu_torch.parallel.distributed import _GROUP_AXES, AxisGroup, ParallelState
    from dynamo_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(mesh_cfg, [base.device] * base.size)
    groups = {}
    for axes in _GROUP_AXES:
        ranks = mesh.group_ranks(axes, base.rank)
        groups[axes] = AxisGroup(ranks, base.rank, base.world.pg if len(ranks) > 1 else None,
                                 stage=base.backend == "gloo")
    return ParallelState(mesh, base.rank, base.device, base.backend, groups)


def par_steps(torch, dev, mc, table, S=8):
    """A 48-id prefill of one row, then two fused-decode-shaped steps."""
    tokens = torch.randint(1, mc.vocab_size, (50,),
                           generator=torch.Generator().manual_seed(5)).tolist()
    return [one_row_batch(torch, dev, S, table, tokens[:48], 0, False),
            one_row_batch(torch, dev, S, table, tokens[48:49], 48, True),
            one_row_batch(torch, dev, S, table, tokens[49:50], 49, True)], [False, True, True]


def par_forward(torch, dev, mc, params, shard, n_pages=8):
    """forward_ragged over ``par_steps`` at this rank's heads: (row 0's
    logits of each step [3, V], the pages)."""
    from dynamo_tpu_torch.models.llama import PagedKVCache, forward_ragged

    kv = mc.num_kv_heads // (1 if shard is None else shard.tp.size)
    cache = PagedKVCache.create(mc.with_overrides(num_kv_heads=kv), n_pages, PS,
                                torch.float32, dev)
    rbs, decode = par_steps(torch, dev, mc, list(range(4)))
    logits = torch.stack([forward_ragged(params, mc, rb, cache, decode=d, shard=shard)[0]
                          for rb, d in zip(rbs, decode)])
    return logits, cache.pages


def par_rank_job(rank, port, out_path, dev=None):
    """One of phase q's two f32 ranks on this card (``--parallel-rank``):
    tp 2, W8A8 tp 2, ep 2 (mixtral width), sp 2 against the one-rank
    forward of the same weights, each rank computing its own reference;
    and the group's all-reduce times.  Writes a JSON report.  ``dev``
    (default the card) lets a CPU rehearsal run it."""
    import torch

    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.llama import (
        PagedKVCache, forward_ragged, forward_sp_prefill, init_params,
    )
    from dynamo_tpu_torch.models.quant import init_params_quantized
    from dynamo_tpu_torch.parallel.distributed import MultiHostConfig, init_multihost
    from dynamo_tpu_torch.parallel.mesh import MeshConfig, param_pspecs, shard_params

    dev = dev or torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    base = init_multihost(MultiHostConfig(coordinator=f"127.0.0.1:{port}"), MeshConfig(tp=2),
                          rank, dev)
    rep = {"rank": rank, "backend": base.backend, "eager": base.eager, "errors": {}}

    def compare(label, got, want):
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        ok = bool(torch.isfinite(g).all()) and torch.allclose(g, w, rtol=PAR_TOL, atol=PAR_TOL)
        rep["errors"][label] = (err, ok, float(w.abs().max()))

    with torch.inference_mode():
        # tp 2, f32, and W8A8 (f32 activations) at llama-3.1-8b's width.
        for label, quant in (("tp2", False), ("tp2_w8a8", True)):
            mc = get_config(PAR_MODEL).with_overrides(num_layers=PAR_CHECK_LAYERS,
                                                      dtype="float32")
            full = init_params_quantized(mc, 0, dev) if quant else init_params(mc, 0, dev)
            ref_logits, ref_pages = par_forward(torch, dev, mc, full, None)
            local = shard_params(full, param_pspecs(mc), base.mesh, rank)
            del full
            torch.cuda.empty_cache()
            logits, pages = par_forward(torch, dev, mc, local, base)
            compare(f"{label} logits", logits, ref_logits)
            kv2 = pages.shape[3]
            compare(f"{label} pages", pages, ref_pages[:, :, :, rank * kv2:(rank + 1) * kv2])
            del local, ref_pages, pages
            torch.cuda.empty_cache()
        # ep 2 at mixtral-8x7b's width.
        ep = par_state_for(base, MeshConfig(ep=2))
        mc = get_config("mixtral-8x7b").with_overrides(num_layers=PAR_CHECK_LAYERS,
                                                       dtype="float32")
        full = init_params(mc, 0, dev)
        ref_logits, _ = par_forward(torch, dev, mc, full, None)
        local = shard_params(full, param_pspecs(mc), ep.mesh, rank)
        del full
        torch.cuda.empty_cache()
        logits, _ = par_forward(torch, dev, mc, local, ep)
        compare("ep2 logits", logits, ref_logits)
        del local
        torch.cuda.empty_cache()
        # sp 2: a 4096-id prompt in one ring pass against the chunked path.
        sp = par_state_for(base, MeshConfig(sp=2))
        mc = get_config(PAR_MODEL).with_overrides(num_layers=PAR_CHECK_LAYERS, dtype="float32")
        params = init_params(mc, 0, dev)
        ids = torch.randint(1, mc.vocab_size, (PAR_SP_IDS,),
                            generator=torch.Generator().manual_seed(6))
        npg = PAR_SP_IDS // PS
        cache = PagedKVCache.create(mc, npg, PS, torch.float32, dev)
        table = list(range(npg))
        for lo in range(0, PAR_SP_IDS, PAR_SP_CHUNK):
            rb = one_row_batch(torch, dev, 1, table, ids[lo:lo + PAR_SP_CHUNK].tolist(), lo,
                               False)
            chunk_logits = forward_ragged(params, mc, rb, cache)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp_logits, rows = forward_sp_prefill(params, mc, ids.to(dev), PAR_SP_IDS, sp)
        torch.cuda.synchronize()
        rep["sp_pass_ms"] = (time.perf_counter() - t0) * 1e3
        compare("sp2 first-token logits", sp_logits, chunk_logits)
        sealed = rows.reshape(mc.num_layers, npg, PS, *rows.shape[2:])
        compare("sp2 sealed pages", sealed, cache.pages)
        del params, cache, rows, sealed
        torch.cuda.empty_cache()
        # The all-reduce over the group, host-staged (gloo).
        times = {}
        for rows_n in PAR_ALLREDUCE_ROWS:
            x = torch.ones((rows_n, 4096), dtype=torch.bfloat16, device=dev)
            for _ in range(3):
                base.tp.all_reduce(x)
            torch.cuda.synchronize()
            n = 20
            t0 = time.perf_counter()
            for _ in range(n):
                base.tp.all_reduce(x)
            torch.cuda.synchronize()
            times[f"[{rows_n}, 4096] bf16"] = (time.perf_counter() - t0) * 1e3 / n
        rep["allreduce_ms"] = times
        rep["memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(out_path, "w") as f:
        json.dump(rep, f)


def par_f32_checks(fails, out):
    """Phase q's f32 part: two ranks (this script, ``--parallel-rank``)
    on the card, over gloo."""
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_q_") as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--parallel-rank",
                                   str(r), str(port), os.path.join(tmp, f"{r}.json")],
                                  cwd=str(REPO), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=PAR_RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out["f32_ranks_s"] = time.perf_counter() - t0
        reps = []
        for r, p in enumerate(procs):
            if p.returncode != 0:
                fails.append(f"f32 rank {r} exited {p.returncode}")
                log(f"parallel rank {r} FAILED:\n{logs[r][-3000:]}")
                continue
            with open(os.path.join(tmp, f"{r}.json")) as f:
                reps.append(json.load(f))
    for rep in reps:
        for label, (err, ok, mag) in rep["errors"].items():
            log(f"parallel f32 rank {rep['rank']} {label}: max_abs_err {err:.3e} "
                f"(max |x| {mag:.3f}) tol {PAR_TOL} {'ok' if ok else 'FAIL'}")
            if not ok:
                fails.append(f"rank {rep['rank']} {label}")
    if reps:
        r0 = reps[0]
        log(f"parallel: backend {r0['backend']}, programs {'eager' if r0['eager'] else 'graphs'}"
            f" (two ranks on one card) [{CARD}]")
        for k, ms in r0["allreduce_ms"].items():
            log(f"parallel all-reduce {k} over 2 ranks on one card (gloo, host-staged): "
                f"{ms:.3f} ms [{CARD}]")
        log(f"parallel sp 2 ring pass, {PAR_SP_IDS} ids, {PAR_CHECK_LAYERS} layers f32: "
            f"{r0['sp_pass_ms']:.1f} ms [{CARD}]")
        out.update(backend=r0["backend"], eager=r0["eager"], allreduce_ms=r0["allreduce_ms"],
                   sp_pass_f32_ms=r0["sp_pass_ms"],
                   f32_errors={rep["rank"]: rep["errors"] for rep in reps},
                   f32_peak_gib=[rep["memory_gib"] for rep in reps])


def par_prompts(n, isl, seed):
    rng = random.Random(seed)
    return [[rng.randrange(1, DIST_VOCAB) for _ in range(isl)] for _ in range(n)]


async def par_complete(port, prompt, max_tokens):
    """A streamed greedy completion with logprobs: (status, the logprob
    entries' token texts, TTFT s, ITL s, completion tokens of the usage,
    the entries' logprobs).  Tokens whose text the detokenizer holds back
    share an entry with the next, so the usage counts the stream."""
    texts, stamps, used, logprobs = [], [], [], []

    def on_event(t, ev):
        if not ev.startswith("data: ") or ev == "data: [DONE]":
            return
        c = json.loads(ev[len("data: "):])
        if c.get("usage"):
            used.append(c["usage"].get("completion_tokens"))
        for ch in c.get("choices") or []:
            lp = ch.get("logprobs") or {}
            for tok, val in zip(lp.get("tokens") or [], lp.get("token_logprobs") or []):
                texts.append(tok)
                logprobs.append(val)
                stamps.append(t)

    body = {"model": PAR_MODEL, "prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
            "stream": True, "logprobs": 0, "nvext": {"ignore_eos": True}}
    st, _, _, _ = await http_call(port, "POST", "/v1/completions", body, on_event=on_event)
    ttft = stamps[0] if stamps else float("nan")
    itl = (stamps[-1] - stamps[0]) / max(1, len(stamps) - 1) if stamps else float("nan")
    return st, texts, ttft, itl, used[-1] if used else None, logprobs


async def par_at_once(port, prompts, max_tokens, timeout):
    """``par_complete`` of every prompt, all sent at once, within
    ``timeout`` seconds."""
    return await asyncio.wait_for(asyncio.gather(
        *(par_complete(port, p, max_tokens) for p in prompts)), timeout)


class ParRun:
    """One ``run in=http out=torch`` of phase q (bf16, at the depth that
    ``model_depth`` sets and the site hook applies) and the rank processes
    it starts, whose kernel launches the site hook writes at their exit."""

    def __init__(self, name, flags, env):
        self.port = _free_port()
        self.t0 = time.perf_counter()
        self.child = Child(name, ["run", "in=http", "out=torch", "--host", "127.0.0.1",
                                  "--port", str(self.port), *PAR_RUN_FLAGS, *flags], env=env)
        self.boot_s = None

    def wait(self):
        self.child.wait_line("serving ", PAR_SERVE_TIMEOUT_S)
        self.boot_s = time.perf_counter() - self.t0
        return self

    def rank_pids(self):
        return [self.child.p.pid, *rank_pids(self.child.lines)]

    def serve(self, prompts, max_tokens):
        return [asyncio.run(par_complete(self.port, p, max_tokens)) for p in prompts]


def par_reports(reports, pids):
    """The site hook's exit reports of ``pids``: launches summed, and per
    pid its launches and peak allocated card memory (GiB)."""
    total, per = {}, {}
    for pid in pids:
        path = os.path.join(reports, f"{pid}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rec = json.load(f)
        per[pid] = dict(rec["launches"] or {}, peak_allocated_gib=rec.get("peak_allocated_gib"))
        for k, v in (rec["launches"] or {}).items():
            total[k] = total.get(k, 0) + v
    return total, per


def rank_pids(lines):
    """The pids of the ranks a ``run`` command started, from its output."""
    return [int(m.group(1)) for m in (re.match(r"rank \d+ started \(pid (\d+)\)", x)
                                      for x in lines) if m]


def reap(pids, fails, label, timeout=60):
    """Wait for ``pids`` to exit; any still alive after ``timeout`` is a
    failure and is killed."""
    deadline = time.time() + timeout
    alive = list(pids)
    while alive and time.time() < deadline:
        alive = [p for p in pids if _pid_alive(p)]
        time.sleep(0.2)
    if alive:
        fails.append(f"{label}: rank processes {alive} outlived the run")
        for p in alive:
            os.kill(p, signal.SIGKILL)


def par_stop(child, reports, fails, label):
    """Stop a ``run`` command (SIGINT to the leader) and check that every
    rank process it started exits with it."""
    pids = [child.p.pid, *rank_pids(child.lines)]
    child.stop(signal.SIGINT)
    reap(pids, fails, label)
    return par_reports(reports, pids)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # A zombie (exited, not yet reaped) holds nothing.
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def par_zero(pids):
    for pid in pids:
        os.kill(pid, signal.SIGUSR1)
    time.sleep(0.5)


def parallel_path(torch):
    """Phase q: tensor, expert, data and sequence parallelism and the step
    plane, with ranks sharing this one card over gloo (NCCL refuses two
    ranks on one GPU): no number here measures an interconnect.  Returns
    (ok, launches of every rank of the tp 2 run, numbers)."""
    fails, out = [], {}
    t_phase = time.perf_counter()

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"parallel check FAILED: {what}")

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.parallel.distributed import choose_backend

    log(f"parallel: torch.cuda.device_count() {torch.cuda.device_count()}; two ranks on one card "
        f"choose {choose_backend(['h/0', 'h/0'])} (one card a rank: "
        f"{choose_backend(['h/0', 'h/1'])}); gloo runs the programs eagerly")
    par_f32_checks(fails, out)
    for f in list(fails):
        log(f"parallel check FAILED: {f}")

    prompts = par_prompts(PAR_PROMPTS, PAR_ISL, 17)
    sp_prompt = par_prompts(1, PAR_SP_IDS, 18)[0]
    sp_pair = par_prompts(2, PAR_SP_IDS, 19)
    # tp 1 in this process: the streams and the chunked TTFT of the 4096-id
    # prompt that the runs below are held against.

    async def one_rank():
        eng = TorchEngine(EngineConfig(model=PAR_MODEL, max_batch=8, num_blocks=1024,
                                       max_model_len=8192, seed=0))
        try:
            got = [(await dist_engine_alone(eng, p, PAR_MAX_TOKENS))[0] for p in prompts]
            return got, (await dist_engine_alone(eng, sp_prompt, 4))[1]
        finally:
            await eng.close()

    streams, ttft = asyncio.run(one_rank())
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parallel tp 1 (this process, CUDA graphs): {PAR_SP_IDS}-id prompt chunked TTFT "
        f"{ttft * 1e3:.1f} ms [{CARD}]")
    out["chunked_ttft_ms"] = ttft * 1e3

    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    want_texts = [[tok.decode([t]) for t in s] for s in streams]
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_q_") as tmp:
        site, reports = os.path.join(tmp, "site"), os.path.join(tmp, "reports")
        os.makedirs(site)
        os.makedirs(reports)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(SDK_SITE_HOOK + TPT_DEPTH_HOOK)
        env = {"PYTHONPATH": os.pathsep.join([site, str(REPO)]),
               "CHIP_SMOKE_CHILD_DIR": reports, "DYN_LOG": "info"}

        # q3: run --tp 2, one command.
        run = ParRun("tp2", ["--tp", "2"], env)
        try:
            run.wait()
            used = card_used_mib()
            par_zero(run.rank_pids())
            res = run.serve(prompts, PAR_MAX_TOKENS)
        finally:
            total, per = par_stop(run.child, reports, fails, "run --tp 2")
        line = next((x for x in run.child.lines if x.startswith("parallel: ")), "")
        log(f"parallel run --tp 2: {line} ; boot {run.boot_s:.1f} s with a warm _build [{CARD}]")
        check(all(r[0] == 200 and r[4] == PAR_MAX_TOKENS for r in res),
              f"run --tp 2 served every request whole ({[(r[0], r[4]) for r in res]})")
        texts = [r[1] for r in res]
        same = sum(t == w for t, w in zip(texts, want_texts))
        log(f"parallel run --tp 2: {same}/{len(texts)} streams equal tp 1's (ungated: "
            f"batch invariance), TTFT {[round(r[2] * 1e3, 1) for r in res]} ms, ITL "
            f"{[round(r[3] * 1e3, 2) for r in res]} ms [{CARD}]")
        log(f"parallel run --tp 2 card's used memory while serving, all processes: {used} MiB "
            f"(nvidia-smi; a rank's own is its peak allocated below) [{CARD}]")
        for pid, l in per.items():
            log(f"parallel run --tp 2 rank pid {pid}: launches and peak allocated GiB {l} "
                f"[{CARD}]")
            check(l.get("decode_attention", 0) > 0 and l.get("prefill_attention", 0) > 0,
                  f"rank pid {pid} launched both attention kernels ({l})")
        check(len(per) == 2, f"both ranks reported their launches ({sorted(per)})")
        launches = total
        out.update(tp2_boot_s=run.boot_s, tp2_streams_equal_tp1=same,
                   tp2_ttft_ms=[r[2] * 1e3 for r in res], tp2_itl_ms=[r[3] * 1e3 for r in res],
                   tp2_card_used_mib=used, tp2_launches=per)

        # q4: the same as two commands, --nnodes 2.
        coord, step = f"127.0.0.1:{_free_port()}", str(_free_port())
        env2 = {**env, "DYN_STEP_TOKEN": "chip-smoke-two-nodes"}
        nodes = ["--tp", "2", "--nnodes", "2", "--coordinator", coord, "--step-port", step]
        follower = Child("node1", ["run", "in=http", "out=torch", "--host", "127.0.0.1",
                                   "--port", str(_free_port()), *PAR_RUN_FLAGS, *nodes,
                                   "--node-rank", "1"], env=env2)
        lead = ParRun("node0", [*nodes, "--node-rank", "0"], env2)
        try:
            lead.wait()
            res2 = lead.serve(prompts, PAR_MAX_TOKENS)
        finally:
            par_stop(lead.child, reports, fails, "run --nnodes 2 leader")
            try:
                follower.p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                check(False, "the follower node exits when the leader closes")
                follower.stop(signal.SIGKILL)
        check(follower.p.returncode == 0,
              f"the follower node exited {follower.p.returncode} after the leader closed")
        check([r[1] for r in res2] == texts,
              "the two-command --nnodes 2 form gives run --tp 2's texts")
        log(f"parallel run --nnodes 2 (two commands, DYN_STEP_TOKEN set): "
            f"{sum(r[1] == t for r, t in zip(res2, texts))}/{len(texts)} texts equal run --tp 2's;"
            f" boot {lead.boot_s:.1f} s [{CARD}]")
        out.update(nnodes_boot_s=lead.boot_s)

        # q5: run --sp 2 on a 4096-id prompt.
        run = ParRun("sp2", ["--sp", "2", "--sp-prefill-min", "1024"], env)
        try:
            run.wait()
            st, _, sp_ttft, _, sp_used, _ = asyncio.run(par_complete(run.port, sp_prompt, 4))
            # Two more long prompts at once: each pass and its seal are one
            # dispatch on every rank, so they cannot interleave.
            try:
                pair = asyncio.run(par_at_once(run.port, sp_pair, 4, 300))
            except asyncio.TimeoutError:
                pair = None
        finally:
            par_stop(run.child, reports, fails, "run --sp 2")
        sealed = [x for x in run.child.lines if "sp prefill sealed" in x]
        check(st == 200 and sp_used == 4, f"run --sp 2 served the {PAR_SP_IDS}-id prompt")
        check(bool(sealed), "run --sp 2 sealed the prompt's blocks in one ring pass")
        check(pair is not None and all(r[0] == 200 and r[4] == 4 for r in pair),
              f"run --sp 2 served two {PAR_SP_IDS}-id prompts sent at once, each whole")
        check(len(sealed) == 3, f"run --sp 2 sealed each of the three prompts ({len(sealed)} seals)")
        log(f"parallel run --sp 2: {sealed[0].split(': ')[-1] if sealed else 'no seal'}; "
            f"TTFT {sp_ttft * 1e3:.1f} ms beside tp 1 chunked {ttft * 1e3:.1f} ms; two at once "
            f"TTFT {[round(r[2] * 1e3, 1) for r in pair or []]} ms "
            f"({PAR_SP_IDS} ids, bf16, {os.environ.get(DEPTH_ENV, 'all')} layers, eager over "
            f"gloo) [{CARD}]")
        out.update(sp_ttft_ms=sp_ttft * 1e3, sp_boot_s=run.boot_s,
                   sp_pair_ttft_ms=[r[2] * 1e3 for r in pair or []])
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel phase: {out['phase_s']:.1f} s")
    return not fails, launches, out


# ------------------------------------------------------------------ phase r

# llama-3.1-8b at PATH_CUT_LAYERS of its layers (1 MiB a block in bf16):
# the disaggregated stack with a tp-2 prefill worker, then ``run --tp 2``
# with phase g's tier budgets.  TPT_TIER_PROMPTS x 129 blocks overflow the
# host and disk tiers (1024 blocks each) into the object store.
TPT_DISAGG_PROMPTS = 4
TPT_TIER_PROMPTS, TPT_TIER_NEW = 17, 8  # 2056 + 8 ids: 129 blocks sealed each
TPT_TIER_ARGV = ["--num-blocks", str(TIER_CFG["num_blocks"]), "--host-cache-mb", "1024",
                 "--disk-cache-mb", "1024", "--object-store-mb", "2048"]
TPT_HOST_BUDGET = 1024 << 20
TPT_SNAP_TIMEOUT_S = 30
# The children's site hook: phase p's (launches at exit, SIGUSR1 zeroes
# them), the layer cut applied at start (a started rank runs the CLI
# module without CHILD_PRELUDE), and SIGUSR2 writing a snapshot of each
# TorchEngine of the process: its host tier's bytes and its KV transfers'
# parts, with the CRC kernel's launches.
TPT_DEPTH_HOOK = f"""\
import os as _os
if _os.environ.get({DEPTH_ENV!r}):
    from dynamo_tpu_torch.models import config as _mc
    _mc._REGISTRY[{DIST_MODEL!r}] = _mc._REGISTRY[{DIST_MODEL!r}].with_overrides(
        num_layers=int(_os.environ[{DEPTH_ENV!r}]))
"""
TPT_SNAP_HOOK = '''

def _snap(signum, frame):
    import gc
    crc = sys.modules.get("dynamo_tpu_torch.ops.crc32")
    engines = []
    for o in gc.get_objects():
        if type(o).__name__ == "TorchEngine":
            hk = getattr(o, "host_kv", None)
            engines.append({"rank": None if o.shard is None else o.shard.rank,
                            "host_bytes": None if hk is None else hk.used_bytes,
                            "host_capacity": None if hk is None else hk.capacity_bytes,
                            "transfer_parts": [list(x) for x in o.transfer_parts]})
    g = _graphs()
    rec = {"pid": os.getpid(), "engines": engines,
           "launches": None if g is None else g.kernel_launches(),
           "crc32_blocks": None if crc is None else crc.block_crc32_cuda.launches}
    tmp = os.path.join(_OUT, f"{os.getpid()}.snap.tmp")
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, os.path.join(_OUT, f"{os.getpid()}.snap.json"))


if _OUT:
    signal.signal(signal.SIGUSR2, _snap)
'''
TPT_SITE_HOOK = SDK_SITE_HOOK + TPT_SNAP_HOOK + TPT_DEPTH_HOOK  # the cut after any chained hook


def tpt_snapshot(reports, pid):
    """The site hook's snapshot of process ``pid`` (SIGUSR2), or None."""
    path = os.path.join(reports, f"{pid}.snap.json")
    if os.path.exists(path):
        os.remove(path)
    os.kill(pid, signal.SIGUSR2)
    end = time.time() + TPT_SNAP_TIMEOUT_S
    while time.time() < end:
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        time.sleep(0.1)
    return None


def tpt_disagg(torch, check, out, reports):
    """Phase r, part 1: the README's disaggregated stack whose prefill
    worker P is ``run … --disagg prefill --tp 2`` (its second rank started
    by the command, both sharing the card over gloo); D is the CLI's own
    ``--disagg decode`` code in this process, one rank."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.component import DistributedRuntime, parse_endpoint_path
    from dynamo_tpu_torch.runtime.engine import Context, collect
    from dynamo_tpu_torch.tokens import hash_token_blocks

    hub_port = _free_port()
    hub_addr = f"127.0.0.1:{hub_port}"
    children, server, prefill = [], None, None

    def on_d(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, server.loop).result(timeout)

    async def alone(engine, prompt, n, salt):
        req = PreprocessedRequest(
            token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0), annotations={"kv_salt": salt},
        ).to_dict()
        return [t for item in await collect(await engine.generate(Context(req)))
                for t in item["token_ids"]]

    t_part = time.perf_counter()
    try:
        children.append(Child("hub", ["hub", "--host", "127.0.0.1", "--port", str(hub_port)]))
        children[-1].wait_line("hub listening", 120)
        front = Child("http", ["http", "--hub", hub_addr, "--host", "127.0.0.1", "--port", "0"])
        children.append(front)
        prefill = Child("prefill worker P (tp 2)", ["run", f"in={DISAGG_PREFILL_ENDPOINT}",
                                                    *DIST_ENGINE_ARGV, "--hub", hub_addr,
                                                    "--disagg", "prefill", "--tp", "2"])
        children.append(prefill)
        fport = int(front.wait_line("OpenAI frontend on", 120).rsplit(":", 1)[1])
        t = time.perf_counter()
        server = CliServer(["run", f"in={DIST_ENDPOINT}", *DIST_ENGINE_ARGV, "--hub", hub_addr,
                            "--disagg", "decode", "--max-local-prefill", str(DISAGG_THRESHOLD)])
        server.warmup()
        engine = server.engine
        out["d_up_s"] = time.perf_counter() - t
        prefill.wait_line("worker ", 600)
        out["p_up_s"] = time.perf_counter() - t_part
        p_pids = [prefill.p.pid, *rank_pids(prefill.lines)]
        line = next((x for x in prefill.lines if x.startswith("parallel: ")), "")
        log(f"tp tiers: disaggregated stack, hub {hub_addr}, frontend :{fport}, D in this "
            f"process (up and warmed in {out['d_up_s']:.1f} s), P = run --disagg prefill --tp 2 "
            f"(pids {p_pids}, registered {out['p_up_s']:.1f} s after the part began; {line})")
        check(len(p_pids) == 2, f"P started its second rank ({p_pids})")

        prompts = dist_prompts(TPT_DISAGG_PROMPTS, DISAGG_ISL, 41)
        warm = dist_prompts(2, DISAGG_ISL, 42)
        salt = "tp-disagg-reference"
        refs, local_ttft = {}, []
        for p in prompts:
            # D's local prefill of the remote path's shapes: a first pass
            # seals the 127 blocks, the stream hits them and prefills the
            # 8-id tail; and a whole local prefill's TTFT.
            on_d(alone(engine, p, 1, salt))
            refs[tuple(p)] = on_d(alone(engine, p, DISAGG_OSL, salt))
            local_ttft.append(on_d(dist_engine_alone(engine, p, 1))[1] * 1e3)
        chain0 = [tb.sequence_hash for tb in hash_token_blocks(prompts[0], PS)]

        async def phase():
            rt = await DistributedRuntime.connect(hub_addr)
            ns, comp, _ = parse_endpoint_path(DIST_ENDPOINT)
            stats_client = await rt.namespace(ns).component(comp).endpoint(
                "disagg_stats").client()
            await stats_client.wait_for_instances(30)

            async def stats():
                return (await collect(await stats_client.generate(Context({}))))[0]

            try:
                for _ in range(300):
                    if await rt.hub.kv_get_prefix("models/"):
                        break
                    await asyncio.sleep(0.1)
                for p in warm:  # P's first export and D's first import, off the record
                    r = await dist_complete(fport, p, 8)
                    check(r[0] == 200 and r[3] == 8, f"warm-up: {r[0]} {r[3]}")
                for pid in p_pids:
                    os.kill(pid, signal.SIGUSR1)
                s0 = await stats()
                n_parts0 = len(engine.transfer_parts)
                captured, inject = [], engine.inject_blocks

                async def capture(tokens, payload, salt=None, donor=None):
                    if list(tokens) == prompts[0]:
                        captured.append(payload)
                    return await inject(tokens, payload, salt, donor)

                engine.inject_blocks = capture
                try:
                    res = []
                    for i, p in enumerate(prompts):
                        r = await dist_complete(fport, p, DISAGG_OSL)
                        check(r[0] == 200 and r[2] == "length" and r[3] == DISAGG_OSL,
                              f"remote {i}: {r[0]} {r[2]}/{r[3]}")
                        res.append(r)
                finally:
                    engine.inject_blocks = inject
                s1 = await stats()
                moved = {k: s1[k] - s0[k] for k in
                         ("remote_prefills", "local_prefills", "degraded_fallbacks")}
                return res, moved, captured, list(engine.transfer_parts)[n_parts0:]
            finally:
                await rt.close()

        res, moved, captured, d_parts = asyncio.run(phase())
        check(moved == {"remote_prefills": TPT_DISAGG_PROMPTS, "local_prefills": 0,
                        "degraded_fallbacks": 0},
              f"{TPT_DISAGG_PROMPTS} of {TPT_DISAGG_PROMPTS} remote from the tp-2 worker, none "
              f"local or degraded ({moved})")
        # D's imported pages against the leader's gathered payload, bitwise.
        checked = same_pages = 0
        for pl in captured:
            shape = pl["shape"]  # [L, n, ps, KV, hd], every KV head of the model
            k = np.frombuffer(pl["k"], np.uint16).reshape(shape)
            v = np.frombuffer(pl["v"], np.uint16).reshape(shape)
            for j in range(int(pl["n_blocks"])):
                got = on_d(block_pages(engine, chain0[int(pl["start_block"]) + j]))
                want = np.stack([k[:, j], v[:, j]], axis=3).reshape(
                    shape[0], shape[2], 2 * shape[3], shape[4])
                checked += 1
                same_pages += int(got is not None and np.array_equal(
                    got.view(torch.int16).numpy().view(np.uint16), want))
        full = DISAGG_ISL // PS
        out["payload"] = {"chunks": len(captured), "blocks": checked, "bitwise": same_pages,
                          "kv_heads": captured[0]["shape"][3] if captured else None}
        check(checked == full and same_pages == full,
              f"D's imported pages bitwise the leader's gathered payload ({same_pages} of "
              f"{checked} blocks, {full} expected, KV heads {out['payload']['kv_heads']})")
        out["remote_ttft_ms"] = [r[4] * 1e3 for r in res]
        out["local_ttft_ms"] = local_ttft
        out["streams_equal_local"] = sum(r[1] == dist_text(refs[tuple(p)])
                                         for r, p in zip(res, prompts))
        snap = tpt_snapshot(reports, p_pids[0])
        exports = [pp for e in (snap or {}).get("engines", [])
                   for kind, _, pp in e["transfer_parts"] if kind == "export"]
        parts = ("pin", "lock_wait", "gather", "d2h_wait", "crc", "bytes")
        out["p_export_parts_ms"] = {k: statistics.median(pp[k] for pp in exports) * 1e3
                                    for k in parts} if exports else {}
        tot = sum(out["p_export_parts_ms"].values())
        out["gather_share"] = out["p_export_parts_ms"].get("gather", 0.0) / tot if tot else None
        out["d_inject_parts_ms"] = {
            k: statistics.median(pp.get(k, 0.0) for kind, _, pp in d_parts if kind == "inject")
            * 1e3 for k in ("parse", "verify", "upload", "hold")} if d_parts else {}
        out["chunks"] = [n for kind, n, _ in d_parts if kind == "inject"]
        check(bool(exports), f"P's leader reported its exports ({len(exports)})")
        share = out["gather_share"]
        log(f"tp tiers disagg: {moved}; remote TTFT {[round(x, 1) for x in out['remote_ttft_ms']]}"
            f" ms beside D's local prefill TTFT {[round(x, 1) for x in local_ttft]} ms; "
            f"{out['streams_equal_local']}/{TPT_DISAGG_PROMPTS} streams equal D's local prefill "
            f"of the same shapes (ungated: tp 2 all-reduces in another order); payload "
            f"{out['payload']}; P's export by part (median ms) "
            f"{({k: round(v, 2) for k, v in out['p_export_parts_ms'].items()})}, the gather "
            f"{None if share is None else round(share, 3)} of it; D's inject by part "
            f"{({k: round(v, 2) for k, v in out['d_inject_parts_ms'].items()})}; chunks "
            f"{out['chunks']} [{CARD}]")
    finally:
        if server is not None:
            server.stop()
        if prefill is not None:
            par_stop(prefill, reports, SimpleNamespace(append=lambda f: check(False, f)), "P")
        for c in reversed(children):
            c.stop()
    out["disagg_s"] = time.perf_counter() - t_part


def tpt_tiers(torch, check, out, reports, tmp):
    """Phase r, part 2: ``run in=http out=torch --tp 2`` with phase g's
    tier budgets, its leader in this process (the CLI's own code; its
    second rank started by it): 17 prompts of 2056 ids, then prefixes whose
    first block sits in the object store, on disk and in host restored and
    each stream held against its first pass.  Returns (the object-store
    prompt, its first pass) for part 3, or None."""
    from dynamo_tpu_torch.llm import metrics as tm
    from dynamo_tpu_torch.ops import crc32
    from dynamo_tpu_torch.tokens import hash_token_blocks

    t_part = time.perf_counter()
    server = CliServer(["run", "in=http", *DIST_ENGINE_ARGV, *TPT_TIER_ARGV, "--host", "127.0.0.1",
                        "--port", "0", "--tp", "2", "--disk-cache-dir", os.path.join(tmp, "disk"),
                        "--object-store-dir", os.path.join(tmp, "objects")])
    engine, port = server.engine, server.service.port
    follower = [p.pid for p in server.ranks.children]
    result = None

    def on_s(fn, timeout=600):
        """``fn()`` on the server's loop (the engine's state lives there)."""
        async def call():
            return fn()

        return asyncio.run_coroutine_threadsafe(call(), server.loop).result(timeout)

    async def drain():
        while engine._offload_queue:
            await engine.drain_offload()

    def scrape(name):
        _, _, body, _ = asyncio.run(http_call(port, "GET", "/metrics"))
        return parse_prometheus(body.decode()).get((name, ()), 0.0)

    try:
        out["tiers_up_s"] = time.perf_counter() - t_part
        check(engine.shard is not None and engine.shard.size == 2 and engine.shard.nnodes == 1,
              "run --tp 2 is two ranks on one node")
        check(engine.disk_kv is not None and engine.object_kv is not None,
              "run --tp 2 keeps its disk and object tiers on one node")
        t = time.perf_counter()
        server.warmup()
        out["tiers_warm_s"] = time.perf_counter() - t
        crc32.block_crc32_cuda.launches = 0
        prompts = tier_prompts(torch, TPT_TIER_PROMPTS, 51)
        chains = [[tb.sequence_hash for tb in hash_token_blocks(p, PS)] for p in prompts]
        n_blocks = TIER_LEN // PS
        first = []
        t = time.perf_counter()
        for i, p in enumerate(prompts):
            st, texts, ttft, _, used, lps = asyncio.run(par_complete(port, p, TPT_TIER_NEW))
            # Tokens whose text the detokenizer holds back share a chunk,
            # so the usage counts the stream, not the logprob entries.
            check(st == 200 and used == TPT_TIER_NEW, f"fill {i}: {st} {used}")
            first.append((list(zip(texts, lps)), ttft))
            asyncio.run_coroutine_threadsafe(drain(), server.loop).result(600)
        out["fill_s"] = time.perf_counter() - t
        tiers = on_s(lambda: [engine._tier_of(c[0]) for c in chains])
        out["tiers_after_fill"] = tiers
        check("objstore" in tiers and "disk" in tiers and "host" in tiers,
              f"fill: first blocks in host, disk and object store ({tiers})")
        rows = []

        def pick(tier):
            taken = {r["prompt"] for r in rows}
            cands = [i for i in reversed(range(TPT_TIER_PROMPTS))
                     if i not in taken and engine._tier_of(chains[i][0]) == tier]
            whole = [i for i in cands
                     if all(engine._tier_of(h) == tier for h in chains[i][:n_blocks])]
            return (whole or cands or [None])[0]

        for tier in ("objstore", "disk", "host"):
            i = on_s(lambda: pick(tier))
            check(i is not None, f"a prompt whose first block is in {tier}")
            if i is None:
                continue
            on_s(lambda: engine.kv.evict_hashes(chains[i]))
            n_parts0 = on_s(lambda: len(engine.transfer_parts))
            r0 = on_s(lambda: engine.host_kv.restored_blocks)
            m0 = scrape("dynamo_tpu_kv_tier_restored_blocks_total")
            c0 = tm.kv_tier_metrics.restored_blocks_total
            st, texts, ttft, _, used, lps = asyncio.run(par_complete(port, prompts[i],
                                                                      TPT_TIER_NEW))
            toks = list(zip(texts, lps))
            restored = on_s(lambda: engine.host_kv.restored_blocks) - r0
            passes = restore_parts(on_s(lambda: list(engine.transfer_parts))[n_parts0:])
            row = {"tier": tier, "prompt": i, "restored": restored,
                   "counter": tm.kv_tier_metrics.restored_blocks_total - c0,
                   "metric": scrape("dynamo_tpu_kv_tier_restored_blocks_total") - m0,
                   "ttft_ms": ttft * 1e3, "first_ttft_ms": first[i][1] * 1e3,
                   "restore_passes": passes[0], "restore_parts_ms": passes[1],
                   "identical": st == 200 and toks == first[i][0],
                   "host_bytes": on_s(lambda: engine.host_kv.used_bytes)}
            rows.append(row)
            asyncio.run_coroutine_threadsafe(drain(), server.loop).result(600)
            check(row["identical"], f"{tier}: the stream (tokens and logprobs) equals its "
                                    f"first pass")
            check(restored >= n_blocks, f"{tier}: {restored} blocks restored (>= {n_blocks})")
            check(restored == row["counter"] == row["metric"],
                  f"{tier}: restored {restored} = counter {row['counter']} = /metrics "
                  f"{row['metric']}")
            if tier == "objstore":
                result = (prompts[i], first[i][0])
        out["restores"] = rows
        snap = tpt_snapshot(reports, follower[0]) if follower else None
        f_host = sum(e["host_bytes"] or 0 for e in (snap or {}).get("engines", []))
        lead_host = on_s(lambda: engine.host_kv.used_bytes)
        out["host_bytes"] = {"leader": lead_host, "follower": f_host,
                             "peak_seen": max([lead_host] + [r["host_bytes"] for r in rows])}
        check(snap is not None and all(e["host_bytes"] is None for e in snap["engines"]),
              f"the follower keeps no host tier ({snap and snap['engines']})")
        check(out["host_bytes"]["peak_seen"] + f_host <= TPT_HOST_BUDGET,
              f"the node's host-tier bytes summed over its ranks within 1024 MiB "
              f"({out['host_bytes']})")
        out["crc_launches"] = crc32.block_crc32_cuda.launches
        check(out["crc_launches"] > 0, f"the CRC kernel launched on the leader "
                                       f"({out['crc_launches']})")
        shown = [{k: (round(v, 1) if isinstance(v, float) else
                      {p: round(x, 2) for p, x in v.items()} if isinstance(v, dict) else v)
                  for k, v in r.items()} for r in rows]
        log(f"tp tiers run --tp 2: up {out['tiers_up_s']:.1f} s, warmup {out['tiers_warm_s']:.1f} "
            f"s, fill {TPT_TIER_PROMPTS} x {TIER_LEN} ids in {out['fill_s']:.1f} s; first blocks "
            f"by tier {({t: tiers.count(t) for t in set(tiers)})}; restores {shown}; host-tier "
            f"bytes {out['host_bytes']} of {TPT_HOST_BUDGET}; CRC launches on the leader "
            f"{out['crc_launches']} [{CARD}]")
    finally:
        server.stop()
        reap(follower, SimpleNamespace(append=lambda f: check(False, f)), "run --tp 2")
    out["tiers_s"] = time.perf_counter() - t_part
    return result


def tpt_scale_from_zero(torch, dev, check, out, tmp, prompt, first):
    """Phase r, part 3: a fresh one-rank engine on the tp-2 worker's object
    store restores its prefix (scale from zero across tp)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    t = time.perf_counter()

    async def go():
        eng = TorchEngine(EngineConfig(**dict(
            TIER_CFG, host_offload_interval=3600.0, disk_cache_dir=os.path.join(tmp, "disk1"),
            object_store_dir=os.path.join(tmp, "objects"))), device=dev)
        try:
            n_obj = len(eng.object_kv)
            toks, stamps, finish = (await serve(torch, eng, [prompt], TPT_TIER_NEW))[0]
            return n_obj, toks, stamps[0], finish, eng.host_kv.restored_blocks
        finally:
            await eng.close()

    n_obj, toks, ttft, finish, restored = asyncio.run(go())
    tok = ByteTokenizer()
    same = [tok.decode([x]) for x in toks] == [x for x, _ in first]
    out["scale_from_zero"] = {"objects": n_obj, "restored": restored, "ttft_ms": ttft * 1e3,
                              "texts_equal_tp2": same, "s": time.perf_counter() - t}
    check(len(toks) == TPT_TIER_NEW and finish == "length", f"scale from zero: {len(toks)} tokens")
    check(restored >= TIER_LEN // PS, f"scale from zero across tp: a one-rank engine restored "
                                      f"{restored} blocks of the tp-2 worker's prefix")
    log(f"tp tiers scale from zero across tp: {out['scale_from_zero']} (the one-rank stream "
        f"against tp 2's first pass ungated) [{CARD}]")


def tp_tiers_path(torch, dev=None):
    """Phase r: KV export and whole-block KV tiers at tp 2 on one node, at
    PATH_CUT_LAYERS of llama-3.1-8b's layers, every rank sharing this card
    over gloo.  ``dev`` (default the card) is part 3's device.  Returns
    (ok, this process's launches in the phase, numbers)."""
    from dynamo_tpu_torch.ops import crc32

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"tp tiers check FAILED: {what}")

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_r_")
    site, reports = os.path.join(tmp, "site"), os.path.join(tmp, "reports")
    os.makedirs(site)
    os.makedirs(reports)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(TPT_SITE_HOOK)
    saved = {k: os.environ.get(k) for k in ("PYTHONPATH", "CHIP_SMOKE_CHILD_DIR")}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [site, str(REPO)] + ([saved["PYTHONPATH"]] if saved["PYTHONPATH"] else []))
    os.environ["CHIP_SMOKE_CHILD_DIR"] = reports
    zero_kernel_counts()
    zero_noise_launches()
    crc32.block_crc32_cuda.launches = 0
    launches = {}
    try:
        with model_depth(PATH_CUT_LAYERS):
            tpt_disagg(torch, check, out, reports)
            gc.collect()
            torch.cuda.empty_cache()
            got = tpt_tiers(torch, check, out, reports, tmp)
            launches = dict(kernel_counts(), threefry_gumbel=noise_launches(),
                            crc32_blocks=crc32.block_crc32_cuda.launches)
            gc.collect()
            torch.cuda.empty_cache()
            if got is not None:
                tpt_scale_from_zero(torch, dev or torch.device("cuda", 0), check, out, tmp, *got)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    check(launches.get("decode_attention", 0) > 0 and launches.get("prefill_attention", 0) > 0,
          f"both attention kernels launched in this process's part of the phase ({launches})")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tp tiers phase: {out['phase_s']:.1f} s; launches (this process: D and the tp-2 leader) "
        f"{launches}")
    return not fails, launches, out


# ------------------------------------------------------- phase s: the tuned table

TUNE_MODEL = "llama-3.1-8b"
# Every phase but s runs with DYN_DECODE_TUNE_TABLE at a path that does not
# exist (set by main), so a table left on the machine changes no launch.
TUNE_TABLE_ENV = "DYN_DECODE_TUNE_TABLE"
# The three geometries of the kernel rows (PERF.md §6): the serve phase's
# (bf16 pages), phase c's and phase d's (int8 pages), each swept by the
# tool at its rows, table width and prefill chunk.
# The serve geometry only since phase t came in (the script's time): the
# bench and loadgen geometries' sweeps and rows are PR 19's.
TUNE_GEOMETRIES = {
    "serve": dict(batch=SERVE_CFG["max_batch"], pages_per_seq=4096 // PS, cache_dtype="bfloat16",
                  prefill_chunk=SERVE_CFG["prefill_chunk"]),
}
TUNE_SPLITS, TUNE_PPCB, TUNE_PREFILL_SPLITS = "0,1,2,4,8,16", "4,8,16,32,64", "1,2,4,8"
TUNE_ITERS = 5  # launches a timed round (the tool's --iters): 7 rounds of 5, for the script's time
TUNE_REQUESTS, TUNE_MAX_TOKENS = 4, 32
TUNE_PINS = (2, 4, 8)  # DYN_DECODE_SPLITS pinned over the entry: the first that changes the launch
TUNE_TURNS = ("tuned", "default", "default", "tuned", "tuned", "default")
TUNE_DISPATCHES = 10  # fused decode dispatches a turn


def tune_case_bound(geo, prefill):
    """The bound of the tool's case at ``geo``: full chains, every row its
    whole table; for prefill, every row its last ``prefill_chunk`` tokens."""
    g = TUNE_GEOMETRIES[geo]
    B, L = g["batch"], g["pages_per_seq"] * PS
    esize = 1 if g["cache_dtype"] == "int8" else 2
    kv = B * L * 2 * KV * D * esize + B * g["pages_per_seq"] * 4
    if not prefill:
        return bound(kv + 2 * B * H * D * 2, B * L * H * D * 4)
    c = min(g["prefill_chunk"], L)
    return bound(kv + 2 * B * c * H * D * 2, B * (c * L - c * (c - 1) // 2) * H * D * 4)


def tune_sweeps(torch, table):
    """Part 1: the tool (``dynamo_tpu_torch.tools.tune_decode.main``, in
    this process) at each geometry into ``table``.  Returns {geo: report}."""
    import contextlib
    import io

    from dynamo_tpu_torch.tools import tune_decode

    reports = {}
    for geo, g in TUNE_GEOMETRIES.items():
        argv = ["--model", TUNE_MODEL, "--batch", str(g["batch"]), "--page-size", str(PS),
                "--pages-per-seq", str(g["pages_per_seq"]), "--cache-dtype", g["cache_dtype"],
                "--prefill-chunk", str(g["prefill_chunk"]), "--splits", TUNE_SPLITS,
                "--ppcb", TUNE_PPCB, "--prefill-splits", TUNE_PREFILL_SPLITS,
                "--iters", str(TUNE_ITERS), "--out", table]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tune_decode.main(argv)
        lines = buf.getvalue().strip().splitlines()
        reports[geo] = dict(json.loads(lines[-1]) if rc == 0 and lines else {}, rc=rc,
                            argv=argv, seconds=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    return reports


def tune_report(geo, report, check):
    """Print every combination of one geometry beside the built-in launch
    and the bound; the winners must hold their plain versions."""
    log(f"tune {geo}: tune_decode {' '.join(report['argv'][:-2])}: rc {report['rc']}, "
        f"{report['seconds']:.1f} s, key {report.get('key')}")
    check(report["rc"] == 0, f"the tool at {geo} exits 0")
    if report["rc"]:
        return
    for family, prefill in (("fused_sweep", False), ("prefill_sweep", True)):
        rows = report[family]
        b_ms, b_by = tune_case_bound(geo, prefill)
        default = next(r for r in rows if r.get("default"))
        d_ms = default["us"] / 1e3 if "us" in default else float("nan")
        for r in rows:
            if "rejected" in r:
                log(f"tune {geo} {family} splits={r['splits']} ppcb={r['ppcb']}: refused "
                    f"({r['rejected']})")
                continue
            plan = (f"part {r['part']} x {r['J']}" if not prefill
                    else f"{r['J']} x {r['split_pages']} pages")
            knobs = ("built-in" if r.get("default") else
                     f"splits={r['splits']}" + ("" if prefill else f" ppcb={r['ppcb']}"))
            ms = r["us"] / 1e3 if "us" in r else float("nan")
            log(f"tune {geo} {'prefill' if prefill else 'decode'} {knobs} ({plan}): {ms:.4f} ms "
                f"(built-in {d_ms:.4f} ms, x{ms / d_ms:.3f}; bound {b_ms:.4f} ms {b_by}, "
                f"{b_ms / ms:.0%} of it), max_abs_err {r['max_abs_err']:.3e} "
                f"{'ok' if r['ok'] else 'FAIL'}")
            check(r["ok"], f"{geo} {family} {knobs} ({plan}) against its plain version")
    entry = report["entry"]
    for family, key in (("fused_sweep", "splits"), ("prefill_sweep", "prefill_splits")):
        win = [r for r in report[family] if not r.get("default") and r["splits"] == entry.get(key)
               and (family == "prefill_sweep" or r["ppcb"] == entry.get("ppcb"))]
        check(len(win) == 1 and win[0].get("ok"),
              f"{geo} {family} winner held to its plain version at rtol = atol = 1e-2 "
              f"({win})")
    log(f"tune {geo} entry: {json.dumps(entry, sort_keys=True)}")


def tune_row_times(torch, dev, tally, entries):
    """Part 2: each kernel row of PERF.md §6 (phase 4's serve shapes, phase
    a's int8 shapes) under its geometry's tuned entry beside the built-in
    launch, in alternating rounds; the tuned output held against the plain
    version.  Returns {geo: {kernel: numbers}}."""
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    sm = D**-0.5
    cfg_serve = SimpleNamespace(max_batch=SERVE_CFG["max_batch"])
    bench_lens = [129 + (7 * i) % 64 for i in range(256)]
    loadgen_lens = [3000 + 6 * i for i in range(24)]
    i8, sc = torch.int8, INT8_KV_SCALE
    rows = {
        "serve": {"decode_attention": (serving_decode_lens(cfg_serve)[1], 4096 // PS,
                                       torch.bfloat16, 1.0),
                  "prefill_attention": (SERVE_CFG["max_batch"], 512, [1024], [512],
                                        torch.bfloat16, 1.0)},
        "bench": {"decode_attention": (bench_lens, 16, i8, sc),
                  "prefill_attention": (256, 512, [0] * 4, [128] * 4, i8, sc)},
        "loadgen": {"decode_attention": (loadgen_lens, 256, i8, sc),
                    "prefill_attention": (24, 2048, [2048, 0], [952, 1096], i8, sc)},
    }
    out = {}
    da.clear_tuned_hints()
    for geo, kernels in rows.items():
        if geo not in TUNE_GEOMETRIES:
            continue
        entry = entries.get(geo) or {}
        out[geo] = {}
        for name, spec in kernels.items():
            gen.manual_seed(3)
            if name == "decode_attention":
                lens, PP, pdt, scale = spec
                kv_scale = None if pdt == torch.bfloat16 else scale
                q, pages, kv_lens, tables, num = decode_case(
                    torch, gen, dev, lens, len(lens), PP, torch.bfloat16, pdt, scale)
                args = (q, pages, kv_lens, tables, num)
                plain = da.decode_attention_plain(*args, sm_scale=sm, kv_scale=kv_scale)
                knobs = dict(num_kv_splits=entry.get("splits"), pages_per_block=entry.get("ppcb"))
                fn = da.decode_attention_cuda
                want_plan = da.decode_partitions(PP, PS, knobs["num_kv_splits"],
                                                 knobs["pages_per_block"])
                builtin = da.decode_partitions(PP, PS)
                label = f"S={len(lens)} PP={PP}"
            else:
                S, T, priors, q_lens, pdt, scale = spec
                kv_scale = None if pdt == torch.bfloat16 else scale
                q, pages, kv_lens, tables, cu, num = prefill_case(
                    torch, gen, dev, priors, q_lens, S, T, torch.bfloat16, pdt, scale)
                args = (q, pages, kv_lens, tables, cu, num)
                plain = pa.prefill_attention_plain(*args, sm_scale=sm, kv_scale=kv_scale)
                knobs = dict(num_kv_splits=entry.get("prefill_splits"))
                fn = pa.prefill_attention_cuda
                PP = tables.shape[1]
                sp, J = pa.prefill_partitions(PP, knobs["num_kv_splits"])
                want_plan = (sp * PS, J)
                sp, J = pa.prefill_partitions(PP)
                builtin = (sp * PS, J)
                label = f"T={T} S={S} PP={PP}"

            def tuned(fn=fn, args=args, knobs=knobs, kv_scale=kv_scale):
                return fn(*args, sm_scale=sm, kv_scale=kv_scale, **knobs)

            def default(fn=fn, args=args, kv_scale=kv_scale):
                return fn(*args, sm_scale=sm, kv_scale=kv_scale)

            got = tuned()
            plan = fn.last_plan
            tally.compare(torch, name, f"tuned {geo} {label} pages={pdt} plan {plan}", got, plain,
                          1e-2)
            default()
            dplan = fn.last_plan
            rt, rd = [], []
            for _ in range(TIMING_ROUNDS):
                rt.append(cuda_ms(torch, tuned, 20, flush))
                rd.append(cuda_ms(torch, default, 20, flush))
            r = dict(ms=statistics.median(rt), default_ms=statistics.median(rd), plan=list(plan),
                     default_plan=list(dplan), want_plan=list(want_plan),
                     builtin_plan=list(builtin), rounds=rt, default_rounds=rd)
            out[geo][name] = r
            log(f"tune time {name} {geo} [{label}, pages {str(pdt).split('.')[-1]}]: tuned "
                f"{r['ms']:.4f} ms at {tuple(plan)}, built-in {r['default_ms']:.4f} ms at "
                f"{tuple(dplan)} (tuned/built-in {r['ms'] / r['default_ms']:.3f}); rounds "
                f"{[round(x, 4) for x in rt]} / {[round(x, 4) for x in rd]}")
            del q, pages, got, plain
    del flush
    torch.cuda.empty_cache()
    return out


def tune_dispatch_times(torch, on, off, turns=TUNE_TURNS):
    """A fused decode dispatch (16 rows at 1024 ids of context, 8 steps)
    replayed on the engine with the table and on one without it sharing
    its weights, in TUNE_TURNS; CUDA events around TUNE_DISPATCHES
    dispatches a turn.  Returns {"tuned": [ms...], "default": [ms...]}."""
    import numpy as np

    cfg = on.cfg
    S, PP, bs = cfg.max_batch, cfg.max_blocks_per_seq, cfg.block_size
    ctx = 1024
    per = ctx // bs + 2
    tables = np.zeros((S, PP), np.int32)
    for i in range(S):
        tables[i, :per] = np.arange(i * per, (i + 1) * per)
    tok0 = np.ones((S,), np.int64)
    pos0 = np.full((S,), ctx, np.int32)
    limits = np.full((S,), per * bs, np.int32)
    engines = {"tuned": on, "default": off}
    times = {k: [] for k in engines}
    with torch.inference_mode():
        for turn in turns:
            eng = engines[turn]
            samp = eng._sampling_arrays([])
            eng._run_multi(tok0, pos0, tables, limits, samp)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(TUNE_DISPATCHES):
                eng._run_multi(tok0, pos0, tables, limits, samp)
            b.record()
            b.synchronize()
            times[turn].append(a.elapsed_time(b) / TUNE_DISPATCHES)
    return times


def tune_path(torch, dev, tally, absent):
    """Phase s: the tuned launch table.  The sweep tool at the three
    geometries into a temporary table (every combination beside the
    built-in launch and the bound; every check against the plain version);
    each kernel row's time under its entry beside the built-in launch;
    then ``TorchEngine`` at the serve geometry (PATH_CUT_LAYERS layers)
    built with the table: its installed entry, TUNE_REQUESTS greedy
    requests served whole with both kernels launched at the entry's
    launches and no graph captured after warmup, the graph check, an env
    pin over the table, and a fused decode dispatch with and without the
    table in turns.  ``absent`` is the table path of every other phase,
    restored on return.  Returns (ok, launches, numbers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops import decode_attention as da
    from dynamo_tpu_torch.ops import prefill_attention as pa

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"tune check FAILED: {what}")

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_s_")
    table = os.path.join(tmp, "decode_tune.json")
    launches = {}
    try:
        with torch.inference_mode():
            reports = tune_sweeps(torch, table)
        for geo, report in reports.items():
            tune_report(geo, report, check)
        entries = {geo: r.get("entry") for geo, r in reports.items()}
        out["sweeps"] = reports
        out["sweep_s"] = time.perf_counter() - t_phase
        with torch.inference_mode():
            out["rows"] = tune_row_times(torch, dev, tally, entries)
        for geo, kernels in out["rows"].items():
            for name, r in kernels.items():
                check(r["plan"] == r["want_plan"] and r["default_plan"] == r["builtin_plan"],
                      f"{name} {geo}: the tuned launch {r['plan']} is the entry's "
                      f"{r['want_plan']}, the built-in {r['default_plan']} is "
                      f"{r['builtin_plan']}")

        # The engine with the table.
        os.environ[TUNE_TABLE_ENV] = table
        serve_entry = entries.get("serve")
        with model_depth(PATH_CUT_LAYERS):
            cfg = EngineConfig(**SERVE_CFG)
            engine = TorchEngine(cfg, device=dev)
            installed = da.active_hints()
            PP = cfg.max_blocks_per_seq
            want_decode = da.decode_partitions(PP, PS, (serve_entry or {}).get("splits"),
                                               (serve_entry or {}).get("ppcb"))
            sp, J = pa.prefill_partitions(PP, (serve_entry or {}).get("prefill_splits"))
            want_prefill = (sp * PS, J)
            log(f"tune engine: {TUNE_MODEL} at {engine.model_config.num_layers} layers, "
                f"{TUNE_TABLE_ENV}={table}: installed {json.dumps(installed, sort_keys=True)}; "
                f"launches decode {want_decode}, prefill {want_prefill}")
            check(serve_entry is not None and installed == serve_entry,
                  "the engine installed the serve geometry's entry")
            prompts = serve_prompts(torch)[:TUNE_REQUESTS]

            async def run():
                try:
                    out["warm"] = await engine.run_warmup()
                    warm = engine.compile_counts()
                    zero_kernel_counts()
                    t = time.perf_counter()
                    results = await serve(torch, engine, prompts, TUNE_MAX_TOKENS)
                    out["serve_s"] = time.perf_counter() - t
                    launches.update(kernel_counts())
                    plans = (da.decode_attention_cuda.last_plan,
                             pa.prefill_attention_cuda.last_plan)
                    whole = [len(t) == TUNE_MAX_TOKENS and f == "length" for t, _, f in results]
                    log(f"tune serve: {len(prompts)} greedy requests of "
                        f"{[len(p) for p in prompts]} ids, {TUNE_MAX_TOKENS} new: whole {whole}, "
                        f"{out['serve_s']:.2f} s, launches {launches}, last launches decode "
                        f"{plans[0]} prefill {plans[1]}, graphs {warm} -> "
                        f"{engine.compile_counts()}")
                    check(all(whole), "every stream whole")
                    check(launches["decode_attention"] > 0 and launches["prefill_attention"] > 0,
                          f"both kernels launched ({launches})")
                    check(plans == (want_decode, want_prefill),
                          f"the kernels launched the entry's shapes {plans} vs "
                          f"{(want_decode, want_prefill)}")
                    check(engine.compile_counts() == warm, "no graph captured after warmup")
                    check(graph_check(torch, dev, engine), "graph replays against eager calls")
                    # An env pin beats the table: a split count whose launch
                    # differs from the entry's.
                    ppcb = (serve_entry or {}).get("ppcb")
                    pin = next(v for v in TUNE_PINS
                               if da.decode_partitions(PP, PS, v, ppcb) != want_decode)
                    want_pin = da.decode_partitions(PP, PS, pin, ppcb)
                    os.environ["DYN_DECODE_SPLITS"] = str(pin)
                    try:
                        with torch.inference_mode():
                            gen = torch.Generator(device=dev)
                            gen.manual_seed(4)
                            lens = serving_decode_lens(cfg)[1]
                            args = decode_case(torch, gen, dev, lens, len(lens), PP,
                                               torch.bfloat16, torch.bfloat16, 1.0)
                            da.decode_attention_cuda(*args, sm_scale=D**-0.5)
                            pinned = da.decode_attention_cuda.last_plan
                    finally:
                        os.environ.pop("DYN_DECODE_SPLITS", None)
                    log(f"tune pin: DYN_DECODE_SPLITS={pin} over the entry (splits "
                        f"{(serve_entry or {}).get('splits')}, launch {want_decode}): launch "
                        f"{pinned}, expected {want_pin}")
                    check(pinned == want_pin, "DYN_DECODE_SPLITS beats the table")
                    # The same engine geometry without the table, sharing the
                    # weights: a fused decode dispatch in turns (one replay
                    # on this engine first, so that any graph it still
                    # captures holds the tuned launch).
                    tune_dispatch_times(torch, engine, None, turns=("tuned",))
                    os.environ[TUNE_TABLE_ENV] = absent
                    off = TorchEngine(cfg, params=engine.params, device=dev)
                    check(da.active_hints() is None, "no entry without the table")
                    try:
                        times = tune_dispatch_times(torch, engine, off)
                    finally:
                        await off.close()
                    out["dispatch"] = times
                    t_ms, d_ms = statistics.median(times["tuned"]), statistics.median(times["default"])
                    log(f"tune dispatch: a fused decode dispatch (16 rows at 1024 ids, "
                        f"{cfg.decode_steps} steps, {engine.model_config.num_layers} layers), "
                        f"{TUNE_DISPATCHES} a turn in turns {list(TUNE_TURNS)}: with the table "
                        f"{t_ms:.3f} ms {[round(x, 3) for x in times['tuned']]}, without "
                        f"{d_ms:.3f} ms {[round(x, 3) for x in times['default']]} (x"
                        f"{t_ms / d_ms:.3f})")
                finally:
                    await engine.close()

            asyncio.run(run())
            del engine
    finally:
        os.environ[TUNE_TABLE_ENV] = absent
        da.clear_tuned_hints()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tune phase: {out['phase_s']:.1f} s (sweeps {out.get('sweep_s', 0):.1f} s); launches "
        f"{launches}")
    return not fails, launches, out


# ------------------------------------------- t. the fault matrix and the chaos ladder

CHAOS_MODEL = "llama-3.1-8b"
CHAOS_LAYERS = 16  # the depth phase t runs at, as phases h–l (the script's time)
# The ladder's rungs on the card: baseline, a crash, the corruption storm,
# and the object tier's scale from zero (its replacement restores the
# victim's chain through the CRC kernel on every run; L7's host restores
# race the integrity plane's negative cache and may all miss).
CHAOS_LEVELS = "0,1,7,10"


def chaos_path(torch, dev):
    """Phase t: the port's fault matrix and chaos ladder on the card, on
    llama-3.1-8b at full width (the depth the caller's ``model_depth``
    sets), bf16 weights.  First ``dynamo_tpu_torch.tools.fault_matrix``
    with ``--engine``: every fault point against the port's hub, service
    plane, routed client, HTTP edge, integrity and bulk planes, then
    ``kv_pressure`` and ``tenant_flood`` on a ``TorchEngine`` on the card;
    no row may observe UNEXPECTED behaviour or NOT RECOVER.  Then
    ``dynamo_tpu_torch.tools.goodput``'s rungs CHAOS_LEVELS with three
    ``TorchEngine`` workers on the card sharing one weight tree, each
    ``batch_invariant`` (``--batch-invariance`` shows why), under
    ``--check`` (0 dropped streams, every stream identical to L0's — a
    seeded resume after L1's crash, the integrity plane's restores and
    injects under L7's flips, each flip detected before a scatter, L10's
    replacement engine restoring the crashed victim's persisted chain from
    the object tier, byte-identical) and its ``--fault-matrix``
    cross-check against the matrix just written.  The attention kernels,
    the draw (the ladder's requests sample at 0.8) and the restore's CRC
    kernel (L10's warm start, and L7's host restores where one beats the
    negative cache) must launch in the ladder, counters zeroed just before
    it and read just after.  Returns (ok, launches, numbers)."""
    from dynamo_tpu_torch.ops import crc32
    from dynamo_tpu_torch.tools import fault_matrix, goodput

    fails, out = [], {}

    def check(cond, what):
        if not cond:
            fails.append(what)
            log(f"chaos check FAILED: {what}")

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_t_") as tmp:
        fm_json = os.path.join(tmp, "fault_matrix.json")
        t = time.perf_counter()
        rc = asyncio.run(fault_matrix.run(fault_matrix.parser().parse_args(
            ["--engine", "--model", CHAOS_MODEL, "--dtype", "bfloat16", "--json", fm_json])))
        out["matrix_s"] = time.perf_counter() - t
        matrix = json.loads(Path(fm_json).read_text())
        rows = matrix["fault_matrix"]
        bad = fault_matrix.bad_rows(rows)
        check(rc == 0 and not bad, f"fault matrix: exit {rc}, rows {[r['fault'] for r in bad]}")
        check({"kv_pressure", "tenant_flood"} <= set(matrix["fault_kinds"]),
              f"fault matrix: the engine sweep ran ({matrix['fault_kinds']})")
        for r in rows:
            log(f"chaos matrix [{r['fault']}] at {r['injected_at']}: {r['observed']} -> "
                f"{r['status']}")
        gc.collect()  # the sweep's engine goes before the ladder's three
        torch.cuda.empty_cache()
        args = goodput.parser().parse_args(
            ["--levels", CHAOS_LEVELS, "--check", "--fault-matrix", fm_json, "--workdir", tmp,
             "--model", CHAOS_MODEL, "--dtype", "bfloat16"])
        zero_kernel_counts()
        zero_noise_launches()
        crc32.block_crc32_cuda.launches = 0
        t = time.perf_counter()
        report = asyncio.run(goodput.run_ladder(args))
        out["ladder_s"] = time.perf_counter() - t
        launches = dict(kernel_counts(), threefry_gumbel=noise_launches(),
                        crc32_blocks=crc32.block_crc32_cuda.launches)
    problems = goodput.check_report(report, args.min_goodput_ratio, args.min_tenant_ratio)
    for p in problems:
        check(False, f"ladder: {p}")
    cross = report.get("fault_matrix") or {}
    check(cross.get("unswept_used_kinds") == [],
          f"ladder: every fault kind its rungs use has a swept row ({cross})")
    check(all(v > 0 for v in launches.values()),
          f"ladder: the attention kernels, the draw and the CRC kernel launched ({launches})")
    for r in report["rungs"]:
        log(f"chaos rung {r['name']}: {r['completed']}/{r['requests']} completed, dropped "
            f"{r['dropped']} {r['dropped_errors']}, goodput {r['goodput']:.3f} (vs L0 "
            f"{r.get('goodput_vs_l0')}), TTFT p50 {r['ttft_p50_ms']} ms p95 {r['ttft_p95_ms']} ms, "
            f"ITL p95 {r['itl_p95_ms']} ms; resilience {r['resilience']}"
            + (f"; integrity {r['integrity']}" if "integrity" in r else "")
            + (f"; objstore {r['objstore']}" if "objstore" in r else "")
            + (f"; tracing {r['tracing']}" if "tracing" in r else ""))
    out.update(report={k: v for k, v in report.items() if k != "rungs"},
               rungs=[{k: v for k, v in r.items() if k != "deterministic"}
                      for r in report["rungs"]], launches=launches,
               wall_s=time.perf_counter() - t_phase)
    log(f"chaos (phase t, card {CARD}): fault matrix {len(rows)} rows in {out['matrix_s']:.1f} s "
        f"(exit {rc}); ladder {CHAOS_LEVELS} on {report['workers']} card engines in "
        f"{out['ladder_s']:.1f} s, --check {'passed' if not problems else problems}; launches "
        f"{launches}; phase wall {out['wall_s']:.1f} s {'ok' if not fails else 'FAIL: ' + '; '.join(fails)}")
    return not fails, launches, out



# --batch-invariance: the product widths of llama-3.1-8b, (in, out) features.
INVARIANCE_WIDTHS = {"wq": (4096, 4096), "wk": (4096, 1024), "wo": (4096, 4096),
                     "w_gate": (4096, 14336), "w_down": (14336, 4096), "lm_head": (4096, 128256)}
INVARIANCE_ROWS = (1, 2, 3, 4, 5, 8, 16, 32, 64, 128)
INVARIANCE_LADDERS = (True,) * 6 + (False,) * 5  # batch_invariant of each ladder run


@contextlib.contextmanager
def engines_batch_invariant(flag):
    """Every TorchEngine built meanwhile has ``batch_invariant=flag``."""
    import dataclasses

    from dynamo_tpu_torch.engine import engine as engine_mod

    init = engine_mod.TorchEngine.__init__

    def patched(self, cfg, *a, **k):
        init(self, dataclasses.replace(cfg, batch_invariant=flag), *a, **k)

    engine_mod.TorchEngine.__init__ = patched
    try:
        yield
    finally:
        engine_mod.TorchEngine.__init__ = init


def batch_invariance(torch, dev):
    """``--batch-invariance``: why the chaos ladder runs batch-invariant
    engines.  (1) One bf16 row's product at llama-3.1-8b widths, against
    the same row in a 4-row call (a fused decode dispatch's rows), at each
    of INVARIANCE_ROWS rows: the rows of the first 4 that differ, as cuBLAS
    is called by the forward without and with ``pad_rows`` 64 (every call
    64 rows); and the row at place 9 of 16 against place 0.  (2) The f32
    row mean ``rms_norm`` takes, likewise.  (3) Phase t's ladder (rungs
    CHAOS_LEVELS, --check) once for each INVARIANCE_LADDERS entry, with
    and without the mode: its problems.  Fails if a padded product or a
    ladder with the mode differs."""
    from dynamo_tpu_torch.tools import goodput

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fails = []

    def padded(x, w):  # forward_ragged's per_token at pad_rows 64
        xp = torch.cat([x, x.new_zeros((64 - x.shape[0], x.shape[1]))]) if x.shape[0] < 64 else x
        return torch.cat([xp[i:i + 64] @ w for i in range(0, xp.shape[0], 64)])[:x.shape[0]]

    for how, fn in (("plain", lambda x, w: x @ w), ("pad_rows 64", padded)):
        table = {}
        for name, (k, n) in INVARIANCE_WIDTHS.items():
            w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
            x = torch.randn((128, k), generator=gen, device=dev).to(torch.bfloat16)
            ref = fn(x[:4], w)
            row = {m: int((fn(x[:m], w)[:min(m, 4)] != ref[:min(m, 4)]).any(dim=1).sum())
                   for m in INVARIANCE_ROWS}
            moved = x[:16].clone()
            moved[[0, 9]] = x[[9, 0]]
            row["place 9"] = int(bool((fn(moved, w)[9] != fn(x[:16], w)[0]).any()))
            table[name] = row
            if how != "plain" and any(row.values()):
                fails.append(f"{how} {name}: {row}")
        log(f"batch invariance, card {CARD}: bf16 product rows (of 4) unlike the 4-row call's, "
            f"{how}, by row count: {json.dumps(table)}")
    x = torch.randn((128, 4096), generator=gen, device=dev)
    ref = (x[:4] * x[:4]).mean(-1)
    means = {m: int(((x[:m] * x[:m]).mean(-1)[:min(m, 4)] != ref[:min(m, 4)]).sum())
             for m in INVARIANCE_ROWS}
    log(f"batch invariance: f32 row means (of 4) unlike the 4-row call's, by row count: {means}")
    for flag in INVARIANCE_LADDERS:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bi_") as tmp, \
                engines_batch_invariant(flag):
            args = goodput.parser().parse_args(
                ["--levels", CHAOS_LEVELS, "--check", "--workdir", tmp,
                 "--model", CHAOS_MODEL, "--dtype", "bfloat16"])
            t = time.perf_counter()
            report = asyncio.run(goodput.run_ladder(args))
            wall = time.perf_counter() - t
        problems = goodput.check_report(report, args.min_goodput_ratio, args.min_tenant_ratio)
        if flag and problems:
            fails.append(f"ladder with the mode: {problems}")
        log(f"batch invariance: ladder {CHAOS_LEVELS} batch_invariant={flag} in {wall:.1f} s, "
            f"completed {[r['completed'] for r in report['rungs']]}, --check "
            f"{problems or 'passed'}")
        gc.collect()
        torch.cuda.empty_cache()
    for f in fails:
        log(f"batch invariance FAILED: {f}")
    return not fails

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    if not (REPO / "dynamo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: dynamo_tpu_torch is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--parallel-rank"]:  # one of phase q's f32 ranks
        par_rank_job(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    # Every phase but s reads no tuned table: a table left on this machine
    # must not change a launch (the children inherit the variable).
    absent = os.path.join(tempfile.gettempdir(), f"chip_smoke_{os.getpid()}_no_tune_table.json")
    if os.path.exists(absent):
        print(f"chip_smoke: {absent} exists", file=sys.stderr)
        return 1
    os.environ[TUNE_TABLE_ENV] = absent
    try:
        from dynamo_tpu_torch.ops import _build

        dev = torch.device("cuda", 0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        global CARD
        CARD = smi[0] if smi else "nvidia-smi gave nothing"
        log(f"card: {CARD}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        log(f"tuned table: {TUNE_TABLE_ENV}={absent}, a path that does not exist: every phase "
            f"but s launches the kernels' built-in shapes")

        mark("2 (build)")
        t0 = time.perf_counter()
        report = _build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(report) or 'cached libraries'}")
        for stem, r in report.items():
            for line in str(r["log"]).splitlines():
                if "registers" in line or "spill" in line.lower():
                    log(f"ptxas {stem}: {line.strip()}")
        if sys.argv[1:] == ["--serve-ab"]:
            return 0 if serve_ab(torch, dev) else 1
        if sys.argv[1:] == ["--quant-ab"]:
            return 0 if quant_ab(torch, dev) else 1
        if sys.argv[1:] == ["--grammar-compile"]:
            return 0 if grammar_compile_times() else 1
        if sys.argv[1:] == ["--sdk-graph"]:
            return 0 if sdk_path(torch)[0] else 1
        if sys.argv[1:] == ["--parallel"]:
            with model_depth(PATH_CUT_LAYERS):
                return 0 if parallel_path(torch)[0] else 1
        if sys.argv[1:] == ["--tp-tiers"]:
            return 0 if tp_tiers_path(torch)[0] else 1
        if sys.argv[1:] == ["--tune"]:
            return 0 if tune_path(torch, dev, Tally(), absent)[0] else 1
        if sys.argv[1:] == ["--upload-causes"]:
            return 0 if upload_causes(torch, dev) else 1
        if sys.argv[1:] == ["--chaos"]:
            with model_depth(CHAOS_LAYERS):
                return 0 if chaos_path(torch, dev)[0] else 1
        if sys.argv[1:] == ["--batch-invariance"]:
            with model_depth(CHAOS_LAYERS):
                return 0 if batch_invariance(torch, dev) else 1
        if sys.argv[1:] == ["--checkpoint"]:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_m_") as tmp:
                return 0 if checkpoint_path(torch, dev, tmp)[0] else 1

        from dynamo_tpu_torch.engine.config import EngineConfig

        cfg = EngineConfig(**SERVE_CFG)
        tally = Tally()
        check_tensor_cores(tally.failures)
        mark("3-5")
        with torch.inference_mode():
            check_kernels(torch, dev, cfg, tally)
            times = time_kernels(torch, dev, cfg, tally)
            crc_times = check_crc_kernel(torch, dev, tally)
            ok_model = model_check(torch, dev, cfg)
        mark("6 (with f and g)")
        ok_path, launches, ok_edge, edge, ok_tiers, tiers = main_path(torch, dev)
        # Phase 7 builds its own engine: free the direct serve's first
        # (16 GB of weights and 4 GiB of KV pages).
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the HTTP phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated")
        mark("7")
        ok_http, http_launches, _ = http_path(torch)
        gc.collect()
        torch.cuda.empty_cache()

        # This slice: W8A8 weights, calibrated int8 KV pages, speculation.
        mark("a")
        with torch.inference_mode():
            ok_ops = w8a8_ops(torch, dev)
            int8_times = time_int8_kernels(torch, dev, tally)
        mark("b")
        ok_w8a8_model = w8a8_model_check(torch, dev)
        mark("c")
        ok_bench, bench = bench_serve(torch, dev, quant=True)
        mark("d")
        ok_loadgen, loadgen = loadgen_http(torch, dev)
        mark("e")
        ok_spec, spec = spec_phase(torch, dev)
        # Phase h runs two llama-3.1-8b workers on this card (one in this
        # process): free what the earlier phases left first.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the distributed phase: {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        log(f"phases h, i and j (l on i's stack, k on j's) at {PATH_CUT_LAYERS} of "
            f"llama-3.1-8b's 32 layers")
        mark("h")
        with model_depth(PATH_CUT_LAYERS):
            ok_dist, dist_launches, _ = dist_path(torch)
        # Phase i runs two llama-3.1-8b workers on this card again.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the disaggregated phase: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        mark("i (with l)")
        with model_depth(PATH_CUT_LAYERS):
            ok_disagg, disagg_launches, _, (ok_planner, planner_launches, _) = disagg_path(torch)
        # Phase j: the sampler's kernel, then two workers again.
        gc.collect()
        torch.cuda.empty_cache()
        mark("j (with k)")
        with torch.inference_mode():
            noise_times = check_noise_kernel(torch, dev, tally)
        log(f"memory before the migration phase: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        with model_depth(PATH_CUT_LAYERS):
            (ok_migrate, migrate_launches, _), (ok_bulk, bulk_launches, _) = migrate_pull_path(
                torch, noise_times)
        # Phase m: checkpoints, the sentencepiece tokenizer, multi-LoRA.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the checkpoint and LoRA phase: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        # Phase n serves with the sentencepiece model that phase m writes.
        mark("m")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_m_") as tmp:
            ok_m, m_launches, _ = checkpoint_lora_path(torch, dev, tmp)
            gc.collect()
            torch.cuda.empty_cache()
            mark("n")
            ok_n, n_launches, _ = grammar_path(torch, dev, os.path.join(tmp, "tokenizer.model"))
        # Phase o: mixtral-8x7b under W8A8 (~47 GB resident).
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the MoE phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated")
        mark("o")
        ok_o, o_launches, _ = moe_path(torch, dev)
        # Phase p: the SDK graph's worker is a child of the runner; this
        # process's card memory goes back first.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the SDK phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        mark("p")
        ok_p, p_launches, _ = sdk_path(torch)
        # Phase q: ranks that share this card, over gloo.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"memory before the parallel phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        mark("q")
        with model_depth(PATH_CUT_LAYERS):
            ok_q, q_launches, _ = parallel_path(torch)
        # Phase r: KV export and the whole-block tiers at tp 2, one node.
        gc.collect()
        torch.cuda.empty_cache()
        mark("r")
        ok_r, r_launches, _ = tp_tiers_path(torch)
        # Phase s: the tuned launch table.
        gc.collect()
        torch.cuda.empty_cache()
        mark("s")
        ok_s, s_launches, tune = tune_path(torch, dev, tally, absent)
        # Phase t: the fault matrix and the chaos ladder on card engines.
        gc.collect()
        torch.cuda.empty_cache()
        mark("t")
        with model_depth(CHAOS_LAYERS):
            ok_t, t_launches, _ = chaos_path(torch, dev)
        mark("end")
        slice_ok = {"fault matrix and chaos ladder (t)": ok_t, "tuned launch table (s)": ok_s, "kv export and tiers at tp 2 (r)": ok_r,
                    "parallelism and the step plane (q)": ok_q,
                    "sdk graph and native library (p)": ok_p,
                    "structured output (n)": ok_n, "mixtral W8A8 (o)": ok_o,
                    "checkpoints, tokenizer and LoRA (m)": ok_m,
                    "w8a8 ops (a)": ok_ops, "w8a8 model (b)": ok_w8a8_model,
                    "bench geometry (c)": ok_bench, "loadgen geometry (d)": ok_loadgen,
                    "speculation (e)": ok_spec, "edge (f)": ok_edge, "kv tiers (g)": ok_tiers,
                    "distributed (h)": ok_dist, "disaggregated (i)": ok_disagg,
                    "migration and pull (j)": ok_migrate,
                    "bulk plane and watchdog (k)": ok_bulk, "planner (l)": ok_planner}

        sources = {
            "decode_attention": ("dynamo_tpu_torch/csrc/decode_attention.cu",
                                 "dynamo_tpu/ops/decode_attention.py:330"),
            "prefill_attention": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                                  "dynamo_tpu/ops/prefill_attention.py:285"),
        }
        kernels = []
        for name, (src, rep) in sources.items():
            tm = times[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "http_launches": http_launches[name],
                "max_abs_err": tally.worst[name],
                "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
                "checks_passed": not any(f.startswith(name) for f in tally.failures),
            })
            for geo, serve_out in (("bench", bench), ("loadgen", loadgen)):
                it = int8_times[geo][name]
                kernels[-1][f"int8_{geo}"] = {
                    "launches": serve_out["launches"][name], "ms": it["ms"],
                    "plain_ms": it["plain_ms"], "bound_ms": it["bound_ms"],
                    "bound_by": it["bound_by"], "library_ms": it["library_ms"]}
            kernels[-1]["spec_launches"] = spec[("repetitive", "on")]["launches"][name]
            kernels[-1]["spec_forced_launches"] = spec[("repetitive", "forced")]["launches"][name]
            kernels[-1]["edge_launches"] = edge["launches"][name]
            kernels[-1]["tier_launches"] = tiers["launches"][name]
            kernels[-1]["dist_launches"] = dist_launches[name]
            kernels[-1]["disagg_launches"] = disagg_launches[name]
            kernels[-1]["migrate_launches"] = migrate_launches[name]
            kernels[-1]["bulk_launches"] = bulk_launches[name]
            kernels[-1]["planner_launches"] = planner_launches[name]
            kernels[-1]["ckpt_launches"] = m_launches["ckpt"].get(name, 0)
            kernels[-1]["lora_launches"] = m_launches["lora"].get(name, 0)
            kernels[-1]["grammar_launches"] = n_launches.get(name, 0)
            kernels[-1]["moe_launches"] = o_launches.get(name, 0)
            kernels[-1]["sdk_launches"] = p_launches.get(name, 0)
            kernels[-1]["parallel_launches"] = q_launches.get(name, 0)
            kernels[-1]["tp_tiers_launches"] = r_launches.get(name, 0)
            kernels[-1]["tune_launches"] = s_launches.get(name, 0)
            kernels[-1]["chaos_launches"] = t_launches.get(name, 0)
            # Each geometry's row under its tuned entry, beside the
            # built-in launch timed in the same rounds.
            kernels[-1]["tuned"] = {
                geo: {k: r[k] for k in ("ms", "default_ms", "plan", "default_plan")}
                for geo, r in ((g, rows[name]) for g, rows in tune.get("rows", {}).items())}
            if "mixed" in tm:
                kernels[-1].update(mixed_step_ms=tm["mixed"]["ms"],
                                   mixed_step_plain_ms=tm["mixed"]["plain_ms"],
                                   mixed_step_bound_ms=tm["mixed"]["bound_ms"],
                                   mixed_step_library_ms=None,
                                   mixed_step_decode_rows_ms=tm["mixed"]["decode_rows_ms"])
        # The sampler's categorical draw has no Pallas counterpart (the JAX
        # package draws with jax.random.categorical in XLA); its path is the
        # sampled traffic, so its launches are phase j's (worker A) and
        # phase e's.  max_abs_err is the Gumbel values' (all 2^23 uniforms,
        # and the noise entry's); the tokens are compared for equality.
        nt = noise_times[max(NOISE_ROWS)]
        timing_keys = ("ms", "unfused_ms", "plain_ms", "bound_ms", "bound_by", "ctas")
        kernels.append({
            "name": "threefry_gumbel", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/threefry_gumbel.cu",
            "replaces": "dynamo_tpu/ops/sampling.py:165 (jax.random.categorical in XLA, no "
                        "Pallas kernel)",
            "launches": migrate_launches["threefry_gumbel"],
            "max_abs_err": tally.worst["threefry_gumbel"],
            "ms": nt["ms"], "plain_ms": nt["plain_ms"], "bound_ms": nt["bound_ms"],
            "bound_by": nt["bound_by"], "library_ms": None,
            "checks_passed": not any(f.startswith("threefry_gumbel") for f in tally.failures),
            "shape": f"B={max(NOISE_ROWS)} V={NOISE_V}",
            "unfused_ms": nt["unfused_ms"], "ctas": nt["ctas"],
            "rows16": {k: noise_times[16][k] for k in timing_keys},
            "spec_launches": {k: spec[(k, "on")]["noise"] for k in ("repetitive", "random")},
            "migrate_launches": migrate_launches["threefry_gumbel"],
            "bulk_launches": bulk_launches["threefry_gumbel"],
            "planner_launches": planner_launches["threefry_gumbel"],
            "sdk_launches": p_launches.get("threefry_gumbel", 0),
            "parallel_launches": q_launches.get("threefry_gumbel", 0),
            "tp_tiers_launches": r_launches.get("threefry_gumbel", 0),
            "chaos_launches": t_launches.get("threefry_gumbel", 0),
            "clock_mhz": nt["clock_mhz"],
        })
        # The restore's CRC kernel has no Pallas counterpart (the JAX
        # package verifies a host block with zlib on the host); its path is
        # phase g's restores.
        kernels.append({
            "name": "crc32_blocks", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/crc32_blocks.cu",
            "replaces": "dynamo_tpu/engine/offload.py:422 (zlib on the host, no Pallas kernel)",
            "launches": tiers["launches"]["crc32_blocks"],
            "max_abs_err": tally.worst["crc32_blocks"],
            "ms": crc_times["ms"], "plain_ms": crc_times["plain_ms"],
            "bound_ms": crc_times["bound_ms"], "bound_by": crc_times["bound_by"],
            "library_ms": None,
            "checks_passed": not any(f.startswith("crc32_blocks") for f in tally.failures),
            "shape": crc_times["shape"],
            "parallel_launches": q_launches.get("crc32_blocks", 0),
            "tp_tiers_launches": r_launches.get("crc32_blocks", 0),
            "chaos_launches": t_launches.get("crc32_blocks", 0),
            "bound_parts_ms": crc_times["bound_parts_ms"],
            "clock_mhz": crc_times["clock_mhz"],
        })
        log(json.dumps({"kernels": kernels}))
        if tally.failures or not ok_model or not ok_path or not ok_http or not all(
                slice_ok.values()):
            log(f"FAILED: kernel checks {tally.failures or 'ok'}; f32 model check "
                f"{'ok' if ok_model else 'failed'}; main path {'ok' if ok_path else 'failed'}; "
                f"HTTP path {'ok' if ok_http else 'failed'}; "
                f"{ {k: 'ok' if v else 'failed' for k, v in slice_ok.items()} }")
            # The phases' own lines, again: the end of stderr names each check.
            for line in _FAILED_LINES[:-1][-30:]:
                print(f"  failed earlier: {line[:600]}", file=sys.stderr, flush=True)
            return 1
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
