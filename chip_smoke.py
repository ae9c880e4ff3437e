#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--out details.json]

These paths run, each with every launch counter set to 0 just
before it and read just after: the paper's int8 DLRM serving (kernels K1-K3),
int8 RWKV6-1.6B chat serving (K1-K4), the main-path resilience campaign
(K1-K3), the ``thresholds`` grid (K2), the paper's overhead benchmarks
(K1, K2 and their unprotected instances), the float DLRM converted to
int8 (K1-K3), int8 Llama-3.2-1B chat serving (K1-K3), the same model
served from the paged KV cache (K1-K3), int8 granite-moe-3b-a800m (MoE)
chat serving (K1-K3), the serving soak (K1-K3), the protection SLO
ladder for Llama-3.2-1B and for granite (K1-K3 and the unprotected
instances of K1 and K2), Llama-3.2-1B served under the observability
layer, the detection-health monitor and adaptive thresholds (K1-K3),
full-width Llama-3.2-1B trained under faults (no kernel of the port: all
six counters read 0), int8 whisper-large-v3, hymba-1.5b,
llava-next-mistral-7b and internlm2-20b chat serving (K1-K3), one path
each, and rwkv6-1.6b, whisper-large-v3, hymba-1.5b, llava-next-mistral-7b
and granite-moe-3b-a800m trained (all six counters 0), one path each,
and the data mesh (all six counters 0): Llama-3.2-1B's deferred and
ZeRO-1 steps over an NCCL world of one, and the ``multidevice`` grid
on 4 gloo ranks sharing the card, one path each, and the model axis:
Llama-3.2-1B's tensor-parallel steps with granite's data-mesh step
(one path, all six counters 0 in every rank), mistral-large-123b and
llama4-scout-17b-a16e served (K1-K3), one path each, and each trained
where the tracker fits it on the card (all six counters 0).
Each phase's seconds are printed.  Phases (any
failure exits non-zero; nothing is caught and passed over):

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build the four CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build times, with
   phase 22d's dry-run subprocess and phase 23a's reckoning on meta
   tensors beside them (both waited for before 3);
3. make the full-width DLRM (26 tables x 4M rows x 128 int8, random
   weights from a seed) on the card and hold each kernel against its
   plain PyTorch version at the main path's shapes and at one larger
   shape: integers bit-exact, floats within the stated tolerance, and a
   flipped weight bit and a flipped high table bit flagged exactly as the
   plain version flags them.  K1 runs every layer in int8 and uint8, with
   and without the column check, plus an aligned RWKV shape split across
   a cluster and an operand off 16-byte alignment; K3 every layer width
   in bf16 (the path's type) and f32.  K1 is launched as the
   programmatic dependent of the kernel before it, so it is also held
   bit-exact right after K3, right after an in-place flip of a B' byte,
   right after another K1 on the same scratch and right after the
   ``correct`` policy's repair.  K2 on one request's bags and on the
   paper's Table I pooling (26 x 2048 bags x 100): R bit-exact with the
   slot-order sum of the plain terms (also for indices past the table),
   rsum within 1e-5 of d x max|R|, flags and counts equal to the plain
   branch at rel_bound 1e-3 and 1e-5 and to K2's formula on its own
   rsum at 1e-3, 1e-5 and 1e-7; each of the 8 bits of a table byte
   flipped, flagged as the plain branch flags it; and, as a programmatic
   dependent, right after an in-place table flip, an alpha change and
   another K2 on the same output allocation and counters;
4. serve 8 ``dlrm_stream`` requests through ``ServingEngine`` under the
   default plan: every request completes, all fault counters are 0, every
   kernel launched; then faults through the engine's ``FaultInjection``:
   a transient flip of ``top.0``'s packed weight, a high bit of a table
   row the request gathers, and a persistent ``top.0`` flip, each flagged
   at its step (the persistent one at every later request) and each
   victim leaf bit-identical afterwards (by fingerprint); the full-width
   logits must be finite, and a small model's forward on the card must
   agree with the plain forward on the CPU (1% of the logit scale, same
   fault counters);
5. count the device operations of one protected EmbeddingBag call by
   the profiler (K2 alone in the card branch, at most 2 with the protect
   layer's sum); time each kernel, its plain version and (for K1)
   ``torch._int_mm`` by CUDA events at the main path's shapes (K2 on
   cold rows and at Table I), next to the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   peak rate; for K2 also with each random scale load a 32-byte sector),
   the time K3 adds in front of K1 (K3 -> K1 against K1 alone over a
   request's layers), and the per-request serve latency; K3 and K4 must
   be handed the path's bf16 activations, with no cast before them;
6. make the full-width RWKV6-1.6B (24 layers, d 2048, 32 heads of 64,
   d_ff 7168, vocab 65536; random int8 weights from a seed) on the card
   and hold K1 and K3 (bit-exact; K3 on bf16 and f32) at its four GEMM
   shapes, K1 under PDL in the four positions of phase 3, K2 on its
   65536 x 2048 token table at 64 and 4 tokens (the checks and PDL
   positions of phase 3, and its time on cold rows beside both bounds),
   and K4 (within 2e-4, and within 2e-4 of the
   per-token recurrence) on the prefill's own bf16 inputs of every layer
   and at batch 1 and 2, dh 64 and 32, chunk 16 and 8, on heavy-decay
   random inputs and on the all-``LOG_W_MIN`` worst case, in bf16 and
   f32, staged by 16- and by 4-byte copies;
7. serve 8 ``chat_stream`` requests (prompt 64, up to 32 new tokens, 4
   slots) under the default plan: every request completes, all fault
   counters are 0, K4 launched 24 times per prefill (the warm-up's
   included); ``FaultInjection`` flips of a ``cm.wv`` payload bit and of
   a high bit of a prompt token's embedding row are each flagged at their
   step and the leaves restored bit for bit; the smoke-size RWKV's
   prefill and 3 decode steps on the card agree with the plain run on
   the CPU at a 64- and at a 24-token prompt (off the WKV chunk grid: K4
   on the first 16 tokens, the recurrence on the rest): the same
   counters; where an activation's int8 codes first differ, a rounding
   split, printed; run free, logits within 1e-4 of their scale up to that
   split (and in bf16 within 2**-4 after it); run in lockstep, the CPU
   taking the card's codes at each rounding split, within 1e-4 at every
   step; and the
   smoke-size engines at a 24-token bucket serve the same requests with
   the same counters on the card and on the CPU;
8. time K4 and its plain version at the prefill shape (r, k, v in bf16
   and f32) and at (4, 4096, 32, 64); K1 at each GEMM shape of a step
   with its weights
   cold (cycling the layers) and warm, beside ``torch._int_mm`` on the
   same cold weights and the byte bound, and under every split count of
   its cluster (the evidence for the plan's rule); K3 at each shape, and
   K3 -> K1 against K1 alone on the same cold weights; the
   prefill and decode steps, and the device-busy and K1 shares of a few
   served requests;
9. run the port's ``quick``, ``pallas`` (quick) and ``paper`` campaign
   grids on the card through K1 and K2 at the JAX grids' sample counts,
   seed 0 (artifacts beside ``--out``); every main-path cell of the
   committed ``BENCH_campaign_pallas_quick.json`` (7) and
   ``BENCH_campaign_quick.json`` (13, the two ``kv_cache`` cells and the
   reduced-Llama ``decode_step`` cell among them: K1-K3 on the card)
   baselines must overlap its baseline by 95% Wilson interval in
   detection and in false positives, and no baseline cell may be left
   out (the differ's coverage regressions: 0); the
   port's differ record against both is printed, with the cells where its
   ``det_tol`` 0.02 verdict disagrees with the Wilson gate; each cell's
   rates, overhead and phase times (CUDA events) are printed; K1 and K2
   are held to their plain versions at every shape the grids hand them
   (K1 bit-exact, clean and with a fault in B'; K2 as in phase 3); and
   every cell that launches K1 or K2, run with the kernels and with its
   plain versions from one seed, must decide every trial alike: the
   GEMM's bit for bit, the EmbeddingBag's but for at most 1% of its
   trials, each within float32 round-off of the bound and shown to be
   K2's own formula on an rsum within round-off of the float64 sum;
10. run the port's ``thresholds`` grid on the card (15 EB cells,
   rel_bound 1e-7 to 1e-3, 400 faulty and 400 clean trials, seed 0) and
   print its tradeoff curve: detection must overlap the committed JAX
   baseline by Wilson interval in every cell, FP at 1e-6 to 1e-3; at 1e-7
   (ROADMAP §C2: round-off decides clean bags) the FP rate is printed
   beside the baseline's and the plain branch's, and every trial is
   replayed through K2 with its flags held bag for bag to K2's own Eq. (5)
   formula on its own rsum;
11. run the paper's overhead benchmarks (``repro_torch.benchmarks``):
   Fig. 5 over the 28 DLRM GEMM shapes (K1, cold and warm, and with the
   encoding, against K1's unprotected instance) and Table I at d 32-256
   on 4M-row tables (K2 against its unprotected instance, fresh indices
   every launch), by CUDA events in alternating rounds; print both tables
   in full; the unprotected instances bit-exact to the protected kernels
   (C's first n columns, R) and to their plain versions, and no median
   overhead below -5%;
12. the full-width float DLRM over phase 3's tables, 8 batches of
   ``SyntheticDLRMDataset``: ``float_gemm`` on, 0 errors clean; a flipped
   exponent bit of a ``top.0`` weight flagged at ``top.0`` and nowhere
   else, and 0 errors once restored; converted by ``quantize_dlrm`` and
   served on the same batches through K1-K3 with 0 errors; the float vs
   int8 CTR gap printed;
13. make the full-width int8 Llama-3.2-1B (16 layers, d 2048, 32 query
   and 8 KV heads of 64, d_ff 8192, vocab 128256; random weights from a
   seed) on the card with two tenants, the default plan (bf16 KV cache)
   and ``*:policy=recompute,kv_cache:on`` (the rowsum-checksummed int8
   cache, verified on every decode read); hold K1 (bit-exact, with and
   without the column check) and K3 (bf16 and f32) at its GEMM shapes,
   the 2048 x 128256 head included (K1's widest n), K1 under PDL in the
   four positions of phase 3, and K2 on its 128256 x 2048 token table at
   64 and 4 tokens as in phase 6, then over every row of the table at
   ``rel_bound`` 1e-5, one pool-1 bag a token: R, rsum and flags
   bit-exact with the plain terms summed in K2's order, and each token K2
   flags (ROADMAP C6) a clean row whose flag float32 round-off in that
   order reaches (its float64 witnesses); serve 8 ``chat_stream`` requests
   (prompt 64, up to 32 new tokens, 4 slots, 100 rps) over both tenants:
   every request completes with 0 errors, the checks and launches are
   the path's own; ``FaultInjection`` flips of an ``attn.wq`` payload bit
   (flagged at its step only, the leaf restored bit for bit) and of an
   int8 KV payload bit of the ``kv_cache:on`` tenant's resident request
   (flagged at the next decode step and at each later one, one error a
   read), and clean requests after; the smoke-size Llama on the card and
   on the CPU, free and in lockstep, as phase 7 holds the smoke RWKV;
   time K1 cold at each shape beside ``torch._int_mm`` and the byte
   bound, K3, and the step medians, with a profile of a few requests;
14. the same full-width Llama-3.2-1B (seed 0) served from the paged,
   prefix-shared, page-checksummed KV cache (``PagingConfig(page_size=16,
   n_pages=26)``; a slot maps (64 + 32 - 1) // 16 + 1 = 6 pages) with two
   tenants, each its own lane and pool, ``*:policy=log,kv_cache_paged:on``
   and ``*:policy=recompute,kv_cache_paged:on``: 8 ``chat_stream``
   requests with a shared 32-token system prompt (2 pages; prompts up to
   64, up to 32 new tokens, 4 slots, 100 rps) complete with 0 errors,
   prefix pages shared, K1-K3 launched at the path's counts, K1 and K3
   bit-exact at every Llama projection at the path's prefill buckets (32,
   48 and 64), fewer pages
   verified per decode token than a contiguous lane verifies rows; the
   pool sizing from ``pool_page_bytes`` (295,936 B a page of both pools,
   7.69 MB for 26, against 8.09 MB for the contiguous ``kv_cache:on``
   cache) and no pool copied by a decode step; four 64-token requests
   through the paged lane and a contiguous ``*:policy=log,kv_cache:on``
   engine, logits within 2**-5 of the scale and greedy tokens equal where
   the top-two margin exceeds twice that; a ``FaultInjection`` page flip
   on the log lane flagged at the next decode step and each later read;
   two on the recompute lane flagged, scrubbed, evicted and rebuilt (0
   aborts, the victim's bit read back from its record).  The detecting
   step reads the corrupt page under a forced log rule and keeps its
   token (the repair follows the step, as in JAX): after a flip of bit
   <= 2, which moves no token there, the rebuilt request's logits are
   held to its clean pass's at every step; after a sign-bit flip, from
   the first step after the repair wherever the detecting step's token
   left the history the clean pass's; clean
   requests after; the paged step medians beside phase 13's, the four
   64-token requests' decode medians through the paged log lane and the
   contiguous engine in turns, one ``scrub_cache`` and one rebuild in
   ms; and the ``paging`` quick grid
   (seed 0) on the card: all four booleans true, detection and FP inside
   the JAX baseline's Wilson intervals in both cells, 0 regressions from
   the port's differ, its pages verified per token and KV bytes printed
   beside the baseline's;
15. make the full-width int8 granite-moe-3b-a800m (16 of its 32 layers,
   for time; d 1536, 24 query and 8 KV heads of 64, 40 experts of width
   512, top-8, vocab 49155; random weights from seed 0; its int8 bytes
   held to the config's reckoning, 2.07 GB at this depth, 3.99 GB at
   all 32) with the default plan's bf16-cache
   tenant and a ``*:policy=recompute,kv_cache:on`` tenant; hold K3 over
   all 40 experts' rows and K1 (the expert stack of one launch an
   expert, single experts with and without the column check, a flipped
   weight) bit-exact, and K1's s8 unprotected instance equal to the
   exact product, at the expert shapes m 4 and 16, (k, n) (1536, 512)
   and (512, 1536), K1 and K3 at the attention projections (m 64 and 4)
   and the head (m 1 and 4), and K2 on the 49408 x 1536 token table at
   64 and 4 tokens and over every row, as phase 13 holds Llama's; serve
   8 ``chat_stream`` requests (64-token bucket,
   up to 32 new tokens, 4 slots, 100 rps) with 0 errors and K1 launched
   16 x (4 + 3 x 40) + 1 = 1,985 times a step; a ``moe.gate`` expert-
   weight flip flagged at its step only (the flipped expert printed, and
   whether a token chose it there) and a KV payload flip on the
   ``kv_cache:on`` lane flagged at the next decode; the smoke-size
   granite on the card and on the CPU, free and in lockstep, as phase 13
   holds the Llama, except that a free run is held to 1e-4 only up to
   its first int8 code split (a moved code can move a token's experts)
   and to equal counters and finite logits after it; K1 cold per expert shape beside its s8 unprotected
   instance, padded ``torch._int_mm`` and the byte bound; the step
   medians per lane and a profile's kernels a step and busy share;
16. run the ``serving_soak`` quick grid on the card (reduced Llama, two
   tenants, 200 requests a cell at 200 rps, clean and faulty passes):
   detection 1/1 and 0 escapes in both cells, detection, escape and FP
   inside the committed JAX baseline's Wilson intervals
   (``src/repro_torch/campaign/baselines/``) and 0 regressions from the
   port's differ; then the protection SLO ladder
   (``repro_torch.benchmarks.serving_slo``: ``*:off``, ``*:policy=log``,
   ``*:policy=recompute,kv_cache:on`` over one stream of 12 requests at
   300 rps, Poisson, 4 slots, 16 new tokens) at full width for
   Llama-3.2-1B and granite (granite at 8 of its 32 layers, for time):
   every request completes with 0 errors but
   the EmbeddingBag flags of clean token rows, each a token the table
   scan of phase 13 or 15 flagged and witnessed again alone; each rung's
   counts are set to 0 before it and read right after its run (the
   ladder's are their sum); the
   unprotected rung launches K1's and K2's unprotected instances and no
   protected kernel, and its device operations (by the profiler, one
   request) hold no float64 GEMM; p50/p95/p99 TTFT, per-token latency
   and throughput of each rung and each protected rung's p99 over the
   unprotected rung's are printed with the card's name and power limit;
17. observability, monitor and adaptive thresholds: phase 13's
   full-width Llama-3.2-1B weights served under
   ``*:policy=log,embedding_bag:threshold=adaptive`` with
   ``Observability``, ``Monitor()`` and
   ``AdaptiveThresholds(ControllerConfig(fp_budget=0.01))``: 24 requests
   all at t = 0, one tenant, 4 slots, the 64-token bucket, up to 16 new
   tokens, ``mlp.down`` flips at steps 4, 5 and 6, each flagged at its
   step; ``detection-burst`` fires and resolves, the tenant walks to
   ``quarantined`` and back to ``healthy``, the engine's ``escalate``,
   ``quarantine`` and ``recover`` actions occur, all 24 complete; the
   four obs artifacts (under ``--out``'s ``obs/``) read back, every
   event validated, ``replay`` equal to the live registry's
   fault-pipeline lines, the trace loaded as Chrome-trace JSON; a second
   monitored run whose controller moves the EmbeddingBag bound to its
   floor 1e-6 (the lane's plan held to it); the same stream with no
   flip, 2 plain and 2 monitored runs in turns, every run on a new
   engine, both step medians printed; device-to-host copies of a short
   stream equal with and without obs, monitor and adapt (profiler); the
   monitor's per-tick fold under 5% of a step, and
   ``repro_torch.benchmarks.monitor_overhead`` under 5%; ``--grid
   adaptive --quick`` on the card (JAX's draws): every cell's gates,
   every count equal to the CPU run on the same draws, detection inside
   the JAX CLI's artifact's and the committed baseline's Wilson
   intervals, the differ against the JAX CLI's artifact with 0
   regressions; ``--trend`` over the committed quick
   history with phase 9's card artifact newest, rc 0; the path's K1, K2
   and K3 launches and the controllers' summaries.

18. training under faults: full-width Llama-3.2-1B from seed 0 with
   float32 master weights, bf16 compute, 4 accumulated microbatches of 2
   x 256 tokens, the int8 error-feedback gradient reduction checked mod
   8191 and ``TrainLoop(fault_policy="recompute")`` under deterministic
   algorithms: 6 clean steps (every loss finite, ``comm/errors`` 0 at
   every step; the state's reckoned bytes beside the peak allocation,
   step times, tokens/s and one profiled step's kernels and busy share);
   the loop's final checksummed checkpoint of the whole state (the free
   disk printed, a temporary directory) restored and verified on the
   card, equal leaf for leaf, with its save and restore seconds; the
   same run (writing no checkpoint) with one byte of the ``mlp``
   victim's int8 payload flipped
   between the encode and the reduction at step 3: ``comm/errors`` 1 at
   that call, one faulty step and one recompute, final parameters equal
   to the clean run's bit for bit; what deterministic algorithms cost a
   step (steps in turns); ``--grid training --quick`` on the card gated
   against the JAX CLI's artifact and the baseline (Wilson overlap in
   every cell, the differ flagging no FP rate, lost cell or checked
   seam, the int8 payload caught at latency 0 in every trial, no flag
   outside the checksum, the post-verify gradient diverging);
19. ROADMAP A7's families at full width, one at a time, each model and
   its lanes freed before the next (internlm2 last): whisper-large-v3
   (32 + 32 layers, d 1280, 1500 stub frames), hymba-1.5b (16 of its 32
   layers, for time; d 1600, Mamba heads beside attention, 128 meta
   tokens), llava-next-mistral-7b (16 of 32 layers, d 4096, 576 stub
   patches through the projector) and internlm2-20b (24 of 48 layers,
   d 6144, 10.7 GB), int8 from seed
   0: the reckoned bytes beside the build's peak (which must stay under
   a second stack of the layers); K1 (C, err_rows, the column check) and
   K3 bit-exact at every projection shape at the prefill's m and a
   decode step's 4 (whisper's encoder at 1500 rows, llava's projector at
   576), and 64 repeated K1 calls where K is not a whole number of 128-
   row stages (hymba's 1600); K2 at the token table at 64 and 4 tokens,
   then over every row with phase 13's witnesses, and its team passes a
   row; 4 requests at t = 0 on a bf16-cache and a ``*:policy=recompute,
   kv_cache:on`` tenant (64-token bucket, 16 new tokens): 0 errors but
   the scan's witnessed tokens, K1/K2/K3 launches equal to the count
   reckoned from the code, K4 and the unprotected instances 0, step
   medians and one profiled decode step; a weight flip (whisper's
   decoder ``mlp.down``, hymba's ``ssm.out_proj``, llava's
   ``projector.fc1`` at a prefill, internlm2's ``attn.wq``) flagged at
   its step and restored; the reduced model card against CPU, free and
   in lockstep (hymba with a third, windowed layer);
20. training of the other families, phase 3's DLRM freed first: rwkv6-
   1.6b, whisper-large-v3, hymba-1.5b, llava-next-mistral-7b and
   granite-moe-3b-a800m, one at a time, at full width as the train CLI
   trains them (float32 master weights, bf16 compute, 8 sequences of
   256 text tokens plus hymba's 128 meta tokens, llava's 576 stub
   patches and whisper's 1500 stub frames, each config's
   ``train_accum`` (granite 16 sequences for its 16), ``compress=True``,
   ``TrainLoop(fault_policy="recompute")``, deterministic algorithms),
   2 steps each and granite 3, at their depths in ``DEPTH`` (llava at
   7 of 32 layers, the depth that fits ~72 GiB: two states, the
   gradient sum and the activations; the others cut for time); every
   loss finite, ``comm/errors`` 0; the
   state's reckoned bytes beside the peak allocation, step times, text
   tokens/s, one profiled step's device operations and busy share; the
   reduced model's loss and every gradient leaf card against CPU in
   float32 and bf16 compute; granite again with one byte of its
   ``moe.gate`` expert stack's int8 payload flipped in transit at step
   2: ``comm/errors`` 1 there, one recompute, final parameters equal to
   the clean run's bit for bit; all six launch counters 0 on each path;
21. the data mesh: full-width Llama-3.2-1B at phase 18's depth, 8 x 256
   tokens in its 4 microbatches, deterministic algorithms, over an NCCL
   world of one rank (this process): the deferred step with the checked
   int8 reduction over the group, 2 steps in ``TrainLoop``, equal bit
   for bit to ``make_train_step(compress=True)`` from the same state
   and batches (parameters and ``comm/errors``), its step ms and a
   profiled step's busy share; the same loop with rank 0's payload
   flipped in transit at the second step (``comm/errors`` 1 there, one
   recompute, parameters equal bit for bit); the ZeRO-1 step, 2 steps,
   its peak against the reckoned bf16 parameters and three flat float32
   vectors, and the reduced model's ZeRO-1 steps card against CPU; then
   ``--grid multidevice --quick`` on 4 gloo ranks sharing the card
   (launched once), gated against both JAX artifacts (Wilson overlap in
   every cell, the differ) with its acceptance cell attributed to shard
   0, each rank's memory; all six launch counters 0 on each path (in
   every rank).
22. the dry run against the card: phase 18's step and phase 21's ZeRO-1
   step reckoned on meta tensors over a world of one by the cost counter
   and its memory tracker (``repro_torch.launch.costs``), each predicted
   peak within 15% of the phase's measured ``max_memory_allocated`` and
   each roofline bound at most the measured step; the ABFT
   implementation roofline's bound for the unprotected instance and K1
   at most phase 11's measured time at each of Fig. 5's 28 shapes;
   ``python -m repro_torch.launch.dryrun --arch mistral-large-123b
   --shape decode_32k`` run as a subprocess on this machine's PyTorch
   beside phase 2's build (the one stretch that times no launches, so
   no timed phase shares the host with it), ending ``ok``, its
   per-device argument bytes and peak printed against the card's
   memory; no kernel launched (meta tensors take the plain versions).
23. the model axis: (a) full-width Llama-3.2-1B at its depth in
   ``DEPTH``, the train CLI's context (``train_rules``, bf16, layer
   remat), trained by the model-mesh step on a (1, 2) and a (2, 2) mesh
   of gloo ranks sharing the card (launched once), 2 steps each on
   phase 18's global batch, held against the one-device step from the
   same state (losses within ``loss_tolerance``, the update within
   ``adam_step_tolerance`` with at most 5% of it more than lr / 100
   apart); per rank the step ms, the collectives' share of it and the
   peak beside the dry run's tracker's prediction (reckoned in this
   process while the ranks run); (b) granite-moe on a data mesh of 2,
   float32: its loss equal to the one-device loss on the global batch
   within ``loss_tolerance`` (ROADMAP §C17), the mean of the halves'
   losses beside it; (c) mistral-large-123b and llama4-scout-17b-a16e
   built at full width at their depths in ``DEPTH`` (bytes equal to the
   reckoning), 2 chat requests served with no error, K1 and K3 bit for
   bit against their plain versions at every shape the serve handed
   them, K2 on the token table; (d) both trained at full width at the
   depth whose reckoned peak (the tracker, on meta tensors) stays under
   70 GiB, the measured peak within 15% of it, or, where no depth fits,
   the reckoned bytes printed; no kernel of the port on (a), (b) and
   (d).

The line before the last is ``{"kernels": [...]}``: K1-K4 and the two
unprotected instances; ``launches`` is the count of the kernel's own path
(DLRM for K1-K3, RWKV for K4, the overhead benchmarks for the unprotected
instances), and ``launches_by_path`` holds every kernel's count on each
of the paths (DLRM serve, RWKV serve, campaign, thresholds, overhead,
float DLRM, Llama serve, Llama paged serve, granite serve, serving soak,
the SLO ladder of each model, observability, training, whisper, hymba,
llava, internlm2, the training of rwkv6, whisper, hymba, llava and
granite, the mesh's deferred step, ZeRO-1 step and multidevice
grid, the dry run, the tensor-parallel steps, and the two large
configs' serving and training),
all six counts set to 0
just before each path and read just after.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the repository's ``src/`` beside this
file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS reads it when CUDA initialises: phase 18 trains under
# torch.use_deterministic_algorithms, whose GEMMs need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent

# the pl.pallas_call of each TPU kernel
REPLACES = {
    "abft_qgemm": "src/repro/kernels/abft_qgemm.py:237",
    "abft_embeddingbag": "src/repro/kernels/abft_embeddingbag.py:67",
    "quantize_rows": "src/repro/kernels/quantize_rows.py:42",
    "wkv6_chunked": "src/repro/kernels/wkv6_chunked.py:99",
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"[chip_smoke] FAILED: {msg}")


def all_wrappers() -> dict:
    """Every kernel's wrapper, by name: K1-K4 and the two unprotected
    instances the overhead benchmarks time."""
    from repro_torch.kernels.abft_embeddingbag import (abft_eb_cuda,
                                                       eb_unprotected_cuda)
    from repro_torch.kernels.abft_qgemm import (abft_qgemm_cuda,
                                                 qgemm_unprotected_cuda)
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked_cuda
    return {"abft_qgemm": abft_qgemm_cuda,
            "abft_embeddingbag": abft_eb_cuda,
            "quantize_rows": quantize_rows_cuda,
            "wkv6_chunked": wkv6_chunked_cuda,
            "qgemm_unprotected": qgemm_unprotected_cuda,
            "eb_unprotected": eb_unprotected_cuda}


def zero_launches() -> dict:
    """:func:`all_wrappers` with every launch count set to 0: called just
    before a path is driven."""
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def read_launches(wrappers: dict) -> dict:
    """The launch count of each of ``wrappers`` (:func:`zero_launches`'
    result), read just after the path."""
    return {k: w.launches for k, w in wrappers.items()}


def profile_requests(torch, engine, requests) -> dict:
    """Where a request's time goes: device time by kernel over a few served
    requests, against the requests' own wall time (the engine's step
    durations, so the profiler's start and stop are not counted).  A
    diagnostic only: where the profiler cannot trace the card it says so
    and the run goes on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tel = engine.run(requests, warmup=False)
            torch.cuda.synchronize()
        wall_ms = sum(ev.duration_s for ev in tel.steps) * 1e3
        n_steps = len(tel.steps)
        by_name = {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue                # CPU ops; their kernels are listed
            t_us = getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0))
            if t_us > 0:
                by_name[ev.key] = (t_us / 1e3, ev.count)
    except Exception as e:              # noqa: BLE001 - diagnostic only
        log(f"profiler could not trace the card: {e!r}")
        return {"error": repr(e)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    device_ms = sum(t for t, _ in by_name.values())
    k1_ms = sum(t for k, (t, _) in by_name.items() if "abft_qgemm_kernel" in k)
    ours = {name: [sum(v[i] for k, v in by_name.items() if name in k)
                   for i in (0, 1)]
            for name in ("abft_qgemm_kernel", "abft_eb_kernel",
                         "quantize_rows_kernel", "wkv6_chunked_kernel")}
    out = {"requests": len(requests), "wall_ms": wall_ms,
           "device_ms": device_ms,
           "busy_share": device_ms / wall_ms if wall_ms else None,
           "k1_ms": k1_ms,
           "k1_share": k1_ms / device_ms if device_ms else None,
           "kernels_per_request": sum(c for _, c in by_name.values())
           / len(requests),
           "steps": n_steps,
           "kernels_per_step": sum(c for _, c in by_name.values())
           / max(n_steps, 1),
           "ours_ms_and_count": ours,
           "top": [{"name": k, "ms": t, "count": c} for k, (t, c) in top]}
    log(f"profile of {len(requests)} requests: device {device_ms:.3f} ms of "
        f"{wall_ms:.3f} ms of request wall time, K1 {k1_ms:.3f} ms of it; "
        f"top: "
        + "; ".join(f"{k[:48]} {t:.3f}ms x{c}" for k, (t, c) in top[:8]))
    return out


def check_outputs(torch, dev, params, ex, requests) -> dict:
    """What comes out is right: the full-width logits of a request are
    finite and shaped [batch]; and on a small model (the ``serve --smoke``
    widths) the card's forward — every kernel — agrees with the plain
    PyTorch forward on the CPU on the same weights and request, with
    identical fault counters.  Tolerance: 1% of the logit scale, in bf16;
    only float summation orders differ (the EmbeddingBag's, the Gram
    product's), and a bf16 step is 2**-8 relative."""
    import dataclasses
    import functools

    import numpy as np

    from repro_torch.core.policy import metrics_to_ints
    from repro_torch.models.dlrm import dlrm_forward, init_dlrm
    from repro_torch.protect import default_plan, protect

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    payload = requests[0].payload
    fwd = protect(functools.partial(dlrm_forward, ex=ex), default_plan())
    logit, _ = fwd(params, torch.from_numpy(payload["dense"]).to(dev),
                   torch.from_numpy(payload["bags"]).to(dev))
    if logit.shape != (payload["dense"].shape[0],) or \
            not bool(torch.isfinite(logit).all()):
        fail(f"full-width logits: shape {tuple(logit.shape)}, finite "
             f"{bool(torch.isfinite(logit).all())}")

    small = dataclasses.replace(ex, table_rows=512, n_tables=4, emb_dim=32,
                                bottom_mlp=(64, 32), top_mlp=(64, 32, 1))
    p_cpu = init_dlrm(0, small, device="cpu")
    rng = np.random.default_rng(13)
    dense = torch.from_numpy(
        rng.standard_normal((10, small.n_dense)).astype(np.float32))
    bags = torch.from_numpy(rng.integers(-1, small.table_rows,
                                         (small.n_tables, 10, 16))
                            .astype(np.int32))
    fwd_s = protect(functools.partial(dlrm_forward, ex=small),
                    default_plan())
    l_cpu, r_cpu = fwd_s(p_cpu, dense, bags)
    l_dev, r_dev = fwd_s(to(p_cpu, dev), dense.to(dev), bags.to(dev))
    m_cpu = metrics_to_ints(r_cpu.as_metrics())
    m_dev = metrics_to_ints(r_dev.as_metrics())
    l_cpu = l_cpu.float()
    err = float((l_dev.float().cpu() - l_cpu).abs().max())
    scale = float(l_cpu.abs().max())
    log(f"outputs: full-width logits finite, shape {tuple(logit.shape)}; "
        f"small model card vs CPU max |dlogit| {err:.3g} of scale "
        f"{scale:.3g}; counters equal {m_cpu == m_dev}")
    if m_cpu != m_dev:
        fail(f"small model counters differ: card {m_dev} vs CPU {m_cpu}")
    if err > 1e-2 * max(scale, 1e-6):
        fail(f"small model logits differ by {err:.3g} (scale {scale:.3g})")
    return {"full_width_logits": [float(v) for v in logit.float().cpu()],
            "small_max_abs_err": err, "small_scale": scale}


def check_gemms(torch, dev, gen, gemms) -> list:
    """K3 (bf16 and its f32 cast) and K1 (with and without the column
    check) bit-exact against their plain versions on random rows at each
    ``(name, stacked weights [layers, k, n + 128], ms)`` entry, clean
    operands unflagged; returns one line a shape naming its launch plans."""
    from repro_torch.core import LANE
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda, launch_plan
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda

    checked = []
    for name, stack, ms_ in gemms:
        bp = stack[0]
        k, n = bp.shape[0], bp.shape[1] - LANE
        plans = [launch_plan(m, k, n, a_addr=0, b_addr=bp.data_ptr())
                 for m in ms_]
        checked.append(f"{name} (k, n) = ({k}, {n}) at m = {ms_} (bm "
                       f"{[p.bm for p in plans]}, splits "
                       f"{[p.splits for p in plans]}, blocks "
                       f"{[p.blocks for p in plans]})")
        for m in ms_:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            q = quantize_rows_cuda(x)
            for g, w, g32, what in zip(q, ref.quantize_rows_ref(x),
                                       quantize_rows_cuda(x.float()),
                                       ("q", "alpha", "beta")):
                if not (torch.equal(g, w) and torch.equal(g32, w)):
                    fail(f"quantize_rows: {what} differs at {m}x{k} (bf16 "
                         f"or its f32 cast)")
            for col in (False, True):
                got = abft_qgemm_cuda(q[0], bp, with_colcheck=col)
                want = ref.abft_qgemm_ref(q[0], bp, with_colcheck=col)
                for g, w, what in zip(got, want,
                                      ("C", "err_rows", "col_check")):
                    if not torch.equal(g, w):
                        fail(f"abft_qgemm: {what} differs at {name} m={m} "
                             f"(k={k}, n={n})")
                if int(got[1].sum()):
                    fail(f"abft_qgemm flagged clean operands at {name}")
    return checked


def wkv_err(got, want, atol: float, rtol: float = 2e-4):
    """(max |got - want|, worst ratio of |got - want| to the allowed
    ``atol + rtol |want|``; <= 1 passes)."""
    diff = (got - want).abs()
    return (float(diff.max()),
            float((diff / (atol + rtol * want.abs())).max()))


#: two runs' inputs to one quantization "agree" within this fraction of
#: the row's largest magnitude (phase 7's logit fraction) or one unit in
#: the last place of the element, whichever is larger
SPLIT_INPUT_TOL = 1e-4


def code_split(torch, cpu_calls, card_calls):
    """The first activation quantization whose int8 codes differ between a
    CPU run and a card run of the same model, or None.  Each list holds
    ``[x, q, alpha, beta]`` per call, in call order.  At the elements whose
    codes differ it reports: the largest code step; whether each side's
    pre-quantization value ``u = (x - beta) / alpha`` (float64) lies on its
    own side of the rounding boundary between the two codes, up to 1e-3 of
    a step (``straddle``); the largest input difference as a share of the
    row's largest magnitude, and whether every input pair agrees within
    :data:`SPLIT_INPUT_TOL` of it or one ulp of the element.  Up to four
    of those elements are listed with each side's x, u and code."""
    if len(cpu_calls) != len(card_calls):
        fail(f"the CPU and the card quantized {len(cpu_calls)} and "
             f"{len(card_calls)} activations in one step")
    for i, (c, d) in enumerate(zip(cpu_calls, card_calls)):
        if torch.equal(c[1], d[1]):
            continue
        (xc, qc, ac, bc), (xd, qd, ad, bd) = c, d
        where = qc != qd
        x64c, x64d = xc.double(), xd.double()
        uc = (x64c - bc.double()[:, None]) / ac.double()[:, None]
        ud = (x64d - bd.double()[:, None]) / ad.double()[:, None]
        edge = torch.minimum(qc, qd).double() + 0.5
        straddle = (torch.minimum(uc, ud) <= edge + 1e-3) & \
            (torch.maximum(uc, ud) >= edge - 1e-3)
        row = torch.maximum(x64c.abs().amax(1), x64d.abs().amax(1))[:, None]
        dx = (x64c - x64d).abs()
        mant = {torch.bfloat16: 7, torch.float16: 10}.get(xc.dtype, 23)
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(x64c.abs(), x64d.abs()).clamp(min=1e-30))) - mant)
        agree = dx <= torch.maximum(SPLIT_INPUT_TOL * row, ulp)
        elems = [{"row": r, "col": col, "x_cpu": float(xc[r, col]),
                  "x_card": float(xd[r, col]), "u_cpu": float(uc[r, col]),
                  "u_card": float(ud[r, col]), "q_cpu": int(qc[r, col]),
                  "q_card": int(qd[r, col])}
                 for r, col in where.nonzero().tolist()[:4]]
        return {"call": i, "shape": list(xc.shape),
                "dtype": str(xc.dtype).replace("torch.", ""),
                "codes_differ": int(where.sum()),
                "max_code_step": int((qc.long() - qd.long()).abs().max()),
                "straddle": bool(straddle[where].all()),
                "inputs_agree": bool(agree[where].all()),
                "max_input_diff_of_row_where_codes_differ": float(
                    (dx / row.clamp(min=1e-30))[where].max()),
                "max_input_diff_of_row": float(
                    (dx / row.clamp(min=1e-30)).max()),
                "alpha_equal": torch.equal(ac, ad),
                "beta_equal": torch.equal(bc, bd), "elements": elems}
    return None


def code_split_is_rounding(split) -> bool:
    """A split of the int8 codes that round-off explains: no code more than
    one step from the other side's, each side's pre-quantization value on
    its own side of the boundary between them, and the inputs in
    agreement wherever the codes differ."""
    return split["max_code_step"] <= 1 and split["straddle"] and \
        split["inputs_agree"]


def wkv_bound(b, s, h, dh, chunk, itemsize=4):
    """Bytes and float operations the chunked WKV6 forward needs: r, k,
    v (``itemsize`` bytes each), lw and u read and y written once, the
    state read and written once; per chunk and head the four products
    (the score tile and its product only below the diagonal), the decay
    of S and the diagonal."""
    n_bytes = (b * s * h * dh * (3 * itemsize + 8)
               + 4 * (h * dh + 2 * b * h * dh * dh))
    tri = chunk * (chunk - 1) // 2
    per_chunk = (2 * chunk * dh * dh * 2 + 2 * tri * dh * 2
                 + 2 * dh * dh + 3 * chunk * dh)
    return n_bytes, b * h * (s // chunk) * per_chunk


def kernel_input_dtypes(run):
    """``run()`` with the K3 and K4 wrappers watched: the types of the x
    (K3) and of the r, k, v (K4) each was handed.  A cast before either
    kernel would show as float32 here.  Returns ``(run's result, {name:
    [dtypes]})``."""
    import repro_torch.kernels.quantize_rows as k3
    import repro_torch.kernels.wkv6_chunked as k4
    real = {"quantize_rows": k3.quantize_rows_cuda,
            "wkv6_chunked": k4.wkv6_chunked_cuda}
    seen = {name: set() for name in real}

    def watch(name, n_args):
        def call(*a, **kw):
            seen[name].add(tuple(str(t.dtype).replace("torch.", "")
                                 for t in a[:n_args]))
            return real[name](*a, **kw)
        # the wrapper counts its launch under its module-level name, which
        # is this function while it watches
        call.launches = 0
        return call

    k3.quantize_rows_cuda = watch("quantize_rows", 1)
    k4.wkv6_chunked_cuda = watch("wkv6_chunked", 3)
    try:
        out = run()
    finally:
        k3.quantize_rows_cuda = real["quantize_rows"]
        k4.wkv6_chunked_cuda = real["wkv6_chunked"]
    return out, {name: sorted(v) for name, v in seen.items()}


def pdl_hazards(torch, dev, gen, cases) -> list:
    """K1 is launched as the programmatic dependent of whatever kernel
    comes before it.  Hold it bit-exact with its plain version (C and
    err_rows) in the four positions where that kernel touches what K1
    reads or writes: right after K3 (which writes A); right after an
    in-place flip of a B' byte and the flip back; right after another K1
    on the same row-sum scratch (as ``recompute`` runs it), alternating
    flagged and clean calls; and right after the ``correct`` policy's
    repair, which must give back the clean C.  ``cases`` are (label, m,
    B') at the path's shapes; each position queues its launches with no
    synchronisation between them, and the comparisons come after."""
    from repro_torch.core import LANE
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.protect.plan import ResolvedRule
    from repro_torch.protect.runtime import protected_call

    def flags(got, a, bp, what):
        for g, w, part in zip(got, ref.abft_qgemm_ref(a, bp),
                              ("C", "err_rows")):
            if not torch.equal(g, w):
                fail(f"K1 under PDL {what}: {part} differs from the plain "
                     f"version")
        return int(got[1].sum())

    def i8(m, k):
        return torch.randint(-128, 128, (m, k), generator=gen,
                             device=dev).to(torch.int8)

    done = []
    for label, m, bp in cases:
        k, n = bp.shape[0], bp.shape[1] - LANE
        row, lane = k // 3, n // 2
        hot, cold = i8(m, k), i8(m, k)
        hot[:, row] = 1                 # a flip in B'[row] shows in every
        cold[:, row] = 0                # row of C, and in none
        b_clean = bp.clone()            # B' as each launch finds it
        b_flip = bp.clone()
        b_flip[row, lane] ^= 0x10
        colsum = torch.sum(b_clean[:, :n].to(torch.int32), dim=0,
                           dtype=torch.int32)
        xs = [torch.randn((m, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(3)]
        torch.cuda.synchronize()
        # 1. K3 -> K1, three times over
        after_k3 = []
        for x in xs:
            q = quantize_rows_cuda(x)[0]
            after_k3.append((q, abft_qgemm_cuda(q, bp)))
        # 2. an in-place flip of a B' byte, K1; the flip back, K1
        bp[row, lane] ^= 0x10
        flipped = abft_qgemm_cuda(hot, bp)
        bp[row, lane] ^= 0x10
        restored = abft_qgemm_cuda(hot, bp)
        # 3. K1 after K1 on the one scratch, flagged and clean in turns
        bp[row, lane] ^= 0x10
        chain = [(a, abft_qgemm_cuda(a, bp)) for a in (hot, cold) * 3]
        # 4. the correct policy repairs C for the flipped B'; K1 at once
        fixed, rep = protected_call("qgemm", (bp, colsum), hot,
                                    rule=ResolvedRule(policy="correct"))
        after_fix = abft_qgemm_cuda(cold, bp)
        bp[row, lane] ^= 0x10
        torch.cuda.synchronize()

        for x, (q, got) in zip(xs, after_k3):
            if not torch.equal(q, ref.quantize_rows_ref(x.float())[0]):
                fail(f"K3 on bf16 differs from the plain version at {label}")
            if flags(got, q, b_clean, f"after K3 at {label}"):
                fail(f"K1 after K3 flagged clean operands at {label}")
        if flags(flipped, hot, b_flip, f"after a flip at {label}") != m or \
                flags(restored, hot, b_clean, f"after the flip back at "
                                              f"{label}"):
            fail(f"K1 right after an in-place flip of B' at {label} did not "
                 f"flag exactly the flipped byte's rows")
        for a, got in chain:
            if flags(got, a, b_flip, f"after K1 at {label}") != \
                    (m if a is hot else 0):
                fail(f"K1 after K1 on one scratch at {label}: wrong flags")
        if flags(after_fix, cold, b_flip, f"after the repair at {label}"):
            fail(f"K1 after the correct repair flagged at {label}")
        if not torch.equal(fixed, ref.abft_qgemm_ref(hot, b_clean)[0]) or \
                int(rep.corrections) != 1:
            fail(f"the correct policy did not repair the flip at {label}")
        if not torch.equal(bp, b_clean):
            fail(f"B' was not restored at {label}")
        del b_clean, b_flip
        done.append(label)
    return done


def eb_checks(torch, enc, bags, label: str) -> dict:
    """K2 against its plain versions on one index set of the stacked tables
    ``enc`` = (table, alphas, betas, C_T): R bit-exact with the slot-order
    sum of the plain terms; rsum within 1e-5 of d x max|R| of the plain
    rsum (another order over d); flags and counts equal to K2's formula
    written plainly (``ref.eb_check_slot_order``) on K2's own rsum at
    rel_bound 1e-3, 1e-5 and 1e-7, and to the plain branch (``verify_bags``)
    at 1e-3 and 1e-5, where no clean bag may be flagged.  At 1e-7 the bound
    is about an ulp of a bag's magnitude, so round-off decides some clean
    bags in any order: how many the plain branch decides otherwise is
    reported, not held."""
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    table, al, be, rs = enc
    d = table.shape[-1]
    want_r = ref.abft_eb_slot_order_ref(table, al, be, bags)
    _, rsum_p = ref.abft_eb_ref(table, al, be, bags)
    scale = max(1.0, float(want_r.abs().max()))
    out = {"rsum_max_abs_err": 0.0}
    for rel in (1e-3, 1e-5, 1e-7):
        r, rsum, flags, count = abft_eb_cuda(table, al, be, bags, rs,
                                             rel_bound=rel)
        if not torch.equal(r, want_r):
            fail(f"abft_embeddingbag: R differs from the slot-order sum at "
                 f"{label} ({int((r != want_r).sum())} elements)")
        e_s = float((rsum - rsum_p).abs().max())
        if e_s > 1e-5 * d * scale:
            fail(f"abft_embeddingbag: rsum off by {e_s:.3g} at {label}")
        out["rsum_max_abs_err"] = max(out["rsum_max_abs_err"], e_s)
        mirror = ref.eb_check_slot_order(rsum, al, be, bags, rs, d,
                                         rel_bound=rel)
        if not torch.equal(flags, mirror) or not torch.equal(
                count, flags.sum(-1, dtype=torch.int32)):
            fail(f"abft_embeddingbag: flags or counts differ from its "
                 f"formula on its own rsum at {label}, rel_bound {rel:g}")
        plain = kops.abft_embedding_bag(table, al, be, bags, rs,
                                        rel_bound=rel, use_kernel=False)
        if rel == 1e-7:
            out["flagged_at_1e-7"] = int(flags.sum())
            out["plain_branch_differs_at_1e-7"] = int(
                (flags != plain.err_bags).sum())
            continue
        if not (torch.equal(flags, plain.err_bags)
                and torch.equal(count, plain.err_count)):
            fail(f"abft_embeddingbag: flags differ from the plain branch at "
                 f"{label}, rel_bound {rel:g}")
        if bool(flags.any()):
            fail(f"abft_embeddingbag flagged clean tables at {label}")
    return out


def eb_flip_sweep(torch, enc, bags) -> list:
    """One bit of a table byte that bag 0 of table 0 reads flipped (C_T
    left stale), each of the 8 positions in turn: the card branch's flags
    and counts equal to the plain branch's at rel_bound 1e-3 and 1e-5.
    Returns the bags flagged per bit at 1e-5."""
    from repro_torch.core import table_rowsums
    from repro_torch.kernels import ops as kops
    table, al, be, rs = enc
    row, col = int(bags[0, 0, 0]), 5
    flagged = []
    for bit in range(8):
        mask = -128 if bit == 7 else 1 << bit
        table[0, row, col] ^= mask
        for rel in (1e-3, 1e-5):
            got, want = (kops.abft_embedding_bag(table, al, be, bags, rs,
                                                 rel_bound=rel, use_kernel=uk)
                         for uk in (True, False))
            if not (torch.equal(got.err_bags, want.err_bags)
                    and torch.equal(got.err_count, want.err_count)):
                fail(f"abft_embeddingbag: flags differ from the plain branch "
                     f"with bit {bit} flipped, rel_bound {rel:g}")
        flagged.append(int(got.err_count.sum()))
        table[0, row, col] ^= mask
    if not flagged[7]:
        fail("abft_embeddingbag missed a flipped high table bit")
    if not torch.equal(table_rowsums(table[0, row]), rs[0, row]):
        fail("the flipped table row was not restored")
    return flagged


def eb_pdl_hazards(torch, enc, bags) -> None:
    """K2 is launched as the programmatic dependent of whatever kernel
    comes before it.  Held with no synchronisation between that kernel and
    K2, in the three positions where it writes what K2 reads or writes:
    right after an in-place flip of a table byte (a torch kernel) and the
    flip back; right after an in-place change of a row's alpha and the
    change back; and right after another K2 whose R and rsum were freed,
    so the allocator hands their memory over, on the same counters, bags
    that read the flipped row and bags that do not in turns."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    table, al, be, rs = enc
    row = int(bags[0, 0, 0])
    cold = torch.where(bags == row, (row + 1) % table.shape[1], bags)
    torch.cuda.synchronize()
    table[0, row, 9] ^= -128
    flipped = abft_eb_cuda(table, al, be, bags, rs)
    table[0, row, 9] ^= -128
    restored = abft_eb_cuda(table, al, be, bags, rs)
    al[0, row] *= 4.0
    scaled = abft_eb_cuda(table, al, be, bags, rs)
    al[0, row] *= 0.25                                # exact: back
    after_alpha = abft_eb_cuda(table, al, be, bags, rs)
    table[0, row, 9] ^= -128
    chain, ptrs = [], set()
    for idx in (bags, cold) * 3:
        r, rsum, flags, count = abft_eb_cuda(table, al, be, idx, rs)
        ptrs.add(r.data_ptr())
        chain.append((idx is bags, flags, count))
        del r, rsum
    last = abft_eb_cuda(table, al, be, bags, rs)
    ptrs.add(last[0].data_ptr())
    torch.cuda.synchronize()
    want_flipped = ref.abft_eb_slot_order_ref(table, al, be, bags)
    table[0, row, 9] ^= -128
    want = ref.abft_eb_slot_order_ref(table, al, be, bags)
    al[0, row] *= 4.0
    want_scaled = ref.abft_eb_slot_order_ref(table, al, be, bags)
    al[0, row] *= 0.25
    for name, got in (("an in-place table flip", flipped),
                      ("K2 on the same allocation", last)):
        if not torch.equal(got[0], want_flipped) or \
                not bool(got[2][0, 0]) or \
                int(got[3].sum()) != int(got[2].sum()):
            fail(f"K2 right after {name}: R or flags wrong")
    for name, got, r_want in (("the flip back", restored, want),
                              ("an alpha change", scaled, want_scaled),
                              ("the alpha change back", after_alpha, want)):
        if not torch.equal(got[0], r_want) or bool(got[2].any()) or \
                int(got[3].sum()):
            fail(f"K2 right after {name}: R or flags wrong")
    for hot, flags, count in chain:
        if bool(flags[0, 0]) != hot or bool(flags.any()) != hot or \
                not torch.equal(count, flags.sum(-1, dtype=torch.int32)):
            fail("K2 right after K2 on the same counters: wrong flags")
    if len(ptrs) > 2:
        fail("the allocator did not hand K2's freed R over")


def eb_bounds(bags, d: int):
    """K2's least time, ``(useful, sectors)``, each ``(ms, by)``.  Useful
    bytes: each valid slot's d-byte row and its alpha, beta and C_T, the
    indices read once, R, rsum, the flags and the counts written once;
    sectors: the same with each random alpha, beta and C_T load a 32-byte
    sector.  Operations: 4 a row element, ~10 a slot for the check, and
    rsum's adds."""
    from repro_torch.benchmarks.common import F32_OPS_PER_S, bound_ms
    valid = int((bags >= 0).sum())
    t, b, p = bags.shape
    rest = 4 * t * b * p + t * b * (4 * d + 5) + 4 * t
    ops = valid * (4 * d + 10) + t * b * d
    return (bound_ms(valid * (d + 12) + rest, ops, F32_OPS_PER_S),
            bound_ms(valid * (d + 3 * 32) + rest, ops, F32_OPS_PER_S))


def device_ops(torch, fn) -> list:
    """The device operations (kernels, copies, fills) one call of ``fn``
    runs, by the profiler, after a warm-up call: ``[(name, count)]``.
    Fails if the profiler traces nothing on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(ev.key, ev.count) for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    if not ops:
        fail("the profiler traced no device operation")
    return ops


def pair_times(timer, calls, reps: int, rounds: int = 3) -> dict:
    """K3 -> K1 against K1 alone over the same calls.  ``calls`` holds
    (x, q, next_b) per qlinear: x the bf16 activation, q its int8 rows
    (K3's output, made beforehand) and next_b the weight each K1 call
    takes (cycling cold slices where there are several).  The pair runs
    K1 on K3's fresh output, as the path does; its excess over K1 alone
    is what K3 adds (``exposed_ms``), the time programmatic dependent
    launch should hide.  The same two with both kernels launched as plain
    stream successors (``*_no_pdl_ms``) show what it buys.  Medians over
    ``rounds`` rounds, in turns."""
    import numpy as np

    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda

    def alone(pdl):
        for _, q, next_b in calls:
            abft_qgemm_cuda(q, next_b(), pdl=pdl)

    def pair(pdl):
        for x, _, next_b in calls:
            abft_qgemm_cuda(quantize_rows_cuda(x, pdl=pdl)[0], next_b(),
                            pdl=pdl)

    def k3():
        for x, _, _ in calls:
            quantize_rows_cuda(x)

    order = [("k1_alone_ms", lambda: alone(True)),
             ("pair_ms", lambda: pair(True)),
             ("pair_no_pdl_ms", lambda: pair(False)),
             ("k1_alone_no_pdl_ms", lambda: alone(False)),
             ("k3_ms", k3)]
    runs = {key: [] for key, _ in order}
    for r in range(rounds):
        for key, fn in (order if r % 2 == 0 else order[::-1]):
            runs[key].append(timer.ms(fn, reps))
    out = {k: float(np.median(v)) for k, v in runs.items()}
    out["exposed_ms"] = out["pair_ms"] - out["k1_alone_ms"]
    out["exposed_no_pdl_ms"] = out["pair_no_pdl_ms"] - \
        out["k1_alone_no_pdl_ms"]
    out["runs"] = runs
    return out


def small_card_vs_cpu(torch, dev, small, model, p_cpu, plan, seqs,
                      f32_after_split: float = 1e-4,
                      hold_after_split: bool = True, extra=None) -> dict:
    """A smoke-size model's prefill and 3 greedy decodes on the card
    against the plain run on the CPU, on the same weights ``p_cpu``, at
    each prompt length of ``seqs``, in float32 and bfloat16, free and in
    lockstep; returns each case's record.

    The same port code runs on both sides; the card sums some float terms
    in another order (the WKV, the EmbeddingBag, the attention and norm
    reductions).  Every activation quantization (K3 on the card, its
    plain version on the CPU) is watched, and where the two runs' int8
    codes first differ the split must be a rounding one
    (:func:`code_split_is_rounding`); it is printed with its element and
    pre-quantization values.  Each case runs twice:

    * free: the logits are held to 1e-4 of their scale at every step
      before that split, and from it an f32 run to ``f32_after_split``
      and a bf16 run to 2**-4, the bf16 allowance the CPU tests hold the
      port to against the JAX package (tests/test_torch_rwkv.py);
    * lockstep: the card runs each step first, and the CPU run takes the
      card's codes (q, alpha, beta) at every quantization where the two
      split by a rounding, and fails at any other split.  Given the same
      codes, every step's logits are held to 1e-4.

    Both hold the counters equal, and the greedy tokens wherever the
    CPU's top-two margin leaves room for the bound.  With
    ``hold_after_split=False`` (a MoE, where a moved int8 code can move a
    token's choice of experts and with it the whole row) a free run is
    held to the bound up to its first code split and to finite logits
    and equal counters after it; the lockstep run is held at every
    step.  ``extra`` holds a family's other prefill inputs for the batch
    of 2 (llava's ``patches``, whisper's ``frames``; CPU tensors); the
    patches and the meta tokens open the sequence before the prompt."""
    import numpy as np

    from repro_torch.core.policy import metrics_to_ints
    from repro_torch.kernels import ops as kops
    from repro_torch.layers.common import Ctx
    from repro_torch.models.convert import to_device

    what = f"smoke {small.name}"
    p_dev = to_device(p_cpu, dev)
    after_split = {torch.float32: f32_after_split, torch.bfloat16: 2.0**-4}
    watch = {"side": "card", "lockstep": False, "step": 0, "at": 0,
             "card": [], "cpu": [], "taken": []}
    real_quant = kops.quantize_rows

    def quantize(x, **kw):
        out = real_quant(x, **kw)
        got = [t.detach().to("cpu", copy=True) for t in (x, *out)]
        watch[watch["side"]].append(got)
        if watch["side"] == "card" or not watch["lockstep"]:
            return out
        i = len(watch["cpu"]) - 1
        if i >= len(watch["card"]):
            fail("the CPU run quantized more activations than the card's")
        card = watch["card"][i]
        if torch.equal(out[0], card[1]):
            return out
        split = code_split(torch, [got], [card])
        split.update(step=watch["step"], call=i)
        if not code_split_is_rounding(split):
            fail(f"{what} in lockstep: the int8 codes part by more "
                 f"than a rounding: {split}")
        watch["taken"].append(split)
        return tuple(t.to(x.device) for t in card[1:])

    def both(step, on_card, on_cpu):
        watch.update(step=step)
        watch["card"].clear()
        watch["cpu"].clear()
        watch["side"] = "card"
        dev_out = on_card()
        watch["side"] = "cpu"
        cpu_out = on_cpu()
        if len(watch["cpu"]) != len(watch["card"]):
            fail(f"the CPU and the card quantized {len(watch['cpu'])} and "
                 f"{len(watch['card'])} activations at step {step}")
        return cpu_out, dev_out

    extra = extra or {}
    prefix = small.meta_tokens + (small.n_patches if small.patch_dim else 0)

    def run_case(tokens, ctx, lockstep):
        watch.update(lockstep=lockstep, taken=[])
        label = f"{ctx.compute_dtype}, prompt {tokens.shape[1]}, " + (
            "lockstep" if lockstep else "free")
        cache_len = tokens.shape[1] + prefix + 8
        batch = {"tokens": tokens, **extra}
        batch_dev = {k: v.to(dev) for k, v in batch.items()}
        (lc, cc, rc), (ld, cd, rd) = both(
            0, lambda: model.prefill(p_dev, batch_dev, ctx, cache_len),
            lambda: model.prefill(p_cpu, batch, ctx, cache_len))
        split, errs = None, []
        for step in range(4):
            if split is None and not lockstep:
                split = code_split(torch, watch["cpu"], watch["card"])
                if split is not None:
                    split["step"] = step
                    if not code_split_is_rounding(split):
                        fail(f"{what} ({label}): the int8 codes part at "
                             f"step {step} by more than a rounding: {split}")
            mc = metrics_to_ints(rc.as_metrics())
            md = metrics_to_ints(rd.as_metrics())
            if mc != md:
                fail(f"{what} counters differ at step {step} ({label}): "
                     f"card {md} vs CPU {mc}")
            lcf, ldf = lc.float(), ld.float().cpu()
            scale = max(float(lcf.abs().max()), 1e-6)
            err = float((ldf - lcf).abs().max()) / scale
            lcf, ldf = lcf[:, :small.vocab], ldf[:, :small.vocab]
            bound = 1e-4 if split is None else after_split[ctx.compute_dtype]
            if split is not None and not hold_after_split:
                bound = float("inf")
            errs.append(err)
            if err > bound or not bool(torch.isfinite(ld).all()):
                fail(f"{what} logits ({label}) differ by {err:.3g} of "
                     f"the scale at step {step} (bound {bound:g}; first code "
                     f"split {split})")
            # two logits each within bound * scale move their gap by at
            # most twice that
            top2 = torch.topk(lcf, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * bound * scale
            if not torch.equal(ldf.argmax(-1)[clear], lcf.argmax(-1)[clear]):
                fail(f"{what} ({label}): the card's greedy token differs "
                     f"at step {step}")
            if step == 3:
                break
            # both sides decode the CPU's token
            nxt = torch.argmax(lcf, -1).to(torch.int32)
            pos = torch.full_like(nxt, tokens.shape[1] + prefix + step)
            (lc, cc, rc), (ld, cd, rd) = both(
                step + 1,
                lambda: model.decode(p_dev, cd, nxt.to(dev), pos.to(dev),
                                     ctx),
                lambda: model.decode(p_cpu, cc, nxt, pos, ctx))
        if lockstep:
            return {"err_of_scale_by_step": errs,
                    "codes_taken_from_the_card": len(watch["taken"]),
                    "first_taken": (watch["taken"] or [None])[0]}
        return {"err_of_scale_by_step": errs, "first_code_split": split}

    out = {}
    kops.quantize_rows = quantize
    try:
        for seq in seqs:
            tokens = torch.from_numpy(np.random.default_rng(13).integers(
                0, small.vocab, (2, seq)).astype(np.int32))
            for dtype in (torch.float32, torch.bfloat16):
                ctx = Ctx(quant=True, plan=plan, compute_dtype=dtype,
                          wkv_chunk=small.wkv_chunk)
                for lockstep in (False, True):
                    out[f"prompt {seq} {str(dtype)[6:]} "
                        + ("lockstep" if lockstep else "free")] = \
                        run_case(tokens, ctx, lockstep)
    finally:
        kops.quantize_rows = real_quant
    log(f"{what} prefill + 3 decodes, card vs CPU: counters equal; "
        "|dlogit| / scale by step, and the first int8 code split (free) or "
        "the codes the CPU took from the card at rounding splits "
        "(lockstep): " + "; ".join(
            f"{k}: {[f'{e:.3g}' for e in v['err_of_scale_by_step']]}, "
            + (f"split {v['first_code_split']}" if "first_code_split" in v
               else f"{v['codes_taken_from_the_card']} taken, the first "
                    f"{v['first_taken']}")
            for k, v in out.items()))
    return out


def rwkv_phases(torch, dev, timer, details, cfg, big_batch_seq) -> dict:
    """Phases 6-8 on RWKV6 config ``cfg`` (the full-width RWKV6-1.6B from
    :func:`main`), with K4 also held and timed at ``big_batch_seq`` =
    (B, S).  Returns the K4 row and the RWKV path's launch counts."""
    import numpy as np

    from repro_torch.benchmarks.common import (F32_OPS_PER_S,
                                               INT8_OPS_PER_S, bound_ms)
    from repro_torch.configs import reduce_cfg
    from repro_torch.core import LANE
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.kernels.abft_qgemm import BK as K1_BK, \
        abft_qgemm_cuda, launch_plan
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked_cuda, wkv_plan
    from repro_torch.layers import rwkv6 as rk
    from repro_torch.models.base import build_model
    from repro_torch.models.convert import to_device
    from repro_torch.protect import default_plan
    from repro_torch.serving import (Request, ServingEngine, TenantSpec,
                                     chat_stream)

    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, [TenantSpec("default", default_plan())],
                           n_slots=4, max_prompt=64, seed=0, device=dev)
    torch.cuda.synchronize()
    params = engine.params
    n_int8 = sum(t.numel() for t in (
        [params["embed"]["table"], params["head"]["w_packed"]]
        + [params["layers"][blk][w]["w_packed"] for blk, ws in
           (("tm", ("wr", "wk", "wv", "wg", "wo")), ("cm", ("wk", "wv")))
           for w in ws]))
    log(f"{cfg.name} (d {cfg.d_model}, {cfg.n_layers} layers) on the card in "
        f"{time.perf_counter() - t0:.1f}s: {n_int8 / 1e9:.2f} GB of int8 "
        f"(packed) weights and table")

    def stream(n, seed):
        return chat_stream(n, tenants={"default": 1.0}, rate_rps=100.0,
                           seed=seed, mean_prompt=32, max_prompt=64,
                           mean_output=16, max_output=32)

    # ------------------- 6. kernels at the RWKV path's shapes ---------------
    gen = torch.Generator(device=dev).manual_seed(2)
    layers = params["layers"]
    # each GEMM shape with its weights of every layer, [layers, k, n + 128]
    gemms = [("tm.wr", layers["tm"]["wr"]["w_packed"], (64, 4)),
             ("cm.wk", layers["cm"]["wk"]["w_packed"], (64, 4)),
             ("cm.wv", layers["cm"]["wv"]["w_packed"], (64, 4)),
             ("lm_head", params["head"]["w_packed"][None], (1, 4))]
    checked = check_gemms(torch, dev, gen, gemms)
    log("K1 (C, err_rows, column check) and K3 (bf16 and f32) bit-exact "
        "at " + "; ".join(checked))
    hazards = pdl_hazards(torch, dev, gen, [
        (f"{name} (k, n) = ({st.shape[1]}, {st.shape[2] - LANE}) m = {ms_[0]}",
         ms_[0], st[0]) for name, st, ms_ in gemms] + [
        ("cm.wv m = 4", 4, layers["cm"]["wv"]["w_packed"][1])])
    log("K1 under PDL bit-exact after K3, after an in-place flip of B', "
        "after K1 on the same scratch and after the correct repair at "
        + "; ".join(hazards))

    emb = params["embed"]
    enc4 = (emb["table"][None], emb["alphas"][None], emb["betas"][None],
            emb["rowsums"][None])
    req0 = stream(1, 5)[0]
    prompt = torch.from_numpy(
        engine._chat_tokens(req0, 64).astype(np.int32)).to(dev)
    k2 = {"checks": {}, "times": {}}
    for n_bags in (64, 4):
        idx = prompt[:n_bags].reshape(1, -1, 1)
        label = f"{n_bags} tokens"
        k2["checks"][label] = eb_checks(torch, enc4, idx, label)
        # cold rows: each launch looks up fresh random tokens
        sets = [torch.randint(0, cfg.vocab, idx.shape, generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(16)]
        it = itertools.cycle(sets)
        (b_ms, _), (s_ms, _) = eb_bounds(idx, cfg.d_model)
        k2["times"][label] = {
            "ms": timer.ms(lambda: abft_eb_cuda(*enc4[:3], next(it),
                                                enc4[3]), 32),
            "plain_ms": timer.ms(lambda: kops.abft_embedding_bag(
                *enc4[:3], next(it), enc4[3], use_kernel=False), 8),
            "bound_ms": b_ms, "sector_bound_ms": s_ms}
    eb_pdl_hazards(torch, enc4, prompt.reshape(1, -1, 1))
    log(f"K2 on the {tuple(emb['table'].shape)} token table at pool 1 (64 "
        f"and 4 bags): R bit-exact with the slot-order sum, flags equal to "
        f"the plain branch at rel_bound 1e-3 and 1e-5 and to its formula at "
        f"all three, under PDL after a table flip, an alpha change and "
        f"another K2; ms (cold) / plain / bound / sector bound: "
        + "; ".join(f"{k}: {v['ms']:.5f} / {v['plain_ms']:.4f} / "
                    f"{v['bound_ms']:.6f} / {v['sector_bound_ms']:.6f}"
                    for k, v in k2["times"].items()))

    # K4 on the prefill's own inputs: capture every layer's WKV call
    captured = []
    real_wkv = kops.wkv_chunked

    def capture(*a, **kw):
        captured.append(([t.clone() for t in a], kw["chunk"]))
        return real_wkv(*a, **kw)

    kops.wkv_chunked = capture
    try:
        engine.lanes[0].prefill_fn(params, engine._chat_batch(req0))
    finally:
        kops.wkv_chunked = real_wkv
    if len(captured) != cfg.n_layers:
        fail(f"prefill ran {len(captured)} chunked WKV calls, not "
             f"{cfg.n_layers}")
    shape = tuple(captured[0][0][0].shape)
    if shape != (1, 64, h, dh) or captured[0][1] != 16:
        fail(f"unexpected prefill WKV shape {shape}, chunk "
             f"{captured[0][1]}")

    if captured[0][0][0].dtype != torch.bfloat16:
        fail(f"the prefill handed K4 {captured[0][0][0].dtype} r, k, v, not "
             f"its bf16 projections")
    k4 = {"model_max_abs_err": 0.0, "model_worst_ratio": 0.0,
          "model vs plain": {"y": 0.0, "S": 0.0}}
    for args, chunk in captured:
        y_k, s_k = wkv6_chunked_cuda(*args, chunk=chunk)
        f32 = [t.float() for t in args[:3]] + list(args[3:])
        for name, (y_w, s_w) in (
                ("plain", ref.wkv_chunked_ref(*args, chunk=chunk)),
                ("recurrence", rk.wkv_recurrent(*f32))):
            # the model's r, k, v reach some tens: 2e-4 of each output's
            # scale as the absolute part
            for part, got, want in (("y", y_k, y_w), ("S", s_k, s_w)):
                err, ratio = wkv_err(got, want,
                                     2e-4 * float(want.abs().max()))
                if not bool(torch.isfinite(got).all()) or ratio > 1.0:
                    fail(f"wkv6_chunked off the {name} version on model "
                         f"inputs: max |d| {err:.3g}, {ratio:.3g}x the "
                         f"2e-4 bound")
                if name == "plain":
                    k4["model_max_abs_err"] = max(k4["model_max_abs_err"],
                                                  err)
                    k4["model vs plain"][part] = max(
                        k4["model vs plain"][part], err)
                k4["model_worst_ratio"] = max(k4["model_worst_ratio"],
                                              ratio)
    k4["model_y_scale"] = max(float(ref.wkv_chunked_ref(*a, chunk=c)[0]
                                    .abs().max()) for a, c in captured)

    def wkv_random(b, s, dh_, decay):
        r, k, v = (torch.randn((b, s, h, dh_), generator=gen, device=dev)
                   for _ in range(3))
        if decay == "heavy":
            lw = torch.rand((b, s, h, dh_), generator=gen, device=dev) \
                * rk.LOG_W_MIN
        else:               # all LOG_W_MIN on unit inputs: kin at e^(5 C)
            r, k, v = (torch.ones_like(r) for _ in range(3))
            lw = torch.full_like(r, rk.LOG_W_MIN)
        u = torch.randn((h, dh_), generator=gen, device=dev) * 0.5
        s0 = torch.randn((b, h, dh_, dh_), generator=gen, device=dev) * 0.1
        return [r, k, v, lw, u, s0]

    # K4 at batch 1 and 2, dh 64 and 32, chunk 16 and 8, heavy and all-min
    # decay, r/k/v in bf16 and f32, staged by 16- and by 4-byte copies; and
    # at big_batch_seq against the plain version only (the recurrence is a
    # Python loop over its tokens)
    cases = [(f"B{b_} dh{dh_} chunk{ch_} {decay}",
              wkv_random(b_, 64, dh_, decay), ch_, True)
             for b_, dh_, ch_, decay in itertools.product(
                 (1, 2), (64, 32), (16, 8), ("heavy", "all_min"))]
    big = wkv_random(*big_batch_seq, dh, "heavy")
    big_label = str(tuple(big[0].shape))
    cases.append((big_label, big, 16, False))
    worst_ratio = {}
    for label, args, ch_, with_rec in cases:
        b_, s_, _, dh_ = args[0].shape
        for dtype in (torch.bfloat16, torch.float32):
            rkv = [t.to(dtype) for t in args[:3]]
            refs = [("plain", ref.wkv_chunked_ref(*rkv, *args[3:],
                                                  chunk=ch_))]
            if with_rec:
                refs.append(("recurrence", rk.wkv_recurrent(
                    *(t.float() for t in rkv), *args[3:])))
            for vec in (16, 4):
                plan = wkv_plan(b_, h, dh_, ch_, seq=s_,
                                itemsize=rkv[0].element_size())
                y_k, s_k = wkv6_chunked_cuda(*rkv, *args[3:], chunk=ch_,
                                             plan=plan._replace(vec=vec))
                way = f"{vec}-byte copies"
                for name, (y_w, s_w) in refs:
                    errs = {}
                    for part, got, want in (("y", y_k, y_w),
                                            ("S", s_k, s_w)):
                        errs[part], ratio = wkv_err(got, want, 2e-4)
                        if not bool(torch.isfinite(got).all()) or \
                                ratio > 1.0:
                            fail(f"wkv6_chunked ({way}, {dtype}) off the "
                                 f"{name} version ({label}): max "
                                 f"|d{part}| {errs[part]:.3g}, "
                                 f"{ratio:.3g}x the bound")
                        worst_ratio[name] = max(
                            worst_ratio.get(name, 0.0), ratio)
                    k4[f"{label} {str(dtype)[6:]} {way} vs {name}"] = errs
    log(f"K4 within 2e-4 of the plain version and of the recurrence on "
        f"all {len(captured)} layers' bf16 prefill inputs (max |dy| "
        f"{k4['model_max_abs_err']:.3g} of a scale "
        f"{k4['model_y_scale']:.3g}); on {len(cases) - 1} cases (batch 1 "
        f"and 2, dh 64 and 32, chunk 16 and 8, heavy and all-min decay) "
        f"and at {big_label} (plain only), each in bf16 and f32, staged by "
        f"16- and 4-byte copies: worst error {worst_ratio} of the bound")

    # -------------------------- 7. serve + flips ----------------------------
    wrappers = zero_launches()
    tel = engine.run(stream(8, 0))            # the warm-up runs inside
    launches = read_launches(wrappers)
    s = tel.summary()
    per = s["per_tenant"]["default"]
    counters = s["faults"]["counters"]
    n_pre = sum(ev.kind == "prefill" for ev in tel.steps)
    n_dec = sum(ev.kind == "decode" for ev in tel.steps)
    log(f"served {per['requests']} chat requests: {per['completed']} "
        f"completed in {n_pre} prefills and {n_dec} decode steps; "
        f"launches {launches}; counters "
        f"{ {k: v for k, v in counters.items() if v} }")
    if per["completed"] != 8 or per["aborted"]:
        fail(f"not every chat request completed: {per}")
    nonzero = {k: v for k, v in counters.items()
               if v and not k.endswith("_checks")}
    if nonzero:
        fail(f"fault counters on a clean RWKV run: {nonzero}")
    steps = n_pre + n_dec
    per_step_gemms = cfg.n_layers * 7 + 1
    if counters["qgemm_checks"] != per_step_gemms * steps or \
            counters["embedding_bag_checks"] != steps:
        fail(f"unexpected check counts {counters} for {steps} steps")
    # the warm-up ran one prefill and one decode step inside the window
    want_l = {"wkv6_chunked": cfg.n_layers * (n_pre + 1),
              "abft_qgemm": per_step_gemms * (steps + 2),
              "quantize_rows": per_step_gemms * (steps + 2),
              "abft_embeddingbag": steps + 2,
              "qgemm_unprotected": 0, "eb_unprotected": 0}
    if launches != want_l:
        fail(f"launches {launches} differ from the path's {want_l}")
    toks = [t for r in tel.requests for t in (r.tokens or [])]
    if len(toks) != per["tokens_out"] or \
            not all(0 <= t < cfg.vocab for t in toks):
        fail("served tokens outside the vocabulary or missing")
    pre_ms = sorted(ev.duration_s * 1e3 for ev in tel.steps
                    if ev.kind == "prefill")
    dec_ms = sorted(ev.duration_s * 1e3 for ev in tel.steps
                    if ev.kind == "decode")
    serve = {"requests": per["requests"], "prefills": n_pre,
             "decode_steps": n_dec, "tokens_out": per["tokens_out"],
             "prefill_ms": pre_ms, "decode_ms": dec_ms,
             "prefill_ms_median": float(np.median(pre_ms)),
             "decode_ms_median": float(np.median(dec_ms)),
             "ttft_ms": per["ttft_ms"], "per_token_ms": per["per_token_ms"],
             "decode_occupancy_mean": s["decode_occupancy_mean"],
             "launches": launches, "counters": counters}

    def one_request(seed):
        req = Request(rid=0, tenant="default", arrival_s=0.0,
                      prompt_len=64, max_new_tokens=2, seed=seed)
        return req, engine.run([req], warmup=False).summary()[
            "faults"]["counters"]

    # faults through FaultInjection, each at the step of one request's
    # prefill (and its decode): a cm.wv payload bit, and a high bit of the
    # embedding row of one of the prompt's tokens
    from repro_torch.serving import FaultInjection

    def inject_run(req, inj, leaf):
        engine.reset_state()
        before = leaf_fingerprint(torch, leaf)
        tel = engine.run([req], inject=[inj], warmup=False)
        return tel, before, leaf_fingerprint(torch, leaf)

    def request(seed):
        return Request(rid=0, tenant="default", arrival_s=0.0,
                       prompt_len=64, max_new_tokens=2, seed=seed)

    tel, fp0, fp1 = inject_run(request(11), FaultInjection(
        step=0, victim="cm.wv", seed=0), layers["cm"]["wv"]["w_packed"])
    r_flips = {"weight": check_injection(tel, 0, [0], fp0, fp1,
                                         "RWKV cm.wv flip")}
    req = request(12)
    prompt_rows = set(engine._chat_tokens(req, 64).tolist())
    e_seed = injection_seed(
        torch, emb["table"], "embed.table",
        lambda idx: idx // emb["table"].shape[1] in prompt_rows)
    tel, fp0, fp1 = inject_run(req, FaultInjection(
        step=0, victim="embed", seed=e_seed), emb["table"])
    r_flips["table"] = check_injection(tel, 0, [0], fp0, fp1,
                                       "RWKV embedding flip")
    r_flips["table"]["seed"] = e_seed
    engine.reset_state()
    _, c_clean = one_request(12)
    if c_clean["qgemm_errors"] or c_clean["embedding_bag_errors"]:
        fail("errors after restoring the injected RWKV flips")
    r_flips["restored"] = c_clean
    log(f"FaultInjection on RWKV: {r_flips['weight']['victim']} and "
        f"{r_flips['table']['victim']} (seed {e_seed}, a prompt token's "
        f"row) each flagged at its step 0 only; both leaves bit-identical "
        f"afterwards; a clean request after: no errors")
    details["rwkv_flips"] = r_flips

    # the smoke-size model: card against the plain CPU run
    small = reduce_cfg(cfg)
    model = build_model(small)
    p_cpu = model.init(0, quant=True, device="cpu")
    small_out = small_card_vs_cpu(torch, dev, small, model, p_cpu,
                                  default_plan(), (64, 24))

    # the smoke-size engines at a 24-token bucket, on the card and on the
    # CPU with the same weights and requests: every request served, the
    # same fault counters, K4 launched for the prefills' whole chunk
    def small_engine(device):
        return ServingEngine(small, [TenantSpec("default", default_plan())],
                             n_slots=4, max_prompt=24, seed=0, device=device)

    def bucket_requests():
        return [Request(rid=i, tenant="default", arrival_s=0.0,
                        prompt_len=24, max_new_tokens=4, seed=60 + i)
                for i in range(4)]

    eng_cpu, eng_dev = small_engine("cpu"), small_engine(dev)
    eng_dev.params = to_device(eng_cpu.params, dev)
    eng_dev.warmup()
    wkv6_chunked_cuda.launches = 0
    bucket = {}
    for where, eng in (("cpu", eng_cpu), ("card", eng_dev)):
        tel_b = eng.run(bucket_requests())
        per_b = tel_b.summary()["per_tenant"]["default"]
        bucket[where] = {"completed": per_b["completed"],
                         "counters": tel_b.summary()["faults"]["counters"]}
    bucket["k4_launches"] = wkv6_chunked_cuda.launches
    if bucket["cpu"] != bucket["card"] or bucket["card"]["completed"] != 4 \
            or bucket["k4_launches"] != 4 * small.n_layers:
        fail(f"the 24-token bucket served differently on the card: {bucket}")
    log(f"smoke RWKV engine at a 24-token bucket: 4 requests on the card "
        f"and on the CPU, counters equal "
        f"{ {k: v for k, v in bucket['card']['counters'].items() if v} }, "
        f"K4 {bucket['k4_launches']} launches (one per layer a prefill)")

    # ------------------------------ 8. times --------------------------------
    m_args = captured[0][0]             # bf16 r, k, v, as the path hands
    nb, nops = wkv_bound(1, 64, h, dh, 16, itemsize=2)
    b_ms, b_by = bound_ms(nb, nops, F32_OPS_PER_S)
    nb_big, nops_big = wkv_bound(*big_batch_seq, h, dh, 16)
    # on the path's bf16 and on the f32 cast
    f32_args = [t.float() for t in m_args[:3]] + list(m_args[3:])
    k4_plans = {}
    for dname, a_ in (("bfloat16", m_args), ("float32", f32_args)):
        plan = wkv_plan(1, h, dh, 16, seq=64, itemsize=a_[0].element_size())
        k4_plans[dname] = {
            "plan": plan._asdict(), "blocks": plan.blocks,
            "ms": timer.ms(lambda: wkv6_chunked_cuda(*a_, chunk=16))}
    k4_row = {
        "name": "wkv6_chunked", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6_chunked.cu",
        "replaces": REPLACES["wkv6_chunked"],
        "launches": launches["wkv6_chunked"],
        "max_abs_err": k4["model_max_abs_err"],
        "ms": timer.ms(lambda: wkv6_chunked_cuda(*m_args, chunk=16)),
        "plain_ms": timer.ms(lambda: ref.wkv_chunked_ref(*m_args,
                                                         chunk=16)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "per": f"one prefill: {cfg.n_layers} launches (one per layer) at "
               f"{shape}, chunk 16, r/k/v bf16",
        "plan": wkv_plan(1, h, dh, 16, seq=64, itemsize=2)._asdict(),
        "by_dtype": k4_plans}
    big_bound = bound_ms(nb_big, nops_big, F32_OPS_PER_S)
    k4_big = {"ms": timer.ms(lambda: wkv6_chunked_cuda(*big, chunk=16), 5),
              "plain_ms": timer.ms(lambda: ref.wkv_chunked_ref(*big,
                                                               chunk=16), 3),
              "bound_ms": big_bound[0], "bound_by": big_bound[1]}
    log(f"K4 at {shape}: {k4_row['ms']:.4f} ms with plan {k4_row['plan']} "
        f"(bound {b_ms:.5f} ms by {b_by}, plain {k4_row['plain_ms']:.4f} "
        f"ms); by r/k/v type: "
        + "; ".join(f"{k_} ({v['blocks']} blocks) {v['ms']:.4f}"
                    for k_, v in k4_plans.items()) + "; at "
        f"{big_label}: {k4_big['ms']:.3f} ms (bound "
        f"{big_bound[0]:.4f} ms, plain {k4_big['plain_ms']:.3f} ms)")
    # K1 and K3 at every GEMM shape of an RWKV step (prefill m = 64,
    # decode m = 4; the head sees m = 1 in a prefill): where a step's
    # device time goes.  K1 as the path finds its weights, cold: each call
    # takes the next layer's slice (24 slices of each shape hold 100-350
    # MB, above the 50 MB L2; the head's 134 MB is cold by size), and warm
    # (one slice again and again).  The yardstick is torch._int_mm on the
    # same cold slices, padded to n + 1 -> a multiple of 8 columns and to
    # m = 32 rows where m <= 16 (its shape limits).
    per_shape = {}
    for name, stack, ms_ in gemms:
        k, n = stack.shape[1], stack.shape[2] - LANE
        n8 = -(-(n + 1) // 8) * 8
        padded = [w[:, :n8].contiguous() for w in stack]
        for m in ms_:
            x = torch.randn((m, k), generator=gen, device=dev)
            q = quantize_rows_cuda(x)[0]
            a_pad = torch.zeros((max(m, 32), k), dtype=torch.int8,
                                device=dev)
            a_pad[:m] = q
            cold = itertools.cycle(list(stack))
            cold_pad = itertools.cycle(padded)
            reps = 2 * len(stack) if len(stack) > 1 else 10
            kb = m * k + k * (n + 1) + 4 * m * n + 4 * m
            b_ms = bound_ms(kb, 2 * m * k * (n + 1), INT8_OPS_PER_S)[0]
            plan = launch_plan(m, k, n, a_addr=q.data_ptr(),
                               b_addr=stack[0].data_ptr())
            x16 = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            cold_pair = itertools.cycle(list(stack))
            row = {
                "pair": pair_times(timer, [(x16, quantize_rows_cuda(x16)[0],
                                            lambda: next(cold_pair))], reps),
                "abft_qgemm_cold_ms": timer.ms(
                    lambda: abft_qgemm_cuda(q, next(cold)), reps),
                "abft_qgemm_warm_ms": timer.ms(
                    lambda: abft_qgemm_cuda(q, stack[0])),
                "library_cold_ms": timer.ms(
                    lambda: torch._int_mm(a_pad, next(cold_pad)), reps),
                "abft_qgemm_bound_ms": b_ms,
                "plan": {"bm": plan.bm, "splits": plan.splits,
                         "blocks": plan.blocks, "aligned": plan.aligned},
                "quantize_rows_ms": timer.ms(lambda: quantize_rows_cuda(x)),
                "quantize_rows_bf16_ms": timer.ms(
                    lambda: quantize_rows_cuda(x16))}
            row["bound_share"] = b_ms / row["abft_qgemm_cold_ms"]
            per_shape[f"{name} m={m} k={k} n={n}"] = row
        del padded
    # the evidence for the plan's split rule: K1 cold at each layer shape
    # under every cluster size that splits k evenly enough (each result
    # also held against the plain version), beside the plan's choice
    sweep = {}
    for name, stack, ms_ in gemms[:3]:
        k, n = stack.shape[1], stack.shape[2] - LANE
        for m in ms_:
            q = quantize_rows_cuda(torch.randn((m, k), generator=gen,
                                               device=dev))[0]
            base = launch_plan(m, k, n, a_addr=q.data_ptr(),
                               b_addr=stack[0].data_ptr())
            want = ref.abft_qgemm_ref(q, stack[0])
            ksteps = -(-k // K1_BK)
            by_splits = {}
            for s_ in range(1, 9):
                per_ = -(-ksteps // s_)
                if -(-ksteps // per_) != s_:
                    continue
                p_ = base._replace(splits=s_, k_per_split=per_ * K1_BK)
                got = abft_qgemm_cuda(q, stack[0], plan=p_)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"abft_qgemm with {s_} splits differs at {name} "
                         f"m={m}")
                cold = itertools.cycle(list(stack))
                by_splits[s_] = timer.ms(
                    lambda: abft_qgemm_cuda(q, next(cold), plan=p_),
                    2 * len(stack))
            sweep[f"{name} m={m}"] = {"plan_splits": base.splits,
                                      "blocks_per_split": base.tiles_n,
                                      "ms_by_splits": by_splits}
    log("K1 split sweep, cold ms by cluster size (the plan's in brackets): "
        + "; ".join(f"{k_} [{v['plan_splits']}]: " + ", ".join(
            f"{s_}: {t:.4f}" for s_, t in v["ms_by_splits"].items())
            for k_, v in sweep.items()))
    log("K1 per RWKV shape, ms cold / warm / torch._int_mm cold / bound "
        "(share); K3 ms f32 / bf16; K3 -> K1 pair ms, K1 alone, exposed: "
        + "; ".join(
            f"{k_}: {v['abft_qgemm_cold_ms']:.4f} / "
            f"{v['abft_qgemm_warm_ms']:.4f} / {v['library_cold_ms']:.4f} / "
            f"{v['abft_qgemm_bound_ms']:.5f} ({v['bound_share']:.2f}); "
            f"{v['quantize_rows_ms']:.4f} / "
            f"{v['quantize_rows_bf16_ms']:.4f}; {v['pair']['pair_ms']:.4f}, "
            f"{v['pair']['k1_alone_ms']:.4f}, "
            f"{v['pair']['exposed_ms']:.4f} (no PDL "
            f"{v['pair']['pair_no_pdl_ms']:.4f}, "
            f"{v['pair']['k1_alone_no_pdl_ms']:.4f}, "
            f"{v['pair']['exposed_no_pdl_ms']:.4f})"
            for k_, v in per_shape.items()))
    prof_reqs = [Request(rid=i, tenant="default", arrival_s=0.0,
                         prompt_len=64, max_new_tokens=4, seed=40 + i)
                 for i in range(4)]
    serve["profile"], dtypes = kernel_input_dtypes(
        lambda: profile_requests(torch, engine, prof_reqs))
    serve["kernel_input_dtypes"] = dtypes
    if dtypes != {"quantize_rows": [("bfloat16",)],
                  "wkv6_chunked": [("bfloat16",) * 3]}:
        fail(f"K3 and K4 were handed {dtypes} on the RWKV path, not its "
             f"bf16 activations uncast")
    log(f"RWKV serve: prefill step median {serve['prefill_ms_median']:.2f} "
        f"ms, decode step median {serve['decode_ms_median']:.2f} ms, TTFT "
        f"p50 {per['ttft_ms']['p50']:.2f} ms, per token p50 "
        f"{per['per_token_ms']['p50']:.2f} ms")
    details["rwkv"] = {"serve": serve, "k4_checks": k4, "k2": k2,
                       "gemm_shapes": per_shape, "k1_split_sweep": sweep,
                       "k4_large": {big_label: k4_big},
                       "small_card_vs_cpu": small_out,
                       "bucket_24": bucket}
    return {"k4_row": k4_row, "launches": launches, "k2_times": k2["times"]}


def leaf_fingerprint(torch, leaf) -> tuple:
    """Two int64 sums of a leaf's bit patterns, plain and weighted by
    position, taken in chunks (a DLRM table stack holds 1.33e10 bytes):
    a changed element changes them, and a restored flip leaves both as
    they were."""
    from repro_torch.core.inject import signed_view

    flat = signed_view(leaf)
    s1 = torch.zeros((), dtype=torch.int64, device=leaf.device)
    s2 = torch.zeros_like(s1)
    step = 1 << 26
    for i in range(0, flat.numel(), step):
        c = flat[i:i + step].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
        s1 += c.sum()
        s2 += (c * w).sum()
    return int(s1), int(s2)


def injection_seed(torch, leaf, path: str, reads, min_bit: int = 4) -> int:
    """The first seed from 0 whose :class:`FaultInjection` draw on
    ``leaf`` lands on an element ``reads(flat_index)`` says the requests
    read, at a bit of at least ``min_bit``: a fault in a row the request
    gathers, high in its byte, as the hand flips of earlier versions of
    this script chose.  The draws are the engine's own (a CPU generator
    per seed)."""
    from repro_torch.core.inject import draw_bitflip_live

    meta = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    for seed in range(1_000_000):
        idx, bit = draw_bitflip_live(torch.Generator().manual_seed(seed),
                                     meta, path)
        if bit >= min_bit and reads(idx):
            return seed
    fail(f"no injection seed below 1e6 hits a row the request reads "
         f"({path})")


def check_injection(tel, step: int, flagged_steps, fp_before, fp_after,
                    what: str) -> dict:
    """An injected fault flagged at its step (and only at
    ``flagged_steps``), the leaf bit-identical afterwards."""
    (inj,) = tel.injections
    flagged = sorted({ev.step for ev in tel.steps if ev.errors})
    if not inj.detected or inj.detect_step != step or \
            flagged != list(flagged_steps):
        fail(f"{what}: injected at step {inj.step}, detected "
             f"{inj.detected} at step {inj.detect_step}; flagged steps "
             f"{flagged}, expected {list(flagged_steps)}")
    if fp_after != fp_before:
        fail(f"{what}: the victim leaf {inj.victim} differs from its clean "
             f"value after the run")
    return {"victim": inj.victim, "step": inj.step,
            "detect_step": inj.detect_step, "flagged_steps": flagged,
            "persistent": inj.persistent,
            "counters": tel.summary()["faults"]["counters"]}


#: the campaign targets whose protected call launches K1 or K2 on the card
KERNEL_TARGETS = ("gemm_packed", "gemm_pallas", "embedding_bag", "eb_pallas")
#: at most this share of an EmbeddingBag cell's trials may be decided
#: differently by K2 and its plain version, each within
#: ``targets.EB_ROUND_OFF`` of the bound and explained by K2's own rsum
EB_SPLIT_SHARE = 0.01


def campaign_plans() -> list:
    """The distinct cell plans of the quick, pallas (quick) and paper grids
    at seed 0, as phase 9 runs them."""
    from repro_torch.campaign import grids, spec

    plans = {}
    for specs in (grids.quick_specs(seed=0),
                  grids.pallas_specs(seed=0, quick=True),
                  grids.paper_specs(seed=0)):
        for sp in specs:
            plans.update(dict.fromkeys(spec.expand(sp)[0]))
    return list(plans)


def kernels_at_campaign_shapes(torch, dev, plans) -> list:
    """K1 and K2 held to their plain versions at every shape the grids hand
    them, on the first cell state of each shape, built as the campaign
    builds it.  K1 (uint8 A, as the cells draw it): C, err_rows and the
    column check bit-exact with ``ref.abft_qgemm_ref``, clean (no row
    flagged) and with the cell's first fault in B'.  K2, on the cell's
    first trial's bags: :func:`eb_checks` (R bit-exact with the slot-order
    sum, rsum within round-off of the plain rsum, flags equal to the plain
    branch) and :func:`eb_flip_sweep`.  Returns what was held, by shape."""
    from repro_torch.campaign.executor import _generators
    from repro_torch.campaign.targets import get_target, inject_, restore_
    from repro_torch.core import LANE
    from repro_torch.core.inject import signed_view
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda, launch_plan

    first = {}
    for p in plans:
        if p.target in KERNEL_TARGETS:
            kind = "K1" if p.target.startswith("gemm") else "K2"
            first.setdefault((kind, p.shape), p)
    done = []
    for (kind, shape), p in first.items():
        target = get_target(p.target)
        g_build, g_trial, _ = _generators(p.seed)
        st = target.build(p, g_build, device=dev)
        (trial,) = target.draw(st, p, g_trial, 1, True)
        label = f"{p.target} {'x'.join(map(str, shape))}"
        if kind == "K2":
            enc = tuple(x[None] for x in st["enc"])
            bags = trial.indices[None].contiguous()
            eb_checks(torch, enc, bags, label)
            eb_flip_sweep(torch, enc, bags)
            done.append(f"K2 {label}")
            continue
        a, packed, n = st["a"], st["packed"], st["n"]
        faults = [f._replace(index=(f.index // n) * (n + LANE) + f.index % n)
                  for f in trial.faults]
        for faulty in (False, True):
            undo = inject_(signed_view(packed), faults, 8)[0] \
                if faulty else []
            for col in (False, True):
                got = abft_qgemm_cuda(a, packed, with_colcheck=col)
                want = ref.abft_qgemm_ref(a, packed, with_colcheck=col)
                for g, w, what in zip(got, want,
                                      ("C", "err_rows", "col_check")):
                    if not torch.equal(g, w):
                        fail(f"abft_qgemm: {what} differs from the plain "
                             f"version at {label} (a fault in B': "
                             f"{faulty}, column check {col})")
                if not faulty and int(got[1].sum()):
                    fail(f"abft_qgemm flagged clean operands at {label}")
            restore_(undo, 8)
        lp = launch_plan(*a.shape, n, a_addr=a.data_ptr(),
                         b_addr=packed.data_ptr())
        done.append(f"K1 {label} (bm {lp.bm}, splits {lp.splits}, "
                    f"aligned {lp.aligned})")
    return done


def eb_split_cause(torch, dev, plan, trial) -> dict:
    """Why K2 and its plain version decide an EmbeddingBag trial
    differently: K2 on the trial's faulted table and bags, its flags equal
    to its own Eq. (5) formula on its own rsum (``ref.eb_check_slot_order``),
    and the largest distance of that rsum from the float64 RSum, as a
    share of each bag's bound.  The split is the order of the sums alone
    when the flags equal the formula and that distance is within
    ``targets.EB_ROUND_OFF``."""
    from repro_torch.campaign.executor import _generators
    from repro_torch.campaign.targets import (eb_sums64, get_target,
                                              inject_, restore_)
    from repro_torch.core.inject import signed_view
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.protect.ops import EMBEDDING_BAG

    st = get_target(plan.target).build(plan, _generators(plan.seed)[0],
                                       device=dev)
    ((rsum64, _, bound64),) = eb_sums64(st, plan, [trial])
    table, al, be, rs = st["enc"]
    rel = EMBEDDING_BAG.default_rel_bound if plan.rel_bound is None \
        else plan.rel_bound
    undo, _ = inject_(signed_view(table), trial.faults, 8)
    idx = trial.indices[None].contiguous()
    _, rsum, flags, _ = abft_eb_cuda(table[None], al[None], be[None], idx,
                                     rs[None], rel_bound=rel)
    mirror = ref.eb_check_slot_order(rsum, al[None], be[None], idx, rs[None],
                                     table.shape[-1], rel_bound=rel)
    restore_(undo, 8)
    return {"k2_flagged": bool(flags.any()),
            "k2_flags_are_its_formula": torch.equal(flags, mirror),
            "k2_rsum_off_f64_of_bound": float(
                ((rsum[0].cpu().double() - rsum64).abs() / bound64).max())}


def trial_for_trial(torch, dev, plans) -> dict:
    """Every cell of the grids whose protected call launches K1 or K2, run
    twice on the card from its seed: with the kernels and with
    ``plain=True``.  The kernel run must launch one kernel per trial and
    the plain run none; the corrupted and the clean flags must be equal,
    and the GEMM's detection flags bit for bit.  An EmbeddingBag trial may
    be decided differently only within ``targets.EB_ROUND_OFF`` of its
    bound, by at most :data:`EB_SPLIT_SHARE` of the cell's trials, and
    only where :func:`eb_split_cause` shows K2 deciding by its own formula
    on an rsum within round-off of the float64 one.  The trials inside
    that window are counted, agreeing and differing."""
    import dataclasses

    from repro_torch.campaign.executor import _generators, run_cell
    from repro_torch.campaign.targets import (EB_ROUND_OFF, eb_margins,
                                              get_target)
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda

    out = {}
    for plan in plans:
        if plan.target not in KERNEL_TARGETS:
            continue
        cid = f"{plan.cell_id} n={plan.samples}"
        plan = dataclasses.replace(plan, measure_overhead=False)
        runs, launched = {}, {}
        for plain in (False, True):
            abft_qgemm_cuda.launches = abft_eb_cuda.launches = 0
            runs[plain] = run_cell(plan, device=dev, plain=plain)
            launched[plain] = (abft_qgemm_cuda.launches
                               + abft_eb_cuda.launches)
        n = plan.samples + plan.clean_samples
        if launched[False] != n or launched[True] != 0:
            fail(f"{cid}: kernel launches {launched} (the kernel run must "
                 f"launch one per trial, {n}, the plain run none)")
        k, p = runs[False], runs[True]
        if not torch.equal(k.trials[:, 1], p.trials[:, 1]):
            fail(f"{cid}: the kernel and plain runs corrupted different "
                 f"trials")
        if not torch.equal(k.clean, p.clean):
            fail(f"{cid}: clean flags differ between kernel and plain "
                 f"({int((k.clean != p.clean).sum())} of "
                 f"{plan.clean_samples})")
        differ = (k.trials[:, 0] != p.trials[:, 0]).nonzero()[:, 0].tolist()
        row = {"target": plan.target, "trials": plan.samples,
               "clean": plan.clean_samples,
               "detected_kernel": int(k.trials[:, 0].sum()),
               "detected_plain": int(p.trials[:, 0].sum()),
               "differ": differ}
        out[cid] = row
        if plan.target.startswith("gemm"):
            if differ:
                fail(f"{cid}: {len(differ)} trials decided differently by "
                     f"K1 and its plain version")
            continue
        target = get_target(plan.target)
        g_build, g_trial, _ = _generators(plan.seed)
        state = target.build(plan, g_build, device=dev)
        trials = target.draw(state, plan, g_trial, plan.samples, True)
        margins = eb_margins(state, plan, trials)
        window = [i for i, m in enumerate(margins) if abs(m) <= EB_ROUND_OFF]
        causes = {i: eb_split_cause(torch, dev, plan, trials[i])
                  for i in differ}
        row.update(in_window=len(window),
                   in_window_differ=len(set(window) & set(differ)),
                   margins_of_differing=[margins[i] for i in differ],
                   causes=causes)
        cap = max(1, int(EB_SPLIT_SHARE * plan.samples))
        if len(differ) > cap or not set(differ) <= set(window):
            fail(f"{cid}: K2 and its plain version decide trials {differ} "
                 f"differently, margins {row['margins_of_differing']} "
                 f"({len(window)} trials within {EB_ROUND_OFF} of the "
                 f"bound; at most {cap} may differ, all inside it)")
        for i, c in causes.items():
            if c["k2_flagged"] != bool(k.trials[i, 0]) or \
                    not c["k2_flags_are_its_formula"] or \
                    c["k2_rsum_off_f64_of_bound"] > EB_ROUND_OFF:
                fail(f"{cid}: trial {i}, decided differently by K2 and its "
                     f"plain version, is not a split of round-off: {c}")
    return out


def campaign_phase(torch, dev, out_dir) -> dict:
    """Phase 9: the port's quick, pallas (quick) and paper grids on the
    card through K1 and K2, at the JAX grids' sample counts and seed 0;
    every main-path cell of the two committed JAX baselines held to its
    baseline by overlapping Wilson intervals (detection and FP); the
    port's differ record at its default tolerances printed beside it;
    then K1 and K2 against their plain versions at every shape the grids
    hand them, and the kernel and plain runs of every cell that launches
    them, trial for trial."""
    from repro_torch.campaign import grids
    from repro_torch.campaign.artifacts import load_artifact
    from repro_torch.campaign.diff import (diff_artifacts, format_diff,
                                           wilson_gate)
    from repro_torch.campaign.executor import run_campaign

    wrappers = zero_launches()
    t0 = time.perf_counter()
    runs = {name: run_campaign(name, specs, device=dev, out_dir=out_dir)
            for name, specs in (
                ("quick", grids.quick_specs(seed=0)),
                ("pallas_quick", grids.pallas_specs(seed=0, quick=True)),
                ("paper", grids.paper_specs(seed=0)))}
    launches = read_launches(wrappers)
    seconds = time.perf_counter() - t0
    log(f"campaign grids on the card in {seconds:.1f}s: "
        + ", ".join(f"{k} {len(v['cells'])} cells" for k, v in runs.items())
        + f"; launches {launches}"
        + (f"; artifacts in {out_dir}" if out_dir else ""))
    if launches["abft_qgemm"] <= 0 or launches["abft_embeddingbag"] <= 0:
        fail(f"the campaign did not run through K1 and K2: {launches}")

    cells = {}
    for name, res in runs.items():
        for c in res["cells"]:
            m = c["metrics"]
            bd = m.get("overhead_breakdown") or {}
            cells[c["cell_id"] if name != "pallas_quick"
                  else "pallas:" + c["cell_id"]] = {
                "detection_rate": m["detection_rate"], "ci95": m["ci95"],
                "fp_rate": m["fp_rate"], "samples": m["samples"],
                "clean_samples": m["clean_samples"],
                "analytic_bound": m.get("analytic_bound"),
                "overhead": m.get("overhead"),
                "protected_ms": (m["protected_s"] * 1e3
                                 if m.get("protected_s") else None),
                "unprotected_ms": (m["unprotected_s"] * 1e3
                                   if m.get("unprotected_s") else None),
                "phases_ms": {k: v * 1e3 for k, v in bd.items()}}
            ov = m.get("overhead")
            log(f"  [{name}] {c['cell_id']}: detect "
                f"{m['detection_rate']:.4f} (n {m['samples']}, ci "
                f"{m['ci95'][0]:.4f}-{m['ci95'][1]:.4f}), fp "
                f"{m['fp_rate']:.4f} (n {m['clean_samples']})"
                + ("" if ov is None else
                   f", overhead {ov:+.4f} (protected "
                   f"{m['protected_s'] * 1e3:.4f} ms, unprotected "
                   f"{m['unprotected_s'] * 1e3:.4f} ms by CUDA events)")
                + ("" if not bd else "; phases ms " + ", ".join(
                    f"{k} {v * 1e3:.4f}" for k, v in bd.items())))

    gates = {}
    base_dir = ROOT / "benchmarks" / "baselines"
    for name, n_cells in (("pallas_quick", 7), ("quick", 13)):
        base = load_artifact(str(base_dir / f"BENCH_campaign_{name}.json"))
        gate = wilson_gate(base, runs[name])
        diff = diff_artifacts(base, runs[name])
        for line in format_diff(diff).splitlines():
            if line:
                log(f"  | {line}")
        overlap = {c["cell_id"]: c for c in gate["cells"]}
        det_regressed = sorted(r["cell_id"] for r in diff["regressions"]
                               if r["kind"] == "detection_rate")
        # the differ's verdict at det_tol 0.02 against the Wilson gate
        disagree = [cid for cid in overlap
                    if (cid in det_regressed)
                    == overlap[cid]["detection"]["overlap"]]
        log(f"  Wilson gate vs {name}: {len(gate['cells'])} cells, failed "
            f"{gate['failed']}, uncovered {gate['uncovered']}; differ at "
            f"det_tol 0.02 disagrees with the gate on {disagree}")
        gates[name] = {"failed": gate["failed"],
                       "uncovered": gate["uncovered"],
                       "differ_regressions": diff["regressions"],
                       "differ_disagrees_with_wilson": disagree,
                       "cells": gate["cells"]}
        if len(gate["cells"]) != n_cells or gate["failed"] or \
                gate["uncovered"] or diff["removed"]:
            fail(f"campaign vs the {name} baseline: {len(gate['cells'])} of "
                 f"{n_cells} cells gated, failing Wilson overlap: "
                 f"{gate['failed']}, left out: {gate['uncovered']}")
    t1 = time.perf_counter()
    plans = campaign_plans()
    shapes = kernels_at_campaign_shapes(torch, dev, plans)
    log(f"K1 and K2 against their plain versions at all {len(shapes)} "
        f"shapes the grids hand them ({time.perf_counter() - t1:.1f}s): "
        + "; ".join(shapes))
    t1 = time.perf_counter()
    tft = trial_for_trial(torch, dev, plans)
    gemm = [v for v in tft.values() if v["target"].startswith("gemm")]
    log(f"kernel vs plain, trial for trial on the card "
        f"({time.perf_counter() - t1:.1f}s): {len(gemm)} K1 cells, "
        f"{sum(v['trials'] + v['clean'] for v in gemm)} trials, every flag "
        f"equal; K2 cells: " + "; ".join(
            f"{cid}: {v['detected_kernel']}/{v['trials']} and "
            f"{v['detected_plain']}/{v['trials']} detected, "
            f"{v['in_window']} trials within round-off of the bound "
            f"({v['in_window'] - v['in_window_differ']} agree, "
            f"{v['in_window_differ']} differ: {v['differ']}, margins "
            f"{v['margins_of_differing']}, causes {v['causes']})"
            for cid, v in tft.items() if not v["target"].startswith("gemm")))
    return {"launches": launches, "seconds": seconds, "cells": cells,
            "gates": gates, "kernel_shapes": shapes, "trial_for_trial": tft,
            "quick_artifact": runs["quick"]}


#: the bound at which float32 round-off decides a clean bag's Eq. (5) flag
#: (ROADMAP §C2): the thresholds gate holds K2 to its own formula there
ROUND_OFF_BOUND = 1e-7


def thresholds_phase(torch, dev, out_dir) -> dict:
    """Phase 10: the port's ``thresholds`` grid on the card (15 EB cells,
    rel_bound 1e-7 to 1e-3, 400 faulty and 400 clean trials each, seed
    0), held to the committed JAX baseline by overlapping 95% Wilson
    intervals: detection in every cell, false positives at 1e-6 to 1e-3.
    At 1e-7 (ROADMAP §C2) round-off decides the clean bags, so the FP rate
    is printed beside the baseline's interval and the plain branch's, not
    gated against them; instead every trial of those cells is replayed
    through K2 and its flags held, bag for bag, to K2's own Eq. (5) formula
    on its own rsum (``ref.eb_check_slot_order``), and its decisions to
    the campaign's.  Returns the counts and the launches of the grid's
    run (counted from zero)."""
    from repro_torch.campaign import grids
    from repro_torch.campaign.artifacts import (load_artifact,
                                                threshold_curve,
                                                threshold_curve_markdown)
    from repro_torch.campaign.diff import wilson_gate
    from repro_torch.campaign.executor import (_generators, run_campaign,
                                               run_cell)
    from repro_torch.campaign.metrics import wilson_interval
    from repro_torch.campaign.spec import expand
    from repro_torch.campaign.targets import get_target, inject_, restore_
    from repro_torch.core.inject import signed_view
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda

    specs = grids.thresholds_specs(seed=0)
    wrappers = zero_launches()
    t0 = time.perf_counter()
    res = run_campaign("thresholds", specs, device=dev, out_dir=out_dir)
    launches = read_launches(wrappers)
    seconds = time.perf_counter() - t0
    if launches["abft_embeddingbag"] != 15 * 800:
        fail(f"the thresholds grid launched K2 "
             f"{launches['abft_embeddingbag']} times, not one per trial "
             f"(12000): {launches}")
    for line in threshold_curve_markdown(res).splitlines():
        log(f"  | {line}")
    base = load_artifact(str(ROOT / "benchmarks" / "baselines"
                             / "BENCH_campaign_thresholds.json"))
    gate = wilson_gate(base, res)
    if len(gate["cells"]) != 15 or gate["uncovered"]:
        fail(f"thresholds: {len(gate['cells'])} of 15 cells gated, "
             f"uncovered {gate['uncovered']}")
    failed = []
    for c in gate["cells"]:
        rb = float(c["cell_id"].rsplit("/rb", 1)[1])
        ok = c["detection"]["overlap"] and (
            rb == ROUND_OFF_BOUND or c["fp"]["overlap"])
        log(f"  thresholds {c['cell_id']}: detection card "
            f"{c['detection']['new']} vs JAX {c['detection']['old']}; FP "
            f"card {c['fp']['new']} vs JAX {c['fp']['old']}"
            + (" (not gated: §C2)" if rb == ROUND_OFF_BOUND else "")
            + ("" if ok else "  FAILED"))
        if not ok:
            failed.append(c["cell_id"])
    if failed:
        fail(f"thresholds cells outside the JAX baseline's intervals: "
             f"{failed}")

    round_off = {}
    plans = [p for p in expand(specs[0])[0] if p.rel_bound == ROUND_OFF_BOUND]
    for plan in plans:
        k = run_cell(plan, device=dev)
        p = run_cell(plan, device=dev, plain=True)
        target = get_target(plan.target)
        g_build, g_trial, g_clean = _generators(plan.seed)
        st = target.build(plan, g_build, device=dev)
        table, al, be, rs = st["enc"]
        runs = (("faulty", target.draw(st, plan, g_trial, plan.samples,
                                       True), k.trials[:, 0]),
                ("clean", target.draw(st, plan, g_clean,
                                      plan.clean_samples, False), k.clean))
        row = {}
        for kind, trials, decided in runs:
            rsums, flags = [], []
            for t in trials:
                undo, _ = inject_(signed_view(table), t.faults, 8)
                _, rsum, f, _ = abft_eb_cuda(
                    table[None], al[None], be[None], t.indices[None],
                    rs[None], rel_bound=plan.rel_bound)
                restore_(undo, 8)
                rsums.append(rsum[0])
                flags.append(f[0])
            rsum, flags = torch.stack(rsums), torch.stack(flags)
            idx = torch.stack([t.indices for t in trials])
            n = len(trials)
            mirror = ref.eb_check_slot_order(
                rsum, al.expand(n, -1), be.expand(n, -1), idx,
                rs.expand(n, -1), table.shape[-1],
                rel_bound=plan.rel_bound)
            if not torch.equal(flags, mirror):
                fail(f"{plan.cell_id} ({kind}): K2's flags differ from its "
                     f"own Eq. (5) formula on {int((flags != mirror).sum())}"
                     f" bags")
            if not torch.equal(flags.any(-1).cpu(), decided):
                fail(f"{plan.cell_id} ({kind}): the replay decided "
                     f"{int((flags.any(-1).cpu() != decided).sum())} trials "
                     f"otherwise than the campaign run")
            row[kind] = {"trials": n, "flagged": int(decided.sum()),
                         "bags_flagged": int(flags.sum())}
        fp_k, fp_p = int(k.clean.sum()), int(p.clean.sum())
        b = next(c for c in base["cells"] if c["cell_id"] == plan.cell_id)
        bm = b["metrics"]
        row.update(
            card_fp=fp_k / plan.clean_samples,
            card_fp_ci95=wilson_interval(fp_k, plan.clean_samples),
            plain_fp=fp_p / plan.clean_samples,
            plain_fp_ci95=wilson_interval(fp_p, plan.clean_samples),
            jax_fp=bm["fp_rate"],
            jax_fp_ci95=wilson_interval(bm["false_positives"],
                                        bm["clean_samples"]))
        round_off[plan.cell_id] = row
        log(f"  §C2 {plan.cell_id}: K2 FP {row['card_fp']:.4f} "
            f"{row['card_fp_ci95']}, plain branch {row['plain_fp']:.4f} "
            f"{row['plain_fp_ci95']}, JAX CPU baseline {row['jax_fp']:.4f} "
            f"{row['jax_fp_ci95']}; K2's flags equal its own formula on "
            f"its own rsum in all {row['faulty']['trials']} faulty and "
            f"{row['clean']['trials']} clean trials "
            f"({row['clean']['bags_flagged']} clean bags flagged)")
    log(f"thresholds grid on the card in {seconds:.1f}s: 15 cells gated "
        f"(detection 15, FP 12), launches {launches}")
    return {"launches": launches, "seconds": seconds, "gate": gate,
            "round_off": round_off, "curve": threshold_curve(res)}


#: an overhead median below this means the timing, not the check, is wrong
MIN_OVERHEAD = -0.05


def overhead_phase(torch, dev, timer) -> dict:
    """Phase 11: the paper's overhead benchmarks on the card
    (``repro_torch.benchmarks``): Fig. 5 over the 28 DLRM GEMM shapes and
    Table I over d 32-256 on 4M-row tables, each protected kernel against
    its own unprotected instance by CUDA events in alternating rounds.
    Both tables are printed in full; every cell must hold the unprotected
    result bit-exact to the protected kernel's (C's first n columns, R),
    and no median overhead may read below :data:`MIN_OVERHEAD`.  Then the
    two instances are held to their plain versions at every shape the
    benchmarks hand them and timed for the kernels line."""
    from repro_torch.benchmarks import eb_overhead, gemm_overhead
    from repro_torch.benchmarks.common import (F32_OPS_PER_S,
                                               INT8_OPS_PER_S, bound_ms)
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import eb_unprotected_cuda
    from repro_torch.kernels.abft_qgemm import qgemm_unprotected_cuda

    wrappers = zero_launches()
    t0 = time.perf_counter()
    gemm = gemm_overhead.run(dev, timer=timer)
    eb = eb_overhead.run(dev, timer=timer)
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    for line in (gemm_overhead.table(gemm) + "\n"
                 + eb_overhead.table(eb)).splitlines():
        log(f"  | {line}")
    bad = [r["shape"] for r in gemm if not r["exact"]] + \
        [(r["d"], r["mode"]) for r in eb if not r["exact"]]
    if bad:
        fail(f"an unprotected instance differs from its protected kernel "
             f"at {bad}")
    low = [(r["shape"], k, r[k]["median"]) for r in gemm
           for k in ("overhead_cold", "overhead_warm", "overhead_encode")
           if r[k]["median"] < MIN_OVERHEAD] + \
        [((r["d"], r["mode"]), "overhead", r["overhead"]["median"])
         for r in eb if r["overhead"]["median"] < MIN_OVERHEAD]
    if low:
        fail(f"a protected kernel timed faster than its unprotected "
             f"instance: {low}")
    log(f"overhead benchmarks in {seconds:.1f}s: {len(gemm)} GEMM shapes, "
        f"{len(eb)} EB cells; unprotected results bit-exact; launches "
        f"{launches}")
    if min(launches[k] for k in ("abft_qgemm", "abft_embeddingbag",
                                 "qgemm_unprotected", "eb_unprotected")) <= 0:
        fail(f"the overhead benchmarks did not run through their kernels: "
             f"{launches}")

    # the instances against their plain versions, at the benchmarks' shapes
    # and inputs, and timed for the kernels line (warm GEMM, cold EB)
    cases = []
    for m, n, k in gemm_overhead.GEMM_SHAPES:
        a, _, bp = gemm_overhead.operands(m, n, k, dev)
        cases.append((a, bp))
    for a, bp in cases:
        if not torch.equal(qgemm_unprotected_cuda(a, bp),
                           ref.qgemm_ref(a, bp)):
            fail(f"qgemm_unprotected differs from its plain version at "
                 f"{tuple(a.shape)} x {tuple(bp.shape)}")
    g_bytes = sum(gemm_overhead.unprotected_bytes(*r["shape"]) for r in gemm)
    g_ops = sum(2 * m * n * k for m, n, k in gemm_overhead.GEMM_SHAPES)
    eb_cases, eb_err, e_bytes, e_ops = [], 0.0, 0, 0
    for d in eb_overhead.DIMS:
        enc = eb_overhead.make_table(eb_overhead.ROWS, d, dev)
        gen = torch.Generator(device=dev).manual_seed(d + 1)
        for weighted in (False, True):
            idx = torch.randint(0, eb_overhead.ROWS, (1, eb_overhead.BATCH,
                                                      eb_overhead.POOL),
                                dtype=torch.int32, generator=gen,
                                device=dev)
            w = (torch.rand(idx.shape, generator=gen, device=dev) + 0.5
                 if weighted else None)
            args = (enc[0], enc[1], enc[2], idx, w)
            r = eb_unprotected_cuda(*args)
            if not torch.equal(r, ref.abft_eb_slot_order_ref(*args)):
                fail(f"eb_unprotected differs from the slot-order sum at "
                     f"d {d} ({'weighted' if weighted else 'regular'})")
            plain = ref.eb_ref(*args)
            err = float((r - plain).abs().max())
            scale = max(1.0, float(plain.abs().max()))
            if err > 1e-5 * eb_overhead.POOL * scale:
                fail(f"eb_unprotected off its plain version by {err} at d "
                     f"{d}")
            eb_err = max(eb_err, err)
            eb_cases.append(args)
            e_bytes += eb_overhead.unprotected_bytes(d, weighted)
            e_ops += 3 * eb_overhead.BATCH * eb_overhead.POOL * d

    def seq(fn, cs):
        return lambda: [fn(*c) for c in cs]

    try:
        library = timer.ms(seq(torch._int_mm, [
            gemm_overhead.int_mm_operands(a, bp) for a, bp in cases]), 10)
    except RuntimeError as e:
        log(f"torch._int_mm refused a padded Fig. 5 shape: {e}")
        library = None
    rows = [
        {"name": "qgemm_unprotected", "source":
         "src/repro_torch/csrc/abft_qgemm.cu", "replaces":
         "benchmarks/gemm_overhead.py:40", "max_abs_err": 0.0,
         "ms": timer.ms(seq(qgemm_unprotected_cuda, cases), 10),
         "plain_ms": timer.ms(seq(ref.qgemm_ref, cases), 5),
         "bound": bound_ms(g_bytes, g_ops, INT8_OPS_PER_S),
         "library_ms": library,
         "per": "the 28 Fig. 5 shapes, one launch each, uint8 A, warm"},
        {"name": "eb_unprotected", "source":
         "src/repro_torch/csrc/abft_embeddingbag.cu", "replaces":
         "src/repro/core/abft_embedding.py:61", "max_abs_err": eb_err,
         "ms": timer.ms(seq(eb_unprotected_cuda, eb_cases), 10),
         "plain_ms": timer.ms(seq(ref.eb_ref, eb_cases), 5),
         "bound": bound_ms(e_bytes, e_ops, F32_OPS_PER_S),
         "library_ms": None,
         "per": "the 8 Table I cells (d 32-256, regular and weighted), "
                "one launch each, 4M-row tables"}]
    return {"gemm": gemm, "eb": eb, "seconds": seconds, "rows": rows,
            "launches": launches}


def float_dlrm_phase(torch, dev, ex, tables) -> dict:
    """Phase 12: the full-width float DLRM (``init_dlrm(..., quant=False)``:
    float bottom and top MLPs over phase 3's 26 x 4M x 128 int8 tables,
    not a second set) on 8 batches of ``SyntheticDLRMDataset``.  With
    ``float_gemm`` on (each layer's row sums encoded once,
    ``encode_linear``): 0 errors on the clean batches; a high exponent bit
    of one ``top.0`` weight flipped in place is flagged with the rule on
    at ``top.0`` alone, and not with it on everywhere else; restored, 0
    errors again.  Then the model converted by ``quantize_dlrm``
    (``quantize_linear`` per layer) serves the same batches through K1-K3
    with 0 errors; the gap between the float and int8 CTR scores is
    printed.  Returns the figures and the int8 run's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.dlrm import CONFIG
    from repro_torch.core.inject import flip_bit_
    from repro_torch.core.policy import metrics_to_ints
    from repro_torch.data import DataConfig, SyntheticDLRMDataset
    from repro_torch.data.pipeline import to_device
    from repro_torch.layers.common import Ctx
    from repro_torch.layers.linear import apply_linear, encode_linear
    from repro_torch.models.dlrm import dlrm_forward, init_dlrm, \
        quantize_dlrm
    from repro_torch.protect import ProtectionPlan, default_plan

    t0 = time.perf_counter()
    p = init_dlrm(7, ex, quant=False, tables=tables, device=dev)
    p = dict(p, bottom=[encode_linear(lp) for lp in p["bottom"]],
             top=[encode_linear(lp) for lp in p["top"]])
    ds = SyntheticDLRMDataset(CONFIG, ShapeConfig("serve", "prefill", 1,
                                                  ex.batch),
                              DataConfig(seed=0))
    batches = [to_device(ds.batch_at(s), dev) for s in range(8)]
    f32 = torch.float32

    def ctx(plan, dtype=f32):
        return Ctx(plan=ProtectionPlan.parse(plan), compute_dtype=dtype)

    def run(params, c, which=None):
        out, counts = [], []
        for b in (batches if which is None else [batches[which]]):
            logit, rep = dlrm_forward(params, b["dense"], b["bags"], c, ex)
            out.append(logit.float())
            counts.append(metrics_to_ints(rep.as_metrics()))
        total = {k: sum(c_[k] for c_ in counts) for k in counts[0]}
        return torch.cat(out), total

    layers = len(ex.bottom_mlp) + len(ex.top_mlp)
    logit_f, clean = run(p, ctx("float_gemm:on"))
    if clean["abft/float_gemm_checks"] != 8 * layers or \
            clean["abft/float_gemm_errors"] or clean["abft/eb_errors"] or \
            not bool(torch.isfinite(logit_f).all()):
        fail(f"float DLRM, clean: {clean}")
    # the top.0 input column the flip meets: the bottom MLP's largest mean
    # output feature of the first batch (|x| well below the f32 range
    # times 2**128 of the flipped weight)
    x = batches[0]["dense"].float()
    for i, lp in enumerate(p["bottom"]):
        x, _ = apply_linear(lp, x, ctx("off"))
        x = torch.relu(x)
    k0 = int(x.mean(0).argmax())
    w = p["top"][0]["w"]
    at, bit = k0 * w.shape[1] + 3, 30
    if float(w.view(-1)[at].abs()) >= 2.0 or float(x[:, k0].max()) > 100:
        fail("float DLRM flip: the chosen weight or input is out of range")
    before = w.clone()
    flip_bit_(w, at, bit)
    _, at_top0 = run(p, ctx("float_gemm/top.0:on"), which=0)
    _, elsewhere = run(p, ctx("float_gemm:on,float_gemm/top.0:off"), which=0)
    flip_bit_(w, at, bit)
    if not torch.equal(w, before):
        fail("float DLRM flip: the weight was not restored")
    _, again = run(p, ctx("float_gemm:on"))
    if at_top0["abft/float_gemm_errors"] < 1 or \
            elsewhere["abft/float_gemm_errors"] or \
            again["abft/float_gemm_errors"]:
        fail(f"float DLRM flip of top.0.w[{k0}, 3] bit {bit}: errors with "
             f"the rule at top.0 {at_top0}, elsewhere {elsewhere}, after "
             f"the restore {again}")

    q = quantize_dlrm(p)
    wrappers = zero_launches()
    logit_q, served = run(q, Ctx(quant=True, plan=default_plan(),
                                 compute_dtype=torch.bfloat16))
    launches = read_launches(wrappers)
    if served["abft/qgemm_checks"] != 8 * layers or \
            served["abft/qgemm_errors"] or served["abft/eb_errors"] or \
            min(launches[k] for k in ("abft_qgemm", "abft_embeddingbag",
                                      "quantize_rows")) <= 0 or \
            not bool(torch.isfinite(logit_q).all()):
        fail(f"the int8 conversion of the float DLRM: {served}, launches "
             f"{launches}")
    ctr_f, ctr_q = torch.sigmoid(logit_f), torch.sigmoid(logit_q)
    gap = {"logit_max_abs": float((logit_f - logit_q).abs().max()),
           "logit_scale": float(logit_f.abs().max()),
           "ctr_max_abs": float((ctr_f - ctr_q).abs().max()),
           "ctr_mean_abs": float((ctr_f - ctr_q).abs().mean())}
    seconds = time.perf_counter() - t0
    log(f"float DLRM ({ex.n_tables} x {ex.table_rows} x {ex.emb_dim} tables "
        f"shared with phase 3) on 8 batches of {ex.batch} in "
        f"{seconds:.1f}s: float_gemm {clean['abft/float_gemm_checks']} "
        f"checks, 0 errors; top.0.w[{k0}, 3] bit {bit} flipped: "
        f"{at_top0['abft/float_gemm_errors']} rows flagged at top.0, 0 "
        f"elsewhere, 0 after the restore; int8 by quantize_linear through "
        f"K1-K3: {served['abft/qgemm_checks']} checks, 0 errors, launches "
        f"{launches}; float vs int8 CTR: max |d| {gap['ctr_max_abs']:.3g}, "
        f"mean {gap['ctr_mean_abs']:.3g} (logits max |d| "
        f"{gap['logit_max_abs']:.3g} of scale {gap['logit_scale']:.3g})")
    return {"seconds": seconds, "clean": clean, "flip": {
        "weight": f"top.0.w[{k0}, 3]", "bit": bit,
        "flagged_rows_at_top0": at_top0["abft/float_gemm_errors"]},
        "int8": served, "gap": gap, "launches": launches}


#: the kv_cache:on plan phase 13's second tenant serves under
KV_PLAN = "*:policy=recompute,kv_cache:on"


def llama_phase(torch, dev, timer) -> dict:
    """Phase 13: the full-width int8 Llama-3.2-1B (16 layers, d 2048, 32
    query and 8 KV heads of 64, d_ff 8192, vocab 128256; random weights
    from a seed) served on the card through K1-K3, with a bf16-cache
    tenant and a ``kv_cache:on`` tenant.  Returns the path's launch
    counts, its K1/K2 times and the record."""
    import dataclasses

    import numpy as np

    from repro_torch.benchmarks.common import (F32_OPS_PER_S,
                                               INT8_OPS_PER_S, bound_ms)
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.core import LANE
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.models.base import build_model
    from repro_torch.protect import ProtectionPlan, default_plan
    from repro_torch.serving import (FaultInjection, Request, ServingEngine,
                                     TenantSpec, chat_stream)

    cfg = get_arch("llama3.2-1b")
    kv_plan = dataclasses.replace(default_plan().with_rules(
        *ProtectionPlan.from_any(KV_PLAN).rules), name="kv")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, [TenantSpec("default", default_plan()),
                                 TenantSpec("kv", kv_plan)],
                           n_slots=4, max_prompt=64, max_new_tokens=32,
                           seed=0, device=dev)
    torch.cuda.synchronize()
    params = engine.params
    layers = params["layers"]
    int8 = [params["embed"]["table"], params["lm_head"]["w_packed"]] + [
        layers[blk][w]["w_packed"] for blk, ws in
        (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("gate", "up", "down")))
        for w in ws]
    log(f"{cfg.name} (d {cfg.d_model}, {cfg.n_layers} layers, vocab "
        f"{cfg.vocab}) on the card in {time.perf_counter() - t0:.1f}s: "
        f"{sum(t.numel() for t in int8) / 1e9:.2f} GB of int8 (packed) "
        f"weights and table; cache_len {engine.cache_len}")
    lanes = {lane.key: lane for lane in engine.lanes}
    if sorted(lanes) != ["lane0[default]", "lane1[kv]"]:
        fail(f"unexpected Llama lanes {sorted(lanes)}")

    # --------------- 13a. the kernels at the Llama path's shapes -----------
    gen = torch.Generator(device=dev).manual_seed(3)
    head = params["lm_head"]["w_packed"]
    # each GEMM shape with its weights of every layer, [layers, k, n + 128]
    gemms = [("attn.wq", layers["attn"]["wq"]["w_packed"], (64, 4)),
             ("attn.wk", layers["attn"]["wk"]["w_packed"], (64, 4)),
             ("mlp.gate", layers["mlp"]["gate"]["w_packed"], (64, 4)),
             ("mlp.down", layers["mlp"]["down"]["w_packed"], (64, 4)),
             ("lm_head", head[None], (1, 4))]
    checked = check_gemms(torch, dev, gen, gemms)
    log("Llama: K1 (C, err_rows, column check) and K3 (bf16 and f32) "
        "bit-exact at " + "; ".join(checked))
    hazards = pdl_hazards(torch, dev, gen, [
        ("lm_head m = 1", 1, head),
        ("attn.wq m = 4", 4, layers["attn"]["wq"]["w_packed"][-1]),
        ("mlp.down m = 64", 64, layers["mlp"]["down"]["w_packed"][1])])
    log("Llama: K1 under PDL bit-exact after K3, after an in-place flip of "
        "B', after K1 on the same scratch and after the correct repair at "
        + "; ".join(hazards))
    emb = params["embed"]
    enc4 = (emb["table"][None], emb["alphas"][None], emb["betas"][None],
            emb["rowsums"][None])
    req0 = Request(rid=0, tenant="default", arrival_s=0.0, prompt_len=64,
                   max_new_tokens=2, seed=5)
    prompt = torch.from_numpy(
        engine._chat_tokens(req0, 64).astype(np.int32)).to(dev)
    k2 = {"checks": {}, "times": {}}
    for n_bags in (64, 4):
        idx = prompt[:n_bags].reshape(1, -1, 1)
        label = f"{n_bags} tokens"
        k2["checks"][label] = eb_checks(torch, enc4, idx, label)
        # cold rows: each launch looks up fresh random tokens
        sets = [torch.randint(0, cfg.vocab, idx.shape, generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(16)]
        it = itertools.cycle(sets)
        (b_ms, b_by), (s_ms, _) = eb_bounds(idx, cfg.d_model)
        k2["times"][label] = {
            "ms": timer.ms(lambda: abft_eb_cuda(*enc4[:3], next(it),
                                                enc4[3]), 32),
            "plain_ms": timer.ms(lambda: kops.abft_embedding_bag(
                *enc4[:3], next(it), enc4[3], use_kernel=False), 8),
            "bound_ms": b_ms, "bound_by": b_by, "sector_bound_ms": s_ms}
    eb_pdl_hazards(torch, enc4, prompt.reshape(1, -1, 1))
    log(f"Llama: K2 on the {tuple(emb['table'].shape)} token table at pool "
        f"1 (64 and 4 bags): R bit-exact with the slot-order sum, flags "
        f"equal to the plain branch at rel_bound 1e-3 and 1e-5 and to its "
        f"formula at all three, under PDL after a table flip, an alpha "
        f"change and another K2; ms (cold) / plain / bound / sector bound: "
        + "; ".join(f"{k}: {v['ms']:.5f} / {v['plain_ms']:.4f} / "
                    f"{v['bound_ms']:.6f} / {v['sector_bound_ms']:.6f}"
                    for k, v in k2["times"].items()))

    scan = scan_token_table(torch, "Llama", emb)

    # ------------------- 13b. serve both tenants, then flips ---------------
    def stream(n, seed):
        return chat_stream(n, tenants={"default": 1.0, "kv": 1.0},
                           rate_rps=100.0, seed=seed, mean_prompt=32,
                           max_prompt=64, mean_output=16, max_output=32)

    wrappers = zero_launches()
    tel = engine.run(stream(8, 0))            # the warm-up runs inside
    launches = read_launches(wrappers)
    s = tel.summary()
    counters = s["faults"]["counters"]
    per = s["per_tenant"]
    steps = {(kind, key): [ev.duration_s * 1e3 for ev in tel.steps
                           if ev.kind == kind and ev.lane == key]
             for kind in ("prefill", "decode") for key in lanes}
    log(f"Llama: served {sum(p['requests'] for p in per.values())} chat "
        f"requests over two tenants: "
        + "; ".join(f"{t}: {p['completed']} completed, {p['tokens_out']} "
                    f"tokens" for t, p in per.items())
        + f"; steps {[(k, len(v)) for k, v in steps.items()]}; launches "
        f"{launches}; counters { {k: v for k, v in counters.items() if v} }")
    if sum(p["completed"] for p in per.values()) != 8 or \
            any(p["aborted"] for p in per.values()):
        fail(f"not every Llama request completed: {per}")
    nonzero = {k: v for k, v in counters.items()
               if v and not k.endswith("_checks")}
    if nonzero:
        fail(f"fault counters on a clean Llama run: {nonzero}")
    n_steps = len(tel.steps)
    per_step_gemms = cfg.n_layers * 7 + 1
    kv_reads = cfg.n_layers * len(steps[("decode", "lane1[kv]")])
    if counters["qgemm_checks"] != per_step_gemms * n_steps or \
            counters["embedding_bag_checks"] != n_steps or \
            counters["kv_cache_checks"] != kv_reads:
        fail(f"unexpected check counts {counters} for {n_steps} steps")
    # the warm-up ran one prefill and one decode step a lane in the window
    want_l = {"abft_qgemm": per_step_gemms * (n_steps + 4),
              "quantize_rows": per_step_gemms * (n_steps + 4),
              "abft_embeddingbag": n_steps + 4, "wkv6_chunked": 0,
              "qgemm_unprotected": 0, "eb_unprotected": 0}
    if launches != want_l:
        fail(f"launches {launches} differ from the path's {want_l}")
    toks = [t for r in tel.requests for t in (r.tokens or [])]
    if len(toks) != sum(p["tokens_out"] for p in per.values()) or \
            not all(0 <= t < cfg.vocab for t in toks):
        fail("served Llama tokens outside the vocabulary or missing")
    serve = {"tenants": per, "launches": launches, "counters": counters,
             "steps_ms": {f"{k} {key}": v for (k, key), v in steps.items()},
             "step_ms_median": {f"{k} {key}": float(np.median(v))
                                for (k, key), v in steps.items()},
             "decode_occupancy_mean": s["decode_occupancy_mean"]}

    def request(rid, tenant, seed, new):
        return Request(rid=rid, tenant=tenant, arrival_s=0.0, prompt_len=64,
                       max_new_tokens=new, seed=seed)

    # a transient flip of an attn.wq payload bit at the first decode-only
    # step of a default-tenant request: flagged at that step only, the
    # leaf bit-identical afterwards
    wq = layers["attn"]["wq"]["w_packed"]
    engine.reset_state()
    fp0 = leaf_fingerprint(torch, wq)
    tel = engine.run([request(0, "default", 3, 3)], inject=[FaultInjection(
        step=1, victim="attn.wq", seed=0)], warmup=False)
    flips = {"weight": check_injection(tel, 1, [1], fp0,
                                       leaf_fingerprint(torch, wq),
                                       "Llama attn.wq flip")}
    # a flip of an int8 KV payload bit in a prompt row of the kv tenant's
    # resident request: flagged at the next decode step and at every later
    # one while the request holds its slot, once a read (recompute reads
    # the same row again and counts a retry)
    engine.reset_state()
    tel = engine.run([request(1, "kv", 3, 4)], inject=[FaultInjection(
        step=1, target="kv", seed=0)], warmup=False)
    (inj,) = tel.injections
    flagged = [ev for ev in tel.steps if ev.errors]
    if not inj.detected or inj.detect_step != 1 or \
            not inj.victim.startswith("kv_row/") or \
            [ev.step for ev in flagged] != [1, 2] or \
            any(ev.kind != "decode" or ev.counters["kv_cache_errors"] != 1
                or ev.counters["qgemm_errors"] for ev in flagged):
        fail(f"Llama KV flip {inj}: flagged steps "
             f"{[(ev.step, ev.kind, ev.counters) for ev in flagged]}")
    flips["kv"] = {"victim": inj.victim, "step": inj.step,
                   "detect_step": inj.detect_step,
                   "flagged_steps": [ev.step for ev in flagged],
                   "counters": tel.summary()["faults"]["counters"]}
    engine.reset_state()
    tel = engine.run([request(2, "kv", 3, 4), request(3, "default", 4, 4)],
                     warmup=False)
    c_clean = tel.summary()["faults"]["counters"]
    if c_clean["qgemm_errors"] or c_clean["kv_cache_errors"] or \
            c_clean["embedding_bag_errors"]:
        fail(f"errors after the Llama flips: {c_clean}")
    flips["clean_after"] = c_clean
    log(f"Llama FaultInjection: {flips['weight']['victim']} flagged at step "
        f"{flips['weight']['detect_step']} only and restored bit for bit; "
        f"{flips['kv']['victim']} flagged at steps "
        f"{flips['kv']['flagged_steps']}, one kv_cache error a read "
        f"({flips['kv']['counters']['retries']} retries); clean requests "
        f"after the reset: no errors")

    # -------------- 13c. the smoke-size LM, card against CPU ---------------
    # a code split moves the attention's softmax further than RWKV's
    # recurrence: after one, a free float32 run is held to the CPU tests'
    # 2**-5 for such runs (tests/test_torch_lm.py, _SPLIT_TOL); lockstep
    # stays at 1e-4
    small = reduce_cfg(cfg)
    model = build_model(small)
    small_out = small_card_vs_cpu(torch, dev, small, model,
                                  model.init(0, quant=True, device="cpu"),
                                  default_plan(), (64, 24),
                                  f32_after_split=2.0**-5)

    # ------------------------------ 13d. times ------------------------------
    # K1 at each GEMM shape of a Llama step, cold (each call takes the next
    # layer's slice; the head's 263 MB is cold by size), beside
    # torch._int_mm on the same cold weights padded to n + 1 -> a multiple
    # of 8 columns and to m = 32 rows, and the byte bound; K3 at each shape
    per_shape = {}
    for name, stack, ms_ in gemms:
        k, n = stack.shape[1], stack.shape[2] - LANE
        n8 = -(-(n + 1) // 8) * 8
        padded = [w[:, :n8].contiguous() for w in stack]
        for m in ms_:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            q = quantize_rows_cuda(x)[0]
            a_pad = torch.zeros((max(m, 32), k), dtype=torch.int8,
                                device=dev)
            a_pad[:m] = q
            cold = itertools.cycle(list(stack))
            cold_pad = itertools.cycle(padded)
            reps = 2 * len(stack) if len(stack) > 1 else 10
            kb = m * k + k * (n + 1) + 4 * m * n + 4 * m
            b_ms, b_by = bound_ms(kb, 2 * m * k * (n + 1), INT8_OPS_PER_S)
            row = {
                "abft_qgemm_cold_ms": timer.ms(
                    lambda: abft_qgemm_cuda(q, next(cold)), reps),
                "plain_ms": timer.ms(
                    lambda: ref.abft_qgemm_ref(q, next(cold)), 4),
                "library_cold_ms": timer.ms(
                    lambda: torch._int_mm(a_pad, next(cold_pad)), reps),
                "abft_qgemm_bound_ms": b_ms, "bound_by": b_by,
                "quantize_rows_bf16_ms": timer.ms(
                    lambda: quantize_rows_cuda(x)),
                "quantize_rows_bound_ms": bound_ms(
                    2 * m * k + m * k + 8 * m, 6 * m * k, F32_OPS_PER_S)[0]}
            row["bound_share"] = b_ms / row["abft_qgemm_cold_ms"]
            per_shape[f"{name} m={m} k={k} n={n}"] = row
        del padded
    log("Llama K1 per shape, ms cold / torch._int_mm cold / plain / bound "
        "(share); K3 bf16 ms / bound: " + "; ".join(
            f"{k_}: {v['abft_qgemm_cold_ms']:.4f} / "
            f"{v['library_cold_ms']:.4f} / {v['plain_ms']:.4f} / "
            f"{v['abft_qgemm_bound_ms']:.5f} ({v['bound_share']:.2f}); "
            f"{v['quantize_rows_bf16_ms']:.4f} / "
            f"{v['quantize_rows_bound_ms']:.6f}"
            for k_, v in per_shape.items()))
    # the kv_cache:on lane under the log policy, on the same weights (one
    # seed) and the kv tenant's requests: what recompute's host read of
    # every protected call's count costs a step
    log_plan = dataclasses.replace(default_plan().with_rules(
        *ProtectionPlan.from_any("kv_cache:on").rules), name="kv")
    eng_log = ServingEngine(cfg, [TenantSpec("kv", log_plan)], n_slots=4,
                            max_prompt=64, max_new_tokens=32, seed=0,
                            device=dev)
    reqs = [r for r in stream(8, 0) if r.tenant == "kv"]
    tel_log = eng_log.run(reqs)
    serve["kv_log_policy_step_ms_median"] = {
        kind: float(np.median([ev.duration_s * 1e3 for ev in tel_log.steps
                               if ev.kind == kind]))
        for kind in ("prefill", "decode")}
    if tel_log.summary()["faults"]["counters"]["kv_cache_errors"]:
        fail("kv_cache errors on a clean log-policy run")
    del eng_log
    prof_reqs = [request(i, "default", 40 + i, 4) for i in range(4)]
    engine.reset_state()
    serve["profile"] = profile_requests(torch, engine, prof_reqs)
    med = serve["step_ms_median"]
    log("Llama serve: step medians ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in med.items())
        + "; the kv_cache:on lane under log, on the kv tenant's requests: "
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    serve["kv_log_policy_step_ms_median"].items())
        + f"; TTFT p50 " + ", ".join(
            f"{t} {p['ttft_ms']['p50']:.2f}" for t, p in per.items())
        + " ms; per token p50 " + ", ".join(
            f"{t} {p['per_token_ms']['p50']:.2f}" for t, p in per.items())
        + " ms")
    record = {"serve": serve, "k2": k2, "flips": flips,
              "gemm_shapes": per_shape, "small_card_vs_cpu": small_out,
              "eb_table_scan": scan}
    return {"launches": launches, "record": record,
            "k1_times": per_shape, "k2_times": k2["times"],
            "params": params}


#: phase 14's two paged tenants (each its own lane and pool) and the
#: contiguous plan its tokens are held against
PAGED_PLANS = {"log": "*:policy=log,kv_cache_paged:on",
               "rec": "*:policy=recompute,kv_cache_paged:on"}
CONTIG_PLAN = "*:policy=log,kv_cache:on"
#: the paged and the contiguous int8 cache hold the same codes, but their
#: attention sums run over other lengths and orders, and a last-bit
#: difference can land across a bf16 or int8 rounding split: their
#: logits (and a rebuilt request's against its clean pass) are held to
#: the LM tests' allowance for a split, 2**-5 of the logit scale
#: (tests/test_torch_lm.py, _SPLIT_TOL), and their greedy tokens equal
#: wherever the top-two margin exceeds twice that
PAGED_LOGIT_TOL = 2.0**-5
#: the baseline's figures phase 14 prints beside the card's
#: (benchmarks/baselines/BENCH_campaign_paging_quick.json)
PAGING_BASELINE = "benchmarks/baselines/BENCH_campaign_paging_quick.json"


class LogitTap:
    """Records the logits of a model's prefill and decode calls, which the
    engine's steps reduce to greedy tokens: ``calls`` holds (kind, plan
    name, logits on the host) per call, while the tap is entered."""

    def __init__(self, model):
        self.model = model
        self.calls = []

    def __enter__(self):
        prefill, decode = self.model.prefill, self.model.decode

        def tapped_prefill(params, batch, ctx, cache_len):
            out = prefill(params, batch, ctx, cache_len)
            self.calls.append(("prefill", ctx.plan.name,
                               out[0].float().cpu()))
            return out

        def tapped_decode(params, cache, tokens, pos, ctx):
            out = decode(params, cache, tokens, pos, ctx)
            self.calls.append(("decode", ctx.plan.name,
                               out[0].float().cpu()))
            return out

        self.model.prefill, self.model.decode = tapped_prefill, tapped_decode
        return self

    def __exit__(self, *exc):
        del self.model.prefill, self.model.decode

    def per_request(self, plan_name: str, tokens: dict,
                    vocab: int) -> dict:
        """Each request's logits, step by step, on one lane whose requests
        arrived together: the prefills run in request-id order; a
        request's decode rows are the slot whose greedy tokens are its
        own."""
        calls = [c for c in self.calls if c[1] == plan_name]
        pre = [c[2][0] for c in calls if c[0] == "prefill"]
        dec = [c[2] for c in calls if c[0] == "decode"]
        out = {}
        for i, rid in enumerate(sorted(tokens)):
            toks = tokens[rid]
            rows = dec[:len(toks) - 1]
            greedy = [[int(d[s, :vocab].argmax()) for d in rows]
                      for s in range(dec[0].shape[0])]
            slot = greedy.index(list(toks[1:]))
            out[rid] = [pre[i]] + [d[slot] for d in rows]
        return out


def compare_logits(torch, want_steps, got_steps, want_tokens, got_tokens,
                   vocab: int, what: str) -> dict:
    """Two runs of one request held step by step: logits within
    :data:`PAGED_LOGIT_TOL` of the reference's scale and greedy tokens
    equal wherever the reference's top-two margin exceeds twice that.  A
    token that differs where the margin does not (a rounding split) ends
    the comparison: the histories part there."""
    worst, compared, split = 0.0, 0, None
    for i, (w, g) in enumerate(zip(want_steps, got_steps)):
        w, g = w[:vocab], g[:vocab]
        scale = float(w.abs().max())
        err = float((g - w).abs().max()) / scale
        top2 = torch.topk(w, 2).values
        margin = float(top2[0] - top2[1]) / scale
        worst = max(worst, err)
        compared += 1
        if err > PAGED_LOGIT_TOL:
            fail(f"{what}: logits at step {i} differ by {err:.3g} of the "
                 f"scale (> {PAGED_LOGIT_TOL})")
        if i < len(want_tokens) and want_tokens[i] != got_tokens[i]:
            if margin > 2 * PAGED_LOGIT_TOL:
                fail(f"{what}: token {i} differs ({got_tokens[i]} vs "
                     f"{want_tokens[i]}) at a top-two margin of "
                     f"{margin:.3g} of the scale")
            split = {"step": i, "margin": margin}
            break
    return {"steps_compared": compared, "max_err": worst, "split": split}


def kv_seed_for_bit(bits) -> int:
    """The first ``FaultInjection(target="kv")`` seed whose flip, on an
    engine with one occupied lane and one resident request, lands on a
    bit in ``bits``, by the draw order the engine documents (lane, slot,
    pool, then the bit: ``ServingEngine._apply_kv_injection``).  The
    caller reads the bit back from the recorded victim
    (:func:`victim_bit`), so a change to that order fails the phase
    rather than moving its flip."""
    import numpy as np
    for seed in itertools.count():
        rng = np.random.default_rng(seed)
        rng.integers(1)
        rng.integers(1)
        rng.integers(2)
        if int(rng.integers(8)) in bits:
            return seed


def victim_bit(victim: str) -> int:
    """The flipped bit of a KV victim string (``...d<col>b<bit>``)."""
    return int(victim.rsplit("b", 1)[1])


def llama_paged_phase(torch, dev, timer, contig_step_ms: dict,
                      out_dir) -> dict:
    """Phase 14: full-width int8 Llama-3.2-1B served from paged,
    prefix-shared, page-checksummed KV pools (``PagingConfig(page_size=16,
    n_pages=26)``), a log and a recompute tenant, then the ``paging``
    quick grid gated against its JAX baseline.  Returns the path's launch
    counts and the record."""
    import dataclasses

    import numpy as np

    from repro_torch.campaign.diff import diff_artifacts, wilson_gate
    from repro_torch.configs import get_arch
    from repro_torch.paging import PagingConfig, pool_page_bytes, scrub_cache
    from repro_torch.protect import ProtectionPlan, default_plan
    from repro_torch.serving import (FaultInjection, Request, ServingEngine,
                                     TenantSpec, chat_stream)
    from repro_torch.serving.paging_soak import (_tree_nbytes,
                                                 run_paging_campaign)

    cfg = get_arch("llama3.2-1b")
    vocab, n_layers = cfg.vocab, cfg.n_layers

    def plan(name, text):
        return dataclasses.replace(default_plan().with_rules(
            *ProtectionPlan.from_any(text).rules), name=name)

    t0 = time.perf_counter()
    paging = PagingConfig(page_size=16, n_pages=26)
    engine = ServingEngine(cfg, [TenantSpec(k, plan(k, v))
                                 for k, v in PAGED_PLANS.items()],
                           n_slots=4, max_prompt=64, max_new_tokens=32,
                           seed=0, paging=paging, device=dev)
    contig = ServingEngine(cfg, [TenantSpec("log", plan("log",
                                                        CONTIG_PLAN))],
                           n_slots=4, max_prompt=64, max_new_tokens=32,
                           seed=0, device=dev)
    torch.cuda.synchronize()
    lanes = {lane.key: lane for lane in engine.lanes}
    if sorted(lanes) != ["lane0[log]", "lane1[rec]"]:
        fail(f"unexpected paged Llama lanes {sorted(lanes)}")
    max_pages = {lane.pager.max_pages for lane in engine.lanes}
    if max_pages != {(64 + 32 - 1) // 16 + 1} or engine.cache_len != 104:
        fail(f"paged slots map {max_pages} pages, cache_len "
             f"{engine.cache_len}")
    log(f"paged Llama engines (two lanes, and a contiguous kv_cache:on "
        f"one) on the card in {time.perf_counter() - t0:.1f}s")

    # ---------------- 14a. serve both tenants from the pools ---------------
    prefix_seed = 0x5EED

    def stream(n, seed):
        return chat_stream(n, tenants={"log": 1.0, "rec": 1.0},
                           rate_rps=100.0, seed=seed, mean_prompt=32,
                           max_prompt=64, mean_output=16, max_output=32,
                           prefix_len=32, prefix_seed=prefix_seed)

    wrappers = zero_launches()
    reqs = stream(8, 0)
    tel = engine.run(reqs)                    # the warm-up runs inside
    launches = read_launches(wrappers)
    s = tel.summary()
    counters = s["faults"]["counters"]
    per = s["per_tenant"]
    stats = engine.paging_stats()
    log(f"paged Llama: served {sum(p['requests'] for p in per.values())} "
        f"chat requests: "
        + "; ".join(f"{t}: {p['completed']} completed, {p['tokens_out']} "
                    f"tokens, {p['shared_prefix_tokens']} prefix tokens "
                    f"shared" for t, p in per.items())
        + f"; launches {launches}; counters "
        f"{ {k: v for k, v in counters.items() if v} }; paging "
        + "; ".join(f"{k}: resident {v['pages_resident']}, high-water "
                    f"{v['pages_high_water']}, prefix hit "
                    f"{v['prefix_hit_rate']:.2f}, evictions "
                    f"{v['page_evictions']}" for k, v in stats.items()))
    if sum(p["completed"] for p in per.values()) != 8 or \
            any(p["aborted"] for p in per.values()):
        fail(f"not every paged Llama request completed: {per}")
    nonzero = {k: v for k, v in counters.items()
               if v and not k.endswith("_checks")}
    if nonzero:
        fail(f"fault counters on a clean paged Llama run: {nonzero}")
    n_steps = len(tel.steps)
    per_step_gemms = n_layers * 7 + 1
    if counters["qgemm_checks"] != per_step_gemms * n_steps or \
            counters["embedding_bag_checks"] != n_steps or \
            counters["kv_cache_paged_checks"] <= 0 or \
            counters["kv_cache_checks"]:
        fail(f"unexpected check counts {counters} for {n_steps} steps")
    # the warm-up ran one prefill and one decode step a lane in the window
    want_l = {"abft_qgemm": per_step_gemms * (n_steps + 4),
              "quantize_rows": per_step_gemms * (n_steps + 4),
              "abft_embeddingbag": n_steps + 4, "wkv6_chunked": 0,
              "qgemm_unprotected": 0, "eb_unprotected": 0}
    if launches != want_l:
        fail(f"launches {launches} differ from the path's {want_l}")
    # K1 and K3 at the shapes this path hands them: a paged lane prefills
    # at the request's page-multiple bucket (and rebuilds at it), not at
    # phase 13's 64, so every bucket of the stream, and 32 and 48 whatever
    # the draw, at each Llama projection; decode (m = 4) and the head (m
    # = 1 and 4) are phase 13's shapes
    buckets = sorted({engine._bucket_of(r) for r in reqs})
    ms_ = tuple(sorted(set(buckets) | {32, 48}, reverse=True))
    layers = engine.params["layers"]
    checked = check_gemms(
        torch, dev, torch.Generator(device=dev).manual_seed(14),
        [(f"{blk}.{w}", layers[blk][w]["w_packed"], ms_)
         for blk, w in (("attn", "wq"), ("attn", "wk"), ("mlp", "gate"),
                        ("mlp", "down"))])
    log(f"paged Llama: prefill buckets {buckets}; K1 (C, err_rows, column "
        f"check) and K3 (bf16 and f32) bit-exact at " + "; ".join(checked))
    hits = sum(v["prefix_hits"] for v in stats.values())
    shared = sum(p["shared_prefix_tokens"] for p in per.values())
    if hits <= 0 or shared <= 0:
        fail(f"no prefix page was shared: {stats}")
    # verify work per decode token: pages the reads touched (both pools,
    # every layer) against the rows a contiguous kv_cache:on lane verifies
    # at the same tokens (both pools, every layer, its 64-token bucket
    # and the tokens so far)
    dtoks = sum(ev.occupancy for ev in tel.steps if ev.kind == "decode")
    pages_per_token = counters["kv_cache_paged_checks"] / dtoks
    rows = [n_layers * 2 * (64 + g) for r in tel.requests
            for g in range(1, r.tokens_out)]
    rows_per_token = sum(rows) / len(rows)
    if not 0 < pages_per_token < rows_per_token:
        fail(f"pages verified per decode token {pages_per_token:.2f} not "
             f"below the contiguous rows {rows_per_token:.2f}")
    # pool sizing, from the code: one page of both pools, the whole pool,
    # and the contiguous kv_cache:on layout at cache_len 104
    attn = engine.lanes[0].cache["attn"]
    page_bytes = pool_page_bytes(attn["k"]) + pool_page_bytes(attn["v"])
    want_page = 2 * (16 * 8 * 16 * 64 + 2 * 16 * 8 * 16 * 4 + 16 * 8 * 4)
    contig.run([Request(rid=0, tenant="log", arrival_s=0.0, prompt_len=64,
                        max_new_tokens=2, seed=1)])
    contig_bytes = _tree_nbytes(contig.lanes[0].cache)
    want_contig = 2 * 16 * 4 * 8 * 104 * (64 + 3 * 4)
    if page_bytes != want_page or contig_bytes != want_contig or \
            not 26 * page_bytes < contig_bytes:
        fail(f"pool sizing: a page {page_bytes} B (want {want_page}), the "
             f"contiguous cache {contig_bytes} B (want {want_contig})")
    # the pools are written in place: no decode step copies them
    ptrs = {k: v.q.data_ptr() for k, v in attn.items()}
    engine.run([Request(rid=50, tenant="log", arrival_s=0.0, prompt_len=64,
                        max_new_tokens=3, seed=50, prefix_len=32,
                        prefix_seed=prefix_seed)], warmup=False)
    if {k: v.q.data_ptr() for k, v in
            engine.lanes[0].cache["attn"].items()} != ptrs:
        fail("a paged decode step reallocated its pools")
    steps = {(kind, key): [ev.duration_s * 1e3 for ev in tel.steps
                           if ev.kind == kind and ev.lane == key]
             for kind in ("prefill", "decode") for key in lanes}
    serve = {"tenants": per, "launches": launches, "counters": counters,
             "paging_stats": stats, "prefill_buckets": buckets,
             "k1_k3_checked": checked, "steps_ms": {
                 f"{k} {key}": v for (k, key), v in steps.items()},
             "step_ms_median": {f"{k} {key}": float(np.median(v))
                                for (k, key), v in steps.items() if v},
             "pages_verified_per_decode_token": pages_per_token,
             "contig_rows_verified_per_decode_token": rows_per_token,
             "page_bytes_both_pools": page_bytes,
             "pool_bytes": 26 * page_bytes,
             "contig_cache_bytes": contig_bytes,
             # a contiguous decode step clones every layer's cache leaves
             # (set_rows) and stacks them anew (stack_layers); a paged one
             # writes its new rows into the pools and pushes the table
             "contig_bytes_copied_per_decode_step": 2 * contig_bytes,
             "paged_pool_bytes_copied_per_decode_step": 0,
             "paged_bytes_written_per_decode_step": {
                 "rows": n_layers * 2 * 4 * 8 * (64 + 3 * 4),
                 "table": 4 * 6 * 4}}
    log(f"paged Llama: {pages_per_token:.2f} pages verified per decode token "
        f"(both pools, all layers) against the contiguous lane's "
        f"{rows_per_token:.1f} rows; a page of both pools {page_bytes} B by "
        f"pool_page_bytes ({want_page} B by the arithmetic), the pool of 26 "
        f"{26 * page_bytes} B, the contiguous kv_cache:on cache at cache_len "
        f"104 {contig_bytes} B ({want_contig} B by the arithmetic); a decode "
        f"step copies no pool (the contiguous lane copies "
        f"{2 * contig_bytes} B a step)")

    # ---------- 14b. the same requests through the contiguous cache --------
    # four 64-token requests (the bucket of both layouts) admitted at once
    # into slots 0-3 of each engine's log lane, retired together
    def cmp_reqs(base):
        return [Request(rid=base + i, tenant="log", arrival_s=0.0,
                        prompt_len=64, max_new_tokens=16, seed=base + i,
                        prefix_len=32, prefix_seed=prefix_seed)
                for i in range(4)]

    engine.reset_state()
    contig.reset_state()
    with LogitTap(engine.model) as tap_p:
        tel_p = engine.run(cmp_reqs(100), warmup=False)
    with LogitTap(contig.model) as tap_c:
        tel_c = contig.run(cmp_reqs(100), warmup=False)
    tok_p = {r.rid: r.tokens for r in tel_p.requests}
    tok_c = {r.rid: r.tokens for r in tel_c.requests}
    want = tap_c.per_request("log", tok_c, vocab)
    got = tap_p.per_request("log", tok_p, vocab)
    versus = {rid: compare_logits(torch, want[rid], got[rid], tok_c[rid],
                                  tok_p[rid], vocab,
                                  f"paged vs contiguous request {rid}")
              for rid in sorted(want)}
    if any(e.errors for e in tel_p.steps + tel_c.steps):
        fail("errors on the paged-vs-contiguous requests")
    log("paged vs contiguous kv_cache:on, 4 requests x 16 tokens: "
        + "; ".join(f"rid {k}: {v['steps_compared']} steps, logits within "
                    f"{v['max_err']:.2g} of the scale, split "
                    f"{v['split']}" for k, v in versus.items())
        + f" (tolerance {PAGED_LOGIT_TOL}, tokens held where the margin "
          f"exceeds twice it)")

    # ------------- 14c. a page flip on the log lane: flagged -------------
    def alone(rid, tenant, new):
        return [Request(rid=rid, tenant=tenant, arrival_s=0.0,
                        prompt_len=64, max_new_tokens=new, seed=rid,
                        prefix_len=32, prefix_seed=prefix_seed)]

    engine.reset_state()
    tel = engine.run(alone(200, "log", 5), inject=[FaultInjection(
        step=1, target="kv", persistent=True, seed=0)], warmup=False)
    (inj,) = tel.injections
    flagged = [ev for ev in tel.steps if ev.errors]
    if not inj.detected or inj.detect_step != 1 or \
            not inj.victim.startswith("kv_page/") or \
            [ev.step for ev in flagged] != [1, 2, 3] or \
            any(ev.kind != "decode"
                or ev.counters["kv_cache_paged_errors"] != 1
                or ev.counters["qgemm_errors"] for ev in flagged):
        fail(f"paged log-lane flip {inj}: flagged steps "
             f"{[(ev.step, ev.kind, ev.counters) for ev in flagged]}")
    flips = {"log": {"victim": inj.victim, "detect_step": inj.detect_step,
                     "flagged_steps": [ev.step for ev in flagged]}}

    # ----- 14d. a page flip on the recompute lane: evicted and rebuilt -----
    # the paged read runs under a forced log rule and the repair comes
    # after the step (JAX semantics): the detecting step's token, and the
    # K/V rows it appends to the decode-tail page in the layers past the
    # flip, come from the corrupt read and are kept.  A flip of bit <= 2
    # moves no token there, and the rebuilt request is held to its clean
    # pass at every step; a sign-bit flip (bit 7) is held from the first
    # step after the repair (the kept tail rows within the tolerance),
    # where the detecting step's token left the history the clean pass's,
    # and otherwise the parting is recorded
    engine.reset_state()
    with LogitTap(engine.model) as tap_clean:
        clean = engine.run(alone(300, "rec", 8), warmup=False)
    tok_clean = {r.rid: r.tokens for r in clean.requests}
    want = tap_clean.per_request("rec", tok_clean, vocab)[300]
    want_t = tok_clean[300]
    for key, bits in (("rec", range(3)), ("rec_bit7", (7,))):
        seed = kv_seed_for_bit(bits)
        engine.reset_state()
        with LogitTap(engine.model) as tap_bad:
            tel = engine.run(alone(300, "rec", 8), inject=[FaultInjection(
                step=1, target="kv", persistent=True, seed=seed)],
                warmup=False)
        (inj,) = tel.injections
        st = engine.paging_stats()["lane1[rec]"]
        summ = tel.summary()["per_tenant"]["rec"]
        rebuilt = [ev for ev in tel.steps if ev.kind == "rebuild"]
        flagged = [ev.step for ev in tel.steps if ev.errors]
        if victim_bit(inj.victim) not in bits:
            fail(f"KV flip seed {seed} drew {inj.victim}, not a bit in "
                 f"{list(bits)}: the engine's draw order changed")
        if not inj.detected or inj.detect_step != 1 or flagged != [1] or \
                st["page_rebuilds"] < 1 or not rebuilt or \
                summ["aborted"] or summ["completed"] != 1:
            fail(f"paged recompute-lane flip {inj}: flagged {flagged}, "
                 f"stats {st}, tenant {summ}")
        # the rebuild's prefill comes after the request's own
        got = tap_bad.per_request("rec", {300: tel.requests[0].tokens},
                                  vocab)[300]
        got_t = tel.requests[0].tokens
        # the detecting step's logits: the request's prefill, then one
        # row a decode step
        d = 1 + [ev.errors > 0 for ev in tel.steps
                 if ev.kind == "decode"].index(True)
        wd, gd = want[d][:vocab], got[d][:vocab]
        rec = {"victim": inj.victim, "seed": seed,
               "detect_step": inj.detect_step,
               "page_rebuilds": st["page_rebuilds"],
               "rebuild_ms": [ev.duration_s * 1e3 for ev in rebuilt],
               "detect_step_token_equal": got_t[d] == want_t[d],
               "detect_step_logit_err":
                   float((gd - wd).abs().max() / wd.abs().max())}
        what = f"the rebuilt request ({inj.victim}) against its clean pass"
        if key == "rec":
            rec["tokens_vs_clean"] = compare_logits(
                torch, want, got, want_t, got_t, vocab, what)
        elif got_t[:d + 1] == want_t[:d + 1]:
            rec["tokens_vs_clean_after_repair"] = compare_logits(
                torch, want[d + 1:], got[d + 1:], want_t[d + 1:],
                got_t[d + 1:], vocab, what + " after the repair")
        else:
            rec["tokens_vs_clean_after_repair"] = \
                "parted at the detecting step"
        flips[key] = rec
    # clean requests afterwards, both tenants
    engine.reset_state()
    tel = engine.run(alone(400, "log", 4) + alone(401, "rec", 4),
                     warmup=False)
    c_clean = tel.summary()["faults"]["counters"]
    if any(v for k, v in c_clean.items() if k.endswith("_errors")):
        fail(f"errors after the paged flips: {c_clean}")
    flips["clean_after"] = c_clean
    r7 = flips["rec_bit7"]
    log(f"paged Llama flips: {flips['log']['victim']} (log lane) flagged at "
        f"steps {flips['log']['flagged_steps']}, one error a read; on the "
        f"recompute lane "
        + "; ".join(f"{f['victim']} (seed {f['seed']}) flagged at step 1, "
                    f"{f['page_rebuilds']} page rebuild(s) in "
                    f"{f['rebuild_ms']} ms, 0 aborts, the detecting step's "
                    f"logits {f['detect_step_logit_err']:.2g} of the scale "
                    f"off the clean pass's (token equal: "
                    f"{f['detect_step_token_equal']})"
                    for f in (flips["rec"], flips["rec_bit7"]))
        + f"; the bit <= 2 rebuild against its clean pass at every step: "
        f"{flips['rec']['tokens_vs_clean']}; the bit-7 one from the step "
        f"after the repair: {r7['tokens_vs_clean_after_repair']}; clean "
        f"requests after: no errors")

    # ------------------------------ 14e. times ------------------------------
    # one scrub_cache over the log lane's pools (all 16 layers, both
    # pools), device time; the medians beside phase 13's contiguous lanes
    engine.reset_state()
    engine.run(alone(500, "log", 4), warmup=False)
    lane = engine.lanes[0]
    scrub_ms = timer.ms(lambda: scrub_cache(lane.cache, lane.pos), 20)
    serve["scrub_cache_ms"] = scrub_ms
    serve["contig_step_ms_median_phase13"] = contig_step_ms
    # the four 64-token requests of 14b again, through the paged log lane
    # and the contiguous kv_cache:on engine in turns (paged, contiguous,
    # contiguous, paged): both decode steps on one workload in one call
    turns = {"paged": [], "contiguous": []}
    for side in ("paged", "contiguous", "contiguous", "paged"):
        eng = engine if side == "paged" else contig
        eng.reset_state()
        tel = eng.run(cmp_reqs(700), warmup=False)
        turns[side] += [ev.duration_s * 1e3 for ev in tel.steps
                        if ev.kind == "decode"]
    serve["turns_decode_ms"] = turns
    serve["turns_decode_ms_median"] = {k: float(np.median(v))
                                       for k, v in turns.items()}
    engine.reset_state()
    serve["profile"] = profile_requests(torch, engine, [
        Request(rid=600 + i, tenant="log", arrival_s=0.0, prompt_len=64,
                max_new_tokens=8, seed=600 + i, prefix_len=32,
                prefix_seed=prefix_seed) for i in range(4)])
    med = serve["step_ms_median"]
    serve["card"] = smi_line()
    log(f"paged Llama times on {serve['card']}: step medians ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in med.items())
        + "; phase 13's contiguous lanes " + ", ".join(
            f"{k} {v:.2f}" for k, v in contig_step_ms.items())
        + f"; one scrub_cache {scrub_ms:.4f} ms (device); one rebuild "
        f"{flips['rec']['rebuild_ms'][0]:.2f} ms (step wall); four "
        f"64-token requests in turns, decode medians ms (log policy): "
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    serve["turns_decode_ms_median"].items()))
    del engine, contig

    # ------------------ 14f. the paging quick grid, gated ------------------
    t0 = time.perf_counter()
    res = run_paging_campaign(quick=True, seed=0, out_dir=out_dir,
                              device=dev, verbose=log)
    with open(ROOT / PAGING_BASELINE) as f:
        base = json.load(f)
    gate = wilson_gate(base, res)
    diff = diff_artifacts(base, res)
    parity, rebuild = (c["metrics"] for c in res["cells"])
    bools = {k: parity[k] for k in ("parity_ok", "verify_ok", "bytes_ok")}
    bools["rebuild_ok"] = rebuild["rebuild_ok"]
    if gate["failed"] or gate["uncovered"] or not all(bools.values()) or \
            diff["regressions"]:
        fail(f"paging grid: Wilson gate {gate['failed']} failed, "
             f"{gate['uncovered']} uncovered; {bools}; differ "
             f"{diff['regressions']}")
    bp = base["cells"][0]["metrics"]
    grid = {"seconds": time.perf_counter() - t0, "booleans": bools,
            "wilson": gate["cells"], "regressions": diff["regressions"],
            "cells": {c["cell_id"]: c["metrics"] for c in res["cells"]}}
    log(f"paging grid (quick, seed 0) in {grid['seconds']:.1f}s: "
        f"{bools}; detection and FP inside the baseline's Wilson intervals "
        f"in both cells; 0 regressions; pages verified per token "
        f"{parity['pages_verified_per_token']:.2f} (baseline "
        f"{bp['pages_verified_per_token']:.2f}), peak resident KV "
        f"{parity['peak_resident_kv_bytes']} B (baseline "
        f"{bp['peak_resident_kv_bytes']}), fixed-slot KV "
        f"{parity['fixed_slot_kv_bytes']} B (baseline "
        f"{bp['fixed_slot_kv_bytes']}); rebuilds "
        f"{rebuild['page_rebuilds']}, aborted {rebuild['aborted']}")
    record = {"serve": serve, "versus_contiguous": versus, "flips": flips,
              "grid": grid}
    return {"launches": launches, "record": record}


GRANITE = "granite-moe-3b-a800m"
#: the depth cuts by (phase, model), each at full width with every shape
#: and check kept (a layer's shapes and checks are every layer's).  For
#: time, so the whole run stays inside 800 s on a slow host (PERF.md §4
#: gives each cut's seconds): 15, granite served at 8 of 32 layers; 16,
#: the SLO ladder's rungs, Llama at 8 of 16 and granite at 4 (a model's
#: token table, the scans' subject, is drawn before its layers, so it is
#: phases 13's and 15's at any depth); 18, Llama trained at 8 of 16;
#: 19, hymba and llava at 8 of 32, internlm2 at 12 of 48 (whisper stays
#: whole: its build's check needs its layer stack, 1.60 GB, above the
#: 0.80 GB its token table's build takes, and at 16 + 16 the two meet).
#: 20, for the time phases 21 and 22 take: granite trained at 5 of
#: 32 layers, hymba at 12 of 32 and whisper at 12 + 12 (a cut of an
#: encoder-decoder cuts both stacks); llava at 7 of 32 for memory (the
#: training loop holds the pre-step state and builds the new one, so the
#: peak is about two 16 B/param states, the float32 gradient sum and the
#: activations: PERF.md §4 reckons it).  21, Llama over the data mesh at
#: phase 18's depth
LLAMA = "llama3.2-1b"
DEPTH = {(15, GRANITE): 8, (16, LLAMA): 8, (16, GRANITE): 4,
         (18, LLAMA): 8, (21, LLAMA): 8, (23, LLAMA): 2, (23, GRANITE): 2,
         (23, "mistral-large-123b"): 2, (23, "llama4-scout-17b-a16e"): 2,
         (19, "hymba-1.5b"): 8, (19, "llava-next-mistral-7b"): 8,
         (19, "internlm2-20b"): 12,
         (20, "llava-next-mistral-7b"): 7, (20, GRANITE): 5,
         (20, "hymba-1.5b"): 12, (20, "whisper-large-v3"): 12}


def depth_cut(phase: int, arch: str):
    """``arch``'s config at its depth in ``phase`` (:data:`DEPTH`; the
    config's own where the phase keeps it)."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if (phase, arch) in DEPTH:
        cut = {"n_layers": DEPTH[phase, arch]}
        if cfg.enc_layers:
            cut["enc_layers"] = DEPTH[phase, arch]
        cfg = dataclasses.replace(cfg, **cut)
    return cfg


#: the int8 (packed) bytes of full-width granite at phase 15's depth by
#: the config's widths (vocab_padded 49,408 keeps the head aligned)
GRANITE_BYTES = {"experts": DEPTH[15, GRANITE] * 40 * (2 * 1536 * 640
                                                       + 512 * 1664),
                 "attention": DEPTH[15, GRANITE] * 7_077_888,
                 "table": 75_890_688, "head": 76_087_296}
#: K1 and K3 launches a granite prefill or decode step: one K1 an expert
#: for each of the 3 expert projections, one K3 a projection over every
#: expert's rows, and the 4 attention projections of each layer, and the
#: head
GRANITE_K1_PER_STEP = DEPTH[15, GRANITE] * (4 + 3 * 40) + 1
GRANITE_K3_PER_STEP = DEPTH[15, GRANITE] * (4 + 3) + 1


@contextlib.contextmanager
def routing_tap(engine):
    """Records each MoE layer's expert choices (``gate_idx``, every row
    of the step's batch) while ``engine`` runs inside the block: yields
    the list of (engine step, choices on the host)."""
    from repro_torch.layers import moe

    calls = []
    real = moe.slot_assignment

    def recorded(gate_idx, n_experts, capacity):
        calls.append((engine.global_step, gate_idx.cpu()))
        return real(gate_idx, n_experts, capacity)
    moe.slot_assignment = recorded
    try:
        yield calls
    finally:
        moe.slot_assignment = real


def granite_phase(torch, dev, timer) -> dict:
    """Phase 15: full-width int8 granite-moe-3b-a800m (its depth in
    :data:`DEPTH` of its 32 layers, d 1536, 24 query and 8 KV heads of 64, 40 experts
    of width 512, top-8, vocab 49155; random weights from seed 0) served
    on the card through K1-K3,
    with a bf16-cache tenant and a ``kv_cache:on`` tenant.  Returns the
    path's launch counts, K1's times at the expert shapes and the
    record."""
    import dataclasses

    import numpy as np

    from repro_torch.benchmarks.common import (F32_OPS_PER_S,
                                               INT8_OPS_PER_S, bound_ms)
    from repro_torch.configs import reduce_cfg
    from repro_torch.core import LANE
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.abft_qgemm import (abft_qgemm_cuda,
                                                 launch_plan,
                                                 qgemm_unprotected_cuda)
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.models.base import build_model
    from repro_torch.protect import ProtectionPlan, default_plan
    from repro_torch.serving import (FaultInjection, Request, ServingEngine,
                                     TenantSpec, chat_stream)

    cfg = depth_cut(15, GRANITE)
    n_exp, n_layers = cfg.n_experts, cfg.n_layers
    kv_plan = dataclasses.replace(default_plan().with_rules(
        *ProtectionPlan.from_any(KV_PLAN).rules), name="kv")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, [TenantSpec("default", default_plan()),
                                 TenantSpec("kv", kv_plan)],
                           n_slots=4, max_prompt=64, max_new_tokens=32,
                           seed=0, device=dev)
    torch.cuda.synchronize()
    params = engine.params
    layers = params["layers"]
    moe = layers["moe"]
    got_bytes = {
        "experts": sum(moe[w]["w_packed"].numel()
                       for w in ("gate", "up", "down")),
        "attention": sum(layers["attn"][w]["w_packed"].numel()
                         for w in ("wq", "wk", "wv", "wo")),
        "table": params["embed"]["table"].numel(),
        "head": params["lm_head"]["w_packed"].numel()}
    if got_bytes != GRANITE_BYTES:
        fail(f"granite int8 bytes {got_bytes}, reckoned {GRANITE_BYTES}")
    log(f"{cfg.name} (d {cfg.d_model}, {n_layers} layers, {n_exp} experts "
        f"of {cfg.d_ff}, top-{cfg.top_k}) on the card in "
        f"{time.perf_counter() - t0:.1f}s: "
        f"{sum(got_bytes.values()) / 1e9:.3f} GB of int8 (packed) weights "
        f"and table ({got_bytes}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    lanes = {lane.key: lane for lane in engine.lanes}
    if sorted(lanes) != ["lane0[default]", "lane1[kv]"]:
        fail(f"unexpected granite lanes {sorted(lanes)}")

    # ------------- 15a. K1 and K3 at the expert shapes -----------------
    # decode: 4 tokens, capacity 4; a 64-token prefill: capacity 16
    gen = torch.Generator(device=dev).manual_seed(5)
    stacks = {"moe.gate": moe["gate"]["w_packed"],
              "moe.down": moe["down"]["w_packed"]}
    kernel_checks = []
    per_shape = {}
    for name, stack in stacks.items():
        k, n = stack.shape[-2], stack.shape[-1] - LANE
        for m in (4, 16):
            x = torch.randn((n_exp * m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            q = quantize_rows_cuda(x)
            for g, w, g32, what in zip(q, ref.quantize_rows_ref(x),
                                       quantize_rows_cuda(x.float()),
                                       ("q", "alpha", "beta")):
                if not (torch.equal(g, w) and torch.equal(g32, w)):
                    fail(f"quantize_rows: {what} differs at the {name} "
                         f"rows {n_exp} x {m} x {k}")
            a = q[0].reshape(n_exp, m, k)
            w3 = stack[1]                              # layer 1's experts
            c, err = kops.abft_qgemm(a, w3)
            want_c, want_err = ref.abft_qgemm_ref(a, w3)
            if not (torch.equal(c, want_c) and torch.equal(err, want_err)):
                fail(f"abft_qgemm over the {name} experts at m = {m} "
                     f"differs from the plain version")
            if int(err.sum()):
                fail(f"abft_qgemm flagged clean {name} experts")
            for e in (0, n_exp - 1):
                for col in (False, True):
                    got = abft_qgemm_cuda(a[e], w3[e], with_colcheck=col)
                    want = ref.abft_qgemm_ref(a[e], w3[e],
                                              with_colcheck=col)
                    if not all(torch.equal(g, w_)
                               for g, w_ in zip(got, want)):
                        fail(f"abft_qgemm at {name} expert {e} m = {m} "
                             f"(col_check={col}) differs")
            cu = kops.qgemm_unprotected(a, w3)
            if not torch.equal(cu, want_c) or not torch.equal(
                    qgemm_unprotected_cuda(a[0], w3[0]), want_c[0]):
                fail(f"the s8 unprotected K1 at {name} m = {m} differs "
                     f"from the exact product")
            bad = w3[7].clone()
            bad[k // 2, n // 3] ^= 0x10
            flipped = abft_qgemm_cuda(a[7], bad)[1]
            if not torch.equal(flipped, ref.abft_qgemm_ref(a[7], bad)[1]) \
                    or not int(flipped.sum()):
                fail(f"abft_qgemm missed a flipped {name} weight bit")
            plan = launch_plan(m, k, n, a_addr=a[1].data_ptr(),
                               b_addr=w3[1].data_ptr())
            if not plan.aligned:
                fail(f"an expert slice of {name} took the ragged path")
            kernel_checks.append(f"{name} (k, n) = ({k}, {n}) m = {m} (bm "
                                 f"{plan.bm}, splits {plan.splits}, "
                                 f"aligned {plan.aligned})")
            # times, cold: each call takes the next expert of the next
            # layer (983,040 or 851,968 B of B' each)
            cold = itertools.cycle([stack[li, e] for li in range(n_layers)
                                    for e in range(0, n_exp, 7)])
            n8 = -(-(n + 1) // 8) * 8
            padded = [stack[li, e, :, :n8].contiguous()
                      for li in range(0, n_layers, 4)
                      for e in range(0, n_exp, 9)]
            cold_pad = itertools.cycle(padded)
            a_pad = torch.zeros((32, k), dtype=torch.int8, device=dev)
            a_pad[:m] = a[0]
            kb = m * k + k * (n + 1) + 4 * m * n + 4 * m
            b_ms, b_by = bound_ms(kb, 2 * m * k * (n + 1), INT8_OPS_PER_S)
            row = {
                "abft_qgemm_cold_ms": timer.ms(
                    lambda: abft_qgemm_cuda(a[0], next(cold)), 64),
                "qgemm_unprotected_s8_cold_ms": timer.ms(
                    lambda: qgemm_unprotected_cuda(a[0], next(cold)), 64),
                "library_cold_ms": timer.ms(
                    lambda: torch._int_mm(a_pad, next(cold_pad)), 64),
                "plain_ms": timer.ms(
                    lambda: ref.abft_qgemm_ref(a[0], next(cold)), 8),
                "abft_qgemm_bound_ms": b_ms, "bound_by": b_by,
                "expert_stack_ms": timer.ms(
                    lambda: kops.abft_qgemm(a, stack[3]), 8),
                "quantize_rows_all_experts_ms": timer.ms(
                    lambda: quantize_rows_cuda(x)),
                "quantize_rows_bound_ms": bound_ms(
                    3 * n_exp * m * k + 8 * n_exp * m, 6 * n_exp * m * k,
                    F32_OPS_PER_S)[0]}
            row["bound_share"] = b_ms / row["abft_qgemm_cold_ms"]
            per_shape[f"{name} m={m} k={k} n={n}"] = row
            del padded
    log("granite: K3 over all 40 experts' rows (bf16 and f32) and K1 "
        "(the expert stack, single experts with and without the column "
        "check, a flipped weight) bit-exact, and the s8 unprotected K1 "
        "equal to the exact product, at " + "; ".join(kernel_checks))
    log("granite K1 per expert shape, ms cold / s8 unprotected cold / "
        "torch._int_mm cold (padded) / plain / bound (share); the 40-expert "
        "stack; K3 over all experts' rows / bound: " + "; ".join(
            f"{k_}: {v['abft_qgemm_cold_ms']:.4f} / "
            f"{v['qgemm_unprotected_s8_cold_ms']:.4f} / "
            f"{v['library_cold_ms']:.4f} / {v['plain_ms']:.4f} / "
            f"{v['abft_qgemm_bound_ms']:.5f} ({v['bound_share']:.3f}); "
            f"{v['expert_stack_ms']:.4f}; "
            f"{v['quantize_rows_all_experts_ms']:.4f} / "
            f"{v['quantize_rows_bound_ms']:.6f}"
            for k_, v in per_shape.items()))

    # the attention projections at the prefill bucket (64) and a decode
    # step (4), the head at the prefill's last token and a decode step,
    # and K2 on the token table at one request's 64 and 4 tokens, as
    # phase 13 holds Llama's
    attn = layers["attn"]
    checked = check_gemms(torch, dev, gen, [
        ("attn.wq", attn["wq"]["w_packed"], (64, 4)),
        ("attn.wk", attn["wk"]["w_packed"], (64, 4)),
        ("attn.wo", attn["wo"]["w_packed"], (64, 4)),
        ("lm_head", params["lm_head"]["w_packed"][None], (1, 4))])
    emb = params["embed"]
    enc4 = (emb["table"][None], emb["alphas"][None], emb["betas"][None],
            emb["rowsums"][None])
    req0 = Request(rid=0, tenant="default", arrival_s=0.0, prompt_len=64,
                   max_new_tokens=2, seed=5)
    prompt = torch.from_numpy(
        engine._chat_tokens(req0, 64).astype(np.int32)).to(dev)
    k2_checks = {f"{n} tokens": eb_checks(torch, enc4,
                                          prompt[:n].reshape(1, -1, 1),
                                          f"granite {n} tokens")
                 for n in (64, 4)}
    log("granite: K1 (C, err_rows, column check) and K3 (bf16 and f32) "
        "bit-exact at " + "; ".join(checked) + f"; K2 on the "
        f"{tuple(emb['table'].shape)} token table at pool 1 (64 and 4 "
        f"bags): R bit-exact with the slot-order sum, flags equal to the "
        f"plain branch at rel_bound 1e-3 and 1e-5 and to its formula at "
        f"all three")
    scan = scan_token_table(torch, "granite", emb)

    # -------------------- 15b. serve both tenants ----------------------
    def stream(n, seed):
        return chat_stream(n, tenants={"default": 1.0, "kv": 1.0},
                           rate_rps=100.0, seed=seed, mean_prompt=32,
                           max_prompt=64, mean_output=16, max_output=32)

    wrappers = zero_launches()
    tel = engine.run(stream(8, 0))            # the warm-up runs inside
    launches = read_launches(wrappers)
    s = tel.summary()
    counters = s["faults"]["counters"]
    per = s["per_tenant"]
    steps = {(kind, key): [ev.duration_s * 1e3 for ev in tel.steps
                           if ev.kind == kind and ev.lane == key]
             for kind in ("prefill", "decode") for key in lanes}
    log(f"granite: served {sum(p['requests'] for p in per.values())} chat "
        f"requests over two tenants: "
        + "; ".join(f"{t}: {p['completed']} completed, {p['tokens_out']} "
                    f"tokens" for t, p in per.items())
        + f"; steps {[(k, len(v)) for k, v in steps.items()]}; launches "
        f"{launches}; counters { {k: v for k, v in counters.items() if v} }")
    if sum(p["completed"] for p in per.values()) != 8 or \
            any(p["aborted"] for p in per.values()):
        fail(f"not every granite request completed: {per}")
    nonzero = {k: v for k, v in counters.items()
               if v and not k.endswith("_checks")}
    if nonzero:
        fail(f"fault counters on a clean granite run: {nonzero}")
    n_steps = len(tel.steps)
    # a check an expert: 4 attention projections and 3 x 40 experts a
    # layer, and the head
    kv_reads = n_layers * len(steps[("decode", "lane1[kv]")])
    if counters["qgemm_checks"] != GRANITE_K1_PER_STEP * n_steps or \
            counters["embedding_bag_checks"] != n_steps or \
            counters["kv_cache_checks"] != kv_reads:
        fail(f"unexpected granite check counts {counters} for {n_steps} "
             f"steps")
    # the warm-up ran one prefill and one decode step a lane in the window
    want_l = {"abft_qgemm": GRANITE_K1_PER_STEP * (n_steps + 4),
              "quantize_rows": GRANITE_K3_PER_STEP * (n_steps + 4),
              "abft_embeddingbag": n_steps + 4, "wkv6_chunked": 0,
              "qgemm_unprotected": 0, "eb_unprotected": 0}
    if launches != want_l:
        fail(f"granite launches {launches} differ from the path's {want_l}")
    toks = [t for r in tel.requests for t in (r.tokens or [])]
    if len(toks) != sum(p["tokens_out"] for p in per.values()) or \
            not all(0 <= t < cfg.vocab for t in toks):
        fail("served granite tokens outside the vocabulary or missing")
    serve = {"tenants": per, "launches": launches, "counters": counters,
             "k1_per_step": launches["abft_qgemm"] / (n_steps + 4),
             "k3_per_step": launches["quantize_rows"] / (n_steps + 4),
             "steps_ms": {f"{k} {key}": v for (k, key), v in steps.items()},
             "step_ms_median": {f"{k} {key}": float(np.median(v))
                                for (k, key), v in steps.items()},
             "decode_occupancy_mean": s["decode_occupancy_mean"]}
    log(f"granite: K1 {serve['k1_per_step']:.0f} and K3 "
        f"{serve['k3_per_step']:.0f} launches a step (reckoned "
        f"{GRANITE_K1_PER_STEP} and {GRANITE_K3_PER_STEP}); an expert-axis "
        f"K1 (ROADMAP B10) would launch {GRANITE_K3_PER_STEP}")

    def request(rid, tenant, seed, new):
        return Request(rid=rid, tenant=tenant, arrival_s=0.0, prompt_len=64,
                       max_new_tokens=new, seed=seed)

    # ---------------------------- 15c. flips ---------------------------
    # an expert-weight flip (moe.gate) at the first decode-only step of a
    # default-tenant request: flagged at that step only, the leaf restored
    # bit for bit; the flipped expert and whether a token chose it there
    gate = moe["gate"]["w_packed"]
    engine.reset_state()
    fp0 = leaf_fingerprint(torch, gate)
    with routing_tap(engine) as calls:
        tel = engine.run([request(0, "default", 3, 3)],
                         inject=[FaultInjection(step=1, victim="moe.gate",
                                                seed=0)], warmup=False)
    flips = {"expert": check_injection(tel, 1, [1], fp0,
                                       leaf_fingerprint(torch, gate),
                                       "granite moe.gate flip")}
    # the engine's own draw for the recorded victim (a CPU generator)
    from repro_torch.core.inject import draw_bitflip_live
    flat, bit = draw_bitflip_live(torch.Generator().manual_seed(0), gate,
                                  flips["expert"]["victim"])
    per_layer = n_exp * gate.shape[-2] * gate.shape[-1]
    layer, expert = flat // per_layer, (flat % per_layer) // (
        gate.shape[-2] * gate.shape[-1])
    chosen = [idx for step, idx in calls if step == 1]
    if len(chosen) != n_layers:
        fail(f"routing tap saw {len(chosen)} MoE layers at step 1")
    routed = bool((chosen[layer] == expert).any())
    flips["expert"].update(layer=int(layer), expert=int(expert),
                           bit=int(bit), routed=routed,
                           errors=flips["expert"]["counters"]["qgemm_errors"])
    # a flip of an int8 KV payload bit of the kv tenant's resident request:
    # flagged at the next decode step and at every later one
    engine.reset_state()
    tel = engine.run([request(1, "kv", 3, 4)], inject=[FaultInjection(
        step=1, target="kv", seed=0)], warmup=False)
    (inj,) = tel.injections
    flagged = [ev for ev in tel.steps if ev.errors]
    if not inj.detected or inj.detect_step != 1 or \
            not inj.victim.startswith("kv_row/") or \
            [ev.step for ev in flagged] != [1, 2] or \
            any(ev.kind != "decode" or ev.counters["kv_cache_errors"] != 1
                or ev.counters["qgemm_errors"] for ev in flagged):
        fail(f"granite KV flip {inj}: flagged steps "
             f"{[(ev.step, ev.kind, ev.counters) for ev in flagged]}")
    flips["kv"] = {"victim": inj.victim, "step": inj.step,
                   "detect_step": inj.detect_step,
                   "flagged_steps": [ev.step for ev in flagged]}
    engine.reset_state()
    tel = engine.run([request(2, "kv", 3, 4), request(3, "default", 4, 4)],
                     warmup=False)
    c_clean = tel.summary()["faults"]["counters"]
    if c_clean["qgemm_errors"] or c_clean["kv_cache_errors"] or \
            c_clean["embedding_bag_errors"]:
        fail(f"errors after the granite flips: {c_clean}")
    flips["clean_after"] = c_clean
    log(f"granite FaultInjection: {flips['expert']['victim']} (layer "
        f"{layer}, expert {expert}, bit {bit}; a token routed to it at the "
        f"step: {routed}) flagged at step "
        f"{flips['expert']['detect_step']} only "
        f"({flips['expert']['errors']} qgemm errors) and restored bit for "
        f"bit; {flips['kv']['victim']} flagged at steps "
        f"{flips['kv']['flagged_steps']}; clean requests after: no errors")

    # ------------- 15d. the smoke-size granite, card against CPU -------
    small = reduce_cfg(cfg)
    model = build_model(small)
    # a moved int8 code can move a token's experts: after a free run's
    # first code split only its counters and finite logits are held
    small_out = small_card_vs_cpu(torch, dev, small, model,
                                  model.init(0, quant=True, device="cpu"),
                                  default_plan(), (64, 24),
                                  hold_after_split=False)

    # ------------------- 15e. step times and a profile -----------------
    prof_reqs = [request(i, "default", 40 + i, 4) for i in range(4)]
    engine.reset_state()
    serve["profile"] = profile_requests(torch, engine, prof_reqs)
    med = serve["step_ms_median"]
    serve["card"] = smi_line()
    log(f"granite serve on {serve['card']}: step medians ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in med.items())
        + f"; profile: {serve['profile'].get('kernels_per_step')} kernels "
          f"a step, busy {serve['profile'].get('busy_share')}"
        + "; TTFT p50 " + ", ".join(
            f"{t} {p['ttft_ms']['p50']:.2f}" for t, p in per.items())
        + " ms; per token p50 " + ", ".join(
            f"{t} {p['per_token_ms']['p50']:.2f}" for t, p in per.items())
        + " ms")
    del engine
    record = {"bytes": got_bytes, "serve": serve, "flips": flips,
              "kernel_checks": kernel_checks + checked,
              "k2_checks": k2_checks, "gemm_shapes": per_shape,
              "small_card_vs_cpu": small_out, "eb_table_scan": scan}
    return {"launches": launches, "record": record, "k1_times": per_shape}


def eb_token_scan(torch, emb, rel_bound: float, tokens=None,
                  chunk: int = 8192) -> dict:
    """The Eq. (5) check of clean pool-1 lookups of a token table on the
    card: K2 over ``tokens`` (default: every row), one bag a token, held
    to plain arithmetic that does not run K2.  R must equal the plain
    slot-order terms, rsum the plain R summed in K2's order
    (``ref.eb_rsum_team_order``) and the flags that sum's compare
    (``ref.eb_check_slot_order``), bit for bit.  The bound scales with
    |alpha x rowsum| + d |beta| (``core.verify_bags``), while the float32
    round-off of a d-term row sum scales with the sum of its terms'
    magnitudes: a row whose int8 values nearly cancel, with a small beta,
    can be flagged clean, and the summation order decides which.  Each
    token K2 flags is then held to three witnesses, in float64 on the
    plain terms: its int8 values sum to its stored C_T (the row is
    intact); ``exact``, |sum R - csum| over the bound for the exact sum
    of the float32 terms; ``reach``, the most a float32 sum in K2's order
    can depart from that sum (gamma_h x sum|R|, h the adds a term passes
    through) over the bound.  A flag with exact + reach < 1 lies further
    inside the bound than round-off reaches, and fails.  Returns the
    tokens K2 and the plain branch (``verify_bags``, another order) flag
    and K2's flagged tokens' witnesses."""
    from repro_torch.core import table_rowsums
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda, eb_plan

    table, alphas, betas, rowsums = (emb[k][None] for k in (
        "table", "alphas", "betas", "rowsums"))
    rows, d = table.shape[1], table.shape[-1]
    if tokens is None:
        tokens = torch.arange(rows, dtype=torch.int32, device=table.device)
    k2, plain, witness = [], [], []
    for i in range(0, tokens.numel(), chunk):
        idx = tokens[i:i + chunk].to(torch.int32).reshape(1, -1, 1)
        plan = eb_plan(1, idx.shape[1], 1, d, rows,
                       table_addr=table.data_ptr())
        if not (plan.vec and plan.groups == 1):
            fail(f"the token table {tuple(table.shape)} is not on K2's "
                 f"team path ({plan})")
        r, rsum, err, _ = abft_eb_cuda(table, alphas, betas, idx, rowsums,
                                       rel_bound=rel_bound)
        want_r = ref.abft_eb_slot_order_ref(table, alphas, betas, idx)
        want_rsum = ref.eb_rsum_team_order(want_r, plan.warps_per_bag)
        want_err = ref.eb_check_slot_order(want_rsum, alphas, betas, idx,
                                           rowsums, d, rel_bound=rel_bound)
        if not (torch.equal(r, want_r) and torch.equal(rsum, want_rsum)
                and torch.equal(err, want_err)):
            fail(f"K2 on token rows {i}..: R, rsum or flags differ from the "
                 f"plain terms summed in its order "
                 f"({int((rsum != want_rsum).sum())} rsums, "
                 f"{int((err != want_err).sum())} flags)")
        out = kops.abft_embedding_bag(table, alphas, betas, idx, rowsums,
                                      rel_bound=rel_bound, use_kernel=False)
        t = idx.reshape(-1).long()
        plain.append(t[out.err_bags[0]])
        hit = err[0]
        if not bool(hit.any()):
            continue
        th = t[hit]
        k2.append(th)
        r64 = want_r[0, hit].double()
        a, b = alphas[0, th].double(), betas[0, th].double()
        ct = rowsums[0, th].double()
        tol = rel_bound * torch.clamp(a.abs() * ct.abs() + d * b.abs(),
                                      min=1.0)
        csum = a * ct + d * b
        h = 16 * -(-plan.lanes // (32 * plan.warps_per_bag)) + 5 \
            + plan.warps_per_bag
        gamma = h * 2.0**-24 / (1 - h * 2.0**-24)
        exact = (r64.sum(-1) - csum).abs() / tol
        reach = gamma * r64.abs().sum(-1) / tol
        k2_ratio = (rsum[0, hit].double() - csum).abs() / tol
        intact = table_rowsums(table[0, th]) == rowsums[0, th]
        for j, tok in enumerate(th.tolist()):
            witness.append({"token": tok, "intact": bool(intact[j]),
                            "k2": round(float(k2_ratio[j]), 4),
                            "exact": round(float(exact[j]), 4),
                            "reach": round(float(reach[j]), 4)})
    bad = [w for w in witness if not w["intact"]
           or w["exact"] + w["reach"] < 1]
    if bad:
        fail(f"K2 flagged clean token rows that no float32 round-off in its "
             f"order explains, or rows not intact: {bad}")
    k2, plain = (torch.cat(x).cpu().tolist() if x else [] for x in (k2, plain))
    return {"tokens": int(tokens.numel()), "k2_flagged": k2,
            "plain_flagged": plain, "witness": witness}


def scan_token_table(torch, name: str, emb) -> dict:
    """:func:`eb_token_scan` over every row of a served model's token
    table at the default rel_bound (ROADMAP C6), logged."""
    from repro_torch.core import EB_REL_BOUND
    t0 = time.perf_counter()
    sc = eb_token_scan(torch, emb, EB_REL_BOUND)
    both = set(sc["k2_flagged"]) & set(sc["plain_flagged"])
    log(f"{name}: K2 over every clean token row ({sc['tokens']}), one "
        f"pool-1 bag each, at rel_bound {EB_REL_BOUND:g}: R, rsum and flags "
        f"bit-exact with the plain terms summed in its order; it flags "
        f"{len(sc['k2_flagged'])}, the plain branch "
        f"{len(sc['plain_flagged'])} ({len(both)} in both); each K2 "
        f"flag's row intact, |rsum - csum| / bound "
        f"under K2 / exact / reach: "
        + ", ".join(f"{w['token']} {w['k2']}/{w['exact']}/{w['reach']}"
                    for w in sc["witness"])
        + f" ({time.perf_counter() - t0:.1f}s)")
    return sc


@contextlib.contextmanager
def eb_flag_tap():
    """Records the token lookups the protected EmbeddingBag flags while
    the block runs (``kops.abft_embedding_bag``'s one-table calls, the
    LM's; kept on the device, no host sync): yields a list the caller
    drains with :func:`flagged_tokens`."""
    from repro_torch.kernels import ops as kops

    seen = []
    real = kops.abft_embedding_bag

    def recording(table_q, alphas, betas, indices, *args, **kw):
        out = real(table_q, alphas, betas, indices, *args, **kw)
        if indices.dim() == 2:
            seen.append((indices, out.err_bags))
        return out
    kops.abft_embedding_bag = recording
    try:
        yield seen
    finally:
        kops.abft_embedding_bag = real


def flagged_tokens(torch, seen) -> list:
    """The flagged tokens of :func:`eb_flag_tap`'s records (one entry a
    flagged bag), and the records cleared."""
    got = [idx[err.reshape(idx.shape[0])][:, 0] for idx, err in seen]
    seen.clear()
    return torch.cat(got).tolist() if got else []


#: the committed JAX baseline of the serving soak (made by the unchanged
#: JAX CLI: python -m repro.campaign --grid serving_soak --quick --seed 0)
SOAK_BASELINE = ("src/repro_torch/campaign/baselines/"
                 "BENCH_campaign_serving_soak_quick.json")


#: requests a rung of the SLO ladder serves (fewer requests, not fewer
#: checks, keep the whole script inside its time)
SLO_REQUESTS = 12


def soak_slo_phase(torch, dev, out_dir, scans: dict) -> dict:
    """Phase 16: the serving soak's quick grid on the card, gated against
    the JAX baseline, then the protection SLO ladder at full width for
    Llama-3.2-1B and granite-moe-3b-a800m (both at their depths in
    :data:`DEPTH`).  ``scans`` holds each model's
    token-table scan (:func:`eb_token_scan`, phases 13 and 15: the same
    seed-0 tables).  Returns each path's launch counts, the ladder's the
    sum of its rungs', and the record."""
    from repro_torch.benchmarks.serving_slo import run_ladder
    from repro_torch.campaign.diff import diff_artifacts, wilson_gate
    from repro_torch.serving.soak import run_soak_campaign

    t0 = time.perf_counter()
    wrappers = zero_launches()
    res = run_soak_campaign(quick=True, seed=0, out_dir=out_dir, device=dev,
                            verbose=log)
    soak_launches = read_launches(wrappers)
    with open(ROOT / SOAK_BASELINE) as f:
        base = json.load(f)
    gate = wilson_gate(base, res)
    diff = diff_artifacts(base, res)
    cells = {c["cell_id"]: c["metrics"] for c in res["cells"]}
    for cid, m in cells.items():
        if (m["samples"], m["detected"], m["escapes"]) != (1, 1, 0):
            fail(f"serving soak {cid}: {m['detected']}/{m['samples']} "
                 f"detected, {m['escapes']} escapes")
    if gate["failed"] or gate["uncovered"] or diff["regressions"]:
        fail(f"serving soak: Wilson gate {gate['failed']} failed, "
             f"{gate['uncovered']} uncovered; differ {diff['regressions']}")
    if min(soak_launches[k] for k in ("abft_qgemm", "abft_embeddingbag",
                                      "quantize_rows")) <= 0:
        fail(f"a kernel of the soak never launched: {soak_launches}")
    soak = {"seconds": time.perf_counter() - t0, "wilson": gate["cells"],
            "regressions": diff["regressions"], "cells": {
                cid: {k: m[k] for k in (
                    "samples", "detected", "escapes", "corrupted",
                    "clean_samples", "false_positives", "fp_rate",
                    "detection_latency_steps", "throughput_tok_s")}
                for cid, m in cells.items()},
            "baseline_cells": {c["cell_id"]: {
                k: c["metrics"][k] for k in ("clean_samples",
                                             "false_positives")}
                for c in base["cells"]}}
    log(f"serving soak (quick, seed 0) in {soak['seconds']:.1f}s: "
        + "; ".join(f"{cid}: detect {m['detected']}/{m['samples']}, "
                    f"escapes {m['escapes']}, FP {m['false_positives']}/"
                    f"{m['clean_samples']} steps (baseline "
                    f"{soak['baseline_cells'][cid]['false_positives']}/"
                    f"{soak['baseline_cells'][cid]['clean_samples']})"
                    for cid, m in soak["cells"].items())
        + "; inside the JAX baseline's Wilson intervals (detection, escape, "
          "FP); 0 regressions")

    # the SLO ladder: the same stream under *:off, log and recompute+kv;
    # the unprotected rung runs K1's and K2's unprotected instances and
    # no float64 product (counted by the profiler on one request).  Each
    # rung's counts are set to 0 before its engine is built and read
    # right after its run, before the probe's own launches
    from repro_torch.core import EB_REL_BOUND

    ladders, ladder_launches = {}, {}
    for arch in ("llama3.2-1b", GRANITE):
        t1 = time.perf_counter()
        rungs = {}
        wrappers = zero_launches()

        def probe(name, engine):
            rungs[name] = read_launches(wrappers)
            flags = flagged_tokens(torch, seen_eb)
            if flags:
                # each flag of a clean rung: a token K2 also flags in the
                # table's scan, held there to plain arithmetic and to its
                # float64 witnesses (the row intact, round-off reaching the
                # bound)
                again = eb_token_scan(
                    torch, engine.params["embed"], EB_REL_BOUND,
                    torch.tensor(sorted(set(flags)), device=dev))
                if sorted(again["k2_flagged"]) != sorted(set(flags)) or \
                        not set(flags) <= set(scans[arch]["k2_flagged"]):
                    fail(f"{arch} rung {name}: the EmbeddingBag flagged "
                         f"tokens {flags} in the serve, {again['k2_flagged']}"
                         f" of them alone, the table scan "
                         f"{scans[arch]['k2_flagged']}")
                rungs[name]["eb_flags"] = {"flagged": flags, **again}
            if name == "unprotected":
                from repro_torch.serving import Request
                req = [Request(rid=0, tenant="t", arrival_s=0.0,
                               prompt_len=24, max_new_tokens=3, seed=1)]
                seen = device_ops(torch, lambda: engine.run(
                    req, warmup=False))
                f64 = [n for n, _ in seen if "dgemm" in n.lower() or (
                    "gemm" in n.lower() and any(
                        s in n.lower() for s in ("f64", "double")))]
                if f64:
                    fail(f"the unprotected {arch} rung ran a float64 GEMM: "
                         f"{f64}")
                rungs[name]["device_op_kinds"] = len(seen)
            flagged_tokens(torch, seen_eb)      # the probe's own lookups
            zero_launches()                     # the next rung's window
        with eb_flag_tap() as seen_eb:
            cfg = depth_cut(16, arch)
            ladder = run_ladder(cfg, requests=SLO_REQUESTS, rate=300.0,
                                arrival="poisson", slots=4, max_new=16,
                                seed=0, smoke=False, device=dev, emit=log,
                                probe=probe)
        ladder["layers"] = cfg.n_layers
        ladder_launches[arch] = {k: sum(r[k] for r in rungs.values())
                                 for k in wrappers}
        off = rungs["unprotected"]
        if off["abft_qgemm"] or off["abft_embeddingbag"] or \
                not off["qgemm_unprotected"] or not off["eb_unprotected"]:
            fail(f"the unprotected {arch} rung launched {off}")
        for name, row in ladder["plans"].items():
            c = row["counters"]
            n_eb = len(rungs[name].get("eb_flags", {}).get("flagged", ()))
            if row["completed"] != SLO_REQUESTS:
                fail(f"{arch} rung {name}: {row['completed']} of "
                     f"{SLO_REQUESTS} completed")
            # the GEMM and KV checks are exact on clean data; every
            # EmbeddingBag flag was witnessed above (a recompute rung
            # reads a flagged row twice: its retry)
            if c["qgemm_errors"] or c["kv_cache_errors"] or \
                    c["embedding_bag_errors"] > n_eb or \
                    bool(c["embedding_bag_errors"]) != bool(n_eb) or (
                        name == "unprotected" and any(c.values())):
                fail(f"{arch} rung {name} counters {c}")
        ladder["launches_by_rung"] = rungs
        ladder["seconds"] = time.perf_counter() - t1
        log(f"{arch}: the rungs' EmbeddingBag flags at rel_bound "
            f"{EB_REL_BOUND:g}, each a token of the table scan's "
            f"{len(scans[arch]['k2_flagged'])}, with its witnesses "
            f"(|rsum - csum| / bound under K2, for the exact sum, and the "
            f"round-off's reach): " + ("; ".join(
                f"{n}: {r['eb_flags']['flagged']} {r['eb_flags']['witness']}"
                for n, r in rungs.items() if "eb_flags" in r) or "none"))
        ladders[arch] = ladder
        p = ladder["plans"]
        log(f"SLO ladder {arch} ({ladder['layers']} layers, {SLO_REQUESTS} "
            f"requests, 300 rps poisson, 4 slots, 16 new tokens; "
            f"{smi_line()}): " + "; ".join(
                f"{n}: TTFT p50/p95/p99 {r['ttft_ms']['p50']:.2f}/"
                f"{r['ttft_ms']['p95']:.2f}/{r['ttft_ms']['p99']:.2f} ms, "
                f"per token p50/p95/p99 {r['per_token_ms']['p50']:.2f}/"
                f"{r['per_token_ms']['p95']:.2f}/"
                f"{r['per_token_ms']['p99']:.2f} ms, "
                f"{r['throughput_tok_s']:.1f} tok/s"
                + (f", p99 TTFT x{r['ttft_p99_ratio']:.3f} and per token "
                   f"x{r['tok_p99_ratio']:.3f} over unprotected"
                   if "ttft_p99_ratio" in r else "")
                for n, r in p.items())
            + f"; launches by rung {rungs}")
    return {"soak_launches": soak_launches,
            "ladder_launches": ladder_launches,
            "record": {"soak": soak, "slo": ladders, "card": smi_line()}}


#: the plan phase 17 serves full-width Llama-3.2-1B under
OBS_PLAN = "*:policy=log,embedding_bag:threshold=adaptive"
#: the JAX CLI's adaptive quick artifact in this repo's JAX environment
#: (python -m repro.campaign --grid adaptive --quick --seed 0), and the
#: older committed baseline whose FP column it does not reproduce
ADAPTIVE_JAX = ("src/repro_torch/campaign/baselines/"
                "BENCH_campaign_adaptive_quick.json")
ADAPTIVE_BASELINE = "benchmarks/baselines/BENCH_campaign_adaptive_quick.json"
#: registry families replay must rebuild exactly from the JSONL
MIRRORED = ("repro_detections_total", "repro_injections_total",
            "repro_abft_checks_total", "repro_abft_errors_total",
            "repro_alerts_total", "repro_health_transitions_total",
            "repro_health_state", "repro_health_actions_total",
            "repro_escapes_total", "repro_false_positives_total",
            "repro_paging_ops_total")


def dtoh_copies(torch, fn) -> int:
    """Device-to-host copies one call of ``fn`` makes, by the profiler
    (after a warm-up call)."""
    return sum(n for name, n in device_ops(torch, fn)
               if "dtoh" in name.lower().replace(" ", ""))


def observability_phase(torch, dev, llama_params, quick_artifact,
                        out_dir, cfg=None) -> dict:
    """Phase 17: full-width Llama-3.2-1B (phase 13's weights) served under
    ``*:policy=log,embedding_bag:threshold=adaptive`` with
    ``Observability``, a default ``Monitor`` and
    ``AdaptiveThresholds(ControllerConfig(fp_budget=0.01))``: 24 requests
    at t = 0, 4 slots, the 64-token bucket, 16 new tokens, ``mlp.down``
    flips at steps 4, 5 and 6, driven healthy -> quarantined -> healthy;
    the four obs artifacts, read back, validated and replayed; a second
    monitored run whose controller moves the bound; the same stream with
    no flip, plain and monitored in turns; device-to-host copies with and
    without obs, monitor and adapt; the monitor's fold time over a step;
    the ``monitor_overhead`` benchmark; ``--grid adaptive --quick`` on
    the card, held to the CPU run and the JAX artifact; ``--trend`` over
    the committed quick history with phase 9's card artifact as its
    newest entry.  Every run has a new engine."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.adapt import AdaptiveThresholds, ControllerConfig
    from repro_torch.benchmarks import monitor_overhead
    from repro_torch.campaign.adaptive import run_adaptive_campaign
    from repro_torch.campaign.artifacts import write_artifacts
    from repro_torch.campaign.diff import diff_artifacts, wilson_gate
    from repro_torch.campaign.trend import run_trend
    from repro_torch.configs import get_arch
    from repro_torch.core import EB_REL_BOUND
    from repro_torch.obs import (EventBus, Monitor, Observability, replay,
                                 validate_event)
    from repro_torch.protect import ProtectionPlan
    from repro_torch.serving import (FaultInjection, Request, ServingEngine,
                                     TenantSpec, chat_stream)

    cfg = cfg or get_arch("llama3.2-1b")
    t0 = time.perf_counter()

    def fresh():
        """A new engine on phase 13's weights (its own init is dropped):
        a run's escalation and bound moves stay with its engine."""
        eng = ServingEngine(cfg, [TenantSpec("t", ProtectionPlan.parse(
            OBS_PLAN, name="t"))], n_slots=4, max_prompt=64,
            max_new_tokens=16, seed=0, device=dev)
        eng.params = llama_params
        return eng
    stream = [dataclasses.replace(r, arrival_s=0.0) for r in chat_stream(
        24, tenants={"t": 1.0}, rate_rps=100.0, seed=0, mean_prompt=32,
        max_prompt=64, mean_output=8, max_output=16)]
    burst = (4, 5, 6)

    def monitored(config, flips=burst):
        eng = fresh()
        obs, mon = Observability.create(), Monitor()
        ad = AdaptiveThresholds(config=config)
        tel = eng.run(stream, obs=obs, monitor=mon, adapt=ad, inject=[
            FaultInjection(step=s, victim="mlp.down", seed=i)
            for i, s in enumerate(flips)])
        return tel, obs, mon, ad, eng

    # --------- 17a. the main path: the burst, quarantine and back ---------
    wrappers = zero_launches()
    with eb_flag_tap() as seen_eb:
        tel, obs, mon, ad, _ = monitored(ControllerConfig(fp_budget=0.01))
        launches = read_launches(wrappers)
        eb_tokens = flagged_tokens(torch, seen_eb)
    s = tel.summary()
    ms = s["monitor"]
    per = s["per_tenant"]["t"]
    actions = [e.attrs["action"] for e in obs.bus
               if e.kind == "health" and e.source == "serving.engine"]
    hops = [(t["old"], t["new"]) for t in ms["transitions"]]
    burst_alerts = [a for a in ms["alerts"] if a["rule"] == "detection-burst"]
    flips = [(i.step, i.detected, i.detect_step) for i in tel.injections]
    walk = " -> ".join([hops[0][0]] + [n for _, n in hops]) if hops \
        else "none"
    log(f"Llama obs path: {per['completed']} of 24 completed, "
        f"{len(tel.steps)} steps, {ms['ticks']} monitor ticks; alerts "
        + ", ".join(f"{a['rule']} [{a['severity']}] tick {a['tick']}"
                    f"{'' if a['resolved_t_s'] is None else ' resolved'}"
                    for a in ms["alerts"])
        + f"; health {walk}"
        + f"; engine actions {actions}; flips (step, flagged, at) {flips}; "
          f"launches {launches}")
    if not burst_alerts or any(a["resolved_t_s"] is None
                               for a in burst_alerts):
        fail(f"detection-burst did not fire and resolve: {ms['alerts']}")
    if not any(n == "quarantined" for _, n in hops) or \
            ms["health"] != {"tenant:t": "healthy"}:
        fail(f"health walk {hops}, final {ms['health']}")
    if not {"escalate", "quarantine", "recover"} <= set(actions):
        fail(f"engine actions {actions}")
    if per["completed"] != 24 or per["aborted"]:
        fail(f"Llama obs path: {per}")
    if [f for f in flips if f != (f[0], True, f[0])] or \
            [f[0] for f in flips] != list(burst):
        fail(f"a flip not flagged at its step: {flips}")
    if min(launches[k] for k in ("abft_qgemm", "abft_embeddingbag",
                                 "quantize_rows")) <= 0:
        fail(f"a kernel of the obs path never launched: {launches}")
    esc_step = next(e.step for e in obs.bus if e.kind == "health"
                    and e.attrs.get("action") == "escalate")
    first_rc = next(ev for ev in tel.steps if ev.step > esc_step)
    ctrl = s["thresholds"]
    moves = [(e.step, e.attrs["direction"], e.bound, e.detector_value)
             for e in obs.bus if e.kind == "threshold"]
    log(f"escalation at step {esc_step}; the lane's first recompute step "
        f"(step {first_rc.step}, {first_rc.kind}) "
        f"{first_rc.duration_s * 1e3:.2f} ms; "
        f"controller {ctrl}, moves {moves}; EmbeddingBag flags at "
        f"rel_bound 1e-5 drove it from tokens {eb_tokens} (ROADMAP §C6)")

    # ------------- 17b. the four artifacts, read back and replayed --------
    tmp = tempfile.TemporaryDirectory()
    obs_dir = str(Path(out_dir) / "obs") if out_dir else tmp.name
    paths = obs.write(obs_dir)
    with open(paths["events"]) as f:
        for line in f:
            validate_event(json.loads(line))
    back = EventBus.from_jsonl(paths["events"])
    if len(back) != len(obs.bus):
        fail(f"JSONL holds {len(back)} of {len(obs.bus)} events")

    def mirrored(reg):
        return sorted(ln for ln in reg.to_prometheus().splitlines()
                      if ln.startswith(MIRRORED))
    if mirrored(replay(paths["events"])) != mirrored(obs.registry):
        fail("replay of the JSONL differs from the live registry")
    with open(paths["trace"]) as f:
        trace = json.load(f)
    if not trace.get("traceEvents"):
        fail("the Chrome trace holds no event")
    log(f"obs artifacts in {obs_dir}: {len(back)} events valid, replay "
        f"equal to the live registry ({len(mirrored(obs.registry))} "
        f"fault-pipeline lines), trace of {len(trace['traceEvents'])} "
        f"events")

    # ---- 17c. the monitor's cost: fold time, turns, device->host copies ---
    best = float("inf")
    for _ in range(7):
        m2 = Monitor()
        t1 = time.perf_counter()
        for ev in obs.bus:
            m2.on_event(ev)
        best = min(best, time.perf_counter() - t1)
    # the second monitored run's controller may move (one EmbeddingBag
    # check a step; FP budget 0.5 in an 8-tick window), its floor 1e-6
    # above the float32 round-off of the token table's checks
    tel2, obs2, _, ad2, eng2 = monitored(ControllerConfig(
        fp_budget=0.5, hysteresis=1.0, min_checks=2, cooldown_ticks=2,
        settle_ticks=3, floor=1e-6, window_ticks=8))
    moved = [(e.step, e.attrs["direction"], e.detector_value)
             for e in obs2.bus if e.kind == "threshold"]
    bound2 = ad2.summary()[0]["rel_bound"]
    lane_bound = eng2._lane_of["t"].plan.resolve("embedding_bag").rel_bound
    if (EB_REL_BOUND if lane_bound is None else lane_bound) != bound2:
        fail(f"the lane runs at {lane_bound}, the controller at {bound2}")
    # the monitor's end-to-end cost: the same stream with no flip (nothing
    # escalates), plain and with obs+monitor+adapt, in turns, 2 runs each
    ab = {"plain": [], "monitored": []}
    for _ in range(2):
        ab["plain"].append(fresh().run(stream))
        tel_m, _, mon_m, _, _ = monitored(ControllerConfig(fp_budget=0.01),
                                          flips=())
        if mon_m.summary()["transitions"]:
            fail("a monitored run with no flip changed the tenant's health")
        ab["monitored"].append(tel_m)

    def medians(tel):
        return {kind: float(np.median([ev.duration_s * 1e3
                                       for ev in tel.steps
                                       if ev.kind == kind]))
                for kind in ("prefill", "decode")}
    per_run = {k: [medians(t) for t in v] for k, v in ab.items()}
    med = {k: {kind: float(np.median([r[kind] for r in v]))
               for kind in ("prefill", "decode")}
           for k, v in per_run.items()}
    ab_cost = {kind: med["monitored"][kind] / med["plain"][kind] - 1.0
               for kind in ("prefill", "decode")}
    pre_esc = float(np.median([ev.duration_s * 1e3 for ev in tel.steps
                               if ev.kind == "decode"
                               and ev.step <= esc_step] or [float("nan")]))
    step_ms = float(np.median([ev.duration_s * 1e3 for ev in tel.steps]))
    fold_ms = 1e3 * best / max(1, ms["ticks"])
    share = fold_ms / step_ms
    # device->host copies: a short stream with and without obs, monitor
    # and adapt (no flip, so no escalation), each profiled after a warm-up
    short = [Request(rid=i, tenant="t", arrival_s=0.0, prompt_len=64,
                     max_new_tokens=4, seed=60 + i) for i in range(4)]

    def serve_short(with_obs):
        eng = fresh()

        def go():
            eng.reset_state()
            if with_obs:
                eng.run(short, warmup=False, obs=Observability.create(),
                        monitor=Monitor(), adapt=AdaptiveThresholds(
                            config=ControllerConfig(fp_budget=0.01)))
            else:
                eng.run(short, warmup=False)
        return go
    copies = {"plain": dtoh_copies(torch, serve_short(False)),
              "monitored": dtoh_copies(torch, serve_short(True))}
    n_steps = len(fresh().run(short, warmup=False).steps)
    log(f"Llama obs path ({smi_line()}): step medians ms, 2 plain and 2 "
        f"monitored runs in turns, no flip: plain {med['plain']}, "
        f"monitored {med['monitored']} (monitored over plain: prefill "
        f"{100 * ab_cost['prefill']:+.2f}%, decode "
        f"{100 * ab_cost['decode']:+.2f}%; per run {per_run}); the burst "
        f"run's decode before its escalation {pre_esc:.2f} ms; monitor "
        f"fold {fold_ms:.4f} ms a tick = {100 * share:.3f}% of the "
        f"{step_ms:.2f} ms step median; device->host copies over "
        f"{n_steps} steps of 4 requests: {copies}; the second monitored "
        f"run's controller moved {moved} to {bound2:.3g}")
    if copies["plain"] != copies["monitored"] or copies["plain"] <= 0:
        fail(f"device->host copies differ with obs+monitor+adapt: {copies}")
    if share >= 0.05:
        fail(f"the monitor's fold is {100 * share:.2f}% of a step")
    bench = monitor_overhead.measure(dev)
    log(f"monitor_overhead (reduced Llama, 32 requests): "
        f"{bench['monitor_per_tick_ms']:.4f} ms a tick over "
        f"{bench['per_step_ms']:.3f} ms a step = "
        f"{bench['monitor_overhead_pct_of_step']:.3f}%")
    if bench["monitor_overhead_frac_of_step"] >= monitor_overhead.ACCEPT_FRAC:
        fail(f"monitor_overhead {bench['monitor_overhead_pct_of_step']:.2f}%")

    # ---------------- 17d. --grid adaptive --quick on the card -------------
    t1 = time.perf_counter()
    adaptive = run_adaptive_campaign(
        quick=True, seed=0, device=dev, verbose=log,
        out_dir=str(Path(out_dir) / "campaign") if out_dir else None)
    card_s = time.perf_counter() - t1
    on_cpu = run_adaptive_campaign(quick=True, seed=0, device="cpu")
    with open(ROOT / ADAPTIVE_JAX) as f:
        jax_now = json.load(f)
    with open(ROOT / ADAPTIVE_BASELINE) as f:
        base = json.load(f)
    g_now, g_base = wilson_gate(jax_now, adaptive), wilson_gate(base,
                                                                adaptive)
    d_now, d_base = [
        [(r["cell_id"], r["kind"], r["old"], r["new"])
         for r in diff_artifacts(ref_art, adaptive)["regressions"]]
        for ref_art in (jax_now, base)]
    for c in adaptive["cells"]:
        m = c["metrics"]
        if not (m["converged"] and m["fp_budget_held"] and
                m["detection_ok"]):
            fail(f"adaptive cell {c['cell_id']}: {m}")
    # the card's stream is the CPU port's bit for bit (JAX's draws, one
    # fixed order of float32 adds): every count and bound equal
    keys = ("detected", "false_positives", "clean_samples", "samples",
            "adjustments", "move_ticks", "converged_rel_bound")
    split = [(c["cell_id"], k, c["metrics"][k], p["metrics"][k])
             for c, p in zip(adaptive["cells"], on_cpu["cells"])
             for k in keys if c["metrics"][k] != p["metrics"][k]]
    if split:
        fail(f"adaptive grid: the card differs from the CPU on the same "
             f"draws: {split}")
    # against the JAX CLI's artifact (the same draws): detection by
    # Wilson overlap and the differ (detection and FP, 2 points), 0
    # regressions; against the older baseline, detection by Wilson overlap
    for gate in (g_now, g_base):
        if len(gate["cells"]) != 3 or gate["uncovered"] or not all(
                c["detection"]["overlap"] for c in gate["cells"]):
            fail(f"adaptive grid: detection outside the JAX intervals "
                 f"{gate['cells']}")
    if d_now:
        fail(f"adaptive grid: differ regressions against the JAX CLI's "
             f"artifact {d_now}")
    log(f"--grid adaptive --quick on the card in {card_s:.1f}s, equal to "
        f"the CPU run on the same draws: " + "; ".join(
            f"{c['cell_id']}: detect {c['metrics']['detected']} of "
            f"{c['metrics']['samples']} (JAX {j['metrics']['detected']}; "
            f"best static {c['metrics']['best_static_detection']}), fp "
            f"{c['metrics']['fp_rate']:.4f} (JAX "
            f"{j['metrics']['fp_rate']:.4f}), bound "
            f"{c['metrics']['converged_rel_bound']:.3g} after "
            f"{c['metrics']['adjustments']} moves (JAX "
            f"{j['metrics']['adjustments']})"
            for c, j in zip(adaptive["cells"], jax_now["cells"]))
        + "; detection inside the JAX artifact's and the older "
          "baseline's Wilson intervals in every cell; differ vs JAX: "
          "0 regressions; FP Wilson intervals new / JAX / baseline "
          "(the round-off cliff's FP is the sums' order's, ROADMAP §C8): "
        + "; ".join(f"{a['cell_id'].split('/')[1]} {a['fp']['new']} / "
                    f"{a['fp']['old']} / {b['fp']['old']}"
                    for a, b in zip(g_now["cells"], g_base["cells"]))
        + f"; differ vs the older baseline (printed; the JAX package "
          f"fails it too) {d_base}")

    # ------------- 17e. --trend with phase 9's card artifact newest --------
    quick_dir = tempfile.TemporaryDirectory()
    newest = write_artifacts(quick_artifact, quick_dir.name)[0]
    history = sorted(str(p) for p in (ROOT / "benchmarks" / "baselines")
                     .glob("BENCH_campaign_quick*.json")) + [newest]
    md = []
    rc = run_trend(history, emit=md.append)
    for line in "\n".join(md).splitlines():
        if line.startswith(("|", "No trend", "## Trend")) or "gated" in line:
            log(f"  trend | {line}")
    if rc != 0:
        fail(f"--trend over the committed quick history with the card's "
             f"artifact newest: rc {rc}")
    tmp.cleanup()
    quick_dir.cleanup()
    seconds = time.perf_counter() - t0
    log(f"phase 17 K1/K2/K3 launches on the obs path: "
        f"{launches['abft_qgemm']} / {launches['abft_embeddingbag']} / "
        f"{launches['quantize_rows']}; controller {ctrl}")
    record = {"card": smi_line(), "seconds": seconds,
              "completed": per["completed"], "steps": len(tel.steps),
              "ticks": ms["ticks"], "alerts": ms["alerts"],
              "transitions": ms["transitions"], "actions": actions,
              "flips": flips, "escalation_step": esc_step,
              "first_recompute_step_ms": first_rc.duration_s * 1e3,
              "controller": ctrl, "controller_moves": moves,
              "eb_flagged_tokens": eb_tokens,
              "second_controller": ad2.summary(),
              "second_controller_moves": moved,
              "step_ms_median": med, "step_ms_per_run": per_run,
              "monitored_over_plain": ab_cost,
              "decode_ms_before_escalation": pre_esc,
              "monitor_fold_ms_per_tick": fold_ms,
              "monitor_share_of_step": share, "dtoh_copies": copies,
              "dtoh_steps": n_steps, "monitor_overhead": bench,
              "adaptive": {c["cell_id"]: {k: c["metrics"][k] for k in (
                  "detection_rate", "fp_rate", "converged_rel_bound",
                  "adjustments", "best_static_detection", "realized_fp_rate",
                  "samples", "clean_samples")} for c in adaptive["cells"]},
              "adaptive_wilson_vs_jax": g_now["cells"],
              "adaptive_wilson_vs_baseline": g_base["cells"],
              "adaptive_differ_vs_jax": d_now,
              "adaptive_card_equals_cpu": not split,
              "adaptive_differ_vs_baseline": d_base,
              "trend_rc": rc}
    return {"launches": launches, "record": record}


#: the training grid's gates: the JAX CLI's artifact (jax 0.9.0) and the
#: committed baseline
TRAINING_JAX = ("src/repro_torch/campaign/baselines/"
                "BENCH_campaign_training_quick.json")
TRAINING_BASELINE = "benchmarks/baselines/BENCH_campaign_training_quick.json"


def profile_train_step(torch, step_fn, state, batch) -> dict:
    """One train step under the profiler: CUDA kernels launched and the
    device-busy share of the step's wall time (a diagnostic: where the
    profiler cannot trace the card it says so and the run goes on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            t_us = getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0))
            if t_us > 0:
                by_name[ev.key] = (t_us / 1e3, ev.count)
    except Exception as e:              # noqa: BLE001 - diagnostic only
        log(f"profiler could not trace the card: {e!r}")
        return {"error": repr(e)}
    device_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "kernels": sum(c for _, c in by_name.values()),
            "top": [{"name": k, "ms": t, "count": c} for k, (t, c) in top]}


def training_phase(torch, dev, out_dir) -> dict:
    """Phase 18: full-width Llama-3.2-1B (at its depth in :data:`DEPTH`)
    trained on the card (float32
    master weights, bf16 compute, 4 accumulated microbatches of 2 x 256
    tokens, the int8 error-feedback gradient reduction checked mod 8191,
    ``TrainLoop(fault_policy="recompute")``, under deterministic
    algorithms): (a) 6 clean steps, every loss finite and ``comm/errors``
    0, the state's reckoned bytes beside the peak allocation, step times
    and a profiled step; (c) the loop's final checksummed checkpoint of
    the full state read back equal; (b) the same 6 steps with one byte of
    the ``mlp`` victim's int8 payload flipped between the encode and the
    reduction at step 3: ``comm/errors`` 1 there, one faulty step and one
    recompute, final params equal to (a)'s bit for bit; what determinism
    costs a step; (d) ``--grid training --quick`` gated against the JAX
    artifacts.  No kernel of the port runs on this path: all six launch
    counters must read 0."""
    import shutil
    import tempfile

    from repro_torch.campaign.artifacts import write_artifacts
    from repro_torch.campaign.diff import diff_artifacts, wilson_gate
    from repro_torch.campaign.executor import run_campaign
    from repro_torch.campaign.grids import training_specs
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inject import victim_leaf_index
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import make_dataset
    from repro_torch.data.pipeline import to_device
    from repro_torch.device import deterministic
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          state_bytes, train_state_shapes)
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.runtime import LoopConfig, TrainLoop

    t0 = time.perf_counter()
    card = smi_line()
    wrappers = zero_launches()
    cfg = depth_cut(18, LLAMA)
    model = build_model(cfg)
    ctx = Ctx(quant=False, compute_dtype=torch.bfloat16, no_remat=True)
    n_steps, batch, seq = 6, 8, 256
    dataset = make_dataset(cfg, ShapeConfig("phase18", "train", seq, batch))
    shapes = train_state_shapes(model, compress=True)
    reckon = {"params": state_bytes(shapes["params"]),
              "m": state_bytes(shapes["opt"]["m"]),
              "v": state_bytes(shapes["opt"]["v"]),
              "residual": state_bytes(shapes["comm"]),
              "total": state_bytes(shapes)}
    free_disk = shutil.disk_usage(tempfile.gettempdir()).free
    log(f"phase 18 on {card}: Llama-3.2-1B full width, {cfg.n_layers} of "
        f"16 layers, {n_steps} steps of "
        f"{batch} x {seq} tokens in {cfg.train_accum} microbatches, state "
        + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in reckon.items())
        + f"; free disk {free_disk / 2**30:.1f} GiB")

    ckpt_root = tempfile.mkdtemp(prefix="phase18_")
    calls = []                  # (step, comm/errors) of every step call

    def recorded(fn):
        def step(state, b):
            new, m = fn(state, b)
            calls.append((int(state["step"]), int(m["comm/errors"])))
            return new, m
        return step

    step_ms = []

    def timed(fn):
        def step(state, b):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            return out
        return step

    def train(tag, payload_hook=None):
        calls.clear()
        step_ms.clear()
        fn = make_train_step(model, ctx, accum=cfg.train_accum,
                             total_steps=n_steps, compress=True,
                             payload_hook=payload_hook)
        losses = []
        loop = TrainLoop(
            timed(recorded(fn)), dataset,
            cfg=LoopConfig(ckpt_dir=str(Path(ckpt_root) / tag),
                           fault_policy="recompute", log_every=1),
            metrics_hook=lambda s, m: losses.append(
                m["loss_final"]))
        if payload_hook is not None:
            # 18c reads 18a's checkpoint; 18b's (another 22 GB write,
            # ~40 s) would be read by nothing
            loop.ckpt = _NoCheckpoints()
        with deterministic():
            # no reference to the initial state is kept here: the loop
            # holds the pre-step state and the step builds the new one
            final, _ = loop.run(init_train_state(model, 0, compress=True,
                                                 device=dev), n_steps)
        return loop, final, losses, list(calls), list(step_ms), fn

    try:
        # ----------------------- 18a. six clean steps ----------------------
        # earlier phases' tensors still held (the DLRM tables) are not
        # this path's: the peak is read above what was allocated before
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loop_a, final_a, losses, calls_a, ms_a, fn_a = train("a")
        peak = torch.cuda.max_memory_allocated() - held
        if not (len(losses) == n_steps and all(math.isfinite(x)
                                               for x in losses)):
            fail(f"phase 18a: losses {losses}")
        if any(e for _, e in calls_a) or loop_a.stats != {
                "recomputes": 0, "restores": 0, "faulty_steps": 0}:
            fail(f"phase 18a: clean steps flagged: {calls_a} "
                 f"{loop_a.stats}")
        med = statistics.median(ms_a[1:])
        log(f"18a: losses {[round(x, 4) for x in losses]}, comm/errors 0 "
            f"at every step; step ms {[round(x, 1) for x in ms_a]} "
            f"(median of steps 1-5 {med:.1f} ms, "
            f"{batch * seq / med * 1e3:.0f} tokens/s); peak allocated "
            f"{peak / 2**30:.2f} GiB over the {held / 2**30:.2f} GiB "
            f"earlier phases hold, against the state's "
            f"{reckon['total'] / 2**30:.2f} GiB ({card})")
        data0 = to_device(dataset.batch_at(0), dev)
        with deterministic():
            prof = profile_train_step(torch, fn_a, final_a, data0)
        log(f"18a: one profiled step: {prof.get('kernels')} kernels, "
            f"device {prof.get('device_ms', 0):.1f} ms of "
            f"{prof.get('wall_ms', 0):.1f} ms wall (busy "
            f"{prof.get('busy_share')}); top "
            + "; ".join(f"{t['name'][:40]} {t['ms']:.2f}ms x{t['count']}"
                        for t in prof.get("top", [])[:6]))

        # ---------- 18c. the loop's final checkpoint of the full state -----
        save = dict(loop_a.ckpt.last_save)
        step_dir = Path(ckpt_root) / "a" / f"step_{n_steps:09d}"
        on_disk = sum(p.stat().st_size for p in step_dir.iterdir())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = load_checkpoint(str(Path(ckpt_root) / "a"), n_steps,
                               final_a)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        bad = [i for i, (a, b) in enumerate(zip(tree_leaves(final_a),
                                                tree_leaves(back)))
               if a.dtype != b.dtype or not torch.equal(a, b)]
        if bad or save.get("step") != n_steps:
            fail(f"phase 18c: restored leaves {bad} differ ({save})")
        del back
        log(f"18c: the final state ({len(tree_leaves(final_a))} leaves, "
            f"{on_disk / 2**30:.2f} GiB on disk) saved by the loop: the "
            f"caller held {save['snapshot_s']:.2f} s (checksums on the "
            f"card, host copies), the write done {save['write_s']:.2f} s "
            f"after the save began; restored and checksum-verified on the "
            f"card in {restore_s:.2f} s, equal leaf for leaf ({card})")
        params_a = final_a["params"]

        # ------------- determinism's cost: steps in turns, on / off --------
        turns = {"deterministic": [], "default": []}
        for mode in ("deterministic", "default", "default",
                     "deterministic"):
            torch.use_deterministic_algorithms(mode == "deterministic")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn_a(final_a, data0)
            torch.cuda.synchronize()
            turns[mode].append((time.perf_counter() - t1) * 1e3)
        torch.use_deterministic_algorithms(False)
        det_cost = statistics.mean(turns["deterministic"]) / \
            statistics.mean(turns["default"]) - 1.0
        log(f"determinism: step ms deterministic {turns['deterministic']} "
            f"default {turns['default']}: {100 * det_cost:+.1f}% a step")
        shutil.rmtree(Path(ckpt_root) / "a", ignore_errors=True)
        del final_a

        # ------ 18b. a payload byte flipped in transit at step 3 ------------
        vidx, vpath = victim_leaf_index(params_a, "mlp", prefer_int8=False)
        struck = []

        def flip_at_3(payload, state):
            if int(state["step"]) == 3 and not struck:
                leaf = tree_leaves(payload["q"])[vidx]
                leaf.view(-1).view(torch.uint8)[12345] ^= 1 << 6
                struck.append(int(state["step"]))
            return payload

        loop_b, final_b, losses_b, calls_b, ms_b, _ = train(
            "b", payload_hook=flip_at_3)
        want_calls = [(0, 0), (1, 0), (2, 0), (3, 1), (3, 0), (4, 0),
                      (5, 0)]
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params_a), tree_leaves(final_b["params"])))
        if calls_b != want_calls or loop_b.stats != {
                "recomputes": 1, "restores": 0, "faulty_steps": 1} \
                or not same:
            fail(f"phase 18b: calls {calls_b} (want {want_calls}), stats "
                 f"{loop_b.stats}, final params equal to 18a: {same}")
        log(f"18b: a byte of {vpath}'s int8 payload flipped in transit at "
            f"step 3: comm/errors per call {calls_b}, loop stats "
            f"{loop_b.stats}, final params equal to 18a's bit for bit")
        del final_b, params_a
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_root, ignore_errors=True)

    # ------------- 18d. --grid training --quick on the card ----------------
    t1 = time.perf_counter()
    grid = run_campaign("training_quick", training_specs(0, quick=True),
                        device=dev, verbose=log)
    grid_s = time.perf_counter() - t1
    if out_dir:
        write_artifacts(grid, str(Path(out_dir) / "campaign"))
    refs = {}
    for name, path in (("jax_now", TRAINING_JAX),
                       ("baseline", TRAINING_BASELINE)):
        with open(ROOT / path) as f:
            refs[name] = json.load(f)
    cells = {c["cell_id"]: c["metrics"] for c in grid["cells"]}
    gates = {k: wilson_gate(r, grid) for k, r in refs.items()}
    diffs = {k: diff_artifacts(r, grid) for k, r in refs.items()}
    for k in refs:
        if gates[k]["failed"] or gates[k]["uncovered"] or \
                len(gates[k]["cells"]) != 11:
            fail(f"training grid outside the {k} Wilson intervals: "
                 f"{gates[k]['failed']} {gates[k]['uncovered']}")
        # the differ may flag only a bound-0 seam's masked share (ROADMAP
        # §C11): never an FP rate, a lost cell or a checked seam
        for r in diffs[k]["regressions"]:
            m = cells.get(r["cell_id"], {})
            if r["kind"] != "detection_rate" or \
                    m.get("analytic_bound") != 0.0 or m.get("detected"):
                fail(f"training grid: differ regression vs {k}: {r}")
    for cid, m in cells.items():
        if m["false_positives"]:
            fail(f"training grid: {cid} flagged a clean run")
        if cid.startswith("train_payload/") and "/int8" in cid:
            if m["detected"] != m["samples"] or \
                    m["detection_latency_hist"][0] != m["samples"]:
                fail(f"training grid: {cid} missed a payload flip: {m}")
        elif m["detected"]:
            fail(f"training grid: {cid} detected a flip outside the "
                 f"checksum: {m}")
    post = cells["train_grad_post/bitflip/significant/2x16/float32"]
    if not (post["divergence_mean"] > 0 and post["escapes"] > 0):
        fail(f"training grid: grad_post shows no divergence: {post}")
    log(f"--grid training --quick on the card in {grid_s:.1f}s: " + "; ".join(
        f"{cid} detect {m['detected']}/{m['samples']} escape "
        f"{m['escapes']} div {m['divergence_mean']:.3g}"
        for cid, m in cells.items())
        + "; Wilson overlap with the JAX CLI's artifact and the baseline "
          "in every cell; differ (masked shares only): "
        + "; ".join(f"{k} " + str([(r["cell_id"], r["old"], r["new"])
                                   for r in d["regressions"]])
                    for k, d in diffs.items()))

    launches = read_launches(wrappers)
    if any(launches.values()):
        fail(f"phase 18: the training path launched a kernel: {launches}")
    seconds = time.perf_counter() - t0
    record = {"card": card, "seconds": seconds, "state_bytes": reckon,
              "peak_allocated": peak, "held_before": held,
              "free_disk": free_disk,
              "losses": losses, "step_ms": ms_a, "step_ms_median": med,
              "tokens_per_s": batch * seq / med * 1e3, "profile": prof,
              "checkpoint": {**save, "restore_s": restore_s,
                             "bytes_on_disk": on_disk},
              "determinism_turns_ms": turns,
              "determinism_cost": det_cost,
              "flip_calls": calls_b, "flip_stats": loop_b.stats,
              "flip_step_ms": ms_b,
              "grid_seconds": grid_s,
              "grid": {cid: {k: m[k] for k in (
                  "samples", "detected", "corrupted", "escapes",
                  "divergence_mean", "loss_divergence_mean",
                  "detection_latency_hist", "protected_s",
                  "unprotected_s")} for cid, m in cells.items()},
              "grid_differ": {k: d["regressions"] for k, d in diffs.items()}}
    log(f"phase 18 launches (all six must be 0): {launches}; "
        f"{seconds:.1f}s")
    return {"launches": launches, "record": record}


#: phase 19's families, served in this order (internlm2, the largest,
#: last), each with the victim of its injected weight flip and the step it
#: is flipped at (0: a request's prefill, 1: its first decode step)
FAMILY_FLIPS = {"whisper-large-v3": ("dec.layers.mlp.down", 1),
                "hymba-1.5b": ("ssm.out_proj", 1),
                "llava-next-mistral-7b": ("projector.fc1", 0),
                "internlm2-20b": ("attn.wq", 1)}
#: a phase-19 request's prompt bucket and new tokens
FAMILY_PROMPT, FAMILY_NEW = 64, 16
#: K1 calls at each shape of phase 19 whose K is not a whole number of
#: K1's 128-row stages (hymba's d 1600), queued without a sync
FAMILY_REPEATS = 64


def family_k1_per_step(cfg) -> tuple:
    """K1 launches (each after one K3) of a prefill and of a decode step,
    reckoned from the code: the protected linears a step calls, and the
    head."""
    n_layers = cfg.n_layers
    if cfg.family == "encdec":
        # encoder: 4 attention + 2 MLP a layer; decoder prefill: 4 self,
        # 4 cross, 2 MLP and the cache's cross.wk / cross.wv a layer; a
        # decode step: 4 self, the cross q and o, 2 MLP a layer
        return (6 * cfg.enc_layers + 12 * n_layers + 1,
                8 * n_layers + 1)
    # 4 attention, 3 (SwiGLU) or 2 MLP, and hymba's 3 SSM projections
    per = 4 + (3 if cfg.gated_mlp else 2) + \
        (3 if cfg.family == "hybrid" else 0)
    # llava's prefill runs the 2-layer patch projector first
    return (per * n_layers + 1 + (2 if cfg.patch_dim else 0),
            per * n_layers + 1)


def family_gemms(cfg, params, m_prefill: int) -> list:
    """``(name, stacked B' [layers, k, n + 128], ms)`` at every projection
    shape of the family's step, each at the m the serve hands it: the
    prefill's rows (``m_prefill``: the bucket and the meta tokens or
    patches; whisper's encoder and cross K/V at its 1500 frames; llava's
    projector at its 576 patches), a decode step's 4, the head's 1 and 4.
    An attention's ``wo`` has ``wq``'s shape, a SwiGLU's ``up`` its
    ``gate``'s."""
    if cfg.family == "encdec":
        enc, dec, t = params["enc"]["layers"], params["dec"]["layers"], \
            cfg.enc_seq
        return [("enc.attn.wq", enc["attn"]["wq"]["w_packed"], (t,)),
                ("enc.mlp.up", enc["mlp"]["up"]["w_packed"], (t,)),
                ("enc.mlp.down", enc["mlp"]["down"]["w_packed"], (t,)),
                ("dec.self.wq", dec["self"]["wq"]["w_packed"],
                 (m_prefill, 4)),
                ("dec.mlp.up", dec["mlp"]["up"]["w_packed"], (m_prefill, 4)),
                ("dec.mlp.down", dec["mlp"]["down"]["w_packed"],
                 (m_prefill, 4)),
                ("dec.head", params["dec"]["head"]["w_packed"][None],
                 (1, 4))]
    lay = params["layers"]
    out = [(f"{blk}.{w}", lay[blk][w]["w_packed"], (m_prefill, 4))
           for blk, w in (("attn", "wq"), ("attn", "wk"), ("mlp", "gate"),
                          ("mlp", "down"))]
    if cfg.family == "hybrid":
        out += [(f"ssm.{w}", lay["ssm"][w]["w_packed"], (m_prefill, 4))
                for w in ("in_proj", "x_proj", "out_proj")]
    if cfg.patch_dim:
        out += [(f"projector.{w}",
                 params["projector"][w]["w_packed"][None],
                 (cfg.n_patches,)) for w in ("fc1", "fc2")]
    out.append(("lm_head", params["lm_head"]["w_packed"][None], (1, 4)))
    return out


def profile_step(torch, fn) -> dict:
    """Device time of one call of ``fn`` against its wall time (a
    synchronize after it): the busy share of, say, one decode step or one
    training step.  -> device ms, wall ms, device operations (kernels,
    copies, fills) and the busy share.  Only the card's activity is
    traced (the host's ops would multiply the profiler's own cost), and
    it is read from the profiler's raw events: turning each into a
    ``FunctionEvent`` for ``key_averages`` takes ~0.25 ms an event, longer
    than a step of 10^4-10^6 of them.  A diagnostic: where the profiler
    cannot trace the card it says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        evs = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        dev_ms = sum(e.duration_ns() for e in evs) / 1e6
    except Exception as e:              # noqa: BLE001 - diagnostic only
        log(f"profiler could not trace the card: {e!r}")
        return {"error": repr(e)}
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "kernels": len(evs),
            "busy_share": dev_ms / wall_ms if wall_ms else None}


def family_phase(torch, dev) -> dict:
    """Phase 19: ROADMAP A7's four families, each built at full width on
    the card from seed 0 (int8; hymba, llava and internlm2 at the depths
    of :data:`DEPTH`) and served through K1-K3 on a bf16-cache
    and a ``*:policy=recompute,kv_cache:on`` tenant, one at a time, each
    model and its lanes freed before the next.  Returns each family's
    launch counts and the record."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import reduce_cfg
    from repro_torch.core import EB_REL_BOUND
    from repro_torch.core.inject import leaf_paths, victim_leaf_index
    from repro_torch.kernels import ref
    from repro_torch.kernels.abft_embeddingbag import eb_plan
    from repro_torch.kernels.abft_qgemm import (BK, abft_qgemm_cuda,
                                                 launch_plan)
    from repro_torch.models.base import build_model
    from repro_torch.protect import ProtectionPlan, default_plan
    from repro_torch.serving import (FaultInjection, Request, ServingEngine,
                                     TenantSpec)

    kv_plan = dataclasses.replace(default_plan().with_rules(
        *ProtectionPlan.from_any(KV_PLAN).rules), name="kv")
    launches_by, record = {}, {"card": smi_line()}
    gen = torch.Generator(device=dev).manual_seed(19)
    for arch, (victim, flip_step) in FAMILY_FLIPS.items():
        t_fam = time.perf_counter()
        cfg = depth_cut(19, arch)
        short = arch.split("-")[0]
        rec = {"seconds_by_part": {}}
        mark = [t_fam]

        def part(name):
            now = time.perf_counter()
            rec["seconds_by_part"][name] = now - mark[0]
            mark[0] = now

        # ------------------- 19a. build, bytes against the peak ---------
        # an engine's lanes and steps hold it in reference cycles: the
        # last family's model is freed only by a collection
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        extra = cfg.meta_tokens + 8 + (cfg.n_patches if cfg.patch_dim
                                       else 0)
        cache_len = FAMILY_PROMPT + FAMILY_NEW + extra
        shapes = build_model(cfg, max_pos=cache_len + 8).init(
            0, quant=True, device="meta")
        metas = [t for _, t in leaf_paths(shapes)]
        reckoned = sum(t.numel() * t.element_size() for t in metas)
        # init_stacked writes each layer into the stacked leaves, so the
        # peak is the model and the temporaries of one weight's init:
        # the int8 block, B' and int32 row and column sums (~12 B an
        # element of the largest, as whisper's build measured); a list
        # of layers stacked at the end would add the whole stack
        n_stack = cfg.n_layers + cfg.enc_layers
        stacked = sum(t.numel() * t.element_size() for t in metas
                      if t.dim() and t.shape[0] in (cfg.n_layers,
                                                    cfg.enc_layers))
        biggest = max(t[0].numel() if t.dim() == 3 else t.numel()
                      for t in metas if t.dtype == torch.int8)
        peak_reckoned = held + reckoned + 12 * biggest
        peak_bound = held + reckoned + stacked
        log(f"{arch}: reckoned int8 model {reckoned / 1e9:.3f} GB "
            f"({stacked / 1e9:.3f} GB of it in {n_stack} stacked layers); "
            f"held before the build {held / 2**30:.2f} GiB; reckoned peak "
            f"{peak_reckoned / 2**30:.2f} GiB (held + model + 12 B x the "
            f"largest weight's {biggest} elements), under "
            f"{peak_bound / 2**30:.2f} GiB (held + model + a second stack) "
            f"on {record['card']}")
        t0 = time.perf_counter()
        engine = ServingEngine(cfg, [TenantSpec("default", default_plan()),
                                     TenantSpec("kv", kv_plan)],
                               n_slots=4, max_prompt=FAMILY_PROMPT,
                               max_new_tokens=FAMILY_NEW, seed=0,
                               device=dev)
        torch.cuda.synchronize()
        params = engine.params
        got = sum(t.numel() * t.element_size()
                  for _, t in leaf_paths(params))
        peak = torch.cuda.max_memory_allocated()
        rec["bytes"] = {"reckoned": reckoned, "built": got, "held": held,
                        "stacked": stacked, "peak": peak,
                        "peak_reckoned": peak_reckoned,
                        "peak_bound": peak_bound,
                        "temporaries_per_element": (peak - held - got)
                        / biggest,
                        "build_s": time.perf_counter() - t0}
        log(f"{arch} on the card in {rec['bytes']['build_s']:.1f}s: "
            f"{got / 1e9:.3f} GB of parameters (reckoned "
            f"{reckoned / 1e9:.3f}); peak {peak / 2**30:.2f} GiB allocated "
            f"(reckoned {peak_reckoned / 2**30:.2f}, bound "
            f"{peak_bound / 2**30:.2f}; the build's temporaries "
            f"{rec['bytes']['temporaries_per_element']:.2f} B an element "
            f"of the largest weight); cache_len {engine.cache_len}")
        if got != reckoned or engine.cache_len != cache_len:
            fail(f"{arch}: built {got} B against {reckoned} reckoned, "
                 f"cache_len {engine.cache_len} against {cache_len}")
        if peak >= peak_bound:
            fail(f"{arch}: the build peaked at {peak} B, as high as a "
                 f"second stack of its layers ({peak_bound})")
        lanes = {lane.key: lane for lane in engine.lanes}
        if sorted(lanes) != ["lane0[default]", "lane1[kv]"]:
            fail(f"unexpected {arch} lanes {sorted(lanes)}")
        part("build")

        # ---------------- 19b. K1 and K3 at the family's shapes ----------
        m_prefill = FAMILY_PROMPT + cfg.meta_tokens + (
            cfg.n_patches if cfg.patch_dim else 0)
        gemms = family_gemms(cfg, params, m_prefill)
        rec["gemms"] = check_gemms(torch, dev, gen, gemms)
        partial = []
        for name, stack, ms_ in gemms:
            bp = stack[-1]
            k, n = bp.shape[0], bp.shape[1] - 128
            if k % BK == 0:
                continue
            for m in ms_:
                plan = launch_plan(m, k, n, a_addr=0, b_addr=bp.data_ptr())
                a = torch.randint(-128, 128, (m, k), generator=gen,
                                  device=dev, dtype=torch.int8)
                for col in (False, True):
                    want = ref.abft_qgemm_ref(a, bp, with_colcheck=col)
                    outs = [abft_qgemm_cuda(a, bp, with_colcheck=col)
                            for _ in range(FAMILY_REPEATS)]
                    bad = [i for i, g in enumerate(outs)
                           if not all(torch.equal(x, w)
                                      for x, w in zip(g, want))]
                    if bad:
                        c0 = outs[bad[0]][0]
                        where = (c0 != want[0]).nonzero().tolist()[:4]
                        fail(f"{arch} {name} m={m} (k={k}, n={n}, col "
                             f"check {col}): {len(bad)} of "
                             f"{FAMILY_REPEATS} repeated K1 calls differ "
                             f"(first {bad[:4]}, C at {where})")
                partial.append(f"{name} m={m} (k, n) = ({k}, {n}): aligned "
                               f"{plan.aligned}, splits {plan.splits}, "
                               f"k % {BK} = {k % BK}")
        rec["partial_k_repeats"] = partial
        part("k1_k3")
        log(f"{arch}: K1 (C, err_rows, column check) and K3 (bf16 and f32) "
            f"bit-exact at " + "; ".join(rec["gemms"])
            + (f"; K1 {FAMILY_REPEATS} x 2 repeated calls bit-exact where "
               f"K is not a whole number of stages: " + "; ".join(partial)
               if partial else ""))

        # ------------ 19c. K2 at the token table, then every row ---------
        emb = params["dec"]["embed"] if cfg.family == "encdec" \
            else params["embed"]
        enc4 = (emb["table"][None], emb["alphas"][None], emb["betas"][None],
                emb["rowsums"][None])
        req0 = Request(rid=0, tenant="default", arrival_s=0.0,
                       prompt_len=FAMILY_PROMPT, max_new_tokens=2, seed=5)
        prompt = torch.from_numpy(engine._chat_tokens(
            req0, FAMILY_PROMPT).astype(np.int32)).to(dev)
        rec["k2_checks"] = {f"{n} tokens": eb_checks(
            torch, enc4, prompt[:n].reshape(1, -1, 1), f"{short} {n} tokens")
            for n in (64, 4)}
        rows, d = emb["table"].shape
        plan = eb_plan(1, 64, 1, d, rows, table_addr=emb["table"].data_ptr())
        passes = math.ceil(plan.lanes / (32 * plan.warps_per_bag))
        rec["k2_team"] = {"lanes": plan.lanes,
                          "warps_per_bag": plan.warps_per_bag,
                          "passes": passes}
        log(f"{arch}: K2 on the {tuple(emb['table'].shape)} token table at "
            f"pool 1 (64 and 4 bags): R bit-exact with the slot-order sum, "
            f"flags equal to the plain branch at rel_bound 1e-3 and 1e-5 and "
            f"to its formula at all three; a row is {plan.lanes} 16-byte "
            f"words on a team of {plan.warps_per_bag} warps: {passes} team "
            f"pass(es) a row")
        scan = scan_token_table(torch, short, emb)
        rec["eb_table_scan"] = scan
        part("k2")

        # ------------------ 19d. serve both tenants ----------------------
        pre, dec = family_k1_per_step(cfg)
        reqs = [Request(rid=i, tenant=("default", "kv")[i % 2],
                        arrival_s=0.0, prompt_len=FAMILY_PROMPT,
                        max_new_tokens=FAMILY_NEW, seed=100 + i)
                for i in range(4)]
        with eb_flag_tap() as seen:
            wrappers = zero_launches()
            tel = engine.run(reqs)             # the warm-up runs inside
            launches = read_launches(wrappers)
            flags = flagged_tokens(torch, seen)
        s = tel.summary()
        counters, per = s["faults"]["counters"], s["per_tenant"]
        kinds = [ev.kind for ev in tel.steps]
        n_pre, n_dec = kinds.count("prefill"), kinds.count("decode")
        steps = {(kind, key): [ev.duration_s * 1e3 for ev in tel.steps
                               if ev.kind == kind and ev.lane == key]
                 for kind in ("prefill", "decode") for key in lanes}
        if flags:
            # each flag of a clean serve: a token the table scan flagged,
            # witnessed again alone
            again = eb_token_scan(torch, emb, EB_REL_BOUND, torch.tensor(
                sorted(set(flags)), device=dev))
            if sorted(again["k2_flagged"]) != sorted(set(flags)) or \
                    not set(flags) <= set(scan["k2_flagged"]):
                fail(f"{arch}: the EmbeddingBag flagged tokens {flags} in "
                     f"the clean serve, {again['k2_flagged']} of them "
                     f"alone, the table scan {scan['k2_flagged']}")
            rec["eb_flags"] = {"flagged": flags, **again}
        # the warm-up ran one prefill and one decode step a lane in the
        # window; a recompute lane re-runs a flagged EmbeddingBag once
        want_l = {"abft_qgemm": pre * (n_pre + 2) + dec * (n_dec + 2),
                  "quantize_rows": pre * (n_pre + 2) + dec * (n_dec + 2),
                  "abft_embeddingbag": len(kinds) + 4 + counters["retries"],
                  "wkv6_chunked": 0, "qgemm_unprotected": 0,
                  "eb_unprotected": 0}
        kv_reads = cfg.n_layers * len(steps[("decode", "lane1[kv]")])
        log(f"{arch}: served {sum(p['requests'] for p in per.values())} "
            f"chat requests at t = 0 over two tenants: " + "; ".join(
                f"{t}: {p['completed']} completed, {p['tokens_out']} tokens"
                for t, p in per.items())
            + f"; {n_pre} prefill and {n_dec} decode steps; launches "
            f"{launches}, reckoned {want_l} (K1 {pre} a prefill, {dec} a "
            f"decode step, each after one K3; K2 one a step, the warm-up's "
            f"2 + 2 steps included); counters "
            f"{ {k: v for k, v in counters.items() if v} }; EmbeddingBag "
            f"flags {flags}")
        if sum(p["completed"] for p in per.values()) != 4 or \
                any(p["aborted"] for p in per.values()):
            fail(f"not every {arch} request completed: {per}")
        n_eb = len(flags)
        if counters["qgemm_errors"] or counters["kv_cache_errors"] or \
                counters["embedding_bag_errors"] > n_eb or \
                bool(counters["embedding_bag_errors"]) != bool(n_eb) or \
                counters["qgemm_checks"] != pre * n_pre + dec * n_dec or \
                counters["embedding_bag_checks"] != len(kinds) or \
                counters["kv_cache_checks"] != kv_reads:
            fail(f"{arch} counters {counters} for {n_pre} prefill and "
                 f"{n_dec} decode steps (EmbeddingBag flags {flags})")
        if launches != want_l:
            fail(f"{arch} launches {launches} differ from the path's "
                 f"{want_l}")
        toks = [t for r in tel.requests for t in (r.tokens or [])]
        if len(toks) != 4 * FAMILY_NEW or \
                not all(0 <= t < cfg.vocab for t in toks):
            fail(f"{arch}: served tokens outside the vocabulary or missing")
        launches_by[short] = launches
        med = {f"{k} {key}": float(np.median(v))
               for (k, key), v in steps.items() if v}
        part("serve")
        # one decode step of the kv lane (its 4 slots) under the profiler
        lane = lanes["lane1[kv]"]
        prof = profile_step(torch, lambda: lane.decode_fn(
            engine.params, lane.cache, lane.tokens, lane.pos))
        part("profile")
        rec["serve"] = {"tenants": per, "launches": launches,
                        "reckoned": want_l, "counters": counters,
                        "k1_per_step": {"prefill": pre, "decode": dec},
                        "steps_ms": {f"{k} {key}": v
                                     for (k, key), v in steps.items()},
                        "step_ms_median": med, "decode_profile": prof}
        log(f"{arch} serve on {record['card']}: step medians ms "
            + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
            + f"; one kv-lane decode step profiled: {prof.get('kernels')} "
            f"kernels, device {prof.get('device_ms', 0):.2f} of "
            f"{prof.get('wall_ms', 0):.2f} ms, busy "
            f"{prof.get('busy_share')}")

        # -------------- 19e. an injected flip, flagged at its step -------
        idx, path = victim_leaf_index(params, victim)
        leaf = leaf_paths(params)[idx][1]
        engine.reset_state()
        fp0 = leaf_fingerprint(torch, leaf)
        with eb_flag_tap() as seen:
            tel = engine.run([Request(
                rid=0, tenant="default", arrival_s=0.0,
                prompt_len=FAMILY_PROMPT, max_new_tokens=3, seed=3)],
                inject=[FaultInjection(step=flip_step, victim=victim,
                                       seed=0)], warmup=False)
            eb = flagged_tokens(torch, seen)
        (inj,) = tel.injections
        k1_flagged = [ev.step for ev in tel.steps
                      if ev.counters["qgemm_errors"]]
        if inj.victim != path or not inj.detected or \
                inj.detect_step != flip_step or k1_flagged != [flip_step] \
                or leaf_fingerprint(torch, leaf) != fp0 or \
                not set(eb) <= set(scan["k2_flagged"]):
            fail(f"{arch} {victim} flip at step {flip_step}: {inj}; K1 "
                 f"flagged steps {k1_flagged}; EmbeddingBag flags {eb}; "
                 f"leaf restored {leaf_fingerprint(torch, leaf) == fp0}")
        rec["flip"] = {"victim": inj.victim, "step": inj.step,
                       "detect_step": inj.detect_step,
                       "qgemm_errors": sum(ev.counters["qgemm_errors"]
                                           for ev in tel.steps),
                       "eb_flags": eb}
        log(f"{arch} FaultInjection: {inj.victim} flipped at step "
            f"{flip_step} ({'prefill' if flip_step == 0 else 'decode'}), "
            f"flagged there only ({rec['flip']['qgemm_errors']} qgemm "
            f"errors) and restored bit for bit")
        del engine, params, leaf, lane, tel, emb, enc4, gemms
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        part("flip")

        # -------------- 19f. the reduced model, card against CPU ---------
        small = reduce_cfg(cfg)
        if small.family == "hybrid":
            # the reduced hymba's two layers are both global: a third
            # (layer 1) slides its 8-token window over the 24-token
            # prompt after the 4 meta tokens
            small = dataclasses.replace(small, n_layers=3)
        model = build_model(small)
        rng = np.random.default_rng(17)
        inputs = {}
        if small.patch_dim:
            inputs["patches"] = torch.from_numpy(rng.standard_normal(
                (2, small.n_patches, small.patch_dim)).astype(np.float32))
        if small.family == "encdec":
            inputs["frames"] = torch.from_numpy(rng.standard_normal(
                (2, small.enc_seq, small.d_model)).astype(np.float32))
        rec["small_card_vs_cpu"] = small_card_vs_cpu(
            torch, dev, small, model,
            model.init(0, quant=True, device="cpu"), default_plan(), (24,),
            f32_after_split=2.0**-5, extra=inputs)
        part("small_card_vs_cpu")
        rec["seconds"] = time.perf_counter() - t_fam
        log(f"phase 19 {arch}: {rec['seconds']:.1f}s (" + ", ".join(
            f"{k} {v:.1f}" for k, v in rec["seconds_by_part"].items())
            + ")")
        record[short] = rec
    return {"launches": launches_by, "record": record}


#: phase 20's families, trained in this order (granite last: its run is
#: repeated with a payload flip)
TRAIN_FAMILIES = ("rwkv6-1.6b", "whisper-large-v3", "hymba-1.5b",
                  "llava-next-mistral-7b", "granite-moe-3b-a800m")
#: text tokens a sequence (the train CLI's --seq-len; hymba's meta tokens
#: and llava's patches come on top)
TRAIN_TEXT = 256
#: steps a family: 2, and granite 3 (its payload flip strikes step 2)
TRAIN_STEPS = {"granite-moe-3b-a800m": 3}


class _NoCheckpoints:
    """A ``CheckpointManager`` stand-in that saves and restores nothing:
    phase 20's loops write no checkpoint of their 22-55 GiB states
    (phase 18 holds the loop's checkpoints)."""

    last_save = None

    def maybe_save(self, step, state, *, force=False):
        return None

    def wait(self):
        return None

    def restore_latest(self, like, *, verify=True):
        return None


def reduced_train_card_vs_cpu(torch, dev, arch: str) -> dict:
    """The reduced model's loss and every gradient leaf on the card
    against the CPU run, float32 and bf16 compute, on the same weights
    and batch (seed 0), under deterministic algorithms, within
    :mod:`repro_torch.launch.parity`'s tolerances, card against CPU."""
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inject import leaf_paths
    from repro_torch.data import make_dataset
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.device import deterministic
    from repro_torch.launch.parity import (grad_scale, grad_tolerance,
                                           loss_tolerance)
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.models.convert import to_device

    cfg = reduce_cfg(get_arch(arch))
    prefix = cfg.meta_tokens + cfg.n_patches
    model = build_model(cfg, max_pos=16 + prefix + 8)
    p_cpu = model.init(0, device="cpu")
    p_dev = to_device(p_cpu, dev)
    batch = make_dataset(cfg, ShapeConfig("p20", "train", 16 + prefix, 2)
                         ).batch_at(0)
    out = {}
    for dtype in ("float32", "bfloat16"):
        fn = make_grad_fn(model, Ctx(quant=False, no_remat=True,
                                     compute_dtype=getattr(torch, dtype)))
        with deterministic():
            (l_c, _), g_c = fn(p_cpu, batch_to(batch, "cpu"))
            (l_d, _), g_d = fn(p_dev, batch_to(batch, dev))
        loss_err = abs(float(l_d) - float(l_c)) / abs(float(l_c))
        named_c = dict(leaf_paths(g_c))
        tol = grad_tolerance(cfg, dtype)
        worst = (0.0, "")
        for (path, a), (_, b) in zip(leaf_paths(g_c), leaf_paths(g_d)):
            err = float((a.float() - b.float().cpu()).abs().max()) / \
                grad_scale(path, named_c)
            worst = max(worst, (err, path))
        out[dtype] = {"loss_rel_err": loss_err, "worst_leaf": worst[1],
                      "worst_leaf_err": worst[0], "tolerance": tol}
    bad = {d: r for d, r in out.items()
           if r["loss_rel_err"] > loss_tolerance(cfg, d, card=True)
           or r["worst_leaf_err"] > r["tolerance"]}
    if bad:
        fail(f"phase 20 {arch}: reduced card vs CPU outside the "
             f"tolerances: {bad}")
    return out


def train_family(torch, dev, arch: str, n_steps: int = 2,
                 flip: bool = False) -> dict:
    """One family trained at full width on the card as the train CLI
    trains it (float32 master weights, bf16 compute, its
    ``train_accum``, the checked int8 compression,
    ``TrainLoop(fault_policy="recompute")``, deterministic algorithms),
    ``n_steps`` steps at its phase-20 depth (:data:`DEPTH`); with
    ``flip`` a second run flips one byte of the MoE expert stack's int8
    payload in transit at step 2, which must be caught in comm/errors,
    recomputed and end bit-equal to the clean run."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inject import victim_leaf_index
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import make_dataset
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.device import deterministic
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          state_bytes, train_state_shapes)
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.runtime import LoopConfig, TrainLoop

    t0 = time.perf_counter()
    full = get_arch(arch)
    cfg = depth_cut(20, arch)
    # the CLI's batch: 8 sequences (granite's 16 microbatches need 16)
    batch = max(8, cfg.train_accum)
    seq = TRAIN_TEXT + cfg.meta_tokens + cfg.n_patches
    model = build_model(cfg, max_pos=seq + cfg.meta_tokens + 8)
    ctx = Ctx(quant=False, compute_dtype=torch.bfloat16, no_remat=True)
    dataset = make_dataset(cfg, ShapeConfig("phase20", "train", seq, batch))
    shapes = train_state_shapes(model, compress=True)
    reckon = state_bytes(shapes)
    n_params = state_bytes(shapes["params"]) // 4
    del shapes
    calls, step_ms = [], []

    def step_fn(fn):
        def step(state, b):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            new, m = fn(state, b)
            calls.append((int(state["step"]), int(m["comm/errors"])))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            return new, m
        return step

    def train(payload_hook=None):
        calls.clear()
        step_ms.clear()
        fn = make_train_step(model, ctx, accum=cfg.train_accum,
                             total_steps=n_steps, compress=True,
                             payload_hook=payload_hook)
        losses = []
        loop = TrainLoop(step_fn(fn), dataset,
                         cfg=LoopConfig(fault_policy="recompute",
                                        log_every=1),
                         metrics_hook=lambda s, m: losses.append(
                             m["loss_final"]))
        loop.ckpt = _NoCheckpoints()
        with deterministic():
            final, _ = loop.run(init_train_state(model, 0, compress=True,
                                                 device=dev), n_steps)
        return loop, final, losses, fn

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    loop, final, losses, fn = train()
    peak = torch.cuda.max_memory_allocated() - held
    # the caching allocator's flush-and-retry of a failed cudaMalloc
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    ms = list(step_ms)
    calls_a = list(calls)
    if not (len(losses) == n_steps and all(math.isfinite(x)
                                           for x in losses)):
        fail(f"phase 20 {arch}: losses {losses}")
    if any(e for _, e in calls_a) or loop.stats != {
            "recomputes": 0, "restores": 0, "faulty_steps": 0}:
        fail(f"phase 20 {arch}: clean steps flagged: {calls_a} "
             f"{loop.stats}")
    med = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    train_s = time.perf_counter() - t0
    data0 = batch_to(dataset.batch_at(0), dev)
    with deterministic():
        prof = profile_step(torch, lambda: fn(final, data0))
    # the step and its captured scan loops go before the next run
    del data0, fn, loop
    prof["seconds"] = time.perf_counter() - t0 - train_s
    rec = {"n_layers": cfg.n_layers, "full_layers": full.n_layers,
           "batch": batch, "seq": seq, "accum": cfg.train_accum,
           "params": n_params, "state_bytes": reckon, "held_before": held,
           "peak_allocated": peak, "alloc_retries": retries,
           "losses": losses, "calls": calls_a,
           "step_ms": ms, "step_ms_median": med,
           "text_tokens_per_s": batch * TRAIN_TEXT / med * 1e3,
           "train_s": train_s, "profile": prof}
    if flip:
        vidx, vpath = victim_leaf_index(final["params"], "moe.gate",
                                        prefer_int8=False)
        clean = [t.cpu() for t in tree_leaves(final["params"])]
        del final
        struck = []

        def flip_at_2(payload, state):
            if int(state["step"]) == 2 and not struck:
                leaf = tree_leaves(payload["q"])[vidx]
                leaf.view(-1).view(torch.uint8)[leaf.numel() // 2 + 7] ^= 1 << 6
                struck.append(int(state["step"]))
            return payload

        loop_b, final, _, fn = train(payload_hook=flip_at_2)
        want = [(s, 0) for s in range(2)] + [(2, 1), (2, 0)] + \
            [(s, 0) for s in range(3, n_steps)]
        same = all(torch.equal(a, b.cpu()) for a, b in zip(
            clean, tree_leaves(final["params"])))
        if calls != want or loop_b.stats != {
                "recomputes": 1, "restores": 0, "faulty_steps": 1} \
                or not same:
            fail(f"phase 20 {arch}: flip calls {calls} (want {want}), "
                 f"stats {loop_b.stats}, final params equal to the clean "
                 f"run's: {same}")
        rec.update(flip_victim=vpath, flip_calls=list(calls),
                   flip_stats=loop_b.stats, flip_step_ms=list(step_ms))
        del clean, loop_b, fn
    del final
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def train_families_phase(torch, dev) -> dict:
    """Phase 20: granite-moe-3b-a800m, rwkv6-1.6b, whisper-large-v3,
    hymba-1.5b and llava-next-mistral-7b trained at full width on the
    card (:func:`train_family`; llava and granite at the depths of
    :data:`DEPTH`), granite again with a payload flip; each family's
    reduced model held card against CPU (:func:`reduced_train_card_vs_cpu`).
    Every launch counter is set to 0 before a family and read after it:
    all six must read 0 (no kernel of the port trains; K4 has no
    backward).  Returns the launches by path and the record."""
    card = smi_line()
    launches_by, record = {}, {"card": card}
    for arch in TRAIN_FAMILIES:
        wrappers = zero_launches()
        n_steps = TRAIN_STEPS.get(arch, 2)
        rec = train_family(torch, dev, arch, n_steps,
                           flip=arch == GRANITE)
        rec["reduced_card_vs_cpu"] = reduced_train_card_vs_cpu(
            torch, dev, arch)
        launches = read_launches(wrappers)
        if any(launches.values()):
            fail(f"phase 20 {arch}: the training path launched a kernel: "
                 f"{launches}")
        launches_by[f"train {arch}"] = launches
        record[arch] = rec
        prof = rec["profile"]
        log(f"phase 20 {arch} on {card}: {rec['n_layers']} of "
            f"{rec['full_layers']} layers, {rec['params'] / 1e9:.3f} B "
            f"params, {n_steps} steps of {rec['batch']} x {rec['seq']} in "
            f"{rec['accum']} microbatches; losses "
            f"{[round(x, 4) for x in rec['losses']]}, comm/errors per call "
            f"{rec['calls']}; state {rec['state_bytes'] / 2**30:.2f} GiB, "
            f"peak allocated {rec['peak_allocated'] / 2**30:.2f} GiB over "
            f"{rec['held_before'] / 2**30:.2f} GiB held ("
            f"{rec['alloc_retries']} allocator retries); step ms "
            f"{[round(x, 1) for x in rec['step_ms']]} (median "
            f"{rec['step_ms_median']:.1f}, {rec['text_tokens_per_s']:.0f} "
            f"text tokens/s); profiled step {prof.get('kernels')} kernels, "
            f"busy {prof.get('busy_share')}; reduced card vs CPU "
            + ", ".join(f"{d} loss {r['loss_rel_err']:.2e} worst "
                        f"{r['worst_leaf']} {r['worst_leaf_err']:.2e}"
                        for d, r in rec["reduced_card_vs_cpu"].items())
            + (f"; flip of {rec['flip_victim']} at step 2: calls "
               f"{rec['flip_calls']}, {rec['flip_stats']}, final params "
               f"equal to the clean run's bit for bit"
               if "flip_calls" in rec else "")
            + f"; launches {launches}; {rec['seconds']:.1f}s")
    return {"launches": launches_by, "record": record}


#: phase 21's multidevice grid, gated as the training grid is
MULTIDEVICE_JAX = ("src/repro_torch/campaign/baselines/"
                   "BENCH_campaign_multidevice_quick.json")
MULTIDEVICE_BASELINE = ("benchmarks/baselines/"
                        "BENCH_campaign_multidevice_quick.json")
MULTIDEVICE_ACCEPT = ("train_payload_shard/bitflip/significant/2x16/int8/"
                      "steps2/shards4")


def _mesh_grid_rank(world, out_dir):
    """One of phase 21c's ranks: ``--grid multidevice --quick`` over the
    world (the CLI's rank body), this rank's launch counts from 0 and
    its memory; rank 0 returns the artifact and every rank's record."""
    import argparse

    import torch
    import torch.distributed as dist

    from repro_torch.campaign.__main__ import _grid_rank
    wrappers = zero_launches()
    args = argparse.Namespace(quick=True, seed=0, samples=0, out=out_dir,
                              chunk=0)
    result = _grid_rank(world, "multidevice", args)
    on_card = world.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    mine = {"rank": world.rank, "pid": os.getpid(),
            "device": str(world.device), "backend": world.backend,
            "reserved": torch.cuda.memory_reserved() if on_card else 0,
            "max_allocated": (torch.cuda.max_memory_allocated()
                              if on_card else 0),
            "launches": read_launches(wrappers)}
    every = [None] * world.size
    dist.all_gather_object(every, mine)
    # the card's memory while every rank still holds its context
    used = smi_used_mib() if on_card and world.rank == 0 else None
    dist.barrier()
    if world.rank != 0:
        return None
    return {"artifact": result, "ranks": every, "used_mib": used}


def smi_used_mib():
    """The card's used memory (MiB) as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return int(out.stdout.split()[0])


#: phase 21b's reduced ZeRO-1 run card against CPU: the shares of the
#: master weights' and of the bf16 parameters' update elements that may
#: lie more than lr / 100 apart.  In bf16 compute the card's gradients
#: part from the CPU's by their sums' order, and Adam's second step
#: turns that into update differences: 5.2% of the master's elements
#: and 0.23% of the parameters' on the H100.  A step that skips its
#: update, or takes it with another bias correction, rate or weight
#: decay, moves more than half of them.
ZERO1_OFF_SHARE = {"master": 0.10, "params": 0.01}


def zero1_card_vs_cpu(torch, dev, mesh_dev) -> dict:
    """The reduced Llama's two ZeRO-1 steps over the world of one on the
    card against the same steps over a gloo group of one on the CPU,
    from one start.  The float32 master weights and the bf16 parameters
    are held by their update (the state less the start): every element
    within ``adam_step_tolerance`` (a bf16 parameter one rounding step
    more, where the masters straddle it), at most
    :data:`ZERO1_OFF_SHARE` of them more than lr / 100 apart, the CPU's
    update a real one, and the card's parameters its master weights
    rounded to bf16.  The first moments within ``grad_tolerance(cfg,
    "bfloat16")`` of their largest magnitude, the second (squares)
    within twice that, losses within ``loss_tolerance``."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.data import make_dataset
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.device import deterministic
    from repro_torch.launch.parity import (adam_step_tolerance,
                                           grad_tolerance, loss_tolerance)
    from repro_torch.launch.steps import (init_zero1_state,
                                          make_train_step_zero1, ravel)
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.sharding import DataMesh

    cfg = reduce_cfg(get_arch(LLAMA))
    model = build_model(cfg, max_pos=64)
    ctx = Ctx(quant=False, compute_dtype=torch.bfloat16, no_remat=True)
    data = make_dataset(cfg, ShapeConfig("p21", "train", 16, 4))
    cpu_mesh = DataMesh((0,), None, dist.new_group([0], backend="gloo"))
    lr, n_steps = 1e-4, 2
    runs = {}
    # the port's init draws on the device it is given: both runs start
    # from the CPU's draw
    start = init_zero1_state(model, 0, cpu_mesh, device="cpu")
    for name, device, mesh in (("card", dev, mesh_dev),
                               ("cpu", torch.device("cpu"), cpu_mesh)):
        step = make_train_step_zero1(model, ctx, mesh, accum=2,
                                     peak_lr=lr, warmup=0, total_steps=10)
        state = tree_map(lambda x: x.to(device), start)
        losses = []
        with deterministic():
            for t in range(n_steps):
                state, m = step(state, batch_to(data.batch_at(t), device))
                losses.append(float(m["loss_final"]))
        runs[name] = {"params": ravel(state["params"], torch.float32).cpu(),
                      "opt": {k: v.cpu() for k, v in state["opt"].items()},
                      "losses": losses}
    tol = grad_tolerance(cfg, "bfloat16")
    bound, off_at = adam_step_tolerance(lr, n_steps), lr / 100

    def err(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def bf16_ulp(x):
        x = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
        return torch.exp2(torch.floor(torch.log2(x)) - 7)

    c, p = runs["card"], runs["cpu"]
    begin = {"master": start["opt"]["master"],
             "params": ravel(start["params"], torch.float32)}
    got = {"master": c["opt"]["master"], "params": c["params"]}
    want = {"master": p["opt"]["master"], "params": p["params"]}
    out, bad = {"tolerance": tol, "update_bound": bound}, []
    for k in ("master", "params"):
        off = ((got[k] - begin[k]) - (want[k] - begin[k])).abs()
        slack = bound + (bf16_ulp(torch.maximum(got[k].abs(),
                                                want[k].abs()))
                         if k == "params" else 0.0)
        out[f"{k}_update_max"] = float(off.max())
        out[f"{k}_off_share"] = float((off > off_at).double().mean())
        out[f"{k}_moved_share"] = float(
            ((want[k] - begin[k]).abs() > off_at).double().mean())
        if bool((off > slack).any()) \
                or out[f"{k}_off_share"] > ZERO1_OFF_SHARE[k] \
                or out[f"{k}_moved_share"] <= (0.5 if k == "master"
                                               else 0.25):
            bad.append(k)
    if not torch.equal(c["params"], c["opt"]["master"].to(
            torch.bfloat16).float()):
        bad.append("params are not the master weights in bf16")
    out.update({k: err(c["opt"][k], p["opt"][k]) for k in ("m", "v")})
    out["loss"] = max(abs(a - b) / abs(b) for a, b in zip(c["losses"],
                                                         p["losses"]))
    if out["m"] > tol:
        bad.append("m")
    if out["v"] > 2 * tol:
        bad.append("v")
    if out["loss"] > loss_tolerance(cfg, "bfloat16", card=True):
        bad.append("loss")
    if bad:
        fail(f"phase 21b: the reduced ZeRO-1 steps card vs CPU outside "
             f"the tolerances at {bad}: {out}")
    return out


def mesh_phase(torch, dev, out_dir) -> dict:
    """Phase 21: the data mesh on the card.  Full-width Llama-3.2-1B at
    its depth in :data:`DEPTH` (phase 18's), 8 x 256 tokens in its
    microbatches, bf16 compute, deterministic algorithms, over an NCCL
    world of one rank (this process): (a) the deferred step with the
    checked int8 reduction, 2 steps in ``TrainLoop``, against
    ``make_train_step(compress=True)`` from the same state and batches:
    with one rank the all-reduce is the identity, so the parameters and
    ``comm/errors`` must be equal bit for bit; step ms and a profiled
    step's busy share; (d) the same loop with rank 0's payload flipped
    in transit at the second step: ``comm/errors`` 1 there, one
    recompute, final parameters equal to (a)'s bit for bit; (b) the
    ZeRO-1 step, 2 steps: peak allocation against the reckoned bf16
    parameters and three flat float32 vectors, the reduced model card
    against CPU; (c) ``--grid multidevice --quick`` on 4 gloo ranks
    sharing the card, the world launched once, gated against both JAX
    artifacts as the CPU test is, each rank's memory.  No kernel of the
    port runs on these paths: every launch counter reads 0 (in every
    rank of (c))."""
    import argparse  # noqa: F401
    import tempfile

    from repro_torch.campaign.diff import diff_artifacts, wilson_gate
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inject import victim_leaf_index
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import BatchShard, make_dataset
    from repro_torch.data.pipeline import to_device
    from repro_torch.device import deterministic
    from repro_torch.launch.steps import (init_train_state,
                                          init_zero1_state, make_train_step,
                                          make_train_step_deferred,
                                          make_train_step_zero1,
                                          zero1_state_shapes)
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.runtime import LoopConfig, TrainLoop
    from repro_torch.sharding import (close_world, init_world, launch,
                                      make_data_mesh, rank_device)

    t0 = time.perf_counter()
    card = smi_line()
    launches_by, record = {}, {"card": card}
    cfg = depth_cut(21, LLAMA)
    model = build_model(cfg)
    ctx = Ctx(quant=False, compute_dtype=torch.bfloat16, no_remat=True)
    n_steps, batch, seq = 2, 8, 256
    dataset = make_dataset(cfg, ShapeConfig("phase21", "train", seq, batch))
    store = tempfile.TemporaryDirectory(prefix="phase21_")
    world = init_world(0, 1, os.path.join(store.name, "store"), dev)
    if dev.type == "cuda" and world.backend != "nccl":
        fail(f"phase 21: a world of one on the card took {world.backend}")
    mesh = make_data_mesh(1, device_type=dev.type)
    try:
        # ------ 21a. the deferred step against the one-device step -------
        wrappers = zero_launches()
        calls, step_ms = [], []

        def instrumented(fn):
            def step(state, b):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                new, m = fn(state, b)
                calls.append((int(state["step"]), int(m["comm/errors"])))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                return new, m
            return step

        def train(fn, **loop_kw):
            calls.clear()
            step_ms.clear()
            loop = TrainLoop(instrumented(fn), dataset, cfg=LoopConfig(
                fault_policy="recompute", log_every=1), **loop_kw)
            loop.ckpt = _NoCheckpoints()      # phase 18 holds the loop's
            with deterministic():
                final, _ = loop.run(init_train_state(
                    model, 0, compress=True, device=dev), n_steps)
            return final, loop.stats, list(calls), list(step_ms)

        kw = dict(accum=cfg.train_accum, total_steps=n_steps)
        one, stats_one, calls_one, ms_one = train(
            make_train_step(model, ctx, compress=True, **kw))
        params_one = one["params"]
        del one
        deferred_fn = make_train_step_deferred(model, ctx, mesh, **kw)
        mesh_kw = dict(shardings=BatchShard(0, 1), group=mesh.group)
        final_a, stats_a, calls_a, ms_a = train(deferred_fn, **mesh_kw)
        differ = [i for i, (a, b) in enumerate(zip(
            tree_leaves(params_one), tree_leaves(final_a["params"])))
            if not torch.equal(a, b)]
        if differ or calls_a != calls_one or any(e for _, e in calls_a) \
                or stats_a != stats_one:
            fail(f"phase 21a: the deferred step over a world of one is not "
                 f"the one-device step bit for bit (leaves {differ} differ, "
                 f"calls {calls_a} vs {calls_one}, {stats_a})")
        data0 = to_device(dataset.batch_at(0), dev)
        with deterministic():
            prof = profile_step(torch, lambda: deferred_fn(final_a, data0))
        del final_a
        log(f"21a on {card}: the deferred step (NCCL world of one, "
            f"{cfg.n_layers} of 16 layers, {n_steps} steps of {batch} x "
            f"{seq} in {cfg.train_accum} microbatches) equals "
            f"make_train_step(compress=True) bit for bit: comm/errors per "
            f"call {calls_a}; step ms {[round(x, 1) for x in ms_a]} "
            f"(one-device {[round(x, 1) for x in ms_one]}); profiled step "
            f"{prof.get('kernels')} device operations, "
            f"{prof.get('device_ms', 0):.1f} of {prof.get('wall_ms', 0):.1f}"
            f" ms (busy {prof.get('busy_share')}); "
            f"{time.perf_counter() - t0:.1f}s into the phase")
        record["deferred"] = {"calls": calls_a, "step_ms": ms_a,
                              "one_device_step_ms": ms_one,
                              "profile": prof,
                              "seconds": time.perf_counter() - t0}

        # ------ 21d. rank 0's payload flipped in transit, second step -----
        vidx, vpath = victim_leaf_index(params_one, "mlp",
                                        prefer_int8=False)
        struck = []

        def flip_at_1(payload, state):
            if int(state["step"]) == 1 and not struck:
                leaf = tree_leaves(payload["q"])[vidx]
                leaf.view(-1).view(torch.uint8)[12345] ^= 1 << 6
                struck.append(1)
            return payload

        final_d, stats_d, calls_d, _ = train(make_train_step_deferred(
            model, ctx, mesh, payload_hook=flip_at_1, **kw), **mesh_kw)
        same_d = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params_one), tree_leaves(final_d["params"])))
        want = [(0, 0), (1, 1), (1, 0)]
        if calls_d != want or stats_d != {"recomputes": 1, "restores": 0,
                                          "faulty_steps": 1} or not same_d:
            fail(f"phase 21d: calls {calls_d} (want {want}), {stats_d}, "
                 f"final params equal to 21a's: {same_d}")
        del final_d, params_one
        torch.cuda.empty_cache()
        log(f"21d: a byte of {vpath}'s int8 payload flipped on rank 0 at "
            f"the second step: comm/errors per call {calls_d}, {stats_d}, "
            f"final params equal to 21a's bit for bit; "
            f"{time.perf_counter() - t0:.1f}s into the phase")
        record["flip"] = {"calls": calls_d, "stats": stats_d,
                          "seconds": time.perf_counter() - t0}
        launches_by["mesh deferred"] = read_launches(wrappers)

        # ------------- 21b. the ZeRO-1 step over the world of one ---------
        wrappers = zero_launches()
        shapes, _ = zero1_state_shapes(model, 1)
        reckon = (sum(x.numel() * x.element_size()
                      for x in tree_leaves(shapes["params"]))
                  + 3 * shapes["opt"]["master"].numel() * 4)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zstep = make_train_step_zero1(model, ctx, mesh, **kw)
        zstate = init_zero1_state(model, 0, mesh, device=dev)
        z_ms, z_losses = [], []
        with deterministic():
            for t in range(n_steps):
                b = to_device(dataset.batch_at(t), dev)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                zstate, m = zstep(zstate, b)
                z_losses.append(float(m["loss_final"]))
                z_ms.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated() - held
        del zstate
        torch.cuda.empty_cache()
        if not all(math.isfinite(x) for x in z_losses):
            fail(f"phase 21b: ZeRO-1 losses {z_losses}")
        reduced = zero1_card_vs_cpu(torch, dev, mesh)
        log(f"21b: ZeRO-1 over the world of one: losses "
            f"{[round(x, 4) for x in z_losses]}, step ms "
            f"{[round(x, 1) for x in z_ms]}; peak allocated "
            f"{peak / 2**30:.2f} GiB against the reckoned "
            f"{reckon / 2**30:.2f} GiB (bf16 params + 3 flat f32) over "
            f"{held / 2**30:.2f} GiB held; reduced card vs CPU {reduced}; "
            f"{time.perf_counter() - t0:.1f}s into the phase")
        record["zero1"] = {"step_ms": z_ms, "losses": z_losses,
                           "peak_allocated": peak, "reckoned": reckon,
                           "held_before": held, "reduced": reduced,
                           "seconds": time.perf_counter() - t0}
        launches_by["mesh zero1"] = read_launches(wrappers)
    finally:
        close_world()
        store.cleanup()

    # ------- 21c. the multidevice grid on 4 gloo ranks sharing the card -----
    used_before = smi_used_mib() if dev.type == "cuda" else None
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phase21c_") as scratch:
        grid_dir = str(Path(out_dir) / "campaign") if out_dir else scratch
        got = launch(_mesh_grid_rank, 4, args=(grid_dir,), device=dev)
    grid_s = time.perf_counter() - t1
    grid, ranks = got["artifact"], got["ranks"]
    # the four ranks' device memory: the card's use while they live over
    # its use before (this process's context and cache), a quarter each
    per_rank = ((got["used_mib"] - used_before) / 4
                if used_before is not None else None)
    if [r["backend"] for r in ranks] != ["gloo"] * 4 or \
            {r["device"] for r in ranks} != {str(rank_device(dev, 0))}:
        fail(f"phase 21c: the ranks are not 4 gloo ranks sharing one "
             f"device: {ranks}")
    refs = {}
    for name, path in (("jax_now", MULTIDEVICE_JAX),
                       ("baseline", MULTIDEVICE_BASELINE)):
        with open(ROOT / path) as f:
            refs[name] = json.load(f)
    cells = {c["cell_id"]: c["metrics"] for c in grid["cells"]}
    for k, r in refs.items():
        gate = wilson_gate(r, grid)
        regressions = diff_artifacts(r, grid)["regressions"]
        if gate["failed"] or gate["uncovered"] or len(gate["cells"]) != 4 \
                or regressions:
            fail(f"phase 21c: the multidevice grid against {k}: "
                 f"{gate['failed']} {gate['uncovered']} {regressions}")
    acc = cells[MULTIDEVICE_ACCEPT]
    n = acc["samples"]
    if not (acc["collective_verified"] and acc["raw_detection_rate"] == 1.0
            and acc["escapes"] == 0 and acc["false_positives"] == 0
            and acc["detection_latency_hist"] == [n, 0]
            and acc["shard_detections"] == [n, 0, 0, 0]):
        fail(f"phase 21c: the acceptance cell: {acc}")
    summed = {k: sum(r["launches"][k] for r in ranks)
              for k in ranks[0]["launches"]}
    launches_by["multidevice grid"] = summed
    log(f"21c: --grid multidevice --quick on 4 gloo ranks sharing "
        f"{rank_device(dev, 0)} in {grid_s:.1f}s (the world launched once): "
        + "; ".join(f"{cid} detect {m['detected']}/{m['samples']} escape "
                    f"{m['escapes']} shards {m['shard_detections']}"
                    for cid, m in cells.items())
        + "; Wilson overlap with both JAX artifacts, differ 0 regressions; "
          f"the 4 ranks took {per_rank} MiB of the card each (nvidia-smi "
          f"memory.used {got['used_mib']} MiB while they lived, "
          f"{used_before} MiB before), of it torch reserved "
        + ", ".join(f"{r['reserved'] / 2**20:.0f}" for r in ranks)
        + " MiB a rank; the rest is each rank's CUDA context")
    record["grid"] = {"seconds": grid_s, "ranks": ranks,
                      "used_mib": got["used_mib"],
                      "used_before_mib": used_before,
                      "per_rank_mib": per_rank,
                      "cells": {cid: {k: m[k] for k in (
                          "samples", "detected", "escapes",
                          "false_positives", "shard_detections",
                          "collective_verified")}
                          for cid, m in cells.items()}}
    for path, counts in launches_by.items():
        if any(counts.values()):
            fail(f"phase 21 {path}: a kernel of the port launched: {counts}")
    record["seconds"] = time.perf_counter() - t0
    log(f"phase 21 launches (all six 0 on every path): {launches_by}; "
        f"{record['seconds']:.1f}s")
    return {"launches": launches_by, "record": record}


#: phase 22: a predicted peak against its measurement, and the dry-run
#: cell its CLI runs on this machine's PyTorch
PEAK_TOL = 0.15
DRYRUN_CELL = ("mistral-large-123b", "decode_32k")


def reckon_step(torch, run, args: dict) -> dict:
    """One step on meta tensors under the cost counter and its memory
    tracker (:mod:`repro_torch.launch.costs`): the memory keys, the
    counted cost and its roofline on the H100."""
    from repro_torch.launch.costs import CostCounter
    from repro_torch.launch.roofline import roofline_terms
    counter = CostCounter()
    counter.arguments(args)
    with counter:
        out = run()
    counter.outputs(out)
    del out
    cost = counter.result()
    return {"memory": counter.memory(), "cost": cost,
            "roofline": roofline_terms(cost, n_devices=1)}


def start_dryrun_cli():
    """Phase 22d's subprocess, started with the kernels' build and
    waited for when it ends (:func:`finish_dryrun_cli`), so that it
    shares the host with no timed phase: ``python -m
    repro_torch.launch.dryrun`` on :data:`DRYRUN_CELL`, on no card.
    -> (the process, its output directory)."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="phase22_")
    arch, shape_name = DRYRUN_CELL
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape_name, "--out", out_dir],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                        "CUDA_VISIBLE_DEVICES": ""})
    return proc, out_dir


def finish_dryrun_cli(cli) -> dict:
    """Wait for phase 22d's subprocess: its exit code, the ends of its
    output and its record (None where it wrote none)."""
    proc, out_dir = cli
    arch, shape_name = DRYRUN_CELL
    try:
        out, err = proc.communicate(timeout=600)
        path = Path(out_dir) / f"{arch}__{shape_name}__pod16x16.json"
        rec = json.loads(path.read_text()) if path.exists() else None
    finally:
        stop_dryrun_cli(cli)
    return {"rc": proc.returncode, "out": out[-2000:], "err": err[-3000:],
            "record": rec}


def stop_dryrun_cli(cli) -> None:
    """Stop phase 22d's subprocess if it still runs; drop its output."""
    import shutil
    proc, out_dir = cli
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    for stream in (proc.stdout, proc.stderr):
        stream.close()
    shutil.rmtree(out_dir, ignore_errors=True)


def dryrun_phase(torch, dev, training: dict, zero1: dict,
                 gemm_rows: list, cli: dict) -> dict:
    """Phase 22: the dry run's predictions held against this card.
    (a) Phase 18's step (Llama-3.2-1B at its depth, 8 x 256 tokens in 4
    microbatches, bf16 compute, ``compress=True``, ``no_remat=True``)
    reckoned on meta tensors over a world of one: the predicted peak
    within :data:`PEAK_TOL` of phase 18's ``max_memory_allocated``, the
    roofline's step bound at most its measured step; (b) the same for
    phase 21's ZeRO-1 step, with the peak's breakdown; (c) the ABFT
    implementation roofline: each Fig. 5 shape's bound for the
    unprotected instance and K1 at most phase 11's measured times; (d)
    ``python -m repro_torch.launch.dryrun`` on :data:`DRYRUN_CELL` as a
    subprocess on this machine's PyTorch (``cli``, from
    :func:`finish_dryrun_cli`: it ran beside phase 2's build), ending
    ``ok``, its per-device argument bytes and peak against the card's
    memory.  Meta tensors launch nothing: all six
    counters stay 0."""
    from repro_torch.benchmarks.roofline_table import abft_rows
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.roofline import count_params, model_flops
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.sharding import make_data_mesh

    t0 = time.perf_counter()
    card = smi_line()
    wrappers = zero_launches()
    total_memory = torch.cuda.get_device_properties(dev).total_memory
    arch, shape_name = DRYRUN_CELL
    record = {"card": card, "total_memory": total_memory}
    # ---------------- 22a. phase 18's step, reckoned ------------------
    cfg = depth_cut(18, LLAMA)
    model = build_model(cfg)
    ctx = Ctx(quant=False, compute_dtype=torch.bfloat16, no_remat=True)
    shape = ShapeConfig("phase18", "train", 256, 8)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in model.input_specs(shape).items()}
    state = steps.train_state_shapes(model, compress=True)
    step = steps.make_train_step(model, ctx, accum=cfg.train_accum,
                                 total_steps=6, compress=True)
    a = reckon_step(torch, lambda: step(state, batch), {
        "params": state["params"], "optimizer": state["opt"],
        "residuals": state["comm"], "step": state["step"],
        "batch": batch})
    measured = training["peak_allocated"]
    step_s = training["step_ms_median"] / 1e3
    mf = model_flops("train", count_params(state["params"])["active"],
                     tokens=8 * 256)
    a.update(measured_peak=measured, measured_step_s=step_s,
             model_flops=mf)
    pred = a["memory"]["peak_estimate_bytes"]
    bound = a["roofline"]["step_lower_bound_s"]
    log(f"22a on {card}: phase 18's step reckoned on meta: peak "
        f"{pred / 2**30:.2f} GiB against the measured "
        f"{measured / 2**30:.2f} GiB ({pred / measured - 1:+.1%}); "
        f"bound {bound * 1e3:.1f} ms ({a['roofline']['dominant']}) "
        f"over the measured step {step_s * 1e3:.1f} ms = "
        f"{bound / step_s:.3f}; model_flops over counted "
        f"{mf / a['cost']['flops']:.3f}; breakdown " + ", ".join(
            f"{k} {v / 2**30:.2f}" for k, v in
            a["memory"]["breakdown"].items()) + " GiB")
    if abs(pred / measured - 1) > PEAK_TOL:
        fail(f"phase 22a: predicted peak {pred} against the measured "
             f"{measured}")
    if bound > step_s:
        fail(f"phase 22a: the step bound {bound} s exceeds the "
             f"measured step {step_s} s")
    record["phase18"] = a

    # ---------------- 22b. phase 21's ZeRO-1 step, reckoned -----------
    cfg21 = depth_cut(21, LLAMA)
    model21 = build_model(cfg21)
    with fake_world(1):
        mesh = make_data_mesh(1, device_type="cpu")
        zs, _ = steps.zero1_state_shapes(model21, 1)
        # three flat vectors, each its own storage
        zs = dict(zs, opt={k: torch.empty_like(v, device="meta")
                           for k, v in zs["opt"].items()})
        zstep = steps.make_train_step_zero1(
            model21, ctx, mesh, accum=cfg21.train_accum, total_steps=2)
        b = reckon_step(torch, lambda: zstep(zs, batch), {
            "params": zs["params"], "optimizer": zs["opt"],
            "step": zs["step"], "batch": batch})
    measured = zero1["peak_allocated"]
    pred = b["memory"]["peak_estimate_bytes"]
    b.update(measured_peak=measured,
             measured_step_s=statistics.median(zero1["step_ms"]) / 1e3)
    log(f"22b: phase 21's ZeRO-1 step reckoned on meta: peak "
        f"{pred / 2**30:.2f} GiB against the measured "
        f"{measured / 2**30:.2f} GiB ({pred / measured - 1:+.1%}); at "
        f"the peak " + ", ".join(
            f"{k} {v / 2**30:.2f}" for k, v in
            b["memory"]["breakdown"].items()) + " GiB; bound "
        f"{b['roofline']['step_lower_bound_s'] * 1e3:.1f} ms over the "
        f"measured {b['measured_step_s'] * 1e3:.1f} ms")
    if abs(pred / measured - 1) > PEAK_TOL:
        fail(f"phase 22b: predicted peak {pred} against the measured "
             f"{measured}")
    if b["roofline"]["step_lower_bound_s"] > b["measured_step_s"]:
        fail("phase 22b: the step bound exceeds the measured step")
    record["zero1"] = b

    # ---------------- 22c. the ABFT roofline against phase 11 ---------
    bounds = {(r["shape"], r["instance"]): r["bound_ms"]
              for r in abft_rows()}
    side = []
    for r in gemm_rows:
        shp = tuple(r["shape"])
        got = {"unprotected": r["cold_ms"]["unprotected"]["median"],
               "K1": r["cold_ms"]["abft"]["median"]}
        for inst, ms in got.items():
            side.append((shp, inst, bounds[shp, inst], ms))
    log("22c: the ABFT roofline's bound against phase 11's measured "
        "cold medians (ms), per Fig. 5 shape: " + "; ".join(
            f"{'x'.join(map(str, s))} {i} {bd:.5f} <= {ms:.5f}"
            for s, i, bd, ms in side))
    over = [x for x in side if x[2] > x[3]]
    if len(side) != 56 or over:
        fail(f"phase 22c: {len(side)} rows, bounds over the measured "
             f"times: {over}")
    record["abft_roofline"] = [
        {"shape": s, "instance": i, "bound_ms": bd, "measured_ms": ms}
        for s, i, bd, ms in side]

    # ---------------- 22d. the dry-run CLI on this machine ------------
    rec = cli["record"]
    if cli["rc"] or rec is None:
        fail(f"phase 22d: the dry run exited {cli['rc']}: "
             f"{cli['out']} {cli['err']}")
    if rec["status"] != "ok":
        fail(f"phase 22d: {rec.get('error')}")
    mem = rec["memory_per_device"]
    log(f"22d: python -m repro_torch.launch.dryrun --arch {arch} "
        f"--shape {shape_name} on this machine's torch "
        f"{rec['torch']}: {rec['status']} in "
        f"{rec['compile_seconds']} s; per device argument bytes "
        f"{mem['argument_bytes'] / 2**30:.2f} GiB and peak "
        f"{mem['peak_estimate_bytes'] / 2**30:.2f} GiB against the "
        f"card's {total_memory / 2**30:.2f} GiB "
        f"(torch.cuda.get_device_properties(0).total_memory = "
        f"{total_memory}); roofline {rec['roofline']['dominant']}-bound"
        f", {rec['roofline']['step_lower_bound_s'] * 1e3:.2f} ms; flags "
        f"{rec['cost_per_device']['flags']}")
    record["cli"] = {k: rec[k] for k in (
        "status", "torch", "compile_seconds", "memory_per_device",
        "cost_per_device", "roofline", "params", "model_vs_hlo")}
    launches = read_launches(wrappers)
    if any(launches.values()):
        fail(f"phase 22: the dry run launched a kernel: {launches}")
    record["seconds"] = time.perf_counter() - t0
    log(f"phase 22 launches (all six must be 0): {launches}; "
        f"{record['seconds']:.1f}s")
    return {"launches": launches, "record": record}


# ------------------------------ 23. the model axis ---------------------------
#: phase 23a's meshes of gloo ranks sharing the card, phase 18's global
#: batch (in one microbatch: each microbatch gathers every FSDP block
#: through the host again), the train CLI's learning rate, and the share
#: of the update's elements allowed more than lr / 100 from the
#: one-device step's (phase 21b's rule): in bf16 compute the meshes sum
#: a row-parallel product's partials and the attention's cotangents in
#: another order, and Adam's second step turns that into update
#: differences (10.1% of them on the (1, 2) mesh on the H100); a step
#: that skips its update, or takes it with another rate, bias
#: correction or gradient, moves more than half of them
TP_MESHES = ((1, 2), (2, 2))
TP_BATCH, TP_SEQ, TP_STEPS, TP_LR = 8, 256, 2, 3e-4
TP_SHARE = 0.25
#: phase 23b: granite's data mesh, its global batch (each rank's 512
#: tokens one whole MoE group of granite's 512) and float32 compute
MOE_MESH, MOE_BATCH, MOE_SEQ = 2, 4, 256
#: phase 23c: the two configs that do not fit one card at full depth,
#: served cut in depth (DEPTH), and 23d: trained at the depth whose
#: reckoned peak stays under TRAIN_PEAK_BYTES (each at accum 1, 2 x 128
#: tokens: the state, not the activations, sets the peak)
BIG = ("mistral-large-123b", "llama4-scout-17b-a16e")
BIG_PROMPT, BIG_NEW = 32, 4
TRAIN_PEAK_BYTES = 70 * 2**30
BIG_TRAIN_BATCH, BIG_TRAIN_SEQ = 2, 128


@contextlib.contextmanager
def collective_clock():
    """Host seconds spent in ``torch.distributed``'s blocking
    collectives while the block runs (``clock["seconds"]``): the
    all-reduces, all-gathers and reduce-scatters the model-mesh step
    issues, each timed to the end of its wait.  With gloo ranks sharing
    a card each is a host copy and a host reduction the step waits for
    (``DTensor``'s functional collectives run as these on gloo,
    :class:`repro_torch.sharding.gspmd.GspmdMode`)."""
    import torch.distributed as dist
    clock = {"seconds": 0.0}
    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
    real = {n: getattr(dist, n) for n in names}

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                clock["seconds"] += time.perf_counter() - t0
        return run
    for n in names:
        setattr(dist, n, timed(real[n]))
    try:
        yield clock
    finally:
        for n in names:
            setattr(dist, n, real[n])


def _tp_rank(world):
    """One of phase 23a-b's ranks (gloo, sharing the card): 23a the
    model-mesh step over TP_MESHES, then on rank 0 the one-device step
    it is held against; 23b granite's data mesh on ranks 0-1.  Rank 0
    returns every rank's record and the comparisons."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import BatchShard, make_dataset
    from repro_torch.data.pipeline import shard_batch, to_device
    from repro_torch.device import deterministic
    from repro_torch.launch.parity import (adam_step_tolerance,
                                           loss_tolerance)
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.sharding import gspmd, make_data_mesh, make_model_mesh
    from repro_torch.sharding.rules import train_rules

    dev = world.device
    wrappers = zero_launches()
    cfg = tp_cfg()
    model = build_model(cfg)
    # the train CLI's context: JAX's rules, bf16 compute, layer remat
    ctx = Ctx(rules=train_rules(), quant=False, compute_dtype=torch.bfloat16)
    data = make_dataset(cfg, ShapeConfig("phase23", "train", TP_SEQ,
                                         TP_BATCH))
    kw = dict(accum=cfg.train_accum, peak_lr=TP_LR, warmup=0,
              total_steps=10)
    mine, finals = {"rank": world.rank, "meshes": {}}, {}
    for shape in TP_MESHES:
        n = shape[0] * shape[1]
        mesh = make_model_mesh(shape, ranks=range(n), device_type="cuda")
        if world.rank >= n:
            continue
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state = init_train_state(model, 0, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        blocks = sum(x.numel() * x.element_size() for x in (
            getattr(t, "_local_tensor", t) for t in tree_leaves(state)))
        step = make_train_step(model, ctx, mesh=mesh, **kw)
        rec = {"step_ms": [], "collective_ms": [], "losses": [],
               "grad_norms": [], "built_s": built_s, "blocks": blocks}
        for t in range(TP_STEPS):
            local = to_device(shard_batch(data.batch_at(t), BatchShard(
                mesh.batch_rank, mesh.n_batch, cfg.train_accum)), dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with deterministic(), collective_clock() as clock:
                state, m = step(state, local)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t1) * 1e3)
            rec["collective_ms"].append(clock["seconds"] * 1e3)
            rec["losses"].append(float(m["loss_final"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
        rec["peak"] = torch.cuda.max_memory_allocated() - held
        # the whole parameters, each leaf gathered in turn; rank 0 keeps
        # them on the card for the comparison
        whole = [gspmd.whole(p) for p in tree_leaves(state["params"])]
        if world.rank == 0:
            finals[shape] = whole
        del state, step, whole
        mine["meshes"][shape] = rec
    dist.barrier()

    out = {}
    if world.rank == 0:
        # 23a's reference: the one-device step from the same state and
        # batches, on the same card
        gc.collect()
        torch.cuda.empty_cache()
        start = [p.clone() for p in tree_leaves(model.init(0, device=dev))]
        state = init_train_state(model, 0, device=dev)
        step = make_train_step(model, ctx, **kw)
        one = {"step_ms": [], "losses": [], "grad_norms": []}
        for t in range(TP_STEPS):
            b = to_device(data.batch_at(t), dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with deterministic():
                state, m = step(state, b)
            torch.cuda.synchronize()
            one["step_ms"].append((time.perf_counter() - t1) * 1e3)
            one["losses"].append(float(m["loss_final"]))
            one["grad_norms"].append(float(m["grad_norm"]))
        want = tree_leaves(state["params"])
        held = {}
        for shape, got in finals.items():
            worst, off, total, moved = 0.0, 0, 0, 0
            for g, w, s in zip(got, want, start):
                d = (g.float() - s.float()) - (w.float() - s.float())
                worst = max(worst, float(d.abs().max()))
                off += int((d.abs() > TP_LR / 100).sum())
                moved += int(((w.float() - s.float()).abs()
                              > TP_LR / 100).sum())
                total += d.numel()
            held[shape] = {"max_update_diff": worst,
                           "share_off": off / total,
                           "reference_moved": moved / total}
        out = {"one_device": one, "held": held,
               "adam_step_tolerance": adam_step_tolerance(TP_LR, TP_STEPS),
               "loss_tolerance": loss_tolerance(cfg, "bfloat16")}
        del state, step, start, want, finals
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    # 23b: granite on a data mesh of 2, float32, against the one-device
    # loss on the global batch (§C17)
    gcfg = dataclasses.replace(depth_cut(23, GRANITE), train_accum=1)
    gmodel = build_model(gcfg)
    gctx = Ctx(rules=train_rules(), quant=False,
               compute_dtype=torch.float32)
    gdata = make_dataset(gcfg, ShapeConfig("phase23b", "train", MOE_SEQ,
                                           MOE_BATCH))
    dmesh = make_data_mesh(MOE_MESH, device_type="cuda")
    moe = None
    if dmesh.member:
        gstate = init_train_state(gmodel, 0, device=dev)
        gstep = make_train_step(gmodel, gctx, mesh=dmesh, accum=1,
                                peak_lr=TP_LR, warmup=0, total_steps=10)
        batch = gdata.batch_at(0)
        local = to_device(shard_batch(batch, BatchShard(dmesh.rank,
                                                        dmesh.size)), dev)
        with deterministic():
            _, m = gstep(gstate, local)
        moe = {"mesh_loss": float(m["loss_final"])}
        if world.rank == 0:
            whole = to_device(batch, dev)
            with torch.no_grad(), deterministic():
                moe["global_loss"] = float(gmodel.loss(
                    gstate["params"], whole, gctx)[0])
                halves = [float(gmodel.loss(gstate["params"], {
                    k: v[h * MOE_BATCH // 2:(h + 1) * MOE_BATCH // 2]
                    for k, v in whole.items()}, gctx)[0]) for h in (0, 1)]
            moe["mean_of_halves"] = sum(halves) / 2
            moe["loss_tolerance"] = loss_tolerance(gcfg, "float32",
                                                   card=True)
            moe["layers"] = gcfg.n_layers
        del gstate, gstep
    mine["launches"] = read_launches(wrappers)
    every = [None] * world.size
    dist.all_gather_object(every, mine)
    dist.barrier()
    if world.rank != 0:
        return None
    return {"ranks": every, "moe": moe, "cfg_layers": cfg.n_layers, **out}


def tp_cfg():
    """Phase 23a's Llama-3.2-1B: full width, its depth in DEPTH, the
    global batch in one microbatch."""
    import dataclasses
    return dataclasses.replace(depth_cut(23, LLAMA), train_accum=1)


def tp_predictions(torch) -> dict:
    """Phase 23a's step reckoned by the dry run's tracker on a fake world
    of each mesh (``launch/costs``): rank 0's peak, which is every rank's
    (the blocks are even), and its collectives' link bytes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.base import build_model
    from repro_torch.sharding.rules import train_rules

    cfg = tp_cfg()
    model = build_model(cfg)
    shape = ShapeConfig("phase23", "train", TP_SEQ, TP_BATCH)
    out = {}
    for mshape in TP_MESHES:
        with dryrun.fake_world(mshape[0] * mshape[1]):
            mesh = dryrun.make_mesh(mshape, ("data", "model"))
            counter, _ = dryrun.run_step(model, shape, train_rules(), mesh)
        mem = counter.memory()
        out[mshape] = {"peak": mem["peak_estimate_bytes"],
                       "arguments": mem["argument_bytes"],
                       "link_bytes": counter.result()[
                           "collective_link_bytes"]}
    return out


def big_serve(torch, dev, arch: str) -> dict:
    """Phase 23c for one config: full width at its depth in DEPTH (int8,
    seed 0), the bytes built against the reckoning, 2 chat requests of
    BIG_NEW tokens on a ``*:policy=log`` tenant with no error; every K1
    shape (each expert's too) and K3 width the serve launched, and K2 on
    the token table at the prompt's tokens, held bit for bit against
    the plain versions."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import LANE
    from repro_torch.core.inject import leaf_paths
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.models.base import build_model
    from repro_torch.protect import default_plan
    from repro_torch.serving import Request, ServingEngine, TenantSpec

    t0 = time.perf_counter()
    cfg = depth_cut(23, arch)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shapes = build_model(cfg, max_pos=BIG_PROMPT + BIG_NEW + 16).init(
        0, quant=True, device="meta")
    reckoned = sum(t.numel() * t.element_size()
                   for _, t in leaf_paths(shapes))
    engine = ServingEngine(cfg, [TenantSpec("default", default_plan())],
                           n_slots=2, max_prompt=BIG_PROMPT,
                           max_new_tokens=BIG_NEW, seed=0, device=dev)
    torch.cuda.synchronize()
    built = sum(t.numel() * t.element_size()
                for _, t in leaf_paths(engine.params))
    build_s = time.perf_counter() - t0
    if built != reckoned:
        fail(f"23c {arch}: built {built} B against {reckoned} reckoned")
    # the shapes the serve hands K1 and K3, recorded on the way
    seen_k1, seen_k3 = {}, {}
    real_mm, real_q = kops.abft_qgemm, kops.quantize_rows

    def tap_mm(a_q, b_packed, **kw):
        bp = b_packed[0] if b_packed.dim() == 3 else b_packed
        m = a_q.shape[-2]
        seen_k1.setdefault((m, bp.shape[0], bp.shape[1] - LANE), bp)
        return real_mm(a_q, b_packed, **kw)

    def tap_q(x, **kw):
        seen_k3.setdefault(tuple(x.reshape(-1, x.shape[-1]).shape), None)
        return real_q(x, **kw)

    reqs = [Request(rid=i, tenant="default", arrival_s=0.0,
                    prompt_len=BIG_PROMPT, max_new_tokens=BIG_NEW,
                    seed=300 + i) for i in range(2)]
    kops.abft_qgemm, kops.quantize_rows = tap_mm, tap_q
    try:
        wrappers = zero_launches()
        tel = engine.run(reqs)
        launches = read_launches(wrappers)
    finally:
        kops.abft_qgemm, kops.quantize_rows = real_mm, real_q
    s = tel.summary()
    counters, per = s["faults"]["counters"], s["per_tenant"]["default"]
    toks = [t for r in tel.requests for t in (r.tokens or [])]
    if per["completed"] != 2 or per["aborted"] or \
            len(toks) != 2 * BIG_NEW or \
            not all(0 <= t < cfg.vocab for t in toks) or \
            counters["qgemm_errors"] or counters["kv_cache_errors"]:
        fail(f"23c {arch}: {per}, tokens {toks}, counters {counters}")
    if min(launches[k] for k in ("abft_qgemm", "quantize_rows",
                                 "abft_embeddingbag")) <= 0:
        fail(f"23c {arch}: a kernel of the path never launched: {launches}")
    step_ms = {k: float(np.median([ev.duration_s * 1e3 for ev in tel.steps
                                   if ev.kind == k]))
               for k in ("prefill", "decode")}
    # K1 (C, err_rows, column check) and K3 (q, alpha, beta) at each
    gen = torch.Generator(device=dev).manual_seed(23)
    for (m, k, n), bp in seen_k1.items():
        a = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        for col in (False, True):
            for g, w, what in zip(abft_qgemm_cuda(a, bp, with_colcheck=col),
                                  ref.abft_qgemm_ref(a, bp,
                                                     with_colcheck=col),
                                  ("C", "err_rows", "col_check")):
                if not torch.equal(g, w):
                    fail(f"23c {arch}: K1 {what} differs at m={m} (k={k}, "
                         f"n={n}) col_check={col}")
    for (m, k) in seen_k3:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        for g, w, what in zip(quantize_rows_cuda(x),
                              ref.quantize_rows_ref(x),
                              ("q", "alpha", "beta")):
            if not torch.equal(g, w):
                fail(f"23c {arch}: K3 {what} differs at {m}x{k}")
    emb = engine.params["embed"]
    enc4 = (emb["table"][None], emb["alphas"][None], emb["betas"][None],
            emb["rowsums"][None])
    prompt = torch.from_numpy(engine._chat_tokens(
        reqs[0], BIG_PROMPT).astype(np.int32)).to(dev)
    k2 = eb_checks(torch, enc4, prompt.reshape(1, -1, 1),
                   f"{arch} {BIG_PROMPT} tokens")
    rec = {"layers": cfg.n_layers, "of": get_arch(arch).n_layers,
           "bytes": built, "build_s": build_s,
           "k1_shapes": sorted(seen_k1), "k3_shapes": sorted(seen_k3),
           "table": list(emb["table"].shape), "k2": k2,
           "launches": launches, "counters": counters,
           "step_ms_median": step_ms,
           "seconds": time.perf_counter() - t0}
    del engine, emb, enc4, tel, seen_k1
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def big_train(torch, dev, arch: str) -> dict:
    """Phase 23d for one config: the one-device train step (the CLI's
    context, float32 AdamW state) reckoned on meta tensors by the
    tracker at 1 and 2 layers, the deepest cut whose reckoned peak stays
    under TRAIN_PEAK_BYTES picked (and reckoned again), and 2 steps
    trained there at full width: finite losses, the measured peak within
    PEAK_TOL of the reckoning.  Where no depth fits, the reckoned bytes
    at 1 layer are the record and nothing trains."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_dataset
    from repro_torch.data.pipeline import to_device
    from repro_torch.device import deterministic
    from repro_torch.launch import steps
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.sharding.rules import train_rules

    t0 = time.perf_counter()
    full = get_arch(arch)
    ctx = Ctx(rules=train_rules(), quant=False, compute_dtype=torch.bfloat16)
    shape = ShapeConfig("phase23d", "train", BIG_TRAIN_SEQ, BIG_TRAIN_BATCH)

    def cut(n):
        return dataclasses.replace(full, n_layers=n, train_accum=1)

    def reckon(n):
        model = build_model(cut(n))
        state = steps.train_state_shapes(model)
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                 for k, v in model.input_specs(shape).items()}
        step = steps.make_train_step(model, ctx, total_steps=10)
        return reckon_step(torch, lambda: step(state, batch), {
            "params": state["params"], "optimizer": state["opt"],
            "step": state["step"], "batch": batch})["memory"]

    one, two = reckon(1), reckon(2)
    per_layer = two["peak_estimate_bytes"] - one["peak_estimate_bytes"]
    base = one["peak_estimate_bytes"] - per_layer
    held = torch.cuda.memory_allocated()
    room = TRAIN_PEAK_BYTES - held
    depth = int((room - base) // per_layer) if per_layer > 0 else 0
    depth = max(0, min(depth, full.n_layers))
    rec = {"reckoned_peak_1": one["peak_estimate_bytes"],
           "reckoned_peak_2": two["peak_estimate_bytes"],
           "state_bytes_1": steps.state_bytes(steps.train_state_shapes(
               build_model(cut(1)))),
           "held": held, "layers": depth, "of": full.n_layers}
    if depth < 1:
        rec["seconds"] = time.perf_counter() - t0
        return rec
    mem = one if depth == 1 else two if depth == 2 else reckon(depth)
    rec["reckoned_peak"] = mem["peak_estimate_bytes"]
    if held + rec["reckoned_peak"] > TRAIN_PEAK_BYTES:
        fail(f"23d {arch}: the picked depth {depth} reckons "
             f"{rec['reckoned_peak']} B over {TRAIN_PEAK_BYTES}")
    model = build_model(cut(depth))
    data = make_dataset(cut(depth), shape)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = zero_launches()
    state = steps.init_train_state(model, 0, device=dev)
    step = steps.make_train_step(model, ctx, total_steps=10)
    losses, ms = [], []
    for t in range(2):
        b = to_device(data.batch_at(t), dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with deterministic():
            state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss_final"]))
    peak = torch.cuda.max_memory_allocated() - held
    rec["launches"] = read_launches(wrappers)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(losses=losses, step_ms=ms, peak=peak,
               seconds=time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        fail(f"23d {arch}: losses {losses}")
    if abs(peak / rec["reckoned_peak"] - 1) > PEAK_TOL:
        fail(f"23d {arch}: peak {peak} B against the reckoned "
             f"{rec['reckoned_peak']}")
    return rec


def start_tp_reckoning(torch):
    """Phase 23a's predictions (:func:`tp_predictions`), reckoned in a
    thread of this process beside phase 2's build (which times no
    launches); :func:`finish_tp_reckoning` joins it before phase 3, so
    no timed phase shares the host or the interpreter with it."""
    import threading
    job = {"pred": None, "error": None}

    def run():
        try:
            job["pred"] = tp_predictions(torch)
        except BaseException as e:          # noqa: BLE001 - raised on join
            job["error"] = e
    job["thread"] = threading.Thread(target=run)
    job["thread"].start()
    return job


def finish_tp_reckoning(job) -> dict:
    job["thread"].join()
    if job["error"] is not None:
        raise job["error"]
    return job["pred"]


def model_axis_phase(torch, dev, pred: dict) -> dict:
    """Phase 23: the model axis.  (a) Full-width Llama-3.2-1B at its
    depth in DEPTH trained by the model-mesh step (the train CLI's
    context: ``train_rules``, bf16, layer remat) on a (1, 2) and a (2, 2)
    mesh of gloo ranks sharing the card, 2 steps each on phase 18's
    global batch (8 x 256, in one microbatch), against the one-device
    step from the same state: each loss within ``loss_tolerance``, the
    update within ``adam_step_tolerance`` with at most TP_SHARE of its
    elements more than lr / 100 apart; per rank the step ms, the
    collectives' share of it and the peak, beside the dry run's
    tracker's prediction for the rank (``pred``, from
    :func:`start_tp_reckoning`); (b) granite-moe on a data mesh of
    2, float32: the mesh step's loss equal to the one-device loss on the
    global batch within ``loss_tolerance`` (§C17), the mean of the
    halves' losses printed beside it; (c) mistral-large-123b and
    llama4-scout-17b-a16e served at full width, cut in depth; (d) both
    trained at full width at the depth the tracker reckons under 70 GiB
    (or, where none fits, the reckoned bytes).  The training paths launch
    no kernel of the port (all six counters 0, in every rank)."""
    from repro_torch.sharding import launch

    t0 = time.perf_counter()
    card = smi_line()
    record, launches_by = {"card": card}, {}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    got = launch(_tp_rank, 4, device=dev)
    ranks_ = got["ranks"]
    one = got["one_device"]
    for shape in TP_MESHES:
        recs = [r["meshes"][shape] for r in ranks_ if shape in r["meshes"]]
        losses = recs[0]["losses"]
        held = got["held"][shape]
        bad = [t for t, (a, b) in enumerate(zip(losses, one["losses"]))
               if abs(a - b) > got["loss_tolerance"] * abs(b)]
        if bad or not all(math.isfinite(x) for x in losses) or \
                held["max_update_diff"] > got["adam_step_tolerance"] or \
                held["share_off"] > TP_SHARE or \
                held["reference_moved"] < 0.5:
            fail(f"phase 23a {shape}: losses {losses} against the one-device "
                 f"{one['losses']} (steps {bad} off), update {held}")
        p = pred[shape]
        log(f"23a on {card}: Llama-3.2-1B at {got['cfg_layers']} of 16 "
            f"layers, full width, {TP_BATCH} x {TP_SEQ} tokens in one "
            f"microbatch, TP {shape} over {len(recs)} gloo ranks sharing "
            f"the card: losses {losses} (one device {one['losses']}); the "
            f"update within {held['max_update_diff']:.3g} of the one-device "
            f"step's (adam_step_tolerance {got['adam_step_tolerance']:.3g}), "
            f"{held['share_off']:.4%} of it more than lr/100 apart "
            f"(allowed {TP_SHARE:.0%}); per rank: step ms "
            + "; ".join(f"{[round(x, 1) for x in r['step_ms']]}, "
                        f"collectives {[round(c / s, 3) for c, s in zip(r['collective_ms'], r['step_ms'])]} "
                        f"of it, peak {r['peak'] / 2**30:.2f} GiB (blocks "
                        f"{r['blocks'] / 2**30:.2f})" for r in recs)
            + f"; the tracker's prediction for each rank: peak "
            f"{p['peak'] / 2**30:.2f} GiB, arguments "
            f"{p['arguments'] / 2**30:.2f} GiB")
        record[f"tp {shape}"] = {"ranks": recs, "held": held,
                                 "prediction": p}
    record["one_device"] = one
    launches_by["tp training"] = {
        k: sum(r["launches"][k] for r in ranks_)
        for k in ranks_[0]["launches"]}
    moe = got["moe"]
    off = abs(moe["mesh_loss"] - moe["global_loss"]) / abs(
        moe["global_loss"])
    old = abs(moe["mean_of_halves"] - moe["global_loss"]) / abs(
        moe["global_loss"])
    if off > moe["loss_tolerance"]:
        fail(f"phase 23b: granite's data-mesh loss {moe} ({off:.3g} off)")
    log(f"23b: granite-moe at {moe['layers']} of 32 layers, full width, "
        f"float32, {MOE_BATCH} x {MOE_SEQ} tokens over a data mesh of "
        f"{MOE_MESH} gloo ranks: loss {moe['mesh_loss']} against the "
        f"one-device loss on the global batch {moe['global_loss']} "
        f"({off:.3g} of it; allowed {moe['loss_tolerance']:.0e}); the mean "
        f"of the halves' own losses {moe['mean_of_halves']} ({old:.3g} "
        f"off, what the step took before §C17)")
    record["moe_data_mesh"] = {**moe, "off": off, "halves_off": old}
    # ---------------- 23c. the two large configs served ----------------
    for arch in BIG:
        rec = big_serve(torch, dev, arch)
        launches_by[f"serve {arch}"] = rec["launches"]
        log(f"23c on {card}: {arch} at {rec['layers']} of {rec['of']} "
            f"layers, full width, {rec['bytes'] / 1e9:.3f} GB of int8 "
            f"(built in {rec['build_s']:.1f}s): 2 requests of {BIG_NEW} "
            f"tokens, step medians ms {rec['step_ms_median']}, launches "
            f"{rec['launches']}, counters "
            f"{ {k: v for k, v in rec['counters'].items() if v} }; K1 "
            f"bit-exact (C, err_rows, column check) at (m, k, n) "
            f"{rec['k1_shapes']}; K3 at {rec['k3_shapes']}; K2 on the "
            f"{tuple(rec['table'])} table at the prompt's tokens; "
            f"{rec['seconds']:.1f}s")
        record[f"serve {arch}"] = {k: v for k, v in rec.items()
                                   if k != "launches"}
    # ---------------- 23d. the two large configs trained ---------------
    for arch in BIG:
        rec = big_train(torch, dev, arch)
        if rec["layers"] < 1:
            log(f"23d on {card}: {arch} does not train on one card at full "
                f"width: at 1 layer the tracker reckons a peak of "
                f"{rec['reckoned_peak_1'] / 2**30:.2f} GiB (state "
                f"{rec['state_bytes_1'] / 2**30:.2f} GiB), over "
                f"{TRAIN_PEAK_BYTES / 2**30:.0f} GiB with "
                f"{rec['held'] / 2**30:.2f} GiB held")
        else:
            launches_by[f"train {arch}"] = rec.pop("launches")
            log(f"23d on {card}: {arch} trained at {rec['layers']} of "
                f"{rec['of']} layers, full width, {BIG_TRAIN_BATCH} x "
                f"{BIG_TRAIN_SEQ} tokens: losses {rec['losses']}, step ms "
                f"{[round(x, 1) for x in rec['step_ms']]}, peak "
                f"{rec['peak'] / 2**30:.2f} GiB against the reckoned "
                f"{rec['reckoned_peak'] / 2**30:.2f} GiB (1 layer "
                f"{rec['reckoned_peak_1'] / 2**30:.2f}, 2 layers "
                f"{rec['reckoned_peak_2'] / 2**30:.2f})")
        record[f"train {arch}"] = rec
    for path, counts in launches_by.items():
        if (path.startswith("train") or path == "tp training") and \
                any(counts.values()):
            fail(f"phase 23 {path}: a kernel of the port launched: {counts}")
    record["seconds"] = time.perf_counter() - t0
    log(f"phase 23 launches: {launches_by}; {record['seconds']:.1f}s")
    return {"launches": launches_by, "record": record}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        log("no CUDA device is available; nothing to drive")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.dlrm import CONFIG, EXTRAS
    from repro_torch.core import LANE, pack_encoded_b
    from repro_torch.kernels import _build, ops as kops, ref
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda, launch_plan
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    from repro_torch.protect import default_plan
    from repro_torch.serving import ServingEngine, TenantSpec, dlrm_stream

    t_start = time.perf_counter()
    phase_s = {}
    mark = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        log(f"phase {name}: {phase_s[name]:.1f}s")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    details = {"card": smi_line()}
    print(details["card"], flush=True)

    # ------------------------------ 2. build --------------------------------
    # phase 22d's dry-run CLI and phase 23a's reckoning (host work, no
    # card) run beside the build, which times no launches
    cli = start_dryrun_cli()
    tp_job = start_tp_reckoning(torch)
    t0 = time.perf_counter()
    try:
        built = _build.build()
    except BaseException:
        stop_dryrun_cli(cli)
        finish_tp_reckoning(tp_job)
        raise
    details["build_s"] = time.perf_counter() - t0
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln]
        log(f"built {name} in {info['seconds']:.1f}s; " + "; ".join(regs))
    log(f"build wall {details['build_s']:.1f}s")
    dry_cli = finish_dryrun_cli(cli)
    details["dryrun_cli_wait_s"] = time.perf_counter() - t0 - \
        details["build_s"]
    tp_pred = finish_tp_reckoning(tp_job)
    details["tp_reckoning_wait_s"] = time.perf_counter() - t0 - \
        details["build_s"]
    log(f"phase 22d's dry-run CLI ended "
        f"{details['dryrun_cli_wait_s']:.1f}s and phase 23a's reckoning "
        f"{details['tp_reckoning_wait_s']:.1f}s after the build")
    phase_done("1-2 card and build")

    # ---------------------- 3. kernels vs plain versions --------------------
    ex = EXTRAS
    t0 = time.perf_counter()
    engine = ServingEngine(CONFIG, [TenantSpec("default", default_plan())],
                           seed=0, device=dev)
    torch.cuda.synchronize()
    details["init_s"] = time.perf_counter() - t0
    params = engine.params
    tables = params["tables"]
    log(f"full-width DLRM on the card in {details['init_s']:.1f}s: tables "
        f"{tuple(tables['table'].shape)}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    layers = params["bottom"] + params["top"]
    shapes = [(p["w_packed"].shape[0], p["w_packed"].shape[1] - LANE)
              for p in layers]
    if shapes != [(13, 512), (512, 256), (256, 128), (479, 1024),
                  (1024, 1024), (1024, 512), (512, 256), (256, 1)]:
        fail(f"unexpected DLRM layer shapes {shapes}")
    gen = torch.Generator(device=dev).manual_seed(1)
    m = 10                                         # dlrm_stream lookup batch
    errs = {"abft_qgemm": 0.0, "quantize_rows": 0.0, "abft_embeddingbag": 0.0}

    def check_equal(name, got, want, what, rerun=None):
        if got.shape != want.shape or not torch.equal(got, want):
            if got.shape != want.shape:
                fail(f"{name}: {what} differs from the plain version "
                     f"(shape)")
            where = (got != want).nonzero()
            at = [(tuple(i), int(got[tuple(i)]), int(want[tuple(i)]))
                  for i in where[:4].tolist()]
            # whether the same call gives the same result again
            again = "" if rerun is None else \
                f"; the same call again equal: {torch.equal(rerun(), want)}"
            fail(f"{name}: {what} differs from the plain version "
                 f"({where.shape[0]}; (index, got, want) {at}{again})")

    def rand_i8(rows, cols, dtype=torch.int8):
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        return torch.randint(lo, hi, (rows, cols), generator=gen,
                             device=dev).to(dtype)

    # K1: every layer at m = 10 in int8 (the path's type) and uint8, each
    # with and without the column check (two variants of the kernel); an
    # aligned RWKV shape split across a cluster; A off 16-byte alignment;
    # and the larger m = 2048 shape on top.1
    k1_main = [(rand_i8(m, k), p["w_packed"]) for (k, _), p in
               zip(shapes, layers)]
    k1_cases = k1_main + [(rand_i8(m, k, torch.uint8), p["w_packed"])
                          for (k, _), p in zip(shapes, layers)]
    bp_rwkv = pack_encoded_b(torch.randint(-127, 128, (2048, 2048),
                                           generator=gen, device=dev)
                             .to(torch.int8))
    k1_cases.append((rand_i8(64, 2048), bp_rwkv))
    a_off = torch.empty(64 * 2048 + 16, dtype=torch.int8, device=dev)
    a_off = a_off[1:1 + 64 * 2048].view(64, 2048)
    a_off.copy_(rand_i8(64, 2048))
    k1_cases.append((a_off, bp_rwkv))
    a_big, bp_big = rand_i8(2048, 1024), layers[4]["w_packed"]
    k1_cases.append((a_big, bp_big))
    paths = set()
    for a, bp in k1_cases:
        plan = launch_plan(a.shape[0], a.shape[1], bp.shape[1] - LANE,
                           a_addr=a.data_ptr(), b_addr=bp.data_ptr())
        paths.add((plan.bm, plan.splits, plan.aligned))
        for col in (False, True):
            got = abft_qgemm_cuda(a, bp, with_colcheck=col)
            want = ref.abft_qgemm_ref(a, bp, with_colcheck=col)
            for j, (g, w, what) in enumerate(
                    zip(got, want, ("C", "err_rows", "col_check"))):
                check_equal("abft_qgemm", g, w,
                            f"{what} at {tuple(a.shape)} {a.dtype} "
                            f"(k, n) = {(bp.shape[0], bp.shape[1] - LANE)} "
                            f"col_check={col} (err_rows {got[1].tolist()})",
                            rerun=lambda: abft_qgemm_cuda(
                                a, bp, with_colcheck=col)[j])
            if int(got[1].sum()) != 0:
                fail("abft_qgemm flagged clean operands")
    bad_bp = layers[3]["w_packed"].clone()
    bad_bp[100, 200] ^= 0x08                       # payload bit, stale lane
    a = k1_main[3][0]
    got, want = abft_qgemm_cuda(a, bad_bp), ref.abft_qgemm_ref(a, bad_bp)
    check_equal("abft_qgemm", got[1], want[1], "err_rows under a flip")
    if int(got[1].sum()) == 0:
        fail("abft_qgemm missed a flipped weight bit")
    log(f"K1 bit-exact in C, err_rows and the column check on "
        f"{len(k1_cases)} cases, each with and without the check; plans "
        f"(bm, splits, aligned) {sorted(paths)}; flip flags "
        f"{int(got[1].sum())}/{m} rows as the plain version does")

    # K3: the input width of every layer at m = 10, in bf16 as the path
    # hands it over and in its f32 cast, and one larger f32 shape
    k3_inputs = [torch.randn((m, k), generator=gen, device=dev)
                 .to(torch.bfloat16) for k, _ in shapes]
    k3_inputs.append(torch.randn((2048, 1024), generator=gen, device=dev))
    k3_cases = k3_inputs + [x.float() for x in k3_inputs[:len(shapes)]]
    for x in k3_cases:
        for g, w, what in zip(quantize_rows_cuda(x), ref.quantize_rows_ref(x),
                              ("q", "alpha", "beta")):
            check_equal("quantize_rows", g, w,
                        f"{what} at {tuple(x.shape)} {x.dtype}")
    log(f"K3 bit-exact in q, alpha, beta on {len(k3_cases)} cases (every "
        f"layer width in bf16 and f32)")
    hazards = pdl_hazards(torch, dev, gen, [
        (f"layer {i} (k, n) = {shapes[i]} m = {m}", m,
         layers[i]["w_packed"]) for i in (0, 3, 7)])
    log("K1 under PDL bit-exact after K3, after an in-place flip of B', "
        "after K1 on the same scratch and after the correct repair at "
        + "; ".join(hazards))

    # K2: one request's bags over all 26 full tables, then the paper's
    # Table I pooling (2048 bags x 100) over all of them
    def stream(n, seed):
        return dlrm_stream(n, tenants={"default": 1.0}, seed=seed,
                           lookup_batch=m, table_rows=ex.table_rows,
                           n_tables=ex.n_tables)

    req_bags = torch.from_numpy(stream(1, 5)[0].payload["bags"]).to(dev)
    big_bags = torch.randint(0, ex.table_rows, (ex.n_tables, 2048, 100),
                             generator=gen, device=dev, dtype=torch.int32)
    enc = (tables["table"], tables["alphas"], tables["betas"])
    enc4 = enc + (tables["rowsums"],)
    past = req_bags.clone()                        # past the table: last row
    past[0, 0, 0], past[-1, -1, 0] = ex.table_rows + 7, 2**31 - 1
    k2_checks = {}
    for label, bags in (("request", req_bags), ("Table I", big_bags)):
        k2_checks[label] = eb_checks(torch, enc4, bags,
                                     f"{label} {tuple(bags.shape)}")
    want = ref.abft_eb_slot_order_ref(*enc, past)
    if not torch.equal(abft_eb_cuda(*enc4[:3], past, enc4[3])[0], want):
        fail("abft_embeddingbag: an index past the table did not read its "
             "last row")
    k2_flips = eb_flip_sweep(torch, enc4, req_bags)
    eb_pdl_hazards(torch, enc4, req_bags)
    errs["abft_embeddingbag"] = k2_checks["request"]["rsum_max_abs_err"]
    details["k2_checks"] = {**k2_checks, "flip_sweep_flagged": k2_flips}
    log(f"K2 at {tuple(req_bags.shape)} and {tuple(big_bags.shape)}: R "
        f"bit-exact with the slot-order sum (and past the table), rsum "
        f"within 1e-5 x d x max|R| (max |d| "
        f"{errs['abft_embeddingbag']:.3g}), flags and counts equal to the "
        f"plain branch at rel_bound 1e-3 and 1e-5 and to its formula on its "
        f"own rsum at 1e-3, 1e-5 and 1e-7 (at 1e-7 "
        + ", ".join(f"{k}: {v['flagged_at_1e-7']} flagged, plain branch "
                    f"differs on {v['plain_branch_differs_at_1e-7']}"
                    for k, v in k2_checks.items())
        + f"); bits 0-7 of a table byte flipped: bags flagged {k2_flips} "
          f"as the plain branch flags them; under PDL right after a table "
          f"flip, an alpha change and another K2")

    # ----------------------------- 4. serve ---------------------------------
    wrappers = zero_launches()
    tel = engine.run(stream(8, 0))
    launches = read_launches(wrappers)
    s = tel.summary()
    per = s["per_tenant"]["default"]
    counters = s["faults"]["counters"]
    log(f"served {per['requests']} requests: {per['completed']} completed; "
        f"launches {launches}; counters "
        f"{ {k: v for k, v in counters.items() if v} }")
    if per["completed"] != 8 or per["aborted"]:
        fail(f"not every request completed: {per}")
    nonzero = {k: v for k, v in counters.items()
               if v and not k.endswith("_checks")}
    if nonzero:
        fail(f"fault counters on a clean run: {nonzero}")
    if counters["qgemm_checks"] != 8 * 8 or \
            counters["embedding_bag_checks"] != 8 * ex.n_tables:
        fail(f"unexpected check counts {counters}")
    if min(launches[k] for k in ("abft_qgemm", "abft_embeddingbag",
                                 "quantize_rows")) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    serve_ms = sorted(ev.duration_s * 1e3 for ev in tel.steps)
    details["serve"] = {"requests": per["requests"],
                        "request_ms": serve_ms,
                        "request_ms_median": float(np.median(serve_ms)),
                        "launches": launches, "counters": counters}

    def one_request(seed):
        return engine.run(stream(1, seed), warmup=False).summary()[
            "faults"]["counters"]

    # faults through the engine's FaultInjection, each flipped in place
    # before its step and checked on the leaf afterwards: a transient flip
    # of top.0's packed weight at the second of three requests; a high
    # bit of a table row the request gathers; a persistent top.0 flip,
    # flagged at every later request until reset_state restores it
    from repro_torch.serving import FaultInjection

    def slow(n, seed):            # one request per engine step
        return dlrm_stream(n, tenants={"default": 1.0}, rate_rps=0.01,
                           seed=seed, lookup_batch=m,
                           table_rows=ex.table_rows, n_tables=ex.n_tables)

    def inject_run(reqs, inj, leaf):
        engine.reset_state()
        before = leaf_fingerprint(torch, leaf)
        tel = engine.run(reqs, inject=[inj], warmup=False)
        if inj.persistent:
            engine.reset_state()
        return tel, before, leaf_fingerprint(torch, leaf)

    top0 = params["top"][0]["w_packed"]
    tel, fp0, fp1 = inject_run(slow(3, 11), FaultInjection(
        step=1, victim="top.0", seed=0), top0)
    flips = {"weight": check_injection(tel, 1, [1], fp0, fp1,
                                       "DLRM top.0 flip")}
    req = stream(1, 12)[0]
    bags = req.payload["bags"]

    def reads(idx):
        t, row = divmod(idx // ex.emb_dim, ex.table_rows)
        return row in set(bags[t].reshape(-1).tolist())

    t_seed = injection_seed(torch, tables["table"], "tables.table", reads)
    tel, fp0, fp1 = inject_run([req], FaultInjection(
        step=0, victim="tables", seed=t_seed), tables["table"])
    flips["table"] = check_injection(tel, 0, [0], fp0, fp1,
                                     "DLRM table flip")
    flips["table"]["seed"] = t_seed
    tel, fp0, fp1 = inject_run(slow(4, 13), FaultInjection(
        step=1, victim="top.0", persistent=True, seed=1), top0)
    flips["persistent"] = check_injection(tel, 1, [1, 2, 3], fp0, fp1,
                                          "DLRM persistent top.0 flip")
    engine.reset_state()
    c_clean = one_request(12)
    if c_clean["qgemm_errors"] or c_clean["embedding_bag_errors"]:
        fail("errors after restoring the injected flips")
    flips["restored"] = c_clean
    log(f"FaultInjection on DLRM: {flips['weight']['victim']} flagged at "
        f"step {flips['weight']['detect_step']} only; "
        f"{flips['table']['victim']} (seed {t_seed}, a row the request "
        f"reads) flagged at step {flips['table']['detect_step']}; the "
        f"persistent flip flagged at steps "
        f"{flips['persistent']['flagged_steps']}; every leaf bit-identical "
        f"afterwards (fingerprints); a clean request after: no errors")
    details["flips"] = flips
    details["outputs"] = check_outputs(torch, dev, params, ex, stream(1, 13))

    # ------------------------------ 5. times --------------------------------
    from repro_torch.benchmarks.common import (F32_OPS_PER_S,
                                               INT8_OPS_PER_S, Timer,
                                               bound_ms)
    timer = Timer()
    k3_main = k3_inputs[:8]
    req_bag_sets = [torch.from_numpy(r.payload["bags"]).to(dev)
                    for r in stream(20, 21)]

    def seq(fn, cases):
        return lambda: [fn(*c) for c in cases]

    # cycling index sets: each K2 launch gathers fresh rows, cold in L2
    def eb_fn(sets):
        it = itertools.cycle(sets)
        return lambda: abft_eb_cuda(*enc, next(it), tables["rowsums"])

    def eb_plain_fn(sets):
        it = itertools.cycle(sets)
        return lambda: kops.abft_embedding_bag(*enc, next(it),
                                               tables["rowsums"],
                                               use_kernel=False)

    k1_bytes = sum(m * k + k * (n + 1) + 4 * m * n + 4 * m
                   for k, n in shapes)
    k1_ops = sum(2 * m * k * (n + 1) for k, n in shapes)
    k3_bytes = sum(3 * m * k + 8 * m for k, _ in shapes)   # bf16 in
    k3_ops = sum(6 * m * k for k, _ in shapes)
    (k2_bound, k2_by), (k2_sectors, _) = eb_bounds(req_bags, ex.emb_dim)
    # one protected EmbeddingBag call on the card: the card branch of ops
    # (K2 alone) and the protect layer around it (K2 and the count's sum)
    from repro_torch.protect.plan import ResolvedRule
    from repro_torch.protect.runtime import protected_call
    eb_ops = {
        "ops.abft_embedding_bag": device_ops(
            torch, lambda: kops.abft_embedding_bag(*enc, req_bags,
                                                   tables["rowsums"])),
        "protected_call": device_ops(
            torch, lambda: protected_call("embedding_bag", enc4, req_bags,
                                          rule=ResolvedRule()))}
    n_ops = {k: sum(c for _, c in v) for k, v in eb_ops.items()}
    log(f"device operations of one protected EmbeddingBag call: {n_ops} "
        f"({eb_ops})")
    if n_ops["ops.abft_embedding_bag"] != 1 or n_ops["protected_call"] > 2:
        fail(f"a protected EmbeddingBag call ran {n_ops} device operations")
    details["eb_device_ops"] = eb_ops

    def int_mm_cases():
        out = []
        for (a, bp), (k, n) in zip(k1_main, shapes):
            kp, np_ = -(-k // 8) * 8, -(-(n + 1) // 8) * 8
            ap = torch.zeros((32, kp), dtype=torch.int8, device=dev)
            ap[:m, :k] = a
            bq = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
            bq[:k, :n + 1] = bp[:, :n + 1]
            out.append((ap, bq))
        return out

    # the library call computes the padded product; it is a yardstick only,
    # so a refusal of its shape limits is reported, not fatal
    mm_cases = int_mm_cases()
    try:
        library_k1 = timer.ms(seq(torch._int_mm, mm_cases))
    except RuntimeError as e:
        log(f"torch._int_mm refused the padded shapes: {e}")
        library_k1 = None
    # K3 -> K1 over one request's 8 layers (the weights warm: 1.9 MB)
    dlrm_pair = pair_times(
        timer, [(x, quantize_rows_cuda(x)[0], lambda bp=bp: bp)
                for x, (_, bp) in zip(k3_main, k1_main)], 20)
    log(f"DLRM request, K3 -> K1 over 8 layers {dlrm_pair['pair_ms']:.4f} "
        f"ms, K1 alone {dlrm_pair['k1_alone_ms']:.4f}, K3 alone "
        f"{dlrm_pair['k3_ms']:.4f}: K3 exposed "
        f"{dlrm_pair['exposed_ms'] / 8 * 1e3:.3f} us a launch (without "
        f"PDL: pair {dlrm_pair['pair_no_pdl_ms']:.4f}, K1 alone "
        f"{dlrm_pair['k1_alone_no_pdl_ms']:.4f}, exposed "
        f"{dlrm_pair['exposed_no_pdl_ms'] / 8 * 1e3:.3f} us)")
    details["dlrm_k3_k1_pair"] = dlrm_pair
    rows = [
        ("abft_qgemm", "src/repro_torch/csrc/abft_qgemm.cu",
         timer.ms(seq(abft_qgemm_cuda, k1_main)),
         timer.ms(seq(ref.abft_qgemm_ref, k1_main)),
         bound_ms(k1_bytes, k1_ops, INT8_OPS_PER_S), library_k1),
        ("abft_embeddingbag", "src/repro_torch/csrc/abft_embeddingbag.cu",
         timer.ms(eb_fn(req_bag_sets)), timer.ms(eb_plain_fn(req_bag_sets)),
         (k2_bound, k2_by), None),
        ("quantize_rows", "src/repro_torch/csrc/quantize_rows.cu",
         timer.ms(seq(quantize_rows_cuda, [(x,) for x in k3_main])),
         timer.ms(seq(ref.quantize_rows_ref, [(x,) for x in k3_main])),
         bound_ms(k3_bytes, k3_ops, F32_OPS_PER_S), None),
    ]
    per = {"abft_qgemm": "one request: 8 launches, the layer shapes at m=10",
           "abft_embeddingbag": "one request: 1 launch, 26 tables x 10 "
                                "bags x <=16 slots",
           "quantize_rows": "one request: 8 launches, the layer input "
                            "widths at m=10, bf16"}
    kernels = []
    for name, source, ms, plain_ms, (bms, by), lib in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "per": per[name]})
    kernels[2]["exposed_in_k1_pair_ms"] = dlrm_pair["exposed_ms"]
    kernels[1]["sector_bound_ms"] = k2_sectors

    # the larger shapes, for the record (the library call's operand is
    # padded to n + 8 columns outside the timed region)
    b_big = bp_big[:, :1032].contiguous()
    big_bag_sets = [big_bags] + [
        torch.randint(0, ex.table_rows, big_bags.shape, generator=gen,
                      device=dev, dtype=torch.int32) for _ in range(3)]
    k3_tiny = torch.randn((1, 8), generator=gen, device=dev).to(
        torch.bfloat16)
    (big_bound, _), (big_sectors, _) = eb_bounds(big_bags, ex.emb_dim)
    details["large"] = {
        "abft_qgemm m=2048 k=1024 n=1024": {
            "ms": timer.ms(lambda: abft_qgemm_cuda(a_big, bp_big), 10),
            "plain_ms": timer.ms(lambda: ref.abft_qgemm_ref(a_big, bp_big),
                                 10),
            "library_ms": (timer.ms(lambda: torch._int_mm(a_big, b_big), 10)
                           if library_k1 is not None else None),
            "bound": bound_ms(2048 * 1024 + 1024 * 1025 + 4 * 2048 * 1028,
                              2 * 2048 * 1024 * 1025, INT8_OPS_PER_S)},
        # a chain of the smallest K3: what a launch costs with nothing to
        # do, each a programmatic dependent of the last, and without that
        "quantize_rows 1x8 (launch floor)": {
            "ms": timer.ms(lambda: quantize_rows_cuda(k3_tiny), 50),
            "no_pdl_ms": timer.ms(
                lambda: quantize_rows_cuda(k3_tiny, pdl=False), 50)},
        "quantize_rows 2048x1024": {
            "ms": timer.ms(lambda: quantize_rows_cuda(k3_inputs[-1]), 10),
            "plain_ms": timer.ms(
                lambda: ref.quantize_rows_ref(k3_inputs[-1]), 10),
            "bound": bound_ms(5 * 2048 * 1024 + 8 * 2048, 6 * 2048 * 1024,
                              F32_OPS_PER_S)},
        "abft_embeddingbag 26x2048 bags x 100": {
            "ms": timer.ms(eb_fn(big_bag_sets), 4),
            "plain_ms": timer.ms(eb_plain_fn(big_bag_sets), 2),
            "bound": big_bound, "sector_bound_ms": big_sectors},
    }
    details["profile"], dtypes = kernel_input_dtypes(
        lambda: profile_requests(torch, engine, stream(4, 31)))
    details["kernel_input_dtypes"] = dtypes
    if dtypes != {"quantize_rows": [("bfloat16",)], "wkv6_chunked": []}:
        fail(f"K3 was handed {dtypes} on the DLRM path, not its bf16 "
             f"activations uncast")

    phase_done("3-5 DLRM")
    # --------------------------- 6-8. RWKV6-1.6B ----------------------------
    from repro_torch.configs import get_arch
    rwkv = rwkv_phases(torch, dev, timer, details, get_arch("rwkv6-1.6b"),
                       (4, 4096))
    phase_done("6-8 RWKV6-1.6B")
    # ----------------------- 9. the campaign grids --------------------------
    camp_dir = str(Path(args.out).parent / "campaign") if args.out else None
    campaign = campaign_phase(torch, dev, camp_dir)
    quick_artifact = campaign.pop("quick_artifact")
    details["campaign"] = campaign
    phase_done("9 campaign grids")
    # ------------------- 10. the thresholds grid (K2) ----------------------
    thresholds = thresholds_phase(torch, dev, camp_dir)
    details["thresholds"] = thresholds
    phase_done("10 thresholds")
    # ------------- 11. the overhead benchmarks (Fig. 5, Table I) -----------
    overhead = overhead_phase(torch, dev, timer)
    details["overhead"] = overhead
    phase_done("11 overhead benchmarks")
    # ------------------------- 12. the float DLRM --------------------------
    details["float_dlrm"] = float_dlrm = float_dlrm_phase(torch, dev, ex,
                                                          tables)
    phase_done("12 float DLRM")
    # --------------------- 13. Llama-3.2-1B chat serving -------------------
    llama = llama_phase(torch, dev, timer)
    details["llama"] = llama["record"]
    phase_done("13 Llama-3.2-1B")
    # --------------- 14. Llama-3.2-1B paged chat serving -------------------
    paged = llama_paged_phase(torch, dev, timer,
                              llama["record"]["serve"]["step_ms_median"],
                              camp_dir)
    details["llama_paged"] = paged["record"]
    phase_done("14 Llama-3.2-1B paged")
    # ------------- 15. granite-moe-3b-a800m (MoE) chat serving -------------
    granite = granite_phase(torch, dev, timer)
    details["granite"] = granite["record"]
    phase_done("15 granite-moe-3b-a800m")
    # --------------- 16. the serving soak and the SLO ladder ---------------
    soak_slo = soak_slo_phase(torch, dev, camp_dir, {
        "llama3.2-1b": llama["record"]["eb_table_scan"],
        GRANITE: granite["record"]["eb_table_scan"]})
    details["soak_slo"] = soak_slo["record"]
    phase_done("16 serving soak and SLO ladder")
    # ------- 17. observability, monitor and adaptive thresholds ----------
    obs_path = observability_phase(torch, dev, llama.pop("params"),
                                   quick_artifact, args.out and str(
                                       Path(args.out).parent))
    details["observability"] = obs_path["record"]
    phase_done("17 observability, monitor and adaptive thresholds")
    # -------------------- 18. training under faults ----------------------
    training = training_phase(torch, dev, args.out and str(
        Path(args.out).parent))
    details["training"] = training["record"]
    phase_done("18 training")
    # -------- 19. whisper, hymba, llava and internlm2 at full width --------
    families = family_phase(torch, dev)
    details["families"] = families["record"]
    phase_done("19 whisper, hymba, llava, internlm2")
    # ------- 20. training of granite, RWKV6, whisper, hymba and llava -------
    # phase 3's DLRM (its 14 GB of tables) trains nothing: freed first
    del engine, params, tables, layers, enc, enc4, big_bags, top0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 20 starts with {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated")
    train_fams = train_families_phase(torch, dev)
    details["train_families"] = train_fams["record"]
    phase_done("20 training of the other families")
    # ------------- 21. the data mesh: deferred, ZeRO-1, the grid -----------
    mesh = mesh_phase(torch, dev, args.out and str(Path(args.out).parent))
    details["mesh"] = mesh["record"]
    phase_done("21 the data mesh")
    # ---------- 22. the dry run's predictions against phases 11-21 ---------
    dry = dryrun_phase(torch, dev, training["record"],
                       mesh["record"]["zero1"], overhead["gemm"], dry_cli)
    details["dryrun"] = dry["record"]
    phase_done("22 the dry run against the card")
    # ------- 23. the model axis: TP training, the two large configs --------
    axis = model_axis_phase(torch, dev, tp_pred)
    details["model_axis"] = axis["record"]
    phase_done("23 the model axis")
    kernels[0]["llama_shapes"] = llama["k1_times"]
    kernels[0]["granite_expert_shapes"] = granite["k1_times"]
    kernels[1]["llama_token_table"] = llama["k2_times"]
    kernels[1]["rwkv_token_table"] = rwkv["k2_times"]
    kernels.append(rwkv["k4_row"])
    for r in overhead["rows"]:
        (bms, by) = r.pop("bound")
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": overhead["launches"][r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": r["library_ms"], "per": r["per"],
            "baseline_of": {"qgemm_unprotected": "abft_qgemm",
                            "eb_unprotected": "abft_embeddingbag"}[r["name"]],
            "note": "the unprotected instance the overhead benchmarks time; "
                    "not a TPU kernel's port"})
    # each path's counts were set to 0 just before it and read just after
    by_path = {"dlrm": launches, "rwkv6": rwkv["launches"],
               "campaign": campaign["launches"],
               "thresholds": thresholds["launches"],
               "overhead": overhead["launches"],
               "float_dlrm": float_dlrm["launches"],
               "llama": llama["launches"],
               "llama_paged": paged["launches"],
               "granite": granite["launches"],
               "serving_soak": soak_slo["soak_launches"],
               **{f"slo_ladder {a}": v for a, v in
                  soak_slo["ladder_launches"].items()},
               "observability": obs_path["launches"],
               "training": training["launches"],
               **families["launches"],
               **train_fams["launches"],
               **mesh["launches"],
               "dryrun": dry["launches"],
               **axis["launches"]}
    for row in kernels:
        row["launches_by_path"] = {p: counts[row["name"]]
                                   for p, counts in by_path.items()}
    details["kernels"] = kernels
    details["phase_seconds"] = phase_s
    details["seconds"] = time.perf_counter() - t_start
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    log("large shapes: " + json.dumps(details["large"]))
    log(f"serve: request ms median {details['serve']['request_ms_median']:.3f}"
        f" of {serve_ms}")
    log(f"done in {details['seconds']:.1f}s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(details, indent=2))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
