#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py                # the whole run (one card)
    python3 chip_smoke.py --profile      # plus a torch.profiler breakdown
    python3 chip_smoke.py --timing-only  # phases 1, 2 and 11 alone
    python3 chip_smoke.py --sweep        # phases 1, 2, then the split sweep
    python3 chip_smoke.py --mixed-only   # phases 1, 2, then phase 6 (a) alone
    python3 chip_smoke.py --constrained-only  # phases 1, 2, 12, 7 and 8 (b)
    python3 chip_smoke.py --speculative-only  # phases 1, 2, 3 and 11 at the
                                              # verify shapes, the cost anchor, 13
    python3 chip_smoke.py --int8-only    # phases 1, 2, then 14 (a), (b) and (f)
    python3 chip_smoke.py --observability-only  # phases 1, 2, then 15 on the
                                                # 7B weights alone
    python3 chip_smoke.py --fleet-only   # phases 1, 2, then 16 (a) on the 7B
                                         # and 3B weights alone
    python3 chip_smoke.py --disagg-only  # phases 1, 2, then 17 on the 7B
                                         # weights alone
    python3 chip_smoke.py --remote-only  # phases 1, 2, then 18 (a) and (b)
                                         # on the 7B weights alone
    python3 chip_smoke.py --elastic-only # phases 1, 2, then 19 on the 7B
                                         # weights alone
    python3 chip_smoke.py --mesh-only    # phases 1, 2, then 20 on the 7B
                                         # and 3B weights alone
    python3 chip_smoke.py --pool-mesh-only  # phases 1, 2, then 21 on the 7B
    python3 chip_smoke.py --sp-only      # phases 1, 2, then 22 on the 7B
    python3 chip_smoke.py --warmup-only  # phases 1, 2, then 23 on the 7B

`--timing-only` times the package that sits beside this file (and prints
the bf16 prefill's output digests), so a copy of this file placed in an
unpacked archive of another commit times that commit's kernels at the same
shapes (for comparing two commits in one call, in turns); `--mixed-only`
does the same for the ragged mixed rounds' serve phase on the 7B weights.
`--sweep` times each decode launch (T == 1, bf16 and int8 caches,
contiguous and paged) at every cluster size of SWEEP_SPLITS beside the
split plan's pick, at phase 11's shapes, then each paged query window
(T > 1) at the mixed round's shapes (MIXED_SHAPES) beside
`window_split_plan`'s pick. `--constrained-only` runs the grammar-constrained
paths of phases 12 and 8 (b) (with phase 7's schedulers under them) on the
7B and 3B weights, phase 6 (b)'s overcommit included. `--speculative-only`
runs phase 3's cases at the speculative verify shapes (`SPEC_CASE_NAMES`),
the verify cost anchor, phase 13 on the 7B weights and phase 11's
verify-shape timing.

Phases, each fatal on failure:

1. Device: requires CUDA; prints the card's name and power limit as
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them.
2. Build: compiles every `csrc/*.cu` of the port with nvcc (one process per
   source, all at once) and prints the build seconds, the CUDA runtime and
   driver versions the kernels run on and, for each kernel, ptxas's
   register, shared-memory and spill lines.
3. Kernels against their plain versions, in bf16 and f32:
   - both launches of the flash GQA attention kernel (prefill T > 1, decode
     T == 1; bf16 prefill runs the tensor-core kernel, decode the split-KV
     kernel of `decode_split.cuh`) at the engine path's shapes
     (duckdb-nsql-7B: N = K = 32; llama3.2-3B: N = 24, K = 8; both H =
     128), llama3.2-1B (H = 64), a Mistral window of 4096 over S = 8192, a
     row with kv_lens = 0, ragged last KV tiles and NaN planted in dead
     cache slots; the decode launch also at the split kernel's edges (G =
     1, 3, 4, 16 at H = 128 and 64; live lengths of 1 and 7 slots; kv_lens
     = 0 beside a full row; a window of 3), each decode case launched twice
     and compared bit for bit; prefill chunks of T = 100 and 37 (no multiple of 64)
     over S = 1024 with ragged starts, windows, kv_lens = 0 and NaN past the
     live length; and the prefill launch at the scheduler's chunked-prefill
     shapes (7B and 3B, groups of 6-8 rows, buckets of 128, 32 and 16 over
     S = 1024 row views, chunk starts after prefix reuse that end mid-page,
     default kv_lens), and the paged chunk's 128-token bucket over one
     layer's view at the paged schedulers' default max_seq (7B: S = 4096,
     3B: S = 8192, 8 rows up to the row's end); the decode launch also at the contiguous scheduler's
     8 slots over the whole cache (7B over 4096, 3B over 8192; six live
     rows, two parked at kv_lens = 0, NaN in every dead slot);
   - the ragged paged attention kernel at the 7B, 3B and 1B shapes, T = 1,
     B = 8 as the scheduler's slots, through permuted tables with sentinel
     entries, parked rows (all-sentinel, kv_lens = 0) and NaN planted in
     dead offsets and unmapped pages; windows T = 8 and 32 with ragged
     q_lens, a G*T = 512 window, pages of 16 and 64, a Mistral window; the
     ragged mixed round's windows (7B and 3B at their default max_seq,
     tables of 64 and 128 pages, B = 8, T = 32 and 16, two rows carrying a
     chunk, four decode rows at q_len 1 with their dead columns one past
     the row, two parked rows); windows that stress the window kernel's
     split (`window_stress_cases`: 8 chunks ending at 4096, a window of
     4096 over rows of 8192, pages of 16 and 8 with sentinel pages in a
     live tile's dead tail); and T = 1 (the split-KV kernel) at its edges
     through tables; every case launched twice and compared bit for bit
     (bf16 windows run the split tensor-core kernel of
     `window_split.cuh`, f32 windows the tile kernel); bf16 windows also
     per query row (WINDOW_ROW_TOL), a limit that a planted fault (the
     plain version without one 64-slot tile of the longest row, at
     WINDOW_CONTROLS) must fail;
   - the page write (one kernel for both pools, `page_write.cuh`),
     bit-exact, at WRITE_CASES: T = 1 at B = 8 into the 7B and 3B
     schedulers' pools (128 pages of 64, tables of 16 pages) at their last
     layer with parked rows, the same at 1B's H = 64, T = 4 with q_lens and
     sentinel rows, a 7B round in which every sliver drops (the pool
     must be unchanged), the mixed round's writes at the same shapes
     (chunks of 32 and 16, decode rows' dead columns dropped), and the
     paged prefill chunk's write-back (7B and 3B at their default max_seq,
     tables of 64 and 128 pages, B = 8, T = 128, no q_lens, ragged starts,
     columns past each row's mapped pages and past the row dropped);
   - the quantized serving path's four kernels: the quantized decode
     attention (the split-KV kernel over int8) at the decode cases
     above over an int8 cache (NaN in dead scales) and at the split kernel's
     edges (G = 1, 3, 4, 16 at H = 128 and 64; live lengths of 1 and 7
     slots; kv_lens = 0 beside a full row; a window of 3), the quantized
     ragged paged attention at the paged cases above over int8 pools and at
     the same edges through tables (T > 1 bf16 windows on the window kernel,
     f32 on the tile kernel), each
     int8 attention case launched twice and compared bit for bit, the
     page write into an int8 pool bit-exact (values and scales) at
     WRITE_CASES, and the int4 matmul at every 7B
     and 3B weight shape (wd's group of 86 included) and at OUT = 400 (no
     multiple of a column tile) at R = 1, 4, 8, 9, 16, 131, 384, 1024 and
     2048 (4 and 2048 are the engine batch's decode and prefill; 8 and 9
     straddle the decode / prefill crossover).
4. Small references, 2-layer f32 models (H = 64): greedy tokens through the
   kernels on the card must equal the plain versions' on the CPU, for the
   engine, the paged scheduler (page 16, shared prefixes) and the
   contiguous scheduler (the same traffic), the paged scheduler with
   ragged mixed rounds, and an overcommitted pool of 9 pages of 8 under a
   `kv:pressure` storm, resumed by recompute and by spill (preemptions >=
   1; spilled == restored); then the same with int4 weights and the int8
   KV cache.
5. Engine serve: a GenerationService with EngineBackends for `duckdb-nsql`
   (DUCKDB_NSQL_7B, full width and depth) and `llama3.2` (LLAMA32_3B on the
   llama3-chat template), random bf16 weights from a seed, ByteTokenizer.
   Three NL->SQL requests with a table schema in `system`, one batch of four
   mixed-length prompts, one error explanation. Launch counts are zeroed
   just before and read just after; each flash launch must number
   num_layers x (prefill calls + decode steps). Prefill logits through the
   kernel must agree with the plain version's.
6. Scheduler serve: the same weights behind paged continuous-batching
   schedulers (8 slots, pages of 64, decode_chunk 8, max_seq at its
   default: 4096 for 7B, 8192 for 3B, pools of 16 and 7 GiB) and
   SchedulerBackends. Two NL->SQL requests one after the other, then six at
   once from threads while a 3B error explanation runs. Launch counts are
   zeroed just before and read just after: ragged paged attention must
   number num_layers x decode_chunk x rounds issued, flash prefill
   num_layers x prefill forwards, page writes both (each chunk writes its
   window back one layer at a time). The peak extra device memory of one
   7B chunk of 8 rows ending at 4096 (two layers of the weights over a
   pool of their own: the transient is one layer's views) is printed
   beside the all-layer views' bytes. The prefix cache must hit, share
   pages and leak none; one decode step on the live pool through the
   kernels must agree with the plain versions, at full depth in bf16 and
   on an f32 copy of two layers, and a one-page fault planted on the plain
   side must miss by more than each tolerance.
   With --profile, one 7B engine request and six concurrent 7B scheduler
   requests run under torch.profiler: device busy share and device time
   by kernel group.
   Then, each fatal and timed:
   (a) ragged mixed rounds: the 7B paged scheduler with `ragged=True`
   over the bf16 and the int8 pool, the SQL traffic; launch counts exact,
   the attention's L launches at T in {16, 32} a mixed round or a ragged
   prefill (a chunk issued while no slot decodes runs the mixed round's
   first step alone; the rest at T = 1, recorded at the dispatch seam), no
   flash prefill; the live pool's decode step kernel vs plain.
   (b) overcommit: the 7B paged scheduler at its default max_seq (4096),
   FLEET_LAYERS deep (since PR 24),
   kv_overcommit 0.5, a burst of six OVERCOMMIT_NEW-token requests, the last three
   under the generic grammar, over a pool that
   holds their admissions (more than one max-length row's 64 pages) and
   not their budgets: spill mode preempts (a constrained request among the
   victims), restores every
   spilled page and gives the control's tokens; recompute mode preempts
   (a constrained victim too) and prints how many streams equal the
   control's and where the others diverge; every constrained stream of
   the three runs passes phase 12's grammar checks.
   (c) admission: max_queue_depth 2 sheds a burst of 12 with Overloaded
   and 1 <= retry_after_s <= 60; `sched:slot_stall:1` retires one request
   SlotStalled after 16 rounds while three beside it complete.
7. Contiguous scheduler serve, the reference app's default: the same
   weights behind ContinuousBatchingSchedulers with `kv_layout` and
   `max_seq` left at their defaults (contiguous; 4096 for 7B, 8192 for 3B:
   a 16 GiB and a 7.5 GiB cache), 8 slots, decode_chunk 8. Phase 6's
   traffic. Launch counts exact: flash decode num_layers x decode_chunk x
   rounds, flash prefill num_layers x prefill forwards (each chunk runs
   over its slots' own cache rows, one layer at a time). The schema prefix
   must hit; one decode step over the live cache (the longest cached
   prefix's blocks) through the kernels must agree with the plain
   versions, at full depth and on an f32 copy of two layers, and a fault
   planted on the plain side (each odd block a copy of the block before
   it) must miss.
8. App: `POST /process-data/` through the port's API app
   (`create_api_app(service, SQLiteBackend, SQLiteHistory(":memory:"),
   cfg)`, a temporary `data/input/taxi.csv`, the WSGI test client) on
   phase 7's schedulers: three requests one after the other, then four
   from threads. The SQL model's text is decoded byte id mod 256 (random
   weights almost never pick one of the ByteTokenizer's own ids, and
   SQLite runs empty SQL as a success), so every request walks the failure
   path: generate, execute, two repair regenerations, the 3B explanation.
   Each body must have tests/test_app.py's failure shape; launch counts
   exact; wall and TTFT per request. Then `/api/generate` with
   stream=true on the 7B scheduler: a 32-token completion in more than one
   NDJSON chunk, timed as they arrive through the app's WSGI callable,
   that join to the blocking text of the same prompt.
   (b) `LSOT_CONSTRAIN_SQL=1`: the app over the same schedulers (the SQL
   model behind a ByteTokenizer backend) compiles the CSV's columns and
   the view into the SQL model's grammar; two `POST /process-data/` in
   turn and two from threads, every SQL generate (the repair loop's
   included) held to the grammar checks of phase 12 against the CSV's
   schema, each body the success or the failure shape; `/api/generate`
   with `constrain: "spark_sql"` answers 200 with SQL that parses; launch
   counts exact. Then the entry
   point as a user starts it, `python -m llm_based_apache_spark_optimization_tpu_torch.app
   --backend tiny --api` in a process of its own on the card: one `POST
   /process-data/` over HTTP on localhost, then SIGTERM, and it must drain
   and exit 0.
9. Quantized serve: DUCKDB_NSQL_7B at full width and depth with int4 block
   weights (`quantize_params_int4` of the seed-0 bf16 tree, on the card)
   and the int8 KV cache: an `EngineBackend` over an
   `InferenceEngine(kv_quant="int8")` serves two NL->SQL requests and a
   batch of four, then a `SchedulerBackend` over a paged
   `ContinuousBatchingScheduler(kv_quant="int8")` (settings of phase 6)
   two requests one after the other and six at once, then the same over a
   contiguous `ContinuousBatchingScheduler(kv_quant="int8")` (8 slots x
   4096). Launch counts exact: int4 matmuls 7 x layers x forwards (one
   launch a call: a split of the contraction axis is added up inside a
   thread-block cluster), quantized decode attention layers x engine
   decode steps (contiguous scheduler: x decode_chunk x rounds), quantized
   paged read and write layers x decode_chunk x rounds, flash prefill
   layers x prefill forwards. Prefill logits through the kernels agree with the plain
   versions'; the prefix
   cache hits, shares and leaks no page; the live int8 pool's decode step
   is checked as in phase 6, the live int8 cache's as in phase 7. With
   --profile, six concurrent requests under torch.profiler.
10. Checkpoints, over files written in a temporary directory (removed
   afterwards) from the seed-0 bf16 trees:
   (a) GGUF, the reference's deployment format, at full width, cut to
   GGUF_LAYERS = 7 of its 28 layers for the run's time:
   LLAMA32_3B (tied embeddings, llama3 rope scaling, so
   `rope_freqs.weight` is written) as a Q4_0 blob by the port's
   `write_gguf` (quantized on the card). `load_gguf_checkpoint` must give
   the direct q4_0 -> f32 -> bf16 round trip of the seed tree bit for bit
   (a second q4_0 implementation on the card, `q4_0_round_trip`), and
   the constructor `SchedulerBackend.from_gguf` calls, over that one load
   (`_from_checkpoint(quantize_int4=True, kv_quant="int8",
   supervise=True)`: contiguous, 8 slots, max_seq 8192; the blob is read
   once, for the run's time), the int4 tree of that round trip; three requests one after the other give the greedy
   tokens of a scheduler built from the round trip in memory. Then phase
   6's traffic, launch counts exact (int4 matmul, flash prefill,
   quantized decode: rows 1, 3 and 8).
   (b) HF safetensors at full width: DUCKDB_NSQL_7B cut to HF_LAYERS = 4
   layers (f32 on disk: 27 GB at full depth, 4.3 GB at 4), written by the
   port's `save_hf_checkpoint` after a free-disk check, loaded by
   `SchedulerBackend.from_hf_checkpoint(supervise=True)` (bf16,
   contiguous, 8 slots, max_seq 4096): the loaded tree must equal the seed
   tree bit for bit; phase 6's traffic, launch counts exact (rows 1, 2).
   (c) The supervisor on the card, over (b)'s backend: a burst of six
   requests (prompts sharing no prefix with earlier traffic) whose first
   streamed token arms `sched:crash` once (utils/faults.py), so the next
   harvest kills the loop mid-batch. Every request completes; health()
   goes restarting -> ready; restarts 1, replayed 6, lost 0; each token
   streams once; each request's tokens equal those of the same burst on a
   fresh scheduler without the fault. The bursts are submitted with a
   0.5 s GIL switch interval, so each run admits all six at once and
   prefills the same groups. Launch counts exact over both incarnations.
   (d) The entry point: `python -m <package>.app --backend checkpoint
   --api --sql-model-path <(b)'s directory> --error-model-path <the 3B
   blob cut to ENTRY_3B_LAYERS = 4 layers, written beside (a)'s for the
   entry points of (d), 14 (e) and 16 (b), for the run's time
   budget>:<tokenizer directory>`,
   supervised by default, with a byte-level
   BPE `tokenizer.json` trained here by the `tokenizers` package (where it
   does not import, the line `checkpoint entry point: not run (no
   tokenizers package on this machine)` is printed instead): `/readyz`
   ready, `POST /process-data/` 200, exit 0 after SIGTERM.
11. Timing at the main paths' shapes (one CUDA graph of one call per layer,
   each on its own layer so K/V and weights come from device memory,
   replayed between CUDA events): kernel, plain version and a PyTorch
   yardstick the port never calls (`scaled_dot_product_attention`, over
   K/V dequantized in advance for the int8 caches; for the page writes,
   `index_put_` of the same slivers, quantized in advance; for the int4
   matmul, `torch.matmul` against the weight dequantized to bf16 in
   advance: the bf16 product, moving 4x the weight bytes, since no PyTorch
   call computes the int4 function). The flash prefill at the 7B prompt
   and at the scheduler's prefill chunk (B = 8, T = 128, S = 1024); the
   decode attention, over the bf16 and the int8 cache, at the engine's B =
   1 and its batch of four (S = 512, rows at the prompts' 317-443 tokens)
   and at the contiguous scheduler's 8 slots (S = 4096, six rows at the
   concurrent requests' 334-460 tokens, two parked; 8 layers cycled);
   the paged reads and the page writes at the scheduler's 8 slots (live
   64-1024; each write also with every sliver dropped, its floor, and with
   the table prefetch forced on and off), and the paged reads at the ragged
   mixed round's first step (MIXED_SHAPES: 7B and 3B at their default
   max_seq, T = 32 and 16, `mixed_rows`; 8 layers; the writes at 7B T = 32);
   the int4 matmul for 7B's `wq` and `wd` at R =
   1, 4, 8 (decode) and 1024 (a prefill chunk). The bound is the larger of the bytes over 3.35 TB/s
   and the FLOPs over 989 TFLOP/s (H100 SXM, bf16 dense).

12. Constrained decoding, run after phase 9 (grammar masks over the ported kernels; the
   grammars, generic `spark_sql` and the prompts' `trips` schema, are
   compiled over the ByteTokenizer before phase 5, their device table
   bytes printed beside the card):
   (a) the 7B engine: the three NL->SQL prompts as one batch under each
   grammar and unconstrained (the control; the decode step walls of the
   three printed beside the card), one schema request at max_new_tokens
   == min_new_tokens, one over the int8 cache;
   (b) the 7B paged scheduler with ragged mixed rounds over the bf16 pool:
   six requests at once, two generic, one free, two schema, one free, so
   the schema pair waits for the generic pair to drain and the tables swap
   (grammar swaps == grammar changes == 2);
   (c) the same with int4 weights over the int8 pool.
   Every constrained completion of phases 6 (b), 8 (b) and 12 must end at
   a stop id within its budget, walk the grammar token by token, parse
   under the port's `parse_spark_sql` and, under a schema grammar, name
   only its columns and table; the unconstrained controls must parse
   below 100%. Launch counts exact on every path, and the constrained
   paths together launch every kernel of the `kernels` line.

13. Speculative decoding, run after phase 12, D = SPEC_DRAFT = 8 (phase
   3 also holds every kernel at the verify shapes: row 1 at T = 9 over the
   engine's cache and the contiguous schedulers' 8 slots with parked rows
   past the cache, rows 4-5 at the paged rounds with parked rows at q_len
   0 and at PS = 4096 (one page a row), rows 6-7 writing 9-wide windows,
   row 8 at R = 72, and row 5 through the contiguous int8 cache's one-page
   view as `forward` calls it (`check_int8_view`); phase 11 times them,
   `time_verify`, and measures the verify cost anchor, `verify_cost_anchor`:
   the median of five readings of the median wall of a T = 9 over a T = 1
   forward at bench-1b, B = 8). It first measures how far the verify
   window's logits sit from the decode step's over the same prefixes on the
   7B weights (`logit_drift`: bf16 and int8 caches, int4 weights) and the
   verify cost at 7B beside the model's estimate (`verify_cost_7b`), then:
   (a) the 7B engine, the three NL->SQL prompts as one batch, contiguous
   bf16, paged bf16 and paged int8, each beside the vanilla engine of its
   layout;
   (b) the copying variant (every block's `wo` and `wd` zeroed, lm_head :=
   embed; premise: vanilla greedy repeats the prompt's last token): the
   engine (contiguous, paged int8) and the contiguous scheduler equal
   vanilla outright at >= D tokens a round;
   (c) the contiguous and the paged scheduler in bf16 and the contiguous
   one with int4 weights over the int8 cache (SPEC_SCHED_VARIANTS: the
   paged int8 pool's verify rounds run in phase 14 (d)): six requests at once (one sampled), then the sampled one
   again in another batch mix (its tokens repeat), greedy streams beside
   the vanilla scheduler's; every verify round under sync debug mode
   "error" (no host synchronisation inside a round);
   (d) a constrained burst (three generic, three free) held to phase 12's
   checks; (e) ragged mixed rounds at D = 4 (mixed rounds > 0); (f) the
   overcommit burst (spill equal to the control, recompute equal or at a
   near-tie, preemptions >= 1 both; the sampled request equal to the
   control up to its first recompute resume, which restores the stream
   index the control's rounds reached there and its history row); (g) `POST /process-data/` over a
   speculative 7B scheduler, then the entry point with `--speculative 8`.
   Every speculative stream equals the vanilla stream of its layout or
   first leaves it where the two tokens' logits lie within twice the top
   ids' drift measured for its weight and cache types, the drift over
   every id within DRIFT_ULPS bf16 ulps (each divergence printed with its position and gap);
   `speculation_stats`' delivered tokens equal what the requests received;
   launch counts exact; tokens per verify round printed per path.

14. int8 weights and the fused trees (ROADMAP A10): (a) in phase 3, the
   int8 matmul (`csrc/int8_matmul.cu`, no TPU counterpart: the JAX package
   leaves the int8 product to XLA) against its plain version at every
   shape of INT8_SHAPES (7B wq, wg, wd, the fused wqkv and wgu, the [V, D]
   unembed; 3B wq, wk, wg, wd, the fused wkv and wgu, unembed) at every R
   of INT8_ROWS (each route's first and last row count: the decode kernel
   up to 8, the wgmma kernel's tiles N above) in
   bf16 and at INT8_F32: bf16 block outputs within one bf16 ulp of the
   plain value element by element (`bf16_ulps`), f32 logits within
   INT8_LOGIT_TOL, f32 outputs within INT8_F32_TOL of max |plain|, every
   call launched twice and bit-identical; (b) in phase 3, row 8 at the
   stacked widths (INT4_STACKED) within INT4_TOL; (c) after phase 13, the
   7B engine over `quantize_params` + `quantize_unembed` of the seed-0 tree,
   unfused and fused, and the 3B engine fused: launch counts exact (7 x 32 +
   1, 4 x 32 + 1, 5 x 28 + 1 `int8_matmul` a forward), fused streams held
   to unfused ones and the unfused 7B streams to the same weights through
   the plain versions by the near-tie rule (`logit_drift` on these
   weights), a generic-grammar batch held to phase 12's checks (with
   --profile, the batch on the bf16, the int8 and the fused int8 7B
   engines under torch.profiler); (d) both
   schedulers with the int8 tree: the paged one fused, ragged, over the
   int8 pool and the contiguous one, phase 6's traffic and a burst with
   staggered budgets, then a speculative burst (D = 8) on the paged one,
   every burst's streams held by the near-tie rule to an unfused engine's
   over the same weights and cache type through the plain versions; launch
   counts exact, no page leaked; (e) in phase 10, the entry point with
   `--backend checkpoint --int8 --int8-unembed` over the 3B Q4_0 blob cut
   to ENTRY_3B_LAYERS layers serves `POST /process-data/`; (f) in phase 11, each int8 shape and row
   8's stacked shapes at R = 1, 8, 72, 1024 against their bounds, their
   plain versions and cuBLAS bf16 on the weight dequantized in advance,
   with each int8 call's route, tile, splits and blocks, the int8 kernels'
   ptxas registers, shared memory and spills, and the host us a call of
   the int8 and int4 wrappers and a bf16 `torch.matmul` dispatch.
   `--int8-only --profile` adds (c)'s profiled batch on the 7B engines.

15. Observability (the flight recorder's rounds, the roofline ledger, the
   metrics registry, `/metrics` and `/debug/*`), each part fatal and timed:
   (a) after phase 8 (b), on phase 7's 7B contiguous bf16 scheduler behind
   the app of phase 8 (its registry holds phase 8's requests); (b) after
   phase 9, on a 7B paged scheduler with phase 9's int4 tree over the int8
   pool (phase 6's settings). Each over one burst of six requests: three
   of OBS_LONG tokens, then `GET /debug/profile?rounds=4&model=duckdb-nsql`
   once they decode (a second arm must answer 409), then three more that
   arrive inside the capture, which is polled through `GET /debug/profile`
   until done. The burst's flight records must number consecutive rounds,
   emit the requests' output tokens, admit and retire the same rids and
   carry mfu and hbm_util in (0, 1.05] (the ledger must price the H100
   row: 989 TFLOP/s, 3350 GB/s); paged, the last record's pages equal the
   idle pool's prefix pages. The torch.profiler artifact must hold the
   hand-written kernels of OBS_KERNELS by name (rows 1 and 2; rows 1, 5, 7
   and 8), and `traceprof.Trace` reads the device busy share: the
   captured decode rounds' median hbm_util may not exceed it, their walls
   (each round's span on the card, CUDA events) must fit in the capture's
   span, and their roofline time (max(mfu, hbm_util) x wall) in its busy
   time. Each decode record's bytes a step (hbm_util x wall x 3350 GB/s /
   decode_chunk) must lie between the weights' bytes on the card and those
   plus the whole KV cache's. Then the host us of a
   round's `flight.record` + `perf.observe`; then `/metrics` (JSON with the
   `serving.perf`, `serving.flight_recorder` and registry blocks, and the
   Prometheus text, parsed) and `/debug/flightrecorder`, `/debug/traces`,
   `/debug/slo`, `/debug/prefixcache`. Prints the registry's queue wait
   and TTFT percentiles, and an `{"observability": ...}` line before the
   kernels line.

16. The co-resident fleet (ROADMAP A7.10, A7.6's tenant half, A11's front
   door and model pool): (a) after phase 15 (a), phase 7's schedulers
   freed, one `SchedulerPool` built by the entry point's
   `make_model_pool_service` over phase 7's 7B and 3B bf16 trees at full
   width, cut to FLEET_LAYERS layers for the run's time (phases 16-19):
   `duckdb-nsql` on two replicas sharing the 7B tree,
   `llama3.2` on one, paged, FLEET_SLOTS slots a replica, FLEET_HBM_GB GiB
   of KV split 0.75 / 0.25, under the crash supervisor, QoS on with
   LSOT_TENANT_WEIGHTS FLEET_WEIGHTS, behind the service and the JSON API
   (`fleet_serve`). Burst A in flight together: 12 SQL requests of tenant
   `storm` (batch), then 3 of `quiet` (interactive) and 3 explanations on
   `llama3.2`: every placement on a replica of its model and both 7B
   replicas used, `quiet`'s queue-wait p50 below `storm`'s. Under
   LSOT_TENANT_RATE FLEET_SHED_RATE the app sheds `storm` 429 with
   Retry-After and serves `quiet`. Burst B: FLEET_BURST_B SQL requests and
   2 explanations with `restart_replica` of the 7B replica holding the most
   slots (prefix affinity may route the whole burst to one): it alone is
   rebuilt (the others' restart counts 0, no pool restart), its entries
   replayed, none lost. Launch counts exact over both bursts (every
   replica object, the rebuilt one included); no replica leaks a page;
   `/metrics` carries lsot_model_replicas 2 and 1, each model's partitioned
   pages and the lsot_tenant_* families; `/healthz` carries `fleet`. Each
   greedy stream equals a lone scheduler's of its model (built by its
   replica's own factory: FLEET_SLOTS slots, the replica's KV share) fed
   the model's prompts in the pool's admission order, or leaves it at a
   near-tie: the first diverging tokens' logit gap within twice the
   model's top-id drift (`logit_drift`, phase 13's measure). Prints
   placements per replica, queue-wait p50 per tenant, the shed count, the
   restart's seconds and the streams equal exactly per model, and a
   `{"fleet": ...}` line before the kernels line. (b) in phase 10, after (e): the entry point's
   `LSOT_MODELS` checkpoint branch over the 3B Q4_0 blob cut to
   ENTRY_3B_LAYERS layers and (b)'s 4-layer 7B HF directory, co-resident in one supervised pool in a
   process of its own (`--kv-layout paged --kv-hbm-gb 4`): one `POST
   /process-data/`, one explanation on `/api/generate`, `/healthz`'s
   `fleet` (`fleet_entry_point`).

17. The phase-split fleet (ROADMAP A7.5: phase roles and the prefill ->
   decode KV handoff), after phase 16 (a), on phase 7's 7B bf16 tree at
   full width, cut to FLEET_LAYERS layers as in phases 16-19
   (`disagg_serve`). First the entry point's `--dp N
   --scheduler`, N one more than the cards, exits with the JAX entry
   point's device-count message before any checkpoint is read. Then a
   supervised `SchedulerPool` built through a per-replica factory (one
   card cannot take the entry point's `--dp 2`): r0 `prefill`, r1
   `decode`, sharing the tree, paged, pages of 64, DISAGG_SLOTS slots and
   DISAGG_HBM_GB GiB of KV each, behind a SchedulerBackend: (a) over the
   bf16 pool, 12 NL->SQL requests in flight together, the prefill
   replica's second pack pass holding a request killed by `sched:handoff`
   (no blob of that pass exported, its first tokens streamed); (b) over
   the int8 pool (`kv_quant="int8"`), 6 requests. Every request is
   imported by r1, decoded in place for backpressure or prefilled again
   by r1 after the fault; exports equal imports over every replica
   object; each export's bytes are its pages x the pool's page bytes (7B
   bf16: 32 MiB a page) and its pages cover prompt + first token; nothing
   lost, only r0 restarted, every stream equal to its result (a replayed
   request's first token may leave its replay's only at a near-tie); no
   page leaked; launch counts exact over every replica object (the faulted
   r0 and its rebuild included); `handoff_stats`, the decode records'
   pages_migrated / handoff_wait_s and the lsot_handoff_* families agree;
   a blob's round trip between the two pools bit for bit; each greedy
   stream equal to a lone mixed scheduler's of the same factory fed the
   same prompts at once, or leaving it at a near-tie (`fleet_compare`).
   Prints export seconds, import waits, bytes a request, the split
   fleet's and the mixed control's TTFT p50 and decode tok/s, and a
   `{"disagg": ...}` line before the kernels line.

18. The remote fleet (ROADMAP A11's remote half: serve/remote.py), after
   phase 17, on phase 7's 7B bf16 tree at full width, FLEET_LAYERS deep
   (`remote_serve`). Its replicas live in worker processes this file
   starts (`--remote-worker ROLE`, `remote_worker`): each rebuilds the
   tree on the card from seed 0 and prints its checksum, which must equal
   this process's, builds a paged scheduler of phase 17's shape (pages of
   64, DISAGG_SLOTS slots, DISAGG_HBM_GB GiB of KV), warms it up, zeroes
   its launch counts and serves it with the port's `ReplicaServer`; on
   SIGTERM it prints its launch counts beside those its rounds imply, and
   they must be equal. A supervised `SchedulerPool` keeps each
   `SocketTransport` under a lease of REMOTE_LEASE_S x REMOTE_LEASE_MISSES.
   (a) r0 a local prefill replica, r1 a remote decode worker, REMOTE_REQUESTS
   NL->SQL requests at once, every blob crossing in a requeue frame:
   exports equal imports (r1's read through the loads digest), each blob
   its pages x 32 MiB, each frame's wire bytes its raw bytes x the
   encoding's overhead, streams once, nothing lost, no page leaked in
   either process. (b) r0 a remote prefill worker pushing its handoffs,
   r1 a local decode replica: a wave of REMOTE_WAVE requests all through
   pushes (`fleet_stats().pushed`, no pull rpc), then a second wave during
   which the worker is killed with SIGKILL once a push of the wave has
   arrived; the lease expires, only r0 restarts, against a replacement
   worker (started before the kill when the card holds a third 7B process,
   else at the kill: a worker starts only when the card has room for it,
   and (b)'s first worker as soon as (a)'s local pool is freed), the
   journal replays the lost work with
   the delivered prefixes suppressed (a replayed request's first token may
   leave its replay's only at a near-tie), nothing is lost; two more
   requests go through the replacement. Each greedy stream equals a lone
   mixed scheduler's fed the same prompts or leaves it at a near-tie
   (`fleet_compare`). (c) in phase 10, after 16 (b): the worker's command
   line (`python -m <package>.serve.remote --from-hf DIR --kv-layout paged
   --kv-page-size 64`) over phase 10's 4-layer 7B HF directory: its hello
   digest, two requests equal to an in-process scheduler's over the same
   directory, and the same command with no card visible exiting non-zero,
   naming the card (`remote_cli`). Prints the frame encoding, per blob
   frame its raw and wire bytes and encode and decode seconds, push ->
   placed p50 / p95, SIGKILL -> lease expiry and the restart's seconds,
   TTFT p50 and decode tok/s beside phase 17's split fleet and the lone
   controls, and a `{"remote": ...}` line before the kernels line.

19. The elastic fleet and the eval harness (serve/elastic.py,
   `serve/factory.standby_spawner`, evalh/), after phase 18, on phase 7's
   7B bf16 tree, FLEET_LAYERS deep (`elastic_serve`). (a) A supervised `SchedulerPool` of one
   local mixed replica of phase 17's shape, a standby worker process of
   this file (`--remote-worker mixed`) that `standby_spawner` points at,
   and `FleetAutoscaler(...).run()` with ELASTIC_KNOBS (fleet 1..2, up at
   2 queued a replica, down at 0.5, hold 1 s, interval 2 s); `fleet:spawn`
   armed for the first attempt. ELASTIC_WAVE requests at once, the load
   held until the standby joins and takes a placement: one counted spawn
   failure with the fleet unchanged, then the join; once idle, a retire by
   drain (fleet 1), then ELASTIC_WAVE2 requests on the shrunk fleet.
   Nothing lost, streams once, each stream equal to a lone mixed
   scheduler's or leaving it at a near-tie, launch counts exact here and
   in the worker. (b) `evaluate_models` on the four-query suite and
   `run_repair_leg` on the Spider smoke cases (injection off and on) over
   that pool: every case terminal. (c) `python -m <package>.evalh --chaos`
   with its schedulers on the card, beside (a)-(b): nothing hung or lost,
   nothing mismatched, stage 8 with a join and a pushed handoff. (d)
   `evalh --backend oracle` at 100% exact and execution match, and the
   oracle report naming the card and its power limit. Prints the
   autoscaler's stats, burst -> join -> first placement seconds,
   placements per replica, the drain seconds, the lsot_fleet_* families,
   the harness's summaries with latency p50 and tok/s, each chaos stage's
   seconds, and an `{"elastic": ...}` line before the kernels line.
20. Meshes (parallel/, `mesh_serve`), inside phase 10 while its HF
   directory exists: two ranks, processes of this file (`--mesh-rank R`)
   on cuda:0 joined over gloo (NCCL refuses two ranks on one card), every
   collective staged through host memory. (a) rows 1, 4 and 6 against
   their plain versions at the 7B's per-rank shapes (16 heads); its tp=2
   paged scheduler is served by phase 21's pool. (b) tp=2
   LLAMA32_3B int4 engine (12 query and 4 KV heads a rank), bf16 and int8
   cache, rows 2, 3 and 8 at the per-rank shapes. (c) sp=2: a 2048-token
   prompt through ring attention, then 16 decode steps on the sp-sharded
   cache (plain PyTorch, as JAX's; no kernel launched). (d) the runbook as
   one command twice (convert, then restore, equal reports) over the HF
   directory, then `runbook.build_service` at tp=2 on the ranks. Each held
   to its tp=1 reference in this process: streams equal or near-ties under
   `fleet_compare`'s rule, ring logits within LOGIT_TOL. Prints an
   `{"mesh": ...}` line before the kernels line; the ranks' launches join
   it per rank (`mesh_*_rank0`, `mesh_*_rank1`).
21. A replica pool of tp meshes (`pool_mesh_serve`), after phase 20: the
   entry point's `--dp 2 --tp 2 --scheduler --kv-layout paged` pool of
   DUCKDB_NSQL_7B at full width, POOL_LAYERS deep (16 heads a rank),
   built by `launch.join_pool` and `make_dp_pool_backend` over the seed
   tree: this process is world rank 0 and rank 0 of both replicas' meshes,
   two follower processes of this file (`--pool-rank R`) hold the other
   halves, every shard on cuda:0 (LSOT_MESH_DEVICES) over gloo. First rows
   5 and 7 at pages of 16 and the int8 matmul at the tp=2 halves against
   their plain versions, and the tp=1 references. (a)
   `LSOT_POOL_PHASES=prefill:1,decode:1`, pages of 64, 8 slots, 8 GiB of KV
   a replica: six SQL requests at once, then two in turn, the second under
   `sched:handoff` (the prefill replica is rebuilt on its mesh, its
   follower building the twin): exports equal imports, every blob holding
   every head, nothing lost, no page leaked. (b) mixed/mixed, `--int8`,
   an int8 pool of 16-token pages with spill and overcommit 0.25, its
   pages withheld by `kv:pressure` down to two admissions and a page:
   POOL_B_REQUESTS 384-token prompts at once, preemptions >= 1, spilled =
   restored. Streams equal the tp=1 references or leave them at near-ties
   (`fleet_compare`); launch counts exact on every rank (each follower its
   replica's, this process their sum). (c) the native layer on the host:
   the C++ CSV scanner over NATIVE_ROWS rows x 8 columns and the C++ BPE
   encoder over NATIVE_BYTES of prompts, each equal to its Python pass,
   which a process of this file (`--native-python DIR`) runs beside (a)-(b).
   Prints export p50, blob bytes, the handoff gap p50, both times of each
   native pass, and a `{"pool_mesh": ...}` line before the kernels line.
22. Sequence parallelism past the contiguous cache (`sp_serve`), after
   phase 21: the 7B at full width, SP_LAYERS deep, this process rank 0
   and one `--sp-rank 1` follower on cuda:0 over gloo: rows 4-7 at an sp
   rank's shapes, the entry point's paged engine backends, a contiguous
   and a paged scheduler, and a scheduler rank 0 builds alone, each beside
   its sp = 1 control; an `{"sp": ...}` line before the kernels line.
23. The warmup (`warmup_serve`), after phase 22, on the 7B at full width,
   FLEET_LAYERS deep. (a) Cold start: two fresh processes of this file
   (`--warm-child cold|warm`, the kernel libraries already built), each
   the app's default scheduler (contiguous, WARM_SLOTS slots) over the
   seed-0 tree: two SQL prompts of one length that share no leading block,
   served in turn; the second process first calls `warmup(len(prompt))`.
   Each prints TTFT 1, TTFT 2 and the excess (TTFT 1 - TTFT 2), the second
   the warmup's seconds; WARM_ROUNDS such pairs, since one TTFT moves by
   a decode round with the host. The streams must be equal or near-ties
   (`fleet_compare`); the warmed processes' median excess is held to
   max(20 ms, 10% of their median TTFT 2) and reported. (b) State neutrality: a contiguous bf16, a paged int8
   and a paged speculative (D = SPEC_DRAFT) scheduler, each serving two
   requests, then warmed: every cache position below the park position (a
   pool: every page and the tables), the slot state, the counters, the
   allocator's counts, the perf ledger and the flight ring must be
   unchanged; then a burst of six, its streams held to an unwarmed twin's;
   launch counts exact, the warmup's included (`expect_warmup`). (c) A
   pool rebuild warms the fresh replica before its start(), timed; beside
   it the restart seconds of phases 10 (c) and 16, whose rebuilds warm
   now. An `{"warmup": ...}` line before the kernels line.

Every phase prints its seconds.

Prints a `{"kernels": [...]}` line, then as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero, printing no result, without CUDA or without the package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
TOL = {"bfloat16": 3e-2, "float32": 1e-4}  # kernel vs plain, max abs error
# bf16: outputs are rounded to bf16 (1 ulp = 1.6e-2 at |x| in [2, 4]) and
# probabilities are rounded at a different running max than the plain
# version's global max. f32: only the order of the f32 sums differs.
# bf16 query windows (T > 1) are also held per query row (b, t, head): the
# largest |kernel - plain| over the row's H outputs over its largest
# |plain|. A row that sees ~4096 keys has outputs of RMS ~0.026, so TOL
# alone misses a 64-slot tile of keys left out (~2e-2 at the max); that
# fault reads 0.2-0.4 per row (the WINDOW_CONTROLS below), where one bf16
# ulp of a row's largest output is at most 2**-7 of it.
WINDOW_ROW_TOL = 5e-2
# Window cases whose control drops the longest row's middle tile from the
# plain version's inputs and must come out above WINDOW_ROW_TOL.
WINDOW_CONTROLS = ("7b_chunks_all_4096", "7b_mixed_t32")
LOGIT_TOL = 5e-2  # 7B bf16 logits, kernel vs plain path, over max |logit|
F32_LOGIT_TOL = 1e-4  # the same for 2 layers of 7B in f32
# int4 matmul vs plain, max |diff| over max |out|: only the order of the f32
# sums differs; bf16 outputs are rounded to bf16 (one ulp is up to 2**-7 of
# the largest output), f32 sums of up to 11008 products drift by ~1e-6.
INT4_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
PKG = "llm_based_apache_spark_optimization_tpu_torch"
REF = "llm_based_apache_spark_optimization_tpu/ops/pallas"
SOURCES = {
    "prefill": f"{PKG}/csrc/flash_prefill.cuh",  # bf16; built by flash_gqa_attention.cu
    # Every decode launch (T == 1) runs the split-KV kernel of
    # decode_split.cuh, built by the four attention sources; the bf16 paged
    # query windows (T > 1) run window_split.cuh, built by the two paged
    # sources (f32 windows: gqa_tile.cuh).
    "decode": f"{PKG}/csrc/decode_split.cuh",
    "paged": f"{PKG}/csrc/decode_split.cuh",
    "paged_window": f"{PKG}/csrc/window_split.cuh",
    # Both page writes run the kernel of page_write.cuh, built by
    # fused_page_write.cu and fused_page_write_quantized.cu.
    "write": f"{PKG}/csrc/page_write.cuh",
    "decode_q": f"{PKG}/csrc/decode_split.cuh",
    "paged_q": f"{PKG}/csrc/decode_split.cuh",
    "paged_q_window": f"{PKG}/csrc/window_split.cuh",
    "write_q": f"{PKG}/csrc/page_write.cuh",
    "int4": f"{PKG}/csrc/int4_matmul.cu",
    "int8": f"{PKG}/csrc/int8_matmul.cu",
}
REPLACES = {
    "prefill": f"{REF}/attention.py:428",
    "decode": f"{REF}/attention.py:313",
    "paged": f"{REF}/paged_attention.py:225",
    "paged_window": f"{REF}/paged_attention.py:225",
    "write": f"{REF}/paged_write.py:191",
    # The quantized twins share their pallas_call lines with rows 2 and 4
    # (attention.py:313, paged_attention.py:225): their wrappers name them.
    "decode_q": f"{REF}/attention.py:453",
    "paged_q": f"{REF}/paged_attention.py:304",
    "paged_q_window": f"{REF}/paged_attention.py:304",
    "write_q": f"{REF}/paged_write.py:249",
    "int4": f"{REF}/int4mm.py:171",
    # No Pallas kernel: the JAX package leaves the int8 product to XLA.
    "int8": "none (XLA's dot_general, llm_based_apache_spark_optimization_tpu/ops/"
            "quant.py:294, and the unembed einsum, models/llama.py:626)",
}


_PHASE = {"name": None, "t0": 0.0, "seconds": {}}


def phase(name):
    """Start phase `name`, printing the seconds the previous one took."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        dt = now - _PHASE["t0"]
        _PHASE["seconds"][_PHASE["name"]] = round(dt, 1)
        print(f"  ({_PHASE['name']}: {dt:.1f} s)", flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
        print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs


def cuda_versions(build) -> str:
    """cudaRuntimeGetVersion of the toolkit that builds the kernels (nvcc
    links its runtime into each library) and cudaDriverGetVersion, e.g.
    12080 for 12.8: a CUDA graph captures a programmatic dependent launch
    from 12.3 on."""
    import ctypes

    lib = ctypes.CDLL(os.path.join(os.path.dirname(os.path.dirname(build.nvcc())),
                                   "lib64", "libcudart.so"))
    out = []
    for name in ("cudaRuntimeGetVersion", "cudaDriverGetVersion"):
        v = ctypes.c_int(0)
        err = getattr(lib, name)(ctypes.byref(v))
        out.append(f"{name} {v.value if err == 0 else f'error {err}'}")
    return ", ".join(out)


def make_case(torch, dtype, b, t, n, kh, h, s, positions, kv_lens=None,
              window=None, nan_dead=False):
    """q, k, v from a seeded generator on the card; NaN planted in the K/V
    slots at or past the live length (kv_lens, or by default max(position)
    + 1) when `nan_dead`."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, t, n, h), generator=g, device=dev).to(dtype)
    k = torch.randn((b, kh, s, h), generator=g, device=dev).to(dtype)
    v = torch.randn((b, kh, s, h), generator=g, device=dev).to(dtype)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    lens = None if kv_lens is None else torch.tensor(kv_lens, dtype=torch.int32,
                                                     device=dev)
    if nan_dead:
        live = pos.max(dim=1).values + 1 if lens is None else lens
        dead = torch.arange(s, device=dev)[None, :] >= live[:, None]  # [B, S]
        k[dead[:, None, :, None].expand_as(k)] = float("nan")
        v[dead[:, None, :, None].expand_as(v)] = float("nan")
    return dict(q=q, k=k, v=v, pos=pos, kv_lens=lens, window=window)


def cases():
    """(launch, name, kwargs) at the shapes listed in the module docstring."""
    def run(b, t, starts):
        return [[st + i for i in range(t)] for st in starts]

    out = [
        ("prefill", "7b_prompt", dict(b=1, t=384, n=32, kh=32, h=128, s=448,
                                      positions=run(1, 384, [0]))),
        ("prefill", "3b_prompt", dict(b=1, t=256, n=24, kh=8, h=128, s=320,
                                      positions=run(1, 256, [0]))),
        ("prefill", "1b_chunk_ragged", dict(b=2, t=128, n=32, kh=8, h=64, s=200,
                                            positions=run(2, 128, [0, 72]))),
        ("prefill", "mistral_window", dict(b=1, t=256, n=32, kh=8, h=128, s=8192,
                                           positions=run(1, 256, [7900]),
                                           window=4096)),
        ("prefill", "kvlens0_nan", dict(b=3, t=64, n=24, kh=8, h=128, s=264,
                                        positions=run(3, 64, [0, 60, 200]),
                                        kv_lens=[0, 100, 264], nan_dead=True)),
        # Chunks of no multiple of 64 rows over S = 1024: G = 3 (3B) and
        # G = 4 at H = 64 (1B), ragged starts, a window, kv_lens = 0 and
        # NaN past each row's live length.
        ("prefill", "3b_t100_window", dict(b=3, t=100, n=24, kh=8, h=128, s=1024,
                                           positions=run(3, 100, [0, 208, 924]),
                                           kv_lens=[0, 308, 1024], window=96,
                                           nan_dead=True)),
        ("prefill", "1b_t37_window", dict(b=3, t=37, n=32, kh=8, h=64, s=1024,
                                          positions=run(3, 37, [0, 500, 987]),
                                          kv_lens=[0, 537, 1024], window=40,
                                          nan_dead=True)),
    ]
    # The scheduler's chunked prefill: groups of k same-bucket chunks over
    # row views of S = 16 pages x 64 = 1024 slots, kv_lens left to default
    # (max position + 1), chunk starts at multiples of 128 and after prefix
    # reuse at 16-token blocks that end mid-page (208, 336, 400, ...), a
    # 128-token bucket and short final buckets; NaN past the live length
    # stands in for the other pages' stale data the row view holds there.
    for model, n, kh in (("7b", 32, 32), ("3b", 24, 8)):
        for b, t, starts in ((8, 128, [0, 128, 256, 0, 208, 336, 464, 896]),
                             (6, 32, [384, 400, 208, 432, 496, 992]),
                             (7, 16, [512, 528, 208, 624, 880, 1008, 0])):
            out.append(("prefill", f"{model}_sched_b{b}_t{t}",
                        dict(b=b, t=t, n=n, kh=kh, h=128, s=1024,
                             positions=run(b, t, starts), nan_dead=True)))
    # The paged chunk at the paged schedulers' default max_seq: one layer's
    # view of 4096 (7B) or 8192 (3B) positions, the 128-token bucket, rows
    # ending at the view's end, mid-view and near its start.
    for model, n, kh, s in (("7b", 32, 32, 4096), ("3b", 24, 8, 8192)):
        starts = [0, 128, 208, s // 2 + 16, 1024, s - 128, s - 240, s // 4 + 336]
        out.append(("prefill", f"{model}_paged_b8_t128_s{s}",
                    dict(b=8, t=128, n=n, kh=kh, h=128, s=s,
                         positions=run(8, 128, starts), nan_dead=True)))
    out += [
        ("decode", "7b_one", dict(b=1, t=1, n=32, kh=32, h=128, s=448,
                                  positions=[[300]])),
        ("decode", "7b_batch4", dict(b=4, t=1, n=32, kh=32, h=128, s=448,
                                     positions=[[130], [200], [260], [383]])),
        ("decode", "3b_one", dict(b=1, t=1, n=24, kh=8, h=128, s=320,
                                  positions=[[200]])),
        ("decode", "1b_batch8", dict(b=8, t=1, n=32, kh=8, h=64, s=1000,
                                     positions=[[p] for p in
                                                (0, 63, 64, 65, 500, 777, 998, 999)])),
        ("decode", "mistral_window", dict(b=2, t=1, n=32, kh=8, h=128, s=8192,
                                          positions=[[8000], [5000]],
                                          window=4096)),
        ("decode", "kvlens0_nan", dict(b=3, t=1, n=24, kh=8, h=128, s=264,
                                       positions=[[50], [120], [263]],
                                       kv_lens=[0, 100, 264], nan_dead=True)),
    ]
    # The contiguous scheduler's decode: 8 slots over the whole cache (7B:
    # 4096, 3B: 8192), six live rows and two parked (position max_seq - 1,
    # kv_lens 0), NaN in every dead slot.
    for model, n, kh, s in (("7b", 32, 32, 4096), ("3b", 24, 8, 8192)):
        live = [318, 357, 390, 412, 444, 1000]
        out.append(("decode", f"{model}_contig_b8", dict(
            b=8, t=1, n=n, kh=kh, h=128, s=s,
            positions=[[p - 1] for p in live] + [[s - 1], [s - 1]],
            kv_lens=live + [0, 0], nan_dead=True)))
    return out + spec_kernel_cases()


def check_kernels(torch, attn_mod, only=None):
    """Kernel vs plain on every case of `cases()` and, for the decode
    launch, of `decode_edge_cases()`, in each dtype; each decode case is
    launched twice and compared bit for bit. Returns the worst error per
    launch and dtype."""
    worst = {(l, d): 0.0 for l in ("prefill", "decode") for d in TOL}
    edges = [("decode", name, kw) for name, kw in decode_edge_cases()]
    for launch, name, kw in cases() + edges:
        if only is not None and name not in only:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            c = make_case(torch, dtype, **kw)
            args = (c["q"], c["k"], c["v"], c["pos"], c["window"], c["kv_lens"])
            out = attn_mod.flash_gqa_attention_cuda(*args)
            same = launch != "decode" or torch.equal(
                out, attn_mod.flash_gqa_attention_cuda(*args))
            ref = attn_mod.flash_gqa_attention_plain(*args)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"{launch}/{name}/{dname}: non-finite"
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= TOL[dname] and same
            twice = " bit-identical-twice=True" if launch == "decode" and same else ""
            print(f"  {launch:7s} {name:16s} {dname:8s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:.0e}{twice} {'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"{launch}/{name}/{dname}: {err} > {TOL[dname]} or not repeatable"
            if c["kv_lens"] is not None and (c["kv_lens"] == 0).any():
                zero_rows = out[c["kv_lens"] == 0]
                assert (zero_rows == 0).all(), "kv_lens=0 row is not exact zeros"
            worst[(launch, dname)] = max(worst[(launch, dname)], err)
    return worst


def paged_case(torch, dtype, b, t, n, kh, h, ps, np_tab, rows, window=None,
               dead_pos=None):
    """A ragged paged attention case on the card. `rows` gives per row
    (start, q_len, kv_len): live columns sit at start + i, dead columns at
    `dead_pos` (default the row's last position; the mixed round puts them
    one past the row). Pages are a random permutation of the pool; entries
    past a row's live pages are the sentinel; NaN is planted in every
    page no table maps, in the live rows' dead pages and in the dead
    offsets of each last live page."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    pool_pages = b * np_tab + 3
    q = torch.randn((b, t, n, h), generator=g, device=dev).to(dtype)
    kp = torch.randn((pool_pages, kh, ps, h), generator=g, device=dev).to(dtype)
    vp = torch.randn((pool_pages, kh, ps, h), generator=g, device=dev).to(dtype)
    perm = torch.randperm(pool_pages, generator=g, device=dev)
    tab = perm[: b * np_tab].reshape(b, np_tab).clone()
    pos = torch.full((b, t), np_tab * ps - 1 if dead_pos is None else dead_pos,
                     dtype=torch.int32, device=dev)
    live = torch.zeros(pool_pages, dtype=torch.bool, device=dev)
    for i, (start, ql, kvl) in enumerate(rows):
        pos[i, :ql] = start + torch.arange(ql, device=dev)
        n_live = -(-kvl // ps)
        tab[i, n_live:] = pool_pages  # sentinel past the live region
        live[tab[i, :n_live]] = True
        if kvl % ps:
            last = tab[i, n_live - 1]
            kp[last, :, kvl % ps:] = float("nan")
            vp[last, :, kvl % ps:] = float("nan")
    kp[~live] = float("nan")
    vp[~live] = float("nan")
    kv_lens = torch.tensor([r[2] for r in rows], dtype=torch.int32, device=dev)
    # T = 1 passes no q_lens, as a decode step does.
    q_lens = None if t == 1 else torch.tensor([r[1] for r in rows],
                                              dtype=torch.int32, device=dev)
    return (q, kp, vp, tab.int(), pos, window, kv_lens, q_lens)


def paged_cases():
    """(name, kwargs) of ragged paged attention cases: decode at the main
    paths' shapes, then ragged windows."""
    def decode_rows(s_virt):
        # The scheduler's 8 slots: live rows ending mid-page, on a page
        # boundary and at the row's end, and parked slots (an all-sentinel
        # table row at the last position, kv_lens = 0).
        return [(s_virt // 2 - 1, 1, s_virt // 2), (s_virt - 1, 1, 0),
                (s_virt - 1, 1, s_virt), (77, 1, 78), (255, 1, 256), (0, 1, 1),
                (s_virt - 1, 1, 0), (s_virt // 3, 1, s_virt // 3 + 1)]

    return [
        ("7b_decode_p64", dict(t=1, n=32, kh=32, h=128, ps=64, np_tab=16,
                               rows=decode_rows(1024))),
        ("3b_decode_p64", dict(t=1, n=24, kh=8, h=128, ps=64, np_tab=16,
                               rows=decode_rows(1024))),
        ("1b_decode_p16", dict(t=1, n=32, kh=8, h=64, ps=16, np_tab=24,
                               rows=decode_rows(384))),
        ("3b_window8_p16", dict(t=8, n=24, kh=8, h=128, ps=16, np_tab=20,
                                rows=[(100, 8, 108), (37, 3, 40), (0, 0, 0),
                                      (310, 5, 315)])),
        ("7b_window32_p64", dict(t=32, n=32, kh=32, h=128, ps=64, np_tab=8,
                                 rows=[(0, 32, 32), (400, 17, 417), (480, 32, 512)])),
        ("gt512_p16", dict(t=32, n=32, kh=2, h=64, ps=16, np_tab=16,
                           rows=[(200, 32, 232), (5, 20, 25)])),
        ("mistral_window", dict(t=1, n=32, kh=8, h=128, ps=64, np_tab=128,
                                rows=[(7999, 1, 8000), (4999, 1, 5000)],
                                window=4096)),
    ] + mixed_cases() + window_stress_cases() + spec_paged_cases()


def window_stress_cases():
    """Query windows that stress the window kernel's split: all 8 rows as
    32-token chunks ending at 4096 (every cluster rank busy); a window of
    4096 over rows of 8192 (the live range starts mid-row, and a chunk's
    rows see different first slots); pages of 16, a 64-slot tile across
    four pages, rows ending mid-page with sentinel pages in the last live
    tile's dead tail; and 1B's head dim 64 over pages of 8 and 16 (1, 3 and
    4 row groups of 16 folded rows). NaN sits in
    every unmapped page and dead offset (`paged_case`), and in the int8
    pools' dead scales."""
    return [
        ("7b_chunks_all_4096", dict(t=32, n=32, kh=32, h=128, ps=64, np_tab=64,
                                    rows=[(4064, 32, 4096)] * 8, dead_pos=4096)),
        ("3b_w4096_s8192", dict(t=32, n=24, kh=8, h=128, ps=64, np_tab=128,
                                rows=[(8160, 32, 8192), (8191, 1, 8192), (5000, 32, 5032),
                                      (4100, 17, 4117), (100, 32, 132), (0, 0, 0),
                                      (4095, 1, 4096), (6000, 9, 6009)],
                                window=4096, dead_pos=8192)),
        ("7b_p16_t32", dict(t=32, n=32, kh=32, h=128, ps=16, np_tab=64,
                            rows=[(936, 32, 968), (1023, 1, 1024), (0, 32, 32),
                                  (500, 5, 505), (961, 1, 962), (0, 0, 0),
                                  (700, 32, 732), (40, 1, 41)], dead_pos=1024)),
        ("1b_p8_t16", dict(t=16, n=32, kh=8, h=64, ps=8, np_tab=64,
                           rows=[(496, 16, 512), (300, 7, 307), (0, 1, 1), (0, 0, 0)],
                           dead_pos=512)),
        # 1B windows of 4 and 12 columns: 16 and 48 folded rows (1 and 3
        # row groups) at H = 64.
        ("1b_p16_t4", dict(t=4, n=32, kh=8, h=64, ps=16, np_tab=32,
                           rows=[(508, 4, 512), (200, 2, 202), (0, 0, 0), (63, 1, 64)],
                           dead_pos=512)),
        ("1b_p16_t12", dict(t=12, n=32, kh=8, h=64, ps=16, np_tab=32,
                            rows=[(500, 12, 512), (90, 5, 95), (0, 0, 0), (511, 1, 512)],
                            dead_pos=512)),
    ]


def mixed_rows(t, s_virt):
    """(start, q_len, kv_len) of the 8 slots of a ragged mixed round (`t`
    columns, rows of `s_virt` positions): two prefill rows carrying a
    whole chunk (one mid-row, one ending at the row's end), four decode
    rows at q_len 1 (mid-page, page boundary, one live slot, the row's last
    slot) and two parked rows (all-sentinel tables, kv_lens 0)."""
    return [(192, t, 192 + t), (s_virt - 1, 1, 0), (777, 1, 778), (s_virt - t, t, s_virt),
            (255, 1, 256), (0, 1, 1), (s_virt - 1, 1, 0), (s_virt - 1, 1, s_virt)]


def row_rel_err(out, ref):
    """Largest over query rows (the last axis is H) of max |out - ref| over
    the row's max |ref|; a row whose reference is all zeros counts its
    absolute error."""
    d = (out.float() - ref.float()).abs().amax(-1)
    s = ref.float().abs().amax(-1)
    return (d / s.clamp_min(1e-30)).where(s > 0, d).max().item()


def drop_tile(torch, tab, pos, kv_lens, ps, sentinel):
    """(table, positions, kv_lens, row) of a planted fault: the longest
    row's middle 64-slot tile left out, its pages cut from the table and
    the later ones shifted down, the row's positions and kv_lens one tile
    less, so the row sees every key but that tile's."""
    row = int(kv_lens.argmax())
    per = max(1, 64 // ps)
    j = int(kv_lens[row]) // ps // 2 // per * per
    tab, pos, kv_lens = tab.clone(), pos.clone(), kv_lens.clone()
    tab[row] = torch.cat([tab[row, :j], tab[row, j + per:], tab.new_full((per,), sentinel)])
    pos[row] -= per * ps
    kv_lens[row] -= per * ps
    return tab, pos, kv_lens, row


def window_control(torch, plain, args, ti, ref, label):
    """The planted fault against the per-row limit: `plain` over `args`
    (table, positions and kv_lens at ti, ti + 1 and ti + 3; the K pool at
    1) with `drop_tile`'s tile left out, compared with `ref` on that row.
    Fails unless the limit catches it."""
    args = list(args)
    sentinel, ps = args[1].shape[0], args[1].shape[2]
    args[ti], args[ti + 1], args[ti + 3], row = drop_tile(
        torch, args[ti], args[ti + 1], args[ti + 3], ps, sentinel)
    fault = plain(*args)[row]
    err = (fault.float() - ref[row].float()).abs().max().item()
    rel = row_rel_err(fault, ref[row])
    caught = rel > WINDOW_ROW_TOL
    print(f"  {label} control: row {row} without its middle tile "
          f"max_abs_err={err:.3e} (tol {TOL['bfloat16']:.0e}) max_row_rel_err={rel:.3e} "
          f"(tol {WINDOW_ROW_TOL:.0e}) {'FAIL as planted' if caught else 'NOT CAUGHT'}",
          flush=True)
    assert caught, f"{label}: a dropped tile passes the per-row limit"


def mixed_cases():
    """The ragged mixed round's windows at the paged schedulers' default
    max_seq (7B: 4096, tables of 64 pages; 3B: 8192, 128 pages; pages of
    64): B = 8, T = 32 and 16, q_lens mixing 1 with T, dead columns one
    past the row as the round places them."""
    return [
        (f"{m}_mixed_t{t}", dict(t=t, n=n, kh=kh, h=128, ps=64, np_tab=np_tab,
                                 rows=mixed_rows(t, np_tab * 64), dead_pos=np_tab * 64))
        for m, n, kh, np_tab in (("7b", 32, 32, 64), ("3b", 24, 8, 128))
        for t in (32, 16)
    ]


def check_paged(torch, pa_mod, only=None):
    """Ragged paged attention kernel vs plain on every case of
    `paged_cases()` and `paged_edge_cases()` and each dtype; each case (the
    split-KV kernel at T = 1, the window kernel or, in f32, the tile kernel
    at T > 1) is launched twice and compared bit for bit; bf16 windows are
    also held per query row (WINDOW_ROW_TOL), and on WINDOW_CONTROLS a
    planted fault must fail that limit. Returns the worst error per launch
    ("paged": T = 1; "paged_window": bf16 T > 1, with "_rel" its worst per
    row error; "paged_window_tile": f32 T > 1, the tile kernel) and
    dtype."""
    worst = {"paged": {d: 0.0 for d in TOL}, "paged_window": {"bfloat16": 0.0},
             "paged_window_rel": {"bfloat16": 0.0}, "paged_window_tile": {"float32": 0.0}}
    for name, kw in paged_cases() + paged_edge_cases():
        if only is not None and name not in only:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            args = paged_case(torch, dtype, b=len(kw["rows"]), **kw)
            out = pa_mod.ragged_paged_attention_cuda(*args)
            again = pa_mod.ragged_paged_attention_cuda(*args)
            ref = pa_mod.ragged_paged_attention_plain(*args)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"paged/{name}/{dname}: non-finite"
            err = (out.float() - ref.float()).abs().max().item()
            same = torch.equal(out, again)
            window = kw["t"] > 1 and dtype == torch.bfloat16
            rel = row_rel_err(out, ref) if window else 0.0
            ok = err <= TOL[dname] and same and rel <= WINDOW_ROW_TOL
            by_row = f" max_row_rel_err={rel:.3e} tol={WINDOW_ROW_TOL:.0e}" if window else ""
            print(f"  paged   {name:16s} {dname:8s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:.0e}{by_row} bit-identical-twice={same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"paged/{name}/{dname}: {err} or {rel} over its limit or not repeatable"
            for i, (_, ql, kvl) in enumerate(kw["rows"]):
                dead = out[i] if kvl == 0 else out[i, ql:]
                assert (dead == 0).all(), f"paged/{name}: row {i} not exact zeros"
            if window and name in WINDOW_CONTROLS:
                window_control(torch, pa_mod.ragged_paged_attention_plain, args, 3, ref,
                               f"paged   {name}")
            launch = ("paged" if kw["t"] == 1 else
                      "paged_window" if window else "paged_window_tile")
            worst[launch][dname] = max(worst[launch][dname], err)
            if window:
                worst[launch + "_rel"][dname] = max(worst[launch + "_rel"][dname], rel)
    return worst


# Page-write cases of phase 3: (name, layers, kv heads, head dim, page size,
# B, T, table pages, pool pages). The 7B and 3B schedulers' decode rounds
# (T = 1 at B = 8, two slots parked behind all-sentinel rows) at their
# last layer; 1B's H = 64; windows of 4 with q_lens, a parked row and a
# past-the-row position; and a 7B round in which every sliver drops
# (negative, past the row, sentinel, q_lens = 0), which must write nothing.
WRITE_CASES = [("7b_t1_b8", 32, 32, 128, 64, 8, 1, 16, 128),
               ("3b_t1_b8", 28, 8, 128, 64, 8, 1, 16, 128),
               ("1b_t1_b8_h64", 16, 8, 64, 64, 8, 1, 16, 128),
               ("3b_t4_qlens", 28, 8, 128, 16, 4, 4, 16, 66),
               ("7b_all_dropped", 32, 32, 128, 64, 8, 1, 16, 128),
               # The ragged mixed round at the default max_seq (two layers
               # of the pool: the kernel's work does not depend on depth).
               ("7b_mixed_t32", 2, 32, 128, 64, 8, 32, 64, 515),
               ("7b_mixed_t16", 2, 32, 128, 64, 8, 16, 64, 515),
               ("3b_mixed_t32", 2, 8, 128, 64, 8, 32, 128, 1027),
               ("3b_mixed_t16", 2, 8, 128, 64, 8, 16, 128, 1027),
               # The paged prefill chunk's write-back at the default
               # max_seq: B = 8, the 128-token bucket, no q_lens.
               ("7b_chunk_t128", 2, 32, 128, 64, 8, 128, 64, 515),
               ("3b_chunk_t128", 2, 8, 128, 64, 8, 128, 128, 1027),
               # A speculative verify round (D = 8): six live windows of 9,
               # a mid-prefill slot (its table mapped) and a free one, both
               # at q_len 0 from the parking position.
               ("7b_verify_t9", 2, 32, 128, 64, 8, 9, 64, 515),
               ("3b_verify_t9", 2, 8, 128, 64, 8, 9, 128, 1027)]


def chunk_rows(t, s_virt, ps):
    """(start, mapped pages) of the 8 rows of a paged prefill chunk of `t`
    tokens over rows of `s_virt` positions: starts at multiples of the
    bucket and after prefix reuse (mid-page), envelopes ending on, before
    and past the window's end, the last row's window running past the
    row."""
    return [(0, 2), (t, -(-(2 * t) // ps)), (208, -(-(208 + 50) // ps)),
            (s_virt // 2 + 16, -(-(s_virt // 2 + 16 + t) // ps) + 1),
            (1024, -(-(1024 + 40) // ps)), (s_virt - t, s_virt // ps),
            (s_virt - 2 * t + 16, s_virt // ps), (s_virt - t + 48, s_virt // ps)]


def write_case(torch, name, kh, h, ps, b, t, np_tab, pages, dtype, g):
    """(k_new, v_new, positions, table, q_lens) of one WRITE_CASES entry,
    every kept sliver on its own (page, offset)."""
    dev = "cuda"
    k_new = torch.randn((b, t, kh, h), generator=g, device=dev).to(dtype)
    v_new = torch.randn((b, t, kh, h), generator=g, device=dev).to(dtype)
    tab = torch.randperm(pages, generator=g, device=dev)[: b * np_tab]
    tab = tab.reshape(b, np_tab).int()
    starts = torch.randint(0, np_tab * ps - t, (b, 1), generator=g, device=dev)
    pos = (starts + torch.arange(t, device=dev)).int()
    q_lens = None
    if "verify" in name:
        rows = spec_rows(np_tab * ps, 0)
        for i, (start, ql, _) in enumerate(rows):
            pos[i] = start + torch.arange(t, device=dev)
        tab[7] = pages  # the free slot: all sentinel
        q_lens = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    elif "mixed" in name:
        # The mixed round's write: prefill rows write their whole chunk,
        # decode rows column 0 (their dead columns one past the row), two
        # parked rows behind all-sentinel tables.
        rows = mixed_rows(t, np_tab * ps)
        for i, (start, ql, kvl) in enumerate(rows):
            pos[i] = np_tab * ps
            pos[i, :ql] = start + torch.arange(ql, device=dev)
            if kvl == 0:
                tab[i] = pages
        q_lens = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    elif "chunk" in name:
        # The paged prefill chunk's write-back (`forward(span=...)`): every
        # row writes its whole window, no q_lens; the table maps each row's
        # pages up to its envelope's end, sentinel past it, so the columns
        # past the mapped pages drop (a final chunk's bucket past its
        # envelope), as do those past the row (the last row).
        s_virt = np_tab * ps
        for i, (start, mapped) in enumerate(chunk_rows(t, s_virt, ps)):
            pos[i] = start + torch.arange(t, device=dev)
            tab[i, mapped:] = pages
    elif t > 1:
        tab[1] = pages           # a parked row: all sentinel
        pos[2, -1] = np_tab * ps  # past the row: dropped
        q_lens = torch.tensor([t, 1, t, 2], dtype=torch.int32, device=dev)
    elif name.endswith("all_dropped"):
        pos[0:2] = -1
        pos[2:4] = np_tab * ps
        tab[4:6] = pages
        q_lens = torch.tensor([1] * 6 + [0] * (b - 6), dtype=torch.int32, device=dev)
    else:
        for i in (2, 6):         # parked slots, as a decode round has
            tab[i] = pages
            pos[i] = np_tab * ps - 1
    return k_new, v_new, pos, tab, q_lens


def check_write(torch, pw_mod, only=None):
    """Page write kernel into a bf16 or f32 pool vs plain, bit for bit, at
    every WRITE_CASES entry; the all-dropped round must leave the pools as
    they were, every other case must write."""
    dev = "cuda"
    worst = {d: 0.0 for d in TOL}
    for name, n_layers, kh, h, ps, b, t, np_tab, pages in WRITE_CASES:
        if only is not None and name not in only:
            continue
        layer = n_layers - 1
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(3)
            shape = (n_layers, pages, kh, ps, h)
            kk = torch.randn(shape, generator=g, device=dev, dtype=dtype)
            vk = torch.randn(shape, generator=g, device=dev, dtype=dtype)
            kr, vr, before = kk.clone(), vk.clone(), kk[layer].clone()
            k_new, v_new, pos, tab, q_lens = write_case(
                torch, name, kh, h, ps, b, t, np_tab, pages, dtype, g)
            pw_mod.fused_page_write_cuda(kk, vk, k_new, v_new, pos, tab, layer,
                                         q_lens)
            pw_mod.fused_page_write_plain(kr, vr, k_new, v_new, pos, tab, layer,
                                          q_lens)
            torch.cuda.synchronize()
            same = torch.equal(kk, kr) and torch.equal(vk, vr)
            wrote = not torch.equal(kk[layer], before)
            dname = str(dtype).split(".")[1]
            # The error over the written layer; torch.equal covered the rest.
            err = max((kk[layer].float() - kr[layer].float()).abs().max().item(),
                      (vk[layer].float() - vr[layer].float()).abs().max().item())
            del kk, vk, kr, vr, before
            print(f"  write   {name:16s} {dname:8s} max_abs_err={err:.3e} "
                  f"bit-exact={same} wrote={wrote}", flush=True)
            assert same and wrote != name.endswith("all_dropped"), \
                f"write/{name}: kernel != plain"
            worst[dname] = max(worst[dname], err)
    return worst


def quantize(torch, x):
    """(int8 values, f32 scales) of K/V [..., H], the port's quantize_kv:
    NaN planted in x comes out as NaN scales (and junk values) there."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_kv

    q = quantize_kv(x)
    return q["q8"], q["s"]


def decode_edge_cases():
    """(name, kwargs) of decode cases at the split-KV kernel's edges, G = 1,
    3, 4 and 16 at H = 128 and 64 over S = 1000: live lengths of 1 and 7
    slots (fewer than the splits), kv_lens = 0 beside a full row, NaN in
    every dead slot, and with a window of 3 that hides all but each row's
    last 3 slots (whole splits empty)."""
    out = []
    for g, n, kh in ((1, 32, 32), (3, 24, 8), (4, 32, 8), (16, 32, 2)):
        for h in (128, 64):
            for window in (None, 3):
                out.append((f"g{g}_h{h}_w{window or 0}",
                            dict(b=4, t=1, n=n, kh=kh, h=h, s=1000,
                                 positions=[[0], [6], [500], [999]],
                                 kv_lens=[1, 7, 0, 1000], window=window,
                                 nan_dead=True)))
    return out


def check_kernels_quantized(torch, attn_mod):
    """The quantized decode attention kernel vs plain on the decode cases of
    `cases()` and `decode_edge_cases()` over an int8 cache (NaN planted in
    the dead slots' scales), each launched twice and compared bit for bit;
    returns the worst error per dtype."""
    worst = {d: 0.0 for d in TOL}
    todo = [(name, kw) for launch, name, kw in cases() if launch == "decode"]
    for name, kw in todo + decode_edge_cases():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            c = make_case(torch, dtype, **kw)
            k8, ks = quantize(torch, c["k"])
            v8, vs = quantize(torch, c["v"])
            args = (c["q"], k8, ks, v8, vs, c["pos"], c["window"], c["kv_lens"])
            out = attn_mod.flash_gqa_attention_quantized_cuda(*args)
            again = attn_mod.flash_gqa_attention_quantized_cuda(*args)
            ref = attn_mod.flash_gqa_attention_quantized_plain(*args)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"decode_q/{name}/{dname}: non-finite"
            err = (out.float() - ref.float()).abs().max().item()
            same = torch.equal(out, again)
            ok = err <= TOL[dname] and same
            print(f"  decode_q {name:15s} {dname:8s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:.0e} bit-identical-twice={same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"decode_q/{name}/{dname}: {err} > {TOL[dname]} or not repeatable"
            if c["kv_lens"] is not None and (c["kv_lens"] == 0).any():
                assert (out[c["kv_lens"] == 0] == 0).all(), "kv_lens=0 row is not zeros"
            worst[dname] = max(worst[dname], err)
    return worst


def paged_edge_cases():
    """(name, kwargs) of T = 1 paged cases at the split-KV kernel's edges,
    G = 1, 3, 4 and 16, H = 128 over pages of 64 and H = 64 over pages of 16:
    rows of 1 and 7 live slots, a parked row (all sentinel, kv_lens = 0)
    beside a full row, with and without a window of 3."""
    out = []
    for g, n, kh in ((1, 32, 32), (3, 24, 8), (4, 32, 8), (16, 32, 2)):
        for h, ps, np_tab in ((128, 64, 16), (64, 16, 24)):
            s_virt = ps * np_tab
            for window in (None, 3):
                out.append((f"g{g}_h{h}_w{window or 0}",
                            dict(t=1, n=n, kh=kh, h=h, ps=ps, np_tab=np_tab,
                                 rows=[(0, 1, 1), (6, 1, 7), (s_virt - 1, 1, 0),
                                       (s_virt - 1, 1, s_virt)], window=window)))
    return out


def check_paged_quantized(torch, pa_mod, only=None):
    """The quantized ragged paged attention kernel vs plain on every paged
    case and on `paged_edge_cases()`, the pools quantized after the NaN was
    planted (so the dead offsets and unmapped pages carry NaN scales), each
    launched twice and compared bit for bit, bf16 windows also per query
    row with a planted-fault control, as in `check_paged`; returns the
    worst error per launch ("paged_q", "paged_q_window", "_rel",
    "paged_q_window_tile") and dtype."""
    worst = {"paged_q": {d: 0.0 for d in TOL}, "paged_q_window": {"bfloat16": 0.0},
             "paged_q_window_rel": {"bfloat16": 0.0},
             "paged_q_window_tile": {"float32": 0.0}}
    for name, kw in paged_cases() + paged_edge_cases():
        if only is not None and name not in only:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q, kp, vp, tab, pos, window, kvl, qln = paged_case(
                torch, dtype, b=len(kw["rows"]), **kw)
            kp8, kps = quantize(torch, kp)
            vp8, vps = quantize(torch, vp)
            del kp, vp
            args = (q, kp8, kps, vp8, vps, tab, pos, window, kvl, qln)
            out = pa_mod.ragged_paged_attention_quantized_cuda(*args)
            again = pa_mod.ragged_paged_attention_quantized_cuda(*args)
            ref = pa_mod.ragged_paged_attention_quantized_plain(*args)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"paged_q/{name}/{dname}: non-finite"
            err = (out.float() - ref.float()).abs().max().item()
            same = torch.equal(out, again)
            window = kw["t"] > 1 and dtype == torch.bfloat16
            rel = row_rel_err(out, ref) if window else 0.0
            ok = err <= TOL[dname] and same and rel <= WINDOW_ROW_TOL
            by_row = f" max_row_rel_err={rel:.3e} tol={WINDOW_ROW_TOL:.0e}" if window else ""
            print(f"  paged_q {name:16s} {dname:8s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:.0e}{by_row} bit-identical-twice={same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"paged_q/{name}/{dname}: {err} or {rel} over its limit or not repeatable"
            for i, (_, ql, kvl_i) in enumerate(kw["rows"]):
                dead = out[i] if kvl_i == 0 else out[i, ql:]
                assert (dead == 0).all(), f"paged_q/{name}: row {i} not exact zeros"
            if window and name in WINDOW_CONTROLS:
                window_control(torch, pa_mod.ragged_paged_attention_quantized_plain, args,
                               5, ref, f"paged_q {name}")
            launch = ("paged_q" if kw["t"] == 1 else
                      "paged_q_window" if window else "paged_q_window_tile")
            worst[launch][dname] = max(worst[launch][dname], err)
            if window:
                worst[launch + "_rel"][dname] = max(worst[launch + "_rel"][dname], rel)
    return worst


def check_write_quantized(torch, pw_mod, only=None):
    """The page write kernel into an int8 pool vs plain, bit for bit in
    values and scales, at every WRITE_CASES entry (bf16 and f32 slivers; the
    all-dropped round writes nothing). Returns the worst error (0 when
    bit-exact) per dtype."""
    dev = "cuda"
    worst = {d: 0.0 for d in TOL}
    for name, n_layers, kh, h, ps, b, t, np_tab, pages in WRITE_CASES:
        if only is not None and name not in only:
            continue
        layer = n_layers - 1
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(3)
            shape = (n_layers, pages, kh, ps, h)
            pools = [torch.randint(-127, 128, shape, generator=g, device=dev,
                                   dtype=torch.int8),
                     torch.rand(shape[:4], generator=g, device=dev),
                     torch.randint(-127, 128, shape, generator=g, device=dev,
                                   dtype=torch.int8),
                     torch.rand(shape[:4], generator=g, device=dev)]
            refs = [x.clone() for x in pools]
            before = pools[0][layer].clone()
            k_new, v_new, pos, tab, q_lens = write_case(
                torch, name, kh, h, ps, b, t, np_tab, pages, dtype, g)
            pw_mod.fused_page_write_quantized_cuda(*pools, k_new, v_new, pos, tab, layer,
                                                   q_lens)
            pw_mod.fused_page_write_quantized_plain(*refs, k_new, v_new, pos, tab, layer,
                                                    q_lens)
            torch.cuda.synchronize()
            same = all(torch.equal(a, r) for a, r in zip(pools, refs))
            wrote = not torch.equal(pools[0][layer], before)
            dname = str(dtype).split(".")[1]
            err = max((a[layer].float() - r[layer].float()).abs().max().item()
                      for a, r in zip(pools, refs))
            del pools, refs, before
            print(f"  write_q {name:16s} {dname:8s} max_abs_err={err:.3e} "
                  f"bit-exact={same} wrote={wrote}", flush=True)
            assert same and wrote != name.endswith("all_dropped"), \
                f"write_q/{name}: kernel != plain"
            worst[dname] = max(worst[dname], err)
    return worst


# (model, weight, IN, OUT) of every 7B and 3B block matmul shape, and an
# edge: OUT = 400 is no multiple of a 128- or 256-column tile (group 86).
INT4_SHAPES = [("7b", "wq/wk/wv/wo", 4096, 4096), ("7b", "wg/wu", 4096, 11008),
               ("7b", "wd", 11008, 4096), ("3b", "wq/wo", 3072, 3072),
               ("3b", "wk/wv", 3072, 1024), ("3b", "wg/wu", 3072, 8192),
               ("3b", "wd", 8192, 3072), ("edge", "OUT 400", 688, 400)]
INT4_ROWS = (1, 4, 8, 9, 16, 72, 131, 384, 1024, 2048)


def check_int4(torch, mm_mod, only=None):
    """The int4 matmul kernel vs plain at every shape of INT4_SHAPES (the
    group `tp_safe_group` gives: 86 for 7B's wd and the edge, 128
    elsewhere) and R in INT4_ROWS, in bf16 (the decode kernel up to 8 rows,
    the prefill kernel above) and f32 (the rows kernel). Returns the worst
    (absolute, relative to max |out|) error per dtype."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_weight_int4,
        tp_safe_group,
    )

    dev = "cuda"
    worst = {d: [0.0, 0.0] for d in TOL}
    for model, name, n_in, n_out in INT4_SHAPES:
        g = torch.Generator(device=dev).manual_seed(5)
        group = tp_safe_group(n_in)
        w = quantize_weight_int4(
            torch.randn((n_in, n_out), generator=g, device=dev) * n_in ** -0.5, group)
        for rows in INT4_ROWS if only is None else [r for r in INT4_ROWS if r in only]:
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]
                x = torch.randn((rows, n_in), generator=g, device=dev).to(dtype)
                out = mm_mod.int4_matmul_cuda(x, w["q4"], w["s4"])
                ref = mm_mod.int4_matmul_plain(x, w["q4"], w["s4"])
                torch.cuda.synchronize()
                assert out.shape == ref.shape and out.dtype == ref.dtype
                assert torch.isfinite(out).all(), f"int4/{model} {name}: non-finite"
                err = (out.float() - ref.float()).abs().max().item()
                rel = err / ref.float().abs().max().item()
                ok = rel <= INT4_TOL[dname]
                print(f"  int4    {model:4s} {name:12s} group {group:3d} R={rows:5d} "
                      f"{dname:8s} max_abs_err={err:.3e} rel={rel:.3e} "
                      f"tol={INT4_TOL[dname]:.0e} {'ok' if ok else 'FAIL'}", flush=True)
                assert ok, f"int4/{model} {name} R={rows} {dname}: {rel}"
                worst[dname] = [max(worst[dname][0], err), max(worst[dname][1], rel)]
    return worst


# ------------------------------------------------------------- reference


def tree_to(tree, device):
    """A params tree (nested dicts of tensors) on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def small_reference(torch, quantized=False):
    """Greedy tokens of a 2-layer f32 model (H = 64, GQA) through the
    kernels on the card == through the plain versions on the CPU: the
    engine, the paged scheduler (8-token prefix blocks in 16-token pages,
    prompts that share a 41-token prefix: the cache hits, and copies the
    page where the match ends mid-page) and the contiguous scheduler (the
    same traffic: its block copies hit). `quantized`: int4 block
    weights (`quantize_params_int4`) and the int8 KV cache in both."""
    import dataclasses

    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.models import LLAMA32_1B
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_params_int4,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
    )

    cfg = dataclasses.replace(LLAMA32_1B, name="ref-small", vocab_size=512,
                              hidden_size=256, intermediate_size=512,
                              num_layers=2, num_heads=4, num_kv_heads=2,
                              head_dim=64, max_seq_len=512, bos_id=1,
                              eos_id=2, pad_id=0, extra_stop_ids=())
    gen = torch.Generator(device="cpu").manual_seed(7)
    cpu_params = init_params(cfg, gen, torch.float32, device="cpu")
    kv_quant = "int8" if quantized else None
    if quantized:
        cpu_params = quantize_params_int4(cpu_params)
    gpu_params = tree_to(cpu_params, "cuda")
    label = "int4 weights, int8 KV" if quantized else "f32"
    prompts = [[1, 17, 93, 5], [1, 40, 41], [1] + list(range(60, 130))]
    ref = InferenceEngine(cfg, cpu_params, device="cpu", kv_quant=kv_quant).generate(
        prompts, 24)
    got = InferenceEngine(cfg, gpu_params, device="cuda", kv_quant=kv_quant).generate(
        prompts, 24)
    print(f"  [{label}] engine cpu plain : {ref}\n  [{label}] engine cuda kern : {got}",
          flush=True)
    assert got == ref, f"[{label}] kernel path disagrees with the plain CPU reference"

    prefix = [1] + list(range(100, 140))
    sched_prompts = [prefix + [200 + i] for i in range(3)] + prompts
    for layout in ("paged", "contiguous"):
        outs = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            with ContinuousBatchingScheduler(
                    cfg, params, num_slots=4, decode_chunk=4, prompt_bucket=8,
                    stop_ids=(-1,), kv_layout=layout, kv_page_size=16,
                    kv_quant=kv_quant, device=dev) as s:
                seq = [s.submit(p, 16).result(timeout=600) for p in sched_prompts[:3]]
                futs = [s.submit(p, 16) for p in sched_prompts]
                outs[dev] = seq + [f.result(timeout=600) for f in futs]
                hits = s.prefix_stats["hits"]
                cow = s.page_stats["cow_copies"] if layout == "paged" else None
            print(f"  [{label}] {layout} scheduler {dev}: prefix hits {hits}, cow copies "
                  f"{cow}: {outs[dev]}", flush=True)
        assert outs["cuda"] == outs["cpu"], (
            f"[{label}] {layout} scheduler on the card != on the CPU")
        assert hits > 0, f"[{label}] the small {layout} scheduler's prefix cache never hit"
        assert layout != "paged" or cow > 0, f"[{label}] no page was copied on write"
    small_variants(cfg, cpu_params, gpu_params, kv_quant, label, sched_prompts)


def small_variants(cfg, cpu_params, gpu_params, kv_quant, label, sched_prompts):
    """The small reference's ragged mixed rounds (the prefix-sharing
    traffic in 8-token chunks) and an overcommitted pool of 9 pages of 8
    under a `kv:pressure` storm withholding 3 (the settings of
    tests/test_paged_kv.py), resumed by recompute and by spill: greedy
    tokens on the card == on the CPU, and the storms preempt (spill: pages
    spilled == restored)."""
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    storm = [[1, 17, 93, 5], [1, 40, 41], [1, 7], [1, 3, 4, 8, 10]]
    pressure = dict(num_slots=2, max_seq=64, kv_page_size=8, kv_pages=9,
                    kv_overcommit=0.25)
    variants = {
        "ragged": (dict(num_slots=4, kv_page_size=16, ragged=True), sched_prompts, 16,
                   None),
        "overcommit recompute": (pressure, storm, 24, "kv:pressure:1:3"),
        "overcommit spill": (dict(pressure, kv_spill=True), storm, 24, "kv:pressure:1:3"),
    }
    for name, (kw, prompts, max_new, fault) in variants.items():
        outs, stats = {}, {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            if fault:
                FAULTS.configure(fault, 0)
            try:
                with ContinuousBatchingScheduler(
                        cfg, params, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
                        kv_layout="paged", kv_quant=kv_quant, device=dev, **kw) as s:
                    futs = [s.submit(p, max_new) for p in prompts]
                    outs[dev] = [f.result(timeout=600) for f in futs]
                    stats[dev] = dict(s.page_stats, mixed_rounds=s.mixed_rounds,
                                      ragged_prefills=s.ragged_prefills)
            finally:
                FAULTS.clear()
            st = stats[dev]
            print(f"  [{label}] {name} {dev}: mixed rounds {st['mixed_rounds']}, ragged "
                  f"prefills {st['ragged_prefills']}, "
                  f"preemptions {st['preemptions']}, spilled {st['spilled_pages']}, "
                  f"restored {st['restored_pages']}: {outs[dev]}", flush=True)
        assert outs["cuda"] == outs["cpu"], f"[{label}] {name}: the card != the CPU"
        for st in stats.values():
            if fault:
                assert st["preemptions"] >= 1, f"[{label}] {name}: no preemption"
                assert st["spilled_pages"] == st["restored_pages"]
                assert (st["spilled_pages"] > 0) == kw.get("kv_spill", False)
            else:
                assert st["mixed_rounds"] > 0, f"[{label}] {name}: no mixed round"


# ----------------------------------------------------------------- serve

SCHEMA_COLUMNS = [
    ("trip_id", "bigint"), ("pickup_datetime", "timestamp"),
    ("dropoff_datetime", "timestamp"), ("passenger_count", "int"),
    ("trip_distance", "double"), ("pickup_zone", "string"),
    ("dropoff_zone", "string"), ("payment_type", "string"),
    ("fare_amount", "double"), ("tip_amount", "double"),
    ("total_amount", "double"),
]
SCHEMA = "\n".join(f"{c} ({t})" for c, t in SCHEMA_COLUMNS)
# The grammars of the constrained phases: the generic Spark-SQL grammar and
# the prompts' own schema (table `trips`).
GRAMMAR_SPECS = {"generic": "spark_sql",
                 "schema": {"table": "trips", "columns": [c for c, _ in SCHEMA_COLUMNS]}}
SYSTEM_SQL = f"Table name is trips. The structure of the table is:\n{SCHEMA}"
QUESTIONS = [
    "What is the average fare amount for each passenger count?",
    "List the ten pickup zones with the highest total tips.",
    "How many trips paid by card were longer than 5 miles in March 2024?",
]
BATCH = [
    "Count the trips.",
    "What is the maximum trip distance?",
    "Show the average tip amount per payment type, sorted from highest to lowest.",
    "For each dropoff zone, give the number of trips and the mean total amount, "
    "keeping only zones with more than 100 trips, ordered by trip count.",
]
ERROR = ("AnalysisException: [UNRESOLVED_COLUMN.WITH_SUGGESTION] A column or "
         "function parameter with name `fare` cannot be resolved. Did you mean "
         "one of the following? [`fare_amount`, `tip_amount`, `total_amount`].")
SYSTEM_ERR = ("You are an AI that helps troubleshoot Apache Spark errors. "
              "Provide clear, concise solutions.")
ERROR_PROMPT = (f"The following Spark error occurred:\n\n{ERROR}\n\n"
                "Please analyze this error and suggest possible solutions.")
MAX_NEW = 32
# The scheduler phase: two NL->SQL requests one after the other, then the
# other six at once (with one 3B error explanation beside them).
SCHED_SQL = QUESTIONS + BATCH + ["Which payment type has the highest average fare?"]
SCHED = dict(num_slots=8, decode_chunk=8, kv_layout="paged", kv_page_size=64)


def make_engines(torch, models):
    """An InferenceEngine per (name, config) of `models`, over random bf16
    weights made on the card from seed 0."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.serve import resolve_stop_ids
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    t0 = time.perf_counter()
    engines = {}
    for name, cfg in models:
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(cfg, gen, torch.bfloat16, device="cuda")
        engines[name] = InferenceEngine(cfg, params, device="cuda",
                                        stop_ids=resolve_stop_ids(cfg, tok))
    torch.cuda.synchronize()
    print(f"  weights made on the card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    return engines


def serve(torch):
    from llm_based_apache_spark_optimization_tpu_torch.models import (
        DUCKDB_NSQL_7B,
        LLAMA32_3B,
    )
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
        set_attention_impl,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        EngineBackend,
        GenerationService,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B), ("llama3.2", LLAMA32_3B)))

    svc = GenerationService()
    svc.register("duckdb-nsql", EngineBackend(engines["duckdb-nsql"], tok,
                                              max_new_tokens=MAX_NEW))
    svc.register("llama3.2", EngineBackend(engines["llama3.2"], tok,
                                           max_new_tokens=MAX_NEW, add_bos=False),
                 template="llama3-chat")

    expected = dict.fromkeys(LAUNCHES, 0)

    def account(model, results, kind):
        eng = engines[model]
        st = eng.last_stats
        expected["flash_gqa_prefill"] += eng.cfg.num_layers
        expected["flash_gqa_decode"] += eng.cfg.num_layers * st["decode_steps"]
        for r in results:
            dec_s = r.latency_s - r.ttft_s
            rate = (r.output_tokens - 1) / dec_s if r.output_tokens > 1 and dec_s > 0 else 0.0
            rec = dict(model=model, kind=kind, prompt_tokens=r.prompt_tokens,
                       padded_prompt=st["prompt_len"], batch=st["batch"],
                       output_tokens=r.output_tokens,
                       latency_s=round(r.latency_s, 4), ttft_s=round(r.ttft_s, 4),
                       decode_tok_per_s=round(rate, 1))
            print(f"  {json.dumps(rec)}", flush=True)
            print(f"    response: {r.response!r}", flush=True)

    torch.cuda.synchronize()
    reset_launches()
    for qn in QUESTIONS:
        r = svc.generate("duckdb-nsql", qn, system=SYSTEM_SQL)
        account("duckdb-nsql", [r], "generate")
    rs = svc.generate_batch("duckdb-nsql", BATCH, system=SYSTEM_SQL)
    account("duckdb-nsql", rs, "generate_batch")
    r = svc.generate("llama3.2", ERROR_PROMPT, system=SYSTEM_ERR)
    account("llama3.2", [r], "generate")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"  launches {launches} expected {expected}", flush=True)
    assert launches == expected, f"launch counts {launches} != {expected}"
    for k in ("flash_gqa_prefill", "flash_gqa_decode"):
        assert launches[k] > 0, f"the engine path never launched {k}"

    # Right answers: prefill logits of the first SQL request through the
    # kernel vs through the plain version, same weights and inputs.
    eng = engines["duckdb-nsql"]
    ids = tok.encode(f"{SYSTEM_SQL}\n\n{QUESTIONS[0]}")
    t = eng.padded_prompt_len(len(ids))
    tokens = torch.tensor([ids + [0] * (t - len(ids))], dtype=torch.int32,
                          device="cuda")
    pos = torch.arange(t, dtype=torch.int32, device="cuda")[None]
    last = torch.tensor([len(ids) - 1], device="cuda")
    with torch.inference_mode():
        lk, _ = forward(eng.cfg, eng.params, tokens, pos, logit_indices=last)
        set_attention_impl("plain")
        lp, _ = forward(eng.cfg, eng.params, tokens, pos, logit_indices=last)
        set_attention_impl("auto")
    assert lk.shape == (1, 1, eng.cfg.vocab_size) and torch.isfinite(lk).all()
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    same = int(lk.argmax()) == int(lp.argmax())
    print(f"  7B prefill logits kernel vs plain: max|diff|/max|logit| = {rel:.3e} "
          f"(tol {LOGIT_TOL:.0e}); argmax equal: {same}", flush=True)
    assert rel <= LOGIT_TOL
    assert t == prompt_shapes(eng.cfg)["padded"], "the timed prompt is not this one"
    return launches, engines, svc


def wait_idle(sched, timeout=60.0):
    """Futures resolve before the worker frees the slot's pages and drains
    its last round: poll until only prefix-cache pages stay in use."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = sched.page_stats
        if st["pages_in_use"] == st["prefix_resident_pages"] and not sched._pending:
            return st
        time.sleep(0.01)
    raise AssertionError(f"scheduler did not drain: {sched.page_stats}")


def live_pool_logits(torch, sched):
    """One decode step on the drained scheduler's live pool, through the
    kernels and through the plain versions: the token after the longest
    cached prefix, attending to the prefix's shared pages, writing its own
    K/V into a free page. At full depth in bf16 the logits must agree
    within LOGIT_TOL; on an f32 copy of the first two layers and of their
    pool, within F32_LOGIT_TOL. A control reads the row's first page in
    place of its second on the plain side (a kernel that read a wrong
    page): its logits must miss the plain ones by more than each
    tolerance, so that both checks can fail such a kernel."""
    import dataclasses

    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        set_attention_impl,
    )

    key = max(sched._prefix_pages, key=len)
    ps, alloc = sched._page_size, sched._page_alloc
    n_use = (len(key) - 1) // ps * ps
    assert n_use >= 2 * ps, f"the cached prefix ({len(key)} tokens) spans < 2 pages"
    free = alloc.alloc(1)
    row = list(sched._prefix_pages[key][: n_use // ps]) + free
    row += [alloc.num_pages] * (sched._pages_per_slot - len(row))
    fault = list(row)
    fault[1] = fault[0]
    tokens = torch.tensor([[key[n_use]]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([[n_use]], dtype=torch.int32, device="cuda")
    kvl = torch.tensor([n_use + 1], dtype=torch.int32, device="cuda")

    def step(cfg, params, pool, table, impl):
        cache = dict(pool, ptab=torch.tensor([table], dtype=torch.int32, device="cuda"))
        set_attention_impl(impl)
        try:
            logits, _ = forward(cfg, params, tokens, pos, cache, kv_lens=kvl)
        finally:
            set_attention_impl("auto")
        assert logits.shape == (1, 1, cfg.vocab_size) and torch.isfinite(logits).all()
        return logits

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def f32(x):  # floating tensors to f32; int8 pools and q4 nibbles as they are
        return x.float() if x.is_floating_point() else x.clone()

    def two_layers(tree):  # the first two layers of a params or pool tree
        if isinstance(tree, dict):
            return {k: two_layers(v) for k, v in tree.items()}
        return f32(tree[:2])

    cfg2 = dataclasses.replace(sched.cfg, num_layers=2)
    with torch.inference_mode():
        pool = sched._pool
        lk = step(sched.cfg, sched.params, pool, row, "auto")
        lp = step(sched.cfg, sched.params, pool, row, "plain")
        lf = step(sched.cfg, sched.params, pool, fault, "plain")
        p2 = {k: two_layers(v) if k == "blocks" else f32(v)
              for k, v in sched.params.items()}
        pool2 = two_layers(pool)
        lk2 = step(cfg2, p2, pool2, row, "auto")
        lp2 = step(cfg2, p2, pool2, row, "plain")
        lf2 = step(cfg2, p2, pool2, fault, "plain")
        del p2, pool2
    alloc.release(free)
    pool_kind = "int8" if sched.kv_quant else "bf16"
    out = {}
    for label, k_, p_, f_, tol in (
            (f"bf16, {sched.cfg.num_layers} layers", lk, lp, lf, LOGIT_TOL),
            ("f32, 2 layers", lk2, lp2, lf2, F32_LOGIT_TOL)):
        out[label] = (rel(k_, p_), rel(f_, p_), tol)
        print(f"  7B decode logits on the live {pool_kind} pool after {n_use} cached tokens "
              f"({label}): kernel vs plain max|diff|/max|logit| = "
              f"{out[label][0]:.3e} (tol {tol:.0e}), argmax equal: "
              f"{int(k_.argmax()) == int(p_.argmax())}; one-page fault vs plain "
              f"{out[label][1]:.3e}, argmax equal: "
              f"{int(f_.argmax()) == int(p_.argmax())}", flush=True)
    for label, (err, fault_err, tol) in out.items():
        assert err <= tol, f"live pool ({label}): kernel vs plain {err} > {tol}"
        assert fault_err > tol, (f"live pool ({label}): a one-page fault moves the "
                                 f"logits by {fault_err}, within the tolerance {tol}")
    return out


def scheduler_serve(torch, engines, profile=False):
    """The paged scheduler path: 7B and 3B behind SchedulerBackends, exact
    launch counts, prefix sharing, no leaked page, and a live-pool check.
    With `profile`, six concurrent 7B requests alone under torch.profiler
    after the checked run."""
    from concurrent.futures import ThreadPoolExecutor

    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        GenerationService,
        SchedulerBackend,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    scheds = {name: ContinuousBatchingScheduler(
        eng.cfg, eng.params, stop_ids=resolve_stop_ids(eng.cfg, tok),
        device="cuda", **SCHED) for name, eng in engines.items()}
    svc = GenerationService()
    svc.register("duckdb-nsql", SchedulerBackend(scheds["duckdb-nsql"], tok,
                                                 max_new_tokens=MAX_NEW))
    svc.register("llama3.2", SchedulerBackend(scheds["llama3.2"], tok,
                                              max_new_tokens=MAX_NEW, add_bos=False),
                 template="llama3-chat")
    for name, sc in scheds.items():
        st = sc.page_stats
        print(f"  {name}: pool of {st['pages_total']} pages x "
              f"{st['page_bytes'] / 2**20:.1f} MiB, {sc.num_slots} slots, "
              f"max_seq {sc.max_seq}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated", flush=True)

    torch.cuda.synchronize()
    reset_launches()
    start = {n: (sc.rounds_issued, sc.prefill_forwards) for n, sc in scheds.items()}
    results = []
    t0 = time.perf_counter()
    for qn in SCHED_SQL[:2]:
        results.append(("duckdb-nsql", "sequential",
                        svc.generate("duckdb-nsql", qn, system=SYSTEM_SQL)))
    t_burst = time.perf_counter()
    with ThreadPoolExecutor(max_workers=7) as pool:
        futs = [pool.submit(svc.generate, "duckdb-nsql", qn, SYSTEM_SQL)
                for qn in SCHED_SQL[2:]]
        err = pool.submit(svc.generate, "llama3.2", ERROR_PROMPT, SYSTEM_ERR)
        results += [("duckdb-nsql", "concurrent", f.result()) for f in futs]
        results.append(("llama3.2", "concurrent", err.result()))
    t_end = time.perf_counter()
    stats = {n: wait_idle(sc) for n, sc in scheds.items()}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    expected = dict.fromkeys(LAUNCHES, 0)
    for n, sc in scheds.items():
        rounds = sc.rounds_issued - start[n][0]
        prefills = sc.prefill_forwards - start[n][1]
        expect_paged(expected, sc, rounds, prefills)
        print(f"  {n}: {rounds} decode rounds, {prefills} prefill forwards; "
              f"pages {stats[n]}; prefix {sc.prefix_stats}", flush=True)
    for model, kind, r in results:
        dec_s = r.latency_s - r.ttft_s
        rate = (r.output_tokens - 1) / dec_s if r.output_tokens > 1 and dec_s > 0 else 0.0
        print("  " + json.dumps(dict(
            model=model, kind=kind, prompt_tokens=r.prompt_tokens,
            output_tokens=r.output_tokens, latency_s=round(r.latency_s, 4),
            ttft_s=round(r.ttft_s, 4), decode_tok_per_s=round(rate, 1))), flush=True)
    burst = sum(r.output_tokens for _, kind, r in results if kind == "concurrent")
    total = sum(r.output_tokens for _, _, r in results)
    print(f"  aggregate: {total} tokens in {t_end - t0:.3f} s = "
          f"{total / (t_end - t0):.1f} tok/s; concurrent burst {burst} tokens in "
          f"{t_end - t_burst:.3f} s = {burst / (t_end - t_burst):.1f} tok/s", flush=True)
    print(f"  launches {launches} expected {expected}", flush=True)
    assert launches == expected, f"launch counts {launches} != {expected}"
    for k in ("flash_gqa_prefill", "ragged_paged_attention", "fused_page_write"):
        assert launches[k] > 0, f"the scheduler path never launched {k}"

    s7 = scheds["duckdb-nsql"]
    assert s7.prefix_stats["hits"] > 0, "the schema prefix never hit"
    assert stats["duckdb-nsql"]["zero_copy_shares"] > 0, "no page was shared"
    for name, sc in scheds.items():
        assert sc.max_seq == sc.cfg.max_seq_len, f"{name} is not at its default max_seq"
    chunk_peak_memory(torch, s7.cfg, s7.params)
    if profile:
        def burst():
            with ThreadPoolExecutor(max_workers=6) as pool:
                futs = [pool.submit(svc.generate, "duckdb-nsql", qn, SYSTEM_SQL)
                        for qn in SCHED_SQL[2:]]
                return sum(f.result().output_tokens for f in futs)

        phase("profile (scheduler path)")
        r0, t1 = s7.rounds_issued, time.perf_counter()
        n_tok = burst()
        wall = time.perf_counter() - t1
        print(f"  six concurrent 7B scheduler requests alone, no profiler: {n_tok} "
              f"tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
              f"{s7.rounds_issued - r0} decode rounds of {s7.decode_chunk} steps",
              flush=True)
        wait_idle(s7)
        r0 = s7.rounds_issued
        profile_device(torch, "six concurrent 7B scheduler requests", burst)
        print(f"  {s7.rounds_issued - r0} decode rounds of {s7.decode_chunk} steps",
              flush=True)
        wait_idle(s7)
    for sc in scheds.values():
        sc.shutdown()
        sc._page_alloc.check()
        st = sc.page_stats
        assert st["pages_in_use"] == st["prefix_resident_pages"], f"leaked pages: {st}"
    live_pool_logits(torch, s7)
    return launches


def chunk_peak_memory(torch, cfg, params):
    """Peak extra device memory of one paged prefill chunk at the 7B paged
    scheduler's widest: 8 rows of the 128-token bucket ending at max_seq
    4096 (views over all 64 pages of each row). Measured over the first two
    layers of the 7B weights and a pool of their own, since the chunk's
    transient is one layer's view at a time and does not grow with depth;
    beside it the bytes of the all-layer K and V views the chunk built
    before (computed for every layer, not run)."""
    import dataclasses

    from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
        init_page_pool,
    )
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = {k: ({n: w[:2] for n, w in v.items()} if k == "blocks" else v)
          for k, v in params.items()}
    ps, k, t = 64, 8, 128
    np_tab = cfg.max_seq_len // ps
    pool = init_page_pool(cfg2, k * np_tab, ps, torch.bfloat16, device="cuda")
    tab = torch.arange(k * np_tab, dtype=torch.int32, device="cuda").reshape(k, np_tab)
    start = cfg.max_seq_len - t
    g = torch.Generator(device="cuda").manual_seed(9)
    tokens = torch.randint(3, cfg.vocab_size, (k, t), generator=g, device="cuda",
                           dtype=torch.int32)
    pos = (start + torch.arange(t, device="cuda", dtype=torch.int32))[None].expand(k, t)
    last = torch.full((k,), t - 1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        logits, _ = forward(cfg2, p2, tokens, pos, dict(pool, ptab=tab),
                            logit_indices=last, span=start + t)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert logits.shape == (k, 1, cfg.vocab_size) and torch.isfinite(logits).all()
    view = k * cfg.num_kv_heads * np_tab * ps * cfg.head_dim * 2  # one layer's K view
    print(f"  7B paged chunk (8 rows x 128 tokens ending at {cfg.max_seq_len}): peak extra "
          f"device memory {peak / 2**20:.0f} MiB with one layer's views "
          f"({view / 2**20:.0f} MiB for K and again for V); the all-layer views "
          f"were {cfg.num_layers * view / 2**30:.1f} GiB for K and again for V",
          flush=True)
    del pool, logits
    return peak


def spy_paged_windows(torch):
    """Record the query window T of every paged attention launch: wraps
    the two ragged paged attention wrappers the model's dispatch calls.
    Returns (windows list, restore())."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import dispatch

    windows, saved = [], {}
    for name in ("ragged_paged_attention", "ragged_paged_attention_quantized"):
        real = getattr(dispatch, name)
        saved[name] = real

        def spy(q, *a, real=real, **kw):
            windows.append(q.shape[1])
            return real(q, *a, **kw)

        setattr(dispatch, name, spy)

    def restore():
        for name, real in saved.items():
            setattr(dispatch, name, real)

    return windows, restore


def mixed_serve(torch, engines):
    """Ragged mixed rounds at full width: the 7B paged scheduler with
    `ragged=True` (max_seq 4096, 8 slots, pages of 64, chunks capped at 32)
    over the bf16 and the int8 pool, phase 6's SQL traffic. Launch counts
    exact: the ragged attention and the page write L x (decode_chunk x
    rounds + ragged prefills), of which L a mixed round or a ragged prefill
    (a chunk issued while no slot decodes: the mixed round's first step
    alone) at T = its chunk bucket and the rest at T = 1; no flash prefill.
    The live pool's decode step kernel vs plain. Returns the launches per
    pool."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        GenerationService,
        SchedulerBackend,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng = engines["duckdb-nsql"]
    n_layers = eng.cfg.num_layers
    out = {}
    for kv_quant in (None, "int8"):
        sched = ContinuousBatchingScheduler(
            eng.cfg, eng.params, stop_ids=resolve_stop_ids(eng.cfg, tok), ragged=True,
            kv_quant=kv_quant, device="cuda", **SCHED)
        assert sched._ragged and sched.prompt_bucket == 32
        svc = GenerationService()
        sb = SchedulerBackend(sched, tok, max_new_tokens=MAX_NEW)
        svc.register("duckdb-nsql", sb)
        windows, restore = spy_paged_windows(torch)
        try:
            torch.cuda.synchronize()
            reset_launches()
            results, walls = send_traffic(svc)
            wait_idle(sched)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        finally:
            restore()
        rounds, mixed, alone = sched.rounds_issued, sched.mixed_rounds, sched.ragged_prefills
        want = dict.fromkeys(LAUNCHES, 0)
        expect_paged(want, sched, rounds, sched.prefill_forwards)
        wide = [t for t in windows if t > 1]
        label = kv_quant or "bf16"
        report_traffic(results, walls, layout="paged", ragged=True, kv=label)
        print(f"  {label} pool: {rounds} rounds, {mixed} mixed, {alone} ragged prefills; "
              f"{len(wide)} launches at "
              f"T in {sorted(set(wide))}, {len(windows) - len(wide)} at T = 1; prefix "
              f"{sched.prefix_stats}", flush=True)
        print(f"  launches {launches} expected {want}", flush=True)
        assert launches == want, f"launch counts {launches} != {want}"
        assert mixed > 0 and sched.prefill_forwards == 0
        assert len(wide) == n_layers * (mixed + alone) and set(wide) <= {16, 32}
        assert len(windows) - len(wide) == n_layers * (sched.decode_chunk * rounds - mixed)
        assert all(r.output_tokens > 0 for _, _, r in results)
        sb.shutdown()
        sched._page_alloc.check()
        live_pool_logits(torch, sched)
        out[label] = launches
        del svc, sb, sched
        gc.collect()
        torch.cuda.empty_cache()
    return out


# Tokens each burst request decodes in the overcommit phases (6 (b), 13
# (f)): at ratio 0.5 the six admissions then take more pages than one
# max-length row (64 at max_seq 4096), the least pool the scheduler
# accepts (66 pages, in a pool of 68), and their budgets 77. 384, not 512:
# the run's time budget.
OVERCOMMIT_NEW = 384


def burst(sched, prompts, max_new, constraints=None):
    """Submit `prompts` at once (a long GIL switch interval keeps the worker
    from admitting any before all are queued), request i with budget
    `max_new[i]` when `max_new` is a list and under grammar
    `constraints[i]` when given, and return their tokens."""
    constraints = constraints or [None] * len(prompts)
    budgets = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(BURST_SWITCH_S)
    try:
        futs = [sched.submit(p, max_new_tokens=m, constraint=c)
                for p, m, c in zip(prompts, budgets, constraints)]
    finally:
        sys.setswitchinterval(switch)
    return [f.result(timeout=600) for f in futs]


def overcommit_serve(torch, engines, tally):
    """Overcommit at full width, FLEET_LAYERS deep (for the run's time): the
    7B paged bf16 scheduler (phase 6's settings, max_seq 4096) with
    kv_overcommit 0.5 over a pool that holds the six burst
    requests' admissions (prompt + half the OVERCOMMIT_NEW budget) but not their
    whole budgets, so top-ups fail and preempt. The last three requests of
    the burst decode under the generic grammar (admitted last, they have
    the fewest tokens when a top-up fails: victims first). A control with
    the same admissions over a pool big enough for every budget preempts
    nothing. Spill mode: preemptions >= 1, a constrained victim among them,
    pages spilled == restored, tokens equal to the control's. Recompute
    mode: preemptions >= 1, a constrained victim; the number of streams
    equal to the control's and the first diverging token index are printed
    (a re-prefill computes the K/V of generated positions with other matmul
    shapes than the decode steps that wrote them). Every constrained stream
    of the three runs passes the grammar checks. Launch counts exact over
    the three runs. Returns them."""
    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import bucket_len
    from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
        pages_for_tokens,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng = fleet_model(engines["duckdb-nsql"])
    cfg = eng.cfg
    prompts = [tok.encode(f"Overcommit request {i}. {SYSTEM_SQL}\n\n{q}")
               for i, q in enumerate(SCHED_SQL[2:])]
    stops = resolve_stop_ids(cfg, tok)
    generic = grammar("generic", tok, stops)
    constraints = [None, None, None, generic, generic, generic]
    ps, overshoot = SCHED["kv_page_size"], 2 * SCHED["decode_chunk"]
    admit = sum(pages_for_tokens(bucket_len(len(p), 128) + OVERCOMMIT_NEW // 2 + overshoot,
                                 ps) for p in prompts)
    full = sum(pages_for_tokens(len(p) + OVERCOMMIT_NEW + overshoot, ps) for p in prompts)
    # A pool must hold one max-length row: the admissions must exceed it.
    assert admit + 2 >= pages_for_tokens(cfg.max_seq_len, ps) and full > admit + 2, \
        (admit, full)
    kw = dict(SCHED, stop_ids=stops, kv_overcommit=0.5, device="cuda")
    runs = {"control": dict(kv_pages=full + 16), "spill": dict(kv_pages=admit + 2,
                                                                  kv_spill=True),
            "recompute": dict(kv_pages=admit + 2, kv_spill=False)}
    print(f"  six requests of {[len(p) for p in prompts]} prompt tokens x "
          f"{OVERCOMMIT_NEW} new: admissions take {admit} pages of {ps}, whole budgets "
          f"{full}; pools {({k: v['kv_pages'] for k, v in runs.items()})}", flush=True)
    victims = {}
    preempt = ContinuousBatchingScheduler._preempt_slot

    def spy(self, slot):  # records whether each victim was constrained
        victims[name].append(self._slot_req[slot].constraint is not None)
        preempt(self, slot)

    torch.cuda.synchronize()
    reset_launches()
    want = dict.fromkeys(LAUNCHES, 0)
    toks, stats = {}, {}
    ContinuousBatchingScheduler._preempt_slot = spy
    try:
        for name, extra in runs.items():
            victims[name] = []
            t0 = time.perf_counter()
            with ContinuousBatchingScheduler(cfg, eng.params, **kw, **extra) as sched:
                toks[name] = burst(sched, prompts, OVERCOMMIT_NEW, constraints)
                st = wait_idle(sched)
            wait_settled(sched)
            sched._page_alloc.check()
            stats[name] = st
            expect_paged(want, sched, sched.rounds_issued, sched.prefill_forwards)
            print(f"  {name}: {time.perf_counter() - t0:.1f} s, {sched.rounds_issued} "
                  f"rounds, {sched.prefill_forwards} prefill forwards; preemptions "
                  f"{st['preemptions']} (constrained victims {sum(victims[name])}), "
                  f"spilled {st['spilled_pages']}, restored {st['restored_pages']}, page "
                  f"waits {st['page_waits']}, tokens {[len(t) for t in toks[name]]}",
                  flush=True)
            for c, out in zip(constraints, toks[name]):
                if c is not None:
                    check_constrained(tally, f"overcommit_{name}", c, "spark_sql", out,
                                      OVERCOMMIT_NEW, stops, tok)
            del sched
    finally:
        ContinuousBatchingScheduler._preempt_slot = preempt
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    ctl = toks["control"]
    for name in ("spill", "recompute"):
        same = sum(a == b for a, b in zip(toks[name], ctl))
        first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                      None if len(a) == len(b) else min(len(a), len(b)))
                 for a, b in zip(toks[name], ctl)]
        print(f"  {name} resume vs control: {same} of {len(ctl)} streams equal; first "
              f"diverging token index per stream {first}", flush=True)
    print(f"  launches {launches} expected {want}", flush=True)
    assert stats["control"]["preemptions"] == 0
    for name in ("spill", "recompute"):
        assert stats[name]["preemptions"] >= 1, f"{name}: the pool never preempted"
        assert any(victims[name]), f"{name}: no constrained request was preempted"
    assert stats["spill"]["spilled_pages"] > 0
    assert stats["spill"]["spilled_pages"] == stats["spill"]["restored_pages"]
    assert toks["spill"] == ctl, "spill resumes changed the tokens"
    assert launches == want, f"launch counts {launches} != {want}"
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def admission_serve(torch, engines):
    """Admission control and slot stalls on the 7B paged scheduler (a pool
    of 96 pages): with max_queue_depth 2, after one request seeds the
    service-time estimate, a burst of 12 sheds Overloaded with 1 <=
    retry_after_s <= 60 and the accepted requests complete; then one
    request submitted under `sched:slot_stall:1` retires SlotStalled after
    16 harvested rounds while the three beside it complete. Launch counts
    exact. Returns them."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        Overloaded,
        SlotStalled,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    tok = ByteTokenizer()
    eng = engines["duckdb-nsql"]
    prompts = [tok.encode(f"Admission {i}. {SYSTEM_SQL}\n\n{SCHED_SQL[i % len(SCHED_SQL)]}")
               for i in range(16)]
    sched = ContinuousBatchingScheduler(
        eng.cfg, eng.params, stop_ids=resolve_stop_ids(eng.cfg, tok), kv_pages=96,
        max_queue_depth=2, device="cuda", **SCHED)
    torch.cuda.synchronize()
    reset_launches()
    with sched:
        sched.submit(prompts[0], max_new_tokens=MAX_NEW).result(timeout=300)
        accepted, hints = [], []
        switch = sys.getswitchinterval()
        sys.setswitchinterval(BURST_SWITCH_S)
        try:
            for p in prompts[1:13]:
                try:
                    accepted.append(sched.submit(p, max_new_tokens=MAX_NEW))
                except Overloaded as e:
                    hints.append(e.retry_after_s)
        finally:
            sys.setswitchinterval(switch)
        done = [f.result(timeout=300) for f in accepted]
        sched.max_queue_depth = 0  # the stall check queues four at once
        FAULTS.configure("sched:slot_stall:1", 0)
        try:
            stalled = sched.submit(prompts[13], max_new_tokens=MAX_NEW)
        finally:
            FAULTS.clear()
        others = [sched.submit(p, max_new_tokens=MAX_NEW) for p in prompts[14:]]
        others.append(sched.submit(prompts[0], max_new_tokens=MAX_NEW))
        others_done = [f.result(timeout=300) for f in others]
        try:
            stalled.result(timeout=300)
            stall_err = None
        except SlotStalled as e:
            stall_err = e
        wait_idle(sched)
    wait_settled(sched)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = dict.fromkeys(LAUNCHES, 0)
    expect_paged(want, sched, sched.rounds_issued, sched.prefill_forwards)
    print(f"  max_queue_depth 2, burst of 12: {len(accepted)} accepted "
          f"({[len(d) for d in done]} tokens), {len(hints)} shed with retry_after_s "
          f"{sorted(set(round(h, 3) for h in hints))} (service-time estimate "
          f"{sched._svc_ewma:.3f} s)", flush=True)
    print(f"  sched:slot_stall:1: {type(stall_err).__name__}: {stall_err}; beside it "
          f"{[len(d) for d in others_done]} tokens; slots retired stalled "
          f"{sched.watchdog_stats['slots_retired_stalled']}", flush=True)
    print(f"  launches {launches} expected {want}", flush=True)
    assert hints and all(1.0 <= h <= 60.0 for h in hints), hints
    assert accepted and all(len(d) > 0 for d in done)
    assert isinstance(stall_err, SlotStalled) and "no progress" in str(stall_err)
    assert all(len(d) > 0 for d in others_done)
    assert sched.watchdog_stats["slots_retired_stalled"] == 1
    assert launches == want, f"launch counts {launches} != {want}"
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def wait_settled(sched, timeout=60.0):
    """Futures resolve before the worker releases the slot and drains its
    last round: poll until no slot is held and no round is in flight (the
    contiguous layout keeps no page accounting to poll)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not sched._pending and all(r is None for r in sched._slot_req):
            return
        time.sleep(0.01)
    raise AssertionError("scheduler did not settle")


def matmul_launches(params, n_layers):
    """The weight-matmul kernel launches of one forward over `params`, by
    counter: int4 or int8 block weights launch their kernel once a block
    matmul (7 a layer; a fused tree 4 with wqkv, 5 with wkv), and an int8
    unembed table the int8 kernel once a forward; bf16 weights none."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        is_q4tensor,
        is_qtensor,
    )

    blocks = params["blocks"]
    per_layer = 7 - 2 * ("wqkv" in blocks) - ("wkv" in blocks) - ("wgu" in blocks)
    w = blocks["wd"]
    out = dict.fromkeys(("int4_matmul", "int8_matmul"), 0)
    if is_q4tensor(w):
        out["int4_matmul"] += per_layer * n_layers
    elif is_qtensor(w):
        out["int8_matmul"] += per_layer * n_layers
    if is_qtensor(params.get("lm_head", params["embed"])):
        out["int8_matmul"] += 1
    return out


def add_matmuls(expected, params, n_layers, forwards):
    """Add `forwards` forwards' weight-matmul launches to `expected`."""
    for name, n in matmul_launches(params, n_layers).items():
        expected[name] += n * forwards


def expect_paged(expected, sched, rounds, prefills):
    """Add a paged scheduler's launches to `expected`: its ragged attention
    (int8 pool: the quantized one) layers x (decode_chunk x rounds + ragged
    prefills) (a mixed round's first step is one of the rounds' steps; a
    ragged prefill is that step run alone), of which layers x (mixed rounds
    + ragged prefills) are query windows (T > 1, counted apart), its page
    write as many plus one a layer for each prefill forward (the chunk's
    window written back), the flash prefill layers x prefill forwards, and
    the weight matmuls of every forward (`matmul_launches`)."""
    n_layers = sched.cfg.num_layers
    q = "_quantized" if sched.kv_quant else ""
    steps = sched.decode_chunk * rounds + sched.ragged_prefills
    windows = sched.mixed_rounds + sched.ragged_prefills
    expected["ragged_paged_attention" + q] += n_layers * (steps - windows)
    expected["ragged_paged_window" + q] += n_layers * windows
    expected["fused_page_write" + q] += n_layers * (steps + prefills)
    expected["flash_gqa_prefill"] += n_layers * prefills
    add_matmuls(expected, sched.params, n_layers, steps + prefills)


def expect_contiguous(expected, sched, rounds, prefills):
    """Add a contiguous scheduler's launches to `expected`: its decode
    kernel (int8 cache: the quantized one) layers x decode_chunk x rounds,
    the flash prefill layers x prefill forwards, and the weight matmuls of
    every forward (`matmul_launches`)."""
    n_layers = sched.cfg.num_layers
    decode = "flash_gqa_decode_quantized" if sched.kv_quant else "flash_gqa_decode"
    expected[decode] += n_layers * sched.decode_chunk * rounds
    expected["flash_gqa_prefill"] += n_layers * prefills
    add_matmuls(expected, sched.params, n_layers, sched.decode_chunk * rounds + prefills)


def expect_warmup(expected, sched):
    """Add one `warmup()`'s launches of `sched` to `expected`: a prefill
    forward for each of its k-buckets (a ragged scheduler: one mixed round
    instead) and one parked round (a verify round under speculation), as
    `expect_paged`, `expect_contiguous` and `expect_spec` count them. The
    rebuilt replicas of a pool or a supervisor warm before they serve."""
    import types

    nk = len(sched._kbuckets())
    rounds, prefills = (2, 0) if sched._ragged else (1, nk)
    view = types.SimpleNamespace(cfg=sched.cfg, kv_quant=sched.kv_quant,
                                 decode_chunk=sched.decode_chunk, params=sched.params,
                                 _paged=sched._paged, _spec_draft=sched._spec_draft,
                                 mixed_rounds=int(sched._ragged), ragged_prefills=0)
    expect_served(expected, view, rounds, prefills)


def expect_served(expected, sched, rounds, prefills):
    """A scheduler's launches by its kind (`expect_spec`, `expect_paged`,
    `expect_contiguous`)."""
    if sched._spec_draft:
        expect_spec(expected, sched, rounds, prefills)
    elif sched._paged:
        expect_paged(expected, sched, rounds, prefills)
    else:
        expect_contiguous(expected, sched, rounds, prefills)


def live_cache_logits(torch, sched):
    """One decode step over a contiguous scheduler's cache, as
    `live_pool_logits` does over the pool: the longest cached prefix's
    blocks copied into one row (the scheduler's own `_restore_block`
    layout), then the token at the prefix's last position attending to all
    of it, through the kernels and through the plain versions, at full
    depth in the serving dtype (LOGIT_TOL) and on an f32 copy of two layers
    (F32_LOGIT_TOL). A control copies each even block over the odd block
    after it on the plain side (a kernel that read the wrong block for half
    the prefix): it must miss by more than each tolerance."""
    import dataclasses

    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        set_attention_impl,
    )

    pb = sched._pblock
    key = max(sched._prefix_cache, key=len)
    n_use = len(key) - 1
    assert n_use >= 2 * pb, f"the cached prefix ({len(key)} tokens) spans < 2 blocks"
    row = {n: torch.zeros_like(c[:, :1]) for n, c in sched._cache.items()}
    for j in range(len(key) // pb):
        block = sched._prefix_cache[key[: (j + 1) * pb]]
        for n, c in row.items():
            c[:, 0, :, j * pb:(j + 1) * pb] = block[n][:, 0]
    fault = {n: c.clone() for n, c in row.items()}
    for j in range(1, len(key) // pb, 2):
        for c in fault.values():
            c[:, 0, :, j * pb:(j + 1) * pb] = c[:, 0, :, (j - 1) * pb:j * pb]
    tokens = torch.tensor([[key[n_use]]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([[n_use]], dtype=torch.int32, device="cuda")
    kvl = torch.tensor([n_use + 1], dtype=torch.int32, device="cuda")

    def step(cfg, params, cache, impl):
        set_attention_impl(impl)
        try:
            logits, _ = forward(cfg, params, tokens, pos,
                                {n: c.clone() for n, c in cache.items()}, kv_lens=kvl)
        finally:
            set_attention_impl("auto")
        assert logits.shape == (1, 1, cfg.vocab_size) and torch.isfinite(logits).all()
        return logits

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def f32(x):  # floating tensors to f32; int8 caches and q4 nibbles as they are
        return x.float() if x.is_floating_point() else x.clone()

    def two_layers(tree):
        if isinstance(tree, dict):
            return {k: two_layers(v) for k, v in tree.items()}
        return f32(tree[:2])

    cfg2 = dataclasses.replace(sched.cfg, num_layers=2)
    with torch.inference_mode():
        lk = step(sched.cfg, sched.params, row, "auto")
        lp = step(sched.cfg, sched.params, row, "plain")
        lf = step(sched.cfg, sched.params, fault, "plain")
        p2 = {k: two_layers(v) if k == "blocks" else f32(v)
              for k, v in sched.params.items()}
        row2, fault2 = two_layers(row), two_layers(fault)
        lk2 = step(cfg2, p2, row2, "auto")
        lp2 = step(cfg2, p2, row2, "plain")
        lf2 = step(cfg2, p2, fault2, "plain")
        del p2, row2, fault2, row, fault
    kind = "int8" if sched.kv_quant else "bf16"
    out = {}
    for label, k_, p_, f_, tol in (
            (f"{sched.cfg.num_layers} layers", lk, lp, lf, LOGIT_TOL),
            ("f32, 2 layers", lk2, lp2, lf2, F32_LOGIT_TOL)):
        out[label] = (rel(k_, p_), rel(f_, p_), tol)
        print(f"  {sched.cfg.name} decode logits on the live contiguous {kind} cache after "
              f"{n_use} cached tokens ({label}): kernel vs plain max|diff|/max|logit| = "
              f"{out[label][0]:.3e} (tol {tol:.0e}), argmax equal: "
              f"{int(k_.argmax()) == int(p_.argmax())}; odd-block fault vs plain "
              f"{out[label][1]:.3e}", flush=True)
    for label, (err, fault_err, tol) in out.items():
        assert err <= tol, f"live cache ({label}): kernel vs plain {err} > {tol}"
        assert fault_err > tol, (f"live cache ({label}): an odd-block fault moves the "
                                 f"logits by {fault_err}, within the tolerance {tol}")
    return out


def send_traffic(svc, sql_model="duckdb-nsql", err_model=None):
    """Two NL->SQL requests one after the other, then six at once from
    threads, beside one error explanation on `err_model` when given.
    Returns [(model, kind, result)] and the walls (t0, t_burst, t_end)."""
    from concurrent.futures import ThreadPoolExecutor

    results = []
    t0 = time.perf_counter()
    for qn in SCHED_SQL[:2]:
        results.append((sql_model, "sequential",
                        svc.generate(sql_model, qn, system=SYSTEM_SQL)))
    t_burst = time.perf_counter()
    with ThreadPoolExecutor(max_workers=7) as pool:
        futs = [pool.submit(svc.generate, sql_model, qn, SYSTEM_SQL)
                for qn in SCHED_SQL[2:]]
        err = (pool.submit(svc.generate, err_model, ERROR_PROMPT, SYSTEM_ERR)
               if err_model else None)
        results += [(sql_model, "concurrent", f.result()) for f in futs]
        if err is not None:
            results.append((err_model, "concurrent", err.result()))
    return results, (t0, t_burst, time.perf_counter())


def report_traffic(results, walls, **labels):
    t0, t_burst, t_end = walls
    for model, kind, r in results:
        dec_s = r.latency_s - r.ttft_s
        rate = (r.output_tokens - 1) / dec_s if r.output_tokens > 1 and dec_s > 0 else 0.0
        print("  " + json.dumps(dict(
            model=model, **labels, kind=kind, prompt_tokens=r.prompt_tokens,
            output_tokens=r.output_tokens, latency_s=round(r.latency_s, 4),
            ttft_s=round(r.ttft_s, 4), decode_tok_per_s=round(rate, 1))), flush=True)
    burst = sum(r.output_tokens for _, kind, r in results if kind == "concurrent")
    total = sum(r.output_tokens for _, _, r in results)
    print(f"  aggregate: {total} tokens in {t_end - t0:.3f} s = "
          f"{total / (t_end - t0):.1f} tok/s; concurrent burst {burst} tokens in "
          f"{t_end - t_burst:.3f} s = {burst / (t_end - t_burst):.1f} tok/s", flush=True)


def contiguous_serve(torch, engines):
    """The contiguous-layout scheduler path, the reference app's default:
    7B and 3B at full width and depth behind SchedulerBackends, `kv_layout`
    and `max_seq` left at their defaults (4096 and 8192), 8 slots. Exact
    launch counts (the flash decode kernel over the slots' rows, the flash
    prefill over the chunks' rows), prefix block hits, and the live cache's
    decode step kernel vs plain. Returns (launches, schedulers)."""
    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import cache_bytes
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        GenerationService,
        SchedulerBackend,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    torch.cuda.empty_cache()
    scheds = {name: ContinuousBatchingScheduler(
        eng.cfg, eng.params, num_slots=8, decode_chunk=8,
        stop_ids=resolve_stop_ids(eng.cfg, tok), device="cuda")
        for name, eng in engines.items()}
    for name, sc in scheds.items():
        assert sc.kv_layout == "contiguous" and sc.max_seq == sc.cfg.max_seq_len
        print(f"  {name}: contiguous cache of {sc.num_slots} slots x {sc.max_seq} = "
              f"{cache_bytes(sc.cfg, sc.num_slots, sc.max_seq) / 2**30:.2f} GiB; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    svc = GenerationService()
    svc.register("duckdb-nsql", SchedulerBackend(scheds["duckdb-nsql"], tok,
                                                 max_new_tokens=MAX_NEW))
    svc.register("llama3.2", SchedulerBackend(scheds["llama3.2"], tok,
                                              max_new_tokens=MAX_NEW, add_bos=False),
                 template="llama3-chat")
    torch.cuda.synchronize()
    reset_launches()
    start = {n: (sc.rounds_issued, sc.prefill_forwards) for n, sc in scheds.items()}
    results, walls = send_traffic(svc, err_model="llama3.2")
    for sc in scheds.values():
        wait_settled(sc)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    expected = dict.fromkeys(LAUNCHES, 0)
    for n, sc in scheds.items():
        rounds = sc.rounds_issued - start[n][0]
        prefills = sc.prefill_forwards - start[n][1]
        expect_contiguous(expected, sc, rounds, prefills)
        print(f"  {n}: {rounds} decode rounds, {prefills} prefill forwards; "
              f"prefix {sc.prefix_stats}", flush=True)
    report_traffic(results, walls, layout="contiguous")
    print(f"  launches {launches} expected {expected}", flush=True)
    assert launches == expected, f"launch counts {launches} != {expected}"
    for k in ("flash_gqa_prefill", "flash_gqa_decode"):
        assert launches[k] > 0, f"the contiguous scheduler path never launched {k}"
    assert scheds["duckdb-nsql"].prefix_stats["hits"] > 0, "the schema prefix never hit"
    for r in (r for _, _, r in results):
        assert r.output_tokens > 0 and r.ttft_s > 0
    live_cache_logits(torch, scheds["duckdb-nsql"])
    return launches, scheds


CSV = ("VendorID,passenger_count,trip_distance,payment_type,fare_amount,tip_amount,"
       "total_amount\n" + "".join(
           f"{1 + i % 2},{1 + i % 4},{0.5 + i * 0.37:.2f},{('card', 'cash')[i % 2]},"
           f"{5 + i * 1.25:.2f},{i % 3 * 0.75:.2f},{6 + i * 1.5:.2f}\n" for i in range(64)))
APP_QUESTIONS = [
    "What is the total fare per vendor?",
    "How many trips were paid by card?",
    "What is the average tip amount for each passenger count?",
    "Which payment type has the highest average total amount?",
    "List the five longest trips.",
    "What is the mean trip distance per vendor?",
    "Count the trips with more than two passengers.",
]


class ByteModTokenizer:
    """ByteTokenizer whose decode maps every id to byte id mod 256: random
    7B weights almost never pick one of the ByteTokenizer's 259 ids, so
    its text would be empty, and SQLite runs empty SQL as a success. With
    this decode the random model writes bytes, so each request walks the
    failure path (the app phase's purpose). Encode is ByteTokenizer's."""

    def __init__(self):
        from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

        self._tok = ByteTokenizer()
        self.eos_ids = ()

    def encode(self, text, add_bos=True):
        return self._tok.encode(text, add_bos=add_bos)

    def decode(self, ids):
        return bytes(i % 256 for i in ids).decode("utf-8", errors="replace")


def app_serve(torch, scheds):
    """`POST /process-data/` through the port's app on the contiguous 7B and
    3B schedulers: `create_api_app(service, SQLiteBackend,
    SQLiteHistory(":memory:"), cfg)` over a temporary `data/input/taxi.csv`,
    driven through the WSGI test client, three requests one after the
    other, then four from threads. Random weights write SQL that fails, so
    each request runs generate, execute, up to two repair regenerations and
    the 3B explanation; each body must have the failure shape of
    tests/test_app.py. The history store records successful runs only (as
    the reference's `query_results`), so it must hold none, and the web
    app's `GET /history` over it must answer. Launch counts exact over the
    phase; wall and TTFT (of the NL->SQL generate) per request. Returns the
    launches, those of the streaming step and the service (its registry
    holds the phase's requests)."""
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from llm_based_apache_spark_optimization_tpu_torch.app import (
        AppConfig,
        create_api_app,
        create_web_app,
    )
    from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        GenerationService,
        SchedulerBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend

    generated = []
    lock = threading.Lock()

    class RecordingService(GenerationService):
        def generate(self, model, prompt, *a, **kw):
            res = super().generate(model, prompt, *a, **kw)
            with lock:
                generated.append((model, res))
            return res

    tok = ByteModTokenizer()
    svc = RecordingService()
    svc.register("duckdb-nsql", SchedulerBackend(scheds["duckdb-nsql"], tok,
                                                 max_new_tokens=MAX_NEW))
    svc.register("llama3.2", SchedulerBackend(scheds["llama3.2"], tok,
                                              max_new_tokens=MAX_NEW, add_bos=False),
                 template="llama3-chat")
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        os.makedirs(os.path.join(data, "input"))
        with open(os.path.join(data, "input", "taxi.csv"), "w") as f:
            f.write(CSV)
        cfg = AppConfig(input_dir=os.path.join(data, "input"),
                        output_dir=os.path.join(data, "output"),
                        history_db=":memory:", max_new_tokens=MAX_NEW)
        history = SQLiteHistory(":memory:")
        client = create_api_app(svc, SQLiteBackend, history, cfg).test_client()

        def post(qn):
            t = time.perf_counter()
            res = client.post_json("/process-data/",
                                   {"input_text": qn, "file_name": "taxi.csv"})
            return res, time.perf_counter() - t

        torch.cuda.synchronize()
        reset_launches()
        start = {n: (sc.rounds_issued, sc.prefill_forwards) for n, sc in scheds.items()}
        t0 = time.perf_counter()
        responses = [(qn, "sequential") + post(qn) for qn in APP_QUESTIONS[:3]]
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [(qn, pool.submit(post, qn)) for qn in APP_QUESTIONS[3:]]
            responses += [(qn, "concurrent") + f.result() for qn, f in futs]
        wall = time.perf_counter() - t0
        for sc in scheds.values():
            wait_settled(sc)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        hist_page = create_web_app(svc, SQLiteBackend, history, cfg).test_client().get(
            "/history")
    assert history.count() == 0 and hist_page.status == 200, "failed runs were recorded"
    expected = dict.fromkeys(LAUNCHES, 0)
    for n, sc in scheds.items():
        expect_contiguous(expected, sc, sc.rounds_issued - start[n][0],
                          sc.prefill_forwards - start[n][1])
    by_model = {}
    for model, _ in generated:
        by_model[model] = by_model.get(model, 0) + 1
    for qn, kind, res, t in responses:
        body = res.json()
        rid = res.headers["X-Request-Id"]
        first = next(r for m, r in generated if r.request_id == rid)
        print("  " + json.dumps(dict(
            kind=kind, status=res.status, wall_s=round(t, 4),
            ttft_s=round(first.ttft_s, 4), sql_bytes=len(body.get("sql_query", "")),
            details_bytes=len(body.get("error_details", "")),
            keys=sorted(body))), flush=True)
        assert res.status == 200, body
        assert set(body) == {"error", "sql_query", "error_details"}, body
        assert body["error"] == "SQL execution failed" and body["error_details"]
    print(f"  seven requests in {wall:.3f} s; generates by model {by_model}", flush=True)
    print(f"  launches {launches} expected {expected}", flush=True)
    assert launches == expected, f"launch counts {launches} != {expected}"
    assert by_model.get("llama3.2", 0) == len(responses), "an explanation did not run"
    assert by_model["duckdb-nsql"] >= len(responses)
    return launches, stream_generate(torch, svc, scheds, cfg), svc


STREAM_PROMPT = "Write one Spark SQL query that counts the trips per payment type."


def stream_generate(torch, svc, scheds, cfg):
    """`/api/generate` with stream=true on the 7B contiguous scheduler: a
    blocking request, then the same prompt streamed through the app's WSGI
    callable, each NDJSON chunk timed as it arrives. Neither request finds
    the prompt's blocks in the prefix cache (the first sighting publishes
    nothing), so both prefill it alone and decode the same 32 tokens: the
    stream must come in more than one chunk whose concatenation equals the
    blocking text. Launch counts exact. Returns them."""
    from llm_based_apache_spark_optimization_tpu_torch.app import create_api_app
    from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend
    import io

    app = create_api_app(svc, SQLiteBackend, SQLiteHistory(":memory:"), cfg)
    torch.cuda.synchronize()
    reset_launches()
    start = {n: (sc.rounds_issued, sc.prefill_forwards) for n, sc in scheds.items()}
    blocking = app.test_client().post_json(
        "/api/generate", {"model": "duckdb-nsql", "prompt": STREAM_PROMPT,
                          "stream": False}).json()
    body = json.dumps({"model": "duckdb-nsql", "prompt": STREAM_PROMPT,
                       "stream": True}).encode()
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/api/generate", "QUERY_STRING": "",
               "CONTENT_TYPE": "application/json", "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body), "HTTP_COOKIE": ""}
    status = {}
    t0 = time.perf_counter()
    lines, stamps = [], []
    for chunk in app(environ, lambda st, headers: status.update(code=st)):
        for line in chunk.decode().splitlines():
            lines.append(json.loads(line))
            stamps.append(time.perf_counter() - t0)
    for sc in scheds.values():
        wait_settled(sc)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = dict.fromkeys(LAUNCHES, 0)
    for n, sc in scheds.items():
        expect_contiguous(want, sc, sc.rounds_issued - start[n][0],
                          sc.prefill_forwards - start[n][1])
    pieces = [ln["response"] for ln in lines if not ln.get("done")]
    print(f"  /api/generate stream=true: {status.get('code')}, {len(pieces)} chunks, first "
          f"at {stamps[0]:.3f} s of {stamps[-1]:.3f} s; joined == blocking "
          f"({len(blocking['response'])} chars): "
          f"{''.join(pieces) == blocking['response']}", flush=True)
    print(f"  launches {launches} expected {want}", flush=True)
    assert status.get("code", "").startswith("200") and lines[-1]["done"] is True, lines[-1:]
    assert len(pieces) > 1, "the completion came in one chunk"
    assert "".join(pieces) == blocking["response"], "streamed text != blocking text"
    assert launches == want, f"launch counts {launches} != {want}"
    return launches


def entry_point(torch, backend_args=("--backend", "tiny"), device_args=(), env_extra=None,
                explain=None):
    """The entry point as a user starts it, in a process of its own:
    `python -m <package>.app <backend_args> --api` (supervised schedulers on
    the card) over a temporary input directory, with `env_extra` in its
    environment; wait for `/healthz`, `/readyz` must answer `ready`, `POST
    /process-data/` once, with `explain` one `/api/generate` of that body
    (and /healthz must then carry the pool's `fleet`), then SIGTERM (the
    graceful drain), and the process must exit 0. Its launches are its own
    process's, outside every counted window."""
    import signal
    import socket
    import tempfile
    import urllib.request

    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "data", "input"))
        with open(os.path.join(root, "data", "input", "taxi.csv"), "w") as f:
            f.write(CSV)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, LSOT_HISTORY_DB=":memory:",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)), **(env_extra or {}))
        cmd = [sys.executable, "-m", f"{PKG}.app", *backend_args, "--api",
               "--port", str(port), *device_args]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        url = f"http://127.0.0.1:{port}"
        try:
            while True:
                assert proc.poll() is None, f"the app exited: {proc.stdout.read()}"
                assert time.perf_counter() - t0 < 300, "the app did not come up"
                try:
                    with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                        health = json.loads(r.read())
                        if health["status"] == "ok":
                            break
                except OSError:
                    time.sleep(0.5)
            t_up = time.perf_counter() - t0
            with urllib.request.urlopen(f"{url}/readyz", timeout=5) as r:
                ready = (r.status, json.loads(r.read()))
            req = urllib.request.Request(
                f"{url}/process-data/", method="POST",
                data=json.dumps({"input_text": APP_QUESTIONS[0],
                                 "file_name": "taxi.csv"}).encode(),
                headers={"Content-Type": "application/json"})
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                status, body = r.status, json.loads(r.read())
            wall = time.perf_counter() - t1
            if explain is not None:
                req = urllib.request.Request(
                    f"{url}/api/generate", method="POST", data=json.dumps(explain).encode(),
                    headers={"Content-Type": "application/json"})
                t1 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=120) as r:
                    explained = (r.status, json.loads(r.read()), time.perf_counter() - t1)
                print(f"  /api/generate {explain['model']}: {explained[0]} in "
                      f"{explained[2]:.3f} s, {len(explained[1]['response'])} chars",
                      flush=True)
                assert explained[0] == 200 and explained[1]["done"], explained
                with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                fleet = {m: [(x["replica"], x["model_id"], x["state"]) for x in reps]
                         for m, reps in health["fleet"].items()}
                print(f"  /healthz fleet {fleet}", flush=True)
                assert {x[1] for reps in fleet.values() for x in reps} >= {
                    explain["model"]}, fleet
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
        log = proc.stdout.read()
    print(f"  `python {' '.join(cmd[1:])}`: up in {t_up:.1f} s; /readyz {ready[0]} "
          f"{ready[1]['state']} (restarts {ready[1].get('restarts')}, models "
          f"{sorted(ready[1]['models'])}); POST /process-data/ {status} in {wall:.3f} s, "
          f"keys {sorted(body)}; exit {rc} after SIGTERM", flush=True)
    assert ready[0] == 200 and ready[1]["state"] == "ready", ready
    assert {"duckdb-nsql", "llama3.2"} <= set(ready[1]["models"]), \
        f"the schedulers are not supervised: {ready[1]}"
    assert status == 200 and (set(body) == {"error", "sql_query", "error_details"}
                              or body.get("message") == "Query executed successfully!"), body
    assert rc == 0 and "SIGTERM: draining" in log, log


# --------------------------------------------------------- observability

# The hand-written kernels each profile capture must hold, by a substring
# of the kernel's name in the trace (the kernel functions of csrc/; paged
# attention's source template is `PagedSrc`).
OBS_KERNELS = {
    "contiguous_bf16": {
        "row 1 flash prefill": ("flash_prefill_kernel",),
        "row 2 decode attention": ("decode_split_kernel", "ContigSrc"),
    },
    "paged_int4_int8": {
        "row 1 flash prefill": ("flash_prefill_kernel",),
        "row 5 quantized paged attention": ("decode_split_kernel", "PagedSrc"),
        "row 7 quantized page write": ("page_write_kernel",),
        "row 8 int4 matmul": ("int4_",),
    },
}
OBS_ROUNDS = 4  # rounds a profile capture brackets
# The captured rounds' walls must fit in the capture's kernel span; the
# slack covers the host's enqueue of a round's first op, which its start
# event precedes and which may fall before the capture's first kernel.
OBS_SPAN_SLACK = 1.05


def tree_nbytes(tree):
    """Bytes of the tensors of a params tree or a cache (nested dicts,
    lists and tuples)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return tree.nbytes
OBS_LONG = 64   # tokens of the burst's first three requests (8 rounds)


def obs_settled(sched, timeout=60.0):
    """wait_settled, and the last harvested round's record in the ring (a
    harvest writes its record after retiring its requests)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not sched._pending and not sched._prefill_q and \
                all(r is None for r in sched._slot_req):
            rounds = [r for r in sched.flight.snapshot() if "round" in r]
            if not rounds or rounds[-1]["round"] == sched.heartbeat.rounds:
                return
        time.sleep(0.01)
    raise AssertionError("scheduler did not settle")


def prometheus_families(text):
    """The families of an exposition text, after checking that every line
    is a comment or a `name{labels} value` sample of a declared family."""
    families = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            m = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$', line)
            assert m, f"unparseable sample line {line!r}"
            float(m.group(3))
            base = re.sub(r"_(bucket|sum|count)$", "", m.group(1))
            assert m.group(1) in families or base in families, f"{m.group(1)} before its TYPE"
    return families


def record_cost_us(sched, rec, calls=2000):
    """Host us a round spends in `flight.record` + `perf.observe`, on a
    recorder and a ledger built like the scheduler's (its live ring and
    EWMAs untouched), at the fields of `rec`."""
    from llm_based_apache_spark_optimization_tpu_torch.serve.flightrecorder import (
        FlightRecorder,
    )
    from llm_based_apache_spark_optimization_tpu_torch.utils.perfmodel import PerfModel

    pm = sched.perf
    ledger = PerfModel(sched.cfg, param_bytes=pm.param_bytes, weight_bits=pm.weight_bits,
                       kv_itemsize=pm.kv_itemsize, kv_quant=pm.kv_quant,
                       kv_layout=pm.kv_layout, page_size=pm.page_size,
                       device_kind=pm.device_kind)
    ring = FlightRecorder(capacity=sched.flight.capacity)
    fields = {k: v for k, v in rec.items() if k not in ("ts", "replica", "seq")}
    t0 = time.perf_counter()
    for _ in range(calls):
        ledger.observe(rec["phase"], rows=sched.num_slots, tokens=sched.decode_chunk,
                       ctx=rec["perf_ctx"], wall_s=rec["round_wall_s"])
        ring.record(**fields)
    return (time.perf_counter() - t0) / calls * 1e6


def observability(torch, svc, model, sched, label):
    """The observability phase on one 7B scheduler behind the app
    (`create_api_app` over `svc`), over one burst: three requests of
    OBS_LONG tokens, a `/debug/profile` capture of OBS_ROUNDS rounds armed
    through the app once they decode (a second arm must answer 409), then
    three more requests that arrive inside the capture (their prefills
    land in it). The burst's flight records must number consecutive
    rounds, emit the requests' output tokens, admit and retire the same
    rids, leave the page pool at its idle value (paged) and carry mfu and
    hbm_util in (0, 1.05] priced at the H100 row. The capture, polled
    through `GET /debug/profile` until done, must hold the hand-written
    kernels of OBS_KERNELS[label]; `traceprof.Trace` gives its device busy
    share, printed beside the captured decode rounds' median hbm_util.
    Then the host us of a round's record and ledger stamp, `/metrics` in
    both formats and the four read-only `/debug/*` routes. Returns the
    phase's numbers."""
    import statistics
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig, create_api_app
    from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
    from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend
    from llm_based_apache_spark_optimization_tpu_torch.utils.traceprof import Trace

    paged = sched.kv_layout == "paged"
    perf = sched.perf_stats
    print(f"  {label}: ledger {perf['device_kind']}, {perf['peak_tflops']} TFLOP/s, "
          f"{perf['peak_hbm_gbs']} GB/s, weights {perf['param_bytes'] / 2**30:.2f} GiB "
          f"at {perf['weight_bits']} bits, kv {perf['kv_layout']} {perf['kv_quant'] or 'bf16'}",
          flush=True)
    assert (perf["peak_tflops"], perf["peak_hbm_gbs"]) == (989.0, 3350.0), \
        f"the ledger does not price the H100 row: {perf}"
    with tempfile.TemporaryDirectory() as root:
        cfg = AppConfig(input_dir=root, output_dir=root, history_db=":memory:",
                        max_new_tokens=MAX_NEW)
        client = create_api_app(svc, SQLiteBackend, SQLiteHistory(":memory:"),
                                cfg).test_client()
        obs_settled(sched)
        mark, last = sched.flight.stats()["total"], sched.heartbeat.rounds
        pool = ThreadPoolExecutor(max_workers=6)
        try:
            long = [pool.submit(svc.generate, model, qn, SYSTEM_SQL, OBS_LONG)
                    for qn in SCHED_SQL[:3]]
            deadline = time.time() + 120
            while not any(r is not None and r.ready for r in sched._slot_req):
                assert time.time() < deadline, "the burst never reached decode"
                time.sleep(0.002)
            res = client.request("GET", "/debug/profile",
                                 query=f"rounds={OBS_ROUNDS}&model={model}")
            assert res.status == 200 and res.json()["state"] == "armed", res.json()
            again = client.request("GET", "/debug/profile",
                                   query=f"rounds={OBS_ROUNDS}&model={model}")
            assert again.status == 409, f"a second capture answered {again.status}"
            while client.get("/debug/profile").json()["captures"][model]["state"] == "armed":
                assert time.time() < deadline, "the capture never started"
                time.sleep(0.002)
            late = [pool.submit(svc.generate, model, qn, SYSTEM_SQL)
                    for qn in SCHED_SQL[3:6]]
            while True:
                cap = client.get("/debug/profile").json()["captures"][model]
                if cap.get("last", {}).get("state") in ("done", "error", "aborted") \
                        and cap["state"] == "idle":
                    break
                assert time.time() < deadline, f"the capture never finished: {cap}"
                time.sleep(0.01)
            results = [f.result() for f in long + late]
        finally:
            pool.shutdown()
        obs_settled(sched)

        # The ring over the burst.
        snap = sched.flight.snapshot()
        rounds = [r for r in snap if r["seq"] >= mark and "round" in r]
        nums = [r["round"] for r in rounds]
        assert nums == list(range(last + 1, last + 1 + len(nums))), f"rounds {nums}"
        emitted, out_tokens = sum(r["emitted"] for r in rounds), sum(
            r.output_tokens for r in results)
        assert emitted == out_tokens, f"emitted {emitted} != output tokens {out_tokens}"
        admitted = sorted(x for r in rounds for x in r["admitted"])
        retired = sorted(x for r in rounds for x in r["retired"])
        assert admitted == retired and len(admitted) == len(results), (admitted, retired)
        outside = [(r["round"], r["mfu"], r["hbm_util"]) for r in rounds
                   if not (0.0 < r["mfu"] <= 1.05 and 0.0 < r["hbm_util"] <= 1.05)]
        assert not outside, f"rounds with mfu or hbm_util outside (0, 1.05]: {outside}"
        if paged:
            st = sched.page_stats
            assert rounds[-1]["kv_pages"] == st["pages_in_use"] == \
                st["prefix_resident_pages"], f"pages leaked: {rounds[-1]} {st}"
        # The ledger's bytes a decode step, read back from each decode
        # record (the rounding of hbm_util and of the wall bounds the
        # error), against the bytes on the card: every weight read once a
        # step, at most the whole KV cache besides.
        weights, kv = tree_nbytes(sched.params), tree_nbytes(
            sched._pool if paged else sched._cache)
        assert perf["param_bytes"] == weights, (perf["param_bytes"], weights)
        for r in (r for r in rounds if r["phase"] == "decode"):
            step = r["hbm_util"] * r["round_wall_s"] * perf["peak_hbm_gbs"] * 1e9 \
                / sched.decode_chunk
            tol = 0.5e-6 / r["hbm_util"] + 0.5e-6 / r["round_wall_s"]
            assert weights * (1 - tol) <= step <= (weights + kv) * (1 + tol), \
                f"round {r['round']}: {step:.4g} bytes a step, weights {weights}, kv {kv}"
        walls = [r["round_wall_s"] for r in rounds]
        cost_us = record_cost_us(sched, rounds[-1])
        print(f"  {label}: {len(rounds)} rounds {nums[0]}-{nums[-1]}, {emitted} tokens "
              f"emitted = the requests' output tokens, rids {admitted} admitted and "
              f"retired; mfu {min(r['mfu'] for r in rounds):.4f}-"
              f"{max(r['mfu'] for r in rounds):.4f}, hbm_util "
              f"{min(r['hbm_util'] for r in rounds):.4f}-"
              f"{max(r['hbm_util'] for r in rounds):.4f}", flush=True)
        print(f"  {label}: flight.record + perf.observe {cost_us:.2f} us a round, "
              f"{100 * cost_us * 1e-6 / statistics.median(walls):.4f}% of the median "
              f"round wall {statistics.median(walls) * 1e3:.2f} ms", flush=True)

        # The capture.
        last_cap = cap["last"]
        assert last_cap["state"] == "done", f"profile capture failed: {last_cap}"
        tr = Trace().load_dir(last_cap["dir"])
        missing = [row for row, parts in OBS_KERNELS[label].items()
                   if not any(all(p in name for p in parts) for name in tr.ops)]
        assert not missing, f"capture without {missing}: {sorted(tr.ops)[:20]}"
        # The rounds the capture counted: its last `rounds` round records
        # (a round in flight when it started was issued outside it).
        start = max(r["seq"] for r in snap if r.get("kind") == "profile_start")
        done = max(r["seq"] for r in snap if r.get("kind") == "profile_done")
        captured = [r for r in snap if start < r["seq"] < done and "round" in r]
        captured = captured[-last_cap["rounds"]:]
        assert len(captured) == last_cap["rounds"], f"captured rounds {captured}"
        decode_util = [r["hbm_util"] for r in captured if r["phase"] == "decode"]
        assert decode_util, f"no decode round in the capture: {captured}"
        busy, dev_s, span_s = tr.busy_share(), tr.device_time_s(), tr.span_s()
        hbm_med = statistics.median(decode_util)
        walls_s = sum(r["round_wall_s"] for r in captured)
        least_s = sum(max(r["mfu"], r["hbm_util"]) * r["round_wall_s"] for r in captured)
        print(f"  {label}: capture of {last_cap['rounds']} rounds, "
              f"{last_cap['artifact_bytes']} bytes, {len(tr.ops)} kernels; held "
              f"{sorted(OBS_KERNELS[label])}; device busy {dev_s * 1e3:.2f} ms "
              f"of a {span_s * 1e3:.2f} ms span = {100 * busy:.1f}%; decode "
              f"hbm_util median {hbm_med:.4f} over {len(decode_util)} captured rounds "
              f"({'<=' if hbm_med <= busy else '>'} the busy share); the captured "
              f"rounds' walls {walls_s * 1e3:.2f} ms (<= the span: "
              f"{walls_s <= OBS_SPAN_SLACK * span_s}), their roofline time "
              f"{least_s * 1e3:.2f} ms = {least_s / dev_s:.3f} of the busy time",
              flush=True)
        for name, secs, n in tr.top_ops(6):
            print(f"    {secs * 1e3:9.3f} ms  x{n:<5d} {name[:100]}", flush=True)
        assert walls_s <= OBS_SPAN_SLACK * span_s, \
            f"the captured rounds' walls overlap: {walls_s} s in a {span_s} s capture"
        assert least_s <= dev_s, \
            f"the ledger's least time {least_s} s exceeds the card's busy {dev_s} s"
        assert hbm_med <= busy, f"decode hbm_util {hbm_med} above the busy share {busy}"

        # The scrapes.
        body = client.get("/metrics").json()
        reg = body[model]
        assert {"perf", "flight_recorder", "prefix", "watchdog"} <= set(reg["serving"]), \
            sorted(reg["serving"])
        assert reg["requests"] > 0 and {"ttft_p50_s", "queue_wait_p50_s"} <= set(reg), \
            sorted(reg)
        prom = client.request("GET", "/metrics", query="format=prometheus")
        families = prometheus_families(prom.text)
        want = {"lsot_mfu", "lsot_hbm_util", "lsot_requests_total", "lsot_ttft_seconds",
                "lsot_queue_wait_seconds", "lsot_prefix_hits_total"}
        assert prom.status == 200 and want <= families, sorted(want - families)
        for path in ("/debug/flightrecorder", "/debug/traces", "/debug/slo",
                     "/debug/prefixcache"):
            r = client.get(path)
            assert r.status == 200, f"{path}: {r.status}"
            r.json()
        assert client.get("/debug/flightrecorder").json()["models"][model]
        assert client.get("/debug/prefixcache").json()["models"][model]["entries"]
        print(f"  {label}: /metrics {len(prom.text)} bytes of exposition text, "
              f"{len(families)} families; registry of {model}: {reg['requests']} requests, "
              f"queue wait p50 {reg['queue_wait_p50_s'] * 1e3:.2f} ms p95 "
              f"{reg['queue_wait_p95_s'] * 1e3:.2f} ms, TTFT p50 "
              f"{reg['ttft_p50_s'] * 1e3:.2f} ms p95 {reg['ttft_p95_s'] * 1e3:.2f} ms",
              flush=True)
    return {"rounds": len(rounds), "record_us": round(cost_us, 3),
            "round_wall_ms_median": round(statistics.median(walls) * 1e3, 3),
            "busy_share": round(busy, 4), "decode_hbm_util_median": round(hbm_med, 4),
            "mfu_max": max(r["mfu"] for r in rounds),
            "hbm_util_max": max(r["hbm_util"] for r in rounds),
            "queue_wait_p50_ms": round(reg["queue_wait_p50_s"] * 1e3, 3),
            "ttft_p50_ms": round(reg["ttft_p50_s"] * 1e3, 3),
            "kernels": sorted(OBS_KERNELS[label])}


def observability_only(torch, cfg):
    """`--observability-only`: phase 15 on the 7B weights alone, (a) over a
    contiguous scheduler of phase 7's settings behind a service of its own
    (no app traffic before it), (b) as in the whole run."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_params_int4,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        GenerationService,
        SchedulerBackend,
        resolve_stop_ids,
    )

    engines = make_engines(torch, (("duckdb-nsql", cfg),))
    eng = engines["duckdb-nsql"]
    tok = ByteModTokenizer()
    sched = ContinuousBatchingScheduler(eng.cfg, eng.params, num_slots=8, decode_chunk=8,
                                        stop_ids=resolve_stop_ids(eng.cfg, tok),
                                        device="cuda")
    svc = GenerationService()
    svc.register("duckdb-nsql", SchedulerBackend(sched, tok, max_new_tokens=MAX_NEW))
    try:
        obs = {"contiguous_bf16": observability(torch, svc, "duckdb-nsql", sched,
                                                "contiguous_bf16")}
    finally:
        svc.close()
        del sched
        torch.cuda.empty_cache()
    phase("observability (b): the paged int4 7B scheduler over the int8 pool")
    obs["paged_int4_int8"] = observability_paged(
        torch, engines, quantize_params_int4(eng.params))
    return obs


def observability_paged(torch, engines, params4):
    """Observability (b): the 7B paged scheduler with int4 block weights
    over the int8 pool (phase 9's settings and tree) behind a service of
    its own."""
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        GenerationService,
        SchedulerBackend,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = engines["duckdb-nsql"].cfg
    sched = ContinuousBatchingScheduler(cfg, params4, stop_ids=resolve_stop_ids(cfg, tok),
                                        kv_quant="int8", device="cuda", **SCHED)
    svc = GenerationService()
    svc.register("duckdb-nsql", SchedulerBackend(sched, tok, max_new_tokens=MAX_NEW))
    try:
        return observability(torch, svc, "duckdb-nsql", sched, "paged_int4_int8")
    finally:
        svc.close()
        del sched
        torch.cuda.empty_cache()


def quantized_serve(torch, engines, profile=False):
    """The quantized serving path: DUCKDB_NSQL_7B at full width and depth
    with int4 block weights quantized on the card from the seed-0 bf16 tree,
    and the int8 KV cache, behind an EngineBackend and a paged
    SchedulerBackend. Exact launch counts, prefill logits kernel vs plain,
    prefix sharing with no leaked page, the live int8 pool's decode step.
    Returns the launch counts per path and the int4 tree."""
    from concurrent.futures import ThreadPoolExecutor

    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
        set_attention_impl,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_params_int4,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        EngineBackend,
        GenerationService,
        SchedulerBackend,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = engines["duckdb-nsql"].cfg
    n_layers = cfg.num_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params4 = quantize_params_int4(engines["duckdb-nsql"].params)
    torch.cuda.synchronize()
    q4_bytes = sum(w[k].numel() * w[k].element_size()
                   for w in params4["blocks"].values() if isinstance(w, dict)
                   for k in ("q4", "s4"))
    print(f"  {cfg.name}: block weights quantized to int4 on the card in "
          f"{time.perf_counter() - t0:.1f} s ({q4_bytes / 2**30:.2f} GiB of nibbles "
          f"and scales); {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)

    stop_ids = resolve_stop_ids(cfg, tok)
    eng = InferenceEngine(cfg, params4, device="cuda", stop_ids=stop_ids, kv_quant="int8")
    backend = EngineBackend(eng, tok, max_new_tokens=MAX_NEW)
    svc = GenerationService()
    svc.register("duckdb-nsql", backend)
    expected = dict.fromkeys(LAUNCHES, 0)

    def account(results, kind):
        st = eng.last_stats
        add_matmuls(expected, params4, n_layers, st["forward_calls"])
        expected["flash_gqa_prefill"] += n_layers
        expected["flash_gqa_decode_quantized"] += n_layers * st["decode_steps"]
        for r in results:
            dec_s = r.latency_s - r.ttft_s
            rate = (r.output_tokens - 1) / dec_s if r.output_tokens > 1 and dec_s > 0 else 0.0
            print("  " + json.dumps(dict(
                model="duckdb-nsql", weights="int4", kv="int8", path="engine",
                kind=kind, prompt_tokens=r.prompt_tokens, padded_prompt=st["prompt_len"],
                batch=st["batch"], output_tokens=r.output_tokens,
                latency_s=round(r.latency_s, 4), ttft_s=round(r.ttft_s, 4),
                decode_tok_per_s=round(rate, 1))), flush=True)

    torch.cuda.synchronize()
    reset_launches()
    for qn in QUESTIONS[:2]:
        account([svc.generate("duckdb-nsql", qn, system=SYSTEM_SQL)], "generate")
    account(svc.generate_batch("duckdb-nsql", BATCH, system=SYSTEM_SQL), "generate_batch")
    torch.cuda.synchronize()
    engine_launches = dict(LAUNCHES)
    print(f"  engine launches {engine_launches} expected {expected}", flush=True)
    assert engine_launches == expected, f"launch counts {engine_launches} != {expected}"
    for k in ("int4_matmul", "flash_gqa_prefill", "flash_gqa_decode_quantized"):
        assert engine_launches[k] > 0, f"the quantized engine path never launched {k}"

    # Prefill logits of the first request through the kernels (the int4
    # tensor-core launch and the flash prefill) vs the plain versions.
    ids = tok.encode(f"{SYSTEM_SQL}\n\n{QUESTIONS[0]}")
    t = eng.padded_prompt_len(len(ids))
    tokens = torch.tensor([ids + [0] * (t - len(ids))], dtype=torch.int32, device="cuda")
    pos = torch.arange(t, dtype=torch.int32, device="cuda")[None]
    last = torch.tensor([len(ids) - 1], device="cuda")
    with torch.inference_mode():
        lk, _ = forward(cfg, params4, tokens, pos, logit_indices=last)
        set_attention_impl("plain")
        lp, _ = forward(cfg, params4, tokens, pos, logit_indices=last)
        set_attention_impl("auto")
    assert lk.shape == (1, 1, cfg.vocab_size) and torch.isfinite(lk).all()
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    print(f"  7B int4 prefill logits kernel vs plain: max|diff|/max|logit| = {rel:.3e} "
          f"(tol {LOGIT_TOL:.0e}); argmax equal: {int(lk.argmax()) == int(lp.argmax())}",
          flush=True)
    assert rel <= LOGIT_TOL
    del svc, backend, eng

    sched = ContinuousBatchingScheduler(cfg, params4, stop_ids=stop_ids, kv_quant="int8",
                                        device="cuda", **SCHED)
    sb = SchedulerBackend(sched, tok, max_new_tokens=MAX_NEW)
    svc = GenerationService()
    svc.register("duckdb-nsql", sb)
    st = sched.page_stats
    print(f"  int8 pool of {st['pages_total']} pages x {st['page_bytes'] / 2**20:.1f} MiB, "
          f"{sched.num_slots} slots, max_seq {sched.max_seq}", flush=True)
    torch.cuda.synchronize()
    reset_launches()
    r0, p0 = sched.rounds_issued, sched.prefill_forwards
    results = []
    t0 = time.perf_counter()
    for qn in SCHED_SQL[:2]:
        results.append(("sequential", svc.generate("duckdb-nsql", qn, system=SYSTEM_SQL)))
    t_burst = time.perf_counter()
    with ThreadPoolExecutor(max_workers=6) as pool:
        futs = [pool.submit(svc.generate, "duckdb-nsql", qn, SYSTEM_SQL)
                for qn in SCHED_SQL[2:]]
        results += [("concurrent", f.result()) for f in futs]
    t_end = time.perf_counter()
    stats = wait_idle(sched)
    torch.cuda.synchronize()
    sched_launches = dict(LAUNCHES)
    rounds, prefills = sched.rounds_issued - r0, sched.prefill_forwards - p0
    want = dict.fromkeys(LAUNCHES, 0)
    expect_paged(want, sched, rounds, prefills)
    for kind, r in results:
        dec_s = r.latency_s - r.ttft_s
        rate = (r.output_tokens - 1) / dec_s if r.output_tokens > 1 and dec_s > 0 else 0.0
        print("  " + json.dumps(dict(
            model="duckdb-nsql", weights="int4", kv="int8", path="scheduler", kind=kind,
            prompt_tokens=r.prompt_tokens, output_tokens=r.output_tokens,
            latency_s=round(r.latency_s, 4), ttft_s=round(r.ttft_s, 4),
            decode_tok_per_s=round(rate, 1))), flush=True)
    burst = sum(r.output_tokens for kind, r in results if kind == "concurrent")
    total = sum(r.output_tokens for _, r in results)
    print(f"  {rounds} decode rounds, {prefills} prefill forwards; pages {stats}; "
          f"prefix {sched.prefix_stats}", flush=True)
    print(f"  aggregate: {total} tokens in {t_end - t0:.3f} s = "
          f"{total / (t_end - t0):.1f} tok/s; concurrent burst {burst} tokens in "
          f"{t_end - t_burst:.3f} s = {burst / (t_end - t_burst):.1f} tok/s", flush=True)
    print(f"  scheduler launches {sched_launches} expected {want}", flush=True)
    assert sched_launches == want, f"launch counts {sched_launches} != {want}"
    for k in ("int4_matmul", "flash_gqa_prefill", "ragged_paged_attention_quantized",
              "fused_page_write_quantized"):
        assert sched_launches[k] > 0, f"the quantized scheduler path never launched {k}"
    assert sched.prefix_stats["hits"] > 0, "the schema prefix never hit"
    assert stats["zero_copy_shares"] > 0, "no page was shared"
    if profile:
        def burst_fn():
            with ThreadPoolExecutor(max_workers=6) as pool:
                futs = [pool.submit(svc.generate, "duckdb-nsql", qn, SYSTEM_SQL)
                        for qn in SCHED_SQL[2:]]
                return sum(f.result().output_tokens for f in futs)

        phase("profile (quantized scheduler path)")
        r1 = sched.rounds_issued
        profile_device(torch, "six concurrent int4/int8 7B scheduler requests", burst_fn)
        print(f"  {sched.rounds_issued - r1} decode rounds of {sched.decode_chunk} steps",
              flush=True)
        wait_idle(sched)
    sb.shutdown()
    sched._page_alloc.check()
    st = sched.page_stats
    assert st["pages_in_use"] == st["prefix_resident_pages"], f"leaked pages: {st}"
    live_pool_logits(torch, sched)
    del svc, sb, sched
    torch.cuda.empty_cache()

    # The contiguous layout over the int8 cache: 8 slots x 4096.
    sched = ContinuousBatchingScheduler(cfg, params4, num_slots=8, decode_chunk=8,
                                        stop_ids=stop_ids, kv_quant="int8", device="cuda")
    assert sched.kv_layout == "contiguous" and sched.max_seq == cfg.max_seq_len
    sb = SchedulerBackend(sched, tok, max_new_tokens=MAX_NEW)
    svc = GenerationService()
    svc.register("duckdb-nsql", sb)
    print(f"  contiguous int8 cache of {sched.num_slots} slots x {sched.max_seq}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    torch.cuda.synchronize()
    reset_launches()
    r0, p0 = sched.rounds_issued, sched.prefill_forwards
    results, walls = send_traffic(svc)
    wait_settled(sched)
    torch.cuda.synchronize()
    contig_launches = dict(LAUNCHES)
    rounds, prefills = sched.rounds_issued - r0, sched.prefill_forwards - p0
    want = dict.fromkeys(LAUNCHES, 0)
    expect_contiguous(want, sched, rounds, prefills)
    print(f"  {rounds} decode rounds, {prefills} prefill forwards; "
          f"prefix {sched.prefix_stats}", flush=True)
    report_traffic(results, walls, weights="int4", kv="int8", layout="contiguous")
    print(f"  contiguous scheduler launches {contig_launches} expected {want}", flush=True)
    assert contig_launches == want, f"launch counts {contig_launches} != {want}"
    for k in ("int4_matmul", "flash_gqa_prefill", "flash_gqa_decode_quantized"):
        assert contig_launches[k] > 0, f"the quantized contiguous path never launched {k}"
    assert sched.prefix_stats["hits"] > 0, "the schema prefix never hit"
    sb.shutdown()
    live_cache_logits(torch, sched)
    return {"engine": engine_launches, "scheduler": sched_launches,
            "contiguous": contig_launches}, params4


# ------------------------------------------------------ constrained decoding


def grammar(name, tok, stop_ids):
    """The compiled grammar `name` of GRAMMAR_SPECS over `tok` and
    `stop_ids` (compiled once a process, by constrain's cache)."""
    from llm_based_apache_spark_optimization_tpu_torch.constrain import get_constraint

    return get_constraint(GRAMMAR_SPECS[name], tok, stop_ids)


def compile_grammars(torch, cfg, smi):
    """Compile GRAMMAR_SPECS over the ByteTokenizer and the 7B stop ids,
    move their tables to the card, and print their sizes beside the card."""
    from llm_based_apache_spark_optimization_tpu_torch.constrain import table_bytes
    from llm_based_apache_spark_optimization_tpu_torch.serve import resolve_stop_ids
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    stops = resolve_stop_ids(cfg, tok)
    for name in GRAMMAR_SPECS:
        t0 = time.perf_counter()
        c = grammar(name, tok, stops)
        secs = time.perf_counter() - t0
        nbytes = table_bytes(c.device_tables(cfg.vocab_size, "cuda"))
        print(f"  grammar {name}: {c.num_states} states x {c.tok_vocab} ids, "
              f"min_new_tokens {c.min_new_tokens}, compiled on the host in {secs:.1f} s; "
              f"device tables (next, need) {nbytes} bytes = {nbytes / 2**20:.1f} MiB "
              f"on {smi}", flush=True)


class GrammarTally:
    """Every constrained completion the run checked (label, ok) and every
    unconstrained control completion (label, parses): the summary holds the
    first at 100% and the second below it."""

    def __init__(self):
        self.constrained = []
        self.control = []

    def control_text(self, label, text):
        from llm_based_apache_spark_optimization_tpu_torch.constrain import (
            is_valid_spark_sql,
        )

        self.control.append((label, is_valid_spark_sql(text)))

    def summary(self):
        n, ok = len(self.constrained), sum(v for _, v in self.constrained)
        m, parsed = len(self.control), sum(v for _, v in self.control)
        labels = sorted({lb for lb, _ in self.constrained})
        print(f"  constrained completions parsing: {ok} of {n} ({100.0 * ok / max(1, n):.1f}%) "
              f"over {labels}; unconstrained control parsing: {parsed} of {m} "
              f"({100.0 * parsed / max(1, m):.1f}%)", flush=True)
        assert n and ok == n, "a constrained completion failed its grammar checks"
        assert m and parsed < m, "the unconstrained control parsed at 100%"


def schema_names(text, spec):
    """The identifiers of `text` outside string literals that are neither
    reserved words nor aliases (the word after AS) nor `spec`'s columns or
    table, case-insensitively: empty for a schema-constrained completion."""
    import re

    from llm_based_apache_spark_optimization_tpu_torch.constrain import RESERVED

    allowed = {c.lower() for c in spec["columns"]} | {spec["table"].lower()}
    reserved = {w.lower() for w in RESERVED}
    words = re.findall(r"[A-Za-z_][A-Za-z0-9_]*", re.sub(r"'[^']*'", "''", text))
    return [w for i, w in enumerate(words)
            if w.lower() not in reserved | allowed
            and not (i and words[i - 1].lower() == "as")]


def check_constrained(tally, label, c, spec, out, budget, stop_ids, tok):
    """Hold one constrained completion `out` (token ids, its stop id kept
    by the engine or stripped by the scheduler) to its grammar: it ends at
    a stop id within `budget`, every token stays in the language (`walk`
    over the tokens and the stop id), the text parses under the port's
    `parse_spark_sql`, and under a schema grammar it names only the
    schema's columns and table. Fatal on failure. Returns the text."""
    from llm_based_apache_spark_optimization_tpu_torch.constrain import parse_spark_sql

    body = out[:-1] if out and out[-1] in stop_ids else out
    used = len(body) + 1  # the stop id is spent from the budget too
    text = tok.decode(body)
    walked = c.walk(list(body) + [c.eos_ids[0]]) is not None
    try:
        parse_spark_sql(text)
        parsed = True
    except ValueError:
        parsed = False
    strays = schema_names(text, spec) if isinstance(spec, dict) else []
    ok = used <= budget and walked and parsed and not strays
    tally.constrained.append((label, ok))
    assert ok, (f"{label}: constrained completion {text!r} ({len(body)} tokens, budget "
                f"{budget}): stop within budget {used <= budget}, walk {walked}, parses "
                f"{parsed}, names outside the schema {strays}")
    return text


def constrained_engine(torch, engines, tally, smi):
    """Phase 12 (a): the 7B engine (bf16 weights, contiguous cache) under
    each grammar: the three NL->SQL prompts as one batch, greedy, MAX_NEW
    new tokens; the same batch unconstrained (the control, and the
    unconstrained step wall of the same call); one schema request at
    max_new_tokens == min_new_tokens; one schema request over the int8
    cache; the unconstrained batch again (its step wall beside the first).
    Launch counts exact. Returns them."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng = engines["duckdb-nsql"]
    cfg, n_layers, stops = eng.cfg, eng.cfg.num_layers, eng.stop_ids
    eng8 = InferenceEngine(cfg, eng.params, device="cuda", stop_ids=stops, kv_quant="int8")
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in QUESTIONS]
    expected = dict.fromkeys(LAUNCHES, 0)

    def run(engine, ps, budget, c):
        t0 = time.perf_counter()
        out = engine.generate(ps, max_new_tokens=budget, constraint=c)
        wall = time.perf_counter() - t0
        st = engine.last_stats
        expected["flash_gqa_prefill"] += n_layers
        decode = "flash_gqa_decode_quantized" if engine.kv_quant else "flash_gqa_decode"
        expected[decode] += n_layers * st["decode_steps"]
        step_ms = 1e3 * (wall - st["ttft_s"]) / max(1, st["decode_steps"])
        return out, step_ms, st["decode_steps"]

    torch.cuda.synchronize()
    reset_launches()
    walls = {}
    free, walls["unconstrained"], steps = run(eng, prompts, MAX_NEW, None)
    walls["unconstrained"] = (walls["unconstrained"], steps)
    for out in free:
        tally.control_text("engine", tok.decode(out))
    for name, spec in GRAMMAR_SPECS.items():
        c = grammar(name, tok, stops)
        outs, ms, steps = run(eng, prompts, MAX_NEW, c)
        walls[name] = (ms, steps)
        for out in outs:
            text = check_constrained(tally, "engine", c, spec, out, MAX_NEW, stops, tok)
            print(f"    engine {name}: {text!r}", flush=True)
    c = grammar("schema", tok, stops)
    (out,), _, _ = run(eng, prompts[:1], c.min_new_tokens, c)
    text = check_constrained(tally, "engine_min_new", c, GRAMMAR_SPECS["schema"], out,
                             c.min_new_tokens, stops, tok)
    print(f"    engine schema at max_new_tokens == min_new_tokens == {c.min_new_tokens}: "
          f"{text!r}", flush=True)
    (out,), _, _ = run(eng8, prompts[1:2], MAX_NEW, c)
    text = check_constrained(tally, "engine_int8", c, GRAMMAR_SPECS["schema"], out,
                             MAX_NEW, stops, tok)
    print(f"    engine schema over the int8 cache: {text!r}", flush=True)
    _, ms, steps = run(eng, prompts, MAX_NEW, None)  # the free batch again, last
    walls["unconstrained, again"] = (ms, steps)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print("  engine decode step wall, batch of 3, 7B bf16: " + ", ".join(
        f"{k} {ms:.3f} ms ({n} steps)" for k, (ms, n) in walls.items()) + f" on {smi}",
        flush=True)
    print(f"  launches {launches} expected {expected}", flush=True)
    assert launches == expected, f"launch counts {launches} != {expected}"
    return launches


def constrained_scheduler(torch, cfg, params, tally, kv_quant=None):
    """Phase 12 (b) and (c): the 7B paged scheduler with ragged mixed rounds
    (phase 6's settings; bf16 weights over the bf16 pool, or int4 weights
    over the int8 pool) serves six requests at once: two under the generic
    grammar, one free, two under the schema grammar, one free. The schema
    requests wait for the generic ones to drain, then the tables swap: the
    swap count must equal the grammar changes of the submission order (2).
    Launch counts exact; no leaked page. Returns the launches."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    stops = resolve_stop_ids(cfg, tok)
    plan = ["generic", "generic", None, "schema", "schema", None]
    changes = sum(1 for i, g in enumerate(plan)
                  if g and g != next((h for h in reversed(plan[:i]) if h), None))
    constraints = [grammar(g, tok, stops) if g else None for g in plan]
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in SCHED_SQL[2:]]
    sched = ContinuousBatchingScheduler(cfg, params, stop_ids=stops, ragged=True,
                                        kv_quant=kv_quant, device="cuda", **SCHED).start()
    label = "scheduler_int4_int8" if kv_quant else "scheduler"
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs = burst(sched, prompts, MAX_NEW, constraints)
        wall = time.perf_counter() - t0
        stats = wait_idle(sched)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        sched.shutdown()
    want = dict.fromkeys(LAUNCHES, 0)
    expect_paged(want, sched, sched.rounds_issued, sched.prefill_forwards)
    for g, c, out in zip(plan, constraints, outs):
        if c is None:
            tally.control_text(label, tok.decode(out))
            continue
        text = check_constrained(tally, label, c, GRAMMAR_SPECS[g], out, MAX_NEW, stops, tok)
        print(f"    {label} {g}: {text!r}", flush=True)
    print(f"  {label}: six requests in {wall:.3f} s, {sched.rounds_issued} rounds "
          f"({sched.mixed_rounds} mixed, {sched.ragged_prefills} ragged prefills); "
          f"grammar swaps {sched.grammar_swaps} for {changes} grammar changes; tokens "
          f"{[len(o) for o in outs]}; pages {stats}", flush=True)
    print(f"  launches {launches} expected {want}", flush=True)
    assert launches == want, f"launch counts {launches} != {want}"
    assert sched.grammar_swaps == changes == 2, "grammar swaps != grammar changes"
    sched._page_alloc.check()
    st = sched.page_stats
    assert st["pages_in_use"] == st["prefix_resident_pages"], f"leaked pages: {st}"
    return launches


def constrained_app(torch, scheds, tally, smi):
    """Phase 8 (b): `LSOT_CONSTRAIN_SQL=1`: the port's app over the
    contiguous schedulers compiles the uploaded CSV's columns and the view
    into the SQL model's grammar (the SQL model behind a ByteTokenizer
    backend: the grammar's tables are the tokenizer's width). Two
    `POST /process-data/` one after the other under `sql:schema:1` (every
    execution fails typed, so each request runs the repair loop's two
    regenerations through the grammar, then the 3B explanation), then two
    from threads without it; each SQL generate must pass the grammar
    checks against the CSV's schema; a body is the success or the failure
    shape of tests/test_app.py. Then `/api/generate` with
    `constrain: "spark_sql"` answers 200 with SQL that parses. Launch
    counts exact. Returns them."""
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig, create_api_app
    from llm_based_apache_spark_optimization_tpu_torch.constrain import (
        is_valid_spark_sql,
        table_bytes,
    )
    from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        GenerationService,
        SchedulerBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    generated = []
    lock = threading.Lock()
    tok = ByteTokenizer()
    sql_backend = SchedulerBackend(scheds["duckdb-nsql"], tok, max_new_tokens=MAX_NEW)

    class RecordingService(GenerationService):
        def generate(self, model, prompt, *a, **kw):
            res = super().generate(model, prompt, *a, **kw)
            with lock:
                generated.append((model, kw.get("constrain"), res))
            return res

    svc = RecordingService()
    svc.register("duckdb-nsql", sql_backend)
    svc.register("llama3.2", SchedulerBackend(scheds["llama3.2"], ByteModTokenizer(),
                                              max_new_tokens=MAX_NEW, add_bos=False),
                 template="llama3-chat")
    before = os.environ.get("LSOT_CONSTRAIN_SQL")
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "input"))
        with open(os.path.join(root, "input", "taxi.csv"), "w") as f:
            f.write(CSV)
        os.environ["LSOT_CONSTRAIN_SQL"] = "1"
        try:
            cfg = AppConfig.from_env(input_dir=os.path.join(root, "input"),
                                     output_dir=os.path.join(root, "output"),
                                     history_db=":memory:", max_new_tokens=MAX_NEW)
        finally:
            if before is None:
                os.environ.pop("LSOT_CONSTRAIN_SQL")
            else:
                os.environ["LSOT_CONSTRAIN_SQL"] = before
        assert cfg.constrain_sql
        client = create_api_app(svc, SQLiteBackend, SQLiteHistory(":memory:"),
                                cfg).test_client()

        def post(qn):
            t = time.perf_counter()
            res = client.post_json("/process-data/", {"input_text": qn, "file_name": "taxi.csv"})
            return res, time.perf_counter() - t

        torch.cuda.synchronize()
        reset_launches()
        start = {n: (sc.rounds_issued, sc.prefill_forwards) for n, sc in scheds.items()}
        FAULTS.configure("sql:schema:1", 0)
        try:
            responses = [post(qn) for qn in APP_QUESTIONS[:2]]
        finally:
            FAULTS.clear()
        with ThreadPoolExecutor(max_workers=2) as pool:
            responses += list(pool.map(post, APP_QUESTIONS[2:4]))
        gen = client.post_json("/api/generate", {"model": "duckdb-nsql",
                                                 "prompt": STREAM_PROMPT,
                                                 "constrain": "spark_sql"})
        for sc in scheds.values():
            wait_settled(sc)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    expected = dict.fromkeys(LAUNCHES, 0)
    for n, sc in scheds.items():
        expect_contiguous(expected, sc, sc.rounds_issued - start[n][0],
                          sc.prefill_forwards - start[n][1])
    columns = CSV.splitlines()[0].split(",")
    spec = {"table": cfg.view_name, "columns": columns}
    c = sql_backend._resolve_constraint(spec)
    nbytes = table_bytes(c.device_tables(scheds["duckdb-nsql"].cfg.vocab_size, "cuda"))
    print(f"  the CSV's grammar: {c.num_states} states x {c.tok_vocab} ids, min_new_tokens "
          f"{c.min_new_tokens}; installed device tables {nbytes} bytes = "
          f"{nbytes / 2**20:.1f} MiB on {smi}", flush=True)
    sql_gens = [(con, r) for m, con, r in generated if m == "duckdb-nsql"]
    for con, r in sql_gens:
        assert con in (spec, "spark_sql"), f"an SQL generate ran with constrain={con!r}"
        cc = c if con == spec else sql_backend._resolve_constraint(con)
        # The backend strips the stop id: the text re-encodes to the tokens.
        check_constrained(tally, "app", cc, con, tok.encode(r.response, add_bos=False),
                          MAX_NEW, cc.eos_ids, tok)
    for i, (res, t) in enumerate(responses):
        body = res.json()
        print("  " + json.dumps(dict(status=res.status, wall_s=round(t, 4),
                                     sql=body.get("sql_query"), keys=sorted(body))),
              flush=True)
        assert res.status == 200, body
        if i < 2:  # under sql:schema:1 every execution failed
            assert body.get("error") == "SQL execution failed", body
        assert set(body) in ({"error", "sql_query", "error_details"},
                             {"message", "input_file_name", "input_data", "sql_query",
                              "output_file"}), body
    reply = gen.json()
    print(f"  /api/generate constrain=spark_sql: {gen.status} {reply.get('response')!r}",
          flush=True)
    assert gen.status == 200 and is_valid_spark_sql(reply["response"]), reply
    repairs = sum(con == spec for con, _ in sql_gens) - len(responses)
    print(f"  {len(sql_gens)} constrained SQL generates ({len(responses)} requests, "
          f"{repairs} repair regenerations, one /api/generate); launches {launches} "
          f"expected {expected}", flush=True)
    assert repairs >= 4, "the repair loop did not regenerate through the grammar"
    assert launches == expected, f"launch counts {launches} != {expected}"
    return launches


def constrained_paths(torch, engines, params4, tally, smi):
    """Phase 12: (a) the 7B engine, (b) the 7B paged ragged scheduler over
    the bf16 pool and, given the int4 tree `params4`, (c) the same over the
    int8 pool with int4 weights, each under the grammars. Returns the
    launches per path."""
    cfg = engines["duckdb-nsql"].cfg
    phase("constrained decoding (a): the engine, bf16 and int8 cache")
    out = {"constrained_engine": constrained_engine(torch, engines, tally, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    phase("constrained decoding (b): the paged ragged scheduler, bf16 pool")
    out["constrained_scheduler"] = constrained_scheduler(
        torch, cfg, engines["duckdb-nsql"].params, tally)
    gc.collect()
    torch.cuda.empty_cache()
    if params4 is not None:
        phase("constrained decoding (c): the paged ragged scheduler, int4 weights, "
              "int8 pool")
        out["constrained_scheduler_int4_int8"] = constrained_scheduler(
            torch, cfg, params4, tally, kv_quant="int8")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ checkpoints

HF_LAYERS = 4  # DUCKDB_NSQL_7B's HF file in f32 is 27 GB at full depth
BURST_SWITCH_S = 0.5  # GIL switch interval while a burst is submitted


def leaves(tree, prefix=""):
    """{dotted name: tensor} of a params tree (int4 packs included)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def assert_trees_equal(torch, got, want, label):
    a, b = leaves(got), leaves(want)
    assert sorted(a) == sorted(b), f"{label}: leaves {sorted(a)} != {sorted(b)}"
    bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    assert not bad, f"{label}: {bad} differ"
    return len(a)


def q4_0_round_trip(torch, w, transpose):
    """One parameter through q4_0 and back, on the card: the GGUF file's
    layout (torch-Linear [out, in] when `transpose`), blocks of 32 along
    its last axis, the llama.cpp q4_0 arithmetic of `write_gguf` (d = the
    block's signed absmax / -8 in f16, q = round(x / d) + 8 in [0, 15]),
    dequantized as the reader does (d * (q - 8) in f32), then bf16. A Q/K
    row permutation moves whole rows, so it does not change the blocks."""
    x = (w.transpose(-1, -2) if transpose else w).float().contiguous()
    b = x.reshape(-1, 32)
    m = b.gather(1, b.abs().argmax(dim=1, keepdim=True))  # first maximum
    d = (m / -8.0).half().float()
    q = torch.clamp(torch.round(b / torch.where(d == 0, torch.ones_like(d), d)) + 8, 0, 15)
    out = (d * (q - 8)).reshape(x.shape)
    return (out.transpose(-1, -2) if transpose else out).to(torch.bfloat16).contiguous()


def q4_0_tree(torch, cfg, params):
    """The direct q4_0 -> f32 -> bf16 round trip of a bf16 tree: every
    matmul weight and the embedding quantized, norms kept (f32 in the file,
    exact for bf16 values), one layer at a time."""
    out = {"embed": q4_0_round_trip(torch, params["embed"], False),
           "final_norm": params["final_norm"].clone(), "blocks": {}}
    if not cfg.tie_embeddings:
        out["lm_head"] = q4_0_round_trip(torch, params["lm_head"], False)
    for k, w in params["blocks"].items():
        out["blocks"][k] = (w.clone() if k.startswith("ln_") else torch.stack(
            [q4_0_round_trip(torch, w[i], True) for i in range(w.shape[0])]))
    return out


def sequential_tokens(scheduler, prompts):
    """Greedy tokens of each prompt, submitted one after the other."""
    return [scheduler.submit(p, max_new_tokens=MAX_NEW).result(timeout=300)
            for p in prompts]


def counted_traffic(torch, svc, incarnations, label, err_model=None, sql_model=None):
    """Phase 6's traffic through `svc` in a counted window: launches zeroed
    just before, read just after, and held to each scheduler incarnation's
    arithmetic (`incarnations`: a callable returning the live inner
    schedulers, whose counters are read before and after)."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )

    torch.cuda.synchronize()
    reset_launches()
    start = {id(s): (s.rounds_issued, s.prefill_forwards) for s in incarnations()}
    results, walls = send_traffic(svc, sql_model=sql_model or "duckdb-nsql",
                                  err_model=err_model)
    for s in incarnations():
        wait_settled(s)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    expected = dict.fromkeys(LAUNCHES, 0)
    for s in incarnations():
        r0, p0 = start.get(id(s), (0, 0))
        expect_contiguous(expected, s, s.rounds_issued - r0, s.prefill_forwards - p0)
    report_traffic(results, walls, path=label)
    print(f"  {label} launches {launches} expected {expected}", flush=True)
    assert launches == expected, f"{label}: launch counts {launches} != {expected}"
    for r in (r for _, _, r in results):
        assert r.output_tokens > 0 and r.ttft_s > 0
    return launches


#: Layers of phase 10 (a)'s 3B Q4_0 blob (of 28): cut for the run's time
#: when phase 20 came.
GGUF_LAYERS = 7


def gguf_serve(torch, engines, root):
    """(a) GGUF, the reference's deployment format, at full width and
    GGUF_LAYERS of its 28 layers:
    LLAMA32_3B's seed-0 bf16 tree written as a Q4_0 blob by the port's
    `write_gguf` and read once by `load_gguf_checkpoint`: the loaded tree
    must equal the direct round trip of the seed tree bit for bit. The
    backend is built over that tree by the constructor `from_gguf` calls
    (`SchedulerBackend._from_checkpoint(quantize_int4=True,
    kv_quant="int8", supervise=True)`: contiguous, 8 slots, max_seq 8192;
    `from_gguf`'s read of a blob runs in (d), 14 (e) and 16 (b)), and
    requests through it must give the tokens of a backend built from the
    round trip in memory. Returns (launches, blob)."""
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
        load_gguf_checkpoint,
        write_gguf,
    )
    from llm_based_apache_spark_optimization_tpu_torch.models.configs import (
        RopeFreqFactors,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_params_int4,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        GenerationService,
        SchedulerBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    base = engines["llama3.2"]
    cfg = dataclasses.replace(base.cfg, num_layers=GGUF_LAYERS)
    seed = {**{k: v for k, v in base.params.items() if k != "blocks"},
            "blocks": {k: v[:GGUF_LAYERS] for k, v in base.params["blocks"].items()}}
    path = os.path.join(root, "llama3.2-3b.q4_0.gguf")
    t0 = time.perf_counter()
    write_gguf(cfg, seed, path, quant="q4_0")
    print(f"  {cfg.name}: {cfg.num_layers} layers written as Q4_0 in "
          f"{time.perf_counter() - t0:.1f} s, {os.path.getsize(path) / 2**30:.2f} GiB",
          flush=True)
    t0 = time.perf_counter()
    lcfg, loaded = load_gguf_checkpoint(path, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    assert isinstance(lcfg.rope_scaling, RopeFreqFactors) and lcfg.tie_embeddings
    assert (lcfg.num_layers, lcfg.hidden_size, lcfg.vocab_size, lcfg.max_seq_len) == (
        cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.max_seq_len)
    ref = q4_0_tree(torch, cfg, seed)
    n = assert_trees_equal(torch, loaded, ref, "GGUF load vs q4_0 round trip")
    print(f"  loaded in {t_load:.1f} s; {n} leaves equal the direct q4_0 -> f32 -> "
          f"bf16 round trip of the seed tree bit for bit", flush=True)

    t0 = time.perf_counter()
    sb = SchedulerBackend._from_checkpoint(
        lambda dtype, device: (lcfg, loaded), os.path.basename(path), tok,
        quantize_int4=True, kv_quant="int8", supervise=True, num_slots=8,
        decode_chunk=8, device="cuda", max_new_tokens=MAX_NEW)
    del loaded
    torch.cuda.synchronize()
    sup = sb.scheduler
    assert isinstance(sup, SupervisedScheduler)
    inner = sup._inner
    assert (inner.kv_layout, inner.kv_quant, inner.num_slots, inner.max_seq) == (
        "contiguous", "int8", 8, cfg.max_seq_len)
    params4 = quantize_params_int4(ref)
    del ref
    assert_trees_equal(torch, inner.params, params4, "int4 trees of the loaded and "
                       "the round-trip weights")
    print(f"  the backend (quantize_int4, kv int8, supervised) over the loaded tree in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB allocated", flush=True)
    refsched = ContinuousBatchingScheduler(lcfg, params4, num_slots=8, decode_chunk=8,
                                           stop_ids=inner.stop_ids, kv_quant="int8",
                                           device="cuda").start()
    prompts = [tok.encode(f"{SYSTEM_ERR}\n\n{ERROR_PROMPT}"),
               tok.encode(f"{SYSTEM_SQL}\n\n{QUESTIONS[0]}"),
               tok.encode(f"{SYSTEM_SQL}\n\n{QUESTIONS[1]}")]
    want = sequential_tokens(refsched, prompts)
    got = sequential_tokens(sup, prompts)
    refsched.shutdown()
    del refsched, params4
    print(f"  greedy tokens through the loaded backend vs the in-memory round-trip "
          f"backend: {[len(g) for g in got]} tokens, equal: {got == want}", flush=True)
    assert got == want, "the GGUF-loaded backend's tokens differ from the round trip's"

    svc = GenerationService()
    svc.register("llama3.2", sb)
    launches = counted_traffic(torch, svc, lambda: [sup._inner],
                               "gguf_3b_int4_int8", sql_model="llama3.2")
    for k in ("int4_matmul", "flash_gqa_prefill", "flash_gqa_decode_quantized"):
        assert launches[k] > 0, f"the GGUF path never launched {k}"
    assert sup.health()["state"] == "ready" and sup.health()["restarts"] == 0
    sb.shutdown()
    del svc, sb, sup, inner
    gc.collect()
    torch.cuda.empty_cache()
    return launches, path


def hf_serve(torch, engines, root):
    """(b) HF safetensors at full width: DUCKDB_NSQL_7B cut to HF_LAYERS
    layers, written in f32 by the port's `save_hf_checkpoint`, loaded by
    `SchedulerBackend.from_hf_checkpoint(supervise=True)` (bf16,
    contiguous, 8 slots, max_seq 4096). The loaded tree must equal the seed
    tree bit for bit (bf16 -> f32 -> bf16 is exact). Returns (launches,
    backend, directory)."""
    import dataclasses
    import shutil

    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
        save_hf_checkpoint,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        GenerationService,
        SchedulerBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    base = engines["duckdb-nsql"]
    cfg = dataclasses.replace(base.cfg, num_layers=HF_LAYERS)
    seed = {**{k: v for k, v in base.params.items() if k != "blocks"},
            "blocks": {k: v[:HF_LAYERS] for k, v in base.params["blocks"].items()}}
    need = 4 * sum(t.numel() for t in leaves(seed).values())
    free = shutil.disk_usage(root).free
    print(f"  disk: {free / 2**30:.1f} GiB free under the temporary directory, "
          f"{need / 2**30:.2f} GiB to write", flush=True)
    assert free > 2 * need, "not enough disk for the HF checkpoint"
    d = os.path.join(root, "duckdb-nsql-7b")
    t0 = time.perf_counter()
    save_hf_checkpoint(cfg, seed, d)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"  {cfg.name} at {HF_LAYERS} of {base.cfg.num_layers} layers written as "
          f"f32 safetensors in {time.perf_counter() - t0:.1f} s, {size / 2**30:.2f} GiB",
          flush=True)
    t0 = time.perf_counter()
    sb = SchedulerBackend.from_hf_checkpoint(d, tok, supervise=True, num_slots=8,
                                             decode_chunk=8, device="cuda",
                                             max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    inner = sb.scheduler._inner
    assert (inner.kv_layout, inner.kv_quant, inner.max_seq) == (
        "contiguous", None, base.cfg.max_seq_len)
    n = assert_trees_equal(torch, inner.params, seed, "HF load vs the seed tree")
    print(f"  from_hf_checkpoint(supervised) in {time.perf_counter() - t0:.1f} s; "
          f"{n} leaves equal the seed tree bit for bit", flush=True)
    svc = GenerationService()
    svc.register("duckdb-nsql", sb)
    launches = counted_traffic(torch, svc, lambda: [sb.scheduler._inner], "hf_7b_bf16")
    for k in ("flash_gqa_prefill", "flash_gqa_decode"):
        assert launches[k] > 0, f"the HF path never launched {k}"
    return launches, sb, d


def supervised_crash(torch, sb):
    """(c) The supervisor on the card, over (b)'s backend: a burst of six
    requests, and `sched:crash` armed once by the first streamed token (the
    next harvest kills the loop mid-batch). Every request must complete,
    health() go restarting -> ready with restarts 1 and lost 0, each token
    stream once, and each request's tokens equal those of the same burst on
    a fresh scheduler without the fault. The burst is submitted with a long
    GIL switch interval, so the worker admits all six at once in every run
    (the supervisor's replay submits them the same way), and its prompts
    share no prefix with earlier traffic: the three runs prefill the same
    groups of rows."""
    import threading

    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    tok = ByteTokenizer()
    sup = sb.scheduler
    factory = sup._factory
    incarnations = [sup._inner]

    def rebuild():
        FAULTS.clear()  # exactly one crash: the rebuilt loop runs clean
        s = factory()
        incarnations.append(s)
        return s

    sup._factory = rebuild
    prompts = [tok.encode(f"Burst request {i}. {SYSTEM_SQL}\n\n{q}")
               for i, q in enumerate(SCHED_SQL[2:])]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(BURST_SWITCH_S)
    try:
        ctl = factory().start()
        futs = [ctl.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        expected = [f.result(timeout=300) for f in futs]
        ctl.shutdown()
        del ctl

        seen, stamps, stop = [], [], threading.Event()

        def poll():
            while not stop.is_set():
                st = sup.health()["state"]
                if not seen or seen[-1] != st:
                    seen.append(st)
                    stamps.append(time.perf_counter())
                time.sleep(0.002)

        poller = threading.Thread(target=poll, daemon=True)
        streamed = [[] for _ in prompts]

        def tap(i):
            def on_token(tok_id):
                # The burst's first streamed token arms the crash: the next
                # harvest kills the loop before any request can finish.
                if not any(streamed):
                    FAULTS.configure("sched:crash:1", seed=0)
                streamed[i].append(tok_id)
            return on_token

        torch.cuda.synchronize()
        reset_launches()
        inner1 = incarnations[0]
        r0, p0 = inner1.rounds_issued, inner1.prefill_forwards
        t0 = time.perf_counter()
        futs = [sup.submit(p, max_new_tokens=MAX_NEW, idempotency_key=f"burst-{i}",
                           on_token=tap(i))
                for i, p in enumerate(prompts)]
        poller.start()  # after the burst is queued: it takes the supervisor's lock
        got = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(switch)
        FAULTS.clear()
    for s in incarnations[1:]:
        wait_settled(s)
    torch.cuda.synchronize()
    stop.set()
    poller.join(timeout=5)
    launches = dict(LAUNCHES)
    want = dict.fromkeys(LAUNCHES, 0)
    expect_contiguous(want, inner1, inner1.rounds_issued - r0, inner1.prefill_forwards - p0)
    for s in incarnations[1:]:  # rebuilt by the restart driver, which warms it
        expect_contiguous(want, s, s.rounds_issued, s.prefill_forwards)
        expect_warmup(want, s)
    h = sup.health()
    # restarting -> ready: teardown, backoff, rebuild, warmup and start.
    restart_s = next((round(b - a, 4) for a, b, x, y in zip(stamps, stamps[1:], seen, seen[1:])
                      if x == "restarting" and y == "ready"), None)
    _WARMUP["supervised_restart_s"] = restart_s
    print(f"  burst of {len(prompts)} with one sched:crash: {wall:.3f} s; health states "
          f"{seen}; restarting -> ready in {restart_s} s (the rebuild's warmup included); "
          f"restarts {h['restarts']}, replayed {h['replayed']}, lost {h['lost']}; "
          f"incarnations {len(incarnations)}", flush=True)
    print(f"  tokens {[len(g) for g in got]}; equal to the fault-free burst: "
          f"{got == expected}; streamed once each: {streamed == got}", flush=True)
    print(f"  supervised_crash launches {launches} expected {want}", flush=True)
    assert h["restarts"] == 1 and h["lost"] == 0 and h["state"] == "ready", h
    assert h["replayed"] == len(prompts), "a request finished before the crash"
    assert "restarting" in seen and seen[-1] == "ready", seen
    assert len(incarnations) == 2
    assert got == expected, "the replayed burst's tokens differ from the fault-free run"
    assert streamed == got, "a token was streamed twice or lost"
    assert launches == want, f"launch counts {launches} != {want}"
    return launches


def checkpoints(torch, engines, after_hf=None):
    """Phase 10 and 14 (e): the checkpoint paths, over files written in a
    temporary directory that is removed afterwards; `after_hf(hf_dir)`
    runs while the 4-layer 7B HF directory (with its tokenizer) exists.
    Returns the launch counts per path."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="lsot-checkpoints-")
    try:
        phase("checkpoint (a): GGUF Q4_0 3B -> one load, int4 + int8 KV, supervised")
        gguf_launches, blob = gguf_serve(torch, engines, root)
        phase("checkpoint (b): HF safetensors 7B -> from_hf_checkpoint, supervised")
        hf_launches, backend, hf_dir = hf_serve(torch, engines, root)
        phase("checkpoint (c): the supervisor, sched:crash mid-burst")
        crash_launches = supervised_crash(torch, backend)
        backend.shutdown()
        del backend
        gc.collect()
        torch.cuda.empty_cache()
        phase("checkpoint (d): the entry point, --backend checkpoint")
        try:
            import tokenizers  # noqa: F401
        except ImportError:
            print("checkpoint entry point: not run (no tokenizers package on this "
                  "machine)", flush=True)
        else:
            write_tokenizer(hf_dir)
            cut = cut_gguf(engines, root)
            entry_point(torch, ("--backend", "checkpoint", "--sql-model-path", hf_dir,
                                "--error-model-path", f"{cut}:{hf_dir}",
                                "--max-new-tokens", str(MAX_NEW)))
            phase("checkpoint (e), phase 14 (e): the entry point, --int8 --int8-unembed "
                  f"over the 3B Q4_0 blob at {ENTRY_3B_LAYERS} layers")
            entry_point(torch, ("--backend", "checkpoint", "--sql-model-path",
                                f"{cut}:{hf_dir}", "--int8", "--int8-unembed",
                                "--max-new-tokens", str(MAX_NEW)))
            phase("fleet (b), phase 16: the entry point's LSOT_MODELS checkpoint branch "
                  f"over the 7B HF directory and the 3B Q4_0 blob at {ENTRY_3B_LAYERS} "
                  "layers")
            fleet_entry_point(torch, hf_dir, cut)
            phase("remote worker (c), phase 18: `python -m ...serve.remote --from-hf` "
                  "over the 7B HF directory")
            _REMOTE["cli"] = remote_cli(torch, hf_dir)
            if after_hf is not None:
                after_hf(hf_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"gguf_3b_int4_int8": gguf_launches, "hf_7b_bf16": hf_launches,
            "supervised_crash": crash_launches}


#: Layers of the 3B Q4_0 blob the entry points of phase 10 (d), 14 (e) and
#: 16 (b) load: the whole blob costs ~15 s a process (the run's budget).
ENTRY_3B_LAYERS = 4


def cut_gguf(engines, root):
    """LLAMA32_3B's seed-0 tree cut to ENTRY_3B_LAYERS layers at full width,
    written as a Q4_0 blob by the port's `write_gguf`, for the entry-point
    processes. Returns its path."""
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import write_gguf

    base = engines["llama3.2"]
    cfg = dataclasses.replace(base.cfg, num_layers=ENTRY_3B_LAYERS)
    seed = {**{k: v for k, v in base.params.items() if k != "blocks"},
            "blocks": {k: v[:ENTRY_3B_LAYERS] for k, v in base.params["blocks"].items()}}
    path = os.path.join(root, f"llama3.2-3b-{ENTRY_3B_LAYERS}-layers.q4_0.gguf")
    write_gguf(cfg, seed, path, quant="q4_0")
    print(f"  {cfg.name} at {ENTRY_3B_LAYERS} of {base.cfg.num_layers} layers written "
          f"as Q4_0 for the entry points, {os.path.getsize(path) / 2**30:.2f} GiB",
          flush=True)
    return path


def write_tokenizer(directory):
    """A byte-level BPE `tokenizer.json` (512 ids, <s> and </s>), trained
    on the phase prompts with the `tokenizers` package."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    t = Tokenizer(models.BPE())
    t.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    t.decoder = decoders.ByteLevel()
    t.train_from_iterator(
        [SYSTEM_SQL, SYSTEM_ERR, ERROR_PROMPT, *SCHED_SQL, *APP_QUESTIONS] * 4,
        trainers.BpeTrainer(vocab_size=512, special_tokens=["<unk>", "<s>", "</s>"],
                            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    t.save(os.path.join(directory, "tokenizer.json"))


# ------------------------------------------------------------------- fleet

FLEET_SLOTS = 2      # slots a replica: the storm outnumbers the fleet's slots
FLEET_HBM_GB = 16    # the pool's KV budget, split 0.75 / 0.25 between the models
FLEET_WEIGHTS = "quiet=4"  # LSOT_TENANT_WEIGHTS of phase 16
# LSOT_TENANT_RATE of the shed check: one token in 20 s, so the two requests
# the burst admits never refill the bucket for a third, however slow the host
# (at 0.5 a host whose two requests took over 2 s admitted the third).
FLEET_SHED_RATE = "batch=0.05"
FLEET_SHED_BURST = "batch=2"    # LSOT_TENANT_BURST of the shed check
# SQL requests of burst B (cut from 8 to 4 for the run's time: four fill the
# two 7B replicas' slots, so the restarted one holds work to replay)
FLEET_BURST_B = 4
# The depth of the 7B and the 3B in phases 16-19 (cut from 32 and 28 layers
# for the run's time: their pools, placements, handoffs, transports and
# autoscaler do the same work a layer; widths stay whole).
FLEET_LAYERS = 8


def depth_cut(cfg, params, layers, clone=False):
    """A model cut to its first `layers` layers: its config, and a tree whose
    block weights are views of `params`' first layers (copies with
    `clone`, so the whole tree can be freed)."""
    def cut(v):
        return v[:layers].clone() if clone else v[:layers]

    return (dataclasses.replace(cfg, num_layers=layers),
            {**params, "blocks": {k: cut(v) for k, v in params["blocks"].items()}})


def fleet_model(eng, layers=FLEET_LAYERS):
    """An engine's model cut to `layers` layers, as the fleet phases take it:
    `cfg`, `params` (views) and `stop_ids`."""
    import types

    cfg, params = depth_cut(eng.cfg, eng.params, layers)
    return types.SimpleNamespace(cfg=cfg, params=params, stop_ids=eng.stop_ids)


def recording_tokenizer():
    """A ByteTokenizer that remembers, per thread, the ids it last encoded
    and decoded: a backend encodes the prompt and decodes the completion on
    the caller's thread, so the caller reads back its request's token ids."""
    import threading

    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    class RecordingTokenizer(ByteTokenizer):
        def __init__(self):
            super().__init__()
            self.local = threading.local()

        def encode(self, text, add_bos=True):
            self.local.prompt = super().encode(text, add_bos=add_bos)
            return self.local.prompt

        def decode(self, ids):
            self.local.out = list(ids)
            return super().decode(ids)

    return RecordingTokenizer()


def fleet_compare(torch, label, cfg, params, stop_ids, streams, got, want, bounds,
                  kv_quant=None):
    """Hold the pool's greedy streams `got` to a lone scheduler's `want` over
    the same prompts: equal, or, at the first diverging token, the two
    tokens' logits (`pair_gap`) within twice the top-id drift of the model
    and its KV cache type (`kv_quant`), measured by `logit_drift` as phase
    13 measures it (once a label, on the first divergence). Returns the
    divergences."""
    out = []
    for i, (p, a, b) in enumerate(zip(streams, got, want)):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            assert len(a) == len(b) or any(t in stop_ids for t in a + b), \
                f"{label}[{i}]: lengths {len(a)} != {len(b)} without a stop"
            continue
        if label not in bounds:
            bounds[label] = 2 * logit_drift(torch, cfg, params, kv_quant)["eps_top"]
        gap = pair_gap(torch, cfg, params, p, b[:j], b[j], a[j])
        out.append(dict(path=label, stream=i, position=j, gap=round(gap, 5),
                        bound=round(bounds[label], 5)))
        print(f"    {label}[{i}]: first divergence at token {j} (lone {b[j]}, pool "
              f"{a[j]}): logit gap {gap:.5f}, bound {bounds[label]:.5f}", flush=True)
        assert gap <= bounds[label], f"{label}[{i}]: divergence at {j}, gap {gap}"
    return out


def fleet_serve(torch, engines, smi):
    """Phase 16 (a): the co-resident fleet through the entry point's pool
    assembly (`app/__main__.make_model_pool_service`) over phase 7's 7B and
    3B bf16 trees: `duckdb-nsql` on two replicas sharing the 7B tree,
    `llama3.2` on one, paged, FLEET_SLOTS slots a replica, a KV budget of
    FLEET_HBM_GB GiB split 0.75 / 0.25, under the crash supervisor, QoS on
    with tenant weights FLEET_WEIGHTS, behind the service and the JSON API.
    Burst A, all in flight together: 12 SQL requests of tenant `storm`
    (batch), then 3 of `quiet` (interactive) and 3 error explanations. Burst
    B: FLEET_BURST_B SQL requests and 2 explanations with a `restart_replica` of the 7B
    replica holding the most slots. Checks: every placement on a replica of its
    model, both 7B replicas used; `quiet`'s queue-wait p50 below `storm`'s;
    under FLEET_SHED_RATE the app sheds `storm` 429 with Retry-After and
    serves `quiet`; the restart rebuilds that replica alone, its entries
    replay, nothing is lost, the
    supervisor never restarts the pool; no replica leaks a page; /metrics
    carries lsot_model_replicas 2 and 1, each model's partitioned pages
    and the lsot_tenant_* families; /healthz carries `fleet`; launch counts
    exact over both bursts (every replica object, the rebuilt one
    included); each greedy stream equals that of a lone scheduler built by
    its replica's factory, fed the same prompts in the pool's admission
    order, or leaves it only at a near-tie. Returns (launches, numbers)."""
    import statistics
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig, create_api_app
    from llm_based_apache_spark_optimization_tpu_torch.app.__main__ import (
        make_model_pool_service,
    )
    from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.modelpool import ModelSpec
    from llm_based_apache_spark_optimization_tpu_torch.serve.qos import ADMISSION
    from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend

    tok = recording_tokenizer()
    e7, e3 = fleet_model(engines["duckdb-nsql"]), fleet_model(engines["llama3.2"])
    specs = [ModelSpec("duckdb-nsql", hbm_fraction=0.75, replicas=2),
             ModelSpec("llama3.2", hbm_fraction=0.25, template="llama3-chat",
                       add_bos=False)]
    budget = FLEET_HBM_GB * 2**30
    ADMISSION.reconfigure(enabled=True, rate="", burst="")
    numbers = {}
    with tempfile.TemporaryDirectory() as root:
        cfg = AppConfig(input_dir=root, output_dir=root, history_db=":memory:",
                        max_new_tokens=MAX_NEW, tenant_weights=FLEET_WEIGHTS)
        t_build = time.perf_counter()
        svc = make_model_pool_service(
            [(specs[0], e7.cfg, e7.params, tok), (specs[1], e3.cfg, e3.params, tok)],
            cfg, max_new_tokens=MAX_NEW, num_slots=FLEET_SLOTS, kv_layout="paged",
            kv_hbm_budget_bytes=budget, supervise=True)
        sup = svc._models["duckdb-nsql"].backend.scheduler
        pool = sup._inner
        assert svc._models["llama3.2"].backend.scheduler is sup
        models = {st.label: st.model_id for st in pool._states}
        assert models == {"r0": "duckdb-nsql", "r1": "duckdb-nsql", "r2": "llama3.2"}
        for st, sc in zip(pool._states, pool.schedulers):
            ps = sc.page_stats
            print(f"  {st.label} ({st.model_id}): {sc.num_slots} slots, pool of "
                  f"{ps['pages_total']} pages x {ps['page_bytes'] / 2**20:.1f} MiB, "
                  f"max_seq {sc.max_seq}, WFQ weights {sc._tenant_weights}", flush=True)
        print(f"  pool built in {time.perf_counter() - t_build:.2f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
        client = create_api_app(svc, SQLiteBackend, SQLiteHistory(":memory:"),
                                cfg).test_client()

        def ask(model, question, tenant, qos):
            system, prompt = ((SYSTEM_SQL, question) if model == "duckdb-nsql"
                              else (SYSTEM_ERR, question))
            t_submit = time.perf_counter()
            res = svc.generate(model, prompt, system=system, tenant=tenant, qos=qos)
            return dict(model=model, tenant=tenant, res=res, prompt=tok.local.prompt,
                        out=tok.local.out, admitted=t_submit + res.queue_wait_s)

        objects = {}  # every replica object the bursts ran on, and its start counters

        def track():
            for sc in pool.schedulers:
                objects.setdefault(id(sc), (sc, sc.rounds_issued, sc.prefill_forwards))

        torch.cuda.synchronize()
        reset_launches()
        track()
        initial = set(objects)
        # Burst A: the storm first, then the quiet tenant and the explanations.
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=18) as ex:
            storm = [ex.submit(ask, "duckdb-nsql", q, "storm", "batch")
                     for q in (SCHED_SQL + SCHED_SQL)[:12]]
            deadline = time.time() + 60
            while sup._next_rid <= 12:  # every storm request journaled
                assert time.time() < deadline, "the storm did not reach the journal"
                time.sleep(0.001)
            quiet = [ex.submit(ask, "duckdb-nsql", q, "quiet", "interactive")
                     for q in QUESTIONS]
            explain = [ex.submit(ask, "llama3.2", ERROR_PROMPT, "support", "interactive")
                       for _ in range(3)]
            burst_a = [f.result() for f in storm + quiet + explain]
        numbers["burst_a_s"] = round(time.perf_counter() - t0, 4)
        for sc in pool.schedulers:
            wait_idle(sc)
        waits = {t: [r["res"].queue_wait_s for r in burst_a
                     if r["tenant"] == t and r["model"] == "duckdb-nsql"]
                 for t in ("storm", "quiet")}
        p50 = {t: round(statistics.median(w), 4) for t, w in waits.items()}
        numbers["queue_wait_p50_s"] = p50
        print(f"  burst A: 18 requests in {numbers['burst_a_s']} s; queue wait p50 "
              f"{p50}; storm {sorted(round(w, 3) for w in waits['storm'])}, quiet "
              f"{sorted(round(w, 3) for w in waits['quiet'])}", flush=True)
        assert p50["quiet"] < p50["storm"], f"WFQ did not put quiet first: {p50}"
        place = [r for r in pool.flight_snapshot() if r.get("kind") == "placement"]
        assert len(place) == 18 and all(models[r["to"]] == r["model"] for r in place), \
            place
        by_replica = {lb: sum(r["to"] == lb for r in place) for lb in models}
        assert by_replica["r0"] > 0 and by_replica["r1"] > 0, by_replica
        assert by_replica["r2"] == 3, by_replica
        numbers["placements_burst_a"] = by_replica

        # The front door: `storm` over its bucket is shed, `quiet` served.
        ADMISSION.reconfigure(enabled=True, rate=FLEET_SHED_RATE, burst=FLEET_SHED_BURST)
        shed = []
        for tenant, qos in [("storm", "batch")] * 4 + [("quiet", "interactive")]:
            r = client.post_json("/api/generate", {
                "model": "duckdb-nsql", "prompt": QUESTIONS[0], "system": SYSTEM_SQL,
                "max_new_tokens": 8}, headers={"X-Lsot-Tenant": tenant, "X-Lsot-Qos": qos})
            shed.append((tenant, r.status, r.headers.get("Retry-After")))
        print(f"  shed check ({FLEET_SHED_RATE}, {FLEET_SHED_BURST}): {shed}", flush=True)
        assert [s for _, s, _ in shed] == [200, 200, 429, 429, 200], shed
        assert all(int(ra) >= 1 for _, s, ra in shed if s == 429), shed
        numbers["shed"] = sum(s == 429 for _, s, _ in shed)
        # The front door's and the WFQ's tenant families (the front door's
        # counters restart with its next reconfigure).
        lines = set(client.get("/metrics", query="format=prometheus").text.splitlines())
        families = sorted({ln.split("{")[0] for ln in lines if ln.startswith("lsot_tenant_")})
        assert {"lsot_tenant_admitted_total", "lsot_tenant_shed_total",
                "lsot_tenant_bucket_level", "lsot_tenant_submitted_total"} <= set(families), \
            families
        assert 'lsot_tenant_shed_total{qos="batch",tenant="storm"} 2' in lines
        ADMISSION.reconfigure(enabled=True, rate="", burst="")
        for sc in pool.schedulers:
            wait_idle(sc)

        # Burst B: a targeted restart of r0 while it holds a slot.
        track()
        h0 = sup.health()
        with ThreadPoolExecutor(max_workers=10) as ex:
            futs = [ex.submit(ask, "duckdb-nsql", q, "storm", "batch")
                    for q in SCHED_SQL[:FLEET_BURST_B]]
            futs += [ex.submit(ask, "llama3.2", ERROR_PROMPT, "support", "interactive")
                     for _ in range(2)]
            # The victim: the 7B replica holding the most slots (prefix
            # affinity may route the whole burst to one of them).
            deadline = time.time() + 60
            while True:
                held, victim = max((sum(r is not None for r in sc._slot_req), st.label)
                                   for st, sc in zip(pool._states, pool.schedulers)
                                   if st.model_id == "duckdb-nsql")
                if held:
                    break
                assert time.time() < deadline, "no 7B replica took a request"
                time.sleep(0.001)
            old = pool.schedulers[pool._resolve_idx(victim)]
            t_restart = time.perf_counter()
            assert sup.restart_replica(victim) is True
            while True:
                reps = {r["replica"]: r for r in pool.replica_health()}
                if reps[victim]["restarts"] == 1 and reps[victim]["state"] in (
                        "ready", "degraded"):
                    break
                assert time.perf_counter() - t_restart < 120, reps
                time.sleep(0.005)
            numbers["restart_s"] = round(time.perf_counter() - t_restart, 4)
            numbers["restarted"] = victim
            track()
            burst_b = [f.result() for f in futs]
        for sc in pool.schedulers:
            wait_idle(sc)
        h = sup.health()
        reps = {r["replica"]: r for r in h["replicas"]}
        print(f"  restart of {victim} ({held} slots held) in {numbers['restart_s']} s "
              f"(the rebuild's warmup included); "
              f"supervisor restarts "
              f"{h['restarts']}, replayed {h['replayed'] - h0['replayed']}, lost "
              f"{h['lost']}; replicas {[(k, v['state'], v['restarts']) for k, v in reps.items()]}",
              flush=True)
        assert old is not pool.schedulers[pool._resolve_idx(victim)], "not rebuilt"
        assert [lb for lb, r in reps.items() if r["restarts"]] == [victim], reps
        assert h["restarts"] == 0 and h["lost"] == 0, h
        assert h["replayed"] > h0["replayed"], "no entry of r0 was replayed"
        assert all(r["res"].output_tokens > 0 for r in burst_a + burst_b)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        expected = dict.fromkeys(LAUNCHES, 0)
        for key, (sc, rounds0, prefills0) in objects.items():
            expect_paged(expected, sc, sc.rounds_issued - rounds0,
                         sc.prefill_forwards - prefills0)
            if key not in initial:  # the rebuild warmed it before it served
                expect_warmup(expected, sc)
        print(f"  launches {launches} expected {expected}", flush=True)
        assert launches == expected, f"launch counts {launches} != {expected}"
        _WARMUP["fleet_restart_s"] = numbers["restart_s"]
        objects.clear()  # the rebuilt replica's predecessor, and its page pool
        del old

        # The scrapes.
        text = client.get("/metrics", query="format=prometheus").text
        want = {'lsot_model_replicas{model="duckdb-nsql",served_model="duckdb-nsql"} 2',
                'lsot_model_replicas{model="duckdb-nsql",served_model="llama3.2"} 1'}
        pages = {m: sum(sc.page_stats["pages_total"] for st, sc in
                        zip(pool._states, pool.schedulers) if st.model_id == m)
                 for m in ("duckdb-nsql", "llama3.2")}
        want |= {f'lsot_model_kv_pages_total{{model="duckdb-nsql",served_model="{m}"}} {n}'
                 for m, n in pages.items()}
        lines = set(text.splitlines())
        assert want <= lines, sorted(want - lines)
        health = client.get("/healthz").json()
        fleet = {m: [(r["replica"], r["model_id"], r["state"]) for r in reps]
                 for m, reps in health["fleet"].items()}
        print(f"  /metrics: model pages {pages}, tenant families {families}; "
              f"/healthz fleet {fleet['duckdb-nsql']}, membership "
              f"{health['fleet_membership']['duckdb-nsql']}", flush=True)
        assert [x[:2] for x in fleet["duckdb-nsql"]] == [
            ("r0", "duckdb-nsql"), ("r1", "duckdb-nsql"), ("r2", "llama3.2")]
        assert pages["duckdb-nsql"] == 2 * pool.schedulers[1].page_stats["pages_total"]
        numbers["placements"] = {st.label: st.placements for st in pool._states}
        # No page leaked: only the prefix cache holds pages.
        for st, sc in zip(pool._states, pool.schedulers):
            ps = wait_idle(sc)
            assert ps["pages_in_use"] == ps["prefix_resident_pages"], (st.label, ps)
        make_replica = pool._factory
        svc.close()
    del svc, sup, pool, client
    gc.collect()
    torch.cuda.empty_cache()

    # Each greedy stream against a lone scheduler built by its replica's
    # own factory (FLEET_SLOTS slots, the replica's KV share, QoS on), fed
    # the model's prompts in the pool's admission order, burst by burst.
    divergences, bounds, equal = [], {}, {}
    for model, eng, idx in (("duckdb-nsql", e7, 0), ("llama3.2", e3, 2)):
        recs = [r for burst in (burst_a, burst_b)
                for r in sorted(burst, key=lambda r: r["admitted"]) if r["model"] == model]
        lone = make_replica(idx)
        assert lone.num_slots == FLEET_SLOTS and lone.model_id == model
        with lone:
            want = [lone.submit(r["prompt"], max_new_tokens=MAX_NEW) for r in recs]
            want = [f.result(timeout=300) for f in want]
        div = fleet_compare(torch, f"fleet_{model}", eng.cfg, eng.params,
                            lone.stop_ids, [r["prompt"] for r in recs],
                            [r["out"] for r in recs], want, bounds)
        equal[model] = f"{len(recs) - len(div)} of {len(recs)}"
        divergences += div
        del lone
        torch.cuda.empty_cache()
    numbers["divergences"] = divergences
    numbers["streams"] = len(burst_a) + len(burst_b)
    numbers["streams_equal"] = equal
    print(f"  {numbers['streams']} streams vs lone schedulers: equal exactly {equal}, "
          f"{len(divergences)} near-tie divergences; on {smi}", flush=True)
    return launches, numbers


def fleet_entry_point(torch, hf_dir, blob):
    """Phase 16 (b): the entry point's `LSOT_MODELS` checkpoint branch over
    phase 10's files: `duckdb-nsql` from the 7B HF directory (HF_LAYERS
    layers) and `llama3.2` from the 3B Q4_0 blob cut to ENTRY_3B_LAYERS
    layers, co-resident in
    one supervised pool (paged, 4 GiB of KV split 0.75 / 0.25) in a process
    of its own; one `POST /process-data/` and one explanation on
    `/api/generate`, /healthz carrying `fleet`."""
    spec = (f"duckdb-nsql=hf:{hf_dir},hbm=0.75;"
            f"llama3.2=gguf:{blob}:{hf_dir},hbm=0.25,template=llama3-chat,add_bos=0")
    entry_point(torch, ("--backend", "checkpoint", "--sql-model-path", hf_dir,
                        "--kv-layout", "paged", "--kv-hbm-gb", "4",
                        "--max-new-tokens", str(MAX_NEW)),
                env_extra={"LSOT_MODELS": spec},
                explain={"model": "llama3.2", "prompt": ERROR_PROMPT, "system": SYSTEM_ERR})


# ------------------------------------------------------------ disaggregated

DISAGG_SLOTS = 8      # slots a replica of phase 17
DISAGG_HBM_GB = 8     # KV a replica of phase 17
# (label, kv_quant, requests in flight together, whether a handoff faults)
DISAGG_VARIANTS = (("bf16", None, 12, True), ("int8", "int8", 6, False))


def dp_entry_refusal(torch):
    """`--dp N --scheduler` through the entry point, N one more than the
    cards: the JAX entry point's device-count message, before any
    checkpoint is read (the path does not exist)."""
    from llm_based_apache_spark_optimization_tpu_torch.app.__main__ import main as app_main

    n = torch.cuda.device_count()
    try:
        app_main(["--backend", "checkpoint", "--api", "--sql-model-path",
                  "/nonexistent/checkpoint", "--dp", str(n + 1)])
    except SystemExit as e:
        msg = str(e.code)
    else:
        raise AssertionError("--dp past the card count did not exit")
    want = f"--dp {n + 1} --tp 1 needs {n + 1} devices, found {n}"
    print(f"  entry point --dp {n + 1} --scheduler: {msg!r}", flush=True)
    assert msg == want, f"{msg!r} != {want!r}"
    return msg


def blob_round_trip(torch, src, dst, npg):
    """npg free pages of `src`'s pool filled at random, exported to a host
    blob, imported into npg free pages of `dst`'s pool and exported again:
    bit for bit. Returns (export s, import s, bytes) of the first leg."""
    import numpy as np

    from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
        export_pages,
        handoff_bytes,
        import_pages,
    )

    a, b = src._page_alloc.alloc(npg), dst._page_alloc.alloc(npg)
    assert a is not None and b is not None, "no free pages for the round trip"
    g = torch.Generator(device="cuda").manual_seed(17)
    with torch.inference_mode():
        for arr in src._pool.values():
            shape = arr[:, a].shape
            arr[:, a] = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                       dtype=torch.int8) if arr.dtype == torch.int8
                         else torch.randn(shape, generator=g, device="cuda").to(arr.dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = export_pages(src._pool, a)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        import_pages(dst._pool, b, blob)
        torch.cuda.synchronize()
        t_import = time.perf_counter() - t0
        back = export_pages(dst._pool, b)
    assert all(np.array_equal(x, y) for x, y in zip(blob, back)), "blob round trip differs"
    src._page_alloc.release(a)
    dst._page_alloc.release(b)
    return t_export, t_import, handoff_bytes(blob)


def p50(xs):
    """The median of `xs`, rounded; None when empty."""
    import statistics

    return round(statistics.median(xs), 6) if xs else None


def timed_burst(submit, prompts):
    """Submit every prompt at once through `submit(ids, on_token)`.
    Returns the results (None for a lost request), the streams, and the
    p50s of TTFT, decode tok/s from the first token ((n - 1) / (last -
    first): the client's rate, the split fleet's handoff inside), the
    gap from the first to the second token (split: the handoff) and
    the decode leg's tok/s from the second token ((n - 2) / (last -
    second))."""
    streams = [[] for _ in prompts]
    stamps = [[0.0, 0.0, 0.0, 0.0] for _ in prompts]  # submit, first, second, last

    def tap(i):
        def on_token(t):
            now = time.perf_counter()
            streams[i].append(t)
            if len(streams[i]) <= 2:
                stamps[i][len(streams[i])] = now
            stamps[i][3] = now
        return on_token

    futs = []
    for i, p in enumerate(prompts):
        stamps[i][0] = time.perf_counter()
        futs.append(submit(p, tap(i)))
    outs = []
    for f in futs:
        try:
            outs.append(f.result(timeout=600))
        except Exception as e:  # noqa: BLE001 — a lost request, counted
            print(f"    lost: {type(e).__name__}: {e}", flush=True)
            outs.append(None)
    ttft = [s[1] - s[0] for s in stamps if s[1]]
    tok_s = [(len(o) - 1) / (s[3] - s[1]) for o, s in zip(outs, stamps)
             if o and len(o) > 1 and s[3] > s[1]]
    gap = [s[2] - s[1] for s in stamps if s[2]]
    leg = [(len(o) - 2) / (s[3] - s[2]) for o, s in zip(outs, stamps)
           if o and len(o) > 2 and s[3] > s[2]]
    return outs, streams, {"ttft_p50_s": p50(ttft), "decode_tok_s_p50": p50(tok_s),
                           "second_token_gap_s_p50": p50(gap),
                           "decode_leg_tok_s_p50": p50(leg)}


def disagg_serve(torch, engines, smi):
    """Phase 17: the phase-split fleet. The entry point's `--dp` past the
    card count exits with the JAX entry point's message first. Then, for
    each DISAGG_VARIANTS entry, a supervised `SchedulerPool` built through
    a per-replica factory over phase 7's 7B bf16 tree (full width and
    depth): replica r0 `prefill`, r1 `decode`, paged, pages of 64,
    DISAGG_SLOTS slots and DISAGG_HBM_GB GiB of KV each, (a) over the bf16
    pool, (b) over the int8 pool, behind a SchedulerBackend and a
    GenerationService; the NL->SQL requests in flight together. In (a) the
    prefill replica's second pack pass that holds a request faults
    (`sched:handoff`): it dies before that pass exports a blob, its
    requests (their first tokens streamed) re-prefill on a sibling with
    the delivered token suppressed, and only r0 is rebuilt. Checks: every
    request is imported by r1, decoded in place for backpressure, or
    prefilled again by r1 after the fault; exports equal imports over
    every replica object; each export's bytes are its pages x the pool's
    page bytes and its pages cover prompt + first token; no request lost,
    each stream equal to its result (a replayed request's first token may
    leave the replay's only at a near-tie); no page leaked; launch counts
    exact over every replica object; the flight records' pages_migrated
    and handoff_wait_s, `handoff_stats` and the lsot_handoff_* families
    non-zero and equal; a blob round trip between the two pools bit for
    bit; each greedy stream equal to that of a lone mixed scheduler built
    by the same factory and fed the same prompts, or leaving it only at a
    near-tie (`fleet_compare`). Returns (launches by path, numbers)."""
    from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
        page_bytes,
        pages_for_tokens,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        GenerationService,
        SchedulerBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerPool,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    numbers = {"entry_point_dp": dp_entry_refusal(torch)}
    e7 = fleet_model(engines["duckdb-nsql"])
    cfg, params = e7.cfg, e7.params
    tok = ByteTokenizer()
    roles = ("prefill", "decode")
    launches, bounds = {}, {}

    for name, kv_quant, n, fault in DISAGG_VARIANTS:
        label = f"disagg_{name}"
        prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in (SCHED_SQL * 2)[:n]]

        def make(role, kv_quant=kv_quant):
            return ContinuousBatchingScheduler(
                cfg, params, num_slots=DISAGG_SLOTS, stop_ids=e7.stop_ids,
                kv_layout="paged", kv_page_size=SCHED["kv_page_size"],
                kv_hbm_budget_bytes=DISAGG_HBM_GB * 2**30, kv_quant=kv_quant,
                phase_role=role, device="cuda")

        def make_replica(i):
            if i == 0:
                FAULTS.clear()  # one crash episode: the rebuilt r0 runs clean
            return make(roles[i])

        t_build = time.perf_counter()
        sup = SupervisedScheduler(
            lambda: SchedulerPool([make_replica(0), make_replica(1)], factory=make_replica),
            name=f"scheduler-pool:{label}")
        svc = GenerationService()
        svc.register("duckdb-nsql", SchedulerBackend(sup, tok, max_new_tokens=MAX_NEW))
        pool = sup._inner
        pre, dec = pool.schedulers
        assert [s.phase_role for s in pool.schedulers] == list(roles)
        assert pre.on_handoff is not None and dec.on_handoff is None
        print(f"  {label}: pool built in {time.perf_counter() - t_build:.2f} s, "
              f"{pre.page_stats['pages_total']} pages of "
              f"{pre.page_stats['page_bytes'] / 2**20:.1f} MiB a replica; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
        armed = []
        if fault:
            pack = pre._pack_handoffs

            def pack_then_fault():
                # The second pack pass that holds a request dies at its first
                # live request's handoff: its first token streamed, no blob of
                # that pass exported.
                if pre._handoff_pending and pre._ho_exports and not armed:
                    armed.append(pre._ho_exports)
                    FAULTS.configure("sched:handoff:1", 0)
                pack()

            pre._pack_handoffs = pack_then_fault
        objects = {id(sc): (sc, sc.rounds_issued, sc.prefill_forwards)
                   for sc in pool.schedulers}
        initial = list(pool.schedulers)
        h0 = sup.health()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            outs, streams, split = timed_burst(
                lambda p, on: sup.submit(p, max_new_tokens=MAX_NEW, on_token=on), prompts)
        finally:
            FAULTS.clear()
        numbers_v = {"requests": n, "burst_s": round(time.perf_counter() - t0, 4)}
        for sc in pool.schedulers:  # a rebuilt replica started after the reset
            objects.setdefault(id(sc), (sc, 0, 0))
        for sc in pool.schedulers:
            wait_idle(sc)
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        expected = dict.fromkeys(LAUNCHES, 0)
        for sc, rounds0, prefills0 in objects.values():
            expect_paged(expected, sc, sc.rounds_issued - rounds0,
                         sc.prefill_forwards - prefills0)
            if sc not in initial:  # a rebuilt replica warms before it serves
                expect_warmup(expected, sc)
        health = sup.health()
        replayed = health["replayed"] - h0["replayed"]
        objs = [sc for sc, _, _ in objects.values()]
        ho = {k: sum(getattr(sc, f"_ho_{k}") for sc in objs)
              for k in ("exports", "imports", "inplace", "backpressure")}
        direct = sum(sc._rid_seq - sc._ho_imports for sc in objs if sc.phase_role == "decode")
        reps = {r["replica"]: r for r in pool.replica_health()}
        print(f"  {label}: {n} requests in {numbers_v['burst_s']} s; exports {ho['exports']}, "
              f"imports {ho['imports']}, in place {ho['inplace']} (backpressure "
              f"{ho['backpressure']}), prefilled by r1 after the fault {direct}; supervisor "
              f"replayed {replayed}, lost {health['lost']}, restarts {health['restarts']}; "
              f"replicas {[(k, v['state'], v['restarts']) for k, v in reps.items()]}; "
              f"launches {launches[label]} expected {expected}", flush=True)
        assert all(o is not None for o in outs), f"{label}: a request was lost"
        assert health["lost"] == 0 and health["restarts"] == 0, health
        assert ho["exports"] == ho["imports"] > 0, ho
        assert ho["inplace"] == ho["backpressure"], ho
        assert ho["imports"] + ho["inplace"] + direct == n, (ho, direct, n)
        assert launches[label] == expected, f"{label}: launch counts {launches[label]} != {expected}"
        if fault:
            assert armed and reps["r0"]["restarts"] == 1 and reps["r1"]["restarts"] == 0, reps
            assert replayed >= 1 and direct <= replayed, (replayed, direct)
        else:
            assert not replayed and not direct and all(
                r["restarts"] == 0 for r in reps.values()), reps
        # Each stream is its result: a token delivered once. A replayed
        # request's first token came from the faulted prefill; its replay may
        # leave it only at a near-tie.
        first_ties = []
        for i, (s, o) in enumerate(zip(streams, outs)):
            assert len(s) == len(o) and s[1:] == o[1:], f"{label}[{i}]: stream {s} != {o}"
            if s[:1] != o[:1]:
                bound = bounds.setdefault(f"disagg_{name}", 2 * logit_drift(
                    torch, cfg, params, kv_quant)["eps_top"])
                gap = pair_gap(torch, cfg, params, prompts[i], [], o[0], s[0])
                first_ties.append(dict(stream=i, gap=round(gap, 5), bound=round(bound, 5)))
                assert fault and gap <= bound, f"{label}[{i}]: first token {s[0]} != {o[0]}"
        # Every blob: its pages cover prompt + first token, its bytes the
        # pages at the pool's page bytes.
        pb = page_bytes(cfg, SCHED["kv_page_size"], params["final_norm"].dtype.itemsize,
                        kv_quant)
        want_pages = {pages_for_tokens(len(p) + 1, SCHED["kv_page_size"]) for p in prompts}
        exports = [r for sc in objs for r in sc.flight.snapshot()
                   if r.get("kind") == "handoff_export"]
        imports = [r for r in dec.flight.snapshot() if r.get("kind") == "handoff_import"]
        assert len(exports) == ho["exports"] and len(imports) == ho["imports"]
        assert all(r["pages"] in want_pages and r["bytes"] == r["pages"] * pb
                   for r in exports), (want_pages, pb, exports[:2])
        # The three views of the handoffs agree.
        hs = {r["replica"]: r for r in pool.handoff_stats["replicas"]}
        mig = [r for r in dec.flight.snapshot() if "pages_migrated" in r]
        text = svc.metrics_prometheus()

        def family(fam, replica):
            for ln in text.splitlines():
                if ln.startswith(fam + "{") and f'replica="{replica}"' in ln:
                    return float(ln.rsplit(" ", 1)[1])
            raise AssertionError(f"{fam} for {replica} missing from /metrics")

        assert sum(r["pages_migrated"] for r in mig) == hs["r1"]["pages_in"] > 0
        assert abs(sum(r["handoff_wait_s"] for r in mig) - hs["r1"]["wait_s_sum"]) \
            <= 1e-5 * (len(mig) + 1)
        assert hs["r1"]["wait_count"] == hs["r1"]["imports"] == len(imports)
        assert family("lsot_handoff_imports_total", "r1") == hs["r1"]["imports"] > 0
        assert family("lsot_handoff_pages_in_total", "r1") == hs["r1"]["pages_in"]
        # (a)'s rebuilt r0 may export nothing: the fault's replays can all
        # land on r1 while it restarts.
        assert family("lsot_handoff_exports_total", "r0") == hs["r0"]["exports"]
        assert family("lsot_handoff_bytes_out_total", "r0") == hs["r0"]["bytes_out"]
        place = [r for r in pool.flight_snapshot() if r.get("kind") == "handoff_place"]
        assert len(place) == ho["exports"] and all(r["to"] == "r1" for r in place), place[:3]
        # A blob's round trip between the two pools on the card.
        npg = max(want_pages)
        t_exp, t_imp, blob_bytes = blob_round_trip(torch, pool.schedulers[0], dec, npg)
        for sc in pool.schedulers:
            ps = wait_idle(sc)
            assert ps["pages_in_use"] == ps["prefix_resident_pages"], ps
        svc.close()
        del svc, sup, pool, pre, dec, objects, objs
        gc.collect()
        torch.cuda.empty_cache()

        # The control: a lone mixed scheduler of the same factory, the same
        # prompts at once.
        lone = make("mixed")
        with lone:
            want, _, mixed = timed_burst(
                lambda p, on: lone.submit(p, max_new_tokens=MAX_NEW, on_token=on), prompts)
        del lone
        torch.cuda.empty_cache()
        div = fleet_compare(torch, f"disagg_{name}", cfg, params, e7.stop_ids, prompts,
                            outs, want, bounds, kv_quant=kv_quant)
        export_s = [r["export_s"] for r in exports]
        wait_s = [r["wait_s"] for r in imports]
        numbers_v.update(
            exports=ho["exports"], imports=ho["imports"], inplace=ho["inplace"],
            backpressure=ho["backpressure"], reprefilled=direct, replayed=replayed,
            fault_after_exports=armed[0] if armed else None,
            export_s={"p50": p50(export_s), "max": round(max(export_s), 6)},
            import_wait_s={"p50": p50(wait_s), "max": round(max(wait_s), 6)},
            bytes_per_request=sorted({r["bytes"] for r in exports}),
            pages_per_request=sorted({r["pages"] for r in exports}),
            round_trip={"pages": npg, "bytes": blob_bytes, "export_s": round(t_exp, 6),
                        "import_s": round(t_imp, 6)},
            split=split, mixed=mixed, first_token_ties=first_ties,
            streams_equal=f"{n - len(div)} of {n}", divergences=div)
        numbers[name] = numbers_v
        print(f"  {label}: export s p50 {numbers_v['export_s']}, import wait s "
              f"{numbers_v['import_wait_s']}, bytes a request "
              f"{numbers_v['bytes_per_request']}; round trip {numbers_v['round_trip']}; "
              f"split {split} vs mixed {mixed}; {numbers_v['streams_equal']} streams equal "
              f"to the lone mixed scheduler, {len(div)} near-ties; on {smi}", flush=True)
    return launches, numbers


# ------------------------------------------------------------------ remote

REMOTE_REQUESTS = 8    # (a): requests in flight together over the remote decode worker
REMOTE_WAVE = 6        # (b): requests a wave over the remote prefill worker
# The pool's lease over the workers of phase 18: a beat of 2 s (the
# default) and 6 misses. A ping and its ack share the worker's one
# connection with the 7B blobs (160-224 MiB a frame, about 1 s each to
# encode, send and decode), so an ack can wait behind a pass of pushes:
# 1 s x 3 expired a live prefill worker on the card.
REMOTE_LEASE_S = 2.0
REMOTE_LEASE_MISSES = 6
REMOTE_RPC_S = 60.0    # an rpc's budget: a 7B blob is encoded and decoded on the way
# The supervisors' stall floor in phase 18: a local prefill replica's pump
# ships its pass's blobs to the remote decode worker on the replica's own
# loop thread, one requeue round trip each (encode, send, decode, ack), and
# its heartbeat waits for the whole pass (10 s, the default, flagged a
# stall on the card).
REMOTE_STALL_MIN_S = 120.0
_REMOTE = {}           # phase 18 (c)'s numbers, taken in phase 10


def tree_checksum(torch, params):
    """A checksum of a params tree's bits: for each leaf, in slices of 2^24
    elements (so the int64 copies stay small), the sum and the sum of
    squares of its 16-bit (or 8-bit, 32-bit) patterns, hashed in the
    leaves' order."""
    import hashlib

    h = hashlib.sha256()
    step = 1 << 24
    for name, x in sorted(leaves(params).items()):
        bits = x.contiguous().view(-1)
        if bits.element_size() == 2:
            bits = bits.view(torch.int16)
        elif bits.element_size() == 4:
            bits = bits.view(torch.int32)
        for i in range(0, bits.numel(), step):
            v = bits[i:i + step].to(torch.int64)
            h.update(f"{name}:{i}:{int(v.sum())}:{int((v * v).sum())};".encode())
    return h.hexdigest()[:16]


class WireProbe:
    """Times the blob frames of this process's transports: `encode_frame`
    and `FrameDecoder.feed` of `serve.remote` wrapped while installed. A
    frame carrying a request with a KV blob (a requeue rpc or a pushed
    handoff) records its raw blob bytes, its wire bytes and the seconds of
    its encode or of the feed call that decoded it; `emit(record)` is called
    with each record (a worker prints it)."""

    def __init__(self, emit=None):
        from llm_based_apache_spark_optimization_tpu_torch.serve import remote

        self.remote = remote
        self.records = []
        self.emit = emit
        self._encode, self._decoder = remote.encode_frame, remote.FrameDecoder
        probe = self

        def encode_frame(obj, encoding=None):
            t0 = time.perf_counter()
            frame = probe._encode(obj, encoding)
            raw = probe.blob_bytes(obj)
            if raw:
                probe.add(dict(side="encode", kind=obj.get("op") or obj.get("ev"),
                               raw=raw, wire=len(frame),
                               s=round(time.perf_counter() - t0, 6)))
            return frame

        class FrameDecoder(probe._decoder):
            def feed(self, data):
                t0 = time.perf_counter()
                out = super().feed(data)
                for msg in out:
                    raw = probe.blob_bytes(msg)
                    if raw:
                        probe.add(dict(side="decode", kind=msg.get("op") or msg.get("ev"),
                                       raw=raw, wire=None,
                                       s=round(time.perf_counter() - t0, 6)))
                return out

        self._patched = (encode_frame, FrameDecoder)

    @staticmethod
    def blob_bytes(msg):
        req = msg.get("req") if isinstance(msg, dict) else None
        blob = req.get("spilled") if isinstance(req, dict) else None
        if not blob:
            return 0
        import numpy as np

        return int(sum(np.asarray(a).nbytes for a in blob
                       if isinstance(a, np.ndarray)))

    def add(self, rec):
        self.records.append(rec)
        if self.emit is not None:
            self.emit(rec)

    def __enter__(self):
        self.remote.encode_frame, self.remote.FrameDecoder = self._patched
        return self

    def __exit__(self, *exc):
        self.remote.encode_frame, self.remote.FrameDecoder = self._encode, self._decoder


def worker_command(role):
    """The command of one phase 18 worker process (this file in worker mode)."""
    return [sys.executable, os.path.abspath(__file__), "--remote-worker", role]


def remote_worker(role) -> int:
    """`--remote-worker ROLE`: one worker process of phase 18. Rebuilds the
    7B bf16 tree on the card from seed 0 (`make_engines`' recipe) and prints
    its checksum, builds a paged scheduler of phase 17's shape with phase
    role ROLE, warms it (`warmup()`, then one request), zeroes the launch counts and
    serves it with the port's `ReplicaServer` (printing its listening line
    and, as a JSON line, each blob frame it encodes or decodes). On SIGTERM
    it prints its launch counts beside the counts its rounds imply
    (`expect_paged`) as one JSON line and exits 0; on any failure it prints
    the traceback and exits 1 at once."""
    try:
        return _remote_worker(role)
    except BaseException:  # noqa: BLE001 — a worker must not linger half-built
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def _remote_worker(role) -> int:
    import signal
    import threading
    import types

    import torch

    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import resolve_stop_ids
    from llm_based_apache_spark_optimization_tpu_torch.serve.remote import ReplicaServer
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg, params = depth_cut(DUCKDB_NSQL_7B, init_params(DUCKDB_NSQL_7B, gen, torch.bfloat16,
                                                        device="cuda"),
                            FLEET_LAYERS, clone=True)
    tok = ByteTokenizer()
    print(json.dumps({"tree_checksum": tree_checksum(torch, params)}), flush=True)
    torch.cuda.empty_cache()
    sched = ContinuousBatchingScheduler(
        cfg, params, num_slots=DISAGG_SLOTS, stop_ids=resolve_stop_ids(cfg, tok),
        kv_layout="paged", kv_page_size=SCHED["kv_page_size"],
        kv_hbm_budget_bytes=DISAGG_HBM_GB * 2**30, phase_role=role, device="cuda")
    sched.warmup()  # as the worker's own entry point (serve/remote.py) warms
    sched.start()
    sched.submit(tok.encode(QUESTIONS[0]), max_new_tokens=4).result(timeout=300)
    wait_idle(sched)
    torch.cuda.synchronize()
    base = dict(rounds=sched.rounds_issued, prefills=sched.prefill_forwards,
                mixed=sched.mixed_rounds, ragged=sched.ragged_prefills)
    reset_launches()
    probe = WireProbe(emit=lambda rec: print(json.dumps({"wire": rec}), flush=True))
    with probe:
        srv = ReplicaServer(sched)
        print(json.dumps({"ready_s": round(time.perf_counter() - t0, 3), "role": role,
                          "allocated_gib": round(torch.cuda.memory_allocated() / 2**30, 2),
                          "reserved_gib": round(torch.cuda.memory_reserved() / 2**30, 2)}),
              flush=True)
        print(f"lsot-remote-worker listening on {srv.address}", flush=True)
        while not stop.wait(0.2):
            pass
        srv.close()
        wait_idle(sched)
        torch.cuda.synchronize()
    # The counts the rounds since the reset imply, on a view of the
    # scheduler whose cumulative counters start at the reset.
    view = types.SimpleNamespace(
        cfg=sched.cfg, kv_quant=sched.kv_quant, decode_chunk=sched.decode_chunk,
        params=sched.params, mixed_rounds=sched.mixed_rounds - base["mixed"],
        ragged_prefills=sched.ragged_prefills - base["ragged"])
    expected = dict.fromkeys(LAUNCHES, 0)
    expect_paged(expected, view, sched.rounds_issued - base["rounds"],
                 sched.prefill_forwards - base["prefills"])
    print(json.dumps({"worker_launches": dict(LAUNCHES), "expected": expected,
                      "handoff": {k: v for k, v in (sched.handoff_stats or {}).items()
                                  if isinstance(v, (int, float))}}), flush=True)
    sched.shutdown()
    return 0


class Worker:
    """One phase 18 worker process: started with `cmd`, its output read by a
    thread into `lines` (JSON lines parsed into `records`), every wait
    bounded."""

    def __init__(self, cmd, name, env=None):
        import queue
        import threading

        self.name = name
        self.lines = queue.Queue()
        self.records = []
        self.log = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            cmd, env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
                          **(env or {})),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def read():
            for line in self.proc.stdout:
                line = line.rstrip("\n")
                self.log.append(line)
                if line.startswith("{"):
                    try:
                        self.records.append(json.loads(line))
                    except ValueError:
                        pass
                self.lines.put(line)
            self.lines.put(None)

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()

    def wait_for(self, pred, timeout):
        """The first line (from now) for which `pred(line)` holds."""
        import queue

        deadline = time.perf_counter() + timeout
        while True:
            left = deadline - time.perf_counter()
            try:
                line = self.lines.get(timeout=max(0.01, left))
            except queue.Empty:
                line = ""
            if line is None or left <= 0:
                ended = "its output ended" if line is None else f"none in {timeout} s"
                raise AssertionError(f"worker {self.name}: no such line ({ended}); "
                                     f"output {self.log[-30:]}")
            if pred(line):
                return line

    def ready(self, timeout=300):
        """(checksum, address, seconds to ready) once it listens."""
        checksum = json.loads(self.wait_for(lambda x: x.startswith('{"tree_checksum"'),
                                            timeout))["tree_checksum"]
        line = self.wait_for(lambda x: x.startswith("lsot-remote-worker listening on "),
                             timeout)
        return checksum, line.split()[-1], round(time.perf_counter() - self.t0, 3)

    def record(self, key):
        return [r[key] for r in self.records if key in r]

    def stop(self, timeout=120):
        """SIGTERM, then the exit code and the launch line (None if the
        worker printed none)."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(timeout=60)
        self.reader.join(timeout=30)
        done = [r for r in self.records if "worker_launches" in r]
        return rc, done[-1] if done else None

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def wire_summary(records):
    """Per blob frame: raw and wire bytes (MiB), encode and decode seconds,
    and their ranges."""
    enc = [r for r in records if r["side"] == "encode"]
    dec = [r for r in records if r["side"] == "decode"]

    def rng(xs):
        return [round(min(xs), 6), round(max(xs), 6)] if xs else None

    return {"frames_encoded": len(enc), "frames_decoded": len(dec),
            "raw_mib": rng([r["raw"] / 2**20 for r in enc + dec]),
            "wire_mib": rng([r["wire"] / 2**20 for r in enc]),
            "wire_over_raw": rng([r["wire"] / r["raw"] for r in enc]),
            "encode_s": rng([r["s"] for r in enc]), "encode_s_p50": p50([r["s"] for r in enc]),
            "decode_s": rng([r["s"] for r in dec]), "decode_s_p50": p50([r["s"] for r in dec])}


def card_memory(torch):
    """The card's free memory (every process's use counted) and this
    process's allocated and reserved memory, in GiB."""
    free, total = torch.cuda.mem_get_info()
    return (f"card free {free / 2**30:.2f} of {total / 2**30:.2f} GiB; here allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f}, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f}")


def check_worker_launches(label, line):
    """A cleanly stopped worker's launch line: its counts equal those its
    rounds imply, and it wrote pages (every paged forward does)."""
    assert line is not None, f"{label}: the worker printed no launch line"
    got, want = line["worker_launches"], line["expected"]
    print(f"  {label}: worker launches {got} expected {want}", flush=True)
    assert got == want, f"{label}: worker launch counts {got} != {want}"
    assert got["fused_page_write"] > 0, got
    return got


def remote_serve(torch, engines, smi, split=None):
    """Phase 18: the remote fleet over phase 7's 7B bf16 tree (full width
    and depth), paged, pages of 64, DISAGG_SLOTS slots and DISAGG_HBM_GB
    GiB of KV a replica, the workers processes of this file
    (`remote_worker`, `Worker`) serving the port's `ReplicaServer`; the
    supervised `SchedulerPool` keeps each `SocketTransport` under a lease of
    REMOTE_LEASE_S x REMOTE_LEASE_MISSES. (a): r0 a local prefill replica,
    r1 a remote decode worker; REMOTE_REQUESTS requests at once, each blob
    crossing in a requeue frame. (b): r0 a remote prefill worker pushing its
    handoffs, r1 a local decode replica; a wave of REMOTE_WAVE requests all
    through pushes (none pulled), then a second wave during which the worker
    is killed with SIGKILL once a push of that wave has arrived: the lease
    expires, only r0 restarts (against a replacement worker, started before
    the kill when the card has room for it, else at the kill) and the
    journal replays the lost work with the delivered
    prefixes suppressed. Checks: every worker's tree checksum equals this
    process's; exports equal imports (r1's side read through the loads
    digest); each blob's bytes are its pages x the pool's page bytes and its
    frame's wire bytes its raw bytes x the encoding's overhead; nothing lost;
    each stream delivered once (a replayed request's first token may leave
    its replay's only at a near-tie); no page leaked in a local replica or
    a worker; launch counts exact in this process and in each worker that
    exits cleanly; each greedy stream equal to a lone mixed scheduler's of
    the same prompts or leaving it at a near-tie (`fleet_compare`). Returns
    (launches by path, numbers)."""
    from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
        page_bytes,
        pages_for_tokens,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import remote
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerPool,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    e7 = fleet_model(engines["duckdb-nsql"])
    cfg, params = e7.cfg, e7.params
    tok = ByteTokenizer()
    enc = "msgpack" if remote.HAVE_MSGPACK else "json"
    checksum = tree_checksum(torch, params)
    print(f"  frame encoding {enc}; this process's 7B tree checksum {checksum}", flush=True)
    pb = page_bytes(cfg, SCHED["kv_page_size"], params["final_norm"].dtype.itemsize, None)
    overhead = (1.0, 1.01) if enc == "msgpack" else (4 / 3, 4 / 3 * 1.01)
    numbers = {"encoding": enc, "tree_checksum": checksum, "device": smi}
    launches, bounds = {}, {}
    prompts_a = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in (SCHED_SQL * 2)[:REMOTE_REQUESTS]]
    prompts_b = [tok.encode(f"{SYSTEM_SQL}\n\n{q}")
                 for q in (SCHED_SQL * 2)[REMOTE_REQUESTS - 2:][:REMOTE_WAVE]]

    def make(role):
        return ContinuousBatchingScheduler(
            cfg, params, num_slots=DISAGG_SLOTS, stop_ids=e7.stop_ids,
            kv_layout="paged", kv_page_size=SCHED["kv_page_size"],
            kv_hbm_budget_bytes=DISAGG_HBM_GB * 2**30, phase_role=role, device="cuda")

    def transport(addr, label):
        return remote.SocketTransport(addr, label=label, rpc_timeout_s=REMOTE_RPC_S,
                                      connect_timeout_s=30.0)

    def supervised(make_replica, label):
        return SupervisedScheduler(
            lambda: SchedulerPool([make_replica(0), make_replica(1)], factory=make_replica,
                                  lease_s=REMOTE_LEASE_S, lease_misses=REMOTE_LEASE_MISSES),
            stall_min_s=REMOTE_STALL_MIN_S, name=f"scheduler-pool:{label}").start()

    def control(prompts):
        lone = make("mixed")
        with lone:
            want, _, mixed = timed_burst(
                lambda p, on: lone.submit(p, max_new_tokens=MAX_NEW, on_token=on), prompts)
        del lone
        gc.collect()
        torch.cuda.empty_cache()
        return want, mixed

    def blob_checks(label, probe_records, exports):
        """Each export's bytes its pages x the page bytes (its pages covering
        prompt + first token); each blob frame's wire bytes its raw bytes x
        the encoding's overhead."""
        for r in exports:
            assert r["bytes"] == r["pages"] * pb, (label, r, pb)
        for r in probe_records:
            if r["side"] == "encode":
                ratio = r["wire"] / r["raw"]
                assert r["raw"] % pb == 0 and overhead[0] <= ratio <= overhead[1], \
                    (label, r, pb, overhead)

    def streams_once(label, prompts, streams, outs, replayed):
        ties = []
        for i, (s, o) in enumerate(zip(streams, outs)):
            assert len(s) == len(o) and s[1:] == o[1:], f"{label}[{i}]: stream {s} != {o}"
            if s[:1] != o[:1]:
                bound = bounds.setdefault(label, 2 * logit_drift(
                    torch, cfg, params, None)["eps_top"])
                gap = pair_gap(torch, cfg, params, prompts[i], [], o[0], s[0])
                ties.append(dict(stream=i, gap=round(gap, 5), bound=round(bound, 5)))
                assert replayed and gap <= bound, f"{label}[{i}]: first token {s[0]} != {o[0]}"
        return ties

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  before the workers: {card_memory(torch)}", flush=True)
    workers = {"a": Worker(worker_command("decode"), "a-decode")}
    overlapped = {}

    def room_for_worker():
        """Whether the card holds one more worker (the first worker's
        footprint, read off the card, and 1 GiB to spare)."""
        return torch.cuda.mem_get_info()[0] / 2**30 >= footprint + 1.0

    try:
        free0 = torch.cuda.mem_get_info()[0] / 2**30
        # The controls run while the first worker builds its tree.
        want_a, mixed_a = control(prompts_a)
        want_b, mixed_b = control(prompts_b)

        # (a) a local prefill replica, a remote decode worker.
        label = "remote_decode"
        sum_a, addr_a, ready_a = workers["a"].ready()
        assert sum_a == checksum, f"{label}: worker tree {sum_a} != {checksum}"
        footprint = free0 - torch.cuda.mem_get_info()[0] / 2**30
        print(f"  {label}: worker ready in {ready_a} s at {addr_a}, tree checksum equal; "
              f"a worker takes {footprint:.2f} GiB of the card; {card_memory(torch)}",
              flush=True)
        with WireProbe() as probe:
            sup = supervised(lambda i: make("prefill") if i == 0 else transport(addr_a, "r1"),
                             label)
            pool = sup._inner
            pre, tr = pool.schedulers
            assert tr.phase_role == "decode" and tr._page_size == SCHED["kv_page_size"]
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            outs, streams, fleet_a = timed_burst(
                lambda p, on: sup.submit(p, max_new_tokens=MAX_NEW, on_token=on), prompts_a)
            burst_a = round(time.perf_counter() - t0, 4)
        wait_idle(pre)
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        expected = dict.fromkeys(LAUNCHES, 0)
        expect_paged(expected, pre, pre.rounds_issued, pre.prefill_forwards)
        tr.ping()  # refresh the loads digest
        loads = {r["replica"]: r for r in pool.replica_loads()}
        health = sup.health()
        exports = [r for r in pre.flight.snapshot() if r.get("kind") == "handoff_export"]
        ho = dict(exports=pre.handoff_stats["exports"], imports=loads["r1"]["handoff_imports"],
                  inplace=pre.handoff_stats["inplace_fallbacks"])
        remote_pages = loads["r1"]["page_stats"]
        print(f"  {label}: {REMOTE_REQUESTS} requests in {burst_a} s; {ho}; lost "
              f"{health['lost']}, restarts {health['restarts']}; transport "
              f"{loads['r1']['transport']}; local launches {launches[label]} expected "
              f"{expected}", flush=True)
        assert all(o is not None for o in outs) and health["lost"] == 0, health
        assert ho["exports"] == ho["imports"] == REMOTE_REQUESTS and not ho["inplace"], ho
        assert launches[label] == expected, f"{label}: {launches[label]} != {expected}"
        assert remote_pages["pages_in_use"] == remote_pages["prefix_resident_pages"], \
            remote_pages
        ps = pre.page_stats
        assert ps["pages_in_use"] == ps["prefix_resident_pages"], ps
        want_pages = {pages_for_tokens(len(p) + 1, SCHED["kv_page_size"]) for p in prompts_a}
        assert {r["pages"] for r in exports} <= want_pages, (want_pages, exports[:2])
        sent = [r for r in probe.records if r["kind"] == "requeue"]
        assert len(sent) == REMOTE_REQUESTS, sent
        blob_checks(label, sent, exports)
        ties_a = streams_once(label, prompts_a, streams, outs, False)
        sup.shutdown()
        del sup, pool, pre, tr
        gc.collect()
        torch.cuda.empty_cache()
        # (b)'s worker builds while (a)'s is stopped and checked, when the
        # card holds both; else after (a)'s stops.
        overlapped["b"] = room_for_worker()
        if overlapped["b"]:
            workers["b"] = Worker(worker_command("prefill"), "b-prefill")
        rc, line = workers["a"].stop()
        assert rc == 0, f"{label}: the worker exited {rc}"
        wl = check_worker_launches(label, line)
        launches[label] = {k: v + wl[k] for k, v in launches[label].items()}
        wire_a = wire_summary(sent + [r["wire"] for r in workers["a"].records if "wire" in r])
        div_a = fleet_compare(torch, label, cfg, params, e7.stop_ids, prompts_a, outs,
                              want_a, bounds)
        numbers["a"] = dict(requests=REMOTE_REQUESTS, burst_s=burst_a, worker_ready_s=ready_a,
                            handoffs=ho, wire=wire_a, fleet=fleet_a, mixed_control=mixed_a,
                            split_local=(split or {}).get("split"), first_token_ties=ties_a,
                            streams_equal=f"{REMOTE_REQUESTS - len(div_a)} of "
                                          f"{REMOTE_REQUESTS}", divergences=div_a)
        print(f"  {label}: wire {wire_a}; TTFT p50 / decode tok/s p50: remote "
              f"{fleet_a['ttft_p50_s']} / {fleet_a['decode_tok_s_p50']}, phase 17's local "
              f"split {numbers['a']['split_local']}, lone mixed {mixed_a}; "
              f"{numbers['a']['streams_equal']} streams equal; on {smi}", flush=True)

        # (b) a remote prefill worker pushing its handoffs, a local decode
        # replica; the worker killed mid-traffic.
        label = "remote_prefill"
        if "b" not in workers:
            workers["b"] = Worker(worker_command("prefill"), "b-prefill")
        sum_b, addr_b, ready_b = workers["b"].ready()
        assert sum_b == checksum, f"{label}: worker tree {sum_b} != {checksum}"
        print(f"  {label}: worker ready in {ready_b} s at {addr_b}, tree checksum equal; "
              f"{card_memory(torch)}", flush=True)
        addrs, killed, ready_c = [addr_b], [], {}

        def replacement():
            """Start the replacement worker unless it runs, wait until it
            listens, and make it r0's address."""
            if "c" not in workers:
                workers["c"] = Worker(worker_command("prefill"), "b-replacement")
            sum_c, addr_c, ready_c["s"] = workers["c"].ready()
            assert sum_c == checksum, f"{label}: replacement tree {sum_c} != {checksum}"
            addrs.append(addr_c)

        def r0_address():
            # A restart after the kill connects to the replacement, waiting
            # for it when it could not build before the kill.
            if killed and len(addrs) == 1:
                replacement()
            return addrs[-1]

        with WireProbe() as probe:
            sup = supervised(lambda i: transport(r0_address(), "r0") if i == 0
                             else make("decode"), label)
            pool = sup._inner
            tr, dec = pool.schedulers
            assert tr.phase_role == "prefill" and tr._dig("push_handoffs") is True
            torch.cuda.synchronize()
            reset_launches()
            h0 = sup.health()
            outs1, streams1, fleet_b = timed_burst(
                lambda p, on: sup.submit(p, max_new_tokens=MAX_NEW, on_token=on), prompts_b)
            fl1 = pool.fleet_stats()
            pulls = tr.transport_stats()["endpoints"].get("extract_handoffs", {}).get("rpcs", 0)
            beats_missed = sum(r.get("kind") == "lease_miss" for r in pool.flight_snapshot())
            print(f"  {label}: wave 1, {REMOTE_WAVE} requests: fleet {fl1}; pulled {pulls}; "
                  f"lease beats missed while pushing {beats_missed}", flush=True)
            assert all(o is not None for o in outs1), f"{label}: wave 1 lost a request"
            assert fl1["pushed"] >= REMOTE_WAVE and fl1["push_placed"] >= REMOTE_WAVE, fl1
            assert pulls == 0, f"{label}: the pull path ran {pulls} times"
            ties_b = streams_once(label, prompts_b, streams1, outs1, False)
            # The replacement builds before the kill when the card holds it
            # beside the live worker; else the restart waits for its build.
            overlapped["c"] = room_for_worker()
            if overlapped["c"]:
                replacement()
            print(f"  {label}: the replacement worker built "
                  f"{'before' if overlapped['c'] else 'after'} the kill; "
                  f"{card_memory(torch)}", flush=True)
            pushed0 = fl1["pushed"]
            streams2 = [[] for _ in prompts_b]
            futs2 = [sup.submit(p, max_new_tokens=MAX_NEW, on_token=streams2[i].append)
                     for i, p in enumerate(prompts_b)]
            deadline = time.perf_counter() + 300
            while pool.fleet_stats()["pushed"] == pushed0:
                assert time.perf_counter() < deadline, f"{label}: no push of wave 2"
                time.sleep(0.002)
            pushed_at_kill = pool.fleet_stats()["pushed"] - pushed0
            workers["b"].proc.kill()  # SIGKILL
            t_kill = time.perf_counter()
            killed.append(t_kill)
            workers["b"].proc.wait(timeout=60)
            if "c" not in workers:
                # Its build overlaps the lease's expiry.
                workers["c"] = Worker(worker_command("prefill"), "b-replacement")
            while tr._crash is None:
                assert time.perf_counter() - t_kill < 120, f"{label}: the lease never expired"
                time.sleep(0.002)
            t_expired = time.perf_counter()
            while not (pool.schedulers[0] is not tr
                       and pool._states[0].state in ("ready", "degraded")):
                assert time.perf_counter() - t_expired < 300, f"{label}: r0 never restarted"
                time.sleep(0.005)
            t_restarted = time.perf_counter()
            outs2 = []
            for f in futs2:
                try:
                    outs2.append(f.result(timeout=600))
                except Exception as e:  # noqa: BLE001 — a lost request, counted
                    print(f"    lost: {type(e).__name__}: {e}", flush=True)
                    outs2.append(None)
            # The healed fleet prefills through the replacement worker.
            fresh = pool.schedulers[0]
            healed = [sup.submit(p, max_new_tokens=MAX_NEW).result(timeout=600)
                      for p in prompts_b[:2]]
            healed_pushes = fresh.push_pump_stats["pushed"]
        wait_idle(dec)
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        expected = dict.fromkeys(LAUNCHES, 0)
        expect_paged(expected, dec, dec.rounds_issued, dec.prefill_forwards)
        health = sup.health()
        reps = {r["replica"]: r for r in pool.replica_health()}
        fl2 = pool.fleet_stats()
        replayed = health["replayed"] - h0["replayed"]
        lease_s = round(t_expired - t_kill, 4)
        restart_s = round(t_restarted - t_expired, 4)
        print(f"  {label}: wave 2: SIGKILL after {pushed_at_kill} push(es) of the wave; "
              f"lease expired {lease_s} s after it, r0 restarted {restart_s} s later; "
              f"replayed {replayed}, lost {health['lost']}; healed fleet: "
              f"{healed_pushes} push(es) through the replacement; replicas "
              f"{[(k, v['state'], v['restarts']) for k, v in reps.items()]}; fleet {fl2}; "
              f"local launches {launches[label]} expected {expected}", flush=True)
        assert all(o is not None for o in outs2) and health["lost"] == 0, health
        assert reps["r0"]["restarts"] == 1 and reps["r1"]["restarts"] == 0, reps
        assert replayed >= 1, f"{label}: nothing replayed after the kill"
        assert pushed_at_kill >= 1 and healed_pushes == 2, (pushed_at_kill, healed_pushes)
        assert launches[label] == expected, f"{label}: {launches[label]} != {expected}"
        ties_b += streams_once(label, prompts_b, streams2, outs2, True)
        assert dec.handoff_stats["imports"] == fl2["push_placed"], \
            (dec.handoff_stats, fl2)
        ps = dec.page_stats
        assert ps["pages_in_use"] == ps["prefix_resident_pages"], ps
        fresh.ping()
        assert fresh.page_stats["pages_in_use"] == fresh.page_stats["prefix_resident_pages"], \
            fresh.page_stats
        recv = [r for r in probe.records if r["kind"] == "handoff"]
        pushed_frames = [r["wire"] for k in ("b", "c") for r in workers[k].records
                         if "wire" in r]
        blob_checks(label, pushed_frames, [])
        assert len(recv) >= fl1["pushed"] + pushed_at_kill + healed_pushes, len(recv)
        sup.shutdown()
        del sup, pool, tr, dec, fresh
        gc.collect()
        torch.cuda.empty_cache()
        rc, line = workers["c"].stop()
        assert rc == 0, f"{label}: the replacement worker exited {rc}"
        wl = check_worker_launches(label, line)
        launches[label] = {k: v + wl[k] for k, v in launches[label].items()}
        div_b = fleet_compare(torch, label, cfg, params, e7.stop_ids,
                              prompts_b * 2 + prompts_b[:2], outs1 + outs2 + healed,
                              want_b * 2 + want_b[:2], bounds)
        wire_b = wire_summary(recv + pushed_frames)
        numbers["b"] = dict(
            requests=2 * REMOTE_WAVE + 2, worker_ready_s=ready_b,
            replacement_ready_s=ready_c.get("s"), worker_footprint_gib=round(footprint, 2),
            built_during={"b_before_a_stopped": overlapped["b"],
                          "c_before_kill": overlapped["c"]},
            pushed={"wave1": fl1["pushed"], "wave2_before_sigkill": pushed_at_kill,
                    "healed": healed_pushes}, push_bytes_wave1=fl1["push_bytes"],
            push_place_ms={"p50": fl2.get("push_place_p50_ms"),
                           "p95": fl2.get("push_place_p95_ms")},
            lease_beats_missed_wave1=beats_missed, sigkill_to_lease_expiry_s=lease_s,
            restart_s=restart_s, replayed=replayed, healed_pushes=healed_pushes,
            wire=wire_b, fleet=fleet_b, mixed_control=mixed_b, first_token_ties=ties_b,
            streams_equal=f"{2 * REMOTE_WAVE + 2 - len(div_b)} of {2 * REMOTE_WAVE + 2}",
            divergences=div_b)
        print(f"  {label}: push -> placed ms p50 {fl2.get('push_place_p50_ms')} p95 "
              f"{fl2.get('push_place_p95_ms')}; wire {wire_b}; TTFT p50 / decode tok/s p50 "
              f"remote {fleet_b['ttft_p50_s']} / {fleet_b['decode_tok_s_p50']}, lone mixed "
              f"{mixed_b}; {numbers['b']['streams_equal']} streams equal; on {smi}",
              flush=True)
    finally:
        for w in workers.values():
            w.kill()
    return launches, numbers


def remote_cli(torch, hf_dir, device_args=()):
    """Phase 18 (c): the worker's real command line on the card, `python -m
    <package>.serve.remote --from-hf DIR --kv-layout paged --kv-page-size
    64`, over phase 10's 4-layer 7B HF directory: its hello digest (config,
    page geometry, model id, role), two requests whose tokens equal an
    in-process scheduler's over the same directory (each request alone on
    both sides), a clean stop on SIGINT; then the same command with no card
    visible and no `--cpu` exits non-zero, naming the card. `device_args`
    go to the served command only."""
    import signal

    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import load_hf_checkpoint
    from llm_based_apache_spark_optimization_tpu_torch.serve import resolve_stop_ids
    from llm_based_apache_spark_optimization_tpu_torch.serve.remote import SocketTransport
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import HFTokenizer

    cmd = [sys.executable, "-m", f"{PKG}.serve.remote", "--from-hf", hf_dir,
           "--kv-layout", "paged", "--kv-page-size", "64"]
    torch.cuda.empty_cache()
    w = Worker([*cmd, *device_args], "cli")
    # The same command with no card visible, run meanwhile.
    no_card = subprocess.Popen(
        cmd, env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                      PYTHONPATH=os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cfg, params = load_hf_checkpoint(hf_dir, dtype=torch.bfloat16, device="cuda")
        tok = HFTokenizer(hf_dir)
        stops = resolve_stop_ids(cfg, tok)
        line = w.wait_for(lambda x: x.startswith("lsot-remote-worker listening on "), 300)
        up = round(time.perf_counter() - w.t0, 3)
        tr = SocketTransport(line.split()[-1], label="cli", rpc_timeout_s=REMOTE_RPC_S)
        digest = (dataclasses.replace(tr.cfg, rope_scaling=cfg.rope_scaling) == cfg,
                  tr._paged, tr._page_size, tr.model_id, tr.phase_role, tr.num_slots,
                  tr.max_seq)
        print(f"  `python {' '.join(cmd[1:])}`: listening in {up} s; hello digest (config "
              f"equal, paged, page size, model id, role, slots, max_seq) {digest}",
              flush=True)
        assert digest == (True, True, 64, "", "mixed", 2, 96), digest
        prompts = [tok.encode(q) for q in QUESTIONS[:2]]
        got = [tr.submit(p, max_new_tokens=16).result(timeout=300) for p in prompts]
        tr.shutdown()
        sched = ContinuousBatchingScheduler(cfg, params, num_slots=2, decode_chunk=4,
                                            prompt_bucket=8, stop_ids=stops, max_seq=96,
                                            kv_layout="paged", kv_page_size=64,
                                            device="cuda")
        with sched:
            want = [sched.submit(p, max_new_tokens=16).result(timeout=300) for p in prompts]
        del sched, params
        print(f"  two requests over the wire {[len(x) for x in got]} tokens, equal to the "
              f"in-process scheduler's: {got == want}", flush=True)
        assert got == want, (got, want)
        w.proc.send_signal(signal.SIGINT)
        rc = w.proc.wait(timeout=60)
        assert rc == 0, f"the worker exited {rc} on SIGINT: {w.log[-5:]}"
    finally:
        w.kill()
        try:
            out, errs = no_card.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            no_card.kill()
            out, errs = no_card.communicate()
    err = errs.strip().splitlines()[-1] if errs.strip() else ""
    print(f"  with no card visible and no --cpu: exit {no_card.returncode}, {err!r}",
          flush=True)
    assert no_card.returncode != 0 and "CUDA" in err and "listening" not in out, \
        (no_card.returncode, errs[-500:])
    torch.cuda.empty_cache()
    return {"up_s": up, "digest_ok": True, "tokens_equal": True,
            "no_card_exit": no_card.returncode}


# ----------------------------------------------------------------- elastic

ELASTIC_WAVE = 16        # (a): wave 1's requests, submitted at once
ELASTIC_WAVE2 = 6        # (a): wave 2's, on the shrunk fleet
ELASTIC_LOAD_S = 120.0   # (a): the longest wave 1 keeps its load up for the join
# (a)'s autoscaler: a fleet of 1 to 2, up at 2 queued requests a serving
# replica, down at 0.5, a signal held 1 s, actions at least 2 s apart. A
# retire's drain waits for a remote replica's work by its last load digest,
# which its lease stops refreshing once it drains: a worker whose last
# request's "done" frame counted a live slot waits out the deadline, 5 s here.
ELASTIC_KNOBS = dict(fleet_min=1, fleet_max=2, scale_up_q=2.0, scale_down_q=0.5,
                     hold_s=1.0, interval_s=2.0, drain_deadline_s=5.0)
ELASTIC_HARNESS_NEW = 16  # (b): the harness's --max-new-tokens (32 until phase 20 came)


class Background:
    """A command run beside the phase, its output in files (the chaos run
    logs more than a pipe holds); `wait` bounds it and returns (exit code,
    stdout, the tail of stderr, the seconds the command ran)."""

    def __init__(self, cmd, name):
        import tempfile
        import threading

        self.t0 = time.perf_counter()
        self.t_end = None
        d = tempfile.mkdtemp(prefix=f"lsot-{name}-")
        self.out = open(os.path.join(d, "out"), "w+")
        self.err = open(os.path.join(d, "err"), "w+")
        self.proc = subprocess.Popen(
            cmd, stdout=self.out, stderr=self.err, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))

        def stamp():
            self.proc.wait()
            self.t_end = time.perf_counter()

        threading.Thread(target=stamp, daemon=True).start()

    def wait(self, timeout):
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(timeout=60)
        seconds = round((self.t_end or time.perf_counter()) - self.t0, 3)
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        self.out.close()
        self.err.close()
        return rc, out, err[-4000:], seconds

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def prometheus_fleet(text):
    """The `lsot_fleet_*` samples of a Prometheus page."""
    return [ln for ln in text.splitlines() if ln.startswith("lsot_fleet_")]


def evalh_command(*args, module="evalh"):
    """`python -m <package>.<module> ARGS`: the eval harness's entry points."""
    return [sys.executable, "-m", f"{PKG}.{module}", *args]


def chaos_checks(out):
    """Phase 19 (c): the chaos run's report (the JSON object its stdout
    ends with): nothing hung, every stage's loss count and `mismatched` 0,
    stage 8's streams exactly once with a join and a pushed handoff."""
    rep = json.loads(out[out.index("{"):])
    assert rep["hung"] == 0, rep["hung"]
    for key in ("scheduler", "watchdog", "fleet"):
        assert rep[key]["lost"] == rep[key]["unresolved"] == rep[key]["mismatched"] == 0, \
            (key, rep[key])
    for key in ("kv_pressure", "disagg", "elastic", "qos", "repair"):
        assert rep[key]["lost"] == 0, (key, rep[key])
    for key in ("kv_pressure", "disagg", "elastic", "qos"):
        assert rep[key]["mismatched"] == 0, (key, rep[key])
    net = rep["transport"]
    assert net["lost_total"] == 0, net
    for tag, w in net["waves"].items():
        assert w["lost"] == w["mismatched"] == w["stream_violations"] == 0, (tag, w)
    el = rep["elastic"]
    assert el["stream_violations"] == 0 and el["joins"] >= 1 and el["pushed_handoffs"] >= 1, el
    return rep


def elastic_serve(torch, engines, smi):
    """Phase 19: the elastic fleet and the eval harness on the card.

    (a) An autoscaled 7B fleet through the pool API: a supervised
    `SchedulerPool` of one local mixed replica of phase 7's 7B bf16 tree
    (phase 17's shape: paged, pages of 64, DISAGG_SLOTS slots, DISAGG_HBM_GB
    GiB of KV), a standby `serve.remote` worker of the same tree (a process
    of this file, `--remote-worker mixed`, building while the lone control
    runs) that `standby_spawner` points at, and `FleetAutoscaler(...).run()`
    with ELASTIC_KNOBS. `fleet:spawn` is armed for the first scale-up attempt
    only. Wave 1: ELASTIC_WAVE requests at once, the load then held at
    ELASTIC_WAVE outstanding (each finished request replaced) until the
    standby has joined and taken a placement: the first attempt must count
    one spawn failure with the fleet unchanged, a later one joins the standby
    through the handshake. Once idle, the autoscaler retires the joined
    replica by drain (downs 1, fleet 1), and wave 2, ELASTIC_WAVE2 requests,
    runs on the shrunk fleet. Every stream is delivered once and held to a
    lone mixed scheduler from the same factory (`fleet_compare`'s near-tie
    rule); nothing is lost; launch counts are exact here and in the worker.

    (b) The harness at 7B over a `GenerationService` registering (a)'s pool
    as `duckdb-nsql`: `evaluate_models` on FOUR_QUERY_SUITE against the taxi
    fixture, `run_repair_leg` on SPIDER_SMOKE with injection off and on,
    ELASTIC_HARNESS_NEW new tokens; every case terminal, the row counts the
    suites'.

    (c) `python -m ...evalh --chaos`, its schedulers on the card, run beside
    (a)-(b) (`chaos_checks`), its stages' seconds printed.

    (d) Host only, beside them: `...evalh --backend oracle` reads 100% exact
    and execution match; `...evalh.report --backend oracle -o -` names the
    card and its power limit in its header.

    Returns (launches by path, numbers)."""
    from llm_based_apache_spark_optimization_tpu_torch.evalh.fixtures import (
        FOUR_QUERY_SUITE,
        TAXI_DDL_SYSTEM,
    )
    from llm_based_apache_spark_optimization_tpu_torch.evalh.harness import (
        evaluate_models,
        format_summary,
    )
    from llm_based_apache_spark_optimization_tpu_torch.evalh.repair import (
        format_repair_summary,
        run_repair_leg,
    )
    from llm_based_apache_spark_optimization_tpu_torch.evalh.report import (
        make_taxi_exec_backend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.evalh.spider import SPIDER_SMOKE
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import GenerationService
    from llm_based_apache_spark_optimization_tpu_torch.serve.elastic import FleetAutoscaler
    from llm_based_apache_spark_optimization_tpu_torch.serve.factory import standby_spawner
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerBackend,
        SchedulerPool,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    e7 = fleet_model(engines["duckdb-nsql"])
    cfg, params = e7.cfg, e7.params
    tok = ByteTokenizer()
    label = "elastic_pool"
    checksum = tree_checksum(torch, params)
    distinct = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in SCHED_SQL]
    background = {
        "chaos": Background(evalh_command("--chaos"), "chaos"),
        "oracle": Background(evalh_command("--backend", "oracle"), "oracle"),
        "report": Background(evalh_command("--backend", "oracle", "-o", "-",
                                           module="evalh.report"), "report"),
    }
    worker = Worker(worker_command("mixed"), "standby")
    numbers = {"device": smi}
    launches, bounds = {}, {}

    def make():
        # FIFO admission (`qos=False`): under WFQ the loop moves the submit
        # queue into its ready pool every round, and `replica_loads`'
        # `queued`, the autoscaler's signal, counts the submit queue alone.
        return ContinuousBatchingScheduler(
            cfg, params, num_slots=DISAGG_SLOTS, stop_ids=e7.stop_ids,
            kv_layout="paged", kv_page_size=SCHED["kv_page_size"],
            kv_hbm_budget_bytes=DISAGG_HBM_GB * 2**30, qos=False, device="cuda")

    def placements():
        """Placements per replica in the pool's flight ring."""
        out = {}
        for r in sup._inner.flight_snapshot():
            if r.get("kind") == "placement":
                out[r["to"]] = out.get(r["to"], 0) + 1
        return out

    try:
        # The lone control of every distinct prompt, while the standby builds.
        lone = make()
        with lone:
            want, _, mixed = timed_burst(
                lambda p, on: lone.submit(p, max_new_tokens=MAX_NEW, on_token=on), distinct)
        del lone
        gc.collect()
        torch.cuda.empty_cache()
        sum_w, addr, ready_s = worker.ready()
        assert sum_w == checksum, f"{label}: standby tree {sum_w} != {checksum}"
        print(f"  {label}: standby worker ready in {ready_s} s at {addr}, tree checksum "
              f"equal; {card_memory(torch)}", flush=True)

        # (a) the autoscaled fleet.
        torch.cuda.synchronize()
        reset_launches()
        # Placement by load (`affinity_routing=False`): prefix affinity comes
        # first in the pool's order, and every request here shares the schema
        # prefix resident on r0, so a joined replica would take none.
        sup = SupervisedScheduler(
            lambda: SchedulerPool([make()], factory=lambda i: make(),
                                  affinity_routing=False, lease_s=REMOTE_LEASE_S,
                                  lease_misses=REMOTE_LEASE_MISSES),
            stall_min_s=REMOTE_STALL_MIN_S, name=f"scheduler-pool:{label}").start()
        r0 = sup._inner.schedulers[0]
        svc = GenerationService()
        svc.register("duckdb-nsql", SchedulerBackend(sup, tok, max_new_tokens=MAX_NEW))
        auto = FleetAutoscaler(sup, standby_spawner(addr, connect_timeout_s=30.0),
                               **ELASTIC_KNOBS)
        FAULTS.configure("fleet:spawn:1", 0)
        auto.run()
        which, streams, futs = [], [], []

        def submit():
            i = len(futs) % len(distinct)
            which.append(i)
            streams.append([])
            futs.append(sup.submit(distinct[i], max_new_tokens=MAX_NEW,
                                   on_token=streams[-1].append))

        t_burst = time.perf_counter()
        for _ in range(ELASTIC_WAVE):
            submit()
        pending = set(range(ELASTIC_WAVE))
        t_fail = t_join = t_placed = size_at_fail = None
        while t_placed is None:
            assert time.perf_counter() - t_burst < ELASTIC_LOAD_S, \
                (f"{label}: no join with a placement in {ELASTIC_LOAD_S} s: "
                 f"{auto.stats()}; placements {placements()}; done "
                 f"{sum(f.done() for f in futs)} of {len(futs)}; replicas "
                 f"{[(r['replica'], r['state']) for r in sup.replica_loads()]}; events "
                 f"{[r for r in sup._inner.flight_snapshot() if r.get('kind', '').startswith('replica_')]}")
            st = auto.stats()
            if t_fail is None and st["spawn_failures"]:
                FAULTS.clear()  # armed for the first attempt only
                t_fail = time.perf_counter()
                size_at_fail = int(sup.fleet_stats()["size"])
            if t_join is None and st["ups"]:
                t_join = time.perf_counter()
            if t_join is not None and placements().get("r1"):
                t_placed = time.perf_counter()
                break
            for k in [k for k in pending if futs[k].done()]:
                assert futs[k].exception() is None, f"{label}[{k}]: {futs[k].exception()!r}"
                pending.discard(k)
                submit()
                pending.add(len(futs) - 1)
            time.sleep(0.005)
        FAULTS.clear()
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=600))
            except Exception as e:  # noqa: BLE001 — a lost request, counted
                print(f"    lost: {type(e).__name__}: {e}", flush=True)
                outs.append(None)
        wave1_s = round(time.perf_counter() - t_burst, 4)
        placed1 = placements()
        stats_up = auto.stats()
        print(f"  {label}: wave 1: {len(futs)} requests ({ELASTIC_WAVE} at once, the load "
              f"held until the join) in {wave1_s} s; spawn failure "
              f"{round(t_fail - t_burst, 4)} s after the burst (fleet size {size_at_fail}), "
              f"join {round(t_join - t_burst, 4)} s after it, first placement on r1 "
              f"{round(t_placed - t_join, 4)} s after the join; placements {placed1}; "
              f"autoscaler {stats_up}", flush=True)
        assert size_at_fail == 1 and stats_up["spawn_failures"] == 1, stats_up
        assert stats_up["ups"] == 1 and placed1.get("r1", 0) >= 1, (stats_up, placed1)

        # The idle fleet shrinks: the autoscaler retires r1 by drain.
        deadline = time.perf_counter() + 60
        while auto.stats()["downs"] < 1:
            assert time.perf_counter() < deadline, f"{label}: no retire: {auto.stats()}"
            time.sleep(0.02)
        t_retired = time.perf_counter()
        fl_retired = sup.fleet_stats()
        print(f"  {label}: retired {round(t_retired - t_burst - wave1_s, 4)} s after wave 1 "
              f"ended; drain {fl_retired['drain_s_sum']} s; fleet {fl_retired}", flush=True)
        assert fl_retired["serving"] == 1 and fl_retired["retires"] == 1, fl_retired

        # Wave 2 on the shrunk fleet.
        before2 = placements()
        prompts2 = distinct[:ELASTIC_WAVE2]
        outs2, streams2, wave2 = timed_burst(
            lambda p, on: sup.submit(p, max_new_tokens=MAX_NEW, on_token=on), prompts2)
        placed2 = {k: v - before2.get(k, 0) for k, v in placements().items()}
        families = prometheus_fleet(svc.metrics_prometheus())
        auto.stop()
        stats = auto.stats()
        health = sup.health()
        print(f"  {label}: wave 2: {ELASTIC_WAVE2} requests, placements {placed2}, "
              f"TTFT p50 {wave2['ttft_p50_s']} s; autoscaler {stats}; lost "
              f"{health['lost']}; on {smi}", flush=True)
        for ln in families:
            print(f"    {ln}", flush=True)
        assert stats["downs"] == 1 and stats["ups"] == 1, stats
        assert placed2.get("r0", 0) == ELASTIC_WAVE2 and not placed2.get("r1"), placed2
        assert all(o is not None for o in outs + outs2) and health["lost"] == 0, health
        for i, (s, o) in enumerate(zip(streams + streams2, outs + outs2)):
            assert s == o, f"{label}[{i}]: stream {s} != result {o}"
        assert any(ln.startswith("lsot_fleet_joins_total") for ln in families), families

        # (b) the harness over the same pool (fleet of one now).
        t0 = time.perf_counter()
        reports = evaluate_models(svc, ["duckdb-nsql"], FOUR_QUERY_SUITE, TAXI_DDL_SYSTEM,
                                  max_new_tokens=ELASTIC_HARNESS_NEW,
                                  exec_backend=make_taxi_exec_backend())
        rep = reports["duckdb-nsql"]
        legs = [run_repair_leg(svc, "duckdb-nsql", cases=SPIDER_SMOKE, inject=inject,
                               max_new_tokens=ELASTIC_HARNESS_NEW)
                for inject in (False, True)]
        harness_s = round(time.perf_counter() - t0, 4)
        print(format_summary(reports), flush=True)
        for leg in legs:
            print(format_repair_summary(leg), flush=True)
        lat = p50([c.latency_s for c in rep.cases])
        print(f"  {label}: harness in {harness_s} s: latency p50 {lat} s, aggregate "
              f"{rep.aggregate_tok_per_s:.3f} tok/s, on {smi}", flush=True)
        assert len(rep.cases) == len(FOUR_QUERY_SUITE), len(rep.cases)
        assert all(c.executable is not None and c.grammar_valid is not None
                   for c in rep.cases), rep.cases
        for leg in legs:
            assert leg["cases"] == len(SPIDER_SMOKE) == len(leg["per_case"]), leg["cases"]
            assert all(r["success_round"] is not None or r["error_class"]
                       for r in leg["per_case"]), leg["per_case"]

        # Launch counts: this process's replica, then the worker's.
        wait_idle(r0)
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        expected = dict.fromkeys(LAUNCHES, 0)
        expect_paged(expected, r0, r0.rounds_issued, r0.prefill_forwards)
        print(f"  {label}: local launches {launches[label]} expected {expected}", flush=True)
        assert launches[label] == expected, f"{label}: {launches[label]} != {expected}"
        sup.shutdown()
        del sup, r0, svc, auto
        gc.collect()
        torch.cuda.empty_cache()
        rc, line = worker.stop()
        assert rc == 0, f"{label}: the standby worker exited {rc}"
        wl = check_worker_launches(label, line)
        launches[label] = {k: v + wl[k] for k, v in launches[label].items()}
        div = fleet_compare(torch, label, cfg, params, e7.stop_ids,
                            [distinct[i] for i in which] + prompts2, outs + outs2,
                            [want[i] for i in which] + want[:ELASTIC_WAVE2], bounds)
        n = len(outs) + len(outs2)
        numbers["a"] = dict(
            knobs=ELASTIC_KNOBS, standby_ready_s=ready_s, wave1_requests=len(futs),
            wave1_s=wave1_s, burst_to_spawn_failure_s=round(t_fail - t_burst, 4),
            burst_to_join_s=round(t_join - t_burst, 4),
            join_to_first_placement_s=round(t_placed - t_join, 4),
            placements_wave1=placed1, placements_wave2=placed2,
            retire_drain_s=fl_retired["drain_s_sum"],
            wave1_end_to_retire_s=round(t_retired - t_burst - wave1_s, 4),
            autoscaler=stats, fleet_after_retire=fl_retired, fleet_families=families,
            wave2=wave2, lone_mixed=mixed, streams_equal=f"{n - len(div)} of {n}",
            divergences=div)
        numbers["b"] = dict(
            seconds=harness_s, cases=len(rep.cases), latency_p50_s=lat,
            aggregate_tok_s=round(rep.aggregate_tok_per_s, 3),
            exact_match_rate=rep.exact_match_rate, executable_rate=rep.executable_rate,
            repair={leg["suite"]: leg["executable_after"] for leg in legs})

        # (c) and (d): the runs beside the phase.
        rc, out, err, secs = background["chaos"].wait(600)
        assert rc == 0, f"chaos run exited {rc}: {err}"
        chaos = chaos_checks(out)
        print(f"  chaos (c): {secs} s on the card; hung {chaos['hung']}; stage seconds "
              f"{chaos['stage_seconds']}; elastic joins {chaos['elastic']['joins']}, "
              f"pushed {chaos['elastic']['pushed_handoffs']}", flush=True)
        numbers["c"] = dict(seconds=secs, stage_seconds=chaos["stage_seconds"],
                            hung=chaos["hung"], outcomes=chaos["outcomes"],
                            elastic={k: chaos["elastic"][k] for k in (
                                "joins", "pushed_handoffs", "scale_ups", "spawn_failures",
                                "retires", "stream_violations")})
        rc, out, err, secs = background["oracle"].wait(300)
        assert rc == 0, f"oracle run exited {rc}: {err}"
        assert out.count("Exact Match Rate: 100.00%") == 3, out
        assert out.count("Execution Match Rate: 100.00%") == 3, out
        rc, out2, err, secs2 = background["report"].wait(300)
        assert rc == 0, f"oracle report exited {rc}: {err}"
        header = next(ln for ln in out2.splitlines() if ln.startswith("Backend:"))
        assert f"platform: **cuda: {smi}**" in header, (header, smi)
        print(f"  host (d): oracle 100% exact and execution match ({secs} s); report "
              f"header: {header[header.index('platform'):]}", flush=True)
        numbers["d"] = dict(oracle_s=secs, report_s=secs2,
                            report_platform=header[header.index("platform"):])
    finally:
        FAULTS.clear()
        worker.kill()
        for b in background.values():
            b.kill()
    return launches, numbers


# --------------------------------------------------------------- profile


def profile_device(torch, label, send):
    """Device time by kernel group over `send()` (`--profile`), which
    returns the tokens it generated, and the device's busy share of its
    wall time under the profiler. Returns the device ms by group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_tokens = send()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side rows only: a CPU op's row repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda x: -x[1])
    busy_us = sum(x[1] for x in rows)
    groups = {"flash attention": 0.0, "paged attention": 0.0, "page write": 0.0,
              "int4 matmul": 0.0, "int8 matmul": 0.0, "matmul": 0.0, "other": 0.0}
    for key, us, _ in rows:
        if "int4_" in key:
            groups["int4 matmul"] += us
        elif any(w in key for w in ("int8_gemv", "int8_decode", "int8_wgmma")):
            groups["int8 matmul"] += us
        elif "PagedSrc" in key:
            groups["paged attention"] += us
        elif any(w in key for w in ("gqa_tile", "flash_prefill", "decode_split")):
            groups["flash attention"] += us
        elif "page_write_kernel" in key:
            groups["page write"] += us
        elif any(w in key.lower() for w in ("nvjet", "gemm", "gemv", "cutlass")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    print(f"  {label}: {n_tokens} tokens, wall {wall_us / 1e3:.1f} ms "
          f"under the profiler, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / wall_us:.1f}%)", flush=True)
    print("  device ms by group: " + ", ".join(
        f"{k} {v / 1e3:.2f}" for k, v in groups.items()), flush=True)
    for key, us, n in rows[:15]:
        print(f"    {us / 1e3:9.3f} ms  x{n:<6d} {key[:110]}", flush=True)
    return {k: v / 1e3 for k, v in groups.items()}


# ---------------------------------------------------------------- timing


def prefill_digests(torch, attn_mod):
    """sha256 (first 16 hex digits) of the bf16 flash prefill's output at
    each prefill case of `cases()`: two commits whose kernels compute the
    same bits print the same digests."""
    import hashlib

    out = {}
    for launch, name, kw in cases():
        if launch != "prefill":
            continue
        c = make_case(torch, torch.bfloat16, **kw)
        o = attn_mod.flash_gqa_attention_cuda(c["q"], c["k"], c["v"], c["pos"],
                                              c["window"], c["kv_lens"])
        torch.cuda.synchronize()
        out[name] = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"  prefill digests {json.dumps(out)}", flush=True)
    return out


def time_ms(torch, fn, calls, reps=20):
    """Device ms per call of `fn(i)`: `calls` calls (one per layer) captured
    in one CUDA graph, replayed `reps` times between CUDA events, so the
    host's Python dispatch is not in the time."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def time_launch(torch, attn_mod, n, kh, h, layers, b, t, s, positions, kv_lens=None):
    """Kernel, plain and SDPA times on one layer's shapes, cycling over a
    [layers, B, K, S, H] cache so reads come from device memory. `kv_lens`
    defaults to max(position) + 1 a row (0 for a parked row)."""
    import torch.nn.functional as F

    dev, dt = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, t, n, h), generator=g, device=dev).to(dt)
    kc = torch.randn((layers, b, kh, s, h), generator=g, device=dev).to(dt)
    vc = torch.randn((layers, b, kh, s, h), generator=g, device=dev).to(dt)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    kvl = (pos.max(dim=1).values + 1 if kv_lens is None
           else torch.tensor(kv_lens, dtype=torch.int32, device=dev))
    ms = time_ms(torch, lambda i: attn_mod.flash_gqa_attention_cuda(
        q, kc[i % layers], vc[i % layers], pos, None, kvl), layers)
    plain = time_ms(torch, lambda i: attn_mod.flash_gqa_attention_plain(
        q, kc[i % layers], vc[i % layers], pos, None, kvl), layers)
    # SDPA yardstick: [B, N, T, H] views, K/V repeated to N heads outside
    # the timed call, the same boolean visibility mask.
    grp = n // kh
    qt = q.transpose(1, 2)
    kr = [kc[l].repeat_interleave(grp, dim=1) if grp > 1 else kc[l] for l in range(layers)]
    vr = [vc[l].repeat_interleave(grp, dim=1) if grp > 1 else vc[l] for l in range(layers)]
    idx = torch.arange(s, device=dev)
    mask = ((idx[None, None, :] <= pos[:, :, None].long())
            & (idx[None, None, :] < kvl[:, None, None]))[:, None]  # [B,1,T,S]
    lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kr[i % layers], vr[i % layers], attn_mask=mask), layers)
    # Bound: q, live K/V (slots < kv_len) and out once each; 4*H FLOPs per
    # visible (query head, key) pair.
    live = int(kvl.clamp(max=s).sum())
    nbytes = 2 * (q.numel() * 2 + 2 * live * kh * h)
    vis = int(mask.sum()) * n
    flops = 4 * h * vis
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=dict(B=b, T=t, N=n, K=kh, S=s, H=h, dtype="bfloat16",
                           **({} if kv_lens is None else {"kv_lens": kv_lens})))


def time_host(torch, fn, calls, reps=5):
    """Device ms per call of `fn(i)` dispatched from the host between CUDA
    events: for a function that synchronises and so cannot be captured in
    a CUDA graph (the plain page write selects its kept slivers)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for i in range(calls):
            fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


PAGED_LENS = [64, 200, 333, 480, 600, 777, 900, 1024]  # live tokens per row


WRITE_VARIANTS = ("floor_ms", "prefetch_ms", "no_prefetch_ms")


def time_write_variants(torch, pw_mod, write, pos, n_layers):
    """More kernel times of a page write `write(layer, positions)`, in
    `time_ms`'s graph: `floor_ms`, every position -1 (every sliver dropped:
    the launch and the coordinate chain, no store); `prefetch_ms` and
    `no_prefetch_ms`, with `table_prefetch` forced on (the row's whole
    table loaded beside the position) and off (the one entry loaded after
    it), the rule's pick being `ms` (both absent from a package without
    the rule)."""
    dead = torch.full_like(pos, -1)
    out = {"floor_ms": time_ms(torch, lambda l: write(l, dead), n_layers)}
    rule = getattr(pw_mod, "table_prefetch", None)
    if rule is not None:
        try:
            for key, forced in (("prefetch_ms", True), ("no_prefetch_ms", False)):
                pw_mod.table_prefetch = lambda np_tab, quantized, f=forced: f
                out[key] = time_ms(torch, lambda l: write(l, pos), n_layers)
        finally:
            pw_mod.table_prefetch = rule
    return out


def time_paged(torch, pa_mod, pw_mod, cfg):
    """The paged decode launches at 7B: B = 8 rows at PAGED_LENS through
    tables of pages of 64 over a full-depth pool, one call per layer.
    Ragged paged attention: kernel, plain, and SDPA over K/V gathered
    through the tables in advance (the gather is not timed). Page write of
    the decode step's own position, kv_lens - 1 (T = 1): kernel, plain
    (host-dispatched: it synchronises) and index_put_ of the same slivers
    at precomputed coordinates."""
    import torch.nn.functional as F

    dev, dt = "cuda", torch.bfloat16
    ps, np_tab, n_layers = 64, 16, cfg.num_layers
    n, kh, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = len(PAGED_LENS)
    need = [-(-x // ps) for x in PAGED_LENS]
    pool_pages = sum(need) + 7
    g = torch.Generator(device=dev).manual_seed(4)
    shape = (n_layers, pool_pages, kh, ps, h)
    kp = torch.randn(shape, generator=g, device=dev, dtype=dt)
    vp = torch.randn(shape, generator=g, device=dev, dtype=dt)
    perm = torch.randperm(pool_pages, generator=g, device=dev).tolist()
    rows, i = [], 0
    for nd in need:
        rows.append(perm[i:i + nd] + [pool_pages] * (np_tab - nd))
        i += nd
    tab = torch.tensor(rows, dtype=torch.int32, device=dev)
    kvl = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    pos = (kvl - 1)[:, None]
    q = torch.randn((b, 1, n, h), generator=g, device=dev, dtype=dt)

    ms = time_ms(torch, lambda l: pa_mod.ragged_paged_attention_cuda(
        q, kp[l], vp[l], tab, pos, None, kvl), n_layers)
    plain = time_ms(torch, lambda l: pa_mod.ragged_paged_attention_plain(
        q, kp[l], vp[l], tab, pos, None, kvl), n_layers)
    grp = n // kh
    kg = [pa_mod.gather_pages(kp[l], tab).repeat_interleave(grp, dim=1)
          for l in range(n_layers)]
    vg = [pa_mod.gather_pages(vp[l], tab).repeat_interleave(grp, dim=1)
          for l in range(n_layers)]
    mask = (torch.arange(np_tab * ps, device=dev)[None, :] < kvl[:, None])[:, None, None]
    qt = q.transpose(1, 2)
    lib = time_ms(torch, lambda l: F.scaled_dot_product_attention(
        qt, kg[l], vg[l], attn_mask=mask), n_layers)
    del kg, vg
    live = sum(PAGED_LENS)
    b_ms, b_by = bound(2 * (2 * live * kh * h + 2 * q.numel()), 4 * h * live * n)
    paged = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 shape=dict(B=b, T=1, N=n, K=kh, H=h, page=ps, kv_lens=PAGED_LENS,
                            dtype="bfloat16"))

    kn = torch.randn((b, 1, kh, h), generator=g, device=dev, dtype=dt)
    vn = torch.randn_like(kn)

    def write_cuda(l, p):
        pw_mod.fused_page_write_cuda(kp, vp, kn, vn, p, tab, l)

    ms = time_ms(torch, lambda l: write_cuda(l, pos), n_layers)
    variants = time_write_variants(torch, pw_mod, write_cuda, pos, n_layers)
    plain = time_host(torch, lambda l: pw_mod.fused_page_write_plain(
        kp, vp, kn, vn, pos, tab, l), n_layers)
    pages, offs = pw_mod.page_coords(pos, tab, ps, pool_pages)
    pg, of = pages.reshape(-1), offs.reshape(-1)
    assert bool((pg < pool_pages).all())  # every sliver lands

    def index_put(l):
        kp[l][pg, :, of] = kn[:, 0]
        vp[l][pg, :, of] = vn[:, 0]

    lib = time_ms(torch, index_put, n_layers)
    b_ms, b_by = bound(2 * 2 * kn.numel() * kn.element_size(), 0)
    write = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 **variants, shape=dict(B=b, T=1, K=kh, H=h, page=ps, dtype="bfloat16"))
    return paged, write


def time_decode_quantized(torch, attn_mod, n, kh, h, layers, s, positions,
                          kv_lens=None):
    """The quantized decode launch at the 7B decode, one row per entry of
    `positions` (the engine's B = 1 and batch of four, the contiguous
    scheduler's 8 slots with `kv_lens` 0 for parked rows): kernel, plain
    and SDPA over K/V dequantized to bf16 in advance, cycling over an int8
    [layers, B, K, S, H] cache so reads come from device memory."""
    import torch.nn.functional as F

    dev, dt, b = "cuda", torch.bfloat16, len(positions)
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, 1, n, h), generator=g, device=dev).to(dt)
    k8, ks = zip(*(quantize(torch, torch.randn((b, kh, s, h), generator=g, device=dev))
                   for _ in range(layers)))
    v8, vs = zip(*(quantize(torch, torch.randn((b, kh, s, h), generator=g, device=dev))
                   for _ in range(layers)))
    pos = torch.tensor([[p] for p in positions], dtype=torch.int32, device=dev)
    kv_lens = kv_lens or [p + 1 for p in positions]
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda i: attn_mod.flash_gqa_attention_quantized_cuda(
        q, k8[i], ks[i], v8[i], vs[i], pos, None, kvl), layers)
    plain = time_ms(torch, lambda i: attn_mod.flash_gqa_attention_quantized_plain(
        q, k8[i], ks[i], v8[i], vs[i], pos, None, kvl), layers)
    grp = n // kh
    kr = [attn_mod.dequantize_kv(k8[l], ks[l], dt).repeat_interleave(grp, dim=1)
          for l in range(layers)]
    vr = [attn_mod.dequantize_kv(v8[l], vs[l], dt).repeat_interleave(grp, dim=1)
          for l in range(layers)]
    mask = (torch.arange(s, device=dev) < kvl[:, None])[:, None, None]
    qt = q.transpose(1, 2)
    lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kr[i], vr[i], attn_mask=mask), layers)
    live = sum(kv_lens)
    b_ms, b_by = bound(2 * 2 * q.numel() + live * kh * (2 * h + 8), 4 * h * live * n)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                shape=dict(B=b, T=1, N=n, K=kh, S=s, H=h, kv_lens=kv_lens,
                           dtype="bfloat16", cache="int8"))


def time_paged_quantized(torch, pa_mod, pw_mod, cfg):
    """The int8 pool's decode launches at 7B, as `time_paged`: B = 8 rows
    at PAGED_LENS through tables of pages of 64 over a full-depth int8 pool.
    Quantized paged read: kernel, plain, and SDPA over K/V gathered and
    dequantized in advance. Quantizing page write of the step's own
    position (T = 1): kernel, plain (host-dispatched: it synchronises), and
    the four `index_put_`s of slivers quantized in advance."""
    import torch.nn.functional as F

    dev, dt = "cuda", torch.bfloat16
    ps, np_tab, n_layers = 64, 16, cfg.num_layers
    n, kh, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = len(PAGED_LENS)
    need = [-(-x // ps) for x in PAGED_LENS]
    pool_pages = sum(need) + 7
    g = torch.Generator(device=dev).manual_seed(4)
    shape = (n_layers, pool_pages, kh, ps, h)
    kp, kps = quantize(torch, torch.randn(shape, generator=g, device=dev, dtype=dt))
    vp, vps = quantize(torch, torch.randn(shape, generator=g, device=dev, dtype=dt))
    perm = torch.randperm(pool_pages, generator=g, device=dev).tolist()
    rows, i = [], 0
    for nd in need:
        rows.append(perm[i:i + nd] + [pool_pages] * (np_tab - nd))
        i += nd
    tab = torch.tensor(rows, dtype=torch.int32, device=dev)
    kvl = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    pos = (kvl - 1)[:, None]
    q = torch.randn((b, 1, n, h), generator=g, device=dev, dtype=dt)

    ms = time_ms(torch, lambda l: pa_mod.ragged_paged_attention_quantized_cuda(
        q, kp[l], kps[l], vp[l], vps[l], tab, pos, None, kvl), n_layers)
    plain = time_ms(torch, lambda l: pa_mod.ragged_paged_attention_quantized_plain(
        q, kp[l], kps[l], vp[l], vps[l], tab, pos, None, kvl), n_layers)
    grp = n // kh

    def rows_deq(pool, scales, l):
        return pa_mod.dequantize_kv(pa_mod.gather_pages(pool[l], tab),
                                    pa_mod.gather_page_scales(scales[l], tab),
                                    dt).repeat_interleave(grp, dim=1)

    kg = [rows_deq(kp, kps, l) for l in range(n_layers)]
    vg = [rows_deq(vp, vps, l) for l in range(n_layers)]
    mask = (torch.arange(np_tab * ps, device=dev)[None, :] < kvl[:, None])[:, None, None]
    qt = q.transpose(1, 2)
    lib = time_ms(torch, lambda l: F.scaled_dot_product_attention(
        qt, kg[l], vg[l], attn_mask=mask), n_layers)
    del kg, vg
    live = sum(PAGED_LENS)
    b_ms, b_by = bound(2 * 2 * q.numel() + live * kh * (2 * h + 8), 4 * h * live * n)
    paged = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 shape=dict(B=b, T=1, N=n, K=kh, H=h, page=ps, kv_lens=PAGED_LENS,
                            dtype="bfloat16", pool="int8"))

    kn = torch.randn((b, 1, kh, h), generator=g, device=dev, dtype=dt)
    vn = torch.randn_like(kn)
    pools = (kp, kps, vp, vps)

    def write_cuda(l, p):
        pw_mod.fused_page_write_quantized_cuda(*pools, kn, vn, p, tab, l)

    ms = time_ms(torch, lambda l: write_cuda(l, pos), n_layers)
    variants = time_write_variants(torch, pw_mod, write_cuda, pos, n_layers)
    plain = time_host(torch, lambda l: pw_mod.fused_page_write_quantized_plain(
        *pools, kn, vn, pos, tab, l), n_layers)
    pages, offs = pw_mod.page_coords(pos, tab, ps, pool_pages)
    pg, of = pages.reshape(-1), offs.reshape(-1)
    assert bool((pg < pool_pages).all())  # every sliver lands
    k8n, ksn = quantize(torch, kn[:, 0])
    v8n, vsn = quantize(torch, vn[:, 0])

    def index_put(l):
        kp[l][pg, :, of] = k8n
        kps[l][pg, :, of] = ksn
        vp[l][pg, :, of] = v8n
        vps[l][pg, :, of] = vsn

    lib = time_ms(torch, index_put, n_layers)
    b_ms, b_by = bound(2 * kn.numel() * kn.element_size() + 2 * b * kh * (h + 4), 0)
    write = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 **variants,
                 shape=dict(B=b, T=1, K=kh, H=h, page=ps, dtype="bfloat16", pool="int8"))
    return paged, write


MIXED_TIMED_LAYERS = 8  # layers cycled when timing the mixed round's step
# The mixed round's first steps timed: (label, model, T); the first is each
# window entry's headline.
MIXED_SHAPES = (("7b_mixed_t32", "7b", 32), ("7b_mixed_t16", "7b", 16),
                ("3b_mixed_t32", "3b", 32), ("3b_mixed_t16", "3b", 16))


def time_mixed(torch, pa_mod, pw_mod, cfg, quantized=False, t=32, writes=True,
               sweep_splits=None, rows=None):
    """The ragged mixed round's first step at `cfg` (7B or 3B), one call per
    layer over MIXED_TIMED_LAYERS layers of a pool (bf16, or int8 with
    scales): B = 8 slots through tables of max_seq / 64 pages of 64, T =
    `t` columns, the rows of `mixed_rows` (two carrying a whole chunk,
    four decode rows at q_len 1, two parked). Ragged paged attention (the
    query-window kernel): kernel, plain, and SDPA over K/V gathered (and
    dequantized) in advance under the same mask. With `writes`, the page
    write of the round's slivers (each chunk's t and each decode row's
    one): kernel, plain (host-dispatched: it synchronises), and
    `index_put_` of the kept slivers (quantized in advance) at precomputed
    coordinates. Bounds count this data: the live K/V and the kept
    slivers. With `sweep_splits`, only the kernel's time at each cluster
    size, forced through `window_split_plan`: {splits: ms}. `rows`
    replaces `mixed_rows` (the speculative verify round's, `spec_rows`)."""
    import torch.nn.functional as F

    dev, dt, layers = "cuda", torch.bfloat16, MIXED_TIMED_LAYERS
    ps, np_tab = 64, cfg.max_seq_len // 64
    n, kh, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rows = rows or mixed_rows(t, np_tab * ps)
    b = len(rows)
    need = [-(-kvl // ps) for _, _, kvl in rows]
    pool_pages = sum(need) + 7
    g = torch.Generator(device=dev).manual_seed(8)
    shape = (layers, pool_pages, kh, ps, h)
    kp = torch.randn(shape, generator=g, device=dev, dtype=dt)
    vp = torch.randn(shape, generator=g, device=dev, dtype=dt)
    if quantized:
        (kp, kps), (vp, vps) = quantize(torch, kp), quantize(torch, vp)
    perm = torch.randperm(pool_pages, generator=g, device=dev).tolist()
    tab_rows, i = [], 0
    for nd in need:
        tab_rows.append(perm[i:i + nd] + [pool_pages] * (np_tab - nd))
        i += nd
    tab = torch.tensor(tab_rows, dtype=torch.int32, device=dev)
    pos = torch.full((b, t), np_tab * ps, dtype=torch.int32, device=dev)
    for r, (start, ql, _) in enumerate(rows):
        pos[r, :ql] = start + torch.arange(ql, device=dev)
    kvl = torch.tensor([r[2] for r in rows], dtype=torch.int32, device=dev)
    qln = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    q = torch.randn((b, t, n, h), generator=g, device=dev, dtype=dt)
    if quantized:
        def attend(fn, l):
            return fn(q, kp[l], kps[l], vp[l], vps[l], tab, pos, None, kvl, qln)
        cuda_fn = pa_mod.ragged_paged_attention_quantized_cuda
        plain_fn = pa_mod.ragged_paged_attention_quantized_plain
    else:
        def attend(fn, l):
            return fn(q, kp[l], vp[l], tab, pos, None, kvl, qln)
        cuda_fn = pa_mod.ragged_paged_attention_cuda
        plain_fn = pa_mod.ragged_paged_attention_plain
    if sweep_splits is not None:
        plan, swept = pa_mod.window_split_plan, {}
        try:
            for sp in sweep_splits:
                pa_mod.window_split_plan = lambda *a, sp=sp: sp
                swept[sp] = time_ms(torch, lambda l: attend(cuda_fn, l), layers)
        finally:
            pa_mod.window_split_plan = plan
        return swept
    ms = time_ms(torch, lambda l: attend(cuda_fn, l), layers)
    plain = time_ms(torch, lambda l: attend(plain_fn, l), layers)

    def rows_kv(pool, scales, l):
        x = pa_mod.gather_pages(pool[l], tab)
        if quantized:
            x = pa_mod.dequantize_kv(x, pa_mod.gather_page_scales(scales[l], tab), dt)
        return x.repeat_interleave(n // kh, dim=1)

    kg = [rows_kv(kp, kps if quantized else None, l) for l in range(layers)]
    vg = [rows_kv(vp, vps if quantized else None, l) for l in range(layers)]
    idx = torch.arange(np_tab * ps, device=dev)
    live_col = torch.arange(t, device=dev)[None, :] < qln[:, None]
    mask = ((idx[None, None, :] <= pos[:, :, None].long())
            & (idx[None, None, :] < kvl[:, None, None])
            & live_col[:, :, None])[:, None]  # [B, 1, T, S]
    qt = q.transpose(1, 2)
    lib = time_ms(torch, lambda l: F.scaled_dot_product_attention(
        qt, kg[l], vg[l], attn_mask=mask), layers)
    del kg, vg
    live = int(kvl.sum())
    vis = int(mask.sum()) * n
    kv_bytes = live * kh * (2 * h + 8) if quantized else 2 * live * kh * h * 2
    q_bytes = int(live_col.sum()) * n * h * 2
    b_ms, b_by = bound(2 * q_bytes + kv_bytes, 4 * h * vis)
    label = "int8" if quantized else "bfloat16"
    attn = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                shape=dict(B=b, T=t, N=n, K=kh, H=h, page=ps, np=np_tab,
                           rows=[list(r) for r in rows], dtype="bfloat16", pool=label))
    if not writes:
        del kp, vp
        return attn, None

    kn = torch.randn((b, t, kh, h), generator=g, device=dev, dtype=dt)
    vn = torch.randn_like(kn)
    pools = (kp, kps, vp, vps) if quantized else (kp, vp)
    wfn = (pw_mod.fused_page_write_quantized_cuda if quantized
           else pw_mod.fused_page_write_cuda)
    wplain = (pw_mod.fused_page_write_quantized_plain if quantized
              else pw_mod.fused_page_write_plain)
    ms = time_ms(torch, lambda l: wfn(*pools, kn, vn, pos, tab, l, qln), layers)
    plain = time_host(torch, lambda l: wplain(*pools, kn, vn, pos, tab, l, qln), layers)
    pages, offs = pw_mod.page_coords(pos, tab, ps, pool_pages, qln)
    bi, ti = (pages < pool_pages).nonzero(as_tuple=True)
    pg, of = pages[bi, ti], offs[bi, ti]
    kept = int(pg.numel())
    if quantized:
        k8n, ksn = quantize(torch, kn[bi, ti])
        v8n, vsn = quantize(torch, vn[bi, ti])

        def index_put(l):
            kp[l][pg, :, of] = k8n
            kps[l][pg, :, of] = ksn
            vp[l][pg, :, of] = v8n
            vps[l][pg, :, of] = vsn

        nbytes = 2 * kept * kh * (2 * h + h + 4)
    else:
        ks_, vs_ = kn[bi, ti], vn[bi, ti]

        def index_put(l):
            kp[l][pg, :, of] = ks_
            vp[l][pg, :, of] = vs_

        nbytes = 2 * 2 * kept * kh * h * 2
    lib = time_ms(torch, index_put, layers)
    b_ms, b_by = bound(nbytes, 0)
    write = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 shape=dict(B=b, T=t, K=kh, H=h, page=ps, kept_slivers=kept,
                            dtype="bfloat16", pool=label))
    del kp, vp, pools
    return attn, write


INT4_TIME_ROWS = (1, 4, 8, 1024)


def time_int4(torch, mm_mod, cfg, rows_list=INT4_TIME_ROWS):
    """The int4 matmul at 7B for `wq` (4096 -> 4096) and `wd` (11008 -> 4096,
    group 86) at R in INT4_TIME_ROWS: the engine's decode of one request
    and of its batch of four, the scheduler's decode over 8 slots, a
    prefill chunk (8 x 128). One call per layer on the layer's own weight
    (random from a seed, quantized as `quantize_params_int4` does): kernel,
    plain (dequantize + f32 product), and the bf16 product against the
    weight dequantized to bf16 in advance (cuBLAS; 4x the weight bytes).
    Bound: x, the nibbles, the scales and out once each over 3.35 TB/s, or
    2 R IN OUT FLOPs over 989 TFLOP/s."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        dequantize_weight_int4,
        quantize_weight_int4,
        tp_safe_group,
    )

    dev, dt, n_layers = "cuda", torch.bfloat16, cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for name, n_in, n_out in (("wq", cfg.hidden_size, cfg.num_heads * cfg.head_dim),
                              ("wd", cfg.intermediate_size, cfg.hidden_size)):
        group = tp_safe_group(n_in)
        ws = [quantize_weight_int4(torch.randn((n_in, n_out), generator=g, device=dev)
                                   * n_in ** -0.5, group) for _ in range(n_layers)]
        wb = [dequantize_weight_int4(w, dt) for w in ws]
        for rows in rows_list:
            x = torch.randn((rows, n_in), generator=g, device=dev).to(dt)
            ms = time_ms(torch, lambda l: mm_mod.int4_matmul_cuda(x, ws[l]["q4"], ws[l]["s4"]),
                         n_layers)
            plain = time_ms(torch, lambda l: mm_mod.int4_matmul_plain(
                x, ws[l]["q4"], ws[l]["s4"]), n_layers, reps=3)
            lib = time_ms(torch, lambda l: torch.matmul(x, wb[l]), n_layers)
            # The host's side of a call: the seconds to enqueue one launch per
            # layer, five times over, without waiting for the card.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                for l in range(n_layers):
                    mm_mod.int4_matmul_cuda(x, ws[l]["q4"], ws[l]["s4"])
            host_us = (time.perf_counter() - t0) / (5 * n_layers) * 1e6
            torch.cuda.synchronize()
            nbytes = (x.numel() * 2 + ws[0]["q4"].numel() + ws[0]["s4"].numel() * 4
                      + rows * n_out * 2)
            b_ms, b_by = bound(nbytes, 2 * rows * n_in * n_out)
            out[f"{name}_R{rows}"] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                host_us_per_call=host_us,
                shape=dict(R=rows, IN=n_in, OUT=n_out, group=group, dtype="bfloat16",
                           bytes_mb=round(nbytes / 1e6, 2)))
        del ws, wb
    return out


def prompt_shapes(cfg):
    """The engine's first 7B NL->SQL request as `serve` sends it: prompt
    tokens, the padded prompt (the engine's bucket of 128) and the cache
    length after 64 more slots, rounded up to 8."""
    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import bucket_len
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    n = len(ByteTokenizer().encode(f"{SYSTEM_SQL}\n\n{QUESTIONS[0]}"))
    t = bucket_len(n, min(128, max(1, cfg.max_seq_len // 2)))
    return {"prompt_len": n, "padded": t, "cache_len": t + 64 + (-(t + 64) % 8)}


def batch_prompt_lens():
    """Prompt tokens of the engine's batch of four (`BATCH` under the SQL
    system prompt), 317-443 with ByteTokenizer."""
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    return [len(tok.encode(f"{SYSTEM_SQL}\n\n{qn}")) for qn in BATCH]


def contiguous_decode_rows(cfg):
    """The contiguous scheduler's decode at `cfg` (8 slots over its
    max_seq_len): six rows at the concurrent requests' prompts plus half
    the decode budget, and two parked rows (position max_seq - 1, kv_lens
    0). Returns (positions, kv_lens)."""
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    live = [len(tok.encode(f"{SYSTEM_SQL}\n\n{qn}")) + MAX_NEW // 2
            for qn in SCHED_SQL[2:]]
    park = cfg.max_seq_len - 1
    return [[p] for p in live] + [[park], [park]], [p + 1 for p in live] + [0, 0]


# Layers cycled when timing the contiguous decode: 8 layers of K and V at
# 8 x 4096 slots (2 GiB of bf16) keep the reads in device memory.
CONTIG_TIMED_LAYERS = 8

# The scheduler's prefill chunk at 7B: 8 chunks of the 128-token bucket over
# row views of 1024 slots, starting where `cases()` starts them.
SCHED_CHUNK_STARTS = [0, 128, 256, 0, 208, 336, 464, 896]


def timing(torch, attn_mod, pa_mod, pw_mod, mm_mod, cfg):
    """Phase 8 at 7B (`cfg`): every kernel's times, by kernel, and for the
    flash prefill and the int4 matmul by shape (`by_shape`)."""
    shp = prompt_shapes(cfg)
    t, s, n_prompt = shp["padded"], shp["cache_len"], shp["prompt_len"]
    n, kh, h, n_layers = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    chunk = 128
    prefill = {
        "7b_prompt": time_launch(torch, attn_mod, n, kh, h, n_layers, 1, t, s,
                                 [list(range(t))]),
        "7b_sched_chunk": time_launch(torch, attn_mod, n, kh, h, n_layers,
                                      len(SCHED_CHUNK_STARTS), chunk, 1024,
                                      [list(range(st, st + chunk))
                                       for st in SCHED_CHUNK_STARTS]),
    }
    # The engine decode: one request (cache of `s`) and the batch of four
    # (a cache of 512, each row at its prompt's length), over the bf16 and
    # the int8 cache.
    batch = batch_prompt_lens()
    decode = {
        "7b_one": time_launch(torch, attn_mod, n, kh, h, n_layers, 1, 1, s,
                              [[n_prompt + MAX_NEW // 2]]),
        "7b_batch4": time_launch(torch, attn_mod, n, kh, h, n_layers, len(batch), 1, 512,
                                 [[p] for p in batch]),
    }
    # The contiguous scheduler's decode: 8 slots over 4096, two parked.
    cpos, ckvl = contiguous_decode_rows(cfg)
    decode["7b_contig_b8"] = time_launch(torch, attn_mod, n, kh, h, CONTIG_TIMED_LAYERS,
                                         len(cpos), 1, cfg.max_seq_len, cpos, ckvl)
    timed = {
        "prefill": dict(prefill["7b_prompt"], by_shape=prefill),
        "decode": dict(decode["7b_one"], by_shape=decode),
    }
    decode_q = {
        "7b_one": time_decode_quantized(torch, attn_mod, n, kh, h, n_layers, s,
                                        [n_prompt + MAX_NEW // 2]),
        "7b_batch4": time_decode_quantized(torch, attn_mod, n, kh, h, n_layers, 512, batch),
        "7b_contig_b8": time_decode_quantized(torch, attn_mod, n, kh, h,
                                              CONTIG_TIMED_LAYERS, cfg.max_seq_len,
                                              [p for p, in cpos], ckvl),
    }
    timed["decode_q"] = dict(decode_q["7b_one"], by_shape=decode_q)
    timed["paged"], timed["write"] = time_paged(torch, pa_mod, pw_mod, cfg)
    timed["paged_q"], timed["write_q"] = time_paged_quantized(torch, pa_mod, pw_mod, cfg)
    # Rows 4-5's query windows (T > 1) and rows 6-7 at the ragged mixed
    # round's first step (default max_seq): 7B and 3B, T = 32 and 16.
    from llm_based_apache_spark_optimization_tpu_torch.models import LLAMA32_3B

    for key, w, quantized in (("paged", timed["write"], False),
                              ("paged_q", timed["write_q"], True)):
        shapes = {}
        for label, mcfg, t_ in MIXED_SHAPES:
            shapes[label], mw = time_mixed(torch, pa_mod, pw_mod,
                                           LLAMA32_3B if mcfg == "3b" else cfg,
                                           quantized, t_, writes=label == "7b_mixed_t32")
            if mw is not None:
                w["by_shape"] = {"7b_b8_t1": dict(w), label: mw}
        timed[key + "_window"] = dict(shapes["7b_mixed_t32"], by_shape=shapes)
    int4_times = time_int4(torch, mm_mod, cfg)
    timed["int4"] = dict(int4_times["wd_R8"], by_shape=int4_times)
    for launch, tm in timed.items():
        for label, t_ in (tm.get("by_shape") or {launch: tm}).items():
            host = (f", host {t_['host_us_per_call']:.1f} us a call"
                    if "host_us_per_call" in t_ else "")
            host += "".join(f", {k[:-3]} {t_[k]:.4f} ms" for k in WRITE_VARIANTS
                            if k in t_)
            print(f"  {label}: kernel {t_['ms']:.4f} ms, plain {t_['plain_ms']:.4f} ms, "
                  f"library {t_['library_ms']:.4f} ms, bound {t_['bound_ms']:.5f} ms "
                  f"({t_['bound_by']}){host} at {t_['shape']}", flush=True)
    return timed


SWEEP_SPLITS = (1, 2, 3, 4, 6, 8)


def sweep(torch, attn_mod, pa_mod, pw_mod, cfg):
    """`--sweep`: the kernel time of each decode launch at `timing`'s 7B
    shapes (the engine's B = 1 and batch of four, the scheduler's 8 slots;
    bf16 and int8 caches) and at the 3B scheduler's 8 slots (K = 8) with
    the cluster size forced to each of SWEEP_SPLITS, beside the size
    `decode_split_plan` picks there; then each paged query window at the
    mixed round's shapes (MIXED_SHAPES, bf16 and int8 pools) beside the
    size `window_split_plan` picks. Returns {shape: {"plan": splits, "ms":
    {splits: ms}}}."""
    from llm_based_apache_spark_optimization_tpu_torch.models import LLAMA32_3B
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.launches import sm_count

    shp = prompt_shapes(cfg)
    n, kh, h, n_layers = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    one, batch = [shp["prompt_len"] + MAX_NEW // 2], batch_prompt_lens()
    shapes = {  # name: (batch, kv heads, virtual length, time the launch)
        "decode 7b_one": (1, kh, shp["cache_len"], lambda: time_launch(
            torch, attn_mod, n, kh, h, n_layers, 1, 1, shp["cache_len"], [one])),
        "decode 7b_batch4": (4, kh, 512, lambda: time_launch(
            torch, attn_mod, n, kh, h, n_layers, 4, 1, 512, [[p] for p in batch])),
        "paged 7b_b8": (8, kh, 1024, lambda: time_paged(torch, pa_mod, pw_mod, cfg)[0]),
        "paged 3b_b8": (8, LLAMA32_3B.num_kv_heads, 1024, lambda: time_paged(
            torch, pa_mod, pw_mod, LLAMA32_3B)[0]),
        "decode_q 7b_one": (1, kh, shp["cache_len"], lambda: time_decode_quantized(
            torch, attn_mod, n, kh, h, n_layers, shp["cache_len"], one)),
        "decode_q 7b_batch4": (4, kh, 512, lambda: time_decode_quantized(
            torch, attn_mod, n, kh, h, n_layers, 512, batch)),
        "paged_q 7b_b8": (8, kh, 1024, lambda: time_paged_quantized(
            torch, pa_mod, pw_mod, cfg)[0]),
        "paged_q 3b_b8": (8, LLAMA32_3B.num_kv_heads, 1024, lambda: time_paged_quantized(
            torch, pa_mod, pw_mod, LLAMA32_3B)[0]),
    }
    plan = attn_mod.decode_split_plan
    sms = sm_count(torch.device("cuda"))
    out = {}

    def report(name, row):
        out[name] = row
        print(f"  sweep {name:24s} plan {row['plan']}: " + ", ".join(
            f"{sp} splits {ms:.4f} ms" for sp, ms in row["ms"].items()), flush=True)

    try:
        for name, (b, kv, s_virt, fn) in shapes.items():
            row = {"plan": plan(b, kv, s_virt, 1, sms), "ms": {}}
            for sp in SWEEP_SPLITS:
                def forced(b_, kh_, s_, t, sms, sp=sp):
                    return sp if t == 1 else 0
                attn_mod.decode_split_plan = pa_mod.decode_split_plan = forced
                row["ms"][sp] = fn()["ms"]
            report(name, row)
    finally:
        attn_mod.decode_split_plan = pa_mod.decode_split_plan = plan
    # The query windows (T > 1) at the mixed round's shapes, the cluster
    # size forced through `window_split_plan`.
    for label, model, t in MIXED_SHAPES:
        mcfg = LLAMA32_3B if model == "3b" else cfg
        for quantized in (False, True):
            rows = mcfg.num_heads // mcfg.num_kv_heads * t
            row = {"plan": pa_mod.window_split_plan(
                8, mcfg.num_kv_heads, mcfg.max_seq_len, rows, sms),
                "ms": time_mixed(torch, pa_mod, pw_mod, mcfg, quantized, t,
                                 sweep_splits=SWEEP_SPLITS)}
            report(f"{'paged_q' if quantized else 'paged'}_window {label}", row)
    return out


# ------------------------------------------------------------------ main


# ---------------------------------------------------------- speculation

SPEC_DRAFT = 8  # D of the speculative phases: verify windows of T = 9
# Window starts of the six live slots of a verify round (the contiguous
# scheduler's concurrent requests), beside two parked slots.
SPEC_LIVE = [317, 356, 389, 411, 443, 999]
# A speculative stream may leave the vanilla stream of its layout only at a
# near-tie. The verify window and the decode step reach their logits
# through other kernels and other matmul shapes; `logit_drift` measures, in
# this run on the 7B weights, how far apart the two (and a cache-free
# prefill, the third path `pair_gap` reads gaps on) put the same logits over
# the same prefixes, for each weight and KV cache type. The two tokens of a
# divergence are the top tokens of two paths, so ids among the top two of
# some path; over such ids the paths differ by at most `eps_top`, so the
# two tokens' gap on the third path is at most twice it: the bound. The drift over every id must stay within DRIFT_ULPS bf16 ulps of
# the row's largest |logit| (the worst an H100 showed is 5.18, PERF.md): a
# window that read a stale or shifted K/V slot moves the logits by far more.
DRIFT_ULPS = 6
_DRIFT: dict = {}  # drift class -> logit_drift's reading, for compare_streams


def spec_rows(s_virt, parked_q):
    """(start, q_len, kv_len) of a verify round's 8 slots: six live windows
    of D + 1 columns at SPEC_LIVE and two parked slots at the parking
    position (kv_lens 0; q_len `parked_q`: 0 on the paged layout, whose
    round drops their writes, D + 1 through the contiguous int8 view)."""
    d1 = SPEC_DRAFT + 1
    return ([(st, d1, st + d1) for st in SPEC_LIVE]
            + [(s_virt - 1, parked_q, 0)] * 2)


def spec_contiguous_positions(s):
    """(positions, kv_lens) of the contiguous scheduler's verify round over
    a cache of `s` slots: the live windows, and the parked slots' windows
    from s - 1 on, past the cache, with kv_lens 0."""
    rows = spec_rows(s, SPEC_DRAFT + 1)
    return ([[st + j for j in range(SPEC_DRAFT + 1)] for st, _, _ in rows],
            [kvl for _, _, kvl in rows])


def spec_kernel_cases():
    """Row 1's verify windows for `cases()`: the engine's batch of three
    over its cache (bucketed prompt 384 + budget 64 + one window: 457 slots,
    rounded to 464) and the contiguous schedulers' 8 slots (7B over 4096, 3B
    over 8192) with two parked rows, NaN past every live length."""
    out = [("prefill", "7b_engine_verify_b3", dict(
        b=3, t=SPEC_DRAFT + 1, n=32, kh=32, h=128, s=464,
        positions=[[st + j for j in range(SPEC_DRAFT + 1)] for st in (360, 371, 440)],
        nan_dead=True))]
    for model, n, kh, s in (("7b", 32, 32, 4096), ("3b", 24, 8, 8192)):
        pos, kvl = spec_contiguous_positions(s)
        out.append(("prefill", f"{model}_contig_verify_b8", dict(
            b=8, t=SPEC_DRAFT + 1, n=n, kh=kh, h=128, s=s, positions=pos, kv_lens=kvl,
            nan_dead=True)))
    return out


def spec_paged_cases():
    """Rows 4-5's verify windows for `paged_cases()`: the paged schedulers'
    rounds at their default max_seq (7B: tables of 64 pages, 3B: 128, pages
    of 64; parked slots at q_len 0), the engine's paged batch of three, and
    the contiguous int8 cache seen as a pool of one page of S = 4096 slots
    a row (parked rows with all columns live and kv_lens 0)."""
    d1 = SPEC_DRAFT + 1
    return [
        ("7b_verify_d8", dict(t=d1, n=32, kh=32, h=128, ps=64, np_tab=64,
                              rows=spec_rows(4096, 0), dead_pos=4095)),
        ("3b_verify_d8", dict(t=d1, n=24, kh=8, h=128, ps=64, np_tab=128,
                              rows=spec_rows(8192, 0), dead_pos=8191)),
        ("7b_engine_verify", dict(t=d1, n=32, kh=32, h=128, ps=64, np_tab=8,
                                  rows=[(360, d1, 360 + d1), (371, d1, 371 + d1),
                                        (440, d1, 440 + d1)])),
        ("7b_view_s4096", dict(t=d1, n=32, kh=32, h=128, ps=4096, np_tab=1,
                               rows=spec_rows(4096, d1), dead_pos=4095)),
    ]


def check_int8_view(torch, pa_mod):
    """Row 5 through the contiguous int8 cache's one-page-a-row view, as
    `models.llama.forward` calls it for a verify window: one layer of a
    7B int8 cache [B = 8, K, S = 4096, H] with its scales as the pool, the
    table arange(8)[:, None], q_lens left to default (every column live),
    two parked rows at the parking position with kv_lens 0, NaN in every
    dead slot's values and scales; kernel vs plain in bf16 (TOL and
    WINDOW_ROW_TOL), twice bit for bit. Returns the worst error."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import dispatch

    dev, d1 = "cuda", SPEC_DRAFT + 1
    pos, kvl = spec_contiguous_positions(4096)
    c = make_case(torch, torch.bfloat16, b=8, t=d1, n=32, kh=32, h=128, s=4096,
                  positions=pos, kv_lens=kvl, nan_dead=True)
    k8, ks = quantize(torch, c["k"])
    v8, vs = quantize(torch, c["v"])
    one_page = torch.arange(8, dtype=torch.int32, device=dev)[:, None]
    args = (c["q"], k8, ks, v8, vs, one_page, c["pos"], None, c["kv_lens"])
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import LAUNCHES

    before = LAUNCHES["ragged_paged_window_quantized"]
    out = dispatch.paged_attention_quantized(*args)
    assert LAUNCHES["ragged_paged_window_quantized"] == before + 1, \
        "the contiguous int8 view did not launch the window kernel"
    again = pa_mod.ragged_paged_attention_quantized_cuda(*args)
    ref = pa_mod.ragged_paged_attention_quantized_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    same = torch.equal(out, again)
    ok = err <= TOL["bfloat16"] and rel <= WINDOW_ROW_TOL and same \
        and bool(torch.isfinite(out).all()) and bool((out[6:] == 0).all())
    print(f"  int8 view 7b_contig_verify_b8 bfloat16 max_abs_err={err:.3e} "
          f"tol={TOL['bfloat16']:.0e} max_row_rel_err={rel:.3e} tol={WINDOW_ROW_TOL:.0e} "
          f"bit-identical-twice={same} {'ok' if ok else 'FAIL'}", flush=True)
    assert ok, f"int8 view: {err} or {rel} over its limit, not repeatable or not zeros"
    return err, rel


def time_int8_view(torch, pa_mod, cfg):
    """Row 5 through the contiguous int8 view at the contiguous scheduler's
    verify round (7B, B = 8, S = 4096, `spec_contiguous_positions`), one
    call a layer over CONTIG_TIMED_LAYERS layers: kernel, plain, and SDPA
    over K/V dequantized in advance. Bound: q and out, the live int8 K/V
    with their scales."""
    import torch.nn.functional as F

    dev, dt, layers, s = "cuda", torch.bfloat16, CONTIG_TIMED_LAYERS, cfg.max_seq_len
    n, kh, h, d1 = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, SPEC_DRAFT + 1
    g = torch.Generator(device=dev).manual_seed(9)
    pos_l, kvl_l = spec_contiguous_positions(s)
    b = len(pos_l)
    shape = (layers, b, kh, s, h)
    kc8, kcs = quantize(torch, torch.randn(shape, generator=g, device=dev, dtype=dt))
    vc8, vcs = quantize(torch, torch.randn(shape, generator=g, device=dev, dtype=dt))
    q = torch.randn((b, d1, n, h), generator=g, device=dev, dtype=dt)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    kvl = torch.tensor(kvl_l, dtype=torch.int32, device=dev)
    one_page = torch.arange(b, dtype=torch.int32, device=dev)[:, None]

    def attend(fn, l):
        return fn(q, kc8[l], kcs[l], vc8[l], vcs[l], one_page, pos, None, kvl)

    ms = time_ms(torch, lambda l: attend(pa_mod.ragged_paged_attention_quantized_cuda, l),
                 layers)
    plain = time_ms(torch, lambda l: attend(pa_mod.ragged_paged_attention_quantized_plain,
                                            l), layers)
    grp = n // kh
    kd = [pa_mod.dequantize_kv(kc8[l], kcs[l], dt).repeat_interleave(grp, dim=1)
          for l in range(layers)]
    vd = [pa_mod.dequantize_kv(vc8[l], vcs[l], dt).repeat_interleave(grp, dim=1)
          for l in range(layers)]
    idx = torch.arange(s, device=dev)
    mask = ((idx[None, None, :] <= pos[:, :, None].long())
            & (idx[None, None, :] < kvl[:, None, None]))[:, None]
    qt = q.transpose(1, 2)
    lib = time_ms(torch, lambda l: F.scaled_dot_product_attention(
        qt, kd[l], vd[l], attn_mask=mask), layers)
    del kd, vd
    live = int(kvl.sum())
    b_ms, b_by = bound(2 * q.numel() * 2 + live * kh * (2 * h + 8),
                       4 * h * int(mask.sum()) * n)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                shape=dict(B=b, T=d1, N=n, K=kh, H=h, page=s, np=1, kv_lens=kvl_l,
                           dtype="bfloat16", pool="int8 contiguous cache as one page a row"))


def time_verify(torch, attn_mod, pa_mod, pw_mod, mm_mod, cfg):
    """Each kernel at the speculative verify round's shapes (7B, D = 8, T =
    9): row 1 over the contiguous scheduler's 8 slots (S = 4096, two
    parked), rows 4-7 at the paged scheduler's round (tables of 64 pages of
    64, two parked slots at q_len 0), row 5 also through the contiguous int8
    view, row 8 at R = slots x (D + 1) = 72 for `wq` and `wd` (the
    dispatcher's route printed). Times, bounds and library calls as in
    `timing`. Returns {launch: {label: times}}."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.int4mm import int4_route

    n, kh, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d1 = SPEC_DRAFT + 1
    pos, kvl = spec_contiguous_positions(cfg.max_seq_len)
    out = {"prefill": {"7b_contig_verify_b8": time_launch(
        torch, attn_mod, n, kh, h, CONTIG_TIMED_LAYERS, len(pos), d1, cfg.max_seq_len,
        pos, kvl)}}
    rows = spec_rows(cfg.max_seq_len, 0)
    for key, wkey, quantized in (("paged_window", "write", False),
                                 ("paged_q_window", "write_q", True)):
        attn, write = time_mixed(torch, pa_mod, pw_mod, cfg, quantized, d1, rows=rows)
        out[key] = {"7b_verify_b8": attn}
        out[wkey] = {"7b_verify_b8": write}
    out["paged_q_window"]["7b_int8_view_b8"] = time_int8_view(torch, pa_mod, cfg)
    r = 8 * d1
    print(f"  int4 matmul at R = {r}: route {int4_route(r, torch.bfloat16)!r}", flush=True)
    out["int4"] = time_int4(torch, mm_mod, cfg, rows_list=(r,))
    for launch, shapes in out.items():
        for label, t_ in shapes.items():
            print(f"  verify {launch} {label}: kernel {t_['ms']:.4f} ms, plain "
                  f"{t_['plain_ms']:.4f} ms, library {t_['library_ms']:.4f} ms, bound "
                  f"{t_['bound_ms']:.5f} ms ({t_['bound_by']}) at {t_['shape']}", flush=True)
    return out


def verify_cost_readings(torch, cfg, params, readings, reps):
    """`readings` ratios of the median wall (host clock around the forward
    and a synchronise) of one T = D + 1 verify forward over that of one T =
    1 decode forward at B = 8 over a contiguous cache of 1024 slots (rows at
    positions 400-659), each from `reps` of each in turns after a warm-up.
    Returns (ratios, the T = 1 and T = D + 1 medians in ms of the last)."""
    import statistics

    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import init_cache
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward

    dev, b = "cuda", 8
    cache = init_cache(cfg, b, 1024, torch.bfloat16, dev)
    pos = torch.tensor([400 + 37 * i for i in range(b)], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)

    def run(t):
        tokens = torch.randint(3, cfg.vocab_size, (b, t), generator=g, device=dev,
                               dtype=torch.int32)
        positions = pos[:, None] + torch.arange(t, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(cfg, params, tokens, positions, cache, kv_lens=pos + t)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ratios = []
    with torch.inference_mode():
        for _ in range(5):
            for t in (1, SPEC_DRAFT + 1):
                run(t)
        for _ in range(readings):
            walls = {1: [], SPEC_DRAFT + 1: []}
            for _ in range(reps):
                for t in walls:
                    walls[t].append(run(t))
            med = {t: statistics.median(w) * 1e3 for t, w in walls.items()}
            ratios.append(med[SPEC_DRAFT + 1] / med[1])
    del cache
    torch.cuda.empty_cache()
    return ratios, med[1], med[SPEC_DRAFT + 1]


def verify_cost_anchor(torch, smi, readings=5, reps=30):
    """The verify cost model's D = 8 anchor on this card: at BENCH_1B, B = 8,
    bf16 (random seed-0 weights), the median of `readings` readings of
    `verify_cost_readings`. Prints each reading and the value
    `engine/speculative.py` carries. Returns (the median, the readings)."""
    import statistics

    from llm_based_apache_spark_optimization_tpu_torch.engine import speculative
    from llm_based_apache_spark_optimization_tpu_torch.models import BENCH_1B
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params

    params = init_params(BENCH_1B, torch.Generator(device="cuda").manual_seed(0),
                         torch.bfloat16, device="cuda")
    ratios, t1, t9 = verify_cost_readings(torch, BENCH_1B, params, readings, reps)
    ratio = statistics.median(ratios)
    print(f"  verify cost anchor (bench-1b, B = 8, bf16): readings "
          f"{[round(r, 4) for r in ratios]} (each the ratio of medians of {reps} forwards; "
          f"the last T = 1 {t1:.3f} ms, T = {SPEC_DRAFT + 1} {t9:.3f} ms); median "
          f"{ratio:.4f} on {smi}; engine/speculative.py carries "
          f"{speculative.VERIFY_COST_ANCHORS[1][1]}", flush=True)
    del params
    torch.cuda.empty_cache()
    return ratio, [round(r, 4) for r in ratios]


def verify_cost_7b(torch, eng, params4, smi):
    """The verify cost model away from its anchor: at DUCKDB_NSQL_7B, B = 8,
    bf16 and int4 weights, the median of three `verify_cost_readings`
    beside what `verify_cost_ratio` scales the anchor to. Printed, not held
    (the scaling is an estimate; `speculation_stats` says so). Returns
    {weights: {measured, modelled}}."""
    import statistics

    from llm_based_apache_spark_optimization_tpu_torch.engine.speculative import (
        verify_cost_ratio,
    )

    out = {}
    for name, params, bits in (("bf16", eng.params, 16), ("int4", params4, 4)):
        ratios, t1, t9 = verify_cost_readings(torch, eng.cfg, params, 3, 20)
        out[name] = dict(measured=round(statistics.median(ratios), 4),
                         modelled=round(verify_cost_ratio(SPEC_DRAFT, eng.cfg, bits), 4))
        print(f"  verify cost at 7B, {name} weights: readings "
              f"{[round(r, 4) for r in ratios]} (the last T = 1 {t1:.3f} ms, T = "
              f"{SPEC_DRAFT + 1} {t9:.3f} ms), median {out[name]['measured']}; "
              f"verify_cost_ratio models {out[name]['modelled']} on {smi}", flush=True)
    return out


def drift_class(label):
    """The weight and KV cache types of a path's label (phase 14's int8
    weights: labels that start with "q8", the 3B's with "q8_3b")."""
    if label.startswith("q8"):
        return "q8_3b" if label.startswith("q8_3b") else (
            "q8_int8" if "int8kv" in label else "q8")
    return "int4_int8" if "int4" in label else "int8" if "int8" in label else "bf16"


def logit_drift(torch, cfg, params, kv_quant, n_new=63):
    """How far the verify window's logits sit from the decode step's over
    the same prefix: the eight SQL prompts (SCHED_SQL) cut to one length as
    B = 8 rows over a contiguous cache (bf16, or quantized after the
    prefill as the engine does), `n_new` greedy tokens decoded at T = 1,
    then the same tokens fed again as verify windows of T = D + 1 after the
    same prefill, and once more as one cache-free prefill of prompt +
    tokens. Returns the largest |difference| between any two of the three
    paths' logits, over every position and id (`eps`), the same in bf16
    ulps of the row's largest |logit| (`ulps`), and over the ids among the
    top two of any path at each position (`eps_top`)."""
    import math

    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import init_cache
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_cache
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rows = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in SCHED_SQL]
    n, b, d1, dev = min(len(r) for r in rows), len(rows), SPEC_DRAFT + 1, "cuda"
    n_new = n_new // d1 * d1
    prompt = torch.tensor([r[:n] for r in rows], dtype=torch.int32, device=dev)
    pos = torch.arange(n + n_new, dtype=torch.int32, device=dev)[None].expand(b, -1)

    def prefilled():
        cache = init_cache(cfg, b, n + n_new + d1, torch.bfloat16, dev)
        logits, cache = forward(cfg, params, prompt, pos[:, :n], cache,
                                logit_indices=torch.full((b,), n - 1, device=dev))
        if kv_quant:
            cache = quantize_cache(cache["k"], cache["v"])
        return logits[:, 0], cache

    with torch.inference_mode():
        first, cache = prefilled()
        gen, dec = [torch.argmax(first, dim=-1).to(torch.int32)], []
        for i in range(n_new):
            logits, cache = forward(cfg, params, gen[-1][:, None], pos[:, n + i:n + i + 1],
                                    cache)
            dec.append(logits[:, 0])
            gen.append(torch.argmax(logits[:, 0], dim=-1).to(torch.int32))
        dec, gen = torch.stack(dec, 1), torch.stack(gen[:-1], 1)
        _, cache = prefilled()
        win = []
        for k in range(0, n_new, d1):
            logits, cache = forward(cfg, params, gen[:, k:k + d1], pos[:, n + k:n + k + d1],
                                    cache)
            win.append(logits)
        win = torch.cat(win, 1)
        full = forward(cfg, params, torch.cat([prompt, gen], 1), pos, None)[0][:, n:]
        del cache
        assert bool(torch.isfinite(dec).all() & torch.isfinite(win).all()
                    & torch.isfinite(full).all())
        diff = torch.stack([(win - dec).abs().amax(-1), (full - dec).abs().amax(-1),
                            (full - win).abs().amax(-1)])          # [3, B, n_new]
        ids = torch.cat([x.topk(2, dim=-1).indices for x in (dec, win, full)], -1)
        dec_t, win_t, full_t = (torch.gather(x, -1, ids) for x in (dec, win, full))
        eps_top = max(float((x - y).abs().max())
                      for x, y in ((win_t, dec_t), (full_t, dec_t), (full_t, win_t)))
        top = dec.abs().amax(-1)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    worst = diff.amax(0)
    out = dict(eps=float(worst.max()), ulps=float((worst / ulp).max()), eps_top=eps_top,
               window_vs_decode=float(diff[0].max()), prefill_vs_decode=float(diff[1].max()),
               prefill_vs_window=float(diff[2].max()), rows=b, prompt_len=n,
               positions=n_new, max_abs_logit=float(top.max()))
    assert math.isfinite(out["eps"])
    torch.cuda.empty_cache()
    return out


def logit_drifts(torch, eng, params4, smi):
    """`logit_drift` for each drift class of phase 13's paths, recorded for
    `compare_streams`: bf16 weights over a bf16 and an int8 cache, int4
    weights over an int8 cache. Fatal past DRIFT_ULPS."""
    for cls, params, kv_quant in (("bf16", eng.params, None), ("int8", eng.params, "int8"),
                                  ("int4_int8", params4, "int8")):
        d = logit_drift(torch, eng.cfg, params, kv_quant)
        _DRIFT[cls] = d
        print(f"  logit drift, {cls}: {json.dumps(d)}; near-tie bound 2 x eps_top = "
              f"{2 * d['eps_top']:.5f} on {smi}", flush=True)
        assert d["ulps"] <= DRIFT_ULPS, \
            f"{cls}: the paths' logits drift {d['ulps']:.2f} ulps > {DRIFT_ULPS}"
    return dict(_DRIFT)


def pair_gap(torch, cfg, params, prompt, prefix, a, b):
    """|logit[a] - logit[b]| at the position after `prompt + prefix`,
    recomputed by a cache-free forward of `params` (a third path)."""
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward

    ids = list(prompt) + list(prefix)
    toks = torch.tensor([ids], dtype=torch.int32, device="cuda")
    pos = torch.arange(len(ids), dtype=torch.int32, device="cuda")[None]
    with torch.inference_mode():
        logits = forward(cfg, params, toks, pos, None,
                         logit_indices=torch.tensor([len(ids) - 1], device="cuda"))[0][0, 0]
    return abs(float(logits[a]) - float(logits[b]))


def compare_streams(torch, eng, label, prompts, got, want, tally_div, params=None):
    """Hold speculative streams `got` to vanilla streams `want` of the same
    layout: equal, or, at the first diverging token, the two tokens' logits
    (`pair_gap` over the path's weights `params`, the engine's by default)
    within twice the top ids' drift `logit_drift` measured for the path's
    weight and cache types. Prints and records every divergence; fatal past
    the bound."""
    limit = 2 * _DRIFT[drift_class(label)]["eps_top"]
    same = 0
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            assert len(a) == len(b) or any(t in eng.stop_ids for t in (a + b)), \
                f"{label}[{i}]: lengths {len(a)} != {len(b)} without a stop"
            same += len(a) == len(b)
            continue
        gap = pair_gap(torch, eng.cfg, params if params is not None else eng.params, p,
                       b[:j], b[j], a[j])
        tally_div.append(dict(path=label, stream=i, position=j, gap=round(gap, 5),
                              bound=round(limit, 5)))
        print(f"    {label}[{i}]: first divergence at token {j} (vanilla {b[j]}, "
              f"speculative {a[j]}): logit gap {gap:.5f}, bound {limit:.5f}", flush=True)
        assert gap <= limit, f"{label}[{i}]: divergence at {j} with gap {gap} > {limit}"
    return same


def spec_report(label, stats, outs, rounds=None):
    """Print a speculative path's acceptance: a scheduler's
    `speculation_stats` (tokens a slot's verify round), whose delivered
    tokens must equal what its requests received (every token after the
    first, which comes from the prefill); or an engine's batch `rounds`
    (tokens a row's round: what the rows received over rounds x rows)."""
    received = sum(max(len(o) - 1, 0) for o in outs)
    if stats is not None:
        print(f"  {label}: speculation_stats {json.dumps(stats)}", flush=True)
        assert stats["tokens_delivered"] == received, \
            f"{label}: delivered {stats['tokens_delivered']} != received {received}"
        assert stats["tokens_emitted"] >= received and stats["verify_rounds"] >= 1
        return round(stats["tokens_emitted"] / stats["verify_rounds"], 3)
    tpr = round(received / max(1, rounds * len(outs)), 3)
    print(f"  {label}: {rounds} verify rounds of {len(outs)} rows for {received} tokens "
          f"after the first: {tpr} tokens a row's round", flush=True)
    return tpr


def expect_spec(expected, sched, rounds, prefills, extra_windows=0):
    """A speculative scheduler's launches: each verify round (a ragged
    mixed round included) is one forward of T > 1 a layer: contiguous bf16
    the flash prefill kernel, contiguous int8 the quantized window through
    the one-page view, paged the window and the page write (int8 pool: the
    quantized twins); a prefill forward the flash prefill a layer (paged:
    and the chunk's page write); a ragged prefill one window and one page
    write a layer; the weight matmuls of every forward (`matmul_launches`)."""
    n_layers = sched.cfg.num_layers
    q = "_quantized" if sched.kv_quant else ""
    windows = rounds + sched.ragged_prefills + extra_windows
    if sched._paged:
        expected["ragged_paged_window" + q] += n_layers * windows
        expected["fused_page_write" + q] += n_layers * (windows + prefills)
    elif q:
        expected["ragged_paged_window_quantized"] += n_layers * windows
    else:
        expected["flash_gqa_prefill"] += n_layers * windows
    expected["flash_gqa_prefill"] += n_layers * prefills
    add_matmuls(expected, sched.params, n_layers, windows + prefills)


def no_sync_rounds(torch, cls):
    """Context: every speculative round method of the scheduler class runs
    under torch's sync debug mode "error", so a host synchronisation inside
    a round raises (and fails the phase)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = {m: getattr(cls, m) for m in ("_spec_round", "_mixed_spec_round")}

        def guard(fn):
            def wrapped(self, *a, **kw):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(self, *a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            return wrapped

        for m, fn in saved.items():
            setattr(cls, m, guard(fn))
        try:
            yield
        finally:
            for m, fn in saved.items():
                setattr(cls, m, fn)
    return ctx()


SPEC_SAMPLED = dict(temperature=0.8, top_p=0.95)


def spec_engine(torch, eng, tally_div):
    """(a) The 7B engine, D = 8: the three NL->SQL prompts as one batch,
    greedy, in the contiguous bf16, paged bf16 and paged int8 layouts, each
    beside the vanilla engine of its layout (streams held by
    `compare_streams`); launch counts exact (contiguous: the flash prefill
    a layer per forward, the verify windows included; paged: window and
    page write a layer a round). Returns {layout: (launches, tokens a
    round)}."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in QUESTIONS]
    n_layers = eng.cfg.num_layers
    out = {}
    for layout, kv_quant in (("contiguous", None), ("paged", None), ("paged", "int8")):
        label = f"engine_{layout}" + (f"_{kv_quant}" if kv_quant else "")
        kw = dict(device="cuda", stop_ids=eng.stop_ids, kv_layout=layout, kv_quant=kv_quant)
        vanilla = InferenceEngine(eng.cfg, eng.params, **kw)
        spec = InferenceEngine(eng.cfg, eng.params, speculative_draft=SPEC_DRAFT, **kw)
        want = vanilla.generate(prompts, max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = spec.generate(prompts, max_new_tokens=MAX_NEW)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        rounds = spec.last_spec_rounds
        exp = dict.fromkeys(LAUNCHES, 0)
        exp["flash_gqa_prefill"] = n_layers
        q = "_quantized" if kv_quant else ""
        if layout == "paged":
            exp["ragged_paged_window" + q] = exp["fused_page_write" + q] = n_layers * rounds
        else:
            exp["flash_gqa_prefill"] += n_layers * rounds
        same = compare_streams(torch, eng, label, prompts, got, want, tally_div)
        tpr = spec_report(label, None, got, rounds)
        print(f"  {label}: {wall:.3f} s; {same} of {len(got)} streams equal to vanilla; "
              f"tokens {[len(o) for o in got]}; launches {launches} expected {exp}",
              flush=True)
        assert launches == exp, f"{label}: launch counts {launches} != {exp}"
        out[label] = (launches, tpr)
        del vanilla, spec
    return out


def spec_copying(torch, eng):
    """(b) The copying variant: the 7B seed-0 weights with every block's
    `wo` and `wd` zeroed and lm_head := embed, so the residual stream stays
    embed[token] and the logits are rms(embed[tok]) @ embed.T while the
    attention kernels still run on real K/V. Premise first: vanilla greedy
    repeats the prompt's last token. The prompts are the NL->SQL prompts
    with their last character repeated 12 times, so a draft window (n-gram
    3 + D = 11) finds a whole match from the first round, as JAX's
    test_acceptance_on_copying_model's prompt does. Then the speculative
    engine (contiguous and paged int8) and the speculative contiguous
    scheduler, D = 8, 256 new tokens: streams equal vanilla's outright, and
    each takes at least D tokens a round (D + 1 but for the round the
    budget cuts). Returns ({path: launches}, {path: tokens a round})."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    blocks = dict(eng.params["blocks"], wo=torch.zeros_like(eng.params["blocks"]["wo"]),
                  wd=torch.zeros_like(eng.params["blocks"]["wd"]))
    params = dict(eng.params, blocks=blocks, lm_head=eng.params["embed"])
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}{q[-1] * 12}") for q in QUESTIONS]
    new = 256
    vanilla = InferenceEngine(eng.cfg, params, device="cuda", stop_ids=(-1,))
    want = vanilla.generate(prompts, max_new_tokens=new)
    assert all(o == [p[-1]] * new for p, o in zip(prompts, want)), \
        f"premise: vanilla does not repeat the last token: {[o[:4] for o in want]}"
    launches, tprs = {}, {}
    for layout, kv_quant in (("contiguous", None), ("paged", "int8")):
        label = f"copying_engine_{layout}"
        spec = InferenceEngine(eng.cfg, params, device="cuda", stop_ids=(-1,),
                               kv_layout=layout, kv_quant=kv_quant,
                               speculative_draft=SPEC_DRAFT)
        torch.cuda.synchronize()
        reset_launches()
        got = spec.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        assert got == want, f"{label}: the copying variant's streams differ"
        tprs[label] = spec_report(label, None, got, spec.last_spec_rounds)
        assert tprs[label] >= SPEC_DRAFT, f"{label}: {tprs[label]} tokens a round"
    sched = ContinuousBatchingScheduler(eng.cfg, params, num_slots=8, stop_ids=(-1,),
                                        speculative_draft=SPEC_DRAFT, device="cuda")
    with sched:
        torch.cuda.synchronize()
        reset_launches()
        got = burst(sched, prompts, new)
        wait_settled(sched)
        torch.cuda.synchronize()
    launches["copying_scheduler"] = dict(LAUNCHES)
    assert got == want, "copying_scheduler: streams differ"
    st = sched.speculation_stats
    tprs["copying_scheduler"] = spec_report("copying_scheduler", st, got)
    assert st["tokens_per_round"] >= SPEC_DRAFT, st
    del params, blocks, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches, tprs


#: Phase 13 (c)'s scheduler variants: (layout, weights, KV cache). Only
#: those whose kernels and layouts no other phase launches at the verify
#: shapes: the contiguous and the paged bf16 schedulers (and their edge
#: request), and int4 weights over the contiguous int8 cache (row 8 at R =
#: 72, row 5 through the cache's one-page view). The paged int8 pool's
#: verify rounds run in phase 14 (d) and the contiguous int8 cache's in the
#: int4 variant; the paged int4 variant's kernels are the other two's.
SPEC_SCHED_VARIANTS = (("contiguous", "bf16", None), ("contiguous", "int4_int8", "int8"),
                       ("paged", "bf16", None))


def spec_schedulers(torch, engines, params4, tally_div):
    """(c) The SPEC_SCHED_VARIANTS: the contiguous scheduler (the app's
    default) and the paged one in bf16, and the contiguous one with int4
    weights over the int8 KV cache, D =
    8, 8 slots at the default max_seq: six requests at once (five greedy
    NL->SQL prompts, one sampled), then the sampled request again beside two
    other greedy ones (another batch mix): its tokens must repeat. The five
    greedy streams are held to the vanilla scheduler of the same
    configuration (`compare_streams`). In bf16 both layouts then serve one
    request at the window's edge: a prompt bucketed to the largest bucket
    that leaves MAX_NEW tokens and the speculative overshoot, (lag + 1)(D +
    1) + D, below max_seq, its verify windows writing up to the parking
    position; its stream too is held to vanilla's. Every verify round runs
    with host synchronisation forbidden (`no_sync_rounds`). Launch counts
    exact.
    Returns ({path: launches}, {path: tokens a round}, {label: scheduler
    kept for (d) and (g)})."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import SamplingParams
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng = engines["duckdb-nsql"]
    cfg = eng.cfg
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in SCHED_SQL[2:]]
    # The edge request: the largest 128-token bucket that leaves MAX_NEW and
    # the overshoot below max_seq, less a few tokens.
    room = cfg.max_seq_len - 1 - MAX_NEW - (2 * (SPEC_DRAFT + 1) + SPEC_DRAFT)
    edge = tok.encode(f"{SYSTEM_SQL}\n" * (cfg.max_seq_len // 64))[:room // 128 * 128 - 10]
    sp = SamplingParams(**SPEC_SAMPLED)
    launches, tprs = {}, {}
    for layout, wname, kv_quant in SPEC_SCHED_VARIANTS:
        label = f"spec_{layout}_scheduler_{wname}"
        params = params4 if wname == "int4_int8" else eng.params
        kw = dict(num_slots=8, stop_ids=eng.stop_ids, kv_layout=layout,
                  kv_quant=kv_quant, device="cuda")
        if layout == "paged":
            kw["kv_page_size"] = SCHED["kv_page_size"]
        with ContinuousBatchingScheduler(cfg, params, **kw) as vs:
            want = burst(vs, prompts[:5], MAX_NEW)
            if wname == "bf16":
                want.append(vs.submit(edge, max_new_tokens=MAX_NEW).result(timeout=600))
        del vs
        sched = ContinuousBatchingScheduler(cfg, params, speculative_draft=SPEC_DRAFT,
                                            **kw)
        t0 = time.perf_counter()
        with sched, no_sync_rounds(torch, ContinuousBatchingScheduler):
            torch.cuda.synchronize()
            reset_launches()
            switch = sys.getswitchinterval()
            sys.setswitchinterval(BURST_SWITCH_S)
            try:
                futs = [sched.submit(p, max_new_tokens=MAX_NEW) for p in prompts[:5]]
                futs.append(sched.submit(prompts[5], max_new_tokens=MAX_NEW,
                                         sampling=sp, seed=11))
            finally:
                sys.setswitchinterval(switch)
            outs = [f.result(timeout=600) for f in futs]
            futs = [sched.submit(prompts[5], max_new_tokens=MAX_NEW, sampling=sp,
                                 seed=11),
                    sched.submit(prompts[0], max_new_tokens=MAX_NEW // 2),
                    sched.submit(prompts[3], max_new_tokens=MAX_NEW)]
            again = [f.result(timeout=600) for f in futs]
            if wname == "bf16":
                outs.append(sched.submit(edge, max_new_tokens=MAX_NEW).result(timeout=600))
            wait_settled(sched)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[label] = dict(LAUNCHES)
        exp = dict.fromkeys(LAUNCHES, 0)
        expect_spec(exp, sched, sched.rounds_issued, sched.prefill_forwards)
        greedy = [0, 1, 2, 3, 4] + ([6] if wname == "bf16" else [])
        same = compare_streams(torch, eng, label, [(prompts[:5] + [None, edge])[i]
                                                   for i in greedy],
                               [outs[i] for i in greedy], want, tally_div,
                               params=params)
        st = sched.speculation_stats
        tprs[label] = spec_report(label, st, outs + again)
        print(f"  {label}: {wall:.3f} s, {sched.rounds_issued} rounds, "
              f"{sched.prefill_forwards} prefill forwards; {same} of {len(greedy)} greedy "
              f"streams equal to vanilla"
              f"{f' (the {len(edge)}-token edge prompt among them)' if 6 in greedy else ''}"
              f"; the sampled request repeats in another batch mix: "
              f"{again[0] == outs[5]}; launches {launches[label]} expected {exp}",
              flush=True)
        assert again[0] == outs[5], f"{label}: the sampled request did not repeat"
        assert launches[label] == exp, f"{label}: launch counts {launches[label]} != {exp}"
        if layout == "paged":
            sched._page_alloc.check()
        del sched
        gc.collect()
        torch.cuda.empty_cache()
    return launches, tprs


def spec_constrained(torch, eng, tally, tally_div):
    """(d) One constrained burst on the speculative contiguous scheduler
    (7B bf16, D = 8): six requests at once, three under the generic grammar
    and three free; every constrained completion passes phase 12's checks
    (`check_constrained`), the free ones join the unconstrained control.
    Launch counts exact. Returns (launches, tokens a round)."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    generic = grammar("generic", tok, eng.stop_ids)
    constraints = [generic, None, generic, None, generic, None]
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in SCHED_SQL[2:]]
    sched = ContinuousBatchingScheduler(eng.cfg, eng.params, num_slots=8,
                                        stop_ids=eng.stop_ids, device="cuda",
                                        speculative_draft=SPEC_DRAFT)
    with sched, no_sync_rounds(torch, ContinuousBatchingScheduler):
        torch.cuda.synchronize()
        reset_launches()
        outs = burst(sched, prompts, MAX_NEW, constraints)
        wait_settled(sched)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    exp = dict.fromkeys(LAUNCHES, 0)
    expect_spec(exp, sched, sched.rounds_issued, sched.prefill_forwards)
    for c, out in zip(constraints, outs):
        if c is None:
            tally.control_text("spec_scheduler", tok.decode(out))
            continue
        text = check_constrained(tally, "spec_scheduler", c, "spark_sql", out, MAX_NEW,
                                 eng.stop_ids, tok)
        print(f"    spec_scheduler generic: {text!r}", flush=True)
    st = sched.speculation_stats
    tpr = spec_report("spec_constrained_scheduler", st, outs)
    print(f"  constrained speculative burst: by_class {json.dumps(st['by_class'])}; "
          f"launches {launches} expected {exp}", flush=True)
    assert st["by_class"]["constrained"]["verify_rounds"] >= 1
    assert launches == exp, f"launch counts {launches} != {exp}"
    return launches, tpr


def spec_mixed(torch, eng, tally_div):
    """(e) Ragged mixed rounds under speculation, D = 4: the 7B paged
    scheduler with `ragged=True` (chunks of at most 32, so a round's window
    is max(32, 5) = 32 wide) over the bf16 pool, the six SQL requests at
    once with staggered budgets, so chunks ride verify rounds: mixed
    rounds > 0; every attention launch at T > 1 (windows = rounds + ragged
    prefills, a layer each); streams held to the vanilla ragged scheduler's.
    Returns (launches, tokens a round)."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in SCHED_SQL[2:]]
    budgets = [MAX_NEW // 4, MAX_NEW, MAX_NEW // 2, MAX_NEW, MAX_NEW // 4, MAX_NEW // 2]
    kw = dict(SCHED, stop_ids=eng.stop_ids, ragged=True, device="cuda")
    outs = {}
    for name, extra in (("vanilla", {}), ("spec", dict(speculative_draft=4))):
        sched = ContinuousBatchingScheduler(eng.cfg, eng.params, **kw, **extra)
        with sched, no_sync_rounds(torch, ContinuousBatchingScheduler):
            torch.cuda.synchronize()
            reset_launches()
            switch = sys.getswitchinterval()
            sys.setswitchinterval(BURST_SWITCH_S)
            try:
                futs = [sched.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
            finally:
                sys.setswitchinterval(switch)
            outs[name] = [f.result(timeout=600) for f in futs]
            wait_idle(sched)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        if name == "spec":
            exp = dict.fromkeys(LAUNCHES, 0)
            expect_spec(exp, sched, sched.rounds_issued, sched.prefill_forwards)
            st = sched.speculation_stats
            print(f"  ragged speculative: {sched.rounds_issued} rounds ({sched.mixed_rounds} "
                  f"mixed, {sched.ragged_prefills} ragged prefills), {sched.prefill_forwards} "
                  f"prefill forwards; launches {launches} expected {exp}", flush=True)
            assert sched.mixed_rounds > 0, "no chunk rode a verify round"
            assert launches == exp, f"launch counts {launches} != {exp}"
            sched._page_alloc.check()
    compare_streams(torch, eng, "spec_mixed_scheduler", prompts, outs["spec"], outs["vanilla"],
                    tally_div)
    return launches, spec_report("spec_mixed_scheduler", st, outs["spec"])


def spec_overcommit(torch, eng, tally, tally_div):
    """(f) The overcommit burst under speculation (D = 8): `overcommit_serve`'s
    six requests at OVERCOMMIT_NEW new tokens (the last three under the
    generic grammar; the first one sampled) over the 7B paged scheduler with
    kv_overcommit 0.5:
    a control pool that holds every budget, and a pool that holds the
    admissions only, in spill and in recompute mode (preemptions >= 1 in
    both). Spill streams equal the control's; recompute streams equal it or
    diverge at a near-tie (`compare_streams`: a re-prefill rebuilds K/V
    with other matmul shapes). The sampled request (`sampled_resumes`):
    equal to the control up to its first recompute resume, which must
    restore the stream index the control's rounds had reached there (one a
    harvested round, after the prefill's one) and the history row (prompt
    + committed tokens); equal outright if it was never preempted. Every
    constrained stream passes the grammar checks. Launch counts exact.
    Returns (launches, tokens a round of the control)."""
    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import bucket_len
    from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
        pages_for_tokens,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import SamplingParams
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = eng.cfg
    prompts = [tok.encode(f"Overcommit request {i}. {SYSTEM_SQL}\n\n{q}")
               for i, q in enumerate(SCHED_SQL[2:])]
    generic = grammar("generic", tok, eng.stop_ids)
    constraints = [None, None, None, generic, generic, generic]
    ps = SCHED["kv_page_size"]
    overshoot = 2 * (SPEC_DRAFT + 1) + SPEC_DRAFT
    new = OVERCOMMIT_NEW
    admit = sum(pages_for_tokens(bucket_len(len(p), 128) + new // 2 + overshoot, ps)
                for p in prompts)
    full = sum(pages_for_tokens(len(p) + new + overshoot, ps) for p in prompts)
    print(f"  six requests of {[len(p) for p in prompts]} prompt tokens x {new} new: "
          f"admissions take {admit} pages of {ps}, whole budgets {full}", flush=True)
    assert admit + 2 >= pages_for_tokens(cfg.max_seq_len, ps) and full > admit + 2
    kw = dict(SCHED, stop_ids=eng.stop_ids, kv_overcommit=0.5, device="cuda",
              speculative_draft=SPEC_DRAFT)
    runs = {"control": dict(kv_pages=full + 16),
            "spill": dict(kv_pages=admit + 2, kv_spill=True),
            "recompute": dict(kv_pages=admit + 2, kv_spill=False)}
    sp = SamplingParams(**SPEC_SAMPLED)
    torch.cuda.synchronize()
    reset_launches()
    want = dict.fromkeys(LAUNCHES, 0)
    toks, stats, watch = {}, {}, {}
    for name, extra in runs.items():
        t0 = time.perf_counter()
        with ContinuousBatchingScheduler(cfg, eng.params, **kw, **extra) as sched:
            watch[name] = sampled_resumes(torch, sched)
            switch = sys.getswitchinterval()
            sys.setswitchinterval(BURST_SWITCH_S)
            try:
                futs = [sched.submit(p, max_new_tokens=new, constraint=c,
                                     sampling=sp if i == 0 else SamplingParams(), seed=21)
                        for i, (p, c) in enumerate(zip(prompts, constraints))]
            finally:
                sys.setswitchinterval(switch)
            toks[name] = [f.result(timeout=600) for f in futs]
            st = wait_idle(sched)
        wait_settled(sched)
        sched._page_alloc.check()
        stats[name] = st
        expect_spec(want, sched, sched.rounds_issued, sched.prefill_forwards)
        spec_report(f"spec_overcommit_{name}", sched.speculation_stats, toks[name])
        print(f"  {name}: {time.perf_counter() - t0:.1f} s, {sched.rounds_issued} rounds; "
              f"preemptions {st['preemptions']}, spilled {st['spilled_pages']}, restored "
              f"{st['restored_pages']}; tokens {[len(t) for t in toks[name]]}", flush=True)
        for c, out in zip(constraints, toks[name]):
            if c is not None:
                check_constrained(tally, f"spec_overcommit_{name}", c, "spark_sql", out,
                                  new, eng.stop_ids, tok)
        if name == "control":
            tpr = round(sched.speculation_stats["tokens_per_round"], 3)
        del sched
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"  launches {launches} expected {want}", flush=True)
    assert stats["control"]["preemptions"] == 0
    for name in ("spill", "recompute"):
        assert stats[name]["preemptions"] >= 1, f"{name}: the pool never preempted"
    assert stats["spill"]["spilled_pages"] == stats["spill"]["restored_pages"] > 0
    assert toks["spill"] == toks["control"], "spill resumes changed the tokens"
    # The sampled stream (request 0): before its first resume it ran as in
    # the control; the resume must restore the control's stream index and
    # history. Past it a draw may flip where the perturbed scores tie.
    a, b = toks["recompute"][0], toks["control"][0]
    rounds, resumes = watch["control"]["rounds"], watch["recompute"]["resumes"]
    j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    print(f"  recompute: sampled stream equal to the control: {a == b} (first diverging "
          f"token {j}); its resumes (committed tokens, stream index, history row "
          f"intact): {resumes}; the control's committed tokens after each round "
          f"{rounds}", flush=True)
    if not resumes:
        assert a == b, "the sampled request was never preempted, yet changed"
    else:
        g0, count, _ = resumes[0]
        want_count = 1 + sum(r <= g0 for r in rounds)
        assert a[:g0] == b[:g0], f"sampled stream changed before its resume at {g0}"
        assert g0 == 1 or g0 in rounds, \
            f"resume at {g0} committed tokens, where no round of the control ended"
        assert count == want_count, \
            f"resume restored stream index {count}, the control's was {want_count}"
        assert all(ok for _, _, ok in resumes), "a resume left a wrong history row"
    compare_streams(torch, eng, "spec_overcommit_recompute", prompts[1:],
                    toks["recompute"][1:], toks["control"][1:], tally_div)
    assert launches == want, f"launch counts {launches} != {want}"
    gc.collect()
    torch.cuda.empty_cache()
    return launches, tpr


def sampled_resumes(torch, sched):
    """Watch the sampled requests of `sched` (temperature > 0): `rounds`, the
    committed tokens after each of their harvested verify rounds, and
    `resumes`, at each resume (committed tokens, the stream index and
    whether the history row holds prompt + committed tokens, pad beyond).
    Wraps the instance's `_count_spec` and `_resume_ready`."""
    seen = {"rounds": [], "resumes": []}
    count_spec, resume_ready = sched._count_spec, sched._resume_ready

    def counted(req, emitted, delivered):
        if req.temperature > 0.0:
            seen["rounds"].append(len(req.generated))
        return count_spec(req, emitted, delivered)

    def resumed(slot, req, **kw):
        resume_ready(slot, req, **kw)
        if req.temperature > 0.0:
            ids = req.full_ids
            row = sched._hist[slot].tolist()
            ok = (row[:len(ids)] == ids and int(sched._hlen[slot]) == len(ids)
                  and set(row[len(ids):]) <= {sched.cfg.pad_id})
            seen["resumes"].append((len(req.generated), int(sched._counts[slot]), ok))

    sched._count_spec, sched._resume_ready = counted, resumed
    return seen


def spec_app(torch, eng):
    """(g) `POST /process-data/` over a speculative 7B scheduler: the
    contiguous scheduler with D = 8 serves both roles (the SQL model and,
    as a checkpoint service without --error-model-path does, the error
    explanation) through `create_api_app`; two requests, each the failure
    shape (random weights), launch counts exact, speculation_stats
    printed. Then the entry point as a user starts it with
    `--speculative 8` (`entry_point`). Returns (launches, tokens a
    round)."""
    import tempfile

    from llm_based_apache_spark_optimization_tpu_torch.app import (
        AppConfig,
        create_api_app,
    )
    from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        GenerationService,
        SchedulerBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend

    tok = ByteModTokenizer()
    sched = ContinuousBatchingScheduler(eng.cfg, eng.params, num_slots=8,
                                        stop_ids=eng.stop_ids, device="cuda",
                                        speculative_draft=SPEC_DRAFT)
    svc = GenerationService()
    svc.register("duckdb-nsql", SchedulerBackend(sched, tok, max_new_tokens=MAX_NEW))
    svc.register("llama3.2", SchedulerBackend(sched, tok, max_new_tokens=MAX_NEW,
                                              add_bos=False), template="llama3-chat")
    try:
        with tempfile.TemporaryDirectory() as root:
            os.makedirs(os.path.join(root, "input"))
            with open(os.path.join(root, "input", "taxi.csv"), "w") as f:
                f.write(CSV)
            cfg = AppConfig(input_dir=os.path.join(root, "input"),
                            output_dir=os.path.join(root, "output"),
                            history_db=":memory:", max_new_tokens=MAX_NEW)
            client = create_api_app(svc, SQLiteBackend, SQLiteHistory(":memory:"),
                                    cfg).test_client()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            bodies = [client.post_json("/process-data/", {"input_text": qn,
                                                          "file_name": "taxi.csv"})
                      for qn in APP_QUESTIONS[:2]]
            wall = time.perf_counter() - t0
            wait_settled(sched)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        exp = dict.fromkeys(LAUNCHES, 0)
        expect_spec(exp, sched, sched.rounds_issued, sched.prefill_forwards)
        for res in bodies:
            body = res.json()
            assert res.status == 200 and set(body) == {"error", "sql_query",
                                                       "error_details"}, body
        st = sched.speculation_stats
        print(f"  app over the speculative scheduler: two POST /process-data/ in "
              f"{wall:.3f} s; speculation_stats {json.dumps(st)}; launches {launches} "
              f"expected {exp}", flush=True)
        assert launches == exp, f"launch counts {launches} != {exp}"
        assert st["verify_rounds"] >= 1
        tpr = st["tokens_per_round"]
    finally:
        sched.shutdown()
    entry_point(torch, backend_args=("--backend", "tiny", "--speculative", str(SPEC_DRAFT)))
    return launches, tpr


def speculative_paths(torch, engines, tally, smi):
    """Phase 13, speculative decoding at D = 8 on the 7B weights: (a) the
    engine in three layouts, (b) the copying variant, (c) both scheduler
    layouts in bf16, int8 KV and int4/int8, (d) a constrained burst, (e)
    ragged mixed rounds at D = 4, (f) the overcommit burst, (g) the app,
    after the logit drift of each weight and cache type and the verify cost
    at 7B. Every speculative stream equals the vanilla stream of its layout
    or leaves it at a reported near-tie within twice its class's top ids' drift.
    Returns ({path: launches}, {path: tokens a round}, divergences,
    {"logit_drift": ..., "verify_cost_7b": ...})."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_params_int4

    eng = engines["duckdb-nsql"]
    div, launches, tprs = [], {}, {}
    phase("speculative logit drift and verify cost at 7B")
    params4 = quantize_params_int4(eng.params)
    calib = {"logit_drift": logit_drifts(torch, eng, params4, smi),
             "verify_cost_7b": verify_cost_7b(torch, eng, params4, smi)}
    phase("speculative engine (a) and the copying variant (b)")
    for label, (la, tpr) in spec_engine(torch, eng, div).items():
        launches[label], tprs[label] = la, tpr
    la, tp = spec_copying(torch, eng)
    launches.update(la)
    tprs.update(tp)
    phase("speculative schedulers (c): contiguous and paged bf16, contiguous int4/int8")
    la, tp = spec_schedulers(torch, engines, params4, div)
    del params4
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(la)
    tprs.update(tp)
    phase("speculative constrained burst (d) and ragged mixed rounds (e)")
    launches["spec_constrained_scheduler"], tprs["spec_constrained_scheduler"] = \
        spec_constrained(torch, eng, tally, div)
    launches["spec_mixed_scheduler"], tprs["spec_mixed_scheduler"] = \
        spec_mixed(torch, eng, div)
    phase("speculative overcommit (f)")
    launches["spec_overcommit_scheduler"], tprs["spec_overcommit_scheduler"] = \
        spec_overcommit(torch, eng, tally, div)
    phase("speculative app (g)")
    launches["spec_app"], tprs["spec_app"] = spec_app(torch, eng)
    print(f"  tokens per verify round by path: {json.dumps(tprs)}", flush=True)
    print(f"  divergences from vanilla ({len(div)}): {json.dumps(div)}", flush=True)
    return launches, tprs, div, calib


SPEC_CASE_NAMES = {name for _, name, _ in spec_kernel_cases()} | {
    name for name, _ in spec_paged_cases()} | {"7b_verify_t9", "3b_verify_t9"}


def spec_kernels(torch, attn_mod, pa_mod, pw_mod, mm_mod):
    """Phase 3's checks at the verify shapes alone (`--speculative-only`):
    rows 1, 4, 5 at T = 9 with parked rows and NaN in dead slots, row 5
    through the contiguous int8 view, rows 6-7 writing 9-wide windows, row
    8 at R = 72."""
    check_kernels(torch, attn_mod, SPEC_CASE_NAMES)
    check_paged(torch, pa_mod, SPEC_CASE_NAMES)
    check_write(torch, pw_mod, SPEC_CASE_NAMES)
    check_paged_quantized(torch, pa_mod, SPEC_CASE_NAMES)
    check_write_quantized(torch, pw_mod, SPEC_CASE_NAMES)
    check_int4(torch, mm_mod, {8 * (SPEC_DRAFT + 1)})
    check_int8_view(torch, pa_mod)


# ------------------------------------------- int8 weights and fused trees


def q8_tree(torch, cfg, params):
    """`params` with int8 block weights and int8 embed/unembed tables,
    quantized on the card (`quantize_params`, then `quantize_unembed`)."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_params,
        quantize_unembed,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = quantize_unembed(quantize_params(params))
    torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for w in (*tree["blocks"].values(),
                                                        tree["embed"])
                 if isinstance(w, dict) for v in w.values())
    print(f"  {cfg.name}: block weights and the unembed table quantized to int8 on the "
          f"card in {time.perf_counter() - t0:.1f} s ({nbytes / 2**30:.2f} GiB of codes and "
          f"scales); {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    return tree


def q8_engine_run(torch, eng, prompts, label, constraint=None):
    """One batch through `eng` (under `constraint` when given) in a counted
    window: the greedy tokens and the launches, held to the expected ones
    (flash prefill and decode a layer a forward, the weight matmuls of
    every forward, `matmul_launches`)."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=MAX_NEW, constraint=constraint)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(LAUNCHES)
    st, n_layers = eng.last_stats, eng.cfg.num_layers
    want = dict.fromkeys(LAUNCHES, 0)
    want["flash_gqa_prefill"] = n_layers
    want["flash_gqa_decode"] = n_layers * st["decode_steps"]
    add_matmuls(want, eng.params, n_layers, st["forward_calls"])
    per = matmul_launches(eng.params, n_layers)["int8_matmul"]
    dec = max(wall - st["ttft_s"], 1e-9)
    print(f"  {label}: batch {st['batch']}, prompt {st['prompt_len']}, "
          f"{st['decode_steps']} decode steps in {wall:.3f} s (TTFT {st['ttft_s']:.4f} s, "
          f"{st['decode_steps'] / dec:.1f} steps/s); {per} int8_matmul a forward; "
          f"launches {got} expected {want}", flush=True)
    assert got == want, f"{label}: launch counts {got} != {want}"
    assert got["int8_matmul"] > 0
    return outs, got


def int8_engines(torch, engines, smi, tally, tally_div, profile=False):
    """Phase 14 (c): the 7B engine over int8 block weights and an int8
    unembed table (`quantize_params` + `quantize_unembed` of the seed-0
    bf16 tree), unfused and fused, and the 3B engine fused, the three
    NL->SQL prompts as one batch. Launch counts exact (7 x 32 + 1, 4 x 32 +
    1 and 5 x 28 + 1 `int8_matmul` a forward). The fused streams are held
    to the unfused ones, and the unfused 7B streams to the same weights
    through the plain versions (the reference function: int8 x bf16 summed
    in f32 by PyTorch), by the near-tie rule over `logit_drift` measured on
    these weights; agreement with the bf16 weights' streams is printed. The
    fused 7B engine also serves the batch under the generic grammar, held
    to phase 12's checks. With `profile`, the batch runs once more under
    torch.profiler on the bf16 7B engine, the unfused and the fused int8
    one. Returns ({path: launches}, the 7B int8 tree)."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import set_attention_impl
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng7, eng3 = engines["duckdb-nsql"], engines["llama3.2"]
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in QUESTIONS]
    launches = {}
    params8 = q8_tree(torch, eng7.cfg, eng7.params)
    for cls, kv in (("q8", None), ("q8_int8", "int8")):
        _DRIFT[cls] = logit_drift(torch, eng7.cfg, params8, kv)
        print(f"  logit drift, {cls}: {json.dumps(_DRIFT[cls])}; near-tie bound 2 x eps_top = "
              f"{2 * _DRIFT[cls]['eps_top']:.5f} on {smi}", flush=True)
        assert _DRIFT[cls]["ulps"] <= DRIFT_ULPS, f"{cls}: drift {_DRIFT[cls]['ulps']:.2f} ulps"
    e8 = InferenceEngine(eng7.cfg, params8, stop_ids=eng7.stop_ids, device="cuda")
    unfused, launches["q8_engine_7b"] = q8_engine_run(torch, e8, prompts, "q8 7B engine")
    set_attention_impl("plain")
    try:
        plain = e8.generate(prompts, max_new_tokens=MAX_NEW)
    finally:
        set_attention_impl("auto")
    compare_streams(torch, e8, "q8_engine_plain", prompts, unfused, plain, tally_div,
                    params=params8)
    ef = InferenceEngine(eng7.cfg, params8, stop_ids=eng7.stop_ids, device="cuda",
                         fuse_matmuls=True)
    assert "wqkv" in ef.params["blocks"] and "wgu" in ef.params["blocks"]
    fused, launches["q8_engine_7b_fused"] = q8_engine_run(torch, ef, prompts,
                                                          "q8 7B engine, fused")
    compare_streams(torch, e8, "q8_engine_fused", prompts, fused, unfused, tally_div,
                    params=params8)
    c = grammar("generic", tok, eng7.stop_ids)
    outs, launches["constrained_q8_engine_fused"] = q8_engine_run(
        torch, ef, prompts, "q8 7B engine, fused, generic grammar", constraint=c)
    for out in outs:
        text = check_constrained(tally, "q8_engine_fused", c, GRAMMAR_SPECS["generic"], out,
                                 MAX_NEW, eng7.stop_ids, tok)
        print(f"    q8 engine generic: {text!r}", flush=True)
    bf16 = eng7.generate(prompts, max_new_tokens=MAX_NEW)
    if profile:
        profile_int8_engines(torch, {"bf16": eng7, "int8, unfused": e8, "int8, fused": ef},
                             prompts)
    agree = sum(a == b for x, y in zip(unfused, bf16) for a, b in zip(x, y))
    print(f"  q8 7B vs bf16 weights: {agree} of {sum(map(len, bf16))} greedy tokens equal "
          f"(other weights: printed, not held)", flush=True)
    del ef, e8
    gc.collect()
    torch.cuda.empty_cache()

    params3 = q8_tree(torch, eng3.cfg, eng3.params)
    _DRIFT["q8_3b"] = logit_drift(torch, eng3.cfg, params3, None)
    print(f"  logit drift, q8_3b: {json.dumps(_DRIFT['q8_3b'])}", flush=True)
    assert _DRIFT["q8_3b"]["ulps"] <= DRIFT_ULPS
    e3 = InferenceEngine(eng3.cfg, params3, stop_ids=eng3.stop_ids, device="cuda")
    with torch.inference_mode():
        unfused3 = e3.generate(prompts, max_new_tokens=MAX_NEW)
    e3f = InferenceEngine(eng3.cfg, params3, stop_ids=eng3.stop_ids, device="cuda",
                          fuse_matmuls=True)
    assert "wkv" in e3f.params["blocks"] and "wq" in e3f.params["blocks"]
    fused3, launches["q8_engine_3b_fused"] = q8_engine_run(torch, e3f, prompts,
                                                           "q8 3B engine, fused")
    compare_streams(torch, e3, "q8_3b_engine_fused", prompts, fused3, unfused3, tally_div,
                    params=params3)
    del e3, e3f, params3
    gc.collect()
    torch.cuda.empty_cache()
    return launches, params8


def profile_int8_engines(torch, engines, prompts):
    """`--profile` of phase 14 (c): the batch once more under torch.profiler
    on each 7B engine of `engines` ({label: engine}), with the int8 and
    the bf16 matmuls' device ms a decode step (a group's ms over the
    batch's decode steps)."""
    for name, e in engines.items():
        groups = profile_device(torch, f"7B engine, {name}, batch of {len(prompts)}",
                                lambda e=e: sum(map(len, e.generate(prompts,
                                                                    max_new_tokens=MAX_NEW))))
        steps = e.last_stats["decode_steps"]
        print(f"    decode steps {steps}; a step: int8 matmul "
              f"{groups['int8 matmul'] / steps:.3f} ms, cuBLAS matmul "
              f"{groups['matmul'] / steps:.3f} ms", flush=True)


def int8_profile(torch):
    """`--int8-only --profile`: phase 14 (c)'s batch of three NL->SQL
    prompts on the 7B engine over the seed-0 bf16 weights, their int8 tree
    unfused and fused, each once to warm up and once under torch.profiler
    (`profile_int8_engines`)."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng7 = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),))["duckdb-nsql"]
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in QUESTIONS]
    params8 = q8_tree(torch, eng7.cfg, eng7.params)
    engines = {"bf16": eng7}
    for name, fuse in (("int8, unfused", False), ("int8, fused", True)):
        engines[name] = InferenceEngine(eng7.cfg, params8, stop_ids=eng7.stop_ids,
                                        device="cuda", fuse_matmuls=fuse)
    for e in engines.values():
        e.generate(prompts, max_new_tokens=MAX_NEW)
    profile_int8_engines(torch, engines, prompts)


def q8_plain_streams(torch, cfg, params8, stop_ids, prompts, kv_quant):
    """The greedy streams of `prompts` (MAX_NEW tokens) through an unfused
    engine over `params8` with every kernel's plain version: the paged
    engine over an int8 pool of SCHED's page size when `kv_quant`, else the
    contiguous engine over the bf16 cache."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import set_attention_impl

    kw = (dict(kv_layout="paged", kv_page_size=SCHED["kv_page_size"], kv_quant=kv_quant)
          if kv_quant else {})
    eng = InferenceEngine(cfg, params8, stop_ids=stop_ids, device="cuda", **kw)
    set_attention_impl("plain")
    try:
        return eng.generate(prompts, max_new_tokens=MAX_NEW)
    finally:
        set_attention_impl("auto")
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def int8_schedulers(torch, cfg, params8, stop_ids, tally_div):
    """Phase 14 (d): q8 weights and tables behind both schedulers, 8 slots:
    the paged one fused over the int8 pool with ragged mixed rounds, and the
    contiguous one (the app's default) unfused over the bf16 cache, each
    under phase 6's traffic as SchedulerBackends, then the six SQL prompts
    at once with staggered budgets (chunks ride decode rounds); then a
    speculative burst (D = 8) on the paged fused one over the int8 pool.
    Every greedy stream of the bursts is held by the near-tie rule to the
    same prompt's stream through an unfused engine over the same weights
    and cache type with every kernel's plain version (`q8_plain_streams`).
    Launch counts exact; the paged pools leak no page. Returns {path:
    launches}."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        GenerationService,
        SchedulerBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in SCHED_SQL[2:]]
    budgets = [MAX_NEW // 4, MAX_NEW, MAX_NEW // 2, MAX_NEW, MAX_NEW // 4, MAX_NEW // 2]
    plain = {kv: q8_plain_streams(torch, cfg, params8, stop_ids, prompts, kv)
             for kv in ("int8", None)}
    launches = {}
    for label, kw in (("q8_paged_ragged_int8kv_fused",
                       dict(SCHED, kv_quant="int8", ragged=True, fuse_matmuls=True)),
                      ("q8_contiguous", dict(num_slots=8, decode_chunk=8))):
        sched = ContinuousBatchingScheduler(cfg, params8, stop_ids=stop_ids, device="cuda",
                                            **kw)
        sb = SchedulerBackend(sched, tok, max_new_tokens=MAX_NEW)
        svc = GenerationService()
        svc.register("duckdb-nsql", sb)
        torch.cuda.synchronize()
        reset_launches()
        r0, p0 = sched.rounds_issued, sched.prefill_forwards
        results, walls = send_traffic(svc)
        if sched._paged:
            stats = wait_idle(sched)
        wait_settled(sched)
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        rounds, prefills = sched.rounds_issued - r0, sched.prefill_forwards - p0
        want = dict.fromkeys(LAUNCHES, 0)
        (expect_paged if sched._paged else expect_contiguous)(want, sched, rounds, prefills)
        report_traffic(results, walls, weights="int8", layout=sched.kv_layout,
                       kv=sched.kv_quant or "bf16")
        extra = (f"; mixed rounds {sched.mixed_rounds}, ragged prefills "
                 f"{sched.ragged_prefills}; pages {stats}" if sched._paged else "")
        print(f"  {label}: {rounds} decode rounds, {prefills} prefill forwards{extra}; "
              f"launches {launches[label]} expected {want}", flush=True)
        assert launches[label] == want, f"{label}: launch counts {launches[label]} != {want}"
        assert launches[label]["int8_matmul"] > 0
        outs = burst(sched, prompts, budgets)
        same = compare_streams(torch, sched, label, prompts, outs,
                               [r[:m] for r, m in zip(plain[sched.kv_quant], budgets)],
                               tally_div, params=params8)
        print(f"  {label}: {same} of {len(prompts)} staggered burst streams equal to the "
              f"plain engine's", flush=True)
        if sched._paged:
            wait_idle(sched)
            sb.shutdown()
            sched._page_alloc.check()
            st = sched.page_stats
            assert st["pages_in_use"] == st["prefix_resident_pages"], f"leaked pages: {st}"
            assert sched.mixed_rounds > 0, f"{label}: no ragged mixed round ran"
        else:
            wait_settled(sched)
            sb.shutdown()
        del svc, sb, sched
        gc.collect()
        torch.cuda.empty_cache()

    label = "q8_spec_paged_int8kv_fused"
    sched = ContinuousBatchingScheduler(cfg, params8, stop_ids=stop_ids, device="cuda",
                                        speculative_draft=SPEC_DRAFT, **dict(
                                            SCHED, kv_quant="int8", fuse_matmuls=True))
    with sched:
        torch.cuda.synchronize()
        reset_launches()
        outs = burst(sched, prompts, MAX_NEW)
        wait_settled(sched)
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        stats = wait_idle(sched)
    want = dict.fromkeys(LAUNCHES, 0)
    expect_spec(want, sched, sched.rounds_issued, sched.prefill_forwards)
    tpr = spec_report(label, sched.speculation_stats, outs)
    same = compare_streams(torch, sched, label, prompts, outs, plain["int8"], tally_div,
                           params=params8)
    print(f"  {label}: {sched.rounds_issued} verify rounds, {tpr} tokens a round; {same} of "
          f"{len(prompts)} streams equal to the plain engine's; pages {stats}; launches "
          f"{launches[label]} expected {want}", flush=True)
    assert launches[label] == want, f"{label}: launch counts {launches[label]} != {want}"
    sched._page_alloc.check()
    st = sched.page_stats
    assert st["pages_in_use"] == st["prefix_resident_pages"], f"leaked pages: {st}"
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Phase 14 (a): the int8 matmul at every weight shape the int8 paths give
# it: (model, name, layout, IN, OUT). io weights are [IN, OUT]; the unembed
# ("vd") reads the [V, D] table as it is stored (OUT = V).
INT8_SHAPES = [("7b", "wq/wk/wv/wo", "io", 4096, 4096), ("7b", "wg/wu", "io", 4096, 11008),
               ("7b", "wd", "io", 11008, 4096), ("7b", "wqkv", "io", 4096, 3 * 4096),
               ("7b", "wgu", "io", 4096, 2 * 11008), ("7b", "unembed", "vd", 4096, 32000),
               ("3b", "wq/wo", "io", 3072, 3072), ("3b", "wk/wv", "io", 3072, 1024),
               ("3b", "wg/wu", "io", 3072, 8192), ("3b", "wd", "io", 8192, 3072),
               ("3b", "wkv", "io", 3072, 2 * 1024), ("3b", "wgu", "io", 3072, 2 * 8192),
               ("3b", "unembed", "vd", 3072, 128256)]
# Rows: each bf16 route's first and last count (decode 1..8, then the wgmma
# kernel's tiles N of 16, 32, 64, 80, 128 and 256 rows; tiles of 256 above)
# and the counts the paths give it.
INT8_ROWS = (1, 3, 4, 8, 9, 16, 17, 32, 33, 64, 65, 72, 80, 81, 128, 129, 256, 257, 384, 1024)
# The small f32 case: (name, layout, IN, OUT, rows).
INT8_F32 = [("wq f32", "io", 4096, 4096, (1, 9)), ("unembed f32", "vd", 4096, 32000, (3,))]
# int8 matmul vs plain: bf16 block outputs within one bf16 ulp of the plain
# value, element by element (`bf16_ulps`); f32 logits and f32 outputs
# within these fractions of max |plain| (only the order of the f32 sums
# differs: the products of bf16 or f32 x and int8 weights are exact in
# f32 for bf16 x, and the scale multiplies the sum in both).
INT8_LOGIT_TOL = 1e-4
INT8_F32_TOL = 1e-5
# Phase 14 (b): row 8 at the fused trees' stacked widths, (model, name, IN,
# C, OUT), and the rows it is held at.
INT4_STACKED = [("7b", "wqkv", 4096, 3, 4096), ("7b", "wgu", 4096, 2, 11008),
                ("3b", "wkv", 3072, 2, 1024), ("3b", "wgu", 3072, 2, 8192)]
INT4_STACKED_ROWS = (1, 8, 72, 384)


def bf16_ulps(out, ref):
    """The largest |out - ref| in units of ref's bf16 ulp, element by
    element; an element's ulp is floored at 2**-8 of the ulp of the largest
    |ref| (an output that cancels to near zero carries the f32 sum order's
    error, ~1e-6 of the largest, which is more than its own ulp)."""
    import torch

    r = ref.float()
    top = r.abs().max().clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    floor = torch.exp2(torch.floor(torch.log2(top)) - 15)
    return float(((out.float() - r).abs() / torch.maximum(ulp, floor)).max())


def int8_weight(torch, g, layout, n_in, n_out):
    """A random int8 weight of `layout` and its scales, as
    `quantize_params` / `quantize_unembed` give them for weights of
    init_params' magnitude: codes over the whole range, scales
    fan_in ** -0.5 / 127 times a factor in (0.5, 1)."""
    shape = (n_in, n_out) if layout == "io" else (n_out, n_in)
    q8 = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8, device="cuda")
    s = (torch.rand((n_out,), generator=g, device="cuda") * 0.5 + 0.5) * n_in ** -0.5 / 127
    return q8, s


def check_int8(torch, mm8):
    """Phase 14 (a): the int8 matmul kernel vs its plain version at every
    shape of INT8_SHAPES and R in INT8_ROWS in bf16 (the decode kernel up
    to 8 rows, the wgmma kernel above), and the f32 cases (the GEMV); every
    call launched twice and compared bit for bit. Returns the worst errors:
    bf16 block outputs in ulps, logits and f32 outputs over max |plain|,
    absolute by dtype."""
    worst = {"bf16_ulps": 0.0, "logits_rel": 0.0, "float32_rel": 0.0,
             "abs": {"bfloat16": 0.0, "float32": 0.0}}
    g = torch.Generator(device="cuda").manual_seed(7)
    cases = [(m, n, lay, i, o, INT8_ROWS, torch.bfloat16) for m, n, lay, i, o in INT8_SHAPES]
    cases += [("7b", n, lay, i, o, rows, torch.float32) for n, lay, i, o, rows in INT8_F32]
    for model, name, layout, n_in, n_out, rows_list, dtype in cases:
        q8, s = int8_weight(torch, g, layout, n_in, n_out)
        for rows in rows_list:
            x = torch.randn((rows, n_in), generator=g, device="cuda").to(dtype)
            out = mm8.int8_matmul_cuda(x, q8, s, layout)
            again = mm8.int8_matmul_cuda(x, q8, s, layout)
            ref = mm8.int8_matmul_plain(x, q8, s, layout)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[1]
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"int8/{model} {name} R={rows}: non-finite"
            same = torch.equal(out, again)
            err = float((out.float() - ref.float()).abs().max())
            rel = err / float(ref.float().abs().max())
            if layout == "vd":
                key, val, tol = "logits_rel", rel, INT8_LOGIT_TOL
            elif dtype == torch.float32:
                key, val, tol = "float32_rel", rel, INT8_F32_TOL
            else:
                key, val, tol = "bf16_ulps", bf16_ulps(out, ref), 1.0
            ok = val <= tol and same
            route = mm8.int8_route(rows, dtype)
            print(f"  int8    {model:4s} {name:12s} {layout} {route:6s} R={rows:5d} "
                  f"{dname:8s} max_abs_err={err:.3e} {key}={val:.3e} tol={tol:.0e} "
                  f"bit-identical twice: {same} {'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"int8/{model} {name} R={rows} {dname}: {key} {val}, same {same}"
            worst[key] = max(worst[key], val)
            worst["abs"][dname] = max(worst["abs"][dname], err)
        del q8, s
    return worst


def check_int4_stacked(torch, mm_mod):
    """Phase 14 (b): row 8 at the fused trees' stacked widths (q4 [IN/2, C,
    OUT], s4 [G, C, OUT], flattened by the wrapper) vs its plain version at
    INT4_TOL, R in INT4_STACKED_ROWS. Returns the worst error over max
    |out| in bf16."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_weight_int4,
        tp_safe_group,
    )

    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(8)
    for model, name, n_in, c, n_out in INT4_STACKED:
        # Stacked as `fuse_blocks` stacks C projections' trees, on axis -2.
        parts = [quantize_weight_int4(torch.randn((n_in, n_out), generator=g, device="cuda")
                                      * n_in ** -0.5, tp_safe_group(n_in)) for _ in range(c)]
        q4 = torch.stack([p["q4"] for p in parts], dim=-2)
        s4 = torch.stack([p["s4"] for p in parts], dim=-2)
        for rows in INT4_STACKED_ROWS:
            x = torch.randn((rows, n_in), generator=g, device="cuda").bfloat16()
            out = mm_mod.int4_matmul_cuda(x, q4, s4)
            ref = mm_mod.int4_matmul_plain(x, q4, s4)
            torch.cuda.synchronize()
            assert out.shape == (rows, c * n_out) and torch.isfinite(out).all()
            rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
            ok = rel <= INT4_TOL["bfloat16"]
            print(f"  int4 stacked {model:4s} {name:5s} [{n_in // 2}, {c}, {n_out}] R={rows:5d} "
                  f"rel={rel:.3e} tol={INT4_TOL['bfloat16']:.0e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            assert ok, f"int4 stacked {model} {name} R={rows}: {rel}"
            worst = max(worst, rel)
    return worst


INT8_TIME_ROWS = (1, 8, 72, 1024)
INT8_HEADLINE = "7b_wd_R8"  # the kernels line's `ms`: 7B's wd at the 8 slots' decode  # decode (engine, 8 slots), verify (D = 8), prefill
L2_FLUSH_BYTES = 256 << 20         # the weights one timing cycles through


def int8_launch(mm8, rows, n_in, n_out, layout):
    """(route, tile, splits, blocks) of one bf16 int8 matmul launch on this
    card, by the wrapper's own rules."""
    import torch

    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.launches import sm_count

    route = mm8.int8_route(rows, torch.bfloat16)
    tile, splits, _ = mm8.split_plan(route, rows, n_in, n_out, layout,
                                     sm_count(torch.device("cuda", 0)))
    if route == "decode":
        blocks = -(-n_out // tile) * splits
    else:
        blocks = -(-n_out // mm8._WGMMA_COLS) * splits * -(-rows // tile)
    return route, tile, splits, blocks


def int8_ptxas(report):
    """Phase 14 (f): `nvcc -Xptxas -v`'s registers, shared memory and
    spills of every int8_matmul kernel (template arguments as ptxas names
    them: layout and column slices, or layout and N, then the output
    type). Returns {kernel: (registers, smem bytes, spill stores, spill
    loads)}."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(int8_\w+?_kernel)I(.*?E)Ev", line)
            if m:
                args = re.findall(r"Li(\d+)E", m.group(2))
                kind = "bf16" if "bfloat16" in m.group(2) else "f32"
                name = f"{m.group(1)}<{', '.join(args + [kind])}>"
            else:
                name = line.split("'")[1][:60]
            out[name] = [None, None, 0, 0]
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[name][2:] = [int(m.group(1)), int(m.group(2))]
        elif name and "Used" in line:
            reg = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out[name][0] = int(reg.group(1)) if reg else None
            out[name][1] = int(smem.group(1)) if smem else 0
    for k, (reg, smem, st, ld) in out.items():
        print(f"  ptxas {k:44s} {reg} registers, {smem} bytes static smem, spills "
              f"{st} / {ld} bytes", flush=True)
    return {k: tuple(v) for k, v in out.items()}


def wrapper_host_us(torch, mm8, mm_mod, calls=200, reps=5):
    """Phase 14 (f): host us a call of the int8 wrapper (`int8_matmul`, the
    entry the model calls) at 7B wq, R = 1, beside row 8's wrapper at the
    same shape and a bf16 `torch.matmul` dispatch: host clocks around
    `calls` enqueues (no synchronise inside them; the queue never fills),
    the median of `reps` runs."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_weight_int4,
        tp_safe_group,
    )

    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((1, 4096), generator=g, device="cuda").bfloat16()
    q8, s = int8_weight(torch, g, "io", 4096, 4096)
    w4 = quantize_weight_int4(torch.randn((4096, 4096), generator=g, device="cuda")
                              * 4096 ** -0.5, tp_safe_group(4096))
    wb = (q8.float() * s[None, :]).bfloat16()
    fns = {"int8_matmul": lambda: mm8.int8_matmul(x, q8, s),
           "int4_matmul": lambda: mm_mod.int4_matmul(x, w4["q4"], w4["s4"]),
           "torch.matmul bf16": lambda: torch.matmul(x, wb)}
    out = {}
    for name, fn in fns.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        out[name] = sorted(runs)[reps // 2]
    print("  host us a call, 7B wq R=1: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()),
          flush=True)
    return out


def time_int8(torch, mm8, mm_mod, report=""):
    """Phase 14 (f): the int8 matmul at every shape of INT8_SHAPES and row
    8 at INT4_STACKED, R in INT8_TIME_ROWS (bf16): kernel, plain, and
    cuBLAS bf16 against the weight dequantized to bf16 in advance (the
    yardstick only: it moves 2x the int8 bytes, and its weight is not the
    int8 function's), with each int8 call's route, tile, splits and blocks.
    Each call on its own copy of the weight, copies cycled past L2 (at
    least 256 MB). Bound: x, the weight, its scales and out once each over
    3.35 TB/s, or 2 R IN OUT operations over 989 TFLOP/s (the products are
    bf16 x int8 in bf16 on the tensor cores). Then the int8 kernels' ptxas
    report (`int8_ptxas` of the build's `report`) and the wrappers' host
    time (`wrapper_host_us`)."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        dequantize_weight_int4,
        quantize_weight_int4,
        tp_safe_group,
    )

    g = torch.Generator(device="cuda").manual_seed(9)
    out = {"int8": {}, "int4_stacked": {}}
    for model, name, layout, n_in, n_out in INT8_SHAPES:
        copies = max(2, min(32, -(-L2_FLUSH_BYTES // (n_in * n_out))))
        ws = [int8_weight(torch, g, layout, n_in, n_out) for _ in range(copies)]
        wb = [(q.float() * (s[None, :] if layout == "io" else s[:, None])).bfloat16()
              for q, s in ws]
        for rows in INT8_TIME_ROWS:
            x = torch.randn((rows, n_in), generator=g, device="cuda").bfloat16()
            ms = time_ms(torch, lambda i: mm8.int8_matmul_cuda(x, *ws[i % copies], layout),
                         copies)
            plain = time_ms(torch, lambda i: mm8.int8_matmul_plain(x, *ws[i % copies], layout),
                            copies, reps=3)
            if layout == "io":
                lib = time_ms(torch, lambda i: torch.matmul(x, wb[i % copies]), copies)
            else:
                lib = time_ms(torch, lambda i: torch.mm(x, wb[i % copies].t(),
                                                        out_dtype=torch.float32), copies)
            nbytes = (x.numel() * 2 + n_in * n_out + n_out * 4
                      + rows * n_out * (4 if layout == "vd" else 2))
            b_ms, b_by = bound(nbytes, 2 * rows * n_in * n_out)
            key = f"{model}_{name.split('/')[0]}_R{rows}"
            route, tile, splits, blocks = int8_launch(mm8, rows, n_in, n_out, layout)
            out["int8"][key] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                                    bound_by=b_by, route=route, tile=tile, splits=splits,
                                    blocks=blocks,
                                    shape=dict(R=rows, IN=n_in, OUT=n_out, layout=layout,
                                               dtype="bfloat16"))
            print(f"  int8 {key:22s} {ms:.4f} ms (bound {b_ms:.4f} {b_by}, cuBLAS bf16 "
                  f"{lib:.4f}, plain {plain:.4f}) {route} tile {tile} splits {splits} "
                  f"blocks {blocks}", flush=True)
        del ws, wb
    for model, name, n_in, c, n_out in INT4_STACKED:
        copies = max(2, min(32, -(-L2_FLUSH_BYTES // (n_in * c * n_out // 2))))
        group = tp_safe_group(n_in)
        ws = []
        for _ in range(copies):
            w = quantize_weight_int4(torch.randn((n_in, c * n_out), generator=g,
                                                 device="cuda") * n_in ** -0.5, group)
            ws.append((w["q4"].view(n_in // 2, c, n_out), w["s4"].view(-1, c, n_out)))
        wb = [dequantize_weight_int4({"q4": q.reshape(n_in // 2, -1),
                                      "s4": s.reshape(s.shape[0], -1)}, torch.bfloat16)
              for q, s in ws]
        for rows in INT8_TIME_ROWS:
            x = torch.randn((rows, n_in), generator=g, device="cuda").bfloat16()
            ms = time_ms(torch, lambda i: mm_mod.int4_matmul_cuda(x, *ws[i % copies]), copies)
            plain = time_ms(torch, lambda i: mm_mod.int4_matmul_plain(x, *ws[i % copies]),
                            copies, reps=3)
            lib = time_ms(torch, lambda i: torch.matmul(x, wb[i % copies]), copies)
            nbytes = (x.numel() * 2 + n_in // 2 * c * n_out + ws[0][1].numel() * 4
                      + rows * c * n_out * 2)
            b_ms, b_by = bound(nbytes, 2 * rows * n_in * c * n_out)
            key = f"{model}_{name}_R{rows}"
            out["int4_stacked"][key] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                route=mm_mod.int4_route(rows, x.dtype),
                shape=dict(R=rows, IN=n_in, C=c, OUT=n_out, group=group, dtype="bfloat16"))
            print(f"  int4 stacked {key:16s} {ms:.4f} ms (bound {b_ms:.4f} {b_by}, cuBLAS "
                  f"bf16 {lib:.4f}, plain {plain:.4f})", flush=True)
        del ws, wb
    torch.cuda.empty_cache()
    out["int8_ptxas"] = int8_ptxas(report)
    out["host_us"] = wrapper_host_us(torch, mm8, mm_mod)
    return out


# ------------------------------------------------------------- phase 20: meshes

MESH_SLOTS = 8        # the SQL prompts of the phase (phase 21's pool serves them too)
MESH_B_PROMPTS = 4    # (b): prompts of the 3B int4 engine batch
MESH_RING_T = 2048    # (c): the ring prefill's prompt
MESH_RING_DECODE = 16  # (c): decode steps on the sp-sharded cache
MESH_TIMEOUT_S = 600  # a rank that has not finished by then is stuck
MESH_NEW = 16         # (d): the runbook's --max-new-tokens
# Rows of PERF.md's table checked at the per-rank shapes (`rank_kernel_checks`).
MESH_ROWS = {"prefill": "row1", "decode": "row2", "decode_q": "row3", "paged": "row4",
             "write": "row6", "int4": "row8"}


def mesh_hf_dir(engines, root):
    """`--mesh-only`'s stand-in for phase 10's HF directory: the 7B seed tree
    cut to HF_LAYERS layers in f32 safetensors, with the phase tokenizer."""
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import save_hf_checkpoint

    base = engines["duckdb-nsql"]
    cfg = dataclasses.replace(base.cfg, num_layers=HF_LAYERS)
    seed = {**{k: v for k, v in base.params.items() if k != "blocks"},
            "blocks": {k: v[:HF_LAYERS] for k, v in base.params["blocks"].items()}}
    d = os.path.join(root, "duckdb-nsql-7b")
    save_hf_checkpoint(cfg, seed, d)
    write_tokenizer(d)
    return d


def mesh_prompts(tok):
    return [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in (SCHED_SQL * 2)[:MESH_SLOTS]]


def mesh_norm(text):
    """A report without its wall-clock fields (latencies, tok/s, the
    roofline shares, TTFT and queue-wait lines, the timestamp, platform)."""
    out = []
    for line in text.splitlines():
        if re.search(r"TTFT|queue wait|platform|generated \d", line, re.I):
            continue
        if re.search(r"latency|tok/s|Throughput|cadence|MFU", line, re.I) or " s |" in line:
            line = re.sub(r"\d+\.\d+", "#", line)
            line = re.sub(r"\*\*[^*]+\*\* \(avg #", "** (avg #", line)
        out.append(line)
    return "\n".join(out)


def mesh_inputs(torch, engines):
    """What phase 20's ranks and references take: the SQL prompts, the stop
    ids and the ring's 2048-token prompt (seed 7)."""
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    e7, e3 = engines["duckdb-nsql"], engines["llama3.2"]
    g = torch.Generator().manual_seed(7)
    ring = torch.randint(3, e7.cfg.vocab_size, (MESH_RING_T,), generator=g)
    return {"prompts": mesh_prompts(ByteTokenizer()),
            "stop7": list(e7.stop_ids), "stop3": list(e3.stop_ids),
            "ring_prompt": ring.tolist()}


def mesh_references(torch, engines, inp):
    """Phase 20's tp=1 side, in this process: (b) the 3B int4 engine over a
    bf16 and an int8 cache; (c) the 7B prefill of the 2048-token prompt and
    16 greedy decode steps. Returns what the ranks are held to. (a)'s tp=2
    scheduler moved to phase 21's pool, with its reference."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import init_cache
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_params_int4,
    )

    e7, e3 = engines["duckdb-nsql"], engines["llama3.2"]
    cfg7 = e7.cfg
    prompts = inp["prompts"]
    ref = {}
    q4 = quantize_params_int4(e3.params)
    b_prompts = prompts[:MESH_B_PROMPTS]
    ref["b"] = {}
    for kvq in (None, "int8"):
        eng = InferenceEngine(e3.cfg, q4, stop_ids=e3.stop_ids, device="cuda",
                              kv_quant=kvq)
        ref["b"][str(kvq)] = eng.generate(b_prompts, max_new_tokens=MAX_NEW)
    ring = torch.tensor([inp["ring_prompt"]], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        cache = init_cache(cfg7, 1, MESH_RING_T + MESH_RING_DECODE,
                           dtype=torch.bfloat16, device="cuda")
        pos = torch.arange(MESH_RING_T, dtype=torch.int32, device="cuda")[None]
        logits, cache = forward(cfg7, e7.params, ring, pos, cache,
                                logit_indices=torch.tensor([MESH_RING_T - 1],
                                                           device="cuda"))
        ref["ring_logits"] = logits[0, 0].float().cpu()
        toks, cur = [], logits[0, 0].argmax().int()
        for i in range(MESH_RING_DECODE):
            toks.append(int(cur))
            p = torch.tensor([[MESH_RING_T + i]], dtype=torch.int32, device="cuda")
            logits, cache = forward(cfg7, e7.params, cur.view(1, 1), p, cache)
            cur = logits[0, 0].argmax().int()
        ref["ring_tokens"] = toks
    del cache
    return ref, q4


def start_ranks(torch, root, argv_extra=()):
    """The two rank processes of phase 20, both on cuda:0, joined over a
    localhost coordinator; their output goes to files under `root`."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, LSOT_COORDINATOR=f"127.0.0.1:{port}",
                   LSOT_NUM_PROCESSES="2", LSOT_PROCESS_ID=str(rank),
                   LSOT_MESH_ROOT=root)
        log = open(os.path.join(root, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(rank),
             *argv_extra], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs, root):
    """Wait for both ranks; a failed or stuck rank fails the phase with the
    tail of its log."""
    deadline = time.time() + MESH_TIMEOUT_S
    for p, log in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
                q.wait()
        log.close()
    for rank, (p, _) in enumerate(procs):
        with open(os.path.join(root, f"rank{rank}.log")) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith("  ") or line.startswith("mesh "):
                print(f"  [rank {rank}] {line.strip()}", flush=True)
        assert p.returncode == 0, f"mesh rank {rank} failed ({p.returncode}):\n{text[-4000:]}"
    out = []
    for rank in range(2):
        with open(os.path.join(root, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_serve(torch, engines, smi, hf_dir=None):
    """Phase 20: tensor and sequence parallelism on two ranks, both
    processes on cuda:0 over gloo (NCCL refuses two ranks on one card), so
    every collective stages through host memory. While the ranks run
    (a)-(d) (`mesh_rank`), this process computes the tp=1 references
    (`mesh_references`), then runs (d)'s runbook as one command twice
    (convert, then restore) when phase 10's HF directory is given, whose
    cache (d)'s ranks restore; then it holds the ranks' results and launch
    counts to the references. Returns (launches by path, numbers)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # three more processes share the card
    print(f"  this process: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", flush=True)
    root = tempfile.mkdtemp(prefix="lsot-mesh-")
    try:
        inp = mesh_inputs(torch, engines)
        inp["hf_dir"] = hf_dir
        torch.save(inp, os.path.join(root, "inputs.pt"))
        numbers = {"device": smi}
        # The ranks run while this process computes the references (done
        # before the ranks load (c)'s two whole 7B trees) and then runs
        # (d)'s tp=1 commands, whose cache (d)'s ranks restore.
        t0 = time.perf_counter()
        procs = start_ranks(torch, root)
        try:
            ref, q4 = mesh_references(torch, engines, inp)
            ref.update(inp)
            gc.collect()
            torch.cuda.empty_cache()  # (c)'s ranks need what the references freed
            try:
                if hf_dir is not None:
                    numbers["runbook_tp1"] = mesh_runbook_cli(torch, hf_dir, root)
            finally:
                open(os.path.join(root, "runbook.done"), "w").close()
            ranks = wait_ranks(procs, root)
        finally:
            for p, _ in procs:  # stop a rank left running by a failure here
                if p.poll() is None:
                    p.kill()
                    p.wait()
        numbers["ranks_s"] = round(time.perf_counter() - t0, 1)
        r0, r1 = ranks
        e7, e3 = engines["duckdb-nsql"], engines["llama3.2"]
        bounds, div = {}, []
        # (a) is the per-rank kernel checks alone (its scheduler: phase 21).
        # (b) greedy tokens of the tp=2 int4 engine against tp=1's.
        for kvq in ("None", "int8"):
            div += fleet_compare(torch, f"mesh_tp2_3b_int4_kv{kvq}", e3.cfg, q4,
                                 e3.stop_ids, ref["prompts"][:MESH_B_PROMPTS],
                                 r0["b"][kvq], ref["b"][kvq], bounds,
                                 kv_quant=None if kvq == "None" else "int8")
            assert r1["b"][kvq] == r0["b"][kvq], f"(b) ranks disagree, kv {kvq}"
        # (c) ring prefill logits within LOGIT_TOL of the tp=1 flash prefill;
        # decode tokens equal or near-ties.
        want = ref["ring_logits"]
        rel = max(((torch.load(os.path.join(root, f"ring{r}.pt")) - want).abs().max()
                   / want.abs().max()).item() for r in range(2))
        print(f"  (c) ring prefill logits vs the tp=1 flash prefill: max |diff| / "
              f"max |logit| {rel:.3e} (tol {LOGIT_TOL:.0e})", flush=True)
        assert rel <= LOGIT_TOL, f"(c) ring prefill logits: {rel} > {LOGIT_TOL}"
        div += fleet_compare(torch, "mesh_sp2_ring", e7.cfg, e7.params, e7.stop_ids,
                             [ref["ring_prompt"]], [r0["c"]["tokens"]],
                             [ref["ring_tokens"]], bounds)
        assert r1["c"]["tokens"] == r0["c"]["tokens"], "(c) ranks disagree"
        numbers.update(
            b={kvq: {"equal": sum(a == b for a, b in zip(r0["b"][kvq], ref["b"][kvq])),
                     "seconds": r0["b"]["seconds"][kvq]} for kvq in ("None", "int8")},
            c={"prefill_rel_err": rel, "prefill_s": r0["c"]["prefill_s"],
               "decode_s": r0["c"]["decode_s"],
               "tokens_equal": r0["c"]["tokens"] == ref["ring_tokens"]},
            d=r0.get("d"), kernels_per_rank=r0["kernels"], divergences=div,
            staged=r0["staged"])
        launches = {}
        for rank, r in enumerate(ranks):
            for path, counts in r["launches"].items():
                launches[f"{path}_rank{rank}"] = counts
        numbers["seconds"] = round(time.perf_counter() - t_phase, 1)
        print(f"  phase 20: {json.dumps(numbers)}", flush=True)
        return launches, numbers
    finally:
        shutil.rmtree(root, ignore_errors=True)


def mesh_runbook_cli(torch, hf_dir, root):
    """(d), tp=1: `python -m ...runbook` as one command over phase 10's
    4-layer 7B HF directory, twice: the first run converts and fills the
    cache, the second restores it; the two reports are equal apart from
    wall-clock fields."""
    cache = os.path.join(root, "runbook-cache")
    texts, logs = [], []
    for i in range(2):
        out = os.path.join(root, f"runbook{i}.md")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.runbook", "--sql-model", hf_dir,
             "--cache-dir", cache, "--limit-cases", "1", "--max-new-tokens",
             str(MESH_NEW), "-o", out],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        assert proc.returncode == 0, f"runbook run {i}: {proc.stderr[-3000:]}"
        logs.append(proc.stdout + proc.stderr)
        with open(out) as f:
            texts.append(f.read())
        print(f"  (d) runbook run {i + 1}: {time.perf_counter() - t0:.1f} s", flush=True)
    assert "converted + cached" in logs[0], logs[0][-2000:]
    assert "restored native cache" in logs[1], logs[1][-2000:]
    assert "Four-query suite" in texts[0] and mesh_norm(texts[0]) == mesh_norm(texts[1])
    return {"reports_equal": True, "cache": cache}


def rank_kernel_checks(torch, part):
    """Rows of PERF.md's table at the per-rank shapes of phase 20 against
    their plain versions: (a) the 7B's 16 heads a rank, row 1 (the flash
    prefill at the scheduler's chunk), row 4 (the paged decode) and row 6
    (the page write); (b) the 3B's 12 query and 4 KV heads a rank (G = 3),
    rows 2 and 3 (the decode over a bf16 and an int8 cache) and row 8 (the
    int4 product at the row-parallel wd's half contraction and at the
    column-parallel halves). Returns the worst error per row."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        attention as attn_mod,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        int4mm as mm_mod,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        paged_attention as pa_mod,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        paged_write as pw_mod,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_weight_int4,
        tp_safe_group,
    )

    bf16 = torch.bfloat16
    tol = TOL["bfloat16"]
    worst = {}

    def note(row, label, err, limit):
        print(f"  {row:8s} {label:28s} max_err={err:.3e} tol={limit:.0e} "
              f"{'ok' if err <= limit else 'FAIL'}", flush=True)
        assert err <= limit, f"{row}/{label}: {err} > {limit}"
        worst[row] = max(worst.get(row, 0.0), err)

    def run(starts, t):
        return [[st + i for i in range(t)] for st in starts]

    if part == "a":
        c = make_case(torch, bf16, b=6, t=128, n=16, kh=16, h=128, s=512,
                      positions=run([0, 128, 256, 0, 208, 384], 128), nan_dead=True)
        args = (c["q"], c["k"], c["v"], c["pos"], c["window"], c["kv_lens"])
        out = attn_mod.flash_gqa_attention_cuda(*args)
        ref = attn_mod.flash_gqa_attention_plain(*args)
        note("row1", "prefill 7b/tp2 b6 t128 s512", (out.float() - ref.float()).abs().max().item(), tol)
        rows = [(p, 1, p + 1) for p in (318, 357, 390, 412, 444, 1000, 64, 5)]
        args = paged_case(torch, bf16, b=8, t=1, n=16, kh=16, h=128, ps=64,
                          np_tab=16, rows=rows)
        out = pa_mod.ragged_paged_attention_cuda(*args)
        ref = pa_mod.ragged_paged_attention_plain(*args)
        note("row4", "paged decode 7b/tp2 b8", (out.float() - ref.float()).abs().max().item(), tol)
        g = torch.Generator(device="cuda").manual_seed(3)
        shape = (2, 160, 16, 64, 128)
        kk = torch.randn(shape, generator=g, device="cuda", dtype=bf16)
        vk = torch.randn(shape, generator=g, device="cuda", dtype=bf16)
        kr, vr = kk.clone(), vk.clone()
        k_new, v_new, pos, tab, q_lens = write_case(torch, "7b_tp2_t1_b8", 16, 128, 64,
                                                    8, 1, 16, 160, bf16, g)
        pw_mod.fused_page_write_cuda(kk, vk, k_new, v_new, pos, tab, 1, q_lens)
        pw_mod.fused_page_write_plain(kr, vr, k_new, v_new, pos, tab, 1, q_lens)
        torch.cuda.synchronize()
        same = torch.equal(kk, kr) and torch.equal(vk, vr)
        note("row6", "page write 7b/tp2 b8 (bit-exact)", 0.0 if same else 1.0, 0.0)
        return worst
    for label, kw in (("decode 3b/tp2 G=3 b4", dict(b=4, t=1, n=12, kh=4, h=128, s=448,
                                                     positions=[[130], [200], [260], [383]])),
                      ("decode 3b/tp2 G=3 contig b8", dict(
                          b=8, t=1, n=12, kh=4, h=128, s=1024,
                          positions=[[317], [356], [389], [411], [443], [999], [1023], [1023]],
                          kv_lens=[318, 357, 390, 412, 444, 1000, 0, 0], nan_dead=True))):
        c = make_case(torch, bf16, **kw)
        args = (c["q"], c["k"], c["v"], c["pos"], c["window"], c["kv_lens"])
        out = attn_mod.flash_gqa_attention_cuda(*args)
        ref = attn_mod.flash_gqa_attention_plain(*args)
        note("row2", label, (out.float() - ref.float()).abs().max().item(), tol)
        k8, ks = quantize(torch, c["k"])
        v8, vs = quantize(torch, c["v"])
        args = (c["q"], k8, ks, v8, vs, c["pos"], c["window"], c["kv_lens"])
        out = attn_mod.flash_gqa_attention_quantized_cuda(*args)
        ref = attn_mod.flash_gqa_attention_quantized_plain(*args)
        note("row3", label, (out.float() - ref.float()).abs().max().item(), tol)
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, n_full, n_in, n_out in (("wd row half", 8192, 4096, 3072),
                                      ("wq col half", 3072, 3072, 1536),
                                      ("wg col half", 3072, 3072, 4096)):
        w = quantize_weight_int4(torch.randn((n_in, n_out), generator=g, device="cuda")
                                 * n_full ** -0.5, tp_safe_group(n_full))
        for rows in (1, 8, 384):
            x = torch.randn((rows, n_in), generator=g, device="cuda").to(bf16)
            out = mm_mod.int4_matmul_cuda(x, w["q4"], w["s4"])
            ref = mm_mod.int4_matmul_plain(x, w["q4"], w["s4"])
            rel = (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
            note("row8", f"int4 3b/tp2 {name} R={rows}", rel, INT4_TOL["bfloat16"])
    return worst


def _launch_snapshot():
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.launches import (
        LAUNCHES,
    )

    return dict(LAUNCHES)


def mesh_rank(rank) -> int:
    """One rank of phase 20 (a process `mesh_serve` starts): joins the group
    from LSOT_COORDINATOR, runs (a)-(d) on its shard, and writes its checks
    and launch counts to LSOT_MESH_ROOT/rank{rank}.json."""
    import faulthandler

    faulthandler.dump_traceback_later(MESH_TIMEOUT_S - 30, exit=True)
    import torch

    from llm_based_apache_spark_optimization_tpu_torch.models import (
        DUCKDB_NSQL_7B,
        LLAMA32_3B,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.launches import (
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        spmd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.environ["LSOT_MESH_ROOT"]
    ref = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    assert init_distributed()
    mesh = make_mesh(tp=2, devices=["cuda:0", "cuda:0"])
    print(f"  {mesh.describe()}", flush=True)
    assert mesh.backend == "gloo" and mesh.staged
    out = {"staged": mesh.describe(), "launches": {}, "kernels": {}}
    inf = torch.inference_mode()

    # (a) the per-rank kernel checks at the 7B's 16 heads a rank. Its tp=2
    # paged scheduler is served by phase 21's pool of tp=2 replicas, which
    # repeats its shapes (a cut for the run's time: PERF.md section 4).
    out["kernels"].update(rank_kernel_checks(torch, "a"))

    # (b) tp=2 3B int4 engine (12 query and 4 KV heads a rank), SPMD.
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_params_int4,
    )

    out["kernels"].update(rank_kernel_checks(torch, "b"))
    with inf:
        q4 = quantize_params_int4(init_params(
            LLAMA32_3B, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
            mesh=mesh), mesh=mesh)
    out["b"] = {"seconds": {}}
    for kvq in (None, "int8"):
        reset_launches()
        eng = InferenceEngine(LLAMA32_3B, q4, stop_ids=ref["stop3"], kv_quant=kvq,
                              mesh=mesh)
        t0 = time.perf_counter()
        toks = eng.generate(ref["prompts"][:MESH_B_PROMPTS], max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        out["b"]["seconds"][str(kvq)] = round(time.perf_counter() - t0, 2)
        out["b"][str(kvq)] = toks
        got = _launch_snapshot()
        f, L = eng.last_stats["forward_calls"], LLAMA32_3B.num_layers
        want = dict.fromkeys(got, 0)
        want["flash_gqa_prefill"] = L
        want["flash_gqa_decode_quantized" if kvq else "flash_gqa_decode"] = L * (f - 1)
        want["int4_matmul"] = 7 * L * f
        assert got == want, f"(b) rank {rank} kv {kvq}: launches {got} != {want}"
        out["launches"][f"mesh_tp2_3b_int4_kv{kvq}"] = got
    del q4, eng
    spmd.close(mesh)
    del mesh
    gc.collect()
    torch.cuda.empty_cache()

    # (c) sp=2 ring prefill of one 2048-token prompt on the 7B, then decode
    # steps on the sp-sharded cache through the sp combine.
    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import init_cache
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import (
        SpSlotCache,
        forward,
    )

    smesh = make_mesh(sp=2, devices=["cuda:0", "cuda:0"])
    with inf:
        params = init_params(DUCKDB_NSQL_7B, torch.Generator(device="cuda").manual_seed(0),
                             torch.bfloat16, device="cuda")
        s_total = MESH_RING_T + MESH_RING_DECODE
        cache = SpSlotCache(init_cache(DUCKDB_NSQL_7B, 1,
                                       -(-(s_total + -s_total % 8) // 2),
                                       dtype=torch.bfloat16, device="cuda"))
        toks = torch.tensor([ref["ring_prompt"]], dtype=torch.int32, device="cuda")
        pos = torch.arange(MESH_RING_T, dtype=torch.int32, device="cuda")[None]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = forward(DUCKDB_NSQL_7B, params, toks, pos, cache,
                                logit_indices=torch.tensor([MESH_RING_T - 1], device="cuda"),
                                mesh=smesh, attn_impl="ring")
        torch.cuda.synchronize()
        prefill_s = round(time.perf_counter() - t0, 2)
        torch.save(logits[0, 0].float().cpu(), os.path.join(root, f"ring{rank}.pt"))
        cur, stream = logits[0, 0].argmax().int(), []
        t0 = time.perf_counter()
        for i in range(MESH_RING_DECODE):
            stream.append(int(cur))
            p = torch.tensor([[MESH_RING_T + i]], dtype=torch.int32, device="cuda")
            logits, cache = forward(DUCKDB_NSQL_7B, params, cur.view(1, 1), p, cache,
                                    mesh=smesh)
            cur = logits[0, 0].argmax().int()
        torch.cuda.synchronize()
        got = _launch_snapshot()
    assert not any(got.values()), f"(c): the sp path launched kernels {got}"
    out["c"] = {"tokens": stream, "prefill_s": prefill_s,
                "decode_s": round(time.perf_counter() - t0, 2)}
    out["launches"]["mesh_sp2_ring"] = got
    print(f"  (c) rank {rank}: ring prefill of {MESH_RING_T} tokens in {prefill_s} s; "
          f"{MESH_RING_DECODE} sp decode steps", flush=True)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    spmd.close(smesh)

    # (d) the runbook's build_service at tp=2 over (a)'s two-rank layout,
    # restoring each rank's block from the cache (d)'s tp=1 runs filled.
    mesh = make_mesh(tp=2, devices=["cuda:0", "cuda:0"])
    if ref.get("hf_dir"):
        from llm_based_apache_spark_optimization_tpu_torch import runbook

        # The main process's tp=1 commands fill the cache first.
        while not os.path.exists(os.path.join(root, "runbook.done")):
            time.sleep(0.5)
        from llm_based_apache_spark_optimization_tpu_torch.evalh import report

        args = runbook.build_parser().parse_args(
            ["--sql-model", ref["hf_dir"], "--cache-dir",
             os.path.join(root, "runbook-cache"), "--tp", "2", "--limit-cases", "1",
             "--max-new-tokens", str(MESH_NEW)])
        reset_launches()
        svc = runbook.build_service(args, mesh=mesh)
        if mesh.is_primary:
            spmd.drive(mesh)
            text = report.generate(svc, backend_desc="runbook tp=2 (phase 20 (d))",
                                   max_new_tokens=MESH_NEW, quality_meaningful=True,
                                   service_mesh="tp=2", limit_cases=1,
                                   with_configs=False)
            svc.close()
            assert "Four-query suite" in text
            out["d"] = {"report_lines": len(text.splitlines())}
        spmd.close(mesh)
        torch.cuda.synchronize()
        got = _launch_snapshot()
        assert got["flash_gqa_prefill"] > 0 and got["flash_gqa_decode"] > 0, got
        out["launches"]["mesh_tp2_runbook"] = got
    else:
        spmd.close(mesh)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------- phase 21: a pool of tp meshes

POOL_SLOTS = 8          # slots a replica, as phase 17's
POOL_KV_GB = 8          # (a): KV a replica, priced on every head (each rank holds half)
POOL_DEVICES = "cuda:0,cuda:0,cuda:0,cuda:0"  # LSOT_MESH_DEVICES: both tp=2 replicas on one card
POOL_TIMEOUT_S = 600    # a follower that has not finished by then is stuck
POOL_B_PAGE = 16        # (b): pages of 16 tokens, so 32 new tokens need top-ups
POOL_B_LEN = 384        # (b): each prompt exactly one prompt bucket, BOS included
POOL_B_REQUESTS = 3     # (b): requests at once (a replica that takes two preempts)
POOL_LAYERS = 8         # the 7B's depth in phase 21 (widths whole: 16 heads a rank)
POOL_B_OVERCOMMIT = 0.25
POOL_MODULE = f"{PKG}.app"
NATIVE_ROWS = 500_000   # (c): the CSV's data rows
NATIVE_MERGES = 256     # (c): the BPE's merges, trained on the app's prompts
NATIVE_BYTES = 2**20    # (c): the text the BPE encodes, as prompts of the app
# Rows of PERF.md's table held against their plain versions at phase 21's
# per-rank shapes (`pool_kernel_checks`).
POOL_ROWS = {"paged_q": "row5", "write_q": "row7", "int8": "int8_matmul"}


def pool_args(extra=()):
    """The entry point's flags of phase 21's pools: `--dp 2 --tp 2
    --scheduler --kv-layout paged`, POOL_SLOTS slots, MAX_NEW tokens."""
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry

    return entry.build_parser().parse_args(
        ["--backend", "checkpoint", "--api", "--sql-model-path", "phase21-seed-tree",
         "--dp", "2", "--tp", "2", "--scheduler", "--kv-layout", "paged",
         "--slots", str(POOL_SLOTS), "--max-new-tokens", str(MAX_NEW), *extra])


def pool_env(part):
    """The environment of phase 21's part (a) or (b): the knobs the entry
    point's AppConfig reads. (b)'s pool: int8 KV, spill, overcommit 0.25,
    pages of POOL_B_PAGE."""
    env = {"LSOT_MESH_DEVICES": POOL_DEVICES}
    if part == "a":
        env["LSOT_POOL_PHASES"] = "prefill:1,decode:1"
    else:
        env.update(LSOT_KV_QUANT="int8", LSOT_KV_SPILL="1",
                   LSOT_KV_OVERCOMMIT=str(POOL_B_OVERCOMMIT),
                   LSOT_KV_PAGE_SIZE=str(POOL_B_PAGE))
    return env


class pool_environ:
    """`pool_env(part)` set in os.environ for the block, the old values back
    after it."""

    def __init__(self, part):
        self.env = pool_env(part)

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pool_b_prompts(tok):
    """(b)'s prompts: POOL_B_REQUESTS SQL prompts, each POOL_B_LEN tokens
    exactly (a prompt bucket, so the admission reserves no slack past it),
    each starting with its own index (no two share a prefix block)."""
    out = []
    for i, q in enumerate((SCHED_SQL * 2)[:POOL_B_REQUESTS]):
        text = f"Request {i}. {q}\n\n{SYSTEM_SQL}"
        ids = tok.encode(text)[:POOL_B_LEN]
        ids += [tok.encode(" ", add_bos=False)[0]] * (POOL_B_LEN - len(ids))
        out.append(ids)
    return out


def pool_b_pages(cfg):
    """(b)'s pool and pressure: the pool holds one max-length row (the
    least a pool may), and `kv:pressure` withholds all but two admissions
    and a page, so the two admitted requests' top-ups (each needs one more
    page after 16 tokens) find one free page: the second preempts the
    first, which spills. Returns (pages, bytes of the pool, pages
    withheld, pages an admission takes)."""
    from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import bucket_len
    from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
        page_bytes,
        pages_for_tokens,
    )

    pages = pages_for_tokens(cfg.max_seq_len, POOL_B_PAGE)
    pb = page_bytes(cfg, POOL_B_PAGE, 2, "int8")
    reserve = -int(-MAX_NEW * POOL_B_OVERCOMMIT // 1)
    admit = pages_for_tokens(bucket_len(POOL_B_LEN, 128) + reserve
                             + 2 * SCHED["decode_chunk"], POOL_B_PAGE)
    budget = pages_for_tokens(POOL_B_LEN + MAX_NEW + 2 * SCHED["decode_chunk"], POOL_B_PAGE)
    assert budget > admit, (budget, admit)
    return pages, pages * pb, pages - (2 * admit + 1), admit


def pool_kernel_checks(torch, mm8):
    """Rows of PERF.md's table at phase 21's per-rank shapes (16 of the 7B's
    32 heads a rank), against their plain versions: row 5 (the paged decode
    over an int8 pool of POOL_B_PAGE-token pages), row 7 (the write into
    it, bit for bit), and the int8 matmul at the tp=2 halves of the 7B's
    weights (column-parallel wq and wg, row-parallel wo and wd, the
    vocab-parallel unembed) at R = 1, 8 and 128. Returns the worst error
    by row."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        paged_attention as pa_mod,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        paged_write as pw_mod,
    )

    tol = TOL["bfloat16"]
    worst = {}

    def note(row, label, err, limit):
        print(f"  {row:11s} {label:34s} err={err:.3e} tol={limit:.0e} "
              f"{'ok' if err <= limit else 'FAIL'}", flush=True)
        assert err <= limit, f"{row}/{label}: {err} > {limit}"
        worst[row] = max(worst.get(row, 0.0), err)

    rows = [(p, 1, p + 1) for p in (384, 390, 399, 400, 401, 415, 64, 5)]
    q, kp, vp, tab, pos, window, kvl, qln = paged_case(
        torch, torch.bfloat16, b=8, t=1, n=16, kh=16, h=128, ps=POOL_B_PAGE, np_tab=27,
        rows=rows)
    kp8, kps = quantize(torch, kp)
    vp8, vps = quantize(torch, vp)
    args = (q, kp8, kps, vp8, vps, tab, pos, window, kvl, qln)
    out = pa_mod.ragged_paged_attention_quantized_cuda(*args)
    ref = pa_mod.ragged_paged_attention_quantized_plain(*args)
    note("row5", "paged_q decode 7b/tp2 b8 ps16", (out.float() - ref.float()).abs().max().item(),
         tol)
    g = torch.Generator(device="cuda").manual_seed(21)
    shape = (2, 232, 16, POOL_B_PAGE, 128)
    pools = [torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8),
             torch.rand(shape[:4], generator=g, device="cuda"),
             torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8),
             torch.rand(shape[:4], generator=g, device="cuda")]
    refs = [x.clone() for x in pools]
    k_new, v_new, wpos, wtab, q_lens = write_case(torch, "7b_tp2_t1_b8_ps16", 16, 128,
                                                   POOL_B_PAGE, 8, 1, 27, 232,
                                                   torch.bfloat16, g)
    pw_mod.fused_page_write_quantized_cuda(*pools, k_new, v_new, wpos, wtab, 1, q_lens)
    pw_mod.fused_page_write_quantized_plain(*refs, k_new, v_new, wpos, wtab, 1, q_lens)
    torch.cuda.synchronize()
    same = all(torch.equal(a, r) for a, r in zip(pools, refs))
    note("row7", "write_q 7b/tp2 b8 ps16 (bit-exact)", 0.0 if same else 1.0, 0.0)
    del pools, refs
    for name, layout, n_in, n_out in (("wq col half", "io", 4096, 2048),
                                      ("wo row half", "io", 2048, 4096),
                                      ("wg col half", "io", 4096, 5504),
                                      ("wd row half", "io", 5504, 4096),
                                      ("unembed vocab half", "vd", 4096, 16000)):
        q8, s = int8_weight(torch, g, layout, n_in, n_out)
        for r in (1, 8, 128):
            x = torch.randn((r, n_in), generator=g, device="cuda").to(torch.bfloat16)
            out = mm8.int8_matmul_cuda(x, q8, s, layout)
            ref = mm8.int8_matmul_plain(x, q8, s, layout)
            if layout == "vd":
                err = float((out.float() - ref.float()).abs().max()
                            / ref.float().abs().max())
                note("int8_matmul", f"int8 7b/tp2 {name} R={r} (rel)", err, INT8_LOGIT_TOL)
            else:
                note("int8_matmul", f"int8 7b/tp2 {name} R={r} (bf16 ulps)",
                     bf16_ulps(out, ref), 1.0)
    return worst


def pool_references(torch, engines, tok):
    """Phase 21's tp=1 side, in this process before the ranks load: (a) a
    lone mixed paged scheduler of the 7B bf16 tree with a replica's shape
    (pages of 64, POOL_SLOTS slots, POOL_KV_GB of KV), six SQL requests at
    once then two in turn; (b) a lone mixed scheduler of the tree's int8
    quantization over an int8 pool of POOL_B_PAGE-token pages, no
    pressure, (b)'s prompts at once. Returns the streams."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_params
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )

    e7 = fleet_model(engines["duckdb-nsql"], POOL_LAYERS)
    prompts_a = mesh_prompts(tok)
    ref = {"prompts_a": prompts_a, "prompts_b": pool_b_prompts(tok)}
    t0 = time.perf_counter()
    with ContinuousBatchingScheduler(
            e7.cfg, e7.params, num_slots=POOL_SLOTS, kv_layout="paged",
            kv_page_size=SCHED["kv_page_size"], kv_hbm_budget_bytes=POOL_KV_GB * 2**30,
            stop_ids=e7.stop_ids, device="cuda") as s:
        futs = [s.submit(p, max_new_tokens=MAX_NEW) for p in prompts_a[:6]]
        want = [f.result(timeout=300) for f in futs]
        want += [s.submit(p, max_new_tokens=MAX_NEW).result(timeout=300)
                 for p in prompts_a[6:]]
    ref["a"] = want
    print(f"  (a) tp=1 mixed paged scheduler: {sum(map(len, want))} tokens in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    q8 = quantize_params(e7.params)
    t0 = time.perf_counter()
    with ContinuousBatchingScheduler(
            e7.cfg, q8, num_slots=POOL_SLOTS, kv_layout="paged", kv_page_size=POOL_B_PAGE,
            kv_quant="int8", stop_ids=e7.stop_ids, device="cuda") as s:
        futs = [s.submit(p, max_new_tokens=MAX_NEW) for p in ref["prompts_b"]]
        ref["b"] = [f.result(timeout=300) for f in futs]
    print(f"  (b) tp=1 int8 scheduler over an int8 pool: {sum(map(len, ref['b']))} tokens "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return ref


def start_pool_followers(root, addr):
    """Phase 21's two follower processes (`--pool-rank 1`, `2`), world
    ranks 1 and 2 of the pool's group (this process is rank 0), their
    output in files under `root`."""
    procs = []
    for rank in (1, 2):
        env = dict(os.environ, LSOT_POOL_ROOT=root, LSOT_POOL_ADDR=addr)
        log = open(os.path.join(root, f"pool_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--pool-rank", str(rank)],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait_pool_followers(procs, root):
    """Wait for the followers; a failed or stuck one fails the phase with
    the tail of its log. Returns their JSON results."""
    deadline = time.time() + POOL_TIMEOUT_S
    for p, log in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
                q.wait()
        log.close()
    out = []
    for rank, (p, _) in zip((1, 2), procs):
        with open(os.path.join(root, f"pool_rank{rank}.log")) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith("  "):
                print(f"  [rank {rank}] {line.strip()}", flush=True)
        assert p.returncode == 0, f"pool rank {rank} failed ({p.returncode}):\n{text[-4000:]}"
        with open(os.path.join(root, f"pool_rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def pool_objects(pool, objects):
    """Record each replica object of `pool` (a rebuilt one too) by its
    replica index, and whether it is a rebuild; every one was built after
    the counts were reset."""
    for i, sc in enumerate(pool.schedulers):
        if id(sc) not in objects:
            rebuilt = any(j == i for j, _, _ in objects.values())
            objects[id(sc)] = (i, sc, rebuilt)


def pool_expected(objects, n):
    """The launches each of the `n` replicas' objects made (`expect_paged`;
    a rebuilt one's warmup, `expect_warmup`, too: its followers warm with
    it), by replica index."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import LAUNCHES

    out = [dict.fromkeys(LAUNCHES, 0) for _ in range(n)]
    for i, sc, rebuilt in objects.values():
        expect_paged(out[i], sc, sc.rounds_issued, sc.prefill_forwards)
        if rebuilt:
            expect_warmup(out[i], sc)
    return out


def pool_part_a(torch, engines, ref, tok, smi, bounds):
    """(a) on the pool's process: the phase-split pool of two tp=2 7B
    replicas, built by the entry point's `launch.join_pool` and
    `make_dp_pool_backend` over the 7B bf16 tree; six SQL requests at once,
    then two in turn, the second under `sched:handoff` (its prefill
    replica dies before the export and is rebuilt on its mesh). Returns
    (numbers, rank 0's launches, the expected launches by replica)."""
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.app.config import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.parallel import launch, spmd
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    e7 = fleet_model(engines["duckdb-nsql"], POOL_LAYERS)
    with pool_environ("a"):
        args, cfg = pool_args(("--kv-hbm-gb", str(POOL_KV_GB))), AppConfig.from_env()
        assert entry.is_tp_pool(args, cfg) and entry.mesh_ranks(args, cfg) == 3
        meshes, _ = launch.join_pool(2, 2, False, POOL_MODULE, [], local=[0, 1])
        assert all(m.staged and m.backend == "gloo" for m in meshes), meshes
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        backend = entry.make_dp_pool_backend(args, cfg, "phase21-a", tok, True, MAX_NEW,
                                             None, meshes=meshes, loaded=(e7.cfg, e7.params))
    built = round(time.perf_counter() - t0, 2)
    for m in meshes:
        spmd.drive(m)
    sup = backend.scheduler
    pool = sup._inner
    assert [s.phase_role for s in pool.schedulers] == ["prefill", "decode"]
    assert [s.mesh.ranks for s in pool.schedulers] == [[0, 1], [0, 2]]
    pages = pool.schedulers[0].page_stats["pages_total"]
    print(f"  (a) pool built in {built} s: {pages} pages of {SCHED['kv_page_size']} a "
          f"replica ({POOL_KV_GB} GiB on every head, half a rank); "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated here", flush=True)
    factory = pool._factory
    pool._factory = lambda i: (FAULTS.clear(), factory(i))[1]  # one crash episode
    objects = {}
    pool_objects(pool, objects)
    h0 = sup.health()
    prompts = ref["prompts_a"]
    t0 = time.perf_counter()
    outs, streams, split = timed_burst(
        lambda p, on: sup.submit(p, max_new_tokens=MAX_NEW, on_token=on), prompts[:6])
    burst_s = round(time.perf_counter() - t0, 3)
    for k, p in enumerate(prompts[6:]):
        if k == 1:
            FAULTS.configure("sched:handoff:1", 0)
        try:
            o, s, _ = timed_burst(
                lambda p, on: sup.submit(p, max_new_tokens=MAX_NEW, on_token=on), [p])
        finally:
            FAULTS.clear()
        outs += o
        streams += s
        pool_objects(pool, objects)
    seconds = round(time.perf_counter() - t0, 3)
    for sc in pool.schedulers:
        st = wait_idle(sc)
        assert st["pages_in_use"] == st["prefix_resident_pages"], st
    torch.cuda.synchronize()
    got = dict(LAUNCHES)
    expected = pool_expected(objects, 2)
    health = sup.health()
    objs = [sc for _, sc, _ in objects.values()]
    ho = {k: sum(getattr(sc, f"_ho_{k}") for sc in objs)
          for k in ("exports", "imports", "inplace", "backpressure")}
    direct = sum(sc._rid_seq - sc._ho_imports for sc in objs if sc.phase_role == "decode")
    reps = {r["replica"]: r for r in pool.replica_health()}
    exports = [r for sc in objs for r in sc.flight.snapshot()
               if r.get("kind") == "handoff_export"]
    print(f"  (a) {len(prompts)} requests in {seconds} s (six at once {burst_s} s); exports "
          f"{ho['exports']}, imports {ho['imports']}, in place {ho['inplace']}, prefilled by "
          f"r1 after the fault {direct}; replayed {health['replayed'] - h0['replayed']}, "
          f"lost {health['lost']}; replicas "
          f"{[(k, v['state'], v['restarts']) for k, v in reps.items()]}", flush=True)
    assert all(o is not None for o in outs), "(a): a request was lost"
    assert health["lost"] == 0 and health["restarts"] == 0, health
    assert ho["exports"] == ho["imports"] > 0, ho
    assert ho["imports"] + ho["inplace"] + direct == len(prompts), (ho, direct)
    assert reps["r0"]["restarts"] == 1 and reps["r1"]["restarts"] == 0, reps
    for i, (s, o) in enumerate(zip(streams, outs)):
        assert s[1:] == o[1:], f"(a)[{i}]: stream {s} != {o}"
    # Every blob holds every head: its bytes are its pages at the whole
    # model's page bytes, as a tp=1 replica's.
    from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import page_bytes

    pb = page_bytes(e7.cfg, SCHED["kv_page_size"], 2)
    assert exports and all(r["bytes"] == r["pages"] * pb for r in exports), exports[:2]
    div = fleet_compare(torch, "pool_tp2_split", e7.cfg, e7.params, e7.stop_ids, prompts,
                        outs, ref["a"], bounds)
    backend.shutdown()
    launch.finish(meshes, [])
    numbers = {
        "requests": len(prompts), "seconds": seconds, "burst_s": burst_s, "build_s": built,
        "pages_a_replica": pages, "exports": ho["exports"], "imports": ho["imports"],
        "inplace": ho["inplace"], "reprefilled": direct,
        "export_s_p50": p50([r["export_s"] for r in exports]),
        "blob_bytes": sorted({r["bytes"] for r in exports}),
        "blob_pages": sorted({r["pages"] for r in exports}),
        "handoff_gap_s_p50": split["second_token_gap_s_p50"], "split": split,
        "restarts": {k: v["restarts"] for k, v in reps.items()},
        "streams_equal": f"{len(prompts) - len(div)} of {len(prompts)}",
        "divergences": div}
    del backend, sup, pool, objects, objs
    gc.collect()
    torch.cuda.empty_cache()
    return numbers, got, expected


def pool_part_b(torch, engines, ref, tok, smi, bounds):
    """(b) on the pool's process: the same pool, mixed/mixed, `--int8`,
    `LSOT_KV_QUANT=int8`, `LSOT_KV_SPILL=1`, over an overcommitted pool of
    one max-length row whose pages `kv:pressure` withholds down to two
    admissions and a page (`pool_b_pages`); (b)'s prompts at once. Returns
    (numbers, rank 0's launches, the expected launches by replica)."""
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.app.config import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.parallel import launch, spmd
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    e7 = fleet_model(engines["duckdb-nsql"], POOL_LAYERS)
    pages, nbytes, withheld, admit = pool_b_pages(e7.cfg)
    with pool_environ("b"):
        args = pool_args(("--int8", "--kv-hbm-gb", repr((nbytes + 0.5) / 2**30)))
        cfg = AppConfig.from_env()
        assert cfg.kv_spill and cfg.kv_quant == "int8"
        meshes, _ = launch.join_pool(2, 2, False, POOL_MODULE, [], local=[0, 1])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        backend = entry.make_dp_pool_backend(args, cfg, "phase21-b", tok, True, MAX_NEW,
                                             "int8", meshes=meshes,
                                             loaded=(e7.cfg, e7.params))
    built = round(time.perf_counter() - t0, 2)
    for m in meshes:
        spmd.drive(m)
    sup = backend.scheduler
    pool = sup._inner
    assert [s.phase_role for s in pool.schedulers] == ["mixed", "mixed"]
    st0 = pool.schedulers[0].page_stats
    assert st0["pages_total"] == pages and st0["page_size"] == POOL_B_PAGE, st0
    print(f"  (b) pool built in {built} s: {pages} pages of {POOL_B_PAGE} a replica, "
          f"{withheld} withheld (an admission takes {admit})", flush=True)
    objects = {}
    pool_objects(pool, objects)
    FAULTS.configure(f"kv:pressure:1:{withheld}", 0)
    t0 = time.perf_counter()
    try:
        outs, streams, timing_b = timed_burst(
            lambda p, on: sup.submit(p, max_new_tokens=MAX_NEW, on_token=on),
            ref["prompts_b"])
    finally:
        FAULTS.clear()
    seconds = round(time.perf_counter() - t0, 3)
    stats = [wait_idle(sc) for sc in pool.schedulers]
    torch.cuda.synchronize()
    got = dict(LAUNCHES)
    expected = pool_expected(objects, 2)
    spilled = sum(s["spilled_pages"] for s in stats)
    restored = sum(s["restored_pages"] for s in stats)
    preempt = sum(s["preemptions"] for s in stats)
    health = sup.health()
    print(f"  (b) {len(outs)} requests in {seconds} s: preemptions {preempt}, spilled "
          f"{spilled} pages, restored {restored}, page waits "
          f"{sum(s['page_waits'] for s in stats)}; lost {health['lost']}", flush=True)
    assert all(o is not None for o in outs) and health["lost"] == 0, health
    assert preempt >= 1 and spilled == restored > 0, stats
    for i, (s, o) in enumerate(zip(streams, outs)):
        assert s == o, f"(b)[{i}]: stream {s} != {o}"
    backend.shutdown()
    launch.finish(meshes, [])
    del backend, sup, pool, objects
    gc.collect()
    torch.cuda.empty_cache()
    # The near-tie rule over the tree's int8 quantization, made again now
    # that the ranks' memory is free.
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_params

    q8 = quantize_params(e7.params)
    div = fleet_compare(torch, "pool_tp2_int8_spill", e7.cfg, q8, e7.stop_ids,
                        ref["prompts_b"], outs, ref["b"], bounds, kv_quant="int8")
    del q8
    numbers = {"requests": len(outs), "seconds": seconds, "build_s": built,
               "pages_a_replica": pages, "withheld": withheld, "preemptions": preempt,
               "spilled_pages": spilled, "restored_pages": restored, "timing": timing_b,
               "streams_equal": f"{len(outs) - len(div)} of {len(outs)}",
               "divergences": div}
    gc.collect()
    torch.cuda.empty_cache()
    return numbers, got, expected


def pool_rank(rank) -> int:
    """A follower of phase 21 (a process `pool_mesh_serve` starts): world
    rank `rank`, on replica rank-1's tp=2 mesh in both parts. It builds its
    replica's twin through the entry point's `make_dp_pool_backend` (its
    block of the 7B tree for (a); the whole tree's int8 quantization,
    made one follower at a time, for (b)), follows rank 0's steps until it
    closes the mesh, and writes each part's launch counts to
    LSOT_POOL_ROOT/pool_rank{rank}.json."""
    import faulthandler

    faulthandler.dump_traceback_later(POOL_TIMEOUT_S - 30, exit=True)
    import torch

    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.app.config import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.launches import (
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_params
    from llm_based_apache_spark_optimization_tpu_torch.parallel import (
        init_distributed,
        launch,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.environ["LSOT_POOL_ROOT"]
    assert init_distributed(os.environ["LSOT_POOL_ADDR"], 3, rank)
    tok = ByteTokenizer()
    out = {"launches": {}}
    for part in ("a", "b"):
        with pool_environ(part):
            extra = ("--kv-hbm-gb", str(POOL_KV_GB)) if part == "a" else ()
            args, cfg = pool_args(extra), AppConfig.from_env()
            meshes, _ = launch.join_pool(2, 2, False, POOL_MODULE, [], local=[0, 1])
            mine = [m for m in meshes if m is not None]
            assert len(mine) == 1 and mine[0].rank == 1 and meshes[rank - 1] is mine[0]
            print(f"  part ({part}): {mine[0].describe()}", flush=True)
            gen = torch.Generator(device="cuda").manual_seed(0)
            if part == "a":
                with torch.inference_mode():
                    cfg7, params = depth_cut(DUCKDB_NSQL_7B, init_params(
                        DUCKDB_NSQL_7B, gen, torch.bfloat16, mesh=mine[0]), POOL_LAYERS,
                        clone=True)
                torch.cuda.empty_cache()  # the whole weights made on the way
            else:
                # The block of the whole tree's quantization: made whole on the
                # card, one follower after the other, and kept on the host.
                turn = os.path.join(root, f"pool_b_loaded{rank - 1}")
                while rank == 2 and not os.path.exists(turn):
                    time.sleep(0.2)
                with torch.inference_mode():
                    cfg7, cut = depth_cut(DUCKDB_NSQL_7B, init_params(
                        DUCKDB_NSQL_7B, gen, torch.bfloat16, device="cuda"), POOL_LAYERS)
                    q8 = quantize_params(cut)
                    params = tree_to(q8, "cpu")
                del cut
                del q8
                torch.cuda.empty_cache()
                open(os.path.join(root, f"pool_b_loaded{rank}"), "w").close()
                args.int8 = False  # the tree is quantized already
            torch.cuda.synchronize()
            reset_launches()
            backend = entry.make_dp_pool_backend(
                args, cfg, f"phase21-{part}", tok, True, MAX_NEW,
                "int8" if part == "b" else None, meshes=meshes,
                loaded=(cfg7, params))
            del params
            launch.follow(*mine)
            torch.cuda.synchronize()
            out["launches"][part] = _launch_snapshot()
            print(f"  part ({part}): followed rank 0 to the end; launches "
                  f"{out['launches'][part]}", flush=True)
            del backend
            gc.collect()
            torch.cuda.empty_cache()
    with open(os.path.join(root, f"pool_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def native_python(root) -> int:
    """(c)'s Python side, a process beside the mesh parts: writes a CSV of
    NATIVE_ROWS rows x 8 mixed columns (seed 0), runs the Python schema
    pass over it, trains the BPE (NATIVE_MERGES merges on the app's
    prompts), picks NATIVE_BYTES of prompts (seed 0) and encodes them with
    the Python merge loop; writes the results and times to
    `root`/native_python.json, the tokenizer to `root`/bpe.json and the
    texts to `root`/texts.json."""
    import csv
    import hashlib
    import random

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_based_apache_spark_optimization_tpu_torch.sql.sqlite_backend import (
        _infer_dtype,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer.bpe import train_bpe

    os.environ["LSOT_NO_NATIVE"] = "1"  # this process is the Python side
    rng = random.Random(0)
    path = os.path.join(root, "trips.csv")
    t0 = time.perf_counter()
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["VendorID", "passenger_count", "trip_distance", "payment_type",
                    "pickup_datetime", "store_and_fwd_flag", "trip_id", "note"])
        for i in range(NATIVE_ROWS):
            w.writerow([rng.randint(1, 2), rng.randint(0, 6), f"{rng.uniform(0, 30):.2f}",
                        rng.choice(["1", "2", "3", "4"]),
                        f"2024-01-{rng.randint(1, 28):02d} {rng.randint(0, 23):02d}:"
                        f"{rng.randint(0, 59):02d}:{rng.randint(0, 59):02d}",
                        rng.choice(["Y", "N"]), 3_000_000_000 + i,
                        "" if rng.random() < 0.1 else rng.choice(["ok", "late", "a, b"])])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    dtypes = [_infer_dtype([r[i] if i < len(r) else "" for r in rows])
              for i in range(len(header))]
    csv_s = time.perf_counter() - t0
    prompts = ([f"{SYSTEM_SQL}\n\n{q}" for q in SCHED_SQL] + list(APP_QUESTIONS)
               + [ERROR_PROMPT])
    t0 = time.perf_counter()
    bpe = train_bpe(prompts * 2, num_merges=NATIVE_MERGES)
    train_s = time.perf_counter() - t0
    bpe.save(os.path.join(root, "bpe.json"))
    texts, n = [], 0
    while n < NATIVE_BYTES:
        texts.append(rng.choice(prompts))
        n += len(texts[-1].encode())
    with open(os.path.join(root, "texts.json"), "w") as f:
        json.dump(texts, f)
    t0 = time.perf_counter()
    ids = [bpe.encode(t, add_bos=False) for t in texts]
    bpe_s = time.perf_counter() - t0
    digest = hashlib.sha256(json.dumps(ids).encode()).hexdigest()
    with open(os.path.join(root, "native_python.json"), "w") as f:
        json.dump({"csv": {"path": path, "dtypes": dtypes, "rows": len(rows),
                           "bytes": os.path.getsize(path), "write_s": round(write_s, 3),
                           "python_s": round(csv_s, 4)},
                   "bpe": {"merges": len(bpe.merges), "texts": len(texts), "bytes": n,
                           "ids": sum(map(len, ids)), "digest": digest,
                           "train_s": round(train_s, 3), "python_s": round(bpe_s, 4)}}, f)
    return 0


def native_serve(root, bg, smi):
    """(c): the C++ scanner over the CSV and the C++ encoder over the texts
    `native_python` wrote, in this process, against its Python results:
    the dtypes and the row count equal, the ids equal (their digest), and
    `SQLiteBackend.load_csv` takes the scanner's dtypes. Returns the
    numbers."""
    import hashlib

    from llm_based_apache_spark_optimization_tpu_torch import native
    from llm_based_apache_spark_optimization_tpu_torch.sql.sqlite_backend import (
        SQLiteBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer.bpe import BPETokenizer

    rc, out, err, seconds = bg.wait(POOL_TIMEOUT_S)
    assert rc == 0, f"(c) the Python side failed ({rc}): {err}"
    with open(os.path.join(root, "native_python.json")) as f:
        py = json.load(f)
    t0 = time.perf_counter()
    lib = native.load_text()
    build_s = time.perf_counter() - t0
    assert lib is not None and not native.native_disabled()
    t0 = time.perf_counter()
    scanned = native.csv_scan(py["csv"]["path"])
    scan_s = time.perf_counter() - t0
    assert scanned is not None, "(c) the scanner refused the CSV"
    assert scanned == (py["csv"]["dtypes"], py["csv"]["rows"]), (scanned, py["csv"])
    calls = []
    real = native.csv_scan
    native.csv_scan = lambda p, *a: calls.append(p) or real(p, *a)
    try:
        schema = SQLiteBackend().load_csv(py["csv"]["path"])
    finally:
        native.csv_scan = real
    assert calls and list(schema.dtypes) == py["csv"]["dtypes"], schema
    bpe = BPETokenizer.load(os.path.join(root, "bpe.json"))
    assert bpe._native is not None
    with open(os.path.join(root, "texts.json")) as f:
        texts = json.load(f)
    t0 = time.perf_counter()
    ids = [bpe.encode(t, add_bos=False) for t in texts]
    bpe_s = time.perf_counter() - t0
    digest = hashlib.sha256(json.dumps(ids).encode()).hexdigest()
    assert digest == py["bpe"]["digest"] and sum(map(len, ids)) == py["bpe"]["ids"], \
        "(c) the C++ encoder's ids differ from the Python loop's"
    numbers = {"csv": {"rows": py["csv"]["rows"], "bytes": py["csv"]["bytes"],
                       "dtypes": py["csv"]["dtypes"], "cpp_s": round(scan_s, 4),
                       "python_s": py["csv"]["python_s"]},
               "bpe": {"merges": py["bpe"]["merges"], "bytes": py["bpe"]["bytes"],
                       "ids": py["bpe"]["ids"], "cpp_s": round(bpe_s, 4),
                       "python_s": py["bpe"]["python_s"]},
               "library_load_s": round(build_s, 3), "python_side_s": seconds}
    print(f"  (c) CSV of {py['csv']['rows']} rows x 8 ({py['csv']['bytes']} bytes): C++ scan "
          f"{scan_s:.4f} s, Python pass {py['csv']['python_s']} s, dtypes equal; BPE of "
          f"{py['bpe']['merges']} merges over {py['bpe']['bytes']} bytes: C++ {bpe_s:.4f} s, "
          f"Python loop {py['bpe']['python_s']} s, ids equal ({py['bpe']['ids']}); host of "
          f"{smi}", flush=True)
    return numbers


def pool_mesh_serve(torch, engines, smi):
    """Phase 21: a replica pool of two tp=2 DUCKDB_NSQL_7B replicas (full
    width, 16 heads a rank), every rank on cuda:0 over gloo
    (LSOT_MESH_DEVICES), so each collective stages through host memory:
    this process is the pool's, world rank 0 and rank 0 of both replicas'
    meshes; two follower processes (`pool_rank`) hold the other halves.
    (c)'s Python side runs in a process beside it (`native_python`). First
    the kernels at the per-rank shapes and the tp=1 references, freed
    before the ranks load; then (a) and (b) (`pool_part_a`,
    `pool_part_b`), whose launches are held on every rank: each follower's
    equal its replica's objects' expected count, rank 0's their sum; then
    (c). Returns (launches by path, numbers)."""
    import shutil
    import socket
    import tempfile

    import torch.distributed as dist

    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int8mm as mm8
    from llm_based_apache_spark_optimization_tpu_torch.parallel import (
        init_distributed,
        multihost,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="lsot-pool-")
    bg = Background([sys.executable, os.path.abspath(__file__), "--native-python", root],
                    "native")
    try:
        numbers = {"device": smi, "kernels_per_rank": pool_kernel_checks(torch, mm8)}
        tok = ByteTokenizer()
        ref = pool_references(torch, engines, tok)
        gc.collect()
        torch.cuda.empty_cache()  # the followers need what the references freed
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{s.getsockname()[1]}"
        procs = start_pool_followers(root, addr)
        bounds = {}
        try:
            t0 = time.perf_counter()
            assert init_distributed(addr, 3, 0)
            numbers["a"], got_a, want_a = pool_part_a(torch, engines, ref, tok, smi, bounds)
            numbers["b"], got_b, want_b = pool_part_b(torch, engines, ref, tok, smi,
                                                      bounds)
            dist.barrier()  # the followers wrote their counts and end after it
            followers = wait_pool_followers(procs, root)
            numbers["ranks_s"] = round(time.perf_counter() - t0, 1)
        finally:
            for p, _ in procs:  # stop a follower left running by a failure here
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if dist.is_initialized():
                dist.destroy_process_group()
            multihost._initialized = False
        gc.collect()
        torch.cuda.empty_cache()
        launches = {}
        for part, got, want in (("a", got_a, want_a), ("b", got_b, want_b)):
            label = "pool_tp2_split" if part == "a" else "pool_tp2_int8_spill"
            total = {k: want[0][k] + want[1][k] for k in want[0]}
            assert got == total, f"({part}) rank 0: launches {got} != {total}"
            launches[f"{label}_rank0"] = got
            for rank, f in zip((1, 2), followers):
                counts = f["launches"][part]
                assert counts == want[rank - 1], \
                    f"({part}) rank {rank}: launches {counts} != {want[rank - 1]}"
                launches[f"{label}_rank{rank}"] = counts
            print(f"  ({part}) launches: rank 0 {got} = replica 0's + replica 1's; each "
                  f"follower its replica's", flush=True)
        numbers["c"] = native_serve(root, bg, smi)
        numbers["seconds"] = round(time.perf_counter() - t_phase, 1)
        print(f"  phase 21: {json.dumps(numbers)}", flush=True)
        return launches, numbers
    finally:
        bg.kill()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------- phase 22: sequence parallelism past the contiguous cache

SP_LAYERS = 8           # the 7B's depth in phase 22 (widths whole: 32 heads and KV heads a rank)
SP_DEVICES = "cuda:0,cuda:0"  # LSOT_MESH_DEVICES: both sp ranks on one card
SP_TIMEOUT_S = 480      # a follower that has not finished by then is stuck
SP_MAX_SEQ = 1024       # (b), (c): the schedulers' context (a prompt and MAX_NEW fit)
SP_SLOTS = 8            # (b): slots a scheduler
SP_C_SLOTS = 4          # (c): the scheduler rank 0 builds alone
SP_BURST = 6            # (b), (c): SQL requests at once, each past the prompt bucket
SP_MODULE = f"{PKG}.app"
# Rows of PERF.md's table checked at an sp rank's shapes (`sp_kernel_checks`).
SP_ROWS = {"paged": "row4", "paged_q": "row5", "write": "row6", "write_q": "row7"}


def sp_args(*extra):
    """(a)'s entry point flags: `--sp 2 --no-scheduler --kv-layout paged`."""
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry

    return entry.build_parser().parse_args(
        ["--backend", "checkpoint", "--sql-model-path", "phase22-seed-tree", "--sp", "2",
         "--no-scheduler", "--kv-layout", "paged", "--max-new-tokens", str(MAX_NEW),
         *extra])


def sp_engine_backend(args, tok, loaded, mesh=None):
    """The entry point's engine backend for `args`, as its checkpoint branch
    builds it once the tree is loaded (`EngineBackend.from_hf_checkpoint`
    hands `_from_checkpoint` a loader; here the loader returns `loaded`),
    on `mesh` or, without one, on the card alone."""
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.app.config import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.serve import EngineBackend

    kv_quant, _ = entry.resolve_kv_quant(args, AppConfig())
    return EngineBackend._from_checkpoint(
        lambda dtype, device: loaded, tok, max_new_tokens=args.max_new_tokens,
        add_bos=True, kv_quant=kv_quant, quantize_int8=args.int8,
        quantize_int4=args.int4, quantize_unembed8=args.int8_unembed,
        speculative_draft=args.speculative, kv_layout=args.kv_layout, mesh=mesh,
        device="cuda" if mesh is None else None)


class sp_pools:
    """Record the shape of every page pool the engine packs its prefill
    into (`engine.generate.pack_prefill_pages`) while the block runs."""

    def __enter__(self):
        from llm_based_apache_spark_optimization_tpu_torch.engine import generate as gen_mod

        self.mod, self.real, self.shapes = gen_mod, gen_mod.pack_prefill_pages, []

        def pack(*a, **kw):
            out = self.real(*a, **kw)
            self.shapes.append(list(out["kp"].shape))
            return out

        gen_mod.pack_prefill_pages = pack
        return self

    def __exit__(self, *exc):
        self.mod.pack_prefill_pages = self.real


def sp_kernel_checks(torch):
    """Rows 4-7 of PERF.md's table at an sp rank's shapes, against their
    plain versions: the pool whole on the rank and every head of the 7B
    (32 query and 32 KV heads, pages of 64): the paged decode over a bf16
    and an int8 pool (rows 4, 5) and the page write into each, bit for bit
    (rows 6, 7). Returns the worst error by row."""
    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        paged_attention as pa_mod,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        paged_write as pw_mod,
    )

    tol = TOL["bfloat16"]
    worst = {}

    def note(row, label, err, limit):
        print(f"  {row:6s} {label:34s} err={err:.3e} tol={limit:.0e} "
              f"{'ok' if err <= limit else 'FAIL'}", flush=True)
        assert err <= limit, f"{row}/{label}: {err} > {limit}"
        worst[row] = max(worst.get(row, 0.0), err)

    ps, kh = SCHED["kv_page_size"], DUCKDB_NSQL_7B.num_kv_heads
    assert kh == DUCKDB_NSQL_7B.num_heads  # the 7B is MHA: every head a rank
    rows = [(p, 1, p + 1) for p in (383, 390, 399, 412, 415, 64, 5, 1023)]
    q, kp, vp, tab, pos, window, kvl, qln = paged_case(
        torch, torch.bfloat16, b=8, t=1, n=kh, kh=kh, h=128, ps=ps, np_tab=16, rows=rows)
    args = (q, kp, vp, tab, pos, window, kvl, qln)
    out = pa_mod.ragged_paged_attention_cuda(*args)
    ref = pa_mod.ragged_paged_attention_plain(*args)
    note("row4", "paged decode 7b/sp2 b8 ps64", (out.float() - ref.float()).abs().max().item(),
         tol)
    kp8, kps = quantize(torch, kp)
    vp8, vps = quantize(torch, vp)
    args = (q, kp8, kps, vp8, vps, tab, pos, window, kvl, qln)
    out = pa_mod.ragged_paged_attention_quantized_cuda(*args)
    ref = pa_mod.ragged_paged_attention_quantized_plain(*args)
    note("row5", "paged_q decode 7b/sp2 b8 ps64",
         (out.float() - ref.float()).abs().max().item(), tol)
    del q, kp, vp, kp8, vp8, kps, vps
    g = torch.Generator(device="cuda").manual_seed(22)
    shape = (2, 136, kh, ps, 128)
    for row, quant in (("row6", False), ("row7", True)):
        if quant:
            pools = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                                   dtype=torch.int8),
                     torch.rand(shape[:4], generator=g, device="cuda"),
                     torch.randint(-127, 128, shape, generator=g, device="cuda",
                                   dtype=torch.int8),
                     torch.rand(shape[:4], generator=g, device="cuda")]
        else:
            pools = [torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
                     for _ in range(2)]
        refs = [x.clone() for x in pools]
        k_new, v_new, wpos, wtab, q_lens = write_case(torch, "7b_sp2_t1_b8", kh, 128, ps,
                                                       8, 1, 16, 136, torch.bfloat16, g)
        if quant:
            pw_mod.fused_page_write_quantized_cuda(*pools, k_new, v_new, wpos, wtab, 1,
                                                   q_lens)
            pw_mod.fused_page_write_quantized_plain(*refs, k_new, v_new, wpos, wtab, 1,
                                                    q_lens)
        else:
            pw_mod.fused_page_write_cuda(*pools, k_new, v_new, wpos, wtab, 1, q_lens)
            pw_mod.fused_page_write_plain(*refs, k_new, v_new, wpos, wtab, 1, q_lens)
        torch.cuda.synchronize()
        same = all(torch.equal(a, r) for a, r in zip(pools, refs))
        note(row, f"{'write_q' if quant else 'write'} 7b/sp2 b8 ps64 (bit-exact)",
             0.0 if same else 1.0, 0.0)
        del pools, refs
    return worst


def sp_sql_texts():
    """(a)'s three NL->SQL requests (355-368 prompt bytes each)."""
    return [f"{SYSTEM_SQL}\n\n{q}" for q in QUESTIONS]


def sp_sched_kw(stop_ids, layout, slots=SP_SLOTS):
    return dict(num_slots=slots, max_seq=SP_MAX_SEQ, kv_layout=layout,
                kv_page_size=SCHED["kv_page_size"], stop_ids=stop_ids)


def sp_references(torch, engines, tok):
    """Phase 22's sp = 1 side, in this process before the follower loads,
    from the same seed-0 tree cut to SP_LAYERS: (a) the entry point's paged
    engine backend on the card alone, bf16 and int8 KV, the three requests
    in turn; (b) a lone contiguous and a lone paged scheduler, SP_SLOTS
    slots, the SP_BURST prompts at once; (c) a fresh paged scheduler of
    SP_C_SLOTS slots, the same burst. Returns the token streams."""
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )

    e7 = fleet_model(engines["duckdb-nsql"], SP_LAYERS)
    rec = recording_tokenizer()
    ref = {"prompts": mesh_prompts(tok)[:SP_BURST], "a": {}}
    t0 = time.perf_counter()
    for kvq, extra in (("bf16", ()), ("int8", ("--kv-int8",))):
        backend = sp_engine_backend(sp_args(*extra), rec, (e7.cfg, e7.params))
        ref["a"][kvq] = []
        for text in sp_sql_texts():
            backend.complete(text)
            ref["a"][kvq].append((rec.local.prompt, rec.local.out))
        del backend
    print(f"  (a) sp=1 paged engine backends: 2 x {len(QUESTIONS)} requests in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for label, layout, slots in (("b_contiguous", "contiguous", SP_SLOTS),
                                 ("b_paged", "paged", SP_SLOTS),
                                 ("c", "paged", SP_C_SLOTS)):
        t0 = time.perf_counter()
        with ContinuousBatchingScheduler(
                e7.cfg, e7.params, device="cuda",
                **sp_sched_kw(e7.stop_ids, layout, slots)) as s:
            futs = [s.submit(p, max_new_tokens=MAX_NEW) for p in ref["prompts"]]
            ref[label] = [f.result(timeout=300) for f in futs]
        print(f"  ({label}) sp=1 {layout} scheduler, {slots} slots: "
              f"{sum(map(len, ref[label]))} tokens in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return ref


def sp_expected_engine(launches, backend):
    """Add the paged engine's last generate to `launches`: a page write and
    a ragged paged attention (int8 pool: the quantized pair) a layer for
    each decode step; the ring prefill launches nothing."""
    eng = backend.engine
    q = "_quantized" if eng.kv_quant else ""
    n = eng.cfg.num_layers * eng.last_stats["decode_steps"]
    launches["ragged_paged_attention" + q] += n
    launches["fused_page_write" + q] += n


def sp_part_a(torch, params, cfg):
    """(a) on either rank: the mesh the entry point forms for its flags,
    the engine backends for bf16 and int8 KV built in turn on it (their
    pools whole on each sp rank); rank 0 drives the three requests through
    each and returns the streams, the pools' shapes and the launches."""
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.app.config import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.parallel import launch, spmd

    args = sp_args()
    assert entry.mesh_ranks(args, AppConfig()) == 2
    try:
        entry.mesh_ranks(sp_args("--scheduler"), AppConfig())
        raise AssertionError("--scheduler with --sp 2 did not exit")
    except SystemExit as exc:
        assert "no sp axis" in str(exc), exc
    mesh, _ = launch.join(args.dp, args.sp, args.tp, args.cpu, SP_MODULE, [])
    assert mesh.shape == {"dp": 1, "sp": 2, "tp": 1} and mesh.staged, mesh
    rec = recording_tokenizer()
    backends = {kvq: sp_engine_backend(sp_args(*extra), rec, (cfg, params), mesh)
                for kvq, extra in (("bf16", ()), ("int8", ("--kv-int8",)))}
    assert all(b.engine.kv_layout == "paged" for b in backends.values())
    out = {"streams": {}, "pools": [], "prompt_lens": [],
           "expected": dict.fromkeys(LAUNCHES, 0)}
    torch.cuda.synchronize()
    reset_launches()
    with sp_pools() as pools:
        if mesh.is_primary:
            spmd.drive(mesh)
            t0 = time.perf_counter()
            for kvq, backend in backends.items():
                out["streams"][kvq] = []
                for text in sp_sql_texts():
                    backend.complete(text)
                    out["streams"][kvq].append((rec.local.prompt, rec.local.out))
                    out["prompt_lens"].append(backend.engine.last_stats["prompt_len"])
                    sp_expected_engine(out["expected"], backend)
            out["seconds"] = round(time.perf_counter() - t0, 2)
            launch.finish(mesh, [])
        else:
            launch.follow(mesh)
        torch.cuda.synchronize()
    out["launches"] = dict(LAUNCHES)
    out["pools"] = pools.shapes
    out["mesh"] = mesh.describe()
    del backends
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_part_bc(torch, params, cfg, stop_ids, prompts):
    """(b) and (c) on either rank, on one sp = 2 mesh: the tree placed on
    it (`shard_params`), then a contiguous and a paged scheduler built on
    both ranks and started. Rank 0 drives: SP_BURST prompts at once through
    each, then (c): a paged scheduler of SP_C_SLOTS slots built on rank 0
    alone, with no twin (the follower builds it from the posted message
    over its placed tree), the same burst. A follower waits for rank 0 to
    shut each down and reports what its mesh still keeps."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.parallel import (
        launch,
        shard_params,
        spmd,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )

    mesh, _ = launch.join(1, 2, 1, False, SP_MODULE, [])
    local = shard_params(params, cfg, mesh)
    assert mesh.tree_index(local) == 0
    torch.cuda.synchronize()
    reset_launches()
    scheds = {layout: ContinuousBatchingScheduler(
        cfg, local, mesh=mesh, **sp_sched_kw(stop_ids, layout)).start()
        for layout in ("contiguous", "paged")}
    # The paged pool: every page and every KV head on each rank.
    out = {"expected": dict.fromkeys(LAUNCHES, 0),
           "pool": list(scheds["paged"]._pool["kp"].shape)}
    if not mesh.is_primary:
        for layout in ("contiguous", "paged"):
            scheds.pop(layout).shutdown()  # returns once rank 0 has shut it down
        out["kept"] = len(mesh._kept)
        launch.follow(mesh)
        torch.cuda.synchronize()
        out["launches"] = dict(LAUNCHES)
        return out
    spmd.drive(mesh)
    for label, layout in (("b_contiguous", "contiguous"), ("b_paged", "paged"), ("c", "paged")):
        if label == "c":
            t0 = time.perf_counter()
            sc = ContinuousBatchingScheduler(
                cfg, local, mesh=mesh,
                **sp_sched_kw(stop_ids, layout, SP_C_SLOTS)).start()
            out["c_build_s"] = round(time.perf_counter() - t0, 2)
            assert sc._mesh_id == 2 and len(mesh._recipes) == 3
        else:
            sc = scheds[layout]
        t0 = time.perf_counter()
        outs, streams, timing_ = timed_burst(
            lambda p, on, sc=sc: sc.submit(p, max_new_tokens=MAX_NEW, on_token=on), prompts)
        assert all(o is not None for o in outs), f"({label}): a request was lost"
        for i, (s, o) in enumerate(zip(streams, outs)):
            assert s == o, f"({label})[{i}]: stream {s} != {o}"
        if sc._paged:
            st = wait_idle(sc)
            assert st["pages_in_use"] == st["prefix_resident_pages"], (label, st)
            out[f"{label}_pages"] = st["pages_total"]
        (expect_paged if sc._paged else expect_contiguous)(
            out["expected"], sc, sc.rounds_issued, sc.prefill_forwards)
        out[label] = {"streams": outs, "seconds": round(time.perf_counter() - t0, 2),
                      "timing": timing_}
        if label != "b_paged":  # the paged one stays up while (c) runs
            sc.shutdown()
    scheds["paged"].shutdown()
    launch.finish(mesh, [])
    torch.cuda.synchronize()
    out["launches"] = dict(LAUNCHES)
    return out


def sp_rank(rank) -> int:
    """Phase 22's follower (a process `sp_serve` starts): world rank 1 of
    both sp = 2 meshes. It makes the 7B tree from seed 0 on the card, cut
    to SP_LAYERS, runs (a) and (b)-(c) beside rank 0 (`sp_part_a`,
    `sp_part_bc`) and writes its launch counts, pools and holdings to
    LSOT_SP_ROOT/sp_rank1.json."""
    import faulthandler

    faulthandler.dump_traceback_later(SP_TIMEOUT_S - 30, exit=True)
    import torch

    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.parallel import init_distributed
    from llm_based_apache_spark_optimization_tpu_torch.serve import resolve_stop_ids
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.environ["LSOT_SP_ROOT"]
    assert init_distributed(os.environ["LSOT_SP_ADDR"], 2, rank)
    with torch.inference_mode():
        cfg, params = depth_cut(DUCKDB_NSQL_7B, init_params(
            DUCKDB_NSQL_7B, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
            device="cuda"), SP_LAYERS, clone=True)
    torch.cuda.empty_cache()  # the whole weights made on the way
    stop_ids = resolve_stop_ids(DUCKDB_NSQL_7B, ByteTokenizer())
    a = sp_part_a(torch, params, cfg)
    print(f"  (a) rank {rank}: followed; pools {a['pools']}; launches "
          f"{ {k: v for k, v in a['launches'].items() if v} }", flush=True)
    bc = sp_part_bc(torch, params, cfg, stop_ids, None)
    print(f"  (b), (c) rank {rank}: followed; kept {bc['kept']}; launches "
          f"{ {k: v for k, v in bc['launches'].items() if v} }", flush=True)
    with open(os.path.join(root, f"sp_rank{rank}.json"), "w") as f:
        json.dump({"a": {"launches": a["launches"], "pools": a["pools"]},
                   "bc": {"launches": bc["launches"], "kept": bc["kept"],
                          "pool": bc["pool"]}}, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def sp_serve(torch, engines, smi):
    """Phase 22: sequence parallelism past the engine's contiguous cache
    (ROADMAP A13.1) and a scheduler built on a running mesh (A13.3) on the
    7B (DUCKDB_NSQL_7B at full width, SP_LAYERS deep), over sp = 2 meshes
    of two ranks on cuda:0 (gloo, staged through host memory): this
    process is rank 0, one follower process (`sp_rank`) rank 1. First rows
    4-7 at an sp rank's shapes (`sp_kernel_checks`) and the sp = 1
    controls (`sp_references`); then (a) the entry point's `--sp 2
    --no-scheduler --kv-layout paged` engine backends, bf16 and `--kv-int8`
    (`sp_part_a`), then (b) and (c) (`sp_part_bc`). Checks: every stream
    equals its control's or leaves it at a near-tie (`fleet_compare`);
    each rank's pool holds every page and every head, the same shape on
    both; no page leaks; the follower keeps nothing once rank 0 shut (c)'s
    scheduler down; each part's launches equal on both ranks and equal the
    count the engines' steps and the schedulers' rounds give. Returns
    (launches by path, numbers)."""
    import shutil
    import socket
    import tempfile

    import torch.distributed as dist

    from llm_based_apache_spark_optimization_tpu_torch.parallel import (
        init_distributed,
        multihost,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="lsot-sp-")
    old_devices = os.environ.get("LSOT_MESH_DEVICES")
    try:
        numbers = {"device": smi, "layers": SP_LAYERS,
                   "kernels_per_rank": sp_kernel_checks(torch)}
        tok = ByteTokenizer()
        ref = sp_references(torch, engines, tok)
        e7 = fleet_model(engines["duckdb-nsql"], SP_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{s.getsockname()[1]}"
        os.environ["LSOT_MESH_DEVICES"] = SP_DEVICES
        log = open(os.path.join(root, "sp_rank1.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sp-rank", "1"],
            env=dict(os.environ, LSOT_SP_ROOT=root, LSOT_SP_ADDR=addr),
            stdout=log, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            assert init_distributed(addr, 2, 0)
            a = sp_part_a(torch, e7.params, e7.cfg)
            bc = sp_part_bc(torch, e7.params, e7.cfg, e7.stop_ids, ref["prompts"])
            dist.barrier()  # the follower wrote its counts and ends after it
            try:
                proc.wait(timeout=SP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
            with open(os.path.join(root, "sp_rank1.log")) as f:
                text = f.read()
            for line in text.splitlines():
                if line.startswith("  "):
                    print(f"  [rank 1] {line.strip()}", flush=True)
            assert proc.returncode == 0, f"sp rank 1 failed ({proc.returncode}):\n{text[-4000:]}"
            with open(os.path.join(root, "sp_rank1.json")) as f:
                r1 = json.load(f)
            numbers["ranks_s"] = round(time.perf_counter() - t0, 1)
        finally:
            if proc.poll() is None:  # stop the follower left running by a failure here
                proc.kill()
                proc.wait()
            if dist.is_initialized():
                dist.destroy_process_group()
            multihost._initialized = False
        bounds, div = {}, []
        # (a): the streams against the sp = 1 engine backends'; the pools,
        # one a request: every page (the prompt's bucket and the decode cap)
        # and every head, on both ranks.
        from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import bucket_len

        cap = bucket_len(MAX_NEW, 64)
        ps = SCHED["kv_page_size"]
        want_pools = [[SP_LAYERS, -(-(t + cap) // ps), e7.cfg.num_kv_heads, ps,
                       e7.cfg.head_dim] for t in a["prompt_lens"]]
        for kvq in ("bf16", "int8"):
            got, want = a["streams"][kvq], ref["a"][kvq]
            assert [p for p, _ in got] == [p for p, _ in want]
            div += fleet_compare(torch, f"sp2_engine_paged_{kvq}", e7.cfg, e7.params,
                                 e7.stop_ids, [p for p, _ in want], [o for _, o in got],
                                 [o for _, o in want], bounds,
                                 kv_quant=None if kvq == "bf16" else "int8")
        assert a["pools"] == r1["a"]["pools"] == want_pools, \
            (a["pools"], r1["a"]["pools"], want_pools)
        # (b), (c): the streams against the sp = 1 schedulers'.
        for label in ("b_contiguous", "b_paged", "c"):
            div += fleet_compare(torch, f"sp2_sched_{label}", e7.cfg, e7.params,
                                 e7.stop_ids, ref["prompts"], bc[label]["streams"],
                                 ref[label], bounds)
        assert r1["bc"]["kept"] == 0, r1["bc"]
        assert bc["pool"] == r1["bc"]["pool"] == [
            SP_LAYERS, bc["b_paged_pages"], e7.cfg.num_kv_heads, ps, e7.cfg.head_dim], \
            (bc["pool"], r1["bc"]["pool"])
        launches = {}
        for part, mine, follower in (("sp2_engine_paged", a, r1["a"]),
                                     ("sp2_schedulers", bc, r1["bc"])):
            assert mine["launches"] == follower["launches"] == mine["expected"], \
                (part, mine["launches"], follower["launches"], mine["expected"])
            launches[f"{part}_rank0"] = mine["launches"]
            launches[f"{part}_rank1"] = follower["launches"]
        for row, key in (("row4", "ragged_paged_attention"),
                         ("row5", "ragged_paged_attention_quantized"),
                         ("row6", "fused_page_write"),
                         ("row7", "fused_page_write_quantized")):
            assert a["launches"][key] > 0, f"(a) launched no {key}"
        for key in ("flash_gqa_prefill", "flash_gqa_decode", "ragged_paged_attention",
                    "fused_page_write"):
            assert bc["launches"][key] > 0, f"(b) launched no {key}"
        print(f"  launches: each part's equal on both ranks and equal to its steps' count; "
              f"(a) {json.dumps({k: v for k, v in a['launches'].items() if v})}; (b)+(c) "
              f"{json.dumps({k: v for k, v in bc['launches'].items() if v})}", flush=True)
        numbers.update(
            a={"seconds": a["seconds"], "pools": a["pools"]},
            **{label: {"seconds": bc[label]["seconds"], "timing": bc[label]["timing"]}
               for label in ("b_contiguous", "b_paged", "c")},
            c_build_s=bc["c_build_s"], pages={k: v for k, v in bc.items()
                                              if k.endswith("_pages")},
            divergences=div, staged=a["mesh"])
        numbers["seconds"] = round(time.perf_counter() - t_phase, 1)
        print(f"  phase 22: {json.dumps(numbers)}", flush=True)
        return launches, numbers
    finally:
        if old_devices is None:
            os.environ.pop("LSOT_MESH_DEVICES", None)
        else:
            os.environ["LSOT_MESH_DEVICES"] = old_devices
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------- phase 23: warmup before serving

WARM_SLOTS = 8          # the app's default scheduler: contiguous, 8 slots
WARM_KV_GB = 4          # (b): KV of each paged scheduler
WARM_TIMEOUT_S = 600    # a cold-start child that has not answered by then is stuck
WARM_ROUNDS = 1         # (a): pairs of fresh processes, unwarmed then warmed (3 in
                        # PR 24's call 4: a single TTFT varies by ~0.05 s with the
                        # host; 1 since, for the run's time)
_WARMUP = {}            # (c)'s restart seconds, taken in phases 10 (c) and 16


def warm_prompts(tok):
    """(a)'s two SQL prompts: the app's NL->SQL shape, each opening with its
    own request number (so they share no leading block), cut to one length
    (so both prefill through the same buckets)."""
    ids = [tok.encode(f"Request {i}. {SYSTEM_SQL}\n\n{q}") for i, q in enumerate(QUESTIONS)]
    n = min(len(x) for x in ids[:2])
    return [x[:n] for x in ids[:2]]


def warm_child(mode) -> int:
    """`--warm-child MODE`: one fresh process of phase 23 (a). Builds the
    app's default scheduler (contiguous, WARM_SLOTS slots) over the 7B
    bf16 tree from seed 0, FLEET_LAYERS deep (`make_engines`' recipe, cut
    as `fleet_model` cuts it), prints the tree's checksum; with MODE "warm"
    calls `warmup(len(prompt))` and times it; then serves the two
    `warm_prompts` in turn and prints each one's TTFT (submit -> first
    accepted token) and stream as one JSON line. Exits 1 on any failure."""
    try:
        return _warm_child(mode)
    except BaseException:  # noqa: BLE001 — a child must not linger half-built
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def _warm_child(mode) -> int:
    import torch

    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.serve import resolve_stop_ids
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg, params = depth_cut(DUCKDB_NSQL_7B, init_params(DUCKDB_NSQL_7B, gen, torch.bfloat16,
                                                        device="cuda"),
                            FLEET_LAYERS, clone=True)
    torch.cuda.empty_cache()
    tok = ByteTokenizer()
    out = {"mode": mode, "tree_checksum": tree_checksum(torch, params)}
    sched = ContinuousBatchingScheduler(cfg, params, num_slots=WARM_SLOTS,
                                        stop_ids=resolve_stop_ids(cfg, tok), device="cuda")
    prompts = warm_prompts(tok)
    torch.cuda.synchronize()
    out["build_s"] = round(time.perf_counter() - t0, 3)
    if mode == "warm":
        t1 = time.perf_counter()
        sched.warmup(len(prompts[0]))
        torch.cuda.synchronize()
        out["warmup_s"] = round(time.perf_counter() - t1, 6)
    sched.start()
    ttft, streams = [], []
    for p in prompts:
        first = []
        t_submit = time.perf_counter()
        fut = sched.submit(p, max_new_tokens=MAX_NEW,
                           on_token=lambda _t: first or first.append(time.perf_counter()))
        streams.append(fut.result(timeout=300))
        ttft.append(first[0] - t_submit)
        wait_settled(sched)
    sched.shutdown()
    out.update(prompt_tokens=len(prompts[0]), ttft_s=[round(x, 6) for x in ttft],
               excess_s=round(ttft[0] - ttft[1], 6), streams=streams)
    print(json.dumps({"warm_child": out}), flush=True)
    return 0


def warm_state(torch, sched):
    """A scheduler's state that a warmup must leave as it found it: every
    cache position below the park position (a pool: every page, and the
    page tables), the slot state, the draft history below max_seq; the
    counters, the allocator's counts, the perf ledger (its pending prefill
    pile included), the flight ring and the prefix stats."""
    if sched._paged:
        dev = {n: p.clone() for n, p in sched._pool.items()}
        dev["ptab"] = sched._ptab.clone()
    else:
        dev = {n: c[:, :, :, :sched._park].clone() for n, c in sched._cache.items()}
    for n in ("_cur", "_pos", "_temps", "_topps", "_topks", "_seeds", "_counts",
              "_cstates", "_crem"):
        dev[n] = getattr(sched, n).clone()
    if sched._spec_draft:
        dev["_hist"] = sched._hist[:, :sched.max_seq].clone()
        dev["_hlen"] = sched._hlen.clone()
    host = ({n: getattr(sched, n) for n in ("rounds_issued", "prefill_forwards",
                                            "mixed_rounds", "ragged_prefills")},
            sched.page_stats, sched.perf_stats, sched.perf._pending_prefill_flops,
            sched.flight.snapshot(), sched.flight_stats, sched.prefix_stats)
    return dev, host


def warm_cold_start(torch, engines, smi, bounds):
    """(a): WARM_ROUNDS pairs of fresh processes, one after the other,
    unwarmed then warmed; the excess held to its limit is the warmed
    processes' median."""
    m = fleet_model(engines["duckdb-nsql"])
    want = tree_checksum(torch, m.params)
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    prompts = warm_prompts(ByteTokenizer())
    children = {"cold": [], "warm": []}
    div = []
    for _ in range(WARM_ROUNDS):
        for mode in ("cold", "warm"):
            w = Worker([sys.executable, os.path.abspath(__file__), "--warm-child", mode],
                       f"warm-{mode}")
            try:
                line = w.wait_for(lambda x: x.startswith('{"warm_child"'), WARM_TIMEOUT_S)
                rc = w.proc.wait(timeout=120)
            finally:
                w.kill()
            assert rc == 0, f"warm child {mode} exited {rc}: {w.log[-20:]}"
            c = json.loads(line)["warm_child"]
            assert c["tree_checksum"] == want, (c, want)
            children[mode].append(c)
            print(f"  (a) {mode} process: TTFT 1 {c['ttft_s'][0]} s, TTFT 2 {c['ttft_s'][1]} "
                  f"s, excess {c['excess_s']} s" + (f", warmup {c['warmup_s']} s"
                                                   if "warmup_s" in c else "")
                  + f" ({c['prompt_tokens']} prompt tokens; on {smi})", flush=True)
        div += fleet_compare(torch, "warmup_cold_start", m.cfg, m.params, m.stop_ids,
                             prompts, children["warm"][-1]["streams"],
                             children["cold"][-1]["streams"], bounds)
    out = {mode: {k: [c[k] for c in cs] for k in ("ttft_s", "excess_s", "build_s")}
           for mode, cs in children.items()}
    warm = children["warm"]
    excess = statistics.median(c["excess_s"] for c in warm)
    limit = max(0.020, 0.1 * statistics.median(c["ttft_s"][1] for c in warm))
    out.update(warmup_s=[c["warmup_s"] for c in warm],
               cold_excess_median_s=round(statistics.median(
                   c["excess_s"] for c in children["cold"]), 6),
               warm_excess_median_s=round(excess, 6), excess_limit_s=round(limit, 6),
               excess_within_limit=excess <= limit,
               streams_equal=all(w["streams"] == c["streams"]
                                 for w, c in zip(warm, children["cold"])),
               divergences=div)
    print(f"  (a) median excess: unwarmed {out['cold_excess_median_s']} s, warmed "
          f"{out['warm_excess_median_s']} s against max(20 ms, 10% of TTFT 2) = "
          f"{limit:.6f} s: {'held' if out['excess_within_limit'] else 'missed'}; streams "
          f"equal: {out['streams_equal']} ({len(div)} near-ties)", flush=True)
    return out


def warm_neutral(torch, engines, smi, bounds):
    """(b): three schedulers in this process, each served, warmed, checked
    unchanged, served a burst and held to an unwarmed twin."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    m = fleet_model(engines["duckdb-nsql"])
    tok = ByteTokenizer()
    turn = [tok.encode(f"{SYSTEM_SQL}\n\n{q}") for q in SCHED_SQL[:2]]
    burst_p = [tok.encode(f"Burst {i}. {SYSTEM_SQL}\n\n{q}")
               for i, q in enumerate(SCHED_SQL[2:8])]
    paged = dict(kv_layout="paged", kv_page_size=SCHED["kv_page_size"],
                 kv_hbm_budget_bytes=WARM_KV_GB * 2**30)
    variants = (("contiguous_bf16", {}), ("paged_int8", dict(paged, kv_quant="int8")),
                ("paged_spec8", dict(paged, speculative_draft=SPEC_DRAFT)))
    launches, numbers = {}, {}
    for label, kw in variants:
        torch.cuda.synchronize()
        reset_launches()
        streams = {}
        for side in ("warmed", "twin"):
            sched = ContinuousBatchingScheduler(m.cfg, m.params, num_slots=WARM_SLOTS,
                                                stop_ids=m.stop_ids, device="cuda", **kw)
            with sched:
                for p in turn:
                    sched.submit(p, max_new_tokens=MAX_NEW).result(timeout=300)
                wait_settled(sched)
            if side == "warmed":
                dev, host = warm_state(torch, sched)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sched.warmup()
                torch.cuda.synchronize()
                warm_s = round(time.perf_counter() - t0, 6)
                dev2, host2 = warm_state(torch, sched)
                same = {n: bool(torch.equal(dev[n], dev2[n])) for n in dev}
                assert all(same.values()), f"{label}: the warmup changed {same}"
                assert host == host2, f"{label}: the warmup moved {host} -> {host2}"
                del dev, dev2
            with sched:
                outs, got, timing = timed_burst(
                    lambda p, on: sched.submit(p, max_new_tokens=MAX_NEW, on_token=on),
                    burst_p)
                wait_settled(sched)
            assert all(o is not None for o in outs), f"{label}: a request was lost"
            if sched._paged:
                st = sched.page_stats
                assert st["pages_in_use"] == st["prefix_resident_pages"], st
            streams[side] = (sched, outs, timing)
        torch.cuda.synchronize()
        launches[f"warmup_{label}"] = dict(LAUNCHES)
        expected = dict.fromkeys(LAUNCHES, 0)
        for sc, _, _ in streams.values():
            expect_served(expected, sc, sc.rounds_issued, sc.prefill_forwards)
        expect_warmup(expected, streams["warmed"][0])
        assert launches[f"warmup_{label}"] == expected, \
            f"{label}: launch counts {launches[f'warmup_{label}']} != {expected}"
        div = fleet_compare(torch, f"warmup_{label}", m.cfg, m.params, m.stop_ids, burst_p,
                            streams["warmed"][1], streams["twin"][1], bounds,
                            kv_quant=kw.get("kv_quant"))
        numbers[label] = dict(warmup_s=warm_s, state_unchanged=True, tensors_checked=len(same),
                              streams_equal=f"{len(burst_p) - len(div)} of {len(burst_p)}",
                              divergences=div, ttft_p50_s=streams["warmed"][2]["ttft_p50_s"],
                              twin_ttft_p50_s=streams["twin"][2]["ttft_p50_s"])
        print(f"  (b) {label}: warmup {warm_s} s; {len(same)} tensors below the park "
              f"position (pool: every page) and the counters, ledger and flight ring "
              f"unchanged; burst of {len(burst_p)}: {numbers[label]['streams_equal']} streams "
              f"equal to the unwarmed twin's, TTFT p50 {numbers[label]['ttft_p50_s']} s "
              f"(twin {numbers[label]['twin_ttft_p50_s']} s); on {smi}", flush=True)
        del streams, sched
        gc.collect()
        torch.cuda.empty_cache()
    return launches, numbers


def warm_rebuild(torch, engines, smi):
    """(c) here: a pool of one contiguous replica over the same tree, its
    targeted restart; the fresh replica warms before it starts. The
    restarts of phases 10 (c) and 16, which warm through the supervisor's
    restart driver and the pool's rebuild, are read from their phases."""
    import random

    from llm_based_apache_spark_optimization_tpu_torch.serve import resilience
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerPool,
    )

    m = fleet_model(engines["duckdb-nsql"])
    events = []

    def build(i=0):
        s = ContinuousBatchingScheduler(m.cfg, m.params, num_slots=WARM_SLOTS,
                                        stop_ids=m.stop_ids, device="cuda")
        warm, start = s.warmup, s.start
        s.warmup = lambda n=None: (events.append("warmup"), warm(n))[1]
        s.start = lambda: (events.append("start"), start())[1]
        return s

    pool = SchedulerPool([build()], factory=build, max_restarts=2,
                         restart_policy=resilience.RetryPolicy(
                             max_attempts=3, base_delay_s=0.001, max_delay_s=0.01),
                         rng=random.Random(0), replica_join_s=5.0)
    with pool:
        t0 = time.perf_counter()
        assert pool.restart_replica("r0") is True
        while True:
            r0 = pool.replica_health()[0]
            if r0["restarts"] == 1 and r0["state"] in ("ready", "degraded"):
                break
            assert time.perf_counter() - t0 < 120, r0
            time.sleep(0.005)
        restart_s = round(time.perf_counter() - t0, 4)
        assert pool.generate([[1, 5, 9]], max_new_tokens=4)
    assert events == ["start", "warmup", "start"], events
    out = {"pool_rebuild_s": restart_s, "supervised_restart_s": _WARMUP.get(
        "supervised_restart_s"), "fleet_restart_s": _WARMUP.get("fleet_restart_s")}
    print(f"  (c) a pool rebuild warmed before start(): {events}; restart {restart_s} s "
          f"with the warmup; phase 10 (c)'s supervised restart "
          f"{out['supervised_restart_s']} s, phase 16's targeted restart "
          f"{out['fleet_restart_s']} s (not run: None); on {smi}", flush=True)
    return out


def warmup_serve(torch, engines, smi):
    """Phase 23: the warmup on the card. (a) cold start in two fresh
    processes, (b) state neutrality in this one, (c) restarts that warm
    before serving."""
    bounds = {}
    numbers = {"cold_start": warm_cold_start(torch, engines, smi, bounds)}
    launches, numbers["neutral"] = warm_neutral(torch, engines, smi, bounds)
    numbers["restarts"] = warm_rebuild(torch, engines, smi)
    return launches, numbers


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also trace one 7B engine request, a burst of 7B "
                         "scheduler requests and a batch on the bf16 and int8 7B "
                         "engines with torch.profiler (with --int8-only: the batch "
                         "on the 7B engines alone)")
    ap.add_argument("--timing-only", action="store_true",
                    help="build and run the timing phase alone (no checks; "
                         "prints the times and no ok line)")
    ap.add_argument("--sweep", action="store_true",
                    help="build and time each decode launch and each paged query "
                         "window at every cluster size of SWEEP_SPLITS (no checks; "
                         "prints the times and no ok line)")
    ap.add_argument("--mixed-only", action="store_true",
                    help="build and run the ragged mixed rounds' serve phase alone "
                         "on the 7B weights (prints its requests and no ok line)")
    ap.add_argument("--constrained-only", action="store_true",
                    help="build and run phase 12 and phase 8 (b), the constrained "
                         "paths, alone on the 7B and 3B weights (prints their checks "
                         "and no ok line)")
    ap.add_argument("--speculative-only", action="store_true",
                    help="build and run the speculative phases alone: the kernels at "
                         "the verify shapes against their plain versions, the verify "
                         "cost anchor, phase 13 on the 7B weights and the verify-shape "
                         "timing (prints their checks and no ok line)")
    ap.add_argument("--observability-only", action="store_true",
                    help="build and run phase 15 alone: the observability checks and "
                         "captures on a contiguous bf16 and a paged int4 + int8-pool 7B "
                         "scheduler (prints their numbers and no ok line)")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build and run phase 16 (a) alone: the co-resident 7B x 2 + 3B "
                         "pool under QoS (prints its numbers and no ok line)")
    ap.add_argument("--disagg-only", action="store_true",
                    help="build and run phase 17 alone: the phase-split 7B fleet over "
                         "the bf16 and the int8 pool (prints its numbers and no ok line)")
    ap.add_argument("--remote-only", action="store_true",
                    help="build and run phase 18 (a) and (b) alone: the remote fleets "
                         "over worker processes on the 7B weights (prints their numbers "
                         "and no ok line)")
    ap.add_argument("--elastic-only", action="store_true",
                    help="build and run phase 19 alone: the autoscaled 7B fleet, the "
                         "harness over it, the chaos run and the host checks (prints "
                         "their numbers and no ok line)")
    ap.add_argument("--remote-worker", default="", choices=["", "prefill", "decode", "mixed"],
                    help=argparse.SUPPRESS)  # one worker process of phases 18-19
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # one rank process of phase 20
    ap.add_argument("--pool-rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # one follower process of phase 21
    ap.add_argument("--native-python", default="",
                    help=argparse.SUPPRESS)  # phase 21 (c)'s Python side
    ap.add_argument("--sp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # the follower process of phase 22
    ap.add_argument("--warm-child", default="", choices=["", "cold", "warm"],
                    help=argparse.SUPPRESS)  # one cold-start process of phase 23 (a)
    ap.add_argument("--warmup-only", action="store_true",
                    help="build and run phase 23 alone: the warmup's cold start in two "
                         "fresh processes, its state neutrality on three schedulers and "
                         "a pool rebuild that warms, over the 7B weights (prints its "
                         "numbers and no ok line)")
    ap.add_argument("--sp-only", action="store_true",
                    help="build and run phase 22 alone: sp=2 on two ranks of one card "
                         "over the 7B weights, the paged engine behind the entry point's "
                         "--sp 2 --no-scheduler --kv-layout paged, schedulers on the sp "
                         "mesh and one built on it while it runs (prints its numbers and "
                         "no ok line)")
    ap.add_argument("--pool-mesh-only", action="store_true",
                    help="build and run phase 21 alone: the --dp 2 --tp 2 pool of tp=2 "
                         "7B replicas, phase-split and int8 with spill, every rank on "
                         "one card, and the native scanner and encoder (prints its "
                         "numbers and no ok line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build and run phase 20 alone: tp=2 and sp=2 on two ranks of "
                         "one card over the 7B and 3B weights, and the runbook over a "
                         "4-layer 7B HF directory (prints its numbers and no ok line)")
    ap.add_argument("--int8-only", action="store_true",
                    help="build and run phase 14's kernel parts alone: the int8 matmul "
                         "and row 8 at the stacked widths against their plain versions, "
                         "then their timing (prints their checks and no ok line)")
    args = ap.parse_args()
    if args.remote_worker:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return remote_worker(args.remote_worker)
    if args.mesh_rank is not None:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return mesh_rank(args.mesh_rank)
    if args.pool_rank is not None:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return pool_rank(args.pool_rank)
    if args.sp_rank is not None:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return sp_rank(args.sp_rank)
    if args.native_python:
        return native_python(args.native_python)
    if args.warm_child:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return warm_child(args.warm_child)

    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import _build
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        attention as attn_mod,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        paged_attention as pa_mod,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        paged_write as pw_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)

    phase("build")
    t0 = time.perf_counter()
    reports = _build.build_all(force=True, extra_flags=("-Xptxas", "-v"))
    print(f"  built {sorted(reports)} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  {cuda_versions(_build)}", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line:  # the mangled kernel name
                print(f"  {name}: {line.split(chr(39))[1][:120]}")
            elif "Used" in line or "spill" in line and " 0 bytes spill" not in line:
                print(f"  {name}:   {line.strip()}")
    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int4mm as mm_mod

    if args.timing_only:
        phase("prefill digests")
        digests = prefill_digests(torch, attn_mod)
        phase("timing")
        timed = timing(torch, attn_mod, pa_mod, pw_mod, mm_mod, DUCKDB_NSQL_7B)
        phase(None)
        print(json.dumps({"timing": timed, "prefill_digests": digests, "device": smi}))
        return 0
    if args.mixed_only:
        phase("serve (ragged mixed rounds)")
        mixed_serve(torch, make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),)))
        phase(None)
        print(json.dumps({"phase_seconds": _PHASE["seconds"], "device": smi}))
        return 0
    if args.constrained_only:
        phase("constrained decoding (grammar tables)")
        compile_grammars(torch, DUCKDB_NSQL_7B, smi)
        tally = GrammarTally()
        from llm_based_apache_spark_optimization_tpu_torch.models import LLAMA32_3B

        from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
            quantize_params_int4,
        )

        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),
                                       ("llama3.2", LLAMA32_3B)))
        constrained_paths(torch, engines,
                          quantize_params_int4(engines["duckdb-nsql"].params), tally, smi)
        phase("serve (overcommit: preemption, spill and recompute)")
        overcommit_serve(torch, engines, tally)
        phase("constrained app (phase 8 (b))")
        _, scheds = contiguous_serve(torch, engines)
        constrained_app(torch, scheds, tally, smi)
        tally.summary()
        phase(None)
        print(json.dumps({"phase_seconds": _PHASE["seconds"], "device": smi}))
        return 0
    if args.speculative_only:
        phase("kernels vs plain at the verify shapes")
        spec_kernels(torch, attn_mod, pa_mod, pw_mod, mm_mod)
        phase("verify cost anchor")
        anchor, readings = verify_cost_anchor(torch, smi)
        phase("constrained decoding (grammar tables)")
        compile_grammars(torch, DUCKDB_NSQL_7B, smi)
        tally = GrammarTally()
        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),))
        _, tprs, div, calib = speculative_paths(torch, engines, tally, smi)
        tally.summary()
        phase("timing at the verify shapes")
        del engines
        gc.collect()
        torch.cuda.empty_cache()
        verify = time_verify(torch, attn_mod, pa_mod, pw_mod, mm_mod, DUCKDB_NSQL_7B)
        phase(None)
        print(json.dumps({"speculative": {"verify_cost_anchor_d8": anchor,
                                          "anchor_readings": readings,
                                          "tokens_per_round": tprs, "divergences": div,
                                          **calib},
                          "verify_timing": verify, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int8mm as mm8

    if args.int8_only:
        phase("int8 matmul and stacked int4 vs plain (phase 14 (a), (b))")
        int8_err = check_int8(torch, mm8)
        stacked_err = check_int4_stacked(torch, mm_mod)
        phase("int8 and stacked int4 timing (phase 14 (f))")
        timed8 = time_int8(torch, mm8, mm_mod, reports.get("int8_matmul", ""))
        if args.profile:
            phase("profile (phase 14 (c)'s batch on the 7B engines)")
            int8_profile(torch)
        phase(None)
        print(json.dumps({"int8_errors": int8_err, "int4_stacked_rel": stacked_err,
                          "int8_timing": timed8, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.observability_only:
        phase("observability (a): the contiguous bf16 7B scheduler behind the app")
        obs = observability_only(torch, DUCKDB_NSQL_7B)
        phase(None)
        print(json.dumps({"observability": obs, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.fleet_only:
        from llm_based_apache_spark_optimization_tpu_torch.models import LLAMA32_3B

        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),
                                       ("llama3.2", LLAMA32_3B)))
        phase("fleet (a), phase 16: the co-resident 7B x 2 + 3B pool under QoS")
        _, fleet = fleet_serve(torch, engines, smi)
        phase(None)
        print(json.dumps({"fleet": fleet, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.remote_only:
        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),))
        phase("remote fleet, phase 18 (a), (b): worker processes over the 7B tree")
        _, remote_numbers = remote_serve(torch, engines, smi)
        phase(None)
        print(json.dumps({"remote": remote_numbers, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.elastic_only:
        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),))
        phase("elastic fleet and eval harness, phase 19: the autoscaled 7B pool")
        _, elastic = elastic_serve(torch, engines, smi)
        phase(None)
        print(json.dumps({"elastic": elastic, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.mesh_only:
        from llm_based_apache_spark_optimization_tpu_torch.models import LLAMA32_3B

        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),
                                       ("llama3.2", LLAMA32_3B)))
        phase("meshes, phase 20: tp=2 and sp=2 on two ranks of cuda:0, the runbook")
        import shutil
        import tempfile

        root = tempfile.mkdtemp(prefix="lsot-mesh-hf-")
        try:
            _, mesh_numbers = mesh_serve(torch, engines, smi, mesh_hf_dir(engines, root))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        phase(None)
        print(json.dumps({"mesh": mesh_numbers, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.pool_mesh_only:
        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),))
        phase("pool of tp meshes, phase 21: two tp=2 replicas on cuda:0 (gloo), the "
              "native layer")
        _, pool_numbers = pool_mesh_serve(torch, engines, smi)
        phase(None)
        print(json.dumps({"pool_mesh": pool_numbers, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.sp_only:
        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),))
        phase("sequence parallelism, phase 22: sp=2 on two ranks of cuda:0 (gloo), the "
              "paged engine and schedulers on it")
        _, sp_numbers = sp_serve(torch, engines, smi)
        phase(None)
        print(json.dumps({"sp": sp_numbers, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.warmup_only:
        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),))
        phase("warmup, phase 23: cold start, state neutrality, restarts that warm")
        _, warm_numbers = warmup_serve(torch, engines, smi)
        phase(None)
        print(json.dumps({"warmup": warm_numbers, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.disagg_only:
        engines = make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),))
        phase("disaggregated fleet, phase 17: prefill:1,decode:1 over the 7B tree")
        _, disagg = disagg_serve(torch, engines, smi)
        phase(None)
        print(json.dumps({"disagg": disagg, "phase_seconds": _PHASE["seconds"],
                          "device": smi}))
        return 0
    if args.sweep:
        phase("split sweep")
        swept = sweep(torch, attn_mod, pa_mod, pw_mod, DUCKDB_NSQL_7B)
        phase(None)
        print(json.dumps({"sweep": swept, "device": smi}))
        return 0

    phase("kernels vs plain")
    worst = check_kernels(torch, attn_mod)
    worst_paged = check_paged(torch, pa_mod)
    write_err = check_write(torch, pw_mod)
    errors_q = {"decode_q": check_kernels_quantized(torch, attn_mod),
                **check_paged_quantized(torch, pa_mod),
                "write_q": check_write_quantized(torch, pw_mod)}
    int4_err = check_int4(torch, mm_mod)
    int8_err = check_int8(torch, mm8)
    stacked_err = check_int4_stacked(torch, mm_mod)
    view_err = check_int8_view(torch, pa_mod)
    errors_q["paged_q_window"]["bfloat16"] = max(errors_q["paged_q_window"]["bfloat16"],
                                                 view_err[0])
    errors_q["paged_q_window_rel"]["bfloat16"] = max(
        errors_q["paged_q_window_rel"]["bfloat16"], view_err[1])

    phase("small reference")
    small_reference(torch)
    small_reference(torch, quantized=True)

    phase("constrained decoding (grammar tables)")
    compile_grammars(torch, DUCKDB_NSQL_7B, smi)
    tally = GrammarTally()

    phase("serve (engine path)")
    launches, engines, svc = serve(torch)
    if args.profile:
        phase("profile (engine path)")
        profile_device(torch, "one 7B engine request", lambda: svc.generate(
            "duckdb-nsql", QUESTIONS[0], system=SYSTEM_SQL).output_tokens)
    del svc

    phase("serve (scheduler path)")
    sched_launches = scheduler_serve(torch, engines, args.profile)
    gc.collect()
    torch.cuda.empty_cache()

    phase("serve (ragged mixed rounds)")
    mixed_launches = mixed_serve(torch, engines)

    phase("serve (overcommit: preemption, spill and recompute)")
    overcommit_launches = overcommit_serve(torch, engines, tally)

    phase("serve (admission control and slot stalls)")
    admission_launches = admission_serve(torch, engines)

    phase("serve (contiguous scheduler path)")
    contig_launches, contig_scheds = contiguous_serve(torch, engines)

    phase("app (POST /process-data/ and /api/generate streaming on the contiguous "
          "schedulers)")
    app_launches, stream_launches, app_svc = app_serve(torch, contig_scheds)
    phase("app under LSOT_CONSTRAIN_SQL=1 (phase 8 (b))")
    constrained_app_launches = constrained_app(torch, contig_scheds, tally, smi)
    phase("observability (a): the contiguous bf16 7B scheduler behind the app")
    obs = {"contiguous_bf16": observability(torch, app_svc, "duckdb-nsql",
                                            contig_scheds["duckdb-nsql"],
                                            "contiguous_bf16")}
    del app_svc
    for sc in contig_scheds.values():
        sc.shutdown()
    del contig_scheds
    gc.collect()  # the app's reference cycles hold the caches until collected
    phase("fleet (a), phase 16: the co-resident 7B x 2 + 3B pool under QoS")
    fleet_launches, fleet = fleet_serve(torch, engines, smi)
    phase("disaggregated fleet, phase 17: prefill:1,decode:1 over the 7B tree")
    disagg_launches, disagg = disagg_serve(torch, engines, smi)
    phase("remote fleet, phase 18 (a), (b): worker processes over the 7B tree")
    remote_launches, remote_numbers = remote_serve(torch, engines, smi,
                                                   split=disagg.get("bf16"))
    phase("elastic fleet and eval harness, phase 19: the autoscaled 7B pool")
    elastic_launches, elastic = elastic_serve(torch, engines, smi)
    phase("entry point: the tiny app as a process")
    entry_point(torch)

    phase("serve (quantized path: int4 weights, int8 KV)")
    q_launches, params4 = quantized_serve(torch, engines, args.profile)
    phase("observability (b): the paged int4 7B scheduler over the int8 pool")
    obs["paged_int4_int8"] = observability_paged(torch, engines, params4)

    constrained_launches = constrained_paths(torch, engines, params4, tally, smi)
    del params4
    constrained_launches["constrained_app"] = constrained_app_launches

    spec_launches, spec_tprs, spec_div, spec_calib = speculative_paths(torch, engines,
                                                                       tally, smi)

    phase("int8 weights and fused trees (phase 14 (c)): the 7B and 3B engines")
    q8_div = []
    q8_launches, params8 = int8_engines(torch, engines, smi, tally, q8_div, args.profile)
    constrained_launches["constrained_q8_engine_fused"] = q8_launches.pop(
        "constrained_q8_engine_fused")
    phase("int8 weights and fused trees (phase 14 (d)): both schedulers, ragged, "
          "speculative")
    eng7 = engines["duckdb-nsql"]
    q8_launches.update(int8_schedulers(torch, eng7.cfg, params8, eng7.stop_ids, q8_div))
    del params8
    gc.collect()
    torch.cuda.empty_cache()
    tally.summary()

    mesh_out = {}

    def phase20(hf_dir):
        phase("meshes, phase 20: tp=2 and sp=2 on two ranks of cuda:0 (gloo), the runbook "
              "at tp=1 and tp=2")
        mesh_out["launches"], mesh_out["numbers"] = mesh_serve(torch, engines, smi, hf_dir)

    ckpt_launches = checkpoints(torch, engines, after_hf=phase20)
    if not mesh_out:  # no tokenizers package: phase 20 without the runbook's (d)
        phase20(None)
    gc.collect()
    torch.cuda.empty_cache()
    phase("pool of tp meshes, phase 21: two tp=2 replicas on cuda:0 (gloo), the native "
          "layer")
    pool_launches, pool_numbers = pool_mesh_serve(torch, engines, smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase("sequence parallelism, phase 22: sp=2 on two ranks of cuda:0 (gloo), the paged "
          "engine and schedulers on it")
    sp_launches, sp_numbers = sp_serve(torch, engines, smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase("warmup, phase 23: cold start, state neutrality, restarts that warm")
    warm_launches, warm_numbers = warmup_serve(torch, engines, smi)

    phase("timing")
    assert engines["duckdb-nsql"].cfg == DUCKDB_NSQL_7B
    del engines
    torch.cuda.empty_cache()
    timed = timing(torch, attn_mod, pa_mod, pw_mod, mm_mod, DUCKDB_NSQL_7B)
    phase("int8 and stacked int4 timing (phase 14 (f))")
    timed8 = time_int8(torch, mm8, mm_mod, reports.get("int8_matmul", ""))
    phase("timing at the verify shapes, verify cost anchor")
    verify = time_verify(torch, attn_mod, pa_mod, pw_mod, mm_mod, DUCKDB_NSQL_7B)
    anchor, readings = verify_cost_anchor(torch, smi)
    errors = {
        "prefill": {d: worst[("prefill", d)] for d in TOL},
        "decode": {d: worst[("decode", d)] for d in TOL},
        **worst_paged,
        "write": write_err,
        **errors_q,
        "int4": {d: int4_err[d][0] for d in TOL},
        "int8": int8_err["abs"],
    }
    timed["int8"] = dict(timed8["int8"][INT8_HEADLINE],
                         by_shape=timed8["int8"])
    timed["int4"]["by_shape_stacked"] = timed8["int4_stacked"]
    names = {"prefill": "flash_gqa_attention_prefill",
             "decode": "flash_gqa_attention_decode",
             "paged": "ragged_paged_attention",
             "paged_window": "ragged_paged_attention_window",
             "write": "fused_page_write",
             "decode_q": "flash_gqa_attention_quantized",
             "paged_q": "ragged_paged_attention_quantized",
             "paged_q_window": "ragged_paged_attention_quantized_window",
             "write_q": "fused_page_write_quantized", "int4": "int4_matmul",
             "int8": "int8_matmul"}
    counters = {"prefill": "flash_gqa_prefill", "decode": "flash_gqa_decode",
                "paged": "ragged_paged_attention", "paged_window": "ragged_paged_window",
                "write": "fused_page_write",
                "decode_q": "flash_gqa_decode_quantized",
                "paged_q": "ragged_paged_attention_quantized",
                "paged_q_window": "ragged_paged_window_quantized",
                "write_q": "fused_page_write_quantized", "int4": "int4_matmul",
                "int8": "int8_matmul"}
    paths = {"engine": launches, "scheduler": sched_launches,
             "mixed_scheduler": mixed_launches["bf16"],
             "mixed_scheduler_int8": mixed_launches["int8"],
             "overcommit_scheduler": overcommit_launches,
             "admission_scheduler": admission_launches,
             "contiguous_scheduler": contig_launches, "app": app_launches,
             "app_streaming": stream_launches,
             "quantized_engine": q_launches["engine"],
             "quantized_scheduler": q_launches["scheduler"],
             "quantized_contiguous_scheduler": q_launches["contiguous"],
             "fleet_pool": fleet_launches, **disagg_launches, **remote_launches,
             **elastic_launches, **mesh_out["launches"], **pool_launches, **sp_launches,
             **warm_launches,
             **ckpt_launches, **constrained_launches, **spec_launches, **q8_launches}
    window_tol = {"bfloat16": TOL["bfloat16"], "bfloat16_max_row_rel": WINDOW_ROW_TOL}
    tolerance = {"paged_window": window_tol, "paged_q_window": window_tol,
                 "write": {"bfloat16": 0.0, "float32": 0.0},
                 "write_q": {"bfloat16": 0.0, "float32": 0.0},
                 "int4": {f"{d}_over_max_abs_out": v for d, v in INT4_TOL.items()},
                 "int8": {"bfloat16_ulps_of_plain": 1.0,
                          "float32_logits_over_max_abs_out": INT8_LOGIT_TOL,
                          "float32_over_max_abs_out": INT8_F32_TOL}}
    for launch in names:  # the constrained paths ran every kernel of the table
        assert any(c[counters[launch]] for c in (*constrained_launches.values(),
                                                 overcommit_launches)), \
            f"no constrained path launched {names[launch]}"
    kernels = []
    for launch in names:
        tm = timed[launch]
        by_path = {p: c[counters[launch]] for p, c in paths.items() if c[counters[launch]]}
        entry = {
            "name": names[launch],
            "route": "cuda",
            "source": SOURCES[launch],
            "replaces": REPLACES[launch],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(errors[launch].values()),
            "max_abs_err_by_dtype": errors[launch],
            "tolerance": tolerance.get(launch, TOL),
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
            "shape": tm["shape"],
        }
        assert entry["launches"] > 0, f"{names[launch]} was launched no time on the paths"
        for k in WRITE_VARIANTS:
            if k in tm:
                entry[k] = tm[k]
        if launch == "int4":
            entry["max_rel_err_by_dtype"] = {d: int4_err[d][1] for d in TOL}
            entry["stacked_max_rel_err"] = stacked_err
        if launch == "int8":
            entry["max_err"] = {k: v for k, v in int8_err.items() if k != "abs"}
            entry["host_us"] = timed8["host_us"]
        if "by_shape" in tm:
            entry["by_shape"] = tm["by_shape"]
        if launch in verify:
            # The speculative verify round's shapes (D = 8, T = 9).
            entry["verify_d8"] = verify[launch]
        if launch in MESH_ROWS:
            # Phase 20: the row held against its plain version at the
            # per-rank shapes of the tp=2 meshes, on each rank.
            entry["mesh_per_rank_max_err"] = mesh_out["numbers"]["kernels_per_rank"][
                MESH_ROWS[launch]]
        if launch in POOL_ROWS:
            # Phase 21: the row at the per-rank shapes of its tp=2 replicas.
            entry["pool_per_rank_max_err"] = pool_numbers["kernels_per_rank"][
                POOL_ROWS[launch]]
        if launch in SP_ROWS:
            # Phase 22: the row at an sp rank's shapes (the whole pool, every head).
            entry["sp_per_rank_max_err"] = sp_numbers["kernels_per_rank"][SP_ROWS[launch]]
        if launch.endswith("_window"):
            # bf16 only: f32 windows run the tile kernel, recorded apart.
            entry["max_row_rel_err_by_dtype"] = errors[launch + "_rel"]
            entry["float32_windows"] = {"source": f"{PKG}/csrc/gqa_tile.cuh",
                                        "max_abs_err": errors[launch + "_tile"]["float32"]}
        kernels.append(entry)
    phase(None)
    print(f"  phase seconds: {json.dumps(_PHASE['seconds'])}", flush=True)

    print(json.dumps({"int8_weights": {"divergences": q8_div,
                                       "drift": {k: v for k, v in _DRIFT.items()
                                                 if k.startswith("q8")}}}))
    print(json.dumps({"speculative": {"verify_cost_anchor_d8": anchor,
                                      "anchor_readings": readings,
                                      "tokens_per_round": spec_tprs,
                                      "divergences": spec_div, **spec_calib}}))
    print(json.dumps({"observability": obs, "device": smi}))
    print(json.dumps({"fleet": fleet, "device": smi}))
    print(json.dumps({"disagg": disagg, "device": smi}))
    print(json.dumps({"remote": {**remote_numbers, "cli": _REMOTE.get("cli")},
                      "device": smi}))
    print(json.dumps({"elastic": elastic, "device": smi}))
    print(json.dumps({"mesh": mesh_out["numbers"], "device": smi}))
    print(json.dumps({"pool_mesh": pool_numbers, "device": smi}))
    print(json.dumps({"sp": sp_numbers, "device": smi}))
    print(json.dumps({"warmup": warm_numbers, "device": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
