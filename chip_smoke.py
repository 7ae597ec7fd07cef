#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py                # the whole run (one card)
    python3 chip_smoke.py --profile      # plus a torch.profiler breakdown
    python3 chip_smoke.py --timing-only  # phases 1, 2 and 11 alone
    python3 chip_smoke.py --sweep        # phases 1, 2, then the split sweep
    python3 chip_smoke.py --mixed-only   # phases 1, 2, then phase 6 (a) alone
    python3 chip_smoke.py --constrained-only  # phases 1, 2, 12, 7 and 8 (b)

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
7B and 3B weights, phase 6 (b)'s overcommit included.

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
   kv_overcommit 0.5, a burst of six 512-token requests, the last three
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
   (a) GGUF, the reference's deployment format, at full width and depth:
   LLAMA32_3B (28 layers, tied embeddings, llama3 rope scaling, so
   `rope_freqs.weight` is written) as a Q4_0 blob by the port's
   `write_gguf`. `load_gguf_checkpoint` must give the direct q4_0 -> f32
   -> bf16 round trip of the seed tree bit for bit (a second q4_0
   implementation on the card, `q4_0_round_trip`), and
   `SchedulerBackend.from_gguf(quantize_int4=True, kv_quant="int8",
   supervise=True)` (contiguous, 8 slots, max_seq 8192) the int4 tree of
   that round trip; three requests one after the other give the greedy
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
   --api --sql-model-path <(b)'s directory> --error-model-path <(a)'s
   blob>:<tokenizer directory>`, supervised by default, with a byte-level
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

Every phase prints its seconds.

Prints a `{"kernels": [...]}` line, then as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero, printing no result, without CUDA or without the package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
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
    return out


def check_kernels(torch, attn_mod):
    """Kernel vs plain on every case of `cases()` and, for the decode
    launch, of `decode_edge_cases()`, in each dtype; each decode case is
    launched twice and compared bit for bit. Returns the worst error per
    launch and dtype."""
    worst = {(l, d): 0.0 for l in ("prefill", "decode") for d in TOL}
    edges = [("decode", name, kw) for name, kw in decode_edge_cases()]
    for launch, name, kw in cases() + edges:
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
    ] + mixed_cases() + window_stress_cases()


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


def check_paged(torch, pa_mod):
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
               ("3b_chunk_t128", 2, 8, 128, 64, 8, 128, 128, 1027)]


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
    if "mixed" in name:
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


def check_write(torch, pw_mod):
    """Page write kernel into a bf16 or f32 pool vs plain, bit for bit, at
    every WRITE_CASES entry; the all-dropped round must leave the pools as
    they were, every other case must write."""
    dev = "cuda"
    worst = {d: 0.0 for d in TOL}
    for name, n_layers, kh, h, ps, b, t, np_tab, pages in WRITE_CASES:
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


def check_paged_quantized(torch, pa_mod):
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


def check_write_quantized(torch, pw_mod):
    """The page write kernel into an int8 pool vs plain, bit for bit in
    values and scales, at every WRITE_CASES entry (bf16 and f32 slivers; the
    all-dropped round writes nothing). Returns the worst error (0 when
    bit-exact) per dtype."""
    dev = "cuda"
    worst = {d: 0.0 for d in TOL}
    for name, n_layers, kh, h, ps, b, t, np_tab, pages in WRITE_CASES:
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
INT4_ROWS = (1, 4, 8, 9, 16, 131, 384, 1024, 2048)


def check_int4(torch, mm_mod):
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
        for rows in INT4_ROWS:
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


# Tokens each burst request decodes in the overcommit phase: at ratio 0.5
# the six admissions then take more pages than one max-length row (64 at
# max_seq 4096), the least pool the scheduler accepts.
OVERCOMMIT_NEW = 512


def burst(sched, prompts, max_new, constraints=None):
    """Submit `prompts` at once (a long GIL switch interval keeps the worker
    from admitting any before all are queued), request i under grammar
    `constraints[i]` when given, and return their tokens."""
    constraints = constraints or [None] * len(prompts)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(BURST_SWITCH_S)
    try:
        futs = [sched.submit(p, max_new_tokens=max_new, constraint=c)
                for p, c in zip(prompts, constraints)]
    finally:
        sys.setswitchinterval(switch)
    return [f.result(timeout=600) for f in futs]


def overcommit_serve(torch, engines, tally):
    """Overcommit at full width: the 7B paged bf16 scheduler (phase 6's
    settings, max_seq 4096) with kv_overcommit 0.5 over a pool that holds the six burst
    requests' admissions (prompt + half the 512-token budget) but not their
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
    eng = engines["duckdb-nsql"]
    cfg, n_layers = eng.cfg, eng.cfg.num_layers
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


def expect_paged(expected, sched, rounds, prefills):
    """Add a paged scheduler's launches to `expected`: its ragged attention
    (int8 pool: the quantized one) layers x (decode_chunk x rounds + ragged
    prefills) (a mixed round's first step is one of the rounds' steps; a
    ragged prefill is that step run alone), of which layers x (mixed rounds
    + ragged prefills) are query windows (T > 1, counted apart), its page
    write as many plus one a layer for each prefill forward (the chunk's
    window written back), the flash prefill layers x prefill forwards, and
    over int4 weights the int4 matmul 7 x layers x forwards."""
    n_layers = sched.cfg.num_layers
    q = "_quantized" if sched.kv_quant else ""
    steps = sched.decode_chunk * rounds + sched.ragged_prefills
    windows = sched.mixed_rounds + sched.ragged_prefills
    expected["ragged_paged_attention" + q] += n_layers * (steps - windows)
    expected["ragged_paged_window" + q] += n_layers * windows
    expected["fused_page_write" + q] += n_layers * (steps + prefills)
    expected["flash_gqa_prefill"] += n_layers * prefills
    if isinstance(sched.params["blocks"]["wq"], dict):
        expected["int4_matmul"] += 7 * n_layers * (steps + prefills)


def expect_contiguous(expected, sched, rounds, prefills):
    """Add a contiguous scheduler's launches to `expected`: its decode
    kernel (int8 cache: the quantized one) layers x decode_chunk x rounds,
    the flash prefill layers x prefill forwards, and over int4 weights the
    int4 matmul 7 x layers x forwards."""
    n_layers = sched.cfg.num_layers
    decode = "flash_gqa_decode_quantized" if sched.kv_quant else "flash_gqa_decode"
    expected[decode] += n_layers * sched.decode_chunk * rounds
    expected["flash_gqa_prefill"] += n_layers * prefills
    if isinstance(sched.params["blocks"]["wq"], dict):
        expected["int4_matmul"] += 7 * n_layers * (sched.decode_chunk * rounds + prefills)


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
    launches."""
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
    return launches, stream_generate(torch, svc, scheds, cfg)


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


def entry_point(torch, backend_args=("--backend", "tiny"), device_args=()):
    """The entry point as a user starts it, in a process of its own:
    `python -m <package>.app <backend_args> --api` (supervised contiguous
    schedulers on the card) over a temporary input directory; wait for
    `/healthz`, `/readyz` must answer `ready`, `POST /process-data/` once,
    then SIGTERM (the graceful drain), and the process must exit 0. Its
    launches are its own process's, outside every counted window."""
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
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
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
                        if json.loads(r.read()) == {"status": "ok"}:
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
        expected["int4_matmul"] += 7 * n_layers * st["forward_calls"]
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


def gguf_serve(torch, engines, root):
    """(a) GGUF, the reference's deployment format, at full width and depth:
    LLAMA32_3B's seed-0 bf16 tree written as a Q4_0 blob by the port's
    `write_gguf`, loaded by `SchedulerBackend.from_gguf(quantize_int4=True,
    kv_quant="int8", supervise=True)` (contiguous, 8 slots, max_seq 8192).
    The loaded tree must equal the direct round trip of the seed tree bit
    for bit, and requests through the loaded backend the tokens of a
    backend built from that round trip in memory. Returns (launches, blob)."""
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
    cfg, seed = engines["llama3.2"].cfg, engines["llama3.2"].params
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
    del loaded
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sb = SchedulerBackend.from_gguf(path, tok, quantize_int4=True, kv_quant="int8",
                                    supervise=True, num_slots=8, decode_chunk=8,
                                    device="cuda", max_new_tokens=MAX_NEW)
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
    print(f"  from_gguf(quantize_int4, kv int8, supervised) in "
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

        seen, stop = [], threading.Event()

        def poll():
            while not stop.is_set():
                st = sup.health()["state"]
                if not seen or seen[-1] != st:
                    seen.append(st)
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
    for s in incarnations[1:]:
        expect_contiguous(want, s, s.rounds_issued, s.prefill_forwards)
    h = sup.health()
    print(f"  burst of {len(prompts)} with one sched:crash: {wall:.3f} s; health states "
          f"{seen}; restarts {h['restarts']}, replayed {h['replayed']}, lost {h['lost']}; "
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


def checkpoints(torch, engines):
    """Phases 10-13: the checkpoint paths, over files written in a temporary
    directory that is removed afterwards. Returns the launch counts per
    path."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="lsot-checkpoints-")
    try:
        phase("checkpoint (a): GGUF Q4_0 3B -> from_gguf, int4 + int8 KV, supervised")
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
            entry_point(torch, ("--backend", "checkpoint", "--sql-model-path", hf_dir,
                                "--error-model-path", f"{blob}:{hf_dir}",
                                "--max-new-tokens", str(MAX_NEW)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"gguf_3b_int4_int8": gguf_launches, "hf_7b_bf16": hf_launches,
            "supervised_crash": crash_launches}


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


# --------------------------------------------------------------- profile


def profile_device(torch, label, send):
    """Device time by kernel group over `send()` (`--profile`), which
    returns the tokens it generated, and the device's busy share of its
    wall time under the profiler."""
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
              "int4 matmul": 0.0, "matmul": 0.0, "other": 0.0}
    for key, us, _ in rows:
        if "int4_" in key:
            groups["int4 matmul"] += us
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
               sweep_splits=None):
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
    size, forced through `window_split_plan`: {splits: ms}."""
    import torch.nn.functional as F

    dev, dt, layers = "cuda", torch.bfloat16, MIXED_TIMED_LAYERS
    ps, np_tab = 64, cfg.max_seq_len // 64
    n, kh, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rows = mixed_rows(t, np_tab * ps)
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


def time_int4(torch, mm_mod, cfg):
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
        for rows in INT4_TIME_ROWS:
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also trace one 7B engine request and a burst of 7B "
                         "scheduler requests with torch.profiler")
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
    args = ap.parse_args()

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
    app_launches, stream_launches = app_serve(torch, contig_scheds)
    phase("app under LSOT_CONSTRAIN_SQL=1 (phase 8 (b))")
    constrained_app_launches = constrained_app(torch, contig_scheds, tally, smi)
    for sc in contig_scheds.values():
        sc.shutdown()
    del contig_scheds
    gc.collect()  # the app's reference cycles hold the caches until collected
    entry_point(torch)

    phase("serve (quantized path: int4 weights, int8 KV)")
    q_launches, params4 = quantized_serve(torch, engines, args.profile)

    constrained_launches = constrained_paths(torch, engines, params4, tally, smi)
    del params4
    constrained_launches["constrained_app"] = constrained_app_launches
    tally.summary()

    ckpt_launches = checkpoints(torch, engines)

    phase("timing")
    assert engines["duckdb-nsql"].cfg == DUCKDB_NSQL_7B
    del engines
    torch.cuda.empty_cache()
    timed = timing(torch, attn_mod, pa_mod, pw_mod, mm_mod, DUCKDB_NSQL_7B)
    errors = {
        "prefill": {d: worst[("prefill", d)] for d in TOL},
        "decode": {d: worst[("decode", d)] for d in TOL},
        **worst_paged,
        "write": write_err,
        **errors_q,
        "int4": {d: int4_err[d][0] for d in TOL},
    }
    names = {"prefill": "flash_gqa_attention_prefill",
             "decode": "flash_gqa_attention_decode",
             "paged": "ragged_paged_attention",
             "paged_window": "ragged_paged_attention_window",
             "write": "fused_page_write",
             "decode_q": "flash_gqa_attention_quantized",
             "paged_q": "ragged_paged_attention_quantized",
             "paged_q_window": "ragged_paged_attention_quantized_window",
             "write_q": "fused_page_write_quantized", "int4": "int4_matmul"}
    counters = {"prefill": "flash_gqa_prefill", "decode": "flash_gqa_decode",
                "paged": "ragged_paged_attention", "paged_window": "ragged_paged_window",
                "write": "fused_page_write",
                "decode_q": "flash_gqa_decode_quantized",
                "paged_q": "ragged_paged_attention_quantized",
                "paged_q_window": "ragged_paged_window_quantized",
                "write_q": "fused_page_write_quantized", "int4": "int4_matmul"}
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
             **ckpt_launches, **constrained_launches}
    window_tol = {"bfloat16": TOL["bfloat16"], "bfloat16_max_row_rel": WINDOW_ROW_TOL}
    tolerance = {"paged_window": window_tol, "paged_q_window": window_tol,
                 "write": {"bfloat16": 0.0, "float32": 0.0},
                 "write_q": {"bfloat16": 0.0, "float32": 0.0},
                 "int4": {f"{d}_over_max_abs_out": v for d, v in INT4_TOL.items()}}
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
        if "by_shape" in tm:
            entry["by_shape"] = tm["by_shape"]
        if launch.endswith("_window"):
            # bf16 only: f32 windows run the tile kernel, recorded apart.
            entry["max_row_rel_err_by_dtype"] = errors[launch + "_rel"]
            entry["float32_windows"] = {"source": f"{PKG}/csrc/gqa_tile.cuh",
                                        "max_abs_err": errors[launch + "_tile"]["float32"]}
        kernels.append(entry)
    phase(None)
    print(f"  phase seconds: {json.dumps(_PHASE['seconds'])}", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
