#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py                # the whole run (one card)
    python3 chip_smoke.py --profile      # plus a torch.profiler breakdown
    python3 chip_smoke.py --timing-only  # phases 1, 2 and 8 alone

`--timing-only` times the package that sits beside this file, so a copy of
this file placed in an unpacked archive of another commit times that
commit's kernels at the same shapes (for comparing two commits in one
call, in turns).

Phases, each fatal on failure:

1. Device: requires CUDA; prints the card's name and power limit as
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them.
2. Build: compiles every `csrc/*.cu` of the port with nvcc (one process per
   source, all at once) and prints the build seconds and, for each kernel,
   ptxas's register, shared-memory and spill lines.
3. Kernels against their plain versions, in bf16 and f32:
   - both launches of the flash GQA attention kernel (prefill T > 1, decode
     T == 1; bf16 prefill runs the tensor-core kernel) at the engine path's
     shapes (duckdb-nsql-7B: N = K = 32; llama3.2-3B: N = 24, K = 8; both
     H = 128), llama3.2-1B (H = 64), a Mistral window of 4096 over S =
     8192, a row with kv_lens = 0, ragged last KV tiles and NaN planted in
     dead cache slots; prefill chunks of T = 100 and 37 (no multiple of 64)
     over S = 1024 with ragged starts, windows, kv_lens = 0 and NaN past the
     live length; and the prefill launch at the scheduler's chunked-prefill
     shapes (7B and 3B, groups of 6-8 rows, buckets of 128, 32 and 16 over
     S = 1024 row views, chunk starts after prefix reuse that end mid-page,
     default kv_lens);
   - the ragged paged attention kernel at the 7B, 3B and 1B shapes, T = 1,
     B = 8 as the scheduler's slots, through permuted tables with sentinel
     entries, parked rows (all-sentinel, kv_lens = 0) and NaN planted in
     dead offsets and unmapped pages; windows T = 8 and 32 with ragged
     q_lens, a G*T = 512 window, pages of 16 and 64, a Mistral window;
   - the fused page write, bit-exact: T = 1 at B = 8 into the 7B
     scheduler's pool (32 layers, 128 pages of 64, tables of 16 pages) at
     its last layer with parked rows, and T = 4 with q_lens and sentinel
     rows;
   - the quantized serving path's four kernels: the quantized decode
     attention at the decode cases above over an int8 cache (NaN in dead
     scales), the quantized ragged paged attention at the paged cases above
     over int8 pools, the quantizing page write bit-exact (values and
     scales) into the 7B int8 pool's shape, and the int4 matmul at every 7B
     and 3B weight shape (wd's group of 86 included) and at OUT = 400 (no
     multiple of a column tile) at R = 1, 4, 8, 9, 16, 131, 384, 1024 and
     2048 (4 and 2048 are the engine batch's decode and prefill; 8 and 9
     straddle the decode / prefill crossover).
4. Small references, 2-layer f32 models (H = 64): greedy tokens through the
   kernels on the card must equal the plain versions' on the CPU, for the
   engine and for the paged scheduler (page 16, shared prefixes); then the
   same with int4 weights and the int8 KV cache.
5. Engine serve: a GenerationService with EngineBackends for `duckdb-nsql`
   (DUCKDB_NSQL_7B, full width and depth) and `llama3.2` (LLAMA32_3B on the
   llama3-chat template), random bf16 weights from a seed, ByteTokenizer.
   Three NL->SQL requests with a table schema in `system`, one batch of four
   mixed-length prompts, one error explanation. Launch counts are zeroed
   just before and read just after; each flash launch must number
   num_layers x (prefill calls + decode steps). Prefill logits through the
   kernel must agree with the plain version's.
6. Scheduler serve: the same weights behind paged continuous-batching
   schedulers (8 slots, pages of 64, decode_chunk 8, max_seq 1024) and
   SchedulerBackends. Two NL->SQL requests one after the other, then six at
   once from threads while a 3B error explanation runs. Launch counts are
   zeroed just before and read just after: ragged paged attention and page
   writes must number num_layers x decode_chunk x rounds issued, flash
   prefill num_layers x prefill forwards. The prefix cache must hit, share
   pages and leak none; one decode step on the live pool through the
   kernels must agree with the plain versions, at full depth in bf16 and
   on an f32 copy of two layers, and a one-page fault planted on the plain
   side must miss by more than each tolerance.
   With --profile, one 7B engine request and six concurrent 7B scheduler
   requests run under torch.profiler: device busy share and device time
   by kernel group.
7. Quantized serve: DUCKDB_NSQL_7B at full width and depth with int4 block
   weights (`quantize_params_int4` of the seed-0 bf16 tree, on the card)
   and the int8 KV cache: an `EngineBackend` over an
   `InferenceEngine(kv_quant="int8")` serves two NL->SQL requests and a
   batch of four, then a `SchedulerBackend` over a paged
   `ContinuousBatchingScheduler(kv_quant="int8")` (settings of phase 6)
   two requests one after the other and six at once. Launch counts exact:
   int4 matmuls 7 x layers x forwards (one launch a call: a split of the
   contraction axis is added up inside a thread-block cluster), quantized
   decode attention layers x engine decode steps, quantized paged read and
   write layers x decode_chunk x rounds, flash prefill layers x prefill
   forwards. Prefill logits through the kernels agree with the plain
   versions'; the prefix
   cache hits, shares and leaks no page; the live int8 pool's decode step
   is checked as in phase 6. With --profile, six concurrent requests under
   torch.profiler.
8. Timing at the main paths' shapes (one CUDA graph of one call per layer,
   each on its own layer so K/V and weights come from device memory,
   replayed between CUDA events): kernel, plain version and a PyTorch
   yardstick the port never calls (`scaled_dot_product_attention`, over
   K/V dequantized in advance for the int8 caches; for the page writes,
   `index_put_` of the same slivers, quantized in advance; for the int4
   matmul, `torch.matmul` against the weight dequantized to bf16 in
   advance: the bf16 product, moving 4x the weight bytes, since no PyTorch
   call computes the int4 function). The flash prefill at the 7B prompt
   and at the scheduler's prefill chunk (B = 8, T = 128, S = 1024); the
   int4 matmul for 7B's `wq` and `wd` at R = 1, 4, 8 (decode) and 1024 (a
   prefill chunk). The bound is the larger of the bytes over 3.35 TB/s
   and the FLOPs over 989 TFLOP/s (H100 SXM, bf16 dense).

Every phase prints its seconds.

Prints a `{"kernels": [...]}` line, then as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero, printing no result, without CUDA or without the package.
"""

from __future__ import annotations

import argparse
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
    "decode": f"{PKG}/csrc/flash_gqa_attention.cu",
    "paged": f"{PKG}/csrc/ragged_paged_attention.cu",
    "write": f"{PKG}/csrc/fused_page_write.cu",
    "decode_q": f"{PKG}/csrc/flash_gqa_attention_quantized.cu",
    "paged_q": f"{PKG}/csrc/ragged_paged_attention_quantized.cu",
    "write_q": f"{PKG}/csrc/fused_page_write_quantized.cu",
    "int4": f"{PKG}/csrc/int4_matmul.cu",
}
REPLACES = {
    "prefill": f"{REF}/attention.py:428",
    "decode": f"{REF}/attention.py:313",
    "paged": f"{REF}/paged_attention.py:225",
    "write": f"{REF}/paged_write.py:191",
    # The quantized twins share their pallas_call lines with rows 2 and 4
    # (attention.py:313, paged_attention.py:225): their wrappers name them.
    "decode_q": f"{REF}/attention.py:453",
    "paged_q": f"{REF}/paged_attention.py:304",
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
    return out


def check_kernels(torch, attn_mod):
    """Kernel vs plain on every case and dtype; returns the worst error per
    launch and dtype."""
    worst = {(l, d): 0.0 for l in ("prefill", "decode") for d in TOL}
    for launch, name, kw in cases():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            c = make_case(torch, dtype, **kw)
            args = (c["q"], c["k"], c["v"], c["pos"], c["window"], c["kv_lens"])
            out = attn_mod.flash_gqa_attention_cuda(*args)
            ref = attn_mod.flash_gqa_attention_plain(*args)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"{launch}/{name}/{dname}: non-finite"
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= TOL[dname]
            print(f"  {launch:7s} {name:16s} {dname:8s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:.0e} {'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"{launch}/{name}/{dname}: {err} > {TOL[dname]}"
            if c["kv_lens"] is not None and (c["kv_lens"] == 0).any():
                zero_rows = out[c["kv_lens"] == 0]
                assert (zero_rows == 0).all(), "kv_lens=0 row is not exact zeros"
            worst[(launch, dname)] = max(worst[(launch, dname)], err)
    return worst


def paged_case(torch, dtype, b, t, n, kh, h, ps, np_tab, rows, window=None):
    """A ragged paged attention case on the card. `rows` gives per row
    (start, q_len, kv_len): live columns sit at start + i, dead columns at
    junk positions. Pages are a random permutation of the pool; entries
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
    pos = torch.full((b, t), np_tab * ps - 1, dtype=torch.int32, device=dev)
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
    ]


def check_paged(torch, pa_mod):
    """Ragged paged attention kernel vs plain on every case and dtype;
    returns the worst error per dtype."""
    worst = {d: 0.0 for d in TOL}
    for name, kw in paged_cases():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            args = paged_case(torch, dtype, b=len(kw["rows"]), **kw)
            out = pa_mod.ragged_paged_attention_cuda(*args)
            ref = pa_mod.ragged_paged_attention_plain(*args)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"paged/{name}/{dname}: non-finite"
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= TOL[dname]
            print(f"  paged   {name:16s} {dname:8s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:.0e} {'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"paged/{name}/{dname}: {err} > {TOL[dname]}"
            for i, (_, ql, kvl) in enumerate(kw["rows"]):
                dead = out[i] if kvl == 0 else out[i, ql:]
                assert (dead == 0).all(), f"paged/{name}: row {i} not exact zeros"
            worst[dname] = max(worst[dname], err)
    return worst


def check_write(torch, pw_mod):
    """Fused page write kernel vs plain, bit for bit: T = 1 at B = 8 into
    the 7B scheduler's pool (L = 32, P = 128 pages of 64, tables of 16
    pages) at its last layer, two slots parked at the last position behind
    all-sentinel rows; and T = 4 with q_lens, a sentinel row and a
    past-the-row position (3B shapes)."""
    dev = "cuda"
    worst = {d: 0.0 for d in TOL}
    # (name, layers, kv heads, page size, B, T, table pages, pool pages)
    cases = [("7b_t1_b8", 32, 32, 64, 8, 1, 16, 128),
             ("3b_t4_qlens", 28, 8, 16, 4, 4, 16, 66)]
    for name, n_layers, kh, ps, b, t, np_tab, pages in cases:
        layer = n_layers - 1
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(3)
            shape = (n_layers, pages, kh, ps, 128)
            kk = torch.randn(shape, generator=g, device=dev, dtype=dtype)
            vk = torch.randn(shape, generator=g, device=dev, dtype=dtype)
            kr, vr, before = kk.clone(), vk.clone(), kk[layer].clone()
            k_new = torch.randn((b, t, kh, 128), generator=g, device=dev).to(dtype)
            v_new = torch.randn_like(k_new)
            tab = torch.randperm(pages, generator=g, device=dev)[: b * np_tab]
            tab = tab.reshape(b, np_tab).int()
            starts = torch.randint(0, np_tab * ps - t, (b, 1), generator=g,
                                   device=dev)
            pos = (starts + torch.arange(t, device=dev)).int()
            q_lens = None
            if t > 1:
                tab[1] = pages           # a parked row: all sentinel
                pos[2, -1] = np_tab * ps  # past the row: dropped
                q_lens = torch.tensor([t, 1, t, 2], dtype=torch.int32, device=dev)
            else:
                for i in (2, 6):         # parked slots, as a decode round has
                    tab[i] = pages
                    pos[i] = np_tab * ps - 1
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
            assert same and wrote, f"write/{name}: kernel != plain"
            worst[dname] = max(worst[dname], err)
    return worst


def quantize(torch, x):
    """(int8 values, f32 scales) of K/V [..., H], the port's quantize_kv:
    NaN planted in x comes out as NaN scales (and junk values) there."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_kv

    q = quantize_kv(x)
    return q["q8"], q["s"]


def check_kernels_quantized(torch, attn_mod):
    """The quantized decode attention kernel vs plain on the decode cases of
    `cases()` over an int8 cache (NaN planted in the dead slots' scales);
    returns the worst error per dtype."""
    worst = {d: 0.0 for d in TOL}
    for launch, name, kw in cases():
        if launch != "decode":
            continue
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            c = make_case(torch, dtype, **kw)
            k8, ks = quantize(torch, c["k"])
            v8, vs = quantize(torch, c["v"])
            args = (c["q"], k8, ks, v8, vs, c["pos"], c["window"], c["kv_lens"])
            out = attn_mod.flash_gqa_attention_quantized_cuda(*args)
            ref = attn_mod.flash_gqa_attention_quantized_plain(*args)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"decode_q/{name}/{dname}: non-finite"
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= TOL[dname]
            print(f"  decode_q {name:15s} {dname:8s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:.0e} {'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"decode_q/{name}/{dname}: {err} > {TOL[dname]}"
            if c["kv_lens"] is not None and (c["kv_lens"] == 0).any():
                assert (out[c["kv_lens"] == 0] == 0).all(), "kv_lens=0 row is not zeros"
            worst[dname] = max(worst[dname], err)
    return worst


def check_paged_quantized(torch, pa_mod):
    """The quantized ragged paged attention kernel vs plain on every paged
    case, the pools quantized after the NaN was planted (so the dead
    offsets and unmapped pages carry NaN scales); returns the worst error
    per dtype."""
    worst = {d: 0.0 for d in TOL}
    for name, kw in paged_cases():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q, kp, vp, tab, pos, window, kvl, qln = paged_case(
                torch, dtype, b=len(kw["rows"]), **kw)
            kp8, kps = quantize(torch, kp)
            vp8, vps = quantize(torch, vp)
            del kp, vp
            args = (q, kp8, kps, vp8, vps, tab, pos, window, kvl, qln)
            out = pa_mod.ragged_paged_attention_quantized_cuda(*args)
            ref = pa_mod.ragged_paged_attention_quantized_plain(*args)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all(), f"paged_q/{name}/{dname}: non-finite"
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= TOL[dname]
            print(f"  paged_q {name:16s} {dname:8s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:.0e} {'ok' if ok else 'FAIL'}", flush=True)
            assert ok, f"paged_q/{name}/{dname}: {err} > {TOL[dname]}"
            for i, (_, ql, kvl_i) in enumerate(kw["rows"]):
                dead = out[i] if kvl_i == 0 else out[i, ql:]
                assert (dead == 0).all(), f"paged_q/{name}: row {i} not exact zeros"
            worst[dname] = max(worst[dname], err)
    return worst


def check_write_quantized(torch, pw_mod):
    """The quantizing page write kernel vs plain, bit for bit in values and
    scales: T = 1 at B = 8 into the 7B int8 pool's shape (L = 32, P = 128
    pages of 64, tables of 16 pages) at its last layer, two slots parked;
    and T = 4 with q_lens, a parked row and a past-the-row position (3B
    shapes). Returns the worst error (0 when bit-exact) per dtype."""
    dev = "cuda"
    worst = {d: 0.0 for d in TOL}
    cases = [("7b_t1_b8", 32, 32, 64, 8, 1, 16, 128),
             ("3b_t4_qlens", 28, 8, 16, 4, 4, 16, 66)]
    for name, n_layers, kh, ps, b, t, np_tab, pages in cases:
        layer = n_layers - 1
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(3)
            shape = (n_layers, pages, kh, ps, 128)
            pools = [torch.randint(-127, 128, shape, generator=g, device=dev,
                                   dtype=torch.int8),
                     torch.rand(shape[:4], generator=g, device=dev),
                     torch.randint(-127, 128, shape, generator=g, device=dev,
                                   dtype=torch.int8),
                     torch.rand(shape[:4], generator=g, device=dev)]
            refs = [x.clone() for x in pools]
            before = pools[0][layer].clone()
            k_new = torch.randn((b, t, kh, 128), generator=g, device=dev).to(dtype)
            v_new = torch.randn((b, t, kh, 128), generator=g, device=dev).to(dtype)
            tab = torch.randperm(pages, generator=g, device=dev)[: b * np_tab]
            tab = tab.reshape(b, np_tab).int()
            starts = torch.randint(0, np_tab * ps - t, (b, 1), generator=g, device=dev)
            pos = (starts + torch.arange(t, device=dev)).int()
            q_lens = None
            if t > 1:
                tab[1] = pages
                pos[2, -1] = np_tab * ps
                q_lens = torch.tensor([t, 1, t, 2], dtype=torch.int32, device=dev)
            else:
                for i in (2, 6):
                    tab[i] = pages
                    pos[i] = np_tab * ps - 1
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
            assert same and wrote, f"write_q/{name}: kernel != plain"
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
    engine, and the paged scheduler (8-token prefix blocks in 16-token
    pages, prompts that share a 41-token prefix: the cache hits, and copies
    the page where the match ends mid-page). `quantized`: int4 block
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
    outs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        with ContinuousBatchingScheduler(
                cfg, params, num_slots=4, decode_chunk=4, prompt_bucket=8,
                stop_ids=(-1,), kv_page_size=16, kv_quant=kv_quant, device=dev) as s:
            seq = [s.submit(p, 16).result(timeout=600) for p in sched_prompts[:3]]
            futs = [s.submit(p, 16) for p in sched_prompts]
            outs[dev] = seq + [f.result(timeout=600) for f in futs]
            hits, cow = s.prefix_stats["hits"], s.page_stats["cow_copies"]
        print(f"  [{label}] scheduler {dev}: prefix hits {hits}, cow copies {cow}: "
              f"{outs[dev]}", flush=True)
    assert outs["cuda"] == outs["cpu"], f"[{label}] scheduler on the card != on the CPU"
    assert hits > 0 and cow > 0, f"[{label}] the small scheduler's prefix cache never hit"


# ----------------------------------------------------------------- serve

SCHEMA = "\n".join(f"{c} ({t})" for c, t in [
    ("trip_id", "bigint"), ("pickup_datetime", "timestamp"),
    ("dropoff_datetime", "timestamp"), ("passenger_count", "int"),
    ("trip_distance", "double"), ("pickup_zone", "string"),
    ("dropoff_zone", "string"), ("payment_type", "string"),
    ("fare_amount", "double"), ("tip_amount", "double"),
    ("total_amount", "double"),
])
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
SCHED = dict(num_slots=8, max_seq=1024, decode_chunk=8, kv_page_size=64)


def serve(torch):
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.models import (
        DUCKDB_NSQL_7B,
        LLAMA32_3B,
    )
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import (
        forward,
        init_params,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
        set_attention_impl,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        EngineBackend,
        GenerationService,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    t0 = time.perf_counter()
    engines = {}
    for name, cfg in (("duckdb-nsql", DUCKDB_NSQL_7B), ("llama3.2", LLAMA32_3B)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(cfg, gen, torch.bfloat16, device="cuda")
        engines[name] = InferenceEngine(cfg, params, device="cuda",
                                        stop_ids=resolve_stop_ids(cfg, tok))
    torch.cuda.synchronize()
    print(f"  weights made on the card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)

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
              f"max_seq {sc.max_seq}", flush=True)

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
        n_layers = sc.cfg.num_layers
        rounds = sc.rounds_issued - start[n][0]
        prefills = sc.prefill_forwards - start[n][1]
        for k in ("ragged_paged_attention", "fused_page_write"):
            expected[k] += n_layers * sc.decode_chunk * rounds
        expected["flash_gqa_prefill"] += n_layers * prefills
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


def quantized_serve(torch, engines, profile=False):
    """The quantized serving path: DUCKDB_NSQL_7B at full width and depth
    with int4 block weights quantized on the card from the seed-0 bf16 tree,
    and the int8 KV cache, behind an EngineBackend and a paged
    SchedulerBackend. Exact launch counts, prefill logits kernel vs plain,
    prefix sharing with no leaked page, the live int8 pool's decode step.
    Returns the launch counts per path."""
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
    for k in ("ragged_paged_attention_quantized", "fused_page_write_quantized"):
        want[k] = n_layers * sched.decode_chunk * rounds
    want["flash_gqa_prefill"] = n_layers * prefills
    want["int4_matmul"] = 7 * n_layers * (sched.decode_chunk * rounds + prefills)
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
    return {"engine": engine_launches, "scheduler": sched_launches}


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
        elif "gqa_tile" in key or "flash_prefill" in key:
            groups["flash attention"] += us
        elif "fused_page_write" in key:
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


def time_launch(torch, attn_mod, n, kh, h, layers, b, t, s, positions):
    """Kernel, plain and SDPA times on one layer's shapes, cycling over a
    [layers, B, K, S, H] cache so reads come from device memory."""
    import torch.nn.functional as F

    dev, dt = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, t, n, h), generator=g, device=dev).to(dt)
    kc = torch.randn((layers, b, kh, s, h), generator=g, device=dev).to(dt)
    vc = torch.randn((layers, b, kh, s, h), generator=g, device=dev).to(dt)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    kvl = pos.max(dim=1).values + 1
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
                shape=dict(B=b, T=t, N=n, K=kh, S=s, H=h, dtype="bfloat16"))


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
    ms = time_ms(torch, lambda l: pw_mod.fused_page_write_cuda(
        kp, vp, kn, vn, pos, tab, l), n_layers)
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
                 shape=dict(B=b, T=1, K=kh, H=h, page=ps, dtype="bfloat16"))
    return paged, write


def time_decode_quantized(torch, attn_mod, n, kh, h, layers, s, position):
    """The quantized decode launch at the engine's 7B decode (B = 1): kernel,
    plain and SDPA over K/V dequantized to bf16 in advance, cycling over an
    int8 [layers, 1, K, S, H] cache so reads come from device memory."""
    import torch.nn.functional as F

    dev, dt = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((1, 1, n, h), generator=g, device=dev).to(dt)
    k8, ks = quantize(torch, torch.randn((layers, 1, kh, s, h), generator=g, device=dev))
    v8, vs = quantize(torch, torch.randn((layers, 1, kh, s, h), generator=g, device=dev))
    pos = torch.tensor([[position]], dtype=torch.int32, device=dev)
    kvl = pos[:, 0] + 1
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
    live = position + 1
    b_ms, b_by = bound(2 * 2 * q.numel() + live * kh * (2 * h + 8), 4 * h * live * n)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                shape=dict(B=1, T=1, N=n, K=kh, S=s, H=h, kv_len=live, dtype="bfloat16",
                           cache="int8"))


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
    ms = time_ms(torch, lambda l: pw_mod.fused_page_write_quantized_cuda(
        *pools, kn, vn, pos, tab, l), n_layers)
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
                 shape=dict(B=b, T=1, K=kh, H=h, page=ps, dtype="bfloat16", pool="int8"))
    return paged, write


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
    timed = {
        "prefill": dict(prefill["7b_prompt"], by_shape=prefill),
        "decode": time_launch(torch, attn_mod, n, kh, h, n_layers, 1, 1, s,
                              [[n_prompt + MAX_NEW // 2]]),
        "decode_q": time_decode_quantized(torch, attn_mod, n, kh, h, n_layers, s,
                                          n_prompt + MAX_NEW // 2),
    }
    timed["paged"], timed["write"] = time_paged(torch, pa_mod, pw_mod, cfg)
    timed["paged_q"], timed["write_q"] = time_paged_quantized(torch, pa_mod, pw_mod, cfg)
    int4_times = time_int4(torch, mm_mod, cfg)
    timed["int4"] = dict(int4_times["wd_R8"], by_shape=int4_times)
    for launch, tm in timed.items():
        for label, t_ in (tm.get("by_shape") or {launch: tm}).items():
            host = (f", host {t_['host_us_per_call']:.1f} us a call"
                    if "host_us_per_call" in t_ else "")
            print(f"  {label}: kernel {t_['ms']:.4f} ms, plain {t_['plain_ms']:.4f} ms, "
                  f"library {t_['library_ms']:.4f} ms, bound {t_['bound_ms']:.5f} ms "
                  f"({t_['bound_by']}){host} at {t_['shape']}", flush=True)
    return timed


# ------------------------------------------------------------------ main


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also trace one 7B engine request and a burst of 7B "
                         "scheduler requests with torch.profiler")
    ap.add_argument("--timing-only", action="store_true",
                    help="build and run the timing phase alone (no checks; "
                         "prints the times and no ok line)")
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
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line:  # the mangled kernel name
                print(f"  {name}: {line.split(chr(39))[1][:120]}")
            elif "Used" in line or "spill" in line and " 0 bytes spill" not in line:
                print(f"  {name}:   {line.strip()}")
    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int4mm as mm_mod

    if args.timing_only:
        phase("timing")
        timed = timing(torch, attn_mod, pa_mod, pw_mod, mm_mod, DUCKDB_NSQL_7B)
        phase(None)
        print(json.dumps({"timing": timed, "device": smi}))
        return 0

    phase("kernels vs plain")
    worst = check_kernels(torch, attn_mod)
    worst_paged = check_paged(torch, pa_mod)
    write_err = check_write(torch, pw_mod)
    errors_q = {"decode_q": check_kernels_quantized(torch, attn_mod),
                "paged_q": check_paged_quantized(torch, pa_mod),
                "write_q": check_write_quantized(torch, pw_mod)}
    int4_err = check_int4(torch, mm_mod)

    phase("small reference")
    small_reference(torch)
    small_reference(torch, quantized=True)

    phase("serve (engine path)")
    launches, engines, svc = serve(torch)
    if args.profile:
        phase("profile (engine path)")
        profile_device(torch, "one 7B engine request", lambda: svc.generate(
            "duckdb-nsql", QUESTIONS[0], system=SYSTEM_SQL).output_tokens)
    del svc

    phase("serve (scheduler path)")
    sched_launches = scheduler_serve(torch, engines, args.profile)

    phase("serve (quantized path: int4 weights, int8 KV)")
    q_launches = quantized_serve(torch, engines, args.profile)

    phase("timing")
    assert engines["duckdb-nsql"].cfg == DUCKDB_NSQL_7B
    del engines
    torch.cuda.empty_cache()
    timed = timing(torch, attn_mod, pa_mod, pw_mod, mm_mod, DUCKDB_NSQL_7B)
    errors = {
        "prefill": {d: worst[("prefill", d)] for d in TOL},
        "decode": {d: worst[("decode", d)] for d in TOL},
        "paged": worst_paged,
        "write": write_err,
        **errors_q,
        "int4": {d: int4_err[d][0] for d in TOL},
    }
    names = {"prefill": "flash_gqa_attention_prefill",
             "decode": "flash_gqa_attention_decode",
             "paged": "ragged_paged_attention", "write": "fused_page_write",
             "decode_q": "flash_gqa_attention_quantized",
             "paged_q": "ragged_paged_attention_quantized",
             "write_q": "fused_page_write_quantized", "int4": "int4_matmul"}
    counters = {"prefill": "flash_gqa_prefill", "decode": "flash_gqa_decode",
                "paged": "ragged_paged_attention", "write": "fused_page_write",
                "decode_q": "flash_gqa_decode_quantized",
                "paged_q": "ragged_paged_attention_quantized",
                "write_q": "fused_page_write_quantized", "int4": "int4_matmul"}
    paths = {"engine": launches, "scheduler": sched_launches,
             "quantized_engine": q_launches["engine"],
             "quantized_scheduler": q_launches["scheduler"]}
    tolerance = {"write": {"bfloat16": 0.0, "float32": 0.0},
                 "write_q": {"bfloat16": 0.0, "float32": 0.0},
                 "int4": {f"{d}_over_max_abs_out": v for d, v in INT4_TOL.items()}}
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
        if launch == "int4":
            entry["max_rel_err_by_dtype"] = {d: int4_err[d][1] for d in TOL}
        if "by_shape" in tm:
            entry["by_shape"] = tm["by_shape"]
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
