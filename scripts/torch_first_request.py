#!/usr/bin/env python3
"""Where a scheduler's first request spends the time its second does not.

Builds the app's default scheduler (contiguous, 8 slots) over DUCKDB_NSQL_7B
at full width, cut to chip_smoke.py's FLEET_LAYERS (8) layers, random bf16
weights from seed 0, on one CUDA card; calls `warmup(len(prompt))` unless
`--no-warmup`; then serves chip_smoke.py's two phase 23 SQL prompts (one
length, no leading block shared) in turn, each under torch.profiler (CPU
and CUDA activities). Prints each request's TTFT under the profiler, the
caching allocators' growth during each, and the ops and CUDA runtime calls
whose host time differs most between the first request and the second:
the first-use costs the warmup left, or paid.

    python3 scripts/torch_first_request.py               # warmed
    python3 scripts/torch_first_request.py --no-warmup   # cold

Run each in a fresh process (the costs it looks for are paid once a
process). Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.serve import resolve_stop_ids
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg, params = cs.depth_cut(DUCKDB_NSQL_7B, init_params(
        DUCKDB_NSQL_7B, gen, torch.bfloat16, device="cuda"), cs.FLEET_LAYERS, clone=True)
    torch.cuda.empty_cache()
    tok = ByteTokenizer()
    sched = ContinuousBatchingScheduler(cfg, params, num_slots=cs.WARM_SLOTS,
                                        stop_ids=resolve_stop_ids(cfg, tok), device="cuda")
    prompts = cs.warm_prompts(tok)
    out = {"warmed": not args.no_warmup, "device": smi}
    if not args.no_warmup:
        t0 = time.perf_counter()
        sched.warmup(len(prompts[0]))
        torch.cuda.synchronize()
        out["warmup_s"] = round(time.perf_counter() - t0, 6)
    sched.start()
    tables, ttft, growth = [], [], []
    for p in prompts:
        seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        first = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_submit = time.perf_counter()
            fut = sched.submit(p, max_new_tokens=cs.MAX_NEW,
                               on_token=lambda _t: first or first.append(time.perf_counter()))
            fut.result(timeout=300)
            cs.wait_settled(sched)
            torch.cuda.synchronize()
        ttft.append(round(first[0] - t_submit, 6))
        growth.append(torch.cuda.memory_stats().get("segment.all.allocated", 0) - seg0)
        tables.append({e.key: (e.self_cpu_time_total, e.count) for e in prof.key_averages()})
    sched.shutdown()
    a, b = tables
    diff = sorted(((a.get(k, (0, 0))[0] - b.get(k, (0, 0))[0], k) for k in set(a) | set(b)),
                  reverse=True)
    out.update(ttft_profiled_s=ttft, new_segments=growth,
               first_minus_second_self_cpu_us=[
                   {"name": k, "us": round(d, 1), "calls": [a.get(k, (0, 0))[1],
                                                            b.get(k, (0, 0))[1]]}
                   for d, k in diff[:args.top]])
    for row in out["first_minus_second_self_cpu_us"]:
        print(f"  {row['us']:>12.1f} us  calls {row['calls']}  {row['name'][:90]}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
