#!/usr/bin/env python3
"""Time the PyTorch port's schedulers issuing together on one CUDA card, with
and without the per-device dispatch lock (`serve/scheduler.dispatch_lock`).

Three paged schedulers, as a pool's replicas are (two over one DUCKDB_NSQL_7B
bf16 tree, one over LLAMA32_3B; random weights from seed 0, 2 slots, 32 new
tokens), each serve two requests (the 7B ones chip_smoke.py's SQL prompts,
the 3B one its error explanation) at once, in turns: under the lock, with
each scheduler's lock detached, detached, under the lock; then the first 7B
scheduler alone. Each side is timed twice per turn. The lock changes no
arithmetic, only when each scheduler issues: a request admitted in another
prefill group than in the other side's run can leave its stream at a
near-tie of the random weights, so the line counts the streams that are
equal between the sides' first runs.

Then chip_smoke.py's phases 6, 7 and 8 (the paged and the contiguous
7B + 3B scheduler paths and the app over the contiguous ones, each with its
own checks), once to warm, then in turns under the lock and with every
scheduler they build detached from it: locked, detached, detached, locked.

    python3 scripts/torch_dispatch_contention.py   # on a host with a CUDA card

Prints the card's name and power limit, then one JSON line of walls.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from llm_based_apache_spark_optimization_tpu_torch.models import (
        DUCKDB_NSQL_7B,
        LLAMA32_3B,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import _build
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        resolve_stop_ids,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as sched_mod
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import dispatch_lock
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _build.build_all()
    engines = cs.make_engines(torch, (("duckdb-nsql", DUCKDB_NSQL_7B),
                                      ("llama3.2", LLAMA32_3B)))
    tok = ByteTokenizer()
    e7, e3 = engines["duckdb-nsql"], engines["llama3.2"]
    p7 = [tok.encode(f"{cs.SYSTEM_SQL}\n\n{q}") for q in cs.SCHED_SQL[:4]]
    p3 = [tok.encode(f"{cs.SYSTEM_ERR}\n\n{cs.ERROR_PROMPT}")] * 2

    def make(e, gib):
        return ContinuousBatchingScheduler(
            e.cfg, e.params, num_slots=2, stop_ids=resolve_stop_ids(e.cfg, tok),
            kv_layout="paged", kv_hbm_budget_bytes=gib * 2**30, device="cuda").start()

    scheds = [make(e7, 12), make(e7, 12), make(e3, 4)]
    work = list(zip(scheds, (p7[:2], p7[2:], p3)))

    def timed(pairs):
        t = time.perf_counter()
        futs = [s.submit(p, max_new_tokens=32) for s, ps in pairs for p in ps]
        outs = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        return time.perf_counter() - t, outs

    def side(locked):
        for s in scheds:
            s._dispatch_lock = (dispatch_lock(s.device) if locked
                                else contextlib.nullcontext())
        return [timed(work) for _ in range(2)]

    try:
        timed(work)  # warm: first calls of every shape
        turns = {"locked": [], "detached": []}
        outs = {}
        for name in ("locked", "detached", "detached", "locked"):
            for wall, out in side(name == "locked"):
                turns[name].append(round(wall, 4))
                outs.setdefault(name, out)
        lone = [round(timed(work[:1])[0], 4) for _ in range(2)]
        same = sum(a == b for a, b in zip(outs["locked"], outs["detached"]))
    finally:
        for s in scheds:
            s.shutdown()
    del scheds, work
    gc.collect()
    torch.cuda.empty_cache()

    def phases(locked):
        """Phases 6-8 once; every scheduler they build takes the lock or not."""
        sched_mod.dispatch_lock = (dispatch_lock if locked
                                   else lambda device: contextlib.nullcontext())
        walls = {}
        try:
            t = time.perf_counter()
            cs.scheduler_serve(torch, engines)
            walls["6_paged_scheduler"] = round(time.perf_counter() - t, 4)
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            _, contig = cs.contiguous_serve(torch, engines)
            walls["7_contiguous_scheduler"] = round(time.perf_counter() - t, 4)
            t = time.perf_counter()
            _, _, svc = cs.app_serve(torch, contig)
            walls["8_app"] = round(time.perf_counter() - t, 4)
            del svc
            for s in contig.values():
                s.shutdown()
            del contig
        finally:
            sched_mod.dispatch_lock = dispatch_lock
        gc.collect()
        torch.cuda.empty_cache()
        return walls

    phases(True)  # warm
    phase_turns = {"locked": [], "detached": []}
    for name in ("locked", "detached", "detached", "locked"):
        phase_turns[name].append(phases(name == "locked"))
    print(json.dumps({"dispatch_contention": {
        "three_schedulers_two_requests_each_s": turns, "lone_7b_two_requests_s": lone,
        "streams_equal": f"{same} of {len(outs['locked'])}",
        "phases_6_to_8_s": phase_turns}, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
