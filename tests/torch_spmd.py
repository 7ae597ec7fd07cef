"""Process groups for the port's parallel tests, on the CPU over gloo.

`run_group(world, fn, tmp_path, payload)` spawns `world` processes
(`torch.multiprocessing`, "spawn"), joins them into one gloo group through a
`FileStore` file in `tmp_path` (no TCP port, so concurrent test workers
cannot collide), calls `fn(payload)` on each rank and returns the ranks'
results in rank order. `fn` is a function of this module, named; the
children import only torch, numpy and the port (not jax and not the JAX
package: the parent computes the reference and passes it as numpy).
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

PKG = "llm_based_apache_spark_optimization_tpu_torch"


def _child(rank: int, world: int, store: str, fn: str, payload, outdir: str,
           timeout: float) -> None:
    import faulthandler

    # A rank stuck in a collective prints where it waits and exits, so the
    # parent fails instead of hanging.
    faulthandler.dump_traceback_later(timeout, exit=True)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    from llm_based_apache_spark_optimization_tpu_torch.parallel import init_distributed

    init_distributed(num_processes=world, process_id=rank,
                     init_method=f"file://{store}")
    with open(payload, "rb") as f:  # a file: numpy in spawn arguments is slow
        payload = pickle.load(f)
    try:
        out = globals()[fn](payload)
    finally:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    with open(Path(outdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_group(world: int, fn: str, tmp_path, payload=None, timeout: float = 300.0):
    """Results of `fn(payload)` on each of `world` gloo ranks, rank order."""
    import torch.multiprocessing as mp

    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store_{fn}"
    outdir = tmp / f"out_{fn}"
    outdir.mkdir(exist_ok=True)
    with open(outdir / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(_child, args=(world, str(store), fn,
                                           str(outdir / "payload.pkl"),
                                           str(outdir), timeout),
                             nprocs=world, join=False, start_method="spawn")
    while not ctx.join(timeout=timeout):
        pass
    out = []
    for r in range(world):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------ helpers

def _mesh(dp=1, sp=1, tp=1):
    from llm_based_apache_spark_optimization_tpu_torch.parallel import make_mesh

    return make_mesh(dp=dp, sp=sp, tp=tp, devices=["cpu"] * (dp * sp * tp))


def _params(tree):
    from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax

    return params_from_jax(tree, device="cpu")


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.detach().cpu().numpy()


def _cfg(name: str):
    from llm_based_apache_spark_optimization_tpu_torch.models import configs

    cfg = {c.name: c for c in vars(configs).values()
           if isinstance(c, configs.LlamaConfig)}[name]
    return cfg


def _tree(params, quant):
    from llm_based_apache_spark_optimization_tpu_torch.ops import quant as q

    if quant == "int8":
        return q.quantize_params(params)
    if quant == "int4":
        return q.quantize_params_int4(params)
    if quant == "unembed8":
        return q.quantize_unembed(params)
    return params


def engine_cases(p):
    """Greedy generate through `InferenceEngine(..., mesh=...)` on every
    rank, for each case (engine kwargs, params variant, prompts, budget)."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine

    mesh = _mesh(**p["mesh"])
    cfg, base = _cfg(p["cfg"]), _params(p["params"])
    out = []
    for kw, quant, prompts, new in p["cases"]:
        eng = InferenceEngine(cfg, _tree(base, quant), device="cpu", mesh=mesh, **kw)
        out.append(eng.generate(prompts, max_new_tokens=new))
    return out


def scheduler_cases(p):
    """Greedy generate through `ContinuousBatchingScheduler(..., mesh=...)`:
    rank 0 submits, the other ranks follow its steps; rank 0's outputs."""
    from llm_based_apache_spark_optimization_tpu_torch.parallel import spmd
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )

    mesh = _mesh(**p["mesh"])
    cfg, base = _cfg(p["cfg"]), _params(p["params"])
    out = []
    for kw, quant, prompts, new in p["cases"]:
        with ContinuousBatchingScheduler(cfg, _tree(base, quant), device="cpu",
                                         mesh=mesh, **kw) as s:
            out.append(s.generate(prompts, max_new_tokens=new)
                       if mesh.is_primary else None)
    spmd.close(mesh)
    return out


def app_cases(p):
    """`python -m ...app` flags on every rank of the group: the entry point's
    mesh and service; rank 0 drives one completion of each model, the
    others follow. Returns (mesh shape, rank 0's texts)."""
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.app.config import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.parallel import launch, spmd

    args = entry.build_parser().parse_args(p["argv"])
    cfg = AppConfig()
    assert entry.mesh_ranks(args, cfg) == args.dp * args.sp * args.tp
    # The group is formed: `join` starts no ranks.
    mesh, _ = launch.join(args.dp, args.sp, args.tp, args.cpu, "unused", [])
    svc = entry.build_service(args, cfg, mesh)
    texts = None
    if mesh.is_primary:
        spmd.drive(mesh)
        texts = [svc.generate(m, p["prompt"], max_new_tokens=p["new"]).response
                 for m in ("duckdb-nsql", "mistral")]
        svc.close()
    spmd.close(mesh)
    return dict(mesh.shape), texts


def parallel_group(p):
    """One mesh's worth of tests/test_torch_parallel.py: this rank's local
    shards (bf16, q8, q4, fused, int8 tables), the sharded forward's logits
    on its dp rows, greedy engines and schedulers per case, and a sharded
    checkpoint load. Every rank returns its results."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import fuse_blocks, forward
    from llm_based_apache_spark_optimization_tpu_torch.ops import quant as q
    from llm_based_apache_spark_optimization_tpu_torch.parallel import shard_params, spmd
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )

    mesh = _mesh(**p["mesh"])
    cfg, base = _cfg(p["cfg"]), _params(p["params"])
    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}
    trees = {"bf16": base, "q8": q.quantize_params(base),
             "q4": q.quantize_params_int4(base), "fused": fuse_blocks(base),
             "unembed8": q.quantize_unembed(base)}
    out["shards"] = {k: _np(shard_params(t, cfg, mesh)) for k, t in trees.items()}
    tokens = torch.as_tensor(p["tokens"])
    dp, di = mesh.shape["dp"], mesh.coords["dp"]
    rows = tokens.shape[0] // dp
    mine = tokens[di * rows:(di + 1) * rows]
    pos = torch.arange(mine.shape[1], dtype=torch.int32)[None].expand_as(mine)
    local = shard_params(base, cfg, mesh)
    out["logits"] = forward(cfg, local, mine, pos, None, mesh=mesh)[0].numpy()
    from llm_based_apache_spark_optimization_tpu_torch.parallel import (
        gather_batch,
        shard_batch,
    )

    out["rows"] = shard_batch(tokens, mesh).numpy()
    out["gathered"] = gather_batch(shard_batch(tokens, mesh), mesh).numpy()
    out["engine"] = []
    for kw, quant, prompts, new in p.get("engine", []):
        eng = InferenceEngine(cfg, _tree(base, quant), device="cpu", mesh=mesh, **kw)
        out["engine"].append(eng.generate(prompts, max_new_tokens=new))
    out["scheduler"] = []
    for kw, quant, prompts, new in p.get("scheduler", []):
        with ContinuousBatchingScheduler(cfg, _tree(base, quant), device="cpu",
                                         mesh=mesh, **kw) as s:
            out["scheduler"].append(s.generate(prompts, max_new_tokens=new)
                                    if mesh.is_primary else None)
    if p.get("ckpt"):
        from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
            load_gguf_checkpoint,
            load_hf_checkpoint,
            load_native,
        )

        _, hf = load_hf_checkpoint(p["ckpt"], dtype=torch.float32, mesh=mesh)
        out["hf"] = _np(hf)
        out["native"] = _np(load_native(cfg, p["native"], dtype=None, mesh=mesh))
        out["q8_loaded"] = _np(q.quantize_params(hf, mesh))
        out["q4_loaded"] = _np(q.quantize_params_int4(hf, mesh=mesh))
        if p.get("gguf"):
            _, gg = load_gguf_checkpoint(p["gguf"], dtype=torch.float32, mesh=mesh)
            out["gguf"] = _np(gg)
    spmd.close(mesh)
    return out


def ring_group(p):
    """tests/test_torch_ring.py on one group of 8 ranks: for each case a
    mesh of its (dp, sp, tp), this rank's block of the ring output (its dp
    rows and tp heads, the whole sequence), and greedy generate on a
    dp x sp x tp mesh."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.ops.ring_attention import (
        ring_gqa_attention,
    )

    out = {"ring": [], "engine": []}
    for case in p["ring"]:
        mesh = _mesh(**case["mesh"])
        dp, tp = mesh.shape["dp"], mesh.shape["tp"]
        q, k, v, pos = (torch.as_tensor(case[n]) for n in ("q", "k", "v", "pos"))
        rb = q.shape[0] // dp
        rows = slice(mesh.coords["dp"] * rb, (mesh.coords["dp"] + 1) * rb)
        nq, nk = q.shape[2] // tp, k.shape[2] // tp
        qh = slice(mesh.coords["tp"] * nq, (mesh.coords["tp"] + 1) * nq)
        kh = slice(mesh.coords["tp"] * nk, (mesh.coords["tp"] + 1) * nk)
        dtype = getattr(torch, case.get("dtype", "float32"))
        got = ring_gqa_attention(mesh, q[rows, :, qh].to(dtype), k[rows, :, kh].to(dtype),
                                 v[rows, :, kh].to(dtype), pos[rows],
                                 sliding_window=case.get("window"))
        out["ring"].append((dict(mesh.coords), str(got.dtype),
                            got.float().numpy()))
    for m, kw, prompts, new in p["engine"]:
        mesh = _mesh(**m)
        eng = InferenceEngine(_cfg(p["cfg"]), _params(p["params"]), device="cpu",
                              mesh=mesh, **kw)
        out["engine"].append(eng.generate(prompts, max_new_tokens=new))
    return out


def multihost_group(p):
    """tests/test_torch_multihost.py: two ranks, one dp row each, through
    `global_mesh` and `process_local_batch`; a sum over the whole batch."""
    import numpy as np

    from llm_based_apache_spark_optimization_tpu_torch.ops.common import (
        all_gather,
        all_reduce,
    )
    from llm_based_apache_spark_optimization_tpu_torch.parallel import (
        global_mesh,
        is_primary,
        process_local_batch,
    )
    from llm_based_apache_spark_optimization_tpu_torch.parallel.multihost import (
        process_index,
    )

    pid = process_index()
    mesh = global_mesh(dp=2, sp=1, tp=1, devices=["cpu", "cpu"])
    local = np.arange(15, dtype=np.float32).reshape(3, 5) + 100 * pid
    arr = process_local_batch(local, mesh)
    total = all_reduce(arr.sum(), mesh, "dp")
    whole = all_gather(arr, mesh, "dp", dim=0)
    return dict(primary=is_primary(), coords=dict(mesh.coords), shape=tuple(arr.shape),
                total=float(total), whole=whole.numpy())


def runbook_group(p):
    """`runbook.main` on every rank of a tp group (the group is formed, so
    the command starts no ranks): rank 0 writes the report, the others
    follow. Returns (mesh shape, the report text on rank 0)."""
    from llm_based_apache_spark_optimization_tpu_torch import runbook

    runbook.main(p["argv"])
    import torch.distributed as dist

    if dist.get_rank() == 0:
        return Path(p["out"]).read_text()
    return None


def clone_group(p):
    """A scheduler rank 0 builds while the other ranks follow (as its
    supervisor rebuilds a crashed one) from the params and arguments of one
    built before: every follower builds its twin, and the new one serves.
    Rank 0 returns both schedulers' outputs."""
    from llm_based_apache_spark_optimization_tpu_torch.parallel import spmd
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )

    mesh = _mesh(**p["mesh"])
    cfg, params = _cfg(p["cfg"]), _params(p["params"])

    def make():
        return ContinuousBatchingScheduler(cfg, params, device="cpu", mesh=mesh,
                                           **p["kw"])

    first = make().start()
    out = None
    if mesh.is_primary:
        spmd.drive(mesh)
        out = [first.generate(p["prompts"], max_new_tokens=p["new"])]
        first.shutdown()
        second = make().start()
        out.append(second.generate(p["prompts"], max_new_tokens=p["new"]))
        second.shutdown()
    else:
        first.shutdown()  # returns once rank 0 has shut it down
    spmd.close(mesh)
    return out


def evalh_group(p):
    """`--virtual-devices N`'s services on N ranks: rank 0 runs the BASELINE
    config that names tp=N through `run_config` with the group's factory
    and returns its mesh cell and case count; the others follow."""
    from llm_based_apache_spark_optimization_tpu_torch.app.__main__ import (
        make_fake_service,
    )
    from llm_based_apache_spark_optimization_tpu_torch.evalh import configs, report

    group = report.virtual_device_services(p["n"], "unused", [], max_new_tokens=8)
    if group is None:
        return None
    factory, done = group
    rep = configs.run_config(make_fake_service(), configs.CONFIGS[p["config"]],
                             max_new_tokens=4, service_factory=factory, device="cpu")
    done()
    return rep.mesh, len(rep.cases)


def dead_follower_group(p):
    """A follower whose step loop fails while its process lives on: its
    `spmd.close` re-raises the failure, and rank 0's next post (the end)
    fails within rank 0's step timeout instead of waiting on it. Returns
    (what close raised, seconds it took) on each rank."""
    import time

    from llm_based_apache_spark_optimization_tpu_torch.parallel import mesh as mesh_mod
    from llm_based_apache_spark_optimization_tpu_torch.parallel import spmd

    mesh_mod._STEP_TIMEOUT = __import__("datetime").timedelta(seconds=p["timeout_s"])
    mesh = _mesh(tp=2)

    class Target:
        def step(self):
            raise ValueError("the follower's step failed")

    target = Target()
    idx = mesh.register(target)
    if not mesh.is_primary:
        spmd.ensure_following(mesh)
    else:
        with mesh.lock:
            spmd.post(mesh, idx, "step")
    t0 = time.perf_counter()
    try:
        spmd.close(mesh)
        raised = None
    except RuntimeError as exc:
        raised = repr(exc.__cause__ or exc)
    return raised, time.perf_counter() - t0


def _prompt_tokens(svc, prompts, new):
    """Greedy token ids of `prompts` (token lists) submitted at once
    through the service's duckdb-nsql scheduler (the supervised pool)."""
    sched = svc._models["duckdb-nsql"].backend.scheduler
    futs = [sched.submit(ids, max_new_tokens=new) for ids in prompts]
    return [f.result(timeout=240) for f in futs]


def _handoff_counts(pool):
    """A pool's handoff counts by replica: exports, imports, pages and
    bytes each way (None before any handoff)."""
    hs = pool.handoff_stats
    return ({r["replica"]: (r["exports"], r["imports"], r["pages_out"], r["pages_in"],
                            r["bytes_out"], r["bytes_in"]) for r in hs["replicas"]}
            if hs else None)


def _wait_restarted(pool, timeout=60.0):
    """Wait until no replica of `pool` is restarting."""
    import time

    deadline = time.time() + timeout
    while any(r["state"] == "restarting" for r in pool.replica_loads()):
        assert time.time() < deadline, pool.replica_loads()
        time.sleep(0.02)


def pool_group(p):
    """`python -m ...app --cpu --dp 2 --tp 2 --scheduler ...` on a group of
    1 + 2*(2-1) = 3 ranks, as the entry point forms it: rank 0 is the
    pool's process and rank 0 of both replicas' tp meshes, ranks 1 and 2
    the followers of replica 0 and replica 1. Rank 0 serves p["waves"] of
    token prompts (each submitted at once), then p["texts"] through the
    service from four threads; with p["restart"] a `sched:handoff` fault
    crashes the prefill replica in the second wave and the pool rebuilds
    it on its mesh (the fault cleared by the rebuild). Rank 0 returns what
    it served and the pool's counters; a follower its mesh's world ranks."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.app.config import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.parallel import launch, spmd
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    os.environ.update(p.get("env", {}))
    args = entry.build_parser().parse_args(p["argv"])
    cfg = AppConfig.from_env(history_db=":memory:")
    assert entry.is_tp_pool(args, cfg)
    assert entry.mesh_ranks(args, cfg) == dist.get_world_size()
    meshes, _ = launch.join_pool(args.dp, args.tp, args.cpu, "unused", [],
                                 local=entry.pool_replicas(args, cfg))
    svc = entry.build_service(args, cfg, meshes)
    mine = [m for m in meshes if m is not None]
    if not mine[0].is_primary:
        launch.follow(*mine)
        return {"ranks": mine[0].ranks, "device": str(mine[0].device)}
    for m in mine:
        spmd.drive(m)
    sup = svc._models["duckdb-nsql"].backend.scheduler
    pool = sup._inner
    out = {"meshes": [m.ranks for m in mine], "waves": [],
           "roles": [s.phase_role for s in pool.schedulers],
           "tp": [s.mesh.shape["tp"] for s in pool.schedulers]}
    try:
        for w, prompts in enumerate(p["waves"]):
            if p.get("restart") and w == 1:
                factory = pool._factory
                pool._factory = lambda i: (FAULTS.clear(), factory(i))[1]
                FAULTS.configure("sched:handoff:1", 0)
            out["waves"].append(_prompt_tokens(svc, prompts, p["new"]))
            out.setdefault("wave_handoffs", []).append(_handoff_counts(pool))
        _wait_restarted(pool)
        if p.get("texts"):
            with ThreadPoolExecutor(max_workers=4) as ex:
                res = [f.result() for f in [
                    ex.submit(svc.generate, "duckdb-nsql", q, system=p["system"])
                    for q in p["texts"]]]
            out["texts"] = [(r.response, r.output_tokens) for r in res]
        out["handoffs"] = _handoff_counts(pool)
        out["restarts"] = {r["replica"]: r["restarts"] for r in pool.replica_loads()}
        out["health"] = {k: sup.health()[k] for k in ("lost", "restarts")}
        out["pages_in_use"] = [s.page_stats["pages_in_use"] if s.kv_layout == "paged"
                               else 0 for s in pool.schedulers]
        out["pages_total"] = [s.page_stats["pages_total"] if s.kv_layout == "paged"
                              else 0 for s in pool.schedulers]
    finally:
        FAULTS.clear()
        svc.close()
        launch.finish(mine, [])
    return out


def cross_tp_group(p):
    """Phase-split pools on two ranks whose replicas differ in tp: pool A
    has a tp=2 prefill replica (on the mesh) and a tp=1 decode replica on
    rank 0 alone, pool B the reverse. Rank 0 records every blob its decode
    replica imports and returns (A's tokens and blobs, B's tokens and
    blobs, each pool's handoff counts); rank 1 builds the tp=2 replicas'
    twins in the same order and follows."""
    from llm_based_apache_spark_optimization_tpu_torch.parallel import spmd
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerPool,
    )

    mesh = _mesh(tp=2)
    cfg, params = _cfg(p["cfg"]), _params(p["params"])

    def make(role, sharded):
        kw = dict(p["kw"], phase_role=role)
        if sharded:
            return ContinuousBatchingScheduler(cfg, params, mesh=mesh, **kw)
        return ContinuousBatchingScheduler(cfg, params, device="cpu", **kw)

    layouts = (("prefill", True), ("decode", False)), (("prefill", False), ("decode", True))
    if not mesh.is_primary:
        twins = [make(role, True).start() for pair in layouts
                 for role, sharded in pair if sharded]
        spmd.close(mesh)
        del twins
        return None
    # Every replica is built before rank 0 drives: a tp=2 one built while
    # it drives would need a twin recipe on rank 1.
    pools = [[make(role, sharded) for role, sharded in pair] for pair in layouts]
    spmd.drive(mesh)
    out = []
    for reps in pools:
        blobs = []
        dec = reps[1]
        real = dec._import
        dec._import = lambda pages, blob, real=real, blobs=blobs: (
            blobs.append([a.copy() for a in blob]), real(pages, blob))[1]
        with SchedulerPool(reps) as pool:
            futs = [pool.submit(ids, max_new_tokens=p["new"]) for ids in p["prompts"]]
            toks = [f.result(timeout=240) for f in futs]
            counts = {r["replica"]: (r["exports"], r["imports"])
                      for r in pool.handoff_stats["replicas"]}
        out.append({"tokens": toks, "blobs": blobs, "counts": counts})
    spmd.close(mesh)
    return out


def spill_group(p):
    """`kv_spill` on a tp=2 paged scheduler under a page-pressure storm
    (`kv:pressure`, set on rank 0, whose loop runs the pressure seam):
    rank 0 returns the tokens of p["prompts"] submitted at once (seeds 41
    + i) and the page stats; rank 1 follows."""
    from llm_based_apache_spark_optimization_tpu_torch.parallel import spmd
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    mesh = _mesh(tp=2)
    cfg, params = _cfg(p["cfg"]), _params(p["params"])
    out = None
    with ContinuousBatchingScheduler(cfg, params, mesh=mesh, **p["kw"]) as s:
        if mesh.is_primary:
            FAULTS.configure(p["pressure"], 0)
            try:
                futs = [s.submit(ids, max_new_tokens=p["new"], seed=41 + i)
                        for i, ids in enumerate(p["prompts"])]
                out = ([f.result(timeout=240) for f in futs], dict(s.page_stats))
            finally:
                FAULTS.clear()
    spmd.close(mesh)
    return out


def sp_group(p):
    """tests/test_torch_sp.py on one dp=1 x sp=2 x tp=2 group of 4 ranks,
    every case in one spawn:
    - p["engine"]: greedy generate through the engine on every rank (the
      paged engine with its pool gathered whole on each sp rank);
    - p["sched"]: schedulers built on every rank in the same order, rank 0
      submitting and the others following; each rank's pool shape and page
      count, and its mixed rounds;
    - p["spill"]: `kv_spill` under a page-pressure storm on rank 0's loop,
      the tokens (seeds 41 + i) and page stats;
    - p["budget"]: the pool pages a `kv_hbm_budget_bytes` buys;
    - p["build"]: a second params tree placed on every rank, then, once the
      followers follow, a scheduler rank 0 alone builds from it with
      arguments no earlier one had (no twin): its tokens, and on each
      follower what the mesh still holds once rank 0 shut it down.
    Rank 0 returns everything; the others their pool pages and holdings."""
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.parallel import shard_params, spmd
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

    mesh = _mesh(sp=2, tp=2)
    cfg, params = _cfg(p["cfg"]), _params(p["params"])
    primary = mesh.is_primary

    def sched(**kw):
        return ContinuousBatchingScheduler(cfg, params, device="cpu", mesh=mesh, **kw)

    out = {"coords": dict(mesh.coords), "engine": [], "sched": [], "pages": [],
           "mixed": []}
    for kw, prompts, new in p["engine"]:
        eng = InferenceEngine(cfg, params, device="cpu", mesh=mesh, **kw)
        out["engine"].append(eng.generate(prompts, max_new_tokens=new))
    for kw, prompts, new in p["sched"]:
        with sched(**kw) as s:
            out["sched"].append(s.generate(prompts, max_new_tokens=new)
                                if primary else None)
            out["pages"].append((tuple(s._pool["kp"].shape), s.page_stats["pages_total"])
                                if s._paged else None)
            out["mixed"].append(s.mixed_rounds)
    kw, prompts, new, pressure = p["spill"]
    with sched(**kw) as s:
        if primary:
            FAULTS.configure(pressure, 0)
            try:
                futs = [s.submit(ids, max_new_tokens=new, seed=41 + i)
                        for i, ids in enumerate(prompts)]
                out["spill"] = ([f.result(timeout=240) for f in futs],
                                dict(s.page_stats))
            finally:
                FAULTS.clear()
    kw, budget = p["budget"]
    with sched(kv_hbm_budget_bytes=budget, **kw) as s:
        out["budget_pages"] = s.page_stats["pages_total"]
    # A13.3: a second tree, placed on every rank before they follow: the
    # barrier keeps rank 0's build message behind every rank's placement.
    other = shard_params(_params(p["params"]), cfg, mesh)
    import torch.distributed as dist

    dist.barrier(group=mesh.control)
    first_kw, kw, prompts, new = p["build"]
    first = sched(**first_kw).start()
    if primary:
        spmd.drive(mesh)
        with ContinuousBatchingScheduler(cfg, other, mesh=mesh, **kw) as s:
            out["build"] = s.generate(prompts, max_new_tokens=new)
        first.shutdown()
    else:
        first.shutdown()  # returns once rank 0 has shut it down
    spmd.close(mesh)
    out["kept"] = len(mesh._kept)
    return out


def warmup_group(p):
    """tests/test_torch_warmup.py's tp=2 mesh: for each case a TINY
    scheduler on every rank; rank 0 serves `first`, stops, warms and
    serves `after`, the follower replays. Each rank reports whether its
    cache below the park position (a pool: every page) is what it was
    before the warmup, the forwards it ran for the warmup, and rank 0 its
    streams."""
    import threading

    from llm_based_apache_spark_optimization_tpu_torch.parallel import spmd
    from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as sm

    mesh = _mesh(tp=2)
    cfg, base = _cfg("tiny"), _params(p["params"])
    calls = []
    real = sm.forward

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    sm.forward = counted

    def state(s):
        if s._paged:
            return [t.clone() for t in s._pool.values()]
        return [c[:, :, :, :s._park].clone() for c in s._cache.values()]

    out = []
    for kw in p["cases"]:
        s = sm.ContinuousBatchingScheduler(cfg, base, device="cpu", mesh=mesh, **kw)
        snaps, done = {}, threading.Event()

        def snap(tag, s=s):
            snaps[tag] = (state(s), len(calls))
            if tag == "after":
                done.set()

        # A step rank 0 posts: the follower takes it after the warmup's.
        s._snap = snap
        streams = None
        if mesh.is_primary:
            # A mesh scheduler's shutdown closes its followers for good: it
            # warms while its loop is idle.
            with s:
                first = [s.submit(q, max_new_tokens=6).result(timeout=120)
                         for q in p["first"]]
                while any(r is not None for r in s._slot_req):
                    time.sleep(0.01)
                with mesh.lock:
                    spmd.post(mesh, s._mesh_id, "_snap", "before")
                    snap("before")
                s.warmup()
                with mesh.lock:
                    spmd.post(mesh, s._mesh_id, "_snap", "after")
                    snap("after")
                futs = [s.submit(q, max_new_tokens=6) for q in p["after"]]
                streams = (first, [f.result(timeout=120) for f in futs])
        else:
            s.start()
            assert done.wait(120), "the follower never took the snapshot step"
            s.shutdown()
        (before, n0), (after, n1) = snaps["before"], snaps["after"]
        out.append({"unchanged": all(torch.equal(x, y) for x, y in zip(before, after)),
                    "warm_forwards": n1 - n0, "streams": streams})
    spmd.close(mesh)
    return out
