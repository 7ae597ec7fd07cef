"""Run the studio on the port: `python -m llm_based_apache_spark_optimization_tpu_torch.app`.

Wires the web UI (or the headless JSON API with --api) to a generation
service, as the JAX package's `app/__main__.py` does:
  --backend fake   canned deterministic responses (the default, as there)
  --backend tiny   the JAX entry point's three tiny models (`duckdb-nsql`,
                   `llama3.2`, and `mistral` with a sliding window), random
                   weights from fixed seeds, byte tokenizer: the real
                   serving path end to end without checkpoint assets
  --backend checkpoint
                   real weights: `--sql-model-path DIR|X.gguf:TOKDIR`
                   (duckdb-nsql) and optionally `--error-model-path`
                   (llama3.2; without it the error role shares the SQL
                   model's weights) and `--mistral-model-path`. An HF
                   directory carries its `tokenizer.json`; a GGUF blob
                   names the directory that holds one after a colon

Serving backends default to the continuous-batching scheduler over the
contiguous KV layout (`--scheduler`, `--kv-layout contiguous`), the
reference app's defaults: concurrent HTTP requests share one decode batch
on the device. `--no-scheduler` serves lock-serialised engines instead,
over the layout `--kv-layout` names. (The JAX entry point gives its
engines no layout, though its own exit for int8 KV with `--speculative`
on an engine tells the user to pass `--kv-layout=paged`; the port's
engines take the flag, so that combination serves.)
Each scheduler runs under the crash supervisor by default (`--supervise`,
as in the JAX entry point: journal, restart with backoff, replay;
`/readyz` reports ready|restarting|degraded|dead); `--no-supervise` leaves
a crashed scheduler answering 503 until the process restarts.

`--speculative N` turns on prompt-lookup speculative decoding (N drafts
verified a round) on both serving paths, schedulers and engines; int8 KV
with it on an engine's contiguous cache is refused, as in the JAX entry
point.

`--int8` (int8 block weights, the int8 matmul kernel) or `--int4` (int4
block weights), and `--int8-unembed` (int8 embed/unembed tables, composing
with either) quantize a checkpoint's tree after it is loaded, on the
checkpoint backends, as the JAX entry point does; `--int8 --int4` exits.

The multi-tenant front door (serve/qos.py) is on by default, as in the JAX
entry point (`LSOT_QOS`): `ADMISSION.reconfigure` takes the token buckets
(`LSOT_TENANT_RATE`, `LSOT_TENANT_BURST`) and the per-class default
deadlines (`LSOT_QOS_DEADLINE_*`); every scheduler built here takes the WFQ
switch, `LSOT_TENANT_WEIGHTS` and `LSOT_PREFIX_TENANT_NS` from the config
(`scheduler_qos`); `LSOT_TENANT_MODELS` pins tenants to models.

`LSOT_MODELS` serves several checkpoints co-resident in one model-routing
`SchedulerPool` (serve/modelpool.py): with `--backend checkpoint` each spec
loads its own hf directory or gguf blob (`make_multimodel_checkpoint_service`,
`--int8` as in JAX, `--int4` refused as there), sized to its `hbm` share of
`--kv-hbm-gb`; with `--backend tiny` the tiny fleet. The pool's knobs:
`LSOT_REPLICA_MAX_RESTARTS`, `LSOT_POOL_ROUTER`, `LSOT_POOL_AFFINITY`,
`LSOT_POOL_MODELS`, `LSOT_REPLICA_WEIGHTS`.

`--dp N --scheduler` with `--backend checkpoint` serves each model from N
replicas behind one `SchedulerPool` (`make_dp_pool_backend`): one host-side
load and quantization, replica i on `cuda:i` (under `--cpu` all on the CPU),
each rebuilt alone after a crash, the crash supervisor around the pool.
With `--tp M` each replica is a tp mesh of its own (JAX's submeshes): this
process is rank 0 of every replica's mesh, on its first card `cuda:i*M`,
and starts the other M-1 ranks of each (1 + N*(M-1) processes,
parallel/launch.join_pool); each replica's scheduler shards the one host
tree onto its mesh, and a crashed replica is rebuilt on its mesh, its
followers building their twins. `LSOT_MESH_DEVICES` (N*M entries) places
the shards, e.g. all on one card.
`LSOT_POOL_PHASES` ("prefill:1,decode:1") gives the replicas phase roles
(paged only): a prefill replica hands each request's KV pages to a decode
replica after its first token; `LSOT_PUMP_DEPTH` bounds the handoffs a
prefill replica holds packed. `LSOT_POOL_REMOTE` ("1=host:port,...") makes
those pool slots `SocketTransport`s to `python -m
llm_based_apache_spark_optimization_tpu_torch.serve.remote` workers (a
targeted restart reconnects); the pool keeps each under a heartbeat lease
(`LSOT_LEASE_S`, `LSOT_LEASE_MISSES`). As in the JAX entry point `--dp N`
counts the remote slots too: N devices, so one card serves `--dp 1` only.
`LSOT_FLEET_WORKERS` ("host:port,...") names standby workers that the
pool's `FleetAutoscaler` (serve/elastic.py) joins and retires within
`LSOT_FLEET_MIN` / `LSOT_FLEET_MAX` (default: the `--dp` replicas, and those
plus the standbys) on `LSOT_SCALE_UP_Q`, `LSOT_SCALE_DOWN_Q`,
`LSOT_SCALE_HOLD_S` and `LSOT_SCALE_INTERVAL_S`; as in the JAX entry point
the autoscaler runs on this pool alone, and elsewhere the knobs are read and
have no effect.

The port runs on a CUDA card and raises without one; `--cpu` runs it on the
CPU (the kernels' plain versions). `--tp`/`--sp` > 1, and `--dp` > 1
without `--scheduler` (the engine's dp mesh), serve the tiny or checkpoint
models on a mesh of dp*sp*tp ranks (parallel/); `--sp` takes the engine,
`--no-scheduler`, with either KV layout (`--kv-layout paged`: the pool
whole on each sp rank), `--kv-int8` and `--speculative`, and exits with
`--scheduler`, as the JAX entry point does. The command starts the
other ranks itself (parallel/launch.py), every rank loads its own block of
the weights, rank 0 serves HTTP and drives, and the others follow its
device steps. One rank a card over NCCL, or LSOT_MESH_DEVICES to place
ranks (two on one card run over gloo, staged through host memory).
`LSOT_MODELS` beside `--tp`/`--dp` builds its model pool unsharded and
starts no rank, as the JAX entry point does. It refuses, naming the
ROADMAP item, every option it cannot honor, instead of ignoring it: a
pool of tp meshes under an outer launcher (A13.5, a path the JAX entry
point does not have: it never initialises a multi-host runtime). The
engine backends take their deadline clamp's seed from `LSOT_STOK_SEED`,
else from the bench artifact `LSOT_STOK_SEED_BENCH` names, as JAX's do.

`make_oracle_service` answers every eval case with its expected SQL: the
eval harness's self-proof (`python -m ...evalh --backend oracle` reads
100% exact and execution match).

Observability (`configure_observability`, before any service or scheduler
is built): request-trace sampling and export (`LSOT_TRACE_SAMPLE`,
`LSOT_TRACE_EXPORT`), the flight recorder's ring (`LSOT_FLIGHT_ROUNDS`),
request-log sampling (`LSOT_REQUEST_LOG`), the prefix registry's bounds
(`LSOT_PREFIX_TOPK`, `LSOT_PREFIX_RING`), the SLO objectives
(`LSOT_SLO_*`) and the `/debug/profile` capture defaults
(`LSOT_PROFILE_ROUNDS`, `LSOT_PROFILE_DIR`). Both frontends serve
`/metrics` and `/debug/*`. The
schedulers honor admission control (`LSOT_MAX_QUEUE_DEPTH`: a full queue
sheds 429 with a Retry-After from the service-time estimate) and, over
the paged layout, the page-pressure knobs (`LSOT_KV_OVERCOMMIT`,
`LSOT_KV_SPILL`, `LSOT_KV_WATERMARK_LOW/HIGH`) and `LSOT_RAGGED`, which
each scheduler reads from the environment as the JAX one does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional, Tuple

from ..history import SQLiteHistory
from ..serve import EngineBackend, FakeBackend, GenerationService
from ..sql import default_backend
from .api import create_api_app
from .config import AppConfig
from .web import create_web_app

#: Per-process spill-path disambiguation: the same source can build two
#: supervisors (e.g. --error-model-path equal to --sql-model-path), and
#: sharing one file would let the second drain clobber the first's journal.
#: Construction order is fixed for a fixed command line, so the suffix is
#: stable across restarts and recovery finds its file.
_SPILL_TAGS: dict = {}


def _spill_path(cfg: AppConfig, tag: str) -> Optional[str]:
    """Per-model journal-spill path (None when LSOT_JOURNAL_SPILL is off):
    one naming rule for every scheduler path, so drain and recovery agree
    on the file."""
    if not cfg.journal_spill:
        return None
    safe = tag.replace("/", "_").replace(":", "_")
    n = _SPILL_TAGS.get(safe, 0) + 1
    _SPILL_TAGS[safe] = n
    if n > 1:
        safe = f"{safe}.{n}"
    return f"{cfg.journal_spill}.{safe}.jsonl"



def mesh_ranks(args, cfg: AppConfig) -> int:
    """Processes the flags ask for: dp*sp*tp for a mesh of the tiny and
    checkpoint models; 1 + (local replicas)*(tp-1) for the `--dp N --tp M
    --scheduler` replica pool of tp meshes (`pool_replicas`); 1 (no mesh)
    for the fake backend, for the pool at `--tp 1`, and beside
    `LSOT_MODELS`, whose model pool is built unsharded as in JAX. Exits on
    `--scheduler` with sp, as JAX does."""
    n = args.dp * args.sp * args.tp
    if n == 1 or args.backend == "fake" or (cfg.models and args.backend == "tiny"):
        return 1
    if args.scheduler and args.sp > 1:
        sys.exit("--scheduler has no sp axis (decode's T=1 has no sequence "
                 "to shard); use sp with --no-scheduler")
    if cfg.models:
        return 1
    if args.scheduler and args.dp > 1:
        return 1 + len(pool_replicas(args, cfg)) * (args.tp - 1)
    return n


def pool_replicas(args, cfg: AppConfig) -> list:
    """The local replicas of the `--dp N --scheduler` pool: its indices
    less the remote slots of `LSOT_POOL_REMOTE`."""
    remote = parse_pool_remote(cfg.pool_remote, args.dp) if not cfg.models else {}
    return [i for i in range(args.dp) if i not in remote]


def is_tp_pool(args, cfg: AppConfig) -> bool:
    """`--dp N --tp M --scheduler` (N, M > 1) on the checkpoint backend: a
    replica pool of tp meshes (`make_dp_pool_backend`)."""
    return (args.backend == "checkpoint" and args.scheduler and args.dp > 1
            and args.tp > 1 and args.sp == 1 and not cfg.models)


def refuse_unported(args, cfg: AppConfig) -> None:
    """Raise on the first option the port cannot honor: the mesh
    combinations of `mesh_ranks`."""
    mesh_ranks(args, cfg)


def configure_observability(cfg: AppConfig) -> None:
    """Wire the observability and front-door knobs through their
    reconfigure seams, as the JAX entry point does: every recorder,
    registry, scheduler and service built after this call reads them."""
    from ..serve import flightrecorder
    from ..serve.qos import ADMISSION
    from ..serve.scheduler import reconfigure_prefix_telemetry
    from ..utils import observability, slo, traceprof
    from ..utils.tracing import TRACER

    TRACER.reconfigure(sample=cfg.trace_sample, export_dir=cfg.trace_export)
    flightrecorder.reconfigure(rounds=cfg.flight_rounds)
    observability.reconfigure_request_log(cfg.request_log)
    reconfigure_prefix_telemetry(top_k=cfg.prefix_topk, ring=cfg.prefix_ring)
    slo.reconfigure(ttft_ms=cfg.slo_ttft_ms, tpot_ms=cfg.slo_tpot_ms,
                    queue_wait_ms=cfg.slo_queue_wait_ms,
                    window_s=cfg.slo_window_s, target=cfg.slo_target)
    traceprof.reconfigure_profile(profile_dir=cfg.profile_dir or None,
                                  rounds=cfg.profile_rounds)
    # The front door: buckets and per-class deadlines (the schedulers take
    # their WFQ settings from `scheduler_qos`).
    ADMISSION.reconfigure(
        enabled=cfg.qos, rate=cfg.tenant_rate, burst=cfg.tenant_burst,
        deadlines={"interactive": cfg.qos_deadline_interactive,
                   "batch": cfg.qos_deadline_batch,
                   "replay": cfg.qos_deadline_replay})


def scheduler_qos(cfg: AppConfig) -> dict:
    """The scheduler-side QoS settings of `cfg`: WFQ on or off, the
    tenants' weights, the tenant prefix namespaces."""
    return dict(qos=cfg.qos, tenant_weights=cfg.tenant_weights,
                prefix_tenant_ns=cfg.prefix_tenant_ns)


def pool_options(cfg: AppConfig, replicas: int) -> dict:
    """`SchedulerPool` arguments from `cfg`'s pool knobs."""
    from ..serve.scheduler import parse_replica_weights

    return dict(max_restarts=cfg.replica_max_restarts, router=cfg.pool_router,
                affinity_routing=cfg.pool_affinity, model_routing=cfg.pool_models,
                weights=parse_replica_weights(cfg.replica_weights, replicas))


def parse_pool_remote(spec: str, replicas: int) -> dict:
    """`LSOT_POOL_REMOTE` ("index=host:port,...") -> {index: address},
    exiting with the JAX entry point's messages on a bad entry or an index
    past the pool."""
    out = {}
    for entry in filter(None, (s.strip() for s in spec.split(","))):
        idx_s, _, addr = entry.partition("=")
        if not idx_s.isdigit() or not addr:
            sys.exit(f"LSOT_POOL_REMOTE: bad entry {entry!r} (want index=host:port)")
        if int(idx_s) >= replicas:
            sys.exit(f"LSOT_POOL_REMOTE: replica index {idx_s} out of range for "
                     f"--dp {replicas}")
        out[int(idx_s)] = addr
    return out


def refuse_dp_pool(args, cfg: AppConfig) -> None:
    """The checks of `--dp N --scheduler` that need no checkpoint, with the
    JAX entry point's messages: N*tp devices (replica i on `cuda:i*tp`,
    remote slots counted; under `--cpu` every local replica on the CPU,
    and under `--tp` > 1 LSOT_MESH_DEVICES may name the cards), the
    checkpoint backend, `LSOT_POOL_PHASES` and `LSOT_POOL_REMOTE` only on
    such a pool, and the remote entries (`LSOT_MODELS` is refused beside
    them later, as in JAX). `--dp` without `--scheduler` is the engine's dp
    mesh (`mesh_ranks`), not a pool."""
    if args.dp > 1 and args.scheduler and not args.cpu and not (
            args.tp > 1 and os.environ.get("LSOT_MESH_DEVICES")):
        import torch

        found = torch.cuda.device_count()
        if found < args.dp * args.tp:
            sys.exit(f"--dp {args.dp} --tp {args.tp} needs {args.dp * args.tp} "
                     f"devices, found {found}")
    if args.dp > 1 and args.scheduler and args.backend != "checkpoint":
        sys.exit("--dp N --scheduler builds a replica pool over --backend "
                 "checkpoint (the tiny and fake backends serve one scheduler a "
                 "model)")
    if cfg.pool_phases and not (args.scheduler and args.dp > 1):
        sys.exit("LSOT_POOL_PHASES needs --scheduler with --dp > 1 "
                 "(phase roles are per pool replica)")
    if cfg.pool_remote and not (args.scheduler and args.dp > 1):
        sys.exit("LSOT_POOL_REMOTE needs --scheduler with --dp > 1 "
                 "(remote replicas are pool slots)")
    if cfg.pool_remote and not cfg.models:
        parse_pool_remote(cfg.pool_remote, args.dp)


def _tree_to(tree, device):
    """A params tree (dicts and lists of tensors) copied to `device`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def make_dp_pool_backend(args, cfg: AppConfig, src: str, tok, add_bos: bool,
                         max_new_tokens: int, kv_quant: Optional[str],
                         meshes=None, loaded=None):
    """`--dp N --scheduler`: N scheduler replicas of one checkpoint behind a
    `SchedulerPool`, the JAX entry point's dp pool. The checkpoint is read
    (or `loaded` = (config, params) taken as read) and quantized once on
    the host. At `--tp 1` the tree is copied to each replica's device
    (replica i on `cuda:i`; all on the CPU under `--cpu`, sharing the
    tree). With `meshes` (`launch.join_pool`: replica i's tp mesh, None for
    a remote slot) replica i's scheduler shards the host tree onto its mesh
    (JAX's `mesh=scheduler_meshes[i]`); on a follower rank, which lies on
    one replica's mesh, only that replica's twin is built, and it follows
    rank 0's steps. A per-replica factory rebuilds a crashed replica from
    the same tree (on its mesh, where the followers build its twin);
    `LSOT_POOL_PHASES` gives each replica its phase role,
    `LSOT_PUMP_DEPTH` a prefill replica's bound on packed handoffs,
    `LSOT_REPLICA_WEIGHTS` its capacity weight, and the crash supervisor
    wraps the pool (`--supervise`). A slot of `LSOT_POOL_REMOTE` is a
    `SocketTransport` to its worker instead (its factory entry connects
    afresh), under the lease of `LSOT_LEASE_S` / `LSOT_LEASE_MISSES`."""
    from ..checkpoint import load_gguf_checkpoint, load_hf_checkpoint
    from ..serve.backends import quantize_loaded, resolve_stop_ids
    from ..serve.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerBackend,
        SchedulerPool,
        parse_pool_phases,
    )

    try:
        roles = parse_pool_phases(cfg.pool_phases, args.dp)
    except ValueError as e:
        sys.exit(f"LSOT_POOL_PHASES: {e}")
    if any(r != "mixed" for r in roles) and args.kv_layout != "paged":
        sys.exit("LSOT_POOL_PHASES with prefill/decode roles needs "
                 "--kv-layout=paged (the prefill→decode handoff ships KV pool "
                 "pages)")
    try:
        options = pool_options(cfg, args.dp)
    except ValueError as e:
        sys.exit(f"LSOT_REPLICA_WEIGHTS: {e}")
    remote = parse_pool_remote(cfg.pool_remote, args.dp)
    if loaded is None:
        path = src.split(":", 1)[0]
        load = load_gguf_checkpoint if path.endswith(".gguf") else load_hf_checkpoint
        loaded = load(path, device="cpu")
    mcfg, params = loaded
    params = quantize_loaded(params, args.int8, args.int4, args.int8_unembed)
    if meshes is None:
        devices = ["cpu"] * args.dp if args.cpu else [f"cuda:{i}" for i in range(args.dp)]
        trees = {d: params if d == "cpu" else _tree_to(params, d)
                 for i, d in enumerate(devices) if i not in remote}
    stops = resolve_stop_ids(mcfg, tok)

    def make_replica(i):
        if i in remote:
            from ..serve.remote import SocketTransport

            return SocketTransport(remote[i], label=f"r{i}")
        placed = (dict(params=params, mesh=meshes[i]) if meshes is not None
                  else dict(params=trees[devices[i]], device=devices[i]))
        return ContinuousBatchingScheduler(
            mcfg, num_slots=args.slots, stop_ids=stops,
            kv_quant=kv_quant, kv_layout=args.kv_layout,
            kv_hbm_budget_bytes=int(args.kv_hbm_gb * 2**30) or None,
            kv_overcommit=cfg.kv_overcommit, kv_spill=cfg.kv_spill,
            kv_watermark_low=cfg.kv_watermark_low,
            kv_watermark_high=cfg.kv_watermark_high,
            speculative_draft=args.speculative, max_queue_depth=cfg.max_queue_depth,
            phase_role=roles[i], pump_depth=cfg.pump_depth, **placed,
            **scheduler_qos(cfg))

    mine = [i for i, m in enumerate(meshes or []) if m is not None and not m.is_primary]
    if mine:
        # A follower rank: its replica's twin, kept by a backend nothing
        # submits to, replays rank 0's steps.
        return SchedulerBackend(make_replica(mine[0]), tok,
                                max_new_tokens=max_new_tokens, add_bos=add_bos)

    def make_pool():
        return SchedulerPool([make_replica(i) for i in range(args.dp)],
                             factory=make_replica, lease_s=cfg.lease_s,
                             lease_misses=cfg.lease_misses, **options)

    if args.supervise:
        from ..serve.supervisor import SupervisedScheduler

        pool = SupervisedScheduler(
            make_pool, max_restarts=cfg.max_restarts,
            max_entry_replays=cfg.max_entry_replays,
            spill_path=_spill_path(cfg, src), stall_factor=cfg.stall_factor,
            stall_min_s=cfg.stall_min_s, warmup_grace_s=cfg.stall_warmup_s,
            name=f"scheduler-pool:{src}")
    else:
        pool = make_pool()
    backend = SchedulerBackend(pool, tok, max_new_tokens=max_new_tokens, add_bos=add_bos,
                               deadline_s=cfg.deadline_s or None)
    # Elastic membership (`LSOT_FLEET_WORKERS`): standby `serve.remote`
    # workers join as `SocketTransport` replicas when the queue EWMA, SLO
    # burn or KV-pressure signal holds past the hysteresis window;
    # scale-down drains and removes only the replicas the autoscaler added.
    # The control loop is a daemon thread: it dies with the process, and a
    # failed step never takes serving down with it.
    if cfg.fleet_workers:
        from ..serve.elastic import FleetAutoscaler
        from ..serve.factory import standby_spawner

        spawn = standby_spawner(cfg.fleet_workers)
        backend.autoscaler = FleetAutoscaler(
            pool, spawn,
            fleet_min=None if cfg.fleet_min < 0 else cfg.fleet_min,
            fleet_max=(cfg.fleet_max if cfg.fleet_max >= 0
                       else args.dp + len(spawn.addresses)),
            scale_up_q=cfg.scale_up_q, scale_down_q=cfg.scale_down_q,
            hold_s=cfg.scale_hold_s, interval_s=cfg.scale_interval_s,
            drain_deadline_s=cfg.drain_deadline_s,
        ).run()
    return backend


def make_tiny_service(
    max_new_tokens: int,
    scheduler: bool = True,
    kv_layout: str = "contiguous",
    kv_quant: Optional[str] = None,
    int4: bool = False,
    num_slots: int = 8,
    device=None,
    weights: Optional[Tuple[dict, dict]] = None,
    deadline_s: Optional[float] = None,
    supervise: bool = True,
    app_cfg: Optional[AppConfig] = None,
    speculative: int = 0,
    mesh=None,
) -> GenerationService:
    """The JAX entry point's tiny service: TINY widened to a 2048-token
    context (`tiny-demo`), served as `duckdb-nsql` and `llama3.2`, and a
    sliding-window twin (window 32) as `mistral`, each behind its own
    scheduler (8 slots, prompt chunks of 64) or engine (prompts bucketed to
    64). Random f32 weights from seeds 0 and 1, or `weights` = (params,
    mistral params), e.g. the JAX service's bridged through
    `convert.params_from_jax`. On CUDA the head dim is 64, the smallest the
    kernels take (the CPU keeps TINY's 8). `int4` quantizes the block
    weights; `kv_quant="int8"` stores the KV cache in int8; `speculative`
    > 0 verifies that many prompt-lookup drafts a round. With
    `supervise` (the default, as in the JAX entry point) each scheduler
    runs under the crash supervisor with `app_cfg`'s knobs (default: the
    environment's). With a `mesh` the head counts widen to tp where they
    fall short (as JAX's tiny service does), every rank makes the same
    weights and keeps its block, and the other ranks' schedulers follow
    rank 0's (unsupervised there: rank 0's supervisor rebuilds on every
    rank)."""
    import torch

    from .. import resolve_device
    from ..engine import InferenceEngine
    from ..models import TINY
    from ..models.llama import init_params
    from ..ops.quant import quantize_params_int4
    from ..serve.scheduler import ContinuousBatchingScheduler, SchedulerBackend
    from ..serve.supervisor import SupervisedScheduler
    from ..tokenizer import ByteTokenizer

    dev = mesh.device if mesh is not None else resolve_device(device)
    cfg = dataclasses.replace(TINY, name="tiny-demo", max_seq_len=2048)
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=64)
    if mesh is not None and mesh.shape["tp"] > 1:
        tp = mesh.shape["tp"]
        cfg = dataclasses.replace(cfg, name=f"tiny-demo-tp{tp}",
                                  num_heads=max(cfg.num_heads, tp),
                                  num_kv_heads=max(cfg.num_kv_heads, tp))
    mistral_cfg = dataclasses.replace(cfg, name=cfg.name + "-swa", sliding_window=32)
    if weights is None:
        weights = tuple(
            init_params(c, torch.Generator(device=dev).manual_seed(seed),
                        torch.float32, device=dev)
            for c, seed in ((cfg, 0), (mistral_cfg, 1)))
    params, mistral_params = weights
    if int4:
        params, mistral_params = (quantize_params_int4(params),
                                  quantize_params_int4(mistral_params))
    tok = ByteTokenizer()
    app_cfg = app_cfg or AppConfig.from_env()
    svc = GenerationService()
    models = (
        ("duckdb-nsql", cfg, params, "completion"),
        ("llama3.2", cfg, params, "completion"),
        ("mistral", mistral_cfg, mistral_params, "mistral-instruct"),
    )
    for name, mcfg, mparams, template in models:
        if scheduler:
            def make_sched(mcfg=mcfg, mparams=mparams):
                return ContinuousBatchingScheduler(
                    mcfg, mparams, num_slots=num_slots, prompt_bucket=64,
                    kv_layout=kv_layout, kv_quant=kv_quant,
                    max_queue_depth=app_cfg.max_queue_depth,
                    speculative_draft=speculative, device=dev, mesh=mesh,
                    **scheduler_qos(app_cfg))

            # The factory closes over the loaded params: a restart
            # re-allocates the cache, never the weights.
            sched = (SupervisedScheduler(
                make_sched, max_restarts=app_cfg.max_restarts,
                spill_path=_spill_path(app_cfg, name),
                stall_factor=app_cfg.stall_factor, stall_min_s=app_cfg.stall_min_s,
                warmup_grace_s=app_cfg.stall_warmup_s, name=f"scheduler:{name}")
                if supervise and (mesh is None or mesh.is_primary) else make_sched())
            backend = SchedulerBackend(sched, tok, max_new_tokens=max_new_tokens,
                                       deadline_s=deadline_s)
        else:
            eng = InferenceEngine(mcfg, mparams, stop_ids=(mcfg.eos_id,),
                                  prompt_bucket=64, device=dev, kv_quant=kv_quant,
                                  kv_layout=kv_layout, speculative_draft=speculative,
                                  mesh=mesh)
            backend = EngineBackend(eng, tok, max_new_tokens=max_new_tokens)
        svc.register(name, backend, template=template)
    return svc


def resolve_kv_quant(args, cfg: AppConfig) -> Tuple[Optional[str], str]:
    """--kv-int8, or the LSOT_KV_QUANT knob (the flag wins); returns
    (kv_quant, the name of what set it)."""
    if args.kv_int8:
        return "int8", "--kv-int8"
    env_q = cfg.kv_quant or None
    if env_q not in (None, "int8"):
        sys.exit(f"LSOT_KV_QUANT must be '' or 'int8', got {env_q!r}")
    return env_q, "LSOT_KV_QUANT=int8"


def refuse_int8_speculation(args, cfg: AppConfig) -> None:
    """The JAX entry point's refusal: int8 KV with --speculative on an
    engine backend, whose verify loop streams a compute-dtype contiguous
    cache."""
    kv_quant, src = resolve_kv_quant(args, cfg)
    if kv_quant and args.speculative > 0 and not args.scheduler \
            and args.kv_layout != "paged":
        sys.exit(f"{src} cannot combine with --speculative on the contiguous "
                 "layout: the speculative verify loop streams the bf16 cache "
                 "(use --kv-layout=paged)")


def make_checkpoint_service(args, cfg: AppConfig, max_new_tokens: int,
                            device=None, mesh=None, pool_meshes=None) -> GenerationService:
    """Real weights: duckdb-nsql (NL->SQL) and llama3.2 (error analysis)
    from HF safetensors directories or GGUF blobs, each behind a
    continuous-batching scheduler (supervised by default) or, with
    `--no-scheduler`, a lock-serialised engine. The JAX entry point's
    single-checkpoint branch (`LSOT_MODELS` takes
    `make_multimodel_checkpoint_service`). With `--dp N` each model is a
    replica pool (`make_dp_pool_backend`), each replica on its mesh of
    `pool_meshes` under `--tp` > 1. With a `mesh` each rank loads its own
    block of every model straight from the checkpoint."""
    from ..serve.factory import assemble_reference_service
    from ..serve.scheduler import SchedulerBackend
    from ..tokenizer import HFTokenizer

    kv_quant, _ = resolve_kv_quant(args, cfg)

    def build(src: str, add_bos: bool = True):
        path, tok_dir = (src.split(":", 1) if ":" in src else (src, None))
        if path.endswith(".gguf") and tok_dir is None:
            sys.exit(f"{path}: GGUF blobs carry no tokenizer.json — pass "
                     "PATH.gguf:TOKDIR")
        tok = HFTokenizer(tok_dir or path)
        gguf = path.endswith(".gguf")
        if args.scheduler and args.dp > 1:
            return make_dp_pool_backend(args, cfg, src, tok, add_bos, max_new_tokens,
                                        kv_quant, meshes=pool_meshes)
        if args.scheduler:
            common = dict(
                max_new_tokens=max_new_tokens, add_bos=add_bos,
                num_slots=args.slots, kv_quant=kv_quant,
                kv_layout=args.kv_layout, quantize_int8=args.int8,
                quantize_int4=args.int4, quantize_unembed8=args.int8_unembed,
                max_queue_depth=cfg.max_queue_depth,
                kv_overcommit=cfg.kv_overcommit, kv_spill=cfg.kv_spill,
                kv_watermark_low=cfg.kv_watermark_low,
                kv_watermark_high=cfg.kv_watermark_high,
                deadline_s=cfg.deadline_s or None, supervise=args.supervise,
                max_restarts=cfg.max_restarts,
                max_entry_replays=cfg.max_entry_replays,
                journal_spill=_spill_path(cfg, src),
                stall_factor=cfg.stall_factor, stall_min_s=cfg.stall_min_s,
                stall_warmup_s=cfg.stall_warmup_s,
                speculative_draft=args.speculative, device=device, mesh=mesh,
                **scheduler_qos(cfg))
            if args.kv_hbm_gb:
                common["kv_hbm_budget_bytes"] = int(args.kv_hbm_gb * 2**30)
            load = (SchedulerBackend.from_gguf if gguf
                    else SchedulerBackend.from_hf_checkpoint)
            return load(path, tok, **common)
        # Deadline-clamp seconds-a-token seed: LSOT_STOK_SEED wins, else the
        # last bench artifact's headline converted to a step's wall
        # (LSOT_STOK_SEED_BENCH); unseeded, the first request runs unclamped.
        stok = cfg.stok_seed or None
        if stok is None and cfg.stok_seed_bench:
            from ..serve.backends import stok_seed_from_bench

            stok = stok_seed_from_bench(cfg.stok_seed_bench)
        load = EngineBackend.from_gguf if gguf else EngineBackend.from_hf_checkpoint
        return load(path, tok, max_new_tokens=max_new_tokens, add_bos=add_bos,
                    kv_quant=kv_quant, quantize_int8=args.int8,
                    quantize_int4=args.int4,
                    quantize_unembed8=args.int8_unembed, device=device,
                    speculative_draft=args.speculative, mesh=mesh,
                    kv_layout=args.kv_layout, sec_per_tok_seed=stok)

    return assemble_reference_service(
        build, args.sql_model_path, args.error_model_path,
        args.mistral_model_path, max_new_tokens=max_new_tokens)


def make_model_pool_service(models, cfg: AppConfig, *, max_new_tokens: int,
                            num_slots: int = 8, kv_layout: str = "contiguous",
                            kv_quant: Optional[str] = None,
                            kv_hbm_budget_bytes: int = 0, speculative: int = 0,
                            supervise: bool = True) -> GenerationService:
    """Co-resident models in one model-routing `SchedulerPool`: `models` is
    [(ModelSpec, LlamaConfig, params, tokenizer)], each params tree already
    on its device. Every (model, replica) scheduler is stamped with its
    model_id and sized to its `hbm` share of `kv_hbm_budget_bytes` (0: each
    sizes itself); a replica restart rebuilds from the same tree, never
    reloading it. Under `supervise` the pool runs in a
    `SupervisedScheduler`. One `SchedulerBackend` a model (its tokenizer,
    template and BOS rule) submits through the shared pool."""
    from ..serve.backends import resolve_stop_ids
    from ..serve.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerBackend,
        SchedulerPool,
    )

    factories, toks = [], {}
    for spec, mcfg, params, tok in models:
        budget = int(kv_hbm_budget_bytes * spec.hbm_fraction) or None

        def mk(mcfg=mcfg, params=params, tok=tok, budget=budget, mid=spec.model_id):
            return ContinuousBatchingScheduler(
                mcfg, params, num_slots=num_slots,
                stop_ids=resolve_stop_ids(mcfg, tok), kv_quant=kv_quant,
                kv_layout=kv_layout, kv_hbm_budget_bytes=budget,
                kv_overcommit=cfg.kv_overcommit, kv_spill=cfg.kv_spill,
                kv_watermark_low=cfg.kv_watermark_low,
                kv_watermark_high=cfg.kv_watermark_high,
                speculative_draft=speculative,
                max_queue_depth=cfg.max_queue_depth, model_id=mid,
                device=params["final_norm"].device, **scheduler_qos(cfg))

        factories += [mk] * spec.replicas
        toks[spec.model_id] = tok

    def make_replica(i):
        return factories[i]()

    def make_pool():
        return SchedulerPool([make_replica(i) for i in range(len(factories))],
                             factory=make_replica, **pool_options(cfg, len(factories)))

    if supervise:
        from ..serve.supervisor import SupervisedScheduler

        pool = SupervisedScheduler(
            make_pool, max_restarts=cfg.max_restarts,
            max_entry_replays=cfg.max_entry_replays,
            spill_path=_spill_path(cfg, "multimodel"),
            stall_factor=cfg.stall_factor, stall_min_s=cfg.stall_min_s,
            warmup_grace_s=cfg.stall_warmup_s, name="scheduler-pool:multimodel")
    else:
        pool = make_pool()
    svc = GenerationService()
    for spec, *_ in models:
        svc.register(spec.model_id, SchedulerBackend(
            pool, toks[spec.model_id], max_new_tokens=max_new_tokens,
            add_bos=spec.add_bos, deadline_s=cfg.deadline_s or None,
            model_id=spec.model_id), template=spec.template or "completion")
    return svc


def make_multimodel_checkpoint_service(args, cfg: AppConfig, max_new_tokens: int,
                                       device=None) -> GenerationService:
    """`LSOT_MODELS` with `--backend checkpoint`: each spec loads its own
    checkpoint (an hf directory or `X.gguf:TOKDIR`) onto the device once,
    `--int8` (and `--int8-unembed`) quantize it, and all of them serve from
    one pool (`make_model_pool_service`) sized to `--kv-hbm-gb`. `--int4`
    is refused, as in the JAX entry point."""
    from ..checkpoint import load_gguf_checkpoint, load_hf_checkpoint
    from ..serve.backends import quantize_loaded
    from ..serve.modelpool import parse_models_spec
    from ..tokenizer import HFTokenizer

    try:
        specs = parse_models_spec(cfg.models)
    except ValueError as e:
        sys.exit(f"LSOT_MODELS: {e}")
    if not args.scheduler:
        sys.exit("LSOT_MODELS needs --scheduler (model routing is a "
                 "scheduler-pool property)")
    if cfg.pool_phases or cfg.pool_remote:
        sys.exit("LSOT_MODELS does not combine with LSOT_POOL_PHASES/LSOT_POOL_REMOTE "
                 "yet (phase roles and remote slots are indexed per replica, not per "
                 "model)")
    tiny = [m.model_id for m in specs if m.source == "tiny"]
    if tiny:
        sys.exit(f"LSOT_MODELS: {tiny} have source 'tiny' — the random-weight "
                 f"fleet serves under --backend tiny; checkpoint assembly needs "
                 f"hf/gguf paths")
    if args.int4:
        sys.exit("LSOT_MODELS does not combine with --int4 yet (the int4 pack "
                 "path is single-checkpoint)")
    from .. import resolve_device

    dev = resolve_device(device)
    models = []
    for m in specs:
        path, tok_dir = m.path.split(":", 1) if ":" in m.path else (m.path, None)
        if path.endswith(".gguf") and tok_dir is None:
            sys.exit(f"LSOT_MODELS {m.model_id}: GGUF blobs carry no tokenizer.json "
                     f"— use gguf:PATH.gguf:TOKDIR")
        tok = HFTokenizer(tok_dir or path)
        if path.endswith(".gguf"):
            mcfg, params = load_gguf_checkpoint(path, device=dev)
        else:
            mcfg, params = load_hf_checkpoint(path, device=dev)
        params = quantize_loaded(params, args.int8, False, args.int8_unembed)
        models.append((m, mcfg, params, tok))
    return make_model_pool_service(
        models, cfg, max_new_tokens=max_new_tokens, num_slots=args.slots,
        kv_layout=args.kv_layout, kv_quant=resolve_kv_quant(args, cfg)[0],
        kv_hbm_budget_bytes=int(args.kv_hbm_gb * 2**30),
        speculative=args.speculative, supervise=args.supervise)


def make_oracle_service() -> GenerationService:
    """A canned service that answers every known eval case with its
    expected SQL (keyed by the NL question inside the rendered prompt).

    The eval harness's self-proof: a run over it must read 100% exact match
    and 100% execution match, showing end to end that the scorer can score
    a hit. Any number below 100 on this backend is a harness bug, never a
    model property."""
    from ..evalh.configs import sql_case_base

    cases = sql_case_base()

    def oracle(prompt: str) -> str:
        for case in cases:
            if case.nl and case.nl in prompt:
                return case.expected_sql
        return "SELECT * FROM temp_view LIMIT 10"

    svc = GenerationService()
    svc.register("duckdb-nsql", FakeBackend(oracle))
    svc.register("llama3.2", FakeBackend(oracle))
    svc.register("mistral", FakeBackend(oracle), template="mistral-instruct")
    return svc


def make_fake_service() -> GenerationService:
    svc = GenerationService()
    svc.register(
        "duckdb-nsql",
        FakeBackend(lambda p: "SELECT * FROM temp_view LIMIT 10"),
    )
    svc.register(
        "llama3.2",
        FakeBackend(lambda p: "Check that the referenced columns exist in the schema."),
    )
    svc.register(
        "mistral",
        FakeBackend(lambda p: "Sure! Here is the SQL you asked for: "
                              "SELECT * FROM temp_view"),
        template="mistral-instruct",
    )
    return svc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="llm_based_apache_spark_optimization_tpu_torch.app")
    ap.add_argument("--api", action="store_true", help="headless JSON API instead of the web UI")
    ap.add_argument("--backend", choices=("tiny", "fake", "checkpoint"), default="fake",
                    help="fake (canned answers), tiny (random-weight models) or "
                         "checkpoint (real weights: --sql-model-path)")
    ap.add_argument("--sql-model-path", metavar="DIR_OR_GGUF[:TOKDIR]",
                    help="duckdb-nsql weights (HF dir or .gguf) for --backend "
                         "checkpoint")
    ap.add_argument("--error-model-path", metavar="DIR_OR_GGUF[:TOKDIR]",
                    help="llama3.2 weights; defaults to --sql-model-path")
    ap.add_argument("--mistral-model-path", metavar="DIR_OR_GGUF[:TOKDIR]",
                    help="optional mistral weights (third comparison model)")
    ap.add_argument("--dp", type=int, default=1,
                    help="with --scheduler and --backend checkpoint: that many "
                         "scheduler replicas behind one pool, replica i on cuda:i "
                         "(LSOT_POOL_PHASES gives their phase roles); without "
                         "--scheduler: the engine's batch rows over dp ranks")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence parallelism (--no-scheduler): ring-attention "
                         "prefill, cache slots over sp ranks")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism: heads, MLP and vocabulary over tp "
                         "ranks, which the command starts itself")
    ap.add_argument("--speculative", type=int, default=0, metavar="N",
                    help="prompt-lookup speculative decoding: draft N tokens a "
                         "round from the prompt and the text so far, verified in "
                         "one forward, on both the scheduler (default) and engine "
                         "serving paths; greedy output is vanilla decode's token "
                         "for token, sampled output vanilla's in distribution, and "
                         "grammar-constrained requests are masked at every draft "
                         "position. Acceptance: the scheduler's "
                         "speculation_stats")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache with one f32 scale a slot (scheduler and "
                         "engine backends)")
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"), default="contiguous",
                    help="KV layout of the scheduler and engine backends (default "
                         "contiguous, the reference app's): one cache row a slot, or "
                         "a shared page pool with per-slot page tables (a "
                         "scheduler's pool size: --kv-hbm-gb)")
    ap.add_argument("--kv-hbm-gb", type=float, default=0.0, metavar="GB",
                    help="device-memory budget of a checkpoint scheduler's paged KV "
                         "pool (0 = slots x max_seq pages, the contiguous layout's "
                         "footprint)")
    ap.add_argument("--int8-unembed", action="store_true",
                    help="per-row int8 embedding/unembedding tables — the "
                         "largest remaining bf16 decode stream after block "
                         "quantization (composes with --int8/--int4)")
    ap.add_argument("--int4", action="store_true",
                    help="4-bit block weights served by the int4 matmul kernel")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only quantization (HF checkpoints)")
    ap.add_argument("--scheduler", action=argparse.BooleanOptionalAction, default=True,
                    help="continuous-batching scheduler backends (default on; "
                         "--no-scheduler serves lock-serialised engines)")
    ap.add_argument("--slots", type=int, default=8,
                    help="scheduler sequence slots (concurrent decode lanes)")
    ap.add_argument("--supervise", action=argparse.BooleanOptionalAction, default=True,
                    help="crash supervision for scheduler backends (default on): "
                         "journal admitted requests, restart a crashed decode "
                         "loop with backoff, and replay journaled work; /readyz "
                         "reports ready|restarting|degraded|dead. --no-supervise "
                         "restores crash-to-503 behavior")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); without "
                         "it the port needs a CUDA card and raises without one")
    return ap


def build_service(args, cfg: AppConfig, mesh=None) -> GenerationService:
    """The service the flags ask for, after refusing what the port cannot
    honor; on `mesh` (`main` builds it over the ranks it starts) this rank's
    side of it. For the replica pool of tp meshes `mesh` is the list of
    replica meshes `launch.join_pool` gives."""
    refuse_unported(args, cfg)
    refuse_dp_pool(args, cfg)
    if args.int4 and args.int8:
        sys.exit("pick one of --int8 / --int4")
    refuse_int8_speculation(args, cfg)
    configure_observability(cfg)
    device = "cpu" if args.cpu else None
    if args.backend == "fake":
        if not args.cpu:
            from .. import resolve_device

            resolve_device(None)  # the port needs its card unless --cpu
        service = make_fake_service()
    elif args.backend == "checkpoint":
        if not args.sql_model_path:
            sys.exit("--backend checkpoint requires --sql-model-path")
        service = (make_multimodel_checkpoint_service(args, cfg, args.max_new_tokens,
                                                      device=device)
                   if cfg.models else
                   make_checkpoint_service(
                       args, cfg, args.max_new_tokens, device=device,
                       mesh=None if isinstance(mesh, list) else mesh,
                       pool_meshes=mesh if isinstance(mesh, list) else None))
    elif cfg.models:
        # The tiny fleet: co-resident random-weight models in one
        # model-routing pool.
        from ..serve.factory import assemble_multimodel_service
        from ..serve.modelpool import parse_models_spec

        try:
            specs = parse_models_spec(cfg.models)
            service, _pool, _registry = assemble_multimodel_service(
                specs, max_new_tokens=32, supervise=args.supervise,
                num_slots=args.slots, device=device,
                pool_options=pool_options(cfg, sum(m.replicas for m in specs)),
                scheduler_options=scheduler_qos(cfg))
        except ValueError as e:
            sys.exit(f"LSOT_MODELS: {e}")
    else:
        # max_new small for the tiny demo model: it babbles bytes, not SQL.
        service = make_tiny_service(
            32, scheduler=args.scheduler, kv_layout=args.kv_layout,
            kv_quant=resolve_kv_quant(args, cfg)[0], int4=args.int4,
            num_slots=args.slots, device=device, deadline_s=cfg.deadline_s or None,
            supervise=args.supervise, app_cfg=cfg, speculative=args.speculative,
            mesh=mesh)
    # Per-tenant model routing (LSOT_TENANT_MODELS), as the config says.
    service.set_tenant_models(cfg.tenant_models)
    return service


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    cfg = AppConfig.from_env()
    if args.host:
        cfg = dataclasses.replace(cfg, host=args.host)
    if args.port:
        cfg = dataclasses.replace(cfg, port=args.port)
    refuse_dp_pool(args, cfg)  # JAX's exits, before any rank starts
    mesh, children = None, []
    if mesh_ranks(args, cfg) > 1:
        from ..parallel import launch, spmd

        module = "llm_based_apache_spark_optimization_tpu_torch.app"
        if is_tp_pool(args, cfg):
            mesh, children = launch.join_pool(args.dp, args.tp, args.cpu, module, argv,
                                              local=pool_replicas(args, cfg))
        else:
            mesh, children = launch.join(args.dp, args.sp, args.tp, args.cpu, module, argv)
    service = build_service(args, cfg, mesh)
    meshes = [m for m in (mesh if isinstance(mesh, list) else [mesh]) if m is not None]
    if any(not m.is_primary for m in meshes):
        launch.follow(*meshes)  # until rank 0 closes the channel
        return
    for m in meshes:
        spmd.drive(m)
    try:
        _serve(args, cfg, service)
    finally:
        if meshes:
            service.close()
            launch.finish(meshes, children)


def _serve(args, cfg: AppConfig, service) -> None:
    cfg.ensure_dirs()
    history = SQLiteHistory(cfg.history_db)
    factory = create_api_app if args.api else create_web_app
    # The backend factory, not an instance: each request gets an isolated
    # SQL session (its own connection and temp_view).
    app = factory(service, default_backend, history, cfg)
    kind = "JSON API" if args.api else "web UI"
    print(f"serving {kind} on http://{cfg.host}:{cfg.port} "
          f"(backend={args.backend}, kv_layout={args.kv_layout})", file=sys.stderr)
    app.serve(cfg.host, cfg.port,
              ready_cb=lambda server: _install_graceful_drain(service, server, cfg))


def _install_graceful_drain(service, server, cfg) -> None:
    """SIGTERM -> graceful drain: stop admitting (the drain gate answers new
    POSTs with 503 + Retry-After, /readyz flips to draining), let the
    backends finish up to LSOT_DRAIN_DEADLINE_S, then stop the HTTP server.
    The drain runs on a worker thread: server.shutdown() must not be called
    from the serving thread."""
    import signal
    import threading

    def drain_and_stop():
        print(f"SIGTERM: draining (deadline {cfg.drain_deadline_s}s)", file=sys.stderr)
        try:
            service.drain(cfg.drain_deadline_s)
        finally:
            server.shutdown()

    def handler(signum, frame):
        threading.Thread(target=drain_and_stop, daemon=True, name="lsot-drain").start()

    signal.signal(signal.SIGTERM, handler)


if __name__ == "__main__":
    main()
