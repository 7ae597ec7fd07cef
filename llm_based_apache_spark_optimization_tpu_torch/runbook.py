"""One-command real-weight runbook: weights in, comparison report out.

Counterpart of the JAX package's `runbook.py`, the reference's
model-comparison workflow (`Model_Comparision_Report.docx`) as ONE command
against real checkpoints:

    python -m llm_based_apache_spark_optimization_tpu_torch.runbook \
        --sql-model /weights/duckdb-nsql-7b \
        --error-model /weights/llama3.2-3b \
        --mistral-model /weights/mistral-7b.gguf \
        --tp 2 -o EVAL.md

per model: HF safetensors dir or GGUF blob -> param tree -> the native
cache (`checkpoint/cache.py`: the first run converts, every later run
restores the saved tree, each rank only its own block under `--tp`) ->
continuous-batching scheduler backend -> the eval harness's four-query
suite + five BASELINE configs -> markdown report in the reference's own
table shapes.

1. Cheap smoke first: one query, no config table, about one prefill and
   decode per model, proving tokenizer, template and stop ids:

       python -m llm_based_apache_spark_optimization_tpu_torch.runbook \
           --sql-model /weights/duckdb-nsql-7b --limit-cases 1 -o SMOKE.md

2. Then the full report at the serving configuration:

       python -m llm_based_apache_spark_optimization_tpu_torch.runbook \
           --sql-model /weights/duckdb-nsql-7b \
           --error-model /weights/llama3.2-3b \
           --int8 --kv-int8 --speculative 4 -o EVAL.md

Model path syntax: `PATH[:TOKENIZER_DIR]`; the tokenizer.json defaults to
the HF checkpoint dir, GGUF blobs need the explicit `:TOKDIR`.

`--tp N` serves every model on a tp mesh of N ranks: the command starts
the other ranks itself (parallel/launch.py; one a card over NCCL, or
LSOT_MESH_DEVICES), each rank loads its own block, and rank 0 writes the
report while the others follow its steps. `--cpu` runs on the CPU.

Serving the same weights afterwards:
    python -m llm_based_apache_spark_optimization_tpu_torch.app \
        --backend checkpoint --sql-model-path ... [--scheduler is default]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from .models.configs import LlamaConfig, RopeFreqFactors, RopeScaling

__all__ = ["load_or_convert", "build_service", "main"]


# --------------------------------------------------------------------- config
# LlamaConfig <-> json for the cache sidecar (the saved tree holds no config).

def _cfg_dump(cfg: LlamaConfig) -> dict:
    d = dataclasses.asdict(cfg)
    if cfg.rope_scaling is not None:
        d["rope_scaling"] = {
            "kind": type(cfg.rope_scaling).__name__,
            **dataclasses.asdict(cfg.rope_scaling),
        }
    return d


def _cfg_load(d: dict) -> LlamaConfig:
    d = dict(d)
    rs = d.get("rope_scaling")
    if rs:
        rs = dict(rs)
        kind = rs.pop("kind")
        d["rope_scaling"] = (
            RopeFreqFactors(tuple(rs["factors"]))
            if kind == "RopeFreqFactors" else RopeScaling(**rs)
        )
    d["extra_stop_ids"] = tuple(d.get("extra_stop_ids") or ())
    return LlamaConfig(**d)


# ---------------------------------------------------------------- conversion

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]  # torch.bfloat16 -> "bfloat16", as numpy


def _cache_key(path: Path, dtype_name: str) -> str:
    # Identity = the files whose contents land in the tree: for HF dirs,
    # config.json plus every weight file's (name, mtime, size), so replacing
    # safetensors in place invalidates; for GGUF blobs, the file itself.
    # The same key as the JAX runbook's.
    if path.is_dir():
        probes = [path / "config.json"] + sorted(path.glob("*.safetensors"))
    else:
        probes = [path]
    parts = [str(path.resolve()), dtype_name]
    for p in probes:
        st = p.stat()
        parts.append(f"{p.name}|{st.st_mtime_ns}|{st.st_size}")
    h = hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]
    return f"{path.name}-{h}"


def load_or_convert(
    src: str,
    cache_dir,
    dtype: Optional[torch.dtype] = None,
    mesh=None,
    log=print,
    device=None,
) -> Tuple[LlamaConfig, dict, Optional[str]]:
    """(cfg, params, tokenizer_dir) for `PATH[:TOKDIR]`, through the cache.

    The first run converts the HF/GGUF source and saves the stacked tree
    (under a mesh rank 0 reads the whole tree on the host and writes it,
    then each rank restores its block from the file); later runs restore
    it, under a mesh each rank only its block, without re-reading the
    source."""
    import torch.distributed as dist

    from .checkpoint import (
        load_gguf_checkpoint,
        load_hf_checkpoint,
        load_native,
        save_native,
    )

    if dtype is None:
        dtype = torch.bfloat16
    path_s, tok_dir = (
        (src.split(":", 1) + [None])[:2] if ":" in src else (src, None)
    )
    path = Path(path_s)
    if not path.exists():
        sys.exit(f"runbook: model path {path} does not exist")
    cache = Path(cache_dir) / _cache_key(path, _dtype_name(dtype))
    cfg_file = cache / "config.json"
    primary = mesh is None or mesh.is_primary

    t0 = time.perf_counter()
    if cfg_file.exists():
        cfg = _cfg_load(json.loads(cfg_file.read_text()))
        params = load_native(cfg, cache / "params", dtype=dtype, device=device,
                             mesh=mesh)
        if primary:
            log(f"runbook: {path.name}: restored native cache in "
                f"{time.perf_counter() - t0:.1f}s ({cache})")
    else:
        gguf = path.is_file() and path.suffix == ".gguf"
        load = load_gguf_checkpoint if gguf else load_hf_checkpoint
        if mesh is None:
            cfg, params = load(path, dtype=dtype, device=device)
            cache.mkdir(parents=True, exist_ok=True)
            save_native(params, cache / "params")
        else:
            # The file holds the whole tree: rank 0 reads it on the host
            # once and writes it, then each rank restores its own block.
            if primary:
                cfg, whole = load(path, dtype=dtype, device="cpu")
                cache.mkdir(parents=True, exist_ok=True)
                save_native(whole, cache / "params")
                del whole
            cfg = _cfg_load(_sync_cfg(mesh, _cfg_dump(cfg) if primary else None))
            params = load_native(cfg, cache / "params", dtype=dtype, device=device,
                                 mesh=mesh)
        if primary:
            cfg_file.write_text(json.dumps(_cfg_dump(cfg), indent=2))
            log(f"runbook: {path.name}: converted + cached in "
                f"{time.perf_counter() - t0:.1f}s ({cache})")
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.control)  # every rank saw the same cache state
    return cfg, params, tok_dir or (str(path) if path.is_dir() else None)


def _sync_cfg(mesh, d: Optional[dict]) -> dict:
    """Rank 0's config sidecar on every rank (the others did not read the
    source)."""
    from .ops.common import broadcast_object

    return broadcast_object(d, mesh)


# ------------------------------------------------------------------- service

def build_service(args, log=print, mesh=None):
    """The three-model generation service from checkpoint paths, through the
    cache, on scheduler backends (or locked engines with --no-scheduler),
    on `mesh` when given (every rank calls this; rank 0 serves). Registry
    shape and shared-weights aliasing come from
    serve.factory.assemble_reference_service (shared with the app)."""
    from .serve import EngineBackend
    from .serve.backends import quantize_loaded, resolve_stop_ids
    from .serve.factory import assemble_reference_service
    from .serve.scheduler import ContinuousBatchingScheduler, SchedulerBackend
    from .tokenizer import HFTokenizer

    if getattr(args, "int4", False) and args.int8:
        sys.exit("runbook: pick one of --int8 / --int4")
    if (getattr(args, "kv_int8", False) and getattr(args, "speculative", 0)
            and not args.scheduler):
        # The engine's speculative verify loop streams a bf16 cache; only
        # the scheduler path composes speculation with the int8 KV cache.
        sys.exit("runbook: --kv-int8 cannot combine with --speculative on "
                 "--no-scheduler (the engine's verify loop streams the "
                 "bf16 cache); drop one, or use the scheduler path")
    if args.tp > 1 and mesh is None:
        raise ValueError(f"--tp {args.tp} needs a mesh of {args.tp} ranks "
                         "(`main` starts them)")
    device = "cpu" if getattr(args, "cpu", False) else None

    def build(src: str, add_bos: bool = True):
        cfg, params, tok_dir = load_or_convert(
            src, args.cache_dir, mesh=mesh, log=log, device=device)
        if getattr(args, "max_seq", None):
            # Context override, mainly for tiny smoke fixtures whose
            # declared context can't fit a schema prompt (rope tables are
            # computed on the fly, so extending costs nothing).
            cfg = dataclasses.replace(cfg, max_seq_len=args.max_seq)
        if tok_dir is None:
            sys.exit(f"runbook: {src}: GGUF blobs need an explicit "
                     "tokenizer dir — pass PATH.gguf:TOKDIR")
        tok = HFTokenizer(tok_dir)
        stop_ids = resolve_stop_ids(cfg, tok)
        params = quantize_loaded(params, args.int8, getattr(args, "int4", False),
                                 getattr(args, "int8_unembed", False), mesh)
        kv_quant = "int8" if getattr(args, "kv_int8", False) else None
        spec = getattr(args, "speculative", 0)
        dev = params["final_norm"].device
        if args.scheduler:
            sched = ContinuousBatchingScheduler(
                cfg, params, num_slots=args.slots, stop_ids=stop_ids,
                mesh=mesh, kv_quant=kv_quant, speculative_draft=spec,
                device=dev,
            )
            return SchedulerBackend(
                sched, tok, max_new_tokens=args.max_new_tokens,
                add_bos=add_bos,
            )
        from .engine import InferenceEngine

        eng = InferenceEngine(cfg, params, stop_ids=stop_ids, mesh=mesh,
                              kv_quant=kv_quant, speculative_draft=spec,
                              device=dev)
        return EngineBackend(
            eng, tok, max_new_tokens=args.max_new_tokens, add_bos=add_bos
        )

    return assemble_reference_service(
        build, args.sql_model, args.error_model, args.mistral_model,
        max_new_tokens=args.max_new_tokens,
    )


# ----------------------------------------------------------------------- cli

def build_parser() -> argparse.ArgumentParser:
    """The runbook CLI, separately constructible so the documented
    invocations stay dry-runnable in tests (parsing loads no weights)."""
    ap = argparse.ArgumentParser(
        prog="llm_based_apache_spark_optimization_tpu_torch.runbook",
        description="weights in -> model-comparison report out (one command)",
    )
    ap.add_argument("--sql-model", required=True,
                    metavar="DIR_OR_GGUF[:TOKDIR]",
                    help="duckdb-nsql weights (NL->SQL role)")
    ap.add_argument("--error-model", metavar="DIR_OR_GGUF[:TOKDIR]",
                    help="llama3.2 weights; defaults to --sql-model")
    ap.add_argument("--mistral-model", metavar="DIR_OR_GGUF[:TOKDIR]",
                    help="optional third comparison model")
    ap.add_argument("--cache-dir", default="data/ckpt_cache",
                    help="native-cache root (convert once, restore after)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks, which the command starts")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int4", action="store_true",
                    help="4-bit packed weights via the int4 matmul kernel "
                         "(composes with --tp; pick one of --int8/--int4)")
    ap.add_argument("--int8-unembed", action="store_true",
                    help="per-row int8 embed/unembed tables (composes with "
                         "--int8/--int4)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (per-slot scales): halves the "
                         "serving window's device footprint and cache traffic")
    ap.add_argument("--speculative", type=int, default=0, metavar="N",
                    help="prompt-lookup speculative decoding, draft N "
                         "tokens/round (greedy requests; NL→SQL's "
                         "copy-heavy completions are the sweet spot)")
    ap.add_argument("--scheduler", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="override the model's context window (smoke fixtures)")
    ap.add_argument("--limit-cases", type=int, default=None, metavar="N",
                    help="smoke mode: score only the first N suite queries "
                         "and skip the BASELINE config table — makes the "
                         "FIRST run over a new checkpoint cheap (one "
                         "prefill+decode per model at N=1) before "
                         "committing to the full report")
    ap.add_argument("-o", "--out", default="EVAL.md")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (hermetic smoke)")
    return ap


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.limit_cases is not None and args.limit_cases < 1:
        # 0 would run the FULL suite (falsy = no limit downstream) while
        # still skipping the config table; negatives would slice from the
        # end.
        sys.exit("runbook: --limit-cases must be >= 1")

    import datetime

    from .evalh import report as report_mod

    mesh, children = None, []
    if args.tp > 1:
        from .parallel import launch, spmd

        mesh, children = launch.join(
            1, 1, args.tp, args.cpu,
            "llm_based_apache_spark_optimization_tpu_torch.runbook", argv)
    svc = build_service(args, mesh=mesh)
    if mesh is not None and not mesh.is_primary:
        launch.follow(mesh)  # until rank 0 has written the report
        return
    if mesh is not None:
        spmd.drive(mesh)
    try:
        text = report_mod.generate(
            svc,
            backend_desc=(
                f"real checkpoints via runbook (tp={args.tp}, "
                f"{'int8, ' if args.int8 else ''}"
                f"{'scheduler' if args.scheduler else 'engine'} backends)"
            ),
            max_new_tokens=args.max_new_tokens,
            quality_meaningful=True,
            timestamp=datetime.datetime.now().strftime("%Y-%m-%d %H:%M"),
            # The service owns its mesh: report config rows with the mesh
            # that actually serves them, not a tp=1 default.
            service_mesh=f"tp={args.tp}",
            limit_cases=args.limit_cases,
            with_configs=args.limit_cases is None,
            device="cpu" if args.cpu else None,
        )
    finally:
        svc.close()
        if mesh is not None:
            launch.finish(mesh, children)
    Path(args.out).write_text(text)
    print(f"runbook: wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
