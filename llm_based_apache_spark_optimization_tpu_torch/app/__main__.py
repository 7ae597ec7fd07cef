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
on the device. `--no-scheduler` serves lock-serialised engines instead.
Each scheduler runs under the crash supervisor by default (`--supervise`,
as in the JAX entry point: journal, restart with backoff, replay;
`/readyz` reports ready|restarting|degraded|dead); `--no-supervise` leaves
a crashed scheduler answering 503 until the process restarts.

The port runs on a CUDA card and raises without one; `--cpu` runs it on the
CPU (the kernels' plain versions). It refuses, naming the ROADMAP item,
every option it cannot honor yet, instead of ignoring it: `--dp`/`--sp`/
`--tp` > 1 (A13), `--speculative` (A9), `--int8` and `--int8-unembed`
(A10), and the fleet, model-pool, QoS, admission-control and KV-pressure
environment knobs (A11, A7).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Tuple

from ..history import SQLiteHistory
from ..serve import EngineBackend, FakeBackend, GenerationService
from ..sql import default_backend
from .api import create_api_app
from .config import AppConfig
from .web import create_web_app

#: Environment knobs of layers the port does not have yet: AppConfig field
#: -> the ROADMAP item that brings it.
UNPORTED_KNOBS = {
    "models": "A11 (multi-model pools)",
    "tenant_models": "A11 (multi-model pools)",
    "pool_phases": "A11 (the fleet)",
    "pool_remote": "A11 (the fleet)",
    "replica_weights": "A11 (the fleet)",
    "fleet_workers": "A11 (the fleet)",
    "qos": "A11 (the QoS front door)",
    "tenant_rate": "A11 (the QoS front door)",
    "tenant_burst": "A11 (the QoS front door)",
    "tenant_weights": "A11 (the QoS front door)",
    "max_queue_depth": "A7.6 (scheduler admission control)",
    "kv_overcommit": "A7.4 (overcommit, spill and watermarks)",
    "kv_spill": "A7.4 (overcommit, spill and watermarks)",
    "kv_watermark_low": "A7.4 (overcommit, spill and watermarks)",
    "kv_watermark_high": "A7.4 (overcommit, spill and watermarks)",
}

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



def refuse_unported(args, cfg: AppConfig) -> None:
    """Raise on the first option or knob the port cannot honor."""
    flags = [
        (args.dp > 1 or args.sp > 1 or args.tp > 1, "--dp/--sp/--tp > 1",
         "A13 (parallelism)"),
        (args.speculative > 0, "--speculative", "A9 (speculative decoding)"),
        (args.int8, "--int8", "A10 (int8 weights)"),
        (args.int8_unembed, "--int8-unembed", "A10 (int8 embeddings)"),
    ]
    for on, flag, item in flags:
        if on:
            raise NotImplementedError(f"{flag} is not ported: ROADMAP {item}")
    defaults = AppConfig()
    for name, item in UNPORTED_KNOBS.items():
        if getattr(cfg, name) != getattr(defaults, name):
            raise NotImplementedError(
                f"LSOT_{name.upper()} is not ported: ROADMAP {item}")


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
) -> GenerationService:
    """The JAX entry point's tiny service: TINY widened to a 2048-token
    context (`tiny-demo`), served as `duckdb-nsql` and `llama3.2`, and a
    sliding-window twin (window 32) as `mistral`, each behind its own
    scheduler (8 slots, prompt chunks of 64) or engine (prompts bucketed to
    64). Random f32 weights from seeds 0 and 1, or `weights` = (params,
    mistral params), e.g. the JAX service's bridged through
    `convert.params_from_jax`. On CUDA the head dim is 64, the smallest the
    kernels take (the CPU keeps TINY's 8). `int4` quantizes the block
    weights; `kv_quant="int8"` stores the KV cache in int8. With
    `supervise` (the default, as in the JAX entry point) each scheduler
    runs under the crash supervisor with `app_cfg`'s knobs (default: the
    environment's)."""
    import torch

    from .. import resolve_device
    from ..engine import InferenceEngine
    from ..models import TINY
    from ..models.llama import init_params
    from ..ops.quant import quantize_params_int4
    from ..serve.scheduler import ContinuousBatchingScheduler, SchedulerBackend
    from ..serve.supervisor import SupervisedScheduler
    from ..tokenizer import ByteTokenizer

    dev = resolve_device(device)
    cfg = dataclasses.replace(TINY, name="tiny-demo", max_seq_len=2048)
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=64)
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
                    kv_layout=kv_layout, kv_quant=kv_quant, device=dev)

            # The factory closes over the loaded params: a restart
            # re-allocates the cache, never the weights.
            sched = (SupervisedScheduler(
                make_sched, max_restarts=app_cfg.max_restarts,
                spill_path=_spill_path(app_cfg, name),
                stall_factor=app_cfg.stall_factor, stall_min_s=app_cfg.stall_min_s,
                warmup_grace_s=app_cfg.stall_warmup_s, name=f"scheduler:{name}")
                if supervise else make_sched())
            backend = SchedulerBackend(sched, tok, max_new_tokens=max_new_tokens,
                                       deadline_s=deadline_s)
        else:
            eng = InferenceEngine(mcfg, mparams, stop_ids=(mcfg.eos_id,),
                                  prompt_bucket=64, device=dev, kv_quant=kv_quant)
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


def make_checkpoint_service(args, cfg: AppConfig, max_new_tokens: int,
                            device=None) -> GenerationService:
    """Real weights: duckdb-nsql (NL->SQL) and llama3.2 (error analysis)
    from HF safetensors directories or GGUF blobs, each behind a
    continuous-batching scheduler (supervised by default) or, with
    `--no-scheduler`, a lock-serialised engine. The JAX entry point's
    single-checkpoint branch; its dp pools (ROADMAP A13) and multi-model
    `LSOT_MODELS` fleet (A11) are refused by `refuse_unported`."""
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
        if args.scheduler:
            common = dict(
                max_new_tokens=max_new_tokens, add_bos=add_bos,
                num_slots=args.slots, kv_quant=kv_quant,
                kv_layout=args.kv_layout, quantize_int4=args.int4,
                deadline_s=cfg.deadline_s or None, supervise=args.supervise,
                max_restarts=cfg.max_restarts,
                max_entry_replays=cfg.max_entry_replays,
                journal_spill=_spill_path(cfg, src),
                stall_factor=cfg.stall_factor, stall_min_s=cfg.stall_min_s,
                stall_warmup_s=cfg.stall_warmup_s, device=device)
            load = (SchedulerBackend.from_gguf if gguf
                    else SchedulerBackend.from_hf_checkpoint)
            return load(path, tok, **common)
        # Deadline-clamp seconds-a-token seed: LSOT_STOK_SEED, else unseeded.
        load = EngineBackend.from_gguf if gguf else EngineBackend.from_hf_checkpoint
        return load(path, tok, max_new_tokens=max_new_tokens, add_bos=add_bos,
                    kv_quant=kv_quant, quantize_int4=args.int4, device=device,
                    sec_per_tok_seed=cfg.stok_seed or None)

    return assemble_reference_service(
        build, args.sql_model_path, args.error_model_path,
        args.mistral_model_path, max_new_tokens=max_new_tokens)


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
    ap.add_argument("--dp", type=int, default=1, help="> 1 raises (ROADMAP A13)")
    ap.add_argument("--sp", type=int, default=1, help="> 1 raises (ROADMAP A13)")
    ap.add_argument("--tp", type=int, default=1, help="> 1 raises (ROADMAP A13)")
    ap.add_argument("--speculative", type=int, default=0, metavar="N",
                    help="> 0 raises: speculative decoding is ROADMAP A9")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache with one f32 scale a slot (scheduler and "
                         "engine backends)")
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"), default="contiguous",
                    help="KV layout of the scheduler backends (default contiguous, "
                         "the reference app's): one cache row a slot, or a shared "
                         "page pool with per-slot page tables")
    ap.add_argument("--int8-unembed", action="store_true",
                    help="raises: int8 embeddings are ROADMAP A10")
    ap.add_argument("--int4", action="store_true",
                    help="4-bit block weights served by the int4 matmul kernel")
    ap.add_argument("--int8", action="store_true",
                    help="raises: int8 weights are ROADMAP A10")
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


def build_service(args, cfg: AppConfig) -> GenerationService:
    """The service the flags ask for, after refusing what the port cannot
    honor."""
    refuse_unported(args, cfg)
    device = "cpu" if args.cpu else None
    if args.backend == "fake":
        if not args.cpu:
            from .. import resolve_device

            resolve_device(None)  # the port needs its card unless --cpu
        return make_fake_service()
    if args.backend == "checkpoint":
        if not args.sql_model_path:
            sys.exit("--backend checkpoint requires --sql-model-path")
        return make_checkpoint_service(args, cfg, args.max_new_tokens,
                                       device=device)
    # max_new small for the tiny demo model: it babbles bytes, not SQL.
    return make_tiny_service(
        32, scheduler=args.scheduler, kv_layout=args.kv_layout,
        kv_quant=resolve_kv_quant(args, cfg)[0], int4=args.int4,
        num_slots=args.slots, device=device, deadline_s=cfg.deadline_s or None,
        supervise=args.supervise, app_cfg=cfg)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = AppConfig.from_env()
    if args.host:
        cfg = dataclasses.replace(cfg, host=args.host)
    if args.port:
        cfg = dataclasses.replace(cfg, port=args.port)
    service = build_service(args, cfg)
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
