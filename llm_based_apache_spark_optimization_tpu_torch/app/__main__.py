"""Run the studio on the port: `python -m llm_based_apache_spark_optimization_tpu_torch.app`.

Wires the web UI (or the headless JSON API with --api) to a generation
service, as the JAX package's `app/__main__.py` does:
  --backend fake   canned deterministic responses (the default, as there)
  --backend tiny   the JAX entry point's three tiny models (`duckdb-nsql`,
                   `llama3.2`, and `mistral` with a sliding window), random
                   weights from fixed seeds, byte tokenizer: the real
                   serving path end to end without checkpoint assets

Serving backends default to the continuous-batching scheduler over the
contiguous KV layout (`--scheduler`, `--kv-layout contiguous`), the
reference app's defaults: concurrent HTTP requests share one decode batch
on the device. `--no-scheduler` serves lock-serialised engines instead.

The port runs on a CUDA card and raises without one; `--cpu` runs it on the
CPU (the kernels' plain versions). It refuses, naming the ROADMAP item,
every option it cannot honor yet, instead of ignoring it: `--backend
checkpoint` (A5), `--supervise` (A11: the port's default is off, the JAX
entry point's on), `--dp`/`--sp`/`--tp` > 1 (A13), `--speculative` (A9),
`--int8` and `--int8-unembed` (A10), and the fleet, model-pool, QoS and
admission-control environment knobs (A11, A7).
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
    "journal_spill": "A11 (the supervisor)",
    "qos": "A11 (the QoS front door)",
    "tenant_rate": "A11 (the QoS front door)",
    "tenant_burst": "A11 (the QoS front door)",
    "tenant_weights": "A11 (the QoS front door)",
    "max_queue_depth": "A7.6 (scheduler admission control)",
}


def refuse_unported(args, cfg: AppConfig) -> None:
    """Raise on the first option or knob the port cannot honor."""
    flags = [
        (args.backend == "checkpoint", "--backend checkpoint",
         "A5 (checkpoint loading)"),
        (args.supervise, "--supervise", "A11 (the crash supervisor)"),
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
) -> GenerationService:
    """The JAX entry point's tiny service: TINY widened to a 2048-token
    context (`tiny-demo`), served as `duckdb-nsql` and `llama3.2`, and a
    sliding-window twin (window 32) as `mistral`, each behind its own
    scheduler (8 slots, prompt chunks of 64) or engine (prompts bucketed to
    64). Random f32 weights from seeds 0 and 1, or `weights` = (params,
    mistral params), e.g. the JAX service's bridged through
    `convert.params_from_jax`. On CUDA the head dim is 64, the smallest the
    kernels take (the CPU keeps TINY's 8). `int4` quantizes the block
    weights; `kv_quant="int8"` stores the KV cache in int8."""
    import torch

    from .. import resolve_device
    from ..engine import InferenceEngine
    from ..models import TINY
    from ..models.llama import init_params
    from ..ops.quant import quantize_params_int4
    from ..serve.scheduler import ContinuousBatchingScheduler, SchedulerBackend
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
    svc = GenerationService()
    models = (
        ("duckdb-nsql", cfg, params, "completion"),
        ("llama3.2", cfg, params, "completion"),
        ("mistral", mistral_cfg, mistral_params, "mistral-instruct"),
    )
    for name, mcfg, mparams, template in models:
        if scheduler:
            sched = ContinuousBatchingScheduler(
                mcfg, mparams, num_slots=num_slots, prompt_bucket=64,
                kv_layout=kv_layout, kv_quant=kv_quant, device=dev)
            backend = SchedulerBackend(sched, tok, max_new_tokens=max_new_tokens,
                                       deadline_s=deadline_s)
        else:
            eng = InferenceEngine(mcfg, mparams, stop_ids=(mcfg.eos_id,),
                                  prompt_bucket=64, device=dev, kv_quant=kv_quant)
            backend = EngineBackend(eng, tok, max_new_tokens=max_new_tokens)
        svc.register(name, backend, template=template)
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
                    help="fake (canned answers) or tiny (random-weight models); "
                         "checkpoint is not ported (ROADMAP A5) and raises")
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
    ap.add_argument("--supervise", action=argparse.BooleanOptionalAction, default=False,
                    help="crash supervision: default OFF in the port (on in the "
                         "JAX entry point); the supervisor is ROADMAP A11 and "
                         "--supervise raises. A crashed scheduler answers 503")
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
    # max_new small for the tiny demo model: it babbles bytes, not SQL.
    return make_tiny_service(
        32, scheduler=args.scheduler, kv_layout=args.kv_layout,
        kv_quant="int8" if args.kv_int8 else None, int4=args.int4,
        num_slots=args.slots, device=device, deadline_s=cfg.deadline_s or None)


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
