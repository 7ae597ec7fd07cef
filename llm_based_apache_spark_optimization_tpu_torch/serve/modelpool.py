"""Model registry and multi-model serving assembly.

The studio runs two models: `duckdb-nsql` writes the SQL and `llama3.2`
explains Spark's errors. A copy of the JAX package's `serve/modelpool.py`:

- `ModelSpec` / `parse_models_spec`: the `LSOT_MODELS` spec, which
  checkpoints are co-resident, where each loads from (`tiny` random weights
  for tests, `hf` safetensors, `gguf`), its share of the paged KV arena, its
  chat template, its replica count.
- `partition_pages`: one page budget split between co-resident checkpoints
  by their `hbm` fractions (they share one device and must not size their
  arenas independently against it).
- `ModelRegistry`: id -> spec, with the typed `UnknownModel`.
- `build_tiny_model_service`: one paged scheduler a (model, replica) on
  tiny weights, all in one model-routing `SchedulerPool`, one
  `SchedulerBackend` a model over it, on the device the caller names.

Routing lives in `scheduler.SchedulerPool`; this module is the registry and
assembly above it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


class UnknownModel(ValueError):
    """A request named a model_id no replica in the fleet carries.

    A ValueError, so the API layer's `except ValueError -> 400` mapping
    makes it a typed client error, not a 500 or a crash shed."""


_SOURCES = ("tiny", "hf", "gguf")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One registered model: identity, checkpoint source, HBM share."""

    model_id: str
    #: "tiny" (random test weights, no path), "hf" (safetensors dir),
    #: "gguf" (single-file checkpoint).
    source: str = "tiny"
    #: Checkpoint location; required for hf/gguf, ignored for tiny.
    path: str = ""
    #: Share of the co-resident paged KV arena (0 < f <= 1). Specs in a
    #: fleet are normalized together — see `partition_pages`.
    hbm_fraction: float = 0.0
    #: Chat template name for GenerationService.register ("" = raw
    #: completion prompt — the duckdb-nsql shape).
    template: str = ""
    #: Replicas of this model in the pool.
    replicas: int = 1
    #: Whether the backend prepends BOS (llama3-chat renders its own).
    add_bos: bool = True

    def validate(self) -> "ModelSpec":
        if not self.model_id:
            raise ValueError("model spec needs a non-empty model id")
        if self.source not in _SOURCES:
            raise ValueError(
                f"model {self.model_id!r}: unknown source "
                f"{self.source!r} (expected one of {_SOURCES})"
            )
        if self.source in ("hf", "gguf") and not self.path:
            raise ValueError(
                f"model {self.model_id!r}: source {self.source!r} "
                f"needs a checkpoint path (model=source:/path)"
            )
        if self.hbm_fraction < 0 or self.hbm_fraction > 1:
            raise ValueError(
                f"model {self.model_id!r}: hbm fraction must be in "
                f"(0, 1], got {self.hbm_fraction}"
            )
        if self.replicas < 1:
            raise ValueError(
                f"model {self.model_id!r}: replicas must be >= 1, "
                f"got {self.replicas}"
            )
        return self


def parse_models_spec(spec: str) -> List[ModelSpec]:
    """Parse `LSOT_MODELS` — the multi-model fleet description.

    Format: `;`-separated entries, each
    `model_id=source[:path][,hbm=F][,template=T][,replicas=N][,add_bos=B]`

        LSOT_MODELS="duckdb-nsql=tiny,hbm=0.75;llama3.2=tiny,hbm=0.25,template=llama3-chat,add_bos=0"
        LSOT_MODELS="sql=hf:/ckpts/nsql,hbm=0.8;explainer=gguf:/ckpts/tiny.gguf,hbm=0.2"

    `tiny` needs no path. Omitted `hbm` fractions split whatever the
    explicit ones left over, equally. Explicit fractions summing past
    1.0 are a config error (two models cannot both hold 80% of one
    arena). Duplicate ids are a config error.
    """
    out: List[ModelSpec] = []
    seen: set = set()
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if "=" not in raw:
            raise ValueError(
                f"LSOT_MODELS entry {raw!r}: expected "
                f"model_id=source[:path][,k=v...]"
            )
        model_id, rest = raw.split("=", 1)
        model_id = model_id.strip()
        parts = [p.strip() for p in rest.split(",")]
        src = parts[0]
        source, _, path = src.partition(":")
        source = source.strip().lower()
        kw: Dict[str, object] = {}
        for opt in parts[1:]:
            if not opt:
                continue
            if "=" not in opt:
                raise ValueError(
                    f"LSOT_MODELS entry {model_id!r}: option {opt!r} "
                    f"is not k=v"
                )
            k, v = (x.strip() for x in opt.split("=", 1))
            if k == "hbm":
                kw["hbm_fraction"] = float(v)
            elif k == "template":
                kw["template"] = v
            elif k == "replicas":
                kw["replicas"] = int(v)
            elif k == "add_bos":
                kw["add_bos"] = v.lower() in ("1", "true", "yes", "on")
            else:
                raise ValueError(
                    f"LSOT_MODELS entry {model_id!r}: unknown option "
                    f"{k!r} (expected hbm/template/replicas/add_bos)"
                )
        ms = ModelSpec(model_id=model_id, source=source,
                       path=path.strip(), **kw).validate()
        if ms.model_id in seen:
            raise ValueError(
                f"LSOT_MODELS: duplicate model id {ms.model_id!r}"
            )
        seen.add(ms.model_id)
        out.append(ms)
    if not out:
        return out
    # Normalize the HBM shares: explicit fractions must leave room for
    # every unspecified model; the leftovers split equally.
    explicit = sum(m.hbm_fraction for m in out if m.hbm_fraction > 0)
    free = [m for m in out if m.hbm_fraction <= 0]
    if explicit > 1.0 + 1e-9:
        raise ValueError(
            f"LSOT_MODELS: hbm fractions sum to {explicit:.3f} > 1.0"
        )
    if free:
        remaining = max(0.0, 1.0 - explicit)
        if remaining <= 1e-9:
            raise ValueError(
                "LSOT_MODELS: explicit hbm fractions leave no arena "
                f"for {[m.model_id for m in free]}"
            )
        share = remaining / len(free)
        out = [dataclasses.replace(m, hbm_fraction=share)
               if m.hbm_fraction <= 0 else m for m in out]
    return out


def partition_pages(total_pages: int,
                    specs: Sequence[ModelSpec]) -> Dict[str, int]:
    """Split one paged-KV arena budget between co-resident models.

    Proportional to `hbm_fraction`, floored, remainder to the largest
    share — and every model gets at least one page when the budget can
    hold one per model (a 5%-share explainer beside a 6-slot SQL model
    must still be able to admit a request).
    """
    if total_pages < len(specs):
        raise ValueError(
            f"page budget {total_pages} cannot hold one page per "
            f"model ({len(specs)} registered)"
        )
    shares = {m.model_id: int(total_pages * m.hbm_fraction)
              for m in specs}
    for mid in shares:
        shares[mid] = max(1, shares[mid])
    # Hand the rounding remainder (or claw back an over-allocation from
    # the minimum-1 floor) to/from the largest-share models.
    order = sorted(specs, key=lambda m: -m.hbm_fraction)
    spare = total_pages - sum(shares.values())
    i = 0
    while spare != 0 and order:
        mid = order[i % len(order)].model_id
        if spare > 0:
            shares[mid] += 1
            spare -= 1
        elif shares[mid] > 1:
            shares[mid] -= 1
            spare += 1
        i += 1
        if i > 4 * len(order) * max(1, abs(spare)):
            break  # degenerate budget; shares are as close as they get
    return shares


class ModelRegistry:
    """id → ModelSpec lookup for one fleet."""

    def __init__(self, specs: Sequence[ModelSpec] = ()):
        self._specs: Dict[str, ModelSpec] = {}
        for m in specs:
            if m.model_id in self._specs:
                raise ValueError(f"duplicate model id {m.model_id!r}")
            self._specs[m.model_id] = m.validate()

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._specs

    def __len__(self) -> int:
        return len(self._specs)

    def ids(self) -> List[str]:
        return list(self._specs)

    def get(self, model_id: str) -> ModelSpec:
        try:
            return self._specs[model_id]
        except KeyError:
            raise UnknownModel(
                f"model {model_id!r} is not registered "
                f"(registered: {sorted(self._specs)})"
            ) from None

    def specs(self) -> List[ModelSpec]:
        return list(self._specs.values())


def build_tiny_model_service(
    specs: Sequence[ModelSpec],
    *,
    num_slots: int = 2,
    max_seq: int = 512,
    decode_chunk: int = 4,
    prompt_bucket: int = 8,
    kv_page_size: int = 8,
    total_pages: int = 0,
    max_new_tokens: int = 48,
    supervise: bool = False,
    seed: int = 0,
    weights: Optional[Sequence[dict]] = None,
    device=None,
    pool_options: Optional[dict] = None,
    scheduler_options: Optional[dict] = None,
):
    """A co-resident multi-model fleet on tiny weights: one paged
    `ContinuousBatchingScheduler` a (model, replica), stamped with its
    `model_id` and sized to its `partition_pages` share of one arena, all in
    one `SchedulerPool` that routes on model and rebuilds a crashed replica
    from the loaded weights, and one `SchedulerBackend` a model over it.
    With `supervise` the pool runs under a `SupervisedScheduler` whose
    factory builds a fresh pool. Returns `(service, pool, registry)`.

    TINY is widened to a context of 2 x `max_seq`; on CUDA its head dim is
    64, the smallest the kernels take. Each model's f32 weights come from
    seed `seed + position + 1` (a torch generator on `device`), or from
    `weights`, one params tree a spec (e.g. the JAX package's bridged
    through `convert.params_from_jax`). Replicas of one model share its
    tree. `pool_options` go to the `SchedulerPool` (router, weights, ...)
    and `scheduler_options` to every scheduler. `device` defaults to
    CUDA."""
    import torch

    from .. import resolve_device
    from ..models import TINY
    from ..models.llama import init_params
    from ..tokenizer import ByteTokenizer
    from .scheduler import ContinuousBatchingScheduler, SchedulerBackend, SchedulerPool
    from .service import GenerationService

    dev = resolve_device(device)
    specs = [m.validate() for m in specs]
    if not specs:
        raise ValueError("need at least one model spec")
    for m in specs:
        if m.source != "tiny":
            raise ValueError(
                f"build_tiny_model_service only builds tiny sources; "
                f"{m.model_id!r} is {m.source!r}")
    if weights is not None and len(weights) != len(specs):
        raise ValueError(f"got {len(weights)} weight trees for {len(specs)} models")
    n_replicas = sum(m.replicas for m in specs)
    # Default arena: every replica can hold a full slot complement.
    pages_per_slot = -(-max_seq // kv_page_size)
    if total_pages <= 0:
        total_pages = n_replicas * num_slots * pages_per_slot
    shares = partition_pages(total_pages, specs)
    cfg = dataclasses.replace(TINY, max_seq_len=max(TINY.max_seq_len, 2 * max_seq))
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=64)
    # (params, model_id, pages) a replica index.
    plan = []
    for idx, m in enumerate(specs):
        # A seed a spec position: two checkpoints, never one aliased.
        params = (weights[idx] if weights is not None else init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed + idx + 1),
            torch.float32, device=dev))
        plan += [(params, m.model_id, max(1, shares[m.model_id] // m.replicas))] * m.replicas

    def make_replica(i):
        params, mid, pages = plan[i]
        return ContinuousBatchingScheduler(
            cfg, params, num_slots=num_slots, decode_chunk=decode_chunk,
            prompt_bucket=prompt_bucket, stop_ids=(2,), max_seq=max_seq,
            kv_layout="paged", kv_page_size=kv_page_size, kv_pages=pages,
            model_id=mid, device=dev, **(scheduler_options or {}))

    def make_pool():
        return SchedulerPool([make_replica(i) for i in range(n_replicas)],
                             factory=make_replica, **(pool_options or {}))

    if supervise:
        from .supervisor import SupervisedScheduler

        pool = SupervisedScheduler(make_pool, name="scheduler-pool:multimodel")
    else:
        pool = make_pool()
    tok = ByteTokenizer()
    svc = GenerationService()
    for m in specs:
        backend = SchedulerBackend(pool, tok, max_new_tokens=max_new_tokens,
                                   add_bos=m.add_bos, model_id=m.model_id)
        svc.register(m.model_id, backend, template=m.template or "completion")
    return svc, pool, ModelRegistry(specs)
