"""Multi-tenant QoS front door: token buckets, class policy, WFQ weights,
and the process-wide admission controller.

A copy of the JAX package's `serve/qos.py` (host logic; no tensors):

* **Token buckets**: per-(tenant, class) refillable budgets shed over-rate
  tenants with a typed 429 before the request touches the scheduler.
  `LSOT_TENANT_RATE` / `LSOT_TENANT_BURST` configure them ("2" = 2 req/s
  for every class; "2,interactive=4" overrides per class). An empty rate
  turns the buckets off (WFQ fairness still applies).
* **Weighted-fair queueing** (serve/scheduler.py): per-tenant
  virtual-finish-time ordering at admission and at the page wait, weights
  from `LSOT_TENANT_WEIGHTS` ("tenantA=4,tenantB=1").
* **Prefix-cache namespaces** (serve/scheduler.py): `tenant_salt` below
  prepends two tenant-derived int32s to every prefix-cache key and chain
  digest (`LSOT_PREFIX_TENANT_NS`, default on), so one tenant can neither
  probe nor evict another's cached schema prefixes.

`LSOT_QOS=0` switches the whole subsystem off: the scheduler's admission
order, prefix keys and preemption choices are then the FIFO scheduler's.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Dict, Optional, Tuple

from .resilience import Overloaded

#: The three service classes the front door understands. `interactive`
#: is the latency class (gets the tighter default deadline when the
#: operator configures one); `batch` is throughput traffic; `replay` is
#: backfill/re-run traffic (the journal-replay and eval harness class).
QOS_CLASSES = ("interactive", "batch", "replay")

#: Bucket accounting label for unlabeled traffic. The empty tenant stays
#: "" end-to-end through the scheduler/wire (so off-switch and
#: single-tenant paths are untouched); only the *accounting* here folds
#: it into one named default bucket.
DEFAULT_TENANT = "default"

#: Bounded label cardinality for everything per-tenant (counters here,
#: the lsot_tenant_* Prometheus families, the scheduler's WFQ ledgers):
#: the top-K tenants keep their own label, the long tail aggregates
#: under "_other" so a tenant-id cardinality attack cannot balloon the
#: metrics payload.
TENANT_TOPK = 32
OTHER_TENANT = "_other"


def _truthy(env: str, default: str = "1") -> bool:
    return os.environ.get(env, default).strip().lower() in (
        "1", "true", "yes", "on")


def qos_enabled() -> bool:
    """The master off-switch (`LSOT_QOS`, default on)."""
    return _truthy("LSOT_QOS")


def prefix_tenant_ns_enabled() -> bool:
    """Per-tenant prefix-cache namespacing (`LSOT_PREFIX_TENANT_NS`,
    default on; off = today's shared registry bit-for-bit)."""
    return _truthy("LSOT_PREFIX_TENANT_NS")


def normalize_qos(qos: str) -> str:
    """Lower-cased class name, "" for unlabeled. Raises ValueError for an
    unknown class — the HTTP layer turns that into a 400."""
    q = (qos or "").strip().lower()
    if q and q not in QOS_CLASSES:
        raise ValueError(
            f"unknown qos class {qos!r}; choices {list(QOS_CLASSES)}")
    return q


def bounded_bump(counters: Dict[str, float], tenant: str,
                 amount: float = 1.0, top_k: int = TENANT_TOPK) -> None:
    """Increment `counters[tenant]`, folding tenants beyond the top-K
    into the `_other` aggregate (bounded label cardinality)."""
    key = tenant or DEFAULT_TENANT
    if key not in counters and len(counters) >= top_k:
        key = OTHER_TENANT
    counters[key] = counters.get(key, 0) + amount


def tenant_salt(tenant: str) -> Tuple[int, ...]:
    """Two int32 salts derived from the tenant id: prepended to prefix
    cache keys/chain digests when namespacing is on, so the same token
    prefix keys differently per tenant (cross-tenant cache probing and
    eviction become impossible by construction). "" salts to () — the
    unlabeled/single-tenant key shape is bit-for-bit unchanged."""
    if not tenant:
        return ()
    h = hashlib.blake2b(tenant.encode("utf-8"), digest_size=8).digest()
    return (int.from_bytes(h[:4], "little", signed=True),
            int.from_bytes(h[4:], "little", signed=True))


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """`LSOT_TENANT_WEIGHTS` ("tenantA=4,tenantB=1") → weight map for
    the scheduler's WFQ. Missing tenants weigh 1.0; malformed entries
    are ignored (a bad knob must not take down serving)."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            w = float(val)
        except ValueError:
            continue
        if name.strip() and w > 0:
            out[name.strip()] = w
    return out


def parse_tenant_models(spec: str) -> Dict[str, str]:
    """`LSOT_TENANT_MODELS` ("tenantA=duckdb-nsql,tenantB=llama3.2") →
    tenant → model_id routing map atop the multi-model pool. Unknown
    tenants fall through to the request's own model; malformed entries
    are ignored (a bad knob must not take down serving)."""
    out: Dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        if name.strip() and val.strip():
            out[name.strip()] = val.strip()
    return out


def _parse_budget_spec(spec: str) -> Tuple[float, Dict[str, float]]:
    """"2,interactive=4,batch=1" → (2.0, {"interactive": 4.0, ...}).
    The bare number is the default for every class; `class=value`
    entries override per class. Malformed entries are ignored."""
    base = 0.0
    per: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, val = part.partition("=")
            try:
                per[name.strip().lower()] = float(val)
            except ValueError:
                continue
        else:
            try:
                base = float(part)
            except ValueError:
                continue
    return base, per


class TokenBucket:
    """Refillable token bucket: `rate` tokens/s toward `burst` capacity,
    starting full. Not thread-safe on its own — the registry serializes
    access under its lock."""

    __slots__ = ("rate", "burst", "level", "_t")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.level = self.burst
        self._t: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._t is not None and self.rate > 0 and now > self._t:
            self.level = min(self.burst,
                             self.level + (now - self._t) * self.rate)
        self._t = now

    def take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        """Consume `n` tokens if available; False (nothing consumed)
        otherwise."""
        self._refill(time.monotonic() if now is None else now)
        if self.level >= n:
            self.level -= n
            return True
        return False

    def refill_eta(self, n: float = 1.0,
                   now: Optional[float] = None) -> float:
        """Seconds until `n` tokens will be available (0.0 if they
        already are). A zero-rate bucket never refills: cap at a minute
        so Retry-After stays a sane HTTP hint rather than infinity."""
        self._refill(time.monotonic() if now is None else now)
        if self.level >= n:
            return 0.0
        if self.rate <= 0:
            return 60.0
        return min(60.0, (n - self.level) / self.rate)


class TenantShed(Overloaded):
    """A tenant's token bucket is empty: the front door shed the request
    before it touched the scheduler — HTTP 429 (rides the existing
    Overloaded → 429 mapping in app/api.py). `retry_after_s` is
    bucket-aware: max(bucket refill ETA, fleet backpressure hint), so a
    rate-limited tenant is never told to retry into the same empty
    bucket."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 tenant: str = "", qos: str = ""):
        super().__init__(message, retry_after_s=retry_after_s)
        self.tenant = tenant
        self.qos = qos


class TenantBucketRegistry:
    """Per-(tenant, class) token buckets from the rate/burst specs.
    Rate 0 (the default) disables shedding entirely — QoS without
    configured budgets still gets WFQ fairness, just no hard ceiling.
    Bucket count is bounded: beyond `max_buckets` distinct keys, new
    tenants share the overflow bucket (a tenant-id flood cannot grow
    memory without bound — and the overflow bucket throttling strangers
    collectively is the *right* failure mode under such a flood)."""

    def __init__(self, rate_spec: str = "", burst_spec: str = "",
                 max_buckets: int = 4 * TENANT_TOPK):
        self.rate_base, self.rate_per = _parse_budget_spec(rate_spec)
        self.burst_base, self.burst_per = _parse_budget_spec(burst_spec)
        self.max_buckets = max_buckets
        self._buckets: Dict[Tuple[str, str], TokenBucket] = {}

    def _limits(self, qos: str) -> Tuple[float, float]:
        rate = self.rate_per.get(qos, self.rate_base)
        # Default burst = 2 seconds of rate (room for a small volley)
        # unless the operator pins one.
        burst = self.burst_per.get(
            qos, self.burst_base if self.burst_base > 0
            else max(1.0, 2.0 * rate))
        return rate, burst

    def bucket(self, tenant: str, qos: str) -> Optional[TokenBucket]:
        """The live bucket for (tenant, class); None when that class is
        unlimited (rate <= 0)."""
        rate, burst = self._limits(qos)
        if rate <= 0:
            return None
        key = (tenant or DEFAULT_TENANT, qos)
        b = self._buckets.get(key)
        if b is None:
            if len(self._buckets) >= self.max_buckets:
                key = (OTHER_TENANT, qos)
                b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = TokenBucket(rate, burst)
        return b

    def check(self, tenant: str, qos: str,
              now: Optional[float] = None) -> Optional[float]:
        """Take one token for (tenant, class). None = admitted; a float
        = shed, with that many seconds until the bucket refills."""
        b = self.bucket(tenant, qos)
        if b is None or b.take(1.0, now=now):
            return None
        return max(0.0, b.refill_eta(1.0, now=now))


class AdmissionController:
    """Process-wide front-door state: the bucket registry, per-class
    default deadlines, and bounded per-tenant admit/shed counters (the
    "qos" block in /metrics → the lsot_tenant_* Prometheus families).
    Reconfigured from the environment at app boot (the slo.ENGINE
    pattern); tests call `reconfigure()` directly."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reconfigure()

    def reconfigure(self, enabled: Optional[bool] = None,
                    rate: Optional[str] = None,
                    burst: Optional[str] = None,
                    deadlines: Optional[Dict[str, float]] = None) -> None:
        with self._lock:
            self.enabled = qos_enabled() if enabled is None else bool(enabled)
            self.buckets = TenantBucketRegistry(
                os.environ.get("LSOT_TENANT_RATE", "") if rate is None
                else rate,
                os.environ.get("LSOT_TENANT_BURST", "") if burst is None
                else burst,
            )
            # Per-class default deadline (seconds; 0 = none): applied by
            # the service ONLY when the request carries no deadline of
            # its own — "interactive gets the tighter default deadline
            # the machinery already honors".
            if deadlines is None:
                deadlines = {}
                for cls in QOS_CLASSES:
                    try:
                        deadlines[cls] = float(os.environ.get(
                            f"LSOT_QOS_DEADLINE_{cls.upper()}", "0") or 0)
                    except ValueError:
                        deadlines[cls] = 0.0
            self.class_deadlines = dict(deadlines)
            self.admitted: Dict[str, float] = {}
            self.shed: Dict[str, float] = {}
            self.shed_wait_s: Dict[str, float] = {}

    def default_deadline(self, qos: str) -> Optional[float]:
        """The class's configured default deadline, or None when the
        class has no tighter budget (or traffic is unlabeled)."""
        d = self.class_deadlines.get(qos, 0.0)
        return d if d and d > 0 else None

    def admit(self, tenant: str, qos: str,
              fleet_hint: float = 1.0) -> None:
        """Front-door check: consume one bucket token for (tenant, qos)
        or raise TenantShed with a bucket-aware Retry-After. No-op when
        QoS is off or no rate is configured."""
        if not self.enabled:
            return
        with self._lock:
            if not (tenant or qos) and \
                    self.buckets.bucket(tenant, qos) is None:
                # Quiet single-tenant deployment (no labels, no rates):
                # zero accounting, so the /metrics payload is unchanged.
                return
            eta = self.buckets.check(tenant, qos)
            label = f"{tenant or DEFAULT_TENANT}/{qos or 'batch'}"
            if eta is None:
                bounded_bump(self.admitted, label)
                return
            bounded_bump(self.shed, label)
            bounded_bump(self.shed_wait_s, label, amount=eta)
        # The hint a shed tenant gets must be
        # max(bucket refill time, fleet backpressure hint) — the fleet
        # hint alone would tell a rate-limited tenant to retry into the
        # same empty bucket.
        retry = max(float(eta), float(fleet_hint or 0.0), 0.1)
        raise TenantShed(
            f"tenant {tenant or DEFAULT_TENANT!r} over {qos or 'default'} "
            f"rate budget; retry in {retry:.2f}s",
            retry_after_s=retry, tenant=tenant, qos=qos,
        )

    def snapshot(self) -> Dict[str, object]:
        """The reserved "qos" block for /metrics: non-empty only once
        the front door actually admitted or shed something (a quiet
        single-tenant deployment's payload is unchanged)."""
        with self._lock:
            if not (self.admitted or self.shed):
                return {}
            out: Dict[str, object] = {
                "admitted": dict(self.admitted),
                "shed": dict(self.shed),
            }
            if self.shed_wait_s:
                out["shed_wait_s"] = {
                    k: round(v, 3) for k, v in self.shed_wait_s.items()}
            levels = {}
            for (tenant, qos), b in self.buckets._buckets.items():
                b._refill(time.monotonic())
                levels[f"{tenant}/{qos or 'batch'}"] = round(b.level, 2)
            if levels:
                out["bucket_level"] = levels
            return out


#: The process singleton (the slo.ENGINE pattern): app/__main__ calls
#: ADMISSION.reconfigure() after loading config; the service checks it
#: on every generate/generate_stream.
ADMISSION = AdmissionController()
