"""Elastic fleet membership: scale the decode tier from the signals the
fleet already exports.

Counterpart of the JAX package's `serve/elastic.py`. Host code with an
explicit clock: it needs no torch.

`FleetAutoscaler` watches three live signals, the queue-depth EWMA per
serving replica, SLO burn (`utils/slo.ENGINE`) and KV pressure
(`pages_withheld` in the pool's page stats), and grows or shrinks the
fleet through `SchedulerPool.add_replica` / `retire_replica` within
[`LSOT_FLEET_MIN`, `LSOT_FLEET_MAX`]. Hysteresis is explicit: a scale
signal must hold continuously for `LSOT_SCALE_HOLD_S` before the
autoscaler acts, and consecutive actions are at least
`LSOT_SCALE_INTERVAL_S` apart, so a bursty queue cannot flap the fleet.

Scale-up pops a replica from the `spawn` callable (the app wires it to
standby worker addresses, `serve/factory.standby_spawner`, tests to an
in-process factory); the attempt consults the fault registry's
`fleet:spawn` site first, so chaos can show that a failed spawn degrades
to "keep serving on the current fleet" rather than wedging the control
loop. Scale-down rides `drain_replica` (drain, re-place, remove): no
acknowledged request is lost, and only replicas the autoscaler itself
added are eligible; an operator-configured replica never retires.

`step(now)` is deterministic (explicit clock) for tests and chaos;
`run()` / `stop()` wrap it in a daemon thread for the app.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, Optional

from ..utils.faults import FAULTS, InjectedFault

_log = logging.getLogger("lsot.elastic")


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FleetAutoscaler:
    """Signal-driven membership control for a `SchedulerPool`, or a
    `SupervisedScheduler` wrapping one (its fleet passthroughs make the
    two interchangeable here)."""

    def __init__(
        self,
        pool,
        spawn: Callable[[], object],
        *,
        fleet_min: Optional[int] = None,
        fleet_max: Optional[int] = None,
        scale_up_q: Optional[float] = None,
        scale_down_q: Optional[float] = None,
        hold_s: Optional[float] = None,
        interval_s: Optional[float] = None,
        drain_deadline_s: float = 30.0,
        ewma_alpha: float = 0.5,
    ):
        self.pool = pool
        self._spawn = spawn
        base = self._fleet_size()
        self.fleet_min = int(fleet_min if fleet_min is not None
                             else _env_f("LSOT_FLEET_MIN", base))
        self.fleet_max = int(fleet_max if fleet_max is not None
                             else _env_f("LSOT_FLEET_MAX", base + 4))
        if self.fleet_max < self.fleet_min:
            raise ValueError(f"LSOT_FLEET_MAX={self.fleet_max} < "
                             f"LSOT_FLEET_MIN={self.fleet_min}")
        # Queue-depth thresholds are per serving replica (queued requests
        # over the serving count), so one knob fits a fleet of 2 or 20.
        self.scale_up_q = float(scale_up_q if scale_up_q is not None
                                else _env_f("LSOT_SCALE_UP_Q", 4.0))
        self.scale_down_q = float(scale_down_q if scale_down_q is not None
                                  else _env_f("LSOT_SCALE_DOWN_Q", 0.5))
        self.hold_s = float(hold_s if hold_s is not None
                            else _env_f("LSOT_SCALE_HOLD_S", 3.0))
        self.interval_s = float(interval_s if interval_s is not None
                                else _env_f("LSOT_SCALE_INTERVAL_S", 5.0))
        self.drain_deadline_s = float(drain_deadline_s)
        self._alpha = float(ewma_alpha)
        self._ewma: Optional[float] = None
        self._up_since: Optional[float] = None
        self._down_since: Optional[float] = None
        self._cooldown_until = 0.0
        self._last_signal: Optional[Dict[str, object]] = None
        self._stats = {"steps": 0, "ups": 0, "downs": 0,
                       "spawn_failures": 0, "spawn_empty": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ signals

    def _fleet_size(self) -> int:
        fs = getattr(self.pool, "fleet_stats", None)
        if callable(fs):
            stats = fs() or {}
            return int(stats.get("serving", stats.get("size", 1)) or 1)
        return 1

    def _signals(self) -> Dict[str, object]:
        """One read of the fleet's exported state -> the three scale
        signals. Every read is best-effort: a fleet churning mid-read must
        not crash the control loop."""
        queued = 0
        serving = max(1, self._fleet_size())
        loads = getattr(self.pool, "replica_loads", None)
        if callable(loads):
            try:
                for rec in loads() or []:
                    queued += int(rec.get("queued", 0) or 0)
            except Exception:  # noqa: BLE001 — churning fleet mid-read
                pass
        depth = queued / serving
        self._ewma = (depth if self._ewma is None
                      else self._alpha * depth + (1.0 - self._alpha) * self._ewma)
        burning = False
        try:
            from ..utils import slo as _slo

            burning = bool(_slo.ENGINE.enabled and _slo.ENGINE.burning())
        except Exception:  # noqa: BLE001 — the SLO engine is optional
            pass
        pressure = False
        try:
            pstats = getattr(self.pool, "page_stats", None)
            if pstats:
                pressure = int(pstats.get("pages_withheld", 0) or 0) > 0
        except Exception:  # noqa: BLE001 — churning fleet mid-read
            pass
        return {"queue_ewma": round(self._ewma, 4), "slo_burn": burning,
                "kv_pressure": pressure, "serving": serving}

    # ------------------------------------------------------------ control

    def step(self, now: float) -> Optional[str]:
        """One control tick at time `now` (monotonic seconds, explicit so
        tests and chaos drive the hysteresis deterministically). Returns
        "up" or "down" when an action fired, else None."""
        self._stats["steps"] += 1
        sig = self._signals()
        self._last_signal = sig
        serving = int(sig["serving"])
        want_up = (serving < self.fleet_max
                   and (sig["queue_ewma"] >= self.scale_up_q
                        or sig["slo_burn"] or sig["kv_pressure"]))
        want_down = (serving > self.fleet_min
                     and sig["queue_ewma"] <= self.scale_down_q
                     and not sig["slo_burn"] and not sig["kv_pressure"])
        # Hysteresis: the direction must hold continuously for hold_s.
        if want_up:
            if self._up_since is None:
                self._up_since = now
        else:
            self._up_since = None
        if want_down:
            if self._down_since is None:
                self._down_since = now
        else:
            self._down_since = None
        if now < self._cooldown_until:
            return None
        if self._up_since is not None and now - self._up_since >= self.hold_s:
            fired = self._scale_up()
            self._cooldown_until = now + self.interval_s
            self._up_since = self._down_since = None
            return "up" if fired else None
        if self._down_since is not None and now - self._down_since >= self.hold_s:
            fired = self._scale_down()
            self._cooldown_until = now + self.interval_s
            self._up_since = self._down_since = None
            return "down" if fired else None
        return None

    def _scale_up(self) -> bool:
        # The `fleet:spawn` seam fires here, so an injected spawn failure
        # (a standby host that is gone) is a counted, logged non-event: the
        # fleet keeps serving at its current size.
        try:
            FAULTS.check("fleet:spawn")
            replica = self._spawn()
        except InjectedFault as e:
            self._stats["spawn_failures"] += 1
            _log.warning("fleet scale-up spawn failed (injected): %s", e)
            return False
        except Exception:  # noqa: BLE001 — a dead standby host
            self._stats["spawn_failures"] += 1
            _log.exception("fleet scale-up spawn failed")
            return False
        if replica is None:
            self._stats["spawn_empty"] += 1
            return False
        add = getattr(self.pool, "add_replica", None)
        if not callable(add):
            return False
        label = add(replica, elastic=True)
        self._stats["ups"] += 1
        _log.info("fleet scaled up: joined %s", label)
        return True

    def _scale_down(self) -> bool:
        retire = getattr(self.pool, "retire_replica", None)
        if not callable(retire):
            return False
        out = retire(deadline_s=self.drain_deadline_s)
        if not out:
            return False
        self._stats["downs"] += 1
        _log.info("fleet scaled down: retired %s", out.get("replica"))
        return True

    # -------------------------------------------------------- observability

    def stats(self) -> Dict[str, object]:
        out = dict(self._stats)
        out.update({"fleet_min": self.fleet_min, "fleet_max": self.fleet_max,
                    "scale_up_q": self.scale_up_q, "scale_down_q": self.scale_down_q,
                    "hold_s": self.hold_s, "interval_s": self.interval_s})
        if self._last_signal:
            out["signal"] = self._last_signal
        return out

    # ------------------------------------------------------------- thread

    def run(self, tick_s: float = 0.25) -> "FleetAutoscaler":
        """Start the control loop in a daemon thread (the app's path). The
        tick is faster than hold_s, so the hysteresis window, not the poll
        cadence, decides how fast the fleet responds."""
        import time as _time

        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(tick_s):
                try:
                    self.step(_time.monotonic())
                except Exception:  # noqa: BLE001 — the control loop survives
                    _log.exception("autoscaler step failed")

        self._thread = threading.Thread(target=loop, name="lsot-fleet-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
