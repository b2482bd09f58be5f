"""Autoscaler: replica scaling driven by gateway request rates (a copy of
``arks_tpu/control/autoscaler.py``).

The reference defers autoscaling entirely to Kubernetes HPA over the
gateway/runtime Prometheus metrics (SURVEY.md §7 step 7); it ships no
autoscaling code.  The JAX package covers Kubernetes with an HPA over
the gateway's ``gateway_requests_total`` rate (its ``deploy/hpa.yaml``);
in the local single-binary mode (this module) the operator closes the
loop natively.  ``Application.spec.autoscale``:

  .. code-block:: yaml

      autoscale:
        minReplicas: 1
        maxReplicas: 4
        targetRPMPerReplica: 120          # admitted requests/min/replica
        scaleDownStabilizationSeconds: 60 # damping, HPA-style

  Each tick reads the embedded gateway's per-endpoint admitted-request
  rate, computes ``ceil(rpm / target)`` clamped to [min, max], scales UP
  immediately and DOWN only after the demand has stayed low for the
  stabilization window (flap damping — the same asymmetry HPA defaults
  to, since a cold replica group pays model-load time).

**Signals mode** (the elastic control loop): when constructed with a
``signals_source``, scaling is driven by LIVE overload evidence instead
of raw RPM — the per-tier SLO burn rate and admission-queue saturation
each backend exports on ``/readiness`` (engine.slo_burn / saturation).
One replica is added when any signal crosses its high-water mark
(ARKS_ELASTIC_BURN_HI / ARKS_ELASTIC_SAT_HI) and removed when EVERY
signal sits under its low-water mark (..._LO) — hysteresis, so a signal
oscillating between the marks holds the current shape.  Actions are
rate-limited by ARKS_ELASTIC_COOLDOWN_S (scale-up FROM ZERO is exempt:
an SLO burn against zero armed replicas is exactly the situation the
cooldown must not sit out), and scale-down still honors the
stabilization window on top of the cooldown.  An optional ``actuator``
callback fires on each scaling decision so a deployment can do the
elastic work inline (re-arm a scaled-to-zero replica via
POST /v1/elastic/resize, then Router.plan_join it).
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import threading
import time
from typing import Callable

from arks_tpu_torch.control.reconciler import Controller, Result
from arks_tpu_torch.control.resources import Application
from arks_tpu_torch import knobs

log = logging.getLogger("arks_tpu_torch.control.autoscaler")

# rate_source(namespace, served_model_name) -> requests per minute.
RateSource = Callable[[str, str], float]
# signals_source(namespace, served_model_name) -> signal dict or None
# (no data this tick).  Keys: "burn" (max per-tier SLO burn across
# serving backends), "saturation" (max admission saturation, 0-1);
# optional "ready" / "disarmed" backend counts ride into status.
SignalsSource = Callable[[str, str], "dict | None"]


def scrape_signals(addr: str, timeout: float = 2.0) -> dict | None:
    """One backend's autoscaler signals from its /readiness: admission
    saturation, worst per-tier SLO burn, armed state.  A 503 still
    yields a row (ready=False, disarmed for scaled-to-zero replicas);
    None means unreachable."""
    host, _, port = addr.partition(":")
    try:
        conn = http.client.HTTPConnection(host, int(port or 80),
                                          timeout=timeout)
        try:
            conn.request("GET", "/readiness")
            resp = conn.getresponse()
            status = resp.status
            data = resp.read()
        finally:
            conn.close()
    except (OSError, http.client.HTTPException, ValueError):
        return None
    try:
        obj = json.loads(data)
    except (ValueError, UnicodeDecodeError):
        obj = {}
    if not isinstance(obj, dict):
        obj = {}
    if status != 200:
        reason = str((obj.get("error") or {}).get("message", ""))
        return {"ready": False, "saturation": 0.0, "burn": 0.0,
                "disarmed": "disarmed" in reason, "reason": reason}
    adm = obj.get("admission") or {}
    burns = obj.get("slo_burn") or {}
    elastic = obj.get("elastic") or {}
    return {"ready": True,
            "saturation": float(adm.get("saturation", 0.0) or 0.0),
            "burn": max((float(v) for v in burns.values()), default=0.0),
            "disarmed": not elastic.get("armed", True),
            "reason": ""}


def fleet_signals(addrs: list[str]) -> dict | None:
    """Merge scrape_signals over a backend list into one signal dict
    (the stock ``signals_source`` for address-list deployments): worst
    burn/saturation across READY backends, plus ready/disarmed counts.
    None when no backend answered at all."""
    rows = [s for s in (scrape_signals(a) for a in addrs) if s is not None]
    if not rows:
        return None
    ready = [r for r in rows if r["ready"]]
    return {"burn": max((r["burn"] for r in ready), default=0.0),
            "saturation": max((r["saturation"] for r in ready),
                              default=0.0),
            "ready": len(ready),
            "disarmed": sum(1 for r in rows if r.get("disarmed"))}


class AutoscalerController(Controller):
    KIND = Application

    def __init__(self, store, rate_source: RateSource,
                 interval_s: float = 10.0,
                 signals_source: SignalsSource | None = None,
                 actuator=None):
        super().__init__(store, workers=1)
        self.rate_source = rate_source
        self.interval_s = interval_s
        self.signals_source = signals_source
        # actuator(app, desired, signals) — inline elastic action hook
        # (re-arm + planned join); failures log, never derail reconcile.
        self.actuator = actuator
        # (ns, name) -> monotonic time of the last signals-mode scaling
        # action (the ARKS_ELASTIC_COOLDOWN_S clock).
        self._last_action: dict[tuple[str, str], float] = {}
        # (ns, name) -> monotonic time the demand first dropped below the
        # current replica count (scale-down stabilization clock).
        self._below_since: dict[tuple[str, str], float] = {}
        # (ns, name) -> last status written (suppress no-op status churn:
        # each write fires a watch event that wakes every Application
        # watcher, so continuous observedRPM jitter must not write).
        self._last_status: dict[tuple[str, str], dict] = {}
        self._ticker: threading.Thread | None = None
        self._tick_stop = threading.Event()

    # Periodic evaluation runs off a DEDICATED ticker, not Result requeues:
    # a self-requeue per reconcile compounds with watch-triggered reconciles
    # (our own status writes included) into an ever-growing stream of
    # delayed queue entries — measured 13x the configured rate before this
    # design.  The ticker enqueues each autoscaled app once per interval;
    # watch events still give immediate reaction to spec edits.
    def start(self) -> None:
        super().start()

        def tick() -> None:
            while not self._tick_stop.wait(self.interval_s):
                try:
                    for app in self.store.list(Application):
                        if app.spec.get("autoscale"):
                            self.queue.add(app.key)
                except Exception:
                    log.exception("autoscaler tick failed")

        self._ticker = threading.Thread(target=tick, name="autoscaler-tick",
                                        daemon=True)
        self._ticker.start()
        self._threads.append(self._ticker)

    def stop(self) -> None:
        # The ticker wakes at once (the reference's sleeps out its
        # interval, holding stop() up to the join's 5 s).
        self._tick_stop.set()
        super().stop()

    def finalize(self, app: Application) -> None:
        self._below_since.pop(app.key, None)
        self._last_status.pop(app.key, None)
        self._last_action.pop(app.key, None)

    def _demand_share(self, app: Application) -> float:
        """This app's share of the endpoint's demand.  The endpoint
        controller routes one served name across every SERVING backend —
        standalone or disaggregated — with equal default weights
        (endpoint_controller), so each backend sees total/N.  Peers are
        counted by the same serving() rule the router uses: a crash-looping
        peer takes no traffic and must not dilute this app's share."""
        from arks_tpu_torch.control.resources import DisaggregatedApplication
        served = app.served_model_name
        total = float(self.rate_source(app.namespace, served))
        peers = 0
        for kind in (Application, DisaggregatedApplication):
            for a in self.store.list(kind, namespace=app.namespace):
                if a.served_model_name == served and a.serving():
                    peers += 1
        # A not-yet-serving SELF joins the rotation the moment it comes up,
        # so it counts toward its own divisor — otherwise a freshly created
        # peer briefly sees the whole endpoint's demand and over-scales
        # until the scale-down window corrects it.
        if not app.serving():
            peers += 1
        return total / max(peers, 1)

    def reconcile(self, app: Application) -> Result | None:
        au = app.spec.get("autoscale")
        if not au:
            self._below_since.pop(app.key, None)
            self._last_status.pop(app.key, None)
            self._last_action.pop(app.key, None)
            return None
        lo = max(au.get("minReplicas", 1), 0)
        hi = max(au.get("maxReplicas", lo), lo)
        if self.signals_source is not None and au.get("signals", True):
            return self._reconcile_signals(app, au, lo, hi)
        target = max(au.get("targetRPMPerReplica", 60), 1)
        rpm = self._demand_share(app)
        cur = app.spec.get("replicas", 1)
        desired = min(hi, max(lo, math.ceil(rpm / target)))

        now = time.monotonic()
        if desired > cur:
            # Scale up immediately: under-provisioning is user-visible.
            self._below_since.pop(app.key, None)
            self._scale(app, desired, rpm)
            return None
        if desired < cur:
            stab = au.get("scaleDownStabilizationSeconds", 60)
            since = self._below_since.setdefault(app.key, now)
            if now - since >= stab:
                self._scale(app, desired, rpm)
                self._below_since.pop(app.key, None)
            return None
        self._below_since.pop(app.key, None)
        status = {"observedRPM": round(rpm, 1), "desiredReplicas": desired}
        last = self._last_status.get(app.key)
        # Write only on a meaningful change (desired flip, or rpm moved by
        # >10% or >1): jitter-driven writes would storm every watcher.
        if last is None or last["desiredReplicas"] != desired or (
                abs(last["observedRPM"] - status["observedRPM"])
                > max(1.0, 0.1 * max(last["observedRPM"], 1.0))):
            app.status["autoscale"] = status
            self.store.update_status(app)
            self._last_status[app.key] = status
        return None

    def _scale(self, app: Application, desired: int, rpm: float) -> None:
        log.info("autoscale %s/%s: rpm=%.1f replicas %d -> %d",
                 app.namespace, app.name, rpm,
                 app.spec.get("replicas", 1), desired)
        app.spec["replicas"] = desired
        status = {"observedRPM": round(rpm, 1), "desiredReplicas": desired}
        app.status["autoscale"] = status
        self._last_status[app.key] = status
        # Spec write wakes the ApplicationController, which resizes the
        # GangSet; a Conflict (someone else wrote first) retries via the
        # workqueue's error backoff against the fresh object.
        self.store.update(app)

    # ---- signals mode (elastic control loop) -------------------------

    def _reconcile_signals(self, app: Application, au: dict,
                           lo: int, hi: int) -> Result | None:
        sig = self.signals_source(app.namespace, app.served_model_name)
        if sig is None:
            # No backend answered this tick: hold shape — scaling on
            # missing evidence is how control loops flap a fleet.
            return None
        burn = float(sig.get("burn", 0.0))
        sat = float(sig.get("saturation", 0.0))
        cur = app.spec.get("replicas", 1)
        now = time.monotonic()
        cooldown = knobs.get_float("ARKS_ELASTIC_COOLDOWN_S")
        last = self._last_action.get(app.key)
        # Hysteresis: up when ANY signal crosses its high-water mark,
        # down only when EVERY signal sits under its low-water mark;
        # the band between holds the current shape.
        up = (burn >= knobs.get_float("ARKS_ELASTIC_BURN_HI")
              or sat >= knobs.get_float("ARKS_ELASTIC_SAT_HI"))
        down = (burn <= knobs.get_float("ARKS_ELASTIC_BURN_LO")
                and sat <= knobs.get_float("ARKS_ELASTIC_SAT_LO"))
        desired = cur
        reason = "steady"
        if up:
            desired, reason = min(hi, cur + 1), "signal_high"
        elif down:
            desired, reason = max(lo, cur - 1), "signal_low"
        if desired > cur:
            self._below_since.pop(app.key, None)
            # Cooldown damps action flapping — EXCEPT scale-up from
            # zero: an SLO burn against zero armed replicas is exactly
            # what the loop exists to rescue, immediately.
            if cur > 0 and last is not None and now - last < cooldown:
                self._write_signals_status(app, cur, burn, sat,
                                           "cooldown", sig)
                return None
            self._last_action[app.key] = now
            self._scale_signals(app, desired, burn, sat, reason, sig)
            return None
        if desired < cur:
            stab = au.get("scaleDownStabilizationSeconds", 60)
            since = self._below_since.setdefault(app.key, now)
            if now - since < stab or (
                    last is not None and now - last < cooldown):
                self._write_signals_status(app, cur, burn, sat,
                                           "stabilizing", sig)
                return None
            self._below_since.pop(app.key, None)
            self._last_action[app.key] = now
            self._scale_signals(app, desired, burn, sat, reason, sig)
            return None
        self._below_since.pop(app.key, None)
        self._write_signals_status(app, desired, burn, sat, reason, sig)
        return None

    def _signals_status(self, desired: int, burn: float, sat: float,
                        reason: str, sig: dict) -> dict:
        status = {"mode": "signals", "desiredReplicas": desired,
                  "burnRate": round(burn, 3), "saturation": round(sat, 3),
                  "reason": reason}
        for k in ("ready", "disarmed"):
            if k in sig:
                status[k] = sig[k]
        return status

    def _write_signals_status(self, app: Application, desired: int,
                              burn: float, sat: float, reason: str,
                              sig: dict) -> None:
        status = self._signals_status(desired, burn, sat, reason, sig)
        last = self._last_status.get(app.key)
        # Same churn guard as RPM mode: only a meaningful move writes
        # (desired/reason flip, or a signal moved past jitter).
        if last is not None and last.get("desiredReplicas") == desired \
                and last.get("reason") == reason \
                and abs(last.get("burnRate", 0.0) - status["burnRate"]) \
                <= max(0.05, 0.1 * max(last.get("burnRate", 0.0), 0.0)) \
                and abs(last.get("saturation", 0.0)
                        - status["saturation"]) <= 0.05:
            return
        app.status["autoscale"] = status
        self.store.update_status(app)
        self._last_status[app.key] = status

    def _scale_signals(self, app: Application, desired: int, burn: float,
                       sat: float, reason: str, sig: dict) -> None:
        log.info("autoscale(signals) %s/%s: burn=%.2f sat=%.2f "
                 "replicas %d -> %d (%s)", app.namespace, app.name,
                 burn, sat, app.spec.get("replicas", 1), desired, reason)
        app.spec["replicas"] = desired
        status = self._signals_status(desired, burn, sat, reason, sig)
        app.status["autoscale"] = status
        self._last_status[app.key] = status
        self.store.update(app)
        if self.actuator is not None:
            # Inline elastic action (re-arm a scaled-to-zero replica,
            # planned join) — best-effort: the spec write above already
            # converges the deployment even if this hook fails.
            try:
                self.actuator(app, desired, dict(sig))
            except Exception:
                log.exception("elastic actuator failed for %s/%s",
                              app.namespace, app.name)
