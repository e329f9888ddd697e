"""SLOTracker — declared serving objectives judged over multi-window
rolling burn rates (the port's copy of ``mxnet_tpu/telemetry/slo.py``).

The serving instruments (latency histograms, outcome counters) say
what happened; the tracker judges it: "is p99 still inside the
objective, and how fast are we spending the error budget?" It is the
SRE-standard answer, host-side and dependency-free:

* **objectives** are declared at construction —
  ``SLOTracker(p99_ms=50, error_rate=1e-3, availability=0.999)``:

  - ``p<NN>_ms=T`` — NN% of requests must finish (successfully) within
    T ms. Error budget = ``1 - NN/100``; a request is *bad* when it
    failed OR took longer than T (deadline-missed requests are bad by
    definition).
  - ``error_rate=r`` — failed/expired request fraction must stay below
    ``r`` (budget = r).
  - ``availability=a`` — fraction of requests answered successfully
    must stay above ``a`` (budget = ``1 - a``; queue-full rejects count
    against it — shed load is unavailability the client saw).

* **burn rate** = (bad fraction in window) / (error budget): 1.0 means
  the budget is being consumed exactly at the sustainable rate, N
  means N× too fast. Evaluated over TWO rolling windows — fast
  (default 1 min) and slow (default 30 min) — and an objective is in
  **breach** only when BOTH exceed ``burn_threshold``: the fast window
  gives detection latency, the slow window keeps a transient blip from
  paging (the multi-window burn-rate alert rule from the SRE workbook).
  ``budget_remaining`` = ``max(0, 1 - burn_slow)`` — the slow window's
  view of how much budget is left at the current spend rate.

* **export** rides the existing plumbing: every objective publishes
  ``slo.<name>.<objective>.burn_rate_fast`` / ``burn_rate_slow`` /
  ``budget_remaining`` / ``breach`` gauges (plus one rollup
  ``slo.<name>.breach``) into the process registry, so the Prometheus
  endpoint and the JSONL ``flush_metrics`` snapshots carry them with
  zero new wiring. ``DynamicBatcher(slo=tracker)`` records every
  request outcome; ``tracker.breached()`` is the state the batcher's
  tenant admission sheds on.

Recording is O(1) (deque append + counters); the window scan runs in
``evaluate()`` — refreshed at most once per ``refresh_s`` from the
record path, so gauges stay fresh under traffic without a scan per
request. Pass explicit ``ts=`` / ``now=`` for deterministic replay
(the burn-rate tests drive synthetic event streams this way).
"""
from __future__ import annotations

import collections
import re
import threading
import time

__all__ = ["SLOTracker"]

_PCT_RE = re.compile(r"^p(\d{1,2})_ms$")

# request outcomes; everything not "ok" spends availability budget
OUTCOMES = ("ok", "error", "timeout", "reject")


class SLOTracker(object):
    """Multi-window burn-rate tracker over declared serving objectives
    (module docstring).

    Parameters
    ----------
    name : str
        Gauge namespace: objectives publish under ``slo.<name>.*``.
    fast_window_s / slow_window_s : float
        The two rolling evaluation windows (defaults 60 s / 1800 s).
    burn_threshold : float
        An objective breaches when BOTH windows burn faster than this
        (default 1.0 — budget spent faster than sustainable).
    capacity : int
        Bounded event ring; beyond it the oldest events age out early.
    refresh_s : float
        Max gauge staleness under traffic: ``record`` re-evaluates at
        most this often (explicit ``evaluate()`` is always fresh).
    **objectives
        ``p<NN>_ms=<threshold>``, ``error_rate=<max fraction>``,
        ``availability=<min fraction>`` (at least one required).
    """

    def __init__(self, name="serving", fast_window_s=60.0,
                 slow_window_s=1800.0, burn_threshold=1.0,
                 capacity=65536, refresh_s=1.0, registry=None,
                 **objectives):
        if not objectives:
            raise ValueError(
                "SLOTracker needs at least one objective, e.g. "
                "p99_ms=50, error_rate=1e-3, availability=0.999")
        self.name = str(name)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast_window_s must be <= slow_window_s")
        self.burn_threshold = float(burn_threshold)
        self.refresh_s = float(refresh_s)
        self._objectives = [self._parse(k, v)
                            for k, v in sorted(objectives.items())]
        self._events = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._last_eval = 0.0
        self._last_breach = False
        # monotonic breach-epoch counter: +1 on every False->True
        # transition of the rollup breach — the hysteresis-auditable
        # signal a controller consumes (a sustained breach is ONE
        # epoch however many times it is polled)
        self._breach_epochs = 0
        if registry is None:
            import mxnet_tpu_torch.telemetry as _tel
            registry = _tel.registry()
        scope = registry.scope("slo.%s" % self.name)
        self.scope = scope
        self._c_events = scope.counter("events")
        self._c_outcomes = {o: scope.counter("outcome.%s" % o)
                            for o in OUTCOMES}
        # gauges created EAGERLY: evaluate() may run inside a registry
        # snapshot iteration (a scrape), which must not get-or-create
        self._gauges = {}
        for obj in self._objectives:
            self._gauges[obj["key"]] = {
                f: scope.gauge("%s.%s" % (obj["key"], f))
                for f in ("burn_rate_fast", "burn_rate_slow",
                          "budget_remaining", "breach")}
        self._g_breach = scope.gauge("breach")
        self._g_breach_epochs = scope.gauge("breach_epochs")

    @staticmethod
    def _parse(key, value):
        m = _PCT_RE.match(key)
        if m:
            q = int(m.group(1)) / 100.0
            if not 0.0 < q < 1.0:
                raise ValueError("latency objective %r needs p1..p99"
                                 % key)
            return {"key": key, "kind": "latency",
                    "threshold_ms": float(value), "target": q,
                    "budget": 1.0 - q}
        if key == "error_rate":
            if not 0.0 < float(value) < 1.0:
                raise ValueError("error_rate must be in (0, 1)")
            return {"key": key, "kind": "error",
                    "budget": float(value)}
        if key == "availability":
            if not 0.0 < float(value) < 1.0:
                raise ValueError("availability must be in (0, 1)")
            return {"key": key, "kind": "availability",
                    "target": float(value), "budget": 1.0 - float(value)}
        raise ValueError(
            "unknown objective %r (want p<NN>_ms, error_rate, "
            "availability)" % key)

    # -- recording ------------------------------------------------------
    def record(self, latency_ms=None, outcome="ok", ts=None):
        """Record one request outcome. ``latency_ms`` is the request's
        end-to-end latency (a timeout's queue age counts — the deadline
        miss spends budget); ``outcome`` is one of ``ok`` / ``error`` /
        ``timeout`` / ``reject``. O(1) on the serving path."""
        if outcome not in OUTCOMES:
            raise ValueError("outcome %r not in %r" % (outcome, OUTCOMES))
        now = time.time() if ts is None else float(ts)
        with self._lock:
            self._events.append(
                (now, float(latency_ms) if latency_ms is not None
                 else None, outcome))
        self._c_events.add()
        self._c_outcomes[outcome].add()
        if ts is None and now - self._last_eval >= self.refresh_s:
            self.evaluate(now=now)

    @staticmethod
    def _bad(obj, latency_ms, outcome):
        kind = obj["kind"]
        if kind == "latency":
            return outcome != "ok" or (latency_ms is not None
                                       and latency_ms
                                       > obj["threshold_ms"])
        if kind == "error":
            return outcome in ("error", "timeout")
        return outcome != "ok"   # availability

    # -- evaluation -----------------------------------------------------
    def evaluate(self, now=None):
        """Scan the retained events and return the per-objective burn
        state (also published to the ``slo.<name>.*`` gauges)::

            {"<objective>": {"burn_rate_fast", "burn_rate_slow",
                             "bad_fast", "n_fast", "bad_slow", "n_slow",
                             "budget_remaining", "breach"},
             ..., "breach": any-objective, "n_events": retained,
             "breach_epochs": monotonic False->True transitions}

        Windows with no events burn 0.0 (no traffic spends no budget).
        """
        now = time.time() if now is None else float(now)
        self._last_eval = now
        fast_t0 = now - self.fast_window_s
        slow_t0 = now - self.slow_window_s
        with self._lock:
            # age out events past the slow window (bounded ring anyway)
            while self._events and self._events[0][0] < slow_t0:
                self._events.popleft()
            events = list(self._events)
        out = {"n_events": len(events)}
        any_breach = False
        for obj in self._objectives:
            n_f = bad_f = n_s = bad_s = 0
            for ts, lat, outcome in events:
                if ts > now:
                    continue
                bad = self._bad(obj, lat, outcome)
                n_s += 1
                bad_s += bad
                if ts >= fast_t0:
                    n_f += 1
                    bad_f += bad
            budget = obj["budget"]
            burn_f = (bad_f / n_f / budget) if n_f else 0.0
            burn_s = (bad_s / n_s / budget) if n_s else 0.0
            breach = (burn_f > self.burn_threshold
                      and burn_s > self.burn_threshold)
            any_breach = any_breach or breach
            state = {
                "burn_rate_fast": round(burn_f, 4),
                "burn_rate_slow": round(burn_s, 4),
                "bad_fast": bad_f, "n_fast": n_f,
                "bad_slow": bad_s, "n_slow": n_s,
                "budget_remaining": round(max(0.0, 1.0 - burn_s), 4),
                "breach": breach,
            }
            out[obj["key"]] = state
            g = self._gauges[obj["key"]]
            g["burn_rate_fast"].set(state["burn_rate_fast"])
            g["burn_rate_slow"].set(state["burn_rate_slow"])
            g["budget_remaining"].set(state["budget_remaining"])
            g["breach"].set(int(breach))
        out["breach"] = any_breach
        if any_breach and not self._last_breach:
            self._breach_epochs += 1
        out["breach_epochs"] = self._breach_epochs
        self._g_breach.set(int(any_breach))
        self._g_breach_epochs.set(self._breach_epochs)
        self._last_breach = any_breach
        return out

    def breached(self, now=None):
        """Whether ANY objective is currently in multi-window breach —
        the state a ``DynamicBatcher(slo=...)`` surfaces and its
        admission policy acts on (shed/reject the breached tenant)."""
        return self.evaluate(now=now)["breach"]

    def breached_cached(self, now=None):
        """The breach state re-evaluated at most once per ``refresh_s``
        — the admission-path spelling of :meth:`breached`: O(1) between
        refreshes, so a per-submit admission check never pays a window
        scan per request under load."""
        now = time.time() if now is None else float(now)
        if now - self._last_eval >= self.refresh_s:
            self.evaluate(now=now)
        return self._last_breach

    @property
    def breach_epochs(self):
        """Monotonic count of distinct breach episodes (False->True
        rollup transitions) as of the last evaluation — the hysteresis
        signal: a controller that acted on epoch k can tell a
        STILL-breaching tracker (same count) from a NEW breach
        (count advanced) without scraping gauge text."""
        return self._breach_epochs

    def burn_state(self, now=None):
        """The controller-facing snapshot: one fresh evaluation folded
        to

        ``{"breach", "breach_epochs", "burn_fast": {objective: rate},
        "burn_slow": {...}, "n_fast", "n_slow", "n_events"}``

        — the rollup breach verdict, the monotonic epoch counter, the
        current per-objective fast/slow burn values, and the window
        event counts (``n_fast == 0`` is the idle signal scale-in
        watches). The field set is the JAX package's."""
        state = self.evaluate(now=now)
        keys = [obj["key"] for obj in self._objectives]
        first = state[keys[0]]
        return {
            "breach": state["breach"],
            "breach_epochs": state["breach_epochs"],
            "burn_fast": {k: state[k]["burn_rate_fast"] for k in keys},
            "burn_slow": {k: state[k]["burn_rate_slow"] for k in keys},
            # every event counts into every objective's windows, so
            # the first objective's counts are THE window counts
            "n_fast": first["n_fast"],
            "n_slow": first["n_slow"],
            "n_events": state["n_events"],
        }

    def report(self, now=None):
        """Objectives + current burn state as one JSON-able dict."""
        state = self.evaluate(now=now)
        return {
            "name": self.name,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
            "objectives": [
                {k: v for k, v in obj.items()}
                for obj in self._objectives],
            "state": state,
            "breach": state["breach"],
        }
