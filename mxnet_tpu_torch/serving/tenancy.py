"""Multi-model tenancy — several named Predictors behind one queue (the
port's copy of ``mxnet_tpu/serving/tenancy.py``).

One serving process, one :class:`DynamicBatcher`, several models (or
several checkpoint generations of ONE model, for canary rollout):
each :class:`Tenant` binds a name to a Predictor, an optional
:class:`~mxnet_tpu_torch.telemetry.SLOTracker`, and an admission priority.
Requests route by tenant name; the worker coalesces launches WITHIN a
tenant (different tenants run different models) and picks
the next launch by (priority, oldest head request), so a high-priority
tenant's backlog is served first while FIFO order holds within each
tenant.

Observability stays per-tenant by construction: every Predictor owns
its own ``serving.<i>.*`` registry scope (counters, latency/phase
histograms, warmup gauges) and every tenant's tracker its own
``slo.<name>.*`` burn-rate gauges — a p99 regression or a shed
decision is attributable to ONE tenant on a single scrape.

Admission policy (the consumer of the ``slo_breached()`` hook):

* a tenant whose OWN fast+slow burn windows are in breach is **shed**
  — new submits raise :class:`~mxnet_tpu_torch.serving.TenantShed`
  synchronously, and already-queued requests are dropped at dequeue
  time with their queue age traced (``outcome: "shed"``) — unless the
  tenant is protected;
* ``priority >= 1`` marks a tenant protected (never shed — it keeps
  serving through its own breach; use for the production generation
  in a canary pair), as does ``protected=True`` or listing the name in
  ``MXNET_SERVE_TENANT_PROTECTED``;
* shed decisions are recorded in the tenant's serving stats (``sheds``
  counter, ``shed_age_ms`` histogram, trace ring) but are NOT fed back
  into the tenant's SLOTracker — recording its own sheds as
  unavailability would lock a breached tenant out forever; instead the
  bad events age out of the burn windows and the tenant readmits
  itself once its budget recovers;
* ``MXNET_SERVE_TENANT_SHED=0`` disables shedding process-wide
  (breaches then only gauge/report, the pre-tenancy behavior).

A canary rollout serves two checkpoints of one model::

    stable = Predictor.load("model", 100, data_shapes=shapes)
    canary = Predictor.load("model", 110, data_shapes=shapes)
    srv = DynamicBatcher(tenants={
        "stable": Tenant("stable", stable, priority=1,
                         slo=SLOTracker("stable", p99_ms=50,
                                        availability=0.999)),
        "canary": Tenant("canary", canary,
                         slo=SLOTracker("canary", p99_ms=50,
                                        availability=0.99)),
    })
    srv.submit(x, tenant="canary")   # sheds itself on its own breach
"""
from __future__ import annotations

import os

from .predictor import Predictor

__all__ = ["Tenant"]


def _env_protected_names():
    raw = os.environ.get("MXNET_SERVE_TENANT_PROTECTED", "")
    return {s.strip() for s in raw.split(",") if s.strip()}


def shed_enabled():
    """Process-wide master switch for SLO-driven admission shedding
    (``MXNET_SERVE_TENANT_SHED``, default on)."""
    return os.environ.get("MXNET_SERVE_TENANT_SHED", "1") != "0"


class Tenant(object):
    """One named model behind the shared queue.

    Parameters
    ----------
    name : str
        Routing key (``submit(..., tenant=name)``) and the spelling
        shed warnings/telemetry use.
    predictor : Predictor
        The tenant's bucketed inference engine; its ``ServingStats``
        scope is the tenant's per-request observability.
    slo : mxnet_tpu_torch.telemetry.SLOTracker, optional
        The tenant's declared objectives. Every outcome of THIS
        tenant's traffic records against it, and its multi-window
        breach state drives the admission decision. Without one the
        tenant is never shed (nothing to breach).
    priority : int
        Admission priority (default 0). The worker serves the
        highest-priority backlog first; ``priority >= 1`` additionally
        protects the tenant from shedding.
    protected : bool, optional
        Explicit shed exemption; defaults to ``priority >= 1``. Names
        in ``MXNET_SERVE_TENANT_PROTECTED`` are always protected.
    """

    def __init__(self, name, predictor, slo=None, priority=0,
                 protected=None):
        if not isinstance(predictor, Predictor):
            raise TypeError(
                "Tenant %r needs a Predictor (got %s)"
                % (name, type(predictor).__name__))
        self.name = str(name)
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        self.predictor = predictor
        self.slo = slo
        self.priority = int(priority)
        if protected is None:
            protected = self.priority >= 1
        self._protected = bool(protected)

    @property
    def protected(self):
        """Shed exemption — explicit/priority protection fixed at
        construction, plus a LIVE read of
        ``MXNET_SERVE_TENANT_PROTECTED`` (like the
        ``MXNET_SERVE_TENANT_SHED`` master switch, so an operator can
        protect a tenant mid-incident without a restart)."""
        return self._protected or self.name in _env_protected_names()

    @property
    def stats(self):
        """The tenant's :class:`ServingStats` (the Predictor's)."""
        return self.predictor._stats

    def shed_active(self):
        """Whether admission is currently shedding this tenant: its
        own SLO in multi-window breach, tenant not protected, shedding
        enabled. O(1) between the tracker's ``refresh_s`` windows."""
        return (shed_enabled() and self.slo is not None
                and not self.protected and self.slo.breached_cached())

    def __repr__(self):
        return ("Tenant(%r, priority=%d%s%s)"
                % (self.name, self.priority,
                   ", protected" if self.protected else "",
                   ", slo=%s" % self.slo.name if self.slo is not None
                   else ""))
