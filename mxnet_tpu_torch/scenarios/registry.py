"""Scenario registry — the declarative half of the scenario matrix (the
port's counterpart of ``mxnet_tpu/scenarios/registry.py``, with the same
feature catalog).

A :class:`Scenario` pins ONE example-family workload (small
deterministic synthetic shapes, CPU-CI-sized) together with the stack
features it exercises and the contracts the matrix runner must hold it
to.  Registration validates the feature tags against the closed
:data:`FEATURES` catalog and refuses duplicate names, so the matrix's report rows and the
examples each scenario pins read from one source of truth that cannot
drift.

The registry is import-cheap: a scenario holds *factories* (module,
data, serving), never live modules — nothing binds or compiles until
the runner executes it.
"""
import os

__all__ = ["FEATURES", "Scenario", "register", "unregister", "get",
           "names", "scenarios", "selected_names"]

# The closed feature catalog: every tag a scenario may declare, and what
# declaring it makes the runner DO (see runner.run_scenario).  A tag not
# in this dict is a registration error — the matrix never silently
# carries a feature it does not know how to exercise or verify.
FEATURES = {
    "fit": "trains through the real Module.fit path (every scenario)",
    "batch_group": "fit(batch_group=K): K-step scanned train blocks",
    "bucketing": "BucketingModule over variable-length bucketed batches",
    "device_augment": "u8 wire batches with the augment compiled into "
                      "the step program (mxnet_tpu_torch.data.DeviceAugment)",
    "cached_dataset": "epoch >= shuffle_from served from the device "
                      "dataset cache (mxnet_tpu_torch.data.CachedDataset)",
    "sharded_cache": "pod-sharded cache tier over a VirtualCluster "
                     "(mxnet_tpu_torch.data.ShardedCachedDataset)",
    "precision": "a non-default PrecisionPolicy mode somewhere in the "
                 "train or serving path",
    "guardian": "training guardian armed through fit(guardian=...)",
    "checkpoint_resume": "kill/resume parity: a checkpointed partial "
                         "fit resumed via fit(resume_from=manager) "
                         "must land bitwise on the straight run",
    "telemetry": "telemetry live during the run; declared gauges must "
                 "be present in the registry snapshot afterwards",
    "serving_predictor": "served-inference parity through "
                         "mxnet_tpu_torch.serving.Predictor",
    "serving_decode": "served-inference parity through "
                      "mxnet_tpu_torch.serving.decode.DecodeEngine",
    "serving_gateway": "served-inference parity through the network "
                       "plane (mxnet_tpu_torch.gateway HTTP front door)",
    "chaos": "declares healable fault rules; the chaos sweep re-runs "
             "the fit under the armed seeded FaultPlan and demands "
             "bitwise equality with the fault-free run",
}

_REGISTRY = {}


class Scenario(object):
    """One pinned workload: factories + feature tags + contract knobs.

    Parameters
    ----------
    name : str
        Registry key; also the row key of the matrix report.
    features : iterable of str
        Tags from :data:`FEATURES`.  ``"fit"`` is mandatory — the
        matrix only pins real ``Module.fit`` workloads.
    make_module : callable ()-> module
        Fresh, unbound module per call (the runner builds several).
    make_data : callable (module)-> DataIter
        Fresh training iterator per call.  Receives the module so
        cache tiers (CachedDataset / ShardedCachedDataset) can adopt
        its sharding; plain iterators may ignore the argument.
    fit_kwargs : dict or callable ()-> dict
        Forwarded into ``Module.fit`` (optimizer, num_epoch,
        batch_group, initializer, eval_metric, ...).  The runner owns
        ``resume_from`` / ``epoch_end_callback`` / ``guardian``.  A
        callable is invoked per fit — use one whenever the kwargs
        carry stateful objects (metric instances), so repeat runs
        never share device-tally tokens.
    score : callable (module)-> float
        Post-fit quality measurement (may forward through an
        inference-only module; must not mutate params).
    floor : float
        Accuracy floor for the AccuracyFloor contract.
    floor_mode : "min" | "max"
        ``"min"``: score must be >= floor (accuracy-like).
        ``"max"``: score must be <= floor (perplexity/loss-like).
    serving : callable (module)-> dict, optional
        Served-inference parity probe.  Returns a dict with at least
        ``{"ok": bool}``; extra keys land in the report row.
    chaos_rules : tuple of str
        Healable fault rules (``site:kind@trigger`` grammar) for the
        chaos sweep.  Requires the ``"chaos"`` feature tag.
    gauges : tuple of str
        Registry gauge names that must exist after the run (the
        telemetry gauge-presence contract).
    resume_at : int
        Epoch boundary the kill/resume probe interrupts after
        (default: num_epoch // 2, at least 1).
    example : (str, list of str), optional
        The example-script invocation this scenario pins —
        ``(relpath under example/, argv)``: the JAX package's script
        of the same family (the port's twin, where there is one, is
        ``mxnet_tpu_torch.examples.<its basename>``).  ``None`` for workloads whose script is not portable
        to the single-device CASES harness.
    seed : int
        Seed for python/numpy/mx RNGs before every run phase.
    """

    def __init__(self, name, features, make_module, make_data,
                 fit_kwargs, score, floor, floor_mode="min",
                 serving=None, chaos_rules=(), gauges=(),
                 resume_at=None, example=None, seed=7):
        if not name or not isinstance(name, str):
            raise ValueError("scenario needs a non-empty string name")
        feats = frozenset(features)
        unknown = sorted(feats - set(FEATURES))
        if unknown:
            raise ValueError(
                "scenario %r declares unknown feature(s) %r; the "
                "catalog is %r" % (name, unknown, sorted(FEATURES)))
        if "fit" not in feats:
            raise ValueError(
                "scenario %r must declare the 'fit' feature: the "
                "matrix pins real Module.fit workloads only" % name)
        if chaos_rules and "chaos" not in feats:
            raise ValueError(
                "scenario %r carries chaos_rules but not the 'chaos' "
                "feature tag" % name)
        if "chaos" in feats and not chaos_rules:
            raise ValueError(
                "scenario %r declares 'chaos' but no chaos_rules to "
                "arm" % name)
        if floor_mode not in ("min", "max"):
            raise ValueError("floor_mode must be 'min' or 'max', got %r"
                             % (floor_mode,))
        serving_tags = feats & {"serving_predictor", "serving_decode",
                                "serving_gateway"}
        if serving_tags and serving is None:
            raise ValueError(
                "scenario %r declares %s but no serving probe"
                % (name, sorted(serving_tags)))
        self.name = name
        self.features = feats
        self.make_module = make_module
        self.make_data = make_data
        self.fit_kwargs = fit_kwargs if callable(fit_kwargs) \
            else dict(fit_kwargs)
        self.score = score
        self.floor = float(floor)
        self.floor_mode = floor_mode
        self.serving = serving
        self.chaos_rules = tuple(chaos_rules)
        self.gauges = tuple(gauges)
        self.example = example
        self.seed = int(seed)
        kw_now = self.fit_kwargs() if callable(self.fit_kwargs) \
            else self.fit_kwargs
        n_epoch = int(kw_now.get("num_epoch", 1))
        self.resume_at = max(1, n_epoch // 2) if resume_at is None \
            else int(resume_at)
        if not 0 < self.resume_at < max(n_epoch, 2) and \
                "checkpoint_resume" in feats:
            raise ValueError(
                "scenario %r: resume_at=%d outside (0, num_epoch=%d)"
                % (name, self.resume_at, n_epoch))

    def contracts(self):
        """The contract list the runner holds this scenario to —
        derived from the feature tags, in verdict order."""
        from .contracts import (AccuracyFloor, BitwiseRepeat,
                                GaugePresent, ResumeParity,
                                ServingParity, ZeroRetraces)
        out = [BitwiseRepeat(), ZeroRetraces(),
               AccuracyFloor(self.floor, mode=self.floor_mode)]
        if "telemetry" in self.features and self.gauges:
            out.append(GaugePresent(self.gauges))
        if "checkpoint_resume" in self.features:
            out.append(ResumeParity())
        if self.features & {"serving_predictor", "serving_decode",
                            "serving_gateway"}:
            out.append(ServingParity())
        return out

    def __repr__(self):
        return "Scenario(%r, features=%s)" % (
            self.name, sorted(self.features))


def register(scenario):
    """Add ``scenario`` to the matrix; refuses duplicate names."""
    if scenario.name in _REGISTRY:
        raise ValueError(
            "scenario %r is already registered; the matrix needs "
            "unique names (unregister it first to replace)"
            % scenario.name)
    _REGISTRY[scenario.name] = scenario
    return scenario


def unregister(name):
    """Remove a scenario (test plumbing; the seeded catalog stays)."""
    _REGISTRY.pop(name, None)


def get(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            "unknown scenario %r; registered: %r"
            % (name, sorted(_REGISTRY))) from None


def names():
    """Registered scenario names, in registration order."""
    return list(_REGISTRY)


def scenarios():
    """Registered scenarios, in registration order."""
    return list(_REGISTRY.values())


def selected_names(environ=None):
    """The scenario names a matrix run should execute, after the env
    knobs (the JAX package's):

    - ``MXNET_SCENARIOS``: comma list of exact names (error on an
      unknown name — a typo must not silently shrink the matrix);
    - ``MXNET_SCENARIO_FILTER``: case-insensitive substring filter,
      applied after MXNET_SCENARIOS.
    """
    env = os.environ if environ is None else environ
    picked = names()
    raw = (env.get("MXNET_SCENARIOS") or "").strip()
    if raw:
        asked = [t.strip() for t in raw.split(",") if t.strip()]
        unknown = [t for t in asked if t not in _REGISTRY]
        if unknown:
            raise KeyError(
                "MXNET_SCENARIOS names unknown scenario(s) %r; "
                "registered: %r" % (unknown, sorted(_REGISTRY)))
        picked = asked
    sub = (env.get("MXNET_SCENARIO_FILTER") or "").strip().lower()
    if sub:
        picked = [n for n in picked if sub in n.lower()]
    return picked
