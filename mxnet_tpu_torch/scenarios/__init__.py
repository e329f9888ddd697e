"""mxnet_tpu_torch.scenarios — pinned-workload scenario matrix (the
port's counterpart of ``mxnet_tpu/scenarios``).

A declarative registry of pinned workloads (the example/ long tail,
CPU-CI-sized), a contract engine, and a matrix runner that executes
each scenario through the real ``Module.fit`` / serving stack and
judges bitwise-repeat, zero-retrace, accuracy-floor, gauge-presence,
kill/resume and chaos-heal contracts.  Every scenario builds its modules
(and its decode engine) on the current context: ``gpu(0)`` unless the
caller runs the matrix inside ``with mx.cpu():``.

Quick start::

    from mxnet_tpu_torch import scenarios
    report = scenarios.run_matrix()          # all registered
    row = scenarios.run_scenario("nce_loss")  # one, by name

Selection knobs: ``MXNET_SCENARIOS`` (comma list of exact names) and
``MXNET_SCENARIO_FILTER`` (substring), as in the JAX package.
"""
from .contracts import (AccuracyFloor, BitwiseRepeat, ChaosHeal,
                        Contract, GaugePresent, ResumeParity,
                        ServingParity, Verdict, ZeroRetraces, evaluate)
from .registry import (FEATURES, Scenario, get, names, register,
                       scenarios, selected_names, unregister)
from .runner import chaos_sweep, param_digest, run_matrix, run_scenario

# importing the catalog registers the seeded matrix
from . import catalog  # noqa: F401  (import is the side effect)

__all__ = [
    "FEATURES", "Scenario", "register", "unregister", "get", "names",
    "scenarios", "selected_names",
    "Verdict", "Contract", "BitwiseRepeat", "ZeroRetraces",
    "AccuracyFloor", "GaugePresent", "ResumeParity", "ServingParity",
    "ChaosHeal", "evaluate",
    "param_digest", "run_scenario", "run_matrix", "chaos_sweep",
]
