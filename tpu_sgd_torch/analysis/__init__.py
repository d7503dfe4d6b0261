"""graftlint for the port — project-native static analysis + runtime
checkers (the framework-free half of ``tpu_sgd/analysis``).

The port's threaded planes (replicas, serving, tenants, observability)
carry the same invariants as the JAX package's — lock-guarded shared
state, one project-wide lock order, condition-variable and thread
lifecycle discipline, failpoints compiled into every hot path, and every
counter, span and alert rule an SLO document or detector default names
emitted somewhere — checked here as lint rules over the AST, plus the
runtime lock twins tests use to validate the declarations themselves.
The rules are the JAX package's, finding for finding; the rules about
JAX tracing (shape-trap, host-sync, memo-key, ...) wait for ROADMAP A12
step 2.

CLI: ``python -m tpu_sgd_torch.analysis.lint``.  Suppress one line with
``# graftlint: disable=<rule> -- <reason>``.  See README "Static analysis
in the port".
"""

from tpu_sgd_torch.analysis.core import (Finding, KNOWN_RULES, LintResult,
                                         ModuleFile, Rule, load_config,
                                         run_lint)
from tpu_sgd_torch.analysis.runtime import (InstrumentedLock,
                                            LockOrderError,
                                            LocksetRecorder,
                                            assert_lock_order,
                                            instrument_object)

#: THE port's lock order — every (outer, inner) acquisition nesting the
#: static lock-order graph (``rules_order.py``) discovers over
#: ``tpu_sgd_torch/``, committed.  Nodes are ``DeclaringClass.lockattr``
#: per the ``GRAFTLINT_LOCKS`` grammar.  The rule fails lint when the
#: graph and this declaration drift in EITHER direction: a new nesting
#: must be added here (after checking it does not invert an existing
#: pair), an inverted nesting names both acquisition paths, and a pair
#: the graph no longer finds must be deleted.
#: ``runtime.assert_lock_order`` replays recorded acquisition sequences
#: from live tests against the same pairs (transitively closed),
#: covering callback-routed acquisitions the static graph cannot see
#: (the HA ``set_replication(log.append)`` hook).  The graph over the
#: port finds exactly the JAX package's pairs: StoreSupervisor._lock sits
#: above the whole replica plane; ParameterStore._cond above the shard
#: pipelines, the heartbeat and the obs counters; WindowStore._lock ->
#: _dispatch_cv.
GRAFTLINT_LOCK_ORDER = (
    ("MicroBatcher._cond", "RuntimeCounters._lock"),
    ("ParameterStore._cond", "Heartbeat._lock"),
    ("ParameterStore._cond", "RuntimeCounters._lock"),
    ("ParameterStore._cond", "ShardPipeline._cond"),
    ("StoreSupervisor._lock", "DeltaLog._cond"),
    ("StoreSupervisor._lock", "ParameterStore._cond"),
    ("StoreSupervisor._lock", "RuntimeCounters._lock"),
    ("WindowStore._lock", "WindowStore._dispatch_cv"),
)

__all__ = [
    "Finding", "GRAFTLINT_LOCK_ORDER", "KNOWN_RULES", "LintResult",
    "ModuleFile", "Rule", "load_config", "run_lint",
    "InstrumentedLock", "LockOrderError", "LocksetRecorder",
    "assert_lock_order", "instrument_object",
]
