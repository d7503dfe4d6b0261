"""graftlint for the port — project-native static analysis + runtime
checkers: the port of ``tpu_sgd/analysis``.

The port's hazards on the card — a host read of a card tensor in a hot
loop, a cached CUDA graph or built library whose key lost a field, a
capture per new size or per iteration, a capture that bakes in a Python
number the loop changes or a host side effect that never replays, a
static output read through an alias after a later replay — and its
threaded planes' invariants (lock-guarded shared state, one project-wide
lock order, condition-variable and thread lifecycle discipline,
failpoints compiled into every hot path, every counter, span and alert
rule an SLO document or detector default names emitted somewhere) are
checked here as the JAX package's thirteen lint rules over the AST, each
read for PyTorch, plus the runtime checkers that count what a region
really did on the card (dispatches, host syncs, captures and builds)
and the runtime lock twins.

CLI: ``python -m tpu_sgd_torch.analysis.lint``.  Suppress one line with
``# graftlint: disable=<rule> -- <reason>``.  See README "Static analysis
in the port".
"""

from tpu_sgd_torch.analysis.core import (Finding, KNOWN_RULES, LintResult,
                                         ModuleFile, Rule, load_config,
                                         run_lint)
from tpu_sgd_torch.analysis.runtime import (CallbackBufferError,
                                            CompileCountError,
                                            DispatchCountError,
                                            HostSyncError, InstrumentedLock,
                                            LockOrderError,
                                            LocksetRecorder,
                                            assert_bounded_callback_buffer,
                                            assert_compile_count,
                                            assert_dispatch_count,
                                            assert_lock_order,
                                            assert_no_host_sync,
                                            count_dispatches,
                                            count_host_syncs,
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
    "CallbackBufferError", "CompileCountError", "DispatchCountError",
    "HostSyncError", "InstrumentedLock", "LockOrderError",
    "LocksetRecorder", "assert_bounded_callback_buffer",
    "assert_compile_count", "assert_dispatch_count", "assert_lock_order",
    "assert_no_host_sync", "count_dispatches", "count_host_syncs",
    "instrument_object",
]
