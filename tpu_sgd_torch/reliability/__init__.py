"""The failure-handling planes of the port (``tpu_sgd/reliability``):

* :mod:`~tpu_sgd_torch.reliability.failpoints`: named, seeded,
  deterministic fault injection at the hook sites (no-ops when
  disabled);
* :mod:`~tpu_sgd_torch.reliability.retry`: ``RetryPolicy``,
  ``Deadline`` and ``CircuitBreaker``;
* :mod:`~tpu_sgd_torch.reliability.supervisor`: ``TrainingSupervisor``,
  auto-checkpoint, cooperative preemption and crash-resume to bitwise
  identical weights.

The JAX package's ``health`` module (heartbeats and straggler monitors)
waits for its time series (ROADMAP A11).

Quickstart::

    from tpu_sgd_torch.reliability import RetryPolicy, TrainingSupervisor

    sup = TrainingSupervisor(opt, checkpoint_manager=ckpt_dir,
                             checkpoint_every=5,
                             retry=RetryPolicy(max_attempts=5, seed=0))
    result = sup.run((X, y), w0)     # survives crashes and SIGTERM
"""

from tpu_sgd_torch.reliability.failpoints import (
    FailpointSpec,
    FaultInjected,
    corrupt_nth,
    corrupt_prob,
    corruptpoint,
    fail_nth,
    fail_prob,
    failpoint,
    inject_faults,
    inject_latency,
)
from tpu_sgd_torch.reliability.retry import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    RetriesExhausted,
    RetryPolicy,
)
from tpu_sgd_torch.reliability.supervisor import (
    SupervisedResult,
    TrainingPreempted,
    TrainingSupervisor,
)

__all__ = [
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceeded",
    "FailpointSpec",
    "FaultInjected",
    "RetriesExhausted",
    "RetryPolicy",
    "SupervisedResult",
    "TrainingPreempted",
    "TrainingSupervisor",
    "corrupt_nth",
    "corrupt_prob",
    "corruptpoint",
    "fail_nth",
    "fail_prob",
    "failpoint",
    "inject_faults",
    "inject_latency",
]
