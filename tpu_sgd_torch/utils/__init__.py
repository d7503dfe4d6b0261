"""Data loading, splitting and generation helpers, model persistence,
optimizer checkpoints and listeners of the port."""

from tpu_sgd_torch.utils.checkpoint import CheckpointManager
from tpu_sgd_torch.utils.events import (
    CollectingListener,
    IterationEvent,
    JsonLinesEventLog,
    RunEvent,
    ServeBatchEvent,
    ServeReloadEvent,
    SGDListener,
    StepTimer,
    profile_trace,
)
from tpu_sgd_torch.utils.mlutils import (
    a9a_like_data,
    append_bias,
    k_fold,
    linear_data,
    load_labeled_points,
    load_libsvm_file,
    logistic_data,
    rcv1_like_data,
    save_as_libsvm_file,
    save_labeled_points,
    svm_data,
    train_test_split,
)
from tpu_sgd_torch.utils.persistence import load_glm_model, save_glm_model

__all__ = [
    "k_fold",
    "train_test_split",
    "CheckpointManager",
    "SGDListener",
    "CollectingListener",
    "JsonLinesEventLog",
    "IterationEvent",
    "RunEvent",
    "ServeBatchEvent",
    "ServeReloadEvent",
    "StepTimer",
    "profile_trace",
    "append_bias",
    "load_labeled_points",
    "load_libsvm_file",
    "save_as_libsvm_file",
    "save_labeled_points",
    "linear_data",
    "logistic_data",
    "svm_data",
    "a9a_like_data",
    "rcv1_like_data",
    "save_glm_model",
    "load_glm_model",
]
