"""Data loading, splitting and generation helpers of the port."""

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

__all__ = [
    "a9a_like_data", "append_bias", "k_fold", "linear_data",
    "load_labeled_points", "load_libsvm_file", "logistic_data",
    "rcv1_like_data", "save_as_libsvm_file", "save_labeled_points",
    "svm_data", "train_test_split",
]
