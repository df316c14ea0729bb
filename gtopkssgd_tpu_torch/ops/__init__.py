"""Top-k selection: the hand-written CUDA kernels (``cuda_topk``) and the
selection methods and sparse-set helpers built on them (``topk``)."""

from gtopkssgd_tpu_torch.ops.topk import (
    blockwise_topk_abs,
    bucketize_counts,
    k_for_density,
    membership_mask,
    merge_sparse_sets,
    scatter_add_dense,
    select_tau,
    select_topk,
    simrecall_topk_abs,
    threshold_topk_abs,
    topk_abs,
    twostage_topk_abs,
)

__all__ = [
    "blockwise_topk_abs",
    "bucketize_counts",
    "k_for_density",
    "membership_mask",
    "merge_sparse_sets",
    "scatter_add_dense",
    "select_tau",
    "select_topk",
    "simrecall_topk_abs",
    "threshold_topk_abs",
    "topk_abs",
    "twostage_topk_abs",
]
