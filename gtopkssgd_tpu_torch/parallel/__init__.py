"""Data parallelism over ``torch.distributed``: the gradient collectives
(``collectives``), the wire codecs they ship (``codec``), the comm model
and the planner that pick a wire (``comm_model``, ``planner``), the
layer-wise buckets (``bucketing``), and the process group and rank
processes (``dist``)."""

from gtopkssgd_tpu_torch.parallel.collectives import (
    balanced_cap,
    balanced_gtopk_allreduce,
    balanced_ref,
    comm_bytes_per_step,
    dense_allreduce,
    gtopk_allreduce,
    hier_gtopk_allreduce,
    ici_dense_psum,
    ici_psum_sends,
    merge_tree_ref,
    pmean,
    reset_wire,
    sparse_allreduce,
    topk_allgather,
    tree_rounds,
    wire,
)

__all__ = [
    "balanced_cap",
    "balanced_gtopk_allreduce",
    "balanced_ref",
    "comm_bytes_per_step",
    "dense_allreduce",
    "gtopk_allreduce",
    "hier_gtopk_allreduce",
    "ici_dense_psum",
    "ici_psum_sends",
    "merge_tree_ref",
    "pmean",
    "reset_wire",
    "sparse_allreduce",
    "topk_allgather",
    "tree_rounds",
    "wire",
]
