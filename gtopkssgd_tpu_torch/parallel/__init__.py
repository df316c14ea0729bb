"""Data parallelism over ``torch.distributed``: the gradient collectives
(``collectives``), the wire codecs they ship (``codec``), and the process
group and rank processes (``dist``)."""

from gtopkssgd_tpu_torch.parallel.collectives import (
    comm_bytes_per_step,
    dense_allreduce,
    gtopk_allreduce,
    merge_tree_ref,
    pmean,
    reset_wire,
    sparse_allreduce,
    topk_allgather,
    tree_rounds,
    wire,
)

__all__ = [
    "comm_bytes_per_step",
    "dense_allreduce",
    "gtopk_allreduce",
    "merge_tree_ref",
    "pmean",
    "reset_wire",
    "sparse_allreduce",
    "topk_allgather",
    "tree_rounds",
    "wire",
]
