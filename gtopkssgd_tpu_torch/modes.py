"""The reduction-mode vocabulary (the reference's --compression flag): the
dense baseline, flat gTop-k, the Top-k allgather baseline, the
hierarchical mode and the layer-wise mode. Every dispatch table keys off
these tuples."""

DENSE_MODES = (None, "none", "dense")
GTOPK_MODES = ("gtopk",)
ALLGATHER_MODES = ("allgather", "topk", "topkA", "topk_allgather")
# Dense sum within each contiguous slice of ranks, gTop-k across slices.
HIER_MODES = ("gtopk_hier",)
# Per-leaf top-k_l with k_l = ceil(rho * n_l), merged by the gTop-k tree.
LAYERWISE_MODES = ("gtopk_layerwise",)

ALL_MODES = (DENSE_MODES + GTOPK_MODES + ALLGATHER_MODES + HIER_MODES
             + LAYERWISE_MODES)
SPARSE_MODES = GTOPK_MODES + ALLGATHER_MODES + HIER_MODES + LAYERWISE_MODES

# Wire schedules (parallel.planner): a mode fixes what set is applied, a
# schedule the algorithm that ships it. The gtopk family has two, the
# hypercube 'tree' and the Ok-Topk 'balanced' split-and-reduce
# (arXiv:2201.07598); every other mode has one.
SCHEDULES = ("psum", "tree", "balanced", "allgather")

# Execution orders of a bucketed layer-wise step (parallel.bucketing): a
# schedule fixes the wire of ONE merge, the pipeline how the B merges
# interleave with the B selections. 'serial': bucket b+1 selects after
# bucket b's merge; 'overlap': bucket b+1 selects while bucket b's merge
# is in flight. Both apply the same values in the same order, so their
# results are bitwise equal; the spec grammar adds 'auto', which resolves
# to one of these two.
PIPELINES = ("serial", "overlap")


def default_schedule(mode: str) -> str:
    """The schedule `mode` used before the planner existed, which the
    planner keeps on ties."""
    if mode in DENSE_MODES:
        return "psum"
    if mode in ALLGATHER_MODES:
        return "allgather"
    if mode in GTOPK_MODES + HIER_MODES + LAYERWISE_MODES:
        return "tree"
    raise ValueError(f"unknown mode {mode!r}")
