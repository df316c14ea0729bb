"""The reduction-mode vocabulary (the reference's --compression flag), as
far as the port implements it: the dense baseline, flat gTop-k and the
Top-k allgather baseline. Every dispatch table keys off these tuples."""

DENSE_MODES = (None, "none", "dense")
GTOPK_MODES = ("gtopk",)
ALLGATHER_MODES = ("allgather", "topk", "topkA", "topk_allgather")

SPARSE_MODES = GTOPK_MODES + ALLGATHER_MODES
ALL_MODES = DENSE_MODES + SPARSE_MODES
