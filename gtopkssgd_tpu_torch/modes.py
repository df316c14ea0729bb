"""The reduction-mode vocabulary (the reference's --compression flag), as
far as the port implements it: the dense baseline and flat gTop-k. Every
dispatch table keys off these tuples."""

DENSE_MODES = (None, "none", "dense")
GTOPK_MODES = ("gtopk",)

SPARSE_MODES = GTOPK_MODES
ALL_MODES = DENSE_MODES + SPARSE_MODES
