"""``k4_bwd_roofline``: k4_bwd's share of its roofline in the traced steps
(``bench.kernels.k4_bwd``), in %."""
from bench.kernels import roofline


def read(ctx):
    return roofline.share("k4_bwd", ctx)
