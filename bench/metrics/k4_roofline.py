"""``k4_roofline``: k4's share of its roofline in the traced steps
(``bench.kernels.k4``), in %."""
from bench.kernels import roofline


def read(ctx):
    return roofline.share("k4", ctx)
