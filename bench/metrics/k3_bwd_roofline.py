"""``k3_bwd_roofline``: k3_bwd's share of its roofline in the traced steps
(``bench.kernels.k3_bwd``), in %."""
from bench.kernels import roofline


def read(ctx):
    return roofline.share("k3_bwd", ctx)
