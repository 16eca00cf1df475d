"""``k3_roofline``: k3's share of its roofline in the traced steps
(``bench.kernels.k3``), in %."""
from bench.kernels import roofline


def read(ctx):
    return roofline.share("k3", ctx)
