"""k2_roofline: K2, the heavy primary sweep of the frame: the least time of the work of its call on the
cell's first frame or step over the kernel's time (``roofline``)."""

from benchmark import roofline


def read(ctx):
    return roofline.k2(ctx.driver, ctx.sites())
