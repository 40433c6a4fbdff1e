"""g1_roofline: G1's two sums (the step's corner sum keyed by face and its material
sum): the least time of the work of its call on the
cell's first frame or step over the kernel's time (``roofline``)."""

from benchmark import roofline


def read(ctx):
    return roofline.g1(ctx.driver, ctx.sites())
