"""d1_roofline: D1, the reflection DDA of the frame's mirror rays: the least time of the work of its call on the
cell's first frame or step over the kernel's time (``roofline``)."""

from benchmark import roofline


def read(ctx):
    return roofline.d1(ctx.driver, ctx.sites())
