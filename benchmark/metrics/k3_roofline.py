"""k3_roofline: K3 at the frame's cell-key site (the serial walk in reference mode): the least time of the work of its call on the
cell's first frame or step over the kernel's time (``roofline``)."""

from benchmark import roofline


def read(ctx):
    return roofline.k3(ctx.driver, ctx.sites())
