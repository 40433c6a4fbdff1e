"""grid_ms.loop: device ms a frame of the perspective and light grids'
builds (the spans ``grid.perspective`` and ``grid.spherical``, events
inside the replayed graph) over the traced loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "grid.perspective", "grid.spherical")
