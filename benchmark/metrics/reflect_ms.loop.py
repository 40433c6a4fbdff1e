"""reflect_ms.loop: device ms a frame of the bounce (the span
``frame.bounce``: uniform grid, reflection pass, shading and mixing;
events inside the replayed graph) over the traced loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "frame.bounce")
