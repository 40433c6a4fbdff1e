"""primary_ms.loop: device ms a frame of the primary trace (the span
``trace.primary``, events inside the replayed graph) over the traced
loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "trace.primary")
