"""shadow_ms.loop: device ms a frame of the shadow trace, summed over the
lights (the span ``trace.shadow``, events inside the replayed graph)
over the traced loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "trace.shadow")
