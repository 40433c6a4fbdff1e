"""shadow_rays_ms.loop: device ms a frame of the shadow rays' binning,
sort and rows (B1; the span ``shadow.rays`` inside ``trace.shadow``,
events inside the replayed graph), summed over the lights, over the
traced loop (``spans``).  None where the program has no such span."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "shadow.rays")
