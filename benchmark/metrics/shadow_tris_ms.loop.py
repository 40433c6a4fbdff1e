"""shadow_tris_ms.loop: device ms a frame of the shadow pass's triangle
side (B2: K3's key and heavy rows and every ray block's window ranges;
the span ``shadow.tris`` inside ``trace.shadow``, events inside the
replayed graph), summed over the lights, over the traced loop
(``spans``).  None where the program has no such span."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "shadow.tris")
