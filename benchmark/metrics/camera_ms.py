"""camera_ms: host ms a frame in the camera matrices and their upload
(the program's span ``bridge.camera``, one a camera) over the traced
loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "bridge.camera")
