"""upload_ms: host ms a frame in the vertex upload (the program's span
``renderer.upload``, ``Renderer.update_vertices``) over the traced loop
(``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "renderer.upload")
