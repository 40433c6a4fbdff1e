"""launch_ms.train: host ms a step in the step graph's launch (the span
``program.launch``, ``graph.replay()``) over the traced loop
(``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "program.launch")
