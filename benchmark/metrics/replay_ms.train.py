"""replay_ms.train: device ms a step of the step graph's replay (the
span ``program.replay``: CUDA events just before and after
``graph.replay()``) over the traced loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "program.replay")
