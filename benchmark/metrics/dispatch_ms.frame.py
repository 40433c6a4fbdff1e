"""dispatch_ms.frame: host ms a frame in the captured program's call
(the span ``program.call``: binding, key, input copies, the replay's
launch, output clones), less the recorder's own reading of events inside
it (``profiler.read``), over the traced loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.dispatch_ms(ctx)
