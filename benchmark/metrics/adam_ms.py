"""adam_ms: device ms a step of Adam (the span ``train.adam``,
``opt.step()`` in ``train()``, CUDA events around the eager update)
over the traced loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train.adam")
