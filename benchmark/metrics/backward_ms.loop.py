"""backward_ms.loop: device ms a step of the backward (the span
``step.backward``, ``torch.autograd.grad`` in ``render_and_grad``;
events inside the replayed graph) over the traced loop (``spans``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "step.backward")
