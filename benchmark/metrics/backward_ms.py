"""backward_ms: the step's backward half (refine, shading VJP, the
gathers' sums, autograd's glue): event ms of the step's replay minus
event ms of the forward frame (``render_color``) on the same views."""


def read(ctx):
    return ctx.stage_ms("step") - ctx.stage_ms("forward")
