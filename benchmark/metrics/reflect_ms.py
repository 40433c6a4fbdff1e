"""reflect_ms: the reflection bounce (the uniform grid's build, D1, the
mixed shading): event ms of the reflective frame's replay minus the
frame's without it, on the same views."""


def read(ctx):
    return ctx.stage_ms("reflective_frame") - ctx.stage_ms("frame")
