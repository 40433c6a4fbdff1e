"""shadow_ms: the shadow trace (ray cells, sort, windows, K3) in the
cell's light-grid mode, as a chained stage program timed by events."""


def read(ctx):
    return ctx.stage_ms("shadow")
