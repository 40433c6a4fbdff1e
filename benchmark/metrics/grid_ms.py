"""grid_ms: the perspective grid's build plus the light grid's, in the
cell's light-grid mode, each a chained stage program timed by events."""


def read(ctx):
    return ctx.stage_ms("perspective_grid") + ctx.stage_ms("light_grid")
