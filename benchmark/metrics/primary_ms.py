"""primary_ms: the primary trace (ray directions, windows, K1, K2, the
slab scan) as a chained stage program timed by events."""


def read(ctx):
    return ctx.stage_ms("primary")
