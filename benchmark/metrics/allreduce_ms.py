"""allreduce_ms: device ms a step of the sharded step's all-reduces (the
span ``mesh.allreduce``: CUDA events around each collective of
``ugrt_torch.dist.all_reduce`` inside the replayed graph) over the
traced loop (``spans``): the transfers, and the wait of this rank's
strip for the slowest one.

Each rank reads its own over a loop of the same steps on every rank
(``sharded.agree``); the launcher keeps the slowest rank's (the value
goes back as a stage of that name).  None on one card, or where the
program has no such span."""

from benchmark import sharded, spans

NAME = "allreduce_ms"


def read(ctx):
    if ctx.driver is None:          # the launcher's reduction of the ranks
        return ctx.stages.get(NAME)
    if ctx.driver.mesh is None:
        return None
    sharded.agree(ctx)
    value = spans.device_ms(ctx, "mesh.allreduce")
    if value is not None:
        ctx.stages.cache[NAME] = value
    return value
