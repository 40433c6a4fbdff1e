"""idle_pct.train: the share of a training step in which the card is
idle: 1 - (device ms of a step: CUDA events over chained replays of the
step's program on the cell's views) / the traced run's train_step_ms."""


def read(ctx):
    return 100.0 * (1.0 - ctx.stage_ms("step") / ctx.e2e["train_step_ms"])
