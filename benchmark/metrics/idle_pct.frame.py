"""idle_pct.frame: the share of a frame in which the card is idle:
1 - (device ms of a frame: CUDA events over chained replays of the
frame's program on the cell's views, ``render_frame_device`` or
``render_frame_reflective``) / the traced run's frame_ms."""


def read(ctx):
    name = "reflective_frame" if ctx.driver.reflective else "frame"
    return 100.0 * (1.0 - ctx.stage_ms(name) / ctx.e2e["frame_ms"])
