"""One run of a one-card cell, from set-up to the result line's object
(``run.py`` describes the sequence)."""

from __future__ import annotations

import statistics
import time

import torch

from benchmark import check, drivers, registry
from benchmark.stages import Stages


class Layers:
    """What a per-layer reader reads: the driver, the traced window, the
    run's end-to-end values and the stage times (``stage_ms``)."""

    def __init__(self, driver, window, e2e: dict):
        self.driver = driver
        self.window = window
        self.e2e = e2e
        self.stages = Stages(driver)

    def stage_ms(self, name: str) -> float:
        return self.stages.ms(name)

    def sites(self) -> dict:
        """The kernels' call sites of the reference's first frame or step
        (``roofline.record``), recorded once."""
        if not hasattr(self, "_sites"):
            from benchmark import roofline
            self._sites = roofline.record(self.driver)
        return self._sites


def end_to_end(cell, window) -> dict:
    """The cell's end-to-end values of a window (``setup_s`` apart)."""
    kind = cell.traffic["kind"]
    if kind == "train":
        return dict(train_step_ms=window.window_s / window.attempted * 1e3)
    return dict(frame_ms=window.window_s / window.attempted * 1e3,
                frame_ms_p95=drivers.p95(window.latencies_s) * 1e3)


def per_layer(cell, ctx, notes: list) -> dict:
    """Each per-layer metric of the cell that its reader finds in
    ``ctx`` (a ``Layers``)."""
    out = {}
    for m in cell.per_layer:
        value = registry.metric_reader(m["name"])(ctx)
        if value is None:
            notes.append(f"{m['name']}: nothing to read")
        else:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def busy_from_events(cell, ctx) -> dict:
    """busy_s and window_s when the profiler's child gave none: the
    frame's or step's device ms (events over chained replays) times the
    window's frames or steps, over the window."""
    name = ("step" if cell.traffic["kind"] == "train" else
            "reflective_frame" if ctx.driver.reflective else "frame")
    w = ctx.window
    return dict(busy_s=ctx.stage_ms(name) * w.attempted / 1e3,
                window_s=w.window_s)


def device_info(device, chips: int, peak: int) -> dict:
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips, memory_peak_bytes=int(peak))


def compared_lines(numbers: dict, limits: dict) -> tuple:
    """(the result's ``compared`` object, the stderr lines)."""
    comp = {n: dict(value=x, limit=limits.get(n)) for n, x in
            numbers.items()}
    lines = [f"compared {n}: {x!r} (limit {limits.get(n)!r})"
             for n, x in numbers.items()]
    return comp, lines


def run_cell(cell, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float):
    """(result object, stderr lines) of one run of a one-card ``cell``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t0 = time.perf_counter()
    driver = drivers.make(cell, seed, device)
    t1 = time.perf_counter()
    driver.setup(seconds)
    drivers.sync(device)
    t2 = time.perf_counter()
    setup_s = t2 - t_start
    window = driver.window(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    e2e = end_to_end(cell, window)
    notes = [f"set-up: {t0 - t_start:.3f} s to the harness, {t1 - t0:.3f} s "
             f"traffic and objects, {t2 - t1:.3f} s warm-up",
             f"window: {window.attempted} attempted, {window.failed} "
             f"failed in {window.window_s:.6f} s" + (
                 f"; {window.error}" if window.error else "")]
    if window.latencies_s:
        q = statistics.quantiles(window.latencies_s, n=4) if len(
            window.latencies_s) > 1 else window.latencies_s * 3
        notes.append("frame latency ms: min {:.3f} quartiles {:.3f} {:.3f} "
                     "{:.3f} max {:.3f}".format(
                         1e3 * min(window.latencies_s), *(1e3 * x for x in q),
                         1e3 * max(window.latencies_s)))
    result = dict(correct=False, attempted=window.attempted,
                  failed=window.failed, metrics={}, device={})
    if trace:
        ctx = Layers(driver, window, e2e)
        result["metrics"] = per_layer(cell, ctx, notes)
        fallback = busy_from_events(cell, ctx)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        e2e["setup_s"] = setup_s
        result["metrics"] = {k: dict(value=v, unit=units[k])
                             for k, v in e2e.items() if k in units}
    counters = launch_counts()
    notes.append(f"memory_peak_bytes {peak}; kernel launches {counters}; "
                 f"capture_s {capture_seconds()}")
    driver.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["device"] = (device_info(device, 1, peak)
                        if device.type == "cuda" else
                        dict(platform="cpu", kind="cpu", count=1,
                             memory_peak_bytes=0))
    if trace:
        from benchmark import profiler_child
        prof = profiler_child.run_child(name, seed, notes)
        if prof is None:
            notes.append("busy_s and window_s from events, not a trace")
            result["device"].update(fallback)
        else:
            result["device"].update(busy_s=prof["busy_s"],
                                    window_s=prof["window_s"])
            result["breakdown"] = prof["breakdown"]
    numbers = driver.check()
    limits = cell.config["limits"][cell.traffic["kind"]]
    result["correct"] = bool(check.verdict(numbers, limits)
                             and window.failed == 0)
    comp, lines = compared_lines(numbers, limits)
    result["compared"] = comp
    for n in notes:
        print(n, flush=True)
    return result, lines


def launch_counts() -> dict:
    """The program's kernel launch counters (``launches`` of each
    wrapper), credited per replay by its captured programs."""
    from ugrt_torch.kernels import (heavy_primary_sweep, primary_sweep,
                                    segment_sum, shadow_sweep, uniform_dda)
    return {f.__name__: f.launches for f in (
        primary_sweep.primary_sweep, heavy_primary_sweep.heavy_primary_sweep,
        shadow_sweep.shadow_sweep, uniform_dda.uniform_dda,
        segment_sum.face_corner_sum, segment_sum.segment_sum)}


def capture_seconds() -> dict:
    """Each captured program's warm-up and capture seconds per key."""
    from ugrt_torch.api.renderer import (render_frame_device,
                                         render_frame_reflective)
    from ugrt_torch.diff.render_grad import render_and_grad
    return {p.__name__: p.capture_seconds() for p in (
        render_frame_device, render_frame_reflective, render_and_grad)}
