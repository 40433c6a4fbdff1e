"""Device times of the program's stages, for the per-layer readers: each
stage a captured program of the program's own functions over a closure
of the vertices, chained (``timing``: a call's vertices carry a
zero-valued dependency on the last call's output; one fence ends the
chain) and timed by CUDA events.

The stages follow ``ugrt_torch/bench.py``'s ``breakdown_ms`` (:181-213),
with two departures: the light grid and the shadow trace run in the
cell's own light-grid mode (with the light window of the frame's own
hit points where the mode is "windowed"), and the step, the forward
frame and the frames cycle through the cell's views as its traffic does.
"""

from __future__ import annotations

import numpy as np

from benchmark import timing

CALLS = 24


def chained_event_ms(fns, x, n: int = CALLS) -> float:
    """Event ms per call of ``n`` chained calls, call i ``fns[i %
    len(fns)](x_i)``, x_i = x + 0 * (call i-1's first output element);
    after one warm-up call of each."""
    for fn in fns:
        out = fn(x)
    device = x.device
    with timing.Window(device) as w:
        for i in range(n):
            x = timing._dep(x, timing.first_leaf(out))
            out = fns[i % len(fns)](x)
    return w.timing(n).event_ms


class Stages:
    """Lazily measured stage times of one driver's cell (ms per call, by
    CUDA events)."""

    def __init__(self, driver):
        self.d = driver
        self.cache = {}

    def ms(self, name: str) -> float:
        if name not in self.cache:
            self.cache[name] = getattr(self, "_" + name)()
        return self.cache[name]

    # Inputs: the driver's views, its first vertex frame (frames), and the
    # cameras with the aspect of a frame or, for the step's stages, of a
    # training step.
    def _inputs(self, step: bool = False):
        from ugrt_torch import bridge
        d = self.d
        cfg, fc, dev = d.cfg, d.fc, d.device
        aspect = fc.step_aspect if step else fc.aspect
        x = bridge.scene_to_torch(d.scene, dev)
        if d.traffic.vertex_frames:
            x["vertices"] = bridge.from_numpy(d.traffic.vertex_frames[0],
                                              dev, np.float32)
        ccs = [fc.camcoords(v, cfg.fovy_deg, dev, aspect)
               for v in d.traffic.views]
        lcc = fc.light_camcoords(cfg.fovy_deg, dev, aspect)
        if step:
            lcc = lcc[:1]
        lp = fc.light_position_tensor(dev)
        return cfg, x, ccs, lcc, lp

    def _programs(self, fns):
        from ugrt_torch.core.program import Program
        return [Program(fn, static=()) for fn in fns]

    def _timed(self, fns, x):
        programs = self._programs(fns)
        try:
            return chained_event_ms(programs, x)
        finally:
            for p in programs:
                p.clear()

    # The frame's stages, on the first view; the light grid and the
    # shadow trace once per light (the frame's sum).
    def _light_args(self, x, cc, lcc, cfg):
        """(x_max, y_max, window, capacity) of the light grid of light
        ``lcc`` in the cell's mode, the window from the frame's own hit
        points."""
        from ugrt_torch.grid import build as gbuild
        from ugrt_torch.trace import primary as tprimary
        from ugrt_torch.trace import shadow as tshadow
        mode, cap = cfg.light_grid_mode, self.d.capacity
        v, f = x["vertices"], x["faces"]
        grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap)
        prim = tprimary.trace_primary(v, f, cc, grid, cfg)
        xm = ym = window = None
        if mode == "extent":
            xm, ym = tshadow.light_extents(prim, cc[0:3], lcc, cfg)
            cap = 2 * cap
        elif mode == "windowed":
            window = tshadow.light_window(prim, cc[0:3], lcc, cfg)
        return grid, prim, dict(x_max=xm, y_max=ym, window=window), cap

    def _perspective_grid(self):
        from ugrt_torch.grid import build as gbuild
        cfg, x, ccs, _, _ = self._inputs()
        f, cap = x["faces"], self.d.capacity
        return self._timed([lambda v: gbuild.build_perspective_grid(
            v, f, ccs[0], cfg=cfg, capacity=cap)], x["vertices"])

    def _per_light(self, make):
        """Event ms of a frame's calls of one light's stage, summed over
        its lights: ``make(x, cc, lc, cfg)`` gives a light's call."""
        cfg, x, ccs, lccs, _ = self._inputs()
        fns = [make(x, ccs[0], lc, cfg) for lc in lccs]
        ms = self._timed(fns, x["vertices"])
        return None if ms is None else ms * len(fns)

    def _light_grid(self):
        from ugrt_torch.grid import build as gbuild

        def make(x, cc, lc, cfg):
            _, _, kw, cap = self._light_args(x, cc, lc, cfg)
            f = x["faces"]
            return lambda v: gbuild.build_spherical_grid(
                v, f, lc, cfg=cfg, capacity=cap, **kw)
        return self._per_light(make)

    def _primary(self):
        from ugrt_torch.trace import primary as tprimary
        cfg, x, ccs, lcc, _ = self._inputs()
        grid, _, _, _ = self._light_args(x, ccs[0], lcc[0], cfg)
        f = x["faces"]
        return self._timed([lambda v: tprimary.trace_primary(
            v, f, ccs[0], grid, cfg)], x["vertices"])

    def _shadow(self):
        from ugrt_torch.grid import build as gbuild
        from ugrt_torch.trace import shadow as tshadow

        def make(x, cc, lc, cfg):
            _, prim, kw, cap = self._light_args(x, cc, lc, cfg)
            f = x["faces"]
            lgrid = gbuild.build_spherical_grid(x["vertices"], f, lc,
                                                cfg=cfg, capacity=cap, **kw)
            return lambda v: tshadow.trace_shadow(
                v, f, lc, lgrid, prim, cc[0:3], cfg, **kw)
        return self._per_light(make)

    def _frame(self):
        from ugrt_torch.api.renderer import render_frame_device
        cfg, x, ccs, lcc, lp = self._inputs()
        kw = self.d.fc.kwargs(cfg, self.d.capacity, plain=True)
        return chained_event_ms(
            [lambda v, cc=cc: render_frame_device(
                v, x["faces"], x["mat_index"], x["materials"], cc, lcc, lp,
                **kw) for cc in ccs], x["vertices"])

    def _reflective_frame(self):
        from ugrt_torch.api.renderer import render_frame_reflective
        cfg, x, ccs, lcc, lp = self._inputs()
        kw = self.d.fc.kwargs(cfg, self.d.capacity)
        return chained_event_ms(
            [lambda v, cc=cc: render_frame_reflective(
                v, x["faces"], x["mat_index"], x["materials"], cc, lcc, lp,
                **kw) for cc in ccs], x["vertices"])

    # The training step's, cycling through the views and targets.
    def _step(self):
        """The step of one card, or the sharded step on every rank of a
        mesh (the ranks call it in the same order)."""
        from ugrt_torch.diff.render_grad import render_and_grad
        from ugrt_torch.dist import mesh as dmesh
        cfg, x, ccs, lcc, lp = self._inputs(step=True)
        kw = self.d.fc.step_kwargs(cfg, self.d.capacity)
        m, f, mi = x["materials"], x["faces"], x["mat_index"]
        if self.d.mesh is None:
            def step(v, cc, tg):
                return render_and_grad(v, m, f, mi, cc, lcc, lp, tg,
                                       **kw)["grad_vertices"]
            clear = render_and_grad.clear
        else:
            program = dmesh.sharded_train_step(self.d.mesh, **kw)

            def step(v, cc, tg):
                return program(v, m, f, mi, cc, lcc, lp, tg)[1]
            clear = program.clear
        try:
            return chained_event_ms(
                [lambda v, cc=cc, tg=tg: step(v, cc, tg)
                 for cc, tg in zip(ccs, self.d.targets)], x["vertices"])
        finally:
            clear()

    def _forward(self):
        from ugrt_torch.diff.render_grad import render_color
        cfg, x, ccs, lcc, lp = self._inputs(step=True)
        kw = self.d.fc.step_kwargs(cfg, self.d.capacity)
        m, f, mi = x["materials"], x["faces"], x["mat_index"]
        programs = self._programs([lambda v, cc: render_color(
            v, m, f, mi, cc, lcc, lp, **kw)[0]])
        try:
            return chained_event_ms(
                [lambda v, cc=cc: programs[0](v, cc) for cc in ccs],
                x["vertices"])
        finally:
            programs[0].clear()

