"""Kernel rooflines: the least time that the work of a kernel's call
needs at the card's published rates, against the time the program's
kernel takes for that call.

The work is counted from the cell's own inputs: the reference
(``benchmark/reference``) renders the cell's first frame or step
eagerly, and recorders at its plain sweeps keep the arguments of each
kernel's call site (``record``).  The same arguments, which equal the
program's bit for bit, are then handed to the program's kernel, timed
by CUDA events over back-to-back calls of its wrapper (its fills and
launch included).  Nothing is read from a kernel's counters.

The arithmetic is a frozen copy of ``chip_smoke.py`` (the peaks and the
operations per test, :268-282; ``bound`` and ``nbytes``, :366-375;
``keyed_tests`` and ``box_tests``, :378-418; ``read_once``, :846-858;
the work of K2 and K3, ``sweep_work`` :429-490):

- K2 (``heavy_primary_sweep``): every test that a ray's footprint box
  admits (a lex-min needs them all), 21 operations each;
- K3 (``shadow_sweep``, the cell-key site): every admitted test of the
  rays that no row occludes and one test of each shadowed ray, 30
  operations each;
- D1 (``uniform_dda``): the tests that the plain DDA makes, the faces of
  each cell a live ray visits until its hit is behind the cell, 46
  operations each;
- G1 (``face_corner_sum`` and ``segment_sum``, the step's two sums): 3
  float64 operations a value.

Each reads its inputs once and writes its output once; the bound is the
larger of operations / peak and bytes / 3.35 TB/s, and the share is the
bound over the kernel's time.
"""

from __future__ import annotations

import contextlib

import torch

PEAK_F32 = 67e12
PEAK_F64 = 34e12
HBM_BYTES_S = 3.35e12
FLOPS_K2 = 21
FLOPS_K3 = 30
FLOPS_D1 = 46
FLOPS_G1 = 3
CALLS = 20


def bound(flops, nbytes, peak=PEAK_F32):
    """(ms, "operations" or "bytes"): the least time of the work at the
    card's published rates."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def keyed_tests(tri, key_col, rays, ray_key_col, only=None):
    """Sum over rays (those where the [NB, 128] mask ``only`` holds, if
    given) of the real rows (not all-zero coefficients) whose cell key
    equals the ray's."""
    rows = tri.reshape(-1, tri.shape[-1])
    real = rows[:, :key_col].abs().amax(dim=1) > 0
    keys = rows[:, key_col].long()
    rk = rays.reshape(-1, rays.shape[-1])[:, ray_key_col].long()
    size = int(max(int(keys.max()), int(rk.max()), 0)) + 1
    counts = torch.bincount(keys[real & (keys >= 0)], minlength=size)
    keep = rk >= 0
    if only is not None:
        keep &= only.reshape(-1)
    return int(counts[rk[keep]].sum())


def box_tests(boxes, rays, gx_col, grid, only=None):
    """Sum over rays (those where the [NB, 128] mask ``only`` holds, if
    given) of the rows whose footprint box (x0, x1, y0, y1) holds the
    ray's cell (gx, gy), by a summed-area table of the rays' cells; empty
    boxes (x0 > x1) count nothing."""
    r = rays.reshape(-1, rays.shape[-1])
    gx, gy = r[:, gx_col].long(), r[:, gx_col + 1].long()
    ok = (gx >= 0) & (gx < grid) & (gy >= 0) & (gy < grid)
    if only is not None:
        ok &= only.reshape(-1)
    hist = torch.bincount(gx[ok] * grid + gy[ok], minlength=grid * grid)
    sat = torch.zeros((grid + 1, grid + 1), dtype=torch.int64,
                      device=rays.device)
    sat[1:, 1:] = hist.reshape(grid, grid).cumsum(0).cumsum(1)
    b = boxes.reshape(-1, 4).long()
    x0, x1 = b[:, 0].clamp(0, grid - 1), b[:, 1].clamp(-1, grid - 1)
    y0, y1 = b[:, 2].clamp(0, grid - 1), b[:, 3].clamp(-1, grid - 1)
    live = (x0 <= x1) & (y0 <= y1)
    x0, x1, y0, y1 = (v[live] for v in (x0, x1, y0, y1))
    return int((sat[x1 + 1, y1 + 1] - sat[x0, y1 + 1] - sat[x1 + 1, y0]
                + sat[x0, y0]).sum())


def read_once(values, fid, faces):
    """A face-keyed sum reads the rows of the faces table that occur."""
    used = torch.unique(fid)
    used = used[(used >= 0) & (used < faces.shape[0])]
    return values, fid, faces[used]


@contextlib.contextmanager
def _recording(module, name, calls):
    """Wrap ``module.name`` so that each call's (args, kwargs, output)
    is appended to ``calls``."""
    fn = getattr(module, name)

    def recorder(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, kw, out))
        return out
    setattr(module, name, recorder)
    try:
        yield
    finally:
        setattr(module, name, fn)


def record(driver) -> dict:
    """{site: [(args, kwargs, output), ...]} of the reference's eager
    first frame (or step) of ``driver``'s cell, from the cell's own
    inputs: the first view and, for frames, the first vertex frame."""
    from benchmark import check, frame_call
    from benchmark.reference import frame as rframe
    from benchmark.reference import gather as rgather
    from benchmark.reference import primary as rprimary
    from benchmark.reference import reflect as rreflect
    from benchmark.reference import shadow as rshadow
    cfg = frame_call.reference_config(driver.config)
    fc = frame_call.of(driver.config)
    dev = driver.device
    frames = driver.cell.traffic["kind"] == "frames"
    verts = driver.traffic.vertex_frames[0] if frames else None
    v, f, mi, m = check._scene(driver, verts)
    aspect = fc.aspect if frames else fc.step_aspect
    cc = fc.camcoords(driver.traffic.views[0], cfg.fovy_deg, dev, aspect)
    lcc = fc.light_camcoords(cfg.fovy_deg, dev, aspect)
    lp = fc.light_position_tensor(dev)
    sites = {n: [] for n in ("heavy_primary_sweep", "shadow_sweep",
                             "uniform_dda", "face_corner_sum", "segment_sum")}
    with contextlib.ExitStack() as stack:
        for mod, name in ((rprimary, "heavy_primary_sweep"),
                          (rshadow, "shadow_sweep"),
                          (rreflect, "uniform_dda"),
                          (rgather, "face_corner_sum"),
                          (rgather, "segment_sum")):
            stack.enter_context(_recording(mod, name, sites[name]))
        if not frames:
            rframe.train_step(v, m, f, mi, cc, lcc[:1], lp,
                              driver.targets[0], cfg=cfg,
                              capacity=driver.capacity)
        else:
            render = (rframe.render_frame_reflective if fc.reflective
                      else rframe.render_frame)
            with torch.no_grad():
                render(v, f, mi, m, cc, lcc, lp,
                       **fc.kwargs(cfg, driver.capacity))
    return sites


def event_ms(fn, n: int = CALLS) -> float:
    """CUDA-event ms per call of ``n`` back-to-back calls, after two."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def share(bound_ms: float, kernel_ms: float) -> float:
    return 100.0 * bound_ms / kernel_ms


def k2(driver, sites) -> float | None:
    """K2's share of its roofline on the first frame's heavy sweep."""
    from ugrt_torch.kernels.heavy_primary_sweep import heavy_primary_sweep
    calls = sites["heavy_primary_sweep"]
    if not calls:
        return None
    (count, table, rays), _, _ = calls[0]
    need = box_tests(table[10:14].T, rays, 4, driver.cfg.grid_x)
    b_ms, _ = bound(need * FLOPS_K2,
                    nbytes(count, table, rays) + rays.shape[0] * 128 * 8)
    ms = event_ms(lambda: heavy_primary_sweep(count, table, rays,
                                              cfg=driver.cfg))
    return share(b_ms, ms)


def k3(driver, sites) -> float | None:
    """K3's share of its roofline at the first frame's cell-key site."""
    from ugrt_torch.kernels.shadow_sweep import shadow_sweep
    calls = [c for c in sites["shadow_sweep"] if not c[1].get("box")]
    if not calls:
        return None
    (tri, rays, w_lo, w_hi), kw, out = calls[0]
    shadowed = out != 0
    need = keyed_tests(tri, 10, rays, 4, only=~shadowed)
    need += int(shadowed.sum())
    b_ms, _ = bound(need * FLOPS_K3,
                    nbytes(tri, rays, w_lo, w_hi) + rays.shape[0] * 128 * 4)
    kw = dict(kw, cfg=driver.cfg)
    ms = event_ms(lambda: shadow_sweep(tri, rays, w_lo, w_hi, **kw))
    return share(b_ms, ms)


def d1(driver, sites) -> float | None:
    """D1's share of its roofline on the first reflective frame's rays."""
    from benchmark.reference.sweeps import uniform_dda_plain
    from ugrt_torch.kernels.uniform_dda import uniform_dda
    calls = sites["uniform_dda"]
    if not calls:
        return None
    args, kw, out = calls[0]
    stats = {}
    uniform_dda_plain(*args, **kw, stats=stats)
    ftab, grid, origins, dirs, active, excl, lo, hi, dims = args
    read = nbytes(ftab, grid.cell_count, grid.cell_offset, grid.sorted_faces,
                  origins, dirs, active, excl)
    b_ms, _ = bound(stats["needed"] * FLOPS_D1,
                    read + origins.shape[0] * 8)
    pkw = dict(kw, cfg=driver.cfg)
    ms = event_ms(lambda: uniform_dda(*args, **pkw))
    return share(b_ms, ms)


def g1(driver, sites) -> float | None:
    """G1's share of its roofline over the first step's two sums."""
    from ugrt_torch.kernels import segment_sum as g1k
    corner, material = sites["face_corner_sum"], sites["segment_sum"]
    if not corner or not material:
        return None
    (cv, fid, faces, rows_v), _, cout = corner[0]
    (mv, idx, rows_m), _, mout = material[0]
    b_c, _ = bound(FLOPS_G1 * cv.numel(),
                   nbytes(*read_once(cv, fid, faces), cout), peak=PEAK_F64)
    b_m, _ = bound(FLOPS_G1 * mv.numel(), nbytes(mv, idx, mout),
                   peak=PEAK_F64)
    fid32, idx32 = fid.to(torch.int32), idx.to(torch.int32)
    ms_c = event_ms(lambda: g1k.face_corner_sum(cv, fid32, faces, rows_v))
    ms_m = event_ms(lambda: g1k.segment_sum(mv, idx32, rows_m))
    return share(b_c + b_m, ms_c + ms_m)

