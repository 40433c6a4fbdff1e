"""The comparison that decides ``correct``: what the timed window
produced against the plain reference (``benchmark/reference``), which
works out everything again from the traffic's own inputs.

Frames: the window keeps two of its frames, one drawn from the seed
among the first cycle of cameras and the window's last; the reference
renders each from the same vertices and camera.  Numbers, each the worst
over the kept frames:

- ``face_px``: pixels whose primary face id differs;
- ``t_gap``: the largest |t - t_ref| / max(|t_ref|, 1) over the pixels
  whose reference ray hits;
- ``shadow_px``: pixels whose shadow flag differs;
- ``image_px``: pixels whose u8 colour differs in any channel;
- ``color_gap``: the largest gap of the f32 colour (shadows /3; the
  mixed colour of a reflective frame);
- ``reflect_face_px`` (reflective frames): pixels whose reflection hit
  face differs.

Training: the reference follows the window's first three steps (the
same views and targets, and PyTorch's Adam as the configuration states
it: betas 0.9 and 0.999, eps 1e-8, one tensor at a time) from the
scene's own parameters:

- ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| of the three;
- ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - beta1), by the worst leaf: the gap of
  the two norms over the larger of the reference leaf's norm and the
  median leaf's;
- ``change_gap``: the parameters' change after three steps, by the same
  measure, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's.

``lowp`` (the control) rounds every floating input of the reference's
frame or step, and its gradients and updated parameters, to that
dtype.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from benchmark import frame_call
from benchmark.reference import frame as rframe

BETA1 = 0.9


def _scene(driver, vertices=None):
    sc, dev = driver.traffic.scene, driver.device
    v = sc.vertices if vertices is None else vertices
    return (torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev),
            torch.from_numpy(sc.faces).to(dev),
            torch.from_numpy(sc.mat_index).to(dev),
            torch.from_numpy(sc.materials).to(dev))


def frames(driver, lowp=None) -> dict:
    """The frame numbers (module docstring), the worst over the kept
    frames."""
    cfg = frame_call.reference_config(driver.config)
    fc = frame_call.of(driver.config)
    dev = driver.device
    r = rframe.rounded
    worst = {}
    for k, (out, image) in sorted(driver.kept.items()):
        verts, view = driver.inputs(k)
        v, f, mi, m = _scene(driver, verts)
        cc = fc.camcoords(view, cfg.fovy_deg, dev)
        lcc = fc.light_camcoords(cfg.fovy_deg, dev)
        lp = fc.light_position_tensor(dev)
        args = (r(v, lowp), f, mi, r(m, lowp), r(cc, lowp), r(lcc, lowp),
                r(lp, lowp))
        kw = fc.kwargs(cfg, driver.capacity)
        with torch.no_grad():
            if fc.reflective:
                ref = rframe.render_frame_reflective(*args, **kw)
            else:
                ref = rframe.render_frame(*args, **kw)
        got = {n: torch.from_numpy(image).to(dev) if n == "image"
               else out[n] for n in ("image", "color", "shadowed")}
        nums = frame_numbers(got, out["primary"], ref)
        if fc.reflective:
            nums["reflect_face_px"] = int(
                (out["reflection"]["face_id"]
                 != ref["reflection"]["face_id"]).sum())
        for n, x in nums.items():
            worst[n] = max(worst.get(n, x), x)
        del ref
    return worst


def frame_numbers(got: dict, primary: dict, ref: dict) -> dict:
    """The per-frame numbers of one program frame against the
    reference's."""
    pf, rf = primary["face_id"], ref["primary"]["face_id"]
    rt = ref["primary"]["t"]
    tgap = ((primary["t"] - rt).abs()
            / torch.clamp(rt.abs(), min=1.0))[rf >= 0]
    return dict(
        face_px=int((pf != rf).sum()),
        t_gap=float(tgap.max()) if tgap.numel() else 0.0,
        shadow_px=int((got["shadowed"] != ref["shadowed"]).sum()),
        image_px=int((got["image"] != ref["image"]).any(dim=-1).sum()),
        color_gap=float((got["color"] - ref["color"]).abs().max()))


def _gap(prog: list, ref: list, leaves=None) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref),
    the median leaf's norm)."""
    pn = [float(torch.linalg.vector_norm(x.double())) for x in prog]
    rn = [float(torch.linalg.vector_norm(x.double())) for x in ref]
    med = statistics.median(rn)
    idx = range(len(rn)) if leaves is None else leaves
    return max((abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in idx),
               default=0.0)


def train(driver, lowp=None) -> dict:
    """The training numbers (module docstring)."""
    from benchmark.drivers import CHECKED_STEPS
    cfg = frame_call.reference_config(driver.config)
    fc = frame_call.of(driver.config)
    dev = driver.device
    rec = driver.record
    losses = list(driver.losses[:CHECKED_STEPS])
    if len(losses) < CHECKED_STEPS or "params" not in rec:
        return dict(loss_gap=float("inf"), grad_gap=float("inf"),
                    change_gap=float("inf"))
    v, f, mi, m = _scene(driver)
    p0 = [v.clone(), m.clone()]
    aspect = fc.step_aspect
    lcc = fc.light_camcoords(cfg.fovy_deg, dev, aspect)[:1]
    lp = fc.light_position_tensor(dev)
    adam = torch.optim.Adam([v, m], lr=driver.lr, betas=(BETA1, 0.999),
                            eps=1e-8, foreach=False)
    ref_losses, first = [], None
    for k in range(CHECKED_STEPS):
        view = driver.traffic.views[k % len(driver.traffic.views)]
        cc = fc.camcoords(view, cfg.fovy_deg, dev, aspect)
        target = driver.targets[k % len(driver.targets)]
        loss, gv, gm, _ = rframe.train_step(
            v, m, f, mi, cc, lcc, lp, target, cfg=cfg,
            capacity=driver.capacity, lowp=lowp)
        ref_losses.append(float(loss))
        if first is None:
            first = [gv, gm]
        v.grad, m.grad = gv, gm
        adam.step()
        with torch.no_grad():
            for p in (v, m):
                p.copy_(rframe.rounded(p, lowp))
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref_losses))
    grad_prog = [x / (1 - BETA1) for x in rec["first_moment"]]
    first_norms = [float(torch.linalg.vector_norm(x.double()))
                   for x in first]
    med = statistics.median(first_norms)
    moving = [i for i, n in enumerate(first_norms) if n >= 1e-3 * med]
    change_prog = [a.to(dev) - b for a, b in zip(rec["params"], p0)]
    change_ref = [v - p0[0], m - p0[1]]
    return dict(loss_gap=loss_gap, grad_gap=_gap(grad_prog, first),
                change_gap=_gap(change_prog, change_ref, moving))


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is finite and within its limit (a number
    without a limit fails)."""
    return all(n in limits and np.isfinite(x) and x <= limits[n]
               for n, x in numbers.items())
