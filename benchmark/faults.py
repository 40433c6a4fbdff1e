"""Faults planted underneath the timed path, to show that the check
fails them (``benchmark/tests`` on the CPU; ``calibrate.py`` reads them
on the card).  Each is a context manager that patches the program's
module attributes and restores them; none is used by a benchmark run.

- ``unchanged`` (training): every step leaves the parameters as they
  were (Adam's rate 0).
- ``half_batch`` (training): half of the image left out of each step,
  the loss and gradients the mean over the rest.
- ``altered`` (training): each step's loss altered by 1% where it is
  produced.
- ``altered`` (frames): one 8x8 tile of each frame altered where it is
  produced: its colour inverted, its face ids moved by one, its shadow
  flags flipped.
- ``half_batch`` (frames): the bottom half of each frame left out: no
  hit, no shadow, black.
- ``no_exchange`` (sharded training): the gradients' all-reduce left
  out, each rank keeping its own strip's; ``unchanged`` as above.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _train_unchanged():
    from ugrt_torch.api import train as ptrain
    return patched(ptrain, "make_optimizer",
                   lambda make: lambda params, lr: make(params, 0.0))


def _train_half_batch():
    from ugrt_torch.api import train as ptrain

    def make(step):
        def half(vertices, materials, faces, mat_index, cc, lcc, lp, target,
                 **kw):
            out = step(vertices, materials, faces, mat_index, cc, lcc, lp,
                       target, **kw)
            h = target.shape[0] // 2
            t2 = target.clone()
            t2[h:] = out["color"][h:]
            out = step(vertices, materials, faces, mat_index, cc, lcc, lp,
                       t2, **kw)
            return dict(out, loss=out["loss"] * 2,
                        grad_vertices=out["grad_vertices"] * 2,
                        grad_materials=out["grad_materials"] * 2)
        return half
    return patched(ptrain, "render_and_grad", make)


def _train_altered():
    from ugrt_torch.api import train as ptrain

    def make(step):
        def altered(*args, **kw):
            out = step(*args, **kw)
            return dict(out, loss=out["loss"] * 1.01)
        return altered
    return patched(ptrain, "render_and_grad", make)


def _alter_tile(out):
    out = dict(out)
    prim = dict(out["primary"])
    img = out["image"].clone()
    img[:8, :8] = 255 - img[:8, :8]
    col = out["color"].clone()
    col[:8, :8] = 1.0 - col[:8, :8]
    fid = prim["face_id"].clone()
    fid[:8, :8] += 1
    sh = out["shadowed"].clone()
    sh[:8, :8] = 1 - sh[:8, :8]
    prim["face_id"] = fid
    out.update(image=img, color=col, shadowed=sh, primary=prim)
    return out


def _drop_half(out):
    out = dict(out)
    prim = dict(out["primary"])
    h = out["image"].shape[0] // 2
    for name, value in (("image", 0), ("color", 0.0), ("shadowed", 0)):
        x = out[name].clone()
        x[h:] = value
        out[name] = x
    for name, value in (("face_id", -2), ("t", -1.0)):
        x = prim[name].clone()
        x[h:] = value
        prim[name] = x
    out["primary"] = prim
    if "reflection" in out:
        refl = dict(out["reflection"])
        x = refl["face_id"].clone()
        x[h:] = -2
        refl["face_id"] = x
        out["reflection"] = refl
    return out


def _frames(edit):
    from ugrt_torch.api import renderer as prenderer

    def make(program):
        def edited(*args, **kw):
            return edit(program(*args, **kw))
        edited.clear = program.clear
        edited.cache_size = program.cache_size
        edited.capture_seconds = program.capture_seconds
        edited.__name__ = program.__name__
        return edited
    stack = contextlib.ExitStack()
    stack.enter_context(patched(prenderer, "render_frame_device", make))
    stack.enter_context(patched(prenderer, "render_frame_reflective", make))
    return stack


def _no_exchange():
    import torch.distributed as dist

    real = dist.all_reduce

    def skip_sum(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if op == dist.ReduceOp.SUM and t.dtype == torch.float32 \
                and t.numel() > 1:
            return None
        return real(t, op=op, group=group, async_op=async_op)
    return patched(dist, "all_reduce", lambda _: skip_sum)


FAULTS = {
    "train": {"unchanged": _train_unchanged,
              "half_batch": _train_half_batch,
              "altered": _train_altered},
    "frames": {"altered": lambda: _frames(_alter_tile),
               "half_batch": lambda: _frames(_drop_half)},
    "train_sharded": {"unchanged": _train_unchanged,
                      "no_exchange": _no_exchange},
}


def plant(kind: str, name: str):
    """The context manager that plants fault ``name`` of traffic kind
    ``kind``."""
    return FAULTS[kind][name]()
