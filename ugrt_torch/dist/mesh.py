"""Multi-GPU sharding on torch.distributed (torch mirror of
ugrt/dist/mesh.py).

Design, as ugrt's (mesh.py:8-18):
  * the image is split along tile COLUMNS: rank r of a group of N renders
    tiles bx in [r * n_bx, (r + 1) * n_bx), n_bx = grid_x / N.  Cells are
    x-major (bx * grid_y + by), so each rank owns a contiguous cell range
    and a contiguous image strip;
  * the scene is replicated, and every rank builds the whole (identical)
    perspective and light grids itself: the build is a small share of
    the trace, and replicating it moves no CSR arrays between cards;
  * the forward is independent per strip: each rank runs
    ``diff.render_grad.render_color`` on its columns.  What must agree
    across ranks is reduced: each light's extents (MAX) or raw angle
    window (MIN/MAX, then the margin, in ``trace.shadow.shadow_pass``),
    the overflow flags (MAX), the loss and the gradients of the
    replicated scene parameters (SUM).  The image is gathered to every
    rank.

ugrt's collectives map one for one: ``axis_index`` -> the rank, ``pmax``
/ ``pmin`` / ``psum`` -> ``all_reduce`` with MAX / MIN / SUM, the
sharded ``out_specs`` -> ``all_gather_into_tensor``.  The collectives
run on the tensors' own device (NCCL on the card, gloo on the CPU) and
order themselves against the current stream: no host sync is added.

Spans (``api.profiler``): each all-reduce is the device span
``mesh.allreduce`` and counts in ``mesh.collectives`` and
``mesh.allreduce_bytes`` (``dist.all_reduce``); the frame's gather is
``mesh.allgather`` (counted in ``mesh.collectives`` too); the step's own
strip, ``render_color`` and its backward before the final sums, is
``mesh.strip``.  Inside a replayed graph each is credited per replay.

``sharded_render`` and ``sharded_train_step`` return ``core.program``
Programs, as ugrt's return one jitted ``shard_map`` program each
(mesh.py:130, :208): on the card each rank records its strip, the
collectives between the kernels included, as one CUDA graph per input
shape, and replays it; ``.fn`` is the eager body.  The capture runs in
``thread_local`` error mode: NCCL's watchdog thread may query its events
while a capture runs, which the default global mode would turn into a
failed capture.  On the CPU (gloo) a Program calls its body eagerly.

The Programs are kept, as ``render_and_grad`` is one module-level
Program: one per process group, rank, world size, device and static
arguments, so that a second ``train(use_mesh=True)`` job replays the
graphs the first one recorded.  ``clear()`` (and
``render_and_grad.clear()``) drops them all at once; call it before
``destroy_process_group``, since a graph that holds NCCL work must go
before its communicator (the destroy hung with such graphs alive, on 4
H100s with torch 2.11).

The run is SPMD: every rank of the group calls the same functions with
the same arguments (as under ``torchrun``).  That holds the programs
too: a rank that records or replays a collective while another runs
something else hangs the group, so every rank must make the same keys
in the same order and replay them in the same order.  The inputs have
the same shapes on every rank, so their keys agree.  Set up the process
group first, e.g. ``torch.distributed.init_process_group("nccl",
device_id=torch.device("cuda", local_rank))`` under ``torchrun
--nproc_per_node=N``; ``make_mesh`` makes the rank's card the current
device in any case.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from ugrt_torch.api import profiler
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.program import Program
from ugrt_torch.core.vecmath import scalar
from ugrt_torch.diff.render_grad import render_color
from ugrt_torch.dist import all_reduce


class Mesh(NamedTuple):
    """One rank's view of the process group that shards the image."""

    group: object          # a torch.distributed process group
    rank: int
    world_size: int
    device: torch.device   # where this rank's tensors live


def make_mesh(group=None, device=None) -> Mesh:
    """This rank's Mesh over ``group`` (default: the default process
    group, which must be initialized).  ``device`` None or ``"cuda"``
    means ``cuda:<LOCAL_RANK>`` (the card ``torchrun`` gives this rank);
    pass ``"cpu"`` for CPU tensors over gloo.  A card becomes this
    process's current device, so that the kernels, the caching
    allocator and NCCL all work on it."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no torch.distributed process group is initialized; "
            "call init_process_group first (e.g. under torchrun)")
    group = dist.group.WORLD if group is None else group
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device 'cuda' requested but CUDA "
                               "is not available")
        if device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                device)


def _any(flag, group):
    """A 0-d bool tensor: ``flag`` on any rank of ``group``."""
    return all_reduce(flag.to(torch.int32), dist.ReduceOp.MAX, group) > 0


def _strip_width(cfg: RenderConfig, world_size: int) -> int:
    """Tile columns per rank: grid_x / world_size, which must divide."""
    if cfg.grid_x % world_size:
        raise ValueError(f"grid_x {cfg.grid_x} does not divide across "
                         f"{world_size} ranks")
    return cfg.grid_x // world_size


# The kept Programs, {(group, body maker, rank, world size, device,
# statics): Program}.
_kept: dict = {}


def _kept_program(make, mesh: Mesh, cfg: RenderConfig, capacity: int,
                  num_lights: int, use_spot: bool) -> Program:
    """The Program of ``make``'s body for ``mesh`` and these statics, made
    at the first call of its key and returned again at every later one."""
    key = (mesh.group, make, mesh.rank, mesh.world_size, mesh.device, cfg,
           capacity, num_lights, use_spot)
    if key not in _kept:
        body = make(mesh.group, mesh.rank, mesh.world_size,
                    _strip_width(cfg, mesh.world_size),
                    dict(cfg=cfg, capacity=capacity, num_lights=num_lights,
                         use_spot=use_spot))
        _kept[key] = Program(body, static=(),
                             capture_error_mode="thread_local")
    return _kept[key]


def clear() -> None:
    """Drop every kept Program and its recordings (and the device memory
    they hold), as ``render_and_grad.clear()`` does for the one-card
    step."""
    for program in _kept.values():
        program.clear()
    _kept.clear()


def sharded_render(mesh: Mesh, *, cfg: RenderConfig, capacity: int,
                   num_lights: int, use_spot: bool) -> Program:
    """The kept Program (vertices, materials, faces, mat_index, camcoords,
    light_camcoords, light_position) -> (image f32 [H, W, 3], overflow
    0-d bool) that renders this rank's strip and gathers the whole image
    to every rank.  ``overflow`` is any strip's capacity flag: a sharded
    image surfaces clipped geometry as the single-device one does."""
    return _kept_program(_render_body, mesh, cfg, capacity, num_lights,
                         use_spot)


def _render_body(group, rank, world_size, n_bx, kw):
    bx0 = rank * n_bx

    def render(vertices, materials, faces, mat_index, camcoords,
               light_camcoords, light_position):
        color, overflow = render_color(
            vertices, materials, faces, mat_index, camcoords,
            light_camcoords, light_position, **kw, bx0=bx0, n_bx=n_bx,
            group=group)
        H, w = color.shape[:2]
        # Strips stacked along rows, [world * H, w, 3], then side by side.
        out = torch.empty((world_size * H, w, 3), dtype=color.dtype,
                          device=color.device)
        profiler.count("mesh.collectives")
        with profiler.span("mesh.allgather", device=True):
            dist.all_gather_into_tensor(out, color.contiguous(),
                                        group=group)
        image = out.reshape(world_size, H, w, 3).permute(
            1, 0, 2, 3).reshape(H, world_size * w, 3)
        return image, _any(overflow, group)

    return render


def sharded_train_step(mesh: Mesh, *, cfg: RenderConfig, capacity: int,
                       num_lights: int, use_spot: bool) -> Program:
    """The kept Program (vertices, materials, faces, mat_index, camcoords,
    light_camcoords, light_position, target) -> (loss, grad_vertices,
    grad_materials, overflow), each the same on every rank.

    ``target``: the whole [H, W, 3] image; each rank takes its strip.
    The loss is the image's MSE: each strip's sum of squares over
    3 * image_size, summed over the ranks (ugrt mesh.py:181-188), as are
    the strips' gradients.  ``overflow`` is any strip's capacity flag;
    the gradients cannot be trusted when it is set."""
    return _kept_program(_step_body, mesh, cfg, capacity, num_lights,
                         use_spot)


def _step_body(group, rank, world_size, n_bx, kw):
    bx0 = rank * n_bx
    cfg = kw["cfg"]
    cols = slice(bx0 * cfg.tile_x, (bx0 + n_bx) * cfg.tile_x)
    SUM = dist.ReduceOp.SUM

    def step(vertices, materials, faces, mat_index, camcoords,
             light_camcoords, light_position, target):
        with torch.enable_grad(), profiler.span("mesh.strip", device=True):
            v = vertices.detach().requires_grad_(True)
            m = materials.detach().requires_grad_(True)
            color, overflow = render_color(
                v, m, faces, mat_index, camcoords, light_camcoords,
                light_position, **kw, bx0=bx0, n_bx=n_bx, group=group)
            # Divide by a device tensor: on CUDA, a Python divisor turns
            # into a multiply by its reciprocal.
            denom = scalar(3.0 * cfg.image_size, color.device)
            loss = torch.sum((color - target[:, cols]) ** 2) / denom
            # On this thread, as render_and_grad's (core/program.py).
            with torch.autograd.set_multithreading_enabled(False):
                grad_v, grad_m = torch.autograd.grad(loss, (v, m))
        return (all_reduce(loss.detach(), SUM, group),
                all_reduce(grad_v, SUM, group),
                all_reduce(grad_m, SUM, group),
                _any(overflow, group))

    return step
