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

``sharded_render`` and ``sharded_train_step`` return ``core.program``
Programs, as ugrt's return one jitted ``shard_map`` program each
(mesh.py:130, :208): on the card each rank records its strip, the
collectives between the kernels included, as one CUDA graph per input
shape, and replays it; ``.fn`` is the eager body.  The capture runs in
``thread_local`` error mode: NCCL's watchdog thread may query its events
while a capture runs, which the default global mode would turn into a
failed capture.  On the CPU (gloo) a Program calls its body eagerly.

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

from ugrt_torch.config import RenderConfig
from ugrt_torch.core.program import Program
from ugrt_torch.diff.render_grad import render_color
from ugrt_torch.dist import all_reduce
from ugrt_torch.kernels.heavy_primary_sweep import heavy_primary_sweep
from ugrt_torch.kernels.primary_sweep import primary_sweep
from ugrt_torch.kernels.segment_sum import face_corner_sum, segment_sum
from ugrt_torch.kernels.shadow_sweep import shadow_sweep

# The kernels a replay launches, credited per replay (core.program).
COUNTERS = (primary_sweep, heavy_primary_sweep, shadow_sweep,
            face_corner_sum, segment_sum)


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


def _program(body) -> Program:
    """``body`` (a closure over the mesh: tensors only) as a Program."""
    return Program(body, static=(), counters=COUNTERS,
                   capture_error_mode="thread_local")


def sharded_render(mesh: Mesh, *, cfg: RenderConfig, capacity: int,
                   num_lights: int, use_spot: bool) -> Program:
    """A Program (vertices, materials, faces, mat_index, camcoords,
    light_camcoords, light_position) -> (image f32 [H, W, 3], overflow
    0-d bool) that renders this rank's strip and gathers the whole image
    to every rank.  ``overflow`` is any strip's capacity flag: a sharded
    image surfaces clipped geometry as the single-device one does."""
    n_bx = _strip_width(cfg, mesh.world_size)
    bx0 = mesh.rank * n_bx

    def render(vertices, materials, faces, mat_index, camcoords,
               light_camcoords, light_position):
        color, overflow = render_color(
            vertices, materials, faces, mat_index, camcoords,
            light_camcoords, light_position, cfg=cfg, capacity=capacity,
            num_lights=num_lights, use_spot=use_spot, bx0=bx0, n_bx=n_bx,
            group=mesh.group)
        H, w = color.shape[:2]
        # Strips stacked along rows, [world * H, w, 3], then side by side.
        out = torch.empty((mesh.world_size * H, w, 3), dtype=color.dtype,
                          device=color.device)
        dist.all_gather_into_tensor(out, color.contiguous(),
                                    group=mesh.group)
        image = out.reshape(mesh.world_size, H, w, 3).permute(
            1, 0, 2, 3).reshape(H, mesh.world_size * w, 3)
        return image, _any(overflow, mesh.group)

    return _program(render)


def sharded_train_step(mesh: Mesh, *, cfg: RenderConfig, capacity: int,
                       num_lights: int, use_spot: bool) -> Program:
    """A Program (vertices, materials, faces, mat_index, camcoords,
    light_camcoords, light_position, target) -> (loss, grad_vertices,
    grad_materials, overflow), each the same on every rank.

    ``target``: the whole [H, W, 3] image; each rank takes its strip.
    The loss is the image's MSE: each strip's sum of squares over
    3 * image_size, summed over the ranks (ugrt mesh.py:181-188), as are
    the strips' gradients.  ``overflow`` is any strip's capacity flag;
    the gradients cannot be trusted when it is set."""
    n_bx = _strip_width(cfg, mesh.world_size)
    bx0 = mesh.rank * n_bx
    cols = slice(bx0 * cfg.tile_x, (bx0 + n_bx) * cfg.tile_x)
    SUM = dist.ReduceOp.SUM

    def step(vertices, materials, faces, mat_index, camcoords,
             light_camcoords, light_position, target):
        with torch.enable_grad():
            v = vertices.detach().requires_grad_(True)
            m = materials.detach().requires_grad_(True)
            color, overflow = render_color(
                v, m, faces, mat_index, camcoords, light_camcoords,
                light_position, cfg=cfg, capacity=capacity,
                num_lights=num_lights, use_spot=use_spot, bx0=bx0,
                n_bx=n_bx, group=mesh.group)
            # Divide by a device tensor: on CUDA, a Python divisor turns
            # into a multiply by its reciprocal.  A fill, not a copy from
            # the host, which a capture refuses.
            denom = torch.full((), 3.0 * cfg.image_size,
                               dtype=torch.float32, device=color.device)
            loss = torch.sum((color - target[:, cols]) ** 2) / denom
            # On this thread, as render_and_grad's (core/program.py).
            with torch.autograd.set_multithreading_enabled(False):
                grad_v, grad_m = torch.autograd.grad(loss, (v, m))
        return (all_reduce(loss.detach(), SUM, mesh.group),
                all_reduce(grad_v, SUM, mesh.group),
                all_reduce(grad_m, SUM, mesh.group),
                _any(overflow, mesh.group))

    return _program(step)
