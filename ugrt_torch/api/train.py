"""Inverse-rendering training loop (torch mirror of ugrt/api/train.py).

Optimizes the scene's vertices and/or materials against per-frame target
images with Adam, one frame per step (``step % len(camera_specs)``),
through the differentiable step ``diff.render_grad.render_and_grad``
(K1-K3 on the card), with checkpoints every ``checkpoint_every`` steps
and resume from the latest one (parameters only, a fresh optimizer
state, as ugrt does).  The step is a captured program: on one card
every frame of ``camera_specs`` replays the same CUDA graph (the frames
share their shapes), and Adam runs eagerly after it, as ugrt's optax
update runs outside its jit.  ``use_mesh`` shards each step's image over
the ranks of the default process group (``dist.mesh.sharded_train_step``,
a captured program too, its collectives inside the graph, kept across
calls as ``render_and_grad`` is, so that a later job replays the graph
that the first one recorded): every rank calls ``train()``, as under
``torchrun``, renders its strip of tile columns and takes the gradients
summed over the group.  The checkpoint barrier and the step's one host
read stay outside the program.  A step is the span ``train.step``
(``api.profiler``), Adam the device span ``train.adam`` inside it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ugrt_torch import bridge
from ugrt_torch.api import checkpoint as ckpt
from ugrt_torch.api import profiler
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.diff.render_grad import render_and_grad
from ugrt_torch.dist import mesh as dmesh


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-2
    steps: int = 100
    optimize_vertices: bool = True
    optimize_materials: bool = True
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    use_mesh: bool = False  # shard over the default process group


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8), one
    tensor at a time (``foreach=False``), so the CPU and the card update
    with the same op order."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, foreach=False)


def train(scene, camera_specs: Sequence[CameraSpec], light_spec: CameraSpec,
          light_position, targets, cfg: RenderConfig, tcfg: TrainConfig,
          verbose: bool = True, device="cuda"):
    """Optimize scene params against per-frame targets.

    camera_specs: one camera per frame (animated path); targets: one
    [H, W, 3] float32 image (array or tensor) per frame.  Every step
    renders with one light and the spotlight shader.  Returns the final
    (vertices, materials) tensors on ``device`` and the list of losses.
    Raises if a step's grid capacities overflow (its gradients would be
    corrupt).

    With ``tcfg.use_mesh`` the run is SPMD over the initialized default
    process group: every rank calls ``train()`` with the same arguments,
    renders its strip of each target (``device`` "cuda" means the card
    ``cuda:<LOCAL_RANK>``), and every rank returns the same losses and
    parameters.  Only rank 0 writes checkpoints; every rank resumes from
    the latest.  The sharded step's graph is kept for the next call:
    call ``dist.mesh.clear()`` (or ``render_and_grad.clear()``) before
    destroying the process group.
    """
    mesh = None
    if tcfg.use_mesh:
        if not dist.is_initialized():
            raise RuntimeError(
                "train(use_mesh=True) runs on every rank of an initialized "
                "torch.distributed default process group (e.g. under "
                "torchrun, after init_process_group); none is initialized")
        mesh = dmesh.make_mesh(device=device)
        device = mesh.device
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: device 'cuda' requested but CUDA is not "
                           "available")
    aspect = cfg.screen_width / cfg.screen_height
    cap = cfg.pair_capacity(scene.num_faces)
    t = bridge.scene_to_torch(scene, device)
    lcc = bridge.camcoords_to_torch(light_spec, cfg.fovy_deg, aspect,
                                    device)[None]
    lp = bridge.from_numpy(light_position, device, np.float32)
    ccs = [bridge.camcoords_to_torch(s, cfg.fovy_deg, aspect, device)
           for s in camera_specs]
    targets = [x.to(device, torch.float32) if isinstance(x, torch.Tensor)
               else bridge.from_numpy(x, device, np.float32) for x in targets]
    vertices, materials = t["vertices"], t["materials"]

    start_step = 0
    if tcfg.checkpoint_dir:
        if mesh is not None:
            # Rank 0 wrote the checkpoints of an earlier run: wait for it.
            dist.barrier(group=mesh.group, device_ids=(
                [device.index] if device.type == "cuda" else None))
        latest = ckpt.latest_step(tcfg.checkpoint_dir)
        if latest is not None:
            state = ckpt.load_checkpoint(tcfg.checkpoint_dir, latest)
            vertices = bridge.from_numpy(state["params/vertices"], device,
                                         np.float32)
            materials = bridge.from_numpy(state["params/materials"],
                                          device, np.float32)
            start_step = latest + 1
            if verbose:
                print(f"resumed from step {latest}")

    kw = dict(cfg=cfg, capacity=cap, num_lights=1, use_spot=True)
    if mesh is None:
        def grads_for(frame):
            return render_and_grad(
                vertices, materials, t["faces"], t["mat_index"], ccs[frame],
                lcc, lp, targets[frame], **kw)
    else:
        sharded_step = dmesh.sharded_train_step(mesh, **kw)

        def grads_for(frame):
            loss, gv, gm, overflow = sharded_step(
                vertices, materials, t["faces"], t["mat_index"], ccs[frame],
                lcc, lp, targets[frame])
            return dict(loss=loss, grad_vertices=gv, grad_materials=gm,
                        overflow=overflow)

    opt = make_optimizer([vertices, materials], tcfg.learning_rate)
    log = []
    for step in range(start_step, tcfg.steps):
        with profiler.span("train.step", request=True):
            out = grads_for(step % len(camera_specs))
            vertices.grad = (out["grad_vertices"] if tcfg.optimize_vertices
                             else torch.zeros_like(vertices))
            materials.grad = (out["grad_materials"]
                              if tcfg.optimize_materials
                              else torch.zeros_like(materials))
            with profiler.span("train.adam", device=True):
                opt.step()
            # ONE host read for both scalars: the loss read the loop pays
            # anyway doubles as the overflow check.
            loss_v, ovf_v = torch.stack(
                [out["loss"], out["overflow"].to(torch.float32)]).tolist()
            if ovf_v:
                raise RuntimeError(
                    "static capacity overflow during training step: "
                    "geometry was clipped and gradients are corrupt — "
                    "raise RenderConfig.pair_capacity_factor / "
                    "heavy_capacity / shadow work capacity")
            log.append(loss_v)
            if verbose and (step % 10 == 0 or step == tcfg.steps - 1):
                print(f"step {step}: loss {loss_v:.6f}")
            if (tcfg.checkpoint_dir
                    and (step + 1) % tcfg.checkpoint_every == 0
                    and (mesh is None or mesh.rank == 0)):
                ckpt.save_checkpoint(
                    tcfg.checkpoint_dir, {"params": {
                        "vertices": vertices, "materials": materials}},
                    step)

    return vertices.detach(), materials.detach(), log
