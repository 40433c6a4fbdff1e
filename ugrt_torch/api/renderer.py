"""Frame renderer (torch mirror of ugrt/api/renderer.py:41-106, :229-279).

Per frame, as the reference's display() (main.cu:59-302): camera
matrices on the host (``core.host_camera``) -> perspective grid ->
primary trace (K1, K2) -> per light: light window or extents, spherical
grid, shadow trace (K3) -> shade with the last light's camera ->
shadow darkening.  The tensors stay on the renderer's device; nothing
moves to the CPU unless that is the device asked for.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ugrt_torch import bridge
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.grid import build as gbuild
from ugrt_torch.shade import shaders
from ugrt_torch.trace import primary as tprimary
from ugrt_torch.trace import shadow as tshadow


def render_frame(vertices, faces, mat_index, materials, camcoords,
                 light_camcoords, light_position, *, cfg: RenderConfig,
                 capacity: int, num_lights: int, use_spot: bool):
    """One frame.  Returns dict: image u8 [H, W, 3], color f32 [H, W, 3]
    (shadows as /3), shadowed int32 [H, W], primary (t, face_id, normal,
    ray_dir) and overflow (bool tensor: a pair or heavy-list capacity
    of either grid was exceeded, so geometry was clipped).

    light_camcoords: [num_lights (or 1), 64]; shading uses the last
    light's camera when there is a light (the reference's constant-memory
    state), else the camera's.
    """
    grid = gbuild.build_perspective_grid(vertices, faces, camcoords,
                                         cfg=cfg, capacity=capacity)
    primary = tprimary.trace_primary(vertices, faces, camcoords, grid, cfg)

    shadowed, light_overflow, shade_cc = tshadow.shadow_pass(
        vertices, faces, primary, camcoords, light_camcoords, cfg,
        capacity=capacity, num_lights=num_lights)
    eye = camcoords[0:3]
    overflow = grid.overflow | light_overflow

    shade = shaders.spotlight if use_spot else shaders.lambert
    color = shade(primary, shade_cc, light_position, eye, mat_index,
                  materials, cfg)
    image = shaders.add_shadows_u8(shaders.to_u8(color), shadowed)
    return dict(image=image, color=shaders.add_shadows_f32(color, shadowed),
                shadowed=shadowed, primary=primary, overflow=overflow)


class Renderer:
    """Host-side frame loop: holds the scene tensors on ``device``,
    computes each frame's camera matrices on the host and renders.  The
    first frame shades with Lambert, later ones with the spotlight
    (main.cu:205-219, frame_cnt < 2)."""

    def __init__(self, scene, cfg: RenderConfig, capacity: int | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer: device 'cuda' requested but CUDA "
                               "is not available")
        t = bridge.scene_to_torch(scene, self.device)
        self.vertices = t["vertices"]
        self.faces = t["faces"]
        self.mat_index = t["mat_index"]
        self.materials = t["materials"]
        self.capacity = (capacity if capacity is not None
                         else cfg.pair_capacity(scene.num_faces))
        self.frame_cnt = 0

    def update_vertices(self, vertices):
        """Dynamic scenes / animation: swap in new vertex positions."""
        self.vertices = bridge.from_numpy(vertices, self.device, np.float32)

    def _camcoords(self, spec):
        cfg = self.cfg
        return bridge.camcoords_to_torch(
            spec, cfg.fovy_deg, cfg.screen_width / cfg.screen_height,
            self.device)

    def render(self, camera_spec: CameraSpec,
               light_specs: Sequence[CameraSpec], light_position,
               use_spot: bool | None = None):
        """Render one frame (see ``render_frame`` for the result)."""
        self.frame_cnt += 1
        if use_spot is None:
            use_spot = self.frame_cnt >= 2   # main.cu:205
        cc = self._camcoords(camera_spec)
        if light_specs:
            lccs = torch.stack([self._camcoords(s) for s in light_specs])
        else:
            lccs = torch.zeros((1, 64), dtype=torch.float32,
                               device=self.device)
        lp = bridge.from_numpy(light_position, self.device, np.float32)
        return render_frame(self.vertices, self.faces, self.mat_index,
                            self.materials, cc, lccs, lp, cfg=self.cfg,
                            capacity=self.capacity,
                            num_lights=len(light_specs), use_spot=use_spot)
