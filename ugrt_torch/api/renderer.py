"""Frame renderer (torch mirror of ugrt/api/renderer.py:41-106, :229-279).

Per frame, as the reference's display() (main.cu:59-302): camera
matrices on the host (``core.host_camera``) -> perspective grid ->
primary trace (K1, K2) -> per light: light window or extents, spherical
grid, shadow trace (K3) -> shade with the last light's camera ->
shadow darkening.  The tensors stay on the renderer's device; nothing
moves to the CPU unless that is the device asked for.

``render_frame_device`` is that frame as one captured program per
static key (``core.program``; ugrt's jitted ``render_frame_device``):
on the card one CUDA graph replay per frame.  ``Renderer.render`` calls
it; ``render_frame`` (``render_frame_device.fn``) is the eager frame.

``render_frame_reflective`` (ugrt/api/renderer.py:109-226) adds the
two-level trace: the plain frame, then a uniform world grid over the
scene's AABB, each primary hit's mirror ray traced through it
(``trace.reflect``, the kernel D1 on the card), the reflection hit
shaded by Lambert from the light position, and the two colors mixed by
``reflectivity``.  It is one captured program per static key too
(ugrt's jitted ``render_frame_reflective``); its eager body,
``render_frame_reflective.fn``, calls the eager ``render_frame``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ugrt_torch import bridge
from ugrt_torch.api import profiler
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.core.program import Program
from ugrt_torch.core.vecmath import (absolute, dot, normalize, rotate_basis,
                                     scalar)
from ugrt_torch.grid import build as gbuild
from ugrt_torch.shade import shaders
from ugrt_torch.trace import primary as tprimary
from ugrt_torch.trace import reflect as treflect
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


# ugrt/api/renderer.py:37-41 (its static arguments but the chunk size
# and trace backend, which the port does not have).
render_frame_device = Program(
    render_frame, static=("cfg", "capacity", "num_lights", "use_spot"))


def render_frame_reflective(vertices, faces, mat_index, materials,
                            camcoords, light_camcoords, light_position, *,
                            cfg: RenderConfig, capacity: int,
                            num_lights: int, use_spot: bool,
                            uniform_dims: tuple = (32, 32, 32),
                            uniform_capacity: int = 1 << 20,
                            reflectivity: float = 0.3,
                            max_batches: int = 8,
                            reflect_batch: int = 32):
    """A frame with one uniform-grid reflection bounce:
    color = (1 - kr) * the plain frame's color (shadows as /3) + kr * the
    reflection hit's Lambert color (0 on a miss), u8 image = clip(color,
    0, 1) * 255 truncated.  Returns dict(image, color, reflection,
    shadowed, primary, uniform_grid, overflow): ``overflow`` includes the
    uniform grid's pair capacity and a cell deeper than max_batches *
    reflect_batch faces."""
    # The eager frame: this body is captured whole, as ugrt's jit inlines
    # the inner jitted frame (a Program cannot capture inside a capture).
    base = render_frame(vertices, faces, mat_index, materials, camcoords,
                        light_camcoords, light_position, cfg=cfg,
                        capacity=capacity, num_lights=num_lights,
                        use_spot=use_spot)
    # The bounce: the uniform grid, the mirror rays, their shading, the mix.
    with profiler.span("frame.bounce", device=True):
        primary = base["primary"]
        lo = vertices.amin(dim=0) - 1e-3            # the padded scene AABB
        hi = vertices.amax(dim=0) + 1e-3
        ugrid = gbuild.build_uniform_grid(vertices, faces, lo, hi,
                                          grid_dims=uniform_dims,
                                          capacity=uniform_capacity)

        # Signed normals for the mirror (the abs quirk is display-only).
        normals = tprimary.face_normals(vertices, faces)
        fid = primary["face_id"]
        prim_signed = dict(t=primary["t"], face_id=fid,
                           normal=normals[torch.clamp(fid, min=0).long()],
                           ray_dir=primary["ray_dir"])
        refl = treflect.reflection_pass(
            vertices, faces, prim_signed, ugrid, lo, hi, uniform_dims, cfg,
            camcoords[0:3], max_batches=max_batches, batch=reflect_batch)

        rfid = refl["face_id"]
        rn = normals[torch.clamp(rfid, min=0).long()]
        if cfg.quirks.abs_normal:
            rn = torch.abs(rn)
        refl_primary = dict(t=refl["t"], face_id=rfid, normal=rn,
                            ray_dir=refl["ray_dir"])
        shade_cc = (light_camcoords[num_lights - 1] if num_lights > 0
                    else camcoords)
        refl_color = _shade_at_points(refl_primary, refl["origin"],
                                      shade_cc, light_position, mat_index,
                                      materials, cfg)

        kr = scalar(reflectivity, vertices.device)
        mixed = ((1.0 - kr) * base["color"]
                 + kr * torch.where((rfid >= 0)[..., None], refl_color, 0.0))
        image = (torch.clamp(mixed, 0.0, 1.0) * 255.0).to(torch.uint8)
        return dict(image=image, color=mixed, reflection=refl,
                    shadowed=base["shadowed"], primary=primary,
                    uniform_grid=ugrid,
                    overflow=base["overflow"] | ugrid.overflow
                    | refl["overflow"])


# ugrt/api/renderer.py:109-111 (its static arguments but the chunk size,
# which the port does not have); ``render_frame_reflective.fn`` is the
# eager body above.
render_frame_reflective = Program(
    render_frame_reflective,
    static=("cfg", "capacity", "num_lights", "use_spot", "uniform_dims",
            "uniform_capacity", "reflectivity", "max_batches",
            "reflect_batch"))


def _shade_at_points(refl_primary, origins, shade_cc, light_position,
                     mat_index, materials, cfg: RenderConfig):
    """Lambert shading (ambient 0.5, no drop-off) where the ray origins
    vary per pixel: the hit point is origin + t * dir.  Black where the
    ray missed or the material id is invalid."""
    mv = shade_cc[16:32]
    num_materials = materials.shape[0]
    tri = refl_primary["face_id"]
    idx = torch.where(tri >= 0, mat_index[torch.clamp(tri, min=0).long()],
                      -1)
    valid = (idx >= 0) & (idx < num_materials)
    mats = materials[torch.clamp(idx, 0, num_materials - 1).long()]
    ka = mats[..., 3:6] if cfg.quirks.ka_from_kd else mats[..., 0:3]
    kd = mats[..., 3:6]

    t = refl_primary["t"][..., None]
    point = origins + t * refl_primary["ray_dir"]
    light_view = rotate_basis(mv, light_position)
    point_view = rotate_basis(mv, point)
    normal_view = normalize(rotate_basis(mv, refl_primary["normal"]))
    light_dir = normalize(point_view - light_view[None, None])
    ndotl = dot(light_dir, normal_view)
    if cfg.quirks.abs_n_dot_l:
        ndotl = absolute(ndotl)
    diffuse = torch.where(ndotl > 0, ndotl, 0.0)[..., None]
    color = torch.minimum(ka * 0.5 + kd * diffuse,
                          torch.ones((), device=kd.device))
    return torch.where(valid[..., None] & (t > 0), color, 0.0)


class Renderer:
    """Host-side frame loop: holds the scene tensors on ``device``,
    computes each frame's camera matrices on the host and renders through
    ``render_frame_device`` (one program each for Lambert and the
    spotlight).  The first frame shades with Lambert, later ones with the
    spotlight (main.cu:205-219, frame_cnt < 2)."""

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
        """Dynamic scenes / animation: swap in new vertex positions (the
        span ``renderer.upload``)."""
        with profiler.span("renderer.upload"):
            self.vertices = bridge.from_numpy(vertices, self.device,
                                              np.float32)

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
        return render_frame_device(
            self.vertices, self.faces, self.mat_index, self.materials, cc,
            lccs, lp, cfg=self.cfg, capacity=self.capacity,
            num_lights=len(light_specs), use_spot=use_spot)
