"""The reference's frame, reflective frame and training step.

Frozen copies of the eager bodies of the program's entries:
``render_frame`` (``ugrt_torch/api/renderer.py:46-80``), the reflective
frame's body (:91-148) and ``_shade_at_points`` (:163-191),
``render_color`` and the step's body
(``ugrt_torch/diff/render_grad.py:41-104``), over the frozen plain path of
this package: no captured program, no kernel, nothing of ``ugrt_torch``.
``train_step`` takes ``lowp``: None for the reference, or a dtype (the
control's bfloat16) to which every floating input of the step, its
colour and its gradients are rounded.
"""

from __future__ import annotations

import torch

from benchmark.reference import build as gbuild
from benchmark.reference import primary as tprimary
from benchmark.reference import reflect as treflect
from benchmark.reference import refine as trefine
from benchmark.reference import shaders
from benchmark.reference import shadow as tshadow
from benchmark.reference.config import RenderConfig
from benchmark.reference.vecmath import absolute, dot, normalize, rotate_basis


def rounded(x, lowp):
    """``x`` rounded to ``lowp`` and back (``x`` itself for None)."""
    return x if lowp is None else x.to(lowp).to(x.dtype)


def render_frame(vertices, faces, mat_index, materials, camcoords,
                 light_camcoords, light_position, *, cfg: RenderConfig,
                 capacity: int, num_lights: int, use_spot: bool):
    """One frame: dict(image u8, color f32 (shadows /3), shadowed,
    primary, overflow)."""
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


def render_frame_reflective(vertices, faces, mat_index, materials,
                            camcoords, light_camcoords, light_position, *,
                            cfg: RenderConfig, capacity: int,
                            num_lights: int, use_spot: bool,
                            uniform_dims: tuple, uniform_capacity: int,
                            reflectivity: float, max_batches: int,
                            reflect_batch: int = 32):
    """A frame with one uniform-grid reflection bounce: dict(image,
    color, reflection, shadowed, primary, overflow)."""
    base = render_frame(vertices, faces, mat_index, materials, camcoords,
                        light_camcoords, light_position, cfg=cfg,
                        capacity=capacity, num_lights=num_lights,
                        use_spot=use_spot)
    primary = base["primary"]
    lo = vertices.amin(dim=0) - 1e-3
    hi = vertices.amax(dim=0) + 1e-3
    ugrid = gbuild.build_uniform_grid(vertices, faces, lo, hi,
                                      grid_dims=uniform_dims,
                                      capacity=uniform_capacity)
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
    refl_color = _shade_at_points(refl_primary, refl["origin"], shade_cc,
                                  light_position, mat_index, materials, cfg)
    kr = torch.full((), reflectivity, dtype=torch.float32,
                    device=vertices.device)
    mixed = ((1.0 - kr) * base["color"]
             + kr * torch.where((rfid >= 0)[..., None], refl_color, 0.0))
    image = (torch.clamp(mixed, 0.0, 1.0) * 255.0).to(torch.uint8)
    return dict(image=image, color=mixed, reflection=refl,
                shadowed=base["shadowed"], primary=primary,
                overflow=base["overflow"] | ugrid.overflow
                | refl["overflow"])


def _shade_at_points(refl_primary, origins, shade_cc, light_position,
                     mat_index, materials, cfg: RenderConfig):
    """Lambert (ambient 0.5, no drop-off) at per-pixel ray origins."""
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


def render_color(vertices, materials, faces, mat_index, camcoords,
                 light_camcoords, light_position, *, cfg: RenderConfig,
                 capacity: int, num_lights: int, use_spot: bool):
    """(f32 color [H, W, 3], overflow), differentiable in ``vertices``
    and ``materials``: the trace on detached vertices, then the refined
    hit and the shading."""
    vsg = vertices.detach()
    grid = gbuild.build_perspective_grid(vsg, faces, camcoords, cfg=cfg,
                                         capacity=capacity)
    raw = tprimary.trace_primary(vsg, faces, camcoords, grid, cfg)
    shadowed, light_overflow, shade_cc = tshadow.shadow_pass(
        vsg, faces, raw, camcoords, light_camcoords, cfg, capacity=capacity,
        num_lights=num_lights)
    refined = trefine.refine_primary(
        vertices, faces, camcoords, raw, cfg,
        face_aux=shaders.face_shade_meta(mat_index, materials.shape[0]))
    shade = shaders.spotlight if use_spot else shaders.lambert
    color = shade(refined, shade_cc, light_position, camcoords[0:3],
                  mat_index, materials, cfg)
    return (shaders.add_shadows_f32(color, shadowed),
            grid.overflow | light_overflow)


def train_step(vertices, materials, faces, mat_index, camcoords,
               light_camcoords, light_position, target, *,
               cfg: RenderConfig, capacity: int, lowp=None):
    """(loss, grad_vertices, grad_materials, overflow) of the MSE of the
    spot-shaded one-light frame to ``target``."""
    with torch.enable_grad():
        v = rounded(vertices, lowp).detach().requires_grad_(True)
        m = rounded(materials, lowp).detach().requires_grad_(True)
        color, overflow = render_color(
            v, m, faces, mat_index, rounded(camcoords, lowp),
            rounded(light_camcoords, lowp), rounded(light_position, lowp),
            cfg=cfg, capacity=capacity, num_lights=1, use_spot=True)
        loss = torch.mean((rounded(color, lowp) - target) ** 2)
        gv, gm = torch.autograd.grad(loss, (v, m))
    return loss.detach(), rounded(gv, lowp), rounded(gm, lowp), overflow
