"""Differentiable rendering: the image and its gradient with respect to
vertices and materials (torch mirror of ugrt/diff/render_grad.py).

    detached vertices -> grid build -> trace (K1-K3) -> face ids, shadows
    vertices ----------------------> refine_primary --+
    materials ----------------------> shading --------+-> color

The CUDA kernels are invisible to autograd, so the trace runs on
``vertices.detach()`` on purpose, not by accident.  The shadow mask is
binary and carries no gradient; darkening uses the f32 /3
(``add_shadows_f32``) so it still scales the gradients of shadowed
pixels.  The backward is autograd's; the corner and material gathers'
(``core.gather.gather_rows``) are its only sums over pixels, exact in
fixed point, so the gradients' bits do not depend on summation order.
"""

from __future__ import annotations

import torch

from ugrt.config import RenderConfig
from ugrt_torch.grid import build as gbuild
from ugrt_torch.shade import shaders
from ugrt_torch.trace import primary as tprimary
from ugrt_torch.trace import refine as trefine
from ugrt_torch.trace import shadow as tshadow


def render_color(vertices, materials, faces, mat_index, camcoords,
                 light_camcoords, light_position, *, cfg: RenderConfig,
                 capacity: int, num_lights: int, use_spot: bool):
    """(f32 RGB [H, W, 3], overflow 0-d bool tensor), differentiable in
    ``vertices`` and ``materials``; equal to the u8 frame up to
    quantization.  ``overflow`` is true when a pair or heavy-list
    capacity clipped real geometry: the image and its gradients are then
    wrong, and callers must surface it."""
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


def render_and_grad(vertices, materials, faces, mat_index, camcoords,
                    light_camcoords, light_position, target, *,
                    cfg: RenderConfig, capacity: int, num_lights: int,
                    use_spot: bool):
    """The inverse-rendering step: the image, its MSE to ``target`` and
    the gradients of that loss.  Returns dict: loss (0-d), color
    [H, W, 3], grad_vertices [V, 3], grad_materials [M, 6] and overflow
    (as ``render_color``; the gradients cannot be trusted when set)."""
    with torch.enable_grad():
        v = vertices.detach().requires_grad_(True)
        m = materials.detach().requires_grad_(True)
        color, overflow = render_color(
            v, m, faces, mat_index, camcoords, light_camcoords,
            light_position, cfg=cfg, capacity=capacity,
            num_lights=num_lights, use_spot=use_spot)
        loss = torch.mean((color - target) ** 2)
        grad_v, grad_m = torch.autograd.grad(loss, (v, m))
    return dict(loss=loss.detach(), color=color.detach(),
                grad_vertices=grad_v, grad_materials=grad_m,
                overflow=overflow)
