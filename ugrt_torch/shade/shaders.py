"""Shading (torch mirror of ugrt/shade/shaders.py:44-164): Lambert,
spotlight, u8 quantization and shadow darkening.

Semantics as in ugrt: view-space transforms use the 3x3 rotation of the
shade-time camera (the last light's, main.cu:170); ambient 0.5, diffuse
1.0; Ka aliases Kd and the diffuse term takes |N.L| under the quirks;
misses shade black; shadowed pixels divide their u8 RGB by 3.
``gather.gather_rows`` fetches the materials, with a fixed-point backward
that sums exactly in any order (ugrt's TPU row gather, shaders.py:58-80,
sums by a one-hot matmul).  ``perlin_shade`` is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ugrt.config import RenderConfig
from ugrt_torch.core.gather import gather_rows
from ugrt_torch.core.vecmath import absolute, dot, normalize, rotate_basis
from ugrt_torch.grid import binning


def face_shade_meta(mat_index, num_materials: int):
    """[F, 2] f32 per-face shading metadata: (material id, validity); ids
    below 2^24 are exact in f32.  ``refine_primary`` carries it to the
    pixels as ``aux`` through its corner gather, so shading needs no
    mat_index gather of its own (ugrt shaders.py:32-41)."""
    valid = (mat_index >= 0) & (mat_index < num_materials)
    return torch.stack([mat_index.to(torch.float32),
                        valid.to(torch.float32)], dim=1)


def shade_core(primary, shade_camcoords, light_position, primary_eye,
               mat_index, materials, cfg: RenderConfig, drop_off):
    """lambert_color_pixel / lambert_color_drop_off_pixel
    (shader_kernel.cu:46-128) with lambertian_shade's material fetch and
    clamp (:165-221).  Returns f32 RGB [H, W, 3] in [0, 1].  Takes the
    pixels' (material id, validity) from ``primary["aux"]`` when the
    refine pass carried it (``face_shade_meta``), else from mat_index."""
    mv = shade_camcoords[16:32]
    num_materials = materials.shape[0]
    tri = primary["face_id"]
    if "aux" in primary:
        rows = primary["aux"]
        idx = rows[..., 0].to(torch.int32)
        valid = (tri >= 0) & (rows[..., 1] > 0)
        mats = gather_rows(materials,
                           torch.clamp(idx, 0, num_materials - 1).long())
    else:
        idx = torch.where(tri >= 0,
                          mat_index[torch.clamp(tri, min=0).long()], -1)
        valid = (idx >= 0) & (idx < num_materials)
        mats = gather_rows(materials, torch.clamp(idx, min=0).long())
    ka = mats[..., 3:6] if cfg.quirks.ka_from_kd else mats[..., 0:3]
    kd = mats[..., 3:6]

    t = primary["t"][..., None]
    point = primary_eye[None, None] + t * primary["ray_dir"]
    light_view = rotate_basis(mv, light_position)
    point_view = rotate_basis(mv, point)
    normal_view = normalize(rotate_basis(mv, primary["normal"]))
    light_dir = normalize(point_view - light_view[None, None])

    ndotl = dot(light_dir, normal_view)
    if cfg.quirks.abs_n_dot_l:
        ndotl = absolute(ndotl)
    diffuse = torch.where(ndotl > 0, ndotl, 0.0)[..., None]
    color = ka * 0.5 * drop_off + kd * diffuse * drop_off
    # min(color, 1) splits the gradient 0.5/0.5 at color == 1, as ugrt's
    # jnp.clip does (torch.clamp would pass all of it).
    color = torch.minimum(color, torch.ones((), device=color.device))
    return torch.where(valid[..., None] & (t > 0), color, 0.0)


def lambert(primary, shade_camcoords, light_position, primary_eye,
            mat_index, materials, cfg: RenderConfig):
    """lambertian_shade (shader_kernel.cu:165-221), f32 RGB."""
    return shade_core(primary, shade_camcoords, light_position, primary_eye,
                      mat_index, materials, cfg, 1.0)


def spotlight(primary, shade_camcoords, light_position, primary_eye,
              mat_index, materials, cfg: RenderConfig):
    """spot_shade (shader_kernel.cu:275-345), f32 RGB: drop-off 1.0 within
    ±pi/4 of the shade camera's axis in both signed angles (y with the
    typo), else 0.25; the apex is the shade camera's eye."""
    spot_eye = shade_camcoords[0:3]
    pts = (primary_eye[None, None]
           + primary["t"][..., None] * primary["ray_dir"])
    d = normalize(pts - spot_eye[None, None])
    x = binning.x_angle(d, shade_camcoords)
    y = binning.y_angle(d, shade_camcoords, cfg.quirks.y_forward_dot_typo)
    right, up, _ = binning.mv_basis(shade_camcoords)
    xs = torch.where(dot(d, right[None, None]) > 0, x, -x)
    ys = torch.where(dot(d, up[None, None]) > 0, y, -y)
    q = np.float32(math.pi / 4)
    inside = (xs < q) & (xs > -q) & (ys < q) & (ys > -q)
    drop = torch.where(inside, 1.0, 0.25)[..., None].to(torch.float32)
    return shade_core(primary, shade_camcoords, light_position, primary_eye,
                      mat_index, materials, cfg, drop)


def to_u8(color_f32):
    """color * 255 truncated to u8 (shader_kernel.cu:218-220)."""
    return (color_f32 * 255.0).to(torch.uint8)


def add_shadows_u8(image_u8, shadowed):
    """shadow_kernel: u8 integer divide by 3 (shader_kernel.cu:347-359)."""
    return torch.where(shadowed[..., None] == 1,
                       torch.div(image_u8, 3, rounding_mode="floor"),
                       image_u8)


def add_shadows_f32(color_f32, shadowed):
    """Shadow darkening in f32 (/3 instead of u8 //3).  Divides by a
    device tensor: CUDA turns division by a host scalar into a multiply
    by its reciprocal, which rounds differently."""
    three = torch.tensor(3.0, dtype=torch.float32, device=color_f32.device)
    return torch.where(shadowed[..., None] == 1, color_f32 / three,
                       color_f32)
