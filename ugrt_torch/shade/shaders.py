"""Shading (torch mirror of ugrt/shade/shaders.py:44-164): Lambert,
spotlight, u8 quantization, shadow darkening and the Perlin debug
shader.

Semantics as in ugrt: view-space transforms use the 3x3 rotation of the
shade-time camera (the last light's, main.cu:170); ambient 0.5, diffuse
1.0; Ka aliases Kd and the diffuse term takes |N.L| under the quirks;
misses shade black; shadowed pixels divide their u8 RGB by 3.
``gather.gather_rows`` fetches the materials with int32 indices, as
ugrt's does (shaders.py:74-80), with a fixed-point backward that sums
exactly in any order (ugrt's TPU row gather sums by a one-hot matmul):
on the card the kernel G1 (kernels/segment_sum.py), whose warps carry
their pixels' material in registers while it stays the same and add
into a shared table of the few rows only when it changes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.core.gather import gather_rows
from ugrt_torch.core.vecmath import (absolute, dot, normalize, rotate_basis,
                                     scalar)
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
        mats = gather_rows(materials, torch.clamp(idx, 0, num_materials - 1))
    else:
        idx = torch.where(tri >= 0,
                          mat_index[torch.clamp(tri, min=0).long()], -1)
        valid = (idx >= 0) & (idx < num_materials)
        mats = gather_rows(materials, torch.clamp(idx, min=0))
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
    three = scalar(3.0, color_f32.device)
    return torch.where(shadowed[..., None] == 1, color_f32 / three,
                       color_f32)


# ---------------------------------------------------------------------------
# Perlin value-noise debug shader (ugrt/shade/shaders.py:168-230:
# perlin_noise_shade + get_material, shader_kernel.cu:4-44, :130-163,
# :505-547).  The hash wraps in int32 as the reference's C does; torch's
# int32 *, << and & wrap the same way on the CPU and on CUDA.


def _noise_int(x):
    """Noise(int) hash (shader_kernel.cu:14-18), int32 wraparound."""
    x = x.to(torch.int32)
    x = (x << 13) ^ x
    h = (x * (x * x * 15731 + 789221) + 1376312589) & 0x7FFFFFFF
    # 2^31 as a device tensor: a power of two, so the quotient is exact.
    return h.to(torch.float32) / scalar(2147483648.0, h.device)


def _interp(a, b, c):
    """InterPolation (shader_kernel.cu:4-7): smoothstep blend."""
    return a + (b - a) * c * c * (3 - 2 * c)


def perlin_noise(x, y, width: int, seed: int, periode):
    """PerlinNoise single octave (shader_kernel.cu:20-44) at f32 pixel
    coordinates ``x``, ``y``; the scalar math is ugrt's numpy f32."""
    freq = np.float32(1.0) / np.float32(periode)
    num = int((np.float32(width) * freq).astype(np.int32))
    fx, fy = x * freq, y * freq
    step_x, step_y = fx.to(torch.int32), fy.to(torch.int32)
    zone_x = fx - step_x.to(torch.float32)
    zone_y = fy - step_y.to(torch.float32)
    nd = step_x + step_y * num + seed
    a = _interp(_noise_int(nd), _noise_int(nd + 1), zone_x)
    b = _interp(_noise_int(nd + num), _noise_int(nd + 1 + num), zone_x)
    return _interp(a, b, zone_y) * np.float32(324.0)


def perlin_shade(face_id, width_px: int, height_px: int, cfg: RenderConfig):
    """perlin_noise_shade (shader_kernel.cu:505-547): screen-space octave
    stack, black on miss.  Returns u8 RGB [height_px, width_px, 3] on
    ``face_id``'s device.  Red only, as in the reference: its channel
    math InterLinear(tmp, 0, 0), (0, tmp, 0), (0, 0, tmp) gives (tmp, 0,
    0) (ugrt's docstring)."""
    dev = face_id.device
    x = torch.arange(width_px, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(height_px, dtype=torch.float32, device=dev)[:, None]
    x = x.expand(height_px, width_px)
    y = y.expand(height_px, width_px)

    seed, width = 63, 12413
    scales = (1.0, 0.25, 0.125, 0.0625, 0.03125, 0.0156)
    tmp = 0
    for p, s in zip((100, 25, 12.5, 6.25, 3.125, 1.56), scales):
        v = perlin_noise(x, y, width, seed, p) * np.float32(s)
        tmp = tmp + v.to(torch.int32).to(torch.float32)

    r = torch.clamp(tmp, 0, 255).to(torch.int32)
    rgb = torch.stack([r, torch.zeros_like(r), torch.zeros_like(r)],
                      dim=-1).to(torch.uint8)
    return torch.where((face_id >= 0)[..., None], rgb, 0).to(torch.uint8)
