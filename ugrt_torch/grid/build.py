"""CSR grid construction (torch mirror of ugrt/grid/build.py): the
perspective and spherical grids (:45-314) and the uniform world grid of
the reflection bounce (:317-397).

Pipeline per build: per-face cell ranges (ugrt_torch.grid.binning) ->
optional heavy-face split -> ragged pair expansion -> one stable sort of
packed (cell key, face) int64 keys -> CSR by ``torch.searchsorted`` over
the sorted keys.  The static pair and heavy capacities and their
overflow flags are kept: they define ugrt's results (which pairs exist),
so the grids are equal field for field.  ugrt's ``align > 1`` layout
exists only for TPU DMA alignment and has no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ugrt_torch.api import profiler
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.ragged import segment_ids_from_starts
from ugrt_torch.core.vecmath import scalar
from ugrt_torch.grid import binning

_MAXI = 2**31 - 1


class DeviceGrid(NamedTuple):
    """CSR acceleration structure plus the heavy-face list (see ugrt's
    DeviceGrid for the two-level split)."""

    sorted_faces: torch.Tensor   # [capacity] int32 face per pair, -1 pad
    sorted_keys: torch.Tensor    # [capacity] int32 cell keys (sentinel pad)
    cell_count: torch.Tensor     # [num_cells] int32
    cell_offset: torch.Tensor    # [num_cells] int32 exclusive scan
    total_pairs: torch.Tensor    # [] int32 (clamped to capacity)
    overflow: torch.Tensor       # [] bool: pair count exceeded capacity
    heavy_faces: torch.Tensor    # [heavy_capacity] int32 (-1 pad)
    heavy_count: torch.Tensor    # [] int32 (clamped to heavy_capacity)
    heavy_ranges: torch.Tensor   # [heavy_capacity, 4] int32 footprints


def _split_heavy(ranges, heavy_threshold: int, heavy_capacity: int):
    """Faces covering >= heavy_threshold cells leave the pair expansion
    for an ascending [heavy_capacity] list (-1 pad) with their footprint
    (gxmin, gxmax, gymin, gymax); dead slots get the empty (1, 0, 1, 0)."""
    counts = ranges["counts"]
    dev = counts.device
    heavy = counts >= heavy_threshold
    num_faces = counts.shape[0]
    face_ids = torch.arange(num_faces, dtype=torch.int32, device=dev)
    marked = torch.where(heavy, face_ids, _MAXI)
    if num_faces < heavy_capacity:
        marked = torch.nn.functional.pad(
            marked, (0, heavy_capacity - num_faces), value=_MAXI)
    packed = torch.sort(marked).values[:heavy_capacity]
    n_heavy = heavy.sum(dtype=torch.int32)
    slot = torch.arange(heavy_capacity, dtype=torch.int32, device=dev)
    heavy_faces = torch.where(
        slot < torch.clamp(n_heavy, max=heavy_capacity), packed, -1)

    fidx = torch.clamp(heavy_faces, 0, num_faces - 1).long()
    heavy_ranges = torch.stack(
        [ranges["gxmin"][fidx], ranges["gxmax"][fidx],
         ranges["gymin"][fidx], ranges["gymax"][fidx]], dim=1).to(torch.int32)
    empty = torch.ones(4, dtype=torch.int32, device=dev)
    empty[1::2] = 0          # [1, 0, 1, 0] by fills: no host copy
    heavy_ranges = torch.where((heavy_faces < 0)[:, None], empty,
                               heavy_ranges)

    light = dict(ranges)
    light["counts"] = torch.where(heavy, 0, counts).to(torch.int32)
    return (light, heavy_faces, torch.clamp(n_heavy, max=heavy_capacity),
            n_heavy > heavy_capacity, heavy_ranges)


def _expand_and_sort(ranges, gz, cfg: RenderConfig,
                     capacity: int) -> DeviceGrid:
    """Ragged expand + stable sort + CSR from per-face cell ranges.

    Pair keys replicate grid_kernel.cu:322 with i-major, j-minor
    enumeration: key = ((gxmin+i) * grid_y + (gymin+j)) * num_slabs + gz."""
    num_cells = cfg.num_cells
    dev = gz.device

    counts = ranges["counts"].to(torch.int32)
    size_y = (ranges["gymax"] - ranges["gymin"] + 1).to(torch.int32)
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    total = incl[-1]
    offsets = incl - counts

    p = torch.arange(capacity, dtype=torch.int32, device=dev)
    face_c = segment_ids_from_starts(offsets, capacity).long()
    valid = p < total

    base = ((ranges["gxmin"] * cfg.grid_y + ranges["gymin"]) * cfg.num_slabs
            + gz).to(torch.int32)
    k = p - offsets[face_c]
    sy = size_y[face_c]
    i = torch.div(k, sy, rounding_mode="floor")
    j = k - i * sy
    key = (base[face_c] + (i * cfg.grid_y + j) * cfg.num_slabs).to(torch.int32)
    return _sorted_csr(key, face_c, valid, total, num_cells, capacity)


def _sorted_csr(key, face_c, valid, total, num_cells: int,
                capacity: int) -> DeviceGrid:
    """Stable sort of the pairs by cell + CSR.  Sorting (key << 32 | face)
    orders pairs by cell, faces ascending within a cell, padding (face
    code 2^32-1, sentinel key ``num_cells``) last — the order of ugrt's
    stable key-value sort; the CSR comes from ``torch.searchsorted`` over
    the sorted keys."""
    dev = key.device
    key = torch.where(valid, key, num_cells).to(torch.int64)
    face_code = torch.where(valid, face_c.long(), 2**32 - 1)

    packed = torch.sort((key << 32) | face_code, stable=True).values
    sorted_key = (packed >> 32).to(torch.int32)
    fc = packed & (2**32 - 1)
    sorted_face = torch.where(fc == 2**32 - 1, -1, fc).to(torch.int32)

    cells = torch.arange(num_cells + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(sorted_key, cells).to(torch.int32)
    return DeviceGrid(
        sorted_faces=sorted_face,
        sorted_keys=sorted_key,
        cell_count=bounds[1:] - bounds[:-1],
        cell_offset=bounds[:-1].contiguous(),
        total_pairs=torch.clamp(total, max=capacity),
        overflow=total > capacity,
        heavy_faces=torch.full((0,), -1, dtype=torch.int32, device=dev),
        heavy_count=torch.zeros((), dtype=torch.int32, device=dev),
        heavy_ranges=torch.zeros((0, 4), dtype=torch.int32, device=dev),
    )


def _finish(r, cfg: RenderConfig, capacity: int,
            heavy_threshold: int) -> DeviceGrid:
    """Heavy split (single-slab configs only), slab bins, expand + sort."""
    if cfg.num_slabs > 1:
        heavy_threshold = 0  # the split needs per-slab modeling; disabled
    split = heavy_threshold > 0 and cfg.heavy_capacity > 0
    if split:
        r, hf, hc, hov, hr = _split_heavy(r, heavy_threshold,
                                          cfg.heavy_capacity)
    z_lo, z_hi = binning.z_minmax(r["zmin"])
    gz = binning.slab_bins(r["zmin"], z_lo, z_hi, cfg.num_slabs)
    g = _expand_and_sort(r, gz, cfg, capacity)
    if split:
        g = g._replace(heavy_faces=hf, heavy_count=hc, heavy_ranges=hr,
                       overflow=g.overflow | hov)
    return g


@profiler.spanned("grid.perspective", device=True)
def build_perspective_grid(vertices, faces, camcoords, *,
                           cfg: RenderConfig, capacity: int,
                           heavy_threshold: int | None = None) -> DeviceGrid:
    """Perspective grid over camera clip space (buildGrid).
    heavy_threshold None = cfg.heavy_threshold; 0 disables the split."""
    if heavy_threshold is None:
        heavy_threshold = cfg.heavy_threshold
    r = binning.perspective_face_ranges(vertices, faces, camcoords,
                                        cfg.grid_x, cfg.grid_y)
    return _finish(r, cfg, capacity, heavy_threshold)


@profiler.spanned("grid.spherical", device=True)
def build_spherical_grid(vertices, faces, camcoords, *,
                         cfg: RenderConfig, capacity: int,
                         x_max=None, y_max=None, window=None,
                         heavy_threshold: int | None = None) -> DeviceGrid:
    """Spherical light-centric grid (buildSphericalGrid); extent defaults
    to pi (main.cu:186-187).  ``window`` (x0, x1, y0, y1) selects the
    windowed parameterization (RenderConfig.light_grid_mode)."""
    if heavy_threshold is None:
        heavy_threshold = cfg.heavy_threshold
    if window is not None:
        r = binning.windowed_face_ranges(vertices, faces, camcoords,
                                         cfg.grid_x, cfg.grid_y, window)
    else:
        r = binning.spherical_face_ranges(
            vertices, faces, camcoords, cfg.grid_x, cfg.grid_y,
            cfg.angular_extent if x_max is None else x_max,
            cfg.angular_extent if y_max is None else y_max,
            cfg.quirks.y_forward_dot_typo)
    return _finish(r, cfg, capacity, heavy_threshold)


def _filled(values, dtype, device):
    """A 1-D tensor of host ``values`` made by fills, not a copy from host
    memory (capturable; see core.program)."""
    return torch.stack([scalar(v, device, dtype) for v in values])


def uniform_face_ranges(vertices, faces, aabb_min, aabb_max, grid_x: int,
                        grid_y: int, grid_z: int):
    """World-space uniform-grid binning for reflection rays (ugrt's
    uniform_face_ranges, the intent of the reference's dead UniformGrid,
    uniform_grid.h:11-59): each face's AABB over the scene AABB, cells
    keyed (gx * grid_y + gy) * grid_z + gz; aabb_min/aabb_max are [3]
    tensors.  Returns dict(gmin, gmax [F, 3] int32, counts [F] int32)."""
    v = vertices[faces.long()]                         # [F, 3, 3]
    dev = v.device
    lo = aabb_min.to(dtype=torch.float32, device=dev)
    hi = aabb_max.to(dtype=torch.float32, device=dev)
    extent = hi - lo
    dims = _filled((grid_x, grid_y, grid_z), torch.float32, dev)
    top = _filled((grid_x - 1, grid_y - 1, grid_z - 1), torch.int32, dev)

    def cell(p):
        c = torch.floor((p - lo) / extent * dims).to(torch.int32)
        return torch.minimum(torch.clamp(c, min=0), top)

    gmin, gmax = cell(v.amin(dim=1)), cell(v.amax(dim=1))
    size = gmax - gmin + 1
    counts = (size[:, 0] * size[:, 1] * size[:, 2]).to(torch.int32)
    return dict(gmin=gmin, gmax=gmax, counts=counts)


def build_uniform_grid(vertices, faces, aabb_min, aabb_max, *,
                       grid_dims: tuple[int, int, int],
                       capacity: int) -> DeviceGrid:
    """Uniform world-space grid (ugrt's build_uniform_grid): 3-D ragged
    expand of each face's cell box (x-major, then y, then z) into a
    static [capacity] pair buffer, stable sort by cell, CSR; ``overflow``
    when the pairs exceed ``capacity``.  No heavy-face split."""
    gx, gy, gz = grid_dims
    r = uniform_face_ranges(vertices, faces, aabb_min, aabb_max, gx, gy, gz)
    counts, gmin = r["counts"], r["gmin"]
    size = r["gmax"] - gmin + 1
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    total = incl[-1]
    offsets = incl - counts

    p = torch.arange(capacity, dtype=torch.int32, device=counts.device)
    face_c = segment_ids_from_starts(offsets, capacity).long()
    valid = p < total

    k = p - offsets[face_c]
    sy, sz = size[face_c, 1], size[face_c, 2]
    syz = sy * sz
    i = torch.div(k, syz, rounding_mode="floor")
    rem = k - i * syz
    j = torch.div(rem, sz, rounding_mode="floor")
    kk = rem - j * sz
    g = gmin[face_c]
    key = (((g[:, 0] + i) * gy + (g[:, 1] + j)) * gz
           + (g[:, 2] + kk)).to(torch.int32)
    return _sorted_csr(key, face_c, valid, total, gx * gy * gz, capacity)
