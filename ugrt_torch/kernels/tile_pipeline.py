"""S2 — a windowed sweep cut into copy and math (CUDA:
``csrc/tile_pipeline.cu``), the probe behind
``ugrt_torch.micro.pallas_micro``.

Replaces the Pallas probe ``kern`` in ``make`` of
scripts/pallas_micro.py:29 with its ``compute_block`` (:19-26).  Item k
reads the 128 x 128 triangle tile tri[offs[k] : offs[k] + 128] and the
ray tile rays[tiles[k]] (f32 [8, 128]); per ray column it runs a 9-step
multiply/add/scale/abs chain over each tile row and keeps the minimum
and the first row that attains it.  ``variant``: "dma" copies and
writes zeros, "compute" computes on zero tiles without copying (the TPU
version read uninitialised memory there), "full" does both.  ``wchunk``
items share one CUDA block and its double buffer; it changes the time,
never the result.  offs and tiles are clamped into range.

``tile_sweep`` launches the kernel for CUDA tensors and runs
``tile_sweep_plain`` (bitwise equal) only for CPU tensors.
"""

from __future__ import annotations

import torch

from ugrt_torch.kernels import _build

ROWS = COLS = 128                # tile rows (B) and columns (COLS)
RAY_C, RAY_N = 8, 128            # ray tile
VARIANTS = {"dma": 0, "compute": 1, "full": 2}
_ITEMS_PER_CHUNK = 512


def _check(offs, tiles, tri, rays, variant, wchunk):
    dev = tri.device
    _build.check_tensor(offs, "offs", torch.int32, (None,), dev)
    _build.check_tensor(tiles, "tiles", torch.int32, (offs.shape[0],), dev)
    _build.check_tensor(tri, "tri", torch.float32, (None, COLS), dev)
    _build.check_tensor(rays, "rays", torch.float32, (None, RAY_C, RAY_N),
                        dev)
    if tri.shape[0] < ROWS or rays.shape[0] == 0:
        raise ValueError(f"tri needs at least {ROWS} rows and rays one tile")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got "
                         f"{variant!r}")
    if not isinstance(wchunk, int) or wchunk < 1:
        raise ValueError(f"wchunk must be a positive int, got {wchunk!r}")
    if tri.data_ptr() % 16 or rays.data_ptr() % 16:
        raise ValueError("tri and rays: the kernel copies them 16 bytes at "
                         "a time; their data must be 16-byte aligned")


def tile_sweep(offs, tiles, tri, rays, variant="full", wchunk=8):
    """(t f32 [N, 128], i int32 [N, 128]): per item and ray column, the
    minimum of the chain over the tile rows and its first row."""
    _check(offs, tiles, tri, rays, variant, wchunk)
    if tri.device.type == "cpu":
        return tile_sweep_plain(offs, tiles, tri, rays, variant)
    if tri.device.type != "cuda":
        raise ValueError(f"tile_sweep: unsupported device {tri.device}")
    n = offs.shape[0]
    t = torch.empty((n, RAY_N), dtype=torch.float32, device=tri.device)
    i = torch.empty((n, RAY_N), dtype=torch.int32, device=tri.device)
    _build.launch("ugrt_tile_sweep", offs, tiles, n, tri, tri.shape[0], rays,
                  rays.shape[0], VARIANTS[variant], wchunk, t, i)
    tile_sweep.launches += 1
    return t, i


tile_sweep.launches = 0


def compute_block(tri_rows, ray_tile):
    """compute_block (scripts/pallas_micro.py:19-26) for a batch:
    tri_rows [C, 128 rows, >= 9] and ray_tile [C, 8, 128 rays] ->
    (min [C, 128], first argmin [C, 128] int32) over the rows."""
    acc = tri_rows[:, :, 0, None] * ray_tile[:, None, 0, :]
    for i in range(1, 9):
        acc = acc + tri_rows[:, :, i, None] * ray_tile[:, None, i % 8, :]
        acc = acc * 1.0001 - 0.5
        acc = torch.abs(acc)
    t, arg = acc.min(dim=1)
    return t, arg.to(torch.int32)


def tile_sweep_plain(offs, tiles, tri, rays, variant="full"):
    """``tile_sweep`` in PyTorch ops (any device)."""
    n, dev = offs.shape[0], tri.device
    t = torch.zeros((n, RAY_N), dtype=torch.float32, device=dev)
    i = torch.zeros((n, RAY_N), dtype=torch.int32, device=dev)
    if variant == "dma":
        return t, i
    off = torch.clamp(offs.long(), 0, tri.shape[0] - ROWS)
    tl = torch.clamp(tiles.long(), 0, rays.shape[0] - 1)
    rows = torch.arange(ROWS, device=dev)
    for s in range(0, n, _ITEMS_PER_CHUNK):
        e = min(n, s + _ITEMS_PER_CHUNK)
        if variant == "full":
            tri_rows = tri[off[s:e, None] + rows, :9]
            ray_tile = rays[tl[s:e]]
        else:
            tri_rows = torch.zeros((e - s, ROWS, 9), device=dev)
            ray_tile = torch.zeros((e - s, RAY_C, RAY_N), device=dev)
        t[s:e], i[s:e] = compute_block(tri_rows, ray_tile)
    return t, i
