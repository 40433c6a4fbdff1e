"""Frozen copy of ``ugrt_torch/config.py`` (lines 1-120), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Render configuration (the port's copy of ugrt/config.py).

The reference program's compile-time constants (main.cu.h:1-42) plus the
quirk ledger of SURVEY.md §7.  The fields, defaults and
``pair_capacity`` are ugrt's, value for value
(tests/test_torch_isolation.py holds them equal); the port keeps its own
copy so that it imports nothing of ``ugrt``.  Everything here is frozen
and hashable.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class QuirkConfig:
    """Reference-faithful numeric quirks (SURVEY.md §7 quirk ledger).

    Parity configs must keep all of these True; "clean" mode may disable
    them to get physically conventional behavior.
    """

    # trace_kernel.cu:35 — Möller–Trumbore accepts t<0 by taking |t|.
    abs_t: bool = True
    # trace_kernel.cu:241-243 — geometric normal stored component-wise abs.
    abs_normal: bool = True
    # shader_kernel.cu:79 — diffuse term uses |N·L| instead of max(N·L, 0).
    abs_n_dot_l: bool = True
    # shader_kernel.cu:180-186 — ambient color aliases the diffuse color
    # (material slots 3..5 used for both Ka and Kd).
    ka_from_kd: bool = True
    # grid_kernel.cu:199,:292 — front-face / inside culling disabled (`if (1)`).
    disable_culling: bool = True
    # grid_kernel.cu:439, misc_kernel.cu:191, shader_kernel.cu:263 — the
    # y-angle helpers compute forward·dir with a `*` typo:
    #   f0*t0 + f1*t1*f2*t2   instead of   f0*t0 + f1*t1 + f2*t2.
    y_forward_dot_typo: bool = True
    # light_kernel.cu:43-47 — shadow occlusion test accepts negative t.
    shadow_accept_negative_t: bool = True


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (mirrors the reference's main.cu.h)."""

    screen_width: int = 1024   # main.cu.h:10
    screen_height: int = 1024  # main.cu.h:11
    fovy_deg: float = 45.0     # main.cu.h:14

    grid_x: int = 128          # NUM_BLOCKS_X, main.cu.h:16
    grid_y: int = 128          # NUM_BLOCKS_Y, main.cu.h:17
    num_slabs: int = 1         # NUM_SLABS,    main.cu.h:18

    tile_x: int = 8            # NUM_THREADS_X, main.cu.h:25
    tile_y: int = 8            # NUM_THREADS_Y, main.cu.h:26

    # Triangle batch per work item (the reference streams 64 per shared
    # memory batch, MAX_TRIANGLES, main.cu.h:28; ugrt uses 128).  The
    # port reads it only to round pair_capacity.
    tri_batch: int = 128
    max_rays_per_packet: int = 64  # MAX_RAYS_PER_BLOCK, main.cu.h:32

    material_size: int = 6     # MATERIAL_SIZE, main.cu.h:34
    # Möller–Trumbore determinant epsilon (main.cu.h:42).
    epsilon: float = 1e-21
    # Shadow distance epsilon (light_kernel.cu:4).
    shadow_epsilon: float = 1e-3
    # The spherical (light) grid angular extent; main.cu:186-187 computes a
    # max then overrides it with pi.
    angular_extent: float = math.pi
    # Light-grid parameterization:
    #   "reference" — the reference's symmetric angle mapping with the
    #     pi extent override (main.cu:186-187) and the y forward-dot
    #     typo.  Parity mode.
    #   "extent" — same mapping, but with the per-frame measured max
    #     angles the reference computes at main.cu:174-185 and then
    #     discards.
    #   "windowed" — affine remap of SIGNED per-axis angles over the
    #     measured hit-point angle window (and the correct y dot).  A
    #     pure coordinate change of the same conservative binning, so
    #     occlusion results are equivalent — but the 128x128 grid then
    #     actually resolves the lit region.
    light_grid_mode: str = "reference"

    # Pair-buffer capacity for grid build, as a multiple of the face
    # count.  Data-dependent totals are clamped to this (with an overflow
    # flag).
    pair_capacity_factor: int = 8
    # Two-level grid split (ugrt_torch.grid.build.DeviceGrid): faces whose
    # clip-space footprint covers >= heavy_threshold cells go to a small
    # global list swept densely for every ray instead of the pair buffer.
    # Identical results, a much smaller pair buffer on interior scenes.
    # 0 disables the split.
    heavy_threshold: int = 256
    heavy_capacity: int = 1024
    quirks: QuirkConfig = QuirkConfig()

    @property
    def image_size(self) -> int:
        return self.screen_width * self.screen_height

    @property
    def num_cells(self) -> int:
        return self.grid_x * self.grid_y * self.num_slabs

    @property
    def cell_sentinel(self) -> int:
        """Out-of-grid sort key (misc_kernel.cu:291: NUM_BLOCKS_X*NUM_BLOCKS_Y)."""
        return self.grid_x * self.grid_y

    def pair_capacity(self, num_faces: int) -> int:
        # Low-poly scenes have large per-face footprints (a wall quad can
        # span hundreds of cells), so keep a floor independent of F.
        cap = max(self.pair_capacity_factor * max(num_faces, 1), 16384)
        # Round up to a tri_batch multiple so padded layouts reshape evenly.
        b = self.tri_batch
        return ((cap + b - 1) // b) * b

