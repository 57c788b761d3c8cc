"""Render configuration.

Re-design of the reference's compile-time constants
(/root/reference/main.cu.h:1-42) plus the quirk ledger from SURVEY.md §7.
Everything here is static (hashable) so it can be a jit static argument.
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
    """Static render configuration (mirrors /root/reference/main.cu.h)."""

    screen_width: int = 1024   # main.cu.h:10
    screen_height: int = 1024  # main.cu.h:11
    fovy_deg: float = 45.0     # main.cu.h:14

    grid_x: int = 128          # NUM_BLOCKS_X, main.cu.h:16
    grid_y: int = 128          # NUM_BLOCKS_Y, main.cu.h:17
    num_slabs: int = 1         # NUM_SLABS,    main.cu.h:18

    tile_x: int = 8            # NUM_THREADS_X, main.cu.h:25
    tile_y: int = 8            # NUM_THREADS_Y, main.cu.h:26

    # Triangle batch per work item of the XLA trace path.  The reference
    # streams 64 triangles per shared-memory batch (MAX_TRIANGLES,
    # main.cu.h:28); the XLA path sweeps 128 per work item.
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
    #     actually resolves the lit region.  Measured on the flagship
    #     interior scene: the reference mapping concentrates all 1M
    #     shadow rays into ~75 cells (the typo'd y angle is CONSTANT
    #     pi/2 for an axis-aligned light, so the grid degenerates to
    #     one row; x angles occupy a narrow band offset from zero),
    #     making the shadow sweep the dominant frame cost.
    light_grid_mode: str = "reference"

    # Static pair-buffer capacity for grid build, as a multiple of the face
    # count.  Data-dependent totals are clamped to this (with an overflow
    # flag); recompile with a larger factor if it trips.
    pair_capacity_factor: int = 8
    # Two-level grid split (see ugrt.grid.build.DeviceGrid): faces whose
    # clip-space footprint covers >= heavy_threshold cells — on interior
    # scenes mostly behind-the-eye faces whose perspective-divided AABB
    # explodes to the whole grid, which the reference duplicates into
    # every cell (frustum_grid.h:254 reallocates to fit) — go to a small
    # global list swept densely for every ray instead of the pair buffer.
    # Identical results, ~20x smaller pair buffer on reference-scale
    # scenes.  0 disables the split.
    heavy_threshold: int = 256
    heavy_capacity: int = 1024
    # Static cap on work items (cell-batch pairs), as a fraction of
    # (pair_capacity // tri_batch) + active cell bound.
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


DEFAULT_CONFIG = RenderConfig()
