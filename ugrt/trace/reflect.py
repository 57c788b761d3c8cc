"""Reflection rays through the world-space uniform grid (2-level trace).

The reference *intends* uniform grids for reflection rays (README.md:1)
but never wires them: UniformGrid (uniform_grid.h:11-59) is dead code and
no bounce exists (SURVEY.md §2).  BASELINE config 4 requires an actual
2-level trace, so this is a new design:

  * reflection directions from the primary hit: r = d - 2(d·n)n with the
    SIGNED geometric normal oriented against the incoming ray (the
    abs-normal quirk is display-only; reflecting off |n| would be
    physically meaningless);
  * 3-D DDA (Amanatides–Woo) through the uniform grid built by
    ugrt.grid.build.build_uniform_grid, vectorized over all rays with a
    lax.scan over steps (static bound gx+gy+gz);
  * per step each active ray tests its cell's triangle list (CSR gather,
    masked); a hit is only accepted while inside the cell that yielded it
    (t_hit <= t_exit), the standard DDA correctness rule;
  * self-intersection is excluded by skipping the originating face id.

Per-cell triangle lists are tested in ceil(count/B) sub-batches up to a
static bound ``max_batches``; cells deeper than that are truncated (an
overflow flag reports it — raise max_batches to remove the cap).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ugrt.config import RenderConfig
from ugrt.core.vecmath import cross, dot, normalize
from ugrt.grid.build import DeviceGrid
from ugrt.trace.primary import moller_trumbore_t

# numpy scalar, NOT jnp: a module-level device array gets hoisted as a
# hidden executable parameter under jax 0.9 simplified-jaxpr-constants,
# and the pjit C++ fastpath then drops it on re-execution
# ("Execution supplied N buffers but compiled program expected M").
_BIG = np.float32(3.0e38)


def reflect_directions(primary, xp=jnp):
    """Mirror reflection of the primary ray at the hit normal.

    Uses the signed geometric normal re-derived via refine (primary must
    carry 'normal' WITHOUT the abs quirk, or we recover orientation from
    the ray: n_oriented = -sign(d·n) * n)."""
    d = primary["ray_dir"]
    n = primary["normal"]
    s = xp.where(dot(d, n) > 0, -1.0, 1.0)[..., None]
    n = n * s  # oriented against the incoming direction
    return d - 2.0 * dot(d, n)[..., None] * n


def trace_uniform_dda(vertices, faces, grid: DeviceGrid, origins, dirs,
                      active, exclude_face, aabb_min, aabb_max,
                      grid_dims, cfg: RenderConfig, *,
                      max_batches: int = 4, eps: float = 1e-4,
                      chunk_rays: int = 65536, batch: int | None = None,
                      skip_k: int = 6):
    """Trace rays through a uniform grid with 3-D DDA.

    origins/dirs: [N, 3] float32; active: [N] bool; exclude_face: [N]
    int32 face to ignore (self-hit).  Returns dict(t [N], face_id [N]).

    Structure (results identical to a dense lax.scan that runs EVERY
    ray for gx+gy+gz steps x max_batches gathers):
      * rays process in ``chunk_rays`` chunks (lax.map) with a
        lax.while_loop per chunk — a chunk stops as soon as all its
        rays resolved, and pixel-order chunks are spatially coherent so
        their reflection paths finish together (interior scenes:
        median path is a few cells, the scan bound is 3*grid_dim);
      * triangle batches beyond the first run under lax.cond, entered
        only when some live ray's cell actually has > b*B triangles;
      * corner fetch is one row gather from a per-face [F, 9] table
        (v0, e1, e2) instead of the two-level vertices[faces[...]]
        gather;
      * EMPTY-CELL SKIPPING: each step first advances rays through up
        to ``skip_k`` empty cells (a 1-wide cell-count gather + the
        elementwise DDA advance) — interior uniform grids are ~80%
        empty, and without the skip every empty cell costs a full
        triangle-batch sweep;
      * ``batch`` (default cfg.tri_batch) sets the triangle batch
        width — uniform-grid cells average ~10-30 triangles, so 32
        halves the dominant gather volume vs the tracer's 64.
    """
    gx, gy, gz = grid_dims
    lo = jnp.asarray(aabb_min, dtype=jnp.float32)
    hi = jnp.asarray(aabb_max, dtype=jnp.float32)
    dims_f = jnp.asarray([gx, gy, gz], dtype=jnp.float32)
    dims_i = jnp.asarray([gx, gy, gz], dtype=jnp.int32)
    cell_size = (hi - lo) / dims_f
    n = origins.shape[0]

    # Per-face corner table (v0, e1, e2) — one gather per face, reused
    # by every (ray, batch) row gather below.
    fv = vertices[faces]                                  # [F, 3, 3]
    ftab = jnp.concatenate(
        [fv[:, 0], fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]], axis=1)

    B = batch if batch is not None else cfg.tri_batch
    lane = jnp.arange(B, dtype=jnp.int32)
    max_steps = gx + gy + gz

    def chunk_fn(args):
        origins_c, dirs_c, active_c, excl_c = args
        m = origins_c.shape[0]

        # Clip ray entry to the AABB (slab test).
        inv_d = 1.0 / jnp.where(jnp.abs(dirs_c) < 1e-20,
                                jnp.float32(1e-20), dirs_c)
        t1 = (lo[None] - origins_c) * inv_d
        t2 = (hi[None] - origins_c) * inv_d
        t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)
        t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
        t_enter = jnp.maximum(t_near, 0.0) + eps
        inside = (t_far > t_enter) & active_c

        p0 = origins_c + t_enter[:, None] * dirs_c
        cell = jnp.clip(
            ((p0 - lo[None]) / cell_size[None]).astype(jnp.int32),
            0, dims_i[None] - 1)

        step = jnp.where(dirs_c >= 0, 1, -1).astype(jnp.int32)
        next_bound = lo[None] + (cell + (step > 0)).astype(jnp.float32) \
            * cell_size[None]
        t_max = (next_bound - origins_c) * inv_d          # [m, 3]
        t_delta = jnp.abs(cell_size[None] * inv_d)

        def test_cell(cell_idx, alive, best_t, best_f):
            cid = ((cell_idx[:, 0] * gy + cell_idx[:, 1]) * gz
                   + cell_idx[:, 2])
            cid = jnp.clip(cid, 0, gx * gy * gz - 1)
            cnt = jnp.where(alive, grid.cell_count[cid], 0)
            off = grid.cell_offset[cid]

            def batch_body(b, bt, bf):
                base = off + b * B
                idx = jnp.clip(base[:, None] + lane[None, :], 0,
                               grid.sorted_faces.shape[0] - 1)
                fidx = jnp.clip(grid.sorted_faces[idx], 0,
                                faces.shape[0] - 1)
                live = (lane[None, :] + b * B) < cnt[:, None]

                rowsv = ftab[fidx]                    # [m, B, 9]
                v0 = rowsv[..., 0:3]
                e1 = rowsv[..., 3:6]
                e2 = rowsv[..., 6:9]
                tvec = origins_c[:, None, :] - v0
                t = moller_trumbore_t(tvec, e1, e2, dirs_c[:, None, :],
                                      cfg, abs_t=False)[:, 0, :]  # [m, B]
                bad = (~live | (t <= eps)
                       | (fidx == excl_c[:, None]))
                t = jnp.where(bad, _BIG, t)
                k = jnp.argmin(t, axis=-1)
                tmin = jnp.min(t, axis=-1)
                upd = alive & (tmin < bt)
                bt = jnp.where(upd, tmin, bt)
                bf = jnp.where(upd, fidx[jnp.arange(m), k], bf)
                return bt, bf

            # Batch 0 runs whenever the chunk is live at all; deeper
            # batches only when some live cell actually needs them
            # (uniform-grid cells average ~10-30 triangles; deep cells
            # are rare enough that the cond rarely fires).
            bt, bf = batch_body(0, best_t, best_f)
            for b in range(1, max_batches):
                need = jnp.any(alive & (cnt > b * B))
                bt, bf = jax.lax.cond(
                    need,
                    lambda args, b=b: batch_body(b, args[0], args[1]),
                    lambda args: args,
                    (bt, bf))
            overflow_c = jnp.any(cnt > max_batches * B)
            return bt, bf, overflow_c

        def dda_advance(cell_c, t_max_c, alive, move):
            """One DDA step for rays in ``move``; returns new state."""
            axis = jnp.argmin(t_max_c, axis=-1)
            onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
            cell_n = cell_c + onehot * step
            t_max_n = t_max_c + onehot.astype(jnp.float32) * t_delta
            out = ((cell_n < 0) | (cell_n >= dims_i[None])).any(axis=-1)
            cell_n = jnp.clip(cell_n, 0, dims_i[None] - 1)
            cell_c = jnp.where(move[:, None], cell_n, cell_c)
            t_max_c = jnp.where(move[:, None], t_max_n, t_max_c)
            alive = alive & ~(move & out)
            return cell_c, t_max_c, alive

        def cond_fn(carry):
            i, cell_c, t_max_c, alive, best_t, best_f, ovf = carry
            return (i < max_steps) & jnp.any(alive)

        def body_fn(carry):
            i, cell_c, t_max_c, alive, best_t, best_f, ovf = carry

            # Empty-space skipping: advance rays sitting in empty cells
            # (nothing to test there) up to skip_k cells before the
            # triangle sweep.
            def skip_body(_, st):
                cell_s, t_max_s, alive_s = st
                cid = ((cell_s[:, 0] * gy + cell_s[:, 1]) * gz
                       + cell_s[:, 2])
                cid = jnp.clip(cid, 0, gx * gy * gz - 1)
                empty = alive_s & (grid.cell_count[cid] == 0)
                return dda_advance(cell_s, t_max_s, alive_s, empty)

            cell_c, t_max_c, alive = jax.lax.fori_loop(
                0, skip_k, skip_body, (cell_c, t_max_c, alive))

            t_exit = jnp.min(t_max_c, axis=-1)
            bt, bf, o = test_cell(cell_c, alive, best_t, best_f)
            # DDA visits cells in increasing t order, so keeping the
            # min is correct; a ray finishes when its best hit lies
            # before the exit of the current cell.
            done = bt <= t_exit + eps
            alive = alive & ~done
            cell_c, t_max_c, alive = dda_advance(cell_c, t_max_c, alive,
                                                 alive)
            return (i + 1, cell_c, t_max_c, alive, bt, bf, ovf | o)

        init = (jnp.int32(0), cell, t_max, inside,
                jnp.full((m,), _BIG), jnp.full((m,), -2, dtype=jnp.int32),
                jnp.zeros((), dtype=jnp.bool_))
        _, _, _, _, best_t, best_f, ovf = jax.lax.while_loop(
            cond_fn, body_fn, init)
        return best_t, best_f, ovf

    nc = -(-n // chunk_rays)
    pad = nc * chunk_rays - n

    def padn(x, cval=0):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                       constant_values=cval)

    xs = (padn(origins).reshape(nc, chunk_rays, 3),
          padn(dirs).reshape(nc, chunk_rays, 3),
          padn(active, False).reshape(nc, chunk_rays),
          padn(exclude_face).reshape(nc, chunk_rays))
    best_t, best_f, ovf = jax.lax.map(chunk_fn, xs)
    best_t = best_t.reshape(-1)[:n]
    best_f = best_f.reshape(-1)[:n]

    hit = best_t < _BIG
    return dict(t=jnp.where(hit, best_t, jnp.float32(-1.0)),
                face_id=jnp.where(hit, best_f, -2),
                overflow=jnp.any(ovf))


def reflection_pass(vertices, faces, primary_refined, uniform_grid,
                    aabb_min, aabb_max, grid_dims, cfg: RenderConfig,
                    primary_eye, *, max_batches: int = 4,
                    batch: int | None = None):
    """Second-level trace: reflect primary hits, trace the uniform grid.

    Returns per-pixel dict(t, face_id, ray_dir, origin) of the reflection
    hit, shapes [H, W(...)]."""
    H, W = primary_refined["t"].shape
    n = H * W
    t = primary_refined["t"].reshape(n)
    d = primary_refined["ray_dir"].reshape(n, 3)
    hit = primary_refined["face_id"].reshape(n) >= 0

    origins = primary_eye[None] + t[:, None] * d
    rdir = reflect_directions(
        dict(ray_dir=d, normal=primary_refined["normal"].reshape(n, 3)),
        xp=jnp)
    rdir = normalize(rdir, xp=jnp)

    res = trace_uniform_dda(
        vertices, faces, uniform_grid, origins, rdir, hit,
        primary_refined["face_id"].reshape(n), aabb_min, aabb_max,
        grid_dims, cfg, max_batches=max_batches, batch=batch)

    return dict(t=res["t"].reshape(H, W),
                face_id=res["face_id"].reshape(H, W),
                ray_dir=rdir.reshape(H, W, 3),
                origin=origins.reshape(H, W, 3),
                overflow=res["overflow"])
