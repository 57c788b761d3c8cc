"""Gather ops with structured transposes (custom VJPs).

XLA transposes a gather into a scatter-add of every update into the
table — for the refine backward 3.1M pixel-corner cotangents into the
[V, 3] vertex gradient, and 1M pixel rows into the material gradient.
Both have structure XLA can't see:

  * gather_corners — huge update count into a large table: transpose as
    sort-by-index + prefix-sum + boundary differences (data-oblivious
    ops, no atomics).  Summation order is the sorted order,
    deterministic across runs; segment sums computed as prefix
    differences carry a relative error ~eps * sqrt(N_prefix /
    N_segment), negligible against the FD tolerances the grad tests use.
  * gather_rows — tiny table (materials): transpose as a one-hot matmul
    [M, N] @ [N, C], a single contraction over the pixel axis at
    HIGHEST precision (no TF32).

Whether these beat XLA's own scatter-add on a GPU has not been measured
yet (ROADMAP B5).

Forward values are exactly `table[idx]` in both cases; only the
backward implementation changes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


from ugrt.core.ragged import dense_int_bounds as _dense_int_bounds
from ugrt.core.ragged import searchsorted_2level as _searchsorted_2level


@jax.custom_vjp
def gather_corners(vertices, idx):
    """vertices: [V, 3] f32; idx: [..., K] int32 -> [..., K, 3]."""
    return vertices[idx]


def _corners_fwd(vertices, idx):
    return vertices[idx], (idx, vertices.shape[0])


def _corners_bwd(res, g):
    idx, V = res
    flat_idx = idx.reshape(-1)
    gf = g.reshape(-1, 3)
    sidx, gx, gy, gz = jax.lax.sort(
        (flat_idx, gf[:, 0], gf[:, 1], gf[:, 2]), num_keys=1)
    cum = jnp.cumsum(jnp.stack([gx, gy, gz], axis=1), axis=0)
    cpad = jnp.concatenate([jnp.zeros((1, 3), cum.dtype), cum], axis=0)
    bounds = _searchsorted_2level(
        sidx, jnp.arange(V + 1, dtype=sidx.dtype))
    out = cpad[bounds[1:]] - cpad[bounds[:-1]]
    return out, None


gather_corners.defvjp(_corners_fwd, _corners_bwd)


@jax.custom_vjp
def gather_face_data(vertices, faces, aux, fid):
    """gather_face_corners plus non-differentiable per-face AUX columns
    riding the same pixel-width row gather.

    aux: [F, A] f32 (e.g. shading metadata: material id, validity) —
    appended to the [F, 9] corner table so ONE [N, 9+A] gather serves
    both refine and shading.  Returns (corners [..., 3, 3], aux_rows [..., A]).  The
    VJP treats aux as constant (integer-derived metadata).
    """
    tbl = jnp.concatenate(
        [vertices[faces].reshape(faces.shape[0], 9), aux], axis=1)
    rows = tbl[fid]
    return (rows[..., :9].reshape(fid.shape + (3, 3)),
            rows[..., 9:])


def _face_data_fwd(vertices, faces, aux, fid):
    return (gather_face_data(vertices, faces, aux, fid),
            (faces, fid, vertices.shape[0]))


def _face_data_bwd(res, g):
    out = _face_corners_bwd(res, g[0])[0]
    return out, None, None, None


gather_face_data.defvjp(_face_data_fwd, _face_data_bwd)


@jax.custom_vjp
def gather_face_corners(vertices, faces, fid):
    """Two-level corner fetch: vertices[faces[fid]] -> [..., 3, 3].

    fid: [...] int32 winning-face ids, pre-clipped to >= 0 (miss pixels
    carry zero cotangents downstream, so their face-0 rows contribute
    nothing to the backward).

    Forward: one [F, 9] per-face corner table (F ~ 75k rows) + one wide
    row gather at pixel width instead of 3 corner rows per pixel.

    Backward: accumulate pixel cotangents at
    FACE granularity first — sort (fid, pixel) pairs (1M x 2 operands, vs
    the 3.1M x 4-operand corner-index sort this replaces), one wide row
    gather of the 9-wide cotangents through the permutation, prefix-sum +
    CSR-bounds differences -> per-face corner sums [F, 3, 3] — then
    scatter those into vertices with the same sort+prefix trick at 3F
    rows (~225k, trivial).  Summation is deterministic (sorted order);
    prefix-difference error ~eps*sqrt(N_prefix/N_segment) as in
    gather_corners.
    """
    return _face_corners_gather(vertices, faces, fid)


def _face_corners_gather(vertices, faces, fid):
    # [F, 9] table keeps the gathered row contiguous on the lane axis
    # (a [F, 3, 3] gather would fetch 3-wide padded rows three times).
    tbl = vertices[faces].reshape(faces.shape[0], 9)
    return tbl[fid].reshape(fid.shape + (3, 3))


def _face_corners_fwd(vertices, faces, fid):
    return (_face_corners_gather(vertices, faces, fid),
            (faces, fid, vertices.shape[0]))


def _face_corners_bwd(res, g):
    faces, fid, V = res
    F = faces.shape[0]
    flat_fid = fid.reshape(-1)
    n = flat_fid.shape[0]
    gf = g.reshape(n, 9)
    # Sort the 9 cotangent columns along as radix-sort PAYLOADS: the
    # permutation-gather alternative (sort (fid, pix) then gf[spix])
    # emits a transposed-layout [n, 9] gather.
    s = jax.lax.sort((flat_fid,) + tuple(gf[:, j] for j in range(9)),
                     num_keys=1)
    sfid = s[0]
    sg = jnp.stack(s[1:], axis=1)
    cum = jnp.cumsum(sg, axis=0)
    cpad = jnp.concatenate([jnp.zeros((1, 9), cum.dtype), cum], axis=0)
    fb = _dense_int_bounds(sfid, F)
    face_g = (cpad[fb[1:]] - cpad[fb[:-1]]).reshape(F * 3, 3)

    vidx = faces.reshape(-1).astype(jnp.int32)
    svidx, gx, gy, gz = jax.lax.sort(
        (vidx, face_g[:, 0], face_g[:, 1], face_g[:, 2]), num_keys=1)
    cum2 = jnp.cumsum(jnp.stack([gx, gy, gz], axis=1), axis=0)
    c2 = jnp.concatenate([jnp.zeros((1, 3), cum2.dtype), cum2], axis=0)
    vb = _dense_int_bounds(svidx, V)
    out = c2[vb[1:]] - c2[vb[:-1]]
    return out, None, None


gather_face_corners.defvjp(_face_corners_fwd, _face_corners_bwd)


@jax.custom_vjp
def gather_rows(table, idx):
    """table: [M, C] f32 (M small); idx: [...] int32 -> [..., C]."""
    return table[idx]


def _rows_fwd(table, idx):
    return table[idx], (idx, table.shape[0])


def _rows_bwd(res, g):
    idx, M = res
    flat_idx = idx.reshape(-1)
    gf = g.reshape(flat_idx.shape[0], -1)
    onehot = (flat_idx[None, :]
              == jnp.arange(M, dtype=flat_idx.dtype)[:, None]
              ).astype(gf.dtype)
    out = jax.lax.dot_general(
        onehot, gf, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    return out, None


gather_rows.defvjp(_rows_fwd, _rows_bwd)
