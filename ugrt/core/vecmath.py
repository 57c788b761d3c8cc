"""Small float32 vector/matrix helpers shared by the JAX path and the oracle.

All matrices are flat length-16 arrays in OpenGL column-major order
(``m[col*4 + row]``), matching the reference's ``camcoords`` layout
(/root/reference/per_frame_funcs.h:18-43) so every kernel formula carries
over index-for-index.

Works with both numpy and jax.numpy (pass the module as ``xp``).
"""

from __future__ import annotations

import numpy as np


def cross(a, b, xp=np):
    """CROSS macro (/root/reference/main.cu.h:44-47)."""
    return xp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def dot(a, b):
    """DOT macro (/root/reference/main.cu.h:49)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(a, xp=np):
    """NORMALIZE macro (/root/reference/main.cu.h:56): multiply by rsqrt."""
    inv = 1.0 / xp.sqrt(dot(a, a))
    return a * inv[..., None]


def magnitude(a, xp=np):
    """getMagnitude (/root/reference/grid_kernel.cu:354-363)."""
    return xp.sqrt(dot(a, a))


def matvec(mat_flat, vec4, xp=np):
    """Column-major 4x4 times vec4.

    Matches mulMatrixVector_D (/root/reference/grid_kernel.cu:4-11):
    ``result[r] = sum_c mat[c*4+r] * vec[c]``.
    Supports batched ``vec4`` of shape [..., 4]; ``mat_flat`` is [16].
    Written as broadcast multiply-adds, NOT ``vec4 @ m``: a float32 dot
    may run at reduced precision (TF32 on a GPU's tensor cores) and sums
    in an order of the library's choosing.  Summation order matches the
    reference's r-loop (c ascending).
    """
    m = xp.reshape(mat_flat, (4, 4))  # m[c, r]
    return (vec4[..., 0:1] * m[0] + vec4[..., 1:2] * m[1]
            + vec4[..., 2:3] * m[2] + vec4[..., 3:4] * m[3])


def transform_point(mat_flat, p3, xp=np):
    """Transform [...,3] points by a column-major flat matrix, w-divide.

    The homogeneous w = 1 coordinate is folded in as ``+ m[3]`` instead
    of concatenating a ones column (same f32 values: 1.0 * m[3] is
    exact)."""
    m = xp.reshape(mat_flat, (4, 4))  # m[c, r]
    out = (p3[..., 0:1] * m[0] + p3[..., 1:2] * m[1]
           + p3[..., 2:3] * m[2] + m[3])
    return out[..., :3] / out[..., 3:4]


def rotate_basis(mv_flat, v3, xp=np):
    """Apply only the 3x3 rotation block of a modelview matrix.

    Matches the shader's view-space transforms which drop the translation
    column (/root/reference/shader_kernel.cu:54-66): out[r] = sum_c mv[c*4+r]*v[c].
    Broadcast multiply-adds in the reference's order (c ascending), like
    matvec, not a float32 dot that could run in TF32.
    """
    m = xp.reshape(mv_flat, (4, 4))[:3, :3]  # m[c, r]
    return v3[..., 0:1] * m[0] + v3[..., 1:2] * m[1] + v3[..., 2:3] * m[2]
