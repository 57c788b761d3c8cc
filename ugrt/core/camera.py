"""Pinhole camera with OpenGL-faithful matrix math.

The reference delegates its matrix math to OpenGL (`gluPerspective` +
`gluLookAt`, /root/reference/camera.h:135-148) and reads the matrices back
with `glGetFloatv` (camera.h:86-89).  There is no GL here, so this module
reproduces those matrices bit-faithfully in float32, plus the reference's
MVP product (camera.h:150-165), Gribb–Hartmann frustum plane extraction
(camera.h:167-216) and 3-plane corner intersection (camera.h:218-253).

All matrices are flat [16] float32 in GL column-major order so that the
packed `camcoords[64]` vector (/root/reference/per_frame_funcs.h:18-43)
has the identical layout the CUDA kernels index into.

camcoords layout:
    [0:4]    eye (homogeneous, w=1)          per_frame_funcs.h:20-23
    [4:16]   near frustum corners 0..3 (xyz) per_frame_funcs.h:25-30
    [16:32]  modelview matrix                per_frame_funcs.h:32-33
    [32:48]  projection matrix               per_frame_funcs.h:34-35
    [48:64]  mvp matrix                      per_frame_funcs.h:36-37
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ugrt.core.vecmath import cross, dot, normalize


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Host-side camera definition (mirrors Camera state, camera.h:18-23)."""

    eye: tuple[float, float, float]
    look_at: tuple[float, float, float]
    up: tuple[float, float, float]
    near: float = 0.1
    far: float = 100.0


def perspective_matrix(fovy_deg: float, aspect: float, near: float, far: float,
                       xp=np):
    """gluPerspective, column-major flat float32."""
    f = 1.0 / math.tan(math.radians(fovy_deg) / 2.0)
    m = np.zeros(16, dtype=np.float32)
    m[0] = np.float32(f / aspect)
    m[5] = np.float32(f)
    m[10] = np.float32((far + near) / (near - far))
    m[11] = np.float32(-1.0)
    m[14] = np.float32(2.0 * far * near / (near - far))
    return xp.asarray(m)


def look_at_matrix(eye, center, up, xp=np):
    """gluLookAt, column-major flat float32 (Mesa convention)."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)

    f = normalize(center - eye)
    s = normalize(cross(f, normalize(up)))
    u = cross(s, f)

    m = np.zeros(16, dtype=np.float32)
    # Rotation rows s, u, -f in column-major storage.
    m[0], m[4], m[8] = s
    m[1], m[5], m[9] = u
    m[2], m[6], m[10] = -f
    # Translation: R @ (-eye).
    m[12] = np.float32(-dot(s, eye))
    m[13] = np.float32(-dot(u, eye))
    m[14] = np.float32(dot(f, eye))
    m[15] = np.float32(1.0)
    return xp.asarray(m)


def mvp_matrix(mv_flat, p_flat, xp=np):
    """The reference's MVP product (camera.h:150-165).

    mvp[i*4+k] = sum_j mv[i*4+j] * p[j*4+k] over the flat arrays, which for
    column-major storage yields the column-major flat of P @ MV — i.e. the
    true clip transform.
    """
    mv = xp.reshape(mv_flat, (4, 4))
    p = xp.reshape(p_flat, (4, 4))
    return xp.reshape(mv @ p, (16,))


def frustum_planes(mvp_flat, xp=np):
    """Plane extraction (camera.h:167-216). Returns [6,4] normalized planes.

    Order: left, right, bottom, top, near, far — using the reference's own
    (sign-flipped) labels; only the corner pairing below depends on it.
    """
    m = mvp_flat
    rows = xp.stack(
        [
            xp.stack([m[3] - m[0], m[7] - m[4], m[11] - m[8], m[15] - m[12]]),
            xp.stack([m[3] + m[0], m[7] + m[4], m[11] + m[8], m[15] + m[12]]),
            xp.stack([m[3] + m[1], m[7] + m[5], m[11] + m[9], m[15] + m[13]]),
            xp.stack([m[3] - m[1], m[7] - m[5], m[11] - m[9], m[15] - m[13]]),
            xp.stack([m[3] + m[2], m[7] + m[6], m[11] + m[10], m[15] + m[14]]),
            xp.stack([m[3] - m[2], m[7] - m[6], m[11] - m[10], m[15] - m[14]]),
        ]
    )
    norm = xp.sqrt(rows[:, 0] ** 2 + rows[:, 1] ** 2 + rows[:, 2] ** 2)
    return rows / norm[:, None]


def _intersect_3_planes(n1, n2, n3, xp=np):
    """Intersect3Planes (camera.h:218-239)."""
    n1n2 = cross(n1[:3], n2[:3], xp=xp)
    n2n3 = cross(n2[:3], n3[:3], xp=xp)
    n3n1 = cross(n3[:3], n1[:3], xp=xp)
    den = dot(n1[:3], n2n3)
    return -(n1[3] * n2n3 + n2[3] * n3n1 + n3[3] * n1n2) / den


def frustum_corners(planes, xp=np):
    """Frustum corners 0..7 (camera.h:241-253). [8,3].

    0..3 are the near-plane corners used for ray generation:
    NBL, NBR, NTR, NTL (camera.h:123-133).
    """
    pairs = [
        (0, 2, 4), (1, 2, 4), (1, 3, 4), (0, 3, 4),
        (0, 2, 5), (1, 2, 5), (1, 3, 5), (0, 3, 5),
    ]
    return xp.stack(
        [_intersect_3_planes(planes[a], planes[b], planes[c], xp=xp)
         for a, b, c in pairs]
    )


def camcoords_from_spec(spec: CameraSpec, fovy_deg: float, aspect: float,
                        xp=np):
    """Build the packed camcoords[64] vector for a camera spec."""
    mv = look_at_matrix(spec.eye, spec.look_at, spec.up, xp=xp)
    p = perspective_matrix(fovy_deg, aspect, spec.near, spec.far, xp=xp)
    mvp = mvp_matrix(mv, p, xp=xp)
    planes = frustum_planes(mvp, xp=xp)
    corners = frustum_corners(planes, xp=xp)

    eye = xp.asarray(np.asarray(spec.eye, dtype=np.float32))
    cc = xp.concatenate(
        [
            eye,
            xp.asarray(np.ones(1, dtype=np.float32)),
            xp.reshape(corners[:4], (12,)),
            mv,
            p,
            mvp,
        ]
    )
    return cc.astype(np.float32)


def primary_ray_dirs(camcoords, width: int, height: int, xp=np):
    """Per-pixel primary ray directions, [H, W, 3] float32 (normalized).

    Derivation: the reference samples a 5x5 bilinear texture of near-plane
    lattice points at ftx in [0.1, 0.9] (trace_kernel.cu:96-113).  The 5x5
    lattice is itself exactly bilinear in the four near corners
    (per_frame_funcs.h:161-434), and the [0.1, 0.9] remap cancels the
    half-texel offset of normalized texture coordinates:
        texel = ftx*5 - 0.5, ftx = 0.1 + 0.8*fx  ⇒  lattice param = fx.
    So the sampled point is bilerp(corners, x=1-col/W, y=row/H) and the
    direction is that point minus the eye (trace_kernel.cu:105-114),
    normalized.
    """
    eye = camcoords[0:3]
    c0 = camcoords[4:7]    # near-bottom-left
    c1 = camcoords[7:10]   # near-bottom-right
    c2 = camcoords[10:13]  # near-top-right
    c3 = camcoords[13:16]  # near-top-left

    col = xp.arange(width, dtype=xp.float32)
    row = xp.arange(height, dtype=xp.float32)
    fx = (1.0 - col / np.float32(width))[None, :, None]   # x-flip, trace_kernel.cu:99
    fy = (row / np.float32(height))[:, None, None]

    bottom = c0[None, None, :] + fx * (c1 - c0)[None, None, :]
    top = c3[None, None, :] + fx * (c2 - c3)[None, None, :]
    pt = bottom + fy * (top - bottom)

    d = pt - eye[None, None, :]
    return normalize(d, xp=xp)
