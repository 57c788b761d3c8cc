"""CPU oracle: a NumPy re-implementation of the reference's exact per-frame
semantics (SURVEY.md §3), used as the allclose target for every stage of the
device path and for finite-difference gradient checks.

Unlike the device path (sort/searchsorted/segment-min machinery), the oracle
builds its CSR grid with naive per-face Python loops and traces per cell —
a genuinely independent algorithm over the same math, so agreement
cross-validates the vectorized implementation.

Stage map (reference call stack, SURVEY.md §3.2):
    build_grid            — FrustumGrid::buildGrid       (frustum_grid.h:210-366)
    build_spherical_grid  — FrustumGrid::buildSphericalGrid (frustum_grid.h:368-532)
    trace_primary         — rckernel_alpha               (trace_kernel.cu:84-270)
    light_cell_of_rays    — mapSort_Effective_kernel     (misc_kernel.cu:255-296)
    trace_shadow          — processData + mod_light_rckernel (light_kernel.cu:52-270)
    shade_lambert/spot    — lambertian_shade / spot_shade (shader_kernel.cu:165-345)
    add_shadows           — shadow_kernel                (shader_kernel.cu:347-359)
    render_frame          — display()                    (main.cu:59-302)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.core.vecmath import cross, dot, normalize, transform_point
from ugrt.grid import binning


@dataclasses.dataclass
class OracleGrid:
    """CSR grid: span/offset per cell + sorted face list.

    Mirrors FrustumGrid outputs d_span, d_offset, d_triangle_value_list
    (frustum_grid.h:21-29).
    """

    cell_count: np.ndarray    # [num_cells] int32
    cell_offset: np.ndarray   # [num_cells] int32 (exclusive scan)
    sorted_faces: np.ndarray  # [total] int32
    total_pairs: int


def _csr_from_ranges(ranges, gz, cfg: RenderConfig) -> OracleGrid:
    """DSFillkernel scatter + stable sort + histogram, done naively.

    Pair keys follow grid_kernel.cu:322:
        key = ((gx + i) * grid_y + (gy + j)) * num_slabs + gz
    with i-major / j-minor enumeration, faces in ascending order, and a
    stable sort by key (CUDPP radix sort is stable, so ties keep face
    order).
    """
    keys = []
    vals = []
    gxmin = ranges["gxmin"]
    gxmax = ranges["gxmax"]
    gymin = ranges["gymin"]
    gymax = ranges["gymax"]
    for f in range(len(gxmin)):
        z = int(gz[f])
        for i in range(int(gxmin[f]), int(gxmax[f]) + 1):
            for j in range(int(gymin[f]), int(gymax[f]) + 1):
                keys.append((i * cfg.grid_y + j) * cfg.num_slabs + z)
                vals.append(f)
    keys = np.asarray(keys, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.int32)

    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    vals = vals[order]

    num_cells = cfg.num_cells
    cell_count = np.bincount(keys, minlength=num_cells).astype(np.int32)
    cell_offset = (np.cumsum(cell_count) - cell_count).astype(np.int32)
    return OracleGrid(cell_count, cell_offset, vals, len(vals))


def build_grid(scene, camcoords, cfg: RenderConfig) -> OracleGrid:
    """Perspective grid (frustum_grid.h:210-366)."""
    r = binning.perspective_face_ranges(
        scene.vertices, scene.faces, camcoords, cfg.grid_x, cfg.grid_y,
        cfg.num_slabs, xp=np)
    z_lo, z_hi = binning.z_minmax(r["zmin"])
    gz = binning.slab_bins(r["zmin"], z_lo, z_hi, cfg.num_slabs)
    return _csr_from_ranges(r, gz, cfg)


def build_spherical_grid(scene, camcoords, cfg: RenderConfig,
                         x_max=None, y_max=None) -> OracleGrid:
    """Spherical light grid (frustum_grid.h:368-532); extent is overridden
    to pi by the caller in the reference (main.cu:186-187)."""
    x_max = cfg.angular_extent if x_max is None else x_max
    y_max = cfg.angular_extent if y_max is None else y_max
    r = binning.spherical_face_ranges(
        scene.vertices, scene.faces, camcoords, cfg.grid_x, cfg.grid_y,
        cfg.num_slabs, x_max, y_max, cfg.quirks.y_forward_dot_typo, xp=np)
    z_lo, z_hi = binning.z_minmax(r["zmin"])
    gz = binning.slab_bins(r["zmin"], z_lo, z_hi, cfg.num_slabs)
    return _csr_from_ranges(r, gz, cfg)


def _intersect_mt(tvec, e1, e2, dirs, cfg, abs_t: bool):
    """Möller–Trumbore over [R,3] rays x [K,3] triangles -> t [R,K].

    intersectTriUV (trace_kernel.cu:4-45): returns 0 for rejects; |t| when
    ``abs_t`` (the reference's ``t<0 ? t*=-1`` quirk at :35); also returns
    (u, v).
    """
    f32 = np.float32
    dirs = dirs.astype(f32)
    pvec = cross(dirs[:, None, :], e2[None, :, :])           # [R,K,3]
    det = dot(e1[None], pvec)                                # [R,K]
    bad_det = np.abs(det) < f32(cfg.epsilon)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = f32(1.0) / det
        u = dot(tvec[None], pvec) * inv_det
        qvec = cross(tvec[None, :, :], e1[None, :, :])
        v = dot(dirs[:, None, :], qvec) * inv_det
        t = dot(e2[None], qvec) * inv_det
    if abs_t:
        t = np.abs(t)
    reject = bad_det | (u < 0) | (u > 1) | (v < 0) | (u + v > 1)
    t = np.where(reject, f32(0.0), t)
    return t, u, v


def trace_primary(scene, camcoords, grid: OracleGrid, cfg: RenderConfig):
    """rckernel_alpha (trace_kernel.cu:84-270), per grid cell (=8x8 tile).

    Returns dict of per-pixel [H, W] arrays: t (miss -1), normal [H,W,3]
    (abs-normal quirk; miss -1), face_id (miss -2), ray_dir [H,W,3].
    """
    H, W = cfg.screen_height, cfg.screen_width
    f32 = np.float32
    eye = camcoords[0:3]
    mvp = camcoords[48:64]

    dirs = cam.primary_ray_dirs(camcoords, W, H, xp=np)      # [H, W, 3]

    t_img = np.full((H, W), f32(-1.0))
    id_img = np.full((H, W), -2, dtype=np.int32)
    n_img = np.full((H, W, 3), f32(-1.0))

    verts = scene.vertices
    faces = scene.faces
    tiles_x = W // cfg.tile_x
    tiles_y = H // cfg.tile_y

    for bx in range(tiles_x):
        for by in range(tiles_y):
            rows = slice(by * cfg.tile_y, (by + 1) * cfg.tile_y)
            cols = slice(bx * cfg.tile_x, (bx + 1) * cfg.tile_x)
            ray_d = dirs[rows, cols].reshape(-1, 3)          # [64, 3]

            oldt = np.full(ray_d.shape[0], f32(99999999.9))
            win = np.full(ray_d.shape[0], -1, dtype=np.int64)
            done = np.zeros(ray_d.shape[0], dtype=np.int32)  # rayDone

            for slab in range(cfg.num_slabs):
                cell = (bx * tiles_y + by) * cfg.num_slabs + slab
                cnt = int(grid.cell_count[cell])
                off = int(grid.cell_offset[cell])
                active = done != 2
                if cnt > 0 and active.any():
                    fidx = grid.sorted_faces[off:off + cnt]
                    v = verts[faces[fidx]].astype(f32)       # [K, 3, 3]
                    v0 = v[:, 0]
                    e1 = v[:, 1] - v0
                    e2 = v[:, 2] - v0
                    tvec = eye[None] - v0
                    t, _, _ = _intersect_mt(tvec, e1, e2, ray_d, cfg,
                                            cfg.quirks.abs_t)
                    # Sequential accept (t>0 and t<oldt) == min with
                    # earliest-index tie-break (strict <).
                    t = np.where(t > 0, t, f32(np.inf))
                    t = np.where(t < oldt[:, None], t, f32(np.inf))
                    any_hit = np.isfinite(t).any(axis=1)
                    k = np.argmin(t, axis=1)
                    tmin = t[np.arange(t.shape[0]), k]
                    upd = active & any_hit
                    oldt = np.where(upd, tmin, oldt)
                    win = np.where(upd, off + k, win)
                    done = np.where(upd, 1, done)

                # isWithin (trace_kernel.cu:56-82): reproject by MVP.
                hit1 = done == 1
                if hit1.any():
                    pt = eye[None] + oldt[:, None] * ray_d
                    ndc = transform_point(mvp, pt.astype(f32), xp=np)
                    zbin = np.floor(ndc[:, 2] * cfg.num_slabs)
                    done = np.where(hit1 & (zbin == slab), 2, done)

            ok = done == 2
            widx = grid.sorted_faces[np.where(win >= 0, win, 0)]
            v = verts[faces[widx]].astype(f32)
            e1 = normalize(v[:, 1] - v[:, 0])
            e2 = normalize(v[:, 2] - v[:, 0])
            nrm = normalize(cross(e1, e2))
            if cfg.quirks.abs_normal:
                nrm = np.abs(nrm)

            sh = (cfg.tile_y, cfg.tile_x)
            t_img[rows, cols] = np.where(ok, oldt, f32(-1.0)).reshape(sh)
            id_img[rows, cols] = np.where(ok, widx, -2).reshape(sh)
            n_img[rows, cols] = np.where(ok[:, None], nrm,
                                         f32(-1.0)).reshape(sh + (3,))

    return dict(t=t_img, face_id=id_img, normal=n_img, ray_dir=dirs)


def light_cell_of_rays(primary, primary_eye, light_camcoords,
                       cfg: RenderConfig):
    """mapSort_Effective_kernel (misc_kernel.cu:255-296): per-pixel light
    grid cell of the shadow ray, sentinel grid_x*grid_y when outside."""
    pts = (primary_eye[None, None]
           + primary["t"][..., None] * primary["ray_dir"])
    return binning.ray_light_cells(
        pts.astype(np.float32), light_camcoords, cfg.grid_x, cfg.grid_y,
        cfg.angular_extent, cfg.angular_extent,
        cfg.quirks.y_forward_dot_typo, xp=np)


def trace_shadow(scene, light_camcoords, light_grid: OracleGrid, primary,
                 primary_eye, cfg: RenderConfig):
    """Shadow occlusion (mod_light_rckernel, light_kernel.cu:52-270).

    For every pixel (hits AND misses — the reference reorders all rays):
    shadow ray from the light-camera eye to the primary 'hit point'
    (eye + t*dir, garbage for misses, faithfully included); test the
    triangles of the ray's light-grid cell with intersectTri, which
    accepts any t < 999999.9 including negatives (light_kernel.cu:43-47);
    shadowed when dist(light, occluder) + 1e-3 < dist(light, point)
    (isSmaller, light_kernel.cu:1-11).

    Sentinel-cell rays are skipped (the reference indexes its span array
    out of bounds for these — undefined; we define them unshadowed).
    """
    H, W = cfg.screen_height, cfg.screen_width
    f32 = np.float32
    L = light_camcoords[0:3]

    cells = light_cell_of_rays(primary, primary_eye, light_camcoords, cfg)
    pts = (primary_eye[None, None]
           + primary["t"][..., None] * primary["ray_dir"]).astype(f32)

    shadowed = np.zeros((H, W), dtype=np.int32)
    verts = scene.vertices
    faces = scene.faces

    flat_cells = cells.reshape(-1)
    flat_pts = pts.reshape(-1, 3)
    for cell in np.unique(flat_cells):
        if cell >= cfg.cell_sentinel:
            continue
        for slab in range(cfg.num_slabs):
            c = cell * cfg.num_slabs + slab
            cnt = int(light_grid.cell_count[c])
            if cnt == 0:
                continue
            off = int(light_grid.cell_offset[c])
            sel = np.where(flat_cells == cell)[0]
            p = flat_pts[sel]
            d = normalize(p - L[None]).astype(f32)

            fidx = light_grid.sorted_faces[off:off + cnt]
            v = verts[faces[fidx]].astype(f32)
            v0 = v[:, 0]
            e1 = v[:, 1] - v0
            e2 = v[:, 2] - v0
            tvec = L[None] - v0
            t, _, _ = _intersect_mt(tvec, e1, e2, d, cfg, abs_t=False)
            hit = (t != 0) & (t < f32(999999.9))
            occ = L[None, None, :] + t[..., None] * d[:, None, :]
            dist_occ = np.sqrt(dot(occ - L[None, None], occ - L[None, None]))
            dist_pt = np.sqrt(dot(p - L[None], p - L[None]))
            small = dist_occ + f32(cfg.shadow_epsilon) < dist_pt[:, None]
            any_sh = (hit & small).any(axis=1)
            idx = sel[any_sh]
            shadowed.reshape(-1)[idx] = 1
    return shadowed


def shade_lambert(primary, shade_camcoords, light_position, primary_eye,
                  scene, cfg: RenderConfig):
    """lambertian_shade (shader_kernel.cu:165-221), u8 RGB."""
    from ugrt.shade import shaders

    c = shaders.lambert(primary, shade_camcoords, light_position,
                        primary_eye, scene.mat_index, scene.materials, cfg,
                        xp=np)
    return shaders.to_u8(c, xp=np)


def shade_spot(primary, shade_camcoords, light_position, primary_eye,
               scene, cfg: RenderConfig):
    """spot_shade (shader_kernel.cu:275-345), u8 RGB."""
    from ugrt.shade import shaders

    c = shaders.spotlight(primary, shade_camcoords, light_position,
                          primary_eye, scene.mat_index, scene.materials,
                          cfg, xp=np)
    return shaders.to_u8(c, xp=np)


def add_shadows(image_u8, shadowed):
    """shadow_kernel (shader_kernel.cu:347-359): u8 integer divide by 3."""
    from ugrt.shade import shaders

    return shaders.add_shadows_u8(image_u8, shadowed, xp=np)


def render_frame(scene, camera_spec: cam.CameraSpec,
                 light_specs, light_position, cfg: RenderConfig,
                 use_spot: bool = True):
    """Full display() pipeline (main.cu:59-302) for one frame.

    light_specs: list of CameraSpec for the per-light shadow cameras
    (main.cu:158-164).  Shading uses the LAST light's camcoords, matching
    the reference's constant-memory state machine.
    """
    aspect = cfg.screen_width / cfg.screen_height
    cc = cam.camcoords_from_spec(camera_spec, cfg.fovy_deg, aspect)
    primary_eye = np.asarray(camera_spec.eye, dtype=np.float32)

    grid = build_grid(scene, cc, cfg)
    primary = trace_primary(scene, cc, grid, cfg)

    shadowed = np.zeros((cfg.screen_height, cfg.screen_width),
                        dtype=np.int32)
    shade_cc = cc
    for lspec in light_specs:
        lcc = cam.camcoords_from_spec(lspec, cfg.fovy_deg, aspect)
        lgrid = build_spherical_grid(scene, lcc, cfg)
        sh = trace_shadow(scene, lcc, lgrid, primary, primary_eye, cfg)
        shadowed = np.maximum(shadowed, sh)
        shade_cc = lcc

    if use_spot:
        img = shade_spot(primary, shade_cc, light_position, primary_eye,
                         scene, cfg)
    else:
        img = shade_lambert(primary, shade_cc, light_position, primary_eye,
                            scene, cfg)
    img = add_shadows(img, shadowed)
    return dict(image=img, primary=primary, shadowed=shadowed)
