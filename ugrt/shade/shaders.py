"""Shading: Lambert, spotlight, shadow-darkening, Perlin debug shader.

Backend-agnostic (numpy / jax.numpy via ``xp``) re-derivation of
/root/reference/shader_kernel.cu.  The device path calls these with jnp
inside jit (XLA fuses the whole shade into the surrounding graph); the CPU
oracle calls them with numpy.

Reference semantics notes:
* View-space transforms use only the 3x3 rotation of whatever modelview is
  in constant memory at shade time — in the reference frame loop that is
  the LAST LIGHT's camera (fillCoordinatesData is last called inside the
  light loop, main.cu:170, and shading runs after it, main.cu:205-219).
* Ambient light 0.5, diffuse light 1.0 (shader_kernel.cu:49-50).
* Ka aliases Kd (material slots 3..5 used for both, shader_kernel.cu:180-186)
  — quirk flag ka_from_kd.
* Diffuse uses |N·L| (shader_kernel.cu:79) — quirk flag abs_n_dot_l.
* Miss pixels (face_id < 0) shade black; the reference actually indexes
  mat_idx[-2] (undefined); we define idx=-1 ⇒ black, matching its
  observable "black on miss" behavior.
* add_shadows divides shadowed pixels' u8 RGB by 3 (shader_kernel.cu:347-359).
"""

from __future__ import annotations

import numpy as np

from ugrt.config import RenderConfig
from ugrt.core.vecmath import dot, normalize, rotate_basis
from ugrt.grid import binning


def face_shade_meta(mat_index, num_materials: int, xp=np):
    """[F, 2] f32 per-face shading metadata: (material id, validity) —
    ids < 2^24 are exact in f32.  Pass through refine_primary's
    face_aux so shading reuses the refine row gather (see shade_core).
    """
    f32 = xp.float32
    return xp.stack(
        [mat_index.astype(f32),
         ((mat_index >= 0) & (mat_index < num_materials)).astype(f32)],
        axis=1)


def shade_core(primary, shade_camcoords, light_position, primary_eye,
               mat_index, materials, cfg: RenderConfig, drop_off, xp=np):
    """lambert_color_pixel / lambert_color_drop_off_pixel
    (shader_kernel.cu:46-128) + the material fetch and clamping of
    lambertian_shade (shader_kernel.cu:165-221).

    Returns float32 RGB in [0,1] (quantization to u8 is separate so the
    differentiable path can stay in float).
    """
    f32 = xp.float32
    mv = shade_camcoords[16:32]
    num_materials = materials.shape[0]

    tri = primary["face_id"]
    if xp is not np:
        from ugrt.diff.fastgrad import gather_rows

        # Fetch the per-pixel material id + validity as ONE f32 row
        # gather from a per-face table (ids < 2^24, exact in f32).  When
        # the refine pass already carried the meta through its corner
        # gather (primary["aux"], see refine_primary /
        # gather_face_data), reuse it instead of gathering again.
        if "aux" in primary:
            rows = primary["aux"]                        # [..., 2]
        else:
            face_meta = face_shade_meta(mat_index, num_materials, xp)
            rows = face_meta[xp.maximum(tri, 0)]         # [..., 2]
        idx = rows[..., 0].astype(xp.int32)
        valid = (tri >= 0) & (rows[..., 1] > 0)
        # gather_rows' custom VJP turns the material-gradient scatter
        # into a one-hot contraction at HIGHEST precision.
        mats = gather_rows(materials,
                           xp.clip(idx, 0, num_materials - 1))
    else:
        idx = xp.where(tri >= 0, mat_index[xp.maximum(tri, 0)], -1)
        valid = (idx >= 0) & (idx < num_materials)
        mats = materials[xp.maximum(idx, 0)]
    ka = mats[..., 3:6] if cfg.quirks.ka_from_kd else mats[..., 0:3]
    kd = mats[..., 3:6]

    t = primary["t"][..., None]
    point = primary_eye[None, None] + t * primary["ray_dir"]

    light_view = rotate_basis(mv, xp.asarray(light_position, dtype=f32),
                              xp=xp)
    point_view = rotate_basis(mv, point.astype(f32), xp=xp)
    normal_view = normalize(
        rotate_basis(mv, primary["normal"].astype(f32), xp=xp), xp=xp)

    light_dir = normalize(point_view - light_view[None, None], xp=xp)

    ndotl = dot(light_dir, normal_view)
    if cfg.quirks.abs_n_dot_l:
        ndotl = xp.abs(ndotl)
    diffuse = xp.where(ndotl > 0, ndotl, f32(0.0))[..., None]

    ambient = f32(0.5)
    color = ka * ambient * drop_off + kd * diffuse * drop_off
    color = xp.clip(color, None, f32(1.0))
    return xp.where(valid[..., None] & (primary["t"][..., None] > 0),
                    color, f32(0.0))


def lambert(primary, shade_camcoords, light_position, primary_eye,
            mat_index, materials, cfg: RenderConfig, xp=np):
    """lambertian_shade (shader_kernel.cu:165-221), float RGB."""
    return shade_core(primary, shade_camcoords, light_position, primary_eye,
                      mat_index, materials, cfg, xp.float32(1.0), xp=xp)


def spotlight(primary, shade_camcoords, light_position, primary_eye,
              mat_index, materials, cfg: RenderConfig, xp=np):
    """spot_shade (shader_kernel.cu:275-345), float RGB.

    Drop-off 1.0 within ±π/4 of the shade camera's forward axis (signed
    angles from get_along_x / get_along_y — y carries the `*` typo), else
    0.25 (shader_kernel.cu:300-303).  The spot apex is the shade-time
    camcoords eye — the light camera eye, not dd_light_position.
    """
    f32 = xp.float32
    spot_eye = shade_camcoords[0:3]
    t = primary["t"][..., None]
    pts = (primary_eye[None, None] + t * primary["ray_dir"]).astype(f32)
    d = normalize(pts - spot_eye[None, None], xp=xp)

    x = binning.x_angle(d, shade_camcoords, xp=xp)
    y = binning.y_angle(d, shade_camcoords, cfg.quirks.y_forward_dot_typo,
                        xp=xp)
    right, up, _fwd = binning.mv_basis(shade_camcoords)
    xs = xp.where(dot(d, right[None, None]) > 0, x, -x)
    ys = xp.where(dot(d, up[None, None]) > 0, y, -y)

    q = f32(np.pi / 4)
    inside = (xs < q) & (xs > -q) & (ys < q) & (ys > -q)
    drop = xp.where(inside, f32(1.0), f32(0.25))[..., None]
    return shade_core(primary, shade_camcoords, light_position, primary_eye,
                      mat_index, materials, cfg, drop, xp=xp)


def to_u8(color_f32, xp=np):
    """color * 255 truncated to u8 (shader_kernel.cu:218-220)."""
    return (color_f32 * xp.float32(255.0)).astype(xp.uint8)


def add_shadows_u8(image_u8, shadowed, xp=np):
    """shadow_kernel: u8 integer divide by 3 (shader_kernel.cu:347-359)."""
    return xp.where(shadowed[..., None] == 1, image_u8 // 3, image_u8)


def add_shadows_f32(color_f32, shadowed, xp=np):
    """Differentiable shadow darkening: float /3 instead of u8 //3.

    Used by the gradient path where u8 quantization would kill gradients;
    equal to the reference up to quantization.
    """
    return xp.where(shadowed[..., None] == 1,
                    color_f32 / xp.float32(3.0), color_f32)


# ---------------------------------------------------------------------------
# Perlin value-noise debug shader (perlin_noise_shade + get_material,
# shader_kernel.cu:4-44, :130-163, :505-547).

def _noise_int(x, xp):
    """Noise(int) hash (shader_kernel.cu:14-18), int32 wraparound."""
    x = x.astype(xp.int32) if hasattr(x, "astype") else np.int32(x)
    x = (x << 13) ^ x
    h = (x * (x * x * np.int32(15731) + np.int32(789221))
         + np.int32(1376312589)) & np.int32(0x7FFFFFFF)
    return h.astype(xp.float32) / xp.float32(2147483648.0)


def _interp(a, b, c):
    """InterPolation (shader_kernel.cu:4-7): smoothstep blend."""
    return a + (b - a) * c * c * (3 - 2 * c)


def perlin_noise(x, y, width: int, seed: int, periode, xp=np):
    """PerlinNoise single octave (shader_kernel.cu:20-44)."""
    f32 = xp.float32
    freq = f32(1.0) / f32(periode)
    num = (f32(width) * freq).astype(xp.int32)
    step_x = (x * freq).astype(xp.int32)
    step_y = (y * freq).astype(xp.int32)
    zone_x = x * freq - step_x.astype(f32)
    zone_y = y * freq - step_y.astype(f32)
    box = step_x + step_y * num
    nd = box + np.int32(seed)
    a = _interp(_noise_int(nd, xp), _noise_int(nd + 1, xp), zone_x)
    b = _interp(_noise_int(nd + num, xp), _noise_int(nd + 1 + num, xp),
                zone_x)
    return _interp(a, b, zone_y) * f32(324.0)


def perlin_shade(face_id, width_px: int, height_px: int, cfg: RenderConfig,
                 xp=np):
    """perlin_noise_shade (shader_kernel.cu:505-547): screen-space octave
    stack, black on miss.  Returns u8 RGB.

    Channel math (shader_kernel.cu:528-530 with InterLinear(a,b,c) =
    a*(1-c)+b*c, :9-12): r = InterLinear(tmp,0,0) = tmp,
    g = InterLinear(0,tmp,0) = 0, b = InterLinear(0,0,tmp) = 0 — the
    reference's debug shader is red-channel-only, despite appearances."""
    f32 = xp.float32
    xi = xp.arange(width_px, dtype=f32)[None, :]
    yi = xp.arange(height_px, dtype=f32)[:, None]
    x = xp.broadcast_to(xi, (height_px, width_px))
    y = xp.broadcast_to(yi, (height_px, width_px))

    seed, width = 63, 12413
    vals = [perlin_noise(x, y, width, seed, p, xp=xp)
            for p in (100, 25, 12.5, 6.25, 3.125, 1.56)]
    scales = [1.0, 0.25, 0.125, 0.0625, 0.03125, 0.0156]
    tmp = sum((v * f32(s)).astype(xp.int32).astype(f32)
              for v, s in zip(vals, scales))

    # InterLinear(a,b,c) = a*(1-c)+b*c; r=(tmp,0,0), g=(0,tmp,0), b=(0,0,tmp)
    r = xp.clip(tmp, 0, 255).astype(xp.int32)
    g = xp.zeros_like(r)
    b = xp.zeros_like(r)
    rgb = xp.stack([r, g, b], axis=-1).astype(xp.uint8)
    hit = (face_id >= 0)[..., None]
    return xp.where(hit, rgb, xp.zeros_like(rgb))
