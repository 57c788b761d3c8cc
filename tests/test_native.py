"""Native library tests (the library is built at first use)."""

import numpy as np

from ugrt.scene import native


def test_native_library_builds():
    assert native.available(), "make -C native failed"


def test_native_obj_matches_python(tmp_path):
    obj = tmp_path / "s.obj"
    obj.write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "usemtl red\nf 1 2 3\n"
        "usemtl blue\nf 1/1 2/1 3/1 4/1\n"  # quad truncates
        "f -4 -3 -2\n")
    (tmp_path / "m.mtl").write_text("newmtl red\nKd 1 0 0\n"
                                    "newmtl blue\nKd 0 0 1\n")
    from ugrt.scene import model as smodel

    v, f, mi = native.parse_obj_fast(str(obj))
    sc = smodel.load_scene(str(obj), prefer_native=False)
    np.testing.assert_array_equal(v, sc.vertices)
    np.testing.assert_array_equal(f, sc.faces)
    np.testing.assert_array_equal(mi, sc.mat_index)


def test_native_materials_match_python(tmp_path):
    mat = tmp_path / "mats.txt"
    mat.write_text(
        "newmtl wall 1\n0.2 0.3 0.4\nKd\n0.5 0.6 0.7\n"
        "a b c d e f g h i j k\nNA\n"
        "newmtl floor 2\n0.1 0.1 0.1\nKd\n0.9 0.8 0.7\n"
        "a b c d e f g h i j k\ntex.png\n")
    from ugrt.scene import model as smodel

    m_native = native.parse_materials_fast(str(mat))
    m_python = smodel.load_material_file(str(mat))
    np.testing.assert_allclose(m_native, m_python)


def test_native_ppm_byte_identical(tmp_path):
    img = np.random.default_rng(3).integers(
        0, 256, (16, 24, 3)).astype(np.uint8)
    from ugrt.api import io

    p_native = tmp_path / "n.ppm"
    p_python = tmp_path / "p.ppm"
    native.write_ppm_fast(str(p_native), img)
    # Force the pure-Python writer for comparison.
    import unittest.mock as mock
    with mock.patch.object(native, "available", return_value=False):
        io.write_ppm(str(p_python), img)
    assert p_native.read_bytes() == p_python.read_bytes()

    flipped = tmp_path / "f.ppm"
    native.write_ppm_fast(str(flipped), img, flip=True)
    back = io.read_ppm(str(flipped))
    np.testing.assert_array_equal(back, img[::-1])


def test_load_scene_native_path(tmp_path):
    obj = tmp_path / "s.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl a\nf 1 2 3\n")
    mat = tmp_path / "m.txt"
    mat.write_text("newmtl a 1\n0.1 0.2 0.3\nKd\n0.4 0.5 0.6\n"
                   "a b c d e f g h i j k\nNA\n")
    from ugrt.scene import model as smodel

    sc_native = smodel.load_scene(str(obj), str(mat), prefer_native=True)
    sc_python = smodel.load_scene(str(obj), str(mat), prefer_native=False)
    np.testing.assert_array_equal(sc_native.vertices, sc_python.vertices)
    np.testing.assert_array_equal(sc_native.faces, sc_python.faces)
    np.testing.assert_allclose(sc_native.materials, sc_python.materials)
