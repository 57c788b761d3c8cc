"""API-layer tests: CLI driver, checkpointing, profiler, training loop."""

import dataclasses
import os

import numpy as np
import pytest

from ugrt.api import checkpoint as ckpt
from ugrt.api.profiler import StageTimer
from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.scene import procedural


def test_cli_end_to_end(tmp_path):
    """Full CLI run on a tiny OBJ scene."""
    from ugrt.api import cli

    obj = tmp_path / "tri.obj"
    obj.write_text(
        "v -1 -1 -3\nv 1 -1 -3\nv 0 1 -3\nf 1 2 3\n")
    out = tmp_path / "results"
    cli.main([str(obj), "--size", "64", "--grid", "8", "--tag", "t",
              "--out", str(out), "--png",
              "--camera", "0.01", "0.02", "2", "0", "0", "-1",
              "0", "1", "0",
              "--light-camera", "0.5", "1.5", "1", "0", "0", "-3",
              "0", "1", "0",
              "--light-position", "0.5", "1.5", "1"])
    assert (out / "t-0.ppm").exists()
    assert (out / "t-0.png").exists()
    from ugrt.api import io
    img = io.read_ppm(str(out / "t-0.ppm"))
    assert img.shape == (64, 64, 3)
    assert img.sum() > 0  # the triangle is lit


def test_cli_reflective(tmp_path):
    from ugrt.api import cli

    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 -1 -3\nv 1 -1 -3\nv 0 1 -3\nf 1 2 3\n")
    out = tmp_path / "results"
    cli.main([str(obj), "--size", "64", "--grid", "8", "--tag", "r",
              "--out", str(out), "--reflect",
              "--camera", "0.01", "0.02", "2", "0", "0", "-1",
              "0", "1", "0",
              "--light-camera", "0.5", "1.5", "1", "0", "0", "-3",
              "0", "1", "0",
              "--light-position", "0.5", "1.5", "1"])
    assert (out / "r-0.ppm").exists()


def test_checkpoint_roundtrip_npz(tmp_path):
    state = {"params": {"vertices": np.ones((4, 3), np.float32) * 2,
                        "materials": np.zeros((2, 6), np.float32)}}
    p = str(tmp_path / "ck")
    ckpt.save_checkpoint(p, state, step=7)
    assert ckpt.latest_step(p) == 7
    loaded = ckpt.load_checkpoint(p)
    key = [k for k in loaded if "vertices" in k][0]
    np.testing.assert_array_equal(loaded[key],
                                  state["params"]["vertices"])


def test_checkpoint_latest_of_many(tmp_path):
    p = str(tmp_path / "ck")
    for s in (1, 5, 3):
        ckpt.save_checkpoint(p, {"x": np.full(2, s, np.float32)}, step=s)
    assert ckpt.latest_step(p) == 5
    loaded = ckpt.load_checkpoint(p)
    assert loaded["x"][0] == 5


@pytest.mark.parametrize("from_env", [True, False])
def test_compilation_cache_dir(monkeypatch, tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set;
    without it the cache is a fixed directory inside the checkout."""
    import jax

    from ugrt.api import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compilation_cache()
        if from_env:
            assert path == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            root = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert path == os.path.join(root, ".jax_cache", "cpu")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_stage_timer():
    timer = StageTimer()
    with timer.stage("a"):
        sum(range(1000))
    out = timer.time_stage("b", lambda: np.arange(10))
    assert out.shape == (10,)
    rep = timer.report()
    assert "a" in rep and "b" in rep


def test_training_loop_materials(tiny_cfg, tmp_path):
    """Recover halved materials from a rendered target; loss must drop
    substantially, and checkpoint/resume must work."""
    pytest.importorskip("optax")
    import jax.numpy as jnp

    from ugrt.api import train
    from ugrt.diff import render_grad

    cfg = tiny_cfg
    sc = procedural.single_triangle()
    sc = dataclasses.replace(
        sc, vertices=np.asarray(
            [[-1.0, -1.1, -3.1], [1.1, -0.9, -2.7], [0.05, 1.2, -3.4]],
            dtype=np.float32))
    spec = cam.CameraSpec(eye=(0.01, 0.02, 2.0), look_at=(0, 0, -1),
                          up=(0, 1, 0), near=0.1, far=100.0)
    light = cam.CameraSpec(eye=(0.5, 1.5, 1.0), look_at=(0, 0, -3),
                           up=(0, 1, 0), near=0.1, far=100.0)

    cap = cfg.pair_capacity(sc.num_faces)
    cc = jnp.asarray(cam.camcoords_from_spec(spec, cfg.fovy_deg, 1.0))
    lcc = jnp.asarray(cam.camcoords_from_spec(light, cfg.fovy_deg,
                                              1.0))[None]
    lp = jnp.asarray(np.asarray(light.eye, np.float32))
    target, _ = render_grad.render_color(
        jnp.asarray(sc.vertices), jnp.asarray(sc.materials) * 0.5,
        jnp.asarray(sc.faces), jnp.asarray(sc.mat_index), cc, lcc, lp,
        cfg=cfg, capacity=cap, num_lights=1, use_spot=True)

    tcfg = train.TrainConfig(learning_rate=5e-2, steps=30,
                             optimize_vertices=False,
                             checkpoint_dir=str(tmp_path / "ck"),
                             checkpoint_every=10)
    _, mats, log = train.train(sc, [spec], light, light.eye, [target],
                               cfg, tcfg, verbose=False)
    assert log[-1] < log[0] * 0.2, f"loss {log[0]} -> {log[-1]}"
    assert ckpt.latest_step(str(tmp_path / "ck")) is not None

    # Resume: should pick up at the checkpointed step without error.
    tcfg2 = dataclasses.replace(tcfg, steps=35)
    _, _, log2 = train.train(sc, [spec], light, light.eye, [target],
                             cfg, tcfg2, verbose=False)
    assert len(log2) > 0
