"""The port's asset IO against the JAX package's: the OBJ loader and the
texture loader on the files under tests/data/, and scene files, which
either package writes and the other loads.

A scene file the JAX package writes (the JAX side runs in a subprocess with
``--xla_cpu_max_isa=AVX``, so XLA makes no fused multiply-adds; see
test_torch_fused.py) loads into the port and renders within the bar of
tests/test_fused.py: colour within 2 u8, at most 0.2% of pixels at 2. This
file is that subprocess's script too.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch.io import load_obj, load_scene, load_texture, save_png, save_scene
from f_renderer_tpu_torch.scene import make_checker_texture, make_cube, make_phong_scene, make_uv_sphere
from test_torch_fused import frame_bar

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
W, H = 64, 48
OBJ_TEXT = """# comment
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 0.0 1.0 0.0
v 1.0 1.0 0.5
vn 0.0 0.0 2.0
vn 0.0 1.0 0.0
vt 0.0 0.0
vt 1.0 0.0
vt 0.0 1.0
f 1/1/1 2/2/1 3/3/2
f 2/2/2 4/1/1 3/3/2 1/1/1
"""
JAX_SCENES = ("phong", "gouraud")  # the scene files the JAX package writes


def jax_scene(kind):
    from f_renderer_tpu.camera import Camera
    from f_renderer_tpu.scene import make_phong_scene as jax_make
    from f_renderer_tpu.shaders import make_gouraud_shaders

    cam = Camera.create([0.0, 0.5, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([0.9, 0.0, 0.0], np.float32)
    scene = jax_make(W, H, meshes=[make_uv_sphere(8, 16), cube], camera=cam, clip_cap=16, shader=kind,
                     textures=[make_checker_texture(32, 4), make_checker_texture(16, 2)])
    if kind == "gouraud":  # a light of its own: recorded in the file
        vs, ps = make_gouraud_shaders(light_pos=(-1.0, 2.0, 1.5), light_color=(1.0, 0.9, 0.8))
        scene = dataclasses.replace(scene, vertex_shader=vs, pixel_shader=ps)
    return scene


def write_reference(directory):
    """Write each JAX scene's file and its jnp frame."""
    from f_renderer_tpu.io.scene_io import save_scene as jax_save

    for kind in JAX_SCENES:
        scene = jax_scene(kind)
        jax_save(os.path.join(directory, f"{kind}.npz"), scene)
        np.save(os.path.join(directory, f"{kind}_frame.npy"), np.asarray(scene.render()[0]))


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    directory = tmp_path_factory.mktemp("jax_scenes")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), str(directory)], env=env, check=True, timeout=600)
    return directory


def _obj_files(tmp_path):
    (tmp_path / "tri.obj").write_text(OBJ_TEXT)
    (tmp_path / "crlf.obj").write_bytes(OBJ_TEXT.replace("\n", "\r\n").encode())
    return [os.path.join(DATA, "torus.obj"), str(tmp_path / "tri.obj"), str(tmp_path / "crlf.obj")]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_load_obj_matches_jax(tmp_path, which):
    pytest.importorskip("jax", reason="compares the port with the JAX package")
    from f_renderer_tpu.io import load_obj as jax_load_obj

    path = _obj_files(tmp_path)[which]
    got, want = load_obj(path), jax_load_obj(path)
    for field in ("verts", "norms", "uvs", "faces"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype
    for k, v in want.corners().items():
        np.testing.assert_array_equal(got.corners()[k], v)
    np.testing.assert_array_equal(got.normal(0, 0), want.normal(0, 0))
    assert got.faces_len == want.faces_len > 0


@pytest.mark.parametrize("bgra", [True, False])
def test_load_texture_matches_jax(bgra):
    pytest.importorskip("PIL", reason="textures decode through PIL")
    pytest.importorskip("jax", reason="compares the port with the JAX package")
    from f_renderer_tpu.io import load_texture as jax_load_texture

    path = os.path.join(DATA, "torus_diffuse.tga")
    got = load_texture(path, bgra=bgra)
    np.testing.assert_array_equal(got, jax_load_texture(path, bgra=bgra))
    assert got.dtype == np.uint8 and got.shape[-1] == 4


def test_save_png_roundtrip(tmp_path):
    pytest.importorskip("PIL", reason="PNG goes through PIL")
    frame = np.random.default_rng(0).integers(0, 256, (4, 5, 4)).astype(np.uint8)
    save_png(str(tmp_path / "f.png"), frame)
    np.testing.assert_array_equal(load_texture(str(tmp_path / "f.png"), bgra=False), frame)


@pytest.mark.parametrize("shader", ["flat", "gouraud", "textured", "phong"])
def test_scene_roundtrip_port_to_port(tmp_path, shader):
    """Every builtin shader kind round-trips: config, shader kind, draws,
    textures and the rendered frame."""
    scene = make_phong_scene(32, 24, meshes=[make_cube()], clip_cap=8, shader=shader, device="cpu")
    path = str(tmp_path / "scene.npz")
    save_scene(path, scene)
    back = load_scene(path, device="cpu")
    assert back.config == scene.config and back.config.tile is None and back.config.backend == "kernels"
    assert back.pixel_shader.fused_kind == shader
    assert torch.equal(back.draws[0]["pos"], scene.draws[0]["pos"])
    assert torch.equal(back.ps_uniform["textures"].texels, scene.ps_uniform["textures"].texels)
    assert torch.equal(back.render()[0], scene.render()[0])


def test_scene_save_rejects_custom_shader(tmp_path):
    scene = make_phong_scene(16, 16, meshes=[make_cube()], device="cpu")
    scene.pixel_shader = lambda u, ctx, ps_index: ctx["uv"]  # no fused_kind
    with pytest.raises(ValueError, match="builtin shader kinds"):
        save_scene(str(tmp_path / "scene.npz"), scene)


@pytest.mark.parametrize("kind", JAX_SCENES)
def test_jax_scene_file_loads_and_renders_in_port(jax_files, kind):
    back = load_scene(str(jax_files / f"{kind}.npz"), device="cpu")
    assert back.config.backend == "kernels"  # the file's "jnp" does not pick the port's path
    assert back.pixel_shader.fused_kind == kind and len(back.draws) == 2
    if kind == "gouraud":
        assert back.pixel_shader.light_pos == pytest.approx((-1.0, 2.0, 1.5))
    frame, _, _ = back.render()
    want = np.load(jax_files / f"{kind}_frame.npy")
    frame_bar(frame.numpy(), want)
    assert (want[..., :3] != 0).any(-1).sum() > 300


def test_port_scene_file_loads_in_jax(tmp_path):
    """A file the port writes loads into the JAX package with the same
    state; its kernel backend is written as the JAX package's "pallas"."""
    pytest.importorskip("jax", reason="compares the port with the JAX package")
    from f_renderer_tpu.io.scene_io import load_scene as jax_load

    scene = make_phong_scene(W, H, meshes=[make_cube(), make_cube(0.5)], clip_cap=8, device="cpu",
                             textures=[make_checker_texture(32, 4), make_checker_texture(16, 2)])
    path = str(tmp_path / "port.npz")
    save_scene(path, scene)
    back = jax_load(path)
    assert (back.config.width, back.config.height, back.config.clip_cap) == (W, H, 8)
    assert back.config.backend == "pallas" and tuple(back.config.tile) == (32, 128)
    assert back.pixel_shader.fused_kind == "phong"
    for d_j, d_p in zip(back.draws, scene.draws):
        for k in d_p:
            np.testing.assert_array_equal(np.asarray(d_j[k]), d_p[k].numpy())
    np.testing.assert_array_equal(np.asarray(back.vs_uniform["proj"]), scene.vs_uniform["proj"].numpy())
    np.testing.assert_array_equal(np.asarray(back.ps_uniform["textures"].dims), scene.ps_uniform["textures"].dims.numpy())
    from f_renderer_tpu.shaders import TextureStack

    want = TextureStack.create([make_checker_texture(32, 4), make_checker_texture(16, 2)])
    np.testing.assert_array_equal(np.asarray(back.ps_uniform["textures"].data), np.asarray(want.data))


if __name__ == "__main__":
    write_reference(sys.argv[1])
