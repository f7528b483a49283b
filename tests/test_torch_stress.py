"""stress4k's shapes at a small size: the port's soup builder and its fused
path in the regime of 64-row tiles and two fine tiles a triangle, against
the JAX package.

``make_instanced_soup`` is numpy in both packages and must be bit-equal.
The stress-shaped scene is a 3,000-triangle ``box=3.2`` soup at 256×144
seen from stress4k's camera (z = -12), its triangles scaled (``size=0.3``)
to about 20 px across, the size stress4k's have at 3840×2160, so they
overlap many deep and some span more than two tiles; with ``tile_auto_threshold=1`` (so
the tiles are 64 rows tall, as at a million triangles) and ``bin_k=2`` (at
most two fine tiles a triangle). On the JAX package's TriangleBuffer, the
port's plain fused render is held to
JAX ``render_fused_pallas(interpret=True)`` and ``rasterize_jnp`` (winner
ids bit-equal, depth within rtol 2.4e-7) and to their frames (colour within
2 u8, at most 0.2% of pixels at 2).

The JAX side runs in a subprocess with ``--xla_cpu_max_isa=AVX`` so XLA
makes no fused multiply-adds (see test_torch_fused.py). This file is that
subprocess's script too.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from f_renderer_tpu_torch import convert
from f_renderer_tpu_torch import scene as port_scene
from f_renderer_tpu_torch.pipeline import fused
from test_torch_fused import frame_bar

W, H = 256, 144
N_TRIS = 3000
SIZE = 0.3  # the soup's triangles about 20 px across at 256x144
TRI_FIELDS = ("spi", "spf", "rhw", "ctx", "top_left", "valid", "order", "ps_index")
OVERRIDES = dict(tile_auto_threshold=1, bin_k=2)
CONFIG = dict(width=W, height=H, background=(30, 30, 30, 255), clip_cap=64)


def write_reference(path):
    """The stress-shaped scene through the JAX package: its triangles, its
    fused kernel (interpret mode), its portable rasterizer and jnp frame."""
    import jax.numpy as jnp

    from f_renderer_tpu.camera import Camera
    from f_renderer_tpu.math import set_rotate
    from f_renderer_tpu.pipeline.fused import render_fused_pallas
    from f_renderer_tpu.pipeline.raster_jnp import rasterize_jnp
    from f_renderer_tpu.pipeline.render import build_triangles
    from f_renderer_tpu.scene import make_instanced_soup, make_phong_scene

    cam = Camera.create([0.0, 0.0, -12.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene = make_phong_scene(W, H, meshes=[make_instanced_soup(N_TRIS, size=SIZE, box=3.2)], camera=cam, clip_cap=64)
    scene = dataclasses.replace(
        scene,
        vs_uniform=dict(scene.vs_uniform, model=set_rotate(jnp.asarray([0.0, 1.0, 0.0]), 0.1)),
        config=dataclasses.replace(scene.config, **OVERRIDES),
    )
    cfg = scene.config
    tri, stats = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, cfg)
    out = {f"tri/{f}": np.asarray(getattr(tri, f)) for f in TRI_FIELDS}
    winner_j, depth_j = rasterize_jnp(tri, W, H, tile=cfg.tile)
    frame_f, depth_f, winner_f = render_fused_pallas(tri, scene.pixel_shader, scene.ps_uniform, cfg, interpret=True)
    frame_j, _, _ = scene.render()  # the jnp pipeline, end to end
    stack = scene.ps_uniform["textures"]
    out.update(
        winner_jnp=np.asarray(winner_j), depth_jnp=np.asarray(depth_j), frame_jnp=np.asarray(frame_j),
        frame_fused=np.asarray(frame_f), depth_fused=np.asarray(depth_f), winner_fused=np.asarray(winner_f),
        tex_data=np.asarray(stack.data), tex_dims=np.asarray(stack.dims),
        view_pos=np.asarray(scene.ps_uniform["view_pos"]), num_clipped=np.asarray(stats["num_clipped"]),
    )
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_stress") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600)
    with np.load(path) as data:
        return dict(data)


@pytest.mark.parametrize("n, seed, box", [(500, 0, None), (500, 3, 3.2)])
def test_instanced_soup_matches_jax(n, seed, box):
    pytest.importorskip("jax", reason="compares the port with the JAX package")
    from f_renderer_tpu.scene import make_instanced_soup

    got = port_scene.make_instanced_soup(n, seed=seed, box=box)
    want = make_instanced_soup(n, seed=seed, box=box)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def port_inputs(ref):
    tri = convert.triangles_from_arrays({f: ref[f"tri/{f}"] for f in TRI_FIELDS}, device="cpu")
    scene = convert.scene_from_arrays(
        draws=[], vs_uniform={},
        ps_uniform={"view_pos": ref["view_pos"], "textures": {"data": ref["tex_data"], "dims": ref["tex_dims"]}},
        shader_kind="phong", config=dict(CONFIG, **OVERRIDES), device="cpu",
    )
    return tri, scene


def test_stress_shaped_prep(ref):
    """The small scene takes stress4k's regime: 64-row tiles, at most two
    fine tiles a triangle (the others in the coarse range), and bin_pairs'
    packed single-operand sort; no face is dropped at the clip cap."""
    tri, scene = port_inputs(ref)
    prep = fused.prep_fused(tri, scene.config)
    assert prep.th == 64
    m_pad = 128 * -(-(tri.num_slots + 1) // 128)
    assert prep.off.numel().bit_length() + (m_pad - 1).bit_length() <= 31
    ntiles = -(-H // 64) * (W // 128)
    off = prep.off.tolist()
    assert 0 < off[ntiles] <= 2 * int(tri.valid.sum())
    assert off[-2] > off[ntiles], "no triangle spans more than two tiles"
    assert int(ref["num_clipped"]) <= CONFIG["clip_cap"]


def test_stress_shaped_fused_matches_jax(ref):
    tri, scene = port_inputs(ref)
    frame, depth, winner = (t.numpy() for t in fused.render_fused(tri, scene.pixel_shader, scene.ps_uniform, scene.config))
    np.testing.assert_array_equal(winner, ref["winner_fused"])
    np.testing.assert_array_equal(winner, ref["winner_jnp"])
    np.testing.assert_allclose(depth, ref["depth_fused"], rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(depth, ref["depth_jnp"], rtol=2.4e-7, atol=0)
    frame_bar(frame, ref["frame_fused"])
    frame_bar(frame, ref["frame_jnp"])
    assert (winner >= 0).mean() > 0.3  # the soup covers the centre of the frame


def test_plain_version_on_chosen_tiles_is_the_full_frames_crop(ref):
    """``render_fused_plain(..., tiles=)`` rasterizes only the given bin
    tiles (how the plain version is held to K1 at stress4k, where the whole
    plain frame would take minutes): there it is the full frame, elsewhere
    background."""
    import torch

    tri, scene = port_inputs(ref)
    prep = fused.prep_fused(tri, scene.config)
    args = (prep, scene.pixel_shader, scene.ps_uniform, scene.config)
    full = fused.render_fused_plain(*args)
    tiles = [(0, 1), (2, 0)]
    part = fused.render_fused_plain(*args, tiles=tiles)
    inside = torch.zeros((H, W), dtype=torch.bool)
    for ty, tx in tiles:
        inside[ty * 64 : (ty + 1) * 64, tx * 128 : (tx + 1) * 128] = True
    for got, want in zip(part, full):
        assert torch.equal(got[inside], want[inside])
    frame, depth, winner = part
    assert (winner[~inside] == -1).all() and (depth[~inside] == 0).all()
    assert (frame[~inside] == torch.tensor(CONFIG["background"], dtype=torch.uint8)).all()
    assert (full[2][~inside] >= 0).any()  # the other tiles were not empty


if __name__ == "__main__":
    write_reference(sys.argv[1])
