"""``Scene.prepare`` / ``render_prepared``: geometry and binning once, then the
fused kernel alone for each change of the shading uniforms (mirroring
tests/test_fused.py:296-334 of the JAX package). On CPU tensors the fused
kernel's plain version runs; the ``cuda`` case runs the kernel."""

import dataclasses
import types

import pytest
import torch

from f_renderer_tpu_torch import Camera, make_checker_texture, make_cube, make_phong_scene
from f_renderer_tpu_torch.pipeline import fused
from f_renderer_tpu_torch.shaders import TextureStack

W, H = 128, 96


def cube_scene(device="cpu", shader="phong"):
    cam = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device=device)
    return make_phong_scene(
        W, H, meshes=[make_cube(0.9)], textures=[make_checker_texture(96, 8)], camera=cam,
        clip_cap=16, shader=shader, device=device,
    )


@pytest.mark.parametrize("shader", ["phong", "textured", "gouraud", "flat"])
def test_prepared_matches_render(shader):
    scene = cube_scene(shader=shader)
    frame, depth, _ = scene.render()
    prepared = scene.prepare()
    frame_p, depth_p, winner_p = scene.render_prepared(prepared)
    assert torch.equal(frame_p, frame) and torch.equal(depth_p, depth)
    assert winner_p.shape == (H, W) and winner_p.dtype == torch.int32
    assert int((winner_p >= 0).sum()) > 500


def test_prepared_texture_swap_and_eye_move():
    """Shading-only changes replay the same prep: a texture of equal shape,
    then a moved eye position."""
    scene = cube_scene()
    prepared = scene.prepare()
    frame0 = scene.render_prepared(prepared)[0]
    swapped = dataclasses.replace(
        scene, ps_uniform=dict(scene.ps_uniform, textures=TextureStack.create([make_checker_texture(96, 24)],
                                                                               device="cpu")),
    )
    frame_swap = swapped.render_prepared(prepared)[0]
    assert torch.equal(frame_swap, swapped.render()[0])
    assert not torch.equal(frame_swap, frame0)  # the texture changed
    # The reference's reflect(-light_dir, n) mirrors the light into the
    # surface, so the highlight shows only for an eye behind the lit faces.
    moved = dataclasses.replace(scene, ps_uniform=dict(scene.ps_uniform, view_pos=torch.tensor([2.3, 1.9, -3.0])))
    frame_moved = moved.render_prepared(prepared)[0]
    assert torch.equal(frame_moved, moved.render()[0])
    assert not torch.equal(frame_moved, frame0)  # the specular term changed


def test_prepare_raises_where_the_fused_kernel_cannot_run(monkeypatch):
    scene = cube_scene()

    def custom(u, ctx, ps_index):
        return torch.ones((4,) + ps_index.shape)

    with pytest.raises(ValueError, match="fused-eligible"):
        dataclasses.replace(scene, pixel_shader=custom).prepare()
    with pytest.raises(ValueError, match="fused-eligible"):
        dataclasses.replace(scene, config=dataclasses.replace(scene.config, backend="portable")).prepare()
    monkeypatch.setattr(fused, "PACKED_VMEM_BUDGET", 1024)
    assert scene.ps_uniform["textures"].packed_nbytes > 1024
    with pytest.raises(ValueError, match="budget"):
        scene.prepare()


def test_a_traced_launch_records_its_split(monkeypatch):
    """With tracing on, the card's path of ``render_prepared`` records
    ``prepared.run`` with ``prepared.inputs``, ``prepared.launch`` and
    ``prepared.finish`` in order under one frame id, and counts nothing.
    On the CPU the prep claims the card and the kernel's place is
    taken by its plain version's planes (no CUDA tensor exists here)."""
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.utils import metrics

    scene = cube_scene()
    prepared = scene.prepare()
    frame, depth, winner = scene.render_prepared(prepared)
    real_inputs = fused.shading_inputs
    monkeypatch.setattr(fused, "shading_inputs", lambda kind, u, dev: real_inputs(kind, u, torch.device("cpu")))
    monkeypatch.setattr(kernels, "fused_raster", lambda *a, **k: (frame.view(torch.int32).reshape(H, W), depth, winner))
    on_card = dataclasses.replace(prepared, tri_i32=types.SimpleNamespace(device=torch.device("cuda")))
    with metrics.tracing() as rec:
        got = scene.render_prepared(on_card)
    assert torch.equal(got[0], frame) and torch.equal(got[1], depth)
    assert [s[:3] for s in rec.spans] == [
        ("prepared.run", None, 1), ("prepared.inputs", "prepared.run", 1), ("prepared.launch", "prepared.run", 1),
        ("prepared.finish", "prepared.run", 1)]
    assert all(a[4] <= b[3] for a, b in zip(rec.spans[1:], rec.spans[2:]))
    assert rec.counters == {}
    assert rec.mean_ms("prepared.launch") == (rec.spans[2][4] - rec.spans[2][3]) / 1e6


@pytest.mark.cuda
def test_render_prepared_launches_the_kernel_once_on_card():
    """On the card ``render_prepared`` is one K1 launch and equals
    ``Scene.render()``. Run there with ``python -m pytest --noconftest -m
    cuda tests/test_torch_prepared.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from f_renderer_tpu_torch import kernels

    scene = cube_scene(device="cuda")
    frame = scene.render()[0]
    prepared = scene.prepare()
    before = kernels.fused_raster.launches
    frame_p = scene.render_prepared(prepared)[0]
    assert kernels.fused_raster.launches == before + 1
    assert torch.equal(frame_p, frame)
