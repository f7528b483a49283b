"""custom_tex1080 (phong.rs's pixel shader as user code,
``benchmark/shaders/phong_rs.py``) through ``Scene.render()`` on the CPU,
held to the benchmark's plain reference (``benchmark/kinds/triangle.py``,
plain PyTorch that imports nothing of the port) at 160 × 90, four angles of
the turntable.

The shader runs on the covered pixels compacted (``shade.compact_planes``):
it is given R rows of slots, R the frame's rung of ``shade.RUNGS``, the
covered pixels in raster order and padding after them. So the planes it is
given are compared at the slots: slot s holds the reference's s-th covered
pixel in raster order (each varying of its winner bit-equal, its texture
id), and every slot past the covered count is padding (texture id -1, zero
varyings). The frame is held to the reference's as the cell's run holds it:
depth bit-equal, the background bit-equal, the colour within the cell's
checks and ``compare.COLOR_TOL``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, scenes
from benchmark.drivers.closed_loop import model_matrix
from benchmark.kinds import triangle
from benchmark.shaders import phong_rs
from f_renderer_tpu_torch.camera import Camera
from f_renderer_tpu_torch.pipeline import shade
from f_renderer_tpu_torch.scene import make_phong_scene

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def tiny_config() -> dict:
    """custom_tex1080 cut as the harness's CPU tests cut it: 160 × 90, an
    8 × 16 sphere, 32² maps."""
    cfg = json.loads((ROOT / "benchmark/configs/custom_tex1080.json").read_text())
    cfg.update(width=160, height=90)
    cfg["meshes"][0].update(n_lat=8, n_lon=16)
    cfg["textures"] = [{"n": 32, "cell": 4}, {"n": 32, "cell": 8}, {"n": 32, "cell": 2}]
    return cfg


def port_scene(cfg, inputs, pixel):
    """The port's scene as the cell's driver builds it: the builtin Phong
    vertex stage, the user's pixel shader ``pixel``."""
    cam = cfg["camera"]
    scene = make_phong_scene(cfg["width"], cfg["height"], meshes=inputs.meshes, textures=inputs.stacks[0],
                             camera=Camera.create(cam["eye"], cam["at"], cam["up"], device="cpu"),
                             clip_cap=cfg["clip_cap"], shader=cfg["shader"], device="cpu")
    scene.pixel_shader = pixel
    return scene


def reference_planes(cfg, inputs, model):
    """The reference's covered pixels in raster order: (C, n) varyings of
    each pixel's winner, (n,) texture ids, and the (H, W) coverage."""
    cam = cfg["camera"]
    eye, at, up = (torch.tensor(cam[k], dtype=torch.float32) for k in ("eye", "at", "up"))
    view, proj = triangle.camera_matrices(cfg, eye, at, up, torch.float32)
    meshes = [{k: torch.as_tensor(v) for k, v in m.items()} for m in inputs.meshes]
    tri = triangle.geometry(meshes, model, view, proj, cfg["width"], cfg["height"], torch.float32)
    winner, depth = triangle.raster(tri, cfg["width"], cfg["height"])
    pix, t, ctx = triangle.interpolate(tri, winner, depth)
    order = torch.argsort(pix)
    covered = torch.zeros(winner.numel(), dtype=torch.bool)
    covered[pix] = True
    return ctx[:, order], tri.ps[t][order].to(torch.int32), covered.view(winner.shape)


@pytest.mark.parametrize("step", [0, 17, 40, 77])
def test_the_users_shader_on_its_slots_against_the_reference(step):
    cfg = tiny_config()
    inputs = scenes.scene_inputs(cfg, 11)
    seen = []

    def pixel(u, ctx, ps_index):
        seen.append((torch.cat([ctx["normal"], ctx["pos"], ctx["uv"]]), ps_index.clone()))
        return phong_rs.pixel(u, ctx, ps_index)

    scene = port_scene(cfg, inputs, pixel)
    model = model_matrix(0.05 * step, CPU)
    scene.vs_uniform = dict(scene.vs_uniform, model=model)
    frame, depth, _ = scene.render()
    ctx, ps, covered = reference_planes(cfg, inputs, model)
    n, h, w = int(covered.sum()), cfg["height"], cfg["width"]
    assert 1000 < n < h * w and len(seen) == 1
    got_planes, got_ps = seen.pop()
    rows = shade.rung_rows(h)
    rung = next(k for k, r in enumerate(rows) if n <= r * w)  # every angle lands on a rung, not the whole frame
    assert got_ps.shape == (rows[rung], w) and got_planes.shape == (ctx.shape[0], rows[rung], w)
    flat_ps, flat = got_ps.reshape(-1), got_planes.reshape(ctx.shape[0], -1)
    assert torch.equal(flat_ps[:n], ps) and torch.equal(flat[:, :n], ctx)
    assert bool((flat_ps[n:] == -1).all()) and bool((flat[:, n:] == 0).all())
    cam = cfg["camera"]
    case = dict(model=model, **{k: np.float32(cam[k]) for k in ("eye", "at", "up")}, stack=0)
    ref_frame, ref_depth, _ = triangle.reference_frames(cfg, inputs, {0: case}, CPU)[0]
    assert torch.equal(depth, ref_depth)
    assert torch.equal(frame[~covered], ref_frame[~covered])
    got = compare.numbers(frame, depth, ref_frame, ref_depth)
    assert all(got[k] <= cfg["checks"][k] for k in cfg["checks"]), got
    assert int((frame.to(torch.int16) - ref_frame.to(torch.int16)).abs().max()) <= compare.COLOR_TOL
