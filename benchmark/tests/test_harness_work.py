"""The work arithmetic behind the rooflines, against hand counts."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark import roofline, scenes
from benchmark.kinds import triangle

ROOT = Path(__file__).resolve().parents[2]


def square(n=4, width=8, height=8):
    """Two triangles that tile the square [0, n]² of pixel corners."""
    verts = [[(0, 0), (n, 0), (n, n)], [(0, 0), (n, n), (0, n)]]
    sx = torch.tensor([[v[i][0] for v in verts] for i in range(3)], dtype=torch.float32)
    sy = torch.tensor([[v[i][1] for v in verts] for i in range(3)], dtype=torch.float32)
    planes = triangle.setup(sx / width * 2 - 1, 1 - sy / height * 2, sx, sy, sx.long(), sy.long(),
                             torch.ones_like(sx), torch.zeros(3, 8, 2))
    return triangle.Triangles(*planes, torch.tensor([0, 1]), torch.tensor([0, 0]), 0)


def test_two_triangles_of_a_square_cover_each_pixel_once():
    winner, depth = triangle.raster(square(4), 8, 8)
    covered = winner >= 0
    assert int(covered.sum()) == 16  # 4 × 4, the shared diagonal drawn once
    assert covered[:4, :4].all() and not covered[4:].any() and not covered[:, 4:].any()
    assert set(winner[covered].tolist()) == {0, 1} and (depth[covered] == 1.0).all()


def test_touched_texels_of_one_sample():
    stack, dims, _ = triangle.pack_textures([np.full((4, 4, 4), 255, np.uint8)], "cpu")
    ctx = torch.zeros(8, 1)
    ctx[6], ctx[7] = 0.5, 0.5  # x = y = 2.0: taps (2, 2), (2, 3), (3, 2), (3, 3)
    assert triangle.touched_texels(stack, dims, torch.zeros(1, dtype=torch.long), ctx) == 4
    ctx[6], ctx[7] = 0.99, 0.99  # the last column and row clamp: one texel read four times
    assert triangle.touched_texels(stack, dims, torch.zeros(1, dtype=torch.long), ctx) == 1


def test_frame_work_by_hand():
    cfg = json.loads((ROOT / "benchmark/configs/phong1080.json").read_text())
    inputs = scenes.scene_inputs(cfg, 1)
    faces = 2 * 40 * 80 + 12 + 12
    counts = {"emitted": 6424, "covered": 500_000, "texels": 400_000}
    w = triangle.per_frame(cfg, {"entry": "render"}, inputs, counts)
    out = 1920 * 1080 * 8 + 400_000 * 4
    tri = 6424 * 3 * (3 + 8) * 4
    assert w["frame_bytes"] == faces * 3 * 32 + out
    assert w["frame_ops"] == faces * 3 * 49 + 6424 * 47 + 500_000 * triangle.OPS_PER_COVERED_PIXEL
    assert w["raster_bytes"] == tri + out and w["raster_ops"] == 500_000 * triangle.OPS_PER_COVERED_PIXEL
    p = triangle.per_frame(cfg, {"entry": "render_prepared"}, inputs, counts)
    assert p["frame_bytes"] == tri + out and p["frame_ops"] == w["raster_ops"]
    peaks = {"hbm_bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12}
    assert roofline.least_seconds(3.35e12, 1.0, peaks) == 1.0  # bytes bound it
    assert roofline.least_seconds(1.0, 134e12, peaks) == 2.0  # operations bound it
