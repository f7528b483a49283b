"""The six triangle bench scenes, built with the port, drop no face at the
clip cap.

``clip_cap`` sizes fixed-shape arrays: faces past it are dropped, and the
frame is then not the scene's. The JAX package's guard
(tests/test_bench_scenes.py) covers four of the six scenes; this one covers
all six at the bench angles, geometry stage only, on the CPU. stress4k's
million faces clip 0 at 0.10 and 44 at its worst angle, 0.80 (the record in
``bench.py:145-151``), far under its cap of 512.
"""

import functools

import pytest

from f_renderer_tpu_torch import bench_scenes
from f_renderer_tpu_torch.pipeline.render import build_triangles

ANGLES = (0.10, 0.55, 0.80, 1.05)  # bench frames take 0.1 + 0.05 i
STRESS_CLIPPED = {0.10: 0, 0.80: 44}
CASES = [(n, a) for n in bench_scenes.NAMES if n != "stress4k" for a in ANGLES]
CASES += [("stress4k", a) for a in STRESS_CLIPPED]


@functools.lru_cache(maxsize=1)
def scene(name):
    return bench_scenes.build_scene(name, device="cpu")


def clipped(name, angle):
    s = scene(name)
    bench_scenes.set_angle(s, angle)
    _, stats = build_triangles(list(s.draws), s.vertex_shader, s.vs_uniform, s.config)
    return int(stats["num_clipped"])


@pytest.mark.parametrize("name, angle", CASES)
def test_clip_count_within_cap(name, angle):
    s = scene(name)
    n = clipped(name, angle)
    assert n <= s.config.clip_cap, (name, angle, n, s.config.clip_cap)
    if name in ("cube512", "cube1080"):  # a drop is impossible at any pose
        assert s.config.clip_cap >= sum(d["pos"].shape[0] for d in s.draws)
    elif name == "stress4k":
        assert n == STRESS_CLIPPED[angle]
    else:  # these clip nothing at the bench angles; half the cap is the margin
        assert n <= s.config.clip_cap // 2


def test_bench_scene_shapes():
    """The port builds bench.py's sizes, caps and shaders."""
    want = {
        "cube512": (512, 512, 16, None), "cube1080": (1920, 1080, 16, "flat"),
        "gouraud800": (800, 600, 64, "gouraud"), "textured1080": (1920, 1080, 64, "textured"),
        "phong1080": (1920, 1080, 64, "phong"), "stress4k": (3840, 2160, 512, "phong"),
    }
    for name, (w, h, cap, kind) in want.items():
        s = scene(name)
        assert (s.config.width, s.config.height, s.config.clip_cap) == (w, h, cap)
        assert getattr(s.pixel_shader, "fused_kind", None) == (kind or "phong")
    assert sum(d["pos"].shape[0] for d in scene("stress4k").draws) == 1_000_000
    with pytest.raises(ValueError):
        bench_scenes.build_scene("voxel540", device="cpu")
