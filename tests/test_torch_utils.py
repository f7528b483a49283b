"""The port's observability module: ``FrameStats`` against the JAX package's
``FrameStats.gather`` on one frame, ``StageTimer`` and ``profiler_trace``."""

import os

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch.utils import FrameStats, StageTimer, profiler_trace

W, H = 64, 48


def test_frame_stats_match_jax():
    """One frame of a cube through both packages' geometry and portable
    rasterizers: the same four counters."""
    pytest.importorskip("jax", reason="compares the port with the JAX package")
    from f_renderer_tpu.pipeline.raster_jnp import rasterize_jnp
    from f_renderer_tpu.pipeline.render import build_triangles as jax_build
    from f_renderer_tpu.scene import make_cube, make_phong_scene
    from f_renderer_tpu.utils import FrameStats as JaxFrameStats
    from f_renderer_tpu_torch import convert
    from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    js = make_phong_scene(W, H, meshes=[make_cube()], clip_cap=16)
    tri_j, stats_j = jax_build(js.draws, js.vertex_shader, js.vs_uniform, js.config)
    winner_j, _ = rasterize_jnp(tri_j, W, H)
    want = JaxFrameStats.gather(tri_j, winner_j, stats_j["num_clipped"], 12).as_dict()

    stack = js.ps_uniform["textures"]
    ps = convert.scene_from_arrays(
        [{k: np.asarray(v) for k, v in d.items()} for d in js.draws],
        {k: np.asarray(v) for k, v in js.vs_uniform.items()},
        {"view_pos": np.asarray(js.ps_uniform["view_pos"]),
         "textures": {"data": np.asarray(stack.data), "dims": np.asarray(stack.dims)}},
        "phong", dict(width=W, height=H, clip_cap=16), device="cpu",
    )
    tri, stats = build_triangles(ps.draws, ps.vertex_shader, ps.vs_uniform, ps.config)
    winner, _ = rasterize_portable(tri, W, H)
    fs = FrameStats.gather(tri, winner, stats["num_clipped"], 12)
    assert all(t.dtype == torch.int32 and t.dim() == 0 for t in (fs.triangles_in, fs.triangles_clipped,
                                                                  fs.triangles_emitted, fs.pixels_covered))
    got = fs.as_dict()
    assert got == want
    assert got["triangles_in"] == 12 and got["triangles_emitted"] >= 6 and 0 < got["pixels_covered"] < W * H


def test_stage_timer_reports_means():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("frame", sync="cpu"):  # a CPU device: nothing to wait for
            torch.ones(64).sum()
    with timer.stage("present"):
        pass
    assert timer.counts == {"frame": 3, "present": 1}
    assert timer.mean("frame") == timer.totals["frame"] / 3 >= 0.0
    report = timer.report(pixels=W * H)
    assert report.startswith("frame: ") and "Mpix/s" in report and "present: " in report


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiler_trace(str(tmp_path)):
        torch.ones(128).cumsum(0)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    assert os.path.getsize(tmp_path / traces[0]) > 0


@pytest.mark.parametrize("log_dir", [None, ""])
def test_profiler_trace_off_without_a_directory(log_dir):
    with profiler_trace(log_dir) as ctx:
        assert ctx is None  # contextlib.nullcontext


@pytest.mark.cuda
def test_stage_timer_covers_the_device():
    """With ``sync`` on the card the span covers work the card queued in it.
    Run there with ``python -m pytest --noconftest -m cuda tests/test_torch_utils.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    timer = StageTimer()
    torch.cuda._sleep(1000)  # queued before the span: not in it
    with timer.stage("spin", sync="cuda"):
        torch.cuda._sleep(50_000_000)  # tens of milliseconds of device time
    assert timer.mean("spin") > 0.005
