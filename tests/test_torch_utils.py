"""The port's observability module: ``FrameStats`` against the JAX package's
``FrameStats.gather`` on one frame, ``StageTimer``, ``profiler_trace``, and
the recorder of spans and counters (``tracing``)."""

import os

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch.utils import FrameStats, Span, StageTimer, metrics, profiler_trace, tracing

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


def test_stage_timer_records_through_the_recorder():
    """A stage is a span: with tracing on the recorder keeps it, with its
    parent, and the timer's total is the span's own duration."""
    timer = StageTimer()
    with tracing() as rec:
        with Span("outer", rec):
            with timer.stage("frame"):
                pass
    name, parent, frame, t0, t1 = rec.spans[1]
    assert (name, parent, frame) == ("frame", "outer", 1)
    assert timer.totals["frame"] == (t1 - t0) / 1e9 and timer.counts == {"frame": 1}


def test_spans_nest_under_frames():
    """An outermost span starts a frame id; spans take the innermost open
    span as their parent, and its frame, whatever their name (an entry point
    called inside another is its child); counters add up a frame; the
    summaries read them back."""
    with tracing() as rec:
        rec.count("bytes", 7)  # before any span: frame 0
        for n in (3, 5):
            with Span("run", rec):
                with Span("a", rec):
                    with Span("other", rec):  # an entry point inside another
                        pass
                span = Span("c", rec).start()
                span.stop()
                rec.add("d", 10 * n, 11 * n)  # stamps the caller took
                rec.count("bytes", n)
                rec.count("bytes", 1)
                rec.count("level", 100 * n)
    assert [s[:3] for s in rec.spans] == [
        ("run", None, 1), ("a", "run", 1), ("other", "a", 1), ("c", "run", 1), ("d", "run", 1),
        ("run", None, 2), ("a", "run", 2), ("other", "a", 2), ("c", "run", 2), ("d", "run", 2)]
    assert [s[3:] for s in rec.spans if s[0] == "d"] == [(30, 33), (50, 55)]
    assert rec.counters == {0: {"bytes": 7}, 1: {"bytes": 4, "level": 300}, 2: {"bytes": 6, "level": 500}}
    assert rec.total("bytes") == 17 and rec.total("none") == 0 and rec.frame == 2
    ns = lambda s: s[4] - s[3]  # noqa: E731
    inner = {f: sum(ns(s) for s in rec.spans if s[1] == "run" and s[2] == f) for f in (1, 2)}
    own = sum(ns(s) - inner[s[2]] for s in rec.spans if s[0] == "run")
    assert rec.self_ms("run") == pytest.approx(own / 2 / 1e6)
    assert rec.mean_ms("other") == pytest.approx(sum(ns(s) for s in rec.spans if s[0] == "other") / 2 / 1e6)
    assert rec.mean_ms("none") is None and rec.self_ms("none") is None


def test_the_recorder_drops_past_its_cap_and_counts():
    with tracing(cap=4) as rec:
        with Span("run", rec):
            for _ in range(5):
                with Span("s", rec):
                    pass
            rec.count("n", 1)  # a fifth record: dropped
            rec.add("t", 0, 1)
    assert [s[0] for s in rec.spans] == ["run", "s", "s", "s"] and rec.counters == {} and rec.dropped == 4


def test_tracing_is_off_by_default_and_restores():
    assert metrics.recorder is None
    with tracing() as outer:
        assert metrics.recorder is outer
        with tracing() as inner:
            assert metrics.recorder is inner
        assert metrics.recorder is outer
    assert metrics.recorder is None
    with pytest.raises(RuntimeError), tracing():
        raise RuntimeError
    assert metrics.recorder is None
    with Span("alone") as span:  # no recorder: timed, not recorded
        pass
    assert span.ns >= 0 and span.frame is None and outer.spans == [] and inner.spans == []


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
