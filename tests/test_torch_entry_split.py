"""``tools/entry_split.py``'s reading of the entry point's spans: the
``entry.*`` numbers from a hand-built recorder with hand counts, and the
idle gaps of a device trace named by the innermost span. The tool and these
tests stand alone: a stand-in host log and device trace, nothing of the
benchmark's package."""

import os
import sys
import types

import pytest

from f_renderer_tpu_torch.utils import Recorder

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import entry_split  # noqa: E402


def span(rec, name, parent, frame, t0, t1):
    rec.spans.append((name, parent, frame, t0, t1))


def graph_frames(n=2):
    """``n`` replayed frames, 100 us each: key 10, copy 20, replay 30, clone
    15, so 25 us of self time; 4 MB of buffers, 3 MB of it not copied, 500 B
    cloned; a capture in the first frame, whose warm-up ran the fused
    kernel's ``prepared.*`` spans."""
    rec = Recorder()
    for f in range(1, n + 1):
        t = f * 1_000_000
        span(rec, "graph.run", None, f, t, t + 100_000)
        for name, a, b in (("graph.key", 2, 12), ("graph.copy", 12, 32), ("graph.replay", 35, 65),
                           ("graph.clone", 65, 80)):
            span(rec, name, "graph.run", f, t + a * 1000, t + b * 1000)
        rec.counters[f] = {"graph.calls": 1, "graph.copy_bytes": 4_000_000, "graph.copy_skipped_bytes": 3_000_000,
                           "graph.clone_bytes": 500}
    span(rec, "prepared.run", "graph.capture", 1, 1_050_000, 1_060_000)
    span(rec, "prepared.launch", "prepared.run", 1, 1_051_000, 1_059_000)
    rec.counters[1].update({"graph.captures": 1, "graph.evictions": 1})
    rec.frame = n
    return rec


def test_the_graph_split_from_hand_counts():
    """The orbit cells' numbers; the ``prepared.*`` spans of a capture's
    warm-up are not read as the entry point's."""
    got = entry_split.split(graph_frames(3), "graph.run")
    want = {"entry.key_ms": 0.010, "entry.copy_ms": 0.020, "entry.replay_ms": 0.030, "entry.clone_ms": 0.015,
            "entry.self_ms": 0.025, "entry.copy_mb": 4.0, "entry.clone_mb": 0.0005, "entry.copy_skipped_pct": 75.0,
            "graph.captures": 1, "graph.evictions": 1, "graph.calls": 3,
            "render.fused_frames": 0, "render.planes_frames": 0, "render.user_shader_frames": 0,
            "render.pack_kernel_frames": 0}
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v) for k, v in want.items())
    assert entry_split.split(graph_frames(3), "graph.run", captures=2)["graph.captures"] == 2


@pytest.mark.parametrize("user", [True, False])
def test_the_path_counters_and_render_spans(user):
    """The captured frame's path as its calls counted it: a planes frame a
    call, a user shader's frame where the shader is user code, C and the
    planes' megabytes a planes frame, a pack kernel's frame where the user's
    colour was packed by the kernel; the fused count 0. The eager frame's ``render.planes``
    and ``render.shade`` spans, where a recorder holds them, as their mean
    ms."""
    rec = graph_frames(4)
    for f in range(1, 5):
        rec.counters[f].update({"render.planes_frames": 1, "render.planes_varyings": 8,
                                "render.planes_bytes": 91_238_400})
        if user:
            rec.counters[f].update({"render.user_shader_frames": 1, "render.pack_kernel_frames": 1})
    got = entry_split.split(rec, "graph.run")
    assert (got["graph.calls"], got["render.planes_frames"], got["render.fused_frames"]) == (4, 4, 0)
    assert got["render.user_shader_frames"] == got["render.pack_kernel_frames"] == (4 if user else 0)
    assert got["render.planes_mb"] == pytest.approx(91.2384) and got["render.planes_c"] == 8
    assert "render.planes_ms" not in got and "render.shade_ms" not in got
    for t, name, a, b in ((0, "render.planes", 10, 40), (0, "render.shade", 40, 140),
                          (1_000, "render.planes", 10, 30), (1_000, "render.shade", 30, 90)):
        span(rec, name, None, 9, t + a * 1000, t + b * 1000)
    got = entry_split.split(rec, "graph.run")
    assert got["render.planes_ms"] == pytest.approx(0.025) and got["render.shade_ms"] == pytest.approx(0.080)


def test_the_prepared_split_from_hand_counts():
    """``render_prepared``: its three children and the self time; no graph
    numbers."""
    rec = Recorder()
    for f in (1, 2):
        t = f * 1_000_000
        span(rec, "prepared.run", None, f, t, t + 50_000)
        for name, a, b in (("prepared.inputs", 0, 5), ("prepared.launch", 5, 40), ("prepared.finish", 40, 48)):
            span(rec, name, "prepared.run", f, t + a * 1000, t + b * 1000)
    want = {"entry.inputs_ms": 0.005, "entry.launch_ms": 0.035, "entry.finish_ms": 0.008, "entry.self_ms": 0.002}
    got = entry_split.split(rec, "prepared.run")
    assert got.keys() == want.keys() and all(got[k] == pytest.approx(v) for k, v in want.items())
    assert entry_split.split(Recorder(), "prepared.run") == {} and entry_split.split(Recorder(), "graph.run") == {}


def test_innermost_segments():
    ivs = [(0, 100, "entry"), (10, 90, "graph.run"), (12, 20, "graph.key"), (20, 40, "graph.copy"),
           (100, 130, "sync"), (200, 300, "motion")]
    assert entry_split.innermost(ivs) == [
        (0, 10, "entry"), (10, 12, "graph.run"), (12, 20, "graph.key"), (20, 40, "graph.copy"),
        (40, 90, "graph.run"), (90, 100, "entry"), (100, 130, "sync"), (200, 300, "motion")]


def test_gaps_are_named_by_the_innermost_span():
    """Gaps under the key, the copy and the root's own time take those
    names, where an outermost label would name each ``entry``; a gap takes
    the span that covers most of it; time in no span is the harness's."""
    offset = 5_000  # the trace's clock less the host's
    busy = [(100, 950), (960, 1004), (1010, 1014), (1030, 1033), (1036, 2000)]  # us
    trace = types.SimpleNamespace(offset_ns=offset, open=offset, close=offset + 2_000_000,
                                  busy=[[offset + a * 1000, offset + b * 1000] for a, b in busy])
    log = types.SimpleNamespace(spans={"motion": [(0.0009, 0.001)], "entry": [(0.001, 0.0011)]})  # s
    rec = graph_frames(1)  # graph.run 1.000-1.100 ms: key 1.002-1.012, copy -1.032, replay 1.035-1.065, ...
    rec.spans[0] = ("graph.run", None, 1, 1_001_000, 1_099_000)
    want = {"harness": 100e-6, "motion": 10e-6, "graph.key": 6e-6, "graph.copy": 16e-6, "graph.run": 3e-6}
    rec.spans = [s for s in rec.spans if s[1] != "graph.capture" and s[1] != "prepared.run"]
    assert dict(entry_split.label_gaps(trace, log, rec.spans)) == pytest.approx(want)
    assert dict(entry_split.label_gaps(trace, log, [])) == pytest.approx(
        {"harness": 100e-6, "motion": 10e-6, "entry": 25e-6})


def test_the_compaction_tally_split():
    """The tally's growth over a window: frames by rung (the whole frame's
    last), the pixels shaded and covered over the frames' pixels; nothing
    where no frame was compacted (the K1 cells)."""
    pixels = 1920 * 1080
    before = [3, 0, 7, 0, 0, 1, 10, 20, 30]
    frames = [0, 1, 98, 0, 0, 1]  # 100 frames: 98 on rung 3/8, one on 2/8, one on the whole frame
    shaded = 1 * 270 * 1920 + 98 * 405 * 1920 + pixels
    covered = 100 * 557_000
    after = [b + g for b, g in zip(before, frames + [covered, shaded, 100 * pixels])]
    got = entry_split.compact_split(before, after)
    assert got["render.compact_frames"] == {"1/8": 0, "2/8": 1, "3/8": 98, "4/8": 0, "6/8": 0, "whole": 1}
    assert got["render.shaded_pct"] == pytest.approx(100.0 * shaded / (100 * pixels))
    assert got["render.covered_pct"] == pytest.approx(100.0 * 557_000 / pixels)
    assert entry_split.compact_split(before, before) == {}


def test_the_compaction_tally_split_reads_the_plain_compaction():
    """Read around plain compactions on the CPU: the tally the compaction
    adds to is the one the tool reads."""
    import torch

    from f_renderer_tpu_torch.pipeline import shade

    tally = shade.compact_tally(torch.device("cpu"))
    before = tally.tolist()
    winner = torch.full((16, 8), -1, dtype=torch.int32)
    winner[:3] = 0  # 24 of 128 covered: rung 2/8 (4 rows)
    shade.compact_planes_plain(torch.zeros((2, 16, 8)), torch.zeros((16, 8), dtype=torch.int32), winner)
    got = entry_split.compact_split(before, tally.tolist())
    assert got["render.compact_frames"]["2/8"] == 1 and sum(got["render.compact_frames"].values()) == 1
    assert got["render.shaded_pct"] == pytest.approx(25.0) and got["render.covered_pct"] == pytest.approx(18.75)


def test_the_voxel_split_from_hand_counts():
    """``VoxelRenderer``: ``voxel.entry`` around ``graph.run`` and its
    children, each read as the orbit cells' numbers are; the entry's self
    time is the conversions outside the graph's call; the frames' rays as a
    total."""
    rec = graph_frames(2)
    spans = []
    for name, parent, f, t0, t1 in rec.spans:
        if name == "graph.run":
            spans.append(("voxel.entry", None, f, t0 - 6_000, t1 + 4_000))
        spans.append((name, "voxel.entry" if name == "graph.run" else parent, f, t0, t1))
    rec.spans = spans
    for f in (1, 2):
        rec.counters[f]["voxel.rays"] = 518_400
    got = entry_split.split(rec, "voxel.entry")
    assert got["entry.graph_ms"] == pytest.approx(0.100) and got["entry.self_ms"] == pytest.approx(0.010)
    assert got["entry.key_ms"] == pytest.approx(0.010) and got["entry.clone_ms"] == pytest.approx(0.015)
    assert (got["graph.calls"], got["voxel.rays"]) == (2, 1_036_800)
    assert "voxel.rays" not in entry_split.split(graph_frames(2), "graph.run")
    assert entry_split.ROOT["voxel"] == "voxel.entry"


def test_the_march_split_reads_the_plain_march():
    """The march's work over two views of a level-2 octree at 48 × 36 on
    the CPU: the rays alive the set-up's, the point queries the plain
    march's, the hits the frame's pixels that a background of alpha 0
    tells apart; nothing where no ray meets the cube."""
    import numpy as np
    import torch

    from f_renderer_tpu_torch.voxel import VoxelRenderConfig, VoxelRenderer, octree, raycast

    color, hit = octree.densify(octree.gen_randomly(2, np.random.default_rng(5)), 2)
    inv = np.zeros((4, 4), np.float32)  # rays in the plane y = 1.1 (tests/test_torch_voxel.py: crafted_view)
    inv[0, 1] = 0.5
    inv[2, 0], inv[2, 2], inv[2, 3] = 1.0, 0.5, 0.5
    inv[3, 3] = 1.0
    cases = [{"eye": np.array([1.0, 1.1, -1.5], np.float32), "inv_mvp": inv},
             {"eye": np.array([0.9, 1.3, -1.2], np.float32), "inv_mvp": inv}]
    cfg = VoxelRenderConfig(width=48, height=36, level=2, length=2.0)
    port = VoxelRenderer(color, hit, cfg, device="cpu")
    clear = VoxelRenderer(color, hit, VoxelRenderConfig(width=48, height=36, level=2, length=2.0,
                                                        background=(0, 0, 0, 0)), device="cpu")
    alive = queries = hits = 0
    for c in cases:
        eye, inv_mvp = torch.as_tensor(c["eye"]), torch.as_tensor(c["inv_mvp"])
        rays = raycast.prepare_rays(eye, inv_mvp, cfg)
        _, q = raycast.march_plain(*rays, port.table, port.constants, count_queries=True)
        alive, queries = alive + int(rays[3].sum()), queries + int(q.sum())
        hits += int((clear(eye, inv_mvp)[..., 3] == 255).sum())
    assert 0 < hits < alive
    got = entry_split.voxel_split(port, cases)
    assert got == pytest.approx({"voxel.alive_pct": 100.0 * alive / (2 * 48 * 36),
                                 "voxel.queries_per_ray": queries / alive,
                                 "voxel.hit_pct": 100.0 * hits / (2 * 48 * 36)})
    away = {"eye": np.array([1.0, 50.0, -1.5], np.float32), "inv_mvp": inv}
    assert entry_split.voxel_split(port, [away]) == {}
