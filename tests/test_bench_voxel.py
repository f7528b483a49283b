"""The benchmark's voxel kind (``benchmark/kinds/voxel.py``) and the
voxel540-orbit cell, against the port.

On the CPU at 96 × 54, level 3, fixed steps:

- the kind's frozen octree generator and densification equal the port's
  on several seeds, and its node tables the port's ``flatten``;
- the plain reference (a descent of the octree itself, never the dense
  grids) renders the same frames as the port's ``VoxelRenderer`` on the
  CPU, three seeds × three orbit views, with no pixel off;
- ``compare.check_frames`` fails a stale view (the previous step's frame)
  and a frame of the port's grids with one leaf recoloured;
- the reference's counts a frame, the inputs' shapes across seeds, the
  least work of a frame by hand, and the cell run through the harness;
- ``raycast.march_frame`` counts ``voxel.rays`` under
  ``metrics.tracing()``, and ``VoxelRenderer`` opens ``voxel.entry``.

On the card (``cuda``): ``tools/entry_split.py``'s march split on
voxel540's views against the set-up's rays alive and the captured frames'
hits. Run there with ``python -m pytest --noconftest -m cuda
tests/test_bench_voxel.py -q``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.kinds import voxel as kind
from f_renderer_tpu_torch.utils import metrics
from f_renderer_tpu_torch.voxel import VoxelRenderConfig, VoxelRenderer, octree, raycast

from _torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread: see that file)

ROOT = Path(__file__).resolve().parents[1]
CELL = "voxel540-orbit"
CONFIG = json.loads((ROOT / "benchmark/configs/voxel540.json").read_text())
TRAFFIC = json.loads((ROOT / "benchmark/traffic/voxel_orbit.json").read_text())
SMALL = dict(CONFIG, width=96, height=54)
SEEDS = (7, 2**31 + 12345, 98765432101)
VIEWS = (0, 31, 64)
CPU = torch.device("cpu")


def renderer(config, grid_color, grid_hit, device="cpu"):
    cfg = VoxelRenderConfig(width=config["width"], height=config["height"], level=config["level"],
                            length=config["length"], background=tuple(config["background"]),
                            traversal=config["traversal"])
    return VoxelRenderer(grid_color, grid_hit, cfg, device=device)


def case(config, step):
    eye, inv_mvp = kind.orbit_view(config, TRAFFIC, step)
    return {"eye": eye, "inv_mvp": inv_mvp}


@pytest.mark.parametrize("seed", [1, 5, 2**31 + 3, 10**11 + 7])
def test_the_frozen_octree_is_the_ports(seed):
    """The same tree, grids and node tables from the same generator."""
    theirs = octree.gen_randomly(3, np.random.default_rng([seed, 7]))
    ours = kind.gen_randomly(3, np.random.default_rng([seed, 7]))
    for a, b in zip(kind.densify(ours, 3), octree.densify(theirs, 3)):
        np.testing.assert_array_equal(a, b)
    tree, flat = kind.node_tables(ours), octree.flatten(theirs)
    np.testing.assert_array_equal(tree.valid, flat.valid_mask)
    np.testing.assert_array_equal(tree.leaf, flat.leaf_mask)
    np.testing.assert_array_equal(tree.child, flat.child_index)
    np.testing.assert_array_equal(tree.color, flat.leaf_color)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", VIEWS)
def test_the_reference_equals_the_port(seed, step):
    """Every pixel of three orbit views on three seeds, within the limit
    and read to 0: the reference's octree descent and the port's dense
    table march give the same BGRA frame."""
    inputs = kind.scene_inputs(SMALL, seed, TRAFFIC)
    c = case(SMALL, step)
    got = renderer(SMALL, inputs.grid_color, inputs.grid_hit)(c["eye"], c["inv_mvp"])
    ref, depth, counts = kind.reference_frames(SMALL, inputs, {0: c}, CPU)[0]
    assert depth is None and ref.shape == got.shape == (54, 96, 4) and ref.dtype == torch.uint8
    assert compare.numbers(got, None, ref, None) == {"bad_px_pct": 0.0}
    assert torch.equal(got, ref)
    assert counts["rays"] == 96 * 54 and 0 < counts["hits"] <= counts["alive"] < counts["rays"]
    assert counts["cells"] >= counts["alive"]


def recolour_one_leaf(grid_color, frame):
    """The port's grids with the leaf that colours most of ``frame``'s hit
    pixels given the colour's complement (its cells are those of exactly
    that colour)."""
    bgr = frame[..., :3].reshape(-1, 3)
    hit = frame[..., 3].reshape(-1) == 255
    colours, n = np.unique(bgr[hit & (bgr.sum(-1) > 0)], axis=0, return_counts=True)
    target = colours[np.argmax(n)]
    cells = (grid_color[..., :3] == target).all(-1)
    out = grid_color.copy()
    out[cells, :3] = 255 - target
    return out


def test_the_comparison_fails_a_stale_view_and_a_recoloured_leaf():
    """A frame of the previous orbit step in place of the frame, and a
    frame of the port's grids with one leaf recoloured (the reference's
    tree unchanged), each fail ``bad_px_pct``'s limit."""
    seed = SEEDS[1]
    inputs = kind.scene_inputs(SMALL, seed, TRAFFIC)
    port = renderer(SMALL, inputs.grid_color, inputs.grid_hit)
    cases = {k: case(SMALL, 40 + k) for k in range(2)}
    frames = {k: port(c["eye"], c["inv_mvp"]) for k, c in cases.items()}
    checks, _ = compare.check_frames(SMALL, kind, inputs, {0: (frames[1], None)}, {0: cases[0]}, CPU)
    assert checks["bad_px_pct"]["value"] > 10 * checks["bad_px_pct"]["limit"]
    recoloured = recolour_one_leaf(inputs.grid_color, frames[1].numpy())
    port2 = renderer(SMALL, recoloured, inputs.grid_hit)
    kept = {1: (port2(cases[1]["eye"], cases[1]["inv_mvp"]), None)}
    checks, _ = compare.check_frames(SMALL, kind, inputs, kept, {1: cases[1]}, CPU)
    assert checks["bad_px_pct"]["value"] > checks["bad_px_pct"]["limit"]
    checks, _ = compare.check_frames(SMALL, kind, inputs, {1: (frames[1], None)}, {1: cases[1]}, CPU)
    assert checks["bad_px_pct"]["value"] == 0.0


def test_the_inputs_keep_their_shapes_across_seeds():
    """The grids' shapes and the table never depend on the seed; the tree's
    values and node count do; the orbit's start lies in its steps."""
    a, b = kind.scene_inputs(CONFIG, 1, TRAFFIC), kind.scene_inputs(CONFIG, 2**31 + 12345, TRAFFIC)
    assert a.grid_color.shape == b.grid_color.shape == (16, 16, 16, 4) and a.grid_color.dtype == np.uint8
    assert a.grid_hit.shape == b.grid_hit.shape == (16, 16, 16) and a.grid_hit.dtype == bool
    assert not np.array_equal(a.grid_color, b.grid_color)
    assert a.tree.color.shape[1:] == (8, 4) and a.tree.valid.shape[0] == a.tree.color.shape[0]
    assert all(0 <= x.start < TRAFFIC["turn_steps"] for x in (a, b))
    np.testing.assert_array_equal(a.grid_color, kind.scene_inputs(CONFIG, 1, TRAFFIC).grid_color)


def test_the_least_work_of_a_frame_by_hand():
    """The frame written once, the table read once, the inputs; 268
    operations a ray and 9 + 12 · 4 a cell crossed at level 3."""
    counts = {"rays": 518_400.0, "alive": 250_000.0, "cells": 900_000.0, "hits": 200_000.0}
    work = kind.per_frame(CONFIG, TRAFFIC, None, counts)
    nbytes = 960 * 540 * 4 + 16**3 * 4 + 76
    ops = 518_400 * 268 + 900_000 * 57
    assert work == {"frame_bytes": nbytes, "frame_ops": ops, "voxel_bytes": nbytes, "voxel_ops": ops}


def test_the_cell_runs_through_the_harness(tmp_path):
    """voxel540-orbit at 96 × 54 on the CPU through ``run_cell``, in a
    process of its own (the harness refuses a process that loaded JAX, as
    this suite's does): its driver on ``VoxelRenderer``, the reference's
    counts, ``correct``."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    path = tmp_path / "voxel_small.json"
    path.write_text(json.dumps(SMALL))
    for c in manifest["configs"]:
        if c["name"] == "voxel540":
            c["file"] = str(path)
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    code = ("import json, sys; from pathlib import Path; sys.path.insert(0, '.'); import torch;"
            "torch.set_num_threads(1); from benchmark import harness; harness.WARM_UP_SECONDS = 0.05;"
            f"r, lines = harness.run_cell(harness.load_json(Path({str(tmp_path / 'manifest.json')!r})), Path('.'),"
            f" {CELL!r}, 2**33 + 5, 0.3, False, 0.0, device='cpu');"
            "print(*lines, sep='\\n', file=sys.stderr); print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["checks"] == {"bad_px_pct": {"value": 0.0, "limit": 0.01}}
    assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert "'cells'" in out.stderr


def test_the_manifest_entries():
    """One one-chip cell on voxel540, nothing cut; its two metrics reported
    there alone; it is in no list of the triangle stages."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = {c["name"]: c for c in manifest["configs"]}["voxel540"]
    assert config["reduced"] == CONFIG["reduced"] == [] and CONFIG["kind"] == "voxel"
    cells = [w for w in manifest["workloads"] if w["config"] == "voxel540"]
    assert [(w["name"], w["traffic"], w["chips"]) for w in cells] == [(CELL, "voxel_orbit", 1)]
    per_layer = {m["name"]: m for m in manifest["per_layer"]}
    for name in ("voxel_roofline", "march.device_ms"):
        assert per_layer[name]["workloads"] == [CELL] and per_layer[name]["moves"] == "frame_ms"
    for name in ("raster_roofline", "setup.device_ms", "planes_roofline", "shade.device_ms"):
        assert CELL not in per_layer[name]["workloads"]


def test_the_kind_and_the_driver_import_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.'); from benchmark.kinds import voxel;"
            "from benchmark.drivers import voxel_orbit;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('f_renderer') or m == 'jax'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_voxel_counter_and_span_on_the_cpu():
    """Under ``metrics.tracing()`` a ``VoxelRenderer`` call is the span
    ``voxel.entry`` with the frame's rays counted; ``voxel_frame`` counts
    them with no span."""
    inputs = kind.scene_inputs(SMALL, 3, TRAFFIC)
    port = renderer(SMALL, inputs.grid_color, inputs.grid_hit)
    c = case(SMALL, 12)
    eye, inv_mvp = (torch.as_tensor(c[k]) for k in ("eye", "inv_mvp"))
    with metrics.tracing() as rec:
        frame = port(eye, inv_mvp)
    assert [s[:3] for s in rec.spans] == [("voxel.entry", None, 1)]
    assert rec.counters == {1: {"voxel.rays": 96 * 54}}
    with metrics.tracing() as rec:
        again = raycast.voxel_frame(torch.as_tensor(inputs.grid_color), torch.as_tensor(inputs.grid_hit), eye,
                                    inv_mvp, port.config)
    assert rec.spans == [] and rec.counters == {0: {"voxel.rays": 96 * 54}}
    assert torch.equal(frame, again)


@pytest.mark.cuda
def test_the_march_split_on_the_card():
    """``tools/entry_split.py``'s march split on voxel540's views on the
    card: its rays alive the set-up kernel's, its hits the captured
    frames' leaf pixels (no leaf is black), at least one point query a ray
    alive."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from f_renderer_tpu_torch import compiled

    sys.path.insert(0, str(ROOT / "tools"))
    import entry_split

    dev = torch.device("cuda", torch.cuda.current_device())
    inputs = kind.scene_inputs(CONFIG, 2**31 + 77, TRAFFIC)
    assert not (inputs.grid_hit & (inputs.grid_color[..., :3] == 0).all(-1)).any()
    port = renderer(CONFIG, inputs.grid_color, inputs.grid_hit, device=dev)
    cases = [case(CONFIG, step) for step in (0, 40)]
    alive = hits = 0
    for c in cases:
        eye, inv_mvp = (torch.as_tensor(c[k], device=dev) for k in ("eye", "inv_mvp"))
        alive += int(raycast.prepare_rays(eye, inv_mvp, port.config)[3].sum())
        for _ in range(3):  # the warm-up frame, the capture, a replay
            frame = port(eye, inv_mvp)
        hits += int((frame[..., :3] != 0).any(-1).sum())
    got = entry_split.voxel_split(port, cases)
    rays = len(cases) * CONFIG["width"] * CONFIG["height"]
    assert 0 < hits < alive
    assert got["voxel.alive_pct"] == pytest.approx(100.0 * alive / rays)
    assert got["voxel.hit_pct"] == pytest.approx(100.0 * hits / rays)
    assert got["voxel.queries_per_ray"] >= 1.0
    compiled.CACHE.clear()
