"""The reference against the port on the CPU at a tiny size, the control
that has to fail, and a run whose timed path is broken underneath."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness, scenes
from benchmark.kinds import triangle
from benchmark.drivers.closed_loop import model_matrix
from benchmark.tests.conftest import tiny_phong

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def port_scene(cfg, inputs):
    from f_renderer_tpu_torch.camera import Camera
    from f_renderer_tpu_torch.scene import make_phong_scene

    cam = cfg["camera"]
    return make_phong_scene(cfg["width"], cfg["height"], meshes=inputs.meshes, textures=inputs.stacks[0],
                            camera=Camera.create(cam["eye"], cam["at"], cam["up"], device="cpu"),
                            clip_cap=cfg["clip_cap"], device="cpu")


def case(cfg, model):
    cam = cfg["camera"]
    return dict(model=model, **{k: np.float32(cam[k]) for k in ("eye", "at", "up")}, stack=0)


@pytest.mark.parametrize("eye, clip_cap, clipped", [([0.0, 0.5, 4.0], 64, False), ([0.3, 0.9, 1.9], 256, True)])
def test_reference_equals_the_port(tmp_path, eye, clip_cap, clipped):
    """Bit for bit at 160 × 90, at the bench camera and close in, where over
    a hundred faces clip."""
    cfg = json.loads(tiny_phong(tmp_path, clip_cap=clip_cap).read_text())
    cfg["camera"]["eye"] = eye
    inputs = scenes.scene_inputs(cfg, 11)
    scene = port_scene(cfg, inputs)
    for j in (0, 17, 40, 77):
        model = model_matrix(0.05 * j, CPU)
        scene.vs_uniform = dict(scene.vs_uniform, model=model)
        frame, depth, stats = scene.render()
        ref_frame, ref_depth, counts = triangle.reference_frames(cfg, inputs, {0: case(cfg, model)}, CPU)[0]
        assert (counts["clipped"] > 100) is clipped and counts["clipped"] == int(stats["num_clipped"])
        assert torch.equal(frame, ref_frame)
        assert torch.equal(depth, ref_depth)


def test_the_control_fails(tmp_path):
    """The reference in bfloat16 in the program's place fails both numbers'
    limits, on three seeds (at the cell's size the chip reads it:
    benchmark/control.py)."""
    cfg = json.loads(tiny_phong(tmp_path).read_text())
    for seed in (1, 2, 3):
        inputs = scenes.scene_inputs(cfg, seed, turn_steps=126)
        cases = {0: case(cfg, model_matrix(0.05 * inputs.start, CPU))}
        ref_frame, ref_depth, _ = triangle.reference_frames(cfg, inputs, cases, CPU)[0]
        low_frame, low_depth, _ = triangle.reference_frames(cfg, inputs, cases, CPU, dtype=torch.bfloat16)[0]
        got = compare.numbers(low_frame, low_depth, ref_frame, ref_depth)
        assert all(got[k] > cfg["checks"][k] for k in cfg["checks"]), got


def stale(fn):
    """A step that returns its first output again and again."""
    first = []

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if not first:
            first.append(tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in out))
        return first[0]
    return wrapped


def half_batch(fn):
    """The frame of half of each draw's faces: half the batch left out."""
    def wrapped(self, *a, **k):
        draws = self.draws
        self.draws = [{n: v[: v.shape[0] // 2] for n, v in d.items()} for d in draws]
        try:
            return fn(self, *a, **k)
        finally:
            self.draws = draws
    return wrapped


def altered(fn):
    """Each frame with one 16 × 32 tile of pixels altered where it is made."""
    def wrapped(*a, **k):
        frame, depth, *rest = fn(*a, **k)
        frame = frame.clone()
        frame[40:56, 64:96] ^= 0x40
        return (frame, depth, *rest)
    return wrapped


FAULTS = {"stale": stale, "half_batch": lambda fn: half_batch(fn), "altered": altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["phong1080-orbit", "phong1080-retexture"])
def test_a_broken_timed_path_is_not_correct(manifest, quick, monkeypatch, cell, fault):
    """The rest of a run (no look for a card) with the port's entry point
    broken underneath: ``correct`` comes out false. The run is on one chip,
    so no exchange between chips can be left out."""
    from f_renderer_tpu_torch.scene import Scene

    entry = "render_prepared" if cell.endswith("retexture") else "render"
    if fault == "half_batch" and entry == "render_prepared":
        monkeypatch.setattr(Scene, "prepare", half_batch(Scene.prepare))
    else:
        monkeypatch.setattr(Scene, entry, FAULTS[fault](getattr(Scene, entry)))
    result, _ = harness.run_cell(manifest, ROOT, cell, 99, 0.2, False, 0.0, device="cpu")
    assert result["correct"] is False, result["checks"]


def test_sound_run_is_correct(manifest, quick):
    result, _ = harness.run_cell(manifest, ROOT, "phong1080-orbit", 99, 0.2, False, 0.0, device="cpu")
    assert result["correct"] is True and all(v["value"] == 0.0 for v in result["checks"].values())


@pytest.mark.parametrize("fault", ["frame_without_depth", "misspelt_limit", "no_frame"])
def test_a_limit_with_no_number_stops_the_run(tmp_path, fault):
    """Every limit of the configuration is compared, or the run gives no
    result: a limit is never dropped for want of its number."""
    cfg = json.loads(tiny_phong(tmp_path).read_text())
    inputs = scenes.scene_inputs(cfg, 4)
    cases = {0: case(cfg, model_matrix(0.0, CPU))}
    frame, depth, _ = triangle.reference_frames(cfg, inputs, cases, CPU)[0]
    checks, _ = compare.check_frames(cfg, triangle, inputs, {0: (frame, depth)}, cases, CPU)
    assert set(checks) == set(cfg["checks"]) and all(c["value"] == 0.0 for c in checks.values())
    kept = {0: (frame, depth)}
    if fault == "frame_without_depth":
        kept = {0: (frame, None)}
    elif fault == "misspelt_limit":
        cfg["checks"]["bad_px_pt"] = 0.01
    else:
        kept = {}
    with pytest.raises(harness.HarnessError, match="no compared number"):
        compare.check_frames(cfg, triangle, inputs, kept, cases, CPU)
