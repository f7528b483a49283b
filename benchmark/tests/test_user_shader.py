"""custom_tex1080: phong.rs's pixel shader as user code (``shaders/phong_rs.py``)
on the port's planes path, held to the plain reference (``kinds/user_shader.py``,
the triangle kind's frame) on the CPU at 160 × 90; its cell's run, driver and
manifest entries; and the least work of K4's planes by hand."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness, scenes
from benchmark.drivers.closed_loop import model_matrix
from benchmark.kinds import triangle, user_shader
from benchmark.shaders import phong_rs
from benchmark.tests.conftest import tiny_phong

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
CELL = "custom_tex1080-orbit"


def tiny_user(tmp_path, **changes) -> dict:
    """custom_tex1080 cut as the harness's tests cut phong1080: 160 × 90, an
    8 × 16 sphere, 32² maps."""
    tiny = json.loads(tiny_phong(tmp_path, **changes).read_text())
    cfg = json.loads((ROOT / "benchmark/configs/custom_tex1080.json").read_text())
    cfg.update({k: tiny[k] for k in ("width", "height", "meshes", "textures", *changes)})
    return cfg


@pytest.fixture
def manifest(tmp_path):
    """BENCHMARK.json with custom_tex1080 at 160 × 90."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    path = tmp_path / "tiny_user.json"
    path.write_text(json.dumps(tiny_user(tmp_path)))
    for c in m["configs"]:
        if c["name"] == "custom_tex1080":
            c["file"] = str(path)
    return m


def port_scene(cfg, inputs):
    """The port's scene as the cell's driver builds it: the builtin Phong
    vertex stage, the user's pixel shader."""
    from f_renderer_tpu_torch.camera import Camera
    from f_renderer_tpu_torch.scene import make_phong_scene

    cam = cfg["camera"]
    scene = make_phong_scene(cfg["width"], cfg["height"], meshes=inputs.meshes, textures=inputs.stacks[0],
                             camera=Camera.create(cam["eye"], cam["at"], cam["up"], device="cpu"),
                             clip_cap=cfg["clip_cap"], shader=cfg["shader"], device="cpu")
    scene.pixel_shader = phong_rs.pixel
    return scene


def case(cfg, model):
    cam = cfg["camera"]
    return dict(model=model, **{k: np.float32(cam[k]) for k in ("eye", "at", "up")}, stack=0)


def reference_planes(cfg, inputs, model):
    """The reference's winners and its interpolated varyings, (C, H, W) with
    NaN where nothing covers a pixel, and each pixel's texture id (-1 there)."""
    cam = cfg["camera"]
    eye, at, up = (torch.tensor(cam[k], dtype=torch.float32) for k in ("eye", "at", "up"))
    view, proj = triangle.camera_matrices(cfg, eye, at, up, torch.float32)
    meshes = [{k: torch.as_tensor(v) for k, v in m.items()} for m in inputs.meshes]
    tri = triangle.geometry(meshes, model, view, proj, cfg["width"], cfg["height"], torch.float32)
    winner, depth = triangle.raster(tri, cfg["width"], cfg["height"])
    pix, t, ctx = triangle.interpolate(tri, winner, depth)
    planes = torch.full((ctx.shape[0], winner.numel()), float("nan"))
    planes[:, pix] = ctx
    ps = torch.full((winner.numel(),), -1, dtype=torch.int64)
    ps[pix] = tri.ps[t]
    return planes.view(-1, *winner.shape), ps.view(winner.shape)


def test_the_users_shader_on_the_port_against_the_reference(tmp_path):
    """At four angles of the turntable: the planes the user's shader is
    given (each varying of each pixel's winner, the texture id; background
    where nothing covers) bit-equal to the reference's, the depth bit-equal,
    and the colour within the cell's limits. The colour need not be
    bit-equal: the user writes the Phong sum in their own order and
    rounding (``torch.linalg.vector_norm`` and a divide to normalize,
    ``** 32``), where the reference takes a correctly rounded reciprocal
    square root and five squarings, so a channel may differ by a step of
    the pack's truncation."""
    cfg = tiny_user(tmp_path)
    inputs = scenes.scene_inputs(cfg, 11)
    scene = port_scene(cfg, inputs)
    seen = []

    def pixel(u, ctx, ps_index):
        seen.append((torch.cat([ctx["normal"], ctx["pos"], ctx["uv"]]), ps_index.clone()))
        return phong_rs.pixel(u, ctx, ps_index)

    scene.pixel_shader = pixel
    for j in (0, 17, 40, 77):
        model = model_matrix(0.05 * j, CPU)
        scene.vs_uniform = dict(scene.vs_uniform, model=model)
        frame, depth, _ = scene.render()
        planes, ps = reference_planes(cfg, inputs, model)
        got_planes, got_ps = seen.pop()
        covered = ps >= 0
        assert 1000 < int(covered.sum()) < cfg["width"] * cfg["height"]
        assert torch.equal(got_ps, ps)
        assert torch.equal(got_planes[:, covered], planes[:, covered])
        ref_frame, ref_depth, _ = triangle.reference_frames(cfg, inputs, {0: case(cfg, model)}, CPU)[0]
        assert torch.equal(depth, ref_depth)
        assert torch.equal(frame[~covered], ref_frame[~covered])
        got = compare.numbers(frame, depth, ref_frame, ref_depth)
        assert all(got[k] <= cfg["checks"][k] for k in cfg["checks"]), got
        assert int((frame.to(torch.int16) - ref_frame.to(torch.int16)).abs().max()) <= compare.COLOR_TOL


def test_the_reference_never_calls_the_users_shader(tmp_path):
    """A fault in the user's shader (an exponent of 16, the ambient dropped)
    shows against the reference, and the bfloat16 control fails both
    limits, as at the cell's size on the card (``control.py``)."""
    cfg = tiny_user(tmp_path)
    inputs = scenes.scene_inputs(cfg, 3, turn_steps=126)
    model = model_matrix(0.05 * inputs.start, CPU)
    cases = {0: case(cfg, model)}
    ref_frame, ref_depth, _ = user_shader.reference_frames(cfg, inputs, cases, CPU)[0]
    low_frame, low_depth, _ = user_shader.reference_frames(cfg, inputs, cases, CPU, dtype=torch.bfloat16)[0]
    got = compare.numbers(low_frame, low_depth, ref_frame, ref_depth)
    assert all(got[k] > cfg["checks"][k] for k in cfg["checks"]), got
    for name, value in (("SHININESS", 16), ("AMBIENT_STRENGTH", 0.0)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(phong_rs, name, value)
            scene = port_scene(cfg, inputs)
            scene.vs_uniform = dict(scene.vs_uniform, model=model)
            frame, depth, _ = scene.render()
        got = compare.numbers(frame, depth, ref_frame, ref_depth)
        assert got["bad_px_pct"] > cfg["checks"]["bad_px_pct"] and got["depth_bad_pct"] == 0.0, (name, got)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_of_the_cell_is_correct(manifest, quick, trace):
    """The cell's run on the CPU (no look for a card): its driver installs
    the user's shader and ``correct`` comes out true with both numbers 0."""
    result, lines = harness.run_cell(manifest, ROOT, CELL, 4_000_000_007, 0.2, trace, 0.0, device="cpu")
    assert result["correct"] is True and all(v["value"] == 0.0 for v in result["checks"].values()), lines
    assert result["failed"] == 0 and result["attempted"] > 0 and result["device"]["platform"] == "cpu"
    if not trace:
        assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    else:  # no device trace on the CPU: only the host's entry time
        assert set(result["metrics"]) == {"entry.host_ms"}


def test_the_driver_installs_the_users_shader(manifest, quick):
    session = harness.start(manifest, ROOT, CELL, 5, "cpu")
    scene = session.driver.scene
    assert scene.pixel_shader is phong_rs.pixel and not hasattr(scene.pixel_shader, "fused_kind")
    assert scene.vertex_shader.fused_kind == "phong" and session.driver.entry == "render"
    session.driver.release()
    cell = harness.resolve(manifest, ROOT, CELL)
    cell.traffic = dict(cell.traffic, entry="render_prepared", motion="retexture")
    with pytest.raises(ValueError, match="render"):
        type(session.driver)(harness.Session(cell, 5, CPU, session.inputs, []))


def test_planes_work_by_hand():
    """K4's least work at 1080p with C = 8: 6,424 triangles of 3 · (3 + 8)
    words read, the winner, depth and 8 planes of 4 bytes written at each of
    1920 · 1080 pixels; 92 operations a covered pixel. The rest is the
    triangle kind's count."""
    cfg = json.loads((ROOT / "benchmark/configs/custom_tex1080.json").read_text())
    inputs = scenes.scene_inputs(cfg, 1)
    counts = {"emitted": 6424, "covered": 500_000, "texels": 400_000}
    w = user_shader.per_frame(cfg, {"entry": "render"}, inputs, counts)
    assert w["planes_bytes"] == 6424 * 3 * 11 * 4 + 1920 * 1080 * 10 * 4
    assert w["planes_ops"] == 500_000 * (15 + 20 + 9 + 1 + 7 + 8 * 5) == 500_000 * 92
    base = triangle.per_frame(cfg, {"entry": "render"}, inputs, counts)
    assert {k: v for k, v in w.items() if not k.startswith("planes_")} == base


def test_the_configuration_is_phong1080s_scene():
    """Every key of phong1080's file but its name, source, kind and
    assumptions is unchanged; the new keys name the user's shader."""
    ours = json.loads((ROOT / "benchmark/configs/custom_tex1080.json").read_text())
    theirs = json.loads((ROOT / "benchmark/configs/phong1080.json").read_text())
    own = {"name", "source", "kind", "assumed", "pixel_shader"}
    assert {k: v for k, v in ours.items() if k not in own} == {k: v for k, v in theirs.items() if k not in own}
    assert (ours["kind"], ours["pixel_shader"], ours["shader"], ours["reduced"]) == ("user_shader", "phong_rs",
                                                                                    "phong", [])
    assert ours["assumed"][:len(theirs["assumed"])] == theirs["assumed"]


def test_the_manifest_entries():
    """One one-chip cell on custom_tex1080 under orbit_user; its two
    metrics reported there alone; it is in the five lists the device and
    entry metrics keep, and out of raster_roofline, whose work counts the
    Phong sum inside its stage's kernels."""
    cells = [w for w in MANIFEST["workloads"] if w["config"] == "custom_tex1080"]
    assert [(w["name"], w["traffic"], w["chips"]) for w in cells] == [(CELL, "orbit_user", 1)]
    per_layer = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in ("planes_roofline", "shade.device_ms"):
        assert per_layer[name]["workloads"] == [CELL] and per_layer[name]["moves"] == "frame_ms"
        assert per_layer[name]["layer"] == per_layer["raster_roofline"]["layer"]
    for name in ("entry.host_ms", "device.idle_pct", "device.busy_ms", "frame_roofline", "setup.device_ms"):
        assert per_layer[name]["workloads"][-1] == CELL
    assert CELL not in per_layer["raster_roofline"]["workloads"]
    traffic = json.loads((ROOT / "benchmark/traffic/orbit_user.json").read_text())
    orbit = json.loads((ROOT / "benchmark/traffic/orbit.json").read_text())
    assert dict(traffic, driver="closed_loop") == orbit


def test_the_shader_and_the_kind_import_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.'); from benchmark.kinds import user_shader;"
            "from benchmark.shaders import phong_rs;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('f_renderer') or m == 'jax'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
