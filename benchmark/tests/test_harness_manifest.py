"""BENCHMARK.json against the benchmark's contract, and the harness finding
every piece by name."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, scenes
from benchmark.meshes import cube, instanced_soup, uv_sphere

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths():
    assert set(MANIFEST) == TOP_KEYS
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(group):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)


def test_configs():
    keys = {"name", "source", "file", "reduced", "why"}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == keys
        assert one_line(c["source"]) and c["source"].startswith("https://") and one_line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert set(cfg["checks"]) <= {"bad_px_pct", "depth_bad_pct"}
        assert (ROOT / "benchmark/kinds" / f"{cfg['kind']}.py").is_file()
        assert all((ROOT / "benchmark/meshes" / f"{m['kind']}.py").is_file() for m in cfg["meshes"])
        files.add(c["file"])
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])
    assert len(files) == len(MANIFEST["configs"])
    assert len({c["source"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])


def test_workloads_resolve_by_name():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"]) and NAME.fullmatch(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.resolve(MANIFEST, ROOT, w["name"])
        assert (ROOT / "benchmark/drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"frame_ms", "frame_p95_ms", "setup_s"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] == "host_clock" and m["better"] in ("lower", "higher") and UNIT.fullmatch(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["better"] in ("lower", "higher") and UNIT.fullmatch(m["unit"])
        assert one_line(m["layer"]) and (ROOT / "benchmark/layers" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:  # each of its cells reports the metric it moves
            assert harness.reports(e2e[m["moves"]], cell)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_frozen_mesh_functions_equal_the_ports():
    from f_renderer_tpu_torch import scene

    for ours, theirs in ((uv_sphere.make_uv_sphere(8, 16, 0.7), scene.make_uv_sphere(8, 16, 0.7)),
                         (cube.make_cube(0.8), scene.make_cube(0.8)),
                         (instanced_soup.make_instanced_soup(500, seed=9, box=3.2),
                          scene.make_instanced_soup(500, seed=9, box=3.2))):
        for k, v in ours.items():
            np.testing.assert_array_equal(v, theirs[k])
    np.testing.assert_array_equal(scenes.make_checker_texture(32, 8), scene.make_checker_texture(32, 8))


def test_inputs_keep_their_shapes_across_seeds():
    cfg = json.loads((ROOT / "benchmark/configs/phong1080.json").read_text())
    a, b = scenes.scene_inputs(cfg, 1, stacks=2), scenes.scene_inputs(cfg, 2**31 + 12345, stacks=2)
    assert [m["pos"].shape for m in a.meshes] == [m["pos"].shape for m in b.meshes]
    assert all(t.dtype == np.uint8 and (t[..., 3] == 255).all() for s in a.stacks for t in s)
    assert not np.array_equal(a.stacks[0][0], b.stacks[0][0])
    assert not np.array_equal(a.stacks[0][0], a.stacks[1][0])


# A scene kind and a mesh kind that the benchmark does not have, for the
# test below: the triangle kind with its counts marked, and a tetrahedron.
STUB_KIND = '''"""The triangle kind, its reference's counts marked."""
from benchmark.kinds import triangle

scene_inputs = triangle.scene_inputs
per_frame = triangle.per_frame


def reference_frames(config, inputs, cases, device, **kw):
    out = triangle.reference_frames(config, inputs, cases, device, **kw)
    return {k: (frame, depth, dict(counts, stub=1)) for k, (frame, depth, counts) in out.items()}
'''
TETRA = '''"""A tetrahedron of half-edge ``size`` with flat normals."""
import numpy as np


def build(spec, seed):
    s = spec["size"]
    v = np.array([[s, s, s], [s, -s, -s], [-s, s, -s], [-s, -s, s]], np.float32)
    pos = np.stack([v[list(f)] for f in ((0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2))])
    n = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    uv = np.tile(np.array([[0, 0], [1, 0], [0, 1]], np.float32), (4, 1, 1))
    return {"pos": pos, "uv": uv, "normal": np.repeat(n[:, None], 3, axis=1)}
'''


def test_a_new_cell_needs_no_edit_of_an_existing_file(tmp_path):
    """A configuration of a new scene kind with a new mesh kind, a traffic
    mix and a cell entry, added as new files and a manifest entry: the
    copy's harness runs the cell with the new kind's reference, and git
    sees no change to a file the benchmark had."""
    from benchmark.tests.conftest import tiny_phong

    repo = tmp_path / "repo"
    (repo / "benchmark").mkdir(parents=True)
    shutil.copytree(ROOT / "benchmark", repo / "benchmark", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", repo / "BENCHMARK.json")
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t", "-C", str(repo)]
    subprocess.run([*git, "init", "-q"], check=True)
    subprocess.run([*git, "add", "-A"], check=True)
    subprocess.run([*git, "commit", "-qm", "base"], check=True)

    cfg = json.loads(tiny_phong(tmp_path).read_text())
    cfg.update(name="tiny_stub", kind="stub_kind")
    cfg["meshes"][2] = {"kind": "tetra", "size": 0.5, "offset": [-1.6, 0.0, 0.0]}
    (repo / "benchmark/configs/tiny_stub.json").write_text(json.dumps(cfg))
    (repo / "benchmark/kinds/stub_kind.py").write_text(STUB_KIND)
    (repo / "benchmark/meshes/tetra.py").write_text(TETRA)
    (repo / "benchmark/traffic/fast_orbit.json").write_text(json.dumps(
        {"driver": "closed_loop", "entry": "render", "motion": "turntable", "step_rad": 0.2, "turn_steps": 31,
         "in_flight": 1}))
    manifest = json.loads((repo / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny_stub", "source": "https://example.org/tiny", "why": "test",
                                "file": "benchmark/configs/tiny_stub.json", "reduced": []})
    manifest["workloads"].append({"name": "tiny_stub-fast_orbit", "config": "tiny_stub",
                                  "traffic": "fast_orbit", "chips": 1, "why": "test"})
    for m in manifest["per_layer"]:
        if m["name"] == "entry.host_ms":
            m["workloads"].append("tiny_stub-fast_orbit")
    (repo / "BENCHMARK.json").write_text(json.dumps(manifest))

    code = ("import json, sys; from pathlib import Path; sys.path[:0] = ['.', %r];"
            "from benchmark import harness; harness.WARM_UP_SECONDS = 0.05;"
            "assert Path(harness.__file__).resolve().parent == Path('benchmark').resolve();"
            "r, lines = harness.run_cell(harness.load_json(Path('BENCHMARK.json')), Path('.'),"
            " 'tiny_stub-fast_orbit', 5, 0.2, False, 0.0, device='cpu');"
            "print(*lines, sep='\\n', file=sys.stderr); print(json.dumps(r))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert "'stub': 1.0" in out.stderr  # the new kind's reference rendered the compared frames
    changed = subprocess.run([*git, "status", "--porcelain"], check=True, capture_output=True, text=True).stdout
    modified = [line for line in changed.splitlines() if not line.startswith("??")]
    assert modified == [" M BENCHMARK.json"]
