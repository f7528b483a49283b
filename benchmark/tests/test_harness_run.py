"""A run's outer behaviour: no card means no result, no forbidden module is
loaded, and the result line has the contract's shape."""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
COMMAND = [sys.executable, "benchmark/run.py", "--workload", "phong1080-orbit", "--seed", "3000000001",
           "--seconds", "1", "--trace", "0"]


def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")


def test_a_run_without_a_card_fails_and_prints_no_result():
    no_card()
    out = subprocess.run(COMMAND, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    with or without a card, the run exits with an error and no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(COMMAND, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name, found", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True),
    ("f_renderer_tpu", True), ("f_renderer_tpu.pipeline", True),
    ("f_renderer_tpu_torch.scene", False), ("jax_like", False), ("jaxtyping", False)])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, found):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) is found
    assert set(before) <= set(harness.forbidden_modules())


def test_the_harness_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness, compare, roofline, scenes, cupti, control;"
            "from benchmark.kinds import triangle; from benchmark.meshes import cube, uv_sphere, instanced_soup;"
            "from benchmark.drivers import closed_loop;"
            "import f_renderer_tpu_torch.scene, f_renderer_tpu_torch.display, f_renderer_tpu_torch.compiled;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import compare, scenes;"
            "from benchmark.kinds import triangle; from benchmark.meshes import cube, uv_sphere, instanced_soup;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('f_renderer')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell, trace", [("phong1080-orbit", False), ("phong1080-retexture", False),
                                         ("phong1080-orbit", True), ("phong1080-retexture", True)])
def test_the_result_line(manifest, quick, cell, trace):
    """A run on the CPU (no look for a card) gives the contract's keys, the
    cell's metrics by name and unit, and its checks under a key of their
    own, last; the standard error's last lines are the checks."""
    result, lines = harness.run_cell(manifest, ROOT, cell, 2**31 + 7, 0.2, trace, 0.0, device="cpu")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    c = harness.resolve(manifest, ROOT, cell)
    if not trace:
        assert {k: v["unit"] for k, v in result["metrics"].items()} == {m["name"]: m["unit"] for m in c.end_to_end}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    else:  # on the CPU only the host spans are there to read
        assert set(result["metrics"]) == {"entry.host_ms"}
    checks = result["checks"]
    assert set(checks) == {"bad_px_pct", "depth_bad_pct"}
    assert all(set(v) == {"value", "limit"} for v in checks.values())
    assert lines[-len(checks):] == [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    json.loads(json.dumps(result, allow_nan=False))


def test_main_prints_the_result_last(monkeypatch, capsys):
    result = {"correct": True, "attempted": 3, "failed": 0, "metrics": {}, "device": {}, "checks": {}}
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: (result, ["check x: 0 (limit 1)"]))
    assert harness.main(["--workload", "phong1080-orbit", "--seed", "1", "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert err.strip().splitlines()[-1] == "check x: 0 (limit 1)"
