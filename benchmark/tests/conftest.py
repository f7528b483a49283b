"""Fixtures of the harness's CPU tests: the manifest with phong1080 cut to a
size the CPU renders in a fraction of a second."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def tiny_phong(tmp_path: Path, **changes) -> Path:
    """phong1080's config at 160 × 90 with an 8 × 16 sphere and 32² maps."""
    cfg = json.loads((ROOT / "benchmark/configs/phong1080.json").read_text())
    cfg.update(width=160, height=90, **changes)
    cfg["meshes"][0].update(n_lat=8, n_lon=16)
    cfg["textures"] = [{"n": 32, "cell": 4}, {"n": 32, "cell": 8}, {"n": 32, "cell": 2}]
    path = tmp_path / "tiny_phong.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture
def manifest(tmp_path):
    """BENCHMARK.json with phong1080 at 160 × 90."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in m["configs"]:
        if c["name"] == "phong1080":
            c["file"] = str(tiny_phong(tmp_path))
    return m


@pytest.fixture
def quick(monkeypatch):
    """A warm-up of a few frames, not a second."""
    from benchmark import harness

    monkeypatch.setattr(harness, "WARM_UP_SECONDS", 0.05)
