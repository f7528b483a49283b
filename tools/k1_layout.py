#!/usr/bin/env python3
"""K1's two pixel layouts at stress4k and phong1080, timed on the card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/k1_layout.py

The raster loop (csrc/raster_loop.cuh, ``tile_slot``) gives each warp an
8 x 8 patch of a tile's pixels, and interleaves the rows of a tile whose
fine and coarse ranges hold at least HEAVY_PAIRS = 256 pairs over its
blocks. That threshold was set at phong1080, where it takes the sphere's
two pole tiles; at stress4k it takes 460 of the 1,020 tiles. Copies of
csrc/ with HEAVY_PAIRS at 1 << 30 (patches in every tile) and at 0 (rows
interleaved in every tile) are built under f_renderer_tpu_torch/_build/
layout/, and K1 is timed with each library in turns (the checkout's,
patches, interleaved, the checkout's again) on stress4k and phong1080 at the
bench angle 0.10: device time (``chip_smoke.device_ms``), and every
variant's frame, depth and winner must equal the checkout kernel's.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HEAVY = "constexpr int HEAVY_PAIRS = 256;"
VARIANTS = {"patches everywhere": "1 << 30", "rows interleaved everywhere": "0"}


def variant_source(csrc: Path, slug: str, value: str) -> Path:
    """A copy of csrc/ whose raster loop has HEAVY_PAIRS = ``value``."""
    src = ROOT / "f_renderer_tpu_torch" / "_build" / "layout" / slug / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    loop = src / "raster_loop.cuh"
    text = loop.read_text()
    if text.count(HEAVY) != 1:
        raise RuntimeError(f"raster_loop.cuh no longer has {HEAVY!r} once: update the tool")
    loop.write_text(text.replace(HEAVY, f"constexpr int HEAVY_PAIRS = {value};"))
    return src


def use(kernels, csrc: Path, build: Path) -> None:
    """Point the kernel wrappers at the library built from ``csrc``."""
    kernels.CSRC, kernels.BUILD_DIR = csrc, build
    kernels.load_library.cache_clear()
    kernels.load_library()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_layout: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import fused
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    dev = torch.device("cuda", 0)
    checkout = (kernels.CSRC, kernels.BUILD_DIR)
    libraries = {"checkout": checkout}
    for label, value in VARIANTS.items():
        src = variant_source(checkout[0], label.split()[0], value)
        libraries[label] = (src, src.parent)
    cases = {}
    for name in ("stress4k", "phong1080"):
        scene = chip_smoke.build_scene(name, dev)
        chip_smoke.set_angle(scene, 0.10)
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        cases[name] = (fused.prep_fused(tri, scene.config), scene.pixel_shader, scene.ps_uniform, scene.config)
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    want = {}
    for label in ("checkout", *VARIANTS, "checkout"):
        use(kernels, *libraries[label])
        times = []
        for name, args in cases.items():
            got = fused.render_fused_prepared(*args)
            if name not in want:
                want[name] = got
            for part, a, b in zip(("frame", "depth", "winner"), got, want[name]):
                chip_smoke.check(torch.equal(a, b), f"{label}, {name}: K1 {part} differs from the checkout kernel's")
            launch = chip_smoke.kernel_call("fused_raster", lambda: fused.render_fused_prepared(*args))
            ms = [chip_smoke.device_ms(launch, 10) for _ in range(2)]
            times.append(f"{name} K1 {ms[0]:.4f} / {ms[1]:.4f} ms")
        print(f"[layout] {label}: {', '.join(times)} (device; {smi})", flush=True)
    use(kernels, *checkout)
    if chip_smoke.failures:
        print(f"k1_layout: {len(chip_smoke.failures)} check(s) failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
