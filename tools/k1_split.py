#!/usr/bin/env python3
"""K1's time at stress4k and phong1080 split into its parts, on the card
(and K4's, which runs the same loop, at phong1080_tex2048 and custom12_360).

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/k1_split.py

(in a checkout of another commit, beside its own package, it splits that
commit's kernel). Each probe is a copy of the checkout's csrc/ with a few
lines of the raster loop (csrc/raster_loop.cuh) replaced, built under
f_renderer_tpu_torch/_build/split/. K1 is timed with each library in turns,
the unchanged copy first and last (device time, ``chip_smoke.device_ms``;
K4 ``rasterize_interp``):

- full: the copy as it is;
- staging alone: the ballot forced false, so the blocks stage every chunk of
  their tile's list and walk no pair;
- staging + ballot: every warp tests the staged bboxes and ballots, then
  walks no pair;
- fine range only: the tiles' lists hold their fine range alone;
- every tile overflows: the plan pass culls, but every tile stages its
  three ranges whole; and with no cull: the plan pass places the tiles and
  culls nothing;
- no row selection: every block of a tile of patches stages the tile's
  whole list;
- tile read alone: the raster blocks exit once they have read their tile's
  descriptor, so the kernel is the pass before them and the launch;
- each layout forced in every tile;
- K1's early depth test: off, in the ballot alone, at the pixels alone, and
  in the ballot against one least depth a warp (not one a row step).

A probe leaves out work, so its pixels differ from the kernel's (where a
spill or coarse pair wins, or everywhere when nothing is walked): only its
time is read. A probe whose lines are not in the copy is reported and
skipped.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# Each probe: a list of (old, new) replacements in raster_loop.cuh, made
# where every old line is in the copy, once.
BALLOT = "uint32_t mask = __ballot_sync(0xFFFFFFFFu, touch);"
CHUNK_LOOP_END = "before it is refilled\n  }\n"
LAYOUT = "at.patch = (at.d.flags & TILE_ROWS) == 0;"
PATCH_WALK = "walk_tile<R, true, kDepthTest>"
ROWS_WALK = "walk_tile<R, false, kDepthTest>"
PIXEL_TEST = "          if (kDepthTest && dep[r] > pr.reach) continue;  // the pixel is deeper than the pair can reach\n"
BALLOT_TEST = " &&\n                  !(kDepthTest && least[r] > reach)"
PROBES = {
    "staging alone": [
        ("touch = rows && (mn & 0xFFFF) < wr.x0 + wr.cols && (mx & 0xFFFF) > wr.x0;", "touch = false;"),
    ],
    "staging + ballot": [
        ("for (int ci = 0; ci < nchunks; ++ci) {", "uint32_t sink = 0;\n  for (int ci = 0; ci < nchunks; ++ci) {"),
        (BALLOT, BALLOT + " sink += mask; mask = 0u;"),
        (CHUNK_LOOP_END, CHUNK_LOOP_END + "  if (sink == 0x7FFFFFFFu) wpair[0] = 0;\n"),
    ],
    "fine range only": [("d.total = w + kept;", "d.total = w;"), ("d.total = w + n;", "d.len01 = w; d.total = w;")],
    "every tile overflows": [
        ("if (kept <= cap) {", "if (false) {"),
    ],
    "every tile overflows, no cull": [
        ("if (kept <= cap) {", "if (false) {"),
        ("  for (int v0 = 0; v0 < n; v0 += PLAN_ROUND) {", "  for (int v0 = 0; v0 < 0; v0 += PLAN_ROUND) {"),
    ],
    "no row selection": [
        ("  if (!kPatch || total <= CHUNK) {", "  if (true) {"),
    ],
    "tile read alone": [
        ("    at.step = TY * S;\n  }\n  return at;",
         "    at.step = TY * S;\n  }\n  if (at.d.t >= 0) asm volatile(\"exit;\");\n  return at;"),
    ],
    "patches everywhere": [(LAYOUT, "at.patch = true;")],
    "rows everywhere": [(LAYOUT, "at.patch = false;")],
    "no early depth test": [(PATCH_WALK, PATCH_WALK.replace("kDepthTest>", "false>")),
                            (ROWS_WALK, ROWS_WALK.replace("kDepthTest>", "false>"))],
    "early depth test in the ballot alone": [(PIXEL_TEST, "")],
    "early depth test at the pixels alone": [(BALLOT_TEST, "")],
    "early depth test, one least a warp": [(BALLOT_TEST, BALLOT_TEST.replace("least[r]", "fminf(least[0], least[R - 1])"))],
}


def patched(text: str, edits) -> str | None:
    """``text`` with ``edits`` made, or None unless each old text is in it
    once."""
    if not all(text.count(old) == 1 for old, _ in edits):
        return None
    for old, new in edits:
        text = text.replace(old, new)
    return text


def variant(csrc: Path, slug: str, edits) -> Path | None:
    """A copy of ``csrc`` under _build/split/<slug>/ with a probe's edits
    made in its raster loop → the copy, or None where they do not apply."""
    src = ROOT / "f_renderer_tpu_torch" / "_build" / "split" / slug / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    loop = src / "raster_loop.cuh"
    text = patched(loop.read_text(), edits)
    if text is None:
        return None
    loop.write_text(text)
    return src


def build_all(sources) -> None:
    """Build every copy's library at once, one process each (each runs one
    nvcc a source, all together)."""
    code = ("import sys; from pathlib import Path; sys.path.insert(0, {root!r}); "
            "from f_renderer_tpu_torch import kernels; kernels.CSRC = Path({src!r}); "
            "kernels.BUILD_DIR = Path({src!r}).parent; kernels.load_library()")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(root=str(ROOT), src=str(s))]) for s in sources]
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError("a probe build failed")


def use(kernels, csrc: Path) -> None:
    """Point the kernel wrappers at the library built from ``csrc``."""
    kernels.CSRC, kernels.BUILD_DIR = csrc, csrc.parent
    kernels.load_library.cache_clear()
    kernels.load_library()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--probes", nargs="*", default=None, help="the probes to run, by label (default: all)")
    parser.add_argument("--scenes", nargs="*", default=None,
                        help="of stress4k, phong1080, phong1080_tex2048, custom12_360 (default: all)")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import fused, raster
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    dev = torch.device("cuda", 0)
    base = kernels.CSRC.resolve()
    libraries = {"full": variant(base, "full", [])}
    for label, edits in PROBES.items():
        if opts.probes is not None and label not in opts.probes:
            continue
        src = variant(base, label.replace(" ", "_").replace("+", "and"), edits)
        if src is None:
            print(f"[split] {label}: its lines are not in {base}: skipped", flush=True)
            continue
        libraries[label] = src
    build_all(libraries.values())
    cases = {}  # (kernel, scene) → (wrapper, entry point, its arguments)
    for kernel, name, angle in (("K1", "stress4k", 0.10), ("K1", "phong1080", 0.10),
                                ("K4", "phong1080_tex2048", 0.10), ("K4", "custom12_360", 0.3)):
        if opts.scenes is not None and name not in opts.scenes:
            continue
        scene = chip_smoke.build_scene(name, dev)
        chip_smoke.set_angle(scene, angle)
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        prep = fused.prep_fused(tri, scene.config)
        if kernel == "K1":
            cases[kernel, name] = ("fused_raster", fused.render_fused_prepared,
                                   (prep, scene.pixel_shader, scene.ps_uniform, scene.config))
        else:
            cases[kernel, name] = ("raster_planes", raster.raster_planes, (prep, True))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    want = {}
    for label in (*libraries, "full"):
        use(kernels, libraries[label])
        times = []
        for (kernel, name), (wrapper, entry, args) in cases.items():
            got = entry(*args)
            if label == "full":
                want.setdefault(name, got)
                chip_smoke.check(chip_smoke.same(got, want[name]), f"{name}: {kernel} differs between the two full runs")
            launch = chip_smoke.kernel_call(wrapper, lambda: entry(*args))
            ms = [chip_smoke.device_ms(launch, opts.reps) for _ in range(2)]
            times.append(f"{name} {kernel} {ms[0]:.4f} / {ms[1]:.4f} ms")
        print(f"[split] {label}: {', '.join(times)} (device; {smi})", flush=True)
    if chip_smoke.failures:
        print(f"k1_split: {len(chip_smoke.failures)} check(s) failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
