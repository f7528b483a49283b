"""Sparse-voxel-octree raycaster: the voxel.rs demo on the port.

Port of ``examples/voxel_demo.py``. Reference: examples/src/bin/voxel.rs, a
960×540 interactive raycast over a random level-3 SVO (70% occupancy / 30%
leaves, voxel.rs:492-516), camera orbit, wgpu presentation, fps print. The
octree is densified into a flat grid (``voxel/octree.py``), one
``VoxelRenderer`` builds its table once, each frame's camera is computed on
the host with numpy, and the frames go to a display sink.

Usage:
  python -m f_renderer_tpu_torch.demos.voxel [--frames 24] [--size 960x540]
      [--level 3] [--out out/voxel] [--seed 0] [--ascii] [--dda]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from f_renderer_tpu_torch.demos import StepClock, frame_size
from f_renderer_tpu_torch.device import resolve_device

LENGTH = 2.0  # the cube's side
ANGLE_STEP = 0.08  # the orbit's turn a frame


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m f_renderer_tpu_torch.demos.voxel")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", default="960x540")
    ap.add_argument("--level", type=int, default=3)
    ap.add_argument("--out", default="out/voxel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ascii", action="store_true")
    ap.add_argument("--dda", action="store_true",
                    help="cell-exact traversal (skips the reference's fixed-step thin-leaf quirk)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def orbit_view(angle: float, width: int, height: int, length: float = LENGTH):
    """The camera of the orbit at ``angle`` around the cube's centre
    (voxel.rs:74-130 analogue), on the host as ``examples/voxel_demo.py``
    computes it → (eye (3,) f32, inv_mvp (4, 4) f32) numpy arrays."""
    from f_renderer_tpu_torch.math import set_identity, set_look_at, set_perspective

    proj = set_perspective(np.pi * 0.25, width / height, 0.1, 100.0).numpy()
    model = set_identity().numpy()
    center = np.array([length / 2] * 3, np.float32)
    eye = center + np.array([3.0 * np.cos(angle), 1.2, 3.0 * np.sin(angle)], np.float32)
    view = set_look_at(eye, center, [0, 1, 0]).numpy()
    mvp = proj @ view @ model
    return eye, np.linalg.inv(mvp).astype(np.float32)


def make_renderer(args):
    """The seeded random octree, densified → a ``VoxelRenderer`` of its
    grids on ``args.device``."""
    from f_renderer_tpu_torch.voxel import VoxelRenderConfig, VoxelRenderer, densify, gen_randomly

    device = resolve_device(args.device)
    w, h = frame_size(args.size)
    grid_color, grid_hit = densify(gen_randomly(args.level, np.random.default_rng(args.seed)), args.level)
    cfg = VoxelRenderConfig(width=w, height=h, level=args.level, length=LENGTH,
                            traversal="dda" if args.dda else "fixed")
    return VoxelRenderer(grid_color, grid_hit, cfg, device=device)


def run(args, display=None):
    """The demo: ``args.frames`` frames of the orbit into ``display`` (by
    default the PNG sequence of ``args.out``, or the terminal with
    ``--ascii``), then the closing line → the loop's ``LoopTimes``."""
    from f_renderer_tpu_torch.display import AsciiDisplay, PngSequenceDisplay, render_loop

    renderer = make_renderer(args)
    w, h = renderer.config.width, renderer.config.height

    def step(angle, event):
        eye, inv_mvp = orbit_view(angle, w, h)
        return renderer(eye, inv_mvp), angle + ANGLE_STEP

    if display is None:
        display = AsciiDisplay() if args.ascii else PngSequenceDisplay(args.out)
    clock = StepClock(step)
    t0 = time.perf_counter()
    with display:
        render_loop(clock, 0.0, display, frames=args.frames)
    times = clock.times(t0)
    dt = times.frame_ms / 1e3
    print(f"avg frame {times.frame_ms:.1f}ms ({times.fps:.1f} fps, {w * h / dt / 1e6:.0f} Mrays/s)",
          file=sys.stderr)
    return times


def main(argv=None):
    args = parse_args(argv)
    run(args)
    if not args.ascii:
        print(f"frames written to {args.out}/", file=sys.stderr)


if __name__ == "__main__":
    main()
