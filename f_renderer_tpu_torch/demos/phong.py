"""Multi-mesh textured Phong viewer: the phong.rs demo on the port.

Port of ``examples/phong_demo.py``. Reference: examples/src/bin/phong.rs, a
1920×1080 interactive viewer over a 3-mesh textured character (OBJ + TGA
assets) with an orbiting camera and a per-frame fps print. The assets are
not distributed with the reference repo, so by default this renders
procedural meshes; pass ``--obj mesh.obj --tex diffuse.tga`` (repeatable)
for the original asset flow (OBJ parse → per-face corners, TGA decode →
BGRA texture, phong.rs:166-171).

The window is a display sink (PNG sequence by default); the camera orbit
is the reference's right-drag orbit (phong.rs:287-298). Each frame sets
the scene's ``view`` and ``view_pos`` and calls ``Scene.render()``: on the
card one captured CUDA graph a frame.

Usage:
  python -m f_renderer_tpu_torch.demos.phong [--frames 24] [--size 960x540]
      [--out out/phong] [--obj a.obj --tex a.tga ...]
      [--backend kernels|portable] [--ascii] [--video out.mp4]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from f_renderer_tpu_torch.demos import StepClock, frame_size
from f_renderer_tpu_torch.device import resolve_device

ORBIT = (6.0, 1.5)  # a ~6 px right-drag a frame (phong.rs:287-298)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m f_renderer_tpu_torch.demos.phong")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", default="960x540")
    ap.add_argument("--out", default="out/phong")
    ap.add_argument("--obj", action="append", default=[])
    ap.add_argument("--tex", action="append", default=[])
    ap.add_argument("--backend", default="kernels", choices=("kernels", "portable"))
    ap.add_argument("--ascii", action="store_true", help="terminal preview")
    ap.add_argument("--video", default="", help="encode the orbit to this .mp4 (ffmpeg) or .gif (PIL fallback)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def load_assets(objs, texs):
    """OBJ meshes as per-face corners and textures as BGRA arrays (a .tga
    through the native decoder, anything else through PIL)."""
    from f_renderer_tpu_torch.io.image import load_texture
    from f_renderer_tpu_torch.io.obj import load_obj

    meshes = [load_obj(path, verbose=True).corners() for path in objs]
    textures = []
    for path in texs:
        if path.endswith(".tga"):
            from f_renderer_tpu_torch import native

            with open(path, "rb") as f:
                textures.append(native.decode_tga(f.read()))
        else:
            textures.append(load_texture(path, verbose=True))
    return meshes, textures


def procedural_meshes():
    """A sphere above a cube, and a smaller cube beside them."""
    from f_renderer_tpu_torch.scene import make_cube, make_uv_sphere

    sphere = make_uv_sphere(24, 48, radius=0.8)
    sphere["pos"] = sphere["pos"] + np.array([0, 1.2, 0], np.float32)
    cube2 = make_cube(0.5)
    cube2["pos"] = cube2["pos"] + np.array([1.1, 0.3, 0.4], np.float32)
    return [sphere, make_cube(0.9), cube2]


def build_scene(args):
    """The demo's phong scene on ``args.device`` with ``args.backend``."""
    from f_renderer_tpu_torch.scene import make_phong_scene

    device = resolve_device(args.device)
    w, h = frame_size(args.size)
    meshes, textures = load_assets(args.obj, args.tex) if args.obj else (procedural_meshes(), [])
    scene = make_phong_scene(w, h, meshes=meshes, textures=textures or None, device=device)
    scene.config = dataclasses.replace(scene.config, backend=args.backend)
    return scene


def start_camera(device):
    from f_renderer_tpu_torch.camera import Camera

    return Camera.create([0.0, 1.0, 3.5], [0.0, 0.6, 0.0], [0.0, 1.0, 0.0], device)


def next_camera(camera):
    """The orbit's next camera."""
    from f_renderer_tpu_torch.camera import orbit

    return orbit(camera, *ORBIT)


def frame_at(scene, camera):
    """The scene's frame from ``camera``: its view and the lighting's eye
    set, then ``Scene.render()`` → (H, W, 4) uint8."""
    scene.vs_uniform = dict(scene.vs_uniform, view=camera.look_at())
    scene.ps_uniform = dict(scene.ps_uniform, view_pos=camera.eye)
    return scene.render()[0]


def run(args, display=None):
    """The demo: ``args.frames`` frames of the orbit into ``display`` (by
    default a video with ``--video``, the terminal with ``--ascii``, else
    the PNG sequence of ``args.out``), then the closing line → the loop's
    ``LoopTimes``."""
    from f_renderer_tpu_torch.display import AsciiDisplay, PngSequenceDisplay, VideoDisplay, render_loop

    scene = build_scene(args)
    w, h = scene.config.width, scene.config.height

    def step(camera, event):
        camera = next_camera(camera)
        return frame_at(scene, camera), camera

    if display is None:
        if args.video:
            os.makedirs(os.path.dirname(args.video) or ".", exist_ok=True)
            display = VideoDisplay(args.video, fps=24)
        elif args.ascii:
            display = AsciiDisplay()
        else:
            display = PngSequenceDisplay(args.out)
    clock = StepClock(step)
    t0 = time.perf_counter()
    with display:
        render_loop(clock, start_camera(scene.device), display, frames=args.frames)
    times = clock.times(t0)
    dt = times.frame_ms / 1e3
    print(f"avg frame {times.frame_ms:.1f}ms ({times.fps:.1f} fps, {w * h / dt / 1e6:.0f} Mpix/s) "
          f"backend={args.backend}", file=sys.stderr)
    return times


def main(argv=None):
    args = parse_args(argv)
    run(args)
    if args.video:
        print(f"video written near {args.video}", file=sys.stderr)
    elif not args.ascii:
        print(f"frames written to {args.out}/", file=sys.stderr)


if __name__ == "__main__":
    main()
