"""Live interactive viewer: a keyboard- and mouse-driven camera over the
phong scene, on the port.

Port of ``examples/interactive_demo.py``. The reference forwards winit
window and mouse events into the frame callback (vulkan_base.rs:803), and
the phong app turns them into orbit / pan / zoom (phong.rs:214-311). A
headless host has no window, so the live input is a raw-mode terminal
(``display.StdinKeys``) feeding ``FrameEvent.keys``, plus pointer input from
xterm SGR-1006 mouse reports (``FrameEvent.mouse``), with each frame shown
in the terminal (``AsciiDisplay``).

Controls: a/d orbit left/right · w/s orbit up/down · h/j/k/l pan ·
q/e zoom in/out · x quit · right-drag orbit · middle-drag pan ·
wheel zoom (the phong.rs:214-311 mouse mapping).

Usage:
  python -m f_renderer_tpu_torch.demos.interactive [--size 480x270]
      [--frames 0] [--backend kernels|portable] [--keys "adwsqe"]
      [--out last.png] [--device cuda|cpu]   # --keys: scripted input
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

# Mouse-delta equivalents per keypress (phong.rs orbit ratio 0.005/px: one
# keypress ≈ a 40 px drag).
DRAG = 40.0
# key → (control, delta x, delta y)
KEYS = {"a": ("orbit", -DRAG, 0.0), "d": ("orbit", DRAG, 0.0), "w": ("orbit", 0.0, -DRAG),
        "s": ("orbit", 0.0, DRAG), "h": ("pan", -DRAG, 0.0), "l": ("pan", DRAG, 0.0),
        "k": ("pan", 0.0, -DRAG), "j": ("pan", 0.0, DRAG), "q": ("zoom", 1.0, None), "e": ("zoom", -1.0, None)}
CELL_PX = 8.0  # a terminal cell is ~8-16 px: cell deltas scaled toward phong.rs's per-pixel ratios
QUIT = "x"


class ScriptedKeys:
    """Replays a fixed key string one char per frame, then quits (scripted
    and headless runs)."""

    def __init__(self, keys: str):
        self._keys = list(keys)

    def poll(self) -> str:
        return self._keys.pop(0) if self._keys else QUIT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m f_renderer_tpu_torch.demos.interactive")
    ap.add_argument("--size", default="480x270")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--backend", default="kernels", choices=("kernels", "portable"))
    ap.add_argument("--keys", default="", help="scripted key sequence")
    ap.add_argument("--out", default="", help="also save the last frame as PNG")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_scene(args):
    """A sphere and a cube beside it on ``args.device`` (clip cap 128)."""
    from f_renderer_tpu_torch.scene import make_cube, make_phong_scene, make_uv_sphere

    device = resolve_device(args.device)
    w, h = frame_size(args.size)
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.6, 0.0, 0.0], np.float32)
    scene = make_phong_scene(w, h, meshes=[make_uv_sphere(24, 48), cube], clip_cap=128, device=device)
    scene.config = dataclasses.replace(scene.config, backend=args.backend)
    return scene


def start_camera(device):
    from f_renderer_tpu_torch.camera import Camera

    return Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device)


class Controls:
    """The event → camera mapping of phong.rs:214-311: keys first, then
    the pointer (right-drag orbits, middle-drag pans, the wheel zooms),
    with the buttons held across frames. ``controls(camera, event)`` →
    (the new camera, whether the event asks to quit): a quit key returns
    the camera as the keys before it left it."""

    def __init__(self):
        self.buttons = set()

    def __call__(self, camera, event):
        from f_renderer_tpu_torch import camera as cam

        for ch in event.keys:
            if ch == QUIT:
                return camera, True
            if ch in KEYS:
                control, dx, dy = KEYS[ch]
                camera = cam.zoom(camera, dx) if control == "zoom" else getattr(cam, control)(camera, dx, dy)
        for ev in event.mouse:
            if ev.kind == "press":
                self.buttons.add(ev.button)
            elif ev.kind == "release":
                self.buttons.discard(ev.button)
            elif ev.kind == "move":
                if 2 in self.buttons:
                    camera = cam.orbit(camera, ev.dx * CELL_PX, ev.dy * CELL_PX)
                elif 1 in self.buttons:
                    camera = cam.pan(camera, ev.dx * CELL_PX, ev.dy * CELL_PX)
            elif ev.kind == "wheel":
                camera = cam.zoom(camera, ev.wheel)
        return camera, False


def frame_at(scene, camera):
    """The scene's frame from ``camera``: its view set, then
    ``Scene.render()`` → (H, W, 4) uint8. The lighting's eye stays where the
    scene put it, as in ``examples/interactive_demo.py``."""
    scene.vs_uniform = dict(scene.vs_uniform, view=camera.look_at())
    return scene.render()[0]


def run(args, display=None):
    """The demo: frames until the input quits (or ``args.frames``) into
    ``display`` (by default the terminal), input from the ``--keys`` script
    or else the terminal with mouse reports; the last frame saved to
    ``args.out`` where given → the loop's ``LoopTimes``."""
    from f_renderer_tpu_torch.display import AsciiDisplay, StdinKeys, render_loop

    scene = build_scene(args)
    controls = Controls()

    def step(camera, event):
        camera, quit_ = controls(camera, event)
        return (None if quit_ else frame_at(scene, camera)), camera

    input_source = ScriptedKeys(args.keys) if args.keys else StdinKeys(mouse=True)
    print("controls: a/d w/s orbit · h/j/k/l pan · q/e zoom · x quit · right-drag orbit · middle-drag pan · "
          "wheel zoom", file=sys.stderr)
    clock = StepClock(step)
    t0 = time.perf_counter()
    display = display or AsciiDisplay()
    with display:
        camera = render_loop(clock, start_camera(scene.device), display, frames=args.frames,
                             input_source=input_source)
    times = clock.times(t0)
    if args.out:
        from f_renderer_tpu_torch.io import save_png

        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        save_png(args.out, frame_at(scene, camera).cpu().numpy())
        print(f"saved {args.out}", file=sys.stderr)
    return times


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
