"""Presentation layer (reference: vulkan_base.rs / wgpu_base.rs).

Port of ``f_renderer_tpu/display.py``. The reference's L3 layer is an OS
window plus a blit of a CPU-computed byte buffer (vulkan_base.rs:723 maps a
staging buffer, the app copies the framebuffer into it, the GPU copies it to
the swapchain). On a headless host the "present" is a device→host copy of
the rendered frame followed by a sink write: PNG sequence, raw byte stream
(pipeable to ffmpeg et al.), npy, or an in-terminal preview.

``render_loop`` keeps the per-frame structure of
``DisplayBase::render_loop`` (vulkan_base.rs:696-805): an event callback
mutates app state (camera), a render step produces the frame, present blits
it. A frame on the card is staged into pinned host memory by a
non-blocking copy behind a CUDA event, up to ``max_in_flight`` frames
outstanding, and presented once its event has completed: the card renders
frame N + 1 while frame N crosses to the host and is written out.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch


class Display:
    """Present sink interface (WgpuRenderer / DisplayBase analogue)."""

    def present(self, frame: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullDisplay(Display):
    """Swallow frames (benchmarking without IO)."""

    def present(self, frame: np.ndarray) -> None:
        pass


class PngSequenceDisplay(Display):
    """Write frame_NNNN.png per present."""

    def __init__(self, directory: str, prefix: str = "frame"):
        self.directory = directory
        self.prefix = prefix
        self.index = 0
        os.makedirs(directory, exist_ok=True)

    def present(self, frame: np.ndarray) -> None:
        path = os.path.join(self.directory, f"{self.prefix}_{self.index:04d}.png")
        save_frame(path, frame)
        self.index += 1


class RawStreamDisplay(Display):
    """Stream raw H*W*4 bytes per frame to a file object.

    The closest analogue of the reference's mapped staging buffer
    (phong.rs:386 ``image_slice.copy_from_slice``): a plain byte blit.
    Pipe to ffmpeg: ``-f rawvideo -pix_fmt rgba -s WxH -i -``.
    """

    def __init__(self, fileobj):
        self.fileobj = fileobj

    def present(self, frame: np.ndarray) -> None:
        self.fileobj.write(np.ascontiguousarray(frame, np.uint8).tobytes())
        self.fileobj.flush()


class VideoDisplay(Display):
    """Encode presented frames into a playable video file.

    When ``ffmpeg`` is on PATH, frames are piped as rawvideo into an H.264
    encoder (the RawStreamDisplay→ffmpeg wiring, done for you). Otherwise
    (this image ships no ffmpeg) frames are collected and written as an
    animated GIF/APNG via PIL on ``close`` — still a playable artifact of
    the render_loop event path (vulkan_base.rs:696-805's observable
    capability).
    """

    def __init__(self, path: str, fps: int = 30):
        import shutil

        self.path = path
        self.fps = fps
        self.proc = None
        self.frames = []
        self.size = None
        self._ffmpeg = shutil.which("ffmpeg") if path.endswith(".mp4") else None

    def _start_ffmpeg(self, w: int, h: int):
        import subprocess

        self.proc = subprocess.Popen(
            [
                self._ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgba",
                "-s", f"{w}x{h}", "-r", str(self.fps), "-i", "-",
                "-pix_fmt", "yuv420p", "-c:v", "libx264", self.path,
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    def present(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(np.asarray(frame)[..., :4], np.uint8)
        if self._ffmpeg:
            if self.proc is None:
                self.size = frame.shape[:2]
                self._start_ffmpeg(frame.shape[1], frame.shape[0])
            self.proc.stdin.write(frame.tobytes())
        else:
            self.frames.append(frame)

    def close(self) -> None:
        if self.proc is not None:
            self.proc.stdin.close()
            self.proc.wait()
            self.proc = None
        elif self.frames:
            from PIL import Image

            path = self.path
            if path.endswith(".mp4"):  # no encoder available — save a GIF
                path = path[: path.rfind(".")] + ".gif"
            ims = [Image.fromarray(f[..., :3], "RGB") for f in self.frames]
            ims[0].save(
                path,
                save_all=True,
                append_images=ims[1:],
                duration=max(1000 // self.fps, 20),
                loop=0,
            )
            self.frames = []


class AsciiDisplay(Display):
    """Coarse in-terminal preview using 256-color half blocks."""

    def __init__(self, max_cols: int = 96, out=None):
        self.max_cols = max_cols
        self.out = out or sys.stdout

    def present(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        h, w = frame.shape[:2]
        step = max(1, w // self.max_cols)
        small = frame[:: step * 2, ::step, :3].astype(np.int32)
        lines = []
        for row in small:
            cells = [
                f"\x1b[48;2;{r};{g};{b}m " for r, g, b in row
            ]
            lines.append("".join(cells) + "\x1b[0m")
        self.out.write("\n".join(lines) + "\n")
        self.out.flush()


def save_frame(path: str, frame: np.ndarray) -> None:
    """Save one frame by extension: .png (PIL), .npy, .raw."""
    frame = np.asarray(frame)
    if path.endswith(".npy"):
        np.save(path, frame)
        return
    if path.endswith(".raw"):
        with open(path, "wb") as f:
            f.write(np.ascontiguousarray(frame, np.uint8).tobytes())
        return
    from f_renderer_tpu_torch.io.image import save_png

    save_png(path, frame)


@dataclasses.dataclass
class MouseEvent:
    """One pointer event (winit WindowEvent analogue, phong.rs:214-311).

    ``kind``: "press" | "release" | "move" | "wheel". ``button``:
    0=left, 1=middle, 2=right (valid for press/release/move-with-button).
    ``x, y``: cell/pixel position; ``dx, dy``: delta from the previous
    position (CursorMoved's ``theta_x/theta_y`` in phong.rs:284-285);
    ``wheel``: +1 scroll up / -1 scroll down (MouseScrollDelta::LineDelta).
    """

    kind: str
    button: int = -1
    x: float = 0.0
    y: float = 0.0
    dx: float = 0.0
    dy: float = 0.0
    wheel: float = 0.0


@dataclasses.dataclass
class FrameEvent:
    """Per-frame event record passed to the app callback (winit analogue).

    ``keys``: characters received from the loop's input source since the
    previous frame — the live-input analogue of the reference forwarding
    non-redraw winit events into render_func (vulkan_base.rs:803).
    ``mouse``: pointer events decoded since the previous frame (the
    CursorMoved / MouseInput / MouseWheel stream of phong.rs:214-311).
    """

    index: int
    time: float
    dt: float
    keys: str = ""
    mouse: tuple = ()


# Complete SGR-1006 mouse report / a prefix of one (split-read buffering).
_SGR_RE = re.compile(r"\x1b\[<(\d+);(\d+);(\d+)([Mm])")
_SGR_PREFIX_RE = re.compile(r"\x1b(\[(<(\d+(;(\d+(;(\d+)?)?)?)?)?)?)?$")


class SgrMouseParser:
    """Incremental decoder for xterm SGR-1006 mouse reports mixed into a
    terminal byte stream.

    A terminal with ``?1002h ?1006h`` set interleaves ``ESC [ < Cb;Cx;Cy
    (M|m)`` reports with ordinary keystrokes. ``feed`` splits one chunk
    into (plain keys, decoded MouseEvents); partial sequences split
    across reads are buffered until complete. Cb bits: 0-1 button
    (0=left 1=middle 2=right), +32 motion, +64 wheel (64 up / 65 down);
    trailing M = press/motion, m = release.

    Mirrors the reference's winit event granularity: presses/releases
    track button state, motion reports carry cursor deltas
    (phong.rs:282-311), wheel maps to LineDelta y = ±1 (phong.rs:217-238).
    """

    def __init__(self):
        self._buf = ""
        self._last_xy = None
        self._stall = 0

    def feed(self, data: str):
        keys = []
        events = []
        buf = self._buf + data
        i = 0
        n = len(buf)
        while i < n:
            ch = buf[i]
            if ch != "\x1b":
                keys.append(ch)
                i += 1
                continue
            m = _SGR_RE.match(buf, i)
            if m:
                cb, cx, cy = (int(v) for v in m.group(1, 2, 3))
                final = m.group(4)
                x, y = float(cx), float(cy)
                if cb >= 64:
                    events.append(
                        MouseEvent("wheel", x=x, y=y,
                                   wheel=1.0 if cb & 1 == 0 else -1.0)
                    )
                else:
                    button = cb & 3
                    if cb & 32:
                        px, py = self._last_xy or (x, y)
                        events.append(
                            MouseEvent("move", button=button, x=x, y=y,
                                       dx=x - px, dy=y - py)
                        )
                    else:
                        kind = "press" if final == "M" else "release"
                        events.append(
                            MouseEvent(kind, button=button, x=x, y=y)
                        )
                    self._last_xy = (x, y)
                i = m.end()
                continue
            if _SGR_PREFIX_RE.match(buf, i) and n - i < 32:
                # Possibly-incomplete report at the chunk tail: hold it.
                break
            keys.append(ch)
            i += 1
        held = buf[i:]
        # A bare ESC keypress is also a valid report prefix; if the held
        # prefix survives two idle polls unchanged, no continuation is
        # coming — release it as plain keys (ESC reaches event.keys ~2
        # frames late instead of never).
        if held and held == self._buf and not data:
            self._stall += 1
        else:
            self._stall = 0
        if self._stall >= 2:
            keys.extend(held)
            held = ""
            self._stall = 0
        self._buf = held
        return "".join(keys), events


class StdinKeys:
    """Non-blocking raw-mode keyboard (and optionally mouse) input from a
    controlling terminal.

    The headless-host stand-in for the reference's winit mouse/scroll
    events (phong.rs:214-311): puts the tty in cbreak mode and drains
    pending bytes each frame without blocking. With ``mouse=True`` it
    additionally switches the terminal into button-event tracking with
    SGR-1006 encoding (``?1002h ?1006h``) and decodes pointer reports out
    of the stream (:class:`SgrMouseParser`) — actual drag/wheel deltas,
    the one reference input modality keyboard polling alone lacks. On a
    non-tty stdin (pipes, CI) it degrades to an always-empty source.
    """

    def __init__(self, mouse: bool = False):
        self._fd = None
        self._saved = None
        self._mouse = None
        try:
            if sys.stdin.isatty():
                import termios
                import tty

                self._fd = sys.stdin.fileno()
                self._saved = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                if mouse:
                    self._mouse = SgrMouseParser()
                    sys.stdout.write("\x1b[?1002h\x1b[?1006h")
                    sys.stdout.flush()
        except Exception:
            self._fd = None

    def _drain(self) -> str:
        if self._fd is None:
            return ""
        import select

        out = []
        while select.select([self._fd], [], [], 0)[0]:
            chunk = os.read(self._fd, 1024).decode(errors="ignore")
            if not chunk:
                break
            out.append(chunk)
        return "".join(out)

    def poll(self) -> str:
        data = self._drain()
        if self._mouse is not None:
            keys, _ = self._mouse.feed(data)
            return keys
        return data

    def poll_events(self):
        """Drain pending input → (keys, tuple of MouseEvents)."""
        data = self._drain()
        if self._mouse is None:
            return data, ()
        keys, events = self._mouse.feed(data)
        return keys, tuple(events)

    def close(self) -> None:
        if self._mouse is not None:
            sys.stdout.write("\x1b[?1002l\x1b[?1006l")
            sys.stdout.flush()
            self._mouse = None
        if self._fd is not None and self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
            self._fd = None


class _Staged:
    """A frame on its way to the host to be presented. A CUDA tensor is
    copied into pinned host memory without blocking, and a CUDA event
    recorded behind the copy on the current stream; a CPU tensor or an
    array is taken as it is."""

    def __init__(self, frame):
        self.event = None
        if isinstance(frame, torch.Tensor) and frame.is_cuda:
            self.host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
            self.host.copy_(frame, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(frame.device))
        elif isinstance(frame, torch.Tensor):
            self.host = frame.detach()
        else:
            self.host = np.asarray(frame)

    def result(self) -> np.ndarray:
        """The frame on the host, once its copy has completed."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy() if isinstance(self.host, torch.Tensor) else self.host


def render_loop(
    step: Callable,
    state,
    display: Optional[Display] = None,
    *,
    frames: int = 0,
    print_fps: bool = True,
    max_in_flight: int = 2,
    input_source=None,
):
    """Drive a frame loop (DisplayBase::render_loop, vulkan_base.rs:696-805).

    ``step(state, event) -> (frame, new_state)``, the frame an (H, W, 4)
    uint8 tensor (on the card or the CPU) or array; ``frames=0`` runs until
    KeyboardInterrupt. Up to ``max_in_flight`` frames are outstanding: each
    is staged to pinned host memory behind a CUDA event, and presented once
    the event completes, so the card's rendering overlaps the host-side
    present (the staging double-buffer analogue).

    ``input_source``: object with ``poll() -> str`` (e.g. :class:`StdinKeys`)
    whose pending characters are forwarded in ``event.keys`` — the live
    input path.

    Returns the final state.
    """
    display = display or NullDisplay()
    pending = []  # _Staged frames awaiting present, oldest first
    t_prev = time.time()
    i = 0
    try:
        while frames == 0 or i < frames:
            now = time.time()
            if input_source is None:
                keys, mouse = "", ()
            elif hasattr(input_source, "poll_events"):
                keys, mouse = input_source.poll_events()
            else:
                keys, mouse = input_source.poll(), ()
            event = FrameEvent(
                index=i, time=now, dt=now - t_prev, keys=keys, mouse=mouse
            )
            t_prev = now
            frame, state = step(state, event)
            if frame is None:  # step signals quit
                break
            pending.append(_Staged(frame))
            if len(pending) >= max_in_flight:
                display.present(pending.pop(0).result())
            if print_fps:
                dt = max(event.dt, 1e-9)
                print(f"fps: {1.0 / dt:.1f}", file=sys.stderr)
            i += 1
    except KeyboardInterrupt:
        pass
    finally:
        if input_source is not None and hasattr(input_source, "close"):
            input_source.close()
    for staged in pending:
        display.present(staged.result())
    return state
