"""The system's demos on the port: the counterparts of ``examples/``.

- ``python -m f_renderer_tpu_torch.demos.voxel``: the voxel.rs orbit over a
  random SVO (``examples/voxel_demo.py``), one ``voxel.VoxelRenderer``
  built once;
- ``python -m f_renderer_tpu_torch.demos.phong``: the phong.rs multi-mesh
  viewer (``examples/phong_demo.py``), ``Scene.render()`` a frame;
- ``python -m f_renderer_tpu_torch.demos.interactive``: the phong scene
  under keyboard and mouse control (``examples/interactive_demo.py``).

Each runs on the card (``--device cuda``, the default) and raises without
one; ``--device cpu`` runs the plain versions of the kernels. Frames go to
the port's ``display`` sinks through ``display.render_loop``. Each module's
``run(args, display=None)`` is the demo with its display given by the
caller; it returns the loop's timings.
"""

from __future__ import annotations

import dataclasses
import time


def frame_size(text: str) -> tuple[int, int]:
    """``"960x540"`` → (960, 540)."""
    w, h = (int(v) for v in text.split("x"))
    return w, h


@dataclasses.dataclass
class LoopTimes:
    """What a demo's loop took, on the host's clock: ``frames`` frames in
    ``seconds`` (the first frame, which captures its graph, included, as
    the JAX demos count it), and ``steady_ms`` a frame from the second
    frame's step to the loop's end."""

    frames: int
    seconds: float
    steady_ms: float

    @property
    def frame_ms(self) -> float:
        return self.seconds * 1e3 / max(self.frames, 1)

    @property
    def fps(self) -> float:
        return 1e3 / self.frame_ms if self.frame_ms > 0 else float("inf")


class StepClock:
    """Wraps a loop's step and notes when each call that returns a frame
    starts."""

    def __init__(self, step):
        self.step, self.starts = step, []

    def __call__(self, state, event):
        t = time.perf_counter()
        frame, state = self.step(state, event)
        if frame is not None:
            self.starts.append(t)
        return frame, state

    def times(self, t0: float) -> LoopTimes:
        """The loop's times, ``t0`` its start, now its end."""
        end = time.perf_counter()
        n = len(self.starts)
        steady = (end - self.starts[1]) * 1e3 / (n - 1) if n > 1 else float("nan")
        return LoopTimes(frames=n, seconds=end - t0, steady_ms=steady)
