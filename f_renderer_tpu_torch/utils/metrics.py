"""Observability: per-frame counters, stage timing and device traces.

Port of ``f_renderer_tpu/utils/metrics.py``. The reference's only
instrumentation is a per-frame fps println (phong.rs:383-384). Here:
per-frame counters computed on the frame's device (:class:`FrameStats`), a
host stage timer that doubles as an fps / Mpix meter and can wait for the
card (:class:`StageTimer`), and a ``torch.profiler`` trace of a span
(:func:`profiler_trace`, the counterpart of ``xprof_trace``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FrameStats:
    """Per-frame counters, 0-d int32 tensors on the frame's device."""

    triangles_in: torch.Tensor
    triangles_clipped: torch.Tensor
    triangles_emitted: torch.Tensor
    pixels_covered: torch.Tensor

    @staticmethod
    def gather(tri, winner, num_clipped, faces_in) -> "FrameStats":
        dev = winner.device
        return FrameStats(
            triangles_in=torch.as_tensor(faces_in, dtype=torch.int32, device=dev),
            triangles_clipped=torch.as_tensor(num_clipped, device=dev).to(torch.int32),
            triangles_emitted=tri.valid.sum().to(torch.int32),
            pixels_covered=(winner >= 0).sum().to(torch.int32),
        )

    def as_dict(self) -> dict:
        return {
            "triangles_in": int(self.triangles_in),
            "triangles_clipped": int(self.triangles_clipped),
            "triangles_emitted": int(self.triangles_emitted),
            "pixels_covered": int(self.pixels_covered),
        }


class StageTimer:
    """Wall-clock stage timer + fps/Mpix meter (host side).

    Usage::

        timer = StageTimer()
        with timer.stage("frame", sync=frame_device):
            frame, depth, stats = scene.render()
        print(timer.report(pixels=W * H))

    ``sync``: a device; where it is a CUDA device the span starts and ends
    with ``torch.cuda.synchronize``, so it covers the work the card queued
    in it and no earlier work. Without it the span is the host's time alone
    (the card's launches return before they run).
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def stage(self, name: str, sync=None):
        timer = self
        dev = torch.device(sync) if sync is not None else None
        cuda = dev is not None and dev.type == "cuda"

        class _Ctx:
            def __enter__(self):
                if cuda:
                    torch.cuda.synchronize(dev)
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                if cuda:
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - self.t0
                timer.totals[name] = timer.totals.get(name, 0.0) + dt
                timer.counts[name] = timer.counts.get(name, 0) + 1

        return _Ctx()

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts.get(name, 0), 1)

    def report(self, pixels: Optional[int] = None) -> str:
        parts = []
        for name in self.totals:
            m = self.mean(name)
            s = f"{name}: {m * 1e3:.2f}ms"
            if pixels:
                s += f" ({pixels / m / 1e6:.1f} Mpix/s)"
            parts.append(s)
        return "; ".join(parts)


def profiler_trace(log_dir):
    """Deep-profiling scope: a ``torch.profiler.profile`` context manager
    that records the host's operators and, where a card is present, its
    kernels, and on exit writes a Chrome trace (``*.pt.trace.json``, for
    TensorBoard or chrome://tracing) into ``log_dir``; a no-op when
    ``log_dir`` is falsy, so call sites can be wired unconditionally."""
    if not log_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)))
