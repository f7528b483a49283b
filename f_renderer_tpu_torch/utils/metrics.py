"""Observability: per-frame counters, host spans, stage timing and device
traces.

Port of ``f_renderer_tpu/utils/metrics.py``. The reference's only
instrumentation is a per-frame fps println (phong.rs:383-384). Here:
per-frame counters computed on the frame's device (:class:`FrameStats`);
the host's spans and counters inside the entry points, kept by a
:class:`Recorder` while :func:`tracing` is on; a host stage timer that
doubles as an fps / Mpix meter and can wait for the card
(:class:`StageTimer`, whose stages are spans too); and a ``torch.profiler``
trace of a span (:func:`profiler_trace`, the counterpart of
``xprof_trace``).

The spans' clock is ``time.perf_counter_ns``, the clock a CUPTI trace's
host offset is read against, so spans and device records share one
timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from time import perf_counter_ns
from typing import Optional

import torch

RECORD_CAP = 1 << 20  # the records a Recorder keeps: spans, and frames' counters

recorder: Optional["Recorder"] = None
"""The recorder :func:`tracing` turned on; None while tracing is off. An
instrumented site tests this one attribute and, where it is None, does
nothing more: no span object, no clock read."""


class Span:
    """A span of time on ``time.perf_counter_ns`` (``t0``, ``t1``, ``ns``),
    timed as a context manager or from :meth:`start` to :meth:`stop`. With
    a recorder ``rec`` it takes the innermost open span as its ``parent``
    and the recorder's ``frame`` when started, and is recorded when
    stopped."""

    __slots__ = ("name", "parent", "frame", "t0", "t1", "_rec", "_slot")

    def __init__(self, name: str, rec: Optional["Recorder"] = None):
        self.name, self._rec = name, rec
        self.parent = self.frame = None
        self.t0 = self.t1 = 0

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    def start(self) -> "Span":
        if self._rec is not None:
            self._rec._open(self)
        self.t0 = perf_counter_ns()
        return self

    def stop(self):
        self.t1 = perf_counter_ns()
        if self._rec is not None:
            self._rec._close(self)

    __enter__ = start

    def __exit__(self, *exc):
        self.stop()
        return False


class Recorder:
    """The spans and counters of the calls made while it is on, in memory.

    ``spans``: one ``(name, parent, frame, t0, t1)`` tuple a span, in the
    order the spans opened (times in ns on ``time.perf_counter_ns``; the
    parent's name, None for an outermost span). Plain tuples of strings and
    ints, which the garbage collector stops tracking, so a long window's
    records do not slow its collections. An outermost span (an entry
    point's whole call) starts a new ``frame`` id; every span opened inside
    it, another entry point's included, and every count made until the
    next outermost span, belongs to that frame. ``counters[frame][name]``:
    named integers added per frame. At most ``cap`` records are kept (a
    span, or a frame's counters); past it records are dropped and counted
    in ``dropped``. One thread's calls: spans opened in another thread at
    the same time would take the wrong parents."""

    def __init__(self, cap: int = RECORD_CAP):
        self.cap = cap
        self.spans: list[tuple] = []
        self.counters: dict[int, dict[str, int]] = {}
        self.frame = 0  # the latest outermost span's frame id (0: none yet)
        self.dropped = 0
        self._stack: list[Span] = []  # the open spans, innermost last

    def _open(self, span: Span):
        stack = self._stack
        if stack:
            span.parent = stack[-1].name
        else:
            self.frame += 1
        span.frame = self.frame
        stack.append(span)
        if len(self.spans) + len(self.counters) < self.cap:
            span._slot = len(self.spans)
            self.spans.append(None)  # filled when the span ends
        else:
            span._slot = None
            self.dropped += 1

    def _close(self, span: Span):
        self._stack.pop()  # spans close innermost first
        if span._slot is not None:
            self.spans[span._slot] = (span.name, span.parent, span.frame, span.t0, span.t1)

    def add(self, name: str, t0: int, t1: int):
        """Record a span that ran from ``t0`` to ``t1`` (``perf_counter_ns``
        stamps the caller took) inside the innermost open span: what a hot
        site records in place of a :class:`Span`, a tuple and no object."""
        if len(self.spans) + len(self.counters) < self.cap:
            self.spans.append((name, self._stack[-1].name if self._stack else None, self.frame, t0, t1))
        else:
            self.dropped += 1

    def count(self, name: str, n: int):
        """Add ``n`` to counter ``name`` of the current frame."""
        frame = self.counters.get(self.frame)
        if frame is None:
            if len(self.spans) + len(self.counters) >= self.cap:
                self.dropped += 1
                return
            frame = self.counters[self.frame] = {}
        frame[name] = frame.get(name, 0) + n

    def mean_ms(self, name: str) -> Optional[float]:
        """Mean duration of the spans named ``name``, ms; None where there
        are none."""
        ns = [t1 - t0 for n, _, _, t0, t1 in self.spans if n == name]
        return sum(ns) / len(ns) / 1e6 if ns else None

    def self_ms(self, name: str) -> Optional[float]:
        """Mean self time of the spans named ``name``, ms: each one's
        duration less that of its children in its frame."""
        own, inner = [], {}
        for n, parent, frame, t0, t1 in self.spans:
            if n == name:
                own.append((frame, t1 - t0))
            if parent == name:
                inner[frame] = inner.get(frame, 0) + t1 - t0
        return sum(ns - inner.get(f, 0) for f, ns in own) / len(own) / 1e6 if own else None

    def total(self, name: str) -> int:
        """Counter ``name`` summed over the frames."""
        return sum(c.get(name, 0) for c in self.counters.values())


_kept = threading.local()


def count(name: str, n: int):
    """Add ``n`` to counter ``name`` of the frame that runs: to the counts of
    the innermost :func:`frame_counts` block of this thread where one is
    open, else to the recorder where tracing is on; else nothing."""
    counts = getattr(_kept, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + n
    elif recorder is not None:
        recorder.count(name, n)


@contextlib.contextmanager
def frame_counts():
    """``with frame_counts() as counts:`` the frame run in the block counts
    (:func:`count`) into the dict ``counts``, not into the recorder. A
    captured frame keeps the counts of its capture and adds them to the
    recorder on each replay, which runs no Python."""
    before = getattr(_kept, "counts", None)
    _kept.counts = counts = {}
    try:
        yield counts
    finally:
        _kept.counts = before


@contextlib.contextmanager
def tracing(cap: int = RECORD_CAP):
    """``with tracing() as rec:`` the entry points' spans and counters go to
    ``rec`` (a new :class:`Recorder`) until the block ends; the recorder
    that was on before, if any, is on again after it."""
    global recorder
    prev, rec = recorder, Recorder(cap)
    recorder = rec
    try:
        yield rec
    finally:
        recorder = prev


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
    (the card's launches return before they run). Each stage is a
    :class:`Span`, recorded by the recorder that is on, if any.
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def stage(self, name: str, sync=None):
        return _Stage(self, name, sync)

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


class _Stage:
    """One :meth:`StageTimer.stage` block. A module-level class: a class
    made per call is a reference cycle left for the garbage collector."""

    def __init__(self, timer: StageTimer, name: str, sync):
        self.timer, self.name = timer, name
        self.dev = torch.device(sync) if sync is not None else None
        self.cuda = self.dev is not None and self.dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        self.span = Span(self.name, recorder).start()

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        self.span.stop()
        timer, name = self.timer, self.name
        timer.totals[name] = timer.totals.get(name, 0.0) + self.span.ns / 1e9
        timer.counts[name] = timer.counts.get(name, 0) + 1


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
