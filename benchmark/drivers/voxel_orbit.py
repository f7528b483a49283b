"""A closed loop over the port's voxel raycaster with one frame in flight:
each frame is requested once the last is complete on the device (a
synchronise), as a viewer that renders, then shows the frame, does.

The port's public ``voxel.VoxelRenderer`` is built once in set-up from the
seed's grids, at the configuration's size, level, cube and traversal; a
frame is its call ``renderer(eye, inv_mvp)`` (on the card one captured
graph a frame). The traffic's ``motion`` is ``orbit``: the camera steps
round the cube (``kinds/voxel.py``: ``orbit_view``), ``turn_steps`` views
of the whole turn from the seed's start, made once in set-up on the
device.
"""

from __future__ import annotations

import time

import torch

from benchmark.kinds import voxel


class Driver:
    def __init__(self, ctx):
        from f_renderer_tpu_torch.voxel import VoxelRenderConfig, VoxelRenderer

        self.ctx, c, t = ctx, ctx.cell.config, ctx.cell.traffic
        if t.get("in_flight", 1) != 1:
            raise ValueError("voxel_orbit keeps one frame in flight")
        if t["motion"] != "orbit":
            raise ValueError(f"voxel_orbit has no motion {t['motion']!r}")
        self.entry = t["entry"]
        cfg = VoxelRenderConfig(width=c["width"], height=c["height"], level=c["level"], length=c["length"],
                                background=tuple(c["background"]), traversal=c["traversal"])
        self.renderer = VoxelRenderer(ctx.inputs.grid_color, ctx.inputs.grid_hit, cfg, device=ctx.device)
        self.views = [voxel.orbit_view(c, t, j) for j in range(t["turn_steps"])]
        self.eyes = [torch.as_tensor(eye, device=ctx.device) for eye, _ in self.views]
        self.inv_mvps = [torch.as_tensor(inv_mvp, device=ctx.device) for _, inv_mvp in self.views]
        self.sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: None)
        self.k = 0  # frames requested so far, warm-up included

    def _view(self, k):
        return (self.ctx.inputs.start + k) % len(self.views)

    def window(self, seconds, log):
        """Frames until ``seconds`` have passed (at least one)."""
        t_end = time.perf_counter() + seconds
        while True:
            t0 = time.perf_counter()
            k, self.k = self.k, self.k + 1
            v = self._view(k)
            eye, inv_mvp = self.eyes[v], self.inv_mvps[v]
            t1 = time.perf_counter()
            frame = self.renderer(eye, inv_mvp)
            t2 = time.perf_counter()
            self.sync()
            t3 = time.perf_counter()
            log.span("motion", t0, t1)
            log.span("entry", t1, t2)
            log.span("sync", t2, t3)
            slot = log.wants()
            log.frame(k, t0, t3, slot, None if slot is None else (frame, None))
            if t3 >= t_end:
                return

    def reference_cases(self, frames):
        """The inputs of each frame for the reference: its eye and inv_mvp."""
        return {k: dict(eye=self.views[self._view(k)][0], inv_mvp=self.views[self._view(k)][1]) for k in frames}

    def release(self):
        from f_renderer_tpu_torch import compiled

        self.renderer = self.eyes = self.inv_mvps = None
        compiled.CACHE.clear()
