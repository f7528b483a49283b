"""A closed loop with one frame in flight: each frame is requested once the
last is complete on the device (a synchronise), as a caller that renders,
then uses the frame, does.

The traffic file says what changes a frame (``motion``) and which entry
point the frame goes through (``entry``):

- ``turntable``: the model turns about y by ``step_rad`` a frame, through
  ``turn_steps`` steps of the whole turn from the seed's start; the model
  matrices are made once in set-up on the device. Entry ``render``:
  ``Scene.render()``.
- ``retexture``: ``prepare()`` once with the model at ``angle_rad``, then
  ``render_prepared`` a frame with ``ps_uniform["textures"]`` swapped among
  ``stacks`` stacks of equal shape in a seeded order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.kinds.triangle import rotate
from benchmark.scenes import seed_stream


def model_matrix(angle: float, device) -> torch.Tensor:
    """The model turned by ``angle`` about y, made by the benchmark."""
    y = torch.tensor([0.0, 1.0, 0.0], device=device)
    return rotate(y, torch.tensor(angle, dtype=torch.float32, device=device))


def make_scene(ctx, textures):
    """The port's scene of the config, built by its public constructor from
    the benchmark's meshes and textures."""
    from f_renderer_tpu_torch.camera import Camera
    from f_renderer_tpu_torch.scene import make_phong_scene

    c, cam = ctx.cell.config, ctx.cell.config["camera"]
    return make_phong_scene(
        c["width"], c["height"], meshes=ctx.inputs.meshes, textures=textures,
        camera=Camera.create(cam["eye"], cam["at"], cam["up"], device=ctx.device),
        clip_cap=c["clip_cap"], shader=c["shader"], device=ctx.device)


class Driver:
    def __init__(self, ctx):
        from f_renderer_tpu_torch.shaders import TextureStack

        self.ctx, t = ctx, ctx.cell.traffic
        if t.get("in_flight", 1) != 1:
            raise ValueError("closed_loop keeps one frame in flight")
        self.motion, self.entry = t["motion"], t["entry"]
        self.scene = make_scene(ctx, ctx.inputs.stacks[0])
        self.sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: None)
        self.k = 0  # frames requested so far, warm-up included
        if self.motion == "turntable":
            self.models = [model_matrix(t["step_rad"] * j, ctx.device) for j in range(t["turn_steps"])]
        elif self.motion == "retexture":
            self.models = [model_matrix(t["angle_rad"], ctx.device)]
            self.stacks = [TextureStack.create(s, device=ctx.device) for s in ctx.inputs.stacks]
            self.order = seed_stream(ctx.seed, "retexture").integers(0, len(self.stacks), 1 << 20)
            self.scene.vs_uniform = dict(self.scene.vs_uniform, model=self.models[0])
            self.prepared = self.scene.prepare()
        else:
            raise ValueError(f"closed_loop has no motion {self.motion!r}")

    def _model(self, k):
        return (self.ctx.inputs.start + k) % len(self.models)

    def _stack(self, k):
        return int(self.order[k % len(self.order)])

    def _frame(self, k):
        """Request frame ``k`` → its outputs (frame, depth)."""
        scene = self.scene
        if self.motion == "turntable":
            scene.vs_uniform = dict(scene.vs_uniform, model=self.models[self._model(k)])
        else:
            scene.ps_uniform = dict(scene.ps_uniform, textures=self.stacks[self._stack(k)])
        t1 = time.perf_counter()
        out = scene.render() if self.entry == "render" else scene.render_prepared(self.prepared)
        return t1, time.perf_counter(), out[0], out[1]

    def window(self, seconds, log):
        """Frames until ``seconds`` have passed (at least one)."""
        t_end = time.perf_counter() + seconds
        while True:
            t0 = time.perf_counter()
            k, self.k = self.k, self.k + 1
            t1, t2, frame, depth = self._frame(k)
            self.sync()
            t3 = time.perf_counter()
            log.span("motion", t0, t1)
            log.span("entry", t1, t2)
            log.span("sync", t2, t3)
            slot = log.wants()
            log.frame(k, t0, t3, slot, None if slot is None else (frame, depth))
            if t3 >= t_end:
                return

    def reference_cases(self, frames):
        """The inputs of each frame for the reference: model, eye, at, up,
        texture stack."""
        cam = self.ctx.cell.config["camera"]
        eye, at, up = (np.asarray(cam[k], np.float32) for k in ("eye", "at", "up"))
        out = {}
        for k in frames:
            if self.motion == "turntable":
                out[k] = dict(model=self.models[self._model(k)], eye=eye, at=at, up=up, stack=0)
            else:
                out[k] = dict(model=self.models[0], eye=eye, at=at, up=up, stack=self._stack(k))
        return out

    def release(self):
        from f_renderer_tpu_torch import compiled

        self.scene = self.prepared = self.stacks = None
        compiled.CACHE.clear()
