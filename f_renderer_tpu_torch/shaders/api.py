"""Shader context flattening.

The pipeline interpolates varyings as flat channel planes (the reference's
Add/Sub/Mul<f32> trait bound, renderer.rs:97-102, collapses to vector
arithmetic). Shaders see a dict of named attributes; the codec maps between
the two with a static channel layout.

The channel order is the sorted order of the dict keys — the order
``jax.tree.flatten`` gives the JAX package — so a TriangleBuffer's ctx rows
compare one to one between the two packages. For the Phong shader that is
normal(3), pos(3), uv(2).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ContextCodec:
    """(key, width) pairs in channel order."""

    layout: tuple

    @staticmethod
    def of(ctx: dict) -> "ContextCodec":
        """Layout of a vertex-shader context whose leaves are (N, k) or (N,)."""
        return ContextCodec(
            tuple((k, 1 if ctx[k].dim() == 1 else ctx[k].shape[1]) for k in sorted(ctx))
        )

    @property
    def num_channels(self) -> int:
        return sum(w for _, w in self.layout)

    def flatten(self, ctx: dict) -> torch.Tensor:
        """{key: (N, k)} → (C, N) channel planes."""
        n = next(iter(ctx.values())).shape[0]
        return torch.cat(
            [ctx[k].to(torch.float32).reshape(n, w).T for k, w in self.layout]
        )

    def unflatten(self, planes: torch.Tensor) -> dict:
        """(C, ...) channel planes → {key: (k, ...)}."""
        out, i = {}, 0
        for k, w in self.layout:
            out[k] = planes[i : i + w]
            i += w
        return out
