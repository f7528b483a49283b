"""Pipeline data types (port of ``f_renderer_tpu/pipeline/types.py``).

The reference's per-vertex AoS record (renderer.rs:387-409) becomes a
planar triangle setup buffer: fixed-shape tensors over M triangle slots with
the slot dim last, invalid slots masked. Field shapes and the slot layout
are the JAX package's, so slot ids (the rasterizer's winner ids) compare
one to one between the two packages.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TriangleBuffer:
    """Raster-ready triangle setup (post geometry stage, winding repaired).

    - ``spi``: (3, 2, M) int32 — integer screen coords [vertex][x|y][slot]
    - ``spf``: (3, 2, M) float32 — float screen coords
    - ``rhw``: (3, M) float32 — 1/w per vertex
    - ``ctx``: (3C, M) float32 — varyings, vertex-major (v0 ch0..C-1, v1 …, v2 …)
    - ``top_left``: (3, M) bool — top-left flags for edges 0→1, 1→2, 2→0
    - ``valid``: (M,) bool — the slot holds a real triangle
    - ``order``: (M,) int32 — submission order, the depth-tie tiebreaker
    - ``ps_index``: (M,) int32 — draw index selecting the texture
    """

    spi: torch.Tensor
    spf: torch.Tensor
    rhw: torch.Tensor
    ctx: torch.Tensor
    top_left: torch.Tensor
    valid: torch.Tensor
    order: torch.Tensor
    ps_index: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.spi.shape[-1]

    @property
    def num_channels(self) -> int:
        return self.ctx.shape[0] // 3

    @staticmethod
    def concat(bufs) -> "TriangleBuffer":
        """Join buffers along the slot axis (the last axis of every field)."""
        return TriangleBuffer(
            **{
                f.name: torch.cat([getattr(b, f.name) for b in bufs], dim=-1)
                for f in dataclasses.fields(TriangleBuffer)
            }
        )
