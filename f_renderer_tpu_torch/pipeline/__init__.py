"""Geometry → bin → fused raster/shade pipeline."""

from f_renderer_tpu_torch.pipeline.render import (
    RenderConfig,
    apply_ps_boundary_quirk,
    build_triangles,
    render_frame,
)
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer

__all__ = [
    "RenderConfig",
    "TriangleBuffer",
    "apply_ps_boundary_quirk",
    "build_triangles",
    "render_frame",
]
