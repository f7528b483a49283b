"""L0 math utilities (reference: matrix_util.rs, vector_util.rs)."""

from f_renderer_tpu_torch.math.transforms import (
    mat_mul4,
    mat_vec4,
    normalize,
    reflect,
    set_identity,
    set_look_at,
    set_perspective,
    set_rotate,
    set_scale,
    transform_points_h,
)

__all__ = [
    "mat_mul4",
    "mat_vec4",
    "normalize",
    "reflect",
    "set_identity",
    "set_look_at",
    "set_perspective",
    "set_rotate",
    "set_scale",
    "transform_points_h",
]
