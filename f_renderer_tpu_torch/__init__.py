"""PyTorch + CUDA port of f_renderer_tpu (the JAX package stays the reference).

Imports ``torch`` and never ``jax`` or ``f_renderer_tpu``. The main path is
``Scene.render()`` with a builtin ``fused_kind`` shader: geometry and binning
as PyTorch ops, then one hand-written CUDA kernel (``csrc/``) on the card,
or its plain PyTorch version for tensors on the CPU. On the card each frame
of ``Scene.render()``, ``prepare()`` and ``voxel.render_voxel_frame`` is
one captured CUDA graph (``compiled``).
"""

from f_renderer_tpu_torch.camera import Camera
from f_renderer_tpu_torch.pipeline import RenderConfig, render_frame
from f_renderer_tpu_torch.scene import (
    Scene,
    make_checker_texture,
    make_cube,
    make_instanced_soup,
    make_phong_scene,
    make_uv_sphere,
)

__all__ = [
    "Camera",
    "RenderConfig",
    "Scene",
    "make_checker_texture",
    "make_cube",
    "make_instanced_soup",
    "make_phong_scene",
    "make_uv_sphere",
    "render_frame",
]
