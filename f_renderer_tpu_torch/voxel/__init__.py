"""Sparse-voxel-octree raycaster (reference: examples/src/bin/voxel.rs).

Port of ``f_renderer_tpu/voxel``: the octree is built on the host (numpy)
and densified into a 2^(level+1)³ table; every ray marches through it in the
K5 kernel on the card (``csrc/voxel_march.cu``).
"""

from f_renderer_tpu_torch.voxel.octree import SvoArrays, Voxel, densify, flatten, gen_randomly
from f_renderer_tpu_torch.voxel.raycast import (
    VoxelRenderConfig,
    cube_intersect,
    render_voxel_frame,
)

__all__ = [
    "SvoArrays",
    "Voxel",
    "densify",
    "flatten",
    "gen_randomly",
    "VoxelRenderConfig",
    "cube_intersect",
    "render_voxel_frame",
]
