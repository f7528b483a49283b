"""Sparse-voxel-octree raycaster (reference: examples/src/bin/voxel.rs).

Port of ``f_renderer_tpu/voxel``: the octree is built on the host (numpy)
and densified into a 2^(level+1)³ table; on the card one kernel sets up
every pixel's ray (``csrc/voxel_setup.cu``) and every ray marches through
the table in the K5 kernel (``csrc/voxel_march.cu``). ``VoxelRenderer``
builds the table once for fixed grids; ``render_voxel_frame`` takes the
grids as inputs of every frame.
"""

from f_renderer_tpu_torch.voxel.octree import SvoArrays, Voxel, densify, flatten, gen_randomly
from f_renderer_tpu_torch.voxel.raycast import (
    VoxelRenderConfig,
    VoxelRenderer,
    cube_intersect,
    march_frame,
    render_voxel_frame,
    voxel_frame,
)

__all__ = [
    "SvoArrays",
    "Voxel",
    "densify",
    "flatten",
    "gen_randomly",
    "VoxelRenderConfig",
    "VoxelRenderer",
    "cube_intersect",
    "march_frame",
    "render_voxel_frame",
    "voxel_frame",
]
