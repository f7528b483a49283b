"""The kind of a triangle scene whose pixel shader is user code: its inputs,
the plain reference and the least work of a frame.

The scene and its frame are the triangle kind's (``kinds/triangle.py``):
the same meshes, textures and camera from the seed, and the same plain
reference, which renders phong.rs's frame with its own geometry, raster,
interpolation, sampler and Phong sum. It never calls the shader under test
(``benchmark/shaders/<pixel_shader>.py``, which the driver installs in the
port's scene), so a fault in that shader, in K4's planes, in the sampler or
in the capture of the frame shows in the comparison. Plain PyTorch; it
imports nothing of the port.

``per_frame`` is the triangle kind's, so ``frame_roofline`` reads the same
frame's least work as in a builtin-shader cell, plus the least work of
K4's job on the planes path (``planes_bytes``, ``planes_ops``): the
screen-space triangles read once; the winner, depth and each of the C
varying planes written once a pixel; and each covered pixel's raster test,
barycentrics, 1 / s and merge, its perspective weights and its C
varyings, counted as the triangle kind counts them.
"""

from __future__ import annotations

from benchmark.kinds import triangle

scene_inputs = triangle.scene_inputs
reference_frames = triangle.reference_frames

PLANE_BYTES = 4  # winner int32, depth and each varying float32
# A covered pixel's share of OPS_PER_COVERED_PIXEL that K4 does: the edge
# tests (15), barycentrics (20), 1 / s and rhw (9), the merge's compare (1),
# the perspective weights (7) and each varying's 5.
OPS_PLANES_PER_COVERED_PIXEL = 15 + 20 + 9 + 1 + 7
OPS_PER_VARYING = 5


def per_frame(config, traffic, inputs, counts) -> dict:
    """The triangle kind's least work of a frame and of its raster stage,
    and that of the planes K4 writes, from the reference's counts a frame."""
    work = triangle.per_frame(config, traffic, inputs, counts)
    c = triangle.VARYINGS[config["shader"]]
    pixels = config["width"] * config["height"]
    work["planes_bytes"] = (counts["emitted"] * triangle.screen_triangle_bytes(config["shader"])
                            + pixels * (2 + c) * PLANE_BYTES)
    work["planes_ops"] = counts["covered"] * (OPS_PLANES_PER_COVERED_PIXEL + c * OPS_PER_VARYING)
    return work
