"""The six triangle scenes of the JAX package's benchmark, built with the port.

The same meshes, cameras, sizes, shaders and clip caps as ``bench.py``'s
``build_scene`` (:60-154), built with the port's numpy builders (identical
to the JAX package's) on ``device``. A frame at bench angle ``a`` rotates the
model by ``a`` about y; the bench's frames take 0.1 + 0.05 i.
"""

from __future__ import annotations

import numpy as np

from f_renderer_tpu_torch.camera import Camera
from f_renderer_tpu_torch.math import set_rotate
from f_renderer_tpu_torch.scene import (
    Scene,
    make_checker_texture,
    make_cube,
    make_instanced_soup,
    make_phong_scene,
    make_uv_sphere,
)

NAMES = ("cube512", "cube1080", "gouraud800", "textured1080", "phong1080", "stress4k")


def build_scene(name: str, device="cuda") -> Scene:
    """Bench scene ``name`` (one of :data:`NAMES`) on ``device``."""
    front = ([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    above = ([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    if name == "cube512":
        return make_phong_scene(512, 512, meshes=[make_cube()], clip_cap=16, device=device)
    if name == "cube1080":  # flat-shaded cube at 1080p
        return make_phong_scene(
            1920, 1080, meshes=[make_cube()], camera=Camera.create(*above, device=device),
            clip_cap=16, shader="flat", device=device,
        )
    if name == "gouraud800":
        return make_phong_scene(
            800, 600, meshes=[make_uv_sphere(36, 72)], camera=Camera.create(*front, device=device),
            clip_cap=64, shader="gouraud", device=device,
        )
    if name == "textured1080":
        return make_phong_scene(
            1920, 1080, meshes=[make_uv_sphere(48, 96)], camera=Camera.create(*front, device=device),
            clip_cap=64, shader="textured", device=device,
        )
    if name == "phong1080":  # three meshes, three 512² diffuse maps
        cube = make_cube(0.8)
        cube["pos"] = cube["pos"] + np.array([1.6, 0.0, 0.0], np.float32)
        cube2 = make_cube(0.8)
        cube2["pos"] = cube2["pos"] + np.array([-1.6, 0.0, 0.0], np.float32)
        return make_phong_scene(
            1920, 1080, clip_cap=64, meshes=[make_uv_sphere(40, 80), cube, cube2],
            textures=[make_checker_texture(512, 32), make_checker_texture(512, 16),
                      make_checker_texture(512, 24)],
            camera=Camera.create(*above, device=device), device=device,
        )
    if name == "stress4k":
        # One million triangles in the cube [-3.2, 3.2]³ seen from z = -12:
        # every face stays inside the frustum at every y rotation, so few
        # clip (44 at the worst bench angle, 0.80); clip_cap=512 drops none.
        return make_phong_scene(
            3840, 2160, meshes=[make_instanced_soup(1_000_000, box=3.2)],
            camera=Camera.create([0.0, 0.0, -12.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device=device),
            clip_cap=512, device=device,
        )
    raise ValueError(f"unknown bench scene {name!r}: one of {NAMES}")


def set_angle(scene: Scene, angle: float) -> None:
    """Rotate the scene's model by ``angle`` about y, as a bench frame does."""
    scene.vs_uniform = dict(scene.vs_uniform, model=set_rotate([0.0, 1.0, 0.0], angle, scene.device))
