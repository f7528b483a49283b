"""Scene / application layer (reference: examples/src/bin/phong.rs).

Port of ``f_renderer_tpu/scene.py``: a ``Scene`` on an explicit device whose
``render()`` runs the whole frame and whose ``prepare()`` /
``render_prepared()`` split it into geometry + binning and the fused kernel
alone, plus the procedural meshes and textures the tests and benchmarks use
(numpy builders, copied from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from f_renderer_tpu_torch.camera import Camera
from f_renderer_tpu_torch.device import resolve_device
from f_renderer_tpu_torch.math import set_identity, set_perspective
from f_renderer_tpu_torch.pipeline.fused import fused_path_ok, prep_fused, render_fused_prepared
from f_renderer_tpu_torch.pipeline.raster import BinnedPrep
from f_renderer_tpu_torch.pipeline.render import RenderConfig, build_triangles, render_frame
from f_renderer_tpu_torch.shaders import (
    FlatShader,
    TextureStack,
    make_gouraud_shaders,
    make_phong_shaders,
    make_textured_shaders,
)


@dataclasses.dataclass
class Scene:
    """A multi-mesh scene with per-draw textures (phong.rs:166-184).

    ``draws`` are dicts of (F, 3, k) tensors; every tensor of the scene lies
    on ``device``.
    """

    draws: Sequence
    vertex_shader: Callable
    pixel_shader: Callable
    vs_uniform: dict
    ps_uniform: dict
    config: RenderConfig
    device: torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def render(self):
        """Render one frame → (frame (H, W, 4) uint8, depth (H, W) f32, stats)."""
        return render_frame(
            list(self.draws),
            self.vertex_shader,
            self.vs_uniform,
            self.pixel_shader,
            self.ps_uniform,
            self.config,
        )

    def prepare(self) -> BinnedPrep:
        """Geometry and binning for the current geometry and camera
        (``fused.prep_fused``): pass the result to :meth:`render_prepared`.

        For a static scene under animated shading (``view_pos``, light,
        texture swaps of equal shape) a frame is then the fused kernel alone.
        Camera or vertex motion changes the screen-space triangles the bins
        index, so it needs a fresh ``prepare()``. Raises ``ValueError`` where
        the fused kernel cannot run the scene: a pixel shader without
        ``fused_kind``, a texture stack past ``PACKED_VMEM_BUDGET``, or the
        portable backend.
        """
        if self.config.backend != "kernels" or not hasattr(self.pixel_shader, "fused_kind"):
            raise ValueError(
                "Scene.prepare requires backend='kernels' and a fused-eligible "
                "pixel shader (builtin flat/gouraud/textured/phong)"
            )
        if not fused_path_ok(self.pixel_shader, self.ps_uniform):
            raise ValueError("texture stack exceeds the fused kernel's budget (PACKED_VMEM_BUDGET)")
        tri, _ = build_triangles(list(self.draws), self.vertex_shader, self.vs_uniform, self.config)
        return prep_fused(tri, self.config)

    def render_prepared(self, prepared: BinnedPrep):
        """Render from :meth:`prepare` products, reading only the shading
        uniforms (``ps_uniform``) afresh → (frame (H, W, 4) uint8, depth
        (H, W) f32, winner (H, W) int32)."""
        return render_fused_prepared(prepared, self.pixel_shader, self.ps_uniform, self.config)


# ---------------------------------------------------------------------------
# Procedural geometry (numpy)
# ---------------------------------------------------------------------------


def make_cube(size: float = 1.0) -> dict:
    """12-triangle cube with per-face normals and uvs; corners (12, 3, ...)."""
    s = size * 0.5
    v = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
        np.float32,
    )
    quads = [
        ((0, 1, 3, 2), (-1, 0, 0)),
        ((4, 6, 7, 5), (1, 0, 0)),
        ((0, 4, 5, 1), (0, -1, 0)),
        ((2, 3, 7, 6), (0, 1, 0)),
        ((0, 2, 6, 4), (0, 0, -1)),
        ((1, 5, 7, 3), (0, 0, 1)),
    ]
    pos, normal, uv, color = [], [], [], []
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    palette = np.array(
        [
            [0.9, 0.2, 0.2, 1],
            [0.2, 0.9, 0.2, 1],
            [0.2, 0.2, 0.9, 1],
            [0.9, 0.9, 0.2, 1],
            [0.9, 0.2, 0.9, 1],
            [0.2, 0.9, 0.9, 1],
        ],
        np.float32,
    )
    for qi, (idx, n) in enumerate(quads):
        for tri in ((0, 1, 2), (0, 2, 3)):
            pos.append(v[[idx[t] for t in tri]])
            uv.append(quad_uv[list(tri)])
            normal.append(np.tile(np.asarray(n, np.float32), (3, 1)))
            color.append(np.tile(palette[qi], (3, 1)))
    return {
        "pos": np.stack(pos),
        "uv": np.stack(uv),
        "normal": np.stack(normal),
        "color": np.stack(color),
    }


def make_uv_sphere(n_lat: int = 36, n_lon: int = 72, radius: float = 1.0) -> dict:
    """UV sphere (~2·n_lat·n_lon triangles) with smooth normals and uvs."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(th) * np.cos(ph)
    y = np.cos(th)
    z = np.sin(th) * np.sin(ph)
    p = np.stack([x, y, z], axis=-1).astype(np.float32)
    u = (ph / (2 * np.pi)).astype(np.float32)
    v = (th / np.pi).astype(np.float32)
    uvg = np.stack([u, v], axis=-1)

    pos, uv, normal = [], [], []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b, c, d = p[i, j], p[i + 1, j], p[i + 1, j + 1], p[i, j + 1]
            ua, ub, uc, ud = uvg[i, j], uvg[i + 1, j], uvg[i + 1, j + 1], uvg[i, j + 1]
            for tri_p, tri_u in (((a, b, c), (ua, ub, uc)), ((a, c, d), (ua, uc, ud))):
                pos.append(np.stack(tri_p))
                uv.append(np.stack(tri_u))
                normal.append(np.stack(tri_p))  # unit sphere: normal = pos
    return {
        "pos": np.stack(pos) * radius,
        "uv": np.stack(uv),
        "normal": np.stack(normal),
    }


def make_instanced_soup(
    n_tris: int, seed: int = 0, spread: float = 8.0, size: float = 0.08,
    box: float | None = None,
) -> dict:
    """Random triangle soup for stress benchmarks (stress4k: one million
    triangles, ``box=3.2``). Bit-identical to the JAX package's builder for
    the same arguments.

    ``box``: centres uniform in the origin-centred cube [-box, box]³, a
    y-rotation-invariant, frustum-interior distribution. Default (None):
    x, y ∈ ±spread, z ∈ [2, 30], which crosses the frustum planes.
    """
    rng = np.random.default_rng(seed)
    if box is not None:
        centers = rng.uniform(-box, box, (n_tris, 3)).astype(np.float32)
    else:
        centers = rng.uniform(
            [-spread, -spread, 2.0], [spread, spread, 30.0], (n_tris, 3)
        ).astype(np.float32)
    offs = rng.uniform(-size * 10, size * 10, (n_tris, 3, 3)).astype(np.float32)
    pos = centers[:, None, :] + offs * size / 0.08 * 0.08
    normal = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    nn = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = (normal / np.where(nn == 0, 1, nn)).astype(np.float32)
    uv = rng.random((n_tris, 3, 2)).astype(np.float32)
    return {
        "pos": pos.astype(np.float32),
        "uv": uv,
        "normal": np.repeat(normal[:, None, :], 3, axis=1),
    }


def make_checker_texture(n: int = 64, cell: int = 4) -> np.ndarray:
    tex = np.zeros((n, n, 4), np.float32)
    ix = np.arange(n)
    mask = (ix[:, None] // cell + ix[None, :] // cell) % 2 == 0
    tex[mask] = [0.85, 0.65, 0.25, 1.0]
    tex[~mask] = [0.25, 0.45, 0.85, 1.0]
    return tex


SHADERS = {
    "phong": make_phong_shaders,
    "gouraud": make_gouraud_shaders,
    "textured": make_textured_shaders,
    "flat": lambda: (FlatShader.vertex, FlatShader.pixel),
}


def make_phong_scene(
    width: int,
    height: int,
    meshes: Sequence[dict] | None = None,
    textures: Sequence[np.ndarray] | None = None,
    camera: Camera | None = None,
    clip_cap: int = 256,
    shader: str = "phong",
    device="cuda",
) -> Scene:
    """A ready-to-render multi-mesh scene (the phong.rs workload shape).

    ``shader``: "phong" (textured per-pixel, the default) | "gouraud"
    (vertex-lit) | "textured" (unlit bilinear) | "flat" (per-face color;
    meshes must carry a "color" attribute, as make_cube does).
    """
    device = resolve_device(device)
    if meshes is None:
        meshes = [make_cube()]
    if textures is None:
        textures = [make_checker_texture()] * len(meshes)
    if camera is None:
        camera = Camera.create([0.0, 1.0, 3.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0], device)
    vs, ps = SHADERS[shader]()
    draw_keys = ("pos", "color") if shader == "flat" else ("pos", "uv", "normal")
    vs_uniform = {
        "model": set_identity(device),
        "view": camera.look_at().to(device),
        "proj": set_perspective(np.pi * 0.25, width / height, 0.1, 100.0, device),
    }
    if shader == "gouraud":
        vs_uniform["view_pos"] = camera.eye.to(device)  # lighting runs in the VS
    return Scene(
        draws=[{k: torch.as_tensor(m[k], device=device) for k in draw_keys} for m in meshes],
        vertex_shader=vs,
        pixel_shader=ps,
        vs_uniform=vs_uniform,
        ps_uniform={
            "textures": TextureStack.create(list(textures), device=device),
            "view_pos": camera.eye.to(device),
        },
        config=RenderConfig(
            width=width, height=height, background=(30, 30, 30, 255), clip_cap=clip_cap
        ),
        device=device,
    )


def make_sliver_scene(
    width: int, height: int, tile=(32, 128), n: int = 240, seed: int = 0, device="cuda"
) -> Scene:
    """An edge-case scene for the binned raster: 1- and 2-pixel triangles at
    the corners of the 32 x (rows / 4) rectangles the raster kernels' warps
    own and of the bin tiles, and long slivers (diagonal, one pixel tall,
    one pixel wide) that span many tiles, at three shared depths (exact rhw
    ties, decided by draw order) and at random ones. ``bin_k=1`` sends every
    triangle that spans two tiles to the coarse or spill range.

    Vertices are placed in pixels: the projection maps (x, y, z) to
    w = 1 + z/2, NDC (x, y) / w, so a vertex at NDC · w lands on its pixel.
    """
    rng = np.random.default_rng(seed)
    rows = tile[0] // 4
    corners_x = np.arange(32, width, 32)
    corners_y = np.arange(rows, height, rows)

    def px(lo, hi, size):
        return rng.integers(lo, hi, size)

    tris = []
    for _ in range(n // 2):  # 1- and 2-pixel right triangles around a corner
        x = int(rng.choice(corners_x)) + int(px(-2, 1, 1)[0])
        y = int(rng.choice(corners_y)) + int(px(-2, 1, 1)[0])
        s, fx, fy = int(px(1, 3, 1)[0]), int(rng.choice([-1, 1])), int(rng.choice([-1, 1]))
        tris.append([(x, y), (x + fx * s, y), (x, y + fy * s)])
    for _ in range(n // 4):  # diagonal slivers across the frame
        x0, x1 = px(0, width - 1, 2)
        y0, y1 = px(0, height - 1, 2)
        tris.append([(x0, y0), (x1, y1), (x1 + 1, y1)])
    for _ in range(n // 8):  # one pixel tall, at a warp-rectangle row edge
        x0, x1 = np.sort(px(0, width, 2))
        y = int(rng.choice(corners_y))
        tris.append([(x0, y), (x1, y), (x1, y + 1)])
    for _ in range(n - len(tris)):  # one pixel wide, at a warp column edge
        y0, y1 = np.sort(px(0, height, 2))
        x = int(rng.choice(corners_x))
        tris.append([(x, y0), (x, y1), (x + 1, y1)])
    xy = np.clip(np.asarray(tris, np.float64), 0, [width - 1, height - 1])
    shared = rng.random(len(tris)) < 0.5
    z = np.where(shared[:, None], rng.choice([0.25, 0.5, 0.75], len(tris))[:, None], rng.random((len(tris), 3)))
    w = 1.0 + 0.5 * z
    nx, ny = 2.0 * xy[..., 0] / width - 1.0, 1.0 - 2.0 * xy[..., 1] / height
    mesh = {
        "pos": np.stack([nx * w, ny * w, z], axis=-1).astype(np.float32),
        "uv": rng.random((len(tris), 3, 2)).astype(np.float32),
        "normal": np.tile(np.array([0.3, 0.2, -1.0], np.float32), (len(tris), 3, 1)),
    }
    scene = make_phong_scene(
        width, height, meshes=[mesh], textures=[make_checker_texture(64, 8)], clip_cap=64, device=device
    )
    proj = torch.tensor(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0.5, 0], [0, 0, 0.5, 1]], dtype=torch.float32, device=scene.device
    )
    eye = set_identity(scene.device)
    scene.vs_uniform = dict(scene.vs_uniform, model=eye, view=eye, proj=proj)
    scene.config = dataclasses.replace(scene.config, tile=tuple(tile), bin_k=1)
    return scene
