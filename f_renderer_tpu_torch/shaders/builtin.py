"""Built-in shader programs reproducing the reference example shaders.

Port of ``f_renderer_tpu/shaders/builtin.py``. Each factory returns
``(vertex_shader, pixel_shader)``:

  vertex_shader(vs_uniform, vs_input) -> (clip (4, N), context)
      ``vs_input`` maps attribute names to (N, k) tensors over all 3F face
      corners at once; ``context`` maps varying names to (N, k) tensors.
  pixel_shader(ps_uniform, context, ps_index) -> rgba (4, *S)
      ``context`` maps varying names to (k, *S) channel planes.

Pixel shaders carry ``fused_kind`` (and the light constants) so the fused
path knows them. Their bodies are the plain version of the fused kernel's
shading epilogue (``csrc/fused_raster.cu``), written with the same
expression shapes: the JAX package's planar epilogue (fused.py:46-117),
not its norm-based ``_phong_lighting``. The shaders sample with
``TextureStack.sample`` (the K3 kernel on the card); ``shade_plain`` runs
the same bodies with the plain sampler, for the fused kernel's plain
version.

Phong constants match phong.rs:128-132: white light at (1.2, 1.0, 2.0),
ambient 0.1, specular 0.5 · (V·R)^32.
"""

from __future__ import annotations

import torch

from f_renderer_tpu_torch.math import mat_mul4, mat_vec4, normalize, reflect
from f_renderer_tpu_torch.math.transforms import _dot3, true_div, true_sqrt
from f_renderer_tpu_torch.shaders.texture import TextureStack

LIGHT_COLOR = (1.0, 1.0, 1.0)
LIGHT_POS = (1.2, 1.0, 2.0)
AMBIENT_STRENGTH = 0.1
SPECULAR_STRENGTH = 0.5


def pow32(x):
    """x**32 as five squarings — how ``lax.integer_pow`` evaluates it."""
    for _ in range(5):
        x = x * x
    return x


def _mvp_transform(u, pos):
    """clip = proj·view·model·(pos, 1), the MVP composed at full float32."""
    mvp = mat_mul4(u["proj"], mat_mul4(u["view"], u["model"]))
    p = [pos[:, 0], pos[:, 1], pos[:, 2], torch.ones_like(pos[:, 0])]
    return mat_vec4(mvp, p), p


def _phong_lighting(normal, world_pos, view_pos, light_pos, light_color):
    """The phong.rs:133-144 lighting sum on (N, 3) rows — the Gouraud vertex
    shader's form (norm and divide, as the JAX package's builtin has it)."""
    dev = normal.device
    lc = torch.tensor(light_color, dtype=torch.float32, device=dev)
    lp = torch.tensor(light_pos, dtype=torch.float32, device=dev)
    ambient = lc * AMBIENT_STRENGTH
    n = normalize(normal)
    light_dir = normalize(lp - world_pos)
    diff = torch.clamp(_dot3(n, light_dir), min=0.0).unsqueeze(-1)
    view_dir = normalize(view_pos - world_pos)
    reflect_dir = reflect(-light_dir, n)
    spec = pow32(torch.clamp(_dot3(view_dir, reflect_dir), min=0.0)).unsqueeze(-1)
    return ambient + diff * lc + SPECULAR_STRENGTH * spec * lc


def _normalize3(x, y, z):
    """Planar normalize by 1/sqrt — correctly rounded sqrt and divide, so the
    plain version and the kernel (which does the same) agree to the bit."""
    inv = true_div(1.0, true_sqrt((x * x + y * y) + z * z))
    return x * inv, y * inv, z * inv


def phong_light_planar(n, p, view_pos, light_pos, light_color):
    """Planar mirror of the lighting sum (fused.py:55-67) on (3, *S) planes."""
    lp, lc = light_pos, light_color
    nx, ny, nz = _normalize3(n[0], n[1], n[2])
    ldx, ldy, ldz = _normalize3(lp[0] - p[0], lp[1] - p[1], lp[2] - p[2])
    diff = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
    vdx, vdy, vdz = _normalize3(view_pos[0] - p[0], view_pos[1] - p[1], view_pos[2] - p[2])
    # reflect(-light_dir, n) = normalize(2 (L·N) N − L), L = -light_dir
    d = -(ldx * nx + ldy * ny + ldz * nz)
    rx, ry, rz = _normalize3(2.0 * d * nx + ldx, 2.0 * d * ny + ldy, 2.0 * d * nz + ldz)
    spec = pow32(torch.clamp(vdx * rx + vdy * ry + vdz * rz, min=0.0))
    return [
        AMBIENT_STRENGTH * lc[c] + diff * lc[c] + SPECULAR_STRENGTH * spec * lc[c]
        for c in range(3)
    ]


def _textures(u, device) -> TextureStack:
    stack = u.get("textures")
    return stack if stack is not None else TextureStack.dummy(device)


def _flat_pixel(ctx):
    return ctx["color"]


def _gouraud_pixel(ctx):
    color = ctx["color"]
    return torch.cat([color, torch.ones_like(color[:1])])


def _textured_pixel(sample, ctx, ps_index):
    return sample(ps_index, ctx["uv"][0], ctx["uv"][1])


def _phong_pixel(sample, u, ctx, ps_index, light_pos, light_color):
    light = phong_light_planar(ctx["normal"], ctx["pos"], u["view_pos"], light_pos, light_color)
    tex = sample(ps_index, ctx["uv"][0], ctx["uv"][1])
    return torch.stack([tex[0] * light[0], tex[1] * light[1], tex[2] * light[2], tex[3]])


def shade_plain(kind, u, ctx, ps_index, light_pos=LIGHT_POS, light_color=LIGHT_COLOR):
    """The builtin pixel shader of ``fused_kind`` ``kind``, sampling textures
    with the plain sampler: the plain version of the fused kernel's shading
    epilogue, which launches no kernel on any device."""
    sample = _textures(u, ps_index.device).sample_plain
    if kind == "flat":
        return _flat_pixel(ctx)
    if kind == "gouraud":
        return _gouraud_pixel(ctx)
    if kind == "textured":
        return _textured_pixel(sample, ctx, ps_index)
    if kind == "phong":
        return _phong_pixel(sample, u, ctx, ps_index, light_pos, light_color)
    raise ValueError(f"no builtin shading of kind {kind!r}")


class FlatShader:
    """Per-face constant color: the context carries an rgba color attribute."""

    @staticmethod
    def vertex(u, vin):
        clip, _ = _mvp_transform(u, vin["pos"])
        return clip, {"color": vin["color"]}

    @staticmethod
    def pixel(u, ctx, ps_index):
        return _flat_pixel(ctx)


FlatShader.pixel.fused_kind = "flat"


def make_phong_shaders(light_pos=LIGHT_POS, light_color=LIGHT_COLOR):
    """Textured per-pixel Phong (phong.rs:114-154).

    vs_uniform: {"model", "view", "proj"} (4, 4) each.
    vs_input:   {"pos" (N, 3), "uv" (N, 2), "normal" (N, 3)}.
    ps_uniform: {"textures": TextureStack, "view_pos" (3,)}.
    """

    def vertex(u, vin):
        clip, p = _mvp_transform(u, vin["pos"])
        world = mat_vec4(u["model"], p)
        return clip, {"uv": vin["uv"], "normal": vin["normal"], "pos": world[:3].T}

    def pixel(u, ctx, ps_index):
        sample = _textures(u, ps_index.device).sample
        return _phong_pixel(sample, u, ctx, ps_index, light_pos, light_color)

    pixel.fused_kind = "phong"
    pixel.light_pos = tuple(light_pos)
    pixel.light_color = tuple(light_color)
    return vertex, pixel


def make_textured_shaders():
    """Unlit perspective-correct textured (BASELINE config #3)."""

    def vertex(u, vin):
        clip, _ = _mvp_transform(u, vin["pos"])
        return clip, {"uv": vin["uv"]}

    def pixel(u, ctx, ps_index):
        return _textured_pixel(_textures(u, ps_index.device).sample, ctx, ps_index)

    pixel.fused_kind = "textured"
    return vertex, pixel


def make_gouraud_shaders(light_pos=LIGHT_POS, light_color=LIGHT_COLOR):
    """Vertex-lit Gouraud (BASELINE config #2): the Phong lighting sum
    evaluated per vertex and interpolated as a color varying."""

    def vertex(u, vin):
        clip, p = _mvp_transform(u, vin["pos"])
        world = mat_vec4(u["model"], p)
        light = _phong_lighting(
            vin["normal"], world[:3].T, u["view_pos"], light_pos, light_color
        )
        base = vin.get("color")
        return clip, {"color": light if base is None else base * light}

    def pixel(u, ctx, ps_index):
        return _gouraud_pixel(ctx)

    pixel.fused_kind = "gouraud"
    pixel.light_pos = tuple(light_pos)
    pixel.light_color = tuple(light_color)
    return vertex, pixel
