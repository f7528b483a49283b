"""Built-in shader programs reproducing the reference example shaders.

Port of ``f_renderer_tpu/shaders/builtin.py``. Each factory returns
``(vertex_shader, pixel_shader)``:

  vertex_shader(vs_uniform, vs_input) -> (clip (4, N), context)
      ``vs_input`` maps attribute names to (N, k) tensors over all 3F face
      corners at once; ``context`` maps varying names to (N, k) tensors.
  pixel_shader(ps_uniform, context, ps_index) -> rgba (4, *S)
      ``context`` maps varying names to (k, *S) channel planes.

Vertex shaders carry ``fused_kind`` (and Gouraud's light constants) so the
triangle set-up kernel runs them in its first launch (csrc/tri_setup.cu),
from the draws' attributes; their bodies are that stage's plain version,
and :func:`vertex_layout` gives their varyings without running them. Pixel
shaders carry ``fused_kind`` (and the light constants), so the pipeline
never calls them: the fused kernel shades in its epilogue, and the
non-fused path launches ``kernels.shade_planes`` on K4's planes, both
through ``csrc/shade.cuh`` (:data:`PIXEL_KINDS`: each kind's code and
varyings). Their bodies are the plain version of that shading, written
with the same expression shapes: the JAX package's planar epilogue
(fused.py:46-117), not its norm-based ``_phong_lighting``. Called directly
they sample with ``TextureStack.sample`` (the K3 kernel on the card);
``shade_plain`` runs the same bodies with the plain sampler, for the
kernels' plain versions.

Phong constants match phong.rs:128-132: white light at (1.2, 1.0, 2.0),
ambient 0.1, specular 0.5 · (V·R)^32.
"""

from __future__ import annotations

import dataclasses

import torch

from f_renderer_tpu_torch.device import constant
from f_renderer_tpu_torch.math import mat_mul4, mat_vec4, normalize, reflect
from f_renderer_tpu_torch.math.transforms import _dot3, max0, true_div, true_sqrt
from f_renderer_tpu_torch.shaders.texture import TextureStack

LIGHT_COLOR = (1.0, 1.0, 1.0)
LIGHT_POS = (1.2, 1.0, 2.0)
AMBIENT_STRENGTH = 0.1
SPECULAR_STRENGTH = 0.5


@dataclasses.dataclass(frozen=True)
class VertexKind:
    """A builtin vertex stage as launch 1 of csrc/tri_setup.cu runs it:
    ``code``, its kind there (kFlat ...); ``attributes``, what it reads in
    the kernel's slots, (name, width or None for any width passed through,
    whether a draw may lack it); ``varyings``, what it emits in codec order
    (sorted names, shaders/api.py), (name, width or the name of the
    attribute whose width it takes)."""

    code: int
    attributes: tuple
    varyings: tuple


# Gouraud's colour may be missing: the colour is then the light itself.
VERTEX_KINDS = {
    "flat": VertexKind(1, (("pos", 3, False), ("color", None, False)), (("color", "color"),)),
    "textured": VertexKind(2, (("pos", 3, False), ("uv", 2, False)), (("uv", "uv"),)),
    "phong": VertexKind(3, (("pos", 3, False), ("uv", 2, False), ("normal", 3, False)),
                        (("normal", "normal"), ("pos", 3), ("uv", "uv"))),
    "gouraud": VertexKind(4, (("pos", 3, False), ("normal", 3, False), ("color", 3, True)), (("color", 3),)),
}


@dataclasses.dataclass(frozen=True)
class PixelKind:
    """A builtin pixel shader as the shading kernels run it (csrc/shade.cuh):
    ``code``, its kind there; ``varyings``, what it reads, (name, width) in
    codec order."""

    code: int
    varyings: tuple


PIXEL_KINDS = {
    "flat": PixelKind(0, (("color", 4),)),
    "gouraud": PixelKind(1, (("color", 3),)),
    "textured": PixelKind(2, (("uv", 2),)),
    "phong": PixelKind(3, (("normal", 3), ("pos", 3), ("uv", 2))),
}


def varying_offsets(kind, codec) -> dict:
    """The first channel of each varying the builtin pixel shader of
    ``fused_kind`` ``kind`` reads, {name: channel}, in the layout of
    ``codec`` (a ``ContextCodec``), which may hold other varyings too.
    ValueError where the layout lacks one or gives it another width."""
    if kind not in PIXEL_KINDS:
        raise ValueError(f"no builtin pixel shader of kind {kind!r}")
    starts, at = {}, 0
    for name, width in codec.layout:
        starts[name] = (at, width)
        at += width
    out = {}
    for name, width in PIXEL_KINDS[kind].varyings:
        if name not in starts or starts[name][1] != width:
            raise ValueError(f"the {kind} pixel shader reads {name!r} of width {width}; the varyings are "
                             f"{codec.layout}")
        out[name] = starts[name][0]
    return out


def vertex_layout(vertex_shader, draw):
    """The varyings' layout, ((name, width), ...) in codec order, that a
    builtin vertex shader (tagged ``fused_kind``) emits on ``draw``'s (F, 3,
    k) attributes, without running it; None for any other vertex shader."""
    kind = getattr(vertex_shader, "fused_kind", None)
    if kind is None:
        return None
    layout = []
    for name, width in VERTEX_KINDS[kind].varyings:
        if isinstance(width, str):
            if width not in draw:
                raise ValueError(f"the {kind} vertex shader reads the attribute {width!r}, which the draw lacks")
            width = draw[width].shape[-1] if draw[width].dim() > 2 else 1
        layout.append((name, width))
    return tuple(layout)


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
    lc = constant(tuple(light_color), normal.device)
    lp = constant(tuple(light_pos), normal.device)
    ambient = lc * AMBIENT_STRENGTH
    n = normalize(normal)
    light_dir = normalize(lp - world_pos)
    diff = max0(_dot3(n, light_dir)).unsqueeze(-1)  # jnp.maximum's +0 for a -0 product sum
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


def shading_inputs(kind, u, device):
    """The texture stack and eye the shading kernels read for the builtin
    pixel shader of ``fused_kind`` ``kind`` from its uniforms ``u``: their
    stack for textured and phong, else (or where they carry none) the dummy
    stack; their ``view_pos``, else zeros. What is made here comes from
    device constants, so a captured frame records no op for it."""
    stack = u.get("textures") if kind in ("textured", "phong") else None
    if stack is None:
        stack = TextureStack(texels=constant(((0,),), device, torch.int32).view(1, 1, 1),
                             dims=constant(((1, 1),), device, torch.int32))
    view_pos = u.get("view_pos")
    return stack, constant((0.0, 0.0, 0.0), device) if view_pos is None else view_pos


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


FlatShader.vertex.fused_kind = "flat"
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

    vertex.fused_kind = "phong"
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

    vertex.fused_kind = "textured"
    pixel.fused_kind = "textured"
    return vertex, pixel


def make_gouraud_shaders(light_pos=LIGHT_POS, light_color=LIGHT_COLOR):
    """Vertex-lit Gouraud (BASELINE config #2): the Phong lighting sum
    evaluated per vertex and interpolated as a color varying. The vertex
    shader reads its light from its tag (``vertex.light_pos`` /
    ``light_color``), the one source the set-up kernel takes it from too."""

    def vertex(u, vin):
        clip, p = _mvp_transform(u, vin["pos"])
        world = mat_vec4(u["model"], p)
        light = _phong_lighting(
            vin["normal"], world[:3].T, u["view_pos"], vertex.light_pos, vertex.light_color
        )
        base = vin.get("color")
        return clip, {"color": light if base is None else base * light}

    def pixel(u, ctx, ps_index):
        return _gouraud_pixel(ctx)

    vertex.fused_kind = "gouraud"
    vertex.light_pos = tuple(light_pos)
    vertex.light_color = tuple(light_color)
    pixel.fused_kind = "gouraud"
    pixel.light_pos = tuple(light_pos)
    pixel.light_color = tuple(light_color)
    return vertex, pixel
