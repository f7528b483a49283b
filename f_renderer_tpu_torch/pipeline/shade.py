"""Deferred shading (reference: renderer.rs:343-381, whose pixel shader runs
once a covered pixel).

Port of ``f_renderer_tpu/pipeline/shade.py:23-144``. Given each pixel's
winning triangle, gather its vertex attributes, recompute the barycentrics
at the pixel center, interpolate the varyings perspective-correct
(renderer.rs:368-378) and run the user pixel shader on the covered pixels.
The final u8 pack matches vec4_to_u8_array (renderer.rs:7-14); background
pixels keep the fill color.

The port's shader contract is planar: the pixel shader gets
``{key: (k, R, W)}`` channel planes and an (R, W) texture id, and returns
(4, R, W) rgba. On the card and the CPU (:func:`shade_from_planes`) the
planes hold R rows of covered pixels (:func:`compact_planes`: in raster
order, in no spatial arrangement), R a rung of the ladder :data:`RUNGS`
(1/8, 2/8, 3/8, 4/8 or 6/8 of the frame's rows, the smallest that holds the
frame's covered pixels); the slots past them are padding, texture id -1 and
zero varyings, whose colour no pixel shows. Past 6/8 the shader gets the
whole frame, (k, H, W), its background pixels' texture id -1. So a shader's
colour at a pixel may depend on that pixel's context and the uniform only,
as the reference's per-pixel closure does; one that reads its neighbours
has no counterpart there. Context planes are (C, H, W). With
``vectorized=False`` the shader is called once per pixel instead
(``{key: (k,)}``, a 0-d texture id, returning (4,)), the JAX package's
``vmap(vmap(shade_one))`` form, for scalar-style custom shaders that cannot
broadcast; it runs on the same compact planes.

A builtin pixel shader (tagged ``fused_kind``) is not called: on the card
one kernel shades the planes (``kernels.shade_planes``, csrc/shade_planes.cu:
the pixel shader, the sampler, the pack and the background, where XLA
fused them in the JAX package); on the CPU its plain version
:func:`shade_planes_plain` does. The builtins broadcast, so
``vectorized`` changes none of their frames.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from f_renderer_tpu_torch.device import capturing, constant, if_node, in_graph_frame
from f_renderer_tpu_torch.math.transforms import true_div
from f_renderer_tpu_torch.pipeline.fused import background_packed
from f_renderer_tpu_torch.pipeline.raster import NF_I, PS, PS_MASK
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.builtin import LIGHT_COLOR, LIGHT_POS, shade_plain, shading_inputs, varying_offsets
from f_renderer_tpu_torch.utils import metrics


def interpolate_context(tri: TriangleBuffer, winner, width: int, height: int, *, origin=(0, 0)):
    """Per-pixel perspective-correct varying interpolation.

    Returns ``(ctx (C, H, W) f32, ps_index (H, W) int32)`` for the winning
    triangle at each pixel (garbage where winner < 0: mask downstream).
    ``origin=(y0, x0)``: the full-frame coordinates of the top-left pixel.
    """
    wid = torch.clamp(winner, min=0).long()
    # the float rows of raster.pack_setup: S0X, S0Y, ..., S2Y, RHW0-2, the 3C varyings
    rows = [tri.spf[v, a] for v in range(3) for a in range(2)] + [tri.rhw[v] for v in range(3)] + list(tri.ctx)
    ctx = _interpolate(lambda j: rows[j][wid], tri.num_channels, width, height, origin, winner.device)
    return ctx, tri.ps_index[wid]


def interpolate_records(recs, winner, n_ctx: int, *, origin=(0, 0)):
    """:func:`interpolate_context` from slot records (``raster.slot_records``,
    the set-up kernels' output): ``recs`` (m, rec) int32, ``winner`` (H, W)
    int32 a record's index (record 0 where winner < 0, garbage to mask, as
    :func:`interpolate_context` reads slot 0) → ``(ctx (C, H, W) f32,
    ps_index (H, W) int32)``, bit-equal to :func:`interpolate_context` on the
    TriangleBuffer whose records these are: it reads the same words (the
    float rows from word NF_I, the PS word's ps_index bits) and does the
    same float32 operations. The plain version of ``kernels.interp_records``
    (csrc/interp_records.cu), on the tensors' device."""
    h, w = winner.shape
    wid = torch.clamp(winner, min=0).long()
    rows = recs[:, NF_I:NF_I + 9 + 3 * n_ctx].view(torch.float32)
    ctx = _interpolate(lambda j: rows[:, j][wid], n_ctx, w, h, origin, winner.device)
    return ctx, (recs[:, PS] & PS_MASK)[wid]


def interp_records(recs, winner, n_ctx: int, *, origin=(0, 0)):
    """The winners' varyings from their slot records: CUDA tensors launch
    ``kernels.interp_records`` (csrc/interp_records.cu), CPU tensors run its
    plain version :func:`interpolate_records`."""
    if recs.device.type == "cpu":
        return interpolate_records(recs, winner, n_ctx, origin=origin)
    from f_renderer_tpu_torch import kernels

    return kernels.interp_records(recs, winner, n_ctx=n_ctx, origin=origin)


def _interpolate(row, nc: int, width: int, height: int, origin, dev):
    """The interpolation of :func:`interpolate_context`: ``row(j)`` the
    winners' float row j (H, W) of ``raster.pack_setup``'s layout → ctx (C,
    H, W) f32."""
    y0, x0 = origin
    sfx = [row(2 * v) for v in range(3)]
    sfy = [row(2 * v + 1) for v in range(3)]
    rhw3 = [row(6 + v) for v in range(3)]
    px = (x0 + torch.arange(width, dtype=torch.float32, device=dev)[None, :]) + 0.5
    py = (y0 + torch.arange(height, dtype=torch.float32, device=dev)[:, None]) + 0.5
    sx = [sfx[v] - px for v in range(3)]
    sy = [sfy[v] - py for v in range(3)]

    def perp(i, j):
        return torch.abs(sx[i] * sy[j] - sy[i] * sx[j])

    a, b, c = perp(1, 2), perp(2, 0), perp(0, 1)
    inv_s = true_div(1.0, a + b + c)
    la, lb, lc = a * inv_s, b * inv_s, c * inv_s
    rhw = rhw3[0] * la + rhw3[1] * lb + rhw3[2] * lc
    w_corr = true_div(1.0, torch.where(rhw != 0.0, rhw, 1.0))  # renderer.rs:368
    coef = [rhw3[0] * la * w_corr, rhw3[1] * lb * w_corr, rhw3[2] * lc * w_corr]
    if not nc:
        return torch.zeros((0, height, width), device=dev)
    return torch.stack([row(9 + ch) * coef[0] + row(9 + nc + ch) * coef[1] + row(9 + 2 * nc + ch) * coef[2]
                        for ch in range(nc)])


# The ladder of a user pixel shader's compact planes: a rung holds this many
# eighths of the planes' rows, rounded up to whole rows. A frame takes the
# smallest rung whose slots hold its covered pixels; past the last, the
# whole frame (rung WHOLE).
RUNGS = (1, 2, 3, 4, 6)
WHOLE = len(RUNGS)
# The tally's words (compact_tally): frames a rung, the whole frame's last;
# then covered pixels, pixels shaded, the frames' pixels.
TALLY_WORDS = WHOLE + 4


def rung_rows(h: int) -> tuple:
    """Each rung's rows in a frame of ``h`` rows: ``ceil(h · k / 8)``."""
    return tuple(-(-h * k // 8) for k in RUNGS)


class Compact(NamedTuple):
    """:func:`compact_planes`' result."""

    count: torch.Tensor  # 0-d int32: the covered pixels (winner >= 0)
    rung: torch.Tensor  # 0-d int32: the frame's rung, WHOLE past the last
    slots: torch.Tensor  # (H, W) int32: a covered pixel's slot, raster order; -1 elsewhere
    ctx: torch.Tensor  # (C, rung_rows(H)[-1], W) f32: the covered pixels' varyings at their slots
    ps: torch.Tensor  # (rung_rows(H)[-1], W) int32: their texture ids; -1 in the padding


def compact_tally(device) -> torch.Tensor:
    """The (TALLY_WORDS,) int64 tally of ``device``'s compactions (``"cuda"``
    is the current card's), made once, outside any capture (a captured
    frame adds to it by its address; callers read it, never reset it): each
    frame adds 1 at its rung, then its covered pixels, its pixels shaded
    (the rung's slots, or the whole frame's) and its pixels."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _tally(device)


@functools.lru_cache(maxsize=None)
def _tally(device: torch.device) -> torch.Tensor:
    if capturing(device):
        raise RuntimeError("the compaction's tally is made outside a capture: run the frame once first")
    return torch.zeros((TALLY_WORDS,), dtype=torch.int64, device=device)


def compact_planes(ctx, ps_idx, winner, *, conds=None) -> Compact:
    """The covered pixels of K4's planes, compacted for a user's pixel
    shader (:class:`Compact`): on the card one launch of
    ``kernels.compact_planes`` (csrc/compact_planes.cu; ``conds``: the
    rungs' conditional nodes, which it sets), its plain version
    :func:`compact_planes_plain` elsewhere. Both add the frame to
    :func:`compact_tally`."""
    if not _on_card(winner):
        return compact_planes_plain(ctx, ps_idx, winner)
    from f_renderer_tpu_torch import kernels

    return Compact(*kernels.compact_planes(ctx, ps_idx, winner, rung_rows(winner.shape[0]), conds=conds,
                                           tally=compact_tally(winner.device)))


def compact_planes_plain(ctx, ps_idx, winner) -> Compact:
    """The plain version of ``kernels.compact_planes``, on the tensors'
    device, with no host sync: the slots a cumulative sum of the covered
    pixels in raster order; the compact planes (C, R, W) and (R, W), R the
    last rung's rows, the covered pixels at their slots (those past R · W
    dropped), zeros and -1 after them; the rung the first whose slots hold
    the count, WHOLE where none does. The kernel writes the same count,
    rung, slot map and, on a rung, the same rung's rows of the compact
    planes (on the whole frame's rung it writes no compact plane)."""
    h, w = winner.shape
    dev, rows = winner.device, rung_rows(h)
    n, cap = h * w, rows[-1] * w
    cov = (winner >= 0).reshape(n)
    rank = torch.cumsum(cov, 0, dtype=torch.int32)
    count = rank[-1] if n else torch.zeros((), dtype=torch.int32, device=dev)
    slots = torch.where(cov, rank - 1, -1)
    caps = constant(tuple(r * w for r in rows) + (n,), dev, torch.int64)
    rung = (caps[:WHOLE] < count).sum(dtype=torch.int32)
    dest = torch.where(cov & (slots < cap), slots, cap).long()  # slot cap collects the rest, dropped
    c = ctx.shape[0]
    ctx_c = torch.zeros((c, cap + 1), dtype=ctx.dtype, device=dev).scatter_(1, dest.expand(c, n), ctx.reshape(c, n))
    ps_c = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev).scatter_(0, dest, ps_idx.reshape(n))
    at = rung.long().view(1)
    compact_tally(dev).index_add_(0, torch.cat([at, constant((WHOLE + 1, WHOLE + 2, WHOLE + 3), dev, torch.int64)]),
                                  torch.cat([constant((1,), dev, torch.int64), count.long().view(1),
                                             caps.index_select(0, at), caps[WHOLE:]]))
    return Compact(count, rung, slots.reshape(h, w), ctx_c[:, :cap].reshape(c, rows[-1], w),
                   ps_c[:cap].reshape(rows[-1], w))


def shade_from_planes(
    ctx,
    ps_idx,
    winner,
    pixel_shader: Callable,
    ps_uniform,
    codec: ContextCodec,
    *,
    background=(0, 0, 0, 255),
    vectorized: bool = True,
    launch: bool = True,
):
    """Shade from interpolated context planes (``raster.rasterize_interp``).

    ``ctx`` (C, H, W) f32, ``ps_idx``/``winner`` (H, W) int32. The pixel
    shader runs on the covered pixels: :func:`compact_planes` gathers them,
    and the shader runs once on the frame's rung (``vectorized``: ``{key:
    (k, R, W)}`` planes of R rows of slots, the first R rows of the compact
    planes, an (R, W) texture id, -1 in the padding slots past the covered
    pixels) or once per slot (``torch.func.vmap`` over the R · W slots);
    past the last rung, on the whole frame (the planes as they are, the
    background's texture id -1). A covered pixel's colour is packed from its
    slot, the background where winner < 0 (:func:`pack_frame`). Returns
    (H, W, 4) uint8. The rung is the JAX package's static shapes made three
    ways, as ``geometry.clip_or_skip`` makes its ``lax.cond``:

    - captured on the card: the compaction sets one conditional node a
      rung (and one for the whole frame), each node's body the shader on
      its rung and the pack into the one frame made before the nodes;
    - a captured frame outside a capture (``device.graph_frame``: the
      graph's warm-up frame, the CPU): every rung runs, and the frame is
      chosen on the device;
    - eagerly: the host reads the rung and runs it alone.

    A builtin pixel shader (``fused_kind``) runs as :func:`shade_planes` on
    CUDA tensors and as :func:`shade_planes_plain` on CPU tensors, whatever
    ``vectorized`` says. ``launch=False`` (the portable backend) launches
    no kernel on any device and compacts nothing: the shader runs on the
    whole frame (a builtin as ``builtin.shade_plain``, the plain sampler, in
    the user shader's place), and :func:`_pack` packs.
    """
    kind = getattr(pixel_shader, "fused_kind", None)
    if kind is not None:
        light = dict(light_pos=getattr(pixel_shader, "light_pos", LIGHT_POS),
                     light_color=getattr(pixel_shader, "light_color", LIGHT_COLOR))
        if launch:
            entry = shade_planes_plain if winner.device.type == "cpu" else shade_planes
            return entry(ctx, ps_idx, winner, kind, ps_uniform, codec, background=background, **light)
        pixel_shader = functools.partial(shade_plain, kind, **light)
    if not launch:
        # Background pixels carry garbage ctx; ps_index = -1 marks them so
        # samplers can exclude them (their color is replaced anyway).
        ps_idx = torch.where(winner >= 0, ps_idx, -1)
        return _pack(_colour(pixel_shader, ps_uniform, codec, ctx, ps_idx, vectorized), winner, background)
    h, w = winner.shape
    card = _on_card(winner)
    if card:
        metrics.count("render.pack_kernel_frames", 1)
    words = torch.empty((h, w), dtype=torch.int32, device=winner.device)
    args = (ctx, ps_idx, winner, pixel_shader, ps_uniform, codec, background, vectorized)
    if card and capturing(winner.device):
        from f_renderer_tpu_torch import kernels

        conds = [kernels.condition(winner.device) for _ in range(WHOLE + 1)]
        comp = compact_planes(ctx, ps_idx, winner, conds=conds)
        for k, cond in enumerate(conds):
            if_node(cond, _shade_rung, k, words, comp, *args)
    elif in_graph_frame():
        comp = compact_planes(ctx, ps_idx, winner)
        _shade_rung(WHOLE, words, comp, *args)
        for k in range(WHOLE):
            each = torch.empty_like(words)
            _shade_rung(k, each, comp, *args)
            words = torch.where(comp.rung == k, each, words)
    else:
        comp = compact_planes(ctx, ps_idx, winner)
        _shade_rung(int(comp.rung), words, comp, *args)  # a host sync
    return words.view(torch.uint8).reshape(h, w, 4)


def _shade_rung(k, words, comp: Compact, ctx, ps_idx, winner, pixel_shader, ps_uniform, codec, background,
                vectorized) -> None:
    """Rung ``k``'s frame into ``words`` ((H, W) int32 RGBA8): the shader on
    the first ``rung_rows(H)[k]`` rows of the compact planes and the pack by
    slot; on rung WHOLE, the shader on the whole frame and the pack by
    pixel."""
    if k == WHOLE:
        ps_idx = torch.where(winner >= 0, ps_idx, -1)
        pack_frame(_colour(pixel_shader, ps_uniform, codec, ctx, ps_idx, vectorized), winner, background, out=words)
        return
    r = rung_rows(winner.shape[0])[k]
    color = _colour(pixel_shader, ps_uniform, codec, comp.ctx[:, :r], comp.ps[:r], vectorized)
    pack_frame(color, winner, background, slots=comp.slots, out=words)


def _colour(pixel_shader, ps_uniform, codec: ContextCodec, ctx, ps_idx, vectorized: bool):
    """The user's pixel shader on (C, R, W) planes and an (R, W) texture id
    → its (4, R, W) colour: one call (``vectorized``) or one a pixel
    (``torch.func.vmap`` over the R · W pixels)."""
    if vectorized:
        return pixel_shader(ps_uniform, codec.unflatten(ctx), ps_idx)

    def shade_one(flat, idx):
        return pixel_shader(ps_uniform, codec.unflatten(flat), idx)

    c, h, w = ctx.shape
    flat = torch.func.vmap(shade_one, in_dims=(1, 0), out_dims=1)(ctx.reshape(c, h * w), ps_idx.reshape(h * w))
    return flat.reshape(4, h, w)


def _on_card(t) -> bool:
    """Whether ``t`` lies on the card, where :func:`pack_frame` and
    :func:`compact_planes` launch (the CPU tests replace it to walk the
    card's route)."""
    return t.device.type == "cuda"


def pack_frame(color, winner, background, *, slots=None, out=None):
    """A user pixel shader's (4, H, W) colour → (H, W, 4) uint8, written into
    ``out`` ((H, W) int32) where given: on the card one launch of
    ``kernels.pack_rgba8`` (csrc/pack_rgba8.cu, whatever the colour's
    strides), on the colour in float32, as the JAX package computes it (a
    float64 or float16 colour is converted first); :func:`_pack`, its plain
    version, on the CPU. With ``slots`` (a slot map, :func:`compact_planes`)
    the colour is the compact planes' (4, R, W), a covered pixel's at its
    slot. :func:`shade_from_planes` counts its frames on the card as
    ``render.pack_kernel_frames``."""
    h, w = winner.shape
    if not _on_card(color):
        frame = _pack(color, winner, background, slots=slots)
        return frame if out is None else out.view(torch.uint8).reshape(h, w, 4).copy_(frame)
    from f_renderer_tpu_torch import kernels

    rgba = kernels.pack_rgba8(color.to(torch.float32), winner, background_packed(background), slots=slots, out=out)
    return rgba.view(torch.uint8).reshape(h, w, 4)


def _pack(color, winner, background, *, slots=None):
    """(4, H, W) colour → (H, W, 4) uint8: ``clip(color · 255, 0, 255)``
    truncated, with NaN to 0 (what XLA's saturating float-to-u8 conversion
    gives the JAX package; a NaN to u8 cast has no fixed value in PyTorch),
    the background where winner < 0. With ``slots`` the colour is (4, R,
    W'), a covered pixel's at its slot, and the background where the slot
    is < 0 or past R · W' (a rung too small for the frame). The plain
    version of ``kernels.pack_rgba8``."""
    if slots is not None:
        n = color.shape[1] * color.shape[2]
        color = color.reshape(4, n)[:, slots.clamp(0, max(n - 1, 0)).long()]
        winner = torch.where(slots < n, slots, -1)
    q = torch.clamp(color * 255.0, 0.0, 255.0)
    u8 = torch.where(torch.isnan(q), 0.0, q).to(torch.uint8).permute(1, 2, 0)
    bg = constant(tuple(background), u8.device, torch.uint8)
    return torch.where((winner >= 0)[..., None], u8, bg)


def shade_planes_plain(ctx, ps_idx, winner, kind, ps_uniform, codec: ContextCodec, *, background=(0, 0, 0, 255),
                       light_pos=LIGHT_POS, light_color=LIGHT_COLOR):
    """The plain version of :func:`shade_planes`, on the tensors' device:
    the builtin pixel shader of ``fused_kind`` ``kind`` (``builtin.shade_plain``,
    the plain sampler) on the planes as :func:`shade_from_planes` runs a
    pixel shader, and its pack. It launches no kernel on any device.
    ValueError where ``codec`` lacks a varying the builtin reads or gives it
    another width (``builtin.varying_offsets``)."""
    varying_offsets(kind, codec)
    stack, view_pos = shading_inputs(kind, ps_uniform, winner.device)
    u = dict(ps_uniform, textures=stack, view_pos=view_pos)
    ps_idx = torch.where(winner >= 0, ps_idx, -1)
    color = shade_plain(kind, u, codec.unflatten(ctx), ps_idx, light_pos=light_pos, light_color=light_color)
    return _pack(color, winner, background)


def shade_planes(ctx, ps_idx, winner, kind, ps_uniform, codec: ContextCodec, *, background=(0, 0, 0, 255),
                 light_pos=LIGHT_POS, light_color=LIGHT_COLOR):
    """The builtin pixel shader of ``fused_kind`` ``kind`` on the planes,
    packed, with the background where winner < 0, in one launch of
    ``kernels.shade_planes`` (csrc/shade_planes.cu) → (H, W, 4) uint8. The
    planes are read through their strides (K4's cropped planes need no
    copy), each varying at the channel ``codec`` gives its name; the
    sampler's opaque shortcut only where ``TextureStack.sampler_opaque``
    allows it, as the plain sampler takes it. CUDA tensors only (it launches
    or raises); :func:`shade_planes_plain` is its plain version."""
    from f_renderer_tpu_torch import kernels

    stack, view_pos = shading_inputs(kind, ps_uniform, winner.device)
    rgba = kernels.shade_planes(
        ctx, ps_idx, winner, view_pos.to(torch.float32).contiguous(), stack.dims, stack.texels, kind=kind,
        varyings=varying_offsets(kind, codec), opaque=stack.sampler_opaque(ps_idx),
        bg_packed=background_packed(background), light_pos=light_pos, light_color=light_color)
    h, w = winner.shape
    return rgba.view(torch.uint8).reshape(h, w, 4)


def shade_deferred(
    tri: TriangleBuffer,
    winner,
    pixel_shader: Callable,
    ps_uniform,
    codec: ContextCodec,
    *,
    background=(0, 0, 0, 255),
    origin=(0, 0),
    vectorized: bool = True,
    launch: bool = True,
):
    """Run the pixel shader over the frame; returns (H, W, 4) uint8.

    ``pixel_shader(ps_uniform, context planes, ps_index) -> rgba (4, H, W)``
    (see :func:`shade_from_planes` for ``vectorized`` and ``launch``);
    ``origin`` as in :func:`interpolate_context`.
    """
    h, w = winner.shape
    ctx, ps_idx = interpolate_context(tri, winner, w, h, origin=origin)
    return shade_from_planes(
        ctx, ps_idx, winner, pixel_shader, ps_uniform, codec, background=background,
        vectorized=vectorized, launch=launch,
    )
