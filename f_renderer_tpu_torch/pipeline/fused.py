"""Fused single-kernel renderer: raster + interpolate + shade + pack.

Port of ``f_renderer_tpu/pipeline/fused.py``. For the builtin shader family
(flat / gouraud / textured / phong, tagged ``fused_kind``) one kernel runs
the whole per-pixel pipeline on each (th, 128) bin tile
(``csrc/fused_raster.cu``): it walks the tile's pair ranges, keeps the
strict (rhw, order) maximum per pixel, interpolates the winner's varyings
once, shades, samples textures in-kernel and packs RGBA8.

The prep around it stays plain PyTorch on the tensors' device, as it was
XLA in the JAX package: ``pack_setup``, ``bin_pairs`` and the pair-order
gather.

``render_fused_prepared`` is the kernel's wrapper: for CUDA tensors it
launches the kernel (or raises), for CPU tensors it runs
``render_fused_plain``, the kernel's plain version, which the CPU tests hold
against the JAX package and ``chip_smoke.py`` against the kernel.

Varying channel order matches the ContextCodec key sort:
flat/gouraud → color; textured → uv; phong → normal(3), pos(3), uv(2).
"""

from __future__ import annotations

import dataclasses

import torch

from f_renderer_tpu_torch.math.transforms import true_div
from f_renderer_tpu_torch.pipeline import raster as R
from f_renderer_tpu_torch.pipeline.raster import bin_pairs, cdiv, pack_setup
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.builtin import LIGHT_COLOR, LIGHT_POS
from f_renderer_tpu_torch.shaders.texture import PACKED_VMEM_BUDGET, TextureStack

LANES = 128

# Varying layout each fused kind's epilogue reads (key, width), key-sorted.
LAYOUTS = {
    "flat": (("color", 4),),
    "gouraud": (("color", 3),),
    "textured": (("uv", 2),),
    "phong": (("normal", 3), ("pos", 3), ("uv", 2)),
}
KIND_IDS = {"flat": 0, "gouraud": 1, "textured": 2, "phong": 3}


def check_fused_path(pixel_shader, ps_uniform) -> None:
    """Raise where the JAX package would leave the fused path: the port has
    no other path yet (ROADMAP modules step 8)."""
    kind = getattr(pixel_shader, "fused_kind", None)
    if kind not in LAYOUTS:
        raise NotImplementedError(
            "only the builtin fused_kind pixel shaders are ported; custom "
            "shaders need the non-fused path"
        )
    stack = ps_uniform.get("textures")
    if kind in ("textured", "phong") and stack is not None:
        if stack.packed_nbytes > PACKED_VMEM_BUDGET:
            raise NotImplementedError(
                f"texture stack of {stack.packed_nbytes} packed bytes is past "
                f"the fused path's {PACKED_VMEM_BUDGET}; the non-fused path is "
                "not ported yet"
            )


@dataclasses.dataclass(frozen=True)
class FusedPrep:
    """Products of :func:`prep_fused`: what the kernel reads."""

    off: torch.Tensor  # (ntiles + ntilesc + 2,) int32 pair-range offsets
    tri_i32: torch.Tensor  # (NF_I, n_pairs) int32, pair order
    tri_f32: torch.Tensor  # (9 + 3C, n_pairs) float32, pair order
    th: int  # bin tile rows (the tile is th × 128)
    n_ctx: int
    height: int
    width: int
    h_pad: int
    w_pad: int


def prep_fused(tri: TriangleBuffer, config) -> FusedPrep:
    """Geometry-side prep for the fused kernel: pack + bin + pair gather."""
    n_slots, n_ctx = tri.num_slots, tri.num_channels
    m_pad = cdiv(n_slots + 1, LANES) * LANES  # ≥ 1 empty padding slot: the dummy
    tri_i32, tri_f32 = pack_setup(tri, config.width, config.height, m_pad)
    th, tw = config.tile if config.tile is not None else (32, LANES)
    if tw != LANES:
        raise ValueError(f"fused path needs tile width {LANES}, got {tw}")
    if config.tile_auto and n_slots > config.tile_auto_threshold:
        th = max(th, 64)  # huge scenes: fewer, taller tiles
    elif config.tile_auto and config.tile is None and n_slots <= 2048:
        th = 128  # tiny scenes are bound by the tile count, not by pairs
    k = config.bin_k or (4 if n_slots <= 300_000 else 2)
    h_pad = cdiv(config.height, th) * th
    w_pad = cdiv(config.width, tw) * tw
    ptri, off = bin_pairs(
        tri_i32, (th, tw), (h_pad // th, w_pad // tw), k, LANES, m_dummy=n_slots, kc=k
    )
    return FusedPrep(
        off=off,
        tri_i32=tri_i32.index_select(1, ptri),
        tri_f32=tri_f32.index_select(1, ptri),
        th=th,
        n_ctx=n_ctx,
        height=config.height,
        width=config.width,
        h_pad=h_pad,
        w_pad=w_pad,
    )


def background_packed(background) -> int:
    """RGBA8 background as the int32 the kernel writes."""
    v = int(background[0]) | (int(background[1]) << 8) | (int(background[2]) << 16) | (
        int(background[3]) << 24
    )
    return v - 2**32 if v >= 2**31 else v


def _finish(rgba, depth, winner, prep: FusedPrep):
    """Crop the padded planes; the frame is the int32 RGBA8 plane viewed as
    bytes in little-endian order (r first)."""
    h, w = prep.height, prep.width
    frame = rgba[:h, :w].contiguous().view(torch.uint8).reshape(h, w, 4)
    return frame, depth[:h, :w], winner[:h, :w]


def render_fused_prepared(prep: FusedPrep, pixel_shader, ps_uniform, config):
    """Run the fused kernel on :func:`prep_fused` products.

    Returns ``(frame (H, W, 4) uint8, depth (H, W) f32, winner (H, W) int32)``.
    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    dev = prep.tri_i32.device
    if dev.type == "cpu":
        return render_fused_plain(prep, pixel_shader, ps_uniform, config)
    if dev.type != "cuda":
        raise ValueError(f"fused kernel runs on CUDA or (plain) CPU, not {dev}")
    from f_renderer_tpu_torch import kernels

    kind = pixel_shader.fused_kind
    stack = ps_uniform.get("textures") if kind in ("textured", "phong") else None
    if stack is None:
        stack = TextureStack.dummy(dev)
    view_pos = ps_uniform.get("view_pos")
    if view_pos is None:
        view_pos = torch.zeros(3, device=dev)
    rgba, depth, winner = kernels.fused_raster(
        prep.off,
        prep.tri_i32,
        prep.tri_f32,
        view_pos.to(torch.float32).contiguous(),
        stack.dims,
        stack.texels,
        th=prep.th,
        n_ctx=prep.n_ctx,
        h_pad=prep.h_pad,
        w_pad=prep.w_pad,
        kind=KIND_IDS[kind],
        opaque=stack.opaque,
        bg_packed=background_packed(config.background),
        light_pos=getattr(pixel_shader, "light_pos", LIGHT_POS),
        light_color=getattr(pixel_shader, "light_color", LIGHT_COLOR),
    )
    return _finish(rgba, depth, winner, prep)


def _tile_plain(tri_i32, tri_f32, idx, cx, cy):
    """Per-pixel strict (rhw, order) maximum over one tile's pairs ``idx``.

    The sequential merge ``accept = cover & (rhw > d | (rhw >= d & o > o_d))``
    from (0.0, ORDER_NONE) ends at the lexicographic maximum of
    {background} ∪ covered pairs, so it is computed as one (the pairs of a
    tile have distinct orders). Returns (depth, winning pair or -1).
    """
    i = tri_i32[:, idx].long()[:, :, None, None]  # (12, P, 1, 1)
    f = tri_f32[:9, idx][:, :, None, None]
    e01 = R._w(i[R.A01] * cx + i[R.B01] * cy + i[R.C01])
    e20 = R._w(i[R.A20] * cx + i[R.B20] * cy + i[R.C20])
    e12 = R._w(i[R.AREA2] - e01 - e20)
    maxx, maxy = R.unpack_xy(i[R.MAXXY])
    cover = (e01 | e12 | e20 | (maxx - 1 - cx) | (maxy - 1 - cy)) >= 0
    pcx = cx.to(torch.float32) + 0.5
    pcy = cy.to(torch.float32) + 0.5
    s0x, s0y = f[R.S0X] - pcx, f[R.S0Y] - pcy
    s1x, s1y = f[R.S1X] - pcx, f[R.S1Y] - pcy
    s2x, s2y = f[R.S2X] - pcx, f[R.S2Y] - pcy
    a = torch.abs(s1x * s2y - s1y * s2x)
    b = torch.abs(s2x * s0y - s2y * s0x)
    c = torch.abs(s0x * s1y - s0y * s1x)
    s = a + b + c
    inv_s = true_div(1.0, s)
    rhw = f[R.RHW0] * (a * inv_s) + f[R.RHW1] * (b * inv_s) + f[R.RHW2] * (c * inv_s)
    ok = cover & (s != 0.0) & ~torch.isnan(rhw)  # a NaN rhw is never accepted
    m1 = torch.where(ok, rhw, float("-inf")).amax(0)
    order = i[R.ORDER]
    tie = ok & (rhw == m1)
    m2 = torch.where(tie, order, R.ORDER_NONE).amax(0)
    accept = (m1 > 0.0) | ((m1 == 0.0) & (m2 > R.ORDER_NONE))
    arg = (tie & (order == m2)).to(torch.uint8).argmax(0)
    depth = torch.gather(rhw.expand(-1, *arg.shape), 0, arg[None])[0]
    return torch.where(accept, depth, 0.0), torch.where(accept, idx[arg], -1)


def render_fused_plain(prep: FusedPrep, pixel_shader, ps_uniform, config):
    """Plain PyTorch version of the fused kernel, on the tensors' device.

    Same inputs and outputs as :func:`render_fused_prepared`; the same
    arithmetic, expression by expression, as ``csrc/fused_raster.cu``.
    """
    dev = prep.tri_i32.device
    ti, tf = prep.tri_i32, prep.tri_f32
    th, tw = prep.th, LANES
    nty, ntx = prep.h_pad // th, prep.w_pad // tw
    ntiles = nty * ntx
    ntxc = cdiv(ntx, R.COARSE)
    ntilesc = cdiv(nty, R.COARSE) * ntxc
    off = prep.off.tolist()
    depth = torch.zeros((prep.h_pad, prep.w_pad), dtype=torch.float32, device=dev)
    wpair = torch.full((prep.h_pad, prep.w_pad), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(th, device=dev)[:, None]
    cols = torch.arange(tw, device=dev)[None, :]
    spill = ntiles + ntilesc
    for ty in range(nty):
        for tx in range(ntx):
            t = ty * ntx + tx
            c = ntiles + (ty // R.COARSE) * ntxc + tx // R.COARSE
            idx = torch.cat(
                [
                    torch.arange(off[r], off[r + 1], device=dev)
                    for r in (t, c, spill)
                ]
            )
            if idx.numel() == 0:
                continue
            d, w = _tile_plain(ti, tf, idx, tx * tw + cols, ty * th + rows)
            depth[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw] = d
            wpair[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw] = w

    # Interpolate the winner's varyings once per pixel, perspective-correct
    # (renderer.rs:368-378), with the final depth (raster_pallas.py:1102-1149).
    has = wpair >= 0
    wp = torch.clamp(wpair, min=0)
    g = tf[:, wp]  # (9 + 3C, h_pad, w_pad)
    pcy = torch.arange(prep.h_pad, device=dev, dtype=torch.float32)[:, None] + 0.5
    pcx = torch.arange(prep.w_pad, device=dev, dtype=torch.float32)[None, :] + 0.5
    s0x, s0y = g[R.S0X] - pcx, g[R.S0Y] - pcy
    s1x, s1y = g[R.S1X] - pcx, g[R.S1Y] - pcy
    s2x, s2y = g[R.S2X] - pcx, g[R.S2Y] - pcy
    a = torch.abs(s1x * s2y - s1y * s2x)
    b = torch.abs(s2x * s0y - s2y * s0x)
    c = torch.abs(s0x * s1y - s0y * s1x)
    inv_s = true_div(1.0, a + b + c)
    w_corr = true_div(1.0, torch.where(depth != 0.0, depth, 1.0))
    c0 = g[R.RHW0] * (a * inv_s) * w_corr
    c1 = g[R.RHW1] * (b * inv_s) * w_corr
    c2 = g[R.RHW2] * (c * inv_s) * w_corr
    n = prep.n_ctx
    ctx = torch.stack(
        [
            g[R.CTX0 + ch] * c0 + g[R.CTX0 + n + ch] * c1 + g[R.CTX0 + 2 * n + ch] * c2
            for ch in range(n)
        ]
    )
    ctx = torch.where(has, ctx, 0.0)
    winner = torch.where(has, ti[R.SLOT][wp], -1)
    ps = torch.where(has, ti[R.PS][wp] & R.PS_MASK, 0)

    # Shading epilogue: the builtin pixel shader on the planes, then RGBA8.
    kind = pixel_shader.fused_kind
    layout = LAYOUTS[kind]
    if ContextCodec(layout).num_channels != n:
        raise ValueError(f"{kind} shading reads {layout}, the buffer has {n} channels")
    u = dict(ps_uniform)
    if u.get("view_pos") is None:
        u["view_pos"] = torch.zeros(3, device=dev)
    psm = torch.where(winner >= 0, ps, -1)
    color = pixel_shader(u, ContextCodec(layout).unflatten(ctx), psm)
    q = color * 255.0
    q = torch.clamp(torch.where(torch.isnan(q), 0.0, q), 0.0, 255.0).to(torch.int64)
    packed = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24)
    packed = R._w(packed).to(torch.int32)
    rgba = torch.where(winner >= 0, packed, background_packed(config.background))
    return _finish(rgba, depth, winner, prep)


def render_fused(tri: TriangleBuffer, pixel_shader, ps_uniform, config):
    """One-kernel render for ``fused_kind``-tagged pixel shaders.

    Returns (frame (H, W, 4) uint8, depth (H, W) f32, winner (H, W) int32).
    """
    check_fused_path(pixel_shader, ps_uniform)
    return render_fused_prepared(prep_fused(tri, config), pixel_shader, ps_uniform, config)
