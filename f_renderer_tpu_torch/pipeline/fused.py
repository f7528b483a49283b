"""Fused single-kernel renderer: raster + interpolate + shade + pack.

Port of ``f_renderer_tpu/pipeline/fused.py``. For the builtin shader family
(flat / gouraud / textured / phong, tagged ``fused_kind``) one kernel runs
the whole per-pixel pipeline on each (th, 128) bin tile
(``csrc/fused_raster.cu``): it walks the tile's pair ranges, keeps the
strict (rhw, order) maximum per pixel, interpolates the winner's varyings
once, shades, samples textures in-kernel and packs RGBA8.

The prep around it stays plain PyTorch on the tensors' device, as it was
XLA in the JAX package: ``pack_setup``, ``bin_pairs`` and the pair-order
gather (``raster.prep_binned``, shared with the non-fused raster kernel K4,
as is the per-tile raster loop).

``render_fused_prepared`` is the kernel's wrapper: for CUDA tensors it
launches the kernel (or raises), for CPU tensors it runs
``render_fused_plain``, the kernel's plain version, which the CPU tests hold
against the JAX package and ``chip_smoke.py`` against the kernel.

Varying channel order matches the ContextCodec key sort:
flat/gouraud → color; textured → uv; phong → normal(3), pos(3), uv(2).
"""

from __future__ import annotations

import torch

from f_renderer_tpu_torch.pipeline import raster as R
from f_renderer_tpu_torch.pipeline.raster import BinnedPrep, prep_binned
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.builtin import LIGHT_COLOR, LIGHT_POS, shade_plain
from f_renderer_tpu_torch.shaders.texture import PACKED_VMEM_BUDGET, TextureStack

# Varying layout each fused kind's epilogue reads (key, width), key-sorted.
LAYOUTS = {
    "flat": (("color", 4),),
    "gouraud": (("color", 3),),
    "textured": (("uv", 2),),
    "phong": (("normal", 3), ("pos", 3), ("uv", 2)),
}
KIND_IDS = {"flat": 0, "gouraud": 1, "textured": 2, "phong": 3}


def fused_path_ok(pixel_shader, ps_uniform) -> bool:
    """Can the fused kernel run this shader and these uniforms? The JAX
    package's rule (fused.py:120-137): a textured or phong shader whose
    texture stack is past ``PACKED_VMEM_BUDGET`` takes the non-fused path;
    so does every shader without a ``fused_kind`` (render.py checks that)."""
    kind = getattr(pixel_shader, "fused_kind", None)
    if kind not in ("textured", "phong"):
        return True
    stack = ps_uniform.get("textures")
    return stack is None or stack.packed_nbytes <= PACKED_VMEM_BUDGET


def prep_fused(tri: TriangleBuffer, config) -> BinnedPrep:
    """Geometry-side prep for the fused kernel: pack + bin + pair gather,
    with the tile and bin settings of ``config``."""
    return prep_binned(
        tri, config.width, config.height, config.tile,
        tile_auto=config.tile_auto, tile_auto_threshold=config.tile_auto_threshold,
        bin_k=config.bin_k,
    )


def background_packed(background) -> int:
    """RGBA8 background as the int32 the kernel writes."""
    v = int(background[0]) | (int(background[1]) << 8) | (int(background[2]) << 16) | (
        int(background[3]) << 24
    )
    return v - 2**32 if v >= 2**31 else v


def _finish(rgba, depth, winner, prep: BinnedPrep):
    """Crop the padded planes; the frame is the int32 RGBA8 plane viewed as
    bytes in little-endian order (r first)."""
    h, w = prep.height, prep.width
    frame = rgba[:h, :w].contiguous().view(torch.uint8).reshape(h, w, 4)
    return frame, depth[:h, :w], winner[:h, :w]


def render_fused_prepared(prep: BinnedPrep, pixel_shader, ps_uniform, config):
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


def render_fused_plain(prep: BinnedPrep, pixel_shader, ps_uniform, config, tiles=None):
    """Plain PyTorch version of the fused kernel, on the tensors' device.

    Same inputs and outputs as :func:`render_fused_prepared`; the same
    arithmetic, expression by expression, as ``csrc/fused_raster.cu``. It
    shades with the builtin bodies and the plain sampler
    (``builtin.shade_plain``), so it launches no kernel on any device.
    ``tiles``: only these (ty, tx) bin tiles are rasterized (None: all); the
    other pixels are background.
    """
    dev = prep.tri_i32.device
    depth, wpair = R.raster_tiles_plain(prep, tiles)
    ctx, winner, ps = R.interpolate_plain(prep, depth, wpair)

    # Shading epilogue: the builtin pixel shader on the planes, then RGBA8.
    kind = pixel_shader.fused_kind
    layout = LAYOUTS[kind]
    if ContextCodec(layout).num_channels != prep.n_ctx:
        raise ValueError(f"{kind} shading reads {layout}, the buffer has {prep.n_ctx} channels")
    u = dict(ps_uniform)
    if u.get("view_pos") is None:
        u["view_pos"] = torch.zeros(3, device=dev)
    psm = torch.where(winner >= 0, ps, -1)
    color = shade_plain(
        kind, u, ContextCodec(layout).unflatten(ctx), psm,
        light_pos=getattr(pixel_shader, "light_pos", LIGHT_POS),
        light_color=getattr(pixel_shader, "light_color", LIGHT_COLOR),
    )
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
    return render_fused_prepared(prep_fused(tri, config), pixel_shader, ps_uniform, config)
