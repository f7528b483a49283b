"""Texture loading and frame export (reference: renderer.rs:427-471).

A copy of ``f_renderer_tpu/io/image.py`` (numpy, and PIL imported where it
is used), so the port imports nothing of the JAX package.

The reference decodes PNG/TGA with the `image` crate and swizzles RGB(A) into
**BGRA** byte order on load (renderer.rs:442-445, 454-457) — texture colors
then flow through shading in BGR order. `load_texture` replicates that
swizzle by default; pass ``bgra=False`` for conventional RGBA.

The window/swapchain presentation layer of the reference (vulkan_base.rs,
wgpu_base.rs) is ``display.py``; here frames are exported to PNG/npy.
"""

from __future__ import annotations

import numpy as np


def load_texture(path: str, *, bgra: bool = True, verbose: bool = False) -> np.ndarray:
    """Decode an image file into an (H, W, 4) uint8 array.

    BGRA swizzle on by default, matching FrameBuffer::load_file
    (renderer.rs:427-471): RGB input gets alpha=255.
    """
    from PIL import Image

    img = Image.open(path)
    if img.mode == "RGB":
        if verbose:
            print(f"rgb {path}")
        rgb = np.asarray(img, np.uint8)
        out = np.empty((*rgb.shape[:2], 4), np.uint8)
        out[..., :3] = rgb[..., ::-1] if bgra else rgb
        out[..., 3] = 255
    elif img.mode == "RGBA":
        if verbose:
            print(f"rgba {path}")
        rgba = np.asarray(img, np.uint8)
        out = np.empty_like(rgba)
        out[..., :3] = rgba[..., 2::-1] if bgra else rgba[..., :3]
        out[..., 3] = rgba[..., 3]
    else:
        raise ValueError(f"invalid color type: {img.mode}")  # renderer.rs:461-463
    return out


def save_png(path: str, frame: np.ndarray) -> None:
    """Write an (H, W, 4) or (H, W, 3) uint8 frame to PNG."""
    from PIL import Image

    Image.fromarray(np.asarray(frame, np.uint8)).save(path)


def save_npy(path: str, frame: np.ndarray) -> None:
    np.save(path, np.asarray(frame))
