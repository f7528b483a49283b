"""FrameBuffer / texture operations (reference: renderer.rs:7-24, 411-589).

Port of ``f_renderer_tpu/framebuffer.py``. Color buffers are ``(H, W, 4)``
uint8 (row y, column x: the reference's ``offset = y*W*4 + x*4``,
renderer.rs:496-514); depth buffers are ``(H, W)`` float32 holding
rhw = 1/w, cleared to 0.0, larger = closer (reversed-z; renderer.rs:360-366).

The array functions take torch tensors (on any device) or numpy arrays and
return the same kind; :class:`FrameBuffer` is the host-side numpy wrapper
with the reference's mutable API (fill / set_pixel / get_pixel / draw_line)
for tools and tests.
"""

from __future__ import annotations

import numpy as np
import torch


def vec4_to_u8(color):
    """float RGBA → u8 with clamp then truncating cast (renderer.rs:7-14).

    Rust's ``as u8`` truncates toward zero, as the cast after the clamp does;
    NaN gives 0 (Rust's saturating cast). Any (..., 4) tensor or array.
    """
    if isinstance(color, torch.Tensor):
        q = torch.clamp(color * 255.0, 0.0, 255.0)
        return torch.where(torch.isnan(q), 0.0, q).to(torch.uint8)
    q = np.clip(np.asarray(color) * 255.0, 0.0, 255.0)
    return np.where(np.isnan(q), 0.0, q).astype(np.uint8)


def u8_to_vec4(color):
    """u8 RGBA → float RGBA in [0, 1] (renderer.rs:16-24)."""
    if isinstance(color, torch.Tensor):
        return color.to(torch.float32) / 255.0
    return np.asarray(color).astype(np.float32) / 255.0


def sample_2d(texture, uv, *, replicate_clamp_bug: bool = True):
    """Bilinear texture sample (renderer.rs:516-538), vectorized over pixels.

    ``texture``: (H, W, 4) float32 in [0, 1] (texel values are u8/255).
    ``uv``: (..., 2) float32. Returns (..., 4): a torch tensor if either
    input is one (on its device), else a numpy array.

    The reference's quirks, replicated when ``replicate_clamp_bug``
    (renderer.rs:523-525): the y texel coordinates are clamped with the
    **width**, not the height (visible on non-square textures), and there is
    no wrap mode. The weights are Rust ``fract()`` = x - trunc(x). On a
    texture wider than tall that clamp can pass the last row: the torch path
    then reads the last row, as the JAX package's jnp gathers clamp, and the
    numpy path raises IndexError, as the JAX package's numpy path does.
    """
    if isinstance(texture, torch.Tensor) or isinstance(uv, torch.Tensor):
        dev = texture.device if isinstance(texture, torch.Tensor) else uv.device
        texture = torch.as_tensor(texture, dtype=torch.float32, device=dev)
        uv = torch.as_tensor(uv, dtype=torch.float32, device=dev)
        trunc, clip = torch.trunc, torch.clamp

        def to_index(a):
            return a.to(torch.int64)

        def rows(y):
            return y.clamp(max=texture.shape[0] - 1)
    else:
        texture = np.asarray(texture, np.float32)
        uv = np.asarray(uv, np.float32)
        trunc, clip = np.trunc, np.clip

        def to_index(a):
            return a.astype(np.int32)

        def rows(y):
            return y

    h, w = texture.shape[0], texture.shape[1]
    x = uv[..., 0] * w
    y = uv[..., 1] * h
    a = x - trunc(x)
    b = y - trunc(y)
    y_hi = (w if replicate_clamp_bug else h) - 1
    # Rust `as u32` saturates: clamp before the cast.
    x1 = to_index(clip(trunc(x), 0, w - 1))
    y1 = to_index(clip(trunc(y), 0, y_hi))
    x2 = clip(x1 + 1, 0, w - 1)
    y2 = clip(y1 + 1, 0, y_hi)
    y1, y2 = rows(y1), rows(y2)
    c11 = texture[y1, x1]
    c12 = texture[y2, x1]
    c21 = texture[y1, x2]
    c22 = texture[y2, x2]
    a = a[..., None]
    b = b[..., None]
    return (
        c11 * (1.0 - a) * (1.0 - b)
        + c12 * (1.0 - a) * b
        + c21 * a * (1.0 - b)
        + c22 * a * b
    )


class FrameBuffer:
    """Host-side RGBA8 framebuffer with the reference's API (renderer.rs:411-589)."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.buffer = np.zeros((self.height, self.width, 4), dtype=np.uint8)

    @staticmethod
    def from_array(array) -> "FrameBuffer":
        """A framebuffer holding a copy of an (H, W, 4) frame (a tensor on
        any device, or an array)."""
        if isinstance(array, torch.Tensor):
            array = array.detach().cpu().numpy()
        array = np.asarray(array)
        fb = FrameBuffer(array.shape[1], array.shape[0])
        fb.buffer = array.astype(np.uint8).copy()
        return fb

    def clear(self) -> None:
        """renderer.rs:477-479."""
        self.buffer.fill(0)

    def fill(self, color) -> None:
        """Fill every pixel with an RGBA u8 color (renderer.rs:485-494)."""
        self.buffer[:] = np.asarray(color, np.uint8)

    def set_pixel(self, x: int, y: int, color) -> None:
        """renderer.rs:496-503."""
        self.buffer[y, x] = np.asarray(color, np.uint8)

    def get_pixel(self, x: int, y: int):
        """renderer.rs:505-514."""
        return self.buffer[y, x].copy()

    def sample_2d(self, uv):
        """Bilinear sample of this buffer as a texture (renderer.rs:516-538)."""
        return sample_2d(u8_to_vec4(self.buffer), np.asarray(uv, np.float32))

    def draw_line(self, x1: int, y1: int, x2: int, y2: int, color) -> None:
        """Bresenham-style line (renderer.rs:540-588).

        The reference's quirk is kept: the x and the y endpoints are sorted
        *independently* (renderer.rs:541-542), so a negative-slope line is
        mirrored into a positive slope.
        """
        color = np.asarray(color, np.uint8)
        x1, x2 = (x1, x2) if x1 < x2 else (x2, x1)
        y1, y2 = (y1, y2) if y1 < y2 else (y2, y1)
        if x1 == x2 and y1 == y2:
            self.set_pixel(x1, y1, color)
        elif x1 == x2:
            for y in range(y1, y2):
                self.set_pixel(x1, y, color)
        elif y1 == y2:
            for x in range(x1, x2):
                self.set_pixel(x, y1, color)
        else:
            dx = x2 - x1
            dy = y2 - y1
            rem = 0
            if dx > dy:
                y = y1
                for x in range(x1, x2):
                    self.set_pixel(x, y, color)
                    rem += dy
                    if rem >= dx:
                        y += 1
                        rem -= dx
                        self.set_pixel(x, y, color)
                self.set_pixel(x2, y2, color)
            else:
                x = x1
                for y in range(y1, y2):
                    self.set_pixel(x, y, color)
                    rem += dx
                    if rem >= dy:
                        x += 1
                        rem -= dy
                        self.set_pixel(x, y, color)
                self.set_pixel(x2, y2, color)
