"""Texture stack for deferred multi-texture shading.

Port of ``f_renderer_tpu/shaders/texture.py``. The reference's pixel shader
picks one of several RGBA8 textures per triangle (phong.rs:147-151); with
deferred shading the texture id is a per-pixel value, so the textures live
in one padded stack indexed by id.

Storage is u8-backed like the reference: ``create`` quantizes float inputs
to u8 once, so every texel value is k/255. The device layout is GPU-natural:
``texels`` (T, Hmax, Wmax) int32, one packed RGBA8 texel per element
(r | g << 8 | b << 16 | a << 24), zero-padded past each texture's own
height and width. It samples identically to the JAX package's page-major
(T·pages·Hmax8, 128) layout: the sampler never reads past a texture's
width, and rows past its height are zero in both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from f_renderer_tpu_torch.device import resolve_device
from f_renderer_tpu_torch.shaders.texture_sampler import sample_packed_plain

LANES = 128

# The routing limit of the JAX package's fused path, in bytes of ITS packed
# layout (``TextureStack.packed_nbytes`` there). A stack past it leaves the
# fused path for rasterize_interp + shade_from_planes, in both packages
# (pipeline/fused.py:fused_path_ok). It is a TPU VMEM limit; the card's
# fused kernel reads texels through L2 and could take larger stacks.
PACKED_VMEM_BUDGET = 8 * 1024 * 1024


def _hmax_padded(hmax: int) -> int:
    return -(-max(hmax, 1) // 8) * 8


def _quantize(t) -> np.ndarray:
    t = np.asarray(t)
    if t.dtype != np.uint8:
        t = np.clip(np.round(t.astype(np.float32) * 255.0), 0, 255).astype(np.uint8)
    return t


def _pack(q: np.ndarray) -> np.ndarray:
    """(..., 4) u8 → (...) int32 RGBA8."""
    q = q.astype(np.uint32)
    packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    return packed.astype(np.uint32).view(np.int32)


@dataclasses.dataclass(frozen=True)
class TextureStack:
    texels: torch.Tensor  # (T, Hmax, Wmax) int32 RGBA8
    dims: torch.Tensor  # (T, 2) int32 — (height, width) per texture
    # Every real texel's alpha is 255: the sampler then takes alpha as the
    # weight sum instead of unpacking the byte (as the JAX package does).
    opaque: bool = False

    @property
    def t_count(self) -> int:
        return self.texels.shape[0]

    @property
    def hmax(self) -> int:
        return self.texels.shape[1]

    @property
    def wmax(self) -> int:
        return self.texels.shape[2]

    @property
    def packed_nbytes(self) -> int:
        """Bytes of the JAX package's packed layout for this stack — the
        quantity its fused-path routing compares with PACKED_VMEM_BUDGET."""
        pages = -(-max(self.wmax, 1) // LANES)
        return self.t_count * pages * _hmax_padded(self.hmax) * LANES * 4

    @staticmethod
    def create(textures, *, device="cuda") -> "TextureStack":
        """Build from a list of (H, W, 4) u8 or float arrays (floats are
        quantized to u8 once, as the reference's textures are u8 images)."""
        device = resolve_device(device)
        texq = [_quantize(t) for t in textures]
        hmax = max(t.shape[0] for t in texq)
        wmax = max(t.shape[1] for t in texq)
        q = np.zeros((len(texq), hmax, wmax, 4), np.uint8)
        dims = np.zeros((len(texq), 2), np.int32)
        for i, t in enumerate(texq):
            q[i, : t.shape[0], : t.shape[1]] = t
            dims[i] = (t.shape[0], t.shape[1])
        return TextureStack(
            texels=torch.from_numpy(_pack(q)).to(device),
            dims=torch.from_numpy(dims).to(device),
            opaque=all(bool((t[..., 3] == 255).all()) for t in texq),
        )

    @staticmethod
    def from_data(data, dims, *, device="cuda") -> "TextureStack":
        """From a padded (T, Hmax, Wmax, 4) f32 stack of k/255 values plus
        its (T, 2) dims — the JAX package's ``TextureStack.data``/``dims``."""
        dims = np.asarray(dims, np.int32)
        q = _quantize(np.asarray(data, np.float32))
        return TextureStack.create(
            [q[i, : dims[i, 0], : dims[i, 1]] for i in range(q.shape[0])],
            device=device,
        )

    @staticmethod
    def dummy(device="cuda") -> "TextureStack":
        """One 1×1 all-zero texel: what a textured shader samples when the
        uniforms carry no stack (the JAX package's dummy stack)."""
        device = resolve_device(device)
        return TextureStack(
            texels=torch.zeros((1, 1, 1), dtype=torch.int32, device=device),
            dims=torch.ones((1, 2), dtype=torch.int32, device=device),
            opaque=False,
        )

    def sample(self, index, u, v, *, replicate_clamp_bug: bool = True):
        """Bilinear sample → (4, *index.shape) f32.

        ``index`` holds each sample's texture id (-1: none, samples 0), ``u``
        and ``v`` its coordinates, all of one shape. On CUDA tensors this
        launches the sampler kernel (K3, ``kernels.sample_bilinear``); on CPU
        tensors it runs the plain version.
        """
        if index.device.type == "cpu":
            return self.sample_plain(index, u, v, replicate_clamp_bug=replicate_clamp_bug)
        from f_renderer_tpu_torch import kernels

        return kernels.sample_bilinear(
            self.texels,
            self.dims,
            index.to(torch.int32).contiguous(),
            u.to(torch.float32).contiguous(),
            v.to(torch.float32).contiguous(),
            opaque=self.opaque,
            replicate_clamp_bug=replicate_clamp_bug,
        )

    def sample_plain(self, index, u, v, *, replicate_clamp_bug: bool = True):
        """The plain PyTorch version of :meth:`sample` on the tensors' own
        device; it launches no kernel."""
        return sample_packed_plain(
            self.texels, self.dims, index, u, v,
            opaque=self.opaque, replicate_clamp_bug=replicate_clamp_bug,
        )
