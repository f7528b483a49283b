"""The port's framebuffer module against the JAX package's, on the cases of
tests/test_framebuffer.py: the truncating ``vec4_to_u8``, ``u8_to_vec4``,
``sample_2d`` (fract weights, the width-clamp-on-y quirk on a non-square
texture) on torch tensors and on numpy arrays, and the host
``FrameBuffer`` with the reference's ``draw_line`` quirk."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="compares the port with the JAX package")

import jax.numpy as jnp

from f_renderer_tpu import framebuffer as jfb
from f_renderer_tpu_torch import framebuffer as pfb


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_vec4_to_u8_truncates_like_jax(kind):
    v = np.array([[0.0, 1.0, 0.5, 2.0], [-1.0, 0.25, 0.999, 1.0], [0.1, 0.2, 0.3, 0.7]], np.float32)
    got = pfb.vec4_to_u8(torch.from_numpy(v) if kind == "torch" else v)
    got = got.numpy() if kind == "torch" else got
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jfb.vec4_to_u8(jnp.asarray(v))))
    np.testing.assert_array_equal(got[:2], [[0, 255, 127, 255], [0, 63, 254, 255]])  # 127.5 → 127


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_u8_to_vec4_matches_jax(kind):
    u = np.array([0, 255, 128, 64], np.uint8)
    got = pfb.u8_to_vec4(torch.from_numpy(u) if kind == "torch" else u)
    got = got.numpy() if kind == "torch" else got
    np.testing.assert_array_equal(got, np.asarray(jfb.u8_to_vec4(jnp.asarray(u))))


def _tex_uv(h, w, n, seed):
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (h, w, 4)).astype(np.float32) / 255.0
    uv = rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32)  # past the edges: clamped
    return tex, uv


@pytest.mark.parametrize("kind", ["torch", "numpy"])
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("h, w", [(4, 2), (8, 16), (16, 16)])
def test_sample_2d_matches_jax(kind, quirk, h, w):
    tex, uv = _tex_uv(h, w, 257, seed=h * 31 + w)
    args = (torch.from_numpy(tex), torch.from_numpy(uv)) if kind == "torch" else (tex, uv)
    want_jnp = np.asarray(jfb.sample_2d(jnp.asarray(tex), jnp.asarray(uv), replicate_clamp_bug=quirk))
    if kind == "numpy" and quirk and h < w:
        # the width clamp passes the last row: numpy indexing raises in both
        with pytest.raises(IndexError):
            jfb.sample_2d(tex, uv, replicate_clamp_bug=quirk)
        with pytest.raises(IndexError):
            pfb.sample_2d(tex, uv, replicate_clamp_bug=quirk)
        return
    got = pfb.sample_2d(*args, replicate_clamp_bug=quirk)
    assert isinstance(got, torch.Tensor) == (kind == "torch")
    got = np.asarray(got)
    if not (quirk and h < w):  # the JAX package's numpy path, expression by expression
        np.testing.assert_array_equal(got, np.asarray(jfb.sample_2d(tex, uv, replicate_clamp_bug=quirk)))
    np.testing.assert_allclose(got, want_jnp, atol=1e-6)  # its jnp gathers clamp the row


@pytest.mark.parametrize("quirk", [True, False])
def test_sample_2d_non_finite_uv_matches_jax(quirk):
    """NaN, ±inf and out-of-range uv on the torch path: what the JAX
    package's jnp path returns (a NaN coordinate reads texel 0 there and
    gives NaN through the weights), NaN in the same places."""
    tex, _ = _tex_uv(4, 4, 1, seed=3)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    uv = np.array([[nan, 0.25], [0.25, nan], [nan, nan], [inf, 0.5], [0.5, -inf], [-inf, inf],
                   [3.5, -2.0], [-1e30, 1e30], [0.25, 0.75]], np.float32)
    got = pfb.sample_2d(torch.from_numpy(tex), torch.from_numpy(uv), replicate_clamp_bug=quirk).numpy()
    want = np.asarray(jfb.sample_2d(jnp.asarray(tex), jnp.asarray(uv), replicate_clamp_bug=quirk))
    assert np.isnan(got[:6]).all() and np.isfinite(got[6:]).all()
    np.testing.assert_array_equal(got, want)  # NaN where JAX has NaN


def test_sample_2d_width_clamp_quirk():
    """H=4, W=2: the reference clamps y with width - 1 = 1, so v near the
    bottom reads row 1, not row 3 (renderer.rs:523-525)."""
    tex = np.zeros((4, 2, 4), np.float32)
    tex[1] = 0.25
    tex[3] = 1.0
    uv = torch.tensor([0.0, 0.9])
    np.testing.assert_allclose(pfb.sample_2d(torch.from_numpy(tex), uv).numpy(), [0.25] * 4, atol=1e-6)
    np.testing.assert_allclose(pfb.sample_2d(torch.from_numpy(tex), uv, replicate_clamp_bug=False).numpy(),
                               [1.0] * 4, atol=1e-6)


def test_sample_2d_batched_shape():
    tex, _ = _tex_uv(8, 8, 1, seed=0)
    uv = torch.rand(5, 7, 2, generator=torch.Generator().manual_seed(1))
    assert pfb.sample_2d(torch.from_numpy(tex), uv).shape == (5, 7, 4)


@pytest.mark.parametrize("line", [(2, 2, 10, 5), (10, 2, 2, 5), (3, 1, 5, 14), (7, 7, 7, 12), (1, 9, 12, 9), (4, 4, 4, 4)])
def test_draw_line_matches_jax(line):
    """Every case, the mirror quirk of negative slopes included (endpoints
    sorted independently, renderer.rs:541-542), draws JAX's pixels."""
    c = [255, 0, 0, 255]
    got, want = pfb.FrameBuffer(16, 16), jfb.FrameBuffer(16, 16)
    got.draw_line(*line, c)
    want.draw_line(*line, c)
    np.testing.assert_array_equal(got.buffer, want.buffer)
    assert got.buffer[..., 0].astype(bool).sum() >= 1


def test_framebuffer_api_matches_jax():
    got, want = pfb.FrameBuffer(3, 5), jfb.FrameBuffer(3, 5)
    for fb in (got, want):
        fb.fill([10, 20, 30, 255])
        fb.set_pixel(2, 3, [1, 2, 3, 4])
    np.testing.assert_array_equal(got.buffer, want.buffer)
    np.testing.assert_array_equal(got.get_pixel(2, 3), [1, 2, 3, 4])
    uv = np.array([[0.3, 0.7], [0.9, 0.1]], np.float32)
    np.testing.assert_array_equal(got.sample_2d(uv), want.sample_2d(uv))
    frame = torch.arange(2 * 3 * 4, dtype=torch.uint8).reshape(2, 3, 4)
    np.testing.assert_array_equal(pfb.FrameBuffer.from_array(frame).buffer, frame.numpy())
    got.clear()
    assert got.buffer.sum() == 0
