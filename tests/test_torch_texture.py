"""Plain K2 / K3 sampler vs the JAX package's samplers.

``TextureStack.sample`` on CPU tensors runs the plain version
(``sample_packed_plain``) of both the in-kernel sampler (K2,
texture_pallas.py:95) and the standalone sampler kernel (K3,
``sample_bilinear_pallas``, texture_pallas.py:446). It is held against the
JAX package's XLA sampler (``TextureStack.sample``) and its Pallas sampler
(``sample_bilinear_pallas``, interpret mode) at the tolerance the JAX suite
uses between those two (tests/test_texture_pallas.py): rtol = atol = 1e-6.
Pixels with no texture (id -1) are don't-care in both packages.
"""

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch.shaders.texture import TextureStack

# The JAX side is imported inside the helpers, so that the file also
# collects (for its ``cuda`` tests) where JAX is not installed.


def stacks(textures):
    from f_renderer_tpu.shaders.texture import TextureStack as JaxStack

    return JaxStack.create(textures), TextureStack.create(textures, device="cpu")


def port_sample(stack, idx, uv, **kw):
    out = stack.sample(torch.from_numpy(idx), torch.from_numpy(uv[..., 0]), torch.from_numpy(uv[..., 1]), **kw)
    return np.moveaxis(out.numpy(), 0, -1)


def pallas_sample(stack, idx, uv, **kw):
    import jax.numpy as jnp

    from f_renderer_tpu.shaders.texture_pallas import sample_bilinear_pallas

    return np.asarray(
        sample_bilinear_pallas(
            stack.packed, stack.dims, jnp.asarray(idx), jnp.asarray(uv),
            hmax=int(stack.data.shape[1]), pages=stack.pages, interpret=True,
            opaque=stack.opaque, **kw,
        )
    )


def xla_sample(stack, idx, uv):
    import jax.numpy as jnp

    return np.asarray(stack.sample(jnp.asarray(idx), jnp.asarray(uv)))


def close(got, want, mask):
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("opaque", [False, True])
def test_multi_page_nonsquare_stack(rng, opaque):
    """Three textures: 13×200 (two 128-lane pages on the TPU, rows not a
    multiple of 8), 48×96 and a tall 40×16 (the width-clamp-on-y quirk);
    uv partly outside [0, 1]."""
    texs = [rng.random((h, w, 4)).astype(np.float32) for h, w in ((13, 200), (48, 96), (40, 16))]
    if opaque:
        for t in texs:
            t[..., 3] = 1.0
    jstack, pstack = stacks(texs)
    assert jstack.pages == 2 and jstack.opaque == pstack.opaque == opaque
    idx = rng.integers(-1, 3, (11, 64)).astype(np.int32)
    uv = rng.uniform(-0.3, 1.3, (11, 64, 2)).astype(np.float32)
    got = port_sample(pstack, idx, uv)
    valid = idx >= 0
    close(got, pallas_sample(jstack, idx, uv), valid)
    # With an opaque stack alpha is the weight sum (both in-kernel samplers),
    # where the XLA sampler reads the zero padding the width-clamp quirk
    # reaches past a texture's height: compare colour only there.
    channels = 3 if opaque else 4
    close(got[..., :channels], xla_sample(jstack, idx, uv)[..., :channels], valid)
    assert (got[~valid] == 0).all()  # no texture samples 0


def test_out_of_range_and_nan_uv(rng):
    """uv far outside [0, 1] clamps; a NaN coordinate is guarded to 0 before
    the fracts (the Pallas sampler's guard; the XLA sampler returns NaN)."""
    jstack, pstack = stacks([rng.random((16, 16, 4)).astype(np.float32)] * 2)
    idx = np.array([[0, 1, 0, 1, 0, 1]], np.int32)
    uv = np.array(
        [[[1.5, -0.5], [2.0, 2.0], [-1.0, 0.99], [np.nan, 0.3], [0.3, np.nan], [7.25, -3.5]]],
        np.float32,
    )
    got = port_sample(pstack, idx, uv)
    finite = ~np.isnan(uv).any(axis=-1)
    close(got, xla_sample(jstack, idx, uv), finite)
    close(got, pallas_sample(jstack, idx, uv), np.ones_like(finite))
    assert np.isfinite(got).all()


def test_from_data_round_trip(rng):
    """A stack rebuilt from the JAX package's (data, dims) holds the same texels."""
    texs = [rng.random((h, w, 4)).astype(np.float32) for h, w in ((9, 30), (20, 12))]
    jstack, pstack = stacks(texs)
    rebuilt = TextureStack.from_data(np.asarray(jstack.data), np.asarray(jstack.dims), device="cpu")
    assert torch.equal(rebuilt.texels, pstack.texels)
    assert torch.equal(rebuilt.dims, pstack.dims)
    assert rebuilt.opaque == pstack.opaque == jstack.opaque
    assert pstack.packed_nbytes == jstack.packed_nbytes


@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("replicate_clamp_bug", [True, False])
def test_k3_plain_matches_pallas_sampler(rng, replicate_clamp_bug, opaque):
    """K3's plain version against ``sample_bilinear_pallas`` (interpret
    mode) with the width-clamp quirk on and off, on a stack three TPU lane
    pages wide with textures taller and wider than they are square."""
    texs = [rng.random((h, w, 4)).astype(np.float32) for h, w in ((20, 300), (70, 40), (9, 130))]
    if opaque:
        for t in texs:
            t[..., 3] = 1.0
    jstack, pstack = stacks(texs)
    assert jstack.pages == 3 and pstack.opaque == opaque
    idx = rng.integers(-1, 3, (5, 200)).astype(np.int32)
    uv = rng.uniform(-0.2, 1.2, (5, 200, 2)).astype(np.float32)
    got = port_sample(pstack, idx, uv, replicate_clamp_bug=replicate_clamp_bug)
    want = pallas_sample(jstack, idx, uv, replicate_clamp_bug=replicate_clamp_bug)
    close(got, want, idx >= 0)
    # The flag matters here: the 70x40 texture's y clamps at 39 or at 69.
    other = port_sample(pstack, idx, uv, replicate_clamp_bug=not replicate_clamp_bug)
    assert not np.array_equal(got[idx == 1], other[idx == 1])


@pytest.mark.cuda
@pytest.mark.parametrize("replicate_clamp_bug", [True, False])
def test_k3_kernel_matches_plain_on_card(replicate_clamp_bug):
    """K3 against its plain version on the card (same tolerance as above:
    both round every product and sum, so equal in practice). Run on the card
    with ``python -m pytest --noconftest -m cuda tests/test_torch_texture.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from f_renderer_tpu_torch import kernels

    rng = np.random.default_rng(1234)  # (no conftest fixtures on the card)
    texs = [rng.random((h, w, 4)).astype(np.float32) for h, w in ((20, 300), (70, 40), (512, 512))]
    stack = TextureStack.create(texs, device="cuda")
    idx = torch.from_numpy(rng.integers(-1, 3, (300, 400)).astype(np.int32)).cuda()
    u, v = torch.from_numpy(rng.uniform(-0.2, 1.2, (2, 300, 400)).astype(np.float32)).cuda()
    before = kernels.sample_bilinear.launches
    got = stack.sample(idx, u, v, replicate_clamp_bug=replicate_clamp_bug)
    assert kernels.sample_bilinear.launches == before + 1
    want = stack.sample_plain(idx, u, v, replicate_clamp_bug=replicate_clamp_bug)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
