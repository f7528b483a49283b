"""Signed zeros where the port clamps or takes a minimum and the JAX package
takes ``jnp.maximum`` / ``jnp.minimum``.

``torch.maximum(-0, +0)`` is -0 and ``torch.clamp(-0, min=0)`` is -0, where
``jnp.maximum`` gives +0; ``torch.minimum(+0, -0)`` is +0, where
``jnp.minimum`` gives -0. Each such site of the port whose value can reach a
bit-for-bit comparison is held here to the JAX package on crafted inputs
that make it produce a zero of the other sign:

- the Gouraud vertex shader's lambert term (``shaders/builtin.py``,
  ``_phong_lighting``: JAX ``jnp.maximum(n·l, 0)``): its colour varying is
  compared bit for bit, and with a light colour channel of -0 the sign of
  a -0 lambert term survives the sum. Its specular term goes through
  ``pow32``, whose squarings make either zero +0, so that site cannot
  differ; the crafted vertex runs it too.

The other sites cannot reach a bit-for-bit comparison: the pixel shaders'
lighting (``phong_light_planar``) ends in an RGBA8 pack that maps both zeros
to 0 (and its JAX counterpart normalizes through ``rsqrt``, so no float of
it is compared bit for bit), and the plain voxel march's ``torch.clamp`` /
``torch.minimum`` values (a step length, the next sample's t) only move
rays whose queries treat both zeros alike (``>= 0``, ``floor``, ``+ eps``).

The JAX reference runs in a subprocess with ``--xla_cpu_max_isa=AVX`` so
that XLA makes no fused multiply-adds, as in tests/test_torch_voxel_setup.py;
this file is that subprocess's script too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

LIGHT_POS = (-0.0, -1.0, -1.0)  # x = -0: lp - p is -0 where p_x = +0
LIGHT_COLOR = (-0.0, 1.0, 0.5)  # a -0 channel keeps the sign of the lambert term


def vertices():
    """Random vertices, then crafted ones: normal (1, 0, 0) at world x = +0
    under the light above, where n·l = 1·(-0) + 0·(neg) + 0·(neg) = -0."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1.0, 1.0, (61, 3)).astype(np.float32)
    normal = rng.standard_normal((61, 3)).astype(np.float32)
    pos = np.concatenate([pos, [[0.0, 0.5, 0.5], [0.0, 0.25, 0.75], [0.0, -0.5, 0.5]]]).astype(np.float32)
    normal = np.concatenate([normal, [[1.0, 0.0, 0.0], [2.0, 0.0, 0.0], [1.0, -0.0, 0.0]]]).astype(np.float32)
    return pos, normal


def uniforms():
    eye = np.eye(4, dtype=np.float32)
    return {"model": eye, "view": eye, "proj": eye, "view_pos": np.array([0.3, 0.2, 2.0], np.float32)}


def _write_jax_reference(path):
    """The JAX package's Gouraud vertex shader on :func:`vertices`."""
    import jax
    import jax.numpy as jnp

    from f_renderer_tpu.shaders import make_gouraud_shaders

    pos, normal = vertices()
    vs, _ = make_gouraud_shaders(light_pos=LIGHT_POS, light_color=LIGHT_COLOR)
    u = {k: jnp.asarray(v) for k, v in uniforms().items()}
    clip, ctx = jax.vmap(lambda vin: vs(u, vin))({"pos": jnp.asarray(pos), "normal": jnp.asarray(normal)})
    np.savez(path, clip=np.asarray(clip).T, color=np.asarray(ctx["color"]))  # clip as the port's (4, N)


if __name__ == "__main__":
    _write_jax_reference(sys.argv[1])
    sys.exit(0)

pytest.importorskip("jax", reason="compares the port with the JAX package")

from f_renderer_tpu_torch.math.transforms import max0  # noqa: E402
from f_renderer_tpu_torch.shaders import make_gouraud_shaders  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_signed_zero") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600)
    with np.load(path) as data:
        return dict(data)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_gouraud_vertex_shader_signed_zeros_equal_jax(ref):
    """The colour varying bit for bit (signed zeros told apart), the
    crafted vertices' -0 lambert terms included."""
    pos, normal = vertices()
    vs, _ = make_gouraud_shaders(light_pos=LIGHT_POS, light_color=LIGHT_COLOR)
    clip, ctx = vs({k: torch.from_numpy(v) for k, v in uniforms().items()},
                   {"pos": torch.from_numpy(pos), "normal": torch.from_numpy(normal)})
    np.testing.assert_array_equal(bits(clip.numpy()), bits(ref["clip"]))
    color = ctx["color"].numpy()
    crafted = ref["color"][-3:, 0]
    assert (crafted == 0.0).all() and np.signbit(crafted).all()  # JAX: (-0) · 0.1 + (+0)(-0) + … = -0
    np.testing.assert_array_equal(bits(color), bits(ref["color"]))


def test_max0_is_jnp_maximum_with_zero():
    """``max0(x)`` is ``jnp.maximum(x, 0.0)`` on zeros of both signs, NaN,
    ±inf and ordinary values."""
    import jax.numpy as jnp

    x = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, -1e-30, 1e-30, -2.5, 3.0], np.float32)
    got = max0(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.maximum(jnp.asarray(x), 0.0))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(bits(got[ok]), bits(want[ok]))
