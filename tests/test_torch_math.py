"""Port math, camera and mesh builders vs the JAX package.

The mesh builders are numpy and match exactly. The float32 math matches to
2 ulps: the port rounds every multiply and add, while XLA's CPU backend
contracts ``a*b + c`` into fused multiply-adds inside jitted jnp functions
(``jnp.linalg.norm``, ``jnp.dot``, ``jnp.matmul``), which moves a result by
up to a unit or two in the last place. (With XLA's CPU ISA capped below FMA
the two agree exactly except for the order of matmul and dot sums.)
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="compares the port with the JAX package")

import jax.numpy as jnp

from f_renderer_tpu import camera as jcam
from f_renderer_tpu import math as jm
from f_renderer_tpu import scene as jscene
from f_renderer_tpu_torch import camera as pcam
from f_renderer_tpu_torch import math as pm
from f_renderer_tpu_torch import scene as pscene
from f_renderer_tpu_torch.math import mat_mul4


def assert_ulp(got, want, ulps=2):
    """Equal up to ``ulps`` float32 units in the last place of the array's
    largest magnitude (an entry near zero by cancellation carries the
    rounding of the terms that cancelled, not its own ulp)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=-1, keepdims=True)
    tol = ulps * np.spacing(scale.astype(np.float32))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize(
    "eye, at, up",
    [
        ([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        ([1.3, -2.0, 0.7], [0.2, 0.4, -1.0], [0.1, 1.0, 0.2]),
    ],
)
def test_look_at(eye, at, up):
    assert_ulp(pm.set_look_at(eye, at, up), jm.set_look_at(eye, at, up))


@pytest.mark.parametrize("fovy, aspect", [(np.pi * 0.25, 128 / 96), (1.1, 16 / 9)])
def test_perspective(fovy, aspect):
    assert_ulp(
        pm.set_perspective(fovy, aspect, 0.1, 100.0),
        jm.set_perspective(fovy, aspect, 0.1, 100.0),
    )


@pytest.mark.parametrize("axis, theta", [([0.0, 1.0, 0.0], 0.15), ([1.0, 2.0, -0.5], 2.3)])
def test_rotate(axis, theta):
    assert_ulp(pm.set_rotate(axis, theta), jm.set_rotate(axis, theta))


def test_identity_normalize_reflect():
    np.testing.assert_array_equal(pm.set_identity().numpy(), np.asarray(jm.set_identity()))
    rng = np.random.default_rng(3)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    n = rng.standard_normal((64, 3)).astype(np.float32)
    assert_ulp(pm.normalize(torch.from_numpy(v)), jm.normalize(jnp.asarray(v)))
    assert_ulp(
        pm.reflect(torch.from_numpy(v), torch.from_numpy(n)),
        jm.reflect(jnp.asarray(v), jnp.asarray(n)),
    )


def test_mvp_compose_matches_highest_precision_matmul():
    """The port composes proj·view·model as fixed-order sums; the JAX shader
    uses a HIGHEST-precision matmul. Both are float32 sums of four products."""
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 4, 4)).astype(np.float32)
    want = jnp.matmul(jnp.asarray(a), jnp.asarray(b), precision="highest")
    assert_ulp(mat_mul4(torch.from_numpy(a), torch.from_numpy(b)), want)


def test_camera_controls():
    args = ([0.0, 1.0, 3.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0])
    jc, pc = jcam.Camera.create(*args), pcam.Camera.create(*args, device="cpu")
    for jf, pf in (
        (lambda c: jcam.orbit(c, 30.0, -12.0), lambda c: pcam.orbit(c, 30.0, -12.0)),
        (lambda c: jcam.pan(c, 4.0, 2.5), lambda c: pcam.pan(c, 4.0, 2.5)),
        (lambda c: jcam.zoom(c, 1.0), lambda c: pcam.zoom(c, 1.0)),
        (lambda c: jcam.zoom(c, -2.0), lambda c: pcam.zoom(c, -2.0)),
    ):
        jc, pc = jf(jc), pf(pc)
        for field in ("eye", "at", "up"):
            assert_ulp(getattr(pc, field), getattr(jc, field))
    assert_ulp(pc.look_at(), jc.look_at())


def test_zoom_clamp():
    """Zooming in past the minimum distance (or out past 20) is refused."""
    far = pcam.Camera.create([0.0, 0.0, 25.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device="cpu")
    assert torch.equal(pcam.zoom(far, -1.0).eye, far.eye)
    assert not torch.equal(pcam.zoom(far, 1.0).eye, far.eye)


def test_mesh_builders_identical():
    for name, args in (
        ("make_cube", (0.8,)),
        ("make_uv_sphere", (6, 12, 0.5)),
        ("make_checker_texture", (32, 4)),
    ):
        got = getattr(pscene, name)(*args)
        want = getattr(jscene, name)(*args)
        if isinstance(want, dict):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("xyz", [(2.0, 0.5, -3.0), (1.0, 1.0, 1.0)])
def test_set_scale(xyz):
    np.testing.assert_array_equal(pm.set_scale(*xyz).numpy(), np.asarray(jm.set_scale(*xyz)))


@pytest.mark.parametrize("batch", [(17,), (4, 5)])
def test_transform_points_h(batch):
    """The port sums each row left to right; the JAX package's matmul may
    contract or reorder the sum: within 2 ulps of the row's largest term."""
    rng = np.random.default_rng(5)
    m = np.array(jm.set_perspective(np.pi * 0.25, 4 / 3, 0.1, 100.0) @ jm.set_rotate([0.0, 1.0, 0.0], 0.4))
    pts = rng.uniform(-3.0, 3.0, batch + (3,)).astype(np.float32)
    got = pm.transform_points_h(torch.from_numpy(m), torch.from_numpy(pts))
    assert got.shape == batch + (4,)
    assert_ulp(got, jm.transform_points_h(jnp.asarray(m), jnp.asarray(pts)), ulps=4)
