"""Matrix / vector math with the reference renderer's exact conventions.

PyTorch port of ``f_renderer_tpu/math/transforms.py``; the conventions are
the same (matrix_util.rs, vector_util.rs):

- ``(4, 4)`` matrices applied to column vectors, ``clip = M @ v``;
- left-handed look-at, forward ``z = normalize(at - eye)``;
- D3D-style perspective, z mapped to ``[0, 1]``;
- axis-angle rotation via quaternion expansion;
- ``reflect(L, N) = normalize(2 (L·N) N - L)``.

Everything is float32. Sums of products are written out in a fixed
left-to-right order (never a library matmul or reduction), so the result
does not depend on the device or on how a BLAS blocks its loops.
"""

from __future__ import annotations

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def true_div(a, b):
    """Correctly rounded float32 ``a / b`` on any device.

    PyTorch's CUDA division by a Python number multiplies by the number's
    reciprocal, which can differ from ``a / b`` in the last bit; the plain
    versions of the kernels must round as the kernels do, so a Python-number
    operand becomes a 0-d tensor on the other operand's device first.
    """
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=torch.float32, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    return torch.div(a, b)


def true_sqrt(x):
    """Correctly rounded float32 ``sqrt(x)`` on any device.

    PyTorch's vectorized CPU sqrt is off by one ulp on some inputs; the
    square root taken in float64 and rounded once to float32 is the
    correctly rounded one (53 ≥ 2·24 + 2 bits), as CUDA's ``sqrtf`` and
    XLA's are.
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def max0(x):
    """``jnp.maximum(x, 0.0)``: NaN stays NaN, and a zero of either sign
    gives +0 (``torch.clamp(x, min=0.0)`` and ``torch.maximum`` keep -0)."""
    return torch.where((x > 0.0) | torch.isnan(x), x, 0.0)


def _dot3(a, b):
    """Σ a_i b_i over the last axis of size 3, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize(v):
    """v / |v| over the last axis (no epsilon — glam release semantics), the
    square root correctly rounded (:func:`true_sqrt`), as the JAX package's
    and the kernels' are."""
    v = _f32(v)
    return v / true_sqrt(_dot3(v, v)).unsqueeze(-1)


def set_identity(device=None):
    """matrix_util.rs:4-8."""
    return torch.eye(4, dtype=torch.float32, device=device)


def set_look_at(eye, at, up):
    """Left-handed look-at view matrix (matrix_util.rs:11-22)."""
    eye = _f32(eye)
    at, up = _f32(at, eye.device), _f32(up, eye.device)
    z_axis = normalize(at - eye)
    x_axis = normalize(_cross(up, z_axis))
    y_axis = _cross(z_axis, x_axis)
    t = -torch.stack([_dot3(eye, x_axis), _dot3(eye, y_axis), _dot3(eye, z_axis)])
    top = torch.cat([torch.stack([x_axis, y_axis, z_axis]), t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=eye.device)
    return torch.cat([top, bottom], dim=0)


def set_perspective(fovy, aspect, zn, zf, device=None):
    """LH, D3D z∈[0,1] perspective projection (matrix_util.rs:25-35)."""
    fovy, aspect, zn, zf = (_f32(x, device) for x in (fovy, aspect, zn, zf))
    fax = 1.0 / torch.tan(fovy * 0.5)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    rows = [
        torch.stack([fax / aspect, zero, zero, zero]),
        torch.stack([zero, fax, zero, zero]),
        torch.stack([zero, zero, zf / (zf - zn), -zn * zf / (zf - zn)]),
        torch.stack([zero, zero, one, zero]),
    ]
    return torch.stack(rows)


def set_rotate(axis, theta, device=None):
    """Axis-angle rotation matrix via quaternion expansion (matrix_util.rs:38-67)."""
    axis = normalize(_f32(axis, device))
    theta = _f32(theta, axis.device)
    q_sin = torch.sin(theta * 0.5)
    w = torch.cos(theta * 0.5)
    x, y, z = axis[0] * q_sin, axis[1] * q_sin, axis[2] * q_sin
    zero = torch.zeros((), dtype=torch.float32, device=axis.device)
    one = torch.ones((), dtype=torch.float32, device=axis.device)
    rows = [
        torch.stack([1.0 - 2.0 * y * y - 2.0 * z * z, 2.0 * x * y - 2.0 * w * z, 2.0 * x * z + 2.0 * w * y, zero]),
        torch.stack([2.0 * x * y + 2.0 * w * z, 1.0 - 2.0 * x * x - 2.0 * z * z, 2.0 * y * z - 2.0 * w * x, zero]),
        torch.stack([2.0 * x * z - 2.0 * w * y, 2.0 * y * z + 2.0 * w * x, 1.0 - 2.0 * x * x - 2.0 * y * y, zero]),
        torch.stack([zero, zero, zero, one]),
    ]
    return torch.stack(rows)


def set_scale(x, y, z, device=None):
    """Diagonal scale matrix (matrix_util.rs:71-78)."""
    return torch.diag(torch.stack([_f32(x, device), _f32(y, device), _f32(z, device),
                                   torch.ones((), dtype=torch.float32, device=device)]))


def reflect(light, normal):
    """``normalize(2 (L·N) N - L)`` over the last axis (vector_util.rs:4-7)."""
    light, normal = _f32(light), _f32(normal)
    d = _dot3(light, normal).unsqueeze(-1)
    return normalize(2.0 * d * normal - light)


def mat_mul4(a, b):
    """(4, 4) @ (4, 4) with each entry summed left to right over k."""
    return (
        (a[:, 0:1] * b[0:1, :] + a[:, 1:2] * b[1:2, :]) + a[:, 2:3] * b[2:3, :]
    ) + a[:, 3:4] * b[3:4, :]


def mat_vec4(m, p):
    """Row-major (4, 4) · 4 planes → 4 planes, as sequential mul/add chains
    (the C++ reference's ``mat4_mul_v4`` order, fr_native.cpp:60-67).
    ``p`` is a sequence of four tensors of one shape (planes over vertices)."""
    return torch.stack(
        [
            ((m[i, 0] * p[0] + m[i, 1] * p[1]) + m[i, 2] * p[2]) + m[i, 3] * p[3]
            for i in range(4)
        ]
    )


def transform_points_h(m, points):
    """Apply a (4, 4) matrix to 3-D points with homogeneous w = 1:
    ``points`` (..., 3) → (..., 4) clip-space positions, the reference's
    per-vertex ``mvp * vec4(pos, 1)`` (phong.rs:125), each entry summed left
    to right."""
    m, points = _f32(m), _f32(points)
    p = [points[..., 0], points[..., 1], points[..., 2]]
    return torch.stack(
        [((m[i, 0] * p[0] + m[i, 1] * p[1]) + m[i, 2] * p[2]) + m[i, 3] for i in range(4)], dim=-1
    )
