"""Batched geometry stage (reference: renderer.rs:96-267).

Port of ``f_renderer_tpu/pipeline/geometry.py``, with the same two paths:

- The vertex shader runs once over all 3F face corners.
- Path A: faces fully inside the frustum emit one triangle each, with no
  clipping and no sort.
- Path B: the other faces (with nonzero w) are compacted into ``clip_cap``
  slots and clipped with the reference's exact, quirky semantics —
  intersections per (vertex pair × plane) with all originals retained,
  21 candidate slots, a stable sort by centroid angle, a fan of ≤ 19
  triangles (renderer.rs:150-266). Faces past the cap are dropped
  (documented overflow policy; ``num_clipped`` reports the count).

Plane order matches PLANE_LIST (renderer.rs:123-131): X_LEFT, X_RIGHT,
Y_UP, Y_DOWN, Z_NEAR, Z_FAR; Z_NEAR tests ``z >= 0`` (quirk, renderer.rs:55).
"""

from __future__ import annotations

import math

import torch

from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec

EPSILON = 1.0e-5
MAX_POLY = 21  # 18 intersection slots + 3 originals
MAX_FAN = MAX_POLY - 2  # fan triangles per clipped face
TWO_PI = 2.0 * math.pi


def _insides(pos):
    """Plane inside tests (renderer.rs:46-58). pos (..., 4) → (..., 6) bool."""
    x, y, z, w = pos.unbind(-1)
    return torch.stack([x >= -w, x <= w, y <= w, y >= -w, z >= 0.0, z <= w], dim=-1)


def _ratios(a, b):
    """Intersection ratios for all 6 planes (renderer.rs:60-73); division by
    zero yields inf as Rust f32 does."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            -(ax + aw) / (bw + bx - ax - aw),
            (aw - ax) / (aw - bw - ax + bx),
            (aw - ay) / (aw - bw - ay + by),
            -(ay + aw) / (bw + by - aw - ay),
            aw / (aw - bw),
            (aw - az) / (aw - bw - az + bz),
        ],
        dim=-1,
    )


def f32_to_i32_sat(x):
    """Rust ``f32 as i32``: truncate toward zero, saturate, NaN → 0.

    A float→int cast of NaN or of an out-of-range value is undefined in
    PyTorch, so the NaN guard and the clamp come first. (Saturation lands on
    the largest f32 below 2^31, as in the JAX package.)
    """
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32)


def _viewport(nx, ny, width, height):
    """NDC → float and integer screen coords, left-associative like the
    reference: ((x + 1) · W) · 0.5 rounds at the W multiply."""
    sx = (nx + 1.0) * float(width) * 0.5
    sy = (1.0 - ny) * float(height) * 0.5
    return sx, sy, f32_to_i32_sat(sx + 0.5), f32_to_i32_sat(sy + 0.5)


def _setup(ndc_x, ndc_y, spf_x, spf_y, spi_x, spi_y, rhw, ctx, valid, order,
           ps_index, cull):
    """Winding repair + raster setup on per-vertex (N,) planes
    (renderer.rs:300-320). Coordinate args are 3-lists (vertex-major) of (N,)
    tensors; ``ctx`` is a 3-list of (C, N) tensors."""
    nz = (ndc_x[1] - ndc_x[0]) * (ndc_y[2] - ndc_y[0]) - (ndc_y[1] - ndc_y[0]) * (
        ndc_x[2] - ndc_x[0]
    )
    swap = nz > 0.0  # NaN → no swap, like Rust
    if cull:
        valid = valid & ~swap
        swap = torch.zeros_like(swap)

    def sw(pl):
        return [pl[0], torch.where(swap, pl[2], pl[1]), torch.where(swap, pl[1], pl[2])]

    spi_x, spi_y, spf_x, spf_y, rhw, ctx = (
        sw(spi_x), sw(spi_y), sw(spf_x), sw(spf_y), sw(rhw), sw(ctx)
    )

    def tl(ax, ay, bx, by):  # top-left rule on integer coords (renderer.rs:26-29)
        return ((ay == by) & (ax < bx)) | (ay > by)

    top_left = torch.stack(
        [
            tl(spi_x[0], spi_y[0], spi_x[1], spi_y[1]),
            tl(spi_x[1], spi_y[1], spi_x[2], spi_y[2]),
            tl(spi_x[2], spi_y[2], spi_x[0], spi_y[0]),
        ]
    )
    return TriangleBuffer(
        spi=torch.stack([torch.stack([spi_x[v], spi_y[v]]) for v in range(3)]),
        spf=torch.stack([torch.stack([spf_x[v], spf_y[v]]) for v in range(3)]),
        rhw=torch.stack(rhw),
        ctx=torch.cat(ctx),
        top_left=top_left,
        valid=valid,
        order=order.to(torch.int32),
        ps_index=torch.full_like(order, ps_index, dtype=torch.int32),
    )


def _clip_faces(pos3, ctx3, width, height):
    """Fixed-shape clip of K (not-all-inside) faces (renderer.rs:150-266).

    pos3 (K, 3, 4), ctx3 (K, 3, C) → per-face fan arrays with MAX_FAN slots:
    (ndc (K, 19, 3, 2), spf, spi, rhw (K, 19, 3), ctx (K, 19, 3, C),
    tri_valid (K, 19)).
    """
    k = pos3.shape[0]
    ins = _insides(pos3)  # (K, 3, 6)
    pair_a, pair_b = [0, 0, 1], [1, 2, 2]
    a_pos, b_pos = pos3[:, pair_a], pos3[:, pair_b]  # (K, 3, 4)
    a_ctx, b_ctx = ctx3[:, pair_a], ctx3[:, pair_b]
    ratios = _ratios(a_pos, b_pos)  # (K, 3, 6)
    new_pos = a_pos[:, :, None, :] + ratios[..., None] * (b_pos - a_pos)[:, :, None, :]
    new_ctx = a_ctx[:, :, None, :] + (b_ctx - a_ctx)[:, :, None, :] * ratios[..., None]
    differ = ins[:, pair_a] != ins[:, pair_b]
    new_valid = differ & (torch.abs(new_pos[..., 3]) > EPSILON)

    c = ctx3.shape[-1]
    cand_pos = torch.cat([new_pos.reshape(k, 18, 4), pos3], dim=1)  # (K, 21, 4)
    cand_ctx = torch.cat([new_ctx.reshape(k, 18, c), ctx3], dim=1)
    cand_valid = torch.cat(
        [new_valid.reshape(k, 18), torch.ones((k, 3), dtype=torch.bool, device=pos3.device)],
        dim=1,
    )
    # Mask garbage slots so they cannot poison the centroid with NaN/inf.
    cand_pos = torch.where(cand_valid[..., None], cand_pos, 0.0)

    n = cand_valid.sum(dim=1).to(torch.int32)
    # Sum the candidates left to right; the reference multiplies by the
    # reciprocal of the count (renderer.rs:187), it does not divide.
    xy = cand_pos[..., :2] * cand_valid[..., None]
    total = xy[:, 0]
    for i in range(1, MAX_POLY):
        total = total + xy[:, i]
    centroid = total * torch.reciprocal(n.to(torch.float32))[:, None]
    d = cand_pos[..., :2] - centroid[:, None, :]
    ang = torch.atan2(d[..., 1], d[..., 0])
    ang = torch.where(ang < 0.0, ang + TWO_PI, ang)
    key = torch.where(cand_valid, ang, 1.0e9)
    perm = torch.sort(key, dim=1, stable=True).indices  # candidate order kept on ties
    pos_s = torch.gather(cand_pos, 1, perm[..., None].expand(-1, -1, 4))
    ctx_s = torch.gather(cand_ctx, 1, perm[..., None].expand(-1, -1, c))

    rhw = torch.reciprocal(pos_s[..., 3])
    nx = pos_s[..., 0] * rhw
    ny = pos_s[..., 1] * rhw
    sx, sy, six, siy = _viewport(nx, ny, width, height)

    # Fan triangulation with the reference's exact ordering (renderer.rs:237-266).
    t = torch.arange(MAX_FAN, dtype=torch.int32, device=pos3.device)[None, :]
    n1 = n[:, None]
    i1 = torch.where(t == n1 - 3, 1, torch.where(t == n1 - 4, 2, n1 - 2 - t))
    i2 = torch.where(t == n1 - 3, 2, torch.where(t == n1 - 4, 3, n1 - 1 - t))
    i0 = torch.zeros_like(i1)
    idx = torch.clamp(torch.stack([i0, i1, i2], dim=-1), 0, MAX_POLY - 1).long()
    rows = torch.arange(k, device=pos3.device)[:, None, None]

    def fan(plane):  # (K, 21, ...) → (K, 19, 3, ...)
        return plane[rows, idx]

    ndc = torch.stack([fan(nx), fan(ny)], dim=-1)
    spf = torch.stack([fan(sx), fan(sy)], dim=-1)
    spi = torch.stack([fan(six), fan(siy)], dim=-1)
    return ndc, spf, spi, fan(rhw), fan(ctx_s), t < (n1 - 2)


def geometry_process(
    vs_inputs: dict,
    vertex_shader,
    vs_uniform,
    width: int,
    height: int,
    *,
    clip_cap: int = 256,
    ps_index: int = 0,
    order_base: int = 0,
    cull: bool = False,
):
    """Run the geometry stage over a batch of faces.

    ``vs_inputs`` maps attribute names to (F, 3, k) tensors, one record per
    face corner. Returns ``(TriangleBuffer, {"num_clipped": 0-d int32})``;
    the buffer has ``F + clip_cap · MAX_FAN`` slots (path A: one per face;
    path B: the fan slots of up to ``clip_cap`` clipped faces).
    """
    f = next(iter(vs_inputs.values())).shape[0]
    dev = next(iter(vs_inputs.values())).device
    corners = {
        k: torch.cat([v[:, i] for i in range(3)]).to(torch.float32)
        for k, v in vs_inputs.items()
    }
    clip, ctx_dict = vertex_shader(vs_uniform, corners)  # (4, 3F), {k: (3F, ·)}
    codec = ContextCodec.of(ctx_dict)
    ctx_a = codec.flatten(ctx_dict)  # (C, 3F)
    c = codec.num_channels

    def vslice(arr, v):
        return arr[..., v * f : (v + 1) * f]

    xa, ya, za, wa = clip
    w_ok = (vslice(wa, 0) != 0.0) & (vslice(wa, 1) != 0.0) & (vslice(wa, 2) != 0.0)
    iv = (xa >= -wa) & (xa <= wa) & (ya <= wa) & (ya >= -wa) & (za >= 0.0) & (za <= wa)
    all_in = vslice(iv, 0) & vslice(iv, 1) & vslice(iv, 2)
    face_idx = torch.arange(f, dtype=torch.int32, device=dev)

    # ---- Path A: all-inside faces (no clip, no sort) ----
    rhw_a = torch.reciprocal(wa)
    nx_a = xa * rhw_a
    ny_a = ya * rhw_a
    sx_a, sy_a, six_a, siy_a = _viewport(nx_a, ny_a, width, height)
    buf_a = _setup(
        *([vslice(p, v) for v in range(3)] for p in (nx_a, ny_a, sx_a, sy_a, six_a, siy_a, rhw_a, ctx_a)),
        w_ok & all_in,
        order_base + face_idx * MAX_FAN,
        ps_index,
        cull,
    )

    # ---- Path B: clipped faces, compacted to clip_cap slots ----
    b_mask = w_ok & ~all_in
    num_clipped = b_mask.sum().to(torch.int32)
    m_b = clip_cap * MAX_FAN
    if int(num_clipped) > 0:  # host sync: skip the clip path when nothing clips
        found = torch.nonzero(b_mask).flatten()[:clip_cap]
        sel = torch.full((clip_cap,), f, dtype=torch.int64, device=dev)
        sel[: found.numel()] = found
        # Padding slots (sel == f) gather face f-1 as the JAX package's
        # clamped gather does; their fan slots are masked below.
        g = torch.clamp(sel, max=f - 1)
        b_pos = torch.stack([torch.stack([vslice(clip[j], v)[g] for j in range(4)], -1) for v in range(3)], 1)
        b_ctx = torch.stack([vslice(ctx_a, v)[:, g].T for v in range(3)], 1)
        ndc, spf, spi, rhw, ctx_s, tri_valid = _clip_faces(b_pos, b_ctx, width, height)
        tri_valid = tri_valid & (sel < f)[:, None]
        order_b = (
            order_base
            + sel[:, None].to(torch.int32) * MAX_FAN
            + torch.arange(MAX_FAN, dtype=torch.int32, device=dev)[None, :]
        )
    else:
        ndc = torch.zeros((clip_cap, MAX_FAN, 3, 2), device=dev)
        spf = torch.zeros((clip_cap, MAX_FAN, 3, 2), device=dev)
        spi = torch.zeros((clip_cap, MAX_FAN, 3, 2), dtype=torch.int32, device=dev)
        rhw = torch.zeros((clip_cap, MAX_FAN, 3), device=dev)
        ctx_s = torch.zeros((clip_cap, MAX_FAN, 3, c), device=dev)
        tri_valid = torch.zeros((clip_cap, MAX_FAN), dtype=torch.bool, device=dev)
        order_b = torch.full((clip_cap, MAX_FAN), order_base, dtype=torch.int32, device=dev)

    def flat(x):
        return x.reshape((m_b,) + x.shape[2:])

    ndc, spf, spi, rhw, ctx_s = (flat(x) for x in (ndc, spf, spi, rhw, ctx_s))
    buf_b = _setup(
        [ndc[:, v, 0] for v in range(3)],
        [ndc[:, v, 1] for v in range(3)],
        [spf[:, v, 0] for v in range(3)],
        [spf[:, v, 1] for v in range(3)],
        [spi[:, v, 0] for v in range(3)],
        [spi[:, v, 1] for v in range(3)],
        [rhw[:, v] for v in range(3)],
        [ctx_s[:, v].T for v in range(3)],
        flat(tri_valid),
        flat(order_b),
        ps_index,
        cull,
    )
    return TriangleBuffer.concat([buf_a, buf_b]), {"num_clipped": num_clipped}
