"""The triangle scenes' kind: their inputs, the plain reference renderer
the benchmark holds the port to, and the least work of a frame.

A configuration names its kind (``"kind": "triangle"``) and the harness
imports ``kinds/<kind>.py`` by that name. A kind gives three functions
(at the end of this file): ``scene_inputs`` (the scene's inputs from the
seed), ``reference_frames`` (the reference's frame, depth and counts of
each sampled frame's inputs) and ``per_frame`` (the least bytes and
operations of a frame, which the rooflines read).

Plain PyTorch on any device; it imports nothing of the port and takes
nothing the port made: from the benchmark's own inputs (meshes, RGBA8
textures, camera, model matrix, the config) it works out again the view and
projection matrices, the vertex stage, the clipping, the triangle set-up,
the raster and the shading. Its formulas are frozen copies of the plain
versions the port's kernels are held to bit for bit (the reference
renderer's semantics, renderer.rs and phong.rs as ``golden/scalar.py``
states them):

- the matrices of matrix_util.rs, each sum of products left to right;
- the Phong vertex stage: clip = proj·(view·model)·(pos, 1), varyings
  normal (as given), world position, uv;
- clipping that keeps the originals and adds an intersection per (vertex
  pair × plane), Z_NEAR tested as ``z >= 0``, a stable sort by the angle
  about the centroid, a fan (renderer.rs:150-266);
- winding repair, not culling; integer edge functions with int32
  wrap-around and the top-left thresholds; |cross| barycentrics at the
  pixel centre; reversed-z depth cleared to 0, the strict (rhw, order)
  maximum, so later triangles win ties (renderer.rs:269-384);
- each draw's texture by the inclusive ``<=`` offsets (phong.rs:364-370);
- the planar Phong sum (phong.rs:133-144), the bilinear RGBA8 sampler with
  the width-clamp quirk and, for an opaque stack, alpha as the weight sum;
  colour packed as ``clip(c · 255, 0, 255)`` truncated, the background
  where nothing covers a pixel.

Where the port rasterizes by bins and tiles, this reference enumerates each
triangle's bounding box in chunks and keeps the per-pixel maximum of a
64-bit key (rhw's bits above the order), which gives the same winner.

``dtype`` is the precision of every floating-point value: float32 is the
configuration's; bfloat16 is the control, which must fail the comparison.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import scenes

EPSILON = 1.0e-5
MAX_POLY = 21  # 18 intersection slots + 3 originals
MAX_FAN = MAX_POLY - 2
TWO_PI = 2.0 * math.pi
LIGHT_POS = (1.2, 1.0, 2.0)
LIGHT_COLOR = (1.0, 1.0, 1.0)
AMBIENT_STRENGTH = 0.1
SPECULAR_STRENGTH = 0.5
CHUNK = 1 << 24  # pixel-triangle candidates a raster chunk holds


# ---------------------------------------------------------------------------
# Matrices and vectors (matrix_util.rs, vector_util.rs)
# ---------------------------------------------------------------------------


def true_div(a, b):
    """Correctly rounded ``a / b`` (a Python number becomes a 0-d tensor:
    CUDA divides by a Python number through its reciprocal)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def true_sqrt(x):
    """Correctly rounded square root (through float64, rounded once)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(v):
    return v / true_sqrt(dot3(v, v)).unsqueeze(-1)


def look_at(eye, at, up):
    """Left-handed look-at view matrix (matrix_util.rs:11-22)."""
    z_axis = normalize(at - eye)
    x_axis = normalize(cross(up, z_axis))
    y_axis = cross(z_axis, x_axis)
    t = -torch.stack([dot3(eye, x_axis), dot3(eye, y_axis), dot3(eye, z_axis)])
    top = torch.cat([torch.stack([x_axis, y_axis, z_axis]), t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=eye.dtype, device=eye.device)
    return torch.cat([top, bottom], dim=0)


def perspective(fovy, aspect, zn, zf, device, dtype=torch.float32):
    """LH, D3D z in [0, 1] perspective (matrix_util.rs:25-35)."""
    fovy, aspect, zn, zf = (torch.as_tensor(x, dtype=dtype, device=device) for x in (fovy, aspect, zn, zf))
    fax = 1.0 / torch.tan(fovy * 0.5)
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    return torch.stack([
        torch.stack([fax / aspect, zero, zero, zero]),
        torch.stack([zero, fax, zero, zero]),
        torch.stack([zero, zero, zf / (zf - zn), -zn * zf / (zf - zn)]),
        torch.stack([zero, zero, one, zero]),
    ])


def rotate(axis, theta):
    """Axis-angle rotation by quaternion expansion (matrix_util.rs:38-67);
    ``axis`` a (3,) tensor, ``theta`` a tensor on its device."""
    axis = normalize(axis)
    q_sin = torch.sin(theta * 0.5)
    w = torch.cos(theta * 0.5)
    x, y, z = axis[0] * q_sin, axis[1] * q_sin, axis[2] * q_sin
    zero = torch.zeros((), dtype=axis.dtype, device=axis.device)
    one = torch.ones((), dtype=axis.dtype, device=axis.device)
    return torch.stack([
        torch.stack([1.0 - 2.0 * y * y - 2.0 * z * z, 2.0 * x * y - 2.0 * w * z, 2.0 * x * z + 2.0 * w * y, zero]),
        torch.stack([2.0 * x * y + 2.0 * w * z, 1.0 - 2.0 * x * x - 2.0 * z * z, 2.0 * y * z - 2.0 * w * x, zero]),
        torch.stack([2.0 * x * z - 2.0 * w * y, 2.0 * y * z + 2.0 * w * x, 1.0 - 2.0 * x * x - 2.0 * y * y, zero]),
        torch.stack([zero, zero, zero, one]),
    ])


def mat_mul4(a, b):
    return ((a[:, 0:1] * b[0:1, :] + a[:, 1:2] * b[1:2, :]) + a[:, 2:3] * b[2:3, :]) + a[:, 3:4] * b[3:4, :]


def mat_vec4(m, p):
    """(4, 4) · four planes → four planes, each a left-to-right chain."""
    return torch.stack([((m[i, 0] * p[0] + m[i, 1] * p[1]) + m[i, 2] * p[2]) + m[i, 3] * p[3] for i in range(4)])


def orbit(eye, at, up, delta_x, delta_y, ratio=0.005):
    """Right-drag orbit around ``at`` (phong.rs:287-298) → (eye, up)."""
    dev, dt = eye.device, eye.dtype
    delta_x = torch.as_tensor(delta_x, dtype=dt, device=dev)
    delta_y = torch.as_tensor(delta_y, dtype=dt, device=dev)
    forward = at - eye
    right = normalize(cross(forward, up))
    rot_h = rotate(up, delta_x * math.pi * ratio)
    rot_v = rotate(right, -delta_y * math.pi * ratio)
    f4 = torch.cat([forward, torch.ones(1, dtype=dt, device=dev)])
    f4 = mat_vec4(rot_h, f4)
    f4 = mat_vec4(rot_v, f4)
    new_forward = f4[:3]
    return at - new_forward, normalize(cross(right, new_forward))


# ---------------------------------------------------------------------------
# Geometry (renderer.rs:96-267)
# ---------------------------------------------------------------------------


def wrap32(x):
    """int64 → the int32 value it equals modulo 2^32 (kept in int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def f32_to_i32(x):
    """Rust ``f32 as i32``: truncate toward zero, saturate, NaN → 0."""
    x = torch.where(torch.isnan(x), 0.0, x.to(torch.float32))
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32).to(torch.int64)


def viewport(nx, ny, width, height):
    sx = (nx + 1.0) * float(width) * 0.5
    sy = (1.0 - ny) * float(height) * 0.5
    return sx, sy, f32_to_i32(sx + 0.5), f32_to_i32(sy + 0.5)


def insides(pos):
    x, y, z, w = pos.unbind(-1)
    return torch.stack([x >= -w, x <= w, y <= w, y >= -w, z >= 0.0, z <= w], dim=-1)


def clip_faces(pos3, ctx3, width, height):
    """The clipped faces' fans: pos3 (K, 3, 4), ctx3 (K, 3, C) → per fan
    slot (K, 19, 3, ...) ndc x, ndc y, sx, sy, six, siy, rhw, ctx, and
    whether the slot holds a triangle (K, 19)."""
    k, dev = pos3.shape[0], pos3.device
    ins = insides(pos3)

    def pairs(x):  # vertex pairs (0, 1), (0, 2), (1, 2)
        return torch.stack([x[:, 0], x[:, 0], x[:, 1]], 1), torch.stack([x[:, 1], x[:, 2], x[:, 2]], 1)

    a, b = pairs(pos3)
    a_ctx, b_ctx = pairs(ctx3)
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    ratios = torch.stack([-(ax + aw) / (bw + bx - ax - aw), (aw - ax) / (aw - bw - ax + bx),
                          (aw - ay) / (aw - bw - ay + by), -(ay + aw) / (bw + by - aw - ay),
                          aw / (aw - bw), (aw - az) / (aw - bw - az + bz)], dim=-1)
    new_pos = a[:, :, None, :] + ratios[..., None] * (b - a)[:, :, None, :]
    new_ctx = a_ctx[:, :, None, :] + (b_ctx - a_ctx)[:, :, None, :] * ratios[..., None]
    ins_a, ins_b = pairs(ins)
    new_valid = (ins_a != ins_b) & (torch.abs(new_pos[..., 3]) > EPSILON)
    c = ctx3.shape[-1]
    cand_pos = torch.cat([new_pos.reshape(k, 18, 4), pos3], dim=1)
    cand_ctx = torch.cat([new_ctx.reshape(k, 18, c), ctx3], dim=1)
    cand_valid = torch.cat([new_valid.reshape(k, 18), torch.ones((k, 3), dtype=torch.bool, device=dev)], dim=1)
    cand_pos = torch.where(cand_valid[..., None], cand_pos, 0.0)
    n = cand_valid.sum(dim=1)
    xy = cand_pos[..., :2] * cand_valid[..., None]
    total = xy[:, 0]
    for i in range(1, MAX_POLY):
        total = total + xy[:, i]
    centroid = total * torch.reciprocal(n.to(pos3.dtype))[:, None]
    d = cand_pos[..., :2] - centroid[:, None, :]
    ang = torch.atan2(d[..., 1].float(), d[..., 0].float()).to(pos3.dtype)
    ang = torch.where(ang < 0.0, ang + TWO_PI, ang)
    key = torch.where(cand_valid, ang.float(), 1.0e9)
    perm = torch.sort(key, dim=1, stable=True).indices
    pos_s = torch.gather(cand_pos, 1, perm[..., None].expand(-1, -1, 4))
    ctx_s = torch.gather(cand_ctx, 1, perm[..., None].expand(-1, -1, c))
    rhw = torch.reciprocal(pos_s[..., 3])
    nx, ny = pos_s[..., 0] * rhw, pos_s[..., 1] * rhw
    sx, sy, six, siy = viewport(nx, ny, width, height)
    t = torch.arange(MAX_FAN, device=dev)[None, :]
    n1 = n[:, None]
    i1 = torch.where(t == n1 - 3, 1, torch.where(t == n1 - 4, 2, n1 - 2 - t))
    i2 = torch.where(t == n1 - 3, 2, torch.where(t == n1 - 4, 3, n1 - 1 - t))
    idx = torch.clamp(torch.stack([torch.zeros_like(i1), i1, i2], dim=-1), 0, MAX_POLY - 1)
    rows = torch.arange(k, device=dev)[:, None, None]
    fan = [plane[rows, idx] for plane in (nx, ny, sx, sy, six, siy, rhw)]
    return (*fan, ctx_s[rows, idx], t < (n1 - 2))


class Triangles:
    """Emitted triangles after set-up: per vertex (3, T) planes ``sx``,
    ``sy`` (float screen), ``ix``, ``iy`` (int64 screen), ``rhw``; ``ctx``
    (3, C, T); ``tl`` (3, T) top-left flags; ``order`` (T,) int64; ``ps``
    (T,) texture ids; and the count of faces that clipped."""

    def __init__(self, sx, sy, ix, iy, rhw, ctx, tl, order, ps, clipped):
        self.sx, self.sy, self.ix, self.iy, self.rhw, self.ctx = sx, sy, ix, iy, rhw, ctx
        self.tl, self.order, self.ps, self.clipped = tl, order, ps, clipped

    @property
    def count(self) -> int:
        return self.order.shape[0]


def phong_vertex(model, view, proj, mesh, dtype):
    """Corners (3, F) planes → clip (3, 4, F) and varyings (3, 8, F):
    normal, world position, uv."""
    mvp = mat_mul4(proj, mat_mul4(view, model))
    clip, ctx = [], []
    for v in range(3):
        pos = mesh["pos"][:, v].to(dtype)
        p = [pos[:, 0], pos[:, 1], pos[:, 2], torch.ones_like(pos[:, 0])]
        clip.append(mat_vec4(mvp, p))
        world = mat_vec4(model, p)[:3]
        ctx.append(torch.cat([mesh["normal"][:, v].to(dtype).T, world, mesh["uv"][:, v].to(dtype).T]))
    return torch.stack(clip), torch.stack(ctx)


def setup(ndc_x, ndc_y, sx, sy, ix, iy, rhw, ctx):
    """Winding repair and the top-left flags on (3, T) planes (ctx (3, C, T))."""
    nz = (ndc_x[1] - ndc_x[0]) * (ndc_y[2] - ndc_y[0]) - (ndc_y[1] - ndc_y[0]) * (ndc_x[2] - ndc_x[0])
    swap = nz > 0.0

    def sw(pl):
        s = swap.view((1, 1, -1) if pl.dim() == 3 else (1, -1))
        return torch.stack([pl[0], torch.where(s[0], pl[2], pl[1]), torch.where(s[0], pl[1], pl[2])])

    sx, sy, ix, iy, rhw, ctx = (sw(p) for p in (sx, sy, ix, iy, rhw, ctx))

    def top_left(a, b):
        return ((iy[a] == iy[b]) & (ix[a] < ix[b])) | (iy[a] > iy[b])

    tl = torch.stack([top_left(0, 1), top_left(1, 2), top_left(2, 0)])
    return sx, sy, ix, iy, rhw, ctx, tl


def geometry(meshes, model, view, proj, width, height, dtype, quirk=True) -> Triangles:
    """Every draw's emitted triangles in submission order, with each draw's
    texture id after the inclusive-offset quirk."""
    parts, counts, clipped, base = [], [], 0, 0
    for d, mesh in enumerate(meshes):
        f = mesh["pos"].shape[0]
        clip, ctx = phong_vertex(model, view, proj, mesh, dtype)  # (3, 4, F), (3, C, F)
        pos3 = clip.permute(2, 0, 1)  # (F, 3, 4)
        w_ok = (clip[:, 3] != 0.0).all(0)
        all_in = insides(pos3).all(-1).all(-1)
        a = w_ok & all_in
        rhw = torch.reciprocal(clip[:, 3][:, a])
        nx, ny = clip[:, 0][:, a] * rhw, clip[:, 1][:, a] * rhw
        sx, sy, ix, iy = viewport(nx, ny, width, height)
        order = base + torch.nonzero(a).flatten() * MAX_FAN
        tris = [(nx, ny, sx, sy, ix, iy, rhw, ctx[:, :, a], order)]
        b = torch.nonzero(w_ok & ~all_in).flatten()
        if b.numel():
            clipped += b.numel()
            fan = clip_faces(pos3[b], ctx.permute(2, 0, 1)[b], width, height)
            ok = fan[-1]
            slots = torch.nonzero(ok)  # (n, 2): face, fan slot, in order
            def pick(x):
                return x[slots[:, 0], slots[:, 1]]
            planes = [pick(x).T for x in fan[:7]]  # (3, n)
            ctx_b = pick(fan[7]).permute(1, 2, 0)  # (3, C, n)
            order_b = base + b[slots[:, 0]] * MAX_FAN + slots[:, 1]
            tris.append((*planes, ctx_b, order_b))
        cat = [torch.cat([t[i] for t in tris], dim=-1) for i in range(9)]
        srt = torch.argsort(cat[8])
        cat = [x[..., srt] for x in cat]
        parts.append(setup(*cat[:8]) + (cat[8],))
        counts.append(cat[8].numel())
        base += f * MAX_FAN
    planes = [torch.cat([p[i] for p in parts], dim=-1) for i in range(8)]
    ps = torch.cat([torch.full((c,), d, dtype=torch.int64, device=model.device) for d, c in enumerate(counts)])
    if quirk and len(meshes) > 1:  # a draw's first triangle takes the earliest draw whose offset equals its index
        offsets = np.cumsum(counts)
        start = 0
        for d, c in enumerate(counts):
            if c:
                ps[start] = int(np.searchsorted(offsets, start, side="left"))
            start += c
    return Triangles(*planes, ps, clipped)


# ---------------------------------------------------------------------------
# Raster (renderer.rs:269-384)
# ---------------------------------------------------------------------------


def edge(ax, ay, bx, by, cx, cy):
    """-(cx - a.x)(b.y - a.y) + (cy - a.y)(b.x - a.x) with int32 wrap-around."""
    return wrap32(wrap32(wrap32(-wrap32(cx - ax)) * wrap32(by - ay)) + wrap32(wrap32(cy - ay) * wrap32(bx - ax)))


def barycentric(tri: Triangles, t, cx, cy):
    """(a, b, c, s) at the centres of pixels (cx, cy) of triangles ``t``."""
    pcx = cx.to(tri.sx.dtype) + 0.5
    pcy = cy.to(tri.sx.dtype) + 0.5
    s0x, s0y = tri.sx[0, t] - pcx, tri.sy[0, t] - pcy
    s1x, s1y = tri.sx[1, t] - pcx, tri.sy[1, t] - pcy
    s2x, s2y = tri.sx[2, t] - pcx, tri.sy[2, t] - pcy
    a = torch.abs(s1x * s2y - s1y * s2x)
    b = torch.abs(s2x * s0y - s2y * s0x)
    c = torch.abs(s0x * s1y - s0y * s1x)
    return a, b, c, a + b + c


def raster(tri: Triangles, width, height):
    """Per pixel the front triangle → (winner (H, W) int64 index into
    ``tri``, -1 where none; depth (H, W) float32, 0 where none)."""
    dev = tri.ix.device
    minx = torch.clamp(tri.ix.amin(0), 0, width)
    maxx = torch.clamp(tri.ix.amax(0), 0, width)
    miny = torch.clamp(tri.iy.amin(0), 0, height)
    maxy = torch.clamp(tri.iy.amax(0), 0, height)
    bw, bh = maxx - minx, maxy - miny
    cand = (bw * bh).cpu().numpy()
    best = torch.full((height * width,), -1, dtype=torch.int64, device=dev)
    ends = np.cumsum(cand)
    lo = 0
    while lo < tri.count:
        hi = max(int(np.searchsorted(ends, (ends[lo - 1] if lo else 0) + CHUNK, side="right")), lo + 1)
        t_ids = torch.arange(lo, hi, device=dev)
        n = torch.as_tensor(cand[lo:hi], device=dev)
        if int(n.sum()):
            t = torch.repeat_interleave(t_ids, n)
            first = torch.cumsum(n, 0) - n
            local = torch.arange(t.numel(), device=dev) - torch.repeat_interleave(first, n)
            cx = minx[t] + local % bw[t]
            cy = miny[t] + local // bw[t]
            cover = torch.ones_like(cx, dtype=torch.bool)
            for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
                thr = 1 - tri.tl[e, t].to(torch.int64)
                cover &= edge(tri.ix[i, t], tri.iy[i, t], tri.ix[j, t], tri.iy[j, t], cx, cy) >= thr
            a, b, c, s = barycentric(tri, t, cx, cy)
            inv_s = true_div(1.0, s)
            rhw = tri.rhw[0, t] * (a * inv_s) + tri.rhw[1, t] * (b * inv_s) + tri.rhw[2, t] * (c * inv_s)
            ok = cover & (s != 0.0) & (rhw >= 0.0)  # NaN fails; rhw >= 0 beats the cleared (0, none)
            bits = (rhw.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
            key = (bits << 32) | tri.order[t]
            pix = cy * width + cx
            best.scatter_reduce_(0, pix[ok], key[ok], reduce="amax")
        lo = hi
    has = best >= 0
    depth = torch.where(has, (best >> 32).to(torch.int32).view(torch.float32), 0.0)
    order_to_index = torch.full((int(tri.order.max()) + 1 if tri.count else 1,), -1, dtype=torch.int64, device=dev)
    order_to_index[tri.order] = torch.arange(tri.count, device=dev)
    winner = torch.where(has, order_to_index[torch.where(has, best & 0xFFFFFFFF, 0)], -1)
    return winner.view(height, width), depth.view(height, width)


# ---------------------------------------------------------------------------
# Shading (phong.rs:114-154; FrameBuffer::sample_2d, renderer.rs:516-538)
# ---------------------------------------------------------------------------


def pack_textures(textures, device):
    """(h, w, 4) uint8 arrays → (T, Hmax, Wmax, 4) uint8 stack, (T, 2)
    dims, and whether every texel is opaque."""
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    q = np.zeros((len(textures), hmax, wmax, 4), np.uint8)
    dims = np.zeros((len(textures), 2), np.int64)
    for i, t in enumerate(textures):
        q[i, : t.shape[0], : t.shape[1]] = t
        dims[i] = t.shape[:2]
    opaque = all(bool((t[..., 3] == 255).all()) for t in textures)
    return torch.from_numpy(q).to(device), torch.from_numpy(dims).to(device), opaque


def texel_taps(stack, dims, ps, u, v):
    """The four taps' flat indices and weights of every sample."""
    t_count, hmax, wmax = stack.shape[:3]
    t = torch.clamp(ps, 0, t_count - 1)
    h_t, w_t = dims[t, 0], dims[t, 1]
    wf, hf = w_t.to(u.dtype), h_t.to(u.dtype)
    x, y = u * wf, v * hf
    x = torch.where(torch.isnan(x), 0.0, x)
    y = torch.where(torch.isnan(y), 0.0, y)
    a, b = x - torch.trunc(x), y - torch.trunc(y)
    y_hi = w_t - 1  # the width-clamp quirk: y clamps to the width
    x1 = torch.clamp(torch.minimum(torch.clamp(torch.trunc(x), min=0.0), wf - 1.0).to(torch.int64), min=0)
    y1 = torch.clamp(torch.minimum(torch.clamp(torch.trunc(y), min=0.0), y_hi.to(u.dtype)).to(torch.int64), min=0)
    # The integer clamps change nothing in float32; in a lower precision
    # (the control) w - 1 may round up to w.
    x1, y1 = torch.minimum(x1, w_t - 1), torch.minimum(y1, y_hi)
    x2 = torch.minimum(x1 + 1, w_t - 1)
    y2 = torch.clamp(torch.minimum(y1 + 1, y_hi), max=hmax - 1)
    y1 = torch.clamp(y1, max=hmax - 1)
    base = t * (hmax * wmax)
    taps = [base + yy * wmax + xx for yy, xx in ((y1, x1), (y1, x2), (y2, x1), (y2, x2))]
    wx1, wx2, wy1, wy2 = 1.0 - a, a, 1.0 - b, b
    return taps, (wx1 * wy1, wx2 * wy1, wx1 * wy2, wx2 * wy2)


def sample(stack, dims, opaque, ps, u, v):
    """Bilinear RGBA8 sample → four channel planes in [0, 1]."""
    taps, (w11, w12, w21, w22) = texel_taps(stack, dims, ps, u, v)
    flat = stack.reshape(-1, 4)
    texel = [flat[i].to(u.dtype) for i in taps]
    zero = torch.zeros_like(w11)

    def accum(ch):
        return (((zero + w11 * texel[0][:, ch]) + w12 * texel[1][:, ch]) + w21 * texel[2][:, ch]) + w22 * texel[3][:, ch]

    rgb = [true_div(accum(ch), 255.0) for ch in range(3)]
    alpha = zero + (((w11 + w12) + w21) + w22) if opaque else true_div(accum(3), 255.0)
    return rgb + [alpha]


def normalize3(x, y, z):
    inv = true_div(1.0, true_sqrt((x * x + y * y) + z * z))
    return x * inv, y * inv, z * inv


def pow32(x):
    for _ in range(5):
        x = x * x
    return x


def phong_light(n, p, view_pos):
    lp, lc = LIGHT_POS, LIGHT_COLOR
    nx, ny, nz = normalize3(n[0], n[1], n[2])
    ldx, ldy, ldz = normalize3(lp[0] - p[0], lp[1] - p[1], lp[2] - p[2])
    diff = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
    vdx, vdy, vdz = normalize3(view_pos[0] - p[0], view_pos[1] - p[1], view_pos[2] - p[2])
    d = -(ldx * nx + ldy * ny + ldz * nz)
    rx, ry, rz = normalize3(2.0 * d * nx + ldx, 2.0 * d * ny + ldy, 2.0 * d * nz + ldz)
    spec = pow32(torch.clamp(vdx * rx + vdy * ry + vdz * rz, min=0.0))
    return [AMBIENT_STRENGTH * lc[ch] + diff * lc[ch] + SPECULAR_STRENGTH * spec * lc[ch] for ch in range(3)]


def interpolate(tri: Triangles, winner, depth):
    """The covered pixels' (flat index, winner, varyings (C, n))."""
    height, width = winner.shape
    pix = torch.nonzero(winner.flatten() >= 0).flatten()
    t = winner.flatten()[pix]
    cy, cx = pix // width, pix % width
    a, b, c, s = barycentric(tri, t, cx, cy)
    inv_s = true_div(1.0, s)
    d = depth.flatten()[pix].to(tri.sx.dtype)
    w_corr = true_div(1.0, torch.where(d != 0.0, d, 1.0))
    c0 = tri.rhw[0, t] * (a * inv_s) * w_corr
    c1 = tri.rhw[1, t] * (b * inv_s) * w_corr
    c2 = tri.rhw[2, t] * (c * inv_s) * w_corr
    ctx = tri.ctx[0][:, t] * c0 + tri.ctx[1][:, t] * c1 + tri.ctx[2][:, t] * c2
    return pix, t, ctx


def shade(tri: Triangles, winner, depth, textures, view_pos, background):
    """The frame (H, W, 4) uint8 of the Phong shader over the covered
    pixels, the background elsewhere; and the touched texels' flat ids."""
    height, width = winner.shape
    stack, dims, opaque = textures
    pix, t, ctx = interpolate(tri, winner, depth)
    ps = tri.ps[t]
    light = phong_light(ctx[0:3], ctx[3:6], view_pos)
    tex = sample(stack, dims, opaque, ps, ctx[6], ctx[7])
    color = [tex[0] * light[0], tex[1] * light[1], tex[2] * light[2], tex[3]]
    q = torch.stack(color).to(torch.float32) * 255.0
    q = torch.clamp(torch.where(torch.isnan(q), 0.0, q), 0.0, 255.0).to(torch.uint8)
    frame = torch.tensor(background, dtype=torch.uint8, device=winner.device).repeat(height * width, 1)
    frame[pix] = q.T
    return frame.view(height, width, 4), pix, ps, ctx


def touched_texels(stack, dims, ps, ctx):
    """Distinct texels the samples of the covered pixels read."""
    taps, _ = texel_taps(stack, dims, ps, ctx[6], ctx[7])
    return int(torch.unique(torch.cat(taps)).numel()) if taps[0].numel() else 0


def camera_matrices(config, eye, at, up, dtype):
    """view and projection of the config's camera at ``eye``."""
    view = look_at(eye.to(dtype), at.to(dtype), up.to(dtype))
    proj = perspective(config["fovy"], config["width"] / config["height"], config["near"], config["far"],
                       eye.device, dtype)
    return view, proj


def render(config, meshes, model, eye, at, up, textures, dtype=torch.float32):
    """One frame of the reference → (frame (H, W, 4) uint8, depth (H, W)
    float32, counts {emitted, covered, clipped, texels})."""
    width, height = config["width"], config["height"]
    view, proj = camera_matrices(config, eye, at, up, dtype)
    tri = geometry(meshes, model.to(dtype), view, proj, width, height, dtype)
    winner, depth = raster(tri, width, height)
    frame, pix, ps, ctx = shade(tri, winner, depth, textures, eye.to(dtype), config["background"])
    counts = {"emitted": tri.count, "covered": int(pix.numel()), "clipped": tri.clipped,
              "texels": touched_texels(textures[0], textures[1], ps, ctx)}
    return frame, depth.to(torch.float32), counts


# ---------------------------------------------------------------------------
# The least work of a frame (the rooflines' numerator)
# ---------------------------------------------------------------------------
#
# Counted from the scene and the frame as this reference counts them, never
# from any kernel's buffers: whatever kernels implement the frame, the same
# frame reads the same. Bytes: what changes a frame read once, the
# textures' touched texels read once, colour (RGBA8) and depth (float32)
# written once. Operations: a fixed count for each face's vertex stage,
# each emitted triangle's set-up and each covered pixel's raster test,
# interpolation and shading, counted from the expressions above, each add,
# multiply, compare, divide or square root one operation.
#
# - A frame through ``render()`` re-runs the vertex stage, so every face's
#   attributes are read: pos, uv, normal, 32 bytes a corner.
# - A frame through ``render_prepared`` starts from the prepared
#   screen-space triangles at their least size: three vertices of x, y,
#   rhw and the varyings.
# - The raster stage (raster and shade) starts from the screen-space
#   triangles too, in every cell.

ATTR_BYTES_PER_CORNER = (3 + 2 + 3) * 4  # pos, uv, normal float32
PIXEL_OUT_BYTES = 4 + 4  # RGBA8 colour, float32 depth
TEXEL_BYTES = 4  # RGBA8
VARYINGS = {"phong": 8}  # normal 3, world position 3, uv 2
# Vertex stage a corner: clip = MVP·p (4 rows of 4 multiplies, 3 adds) and
# the world position (3 rows of the same): 28 + 21.
OPS_VERTEX_PER_CORNER = 49
# Set-up a triangle: 3 reciprocals, 6 multiplies to NDC, the viewport's 8 a
# vertex (24), the winding's 8, the top-left flags' 6.
OPS_SETUP_PER_TRIANGLE = 3 + 6 + 24 + 8 + 6
# A covered pixel: 3 edge functions of 4 and their tests (15), the
# barycentrics (20), 1 / s and rhw (9), the merge's compare; the
# perspective weights (7) and 8 varyings of 5 (40); the Phong sum (four
# normalizations of 10, the differences, dots, reflection and 5 squarings:
# 75); the bilinear sample (coordinates, fracts, clamps and weights 21, four
# channels of 8 adds and multiplies and a divide: 36); the product with the
# light and the pack (15).
OPS_PER_COVERED_PIXEL = 15 + 20 + 9 + 1 + 7 + 40 + 75 + 21 + 36 + 15


def screen_triangle_bytes(shader: str) -> int:
    return 3 * (3 + VARYINGS[shader]) * 4


# ---------------------------------------------------------------------------
# The kind's functions, which the harness calls
# ---------------------------------------------------------------------------


def scene_inputs(config, seed, traffic) -> scenes.SceneInputs:
    """The config's meshes from ``seed``, one texture stack or the
    traffic's ``stacks``, and the start of its ``turn_steps`` schedule."""
    return scenes.scene_inputs(config, seed, stacks=traffic.get("stacks", 1),
                               turn_steps=traffic.get("turn_steps", 1))


def reference_frames(config, inputs, cases, device, dtype=torch.float32):
    """The reference's (frame, depth, counts) of each case {k: inputs}:
    the model, eye, at, up and texture stack of a sampled frame."""
    meshes = [{k: torch.as_tensor(v, device=device) for k, v in m.items()} for m in inputs.meshes]
    stacks = {}
    out = {}
    for k, case in cases.items():
        s = case["stack"]
        if s not in stacks:
            stacks[s] = pack_textures(inputs.stacks[s], device)
        eye, at, up = (torch.as_tensor(case[n], dtype=torch.float32, device=device) for n in ("eye", "at", "up"))
        out[k] = render(config, meshes, case["model"], eye, at, up, stacks[s], dtype)
    return out


def per_frame(config, traffic, inputs, counts) -> dict:
    """The least bytes and operations of a frame and of its raster stage,
    from the reference's counts a frame (emitted triangles, covered pixels,
    touched texels)."""
    faces = sum(m["pos"].shape[0] for m in inputs.meshes)
    pixels = config["width"] * config["height"]
    tri_bytes = counts["emitted"] * screen_triangle_bytes(config["shader"])
    out_bytes = pixels * PIXEL_OUT_BYTES + counts["texels"] * TEXEL_BYTES
    pixel_ops = counts["covered"] * OPS_PER_COVERED_PIXEL
    if traffic["entry"] == "render_prepared":
        frame_bytes, frame_ops = tri_bytes + out_bytes, pixel_ops
    else:
        frame_bytes = faces * 3 * ATTR_BYTES_PER_CORNER + out_bytes
        frame_ops = faces * 3 * OPS_VERTEX_PER_CORNER + counts["emitted"] * OPS_SETUP_PER_TRIANGLE + pixel_ops
    return {"frame_bytes": frame_bytes, "frame_ops": frame_ops,
            "raster_bytes": tri_bytes + out_bytes, "raster_ops": pixel_ops}
