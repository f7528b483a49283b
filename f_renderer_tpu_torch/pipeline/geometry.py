"""Batched geometry stage (reference: renderer.rs:96-267).

Port of ``f_renderer_tpu/pipeline/geometry.py``, with the same two paths:

- The vertex shader runs once over all 3F face corners.
- Path A: faces fully inside the frustum emit one triangle each, with no
  clipping and no sort.
- Path B: the other faces (with nonzero w) are compacted into ``clip_cap``
  slots (a fixed-size compaction; skipped where nothing clips, by a host
  sync eagerly and by a conditional graph node in a captured frame:
  :func:`clip_or_skip`) and clipped with the reference's exact, quirky
  semantics —
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

from f_renderer_tpu_torch.device import capturing, if_node, in_graph_frame
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

    def pairs(x):  # vertex pairs (0, 1), (0, 2), (1, 2) on axis 1; a list index would be host data
        return torch.stack([x[:, 0], x[:, 0], x[:, 1]], 1), torch.stack([x[:, 1], x[:, 2], x[:, 2]], 1)

    a_pos, b_pos = pairs(pos3)  # (K, 3, 4)
    a_ctx, b_ctx = pairs(ctx3)
    ratios = _ratios(a_pos, b_pos)  # (K, 3, 6)
    new_pos = a_pos[:, :, None, :] + ratios[..., None] * (b_pos - a_pos)[:, :, None, :]
    new_ctx = a_ctx[:, :, None, :] + (b_ctx - a_ctx)[:, :, None, :] * ratios[..., None]
    ins_a, ins_b = pairs(ins)
    differ = ins_a != ins_b
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


def compact_clipped(b_mask, clip_cap: int):
    """The first ``clip_cap`` indices where ``b_mask`` is set, in index order,
    padded with ``F`` = ``b_mask.shape[0]`` → (clip_cap,) int64: a cumsum
    and a scatter, with no host sync (``jnp.nonzero(b_mask, size=clip_cap,
    fill_value=F)``, geometry.py:356 of the JAX package)."""
    f = b_mask.shape[0]
    rank = torch.cumsum(b_mask, 0) - 1
    # faces past the cap, and faces not clipped, land in a dump slot
    slot = torch.where(b_mask & (rank < clip_cap), rank, clip_cap)
    sel = torch.full((clip_cap + 1,), f, dtype=torch.int64, device=b_mask.device)
    sel.scatter_(0, slot, torch.arange(f, device=b_mask.device))
    return sel[:clip_cap]


def _clip_path(clip, ctx_a, b_mask, clip_cap, order_base, width, height):
    """Path B of :func:`geometry_process` (run_clip_path, geometry.py:355-387
    of the JAX package): the compacted faces clipped into fan slots →
    (ndc, spf, spi, rhw, ctx, tri_valid, order), each (clip_cap, MAX_FAN, ...).
    ``clip`` (4, 3F) and ``ctx_a`` (C, 3F) are the corner planes, F > 0."""
    f = b_mask.shape[0]
    sel = compact_clipped(b_mask, clip_cap)
    # Padding slots (sel == f) gather face f-1 as the JAX package's clamped
    # gather does; their fan slots are masked below.
    g = torch.clamp(sel, max=f - 1)
    b_pos = torch.stack([torch.stack([clip[j][v * f : (v + 1) * f][g] for j in range(4)], -1) for v in range(3)], 1)
    b_ctx = torch.stack([ctx_a[:, v * f : (v + 1) * f][:, g].T for v in range(3)], 1)
    ndc, spf, spi, rhw, ctx_s, tri_valid = _clip_faces(b_pos, b_ctx, width, height)
    order_b = (
        order_base
        + sel[:, None].to(torch.int32) * MAX_FAN
        + torch.arange(MAX_FAN, dtype=torch.int32, device=b_mask.device)[None, :]
    )
    return ndc, spf, spi, rhw, ctx_s, tri_valid & (sel < f)[:, None], order_b


def clip_path_into(outs, clip, ctx_a, b_mask, clip_cap, order_base, width, height):
    """The body of the conditional node of a captured frame: :func:`_clip_path`
    written into ``outs``, the skip path's tensors (:func:`_skip_clip_path`)."""
    for dst, src in zip(outs, _clip_path(clip, ctx_a, b_mask, clip_cap, order_base, width, height)):
        dst.copy_(src)


def _skip_clip_path(clip_cap, c, order_base, dev):
    """What path B gives when no face clips (skip_clip_path, geometry.py:389-
    400 of the JAX package): zeros, no valid slot, orders ``order_base``."""
    z = (clip_cap, MAX_FAN)
    return (
        torch.zeros(z + (3, 2), device=dev),
        torch.zeros(z + (3, 2), device=dev),
        torch.zeros(z + (3, 2), dtype=torch.int32, device=dev),
        torch.zeros(z + (3,), device=dev),
        torch.zeros(z + (3, c), device=dev),
        torch.zeros(z, dtype=torch.bool, device=dev),
        torch.full(z, order_base, dtype=torch.int32, device=dev),
    )


def clip_or_skip(clip, ctx_a, b_mask, num_clipped, clip_cap, order_base, width, height):
    """Path B: the clip path where a face clipped, else the skip path — the
    JAX package's ``lax.cond`` (geometry.py:350-404 there), three ways:

    - captured on the card: the skip path is written on every replay, and a
      conditional node (``device.if_node``) overwrites it with the clip path
      where a face clipped, so a frame never sees an earlier frame's slots;
    - run as a captured frame outside a capture (``device.graph_frame``: the
      graph's warm-up frame, the CPU): no host sync, the clip path runs and
      the skip path's values are chosen on the device;
    - eagerly: the host asks, and skips the clip path where nothing clips.
    """
    dev, c = clip.device, ctx_a.shape[0]
    if capturing(dev):
        outs = _skip_clip_path(clip_cap, c, order_base, dev)
        if_node(num_clipped > 0, clip_path_into, outs, clip, ctx_a, b_mask, clip_cap, order_base, width, height)
        return outs
    if in_graph_frame():
        ran = _clip_path(clip, ctx_a, b_mask, clip_cap, order_base, width, height)
        skip = _skip_clip_path(clip_cap, c, order_base, dev)
        return [torch.where(num_clipped > 0, r, s) for r, s in zip(ran, skip)]
    if int(num_clipped) > 0:  # host sync
        return _clip_path(clip, ctx_a, b_mask, clip_cap, order_base, width, height)
    return _skip_clip_path(clip_cap, c, order_base, dev)


def vertex_stage(vs_inputs: dict, vertex_shader, vs_uniform):
    """The vertex shader over a draw's 3F face corners (corner v of face i
    at v · F + i) → (F, clip (4, 3F), ctx (C, 3F) channel planes)."""
    f = next(iter(vs_inputs.values())).shape[0]
    corners = {
        k: torch.cat([v[:, i] for i in range(3)]).to(torch.float32)
        for k, v in vs_inputs.items()
    }
    clip, ctx_dict = vertex_shader(vs_uniform, corners)  # (4, 3F), {k: (3F, ·)}
    return f, clip, ContextCodec.of(ctx_dict).flatten(ctx_dict)


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
    dev = next(iter(vs_inputs.values())).device
    f, clip, ctx_a = vertex_stage(vs_inputs, vertex_shader, vs_uniform)
    c = ctx_a.shape[0]

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
    if f > 0:
        path_b = clip_or_skip(clip, ctx_a, b_mask, num_clipped, clip_cap, order_base, width, height)
    else:
        path_b = _skip_clip_path(clip_cap, c, order_base, dev)
    ndc, spf, spi, rhw, ctx_s, tri_valid, order_b = path_b

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


def fan_views(words, clip_cap: int, c: int):
    """One draw's fan words (clip_cap · MAX_FAN · (23 + 3C),) int32, the
    layout the set-up kernels read (csrc/tri_setup.cu) → views shaped as
    :func:`_clip_path`'s seven outputs, one after the other, slot-major:
    ndc, spf (float bits), spi, rhw, ctx (float bits), valid, order."""
    fields = (((3, 2), True), ((3, 2), True), ((3, 2), False), ((3,), True), ((3, c), True), ((), False),
              ((), False))
    out, at = [], 0
    for shape, is_float in fields:
        n = clip_cap * MAX_FAN * math.prod(shape)
        block = words[at:at + n]
        at += n
        out.append((block.view(torch.float32) if is_float else block).view((clip_cap, MAX_FAN) + shape))
    return out


def packed_geometry(draws, vertex_shader, vs_uniform, width: int, height: int, *, clip_cap: int, cull: bool,
                    quirk: bool):
    """Every draw's geometry and pack on the card, through the triangle
    set-up kernels (csrc/tri_setup.cu; ``kernels.tri_setup``) → (recs (m_pad,
    rec) int32, bbox (2, m_pad) int32, slots m, C, faces clipped 0-d int32):
    the records (``raster.slot_records``) and bbox rows of what
    ``raster.pack_binned`` makes of ``render.build_triangles``' buffer, bit
    for bit. Launch 1 runs over every slot (a builtin's vertex stage where
    the vertex shader is tagged ``fused_kind``, else the vertex shader per
    draw in PyTorch first): the masks, the path-A slots, the skip path's
    path-B slots, the padding, and, where no face clipped, the ps boundary
    quirk (where ``quirk``). Where a face clipped, the clip path runs
    (:func:`clip_path_into` for each draw, then ``kernels.tri_setup_slots``:
    the path-B slots of the draws that clipped, the quirk) — the JAX
    package's ``lax.cond``, one for the frame, three ways:

    - captured on the card: a conditional node whose condition launch 1's
      last block sets (``kernels.condition``, ``device.if_node``), so a
      replay that clips nothing runs launch 1 alone;
    - a captured frame outside a capture (the graph's warm-up frame): the
      clip path runs (no host sync); it leaves a frame that clipped nothing
      as launch 1 wrote it;
    - eagerly: the host asks, and runs the clip path of the draws that
      clipped where one did.
    """
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.shaders.builtin import vertex_layout

    n_draws, dev = len(draws), next(iter(draws[0].values())).device
    kind = getattr(vertex_shader, "fused_kind", None)
    if kind is None:
        stages = [vertex_stage(d, vertex_shader, vs_uniform) for d in draws]
        faces, widths = [s[0] for s in stages], [s[2].shape[0] for s in stages]
    else:
        faces = [next(iter(d.values())).shape[0] for d in draws]
        widths = [sum(w for _, w in vertex_layout(vertex_shader, d)) for d in draws]
    c = widths[0]
    if any(w != c for w in widths):
        raise ValueError("every draw's vertex shader must emit the same varyings")
    nb = clip_cap * MAX_FAN
    face_off = [sum(faces[:d]) for d in range(n_draws)]
    slot_base = [f0 + d * nb for d, f0 in enumerate(face_off)]
    order_base = [f0 * MAX_FAN for f0 in face_off]
    m = sum(faces) + n_draws * nb
    m_pad = -(-(m + 1) // 128) * 128  # raster.pack_binned's columns
    table = tuple(face_off + faces + slot_base + order_base)  # the launches' parameters
    shape = dict(n_draws=n_draws, nb=nb, m=m, width=width, height=height, cull=cull, quirk=quirk)
    if kind is None:
        clip = torch.cat([s[1] for s in stages], 1) if n_draws > 1 else stages[0][1]
        ctx = torch.cat([s[2] for s in stages], 1) if n_draws > 1 else stages[0][2]
        clip, ctx, vertex = clip.to(torch.float32).contiguous(), ctx.contiguous(), None
    else:  # the kernel writes the entries of these that the clip path reads
        clip = torch.empty((4, 3 * sum(faces)), device=dev)
        ctx = torch.empty((c, 3 * sum(faces)), device=dev)
        vertex = kernels.VertexStage(kind, vs_uniform, list(draws), getattr(vertex_shader, "light_pos", (0.0,) * 3),
                                     getattr(vertex_shader, "light_color", (0.0,) * 3))
    cond = kernels.condition(dev) if capturing(dev) else None
    recs, bbox, b_mask, acc = kernels.tri_setup(table, clip, ctx, m_pad=m_pad, vertex=vertex, cond=cond, **shape)
    num_clipped, total = kernels.acc_views(acc, n_draws)
    fan = torch.empty((n_draws, nb * (23 + 3 * c)), dtype=torch.int32, device=dev)

    def clip_path(which):
        """The clip path of the draws ``which``, into their fan words, then
        the path-B slots of those that clipped a face and the quirk."""
        for d in which:
            o, f = face_off[d], faces[d]
            clip_path_into(fan_views(fan[d], clip_cap, c), clip[:, 3 * o:3 * (o + f)], ctx[:, 3 * o:3 * (o + f)],
                           b_mask[o:o + f], clip_cap, order_base[d], width, height)
        kernels.tri_setup_slots(table, fan, recs, bbox, acc, n_ctx=c, **shape)

    with_faces = [d for d in range(n_draws) if faces[d] > 0]
    if cond is not None:
        if_node(cond, clip_path, with_faces)
    elif in_graph_frame():
        clip_path(with_faces)
    else:
        clipped = [d for d, n in enumerate(num_clipped.tolist()) if n > 0]  # a host sync
        if clipped:
            clip_path(clipped)
    return recs, bbox, m, c, total
