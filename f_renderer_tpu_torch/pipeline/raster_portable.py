"""Portable tile rasterizer (port of ``f_renderer_tpu/pipeline/raster_jnp.py``).

The reference's sequential per-triangle depth loop (renderer.rs:362-366)
keeps, at each pixel, the lexicographic maximum of (rhw, submission order)
over the triangles that cover it, so rasterization is a per-pixel reduction
that any order of the triangles gives exactly. This module computes it the
JAX module's way: every valid slot against every pixel of the (sub)frame,
with no binning, no setup packing and no kernel. It is the port's oracle
that does not depend on ``bin_pairs``; it does not need to be fast.

Per pixel, as the JAX module:

- the bbox from ``spi`` clamped to the full frame, exclusive upper bounds
  (renderer.rs:285-298, 322-324);
- integer edge functions on the rounded coords with int32 wrap-around
  (renderer.rs:329-331), computed in int64 and reduced modulo 2^32 after
  every operation, with the top-left thresholds ``E >= (top_left ? 0 : 1)``
  (renderer.rs:333-341);
- |cross| barycentrics at the pixel centre from ``spf``, with the ``s != 0``
  guard (renderer.rs:343-354);
- the strict (rhw, order) merge from (0.0, ORDER_NONE) (renderer.rs:360-366).

The frame is cut into tiles, and the triangles into chunks, so memory stays
bounded by one tile times one chunk (the JAX module's ``vmap`` over tiles
times ``fori_loop`` over triangles). Each chunk is reduced to its own
lexicographic maximum per pixel and folded into the tile's: the maximum does
not depend on the order of the folds.
"""

from __future__ import annotations

import torch

from f_renderer_tpu_torch.math.transforms import true_div
from f_renderer_tpu_torch.pipeline.raster import ORDER_NONE, _w, cdiv
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer

# Pixel-triangle tests per chunk step (one tile times one chunk of triangles).
CHUNK_ELEMS = 1 << 21


def _edge(ax, ay, bx, by, cx, cy):
    """-(cx - a.x)(b.y - a.y) + (cy - a.y)(b.x - a.x), wrapped int32."""
    p1 = _w(_w(-_w(cx - ax)) * _w(by - ay))
    p2 = _w(_w(cy - ay) * _w(bx - ax))
    return _w(p1 + p2)


def _chunk_max(tri: TriangleBuffer, ids, bbox, cx, cy):
    """The (rhw, order) maximum per pixel over the slots ``ids`` at pixels
    (cx (1, tw), cy (th, 1)) → (rhw max, its order, its slot), with
    (-inf, ORDER_NONE, -1) where none of them is accepted."""
    col = (slice(None), None, None)
    sx = tri.spi[:, 0][:, ids].long()  # (3, P)
    sy = tri.spi[:, 1][:, ids].long()
    min_x, max_x, min_y, max_y = (b[ids][col] for b in bbox)
    in_bbox = (cx >= min_x) & (cx < max_x) & (cy >= min_y) & (cy < max_y)
    x = [sx[v][col] for v in range(3)]
    y = [sy[v][col] for v in range(3)]
    thr = 1 - tri.top_left[:, ids].long()  # (3, P): 0 where top-left, else 1
    cover = in_bbox
    for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        cover = cover & (_edge(x[i], y[i], x[j], y[j], cx, cy) >= thr[e][col])
    pcx = cx.to(torch.float32) + 0.5
    pcy = cy.to(torch.float32) + 0.5
    f = tri.spf[:, :, ids]  # (3, 2, P)
    s0x, s0y = f[0, 0][col] - pcx, f[0, 1][col] - pcy
    s1x, s1y = f[1, 0][col] - pcx, f[1, 1][col] - pcy
    s2x, s2y = f[2, 0][col] - pcx, f[2, 1][col] - pcy
    a = torch.abs(s1x * s2y - s1y * s2x)
    b = torch.abs(s2x * s0y - s2y * s0x)
    c = torch.abs(s0x * s1y - s0y * s1x)
    s = a + b + c
    inv_s = true_div(1.0, s)
    r = tri.rhw[:, ids]
    rhw = r[0][col] * (a * inv_s) + r[1][col] * (b * inv_s) + r[2][col] * (c * inv_s)
    # A NaN rhw fails both comparisons of the merge: never accepted.
    ok = cover & (s != 0.0) & ~torch.isnan(rhw)
    m1 = torch.where(ok, rhw, float("-inf")).amax(0)
    order = tri.order[ids].long()[col]
    tie = ok & (rhw == m1)
    m2 = torch.where(tie, order, ORDER_NONE).amax(0)
    arg = (tie & (order == m2)).to(torch.uint8).argmax(0)
    return m1, m2, ids[arg]


def rasterize_portable(
    tri: TriangleBuffer,
    width: int,
    height: int,
    *,
    tile: tuple = (64, 128),
    origin: tuple = (0, 0),
    full_size: tuple | None = None,
):
    """Rasterize to per-pixel ``(winner (H, W) int32, depth (H, W) f32)``:
    the TriangleBuffer slot id of each pixel's front triangle (-1 where none
    covers it) and its rhw (0.0 where none does).

    ``origin=(y0, x0)`` renders the sub-rectangle [y0, y0 + height) ×
    [x0, x0 + width) of a ``full_size=(H_full, W_full)`` frame, with bboxes
    clamped to the full frame (renderer.rs:269-298).
    """
    th, tw = tile
    y0, x0 = origin
    fh, fw = full_size if full_size is not None else (height, width)
    dev = tri.spi.device
    sx, sy = tri.spi[:, 0].long(), tri.spi[:, 1].long()
    bbox = (
        torch.clamp(sx.amin(0), 0, fw), torch.clamp(sx.amax(0), 0, fw),
        torch.clamp(sy.amin(0), 0, fh), torch.clamp(sy.amax(0), 0, fh),
    )
    ids = torch.nonzero(tri.valid).flatten()
    chunk = max(CHUNK_ELEMS // (th * tw), 1)
    nty, ntx = cdiv(height, th), cdiv(width, tw)
    depth = torch.zeros((nty * th, ntx * tw), dtype=torch.float32, device=dev)
    winner = torch.full((nty * th, ntx * tw), -1, dtype=torch.int32, device=dev)
    for ty in range(nty):
        cy = y0 + ty * th + torch.arange(th, device=dev)[:, None]
        for tx in range(ntx):
            cx = x0 + tx * tw + torch.arange(tw, device=dev)[None, :]
            d = torch.zeros((th, tw), dtype=torch.float32, device=dev)
            o = torch.full((th, tw), ORDER_NONE, dtype=torch.int64, device=dev)
            win = torch.full((th, tw), -1, dtype=torch.int64, device=dev)
            for c0 in range(0, ids.numel(), chunk):
                m1, m2, arg = _chunk_max(tri, ids[c0 : c0 + chunk], bbox, cx, cy)
                take = (m1 > d) | ((m1 == d) & (m2 > o))
                d = torch.where(take, m1, d)
                o = torch.where(take, m2, o)
                win = torch.where(take, arg, win)
            depth[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw] = d
            winner[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw] = win.to(torch.int32)
    return winner[:height, :width], depth[:height, :width]
