"""Binned rasterization: setup, binning, and the raster without shading.

Port of ``f_renderer_tpu/pipeline/raster_pallas.py``: the field-row layout,
``pack_setup`` and ``bin_pairs`` (:47-91, :178-269, :316-436), XLA ops on
the TPU and here the plain versions of the set-up and binning kernels
(csrc/tri_setup.cu, csrc/bin_pairs.cu: :func:`bin_packed` launches the
latter on CUDA tensors), and the two entry points of its non-fused raster
kernel (K4),
:func:`rasterize` (``rasterize_pallas :1583``) and :func:`rasterize_interp`
(``rasterize_interp_pallas :1617``).

Both kernels that rasterize, the fused one (K1, ``pipeline/fused.py``) and
K4, read the same prep (:func:`prep_binned`: pack, bin, pair-order gather)
and run the same per-tile loop (``csrc/raster_loop.cuh``); their plain
versions share :func:`raster_tiles_plain` and :func:`interpolate_plain`.
K4 replaces the TPU kernel's chunk scan (``compact_sort``, ``chunk_bounds``,
DMA semaphores) with these exact per-tile pair lists; the per-pixel merge is
order-free, so the winners are the same.

Integer arithmetic follows the JAX package's wrapped int32 semantics
(Rust release-mode overflow, renderer.rs:329-331): the affine edge
coefficients are computed in int64 and reduced modulo 2^32 after every
product and sum, which gives the wrapped int32 result exactly with no
overflow in between.
"""

from __future__ import annotations

import dataclasses

import torch

from f_renderer_tpu_torch.math.transforms import true_div
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer

ORDER_NONE = -2147483648

# tri_i32 rows. Edge functions in affine form e(cx, cy) = A·cx + B·cy + C,
# e01 from A01/B01/C01 and e20 from A20/B20/C20; e12 = AREA2 − e01 − e20
# (2·signed area = e01 + e12 + e20, exact under wrap). The fill-rule
# thresholds are folded into C01, C20 and AREA2, so the cover test is
# against zero.
A01, B01, C01, A20, B20, C20 = range(6)
AREA2 = 6
ORDER = 7
MINXY = 8  # min_x | (min_y << 16), bbox clamped to the frame
MAXXY = 9  # max_x | (max_y << 16), exclusive
SLOT = 10  # TriangleBuffer slot id (the winner id)
PS = 11  # bits 0..7: ps_index
PS_MASK = 0xFF
NF_I = 12

# tri_f32 rows: float screen coords, 1/w, then 3·C varyings vertex-major.
S0X, S0Y, S1X, S1Y, S2X, S2Y = range(6)
RHW0, RHW1, RHW2 = 6, 7, 8
CTX0 = 9

COARSE = 4  # coarse tile = COARSE×COARSE fine tiles (hierarchical binning)
LANES = 128  # bin tile width


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _w(x):
    """int64 → the int32 value it equals modulo 2^32 (kept in int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def unpack_xy(v):
    """(x | y << 16) → (x, y); exact for clamped non-negative halves."""
    return v & 0xFFFF, v >> 16


def pack_setup(tri: TriangleBuffer, width: int, height: int, m_pad: int):
    """Pack a TriangleBuffer into field-major (NF_I, m_pad) int32 and
    (9 + 3C, m_pad) float32 arrays.

    Invalid slots (and padding) get an empty bbox (min = max = 0), so no
    pixel can pass their cover test.
    """
    if not (0 < width < 32768 and 0 < height < 32768):
        raise ValueError(f"frame {width}x{height}: the packed bbox needs < 32768")
    m = tri.num_slots
    sx = tri.spi[:, 0].long()  # (3, M)
    sy = tri.spi[:, 1].long()
    valid = tri.valid
    zero = torch.zeros_like(sx[0])
    min_x = torch.where(valid, torch.clamp(sx.amin(0), 0, width), zero)
    max_x = torch.where(valid, torch.clamp(sx.amax(0), 0, width), zero)
    min_y = torch.where(valid, torch.clamp(sy.amin(0), 0, height), zero)
    max_y = torch.where(valid, torch.clamp(sy.amax(0), 0, height), zero)
    dy01 = _w(sy[1] - sy[0])
    dx01 = _w(sx[1] - sx[0])
    dy20 = _w(sy[0] - sy[2])
    dx20 = _w(sx[0] - sx[2])
    area2 = _w(_w(dx01 * _w(sy[2] - sy[0])) - _w(dy01 * _w(sx[2] - sx[0])))
    c01 = _w(_w(sx[0] * dy01) - _w(sy[0] * dx01))
    c20 = _w(_w(sx[2] * dy20) - _w(sy[2] * dx20))
    thr = 1 - tri.top_left.long()  # (3, M): edge threshold 0 (top-left) or 1
    c01 = _w(c01 - thr[0])
    c20 = _w(c20 - thr[2])
    area2 = _w(area2 - (thr[0] + thr[1] + thr[2]))
    rows_i = torch.stack(
        [
            _w(-dy01), dx01, c01,
            _w(-dy20), dx20, c20,
            area2,
            tri.order.long(),
            min_x | (min_y << 16),
            max_x | (max_y << 16),
            torch.arange(m, device=sx.device),
            tri.ps_index.long(),
        ]
    )
    rows_f = torch.cat(
        [tri.spf.reshape(6, m), tri.rhw, tri.ctx]
    )  # spf (3, 2, M) flattens to S0X, S0Y, S1X, ... in row order
    tri_i32 = torch.zeros((NF_I, m_pad), dtype=torch.int32, device=sx.device)
    tri_i32[:, :m] = rows_i.to(torch.int32)
    tri_f32 = torch.zeros((rows_f.shape[0], m_pad), dtype=torch.float32, device=sx.device)
    tri_f32[:, :m] = rows_f
    return tri_i32, tri_f32


def bin_pairs(tri_i32, tile, grid_hw, k: int, chunk: int, m_dummy: int, kc: int = 6, origin=(0, 0)):
    """Hierarchical per-tile triangle lists via (tile, triangle) pair expansion.

    Each triangle lands in exactly one level: a span of ≤ ``k`` fine tiles
    gives one pair per covered fine tile; else a span of ≤ ``kc`` coarse
    tiles (COARSE×COARSE fine tiles each) one pair per covered coarse tile;
    else one pair in the shared spill bucket that every tile scans.

    Returns ``(pair_tri (Npad,) int32, off (ntiles + ntilesc + 2,) int32)``:
    ``off[t]..off[t+1]`` is fine tile t's pair range, ``off[ntiles + c]..``
    coarse tile c's, and the last pair of entries the spill range. Padding
    pairs point at ``m_dummy``, an empty-bbox slot. ``origin=(y0, x0)``: the
    full-frame pixel of the grid's top-left corner; the bboxes, clamped to
    the full frame by :func:`pack_setup`, are shifted by it before they are
    clamped to the grid (raster_pallas.py:360-366).
    """
    th, tw = tile
    y_org, x_org = origin
    nty, ntx = grid_hw
    ntiles = nty * ntx
    ntxc = cdiv(ntx, COARSE)
    ntilesc = cdiv(nty, COARSE) * ntxc
    big = ntiles + ntilesc + 1
    bminx, bminy = unpack_xy(tri_i32[MINXY])
    bmaxx, bmaxy = unpack_xy(tri_i32[MAXXY])
    minx = torch.clamp(bminx - x_org, 0, ntx * tw)
    maxx = torch.clamp(bmaxx - x_org, 0, ntx * tw)
    miny = torch.clamp(bminy - y_org, 0, nty * th)
    maxy = torch.clamp(bmaxy - y_org, 0, nty * th)
    nonempty = (maxx > minx) & (maxy > miny)
    tx0 = minx // tw
    tx1 = torch.maximum(maxx - 1, minx) // tw
    ty0 = miny // th
    ty1 = torch.maximum(maxy - 1, miny) // th
    ncols = tx1 - tx0 + 1
    span = ncols * (ty1 - ty0 + 1)
    small = nonempty & (span <= k)
    ctx0, ctx1 = tx0 // COARSE, tx1 // COARSE
    cty0, cty1 = ty0 // COARSE, ty1 // COARSE
    ncolsc = ctx1 - ctx0 + 1
    cspan = ncolsc * (cty1 - cty0 + 1)
    mid = nonempty & ~small & (cspan <= kc)
    spill = nonempty & ~small & ~mid

    m = tri_i32.shape[1]
    # The levels are exclusive per triangle, so they share max(k, kc) key
    # slots per triangle (spill uses slot 0).
    nk = max(k, kc)
    keys = []
    for j in range(nk):
        fine = (ty0 + j // ncols) * ntx + (tx0 + j % ncols)
        coarse = ntiles + (cty0 + j // ncolsc) * ntxc + (ctx0 + j % ncolsc)
        kj = torch.full_like(minx, big)
        if j == 0:
            kj = torch.where(spill, ntiles + ntilesc, kj)
        if j < kc:
            kj = torch.where(mid & (j < cspan), coarse, kj)
        if j < k:
            kj = torch.where(small & (j < span), fine, kj)
        keys.append(kj)
    key = torch.cat(keys)
    ptri = torch.arange(m, dtype=torch.int32, device=key.device).repeat(nk)
    n_keys = ntiles + ntilesc + 2
    id_bits = max((m - 1).bit_length(), 1)
    if n_keys.bit_length() + id_bits <= 31:
        # (key, tri id) packed into one int32: a single-operand sort. The
        # tri-id tiebreak is harmless — the per-pixel merge is order-free.
        packed = torch.sort((key << id_bits) | ptri).values
        key_s = packed >> id_bits
        ptri_s = packed & ((1 << id_bits) - 1)
    else:
        key_s, perm = torch.sort(key, stable=True)
        ptri_s = ptri[perm]
    off = torch.searchsorted(
        key_s, torch.arange(n_keys, dtype=key_s.dtype, device=key.device)
    ).to(torch.int32)
    n = ptri_s.shape[0]
    n_pad = cdiv(n, chunk) * chunk
    ptri_s = torch.cat(
        [ptri_s, torch.full((n_pad - n,), m_dummy, dtype=torch.int32, device=key.device)]
    )
    pos = torch.arange(n_pad, device=key.device)
    return torch.where(pos < off[ntiles + ntilesc + 1], ptri_s, m_dummy), off


@dataclasses.dataclass(frozen=True)
class BinnedPrep:
    """Products of :func:`prep_binned`: what the raster kernels read."""

    off: torch.Tensor  # (ntiles + ntilesc + 2,) int32 pair-range offsets
    tri_i32: torch.Tensor  # (NF_I, n_pairs) int32, pair order
    tri_f32: torch.Tensor  # (9 + 3C, n_pairs) float32, pair order
    th: int  # bin tile rows (the tile is th × 128)
    n_ctx: int
    height: int  # the rendered rectangle's rows and columns
    width: int
    h_pad: int
    w_pad: int
    # Full-frame (y, x) of the rectangle's top-left pixel: the kernels rasterize
    # full-frame pixels and store them at their place in the rectangle.
    origin: tuple = (0, 0)


def pack_binned(tri: TriangleBuffer, width: int, height: int):
    """Stage 1 of the prep (the JAX package's ``pack_fused``, fused.py:140):
    :func:`pack_setup` with bboxes clamped to the full ``width`` × ``height``
    frame, over ``cdiv(slots + 1, 128) · 128`` columns, so at least one empty
    padding slot follows the real ones. It does not depend on the rendered
    rectangle, so a sharded renderer packs its own slots and gathers these
    arrays along their last (slot) axis."""
    m_pad = cdiv(tri.num_slots + 1, LANES) * LANES
    return pack_setup(tri, width, height, m_pad)


def bin_packed(tri_i32, tri_f32, n_slots: int, n_ctx: int, width: int, height: int, tile=None, **kw) -> BinnedPrep:
    """Stage 2 of the prep (``prep_fused_packed``, fused.py:183): bin and
    gather the packed arrays in pair order for the rectangle ``size=(rows,
    cols)`` (None: the whole ``width`` × ``height`` frame) whose top-left
    pixel is ``origin=(y0, x0)`` of the frame. CUDA tensors launch the
    binning kernels (csrc/bin_pairs.cu, ``kernels.bin_pairs``: a counting
    sort by (key, slot), the packed sort's order); CPU tensors run their
    plain version, :func:`bin_pairs` and two ``index_select``.

    ``tile`` (rows, 128); None picks (32, 128), or (128, 128) for scenes of
    at most 2048 slots; ``tile_auto`` makes tiles at least 64 rows tall above
    ``tile_auto_threshold`` slots. ``bin_k`` caps the fine tiles a triangle
    may span before it goes to the coarse or spill range (None: size
    heuristic). ``n_slots`` drives these heuristics (in a sharded frame, the
    count over every shard). ``m_dummy`` is an empty-bbox column the padding
    pairs point at (None: ``n_slots``, the first padding slot of
    :func:`pack_binned`).

    A rectangle shorter than the tile keeps a tile height the kernels take:
    ``cdiv(rows, th) · th`` rows are rasterized and the caller crops. That is
    exact, because the per-pixel (rhw, order) merge does not depend on the
    tiling.
    """
    kernel = tri_i32.device.type == "cuda"
    return _bin(kernel, tri_i32, tri_f32, n_slots, n_ctx, width, height, tile, **kw)


def bin_packed_plain(tri_i32, tri_f32, n_slots: int, n_ctx: int, width: int, height: int, tile=None,
                     **kw) -> BinnedPrep:
    """The plain version of :func:`bin_packed`'s kernels, on the tensors'
    device: :func:`bin_pairs` (a sort) and two ``index_select``."""
    return _bin(False, tri_i32, tri_f32, n_slots, n_ctx, width, height, tile, **kw)


def _bin(kernel: bool, tri_i32, tri_f32, n_slots: int, n_ctx: int, width: int, height: int, tile=None, *,
         tile_auto: bool = True, tile_auto_threshold: int = 300_000, bin_k: int | None = None, origin=(0, 0),
         size=None, m_dummy: int | None = None) -> BinnedPrep:
    rows, cols = size if size is not None else (height, width)
    th, tw = tile if tile is not None else (32, LANES)
    if tw != LANES:
        raise ValueError(f"binned raster needs tile width {LANES}, got {tw}")
    if tile_auto and n_slots > tile_auto_threshold:
        th = max(th, 64)  # huge scenes: fewer, taller tiles
    elif tile_auto and tile is None and n_slots <= 2048:
        th = 128  # tiny scenes are bound by the tile count, not by pairs
    k = bin_k or (4 if n_slots <= 300_000 else 2)
    h_pad = cdiv(rows, th) * th
    w_pad = cdiv(cols, tw) * tw
    m_dummy = n_slots if m_dummy is None else m_dummy
    if kernel:
        from f_renderer_tpu_torch import kernels

        off, ti, tf = kernels.bin_pairs(
            tri_i32, tri_f32, th=th, grid_hw=(h_pad // th, w_pad // tw), k=k, kc=k, m_dummy=m_dummy,
            n_pad=cdiv(tri_i32.shape[1] * k, LANES) * LANES, origin=origin,
        )
    else:
        ptri, off = bin_pairs(tri_i32, (th, tw), (h_pad // th, w_pad // tw), k, LANES, m_dummy=m_dummy, kc=k,
                              origin=origin)
        ti, tf = tri_i32.index_select(1, ptri), tri_f32.index_select(1, ptri)
    return BinnedPrep(
        off=off,
        tri_i32=ti,
        tri_f32=tf,
        th=th,
        n_ctx=n_ctx,
        height=rows,
        width=cols,
        h_pad=h_pad,
        w_pad=w_pad,
        origin=tuple(int(v) for v in origin),
    )


def prep_binned(
    tri: TriangleBuffer,
    width: int,
    height: int,
    tile=None,
    *,
    tile_auto: bool = True,
    tile_auto_threshold: int = 300_000,
    bin_k: int | None = None,
    origin=(0, 0),
    size=None,
) -> BinnedPrep:
    """Pack + bin + pair-order gather (fused.py:160-350 of the JAX package):
    :func:`pack_binned`, then :func:`bin_packed` with the same settings."""
    tri_i32, tri_f32 = pack_binned(tri, width, height)
    return bin_packed(
        tri_i32, tri_f32, tri.num_slots, tri.num_channels, width, height, tile,
        tile_auto=tile_auto, tile_auto_threshold=tile_auto_threshold, bin_k=bin_k,
        origin=origin, size=size,
    )


def tile_lists(prep: BinnedPrep, ty: int, tx: int) -> tuple[int, int, int]:
    """Fine tile (ty, tx)'s three pair ranges in ``prep.off``: the indices r
    of its fine, coarse and spill ranges, each the pairs off[r]..off[r+1]."""
    nty, ntx = prep.h_pad // prep.th, prep.w_pad // LANES
    ntiles, ntxc = nty * ntx, cdiv(ntx, COARSE)
    spill = ntiles + cdiv(nty, COARSE) * ntxc
    return ty * ntx + tx, ntiles + (ty // COARSE) * ntxc + tx // COARSE, spill


# The raster kernels' tile plan (csrc/raster_loop.cuh: tile_plan_kernel),
# the flags of a tile's descriptor.
TILE_ROWS, TILE_CULLED, TILE_OVERFLOW = 1, 2, 4
# Raster blocks an NVIDIA H100 holds at once (132 SMs, two blocks each): the
# plan pass reads the card's own count.
H100_SLOTS = 264


def blocks_per_tile(th: int) -> int:
    """Thread blocks of the raster kernels to a (th, 128) tile, each of 128 x
    4 threads owning two rows a thread (one at th = 4)."""
    return th // (4 * (1 if th < 8 else 2))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """What the raster kernels' plan pass decides for each tile
    t = ty · ntx + tx (:func:`tile_plan_plain`)."""

    order: list  # the tiles in the order the raster grid takes them
    flags: list  # per tile: TILE_CULLED or TILE_OVERFLOW, | TILE_ROWS
    counts: list  # per tile: its coarse and spill pairs whose bbox meets it
    lists: list  # per tile: the pair columns its blocks stage, in order
    weights: list  # per tile: the pairs of its fine range


def tile_plan_plain(prep: BinnedPrep, cap: int | None = None, slots: int = H100_SLOTS) -> TilePlan:
    """The raster kernels' tile plan, plain (csrc/raster_loop.cuh).

    The cull: a tile keeps the pairs of its coarse and spill ranges whose
    bbox [MINXY, MAXXY) meets its pixels (frame coordinates, ``prep.origin``
    away from the planes'), in list order, after its fine range; where more
    than ``cap`` (None: ``kernels.CULL_CAP``) would be kept, it keeps both
    ranges whole (TILE_OVERFLOW). Exact, since every pixel the cover test
    accepts lies inside its pair's bbox. The layout: rows interleaved
    (TILE_ROWS) for a tile of w > 0 pairs in its fine range with w · n >= 4
    · W and w · slots >= 2 · S · W, W the sum of every tile's w, n the tiles
    with w > 0 and S the blocks a tile; patches elsewhere. The order: the
    tiles of the largest floor(log2(w)) first, in tile order within one."""
    if cap is None:
        from f_renderer_tpu_torch.kernels import CULL_CAP

        cap = CULL_CAP
    dev = prep.tri_i32.device
    th, oy, ox = prep.th, *prep.origin
    nty, ntx = prep.h_pad // th, prep.w_pad // LANES
    off = prep.off.tolist()
    minx, miny = unpack_xy(prep.tri_i32[MINXY].long())
    maxx, maxy = unpack_xy(prep.tri_i32[MAXXY].long())
    flags, counts, lists, weights = [], [], [], []
    for ty in range(nty):
        for tx in range(ntx):
            fine, coarse, spill = (torch.arange(off[r], off[r + 1], device=dev) for r in tile_lists(prep, ty, tx))
            weights.append(fine.numel())
            rest = torch.cat([coarse, spill])
            x0, y0 = ox + tx * LANES, oy + ty * th
            meets = ((minx[rest] < x0 + LANES) & (maxx[rest] > x0) & (miny[rest] < y0 + th) & (maxy[rest] > y0))
            kept = rest[meets]
            counts.append(kept.numel())
            culled = kept.numel() <= cap
            flags.append(TILE_CULLED if culled else TILE_OVERFLOW)
            lists.append(torch.cat([fine, kept if culled else rest]))
    frame, n = sum(weights), sum(w > 0 for w in weights)
    bound = 2 * blocks_per_tile(th) * frame
    flags = [f | (TILE_ROWS if w > 0 and w * n >= 4 * frame and w * slots >= bound else 0)
             for f, w in zip(flags, weights)]
    order = sorted(range(len(weights)), key=lambda t: (-weights[t].bit_length(), t))
    return TilePlan(order=order, flags=flags, counts=counts, lists=lists, weights=weights)


def cover_plain(tri_i32, idx, cx, cy):
    """The cover test of both raster kernels for the pairs ``idx`` at pixels
    (cx, cy) (broadcast) → bool (P, ...): the wrapped int32 edges against 0
    and the exclusive bbox max."""
    i = tri_i32[:, idx].long()[:, :, None, None]  # (12, P, 1, 1)
    e01 = _w(i[A01] * cx + i[B01] * cy + i[C01])
    e20 = _w(i[A20] * cx + i[B20] * cy + i[C20])
    e12 = _w(i[AREA2] - e01 - e20)
    maxx, maxy = unpack_xy(i[MAXXY])
    return (e01 | e12 | e20 | (maxx - 1 - cx) | (maxy - 1 - cy)) >= 0


def _tile_plain(tri_i32, tri_f32, idx, cx, cy):
    """Per-pixel strict (rhw, order) maximum over one tile's pairs ``idx``.

    The sequential merge ``accept = cover & (rhw > d | (rhw >= d & o > o_d))``
    from (0.0, ORDER_NONE) ends at the lexicographic maximum of
    {background} ∪ covered pairs, so it is computed as one (the pairs of a
    tile have distinct orders). Returns (depth, winning pair or -1).
    """
    f = tri_f32[:9, idx][:, :, None, None]
    cover = cover_plain(tri_i32, idx, cx, cy)
    pcx = cx.to(torch.float32) + 0.5
    pcy = cy.to(torch.float32) + 0.5
    s0x, s0y = f[S0X] - pcx, f[S0Y] - pcy
    s1x, s1y = f[S1X] - pcx, f[S1Y] - pcy
    s2x, s2y = f[S2X] - pcx, f[S2Y] - pcy
    a = torch.abs(s1x * s2y - s1y * s2x)
    b = torch.abs(s2x * s0y - s2y * s0x)
    c = torch.abs(s0x * s1y - s0y * s1x)
    s = a + b + c
    inv_s = true_div(1.0, s)
    rhw = f[RHW0] * (a * inv_s) + f[RHW1] * (b * inv_s) + f[RHW2] * (c * inv_s)
    ok = cover & (s != 0.0) & ~torch.isnan(rhw)  # a NaN rhw is never accepted
    m1 = torch.where(ok, rhw, float("-inf")).amax(0)
    order = tri_i32[ORDER, idx].long()[:, None, None]
    tie = ok & (rhw == m1)
    m2 = torch.where(tie, order, ORDER_NONE).amax(0)
    accept = (m1 > 0.0) | ((m1 == 0.0) & (m2 > ORDER_NONE))
    arg = (tie & (order == m2)).to(torch.uint8).argmax(0)
    depth = torch.gather(rhw.expand(-1, *arg.shape), 0, arg[None])[0]
    return torch.where(accept, depth, 0.0), torch.where(accept, idx[arg], -1)


def raster_tiles_plain(prep: BinnedPrep, tiles=None, plan: TilePlan | None = None):
    """The per-tile loop of both raster kernels (``csrc/raster_loop.cuh``),
    plain: each tile's fine, coarse and spill pair ranges merged per pixel
    (with ``plan``, :func:`tile_plan_plain`'s lists instead: the pairs the
    kernels stage). Returns padded (depth f32, winning pair int64 or -1),
    (h_pad, w_pad).

    ``tiles``: the (ty, tx) tiles to raster (None: every tile); the pixels
    of the others stay background (depth 0, pair -1). The pixels are the
    frame's, ``prep.origin`` away from the planes' own."""
    dev = prep.tri_i32.device
    th, tw = prep.th, LANES
    oy, ox = prep.origin
    nty, ntx = prep.h_pad // th, prep.w_pad // tw
    off = prep.off.tolist()
    depth = torch.zeros((prep.h_pad, prep.w_pad), dtype=torch.float32, device=dev)
    wpair = torch.full((prep.h_pad, prep.w_pad), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(th, device=dev)[:, None]
    cols = torch.arange(tw, device=dev)[None, :]
    if tiles is None:
        tiles = [(ty, tx) for ty in range(nty) for tx in range(ntx)]
    for ty, tx in tiles:
        if plan is not None:
            idx = plan.lists[ty * ntx + tx]
        else:
            idx = torch.cat([torch.arange(off[r], off[r + 1], device=dev) for r in tile_lists(prep, ty, tx)])
        if idx.numel() == 0:
            continue
        d, w = _tile_plain(prep.tri_i32, prep.tri_f32, idx, ox + tx * tw + cols, oy + ty * th + rows)
        depth[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw] = d
        wpair[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw] = w
    return depth, wpair


def interpolate_plain(prep: BinnedPrep, depth, wpair):
    """Interpolate the winner's varyings once per pixel, perspective-correct
    (renderer.rs:368-378), with the final depth (raster_pallas.py:1102-1149).

    Returns padded (ctx (C, h_pad, w_pad) f32, winner slot int32, ps int32),
    with ctx 0, winner -1 and ps 0 where no pair won.
    """
    dev = prep.tri_i32.device
    ti, tf = prep.tri_i32, prep.tri_f32
    has = wpair >= 0
    wp = torch.clamp(wpair, min=0)
    g = tf[:, wp]  # (9 + 3C, h_pad, w_pad)
    oy, ox = prep.origin
    pcy = (oy + torch.arange(prep.h_pad, device=dev)[:, None]).to(torch.float32) + 0.5
    pcx = (ox + torch.arange(prep.w_pad, device=dev)[None, :]).to(torch.float32) + 0.5
    s0x, s0y = g[S0X] - pcx, g[S0Y] - pcy
    s1x, s1y = g[S1X] - pcx, g[S1Y] - pcy
    s2x, s2y = g[S2X] - pcx, g[S2Y] - pcy
    a = torch.abs(s1x * s2y - s1y * s2x)
    b = torch.abs(s2x * s0y - s2y * s0x)
    c = torch.abs(s0x * s1y - s0y * s1x)
    inv_s = true_div(1.0, a + b + c)
    w_corr = true_div(1.0, torch.where(depth != 0.0, depth, 1.0))
    c0 = g[RHW0] * (a * inv_s) * w_corr
    c1 = g[RHW1] * (b * inv_s) * w_corr
    c2 = g[RHW2] * (c * inv_s) * w_corr
    n = prep.n_ctx
    ctx = torch.stack(
        [g[CTX0 + ch] * c0 + g[CTX0 + n + ch] * c1 + g[CTX0 + 2 * n + ch] * c2 for ch in range(n)]
    ) if n else torch.zeros((0, prep.h_pad, prep.w_pad), device=dev)
    ctx = torch.where(has, ctx, 0.0)
    winner = torch.where(has, ti[SLOT][wp], -1)
    ps = torch.where(has, ti[PS][wp] & PS_MASK, 0)
    return ctx, winner, ps


def raster_planes_plain(prep: BinnedPrep, interp: bool):
    """Plain version of K4 (``csrc/raster_planes.cu``), on the tensors' device:
    padded (depth, winner) and, with ``interp``, (ps, ctx (C, h_pad, w_pad))."""
    depth, wpair = raster_tiles_plain(prep)
    ctx, winner, ps = interpolate_plain(prep, depth, wpair)
    if not interp:
        return depth, winner, None, None
    return depth, winner, ps, ctx


def raster_planes(prep: BinnedPrep, interp: bool):
    """K4 on :func:`prep_binned` products: CUDA tensors launch the kernel
    (``kernels.raster_planes``), CPU tensors run the plain version. Returns
    the padded planes of :func:`raster_planes_plain`."""
    dev = prep.tri_i32.device
    if dev.type == "cpu":
        return raster_planes_plain(prep, interp)
    from f_renderer_tpu_torch import kernels

    return kernels.raster_planes(
        prep.off, prep.tri_i32, prep.tri_f32,
        th=prep.th, n_ctx=prep.n_ctx, h_pad=prep.h_pad, w_pad=prep.w_pad, interp=interp,
        origin=prep.origin,
    )


def rasterize(tri: TriangleBuffer, width: int, height: int, tile=None, *, origin=(0, 0), full_size=None):
    """Rasterize to per-pixel (winner (H, W) int32, depth (H, W) f32).

    ``winner`` is the TriangleBuffer slot id of the pixel's front triangle,
    -1 where none covers it. ``tile`` as in :func:`bin_packed`.
    ``origin=(y0, x0)`` renders the ``height`` × ``width`` rectangle at that
    pixel of a ``full_size=(H_full, W_full)`` frame (None: the rectangle is
    the frame), as ``rasterize_pallas`` does (raster_pallas.py:1583).
    """
    prep = _prep_rect(tri, width, height, tile, origin, full_size)
    depth, winner, _, _ = raster_planes(prep, interp=False)
    return winner[:height, :width], depth[:height, :width]


def rasterize_interp(tri: TriangleBuffer, width: int, height: int, tile=None, *, origin=(0, 0), full_size=None):
    """Rasterize and interpolate the C varyings of each pixel's winner.

    Returns ``(ctx (C, H, W) f32, ps_index (H, W) int32, winner (H, W)
    int32, depth (H, W) f32)``; ctx is 0 and ps 0 where winner < 0. Any C.
    ``origin`` and ``full_size`` as in :func:`rasterize`.
    """
    return interp_planes(_prep_rect(tri, width, height, tile, origin, full_size))


def interp_planes(prep: BinnedPrep):
    """K4 with interpolation on a prep → :func:`rasterize_interp`'s planes,
    cropped to the prep's rectangle."""
    depth, winner, ps, ctx = raster_planes(prep, interp=True)
    h, w = prep.height, prep.width
    return ctx[:, :h, :w], ps[:h, :w], winner[:h, :w], depth[:h, :w]


def _prep_rect(tri, width, height, tile, origin, full_size):
    fh, fw = full_size if full_size is not None else (height, width)
    return prep_binned(tri, fw, fh, tile, origin=origin, size=(height, width))
