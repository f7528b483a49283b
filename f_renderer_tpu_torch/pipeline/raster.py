"""Raster setup and binning for the fused kernel.

Port of the prep half of ``f_renderer_tpu/pipeline/raster_pallas.py``
(:47-91, :178-269, :316-436): the field-row layout, ``pack_setup`` and
``bin_pairs``. On the TPU these ran as XLA ops, and here they stay plain
PyTorch ops on the tensors' device.

Integer arithmetic follows the JAX package's wrapped int32 semantics
(Rust release-mode overflow, renderer.rs:329-331): the affine edge
coefficients are computed in int64 and reduced modulo 2^32 after every
product and sum, which gives the wrapped int32 result exactly with no
overflow in between.
"""

from __future__ import annotations

import torch

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


def bin_pairs(tri_i32, tile, grid_hw, k: int, chunk: int, m_dummy: int, kc: int = 6):
    """Hierarchical per-tile triangle lists via (tile, triangle) pair expansion.

    Each triangle lands in exactly one level: a span of ≤ ``k`` fine tiles
    gives one pair per covered fine tile; else a span of ≤ ``kc`` coarse
    tiles (COARSE×COARSE fine tiles each) one pair per covered coarse tile;
    else one pair in the shared spill bucket that every tile scans.

    Returns ``(pair_tri (Npad,) int32, off (ntiles + ntilesc + 2,) int32)``:
    ``off[t]..off[t+1]`` is fine tile t's pair range, ``off[ntiles + c]..``
    coarse tile c's, and the last pair of entries the spill range. Padding
    pairs point at ``m_dummy``, an empty-bbox slot.
    """
    th, tw = tile
    nty, ntx = grid_hw
    ntiles = nty * ntx
    ntxc = cdiv(ntx, COARSE)
    ntilesc = cdiv(nty, COARSE) * ntxc
    big = ntiles + ntilesc + 1
    bminx, bminy = unpack_xy(tri_i32[MINXY])
    bmaxx, bmaxy = unpack_xy(tri_i32[MAXXY])
    minx = torch.clamp(bminx, 0, ntx * tw)
    maxx = torch.clamp(bmaxx, 0, ntx * tw)
    miny = torch.clamp(bminy, 0, nty * th)
    maxy = torch.clamp(bmaxy, 0, nty * th)
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
