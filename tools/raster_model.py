#!/usr/bin/env python3
"""A CPU model of the raster kernels' work (csrc/raster_loop.cuh) at
phong1080 and stress4k: how much each pixel layout and each way of staging
the pair lists gives the blocks and their warps.

Run from the repository root (CPU only, about two minutes for both scenes):

    python3 tools/raster_model.py [--scene phong1080|stress4k]

For every tile of the binned pair list (``prep_binned`` at the bench angle
0.10) it walks the ballot the kernels run: a warp visits a pair when the
pair's bbox [MINXY, MAXXY) meets the warp's columns and the rows of one of
its row steps. Costs are counted in the model's own units, 20 a visit and
60 a row step inside the bbox (the visit loop's SASS is about that), and a
block's chain is the cost of its busiest warp. Printed per scene:

- the tile plan (``raster.tile_plan_plain``): the layouts it chooses, and
  the coarse and spill entries of the tiles' lists against those whose
  bbox meets their tile (the culled lists);
- per layout (rows interleaved in every tile, 8 x 8 patches in every tile,
  a fixed threshold: rows at >= 256 fine + coarse pairs, the plan's) and
  per range (fine / coarse / spill): visits and row steps, and the summed
  block chains; a pair that does not reach a tile has no visit, so the cull
  changes none of these;
- the pair records the blocks stage, summed over blocks, and their chunks
  of 128: every block the tile's whole lists, the culled lists
  (the plan), and the culled lists cut to the pairs whose bbox rows meet
  the block's own in a tile of patches longer than a chunk (the row
  selection);
- the tiles no pair reaches, which the plan empties;
- a pair walk's work (a thread a (pair, row) couple, the covered pixels
  shared out 32 to a warp; measured slower than the warp walks, PERF.md
  §6) in the tiles of patches, beside their warp visits: the couples (a
  staged pair's bbox rows in its block's band), the bbox pixels those rows
  hold inside the tile, the pixels the pairs cover there
  (``raster.cover_plain``), the warp rounds of 32 covered pixels, and the
  tiles' mean bbox area clipped to the tile.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

VISIT, ROW_STEP = 20, 60
CHUNK = 128  # csrc/raster_loop.cuh
FIXED_HEAVY = 256  # a fixed rows-interleaved threshold on fine + coarse pairs
RANGES = ("fine", "coarse", "spill")


def scene_prep(name):
    import chip_smoke
    from f_renderer_tpu_torch.pipeline import raster
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    scene = chip_smoke.build_scene(name, "cpu")
    chip_smoke.set_angle(scene, 0.10)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    c = scene.config
    return raster.prep_binned(tri, c.width, c.height, c.tile, tile_auto=c.tile_auto, bin_k=c.bin_k)


def warp_rects(layout, th):
    """The warps' row-step rects, (S, 16, 2, 4) as (x0, x1, y0, y1) in the
    tile: rows interleaved (block s rows s + S k, each warp 32 columns of two
    rows 4 S apart) or 8 x 8 patches (block s rows [8 s, 8 s + 8), each warp
    8 columns, 4 rows a row step)."""
    s_blocks = th // 8
    rects = np.zeros((s_blocks, 16, 2, 4), np.int64)
    for s in range(s_blocks):
        for w in range(16):
            for r in range(2):
                if layout == "rows":
                    y = s + s_blocks * (w // 4) + 4 * s_blocks * r
                    rects[s, w, r] = (32 * (w % 4), 32 * (w % 4) + 32, y, y + 1)
                else:
                    rects[s, w, r] = (8 * w, 8 * w + 8, 8 * s + 4 * r, 8 * s + 4 * r + 4)
    return rects


def warp_work(box, rects):
    """(visits, row steps, cost of each warp (S, 16)) of the pairs in ``box``."""
    bx0, bx1, by0, by1 = (v[:, None] for v in box)
    x0, x1, y0, y1 = (rects[..., k].reshape(-1)[None, :] for k in range(4))
    hit = ((bx0 < x1) & (bx1 > x0) & (by0 < y1) & (by1 > y0)).reshape(-1, *rects.shape[:3])
    steps, visits = hit.sum(-1), hit.any(-1)
    return int(visits.sum()), int(steps.sum()), VISIT * visits.sum(0) + ROW_STEP * steps.sum(0)


def pair_work(prep, idx, x0, y0, th):
    """A pair walk's work in one tile over its list ``idx``: (couples, bbox
    pixels, covered pixels, pairs whose bbox meets the tile), each pair's
    bbox cut to the tile (a bbox row lies in one block's band)."""
    import torch

    from f_renderer_tpu_torch.pipeline import raster

    if idx.numel() == 0:
        return 0, 0, 0, 0
    minx, miny = raster.unpack_xy(prep.tri_i32[raster.MINXY, idx].long())
    maxx, maxy = raster.unpack_xy(prep.tri_i32[raster.MAXXY, idx].long())
    xs, xe = minx.clamp(min=x0), maxx.clamp(max=x0 + raster.LANES)
    ys, ye = miny.clamp(min=y0), maxy.clamp(max=y0 + th)
    w, h = (xe - xs).clamp(min=0), (ye - ys).clamp(min=0)
    couples = int(h[w > 0].sum())
    bbox_px = int((w * h).sum())
    meets = int(((w > 0) & (h > 0)).sum())
    covered = 0
    gw, gh = int(w.max()), int(h.max())
    step = max(1, (1 << 22) // max(1, gw * gh))
    for i in range(0, idx.numel(), step):
        sl = slice(i, i + step)
        cx = xs[sl, None, None] + torch.arange(gw)[None, None, :]
        cy = ys[sl, None, None] + torch.arange(gh)[None, :, None]
        inside = (cx < xe[sl, None, None]) & (cy < ye[sl, None, None])
        covered += int((inside & raster.cover_plain(prep.tri_i32, idx[sl], cx, cy)).sum())
    return couples, bbox_px, covered, meets


def model(name):
    import torch

    from f_renderer_tpu_torch.pipeline import raster

    prep = scene_prep(name)
    th, nty, ntx = prep.th, prep.h_pad // prep.th, prep.w_pad // raster.LANES
    ntiles, s_blocks = nty * ntx, th // 8
    plan = raster.tile_plan_plain(prep)
    off = prep.off.tolist()
    spill0 = off[raster.tile_lists(prep, 0, 0)[2]]
    minx, miny = (v.numpy() for v in raster.unpack_xy(prep.tri_i32[raster.MINXY].long()))
    maxx, maxy = (v.numpy() for v in raster.unpack_xy(prep.tri_i32[raster.MAXXY].long()))
    rects = {layout: warp_rects(layout, th) for layout in ("rows", "patches")}
    layouts = ("rows", "patches", "threshold's", "plan's")
    visits = {(lay, r): 0 for lay in layouts for r in RANGES}
    steps = dict(visits)
    chains = {lay: 0 for lay in layouts}
    entries, kept = dict.fromkeys(RANGES, 0), dict.fromkeys(RANGES, 0)
    staged = {key: [0, 0] for key in ("whole lists", "culled lists (plan)", "culled + row selection")}
    emptied = fixed_rows_tiles = 0
    for t in range(ntiles):
        ty, tx = divmod(t, ntx)
        x0, y0 = tx * raster.LANES, ty * th
        lists = [np.arange(off[r], off[r + 1]) for r in raster.tile_lists(prep, ty, tx)]
        mine = plan.lists[t].numpy()
        for r, idx in zip(RANGES, lists):
            entries[r] += idx.size
        if plan.flags[t] & raster.TILE_CULLED:
            culled = mine[lists[0].size:]
            kept["spill"] += int((culled >= spill0).sum())
            kept["coarse"] += int((culled < spill0).sum())
        emptied += mine.size == 0
        work = {}  # (layout, range) → (visits, row steps, each warp's cost)
        for layout, rect in rects.items():
            for r, idx in zip(RANGES, lists):
                work[layout, r] = warp_work((minx[idx] - x0, maxx[idx] - x0, miny[idx] - y0, maxy[idx] - y0), rect)
        fixed_rows = lists[0].size + lists[1].size >= FIXED_HEAVY
        fixed_rows_tiles += fixed_rows
        plan_rows = bool(plan.flags[t] & raster.TILE_ROWS)
        for layout, rows in (("rows", True), ("patches", False), ("threshold's", fixed_rows), ("plan's", plan_rows)):
            src = "rows" if rows else "patches"
            for r in RANGES:
                v, s, _ = work[src, r]
                visits[layout, r] += v
                steps[layout, r] += s
            chains[layout] += int(sum(work[src, r][2] for r in RANGES).max(1).sum())  # each block's busiest warp
        for key, n in (("whole lists", sum(v.size for v in lists)), ("culled lists (plan)", mine.size)):
            staged[key][0] += s_blocks * n
            staged[key][1] += s_blocks * -(-n // CHUNK)
        for s in range(s_blocks):
            n = mine.size
            if not plan_rows and n > CHUNK:  # the block's rows alone
                n = int(((miny[mine] < y0 + 8 * s + 8) & (maxy[mine] > y0 + 8 * s)).sum())
            staged["culled + row selection"][0] += n
            staged["culled + row selection"][1] += -(-n // CHUNK)
    tiles = [t for t, lst in enumerate(plan.lists) if lst.numel() and not plan.flags[t] & raster.TILE_ROWS]
    pw = {"couples": 0, "bbox_px": 0, "covered": 0, "rounds": 0, "visits": 0}
    mean_area = []
    for t in tiles:
        ty, tx = divmod(t, ntx)
        lst = plan.lists[t]
        c, b, v, m = pair_work(prep, lst, tx * raster.LANES, ty * th, th)
        mean_area.append(b / max(m, 1))
        pw["couples"] += c
        pw["bbox_px"] += b
        pw["covered"] += v
        pw["rounds"] += -(-v // 32)
        x0, y0 = tx * raster.LANES, ty * th
        box = (minx[lst.numpy()] - x0, maxx[lst.numpy()] - x0, miny[lst.numpy()] - y0, maxy[lst.numpy()] - y0)
        pw["visits"] += warp_work(box, rects["patches"])[0]
    rows_tiles = sum(bool(f & raster.TILE_ROWS) for f in plan.flags)
    print(f"{name}: {ntiles} tiles of ({th}, 128), {s_blocks} blocks a tile; the tiles' lists hold "
          f"{entries['fine']} fine, {entries['coarse']} coarse and {entries['spill']} spill entries")
    print(f"  the plan: rows interleaved in {rows_tiles} tiles (a fixed threshold, >= {FIXED_HEAVY} fine + coarse "
          f"pairs: {fixed_rows_tiles}); the cull keeps {kept['coarse']} coarse and {kept['spill']} spill entries; "
          f"{emptied} tiles emptied")
    for layout in layouts:
        where = "everywhere" if layout in ("rows", "patches") else "layout"
        per = ", ".join(f"{r} {visits[layout, r]} / {steps[layout, r]}" for r in RANGES)
        print(f"  {layout} {where}: visits / row steps {per}; summed block chains {chains[layout] / 1e6:.3f} M")
    for key, (records, chunks) in staged.items():
        print(f"  staged, {key}: records {records} ({records / (ntiles * s_blocks):.1f} a block), "
              f"block-chunks {chunks}")

    def spread(v):
        return f"{min(v):.0f}-{max(v):.0f} px (median {sorted(v)[len(v) // 2]:.0f})" if v else "none"

    if tiles:
        print(f"  a pair walk in the {len(tiles)} non-empty tiles of patches (mean clipped bbox area "
              f"{spread(mean_area)}): patch visits {pw['visits']}; couples {pw['couples']}, bbox pixels "
              f"{pw['bbox_px']}, covered pixels {pw['covered']} ({pw['covered'] / pw['bbox_px']:.3f} of the bbox "
              f"pixels), warp rounds of 32 covered pixels >= {pw['rounds']} "
              f"({pw['visits'] / max(1, pw['couples'] / 32):.2f} visits a warp of 32 couples)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scene", choices=("phong1080", "stress4k"), default=None)
    opts = parser.parse_args()
    for name in (opts.scene,) if opts.scene else ("phong1080", "stress4k"):
        model(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
