#!/usr/bin/env python3
"""A CPU model of the raster kernels' warp-level culling (csrc/raster_loop.cuh)
on phong1080's geometry: how much work each pixel layout gives the warps.

Run from the repository root (CPU only, about a minute):

    python3 tools/raster_model.py

For every tile of the binned pair list (``prep_binned`` at 1920x1080, the
bench angle 0.10) it walks the ballot the kernels run: a warp visits a pair
when the pair's bbox [MINXY, MAXXY) meets the warp's columns and the rows of
one of its row steps. Costs are counted in the model's own units, 20 a visit
and 60 a row step inside the bbox (the visit loop's SASS is about that), and
a block's chain is the cost of its busiest warp. Printed:

- per class of tiles (by their fine and coarse pairs): visits and the
  busiest warp of a block, in the kernels' layout;
- per layout: visits, row steps, the summed cost (issue), the longest chain
  of any warp and the summed chains of the blocks (a block holds its slot
  for its busiest warp's chain);
- the tiles the order pass empties (no fine pair, at most 32 coarse and
  spill pairs, none of whose bboxes reaches the tile).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

VISIT, ROW_STEP = 20, 60
HEAVY_PAIRS, TOUCH_SCAN = 256, 32  # csrc/raster_loop.cuh


def phong1080_prep():
    import chip_smoke
    from f_renderer_tpu_torch.pipeline import raster
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    scene = chip_smoke.build_scene("custom12_360", "cpu")  # phong1080's meshes and camera, small textures
    scene.config = dataclasses.replace(scene.config, width=1920, height=1080)
    chip_smoke.set_angle(scene, 0.10)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    return raster.prep_binned(tri, 1920, 1080, scene.config.tile)


def rows_layout(th):
    """32-column warps, rows interleaved over the S blocks of a tile →
    blocks of warps of (first column, columns, [rows of each row step])."""
    s_blocks = th // 8
    return [[(wx * 32, 32, [[s + s_blocks * ty], [s + s_blocks * ty + 4 * s_blocks]])
             for ty in range(4) for wx in range(4)] for s in range(s_blocks)]


def patch_layout(th):
    """8 x 8 patches: block s takes rows [8 s, 8 s + 8), each warp 8 columns
    of them, rows l / 8 + 4 r for lane l and row step r."""
    return [[(8 * w, 8, [[8 * s + k for k in range(4)], [8 * s + 4 + k for k in range(4)]])
             for w in range(16)] for s in range(th // 8)]


def tile_work(box, x0, y0, blocks):
    """(visits, row steps, the busiest warp's cost of each block) of one tile."""
    minx, maxx, miny, maxy = box
    visits = steps = 0
    chains = []
    for warps in blocks:
        busiest = 0
        for cx, cw, row_steps in warps:
            inside = np.stack([((miny[:, None] <= y0 + np.array(rows)[None, :])
                                & (maxy[:, None] > y0 + np.array(rows)[None, :])).any(1)
                               for rows in row_steps], 1)
            touch = inside.any(1) & (minx < x0 + cx + cw) & (maxx > x0 + cx)
            v, r = int(touch.sum()), int(inside[touch].sum())
            visits, steps = visits + v, steps + r
            busiest = max(busiest, VISIT * v + ROW_STEP * r)
        chains.append(busiest)
    return visits, steps, chains


def main() -> int:
    from f_renderer_tpu_torch.pipeline import raster

    prep = phong1080_prep()
    th, nty, ntx = prep.th, prep.h_pad // prep.th, prep.w_pad // raster.LANES
    off = prep.off.tolist()
    minx, miny = (v.numpy() for v in raster.unpack_xy(prep.tri_i32[raster.MINXY].long()))
    maxx, maxy = (v.numpy() for v in raster.unpack_xy(prep.tri_i32[raster.MAXXY].long()))
    kernels_layout = "8x8 patches, rows at >= 256 pairs (the kernels')"
    layouts = {"32-column rows interleaved": lambda w: rows_layout(th),
               "8x8 patches": lambda w: patch_layout(th),
               kernels_layout: lambda w: rows_layout(th) if w >= HEAVY_PAIRS else patch_layout(th)}
    totals = {name: [0, 0, 0, []] for name in layouts}
    classes = {}
    emptied = 0
    for ty in range(nty):
        for tx in range(ntx):
            fine, coarse, spill = raster.tile_lists(prep, ty, tx)
            idx = np.concatenate([np.arange(off[r], off[r + 1]) for r in (fine, coarse, spill)])
            w = (off[fine + 1] - off[fine]) + (off[coarse + 1] - off[coarse])
            box = (minx[idx], maxx[idx], miny[idx], maxy[idx])
            x0, y0 = tx * raster.LANES, ty * th
            reach = ((box[0] < x0 + raster.LANES) & (box[1] > x0) & (box[2] < y0 + th) & (box[3] > y0))
            if off[fine + 1] == off[fine] and idx.size <= TOUCH_SCAN and not reach.any():
                emptied += 1
            for name, layout in layouts.items():
                v, r, chains = tile_work(box, x0, y0, layout(w))
                t = totals[name]
                t[0], t[1], t[2] = t[0] + v, t[1] + r, t[2] + VISIT * v + ROW_STEP * r
                t[3] += chains
                if name == kernels_layout:
                    cls = next(c for c in ((0, 1), (1, 8), (8, 32), (32, 128), (128, 256), (256, 10**9))
                               if c[0] <= w < c[1])
                    c = classes.setdefault(cls, [0, 0, []])
                    c[0], c[1] = c[0] + 1, c[1] + v
                    c[2] += [ch // (VISIT + ROW_STEP) for ch in chains]
    print(f"phong1080: {ntx * nty} tiles of ({th}, 128), {off[-1]} pairs in the lists")
    for (lo, hi), (n, v, chains) in sorted(classes.items()):
        print(f"  tiles of [{lo}, {hi}) fine + coarse pairs: {n:4d}, visits a tile {v / n:8.1f}, "
              f"the busiest warp of a block ~{np.mean(chains):6.1f} visits")
    for name, (v, r, cost, chains) in totals.items():
        print(f"  {name:50s} visits {v:7d}, row steps {r:7d}, issue {cost / 1e6:6.2f} M, "
              f"longest chain {max(chains):6d}, summed block chains {sum(chains) / 1e6:6.3f} M")
    print(f"  tiles the order pass empties: {emptied}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
