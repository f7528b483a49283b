"""The voxel scenes' kind: the sparse voxel octree and its dense grids from
the seed, the orbit's cameras, the plain reference raycaster the benchmark
holds the port's frames to, and the least work of a frame.

The scene is ``voxel.rs``'s (examples/src/bin/voxel.rs:21-559 of the
reference renderer): a random octree of the configuration's ``level``
(70% of a node's octants occupied, 30% of those a leaf above level 0,
voxel.rs:492-516) in a cube of side ``length``; its generator and its
densification into the (r, r, r) grids the port takes (r = 2^(level+1))
are frozen copies of the port's numpy ones (``voxel/octree.py``:
``gen_randomly``, ``densify``), as ``scenes.py`` freezes the texture.

The reference renders each pixel as ``voxel.rs`` does, in plain PyTorch
float32 on any device. It imports nothing of the port, uses no matrix
multiplication, and never reads the dense grids:

- the pixel's NDC and the ray direction unprojected through ``inv_mvp``
  and normalized (voxel.rs:141-150), each sum left to right;
- ``VoxelCube::intersect`` (voxel.rs:239-334): per axis the
  axis-parallel case, then the planes through the origin and at
  ``length`` (a corner point itself where the ray's line passes through
  it), the points sorted by their distance to the eye (stable), and for
  more than two points the reference's scrambling dedupe; its early-out
  ``pos.x > length && pos.x < 0`` can never hold and is left out
  (voxel.rs:243-246);
- ``t_max``, the least of the three axes' ``(end - start) / dir`` with a
  NaN ignored (Rust's ``f32::min``), and the fixed step's serial float32
  chain ``t = min(t + per_t, t_max)`` from 0, ``per_t = length / 2^level
  · 0.01`` (voxel.rs:336-355);
- each sample's ``find_leaf``: a descent of the octree itself
  (voxel.rs:357-411), the octants tested in bit order by their half-open
  ranges, octant ``i`` at offset ``(i & 1, (i >> 2) & 1, (i >> 1) & 1)``
  of the half side; the first leaf met gives the pixel its BGR colour,
  alpha 255; a ray that meets none is the background.

Rays are worked on in blocks of whole rows, each ray's march until its
hit or its end. No depth is compared.

``dtype`` is the precision the ray directions are rounded to once
unprojected: float32 is the configuration's; bfloat16 is the control,
which must fail the comparison. The march stays in float32 (a bfloat16
``t`` could not take the step at all past t = 0.64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import scenes
from benchmark.kinds import triangle

BLOCK_RAYS = 1 << 20  # rays a block of rows holds
FAR = float("inf")  # an empty slot's distance in the sort


# ---------------------------------------------------------------------------
# The octree (frozen copies of the port's voxel/octree.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Leaf:
    color: np.ndarray  # (4,) u8, (b, g, r, a)


@dataclasses.dataclass
class Voxel:
    valid_mask: int = 0
    leaf_mask: int = 0
    children: list = dataclasses.field(default_factory=list)
    leaves: list = dataclasses.field(default_factory=list)


def _random_rgba(rng) -> np.ndarray:
    return np.array([rng.integers(0, 256), rng.integers(0, 256), rng.integers(0, 256), 255], np.uint8)


def gen_randomly(level: int, rng) -> Voxel:
    """Random SVO: 70% occupancy, 30% leaf chance above level 0
    (voxel.rs:492-516)."""
    v = Voxel()
    for i in range(8):
        bit = 1 << i
        if rng.random() < 0.70:
            v.valid_mask += bit
            is_leaf = (rng.random() < 0.30) if level > 0 else True
            if is_leaf:
                v.leaf_mask += bit
                v.leaves.append(Leaf(color=_random_rgba(rng)))
            else:
                v.children.append(gen_randomly(level - 1, rng))
    return v


def _octant_offset(i: int):
    return (i & 1, (i >> 2) & 1, (i >> 1) & 1)  # (dx, dy, dz), voxel.rs:396-411


def densify(root: Voxel, level: int):
    """The SVO as a dense grid of resolution r = 2^(level+1): (color (r, r,
    r, 4) u8 indexed [ix, iy, iz], hit (r, r, r) bool)."""
    r = 1 << (level + 1)
    color = np.zeros((r, r, r, 4), np.uint8)
    hit = np.zeros((r, r, r), bool)

    def paint(node: Voxel, x0: int, y0: int, z0: int, half: int):
        ci = 0
        li = 0
        for i in range(8):
            bit = 1 << i
            if not (node.valid_mask & bit):
                continue
            dx, dy, dz = _octant_offset(i)
            x, y, z = x0 + dx * half, y0 + dy * half, z0 + dz * half
            if node.leaf_mask & bit:
                color[x : x + half, y : y + half, z : z + half] = node.leaves[li].color
                hit[x : x + half, y : y + half, z : z + half] = True
                li += 1
            else:
                paint(node.children[ci], x, y, z, half // 2)
                ci += 1

    paint(root, 0, 0, 0, r // 2)
    return color, hit


@dataclasses.dataclass
class Tree:
    """The octree as node tables, breadth first from the root (node 0):
    valid and leaf masks (N,) int64, each octant's child node (N, 8) int64
    (-1 where none) and leaf colour (N, 8, 4) uint8 BGRA."""

    valid: np.ndarray
    leaf: np.ndarray
    child: np.ndarray
    color: np.ndarray


def node_tables(root: Voxel) -> Tree:
    nodes, order, queue = [root], {id(root): 0}, [root]
    while queue:
        n = queue.pop(0)
        for c in n.children:
            order[id(c)] = len(nodes)
            nodes.append(c)
            queue.append(c)
    count = len(nodes)
    valid, leaf = np.zeros(count, np.int64), np.zeros(count, np.int64)
    child, color = np.full((count, 8), -1, np.int64), np.zeros((count, 8, 4), np.uint8)
    for ni, n in enumerate(nodes):
        valid[ni], leaf[ni] = n.valid_mask, n.leaf_mask
        ci = li = 0
        for i in range(8):
            if not (n.valid_mask >> i) & 1:
                continue
            if (n.leaf_mask >> i) & 1:
                color[ni, i] = n.leaves[li].color
                li += 1
            else:
                child[ni, i] = order[id(n.children[ci])]
                ci += 1
    return Tree(valid, leaf, child, color)


@dataclasses.dataclass
class VoxelInputs:
    """What a run renders: the octree (node tables, for the reference), its
    dense grids (for the port) and the start of the orbit."""

    tree: Tree
    grid_color: np.ndarray
    grid_hit: np.ndarray
    start: int


# ---------------------------------------------------------------------------
# The camera
# ---------------------------------------------------------------------------


def orbit_view(config, traffic, step: int):
    """The orbit's camera at ``step``: the eye at angle ``a = start_angle_rad +
    step_rad · step`` on a circle of ``radius`` about the cube's centre,
    ``height`` above it, looking at the centre with y up; the config's
    perspective (matrix_util.rs) → (eye (3,), inv_mvp (4, 4)) float32
    arrays, the model the identity and the inverse taken in float64."""
    a = traffic["start_angle_rad"] + traffic["step_rad"] * step
    centre = np.full(3, config["length"] / 2, np.float32)
    eye = centre + np.array([traffic["radius"] * np.cos(a), traffic["height"], traffic["radius"] * np.sin(a)],
                            np.float32)
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
    view, proj = triangle.camera_matrices(config, t(eye), t(centre), t((0.0, 1.0, 0.0)), torch.float32)
    mvp = triangle.mat_mul4(proj, view)
    return eye.astype(np.float32), torch.linalg.inv(mvp.double()).float().numpy()


# ---------------------------------------------------------------------------
# The raycaster (voxel.rs:135-416)
# ---------------------------------------------------------------------------


def unproject(inv_mvp, width, rows, height):
    """The directions of the pixels of ``rows`` (voxel.rs:141-150) → (R, 3)."""
    dev = inv_mvp.device
    x = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    y = rows.to(torch.float32)[:, None]
    ndc_x = (triangle.true_div(x * 2.0, float(width)) - 1.0).expand(len(rows), width).reshape(-1)
    ndc_y = (1.0 - triangle.true_div(y * 2.0, float(height))).expand(len(rows), width).reshape(-1)
    m = inv_mvp
    d = [((m[i, 0] * ndc_x + m[i, 1] * ndc_y) + m[i, 2]) + m[i, 3] for i in range(3)]
    norm = triangle.true_sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    return torch.stack([c / norm for c in d], dim=-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def intersect(pos, dirs, length):
    """VoxelCube::intersect (voxel.rs:239-334) for rays from ``pos`` (3,)
    along ``dirs`` (R, 3) → (start (R, 3), end (R, 3), valid (R,))."""
    dev, n_rays = dirs.device, dirs.shape[0]
    length = torch.tensor(length, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pushed = []  # (point (R, 3), cond (R,)) in the order the reference pushes
    done = torch.zeros(n_rays, dtype=torch.bool, device=dev)  # broke out after the parallel case
    for axis in range(3):
        n = torch.zeros(3, dtype=torch.float32, device=dev)
        n[axis] = 1.0
        unit_diag = 1.0 - n
        parallel = (cross(dirs, n) == 0.0).all(-1) & ~done
        p = unit_diag * pos
        inside = bool(((p >= 0.0) & (p <= length)).all())
        if inside:
            pushed.append((p.expand(n_rays, 3), parallel))
            pushed.append(((p + length * unit_diag).expand(n_rays, 3), parallel))
            done = done | parallel
        generic = ~parallel & ~done & (dirs[:, axis] != 0.0)
        for corner in (zero * n, n * length):
            ap = corner - pos
            on_line = (cross(ap.expand(n_rays, 3), dirs) == 0.0).all(-1)
            pushed.append((corner.expand(n_rays, 3), generic & on_line))
            t = triangle.true_div(ap[axis].expand(n_rays), dirs[:, axis])
            b = pos + dirs * t[:, None]
            in_box = ((b >= 0.0) & (b <= length)).all(-1)
            pushed.append((b, generic & ~on_line & (t >= 0.0) & in_box))
    pts = torch.stack([p for p, _ in pushed], dim=1)  # (R, K, 3)
    cond = torch.stack([c for _, c in pushed], dim=1)  # (R, K)
    cnt = cond.sum(1)
    # a stable sort of the pushed points by distance to the eye
    dv = pts - pos
    dist = triangle.true_sqrt((dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1]) + dv[..., 2] * dv[..., 2])
    order = torch.sort(torch.where(cond, dist, FAR), dim=1, stable=True).indices
    pts = torch.gather(pts, 1, order[..., None].expand_as(pts))
    # the scrambling dedupe for more than two points (voxel.rs:323-331):
    # i = 1; for j in 0..len: if pts[i] != pts[j] { pts[i] = pts[j]; i = j }
    ded = pts.clone()
    rows = torch.arange(n_rays, device=dev)
    i = torch.ones(n_rays, dtype=torch.long, device=dev)
    for j in range(pts.shape[1]):
        differs = (ded[rows, i] != ded[:, j]).any(-1) & (j < cnt) & (cnt > 2)
        ded[rows, i] = torch.where(differs[:, None], ded[:, j], ded[rows, i])
        i = torch.where(differs, j, i)
    start, end = ded[:, 0], torch.where((cnt == 1)[:, None], ded[:, 0], ded[:, 1])
    return start, end, cnt > 0


def fmin(a, b):
    """Rust's ``f32::min``: a NaN operand ignored."""
    return torch.where((a < b) | torch.isnan(b), a, b)


def find_leaf(tree, level: int, length, p):
    """VoxelCube::find_leaf (voxel.rs:357-411) at points ``p`` (M, 3), a
    descent of the octree by octant bits → (hit (M,), the leaf's index
    into ``tree.color`` viewed (N · 8, 4))."""
    dev, m = p.device, p.shape[0]
    offsets = torch.tensor([_octant_offset(i) for i in range(8)], dtype=torch.float32, device=dev)
    bits = torch.arange(8, device=dev)
    node = torch.zeros(m, dtype=torch.long, device=dev)
    origin = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    searching = torch.ones(m, dtype=torch.bool, device=dev)
    hit = torch.zeros(m, dtype=torch.bool, device=dev)
    leaf_at = torch.zeros(m, dtype=torch.long, device=dev)
    side = torch.tensor(length, dtype=torch.float32, device=dev)
    rows = torch.arange(m, device=dev)
    for _ in range(level + 1):
        half = side * 0.5
        sub = origin[:, None, :] + offsets * half  # (M, 8, 3): each octant's corner
        q = p[:, None, :]
        inside = ((sub <= q) & (q < sub + half)).all(-1)
        valid = ((tree.valid[node][:, None] >> bits) & 1).bool()
        cand = inside & valid & searching[:, None]
        found = cand.any(1)
        i = cand.to(torch.uint8).argmax(1)  # the first octant in bit order
        is_leaf = ((tree.leaf[node] >> i) & 1).bool()
        got = found & is_leaf
        hit = hit | got
        leaf_at = torch.where(got, node * 8 + i, leaf_at)
        searching = found & ~is_leaf
        node = torch.where(searching, tree.child[node, i], 0)
        origin = torch.where(searching[:, None], sub[rows, i], origin)
        side = half
    return hit, leaf_at


def march(tree, config, dirs, start, end, valid, cell):
    """The fixed-step ray_cast (voxel.rs:336-355) of each ray → (hit (R,),
    leaf index (R,), alive (R,), cells crossed (R,))."""
    dev, n_rays = dirs.device, dirs.shape[0]
    length, level = config["length"], config["level"]
    f32 = np.float32
    per_t = torch.tensor(f32(f32(f32(length) / f32(2.0**level)) * f32(0.01)), device=dev)
    tmv = (end - start) / dirs
    t_max = fmin(fmin(tmv[:, 0], tmv[:, 1]), tmv[:, 2])
    alive = valid & (t_max >= 0.0)  # while t <= t_max, from t = 0
    hit = torch.zeros(n_rays, dtype=torch.bool, device=dev)
    leaf = torch.zeros(n_rays, dtype=torch.long, device=dev)
    cells = torch.zeros(n_rays, dtype=torch.long, device=dev)
    r = 1 << (level + 1)
    idx = torch.nonzero(alive).squeeze(1)
    t = torch.zeros(idx.shape[0], dtype=torch.float32, device=dev)
    last = torch.full(idx.shape, -1, dtype=torch.long, device=dev)
    while idx.numel():
        s, d, tm = start[idx], dirs[idx], t_max[idx]
        p = s + t[:, None] * d
        inside = ((p >= 0.0) & (p < length)).all(-1)
        c = torch.clamp(torch.floor(triangle.true_div(p, cell)), 0, r - 1).long()
        flat = torch.where(inside, (c[:, 0] * r + c[:, 1]) * r + c[:, 2], -1)
        new_cell = inside & (flat != last)
        cells.index_add_(0, idx, new_cell.long())
        last = torch.where(new_cell, flat, last)
        h, at = find_leaf(tree, level, length, p)
        hit[idx] = h
        leaf[idx] = at
        going = ~h & (t < tm)
        t = torch.minimum(t + per_t, tm)
        idx, t, last = idx[going], t[going], last[going]
    return hit, leaf, alive, cells


def render(config, tree, eye, inv_mvp, dtype=torch.float32):
    """One frame of the reference → (frame (H, W, 4) uint8 BGRA, counts
    {rays, alive, cells, hits})."""
    width, height, length = config["width"], config["height"], config["length"]
    dev = inv_mvp.device
    colors = torch.as_tensor(tree.color, device=dev).reshape(-1, 4)
    background = torch.tensor(config["background"], dtype=torch.uint8, device=dev)
    cell = torch.tensor(np.float32(np.float32(length) / np.float32(1 << (config["level"] + 1))), device=dev)
    frame = torch.empty((height * width, 4), dtype=torch.uint8, device=dev)
    counts = {"rays": width * height, "alive": 0, "cells": 0, "hits": 0}
    rows_a_block = max(1, BLOCK_RAYS // width)
    for y0 in range(0, height, rows_a_block):
        rows = torch.arange(y0, min(y0 + rows_a_block, height), device=dev)
        dirs = unproject(inv_mvp, width, rows, height).to(dtype).to(torch.float32)
        start, end, valid = intersect(eye, dirs, length)
        hit, leaf, alive, cells = march(tree, config, dirs, start, end, valid, cell)
        color = colors[leaf].clone()
        color[:, 3] = 255
        block = slice(y0 * width, (y0 + len(rows)) * width)
        frame[block] = torch.where(hit[:, None], color, background)
        counts["alive"] += int(alive.sum())
        counts["cells"] += int(cells.sum())
        counts["hits"] += int(hit.sum())
    return frame.reshape(height, width, 4), counts


# ---------------------------------------------------------------------------
# The least work of a frame (the rooflines' numerator)
# ---------------------------------------------------------------------------
#
# Counted from the frame as this reference computes it, whatever kernels
# implement it. Bytes: the frame written once (RGBA8), the (r³,) table of
# 4 B a cell read once and the frame's inputs (eye 12 B, inv_mvp 64 B).
# Operations, each add, multiply, compare, divide or square root one:
#
# - a ray: its NDC (6); the unprojection (three rows of 2 multiplies and 3
#   adds, 15), its norm (3 multiplies, 2 adds, a square root) and the 3
#   divisions (24 in all); the intersection's three axes, each the
#   parallel test (a cross product of 6 multiplies and 3 subtractions, 3
#   compares: 12) and two planes of 29 (ap 3; the on-line cross product
#   and its compares 12; t, a division and its compare 2; b, 3 multiplies
#   and 3 adds; its 6 bounds): 210; two points' distances (3 subtractions,
#   3 multiplies, 2 adds, a square root each) and their compare, 19;
#   t_max's 3 subtractions, 3 divisions, 2 minima and its compare, 9;
# - a cell crossed: one point query, the least the fixed step needs where
#   it crosses a cell: the sample (3 multiplies, 3 adds), the step (an
#   add, a minimum, a compare) and the descent, each of the level + 1
#   levels the octant that holds the point (its corner, 3; its range's 3
#   adds and 6 compares): 9 + 12 · (level + 1).

INPUT_BYTES = 12 + 64  # eye and inv_mvp, float32
PIXEL_BYTES = 4  # BGRA8
TABLE_BYTES_PER_CELL = 4  # the port's int32 cell: BGR and the hit bit
OPS_PER_RAY = 6 + 24 + 210 + 19 + 9
OPS_PER_LEVEL = 3 + 3 + 6


def ops_per_cell(level: int) -> int:
    return 9 + OPS_PER_LEVEL * (level + 1)


# ---------------------------------------------------------------------------
# The kind's functions, which the harness calls
# ---------------------------------------------------------------------------


def scene_inputs(config, seed, traffic) -> VoxelInputs:
    """The config's octree from ``seed`` (its node tables and dense
    grids) and the start of the orbit's ``turn_steps``. The grids' shapes
    never depend on the seed; only the tree's values and node count do."""
    root = gen_randomly(config["level"], scenes.seed_stream(seed, "octree"))
    grid_color, grid_hit = densify(root, config["level"])
    start = int(scenes.seed_stream(seed, "start").integers(0, traffic.get("turn_steps", 1)))
    return VoxelInputs(node_tables(root), grid_color, grid_hit, start)


def reference_frames(config, inputs, cases, device, dtype=torch.float32):
    """The reference's (frame, None, counts) of each case {k: inputs}: the
    ``eye`` and ``inv_mvp`` of a sampled frame."""
    t = inputs.tree
    tree = Tree(*(torch.as_tensor(a, device=device) for a in (t.valid, t.leaf, t.child, t.color)))
    out = {}
    for k, case in cases.items():
        eye = torch.as_tensor(np.asarray(case["eye"], np.float32), device=device)
        inv_mvp = torch.as_tensor(np.asarray(case["inv_mvp"], np.float32), device=device)
        frame, counts = render(config, tree, eye, inv_mvp, dtype)
        out[k] = (frame, None, counts)
    return out


def per_frame(config, traffic, inputs, counts) -> dict:
    """The least bytes and operations of a frame, from the reference's
    counts a frame (rays, cells crossed); the voxel stage is the whole
    frame."""
    r = 1 << (config["level"] + 1)
    nbytes = config["width"] * config["height"] * PIXEL_BYTES + r**3 * TABLE_BYTES_PER_CELL + INPUT_BYTES
    ops = counts["rays"] * OPS_PER_RAY + counts["cells"] * ops_per_cell(config["level"])
    return {"frame_bytes": nbytes, "frame_ops": ops, "voxel_bytes": nbytes, "voxel_ops": ops}
