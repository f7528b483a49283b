"""SVO data model (reference: voxel.rs:419-559).

A copy of ``f_renderer_tpu/voxel/octree.py``, which needs no JAX but sits in
a package whose ``__init__`` imports it; the port keeps its own. Host-side
numpy, as in the reference: the scene is built once at set-up.

`Voxel` mirrors the reference's recursive node: valid/leaf bitmasks plus
children and leaf lists indexed by *rank* of the bit among set bits
(voxel.rs:357-385). Octant bit layout (voxel.rs:396-411): for bit index i,
the sub-cube offset is (dx, dy, dz) = (i & 1, (i >> 2) & 1, (i >> 1) & 1).

Host-side construction (scene setup, like the reference's gen at startup);
device-side representations: flat index arrays and a dense grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Leaf:
    """voxel.rs:434-451. Color is BGRA u8 like Rgba (wgpu_base.rs:13-20)."""

    id: int = 0
    color: np.ndarray = None  # (4,) u8, (b, g, r, a)


@dataclasses.dataclass
class Voxel:
    valid_mask: int = 0
    leaf_mask: int = 0
    children: list = dataclasses.field(default_factory=list)
    leaves: list = dataclasses.field(default_factory=list)

    def depth_first(self) -> int:
        """DFS node count (voxel.rs:518-536)."""
        return 1 + sum(c.depth_first() for c in self.children)

    def leaves_count(self) -> int:
        """Total leaves (voxel.rs:538-558)."""
        return len(self.leaves) + sum(c.leaves_count() for c in self.children)


def _random_rgba(rng) -> np.ndarray:
    # Rgba::new_randomly (wgpu_base.rs:32-35): random b, g, r; a = 255.
    return np.array(
        [rng.integers(0, 256), rng.integers(0, 256), rng.integers(0, 256), 255],
        np.uint8,
    )


def gen_randomly(level: int, rng=None) -> Voxel:
    """Random SVO: 70% occupancy, 30% leaf chance above level 0
    (voxel.rs:492-516)."""
    if rng is None:
        rng = np.random.default_rng()
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


def new_full() -> Voxel:
    """voxel.rs:470-477."""
    v = Voxel(valid_mask=255, leaf_mask=255)
    v.leaves = [Leaf(color=np.array([255, 255, 255, 255], np.uint8)) for _ in range(8)]
    return v


@dataclasses.dataclass
class SvoArrays:
    """Flat array form: node-table SVO for device-side traversal.

    - valid_mask, leaf_mask: (N,) i32
    - child_index: (N, 8) i32 — node id of octant i's child, -1 if none
    - leaf_color: (N, 8, 4) u8 — color when octant i is a leaf
    """

    valid_mask: np.ndarray
    leaf_mask: np.ndarray
    child_index: np.ndarray
    leaf_color: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.valid_mask.shape[0])


def flatten(root: Voxel) -> SvoArrays:
    """Breadth-first flatten of the pointer octree into index arrays."""
    nodes = [root]
    order = {id(root): 0}
    queue = [root]
    while queue:
        n = queue.pop(0)
        for c in n.children:
            order[id(c)] = len(nodes)
            nodes.append(c)
            queue.append(c)
    count = len(nodes)
    valid = np.zeros(count, np.int32)
    leafm = np.zeros(count, np.int32)
    child = np.full((count, 8), -1, np.int32)
    color = np.zeros((count, 8, 4), np.uint8)
    for ni, n in enumerate(nodes):
        valid[ni] = n.valid_mask
        leafm[ni] = n.leaf_mask
        ci = 0
        li = 0
        for i in range(8):
            bit = 1 << i
            if not (n.valid_mask & bit):
                continue
            if n.leaf_mask & bit:
                color[ni, i] = n.leaves[li].color
                li += 1
            else:
                child[ni, i] = order[id(n.children[ci])]
                ci += 1
    return SvoArrays(valid, leafm, child, color)


def _octant_offset(i: int):
    """Bit layout from get_sub_cube_range (voxel.rs:396-411)."""
    return (i & 1, (i >> 2) & 1, (i >> 1) & 1)  # (dx, dy, dz)


def densify(root: Voxel, level: int):
    """Expand the SVO into a dense grid of resolution R = 2^(level+1).

    Returns ``(color (R, R, R, 4) u8 indexed [ix, iy, iz], hit (R, R, R)
    bool)``. Point queries on the grid (cell = floor(pos / cell_size)) agree
    exactly with find_leaf's half-open recursive descent (voxel.rs:357-394)
    because all cell boundaries are binary fractions of the cube length.
    """
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


def find_leaf_scalar(root: Voxel, length: float, pos) -> np.ndarray | None:
    """Scalar oracle of VoxelCube::find_leaf (voxel.rs:357-394)."""
    pos = np.asarray(pos, np.float32)

    def check_inside(rx, ry, rz, l, p):
        return (
            rx <= p[0] < rx + l and ry <= p[1] < ry + l and rz <= p[2] < rz + l
        )

    def rec(node, rx, ry, rz, l):
        ci = 0
        li = 0
        for i in range(8):
            bit = 1 << i
            if not (node.valid_mask & bit):
                continue
            is_leaf = bool(node.leaf_mask & bit)
            dx, dy, dz = _octant_offset(i)
            half = np.float32(l * 0.5)
            sx, sy, sz = (
                np.float32(rx + dx * half),
                np.float32(ry + dy * half),
                np.float32(rz + dz * half),
            )
            if check_inside(sx, sy, sz, half, pos):
                if is_leaf:
                    return node.leaves[li].color
                return rec(node.children[ci], sx, sy, sz, half)
            if is_leaf:
                li += 1
            else:
                ci += 1
        return None

    return rec(root, np.float32(0), np.float32(0), np.float32(0), np.float32(length))
