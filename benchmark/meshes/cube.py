"""The cube mesh kind: ``size``.

A frozen copy of the port's numpy builder (``scene.py``: ``make_cube``), itself
a copy of the JAX package's; found by a mesh's ``kind`` in a
configuration.
"""

from __future__ import annotations

import numpy as np


def make_cube(size: float = 1.0) -> dict:
    """12-triangle cube with per-face normals and uvs; corners (12, 3, ...)."""
    s = size * 0.5
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float32)
    quads = [
        ((0, 1, 3, 2), (-1, 0, 0)),
        ((4, 6, 7, 5), (1, 0, 0)),
        ((0, 4, 5, 1), (0, -1, 0)),
        ((2, 3, 7, 6), (0, 1, 0)),
        ((0, 2, 6, 4), (0, 0, -1)),
        ((1, 5, 7, 3), (0, 0, 1)),
    ]
    pos, normal, uv = [], [], []
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    for idx, n in quads:
        for tri in ((0, 1, 2), (0, 2, 3)):
            pos.append(v[[idx[t] for t in tri]])
            uv.append(quad_uv[list(tri)])
            normal.append(np.tile(np.asarray(n, np.float32), (3, 1)))
    return {"pos": np.stack(pos), "uv": np.stack(uv), "normal": np.stack(normal)}


def build(spec: dict, seed: int) -> dict:
    return make_cube(spec["size"])
