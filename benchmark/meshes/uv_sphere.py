"""The UV sphere mesh kind: ``n_lat``, ``n_lon``, ``radius``.

A frozen copy of the port's numpy builder (``scene.py``: ``make_uv_sphere``), itself
a copy of the JAX package's; found by a mesh's ``kind`` in a
configuration.
"""

from __future__ import annotations

import numpy as np


def make_uv_sphere(n_lat: int = 36, n_lon: int = 72, radius: float = 1.0) -> dict:
    """UV sphere (2·n_lat·n_lon triangles) with smooth normals and uvs."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    p = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], axis=-1).astype(np.float32)
    uvg = np.stack([(ph / (2 * np.pi)).astype(np.float32), (th / np.pi).astype(np.float32)], axis=-1)
    pos, uv, normal = [], [], []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b, c, d = p[i, j], p[i + 1, j], p[i + 1, j + 1], p[i, j + 1]
            ua, ub, uc, ud = uvg[i, j], uvg[i + 1, j], uvg[i + 1, j + 1], uvg[i, j + 1]
            for tri_p, tri_u in (((a, b, c), (ua, ub, uc)), ((a, c, d), (ua, uc, ud))):
                pos.append(np.stack(tri_p))
                uv.append(np.stack(tri_u))
                normal.append(np.stack(tri_p))  # unit sphere: normal = pos
    return {"pos": np.stack(pos) * radius, "uv": np.stack(uv), "normal": np.stack(normal)}


def build(spec: dict, seed: int) -> dict:
    return make_uv_sphere(spec["n_lat"], spec["n_lon"], spec.get("radius", 1.0))
