"""The triangle soup mesh kind: ``n_tris`` triangles in a ``box``; its
positions come from the run's seed.

A frozen copy of the port's numpy builder (``scene.py``:
``make_instanced_soup``), itself a copy of the JAX package's; found by a
mesh's ``kind`` in a configuration.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenes import seed_stream


def make_instanced_soup(n_tris: int, seed: int = 0, spread: float = 8.0, size: float = 0.08,
                        box: float | None = None) -> dict:
    """Random triangle soup (stress4k: one million triangles, ``box=3.2``):
    centres uniform in [-box, box]³, corners within ±0.8 · size of them."""
    rng = np.random.default_rng(seed)
    if box is not None:
        centers = rng.uniform(-box, box, (n_tris, 3)).astype(np.float32)
    else:
        centers = rng.uniform([-spread, -spread, 2.0], [spread, spread, 30.0], (n_tris, 3)).astype(np.float32)
    offs = rng.uniform(-size * 10, size * 10, (n_tris, 3, 3)).astype(np.float32)
    pos = centers[:, None, :] + offs * size / 0.08 * 0.08
    normal = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    nn = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = (normal / np.where(nn == 0, 1, nn)).astype(np.float32)
    uv = rng.random((n_tris, 3, 2)).astype(np.float32)
    return {"pos": pos.astype(np.float32), "uv": uv, "normal": np.repeat(normal[:, None, :], 3, axis=1)}


def build(spec: dict, seed: int) -> dict:
    soup_seed = int(seed_stream(seed, "soup").integers(0, 2**63))
    return make_instanced_soup(spec["n_tris"], seed=soup_seed, box=spec["box"])
