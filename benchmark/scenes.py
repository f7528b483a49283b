"""The triangle scenes' inputs, made from the run's seed on the host.

Each mesh of a configuration is built by the module of its ``kind``,
``meshes/<kind>.py`` (``build(spec, seed)``), found by name. The texture
function is a frozen copy of the port's numpy one (``scene.py``:
``make_checker_texture``), itself a copy of the JAX package's. The
harness hands these arrays to the port's public constructor and the same
arrays to the plain reference, so both sides render the same inputs.
Nothing here imports the port.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


def make_checker_texture(n: int = 64, cell: int = 4) -> np.ndarray:
    tex = np.zeros((n, n, 4), np.float32)
    ix = np.arange(n)
    mask = (ix[:, None] // cell + ix[None, :] // cell) % 2 == 0
    tex[mask] = [0.85, 0.65, 0.25, 1.0]
    tex[~mask] = [0.25, 0.45, 0.85, 1.0]
    return tex


def seed_stream(seed: int, purpose: str) -> np.random.Generator:
    """An independent generator for one purpose of one run's seed (any
    non-negative integer, however large)."""
    return np.random.default_rng([seed, *purpose.encode()])


def noisy_texture(spec: dict, noise: float, rng: np.random.Generator) -> np.ndarray:
    """The config's checker texture with seeded RGB noise, quantized to
    RGBA8 as the reference's textures are u8 images; alpha stays 255, so
    the stack is opaque."""
    tex = make_checker_texture(spec["n"], spec["cell"])
    tex[..., :3] += rng.uniform(-noise, noise, tex[..., :3].shape).astype(np.float32)
    return np.clip(np.round(np.clip(tex, 0.0, 1.0) * 255.0), 0, 255).astype(np.uint8)


def build_mesh(spec: dict, seed: int) -> dict:
    """The mesh of ``spec`` by its kind's module, moved by its ``offset``."""
    mesh = importlib.import_module(f"benchmark.meshes.{spec['kind']}").build(spec, seed)
    offset = np.asarray(spec.get("offset", (0.0, 0.0, 0.0)), np.float32)
    mesh["pos"] = (mesh["pos"] + offset).astype(np.float32)
    return mesh


@dataclasses.dataclass
class SceneInputs:
    """What a run renders: the meshes (dicts of (F, 3, k) float32 arrays),
    ``stacks`` texture stacks (each a list of (h, w, 4) uint8 arrays, one a
    mesh) and the start of the angle schedule."""

    meshes: list
    stacks: list
    start: int


def scene_inputs(config: dict, seed: int, stacks: int = 1, turn_steps: int = 1) -> SceneInputs:
    """The config's meshes and ``stacks`` texture stacks made from ``seed``,
    and a start step in ``[0, turn_steps)``. Shapes never depend on the
    seed; only values do."""
    meshes = [build_mesh(m, seed) for m in config["meshes"]]
    tex_rng = seed_stream(seed, "textures")
    out = [[noisy_texture(t, config["texel_noise"], tex_rng) for t in config["textures"]] for _ in range(stacks)]
    start = int(seed_stream(seed, "start").integers(0, turn_steps))
    return SceneInputs(meshes, out, start)
