"""Wavefront OBJ loader (reference: obj_loader.rs:15-97).

A copy of ``f_renderer_tpu/io/obj.py`` (numpy only), so the port imports
nothing of the JAX package.

Parses ``v``/``vn``/``vt``/``f`` records. Faces are triangles only — exactly
indices 1..4 of an ``f`` line are read (obj_loader.rs:58), each a
``pos/uv/norm`` 1-based triple converted to 0-based (obj_loader.rs:60-64).

Unlike the reference's per-face AoS accessors (phong.rs:187-201), the model
exposes SoA arrays plus a `corners()` gather producing the per-face-corner
arrays the batched geometry stage consumes directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Model:
    verts: np.ndarray  # (V, 3) f32
    norms: np.ndarray  # (N, 3) f32
    uvs: np.ndarray  # (T, 2) f32
    faces: np.ndarray  # (F, 3, 3) i32 — [face, corner, (pos, uv, norm)]

    @property
    def faces_len(self) -> int:
        return int(self.faces.shape[0])

    def vert(self, i_face: int, nth_vert: int) -> np.ndarray:
        """obj_loader.rs:84-86."""
        return self.verts[self.faces[i_face, nth_vert, 0]]

    def uv(self, i_face: int, nth_vert: int) -> np.ndarray:
        """obj_loader.rs:89-91."""
        return self.uvs[self.faces[i_face, nth_vert, 1]]

    def normal(self, i_face: int, nth_vert: int) -> np.ndarray:
        """obj_loader.rs:94-96 — re-normalized on access."""
        n = self.norms[self.faces[i_face, nth_vert, 2]]
        return n / np.linalg.norm(n)

    def corners(self) -> dict:
        """Gather per-face-corner SoA arrays for the batched pipeline.

        Returns ``{"pos": (F,3,3), "uv": (F,3,2), "normal": (F,3,3)}`` f32,
        normals normalized (matching obj_loader.rs:95).
        """
        pos = self.verts[self.faces[:, :, 0]]
        uv = self.uvs[self.faces[:, :, 1]]
        normal = self.norms[self.faces[:, :, 2]]
        normal = normal / np.linalg.norm(normal, axis=-1, keepdims=True)
        return {
            "pos": pos.astype(np.float32),
            "uv": uv.astype(np.float32),
            "normal": normal.astype(np.float32),
        }


def load_obj(path: str, verbose: bool = False) -> Model:
    """Parse an OBJ file (obj_loader.rs:15-74)."""
    verts, norms, uvs, faces = [], [], [], []
    with open(path, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")  # from_utf8_lossy
    for line in text.split("\n"):
        parts = line.split(" ")
        if not parts:
            continue
        tag = parts[0]
        if tag == "v":
            verts.append([float(parts[i].replace("\r", "")) for i in (1, 2, 3)])
        elif tag == "vn":
            norms.append([float(parts[i].replace("\r", "")) for i in (1, 2, 3)])
        elif tag == "vt":
            uvs.append([float(parts[i].replace("\r", "")) for i in (1, 2)])
        elif tag == "f":
            face = []
            for i in (1, 2, 3):  # triangles only (obj_loader.rs:58)
                triple = parts[i].split("/")
                face.append(
                    [int(t.replace("\r", "")) - 1 for t in triple[:3]]
                )
            faces.append(face)
    model = Model(
        verts=np.asarray(verts, np.float32).reshape(-1, 3),
        norms=np.asarray(norms, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        faces=np.asarray(faces, np.int32).reshape(-1, 3, 3),
    )
    if verbose:
        print(f"v: {model.verts.shape[0]}, faces: {model.faces.shape[0]}")
    return model
