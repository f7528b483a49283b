"""State carried across from the JAX package, given as numpy arrays.

The caller turns the JAX objects into numpy (``np.asarray``), so this
module needs no JAX. With these, a test hands both packages the same scene
or the same triangle buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from f_renderer_tpu_torch.pipeline.render import RenderConfig
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.device import resolve_device
from f_renderer_tpu_torch.scene import SHADERS, Scene
from f_renderer_tpu_torch.shaders.texture import TextureStack


def _tensor(a, device):
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def scene_from_arrays(
    draws: Sequence[Mapping[str, np.ndarray]],
    vs_uniform: Mapping[str, np.ndarray],
    ps_uniform: Mapping,
    shader_kind: str,
    config: Mapping,
    device="cuda",
) -> Scene:
    """A port Scene from a JAX scene's state.

    ``draws``: per draw, attribute name → (F, 3, k) array.
    ``vs_uniform``: name → array ("model", "view", "proj", maybe "view_pos").
    ``ps_uniform``: {"textures": {"data": (T, Hmax, Wmax, 4), "dims": (T, 2)}
    (optional), "view_pos": (3,)}.
    ``shader_kind``: "phong" | "gouraud" | "textured" | "flat".
    ``config``: RenderConfig fields by name (the port's subset).
    """
    device = resolve_device(device)
    vs, ps = SHADERS[shader_kind]()
    ps_u = {"view_pos": _tensor(np.asarray(ps_uniform["view_pos"], np.float32), device)}
    tex = ps_uniform.get("textures")
    if tex is not None:
        ps_u["textures"] = TextureStack.from_data(tex["data"], tex["dims"], device=device)
    return Scene(
        draws=[{k: _tensor(v, device) for k, v in d.items()} for d in draws],
        vertex_shader=vs,
        pixel_shader=ps,
        vs_uniform={k: _tensor(v, device) for k, v in vs_uniform.items()},
        ps_uniform=ps_u,
        config=RenderConfig(**config),
        device=device,
    )


def triangles_from_arrays(fields: Mapping[str, np.ndarray], device="cuda") -> TriangleBuffer:
    """A port TriangleBuffer from a JAX ``TriangleBuffer``'s fields by name."""
    device = resolve_device(device)
    return TriangleBuffer(
        **{f.name: _tensor(fields[f.name], device) for f in dataclasses.fields(TriangleBuffer)}
    )
