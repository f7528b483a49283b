"""Scene files: the port's ``Scene`` to and from one ``.npz``.

Port of ``f_renderer_tpu/io/scene_io.py`` in the same format, so a file
that either package writes loads in the other: mesh draws, vertex and pixel
uniforms, the texture stack as its padded (T, Hmax, Wmax, 4) float32 data
(k/255) and (T, 2) dims, the builtin shader's kind and light parameters, and
the JAX package's config fields, as JSON in ``__meta__``.

``config.backend`` in a file is the JAX package's choice ("pallas" or
"jnp"); it does not pick the port's path. The port writes "pallas" for its
``"kernels"`` backend and "jnp" for ``"portable"``, and on load takes its
default, ``"kernels"``. A port config whose tile is the ``None`` default
writes the JAX default (32, 128) with ``"tile_default": true``, which the
JAX package ignores and the port reads back as ``None``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

JAX_BACKEND = {"kernels": "pallas", "portable": "jnp"}


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def texture_data(stack) -> np.ndarray:
    """A port ``TextureStack``'s texels as the JAX package's ``data``:
    (T, Hmax, Wmax, 4) float32, each channel u8 / 255."""
    packed = _np(stack.texels).astype(np.int32).view(np.uint32)
    q = np.stack([(packed >> (8 * c)) & 0xFF for c in range(4)], axis=-1)
    return q.astype(np.float32) / 255.0


def save_scene(path: str, scene) -> None:
    """Write a port ``Scene`` to ``path`` (.npz).

    Only builtin shaders (flat / gouraud / textured / phong, known by their
    ``fused_kind``) serialize: a custom shader has no stable on-disk form,
    so callers re-attach it after loading.
    """
    kind = getattr(scene.pixel_shader, "fused_kind", None)
    if kind not in ("flat", "gouraud", "textured", "phong"):
        raise ValueError(
            "save_scene only serializes the builtin shader kinds "
            "(flat/gouraud/textured/phong); got pixel_shader without a "
            "builtin fused_kind tag — re-attach custom shaders on load "
            "instead"
        )
    shader_meta = {"kind": kind}
    for attr in ("light_pos", "light_color"):
        val = getattr(scene.pixel_shader, attr, None)
        if val is not None:
            shader_meta[attr] = [float(v) for v in val]
    cfg = scene.config
    meta = {
        "num_draws": len(scene.draws),
        "draw_keys": [sorted(d.keys()) for d in scene.draws],
        "shader": shader_meta,
        "config": {
            "width": cfg.width,
            "height": cfg.height,
            "background": list(cfg.background),
            "clip_cap": cfg.clip_cap,
            "tile": list(cfg.tile) if cfg.tile is not None else [32, 128],
            "tile_default": cfg.tile is None,
            "backend": JAX_BACKEND[cfg.backend],
            "replicate_ps_boundary_quirk": cfg.replicate_ps_boundary_quirk,
        },
    }
    arrays = {}
    for i, d in enumerate(scene.draws):
        for k, v in d.items():
            arrays[f"draw{i}_{k}"] = _np(v)
    for k, v in scene.vs_uniform.items():
        arrays[f"vs_{k}"] = _np(v)
    tex = scene.ps_uniform.get("textures")
    if tex is not None:
        arrays["tex_data"] = texture_data(tex)
        arrays["tex_dims"] = _np(tex.dims)
    for k, v in scene.ps_uniform.items():
        if k != "textures":
            arrays[f"ps_{k}"] = _np(v)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_scene(path: str, device="cuda"):
    """Load a scene file written by either package into a port ``Scene`` on
    ``device``, with its builtin shader pair (kind and light parameters)
    re-attached. Files without a shader record load as Phong."""
    from f_renderer_tpu_torch.device import resolve_device
    from f_renderer_tpu_torch.pipeline.render import RenderConfig
    from f_renderer_tpu_torch.scene import Scene
    from f_renderer_tpu_torch.shaders import (
        FlatShader,
        TextureStack,
        make_gouraud_shaders,
        make_phong_shaders,
        make_textured_shaders,
    )

    device = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())

        def tensor(key):
            return torch.from_numpy(np.array(z[key])).to(device)

        draws = [{k: tensor(f"draw{i}_{k}") for k in keys} for i, keys in enumerate(meta["draw_keys"])]
        vs_uniform = {k[3:]: tensor(k) for k in z.files if k.startswith("vs_")}
        ps_uniform = {k[3:]: tensor(k) for k in z.files if k.startswith("ps_")}
        if "tex_data" in z.files:
            ps_uniform["textures"] = TextureStack.from_data(z["tex_data"], z["tex_dims"], device=device)
    c = meta["config"]
    sh = meta.get("shader", {"kind": "phong"})
    light_kw = {k: tuple(sh[k]) for k in ("light_pos", "light_color") if k in sh}
    kind = sh["kind"]
    if kind == "flat":
        vs, ps = FlatShader.vertex, FlatShader.pixel
    elif kind == "textured":
        vs, ps = make_textured_shaders()
    elif kind == "gouraud":
        vs, ps = make_gouraud_shaders(**light_kw)
    else:
        vs, ps = make_phong_shaders(**light_kw)
    return Scene(
        draws=draws,
        vertex_shader=vs,
        pixel_shader=ps,
        vs_uniform=vs_uniform,
        ps_uniform=ps_uniform,
        config=RenderConfig(
            width=c["width"],
            height=c["height"],
            background=tuple(c["background"]),
            clip_cap=c["clip_cap"],
            tile=None if c.get("tile_default") else tuple(c["tile"]),
            replicate_ps_boundary_quirk=c["replicate_ps_boundary_quirk"],
        ),
        device=device,
    )
