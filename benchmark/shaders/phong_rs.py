"""phong.rs's pixel shader (examples/src/bin/phong.rs:133-154) as a user of
the port writes it: plain torch on the port's planar contract, no
``fused_kind``, so the port calls it as it is, once over the whole frame.

The contract (``pipeline/shade.py``): ``ctx`` maps each varying of the
vertex stage to its (k, H, W) planes (here the builtin Phong vertex
stage's ``normal``, world ``pos`` and ``uv``); ``u`` is the scene's
``ps_uniform``, with ``u["textures"].sample(index, u, v)`` the bilinear
sampler and ``u["view_pos"]`` the eye; ``ps_index`` (H, W) is each pixel's
texture id. It returns (4, H, W) rgba in [0, 1].

The lighting is phong.rs's: white light at (1.2, 1.0, 2.0), ambient 0.1,
specular 0.5 · max(V·R, 0)^32, with the reference's own ``reflect``
(vector_util.rs:4-7: ``normalize(2 (L·N) N - L)``, called with
``-light_dir``), times the sampled texel, whose alpha it keeps. Nothing
here imports the port.
"""

import torch

LIGHT_POS = (1.2, 1.0, 2.0)
LIGHT_COLOR = (1.0, 1.0, 1.0)
AMBIENT_STRENGTH = 0.1
SPECULAR_STRENGTH = 0.5
SHININESS = 32


def dot(a, b):
    return (a * b).sum(dim=0, keepdim=True)


def normalize(v):
    return v / torch.linalg.vector_norm(v, dim=0, keepdim=True)


def reflect(light, normal):
    return normalize(2.0 * dot(light, normal) * normal - light)


def pixel(u, ctx, ps_index):
    frag_pos, dev = ctx["pos"], ctx["pos"].device
    light_color = torch.tensor(LIGHT_COLOR, device=dev).view(3, 1, 1)
    light_pos = torch.tensor(LIGHT_POS, device=dev).view(3, 1, 1)
    view_pos = u["view_pos"].view(3, 1, 1)

    ambient = AMBIENT_STRENGTH * light_color
    norm = normalize(ctx["normal"])
    light_dir = normalize(light_pos - frag_pos)
    diffuse = torch.clamp(dot(norm, light_dir), min=0.0) * light_color
    view_dir = normalize(view_pos - frag_pos)
    reflect_dir = reflect(-light_dir, norm)
    spec = torch.clamp(dot(view_dir, reflect_dir), min=0.0) ** SHININESS
    specular = SPECULAR_STRENGTH * spec * light_color

    texel = u["textures"].sample(ps_index, ctx["uv"][0], ctx["uv"][1])
    return torch.cat([(ambient + diffuse + specular) * texel[:3], texel[3:]])
