"""Shader API, builtin shaders and textures."""

from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.builtin import (
    FlatShader,
    make_gouraud_shaders,
    make_phong_shaders,
    make_textured_shaders,
)
from f_renderer_tpu_torch.shaders.texture import TextureStack

__all__ = [
    "ContextCodec",
    "FlatShader",
    "TextureStack",
    "make_gouraud_shaders",
    "make_phong_shaders",
    "make_textured_shaders",
]
