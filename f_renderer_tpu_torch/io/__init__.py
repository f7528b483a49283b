"""Asset IO: OBJ meshes, PNG/TGA textures, image export, scene files."""

from f_renderer_tpu_torch.io.image import load_texture, save_npy, save_png
from f_renderer_tpu_torch.io.obj import Model, load_obj
from f_renderer_tpu_torch.io.scene_io import load_scene, save_scene

__all__ = ["Model", "load_obj", "load_scene", "load_texture", "save_npy", "save_png", "save_scene"]
