"""Camera (reference: camera.rs) plus orbit/pan/zoom controls (phong.rs:217-311).

PyTorch port of ``f_renderer_tpu/camera.py``: an immutable eye/at/up
dataclass of (3,) float32 tensors on one device; the controls return a new
camera.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from f_renderer_tpu_torch.device import resolve_device
from f_renderer_tpu_torch.math import mat_vec4, normalize, set_look_at, set_rotate
from f_renderer_tpu_torch.math.transforms import _cross, _dot3


@dataclasses.dataclass(frozen=True)
class Camera:
    """eye/at/up camera (camera.rs:4-9)."""

    eye: torch.Tensor
    at: torch.Tensor
    up: torch.Tensor

    @staticmethod
    def create(eye, at, up, device="cuda") -> "Camera":
        device = resolve_device(device)

        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        return Camera(eye=f32(eye), at=f32(at), up=f32(up))

    def look_at(self) -> torch.Tensor:
        """View matrix (camera.rs:12-19 → matrix_util.rs:11)."""
        return set_look_at(self.eye, self.at, self.up)


def zoom(camera: Camera, scroll_y, min_dist=-1.0, max_dist=20.0) -> Camera:
    """Mouse-wheel zoom along the view axis with the reference's distance
    clamp ``(-1 < d && y > 0) || (d < 20 && y < 0)`` (phong.rs:222-235)."""
    scroll_y = torch.as_tensor(scroll_y, dtype=torch.float32, device=camera.eye.device)
    rel = camera.eye - camera.at
    forward = normalize(rel)
    distance = torch.sqrt(_dot3(rel, rel))
    allowed = ((distance > min_dist) & (scroll_y > 0)) | (
        (distance < max_dist) & (scroll_y < 0)
    )
    new_eye = forward * (distance - scroll_y * 0.2) + camera.at
    return dataclasses.replace(camera, eye=torch.where(allowed, new_eye, camera.eye))


def orbit(camera: Camera, delta_x, delta_y, ratio=0.005) -> Camera:
    """Right-mouse-drag orbit around ``at`` (phong.rs:287-298)."""
    dev = camera.eye.device
    delta_x = torch.as_tensor(delta_x, dtype=torch.float32, device=dev)
    delta_y = torch.as_tensor(delta_y, dtype=torch.float32, device=dev)
    forward = camera.at - camera.eye
    right = normalize(_cross(forward, camera.up))
    rot_h = set_rotate(camera.up, delta_x * math.pi * ratio)
    rot_v = set_rotate(right, -delta_y * math.pi * ratio)
    f4 = torch.cat([forward, torch.ones(1, device=dev)])
    f4 = mat_vec4(rot_h, f4)
    f4 = mat_vec4(rot_v, f4)
    new_forward = f4[:3]
    up = normalize(_cross(right, new_forward))
    return dataclasses.replace(camera, eye=camera.at - new_forward, up=up)


def pan(camera: Camera, delta_x, delta_y, ratio=0.01) -> Camera:
    """Middle-mouse-drag pan in the view plane (phong.rs:299-305)."""
    forward = camera.at - camera.eye
    right = normalize(_cross(forward, camera.up))
    up = normalize(camera.up)
    offset = (up * float(delta_y) + right * float(delta_x)) * ratio
    return dataclasses.replace(camera, eye=camera.eye - offset, at=camera.at - offset)
