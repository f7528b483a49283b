#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (f_renderer_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. identity — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build — the CUDA kernels, compiled with nvcc from ``csrc/``;
3. the fused kernel (K1, with the K2 sampler inside) against its plain
   PyTorch version on the card: phong1080 at the bench angles 0.10 / 0.15 /
   0.20, plus small scenes for the coarse/spill ranges (bin_k=1), a texture
   wider than 128 px and the flat / gouraud / textured kinds. Winner ids
   bit-equal, depth within rtol 2.4e-7, colour within 2 u8 with at most 0.2%
   of pixels at 2. Kernel and plain times from CUDA events;
4. the main path — ``Scene.render()`` on phong1080 for several frames; the
   kernel's launch count must equal the frame count;
5. one JSON line describing the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without CUDA, or without the port
beside it, the script exits non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

FRAMES = 10
ANGLES = (0.10, 0.15, 0.20)  # bench.py's first three frame angles
DEPTH_RTOL = 2.4e-7


def log(*parts):
    print(*parts, flush=True)


def build_scene(name, device):
    """The bench scenes the port runs, built with the port's own builders."""
    import numpy as np

    from f_renderer_tpu_torch import Camera, make_checker_texture, make_cube
    from f_renderer_tpu_torch import make_phong_scene, make_uv_sphere

    cam = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    sphere_cam = Camera.create([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])

    def three_meshes():
        cube = make_cube(0.8)
        cube["pos"] = cube["pos"] + np.array([1.6, 0.0, 0.0], np.float32)
        cube2 = make_cube(0.8)
        cube2["pos"] = cube2["pos"] + np.array([-1.6, 0.0, 0.0], np.float32)
        return [make_uv_sphere(40, 80), cube, cube2]

    if name == "phong1080":  # bench.py:105-129
        return make_phong_scene(
            1920, 1080, clip_cap=64, meshes=three_meshes(), camera=cam, device=device,
            textures=[make_checker_texture(512, 32), make_checker_texture(512, 16),
                      make_checker_texture(512, 24)],
        )
    if name == "phong_bin_k1":  # coarse and spill ranges
        scene = make_phong_scene(
            640, 360, clip_cap=64, meshes=three_meshes(), camera=cam, device=device,
            textures=[make_checker_texture(64, 8)] * 3,
        )
        scene.config = dataclasses.replace(scene.config, tile=(16, 128), bin_k=1)
        return scene
    if name == "textured_wide":  # a 300-px texture (three TPU lane pages)
        return make_phong_scene(
            800, 600, clip_cap=64, meshes=[make_uv_sphere(24, 48)], camera=sphere_cam,
            textures=[make_checker_texture(300, 20)], shader="textured", device=device,
        )
    if name == "gouraud800":  # bench.py:83-94
        return make_phong_scene(
            800, 600, clip_cap=64, meshes=[make_uv_sphere(36, 72)], camera=sphere_cam,
            shader="gouraud", device=device,
        )
    if name == "cube1080_flat":  # bench.py:67-82
        return make_phong_scene(
            1920, 1080, clip_cap=16, meshes=[make_cube()], camera=cam, shader="flat",
            device=device,
        )
    raise ValueError(name)


def set_angle(scene, angle):
    from f_renderer_tpu_torch.math import set_rotate

    scene.vs_uniform = dict(scene.vs_uniform, model=set_rotate([0.0, 1.0, 0.0], angle, scene.device))


def cuda_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(tag, got, want):
    """Kernel vs plain on the same inputs; raises on disagreement."""
    import torch

    frame_g, depth_g, winner_g = got
    frame_w, depth_w, winner_w = want
    if not torch.equal(winner_g, winner_w):
        n = int((winner_g != winner_w).sum())
        raise AssertionError(f"{tag}: winner differs at {n} pixels")
    derr = (depth_g - depth_w).abs()
    if not bool((derr <= DEPTH_RTOL * depth_w.abs()).all()):
        raise AssertionError(f"{tag}: depth beyond rtol {DEPTH_RTOL}: max abs {float(derr.max())}")
    diff = (frame_g.int() - frame_w.int()).abs().amax(-1)
    at2 = float((diff > 1).float().mean())
    if int(diff.max()) > 2 or at2 > 0.002:
        raise AssertionError(f"{tag}: frame max diff {int(diff.max())} u8, {at2:.4%} at 2")
    covered = int((winner_g >= 0).sum())
    log(f"  {tag}: winner equal, depth max abs err {float(derr.max()):.3g}, "
        f"frame max diff {int(diff.max())} u8 ({at2:.4%} at 2), covered px {covered}")
    return int(diff.max()), float(derr.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    try:
        from f_renderer_tpu_torch import kernels
        from f_renderer_tpu_torch.pipeline import fused
        from f_renderer_tpu_torch.pipeline.render import build_triangles
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    # 1. identity
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log("[identity]", smi)
    log(f"[identity] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.time()
    kernels.load_library()
    log(f"[build] nvcc sm_90a --fmad=false: {time.time() - t0:.1f} s")

    # 3. K1 (+K2) against plain on the card
    log("[kernel-vs-plain]")
    worst_frame, worst_depth = 0, 0.0
    timing = None
    cases = [("phong1080", a) for a in ANGLES] + [
        ("phong_bin_k1", 0.3), ("textured_wide", 0.2), ("gouraud800", 0.1), ("cube1080_flat", 0.1),
    ]
    for scene_name, angle in cases:
        scene = build_scene(scene_name, dev)
        set_angle(scene, angle)
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        prep = fused.prep_fused(tri, scene.config)
        args = (prep, scene.pixel_shader, scene.ps_uniform, scene.config)
        got = fused.render_fused_prepared(*args)
        torch.cuda.synchronize()
        want = fused.render_fused_plain(*args)
        f_err, d_err = compare(f"{scene_name}@{angle:.2f} th={prep.th} pairs={prep.tri_i32.shape[1]}", got, want)
        worst_frame, worst_depth = max(worst_frame, f_err), max(worst_depth, d_err)
        if scene_name == "phong1080" and timing is None:
            reference_frame = got[0].clone()
            plain_a = cuda_ms(lambda: fused.render_fused_plain(*args), 2)
            kern_a = cuda_ms(lambda: fused.render_fused_prepared(*args), 20)
            kern_b = cuda_ms(lambda: fused.render_fused_prepared(*args), 20)
            plain_b = cuda_ms(lambda: fused.render_fused_plain(*args), 2)
            timing = ((kern_a + kern_b) / 2, (plain_a + plain_b) / 2)
            log(f"  phong1080 K1 time: kernel {kern_a:.4f} / {kern_b:.4f} ms, "
                f"plain {plain_a:.2f} / {plain_b:.2f} ms (CUDA events; {smi})")

    # 4. the main path: Scene.render() on phong1080
    scene = build_scene("phong1080", dev)
    set_angle(scene, ANGLES[0])
    scene.render()  # warm-up (allocator, first-use costs)
    torch.cuda.synchronize()
    kernels.fused_raster.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    checksum = 0
    frames = []
    t_host = time.time()
    start.record()
    for i in range(FRAMES):
        set_angle(scene, 0.10 + 0.05 * i)
        frame, depth, stats = scene.render()
        frames.append((frame, depth, stats))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.time() - t_host) * 1e3 / FRAMES
    launches = kernels.fused_raster.launches
    frame_ms = start.elapsed_time(end) / FRAMES
    if launches != FRAMES:
        raise AssertionError(f"main path launched the kernel {launches} times for {FRAMES} frames")
    for frame, depth, stats in frames:
        checksum += int(frame[::97, ::89, 0].int().sum())
        if tuple(frame.shape) != (1080, 1920, 4) or not bool(torch.isfinite(depth).all()):
            raise AssertionError("main path frame has the wrong shape or a non-finite depth")
        shaded = int((frame[..., :3] != 30).any(-1).sum())
        if not 0.05 * 1920 * 1080 < shaded < 0.9 * 1920 * 1080:
            raise AssertionError(f"implausible shaded pixel count {shaded}")
        if int(stats["num_clipped"]) > scene.config.clip_cap:
            raise AssertionError("clip_cap dropped faces")
    if not torch.equal(frames[0][0], reference_frame):
        raise AssertionError("Scene.render() at angle 0.10 differs from the checked kernel frame")
    mpix = 1920 * 1080 / frame_ms / 1e3
    log(f"[main-path] phong1080 Scene.render() x{FRAMES}: launches {launches}, "
        f"frame {frame_ms:.3f} ms (CUDA events), host {host_ms:.3f} ms/frame, "
        f"{mpix:.1f} Mpix/s, shaded px {shaded}, checksum {checksum} ({smi})")

    # 5. results
    log(json.dumps({"kernels": [{
        "name": "fused_raster_shade (K1, K2 sampler inlined)",
        "route": "cuda",
        "source": "f_renderer_tpu_torch/csrc/fused_raster.cu",
        "replaces": "f_renderer_tpu/pipeline/fused.py:525",
        "also_replaces": "f_renderer_tpu/shaders/texture_pallas.py:95 (csrc/sampler.cuh)",
        "launches": launches,
        "max_abs_err": worst_frame,  # frame, in u8 steps
        "max_abs_err_depth": worst_depth,
        "ms": timing[0],
        "plain_ms": timing[1],
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
