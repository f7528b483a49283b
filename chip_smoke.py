#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (f_renderer_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. identity: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the CUDA kernels, one nvcc per source, all started together,
   and each kernel's registers, spills and shared memory (``ptxas -v``);
3. every kernel against its plain PyTorch version on the card, on the same
   inputs, at the shapes its main path gives it (no plain run may move a
   launch counter):
   - K1, the fused raster + shade kernel with the K2 sampler inside:
     phong1080 at the bench angles 0.10 / 0.15 / 0.20 and five small
     scenes (coarse/spill ranges, a wide texture, flat / gouraud /
     textured, and sliver640: slivers and 1-pixel triangles on the edges
     of the warps' rectangles and of the tiles, in all three ranges).
     Winner ids bit-equal, depth within rtol 2.4e-7, colour within 2 u8
     with at most 0.2% of pixels at 2. On four phong1080 tiles (the pole
     tile among them) K1's winner and depth also against
     ``rasterize_portable``, which bins nothing;
   - the raster kernels' tile plan (csrc/raster_loop.cuh: each tile's
     culled coarse and spill list and its pixel layout), read back from
     their scratch and held to its plain mirror ``raster.tile_plan_plain``
     (K1 at phong1080, stress4k and a row slab, K4 at phong1080_tex2048 and
     custom12_360), with each layout's tiles, the culled and overflowed
     tiles and the records the raster blocks stage against whole lists;
   - K1 at stress4k (a million triangles at 3840x2160, the default config:
     64-row tiles, two fine tiles a triangle, bin_pairs' packed 31-bit
     sort) against its plain version and ``rasterize_portable`` on its
     checked tiles (the heaviest, the one with the most coarse pairs, one
     no pair reaches, the first of each layout the plan has, the one whose
     culled list keeps the most spill pairs, five drawn with a seeded
     generator); with a cull cap of 64, which most tiles' culled lists pass
     (they keep their whole ranges), the same frame; again with 32-row
     tiles, where the sort key needs 32 bits and the stable two-operand
     sort runs, which must give the same frame; K1's device time there,
     with every pair list empty, and its bound;
   - K4, the non-fused raster: phong1080_tex2048 at the same angles, both
     entry points, a custom shader with 12 varyings at 640x360, and
     sliver640 (K4's device time at phong1080_tex2048 and custom12_360).
     Winner ids, texture ids and varyings bit-equal, depth
     within rtol 2.4e-7; the frames shaded from the kernels' planes
     (K4 + K3) against the frames shaded from the plain planes with the
     plain sampler, under the colour bar above;
   - K3, the batched sampler, on the phong1080_tex2048 planes: within
     1e-6 of the plain version;
   - the voxel ray set-up kernel (csrc/voxel_setup.cu, XLA's fusion of the
     JAX package's set-up): voxel540's 10 orbit views, the tests' crafted
     view (a zero direction, rays on a grid plane and along ±x), eyes
     inside the cube, on a face, on an edge and on its corner, and a view
     at length 3.0: the eight planes bit for bit (NaN equal to NaN, zeros
     with their signs), then the frames K5 marches from each; its
     ``ptxas`` line must show no stack frame and no spills;
   - the triangle set-up kernels (csrc/tri_setup.cu, XLA's fusions of the
     chain from the vertex shader's outputs to the packed rows) and the
     binning kernels (csrc/bin_pairs.cu, the binning and pair gather):
     ``build_packed`` against ``build_packed_plain`` bit for bit (NaN equal
     to any NaN), and ``bin_packed`` against ``bin_packed_plain`` (offsets
     and pair columns bit for bit where the plain version takes the packed
     31-bit sort; where it takes the two-operand sort, equal offsets and the
     same lists, the kernels' in slot order), on phong1080 at the bench
     camera and three more angles, with 1, cap and cap + 7 faces clipped,
     its eight row slabs, stress4k (and at 32-row tiles), phong1080_tex2048,
     custom12_360, sliver640, gouraud800, textured_wide, phong_bin_k1 and
     cube1080; their ``ptxas`` lines must show no stack frame and no spills;
     their device times at phong1080 and stress4k beside their bounds. The
     raster kernels above run on the plain chain's preps, so every frame
     of 4 is held to the frame the plain set-up and binning give;
   - K5, the voxel march: voxel540 and voxel540dda on all 10 main-path
     views, BGRA frames equal; for fixed steps each frame also against
     the plain serial chain without the jump (the query count of view 0
     kept, and the queries of its warps: the largest and the mean); one
     level-6 view at 240x135 (its hit bitmap read through L2), fixed
     steps against both plain marches; and one dda view at length 3.0,
     where the cell is no power of two and the kernel divides;
   each kernel's device time (its launches queued behind a spin kernel,
   CUDA events), its entry point's time with the host's launch overhead
   (back-to-back calls), its plain version's time, and the least time the
   card could take for the same work (the bound; for K1 and K4 also with
   every pixel of a tile tested for every pair in its lists, for K5 fixed
   also with the serial chain's queries); beside them the same launches
   with every pair list empty (K1, K4: the stores alone), without
   varyings and with only the heaviest tile (K4), and with every ray dead
   (K5);
4. the main paths through the entry points a user calls, each driven with
   the launch counters set to 0 just before it and read just after:
   phong1080 ``Scene.render()`` (K1, the set-up and the binning kernels
   once a frame), phong1080
   ``render_prepared`` (``prepare()`` once, then K1 alone a frame while the
   eye moves and the textures trade places; the first and last frames equal
   to ``Scene.render()`` at the same uniforms), stress4k
   ``Scene.render()`` at 0.10 / 0.15 / 0.20 (K1 once a frame, no face past
   the clip cap, frame 0 equal to the checked K1 frame), cube1080_flat
   through the portable backend (no kernel; winner equal to the kernel
   path's), phong1080_tex2048 ``Scene.render()`` (K4 and K3 once a frame,
   K1 never), the custom 12-varying shader's ``Scene.render()`` (K4 once a
   frame) and ``render_voxel_frame`` for voxel540 and voxel540dda (the
   set-up kernel and K5 once a frame, each graph under 100 nodes), with
   frame times (CUDA events), checksums and per-stage times
   (eager). On the card each of these entry points but the portable one
   and ``render_prepared`` (eager: one K1 launch) replays one captured CUDA
   graph a frame (``compiled.py``). A graph path's frames are replays, so
   its launches are the kernels the device ran in them, read from CUPTI's
   kernel records in phase 4b, after every timing (no wrapper may count
   one). ``[split]`` lines, in 4b too: one replay each of phong1080
   ``render()`` and ``prepare()`` and stress4k ``render()`` under a trace
   of its kernels, memsets and memcpys with their durations (the names
   with the most device time, their sum and union against the replay's
   time, the faces clipped at the bench camera). ``[graph]``
   lines: the first call captures; the graph's K1/K3/K4/K5 nodes (from its
   DOT) equal one eager frame's launches; the graph frames, timed in a
   second run, and the first three of them run eagerly (``render_frame``,
   ``voxel.voxel_frame``) are bit-equal, the prep of ``prepare()`` to
   ``prep_fused`` too; a replay overwrites its sentinel-filled static
   outputs; a changed draw shape and a stack of another ``opaque`` capture
   anew and stay equal; capture ms, pool bytes, graph and eager frame ms,
   the input copy, replay and output clone alone; the graph's conditional
   nodes from its DOT, one a draw's geometry (``lax.cond``'s clip path in
   its body); what path B costs a replay where nothing clips (phong1080,
   stress4k): the conditional node with its predicate false, the skip
   path alone, and the clip path with a select on every frame (the
   graph's form before the node); and every geometry graph path
   (phong1080 ``render()`` and ``prepare()``, stress4k, phong1080_tex2048,
   custom12_360, and the captured sharded frame and grids below) replayed
   across frames that flip between clipped and unclipped faces (1, 0, cap,
   0, cap + 7 and 1 faces of draw 0 moved through the near plane), each
   replay bit-equal to the same frame run eagerly;
5. ``[sharded]``, row slabs and the sharded frame: K1 and K4 with an
   origin against their plain versions with that origin, bit for bit (slab
   3 of 8 of phong1080, and sliver640 cut on and off its corners), with
   their device times beside those at origin (0, 0); the eight row slabs
   of phong1080 (K1), phong1080_tex2048 (K4 + K3) and stress4k (K1)
   stitched and held to the whole frame bit for bit, timed against it;
   phong1080 through ``render_frame_grid`` on a 2 x 4 grid in one process
   (8 K1 launches all-gathered; 16 K4 and 8 K3 streamed) and through
   ``render_frame_sharded`` with NCCL at world size 1 (one K1 a frame),
   each equal to the single-device frame; then the same captured:
   ``compiled.sharded_frame`` at world size 1 (its collectives recorded
   into the graph) and ``compiled.grid_frame`` at 2 x 4 (all-gathered and
   streamed), each a graph path as in 4 and equal to the single-device
   frame. The NCCL group lives until 4b has replayed the sharded graph;
6. one JSON line describing the kernels, the card's identity line, and the
   last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero; without CUDA, or without the port beside it,
the script exits non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

FRAMES = 10
ANGLES = (0.10, 0.15, 0.20)  # bench.py's first three frame angles
DEPTH_RTOL = 2.4e-7
SAMPLE_ATOL = 1e-6
# Published H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores. Integer and float work are
# both counted at the float32 rate, so a bound is never too high.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
VOXEL_LEVEL, VOXEL_LENGTH, VOXEL_W, VOXEL_H = 3, 2.0, 960, 540
# Frame sizes of the scenes, and the side of phong1080_tex2048's textures.
SIZES = {"phong1080": (1920, 1080), "custom12_360": (640, 360), "phong_bin_k1": (640, 360),
         "textured_wide": (800, 600), "gouraud800": (800, 600), "gouraud800_color": (800, 600),
         "cube1080_flat": (1920, 1080),
         "sliver640": (640, 360), "stress4k": (3840, 2160)}
SIZES["phong1080_tex2048"] = SIZES["phong1080"]
TEX_SIDE = 2048
EAGER_FRAMES = 3  # the eager frames run beside a graph path's, its first ones
# Each wrapper's kernel function (csrc/), as the device's trace names it.
KERNEL_FUNCTIONS = {"fused_raster": "fused_raster_kernel", "raster_planes": "raster_planes_kernel",
                    "sample_bilinear": "sample_bilinear_kernel", "voxel_march": "voxel_march_kernel",
                    "voxel_setup": "voxel_setup_kernel", "tri_setup": "tri_setup_kernel",
                    "bin_pairs": "bin_pairs_kernel"}
VOXEL_GRAPH_NODES = 100  # a voxel frame's graph holds fewer nodes than this
PHONG_GRAPH_NODES = 126  # phong1080's render() graph: half the 252 nodes it held with the PyTorch vertex shader

failures = []


def log(*parts):
    print(*parts, flush=True)


def check(ok, msg):
    """Record a disagreement; the script fails at the end if any were."""
    if not ok:
        failures.append(msg)
        log(f"  FAIL: {msg}")
    return ok


def three_meshes():
    import numpy as np

    from f_renderer_tpu_torch import make_cube, make_uv_sphere

    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.6, 0.0, 0.0], np.float32)
    cube2 = make_cube(0.8)
    cube2["pos"] = cube2["pos"] + np.array([-1.6, 0.0, 0.0], np.float32)
    return [make_uv_sphere(40, 80), cube, cube2]


def custom12_shaders():
    """A custom shader with 12 varyings (color 4, normal 3, pos 3, uv 2) and
    no ``fused_kind``: past the fused kernel's cap of 8."""
    import torch

    from f_renderer_tpu_torch.math import mat_vec4
    from f_renderer_tpu_torch.shaders.builtin import _mvp_transform

    def vertex(u, vin):
        clip, p = _mvp_transform(u, vin["pos"])
        world = mat_vec4(u["model"], p)
        uv, n = vin["uv"].float(), vin["normal"].float()
        color = torch.cat([uv, n[:, :1] * 0.5 + 0.5, torch.ones_like(uv[:, :1])], dim=1)
        return clip, {"uv": uv, "normal": n, "pos": world[:3].T, "color": color}

    def pixel(u, ctx, ps_index):
        c, n, p, uv = ctx["color"], ctx["normal"], ctx["pos"], ctx["uv"]
        return torch.stack([
            0.5 * c[0] + 0.25 * (n[0] * n[0]) + 0.25 * uv[1],
            0.5 * c[1] + 0.25 * (n[1] * n[1]) + 0.1 * torch.abs(p[0]),
            0.5 * c[2] + 0.25 * (n[2] * n[2]) + 0.1 * torch.abs(p[1]),
            c[3],
        ])

    return vertex, pixel


def build_scene(name, device):
    """The scenes the port runs, built with the port's own builders: the
    bench scenes of ``bench_scenes`` (``bench.py:60-154``) and variants."""
    from f_renderer_tpu_torch import Camera, make_checker_texture, make_phong_scene, make_uv_sphere
    from f_renderer_tpu_torch import bench_scenes

    if name in ("phong1080", "gouraud800", "stress4k"):
        return bench_scenes.build_scene(name, device)
    if name == "cube1080_flat":
        return bench_scenes.build_scene("cube1080", device)
    if name == "gouraud800_color":  # draws with a colour: the vertex stage's base · light
        import numpy as np
        import torch

        scene = bench_scenes.build_scene("gouraud800", device)
        rng = np.random.default_rng(2)
        scene.draws = [dict(d, color=torch.from_numpy(rng.uniform(0.2, 1.0, tuple(d["pos"].shape)).astype(np.float32))
                            .to(device)) for d in scene.draws]
        return scene
    w, h = SIZES[name]
    cam = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device)
    sphere_cam = Camera.create([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device)
    if name == "phong1080_tex2048":  # phong1080 with 2048^2 diffuse maps: a 48 MiB stack
        n = TEX_SIDE
        return make_phong_scene(
            w, h, clip_cap=64, meshes=three_meshes(), camera=cam, device=device,
            textures=[make_checker_texture(n, n // 16), make_checker_texture(n, n // 32),
                      make_checker_texture(n, 3 * n // 64)],
        )
    if name == "custom12_360":
        scene = make_phong_scene(
            w, h, clip_cap=64, meshes=three_meshes(), camera=cam, device=device,
            textures=[make_checker_texture(64, 8)] * 3,
        )
        scene.vertex_shader, scene.pixel_shader = custom12_shaders()
        return scene
    if name == "phong_bin_k1":  # coarse and spill ranges
        scene = make_phong_scene(
            w, h, clip_cap=64, meshes=three_meshes(), camera=cam, device=device,
            textures=[make_checker_texture(64, 8)] * 3,
        )
        scene.config = dataclasses.replace(scene.config, tile=(16, 128), bin_k=1)
        return scene
    if name == "textured_wide":  # a 300-px texture (three TPU lane pages)
        return make_phong_scene(
            w, h, clip_cap=64, meshes=[make_uv_sphere(24, 48)], camera=sphere_cam,
            textures=[make_checker_texture(300, 20)], shader="textured", device=device,
        )
    if name == "sliver640":  # slivers and 1-px triangles on warp and tile edges, bin_k=1
        from f_renderer_tpu_torch.scene import make_sliver_scene

        return make_sliver_scene(w, h, device=device)
    raise ValueError(name)


def set_angle(scene, angle):
    """Rotate the scene's model by ``angle`` about y (None: leave it)."""
    from f_renderer_tpu_torch import bench_scenes

    if angle is not None:
        bench_scenes.set_angle(scene, angle)


def voxel_view(i, length=VOXEL_LENGTH):
    """bench.py:283-292: the orbit camera of voxel frame ``i`` around a cube
    of side ``length`` → (eye, inv_mvp) as float32 numpy, from the port's
    math on the host."""
    import numpy as np

    from f_renderer_tpu_torch.math import set_identity, set_look_at, set_perspective

    w, h = VOXEL_W, VOXEL_H
    proj = set_perspective(np.pi * 0.25, w / h, 0.1, 100.0, "cpu").numpy()
    center = np.array([length / 2] * 3, np.float32)
    ang = 0.3 + 0.08 * i
    eye = center + np.array([3.0 * np.cos(ang), 1.2, 3.0 * np.sin(ang)], np.float32)
    view = set_look_at(eye, center, [0, 1, 0]).numpy()
    mvp = proj @ view @ set_identity("cpu").numpy()
    return eye, np.linalg.inv(mvp).astype(np.float32)


def look_at_view(eye, target, width, height, fov):
    """(eye, inv_mvp) as float32 numpy of a left-handed look-at from ``eye``
    to ``target`` and a D3D perspective of ``fov`` radians, made in float64."""
    import numpy as np

    eye64, target64 = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = target64 - eye64
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = x, np.cross(z, x), z
    view[:3, 3] = -view[:3, :3] @ eye64
    f, near, far = 1.0 / np.tan(fov / 2), 0.1, 100.0
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = f / (width / height), f
    proj[2, 2], proj[2, 3], proj[3, 2] = far / (far - near), -near * far / (far - near), 1.0
    return np.asarray(eye, np.float32), np.linalg.inv(proj @ view).astype(np.float32)


def setup_views(width=VOXEL_W, height=VOXEL_H):
    """The set-up kernel's views beside the orbit: the crafted view of
    tests/test_torch_voxel.py (every ray in the plane y = 1.1: rays along a
    grid plane and along ±x, a zero direction at pixel (0, H/2)) and eyes
    inside the cube, on a face, on an edge and on the corner (0, 0, 0),
    each looking into it with a wide field of view (rays that meet the cube
    in more than two points: the dedupe) → (name, eye, inv_mvp)."""
    import numpy as np

    inv = np.zeros((4, 4), np.float32)
    inv[0, 1] = 0.5
    inv[2, 0], inv[2, 2], inv[2, 3] = 1.0, 0.5, 0.5
    inv[3, 3] = 1.0
    views = [("crafted", np.array([1.0, 1.1, -1.5], np.float32), inv)]
    for name, eye, fov in (("inside", [0.7, 1.2, 0.9], np.pi / 2), ("face", [1.0, 0.6, 0.0], 2.0),
                           ("edge", [0.0, 0.0, 1.0], 2.4), ("corner", [0.0, 0.0, 0.0], 2.4)):
        target = [2.0, 0.4, 1.7] if name == "inside" else [1.0, 1.0, 1.0]
        views.append((name, *look_at_view(eye, target, width, height, fov)))
    return views


def planes_equal(got, want):
    """Two (start, dirs, t_max, alive) set-ups → (bit-equal, NaN equal to
    NaN and zeros with their signs; the largest absolute difference of the
    float planes where both are numbers)."""
    import torch

    g = [*got[0], *got[1], got[2]]
    w = [*want[0], *want[1], want[2]]
    ok = torch.equal(got[3], want[3]) and all(
        bool(((a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))).all())
        for a, b in zip(g, w))
    err = max(float(torch.nan_to_num((a - b).abs(), nan=0.0, posinf=0.0).max()) for a, b in zip(g, w))
    return ok, err


def cuda_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms():
    """Clock cycles ``torch.cuda._sleep`` spins per millisecond on this card."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, reps):
    """Device time per call of ``fn`` (one kernel launch): the launches queue
    behind a spin kernel long enough for the host to enqueue all of them, so
    CUDA events around them see the device's time and not the host's
    launch overhead. Fails the run if the host did not keep ahead."""
    import torch

    fn()
    torch.cuda.synchronize()
    host_ms = 0.0
    for _ in range(3):  # the slowest of three calls: one call's host time varies
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = max(host_ms, (time.perf_counter() - t0) * 1e3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_ms = 3.0 * host_ms * reps + 1.0
    torch.cuda._sleep(int(sleep_cycles_per_ms() * spin_ms))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    check(enqueue_ms < spin_ms, f"device_ms: enqueueing took {enqueue_ms:.2f} ms, the spin {spin_ms:.2f} ms")
    return start.elapsed_time(end) / reps


def kernel_call(name, entry):
    """Run ``entry()`` once with ``kernels.<name>`` wrapped to record its
    arguments → a function that launches that kernel alone with them."""
    from f_renderer_tpu_torch import kernels

    wrapper, seen = getattr(kernels, name), {}

    def spy(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return wrapper(*args, **kw)

    spy.launches = wrapper.launches  # the wrapper counts on its module's name
    setattr(kernels, name, spy)
    try:
        entry()
    finally:
        setattr(kernels, name, wrapper)
        wrapper.launches = spy.launches
    def launch(*args, **over):  # the recorded call; ``args`` replace the leading positionals
        return wrapper(*args, *seen["args"][len(args):], **dict(seen["kw"], **over))

    return launch


def counts():
    from f_renderer_tpu_torch import kernels

    return {k: getattr(kernels, k).launches for k in KERNEL_FUNCTIONS}


def reset_counts():
    from f_renderer_tpu_torch import kernels

    for k in counts():
        getattr(kernels, k).launches = 0


def plain(fn, *args, **kw):
    """Run a plain version; it must launch no kernel."""
    import torch

    before = counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    check(counts() == before, f"plain {getattr(fn, '__name__', fn)} moved a launch counter")
    return out


def timed(entry_fn, launch_fn, plain_fn, kernel_reps, plain_reps=1):
    """Times in turns plain, kernel, kernel, plain → (kernel ms, plain ms,
    wrapper ms, each): the kernel's device time (``device_ms`` of
    ``launch_fn``, the wrapper called with recorded arguments), and with
    CUDA events around back-to-back calls, host launch overhead included,
    the entry point ``entry_fn`` and the plain
    version."""
    entry_fn(), plain(plain_fn)  # warm-up
    p_a = cuda_ms(lambda: plain(plain_fn), plain_reps)
    k_a, w_a = device_ms(launch_fn, kernel_reps), cuda_ms(entry_fn, kernel_reps)
    k_b, w_b = device_ms(launch_fn, kernel_reps), cuda_ms(entry_fn, kernel_reps)
    p_b = cuda_ms(lambda: plain(plain_fn), plain_reps)
    return (k_a + k_b) / 2, (p_a + p_b) / 2, (w_a + w_b) / 2, (k_a, k_b, p_a, p_b, w_a, w_b)


def bound_ms(nbytes, ops):
    """The least time for the work: max(bytes / HBM rate, ops / ALU rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same(a, b):
    """Two outputs (a tensor, or tuples and dicts of them) bit-equal."""
    import torch

    from f_renderer_tpu_torch import compiled

    (la, sa), (lb, sb) = compiled.flatten(a), compiled.flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def fill_sentinel(t):
    """Fill a static output with a value no frame writes there: NaN for
    floats, 0x5A5A5A5A (0x5A for bytes) for integers."""
    import torch

    t.fill_(float("nan") if t.is_floating_point() else (0x5A if t.dtype == torch.uint8 else 0x5A5A5A5A))


def kernel_launches(names):
    """How many of ``names`` (kernel function names, as the device's trace
    or a graph's DOT gives them) are each wrapper's kernel, by wrapper name."""
    names = list(names)
    return {k: sum(fn in name for name in names) for k, fn in KERNEL_FUNCTIONS.items()}


def launches_between_markers(events, marker="spin_kernel"):
    """``events``: (start ns, kernel name) of the kernels a device ran, in
    any order → for each stretch between two ``marker`` kernels, in time
    order, the wrappers' kernels in it by wrapper name."""
    parts, names = [], None
    for _, name in sorted(events):
        if marker in name:
            if names is not None:
                parts.append(kernel_launches(names))
            names = []
        elif names is not None:
            names.append(name)
    return parts


class DeviceTrace:
    """The work the device runs while the block is open, as CUPTI's activity
    API records it (one record a kernel, memset or memcpy executed, graph
    replays included): ``with DeviceTrace() as trace: ...``, then
    ``trace.kernels``, (start ns, name) pairs of the kernels, and
    ``trace.records``, (start ns, end ns, name) of every record, a memset
    named ``[memset]`` and a memcpy ``[memcpy]``. Uses the libcupti that
    torch loaded (``torch.profiler`` took seconds to start). Records are
    read at fixed offsets (cupti_activity.h): start at byte 16 and end at
    byte 24 in CUpti_ActivityKernel4 and its successors, in
    CUpti_ActivityMemset4 and in CUpti_ActivityMemcpy5; a kernel's name at
    byte 104."""

    KERNEL_KIND, START, END, NAME, BUFFER = 10, 16, 24, 104, 32 << 20  # CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL
    OTHER_KINDS = {1: "[memcpy]", 2: "[memset]"}  # CUPTI_ACTIVITY_KIND_MEMCPY, CUPTI_ACTIVITY_KIND_MEMSET
    _lib = _callbacks = None
    _active = None  # the trace the callbacks fill

    @classmethod
    def _load(cls):
        import ctypes

        if cls._lib is not None:
            return
        paths = sorted({line.split()[-1] for line in open("/proc/self/maps") if "libcupti" in line})
        if not paths:
            raise RuntimeError("torch loaded no libcupti")
        lib = ctypes.CDLL(paths[0])
        buffers = []  # every buffer handed to CUPTI, kept alive

        @ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
                          ctypes.POINTER(ctypes.c_size_t))
        def requested(buf, size, max_records):
            raw = ctypes.create_string_buffer(cls.BUFFER + 8)
            buffers.append(raw)
            buf[0] = (ctypes.addressof(raw) + 7) & ~7
            size[0], max_records[0] = cls.BUFFER, 0

        @ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t)
        def completed(ctx, stream, buf, size, valid):
            rec = ctypes.c_void_p()
            while lib.cuptiActivityGetNextRecord(ctypes.c_void_p(buf), ctypes.c_size_t(valid), ctypes.byref(rec)) == 0:
                kind = ctypes.c_uint32.from_address(rec.value).value
                if cls._active is None or (kind != cls.KERNEL_KIND and kind not in cls.OTHER_KINDS):
                    continue
                start = ctypes.c_uint64.from_address(rec.value + cls.START).value
                end = ctypes.c_uint64.from_address(rec.value + cls.END).value
                if kind == cls.KERNEL_KIND:
                    name = (ctypes.c_char_p.from_address(rec.value + cls.NAME).value or b"").decode(errors="replace")
                    cls._active.kernels.append((start, name))
                else:
                    name = cls.OTHER_KINDS[kind]
                cls._active.records.append((start, end, name))
            buffers[:] = [b for b in buffers if (ctypes.addressof(b) + 7) & ~7 != buf]

        cls._lib, cls._callbacks = lib, (requested, completed)
        cls._check(lib.cuptiActivityRegisterCallbacks(requested, completed), "cuptiActivityRegisterCallbacks")

    @staticmethod
    def _check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUPTI error {rc}")

    def __enter__(self):
        import torch

        self._load()
        self.kernels, self.records = [], []
        torch.cuda.synchronize()
        DeviceTrace._active = self
        for kind in (self.KERNEL_KIND, *self.OTHER_KINDS):
            self._check(self._lib.cuptiActivityEnable(kind), "cuptiActivityEnable")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._check(self._lib.cuptiActivityFlushAll(1), "cuptiActivityFlushAll")
        for kind in (self.KERNEL_KIND, *self.OTHER_KINDS):
            self._check(self._lib.cuptiActivityDisable(kind), "cuptiActivityDisable")
        DeviceTrace._active = None
        return False


def records_between_markers(records, marker="spin_kernel"):
    """``records``: (start ns, end ns, name) in any order → the records of
    each stretch between two ``marker`` kernels, in time order."""
    parts, part = [], None
    for rec in sorted(records):
        if marker in rec[2]:
            if part is not None:
                parts.append(part)
            part = []
        elif part is not None:
            part.append(rec)
    return parts


@functools.lru_cache(maxsize=None)
def demangle(name):
    """A kernel's C++ name as ``c++filt`` prints it (the name as given where
    that fails), cut to 110 characters."""
    try:
        out = subprocess.run(["c++filt"], input=name, capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    out = out or name
    return out if len(out) <= 110 else out[:107] + "..."


def port_kernel_names():
    """The names of the port's kernel functions (csrc/), as ``ptxas -v``
    listed them when the library was built, without template arguments."""
    from f_renderer_tpu_torch import kernels

    return frozenset(line.split(":")[0].split("<")[0] for line in kernels.ptxas_report())


def foreign_kernels(records, port_names):
    """The kernels among a replay's records (start, end, name) whose names
    hold none of ``port_names`` (PyTorch's, CUDA's memset kernels) → {name
    as ``demangle`` prints it: count}."""
    out = {}
    for *_, name in records:
        if name not in ("[memset]", "[memcpy]") and not any(k in name for k in port_names):
            out[demangle(name)] = out.get(demangle(name), 0) + 1
    return out


def split(records, top=15):
    """One replay's device records (start, end, name) → a summary: the
    ``top`` names by device time with their count and total us; the sum of
    every record's time; the span from the first start to the last end; the
    time the device was busy (the union of the records); the idle gap (span
    less busy); and the records by kind."""
    by_name = {}
    for start, end, name in records:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (end - start) / 1e3)
    busy, last_end = 0, None
    for start, end, _ in sorted(records):
        if last_end is None or start >= last_end:
            busy += end - start
            last_end = end
        elif end > last_end:
            busy += end - last_end
            last_end = end
    span = (max(e for _, e, _ in records) - min(s for s, _, _ in records)) if records else 0
    kinds = {k: sum(1 for *_, n in records if n == k) for k in ("[memset]", "[memcpy]")}
    kinds["kernels"] = len(records) - sum(kinds.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"top": [(demangle(n), c, us) for n, (c, us) in ranked],
            "sum_us": sum(us for _, us in by_name.values()), "span_us": span / 1e3, "busy_us": busy / 1e3,
            "gap_us": (span - busy) / 1e3, "records": kinds}


def graph_summary(frame):
    """What a captured frame's graph holds, from the DOT that ``debug_dump``
    writes (debug mode, one dump a graph) → (its K1, K4, K3 and K5 kernel
    nodes by wrapper name: the nodes whose attributes name the kernel's
    function; its conditional nodes (``device.if_node``); the nodes of the
    graph itself; the nodes inside the conditional nodes' bodies). The DOT
    draws each graph as a cluster, the frame's first, each body after it."""
    import re

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.dot")
        frame.graph.graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    nodes = dot_nodes(text)
    conditional = sum(node_type(attrs) == "CONDITIONAL" for attrs in nodes.values())
    frame_graph = re.search(r'label="(graph_\d+)"', text).group(1) + "_"  # the first cluster is the frame's
    own = sum(node.startswith(frame_graph) for node in nodes)
    return kernel_launches(nodes.values()), conditional, own, len(nodes) - own


def dot_nodes(text):
    """A graph's DOT (``debug_dump``) → {node: its attributes}."""
    import re

    nodes = {}
    for node, attrs in re.findall(r'"([A-Za-z0-9_]+)"\s*\[(.*?)\];?\s*$', text, re.S | re.M):
        nodes.setdefault(node, "")
        nodes[node] += attrs
    return nodes


def node_type(attrs):
    """A DOT node's type, the first field of its label (``KERNEL``,
    ``MEMSET``, ``CONDITIONAL``, ...), upper-cased; what the label says
    after it (a kernel's name, its parameters) cannot change it."""
    import re

    found = re.search(r'label="\{?\s*([A-Za-z_]+)', attrs)
    return found.group(1).upper() if found else ""


def graph_replay_ms(fn, reps):
    """``fn`` captured into a CUDA graph of its own → ms a replay (CUDA
    events around ``reps`` replays)."""
    import torch

    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.device import node_memory

    kernels.body_stream(torch.device("cuda", torch.cuda.current_device()))  # made before any capture
    current, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with node_memory() as kept, torch.cuda.graph(graph):  # kept: a conditional node's memory
        fn()
    return cuda_ms(graph.replay, reps)


def clip_path_cost(path, scene, smi):
    """What path B of ``geometry_process`` costs a replay on the scene's
    largest draw with no face clipped, each form in a captured graph of its
    own: the conditional node with its predicate false (``clip_or_skip`` as
    a capture records it: the skip path's fills, the predicate, the node),
    the skip path alone, and the clip path run on every frame with a
    ``torch.where`` select (how a captured frame ran it before the node).
    (The eager frame asks the host and skips the clip path.)"""
    import torch

    from f_renderer_tpu_torch.device import graph_frame
    from f_renderer_tpu_torch.pipeline import geometry
    from f_renderer_tpu_torch.shaders.api import ContextCodec

    draw = max(scene.draws, key=lambda d: next(iter(d.values())).shape[0])
    f = next(iter(draw.values())).shape[0]
    corners = {k: torch.cat([v[:, i] for i in range(3)]).to(torch.float32) for k, v in draw.items()}
    clip, ctx = scene.vertex_shader(scene.vs_uniform, corners)
    ctx_a = ContextCodec.of(ctx).flatten(ctx)
    b_mask = torch.zeros(f, dtype=torch.bool, device=clip.device)
    cfg = scene.config

    def skip():
        return geometry._skip_clip_path(cfg.clip_cap, ctx_a.shape[0], 0, clip.device)

    def select():
        num = b_mask.sum().to(torch.int32)
        ran = geometry._clip_path(clip, ctx_a, b_mask, cfg.clip_cap, 0, cfg.width, cfg.height)
        return [torch.where(num > 0, r, s) for r, s in zip(ran, skip())]

    def node():  # the warm-up runs the select, the capture records the node
        with graph_frame():
            num = b_mask.sum().to(torch.int32)
            return geometry.clip_or_skip(clip, ctx_a, b_mask, num, cfg.clip_cap, 0, cfg.width, cfg.height)

    g_node, g_skip, g_select = graph_replay_ms(node, 20), graph_replay_ms(skip, 20), graph_replay_ms(select, 20)
    log(f"[graph] {path}: path B on a frame with nothing clipped ({f} faces, clip_cap {cfg.clip_cap}), a replay: "
        f"the conditional node (predicate false) {g_node:.4f} ms, the skip path alone {g_skip:.4f} ms "
        f"(+{g_node - g_skip:.4f} ms), the clip path and a select on every frame {g_select:.4f} ms "
        f"(+{g_select - g_skip:.4f} ms) (CUDA events; {smi})")


def clipped_per_draw(scene, angle):
    """Each draw's faces clipped (path B's ``num_clipped``) at ``angle``."""
    from f_renderer_tpu_torch.pipeline.geometry import geometry_process

    set_angle(scene, angle)
    cfg = scene.config
    return [int(geometry_process(d, scene.vertex_shader, scene.vs_uniform, cfg.width, cfg.height,
                                 clip_cap=cfg.clip_cap)[1]["num_clipped"]) for d in scene.draws]


def clipped_draws(draws, vs_uniform, n, seed=0):
    """``draws`` with corner 0 of ``n`` faces of draw 0 moved through the
    near plane (to clip z = -w / 2 at ``vs_uniform``'s MVP): those ``n``
    faces clip, and no other face moves. The faces are drawn with a seeded
    generator from the first quarter of the draw, so that one face shard of
    a 2-way dp split holds them all (each shard keeps its own clip cap)."""
    import numpy as np
    import torch

    pos = draws[0]["pos"]
    faces = torch.from_numpy(np.random.default_rng(seed).choice(pos.shape[0] // 4, n, replace=False)).to(pos.device)
    u = {k: vs_uniform[k].double() for k in ("proj", "view", "model")}
    mvp = u["proj"] @ u["view"] @ u["model"]
    corner = torch.cat([pos[faces, 0].double(), torch.ones_like(pos[faces, 0, :1].double())], 1)
    clip = corner @ mvp.T
    clip[:, 2] = -0.5 * clip[:, 3]
    back = clip @ torch.linalg.inv(mvp).T
    moved = pos.clone()
    moved[faces, 0] = (back[:, :3] / back[:, 3:]).to(pos.dtype)
    return [dict(draws[0], pos=moved)] + list(draws[1:])


def tile_pair_pixels(prep):
    """(pair, pixel) cover tests the binned lists ask for, two ways →
    (every pixel of the tile for every pair in its fine, coarse and spill
    ranges; only the pixels inside the pair's bbox,
    the tests no exact design can skip)."""
    import torch

    from f_renderer_tpu_torch.pipeline.raster import LANES, MAXXY, MINXY, tile_lists, unpack_xy

    off = prep.off.tolist()
    th, nty, ntx = prep.th, prep.h_pad // prep.th, prep.w_pad // LANES
    minx, miny = unpack_xy(prep.tri_i32[MINXY].long())
    maxx, maxy = unpack_xy(prep.tri_i32[MAXXY].long())
    every, inside = 0, 0
    for ty in range(nty):
        for tx in range(ntx):
            lists = tile_lists(prep, ty, tx)
            n = sum(off[r + 1] - off[r] for r in lists)
            if n == 0:
                continue
            every += n * th * LANES
            idx = torch.cat([torch.arange(off[r], off[r + 1], device=minx.device) for r in lists])
            x0, y0 = tx * LANES, ty * th
            w = (torch.clamp(maxx[idx], max=x0 + LANES) - torch.clamp(minx[idx], min=x0)).clamp(min=0)
            h = (torch.clamp(maxy[idx], max=y0 + th) - torch.clamp(miny[idx], min=y0)).clamp(min=0)
            inside += int((w * h).sum())
    return every, inside


def raster_work(prep, out_planes, per_pixel_ops, extra_bytes=0):
    """(bytes, ops, ops at every pixel of the tile) of a raster kernel: its inputs
    read once (the offsets and the pair columns the lists hold, not the
    padding columns after them), its output planes written once; 12 integer
    operations for each cover test (edges, sign OR, bbox max) inside the
    pair's bbox (or at every pixel of the tile), ``per_pixel_ops`` for each
    pixel's epilogue."""
    pairs = int(prep.off[-1])
    nbytes = 4 * (prep.off.numel() + pairs * (prep.tri_i32.shape[0] + prep.tri_f32.shape[0]))
    nbytes += 4 * out_planes * prep.h_pad * prep.w_pad + extra_bytes
    every, inside = tile_pair_pixels(prep)
    epilogue = per_pixel_ops * prep.h_pad * prep.w_pad
    return nbytes, 12 * inside + epilogue, 12 * every + epilogue


def heaviest_tile_lists(prep):
    """Pair-range offsets that keep only the fine range of the tile with the
    most pairs (every other range empty) → (offsets, its pairs)."""
    import torch

    from f_renderer_tpu_torch.pipeline.raster import tile_lists

    ntiles = tile_lists(prep, 0, 0)[1]  # the fine ranges come first, one per tile
    t = int(torch.argmax(prep.off[1:ntiles + 1] - prep.off[:ntiles]))
    lo, hi = prep.off[t], prep.off[t + 1]
    only = torch.where(torch.arange(prep.off.numel(), device=prep.off.device) <= t, lo, hi)
    return only.to(torch.int32), int(hi - lo)


def range_sizes(prep):
    """Pairs in the fine, coarse and spill ranges of a binned prep."""
    from f_renderer_tpu_torch.pipeline.raster import tile_lists

    _, ntiles, spill = tile_lists(prep, 0, 0)  # the coarse ranges start after the fine ones
    off = prep.off.tolist()
    return f"{off[ntiles]}/{off[spill] - off[ntiles]}/{off[spill + 1] - off[spill]}"


def texel_bytes(stack, ps, u, v):
    """Bytes of the distinct texels these samples read."""
    import torch

    from f_renderer_tpu_torch.shaders.texture_sampler import texel_taps

    taps = texel_taps(stack.texels, stack.dims, ps, u, v)
    return 4 * int(torch.unique(taps).numel()) + 4 * stack.dims.numel()


def frame_bar(tag, got, want):
    diff = (got.int() - want.int()).abs().amax(-1)
    at2 = float((diff > 1).float().mean())
    check(int(diff.max()) <= 2 and at2 <= 0.002, f"{tag}: frame max diff {int(diff.max())} u8, {at2:.4%} at 2")
    return int(diff.max()), at2


def compare_fused(tag, got, want):
    """K1 against its plain version; returns (frame err u8, depth err)."""
    import torch

    frame_g, depth_g, winner_g = got
    frame_w, depth_w, winner_w = want
    check(torch.equal(winner_g, winner_w), f"{tag}: winner differs at {int((winner_g != winner_w).sum())} px")
    derr = (depth_g - depth_w).abs()
    check(bool((derr <= DEPTH_RTOL * depth_w.abs()).all()), f"{tag}: depth beyond rtol, max {float(derr.max())}")
    f_err, at2 = frame_bar(tag, frame_g, frame_w)
    log(f"  {tag}: winner equal, depth max abs err {float(derr.max()):.3g}, "
        f"frame max diff {f_err} u8 ({at2:.4%} at 2), covered px {int((winner_g >= 0).sum())}")
    return f_err, float(derr.max())


def compare_planes(tag, got, want):
    """K4 against its plain version (padded planes); returns (ctx err, depth err)."""
    import torch

    depth_g, winner_g, ps_g, ctx_g = got
    depth_w, winner_w, ps_w, ctx_w = want
    check(torch.equal(winner_g, winner_w), f"{tag}: winner differs at {int((winner_g != winner_w).sum())} px")
    derr = (depth_g - depth_w).abs()
    check(bool((derr <= DEPTH_RTOL * depth_w.abs()).all()), f"{tag}: depth beyond rtol, max {float(derr.max())}")
    cerr = 0.0
    if ps_g is not None:
        check(torch.equal(ps_g, ps_w), f"{tag}: texture ids differ")
        cerr = float((ctx_g - ctx_w).abs().max()) if ctx_g.numel() else 0.0
        check(torch.equal(ctx_g, ctx_w), f"{tag}: varyings differ, max abs err {cerr}")
    log(f"  {tag}: winner equal, depth max abs err {float(derr.max()):.3g}, "
        f"varyings max abs err {cerr:.3g}, covered px {int((winner_g >= 0).sum())}")
    return cerr, float(derr.max())


def check_serial(tag, got, rays, table, k):
    """Hold a fixed-step K5 frame against the plain serial chain (no jump),
    which the jump must not change → (its frame, its queries)."""
    import torch

    from f_renderer_tpu_torch.voxel import raycast

    want, queries = plain(raycast.march_plain, *rays, table, k, count_queries=True, serial=True)
    check(torch.equal(got, want), f"{tag}: the serial chain's frame differs at {int((got != want).sum())} rays")
    return want, int(queries.sum())


def warp_queries(queries):
    """Queries per warp of 32 rays in row order, as one thread per ray would
    run them → (mean over warps of the largest count, mean count)."""
    import torch

    q = queries.reshape(-1)
    q = torch.cat([q, q.new_zeros(-q.numel() % 32)]).reshape(-1, 32)
    return float(q.amax(1).float().mean()), float(q.float().mean())


def tile_ranges(prep):
    """Pairs of every bin tile → (fine, coarse, spill) lists indexed by tile
    t = ty * ntx + tx."""
    from f_renderer_tpu_torch.pipeline.raster import LANES, tile_lists

    off = prep.off.tolist()
    nty, ntx = prep.h_pad // prep.th, prep.w_pad // LANES
    out = []
    for t in range(nty * ntx):
        out.append(tuple(off[r + 1] - off[r] for r in tile_lists(prep, t // ntx, t % ntx)))
    return out


def reaches(prep, t):
    """Whether a pair of tile t's coarse or spill range has a bbox that
    reaches the tile (the cull's test)."""
    import torch

    from f_renderer_tpu_torch.pipeline.raster import LANES, MAXXY, MINXY, tile_lists, unpack_xy

    off = prep.off.tolist()
    ntx = prep.w_pad // LANES
    _, c, sp = tile_lists(prep, t // ntx, t % ntx)
    idx = torch.cat([torch.arange(off[r], off[r + 1], device=prep.off.device) for r in (c, sp)])
    x0, y0 = (t % ntx) * LANES, (t // ntx) * prep.th
    minx, miny = unpack_xy(prep.tri_i32[MINXY, idx])
    maxx, maxy = unpack_xy(prep.tri_i32[MAXXY, idx])
    return bool(((minx < x0 + LANES) & (maxx > x0) & (miny < y0 + prep.th) & (maxy > y0)).any())


def plan_check(tag, launch, prep, cap=None):
    """A raster kernel's tile plan (csrc/raster_loop.cuh), read back from its
    scratch after ``launch(cull_cap=cap, scratch=...)``, held to its plain
    mirror ``raster.tile_plan_plain`` at the card's resident slots: the
    order of the tiles (the largest floor(log2) of fine pairs first), each
    tile's flags (layout, culled or overflowed), its list's length, its
    culled count and culled pairs, in order → (the mirror's plan, the launch's
    outputs, a summary: tiles of each layout and kind, and the pair records
    the raster blocks stage, and with every tile's whole lists)."""
    import torch

    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import raster

    cap = kernels.CULL_CAP if cap is None else cap
    dev = prep.off.device
    nty, ntx = prep.h_pad // prep.th, prep.w_pad // raster.LANES
    ntiles = nty * ntx
    scratch = torch.empty((kernels.plan_words(ntiles, cap),), dtype=torch.int32, device=dev)
    out = launch(cull_cap=cap, scratch=scratch)
    desc, counts, pairs = kernels.read_plan(scratch, ntiles, cap)
    slots = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plain(raster.tile_plan_plain, prep, cap=cap, slots=slots)
    desc, counts = desc.tolist(), counts.tolist()
    check([d[0] for d in desc] == plan.order, f"{tag}: the plan's order of the tiles differs from the mirror's")
    bad = 0
    for d in desc:
        t = d[0]
        ok = d[7] == plan.flags[t] and d[3] == plan.lists[t].numel() and counts[t] == plan.counts[t]
        if ok and d[7] & raster.TILE_CULLED and plan.counts[t]:
            ok = torch.equal(pairs[t, :plan.counts[t]].long(), plan.lists[t][d[1]:])
        bad += not ok
    check(bad == 0, f"{tag}: the kernel's plan differs from the mirror's at {bad} tiles")
    off = prep.off.tolist()
    s = raster.blocks_per_tile(prep.th)
    band = prep.th // s  # a block of patches: one band of rows
    spill0 = off[raster.tile_lists(prep, 0, 0)[2]]
    miny, maxy = prep.tri_i32[raster.MINXY] >> 16, prep.tri_i32[raster.MAXXY] >> 16
    before = listed = now = coarse_in = spill_in = coarse_kept = spill_kept = 0
    for ty in range(nty):
        for tx in range(ntx):
            t = ty * ntx + tx
            fine, coarse, spill = (off[r + 1] - off[r] for r in raster.tile_lists(prep, ty, tx))
            # whole lists; a tile with no fine pair and at most 32 others, none reaching it, empty
            emptied = fine == 0 and coarse + spill <= 32 and plan.counts[t] == 0
            before += 0 if emptied else s * (fine + coarse + spill)
            lst = plan.lists[t]
            listed += s * lst.numel()
            if plan.flags[t] & raster.TILE_ROWS or lst.numel() <= 128:  # a chunk: no selection
                now += s * lst.numel()
            else:  # the row selection: each block the pairs whose bbox rows meet its band
                b0 = prep.origin[0] + ty * prep.th + band * torch.arange(s, device=dev)[:, None]
                now += int(((miny[lst][None] < b0 + band) & (maxy[lst][None] > b0)).sum())
            coarse_in, spill_in = coarse_in + coarse, spill_in + spill
            if plan.flags[t] & raster.TILE_CULLED:
                kept = plan.lists[t][fine:]
                n_spill = int((kept >= spill0).sum())
                coarse_kept, spill_kept = coarse_kept + kept.numel() - n_spill, spill_kept + n_spill
    summary = {
        "tiles": ntiles, "rows": sum(bool(f & raster.TILE_ROWS) for f in plan.flags),
        "culled": sum(bool(f & raster.TILE_CULLED) for f in plan.flags),
        "overflow": sum(bool(f & raster.TILE_OVERFLOW) for f in plan.flags), "cap": cap,
        "records_staged": now, "records_listed": listed, "records_staged_whole_lists": before, "coarse_entries": coarse_in,
        "coarse_kept": coarse_kept, "spill_entries": spill_in, "spill_kept": spill_kept,
    }
    log(f"  {tag} tile plan (cap {cap}): equal to the mirror's; layouts: rows {summary['rows']}, patches "
        f"{ntiles - summary['rows']}; culled {summary['culled']}, overflowed {summary['overflow']}; culled tiles keep "
        f"{coarse_kept} coarse and {spill_kept} spill records (of all tiles' {coarse_in} and {spill_in}); records "
        f"the raster blocks stage {now}, {listed} without the row selection, {before} with whole lists "
        f"({now / max(before, 1):.3f}x)")
    return plan, out, summary


def check_tiles(prep, n_random, seed=0, with_coarse_and_empty=True, plan=None):
    """The bin tiles to hold a kernel to its plain version on → ([(ty, tx)],
    what each is): the heaviest tile (most fine and coarse pairs); with
    ``with_coarse_and_empty`` the tile with the most coarse pairs and the
    first tile whose list the cull empties (no fine pair, and no coarse or
    spill pair whose bbox reaches it); with ``plan`` (``tile_plan_plain``),
    the first tile of each layout, the culled tile that keeps the most spill
    pairs, and the first tile whose culled list overflowed, where the frame
    has one; and ``n_random`` tiles with pairs, drawn with a seeded numpy
    generator."""
    import numpy as np

    from f_renderer_tpu_torch.pipeline.raster import LANES

    ntx = prep.w_pad // LANES
    ranges = tile_ranges(prep)
    picks, what = [], []

    def pick(t, label):
        picks.append(t)
        what.append(f"{label} ({t // ntx},{t % ntx}) pairs {'/'.join(map(str, ranges[t]))}")

    pick(max(range(len(ranges)), key=lambda t: ranges[t][0] + ranges[t][1]), "heaviest")
    if with_coarse_and_empty:
        pick(max(range(len(ranges)), key=lambda t: ranges[t][1]), "most coarse")
        empty = [t for t, (f, c, sp) in enumerate(ranges) if f == 0 and not reaches(prep, t)]
        if empty:
            pick(empty[0], "emptied by the cull (no pair reaches it)")
        else:
            what.append("no tile without fine pairs that no pair reaches")
    if plan is not None:
        from f_renderer_tpu_torch.pipeline.raster import TILE_CULLED, TILE_OVERFLOW, TILE_ROWS

        spill0 = int(prep.off[-2])
        for label, want in (("rows interleaved", lambda f: f & TILE_ROWS), ("patches", lambda f: not f & TILE_ROWS),
                            ("overflowed", lambda f: f & TILE_OVERFLOW)):
            at = [t for t, f in enumerate(plan.flags) if want(f) and t not in picks]
            if at:
                pick(at[0], label)
            else:
                what.append(f"no other tile {label}")
        kept = [(int((v[int(prep.off[t + 1] - prep.off[t]):] >= spill0).sum()), t)
                for t, (f, v) in enumerate(zip(plan.flags, plan.lists)) if f & TILE_CULLED]
        n, t = max(kept, default=(0, None))
        if n and t not in picks:
            pick(t, f"spill range culled to {n}")
    rest = [t for t, r in enumerate(ranges) if sum(r) > 0 and t not in picks]
    for t in np.random.default_rng(seed).choice(rest, n_random, replace=False):
        pick(int(t), "random")
    return [(t // ntx, t % ntx) for t in picks], what


def crop_tiles(plane, tiles, th):
    """The pixels of ``plane`` (H, W, ...) inside the bin tiles, joined
    (tiles at the frame's bottom edge are cut to the frame)."""
    import torch

    from f_renderer_tpu_torch.pipeline.raster import LANES

    return torch.cat([plane[ty * th:(ty + 1) * th, tx * LANES:(tx + 1) * LANES].reshape(-1, *plane.shape[2:])
                      for ty, tx in tiles])


def portable_tile(tri, th, ty, tx, width, height):
    """``rasterize_portable`` on one bin tile of the frame, fed only the
    valid slots whose bbox (clamped to the frame, as the rasterizer clamps
    it) reaches the tile, a plain bbox test that bins nothing; exact, since
    every accepted pixel lies in its triangle's bbox → (winner slot ids,
    depth), cut to the frame, and the slots fed."""
    import dataclasses as dc

    import torch

    from f_renderer_tpu_torch.pipeline.raster import LANES
    from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable

    x0, y0 = tx * LANES, ty * th
    sx, sy = tri.spi[:, 0].long(), tri.spi[:, 1].long()
    keep = (tri.valid & (sx.amin(0).clamp(0, width) < x0 + LANES) & (sx.amax(0).clamp(0, width) > x0)
            & (sy.amin(0).clamp(0, height) < y0 + th) & (sy.amax(0).clamp(0, height) > y0))
    ids = torch.nonzero(keep).flatten()
    sub = type(tri)(**{f.name: getattr(tri, f.name)[..., ids] for f in dc.fields(tri)})
    winner, depth = rasterize_portable(sub, LANES, th, tile=(th, LANES), origin=(y0, x0),
                                       full_size=(height, width))
    slot = torch.cat([ids, ids.new_full((1,), -1)]).to(torch.int32)  # winner -1 reads the last: -1
    winner = slot[winner.long()]
    rows = min(th, height - y0)
    return winner[:rows], depth[:rows], ids.numel()


def compare_portable(tag, tri, prep, tiles, got, width, height):
    """K1's winner and depth on the tiles against ``rasterize_portable``,
    the oracle that does not depend on ``bin_pairs`` → (depth err, ms)."""
    import torch

    _, depth_k, winner_k = got
    start = time.perf_counter()
    worst, fed = 0.0, []
    for ty, tx in tiles:
        winner_p, depth_p, n = plain(portable_tile, tri, prep.th, ty, tx, width, height)
        fed.append(n)
        w_k = crop_tiles(winner_k, [(ty, tx)], prep.th).reshape(winner_p.shape)
        d_k = crop_tiles(depth_k, [(ty, tx)], prep.th).reshape(depth_p.shape)
        check(torch.equal(w_k, winner_p), f"{tag} tile ({ty},{tx}): winner differs from rasterize_portable "
              f"at {int((w_k != winner_p).sum())} px")
        derr = (d_k - depth_p).abs()
        check(bool((derr <= DEPTH_RTOL * depth_p.abs()).all()),
              f"{tag} tile ({ty},{tx}): depth beyond rtol of rasterize_portable, max {float(derr.max())}")
        worst = max(worst, float(derr.max()))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3
    log(f"  {tag}: K1 against rasterize_portable on {len(tiles)} tiles (slots fed {fed}): winner equal, "
        f"depth max abs err {worst:.3g} ({ms:.0f} ms)")
    return worst, ms


def sort_bits(prep, m):
    """Bits of bin_pairs' packed (key, slot) sort key for a prep of ``m``
    packed columns: the keys' and the slots' (over 31, the two-operand
    stable sort runs)."""
    return prep.off.numel().bit_length(), max((m - 1).bit_length(), 1)


def packed_columns(tri):
    """The columns ``raster.pack_binned`` packs a TriangleBuffer into."""
    return -(-(tri.num_slots + 1) // 128) * 128


def slab_check(tag, got, want):
    """A kernel with an origin against its plain version with that origin:
    every plane bit-equal (None where neither has one)."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        check((g is None and w is None) or torch.equal(g, w), f"{tag}: output {i} differs from the plain version")


def stitch(tag, render_slab, full, n, slab):
    """Render the ``n`` row slabs with ``render_slab(y0)`` and hold their
    stitched planes to the whole frame's ``full`` bit for bit."""
    import torch

    parts = [render_slab(i * slab) for i in range(n)]
    for k, whole in enumerate(full):  # frame (H, W, 4), depth and winner (H, W): rows first
        joined = torch.cat([p[k] for p in parts])
        check(torch.equal(joined, whole), f"{tag}: the {n} stitched slabs' output {k} differs from the whole frame")
    return parts


def bin_settings(cfg, fused_path):
    """The bin settings ``render_frame`` gives ``raster.bin_packed``: the
    config's for the fused path (``fused.prep_packed``), the tile alone
    for K4's (as ``raster.rasterize_interp``)."""
    if not fused_path:
        return {}
    return dict(tile_auto=cfg.tile_auto, tile_auto_threshold=cfg.tile_auto_threshold, bin_k=cfg.bin_k)


def plain_prep(tri, cfg, **kw):
    """The prep of a TriangleBuffer through the plain versions of the
    set-up's pack and of the binning kernels (``raster.pack_binned``, then
    ``raster.bin_packed_plain``), on the card: the raster kernels' inputs as
    the plain chain makes them."""
    from f_renderer_tpu_torch.pipeline import raster

    ti, tf = raster.pack_binned(tri, cfg.width, cfg.height)
    return raster.bin_packed_plain(ti, tf, tri.num_slots, tri.num_channels, cfg.width, cfg.height, cfg.tile, **kw)


def bits_equal(a, b):
    """Two tensors equal bit for bit, a float NaN equal to any NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def float_err(a, b):
    """The largest |a - b| where both are finite (0 for empty tensors)."""
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.where(both, (a - b).abs(), 0.0).max()) if a.numel() else 0.0


def bins_equal(got, want, ti, tf, packed):
    """The binning kernels' prep against the plain one: equal offsets, and
    the pair columns bit for bit where the plain version takes the packed
    sort (both order pairs by (key, slot)); where it takes the two-operand
    sort, each key's list the same set of slots (the kernels' in slot
    order), each pair column its slot's packed column, and the padding
    columns equal."""
    import torch

    from f_renderer_tpu_torch.pipeline.raster import SLOT

    if not torch.equal(got.off, want.off):
        return False
    if packed:
        return bits_equal(got.tri_i32, want.tri_i32) and bits_equal(got.tri_f32, want.tri_f32)
    total = int(want.off[-1])
    pairs = torch.arange(total, device=got.off.device)
    key = torch.searchsorted(want.off.long(), pairs, right=True) - 1
    slots_g, slots_w = got.tri_i32[SLOT, :total].long(), want.tri_i32[SLOT, :total].long()
    same_sets = torch.equal(torch.sort((key << 32) | slots_g).values, torch.sort((key << 32) | slots_w).values)
    in_order = bool((((key[1:] << 32) | slots_g[1:]) > ((key[:-1] << 32) | slots_g[:-1])).all())
    return (same_sets and in_order and bits_equal(got.tri_i32[:, :total], ti[:, slots_g])
            and bits_equal(got.tri_f32[:, :total], tf[:, slots_g])
            and bits_equal(got.tri_i32[:, total:], want.tri_i32[:, total:])
            and bits_equal(got.tri_f32[:, total:], want.tri_f32[:, total:]))


def setup_launch(entry):
    """Run ``entry()`` (a ``build_packed`` call) once with the set-up
    kernels' wrappers recorded → a function that launches those kernels
    alone with the same arguments: launch 1 (a fresh zeroed accumulator
    and outputs), then launches 2 and 3 on its outputs and the recorded
    clip path's fan words."""
    from f_renderer_tpu_torch import kernels

    seen, first, rest = {}, kernels.tri_setup, kernels.tri_setup_slots

    def spy_first(*a, **kw):
        seen["first"] = (a, kw)
        return first(*a, **kw)

    def spy_rest(*a, **kw):
        seen["rest"] = (a, kw)
        return rest(*a, **kw)

    spy_first.launches, spy_rest.launches = first.launches, rest.launches  # each counts on its module name
    kernels.tri_setup, kernels.tri_setup_slots = spy_first, spy_rest
    try:
        entry()
    finally:
        kernels.tri_setup, kernels.tri_setup_slots = first, rest
        first.launches, rest.launches = spy_first.launches, spy_rest.launches

    def launch():
        (a1, kw1), (a2, kw2) = seen["first"], seen["rest"]
        ti, tf, _, acc = first(*a1, **kw1)
        rest(a2[0], a2[1], ti, tf, acc, **kw2)

    return launch


def sharded_phase(dev, smi, rows, launches, drive, graph_path, clip_flip):
    """K1 and K4 with an origin against their plain versions; every row slab
    of phong1080 (K1), phong1080_tex2048 (K4 + K3) and stress4k (K1)
    stitched and held to the whole frame; a 2 x 4 grid's stages in this
    process, eagerly and captured (``compiled.grid_frame``);
    ``render_frame_sharded`` through NCCL at world size 1 (the process group
    is initialized), eagerly and captured (``compiled.sharded_frame``)."""
    import torch

    from f_renderer_tpu_torch import compiled
    from f_renderer_tpu_torch.parallel import gather_slabs, make_render_mesh, render_frame_grid, render_frame_sharded
    from f_renderer_tpu_torch.pipeline import fused, raster, shade
    from f_renderer_tpu_torch.pipeline.render import build_triangles, context_codec, render_frame

    n_slabs = 8
    log(f"[sharded] row slabs: K1 and K4 with an origin, {n_slabs} slabs stitched, the sharded entry")

    # K1 and K4 with an origin against their plain versions: slab 3 of 8 of
    # phong1080, and the sliver scene cut on and off its 8-row corners
    scene = build_scene("phong1080", dev)
    set_angle(scene, ANGLES[0])
    cfg = scene.config
    w, h = SIZES["phong1080"]
    slab = h // n_slabs
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, cfg)
    prep = fused.prep_fused(tri, cfg, origin=(3 * slab, 0), size=(slab, w))
    args = (prep, scene.pixel_shader, scene.ps_uniform, cfg)
    slab_check(f"phong1080 slab 3 of {n_slabs} K1", fused.render_fused_prepared(*args),
               plain(fused.render_fused_plain, *args))
    for interp in (False, True):
        slab_check(f"phong1080 slab 3 of {n_slabs} K4 interp={interp}", raster.raster_planes(prep, interp),
                   plain(raster.raster_planes_plain, prep, interp))
    k1_slab = kernel_call("fused_raster", lambda: fused.render_fused_prepared(*args))
    k4_slab = kernel_call("raster_planes", lambda: raster.raster_planes(prep, True))
    plan_check(f"phong1080 slab 3 of {n_slabs} K1 (origin {prep.origin})", k1_slab, prep)  # the cull in frame pixels
    full_prep = fused.prep_fused(tri, cfg)
    full_args = (full_prep, scene.pixel_shader, scene.ps_uniform, cfg)
    k1_full = kernel_call("fused_raster", lambda: fused.render_fused_prepared(*full_args))
    k4_full = kernel_call("raster_planes", lambda: raster.raster_planes(full_prep, True))
    times = {name: [device_ms(fn, 20) for _ in range(2)] for name, fn in (
        ("K1 origin 0", k1_full), ("K1 slab 3", k1_slab), ("K4 origin 0", k4_full), ("K4 slab 3", k4_slab))}
    log(f"  phong1080 slab 3 of {n_slabs} (rows {3 * slab}..{4 * slab - 1}, th {prep.th}): K1 and K4 equal their "
        f"plain versions; device ms " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in times.items())
        + f" (CUDA events; {smi})")
    rows["K1"].update(origin0_ms=times["K1 origin 0"], slab3_of_8_ms=times["K1 slab 3"])
    rows["K4"].update(phong1080_origin0_ms=times["K4 origin 0"], phong1080_slab3_of_8_ms=times["K4 slab 3"])
    sliver = build_scene("sliver640", dev)
    stri, _ = build_triangles(sliver.draws, sliver.vertex_shader, sliver.vs_uniform, sliver.config)
    cuts = [0, 8, 45, 96, 200, 360]
    for y0, y1 in zip(cuts[:-1], cuts[1:]):
        sprep = fused.prep_fused(stri, sliver.config, origin=(y0, 0), size=(y1 - y0, SIZES["sliver640"][0]))
        sargs = (sprep, sliver.pixel_shader, sliver.ps_uniform, sliver.config)
        slab_check(f"sliver640 rows {y0}..{y1 - 1} K1", fused.render_fused_prepared(*sargs),
                   plain(fused.render_fused_plain, *sargs))
        slab_check(f"sliver640 rows {y0}..{y1 - 1} K4", raster.raster_planes(sprep, True),
                   plain(raster.raster_planes_plain, sprep, True))
    log(f"  sliver640 cut at rows {cuts}: K1 and K4 equal their plain versions on every slab")

    # every slab stitched against the whole frame; prep + kernel per slab
    def slabs_timed(tag, render_full, render_slab, height):
        s = height // n_slabs
        full = render_full()
        stitch(tag, render_slab, full, n_slabs, s)
        t_full = [cuda_ms(render_full, 3) for _ in range(2)]
        t_slabs = [cuda_ms(lambda: [render_slab(i * s) for i in range(n_slabs)], 3) for _ in range(2)]
        log(f"  {tag}: {n_slabs} slabs of {s} rows stitched equal the whole frame; whole frame {t_full[0]:.3f} / "
            f"{t_full[1]:.3f} ms, the {n_slabs} slabs {t_slabs[0]:.3f} / {t_slabs[1]:.3f} ms "
            f"({t_slabs[0] / n_slabs:.3f} ms a slab) (CUDA events, prep + kernel, host included; {smi})")
        return {"whole_ms": t_full, "slabs_ms": t_slabs}

    timing = {}
    timing["phong1080 K1"] = slabs_timed(
        "phong1080 K1", lambda: fused.render_fused(tri, scene.pixel_shader, scene.ps_uniform, cfg),
        lambda y0: fused.render_fused(tri, scene.pixel_shader, scene.ps_uniform, cfg, origin=(y0, 0),
                                      size=(slab, w)), h)
    k1_each = [kernel_call("fused_raster", lambda y0=i * slab: fused.render_fused(
        tri, scene.pixel_shader, scene.ps_uniform, cfg, origin=(y0, 0), size=(slab, w))) for i in range(n_slabs)]
    timing["phong1080 K1"]["kernel_slabs_ms"] = sum(device_ms(k, 20) for k in k1_each)
    log(f"  phong1080: K1's device time summed over the {n_slabs} slabs "
        f"{timing['phong1080 K1']['kernel_slabs_ms']:.4f} ms ({smi})")
    del k1_each

    tex = build_scene("phong1080_tex2048", dev)
    set_angle(tex, ANGLES[0])
    ttri, _ = build_triangles(tex.draws, tex.vertex_shader, tex.vs_uniform, tex.config)
    codec = context_codec(tex.vertex_shader, tex.vs_uniform, tex.draws[0])

    def tex_slab(y0, rows_=slab):
        ctx, ps, winner, depth = raster.rasterize_interp(ttri, w, rows_, tex.config.tile, origin=(y0, 0),
                                                         full_size=(h, w))
        frame = shade.shade_from_planes(ctx, ps, winner, tex.pixel_shader, tex.ps_uniform, codec,
                                        background=tex.config.background)
        return frame, depth, winner

    timing["phong1080_tex2048 K4 + K3"] = slabs_timed("phong1080_tex2048 K4 + K3", lambda: tex_slab(0, h),
                                                      tex_slab, h)
    check(torch.equal(tex_slab(0, h)[0], tex.render()[0]), "phong1080_tex2048: rasterize_interp + shade differs "
          "from Scene.render()")
    del tex, ttri

    stress = build_scene("stress4k", dev)
    set_angle(stress, ANGLES[0])
    sw, sh = SIZES["stress4k"]
    s_tri, _ = build_triangles(stress.draws, stress.vertex_shader, stress.vs_uniform, stress.config)
    s_args = (stress.pixel_shader, stress.ps_uniform, stress.config)
    timing["stress4k K1"] = slabs_timed(
        "stress4k K1", lambda: fused.render_fused(s_tri, *s_args),
        lambda y0: fused.render_fused(s_tri, *s_args, origin=(y0, 0), size=(sh // n_slabs, sw)), sh)
    k1_each = [kernel_call("fused_raster", lambda y0=i * (sh // n_slabs): fused.render_fused(
        s_tri, *s_args, origin=(y0, 0), size=(sh // n_slabs, sw))) for i in range(n_slabs)]
    timing["stress4k K1"]["kernel_slabs_ms"] = sum(device_ms(k, 5) for k in k1_each)
    timing["stress4k K1"]["kernel_whole_ms"] = device_ms(
        kernel_call("fused_raster", lambda: fused.render_fused(s_tri, *s_args)), 5)
    log(f"  stress4k: K1's device time summed over the {n_slabs} slabs {timing['stress4k K1']['kernel_slabs_ms']:.4f}"
        f" ms, the whole frame's {timing['stress4k K1']['kernel_whole_ms']:.4f} ms ({smi})")
    del k1_each, stress, s_tri
    rows["K1"]["sharded_slabs"] = timing

    # the dp > 1 data path in one process: a 2 x 4 grid's stages, torch.cat
    # for the all-gather and the ring; then the NCCL entry at world size 1.
    # The single-device frames run eagerly, as the grid's stages do (and warm
    # them as before the frame was captured)
    def eager(s):
        return render_frame(list(s.draws), s.vertex_shader, s.vs_uniform, s.pixel_shader, s.ps_uniform, s.config)

    eager(scene)
    whole = eager(scene)
    whole_planes = eager(dataclasses.replace(scene, config=dataclasses.replace(cfg, fused_shade=False)))
    zero = dict.fromkeys(counts(), 0)
    grid_args = (scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform)
    outs, got = drive("phong1080 render_frame_grid 2 x 4 (all_gather, in one process)",
                      lambda i: render_frame_grid(*grid_args, cfg, 2, 4), 1, dict(zero, fused_raster=8, bin_pairs=8),
                      (h, w, 4))
    launches["K1 grid 2x4"] = got["fused_raster"]
    check(torch.equal(outs[0][0], whole[0]) and torch.equal(outs[0][1], whole[1]),
          "phong1080: the 2 x 4 grid's frame differs from the single-device frame")
    stream_cfg = dataclasses.replace(cfg, comm_mode="stream")
    outs, got = drive("phong1080 render_frame_grid 2 x 4 (stream, in one process)",
                      lambda i: render_frame_grid(*grid_args, stream_cfg, 2, 4), 1,
                      dict(zero, raster_planes=16, sample_bilinear=8, bin_pairs=16), (h, w, 4))
    launches["K4 grid 2x4 stream"] = got["raster_planes"]
    check(torch.equal(outs[0][0], whole_planes[0]) and torch.equal(outs[0][1], whole_planes[1]),
          "phong1080: the 2 x 4 grid's stream frame differs from the single-device fused_shade=False frame")

    mesh = make_render_mesh(1, 1, device_type="cuda")

    def sharded_args():
        return scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform

    def sharded(i):
        set_angle(scene, 0.10 + 0.05 * i)
        return gather_slabs(mesh, *render_frame_sharded(*sharded_args(), cfg, mesh))

    sharded(0)
    outs, got = drive("phong1080 render_frame_sharded (NCCL, world size 1)", sharded, FRAMES,
                      dict(zero, fused_raster=FRAMES, bin_pairs=FRAMES), (h, w, 4))
    launches["K1 sharded world 1"] = got["fused_raster"]
    set_angle(scene, ANGLES[0])
    check(torch.equal(outs[0][0], whole[0]) and torch.equal(outs[0][1], whole[1]),
          "phong1080: render_frame_sharded at world size 1 differs from the single-device frame")

    # the same frames captured: jax.jit over the shard_map step. The warm-up
    # frame runs the collectives eagerly, then the capture records them
    def sharded_now():
        return compiled.sharded_frame(*sharded_args(), cfg, mesh)

    def sharded_graph(i):
        set_angle(scene, 0.10 + 0.05 * i)
        return sharded_now()

    def sharded_eager(i):
        set_angle(scene, 0.10 + 0.05 * i)
        return render_frame_sharded(*sharded_args(), cfg, mesh)

    outs = graph_path("phong1080 compiled.sharded_frame (NCCL, world size 1)", sharded_graph, sharded_eager, FRAMES,
                      dict(zero, fused_raster=FRAMES, bin_pairs=FRAMES), (h, w, 4),
                      {"K1 sharded graph": "fused_raster", "bin_pairs sharded graph": "bin_pairs"}, geometries=3)
    check(torch.equal(outs[0][0], whole[0]) and torch.equal(outs[0][1], whole[1]),
          "phong1080: compiled.sharded_frame at world size 1 differs from the single-device frame")
    set_angle(scene, ANGLES[0])
    clip_flip("phong1080 compiled.sharded_frame (NCCL, world size 1)", scene, sharded_now,
              lambda: render_frame_sharded(*sharded_args(), cfg, mesh), single=lambda: eager(scene))

    # the 2 x 4 grid captured in this process: dp = 2 under a graph on one card
    for tag, c, single_cfg, expect, keys in (
            ("all_gather", cfg, cfg, {"fused_raster": 8, "bin_pairs": 8}, {"K1 grid 2x4 graph": "fused_raster"}),
            ("stream", stream_cfg, dataclasses.replace(cfg, fused_shade=False),
             {"raster_planes": 16, "sample_bilinear": 8, "bin_pairs": 16},
             {"K4 grid 2x4 stream graph": "raster_planes", "K3 grid 2x4 stream graph": "sample_bilinear"})):
        def grid_now(c=c):
            return compiled.grid_frame(*sharded_args(), c, 2, 4)

        def grid_graph(i, c=c):
            set_angle(scene, 0.10 + 0.05 * i)
            return grid_now(c)

        def grid_eager(i, c=c):
            set_angle(scene, 0.10 + 0.05 * i)
            return render_frame_grid(*sharded_args(), c, 2, 4)

        def single(c=single_cfg):
            return eager(dataclasses.replace(scene, config=c))

        n = 3
        outs = graph_path(f"phong1080 compiled.grid_frame 2 x 4 ({tag}, in one process)", grid_graph, grid_eager, n,
                          dict(zero, **{k: v * n for k, v in expect.items()}), (h, w, 4), keys, geometries=6)
        set_angle(scene, ANGLES[0])
        want = single()
        check(torch.equal(outs[0][0], want[0]) and torch.equal(outs[0][1], want[1]),
              f"phong1080: compiled.grid_frame 2 x 4 ({tag}) differs from the single-device frame")
        clip_flip(f"phong1080 compiled.grid_frame 2 x 4 ({tag})", scene, grid_now,
                  lambda c=c: render_frame_grid(*sharded_args(), c, 2, 4), single=single)
    rows["K1"]["launches_grid_2x4"] = launches.pop("K1 grid 2x4")
    rows["K1"]["launches_sharded_world1"] = launches.pop("K1 sharded world 1")
    rows["K4"]["launches_grid_2x4_stream"] = launches.pop("K4 grid 2x4 stream")


def setup_phase(dev, smi, rows):
    """3h. the triangle set-up kernels (csrc/tri_setup.cu) and the binning
    kernels (csrc/bin_pairs.cu) against their plain versions on the card:
    ``build_packed`` against ``build_packed_plain`` bit for bit (NaN equal
    to any NaN), and ``bin_packed`` against ``bin_packed_plain`` on the
    plain packed arrays (``bins_equal``), on phong1080 at the bench camera
    and three more angles, its clip-flip frames and its eight row slabs,
    stress4k (and its 32-row tiles: the two-operand sort),
    phong1080_tex2048, custom12_360, sliver640, gouraud800 (with and
    without a colour attribute), textured_wide, phong_bin_k1 (coarse and
    spill ranges) and cube1080: launch 1 runs each builtin's vertex stage
    (phong, gouraud, textured, flat) and reads custom12_360's planes, each
    case checked to have taken its mode; their device times at phong1080
    and stress4k beside their bounds."""
    import torch

    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import fused, raster
    from f_renderer_tpu_torch.pipeline.geometry import MAX_FAN
    from f_renderer_tpu_torch.pipeline.render import build_packed, build_packed_plain
    from f_renderer_tpu_torch.shaders.builtin import VERTEX_KINDS

    log("[kernel-vs-plain] tri_setup (the triangle set-up), bin_pairs (the binning and pair gather)")
    lines = [line for line in kernels.ptxas_report() if line.split(":")[0].startswith(("tri_", "bin_"))]
    for line in lines:
        log(f"  ptxas {line}")
    frames = [line for line in lines if "stack frame" in line]
    # tri_setup_kernel<0..4> (the planes mode and four vertex stages), tri_slots, tri_quirk, six bin_ kernels
    check(len(frames) == 13 and all("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in line
                                   for line in frames), f"tri_setup / bin_pairs kernels: a stack frame or spills ({lines})")
    worst = {"tri_setup": 0.0, "bin_pairs": 0.0}

    def mode_of(entry):
        """The mode ``entry()`` (a ``build_packed`` call) launched the set-up
        kernel in: a builtin's vertex stage (its kind) or ``planes``."""
        seen, first = [], kernels.tri_setup

        def spy(*a, vertex=None, **kw):
            seen.append("planes" if vertex is None else vertex.kind)
            return first(*a, vertex=vertex, **kw)

        spy.launches = first.launches
        kernels.tri_setup = spy
        try:
            out = entry()
        finally:
            kernels.tri_setup, first.launches = first, spy.launches
        return out, seen

    def check_setup(tag, scene, draws=None):
        args = (scene.draws if draws is None else draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        got, modes = mode_of(lambda: build_packed(*args))
        want = plain(build_packed_plain, *args)
        mode = getattr(scene.vertex_shader, "fused_kind", None) or "planes"
        check(modes == [mode], f"tri_setup {tag}: launch 1 ran in {modes}, not once in the {mode} mode")
        ok = (bits_equal(got[0], want[0]) and bits_equal(got[1], want[1]) and got[2:4] == want[2:4]
              and int(got[4]["num_clipped"]) == int(want[4]["num_clipped"]))
        worst["tri_setup"] = max(worst["tri_setup"], float_err(got[1], want[1]))
        check(ok, f"tri_setup {tag}: the packed arrays differ from the plain version's (slots {got[2]} / "
                  f"{want[2]}, clipped {int(got[4]['num_clipped'])} / {int(want[4]['num_clipped'])})")
        return want, ok

    def check_bins(tag, packed, cfg, fused_path, **kw):
        ti, tf, n, c, _ = packed
        bins = (ti, tf, n, c, cfg.width, cfg.height, cfg.tile)
        kw = dict(bin_settings(cfg, fused_path), **kw)
        got, want = raster.bin_packed(*bins, **kw), plain(raster.bin_packed_plain, *bins, **kw)
        sort = sum(sort_bits(want, ti.shape[1])) <= 31
        ok = bins_equal(got, want, ti, tf, sort)
        if sort:
            worst["bin_pairs"] = max(worst["bin_pairs"], float_err(got.tri_f32, want.tri_f32))
        check(ok, f"bin_pairs {tag}: the binned prep differs from the plain version's "
                  f"({'packed' if sort else 'two-operand'} sort)")
        return got, ok, sort

    def report(tag, packed, got, ok_a, ok_b, sort, mode_tag):
        log(f"  {tag}: slots {packed[2]}, C={packed[3]}, faces clipped {int(packed[4]['num_clipped'])}: set-up "
            f"({mode_tag}) bit-equal={ok_a}; th={got.th}, {int(got.off[-1])} pairs in {got.tri_i32.shape[1]} columns, "
            f"ranges {range_sizes(got)}, the plain version's {'packed 31-bit' if sort else 'two-operand'} sort: "
            f"bins {'bit-equal' if sort else 'equal offsets, the same lists in slot order'}={ok_b}")

    def timing(tag, scene, packed, fused_path):
        """Device ms of the set-up kernels and the binning kernels, their
        entry points' and plain versions' ms, and their bounds."""
        cfg = scene.config
        args = (scene.draws, scene.vertex_shader, scene.vs_uniform, cfg)
        ti, tf, n, c, _ = packed
        bins = (ti, tf, n, c, cfg.width, cfg.height, cfg.tile)
        kw = bin_settings(cfg, fused_path)
        a_launch = setup_launch(lambda: build_packed(*args))
        a = timed(lambda: build_packed(*args), a_launch, lambda: build_packed_plain(*args), 20, 3)
        b_launch = kernel_call("bin_pairs", lambda: raster.bin_packed(*bins, **kw))
        b = timed(lambda: raster.bin_packed(*bins, **kw), b_launch, lambda: raster.bin_packed_plain(*bins, **kw), 20, 3)
        prep = raster.bin_packed(*bins, **kw)
        faces = sum(next(iter(d.values())).shape[0] for d in scene.draws)
        n_draws, nb = len(scene.draws), cfg.clip_cap * MAX_FAN
        clipping = sum(v > 0 for v in clipped_per_draw(scene, ANGLES[0]))
        m_pad, rows_f = ti.shape[1], tf.shape[0]
        # set-up: a builtin's vertex stage reads the attributes it takes and
        # the uniforms, and writes the planes at the corners of the clipped
        # faces and of each draw's last face (a custom shader's planes: read
        # whole); the fan words of each draw that clipped read, both arrays
        # and the face mask written. ~100 operations a face, and a stage's
        # mat_vec4 rows (7 each: 4 clip, 3 world for phong and gouraud) and
        # gouraud's lighting (~90) a corner; ~45 a path-B slot
        kind = getattr(scene.vertex_shader, "fused_kind", None)
        if kind is None:
            vertex_bytes, vertex_ops = 4 * (4 + c) * 3 * faces, 0
        else:
            names = [name for name, *_ in VERTEX_KINDS[kind].attributes]
            written = int(packed[4]["num_clipped"]) + sum(next(iter(d.values())).shape[0] > 0 for d in scene.draws)
            vertex_bytes = (sum(4 * d[k].numel() for d in scene.draws for k in names if k in d) + 4 * (48 + 3)
                            + 4 * (4 + c) * 3 * written)
            vertex_ops = 3 * faces * (28 + (21 if kind in ("phong", "gouraud") else 0) + (90 if kind == "gouraud" else 0))
        a_bytes = vertex_bytes + 4 * nb * (23 + 3 * c) * clipping + 4 * (12 + rows_f) * m_pad + faces
        a_ops = 100 * faces + vertex_ops + 45 * n_draws * nb
        # binning: the packed arrays read once, the pair-order arrays and the
        # offsets written; ~30 operations a slot and ~10 a pair
        pairs = int(prep.off[-1])
        b_bytes = 4 * (12 + rows_f) * (m_pad + prep.tri_i32.shape[1]) + 4 * prep.off.numel()
        b_ops = 30 * m_pad + 10 * pairs
        out = {}
        for name, (k_ms, p_ms, w_ms, each), nbytes, ops in (("tri_setup", a, a_bytes, a_ops),
                                                             ("bin_pairs", b, b_bytes, b_ops)):
            b_ms, b_by = bound_ms(nbytes, ops)
            out[name] = {"ms": k_ms, "ms_each": each[:2], "plain_ms": p_ms, "wrapper_ms": w_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "ops": ops}
            log(f"  {tag} {name} time: kernels {each[0]:.4f} / {each[1]:.4f} ms (device), entry point "
                f"{each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.3f} / {each[3]:.3f} ms, bound {b_ms:.4f} ms by "
                f"{b_by} ({nbytes} B, {ops} ops), share {b_ms / k_ms:.3f} (CUDA events; {smi})")
        return out

    cases = [("phong1080", a) for a in (0.10, 0.15, 0.20, 0.35)] + [
        ("stress4k", 0.10), ("phong1080_tex2048", 0.10), ("custom12_360", 0.3), ("sliver640", None),
        ("gouraud800", 0.1), ("gouraud800_color", 0.1), ("textured_wide", 0.2), ("phong_bin_k1", 0.3),
        ("cube1080_flat", 0.1)]
    for name, angle in cases:
        scene = build_scene(name, dev)
        set_angle(scene, angle)
        cfg = scene.config
        fused_path = (cfg.fused_shade and hasattr(scene.pixel_shader, "fused_kind")
                      and fused.fused_path_ok(scene.pixel_shader, scene.ps_uniform))
        mode = getattr(scene.vertex_shader, "fused_kind", None) or "planes"
        packed, ok_a = check_setup(f"{name}@{angle}", scene)
        got, ok_b, sort = check_bins(f"{name}@{angle}", packed, cfg, fused_path)
        report(f"{name}@{angle}", packed, got, ok_a, ok_b, sort, mode)
        if name == "phong1080" and angle == ANGLES[0]:
            cap = cfg.clip_cap
            for n in (1, cap, cap + 7):
                draws = clipped_draws(scene.draws, scene.vs_uniform, n)
                flip, ok_a = check_setup(f"phong1080 with {n} faces clipped", scene, draws)
                got, ok_b, sort = check_bins(f"phong1080 with {n} faces clipped", flip, cfg, fused_path)
                report(f"phong1080@{angle} with {n} faces of draw 0 clipped", flip, got, ok_a, ok_b, sort, mode)
            slab, oks = cfg.height // 8, []
            for lin in range(8):
                got, ok_b, sort = check_bins(f"phong1080 slab {lin} of 8", packed, cfg, fused_path,
                                             origin=(lin * slab, 0), size=(slab, cfg.width))
                oks.append(ok_b and sort)
            log(f"  phong1080@{angle}: the eight row slabs' bins (origin, size) bit-equal={oks}")
            times = timing(f"phong1080@{angle}", scene, packed, fused_path)
            for key, tag, source, replaces in (
                    ("tri_setup", "the builtin vertex stages and the triangle set-up, XLA's fusions",
                     "tri_setup.cu",
                     "f_renderer_tpu/pipeline/geometry.py:287 (no pallas_call: XLA's fusions of the builtin vertex "
                     "stages, geometry.py:287-308 over shaders/builtin.py:52-166, and of geometry.py:300-350, "
                     "render.py:113-202 and raster_pallas.py:178 pack_setup)"),
                    ("bin_pairs", "the binning and pair gather, XLA's fusions", "bin_pairs.cu",
                     "f_renderer_tpu/pipeline/raster_pallas.py:319 (no pallas_call: XLA's fusions of bin_pairs and "
                     "the pair gather, fused.py:160-183)")):
                rows[key] = dict({"name": f"{key} ({tag})", "route": "cuda",
                                  "source": f"f_renderer_tpu_torch/csrc/{source}", "replaces": replaces,
                                  "library_ms": None}, **times[key])
        if name == "stress4k":
            times = timing(f"stress4k@{angle}", scene, packed, fused_path)
            for key in ("tri_setup", "bin_pairs"):
                rows[key].update({f"stress4k_{k}": v for k, v in times[key].items()})
            cfg32 = dataclasses.replace(cfg, tile=(32, 128), tile_auto=False)
            got, ok_b, sort = check_bins("stress4k th=32", packed, cfg32, fused_path)
            check(not sort, "stress4k th=32: the plain version took the packed sort, not the two-operand one")
            report("stress4k@0.1 th=32", packed, got, ok_a, ok_b, sort, mode)
        del scene, packed, got
    for key in worst:
        rows[key]["max_abs_err"] = worst[key]
    rows["tri_setup"]["ptxas"] = [line for line in lines if line.startswith("tri_")]
    rows["bin_pairs"]["ptxas"] = [line for line in lines if line.startswith("bin_")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        import numpy as np
        import torch.distributed as dist

        from f_renderer_tpu_torch import compiled, kernels
        from f_renderer_tpu_torch.pipeline import fused, raster, shade
        from f_renderer_tpu_torch.pipeline.render import (
            build_packed, build_packed_plain, build_triangles, context_codec, rasterize, render_frame)
        from f_renderer_tpu_torch.shaders.builtin import VERTEX_KINDS, shade_plain
        from f_renderer_tpu_torch.voxel import octree, raycast
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    t_start = time.time()
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
    log(f"[build] nvcc sm_90a --fmad=false, one process per source: {time.time() - t0:.1f} s")
    for line in kernels.ptxas_report():
        log(f"[build] ptxas {line}")

    rows = {}  # kernel name → its JSON entry

    # 3a. K1 (+K2) against plain
    log(f"[time] {time.time() - t_start:.1f} s")
    log("[kernel-vs-plain] K1 fused_raster")
    worst_frame, worst_depth = 0, 0.0
    cases = [("phong1080", a) for a in ANGLES] + [
        ("phong_bin_k1", 0.3), ("textured_wide", 0.2), ("gouraud800", 0.1), ("cube1080_flat", 0.1),
        ("sliver640", None),
    ]
    for scene_name, angle in cases:
        scene = build_scene(scene_name, dev)
        set_angle(scene, angle)
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        prep = plain_prep(tri, scene.config, **bin_settings(scene.config, True))
        args = (prep, scene.pixel_shader, scene.ps_uniform, scene.config)
        got = fused.render_fused_prepared(*args)
        want = plain(fused.render_fused_plain, *args)
        f_err, d_err = compare_fused(f"{scene_name}@{angle} th={prep.th} pairs={prep.tri_i32.shape[1]} "
                                     f"ranges {range_sizes(prep)}", got, want)
        worst_frame, worst_depth = max(worst_frame, f_err), max(worst_depth, d_err)
        if scene_name == "phong1080" and "K1" not in rows:
            reference_frame = got[0].clone()
            launch = kernel_call("fused_raster", lambda: fused.render_fused_prepared(*args))
            plan, _, phong_plan = plan_check(f"phong1080@{angle}", launch, prep)
            tiles, what = check_tiles(prep, 3, with_coarse_and_empty=False, plan=plan)
            log(f"  phong1080@{angle} tiles held to rasterize_portable: {'; '.join(what)}")
            compare_portable(f"phong1080@{angle}", tri, prep, tiles, got, *SIZES["phong1080"])
            k_ms, p_ms, w_ms, each = timed(lambda: fused.render_fused_prepared(*args), launch,
                                           lambda: fused.render_fused_plain(*args), 20)
            _, win_p, ps_p, ctx_p = plain(raster.raster_planes_plain, prep, True)
            stack = scene.ps_uniform["textures"]
            tex = texel_bytes(stack, torch.where(win_p >= 0, ps_p, -1), ctx_p[6], ctx_p[7])
            # epilogue per pixel: interpolation (~30), phong (~90), sampler (~60), pack (~12)
            nbytes, ops, ops_every = raster_work(prep, 3, 192, extra_bytes=tex)
            b_ms, b_by = bound_ms(nbytes, ops)
            b2_ms, b2_by = bound_ms(nbytes, ops_every)
            rows["K1"] = {
                "name": "fused_raster (K1, K2 sampler inlined)", "route": "cuda",
                "source": "f_renderer_tpu_torch/csrc/fused_raster.cu",
                "replaces": "f_renderer_tpu/pipeline/fused.py:525",
                "also_replaces": "f_renderer_tpu/shaders/texture_pallas.py:95 (csrc/sampler.cuh)",
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "wrapper_ms": w_ms, "bound_ms_every_pixel": b2_ms, "bound_by_every_pixel": b2_by,
                "bytes": nbytes, "ops": ops, "ops_every_pixel": ops_every, "plan": phong_plan,
            }
            # the epilogue alone: the same launch with every pair list empty
            no_pairs = torch.zeros_like(prep.off)
            rows["K1"]["ms_no_pairs"] = [device_ms(lambda: launch(no_pairs), 20) for _ in range(2)]
            log(f"  phong1080 K1 with every pair list empty (background epilogue only): "
                f"{rows['K1']['ms_no_pairs']} ms (device)")
            log(f"  phong1080 K1 time: kernel {each[0]:.4f} / {each[1]:.4f} ms (device), wrapper "
                f"{each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.2f} / {each[3]:.2f} ms, bound "
                f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {ops} ops; at every pixel {ops_every} ops, "
                f"{b2_ms:.4f} ms by {b2_by}) (CUDA events; {smi})")
    rows["K1"]["max_abs_err"] = worst_frame
    rows["K1"]["max_abs_err_depth"] = worst_depth

    # 3a. K1 at stress4k: a million triangles at 3840x2160 through the
    # default config (th = 64, k = 2, bin_pairs' packed 31-bit sort), held to
    # the plain version and to rasterize_portable on eight tiles (the whole
    # plain frame tests every pixel of a tile against every pair of its lists)
    log(f"[time] {time.time() - t_start:.1f} s")
    log("[kernel-vs-plain] K1 fused_raster at stress4k")
    stress = build_scene("stress4k", dev)
    set_angle(stress, ANGLES[0])
    sw, sh = SIZES["stress4k"]
    tri, stats = build_triangles(stress.draws, stress.vertex_shader, stress.vs_uniform, stress.config)
    check(int(stats["num_clipped"]) <= stress.config.clip_cap, "stress4k: clip_cap dropped faces")
    prep = plain_prep(tri, stress.config, **bin_settings(stress.config, True))
    key_bits, slot_bits = sort_bits(prep, packed_columns(tri))
    check(prep.th == 64 and key_bits + slot_bits <= 31,
          f"stress4k: th {prep.th}, sort key {key_bits} + {slot_bits} bits: not the packed sort at th = 64")
    args = (prep, stress.pixel_shader, stress.ps_uniform, stress.config)
    stress_got = fused.render_fused_prepared(*args)
    launch = kernel_call("fused_raster", lambda: fused.render_fused_prepared(*args))
    plan, _, stress_plan = plan_check(f"stress4k@{ANGLES[0]}", launch, prep)
    ranges = tile_ranges(prep)
    heaviest = max(f + c for f, c, _ in ranges)
    tiles, what = check_tiles(prep, 5, plan=plan)
    log(f"  stress4k@{ANGLES[0]}: th={prep.th} slots {tri.num_slots} clipped {int(stats['num_clipped'])} "
        f"pair columns {prep.tri_i32.shape[1]} ranges {range_sizes(prep)} (fine/coarse/spill), tiles "
        f"{len(ranges)}, rows interleaved in {stress_plan['rows']}, heaviest tile {heaviest} fine + coarse "
        f"pairs; sort key {key_bits} + {slot_bits} = {key_bits + slot_bits} bits (packed)")
    log(f"  stress4k tiles checked: {'; '.join(what)}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(fused.render_fused_plain, *args, tiles=tiles)
    end.record()
    torch.cuda.synchronize()
    plain_tiles_ms = start.elapsed_time(end)
    f_err, d_err = compare_fused(f"stress4k@{ANGLES[0]} th={prep.th} on {len(tiles)} tiles",
                                 [crop_tiles(t, tiles, prep.th) for t in stress_got],
                                 [crop_tiles(t, tiles, prep.th) for t in want])
    del want
    p_err, portable_ms = compare_portable(f"stress4k@{ANGLES[0]}", tri, prep, tiles, stress_got, sw, sh)
    # a cap that most tiles' culled lists pass: those keep their whole ranges, and the frame stays the same
    plan64, got64, stress_plan64 = plan_check(f"stress4k@{ANGLES[0]}", launch, prep, cap=64)
    for part, a, b in zip(("frame", "depth", "winner"), fused._finish(*got64, prep), stress_got):
        check(torch.equal(a, b), f"stress4k: K1 {part}s with cull cap 64 ({stress_plan64['overflow']} tiles "
              f"overflowed) differ from the default cap's")
    check(stress_plan64["overflow"] > 0, "stress4k: no tile overflowed a cull cap of 64")
    log(f"  stress4k K1 with cull cap 64: frame, depth and winner equal the default cap's "
        f"({stress_plan64['overflow']} tiles overflowed)")
    del plan64, got64
    k_ms = [device_ms(launch, 10) for _ in range(2)]
    no_pairs = torch.zeros_like(prep.off)
    k_empty = [device_ms(lambda: launch(no_pairs), 10) for _ in range(2)]
    w_ms = cuda_ms(lambda: fused.render_fused_prepared(*args), 5)
    stack = stress.ps_uniform["textures"]
    # every texel of the 64^2 stack: a million triangles' random uvs reach them all
    nbytes, ops, ops_every = raster_work(prep, 3, 192, extra_bytes=4 * (stack.texels.numel() + stack.dims.numel()))
    b_ms, b_by = bound_ms(nbytes, ops)
    b2_ms, b2_by = bound_ms(nbytes, ops_every)
    log(f"  stress4k K1 time: kernel {k_ms[0]:.4f} / {k_ms[1]:.4f} ms (device), every pair list empty "
        f"{k_empty[0]:.4f} / {k_empty[1]:.4f} ms, wrapper {w_ms:.4f} ms, plain on the {len(tiles)} checked "
        f"tiles only {plain_tiles_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {ops} ops; at every "
        f"pixel {ops_every} ops, {b2_ms:.4f} ms by {b2_by}), share {b_ms / min(k_ms):.3f} (CUDA events; {smi})")
    rows["K1"].update(
        stress4k_ms=sum(k_ms) / 2, stress4k_ms_each=k_ms, stress4k_ms_no_pairs=k_empty, stress4k_wrapper_ms=w_ms,
        stress4k_plain_ms_checked_tiles=plain_tiles_ms, stress4k_checked_tiles=len(tiles),
        stress4k_portable_ms_checked_tiles=portable_ms,
        stress4k_bound_ms=b_ms, stress4k_bound_by=b_by, stress4k_bound_ms_every_pixel=b2_ms,
        stress4k_bound_by_every_pixel=b2_by, stress4k_bytes=nbytes, stress4k_ops=ops,
        stress4k_ops_every_pixel=ops_every, stress4k_max_abs_err=f_err, stress4k_max_abs_err_depth=max(d_err, p_err),
        stress4k_th=prep.th, stress4k_pair_columns=prep.tri_i32.shape[1], stress4k_ranges=range_sizes(prep),
        stress4k_plan=stress_plan, stress4k_plan_cap64=stress_plan64, stress4k_tiles=len(ranges),
        stress4k_heaviest_tile_pairs=heaviest,
        stress4k_sort_bits=key_bits + slot_bits,
    )
    del launch

    # the second sort path: 32-row tiles (tile_auto off, or the slot count
    # would raise them to 64) need a 12-bit key, 32 bits with the slot: the
    # stable two-operand sort. The same pixels, so the same frame.
    cfg32 = dataclasses.replace(stress.config, tile=(32, 128), tile_auto=False)
    prep32 = plain_prep(tri, cfg32, **bin_settings(cfg32, True))
    key_bits, slot_bits = sort_bits(prep32, packed_columns(tri))
    check(prep32.th == 32 and key_bits + slot_bits > 31,
          f"stress4k th=32: th {prep32.th}, sort key {key_bits} + {slot_bits} bits: not the two-operand sort")
    args32 = (prep32, stress.pixel_shader, stress.ps_uniform, cfg32)
    got32 = fused.render_fused_prepared(*args32)
    for part, a, b in zip(("frame", "depth", "winner"), got32, stress_got):
        check(torch.equal(a, b), f"stress4k: th=32 (two-operand sort) and th=64 (packed sort) K1 {part}s differ "
              f"at {int((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1).sum())} px")
    tiles32 = [(2 * ty + half, tx) for ty, tx in tiles for half in (0, 1) if (2 * ty + half) * 32 < sh]
    want32 = plain(fused.render_fused_plain, *args32, tiles=tiles32)
    f32_err, d32_err = compare_fused(
        f"stress4k@{ANGLES[0]} th=32 (sort key {key_bits} + {slot_bits} bits, two-operand) ranges "
        f"{range_sizes(prep32)} on the same pixels ({len(tiles32)} tiles)",
        [crop_tiles(t, tiles32, 32) for t in got32], [crop_tiles(t, tiles32, 32) for t in want32])
    k32 = device_ms(kernel_call("fused_raster", lambda: fused.render_fused_prepared(*args32)), 10)
    log(f"  stress4k K1 at th=32: frame equal to th=64's={all(torch.equal(a, b) for a, b in zip(got32, stress_got))}, "
        f"kernel {k32:.4f} ms (device; {smi})")
    rows["K1"].update(stress4k_th32_ms=k32, stress4k_th32_max_abs_err=f32_err,
                      stress4k_th32_max_abs_err_depth=d32_err)
    stress_frame = stress_got[0].clone()
    del prep32, args32, got32, want32, prep, args, stress_got, tri

    # 3b. K4 against plain, both entry points; 3c. K3 on the same planes
    log(f"[time] {time.time() - t_start:.1f} s")
    log("[kernel-vs-plain] K4 raster_planes, K3 sample_bilinear")
    worst_ctx, worst_d4, worst_sample, worst_frame4 = 0.0, 0.0, 0.0, 0
    for scene_name, angles in (("phong1080_tex2048", ANGLES), ("custom12_360", (0.3,)), ("sliver640", (None,)),
                               ("phong_bin_k1", (0.3,))):
        scene = build_scene(scene_name, dev)
        if scene_name == "phong1080_tex2048":
            stack = scene.ps_uniform["textures"]
            check(not fused.fused_path_ok(scene.pixel_shader, scene.ps_uniform),
                  f"{scene_name}: the {stack.packed_nbytes} B stack should leave the fused path")
        codec = context_codec(scene.vertex_shader, scene.vs_uniform, scene.draws[0])
        for angle in angles:
            set_angle(scene, angle)
            tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
            prep = plain_prep(tri, scene.config, bin_k=scene.config.bin_k)
            tag = (f"{scene_name}@{angle} C={prep.n_ctx} th={prep.th} pairs={prep.tri_i32.shape[1]} "
                   f"ranges {range_sizes(prep)}")
            e_ctx, e_d = compare_planes(f"{tag} rasterize", raster.raster_planes(prep, False),
                                        plain(raster.raster_planes_plain, prep, False))
            got = raster.raster_planes(prep, True)
            want = plain(raster.raster_planes_plain, prep, True)
            e_ctx2, e_d2 = compare_planes(f"{tag} rasterize_interp", got, want)
            worst_ctx, worst_d4 = max(worst_ctx, e_ctx, e_ctx2), max(worst_d4, e_d, e_d2)
            h, w = prep.height, prep.width
            depth_k, winner_k, ps_k, ctx_k = (t[..., :h, :w] for t in got)
            depth_p, winner_p, ps_p, ctx_p = (t[..., :h, :w] for t in want)
            bg = scene.config.background
            if scene_name in ("sliver640", "phong_bin_k1"):  # planes only: their phong shader samples through K3
                continue
            if scene_name != "phong1080_tex2048":
                frame_k = shade.shade_from_planes(ctx_k, ps_k, winner_k, scene.pixel_shader,
                                                  scene.ps_uniform, codec, background=bg)
                frame_p = plain(shade.shade_from_planes, ctx_p, ps_p, winner_p, scene.pixel_shader,
                                scene.ps_uniform, codec, background=bg)
                worst_frame4 = max(worst_frame4, frame_bar(f"{tag} frame", frame_k, frame_p)[0])
                # K4 at custom12_360 (C = 12): its plan and device time
                launch = kernel_call("raster_planes", lambda: raster.raster_planes(prep, True))
                _, _, rows["K4"]["custom12_360_plan"] = plan_check(f"{scene_name}@{angle} K4", launch, prep)
                rows["K4"]["custom12_360_ms"] = [device_ms(launch, 20) for _ in range(2)]
                # as at phong1080_tex2048: interpolation of C varyings (~20 + 5C) a pixel
                nbytes, ops, _ = raster_work(prep, 3 + prep.n_ctx, 20 + 5 * prep.n_ctx)
                b_ms, b_by = bound_ms(nbytes, ops)
                rows["K4"].update(custom12_360_bound_ms=b_ms, custom12_360_bound_by=b_by,
                                  custom12_360_bytes=nbytes, custom12_360_ops=ops)
                log(f"  {scene_name}@{angle} K4 time (rasterize_interp, C={prep.n_ctx}): "
                    f"{' / '.join(f'{v:.4f}' for v in rows['K4']['custom12_360_ms'])} ms (device), bound "
                    f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {ops} ops), share "
                    f"{b_ms / min(rows['K4']['custom12_360_ms']):.3f} ({smi})")
                continue
            # K3 on the main path's samples: the texture id where a pair won, uv.
            psm = torch.where(winner_k >= 0, ps_k, -1).contiguous()
            u, v = ctx_k[6].contiguous(), ctx_k[7].contiguous()
            s_k = stack.sample(psm, u, v)
            s_p = plain(stack.sample_plain, psm, u, v)
            s_err = float((s_k - s_p).abs().max())
            worst_sample = max(worst_sample, s_err)
            check(s_err <= SAMPLE_ATOL, f"{tag}: K3 samples differ by {s_err}")
            frame_k = shade.shade_from_planes(ctx_k, ps_k, winner_k, scene.pixel_shader,
                                              scene.ps_uniform, codec, background=bg)
            frame_p = plain(shade.shade_from_planes, ctx_p, ps_p, winner_p,
                            lambda uu, ctx, ps: shade_plain("phong", uu, ctx, ps),
                            scene.ps_uniform, codec, background=bg)
            f_err = frame_bar(f"{tag} frame", frame_k, frame_p)[0]
            worst_frame4 = max(worst_frame4, f_err)
            log(f"  {tag}: K3 max abs err {s_err:.3g}, frame (K4 + K3) max diff {f_err} u8")
            if "K4" in rows:
                continue
            tex2048_frame = frame_k.clone()
            launch = kernel_call("raster_planes", lambda: raster.raster_planes(prep, True))
            _, _, k4_plan = plan_check(f"{scene_name}@{angle} K4", launch, prep)
            k_ms, p_ms, w_ms, each = timed(lambda: raster.raster_planes(prep, True), launch,
                                           lambda: raster.raster_planes_plain(prep, True), 20)
            # epilogue per pixel: interpolation of C varyings (~20 + 5C)
            nbytes, ops, ops_every = raster_work(prep, 3 + prep.n_ctx, 20 + 5 * prep.n_ctx)
            b_ms, b_by = bound_ms(nbytes, ops)
            b2_ms, b2_by = bound_ms(nbytes, ops_every)
            rows["K4"] = {
                "name": "raster_planes (K4)", "route": "cuda",
                "source": "f_renderer_tpu_torch/csrc/raster_planes.cu",
                "replaces": "f_renderer_tpu/pipeline/raster_pallas.py:1562",
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "wrapper_ms": w_ms, "bound_ms_every_pixel": b2_ms, "bound_by_every_pixel": b2_by,
                "bytes": nbytes, "ops": ops, "ops_every_pixel": ops_every, "plan": k4_plan,
            }
            # the epilogue alone: every pair list empty, all 3 + C planes of background
            no_pairs = torch.zeros_like(prep.off)
            rows["K4"]["ms_no_pairs"] = [device_ms(lambda: launch(no_pairs), 20) for _ in range(2)]
            # the loop with K4's smallest epilogue (depth and winner planes only)
            rows["K4"]["ms_rasterize"] = [device_ms(lambda: launch(interp=False), 20) for _ in range(2)]
            # the heaviest tile's fine range alone, and every list but it
            only, pairs = heaviest_tile_lists(prep)
            rows["K4"]["ms_rasterize_heaviest_tile"] = [device_ms(lambda: launch(only, interp=False), 20)
                                                        for _ in range(2)]
            log(f"  phong1080_tex2048 K4 with every pair list empty: {rows['K4']['ms_no_pairs']} ms; "
                f"rasterize (no varyings): {rows['K4']['ms_rasterize']} ms; with only the "
                f"heaviest tile's {pairs} fine pairs: {rows['K4']['ms_rasterize_heaviest_tile']} ms (device)")
            log(f"  phong1080_tex2048 K4 time (rasterize_interp, C={prep.n_ctx}): kernel {each[0]:.4f} / "
                f"{each[1]:.4f} ms (device), wrapper {each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.2f} / "
                f"{each[3]:.2f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {ops} ops; at every pixel "
                f"{ops_every} ops, {b2_ms:.4f} ms by {b2_by}) (CUDA events; {smi})")
            launch = kernel_call("sample_bilinear", lambda: stack.sample(psm, u, v))
            k_ms, p_ms, w_ms, each = timed(lambda: stack.sample(psm, u, v), launch,
                                           lambda: stack.sample_plain(psm, u, v), 50, 3)
            n, n_tex = psm.numel(), int((psm >= 0).sum())
            # per sample: ids, uv and 4 outputs; ~60 operations where it has a texture
            nbytes = 28 * n + texel_bytes(stack, psm, u, v)
            b_ms, b_by = bound_ms(nbytes, 60 * n_tex + 2 * n)
            rows["K3"] = {
                "name": "sample_bilinear (K3)", "route": "cuda",
                "source": "f_renderer_tpu_torch/csrc/sample_bilinear.cu",
                "replaces": "f_renderer_tpu/shaders/texture_pallas.py:497",
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "wrapper_ms": w_ms, "bytes": nbytes, "ops": 60 * n_tex + 2 * n,
            }
            log(f"  phong1080_tex2048 K3 time ({n} samples, {n_tex} textured): kernel {each[0]:.4f} / "
                f"{each[1]:.4f} ms (device), wrapper {each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.2f} / "
                f"{each[3]:.2f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B) (CUDA events; {smi})")
    rows["K4"]["max_abs_err"] = worst_ctx
    rows["K4"]["max_abs_err_depth"] = worst_d4
    rows["K4"]["max_abs_err_frame_u8"] = worst_frame4
    rows["K3"]["max_abs_err"] = worst_sample

    # 3d. the voxel ray set-up kernel against plain: the eight planes, then
    # the frames K5 marches from them
    log(f"[time] {time.time() - t_start:.1f} s")
    log("[kernel-vs-plain] voxel_setup (the ray set-up)")
    grid_color, grid_hit = octree.densify(octree.gen_randomly(VOXEL_LEVEL, np.random.default_rng(0)), VOXEL_LEVEL)
    table = raycast.voxel_table(torch.as_tensor(grid_color, device=dev), torch.as_tensor(grid_hit, device=dev))
    setup_lines = [line for line in kernels.ptxas_report() if line.startswith("voxel_setup_kernel:")]
    for line in setup_lines:
        log(f"  ptxas {line}")
    check(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in line for line in setup_lines),
          f"voxel_setup_kernel: a stack frame or spills ({setup_lines})")
    base_cfg = raycast.VoxelRenderConfig(width=VOXEL_W, height=VOXEL_H, level=VOXEL_LEVEL, length=VOXEL_LENGTH)
    cases = [(f"orbit {i}", *voxel_view(i), base_cfg) for i in range(FRAMES)]
    cases += [(view, eye, inv, base_cfg) for view, eye, inv in setup_views()]
    cases.append(("orbit 0 at length 3.0", *voxel_view(0, 3.0), dataclasses.replace(base_cfg, length=3.0)))
    worst_setup = 0.0
    for view, eye, inv_mvp, cfg in cases:
        eye, inv_mvp = torch.from_numpy(eye).to(dev), torch.from_numpy(inv_mvp).to(dev)
        got = raycast.prepare_rays(eye, inv_mvp, cfg)
        want = plain(raycast.prepare_rays_plain, eye, inv_mvp, cfg)
        ok, err = planes_equal(got, want)
        worst_setup = max(worst_setup, err)
        k = raycast.march_constants(cfg, grid_hit.shape[0])
        frame_k, frame_p = raycast.march(*got, table, k), raycast.march(*want, table, k)
        check(ok, f"voxel_setup {view}: the planes differ from the plain version's (max abs err {err})")
        check(torch.equal(frame_k, frame_p), f"voxel_setup {view}: the marched frames differ at "
              f"{int((frame_k != frame_p).sum())} rays")
        log(f"  voxel_setup {view} (length {cfg.length}): eight planes bit-equal={ok}, alive share "
            f"{float(got[3].float().mean()):.4f}, NaN t_max {int(torch.isnan(got[2]).sum())}, frames marched "
            f"from them equal={torch.equal(frame_k, frame_p)}")
    eye0, inv0 = (torch.from_numpy(a).to(dev) for a in voxel_view(0))
    launch = kernel_call("voxel_setup", lambda: raycast.prepare_rays(eye0, inv0, base_cfg))
    k_ms, p_ms, w_ms, each = timed(lambda: raycast.prepare_rays(eye0, inv0, base_cfg), launch,
                                   lambda: raycast.prepare_rays_plain(eye0, inv0, base_cfg), 20)
    n = VOXEL_W * VOXEL_H
    # inputs read once (eye, inv_mvp), seven f32 planes and one bool plane
    # written; ~340 float32 operations a ray on the cnt <= 2 shortcut that
    # every ray needs at least (the kernel's note counts them)
    nbytes, ops = 12 + 64 + 29 * n, 340 * n
    b_ms, b_by = bound_ms(nbytes, ops)
    rows["setup"] = {
        "name": "voxel_setup (the voxel ray set-up, XLA's fusion)", "route": "cuda",
        "source": "f_renderer_tpu_torch/csrc/voxel_setup.cu",
        "replaces": "f_renderer_tpu/voxel/raycast.py:34 (no pallas_call: XLA's fusion of raycast.py:34-264, "
                    "fenced at raycast_pallas.py:310)",
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "wrapper_ms": w_ms, "max_abs_err": worst_setup, "bytes": nbytes, "ops": ops, "ptxas": setup_lines,
    }
    log(f"  voxel540 voxel_setup time: kernel {each[0]:.4f} / {each[1]:.4f} ms (device), wrapper "
        f"{each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.2f} / {each[3]:.2f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes} B, {ops} ops), share {b_ms / k_ms:.3f} (CUDA events; {smi})")

    # 3e. K5 against plain, on every main-path view
    log(f"[time] {time.time() - t_start:.1f} s")
    log("[kernel-vs-plain] K5 voxel_march")
    for traversal in ("fixed", "dda"):
        cfg = raycast.VoxelRenderConfig(width=VOXEL_W, height=VOXEL_H, level=VOXEL_LEVEL,
                                        length=VOXEL_LENGTH, traversal=traversal)
        k = raycast.march_constants(cfg, grid_hit.shape[0])
        worst = 0
        row = {}
        for i in range(FRAMES):
            eye, inv_mvp = voxel_view(i)
            rays = raycast.prepare_rays(torch.from_numpy(eye).to(dev), torch.from_numpy(inv_mvp).to(dev), cfg)
            got = raycast.march(*rays, table, k)
            want, per_ray = plain(raycast.march_plain, *rays, table, k, count_queries=True)
            queries = int(per_ray.sum())
            err = int((got.view(torch.uint8).int() - want.view(torch.uint8).int()).abs().max())
            worst = max(worst, err)
            hit = float((got != k.bg_packed).float().mean())
            check(torch.equal(got, want), f"voxel540 {traversal} frame {i}: BGRA differs at "
                  f"{int((got != want).sum())} rays")
            serial = ""
            if not k.dda:  # the serial chain without the jump: the independent oracle
                want_s, queries_s = check_serial(f"voxel540 fixed frame {i}", got, rays, table, k)
                serial = f", serial chain equal={torch.equal(got, want_s)} ({queries_s} queries)"
                if i == 0:
                    row["queries_serial"] = queries_s
            log(f"  voxel540 {traversal} frame {i}: BGRA equal={torch.equal(got, want)}, "
                f"hit share {hit:.4f}, queries {queries}{serial}")
            if i == 0:
                rays0, queries0 = rays, queries
                row["queries_warp_max"], row["queries_warp_mean"] = warp_queries(per_ray)
                log(f"  voxel540 {traversal} frame 0: queries per warp of 32 rays in row order: largest "
                    f"{row['queries_warp_max']:.3f}, mean {row['queries_warp_mean']:.3f} (mean over warps; "
                    f"a static warp runs {row['queries_warp_max'] / row['queries_warp_mean']:.3f}x the "
                    f"queries its rays need)")
        if not k.dda:
            log(f"  voxel540 fixed frame 0: the serial chain makes {row['queries_serial']} queries, "
                f"{row['queries_serial'] / queries0:.2f}x the jump's")
        launch = kernel_call("voxel_march", lambda: raycast.march(*rays0, table, k))
        k_ms, p_ms, w_ms, each = timed(lambda: raycast.march(*rays0, table, k), launch,
                                       lambda: raycast.march_plain(*rays0, table, k), 10)
        # the same launch with every ray dead: the hit-bit pass, the launch and the output
        dead = torch.zeros_like(rays0[3], dtype=torch.int32)
        row["ms_no_rays"] = device_ms(lambda: launch(*rays0[:3], dead), 10)
        log(f"  voxel540 {traversal} K5 with every ray dead: {row['ms_no_rays']:.4f} ms (device)")
        n = rays0[2].numel()
        # per ray: 8 input planes, 1 output; the table, times and hit bits; ~25 operations a query
        nbytes = 36 * n + 4 * table.numel() + 4 * k.n_times + table.numel() // 8
        ops = 25 * queries0 + 5 * n
        b_ms, b_by = bound_ms(nbytes, ops)
        rows[f"K5 {traversal}"] = dict(row, **{
            "name": f"voxel_march {traversal} (K5)", "route": "cuda",
            "source": "f_renderer_tpu_torch/csrc/voxel_march.cu",
            "replaces": "f_renderer_tpu/voxel/raycast_pallas.py:393",
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "wrapper_ms": w_ms, "max_abs_err": worst, "bytes": nbytes, "ops": ops, "queries": queries0,
        })
        log(f"  voxel540 {traversal} K5 time: kernel {each[0]:.4f} / {each[1]:.4f} ms (device), wrapper "
            f"{each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.2f} / {each[3]:.2f} ms, bound {b_ms:.4f} ms "
            f"by {b_by} ({queries0} queries) (CUDA events; {smi})")
        if not k.dda:
            # the serial chain's queries over the same bytes
            b2_ms, b2_by = bound_ms(36 * n + 4 * table.numel(), 25 * row["queries_serial"] + 5 * n)
            rows["K5 fixed"].update(bound_ms_serial=b2_ms, bound_by_serial=b2_by)

    # 3f. K5 at level 6, where the hit bitmap (256 KiB) leaves shared memory for L2
    color6, hit6 = octree.densify(octree.gen_randomly(6, np.random.default_rng(1)), 6)
    table6 = raycast.voxel_table(torch.as_tensor(color6, device=dev), torch.as_tensor(hit6, device=dev))
    eye, inv_mvp = (torch.from_numpy(a).to(dev) for a in voxel_view(0))
    for traversal in ("fixed", "dda"):
        cfg = raycast.VoxelRenderConfig(width=VOXEL_W // 4, height=VOXEL_H // 4, level=6,
                                        length=VOXEL_LENGTH, traversal=traversal)
        k = raycast.march_constants(cfg, hit6.shape[0])
        rays = raycast.prepare_rays(eye, inv_mvp, cfg)
        got = raycast.march(*rays, table6, k)
        want, queries = plain(raycast.march_plain, *rays, table6, k, count_queries=True)
        queries = int(queries.sum())
        check(torch.equal(got, want), f"level 6 {traversal}: BGRA differs at {int((got != want).sum())} rays")
        serial = ""
        if not k.dda:
            want_s, queries_s = check_serial("level 6 fixed", got, rays, table6, k)
            serial = f", serial chain equal={torch.equal(got, want_s)} ({queries_s} queries)"
        log(f"  level 6 {traversal} ({cfg.width}x{cfg.height}, bitmap through L2): BGRA equal="
            f"{torch.equal(got, want)}, hit share {float((got != k.bg_packed).float().mean()):.4f}, "
            f"queries {queries}{serial}")

    # 3g. K5 dda at length 3.0: cell 3/16 is no power of two, so the kernel divides
    cfg = raycast.VoxelRenderConfig(width=VOXEL_W, height=VOXEL_H, level=VOXEL_LEVEL, length=3.0,
                                    traversal="dda")
    k = raycast.march_constants(cfg, grid_hit.shape[0])
    check(k.inv_cell == 0.0, f"length 3.0: cell {k.cell} taken for a power of two")
    eye, inv_mvp = (torch.from_numpy(a).to(dev) for a in voxel_view(0, 3.0))
    rays = raycast.prepare_rays(eye, inv_mvp, cfg)
    got = raycast.march(*rays, table, k)
    want, queries = plain(raycast.march_plain, *rays, table, k, count_queries=True)
    check(torch.equal(got, want), f"length 3.0 dda: BGRA differs at {int((got != want).sum())} rays")
    log(f"  length 3.0 dda (cell {k.cell}, divided): BGRA equal={torch.equal(got, want)}, hit share "
        f"{float((got != k.bg_packed).float().mean()):.4f}, queries {int(queries.sum())}")

    setup_phase(dev, smi, rows)

    log(f"[time] {time.time() - t_start:.1f} s")
    # 4. the main paths, each with the counters set to 0 just before it
    def checksum(path, outs, shape):
        """Each frame's shape checked → a checksum of the frames."""
        total = 0
        for out in outs:
            frame = out[0] if isinstance(out, tuple) else out
            check(tuple(frame.shape) == shape and frame.dtype == torch.uint8, f"{path}: frame shape {tuple(frame.shape)}")
            total += int(frame[::97, ::89, :3].int().sum())
        return total

    def drive(path, render, frames, expect, shape):
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        outs = []
        t_host = time.time()
        start.record()
        for i in range(frames):
            outs.append(render(i))  # a frame, or (frame, depth, stats)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.time() - t_host) * 1e3 / frames
        got = counts()
        frame_ms = start.elapsed_time(end) / frames
        check(got == expect, f"{path}: launches {got}, expected {expect}")
        log(f"[main-path] {path} x{frames}: launches {got}, frame {frame_ms:.3f} ms (CUDA events), "
            f"host {host_ms:.3f} ms/frame, checksum {checksum(path, outs, shape)} ({smi})")
        return outs, got

    def stages(path, parts, reps=5):
        """Each stage of one frame alone, after the main path's counts were
        read: CUDA events around ``reps`` runs (host launch gaps included)."""
        times = []
        for label, fn in parts:
            fn()
            times.append(f"{label} {cuda_ms(fn, reps):.3f} ms")
        log(f"[stages] {path}: " + ", ".join(times) + f" ({smi})")

    def raster_stages(path, scene):
        cfg = scene.config
        args = (scene.draws, scene.vertex_shader, scene.vs_uniform, cfg)
        ti, tf, n, c, _ = build_packed(*args)
        fused_ok = fused.fused_path_ok(scene.pixel_shader, scene.ps_uniform)
        bins = (ti, tf, n, c, cfg.width, cfg.height, cfg.tile)
        kw = bin_settings(cfg, fused_ok)
        parts = [("set-up (the tri_setup kernels, a builtin's vertex stage in launch 1, the clip path: "
                  "build_packed)",
                  lambda: build_packed(*args)),
                 ("its plain version (build_triangles + pack_binned)", lambda: build_packed_plain(*args)),
                 ("bin (the bin_pairs kernels: bin_packed)", lambda: raster.bin_packed(*bins, **kw)),
                 ("its plain version (bin_packed_plain)", lambda: raster.bin_packed_plain(*bins, **kw))]
        prep = raster.bin_packed(*bins, **kw)
        if fused_ok:
            parts += [("K1", lambda: fused.render_fused_prepared(prep, scene.pixel_shader, scene.ps_uniform, cfg))]
        else:
            codec = context_codec(scene.vertex_shader, scene.vs_uniform, scene.draws[0])
            depth, winner, ps, ctx = (t[..., :cfg.height, :cfg.width] for t in raster.raster_planes(prep, True))
            parts += [("K4", lambda: raster.raster_planes(prep, True)),
                      ("shade (with K3)", lambda: shade.shade_from_planes(
                          ctx, ps, winner, scene.pixel_shader, scene.ps_uniform, codec, background=cfg.background))]
        stages(path, parts)

    zero = dict.fromkeys(counts(), 0)
    launches = {}
    compiled.CACHE.debug = True  # each graph keeps its nodes until graph_summary() reads them

    counted = []  # the graph paths' main-path runs, made after every timing (4b)
    split_frames = {}  # path → (its GraphFrame, its replay ms, a call that loads the bench camera's frame)

    def graph_path(path, entry, eager, frames, expect, shape, keys, geometries=0, max_nodes=None):
        """A main path through its entry point, whose frames replay one
        captured graph (``entry(i)``: frame i), beside its first
        ``EAGER_FRAMES`` frames run eagerly (``eager(i)``): the first call
        captures; the graph's kernel nodes equal the launches of one eager
        frame; the replays are timed; the eager frames are bit-equal to the
        graph's; a replay into sentinel-filled static outputs overwrites
        them; then the input copy, the replay and the output clone are timed
        alone. The graph must hold one conditional node (the clip path) for
        each of its ``geometries`` (draws, times face shards), and fewer than
        ``max_nodes`` nodes where that is given. The counted run of its first frames as replays (launches from
        the device's trace) comes in 4b, after every timing, so that no time
        is taken after tracing: ``keys`` maps the JSON line's launch keys to
        wrapper names."""
        torch.cuda.synchronize()
        before = compiled.CACHE.captures
        t0 = time.perf_counter()
        entry(0)  # the eager warm-up frame, then the capture
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        check(compiled.CACHE.captures == before + 1,
              f"{path}: the first frame captured {compiled.CACHE.captures - before} graphs, not 1")
        frame = compiled.CACHE.last
        nodes, conds, own, in_bodies = graph_summary(frame)
        per_frame = {k: n // frames for k, n in expect.items()}
        check(nodes == per_frame, f"{path}: the graph holds kernel nodes {nodes}, one frame launches {per_frame}")
        check(conds == geometries, f"{path}: the graph holds {conds} conditional nodes, not one for each of its "
                                   f"{geometries} draws' geometries")
        if max_nodes is not None:
            check(own < max_nodes, f"{path}: the graph holds {own} nodes, not fewer than {max_nodes}")
            log(f"[graph] {path}: {own} nodes (fewer than {max_nodes}: {own < max_nodes})")

        def timed(run, n):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t_host = time.time()
            start.record()
            res = [run(i) for i in range(n)]
            end.record()
            torch.cuda.synchronize()
            return res, start.elapsed_time(end) / n, (time.time() - t_host) * 1e3 / n

        reset_counts()
        outs, graph_ms, graph_host_ms = timed(entry, frames)
        check(counts() == zero, f"{path}: a graph frame called a wrapper ({counts()}), so it was no replay")
        check(compiled.CACHE.captures == before + 1, f"{path}: a frame of equal key captured anew")
        n_eager = min(EAGER_FRAMES, frames)
        want, eager_ms, eager_host_ms = timed(eager, n_eager)
        check(counts() == {k: n * n_eager for k, n in per_frame.items()},
              f"{path}: {n_eager} eager frames launched {counts()}, one launches {per_frame}")
        equal = [same(g, e) for g, e in zip(outs, want)]
        check(all(equal), f"{path}: graph frames {[i for i, e in enumerate(equal) if not e]} differ from the eager frames")
        for t in frame.outputs:
            fill_sentinel(t)
        sentinel = entry(0)
        want_leaves = compiled.flatten(want[0])[0]
        check(same(sentinel, want[0]) and all(torch.equal(a, b) for a, b in zip(frame.outputs, want_leaves)),
              f"{path}: a replay did not overwrite its sentinel-filled outputs with the eager frame")
        sources = [t.clone() for t in frame.inputs]
        frame.result()  # the allocator's first blocks for the clones
        copy_ms = cuda_ms(lambda: [d.copy_(s) for d, s in zip(frame.inputs, sources)], 10)
        replay_ms = cuda_ms(frame.replay, 10)
        clone_ms = cuda_ms(frame.result, 10)
        in_bytes = sum(t.numel() * t.element_size() for t in frame.inputs)
        out_bytes = sum(t.numel() * t.element_size() for t in frame.outputs)
        log(f"[time] {time.time() - t_start:.1f} s")
        log(f"[graph] {path}: capture {frame.capture_ms:.1f} ms (first call, warm-up frame included, "
            f"{first_ms:.1f} ms), pool {frame.graph.pool_bytes} B, graph frame {graph_ms:.3f} ms (host "
            f"{graph_host_ms:.3f} ms) over {frames} frames, eager frame {eager_ms:.3f} ms (host {eager_host_ms:.3f} "
            f"ms) over the first {n_eager}, each bit-equal to its graph frame; alone: input copy {copy_ms:.4f} ms "
            f"({in_bytes} B), replay {replay_ms:.3f} ms, output clone {clone_ms:.4f} ms ({out_bytes} B); "
            f"kernel nodes {nodes}; {own} nodes, {conds} of them conditional (a draw's clip path each), "
            f"{in_bodies} nodes in their bodies (CUDA events; {smi})")
        counted.append((path, entry, frames, expect, shape, outs, keys))
        split_frames[path] = (frame, replay_ms, lambda: entry(0))
        return outs

    def render_eager(s):
        return render_frame(list(s.draws), s.vertex_shader, s.vs_uniform, s.pixel_shader, s.ps_uniform, s.config)

    def recapture(tag, scene):
        """After a change of key: the next frame captures anew, and it and a
        replay equal the eager frame."""
        before = compiled.CACHE.captures
        got = [scene.render() for _ in range(2)]
        want = render_eager(scene)
        ok = compiled.CACHE.captures == before + 1 and same(got[0], want) and same(got[1], want)
        check(ok, f"phong1080 {tag}: {compiled.CACHE.captures - before} captures, frames equal eager "
              f"{same(got[0], want)} / {same(got[1], want)}")
        log(f"[graph] phong1080 {tag}: captured anew, the first frame and a replay equal the eager frame={ok}")

    def clip_flip(path, scene, entry, eager, single=None):
        """One captured graph replayed across frames whose draw 0 flips
        between clipped and unclipped faces: corner 0 of 1, 0, cap, 0,
        cap + 7 and 1 of its faces moved through the near plane
        (``clipped_draws``). Each replay (``entry()``) bit-equal to the same
        frame run eagerly (``eager()``) and, where ``single`` is given, its
        frame and depth to the single-device frame; no capture anew."""
        from f_renderer_tpu_torch.pipeline.geometry import geometry_process

        cfg, base, cap = scene.config, scene.draws, scene.config.clip_cap
        before, seen = compiled.CACHE.captures, []
        try:
            for n in (1, 0, cap, 0, cap + 7, 1):
                scene.draws = clipped_draws(base, scene.vs_uniform, n) if n else base
                _, stats = geometry_process(scene.draws[0], scene.vertex_shader, scene.vs_uniform, cfg.width,
                                            cfg.height, clip_cap=cap)
                got, want = entry(), eager()
                ok = same(got, want)
                if single is not None:
                    one = single()
                    ok = ok and torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
                seen.append((n, int(stats["num_clipped"]), ok))
        finally:
            scene.draws = base
        ok = all(n == c and e for n, c, e in seen) and compiled.CACHE.captures == before
        check(ok, f"{path}: across clipped / unclipped frames (faces moved, clipped, equal) {seen}, "
                  f"{compiled.CACHE.captures - before} captures")
        log(f"[graph] {path}: one graph replayed across draw 0's faces clipped {[c for _, c, _ in seen]} (clip_cap "
            f"{cap}), each replay bit-equal to its eager frame{' and to the single-device frame' if single else ''}"
            f"={all(e for *_, e in seen)}, captures anew {compiled.CACHE.captures - before}")

    scene = build_scene("phong1080", dev)
    w, h = SIZES["phong1080"]

    def phong_frame(i, s=scene):
        set_angle(s, 0.10 + 0.05 * i)
        return s.render()

    def phong_eager(i, s=scene):
        set_angle(s, 0.10 + 0.05 * i)
        return render_eager(s)

    outs = graph_path("phong1080 Scene.render()", phong_frame, phong_eager, FRAMES,
                      dict(zero, fused_raster=FRAMES, tri_setup=FRAMES, bin_pairs=FRAMES), (h, w, 4),
                      {"K1": "fused_raster", "tri_setup": "tri_setup", "bin_pairs": "bin_pairs"}, geometries=3,
                      max_nodes=PHONG_GRAPH_NODES)
    clipped_at_bench = {"phong1080 Scene.render()": clipped_per_draw(scene, ANGLES[0])}
    clipped_at_bench["phong1080 prepare()"] = clipped_at_bench["phong1080 Scene.render()"]
    for frame, depth, stats in outs:
        check(bool(torch.isfinite(depth).all()), "phong1080: non-finite depth")
        check(int(stats["num_clipped"]) <= scene.config.clip_cap, "phong1080: clip_cap dropped faces")
    check(torch.equal(outs[0][0], reference_frame), "phong1080: Scene.render() at 0.10 differs from the checked K1 frame")
    shaded = int((outs[0][0][..., :3] != 30).any(-1).sum())
    check(0.05 * w * h < shaded < 0.9 * w * h, f"phong1080: implausible shaded pixel count {shaded}")
    raster_stages("phong1080", scene)
    phong_frame0 = outs[0][0]
    clip_path_cost("phong1080", scene, smi)
    set_angle(scene, ANGLES[0])
    clip_flip("phong1080 Scene.render()", scene, scene.render, lambda: render_eager(scene))

    # a key the frame reads changes: the draw shapes, the stack's opaque flag
    set_angle(scene, ANGLES[0])
    draws = list(scene.draws)
    scene.draws = [draws[0], {k: v[:10] for k, v in draws[1].items()}, draws[2]]
    recapture("draw 1 cut to 10 faces", scene)
    scene.draws = draws
    stack = scene.ps_uniform["textures"]
    scene.ps_uniform = dict(scene.ps_uniform, textures=dataclasses.replace(stack, opaque=not stack.opaque))
    recapture(f"texture stack with opaque={not stack.opaque}", scene)
    scene.ps_uniform = dict(scene.ps_uniform, textures=stack)

    # phong1080 render_prepared: geometry and binning once, then frames that
    # change only shading uniforms: the eye the lighting reads moves (toward
    # the side where the reference's mirrored highlight shows), and every
    # other frame the three textures trade places (a stack of equal shape)
    from f_renderer_tpu_torch import make_checker_texture
    from f_renderer_tpu_torch.shaders import TextureStack

    set_angle(scene, ANGLES[0])
    before = compiled.CACHE.captures
    prepared = scene.prepare()  # the eager warm-up, then the capture
    prep_graph = compiled.CACHE.last
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    want_prep = plain_prep(tri, scene.config, **bin_settings(scene.config, True))
    for t in prep_graph.outputs:
        fill_sentinel(t)
    replayed = scene.prepare()
    prep_nodes, prep_conds, prep_own, prep_in_bodies = graph_summary(prep_graph)
    ok = (compiled.CACHE.captures == before + 1 and same(prepared, want_prep) and same(replayed, want_prep)
          and all(torch.equal(a, b) for a, b in zip(prep_graph.outputs, compiled.flatten(want_prep)[0])))
    check(ok and prep_nodes == dict(zero, tri_setup=1, bin_pairs=1) and prep_conds == 3,
          f"phong1080 prepare: graph prep equal to eager {ok}, kernel nodes {prep_nodes}, conditional nodes {prep_conds}")

    def prepare_eager():
        packed = build_packed(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        return fused.prep_packed(*packed[:4], scene.config)

    prep_replay_ms = cuda_ms(prep_graph.replay, 5)
    split_frames["phong1080 prepare()"] = (prep_graph, prep_replay_ms,
                                           lambda s=scene: (set_angle(s, ANGLES[0]), s.prepare()))
    log(f"[graph] phong1080 prepare: capture {prep_graph.capture_ms:.1f} ms, pool {prep_graph.graph.pool_bytes} B, "
        f"replay {prep_replay_ms:.3f} ms, eager prep {cuda_ms(prepare_eager, 5):.3f} ms; the prep (and "
        f"a replay into sentinel-filled outputs) bit-equal to the eager prep={ok}, kernel nodes {prep_nodes}; "
        f"{prep_own} nodes, {prep_conds} of them conditional, {prep_in_bodies} nodes in their bodies ({smi})")
    clip_flip("phong1080 prepare()", scene, scene.prepare, prepare_eager)
    base = scene.ps_uniform
    swapped = TextureStack.create([make_checker_texture(512, c) for c in (24, 16, 32)], device=dev)
    uniforms = [dict(base, view_pos=base["view_pos"] + torch.tensor([0.3 * i, 0.2 * i, -0.8 * i], device=dev),
                     textures=swapped if i % 2 else base["textures"]) for i in range(FRAMES)]

    scene.render_prepared(prepared)  # render_prepared is eager on the card: one K1 launch

    def prepared_frame(i):
        scene.ps_uniform = uniforms[i]
        return scene.render_prepared(prepared)

    outs, got = drive("phong1080 render_prepared", prepared_frame, FRAMES, dict(zero, fused_raster=FRAMES), (h, w, 4))
    launches["K1 render_prepared"] = got["fused_raster"]
    check(torch.equal(outs[0][0], phong_frame0), "phong1080: render_prepared at 0.10 differs from Scene.render()")
    check(not torch.equal(outs[1][0], phong_frame0), "phong1080: render_prepared ignored the swapped textures")
    scene.ps_uniform = uniforms[FRAMES - 1]
    check(torch.equal(outs[-1][0], scene.render()[0]), "phong1080: render_prepared's last frame differs from Scene.render()")
    scene.ps_uniform = base
    stages("phong1080 render_prepared", [("prepare (eager)", prepare_eager),
                                         ("render_prepared", lambda: scene.render_prepared(prepared))])
    del prepared, want_prep, replayed

    # stress4k Scene.render(): geometry of a million faces, binning and K1
    scene = stress

    def stress_frame_at(i, s=scene):
        set_angle(s, ANGLES[i])
        return s.render()

    def stress_eager(i, s=scene):
        set_angle(s, ANGLES[i])
        return render_eager(s)

    outs = graph_path("stress4k Scene.render()", stress_frame_at, stress_eager, len(ANGLES),
                      dict(zero, fused_raster=len(ANGLES), tri_setup=len(ANGLES), bin_pairs=len(ANGLES)), (sh, sw, 4),
                      {"K1 stress4k": "fused_raster", "tri_setup stress4k": "tri_setup", "bin_pairs stress4k": "bin_pairs"},
                      geometries=1)
    clipped_at_bench["stress4k Scene.render()"] = clipped_per_draw(scene, ANGLES[0])
    for i, (frame, depth, stats) in enumerate(outs):
        check(bool(torch.isfinite(depth).all()), "stress4k: non-finite depth")
        check(int(stats["num_clipped"]) <= scene.config.clip_cap, "stress4k: clip_cap dropped faces")
        log(f"  stress4k@{ANGLES[i]}: clipped {int(stats['num_clipped'])} of {scene.config.clip_cap}, covered px "
            f"{int((frame[..., :3] != 30).any(-1).sum())}")
    check(torch.equal(outs[0][0], stress_frame), "stress4k: Scene.render() at 0.10 differs from the checked K1 frame")
    raster_stages("stress4k", scene)
    clip_path_cost("stress4k", scene, smi)
    set_angle(scene, ANGLES[0])
    clip_flip("stress4k Scene.render()", scene, scene.render, lambda: render_eager(scene))
    del outs, stress, scene

    # cube1080_flat through the portable backend: rasterize_portable and
    # shade_deferred, no kernel; held to the kernel path's prepare + render_prepared
    scene = build_scene("cube1080_flat", dev)
    set_angle(scene, ANGLES[0])
    frame_k, depth_k, winner_k = scene.render_prepared(scene.prepare())
    scene.config = dataclasses.replace(scene.config, backend="portable")
    scene.render()
    w1, h1 = SIZES["cube1080_flat"]
    before = compiled.CACHE.captures
    outs, _ = drive("cube1080_flat Scene.render() backend=portable", lambda i: scene.render(), 1, zero, (h1, w1, 4))
    check(compiled.CACHE.captures == before, "cube1080_flat: the portable backend captured a graph")
    frame_p, depth_p, _ = outs[0]
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    winner_p, _ = plain(rasterize, tri, scene.config)
    check(torch.equal(winner_p, winner_k), f"cube1080_flat: the portable winner differs from K1's at "
          f"{int((winner_p != winner_k).sum())} px")
    derr = (depth_p - depth_k).abs()
    check(bool((derr <= DEPTH_RTOL * depth_k.abs()).all()), f"cube1080_flat: portable depth beyond rtol, {float(derr.max())}")
    f_err, at2 = frame_bar("cube1080_flat portable", frame_p, frame_k)
    log(f"  cube1080_flat portable vs kernels: winner equal, depth max abs err {float(derr.max()):.3g}, frame max "
        f"diff {f_err} u8 ({at2:.4%} at 2), covered px {int((winner_p >= 0).sum())}")

    scene = build_scene("phong1080_tex2048", dev)

    def tex_frame(i, s=scene):
        set_angle(s, 0.10 + 0.05 * i)
        return s.render()[0]

    def tex_eager(i, s=scene):
        set_angle(s, 0.10 + 0.05 * i)
        return render_eager(s)[0]

    outs = graph_path("phong1080_tex2048 Scene.render()", tex_frame, tex_eager, FRAMES,
                      dict(zero, raster_planes=FRAMES, sample_bilinear=FRAMES, tri_setup=FRAMES, bin_pairs=FRAMES),
                      (h, w, 4), {"K4": "raster_planes", "K3": "sample_bilinear", "tri_setup tex2048": "tri_setup",
                                  "bin_pairs tex2048": "bin_pairs"}, geometries=3)
    check(torch.equal(outs[0], tex2048_frame), "phong1080_tex2048: Scene.render() at 0.10 differs from the checked K4 + K3 frame")
    raster_stages("phong1080_tex2048", scene)
    set_angle(scene, ANGLES[0])
    clip_flip("phong1080_tex2048 Scene.render()", scene, scene.render, lambda: render_eager(scene))

    scene = build_scene("custom12_360", dev)

    def custom_frame(i, s=scene):
        set_angle(s, 0.3 + 0.05 * i)
        return s.render()[0]

    def custom_eager(i, s=scene):
        set_angle(s, 0.3 + 0.05 * i)
        return render_eager(s)[0]

    w, h = SIZES["custom12_360"]
    graph_path("custom12_360 Scene.render()", custom_frame, custom_eager, 3,
               dict(zero, raster_planes=3, tri_setup=3, bin_pairs=3), (h, w, 4),
               {"K4 custom12_360": "raster_planes", "tri_setup custom12_360": "tri_setup",
                "bin_pairs custom12_360": "bin_pairs"}, geometries=3)
    set_angle(scene, 0.3)
    clip_flip("custom12_360 Scene.render()", scene, scene.render, lambda: render_eager(scene))

    views = [voxel_view(i) for i in range(FRAMES)]
    color_t, hit_t = torch.as_tensor(grid_color, device=dev), torch.as_tensor(grid_hit, device=dev)
    for traversal, key, setup_key in (("fixed", "K5 fixed", "setup"), ("dda", "K5 dda", "setup dda")):
        cfg = raycast.VoxelRenderConfig(width=VOXEL_W, height=VOXEL_H, level=VOXEL_LEVEL,
                                        length=VOXEL_LENGTH, traversal=traversal)

        def voxel_frame(i, cfg=cfg):
            return raycast.render_voxel_frame(grid_color, grid_hit, *views[i], cfg, device=dev)

        def voxel_eager(i, cfg=cfg):
            eye, inv_mvp = (torch.from_numpy(a).to(dev) for a in views[i])
            return raycast.voxel_frame(color_t, hit_t, eye, inv_mvp, cfg)

        path = "voxel540" if traversal == "fixed" else "voxel540dda"
        outs = graph_path(f"{path} render_voxel_frame", voxel_frame, voxel_eager, FRAMES,
                          dict(zero, voxel_march=FRAMES, voxel_setup=FRAMES), (VOXEL_H, VOXEL_W, 4),
                          {key: "voxel_march", setup_key: "voxel_setup"}, max_nodes=VOXEL_GRAPH_NODES)
        hit = float((outs[0][..., :3] != 0).any(-1).float().mean())
        check(0.05 < hit < 0.9, f"{path}: implausible hit share {hit}")
        eye, inv_mvp = (torch.from_numpy(a).to(dev) for a in views[0])
        k = raycast.march_constants(cfg, grid_hit.shape[0])
        rays = raycast.prepare_rays(eye, inv_mvp, cfg)
        stages(path, [
            ("ray set-up", lambda: raycast.prepare_rays(eye, inv_mvp, cfg)),
            ("ray set-up plain", lambda: raycast.prepare_rays_plain(eye, inv_mvp, cfg)),
            ("table", lambda: raycast.voxel_table(torch.as_tensor(grid_color, device=dev),
                                                  torch.as_tensor(grid_hit, device=dev))),
            ("K5", lambda: raycast.march(*rays, table, k)),
        ])
    set_up_before = cuda_ms(lambda: raycast.prepare_rays(eye, inv_mvp, cfg), 5)

    def count_replays():
        """4b. each graph path's main-path run: the first EAGER_FRAMES of its
        frames again, as replays, with the counts set to 0 just before and
        read just after. A replay runs no wrapper, so the counts must stay
        0, and the launches are the kernels the device ran (CUPTI's records,
        one trace for all paths, a spin kernel between two paths). Last,
        because tracing may slow the host's later launches (the voxel ray
        set-up is timed again after it)."""
        log(f"[time] {time.time() - t_start:.1f} s")
        runs = []
        with DeviceTrace() as trace:
            for path, entry, frames, expect, shape, outs, keys in counted:
                n = min(EAGER_FRAMES, frames)
                torch.cuda._sleep(1)  # where the path's kernels start in the trace
                torch.cuda.synchronize()
                reset_counts()
                t_host = time.time()
                again = [entry(i) for i in range(n)]
                torch.cuda.synchronize()
                runs.append((n, again, counts(), (time.time() - t_host) * 1e3 / n))
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        check(bool(trace.kernels), "CUPTI recorded no kernel on the device")
        by_path = launches_between_markers(trace.kernels)
        log(f"[time] {time.time() - t_start:.1f} s ({len(trace.kernels)} kernels in the trace)")
        check(len(by_path) == len(counted), f"the trace holds {len(by_path)} paths' kernels, not {len(counted)}")
        for (path, entry, frames, expect, shape, outs, keys), (n, again, host, host_ms), got in zip(counted, runs, by_path):
            want = {k: v // frames * n for k, v in expect.items()}
            check(host == zero, f"{path}: a graph frame called a wrapper ({host}), so it was no replay")
            check(got == want, f"{path}: the device ran {got} in {n} replays, expected {want}")
            check(all(same(a, b) for a, b in zip(outs, again)), f"{path}: the counted replays differ from the timed ones")
            log(f"[main-path] {path} x{n}: launches {got} (the kernels the device ran in {n} replays, from "
                f"CUPTI's records; the wrappers' counts {host}), host {host_ms:.3f} ms/frame under the trace, "
                f"checksum {checksum(path, again, shape)} ({smi})")
            launches.update({key: got[wrapper] for key, wrapper in keys.items()})
        counted.clear()
        split_replays()

    def split_replays():
        """4b. one replay of each split path (phong1080 ``render()`` and
        ``prepare()``, stress4k ``render()``) at the bench camera, under a
        device trace of its kernels, memsets and memcpys with their
        durations: where the replay's time goes."""
        paths = [p for p in ("phong1080 Scene.render()", "phong1080 prepare()", "stress4k Scene.render()")
                 if p in split_frames]
        for p in paths:
            split_frames[p][2]()  # the bench camera's inputs in the graph's buffers
        torch.cuda.synchronize()
        with DeviceTrace() as trace:
            for p in paths:
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                split_frames[p][0].replay()
                torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        parts = records_between_markers(trace.records)
        port_names = port_kernel_names()
        check(len(parts) == len(paths), f"split: the trace holds {len(parts)} replays, not {len(paths)}")
        for p, part in zip(paths, parts):
            sp = split(part)
            ran = kernel_launches(name for *_, name in part)
            check(ran["tri_setup"] == 1 and ran["bin_pairs"] == 1,
                  f"{p}: the traced replay ran the set-up and binning kernels {ran['tri_setup']} and "
                  f"{ran['bin_pairs']} times, not once each")
            # phong's vertex stage runs in launch 1 (tri_setup_kernel<kPhong>): no PyTorch kernel of it is left
            phong = VERTEX_KINDS["phong"].code
            check(any(f"tri_setup_kernelILi{phong}E" in name for *_, name in part),
                  f"{p}: the traced replay's set-up kernel is not the phong vertex mode")
            others = foreign_kernels(part, port_names)
            log(f"[split] {p}: {sum(others.values())} kernels not of csrc/ in the replay (PyTorch's, CUDA's memset "
                f"kernels), {sorted(others.items())}")
            log(f"[split] {p}: one replay at the bench camera ({ANGLES[0]}), faces clipped per draw "
                f"{clipped_at_bench[p]}; {sp['records']} records; device time summed {sp['sum_us']:.1f} us, busy "
                f"(their union) {sp['busy_us']:.1f} us over a span of {sp['span_us']:.1f} us (idle gap "
                f"{sp['gap_us']:.1f} us); the replay {split_frames[p][1] * 1e3:.1f} us (CUDA events, untraced; "
                f"{smi})")
            for name, n, us in sp["top"]:
                log(f"[split]   {us:9.2f} us  x{n:<5d} {name}")
        split_frames.clear()

    # 5. row slabs and the sharded frame, on an NCCL group of one rank that
    # lives until 4b has replayed the captured sharded frame
    log(f"[time] {time.time() - t_start:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=0,
                                world_size=1)
        try:
            sharded_phase(dev, smi, rows, launches, drive, graph_path, clip_flip)
            compiled.CACHE.debug = False
            count_replays()
        finally:
            compiled.CACHE.clear()  # the graphs that hold the group's NCCL launches go before the group
            dist.destroy_process_group()
    log(f"[stages] voxel540dda ray set-up {set_up_before:.3f} ms before the device trace, "
        f"{cuda_ms(lambda: raycast.prepare_rays(eye, inv_mvp, cfg), 5):.3f} ms after it ({smi})")

    # 6. results
    for key, row in rows.items():
        row["launches"] = launches[key]
    rows["K4"]["launches_custom12_360"] = launches["K4 custom12_360"]
    rows["setup"]["launches_voxel540dda"] = launches["setup dda"]
    rows["K1"]["launches_stress4k"] = launches["K1 stress4k"]
    for key in ("tri_setup", "bin_pairs"):
        for path in ("stress4k", "tex2048", "custom12_360"):
            rows[key][f"launches_{path}"] = launches[f"{key} {path}"]
    rows["bin_pairs"]["launches_sharded_graph_world1"] = launches["bin_pairs sharded graph"]
    rows["K1"]["launches_render_prepared"] = launches["K1 render_prepared"]
    rows["K1"]["launches_sharded_graph_world1"] = launches["K1 sharded graph"]
    rows["K1"]["launches_grid_2x4_graph"] = launches["K1 grid 2x4 graph"]
    rows["K4"]["launches_grid_2x4_stream_graph"] = launches["K4 grid 2x4 stream graph"]
    rows["K3"]["launches_grid_2x4_stream_graph"] = launches["K3 grid 2x4 stream graph"]
    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            log("  " + f)
        return 1
    log(f"[time] chip_smoke: {time.time() - t_start:.1f} s, the build included ({smi})")
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
