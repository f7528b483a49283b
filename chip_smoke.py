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
   - K1 at stress4k (a million triangles at 3840x2160, the default config:
     64-row tiles, two fine tiles a triangle, bin_pairs' packed 31-bit
     sort) against its plain version and ``rasterize_portable`` on eight
     tiles (the heaviest, the one with the most coarse pairs, one no pair
     reaches, five drawn with a seeded generator); again with 32-row tiles,
     where the sort key needs 32 bits and the stable two-operand sort runs,
     which must give the same frame; K1's device time there, with every
     pair list empty, and its bound;
   - K4, the non-fused raster: phong1080_tex2048 at the same angles, both
     entry points, a custom shader with 12 varyings at 640x360, and
     sliver640. Winner ids, texture ids and varyings bit-equal, depth
     within rtol 2.4e-7; the frames shaded from the kernels' planes
     (K4 + K3) against the frames shaded from the plain planes with the
     plain sampler, under the colour bar above;
   - K3, the batched sampler, on the phong1080_tex2048 planes: within
     1e-6 of the plain version;
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
   phong1080 ``Scene.render()`` (K1 once a frame), phong1080
   ``render_prepared`` (``prepare()`` once, then K1 alone a frame while the
   eye moves and the textures trade places; the first and last frames equal
   to ``Scene.render()`` at the same uniforms), stress4k
   ``Scene.render()`` at 0.10 / 0.15 / 0.20 (K1 once a frame, no face past
   the clip cap, frame 0 equal to the checked K1 frame), cube1080_flat
   through the portable backend (no kernel; winner equal to the kernel
   path's), phong1080_tex2048 ``Scene.render()`` (K4 and K3 once a frame,
   K1 never), the custom 12-varying shader's ``Scene.render()`` (K4 once a
   frame) and ``render_voxel_frame`` for voxel540 and voxel540dda (K5 once
   a frame), with frame times (CUDA events), checksums and per-stage times;
5. one JSON line describing the kernels, the card's identity line, and the
   last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero; without CUDA, or without the port beside it,
the script exits non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
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
         "textured_wide": (800, 600), "gouraud800": (800, 600), "cube1080_flat": (1920, 1080),
         "sliver640": (640, 360), "stress4k": (3840, 2160)}
SIZES["phong1080_tex2048"] = SIZES["phong1080"]
TEX_SIDE = 2048

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
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_ms = 2.0 * host_ms * reps + 1.0
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

    return {k: getattr(kernels, k).launches for k in ("fused_raster", "raster_planes", "sample_bilinear", "voxel_march")}


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
    reaches the tile (the order pass's test, for a tile with no fine pair)."""
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


def check_tiles(prep, n_random, seed=0, with_coarse_and_empty=True):
    """The bin tiles to hold a kernel to its plain version on → ([(ty, tx)],
    what each is): the heaviest tile (most fine and coarse pairs); with
    ``with_coarse_and_empty`` the tile with the most coarse pairs and a tile
    whose list the order pass empties (no fine pair, at most 32 coarse and
    spill pairs, none whose bbox reaches it), or else the first tile with
    no fine pair that no pair reaches; and ``n_random`` tiles with pairs,
    drawn with a seeded numpy generator."""
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
        emptied = [t for t in empty if sum(ranges[t]) <= 32]
        if emptied:
            pick(emptied[0], "emptied by the order pass")
        elif empty:
            pick(empty[0], f"reached by no pair (none emptied: the spill range holds {ranges[0][2]} > 32 pairs)")
        else:
            what.append("no tile without fine pairs that no pair reaches")
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


def sort_bits(tri, prep):
    """Bits of bin_pairs' packed (key, slot) sort key: the keys' and the
    slots' (over 31, the two-operand stable sort runs)."""
    from f_renderer_tpu_torch.pipeline.raster import LANES, cdiv

    m_pad = cdiv(tri.num_slots + 1, LANES) * LANES
    return prep.off.numel().bit_length(), max((m_pad - 1).bit_length(), 1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from f_renderer_tpu_torch import kernels
        from f_renderer_tpu_torch.pipeline import fused, raster, shade
        from f_renderer_tpu_torch.pipeline.render import build_triangles, context_codec, rasterize
        from f_renderer_tpu_torch.shaders.builtin import shade_plain
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
        prep = fused.prep_fused(tri, scene.config)
        args = (prep, scene.pixel_shader, scene.ps_uniform, scene.config)
        got = fused.render_fused_prepared(*args)
        want = plain(fused.render_fused_plain, *args)
        f_err, d_err = compare_fused(f"{scene_name}@{angle} th={prep.th} pairs={prep.tri_i32.shape[1]} "
                                     f"ranges {range_sizes(prep)}", got, want)
        worst_frame, worst_depth = max(worst_frame, f_err), max(worst_depth, d_err)
        if scene_name == "phong1080" and "K1" not in rows:
            reference_frame = got[0].clone()
            tiles, what = check_tiles(prep, 3, with_coarse_and_empty=False)
            log(f"  phong1080@{angle} tiles held to rasterize_portable: {'; '.join(what)}")
            compare_portable(f"phong1080@{angle}", tri, prep, tiles, got, *SIZES["phong1080"])
            launch = kernel_call("fused_raster", lambda: fused.render_fused_prepared(*args))
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
                "bytes": nbytes, "ops": ops, "ops_every_pixel": ops_every,
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
    log("[kernel-vs-plain] K1 fused_raster at stress4k")
    stress = build_scene("stress4k", dev)
    set_angle(stress, ANGLES[0])
    sw, sh = SIZES["stress4k"]
    tri, stats = build_triangles(stress.draws, stress.vertex_shader, stress.vs_uniform, stress.config)
    check(int(stats["num_clipped"]) <= stress.config.clip_cap, "stress4k: clip_cap dropped faces")
    prep = fused.prep_fused(tri, stress.config)
    key_bits, slot_bits = sort_bits(tri, prep)
    check(prep.th == 64 and key_bits + slot_bits <= 31,
          f"stress4k: th {prep.th}, sort key {key_bits} + {slot_bits} bits: not the packed sort at th = 64")
    args = (prep, stress.pixel_shader, stress.ps_uniform, stress.config)
    stress_got = fused.render_fused_prepared(*args)
    ranges = tile_ranges(prep)
    heavy = sum(f + c >= 256 for f, c, _ in ranges)
    heaviest = max(f + c for f, c, _ in ranges)
    tiles, what = check_tiles(prep, 5)
    log(f"  stress4k@{ANGLES[0]}: th={prep.th} slots {tri.num_slots} clipped {int(stats['num_clipped'])} "
        f"pair columns {prep.tri_i32.shape[1]} ranges {range_sizes(prep)} (fine/coarse/spill), tiles "
        f"{len(ranges)}, heavy tiles (>= 256 fine + coarse pairs, rows interleaved) {heavy}, heaviest tile "
        f"{heaviest} pairs; sort key {key_bits} + {slot_bits} = {key_bits + slot_bits} bits (packed)")
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
    launch = kernel_call("fused_raster", lambda: fused.render_fused_prepared(*args))
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
        stress4k_heavy_tiles=heavy, stress4k_tiles=len(ranges), stress4k_heaviest_tile_pairs=heaviest,
        stress4k_sort_bits=key_bits + slot_bits,
    )
    del launch

    # the second sort path: 32-row tiles (tile_auto off, or the slot count
    # would raise them to 64) need a 12-bit key, 32 bits with the slot: the
    # stable two-operand sort. The same pixels, so the same frame.
    cfg32 = dataclasses.replace(stress.config, tile=(32, 128), tile_auto=False)
    prep32 = fused.prep_fused(tri, cfg32)
    key_bits, slot_bits = sort_bits(tri, prep32)
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
            prep = raster.prep_binned(tri, scene.config.width, scene.config.height, scene.config.tile,
                                      bin_k=scene.config.bin_k)
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
                "bytes": nbytes, "ops": ops, "ops_every_pixel": ops_every,
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

    # 3d. K5 against plain, on every main-path view
    log("[kernel-vs-plain] K5 voxel_march")
    grid_color, grid_hit = octree.densify(octree.gen_randomly(VOXEL_LEVEL, np.random.default_rng(0)), VOXEL_LEVEL)
    table = raycast.voxel_table(torch.as_tensor(grid_color, device=dev), torch.as_tensor(grid_hit, device=dev))
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

    # 3e. K5 at level 6, where the hit bitmap (256 KiB) leaves shared memory for L2
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

    # 3f. K5 dda at length 3.0: cell 3/16 is no power of two, so the kernel divides
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

    # 4. the main paths, each with the counters set to 0 just before it
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
        checksum = 0
        for out in outs:
            frame = out[0] if isinstance(out, tuple) else out
            check(tuple(frame.shape) == shape and frame.dtype == torch.uint8, f"{path}: frame shape {tuple(frame.shape)}")
            checksum += int(frame[::97, ::89, :3].int().sum())
        log(f"[main-path] {path} x{frames}: launches {got}, frame {frame_ms:.3f} ms (CUDA events), "
            f"host {host_ms:.3f} ms/frame, checksum {checksum} ({smi})")
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
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        cfg = scene.config
        parts = [("geometry", lambda: build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, cfg))]
        if fused.fused_path_ok(scene.pixel_shader, scene.ps_uniform):
            prep = fused.prep_fused(tri, cfg)
            parts += [("prep", lambda: fused.prep_fused(tri, cfg)),
                      ("K1", lambda: fused.render_fused_prepared(prep, scene.pixel_shader, scene.ps_uniform, cfg))]
        else:
            prep = raster.prep_binned(tri, cfg.width, cfg.height, cfg.tile)
            codec = context_codec(scene.vertex_shader, scene.vs_uniform, scene.draws[0])
            depth, winner, ps, ctx = (t[..., :cfg.height, :cfg.width] for t in raster.raster_planes(prep, True))
            parts += [("prep", lambda: raster.prep_binned(tri, cfg.width, cfg.height, cfg.tile)),
                      ("K4", lambda: raster.raster_planes(prep, True)),
                      ("shade (with K3)", lambda: shade.shade_from_planes(
                          ctx, ps, winner, scene.pixel_shader, scene.ps_uniform, codec, background=cfg.background))]
        stages(path, parts)

    zero = dict.fromkeys(counts(), 0)
    launches = {}

    scene = build_scene("phong1080", dev)
    set_angle(scene, ANGLES[0])
    scene.render()  # warm-up (allocator, first-use costs)

    def phong_frame(i):
        set_angle(scene, 0.10 + 0.05 * i)
        return scene.render()

    w, h = SIZES["phong1080"]
    outs, got = drive("phong1080 Scene.render()", phong_frame, FRAMES, dict(zero, fused_raster=FRAMES), (h, w, 4))
    launches["K1"] = got["fused_raster"]
    for frame, depth, stats in outs:
        check(bool(torch.isfinite(depth).all()), "phong1080: non-finite depth")
        check(int(stats["num_clipped"]) <= scene.config.clip_cap, "phong1080: clip_cap dropped faces")
    check(torch.equal(outs[0][0], reference_frame), "phong1080: Scene.render() at 0.10 differs from the checked K1 frame")
    shaded = int((outs[0][0][..., :3] != 30).any(-1).sum())
    check(0.05 * w * h < shaded < 0.9 * w * h, f"phong1080: implausible shaded pixel count {shaded}")
    raster_stages("phong1080", scene)
    phong_frame0 = outs[0][0]

    # phong1080 render_prepared: geometry and binning once, then frames that
    # change only shading uniforms: the eye the lighting reads moves (toward
    # the side where the reference's mirrored highlight shows), and every
    # other frame the three textures trade places (a stack of equal shape)
    from f_renderer_tpu_torch import make_checker_texture
    from f_renderer_tpu_torch.shaders import TextureStack

    set_angle(scene, ANGLES[0])
    prepared = scene.prepare()
    base = scene.ps_uniform
    swapped = TextureStack.create([make_checker_texture(512, c) for c in (24, 16, 32)], device=dev)
    uniforms = [dict(base, view_pos=base["view_pos"] + torch.tensor([0.3 * i, 0.2 * i, -0.8 * i], device=dev),
                     textures=swapped if i % 2 else base["textures"]) for i in range(FRAMES)]
    scene.render_prepared(prepared)

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
    stages("phong1080 render_prepared", [("prepare", scene.prepare),
                                         ("render_prepared", lambda: scene.render_prepared(prepared))])
    del prepared

    # stress4k Scene.render(): geometry of a million faces, binning and K1
    scene = stress
    set_angle(scene, ANGLES[0])
    scene.render()

    def stress_frame_at(i):
        set_angle(scene, ANGLES[i])
        return scene.render()

    outs, got = drive("stress4k Scene.render()", stress_frame_at, len(ANGLES),
                      dict(zero, fused_raster=len(ANGLES)), (sh, sw, 4))
    launches["K1 stress4k"] = got["fused_raster"]
    for i, (frame, depth, stats) in enumerate(outs):
        check(bool(torch.isfinite(depth).all()), "stress4k: non-finite depth")
        check(int(stats["num_clipped"]) <= scene.config.clip_cap, "stress4k: clip_cap dropped faces")
        log(f"  stress4k@{ANGLES[i]}: clipped {int(stats['num_clipped'])} of {scene.config.clip_cap}, covered px "
            f"{int((frame[..., :3] != 30).any(-1).sum())}")
    check(torch.equal(outs[0][0], stress_frame), "stress4k: Scene.render() at 0.10 differs from the checked K1 frame")
    raster_stages("stress4k", scene)
    del outs, stress, scene

    # cube1080_flat through the portable backend: rasterize_portable and
    # shade_deferred, no kernel; held to the kernel path's prepare + render_prepared
    scene = build_scene("cube1080_flat", dev)
    set_angle(scene, ANGLES[0])
    frame_k, depth_k, winner_k = scene.render_prepared(scene.prepare())
    scene.config = dataclasses.replace(scene.config, backend="portable")
    scene.render()
    w1, h1 = SIZES["cube1080_flat"]
    outs, _ = drive("cube1080_flat Scene.render() backend=portable", lambda i: scene.render(), 1, zero, (h1, w1, 4))
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
    set_angle(scene, ANGLES[0])
    scene.render()

    def tex_frame(i):
        set_angle(scene, 0.10 + 0.05 * i)
        return scene.render()[0]

    outs, got = drive("phong1080_tex2048 Scene.render()", tex_frame, FRAMES,
                      dict(zero, raster_planes=FRAMES, sample_bilinear=FRAMES), (h, w, 4))
    launches["K4"], launches["K3"] = got["raster_planes"], got["sample_bilinear"]
    check(torch.equal(outs[0], tex2048_frame), "phong1080_tex2048: Scene.render() at 0.10 differs from the checked K4 + K3 frame")
    raster_stages("phong1080_tex2048", scene)

    scene = build_scene("custom12_360", dev)
    scene.render()

    def custom_frame(i):
        set_angle(scene, 0.3 + 0.05 * i)
        return scene.render()[0]

    w, h = SIZES["custom12_360"]
    _, got = drive("custom12_360 Scene.render()", custom_frame, 3, dict(zero, raster_planes=3), (h, w, 4))
    launches["K4 custom12_360"] = got["raster_planes"]

    views = [voxel_view(i) for i in range(FRAMES)]
    for traversal, key in (("fixed", "K5 fixed"), ("dda", "K5 dda")):
        cfg = raycast.VoxelRenderConfig(width=VOXEL_W, height=VOXEL_H, level=VOXEL_LEVEL,
                                        length=VOXEL_LENGTH, traversal=traversal)
        raycast.render_voxel_frame(grid_color, grid_hit, *views[0], cfg, device=dev)

        def voxel_frame(i):
            return raycast.render_voxel_frame(grid_color, grid_hit, *views[i], cfg, device=dev)

        path = "voxel540" if traversal == "fixed" else "voxel540dda"
        outs, got = drive(f"{path} render_voxel_frame", voxel_frame, FRAMES, dict(zero, voxel_march=FRAMES),
                          (VOXEL_H, VOXEL_W, 4))
        launches[key] = got["voxel_march"]
        hit = float((outs[0][..., :3] != 0).any(-1).float().mean())
        check(0.05 < hit < 0.9, f"{path}: implausible hit share {hit}")
        eye, inv_mvp = (torch.from_numpy(a).to(dev) for a in views[0])
        k = raycast.march_constants(cfg, grid_hit.shape[0])
        rays = raycast.prepare_rays(eye, inv_mvp, cfg)
        stages(path, [
            ("ray set-up", lambda: raycast.prepare_rays(eye, inv_mvp, cfg)),
            ("table", lambda: raycast.voxel_table(torch.as_tensor(grid_color, device=dev),
                                                  torch.as_tensor(grid_hit, device=dev))),
            ("K5", lambda: raycast.march(*rays, table, k)),
        ])

    # 5. results
    for key, row in rows.items():
        row["launches"] = launches[key]
    rows["K4"]["launches_custom12_360"] = launches["K4 custom12_360"]
    rows["K1"]["launches_stress4k"] = launches["K1 stress4k"]
    rows["K1"]["launches_render_prepared"] = launches["K1 render_prepared"]
    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            log("  " + f)
        return 1
    log(f"[time] chip_smoke: {time.time() - t_start:.1f} s, the build included ({smi})")
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
