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
     (K4 + the shading kernel) against the frames shaded from the plain
     planes with the plain sampler, under the colour bar above;
   - K3, the batched sampler, on the phong1080_tex2048 planes and on
     custom_tex1080's (its main path: phong1080's planes sampled by a
     user's pixel shader): within 1e-6 of the plain version;
   - the builtin shading of K4's planes (csrc/shade_planes.cu, XLA's
     fusion of the JAX package's non-fused shading): against
     ``shade_planes_plain`` byte for byte on phong1080_tex2048's K4 planes
     at the bench angles, the K4 planes of gouraud800, textured_wide and
     cube1080_flat (all four kinds), and crafted planes (NaN and ±inf uv
     and normals, a zero normal, texture ids -1 and past the stack, every
     pixel background, more varyings ahead of phong's, the textured shader
     on phong's planes), and phong and textured on an opaque non-square
     stack past the routing limit (alpha from the taps); its ``ptxas`` line
     with no stack frame or spills,
     its occupancy, its time and bound at phong1080_tex2048, beside the same
     shader run untagged (PyTorch's ops and K3);
   - the RGBA8 pack of a user shader's colour (csrc/pack_rgba8.cu, XLA's
     fusion of the pack after the shader): against ``shade._pack`` byte for
     byte on the 1920x1080 colour of custom_tex1080's shader
     (``benchmark/shaders/phong_rs.py``) at the bench angles, with crafted
     rows (NaN, +-inf, +-0.0, each side of every k/255, values past [0, 1]),
     as a strided view and with every pixel background; its ``ptxas`` line
     with no stack frame or spills, its occupancy, its time beside its
     bound (every pixel's colour, and the least bytes) and ``_pack``'s time;
   - the compaction of K4's planes for a user's shader
     (csrc/compact_planes.cu): against ``shade.compact_planes_plain`` bit
     for bit on phong1080's planes at the bench angles and cut or grown to
     every rung and the whole frame's; the pack's slot form against
     ``_pack``'s, and the compact path's frame against the shader on the
     whole frame, byte for byte; its ``ptxas`` line with no stack frame or
     spills, its occupancy, its time beside its bound, the shader's time
     on the rung and on the whole frame;
   - the voxel ray set-up kernel (csrc/voxel_setup.cu, XLA's fusion of the
     JAX package's set-up): voxel540's 10 orbit views, the tests' crafted
     view (a zero direction, rays on a grid plane and along ±x), eyes
     inside the cube, on a face, on an edge and on its corner, and a view
     at length 3.0: the eight planes bit for bit (NaN equal to NaN, zeros
     with their signs), then the frames K5 marches from each; its
     ``ptxas`` line must show no stack frame and no spills; its occupancy,
     and per view the rays and warps its eight-slot path takes
     (``raycast.eight_slot_rays``);
   - the triangle set-up kernels (csrc/tri_setup.cu, XLA's fusions of the
     chain from the vertex shader's outputs to the packed rows, written as
     slot records and a bbox array) and the binning kernels
     (csrc/bin_pairs.cu, the binning and pair gather from them):
     ``build_packed``'s records and bboxes against ``build_packed_plain``'s
     bit for bit (a float word's NaN equal to any NaN), and ``bin_packed``
     against ``bin_packed_plain`` (offsets and pair columns bit for bit
     where the plain version takes the packed 31-bit sort; where it takes
     the two-operand sort, equal offsets and the same lists, the kernels' in
     slot order), on phong1080 at the bench camera and three more angles,
     with 1, cap and cap + 7 faces clipped, its eight row slabs (also from
     packed rows with the last column the dummy, as the sharded frame bins,
     and from rows with K4's settings, as ``raster.prep_binned``), stress4k
     (and at 32-row tiles), phong1080_tex2048, custom12_360, sliver640,
     gouraud800, textured_wide, phong_bin_k1 and cube1080; their ``ptxas``
     lines must show no stack frame and no spills, and their registers,
     shared memory and occupancy at stress4k's launch shapes are printed;
     their device times at phong1080 and stress4k beside their bounds (the
     binning also reading the records' own bbox words), and the set-up and
     binning summed against their summed bound. The
     raster kernels above run on the plain chain's preps, so every frame
     of 4 is held to the frame the plain set-up and binning give;
   - the sharded frame's kernels: the set-up kernels' shard mode on each
     dp shard of phong1080's 2 x 4 grid, with 0, 1 and cap + 7 faces of
     draw 0 clipped, against the plain chain (PyTorch's geometry, the
     quirk's partials, ``pack_shard``, ``raster.slot_records``) byte for
     byte; ``interp_records_kernel`` (csrc/interp_records.cu, XLA's fusion
     of the JAX package's ``interpolate_context``) against
     ``shade.interpolate_records`` bit for bit on the K4 winners of slab 3
     of 8 of phong1080, custom12_360 and phong1080_tex2048's 2 x 4 grid
     (gathered records), and against K4's own interpolation where a pixel
     is covered; its ``ptxas`` line with no stack frame or spills, its
     device time, plain time and bound at the grid's shapes;
   - the stream mode's per-round merge (csrc/stream_merge.cu, XLA's fusion
     of the JAX package's merge of a round): ``stream_merge_kernel``
     against ``sharding.stream_merge_plain`` byte for byte on all five
     accumulator planes, on each of the 16 rounds of phong1080's 2 x 4
     stream grid (round 0 of a slab writes the accumulator whole, and also
     equals the merge into ``stream_start``'s fills) and on crafted rounds
     (equal depths with a higher, an equal and a lower order, -0.0 against
     0.0, no winner on either side, owners 0, 1 and 3), merging and writing
     whole; its ``ptxas`` line with no stack frame or spills, its device
     time a round (a fresh accumulator a launch) against the bound from
     this run's data, and its plain time;
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
   path's), phong1080_tex2048 ``Scene.render()`` (K4 and the shading
   kernel once a frame, K1 and K3 never, the checksum of the PyTorch
   shading, a graph of fewer than half its 137 nodes), custom_tex1080
   ``Scene.render()`` (a user's pixel shader that samples: K4 and K3 once a
   frame; its frames equal the builtin textured shader's, which reads uv at
   channel 6 of phong's varyings), the custom 12-varying shader's
   ``Scene.render()`` (K4 once a
   frame) and ``render_voxel_frame`` for voxel540 and voxel540dda (the
   set-up kernel and K5 once a frame, each graph of 10 nodes: 11 less the
   alive plane's cast, now that K5 reads its bytes), and the same frames
   through ``voxel.VoxelRenderer`` (the grids bound once, as the JAX
   package's callers jit a closure over them: the table made outside the
   graph, whose inputs are eye and inv_mvp alone; its frames byte-equal to
   ``render_voxel_frame``'s on every view; its graph's three nodes named:
   the set-up kernel, K5's hit-bit pass and K5; in 4b one replay runs those
   three kernels and no other device operation; its replay, graph frame and
   input copy beside ``render_voxel_frame``'s), with
   frame times (CUDA events), checksums and per-stage times
   (eager). On the card each of these entry points but the portable one
   and ``render_prepared`` (eager: one K1 launch) replays one captured CUDA
   graph a frame (``compiled.py``). A graph path's frames are replays, so
   its launches are the kernels the device ran in them, read from CUPTI's
   kernel records in phase 4b, after every timing (no wrapper may count
   one). ``[split]`` lines, in 4b too: one replay each of phong1080
   ``render()`` and ``prepare()``, stress4k ``render()``, phong1080_tex2048
   ``render()``, the captured
   sharded frame, voxel540 and voxel540dda under a trace of its kernels,
   memsets and memcpys with their durations (the names with the most
   device time, their sum and
   union against the replay's time, the faces clipped at the bench camera;
   the set-up of
   phong1080's ``render()`` and ``prepare()`` is launch 1 and at most a
   fill, no conditional node's or clip path's kernel; the sharded frame's
   is the shard's launch 1 and its tri_quirk_kernel), then one phong1080
   ``render()`` replay with a face clipped (the conditional node's body
   runs; the frame equals the eager frame and the plain chain's). ``[graph]``
   lines: the first call captures; the graph's kernel nodes (from its
   DOT) equal one eager frame's launches; the graph frames, timed in a
   second run, and the first three of them run eagerly (``render_frame``,
   ``voxel.voxel_frame``) are bit-equal, the prep of ``prepare()`` to
   ``prep_fused`` too; a replay overwrites its sentinel-filled static
   outputs; a changed draw shape and a stack of another ``opaque`` capture
   anew and stay equal; capture ms, pool bytes, graph and eager frame ms,
   the input copy, replay and output clone alone; the graph's conditional
   nodes from its DOT, one a frame (``lax.cond``'s clip path in its body,
   the condition set by the set-up's launch 1), one a face shard in the
   sharded frame and the grids (the set-up kernels' shard mode); what
   path B costs a replay where nothing clips (phong1080,
   stress4k): the conditional node with its predicate false, the skip
   path alone, and the clip path with a select on every frame (the
   graph's form before the node); and every geometry graph path
   (phong1080 ``render()`` and ``prepare()``, stress4k, phong1080_tex2048,
   custom12_360, and the captured sharded frame and grids below) replayed
   across frames that flip between clipped and unclipped faces (1, 0, cap,
   0, cap + 7 and 1 faces of draw 0 moved through the near plane), each
   replay bit-equal to the same frame run eagerly;
   4c, ``[demo]`` lines: the three demos (``f_renderer_tpu_torch/demos``)
   at their default sizes, each 24 frames into a NullDisplay (the
   interactive demo from a 24-key script) with each frame's checksum equal
   to the entry point's frame at the same camera, then once from its
   command line into a PNG directory under a temporary path, the PNGs
   byte-equal to those frames; the demo's avg frame ms and fps, its loop's
   ms a frame after the first against render-only ms (the Present layer);
5. ``[sharded]``, row slabs and the sharded frame: K1 and K4 with an
   origin against their plain versions with that origin, bit for bit (slab
   3 of 8 of phong1080, and sliver640 cut on and off its corners), with
   their device times beside those at origin (0, 0); the eight row slabs
   of phong1080 (K1), phong1080_tex2048 (K4 + the shading kernel) and
   stress4k (K1) stitched and held to the whole frame bit for bit, timed
   against it; phong1080 through ``render_frame_grid`` on a 2 x 4 grid in
   one process (a launch 1 and a tri_quirk_kernel a shard; 8 K1 launches
   all-gathered; 16 K4, 16 ``stream_merge_kernel`` and 8 of the shading
   kernel streamed, no K3),
   phong1080_tex2048 on the same grid (the gather path: 8 K4 without
   varyings, 8 interp_records, 8 of the shading kernel) and phong1080
   through ``render_frame_sharded`` with NCCL at world size 1 (one launch
   1, one tri_quirk_kernel and one K1 a frame), each equal to the
   single-device frame, no PyTorch geometry on any;
   then the same captured: ``compiled.sharded_frame`` at world size 1 (its
   collectives recorded into the graph) and ``compiled.grid_frame`` at 2 x
   4 (all-gathered, the gather path and streamed), each a graph path as in
   4 and equal to the single-device frame; in 4b ``stream_merge_kernel``
   runs 16 times a stream grid frame and on no other path, and the stream
   grid's traced replay runs none of the PyTorch merge's kernels. The NCCL
   group lives until 4b has replayed the sharded graph;
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

from benchmark.cupti import OTHER_KINDS, Trace

FRAMES = 10
ANGLES = (0.10, 0.15, 0.20)  # bench.py's first three frame angles
DEPTH_RTOL = 2.4e-7
SAMPLE_ATOL = 1e-6
# Published H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores. Integer and float work are
# both counted at the float32 rate, so a bound is never too high.
HBM_BYTES_PER_S = 3.35e12
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
OPS_PER_S = 67e12
VOXEL_LEVEL, VOXEL_LENGTH, VOXEL_W, VOXEL_H = 3, 2.0, 960, 540
# Frame sizes of the scenes, and the side of phong1080_tex2048's textures.
SIZES = {"phong1080": (1920, 1080), "custom12_360": (640, 360), "phong_bin_k1": (640, 360),
         "textured_wide": (800, 600), "gouraud800": (800, 600), "gouraud800_color": (800, 600),
         "cube1080_flat": (1920, 1080),
         "sliver640": (640, 360), "stress4k": (3840, 2160)}
SIZES["phong1080_tex2048"] = SIZES["custom_tex1080"] = SIZES["phong1080"]
TEX_SIDE = 2048
EAGER_FRAMES = 3  # the eager frames run beside a graph path's, its first ones
# Each wrapper's kernel function (csrc/), as the device's trace names it.
KERNEL_FUNCTIONS = {"fused_raster": "fused_raster_kernel", "raster_planes": "raster_planes_kernel",
                    "sample_bilinear": "sample_bilinear_kernel", "shade_planes": "shade_planes_kernel",
                    "pack_rgba8": "pack_rgba8_kernel", "compact_planes": "compact_planes_kernel",
                    "voxel_march": "voxel_march_kernel",
                    "voxel_setup": "voxel_setup_kernel", "tri_setup": "tri_setup_kernel",
                    "bin_pairs": "bin_pairs_kernel",
                    "interp_records": "interp_records_kernel", "stream_merge": "stream_merge_kernel"}
VOXEL_GRAPH_NODES = 100  # a voxel frame's graph holds fewer nodes than this
# A voxel frame's graph nodes: 11 before K5 read the set-up's alive bytes,
# one fewer without the cast to int32 between the set-up and the march.
VOXEL_FRAME_NODES = 11 - 1
# A bound voxel frame's graph (voxel.VoxelRenderer, the table built once
# outside it): render_voxel_frame's 10 nodes less the table's 7 PyTorch
# nodes, which leaves the set-up kernel, K5's hit-bit pass (the K5 wrapper's
# first launch, from the table) and K5.
VOXEL_BOUND_NODES = ("voxel_setup_kernel", "hit_bits_kernel", "voxel_march_kernel")
DEMO_FRAMES = 24  # frames of each demo's run into a NullDisplay
DEMO_KEYS = "adwshljkqe" * 2 + "adws"  # the interactive demo's script: orbit, pan, zoom; a frame a key
VOXEL_SETUP_THREADS = 32 * 4  # voxel_setup_kernel's block (csrc/voxel_setup.cu: kCols x kRows)
PHONG_GRAPH_NODES = 126  # phong1080's render() graph: half the 252 nodes it held with the PyTorch vertex shader
# phong1080_tex2048's render() graph: fewer than half the 137 nodes it held
# with the builtin shading in PyTorch and K3; its frames 0-2 gave checksum
# 95260 there, which the shading kernel must give too
TEX2048_GRAPH_NODES = 137 // 2 + 1
TEX2048_CHECKSUM = 95260
SHADE_THREADS = 128  # shade_planes_kernel's block (csrc/shade_planes.cu: kThreads)
COMPACT_THREADS = 256  # compact_planes_kernel's block (csrc/compact_planes.cu: kThreads)

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


def sample_uv_shader(u, ctx, ps_index):
    """A user's pixel shader (no ``fused_kind``): the texture at uv, through
    ``TextureStack.sample`` (K3 on the card)."""
    return u["textures"].sample(ps_index, ctx["uv"][0], ctx["uv"][1])


def build_scene(name, device):
    """The scenes the port runs, built with the port's own builders: the
    bench scenes of ``bench_scenes`` (``bench.py:60-154``) and variants."""
    from f_renderer_tpu_torch import Camera, make_checker_texture, make_phong_scene, make_uv_sphere
    from f_renderer_tpu_torch import bench_scenes

    if name in ("phong1080", "gouraud800", "stress4k"):
        return bench_scenes.build_scene(name, device)
    if name == "custom_tex1080":  # phong1080's scene and vertex stage, a user's pixel shader that samples (K3)
        scene = bench_scenes.build_scene("phong1080", device)
        scene.pixel_shader = sample_uv_shader
        return scene
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


def cold_device_ms(fn, reps, flush_bytes=L2_FLUSH_BYTES):
    """Device time per call of ``fn`` (one kernel launch) with the L2 cold:
    before each call a read of ``flush_bytes`` of another buffer evicts
    what the last call left in the L2 (clean lines, so the call writes
    none back), and CUDA events bracket the call alone. The calls queue
    behind a spin kernel, as in :func:`device_ms`."""
    import torch

    flush = torch.ones(flush_bytes // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    flush.max()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    spin_ms = 3.0 * host_ms * reps + 1.0
    torch.cuda._sleep(int(sleep_cycles_per_ms() * spin_ms))
    t0 = time.perf_counter()
    for start, end in events:
        flush.max()
        start.record()
        fn()
        end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    check(enqueue_ms < spin_ms, f"cold_device_ms: enqueueing took {enqueue_ms:.2f} ms, the spin {spin_ms:.2f} ms")
    return sum(start.elapsed_time(end) for start, end in events) / reps


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


class DeviceTrace(Trace):
    """The work the device runs while the block is open, as CUPTI's activity
    API records it (``benchmark.cupti.Trace``: one record a kernel, memset
    or memcpy executed, graph replays included): ``with DeviceTrace() as
    trace: ...``, then ``trace.records``, (start ns, end ns, name) of every
    record in time order, a memset named ``[memset]`` and a memcpy
    ``[memcpy]``, and ``trace.kernels``.

    ``trace.records`` holds every record CUPTI delivered with its device
    stamps, unclipped: the activity kinds are on only while the block runs,
    after a synchronise, so each is work the block ran. The base class's
    clip to the window's host stamps drops a record whose device stamp lies
    a few microseconds outside them (a spin marker launched after the open,
    stamped 9 us before it), and so a stretch between two markers; CUPTI's
    incomplete records (stamps 0) are left out."""

    def __exit__(self, *exc):
        delivered = self.records  # the list CUPTI's callback appends to
        super().__exit__(*exc)
        self.records = sorted(r for r in delivered if r[0] and r[1])
        return False

    @property
    def kernels(self):
        """(start ns, name) pairs of the kernels."""
        return [(start, name) for start, _, name in self.records if name not in OTHER_KINDS.values()]


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


BIN_CHAIN = ("bin_count_kernel", "bin_scan_kernel", "bin_pairs_kernel", "bin_gather_kernel")
# The triangle set-up's kernels (csrc/tri_setup.cu) and the conditional node's own (csrc/graph_cond.cu)
SETUP_OPS = ("tri_setup_kernel", "tri_slots_kernel", "tri_quirk_kernel", "set_condition_kernel")


def programmatic_leads(records):
    """How long (us) each of the binning's kernels after the first started
    before the kernel ahead of it in ``BIN_CHAIN`` ended, in one replay's
    records (start, end, name): positive where it was launched by a
    programmatic edge, which lets it start while the one ahead runs."""
    found = {k: next(((s, e) for s, e, name in records if k in name), None) for k in BIN_CHAIN}
    return [round((found[a][1] - found[b][0]) / 1e3, 2) for a, b in zip(BIN_CHAIN, BIN_CHAIN[1:])
            if found[a] and found[b]]


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
    port_names = port_kernel_names()
    names = []  # the graph's own nodes, each by the port's kernel function it names, else by its type
    for node, attrs in nodes.items():
        if node.startswith(frame_graph):
            found = [k for k in port_names if k in attrs]
            names.append(max(found, key=len) if found else node_type(attrs))
    return kernel_launches(nodes.values()), conditional, own, len(nodes) - own, sorted(names)


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
    set-up's pack and of the binning kernels (``raster.pack_binned``,
    ``raster.slot_records``, then ``raster.bin_packed_plain``), on the card:
    the raster kernels' inputs as the plain chain makes them."""
    from f_renderer_tpu_torch.pipeline import raster

    ti, tf = raster.pack_binned(tri, cfg.width, cfg.height)
    return raster.bin_packed_plain(raster.slot_records(ti, tf), ti[raster.MINXY:raster.MAXXY + 1], tri.num_slots,
                                   tri.num_channels, cfg.width, cfg.height, cfg.tile, **kw)


def bits_equal(a, b):
    """Two tensors equal bit for bit, a float NaN equal to any NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def records_equal(a, b, n_ctx):
    """Two record arrays (m, rec) int32 equal: the int and padding words
    bit for bit, the float words too, a NaN equal to any NaN."""
    rf = 12 + 9 + 3 * n_ctx
    return (a.shape == b.shape and bits_equal(a[:, :12], b[:, :12]) and bits_equal(a[:, rf:], b[:, rf:])
            and bits_equal(record_floats(a, n_ctx), record_floats(b, n_ctx)))


def record_floats(recs, n_ctx):
    """The float words of records (m, rec) int32, as float32 (m, 9 + 3C)."""
    import torch

    return recs[:, 12:21 + 3 * n_ctx].contiguous().view(torch.float32)


def float_err(a, b):
    """The largest |a - b| where both are finite (0 for empty tensors)."""
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.where(both, (a - b).abs(), 0.0).max()) if a.numel() else 0.0


def bins_equal(got, want, recs, packed):
    """The binning kernels' prep against the plain one: equal offsets, and
    the pair columns bit for bit where the plain version takes the packed
    sort (both order pairs by (key, slot)); where it takes the two-operand
    sort, each key's list the same set of slots (the kernels' in slot
    order), each pair column its slot's record, and the padding columns
    equal."""
    import torch

    from f_renderer_tpu_torch.pipeline.raster import SLOT

    if not torch.equal(got.off, want.off):
        return False
    if packed:
        return bits_equal(got.tri_i32, want.tri_i32) and bits_equal(got.tri_f32, want.tri_f32)
    ti, tf = recs[:, :12].T, record_floats(recs, got.n_ctx).T  # the slots' packed columns
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


def occupancy(regs, smem, threads):
    """Blocks of a kernel an H100 SM holds at once, and its share of the
    SM's 64 warps: the least of the threads (2,048), the registers (65,536,
    a warp's rounded up to 256), the shared memory (228 KB, 1 KB more a
    block) and 32 blocks."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(2048 // threads, (65536 // per_warp) // warps, 233472 // (smem + 1024), 32)
    return blocks, blocks * warps / 64


def occupancy_report(lines, packed, smi):
    """Registers, shared memory and occupancy of the set-up and binning
    kernels at ``packed``'s shapes (stress4k), from their ``ptxas -v`` lines
    and their launch shapes (csrc/tri_setup.cu: 128 threads, rec + 1 words
    of staging a thread; csrc/bin_pairs.cu: 256-thread stripes with a
    counter a key, 1,024-thread scan blocks, 128-thread gather blocks with
    64 records at an odd stride of 16-byte pieces and m_dummy's)."""
    import re

    recs, c = packed[0], packed[3]
    rec = recs.shape[1]
    w, h = SIZES["stress4k"]
    ntx, nty = -(-w // 128), -(-h // 64)
    n_keys = ntx * nty + -(-ntx // 4) * -(-nty // 4) + 1
    stride = min(rec // 4, 16) | 1
    shapes = {"tri_setup_kernel<3>": (128, 4 * 32 * (rec + 1) * 4), "tri_slots_kernel": (128, 4 * 32 * (rec + 1) * 4),
              "bin_count_kernel": (256, 4 * n_keys), "bin_scan_kernel": (1024, 0),
              "bin_pairs_kernel": (256, 4 * n_keys), "bin_gather_kernel": (128, 64 * stride * 16 + 256)}
    for name, (threads, dyn) in shapes.items():
        used = [line for line in lines if line.split(":")[0] == name and "registers" in line]
        if not used:
            check(False, f"occupancy: no ptxas line for {name}")
            continue
        regs = int(re.search(r"Used (\d+) registers", used[0]).group(1))
        static = re.search(r"(\d+) bytes smem", used[0])
        smem = dyn + (int(static.group(1)) if static else 0)
        blocks, share = occupancy(regs, smem, threads)
        log(f"  occupancy {name} at stress4k (C={c}, rec={rec}, {n_keys} keys): {regs} registers, {smem} B shared "
            f"memory ({dyn} dynamic), {threads} threads: {blocks} blocks an SM, {share:.2f} of its warps ({smi})")


def setup_launch(entry):
    """Run ``entry()`` (a ``build_packed`` call) once with the set-up
    kernels' wrappers recorded → a function that launches those kernels
    alone with the same arguments: launch 1 (a fresh zeroed accumulator
    and outputs), then, where the recorded run clipped a face, the clip
    path's launches on its outputs and the recorded fan words."""
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
        a1, kw1 = seen["first"]
        recs, bbox, _, acc = first(*a1, **kw1)
        if "rest" in seen:
            a2, kw2 = seen["rest"]
            rest(a2[0], a2[1], recs, bbox, acc, **kw2)

    return launch


def sharded_phase(dev, smi, rows, launches, drive, graph_path, clip_flip):
    """K1 and K4 with an origin against their plain versions; every row slab
    of phong1080 (K1), phong1080_tex2048 (K4 + shade_planes) and stress4k (K1)
    stitched and held to the whole frame; a 2 x 4 grid's stages in this
    process (phong1080 all-gathered and streamed, phong1080_tex2048 on the
    gather path), eagerly and captured (``compiled.grid_frame``);
    ``render_frame_sharded`` through NCCL at world size 1 (the process group
    is initialized), eagerly and captured (``compiled.sharded_frame``)."""
    import torch

    from f_renderer_tpu_torch import compiled
    from f_renderer_tpu_torch.parallel import gather_slabs, make_render_mesh, render_frame_grid, render_frame_sharded
    from f_renderer_tpu_torch.parallel import sharding
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

    before = counts()
    tex_slab(3 * slab)
    ran = {k: n - before[k] for k, n in counts().items() if n != before[k]}
    check(ran == {"raster_planes": 1, "shade_planes": 1, "bin_pairs": 1},
          f"phong1080_tex2048: a slab launched {ran}, not K4, shade_planes and the binning once each")
    timing["phong1080_tex2048 K4 + shade_planes"] = slabs_timed("phong1080_tex2048 K4 + shade_planes",
                                                                lambda: tex_slab(0, h), tex_slab, h)
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
    # for the all-gather and the ring, sums and maxima for the all-reduce;
    # then the NCCL entry at world size 1. Each shard's set-up is one launch
    # 1 (the set-up kernels' shard mode) and one tri_quirk_kernel. The
    # single-device frames run eagerly, as the grid's stages do (and warm
    # them as before the frame was captured)
    from f_renderer_tpu_torch import kernels

    def eager(s):
        return render_frame(list(s.draws), s.vertex_shader, s.vs_uniform, s.pixel_shader, s.ps_uniform, s.config)

    def quirk_launches(tag, before, want):
        got = kernels.tri_quirk.launches - before
        check(got == want, f"{tag}: {got} tri_quirk launches, not {want} (one a shard a frame)")

    eager(scene)
    whole = eager(scene)
    whole_planes = eager(dataclasses.replace(scene, config=dataclasses.replace(cfg, fused_shade=False)))
    zero = dict.fromkeys(counts(), 0)
    grid_args = (scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform)
    q0 = kernels.tri_quirk.launches
    outs, got = drive("phong1080 render_frame_grid 2 x 4 (all_gather, in one process)",
                      lambda i: render_frame_grid(*grid_args, cfg, 2, 4), 1,
                      dict(zero, fused_raster=8, tri_setup=2, bin_pairs=8), (h, w, 4))
    quirk_launches("phong1080 render_frame_grid 2 x 4 (all_gather)", q0, 2)
    launches["K1 grid 2x4"] = got["fused_raster"]
    launches["tri_setup grid 2x4"] = got["tri_setup"]
    check(torch.equal(outs[0][0], whole[0]) and torch.equal(outs[0][1], whole[1]),
          "phong1080: the 2 x 4 grid's frame differs from the single-device frame")
    stream_cfg = dataclasses.replace(cfg, comm_mode="stream")
    outs, got = drive("phong1080 render_frame_grid 2 x 4 (stream, in one process)",
                      lambda i: render_frame_grid(*grid_args, stream_cfg, 2, 4), 1,
                      dict(zero, raster_planes=16, shade_planes=8, bin_pairs=16, tri_setup=2, stream_merge=16),
                      (h, w, 4))
    launches["K4 grid 2x4 stream"] = got["raster_planes"]
    launches["stream_merge grid 2x4 stream"] = got["stream_merge"]
    launches["shade_planes grid 2x4 stream"] = got["shade_planes"]
    check(torch.equal(outs[0][0], whole_planes[0]) and torch.equal(outs[0][1], whole_planes[1]),
          "phong1080: the 2 x 4 grid's stream frame differs from the single-device fused_shade=False frame")

    # the gather path (K4 without varyings, interp_records, the shading
    # kernel) on phong1080_tex2048's scene, whose stack is past the fused
    # kernel's budget
    tex = build_scene("phong1080_tex2048", dev)
    set_angle(tex, ANGLES[0])
    check(sharding.slab_path(tex.config, tex.pixel_shader, tex.ps_uniform, 2) == "gather",
          "phong1080_tex2048: the sharded frame does not take the gather path")
    tex_args = (tex.draws, tex.vertex_shader, tex.vs_uniform, tex.pixel_shader, tex.ps_uniform)
    eager(tex)
    tex_whole = eager(tex)
    gather_expect = dict(raster_planes=8, interp_records=8, shade_planes=8, bin_pairs=8, tri_setup=2)
    q0 = kernels.tri_quirk.launches
    outs, got = drive("phong1080_tex2048 render_frame_grid 2 x 4 (all_gather, the gather path, in one process)",
                      lambda i: render_frame_grid(*tex_args, tex.config, 2, 4), 1, dict(zero, **gather_expect),
                      (h, w, 4))
    quirk_launches("phong1080_tex2048 render_frame_grid 2 x 4 (gather)", q0, 2)
    launches["interp_records grid 2x4"] = got["interp_records"]
    check(torch.equal(outs[0][0], tex_whole[0]) and torch.equal(outs[0][1], tex_whole[1]),
          "phong1080_tex2048: the 2 x 4 grid's gather-path frame differs from the single-device frame")

    mesh = make_render_mesh(1, 1, device_type="cuda")

    def sharded_args():
        return scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform

    def sharded(i):
        set_angle(scene, 0.10 + 0.05 * i)
        return gather_slabs(mesh, *render_frame_sharded(*sharded_args(), cfg, mesh))

    sharded(0)
    q0 = kernels.tri_quirk.launches
    outs, got = drive("phong1080 render_frame_sharded (NCCL, world size 1)", sharded, FRAMES,
                      dict(zero, fused_raster=FRAMES, tri_setup=FRAMES, bin_pairs=FRAMES), (h, w, 4))
    quirk_launches("phong1080 render_frame_sharded (NCCL, world size 1)", q0, FRAMES)
    launches["K1 sharded world 1"] = got["fused_raster"]
    set_angle(scene, ANGLES[0])
    check(torch.equal(outs[0][0], whole[0]) and torch.equal(outs[0][1], whole[1]),
          "phong1080: render_frame_sharded at world size 1 differs from the single-device frame")

    # the same frames captured: jax.jit over the shard_map step. The warm-up
    # frame runs the collectives eagerly, then the capture records them; one
    # conditional node a shard (the set-up's clip path), the quirk's
    # all-reduce and tri_quirk_kernel after it
    def sharded_now():
        return compiled.sharded_frame(*sharded_args(), cfg, mesh)

    def sharded_graph(i):
        set_angle(scene, 0.10 + 0.05 * i)
        return sharded_now()

    def sharded_eager(i):
        set_angle(scene, 0.10 + 0.05 * i)
        return render_frame_sharded(*sharded_args(), cfg, mesh)

    outs = graph_path("phong1080 compiled.sharded_frame (NCCL, world size 1)", sharded_graph, sharded_eager, FRAMES,
                      dict(zero, fused_raster=FRAMES, tri_setup=FRAMES, bin_pairs=FRAMES), (h, w, 4),
                      {"K1 sharded graph": "fused_raster", "bin_pairs sharded graph": "bin_pairs",
                       "tri_setup sharded graph": "tri_setup"}, geometries=1)
    check(torch.equal(outs[0][0], whole[0]) and torch.equal(outs[0][1], whole[1]),
          "phong1080: compiled.sharded_frame at world size 1 differs from the single-device frame")
    set_angle(scene, ANGLES[0])
    clip_flip("phong1080 compiled.sharded_frame (NCCL, world size 1)", scene, sharded_now,
              lambda: render_frame_sharded(*sharded_args(), cfg, mesh), single=lambda: eager(scene))

    # the 2 x 4 grids captured in this process: dp = 2 under a graph on one card
    for tag, sc, c, single_cfg, expect, keys in (
            ("all_gather", scene, cfg, cfg, {"fused_raster": 8, "tri_setup": 2, "bin_pairs": 8},
             {"K1 grid 2x4 graph": "fused_raster", "tri_setup grid 2x4 graph": "tri_setup"}),
            ("stream", scene, stream_cfg, dataclasses.replace(cfg, fused_shade=False),
             {"raster_planes": 16, "shade_planes": 8, "bin_pairs": 16, "tri_setup": 2, "stream_merge": 16},
             {"K4 grid 2x4 stream graph": "raster_planes", "shade_planes grid 2x4 stream graph": "shade_planes",
              "stream_merge": "stream_merge"}),
            ("all_gather, the gather path on phong1080_tex2048", tex, tex.config, tex.config, gather_expect,
             {"interp_records": "interp_records", "K4 grid 2x4 gather graph": "raster_planes"})):
        def grid_now(sc=sc, c=c):
            return compiled.grid_frame(sc.draws, sc.vertex_shader, sc.vs_uniform, sc.pixel_shader, sc.ps_uniform,
                                       c, 2, 4)

        def grid_graph(i, sc=sc, c=c):
            set_angle(sc, 0.10 + 0.05 * i)
            return grid_now(sc, c)

        def grid_eager(i, sc=sc, c=c):
            set_angle(sc, 0.10 + 0.05 * i)
            return render_frame_grid(sc.draws, sc.vertex_shader, sc.vs_uniform, sc.pixel_shader, sc.ps_uniform,
                                     c, 2, 4)

        def single(sc=sc, c=single_cfg):
            return eager(dataclasses.replace(sc, config=c))

        n = 3
        name = "phong1080_tex2048" if sc is tex else "phong1080"
        outs = graph_path(f"{name} compiled.grid_frame 2 x 4 ({tag}, in one process)", grid_graph, grid_eager, n,
                          dict(zero, **{k: v * n for k, v in expect.items()}), (h, w, 4), keys, geometries=2)
        set_angle(sc, ANGLES[0])
        want = single()
        check(torch.equal(outs[0][0], want[0]) and torch.equal(outs[0][1], want[1]),
              f"{name}: compiled.grid_frame 2 x 4 ({tag}) differs from the single-device frame")
        clip_flip(f"{name} compiled.grid_frame 2 x 4 ({tag})", sc, grid_now,
                  lambda sc=sc, c=c: render_frame_grid(sc.draws, sc.vertex_shader, sc.vs_uniform, sc.pixel_shader,
                                                       sc.ps_uniform, c, 2, 4), single=single)
    rows["K1"]["launches_grid_2x4"] = launches.pop("K1 grid 2x4")
    rows["K1"]["launches_sharded_world1"] = launches.pop("K1 sharded world 1")
    rows["K4"]["launches_grid_2x4_stream"] = launches.pop("K4 grid 2x4 stream")
    rows["shade_planes"]["launches_grid_2x4_stream"] = launches.pop("shade_planes grid 2x4 stream")
    rows["stream_merge"]["launches_grid_2x4_stream_eager"] = launches.pop("stream_merge grid 2x4 stream")
    rows["tri_setup"]["launches_grid_2x4"] = launches.pop("tri_setup grid 2x4")
    rows["interp_records"]["launches_grid_2x4_eager"] = launches.pop("interp_records grid 2x4")


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
    # tri_setup_kernel<0..4> (the planes mode and four vertex stages), tri_slots, tri_quirk; bin_count, bin_scan,
    # bin_pairs, bin_gather
    check(len(frames) == 11 and all("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in line
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
        ok = (got[2:4] == want[2:4] and records_equal(got[0], want[0], want[3]) and bits_equal(got[1], want[1])
              and int(got[4]["num_clipped"]) == int(want[4]["num_clipped"]))
        if got[0].shape == want[0].shape:
            worst["tri_setup"] = max(worst["tri_setup"], float_err(record_floats(got[0], want[3]),
                                                                   record_floats(want[0], want[3])))
        check(ok, f"tri_setup {tag}: the records or bboxes differ from the plain version's (slots {got[2]} / "
                  f"{want[2]}, clipped {int(got[4]['num_clipped'])} / {int(want[4]['num_clipped'])})")
        return want, ok

    def check_bins(tag, packed, cfg, fused_path, rows=None, **kw):
        """The binning from records and bboxes (``packed``) against its
        plain version; with ``rows`` (packed rows, whose records ``packed``
        holds) from the rows too: ``raster.bin_rows``."""
        recs, bbox, n, c, _ = packed
        bins = (recs, bbox, n, c, cfg.width, cfg.height, cfg.tile)
        kw = dict(bin_settings(cfg, fused_path), **kw)
        got, want = raster.bin_packed(*bins, **kw), plain(raster.bin_packed_plain, *bins, **kw)
        sort = sum(sort_bits(want, recs.shape[0])) <= 31
        ok = bins_equal(got, want, recs, sort)
        if rows is not None:
            from_rows = raster.bin_rows(*rows, *bins[2:], **kw)
            ok_rows = bins_equal(from_rows, want, recs, sort)
            check(ok_rows, f"bin_pairs {tag}: the binned prep from packed rows differs from the plain version's")
            ok = ok and ok_rows
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
        entry points' and plain versions' ms, and their bounds; the binning
        also reading the records' own bbox words."""
        cfg = scene.config
        args = (scene.draws, scene.vertex_shader, scene.vs_uniform, cfg)
        recs, bbox, n, c, _ = packed
        bins = (recs, bbox, n, c, cfg.width, cfg.height, cfg.tile)
        kw = bin_settings(cfg, fused_path)
        a_launch = setup_launch(lambda: build_packed(*args))
        a = timed(lambda: build_packed(*args), a_launch, lambda: build_packed_plain(*args), 20, 3)
        b_launch = kernel_call("bin_pairs", lambda: raster.bin_packed(*bins, **kw))
        b = timed(lambda: raster.bin_packed(*bins, **kw), b_launch, lambda: raster.bin_packed_plain(*bins, **kw), 20, 3)
        own_bbox = recs[:, raster.MINXY:raster.MAXXY + 1].T  # the records' own bbox words: 32 B sectors, not 8 B
        b_own = [device_ms(lambda: b_launch(recs, own_bbox), 20) for _ in range(2)]
        prep = raster.bin_packed(*bins, **kw)
        faces = sum(next(iter(d.values())).shape[0] for d in scene.draws)
        n_draws, nb = len(scene.draws), cfg.clip_cap * MAX_FAN
        clipping = sum(v > 0 for v in clipped_per_draw(scene, ANGLES[0]))
        m_pad, rec, rows_f = recs.shape[0], recs.shape[1], 9 + 3 * c
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
        # the records (rec words a slot) and the bbox array written
        a_bytes = vertex_bytes + 4 * nb * (23 + 3 * c) * clipping + (4 * rec + 8) * m_pad + faces
        a_ops = 100 * faces + vertex_ops + 45 * n_draws * nb
        # binning: the records and the bbox words read once, the pair-order
        # arrays and the offsets written; ~30 operations a slot and ~10 a pair
        pairs = int(prep.off[-1])
        b_bytes = (4 * rec + 8) * m_pad + 4 * (12 + rows_f) * prep.tri_i32.shape[1] + 4 * prep.off.numel()
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
        out["bin_pairs"]["ms_bbox_from_records"] = b_own
        log(f"  {tag} bin_pairs reading the records' own bbox words (bb_slot {rec}) in place of the (2, m_pad) "
            f"array: {b_own[0]:.4f} / {b_own[1]:.4f} ms (device), against {b[3][0]:.4f} / {b[3][1]:.4f} ({smi})")
        setup_sum, bound_sum = a[0] + b[0], out["tri_setup"]["bound_ms"] + out["bin_pairs"]["bound_ms"]
        log(f"  {tag} set-up + binning: {setup_sum:.4f} ms against the summed bound {bound_sum:.4f} ms, share "
            f"{bound_sum / setup_sum:.3f} ({smi})")
        return out

    def packed_rows(scene):
        """The plain chain's packed rows of the scene (``pack_binned``), the
        rows path's input, whose records the plain set-up's are."""
        from f_renderer_tpu_torch.pipeline.render import build_triangles

        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        return raster.pack_binned(tri, scene.config.width, scene.config.height)

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
        rows_path = None
        if (name, angle) in (("phong1080", ANGLES[0]), ("stress4k", ANGLES[0]), ("custom12_360", 0.3)):
            rows_path = packed_rows(scene)
        got, ok_b, sort = check_bins(f"{name}@{angle}", packed, cfg, fused_path, rows=rows_path)
        report(f"{name}@{angle}", packed, got, ok_a, ok_b, sort, mode)
        if name == "phong1080" and angle == ANGLES[0]:
            cap = cfg.clip_cap
            for n in (1, cap, cap + 7):
                draws = clipped_draws(scene.draws, scene.vs_uniform, n)
                flip, ok_a = check_setup(f"phong1080 with {n} faces clipped", scene, draws)
                got, ok_b, sort = check_bins(f"phong1080 with {n} faces clipped", flip, cfg, fused_path)
                report(f"phong1080@{angle} with {n} faces of draw 0 clipped", flip, got, ok_a, ok_b, sort, mode)
            slab, oks = cfg.height // 8, []
            for lin in range(8):  # from records, and as the sharded frame bins them: rows, the last column the dummy
                got, ok_b, sort = check_bins(f"phong1080 slab {lin} of 8", packed, cfg, fused_path,
                                             origin=(lin * slab, 0), size=(slab, cfg.width))
                got, ok_s, _ = check_bins(f"phong1080 slab {lin} of 8 (rows, the sharded frame's dummy)", packed,
                                          cfg, fused_path, rows=rows_path, origin=(lin * slab, 0),
                                          size=(slab, cfg.width), m_dummy=packed[0].shape[0] - 1)
                oks.append(ok_b and ok_s and sort)
            got, ok_k4, _ = check_bins("phong1080 (rows, K4's settings: raster.prep_binned)", packed, cfg, False,
                                       rows=rows_path)
            log(f"  phong1080@{angle}: the eight row slabs' bins (origin, size; from records, and from rows with the "
                f"last column the dummy) bit-equal={oks}; from rows with K4's settings bit-equal={ok_k4}")
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
            occupancy_report(lines, packed, smi)
            cfg32 = dataclasses.replace(cfg, tile=(32, 128), tile_auto=False)
            got, ok_b, sort = check_bins("stress4k th=32", packed, cfg32, fused_path)
            check(not sort, "stress4k th=32: the plain version took the packed sort, not the two-operand one")
            report("stress4k@0.1 th=32", packed, got, ok_a, ok_b, sort, mode)
        del scene, packed, got, rows_path
    for key in worst:
        rows[key]["max_abs_err"] = worst[key]
    rows["tri_setup"]["ptxas"] = [line for line in lines if line.startswith("tri_")]
    rows["bin_pairs"]["ptxas"] = [line for line in lines if line.startswith("bin_")]


def shard_phase(dev, smi, rows):
    """3i. the sharded frame's kernels against their plain versions on the
    card: the set-up kernels' shard mode (``sharding.setup_shard_kernels``,
    the quirk's totals reduced over the shards, ``kernels.tri_quirk``) on
    each dp shard of phong1080's 2 x 4 grid, with 0, 1 and cap + 7 faces of
    draw 0 clipped, against the plain chain (``setup_shard_plain``: PyTorch's
    geometry, the quirk's partials, ``pack_shard``, ``raster.slot_records``)
    byte for byte; and ``interp_records_kernel`` (csrc/interp_records.cu)
    against ``shade.interpolate_records`` bit for bit (a NaN equal to any
    NaN) on the winners K4 gives slab 3 of 8 of phong1080 and custom12_360
    from their records, and on the gathered records of phong1080_tex2048's
    2 x 4 grid (the main path's shapes: its device time, plain time and
    bound), each also held to K4's own interpolation where a pixel is
    covered."""
    import torch

    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.parallel import sharding
    from f_renderer_tpu_torch.pipeline import raster, shade
    from f_renderer_tpu_torch.pipeline.render import build_packed

    log("[kernel-vs-plain] the set-up kernels' shard mode (tri_setup_kernel, tri_slots_kernel, tri_quirk_kernel); "
        "interp_records (the gather path's interpolate_context, XLA's fusion)")
    lines = [line for line in kernels.ptxas_report() if line.startswith("interp_records_kernel")]
    for line in lines:
        log(f"  ptxas {line}")
    check(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in line for line in lines),
          f"interp_records_kernel: a stack frame or spills ({lines})")

    def kernel_route(scene, draws, cfg, n_dp):
        plan = sharding.shard_plan(draws, cfg, n_dp, 8 // n_dp)
        setups = [sharding.setup_shard_kernels(draws, scene.vertex_shader, scene.vs_uniform, cfg, plan, dp)
                  for dp in range(n_dp)]
        totals = sharding.reduce_quirk(setups)
        return [sharding.shard_records(s, totals, cfg) for s in setups], setups

    def plain_route(scene, draws, cfg, n_dp):
        plan = sharding.shard_plan(draws, cfg, n_dp, 8 // n_dp)
        setups = [sharding.setup_shard_plain(draws, scene.vertex_shader, scene.vs_uniform, cfg, plan, dp)
                  for dp in range(n_dp)]
        totals = sharding.reduce_quirk(setups)
        return [sharding.shard_records(s, totals, cfg) for s in setups], setups

    scene = build_scene("phong1080", dev)
    set_angle(scene, ANGLES[0])
    cfg, cap, worst = scene.config, scene.config.clip_cap, 0.0
    for n in (0, 1, cap + 7):
        draws = clipped_draws(scene.draws, scene.vs_uniform, n) if n else scene.draws
        before = {k: getattr(kernels, k).launches for k in ("tri_setup", "tri_setup_slots", "tri_quirk")}
        got, setups = kernel_route(scene, draws, cfg, 2)
        torch.cuda.synchronize()
        ran = {k: getattr(kernels, k).launches - v for k, v in before.items()}
        want, _ = plain(plain_route, scene, draws, cfg, 2)
        plan = sharding.shard_plan(draws, cfg, 2, 4)
        clipped = [int(sharding.shard_geometry(draws, scene.vertex_shader, scene.vs_uniform, cfg, plan, dp)[2])
                   for dp in range(2)]
        oks = []
        for dp, ((recs, bbox), (wr, wb), s) in enumerate(zip(got, want, setups)):
            ok = records_equal(recs, wr, s.n_ctx) and bits_equal(bbox, wb.contiguous())
            worst = max(worst, float_err(record_floats(recs, s.n_ctx), record_floats(wr, s.n_ctx)))
            oks.append(ok)
        expect = {"tri_setup": 2, "tri_setup_slots": sum(c > 0 for c in clipped), "tri_quirk": 2}
        check(all(oks) and ran == expect,
              f"phong1080 2 x 4 with {n} faces clipped: the shards' records equal the plain chain's {oks}, the "
              f"set-up launched {ran}, not {expect}")
        log(f"  phong1080@{ANGLES[0]} 2 x 4, {n} faces of draw 0 moved through the near plane: faces clipped per "
            f"shard {clipped}; each shard's records and bbox words equal the plain chain's={oks} ({ran}; the "
            f"shards' {setups[0].m} slots in {got[0][0].shape[0]} records each)")
    rows["tri_setup"]["shard_mode_max_abs_err"] = worst

    def planes(name, origin_slab, gathered=None):
        """A slab's K4 winners from the set-up's records (``gathered``: the
        2 x 4 grid's gathered records and bboxes) → (records, C, winner, its
        prep, K4's interpolated ctx and ps)."""
        sc = build_scene(name, dev)
        set_angle(sc, ANGLES[0] if name != "custom12_360" else 0.3)
        c = sc.config
        if gathered is None:
            recs, bbox, m, n_ctx, _ = build_packed(sc.draws, sc.vertex_shader, sc.vs_uniform, c)
        else:
            shards, setups = kernel_route(sc, sc.draws, c, 2)
            recs, bbox = torch.cat([r for r, _ in shards]), torch.cat([b for _, b in shards], dim=-1)
            m, n_ctx = 2 * setups[0].m, setups[0].n_ctx
        slab = c.height // 8
        prep = raster.bin_packed(recs, bbox, m, n_ctx, c.width, c.height, c.tile, origin=(origin_slab * slab, 0),
                                 size=(slab, c.width), m_dummy=recs.shape[0] - 1)
        depth, winner, ps4, ctx4 = raster.raster_planes(prep, interp=True)
        return recs, n_ctx, winner[:slab, :c.width], prep, ctx4[:, :slab, :c.width], ps4[:slab, :c.width]

    def compare(tag, recs, n_ctx, winner, prep, ctx4, ps4):
        ctx, ps = shade.interp_records(recs, winner, n_ctx, origin=prep.origin)
        want_ctx, want_ps = plain(shade.interpolate_records, recs, winner, n_ctx, origin=prep.origin)
        cov = winner >= 0
        ok = bits_equal(ctx, want_ctx) and torch.equal(ps, want_ps)
        ok_k4 = bits_equal(torch.where(cov, ctx, 0.0), torch.where(cov, ctx4, 0.0)) and torch.equal(
            torch.where(cov, ps, 0), torch.where(cov, ps4, 0))
        err = float_err(ctx, want_ctx)
        check(ok and ok_k4, f"interp_records {tag}: differs from interpolate_records ({ok}) or from K4's "
                            f"interpolation on covered pixels ({ok_k4})")
        log(f"  interp_records {tag} (C = {n_ctx}, {tuple(winner.shape)} pixels at {prep.origin}, "
            f"{int(cov.sum())} covered, {recs.shape[0]} records): equal to interpolate_records={ok}, to K4's "
            f"interpolation where covered={ok_k4}")
        return err

    errs = [compare(f"{name} slab 3 of 8", *planes(name, 3)) for name in ("phong1080", "custom12_360")]
    recs, n_ctx, winner, prep, ctx4, ps4 = planes("phong1080_tex2048", 3, gathered=True)
    errs.append(compare("phong1080_tex2048 slab 3 of 8 of the 2 x 4 grid (gathered records)", recs, n_ctx, winner,
                        prep, ctx4, ps4))
    launch = kernel_call("interp_records", lambda: shade.interp_records(recs, winner, n_ctx, origin=prep.origin))
    k_ms, p_ms, w_ms, each = timed(lambda: shade.interp_records(recs, winner, n_ctx, origin=prep.origin), launch,
                                   lambda: shade.interpolate_records(recs, winner, n_ctx, origin=prep.origin), 50, 3)
    n = winner.numel()
    distinct = int(torch.unique(torch.clamp(winner, min=0)).numel())
    # the winner read and ctx / ps written a pixel; each distinct winner's
    # record words read once (9 float rows, 3C varyings, the PS word); ~20
    # operations a pixel and 5 a varying
    nbytes = 4 * n * (2 + n_ctx) + 4 * distinct * (10 + 3 * n_ctx)
    ops = n * (20 + 5 * n_ctx)
    b_ms, b_by = bound_ms(nbytes, ops)
    rows["interp_records"] = {
        "name": "interp_records (the sharded gather path's interpolate_context, XLA's fusion)", "route": "cuda",
        "source": "f_renderer_tpu_torch/csrc/interp_records.cu",
        "replaces": "f_renderer_tpu/pipeline/shade.py:23 (no pallas_call: XLA's fusion of interpolate_context, "
                    "which the sharded frame's gather path runs, parallel/sharding.py:295-336)",
        "ms": k_ms, "ms_each": each[:2], "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "wrapper_ms": w_ms, "max_abs_err": max(errs), "bytes": nbytes, "ops": ops, "pixels": n,
        "distinct_winners": distinct, "records": recs.shape[0], "ptxas": lines}
    log(f"  phong1080_tex2048 slab 3 of 8 (2 x 4, gathered records) interp_records time: kernel {each[0]:.4f} / "
        f"{each[1]:.4f} ms (device), entry point {each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.3f} / "
        f"{each[3]:.3f} ms, bound {b_ms:.5f} ms by {b_by} ({nbytes} B, {ops} ops), share {b_ms / k_ms:.3f} "
        f"(CUDA events; {smi})")


def bytes_equal(a, b):
    """Two tensors equal byte for byte (NaNs by their bits, -0.0 apart from 0.0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


MERGE_PLANES = ("depth", "order", "winner", "ps", "ctx")
# The PyTorch kernels of the stream merge that stream_merge_kernel replaced
# (mangled names): the wheres, the compares and their |, the orders' index
# gather and clamp; none may run in the stream grid's replay.
MERGE_OPS = ("where_kernel", "Compare", "BitwiseOrFunctor", "index_elementwise", "index_kernel", "clamp")


def crafted_merge_round(seed, h, w, n_ctx, m, owner, dev, rec=36, pad=(25, 128)):
    """A crafted round at a slab's shape: the accumulator (depth, order,
    winner, ps, ctx) and K4-like padded planes (depth, global winner, ps,
    ctx) whose depths and orders tie the accumulator's (equal depths with a
    higher, an equal and a lower order; -0.0 against 0.0; NaN), with -1
    winners on both sides, the held shard's records (ORDER words 0..3) and
    its slot0 = owner · m → (acc, planes, recs, slot0, the ties counted)."""
    import numpy as np
    import torch

    from f_renderer_tpu_torch.pipeline.raster import ORDER, ORDER_NONE

    rng = np.random.default_rng(seed)
    shape = (h, w)
    acc_depth = rng.choice(np.array([0.0, -0.0, 0.25, 0.5], np.float32), shape)
    acc_order = rng.choice(np.array([ORDER_NONE, 0, 1, 2, 3], np.int32), shape)
    acc_winner = np.where(acc_order == ORDER_NONE, -1, rng.integers(0, 4 * m, shape)).astype(np.int32)
    acc = [acc_depth, acc_order, acc_winner, rng.integers(0, 9, shape).astype(np.int32),
           rng.standard_normal((n_ctx,) + shape).astype(np.float32)]
    recs = rng.integers(-(2 ** 31), 2 ** 31 - 1, (m, rec), dtype=np.int64).astype(np.int32)
    recs[:, ORDER] = rng.integers(0, 4, m)
    win = np.where(rng.random(shape) < 0.3, -1, rng.integers(0, m, shape)).astype(np.int32)
    d = rng.choice(np.array([0.0, -0.0, 0.25, 0.5, 1.0, np.nan], np.float32), shape)
    none = win < 0
    d[none] = rng.choice(np.array([0.0, -0.0], np.float32), int(none.sum()))
    o = np.where(none, ORDER_NONE, recs[:, ORDER][np.maximum(win, 0)])
    eq = d == acc_depth
    ties = {"equal depth, higher order": int((eq & (o > acc_order)).sum()),
            "equal depth, equal order": int((eq & (o == acc_order)).sum()),
            "equal depth, lower order": int((eq & (o < acc_order)).sum()),
            "-0.0 against 0.0": int((eq & (np.signbit(d) != np.signbit(acc_depth))).sum()),
            "no winner on either side": int((none & (acc_winner < 0)).sum()), "NaN depth": int(np.isnan(d).sum())}
    ps = np.where(none, 0, rng.integers(0, 9, shape)).astype(np.int32)
    ctx = np.where(none[None], 0, rng.standard_normal((n_ctx,) + shape)).astype(np.float32)
    win_g = np.where(none, -1, win + owner * m).astype(np.int32)

    def pad_plane(a, fill):
        out = np.full(a.shape[:-2] + (h + pad[0], w + pad[1]), fill, a.dtype)
        out[..., :h, :w] = a
        return torch.from_numpy(out).to(dev)

    planes = (pad_plane(d, np.nan), pad_plane(win_g, 12345), pad_plane(ps, 77), pad_plane(ctx, np.inf))
    return ([torch.from_numpy(a).to(dev) for a in acc], planes, torch.from_numpy(recs).to(dev), owner * m, ties)


def stream_phase(dev, smi, rows):
    """3j. ``stream_merge_kernel`` (csrc/stream_merge.cu: XLA's fusion of
    the JAX package's per-round merge of the stream mode,
    parallel/sharding.py:224-245) against ``sharding.stream_merge_plain``
    on the same inputs, the five accumulator planes byte for byte: on each
    of the 16 rounds of phong1080's 2 x 4 stream grid (the inputs recorded
    from one eager frame: K4's padded planes, the held shard's records, the
    accumulator before the round; round 0 writes it whole, and also equals
    the merge into ``stream_start``'s fills) and on crafted rounds at the
    slab's shape (ties of depth with a higher, an equal and a lower order,
    -0.0 against 0.0, no winner on either side, owners 0, 1 and 3), merging
    and writing whole. Its ``ptxas`` line with no stack frame or spills; its
    device time on each round of the frame (a fresh copy of the accumulator
    a launch) against the bound from this run's data, and its plain time."""
    import torch

    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.parallel import render_frame_grid, sharding
    from f_renderer_tpu_torch.pipeline.raster import ORDER, ORDER_NONE

    log("[kernel-vs-plain] stream_merge (the stream mode's per-round merge, XLA's fusion)")
    lines = [line for line in kernels.ptxas_report() if line.startswith("stream_merge_kernel")]
    for line in lines:
        log(f"  ptxas {line}")
    check(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in line for line in lines),
          f"stream_merge_kernel: a stack frame or spills ({lines})")

    def run(planes, recs, acc, slot0, first, kernel):
        """The kernel or its plain version on a copy of ``acc`` → the merged planes."""
        out = sharding.StreamPlanes(*(t.clone() for t in acc))
        if kernel:
            kernels.stream_merge(*planes, recs, out.planes(), slot0=slot0, first=first)
        else:
            plain(sharding.stream_merge_plain, out, *planes, recs[:, ORDER], slot0, first)
        torch.cuda.synchronize()
        return out

    worst = [0.0]

    def compare(tag, planes, recs, acc, slot0, first):
        got = run(planes, recs, acc, slot0, first, True)
        want = run(planes, recs, acc, slot0, first, False)
        eq = [bytes_equal(a, b) for a, b in zip(got.planes(), want.planes())]
        check(all(eq), f"stream_merge {tag}: differs from stream_merge_plain on "
                       f"{[n for n, e in zip(MERGE_PLANES, eq) if not e]}")
        worst[0] = max(worst[0], float_err(got.depth, want.depth), float_err(got.ctx, want.ctx))
        return got, all(eq)

    # the 16 rounds of phong1080's 2 x 4 stream grid, recorded from one eager frame
    scene = build_scene("phong1080", dev)
    set_angle(scene, ANGLES[0])
    cfg = dataclasses.replace(scene.config, comm_mode="stream")
    rounds, wrapper = [], kernels.stream_merge

    def spy(depth, winner, ps, ctx, recs, acc, *, slot0, first=False):
        rounds.append(((depth, winner, ps, ctx), recs, tuple(t.clone() for t in acc), slot0, first))
        return wrapper(depth, winner, ps, ctx, recs, acc, slot0=slot0, first=first)

    spy.launches = wrapper.launches  # the wrapper counts on its module's name
    kernels.stream_merge = spy
    try:
        render_frame_grid(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform,
                          cfg, 2, 4)
        torch.cuda.synchronize()
    finally:
        kernels.stream_merge = wrapper
        wrapper.launches = spy.launches
    check(len(rounds) == 16 and [r[4] for r in rounds] == [True, False] * 8,
          f"phong1080 2 x 4 stream grid: {len(rounds)} merges recorded (first: {[r[4] for r in rounds]}), not 16, "
          f"round 0 of each slab writing whole")
    h, w = rounds[0][2][0].shape
    n_ctx = rounds[0][0][3].shape[0]
    oks, work = [], []
    for i, (planes, recs, acc, slot0, first) in enumerate(rounds):
        got, ok = compare(f"grid round {i}", planes, recs, acc, slot0, first)
        oks.append(ok)
        depth, winner = planes[0][:h, :w], planes[1][:h, :w]
        covered = winner >= 0
        distinct = int(torch.unique(winner[covered]).numel())
        n = h * w
        if first:
            fills = (torch.zeros_like(acc[0]), torch.full_like(acc[1], ORDER_NONE), torch.full_like(acc[2], -1),
                     torch.zeros_like(acc[3]), torch.zeros_like(acc[4]))
            merged = run(planes, recs, fills, slot0, False, True)
            eq = all(bytes_equal(a, b) for a, b in zip(got.planes(), merged.planes()))
            check(eq, f"stream_merge grid round {i}: the first round's write differs from the merge into the fills")
            better = n
        else:
            local = torch.clamp(winner - slot0, 0, recs.shape[0] - 1).long()
            o = torch.where(covered, recs[:, ORDER][local], ORDER_NONE)
            better = int(((depth > acc[0]) | ((depth >= acc[0]) & (o > acc[1]))).sum())
        # depth and winner read a pixel, the accumulator's depth and order where it merges, each distinct
        # winner's order word; ps and the C varyings read and the five planes written where the round is
        # better (everywhere in round 0); ~12 operations a pixel
        nbytes = 8 * n + (0 if first else 8 * n) + 4 * distinct + better * ((4 + 4 * n_ctx) + (16 + 4 * n_ctx))
        work.append((nbytes, 12 * n, better, int(covered.sum()), distinct))
        log(f"  stream_merge grid round {i} (slab {i // 2}, owner {slot0 // recs.shape[0]}, first={first}): "
            f"byte-equal to stream_merge_plain on all five planes={ok}; {int(covered.sum())} covered, {better} "
            f"better, {distinct} winners" + (", equal to the merge into stream_start's fills" if first else ""))

    # crafted rounds at the slab's shape, merging and writing whole
    for seed, owner in enumerate((0, 1, 3)):
        acc, planes, recs, slot0, ties = crafted_merge_round(seed, h, w, n_ctx, 2048, owner, dev)
        for first in (False, True):
            _, ok = compare(f"crafted owner {owner} first={first}", planes, recs, acc, slot0, first)
            oks.append(ok)
        check(all(v > 100 for v in ties.values()), f"stream_merge crafted owner {owner}: too few ties {ties}")
        log(f"  stream_merge crafted round, owner {owner} (slot0 {slot0}), {h} x {w}, C = {n_ctx}: byte-equal to "
            f"stream_merge_plain merging and writing whole={oks[-2:]}; pixels {ties}")

    # device time a round: each launch on a fresh copy of the round's accumulator (a launch merges in place)
    def kernel_ms(i, reps=10):
        planes, recs, acc, slot0, first = rounds[i]
        pool = iter([tuple(t.clone() for t in acc) for _ in range(reps + 4)])  # device_ms calls reps + 4 times
        return device_ms(lambda: kernels.stream_merge(*planes, recs, next(pool), slot0=slot0, first=first), reps)

    def plain_ms(i):
        planes, recs, acc, slot0, first = rounds[i]
        out = sharding.StreamPlanes(*(t.clone() for t in acc))  # in place: the same work on every call
        return cuda_ms(lambda: plain(sharding.stream_merge_plain, out, *planes, recs[:, ORDER], slot0, first), 3)

    p_a = [plain_ms(i) for i in range(16)]
    k_a = [kernel_ms(i) for i in range(16)]
    k_b = [kernel_ms(i) for i in range(16)]
    p_b = [plain_ms(i) for i in range(16)]
    bounds = [bound_ms(nb, ops) for nb, ops, *_ in work]
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    k_ms, p_ms, b_ms = (mean(k_a) + mean(k_b)) / 2, (mean(p_a) + mean(p_b)) / 2, mean([b for b, _ in bounds])
    b_by = "bytes" if all(by == "bytes" for _, by in bounds) else "operations"
    nbytes = sum(nb for nb, *_ in work)
    rows["stream_merge"] = {
        "name": "stream_merge (the stream mode's per-round merge, XLA's fusion)", "route": "cuda",
        "source": "f_renderer_tpu_torch/csrc/stream_merge.cu",
        "replaces": "f_renderer_tpu/parallel/sharding.py:224-245 (no pallas_call: XLA's fusion of the stream "
                    "mode's per-round (rhw, order) merge)",
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "max_abs_err": worst[0], "ms_each": [mean(k_a), mean(k_b), mean(p_a), mean(p_b)],
        "ms_rounds": [(a + b) / 2 for a, b in zip(k_a, k_b)], "bound_ms_rounds": [b for b, _ in bounds],
        "frame_ms": sum(k_a) / 2 + sum(k_b) / 2, "frame_bound_ms": sum(b for b, _ in bounds),
        "frame_plain_ms": sum(p_a) / 2 + sum(p_b) / 2, "bytes_frame": nbytes,
        "better_rounds": [b for _, _, b, _, _ in work], "slab": [h, w], "n_ctx": n_ctx, "ptxas": lines,
        "library": "none: no one call merges five planes by (rhw, order)"}
    log(f"  phong1080 2 x 4 stream grid, 16 rounds of {h} x {w}, C = {n_ctx}: stream_merge_kernel {mean(k_a):.4f} / "
        f"{mean(k_b):.4f} ms a round (device, a round's mean), {k_ms * 16:.4f} ms a frame; plain {mean(p_a):.4f} / "
        f"{mean(p_b):.4f} ms a round; bound {b_ms:.5f} ms a round by {b_by} ({nbytes} B over the frame), share "
        f"{b_ms / k_ms:.3f}; round 0 {rows['stream_merge']['ms_rounds'][0]:.4f} ms (writes whole) against "
        f"{bounds[0][0]:.5f}, round 1 {rows['stream_merge']['ms_rounds'][1]:.4f} against {bounds[1][0]:.5f}; "
        f"library call: none (CUDA events; {smi})")
    del rounds


def shade_phase(dev, smi, rows):
    """3c. the builtin shading of K4's planes (csrc/shade_planes.cu: XLA's
    fusion of ``shade_from_planes`` over the builtin pixel shaders) against
    its plain version ``shade_planes_plain`` on the card, byte for byte, each
    frame one launch of the entry point ``shade.shade_from_planes``:
    phong1080_tex2048's K4 planes at the bench angles; the K4 planes of
    gouraud800, textured_wide and cube1080_flat (flat), so all four kinds;
    crafted planes: NaN and ±inf uv and normals, a zero normal, texture ids
    -1 and past the stack, every pixel background, three more varyings ahead
    of the builtin's, contiguous planes, the textured shader on phong's
    planes (uv at channel 6), and phong and textured on an opaque non-square
    stack past the routing limit (alpha from the taps, as the JAX package's
    XLA sampler takes it there). Its ``ptxas`` line (no stack frame or spills),
    occupancy, device time, entry point and plain times and bound at
    phong1080_tex2048's shapes; beside them the same shader untagged (the
    PyTorch ops and K3, as the path ran before the kernel). Then K3 at its
    main path's shapes: custom_tex1080's samples (phong1080's planes and
    512^2 stack), against its plain version, timed."""
    import re

    import numpy as np
    import torch

    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import raster, shade
    from f_renderer_tpu_torch.pipeline.render import build_triangles, context_codec
    from f_renderer_tpu_torch.shaders.api import ContextCodec
    from f_renderer_tpu_torch.shaders.builtin import LIGHT_COLOR, LIGHT_POS, make_textured_shaders, varying_offsets
    from f_renderer_tpu_torch.shaders.texture import TextureStack

    log("[kernel-vs-plain] shade_planes (the non-fused path's builtin shading, XLA's fusion)")
    lines = [line for line in kernels.ptxas_report() if line.startswith("shade_planes_kernel:")]
    for line in lines:
        log(f"  ptxas {line}")
    check(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in line for line in lines),
          f"shade_planes_kernel: a stack frame or spills ({lines})")
    used = [line for line in lines if "registers" in line]
    occ = None
    if check(len(used) == 1, f"shade_planes_kernel: no ptxas register line ({lines})"):
        regs = int(re.search(r"Used (\d+) registers", used[0]).group(1))
        smem = int(re.search(r"(\d+) bytes smem", used[0]).group(1)) if "smem" in used[0] else 0
        occ = occupancy(regs, smem, SHADE_THREADS)
        log(f"  occupancy shade_planes_kernel: {regs} registers, {smem} B shared memory, {SHADE_THREADS} threads: "
            f"{occ[0]} blocks an SM, {occ[1]:.2f} of its warps ({smi})")

    def planes(scene, angle):
        """K4's planes of ``scene`` at ``angle``, cropped to the frame (the
        views the non-fused path shades)."""
        set_angle(scene, angle)
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        prep = plain_prep(tri, scene.config, bin_k=scene.config.bin_k)
        _, winner, ps, ctx = raster.raster_planes(prep, True)
        h, w = prep.height, prep.width
        return ctx[:, :h, :w], ps[:h, :w], winner[:h, :w]

    worst = 0

    def compare(tag, ctx, ps, winner, pixel, uniform, codec, bg):
        nonlocal worst
        kind = pixel.fused_kind
        before = kernels.shade_planes.launches
        got = shade.shade_from_planes(ctx, ps, winner, pixel, uniform, codec, background=bg)
        launched = kernels.shade_planes.launches - before
        want = plain(shade.shade_planes_plain, ctx, ps, winner, kind, uniform, codec, background=bg,
                     light_pos=getattr(pixel, "light_pos", LIGHT_POS),
                     light_color=getattr(pixel, "light_color", LIGHT_COLOR))
        err = int((got.int() - want.int()).abs().max())
        worst = max(worst, err)
        equal = torch.equal(got, want)
        check(launched == 1 and equal, f"shade_planes {tag}: {launched} launches, frame equal to the plain "
                                       f"version's {equal} (max diff {err} u8)")
        log(f"  {tag}: {kind}, C={ctx.shape[0]} (varyings at {varying_offsets(kind, codec)}), strides "
            f"{ctx.stride()}: {launched} launch, frame byte-equal to the plain version's={equal} (max diff {err} u8), "
            f"covered px {int((winner >= 0).sum())}")

    tex = build_scene("phong1080_tex2048", dev)
    codec = context_codec(tex.vertex_shader, tex.vs_uniform, tex.draws[0])
    bg = tex.config.background
    for angle in ANGLES:
        ctx, ps, winner = planes(tex, angle)
        compare(f"phong1080_tex2048@{angle}", ctx, ps, winner, tex.pixel_shader, tex.ps_uniform, codec, bg)
    for name, angle in (("gouraud800", 0.1), ("textured_wide", 0.2), ("cube1080_flat", 0.1)):
        scene = build_scene(name, dev)
        s_ctx, s_ps, s_winner = planes(scene, angle)
        compare(f"{name}@{angle}", s_ctx, s_ps, s_winner, scene.pixel_shader, scene.ps_uniform,
                context_codec(scene.vertex_shader, scene.vs_uniform, scene.draws[0]), scene.config.background)
        del scene, s_ctx, s_ps, s_winner

    # crafted planes on phong1080_tex2048's at 0.10: rows of NaN, +inf and
    # -inf uv, then of normals, a band of zero normals; ids -1 and past the stack
    ctx, ps, winner = planes(tex, ANGLES[0])
    h, w = winner.shape
    special = torch.tensor([float("nan"), float("inf"), -float("inf")], device=dev)
    odd = ctx.clone()
    band = torch.arange(h, device=dev)
    odd[6:8, band < 120] = special[band[band < 120] % 3][None, :, None]
    odd[0:3, (band >= 120) & (band < 240)] = special[band[(band >= 120) & (band < 240)] % 3][None, :, None]
    odd[0:3, (band >= 240) & (band < 300)] = 0.0
    odd_ps = ps.clone()
    odd_ps[:, ::7] = -1
    odd_ps[:, 3::7] = tex.ps_uniform["textures"].t_count + 3
    crafted = [("NaN / inf uv and normals, zero normals (contiguous planes)", odd, ps, winner, codec),
               ("texture ids -1 and past the stack", ctx, odd_ps, winner, codec),
               ("every pixel background", ctx, ps, torch.full_like(winner, -1), codec)]
    aux = torch.rand((3, h, w), device=dev) * 10 - 5
    crafted.append(("three more varyings ahead of phong's (aux)", torch.cat([aux, ctx]), ps, winner,
                    ContextCodec((("aux", 3),) + codec.layout)))
    for tag, c_ctx, c_ps, c_winner, c_codec in crafted:
        compare(f"phong1080_tex2048@{ANGLES[0]} {tag}", c_ctx, c_ps, c_winner, tex.pixel_shader, tex.ps_uniform,
                c_codec, bg)
    textured = make_textured_shaders()[1]
    for tag, c_ctx, c_ps in (("", ctx, ps), (" on the crafted planes and ids", odd, odd_ps)):
        compare(f"phong1080_tex2048@{ANGLES[0]} the textured shader on phong's planes{tag}", c_ctx, c_ps, winner,
                textured, tex.ps_uniform, codec, bg)
    # an opaque non-square stack past the routing limit: the JAX package's
    # XLA sampler's route, alpha from the taps (TextureStack.sampler_opaque)
    rng = np.random.default_rng(5)
    wide = [rng.integers(0, 256, (h_t, w_t, 4), dtype=np.uint8)
            for h_t, w_t in ((2048, 1024), (512, 2048), (1024, 300))]
    for t in wide:
        t[..., 3] = 255
    wide_u = dict(tex.ps_uniform, textures=TextureStack.create(wide, device=dev))
    stack_w = wide_u["textures"]
    check(stack_w.opaque and not stack_w.sampler_opaque(ps),
          f"shade_planes: the opaque {stack_w.packed_nbytes}-byte stack takes the opaque shortcut past the limit")
    for pixel_w in (tex.pixel_shader, textured):
        compare(f"phong1080_tex2048@{ANGLES[0]} {pixel_w.fused_kind} on an opaque non-square stack past the limit "
                f"({stack_w.packed_nbytes} B)", ctx, ps, winner, pixel_w, wide_u, codec, bg)
    del odd, odd_ps, aux, crafted, wide, wide_u, stack_w

    # the time at the main path's shapes: phong1080_tex2048 at 0.10
    pixel, uniform, stack = tex.pixel_shader, tex.ps_uniform, tex.ps_uniform["textures"]

    def entry():
        return shade.shade_from_planes(ctx, ps, winner, pixel, uniform, codec, background=bg)

    launch = kernel_call("shade_planes", entry)
    k_ms, p_ms, w_ms, each = timed(entry, launch, lambda: shade.shade_planes_plain(
        ctx, ps, winner, "phong", uniform, codec, background=bg), 50, 3)

    def untagged(u, c, p):
        return pixel(u, c, p)

    torch_ms = [cuda_ms(lambda: shade.shade_from_planes(ctx, ps, winner, untagged, uniform, codec, background=bg), 5)
                for _ in range(2)]
    n = winner.numel()
    covered = winner >= 0
    n_cov = int(covered.sum())
    psm = torch.where(covered, ps, -1)
    texels = texel_bytes(stack, psm, ctx[6], ctx[7])
    # winner and output on every pixel; ps and the 8 channels phong reads on
    # covered pixels; the texels they sample once. ~90 operations of
    # lighting, ~60 of sampling and ~12 of packing a covered pixel, 2 a pixel
    nbytes = 8 * n + (4 + 4 * 8) * n_cov + texels
    ops = 162 * n_cov + 2 * n
    b_ms, b_by = bound_ms(nbytes, ops)
    rows["shade_planes"] = {
        "name": "shade_planes (the non-fused path's builtin shading, XLA's fusion)", "route": "cuda",
        "source": "f_renderer_tpu_torch/csrc/shade_planes.cu",
        "replaces": "f_renderer_tpu/pipeline/shade.py:80 (no pallas_call: XLA's fusion of shade_from_planes over the "
                    "builtin pixel shaders, shaders/builtin.py:67-163, with the sampler, shaders/texture.py:155)",
        "ms": k_ms, "ms_each": each[:2], "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "wrapper_ms": w_ms, "max_abs_err": worst, "bytes": nbytes, "texel_bytes": texels, "ops": ops,
        "covered": n_cov, "pixels": n, "torch_and_k3_ms": torch_ms, "ptxas": lines,
        "occupancy": None if occ is None else {"blocks": occ[0], "warps": occ[1]},
    }
    log(f"  phong1080_tex2048@{ANGLES[0]} shade_planes time ({n} pixels, {n_cov} covered): kernel {each[0]:.4f} / "
        f"{each[1]:.4f} ms (device), entry point {each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.3f} / "
        f"{each[3]:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {texels} of them texels; {ops} ops), share "
        f"{b_ms / k_ms:.3f}; the same shader untagged (PyTorch's ops and K3, as the path ran before the kernel) "
        f"{torch_ms[0]:.3f} / {torch_ms[1]:.3f} ms (CUDA events; {smi})")
    del tex, ctx, ps, winner

    # K3 where its main path now samples: custom_tex1080, a user's shader
    # on phong1080's planes (three 512^2 maps)
    scene = build_scene("custom_tex1080", dev)
    ctx, ps, winner = planes(scene, ANGLES[0])
    stack = scene.ps_uniform["textures"]
    psm = torch.where(winner >= 0, ps, -1).contiguous()
    u, v = ctx[6].contiguous(), ctx[7].contiguous()  # what TextureStack.sample hands the kernel
    s_k, s_p = stack.sample(psm, u, v), plain(stack.sample_plain, psm, u, v)
    s_err = float((s_k - s_p).abs().max())
    check(s_err <= SAMPLE_ATOL, f"custom_tex1080: K3 samples differ by {s_err}")
    launch = kernel_call("sample_bilinear", lambda: stack.sample(psm, u, v))
    k_ms, p_ms, w_ms, each = timed(lambda: stack.sample(psm, u, v), launch,
                                   lambda: stack.sample_plain(psm, u, v), 50, 3)
    n, n_tex = psm.numel(), int((psm >= 0).sum())
    nbytes = 28 * n + texel_bytes(stack, psm, u, v)
    b_ms, b_by = bound_ms(nbytes, 60 * n_tex + 2 * n)
    earlier = {f"tex2048_{k}": rows["K3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "wrapper_ms", "bytes",
                                                         "ops", "max_abs_err")}
    rows["K3"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, wrapper_ms=w_ms, bytes=nbytes,
                      ops=60 * n_tex + 2 * n, max_abs_err=max(s_err, rows["K3"]["max_abs_err"]), **earlier)
    log(f"  custom_tex1080@{ANGLES[0]} K3 ({n} samples, {n_tex} textured): max abs err {s_err:.3g}; kernel "
        f"{each[0]:.4f} / {each[1]:.4f} ms (device), wrapper {each[4]:.4f} / {each[5]:.4f} ms, plain {each[2]:.2f} / "
        f"{each[3]:.2f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B) (CUDA events; {smi})")


def pack_phase(dev, smi, rows):
    """3c'. the RGBA8 pack of a user pixel shader's colour
    (csrc/pack_rgba8.cu: XLA's fusion of the pack after the shader in the
    JAX package's non-fused shading) against its plain version
    ``shade._pack`` on the card, byte for byte, each one launch of the
    entry point ``shade.pack_frame``: the 1920 x 1080 colour that
    custom_tex1080's shader (``benchmark/shaders/phong_rs.py``, phong.rs's
    pixel shader as user code) gives on phong1080's K4 planes at the bench
    angles; that colour with crafted rows (NaN, +-inf, +-0.0, each side of
    every k/255, values past [0, 1]); as a strided view of wider planes; and
    with every pixel background; in the layouts other shaders give it (a
    column stride of 3; interleaved, the per-pixel ``vmap`` branch's
    (1, 4W, 4)); and as float64, which it packs as float32. Its ``ptxas``
    line (no stack frame or spills), occupancy, device time (with the L2
    flushed before each launch; and 50 launches back to back on one
    colour, the L2 warm), entry point and plain times, and its bound: the
    least bytes, the winner and the output once a pixel and the colour once
    a covered pixel (a background pixel reads no colour); beside it the
    bytes of every pixel's colour, winner and output."""
    import re

    import torch

    from benchmark.shaders import phong_rs
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import raster, shade
    from f_renderer_tpu_torch.pipeline.render import build_triangles, context_codec

    log("[kernel-vs-plain] pack_rgba8 (the RGBA8 pack of a user shader's colour, XLA's fusion)")
    lines = [line for line in kernels.ptxas_report() if line.startswith("pack_rgba8_kernel:")]
    for line in lines:
        log(f"  ptxas {line}")
    check(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in line for line in lines),
          f"pack_rgba8_kernel: a stack frame or spills ({lines})")
    used = [line for line in lines if "registers" in line]
    occ = None
    if check(len(used) == 1, f"pack_rgba8_kernel: no ptxas register line ({lines})"):
        regs = int(re.search(r"Used (\d+) registers", used[0]).group(1))
        occ = occupancy(regs, 0, SHADE_THREADS)
        log(f"  occupancy pack_rgba8_kernel: {regs} registers, {SHADE_THREADS} threads: {occ[0]} blocks an SM, "
            f"{occ[1]:.2f} of its warps ({smi})")

    scene = build_scene("phong1080", dev)
    codec = context_codec(scene.vertex_shader, scene.vs_uniform, scene.draws[0])
    bg = scene.config.background

    def colour(angle):
        """custom_tex1080's shader on K4's planes at ``angle`` → (colour, winner)."""
        set_angle(scene, angle)
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        prep = plain_prep(tri, scene.config, bin_k=scene.config.bin_k)
        _, winner, ps, ctx = raster.raster_planes(prep, True)
        h, w = prep.height, prep.width
        winner = winner[:h, :w]
        ps = torch.where(winner >= 0, ps[:h, :w], -1)
        return phong_rs.pixel(scene.ps_uniform, codec.unflatten(ctx[:, :h, :w]), ps), winner

    worst = 0

    def compare(tag, color, winner):
        nonlocal worst
        before = kernels.pack_rgba8.launches
        got = shade.pack_frame(color, winner, bg)
        launched = kernels.pack_rgba8.launches - before
        want = plain(shade._pack, color.to(torch.float32), winner, bg)
        err = int((got.int() - want.int()).abs().max())
        worst = max(worst, err)
        equal = torch.equal(got, want)
        check(launched == 1 and equal, f"pack_rgba8 {tag}: {launched} launches, frame equal to _pack's {equal} "
                                       f"(max diff {err} u8)")
        log(f"  {tag}: colour {tuple(color.shape)} strides {color.stride()}: {launched} launch, frame byte-equal to "
            f"_pack's={equal} (max diff {err} u8), covered px {int((winner >= 0).sum())}")

    for angle in ANGLES:
        color, winner = colour(angle)
        compare(f"custom_tex1080@{angle}", color, winner)
    color, winner = colour(ANGLES[0])
    h, w = winner.shape
    odd = color.clone()
    k = torch.arange(256, device=dev, dtype=torch.float32) / 255
    special = torch.cat([torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, -2.0, 1.5, 3e4],
                                      device=dev), k, torch.nextafter(k, torch.full_like(k, -1.0)),
                         torch.nextafter(k, torch.full_like(k, 2.0))])
    rows_odd = torch.arange(0, h, 3, device=dev)
    odd[:, rows_odd] = special[torch.arange(w, device=dev) % special.numel()][None, None, :]
    compare(f"custom_tex1080@{ANGLES[0]} crafted rows (NaN, +-inf, +-0.0, each side of k/255, past [0, 1])", odd,
            winner)
    wide = torch.full((6, h + 5, w + 64), float("nan"), device=dev)
    wide[1:5, 3:h + 3, 32:w + 32] = color
    compare(f"custom_tex1080@{ANGLES[0]} a strided view", wide[1:5, 3:h + 3, 32:w + 32], winner)
    compare(f"custom_tex1080@{ANGLES[0]} every pixel background", color, torch.full_like(winner, -1))
    compare(f"custom_tex1080@{ANGLES[0]} column stride 3", torch.repeat_interleave(color, 3, dim=2)[:, :, 1::3],
            winner)
    interleaved = color.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    compare(f"custom_tex1080@{ANGLES[0]} interleaved (the per-pixel shader's layout)", interleaved, winner)
    compare(f"custom_tex1080@{ANGLES[0]} float64", color.double(), winner)
    del odd, wide

    def entry():
        return shade.pack_frame(color, winner, bg)

    launch = kernel_call("pack_rgba8", entry)
    k_ms, p_ms, w_ms, each = timed(entry, launch, lambda: shade._pack(color, winner, bg), 50, 5)
    cold = [cold_device_ms(launch, 20) for _ in range(2)]
    cold_ms = sum(cold) / 2
    cold_interleaved = cold_device_ms(kernel_call("pack_rgba8", lambda: shade.pack_frame(interleaved, winner, bg)), 20)
    n, n_cov = winner.numel(), int((winner >= 0).sum())
    all_bytes = 16 * n + 4 * n + 4 * n  # the colour, the winner and the output, once each
    least_bytes = 8 * n + 16 * n_cov  # a background pixel reads no colour
    ops = 12 * n  # x 255, two clamps, the cast, three shifts and ors a channel
    b_ms, b_by = bound_ms(least_bytes, ops)
    a_ms, _ = bound_ms(all_bytes, ops)
    rows["pack_rgba8"] = {
        "name": "pack_rgba8 (the RGBA8 pack of a user shader's colour, XLA's fusion)", "route": "cuda",
        "source": "f_renderer_tpu_torch/csrc/pack_rgba8.cu",
        "replaces": "f_renderer_tpu/pipeline/shade.py:112 (no pallas_call: XLA's fusion of the pack with the user's "
                    "pixel shader in shade_from_planes)",
        "ms": cold_ms, "ms_each": cold, "warm_ms": k_ms, "warm_ms_each": each[:2], "interleaved_ms": cold_interleaved,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "all_pixels_bound_ms": a_ms, "library_ms": None,
        "wrapper_ms": w_ms, "max_abs_err": worst, "bytes": least_bytes, "all_pixels_bytes": all_bytes, "ops": ops,
        "covered": n_cov, "pixels": n, "ptxas": lines,
        "occupancy": None if occ is None else {"blocks": occ[0], "warps": occ[1]},
    }
    log(f"  custom_tex1080@{ANGLES[0]} pack_rgba8 time ({n} pixels, {n_cov} covered): kernel {cold[0]:.4f} / "
        f"{cold[1]:.4f} ms (device, L2 flushed), {each[0]:.4f} / {each[1]:.4f} ms (back to back, warm L2), "
        f"interleaved colour {cold_interleaved:.4f} ms (L2 flushed); entry point {each[4]:.4f} / {each[5]:.4f} ms, "
        f"plain (_pack) {each[2]:.4f} / {each[3]:.4f} ms; bound {b_ms:.4f} ms by {b_by} (least bytes, {least_bytes} "
        f"B), share {b_ms / cold_ms:.3f}; every pixel's colour {all_bytes} B, {a_ms:.4f} ms (CUDA events; {smi})")


def compact_phase(dev, smi, rows):
    """3c''. the compaction of K4's planes for a user's pixel shader
    (csrc/compact_planes.cu) against its plain version
    ``shade.compact_planes_plain``, bit for bit (count, rung, slot map, the
    rung's rows of the compact planes), one launch each: K4's planes of
    phong1080 at the bench angles (custom_tex1080's frames) and those
    planes with the winner cut or grown to land in every rung and the whole
    frame's; the pack's slot form against ``_pack``'s, byte for byte, on
    custom_tex1080's colour computed on the rung; and the frame of the
    compact path (``shade.shade_from_planes``: the compaction, the user's
    shader on the rung, the pack by slot) byte-equal to the user's shader
    on the whole frame packed by pixel. Its ``ptxas`` line (no stack frame
    or spills), occupancy, device time (L2 flushed before each launch, and
    back to back), its bound: the least bytes (the winner and the slot map
    a pixel, a covered pixel's texture id and C varyings read, the rung's
    slots written); the pack's slot form and the shading (the user's ops
    and K3) on the rung against the whole frame, CUDA events."""
    import re

    import torch

    from benchmark.shaders import phong_rs
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import raster, shade
    from f_renderer_tpu_torch.pipeline.render import build_triangles, context_codec

    log("[kernel-vs-plain] compact_planes (a user shader's covered pixels compacted, the frame's rung)")
    lines = [line for line in kernels.ptxas_report() if line.startswith("compact_planes_kernel:")]
    for line in lines:
        log(f"  ptxas {line}")
    check(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in line for line in lines),
          f"compact_planes_kernel: a stack frame or spills ({lines})")
    used = [line for line in lines if "registers" in line]
    occ = None
    if check(len(used) == 1, f"compact_planes_kernel: no ptxas register line ({lines})"):
        regs = int(re.search(r"Used (\d+) registers", used[0]).group(1))
        occ = occupancy(regs, 0, COMPACT_THREADS)
        log(f"  occupancy compact_planes_kernel: {regs} registers, {COMPACT_THREADS} threads: {occ[0]} blocks an "
            f"SM, {occ[1]:.2f} of its warps ({smi})")

    scene = build_scene("phong1080", dev)
    codec = context_codec(scene.vertex_shader, scene.vs_uniform, scene.draws[0])
    bg = scene.config.background

    def planes(angle):
        """K4's cropped planes of phong1080 at ``angle`` → (ctx, ps, winner)."""
        set_angle(scene, angle)
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        prep = plain_prep(tri, scene.config, bin_k=scene.config.bin_k)
        _, winner, ps, ctx = raster.raster_planes(prep, True)
        h, w = prep.height, prep.width
        return ctx[:, :h, :w], ps[:h, :w], winner[:h, :w]

    def with_count(winner, count):
        """``winner`` with ``count`` covered pixels: its first ones in raster
        order, or all and its first background pixels taken as covered."""
        cov = (winner >= 0).reshape(-1)
        extra = count - int(cov.sum())
        keep = cov & (torch.cumsum(cov, 0) <= count)
        add = ~cov & (torch.cumsum(~cov, 0) <= extra)
        return torch.where(keep, winner.reshape(-1), torch.where(add, 0, -1)).reshape(winner.shape).to(torch.int32)

    def compare(tag, ctx, ps, winner):
        before = kernels.compact_planes.launches
        got = shade.compact_planes(ctx, ps, winner)
        launched = kernels.compact_planes.launches - before
        want = plain(shade.compact_planes_plain, ctx, ps, winner)
        k = int(want.rung)
        ok = int(got.count) == int(want.count) and int(got.rung) == k and torch.equal(got.slots, want.slots)
        if k < shade.WHOLE:
            r = shade.rung_rows(winner.shape[0])[k]
            ok = ok and torch.equal(got.ps[:r], want.ps[:r]) and torch.equal(
                got.ctx[:, :r].view(torch.int32), want.ctx[:, :r].view(torch.int32))
        check(launched == 1 and ok, f"compact_planes {tag}: {launched} launches, equal to the plain version's {ok}")
        name = "the whole frame" if k == shade.WHOLE else f"{shade.RUNGS[k]}/8"
        log(f"  {tag}: {int(want.count)} covered of {winner.numel()}, rung {k} ({name}), {launched} launch, count, "
            f"rung, slots and the rung's compact rows equal to the plain version's={ok}")
        return got

    for angle in ANGLES:
        compare(f"phong1080@{angle}", *planes(angle))
    ctx, ps, winner = planes(ANGLES[0])
    h, w = winner.shape
    caps = [0] + [r * w for r in shade.rung_rows(h)] + [h * w]
    seen = set()
    for k in range(shade.WHOLE + 1):
        for count in (caps[k] + (k > 0), caps[k + 1]):
            seen.add(int(compare(f"phong1080@{ANGLES[0]} cut or grown to {count} covered", ctx, ps,
                                 with_count(winner, count)).rung))
    check(seen == set(range(shade.WHOLE + 1)), f"compact_planes: the crafted frames reached rungs {sorted(seen)}")

    # the pack's slot form and the compact path's frame, custom_tex1080's shader
    comp = shade.compact_planes(ctx, ps, winner)
    k = int(comp.rung)
    r = shade.rung_rows(h)[k]
    color = phong_rs.pixel(scene.ps_uniform, codec.unflatten(comp.ctx[:, :r]), comp.ps[:r])
    before = kernels.pack_rgba8.launches
    got = shade.pack_frame(color, winner, bg, slots=comp.slots)
    want = plain(shade._pack, color, winner, bg, slots=comp.slots)
    equal = torch.equal(got, want)
    check(kernels.pack_rgba8.launches == before + 1 and equal, f"pack_rgba8 by slot: equal to _pack's {equal}")
    whole_ps = torch.where(winner >= 0, ps, -1)
    whole = shade.pack_frame(phong_rs.pixel(scene.ps_uniform, codec.unflatten(ctx), whole_ps), winner, bg)
    frame = shade.shade_from_planes(ctx, ps, winner, phong_rs.pixel, scene.ps_uniform, codec, background=bg)
    same_frame = torch.equal(frame, whole) and torch.equal(got, whole)
    check(same_frame, f"custom_tex1080@{ANGLES[0]}: the compact path's frame differs from the whole frame's "
                      f"({int((frame != whole).any(-1).sum())} pixels)")
    log(f"  custom_tex1080@{ANGLES[0]}: rung {k} ({r} rows), the pack by slot byte-equal to _pack's={equal}; the "
        f"compact path's frame byte-equal to the shader on the whole frame packed by pixel={same_frame}")

    entry = kernel_call("compact_planes", lambda: shade.compact_planes(ctx, ps, winner))
    k_ms, p_ms, w_ms, each = timed(lambda: shade.compact_planes(ctx, ps, winner), entry,
                                   lambda: shade.compact_planes_plain(ctx, ps, winner), 50, 5)
    cold = [cold_device_ms(entry, 20) for _ in range(2)]
    cold_ms = sum(cold) / 2
    n, n_cov, c = winner.numel(), int(comp.count), ctx.shape[0]
    nbytes = 8 * n + 4 * (c + 1) * n_cov + 4 * (c + 1) * r * w  # winner, slots; covered read; the rung written
    ops = 8 * n
    b_ms, b_by = bound_ms(nbytes, ops)
    # the kernel split by its inputs: the whole frame's rung (every rung 0
    # rows: the counts, the barrier and the slot map), no varyings (the
    # texture ids copied), a 1 x 1 frame (the launch and the grid's barrier)
    forms = {"slot_map_alone": (ctx, ps, winner, (0,) * shade.WHOLE), "no_varyings": (ctx[:0], ps, winner, None),
             "one_pixel": (ctx[:, :1, :1], ps[:1, :1], winner[:1, :1], (1,) * shade.WHOLE)}
    split_ms = {}
    for name, (c_, p_, w_, rows_) in forms.items():
        rows_ = shade.rung_rows(h) if rows_ is None else rows_
        split_ms[name] = cold_device_ms(
            lambda c_=c_, p_=p_, w_=w_, r_=rows_: kernels.compact_planes(c_, p_, w_, r_), 20)
    pack = kernel_call("pack_rgba8", lambda: shade.pack_frame(color, winner, bg, slots=comp.slots))
    pack_cold = cold_device_ms(pack, 20)
    whole_color = lambda: phong_rs.pixel(scene.ps_uniform, codec.unflatten(ctx), whole_ps)  # noqa: E731
    rung_color = lambda: phong_rs.pixel(scene.ps_uniform, codec.unflatten(comp.ctx[:, :r]), comp.ps[:r])  # noqa: E731
    rung_color(), whole_color()
    shading = {"rung_ms": [cuda_ms(rung_color, 20) for _ in range(2)],
               "whole_ms": [cuda_ms(whole_color, 20) for _ in range(2)]}
    path_ms = [cuda_ms(lambda: shade.shade_from_planes(ctx, ps, winner, phong_rs.pixel, scene.ps_uniform, codec,
                                                       background=bg), 20) for _ in range(2)]
    rows["compact_planes"] = {
        "name": "compact_planes (a user shader's covered pixels compacted, the frame's rung)", "route": "cuda",
        "source": "f_renderer_tpu_torch/csrc/compact_planes.cu",
        "replaces": "none: the JAX package shades the whole frame (f_renderer_tpu/pipeline/shade.py:80-)",
        "ms": cold_ms, "ms_each": cold, "warm_ms": k_ms, "warm_ms_each": each[:2], "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "wrapper_ms": w_ms, "bytes": nbytes, "ops": ops,
        "covered": n_cov, "pixels": n, "rung": k, "rung_rows": r, "ptxas": lines, "split_ms": split_ms,
        "pack_by_slot_ms": pack_cold, "shader_on_rung_ms": shading["rung_ms"],
        "shader_on_whole_ms": shading["whole_ms"], "compact_path_ms": path_ms,
        "occupancy": None if occ is None else {"blocks": occ[0], "warps": occ[1]},
    }
    log(f"  custom_tex1080@{ANGLES[0]} compact_planes time ({n} pixels, {n_cov} covered, rung {k}): kernel "
        f"{cold[0]:.4f} / {cold[1]:.4f} ms (device, L2 flushed), {each[0]:.4f} / {each[1]:.4f} ms (back to back); "
        f"plain {each[2]:.4f} / {each[3]:.4f} ms; bound {b_ms:.4f} ms by {b_by} ({nbytes} B), share "
        f"{b_ms / cold_ms:.3f}; the pack by slot {pack_cold:.4f} ms (L2 flushed); the user's shader on the rung "
        f"{shading['rung_ms'][0]:.4f} / {shading['rung_ms'][1]:.4f} ms, on the whole frame "
        f"{shading['whole_ms'][0]:.4f} / {shading['whole_ms'][1]:.4f} ms; the compact path (compaction, shader, "
        f"pack; eager, host included) {path_ms[0]:.4f} / {path_ms[1]:.4f} ms (CUDA events; {smi})")
    log(f"  compact_planes split (L2 flushed): the slot map alone (the whole frame's rung) "
        f"{split_ms['slot_map_alone']:.4f} ms, with the texture ids {split_ms['no_varyings']:.4f} ms, a 1 x 1 frame "
        f"{split_ms['one_pixel']:.4f} ms ({smi})")


def demos_phase(dev, smi):
    """4c. the three demos (``f_renderer_tpu_torch/demos``) at their default
    sizes on the card, as a user starts them. Each runs ``DEMO_FRAMES``
    frames into a NullDisplay that keeps a checksum of each frame it is
    shown (the interactive demo from the ``DEMO_KEYS`` script, a frame a
    key), and the checksums must equal those of the entry point's frames at
    the same cameras: ``render_voxel_frame`` (the grids as inputs) for the
    voxel demo's ``VoxelRenderer``, the eager ``render_frame`` for the two
    phong demos' ``Scene.render()``, whose graph frames must also equal it.
    Then each runs once from its command line, in a process of its own, into
    a PNG directory under a temporary path (the interactive demo: its
    ``--out`` frame), and the PNGs must equal the entry point's frames byte
    for byte. Printed: the demo's avg frame ms and fps (its first frame,
    which captures, included, as the JAX demos count it), its loop's ms a
    frame after the first, and the loop's parts alone, on the host's clock
    with the card synchronized after each part's frames: the camera, the
    entry point's frames on the same cameras (render-only, the graph warm)
    and the Present layer's staging of each frame to pinned host memory
    (``display._Staged``); the rest is the loop's own host work."""
    import numpy as np
    import torch
    from PIL import Image

    from f_renderer_tpu_torch.demos import frame_size, interactive, phong
    from f_renderer_tpu_torch.demos import voxel as voxel_demo
    from f_renderer_tpu_torch.display import FrameEvent, NullDisplay, _Staged
    from f_renderer_tpu_torch.pipeline.render import render_frame
    from f_renderer_tpu_torch.voxel import octree, raycast

    class Checksums(NullDisplay):
        """A NullDisplay that keeps a checksum of each frame it is shown."""

        def __init__(self):
            self.sums = []

        def present(self, frame):
            self.sums.append(int(np.asarray(frame)[::97, ::89, :3].astype(np.int64).sum()))

    def sums(frames):
        return [int(f[::97, ::89, :3].long().sum()) for f in frames]

    def host_ms(fn, n):
        """ms a frame of ``fn()``, which makes ``n`` frames' part, on the host's clock, the card synchronized."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def eager(scene, camera, view_pos):
        vs_u = dict(scene.vs_uniform, view=camera.look_at())
        ps_u = dict(scene.ps_uniform, view_pos=camera.eye) if view_pos else scene.ps_uniform
        return render_frame(list(scene.draws), scene.vertex_shader, vs_u, scene.pixel_shader, ps_u, scene.config)[0]

    def command_line(name, argv, want, out):
        """The demo from its command line → its PNGs equal to ``want``, and its closing line."""
        root = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run([sys.executable, "-m", f"f_renderer_tpu_torch.demos.{name}", *argv], cwd=root,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"demo {name} from its command line exited {proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
        paths = sorted(os.path.join(out, f) for f in os.listdir(out)) if os.path.isdir(out) else [out]
        pngs = [np.asarray(Image.open(p)) for p in paths if os.path.exists(p)]
        equal = len(pngs) == len(want) and all(np.array_equal(p, w.cpu().numpy()) for p, w in zip(pngs, want))
        check(equal, f"demo {name}: {len(pngs)} PNGs from its command line, not {len(want)} equal to the entry "
                     f"point's frames")
        closing = [line for line in proc.stderr.splitlines() if line.startswith(("avg frame", "saved"))]
        return equal, closing

    def report(name, times, shown, want, camera_ms, render_ms, png_equal, closing):
        equal = shown.sums == sums(want)
        check(equal and times.frames == len(want), f"demo {name}: {times.frames} frames, checksums {shown.sums} "
                                                   f"against the entry point's {sums(want)}")
        staging_ms = host_ms(lambda: [_Staged(f).result() for f in want], len(want))
        rest = times.steady_ms - camera_ms - render_ms - staging_ms
        log(f"[demo] {name}: {times.frames} frames into a NullDisplay, avg frame {times.frame_ms:.3f} ms "
            f"({times.fps:.1f} fps; the first frame and its capture included), the loop {times.steady_ms:.3f} ms "
            f"a frame after the first; alone, a frame: the camera {camera_ms:.3f} ms, render-only {render_ms:.3f} "
            f"ms (the entry point on the same cameras), the Present layer's staging {staging_ms:.3f} ms, the rest "
            f"{rest:.3f} ms (host clock); checksums equal the entry point's={equal}, the command line's PNGs "
            f"byte-equal to its frames={png_equal}; its closing line {closing} ({smi})")

    with tempfile.TemporaryDirectory() as tmp:
        # voxel: the orbit of a level-3 octree at 960x540, one VoxelRenderer
        args = voxel_demo.parse_args(["--frames", str(DEMO_FRAMES)])
        shown = Checksums()
        times = voxel_demo.run(args, shown)
        w, h = frame_size(args.size)
        angles = [0.0]
        while len(angles) < DEMO_FRAMES:
            angles.append(angles[-1] + voxel_demo.ANGLE_STEP)
        views = [voxel_demo.orbit_view(a, w, h) for a in angles]
        camera_ms = host_ms(lambda: [voxel_demo.orbit_view(a, w, h) for a in angles], len(angles))
        color, hit = octree.densify(octree.gen_randomly(args.level, np.random.default_rng(args.seed)), args.level)
        cfg = raycast.VoxelRenderConfig(width=w, height=h, level=args.level, length=voxel_demo.LENGTH)
        want = [raycast.render_voxel_frame(color, hit, *v, cfg, device=dev) for v in views]
        renderer = voxel_demo.make_renderer(args)
        renderer(*views[0])  # its capture
        render_ms = host_ms(lambda: [renderer(*v) for v in views], len(views))
        out = os.path.join(tmp, "voxel")
        png_equal, closing = command_line("voxel", ["--frames", "3", "--out", out], want[:3], out)
        report("voxel (python -m f_renderer_tpu_torch.demos.voxel)", times, shown, want, camera_ms, render_ms,
               png_equal, closing)

        # phong: three meshes at 960x540, Scene.render() a frame
        args = phong.parse_args(["--frames", str(DEMO_FRAMES)])
        shown = Checksums()
        times = phong.run(args, shown)
        scene = phong.build_scene(args)
        def orbit():
            cams, camera = [], phong.start_camera(dev)
            for _ in range(DEMO_FRAMES):
                camera = phong.next_camera(camera)
                cams.append(camera)
            return cams

        cams = orbit()
        camera_ms = host_ms(orbit, DEMO_FRAMES)
        want = [eager(scene, c, view_pos=True) for c in cams]
        graph = [phong.frame_at(scene, c) for c in cams]
        check(all(torch.equal(g, e) for g, e in zip(graph, want)), "demo phong: Scene.render() differs from the "
                                                                   "eager frames")
        render_ms = host_ms(lambda: [phong.frame_at(scene, c) for c in cams], len(cams))
        out = os.path.join(tmp, "phong")
        png_equal, closing = command_line("phong", ["--frames", "3", "--out", out], want[:3], out)
        report("phong (python -m f_renderer_tpu_torch.demos.phong)", times, shown, want, camera_ms, render_ms,
               png_equal, closing)

        # interactive: the phong scene at 480x270 from a key script
        args = interactive.parse_args(["--keys", DEMO_KEYS])
        shown = Checksums()
        times = interactive.run(args, shown)
        scene = interactive.build_scene(args)

        def steer():
            controls, cams, camera = interactive.Controls(), [], interactive.start_camera(dev)
            for i, ch in enumerate(DEMO_KEYS):
                camera, _ = controls(camera, FrameEvent(index=i, time=0.0, dt=0.0, keys=ch))
                cams.append(camera)
            return cams

        cams = steer()
        camera_ms = host_ms(steer, len(DEMO_KEYS))
        want = [eager(scene, c, view_pos=False) for c in cams]
        graph = [interactive.frame_at(scene, c) for c in cams]
        check(all(torch.equal(g, e) for g, e in zip(graph, want)), "demo interactive: Scene.render() differs from "
                                                                   "the eager frames")
        render_ms = host_ms(lambda: [interactive.frame_at(scene, c) for c in cams], len(cams))
        out = os.path.join(tmp, "interactive.png")
        png_equal, closing = command_line("interactive", ["--keys", DEMO_KEYS[:4], "--out", out], want[3:4], out)
        report("interactive (python -m f_renderer_tpu_torch.demos.interactive)", times, shown, want, camera_ms,
               render_ms, png_equal, closing)


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
        from f_renderer_tpu_torch.shaders.builtin import VERTEX_KINDS, make_textured_shaders, shade_plain
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

    # 3b. K4 against plain, both entry points; K3 on the same planes
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
            if scene_name in ("sliver640", "phong_bin_k1"):  # planes only: 3c holds the shading to its plain version
                continue
            if scene_name != "phong1080_tex2048":
                frame_k = shade.shade_from_planes(ctx_k, ps_k, winner_k, scene.pixel_shader,
                                                  scene.ps_uniform, codec, background=bg)
                frame_p = plain(shade.shade_from_planes, ctx_p, ps_p, winner_p, scene.pixel_shader,
                                scene.ps_uniform, codec, background=bg, launch=False)
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
            # K3 on phong1080_tex2048's samples (its main path until the shading
            # kernel; 3c times it on custom_tex1080's): the texture id where a pair won, uv.
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
                            scene.ps_uniform, codec, background=bg, launch=False)
            f_err = frame_bar(f"{tag} frame", frame_k, frame_p)[0]
            worst_frame4 = max(worst_frame4, f_err)
            log(f"  {tag}: K3 max abs err {s_err:.3g}, frame (K4 + shade_planes) max diff {f_err} u8")
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

    # 3c. the builtin shading of K4's planes against plain; K3 at custom_tex1080
    log(f"[time] {time.time() - t_start:.1f} s")
    shade_phase(dev, smi, rows)
    log(f"[time] {time.time() - t_start:.1f} s")
    pack_phase(dev, smi, rows)
    compact_phase(dev, smi, rows)

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
    import re

    used = [line for line in setup_lines if "registers" in line]
    if check(len(used) == 1, f"voxel_setup_kernel: no ptxas register line ({setup_lines})"):
        regs = int(re.search(r"Used (\d+) registers", used[0]).group(1))
        smem = int(re.search(r"(\d+) bytes smem", used[0]).group(1)) if "smem" in used[0] else 0
        blocks, share = occupancy(regs, smem, VOXEL_SETUP_THREADS)
        log(f"  occupancy voxel_setup_kernel: {regs} registers, {smem} B shared memory, "
            f"{VOXEL_SETUP_THREADS} threads: {blocks} blocks an SM, {share:.2f} of its warps ({smi})")
    base_cfg = raycast.VoxelRenderConfig(width=VOXEL_W, height=VOXEL_H, level=VOXEL_LEVEL, length=VOXEL_LENGTH)
    cases = [(f"orbit {i}", *voxel_view(i), base_cfg) for i in range(FRAMES)]
    cases += [(view, eye, inv, base_cfg) for view, eye, inv in setup_views()]
    cases.append(("orbit 0 at length 3.0", *voxel_view(0, 3.0), dataclasses.replace(base_cfg, length=3.0)))
    worst_setup = 0.0
    eight_slot = {}  # view → (rays, warps of 32 pixels of a row) the eight-slot path takes
    for view, eye, inv_mvp, cfg in cases:
        eye, inv_mvp = torch.from_numpy(eye).to(dev), torch.from_numpy(inv_mvp).to(dev)
        got = raycast.prepare_rays(eye, inv_mvp, cfg)
        want = plain(raycast.prepare_rays_plain, eye, inv_mvp, cfg)
        eight = plain(raycast.eight_slot_rays, eye, inv_mvp, cfg)
        w32 = cfg.width - cfg.width % 32
        eight_slot[view] = (int(eight.sum()), int(eight[:, :w32].reshape(cfg.height, -1, 32).any(-1).sum()))
        ok, err = planes_equal(got, want)
        worst_setup = max(worst_setup, err)
        k = raycast.march_constants(cfg, grid_hit.shape[0])
        frame_k, frame_p = raycast.march(*got, table, k), raycast.march(*want, table, k)
        check(ok, f"voxel_setup {view}: the planes differ from the plain version's (max abs err {err})")
        check(torch.equal(frame_k, frame_p), f"voxel_setup {view}: the marched frames differ at "
              f"{int((frame_k != frame_p).sum())} rays")
        log(f"  voxel_setup {view} (length {cfg.length}): eight planes bit-equal={ok}, alive share "
            f"{float(got[3].float().mean()):.4f}, NaN t_max {int(torch.isnan(got[2]).sum())}, frames marched "
            f"from them equal={torch.equal(frame_k, frame_p)}; the eight-slot path: {eight_slot[view][0]} of "
            f"{cfg.width * cfg.height} rays, {eight_slot[view][1]} of {cfg.height * (cfg.width // 32)} warps")
    eye0, inv0 = (torch.from_numpy(a).to(dev) for a in voxel_view(0))
    launch = kernel_call("voxel_setup", lambda: raycast.prepare_rays(eye0, inv0, base_cfg))
    k_ms, p_ms, w_ms, each = timed(lambda: raycast.prepare_rays(eye0, inv0, base_cfg), launch,
                                   lambda: raycast.prepare_rays_plain(eye0, inv0, base_cfg), 20)
    n = VOXEL_W * VOXEL_H
    # inputs read once (eye, inv_mvp), seven f32 planes and one bool plane
    # written; ~340 float32 operations a ray on the two-slot pass, ~1,000
    # more a ray on the eight-slot path (the kernel's note counts them)
    nbytes, ops = 12 + 64 + 29 * n, 340 * n + 1000 * eight_slot["orbit 0"][0]
    b_ms, b_by = bound_ms(nbytes, ops)
    rows["setup"] = {
        "name": "voxel_setup (the voxel ray set-up, XLA's fusion)", "route": "cuda",
        "source": "f_renderer_tpu_torch/csrc/voxel_setup.cu",
        "replaces": "f_renderer_tpu/voxel/raycast.py:34 (no pallas_call: XLA's fusion of raycast.py:34-264, "
                    "fenced at raycast_pallas.py:310)",
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "wrapper_ms": w_ms, "max_abs_err": worst_setup, "bytes": nbytes, "ops": ops, "ptxas": setup_lines,
        "kernels": ["voxel_setup_kernel"], "eight_slot_rays_warps": eight_slot,
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
        dead = torch.zeros_like(rays0[3])
        row["ms_no_rays"] = device_ms(lambda: launch(*rays0[:3], dead), 10)
        log(f"  voxel540 {traversal} K5 with every ray dead: {row['ms_no_rays']:.4f} ms (device)")
        n = rays0[2].numel()
        # per ray: 7 f32 input planes, the alive byte, 1 output; the table, times and hit bits;
        # ~25 operations a query
        nbytes = 33 * n + 4 * table.numel() + 4 * k.n_times + table.numel() // 8
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
            b2_ms, b2_by = bound_ms(33 * n + 4 * table.numel(), 25 * row["queries_serial"] + 5 * n)
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
    shard_phase(dev, smi, rows)
    stream_phase(dev, smi, rows)

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
        recs, bbox, n, c, _ = build_packed(*args)
        fused_ok = fused.fused_path_ok(scene.pixel_shader, scene.ps_uniform)
        bins = (recs, bbox, n, c, cfg.width, cfg.height, cfg.tile)
        kw = bin_settings(cfg, fused_ok)
        parts = [("set-up (the tri_setup kernels, a builtin's vertex stage in launch 1, the clip path: "
                  "build_packed)",
                  lambda: build_packed(*args)),
                 ("its plain version (build_triangles + pack_binned + slot_records)",
                  lambda: build_packed_plain(*args)),
                 ("bin (the bin_pairs kernels: bin_packed)", lambda: raster.bin_packed(*bins, **kw)),
                 ("its plain version (bin_packed_plain)", lambda: raster.bin_packed_plain(*bins, **kw))]
        prep = raster.bin_packed(*bins, **kw)
        kind = getattr(scene.pixel_shader, "fused_kind", None)
        if kind is not None and fused_ok:
            parts += [("K1", lambda: fused.render_fused_prepared(prep, scene.pixel_shader, scene.ps_uniform, cfg))]
        else:
            codec = context_codec(scene.vertex_shader, scene.vs_uniform, scene.draws[0])
            depth, winner, ps, ctx = (t[..., :cfg.height, :cfg.width] for t in raster.raster_planes(prep, True))
            parts += [("K4", lambda: raster.raster_planes(prep, True)),
                      ("shade (the shade_planes kernel)" if kind else "shade (the user's shader: PyTorch, K3)",
                       lambda: shade.shade_from_planes(ctx, ps, winner, scene.pixel_shader, scene.ps_uniform, codec,
                                                       background=cfg.background))]
            if kind:
                parts += [("its plain version (shade_planes_plain)", lambda: shade.shade_planes_plain(
                    ctx, ps, winner, kind, scene.ps_uniform, codec, background=cfg.background))]
        stages(path, parts)

    zero = dict.fromkeys(counts(), 0)
    launches = {}
    compiled.CACHE.debug = True  # each graph keeps its nodes until graph_summary() reads them

    counted = []  # the graph paths' main-path runs, made after every timing (4b)
    split_frames = {}  # path → (its GraphFrame, its replay ms, a call that loads the bench camera's frame)
    split_flip = {}  # phong1080's scene, whose graph 4b replays once with a face clipped

    graph_times = {}  # path → its graph's times, input bytes and nodes, as graph_path logged them

    def graph_path(path, entry, eager, frames, expect, shape, keys, geometries=0, max_nodes=None, own_nodes=None,
                   own_names=None, in_rungs=()):
        """A main path through its entry point, whose frames replay one
        captured graph (``entry(i)``: frame i), beside its first
        ``EAGER_FRAMES`` frames run eagerly (``eager(i)``): the first call
        captures; the graph's kernel nodes equal the launches of one eager
        frame; the replays are timed; the eager frames are bit-equal to the
        graph's; a replay into sentinel-filled static outputs overwrites
        them; then the input copy, the replay and the output clone are timed
        alone. The graph must hold one conditional node (the clip path) for
        each of its ``geometries`` (a frame's set-up kernels, or each face
        shard's in the sharded frame and the grids), and fewer than
        ``max_nodes`` nodes where that is given, ``own_nodes`` where
        that is given, and the nodes ``own_names`` names (each a port
        kernel's function) where that is given. A user's pixel shader
        (``in_rungs``: the wrappers its frame launches inside each rung's
        body) adds a conditional node a rung of the ladder and the whole
        frame's (``shade.WHOLE + 1``), those wrappers' nodes once in each
        body. The counted run of its first frames as replays (launches from
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
        nodes, conds, own, in_bodies, names = graph_summary(frame)
        per_frame = {k: n // frames for k, n in expect.items()}
        bodies = shade.WHOLE + 1 if in_rungs else 0
        in_graph = {k: n * bodies if k in in_rungs else n for k, n in per_frame.items()}
        check(nodes == in_graph, f"{path}: the graph holds kernel nodes {nodes}, not {in_graph} (one frame launches "
                                 f"{per_frame}, {bodies} rungs' bodies)")
        check(conds == geometries + bodies, f"{path}: the graph holds {conds} conditional nodes, not one for each "
                                            f"of its {geometries} geometries and {bodies} rungs")
        if max_nodes is not None:
            check(own < max_nodes, f"{path}: the graph holds {own} nodes, not fewer than {max_nodes}")
            log(f"[graph] {path}: {own} nodes (fewer than {max_nodes}: {own < max_nodes})")
        if own_nodes is not None:
            check(own == own_nodes, f"{path}: the graph holds {own} nodes, not {own_nodes}")
            log(f"[graph] {path}: {own} nodes, {own_nodes} expected")
        if own_names is not None:
            check(names == sorted(own_names), f"{path}: the graph's nodes are {names}, not {sorted(own_names)}")
            log(f"[graph] {path}: its {own} nodes {names}, {len(own_names)} expected")

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
        log(f"[graph] {path}: warm-up and capture {frame.capture_ms:.1f} ms (first call {first_ms:.1f} ms), "
            f"pool {frame.graph.pool_bytes} B, graph frame {graph_ms:.3f} ms (host "
            f"{graph_host_ms:.3f} ms) over {frames} frames, eager frame {eager_ms:.3f} ms (host {eager_host_ms:.3f} "
            f"ms) over the first {n_eager}, each bit-equal to its graph frame; alone: input copy {copy_ms:.4f} ms "
            f"({in_bytes} B), replay {replay_ms:.3f} ms, output clone {clone_ms:.4f} ms ({out_bytes} B); "
            f"kernel nodes {nodes}; {own} nodes, {conds} of them conditional (a geometry's clip path each), "
            f"{in_bodies} nodes in their bodies (CUDA events; {smi})")
        counted.append((path, entry, frames, expect, shape, outs, keys))
        split_frames[path] = (frame, replay_ms, lambda: entry(0))
        graph_times[path] = dict(graph_ms=graph_ms, graph_host_ms=graph_host_ms, copy_ms=copy_ms, replay_ms=replay_ms,
                                 clone_ms=clone_ms, in_bytes=in_bytes, in_leaves=len(frame.inputs), nodes=own)
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
                      {"K1": "fused_raster", "tri_setup": "tri_setup", "bin_pairs": "bin_pairs"}, geometries=1,
                      max_nodes=PHONG_GRAPH_NODES)
    clipped_at_bench = {"phong1080 Scene.render()": clipped_per_draw(scene, ANGLES[0])}
    split_flip["phong1080 Scene.render()"] = scene
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
    prep_nodes, prep_conds, prep_own, prep_in_bodies, _ = graph_summary(prep_graph)
    ok = (compiled.CACHE.captures == before + 1 and same(prepared, want_prep) and same(replayed, want_prep)
          and all(torch.equal(a, b) for a, b in zip(prep_graph.outputs, compiled.flatten(want_prep)[0])))
    check(ok and prep_nodes == dict(zero, tri_setup=1, bin_pairs=1) and prep_conds == 1,
          f"phong1080 prepare: graph prep equal to eager {ok}, kernel nodes {prep_nodes}, conditional nodes {prep_conds}")

    def prepare_eager():
        packed = build_packed(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        return fused.prep_packed(*packed[:4], scene.config)

    prep_replay_ms = cuda_ms(prep_graph.replay, 5)
    split_frames["phong1080 prepare()"] = (prep_graph, prep_replay_ms,
                                           lambda s=scene: (set_angle(s, ANGLES[0]), s.prepare()))
    log(f"[graph] phong1080 prepare: warm-up and capture {prep_graph.capture_ms:.1f} ms, "
        f"pool {prep_graph.graph.pool_bytes} B, "
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
                      dict(zero, raster_planes=FRAMES, shade_planes=FRAMES, tri_setup=FRAMES, bin_pairs=FRAMES),
                      (h, w, 4), {"K4": "raster_planes", "shade_planes": "shade_planes", "tri_setup tex2048": "tri_setup",
                                  "bin_pairs tex2048": "bin_pairs"}, geometries=1, max_nodes=TEX2048_GRAPH_NODES)
    check(torch.equal(outs[0], tex2048_frame), "phong1080_tex2048: Scene.render() at 0.10 differs from the checked "
          "K4 + shade_planes frame")
    clipped_at_bench["phong1080_tex2048 Scene.render()"] = clipped_per_draw(scene, ANGLES[0])
    raster_stages("phong1080_tex2048", scene)
    set_angle(scene, ANGLES[0])
    clip_flip("phong1080_tex2048 Scene.render()", scene, scene.render, lambda: render_eager(scene))

    # custom_tex1080: a user's pixel shader that samples, so K3 once a frame;
    # its frames equal the builtin textured shader's on the same planes
    # (shade_planes reading uv at channel 6 of phong's varyings)
    scene = build_scene("custom_tex1080", dev)

    def custom_tex_frame(i, s=scene):
        set_angle(s, 0.10 + 0.05 * i)
        return s.render()[0]

    def custom_tex_eager(i, s=scene):
        set_angle(s, 0.10 + 0.05 * i)
        return render_eager(s)[0]

    outs = graph_path("custom_tex1080 Scene.render()", custom_tex_frame, custom_tex_eager, FRAMES,
                      dict(zero, raster_planes=FRAMES, sample_bilinear=FRAMES, tri_setup=FRAMES, bin_pairs=FRAMES,
                           pack_rgba8=FRAMES, compact_planes=FRAMES),
                      (h, w, 4), {"K3": "sample_bilinear", "K4 custom_tex1080": "raster_planes",
                                  "tri_setup custom_tex1080": "tri_setup", "bin_pairs custom_tex1080": "bin_pairs",
                                  "pack_rgba8": "pack_rgba8", "compact_planes": "compact_planes"},
                      geometries=1, in_rungs=("sample_bilinear", "pack_rgba8"))
    builtin_tex = dataclasses.replace(scene, pixel_shader=make_textured_shaders()[1],
                                      config=dataclasses.replace(scene.config, fused_shade=False))
    before = kernels.shade_planes.launches
    equal = []
    for i in range(EAGER_FRAMES):
        set_angle(builtin_tex, 0.10 + 0.05 * i)
        equal.append(torch.equal(outs[i], render_eager(builtin_tex)[0]))
    check(all(equal) and kernels.shade_planes.launches == before + EAGER_FRAMES,
          f"custom_tex1080: frames equal to the builtin textured shader's (fused_shade=False) {equal}, "
          f"{kernels.shade_planes.launches - before} shade_planes launches")
    log(f"[main-path] custom_tex1080: frames 0-{EAGER_FRAMES - 1} (K4 + K3) equal the builtin textured shader's on "
        f"phong's planes (K4 + shade_planes, uv at channel 6)={equal}")
    raster_stages("custom_tex1080", scene)
    del builtin_tex, outs

    scene = build_scene("custom12_360", dev)

    def custom_frame(i, s=scene):
        set_angle(s, 0.3 + 0.05 * i)
        return s.render()[0]

    def custom_eager(i, s=scene):
        set_angle(s, 0.3 + 0.05 * i)
        return render_eager(s)[0]

    w, h = SIZES["custom12_360"]
    graph_path("custom12_360 Scene.render()", custom_frame, custom_eager, 3,
               dict(zero, raster_planes=3, tri_setup=3, bin_pairs=3, pack_rgba8=3, compact_planes=3), (h, w, 4),
               {"K4 custom12_360": "raster_planes", "tri_setup custom12_360": "tri_setup",
                "bin_pairs custom12_360": "bin_pairs", "pack_rgba8 custom12_360": "pack_rgba8",
                "compact_planes custom12_360": "compact_planes"}, geometries=1, in_rungs=("pack_rgba8",))
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
                          {key: "voxel_march", setup_key: "voxel_setup"}, max_nodes=VOXEL_GRAPH_NODES,
                          own_nodes=VOXEL_FRAME_NODES)
        hit = float((outs[0][..., :3] != 0).any(-1).float().mean())
        check(0.05 < hit < 0.9, f"{path}: implausible hit share {hit}")
        # the same frames with the grids bound once (voxel.VoxelRenderer, as the JAX package's bench and demo
        # jit a closure over concrete grids): the table made here, outside the graph, whose inputs are eye
        # and inv_mvp alone
        renderer = raycast.VoxelRenderer(grid_color, grid_hit, cfg, device=dev)

        def bound_frame(i, r=renderer):
            return r(*views[i])

        def bound_eager(i, r=renderer, cfg=cfg):
            eye, inv_mvp = (torch.from_numpy(a).to(dev) for a in views[i])
            return raycast.march_frame(r.table, r.constants, eye, inv_mvp, cfg)

        bound = graph_path(f"{path} VoxelRenderer", bound_frame, bound_eager, FRAMES,
                           dict(zero, voxel_march=FRAMES, voxel_setup=FRAMES), (VOXEL_H, VOXEL_W, 4), {},
                           own_names=VOXEL_BOUND_NODES)
        equal = [torch.equal(a, b) for a, b in zip(bound, outs)]
        check(all(equal), f"{path}: VoxelRenderer's frames {[i for i, e in enumerate(equal) if not e]} differ from "
                          f"render_voxel_frame's")
        tb, tf = graph_times[f"{path} VoxelRenderer"], graph_times[f"{path} render_voxel_frame"]
        log(f"[graph] {path} VoxelRenderer against render_voxel_frame: frames on the {FRAMES} views byte-equal="
            f"{all(equal)}; replay {tb['replay_ms']:.4f} / {tf['replay_ms']:.4f} ms, graph frame "
            f"{tb['graph_ms']:.4f} / {tf['graph_ms']:.4f} ms (host {tb['graph_host_ms']:.4f} / "
            f"{tf['graph_host_ms']:.4f} ms), input copy {tb['copy_ms']:.4f} / {tf['copy_ms']:.4f} ms "
            f"({tb['in_leaves']} leaves, {tb['in_bytes']} B / {tf['in_leaves']} leaves, {tf['in_bytes']} B), "
            f"nodes {tb['nodes']} / {tf['nodes']} (CUDA events; {smi})")
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

    # 4c. the three demos, each at its default size, as a user starts them
    demos_phase(dev, smi)

    stream_grid = "phong1080 compiled.grid_frame 2 x 4 (stream, in one process)"

    def count_replays():
        """4b. each graph path's main-path run: the first EAGER_FRAMES of its
        frames again, as replays, with the counts set to 0 just before and
        read just after. A replay runs no wrapper, so the counts must stay
        0, and the launches are the kernels the device ran (CUPTI's records,
        one trace for all paths, a spin kernel between two paths). Last,
        because tracing may slow the host's later launches (the voxel ray
        set-up is timed again after it)."""
        log(f"[time] {time.time() - t_start:.1f} s")
        runs, merges = [], {}
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
            total = checksum(path, again, shape)
            if path == "phong1080_tex2048 Scene.render()":
                check(total == TEX2048_CHECKSUM, f"{path}: checksum {total}, the PyTorch shading's {TEX2048_CHECKSUM}")
            log(f"[main-path] {path} x{n}: launches {got} (the kernels the device ran in {n} replays, from "
                f"CUPTI's records; the wrappers' counts {host}), host {host_ms:.3f} ms/frame under the trace, "
                f"checksum {total} ({smi})")
            launches.update({key: got[wrapper] for key, wrapper in keys.items()})
            merges[path] = got["stream_merge"] // n
        log("[main-path] stream_merge_kernel launches a frame (CUPTI's records, replays): "
            + ", ".join(f"{p} {v}" for p, v in merges.items()))
        check(merges.get(stream_grid) == 16 and not any(v for p, v in merges.items() if p != stream_grid),
              f"stream_merge_kernel ran {merges} times a frame, not 16 in the stream grid and 0 elsewhere")
        counted.clear()
        split_replays()

    def split_replays():
        """4b. one replay of each split path (phong1080 ``render()`` and
        ``prepare()``, stress4k ``render()``, phong1080_tex2048 ``render()``,
        the captured sharded frame and 2 x 4 grids, voxel540 and voxel540dda)
        at the bench camera, under a device trace of its kernels, memsets and
        memcpys with their durations: where the replay's time goes."""
        sharded = "phong1080 compiled.sharded_frame (NCCL, world size 1)"
        voxel = ("voxel540 render_voxel_frame", "voxel540dda render_voxel_frame", "voxel540 VoxelRenderer",
                 "voxel540dda VoxelRenderer")
        tex2048 = "phong1080_tex2048 Scene.render()"
        # the grids' (shards, binnings): each shard's launch 1 and tri_quirk_kernel, a binning a slab or round
        grids = {"phong1080 compiled.grid_frame 2 x 4 (all_gather, in one process)": (2, 8),
                 stream_grid: (2, 16),
                 "phong1080_tex2048 compiled.grid_frame 2 x 4 (all_gather, the gather path on phong1080_tex2048, "
                 "in one process)": (2, 8)}
        paths = [p for p in ("phong1080 Scene.render()", "phong1080 prepare()", "stress4k Scene.render()", tex2048,
                             sharded, *grids, *voxel) if p in split_frames]
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
            if p in voxel:
                check((ran["voxel_setup"], ran["voxel_march"]) == (1, 1),
                      f"{p}: the traced replay ran the set-up and march kernels {ran['voxel_setup']} and "
                      f"{ran['voxel_march']} times, not once each")
                log(f"[split] {p}: set-up and march kernels {ran['voxel_setup']}, {ran['voxel_march']}")
                if p.endswith("VoxelRenderer"):  # no table operation: the port's three kernels and nothing else
                    others = foreign_kernels(part, port_names)
                    check(not others and len(part) == len(VOXEL_BOUND_NODES),
                          f"{p}: the traced replay ran {len(part)} operations, {others} of them not the port's")
                    log(f"[split] {p}: {len(part)} device operations, none but the port's kernels ({others})")
                scene = "frame 0's view"
            else:
                # the set-up kernels write the records (the sharded frame's in their shard mode)
                shards, bins = grids.get(p, (1, 1))
                want = (shards, bins)
                check((ran["tri_setup"], ran["bin_pairs"]) == want,
                      f"{p}: the traced replay ran the set-up and binning kernels {ran['tri_setup']} and "
                      f"{ran['bin_pairs']} times, not {want}")
                log(f"[split] {p}: set-up and binning kernels {ran['tri_setup']}, {ran['bin_pairs']}")
                leads = programmatic_leads(part)
                log(f"[split] {p}: the binning's kernels start before the one ahead of them ends (programmatic "
                    f"edges kept in the graph) by {leads} us")
                if p == "stress4k Scene.render()":
                    check(len(leads) == 3 and all(v > 0 for v in leads),
                          f"{p}: the replay's binning kernels ran one after another ({leads} us): the graph lost its "
                          f"programmatic edges")
                # phong's vertex stage runs in launch 1 (tri_setup_kernel<kPhong>): no PyTorch kernel of it is left
                phong = VERTEX_KINDS["phong"].code
                check(any(f"tri_setup_kernelILi{phong}E" in name for *_, name in part),
                      f"{p}: the traced replay's set-up kernel is not the phong vertex mode")
                # the set-up at the bench camera (nothing clipped): launch 1 and the accumulator's fill, no
                # conditional node's kernel, no clip path's kernels
                setup_ops = {k: sum(k in name for *_, name in part) for k in SETUP_OPS}
                if p in ("phong1080 Scene.render()", "phong1080 prepare()"):
                    fills = sum("FillFunctor<int>" in demangle(name) for *_, name in part)
                    check(setup_ops == dict(dict.fromkeys(SETUP_OPS, 0), tri_setup_kernel=1) and fills <= 1,
                          f"{p}: the set-up ran {setup_ops} and {fills} fills at the bench camera, not launch 1 and "
                          f"at most a fill")
                    log(f"[split] {p}: the set-up's device operations at the bench camera {1 + fills} (launch 1, "
                        f"{fills} fill): {setup_ops}")
                if p == sharded or p in grids:  # each shard's launch 1, its quirk after the reduction
                    want_ops = dict(dict.fromkeys(SETUP_OPS, 0), tri_setup_kernel=shards, tri_quirk_kernel=shards)
                    check(setup_ops == want_ops, f"{p}: the set-up ran {setup_ops} at the bench camera, not {want_ops}")
                    log(f"[split] {p}: the shard's set-up at the bench camera: {setup_ops}")
                if p == stream_grid:  # one merge kernel a round, none of the PyTorch merge's kernels
                    merge_ops = {k: sum(k in name for *_, name in part) for k in MERGE_OPS}
                    check(ran["stream_merge"] == 16 and not any(merge_ops.values()),
                          f"{p}: the traced replay ran {ran['stream_merge']} stream_merge_kernel (not 16) and the "
                          f"PyTorch merge's kernels {merge_ops}")
                    log(f"[split] {p}: stream_merge_kernel {ran['stream_merge']}, the PyTorch merge's kernels "
                        f"{merge_ops}")
                if p == tex2048:  # K4, then the shading kernel; no K3, no K1
                    got = {k: ran[k] for k in ("raster_planes", "shade_planes", "sample_bilinear", "fused_raster")}
                    check(got == {"raster_planes": 1, "shade_planes": 1, "sample_bilinear": 0, "fused_raster": 0},
                          f"{p}: the traced replay ran {got}")
                    log(f"[split] {p}: K4, shade_planes, K3 and K1 kernels {list(got.values())}")
                scene = (f"the bench camera ({ANGLES[0]}), faces clipped per draw "
                         f"{clipped_at_bench.get(p, clipped_at_bench['phong1080 Scene.render()'])}")
            others = foreign_kernels(part, port_names)
            log(f"[split] {p}: {sum(others.values())} kernels not of csrc/ in the replay (PyTorch's, CUDA's memset "
                f"kernels), {sorted(others.items())}")
            log(f"[split] {p}: one replay at {scene}; {sp['records']} records; device time summed "
                f"{sp['sum_us']:.1f} us, busy (their union) {sp['busy_us']:.1f} us over a span of "
                f"{sp['span_us']:.1f} us (idle gap {sp['gap_us']:.1f} us); the replay "
                f"{split_frames[p][1] * 1e3:.1f} us (CUDA events, untraced; {smi})")
            for name, n, us in sp["top"]:
                log(f"[split]   {us:9.2f} us  x{n:<5d} {name}")
        split_frames.clear()
        for p, s in split_flip.items():
            flip_replay(p, s)
        split_flip.clear()

    def flip_replay(p, s):
        """4b. one replay of ``p``'s graph (scene ``s``) at the bench camera
        with 1 face of draw 0 clipped, under a device trace: the frame's
        conditional node runs its body (the clip path, tri_slots_kernel,
        tri_quirk_kernel), and the frame equals the eager frame bit for bit
        and the plain chain's (build_triangles, the plain binning,
        render_fused_plain) as K1 is held to it."""
        base = s.draws
        s.draws = clipped_draws(base, s.vs_uniform, 1)
        set_angle(s, ANGLES[0])
        try:
            want = render_eager(s)
            tri, _ = build_triangles(s.draws, s.vertex_shader, s.vs_uniform, s.config)
            prep = plain_prep(tri, s.config, **bin_settings(s.config, True))
            plain_frame = plain(fused.render_fused_plain, prep, s.pixel_shader, s.ps_uniform, s.config)
            s.render()  # the clipped draws in the graph's buffers
            torch.cuda.synchronize()
            with DeviceTrace() as trace:
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                got = s.render()
                torch.cuda.synchronize()
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
        finally:
            s.draws = base
        part = records_between_markers(trace.records)
        names = [name for *_, name in part[0]] if part else []
        ran = {k: sum(k in name for name in names) for k in SETUP_OPS}
        body = dict(tri_setup_kernel=1, tri_slots_kernel=1, tri_quirk_kernel=1, set_condition_kernel=0)
        check(ran == body, f"{p} with 1 face clipped: the replay ran {ran}, not the conditional node's body {body}")
        equal = same(got, want)
        check(equal, f"{p} with 1 face clipped: the replay differs from the eager frame")
        derr = (got[1] - plain_frame[1]).abs()
        check(bool((derr <= DEPTH_RTOL * plain_frame[1].abs()).all()),
              f"{p} with 1 face clipped: depth beyond rtol of the plain chain's, max {float(derr.max())}")
        f_err, at2 = frame_bar(f"{p} with 1 face clipped, against the plain chain", got[0], plain_frame[0])
        log(f"[split] {p} with 1 face of draw 0 clipped ({int(got[2]['num_clipped'])} faces): one replay ran "
            f"{ran}; the frame bit-equal to the eager frame={equal}, against the plain chain's {f_err} u8 "
            f"({at2:.4%} at 2), depth max abs err {float(derr.max()):.3g}")

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
        for path in ("stress4k", "tex2048", "custom12_360", "custom_tex1080"):
            rows[key][f"launches_{path}"] = launches[f"{key} {path}"]
    rows["bin_pairs"]["launches_sharded_graph_world1"] = launches["bin_pairs sharded graph"]
    rows["tri_setup"]["launches_sharded_graph_world1"] = launches["tri_setup sharded graph"]
    rows["tri_setup"]["launches_grid_2x4_graph"] = launches["tri_setup grid 2x4 graph"]
    rows["K4"]["launches_grid_2x4_gather_graph"] = launches["K4 grid 2x4 gather graph"]
    rows["K1"]["launches_render_prepared"] = launches["K1 render_prepared"]
    rows["K1"]["launches_sharded_graph_world1"] = launches["K1 sharded graph"]
    rows["K1"]["launches_grid_2x4_graph"] = launches["K1 grid 2x4 graph"]
    rows["K4"]["launches_grid_2x4_stream_graph"] = launches["K4 grid 2x4 stream graph"]
    rows["shade_planes"]["launches_grid_2x4_stream_graph"] = launches["shade_planes grid 2x4 stream graph"]
    rows["K4"]["launches_custom_tex1080"] = launches["K4 custom_tex1080"]
    rows["pack_rgba8"]["launches_custom12_360"] = launches["pack_rgba8 custom12_360"]
    rows["compact_planes"]["launches_custom12_360"] = launches["compact_planes custom12_360"]
    rows["stream_merge"]["launches_per_frame"] = rows["stream_merge"]["launches"] // EAGER_FRAMES
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
