#!/usr/bin/env python3
"""Where K4's time goes on the card, and the size of K5's dda step.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/k4_trace.py

1. A per-block timeline of K4 (csrc/raster_planes.cu) on phong1080_tex2048:
   a copy of csrc/ whose K4 writes, for every block, %globaltimer at its
   start, after its loop and at its end (after a barrier), with its SM, is
   built into f_renderer_tpu_torch/_build/trace/ and run with and without
   varyings. Printed: the device time, the span, the summed block time (a
   kernel whose 264 resident blocks stay busy takes about that over 264),
   loop and epilogue per class of tiles, and how many blocks are in their
   loop or epilogue over time. The instrumented kernel is slower than K4
   (its last barrier and stores); the shares are what it is for.
2. The instructions of the loops (20 or more) of each K5 dda kernel in the
   library that ``kernels.load_library`` builds (``cuobjdump -sass``): the
   step's loop is compiled twice, for a cell that is a power of two (the
   shorter) and for one that is not (with its divisions).
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HOOKS = {  # text of csrc/raster_planes.cu → the same with the trace hooks
    "constexpr int CH_GROUP = 4;": "__device__ unsigned long long g_trace[1 << 15][4];\nconstexpr int CH_GROUP = 4;",
    "  const TileSlot at = tile_slot(th, ntx, desc);":
        "  unsigned long long t0, t1;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t0));\n"
        "  const TileSlot at = tile_slot(th, ntx, desc);",
    "  raster_tile<R>(tri_i32, tri_f32, np, at, dep, wpair);\n":
        "  raster_tile<R>(tri_i32, tri_f32, np, at, dep, wpair);\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));\n"
        "  struct Mark {\n"
        "    unsigned long long t0, t1;\n"
        "    int t;\n"
        "    __device__ ~Mark() {\n"
        "      __syncthreads();\n"
        "      if (threadIdx.x == 0 && threadIdx.y == 0) {\n"
        "        unsigned long long t2;\n"
        "        unsigned smid;\n"
        "        asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t2));\n"
        "        asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
        "        g_trace[blockIdx.x][0] = t0;\n"
        "        g_trace[blockIdx.x][1] = t1;\n"
        "        g_trace[blockIdx.x][2] = t2;\n"
        "        g_trace[blockIdx.x][3] = ((unsigned long long)smid << 32) | (unsigned)t;\n"
        "      }\n"
        "    }\n"
        "  } mark{t0, t1, at.d.t};\n",
}
TRACE_GET = """
extern "C" int fr_trace_get(void* dst, int n_blocks) {
  const cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(dst, g_trace, (size_t)n_blocks * 32);
}
"""


def traced_library(kernels):
    """Point ``kernels`` at an instrumented copy of csrc/ → its library."""
    src = ROOT / "f_renderer_tpu_torch" / "_build" / "trace" / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    text = (src / "raster_planes.cu").read_text()
    for old, new in HOOKS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"raster_planes.cu no longer has {old!r} once: update the hooks")
        text = text.replace(old, new)
    (src / "raster_planes.cu").write_text(text + TRACE_GET)
    kernels.CSRC, kernels.BUILD_DIR = src, src.parent
    kernels.load_library.cache_clear()
    lib = kernels.load_library()
    lib.fr_trace_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def trace_k4():
    import torch

    import chip_smoke
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import raster
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    dev = torch.device("cuda", 0)
    scene = chip_smoke.build_scene("phong1080_tex2048", dev)
    chip_smoke.set_angle(scene, 0.10)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    prep = raster.prep_binned(tri, scene.config.width, scene.config.height, scene.config.tile)
    lib = traced_library(kernels)
    off = prep.off.tolist()
    nty, ntx = prep.h_pad // prep.th, prep.w_pad // raster.LANES
    pairs = np.array([sum(off[r + 1] - off[r] for r in raster.tile_lists(prep, ty, tx)[:2])
                      for ty in range(nty) for tx in range(ntx)])
    n_blocks = ntx * nty * (prep.th // 8)
    buf = np.zeros((n_blocks, 4), np.uint64)
    for interp in (True, False):
        ms = chip_smoke.device_ms(lambda: raster.raster_planes(prep, interp), 20)
        raster.raster_planes(prep, interp)
        err = lib.fr_trace_get(buf.ctypes.data, n_blocks)
        if err:
            raise RuntimeError(f"fr_trace_get: CUDA error {err}")
        t = buf.astype(np.int64)
        start, lend, end = ((t[:, k] - t[:, 0].min()) / 1e3 for k in range(3))  # µs
        w = pairs[t[:, 3] & 0xFFFFFFFF]
        tag = f"K4 {'with' if interp else 'without'} varyings"
        print(f"[trace] {tag}: device {ms * 1e3:.2f} us, span {end.max():.2f} us, summed block time "
              f"{(end - start).sum():.0f} us (/264 = {(end - start).sum() / 264:.2f} us)")
        for lo, hi in ((0, 1), (1, 8), (8, 32), (32, 128), (128, 256), (256, 10**9)):
            m = (w >= lo) & (w < hi)
            if m.any():
                print(f"[trace] {tag}: tiles of [{lo}, {hi}) pairs, {int(m.sum())} blocks: loop "
                      f"{(lend - start)[m].mean():.2f} us, epilogue {(end - lend)[m].mean():.2f} us, "
                      f"summed {(end - start)[m].sum():.0f} us")
        at = np.linspace(0, end.max(), 11)
        print(f"[trace] {tag}: at {' '.join(f'{x:.1f}' for x in at)} us, blocks in their loop "
              f"{[int(((start <= x) & (lend > x)).sum()) for x in at]}, in their epilogue "
              f"{[int(((lend <= x) & (end > x)).sum()) for x in at]}")


def dda_step_sass():
    from f_renderer_tpu_torch import kernels

    lib_path = Path(kernels.load_library()._name)
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    for name, body in re.findall(r"Function : (\S*voxel_march_kernelILb1E\S*)\n(.*?)(?=Function :|\Z)",
                                 sass, re.S):
        pcs = {}
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
            pcs[int(m.group(1), 16)] = m.group(2)
        loops = [(pc - int(target, 16)) // 16 + 1 for pc, ins in pcs.items()
                 for target in re.findall(r"BRA (0x[0-9a-f]+)", ins) if int(target, 16) < pc]
        print(f"[sass] {name}: loops of {sorted((n for n in loops if n >= 20), reverse=True)} instructions")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_trace: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dda_step_sass()
    trace_k4()
    return 0


if __name__ == "__main__":
    sys.exit(main())
