"""Build, bind and launch the hand-written CUDA kernels.

The sources live in ``csrc/``. At first use each ``.cu`` is compiled with
its own ``nvcc`` for ``sm_90a`` (all started together), and the objects are
linked into one shared library with a plain C interface, under ``_build/``
beside this file and named by a hash of the sources and flags (an edited
source builds anew). The library is loaded with ``ctypes``: pointers and the
stream go as ``c_void_p``. Each C entry point returns ``cudaGetLastError()``
after its launch, and the wrapper raises unless it is 0. Nothing here falls
back to anything: a failed build or launch raises, and every wrapper takes
CUDA tensors only.

The kernels (the TPU kernel each replaces in brackets):

- ``fused_raster`` — K1 with the K2 sampler inlined (pipeline/fused.py:525);
- ``raster_planes`` — K4 (pipeline/raster_pallas.py:1562);
- ``sample_bilinear`` — K3 (shaders/texture_pallas.py:497);
- ``voxel_march`` — K5 (voxel/raycast_pallas.py:393);
- ``voxel_setup`` — no Pallas kernel: XLA's fusion of the voxel ray set-up
  (voxel/raycast.py:34-264, fenced at raycast_pallas.py:310);
- ``tri_setup`` / ``tri_setup_slots`` — no Pallas kernel: XLA's fusions of
  the triangle set-up from the builtin shaders' vertex stage, or a custom
  vertex shader's outputs, to the packed rows (pipeline/geometry.py:287-350
  over shaders/builtin.py:52-166, render.py:113-202, raster_pallas.py:178
  pack_setup);
- ``bin_pairs`` — no Pallas kernel: XLA's fusions of the binning and the
  pair-order gather (raster_pallas.py:319 bin_pairs, fused.py:160-183);
- ``if_node`` — no TPU kernel: a conditional node of a CUDA graph under
  capture, the counterpart of ``lax.cond`` in a compiled program
  (torch 2.11 has no Python API for one).

Each wrapper counts its launches (``fused_raster.launches`` …), so a run can
show that its main path went through the kernel. A stream capture records a
launch without making it, so a wrapper called under capture does not count;
a CUDA graph replay runs no wrapper, so its launches are read from the
device (``chip_smoke.py`` does so with CUPTI).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# --fmad=false: no mul+add contraction, so the float math rounds as the
# plain PyTorch versions do. Division and sqrt stay IEEE (nvcc's default
# -prec-div=true -prec-sqrt=true); never --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
)


class FusedParams(ctypes.Structure):
    """Mirror of ``FrFusedParams`` in csrc/kernels.h (int32 and float only,
    so the two layouts agree with no padding)."""

    _fields_ = [
        ("th", ctypes.c_int32),
        ("ntx", ctypes.c_int32),
        ("nty", ctypes.c_int32),
        ("w_pad", ctypes.c_int32),
        ("n_pairs", ctypes.c_int32),
        ("n_ctx", ctypes.c_int32),
        ("kind", ctypes.c_int32),
        ("t_count", ctypes.c_int32),
        ("hmax", ctypes.c_int32),
        ("wmax", ctypes.c_int32),
        ("opaque", ctypes.c_int32),
        ("bg_packed", ctypes.c_int32),
        ("light_pos", ctypes.c_float * 3),
        ("light_color", ctypes.c_float * 3),
        ("ambient", ctypes.c_float * 3),
        ("oy", ctypes.c_int32),
        ("ox", ctypes.c_int32),
    ]


class VoxelParams(ctypes.Structure):
    """Mirror of ``FrVoxelParams`` in csrc/kernels.h."""

    _fields_ = [
        ("n", ctypes.c_int32),
        ("r", ctypes.c_int32),
        ("dda", ctypes.c_int32),
        ("max_steps", ctypes.c_int32),
        ("bg_packed", ctypes.c_int32),
        ("n_times", ctypes.c_int32),
        ("length", ctypes.c_float),
        ("cell", ctypes.c_float),
        ("per_t", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("inv_per_t", ctypes.c_float),
        ("eps_jump", ctypes.c_float),
        ("inv_cell", ctypes.c_float),
    ]


class TriSetupParams(ctypes.Structure):
    """Mirror of ``FrTriSetupParams`` in csrc/kernels.h."""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "n_draws", "n_faces", "n_ctx", "nb", "m", "m_pad", "width", "height", "cull", "quirk")]


MAX_DRAWS = 256  # FR_MAX_DRAWS: the draws of a frame (render.build_triangles' cap)


class VertexArgs(ctypes.Structure):
    """Mirror of ``FrVertexArgs`` in csrc/kernels.h (ctypes pads it as the C
    compiler does)."""

    _fields_ = [
        ("model", ctypes.c_void_p),
        ("view", ctypes.c_void_p),
        ("proj", ctypes.c_void_p),
        ("view_pos", ctypes.c_void_p),
        ("clip", ctypes.c_void_p),
        ("ctx", ctypes.c_void_p),
        ("attr", (ctypes.c_void_p * 3) * MAX_DRAWS),
        ("light_pos", ctypes.c_float * 3),
        ("light_color", ctypes.c_float * 3),
        ("kind", ctypes.c_int32),
    ]


class BinParams(ctypes.Structure):
    """Mirror of ``FrBinParams`` in csrc/kernels.h."""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "m", "rows_f", "th", "ntx", "nty", "k", "kc", "oy", "ox", "m_dummy", "n_pad", "stripe", "n_stripes")]


# Tile heights the raster kernels take (th / 8 thread blocks to a tile).
SUPPORTED_TH = (4, 8, 16, 32, 64, 128)
MAX_CTX = 8  # the fused kernel's varying cap (K4 has none)
# Pairs a tile's culled coarse + spill list holds (csrc/raster_loop.cuh,
# tile_plan_kernel); a tile with more keeps both ranges whole. stress4k's
# most is 394.
CULL_CAP = 512
REC = 20  # words of a staged pair record (raster_loop.cuh); word 18 is its pair column


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))


def _run_all(cmds) -> list[str]:
    """Run the commands together → their stderr; raise with the failures'."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    errors, logs = [], []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)} failed ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return logs


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib_path = BUILD_DIR / f"fr_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        units = [p for p in _sources() if p.suffix == ".cu"]
        objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in units]
        nvcc = _nvcc()
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(p), "-o", str(o)]
                         for p, o in zip(units, objs)])
        lib_path.with_suffix(".ptxas.txt").write_text("".join(logs))
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        for o in objs:
            o.unlink()
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fr_fused_raster.argtypes = [FusedParams] + [ptr] * 10 + [i32, ptr]
    lib.fr_raster_planes.argtypes = [i32] * 7 + [ptr] * 8 + [i32, ptr]
    lib.fr_sample_bilinear.argtypes = [ptr, ptr] + [i32] * 5 + [ptr] * 4 + [ctypes.c_int64, ptr]
    lib.fr_voxel_march.argtypes = [VoxelParams] + [ptr] * 13
    lib.fr_voxel_setup.argtypes = [i32, i32, ctypes.c_float] + [ptr] * 5
    lib.fr_tri_setup.argtypes = [TriSetupParams] + [ptr] * 7 + [i32, ptr]
    lib.fr_tri_setup_vertex.argtypes = [TriSetupParams, ptr, ctypes.POINTER(VertexArgs)] + [ptr] * 4 + [i32, ptr]
    lib.fr_tri_setup_slots.argtypes = [TriSetupParams] + [ptr] * 5 + [i32, ptr]
    lib.fr_bin_pairs.argtypes = [BinParams] + [ptr] * 10
    lib.fr_if_node_begin.argtypes = [ptr] * 3
    lib.fr_if_node_end.argtypes = [ptr]
    lib.fr_stream_create.argtypes = [ctypes.POINTER(ptr)]
    for fn in (lib.fr_fused_raster, lib.fr_raster_planes, lib.fr_sample_bilinear, lib.fr_voxel_march,
               lib.fr_voxel_setup, lib.fr_tri_setup, lib.fr_tri_setup_vertex, lib.fr_tri_setup_slots,
               lib.fr_bin_pairs,
               lib.fr_if_node_begin, lib.fr_if_node_end, lib.fr_stream_create):
        fn.restype = ctypes.c_int
    lib.fr_error_string.argtypes = [ctypes.c_int]
    lib.fr_error_string.restype = ctypes.c_char_p
    return lib


def ptxas_report() -> list[str]:
    """Each kernel's registers, spills and shared memory as ``ptxas -v``
    printed them when the library was built (one line per kernel)."""
    lib_path = Path(load_library()._name)
    lines, name = [], None
    for line in lib_path.with_suffix(".ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d([a-z_]+_kernel)(?:I((?:L[a-z]+\d+E)+)E)?", line.split("'")[1])
            # template arguments: Li2 → 2, Lb0 / Lb1 → false / true
            args = [v if t != "b" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([a-z]+)(\d+)E", (m.group(2) or "") if m else "")]
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "") if m else line
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1] if line.startswith('ptxas') else line}".strip())
    return lines


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.fr_error_string(err).decode()}")


def _need(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on_cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches on CUDA tensors, got {t.device}")
    return t.device


def _check_bins(off, tri_i32, tri_f32, th, n_ctx, h_pad, w_pad):
    """Check a binned pair list (pipeline/raster.py:prep_binned) → (ntx, nty)."""
    dev = tri_i32.device
    if th not in SUPPORTED_TH or w_pad % 128 or h_pad % th:
        raise ValueError(f"tile ({th}, 128) over {h_pad}x{w_pad} is not supported")
    n_pairs = tri_i32.shape[1]
    ntx, nty = w_pad // 128, h_pad // th
    n_off = ntx * nty + -(-ntx // 4) * -(-nty // 4) + 2
    _need(off, "off", torch.int32, dev, (n_off,))
    _need(tri_i32, "tri_i32", torch.int32, dev, (12, n_pairs))
    _need(tri_f32, "tri_f32", torch.float32, dev, (9 + 3 * n_ctx, n_pairs))
    return ntx, nty


def plan_words(ntiles: int, cap: int) -> int:
    """int32 words of the raster kernels' tile plan (csrc/raster_loop.cuh):
    each tile's descriptor (8 words, in the order the raster grid takes the
    tiles), its count of culled coarse and spill pairs, and its record area
    (the staged records of its first ``cap`` culled pairs, ``REC`` rows of
    ``cap`` words)."""
    if cap < 0 or ntiles * REC * cap >= 2**31:
        raise ValueError(f"cull cap {cap} over {ntiles} tiles: need 0 <= ntiles * {REC} * cap < 2**31")
    return ntiles * (9 + REC * cap)


def _plan(scratch, ntx, nty, cap, dev) -> torch.Tensor:
    """The tile plan's scratch: ``scratch`` (checked) or a new buffer."""
    words = plan_words(ntx * nty, cap)
    if scratch is None:
        return torch.empty((words,), dtype=torch.int32, device=dev)
    _need(scratch, "scratch", torch.int32, dev, (words,))
    if scratch.data_ptr() % 16:
        raise ValueError("scratch: the tile descriptors need a 16-byte aligned buffer")
    return scratch


def read_plan(plan: torch.Tensor, ntiles: int, cap: int):
    """A tile plan the raster kernels wrote (``scratch=``) → (descriptors
    (ntiles, 8) int32 in the order the raster grid takes them: t, len0,
    len01, total, starts[3], flags; each tile's culled count (ntiles,); the
    culled pairs' columns (ntiles, cap), those past a tile's count unset)."""
    records = plan[9 * ntiles:].view(ntiles, REC, cap)
    return plan[:8 * ntiles].view(ntiles, 8), plan[8 * ntiles:9 * ntiles], records[:, 18]


@functools.lru_cache(maxsize=None)
def body_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """The stream that captures the bodies of conditional nodes on
    ``device``: made once, outside PyTorch's stream pool, whose round robin
    can hand out the capturing stream itself. Call it before a capture."""
    lib, out = load_library(), ctypes.c_void_p()
    with torch.cuda.device(device):
        _check(lib, lib.fr_stream_create(ctypes.byref(out)), "fr_stream_create")
    return torch.cuda.ExternalStream(out.value, device=device)


def if_node(pred: torch.Tensor, fn, *args) -> torch.cuda.MemPool:
    """``fn(*args)`` captured as an ``if`` node of the CUDA graph that the
    current stream is capturing (csrc/graph_cond.cu): a replay runs it only
    where the 0-d bool ``pred`` is true on the card. ``fn`` runs on
    :func:`body_stream`, which captures into the node's body, its
    allocations routed to a memory pool of its own (the capture's pool
    serves only the capturing stream) → that pool, which must live as long
    as the graph."""
    dev = _on_cuda(pred, "if_node")
    _need(pred, "pred", torch.bool, dev, ())
    lib = load_library()
    body, pool = body_stream(dev), torch.cuda.MemPool()
    _check(lib, lib.fr_if_node_begin(pred.data_ptr(), _stream(dev), body.cuda_stream), "if_node")
    try:
        with torch.cuda.stream(body), torch.cuda.use_mem_pool(pool, dev):
            fn(*args)
    finally:
        _check(lib, lib.fr_if_node_end(body.cuda_stream), "if_node body")
    return pool


def _count(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel, unless the stream is being
    captured: a capture records the launch into a graph and makes none."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


def fused_raster(
    off, tri_i32, tri_f32, view_pos, dims, texels, *,
    th, n_ctx, h_pad, w_pad, kind, opaque, bg_packed, light_pos, light_color, origin=(0, 0),
    cull_cap=CULL_CAP, scratch=None,
):
    """Launch the fused raster + shade kernel (csrc/fused_raster.cu) on
    PyTorch's current stream → padded (rgba int32, depth f32, winner int32),
    each (h_pad, w_pad). ``origin=(y0, x0)``: the frame's pixel that the
    planes' first one is (a row slab of a sharded frame). ``cull_cap``: the
    pairs a tile's culled list holds; ``scratch``: a (:func:`plan_words`,)
    int32 buffer to leave the tile plan in (:func:`read_plan`), else a new
    one."""
    dev = _on_cuda(tri_i32, "fused_raster")
    if not 0 < n_ctx <= MAX_CTX:
        raise ValueError(f"n_ctx={n_ctx}: the kernel carries 1..{MAX_CTX} varyings")
    n_pairs = tri_i32.shape[1]
    ntx, nty = _check_bins(off, tri_i32, tri_f32, th, n_ctx, h_pad, w_pad)
    _need(view_pos, "view_pos", torch.float32, dev, (3,))
    _need(texels, "texels", torch.int32, dev)
    _need(dims, "dims", torch.int32, dev, (texels.shape[0], 2))
    lib = load_library()
    params = FusedParams(
        th=th, ntx=ntx, nty=nty, w_pad=w_pad, n_pairs=n_pairs, n_ctx=n_ctx,
        kind=kind, t_count=texels.shape[0], hmax=texels.shape[1],
        wmax=texels.shape[2], opaque=int(bool(opaque)), bg_packed=bg_packed,
        light_pos=(ctypes.c_float * 3)(*light_pos),
        light_color=(ctypes.c_float * 3)(*light_color),
        # 0.1·lc rounds once, from the double product to float32, as the
        # JAX epilogue's Python-float ambient term does.
        ambient=(ctypes.c_float * 3)(*(0.1 * c for c in light_color)),
        oy=origin[0], ox=origin[1],
    )
    rgba = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
    depth = torch.empty((h_pad, w_pad), dtype=torch.float32, device=dev)
    winner = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
    plan = _plan(scratch, ntx, nty, cull_cap, dev)
    stream = _stream(dev)
    err = lib.fr_fused_raster(
        params,
        off.data_ptr(), tri_i32.data_ptr(), tri_f32.data_ptr(),
        view_pos.data_ptr(), dims.data_ptr(), texels.data_ptr(),
        rgba.data_ptr(), depth.data_ptr(), winner.data_ptr(), plan.data_ptr(), cull_cap, stream,
    )
    _check(lib, err, "fr_fused_raster")
    _count(fused_raster)
    return rgba, depth, winner


fused_raster.launches = 0


def raster_planes(off, tri_i32, tri_f32, *, th, n_ctx, h_pad, w_pad, interp, origin=(0, 0),
                  cull_cap=CULL_CAP, scratch=None):
    """Launch the non-fused raster kernel (csrc/raster_planes.cu) on PyTorch's
    current stream → padded (depth f32, winner int32) and, with ``interp``,
    (ps int32, ctx (n_ctx, h_pad, w_pad) f32); else None for both. Any C.
    ``origin``, ``cull_cap`` and ``scratch`` as for :func:`fused_raster`."""
    dev = _on_cuda(tri_i32, "raster_planes")
    ntx, nty = _check_bins(off, tri_i32, tri_f32, th, n_ctx, h_pad, w_pad)
    lib = load_library()
    depth = torch.empty((h_pad, w_pad), dtype=torch.float32, device=dev)
    winner = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
    ps = ctx = None
    if interp:
        ps = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
        ctx = torch.empty((n_ctx, h_pad, w_pad), dtype=torch.float32, device=dev)
    plan = _plan(scratch, ntx, nty, cull_cap, dev)
    err = lib.fr_raster_planes(
        th, ntx, nty, tri_i32.shape[1], n_ctx, origin[0], origin[1],
        off.data_ptr(), tri_i32.data_ptr(), tri_f32.data_ptr(),
        depth.data_ptr(), winner.data_ptr(),
        None if ps is None else ps.data_ptr(),
        None if ctx is None or n_ctx == 0 else ctx.data_ptr(),
        plan.data_ptr(), cull_cap, _stream(dev),
    )
    _check(lib, err, "fr_raster_planes")
    _count(raster_planes)
    return depth, winner, ps, ctx


raster_planes.launches = 0


def sample_bilinear(texels, dims, ps, u, v, *, opaque, replicate_clamp_bug):
    """Launch the batched sampler kernel (csrc/sample_bilinear.cu) on
    PyTorch's current stream → (4, *ps.shape) f32."""
    dev = _on_cuda(ps, "sample_bilinear")
    _need(texels, "texels", torch.int32, dev)
    if texels.dim() != 3:
        raise ValueError(f"texels: need (T, Hmax, Wmax), got {tuple(texels.shape)}")
    _need(dims, "dims", torch.int32, dev, (texels.shape[0], 2))
    _need(ps, "ps", torch.int32, dev)
    _need(u, "u", torch.float32, dev, ps.shape)
    _need(v, "v", torch.float32, dev, ps.shape)
    out = torch.empty((4,) + tuple(ps.shape), dtype=torch.float32, device=dev)
    n = ps.numel()
    if n == 0:
        return out
    lib = load_library()
    t_count, hmax, wmax = texels.shape
    err = lib.fr_sample_bilinear(
        dims.data_ptr(), texels.data_ptr(), t_count, hmax, wmax,
        int(bool(opaque)), int(bool(replicate_clamp_bug)),
        ps.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), n, _stream(dev),
    )
    _check(lib, err, "fr_sample_bilinear")
    _count(sample_bilinear)
    return out


sample_bilinear.launches = 0


def voxel_march(start, dirs, t_max, alive, table, times, k):
    """Launch the voxel march kernel (csrc/voxel_march.cu) on PyTorch's
    current stream. ``start`` and ``dirs`` are three f32 planes each, of
    ``t_max``'s shape; ``alive`` int32 of that shape; ``table`` (r³,)
    int32; ``times`` the (k.n_times,) f32 sample-time table; ``k`` the
    march's constants (``voxel.raycast.MarchConstants``) → packed BGRA int32
    of that shape."""
    dev = _on_cuda(t_max, "voxel_march")
    shape = tuple(t_max.shape)
    for name, planes in (("start", start), ("dirs", dirs)):
        for a, t in enumerate(planes):
            _need(t, f"{name}[{a}]", torch.float32, dev, shape)
    _need(t_max, "t_max", torch.float32, dev, shape)
    _need(alive, "alive", torch.int32, dev, shape)
    _need(table, "table", torch.int32, dev, (k.r ** 3,))
    _need(times, "times", torch.float32, dev, (k.n_times,))
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    n = t_max.numel()
    if n == 0:
        return out
    lib = load_library()
    params = VoxelParams(
        n=n, r=k.r, dda=int(k.dda), max_steps=k.max_steps,
        bg_packed=k.bg_packed, n_times=k.n_times, length=k.length, cell=k.cell, per_t=k.per_t,
        eps=k.eps, inv_per_t=k.inv_per_t, eps_jump=k.eps_jump, inv_cell=k.inv_cell,
    )
    bits = torch.empty(((k.r ** 3 + 31) // 32,), dtype=torch.int32, device=dev)
    err = lib.fr_voxel_march(
        params, *(t.data_ptr() for t in (*start, *dirs, t_max, alive, table, times, bits, out)),
        _stream(dev),
    )
    _check(lib, err, "fr_voxel_march")
    _count(voxel_march)
    return out


voxel_march.launches = 0


def voxel_setup(eye, inv_mvp, width, height, length):
    """Launch the voxel ray set-up kernel (csrc/voxel_setup.cu) on PyTorch's
    current stream: ``eye`` (3,) and ``inv_mvp`` (4, 4) f32, read by the
    kernel from the card, a ``width`` x ``height`` frame, a cube of side
    ``length`` → (start [3 planes], dirs [3 planes], t_max, alive), each
    (height, width): f32 planes, contiguous views of one buffer, and a bool
    plane."""
    dev = _on_cuda(inv_mvp, "voxel_setup")
    _need(eye, "eye", torch.float32, dev, (3,))
    _need(inv_mvp, "inv_mvp", torch.float32, dev, (4, 4))
    if width < 0 or height < 0 or width * height >= 2**31 - 256:
        raise ValueError(f"voxel_setup: a {width}x{height} frame is not supported")
    planes = torch.empty((7, height, width), dtype=torch.float32, device=dev)
    alive = torch.empty((height, width), dtype=torch.bool, device=dev)
    if width * height:
        lib = load_library()
        err = lib.fr_voxel_setup(width, height, length, eye.data_ptr(), inv_mvp.data_ptr(),
                                 planes.data_ptr(), alive.data_ptr(), _stream(dev))
        _check(lib, err, "fr_voxel_setup")
        _count(voxel_setup)
    return list(planes[:3]), list(planes[3:6]), planes[6], alive


voxel_setup.launches = 0


def acc_layout(n_draws: int):
    """int32 words of the set-up kernels' accumulator (csrc/tri_setup.cu) →
    (words, the word its uint64 keys start at): faces clipped per draw and
    in the frame, valid slots per draw, a byte a draw (clipped), the keys."""
    keys = 2 * n_draws + 1 + -(-n_draws // 4)
    keys += keys % 2
    return keys + 2 * n_draws, keys


def tri_setup(table, clip, ctx, *, n_draws, nb, m, m_pad, width, height, cull, quirk, vertex=None):
    """Launch 1 of the triangle set-up (csrc/tri_setup.cu: tri_setup_kernel)
    on PyTorch's current stream, over every face of the frame; ``table`` is
    the (4 D,) int32 draw table (face_off, faces, slot_base, order_base).
    ``clip`` (4, 3F) and ``ctx`` (C, 3F) f32 hold the draws' corners one
    after the other (draw d's corner v of face i at 3 face_off[d] + v F_d +
    i): the vertex shader's outputs, which the kernel reads, or, with
    ``vertex`` (a :class:`VertexStage`: a builtin's vertex stage, run in the
    launch), planes the kernel writes at the corners of every clipped face
    and of each draw's last face, the entries the clip path reads, leaving
    the rest unwritten. → (tri_i32 (12, m_pad), tri_f32 (9 + 3C, m_pad) with
    every path-A column written, b_mask (F,) bool, acc: the zeroed
    accumulator the kernel filled (:func:`acc_layout`; :func:`acc_views`
    reads it))."""
    dev = _on_cuda(clip, "tri_setup")
    n_faces, n_ctx = clip.shape[1] // 3, ctx.shape[0]
    _need(clip, "clip", torch.float32, dev, (4, 3 * n_faces))
    _need(ctx, "ctx", torch.float32, dev, (n_ctx, 3 * n_faces))
    _need(table, "table", torch.int32, dev, (4 * n_draws,))
    if not (0 < n_draws <= MAX_DRAWS and 0 <= m < m_pad < 2**31 and 0 < width < 32768 and 0 < height < 32768):
        raise ValueError(f"tri_setup: {n_draws} draws, {m} slots in {m_pad} columns, {width}x{height}")
    args = None if vertex is None else vertex_args(vertex, clip, ctx, dev)
    words, keys = acc_layout(n_draws)
    acc = torch.zeros((words,), dtype=torch.int32, device=dev)
    tri_i32 = torch.empty((12, m_pad), dtype=torch.int32, device=dev)
    tri_f32 = torch.empty((9 + 3 * n_ctx, m_pad), dtype=torch.float32, device=dev)
    b_mask = torch.empty((n_faces,), dtype=torch.bool, device=dev)
    params = TriSetupParams(n_draws=n_draws, n_faces=n_faces, n_ctx=n_ctx, nb=nb, m=m, m_pad=m_pad, width=width,
                            height=height, cull=int(bool(cull)), quirk=int(bool(quirk)))
    if n_faces:
        lib = load_library()
        outs = (tri_i32.data_ptr(), tri_f32.data_ptr(), b_mask.data_ptr(), acc.data_ptr(), keys, _stream(dev))
        if args is None:
            err = lib.fr_tri_setup(params, table.data_ptr(), clip.data_ptr(), ctx.data_ptr(), *outs)
        else:
            err = lib.fr_tri_setup_vertex(params, table.data_ptr(), ctypes.byref(args), *outs)
        _check(lib, err, "fr_tri_setup" if args is None else "fr_tri_setup_vertex")
        _count(tri_setup)
    return tri_i32, tri_f32, b_mask, acc


@dataclasses.dataclass(frozen=True)
class VertexStage:
    """A builtin's vertex stage for :func:`tri_setup`: its ``kind`` (the
    vertex shader's ``fused_kind``), the uniforms (``model``, ``view``,
    ``proj`` (4, 4), and gouraud's ``view_pos`` (3,)), the draws (dicts of
    (F_d, 3, k) tensors) and gouraud's light."""

    kind: str
    uniforms: dict
    draws: list
    light_pos: tuple = (0.0, 0.0, 0.0)
    light_color: tuple = (0.0, 0.0, 0.0)


def vertex_args(vertex: VertexStage, clip, ctx, dev) -> VertexArgs:
    """The launch's :class:`VertexArgs`: every tensor checked (float32,
    contiguous, on ``dev``, of the width the kind reads), or ValueError."""
    from f_renderer_tpu_torch.shaders.builtin import VERTEX_KINDS  # each kind's code and attributes

    if vertex.kind not in VERTEX_KINDS:
        raise ValueError(f"tri_setup: no builtin vertex stage of kind {vertex.kind!r}")
    spec = VERTEX_KINDS[vertex.kind]
    n_draws, n_ctx = len(vertex.draws), ctx.shape[0]
    if not 0 < n_draws <= MAX_DRAWS or not 0 < n_ctx <= MAX_CTX:
        raise ValueError(f"tri_setup: {n_draws} draws, {n_ctx} varyings")
    u = vertex.uniforms
    names = ("model", "view", "proj") + (("view_pos",) if vertex.kind == "gouraud" else ())
    for name in names:
        if name not in u:
            raise ValueError(f"tri_setup: the {vertex.kind} vertex stage reads the uniform {name!r}")
        _need(u[name], name, torch.float32, dev, (3,) if name == "view_pos" else (4, 4))
    args = VertexArgs(kind=spec.code, light_pos=(ctypes.c_float * 3)(*vertex.light_pos),
                      light_color=(ctypes.c_float * 3)(*vertex.light_color),
                      clip=clip.data_ptr(), ctx=ctx.data_ptr(),
                      **{name: u[name].data_ptr() for name in names})
    for d, draw in enumerate(vertex.draws):
        f = draw["pos"].shape[0] if "pos" in draw else 0
        for slot, (name, w, optional) in enumerate(spec.attributes):
            t = draw.get(name)
            if t is None and optional:
                continue
            if t is None:
                raise ValueError(f"tri_setup: draw {d} lacks the attribute {name!r} the {vertex.kind} stage reads")
            _need(t, f"draw {d} {name}", torch.float32, dev, (f, 3, n_ctx if w is None else w))
            args.attr[d][slot] = t.data_ptr()
    return args


tri_setup.launches = 0


def acc_views(acc, n_draws: int):
    """The set-up accumulator's (faces clipped per draw (D,) int32, in the
    frame (0-d int32), whether each draw clipped a face (D,) bool)."""
    clipped = acc[2 * n_draws + 1:2 * n_draws + 1 + -(-n_draws // 4)].view(torch.uint8)[:n_draws]
    return acc[:n_draws], acc[n_draws], clipped.view(torch.bool)


def tri_setup_slots(table, fan, tri_i32, tri_f32, acc, *, n_draws, nb, m, width, height, cull, quirk):
    """Launches 2 and 3 of the triangle set-up (csrc/tri_setup.cu:
    tri_slots_kernel, then with ``quirk`` tri_quirk_kernel) on PyTorch's
    current stream, into :func:`tri_setup`'s arrays: the path-B columns
    from ``fan`` (D, nb (23 + 3C)) int32, the clip path's arrays where the
    draw clipped a face, the padding columns, and the ps boundary quirk."""
    dev = _on_cuda(tri_i32, "tri_setup_slots")
    m_pad, n_ctx = tri_i32.shape[1], (tri_f32.shape[0] - 9) // 3
    _need(table, "table", torch.int32, dev, (4 * n_draws,))
    _need(fan, "fan", torch.int32, dev, (n_draws, nb * (23 + 3 * n_ctx)))
    _need(tri_i32, "tri_i32", torch.int32, dev, (12, m_pad))
    _need(tri_f32, "tri_f32", torch.float32, dev, (9 + 3 * n_ctx, m_pad))
    _need(acc, "acc", torch.int32, dev, (acc_layout(n_draws)[0],))
    params = TriSetupParams(n_draws=n_draws, n_faces=0, n_ctx=n_ctx, nb=nb, m=m, m_pad=m_pad, width=width,
                            height=height, cull=int(bool(cull)), quirk=int(bool(quirk)))
    lib = load_library()
    err = lib.fr_tri_setup_slots(params, table.data_ptr(), fan.data_ptr(), tri_i32.data_ptr(), tri_f32.data_ptr(),
                                 acc.data_ptr(), acc_layout(n_draws)[1], _stream(dev))
    _check(lib, err, "fr_tri_setup_slots")
    _count(tri_setup_slots)


tri_setup_slots.launches = 0

# The most counters the binning's stripes may take (8 MB), and its stripes.
BIN_COUNTERS = 1 << 21
BIN_MAX_STRIPES = 4096
BIN_MAX_SPAN = 64  # max(k, kc): a chunk's hash table holds 64 keys a lane


def bin_stripes(m: int, n_keys: int) -> tuple[int, int]:
    """(slots a stripe, stripes) of the binning's counting passes: as many
    stripes (warps) as BIN_MAX_STRIPES and BIN_COUNTERS counters allow,
    each a multiple of 32 slots."""
    n = max(1, min(-(-m // 32), BIN_MAX_STRIPES, BIN_COUNTERS // n_keys))
    stripe = -(-(-(-m // n)) // 32) * 32
    return stripe, -(-m // stripe)


def bin_pairs(tri_i32, tri_f32, *, th, grid_hw, k, kc, m_dummy, n_pad, origin=(0, 0)):
    """Launch the binning and pair gather (csrc/bin_pairs.cu) on PyTorch's
    current stream: the (tile key, slot) pairs of the packed arrays
    ``tri_i32`` (12, m) / ``tri_f32`` (9 + 3C, m) counted, placed in (key,
    slot) order and gathered → (off (R + 1,) int32, tri_i32 (12, n_pad),
    tri_f32 (9 + 3C, n_pad) in pair order, ``m_dummy``'s column past the
    last pair). ``grid_hw`` = (nty, ntx) tiles of (th, 128) pixels whose
    top-left pixel is the frame's ``origin`` = (y0, x0)."""
    dev = _on_cuda(tri_i32, "bin_pairs")
    m, rows_f = tri_i32.shape[1], tri_f32.shape[0]
    nty, ntx = grid_hw
    _need(tri_i32, "tri_i32", torch.int32, dev, (12, m))
    _need(tri_f32, "tri_f32", torch.float32, dev, (rows_f, m))
    n_keys = nty * ntx + -(-nty // 4) * -(-ntx // 4) + 1
    if not (0 <= m_dummy < m and 0 < m * max(k, kc) <= n_pad < 2**31 and n_pad % 128 == 0):
        raise ValueError(f"bin_pairs: m_dummy {m_dummy}, {m} slots x {max(k, kc)} keys in {n_pad} pair columns")
    if not (0 < max(k, kc) <= BIN_MAX_SPAN and th > 0 and nty > 0 and ntx > 0):
        raise ValueError(f"bin_pairs: k={k}, kc={kc} (at most {BIN_MAX_SPAN}), tile rows {th}, grid {grid_hw}")
    stripe, n_stripes = bin_stripes(m, n_keys)
    counts = torch.empty((n_keys * n_stripes,), dtype=torch.int32, device=dev)
    totals = torch.empty((n_keys,), dtype=torch.int32, device=dev)
    ptri = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    recs = torch.empty((m * (-(-(12 + rows_f) // 8) * 8),), dtype=torch.int32, device=dev)  # a record a slot
    off = torch.empty((n_keys + 1,), dtype=torch.int32, device=dev)
    out_i32 = torch.empty((12, n_pad), dtype=torch.int32, device=dev)
    out_f32 = torch.empty((rows_f, n_pad), dtype=torch.float32, device=dev)
    params = BinParams(m=m, rows_f=rows_f, th=th, ntx=ntx, nty=nty, k=k, kc=kc, oy=int(origin[0]), ox=int(origin[1]),
                       m_dummy=m_dummy, n_pad=n_pad, stripe=stripe, n_stripes=n_stripes)
    lib = load_library()
    err = lib.fr_bin_pairs(params, tri_i32.data_ptr(), tri_f32.data_ptr(), counts.data_ptr(), totals.data_ptr(),
                           off.data_ptr(), ptri.data_ptr(), recs.data_ptr(), out_i32.data_ptr(), out_f32.data_ptr(),
                           _stream(dev))
    _check(lib, err, "fr_bin_pairs")
    _count(bin_pairs)
    return off, out_i32, out_f32


bin_pairs.launches = 0
