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
- ``voxel_march`` — K5 (voxel/raycast_pallas.py:393).

Each wrapper counts its launches (``fused_raster.launches`` …), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
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


# Tile heights the raster kernels take (th / 8 thread blocks to a tile).
SUPPORTED_TH = (4, 8, 16, 32, 64, 128)
MAX_CTX = 8  # the fused kernel's varying cap (K4 has none)


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
    lib.fr_fused_raster.argtypes = [FusedParams] + [ptr] * 11
    lib.fr_raster_planes.argtypes = [i32] * 5 + [ptr] * 9
    lib.fr_sample_bilinear.argtypes = [ptr, ptr] + [i32] * 5 + [ptr] * 4 + [ctypes.c_int64, ptr]
    lib.fr_voxel_march.argtypes = [VoxelParams] + [ptr] * 13
    for fn in (lib.fr_fused_raster, lib.fr_raster_planes, lib.fr_sample_bilinear, lib.fr_voxel_march):
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
            m = re.search(r"\d([a-z_]+_kernel)(I[^E]*E)?", line.split("'")[1])
            name = m.group(1) + (f"<{m.group(2)[1:-1]}>" if m.group(2) else "") if m else line
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


def _tiles_scratch(ntx, nty, dev) -> torch.Tensor:
    """Scratch of the raster kernels: each tile's pair ranges, 8 int32 words
    a tile, heaviest tile first (written by their order pass)."""
    return torch.empty((ntx * nty, 8), dtype=torch.int32, device=dev)


def fused_raster(
    off, tri_i32, tri_f32, view_pos, dims, texels, *,
    th, n_ctx, h_pad, w_pad, kind, opaque, bg_packed, light_pos, light_color,
):
    """Launch the fused raster + shade kernel (csrc/fused_raster.cu) on
    PyTorch's current stream → padded (rgba int32, depth f32, winner int32),
    each (h_pad, w_pad)."""
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
    )
    rgba = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
    depth = torch.empty((h_pad, w_pad), dtype=torch.float32, device=dev)
    winner = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
    tiles = _tiles_scratch(ntx, nty, dev)
    stream = _stream(dev)
    err = lib.fr_fused_raster(
        params,
        off.data_ptr(), tri_i32.data_ptr(), tri_f32.data_ptr(),
        view_pos.data_ptr(), dims.data_ptr(), texels.data_ptr(),
        rgba.data_ptr(), depth.data_ptr(), winner.data_ptr(), tiles.data_ptr(), stream,
    )
    _check(lib, err, "fr_fused_raster")
    fused_raster.launches += 1
    return rgba, depth, winner


fused_raster.launches = 0


def raster_planes(off, tri_i32, tri_f32, *, th, n_ctx, h_pad, w_pad, interp):
    """Launch the non-fused raster kernel (csrc/raster_planes.cu) on PyTorch's
    current stream → padded (depth f32, winner int32) and, with ``interp``,
    (ps int32, ctx (n_ctx, h_pad, w_pad) f32); else None for both. Any C."""
    dev = _on_cuda(tri_i32, "raster_planes")
    ntx, nty = _check_bins(off, tri_i32, tri_f32, th, n_ctx, h_pad, w_pad)
    lib = load_library()
    depth = torch.empty((h_pad, w_pad), dtype=torch.float32, device=dev)
    winner = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
    ps = ctx = None
    if interp:
        ps = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
        ctx = torch.empty((n_ctx, h_pad, w_pad), dtype=torch.float32, device=dev)
    tiles = _tiles_scratch(ntx, nty, dev)
    err = lib.fr_raster_planes(
        th, ntx, nty, tri_i32.shape[1], n_ctx,
        off.data_ptr(), tri_i32.data_ptr(), tri_f32.data_ptr(),
        depth.data_ptr(), winner.data_ptr(),
        None if ps is None else ps.data_ptr(),
        None if ctx is None or n_ctx == 0 else ctx.data_ptr(),
        tiles.data_ptr(), _stream(dev),
    )
    _check(lib, err, "fr_raster_planes")
    raster_planes.launches += 1
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
    sample_bilinear.launches += 1
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
    voxel_march.launches += 1
    return out


voxel_march.launches = 0
