"""Build, bind and launch the hand-written CUDA kernels.

The sources live in ``csrc/``. At first use they are compiled with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, under
``_build/`` beside this file and named by a hash of the sources and flags
(an edited source builds anew). The library is loaded with ``ctypes``:
pointers and the stream go as ``c_void_p``. Each C entry point returns
``cudaGetLastError()`` after its launch, and the wrapper raises unless it is
0. Nothing here falls back to anything: a failed build or launch raises.

Each wrapper counts its launches (``fused_raster.launches``), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
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
    "-shared", "-Xcompiler", "-fPIC",
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


# Tile heights the kernel is instantiated for (rows per thread = th / 4).
SUPPORTED_TH = (4, 8, 16, 32, 64, 128)
MAX_CTX = 8


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
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.fr_fused_raster.argtypes = [FusedParams] + [ctypes.c_void_p] * 10
    lib.fr_fused_raster.restype = ctypes.c_int
    lib.fr_error_string.argtypes = [ctypes.c_int]
    lib.fr_error_string.restype = ctypes.c_char_p
    return lib


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


def fused_raster(
    off, tri_i32, tri_f32, view_pos, dims, texels, *,
    th, n_ctx, h_pad, w_pad, kind, opaque, bg_packed, light_pos, light_color,
):
    """Launch the fused raster + shade kernel (csrc/fused_raster.cu) on
    PyTorch's current stream → padded (rgba int32, depth f32, winner int32),
    each (h_pad, w_pad)."""
    dev = tri_i32.device
    if dev.type != "cuda":
        raise ValueError(f"fused_raster launches on CUDA tensors, got {dev}")
    if th not in SUPPORTED_TH or w_pad % 128 or h_pad % th:
        raise ValueError(f"tile ({th}, 128) over {h_pad}x{w_pad} is not supported")
    if not 0 < n_ctx <= MAX_CTX:
        raise ValueError(f"n_ctx={n_ctx}: the kernel carries 1..{MAX_CTX} varyings")
    n_pairs = tri_i32.shape[1]
    ntx, nty = w_pad // 128, h_pad // th
    n_off = ntx * nty + -(-ntx // 4) * -(-nty // 4) + 2
    _need(off, "off", torch.int32, dev, (n_off,))
    _need(tri_i32, "tri_i32", torch.int32, dev, (12, n_pairs))
    _need(tri_f32, "tri_f32", torch.float32, dev, (9 + 3 * n_ctx, n_pairs))
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fr_fused_raster(
        params,
        off.data_ptr(), tri_i32.data_ptr(), tri_f32.data_ptr(),
        view_pos.data_ptr(), dims.data_ptr(), texels.data_ptr(),
        rgba.data_ptr(), depth.data_ptr(), winner.data_ptr(), stream,
    )
    _check(lib, err, "fr_fused_raster")
    fused_raster.launches += 1
    return rgba, depth, winner


fused_raster.launches = 0
