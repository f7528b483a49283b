#!/usr/bin/env python3
"""The voxel ray set-up kernel's time split into its parts, on the card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/voxel_setup_split.py [--root DIR] [--reps N] [--probes d_whole ...]

Each probe is a copy of ``csrc/voxel_setup.cu`` (this checkout's, or that
of the checkout at ``--root``: a ``git archive`` of another commit unpacked
under ``_variants/``) with a few lines replaced, built alone with the port's
nvcc flags into a library of its own under
``f_renderer_tpu_torch/_build/voxel_split/`` (one nvcc a probe, all started
together), and launched through its C entry point ``fr_voxel_setup`` at
voxel540's size (960 x 540, length 2.0) on chip_smoke.py's 10 orbit views
and its five other set-up views (crafted, inside, face, edge, corner: the
last two send most rays past the shortcut). The probes:

- (a) stores: the eight planes written from the pixel's coordinates alone;
- (b) + unprojection: the direction planes, and nothing after them;
- (c) + pushes: the intersection's pushes, what they leave stored, no sort;
- (d) whole: the kernel as it is (its planes are checked against
  ``prepare_rays_plain``);
- (e) no sort: the whole kernel with the eight-slot sort never taken.

A probe leaves out work, so its planes differ from the kernel's: only its
time is read. Each probe's device time (``chip_smoke.device_ms``: launches
queued behind a spin kernel, CUDA events) is printed per view, with its
``ptxas -v`` line. Per view the tool also prints how many rays, and how
many warps of 32 pixels of a row, leave the shortcut for the eight-slot
path (``raycast.eight_slot_rays``, plain PyTorch). A probe whose lines are
not in the copy is reported and skipped.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# the kernel's stores, from values named as the probe's anchor leaves them
STORES = ("planes[i] = {0}; planes[n + i] = {1}; planes[2 * n + i] = {2}; planes[3 * n + i] = {3}; "
          "planes[4 * n + i] = {4}; planes[5 * n + i] = {5}; planes[6 * n + i] = {6}; alive[i] = {7}; return;\n")
UNPROJECT = "  // unprojection (_unproject_dir_planes)\n"
INTERSECT = "  // VoxelCube::intersect (_cube_intersect_planes)\n"
# Each probe: a list of (old, new) replacements, made where every old text
# is in the copy once.
PROBES = {
    "a_stores": [(UNPROJECT, "  {\n    const float fx = (float)px, fy = (float)py;\n    "
                  + STORES.format("fx", "fy", "fx", "fy", "fx", "fy", "fx", "(uint8_t)(px & 1)") + "  }\n" + UNPROJECT)],
    "b_unproject": [(INTERSECT, "  " + STORES.format("dx", "dy", "dz", "dx", "dy", "dz", "dx + dy",
                                                     "(uint8_t)(dz > 0.0f)") + INTERSECT)],
    "c_pushes": [("  // the two-slot pass's verdict",
                  "  " + STORES.format("s.x0", "s.y0", "s.z0", "s.x1", "s.y1", "s.z1", "(float)s.cnt", "(uint8_t)s.cnt")
                  + "  // the two-slot pass's verdict")],
    "d_whole": [],
    "e_no_sort": [("  if (eight) {", "  if (false) {")],
}


def patched(text: str, edits) -> str | None:
    """``text`` with ``edits`` made, or None unless each old text is in it
    once."""
    if not all(text.count(old) == 1 for old, _ in edits):
        return None
    for old, new in edits:
        text = text.replace(old, new)
    return text


def build_all(root: Path, probes) -> dict[str, Path]:
    """Each of ``probes``' sources written and built (all nvcc processes
    together) → {probe: its library}; a probe that does not apply is left
    out."""
    from f_renderer_tpu_torch import kernels

    csrc = root / "f_renderer_tpu_torch" / "csrc"
    base = (csrc / "voxel_setup.cu").read_text()
    out = REPO / "f_renderer_tpu_torch" / "_build" / "voxel_split"
    shutil.rmtree(out, ignore_errors=True)
    jobs = {}
    for name in probes:
        text = patched(base, PROBES[name])
        if text is None:
            print(f"[voxel_split] {name}: its lines are not in {csrc / 'voxel_setup.cu'}: skipped", flush=True)
            continue
        d = out / name
        d.mkdir(parents=True)
        shutil.copy(csrc / "kernels.h", d / "kernels.h")
        (d / "voxel_setup.cu").write_text(text)
        lib = d / "fr_voxel_setup.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(lib),
               str(d / "voxel_setup.cu")]
        jobs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, cmd, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{err}")
        for line in err.splitlines():
            if re.search(r"registers|stack frame", line):
                print(f"[voxel_split] {name} ptxas: {line.split(':', 1)[-1].strip()}", flush=True)
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO), help="the checkout whose csrc/voxel_setup.cu to split")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--probes", nargs="+", choices=list(PROBES), default=list(PROBES))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("voxel_setup_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from f_renderer_tpu_torch.voxel import raycast

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    root = Path(args.root).resolve()
    print(f"[voxel_split] root {root} ({smi})", flush=True)
    libs = build_all(root, args.probes)
    cfg = raycast.VoxelRenderConfig(width=cs.VOXEL_W, height=cs.VOXEL_H, level=cs.VOXEL_LEVEL, length=cs.VOXEL_LENGTH)
    w, h = cfg.width, cfg.height
    views = [(f"orbit{i}", *cs.voxel_view(i)) for i in range(cs.FRAMES)] + list(cs.setup_views())
    views = [(name, torch.from_numpy(eye).to(dev), torch.from_numpy(inv).to(dev)) for name, eye, inv in views]
    for name, eye, inv in views:
        eight = raycast.eight_slot_rays(eye, inv, cfg)
        warps = int(eight[:, : w - w % 32].reshape(h, -1, 32).any(-1).sum())
        print(f"[voxel_split] {name}: {int(eight.sum())} of {w * h} rays and {warps} of {h * (w // 32)} warps "
              f"leave the shortcut", flush=True)
    planes = torch.empty((7, h, w), dtype=torch.float32, device=dev)
    alive = torch.empty((h, w), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = ctypes.c_void_p
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.fr_voxel_setup.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ptr] * 5
        lib.fr_voxel_setup.restype = ctypes.c_int

        def launch(eye, inv, lib=lib):
            err = lib.fr_voxel_setup(w, h, cfg.length, eye.data_ptr(), inv.data_ptr(), planes.data_ptr(),
                                     alive.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"fr_voxel_setup ({name}): CUDA error {err}")

        times = []
        for view, eye, inv in views:
            launch(eye, inv)
            torch.cuda.synchronize()
            if name == "d_whole":
                got = (list(planes[:3]), list(planes[3:6]), planes[6], alive)
                ok, err = cs.planes_equal(got, raycast.prepare_rays_plain(eye, inv, cfg))
                cs.check(ok, f"{view}: the whole kernel's planes differ from the plain version's ({err})")
            times.append((view, [cs.device_ms(lambda: launch(eye, inv), args.reps) for _ in range(2)]))
        orbit = [sum(t) / 2 for v, t in times if v.startswith("orbit")]
        print(f"[voxel_split] {name}: orbit mean {sum(orbit) / len(orbit):.4f} ms; "
              + ", ".join(f"{v} {t[0]:.4f} / {t[1]:.4f}" for v, t in times) + f" ms (device; {smi})", flush=True)
    if cs.failures:
        print(f"voxel_setup_split: {len(cs.failures)} check(s) failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
