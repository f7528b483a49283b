#!/usr/bin/env python3
"""The triangle set-up's time split into its device operations and its
first launch split by probe builds, on the card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/setup_split.py [--root DIR] [--scenes phong1080 stress4k] [--probes ...]

1. **A replay's operations.** phong1080's ``Scene.render()`` and
   ``prepare()`` are captured (chip_smoke.py's scene, the bench camera) and
   one replay of each runs under a CUPTI trace of the device
   (``chip_smoke.DeviceTrace``): every kernel, memset and memcpy in time
   order with its start and end (us from the replay's first record), its
   duration and the gap after it; the set-up's operations are marked. Then
   one replay of ``Scene.render()`` with 1 face of draw 0 moved through the
   near plane (``chip_smoke.clipped_draws``): the clip path's work.
2. **Launch 1 alone, by probes.** Each probe is a copy of
   ``csrc/tri_setup.cu`` (this checkout's, or that of the checkout at
   ``--root``, a ``git archive`` of another commit unpacked under
   ``_variants/``) with a few lines replaced, built alone with the port's
   nvcc flags under ``f_renderer_tpu_torch/_build/setup_split/`` (one nvcc
   a probe, all started together) and called through ``kernels.tri_setup``
   in place of the library's own set-up entry points, with the arguments
   ``build_packed`` gave it at each scene. The probes:

   - ``whole``: the file as it is (its records and bboxes are checked
     against the library's own launch);
   - ``stores``: no vertex stage (no uniforms, no attribute loads: each
     corner's clip position and varyings made from the face's index) and
     no draw search (every face of draw 0), then the rest as it is;
   - ``no_vertex``: no vertex stage, the draw search kept;
   - ``no_draw_of``: the vertex stage kept, every face of draw 0 (its local
     index clamped to that draw's faces);
   - ``no_tail``: no last block, no ticket (so neither the quirk nor the
     condition);
   - ``t32``, ``t64``: 32- and 64-thread blocks (the kernel's own: 128).

   A probe leaves out work, so its records differ from the kernel's: only
   its time is read. For each, the launch's own duration (the mean of its
   CUPTI kernel records over ``--reps`` runs) and ``chip_smoke.device_ms``
   of the wrapper's call (the accumulator's fill, where the wrapper makes
   one, and the launch, queued behind a spin kernel), with its ``ptxas -v``
   lines. A probe whose lines are not in the copy is reported and skipped.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SETUP_KERNELS = ("FillFunctor", "tri_setup_kernel", "set_condition_kernel", "tri_slots_kernel", "tri_quirk_kernel")
# a vertex stage's corner replaced by values made from the face's index
FAKE_CORNER = ("{ cl[v][0] = 1e-4f * (float)fl - 0.3f; cl[v][1] = 0.1f * (float)v - 0.1f; cl[v][2] = 0.5f; "
               "cl[v][3] = 1.0f; for (int c = 0; c < (NC > 0 ? NC : 1); ++c) vary[v][c] = 0.25f * (float)c; }")
NO_UNIFORMS = [("if constexpr (Kind != kPlanes) load_uniforms(", "if constexpr (false) load_uniforms(")]
NO_CORNER = [("vertex_corner<Kind>(in, u, n_ctx, d, fl, v, cl[v], vary[v]);", FAKE_CORNER)]
NO_DRAW_OF = [("const int d = draw_of(", "const int d = 0 * draw_of("),
              ("fl = i - draw[kFaceOff];", "fl = min(i, draw[kFaces] - 1);")]
# Each probe: a list of (old, new) replacements, made where every old text
# is in the copy once.
PROBES = {
    "whole": [],
    "stores": NO_UNIFORMS + NO_CORNER + NO_DRAW_OF,
    "no_vertex": NO_UNIFORMS + NO_CORNER,
    "no_draw_of": NO_DRAW_OF,
    "no_tail": [("  if (!last_block(acc)) return;\n", "  return;\n")],
    "t32": [("constexpr int kThreads = 128;", "constexpr int kThreads = 32;")],
    "t64": [("constexpr int kThreads = 128;", "constexpr int kThreads = 64;")],
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
    base = (csrc / "tri_setup.cu").read_text()
    out = REPO / "f_renderer_tpu_torch" / "_build" / "setup_split"
    shutil.rmtree(out, ignore_errors=True)
    jobs = {}
    for name in probes:
        text = patched(base, PROBES[name])
        if text is None:
            print(f"[setup_split] {name}: its lines are not in {csrc / 'tri_setup.cu'}: skipped", flush=True)
            continue
        d = out / name
        d.mkdir(parents=True)
        shutil.copy(csrc / "kernels.h", d / "kernels.h")
        (d / "tri_setup.cu").write_text(text)
        lib = d / "fr_tri_setup.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(lib),
               str(d / "tri_setup.cu")]
        jobs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, cmd, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{err}")
        kernel = None
        for line in err.splitlines():
            if "Compiling entry function" in line:
                kernel = re.search(r"\d([a-z_]+_kernel)(I\w*?E)?E?", line.split("'")[1])
                kernel = (kernel.group(1) + (kernel.group(2) or "")) if kernel else line
            elif kernel and re.search(r"registers|stack frame", line):
                print(f"[setup_split] {name} ptxas {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)
        libs[name] = lib
    return libs


class Probe:
    """The port's kernel library with the set-up's entry points (``fr_tri_setup*``)
    taken from a probe's library, their argument types as the port binds them."""

    def __init__(self, real, path):
        import ctypes

        self._real, self._probe = real, ctypes.CDLL(str(path))

    def __getattr__(self, name):
        if not name.startswith("fr_tri_setup"):
            return getattr(self._real, name)
        fn, bound = getattr(self._probe, name), getattr(self._real, name)
        fn.argtypes, fn.restype = bound.argtypes, bound.restype
        return fn


def written_columns(table, n_draws, m_pad):
    """The columns launch 1 writes: every column of a checkout whose launch
    takes its draw table as parameters (a tuple), else the path-A columns."""
    import torch

    if isinstance(table, (tuple, list)):
        return torch.arange(m_pad)
    face_off, faces, slot_base, _ = table.cpu().view(4, n_draws).tolist()
    return torch.cat([torch.arange(s, s + f) for s, f in zip(slot_base, faces)])


def replay_ops(cs, torch, tag, frame, smi):
    """One replay of ``frame`` (a captured ``GraphFrame``) under a device
    trace → each record in time order, the set-up's marked."""
    frame.replay()
    torch.cuda.synchronize()
    with cs.DeviceTrace() as trace:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        frame.replay()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    part = cs.records_between_markers(trace.records)[0]
    t0 = min(s for s, _, _ in part)
    setup = [r for r in part if any(k in r[2] for k in SETUP_KERNELS)]
    summed = sum(e - s for s, e, _ in setup) / 1e3
    spread = (max(e for _, e, _ in setup) - min(s for s, _, _ in setup)) / 1e3 if setup else 0.0
    print(f"[setup_split] {tag}: {len(part)} records, {len(setup)} of the set-up ({summed:.2f} us summed, first "
          f"start to last end {spread:.2f} us) ({smi})", flush=True)
    part = sorted(part)
    for k, (s, e, name) in enumerate(part):
        gap = (part[k + 1][0] - e) / 1e3 if k + 1 < len(part) else 0.0
        mark = "set-up" if any(key in name for key in SETUP_KERNELS) else "      "
        print(f"[setup_split]   {mark} {(s - t0) / 1e3:8.2f} .. {(e - t0) / 1e3:8.2f} us  {(e - s) / 1e3:6.2f} us, "
              f"gap after {gap:6.2f} us  {cs.demangle(name)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO), help="the checkout whose csrc/tri_setup.cu to split")
    ap.add_argument("--scenes", nargs="+", default=["phong1080", "stress4k"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--probes", nargs="+", choices=list(PROBES), default=list(PROBES))
    ap.add_argument("--no-replay", action="store_true", help="only the probes")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(REPO)]  # that checkout's package and chip_smoke.py
    import torch

    if not torch.cuda.is_available():
        print("setup_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from f_renderer_tpu_torch import compiled, kernels
    from f_renderer_tpu_torch.pipeline.render import build_packed

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[setup_split] root {root} ({smi})", flush=True)
    libs = build_all(root, args.probes)
    if not args.no_replay:
        scene = cs.build_scene("phong1080", dev)
        cs.set_angle(scene, cs.ANGLES[0])
        for tag, entry in (("phong1080 Scene.render()", scene.render), ("phong1080 prepare()", scene.prepare)):
            entry()
            entry()
            replay_ops(cs, torch, f"{tag} at the bench camera", compiled.CACHE.last, smi)
        base = scene.draws
        scene.draws = cs.clipped_draws(base, scene.vs_uniform, 1)
        scene.render()
        replay_ops(cs, torch, "phong1080 Scene.render() with 1 face of draw 0 clipped", compiled.CACHE.last, smi)
        scene.draws = base
        compiled.CACHE.clear()
        del scene
    load, first = kernels.load_library, kernels.tri_setup
    real = load()
    for name in args.scenes:
        scene = cs.build_scene(name, dev)
        cs.set_angle(scene, cs.ANGLES[0])
        seen = {}

        def spy(*a, **kw):
            seen["call"] = (a, kw)
            return first(*a, **kw)

        spy.launches = first.launches
        kernels.tri_setup = spy
        try:
            build_packed(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        finally:
            kernels.tri_setup, first.launches = first, spy.launches
        a, kw = seen["call"]
        want = first(*a, **kw)
        torch.cuda.synchronize()
        for probe, path in libs.items():
            kernels.load_library = lambda path=path: Probe(real, path)
            try:
                got = first(*a, **kw)
                torch.cuda.synchronize()
                if probe == "whole":  # the columns launch 1 writes: every slot, or (before) the faces'
                    cols = written_columns(a[0], kw["n_draws"], want[0].shape[0])
                    ok = (torch.equal(got[0][cols], want[0][cols]) and torch.equal(got[1][:, cols], want[1][:, cols])
                          and torch.equal(got[2], want[2]))
                    cs.check(ok, f"{name}: the whole probe's records or bboxes differ from the library's launch")
                with cs.DeviceTrace() as trace:
                    for _ in range(args.reps):
                        torch.cuda._sleep(1)
                        torch.cuda.synchronize()
                        first(*a, **kw)
                        torch.cuda.synchronize()
                    torch.cuda._sleep(1)
                    torch.cuda.synchronize()
                own = [(e - s) / 1e3 for s, e, k in trace.records if "tri_setup_kernel" in k]
                wrapper = [cs.device_ms(lambda: first(*a, **kw), args.reps) for _ in range(2)]
            finally:
                kernels.load_library = load
            print(f"[setup_split] {name} {probe}: launch 1 {sum(own) / max(len(own), 1):.2f} us (CUPTI, mean of "
                  f"{len(own)}; min {min(own, default=0):.2f}), the wrapper's call {wrapper[0] * 1e3:.2f} / "
                  f"{wrapper[1] * 1e3:.2f} us (device_ms) ({smi})", flush=True)
        del scene, want, seen
        torch.cuda.empty_cache()
    if cs.failures:
        print(f"setup_split: {len(cs.failures)} check(s) failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
