#!/usr/bin/env python3
"""Split the triangle set-up and the binning into their kernels on the card.

For phong1080 and stress4k at the bench camera (chip_smoke.py's scenes),
``render.build_packed`` (the set-up kernels) and ``raster.bin_packed`` (the
binning kernels) run eagerly, three times each under a CUPTI trace of the
device (``chip_smoke.DeviceTrace``), with a spin kernel between runs; each
kernel's mean duration is printed, with the binning's device time
(``chip_smoke.device_ms``: launches queued behind a spin kernel) beside it.
Kernels launched by programmatic dependent launch start before the kernel
ahead of them ends, so their durations overlap; the device time is the
total.

    python3 tools/bin_split.py [--root DIR] [--scenes phong1080 stress4k]

``--root``: a checkout whose ``f_renderer_tpu_torch`` to run (a ``git
archive`` of another commit unpacked under ``_variants/``, or a copy with an
edited ``csrc/``); it builds its own kernels. The default is this checkout.
Works on checkouts whose ``build_packed`` returns packed rows and on those
that return slot records: its outputs go to ``bin_packed`` as they are.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--scenes", nargs="+", default=["phong1080", "stress4k"])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), REPO]
    import torch

    import chip_smoke as cs
    from f_renderer_tpu_torch.pipeline import raster
    from f_renderer_tpu_torch.pipeline.render import build_packed

    if not torch.cuda.is_available():
        print("bin_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = os.popen("nvidia-smi -i 0 --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(f"[bin_split] root {args.root} ({smi})", flush=True)
    for name in args.scenes:
        scene = cs.build_scene(name, dev)
        cs.set_angle(scene, cs.ANGLES[0])
        cfg = scene.config
        setup = (scene.draws, scene.vertex_shader, scene.vs_uniform, cfg)
        packed = build_packed(*setup)
        bins = (packed[0], packed[1], packed[2], packed[3], cfg.width, cfg.height, cfg.tile)
        kw = dict(tile_auto=cfg.tile_auto, tile_auto_threshold=cfg.tile_auto_threshold, bin_k=cfg.bin_k)
        for _ in range(3):
            raster.bin_packed(*bins, **kw)
        torch.cuda.synchronize()
        binning = [cs.device_ms(lambda: raster.bin_packed(*bins, **kw), 20) for _ in range(2)]
        for stage, run in (("set-up", lambda: build_packed(*setup)), ("binning", lambda: raster.bin_packed(*bins, **kw))):
            with cs.DeviceTrace() as trace:
                for _ in range(args.reps):
                    torch.cuda._sleep(1)
                    torch.cuda.synchronize()
                    run()
                    torch.cuda.synchronize()
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
            parts = cs.records_between_markers(trace.records)
            by_name = {}
            for part in parts:
                for start, end, kname in part:
                    n, us = by_name.get(kname, (0, 0.0))
                    by_name[kname] = (n + 1, us + (end - start) / 1e3)
            spans = [(max(e for _, e, _ in p) - min(s for s, _, _ in p)) / 1e3 for p in parts if p]
            whole = f"device time {binning[0]:.4f} / {binning[1]:.4f} ms (device_ms), " if stage == "binning" else ""
            print(f"[bin_split] {name} {stage}: {whole}trace span {sum(spans) / max(len(spans), 1):.1f} us a run "
                  f"({smi})", flush=True)
            for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
                print(f"[bin_split]   {us / len(parts):9.2f} us  x{n // len(parts):<3d} {cs.demangle(kname)}", flush=True)
        del scene, packed, bins
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
