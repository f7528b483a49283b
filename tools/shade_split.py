#!/usr/bin/env python3
"""Split phong1080_tex2048's frame and its shading into their kernels on the card.

phong1080_tex2048 (chip_smoke.py's scene: phong1080 with three 2048^2 maps,
past the fused path's routing limit, so K4 and then ``shade_from_planes``)
at the bench camera:

1. ``Scene.render()`` captures its graph; one replay runs under a CUPTI
   trace of the device (``chip_smoke.DeviceTrace``): its kernels, memsets
   and memcpys with their durations, the port's kernels (csrc/) summed
   apart from the rest (PyTorch's), and the replay's time untraced (CUDA
   events);
2. the shading alone, ``shade.shade_from_planes`` on K4's planes, run
   eagerly three times under the trace (each kernel's mean duration, their
   sum a run) and timed with CUDA events.

    python3 tools/shade_split.py [--root DIR]

``--root``: a checkout whose ``f_renderer_tpu_torch`` to run (a ``git
archive`` of another commit unpacked under ``_variants/``); it builds its own
kernels. The default is this checkout. On a checkout where the builtin
shading is PyTorch's ops and K3 the split lists those nodes; where it is one
kernel, that kernel.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), REPO]
    import torch

    import chip_smoke as cs
    from f_renderer_tpu_torch import compiled
    from f_renderer_tpu_torch.pipeline import raster, shade
    from f_renderer_tpu_torch.pipeline.render import build_packed, context_codec

    if not torch.cuda.is_available():
        print("shade_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = os.popen("nvidia-smi -i 0 --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(f"[shade_split] root {args.root} ({smi})", flush=True)
    scene = cs.build_scene("phong1080_tex2048", dev)
    cs.set_angle(scene, cs.ANGLES[0])
    port_names = cs.port_kernel_names()

    def report(tag, parts, ms):
        by_name = {}
        for part in parts:
            for start, end, name in part:
                n, us = by_name.get(name, (0, 0.0))
                by_name[name] = (n + 1, us + (end - start) / 1e3)
        runs = max(len(parts), 1)
        port = sum(us for name, (_, us) in by_name.items() if any(k in name for k in port_names)) / runs
        total = sum(us for _, us in by_name.values()) / runs
        records = sum(n for n, _ in by_name.values()) // runs
        print(f"[shade_split] {tag}: {records} records a run, device time summed {total:.1f} us: the port's kernels "
              f"(csrc/) {port:.1f} us, the rest (PyTorch's kernels, memsets, memcpys) {total - port:.1f} us; "
              f"{ms:.4f} ms a run (CUDA events, untraced; {smi})", flush=True)
        for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]:
            print(f"[shade_split]   {us / runs:9.2f} us  x{n // runs:<4d} {cs.demangle(name)}", flush=True)

    # 1. one replay of the captured frame
    scene.render()
    scene.render()
    frame = compiled.CACHE.last
    replay_ms = cs.cuda_ms(frame.replay, 10)
    with cs.DeviceTrace() as trace:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        frame.replay()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    report("phong1080_tex2048 Scene.render() one replay", cs.records_between_markers(trace.records), replay_ms)

    # 2. the shading alone, on K4's planes
    cfg = scene.config
    recs, bbox, n, c, _ = build_packed(scene.draws, scene.vertex_shader, scene.vs_uniform, cfg)
    prep = raster.bin_packed(recs, bbox, n, c, cfg.width, cfg.height, cfg.tile)
    ctx, ps, winner, _ = raster.interp_planes(prep)
    codec = context_codec(scene.vertex_shader, scene.vs_uniform, scene.draws[0])

    def shading():
        return shade.shade_from_planes(ctx, ps, winner, scene.pixel_shader, scene.ps_uniform, codec,
                                       background=cfg.background)

    for _ in range(3):
        shading()
    shade_ms = cs.cuda_ms(shading, 10)
    with cs.DeviceTrace() as trace:
        for _ in range(args.reps):
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            shading()
            torch.cuda.synchronize()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    report("phong1080_tex2048 shade_from_planes on K4's planes, eager", cs.records_between_markers(trace.records),
           shade_ms)
    compiled.CACHE.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
