#!/usr/bin/env python3
"""Split the scene entry point's host time into the port's own spans, in the
benchmark's cells, on the card.

For each cell of ``BENCHMARK.json`` the benchmark's own set-up and driver
(``benchmark.harness.start``: the seed's inputs, the scene, its first frame
and a second of warm-up) run these windows in turn:

1. a measured window, ``--seconds``, with tracing off: the frame time the
   benchmark's ``frame_ms`` reads;
2. a spans window, ``--trace-seconds``, with ``utils.metrics.tracing()`` on
   and no CUPTI: the program's spans and counters, read into the
   ``entry.*`` numbers below; a full collection before and after it
   (``gc.collect``) gives the allocator's growth that no collection
   frees (``torch.cuda.memory_allocated``), and ``gc.get_stats`` the
   collections it ran;
3. ``--pairs`` rounds of two 1 s windows, tracing off and on, the order
   turned each round: the recorder's cost, the median frame time on
   against off;
4. a CUPTI window, ``--trace-seconds``, tracing on: each idle gap of the
   device named by the innermost span, the harness's or the program's,
   that covers most of it (:func:`label_gaps`), beside the benchmark's
   labels (outermost span, ``cupti.Trace.label_gaps``).

The numbers, from the spans window (:func:`split`), a frame, read from
the spans of the cell's entry point (``render``: ``graph.run``;
``render_prepared``: ``prepared.run``; ``voxel``: ``voxel.entry``, the
``VoxelRenderer`` call, whose child ``graph.run`` gives ``entry.graph_ms``
and the ``graph.*`` spans under it the numbers below): ``entry.key_ms``,
``entry.copy_ms``, ``entry.replay_ms``, ``entry.clone_ms``
(``graph.key``, ``graph.copy``, ``graph.replay``, ``graph.clone``),
``entry.inputs_ms``, ``entry.launch_ms``, ``entry.finish_ms``
(``prepared.inputs``, ``prepared.launch``, ``prepared.finish``),
``entry.self_ms`` (the entry point's span less its children),
``entry.copy_mb`` and ``entry.clone_mb`` (``graph.copy_bytes``,
``graph.clone_bytes``), ``entry.copy_skipped_pct`` (the bytes not
copied, ``graph.copy_skipped_bytes``, over ``graph.copy_bytes``),
``graph.captures`` (spans and CUPTI windows), ``graph.evictions``, and
``entry.held_kb``: the allocator's growth between the full collections
before and after the spans window, over its frames. The path of the
captured frame, counted on each call: ``graph.calls``,
``render.fused_frames``, ``render.planes_frames``,
``render.user_shader_frames``, ``render.pack_kernel_frames`` (totals
over the window),
``render.planes_c`` and ``render.planes_mb`` (``render.planes_varyings``
and ``render.planes_bytes`` a planes frame); and where a frame
ran eagerly under tracing (none does in a cell's windows, which replay),
``render.planes_ms`` and ``render.shade_ms`` (the spans ``render.planes``,
K4 and its planes, and ``render.shade``, the pixel shader and the pack).
Where a user's pixel shader ran, the compaction's tally
(``shade.compact_tally``, read with a synchronise at each end of the spans
window; :func:`compact_split`): ``render.compact_frames``, the frames on
each rung of the ladder and on the whole frame, ``render.shaded_pct``, the
pixels the shader ran on over the frames' pixels, and
``render.covered_pct``, the covered pixels over the frames' pixels.
Where the voxel raycaster ran: the total of ``voxel.rays``
(``raycast.march_frame``'s counter), and the march's work over the
traffic's turn of views (:func:`voxel_split`, by the port's plain march,
``raycast.march_plain(..., count_queries=True)``): ``voxel.alive_pct``,
the rays that meet the cube over the rays, ``voxel.queries_per_ray``, the
point queries over those rays, and ``voxel.hit_pct``, the rays that hit a
leaf over the rays.

    python3 tools/entry_split.py [--cells C ...] [--seed N] [--seconds S]

Each cell runs in a process of its own, as a benchmark run does: a CUPTI
window slows the host's later launches in its process. One JSON line a
cell on standard output, also appended to ``--out`` (default
``out/entry_split.jsonl``); a summary on standard error. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# a traffic's ``entry`` → its span
ROOT = {"render": "graph.run", "render_prepared": "prepared.run", "voxel": "voxel.entry"}
SPLIT = {  # an entry point's span → its children's numbers
    "graph.run": (("entry.key_ms", "graph.key"), ("entry.copy_ms", "graph.copy"),
                  ("entry.replay_ms", "graph.replay"), ("entry.clone_ms", "graph.clone")),
    "prepared.run": (("entry.inputs_ms", "prepared.inputs"), ("entry.launch_ms", "prepared.launch"),
                     ("entry.finish_ms", "prepared.finish")),
    "voxel.entry": (("entry.graph_ms", "graph.run"), ("entry.key_ms", "graph.key"), ("entry.copy_ms", "graph.copy"),
                    ("entry.replay_ms", "graph.replay"), ("entry.clone_ms", "graph.clone")),
}


PATH_COUNTERS = ("render.fused_frames", "render.planes_frames", "render.user_shader_frames",
                 "render.pack_kernel_frames")
RENDER_SPANS = (("render.planes_ms", "render.planes"), ("render.shade_ms", "render.shade"))  # eager frames only


def split(rec, root: str, captures: int | None = None) -> dict:
    """The ``entry.*`` numbers of a recorder's spans and counters under the
    entry point's span ``root``, each left out where the recorder holds
    nothing for it; spans of the other entry point (``prepared.*`` inside
    a capture's warm-up) are not read. ``captures``: the captures to
    report (default: the recorder's own)."""
    out = {}
    for metric, span in SPLIT[root]:
        v = rec.mean_ms(span)
        if v is not None:
            out[metric] = v
    v = rec.self_ms(root)
    if v is not None:
        out["entry.self_ms"] = v
    calls = rec.total("graph.calls")
    if calls:
        copied = rec.total("graph.copy_bytes")
        out["entry.copy_mb"] = copied / calls / 1e6
        out["entry.clone_mb"] = rec.total("graph.clone_bytes") / calls / 1e6
        if copied:
            out["entry.copy_skipped_pct"] = 100.0 * rec.total("graph.copy_skipped_bytes") / copied
        out["graph.captures"] = rec.total("graph.captures") if captures is None else captures
        out["graph.evictions"] = rec.total("graph.evictions")
        out["graph.calls"] = calls
        for name in PATH_COUNTERS:
            out[name] = rec.total(name)
        planes = rec.total("render.planes_frames")
        if planes:
            out["render.planes_c"] = rec.total("render.planes_varyings") / planes
            out["render.planes_mb"] = rec.total("render.planes_bytes") / planes / 1e6
    for metric, span in RENDER_SPANS:
        v = rec.mean_ms(span)
        if v is not None:
            out[metric] = v
    if rec.total("voxel.rays"):
        out["voxel.rays"] = rec.total("voxel.rays")
    return out


def compact_split(before, after) -> dict:
    """The compaction tally's growth between two readings
    (``shade.compact_tally``'s words) → ``render.compact_frames`` (frames by
    rung, "1/8" ... "6/8" and "whole"), ``render.shaded_pct`` and
    ``render.covered_pct``; empty where no frame was compacted."""
    from f_renderer_tpu_torch.pipeline.shade import RUNGS, WHOLE

    grown = [int(a) - int(b) for a, b in zip(after, before)]
    frames = grown[:WHOLE + 1]
    if not sum(frames):
        return {}
    covered, shaded, pixels = grown[WHOLE + 1:WHOLE + 4]
    return {"render.compact_frames": dict(zip([f"{k}/8" for k in RUNGS] + ["whole"], frames)),
            "render.shaded_pct": 100.0 * shaded / pixels, "render.covered_pct": 100.0 * covered / pixels}


def voxel_split(renderer, cases) -> dict:
    """The march's work over ``cases`` (dicts of ``eye`` and ``inv_mvp``)
    in ``renderer`` (a ``voxel.VoxelRenderer``), by the port's ray set-up
    and plain march (``count_queries``) on its device → ``voxel.alive_pct``,
    ``voxel.queries_per_ray`` (a ray that meets the cube) and
    ``voxel.hit_pct``; empty where no ray meets the cube."""
    import dataclasses

    import torch

    from f_renderer_tpu_torch.voxel import raycast

    # a hit's colour has alpha 255, so a background of 0 tells every hit apart
    k = dataclasses.replace(renderer.constants, bg_packed=0)
    rays = alive = queries = hits = 0
    for case in cases:
        eye, inv_mvp = (torch.as_tensor(case[n], dtype=torch.float32, device=renderer.device)
                        for n in ("eye", "inv_mvp"))
        start, dirs, t_max, live = raycast.prepare_rays(eye, inv_mvp, renderer.config)
        packed, q = raycast.march_plain(start, dirs, t_max, live, renderer.table, k, count_queries=True)
        rays += live.numel()
        alive += int(live.sum())
        queries += int(q.sum(dtype=torch.int64))
        hits += int((packed != 0).sum())
    if not alive:
        return {}
    return {"voxel.alive_pct": 100.0 * alive / rays, "voxel.queries_per_ray": queries / alive,
            "voxel.hit_pct": 100.0 * hits / rays}


def innermost(intervals):
    """Properly nested ``(t0, t1, name)`` intervals → the non-overlapping
    ``(t0, t1, name)`` segments that name, at each instant, the innermost
    interval covering it."""
    out, stack, cursor = [], [], None

    def emit(upto):
        if stack and upto > cursor:
            out.append((cursor, upto, stack[-1][2]))

    for iv in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        while stack and stack[-1][1] <= iv[0]:
            emit(stack[-1][1])
            cursor = max(cursor, stack.pop()[1])
        emit(iv[0])
        stack.append(iv)
        cursor = iv[0]
    while stack:
        emit(stack[-1][1])
        cursor = max(cursor, stack.pop()[1])
    return out


def label_gaps(trace, log, spans) -> list:
    """Each idle gap of a CUPTI ``trace`` named by the innermost span that
    covers most of it: the benchmark's host spans of ``log`` (seconds on
    ``time.perf_counter``) and the program's ``spans`` (``Recorder.spans``,
    ns on ``time.perf_counter_ns``), on the trace's clock; time in no span
    is the harness's own → [(name, seconds)], most first."""
    ivs = [(int(a * 1e9) + trace.offset_ns, int(b * 1e9) + trace.offset_ns, name)
           for name, items in log.spans.items() for a, b in items]
    ivs += [(t0 + trace.offset_ns, t1 + trace.offset_ns, name) for name, _, _, t0, t1 in spans]
    segs = innermost(ivs)
    edges = [trace.open] + [x for iv in trace.busy for x in iv] + [trace.close]
    totals, i = {}, 0
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge <= gs:
            continue
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        cover, j = {"harness": ge - gs}, i
        while j < len(segs) and segs[j][0] < ge:
            ov = min(ge, segs[j][1]) - max(gs, segs[j][0])
            cover[segs[j][2]] = cover.get(segs[j][2], 0) + ov
            cover["harness"] -= ov
            j += 1
        label = max(cover, key=cover.get)
        totals[label] = totals.get(label, 0) + (ge - gs)
    return sorted(((k, v / 1e9) for k, v in totals.items()), key=lambda kv: -kv[1])


def ms_a_frame(log) -> float:
    return log.seconds() * 1e3 / log.frames


def split_cell(manifest, name: str, seed: int, seconds: float, trace_seconds: float, pairs: int,
               device: str = "cuda") -> tuple[dict, list[str]]:
    """The windows above in cell ``name`` → (its JSON object, summary lines)."""
    import torch

    from benchmark import harness
    from f_renderer_tpu_torch.pipeline import shade
    from f_renderer_tpu_torch.utils import metrics

    session = harness.start(manifest, Path(REPO), name, seed, device)
    drive, root = session.driver.window, ROOT[session.driver.entry]
    gc.collect()
    gc.freeze()
    measured = harness.Log()
    drive(seconds, measured)
    cuda = session.device.type == "cuda"
    allocated = (lambda: torch.cuda.memory_allocated(session.device)) if cuda else (lambda: 0)
    gc.collect()
    held0, gc0 = allocated(), [g["collections"] for g in gc.get_stats()]
    spans_log = harness.Log()
    tally = shade.compact_tally(session.device)  # made here where no frame compacts: it stays 0

    def read_tally():
        if cuda:
            torch.cuda.synchronize(session.device)
        return tally.tolist()

    tally_before = read_tally()
    with metrics.tracing() as rec:
        drive(trace_seconds, spans_log)
    tally_after = read_tally()
    collections = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    gc.collect()
    held_kb = (allocated() - held0) / spans_log.frames / 1e3
    off, on = [], []
    for r in range(pairs):  # off then on, on then off, ...
        for side, tracing in ((off, False), (on, True))[::1 if r % 2 == 0 else -1]:
            log = harness.Log()
            with metrics.tracing() if tracing else contextlib.nullcontext():
                drive(1.0, log)
            side.append(ms_a_frame(log))
    traced = gaps = old_gaps = None
    captures = rec.total("graph.captures")
    if cuda:
        from benchmark import cupti

        traced = harness.Log()
        with metrics.tracing() as rec_t:
            with cupti.Trace() as dtrace:
                drive(trace_seconds, traced)
        captures += rec_t.total("graph.captures")
        gaps = label_gaps(dtrace, traced, rec_t.spans)
        dtrace.label_gaps(traced)
        old_gaps = dtrace.gaps
    gc.unfreeze()
    march = {}
    if root == "voxel.entry":
        turn = range(session.cell.traffic["turn_steps"])
        march = voxel_split(session.driver.renderer, session.driver.reference_cases(turn).values())
    session.driver.release()
    session.driver = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    got = split(rec, root, captures)
    got.update(compact_split(tally_before, tally_after))
    got.update(march)
    if cuda:
        got["entry.held_kb"] = held_kb
    entry = spans_log.span_ms("entry")
    parent = {n: p for n, p, _, _, _ in rec.spans}
    children = [m for m, span in SPLIT[root] if m in got and parent.get(span) == root]
    total = sum(got[m] for m in children) + got["entry.self_ms"] if "entry.self_ms" in got else None
    cost = {"off_ms": statistics.median(off), "on_ms": statistics.median(on)} if pairs else {}
    if cost:
        cost["pct"] = 100.0 * (cost["on_ms"] / cost["off_ms"] - 1.0)
    result = {
        "cell": name, "seed": seed, "device": harness.device_info(torch, session.device)["kind"],
        "frame_ms": ms_a_frame(measured), "spans_frame_ms": ms_a_frame(spans_log),
        "entry_ms": entry, "split_sum_ms": total, "metrics": got, "cost": cost,
        "pairs": {"off": off, "on": on}, "dropped": rec.dropped, "spans": len(rec.spans),
        "frames": spans_log.frames, "idle_gaps": gaps, "idle_gaps_outermost": old_gaps,
        "gc_collections": collections,
    }
    lines = [f"{name}: spans window {result['spans_frame_ms']:.4f} ms a frame (measured window "
             f"{result['frame_ms']:.4f}); entry {entry} ms, the split's sum {total} ms"]
    if cost:
        lines.append(f"{name}: recorder off {cost['off_ms']:.4f}, on {cost['on_ms']:.4f} ms a frame "
                     f"({cost['pct']:+.2f}%, medians of {pairs} pairs of 1 s windows)")
    lines += [f"{name}: {k} {v!r}" for k, v in got.items()]
    lines.append(f"{name}: spans window's collections by generation {collections}")
    if gaps is not None:
        lines.append(f"{name}: idle gaps innermost {gaps}; outermost {old_gaps}")
    return result, lines


def main() -> int:
    from benchmark import harness

    manifest = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=[w["name"] for w in manifest["workloads"]])
    ap.add_argument("--seed", type=int, default=2**31 + 12345)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace-seconds", type=float, default=harness.TRACE_SECONDS)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(REPO, "out", "entry_split.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("entry_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = os.popen("nvidia-smi -i 0 --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(f"[entry_split] {smi}", file=sys.stderr, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if len(args.cells) > 1:  # a process a cell
        rcs = [subprocess.run([sys.executable, __file__, "--cells", name, "--seed", str(args.seed + i),
                               "--seconds", str(args.seconds), "--trace-seconds", str(args.trace_seconds),
                               "--pairs", str(args.pairs), "--out", args.out]).returncode
               for i, name in enumerate(args.cells)]
        return max(rcs)
    for name in args.cells:
        t0 = time.perf_counter()
        result, lines = split_cell(manifest, name, args.seed, args.seconds, args.trace_seconds, args.pairs)
        result["power"] = smi
        for line in lines + [f"{name}: {time.perf_counter() - t0:.1f} s"]:
            print(line, file=sys.stderr, flush=True)
        print(json.dumps(result), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
