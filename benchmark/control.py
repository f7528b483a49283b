"""The readings that set each limit of ``correct``, on the card at each
cell's own size (not run by the benchmark's runs):

    python3 benchmark/control.py --cells stress4k-orbit,phong1080-orbit \
        --seeds 12 --control-seeds 3 --seconds 1 [--first-seed N]

For each cell and seed, in one process: the program's set-up and a short
window at the cell's own load, its sampled frames against the reference
(the lower readings); on the first ``--control-seeds`` seeds, the control,
the reference computed in bfloat16 put in the program's place (the upper
readings), and two faults planted in the program's frames: a 32 × 128 tile
of each frame left as background, and each frame replaced by another
sampled frame of the window (a step that returns an earlier state). One
JSON line a reading, then the largest and least of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import compare, harness  # noqa: E402

TILE = (32, 128)


def with_tile(frame, depth, background):
    """The frame with its first tile of rows 32 × 128 in the middle left as
    background (depth 0)."""
    f = torch.as_tensor(frame).clone()
    h, w = f.shape[:2]
    y, x = h // 2, w // 2
    f[y:y + TILE[0], x:x + TILE[1]] = torch.tensor(background, dtype=torch.uint8)
    if depth is None:
        return f, None
    d = torch.as_tensor(depth).clone()
    d[y:y + TILE[0], x:x + TILE[1]] = 0.0
    return f, d


def worst(pairs):
    out = {}
    for frame, depth, rf, rd in pairs:
        for k, v in compare.numbers(frame, depth, rf, rd).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def readings(manifest, root, cell, seed, seconds, control, device="cuda"):
    session = harness.start(manifest, root, cell, seed, device)
    config = session.cell.config
    log, _, _ = harness.measure(session, seconds, False)
    kept, cases = harness.finish(session, log)
    dev = session.device
    kind = session.cell.kind
    refs = kind.reference_frames(config, session.inputs, cases, dev)
    keys = sorted(kept)
    out = {"cell": cell, "seed": seed, "frames": log.frames, "compared": keys,
           "program": worst((*kept[k], *refs[k][:2]) for k in keys)}
    if control:
        low = kind.reference_frames(config, session.inputs, cases, dev, dtype=torch.bfloat16)
        out["control"] = worst((low[k][0], None if kept[k][1] is None else low[k][1], *refs[k][:2])
                               for k in keys)
        out["tile"] = worst((*with_tile(*kept[k], config["background"]), *refs[k][:2]) for k in keys)
        if len(keys) > 1:
            out["stale"] = worst((*kept[keys[i - 1]], *refs[keys[i]][:2]) for i in range(1, len(keys)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--first-seed", type=int, default=5_000_000_000)
    args = ap.parse_args()
    root = Path(__file__).resolve().parent.parent
    manifest = harness.load_json(root / "BENCHMARK.json")
    for cell in args.cells.split(","):
        rows = []
        for i in range(args.seeds):
            t = time.perf_counter()
            row = readings(manifest, root, cell, args.first_seed + i, args.seconds, i < args.control_seeds)
            row["seconds"] = time.perf_counter() - t
            rows.append(row)
            print(json.dumps(row), flush=True)
        summary = {"cell": cell}
        for what in ("program", "control", "tile", "stale"):
            vals = [r[what] for r in rows if what in r]
            if vals:
                summary[what] = {k: [min(v[k] for v in vals), max(v[k] for v in vals)] for k in vals[0]}
        print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())
