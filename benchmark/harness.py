"""One run of one cell: set-up, warm-up, the measured window, the traced
window, the check against the reference, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name in files of its own: ``configs/<config>.json``
(through the manifest's ``file``), which names its kind,
``kinds/<kind>.py`` (the scene's inputs, the plain reference, the work
count) and its meshes' kinds, ``meshes/<kind>.py``; ``traffic/<mix>.json``,
which names its driver, ``drivers/<driver>.py``; and ``layers/<metric>.py``
(its reader).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "f_renderer_tpu"})
TRACE_SECONDS = 2.0  # the CUPTI-traced window of a --trace 1 run
WARM_UP_SECONDS = 1.0  # real frames after the first, before the window
SAMPLE_DRAWS = 1 << 20  # seeded draws of the frame sampler


class HarnessError(RuntimeError):
    """A run that cannot produce a result (no card, a module it must not load)."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file (a reader or driver, found by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """A manifest's workload with its configuration, traffic and metrics."""

    name: str
    chips: int
    config: dict
    kind: object  # kinds/<kind>.py, the config's "kind"
    traffic: dict
    end_to_end: list
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(manifest: dict, root: Path, name: str) -> Cell:
    """The cell ``name`` of ``manifest`` with its files read from ``root``."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise HarnessError(f"no workload {name!r}; the manifest has {sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    kind = importlib.import_module(f"benchmark.kinds.{config['kind']}")
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    return Cell(name, w["chips"], config, kind, traffic,
                [m for m in manifest["end_to_end"] if reports(m, name)],
                [m for m in manifest["per_layer"] if reports(m, name)])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one the
    benchmark must never load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


class Sampler:
    """A seeded reservoir of ``k`` frames of the window: every frame has the
    same chance to be kept, whatever the window's length."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.u = np.random.default_rng([seed, 7]).random(SAMPLE_DRAWS)
        self.seen = 0
        self.kept = {}  # frame index -> output

    def slot(self):
        """The slot the next frame of the window takes, or None."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = int(self.u[i % SAMPLE_DRAWS] * (i + 1))
        return j if j < self.k else None

    def keep(self, slot, index, output):
        self.kept = {k: v for k, v in self.kept.items() if v[0] != slot}
        self.kept[index] = (slot, output)


class Log:
    """A window's frames (request and completion times) and the host's
    spans (what it was doing: one at a time), on ``time.perf_counter``."""

    def __init__(self, sampler: Sampler | None = None):
        self.t_req, self.t_done = [], []
        self.spans = {}
        self.sampler = sampler

    def span(self, name, t0, t1):
        self.spans.setdefault(name, []).append((t0, t1))

    def wants(self):
        """The sampler's slot for the frame about to complete, or None."""
        return self.sampler.slot() if self.sampler is not None else None

    def frame(self, index, t_req, t_done, slot=None, output=None):
        """Frame ``index`` requested at ``t_req`` and complete at ``t_done``;
        ``output`` is kept where the sampler gave the frame a ``slot``."""
        self.t_req.append(t_req)
        self.t_done.append(t_done)
        if slot is not None:
            self.sampler.keep(slot, index, output)

    @property
    def frames(self) -> int:
        return len(self.t_done)

    def seconds(self) -> float:
        return self.t_done[-1] - self.t_req[0]

    def span_ms(self, name):
        """Mean duration of ``name``'s spans, ms; None where there are
        none."""
        s = self.spans.get(name)
        return float(np.mean([b - a for a, b in s]) * 1e3) if s else None


@dataclasses.dataclass
class Run:
    """What the per-layer readers read."""

    cell: Cell
    log: Log  # the measured window
    traced: Log | None  # the traced window
    trace: object  # cupti.Trace of the traced window
    work: dict  # the least work a frame, by the kind's per_frame
    peaks: dict | None


def e2e_metrics(log: Log, setup_s: float) -> dict:
    lat = (np.asarray(log.t_done) - np.asarray(log.t_req)) * 1e3
    return {
        "frame_ms": log.seconds() * 1e3 / log.frames,
        "frame_p95_ms": float(np.percentile(lat, 95)),
        "setup_s": setup_s,
    }


def device_info(torch, device, trace=None) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    if trace is not None:
        info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return info


@dataclasses.dataclass
class Session:
    """A cell's run: its seed, device and the scene inputs the harness made,
    which its driver is given, and the driver with the port's program."""

    cell: Cell
    seed: int
    device: object
    inputs: object
    phases: list
    driver: object = None


def start(manifest: dict, root: Path, name: str, seed: int, device: str = "cuda") -> Session:
    """Set-up: the cell's inputs from ``seed``, the port's program built from
    them, its first frame (which builds the kernels and captures) and a
    warm-up of real frames."""
    import torch

    cell = resolve(manifest, root, name)
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        raise HarnessError(f"cell {name} needs {cell.chips} CUDA device(s); "
                           f"cuda available: {torch.cuda.is_available()}")
    torch.set_num_threads(1)
    phases = [("imports", time.perf_counter())]
    traffic = cell.traffic
    inputs = cell.kind.scene_inputs(cell.config, seed, traffic)
    phases.append(("inputs", time.perf_counter()))
    session = Session(cell, seed, dev, inputs, phases)
    driver_mod = load_module(HERE / "drivers" / f"{traffic['driver']}.py", f"bench_driver_{traffic['driver']}")
    session.driver = driver = driver_mod.Driver(session)
    phases.append(("program", time.perf_counter()))
    driver.window(0.0, Log())
    phases.append(("first frame", time.perf_counter()))
    driver.window(WARM_UP_SECONDS, Log())
    phases.append(("warm-up", time.perf_counter()))
    return session


def measure(session: Session, seconds: float, trace: bool):
    """The measured window, then with ``trace`` the CUPTI-traced window →
    (log, traced log or None, trace or None)."""
    gc.collect()
    gc.freeze()
    log = Log(Sampler(session.cell.config["compare_frames"], session.seed))
    session.driver.window(seconds, log)
    traced = dtrace = None
    if trace and session.device.type == "cuda":
        from benchmark import cupti

        traced = Log()
        with cupti.Trace() as dtrace:
            session.driver.window(TRACE_SECONDS, traced)
        dtrace.label_gaps(traced)
    gc.unfreeze()
    return log, traced, dtrace


def finish(session: Session, log: Log):
    """Free the program's state, then the reference's frames of the sampled
    frames' inputs → (kept outputs {k: (frame, depth)}, cases {k: inputs})."""
    import torch

    kept = {k: out for k, (_, out) in sorted(log.sampler.kept.items())}
    cases = session.driver.reference_cases(sorted(kept))
    session.driver.release()
    session.driver = None
    gc.collect()
    if session.device.type == "cuda":
        torch.cuda.empty_cache()
    return kept, cases


def run_cell(manifest: dict, root: Path, name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda") -> tuple[dict, list[str]]:
    """One run of cell ``name`` → (the result line's object, the lines for
    standard error, the checks last). ``t0``: the process's start on
    ``time.perf_counter``."""
    import torch

    from benchmark import compare

    session = start(manifest, root, name, seed, device)
    cell, dev = session.cell, session.device
    log, traced, dtrace = measure(session, seconds, trace)
    setup_s = log.t_req[0] - t0
    info = device_info(torch, dev, dtrace)
    kept, cases = finish(session, log)
    checks, counts = compare.check_frames(cell.config, cell.kind, session.inputs, kept, cases, dev)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        raise HarnessError(f"modules the benchmark must not load are loaded: {found}")

    result = {"correct": correct, "attempted": log.frames, "failed": 0, "metrics": {}, "device": info}
    if not trace:
        values = e2e_metrics(log, setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        peaks = load_json(HERE / "peaks.json").get(info["kind"])
        work = cell.kind.per_frame(cell.config, cell.traffic, session.inputs, counts)
        run = Run(cell, log, traced, dtrace, work, peaks)
        for m in cell.per_layer:
            reader = load_module(HERE / "layers" / f"{m['name']}.py", f"bench_layer_{m['name']}")
            value = reader.read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if dtrace is not None:
            result["breakdown"] = dtrace.breakdown()
    result["checks"] = checks
    edges = [t0] + [t for _, t in session.phases]
    lines = ["set-up s: " + ", ".join(f"{n} {b - a:.3f}" for (n, _), a, b in zip(session.phases, edges, edges[1:]))]
    fifths = np.array_split(np.asarray(log.t_done), 5)
    lines.append(f"window: {log.frames} frames in {log.seconds():.3f} s; ms a frame by fifths: "
                 + ", ".join(f"{(f[-1] - f[0]) * 1e3 / max(len(f) - 1, 1):.4f}" for f in fifths if len(f)))
    if traced is not None:
        lines.append(f"traced window: {traced.frames} frames in {traced.seconds():.3f} s, "
                     f"busy {dtrace.busy_s:.6f} s of {dtrace.window_s:.6f} s")
    lines.append(f"frames compared: {sorted(kept)}; reference counts a frame {counts}")
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return result, lines


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or not math.isfinite(args.seconds) or args.seconds <= 0:
        print("--seed must be >= 0 and --seconds > 0", file=sys.stderr)
        return 2
    root = HERE.parent
    try:
        result, lines = run_cell(load_json(root / "BENCHMARK.json"), root, args.workload, args.seed,
                                 args.seconds, bool(args.trace), t0)
    except HarnessError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
