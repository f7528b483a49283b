"""The comparison that decides ``correct``: each sampled frame of the
window against the plain reference's frame of the same inputs, which the
configuration's kind renders (``kinds/<kind>.py``: ``reference_frames``).

Two numbers, each the worst over the sampled frames, each with the limit
the configuration file states (``checks``):

- ``bad_px_pct``: the share of the frame's pixels, %, whose colour differs
  from the reference's by more than 2 in any channel (coverage, the
  winner, the varyings, the shading and the pack);
- ``depth_bad_pct``: the share of pixels, %, whose depth differs by more
  than ``DEPTH_RTOL`` of the reference's (the raster's winner and rhw).

A limit whose number the run did not compute (a frame kept without its
depth, a misspelt name) stops the run: nothing is judged on what was not
compared.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import HarnessError

COLOR_TOL = 2  # u8 steps: one for the pack's truncation, one for the sampler's rounding
DEPTH_RTOL = 1.0e-6  # about 8 float32 ulps


def numbers(frame, depth, ref_frame, ref_depth) -> dict:
    """The compared numbers of one frame (tensors or arrays)."""
    f = torch.as_tensor(frame).to(ref_frame.device).to(torch.int16)
    bad = (f - ref_frame.to(torch.int16)).abs().amax(-1) > COLOR_TOL
    out = {"bad_px_pct": 100.0 * float(bad.float().mean())}
    if depth is not None:
        d = torch.as_tensor(depth).to(ref_depth.device)
        off = ~((d - ref_depth).abs() <= DEPTH_RTOL * ref_depth.abs())  # NaN is off
        out["depth_bad_pct"] = 100.0 * float(off.float().mean())
    return out


def check_frames(config, kind, inputs, kept, cases, device):
    """``kept`` {k: (frame, depth)} against ``kind``'s reference frames of
    ``cases`` → (checks {name: {"value", "limit"}}, the reference's counts
    a frame, averaged)."""
    refs = kind.reference_frames(config, inputs, cases, device)
    worst = {}
    for k, (frame, depth) in kept.items():
        ref_frame, ref_depth, _ = refs[k]
        for name, value in numbers(frame, depth, ref_frame, ref_depth).items():
            worst[name] = max(worst.get(name, 0.0), value)
    limits = config["checks"]
    missing = sorted(set(limits) - set(worst))
    if not kept or missing:
        raise HarnessError(f"limits with no compared number: {missing or sorted(limits)}")
    checks = {name: {"value": worst[name], "limit": limits[name]} for name in limits}
    counts = {key: float(np.mean([r[2][key] for r in refs.values()])) for key in next(iter(refs.values()))[2]}
    return checks, counts
