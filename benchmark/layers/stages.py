"""The kernels a stage's name file (``stages/<stage>.txt``) assigns to it."""

from pathlib import Path


def patterns(stage: str) -> tuple:
    lines = (Path(__file__).parent / "stages" / f"{stage}.txt").read_text().splitlines()
    return tuple(s.strip() for s in lines if s.strip() and not s.startswith("#"))


def seconds_a_frame(run, stage: str):
    """Device seconds a frame of the stage's kernels in the traced window;
    None where the stage ran nothing there."""
    if run.trace is None or not run.traced.frames:
        return None
    s = run.trace.seconds(patterns(stage))
    return s / run.traced.frames if s > 0 else None
