"""Device ms a frame of the voxel march, K5 alone (``stages/march.txt``),
from the traced window (CUPTI): apart from the ray set-up, so that a
change to either shows on its own."""

from benchmark.layers.stages import seconds_a_frame


def read(run):
    s = seconds_a_frame(run, "march")
    return None if s is None else s * 1e3
