"""Device ms a frame of the vertex stage, set-up and binning kernels
(``stages/setup.txt``), from the traced window (CUPTI)."""

from benchmark.layers.stages import seconds_a_frame


def read(run):
    s = seconds_a_frame(run, "setup")
    return None if s is None else s * 1e3
