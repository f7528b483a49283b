"""Device ms a frame of the shading of K4's planes by a user's pixel shader
(``stages/shade.txt``: the sampler K3 and the PyTorch kernels that the
shader and the port's pack of its colour launch), from the traced window
(CUPTI)."""

from benchmark.layers.stages import seconds_a_frame


def read(run):
    s = seconds_a_frame(run, "shade")
    return None if s is None else s * 1e3
