"""K4's share of its roofline on the planes path, %: the least time of its
job (the kind's ``per_frame``: the screen-space triangles read once, the
winner, depth and varying planes written once a pixel, the covered pixels'
raster and interpolation operations) over the device time a frame of the
kernels that ``stages/planes.txt`` assigns to it. None where the kind
counts no planes or the traced window ran none of those kernels."""

from benchmark import roofline
from benchmark.layers.stages import seconds_a_frame


def read(run):
    s = seconds_a_frame(run, "planes")
    if s is None or run.peaks is None or "planes_bytes" not in run.work:
        return None
    return 100.0 * roofline.least_seconds(run.work["planes_bytes"], run.work["planes_ops"], run.peaks) / s
