"""The voxel frame's share of its roofline, %: the least time of its work
(the kind's ``per_frame``: the frame written once, the table read once,
each ray's unprojection and intersection, each cell crossed's point
query) over the device time a frame of the kernels that
``stages/voxel.txt`` assigns to it (the ray set-up, the hit-bit pass and
the march). None where the kind counts no voxel work or the traced window
ran none of those kernels."""

from benchmark import roofline
from benchmark.layers.stages import seconds_a_frame


def read(run):
    s = seconds_a_frame(run, "voxel")
    if s is None or run.peaks is None or "voxel_bytes" not in run.work:
        return None
    return 100.0 * roofline.least_seconds(run.work["voxel_bytes"], run.work["voxel_ops"], run.peaks) / s
