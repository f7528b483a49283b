"""The raster and shade stage's share of its roofline, %: the least time of
its work (the kind's ``per_frame``: for triangles, the screen-space
triangles at their least size, the touched texels, colour and depth
written once; the covered pixels' operations) over the device time a frame
of the kernels that ``stages/raster.txt`` assigns to it."""

from benchmark import roofline
from benchmark.layers.stages import seconds_a_frame


def read(run):
    s = seconds_a_frame(run, "raster")
    if s is None or run.peaks is None or "raster_bytes" not in run.work:
        return None
    return 100.0 * roofline.least_seconds(run.work["raster_bytes"], run.work["raster_ops"], run.peaks) / s
