"""The whole frame's device work as a share of its roofline, %: the least
time of the frame's work (the kind's ``per_frame``) over the device's busy
time a frame in the traced window (CUPTI). It bounds every kernel's share,
whatever kernels implement the frame."""

from benchmark import roofline


def read(run):
    if run.trace is None or run.peaks is None or not run.traced.frames or run.trace.busy_s <= 0:
        return None
    if "frame_bytes" not in run.work:
        return None
    busy = run.trace.busy_s / run.traced.frames
    return 100.0 * roofline.least_seconds(run.work["frame_bytes"], run.work["frame_ops"], run.peaks) / busy
