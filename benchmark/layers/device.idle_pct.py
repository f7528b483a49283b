"""The share of the measured window, %, in which no kernel, memcpy or
memset ran on the device: 1 less the device's busy time a frame (CUPTI,
over the traced window's frames) over the measured window's time a frame.

The traced window itself is not the denominator: CUPTI's activity tracing
slows a traced frame's host work (a phong1080 ``Scene.render()`` frame
~3.3 ms traced, ~0.36 untraced), so its own idle share reads the tracer's
cost. The device's busy time a frame does not move with it."""


def read(run):
    if run.trace is None or not run.traced.frames or run.trace.busy_s <= 0 or not run.log.frames:
        return None
    busy = run.trace.busy_s / run.traced.frames
    return 100.0 * (1.0 - busy / (run.log.seconds() / run.log.frames))
