"""Device ms a frame in which some kernel, memcpy or memset ran (CUPTI),
over the traced window's frames. A frame's device work does not grow with
the tracer's own cost to the host, which slows a traced frame's
launches."""


def read(run):
    if run.trace is None or not run.traced.frames or run.trace.busy_s <= 0:
        return None
    return run.trace.busy_s / run.traced.frames * 1e3
