"""Host ms a frame from the call of the scene's entry point (``render()``
or ``render_prepared``) to its return, with no synchronise: keying, input
copies, the replay's or kernel's launch, output clones."""


def read(run):
    return run.log.span_ms("entry")
