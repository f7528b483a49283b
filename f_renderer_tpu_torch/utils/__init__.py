from f_renderer_tpu_torch.utils.metrics import FrameStats, Recorder, Span, StageTimer, profiler_trace, tracing  # noqa: F401
