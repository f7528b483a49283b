from f_renderer_tpu_torch.utils.metrics import FrameStats, StageTimer, profiler_trace  # noqa: F401
