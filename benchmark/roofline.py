"""A roofline's least time: the larger of bytes over the memory rate and
operations over the float32 rate, at the peaks of ``peaks.json``. The
work itself is counted by each configuration's kind (``kinds/<kind>.py``:
``per_frame``)."""


def least_seconds(nbytes: float, ops: float, peaks: dict) -> float:
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_ops_per_s"])
