"""Utilities: device selection and float32 precision control, timers
(src/timer.cc port) and profiling helpers."""

from cognitive_radio_network_tpu_torch.utils.device import full_f32, on_cuda
from cognitive_radio_network_tpu_torch.utils.profiling import device_time, drain, trace
from cognitive_radio_network_tpu_torch.utils.timer import LatencyRecorder, Timer

__all__ = ["full_f32", "on_cuda", "Timer", "LatencyRecorder", "trace", "device_time", "drain"]
