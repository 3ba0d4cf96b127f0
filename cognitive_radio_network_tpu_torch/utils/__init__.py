"""Utilities: device selection and float32 precision control, the tic/toc
timer (src/timer.cc port), profiling helpers and the program's tracer."""

from cognitive_radio_network_tpu_torch.utils.device import full_f32, on_cuda
from cognitive_radio_network_tpu_torch.utils.profiling import device_time, drain, trace
from cognitive_radio_network_tpu_torch.utils.timer import Timer

__all__ = ["full_f32", "on_cuda", "Timer", "trace", "device_time", "drain"]
