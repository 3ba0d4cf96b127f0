"""Utilities: device selection and float32 precision control."""

from cognitive_radio_network_tpu_torch.utils.device import full_f32, on_cuda

__all__ = ["full_f32", "on_cuda"]
