"""Built-in scenario controllers (ports of the reference's SC_* plug-ins)."""

from cognitive_radio_network_tpu_torch.controllers import template  # noqa: F401
