"""The wideband sense pipeline on one device (port of
``cognitive_radio_network_tpu/parallel``).  The mesh, the halo exchange and
the sharded forms of the reference span several devices and are not part of
the one-device pipeline here."""

from cognitive_radio_network_tpu_torch.parallel.wideband import (
    WidebandConfig,
    make_wideband_fn,
    wideband_energy_packed,
    wideband_sense,
)

__all__ = ["WidebandConfig", "wideband_sense", "wideband_energy_packed", "make_wideband_fn"]
