"""Scale-out: device meshes, overlap-save halo exchange, sharded pipelines
(port of ``cognitive_radio_network_tpu/parallel``).

The reference runs one compiled program over a ``jax.sharding.Mesh`` with
in-graph collectives; here one process per rank runs the ``shard_map`` body
of each sharded function, over ``torch.distributed`` process groups named by
a ``DeviceMesh`` (:mod:`.mesh`), with explicit collectives (:mod:`.collectives`:
ring shifts for FIR and frame halos, sums for gradients and decode windows).
:mod:`.multihost` starts the world, :mod:`.launch` runs a function on N local
ranks, :mod:`.phylink` holds the sharded OFDM receivers.  With no mesh the
wideband pipeline runs on one device.
"""

from cognitive_radio_network_tpu_torch.parallel.halo import halo_exchange, sharded_channelize
from cognitive_radio_network_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from cognitive_radio_network_tpu_torch.parallel.wideband import (
    WidebandConfig,
    make_wideband_fn,
    wideband_energy_packed,
    wideband_sense,
)

__all__ = [
    "make_mesh",
    "MeshSpec",
    "halo_exchange",
    "sharded_channelize",
    "WidebandConfig",
    "wideband_sense",
    "wideband_energy_packed",
    "make_wideband_fn",
]
