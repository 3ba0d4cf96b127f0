"""Hand-written CUDA kernels for the hot paths, each beside its plain version.

Each replaces one Pallas TPU kernel of ``cognitive_radio_network_tpu/ops``
(CUDA C++ for ``sm_90a``, sources under ``csrc/``):

``fused_sense_ct``         ``fused_sense_ct.py``  -> ``csrc/fused_sense_ct.cu``
``fused_sense_classify``   (the same kernel with the MLP and decision per cycle)
``extract_windows``        ``extract.py``         -> ``csrc/extract_windows.cu``
``extract_window_sets``    (the same kernel: up to four window sets a launch)
``wideband_energy_fused``  ``fused_wideband.py``  -> ``csrc/fused_wideband.cu``
``wideband_energy_fused_planes``  (the same kernel on interleaved planes)
``fused_band_features``    ``fused_sense.py``     -> ``csrc/fused_sense.cu``

Every TPU kernel of the reference has its counterpart here.  Three kernels
have no TPU counterpart: ``resolve_candidates`` (``csrc/resolve_candidates.cu``),
the adaptive stream step's greedy walk over its candidates, which the
reference runs as a ``lax.scan`` inside its step graph; ``sense_trace``
(in ``csrc/fused_sense_ct.cu``), the retune trace the reference's sense
pipeline runs as a ``lax.scan``; and ``viterbi_decode_k7``
(``csrc/viterbi_k7.cu``), the v27 decoder the reference runs as a
``lax.scan`` (``phy/fec.py``).  Kernels build at first launch, never at import.
"""

from cognitive_radio_network_tpu_torch.ops.extract import (
    extract_window_sets,
    extract_window_sets_plain,
    extract_windows,
    extract_windows_plain,
)
from cognitive_radio_network_tpu_torch.ops.fused_sense import (
    fused_band_features,
    fused_band_features_plain,
)
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
    fused_sense_classify,
    fused_sense_classify_plain,
    fused_sense_ct,
    fused_sense_ct_plain,
    sense_trace,
    sense_trace_plain,
)
from cognitive_radio_network_tpu_torch.ops.fused_wideband import (
    wideband_energy_fused,
    wideband_energy_fused_plain,
    wideband_energy_fused_planes,
    wideband_energy_fused_planes_plain,
)
from cognitive_radio_network_tpu_torch.ops.resolve import (
    resolve_candidates,
    resolve_candidates_plain,
)
from cognitive_radio_network_tpu_torch.ops.viterbi import viterbi_decode_k7, viterbi_decode_plain

__all__ = [
    "extract_window_sets",
    "extract_window_sets_plain",
    "extract_windows",
    "extract_windows_plain",
    "fused_band_features",
    "fused_band_features_plain",
    "fused_sense_classify",
    "fused_sense_classify_plain",
    "fused_sense_ct",
    "fused_sense_ct_plain",
    "resolve_candidates",
    "resolve_candidates_plain",
    "sense_trace",
    "sense_trace_plain",
    "viterbi_decode_k7",
    "viterbi_decode_plain",
    "wideband_energy_fused",
    "wideband_energy_fused_plain",
    "wideband_energy_fused_planes",
    "wideband_energy_fused_planes_plain",
]
