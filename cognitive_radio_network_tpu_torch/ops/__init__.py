"""Hand-written CUDA kernels for the hot paths, each beside its plain version.

``fused_sense_ct`` (CUDA C++, ``csrc/fused_sense_ct.cu``) replaces the
Pallas TPU kernel of ``cognitive_radio_network_tpu/ops/fused_sense_ct.py``;
``extract_windows`` (CUDA C++, ``csrc/extract_windows.cu``) replaces the one
of ``cognitive_radio_network_tpu/ops/extract.py``.  The other two TPU kernels
(``fused_wideband``, ``fused_sense``) are not ported yet.  Kernels build at
first launch, never at import.
"""

from cognitive_radio_network_tpu_torch.ops.extract import extract_windows, extract_windows_plain
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
    fused_sense_ct,
    fused_sense_ct_plain,
)

__all__ = ["extract_windows", "extract_windows_plain", "fused_sense_ct", "fused_sense_ct_plain"]
