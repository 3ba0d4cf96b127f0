"""cognitive_radio_network_tpu_torch — the PyTorch/CUDA port of the framework.

A second package beside the JAX reference ``cognitive_radio_network_tpu``,
for one NVIDIA H100.  Module names follow the reference's, so each module's
counterpart is found under the same path there.  Plain tensor code is
PyTorch; the TPU's Pallas kernels become CUDA C++ kernels for ``sm_90a``
(``csrc/``), built at first use and bound with ``ctypes`` (``ops/_build.py``).

The package imports ``torch`` and never ``jax``, and nothing of the
reference package, at run time.  Each kernel wrapper picks the kernel or its
plain PyTorch version by the device of the tensor it is given
(:mod:`.utils.device`).

Ported so far (the sense->classify main path and the fixed-config OFDM link):

signal    IQ layouts, DFT spectra, band features, the 4-5-3 MLP, detector,
          filter design, m-sequences
ops       ``fused_sense_ct``: 512-point FFT -> |X| -> mean over buffers ->
          band sums, squared; ``extract_windows``: K windows of two IQ
          planes at dynamic offsets (CUDA kernels + plain versions)
models    ``SenseConfig``, ``sense_classify``, ``sense_classify_trace``,
          ``make_sense_fn``
phy       bits, CRC, FEC, modem, subcarrier allocations, ``OFDMFrameGen``,
          ``OFDMFrameSync`` (detect, demod, decode, block receive)
env       Markov/random PU traces, scene synthesis, channel impairments
io        recorded-IQ captures and MLP checkpoints (same file formats)

Submodules are not imported here; import what you use.
"""

__version__ = "0.1.0"
