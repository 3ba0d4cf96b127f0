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

Ported so far (the sense->classify main path, the OFDM link with its
fixed-config and adaptive streaming receivers, the one-device 64-channel
wideband detector, the scenario runtime in one process or one process per
node, classifier training on one device, and the operator tools):

signal    IQ layouts, DFT spectra, band features, the sigmoid MLP, detector,
          filter design, m-sequences, the polyphase channelizer, rational
          resampling
ops       ``fused_sense_ct``: 512-point FFT -> |X| -> mean over buffers ->
          band sums, squared; ``fused_sense_classify``: the same kernel with
          the MLP and the decision per cycle, and ``sense_trace`` (the retune
          trace); ``extract_windows``: K windows of two IQ
          planes at dynamic offsets; ``wideband_energy_fused``: polyphase
          FIR -> 64-point DFT -> power -> mean per sense cycle;
          ``fused_band_features``: the sense features alone, no spectrum
          written; ``resolve_candidates``: the stream step's greedy walk over
          frame candidates (CUDA kernels + plain versions)
models    ``SenseConfig``, ``sense_classify``, ``sense_classify_trace``,
          ``make_sense_fn``; ``TrainConfig``, ``make_dataset``, ``fit``
          (training); ``wideband_features``, ``make_sharded_train_step``,
          ``make_sharded_apply``
parallel  ``WidebandConfig``, ``wideband_energy_packed``, ``wideband_sense``,
          ``make_wideband_fn`` (one device)
phy       bits, CRC, FEC, modem, subcarrier allocations, ``OFDMFrameGen``,
          ``OFDMFrameSync`` (detect, demod, decode, block receive),
          ``StreamReceiver`` (per-frame configs from the PHY header; host and
          device-resident streaming), GMSK frames
env       Markov/random PU traces, scene synthesis, channel impairments,
          interferer waveforms
io        recorded-IQ captures, MLP checkpoints and training states (same
          file formats and keys)
tools     the headless spectrum analyzer (waterfall, PSD, live monitor)
utils     device selection, float32 control, the timer, profiling and the tracer
runtime   ``ScenarioRuntime``: configs, the simulated medium, radios, nodes,
          the control channel, logs; ``engines`` and ``controllers`` hold
          the cognitive engines and scenario controllers

Submodules are not imported here; import what you use.
"""

__version__ = "0.1.0"
