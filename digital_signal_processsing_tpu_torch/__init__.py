"""digital_signal_processsing_tpu_torch: the DSP framework on PyTorch and CUDA.

The port of ``digital_signal_processsing_tpu`` (JAX on a TPU) to PyTorch on
an NVIDIA H100, with the same modules and public names. It imports PyTorch
and never JAX, nor the JAX package. Around the reference paper's primitive
(WAV in, the causal multi-channel moving average by every method of the
reference package, WAV out, bit-exact against the golden model) it holds the
reference package's whole signal-processing surface:

- ``ops``      the averager and its routes, FIR and overlap-save, FFT and
               spectral tools, the time-invariant and time-varying IIR
               families, designers, resamplers, channelizers, Farrow, LPC,
               correlation, 2-D, rank, wavelet, peak and LTI functions; the
               wrappers of the hand-written kernels and their plain PyTorch
               versions
- ``csrc``     the hand-written CUDA kernels, built by ``_build.py`` at
               first use
- ``models``   the averager variant zoo, the receiver chain, the wideband
               receiver, radar, tracking, modem, OFDM, beamforming and the
               adaptive filters and trainer
- ``parallel`` meshes over ``torch.distributed``: the time-sharded
               averager, FIR and filters, the ring kernels, pipelines and
               the sharded model and training steps
- ``serve``    WAV files through the chunked averager, IIR and spectral loops
- ``harness``  phase-split timing with CUDA events (and the reference's
               K-differential cross-check); the 14-column CSV; the sweep
- ``golden``   the NumPy oracle
- ``io``       the WAV codec, chunk loader and prefetch in NumPy, and the
               native C++ host path, built at first use
- ``utils``    numerics, shape arithmetic, dispatch records, device checks,
               checkpoints
- ``compat``   scipy.signal drop-in namespace: every public scipy.signal
               callable under its scipy name and signature, delegating to
               the port's ops (``from digital_signal_processsing_tpu_torch
               import compat as signal``)
- ``examples`` the reference's example scripts through the port's API

A CUDA tensor always goes through its kernel, and a CPU tensor through the
plain PyTorch version; nothing moves between them on its own. NumPy input
goes to the device an entry point's ``device`` names, ``cuda`` by default.
"""

__version__ = "0.1.0"

__all__ = ["io", "golden", "ops", "parallel", "models", "harness", "utils", "serve", "compat"]
