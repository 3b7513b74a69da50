"""digital_signal_processsing_tpu_torch: the DSP framework on PyTorch and CUDA.

The port of ``digital_signal_processsing_tpu`` (JAX on a TPU) to PyTorch on
an NVIDIA H100. It imports PyTorch and never JAX, nor the JAX package. So
far it holds the reference paper's one primitive end to end: WAV in, the
causal multi-channel moving average with every method of the reference
package, WAV out, bit-exact against the golden model.

- ``ops``      ``moving_average`` and its routes; the kernel wrappers
               (``ops/pallas_scan.py``, ``ops/pallas_direct.py``) and their
               plain versions (``ops/scan_xla.py``, ``ops/direct_xla.py``);
               the streaming averager
- ``csrc``     the hand-written CUDA kernels, built by ``_build.py`` at
               first use
- ``models``   the averager variant zoo
- ``serve``    WAV files through the chunked averager to a WAV
- ``harness``  phase-split timing with CUDA events; the 14-column CSV; the
               sweep driver
- ``golden``   the NumPy oracle
- ``io``       the WAV codec and chunk loader (NumPy only)
- ``utils``    numerics, shape arithmetic, dispatch records, device checks
- ``compat``   scipy.signal drop-in namespace: every public scipy.signal
               callable under its scipy name and signature, delegating to
               the port's ops (``from digital_signal_processsing_tpu_torch
               import compat as signal``)

A CUDA tensor always goes through its kernel, and a CPU tensor through the
plain PyTorch version; nothing moves between them on its own.
"""

__version__ = "0.1.0"

__all__ = ["io", "golden", "ops", "models", "harness", "utils", "serve", "compat"]
