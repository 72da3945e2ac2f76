"""dvbs2rx_tpu_torch — the PyTorch/CUDA port of ``dvbs2rx_tpu``.

The CCM stream receiver (IQ in, MPEG TS out) on one NVIDIA GPU. Module
names mirror the JAX package, which stays the reference: each port module
has one obvious counterpart there. The two Pallas kernels of the JAX
package are hand-written CUDA C++ kernels here (``csrc/``), built with
``nvcc`` at first use and loaded with ctypes (``_build.py``).

This package never imports jax. It imports the JAX package's framework-free
layers only: ``dvbs2rx_tpu.spec``, ``dvbs2rx_tpu.io.native`` and
``dvbs2rx_tpu.tx``.
"""

__version__ = "0.1.0"
