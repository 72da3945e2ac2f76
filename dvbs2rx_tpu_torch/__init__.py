"""dvbs2rx_tpu_torch — the PyTorch/CUDA port of ``dvbs2rx_tpu``.

The CCM stream receiver (IQ in, MPEG TS out) on one NVIDIA GPU. Module
names mirror the JAX package, which stays the reference: each port module
has one obvious counterpart there. The two Pallas kernels of the JAX
package are hand-written CUDA C++ kernels here (``csrc/``), built with
``nvcc`` at first use and loaded with ctypes (``_build.py``).

This package imports nothing of the JAX package, not even its numpy-only
modules: it keeps its own copies of the specification core (``spec/``),
of the native TS-stitch loader (``io/native.py``) and of the transmitter
(``tx/``), each held to its original by ``tests/test_torch_spec.py``. Only
the tests import both packages. Entry points run on the card
(``device=None`` means CUDA) unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
