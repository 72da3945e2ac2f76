"""Runtime helpers: device resolution and float32 precision policy.

Counterpart of ``dvbs2rx_tpu/utils/runtime.py``. The JAX module's scoped-VMEM
``fec_jit`` and compilation-cache helpers are TPU workarounds with nothing
to port; what carries over is one place that decides the device and the
float32 contract.
"""

import torch


def exact_fp32():
    """Turn TF32 off for float32 matmuls and convolutions.

    PyTorch runs float32 convolutions through cuDNN in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits. The receiver's float paths are held to the JAX
    reference within float32 tolerances, and the BCH GF(2) products run as
    float32 matmuls whose 0/1 sums must stay exact (they are below 2^24, so
    full float32 is exact and TF32 is not). So both switches go off, the way
    the JAX package pins exact-f32 where it matters (``PARITY.md``).
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. ``None`` means ``"cuda"``; ``"cpu"`` is the only way to
    the CPU. A CUDA device without a usable card raises ``RuntimeError``
    (never a silent fall back to the CPU).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        exact_fp32()
    return dev


_DEVICE_TABLES = {}


def device_table(x, device):
    """The constant numpy table ``x`` as a tensor on ``device``, uploaded
    once. A host->device copy inside a step would synchronise the host with
    the card, so every constant the step uses comes through here. Keys are
    ids of long-lived numpy tables (module constants or lru-cached
    builders); each entry holds ``x`` itself so its id is never reused."""
    key = (id(x), str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = _DEVICE_TABLES[key] = (x, torch.as_tensor(x, device=device))
    return hit[1]
