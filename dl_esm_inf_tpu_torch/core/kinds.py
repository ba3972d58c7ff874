"""Precision policy for the PyTorch port.

The reference library pins everything to IEEE double precision
(``GO_WP``).  The port keeps the JAX package's configurable working
precision, as torch dtypes:

* ``float64`` — the validation precision (CPU tests, goldens).  The H100
  has native fp64, so the CUDA kernels take it too.
* ``float32`` — the performance precision on the GPU.
* ``bfloat16`` — for experiments on the plain path; reductions still
  accumulate in float32.

Select with :func:`set_working_precision` or the ``DL_ESM_DTYPE``
environment variable.  With neither, the default depends on the device
a grid lives on: float64 on the CPU, float32 on CUDA (:func:`wp`).
"""
from __future__ import annotations

import os

import torch

_DTYPE_NAMES = {
    "float64": torch.float64,
    "f64": torch.float64,
    "double": torch.float64,
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}

_working_dtype: torch.dtype | None = None


def _parse(name: str) -> torch.dtype:
    key = name.strip().lower()
    if key not in _DTYPE_NAMES:
        raise ValueError(
            f"working precision {name!r} not understood; expected one of "
            f"{sorted(_DTYPE_NAMES)}")
    return _DTYPE_NAMES[key]


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name (a
    numpy integer or bool dtype maps to its torch twin, for integer
    fields)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return _parse(dtype)
    import numpy as np
    dt = np.dtype(dtype)
    if dt.kind in "iub":
        return torch.from_numpy(np.empty(0, dt)).dtype
    return _parse(dt.name)


def set_working_precision(dtype) -> None:
    """Set the working precision (``go_wp`` analogue) for new grids.

    ``None`` restores the device-dependent default."""
    global _working_dtype
    _working_dtype = None if dtype is None else as_dtype(dtype)


def wp(device=None) -> torch.dtype:
    """The working-precision dtype for a grid on ``device``.

    Order of precedence: :func:`set_working_precision`, then
    ``DL_ESM_DTYPE``, then float64 on the CPU and float32 on CUDA."""
    if _working_dtype is not None:
        return _working_dtype
    env = os.environ.get("DL_ESM_DTYPE", "").strip()
    if env:
        return _parse(env)
    dev = torch.device(device if device is not None else "cpu")
    return torch.float32 if dev.type == "cuda" else torch.float64


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype for checksums and reductions of ``dtype`` data:
    float64 for float64 data, float32 otherwise (the reference's
    checksums are fp64; the f32 path states its tolerance)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def np_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch float dtype (host-side scatter)."""
    import numpy as np
    if dtype == torch.bfloat16:
        # numpy has no bfloat16: host arrays go through float32
        return np.dtype(np.float32)
    return np.dtype(str(dtype).removeprefix("torch."))
