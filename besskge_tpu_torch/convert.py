"""Carry parameters between the JAX package and the port."""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from besskge_tpu_torch.utils import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(
    params: Dict[str, np.ndarray],
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """The port's params from the JAX package's, given as numpy arrays
    (``{k: np.asarray(v) for k, v in jax_params.items()}``), on ``device``
    (default ``cuda``). Values and dtypes are kept bit for bit; bfloat16
    arrays (numpy dtype ``bfloat16`` from ``ml_dtypes``) are carried by
    their bits."""
    device = resolve_device(device)
    out = {}
    for key, value in params.items():
        arr = np.ascontiguousarray(value)
        if arr.dtype.name == "bfloat16":
            tensor = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            tensor = torch.from_numpy(arr)
        out[key] = tensor.to(device)
    return out
