"""Carry parameters across from the JAX package.

``params_from_jax`` takes the nested dict of numpy arrays that
``jax.tree.map(np.asarray, params)`` gives and returns the port's
parameter dict on a device.  bfloat16 arrays (numpy's ``ml_dtypes``
extension type) are carried bit for bit: their ``uint16`` view becomes a
tensor that is reinterpreted as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dicts/lists of numpy arrays -> the same structure of
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return tensor_from_numpy(tree, device)
