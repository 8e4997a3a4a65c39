"""Parameters of the JAX package, as numpy arrays, → parameters of the port.

The JAX model's params are a pytree ``{"backbone": {...}, "nc": [{"w", "b"},
...]}``; turned into numpy (``jax.tree.map(np.asarray, params)``, done by
the caller) it is plain nested dicts and lists of arrays.  The port keeps
the same tree with three layout rules:

  * trunk conv weights (4-D ``"w"`` leaves under ``"backbone"``) go from
    HWIO to PyTorch's OIHW;
  * BatchNorm dicts and biases are kept as they are;
  * NC weights keep the JAX layout ``(k, k, k, k, C_in, C_out)``, which is
    the port's own, and a layer's ``"cp"`` factor dict (the CP tier's) is
    carried as it is.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch cannot wrap it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _convert_trunk(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: (_tensor(np.transpose(np.asarray(v), (3, 2, 0, 1)))
                    if k == "w" and np.ndim(v) == 4 else _convert_trunk(v))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert_trunk(v) for v in node]
    return _tensor(node)


def _convert_nc_layer(layer: dict) -> dict:
    out = {"w": _tensor(layer["w"]), "b": _tensor(layer["b"])}
    if "cp" in layer:  # the CP tier's factor dict, kept as it is
        out["cp"] = {k: _tensor(v) for k, v in layer["cp"].items()}
    return out


def params_from_numpy(tree: dict) -> dict:
    """The port's parameter tree (CPU tensors) from the JAX params as
    numpy arrays."""
    out = {"nc": [_convert_nc_layer(layer) for layer in tree["nc"]]}
    if "backbone" in tree:
        out["backbone"] = _convert_trunk(tree["backbone"])
    return out
