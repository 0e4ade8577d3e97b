"""Weights of the JAX package → the port's ``state_dict``.

``state_dict_from_jax(params, constants)`` takes the JAX PPNet's flax
variable trees as nested dicts of numpy arrays (the ``params`` and
``constants`` collections, e.g. as a checkpoint restores them) and
returns the state_dict of ``adlm_tpu_torch.models.ppnet.PPNet``, which
loads with ``strict=True``:

* conv kernels HWIO → OIHW (backbone, ASPP ``c0..c3``, add-on convs);
* frozen-BN constants ``gamma/beta/mean/var`` →
  ``bn.{weight,bias,running_mean,running_var}``;
* add-on ``conv{i}`` → ``add_on_layers.{2i}``, ``presigmoid_ln``
  ``scale/bias`` → ``add_on_layers.presigmoid_ln.{weight,bias}``;
* prototypes (P, C) → (P, C, 1, 1) plus the constant ``ones``;
* last layer (P, K) → ``last_layer.weight`` (K, P).

Without ``constants`` it maps a tree shaped like ``params`` alone onto
the port's parameter names, with the same transposes: a JAX gradient
tree becomes ``{name: grad}`` for ``model.named_parameters()``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_BN = {"gamma": "weight", "beta": "bias", "mean": "running_mean",
       "var": "running_var"}


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, Mapping):
        for k in tree:
            yield from _leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _tensor(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v).copy())


def _param_key(path: Tuple[str, ...]) -> Tuple[str, Tuple[int, ...]]:
    """(state_dict key, axis permutation) of one flax param leaf."""
    leaf = path[-1]
    if path[0] == "add_on":
        mod = path[1]
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
        if mod.startswith("conv"):
            mod = str(2 * int(mod[len("conv"):]))
        elif mod != "presigmoid_ln":
            raise KeyError(f"unknown add-on parameter {'/'.join(path)}")
        return f"add_on_layers.{mod}.{name}", ((3, 2, 0, 1) if leaf == "kernel" else ())
    if leaf == "kernel":
        return ".".join(path[:-1]) + ".weight", (3, 2, 0, 1)
    if leaf == "bias":
        return ".".join(path), ()
    raise KeyError(f"unknown parameter {'/'.join(path)}")


def state_dict_from_jax(params: Mapping[str, Any],
                        constants: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's PPNet state_dict from the JAX PPNet's variables; with
    ``constants=None``, the parameter entries only (e.g. of gradients)."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _leaves(params):
        if path == ("prototype_vectors",):
            out["prototype_vectors"] = _tensor(v[:, :, None, None])
            if constants is not None:
                out["ones"] = torch.ones(v.shape + (1, 1), dtype=torch.float32)
        elif path == ("last_layer",):
            out["last_layer.weight"] = _tensor(v.T)
        else:
            key, perm = _param_key(path)
            out[key] = _tensor(np.transpose(v, perm) if perm else v)
    for path, v in _leaves(constants or {}):
        if len(path) < 2 or path[-2] != "bn" or path[-1] not in _BN:
            raise KeyError(f"unknown constant {'/'.join(path)}")
        out[".".join(path[:-1]) + "." + _BN[path[-1]]] = _tensor(v)
    return out
