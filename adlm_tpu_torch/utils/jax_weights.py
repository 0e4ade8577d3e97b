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

``adam_state_from_jax(opt_state, model, cfg, phase)`` carries a JAX
training state's optimizer across: each trained group's optax
``ScaleByAdamState`` becomes the ``torch.optim.Adam`` state of the
group's parameters, keyed by parameter name (``count`` → ``step``,
``mu`` → ``exp_avg``, ``nu`` → ``exp_avg_sq``; ``mu`` and ``nu`` are
params-shaped trees, mapped as gradients are).  It is the by-name form
the port's checkpoints keep (``train/optimizer.py::adam_state_by_name``).

``unet_state_dict_from_jax(params, batch_stats)`` does the same for the
JAX U-Net of U-Noise (``down{i}``, ``up{k}``, ``head``) onto
``adlm_tpu_torch.models.unet.UNet``'s reference names; with
``batch_stats=None`` it maps a gradient tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

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


_ADAM_KEYS = {"count", "mu", "nu"}


def _adam_nodes(tree: Any) -> List[Mapping[str, Any]]:
    """Every mapping with exactly the keys of optax's ``ScaleByAdamState``
    in a nested-mapping optimizer state, in walk order."""
    if not isinstance(tree, Mapping):
        return []
    if set(tree) == _ADAM_KEYS:
        return [tree]
    return [node for k in tree for node in _adam_nodes(tree[k])]


def adam_state_from_jax(opt_state: Mapping[str, Any], model: torch.nn.Module,
                        cfg: Any, phase: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's by-name Adam state from the JAX optimizer state of a
    ``phase`` of ``cfg`` (an ``ExperimentConfig``) for ``model`` (the
    port's PPNet).

    ``opt_state`` is the optax state as nested mappings of numpy arrays
    (named tuples as ``{field: value}``, tuples as ``{"0": ..., ...}``,
    masked-out leaves as empty mappings).  Each ``ScaleByAdamState`` in
    it is one trained group; together they must cover exactly the
    parameters the port's optimizer trains in that phase.  Returns
    ``{name: {"step", "exp_avg", "exp_avg_sq"}}``."""
    from adlm_tpu_torch.train.optimizer import label_params, phase_groups

    trained_labels = phase_groups(cfg.train, phase)
    trained = {n for n, lab in label_params(model).items() if lab in trained_labels}
    params = dict(model.named_parameters())
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for node in _adam_nodes(opt_state):
        step = torch.tensor(float(np.asarray(node["count"])), dtype=torch.float32)
        mu, nu = state_dict_from_jax(node["mu"]), state_dict_from_jax(node["nu"])
        for name, m in mu.items():
            if name in out:
                raise ValueError(f"{name} is in two Adam states")
            shape = params[name].shape
            out[name] = {"step": step.clone(), "exp_avg": m.reshape(shape),
                         "exp_avg_sq": nu[name].reshape(shape)}
    if set(out) != trained:
        raise ValueError(
            f"the JAX Adam states cover {len(out)} parameters, the port's "
            f"phase {phase} trains {len(trained)}: missing "
            f"{sorted(trained - set(out))[:4]}, extra {sorted(set(out) - trained)[:4]}")
    return out


# U-Net: flax submodule → index in the reference's nn.Sequential
_UNET_SEQ = {"conv0": "0", "bn0": "1", "conv1": "3", "bn1": "4"}
_UNET_UP = {"up_conv": "1", "up_bn": "2"}
_UNET_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
              "mean": "running_mean", "var": "running_var"}


def _unet_key(path: Tuple[str, ...], depth: int) -> str:
    """state_dict key of one U-Net leaf (``up{k}`` is ``ups.{depth-2-k}``:
    the reference's ``ups[0]`` is the deepest level)."""
    top, leaf = path[0], _UNET_LEAF[path[-1]]
    if top == "head":
        return f"conv1x1.{leaf}"
    if top.startswith("down"):
        return f"downs.{top[4:]}.{_UNET_SEQ[path[1]]}.{leaf}"
    if top.startswith("up"):
        j = depth - 2 - int(top[2:])
        if path[1] == "conv":
            return f"ups.{j}.conv.{_UNET_SEQ[path[2]]}.{leaf}"
        return f"ups.{j}.up.{_UNET_UP[path[1]]}.{leaf}"
    raise KeyError(f"unknown U-Net leaf {'/'.join(path)}")


def unet_state_dict_from_jax(params: Mapping[str, Any],
                             batch_stats: Optional[Mapping[str, Any]] = None
                             ) -> Dict[str, torch.Tensor]:
    """The port U-Net's state_dict from the JAX U-Net's ``params`` and
    ``batch_stats`` (conv kernels HWIO → OIHW); with ``batch_stats=None``
    the parameter entries only (e.g. of gradients)."""
    depth = sum(1 for k in params if str(k).startswith("down"))
    out: Dict[str, torch.Tensor] = {}
    for path, v in list(_leaves(params)) + list(_leaves(batch_stats or {})):
        out[_unet_key(path, depth)] = _tensor(
            np.transpose(v, (3, 2, 0, 1)) if path[-1] == "kernel" else v)
    return out
