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
