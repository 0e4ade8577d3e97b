"""Prototype pruning by nearest-patch class purity (counterpart of
``adlm_tpu.interpret.prune``).

Reference flow (reference prune.py:11-63, segmentation/run_pruning.py):
find each prototype's k = 6 nearest training patches, count those
labelled with the prototype's own class, and prune the prototypes with
fewer than ``prune_threshold = 3`` own-class neighbours.  The pruned
model is then finetuned through the ``--pruned`` train path.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

from adlm_tpu_torch.core.device import DeviceLike
from adlm_tpu_torch.interpret.nearest import find_k_nearest_patches
from adlm_tpu_torch.models.ppnet import prune_params


def prune_by_purity(
    model: nn.Module,
    proto_class,
    dataset: Iterable[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    k: int = 6,
    prune_threshold: int = 3,
    log=print,
    batch_size: int = 1,
    raw_normalize=None,
    device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, np.ndarray]:
    """Returns (state_dict, proto_class, prune_info), on ``device``
    (default the card).  The state dict keeps the surviving prototypes
    and loads with ``strict=True`` into a PPNet with that many;
    ``prune_info`` rows are [pruned_index, class] (reference
    prune.py:47-60)."""
    nearest_ids = find_k_nearest_patches(
        model, proto_class, dataset, num_classes, k=k,
        batch_size=batch_size, raw_normalize=raw_normalize, device=device)

    pc_t = torch.as_tensor(proto_class)
    pc = pc_t.cpu().numpy()
    P = pc.shape[0]
    to_prune = [j for j in range(P)
                if int(np.sum(nearest_ids[j] == pc[j])) < prune_threshold]
    keep = sorted(set(range(P)) - set(to_prune))
    log(f"prune: k={k} threshold={prune_threshold} — pruning "
        f"{len(to_prune)}/{P} prototypes")
    if not keep:
        raise ValueError("pruning would remove every prototype")

    prune_info = np.asarray([[j, pc[j]] for j in to_prune], dtype=np.int64
                            ).reshape(-1, 2)
    new_sd, new_pc = prune_params(model.state_dict(), pc_t, keep)
    return new_sd, new_pc, prune_info
