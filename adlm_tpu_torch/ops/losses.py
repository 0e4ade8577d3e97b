"""ProtoSeg losses (counterpart of ``adlm_tpu.ops.losses``).

* ``cross_entropy_ignore`` — per-patch CE with void masking (reference
  segmentation/module.py:156-165 drops void pixels before CE).
* ``kld_prototype_loss`` — the prototype-diversity loss as one masked
  log-softmax and one batched product, where the reference loops over
  images × classes × prototype pairs (module.py:167-208).
* ``masked_l1`` — L1 on off-class last-layer weights (module.py:213-218).
* ``bce_with_logits`` and ``dice_coeff`` — U-Noise's loss and metric
  (reference src/train_util.py:25-41, src/utils.py:2-12).

``groups=G`` splits the rows (CE) or images (KLD) into G equal
contiguous groups and averages the per-group means: the loss of the
fused-accumulation step, gradient-identical to averaging G microbatch
losses.

``count=`` gives the CE and KLD means their denominators from outside:
a data-parallel rank passes the counts summed over every rank's share
of the batch (``train/protoseg.py``), so that its local sum over that
count, summed over the ranks, is the mean over the global batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_F32 = torch.float32
_NEG_INF = -1e30


def ce_count(valid: torch.Tensor, groups: Optional[int] = None) -> torch.Tensor:
    """The valid positions of ``cross_entropy_ignore``: a 0-d count, or
    (G,) per group."""
    if groups is None:
        return valid.sum()
    return valid.reshape(groups, -1).sum(1)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         valid: Optional[torch.Tensor] = None,
                         groups: Optional[int] = None,
                         count: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean softmax cross-entropy over valid positions.

    Args:
      logits: (N, C) float.
      labels: (N,) int in [0, C); ignored where ``valid`` is False.
      valid: (N,) bool, or None for all-valid.
      groups: None for one mean over all valid positions, or G for the
        mean over G contiguous groups of each group's valid-mean.
      count: the denominator(s) in place of ``ce_count(valid, groups)``.

    Returns:
      (scalar loss, scalar n_correct): n_correct counts valid argmax hits
      (reference module.py:210-227).
    """
    logits = logits.to(_F32)
    n = logits.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=logits.device)
    safe = torch.clamp(labels.long(), 0, logits.shape[-1] - 1)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[:, None])[:, 0]
    ce = torch.where(valid, logz - ll, 0.0)
    n = ce_count(valid, groups) if count is None else count
    if groups is None:
        loss = ce.sum() / torch.clamp(n, min=1)
    else:
        g_sum = ce.reshape(groups, -1).sum(1)
        loss = (g_sum / torch.clamp(n, min=1)).mean()
    pred = torch.argmax(logits, dim=-1)
    n_correct = (valid & (pred == safe)).sum()
    return loss, n_correct


def kld_pair_count(labels: torch.Tensor, proto_class: torch.Tensor,
                   groups: Optional[int] = None) -> torch.Tensor:
    """The valid (image, class, pair) triples of ``kld_prototype_loss``
    from the labels alone: a 0-d count, or (G,) per group of images."""
    P = proto_class.shape[0]
    proto_class = proto_class.to(labels.device)
    pix = (labels[:, None, :] == proto_class[None, :, None]).sum(-1)   # (B, P)
    same = proto_class[:, None] == proto_class[None, :]
    upper = torch.triu(torch.ones(P, P, dtype=torch.bool, device=labels.device),
                       diagonal=1)
    partners = (same & upper).sum(1)                                  # (P,)
    per_image = ((pix >= 2) * partners).sum(1)                        # (B,)
    return per_image.sum() if groups is None else per_image.reshape(groups, -1).sum(1)


def kld_prototype_loss(activations: torch.Tensor, labels: torch.Tensor,
                       proto_class: torch.Tensor,
                       groups: Optional[int] = None,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric-KLD prototype-diversity loss.

    For each image and each class present in it, the activations of that
    class's prototypes over the class's pixels are distributions
    (log-softmax over pixels); each same-class prototype pair gives a
    symmetric KL divergence, and the loss is ``mean(exp(−KLD))`` over the
    valid (image, class, pair) triples.  A pair is valid when the image
    has ≥ 2 pixels of the class (reference module.py:185-189).

    Args:
      activations: (B, N, P) patch activations over flattened patches.
      labels: (B, N) int; a value matching no prototype class (void = −1)
        adds to no distribution.
      proto_class: (P,) class id per prototype.
      groups: None for one mean over the batch, or G for the mean over G
        contiguous groups of images of each group's pair-mean (0 for a
        group without a valid pair).
      count: the pair count(s) in place of this batch's own
        (``kld_pair_count``); a group whose count is 0 adds 0.

    Returns:
      scalar loss, 0.0 when no valid pair exists.
    """
    P = activations.shape[-1]
    acts = activations.to(_F32).transpose(1, 2)                   # (B, P, N)
    proto_class = proto_class.to(labels.device)
    mask = labels[:, None, :] == proto_class[None, :, None]      # (B, P, N)
    pix_count = mask.sum(-1)                                     # (B, P)

    ls = torch.log_softmax(torch.where(mask, acts, _NEG_INF), dim=-1)
    ls_safe = torch.where(mask, ls, 0.0)
    p = torch.where(mask, torch.exp(ls), 0.0)
    # H[b,j] = Σ_n p_j·ls_j, cross[b,j,i] = Σ_n p_j·ls_i
    ent = (p * ls_safe).sum(-1)                                  # (B, P)
    cross = torch.bmm(p, ls_safe.transpose(1, 2))                # (B, P, P)
    kld1 = ent[:, :, None] - cross            # KL(ls_i ‖ ls_j) at [j, i]
    sym = 0.5 * (kld1 + kld1.transpose(1, 2))

    same_class = proto_class[:, None] == proto_class[None, :]
    upper = torch.triu(torch.ones(P, P, dtype=torch.bool,
                                  device=labels.device), diagonal=1)
    valid = (same_class & upper)[None] & (pix_count[:, :, None] >= 2)
    pair_vals = torch.where(valid, torch.exp(-sym), 0.0)
    if groups is None:
        count = valid.sum() if count is None else count
        return torch.where(count > 0,
                           pair_vals.sum() / torch.clamp(count, min=1), 0.0)
    g_sum = pair_vals.reshape(groups, -1).sum(1)
    g_count = valid.reshape(groups, -1).sum(1) if count is None else count
    g_loss = torch.where(g_count > 0, g_sum / torch.clamp(g_count, min=1), 0.0)
    return g_loss.mean()


def masked_l1(last_layer_weight: torch.Tensor,
              proto_class: torch.Tensor) -> torch.Tensor:
    """L1 norm of the last-layer weights outside each prototype's own
    class; the weight is (P, K), the JAX package's layout (reference
    module.py:213-218 masks with ``1 − identityᵀ``)."""
    K = last_layer_weight.shape[1]
    own = proto_class.to(last_layer_weight.device)[:, None] == torch.arange(
        K, device=last_layer_weight.device)[None, :]
    mask = 1.0 - own.to(_F32)
    return (last_layer_weight.to(_F32) * mask).abs().sum()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    count: Optional[int] = None) -> torch.Tensor:
    """Mean binary cross-entropy with logits (torch ``BCEWithLogitsLoss``)
    in f32, in the stable form ``max(x, 0) − x·t + log1p(exp(−|x|))``.

    Its gradient is ``σ(x) − t`` at an exact-zero logit too: ``maximum``
    splits a tie's gradient in halves and ``abs`` has slope 0 at 0.  The
    JAX package's gives ``−t`` there (``jnp.abs`` has slope 1 at 0), which
    a ReLU-fed head with a zero bias meets (ROADMAP.md, Queue 3).

    ``count`` divides the sum instead of the element count (a rank's
    share of a global batch's mean)."""
    x = logits.to(_F32)
    t = targets.to(_F32)
    terms = (torch.maximum(x, x.new_zeros(())) - x * t
             + torch.log1p(torch.exp(-x.abs())))
    return terms.mean() if count is None else terms.sum() / count


def dice_coeff(pred: torch.Tensor, target: torch.Tensor,
               eps: float = 1e-10) -> torch.Tensor:
    """Global (batch-flattened) dice coefficient (reference src/utils.py:2-12)."""
    m1 = pred.to(_F32).reshape(-1)
    m2 = target.to(_F32).reshape(-1)
    return 2.0 * (m1 * m2).sum() / (m1.sum() + m2.sum() + eps)
