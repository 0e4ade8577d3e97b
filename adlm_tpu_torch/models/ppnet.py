"""PPNet: prototype classification head over a feature backbone
(counterpart of ``adlm_tpu.models.ppnet``; reference model.py:40-418).

State-dict keys are the reference's: ``features.base.*`` (DeepLabV2
inside the MSC wrapper) or ``features.*`` with a classification stem's
torchvision names (``models/backbones.py``), ``add_on_layers.{2i}.*``, ``prototype_vectors``
(P, C, 1, 1), ``last_layer.weight`` (K, P) and the constant ``ones``
buffer (P, C, 1, 1) of the reference's L2 convolution (model.py:140),
so a state_dict exported from the JAX package loads with
``strict=True``.

``forward`` takes NCHW images and returns the JAX package's channels-
last outputs: logits (B, h, w, K) and distances (B, h, w, P).  With
the backbone in ``torch.channels_last`` the (B, h, w, C) feature view
the head reads is contiguous, and so are the distances the upsampled
statistics read.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.models.backbones import (
    backbone_out_channels,
    build_classification_backbone,
    reset_stem,
)
from adlm_tpu_torch.models.deeplab import MSC, DeepLabV2
from adlm_tpu_torch.ops.prototype import distance_to_similarity, prototype_head

Head = Tuple[torch.Tensor, Optional[torch.Tensor]]


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (flax's default
    epsilon 1e-6), the ``presigmoid_ln`` of the JAX package."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


def build_add_on_layers(kind: str, in_channels: int, proto_channels: int,
                        bottleneck_stride: Optional[int] = None,
                        presigmoid_ln: bool = False) -> nn.Sequential:
    """The add-on 1x1 conv stack between backbone and prototypes
    (reference model.py:97-136).  Convs sit at even indices of the
    Sequential, as in the reference; ``presigmoid_ln`` adds a LayerNorm
    named ``presigmoid_ln`` right before the final sigmoid."""
    seq = nn.Sequential()

    def add(m: nn.Module) -> None:
        seq.add_module(str(len(seq)), m)

    def sigmoid(ch: int) -> None:
        if presigmoid_ln:
            seq.add_module("presigmoid_ln", ChannelLayerNorm(ch))
        add(nn.Sigmoid())

    if kind == "deeplab_simple":
        sigmoid(in_channels)
        return seq

    idx = 0
    ch = in_channels
    if kind == "bottleneck_pool":
        add(nn.Conv2d(ch, ch, 3, stride=bottleneck_stride, padding=1))
        add(nn.ReLU())
        idx += 1

    if kind.startswith("bottleneck"):
        cur_in = in_channels
        first = True
        while cur_in > proto_channels or (first and idx == 0):
            first = False
            cur_out = max(proto_channels, cur_in // 2)
            add(nn.Conv2d(ch, cur_out, 1))
            add(nn.ReLU())
            add(nn.Conv2d(cur_out, cur_out, 1))
            idx += 2
            ch = cur_out
            if cur_out > proto_channels:
                add(nn.ReLU())
            else:
                sigmoid(ch)
            cur_in = cur_in // 2
        return seq

    if kind != "regular":
        raise ValueError(f"unknown add_on_layers_type {kind!r}")
    add(nn.Conv2d(in_channels, proto_channels, 1))
    add(nn.ReLU())
    add(nn.Conv2d(proto_channels, proto_channels, 1))
    sigmoid(proto_channels)
    return seq


def build_backbone(cfg: PPNetConfig) -> nn.Module:
    """Backbone registry (reference model.py:19-36): the DeepLabV2 family
    inside its MSC wrapper, or a classification stem
    (``models/backbones.py``)."""
    if cfg.base_architecture == "deeplabv2_resnet101":
        base = DeepLabV2(out_features=cfg.deeplab_n_features,
                         n_blocks=tuple(cfg.deeplab_n_blocks),
                         atrous_rates=tuple(cfg.atrous_rates),
                         s2b_dilated=cfg.dilated_space_to_batch)
        return MSC(base=base, scales=tuple(cfg.msc_scales))
    return build_classification_backbone(cfg.base_architecture)


def add_on_in_channels(cfg: PPNetConfig) -> int:
    """Channels the backbone hands the add-on stack: DeepLab's ASPP
    width, or the classification stem's output width."""
    if cfg.base_architecture == "deeplabv2_resnet101":
        return cfg.deeplab_n_features
    return backbone_out_channels(cfg.base_architecture)


class PPNet(nn.Module):
    def __init__(self, cfg: PPNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        P, C, K = cfg.num_prototypes, cfg.prototype_channels, cfg.num_classes
        self.features = build_backbone(cfg)
        self.add_on_layers = build_add_on_layers(
            cfg.add_on_layers_type, add_on_in_channels(cfg), C,
            cfg.bottleneck_stride, cfg.presigmoid_ln)
        self.prototype_vectors = nn.Parameter(torch.empty(P, C, 1, 1))
        self.register_buffer("ones", torch.ones(P, C, 1, 1))
        self.last_layer = nn.Linear(P, K, bias=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's initializers, drawn from ``generator``:
        lecun-normal backbone convs (a classification stem's truncated,
        as flax draws them), kaiming-normal (fan_out) add-on convs, zero
        biases, identity BN, uniform [0, 1) prototypes (reference
        model.py:54) and the +1 / −0.5 last layer (model.py:359-380)."""
        g = generator
        if self.cfg.base_architecture == "deeplabv2_resnet101":
            for m in self.features.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
                    if m.bias is not None:
                        m.bias.zero_()
        else:
            reset_stem(self.features, g)
        for m in self.add_on_layers.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
                m.bias.zero_()
        self.prototype_vectors.uniform_(0.0, 1.0, generator=g)
        P, K = self.cfg.num_prototypes, self.cfg.num_classes
        own = default_proto_class(P, K)[None, :] == torch.arange(K)[:, None]
        self.last_layer.weight.copy_(torch.where(own, 1.0, -0.5))

    # -- feature path ------------------------------------------------------
    def conv_features(self, x: torch.Tensor
                      ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Backbone + add-on, NCHW (reference model.py:164-175); a list
        when MSC multi-scale training is active."""
        f = self.features(x)
        if isinstance(f, list):
            return [self.add_on_layers(fi) for fi in f]
        return self.add_on_layers(f)

    # -- heads ---------------------------------------------------------------
    def prototypes(self) -> torch.Tensor:
        """(P, C) prototype matrix."""
        return self.prototype_vectors.flatten(1)

    def last_layer_pk(self) -> torch.Tensor:
        """(P, K) last-layer weight, the JAX package's layout."""
        return self.last_layer.weight.t()

    def head(self, conv_features: torch.Tensor, return_distances: bool = True,
             bank: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Head:
        """Per-patch logits (B, h, w, K) (+ distances (B, h, w, P)) from
        NCHW conv features (reference model.py:259-283).  ``bank``
        ((P', C) prototypes, (P', K) last layer) replaces the module's
        own: a tensor-parallel rank's slice (partial logits, its slice's
        distances) or a bank gathered from the ranks."""
        rows = conv_features.permute(0, 2, 3, 1)
        protos, w = (self.prototypes(), self.last_layer_pk()) if bank is None else bank
        return prototype_head(rows, protos, w, self.cfg.prototype_activation,
                              self.cfg.epsilon, return_distances)

    def global_head(self, conv_features: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ProtoPNet image classification: global min-pool over patch
        distances (reference model.py:285-299) → (logits (B, K), (B, P)).

        The head is asked for its distances alone (the kernel's
        distances-only route), so its last-layer operand carries no
        gradient: the distances alone reach the backward."""
        rows = conv_features.permute(0, 2, 3, 1)
        _, d = prototype_head(rows, self.prototypes(), self.last_layer_pk().detach(),
                              self.cfg.prototype_activation, self.cfg.epsilon, True,
                              return_logits=False)
        min_d = d.amin(dim=(1, 2))
        act = distance_to_similarity(min_d, self.cfg.prototype_activation,
                                     self.cfg.epsilon)
        return act @ self.last_layer_pk().to(torch.float32), min_d

    def forward(self, x: torch.Tensor, return_distances: bool = True
                ) -> Union[Head, List[Head], Tuple[torch.Tensor, torch.Tensor]]:
        f = self.conv_features(x)
        if isinstance(f, list):
            return [self.head(fi, return_distances) for fi in f]
        if self.cfg.patch_classification:
            return self.head(f, return_distances)
        return self.global_head(f)

    def push_forward(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(conv features (B, h, w, C), distances (B, h, w, P)) for the
        push phase (reference model.py:301-309)."""
        f = self.conv_features(x)
        if isinstance(f, list):
            raise ValueError("push uses single-scale features")
        _, d = self.head(f, return_distances=True)
        return f.permute(0, 2, 3, 1), d


def default_proto_class(num_prototypes: int, num_classes: int,
                        device=None) -> torch.Tensor:
    """(P,) class id per prototype: contiguous equal blocks
    (reference model.py:66-73)."""
    k = num_prototypes // num_classes
    return torch.arange(num_prototypes, device=device) // k


def prune_params(state_dict: Dict[str, torch.Tensor],
                 proto_class: torch.Tensor, keep_idx: Sequence[int]
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """New (state_dict, proto_class) with only the ``keep_idx``
    prototypes (reference model.py:311-336 does this in place).  Build a
    PPNet with the new prototype count and load the result into it."""
    keep = torch.as_tensor(list(keep_idx), dtype=torch.long)
    new = dict(state_dict)
    for key in ("prototype_vectors", "ones"):
        new[key] = state_dict[key][keep.to(state_dict[key].device)]
    w = state_dict["last_layer.weight"]
    new["last_layer.weight"] = w[:, keep.to(w.device)]
    return new, proto_class[keep.to(proto_class.device)]
