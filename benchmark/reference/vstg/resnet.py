"""Frozen copy of the port module named below, imports made local; kernel calls go to
``plain_kernels``.

ResNet backbone with frozen BatchNorm (counterpart of ``vgqa_tpu/models/resnet.py``).

Plain ``nn.Conv2d`` layers (cuDNN on the card): the JAX reference has no
kernel here. Inputs and outputs are channels-last ``[N, H, W, C]`` like the
JAX module; inside, the trunk runs NCHW tensors in the channels_last memory
format, which is what cuDNN's tensor-core convolutions want. Inference
BatchNorm is a per-channel affine (``FrozenAffine``) that the forward folds
into the preceding convolution (scaled weights, its bias as the conv bias),
so it costs no pass over the activations; XLA fuses it the same way. The
fold is a product of parameters, so gradients reach the conv weights in
training; the stem, ``layer1`` and every ``FrozenAffine`` are frozen by the
optimizer's labels (``training/optimizer.py``), which also turn their
``requires_grad`` off.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .remat import remat_call


class FrozenAffine(nn.Module):
    """Per-channel ``x * weight + bias`` standing in for inference BatchNorm
    (weight = gamma / sqrt(var + eps), bias = beta - mean * weight). It holds
    the parameters; ``_conv_norm`` applies them inside the convolution."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


def _conv(cin, cout, kernel, stride=1, dilation=1):
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=False)


def _conv_norm(conv: nn.Conv2d, norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """norm(conv(x)), with a FrozenAffine folded into the convolution."""
    if isinstance(norm, FrozenAffine):
        w = conv.weight * norm.weight[:, None, None, None]
        return F.conv2d(x, w, norm.bias, conv.stride, conv.padding, conv.dilation)
    return norm(conv(x))


def _make_norm(norm: str, features: int) -> nn.Module:
    """"frozen" = folded BatchNorm affine; "group" = GroupNorm32."""
    if norm == "group":
        return nn.GroupNorm(min(32, features), features, eps=1e-5)
    return FrozenAffine(features)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck (stride on the 3x3)."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, norm: str = "frozen"):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = _make_norm(norm, planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = _make_norm(norm, planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = _make_norm(norm, planes * 4)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = _conv(cin, planes * 4, 1, stride)
            self.downsample_bn = _make_norm(norm, planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(_conv_norm(self.conv1, self.bn1, x))
        out = torch.relu(_conv_norm(self.conv2, self.bn2, out))
        out = _conv_norm(self.conv3, self.bn3, out)
        identity = x
        if self.has_downsample:
            identity = _conv_norm(self.downsample_conv, self.downsample_bn, x)
        return torch.relu(out + identity)


class ResNetBackbone(nn.Module):
    """ResNet-50/101 trunk returning the final stage feature map."""

    def __init__(self, depths: Sequence[int] = (3, 4, 23, 3), dilation: bool = False,
                 width: int = 64, norm: str = "frozen", remat: bool = False):
        super().__init__()
        self.depths = tuple(depths)
        self.width = width
        self.remat = remat                # per-bottleneck gradient checkpointing
        self.conv1 = _conv(3, width, 7, 2)
        self.bn1 = _make_norm(norm, width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = width
        for stage, blocks in enumerate(self.depths):
            planes = width * 2**stage
            first_stride = 1 if stage == 0 else 2
            dil = 1
            if stage == 3 and dilation:
                first_stride, dil = 1, 2
            for b in range(blocks):
                setattr(self, f"layer{stage + 1}_{b}", Bottleneck(
                    cin, planes, stride=first_stride if b == 0 else 1,
                    dilation=dil, downsample=(b == 0), norm=norm))
                cin = planes * 4

    @property
    def num_channels(self) -> int:
        return self.width * 8 * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, H, W, 3] -> [N, H/32 (or /16 for DC5), W/32, 2048]"""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.maxpool(torch.relu(_conv_norm(self.conv1, self.bn1, x)))
        for stage, blocks in enumerate(self.depths):
            for b in range(blocks):
                block = getattr(self, f"layer{stage + 1}_{b}")
                if self.remat and torch.is_grad_enabled():
                    x = remat_call(block, x)
                else:
                    x = block(x)
        return x.permute(0, 2, 3, 1)


def build_resnet(name: str, dilation: bool = False, remat: bool = False) -> ResNetBackbone:
    """Backbone zoo; a "-gn" suffix selects GroupNorm32."""
    norm = "frozen"
    if name.endswith("-gn"):
        norm = "group"
        name = name[: -len("-gn")]
    depths = {
        "resnet50": (3, 4, 6, 3),
        "resnet101": (3, 4, 23, 3),
        "resnet_test": (1, 1, 1, 1),
    }[name]
    width = 64 if name != "resnet_test" else 8
    return ResNetBackbone(depths=depths, dilation=dilation, width=width, norm=norm,
                          remat=remat)


def downsample_mask(pixel_mask: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-sample a [., H, W] validity mask at the stride centers."""
    H, W = pixel_mask.shape[-2:]
    h, w = out_hw
    ys = (torch.arange(h, device=pixel_mask.device) * H) // h
    xs = (torch.arange(w, device=pixel_mask.device) * W) // w
    return pixel_mask[..., ys, :][..., :, xs]
