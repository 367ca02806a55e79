"""ResNet-FPN backbone of LoFTR, 8x coarse and 2x fine (counterpart of
`gluefactory_tpu/models/backbones/resnet_fpn.py`).

A 7x7 stride-2 stem (initial_dim 128), three stages of two BasicBlocks
(block_dims 128, 196, 256 at strides 1, 2, 2), then a top-down FPN: the
coarse output is the 1x1-projected stage-3 map (256 at 1/8), the fine
output the merged and 3x3-refined maps down to 128 at 1/2. Every conv is
bias-free, each followed by a BatchNorm (eps 1e-5) but in the FPN's last
convs. Parameters carry the official names (`conv1`, `bn1`,
`layer{1,2,3}.{0,1}.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}`,
`layer{1,2,3}_outconv`, `layer{1,2}_outconv2.{0,1,3}`).

The port follows the JAX package where it departs from the official
model:
  - convolutions pad as flax's `SAME`: a stride-2 conv on an even size pads
    one more row and column after than before ((2, 3) for the 7x7 stem,
    (0, 1) for a 3x3), where the official `padding=k // 2` pads evenly;
  - the FPN upsamples bilinearly at half-pixel centres
    (`align_corners=False`, as `jax.image.resize`), the official model with
    `align_corners=True`.
The BatchNorms use their running statistics, or with `train` the batch's
as flax's (`ops/batch_norm.py`).

On the card the convs run with cuDNN's benchmark mode on: in float32 with
TF32 off, its heuristic picks an FFT algorithm for this network that runs a
complex gemv per tile (264k launches, 834 of the 1054 device ms of a 832 x
624 pair on an H100 80GB HBM3 at 700 W); benchmark mode times the
algorithms once a shape and keeps the fastest.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.batch_norm import batch_norm

MOMENTUM = 0.9  # flax's weight of the old running statistic


def _same_pad(n: int, k: int, s: int) -> tuple:
    """flax `SAME` padding (before, after) of one axis of size n."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A bias-free conv padded as flax's `SAME`."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1):
        super().__init__(c_in, c_out, k, stride=stride, padding=0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same_pad(x.shape[-2], k, s)
        left, right = _same_pad(x.shape[-1], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(c_in, c_out, 3, stride)
        self.bn1 = nn.BatchNorm2d(c_out, eps=1e-5)
        self.conv2 = SameConv2d(c_out, c_out, 3)
        self.bn2 = nn.BatchNorm2d(c_out, eps=1e-5)
        self.downsample = None
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(SameConv2d(c_in, c_out, 1, stride),
                                            nn.BatchNorm2d(c_out, eps=1e-5))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(batch_norm(self.bn1, self.conv1(x), train, MOMENTUM))
        y = batch_norm(self.bn2, self.conv2(y), train, MOMENTUM)
        if self.downsample is not None:
            x = batch_norm(self.downsample[1], self.downsample[0](x), train, MOMENTUM)
        return F.relu(x + y)


def _outconv2(c_mid: int, c_out: int) -> nn.Sequential:
    """conv3x3, BatchNorm, LeakyReLU (0.01), conv3x3: the FPN's merge block."""
    return nn.Sequential(SameConv2d(c_mid, c_mid, 3), nn.BatchNorm2d(c_mid, eps=1e-5),
                         nn.LeakyReLU(0.01), SameConv2d(c_mid, c_out, 3))


@contextlib.contextmanager
def _cudnn_benchmark():
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


class ResNetFPN_8_2(nn.Module):
    def __init__(self, initial_dim: int = 128, block_dims: tuple = (128, 196, 256)):
        super().__init__()
        d1, d2, d3 = block_dims
        self.conv1 = SameConv2d(1, initial_dim, 7, 2)
        self.bn1 = nn.BatchNorm2d(initial_dim, eps=1e-5)
        self.layer1 = nn.ModuleList([BasicBlock(initial_dim, d1, 1), BasicBlock(d1, d1, 1)])
        self.layer2 = nn.ModuleList([BasicBlock(d1, d2, 2), BasicBlock(d2, d2, 1)])
        self.layer3 = nn.ModuleList([BasicBlock(d2, d3, 2), BasicBlock(d3, d3, 1)])
        self.layer3_outconv = SameConv2d(d3, d3, 1)
        self.layer2_outconv = SameConv2d(d2, d3, 1)
        self.layer2_outconv2 = _outconv2(d3, d2)
        self.layer1_outconv = SameConv2d(d1, d2, 1)
        self.layer1_outconv2 = _outconv2(d2, d1)

    @staticmethod
    def _merge(block: nn.Sequential, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.leaky_relu(batch_norm(block[1], block[0](x), train, MOMENTUM), 0.01)
        return block[3](x)

    def forward(self, x: torch.Tensor, train: bool = False):
        """x (B, 1, H, W) -> coarse (B, 256, H/8, W/8), fine (B, 128, H/2, W/2)."""
        with _cudnn_benchmark() if x.is_cuda else contextlib.nullcontext():
            return self._forward(x, train)

    def _forward(self, x: torch.Tensor, train: bool):
        x0 = F.relu(batch_norm(self.bn1, self.conv1(x), train, MOMENTUM))
        x1 = x0
        for block in self.layer1:
            x1 = block(x1, train)
        x2 = x1
        for block in self.layer2:
            x2 = block(x2, train)
        x3 = x2
        for block in self.layer3:
            x3 = block(x3, train)

        x3_out = self.layer3_outconv(x3)
        x3_up = F.interpolate(x3_out, size=x2.shape[-2:], mode="bilinear", align_corners=False)
        y = self._merge(self.layer2_outconv2, self.layer2_outconv(x2) + x3_up, train)
        x2_up = F.interpolate(y, size=x1.shape[-2:], mode="bilinear", align_corners=False)
        z = self._merge(self.layer1_outconv2, self.layer1_outconv(x1) + x2_up, train)
        return x3_out, z
