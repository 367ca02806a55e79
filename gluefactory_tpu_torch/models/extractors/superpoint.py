"""SuperPoint keypoint detector and descriptor (counterpart of
`gluefactory_tpu/models/extractors/superpoint.py`), in both variants:

  - `vanilla`: parameters carry the official MagicLeap names (`conv1a` ...
    `convDb`, each an `nn.Conv2d`), so `superpoint_v1.pth` loads as it is;
  - `open` (the MIT re-training, `superpoint_open.py`): each conv is
    followed by ReLU (not in the 1x1 heads) and then BatchNorm (eps 1e-3,
    flax's momentum 0.9), under rpautrat's names `backbone.{i}.{0,1}`,
    `detector.{0,1}` and `descriptor.{0,1}`, each a block of `conv` and
    `bn`, so `superpoint_v6_from_tf.pth` loads as it is. As in the JAX
    package, the backbone and the 3x3 heads normalise by the batch under
    `train` unless `freeze_batch_normalization`, and the 1x1 heads
    always by their running statistics; descriptors are sampled at the
    cell's geometric centre. `fused_backbone` raises with `open` (the
    kernel has no BatchNorm; the JAX package quietly runs the plain path
    there); `fused_detect` routes as with `vanilla`.

The network runs
channels-first; the data contract stays that of the JAX package: images
(B, H, W, C) in [0, 1], keypoints in the COLMAP convention (+0.5), exactly
`max_num_keypoints` keypoints per image with a `keypoint_mask`
(`max_num_keypoints_val` instead at eval, `train=False`). With
`refinement_radius` > 0 the selected keypoints move to the score-weighted
mean position of their window of the dense score map (`ops/nms.py`), after
either decode. With `randomize_keypoints_training`, training samples its
keypoints by score (the Gumbel top-k) from the caller's generator.
`freeze_batch_normalization` changes nothing in the vanilla network,
which has no BatchNorm.

Two opt-ins, off by default as in the JAX package, route through the
hand-written CUDA kernels on the card:
  - `fused_backbone`: conv1b + pool and blocks 2-4 as `fused_vgg_block`
    (NHWC, four launches per forward), each block whose shape
    `vgg_kernel_available` takes (the rest runs the plain path, as the JAX
    package consults `fused_vgg_available`); conv1a (C_in = 1) stays an
    `nn.Conv2d`. On the CPU the blocks run the kernel's plain version;
  - `fused_detect`: NMS, border and area masks and the 4x4 tile reduction
    as `fused_nms_tile_reduce`, exactly where the JAX package takes its
    fused decode (`use_fused_detect`): on a CUDA tensor, or on the CPU
    under the test hook `cuda_detect.FORCE_FUSED`. The fused decode keeps
    one of two equal survivors in a 4x4 tile where the non-fused one may
    keep both, so where it runs decides the keypoints.

Two serving options of the JAX package, vanilla variant only (`open`
raises, as with `fused_backbone`; the JAX package quietly ignores them):
  - `quantize: "int8"` (inference only: under `train` the float path
    runs): the whole dense pass, the 8 backbone convs with their pools in
    the int8 domain and both heads, as `ops/int8_conv.py::int8_conv`
    (per-channel weights, one dynamic activation scale over the batch),
    through `csrc/int8_conv.cu` on the card, 12 conv launches and 12
    requant launches a forward; the 1x1 heads return bf16 as in JAX. It
    takes precedence over `fused_backbone`;
  - `s2d_block1`: block 1 at half resolution by space-to-depth
    (`ops/s2d_conv.py`) when H and W are even; the other blocks keep their
    route (plain or `fused_backbone`).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import cuda_detect
from ...ops.batch_norm import batch_norm
from ...ops.cuda_conv import fused_vgg_block, vgg_kernel_available
from ...ops.cuda_detect import detect_keypoints, fused_detect_available
from ...ops.grid_sample import sample_descriptors
from ...ops.int8_conv import int8_conv, pack_weight, quantize_activation
from ...ops.nms import (mask_outside, remove_borders, simple_nms, soft_argmax_refinement,
                        top_k_keypoints)
from ...ops.s2d_conv import vgg_block1_s2d
from ...utils.distributed import batch_rand
from ..base_model import BaseModel


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 1), luminance weights."""
    if image.shape[-1] == 1:
        return image
    w = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype, device=image.device)
    return (image * w).sum(dim=-1, keepdim=True)


def detector_scores(logits: torch.Tensor) -> torch.Tensor:
    """Detector logits (B, 65, Hc, Wc) -> score map (B, 8*Hc, 8*Wc): softmax
    over the 65 channels, drop the dustbin, 8x8 pixel shuffle in which
    channel dy*8+dx of cell (hc, wc) is pixel (8*hc+dy, 8*wc+dx)."""
    scores = logits.softmax(dim=1)[:, :64]
    B, _, Hc, Wc = scores.shape
    scores = scores.reshape(B, 8, 8, Hc, Wc).permute(0, 3, 1, 4, 2)
    return scores.reshape(B, Hc * 8, Wc * 8)


def use_fused_detect(conf, scores: torch.Tensor) -> bool:
    """Whether SuperPoint decodes `scores` (B, H, W) with the fused decode:
    the JAX package's condition (`superpoint.py::_decode`) with the CUDA
    device in the TPU's place and `cuda_detect.FORCE_FUSED` in that of
    `pallas_detect.FORCE_INTERPRET`. `nms_radius >= 3` keeps the 4x4-tile
    top-k exact; the shape test is the JAX package's routing predicate
    (`fused_detect_available`), not the kernel's; the kernel has no
    gradient. A radius the kernel cannot take then raises in the kernel's
    wrapper rather than change the keypoints."""
    H, W = scores.shape[1:]
    return bool(conf.fused_detect and conf.nms_radius >= 3
                and (scores.device.type == "cuda" or cuda_detect.FORCE_FUSED)
                and fused_detect_available(H, W)
                and not (torch.is_grad_enabled() and scores.requires_grad))


def sample_k_keypoints(nmsed: torch.Tensor, k: int, threshold: float, generator: torch.Generator):
    """k keypoints of a suppressed score map (B, H, W) sampled without
    replacement with probability by score, among those above `threshold`:
    the Gumbel top-k of the log scores (the JAX package's
    `randomize_keypoints_training`). Gumbel noise is -log(-log(u)), u
    uniform in [tiny, 1), from `generator`. Returns keypoints (+0.5, as
    `top_k_keypoints`), their scores and validity (False for slots beyond the
    candidates)."""
    B, H, W = nmsed.shape
    tiny = torch.finfo(torch.float32).tiny
    u = batch_rand(nmsed.shape, generator, nmsed.device).clamp(min=tiny)
    g = -torch.log(-torch.log(u))
    pert = torch.where(nmsed > threshold, torch.log(nmsed.float().clamp(min=1e-20)) + g,
                       torch.tensor(-float("inf"), device=nmsed.device))
    top, idx = torch.topk(pert.reshape(B, -1), k, dim=-1)
    kpt_scores = torch.gather(nmsed.reshape(B, -1), 1, idx)
    kpts = torch.stack([idx % W, idx // W], dim=-1).float() + 0.5
    return kpts, kpt_scores, torch.isfinite(top)


OPEN_BN_MOMENTUM = 0.9  # flax's, as the JAX package's open variant sets it


class OpenVGGBlock(nn.Module):
    """rpautrat's VGG block: `conv`, ReLU unless `relu` is False, then `bn`
    (BatchNorm after the activation, eps 1e-3)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, padding=kernel // 2)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)
        self.relu = relu

    def forward(self, x: torch.Tensor, by_batch: bool = False) -> torch.Tensor:
        x = self.conv(x)
        if self.relu:
            x = torch.relu(x)
        return batch_norm(self.bn, x, by_batch, OPEN_BN_MOMENTUM)


class SuperPoint(BaseModel):
    default_conf = {
        "variant": "vanilla",
        "descriptor_dim": 256,
        "nms_radius": 4,
        "max_num_keypoints": 1024,
        "max_num_keypoints_val": None,  # the keypoint count at eval
        "force_num_keypoints": False,
        "randomize_keypoints_training": False,  # sample keypoints by score
        "detection_threshold": 0.005,
        "remove_borders": 4,
        "refinement_radius": 0,  # soft-argmax sub-pixel refinement (ops/nms.py)
        "dense_outputs": False,
        "channels": [64, 64, 128, 128],
        "head_channels": 256,
        "fused_detect": False,  # the decode through csrc/nms_tile_reduce.cu
        "fused_backbone": False,  # the VGG blocks through csrc/vgg_block.cu
        "s2d_block1": False,  # block 1 by space-to-depth (ops/s2d_conv.py)
        "quantize": None,  # None | "int8": the dense pass through csrc/int8_conv.cu
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        if conf.quantize not in (None, "int8"):
            raise ValueError(f"SuperPoint quantize must be None or 'int8', got {conf.quantize!r}")
        if conf.variant == "open":
            self._init_open(conf)
            return
        if conf.variant != "vanilla":
            raise ValueError(f"unknown SuperPoint variant {conf.variant!r}")
        chans = [1, *conf.channels]
        for i in range(len(conf.channels)):
            setattr(self, f"conv{i+1}a", nn.Conv2d(chans[i], chans[i + 1], 3, padding=1))
            setattr(self, f"conv{i+1}b", nn.Conv2d(chans[i + 1], chans[i + 1], 3, padding=1))
        c = conf.channels[-1]
        self.convPa = nn.Conv2d(c, conf.head_channels, 3, padding=1)
        self.convPb = nn.Conv2d(conf.head_channels, 65, 1)
        self.convDa = nn.Conv2d(c, conf.head_channels, 3, padding=1)
        self.convDb = nn.Conv2d(conf.head_channels, conf.descriptor_dim, 1)
        self._kernel_weights: dict = {}  # `_hwio`'s copies, by conv name
        self._int8_weights: dict = {}  # `_packed`'s quantized weights, by conv name

    def _init_open(self, conf):
        if conf.fused_backbone:
            raise ValueError("fused_backbone takes the vanilla variant only: the VGG block kernel "
                             "has no BatchNorm")
        if conf.quantize or conf.s2d_block1:
            raise ValueError("quantize and s2d_block1 take the vanilla variant only: the open "
                             "variant's BatchNorm sits between the convs")
        chans = [1, *conf.channels]
        self.backbone = nn.ModuleList(
            nn.ModuleList([OpenVGGBlock(chans[i], chans[i + 1]), OpenVGGBlock(chans[i + 1], chans[i + 1])])
            for i in range(len(conf.channels)))
        c = conf.channels[-1]
        self.detector = nn.ModuleList([OpenVGGBlock(c, conf.head_channels),
                                       OpenVGGBlock(conf.head_channels, 65, 1, relu=False)])
        self.descriptor = nn.ModuleList([OpenVGGBlock(c, conf.head_channels),
                                         OpenVGGBlock(conf.head_channels, conf.descriptor_dim, 1,
                                                      relu=False)])

    def _open_dense(self, x: torch.Tensor, train: bool):
        """The open variant's network on x (B, 1, H, W): (logits (B, 65, Hc,
        Wc), dense descriptors (B, D, Hc, Wc)). The backbone and the 3x3
        heads by the batch under `train` unless `freeze_batch_normalization`,
        the 1x1 heads by their running statistics (the JAX model calls them
        without `train`)."""
        by_batch = train and not self.conf.freeze_batch_normalization
        for i, (block_a, block_b) in enumerate(self.backbone):
            x = block_b(block_a(x, by_batch), by_batch)
            if i < len(self.backbone) - 1:
                x = nn.functional.max_pool2d(x, 2, 2)
        logits = self.detector[1](self.detector[0](x, by_batch))
        dense_desc = self.descriptor[1](self.descriptor[0](x, by_batch))
        return logits, dense_desc

    def _forward(self, data: dict, generator: torch.Generator | None = None,
                 train: bool = False) -> dict:
        """`generator` draws the random keypoints that fill invalid slots
        under `force_num_keypoints` and the Gumbel noise of
        `randomize_keypoints_training` (a fresh one seeded with 0 if None)."""
        image = rgb_to_grayscale(data["image"])
        x = image.permute(0, 3, 1, 2)
        if self.conf.variant == "open":
            logits, dense_desc = self._open_dense(x, train)
            return self._decode(data, image, logits, dense_desc, generator, train)
        if self.conf.quantize == "int8" and not train:
            logits, dense_desc = self._int8_dense(image)
            return self._decode(data, image, logits, dense_desc, generator, train)
        relu = torch.relu
        n_blocks = len(self.conf.channels)
        s2d = bool(self.conf.s2d_block1 and n_blocks > 1 and x.shape[2] % 2 == 0
                   and x.shape[3] % 2 == 0)
        if self.conf.fused_backbone:
            x = self._fused_backbone(x, s2d)
        else:
            for i in range(n_blocks):
                x = self._s2d_block1(x) if i == 0 and s2d else self._plain_block(x, i)
        logits = self.convPb(relu(self.convPa(x)))  # (B, 65, Hc, Wc)
        dense_desc = self.convDb(relu(self.convDa(x)))  # (B, D, Hc, Wc)
        return self._decode(data, image, logits, dense_desc, generator, train)

    def _plain_block(self, x: torch.Tensor, i: int, first_conv: bool = True) -> torch.Tensor:
        """VGG block i through `nn.Conv2d`s (NCHW): conv_a (unless
        `first_conv` is False), conv_b, the pool except after the last."""
        if first_conv:
            x = torch.relu(getattr(self, f"conv{i+1}a")(x))
        x = torch.relu(getattr(self, f"conv{i+1}b")(x))
        if i < len(self.conf.channels) - 1:
            x = nn.functional.max_pool2d(x, 2, 2)
        return x

    def _s2d_block1(self, x: torch.Tensor) -> torch.Tensor:
        """Block 1 by space-to-depth (`ops/s2d_conv.py`), NCHW in and out."""
        a, b = self.conv1a, self.conv1b
        out = vgg_block1_s2d(x.permute(0, 2, 3, 1), a.weight.permute(2, 3, 1, 0), a.bias,
                             b.weight.permute(2, 3, 1, 0), b.bias)
        return out.permute(0, 3, 1, 2)

    def _packed(self, name: str):
        """Conv `name`'s weight quantized and packed for `int8_conv`, kept
        until the weight changes (in place, moved or cast), and its bias."""
        conv = getattr(self, name)
        w = conv.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        hit = self._int8_weights.get(name)
        if hit is None or hit[0] != key:
            hit = (key, pack_weight(w.detach().permute(2, 3, 1, 0)))
            self._int8_weights[name] = hit
        return hit[1], conv.bias.detach()

    def _int8_dense(self, image: torch.Tensor):
        """The dense pass (backbone and both heads) in int8 on image (B, H, W,
        1): the JAX package's `_int8_dense`, each pool fused into the conv
        before it. Returns (logits (B, 65, Hc, Wc), raw dense descriptors
        (B, D, Hc, Wc)), both bf16."""
        x8, s = quantize_activation(image)
        n_blocks = len(self.conf.channels)
        for i in range(n_blocks):
            for tag in "ab":
                pool = tag == "b" and i < n_blocks - 1
                x8, s = int8_conv(x8, s, *self._packed(f"conv{i+1}{tag}"), pool=pool)
        heads = []
        for name in "PD":
            h8, sh = int8_conv(x8, s, *self._packed(f"conv{name}a"))
            out = int8_conv(h8, sh, *self._packed(f"conv{name}b"), relu=False, requant=False)
            heads.append(out.permute(0, 3, 1, 2))
        return heads[0], heads[1]

    def _hwio(self, name: str):
        """Conv `name`'s weight as a contiguous HWIO copy, the layout the
        kernel reads, so that `fused_vgg_block` copies nothing. The copy is
        kept until the weight changes (in place, moved or cast); with
        autograd on, the live weight is permuted instead."""
        conv = getattr(self, name)
        w = conv.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return w.permute(2, 3, 1, 0), conv.bias
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        hit = self._kernel_weights.get(name)
        if hit is None or hit[0] != key:
            hit = (key, w.detach().permute(2, 3, 1, 0).contiguous())
            self._kernel_weights[name] = hit
        return hit[1], conv.bias

    def _fused_backbone(self, x: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        """The VGG blocks through `fused_vgg_block`, NHWC inside: conv1a as
        an `nn.Conv2d` (channels-last, so its output is NHWC without a
        copy), conv1b + pool as the single-conv variant, blocks 2-4 as the
        two-conv variant, block 4 without pool. A block whose shape the
        kernel does not take (`vgg_kernel_available`) runs `_plain_block`,
        as the JAX package sends it to XLA. With `s2d`, block 1 runs
        `_s2d_block1` instead. NCHW view out."""
        if s2d:
            x = self._s2d_block1(x).contiguous(memory_format=torch.channels_last)
        else:
            x = torch.relu(self.conv1a(x.contiguous(memory_format=torch.channels_last)))
        x = x.permute(0, 2, 3, 1)
        n_blocks = len(self.conf.channels)
        for i in range(1 if s2d else 0, n_blocks):
            pool = i < n_blocks - 1
            H, W, c_in = x.shape[1:]
            c_mid = getattr(self, f"conv{i+1}a").out_channels
            c_out = getattr(self, f"conv{i+1}b").out_channels
            if i == 0:
                c_mid = c_out  # conv1b alone
            if not vgg_kernel_available(H, W, c_in, c_mid, c_out, pool):
                x = self._plain_block(x.permute(0, 3, 1, 2), i, first_conv=i > 0).permute(0, 2, 3, 1)
                continue
            wb, bb = self._hwio(f"conv{i+1}b")
            if i == 0:
                x = fused_vgg_block(x, wb, bb, pool=pool)
            else:
                wa, ba = self._hwio(f"conv{i+1}a")
                x = fused_vgg_block(x, wa, ba, wb, bb, pool=pool)
        return x.permute(0, 3, 1, 2)

    def _decode(self, data, image, logits, dense_desc, generator, train: bool):
        c = self.conf
        scores = detector_scores(logits)
        B = scores.shape[0]
        dense_desc = dense_desc / (torch.linalg.vector_norm(dense_desc, dim=1, keepdim=True) + 1e-8)
        if generator is None:
            generator = torch.Generator(device=scores.device).manual_seed(0)

        k = int(c.max_num_keypoints)
        if not train and c.max_num_keypoints_val is not None:
            k = int(c.max_num_keypoints_val)
        randomize = train and c.randomize_keypoints_training
        true_size = data.get("image_size")
        if not randomize and use_fused_detect(c, scores):
            kpts, kpt_scores, valid = detect_keypoints(
                scores, k, c.detection_threshold, radius=c.nms_radius,
                border=c.remove_borders, true_size=true_size,
            )
        else:
            nmsed = remove_borders(simple_nms(scores, c.nms_radius), c.remove_borders)
            if true_size is not None:
                # no detections beyond the true image area of a padded buffer
                nmsed = mask_outside(nmsed, true_size, c.remove_borders)
            if randomize:
                kpts, kpt_scores, valid = sample_k_keypoints(nmsed, k, c.detection_threshold, generator)
            else:
                kpts, kpt_scores, valid = top_k_keypoints(
                    nmsed, k, c.detection_threshold, nms_radius=c.nms_radius
                )
        if c.refinement_radius > 0:  # on the score map before NMS, after either decode
            kpts = soft_argmax_refinement(kpts, scores, int(c.refinement_radius))

        if c.force_num_keypoints:
            size = true_size
            if size is None:
                h, w = image.shape[1:3]
                size = torch.tensor([[w, h]], dtype=torch.float32, device=kpts.device).expand(B, 2)
            u = batch_rand((B, k, 2), generator, kpts.device, kpts.dtype)
            rand_kpts = u * size[:, None, :]
            kpts = torch.where(valid[..., None], kpts, rand_kpts)
            kpt_scores = torch.where(valid, kpt_scores, torch.zeros_like(kpt_scores))
            valid = torch.ones_like(valid)

        # vanilla: glue-factory's legacy sampling offset; open: the cell's centre
        desc = sample_descriptors(kpts, dense_desc.permute(0, 2, 3, 1), stride=8,
                                  legacy_offset=c.variant == "vanilla")
        pred = {
            "keypoints": kpts,
            "keypoint_scores": kpt_scores,
            "keypoint_mask": valid,
            "descriptors": desc,
        }
        if c.dense_outputs:
            pred["dense_descriptors"] = dense_desc.permute(0, 2, 3, 1)
            pred["dense_score_map"] = scores
        return pred
