"""DeepLSD learned line detection (counterpart of
`gluefactory_tpu/models/lines/deeplsd.py`).

A U-Net predicts a normalised line distance field (DF) and a line angle
field (AF); segments are vectorised from the fields on the host. Backends:

  - ``native``: the trainable U-Net (`DeepLSDNet`), supervised by GT fields
    that `fields_from_lines` derives on the device from any line source;
  - ``package-layout``: the official DeepLSD layout (`DeepLSDPackageNet`,
    modules `backbone` / `df_head` / `angle_head`) for converted weights;
  - ``package`` (the `deeplsd` package on the host) is not ported: it
    raises `ImportError` as the JAX module does without the package.

The vectoriser (`lines_from_fields_host`) is the JAX module's numpy code
with the probabilistic Hough of `ops/hough.py` (the repo's C++, as OpenCV's
`HoughLinesP` computes it) in place of cv2. Where the JAX module turns any
exception of the vectoriser into "no lines", this one raises.

Output contract as `lsd.py`: ``lines (B, L, 2, 2)`` xy endpoints,
``line_scores (B, L)`` (normalised to max 1), ``line_mask (B, L)``, beside
the fields ``df`` and ``angle`` (B, H, W).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.batch_norm import batch_norm
from ...ops.hough import hough_lines_p
from ...settings import DATA_PATH
from ..base_model import BaseModel
from ..extractors.superpoint import rgb_to_grayscale

# ---------------------------------------------------------------------------
# GT fields from line segments (on the device)
# ---------------------------------------------------------------------------


def fields_from_lines(lines: torch.Tensor, line_mask: torch.Tensor | None, h: int, w: int,
                      d_max: float = 5.0, chunk_elems: int = 1 << 23):
    """Line segments -> (normalised distance field, angle field).

    lines (B, L, 2, 2) xy endpoints (COLMAP pixel centres), line_mask (B, L).
    Returns df (B, h, w) in [0, 1] (distance from the pixel centre to the
    nearest segment, clipped at `d_max` and divided by it) and angle (B, h,
    w) in [0, pi) (orientation of the nearest segment; the first of equally
    near ones). Masked and degenerate segments never win; with no valid
    segment, df = 1 and angle = 0 everywhere. Rows go in chunks of about
    `chunk_elems` (pixel, segment) pairs: no (h * w, L) tensor is made."""
    B, L = lines.shape[:2]
    dev = lines.device
    lines = lines.float()
    if line_mask is None:
        line_mask = torch.ones((B, L), dtype=torch.bool, device=dev)
    a = lines[:, :, 0]  # (B, L, 2)
    ab = lines[:, :, 1] - a
    len2 = ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1]
    valid = line_mask.bool() & (len2 > 1e-6)
    theta = torch.remainder(torch.atan2(ab[..., 1], ab[..., 0]), math.pi)
    any_valid = valid.any(-1)  # (B,)
    ax, ay, abx, aby = (t[:, None, None, :] for t in (a[..., 0], a[..., 1], ab[..., 0], ab[..., 1]))
    den, vmask = len2.clamp(min=1e-6)[:, None, None, :], valid[:, None, None, :]
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    rows = max(1, chunk_elems // max(1, B * w * L))
    df = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    ang = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    for y0 in range(0, h, rows):
        ys = torch.arange(y0, min(h, y0 + rows), dtype=torch.float32, device=dev) + 0.5
        px, py = xs[None, None, :, None], ys[None, :, None, None]
        pax, pay = px - ax, py - ay
        t = ((pax * abx + pay * aby) / den).clamp(0.0, 1.0)
        dx, dy = px - (ax + t * abx), py - (ay + t * aby)
        d = torch.sqrt(dx * dx + dy * dy)
        d = torch.where(vmask, d, torch.full_like(d, math.inf))
        dmin, idx = d.min(-1)  # the first index of the minimum
        a_rows = torch.gather(theta[:, None, :].expand(B, idx.shape[1], L), 2, idx)
        dmin = torch.where(any_valid[:, None, None], dmin, torch.full_like(dmin, math.inf))
        a_rows = torch.where(any_valid[:, None, None], a_rows, torch.zeros_like(a_rows))
        df[:, y0:y0 + ys.shape[0]] = dmin.clamp(max=d_max) / d_max
        ang[:, y0:y0 + ys.shape[0]] = a_rows
    return df, ang


def field_losses(pred_df: torch.Tensor, pred_angle: torch.Tensor, gt_df: torch.Tensor,
                 gt_angle: torch.Tensor) -> dict:
    """L1 on the normalised DF; the circular (mod pi) angle error, weighted
    by 1 - gt_df toward pixels near lines. Each (B,)."""
    l_df = (pred_df - gt_df).abs().mean((-2, -1))
    dtheta = (pred_angle - gt_angle).abs()
    dtheta = torch.minimum(dtheta, math.pi - dtheta) / math.pi
    wgt = 1.0 - gt_df
    l_angle = (wgt * dtheta).sum((-2, -1)) / wgt.sum((-2, -1)).clamp(min=1.0)
    return {"df": l_df, "angle": l_angle, "total": l_df + l_angle}


# ---------------------------------------------------------------------------
# the DF / AF networks (channels-last images in, (B, H, W) fields out)
# ---------------------------------------------------------------------------


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)  # flax's SAME at stride 1


class _ConvBlock(nn.Sequential):
    def __init__(self, cin: int, ch: int):
        super().__init__(_conv3(cin, ch), nn.ReLU(), _conv3(ch, ch), nn.ReLU())


class DeepLSDNet(nn.Module):
    """The native U-Net: VGG-style blocks, 3 down / 3 up with skips (nearest
    2x upsampling, a conv, then [x, skip]); sigmoid DF head, sigmoid x pi
    angle head. H and W must be multiples of 2 ** len(channels)."""

    def __init__(self, channels=(64, 128, 256)):
        super().__init__()
        channels = tuple(int(c) for c in channels)
        ins = (1,) + channels[:-1]
        self.down = nn.ModuleList([_ConvBlock(i, c) for i, c in zip(ins, channels)])
        self.bottleneck = _ConvBlock(channels[-1], 2 * channels[-1])
        rev = channels[::-1]
        up_in = (2 * channels[-1],) + rev[:-1]
        self.up = nn.ModuleList([_conv3(i, c) for i, c in zip(up_in, rev)])
        self.up_blocks = nn.ModuleList([_ConvBlock(2 * c, c) for c in rev])
        self.df_head = nn.Conv2d(channels[0], 1, 1)
        self.angle_head = nn.Conv2d(channels[0], 1, 1)

    def forward(self, image: torch.Tensor):
        x = rgb_to_grayscale(image).permute(0, 3, 1, 2)
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for conv, block, skip in zip(self.up, self.up_blocks, reversed(skips)):
            x = conv(F.interpolate(x, scale_factor=2, mode="nearest"))
            x = block(torch.cat([x, skip], 1))
        df = torch.sigmoid(self.df_head(x))[:, 0]
        angle = torch.sigmoid(self.angle_head(x))[:, 0] * math.pi
        return df, angle


_BN_MOMENTUM = 0.9  # flax's: the weight of the old running statistic


class DeepLSDPackageNet(nn.Module):
    """The official DeepLSD layout for converted `deeplsd_md.tar` weights:
    `backbone.enc{i}` / `backbone.dec{i}` blocks of (3x3 conv, BatchNorm,
    ReLU) units, then `df_head` / `angle_head`, each (3x3 conv, ReLU,
    BatchNorm) units and a 1x1 conv. Decoder blocks take bilinear 2x
    upsampling then [skip, x]. The DF head's ReLU output is -log(d / r), so
    df = min(exp(-head), 1); the angle head is a sigmoid x pi. The state dict
    goes through the JAX package's `convert_deeplsd` as an official one.

    BatchNorm by the batch (`train=True`) moves the running statistics as
    flax does (`ops/batch_norm.py`, momentum 0.9)."""

    enc = ((64, 64), (128, 128), (256, 256), (256, 256))
    dec = ((128, 128), (64, 64), (64, 64))
    head = (64, 64)

    def __init__(self, enc=None, dec=None, head=None):
        super().__init__()
        self.enc = tuple(tuple(int(c) for c in b) for b in (enc or type(self).enc))
        self.dec = tuple(tuple(int(c) for c in b) for b in (dec or type(self).dec))
        self.head = tuple(int(c) for c in (head or type(self).head))
        self.backbone = nn.Module()
        cin, outs = 1, []
        for bi, block in enumerate(self.enc):
            self.backbone.add_module(f"enc{bi}", self._block(cin, block))
            cin = block[-1]
            outs.append(cin)
        for bi, block in enumerate(self.dec):
            self.backbone.add_module(f"dec{bi}", self._block(outs[-(bi + 2)] + cin, block))
            cin = block[-1]
        self.df_head = self._head(cin)
        self.angle_head = self._head(cin)

    @staticmethod
    def _block(cin: int, widths) -> nn.Sequential:
        layers = []
        for ch in widths:
            layers += [_conv3(cin, ch), nn.BatchNorm2d(ch), nn.ReLU()]
            cin = ch
        return nn.Sequential(*layers)

    def _head(self, cin: int) -> nn.Sequential:
        layers = []
        for ch in self.head:
            layers += [_conv3(cin, ch), nn.ReLU(), nn.BatchNorm2d(ch)]
            cin = ch
        return nn.Sequential(*layers, nn.Conv2d(cin, 1, 1))

    @staticmethod
    def _run(seq: nn.Sequential, x: torch.Tensor, train: bool) -> torch.Tensor:
        for layer in seq:
            if isinstance(layer, nn.BatchNorm2d):
                x = batch_norm(layer, x, train, _BN_MOMENTUM)
            else:
                x = layer(x)
        return x

    def forward(self, image: torch.Tensor, train: bool = False):
        x = rgb_to_grayscale(image).permute(0, 3, 1, 2)
        skips = []
        for bi in range(len(self.enc)):
            x = self._run(getattr(self.backbone, f"enc{bi}"), x, train)
            if bi < len(self.enc) - 1:
                skips.append(x)
                x = F.max_pool2d(x, 2, 2)
        for bi in range(len(self.dec)):
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
            x = self._run(getattr(self.backbone, f"dec{bi}"), torch.cat([skips[-(bi + 1)], x], 1), train)
        df_norm = torch.relu(self._run(self.df_head, x, train))[:, 0]
        angle = torch.sigmoid(self._run(self.angle_head, x, train))[:, 0] * math.pi
        return torch.exp(-df_norm).clamp(max=1.0), angle


# ---------------------------------------------------------------------------
# field -> segments vectoriser (host)
# ---------------------------------------------------------------------------


def _vectorize_one(df, angle, L, min_length, df_thresh, angle_tol, d_max):
    H, W = df.shape
    lines = np.zeros((L, 2, 2), np.float32)
    scores = np.zeros(L, np.float32)
    valid = np.zeros(L, bool)
    mask = (df < df_thresh).astype(np.uint8) * 255
    segs = hough_lines_p(mask, 1.0, math.pi / 180.0, int(max(10, min_length // 2)),
                         int(min_length), 4)
    if len(segs) == 0:
        return lines, scores, valid
    segs = np.asarray(segs, np.float32).reshape(-1, 4)  # x1 y1 x2 y2
    cands = []
    for x1, y1, x2, y2 in segs:
        length = math.hypot(x2 - x1, y2 - y1)
        if length < min_length:
            continue
        n = max(int(length), 2)
        ts = np.linspace(0, 1, n)
        xs = np.clip((x1 + ts * (x2 - x1)).round().astype(int), 0, W - 1)
        ys = np.clip((y1 + ts * (y2 - y1)).round().astype(int), 0, H - 1)
        med_df = float(np.median(df[ys, xs]))
        if med_df > df_thresh:
            continue
        seg_theta = math.atan2(y2 - y1, x2 - x1) % math.pi
        dth = np.abs(angle[ys, xs] - seg_theta)
        dth = np.minimum(dth, math.pi - dth)
        if float(np.median(dth)) > angle_tol:
            continue
        cands.append((math.sqrt(length) * (1.0 - med_df), x1, y1, x2, y2, seg_theta))
    if not cands:
        return lines, scores, valid
    cands.sort(key=lambda c: -c[0])

    # segment NMS: a candidate whose midpoint lies near a kept segment of a
    # similar orientation, within its projection, is dropped
    kept = []
    for score, x1, y1, x2, y2, th in cands:
        mid = np.asarray([(x1 + x2) / 2, (y1 + y2) / 2])
        dup = False
        for _, kx1, ky1, kx2, ky2, kth in kept:
            dth = abs(th - kth)
            dth = min(dth, math.pi - dth)
            if dth > angle_tol:
                continue
            ka = np.asarray([kx1, ky1])
            kd = np.asarray([kx2 - kx1, ky2 - ky1])
            klen2 = float((kd**2).sum())
            t = float(np.dot(mid - ka, kd)) / max(klen2, 1e-6)
            perp = float(np.linalg.norm(mid - (ka + np.clip(t, 0, 1) * kd)))
            if -0.1 <= t <= 1.1 and perp <= d_max:
                dup = True
                break
        if not dup:
            kept.append((score, x1, y1, x2, y2, th))
        if len(kept) >= L:
            break

    n = len(kept)
    arr = np.asarray([[k[1], k[2], k[3], k[4]] for k in kept], np.float32)
    # Hough endpoints are array indices; +0.5 -> COLMAP pixel centres
    lines[:n, 0] = arr[:, :2] + 0.5
    lines[:n, 1] = arr[:, 2:] + 0.5
    s = np.asarray([k[0] for k in kept], np.float32)
    scores[:n] = s / max(float(s.max()), 1e-6)
    valid[:n] = True
    return lines, scores, valid


def lines_from_fields_host(df: np.ndarray, angle: np.ndarray, max_lines: int,
                           min_length: float = 15.0, df_thresh: float = 0.45,
                           angle_tol: float = math.pi / 9, d_max: float = 5.0):
    """Segments from (B, H, W) normalised DF and AF: candidates from the
    probabilistic Hough on df < df_thresh (threshold max(10, min_length //
    2), min_length, gap 4), kept if their median DF and median angle error
    along the segment pass, scored sqrt(length) * (1 - median DF), sorted,
    deduplicated by a segment NMS, at most `max_lines`, scores over the
    image's best; endpoints + 0.5 (COLMAP pixel centres). One image a
    thread. Returns lines (B, L, 2, 2), scores (B, L), valid (B, L)."""
    df = np.asarray(df, np.float32)
    angle = np.asarray(angle, np.float32)
    B = df.shape[0]
    args = (int(max_lines), float(min_length), float(df_thresh), float(angle_tol), float(d_max))
    with ThreadPoolExecutor(max_workers=max(1, min(B, 8))) as pool:
        outs = list(pool.map(lambda b: _vectorize_one(df[b], angle[b], *args), range(B)))
    return tuple(np.stack([o[i] for o in outs]) for i in range(3))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class DeepLSD(BaseModel):
    default_conf = {
        "backend": "native",  # "native" | "package-layout" | "package" (not ported)
        "max_num_lines": 250,
        "min_length": 15.0,
        "df_thresh": 0.45,
        "angle_tol": math.pi / 9,
        "d_max": 5.0,  # DF normalisation radius (px)
        "detect_in_train": False,  # also vectorise in training forwards
        "channels": [64, 128, 256],
        # package-layout: block widths {"enc", "dec", "head"} of the converted
        # net (`convert_deeplsd`'s spec); None = the deeplsd_md.tar layout
        "package_spec": None,
        "trainable": True,
        "weights_path": "weights/deeplsd_md.tar",  # package backend, under DATA_PATH
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        if conf.backend == "native":
            self.net = DeepLSDNet(tuple(conf.channels))
        elif conf.backend == "package-layout":
            spec = conf.get("package_spec") or {}
            self.net = DeepLSDPackageNet(spec.get("enc"), spec.get("dec"), spec.get("head"))
        else:
            try:
                import deeplsd  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "backend='package' requires the `deeplsd` package and "
                    f"weights (expected under {DATA_PATH / conf.weights_path});"
                    " unavailable in this environment — use backend='native'"
                    " or `lsd` instead.") from e
            raise NotImplementedError("backend='package' is not ported: use 'package-layout' "
                                      "with weights converted by convert_deeplsd")

    def _forward(self, data: dict, train: bool = False, **kwargs) -> dict:
        image = data["image"]
        # the package-layout net's BatchNorm runs on its running statistics,
        # as the JAX model calls it
        df, angle = self.net(image)
        pred = {"df": df, "angle": angle}
        if train and not self.conf.detect_in_train:
            return pred  # training supervises the fields
        lines, scores, valid = lines_from_fields_host(
            df.detach().float().cpu().numpy(), angle.detach().float().cpu().numpy(),
            int(self.conf.max_num_lines), float(self.conf.min_length),
            float(self.conf.df_thresh), float(self.conf.angle_tol), float(self.conf.d_max))
        dev = image.device
        pred.update({"lines": torch.from_numpy(lines).to(dev),
                     "line_scores": torch.from_numpy(scores).to(dev),
                     "line_mask": torch.from_numpy(valid).to(dev)})
        return pred

    def loss(self, pred: dict, data: dict, train: bool = False):
        """Field supervision from the batch's `lines` / `line_mask` (e.g.
        LSD pseudo-labels): GT fields derived on the device."""
        if self.conf.backend != "native":
            raise NotImplementedError("package backend is inference-only")
        h, w = pred["df"].shape[-2:]
        gt_df, gt_angle = fields_from_lines(data["lines"], data.get("line_mask"), h, w,
                                            float(self.conf.d_max))
        return field_losses(pred["df"], pred["angle"], gt_df, gt_angle), {}
