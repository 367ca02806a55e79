"""RoMa, the dense warp matcher, for evaluation (counterpart of
`gluefactory_tpu/models/matchers/roma.py`): the warp and its certainty
from the network (`roma_net.py`) or from the data, then sparse matches
from them.

  - `flow_to_warp`: flow and certainty logits -> a warp clamped to [-1, 1]
    and a sigmoid certainty, less half the coarse certainty's negative part,
    zero where the flow left the image;
  - `match_keypoints_dense`: given keypoints snapped through the warp: the
    warp sampled at each query keypoint, the nearest target keypoint within
    `max_kp_error` px, a mutual check and a certainty threshold; masked
    keypoint slots neither match nor are matched;
  - `cycle_dist`: the warp's round-trip error in pixels;
  - `sample_matches`: exactly `num` matches drawn from both warps (batch
    1): certainty-thresholded, then balanced by a Gaussian KDE of the
    drawn 4-vectors (romatch's `threshold_balanced`). The draws are Gumbel
    top-k, the noise from the caller's `torch.Generator` (the pipeline's),
    or given. The KDE's (k, k) sum runs in row blocks, so that its peak
    stays near 1 GiB at romatch's 4 x 10000 draws.

The network path runs the reference wrapper's two passes: a coarse pass at
`internal_hw`, then a refiner-only pass at `output_hw` (the views' size
when null) from the coarse flow, both directions in one doubled batch.
With `mixed_precision` the images are rounded to bfloat16 and the network
runs in float32 on them, as flax promotes the bf16 images against float32
parameters in the JAX package. Coordinates follow the reference: the
(W - 1) convention of `normalize_coords` / `denormalize_coords`, sampling
with align_corners False.

The network's parameters carry romatch's names at the top of this model's
state dict (`encoder.*`, `decoder.*`); `weights` (outdoor / indoor) is kept
for the configs and read nowhere, as in the JAX package. Evaluation only:
`loss` raises.
"""

from __future__ import annotations

import torch

from ..base_model import BaseModel
from .roma_net import NET_DEFAULT_CONF, Encoder, RoMaDecoder, resize, sample_normalized, symmetric_forward

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
KDE_BLOCK = 1 << 24  # elements of a row block's (rows, k) distance matrix


def get_pixel_grid(h: int, w: int, normalized: bool = False, device=None) -> torch.Tensor:
    """(H, W, 2) [x, y] grid of pixel centres (+0.5); `normalized` maps it
    to [-1, 1] at align_corners False."""
    x = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
    if normalized:
        grid = grid * (2.0 / torch.tensor([w, h], dtype=torch.float32, device=device)) - 1.0
    return grid


def normalize_coords(coords: torch.Tensor, hw) -> torch.Tensor:
    """[0, W / H] -> [-1, 1], the (W - 1) convention."""
    h, w = hw
    return coords / torch.tensor([w - 1, h - 1], dtype=torch.float32, device=coords.device) * 2.0 - 1.0


def denormalize_coords(coords: torch.Tensor, hw) -> torch.Tensor:
    """[-1, 1] -> [0, W / H], the (W - 1) convention."""
    h, w = hw
    return (coords + 1.0) / 2.0 * torch.tensor([w - 1, h - 1], dtype=torch.float32, device=coords.device)


def grid_sample_normalized(fmap: torch.Tensor, ncoords: torch.Tensor) -> torch.Tensor:
    """fmap (B, H, W, C) sampled at normalised coords (B, N, 2): (B, N, C);
    bilinear, align_corners False, zeros outside."""
    return sample_normalized(fmap.permute(0, 3, 1, 2), ncoords[:, :, None])[..., 0].transpose(1, 2)


def flow_to_warp(flow: torch.Tensor, certainty_logits: torch.Tensor, lr_certainty=None,
                 extract_query_coords: bool = False) -> dict:
    """flow (B, H, W, 2) normalised target coords, certainty_logits
    (B, H, W) -> {"warp": clamped to [-1, 1], "certainty": probabilities,
    0 where the flow left the image} (+ "q_coords" when asked)."""
    B, H, W = certainty_logits.shape[:3]
    if lr_certainty is not None:
        # the coarse certainty upsampled, its negative part halved, subtracted
        lr = resize(lr_certainty, H, W)
        lr = 0.5 * lr * (lr < 0.0)
        certainty_logits = certainty_logits - lr
    certainty = torch.sigmoid(certainty_logits)
    out_of_range = (flow.abs() > 1.0).any(dim=-1)
    certainty = torch.where(out_of_range, torch.zeros((), device=flow.device), certainty)
    pred = {"warp": flow.clamp(-1.0, 1.0), "certainty": certainty}
    if extract_query_coords:
        pred["q_coords"] = get_pixel_grid(H, W, True, flow.device)[None].expand(B, H, W, 2)
    return pred


def cycle_dist(q_to_ref: torch.Tensor, ref_to_q: torch.Tensor) -> torch.Tensor:
    """Round-trip error in pixels, |grid - denorm(ref_to_q(q_to_ref))|:
    (B, H, W, 2) warps -> (B, H, W)."""
    B, H, W, _ = q_to_ref.shape
    back = grid_sample_normalized(ref_to_q, q_to_ref.reshape(B, H * W, 2)).reshape(B, H, W, 2)
    grid = get_pixel_grid(H, W, device=q_to_ref.device)[None]
    return torch.linalg.vector_norm(grid - denormalize_coords(back, (H, W)), dim=-1)


def _view_hw(view: dict) -> tuple:
    if "image" in view:
        return tuple(view["image"].shape[1:3])
    size = view["image_size"]  # (B, 2) [w, h], one size a batch
    return int(size[0, 1]), int(size[0, 0])


def match_keypoints_dense(pred: dict, data: dict, max_kp_error: float, filter_threshold: float,
                          mutual_check: bool = True) -> dict:
    """Match the data's keypoints0/1 (pixels) through the dense warps
    `warp0/certainty0` (0 -> 1) and `warp1/certainty1`; `keypoint_mask0/1`
    where given."""
    hw0, hw1 = _view_hw(data["view0"]), _view_hw(data["view1"])
    kpts0, kpts1 = data["keypoints0"], data["keypoints1"]
    mask0, mask1 = data.get("keypoint_mask0"), data.get("keypoint_mask1")

    def find_matches(kq, kt, warp, cert, q_hw, t_hw, mq, mt):
        nq = normalize_coords(kq, q_hw)
        kq_to_t = denormalize_coords(grid_sample_normalized(warp, nq), t_hw)
        scores = grid_sample_normalized(cert[..., None], nq)[..., 0]
        dist = torch.linalg.vector_norm(kq_to_t[:, :, None, :] - kt[:, None, :, :], dim=-1)
        if mt is not None:
            dist = torch.where(mt[:, None, :], dist, torch.full((), float("inf"), device=dist.device))
        match_dist = dist.amin(dim=-1)
        matches = torch.argmin(dist, dim=-1)  # the first minimum, as jnp.argmin
        valid = torch.isfinite(match_dist) & (match_dist < max_kp_error)
        if mutual_check:
            rev = torch.argmin(dist, dim=-2)
            back = torch.gather(rev, 1, matches)
            valid = valid & (back == torch.arange(kq.shape[1], device=kq.device)[None])
        valid = valid & (scores > filter_threshold)
        if mq is not None:
            valid = valid & mq
        return (torch.where(valid, matches, torch.full_like(matches, -1)).to(torch.int32),
                torch.where(valid, scores, torch.zeros((), device=scores.device)))

    m0, s0 = find_matches(kpts0, kpts1, pred["warp0"], pred["certainty0"], hw0, hw1, mask0, mask1)
    m1, s1 = find_matches(kpts1, kpts0, pred["warp1"], pred["certainty1"], hw1, hw0, mask1, mask0)
    return {"matches0": m0, "matching_scores0": s0, "matches1": m1, "matching_scores1": s1,
            "keypoints0": kpts0, "keypoints1": kpts1}


def gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def multinomial_no_replacement(weights: torch.Tensor, k: int, noise: torch.Tensor) -> torch.Tensor:
    """Indices of k draws without replacement, in proportion to `weights`
    (Gumbel top-k with the given noise)."""
    return torch.topk(torch.log(weights.clamp_min(1e-30)) + noise, k, sorted=True).indices


def kde_density(x: torch.Tensor, std: float = 0.1) -> torch.Tensor:
    """Gaussian KDE over match 4-vectors (romatch `kde`): density_i =
    sum_j exp(-|x_i - x_j|^2 / (2 std^2)), in row blocks."""
    n = x.shape[0]
    rows = max(1, KDE_BLOCK // max(n, 1))
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    for i in range(0, n, rows):
        d2 = ((x[i:i + rows, None, :] - x[None, :, :]) ** 2).sum(-1)
        out[i:i + rows] = torch.exp(-d2 / (2.0 * std * std)).sum(-1)
    return out


def sample_matches(pred: dict, hw0, hw1, num: int, generator: torch.Generator | None = None,
                   sample_mode: str = "threshold_balanced", sample_thresh: float = 0.05,
                   balanced_expansion: int = 4, kde_std: float = 0.1, min_density: float = 10.0,
                   noise: tuple | None = None) -> dict:
    """Exactly `num` sparse matches from the symmetric dense warps (batch
    1); `keypoint_scores` carry the certainty (0 where a draw fell on a
    certainty-0 pixel). `noise` (two Gumbel tensors: over every warp pixel
    of both directions, then over the first draw) replaces the draws from
    `generator`."""
    warp0, warp1 = pred["warp0"], pred["warp1"]
    cert0, cert1 = pred["certainty0"], pred["certainty1"]
    if warp0.shape[0] != 1:
        raise ValueError(f"dense sampling is defined for batch 1, got {warp0.shape[0]}")
    dev = warp0.device
    H0, W0 = warp0.shape[1:3]
    H1, W1 = warp1.shape[1:3]
    coords0 = get_pixel_grid(H0, W0, True, dev)[None]
    coords1 = get_pixel_grid(H1, W1, True, dev)[None]
    # rows: [x0, y0, x1, y1], normalised
    matches = torch.cat([torch.cat([coords0, warp0], -1).reshape(-1, 4),
                         torch.cat([warp1, coords1], -1).reshape(-1, 4)])
    certainty = torch.cat([cert0.reshape(-1), cert1.reshape(-1)])
    if "threshold" in sample_mode:  # confident-enough pixels are drawn uniformly
        certainty = torch.where(certainty > sample_thresh, torch.ones((), device=dev), certainty)

    def draw(i, n):
        return noise[i].to(dev) if noise is not None else gumbel((n,), generator, dev)

    if "balanced" in sample_mode:
        k1 = min(balanced_expansion * num, matches.shape[0])
        good = multinomial_no_replacement(certainty, k1, draw(0, certainty.shape[0]))
        gm, gc = matches[good], certainty[good]
        density = kde_density(gm, kde_std)
        p = 1.0 / (density + 1.0)
        p = torch.where(density < min_density, torch.full((), 1e-7, device=dev), p)  # sparse regions
        # fewer than k1 positive rows: draws on certainty 0 get no weight
        p = torch.where(gc > 0, p, torch.full((), 1e-30, device=dev))
        sel = multinomial_no_replacement(p, min(num, k1), draw(1, k1))
        m_kpts, scores = gm[sel], gc[sel]
    else:
        sel = multinomial_no_replacement(certainty, min(num, matches.shape[0]), draw(0, certainty.shape[0]))
        m_kpts, scores = matches[sel], certainty[sel]
    scores = scores.reshape(1, -1)
    n = scores.shape[-1]
    arange = torch.arange(n, dtype=torch.int32, device=dev)[None]
    return {
        "keypoints0": denormalize_coords(m_kpts[:, :2], hw0).reshape(1, n, 2),
        "keypoints1": denormalize_coords(m_kpts[:, 2:], hw1).reshape(1, n, 2),
        "matching_scores0": scores,
        "matching_scores1": scores,
        "keypoint_scores0": scores,
        "keypoint_scores1": scores,
        "keypoint_mask0": scores > 0,
        "keypoint_mask1": scores > 0,
        "matches0": arange,
        "matches1": arange,
    }


class RoMa(BaseModel):
    default_conf = {
        "sample": False,
        "add_cycle_error": False,
        "sample_num_matches": 0,  # > 0: sample dense matches, ignore keypoints
        "sample_mode": "threshold_balanced",
        "filter_threshold": 0.05,
        "max_kp_error": 2.0,
        "mutual_check": True,
        # the dense warp's source: "native" runs the network (roma_net.py),
        # "data" needs warp / flow inputs
        "backend": "native",
        "net": dict(NET_DEFAULT_CONF),
        "weights": "outdoor",  # read nowhere; kept for the configs
        "internal_hw": [560, 560],
        "output_hw": None,  # None: the views' size
        "upsample_preds": True,
        "symmetric": True,  # the network always computes both directions
        "mixed_precision": True,
        "trainable": False,
    }
    required_data_keys = ["view0", "view1"]
    uses_generator = True  # the pipeline passes its generator: the match sampling's noise

    def _init(self, conf):
        if conf.backend == "native":
            self.encoder, self.decoder = Encoder(conf.net), RoMaDecoder(conf.net)

    def _prep(self, image: torch.Tensor, hw) -> torch.Tensor:
        """[0, 1] (B, H, W, C) -> ImageNet-normalised (B, 3, h, w) at `hw`
        (bilinear, antialiased on a downsample), rounded to bfloat16 with
        `mixed_precision`."""
        x = image.permute(0, 3, 1, 2).float()
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        x = resize(x, int(hw[0]), int(hw[1]))
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
        x = (x - mean) / std
        return x.to(torch.bfloat16).float() if self.conf.mixed_precision else x

    def dense_warp(self, data: dict) -> dict:
        """warp0 / certainty0 (0 -> 1) and warp1 / certainty1 from the
        network's two passes."""
        c = self.conf
        img0, img1 = data["view0"]["image"], data["view1"]["image"]
        B = img0.shape[0]
        internal = tuple(int(v) for v in c.internal_hw)
        corresps = symmetric_forward(self.encoder, self.decoder, self._prep(img0, internal),
                                     self._prep(img1, internal))
        lr_certainty = corresps[16]["certainty"].float()
        flow, certainty = corresps[1]["flow"].float(), corresps[1]["certainty"].float()
        if c.upsample_preds:  # a refiner-only pass at the output size
            hw0 = tuple(c.output_hw) if c.output_hw else tuple(img0.shape[1:3])
            hw1 = tuple(c.output_hw) if c.output_hw else tuple(img1.shape[1:3])
            if hw0 != hw1:
                raise ValueError(f"RoMa's upsample pass needs equal view sizes, got {hw0} and {hw1}")
            sf = float((hw0[0] * hw0[1] / (internal[0] * internal[1])) ** 0.5)
            del corresps
            corresps = symmetric_forward(self.encoder, self.decoder, self._prep(img0, hw0),
                                         self._prep(img1, hw1), flow=flow, certainty=certainty,
                                         upsample=True, scale_factor=sf)
            flow, certainty = corresps[1]["flow"].float(), corresps[1]["certainty"].float()
        out_q = flow_to_warp(flow[:B], certainty[:B], lr_certainty[:B])
        out_s = flow_to_warp(flow[B:], certainty[B:], lr_certainty[B:])
        return {"warp0": out_q["warp"], "certainty0": out_q["certainty"],
                "warp1": out_s["warp"], "certainty1": out_s["certainty"]}

    def _forward(self, data: dict, train: bool = False, generator: torch.Generator | None = None) -> dict:
        """`generator` draws the match sampling's noise."""
        c = self.conf
        pred: dict = {}
        for v in ("0", "1"):
            if f"warp{v}" in data:
                pred[f"warp{v}"] = data[f"warp{v}"]
                pred[f"certainty{v}"] = data[f"certainty{v}"]
            elif f"flow{v}" in data:
                out = flow_to_warp(data[f"flow{v}"], data[f"certainty_logits{v}"], data.get(f"lr_certainty{v}"))
                pred[f"warp{v}"], pred[f"certainty{v}"] = out["warp"], out["certainty"]
            elif c.backend == "native":
                # both directions at once; keys the data gave stay
                pred.update({k: x for k, x in self.dense_warp(data).items() if k not in pred})
                break
            else:
                raise NotImplementedError(
                    "RoMa needs a dense warp source: provide warp{0,1}/certainty{0,1} or "
                    "flow{0,1}/certainty_logits{0,1} in the data, or set backend: native.")
        if c.add_cycle_error:
            pred["cycle_error0"] = cycle_dist(pred["warp0"], pred["warp1"])
            pred["cycle_error1"] = cycle_dist(pred["warp1"], pred["warp0"])
        if c.sample_num_matches > 0:
            pred.update(sample_matches(pred, _view_hw(data["view0"]), _view_hw(data["view1"]),
                                       int(c.sample_num_matches), generator, sample_mode=c.sample_mode,
                                       sample_thresh=c.filter_threshold))
        elif "keypoints0" in data:
            pred.update(match_keypoints_dense(pred, data, c.max_kp_error, c.filter_threshold, c.mutual_check))
        return pred

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError("RoMa is eval-only (as in the JAX package and the reference)")
