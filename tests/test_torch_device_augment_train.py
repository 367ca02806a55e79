"""The port's trainer with `train.device_augment` and `steps_per_dispatch`
against the JAX trainer's rules, on the CPU.

- The augmentation keys of steps 0 and 3 (one step a dispatch, and two)
  are the JAX trainer's chain, bit for bit; the augmented batch equals
  JAX's `apply_device_augment` on that key: H_0to1 within 1e-4 relative,
  each view's pixels within 1e-4 plus twice the gap between the two
  packages' sampling points times the image's local slope (the float32
  DLTs differ, `tests/test_torch_device_homography.py`).
- A dispatch of two steps equals the two steps made one by one with the
  same generators and keys: parameters within 1e-6.
- `python -m gluefactory_tpu_torch.train` (in process) on the recipe's
  small config with `emit_source`, `device_augment` and
  `steps_per_dispatch=2`: finite losses, a checkpoint with every
  micro-step's update, the iterations logged, their lr and their sample
  counts as the JAX trainer computes them (`it % log_every_iter < K`,
  `schedule(total_iter * K)`, `batch * K` a dispatch).
"""

import copy
import io
import logging
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu import train as jax_train
from gluefactory_tpu.core.config import Config as JConfig
from gluefactory_tpu.core.config import from_yaml as jax_from_yaml
from gluefactory_tpu.data import device_homography as J
from gluefactory_tpu_torch import train
from gluefactory_tpu_torch.core.config import Config, merge
from gluefactory_tpu_torch.data import device_homography as T
from gluefactory_tpu_torch.data.base_dataset import collate
from gluefactory_tpu_torch.data.homographies import HomographyDataset, generate_synthetic_image
from gluefactory_tpu_torch.geometry.homography import warp_points
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.utils import experiments, threefry

SEED, SOURCE, PATCH = 0, (96, 80), (80, 64)
AUGMENT = {"name": "homography", "patch_size": list(PATCH), "difficulty": 0.7, "max_angle": 45}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the suite runs 6 workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_aug_keys(t, k):
    rng = jax.random.split(jax.random.key(SEED), 3)[2]
    step_rng = jax.random.fold_in(rng, t)
    rngs = [step_rng] if k == 1 else list(jax.random.split(step_rng, k))
    return [jax.random.split(r)[1] for r in rngs]


def _sources(n=2):
    return np.stack([generate_synthetic_image(i, SOURCE) for i in range(n)]).astype(np.float32)


_jax_augment = jax.jit(lambda batch, key: jax_train.apply_device_augment(batch, key, AUGMENT))


_jax_window_safe = jax.jit(J._sample_window_safe_homography, static_argnums=(1, 2, 3, 4, 5, 6),
                           static_argnames=("max_angle",))


def _view_homographies(jkey, tkey, n):
    """Each view's (JAX, port) homography of the tiled sampler under a key."""
    win = T.tiled_window(SOURCE[::-1], PATCH)
    args = (n, SOURCE, PATCH, 0.7, 1.0, win)
    jk, tk = jax.random.split(jkey, 4), threefry.split(tkey, 4)
    return [(np.asarray(_jax_window_safe(jk[i], *args, max_angle=45)),
             T._sample_window_safe_homography(tk[i], *args, max_angle=45)) for i in (0, 1)]


@pytest.mark.parametrize("t", [0, 3])
def test_augmented_batch_matches_jax(t):
    for k in (1, 2):
        want = [np.asarray(jax.random.key_data(key)) for key in _jax_aug_keys(t, k)]
        got = train.augment_keys(train.train_key(SEED), t, k)
        np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), np.stack(want).astype(np.int64))
    src = _sources()
    jkey = _jax_aug_keys(t, 1)[0]
    want = _jax_augment({"source_image": jnp.asarray(src), "idx": jnp.arange(2)}, jkey)
    key = train.augment_keys(train.train_key(SEED), t, 1)[0]
    got = train.apply_device_augment({"source_image": torch.from_numpy(src), "idx": torch.arange(2)},
                                     key, Config(AUGMENT))
    assert "source_image" not in got and set(got) == set(want)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    H_t, H_j = got["H_0to1"].numpy().astype(np.float64), np.asarray(want["H_0to1"], np.float64)
    assert (np.abs(H_t - H_j).max(axis=(1, 2)) / np.abs(H_j).max(axis=(1, 2))).max() <= 1e-4
    xs, ys = np.meshgrid(np.arange(PATCH[0]) + 0.5, np.arange(PATCH[1]) + 0.5)
    pts = torch.from_numpy(np.stack([xs, ys], -1).reshape(1, -1, 2).astype(np.float32)).expand(2, -1, 2)
    for view, (Hj, Ht) in zip(("view0", "view1"), _view_homographies(jkey, key, 2)):
        gap = (warp_points(pts, Ht, inverse=True) - warp_points(pts, torch.from_numpy(Hj), inverse=True)
               ).norm(dim=-1).reshape(2, PATCH[1], PATCH[0], 1).numpy()
        a, b = got[view]["image"].numpy(), np.asarray(want[view]["image"])
        pad = np.pad(b, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
        slope = np.max([np.abs(pad[:, 1:-1, 2:] - b), np.abs(pad[:, 1:-1, :-2] - b),
                        np.abs(pad[:, 2:, 1:-1] - b), np.abs(pad[:, :-2, 1:-1] - b)], axis=0)
        assert np.median(gap) <= 1e-3
        assert (np.abs(a - b) <= 1e-4 + 2 * gap * slope).all()
        np.testing.assert_array_equal(got[view]["image_size"].numpy(), np.asarray(want[view]["image_size"]))


MODEL = {
    "extractor": {"name": "superpoint", "channels": [8, 8, 16, 16], "head_channels": 32,
                  "descriptor_dim": 64, "max_num_keypoints": 32, "force_num_keypoints": True,
                  "detection_threshold": 0.0, "nms_radius": 3, "trainable": False},
    "ground_truth": {"name": "homography_matcher", "th_positive": 3, "th_negative": 3},
    "matcher": {"name": "lightglue", "input_dim": 64, "descriptor_dim": 64, "n_layers": 2,
                "num_heads": 2, "filter_threshold": 0.1, "flash": False},
}


def _step(model):
    conf = merge(Config(train.default_train_conf), {"lr": 1e-3})
    opt, schedule = train.build_optimizer(conf, model, 4)
    return train.TrainStep(model, opt, schedule, max_updates=4, device_augment=Config(AUGMENT))


def test_dispatch_equals_single_steps():
    torch.manual_seed(0)
    model = get_model("two_view_pipeline").from_conf(MODEL, device="cpu")
    twin = copy.deepcopy(model)
    ds = HomographyDataset({"synthetic_images": 4, "train_size": 4, "val_size": 0,
                            "source_size": list(SOURCE), "emit_source": True}).get_dataset("train")
    batches = [{k: v for k, v in collate([ds[2 * i], ds[2 * i + 1]]).items() if k != "name"}
               for i in range(2)]
    keys = train.augment_keys(train.train_key(SEED), 5, 2)
    gen = torch.Generator()
    gens = [train.step_generator(torch.Generator(), SEED, 10 + i) for i in range(2)]
    losses, _, info = train.dispatch(_step(model), batches, gens, keys)
    step = _step(twin)
    for i in range(2):
        last = step(batches[i], train.step_generator(gen, SEED, 10 + i), keys[i])
    assert bool(info["ok"]) and bool(last[2]["ok"])
    assert float(losses["total"]) == pytest.approx(float(last[0]["total"]), rel=1e-6, abs=1e-6)
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.allclose(p, q, atol=1e-6, rtol=0), n
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), get_model(
        "two_view_pipeline").from_conf(MODEL, device="cpu").parameters()))


CONF = "gluefactory_tpu/configs/superpoint+lightglue_homography.yaml"
RECIPE = [
    "--device", "cpu", "--conf", CONF, "--no_tensorboard", "--no_capture", "--max_val_iters", "1",
    "data.synthetic_images=8", "data.train_size=6", "data.val_size=2", "data.batch_size=2",
    "data.num_workers=0", "data.source_size=[96,80]", "data.emit_source=true",
    "model.extractor.max_num_keypoints=32", "model.matcher.n_layers=2",
    "model.matcher.descriptor_dim=64", "model.matcher.num_heads=2", "model.matcher.checkpointed=False",
    "train.log_every_iter=1", "train.eval_every_iter=100", "train.epochs=1", "train.steps_per_dispatch=2",
    "train.device_augment={name: homography, patch_size: [80, 64], difficulty: 0.7, max_angle: 45}",
]
LOG = re.compile(r"\[E (\d+) \| it (\d+)\] loss \{(.*)\} lr (\S+) (\S+) samples/s")


def test_cli_with_device_augment_and_two_steps_a_dispatch(tmp_path, monkeypatch):
    monkeypatch.setattr(train, "TRAINING_PATH", tmp_path)
    monkeypatch.setattr(train.time, "time", lambda: 0.0)  # samples/s = samples / 1e-9
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    train.logger.addHandler(handler)
    try:
        train.main(["vtest", *RECIPE])
    finally:
        train.logger.removeHandler(handler)
    log = buf.getvalue()
    lines = LOG.findall(log)
    # 3 loader batches: dispatches at it 1 (batches 0, 1) and 2 (batch 2, padded)
    assert [(int(e), int(i)) for e, i, *_ in lines] == [(0, 1), (0, 2)]
    for *_, body, _, _ in lines:
        assert all(math.isfinite(float(t.rsplit(" ", 1)[1])) for t in body.split(", "))
    jconf = jax_from_yaml(str(ROOT / CONF))
    schedule = jax_train.build_lr_schedule(JConfig(jconf.train.to_dict()), 3)
    assert [lr for *_, lr, _ in lines] == [f"{schedule(t * 2):.2e}" for t in (0, 1)]
    assert [round(float(s) * 1e-9) for *_, s in lines] == [4, 8]  # batch 2 x 2 steps a dispatch
    assert "[Validation]" in log and "Finished training." in log
    ckpt = experiments.load_checkpoint(tmp_path / "vtest" / "checkpoint_0_2.tar")
    assert ckpt["iter"] == 2 and ckpt["step"]["updates"] == 4
