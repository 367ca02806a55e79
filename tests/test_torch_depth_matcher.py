"""The port's `depth_matcher` (`models/matchers/depth_matcher.py`) against
the JAX package's on batches of procedural MegaDepth pairs (ray-cast planes,
`scripts_dev/posed_scenes.write_megadepth_scene`): keypoints projected from
view 0 with noise, outliers, points off the depth and padding slots, with
`th_epi` and `ccth` on and off. Matches, assignment and visibility equal;
the batch holds positives, both kinds of negative and ignored slots. With
`use_lines`, the line GT equal too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gluefactory_tpu.data.megadepth as jmd
import gluefactory_tpu_torch.settings as tsettings
from gluefactory_tpu.data.base_dataset import collate as jax_collate
from gluefactory_tpu.data.base_dataset import prepare_batch as jax_prepare_batch
from gluefactory_tpu.data import get_dataset as jax_get_dataset
from gluefactory_tpu.models.matchers.depth_matcher import DepthMatcher as JaxDepthMatcher
from gluefactory_tpu_torch.data import get_dataset
from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
from gluefactory_tpu_torch.geometry.depth import project, sample_depth
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scene

N = 64  # keypoint slots a view; the last PAD are padding


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_megadepth_scene(root / "megadepth", "s0", n_views=6, size=(128, 96), seed=3)
    return root


def _batches(root, monkeypatch, n_pairs=3):
    monkeypatch.setattr(jmd, "DATA_PATH", root)
    monkeypatch.setattr(tsettings, "DATA_PATH", root)
    conf = {"train_split": ["s0"], "train_num_per_scene": n_pairs, "min_overlap": 0.3,
            "max_overlap": 0.95, "preprocessing": {"resize": 96, "side": "long", "square_pad": True}}
    items = get_dataset("megadepth")(conf).get_dataset("train")
    jax_items = jax_get_dataset("megadepth")(conf).get_dataset("train")
    assert items.items == jax_items.items
    return (prepare_batch(collate([items[i] for i in range(n_pairs)]), "cpu"),
            jax_prepare_batch(jax_collate([jax_items[i] for i in range(n_pairs)])))


def _keypoints(batch, seed, pad):
    """kp0 uniform over the image; kp1 = kp0 projected through the GT with
    0.7 px noise, a quarter replaced by uniform points; masks with `pad`
    padding slots at the end of each view."""
    rng = np.random.default_rng(seed)
    B = batch["view0"]["image"].shape[0]
    w, h = (float(x) for x in batch["view0"]["image_size"][0])
    kp0 = torch.from_numpy(rng.uniform([0, 0], [w, h], (B, N, 2)).astype(np.float32))
    d0, valid0 = sample_depth(kp0, batch["view0"]["depth"])
    kp1, _ = project(kp0, d0, None, batch["view0"]["camera"], batch["view1"]["camera"],
                     batch["T_0to1"], valid0)
    kp1 = kp1 + torch.from_numpy(rng.normal(size=kp1.shape).astype(np.float32)) * 0.7
    out = rng.random((B, N)) < 0.25
    kp1[torch.from_numpy(out)] = torch.from_numpy(rng.uniform([0, 0], [w, h], (int(out.sum()), 2))
                                                  .astype(np.float32))
    kp1 = kp1[:, torch.from_numpy(rng.permutation(N))]
    mask = np.ones((B, N), bool)
    mask[:, N - pad:] = False
    return kp0, kp1, torch.from_numpy(mask)


@pytest.mark.parametrize("th_epi,ccth,pad", [(None, None, 0), (5.0, None, 6), (None, 0.1, 6),
                                             (5.0, 0.1, 10)])
def test_depth_matcher_equals_jax(scene_root, monkeypatch, th_epi, ccth, pad):
    batch, jax_batch = _batches(scene_root, monkeypatch)
    kp0, kp1, mask = _keypoints(batch, seed=pad, pad=pad)
    conf = {"th_positive": 3.0, "th_negative": 5.0, "th_epi": th_epi, "ccth": ccth}
    matcher = get_model("depth_matcher").from_conf(conf, device="cpu")
    got = matcher({**batch, "keypoints0": kp0, "keypoints1": kp1, "keypoint_mask0": mask,
                   "keypoint_mask1": mask})
    jax_matcher = JaxDepthMatcher.from_conf(conf)
    want = jax_matcher.apply({}, {**jax_batch, "keypoints0": jnp.asarray(kp0.numpy()),
                                  "keypoints1": jnp.asarray(kp1.numpy()),
                                  "keypoint_mask0": jnp.asarray(mask.numpy()),
                                  "keypoint_mask1": jnp.asarray(mask.numpy())})
    assert set(got) == set(want) == {"gt_matches0", "gt_matches1", "gt_assignment", "gt_visible0",
                                     "gt_visible1"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    m0 = got["gt_matches0"].numpy()
    assert (m0 >= 0).sum() >= 10 and (m0 == -1).sum() >= 3, np.unique(m0, return_counts=True)
    if pad:
        assert (m0[:, N - pad:] == -2).all()


def test_lines_raise(scene_root, monkeypatch):
    """`use_lines` (which raised before the line GT was ported): the line GT
    of `gt_line_matches_from_pose_depth` equal to JAX's, with segments of
    view 0 projected into view 1 with noise, shuffled, some replaced by
    random segments, and masked lines."""
    batch, jax_batch = _batches(scene_root, monkeypatch)
    rng = np.random.default_rng(21)
    B, L = batch["view0"]["image"].shape[0], 24
    w, h = (float(x) for x in batch["view0"]["image_size"][0])
    l0 = torch.from_numpy(rng.uniform([0, 0], [w, h], (B, L, 2, 2)).astype(np.float32))
    ep = l0.reshape(B, 2 * L, 2)
    d0, v0 = sample_depth(ep, batch["view0"]["depth"])
    ep1, _ = project(ep, d0, None, batch["view0"]["camera"], batch["view1"]["camera"],
                     batch["T_0to1"], v0)
    l1 = (ep1 + torch.from_numpy(rng.normal(scale=0.7, size=ep1.shape).astype(np.float32)))
    l1 = l1.reshape(B, L, 2, 2)[:, torch.from_numpy(rng.permutation(L))]
    l1[:, :4] = torch.from_numpy(rng.uniform([0, 0], [w, h], (B, 4, 2, 2)).astype(np.float32))
    lm = np.ones((B, L), bool)
    lm[:, -3:] = False
    kp0, kp1, mask = _keypoints(batch, seed=1, pad=4)
    conf = {"use_lines": True, "n_line_sampled_pts": 30}
    inputs = {"keypoints0": kp0, "keypoints1": kp1, "keypoint_mask0": mask,
              "keypoint_mask1": mask, "lines0": l0, "lines1": l1,
              "line_mask0": torch.from_numpy(lm), "line_mask1": torch.from_numpy(lm)}
    got = get_model("depth_matcher").from_conf(conf, device="cpu")({**batch, **inputs})
    want = JaxDepthMatcher.from_conf(conf).apply(
        {}, {**jax_batch, **{k: jnp.asarray(v.numpy()) for k, v in inputs.items()}})
    assert set(got) == set(want) and "gt_line_assignment" in got
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    m0 = got["gt_line_matches0"].numpy()
    assert (m0 >= 0).sum() >= 5 and (m0 == -2).sum() >= 3 * B, np.unique(m0, return_counts=True)
