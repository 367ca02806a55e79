"""The port's triplet pipeline and its view helpers against the JAX
package's on the same triplet batch and weights: a homography dataset
batch with `triplet: True` (three views, `H_0to1`, `H_0to2`, `H_1to2`),
each view's keypoints and descriptors given as its `cache` (no extractor,
so no random keypoint fill enters), LightGlue (2 layers, d = 64, 2 heads)
and the homography ground truth. The forward (stacked in one matcher pass
and pair by pair) and the summed loss over the three pairs, at train
(deep supervision) and at eval (with the metrics). Tolerances: losses and
log assignments within 1e-4 relative (f32 sums in another order), matches
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_lightglue
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.utils import misc as jax_misc
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.data.base_dataset import collate
from gluefactory_tpu_torch.data.homographies import HomographyDataset
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.utils import misc

HEADS, K, D, B = 2, 48, 64, 2
PAIRS = ("0to1", "0to2", "1to2")
DATA = {"synthetic_images": 4, "train_size": 4, "val_size": 1, "source_size": [96, 80],
        "triplet": True, "homography": {"patch_shape": [80, 64], "difficulty": 0.3, "max_angle": 20},
        "photometric": {"name": "identity"}}
RTOL = 1e-4


def _conf(batch_triplets: bool) -> dict:
    return {"batch_triplets": batch_triplets,
            "ground_truth": {"name": "homography_matcher", "th_positive": 3, "th_negative": 3},
            "matcher": {"name": "lightglue", "input_dim": D, "descriptor_dim": D, "n_layers": 2,
                        "num_heads": HEADS, "filter_threshold": 0.01, "flash": False,
                        "checkpointed": False}}


def _batch(seed=0) -> dict:
    """Two triplet items; view 0's keypoints warped into views 1 and 2 by
    the items' homographies (with jitter) and shared descriptors, so that
    pairs match and the GT has positives."""
    ds = HomographyDataset(DATA).get_dataset("train")
    batch = {k: v for k, v in collate([ds[0], ds[1]]).items() if k not in ("name", "idx")}
    rng = np.random.default_rng(seed)
    w, h = (float(x) for x in batch["view0"]["image_size"][0])
    k0 = rng.uniform([4, 4], [w - 4, h - 4], (B, K, 2))
    d0 = rng.normal(size=(B, K, D))
    for i in "012":
        if i == "0":
            kp = k0
        else:
            H = batch[f"H_0to{i}"].numpy().astype(np.float64)
            p = np.concatenate([k0, np.ones((B, K, 1))], -1) @ H.transpose(0, 2, 1)
            kp = p[..., :2] / p[..., 2:] + rng.normal(scale=0.5, size=(B, K, 2))
        desc = d0 + rng.normal(scale=0.2, size=(B, K, D))
        batch[f"view{i}"]["cache"] = {
            "keypoints": torch.from_numpy(kp.astype(np.float32)),
            "descriptors": torch.from_numpy((desc / np.linalg.norm(desc, axis=-1, keepdims=True))
                                            .astype(np.float32)),
            "keypoint_scores": torch.from_numpy(rng.uniform(size=(B, K)).astype(np.float32)),
        }
    return batch


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def runs():
    """The port's random weights (lecun-normal, zero biases) carried into
    JAX params by the JAX package's converter (quicker than a jitted init);
    JAX's forward and loss stacked at train and eval, and pair by pair at
    train (the matcher has no batch statistics, so stacked and per-pair
    eval runs are the same function; `test_stacked_and_per_pair_losses_agree`
    holds both packages to that)."""
    batch = _batch()
    jb = _to_jax(batch)
    torch.manual_seed(4)
    port = get_model("triplet_pipeline").from_conf(_conf(True), device="cpu")
    with torch.no_grad():
        for name, prm in port.named_parameters():
            if name.endswith("bias"):
                prm.zero_()
            elif prm.ndim >= 2:
                torch.nn.init.normal_(prm, std=prm[0].numel() ** -0.5)
    sd = {k[len("matcher."):]: v.numpy() for k, v in port.state_dict().items() if k.startswith("matcher.")}
    out = {"batch": batch, "params": {"matcher_model": convert_lightglue(sd, n_layers=2, dim=D,
                                                                         num_heads=HEADS)}}
    for bt, trains in ((True, (True, False)), (False, (True,))):
        model = jax_get_model("triplet_pipeline").from_conf(_conf(bt))
        apply = jax.jit(model.apply, static_argnames=("train", "method", "mutable"))
        for train in trains:
            (pred, losses, metrics), _ = apply({"params": out["params"]}, jb, train=train,
                                               method="forward_with_loss", mutable=("batch_stats",))
            out[bt, train] = jax.tree.map(np.asarray, (pred, losses, metrics))
    out[False, False] = out[True, False]
    return out


def _port(params, batch_triplets):
    model = get_model("triplet_pipeline").from_conf(_conf(batch_triplets), device="cpu")
    model.load_state_dict(from_jax_params(params, "two_view_pipeline", num_heads=HEADS))
    return model


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("batch_triplets", [True, False], ids=["stacked", "per_pair"])
def test_forward_and_loss_match_jax(runs, batch_triplets, train):
    want_pred, want_losses, want_metrics = runs[batch_triplets, train]
    model = _port(runs["params"], batch_triplets)
    with torch.no_grad():
        pred, losses, metrics = model.forward_with_loss(runs["batch"], train=train)
    for idx in PAIRS:
        for k in ("matches0", "matches1"):
            np.testing.assert_array_equal(pred[f"{k}_{idx}"].numpy(), want_pred[f"{k}_{idx}"])
        la, ref = pred[f"log_assignment_{idx}"].numpy(), want_pred[f"log_assignment_{idx}"]
        np.testing.assert_allclose(la, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())
    assert {k for k in pred if k.endswith(PAIRS)} == {k for k in want_pred if k.endswith(PAIRS)}
    assert set(losses) == set(want_losses) and set(metrics) == set(want_metrics)
    for k, v in want_losses.items():
        np.testing.assert_allclose(losses[k].numpy(), v, rtol=RTOL, atol=1e-6, err_msg=k)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=RTOL, atol=1e-6, err_msg=k)
    assert (want_metrics == {}) == train
    assert all(float(losses[f"num_matchable_{idx}"].min()) >= 5 for idx in PAIRS)


def test_stacked_and_per_pair_losses_agree(runs):
    """One matcher pass over the three stacked pairs and three passes give
    the same total loss, in both packages."""
    np.testing.assert_allclose(runs[True, True][1]["total"], runs[False, True][1]["total"], rtol=RTOL)
    got = {}
    for bt in (True, False):
        with torch.no_grad():
            got[bt] = _port(runs["params"], bt).forward_with_loss(runs["batch"], train=True)[1]["total"]
    torch.testing.assert_close(got[True], got[False], rtol=RTOL, atol=1e-6)


def test_view_helpers_match_jax(runs):
    batch = runs["batch"]
    jb = _to_jax(batch)
    for idx in PAIRS:
        got, want = misc.get_twoview_data(batch, idx), jax_misc.get_twoview_data(jb, idx)
        assert set(got) == set(want) == {"view0", "view1", "H_0to1"}
        np.testing.assert_array_equal(got["H_0to1"].numpy(), np.asarray(want["H_0to1"]))
    stacked = misc.map_multi([misc.get_twoview_data(batch, idx) for idx in PAIRS])
    jstacked = jax_misc.map_multi([jax_misc.get_twoview_data(jb, idx) for idx in PAIRS])
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jstacked)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), stacked))):
        np.testing.assert_array_equal(a, b)
    assert stacked["view1"]["image"].shape[0] == 3 * B
    split = misc.unstack_twoviews({"x": stacked["view1"]["image_size"]}, B)
    for n, idx in enumerate(PAIRS):
        torch.testing.assert_close(split[idx]["x"], batch[f"view{idx[-1]}"]["image_size"])
