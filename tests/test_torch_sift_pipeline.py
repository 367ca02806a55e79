"""SIFT with its matchers in the port against the JAX package: LightGlue's
`add_scale_ori` (each keypoint's scale and orientation beside its
normalised position in the rotary encoding's input) in the dense, the
masked pruned and the serving forwards, the `sift+lightglue` and
`sift+NN` pipelines end to end, and one stage-1 training run with SIFT
frozen.

LightGlue takes the JAX model's weights (`initialize`, every head)
through `from_jax_params`, with `test_torch_pruning.py`'s heads, so every
threshold decision is clear by >= 1e-4 (asserted). Tolerances: the log
assignments 1e-4 absolute and 1e-5 relative, decisions (matches, prune
counts, exits) equal. The pipelines run the opencv backend, bit-equal in
both packages (`tests/test_torch_sift.py`), so LightGlue and the NN
matcher see the same keypoints, scales and orientations.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.core.config import from_yaml as jax_from_yaml
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.matchers.lightglue_serving import make_serving_fn as jax_serving_fn
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.core.config import from_yaml, merge
from gluefactory_tpu_torch.eval.io import extract_benchmark_conf, parse_config_path
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.matchers.lightglue_serving import make_serving_fn
from test_torch_pruning import (BASE, DIM, EXITS, HEADS, N_LAYERS, _head, assert_clear_margins,
                                assert_log_assignment_close, assert_same_decisions, case_params,
                                make_data, record_decision_values, to_torch)
from test_torch_sift import textured
from test_torch_train_cli import losses_of

ROOT = Path(__file__).resolve().parents[1]
SO = {**BASE, "add_scale_ori": True}
PRUNED = {**SO, "depth_confidence": 0.95, "width_confidence": 0.99}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this file's tests: the suite runs in several
    worker processes at once, where each process's default of one thread
    a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def so_data(seed=0):
    data = make_data(seed)
    rng = np.random.default_rng(seed + 1)
    for i in "01":
        shape = data[f"keypoints{i}"].shape[:2]
        data[f"scales{i}"] = rng.uniform(1.0, 30.0, shape).astype(np.float32)
        data[f"oris{i}"] = rng.uniform(-math.pi, math.pi, shape).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def so_params():
    """The JAX LightGlue's parameters with `add_scale_ori` (a (4, Dh/2)
    Wr), the identity input projection and the pruning tests' heads."""
    model = jax_get_model("lightglue").from_conf(SO)
    dj = {k: jnp.asarray(v) for k, v in so_data().items()}
    params = jax.jit(model.init, static_argnames="method")(
        {"params": jax.random.key(0)}, dj, method="initialize")["params"]
    params = jax.tree.map(np.asarray, params)
    assert params["posenc"]["Wr"]["kernel"].shape == (4, DIM // HEADS // 2)
    params["input_proj"] = {"kernel": np.eye(DIM, dtype=np.float32), "bias": np.zeros(DIM, np.float32)}
    for i in range(N_LAYERS - 1):
        params[f"log_assignment_{i}"]["matchability"] = _head(("channel", 2))
    return params


def port_lightglue(params, conf):
    model = get_model("lightglue").from_conf(conf, device="cpu").eval()
    sd = from_jax_params(params, "lightglue", HEADS)
    assert sd["posenc.Wr.weight"].shape == (DIM // HEADS // 2, 4)
    model.load_state_dict(sd)
    return model


def test_dense_forward_with_scale_ori(so_params):
    data = so_data()
    model_j = jax_get_model("lightglue").from_conf(SO)
    ref = jax.jit(model_j.apply)({"params": so_params}, {k: jnp.asarray(v) for k, v in data.items()})
    model = port_lightglue(so_params, SO)
    with torch.no_grad():
        pred = model(to_torch(data))
        moved = model(to_torch({**data, "oris0": data["oris0"] + 1.0}))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(pred[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert_log_assignment_close(pred["log_assignment"], ref["log_assignment"])
    np.testing.assert_allclose(pred["matching_scores0"].numpy(), np.asarray(ref["matching_scores0"]),
                               atol=1e-5)
    # the orientations enter the encoding
    assert not torch.allclose(moved["log_assignment"], pred["log_assignment"])


@pytest.mark.parametrize("serving", [False, True])
def test_pruned_and_serving_forwards_with_scale_ori(so_params, serving):
    """The masked pruned forward and the serving function, each against
    JAX's, on the pruning tests' "mixed" heads (items exit at layers 1 and
    2, tokens width-pruned before)."""
    data = so_data()
    params = case_params(so_params, "mixed")
    model_j = jax_get_model("lightglue").from_conf(PRUNED)
    dj = {k: jnp.asarray(v) for k, v in data.items()}
    model = port_lightglue(params, PRUNED)
    seen = record_decision_values(model)
    with torch.no_grad():
        if serving:
            ref = jax_serving_fn(model_j, {"params": params})(dj)
            pred = make_serving_fn(model)(to_torch(data))
            assert pred["exit_layer"].tolist() == np.asarray(ref["exit_layer"]).tolist() == EXITS["mixed"]
        else:
            ref = model_j.apply({"params": params}, dj)
            pred = model(to_torch(data))
    assert_same_decisions({k: v.numpy() for k, v in pred.items()}, {k: np.asarray(v) for k, v in ref.items()})
    assert_clear_margins(seen, data, PRUNED["width_confidence"])
    assert (pred["prune0"].numpy()[data["keypoint_mask0"]] < N_LAYERS).any()


def _pair(size=(128, 96)):
    w, h = size
    im0 = textured(5, w, h)
    im1 = np.roll(im0, (4, 7), (0, 1)).copy()
    return {f"view{i}": {"image": np.repeat(im[None, ..., None], 3, -1),
                         "image_size": np.array([[w, h]], np.float32)} for i, im in enumerate((im0, im1))}


@pytest.mark.parametrize("config,matcher", [
    ("sift+lightglue-official", {"n_layers": 2, "descriptor_dim": 64, "num_heads": 2, "flash": False,
                                 "filter_threshold": 0.0}),
    ("sift+NN", {}),
])
def test_sift_pipelines_match_jax(config, matcher):
    """The config's megadepth1500 model by name (opencv SIFT, 64 keypoints)
    in both packages: the matcher's outputs (the JAX LightGlue's weights
    through `from_jax_params`)."""
    over = {"extractor": {"max_num_keypoints": 64}, "matcher": matcher}
    conf = merge(extract_benchmark_conf(from_yaml(str(parse_config_path(config))), "megadepth1500").model,
                 over).to_dict()
    conf = {k: v for k, v in conf.items() if k != "name"}
    data = _pair()
    dj = jax.tree.map(jnp.asarray, data)
    model_j = jax_get_model("two_view_pipeline").from_conf(conf)
    variables = {"params": {}}
    if matcher:  # every LightGlue head, as `from_jax_params` needs them
        variables = jax.jit(model_j.init, static_argnames="method")(jax.random.key(0), dj,
                                                                     method="initialize")
    ref = {k: np.asarray(v) for k, v in jax.jit(model_j.apply)(variables, dj).items()}
    port = get_model("two_view_pipeline").from_conf(conf, device="cpu").eval()
    if matcher:
        params = jax.tree.map(np.asarray, variables["params"])
        port.load_state_dict(from_jax_params(params, "two_view_pipeline", HEADS))
    with torch.no_grad():
        pred = {k: v.numpy() for k, v in port(jax.tree.map(torch.from_numpy, data)).items()}
    for k in ("keypoints0", "scales1", "oris0", "descriptors1", "keypoint_mask0"):
        np.testing.assert_array_equal(pred[k], ref[k], err_msg=k)
    assert ref["keypoint_mask0"].sum() >= 30 and (ref["matches0"] >= 0).sum() >= 5
    np.testing.assert_array_equal(pred["matches0"], ref["matches0"])
    np.testing.assert_array_equal(pred["matches1"], ref["matches1"])
    np.testing.assert_allclose(pred["matching_scores0"], ref["matching_scores0"], atol=1e-5, rtol=0)
    if matcher:
        assert_log_assignment_close(pred["log_assignment"], ref["log_assignment"])


def test_stage1_training_with_frozen_sift(tmp_path):
    """`sift+lightglue_homography` by name through the train CLI on the CPU,
    the device backend, two steps and a validation batch: finite losses,
    SIFT frozen (no parameter), LightGlue with `add_scale_ori` trained."""
    env = {**os.environ, "GLUEFACTORY_TRAINING": str(tmp_path), "OMP_NUM_THREADS": "1"}
    args = ["--no_tensorboard", "--no_capture", "--max_val_iters", "1", "data.synthetic_images=8",
            "data.train_size=4", "data.val_size=2", "data.batch_size=2", "data.num_workers=0",
            "data.source_size=[128,96]", "data.homography.patch_shape=[128,96]",
            "data.photometric.name=identity", "model.extractor.backend=jax",
            "model.extractor.max_num_keypoints=64", "model.matcher.n_layers=2",
            "model.matcher.descriptor_dim=64", "model.matcher.num_heads=2", "train.epochs=1",
            "train.log_every_iter=1", "train.eval_every_iter=100"]
    res = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.train", "sift1", "--device", "cpu",
                          "--conf", "sift+lightglue_homography", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    log = res.stdout + res.stderr
    assert res.returncode == 0, log
    steps = losses_of(log)
    assert [(e, i) for e, i, _ in steps] == [(0, 0), (0, 1)] and "[Validation]" in log
    assert all(math.isfinite(v) for _, _, terms in steps for v in terms.values())
    ckpt = torch.load(tmp_path / "sift1" / "checkpoint_best.tar", map_location="cpu", weights_only=False)
    state = ckpt["model"]
    assert state["matcher.posenc.Wr.weight"].shape == (64 // 2 // 2, 4)  # (head dim / 2, 4)
    assert not any(k.startswith("extractor.") for k in state)
    conf = jax_from_yaml(str(Path(ROOT, "gluefactory_tpu/configs/sift+lightglue_homography.yaml")))
    assert conf.model.extractor.trainable is False and conf.model.matcher.add_scale_ori is True
