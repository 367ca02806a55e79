"""The port's adaptive pruning (LightGlue's masked `_pruned_forward`, the
token-confidence and matchability heads, the pruning guard) against the JAX
package's on the same seeded inputs and weights.

The heads are set so that every compared threshold decision is clear-cut:
the input projection is the identity and three descriptor channels carry
offsets of +-12 (channel 0 by item, channels 1 and 2 by token), and a head
reads one of them. The test asserts that margin instead of relying on it.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.matchers import lightglue as lg_mod

N_LAYERS, DIM, HEADS = 4, 64, 2
BASE = {"n_layers": N_LAYERS, "input_dim": DIM, "descriptor_dim": DIM, "num_heads": HEADS,
        "flash": False, "checkpointed": False, "filter_threshold": 0.01}
PRUNING = [(0.95, -1.0), (-1.0, 0.99), (0.95, 0.99)]
OFFSET = 12.0
# token-confidence heads by layer: ("bias", b) is a zero kernel and bias b
# (the JAX serving tests' `_bias_confidence`); ("channel", k) reads channel k
CASES = {
    "no_exit": {0: ("bias", -20.0), 1: ("bias", -20.0), 2: ("bias", -20.0)},
    "exit_1": {0: ("bias", -20.0), 1: ("bias", 20.0), 2: ("bias", 20.0)},
    # layer 0: ~40% of tokens confident (no exit), some pruned; layer 1:
    # item 0 confident everywhere (exits), item 1 nowhere; layer 2: item 1
    "mixed": {0: ("channel", 1), 1: ("channel", 0), 2: ("bias", 20.0)},
}
EXITS = {"no_exit": [3, 3], "exit_1": [1, 1], "mixed": [1, 2]}
MARGIN = 1e-4


def make_data(seed=0, B=2, M=24, N=20):
    rng = np.random.default_rng(seed)
    data = {"image_size0": np.full((B, 2), 100.0, np.float32),
            "image_size1": np.full((B, 2), 100.0, np.float32)}
    for i, n in (("0", M), ("1", N)):
        desc = rng.normal(size=(B, n, DIM))
        desc[:, :, 0] = OFFSET * np.where(np.arange(B) == 0, 1.0, -1.0)[:, None]
        desc[:, :, 1] = OFFSET * np.where(rng.uniform(size=(B, n)) < 0.4, 1.0, -1.0)
        desc[:, :, 2] = OFFSET * np.where(rng.uniform(size=(B, n)) < 0.5, 1.0, -1.0)
        data[f"keypoints{i}"] = rng.uniform(0, 100, (B, n, 2)).astype(np.float32)
        data[f"descriptors{i}"] = desc.astype(np.float32)
        data[f"keypoint_mask{i}"] = rng.uniform(size=(B, n)) > 0.15
    return data


def jax_params(seed=0):
    """All of the JAX LightGlue's parameters (`initialize` creates every
    head), with the identity input projection and every matchability head
    but the last reading channel 2."""
    model = jax_get_model("lightglue").from_conf(BASE)
    dj = {k: jnp.asarray(v) for k, v in make_data().items()}
    params = jax.jit(model.init, static_argnames="method")(
        {"params": jax.random.key(seed)}, dj, method="initialize")["params"]
    params = jax.tree.map(np.asarray, params)
    params["input_proj"] = {"kernel": np.eye(DIM, dtype=np.float32),
                            "bias": np.zeros(DIM, np.float32)}
    for i in range(N_LAYERS - 1):
        params[f"log_assignment_{i}"]["matchability"] = _head(("channel", 2))
    return params


def _head(spec):
    kernel = np.zeros((DIM, 1), np.float32)
    bias = np.zeros(1, np.float32)
    if spec[0] == "bias":
        bias[:] = spec[1]
    else:
        kernel[spec[1], 0] = 1.0
    return {"kernel": kernel, "bias": bias}


def case_params(base, case):
    params = {k: dict(v) for k, v in base.items()}
    for i, spec in CASES[case].items():
        params[f"token_confidence_{i}"] = {"token": _head(spec)}
    return params


def port_model(params, conf):
    model = get_model("lightglue").from_conf(conf, device="cpu").eval()
    model.load_state_dict(from_jax_params(params, "lightglue", HEADS))
    return model


def to_torch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def assert_log_assignment_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-4, rtol=1e-5)


def assert_same_decisions(pred, ref, keys=("prune0", "prune1", "matches0", "matches1")):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(pred[k]), np.asarray(ref[k]), err_msg=k)
    assert_log_assignment_close(pred["log_assignment"], ref["log_assignment"])


def record_decision_values(model):
    """Forward hooks that keep every token confidence (by layer) and every
    matchability logit of a layer with a width round (all but the last)
    that the model computes on the whole batch."""
    seen = {"conf": [], "z": []}
    for i, head in enumerate(model.token_confidence):
        head.register_forward_hook(lambda m, a, out, i=i: seen["conf"].append((i, out)))
    for head in model.log_assignment[:-1]:
        head.matchability.register_forward_hook(lambda m, a, out: seen["z"].append(out[..., 0]))
    return seen


def assert_clear_margins(seen, data, width):
    """Every threshold compare the run made on a valid token lies at least
    MARGIN from its threshold."""
    valid = [torch.from_numpy(data["keypoint_mask0"]), torch.from_numpy(data["keypoint_mask1"])]
    th = [min(0.8 + 0.1 * math.exp(-4.0 * i / N_LAYERS), 1.0) for i in range(N_LAYERS)]
    for i, (c0, c1) in seen["conf"]:
        for c, v in zip((c0, c1), valid):
            assert (c - th[i]).abs()[v].min() >= MARGIN
    if width > 0:
        for z in seen["z"]:
            v = valid[0] if z.shape == valid[0].shape else valid[1]
            if z.shape != v.shape:  # the serving path's final head on some items
                continue
            assert (torch.sigmoid(z.float()) - (1.0 - width)).abs()[v].min() >= MARGIN


@pytest.fixture(scope="module")
def base_params():
    return jax_params()


@pytest.fixture(scope="module")
def jax_masked(base_params):
    """The JAX masked pruned forward, by (depth, width, case)."""
    data = {k: jnp.asarray(v) for k, v in make_data().items()}
    out = {}
    for depth, width in PRUNING:
        model = jax_get_model("lightglue").from_conf(
            {**BASE, "depth_confidence": depth, "width_confidence": width})
        for case in CASES:
            pred = model.apply({"params": case_params(base_params, case)}, data)
            out[depth, width, case] = {k: np.asarray(v) for k, v in pred.items()}
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("depth,width", PRUNING)
def test_masked_pruned_forward_matches_jax(base_params, jax_masked, depth, width, case):
    data = make_data()
    conf = {**BASE, "depth_confidence": depth, "width_confidence": width}
    model = port_model(case_params(base_params, case), conf)
    seen = record_decision_values(model)
    with torch.no_grad():
        pred = model(to_torch(data))
    ref = jax_masked[depth, width, case]
    assert_same_decisions({k: v.numpy() for k, v in pred.items()}, ref)
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(pred[k].numpy(), ref[k], atol=1e-5)
    assert_clear_margins(seen, data, width)
    prune0 = pred["prune0"].numpy()
    if width > 0 and not (depth > 0 and case != "mixed"):
        # width pruning removed tokens (with depth on, only the mixed
        # case's heads make tokens confident, and only confident tokens go)
        assert (prune0[data["keypoint_mask0"]] < prune0.max()).any()
    if not width > 0:
        assert (prune0 == N_LAYERS).all()


def test_pruning_guard_resolves_by_device_type():
    """"auto" looks up the keypoints' device type in the JAX table's entries
    (its "gpu" entry under torch's "cuda"); an int overrides it."""
    from gluefactory_tpu.models.matchers.lightglue import PRUNING_KEYPOINT_THRESHOLDS as JAX_TABLE

    assert lg_mod.PRUNING_KEYPOINT_THRESHOLDS == {"cpu": JAX_TABLE["cpu"], "cuda": JAX_TABLE["gpu"]}
    conf = {**BASE, "depth_confidence": 0.95, "width_confidence": 0.99}
    auto = get_model("lightglue").from_conf(conf, device="cpu")
    assert auto.pruning_min_kpts(torch.device("cpu")) == -1
    assert auto.pruning_min_kpts(torch.device("cuda")) == 1024
    for v in (128, -1):
        fixed = get_model("lightglue").from_conf({**conf, "pruning_min_kpts": v}, device="cpu")
        assert fixed.pruning_min_kpts(torch.device("cpu")) == v
        assert fixed.pruning_min_kpts(torch.device("cuda")) == v


def test_int_guard_routes_a_small_problem_to_the_dense_forward(base_params):
    """With pruning on and 24 keypoints under a guard of 128, the forward is
    the dense one (no prune counts), as in the JAX package; -1 prunes."""
    data = make_data()
    params = case_params(base_params, "mixed")
    conf = {**BASE, "depth_confidence": 0.95, "width_confidence": 0.99, "pruning_min_kpts": 128}
    with torch.no_grad():
        pred = port_model(params, conf)(to_torch(data))
        dense = port_model(params, BASE)(to_torch(data))
        unguarded = port_model(params, {**conf, "pruning_min_kpts": -1})(to_torch(data))
    assert "prune0" not in pred and "prune0" in unguarded
    for k in dense:
        torch.testing.assert_close(pred[k], dense[k], rtol=0, atol=0, msg=k)
    ref = jax_get_model("lightglue").from_conf(conf).apply(
        {"params": params}, {k: jnp.asarray(v) for k, v in data.items()})
    assert "prune0" not in ref
    assert_log_assignment_close(pred["log_assignment"].numpy(), ref["log_assignment"])
    np.testing.assert_array_equal(pred["matches0"].numpy(), np.asarray(ref["matches0"]))


def test_heads_and_thresholds_match_jax(base_params):
    """TokenConfidence (f32 logits after the Linear, then the sigmoid),
    MatchAssignment.get_matchability and the per-layer thresholds."""
    from gluefactory_tpu.models.matchers.lightglue import MatchAssignment, TokenConfidence

    rng = np.random.default_rng(4)
    d0 = rng.normal(size=(2, 24, DIM)).astype(np.float32)
    d1 = rng.normal(size=(2, 20, DIM)).astype(np.float32)
    model = port_model(base_params, BASE)
    tc = {"params": base_params["token_confidence_0"]}
    la = {"params": base_params[f"log_assignment_{N_LAYERS - 1}"]}
    with torch.no_grad():
        for logits in (False, True):
            got = model.token_confidence[0](torch.from_numpy(d0), torch.from_numpy(d1),
                                            return_logits=logits)
            want = TokenConfidence().apply(tc, jnp.asarray(d0), jnp.asarray(d1), return_logits=logits)
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and g.shape == w.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-5)
        got = model.log_assignment[-1].get_matchability(torch.from_numpy(d0))
    want = MatchAssignment(DIM).apply(la, jnp.asarray(d0), method="get_matchability")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jax_model = jax_get_model("lightglue").from_conf(BASE)
    for i in range(N_LAYERS):
        assert model._confidence_threshold(i) == jax_model._confidence_threshold(i)


def test_pruning_builds_and_no_longer_raises():
    """The published serving defaults build (on the CPU here; `from_conf`
    places the model on "cuda" unless told otherwise)."""
    conf = {"depth_confidence": 0.95, "width_confidence": 0.99}
    model = get_model("lightglue").from_conf(conf, device="cpu")
    assert model.conf.depth_confidence == 0.95 and len(model.token_confidence) == 8
    assert inspect.signature(type(model).from_conf).parameters["device"].default == "cuda"
