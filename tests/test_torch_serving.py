"""The port's early-exit serving path (`lightglue_serving.make_serving_fn`)
against the JAX package's on the same seeded inputs and weights, against
the port's own masked pruned forward, and against the dense forward where
no item exits early. Inputs and heads: `test_torch_pruning.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.matchers.lightglue_serving import make_serving_fn as jax_serving_fn
from gluefactory_tpu_torch.models.matchers.lightglue_serving import make_serving_fn
from test_torch_pruning import (BASE, CASES, EXITS, N_LAYERS, assert_clear_margins,
                                assert_log_assignment_close, assert_same_decisions, case_params,
                                jax_params, make_data, port_model, record_decision_values, to_torch)

SERVING = [(0.95, -1.0), (0.95, 0.99)]
KEYS = ("log_assignment", "matches0", "matches1", "matching_scores0", "matching_scores1",
        "prune0", "prune1")


@pytest.fixture(scope="module")
def base_params():
    return jax_params()


@pytest.fixture(scope="module")
def jax_serving(base_params):
    """The JAX serving function's outputs, by (depth, width, case)."""
    data = {k: jnp.asarray(v) for k, v in make_data().items()}
    out = {}
    for depth, width in SERVING:
        model = jax_get_model("lightglue").from_conf(
            {**BASE, "depth_confidence": depth, "width_confidence": width})
        for case in CASES:
            fn = jax_serving_fn(model, {"params": case_params(base_params, case)})
            out[depth, width, case] = {k: np.asarray(v) for k, v in fn(data).items()}
    return out


def serve(params, conf, data):
    model = port_model(params, conf)
    with torch.no_grad():
        return make_serving_fn(model)(to_torch(data)), model


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("depth,width", SERVING)
def test_serving_matches_jax(base_params, jax_serving, depth, width, case):
    data = make_data()
    conf = {**BASE, "depth_confidence": depth, "width_confidence": width}
    model = port_model(case_params(base_params, case), conf)
    seen = record_decision_values(model)
    with torch.no_grad():
        pred = make_serving_fn(model)(to_torch(data))
    ref = jax_serving[depth, width, case]
    assert pred["exit_layer"].dtype == torch.int32
    assert pred["exit_layer"].tolist() == ref["exit_layer"].tolist() == EXITS[case]
    assert_same_decisions({k: v.numpy() for k, v in pred.items()}, ref)
    assert_clear_margins(seen, data, width)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("depth,width", SERVING)
def test_serving_equals_the_masked_path(base_params, depth, width, case):
    """Serving and the masked forward run the same layers on the items
    still running: equal outputs, float for float."""
    data = make_data()
    conf = {**BASE, "depth_confidence": depth, "width_confidence": width}
    pred, model = serve(case_params(base_params, case), conf, data)
    with torch.no_grad():
        masked = model(to_torch(data))
    for k in KEYS:
        torch.testing.assert_close(pred[k], masked[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("depth,width", SERVING)
def test_serving_without_exit_equals_the_dense_forward(base_params, depth, width):
    """Items that never exit early run every layer unpruned (no token is
    confident, so none is width-pruned): the dense forward's outputs."""
    data = make_data()
    params = case_params(base_params, "no_exit")
    pred, _ = serve(params, {**BASE, "depth_confidence": depth, "width_confidence": width}, data)
    dense = port_model(params, BASE)
    with torch.no_grad():
        ref = dense(to_torch(data))
    assert pred["exit_layer"].tolist() == [N_LAYERS - 1] * 2
    for k in ref:
        torch.testing.assert_close(pred[k], ref[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_serving_runs_only_the_layers_before_the_exit(base_params, case):
    """Each transformer layer runs once up to the deepest exit and never
    after it (on the card, each attention kernel launches that often)."""
    conf = {**BASE, "depth_confidence": 0.95, "width_confidence": 0.99}
    model = port_model(case_params(base_params, case), conf)
    calls = []
    for i, layer in enumerate(model.transformers):
        layer.register_forward_hook(lambda m, a, out, i=i: calls.append(i))
    with torch.no_grad():
        make_serving_fn(model)(to_torch(make_data()))
    assert calls == list(range(max(EXITS[case]) + 1))


def test_serving_below_the_guard_runs_dense(base_params):
    """Below `pruning_min_kpts` the serving function runs the dense forward:
    every item exits at the last layer with prune counts n_layers, as the
    JAX serving function's guard does."""
    data = make_data()
    params = case_params(base_params, "exit_1")
    conf = {**BASE, "depth_confidence": 0.95, "width_confidence": 0.99, "pruning_min_kpts": 128}
    pred, _ = serve(params, conf, data)
    with torch.no_grad():
        ref = port_model(params, BASE)(to_torch(data))
    jax_model = jax_get_model("lightglue").from_conf(conf)
    jref = jax_serving_fn(jax_model, {"params": params})({k: jnp.asarray(v) for k, v in data.items()})
    assert pred["exit_layer"].tolist() == np.asarray(jref["exit_layer"]).tolist() == [N_LAYERS - 1] * 2
    for k in ("prune0", "prune1"):
        assert (pred[k] == N_LAYERS).all()
        np.testing.assert_array_equal(pred[k].numpy(), np.asarray(jref[k]))
    for k in ref:
        torch.testing.assert_close(pred[k], ref[k], rtol=0, atol=0, msg=k)
    assert_log_assignment_close(pred["log_assignment"].numpy(), jref["log_assignment"])


def test_serving_needs_an_exit_rule(base_params):
    model = port_model(case_params(base_params, "no_exit"), {**BASE, "width_confidence": 0.99})
    with pytest.raises(ValueError, match="depth_confidence"):
        make_serving_fn(model)
