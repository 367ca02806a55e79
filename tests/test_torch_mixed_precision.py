"""`train.mixed_precision: bf16` against the JAX package's
`make_train_step(model, tx, mixed_precision="bf16")`.

A small SuperPoint (channels [8, 8, 16, 16], frozen, random weights) +
LightGlue (2 layers, d = 64, 2 heads) pipeline takes one SGD step in both
packages on the same batch, its weights carried by `from_jax_params`. SGD
keeps the update linear in the gradient, so the updated parameters show
the gradient itself.

SuperPoint picks its keypoints by the top-k of a bf16 score map, whose
order flips wherever two scores lie within bf16's rounding of each other,
and XLA and PyTorch round differently (XLA's even between its jitted and
its eager forward). So in both packages `top_k_keypoints` returns the
keypoints of the float32 forward, each package's own bf16 scores at them,
and each package computes everything else itself.

Measured on the CPU: every loss term within 8.2e-4 relative, every
parameter's update within 0.051 of the largest entry of JAX's update
(XLA's CPU fusions keep float32 between operations where PyTorch rounds
each to bf16, and a bias's gradient sums many bf16 products). Bounds: 5e-3
relative on the losses, 0.1 of the largest update entry on the updates.
Every prediction has JAX's dtype; the gradients and the parameters stay
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu import train as jax_train
from gluefactory_tpu.core.config import Config as JConfig
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.extractors import superpoint as jax_superpoint
from gluefactory_tpu_torch import train as torch_train
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.core.config import Config, merge
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors import superpoint as torch_superpoint

from test_torch_train_step import HEADS, MODEL, make_batches, to_jax

LR = 1e-2
TRAIN = {"lr": LR, "optimizer": "sgd", "lr_schedule": {"type": None}}
LOSS_TOL, UPDATE_TOL = 5e-3, 0.1


def model_conf(checkpointed):
    return {k: v for k, v in merge(Config(MODEL), {"matcher": {"checkpointed": checkpointed,
                                                               "n_layers": 2}}).to_dict().items()
            if k != "name"}


def _bf16(x):
    return x.astype(jnp.bfloat16) if isinstance(x, jnp.ndarray) and x.dtype == jnp.float32 else x


@pytest.fixture(scope="module")
def jax_run():
    batch = make_batches(1)[0]
    jb = to_jax(batch)
    model = jax_get_model("two_view_pipeline").from_conf(model_conf(False))
    key = jax.random.key(0)
    params = jax.jit(model.init, static_argnames="method")(
        {"params": key, "sample": key}, jb, method="initialize")["params"]

    def forward(p, b):
        return model.apply({"params": p}, b, method="forward_with_loss", mutable=["batch_stats"],
                           rngs={"sample": key})[0][0]

    pred = jax.jit(forward)(params, jb)
    keypoints = np.concatenate([np.asarray(pred["keypoints0"]), np.asarray(pred["keypoints1"])])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_superpoint, "top_k_keypoints", fixed_top_k(keypoints, jnp))
        out = _jax_bf16_step(model, params, jb, key, forward)
    return {**out, "batch": batch, "keypoints": keypoints}


def fixed_top_k(keypoints: np.ndarray, xp):
    """`top_k_keypoints` (of `jnp` or `torch`) that returns `keypoints`
    (both views stacked, as the pipelines run them), the score map's values
    at them, all valid."""
    def top_k(nmsed, k, threshold=0.0, nms_radius=None):
        B, H, W = nmsed.shape
        idx = ((keypoints[..., 1] - 0.5) * W + keypoints[..., 0] - 0.5).astype(np.int64)
        flat = nmsed.reshape(B, -1)
        if xp is jnp:
            return (jnp.asarray(keypoints), jnp.take_along_axis(flat, jnp.asarray(idx), axis=1),
                    jnp.ones(idx.shape, bool))
        return (torch.from_numpy(keypoints), torch.gather(flat, 1, torch.from_numpy(idx)),
                torch.ones(idx.shape, dtype=torch.bool))

    return top_k


def _jax_bf16_step(model, params, jb, key, forward):
    """JAX's bf16 step (SGD) from `params`, and the dtypes of its bf16
    forward's predictions."""
    conf = JConfig(merge(Config(torch_train.default_train_conf), TRAIN).to_dict())
    tx, _ = jax_train.build_optimizer(conf, params, model, 4)
    step = jax.jit(jax_train.make_train_step(model, tx, mixed_precision="bf16"))
    new, _, losses, _, info = step({"params": params}, tx.init(params), jb, key)
    assert bool(info["ok"])
    fwd = dict(jb)
    for v in ("view0", "view1"):
        fwd[v] = {**fwd[v], "image": _bf16(fwd[v]["image"])}
    pred = jax.eval_shape(forward, jax.tree.map(_bf16, params), fwd)
    return {"params": jax.tree.map(np.asarray, params),
            "new": jax.tree.map(np.asarray, new["params"]),
            "losses": {k: float(v) for k, v in losses.items()},
            "dtypes": {k: str(v.dtype) for k, v in pred.items() if hasattr(v, "dtype")}}


@pytest.fixture
def jax_keypoints(jax_run, monkeypatch):
    monkeypatch.setattr(torch_superpoint, "top_k_keypoints", fixed_top_k(jax_run["keypoints"], torch))


def port_model(jax_run, checkpointed=False):
    model = get_model("two_view_pipeline").from_conf(model_conf(checkpointed), device="cpu")
    model.load_state_dict(from_jax_params(jax_run["params"], "two_view_pipeline", num_heads=HEADS))
    return model


def port_step(model):
    conf = merge(Config(torch_train.default_train_conf), TRAIN)
    opt, schedule = torch_train.build_optimizer(conf, model, 4)
    return torch_train.TrainStep(model, opt, schedule, max_updates=1, mixed_precision="bf16")


def test_predictions_have_jax_dtypes(jax_run, jax_keypoints):
    model = port_model(jax_run)
    fb = torch_train._ForwardBackward(model)
    cast = {"model." + n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
    seen = {}
    forward = model.forward_with_loss

    def spy(*args, **kwargs):
        pred, losses, metrics = forward(*args, **kwargs)
        seen.update(pred=pred, losses=losses)
        return pred, losses, metrics

    model.forward_with_loss = spy
    torch.func.functional_call(fb, cast, (torch_train.bf16_batch(jax_run["batch"]), None))
    want = {k: v.replace("bfloat16", "torch.bfloat16").replace("float32", "torch.float32")
            .replace("int32", "torch.int32").replace("bool", "torch.bool")
            for k, v in jax_run["dtypes"].items()}
    got = {k: str(v.dtype) for k, v in seen["pred"].items() if k in want}
    assert got == want
    assert all(v.dtype == torch.float32 for v in seen["losses"].values())
    assert want["descriptors0"] == "torch.bfloat16" and want["ref_descriptors0"] == "torch.bfloat16"


@pytest.mark.parametrize("checkpointed", [False, True])
def test_bf16_step_matches_jax(jax_run, jax_keypoints, checkpointed):
    model = port_model(jax_run, checkpointed)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, _, info = port_step(model)(jax_run["batch"], torch.Generator().manual_seed(0))
    assert bool(info["ok"])
    for k, want in jax_run["losses"].items():
        got = float(losses[k])
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1.0), (k, got, want)
    new = from_jax_params(jax_run["new"], "two_view_pipeline", num_heads=HEADS)
    old = from_jax_params(jax_run["params"], "two_view_pipeline", num_heads=HEADS)
    scale = max(float((new[n] - old[n]).abs().max()) for n in new)
    assert scale > 0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
        got, want = p.detach() - before[name], new[name] - old[name]
        assert float((got - want).abs().max()) <= UPDATE_TOL * scale, name


def test_checkpointed_recompute_sees_the_bf16_copies(jax_run, jax_keypoints):
    """The recompute of checkpointed layers runs on the same bf16 copies
    as the forward: gradients equal to those without checkpointing."""
    grads = []
    for checkpointed in (False, True):
        model = port_model(jax_run, checkpointed)
        port_step(model)(jax_run["batch"], torch.Generator().manual_seed(0))
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0)
