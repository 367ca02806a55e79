"""The port's SuperGlue training against the JAX package's on the same
seeded inputs and weights (SuperGlue at d = 64, 2 layer pairs, 2 heads,
20 Sinkhorn iterations; padded keypoints on both sides; non-trivial
BatchNorm statistics).

- The train-mode forward (BatchNorm by the batch), the loss terms and
  every gradient against `apply(..., train=True, mutable=["batch_stats"])`
  and `jax.grad`, and the running statistics after the forward against the
  updated `batch_stats` (flax: 0.9 old + 0.1 batch, the biased variance).
- `checkpointed` against the plain forward: the same outputs, gradients and
  running statistics, which the recompute does not update a second time.
- Three Adam steps of the port's `TrainStep` on a pipeline holding the
  matcher against JAX's `make_train_step`, and a step the NaN-skip rejects
  (an lr of inf): the parameters and the optimizer state stay, and the
  running statistics keep the forward's update, as in JAX.
- The trainer's checkpoint and `--restore` carry the statistics bit-equal,
  and validation normalises by them.

Tolerances: losses and the log assignment within 1e-4 relative (f32
log-sum-exps over 20 Sinkhorn iterations summed in another order);
gradients within 1e-4 of their global norm; statistics within 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gluefactory_tpu import train as jax_train
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch import train as torch_train
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.optim import OPTIMIZERS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file's tests and fixtures: the suite runs 6
    workers on the host's cores, and torch's default pool oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADS = 2
SG_CONF = {"descriptor_dim": 64, "keypoint_encoder": [8, 16], "n_layers": 2, "num_heads": HEADS,
           "sinkhorn_iterations": 20, "filter_threshold": 0.01, "checkpointed": False}
LR = 1e-3
RTOL = 1e-4
STATS_TOL = 1e-5


def _data(rng, B=2, M=40, N=36, D=64, n_pad=(6, 9)):
    """View 1 holds a permuted, jittered copy of view 0; the last keypoints
    of one item a side are padding; the GT matches the permutation."""
    k0 = rng.uniform(0, 128, (B, M, 2))
    d0 = rng.normal(size=(B, M, D))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    perm = rng.permutation(M)[:N]
    k1 = k0[:, perm] + rng.normal(scale=0.5, size=(B, N, 2))
    d1 = d0[:, perm] + rng.normal(scale=0.05, size=(B, N, D))
    m0, m1 = np.ones((B, M), bool), np.ones((B, N), bool)
    m0[0, M - n_pad[0]:] = False
    m1[B - 1, N - n_pad[1]:] = False
    gt0 = np.full((B, M), -1, np.int32)
    gt1 = np.full((B, N), -1, np.int32)
    for j, i in enumerate(perm):
        keep = m0[:, i] & m1[:, j] & (rng.uniform(size=B) > 0.2)
        gt0[keep, i] = j
        gt1[keep, j] = i
    gt0[~m0], gt1[~m1] = -2, -2  # padding is neither matched nor unmatched
    gt_ass = np.zeros((B, M, N), bool)
    b, i = np.nonzero(gt0 >= 0)
    gt_ass[b, i, gt0[b, i]] = True
    return {
        "keypoints0": k0.astype(np.float32), "keypoints1": k1.astype(np.float32),
        "descriptors0": d0.astype(np.float32), "descriptors1": d1.astype(np.float32),
        "keypoint_scores0": rng.uniform(0, 1, (B, M)).astype(np.float32),
        "keypoint_scores1": rng.uniform(0, 1, (B, N)).astype(np.float32),
        "keypoint_mask0": m0, "keypoint_mask1": m1,
        "view0": {"image_size": np.asarray([[128.0, 96.0]] * B, np.float32)},
        "view1": {"image_size": np.asarray([[128.0, 96.0]] * B, np.float32)},
        "gt_matches0": gt0, "gt_matches1": gt1, "gt_assignment": gt_ass,
    }


def _randomize_batch_stats(rng, stats):
    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else jnp.asarray(
            rng.normal(0, 0.5, v.shape) if k == "mean" else rng.uniform(0.5, 2.0, v.shape),
            jnp.float32) for k, v in d.items()}
    return walk(stats)


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _port(params, batch_stats, **conf):
    model = get_model("superglue").from_conf({**SG_CONF, **conf}, device="cpu")
    model.load_state_dict(from_jax_params(params, "superglue", HEADS, batch_stats))
    return model


def _grad_state_dict(model) -> dict:
    """The parameters' gradients in the state dict's (official) layout: the
    attention weights are held head-major inside the module."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(clone.parameters(), model.parameters()):
            assert q.grad is not None
            p.copy_(q.grad)
    names = {n for n, _ in model.named_parameters()}
    return {k: v for k, v in clone.state_dict().items() if k in names}


def _assert_grads(model, ref_sd: dict, tol=RTOL):
    """Every parameter gradient against the converted JAX gradients, within
    `tol` of their global norm."""
    got = _grad_state_dict(model)
    norm = float(np.sqrt(sum(float((v.double() ** 2).sum()) for k, v in ref_sd.items() if k in got)))
    assert norm > 0
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref_sd[n].numpy(), atol=tol * norm, rtol=0, err_msg=n)


@pytest.fixture(scope="module")
def jax_ref():
    rng = np.random.default_rng(11)
    data = _data(rng)
    dj = _as_jax(data)
    sg = jax_get_model("superglue").from_conf(SG_CONF)
    variables = jax.jit(sg.init)({"params": jax.random.key(3)}, dj)
    stats = _randomize_batch_stats(rng, variables["batch_stats"])
    params = variables["params"]

    def loss_fn(p):
        (pred, losses, _), updates = sg.apply({"params": p, "batch_stats": stats}, dj, train=True,
                                              method="forward_with_loss", mutable=["batch_stats"])
        return losses["total"].mean(), (pred, losses, updates["batch_stats"])

    (_, (pred, losses, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    (_, eval_losses, eval_metrics), _ = jax.jit(lambda v, d: sg.apply(
        v, d, train=False, method="forward_with_loss", mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, dj)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"data": data, "params": to_np(params), "stats": to_np(stats), "pred": to_np(pred),
            "losses": to_np(losses), "new_stats": to_np(new_stats), "grads": to_np(grads),
            "eval_losses": to_np(eval_losses), "eval_metrics": to_np(eval_metrics)}


def _train_forward(ref, **conf):
    model = _port(ref["params"], ref["stats"], **conf)
    pred, losses, metrics = model.forward_with_loss(_as_torch(ref["data"]), train=True)
    losses["total"].mean().backward()
    return model, pred, losses, metrics


def test_train_forward_loss_and_gradients_match_jax(jax_ref):
    model, pred, losses, metrics = _train_forward(jax_ref)
    assert metrics == {}
    assert set(losses) == set(jax_ref["losses"])
    for k, v in jax_ref["losses"].items():
        np.testing.assert_allclose(losses[k].detach().numpy(), v, rtol=RTOL, atol=1e-6, err_msg=k)
    la, want = pred["log_assignment"].detach().numpy(), jax_ref["pred"]["log_assignment"]
    small = np.abs(want) < 1e6  # masked entries sit near -1e9
    np.testing.assert_allclose(la[small], want[small], atol=RTOL * np.abs(want[small]).max())
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(pred[k].numpy(), jax_ref["pred"][k])
    _assert_grads(model, from_jax_params(jax_ref["grads"], "superglue", HEADS, jax_ref["stats"]))
    assert float(jax_ref["losses"]["nll_pos"].min()) > 0 and jax_ref["data"]["gt_assignment"].sum() > 20


def test_running_stats_after_a_train_forward_match_jax(jax_ref):
    model, _, _, _ = _train_forward(jax_ref)
    want = _stats(from_jax_params(jax_ref["params"], "superglue", HEADS, jax_ref["new_stats"]))
    before = _stats(from_jax_params(jax_ref["params"], "superglue", HEADS, jax_ref["stats"]))
    got = _stats(model.state_dict())
    assert set(got) == set(want) and len(got) == 2 * (2 + 2 * SG_CONF["n_layers"])
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)
        assert not np.allclose(v.numpy(), before[k].numpy()), k  # the update moved every statistic


def test_eval_forward_uses_running_stats_and_reports_metrics(jax_ref):
    model = _port(jax_ref["params"], jax_ref["stats"])
    before = {k: v.clone() for k, v in _stats(model.state_dict()).items()}
    with torch.no_grad():
        _, losses, metrics = model.forward_with_loss(_as_torch(jax_ref["data"]), train=False)
    for k, v in _stats(model.state_dict()).items():
        assert torch.equal(v, before[k]), k
    for k, v in jax_ref["eval_losses"].items():
        np.testing.assert_allclose(losses[k].numpy(), v, rtol=RTOL, atol=1e-6, err_msg=k)
    assert set(metrics) == set(jax_ref["eval_metrics"])
    for k, v in jax_ref["eval_metrics"].items():
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=RTOL, atol=1e-6, err_msg=k)


def test_checkpointed_equals_plain_and_updates_stats_once(jax_ref):
    plain, pred_p, losses_p, _ = _train_forward(jax_ref)
    ckpt, pred_c, losses_c, _ = _train_forward(jax_ref, checkpointed=True)
    torch.testing.assert_close(losses_c["total"], losses_p["total"], rtol=1e-6, atol=0)
    torch.testing.assert_close(pred_c["log_assignment"], pred_p["log_assignment"], rtol=1e-6, atol=1e-3)
    for (n, a), (_, b) in zip(ckpt.named_parameters(), plain.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7, msg=n)
    for k, v in _stats(plain.state_dict()).items():
        torch.testing.assert_close(_stats(ckpt.state_dict())[k], v, rtol=0, atol=0, msg=k)


def test_checkpointed_layers_recompute_in_the_backward(jax_ref, monkeypatch):
    """The checkpointed model runs each GNN layer's attention again in the
    backward (twice the plain model's calls, as the kernel's launches double
    on the card) and its statistics still equal JAX's single update."""
    import gluefactory_tpu_torch.models.matchers.superglue as sg_module

    calls = []
    mha = sg_module.mha
    monkeypatch.setattr(sg_module, "mha", lambda *a, **k: calls.append(1) or mha(*a, **k))
    counts = {}
    for checkpointed in (False, True):
        calls.clear()
        model = _port(jax_ref["params"], jax_ref["stats"], checkpointed=checkpointed)
        _, losses, _ = model.forward_with_loss(_as_torch(jax_ref["data"]), train=True)
        losses["total"].mean().backward()
        counts[checkpointed] = len(calls)
    assert counts[True] == 2 * counts[False] == 2 * 4 * SG_CONF["n_layers"]
    want = _stats(from_jax_params(jax_ref["params"], "superglue", HEADS, jax_ref["new_stats"]))
    for k, v in _stats(model.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)


# --------------------------------------------------------------------------
# the trainer: Adam steps, the NaN-skip, checkpoints
# --------------------------------------------------------------------------

PIPE_CONF = {"matcher": {"name": "superglue", **SG_CONF}}


def _pipeline_batch(data: dict) -> dict:
    """The matcher's inputs as a pipeline without an extractor reads them:
    each view's features under `cache`."""
    batch = {k: v for k, v in data.items() if k.startswith("gt_")}
    for i in "01":
        feats = ("keypoints", "descriptors", "keypoint_scores", "keypoint_mask")
        batch[f"view{i}"] = {**data[f"view{i}"], "cache": {k: data[f"{k}{i}"] for k in feats}}
    return batch


def _pipelines(checkpointed: bool):
    conf = {"matcher": {**PIPE_CONF["matcher"], "checkpointed": checkpointed}}
    return (jax_get_model("two_view_pipeline").from_conf(conf),
            get_model("two_view_pipeline").from_conf(conf, device="cpu"))


@pytest.fixture(scope="module")
def jax_steps():
    """Three Adam steps of JAX's `make_train_step` on three batches, then a
    step at an lr of inf (rejected by the NaN-skip)."""
    rng = np.random.default_rng(12)
    batches = [_pipeline_batch(_data(rng)) for _ in range(4)]
    model, _ = _pipelines(False)
    variables = jax.jit(model.init, static_argnames="method")(
        {"params": jax.random.key(4)}, _as_jax(batches[0]), method="initialize")
    variables = {"params": variables["params"],
                 "batch_stats": _randomize_batch_stats(rng, variables["batch_stats"])}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {"batches": batches, "init": to_np(variables), "losses": []}
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    opt_state = tx.init(variables["params"])
    step = jax.jit(jax_train.make_train_step(model, tx))
    key = jax.random.key(0)
    for b in batches[:3]:
        variables, opt_state, losses, _, info = step(variables, opt_state, _as_jax(b), key)
        assert bool(info["ok"])
        out["losses"].append(float(losses["total"]))
    out["after"] = to_np(variables)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(np.inf, jnp.float32)
    rejected, _, _, _, info = step(variables, opt_state, _as_jax(batches[3]), key)
    assert not bool(info["ok"])
    out["rejected"] = to_np(rejected)
    return out


def _sd(variables) -> dict:
    return from_jax_params(variables["params"], "two_view_pipeline", HEADS, variables["batch_stats"])


def _train_step(model, lr=LR, max_updates=8):
    opt = OPTIMIZERS["adam"]([p for p in model.parameters() if p.requires_grad], lr=lr)
    return torch_train.TrainStep(model, opt, lambda i: lr, max_updates=max_updates)


@pytest.mark.parametrize("checkpointed", [False, True])
def test_adam_steps_match_jax_make_train_step(jax_steps, checkpointed):
    _, model = _pipelines(checkpointed)
    model.load_state_dict(_sd(jax_steps["init"]))
    step = _train_step(model)
    for b, want in zip(jax_steps["batches"][:3], jax_steps["losses"]):
        losses, _, info = step(_as_torch(b))
        assert bool(info["ok"])
        np.testing.assert_allclose(float(losses["total"]), want, rtol=RTOL)
    want = _sd(jax_steps["after"])
    got = model.state_dict()
    for k, v in want.items():
        # Adam moves each parameter by about lr a step and a near-zero
        # gradient may take either sign; the running statistics are taken
        # from activations of those parameters
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=3 * LR * 3, rtol=0, err_msg=k)


def test_nan_skip_keeps_the_running_stats_update(jax_steps):
    """A step whose update makes the parameters non-finite is rejected: the
    parameters and the optimizer state stay bit-equal, while the running
    statistics keep the forward's update, as JAX's `make_train_step` keeps
    `batch_stats` (its `updates` are not gated by `ok`)."""
    _, model = _pipelines(False)
    model.load_state_dict(_sd(jax_steps["after"]))
    step = _train_step(model, lr=float("inf"))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, _, info = step(_as_torch(jax_steps["batches"][3]))
    assert not bool(info["ok"]) and step.updates == 0
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n
    assert all(int(s["step"]) == 0 for s in step.optimizer.state.values())
    want = _stats(_sd(jax_steps["rejected"]))
    before = _stats(_sd(jax_steps["after"]))
    for k, v in _stats(model.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)
        assert not np.allclose(v.numpy(), before[k].numpy()), k


def test_trainer_checkpoint_and_restore_carry_running_stats(jax_steps, tmp_path):
    """The trainer's checkpoint payload holds the running statistics, a
    restored model gets them bit-equal, and validation (train=False)
    normalises by them and leaves them alone."""
    from gluefactory_tpu_torch.utils.experiments import load_checkpoint, save_checkpoint

    _, model = _pipelines(True)
    model.load_state_dict(_sd(jax_steps["init"]))
    step = _train_step(model)
    step(_as_torch(jax_steps["batches"][0]))
    state = {"model": model.state_dict(), "optimizer": step.optimizer.state_dict(),
             "step": step.state_dict()}
    conf = torch_train.Config({**torch_train.default_conf, "model": {"name": "two_view_pipeline",
                                                                     **PIPE_CONF}})
    path = save_checkpoint(state, conf, {}, tmp_path, 0, 1)
    _, restored = _pipelines(True)
    restored.load_state_dict(load_checkpoint(path, map_location="cpu")["model"])
    trained = _stats(model.state_dict())
    assert trained and all(torch.equal(v, _stats(restored.state_dict())[k]) for k, v in trained.items())
    with torch.no_grad():
        pred, _, _ = restored.forward_with_loss(_as_torch(jax_steps["batches"][1]), train=False)
    assert all(torch.equal(v, _stats(restored.state_dict())[k]) for k, v in trained.items())
    _, plain = _pipelines(False)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = plain(_as_torch(jax_steps["batches"][1]), train=False)
    torch.testing.assert_close(pred["log_assignment"], want["log_assignment"])


@pytest.mark.parametrize("name", ["superpoint+superglue-official", "superpoint+NN"])
def test_official_configs_match_jax(name):
    """The port's copies of the two configs, resolved by name, hold the JAX
    package's: the same YAML data, and each component's conf merged with
    its model's defaults equal to the JAX model's merged conf, SuperPoint's
    int8 serving options `quantize` and `s2d_block1` included."""
    from pathlib import Path

    from gluefactory_tpu.core.config import from_yaml as jax_from_yaml
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.eval.io import parse_config_path

    path = parse_config_path(name)
    assert path.parent.name == "configs" and path.parent.parent.name == "gluefactory_tpu_torch"
    jax_conf = jax_from_yaml(str(Path(jax_train.__file__).parent / "configs" / f"{name}.yaml")).to_dict()
    conf = from_yaml(str(path)).to_dict()
    assert conf == jax_conf
    for comp in ("extractor", "matcher"):
        sub = {k: v for k, v in conf["model"][comp].items() if k != "name"}
        want = jax_get_model(conf["model"][comp]["name"]).from_conf(sub).conf.to_dict()
        got = get_model(conf["model"][comp]["name"]).resolve_conf(sub).to_dict()
        assert set(want) == set(got)
        assert {"quantize", "s2d_block1"} <= set(got) or comp != "extractor"
        assert got == want, comp
