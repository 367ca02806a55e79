"""The port's GlueStick training against the JAX package's on the same
seeded inputs and weights (GlueStick at d = 64, 2 layer pairs, 2 heads,
inter-layer line supervision at layers [0, 1]; scattered keypoint and line
masks; non-trivial BatchNorm statistics), with the plain line messages and
with `line_attention`.

- The train-mode forward (BatchNorm by the batch), the point, line and
  inter-layer line losses and every gradient against `apply(...,
  train=True, mutable=["batch_stats"])` and `jax.value_and_grad`, and the
  running statistics after the forward against flax's updated
  `batch_stats` (0.9 old + 0.1 batch, the biased variance, each
  BatchNorm updated once a call of its MLP).
- `checkpointed` against the plain forward: the same outputs, gradients
  and running statistics, the attention layers run again in the backward
  and the statistics updated once.
- Three Adam steps of the port's `TrainStep` on a pipeline holding the
  matcher against JAX's `make_train_step`, with and without
  `checkpointed`.
- The two GlueStick training configs resolved by name and equal to JAX's;
  `train.main` on the stage-1 config by name (the wireframes from 2 loader
  workers), and the warm start of a run without inter-layer supervision.

Tolerances: losses within 1e-5 relative; the log assignments within 1e-5
of their largest finite magnitude; gradients within 1e-4 of their global
norm; statistics within 1e-5.
"""

import copy
from pathlib import Path

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
GS_CONF = {"descriptor_dim": 64, "input_dim": 64, "keypoint_encoder": [8, 16], "n_layers": 2,
           "num_heads": HEADS, "filter_threshold": 0.01, "inter_supervision": [0, 1],
           "checkpointed": False}
CASES = {"plain": {}, "line_attention": {"line_attention": True}}
LR = 1e-3
RTOL = 1e-5
GRAD_TOL = 1e-4
STATS_TOL = 1e-5


def _gt(rng, pairs, m0, m1):
    """GT matches (-1 unmatched, -2 a masked slot) and the assignment from
    candidate pairs (i, j), each kept with probability 0.8 where both slots
    are valid."""
    B, M = m0.shape
    N = m1.shape[1]
    gt0 = np.full((B, M), -1, np.int32)
    gt1 = np.full((B, N), -1, np.int32)
    for i, j in pairs:
        keep = m0[:, i] & m1[:, j] & (gt0[:, i] < 0) & (gt1[:, j] < 0) & (rng.uniform(size=B) > 0.2)
        gt0[keep, i] = j
        gt1[keep, j] = i
    gt0[~m0], gt1[~m1] = -2, -2
    ass = np.zeros((B, M, N), bool)
    b, i = np.nonzero(gt0 >= 0)
    ass[b, i, gt0[b, i]] = True
    return gt0, gt1, ass


def _data(rng, B=2, L=10, K=30, D=64):
    """Two views of a wireframe: the node list is 2L junction slots, then K
    keypoints; view 1 a permuted, jittered copy of view 0 so that random
    weights match. Lines join junction slots (some junctions shared); the
    keypoint, junction and line masks are scattered; the point GT follows
    the permutation, the line GT pairs line l with line perm_l[l]."""
    N = 2 * L + K
    k0 = rng.uniform(0, 128, (B, N, 2))
    d0 = rng.normal(size=(B, N, D))
    perm = rng.permutation(N)
    k1 = k0[:, perm] + rng.normal(scale=0.3, size=(B, N, 2))
    d1 = d0[:, perm] + rng.normal(scale=0.05, size=(B, N, D))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    jidx0 = rng.integers(0, 2 * L - 4, (B, L, 2))
    jidx1 = rng.integers(0, 2 * L - 4, (B, L, 2))
    lines0 = np.take_along_axis(k0, jidx0.reshape(B, 2 * L, 1), 1).reshape(B, L, 2, 2)
    lines1 = np.take_along_axis(k1, jidx1.reshape(B, 2 * L, 1), 1).reshape(B, L, 2, 2)
    m0, m1 = rng.uniform(size=(B, N)) > 0.2, rng.uniform(size=(B, N)) > 0.2
    lm0, lm1 = rng.uniform(size=(B, L)) > 0.2, rng.uniform(size=(B, L)) > 0.2
    inv = np.argsort(perm)  # node i of view 0 is node inv[i] of view 1
    gt0, gt1, ass = _gt(rng, [(i, inv[i]) for i in range(N)], m0, m1)
    lperm = rng.permutation(L)
    lgt0, lgt1, lass = _gt(rng, [(l, lperm[l]) for l in range(L)], lm0, lm1)
    f = np.float32
    return {
        "keypoints0": k0.astype(f), "keypoints1": k1.astype(f),
        "descriptors0": d0.astype(f), "descriptors1": d1.astype(f),
        "keypoint_scores0": rng.uniform(0, 1, (B, N)).astype(f),
        "keypoint_scores1": rng.uniform(0, 1, (B, N)).astype(f),
        "keypoint_mask0": m0, "keypoint_mask1": m1,
        "lines0": lines0.astype(f), "lines1": lines1.astype(f),
        "line_scores0": rng.uniform(0, 1, (B, L)).astype(f),
        "line_scores1": rng.uniform(0, 1, (B, L)).astype(f),
        "line_mask0": lm0, "line_mask1": lm1,
        "lines_junc_idx0": jidx0.astype(np.int32), "lines_junc_idx1": jidx1.astype(np.int32),
        "view0": {"image_size": np.asarray([[128.0, 96.0]] * B, f)},
        "view1": {"image_size": np.asarray([[128.0, 96.0]] * B, f)},
        "gt_matches0": gt0, "gt_matches1": gt1, "gt_assignment": ass,
        "gt_line_matches0": lgt0, "gt_line_matches1": lgt1, "gt_line_assignment": lass,
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


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _port(params, batch_stats, **conf):
    model = get_model("gluestick").from_conf({**GS_CONF, **conf}, device="cpu")
    model.load_state_dict(from_jax_params(params, "gluestick", HEADS, batch_stats), strict=True)
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


def _assert_grads(model, ref_sd: dict, tol=GRAD_TOL):
    """Every parameter gradient against the converted JAX gradients, within
    `tol` of their global norm."""
    got = _grad_state_dict(model)
    assert set(got) <= set(ref_sd)
    norm = float(np.sqrt(sum(float((v.double() ** 2).sum()) for k, v in ref_sd.items() if k in got)))
    assert norm > 0
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref_sd[n].numpy(), atol=tol * norm, rtol=0, err_msg=n)


def _close_log_assignment(got, want):
    """Equal -inf / masked slots; finite entries within RTOL of the largest
    finite magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert (np.isfinite(got) == np.isfinite(want)).all()
    fin = np.isfinite(want) & (np.abs(want) < 1e6)
    np.testing.assert_allclose(got[fin], want[fin], atol=RTOL * np.abs(want[fin]).max(), rtol=0)


_INITS: dict = {}


def _jax_init(conf: dict, data, seed: int):
    """(JAX GlueStick, its variables from `seed`), the jitted init compiled
    once a conf for the module's data shapes."""
    key = repr(sorted(conf.items()))
    if key not in _INITS:
        gs = jax_get_model("gluestick").from_conf(conf)
        _INITS[key] = (gs, jax.jit(gs.init))
    gs, init = _INITS[key]
    return gs, init({"params": jax.random.key(seed)}, data)


@pytest.fixture(scope="module", params=list(CASES))
def jax_ref(request):
    conf = {**GS_CONF, **CASES[request.param]}
    rng = np.random.default_rng(21)
    data = _data(rng)
    dj = _as_jax(data)
    gs, variables = _jax_init(conf, dj, seed=5)
    stats = _randomize_batch_stats(rng, variables["batch_stats"])
    params = variables["params"]

    def loss_fn(p):
        (pred, losses, _), updates = gs.apply({"params": p, "batch_stats": stats}, dj, train=True,
                                              method="forward_with_loss", mutable=["batch_stats"])
        return losses["total"].mean(), (pred, losses, updates["batch_stats"])

    (_, (pred, losses, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    (_, eval_losses, eval_metrics), _ = jax.jit(lambda v, d: gs.apply(
        v, d, train=False, method="forward_with_loss", mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, dj)
    return {"case": request.param, "conf": CASES[request.param], "data": data,
            "params": _to_np(params), "stats": _to_np(stats), "pred": _to_np(pred),
            "losses": _to_np(losses), "new_stats": _to_np(new_stats), "grads": _to_np(grads),
            "eval_losses": _to_np(eval_losses), "eval_metrics": _to_np(eval_metrics)}


def _train_forward(ref, **conf):
    model = _port(ref["params"], ref["stats"], **{**ref["conf"], **conf})
    pred, losses, metrics = model.forward_with_loss(_as_torch(ref["data"]), train=True)
    losses["total"].mean().backward()
    return model, pred, losses, metrics


def test_train_forward_loss_and_gradients_match_jax(jax_ref):
    """The point, line and inter-layer line NLLs (weights 0.3 and 0.6 at
    layers 0 and 1), every log assignment, and every parameter's gradient,
    `inter_line_proj` and (with `line_attention`) `proj_node` /
    `proj_neigh` included."""
    model, pred, losses, metrics = _train_forward(jax_ref)
    assert metrics == {}
    assert set(losses) == set(jax_ref["losses"])
    assert {"line_0_assignment_nll", "line_1_assignment_nll"} <= set(losses)
    for k, v in jax_ref["losses"].items():
        np.testing.assert_allclose(losses[k].detach().numpy(), v, rtol=RTOL, atol=1e-6, err_msg=k)
    for k in ("log_assignment", "line_log_assignment", "line_0_log_assignment",
              "line_1_log_assignment"):
        _close_log_assignment(pred[k].detach().numpy(), jax_ref["pred"][k])
    ref_grads = from_jax_params(jax_ref["grads"], "gluestick", HEADS, jax_ref["stats"])
    _assert_grads(model, ref_grads)
    names = {n for n, _ in model.named_parameters()}
    assert {"inter_line_proj.0.weight", "inter_line_proj.1.weight"} <= names
    if jax_ref["conf"].get("line_attention"):
        assert "gnn.line_layers.0.proj_node.weight" in names
        assert float(model.gnn.line_layers[0].proj_neigh.weight.grad.abs().max()) > 0
    # every term carries signal: positives on both sides of the assignment
    assert jax_ref["data"]["gt_assignment"].sum() > 20 and jax_ref["data"]["gt_line_assignment"].sum() > 5
    assert all(float(np.min(jax_ref["losses"][k])) > 0 for k in
               ("assignment_nll", "line_assignment_nll", "line_0_assignment_nll"))


def test_running_stats_after_a_train_forward_match_jax(jax_ref):
    """Every BatchNorm of both encoders, the attention layers' MLPs and the
    line layers' MLPs: the running statistics after one train forward
    against flax's updated `batch_stats`, each moved by the update."""
    model, _, _, _ = _train_forward(jax_ref)
    want = _stats(from_jax_params(jax_ref["params"], "gluestick", HEADS, jax_ref["new_stats"]))
    before = _stats(from_jax_params(jax_ref["params"], "gluestick", HEADS, jax_ref["stats"]))
    got = _stats(model.state_dict())
    n = GS_CONF["n_layers"]
    # kenc and lenc: 2 each; each of the 2n attention layers: 1; each line layer: 1
    assert set(got) == set(want) and len(got) == 2 * (2 + 2 + 2 * n + n)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)
        assert not np.allclose(v.numpy(), before[k].numpy()), k


def test_eval_forward_uses_running_stats_and_reports_metrics(jax_ref):
    """train=False: BatchNorm by the running statistics, left alone; the
    losses and the point, line and inter-layer line metrics as JAX's."""
    model = _port(jax_ref["params"], jax_ref["stats"], **jax_ref["conf"])
    before = {k: v.clone() for k, v in _stats(model.state_dict()).items()}
    with torch.no_grad():
        _, losses, metrics = model.forward_with_loss(_as_torch(jax_ref["data"]), train=False)
    for k, v in _stats(model.state_dict()).items():
        assert torch.equal(v, before[k]), k
    for k, v in jax_ref["eval_losses"].items():
        np.testing.assert_allclose(losses[k].numpy(), v, rtol=RTOL, atol=1e-6, err_msg=k)
    assert set(metrics) == set(jax_ref["eval_metrics"])
    assert any(k.startswith("line_1_") for k in metrics)
    for k, v in jax_ref["eval_metrics"].items():
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=RTOL, atol=1e-6, err_msg=k)


def test_checkpointed_equals_plain_and_updates_stats_once(jax_ref):
    plain, pred_p, losses_p, _ = _train_forward(jax_ref)
    ckpt, pred_c, losses_c, _ = _train_forward(jax_ref, checkpointed=True)
    torch.testing.assert_close(losses_c["total"], losses_p["total"], rtol=1e-6, atol=0)
    for k in ("log_assignment", "line_log_assignment", "line_0_log_assignment"):
        torch.testing.assert_close(pred_c[k], pred_p[k], rtol=1e-6, atol=1e-5, msg=k)
    for (n, a), (_, b) in zip(ckpt.named_parameters(), plain.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7, msg=n)
    for k, v in _stats(plain.state_dict()).items():
        torch.testing.assert_close(_stats(ckpt.state_dict())[k], v, rtol=0, atol=0, msg=k)


def test_checkpointed_layers_recompute_in_the_backward(jax_ref, monkeypatch):
    """The checkpointed model runs each attention layer again in the
    backward (twice the plain model's attention calls, as the kernel's
    launches double on the card), not the line layers, and its statistics
    still equal JAX's single update."""
    import gluefactory_tpu_torch.models.matchers.gluestick as gs_module
    import gluefactory_tpu_torch.models.matchers.superglue as sg_module

    calls, line_calls = [], []
    mha = sg_module.mha
    monkeypatch.setattr(sg_module, "mha", lambda *a, **k: calls.append(1) or mha(*a, **k))
    line_forward = gs_module.LineLayer.forward
    monkeypatch.setattr(gs_module.LineLayer, "forward",
                        lambda self, *a, **k: line_calls.append(1) or line_forward(self, *a, **k))
    counts = {}
    for checkpointed in (False, True):
        calls.clear()
        line_calls.clear()
        model = _port(jax_ref["params"], jax_ref["stats"], **jax_ref["conf"], checkpointed=checkpointed)
        _, losses, _ = model.forward_with_loss(_as_torch(jax_ref["data"]), train=True)
        losses["total"].mean().backward()
        counts[checkpointed] = (len(calls), len(line_calls))
    n = GS_CONF["n_layers"]
    assert counts[True][0] == 2 * counts[False][0] == 2 * 4 * n
    assert counts[True][1] == counts[False][1] == 2 * n
    want = _stats(from_jax_params(jax_ref["params"], "gluestick", HEADS, jax_ref["new_stats"]))
    for k, v in _stats(model.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)


# --------------------------------------------------------------------------
# the trainer: Adam steps against make_train_step
# --------------------------------------------------------------------------

VIEW_KEYS = ("keypoints", "descriptors", "keypoint_scores", "keypoint_mask", "lines", "line_scores",
             "line_mask", "lines_junc_idx")


def _pipeline_batch(data: dict) -> dict:
    """The matcher's inputs as a pipeline without an extractor reads them:
    each view's features and wireframe under `cache`."""
    batch = {k: v for k, v in data.items() if k.startswith("gt_")}
    for i in "01":
        batch[f"view{i}"] = {**data[f"view{i}"], "cache": {k: data[f"{k}{i}"] for k in VIEW_KEYS}}
    return batch


def _pipelines(checkpointed: bool):
    conf = {"matcher": {"name": "gluestick", **GS_CONF, "checkpointed": checkpointed}}
    return (jax_get_model("two_view_pipeline").from_conf(conf),
            get_model("two_view_pipeline").from_conf(conf, device="cpu"))


@pytest.fixture(scope="module")
def jax_steps():
    """Three Adam steps of JAX's `make_train_step` on three batches."""
    rng = np.random.default_rng(22)
    batches = [_pipeline_batch(_data(rng)) for _ in range(3)]
    model, _ = _pipelines(False)
    # the pipeline's variables are its matcher's, under `matcher_model`
    _, variables = _jax_init(GS_CONF, _as_jax(_data(np.random.default_rng(21))), seed=6)
    variables = {"params": {"matcher_model": variables["params"]},
                 "batch_stats": {"matcher_model": _randomize_batch_stats(rng, variables["batch_stats"])}}
    out = {"batches": batches, "init": _to_np(variables), "losses": []}
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    opt_state = tx.init(variables["params"])
    step = jax.jit(jax_train.make_train_step(model, tx))
    for b in batches:
        variables, opt_state, losses, _, info = step(variables, opt_state, _as_jax(b), jax.random.key(0))
        assert bool(info["ok"])
        out["losses"].append(float(losses["total"]))
    out["after"] = _to_np(variables)
    return out


def _sd(variables) -> dict:
    return from_jax_params(variables["params"], "two_view_pipeline", HEADS, variables["batch_stats"])


@pytest.mark.parametrize("checkpointed", [False, True])
def test_adam_steps_match_jax_make_train_step(jax_steps, checkpointed):
    _, model = _pipelines(checkpointed)
    model.load_state_dict(_sd(jax_steps["init"]))
    opt = OPTIMIZERS["adam"]([p for p in model.parameters() if p.requires_grad], lr=LR)
    step = torch_train.TrainStep(model, opt, lambda i: LR, max_updates=8)
    for b, want in zip(jax_steps["batches"], jax_steps["losses"]):
        losses, _, info = step(_as_torch(b))
        assert bool(info["ok"])
        np.testing.assert_allclose(float(losses["total"]), want, rtol=RTOL)
    want = _sd(jax_steps["after"])
    got = model.state_dict()
    assert set(_stats(got)) == set(_stats(want))
    for k, v in want.items():
        # Adam moves each parameter by about lr a step and a near-zero
        # gradient may take either sign; the running statistics are taken
        # from activations of those parameters
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=3 * LR * 3, rtol=0, err_msg=k)


# --------------------------------------------------------------------------
# the configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["superpoint+lsd+gluestick-homography",
                                  "superpoint+lsd+gluestick-megadepth"])
def test_gluestick_training_configs_match_jax(name):
    """The port's copies of the two GlueStick training configs, resolved by
    name (as `train.main --conf <name>` resolves them), hold the JAX
    package's YAML data key for key; the matcher's and the wireframe's
    confs merged with their defaults equal the JAX models' merged confs;
    the datasets' `detect_lines` equal the JAX datasets'."""
    from gluefactory_tpu.core.config import from_yaml as jax_from_yaml
    from gluefactory_tpu.data import get_dataset as jax_get_dataset
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.eval.io import parse_config_path

    path = parse_config_path(name)
    assert path.parent.name == "configs" and path.parent.parent.name == "gluefactory_tpu_torch"
    jax_conf = jax_from_yaml(str(Path(jax_train.__file__).parent / "configs" / f"{name}.yaml")).to_dict()
    conf = from_yaml(str(path)).to_dict()
    assert conf == jax_conf
    assert conf["train"]["lr_schedule"]["unit"] == "iter"
    assert conf["data"]["detect_lines"]["do"] is True
    for comp in ("extractor", "matcher"):
        sub = {k: v for k, v in conf["model"][comp].items() if k != "name"}
        want = jax_get_model(conf["model"][comp]["name"]).from_conf(sub).conf.to_dict()
        got = get_model(conf["model"][comp]["name"]).resolve_conf(sub).to_dict()
        if comp == "extractor":  # the point extractor merged with SuperPoint's
            # defaults: the int8 serving options are the port's keys too
            pe = {k: v for k, v in got["point_extractor"].items() if k != "name"}
            pe_got = get_model("superpoint").resolve_conf(pe).to_dict()
            assert pe_got == jax_get_model("superpoint").from_conf(pe).conf.to_dict()
            assert {"quantize", "s2d_block1"} <= set(pe_got)
        assert got == want, comp
    data_name = conf["data"]["name"]
    jax_default = jax_get_dataset(data_name).default_conf["detect_lines"]
    assert get_dataset(data_name).default_conf["detect_lines"] == jax_default


# --------------------------------------------------------------------------
# the train CLI: both stages by config name, the warm start
# --------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--no_tensorboard", "--no_capture", "--max_val_iters", "1",
         "data.synthetic_images=6", "data.train_size=4", "data.val_size=2", "data.batch_size=2",
         "data.num_workers=2", "data.source_size=[160,120]", "data.homography.patch_shape=[160,120]",
         "data.photometric.name=identity", "data.detect_lines.max_num_lines=12",
         "data.detect_lines.min_length=10", "model.extractor.point_extractor.max_num_keypoints=32",
         "model.extractor.max_num_lines=12", "model.extractor.min_length=10",
         "model.matcher.n_layers=6", "model.matcher.descriptor_dim=32", "model.matcher.num_heads=2",
         "train.log_every_iter=1", "train.eval_every_iter=100"]

# run in a process of its own that imports no JAX (the loader's workers are
# forked, as in training); prints the records as JSON
TWO_STAGES = """
import json, sys
import numpy as np, torch
from gluefactory_tpu_torch import train
from gluefactory_tpu_torch.models.lines import lsd
from gluefactory_tpu_torch.utils import experiments

small, out = json.loads(sys.argv[1]), {}
records = []
call = train.TrainStep.__call__
train.TrainStep.__call__ = lambda self, *a, **k: records.append(call(self, *a, **k)) or records[-1]
conf = ["--conf", "superpoint+lsd+gluestick-homography", *small]
train.main(["gs1", *conf, "train.epochs=1"])
out["main_process_detections"] = lsd.detections
out["steps"] = [({k: float(v) for k, v in l.items()}, bool(i["ok"])) for l, _, i in records]
best = experiments.load_checkpoint(experiments.get_best_checkpoint("gs1"))["model"]
warm = train.main(["gs2", *conf, "train.epochs=0", "train.load_experiment=gs1",
                   "model.matcher.inter_supervision=null"]).state_dict()
out["skipped"] = sorted(set(best) - set(warm))
out["statistics"] = sum(k.endswith("running_var") for k in warm)
out["unequal"] = [k for k, v in warm.items() if not torch.equal(v, best[k])]
try:
    train.main(["gs3", *conf, "train.epochs=0", "train.load_experiment=gs1",
                "model.matcher.inter_supervision=[1,2,5]"])
except KeyError as e:
    out["missing_raises"] = str(e)
print("RESULT " + json.dumps(out))
"""


def test_two_stages_by_name_with_the_warm_start(tmp_path):
    """`train.main` on `superpoint+lsd+gluestick-homography` by name: two
    steps on wireframes from 2 loader workers (no LSD in the main process),
    finite point, line and inter-layer line losses, a checkpoint. Then a
    run without inter-layer supervision warm-started from it: every tensor
    equal to the checkpoint's, the running statistics included, and only
    `inter_line_proj` skipped; a model with a tensor the checkpoint lacks
    raises."""
    import json
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "GLUEFACTORY_TRAINING": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", TWO_STAGES, json.dumps(SMALL)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.split("RESULT ", 1)[1])
    assert out["main_process_detections"] == 0 and len(out["steps"]) == 2
    for losses, ok in out["steps"]:
        assert ok
        assert {"total", "matcher_assignment_nll", "matcher_line_assignment_nll",
                "matcher_line_2_assignment_nll", "matcher_line_5_assignment_nll"} <= set(losses)
        assert all(np.isfinite(v) for v in losses.values())
    assert out["skipped"] == [f"matcher.inter_line_proj.{j}.{p}" for j in (0, 1) for p in ("bias", "weight")]
    assert out["statistics"] > 0 and out["unequal"] == []
    assert "inter_line_proj.2" in out["missing_raises"]
