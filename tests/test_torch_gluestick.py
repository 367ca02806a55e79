"""The port's GlueStick against the JAX package's on the same seeded inputs
and weights: `log_double_softmax`, the weight conversions (JAX params and
upstream's state dict), the forward in both line-message modes with padded
and scattered masks, inter-layer supervision and an input projection, and the
loss and eval metrics' values. Each (conf, masks, seed) is built and
applied once per file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_gluestick
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.ops import assignment as jax_assignment
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops import assignment


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file's tests and fixtures: the suite runs 6
    workers on the host's cores, and torch's default pool oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4

BASE = {"descriptor_dim": 64, "input_dim": 64, "keypoint_encoder": [8, 16], "n_layers": 2,
        "num_heads": 2, "filter_threshold": 0.01}


def _close_where_finite(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert (np.isfinite(got) == np.isfinite(want)).all()
    fin = np.isfinite(want)
    small = fin & (np.abs(want) < 1e6)
    np.testing.assert_allclose(got[small], want[small], atol=atol, rtol=0)
    np.testing.assert_allclose(got[fin & ~small], want[fin & ~small], rtol=1e-6)


def _randomize_batch_stats(rng, stats):
    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = jnp.asarray(rng.normal(0, 0.5, v.shape), jnp.float32)
            else:
                out[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32)
        return out
    return walk(stats)


def _data(rng, masks: str, D=64, B=2, L=10, K=30):
    """Two views of a wireframe: node list = 2L junction slots then K
    keypoints; view 1 a permuted, jittered copy so random weights match."""
    N = 2 * L + K
    k0 = rng.uniform(0, 128, (B, N, 2))
    d0 = rng.normal(size=(B, N, D))
    perm = rng.permutation(N)
    k1 = k0[:, perm] + rng.normal(scale=0.3, size=(B, N, 2))
    d1 = d0[:, perm] + rng.normal(scale=0.05, size=(B, N, D))
    # unit descriptors, as SuperPoint gives them
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    # lines between junction slots, some junctions shared by several lines
    jidx0 = rng.integers(0, 2 * L - 4, (B, L, 2))
    jidx1 = rng.integers(0, 2 * L - 4, (B, L, 2))
    lines0 = np.take_along_axis(k0, jidx0.reshape(B, 2 * L, 1), 1).reshape(B, L, 2, 2)
    lines1 = np.take_along_axis(k1, jidx1.reshape(B, 2 * L, 1), 1).reshape(B, L, 2, 2)
    m0, m1 = np.ones((B, N), bool), np.ones((B, N), bool)
    lm0, lm1 = np.ones((B, L), bool), np.ones((B, L), bool)
    if masks == "padded":
        m0[0, -6:] = False
        m1[1, -9:] = False
        lm0[0, -3:] = False
        lm1[1, -2:] = False
    elif masks == "scattered":
        m0 = rng.uniform(size=(B, N)) > 0.25
        m1 = rng.uniform(size=(B, N)) > 0.25
        lm0 = rng.uniform(size=(B, L)) > 0.3
        lm1 = rng.uniform(size=(B, L)) > 0.3
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
        "image_size0": np.asarray([[128.0, 96.0]] * B, f),
        "image_size1": np.asarray([[128.0, 96.0]] * B, f),
    }


_PAIRS: dict = {}


def _pair(conf, masks, seed):
    key = (repr(sorted(conf.items())), masks, seed)
    if key not in _PAIRS:
        _PAIRS[key] = _build_pair(conf, masks, seed)
    return _PAIRS[key]


def _build_pair(conf, masks, seed):
    rng = np.random.default_rng(seed)
    data = _data(rng, masks, D=conf["input_dim"])
    gs_j = jax_get_model("gluestick").from_conf(conf)
    dj = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jax.jit(gs_j.init)({"params": jax.random.key(seed)}, dj)
    stats = _randomize_batch_stats(rng, variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    ref = {k: np.asarray(v) for k, v in jax.jit(gs_j.apply)(variables, dj).items()}
    gs_t = get_model("gluestick").from_conf(conf, device="cpu").eval()
    gs_t.load_state_dict(from_jax_params(variables["params"], "gluestick",
                                         num_heads=conf["num_heads"], batch_stats=stats),
                         strict=True)
    with torch.no_grad():
        out = gs_t({k: torch.from_numpy(v) for k, v in data.items()})
    return ref, out, gs_t, gs_j, variables, data


def test_log_double_softmax_matches_jax():
    rng = np.random.default_rng(0)
    sim = rng.normal(size=(2, 7, 9)).astype(np.float32)
    m0, m1 = rng.uniform(size=(2, 7)) > 0.3, rng.uniform(size=(2, 9)) > 0.3
    for masks in ((None, None), (m0, m1)):
        want = jax_assignment.log_double_softmax(
            jnp.asarray(sim), 0.7, *(None if m is None else jnp.asarray(m) for m in masks))
        got = assignment.log_double_softmax(
            torch.from_numpy(sim), torch.tensor(0.7),
            *(None if m is None else torch.from_numpy(m) for m in masks))
        _close_where_finite(got.numpy(), np.asarray(want), 1e-6)


CASES = {
    "plain-padded": ({}, "padded"),
    "plain-scattered": ({}, "scattered"),
    "attention-padded": ({"line_attention": True}, "padded"),
    "attention-scattered": ({"line_attention": True, "num_line_iterations": 2}, "scattered"),
    "inter-supervision": ({"inter_supervision": [0]}, "scattered"),
    "input-proj": ({"input_dim": 48}, "padded"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gluestick_forward_matches_jax(case):
    extra, masks = CASES[case]
    conf = {**BASE, **extra}
    ref, out, _, _, _, _ = _pair(conf, masks, seed=len(case))
    assert set(out) == set(ref)
    for k in ref:
        if "log_assignment" in k:
            _close_where_finite(out[k].numpy(), ref[k], ATOL)
        elif "matching_scores" in k or k == "raw_line_scores":
            np.testing.assert_allclose(out[k].numpy(), ref[k], atol=ATOL)
    # matches equal wherever the score clears the threshold by 1e-4
    for k in [k for k in ref if k.endswith(("matches0", "matches1"))]:
        sk = k.replace("matches", "matching_scores")
        clear = np.abs(ref[sk] - conf["filter_threshold"]) > 1e-4
        np.testing.assert_array_equal(out[k].numpy()[clear], ref[k][clear])
    assert (ref["matches0"] >= 0).sum() >= 5 and (ref["line_matches0"] >= 0).sum() >= 2
    if "inter_supervision" in extra:
        assert "line_0_log_assignment" in out


def test_gluestick_round_trip_through_jax_params_and_official_names():
    """JAX params -> the port -> upstream's state dict -> the JAX package's
    `convert_gluestick` -> the same JAX params; the port loads the state
    dict strictly (upstream's encoders have five convolutions)."""
    conf = {**BASE, "keypoint_encoder": [8, 8, 16, 16]}
    _, _, gs_t, _, variables, _ = _pair(conf, "padded", seed=3)
    sd = {k: v.numpy() for k, v in gs_t.state_dict().items()}
    assert "gnn.layers.0.update.attn.proj.0.weight" in sd
    assert "gnn.line_layers.1.mlp.3.weight" in sd and "lenc.encoder.0.weight" in sd
    params, stats = convert_gluestick(sd, n_layers=conf["n_layers"], dim=64, num_heads=2)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_allclose(np.asarray(v), np.asarray(flat_b[path]), rtol=0, atol=0)
    again = get_model("gluestick").from_conf(conf, device="cpu")
    again.load_state_dict(from_jax_params(params, "gluestick", num_heads=2, batch_stats=stats),
                          strict=True)
    for k, v in again.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_convert_gluestick_of_a_synthetic_official_checkpoint_loads_strictly():
    """A state dict with upstream's names and shapes, random values (what a
    GlueStick checkpoint holds under 'model' with 'matcher.' prefixes), goes
    through the JAX package's converter and `from_jax_params` and loads
    with strict=True into the port, every tensor where it came from."""
    conf = {**BASE, "keypoint_encoder": [8, 8, 16, 16]}
    model = get_model("gluestick").from_conf(conf, device="cpu")
    rng = np.random.default_rng(4)
    official = {"matcher." + k: (rng.normal(size=tuple(v.shape)).astype(np.float32)
                                 if v.is_floating_point() else v.numpy())
                for k, v in model.state_dict().items()}
    for k in official:
        if k.endswith("running_var"):
            official[k] = np.abs(official[k]) + 0.5
    params, stats = convert_gluestick(official, n_layers=conf["n_layers"], dim=64, num_heads=2)
    model.load_state_dict(from_jax_params(params, "gluestick", num_heads=2, batch_stats=stats),
                          strict=True)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), official["matcher." + k])


def _gt(rng, data, B=2):
    """Random GT labels for points and lines (-2 ignore, -1 unmatched, or a
    one-to-one match) and the matching assignment."""
    out = {}
    for prefix, (M, N) in (("", data["keypoints0"].shape[1:2] + data["keypoints1"].shape[1:2]),
                           ("line_", data["lines0"].shape[1:2] + data["lines1"].shape[1:2])):
        m0 = np.full((B, M), -1, np.int32)
        m1 = np.full((B, N), -1, np.int32)
        assign = np.zeros((B, M, N), bool)
        for b in range(B):
            rows = rng.permutation(M)[: min(M, N) // 2]
            cols = rng.permutation(N)[: len(rows)]
            m0[b, rows], m1[b, cols] = cols, rows
            assign[b, rows, cols] = True
            m0[b, rng.permutation(M)[:2]] = np.where(m0[b, rng.permutation(M)[:2]] < 0, -2, -1)
        out[f"gt_{prefix}matches0"], out[f"gt_{prefix}matches1"] = m0, m1
        out[f"gt_{prefix}assignment"] = assign
    return out


@pytest.mark.parametrize("train", [False, True])
def test_gluestick_loss_and_metrics_match_jax(train):
    conf = {**BASE, "inter_supervision": [0, 1]}
    ref, out, gs_t, gs_j, variables, data = _pair(conf, "padded", seed=11)
    gt = _gt(np.random.default_rng(12), data)
    pred_j = {k: jnp.asarray(v) for k, v in ref.items()}
    dj = {**{k: jnp.asarray(v) for k, v in data.items()}, **{k: jnp.asarray(v) for k, v in gt.items()}}
    losses_j, metrics_j = jax.jit(lambda v, p, d: gs_j.apply(v, p, d, train=train, method="loss"))(
        variables, pred_j, dj)
    dt = {**{k: torch.from_numpy(v) for k, v in data.items()},
          **{k: torch.from_numpy(v) for k, v in gt.items()}}
    pred_t = {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()}
    losses_t, metrics_t = gs_t.loss(pred_t, dt, train=train)
    assert set(losses_t) == set(losses_j) and set(metrics_t) == set(metrics_j)
    assert "line_0_assignment_nll" in losses_t and "line_1_assignment_nll" in losses_t
    for k in losses_j:
        np.testing.assert_allclose(losses_t[k].detach().numpy(), np.asarray(losses_j[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in metrics_j:
        np.testing.assert_allclose(metrics_t[k].numpy(), np.asarray(metrics_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert train or "line_0_accuracy" in metrics_t
