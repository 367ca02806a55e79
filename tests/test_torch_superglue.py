"""The port's SuperGlue path against the JAX package's on the same seeded
inputs and weights: the Sinkhorn kernel's plain version (against the Pallas
kernel in interpret mode and the JAX loop), optimal transport with masks,
the SuperGlue matcher with non-trivial BatchNorm statistics, and the
SuperPoint + SuperGlue pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.ops import assignment as jax_assignment
from gluefactory_tpu.ops.pallas_sinkhorn import log_sinkhorn_pallas
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops import assignment
from gluefactory_tpu_torch.ops.cuda_sinkhorn import plain_log_sinkhorn

# f32 log-sum-exps summed in another order, over 20-50 iterations; the JAX
# package's own Sinkhorn kernel test holds the Pallas kernel to 1e-4
ATOL = 1e-4


def _masks(rng, B, M, N, case):
    m0, m1 = rng.uniform(size=(B, M)) > 0.3, rng.uniform(size=(B, N)) > 0.3
    if case == "none":
        return None, None
    if case == "side0_masked":
        m0[0] = False
    if case == "side1_masked":
        m1[-1] = False
    return m0, m1


def _close_where_finite(got, want, atol):
    """Equal infinities, and finite entries within atol (masked entries sit
    near -1e9, where the f32 step is 64: compare them relatively)."""
    got, want = np.asarray(got), np.asarray(want)
    assert (np.isfinite(got) == np.isfinite(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    small = fin & (np.abs(want) < 1e6)
    np.testing.assert_allclose(got[small], want[small], atol=atol, rtol=0)
    np.testing.assert_allclose(got[fin & ~small], want[fin & ~small], rtol=1e-6)


def test_plain_sinkhorn_matches_pallas_kernel_and_jax_loop():
    rng = np.random.default_rng(3)
    B, M, N = 2, 33, 41
    Z = rng.normal(size=(B, M, N)).astype(np.float32)
    log_mu = rng.normal(size=(B, M)).astype(np.float32)
    log_nu = rng.normal(size=(B, N)).astype(np.float32)
    got = plain_log_sinkhorn(*(torch.from_numpy(a) for a in (Z, log_mu, log_nu)), 20).numpy()
    jz, jmu, jnu = (jnp.asarray(a) for a in (Z, log_mu, log_nu))
    np.testing.assert_allclose(got, np.asarray(log_sinkhorn_pallas(jz, jmu, jnu, 20, interpret=True)),
                               atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_assignment.log_sinkhorn_iterations(jz, jmu, jnu, 20)),
                               atol=ATOL)


@pytest.mark.parametrize("case", ["none", "partial", "side0_masked", "side1_masked"])
def test_log_optimal_transport_matches_jax(case, monkeypatch):
    """Couplings with dustbins and -1e9 masked entries through the plain
    Sinkhorn (what a CPU tensor runs) against JAX's `log_optimal_transport`
    (its loop), and the same couplings through the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(4)
    B, M, N = 2, 24, 30
    scores = rng.normal(size=(B, M, N)).astype(np.float32)
    m0, m1 = _masks(rng, B, M, N, case)
    as_j = lambda m: None if m is None else jnp.asarray(m)  # noqa: E731
    as_t = lambda m: None if m is None else torch.from_numpy(m)  # noqa: E731
    want = jax_assignment.log_optimal_transport(jnp.asarray(scores), 1.3, 50, as_j(m0), as_j(m1))
    args = (torch.from_numpy(scores), torch.tensor(1.3), 50, as_t(m0), as_t(m1))
    got = assignment.log_optimal_transport(*args)
    assert got.dtype == torch.float32 and got.shape == (B, M + 1, N + 1)
    _close_where_finite(got.numpy(), want, ATOL)

    def pallas(Z, log_mu, log_nu, iters, flash=True):
        out = log_sinkhorn_pallas(*(jnp.asarray(t.numpy()) for t in (Z, log_mu, log_nu)), iters,
                                  interpret=True)
        return torch.from_numpy(np.array(out))

    monkeypatch.setattr(assignment, "log_sinkhorn_iterations", pallas)
    _close_where_finite(assignment.log_optimal_transport(*args).numpy(), got.numpy(), ATOL)
    if m0 is not None:  # padded rows carry no mass: only -1e9 scale entries
        assert (got[:, :M][torch.from_numpy(~m0)] < -1e8).all()


def test_log_optimal_transport_is_f32_for_bf16_scores():
    rng = np.random.default_rng(5)
    scores = torch.from_numpy(rng.normal(size=(1, 8, 9)).astype(np.float32))
    out = assignment.log_optimal_transport(scores.bfloat16(), torch.tensor(1.0).bfloat16(), 5)
    assert out.dtype == torch.float32
    torch.testing.assert_close(
        out, assignment.log_optimal_transport(scores.bfloat16().float(), torch.tensor(1.0), 5))


SG_CONF = {"descriptor_dim": 64, "keypoint_encoder": [8, 16], "n_layers": 2, "num_heads": 2,
           "filter_threshold": 0.01, "checkpointed": False}


def _matcher_data(rng, B=2, M=40, N=36, D=64, n_pad=(6, 9)):
    """View 1 holds a permuted, jittered copy of view 0 so that random
    weights still give mutual matches; the last keypoints are padding."""
    k0 = rng.uniform(0, 128, (B, M, 2))
    d0 = rng.normal(size=(B, M, D))
    perm = rng.permutation(M)[:N]
    k1 = k0[:, perm] + rng.normal(scale=0.5, size=(B, N, 2))
    d1 = d0[:, perm] + rng.normal(scale=0.1, size=(B, N, D))
    m0, m1 = np.ones((B, M), bool), np.ones((B, N), bool)
    m0[0, M - n_pad[0]:] = False
    m1[B - 1, N - n_pad[1]:] = False
    return {
        "keypoints0": k0.astype(np.float32), "keypoints1": k1.astype(np.float32),
        "descriptors0": d0.astype(np.float32), "descriptors1": d1.astype(np.float32),
        "keypoint_scores0": rng.uniform(0, 1, (B, M)).astype(np.float32),
        "keypoint_scores1": rng.uniform(0, 1, (B, N)).astype(np.float32),
        "keypoint_mask0": m0, "keypoint_mask1": m1,
        "image_size0": np.asarray([[128.0, 96.0]] * B, np.float32),
        "image_size1": np.asarray([[128.0, 96.0]] * B, np.float32),
    }


def _randomize_batch_stats(rng, stats):
    """Non-trivial BatchNorm statistics in place of the init's 0 / 1."""
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


@pytest.fixture(scope="module")
def sg_runs():
    rng = np.random.default_rng(6)
    data = _matcher_data(rng)
    sg_j = jax_get_model("superglue").from_conf(SG_CONF)
    dj = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jax.jit(sg_j.init)({"params": jax.random.key(6)}, dj)
    variables = {"params": variables["params"],
                 "batch_stats": _randomize_batch_stats(rng, variables["batch_stats"])}
    ref = jax.jit(sg_j.apply)(variables, dj)
    sg_t = get_model("superglue").from_conf(SG_CONF, device="cpu").eval()
    sd = from_jax_params(variables["params"], "superglue", num_heads=2,
                         batch_stats=variables["batch_stats"])
    sg_t.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = sg_t({k: torch.from_numpy(v) for k, v in data.items()})
    return {k: np.asarray(v) for k, v in ref.items()}, out, sg_t, data


def test_superglue_matches_jax(sg_runs):
    ref, out, _, _ = sg_runs
    assert set(out) == set(ref)
    assert out["log_assignment"].dtype == torch.float32
    _close_where_finite(out["log_assignment"].numpy(), ref["log_assignment"], ATOL)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k])
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=1e-5)
    assert (out["matches0"] >= 0).sum() >= 10  # the comparison is not vacuous


def test_superglue_padded_keypoints_are_inert(sg_runs):
    """Padded keypoints never match, and changing what they hold changes
    nothing on the valid keypoints."""
    _, out, sg_t, data = sg_runs
    m0, m1 = torch.from_numpy(data["keypoint_mask0"]), torch.from_numpy(data["keypoint_mask1"])
    assert (out["matches0"][~m0] == -1).all() and (out["matches1"][~m1] == -1).all()
    rng = np.random.default_rng(7)
    noisy = {k: v.copy() for k, v in data.items()}
    for i, m in (("0", data["keypoint_mask0"]), ("1", data["keypoint_mask1"])):
        noisy[f"descriptors{i}"][~m] = rng.normal(size=noisy[f"descriptors{i}"][~m].shape) * 10
        noisy[f"keypoints{i}"][~m] = rng.uniform(0, 128, noisy[f"keypoints{i}"][~m].shape)
    with torch.no_grad():
        out2 = sg_t({k: torch.from_numpy(v) for k, v in noisy.items()})
    la, la2 = out["log_assignment"], out2["log_assignment"]
    M, N = m0.shape[1], m1.shape[1]
    valid = torch.zeros_like(la, dtype=torch.bool)
    valid[:, :M, :N] = m0[:, :, None] & m1[:, None, :]
    torch.testing.assert_close(la2[valid], la[valid], atol=1e-5, rtol=0)
    for k in ("matches0", "matches1"):
        torch.testing.assert_close(out2[k], out[k])


def test_superglue_bf16_stays_bf16(sg_runs):
    """Keypoints and scores arrive in f32: the encoder input follows the
    descriptors' dtype, so a bf16 model keeps its GNN in bf16, while the
    similarity and the transport stay f32."""
    _, _, sg_t, data = sg_runs
    model = get_model("superglue").from_conf(SG_CONF, device="cpu").eval()
    model.load_state_dict(sg_t.state_dict())
    model = model.to(torch.bfloat16)
    seen = []
    model.gnn.layers[-1].register_forward_hook(lambda m, args, out: seen.append(out.dtype))
    bf = {k: torch.from_numpy(v) for k, v in data.items()}
    for k in ("descriptors0", "descriptors1"):
        bf[k] = bf[k].bfloat16()
    with torch.no_grad():
        out = model(bf)
    assert seen and all(d == torch.bfloat16 for d in seen)
    assert out["log_assignment"].dtype == torch.float32


def test_superglue_state_dict_is_official_layout(sg_runs):
    """Saved weights are in the official head-fastest packing (what was
    loaded comes back), while the module holds them head-major."""
    _, _, sg_t, _ = sg_runs
    rng = np.random.default_rng(8)
    sd = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
          if v.is_floating_point() else v for k, v in sg_t.state_dict().items()}
    model = get_model("superglue").from_conf(SG_CONF, device="cpu")
    model.load_state_dict(sd)
    back = model.state_dict()
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    w = sd["gnn.layers.0.attn.proj.0.weight"][..., 0]  # official rows dh * H + h
    held = model.gnn.layers[0].attn.proj[0].weight[..., 0]  # rows h * Dh + dh
    torch.testing.assert_close(held[1], w[2])  # h = 0, dh = 1 <- official 1 * 2 + 0


PIPE_CONF = {
    "extractor": {"name": "superpoint", "channels": [8, 8, 16, 16], "head_channels": 32,
                  "descriptor_dim": 64, "max_num_keypoints": 48, "detection_threshold": 0.0,
                  "nms_radius": 3},
    "matcher": {"name": "superglue", **SG_CONF},
}


def test_superpoint_superglue_pipeline_matches_jax():
    H, W, B = 96, 128, 2
    rng = np.random.default_rng(9)
    img0 = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(scale=1e-3, size=img0.shape), 0, 1).astype(np.float32)
    size = np.asarray([[W, H]] * B, np.float32)
    data = {"view0": {"image": img0, "image_size": size}, "view1": {"image": img1, "image_size": size}}
    pipe_j = jax_get_model("two_view_pipeline").from_conf(PIPE_CONF)
    dj = jax.tree_util.tree_map(jnp.asarray, data)
    variables = jax.jit(pipe_j.init, static_argnames="method")(
        {"params": jax.random.key(9)}, dj, method="initialize")
    stats = {"matcher_model": _randomize_batch_stats(rng, variables["batch_stats"]["matcher_model"])}
    variables = {"params": variables["params"], "batch_stats": stats}
    ref = {k: np.asarray(v) for k, v in jax.jit(pipe_j.apply)(variables, dj).items()}

    pipe_t = get_model("two_view_pipeline").from_conf(PIPE_CONF, device="cpu").eval()
    pipe_t.load_state_dict(from_jax_params(variables["params"], "two_view_pipeline", num_heads=2,
                                           batch_stats=stats))
    with torch.no_grad():
        out = pipe_t(jax.tree_util.tree_map(torch.from_numpy, data))
    assert set(out) == set(ref)
    for i in "01":
        np.testing.assert_array_equal(out[f"keypoints{i}"].numpy(), ref[f"keypoints{i}"])
        np.testing.assert_allclose(out[f"descriptors{i}"].numpy(), ref[f"descriptors{i}"], atol=2e-5)
    _close_where_finite(out["log_assignment"].numpy(), ref["log_assignment"], 2e-4)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k])
    assert (out["matches0"] >= 0).sum() >= 5


# the Sinkhorn kernel's plan on an H100 (132 SMs, 232,448 bytes of shared
# memory a block): (B, M, N) -> what must hold
@pytest.mark.parametrize("shape,case", [
    ((4, 2049, 2049), "resident"),   # SuperGlue at 2048 keypoints: Z on chip, items in turn
    ((1, 4097, 4097), "streamed"),   # more than the grid's shared memory holds
    ((4, 513, 513), "several_items"),
])
def test_sinkhorn_plan(shape, case):
    from gluefactory_tpu_torch.ops.cuda_sinkhorn import MAX_BLOCKS, STATIC_SMEM, sinkhorn_plan
    from gluefactory_tpu_torch.ops._build import MAX_SHARED_BYTES

    B, M, N = shape
    plan = sinkhorn_plan(B, M, N, 132)
    assert plan["grid"] == plan["groups"] * plan["blocks"] <= 132
    assert plan["blocks"] <= MAX_BLOCKS
    # every row is owned by a block, and every block owns at least one
    assert plan["blocks"] * plan["rows"] >= M > (plan["blocks"] - 1) * plan["rows"]
    assert plan["resident"] + plan["streamed"] == plan["rows"]
    assert plan["smem"] + STATIC_SMEM <= MAX_SHARED_BYTES
    ldz = -(-N // 4) * 4
    assert plan["smem"] >= 4 * plan["resident"] * ldz
    if case == "resident":
        assert (plan["groups"], plan["blocks"], plan["rows"], plan["streamed"]) == (1, 129, 16, 0)
    elif case == "streamed":
        assert plan["groups"] == 1 and plan["streamed"] > 0 and plan["resident"] >= 1
        # the resident rows fill the block's shared memory
        assert plan["smem"] + 4 * ldz + STATIC_SMEM > MAX_SHARED_BYTES
    else:
        assert plan["groups"] == 4 and plan["streamed"] == 0


def test_log_optimal_transport_grad_matches_jax():
    """Through the plain Sinkhorn loop (the kernel's backward on the card),
    the gradient of optimal transport with masks and a learned bin score
    equals `jax.grad` of the JAX package's, in f32 (relative 1e-4)."""
    rng = np.random.default_rng(8)
    B, M, N = 2, 12, 15
    scores = rng.normal(size=(B, M, N)).astype(np.float32)
    m0, m1 = _masks(rng, B, M, N, "partial")
    g = rng.normal(size=(B, M + 1, N + 1)).astype(np.float32)

    def loss(s, b):
        out = jax_assignment.log_optimal_transport(s, b, 20, jnp.asarray(m0), jnp.asarray(m1))
        return jnp.sum(jnp.where(out > -1e8, out, 0.0) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(scores), jnp.asarray(1.3, jnp.float32))
    st = torch.from_numpy(scores).requires_grad_(True)
    bt = torch.tensor(1.3, requires_grad=True)
    out = assignment.log_optimal_transport(st, bt, 20, torch.from_numpy(m0), torch.from_numpy(m1))
    got = torch.autograd.grad((torch.where(out > -1e8, out, 0.0) * torch.from_numpy(g)).sum(), [st, bt])
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(b).max())))
