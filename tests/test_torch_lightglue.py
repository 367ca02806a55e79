"""The port's LightGlue (dense forward) against the JAX package's on the
same seeded inputs and the same weights (converted with `from_jax_params`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_lightglue
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model

SMALL = {"n_layers": 2, "descriptor_dim": 64, "input_dim": 32, "num_heads": 2,
         "filter_threshold": 0.01}
# one layer at the real width: d = 256, 4 heads of 64
WIDE = {"n_layers": 1, "descriptor_dim": 256, "input_dim": 256, "num_heads": 4,
        "filter_threshold": 0.01}


def _inputs(rng, conf, B=2, M=40, N=40, n_pad=(6, 9)):
    """Keypoints and descriptors; view 1 holds a permuted, jittered copy of
    view 0 so that random weights still give mutual matches."""
    D = conf["input_dim"]
    k0 = rng.uniform(0, 128, (B, M, 2))
    d0 = rng.normal(size=(B, M, D))
    perm = rng.permutation(M)[:N] if N <= M else rng.integers(0, M, N)
    k1 = k0[:, perm] + rng.normal(scale=0.5, size=(B, N, 2))
    d1 = d0[:, perm] + rng.normal(scale=0.1, size=(B, N, D))
    m0 = np.ones((B, M), bool)
    m1 = np.ones((B, N), bool)
    m0[0, M - n_pad[0]:] = False
    m1[B - 1, N - n_pad[1]:] = False
    return {
        "keypoints0": k0.astype(np.float32), "keypoints1": k1.astype(np.float32),
        "descriptors0": d0.astype(np.float32), "descriptors1": d1.astype(np.float32),
        "keypoint_mask0": m0, "keypoint_mask1": m1,
        "image_size0": np.asarray([[128.0, 96.0]] * B, np.float32),
        "image_size1": np.asarray([[128.0, 96.0]] * B, np.float32),
    }


def _run_both(conf, data, seed=0):
    lg_j = jax_get_model("lightglue").from_conf({**conf, "checkpointed": False})
    dj = {k: jnp.asarray(v) for k, v in data.items()}
    params = jax.jit(lg_j.init, static_argnames="method")(
        {"params": jax.random.key(seed)}, dj, method="initialize")
    params = {"params": params["params"]}
    ref = jax.jit(lg_j.apply)(params, dj)
    lg_t = get_model("lightglue").from_conf(conf, device="cpu").eval()
    lg_t.load_state_dict(from_jax_params(params["params"], "lightglue", conf["num_heads"]))
    with torch.no_grad():
        out = lg_t({k: torch.from_numpy(v) for k, v in data.items()})
    return {k: np.asarray(v) for k, v in ref.items()}, out, lg_t


@pytest.mark.parametrize("conf,M,N", [(SMALL, 40, 40), (SMALL, 40, 28), (WIDE, 32, 32)],
                         ids=["small-stacked", "small-uneven", "wide"])
def test_log_assignment_and_matches(conf, M, N):
    data = _inputs(np.random.default_rng(0), conf, M=M, N=N)
    ref, out, _ = _run_both(conf, data)
    B = 2
    la = out["log_assignment"]
    assert la.shape == (B, M + 1, N + 1) and la.dtype == torch.float32
    # f32 end to end; the -1e9 masked entries compare exactly
    np.testing.assert_allclose(la.numpy(), ref["log_assignment"], atol=1e-4, rtol=1e-5)
    for k in ("matches0", "matches1"):
        assert out[k].dtype == torch.int32
        np.testing.assert_array_equal(out[k].numpy(), ref[k])
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=1e-5)
    assert (out["matches0"] >= 0).sum() >= 10
    # padded keypoints never match
    assert (out["matches0"][~torch.from_numpy(data["keypoint_mask0"])] == -1).all()
    assert (out["matches1"][~torch.from_numpy(data["keypoint_mask1"])] == -1).all()


def test_matches_are_mutual():
    data = _inputs(np.random.default_rng(1), SMALL)
    _, out, _ = _run_both(SMALL, data, seed=1)
    m0, m1 = out["matches0"].long(), out["matches1"].long()
    for b in range(m0.shape[0]):
        for i in torch.nonzero(m0[b] >= 0)[:, 0]:
            assert m1[b, m0[b, i]] == i


def test_padded_keypoints_are_inert():
    """Extra keypoints behind a False mask, whatever their values, leave the
    valid block of the assignment and the matches unchanged."""
    rng = np.random.default_rng(2)
    data = _inputs(rng, SMALL, B=1, M=30, N=30, n_pad=(0, 0))
    _, out, lg_t = _run_both(SMALL, data)
    P = 10
    padded = dict(data)
    for i in "01":
        padded[f"keypoints{i}"] = np.concatenate(
            [data[f"keypoints{i}"], rng.uniform(0, 128, (1, P, 2)).astype(np.float32)], 1)
        padded[f"descriptors{i}"] = np.concatenate(
            [data[f"descriptors{i}"], 50 * rng.normal(size=(1, P, 32)).astype(np.float32)], 1)
        padded[f"keypoint_mask{i}"] = np.concatenate([data[f"keypoint_mask{i}"],
                                                      np.zeros((1, P), bool)], 1)
    with torch.no_grad():
        pout = lg_t({k: torch.from_numpy(v) for k, v in padded.items()})
    la, pla = out["log_assignment"], pout["log_assignment"]
    torch.testing.assert_close(pla[:, :30, :30], la[:, :30, :30], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(pla[:, :30, -1], la[:, :30, -1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pla[:, -1, :30], la[:, -1, :30], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pout["matches0"][:, :30], out["matches0"])
    assert (pout["matches0"][:, 30:] == -1).all() and (pout["matches1"][:, 30:] == -1).all()


def test_bf16_trunk_stays_bf16():
    """A bf16 LightGlue fed f32 keypoints keeps every attention input and
    message in bf16 (the f32 rotary angles are cast to x's dtype) and
    computes the similarity in f32; it stays close to the JAX bf16 run."""
    conf = SMALL
    data = _inputs(np.random.default_rng(3), conf)
    lg_j = jax_get_model("lightglue").from_conf({**conf, "checkpointed": False})
    dj = {k: jnp.asarray(v) for k, v in data.items()}
    params = jax.jit(lg_j.init, static_argnames="method")(
        {"params": jax.random.key(3)}, dj, method="initialize")["params"]
    cast = lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x
    dj = {k: (v.astype(jnp.bfloat16) if k.startswith("descriptors") else v) for k, v in dj.items()}
    ref = jax.jit(lg_j.apply)({"params": jax.tree.map(cast, params)}, dj)

    lg_t = get_model("lightglue").from_conf(conf, device="cpu").eval()
    lg_t.load_state_dict(from_jax_params(params, "lightglue", conf["num_heads"]))
    lg_t = lg_t.to(torch.bfloat16)
    seen = []
    for layer in lg_t.transformers:
        for mod in (layer.self_attn.out_proj, layer.cross_attn.to_out):
            mod.register_forward_hook(lambda m, args, out: seen.append((args[0].dtype, out.dtype)))
    dt = {k: torch.from_numpy(v) for k, v in data.items()}
    for k in ("descriptors0", "descriptors1"):
        dt[k] = dt[k].to(torch.bfloat16)
    with torch.no_grad():
        out = lg_t(dt)
    assert len(seen) == 2 * conf["n_layers"]
    assert all(a == o == torch.bfloat16 for a, o in seen)
    assert out["log_assignment"].dtype == torch.float32
    assert ref["log_assignment"].dtype == jnp.float32
    la_ref = np.asarray(ref["log_assignment"])
    valid = la_ref > -1e8
    # bf16 matmuls round at other places in the two frameworks: on these
    # inputs either bf16 run lies up to ~0.4 from the f32 run (log-assignment
    # entries reach -50), and the two bf16 runs differ by as much
    np.testing.assert_allclose(out["log_assignment"].numpy()[valid], la_ref[valid], atol=0.5)


def test_official_layout_without_input_proj_loads_strict():
    """The official model has no `input_proj` when input_dim ==
    descriptor_dim (an nn.Identity): such a state dict loads strict=True as
    the identity and a zero bias, and the forward matches the JAX package
    run on the same state dict through its converter (which fills in the
    same identity)."""
    conf = {**SMALL, "input_dim": SMALL["descriptor_dim"]}
    torch.manual_seed(0)
    donor = get_model("lightglue").from_conf(conf, device="cpu")
    sd = {k: v for k, v in donor.state_dict().items() if not k.startswith("input_proj.")}
    lg_t = get_model("lightglue").from_conf(conf, device="cpu").eval()
    result = lg_t.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    d = conf["descriptor_dim"]
    torch.testing.assert_close(lg_t.input_proj.weight, torch.eye(d), rtol=0, atol=0)
    assert not lg_t.input_proj.bias.any()
    data = _inputs(np.random.default_rng(4), conf)
    params = convert_lightglue({k: v.numpy() for k, v in sd.items()}, n_layers=conf["n_layers"],
                               dim=d, num_heads=conf["num_heads"])
    lg_j = jax_get_model("lightglue").from_conf({**conf, "checkpointed": False})
    ref = jax.jit(lg_j.apply)({"params": params}, {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        out = lg_t({k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(out["log_assignment"].numpy(), np.asarray(ref["log_assignment"]),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(out["matches0"].numpy(), np.asarray(ref["matches0"]))


def test_input_proj_kept_when_present_or_dims_differ():
    """A state dict that has `input_proj.*` keeps it; with input_dim !=
    descriptor_dim a missing `input_proj` is still an error."""
    conf = {**SMALL, "input_dim": SMALL["descriptor_dim"]}
    torch.manual_seed(1)
    donor = get_model("lightglue").from_conf(conf, device="cpu")
    lg_t = get_model("lightglue").from_conf(conf, device="cpu")
    lg_t.load_state_dict(donor.state_dict(), strict=True)
    torch.testing.assert_close(lg_t.input_proj.weight, donor.input_proj.weight, rtol=0, atol=0)
    other = get_model("lightglue").from_conf(SMALL, device="cpu")
    sd = {k: v for k, v in other.state_dict().items() if not k.startswith("input_proj.")}
    with pytest.raises(RuntimeError, match="input_proj"):
        get_model("lightglue").from_conf(SMALL, device="cpu").load_state_dict(sd, strict=True)
