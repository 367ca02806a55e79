"""The port's wireframe extractor (`models/lines/wireframe.py`) against the
JAX package's: the endpoint clustering on chains and ties, `_assemble` from
precomputed wireframe keys, and the whole forward with a small random
SuperPoint and the LSD inside. Each side detects with its own LSD: the JAX
package's cv2 and the port's C++ one, which are bit-equal
(`test_torch_lsd.py`), so the whole forward, host step included, is held to
the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gluefactory_tpu.models.lines.wireframe as jax_wf
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.lines import wireframe
from test_torch_lsd import polygons

SP = {"name": "superpoint", "channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 64,
      "max_num_keypoints": 48, "detection_threshold": 0.0, "nms_radius": 3, "trainable": False,
      "dense_outputs": True}
CONF = {"point_extractor": SP, "max_num_lines": 24, "min_length": 10.0, "nms_radius": 3.0}


@pytest.mark.parametrize("case", ["chain", "ties", "masked", "none_valid"])
def test_cluster_endpoints_equals_jax(case):
    rng = np.random.default_rng(0)
    L = 8
    lines = rng.uniform(0, 100, (L, 2, 2)).astype(np.float32)
    valid = np.ones(L, bool)
    if case == "chain":  # endpoints 2.9 px apart in a row: one component through the chain
        lines[:4, 1] = lines[1:5, 0] = np.array([[10 + 2.9 * i, 50] for i in range(4)], np.float32)
        lines[1:5, 0, 0] += 2.9
    elif case == "ties":  # pairs exactly at the radius (<= joins them)
        lines[0, 0], lines[1, 0], lines[2, 1] = (20, 20), (23, 20), (26, 20)
    elif case == "masked":
        valid[::3] = False
    else:
        valid[:] = False
    scores = rng.uniform(0, 1, L).astype(np.float32)
    got = wireframe.cluster_endpoints_host(lines, valid, 3.0, scores)
    want = jax_wf.cluster_endpoints_host(lines, valid, 3.0, scores)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if case in ("chain", "ties"):
        assert got[2].sum() < 2 * L  # some endpoints merged


def _images(B=2, H=96, W=128):
    imgs = np.stack([np.repeat(polygons(H, W, s, n=6, noise=4)[..., None], 3, -1)
                     for s in range(B)]).astype(np.float32) / 255
    return imgs, np.asarray([[W, H]] * B, np.float32)


@pytest.fixture(scope="module")
def models():
    imgs, size = _images()
    ej = jax_get_model("wireframe").from_conf(CONF)
    data = {"image": jnp.asarray(imgs), "image_size": jnp.asarray(size)}
    pre = jax_wf.wireframe_host(imgs, 24, 10.0, 3.0)
    variables = ej.init(jax.random.key(0), {**data, **dict(zip(wireframe.WIREFRAME_KEYS,
                                                               map(jnp.asarray, pre)))})
    et = get_model("wireframe").from_conf(CONF, device="cpu").eval()
    sd = from_jax_params(variables["params"]["point_extractor"], "superpoint")
    et.point_extractor.load_state_dict(sd, strict=True)
    return ej, variables, et, imgs, size


def _compare(got, want):
    assert set(got) == set(want)
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        if g.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=k)


def test_assemble_from_precomputed_keys_equals_jax(models):
    ej, variables, et, imgs, size = models
    rng = np.random.default_rng(1)
    B, L = 2, 24
    lines = rng.uniform(0, 96, (B, L, 2, 2)).astype(np.float32)
    lmask = rng.uniform(size=(B, L)) > 0.2
    scores = rng.uniform(0, 1, (B, L)).astype(np.float32)
    pre = [np.stack(x) for x in zip(*(wireframe.cluster_endpoints_host(lines[b], lmask[b], 3.0,
                                                                       scores[b])
                                      for b in range(B)))]
    keys = {"lines": lines, "line_scores": scores, "line_mask": lmask, "junctions": pre[0],
            "junc_scores": pre[1], "junc_mask": pre[2], "lines_junc_idx": pre[3].astype(np.int32)}
    want = ej.apply(variables, {"image": jnp.asarray(imgs), "image_size": jnp.asarray(size),
                                **{k: jnp.asarray(v) for k, v in keys.items()}})
    with torch.no_grad():
        got = et({"image": torch.from_numpy(imgs), "image_size": torch.from_numpy(size),
                  **{k: torch.from_numpy(v) for k, v in keys.items()}})
    _compare(got, want)
    assert got["keypoints"].shape[1] == 2 * L + 48


@pytest.mark.parametrize("radius", [3.0, 5.0])
def test_wireframe_host_equals_jax(radius):
    """The host step, LSD and clustering, against the JAX package's with cv2
    inside: every array equal."""
    imgs = np.stack([np.repeat(polygons(120, 160, s, n=10)[..., None], 3, -1)
                     for s in (3, 4, 5)]).astype(np.float32) / 255
    got = wireframe.wireframe_host(imgs, 32, 10.0, radius)
    want = jax_wf.wireframe_host(imgs, 32, 10.0, radius)
    assert got[2].sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_forward_with_lsd_inside_equals_jax(models):
    ej, variables, et, imgs, size = models
    want = ej.apply(variables, {"image": jnp.asarray(imgs), "image_size": jnp.asarray(size)})
    with torch.no_grad():
        got = et({"image": torch.from_numpy(imgs), "image_size": torch.from_numpy(size)})
    _compare(got, want)
    assert got["line_mask"].sum(1).min() >= 5  # the polygons gave lines
    # endpoints snapped to their junctions; the originals kept
    assert not torch.equal(got["lines"], got["orig_lines"])


def test_pipeline_stacks_every_wireframe_key():
    from gluefactory_tpu_torch.models import two_view_pipeline

    assert set(wireframe.WIREFRAME_KEYS) <= set(two_view_pipeline._STACKED_KEYS)
