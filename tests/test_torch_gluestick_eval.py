"""GlueStick end to end on the CPU against the JAX package: the two-view
pipeline with `superpoint+lsd+gluestick` scaled down (wireframe of a 3-conv
SuperPoint at 48 keypoints and 16 lines, GlueStick-2 at 32 wide), the
HPatches benchmark with `xla_ransac` and with the point and line RANSAC
(`homography_est`), and ETH3D with the line GT in the forward and
`eval_lines`. Both packages get the same random weights (drawn in the port,
lecun-normal and zero biases, converted by the JAX package's converters).
Each side detects lines with its own LSD, cv2 in the JAX package and the
port's C++ one (bit-equal, `test_torch_lsd.py`), so these hold the whole
line path to the JAX package's, detection included.

The `superpoint+lsd+gluestick` config by name through the ETH3D CLI on the
CPU is in `test_torch_eval_eth3d.py::test_cli_by_name_on_cpu`.
"""

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_gluestick, convert_superpoint
from gluefactory_tpu.eval import eth3d as jax_eth3d_eval
from gluefactory_tpu.eval import hpatches as jax_hpatches
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.eval import eth3d as port_eth3d
from gluefactory_tpu_torch.eval import hpatches
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.utils.export_predictions import load_predictions
from test_torch_eval_eth3d import DATA as ETH3D_DATA
from test_torch_eval_eth3d import data_path, layout  # noqa: F401 (fixtures)
from test_torch_lsd import polygons

W, H = 160, 120
EXTRACTOR = {
    "name": "wireframe",
    "point_extractor": {"name": "superpoint", "channels": [8, 8, 16, 16], "head_channels": 32,
                        "descriptor_dim": 32, "max_num_keypoints": 48, "detection_threshold": 0.0,
                        "nms_radius": 3, "trainable": False, "dense_outputs": True,
                        "force_num_keypoints": False},
    "max_num_lines": 16, "min_length": 10.0, "nms_radius": 3,
}
MATCHER = {"name": "gluestick", "input_dim": 32, "descriptor_dim": 32,
           "keypoint_encoder": [8, 8, 16, 16], "n_layers": 2, "num_heads": 2,
           "filter_threshold": 0.01}
MODEL = {"name": "two_view_pipeline", "extractor": EXTRACTOR, "matcher": MATCHER}


def random_models(model_conf):
    """(JAX pipeline, its variables, the port's pipeline), same weights."""
    conf = {k: v for k, v in model_conf.items() if k != "name"}
    torch.manual_seed(5)
    pt = get_model("two_view_pipeline").from_conf(conf, device="cpu")
    with torch.no_grad():
        for name, prm in pt.named_parameters():
            if name.endswith("bias"):
                prm.zero_()
            elif prm.ndim >= 2:
                torch.nn.init.normal_(prm, std=prm[0].numel() ** -0.5)
    sd = {k: v.detach().numpy() for k, v in pt.state_dict().items()}
    part = lambda prefix: {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}  # noqa: E731
    mp, ms = convert_gluestick(part("matcher."), n_layers=2, dim=32, num_heads=2)
    params = {"extractor_model": {"point_extractor": convert_superpoint(
        part("extractor.point_extractor."))}, "matcher_model": mp}
    variables = {"params": params, "batch_stats": {"matcher_model": ms}}
    pt.load_state_dict(from_jax_params(params, "two_view_pipeline", num_heads=2,
                                       batch_stats=variables["batch_stats"]), strict=True)
    return jax_get_model("two_view_pipeline").from_conf(conf), variables, pt.eval()


def test_pipeline_equals_jax():
    imgs = np.stack([np.repeat(polygons(H, W, s, n=8, noise=4)[..., None], 3, -1)
                     for s in range(2)]).astype(np.float32) / 255
    img1 = np.roll(imgs, (3, -5), axis=(1, 2))
    size = np.asarray([[W, H]] * 2, np.float32)
    data = {"view0": {"image": imgs, "image_size": size},
            "view1": {"image": img1, "image_size": size}}
    pj, variables, pt = random_models(MODEL)
    ref = {k: np.asarray(v) for k, v in pj.apply(variables, jax.tree_util.tree_map(
        jnp.asarray, data)).items()}
    with torch.no_grad():
        out = pt(jax.tree_util.tree_map(torch.from_numpy, data))
    assert set(out) == set(ref)
    for k in ref:
        g = out[k].numpy()
        if "log_assignment" in k:
            fin = np.abs(ref[k]) < 1e6
            np.testing.assert_allclose(g[fin], ref[k][fin], atol=1e-4, err_msg=k)
        elif g.dtype == bool or np.issubdtype(ref[k].dtype, np.integer):
            if "matches" in k:
                sk = k.replace("matches", "matching_scores")
                clear = np.abs(ref[sk] - MATCHER["filter_threshold"]) > 1e-4
                np.testing.assert_array_equal(g[clear], ref[k][clear], err_msg=k)
            else:
                np.testing.assert_array_equal(g, ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(g, ref[k], atol=1e-4, rtol=1e-5, err_msg=k)
    assert out["line_mask0"].sum() >= 8 and (out["matches0"] >= 0).sum() >= 5


def write_sequence(root, seq="i_lines", seed=0, pairs=5):
    """HPatches layout of polygon images translated by multiples of 8 px."""
    d = root / seq
    d.mkdir(parents=True)
    big = np.repeat(polygons(H + 64, W + 64, seed, n=10, noise=4)[..., None], 3, -1)
    cv2.imwrite(str(d / "1.ppm"), big[32:32 + H, 32:32 + W])
    for q in range(2, 2 + pairs):
        tx, ty = 8 * (q - 3), -8 * (q - 2)
        Hq = np.eye(3)
        Hq[:2, 2] = tx, ty
        cv2.imwrite(str(d / f"{q}.ppm"), big[32 - ty:32 - ty + H, 32 - tx:32 - tx + W])
        np.savetxt(str(d / f"H_1_{q}"), Hq)


@pytest.mark.parametrize("estimator", ["xla_ransac", "homography_est"])
def test_hpatches_equals_jax(tmp_path, monkeypatch, estimator):
    import gluefactory_tpu.data.hpatches as jhp
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings

    write_sequence(tmp_path / "hpatches-sequences-release")
    for mod in (jsettings, jhp, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    conf = {"data": {"num_workers": 0, "preprocessing": {"resize": H, "side": "short"}},
            "model": MODEL, "eval": {"estimator": estimator, "ransac_th": [2.0]}}
    pj, variables, pt = random_models(MODEL)
    sj, _, rj = jax_hpatches.HPatchesPipeline(conf).run(
        tmp_path / "jax", model=pj, variables=variables, overwrite=True, overwrite_eval=True)
    st, _, rt = hpatches.HPatchesPipeline(conf, device="cpu").run(
        tmp_path / "port", model=pt, overwrite=True, overwrite_eval=True)
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-3, atol=1e-9, err_msg=k)
    for k in ("num_matches", "num_keypoints", "ransac_inl"):
        np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)
    np.testing.assert_allclose(rt["H_error_ransac"], rj["H_error_ransac"], rtol=5e-3)
    assert all(np.isfinite(v) for k, v in st.items() if "auc" in k.lower() or "@" in k)


def test_eth3d_lines_equal_jax(data_path):  # noqa: F811
    gt = {"run_gt_in_forward": True,
          "ground_truth": {"name": "depth_matcher", "use_points": True, "use_lines": True,
                           "th_positive": 3.0, "th_negative": 5.0}}
    model = {**MODEL, **gt}
    conf = {"data": ETH3D_DATA, "model": model, "eval": {"eval_lines": True}}
    pj, variables, pt = random_models(model)
    sj, _, rj = jax_eth3d_eval.ETH3DPipeline(conf).run(
        data_path / "jax", model=pj, variables=variables, overwrite=True, overwrite_eval=True)
    st, _, rt = port_eth3d.ETH3DPipeline(conf, device="cpu").run(
        data_path / "port", model=pt, overwrite=True, overwrite_eval=True)
    assert set(st) == set(sj) == {"AP", "AP_lines"}
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-6, err_msg=k)
    assert np.isfinite(st["AP_lines"])
    cache = load_predictions(data_path / "port" / "predictions.h5")
    with h5py.File(data_path / "jax" / "predictions.h5") as hfile:
        n_gt = 0
        for name in hfile:
            for k in ("gt_line_matches0", "line_matches0", "lines0"):
                np.testing.assert_array_equal(cache[name][k], hfile[name][k][()], err_msg=k)
            n_gt += int((cache[name]["gt_line_matches0"] >= 0).sum())
    assert n_gt >= 1  # the line GT found correspondences
