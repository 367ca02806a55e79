"""The port's in-repo native estimators against the JAX package's on the CPU:
the ctypes bindings of the C++ LO-RANSAC (`robust_estimators/native.py`,
built from `gluefactory_tpu_torch/csrc/fastransac.cpp` into
`build/torch_ext/`), both `poselib` estimators, `two_view_native` (COLMAP's
E-versus-H selection on the batched RANSACs), and the MegaDepth-1500 CLI
with `eval.estimator=poselib`. Same seeded matches with outliers in both
packages."""

import json

import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import wrappers as jw
from gluefactory_tpu.robust_estimators import load_estimator as jload
from gluefactory_tpu.robust_estimators import native as jnative
from gluefactory_tpu.robust_estimators.relative_pose import two_view_native as jtv
from gluefactory_tpu_torch.eval import megadepth1500
from gluefactory_tpu_torch.eval.utils import angle_error_mat_np, angle_error_vec_np
from gluefactory_tpu_torch.geometry import wrappers as tw
from gluefactory_tpu_torch.ops import _build
from gluefactory_tpu_torch.robust_estimators import load_estimator as tload
from gluefactory_tpu_torch.robust_estimators import native as tnative
from gluefactory_tpu_torch.robust_estimators.relative_pose import two_view_native as ttv
from gluefactory_tpu_torch.scripts_dev.posed_scenes import synthetic_correspondences
from test_torch_eval_megadepth1500 import BENCH, _planted
from test_torch_eval_megadepth1500 import data_path, layouts  # noqa: F401 (fixtures)
from test_torch_eval_hpatches import MODEL


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL_TOL = 1e-9  # the same C++ from the same source; only the build flags differ


def _homography_matches(seed, n=120, outliers=0.3):
    rng = np.random.default_rng(seed)
    H = np.array([[1.1, 0.05, 12.0], [-0.04, 0.95, -7.0], [2e-4, -1e-4, 1.0]])
    p0 = rng.uniform(0, 640, (n, 2))
    q = np.c_[p0, np.ones(n)] @ H.T
    p1 = q[:, :2] / q[:, 2:] + rng.normal(0, 0.3, (n, 2))
    out = rng.choice(n, int(outliers * n), replace=False)
    p1[out] = rng.uniform(0, 640, (len(out), 2))
    return p0, p1, H


CAMS = [{"model": "PINHOLE", "width": 640, "height": 480, "params": [500.0, 510.0, 320.0, 240.0]},
        {"model": "SIMPLE_PINHOLE", "width": 640, "height": 480, "params": [480.0, 330.0, 235.0]}]


def _cameras():
    return [tw.Camera.from_colmap(c) for c in CAMS], [jw.Camera.from_colmap(c) for c in CAMS]


def _pose_matches(seed, n=150, outliers=0.25, planar=False):
    """Pixel matches of a known pose: a general scene, or points on one
    plane (z = 4 + 0.1 x)."""
    rng = np.random.default_rng(seed)
    p0, p1, R, t, _, _ = synthetic_correspondences(rng, n, noise=3e-4, outliers=outliers)
    if planar:
        xy = rng.uniform(-1, 1, (n, 2))
        X = np.c_[xy, 4 + 0.1 * xy[:, 0]]
        X1 = X @ R.T + t
        p0 = (X[:, :2] / X[:, 2:]).astype(np.float32)
        p1 = (X1[:, :2] / X1[:, 2:] + rng.normal(0, 3e-4, (n, 2))).astype(np.float32)
        out = rng.choice(n, int(outliers * n), replace=False)
        p1[out] = rng.uniform(-0.5, 0.5, (len(out), 2))
    tc, jc = _cameras()
    k0 = np.asarray(jc[0].denormalize(p0[None]))[0]
    k1 = np.asarray(jc[1].denormalize(p1[None]))[0]
    return k0, k1, tc, jc, R, t


def test_library_builds_into_the_port_build_dir():
    path = _build.build_host("fastransac")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("fastransac-host-")
    assert "native" not in path.parts
    # the port's copy: the JAX package's source line for line but for the
    # header's build note
    code = [(_build.CSRC / "fastransac.cpp").read_text().splitlines(),
            (_build.CSRC.parents[1] / "native" / "fastransac.cpp").read_text().splitlines()]
    assert [ln for ln in code[0] if not ln.startswith("//")] == [ln for ln in code[1] if not ln.startswith("//")]


@pytest.mark.parametrize("seed", [0, 1])
def test_raw_homography_binding_equals_jax(seed):
    p0, p1, H = _homography_matches(seed)
    Ht, it, nt = tnative.ransac_homography_native(p0, p1, 2.0, max_iters=500, seed=seed)
    Hj, ij, nj = jnative.ransac_homography_native(p0, p1, 2.0, max_iters=500, seed=seed)
    np.testing.assert_array_equal(it, ij)
    assert nt == nj and nt >= 0.6 * len(p0)
    np.testing.assert_allclose(Ht, Hj, atol=MODEL_TOL, rtol=0)
    q = np.c_[p0, np.ones(len(p0))] @ Ht.T
    clean = np.linalg.norm(np.c_[p0, np.ones(len(p0))] @ H.T, axis=-1) > 0  # all rows
    err = np.linalg.norm(q[:, :2] / q[:, 2:] - p1, axis=-1)[it & clean]
    assert err.mean() < 1.0  # the inliers' transfer error, noise 0.3 px


@pytest.mark.parametrize("seed", [0, 1])
def test_raw_essential_binding_equals_jax(seed):
    rng = np.random.default_rng(seed)
    p0, p1, R, t, _, _ = synthetic_correspondences(rng, 150, noise=3e-4, outliers=0.3)
    Rt, tt, it, nt = tnative.ransac_essential_native(p0, p1, 2e-3, max_iters=500, seed=seed)
    Rj, tj, ij, nj = jnative.ransac_essential_native(p0, p1, 2e-3, max_iters=500, seed=seed)
    np.testing.assert_array_equal(it, ij)
    assert nt == nj
    np.testing.assert_allclose(Rt, Rj, atol=MODEL_TOL, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=MODEL_TOL, rtol=0)
    assert angle_error_mat_np(Rt, R) < 1


def test_poselib_homography_equals_jax():
    est_t, est_j = tload("homography", "poselib")(), jload("homography", "poselib")()
    assert dict(est_t.conf) == dict(est_j.conf)
    p0, p1, _ = _homography_matches(2)
    got = est_t({"m_kpts0": p0, "m_kpts1": p1})
    want = est_j({"m_kpts0": p0, "m_kpts1": p1})
    assert got["success"] and want["success"]
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    assert got["M_0to1"].dtype == np.float32
    np.testing.assert_array_equal(got["M_0to1"], want["M_0to1"])
    few = est_t({"m_kpts0": p0[:3], "m_kpts1": p1[:3]})
    assert not few["success"] and few["inliers"].shape == (3,)
    np.testing.assert_array_equal(few["M_0to1"], np.eye(3))


def test_poselib_relative_pose_equals_jax():
    est_t, est_j = tload("relative_pose", "poselib")(), jload("relative_pose", "poselib")()
    assert dict(est_t.conf) == dict(est_j.conf)
    for seed in range(2):
        k0, k1, tc, jc, R, _ = _pose_matches(seed)
        got = est_t({"m_kpts0": k0, "m_kpts1": k1, "camera0": tc[0], "camera1": tc[1]})
        want = est_j({"m_kpts0": k0, "m_kpts1": k1, "camera0": jc[0], "camera1": jc[1]})
        assert got["success"] and want["success"]
        np.testing.assert_array_equal(got["inliers"], want["inliers"])
        np.testing.assert_array_equal(got["M_0to1"].R.numpy(), np.asarray(want["M_0to1"].R))
        np.testing.assert_array_equal(got["M_0to1"].t.numpy(), np.asarray(want["M_0to1"].t))
        assert angle_error_mat_np(got["M_0to1"].R.numpy(), R) < 1
    few = est_t({"m_kpts0": k0[:4], "m_kpts1": k1[:4], "camera0": tc[0], "camera1": tc[1]})
    assert not few["success"] and few["inliers"].shape == (4,)


def _recorded(monkeypatch, mod):
    calls = []
    real = mod.decompose_homography
    monkeypatch.setattr(mod, "decompose_homography", lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("planar", [False, True])
def test_two_view_native_equals_jax(monkeypatch, planar):
    """The same model decision (the homography's decomposition runs in both
    or in neither), inliers agreeing on >= 99% of the matches (the minimal
    solver's candidates come from another nullspace basis,
    `tests/test_torch_essential.py`), R and t within 0.1 degrees."""
    est_t = tload("relative_pose", "two_view_native")({"device": "cpu"})
    est_j = jload("relative_pose", "two_view_native")()
    calls_t, calls_j = _recorded(monkeypatch, ttv), _recorded(monkeypatch, jtv)
    k0, k1, tc, jc, R, t = _pose_matches(3 + planar, planar=planar)
    got = est_t({"m_kpts0": k0, "m_kpts1": k1, "camera0": tc[0], "camera1": tc[1]})
    want = est_j({"m_kpts0": k0, "m_kpts1": k1, "camera0": jc[0], "camera1": jc[1]})
    assert got["success"] and want["success"]
    assert bool(calls_t) == bool(calls_j) == planar
    assert (got["inliers"] == want["inliers"]).mean() >= 0.99
    Rt, tt = got["M_0to1"].R.numpy(), got["M_0to1"].t.numpy()
    assert angle_error_mat_np(Rt, np.asarray(want["M_0to1"].R)) < 0.1
    assert angle_error_vec_np(tt, np.asarray(want["M_0to1"].t)) < 0.1
    assert angle_error_mat_np(Rt, R) < 2


def test_two_view_native_fails_below_eight_matches():
    est = tload("relative_pose", "two_view_native")({"device": "cpu"})
    assert tload("relative_pose", "two_view_native")().conf.device == "cuda"
    k0, k1, tc, _, _, _ = _pose_matches(5)
    out = est({"m_kpts0": k0[:7], "m_kpts1": k1[:7], "camera0": tc[0], "camera1": tc[1]})
    assert not out["success"] and out["inliers"].shape == (7,)


def test_decompose_homography_equals_jax():
    rng = np.random.default_rng(6)
    Hn = np.eye(3) + rng.normal(0, 0.1, (3, 3))
    p = rng.normal(size=(10, 2))
    got, want = ttv.decompose_homography(Hn, p, p), jtv.decompose_homography(Hn, p, p)
    assert len(got) == len(want) == 4
    for (Rg, tg), (Rw, tw_) in zip(got, want):
        np.testing.assert_array_equal(Rg, Rw)
        np.testing.assert_array_equal(tg, tw_)
    R, t = got[0]
    assert ttv._cheirality_count(R, t, p, p) == jtv._cheirality_count(R, t, p, p)


def test_megadepth1500_cli_with_poselib(data_path, monkeypatch):  # noqa: F811
    """The eval CLI on the tiny MegaDepth-1500 layout of
    `tests/test_torch_eval_posed.py` with `eval.estimator=poselib`."""
    monkeypatch.setattr(megadepth1500, "EVAL_PATH", data_path / "results")
    argv = ["--conf", "superpoint+lightglue-official", "--device", "cpu", "--tag", "poselib",
            "eval.estimator=poselib", "data.num_workers=0", "data.preprocessing.resize=100",
            "model.extractor.max_num_keypoints=64", "model.matcher.n_layers=2", "data.depth_format=png"]
    torch.manual_seed(0)
    s, _, r = megadepth1500.main(argv)
    out = data_path / "results" / "megadepth1500" / "poselib"
    assert json.loads((out / "summaries.json").read_text()) == s
    assert len(r["rel_pose_error"]) == 5
    aucs = ("rel_pose_error@5°", "rel_pose_error@10°", "rel_pose_error@20°", "rel_pose_error_mAA")
    assert all(np.isfinite(s[k]) for k in aucs)


def test_eval_loop_with_poselib_equals_jax(data_path, tmp_path):  # noqa: F811
    """The MegaDepth-1500 eval loop with `poselib` on a planted cache
    (`tests/test_torch_eval_megadepth1500.py`), both packages reading one
    file: the same inliers and pose errors, the summaries within 1e-6."""
    import h5py

    tpipe, jpipe, data, n_pairs = BENCH["megadepth1500"]
    preds = _planted(tpipe, data)
    with h5py.File(tmp_path / "predictions.h5", "w") as hfile:
        for name, pred in preds.items():
            grp = hfile.create_group(name)
            for k, v in pred.items():
                grp.create_dataset(k, data=v)
    conf = {"data": data, "model": MODEL, "eval": {"estimator": "poselib", "ransac_th": [1.0]}}
    jp = jpipe(conf)
    sj, _, rj = jp.run_eval(jp.get_dataloader(jp.conf.data), tmp_path / "predictions.h5")
    tp = tpipe(conf, device="cpu")
    st, _, rt = tp.run_eval(tp.get_dataloader(tp.conf.data), tmp_path / "predictions.h5")
    assert sj["rel_pose_error@20°"] > 0.5  # far from random poses
    np.testing.assert_array_equal(rt["ransac_inl"], rj["ransac_inl"])
    np.testing.assert_allclose(np.asarray(rt["rel_pose_error"], np.float64),
                               np.asarray(rj["rel_pose_error"], np.float64), atol=1e-6, rtol=0)
    assert set(st) == set(sj)
    for k, v in sj.items():
        np.testing.assert_allclose(st[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
