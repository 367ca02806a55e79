"""The port's camera and pose geometry against the JAX package's on the CPU
(`geometry/{utils,wrappers,epipolar,depth}.py` and
`gt_generation.gt_matches_from_pose_depth`), on inputs drawn from numpy
seeds: batched random poses, every COLMAP model the wrappers read (the
radial ones with distortion), depth maps of a tilted plane with holes
(zeros and NaNs). Float outputs within 1e-5 (pixels within 1e-4, angles in
degrees within 1e-3, residual-like values within 1e-5 of their largest
entry, each as stated), masks and matches equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import depth as jdepth
from gluefactory_tpu.geometry import epipolar as jepi
from gluefactory_tpu.geometry import gt_generation as jgt
from gluefactory_tpu.geometry import utils as jutils
from gluefactory_tpu.geometry import wrappers as jw
from gluefactory_tpu_torch.geometry import depth as tdepth
from gluefactory_tpu_torch.geometry import epipolar as tepi
from gluefactory_tpu_torch.geometry import gt_generation as tgt
from gluefactory_tpu_torch.geometry import utils as tutils
from gluefactory_tpu_torch.geometry import wrappers as tw

TOL = 1e-5
W, H = 96, 72

COLMAP = [
    {"model": "SIMPLE_PINHOLE", "width": W, "height": H, "params": [80.0, 48.0, 36.0]},
    {"model": "SIMPLE_RADIAL", "width": W, "height": H, "params": [80.0, 47.5, 36.5, -0.05]},
    {"model": "RADIAL", "width": W, "height": H, "params": [82.0, 48.0, 35.0, 0.03, -0.01]},
    {"model": "PINHOLE", "width": W, "height": H, "params": [80.0, 78.0, 48.5, 36.0]},
    {"model": "OPENCV", "width": W, "height": H,
     "params": [80.0, 81.0, 48.0, 36.0, -0.04, 0.01, 0.001, -0.002]},
]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True)


def close_scaled(got, want, tol=TOL):
    """Within tol of the largest magnitude of `want` (residual-like values
    whose small entries come from cancellation)."""
    scale = float(np.nanmax(np.abs(_np(want))))
    close(_np(got) / scale, _np(want) / scale, tol)


def _rotations(rng, n, max_angle=0.5):
    return rng.normal(size=(n, 3)) * max_angle / 2


def _poses(seed, n=6):
    rng = np.random.default_rng(seed)
    aa = _rotations(rng, n).astype(np.float32)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return aa, t


def _both_poses(seed, n=6):
    aa, t = _poses(seed, n)
    return tw.Pose.from_aa(torch.from_numpy(aa), torch.from_numpy(t)), jw.Pose.from_aa(aa, t)


def _camera_pair(cam):
    return tw.Camera.from_colmap(cam), jw.Camera.from_colmap(cam)


def test_utils():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(4, 5, 3)).astype(np.float32)
    close(tutils.to_homogeneous(torch.from_numpy(v)), jutils.to_homogeneous(v))
    close(tutils.from_homogeneous(torch.from_numpy(v), eps=1e-3), jutils.from_homogeneous(v, eps=1e-3))
    close(tutils.skew_symmetric(torch.from_numpy(v)), jutils.skew_symmetric(v))
    w = np.concatenate([v[0], np.zeros((1, 3), np.float32), np.full((1, 3), 1e-9, np.float32)])
    close(tutils.so3exp_map(torch.from_numpy(w)), jutils.so3exp_map(w))
    pts = rng.uniform(-0.7, 0.7, (3, 10, 2)).astype(np.float32)
    dist = rng.uniform(-0.1, 0.1, (3, 1, 2)).astype(np.float32)
    got, gv = tutils.distort_points(torch.from_numpy(pts), torch.from_numpy(dist))
    want, wv = jutils.distort_points(pts, dist)
    close(got, want)
    close(gv, wv)
    close(tutils.undistort_points(torch.from_numpy(pts), torch.from_numpy(dist)),
          jutils.undistort_points(pts, dist))
    close(tutils.image_grid(5, 7), jutils.image_grid(5, 7))


def test_pose_methods():
    tp, jp = _both_poses(1)
    tq, jq = _both_poses(2)
    close(tp.R, jp.R)
    close(tp.t, jp.t)
    for got, want in [(tp.inv(), jp.inv()), (tp @ tq, jp @ jq), (tp.compose(tq.inv()), jp.compose(jq.inv())),
                      (tw.Pose.from_4x4mat(tp.matrix()), jw.Pose.from_4x4mat(jp.matrix())),
                      (tw.Pose.stack([tp[0], tq[1]]), jw.Pose.stack([jp[0], jq[1]])),
                      (tw.Pose.concatenate([tp, tq]), jw.Pose.concatenate([jp, jq])),
                      (tw.Pose.from_Rt(tp.R, tp.t), jw.Pose.from_Rt(jp.R, jp.t))]:
        close(got.R, want.R)
        close(got.t, want.t)
    close(tp.matrix(), jp.matrix())
    pts = np.random.default_rng(3).normal(size=(6, 11, 3)).astype(np.float32)
    close(tp.transform(torch.from_numpy(pts)), jp.transform(pts))
    close(tp @ torch.from_numpy(pts), jp @ pts)
    for got, want in zip(tp.magnitude(), jp.magnitude()):
        close(got, want, tol=1e-4)  # degrees: arccos near 1 loses float32 digits
    ti, ji = tw.Pose.identity((2, 3)), jw.Pose.identity((2, 3))
    close(ti.R, ji.R)
    close(ti.t, ji.t)
    assert tp.shape == jp.shape and tp[1:3].shape == jp[1:3].shape
    assert tp.to(torch.float64).dtype == torch.float64


@pytest.mark.parametrize("cam", COLMAP, ids=[c["model"] for c in COLMAP])
def test_camera_methods(cam):
    tc, jc = _camera_pair(cam)
    for k in ("size", "f", "c", "dist"):
        close(getattr(tc, k), getattr(jc, k))
    assert tc.to_cameradict() == jc.to_cameradict()
    close(tc.calibration_matrix(), jc.calibration_matrix())
    rng = np.random.default_rng(4)
    p3d = np.concatenate([rng.uniform(-1, 1, (1, 40, 2)), rng.uniform(0.5, 4, (1, 40, 1))], -1)
    p3d[0, :3, 2] = [0.0, -1.0, 1e-4]  # behind or on the camera plane
    p3d = p3d.astype(np.float32)
    tb, jb = tc.stack([tc, tc]), jc.stack([jc, jc])  # batched (2,)
    p3d2 = np.concatenate([p3d, p3d * 1.1], 0)
    for got, want in zip(tb.project(torch.from_numpy(p3d2)), jb.project(p3d2)):
        close(got, want)
    p2d = rng.uniform(-0.6, 0.6, (2, 40, 2)).astype(np.float32)
    for got, want in zip(tb.distort(torch.from_numpy(p2d)), jb.distort(p2d)):
        close(got, want)
    for got, want in zip(tb.undistort(torch.from_numpy(p2d)), jb.undistort(p2d)):
        close(got, want)
    close(tb.denormalize(torch.from_numpy(p2d)), jb.denormalize(p2d), tol=1e-4)  # pixels ~1e2
    pix = rng.uniform(-5, [W + 5, H + 5], (2, 40, 2)).astype(np.float32)
    close(tb.normalize(torch.from_numpy(pix)), jb.normalize(pix))
    close(tb.in_image(torch.from_numpy(pix)), jb.in_image(pix))
    got, gv = tb.cam2image(torch.from_numpy(p3d2))
    want, wv = jb.cam2image(p3d2)
    close(gv, wv)
    close(got, want, tol=1e-4)
    close(tb.image2cam(torch.from_numpy(pix)), jb.image2cam(pix))
    d = rng.uniform(1, 5, (2, 40)).astype(np.float32)
    close(tw.unproject_depth(tb, torch.from_numpy(pix), torch.from_numpy(d)),
          jw.unproject_depth(jb, pix, d), tol=1e-4)
    for got, want in [(tc.scale(0.5), jc.scale(0.5)), (tc.scale([0.5, 0.25]), jc.scale([0.5, 0.25])),
                      (tc.crop([3, 4], [40, 30]), jc.crop([3, 4], [40, 30])), (tb[1], jb[1])]:
        for k in ("size", "f", "c", "dist"):
            close(getattr(got, k), getattr(want, k))
    K = np.array(jc.calibration_matrix())
    for got, want in [(tw.Camera.from_calibration_matrix(torch.from_numpy(K)),
                       jw.Camera.from_calibration_matrix(K))]:
        for k in ("size", "f", "c", "dist"):
            close(getattr(got, k), getattr(want, k))


def _correspondences(seed, n=32):
    rng = np.random.default_rng(seed)
    tp, jp = _both_poses(seed, 3)
    X = np.concatenate([rng.uniform(-1, 1, (3, n, 2)), rng.uniform(2, 5, (3, n, 1))], -1)
    X1 = np.asarray(jp.transform(X.astype(np.float32)))
    p0 = (X[..., :2] / X[..., 2:]).astype(np.float32)
    p1 = (X1[..., :2] / X1[..., 2:] + rng.normal(size=X1[..., :2].shape) * 1e-2).astype(np.float32)
    return tp, jp, p0, p1


def test_epipolar():
    tp, jp, p0, p1 = _correspondences(5)
    Et, Ej = tepi.T_to_E(tp), jepi.T_to_E(jp)
    close(Et, Ej)
    tcam, jcam = _camera_pair(COLMAP[3])
    close_scaled(tepi.T_to_F(tcam, tcam, tp), jepi.T_to_F(jcam, jcam, jp))
    P0, P1 = torch.from_numpy(p0), torch.from_numpy(p1)
    for squared in (True, False):
        close_scaled(tepi.sym_epipolar_distance(P0, P1, Et, squared),
                     jepi.sym_epipolar_distance(p0, p1, Ej, squared))
    close_scaled(tepi.sym_epipolar_distance_all(P0, P1, Et), jepi.sym_epipolar_distance_all(p0, p1, Ej))
    # the decomposition's candidates: equal as a set (SVD bases may differ)
    for got, want in zip(tepi.E_to_Rt_candidates(Et), jepi.E_to_Rt_candidates(Ej)):
        assert got[0].shape == want[0].shape
    cand_t = [(R.numpy(), t.numpy()) for R, t in tepi.E_to_Rt_candidates(Et)]
    cand_j = [(np.asarray(R), np.asarray(t)) for R, t in jepi.E_to_Rt_candidates(Ej)]
    for b in range(3):
        for R, t in cand_t:
            assert min(np.abs(R[b] - Rj[b]).max() + np.abs(t[b] - tj[b]).max() for Rj, tj in cand_j) < 1e-4
    R_est = tw.Pose.from_aa(torch.from_numpy(np.full((3, 3), 0.05, np.float32)), tp.t).R @ tp.R
    t_est = tp.t + 0.1
    for got, want in zip(tepi.relative_pose_error(tp, R_est, t_est),
                         jepi.relative_pose_error(jp, jnp.asarray(R_est.numpy()), jnp.asarray(t_est.numpy()))):
        close(got, want, tol=1e-3)  # degrees through float32 arccos
    close(tepi.angle_error_mat(R_est, tp.R), jepi.angle_error_mat(jnp.asarray(R_est.numpy()), jp.R), tol=1e-3)
    close(tepi.angle_error_vec(t_est, tp.t), jepi.angle_error_vec(jnp.asarray(t_est.numpy()), jp.t), tol=1e-3)


def plane_depth(cam, T_0to1, h=H, w=W, z0=4.0, tilt=0.1):
    """Depth maps (h, w) of the plane z = z0 + tilt * x (camera 0's frame)
    in both views, with holes."""
    def depth_of(cam_j, R, t):
        # plane n . X = d in camera 0, moved into camera j: X0 = R^T (Xj - t)
        n0, d0 = np.array([-tilt, 0.0, 1.0]), z0
        n = R @ n0
        d = d0 + n @ t
        rays = np.asarray(cam_j.image2cam(jutils.image_grid(h, w).reshape(1, -1, 2)))[0]
        return (d / (rays @ n)).reshape(h, w)
    R, t = np.asarray(T_0to1.R, np.float64), np.asarray(T_0to1.t, np.float64)
    d0 = depth_of(cam, np.eye(3), np.zeros(3))
    d1 = depth_of(cam, R, t)
    rng = np.random.default_rng(0)
    for d in (d0, d1):
        d[rng.random(d.shape) < 0.05] = 0.0
        d[rng.random(d.shape) < 0.02] = np.nan
        d[:10, :12] = 0.0  # a block without depth
    return d0.astype(np.float32), d1.astype(np.float32)


def _scene(seed=6, cam=COLMAP[1], n=48):
    rng = np.random.default_rng(seed)
    tcam, jcam = _camera_pair(cam)
    aa = (rng.normal(size=3) * 0.05).astype(np.float32)
    t = np.array([0.3, 0.02, 0.05], np.float32)
    tp, jp = tw.Pose.from_aa(torch.from_numpy(aa), torch.from_numpy(t)), jw.Pose.from_aa(aa, t)
    d0, d1 = plane_depth(jcam, jp)
    kp0 = rng.uniform(0, [W, H], (n, 2)).astype(np.float32)
    dd, _ = jdepth.sample_depth(kp0[None], d0[None])
    kp1, _ = jdepth.project(kp0[None], dd, None, jcam, jcam, jp, jnp.ones((1, n), bool))
    kp1 = np.asarray(kp1)[0] + rng.normal(size=(n, 2)) * 1.0
    kp1[: n // 4] = rng.uniform(0, [W, H], (n // 4, 2))
    kp1 = kp1[rng.permutation(n)].astype(np.float32)
    return (tcam, jcam, tp, jp, d0, d1, kp0, kp1)


def test_sample_depth():
    *_, d0, d1, kp0, kp1 = _scene()
    rng = np.random.default_rng(7)
    pts = np.concatenate([kp0, rng.uniform(-3, [W + 3, H + 3], (30, 2)),
                          np.array([[0.5, 0.5], [W - 0.5, H - 0.5], [10.5, 20.5], [W, H / 2]])])
    pts = pts.astype(np.float32)[None].repeat(2, 0)
    depth = np.stack([d0, d1])
    for interp in ("bilinear", "nearest"):
        got = tdepth.sample_depth(torch.from_numpy(pts), torch.from_numpy(depth), interp)
        want = jdepth.sample_depth(jnp.asarray(pts), jnp.asarray(depth), interp)
        close(got[1], want[1])
        close(got[0], want[0])
    assert 0 < np.asarray(want[1]).mean() < 1  # holes and valid points both


@pytest.mark.parametrize("ccth", [None, 4.0])
def test_project_and_reprojection(ccth):
    tcam, jcam, tp, jp, d0, d1, kp0, kp1 = _scene()
    D0, D1 = torch.from_numpy(d0[None]), torch.from_numpy(d1[None])
    dt, vt = tdepth.sample_depth(torch.from_numpy(kp0[None]), D0)
    dj, vj = jdepth.sample_depth(kp0[None], d0[None])
    got = tdepth.project(torch.from_numpy(kp0[None]), dt, D1, tcam, tcam, tp, vt, ccth=ccth)
    want = jdepth.project(kp0[None], dj, d1[None], jcam, jcam, jp, vj, ccth=ccth)
    close(got[1], want[1])
    close(got[0], want[0], tol=1e-4)  # pixels
    got = tdepth.symmetric_reprojection_error(torch.from_numpy(kp0[None]), torch.from_numpy(kp1[None]),
                                              tcam, tcam, tp, D0, D1)
    want = jdepth.symmetric_reprojection_error(kp0[None], kp1[None], jcam, jcam, jp, d0[None], d1[None])
    close(got[1], want[1])
    close(got[0], want[0], tol=1e-4)
    got = tdepth.dense_warp_consistency(D0, D1, tp, tcam, tcam, ccth=ccth)
    want = jdepth.dense_warp_consistency(d0[None], d1[None], jp, jcam, jcam, ccth=ccth)
    close(got[1], want[1])
    close(torch.where(got[1][..., None], got[0], 0), jnp.where(want[1][..., None], want[0], 0), tol=1e-3)


@pytest.mark.parametrize("epi_th,masked,cam", [(None, False, 3), (3.0, False, 1), (None, True, 4),
                                                (3.0, True, 1)])
def test_gt_matches_from_pose_depth(epi_th, masked, cam):
    tcam, jcam, tp, jp, d0, d1, kp0, kp1 = _scene(cam=COLMAP[cam])
    kw = {"pos_th": 3.0, "neg_th": 5.0, "epi_th": epi_th}
    if masked:
        m0, m1 = np.ones((1, len(kp0)), bool), np.ones((1, len(kp1)), bool)
        m0[0, -6:] = False
        m1[0, :5] = False
        kw_t = {**kw, "mask0": torch.from_numpy(m0), "mask1": torch.from_numpy(m1)}
        kw_j = {**kw, "mask0": jnp.asarray(m0), "mask1": jnp.asarray(m1)}
    else:
        kw_t = kw_j = kw
    got = tgt.gt_matches_from_pose_depth(torch.from_numpy(kp0[None]), torch.from_numpy(kp1[None]), tcam,
                                         tcam, tp, torch.from_numpy(d0[None]), torch.from_numpy(d1[None]), **kw_t)
    want = jgt.gt_matches_from_pose_depth(kp0[None], kp1[None], jcam, jcam, jp, d0[None], d1[None], **kw_j)
    assert set(got) == set(want)
    for k in got:
        close(got[k], want[k])
    m = np.asarray(want["matches0"])
    assert (m >= 0).sum() >= 10 and (m == -1).sum() >= 3 and (m == -2).sum() >= 1, np.unique(m, return_counts=True)


def test_ccth_gt():
    tcam, jcam, tp, jp, d0, d1, kp0, kp1 = _scene(seed=8)
    got = tgt.gt_matches_from_pose_depth(torch.from_numpy(kp0[None]), torch.from_numpy(kp1[None]), tcam,
                                         tcam, tp, torch.from_numpy(d0[None]), torch.from_numpy(d1[None]),
                                         ccth=9.0)
    want = jgt.gt_matches_from_pose_depth(kp0[None], kp1[None], jcam, jcam, jp, d0[None], d1[None], ccth=9.0)
    for k in got:
        close(got[k], want[k])


def test_wrappers_move_and_map():
    tc, _ = _camera_pair(COLMAP[1])
    tp, _ = _both_poses(9, 2)
    assert tc.to(torch.float64).f.dtype == torch.float64 and tc.device.type == "cpu"
    from gluefactory_tpu_torch.utils.tensor import map_tensor, rbd

    batch = rbd({"camera": tc.stack([tc, tc]), "T": tp, "x": torch.zeros(2, 3)})
    assert batch["camera"].shape == () and batch["T"].shape == () and batch["x"].shape == (3,)
    assert isinstance(map_tensor(tp, lambda x: x * 2), tw.Pose)
