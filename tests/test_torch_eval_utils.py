"""The eval slice's helpers against the JAX package on the CPU: the
per-pair metrics of `eval/utils.py`, the AUCs, the export (grouped against
per-item dispatch, and its cache against JAX's HDF5 one), the eval
pipeline's storage and drift checks, the config parsing and model loading
of `eval/io.py`, the benchmark registry, the pipeline's filter and solver,
and the trainer's benchmark hook.

Tolerances: the numpy metrics equal to JAX's (the same numpy arithmetic),
but the DLT error, whose float32 fit differs in rounding: within 1e-3 px on
planted matches; the exported arrays equal.
"""

import json
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from gluefactory_tpu.eval import io as jio
from gluefactory_tpu.eval import utils as J
from gluefactory_tpu.utils import export_predictions as jexport
from gluefactory_tpu.utils import tools as jtools
from gluefactory_tpu_torch.core.config import Config
from gluefactory_tpu_torch.eval import eval_pipeline, get_benchmark, io, run_benchmark
from gluefactory_tpu_torch.eval import utils as P
from gluefactory_tpu_torch.utils import export_predictions as pexport
from gluefactory_tpu_torch.utils import tools as ptools

HGT = np.array([[1.02, 0.03, 5.0], [-0.02, 0.98, -3.0], [1e-4, -5e-5, 1.0]])


def _pair(seed=0, n=60, n_out=15, size=(320, 240)):
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(0, size, (n, 2)).astype(np.float32)
    w = np.c_[k0, np.ones(n)] @ HGT.T
    k1 = (w[:, :2] / w[:, 2:] + rng.normal(0, 0.4, (n, 2))).astype(np.float32)
    k1[:n_out] = rng.uniform(0, size, (n_out, 2))
    perm = rng.permutation(n)
    m0 = np.argsort(perm).astype(np.int32)
    m0[rng.choice(n, 4, replace=False)] = -1
    scores = np.where(m0 >= 0, rng.uniform(0.1, 1, n), 0).astype(np.float32)
    scores[:n_out] *= 0.01
    pred = {"keypoints0": k0, "keypoints1": k1[perm], "matches0": m0, "matching_scores0": scores,
            "keypoint_mask0": np.r_[np.ones(n - 3, bool), np.zeros(3, bool)]}
    data = {"H_0to1": HGT.astype(np.float32),
            "view0": {"image_size": np.array(size, np.float32)}}
    return data, pred


def test_homography_helpers_equal_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 300, (2, 17, 2))
    for inverse in (False, True):
        np.testing.assert_array_equal(P.warp_points_np(pts, HGT, inverse), J.warp_points_np(pts, HGT, inverse))
    np.testing.assert_array_equal(P.sym_homography_error_np(pts[0], pts[1], HGT),
                                  J.sym_homography_error_np(pts[0], pts[1], HGT))
    H2 = HGT + rng.normal(0, 1e-3, (3, 3))
    assert P.homography_corner_error_np(H2, HGT, (320, 240)) == J.homography_corner_error_np(H2, HGT, (320, 240))
    data, pred = _pair()
    got = P.get_matches_scores(pred["keypoints0"], pred["keypoints1"], pred["matches0"], pred["matching_scores0"])
    want = J.get_matches_scores(pred["keypoints0"], pred["keypoints1"], pred["matches0"], pred["matching_scores0"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_metrics_equal_jax(seed):
    data, pred = _pair(seed)
    assert P.eval_matches_homography(data, pred) == J.eval_matches_homography(data, pred)
    none = {**pred, "matches0": np.full_like(pred["matches0"], -1)}
    assert P.eval_matches_homography(data, none) == J.eval_matches_homography(data, none)
    got, want = P.eval_homography_dlt(data, pred)["H_error_dlt"], J.eval_homography_dlt(data, pred)["H_error_dlt"]
    assert got < 5 and abs(got - want) <= 1e-3
    assert np.isnan(P.eval_homography_dlt(data, none)["H_error_dlt"])
    for est in ("opencv", "xla_ransac"):
        conf = {"estimator": est, "ransac_th": 2.0}
        got = P.eval_homography_robust(data, pred, {**conf, "device": "cpu"})
        want = J.eval_homography_robust(data, pred, conf)
        assert got.keys() == want.keys()
        assert got["ransac_inl"] == want["ransac_inl"] and got["ransac_inl%"] == want["ransac_inl%"]
        np.testing.assert_allclose(got["H_error_ransac"], want["H_error_ransac"], atol=1e-3)
        failed = P.eval_homography_robust(data, none, {**conf, "device": "cpu"})
        assert failed == J.eval_homography_robust(data, none, conf)


def test_pr_helpers_equal_jax():
    rng = np.random.default_rng(2)
    results = {"tp": [], "fp": [], "scores": [], "num_pos": 0}
    for _ in range(3):
        gt = rng.integers(-2, 20, 30)
        pm = np.where(rng.random(30) < 0.7, gt, rng.integers(-1, 20, 30))
        sc = rng.random(30)
        got, want = P.get_tp_fp_pts(pm, gt, sc), J.get_tp_fp_pts(pm, gt, sc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for k, v in zip(("tp", "fp", "scores"), got[:3]):
            results[k].append(v)
        results["num_pos"] += got[3]
    got, want = P.aggregate_pr_results(results), J.aggregate_pr_results(results)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tp, fp = np.cumsum(rng.random(20) < 0.6) / 20.0, np.cumsum(rng.random(20) < 0.4) / 20.0
    assert P.AP(tp, fp) == J.AP(tp, fp)


def test_aucs_and_eval_poses_equal_jax(capsys):
    rng = np.random.default_rng(3)
    errs = np.r_[rng.exponential(3, 40), np.inf, np.nan, 0.0]
    for ths in ([1, 3, 5], [5, 10, 20], [2]):
        assert ptools.cal_error_auc(errs[np.isfinite(errs)], ths) == jtools.cal_error_auc(errs[np.isfinite(errs)], ths)
        assert ptools.AUCMetric(ths, errs).compute() == jtools.AUCMetric(ths, errs).compute()
    assert ptools.cal_error_auc([], [1, 2]) == [0.0, 0.0]
    assert np.isnan(ptools.AUCMetric([1], [np.nan]).compute())
    m = ptools.AUCMetric(3)
    m.update(torch.tensor([0.5, 7.0]))
    assert m.compute() == jtools.AUCMetric(3, [0.5, 7.0]).compute()
    pose_results = {th: {"H_error_ransac": list(rng.exponential(th * 2, 12)) + [np.inf],
                         "ransac_inl": list(rng.integers(0, 50, 13))} for th in (0.5, 1.0, 2.0)}
    got = P.eval_poses(pose_results, [1, 3, 5], "H_error_ransac", "px")
    out_p = capsys.readouterr().out
    want = J.eval_poses(pose_results, [1, 3, 5], "H_error_ransac", "px")
    assert got == want and out_p == capsys.readouterr().out


class _Loader:

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


HEIGHTS = (32, 24, 24, 32, 32, 24, 32)


def _items(n=7, seed=0):
    """Items of two image heights, one name repeated."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        h = HEIGHTS[i]
        view = lambda: {"image": rng.random((h, 40, 1)).astype(np.float32),
                        "scales": np.array([0.5, 0.25], np.float32)}
        items.append({"view0": view(), "view1": view(), "idx": np.int64(i),
                      "name": f"seq/{min(i, 5)}.ppm"})
    return items


def _batches(items, sizes=(1, 2, 2, 1, 1), to=torch.from_numpy):
    """Loader batches of consecutive items of one height, as tensors (the
    port's loader) or numpy arrays (`to=np.asarray`, the JAX package's)."""
    out, k = [], 0
    for s in sizes:
        group = items[k:k + s]
        k += s
        out.append({"view0": {key: to(np.stack([g["view0"][key] for g in group]))
                              for key in ("image", "scales")},
                    "view1": {key: to(np.stack([g["view1"][key] for g in group]))
                              for key in ("image", "scales")},
                    "idx": to(np.array([int(g["idx"]) for g in group])),
                    "name": [g["name"] for g in group]})
    return out


def _apply(batch):
    """A stand-in model: per-item outputs from the images, 6 keypoint slots
    of which the last `idx % 3` are masked, matches that cross the masks."""
    img0, img1 = np.asarray(batch["view0"]["image"]), np.asarray(batch["view1"]["image"])
    B = img0.shape[0]
    idx = np.asarray(batch["idx"])
    kp = np.stack([np.stack([img0[b, :6, 0, 0] * 40, img1[b, :6, 1, 0] * 24], -1) for b in range(B)])
    mask = np.arange(6)[None] < (6 - idx[:, None] % 3)
    m = np.tile(np.array([5, -1, 0, 2, 3, 1], np.int64), (B, 1))
    return {"keypoints0": kp.astype(np.float32), "keypoints1": kp[:, ::-1].astype(np.float32),
            "keypoint_mask0": mask, "keypoint_mask1": mask[:, ::-1].copy(),
            "matches0": m, "matches1": m[:, ::-1].copy(),
            "matching_scores0": img0[:, :6, 2, 0], "descriptors0": img0[:, :6, :3, 0]}


def _npz_items(path):
    with np.load(path) as npz:
        keys = pexport.prediction_keys(npz)
        return {name: pexport.load_prediction(npz, keys, name) for name in keys}


@pytest.mark.parametrize("ipd", [None, 1, 2, 3])
def test_export_equals_jax_and_per_item(tmp_path, ipd):
    items = _items()
    keys = ["keypoints0", "keypoints1", "matches0", "matches1", "matching_scores0", "keypoint_mask0",
            "keypoint_mask1"]
    calls = []

    def apply(batch):
        calls.append(np.asarray(batch["idx"]).tolist())
        return _apply(batch)

    pexport.export_predictions(_Loader(_batches(items)), apply, tmp_path / "p.npz", keys=keys,
                               items_per_dispatch=ipd)
    jexport.export_predictions(_Loader(_batches(items, to=np.asarray)), _apply, tmp_path / "j.h5", keys=keys,
                               items_per_dispatch=ipd)
    got = _npz_items(tmp_path / "p.npz")
    with h5py.File(tmp_path / "j.h5") as hfile:
        names = []
        hfile.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Group) and
                         any(isinstance(v, h5py.Dataset) for v in o.values()) else None)
        want = {n: {k: hfile[n][k][()] for k in hfile[n]} for n in names}
    assert got.keys() == want.keys() and len(got) == 7  # the repeated name got a suffix
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k], err_msg=f"{name}/{k}")
    per_item = tmp_path / "one.npz"
    pexport.export_predictions(_Loader(_batches(items, (1,) * 7)), _apply, per_item, keys=keys,
                               items_per_dispatch=None)
    ref = _npz_items(per_item)
    for name in ref:
        if name.startswith("seq/5.ppm"):  # the repeated name: its suffix follows the write order
            continue
        for k in ref[name]:
            np.testing.assert_array_equal(got[name][k], ref[name][k])
    if ipd:
        assert all(len(c) == ipd for c in calls)  # trailing buckets padded to the group size
        flat = [i for c in calls for i in c]
        assert sorted(set(flat)) == list(range(7))


def test_export_options(tmp_path):
    items = _items(3)
    calls = []

    def cb(pred, item):
        calls.append(item["name"])
        return {"extra": np.array([len(calls)]), "keypoints0": np.zeros(1)}

    pexport.export_predictions(_Loader(_batches(items, (1, 2))), _apply, tmp_path / "p.npz",
                               as_half=True, callback_fn=cb, trim_masks=False)
    got = _npz_items(tmp_path / "p.npz")
    assert calls == [it["name"] for it in items]
    first = got["seq/0.ppm"]
    assert first["keypoints0"].dtype == np.float16 and first["keypoints0"].shape == (6, 2)  # model wins
    assert first["extra"].tolist() == [1] and "keypoint_mask0" in first
    assert first["matches0"].dtype == np.int64


def test_trim_masked_and_unscale_equal_jax():
    pred = {k: v[1] for k, v in _apply({"view0": {"image": np.random.default_rng(0).random((2, 8, 3, 1))},
                                         "view1": {"image": np.random.default_rng(1).random((2, 8, 3, 1))},
                                         "idx": np.array([4, 5])}).items()}
    got, want = pexport.trim_masked(pred), jexport.trim_masked(pred)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    data = {"view0": {"scales": np.array([0.5, 2.0])}, "view1": {"scales": np.array([2.0, 0.5])}}
    for k, v in pexport.unscale_keypoints(got, data).items():
        np.testing.assert_array_equal(v, jexport.unscale_keypoints(want, data)[k])


def test_eval_storage_and_drift(tmp_path):
    results = {"H_error_dlt": [1.0, np.nan, 3.0], "names": ["a/2.ppm", "a/3.ppm", "b/2.ppm"],
               "ransac_inl": [4, 5, 6]}
    summaries = {"mH_error_dlt": np.float64(2.0), "H_error_dlt@1px": 0.25}
    assert not eval_pipeline.exists_eval(tmp_path)
    eval_pipeline.save_eval(tmp_path, summaries, {}, results)
    assert eval_pipeline.exists_eval(tmp_path)
    s, r = eval_pipeline.load_eval(tmp_path)
    assert s == {"mH_error_dlt": 2.0, "H_error_dlt@1px": 0.25}
    assert r["names"].tolist() == results["names"] and r["ransac_inl"].tolist() == [4, 5, 6]
    np.testing.assert_array_equal(r["H_error_dlt"], results["H_error_dlt"])

    class Pipe(eval_pipeline.EvalPipeline):
        default_conf = {"model": {"a": 1}, "eval": {"b": 2}}

    Pipe({}).save_conf(tmp_path)
    Pipe({}).save_conf(tmp_path)
    with pytest.raises(ValueError, match="overwrite_eval"):
        Pipe({"eval": {"b": 3}}).save_conf(tmp_path)
    Pipe({"eval": {"b": 3}}).save_conf(tmp_path, overwrite_eval=True)
    with pytest.raises(ValueError, match="--overwrite"):
        Pipe({"model": {"a": 2}, "eval": {"b": 3}}).save_conf(tmp_path, overwrite_eval=True)
    Pipe({"model": {"a": 2}}).save_conf(tmp_path, overwrite=True)
    assert Pipe({}).device == "cuda"


def test_config_parsing_equals_jax(monkeypatch, tmp_path):
    from gluefactory_tpu.core.config import from_yaml as jfrom_yaml

    path = io.parse_config_path("superpoint+lightglue-official")
    assert path.parent.name == "configs" and path.parent.parent.name == "gluefactory_tpu_torch"
    jpath = jio.parse_config_path("superpoint+lightglue-official")
    assert jfrom_yaml(str(jpath)).to_dict() == io.from_yaml(str(path)).to_dict()
    assert io.parse_config_path(str(path)) == path
    with pytest.raises(ValueError, match="Cannot find"):
        io.parse_config_path("no-such-config")
    from gluefactory_tpu.eval.hpatches import HPatchesPipeline as JP
    from gluefactory_tpu_torch.eval.hpatches import HPatchesPipeline as TP

    for argv in (["--conf", "superpoint+lightglue-official", "eval.ransac_th=1.0"],
                 ["--conf", "superpoint+lightglue-official", "--tag", "x", "model.extractor.max_num_keypoints=16"],
                 ["model.name=two_view_pipeline"]):
        jargs = jio.get_eval_parser().parse_intermixed_args(argv)
        targs = io.get_eval_parser().parse_intermixed_args(argv)
        assert targs.device == "cuda"
        jname, jconf = jio.parse_eval_args("hpatches", jargs, "configs/", JP.default_conf)
        tname, tconf = io.parse_eval_args("hpatches", targs, "configs/", TP.default_conf)
        assert tname == jname and tconf.to_dict() == jconf.to_dict()
    # a training run's model section comes under the conf and the CLI
    import gluefactory_tpu_torch.eval.io as tio

    run = tmp_path / "run"
    run.mkdir()
    (run / "config.yaml").write_text("model:\n  name: two_view_pipeline\n  extractor:\n    name: superpoint\n")
    monkeypatch.setattr(tio, "TRAINING_PATH", tmp_path)
    args = io.get_eval_parser().parse_intermixed_args(["--checkpoint", "run", "model.extractor.nms_radius=2"])
    _, conf = io.parse_eval_args("hpatches", args, "configs/")
    assert conf.model.extractor.name == "superpoint" and conf.model.extractor.nms_radius == 2
    assert conf.checkpoint == "run"


SMALL = {"name": "two_view_pipeline",
         "extractor": {"name": "superpoint", "max_num_keypoints": 16, "detection_threshold": 0.0},
         "matcher": {"name": "lightglue", "n_layers": 1, "descriptor_dim": 32, "num_heads": 2}}


def test_load_model_and_apply_fn(tmp_path):
    torch.manual_seed(0)
    ref = io.load_model(Config(SMALL), None, device="cpu")
    torch.save(ref.state_dict(), tmp_path / "all.pth")
    torch.save(ref.matcher.state_dict(), tmp_path / "lg.pth")
    torch.manual_seed(1)
    m = io.load_model(Config({**SMALL, "weights_file": str(tmp_path / "all.pth")}), None, device="cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(m.state_dict()[k], v), k
    torch.manual_seed(1)
    m = io.load_model(Config({**SMALL, "matcher": {**SMALL["matcher"], "weights_file": str(tmp_path / "lg.pth")}}),
                      None, device="cpu")
    assert all(torch.equal(m.matcher.state_dict()[k], v) for k, v in ref.matcher.state_dict().items())
    assert not torch.equal(m.extractor.state_dict()["conv1a.weight"], ref.extractor.state_dict()["conv1a.weight"])
    with pytest.raises(ValueError, match="msgpack"):
        io.load_model(Config({**SMALL, "weights_file": "w.msgpack"}), None, device="cpu")
    rng = np.random.default_rng(0)
    view = {"image": rng.random((1, 48, 64, 1)).astype(np.float32),
            "image_size": np.array([[64, 48]], np.float32)}
    pred = io.make_apply_fn(m, "cpu")({"view0": view, "view1": dict(view), "name": ["a"]})
    assert all(isinstance(v, np.ndarray) for v in pred.values())
    assert pred["keypoints0"].shape == (1, 16, 2) and pred["matches0"].shape == (1, 16)


def test_load_model_from_a_training_run(tmp_path, monkeypatch):
    import gluefactory_tpu_torch.utils.experiments as ex

    monkeypatch.setattr(ex, "TRAINING_PATH", tmp_path)
    torch.manual_seed(0)
    ref = io.load_model(Config(SMALL), None, device="cpu")
    run = tmp_path / "run"
    run.mkdir()
    ex.save_checkpoint({"model": ref.state_dict()}, Config({"model": SMALL}), {"loss/total": 1.0},
                       run, 0, 3)
    ex.update_best_checkpoint(run / "checkpoint_0_3.tar", {"loss/total": 1.0}, "loss/total", None)
    m = io.load_model(Config({"extractor": {"max_num_keypoints": 8}}), "run", device="cpu")
    assert m.conf.extractor.max_num_keypoints == 8  # the caller's conf over the run's
    for k, v in ref.state_dict().items():
        assert torch.equal(m.state_dict()[k], v), k


def test_benchmark_registry():
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_tpu_torch.eval.eth3d import ETH3DPipeline
    from gluefactory_tpu_torch.eval.megadepth1500 import MegaDepth1500Pipeline
    from gluefactory_tpu_torch.eval.scannet1500 import ScanNet1500Pipeline
    from gluefactory_tpu_torch.eval.zeb import ZEBPipeline

    assert get_benchmark("hpatches") is HPatchesPipeline
    assert get_benchmark("megadepth1500") is MegaDepth1500Pipeline
    assert get_benchmark("scannet1500") is ScanNet1500Pipeline
    assert get_benchmark("eth3d") is ETH3DPipeline
    assert get_benchmark("zeb") is ZEBPipeline
    train.check_supported(train.merge(Config(train.default_conf),
                                      {"train": {"run_benchmarks": ["eth3d", "zeb"]}}),
                          train.main_args(["x"]))
    with pytest.raises(ValueError):
        get_benchmark("nope")


def test_pipeline_runs_filter_and_solver(tmp_path, monkeypatch):
    """The filter and the solver run after the matcher, each on the
    predictions merged so far."""
    (tmp_path / "dummy_filter.py").write_text('''
import torch
from gluefactory_tpu_torch.models.base_model import BaseModel


class Filter(BaseModel):
    default_conf = {"keep": 3}
    required_data_keys = ["matches0"]

    def _init(self, conf):
        pass

    def _forward(self, data, train=False):
        m = data["matches0"].clone()
        m[:, self.conf.keep:] = -1
        return {"matches0": m, "filtered": torch.ones(1)}
''')
    (tmp_path / "dummy_solver.py").write_text('''
from gluefactory_tpu_torch.models.base_model import BaseModel


class Solver(BaseModel):
    required_data_keys = ["matches0", "filtered"]

    def _init(self, conf):
        pass

    def _forward(self, data, train=False):
        return {"n_kept": (data["matches0"] >= 0).sum(1)}
''')
    monkeypatch.syspath_prepend(str(tmp_path))
    conf = {**SMALL, "filter": {"name": "dummy_filter", "keep": 2}, "solver": {"name": "dummy_solver"}}
    model = io.load_model(Config(conf), None, device="cpu")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((1, 48, 64, 1)).astype(np.float32))
    view = {"image": img, "image_size": torch.tensor([[64.0, 48.0]])}
    with torch.no_grad():
        pred = model({"view0": view, "view1": {"image": img.clone(), "image_size": view["image_size"]}})
    assert (pred["matches0"][:, 2:] == -1).all()
    assert pred["n_kept"].tolist() == [int((pred["matches0"] >= 0).sum())]


def test_trainer_benchmark_hook(tmp_path, monkeypatch):
    """`run_benchmarks`: the benchmark on the model in memory into
    `<output_dir>/benchmarks/<name>`, its scalars to the writer; a failing
    one is logged and training goes on; only hpatches passes the check."""
    sys.path.insert(0, str(Path(__file__).parent))
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch import train
    from test_torch_eval_hpatches import DATA, write_sequence

    write_sequence(tmp_path / "hpatches-sequences-release")
    monkeypatch.setattr(tsettings, "DATA_PATH", tmp_path)
    conf = Config({"train": {"run_benchmarks": ["hpatches"], "benchmark_conf": {"hpatches": {
        "data": DATA, "eval": {"estimator": "xla_ransac", "ransac_th": 3.0}}}}})
    torch.manual_seed(0)
    model = io.load_model(Config(SMALL), None, device="cpu")

    class Writer:
        def __init__(self):
            self.scalars = {}

        def add_scalar(self, k, v, it):
            self.scalars[k] = (v, it)

    writer = Writer()
    train.run_benchmark_hook("hpatches", conf, model, tmp_path / "out", "cpu", writer, 7)
    out = tmp_path / "out" / "benchmarks" / "hpatches"
    s = json.loads((out / "summaries.json").read_text())
    assert (out / "predictions.npz").exists()
    assert writer.scalars["benchmark/hpatches/mnum_matches"] == (s["mnum_matches"], 7)
    s2, _, _ = run_benchmark("hpatches", conf.train.benchmark_conf.hpatches, tmp_path / "direct",
                             model=model, device="cpu")
    assert s2 == s
    monkeypatch.setattr(tsettings, "DATA_PATH", tmp_path / "nowhere")
    train.run_benchmark_hook("hpatches", conf, model, tmp_path / "out2", "cpu", writer, 8)
    assert not (tmp_path / "out2" / "benchmarks" / "hpatches" / "summaries.json").exists()
    train.check_supported(train.merge(Config(train.default_conf), conf), train.main_args(["x"]))
