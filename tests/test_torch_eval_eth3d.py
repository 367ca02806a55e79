"""The port's ETH3D benchmark against the JAX package's on the CPU, on two
procedural scenes in ETH3D's undistorted DSLR layout
(`scripts_dev/posed_scenes.write_eth3d_scene`: 3 views at 320 x 240 with
Gaussian noise of 0.05, so that SuperPoint's top-k meets no tie between
equal scores, whose order the packages break differently; downsize factor
2, 16-bit PNG depths at 160 x 120, COLMAP calibration with the
observations of 1500 points on the planes).

- The dataset's items bit-equal to JAX's `ETH3DDataset` (cv2 reads the
  images and depths there, Pillow here), pairs by covisibility, and the
  COLMAP quaternion parse.
- The whole pipeline (the export with `depth_matcher` in the forward, then
  the PR eval loop) with SuperPoint (64 keypoints) and a 2-layer LightGlue
  or the nearest-neighbour matcher, the same random weights in both
  packages (`test_torch_eval_hpatches.random_models`): the cached
  keypoints, matches and GT matches equal, the scores within 1e-6, the AP
  within 1e-6 relative.
- `main` by config name (`superpoint+NN`) on the CPU, its files and an
  `--overwrite_eval` rerun that reads the cache; `superpoint+lsd+gluestick`
  by name with `eval.eval_lines` (its line AP against JAX's:
  `test_torch_gluestick_eval.py`).
"""

import json

import h5py
import numpy as np
import pytest
import torch

from gluefactory_tpu.data import eth3d as jax_eth3d
from gluefactory_tpu.eval import eth3d as jax_eval
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.data import eth3d
from gluefactory_tpu_torch.eval import eth3d as port_eval
from gluefactory_tpu_torch.eval import eval_pipeline
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.scripts_dev.posed_scenes import rotmat2qvec, write_eth3d_scene
from gluefactory_tpu_torch.utils.export_predictions import load_predictions
from test_torch_eval_hpatches import MODEL, random_models

SCENES = ("courtyard", "pipes")
DATA = {"downsize_factor": 2, "min_covisibility": 50, "num_workers": 0}
GT = {"run_gt_in_forward": True,
      "ground_truth": {"name": "depth_matcher", "use_points": True, "use_lines": False,
                       "th_positive": 3.0, "th_negative": 5.0}}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("eth3d")
    written = {s: write_eth3d_scene(root / "ETH3D_undistorted", s, n_views=3, size=(320, 240),
                                    downsize_factor=2, n_points=1500, seed=k)
               for k, s in enumerate(SCENES)}
    return root, written


@pytest.fixture()
def data_path(layout, monkeypatch):
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings

    for mod in (jax_eth3d, jsettings, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", layout[0])
    return layout[0]


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def test_qvec_round_trip():
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.normal(size=4)
        q = q / np.linalg.norm(q) * np.sign(q[0])
        R = jax_eth3d.qvec2rotmat(q).astype(np.float64)
        np.testing.assert_allclose(rotmat2qvec(R), q, atol=1e-6)
        np.testing.assert_array_equal(eth3d.qvec2rotmat(q), jax_eth3d.qvec2rotmat(q))


def test_items_equal_jax(data_path, layout):
    port = eth3d.ETH3DDataset(DATA).get_dataset("test")
    ref = jax_eth3d.ETH3DDataset(DATA).get_dataset("test")
    assert len(port) == len(ref) == 6  # 3 pairs a scene, every pair covisible
    for i in range(len(ref)):
        _assert_tree_equal(port[i], ref[i])
    item = port[0]
    assert item["view0"]["image"].shape == (120, 160, 1)
    assert item["view0"]["depth"].shape == (120, 160) and (item["view0"]["depth"] > 0).mean() > 0.9
    covis = layout[1][SCENES[0]]["covisible"]
    assert item["n_covisible_points"] == covis[(item["view0"]["name"] + ".JPG",
                                                item["view1"]["name"] + ".JPG")]
    high = eth3d.ETH3DDataset({**DATA, "min_covisibility": 10**6}).get_dataset("test")
    assert len(high) == 0


def _models(matcher: str):
    """(JAX pipeline, its variables, the port's pipeline) with ETH3D's GT
    in the forward and the same random weights."""
    pj, params, pt = random_models()
    if matcher == "lightglue":
        conf = {"extractor": MODEL["extractor"], "matcher": {**MODEL["matcher"], "checkpointed": False},
                **GT}
        variables = params
    else:
        conf = {"extractor": MODEL["extractor"], "matcher": {"name": "nearest_neighbor_matcher"}, **GT}
        variables = {"params": {"extractor_model": params["params"]["extractor_model"]}}
    pj = jax_get_model("two_view_pipeline").from_conf(conf)
    port = get_model("two_view_pipeline").from_conf(conf, device="cpu")
    port.load_state_dict({k: v for k, v in pt.state_dict().items()
                          if matcher == "lightglue" or k.startswith("extractor.")})
    return pj, variables, port.eval()


@pytest.mark.parametrize("matcher", ["lightglue", "nearest_neighbor_matcher"])
def test_pipeline_equals_jax(data_path, matcher):
    conf = {"data": DATA, "model": {**MODEL, "matcher": {"name": matcher}}}
    pj, variables, pt = _models(matcher)
    sj, _, rj = jax_eval.ETH3DPipeline(conf).run(data_path / "jax" / matcher, model=pj,
                                                  variables=variables, overwrite=True,
                                                  overwrite_eval=True)
    st, _, rt = port_eval.ETH3DPipeline(conf, device="cpu").run(
        data_path / "port" / matcher, model=pt, overwrite=True, overwrite_eval=True)
    cache = load_predictions(data_path / "port" / matcher / "predictions.h5")
    with h5py.File(data_path / "jax" / matcher / "predictions.h5") as hfile:
        names = set(cache)
        assert names == set(hfile.keys()) and len(names) == 6
        positives = 0
        for name in names:
            assert set(cache[name]) == set(port_eval.ETH3DPipeline.export_keys)
            for k in port_eval.ETH3DPipeline.export_keys:
                got, want = cache[name][k], hfile[name][k][()]
                if k.startswith(("keypoints", "matches", "gt_")):
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:
                    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=k)
            positives += int((cache[name]["gt_matches0"] >= 0).sum())
        assert positives >= 20  # the depth GT finds correspondences
    assert set(st) == set(sj) == {"AP"}
    np.testing.assert_allclose(st["AP"], sj["AP"], rtol=1e-6)
    for k in ("curve_recall", "curve_precision"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-6, err_msg=k)
    assert 0 <= st["AP"] <= 100 and (matcher != "nearest_neighbor_matcher" or st["AP"] > 0)


def test_cli_by_name_on_cpu(data_path, monkeypatch):
    from gluefactory_tpu_torch.eval import megadepth1500

    monkeypatch.setattr(megadepth1500, "EVAL_PATH", data_path / "results")
    argv = ["--conf", "superpoint+NN", "--device", "cpu", "--tag", "t", "data.num_workers=0",
            "data.downsize_factor=2", "data.min_covisibility=50", "model.extractor.max_num_keypoints=64"]
    torch.manual_seed(0)
    s, _, r = port_eval.main(argv)
    out = data_path / "results" / "eth3d" / "t"
    for f in ("predictions.h5", "results.h5", "summaries.json", "conf.yaml"):
        assert (out / f).exists(), f
    assert json.loads((out / "summaries.json").read_text()) == s and np.isfinite(s["AP"])
    mtime = (out / "predictions.h5").stat().st_mtime_ns

    def no_model(*a, **k):
        raise AssertionError("the cache was not read")

    load_model = eval_pipeline.load_model

    monkeypatch.setattr(eval_pipeline, "load_model", no_model)
    s2, _, _ = port_eval.main(argv + ["--overwrite_eval"])
    assert s2 == s and (out / "predictions.h5").stat().st_mtime_ns == mtime
    # eval_lines (which raised before the line models were ported): GlueStick's
    # config by name, its line GT in the forward, the line AP from the cache
    monkeypatch.setattr(eval_pipeline, "load_model", load_model)
    argv = ["--conf", "superpoint+lsd+gluestick", "--device", "cpu", "--tag", "g",
            "data.num_workers=0", "data.downsize_factor=2", "data.min_covisibility=50",
            "model.extractor.point_extractor.max_num_keypoints=64",
            "model.extractor.max_num_lines=32", "model.matcher.n_layers=1",
            "model.matcher.filter_threshold=0.0", "model.extractor.min_length=10"]
    torch.manual_seed(0)
    s, _, r = port_eval.main(argv)
    assert set(s) == {"AP", "AP_lines"} and np.isfinite(s["AP_lines"]), s
    loader = port_eval.ETH3DPipeline.get_dataloader({**DATA, "name": "eth3d"})
    pred_file = data_path / "results" / "eth3d" / "g" / "predictions.h5"
    again = port_eval.eval_dataset(loader, pred_file, suffix="_lines")
    assert again["AP_lines"] == s["AP_lines"] and len(r["curve_recall_lines"]) > 0
    # the line GT found correspondences
    assert sum(int((item["gt_line_matches0"] >= 0).sum()) for item in load_predictions(pred_file).values())
