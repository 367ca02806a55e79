"""The port's ZEB benchmark against the JAX package's on the CPU, on two
procedural ZEB scenes (`scripts_dev/posed_scenes.write_zeb_scene`: 5
views at 160 x 120 with Gaussian noise of 0.05, so that SuperPoint's
top-k meets no tie; 6 pair files each, both overlaps, K0, K1 and the
relative pose).

- The dataset's items bit-equal to JAX's `ZEBPairs` under the scene list
  (as a list and as a file), `exclude_scenes`, the overlap filter,
  `max_per_scene`, `shuffle` and `check`.
- The item's `overlap` is JAX's value, min(overlap1, K0[0, 0]), where the
  filter reads min(overlap0, overlap1): the two disagree (ROADMAP queue 3).
- The whole pipeline (ScanNet-1500's loops) with SuperPoint (64
  keypoints) and a 2-layer LightGlue, the same random weights in both
  packages, estimator `opencv` at two thresholds: the cached keypoints and
  matches equal, the scores within 1e-6, every per-pair metric and summary
  within 1e-6.
- `main` by config name (`superpoint+superglue-official`) on the CPU with
  `xla_ransac`, its files and an `--overwrite_eval` rerun on the cache.
"""

import json

import h5py
import numpy as np
import pytest
import torch

from gluefactory_tpu.data import zeb as jax_zeb_data
from gluefactory_tpu.eval import zeb as jax_zeb
from gluefactory_tpu_torch.data import zeb as zeb_data
from gluefactory_tpu_torch.eval import eval_pipeline, megadepth1500, zeb
from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_zeb_scene
from gluefactory_tpu_torch.utils.export_predictions import load_predictions
from test_torch_eval_hpatches import MODEL, _assert_summaries_close, random_models
from test_torch_eval_megadepth1500 import _assert_results_close
from test_torch_eval_posed import assert_items_equal

SCENES = ("gl3d", "kitti", "scenenet")
PAIRS_PER_SCENE = 6
DATA = {"num_workers": 0, "preprocessing": {"resize": 160, "side": "long"}}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("zeb")
    for k, scene in enumerate(SCENES):
        write_zeb_scene(root / "zeb", scene, n_views=4, n_pairs=PAIRS_PER_SCENE, size=(160, 120),
                        seed=k)
    (root / "zeb" / "two.txt").write_text("gl3d\nkitti\n")
    return root


@pytest.fixture()
def data_path(layout, monkeypatch):
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings

    for mod in (jax_zeb_data, jsettings, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", layout)
    return layout


CONFS = {
    "all": {},
    "scene_list": {"scene_list": ["kitti", "gl3d"]},
    "scene_list_file": {"scene_list": "two.txt", "check": True},
    "exclude": {"exclude_scenes": ["kitti"]},
    "overlap": {"min_overlap": 0.7, "max_overlap": 0.85},
    "max_per_scene": {"max_per_scene": 4},
    "shuffle": {"shuffle": True, "seed": 3, "max_per_scene": 5},
}


@pytest.mark.parametrize("case", sorted(CONFS))
def test_items_equal_jax(data_path, case):
    conf = {**DATA, **CONFS[case]}
    port = zeb_data.ZEBPairs(conf)
    ref = jax_zeb_data.ZEBPairs(conf)
    assert [str(p) for p in port.items] == [str(p) for p in ref.items]
    assert len(port.items) > 0
    ds_p, ds_j = port.get_dataset("test"), ref.get_dataset("test")
    for i in range(len(ds_j)):
        assert_items_equal(ds_p[i], ds_j[i])
    if case == "all":
        assert len(ds_p) == len(SCENES) * PAIRS_PER_SCENE
    if case == "overlap":
        assert 0 < len(ds_p) < len(SCENES) * PAIRS_PER_SCENE  # the filter drops some


def test_overlap_is_jax_value_not_the_filters(data_path):
    """`overlap` of an item comes from the line's fields 3-4 after the names
    (overlap1 and K0[0, 0]) where the filter reads fields 2-3 (overlap0 and
    overlap1): the JAX package's slicing, kept."""
    ds = zeb_data.ZEBPairs(DATA).get_dataset("test")
    differ = 0
    for i in range(len(ds)):
        fields = zeb_data.read_pair_data(ds.parent.items[i])
        ov0, ov1, fx0 = float(fields[2]), float(fields[3]), float(fields[4])
        item = ds[i]
        assert item["overlap"] == min(ov1, fx0)
        assert item["overlap"] == jax_zeb_data.ZEBPairs(DATA).get_dataset("test")[i]["overlap"]
        differ += item["overlap"] != min(ov0, ov1)
    assert differ > 0


def test_pipeline_equals_jax(data_path, capsys):
    from test_torch_eval_hpatches import _best_threshold

    conf = {"data": DATA, "model": MODEL, "eval": {"estimator": "opencv", "ransac_th": [1.0, 2.0]}}
    pj, params, pt = random_models()
    sj, _, rj = jax_zeb.ZEBPipeline(conf).run(data_path / "jax", model=pj, variables=params,
                                              overwrite=True, overwrite_eval=True)
    th_jax = _best_threshold(capsys.readouterr().out)
    st, _, rt = zeb.ZEBPipeline(conf, device="cpu").run(data_path / "port", model=pt,
                                                        overwrite=True, overwrite_eval=True)
    assert _best_threshold(capsys.readouterr().out) == th_jax
    cache = load_predictions(data_path / "port" / "predictions.h5")
    with h5py.File(data_path / "jax" / "predictions.h5") as hfile:
        assert len(cache) == len(SCENES) * PAIRS_PER_SCENE
        for name in cache:
            for k in zeb.ZEBPipeline.export_keys:
                got, want = cache[name][k], hfile[name][k][()]
                if k.startswith(("keypoints", "matches")):
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:
                    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=k)
    _assert_summaries_close(st, sj, rtol=1e-6)
    _assert_results_close(rt, rj, ["epi_prec@1e-4", "epi_prec@5e-4", "epi_prec@1e-3", "num_matches",
                                   "num_keypoints", "rel_pose_error", "ransac_inl", "ransac_inl%"])
    assert (rt["num_matches"] >= 5).sum() >= 3


def test_cli_by_name_on_cpu(data_path, monkeypatch):
    monkeypatch.setattr(megadepth1500, "EVAL_PATH", data_path / "results")
    argv = ["--conf", "superpoint+superglue-official", "--device", "cpu", "--tag", "t",
            "eval.estimator=xla_ransac", "data.num_workers=0", "data.preprocessing.resize=100",
            "model.extractor.max_num_keypoints=64", "model.matcher.n_layers=2",
            "model.matcher.sinkhorn_iterations=10", "data.scene_list=[gl3d]"]
    torch.manual_seed(0)
    s, _, r = zeb.main(argv)
    out = data_path / "results" / "zeb" / "t"
    for f in ("predictions.h5", "results.npz", "summaries.json", "conf.yaml"):
        assert (out / f).exists(), f
    assert json.loads((out / "summaries.json").read_text()) == s
    assert all(np.isfinite(s[k]) for k in ("rel_pose_error@5°", "rel_pose_error@20°",
                                           "rel_pose_error_mAA"))
    assert len(r["rel_pose_error"]) == PAIRS_PER_SCENE
    mtime = (out / "predictions.h5").stat().st_mtime_ns

    def no_model(*a, **k):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(eval_pipeline, "load_model", no_model)
    s2, _, _ = zeb.main(argv + ["--overwrite_eval"])
    assert s2 == s and (out / "predictions.h5").stat().st_mtime_ns == mtime
