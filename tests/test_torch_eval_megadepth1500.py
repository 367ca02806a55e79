"""The port's MegaDepth-1500 and ScanNet-1500 benchmarks against the JAX
package's on the CPU, on the procedural layouts of
`tests/test_torch_eval_posed.py` (5 posed pairs at 160 x 120 with 16-bit
PNG depths, 3 calibrated pairs).

- The whole pipeline (export, then the eval loop) with SuperPoint and a
  2-layer LightGlue at 64 keypoints and the same random weights, drawn in
  the port's layout as flax draws them and carried across by
  `from_jax_params`, as `tests/test_torch_eval_hpatches.py` does; every
  row's and column's best assignment entry leads its second by at least
  1e-4 (so float32 rounding cannot flip a match). The estimator is
  `opencv`, which both packages call on the same float32 points: the
  cached keypoints and matches equal, every per-pair metric and summary
  within 1e-6, the same best threshold.
- The eval loop alone on a planted cache (matches projected through the
  GT depth and pose within 0.1 px, a fifth of them outliers), so that the
  poses are far from random. With `opencv`, thresholds 0.5 and 2.0: every
  per-pair metric and summary within 1e-6 of JAX's and the same best
  threshold. With `xla_ransac` on the CPU, at 1.0: the match metrics within
  1e-6 and the inlier counts equal; the pose errors within 0.05 degrees (measured 0.014 and
  0.035: the minimal solver's candidates come from another nullspace
  basis, `tests/test_torch_essential.py`, and the errors are float32
  arccos of a trace, which resolves ~0.02 degrees near 0); the AUCs within
  1e-3 (measured 6e-4).
- `main` on the official config at a cut width (64 keypoints, 2 layers,
  100 px): the files, a rerun with `--overwrite_eval` that reads the
  cache, and the refusal without a card. ScanNet-1500 the same, each test
  parametrised over both benchmarks.
"""

import json

import h5py
import numpy as np
import pytest
import torch

from gluefactory_tpu.eval import megadepth1500 as jax_md
from gluefactory_tpu.eval import scannet1500 as jax_sn
from gluefactory_tpu_torch.data.base_dataset import prepare_batch
from gluefactory_tpu_torch.eval import eval_pipeline, megadepth1500, scannet1500
from gluefactory_tpu_torch.geometry.depth import project, sample_depth
from gluefactory_tpu_torch.utils.export_predictions import PredictionWriter, load_predictions
from gluefactory_tpu_torch.utils.tensor import rbd
from test_torch_eval_hpatches import MODEL, _assert_summaries_close, _best_threshold, random_models
from test_torch_eval_posed import MD_CONF, PAIRS_CONF, write_layouts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file's tests and fixtures: the suite runs 6
    workers on the host's cores, and torch's default pool oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BENCH = {
    "megadepth1500": (megadepth1500.MegaDepth1500Pipeline, jax_md.MegaDepth1500Pipeline, MD_CONF, 5),
    "scannet1500": (scannet1500.ScanNet1500Pipeline, jax_sn.ScanNet1500Pipeline, PAIRS_CONF, 3),
}
MATCH_METRICS = ("epi_prec@1e-4", "epi_prec@5e-4", "epi_prec@1e-3", "num_matches", "num_keypoints",
                 "reproj_prec@1px", "reproj_prec@3px", "reproj_prec@5px", "covisible",
                 "covisible_percent", "gt_match_recall@3px", "gt_match_precision@3px")


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("posed")
    write_layouts(root)
    return root


@pytest.fixture()
def data_path(layouts, monkeypatch):
    import gluefactory_tpu.data.image_pairs as jip
    import gluefactory_tpu.data.posed_images as jpi
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings

    for mod in (jsettings, jpi, jip, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", layouts)
    return layouts


def _assert_results_close(rt, rj, keys, atol=1e-6):
    for k in keys:
        np.testing.assert_allclose(np.asarray(rt[k], np.float64), np.asarray(rj[k], np.float64),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("bench", list(BENCH))
def test_pipeline_equals_jax(data_path, bench, capsys):
    tpipe, jpipe, data, n_pairs = BENCH[bench]
    conf = {"data": data, "model": MODEL, "eval": {"estimator": "opencv", "ransac_th": [1.0, 2.0]}}
    pj, params, pt = random_models()
    sj, _, rj = jpipe(conf).run(data_path / "jax" / bench, model=pj, variables=params, overwrite=True,
                                overwrite_eval=True)
    th_jax = _best_threshold(capsys.readouterr().out)
    st, _, rt = tpipe(conf, device="cpu").run(data_path / "port" / bench, model=pt, overwrite=True,
                                              overwrite_eval=True)
    cache = load_predictions(data_path / "port" / bench / "predictions.h5")
    with h5py.File(data_path / "jax" / bench / "predictions.h5") as hfile:
        assert len(cache) == n_pairs
        for name in cache:
            for k in tpipe.export_keys:
                got, want = cache[name][k], hfile[name][k][()]
                if k.startswith(("keypoints", "matches")):
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:  # scores: float32 rounding of the two forwards
                    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=k)
    assert _best_threshold(capsys.readouterr().out) == th_jax
    _assert_summaries_close(st, sj, rtol=1e-6)
    metrics = [k for k in MATCH_METRICS if k in rj] + ["rel_pose_error", "ransac_inl", "ransac_inl%"]
    assert len(metrics) == (15 if bench == "megadepth1500" else 8)
    _assert_results_close(rt, rj, metrics)
    assert list(rt["names"]) == [n.decode() if isinstance(n, bytes) else n for n in rj["names"]]
    assert (rt["num_matches"] >= 5).sum() >= 3  # the random model's matches reach the estimator
    loader = tpipe.get_dataloader(tpipe(conf).conf.data)
    with torch.no_grad():
        for batch in loader:
            la = pt({"view0": batch["view0"], "view1": batch["view1"]})["log_assignment"][0, :-1, :-1]
            rows, cols = la.topk(2, dim=1).values, la.topk(2, dim=0).values
            assert min((rows[:, 0] - rows[:, 1]).min(), (cols[0] - cols[1]).min()) >= 1e-4


def _planted(pipeline_cls, data, seed=0, n=100, n_out=20):
    """Per item: keypoints of view 0 where its depth is valid, their
    projections into view 1 (GT pose and depth) within 0.1 px, `n_out`
    outlier matches, 6 unmatched keypoints; in original pixels, as the
    export writes them. Without depth (ScanNet-1500) the points lie at
    random depths on their rays."""
    rng = np.random.default_rng(seed)
    preds = {}
    for batch in pipeline_cls.get_dataloader(pipeline_cls({"data": data}).conf.data):
        item = rbd(prepare_batch(batch, "cpu"))
        v0, v1 = item["view0"], item["view1"]
        w, h = (int(x) for x in v0["image_size"])
        k0 = rng.uniform(1, [w - 1, h - 1], (4 * n, 2)).astype(np.float32)
        k0_t = torch.from_numpy(k0)[None]
        if "depth" in v0:
            d0, valid = sample_depth(k0_t, v0["depth"][None])
        else:  # no depth in ScanNet-1500's pairs: points at random depths on each ray
            d0 = torch.from_numpy(rng.uniform(3, 9, (1, 4 * n)).astype(np.float32))
            valid = torch.ones(1, 4 * n, dtype=torch.bool)
        k1, vis = project(k0_t, d0, None, v0["camera"][None], v1["camera"][None], item["T_0to1"][None],
                          valid)
        keep = np.flatnonzero(vis[0].numpy())[:n]
        assert len(keep) == n
        k0, k1 = k0[keep], k1[0].numpy()[keep] + rng.uniform(-0.1, 0.1, (n, 2))
        w1, h1 = (float(x) for x in v1["image_size"])
        k1[:n_out] = rng.uniform(0, [w1, h1], (n_out, 2))
        perm = rng.permutation(n)
        matches0 = np.argsort(perm)
        matches0[rng.choice(n, 6, replace=False)] = -1
        preds[batch["name"][0]] = {
            "keypoints0": (k0 / v0["scales"].numpy()).astype(np.float32),
            "keypoints1": (k1[perm] / v1["scales"].numpy()).astype(np.float32),
            "matches0": matches0.astype(np.int32),
            "matching_scores0": np.where(matches0 >= 0, rng.uniform(0.2, 1, n), 0).astype(np.float32),
        }
    return preds


@pytest.mark.parametrize("estimator", ["opencv", "xla_ransac"])
@pytest.mark.parametrize("bench", list(BENCH))
def test_eval_loop_on_planted_cache_equals_jax(data_path, bench, estimator, tmp_path, capsys):
    tpipe, jpipe, data, n_pairs = BENCH[bench]
    preds = _planted(tpipe, data)
    assert len(preds) == n_pairs
    # h5py writes one cache and the port another: each package's eval reads
    # the other's file, so the equal results below hold both writers and readers
    with h5py.File(tmp_path / "h5py_predictions.h5", "w") as hfile:
        for name, pred in preds.items():
            grp = hfile.create_group(name)
            for k, v in pred.items():
                grp.create_dataset(k, data=v)
    writer = PredictionWriter(tmp_path / "predictions.h5")
    for name, pred in preds.items():
        writer.write(name, pred)
    writer.close()
    # the sweep with opencv; xla_ransac at one threshold (512 minimal sets a
    # call on the CPU in both packages is the file's largest cost)
    ths = [0.5, 2.0] if estimator == "opencv" else [1.0]
    conf = {"data": data, "model": MODEL, "eval": {"estimator": estimator, "ransac_th": ths}}
    jp = jpipe(conf)
    sj, _, rj = jp.run_eval(jp.get_dataloader(jp.conf.data), tmp_path / "predictions.h5")
    out_jax = capsys.readouterr().out
    tp = tpipe(conf, device="cpu")
    st, _, rt = tp.run_eval(tp.get_dataloader(tp.conf.data), tmp_path / "h5py_predictions.h5")
    if len(ths) > 1:
        assert _best_threshold(capsys.readouterr().out) == _best_threshold(out_jax)
    assert sj["rel_pose_error@20°"] > 0.5  # far from random poses
    metrics = [k for k in MATCH_METRICS if k in rj]
    _assert_results_close(rt, rj, metrics)
    np.testing.assert_array_equal(rt["ransac_inl"], rj["ransac_inl"])
    if estimator == "opencv":
        _assert_results_close(rt, rj, ["rel_pose_error", "ransac_inl%"])
        _assert_summaries_close(st, sj, rtol=1e-6)
    else:
        _assert_results_close(rt, rj, ["rel_pose_error"], atol=0.05)
        assert set(st) == set(sj)
        for k, v in sj.items():
            np.testing.assert_allclose(st[k], v, atol=0.05 if k.startswith("mrel") else 1e-3, err_msg=k)


@pytest.mark.parametrize("bench", list(BENCH))
def test_cli_on_cpu(data_path, bench, monkeypatch):
    mod = {"megadepth1500": megadepth1500, "scannet1500": scannet1500}[bench]
    monkeypatch.setattr(megadepth1500, "EVAL_PATH", data_path / "results")
    argv = ["--conf", "superpoint+lightglue-official", "--device", "cpu", "--tag", "t",
            "eval.estimator=xla_ransac", "data.num_workers=0", "data.preprocessing.resize=100",
            "model.extractor.max_num_keypoints=64", "model.matcher.n_layers=2"]
    if bench == "megadepth1500":
        argv.append("data.depth_format=png")
    torch.manual_seed(0)
    s, _, r = mod.main(argv)
    out = data_path / "results" / bench / "t"
    for f in ("predictions.h5", "results.h5", "summaries.json", "conf.yaml"):
        assert (out / f).exists(), f
    assert json.loads((out / "summaries.json").read_text()) == s
    assert set(s) >= {"rel_pose_error@5°", "rel_pose_error@20°", "rel_pose_error_mAA",
                      "mepi_prec@1e-3", "mnum_matches"}
    assert len(r["rel_pose_error"]) == BENCH[bench][3]
    if bench == "megadepth1500":
        assert {"mreproj_prec@3px", "mgt_match_recall@3px", "mcovisible"} <= set(s)
    mtime = (out / "predictions.h5").stat().st_mtime_ns

    def no_model(*a, **k):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(eval_pipeline, "load_model", no_model)
    s2, _, _ = mod.main(argv + ["--overwrite_eval"])
    assert s2 == s and (out / "predictions.h5").stat().st_mtime_ns == mtime


@pytest.mark.parametrize("bench", list(BENCH))
def test_cli_needs_a_card_by_default(bench, monkeypatch):
    mod = {"megadepth1500": megadepth1500, "scannet1500": scannet1500}[bench]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert megadepth1500.get_eval_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--conf", "superpoint+lightglue-official"])
