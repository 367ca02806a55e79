"""The port's HPatches eval loop on a planted cache against the JAX
package's, and the HPatches CLI on the CPU, on the fabricated sequence of
`tests/test_torch_eval_hpatches.py`.

- The eval loop alone on a planted cache (matches under the true
  homographies within 0.3 px, a quarter of them outliers), so that the
  AUCs are far from 0: the swept thresholds' summaries equal to JAX's
  within 1e-6, the same best threshold, the same inlier counts.
- `main` on the official config at a cut width: the files, a rerun with
  `--overwrite_eval` that reads the cache, the drift checks, and the
  refusal without a card.
"""

import json

import h5py
import numpy as np
import pytest
import torch

from gluefactory_tpu.eval import hpatches as jax_hpatches
from gluefactory_tpu_torch.eval import eval_pipeline, hpatches
from gluefactory_tpu_torch.utils.export_predictions import PredictionWriter
from test_torch_eval_hpatches import DATA, H, MODEL, PAIRS, W, _assert_summaries_close, _best_threshold
from test_torch_eval_hpatches import fake_hpatches  # noqa: F401  (the fixture)


def _planted(Hs, seed=0, n=80, n_out=20):
    """Per pair: keypoints, matches under the true homography within 0.3 px
    and `n_out` outlier matches; the outliers' scores 1e-3, so that the
    score-weighted DLT also lands near the truth."""
    rng = np.random.default_rng(seed)
    preds = []
    for Hq in Hs:
        k0 = rng.uniform(0, [W, H], (n, 2))
        w = np.c_[k0, np.ones(n)] @ Hq.T
        k1 = w[:, :2] / w[:, 2:] + rng.uniform(-0.3, 0.3, (n, 2))
        k1[:n_out] = rng.uniform(0, [W, H], (n_out, 2))
        perm = rng.permutation(n)
        matches0 = np.argsort(perm)
        matches0[rng.choice(n, 5, replace=False)] = -1
        scores = np.where(matches0 >= 0, rng.uniform(0.2, 1, n), 0)
        scores[:n_out] = np.where(matches0[:n_out] >= 0, 1e-3, 0)
        preds.append({"keypoints0": k0.astype(np.float32), "keypoints1": k1[perm].astype(np.float32),
                      "matches0": matches0.astype(np.int32),
                      "matching_scores0": scores.astype(np.float32)})
    return preds


def test_eval_loop_on_planted_cache_equals_jax(fake_hpatches, capsys):
    tmp, Hs = fake_hpatches
    preds = _planted(Hs)
    names = [f"i_fake/{q}.ppm" for q in range(2, 2 + PAIRS)]
    # h5py writes one cache and the port another: each package's eval reads
    # the other's file, so the equal results below hold both writers and readers
    with h5py.File(tmp / "h5py_predictions.h5", "w") as hfile:
        for name, pred in zip(names, preds):
            grp = hfile.create_group(name)
            for k, v in pred.items():
                grp.create_dataset(k, data=v)
    writer = PredictionWriter(tmp / "predictions.h5")
    for name, pred in zip(names, preds):
        writer.write(name, pred)
    writer.close()
    conf = {"data": DATA, "model": MODEL, "eval": {"estimator": "xla_ransac", "ransac_th": -1}}
    jp = jax_hpatches.HPatchesPipeline(conf)
    sj, _, rj = jp.run_eval(jp.get_dataloader(jp.conf.data), tmp / "predictions.h5")
    th_jax = _best_threshold(capsys.readouterr().out)
    tp = hpatches.HPatchesPipeline(conf, device="cpu")
    st, _, rt = tp.run_eval(tp.get_dataloader(tp.conf.data), tmp / "h5py_predictions.h5")
    assert _best_threshold(capsys.readouterr().out) == th_jax
    assert sj["H_error_ransac@5px"] > 0.5 and sj["H_error_dlt@5px"] > 0.5  # far from 0
    _assert_summaries_close(st, sj, rtol=1e-6)
    for k in ("ransac_inl", "num_matches"):
        np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)


def test_cli_on_cpu(fake_hpatches, monkeypatch):
    """`main` on the official config (cut: 64 keypoints, 2 layers): the run,
    then a rerun with --overwrite_eval that reads the cache, and the drift
    checks."""
    tmp, _ = fake_hpatches
    monkeypatch.setattr(hpatches, "EVAL_PATH", tmp / "results")
    argv = ["--conf", "superpoint+lightglue-official", "--device", "cpu", "--tag", "t",
            "eval.estimator=xla_ransac", "data.num_workers=0", f"data.preprocessing.resize={H}",
            "model.extractor.max_num_keypoints=64", "model.matcher.n_layers=2"]
    torch.manual_seed(0)
    s, _, r = hpatches.main(argv)
    out = tmp / "results" / "hpatches" / "t"
    for f in ("predictions.h5", "results.npz", "summaries.json", "conf.yaml"):
        assert (out / f).exists(), f
    assert json.loads((out / "summaries.json").read_text()) == s
    assert set(s) >= {"H_error_ransac@1px", "H_error_dlt@5px", "mnum_matches", "H_error_ransac_mAA"}
    assert len(r["H_error_dlt"]) == PAIRS
    mtime = (out / "predictions.h5").stat().st_mtime_ns

    def no_model(*a, **k):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(eval_pipeline, "load_model", no_model)
    s2, _, _ = hpatches.main(argv + ["--overwrite_eval"])
    assert s2 == s and (out / "predictions.h5").stat().st_mtime_ns == mtime
    with pytest.raises(ValueError, match="overwrite_eval"):
        hpatches.main(argv + ["eval.ransac_th=1.0"])
    with pytest.raises(ValueError, match="overwrite"):
        hpatches.main(argv + ["model.matcher.filter_threshold=0.2"])


def test_cli_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = hpatches.get_eval_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hpatches.main(["--conf", "superpoint+lightglue-official"])
