"""The port's HPatches benchmark against the JAX package's on the CPU, on
one fabricated sequence of 5 pairs (integer translations, 160 x 120, no
resize). The eval loop on a planted cache and the CLI:
`tests/test_torch_eval_cli.py`.

- The whole pipeline (export, then the eval loop with `xla_ransac` at two
  thresholds), SuperPoint + a 2-layer LightGlue at 64 keypoints with the
  same random weights (drawn in the port's layout as flax draws them,
  lecun-normal with zero biases, so that the random model matches 5-7
  points a pair; turned into JAX params by the JAX package's converter,
  which is quicker than JAX's jitted init; loaded into the port through
  `from_jax_params`). Random weights leave near-ties in the assignment,
  which float32 rounding can flip (a 1e-9 gap did at seed 1), so the test
  asserts that every row's and column's best entry leads its second by at
  least 1e-4. Then: the same keypoints, matches and RANSAC inlier counts,
  the same best threshold, the summaries within 1e-3 relative, and each
  pair's DLT and RANSAC errors within 5e-3 relative. Random weights match
  a handful of points at random, so each homography is fitted to 5-7
  garbage matches, an ill-conditioned fit in which the two packages'
  float32 rounding of the scores and the DLT moves a 216 px error by 0.43
  px (2.0e-3, measured).
"""

from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_lightglue, convert_superpoint
from gluefactory_tpu.eval import hpatches as jax_hpatches
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.eval import hpatches
from gluefactory_tpu_torch.models import get_model

W, H, K, PAIRS = 160, 120, 64, 5
MODEL = {"name": "two_view_pipeline",
         "extractor": {"name": "superpoint", "max_num_keypoints": K, "detection_threshold": 0.0},
         "matcher": {"name": "lightglue", "n_layers": 2, "descriptor_dim": 64, "num_heads": 2,
                     "filter_threshold": 0.0}}
DATA = {"num_workers": 0, "preprocessing": {"resize": H, "side": "short"}}


def write_sequence(root: Path, seq: str = "i_fake", seed: int = 0) -> list:
    """`seq` with 5 views translated by multiples of 8 px from a blurred
    noise image; returns the homographies."""
    rng = np.random.default_rng(seed)
    d = root / seq
    d.mkdir(parents=True)
    big = cv2.GaussianBlur((rng.random((H + 64, W + 64, 3)) * 255).astype(np.uint8), (0, 0), 1.5)
    cv2.imwrite(str(d / "1.ppm"), big[32:32 + H, 32:32 + W, ::-1])
    Hs = []
    for q in range(2, 2 + PAIRS):
        tx, ty = 8 * (q - 3), -8 * (q - 4)
        Hq = np.eye(3)
        Hq[:2, 2] = tx, ty
        cv2.imwrite(str(d / f"{q}.ppm"), big[32 - ty:32 - ty + H, 32 - tx:32 - tx + W, ::-1])
        np.savetxt(str(d / f"H_1_{q}"), Hq)
        Hs.append(Hq)
    return Hs


@pytest.fixture()
def fake_hpatches(tmp_path, monkeypatch):
    import gluefactory_tpu.data.hpatches as jhp
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings

    Hs = write_sequence(tmp_path / "hpatches-sequences-release")
    for mod in (jsettings, jhp, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    return tmp_path, Hs


def _best_threshold(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("Best threshold:")]
    assert len(lines) == 1, out
    return float(lines[0].split(":")[1])


def _assert_summaries_close(got: dict, want: dict, rtol: float):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-12, err_msg=k)


def random_models():
    """(JAX model, its params, the port's model) with the same random
    weights: drawn in the port's layout as flax draws them (seed 4),
    converted by the JAX package's converter, loaded back through
    `from_jax_params`."""
    pj = jax_get_model("two_view_pipeline").from_conf(
        {"extractor": MODEL["extractor"], "matcher": {**MODEL["matcher"], "checkpointed": False}})
    torch.manual_seed(4)
    pt = get_model("two_view_pipeline").from_conf(
        {k: v for k, v in MODEL.items() if k != "name"}, device="cpu")
    with torch.no_grad():
        for name, prm in pt.named_parameters():
            if name.endswith("bias"):
                prm.zero_()
            elif prm.ndim >= 2:
                torch.nn.init.normal_(prm, std=prm[0].numel() ** -0.5)
    sd = {k: v.detach().numpy() for k, v in pt.state_dict().items()}
    part = lambda prefix: {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params = {"params": {"extractor_model": convert_superpoint(part("extractor.")),
                         "matcher_model": convert_lightglue(part("matcher."), n_layers=2, dim=64,
                                                            num_heads=2)}}
    pt.load_state_dict(from_jax_params(params["params"], "two_view_pipeline", num_heads=2))
    return pj, params, pt


def test_pipeline_equals_jax(fake_hpatches, capsys):
    tmp, _ = fake_hpatches
    conf = {"data": DATA, "model": MODEL, "eval": {"estimator": "xla_ransac", "ransac_th": [1.0, 3.0]}}
    pj, params, pt = random_models()
    sj, _, rj = jax_hpatches.HPatchesPipeline(conf).run(
        tmp / "jax", model=pj, variables=params, overwrite=True, overwrite_eval=True)
    th_jax = _best_threshold(capsys.readouterr().out)
    st, _, rt = hpatches.HPatchesPipeline(conf, device="cpu").run(
        tmp / "port", model=pt, overwrite=True, overwrite_eval=True)
    assert _best_threshold(capsys.readouterr().out) == th_jax
    _assert_summaries_close(st, sj, rtol=1e-3)
    for k in ("num_matches", "num_keypoints", "ransac_inl", "prec@1px", "prec@3px"):
        np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)
    for k in ("H_error_dlt", "H_error_ransac"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=5e-3, err_msg=k)
    assert list(rt["names"]) == [n.decode() if isinstance(n, bytes) else n for n in rj["names"]]
    assert (rt["num_matches"] >= 4).all()  # every pair reaches the estimators
    loader = hpatches.HPatchesPipeline.get_dataloader(conf["data"])
    with torch.no_grad():
        for batch in loader:
            la = pt({"view0": batch["view0"], "view1": batch["view1"]})["log_assignment"][0, :-1, :-1]
            rows, cols = la.topk(2, dim=1).values, la.topk(2, dim=0).values
            assert min((rows[:, 0] - rows[:, 1]).min(), (cols[0] - cols[1]).min()) >= 1e-4
    with np.load(tmp / "port" / "predictions.npz") as npz:
        names = {m.rsplit("/", 1)[0] for m in npz.files}
        assert names == {f"i_fake/{q}.ppm" for q in range(2, 2 + PAIRS)}
        assert {m.rsplit("/", 1)[1] for m in npz.files} == set(hpatches.HPatchesPipeline.export_keys)
    with h5py.File(tmp / "jax" / "predictions.h5") as hfile, \
            np.load(tmp / "port" / "predictions.npz") as npz:
        for q in range(2, 2 + PAIRS):
            grp = hfile[f"i_fake/{q}.ppm"]
            for k in ("keypoints0", "keypoints1", "matches0", "matches1"):
                np.testing.assert_array_equal(npz[f"i_fake/{q}.ppm/{k}.npy"], grp[k][()], err_msg=k)
