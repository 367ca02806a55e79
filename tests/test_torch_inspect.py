"""The port's results inspector (`gluefactory_tpu_torch/eval/inspect.py`)
against the JAX package's on two HPatches eval experiments of the
fabricated sequence of `tests/test_torch_eval_hpatches.py`, one written by
each package (predictions through h5py and through the port's writer,
results through each package's `run_eval` and `save_eval`), so that each
package reads the other's files:

- `load_experiments` (no matplotlib) equal to the JAX package's
  `load_eval` and to h5py's reads of every prediction;
- `main` with `plt.show` patched: its scatter's artists (offsets within
  1e-4, colours within 1e-6 relative, the legend's medians) equal to those
  of the JAX package's `main` on the same experiments, then a click on an
  item opens the same two-view frame in both."""

import sys

import matplotlib

matplotlib.use("Agg")

import h5py  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import gluefactory_tpu_torch.settings as tsettings  # noqa: E402
from gluefactory_tpu.eval import eval_pipeline as jeval  # noqa: E402
from gluefactory_tpu.eval import hpatches as jax_hpatches  # noqa: E402
from gluefactory_tpu.eval import inspect as jinspect  # noqa: E402
from gluefactory_tpu_torch.eval import eval_pipeline, hpatches  # noqa: E402
from gluefactory_tpu_torch.eval import inspect as tinspect  # noqa: E402
from gluefactory_tpu_torch.utils.export_predictions import PredictionWriter  # noqa: E402
from test_torch_eval_cli import _planted  # noqa: E402
from test_torch_eval_hpatches import DATA, MODEL, PAIRS  # noqa: E402
from test_torch_eval_hpatches import fake_hpatches  # noqa: E402,F401  (the fixture)
from test_torch_visualization import same_figures  # noqa: E402

CONF = {"data": DATA, "model": MODEL, "eval": {"estimator": "xla_ransac", "ransac_th": 1.0}}
NAMES = [f"i_fake/{q}.ppm" for q in range(2, 2 + PAIRS)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def experiments(fake_hpatches, monkeypatch):
    """`results/hpatches/{jax,torch}`: each package's predictions and its
    eval of them."""
    tmp, Hs = fake_hpatches
    out = tmp / "results" / "hpatches"
    for exp, seed in (("jax", 0), ("torch", 1)):
        (out / exp).mkdir(parents=True)
        preds = _planted(Hs, seed=seed)
        pred_file = out / exp / "predictions.h5"
        if exp == "jax":
            with h5py.File(pred_file, "w") as hfile:
                for name, pred in zip(NAMES, preds):
                    grp = hfile.create_group(name)
                    for k, v in pred.items():
                        grp.create_dataset(k, data=v)
            pipe = jax_hpatches.HPatchesPipeline(CONF)
            s, f, r = pipe.run_eval(pipe.get_dataloader(pipe.conf.data), pred_file)
            jeval.save_eval(out / exp, s, f, r)
        else:
            writer = PredictionWriter(pred_file)
            for name, pred in zip(NAMES, preds):
                writer.write(name, pred)
            writer.close()
            pipe = hpatches.HPatchesPipeline(CONF, device="cpu")
            s, f, r = pipe.run_eval(pipe.get_dataloader(pipe.conf.data), pred_file)
            eval_pipeline.save_eval(out / exp, s, f, r)
    monkeypatch.setattr(jinspect, "EVAL_PATH", tmp / "results")
    monkeypatch.setattr(tsettings, "EVAL_PATH", tmp / "results")
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    for cls in (jax_hpatches.HPatchesPipeline, hpatches.HPatchesPipeline):  # the viewers' loaders
        monkeypatch.setitem(cls.default_conf, "data", {**cls.default_conf["data"], **DATA})
    yield out
    plt.close("all")


def test_loading_reads_either_packages_files(experiments):
    results, predictions = tinspect.load_experiments("hpatches", ["jax", "torch"])
    assert list(results) == list(predictions) == ["jax", "torch"]
    for exp in ("jax", "torch"):
        _, want = jeval.load_eval(experiments / exp)
        assert set(results[exp]) == set(want)
        for k, v in want.items():
            if v.dtype.kind in "OSU":
                assert [str(x) for x in results[exp][k]] == [x.decode() if isinstance(x, bytes) else str(x)
                                                             for x in v], k
            else:
                np.testing.assert_array_equal(results[exp][k], v, err_msg=k)
        assert [str(n) for n in results[exp]["names"]] == NAMES
        with h5py.File(experiments / exp / "predictions.h5", "r") as hfile:
            for name in NAMES:
                got = predictions[exp](name)
                assert set(got) == set(hfile[name].keys())
                for k, v in got.items():
                    np.testing.assert_array_equal(v, np.asarray(hfile[name][k]), err_msg=f"{name}/{k}")


def test_main_equals_jax(experiments, monkeypatch):
    frames = []
    global_frame = jinspect.GlobalFrame

    class Recorded(global_frame):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            frames.append(self)

    monkeypatch.setattr(jinspect, "GlobalFrame", Recorded)
    argv = ["hpatches", "jax", "torch", "--y", "ransac_inl", "--diff"]
    monkeypatch.setattr(sys, "argv", ["inspect", *argv])
    jinspect.main()
    jf = frames[0]
    tf = tinspect.main(argv)
    assert (tf.x, tf.y, tf.diff, tf.metrics) == (jf.x, jf.y, jf.diff, jf.metrics)
    assert tf.diff and tf.y == "ransac_inl"
    same_figures(tf.fig, jf.fig)
    offsets = [c.get_offsets() for c in tf.ax.collections]
    assert len(offsets) == 2 and all(len(o) == PAIRS for o in offsets)

    class Pick:
        ind = [2]

    # h5py reads the names as bytes, and the JAX package's inspector then
    # asks its prediction files for "b'i_fake/4.ppm'": the port's reader
    # gives str; the JAX frame is handed the decoded names for the click
    assert isinstance(jf.names[0], bytes) and tf.names == NAMES
    jf.names = [n.decode() for n in jf.names]
    jf.on_pick(Pick())
    tf.on_pick(Pick())
    same_figures(tf.child_frames[-1].fig, jf.child_frames[-1].fig)
    assert tf.child_frames[-1].names == ["jax", "torch"]
