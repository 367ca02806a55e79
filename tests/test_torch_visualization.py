"""The port's plotting layer against the JAX package's on Agg: `viz2d`'s
functions, `make_match_figures`, the viewer's 14 plot modes, the two
frames under the event sequences of `tests/test_visualization.py`, and the
five datasets' viewers. Each test builds the same inputs from a seed,
draws through both packages (the port given torch tensors, channel-first
images where it says so) and compares the figures artist by artist
(`artists`): images by their arrays, lines by their data and colours,
collections by their offsets, face colours and segments, texts by their
strings, and the figure's match patches by their ends and colours;
positions within 1e-4 px, colours and image values within 1e-6 relative.

Also the trainer's figure hook (`train.plot`): figures reach a recording
writer, a run with `plot` set trains bit for bit as one without, a path
that does not resolve raises, and the shipped config trains through the
CLI with tensorboardX, importing neither JAX nor the JAX package."""

import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.colors as mcolors  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gluefactory_tpu.geometry import wrappers as jwrappers  # noqa: E402
from gluefactory_tpu.visualization import global_frame as jgf  # noqa: E402
from gluefactory_tpu.visualization import tools as jtools  # noqa: E402
from gluefactory_tpu.visualization import two_view_frame as jtvf  # noqa: E402
from gluefactory_tpu.visualization import visualize_batch as jvb  # noqa: E402
from gluefactory_tpu.visualization import viz2d as jviz  # noqa: E402
from gluefactory_tpu_torch import train  # noqa: E402
from gluefactory_tpu_torch.geometry import wrappers as twrappers  # noqa: E402
from gluefactory_tpu_torch.visualization import global_frame as tgf  # noqa: E402
from gluefactory_tpu_torch.visualization import tools as ttools  # noqa: E402
from gluefactory_tpu_torch.visualization import two_view_frame as ttvf  # noqa: E402
from gluefactory_tpu_torch.visualization import visualize_batch as tvb  # noqa: E402
from gluefactory_tpu_torch.visualization import viz2d as tviz  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POS_ATOL = 1e-4  # px
COLOR_RTOL = 1e-6


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


# --------------------------------------------------------------------------
# the figures' artists
# --------------------------------------------------------------------------


def _rgba(c):
    c = np.asarray(c, dtype=object) if isinstance(c, (list, tuple)) else c
    if isinstance(c, np.ndarray) and c.dtype != object:
        return np.atleast_2d(c.astype(float))
    return np.atleast_2d(mcolors.to_rgba_array(c))


def _text(t):
    return ("text", t.get_text(), t.get_visible())


def _axis(ax):
    out = {"limits": ("pos", np.array([*ax.get_xlim(), *ax.get_ylim()])),
           "labels": ("str", (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(), ax.axison)),
           "images": [(("img", np.ma.filled(np.asarray(im.get_array(), float), np.nan)),
                       ("img", np.array(im.get_clim(), float)),
                       ("str", (im.get_alpha(), im.get_cmap().name)))
                      for im in ax.images],
           "lines": [(("pos", np.asarray(li.get_xydata(), float)), ("color", _rgba(li.get_color())),
                      ("str", (li.get_linewidth(), li.get_alpha())))
                     for li in ax.lines],
           "collections": [], "texts": [_text(t) for t in ax.texts]}
    for c in ax.collections:
        entry = [("pos", np.asarray(c.get_offsets(), float)), ("color", _rgba(c.get_facecolors())),
                 ("str", c.get_alpha())]
        if hasattr(c, "get_segments"):
            entry.append(("pos", [np.asarray(s, float) for s in c.get_segments()]))
        out["collections"].append(entry)
    legend = ax.get_legend()
    if legend is not None:
        out["texts"] += [_text(t) for t in legend.get_texts()]
    return out


def artists(fig) -> dict:
    """Everything a figure shows, axis by axis, tagged for `assert_same`."""
    patches = [(("pos", np.array([*p.xy1, *p.xy2], float)), ("color", _rgba(p.get_edgecolor())),
                ("str", (p.get_linewidth(), p.get_alpha())))
               for p in fig.artists]
    suptitle = fig._suptitle.get_text() if fig._suptitle is not None else None
    return {"axes": [_axis(ax) for ax in fig.axes], "patches": patches, "suptitle": ("str", suptitle)}


def assert_same(a, b, path="fig"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, tuple) and len(a) in (2, 3) and a and a[0] in ("pos", "color", "img", "str",
                                                                           "text"):
        assert b[0] == a[0], path
        if a[0] == "pos":
            if isinstance(a[1], list):
                assert len(a[1]) == len(b[1]), path
                for i, (x, y) in enumerate(zip(a[1], b[1])):
                    np.testing.assert_allclose(x, y, rtol=0, atol=POS_ATOL, err_msg=f"{path}[{i}]")
            else:
                assert np.shape(a[1]) == np.shape(b[1]), path
                np.testing.assert_allclose(a[1], b[1], rtol=0, atol=POS_ATOL, err_msg=path)
        elif a[0] in ("color", "img"):
            assert np.shape(a[1]) == np.shape(b[1]), path
            np.testing.assert_allclose(a[1], b[1], rtol=COLOR_RTOL, atol=1e-12, equal_nan=True,
                                       err_msg=path)
        else:
            assert a[1:] == b[1:], path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def same_figures(fig_a, fig_b):
    assert_same(artists(fig_a), artists(fig_b))


# --------------------------------------------------------------------------
# viz2d
# --------------------------------------------------------------------------

RNG = np.random.default_rng(0)
IMGS = [RNG.uniform(0, 1, (60, 80, 3)).astype(np.float32), RNG.uniform(0, 1, (60, 80, 3)).astype(np.float32)]
KPTS = [RNG.uniform(0, 60, (20, 2)).astype(np.float32), RNG.uniform(0, 60, (20, 2)).astype(np.float32)]
LINES = [RNG.uniform(0, 60, (5, 2, 2)).astype(np.float32), RNG.uniform(0, 60, (5, 2, 2)).astype(np.float32)]
HEAT = [RNG.normal(size=(60, 80)).astype(np.float32), RNG.normal(size=(60, 80)).astype(np.float32)]
SCORES = RNG.uniform(0, 1, 50).astype(np.float32)
ERRS = RNG.uniform(0, 10, 100)
ERRS[:3] = np.inf
F_MAT = np.array([[0, -1e-3, 0.05], [1e-3, 0, -0.08], [-0.04, 0.07, 1.0]])


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _chw(img):
    return torch.as_tensor(img).permute(2, 0, 1)


def _draw(mod, torch_in: bool, name: str, tmp_path: Path):
    """One case of `name` through `mod`; returns a figure or an array."""
    t = _t if torch_in else (lambda x: x)
    img = (lambda x: _chw(x)) if torch_in else (lambda x: x)
    if name == "cm_RdGn":
        return mod.cm_RdGn(t(SCORES))
    if name == "cm_ranking":
        return mod.cm_ranking(t(np.sort(SCORES)[::-1].copy()), ths=(5, 10, 20, 40))
    if name == "plot_images":
        mod.plot_images([img(IMGS[0]), img(IMGS[1][..., :1])], titles=["a", "b"], cmaps=["gray", "viridis"])
    elif name == "plot_image_grid":
        mod.plot_image_grid([[img(IMGS[0]), img(IMGS[1])], [img(IMGS[1]), img(IMGS[0])]],
                            titles=[["a", "b"], ["c", "d"]])
    elif name == "add_text":
        axes = mod.plot_images([img(IMGS[0]), img(IMGS[1])])
        mod.add_text(0, "left")
        mod.add_text(1, "right", axes=axes, pos=(0.5, 0.1), va="bottom", visible=False)
    elif name == "plot_keypoints":
        mod.plot_images([img(IMGS[0]), img(IMGS[1])])
        mod.plot_keypoints([t(KPTS[0]), t(KPTS[1])], colors=["red", "blue"], ps=6, a=0.5)
    elif name == "plot_matches":
        mod.plot_images([img(IMGS[0]), img(IMGS[1])])
        np.random.seed(3)  # color=None draws from numpy's global generator
        mod.plot_matches(t(KPTS[0][:10]), t(KPTS[1][:10]))
        mod.plot_matches(t(KPTS[0][10:]), t(KPTS[1][10:]), color=mod.cm_RdGn(np.arange(10) % 2).tolist(),
                         lw=1.0, a=0.5)
    elif name == "plot_lines":
        mod.plot_images([img(IMGS[0]), img(IMGS[1])])
        mod.plot_lines([t(LINES[0]), t(LINES[1])], line_colors=["orange", "red"], ps=3)
    elif name == "plot_color_line_matches":
        mod.plot_images([img(IMGS[0]), img(IMGS[1])])
        mod.plot_color_line_matches([t(LINES[0]), t(LINES[1])])
        mod.plot_color_line_matches([t(LINES[1]), t(LINES[0])], correct_matches=t(np.arange(5) % 2 == 0),
                                    lw=1)
    elif name == "plot_heatmaps":
        mod.plot_images([img(IMGS[0]), img(IMGS[1])])
        mod.plot_heatmaps([t(HEAT[0]), t(HEAT[1])], vmin=-1.0, vmax=1.0, cmap="rainbow")
    elif name == "plot_epipolar_lines":
        mod.plot_images([img(IMGS[0]), img(IMGS[1])])
        mod.plot_epipolar_lines(t(KPTS[0][:8]), t(KPTS[1][:8]), t(F_MAT))
    elif name == "save_plot":
        mod.plot_images([img(IMGS[0]), img(IMGS[1])])
        mod.plot_keypoints([t(KPTS[0]), t(KPTS[1])])
        path = tmp_path / f"{mod.__name__.split('.')[0]}.png"
        mod.save_plot(path, dpi=50)
        return plt.imread(path)
    elif name == "plot_cumulative":
        return mod.plot_cumulative({"a": t(ERRS), "b": ERRS[::2], "empty": [np.nan]}, [0, 10], title="t")
    return plt.gcf()


VIZ2D = ["cm_RdGn", "cm_ranking", "plot_images", "plot_image_grid", "add_text", "plot_keypoints",
         "plot_matches", "plot_lines", "plot_color_line_matches", "plot_heatmaps",
         "plot_epipolar_lines", "save_plot", "plot_cumulative"]


@pytest.mark.parametrize("name", VIZ2D)
def test_viz2d_equals_jax(name, tmp_path):
    want = _draw(jviz, False, name, tmp_path)
    got = _draw(tviz, True, name, tmp_path)
    if isinstance(want, np.ndarray):
        assert got.shape == want.shape
        if want.dtype.kind in "fc":
            np.testing.assert_allclose(got, want, rtol=COLOR_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
    else:
        same_figures(got, want)


def test_viz2d_takes_tensors_on_the_channel_first_layout():
    """A CHW tensor shows the pixels of its HWC array."""
    ax_t = tviz.plot_images([_chw(IMGS[0])])
    ax_j = jviz.plot_images([IMGS[0]])
    np.testing.assert_array_equal(ax_t[0].images[0].get_array(), ax_j[0].images[0].get_array())


# --------------------------------------------------------------------------
# make_match_figures
# --------------------------------------------------------------------------


def _match_batch(gt: bool, B=3, N=12):
    rng = np.random.default_rng(1)
    pred = {"keypoints0": rng.uniform(0, 60, (B, N, 2)).astype(np.float32),
            "keypoints1": rng.uniform(0, 60, (B, N, 2)).astype(np.float32),
            "matches0": rng.integers(-1, N, (B, N))}
    if gt:
        pred["gt_matches0"] = np.where(rng.random((B, N)) < 0.5, pred["matches0"], rng.integers(-1, N, (B, N)))
    data = {"view0": {"image": rng.uniform(0, 1, (B, 60, 80, 3)).astype(np.float32)},
            "view1": {"image": rng.uniform(0, 1, (B, 60, 80, 1)).astype(np.float32)}}
    return pred, data


@pytest.mark.parametrize("gt", [True, False])
def test_make_match_figures_equals_jax(gt):
    pred, data = _match_batch(gt)
    want = jvb.make_match_figures(pred, data)
    got = tvb.make_match_figures({k: _t(v) for k, v in pred.items()},
                                 {k: {"image": _t(v["image"])} for k, v in data.items()})
    assert list(got) == list(want) == ["match_0", "match_1"]  # JAX's n_pairs default, 2
    for k in want:
        same_figures(got[k], want[k])
    pairs = tvb.match_data(pred, data, n_pairs=5)
    assert len(pairs) == 3
    for i, p in enumerate(pairs):
        valid = pred["matches0"][i] > -1
        np.testing.assert_array_equal(p["matches"][1], pred["keypoints1"][i][pred["matches0"][i][valid]])
        assert (p["correct"] is None) == (not gt)


# --------------------------------------------------------------------------
# the plot modes
# --------------------------------------------------------------------------

N = 16
H_0TO1 = np.array([[1.02, 0.03, 2.0], [-0.02, 0.98, -1.5], [1e-4, -2e-4, 1.0]], np.float32)
CAM = {"size": np.array([80.0, 60.0], np.float32), "f": np.array([50.0, 50.0], np.float32),
       "c": np.array([40.0, 30.0], np.float32)}
T_0TO1 = np.eye(4, dtype=np.float32)
T_0TO1[0, 3] = 0.2  # a translation along x, both depth maps the plane Z = 5: k1 = k0 + (2, 0)


def _tool_inputs():
    """Keypoints whose correspondences are 0.2 px off (even indices) or 15
    px off (odd), so no error lies near the 3 px threshold."""
    rng = np.random.default_rng(2)
    k0 = rng.uniform(8, [70, 50], (N, 2))
    off = np.where((np.arange(N) % 2 == 0)[:, None], rng.uniform(-0.1, 0.1, (N, 2)), [15.0, 0.0])
    w = np.c_[k0, np.ones(N)] @ H_0TO1.T.astype(float)
    k1h = w[:, :2] / w[:, 2:] + off
    k1d = k0 + [2.0, 0.0] + off
    m0 = np.arange(N)
    m0[[3, 8]] = -1
    pred = {"keypoints0": k0.astype(np.float32), "keypoints1": k1h.astype(np.float32), "matches0": m0,
            "keypoint_scores0": rng.uniform(0, 1, N).astype(np.float32),
            "keypoint_scores1": rng.uniform(0, 1, N).astype(np.float32),
            "matching_scores0": rng.uniform(0, 1, N).astype(np.float32),
            "gt_matches0": np.where(np.arange(N) % 3 == 0, m0, -1),
            "dense_score_map0": rng.normal(size=(60, 80)).astype(np.float32),
            "dense_score_map1": rng.uniform(0, 1, (1, 60, 80)).astype(np.float32),
            "lines0": rng.uniform(0, 60, (6, 2, 2)).astype(np.float32),
            "lines1": rng.uniform(0, 60, (6, 2, 2)).astype(np.float32),
            "line_matches0": np.array([2, -1, 0, 5, 1, -1]),
            "line_gt_matches0": np.array([2, -1, 1, 5, -1, 3])}
    depth = np.full((60, 80), 5.0, np.float32)
    images = [rng.uniform(0, 1, (60, 80, 3)).astype(np.float32) for _ in range(2)]
    return pred, k1d.astype(np.float32), images, depth


def _tool_data(package: str, name: str):
    pred, k1d, images, depth = _tool_inputs()
    if name == "depth_matches":
        pred = {**pred, "keypoints1": k1d}
    if package == "jax":
        cam = jwrappers.Camera(CAM["size"], CAM["f"], CAM["c"])
        pose = jwrappers.Pose.from_4x4mat(T_0TO1)
        views = [{"image": im, "depth": depth, "camera": cam} for im in images]
    else:  # tensors, one camera as a dict, the pose as a matrix
        cam = twrappers.Camera(_t(CAM["size"]), _t(CAM["f"]), _t(CAM["c"]))
        cam_dict = {k: _t(v) for k, v in CAM.items()}
        pose = _t(T_0TO1)
        pred = {k: _t(v) for k, v in pred.items()}
        views = [{"image": _chw(im), "depth": _t(depth), "camera": c} for im, c in zip(images, (cam, cam_dict))]
    data = {"view0": views[0], "view1": views[1], "H_0to1": H_0TO1 if package == "jax" else _t(H_0TO1),
            "T_0to1": pose}
    return data, pred


TOOLS = [*jtools.__plot_dict__, *jtools.__plot_lines_dict__]


@pytest.mark.parametrize("name", TOOLS)
def test_tool_equals_jax(name):
    assert sorted(ttools.__plot_dict__) == sorted(jtools.__plot_dict__)
    assert sorted(ttools.__plot_lines_dict__) == sorted(jtools.__plot_lines_dict__)
    figs = []
    for package, mod, viz in (("jax", jtools, jviz), ("torch", ttools, tviz)):
        tool = {**mod.__plot_dict__, **mod.__plot_lines_dict__}[name]
        data, pred = _tool_data(package, name)
        fig, axes = viz.plot_image_grid([[data["view0"]["image"], data["view1"]["image"]]],
                                        return_fig=True)
        tool(fig, axes[0], data, pred)
        figs.append(fig)
        assert tool.required_keys == {**jtools.__plot_dict__, **jtools.__plot_lines_dict__}[name].required_keys
    same_figures(figs[1], figs[0])
    if name in ("homography_error", "depth_matches"):  # both colours drawn
        colors = {tuple(c) for c in artists(figs[1])["patches"] for c in [c[1][1][0][:3]]}
        assert (1.0, 0.0, 0.0) in colors and (0.0, 1.0, 0.0) in colors, colors


# --------------------------------------------------------------------------
# the frames (the event sequences of tests/test_visualization.py)
# --------------------------------------------------------------------------


class KeyEvent:
    def __init__(self, key):
        self.key = key


def _results(n=10):
    rng = np.random.default_rng(0)
    res = {}
    for exp in ("expA", "expB"):
        res[exp] = {"names": [f"pair{i}" for i in range(n)], "prec": rng.uniform(0, 1, n),
                    "num_matches": rng.integers(10, 100, n).astype(float)}
    return res


def _frame_preds(seed=0):
    rng = np.random.default_rng(seed)
    data = {"view0": {"image": rng.uniform(0, 1, (60, 80, 3)).astype(np.float32),
                      "depth": rng.uniform(1, 5, (60, 80)).astype(np.float32)},
            "view1": {"image": rng.uniform(0, 1, (60, 80, 3)).astype(np.float32),
                      "depth": rng.uniform(1, 5, (60, 80)).astype(np.float32)},
            "H_0to1": np.eye(3, dtype=np.float32)}

    def mk_pred():
        return {"keypoints0": rng.uniform(0, 60, (N, 2)).astype(np.float32),
                "keypoints1": rng.uniform(0, 60, (N, 2)).astype(np.float32),
                "keypoint_scores0": rng.uniform(0, 1, N).astype(np.float32),
                "keypoint_scores1": rng.uniform(0, 1, N).astype(np.float32),
                "matches0": rng.integers(-1, N, N),
                "matching_scores0": rng.uniform(0, 1, N).astype(np.float32)}

    return data, {"expA": mk_pred(), "expB": mk_pred()}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return _t(tree) if isinstance(tree, np.ndarray) else tree


def test_global_frame_equals_jax(monkeypatch):
    """Draw, metric cycling, diff mode, hover; then a click opens the
    pair's two-view frame from the loader and the prediction loaders."""
    data, preds = _frame_preds()
    loader = [{"view0": {"image": d["image"][None]}, "view1": {"image": d2["image"][None]},
               "name": [f"pair{i}"]}
              for i, (d, d2) in enumerate([(data["view0"], data["view1"])] * 10)]
    frames = []
    for mod, tvf, tensors in ((jgf, jtvf, False), (tgf, ttvf, True)):
        monkeypatch.setattr(plt, "show", lambda *a, **k: None)
        ld = [_tensors(b) for b in loader] if tensors else loader
        pr = {exp: (lambda name, p=p: _tensors(p) if tensors else p) for exp, p in preds.items()}
        frames.append(mod.GlobalFrame({}, _results(), ld, pr, child_frame=tvf.TwoViewFrame))
    jf, tf = frames
    assert tf.metrics == jf.metrics == ["prec", "num_matches"]
    same_figures(tf.fig, jf.fig)
    for key in ("x", "X", "y", "d", "Y", "d"):
        jf.on_key(KeyEvent(key))
        tf.on_key(KeyEvent(key))
        assert (tf.x, tf.y, tf.diff) == (jf.x, jf.y, jf.diff), key
        same_figures(tf.fig, jf.fig)
    from matplotlib.backend_bases import MouseEvent

    for f in frames:
        f.fig.canvas.draw()
        xs, ys = f._series("expB")
        x, y = f.ax.transData.transform((xs[4], ys[4]))
        f.on_hover(MouseEvent("motion_notify_event", f.fig.canvas, x, y))
        assert f.annot.get_visible() and "pair4" in f.annot.get_text()
    same_figures(tf.fig, jf.fig)

    class Pick:
        ind = [3]

    for f in frames:
        f.on_pick(Pick())
    same_figures(tf.child_frames[-1].fig, jf.child_frames[-1].fig)
    assert tf.child_frames[-1].fig._suptitle.get_text() == "pair3"


@pytest.mark.parametrize("event", [1, 2, 3])
def test_two_view_frame_equals_jax(event):
    """Rows per experiment, the modes filtered by keys, right / left
    cycling (through every mode on the colour background), the summary
    toggle; colour, depth and colour + depth backgrounds."""
    data, preds = _frame_preds()
    summaries = {"expA": {"prec": 0.9, "n": 3}, "expB": {"prec": 0.8, "n": 4}}
    jf = jtvf.TwoViewFrame({}, data, preds, title="pair0", event=event, summaries=summaries)
    tf = ttvf.TwoViewFrame({}, _tensors(data), _tensors(preds), title="pair0", event=event,
                           summaries=summaries)
    assert tf.options == jf.options and "heatmaps" not in tf.options
    assert tf.radio.current == jf.radio.current == "matches"
    same_figures(tf.fig, jf.fig)
    keys = ["right"] * len(tf.options) + ["left", "t", "left"] if event == 1 else ["left", "t"]
    for key in keys:
        plt.figure(jf.fig.number)  # the JAX package draws matches on the current figure
        jf.on_key(KeyEvent(key))
        tf.on_key(KeyEvent(key))
        assert tf.radio.current == jf.radio.current
        same_figures(tf.fig, jf.fig)


def test_two_view_frame_single_prediction_equals_jax():
    data, preds = _frame_preds(1)
    pred = {k: preds["expA"][k] for k in ("keypoints0", "keypoints1", "matches0")}
    data = {k: v for k, v in data.items() if k != "H_0to1"}
    jf = jtvf.TwoViewFrame({}, data, pred)
    tf = ttvf.TwoViewFrame({}, data, _tensors(pred))
    assert len(tf.axes) == 1 and tf.options == jf.options
    same_figures(tf.fig, jf.fig)


# --------------------------------------------------------------------------
# the datasets' viewers
# --------------------------------------------------------------------------


def _viewer(module: str, argv: list, out: Path, monkeypatch):
    """The JAX package's `__main__` block and the port's `main(argv)` with
    the same arguments; both write their PNG, and their figures agree."""
    import importlib

    monkeypatch.setattr(sys, "argv", [module, *argv, "--out", str(out / "jax.png")])
    runpy.run_module(f"gluefactory_tpu.data.{module}", run_name="__main__")
    want = plt.gcf()
    importlib.import_module(f"gluefactory_tpu_torch.data.{module}").main(
        [*argv, "--out", str(out / "torch.png")])
    got = plt.gcf()
    assert got is not want
    assert (out / "torch.png").stat().st_size > 0 and (out / "jax.png").exists()
    same_figures(got, want)
    assert len(got.axes) >= 2


def test_homographies_viewer(tmp_path, monkeypatch):
    _viewer("homographies", ["--num_items", "1", "--synthetic", "2"], tmp_path, monkeypatch)


def test_hpatches_viewer(tmp_path, monkeypatch):
    import gluefactory_tpu.data.hpatches as jhp
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings
    from test_torch_eval_hpatches import write_sequence

    write_sequence(tmp_path / "hpatches-sequences-release")
    for mod in (jsettings, jhp, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    _viewer("hpatches", ["--num_items", "2"], tmp_path, monkeypatch)


def test_megadepth_viewer(tmp_path, monkeypatch):
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scene

    base = tmp_path / "megadepth"
    for i, scene in enumerate(("s0", "s1")):
        write_megadepth_scene(base, scene, n_views=4, size=(80, 60), seed=i)
    (base / "scene_lists").mkdir(exist_ok=True)
    (base / "scene_lists" / "train_scenes_clean.txt").write_text("s0\ns1\n")
    for mod in (jsettings, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    _viewer("megadepth", ["--split", "train", "--num_items", "2", "--dpi", "40",
                          "min_overlap=0.0", "max_overlap=1.0", "num_overlap_bins=1",
                          "train_num_per_scene=2", "preprocessing.resize=80"], tmp_path, monkeypatch)


def test_posed_images_viewer(tmp_path, monkeypatch):
    import gluefactory_tpu.data.posed_images as jpi
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_posed_images

    write_posed_images(tmp_path / "megadepth1500", "s0", n_views=3, n_pairs=2, size=(80, 60),
                       model="PINHOLE", seed=0)
    for mod in (jsettings, jpi, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    _viewer("posed_images", ["--num_items", "2", "--dpi", "40", "depth_format=png",
                             "preprocessing.resize=80"], tmp_path, monkeypatch)


def test_zeb_viewer(tmp_path, monkeypatch):
    import gluefactory_tpu.data.zeb as jzeb
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_zeb_scene

    for k, scene in enumerate(("gl3d", "kitti")):
        write_zeb_scene(tmp_path / "zeb", scene, n_views=3, n_pairs=2, size=(80, 60), seed=k)
    for mod in (jsettings, jzeb, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    _viewer("zeb", ["--num_items", "2", "--dpi", "40", "preprocessing.resize=80"], tmp_path,
            monkeypatch)


# --------------------------------------------------------------------------
# the trainer's figure hook
# --------------------------------------------------------------------------

TINY = ["--device", "cpu", "--max_val_iters", "1", "--no_capture",
        "data.synthetic_images=8", "data.train_size=6", "data.val_size=2", "data.batch_size=2",
        "data.num_workers=0", "data.source_size=[160,120]", "data.homography.patch_shape=[160,120]",
        "data.photometric.name=identity", "model.extractor.max_num_keypoints=32",
        "train.epochs=1", "train.log_every_iter=1", "train.eval_every_iter=1"]
SUPERGLUE = {"name": "superglue", "descriptor_dim": 256, "keypoint_encoder": [8, 16],
             "n_layers": 1, "num_heads": 2, "sinkhorn_iterations": 5, "filter_threshold": 0.2}
PLOT = "gluefactory_tpu_torch.visualization.visualize_batch.make_match_figures"


class RecordingWriter:
    def __init__(self):
        self.figures = []

    def add_figure(self, tag, fig, step):
        self.figures.append((tag, step, fig))


def _superglue_config(tmp_path: Path) -> Path:
    """The shipped stage-1 config with a small SuperGlue (BatchNorm in its
    keypoint encoder) as the matcher."""
    from gluefactory_tpu_torch.core.config import Config, from_yaml

    conf = from_yaml(str(ROOT / "gluefactory_tpu_torch/configs/superpoint+lightglue_homography.yaml"))
    conf = conf.to_dict()
    conf["model"]["matcher"] = dict(SUPERGLUE)
    path = tmp_path / "superglue_homography.yaml"
    path.write_text(Config(conf).to_yaml())
    return path


def _batch(n=2):
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch

    ds = get_dataset("homographies")({"synthetic_images": 4, "train_size": n, "val_size": 1,
                                      "source_size": [160, 120], "homography": {"patch_shape": [160, 120]},
                                      "photometric": {"name": "identity"}}).get_dataset("train")
    return prepare_batch(collate([ds[i] for i in range(n)]), "cpu")


def _model(matcher):
    from gluefactory_tpu_torch.models import get_model

    torch.manual_seed(0)
    return get_model("two_view_pipeline").from_conf(
        {"extractor": {"name": "superpoint", "max_num_keypoints": 32, "force_num_keypoints": True,
                       "detection_threshold": 0.0},
         "ground_truth": {"name": "homography_matcher", "th_positive": 3, "th_negative": 3},
         "matcher": matcher}, device="cpu")


def test_hook_draws_to_the_writer_and_leaves_the_model_as_it_was(monkeypatch):
    """SuperGlue's train-mode forward would move its BatchNorm statistics
    and the keypoint fill would draw from a generator: after the hook every
    parameter, buffer and torch's global generator are as before."""
    model, batch = _model(SUPERGLUE), _batch(3)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = torch.get_rng_state()
    writer = RecordingWriter()
    out = train.plot_hook(model, batch, tvb.make_match_figures, writer, 7, seed=5)
    assert out["error"] is None and out["figures"] == ["match_0", "match_1"]
    assert [(t, s) for t, s, _ in writer.figures] == [("figures/match_0", 7), ("figures/match_1", 7)]
    for _, _, fig in writer.figures:
        assert len(fig.axes) == 2 and fig.axes[0].images
    assert {"matches0", "keypoints0", "keypoints1"} <= set(out["pred"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert torch.equal(torch.get_rng_state(), rng)
    moved = _model(SUPERGLUE)
    with torch.no_grad():
        moved(batch, train=True, generator=torch.Generator().manual_seed(5))
    assert any(not torch.equal(v, state[k]) for k, v in moved.state_dict().items())  # the test bites

    # a failing figure function (no matplotlib on the card's host) is logged
    def no_matplotlib(pred, data):
        raise ImportError("No module named 'matplotlib'")

    warnings = []
    monkeypatch.setattr(train.logger, "warning", lambda msg, *a: warnings.append(msg % a))
    out = train.plot_hook(model, batch, no_matplotlib, writer, 8, seed=5)
    assert out["error"].startswith("ImportError") and out["pred"] is not None
    assert warnings == ["plot hook failed: ImportError: No module named 'matplotlib'"]
    assert len(writer.figures) == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_unresolvable_plot_path_raises():
    assert train.resolve_plot(None) is None
    assert train.resolve_plot([5, PLOT]) == (5, tvb.make_match_figures)
    for path in ("gluefactory_tpu_torch.visualization.visualize_batch.nope", "no_such_module.fn",
                 "gluefactory_tpu.visualization.visualize_batch.make_match_figures"):
        with pytest.raises(ValueError, match="train.plot"):
            train.resolve_plot([1, path])


def test_a_run_with_plot_trains_as_one_without(tmp_path, monkeypatch):
    """Two runs of the CLI with a writer (tensorboardX), SuperGlue as the
    matcher, the hook at every evaluation: the losses of every step and
    every tensor of the trained model (BatchNorm statistics included) equal
    those of the run with `train.plot=null`."""
    monkeypatch.setattr(train, "TRAINING_PATH", tmp_path)
    import tensorboardX

    tags = []
    monkeypatch.setattr(tensorboardX.SummaryWriter, "add_figure",
                        lambda self, tag, fig, step=None, **k: (tags.append((tag, step)), plt.close(fig)))
    call, runs = train.TrainStep.__call__, {}
    conf = str(_superglue_config(tmp_path))
    for name, plot in (("with", f"train.plot=[1,{PLOT}]"), ("without", "train.plot=null")):
        losses = []

        def recorded(self, *a, **k):
            out = call(self, *a, **k)
            losses.append({key: v.clone() for key, v in out[0].items()})
            return out

        monkeypatch.setattr(train.TrainStep, "__call__", recorded)
        runs[name] = (train.main([name, "--conf", conf, *TINY, plot]), losses)
    assert tags == [(f"figures/match_{i}", it) for it in (1, 2) for i in range(2)]
    (m_with, l_with), (m_without, l_without) = runs["with"], runs["without"]
    assert len(l_with) == len(l_without) == 3
    for a, b in zip(l_with, l_without):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    sd = m_without.state_dict()
    assert any("running_mean" in k for k in sd)
    for k, v in m_with.state_dict().items():
        assert torch.equal(v, sd[k]), k


_CLI = """
import json, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import tensorboardX
tags = []
add_figure = tensorboardX.SummaryWriter.add_figure
def recorded(self, tag, figure, global_step=None, *args, **kwargs):
    tags.append([tag, global_step, len(figure.axes)])
    return add_figure(self, tag, figure, global_step, *args, **kwargs)
tensorboardX.SummaryWriter.add_figure = recorded
from gluefactory_tpu_torch import train
train.main(sys.argv[1:])
leaked = sorted(m for m in sys.modules if m == "gluefactory_tpu" or m.startswith("gluefactory_tpu."))
print("RESULT " + json.dumps({"tags": tags, "leaked": leaked}))
"""


def test_shipped_config_trains_with_a_writer_through_the_cli(tmp_path):
    """`--conf superpoint+lightglue_homography` (its `plot: [5, ...]`) with
    tensorboardX on the CPU, 2 steps: the figures of the last step's
    evaluation reach the writer, and neither JAX nor the JAX package is
    imported."""
    argv = ["vplot", "--conf", "superpoint+lightglue_homography", *TINY, "data.train_size=4",
            "model.matcher.n_layers=2", "model.matcher.descriptor_dim=64", "model.matcher.num_heads=2",
            "train.eval_every_iter=100"]
    env = {**os.environ, "GLUEFACTORY_TRAINING": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", _CLI, *argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.split("RESULT ", 1)[1])
    assert out["leaked"] == []
    assert out["tags"] == [["figures/match_0", 1, 2], ["figures/match_1", 1, 2]]
    assert list((tmp_path / "vplot").glob("events.out.tfevents.*"))
