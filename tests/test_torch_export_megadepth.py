"""The MegaDepth feature export and cached-feature stage-2 training in the
port against the JAX package, on the CPU at a tiny size: procedural scenes
in MegaDepth's D2-Net layout (`scripts_dev/posed_scenes.write_megadepth_scene`).

- `scripts/export_megadepth.py` on 2 scenes of 3 views at 128 x 96
  (SuperPoint at full width, 256 keypoints, random weights drawn in the
  port's layout as flax draws them and converted by the JAX package's
  converter, loaded back through `from_jax_params`; `--with_depth`) against
  the JAX script on the first scene: every key; keypoints, depths and their
  validity equal; float16 arrays within their rounding of float32 values
  that agree to 1e-4 (SuperPoint's 256-D descriptors at full width differ
  by up to ~6e-5 between the packages' float32 convolutions, which moves
  0.7% of the float16 entries by 1-3 steps of 3e-5-6e-5), >= 99% equal. The second scene: the port writes its 3
  images; the JAX script writes none (it narrows its item list in place).
  The JAX script writes each image under `<scene>/<image>` (its
  single-view items' name), which its own `CacheLoader` cannot find
  (it asks for `<image>`); the port writes `<image>`, which both packages'
  loaders read equal.
- `MegaDepth` items with `load_features` (the port's export, padded to 64)
  equal to JAX's, with `p_rotate` 1 so that views turn both ways: the
  cached keypoints rotate with the image.
- Two Adam steps of the stage-2 config on cached features (no extractor in
  the step; masks from the padding) against JAX's `make_train_step`, from
  the same matcher weights: losses within 1e-4 relative, step-0 gradients
  within 1e-4 of their global norm, parameters within 3 * lr * steps.
"""

import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

import gluefactory_tpu.data.megadepth as jmd
import gluefactory_tpu.eval.io as jio
import gluefactory_tpu.models.cache_loader as jcl
import gluefactory_tpu.scripts.export_megadepth as jexp
import gluefactory_tpu_torch.settings as tsettings
from gluefactory_tpu import train as jax_train
from gluefactory_tpu.compat.torch_conversion import convert_superpoint
from gluefactory_tpu.core.config import Config as JConfig
from gluefactory_tpu.data import get_dataset as jax_get_dataset
from gluefactory_tpu.data.base_dataset import collate as jax_collate
from gluefactory_tpu.data.base_dataset import prepare_batch as jax_prepare_batch
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch import train as torch_train
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.core.config import Config, from_yaml, merge
from gluefactory_tpu_torch.data import get_dataset
from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
from gluefactory_tpu_torch.models import cache_loader, get_model
from gluefactory_tpu_torch.scripts import export_megadepth as texp
from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scene

ROOT = Path(__file__).resolve().parents[1]
CONF = ROOT / "gluefactory_tpu_torch/configs/superpoint+lightglue_megadepth.yaml"
YAML = from_yaml(str(CONF))
SIZE = (128, 96)
EXPORT_K = 256
TAG = "megadepth-undist-depth-" + texp.METHODS["sp"]["tag"]
# the training test's SuperPoint and LightGlue (test_torch_train_megadepth.py's)
K, HEADS, LR, STEPS, B, PAD = 48, 2, 1e-3, 2, 2, 64
SMALL_SP = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 64}
MODEL = merge(YAML.model, {
    "extractor": {**SMALL_SP, "max_num_keypoints": K},
    "matcher": {"input_dim": 64, "descriptor_dim": 64, "n_layers": 2, "num_heads": HEADS,
                "flash": False, "checkpointed": False},
}).to_dict()


def random_superpoint(conf: dict, seed: int):
    """(JAX params, the port's state dict) of one random SuperPoint: drawn
    in the port's layout as flax draws it (lecun-normal, zero biases),
    converted by the JAX package's converter and back by `from_jax_params`."""
    torch.manual_seed(seed)
    sp = get_model("superpoint").from_conf(conf, device="cpu")
    with torch.no_grad():
        for name, prm in sp.named_parameters():
            if name.endswith("bias"):
                prm.zero_()
            elif prm.ndim >= 2:
                torch.nn.init.normal_(prm, std=prm[0].numel() ** -0.5)
    params = convert_superpoint({k: v.numpy() for k, v in sp.state_dict().items()})
    return params, from_jax_params(params, "superpoint")


def _export(method_conf: dict, params, state_dict, root: Path, scenes: list, monkeypatch,
            jax_too: bool) -> None:
    """Both scripts (the JAX one where `jax_too`, first) on `scenes`, their
    caches under root/exports_jax and root/exports."""
    (root / "megadepth" / "scene_lists" / "export.txt").write_text("\n".join(scenes) + "\n")
    sp = {**texp.METHODS["sp"], "model": {**texp.METHODS["sp"]["model"], **method_conf}}
    monkeypatch.setitem(texp.METHODS, "sp", sp)
    monkeypatch.setitem(jexp.METHODS, "sp", sp)
    for mod in (jmd, jexp, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", root)
    args = ["--method", "sp", "--scenes", "export.txt", "--num_workers", "0", "--resize", "128",
            "--with_depth"]
    if jax_too:
        orig = jio.make_apply_fn
        monkeypatch.setattr(jexp, "make_apply_fn", lambda model, _: orig(model, {"params": params}))
        monkeypatch.setattr(sys, "argv", ["export_megadepth", *args])
        jexp.main()
        (root / "exports").rename(root / "exports_jax")
    torch.save(state_dict, root / "sp.pth")
    written = texp.main([*args, "--device", "cpu", "--weights_file", str(root / "sp.pth")])
    assert [p.name for p in written] == [f"{s}.h5" for s in scenes]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    for s in range(2):
        write_megadepth_scene(root / "megadepth", f"s{s}", n_views=3, size=SIZE, seed=s)
    (root / "megadepth" / "scene_lists").mkdir()
    mp = pytest.MonkeyPatch()
    try:
        params, sd = random_superpoint({"max_num_keypoints": EXPORT_K, "detection_threshold": 0.0,
                                        "nms_radius": 3}, seed=4)
        _export({"max_num_keypoints": EXPORT_K}, params, sd, root, ["s0", "s1"], mp, jax_too=True)
    finally:
        mp.undo()
    return root


def _close_half(got: np.ndarray, want: np.ndarray, key: str, atol: float = 1e-4):
    """float16 arrays of float32 values that agree to `atol`: apart by at
    most `atol` and one float16 step, and >= 99% equal."""
    assert got.dtype == want.dtype == np.float16, key
    g, w = got.astype(np.float32), want.astype(np.float32)
    step = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float16)).astype(np.float32)
    assert (np.abs(g - w) <= atol + step).all(), (key, np.abs(g - w).max())
    assert (g == w).mean() >= 0.99, key


def test_export_equals_jax_on_the_first_scene(exported):
    ours = h5py.File(exported / "exports" / TAG / "s0.h5", "r")
    theirs = h5py.File(exported / "exports_jax" / TAG / "s0.h5", "r")
    assert sorted(ours) == [f"s0_im{i:02d}.jpg" for i in range(3)]
    assert list(theirs) == ["s0"] and sorted(theirs["s0"]) == sorted(ours)  # <scene>/<image>
    for name in ours:
        a, b = ours[name], theirs["s0"][name]
        assert set(a) == set(b) >= {"keypoints", "keypoint_scores", "descriptors", "depth_keypoints",
                                    "valid_depth_keypoints"}
        assert a["keypoints"].shape == (EXPORT_K, 2)
        for k in a:
            x, y = a[k][()], b[k][()]
            assert x.shape == y.shape, k
            if k in ("keypoints", "depth_keypoints"):
                np.testing.assert_array_equal(x, y, err_msg=k)
            if x.dtype == np.float16:
                _close_half(x, y, k)
            else:
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)
        kpts = a["keypoints"][()].astype(np.float32)
        assert np.isfinite(kpts).all() and (kpts >= 0).all() and (kpts <= np.array(SIZE)).all()
        assert a["valid_depth_keypoints"].dtype == bool and a["valid_depth_keypoints"][()].any()
    ours.close()
    theirs.close()


def test_every_scene_gets_its_images(exported):
    with h5py.File(exported / "exports" / TAG / "s1.h5", "r") as f:
        assert sorted(f) == [f"s1_im{i:02d}.jpg" for i in range(3)]
    with h5py.File(exported / "exports_jax" / TAG / "s1.h5", "r") as f:
        assert list(f) == []  # the JAX script's second scene is empty


def test_cache_loaders_read_the_port_export(exported, monkeypatch):
    monkeypatch.setattr(jcl, "DATA_PATH", exported)
    monkeypatch.setattr(tsettings, "DATA_PATH", exported)
    conf = {"path": f"exports/{TAG}/{{scene}}.h5", "padding_length": 300,
            "data_keys": ["keypoints", "keypoint_scores", "descriptors", "valid_depth_keypoints"]}
    ours, theirs = cache_loader.CacheLoader(conf), jcl.CacheLoader(conf)
    for scene in ("s0", "s1"):
        for i in range(3):
            data = {"scene": scene, "name": f"{scene}_im{i:02d}.jpg", "scales": np.float32([0.5, 0.5])}
            got, want = ours(data), theirs(data)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax_own = jcl.CacheLoader({**conf, "path": f"exports_jax/{TAG}/{{scene}}.h5"})
    with pytest.raises(KeyError):  # the JAX export's key is <scene>/<image>
        jax_own({"scene": "s0", "name": "s0_im00.jpg"})


# -- cached stage-2 training ---------------------------------------------

DATA = {"train_split": ["s0", "s1"], "train_num_per_scene": 6, "min_overlap": 0.1,
        "max_overlap": 0.7, "num_overlap_bins": 3,
        "preprocessing": {"resize": 128, "side": "long", "square_pad": True},
        "load_features": {"do": True, "path": f"exports/{TAG}/{{scene}}.h5", "padding_length": PAD}}


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """2 scenes of 8 views, exported by the port's script with the small
    SuperPoint at 48 keypoints."""
    root = tmp_path_factory.mktemp("train")
    for s in range(2):
        write_megadepth_scene(root / "megadepth", f"s{s}", n_views=8, size=SIZE, seed=s)
    (root / "megadepth" / "scene_lists").mkdir()
    mp = pytest.MonkeyPatch()
    try:
        conf = {**SMALL_SP, "max_num_keypoints": K}
        params, sd = random_superpoint({**conf, "detection_threshold": 0.0, "nms_radius": 3}, seed=2)
        _export(conf, params, sd, root, ["s0", "s1"], mp, jax_too=False)
    finally:
        mp.undo()
    return root


@pytest.fixture()
def both(train_root, monkeypatch):
    for mod in (jmd, jcl, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", train_root)

    def make(conf):
        return (jax_get_dataset("megadepth")(conf).get_dataset("train"),
                get_dataset("megadepth")(conf).get_dataset("train"))

    return make


def _rotations(conf: dict, idx: int) -> list:
    """The item's views' rotations, drawn as `_read_view` draws them."""
    rng, out = np.random.default_rng((conf.get("seed", 0), idx)), []
    for _ in range(2):
        if rng.random() < conf["p_rotate"]:
            out.append(int(rng.choice(2)) * 2 - 1)
        else:
            out.append(0)
    return out


def test_megadepth_items_with_cache_equal_jax(both):
    conf = {**DATA, "p_rotate": 1.0}
    theirs, ours = both(conf)
    assert theirs.items == ours.items and len(ours) >= 6
    turns = set()
    for i in range(6):
        a, b = ours[i], theirs[i]
        turns.update(_rotations(conf, i))
        for v in ("view0", "view1"):
            ca, cb = a[v]["cache"], b[v]["cache"]
            assert set(ca) == set(cb) == {"keypoints", "keypoint_scores", "descriptors", "keypoint_mask"}
            for k in cb:
                assert ca[k].dtype == cb[k].dtype and ca[k].shape == cb[k].shape, k
                np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
            assert ca["keypoint_mask"].shape == (PAD,) and 0 < ca["keypoint_mask"].sum() <= K
            np.testing.assert_array_equal(a[v]["image"], b[v]["image"])
    assert turns == {-1, 1}  # both rotation signs


@pytest.fixture(scope="module")
def jax_run(train_root):
    """Cached batches from both packages' datasets, JAX's initial params and
    step-0 gradients, the losses of two steps and the final params."""
    old = jmd.DATA_PATH, jcl.DATA_PATH, tsettings.DATA_PATH
    jmd.DATA_PATH = jcl.DATA_PATH = tsettings.DATA_PATH = train_root
    try:
        items = get_dataset("megadepth")(DATA).get_dataset("train")
        jax_items = jax_get_dataset("megadepth")(DATA).get_dataset("train")
        assert items.items == jax_items.items
        idx = [list(range(i * B, (i + 1) * B)) for i in range(STEPS)]
        batches = [prepare_batch(collate([items[i] for i in ix]), "cpu") for ix in idx]
        jb = [jax_train.strip_non_arrays(jax_prepare_batch(jax_collate([jax_items[i] for i in ix])))
              for ix in idx]
    finally:
        jmd.DATA_PATH, jcl.DATA_PATH, tsettings.DATA_PATH = old
    key = jax.random.key(0)
    model = jax_get_model("two_view_pipeline").from_conf({k: v for k, v in MODEL.items() if k != "name"})
    params = jax.jit(model.init, static_argnames="method")(
        {"params": key, "sample": key}, jb[0], method="initialize")["params"]

    def loss_fn(p):
        outs, _ = model.apply({"params": p}, jb[0], method="forward_with_loss",
                              mutable=["batch_stats"], rngs={"sample": key})
        return outs[1]["total"].mean()

    out = {"batches": batches, "params": jax.tree.map(np.asarray, params),
           "grads": jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))}
    conf = JConfig(merge(Config(torch_train.default_train_conf),
                         {"lr": LR, "lr_schedule": YAML.train.lr_schedule}).to_dict())
    tx, _ = jax_train.build_optimizer(conf, params, model, 4)
    opt_state = tx.init(params)
    step = jax.jit(jax_train.make_train_step(model, tx))
    variables, losses = {"params": params}, []
    for b in jb:
        variables, opt_state, ls, _, info = step(variables, opt_state, b, key)
        assert bool(info["ok"])
        losses.append({k: float(v) for k, v in ls.items()})
    out["losses"] = losses
    out["final"] = jax.tree.map(np.asarray, variables["params"])
    return out


def test_cached_batches_skip_the_extractor(jax_run, monkeypatch):
    """The batches carry padded caches; the pipeline never calls SuperPoint
    on them, and the depth GT finds positives."""
    model = get_model("two_view_pipeline").from_conf({k: v for k, v in MODEL.items() if k != "name"},
                                                     device="cpu")
    assert "extractor_model" not in jax_run["params"]  # JAX's init skipped it too
    monkeypatch.setattr(type(model.extractor), "forward", lambda *a, **k: pytest.fail("extractor ran"))
    for batch in jax_run["batches"]:
        for v in ("view0", "view1"):
            mask = batch[v]["cache"]["keypoint_mask"]
            assert mask.shape == (B, PAD) and (~mask).any() and mask.any()
        with torch.no_grad():
            pred = model(batch)
            gt = model.ground_truth({**batch, **pred})
        assert pred["keypoint_mask0"].shape == (B, PAD)
        assert (gt["gt_matches0"] >= 0).sum() >= 4
        assert (gt["gt_matches0"][~pred["keypoint_mask0"]] < 0).all()  # no padding slot matched


def test_two_cached_steps_match_jax(jax_run):
    model = get_model("two_view_pipeline").from_conf({k: v for k, v in MODEL.items() if k != "name"},
                                                     device="cpu")
    model.matcher.load_state_dict(from_jax_params(jax_run["params"]["matcher_model"], "lightglue",
                                                  num_heads=HEADS))
    conf = merge(Config(torch_train.default_train_conf), {"lr": LR, "lr_schedule": YAML.train.lr_schedule})
    opt, schedule = torch_train.build_optimizer(conf, model, 4)
    step = torch_train.TrainStep(model, opt, schedule, max_updates=STEPS)
    for i, (batch, want) in enumerate(zip(jax_run["batches"], jax_run["losses"])):
        losses, _, info = step(batch, torch.Generator().manual_seed(i))
        assert bool(info["ok"])
        assert {"total", "matcher_assignment_nll", "matcher_confidence"} <= set(want)
        for k, v in want.items():
            got = float(losses[k])
            assert abs(got - v) <= 1e-4 * max(abs(v), 1.0), (i, k, got, v)
        if i == 0:
            grads = from_jax_params(jax_run["grads"]["matcher_model"], "lightglue", num_heads=HEADS)
            gnorm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values())))
            assert gnorm > 0
            for name, p in model.matcher.named_parameters():
                err = float((p.grad - grads[name]).abs().max())
                assert err <= 1e-4 * gnorm, (name, err, gnorm)
    want = from_jax_params(jax_run["final"]["matcher_model"], "lightglue", num_heads=HEADS)
    for name, p in model.matcher.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 3 * LR * STEPS, name
