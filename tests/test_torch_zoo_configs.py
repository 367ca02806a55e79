"""The shipped configs of the extractor zoo (ALIKED, DISK, SuperPoint-open
and SIFT, with the NN matcher or LightGlue) and LoFTR in the port: each
resolves by name as the train and eval CLIs resolve `--conf`, holds the
JAX package's YAML data, and builds and runs in every section (SIFT with
its shipped opencv backend, here on the host's cv2)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import gluefactory_tpu
from gluefactory_tpu.core.config import from_yaml as jax_from_yaml
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.core.config import from_yaml, merge
from gluefactory_tpu_torch.eval.io import extract_benchmark_conf, parse_config_path
from gluefactory_tpu_torch.models import get_model

CONFIGS = [f"{e}+{m}" for e in ("aliked", "disk")
           for m in ("NN", "lightglue-official", "lightglue_homography", "lightglue_megadepth")]
CONFIGS += [f"superpoint-open+{m}" for m in ("NN", "lightglue_homography", "lightglue_megadepth")]
CONFIGS += [f"sift+{m}" for m in ("NN", "lightglue-official", "lightglue_homography", "lightglue_megadepth")]
CONFIGS += ["loftr"]
# the JAX SuperPoint's int8 / space-to-depth serving options: the port's
# SuperPoint (and SuperPoint-open, its subclass) carries them too
SERVING_KEYS = ("quantize", "s2d_block1")
DESC_DIM = {"aliked": 128, "disk": 128, "superpoint_open": 256, "sift": 128}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this file's tests: the suite runs in several
    worker processes at once, where each process's default of one thread
    a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_resolves_by_name_and_runs(name):
    """`parse_config_path` (the train and eval CLIs' `--conf`) finds the
    port's copy, which holds the JAX package's YAML data key for key; the
    extractor's conf merged with its defaults equals the JAX model's; the
    model of each section builds, and a forward at 64 x 96 (64 keypoints)
    gives descriptors of the width the matcher takes."""
    path = parse_config_path(name)
    assert path.parent.name == "configs" and path.parent.parent.name == "gluefactory_tpu_torch"
    jax_conf = jax_from_yaml(str(Path(gluefactory_tpu.__file__).parent / "configs" / f"{name}.yaml"))
    conf = from_yaml(str(path))
    assert conf.to_dict() == jax_conf.to_dict()
    # the component that holds the config's model: its extractor, else (LoFTR) its matcher
    comp = "extractor" if conf.model.get("extractor") else "matcher"
    sub_conf = conf.model[comp]
    sub = {k: v for k, v in sub_conf.to_dict().items() if k != "name"}
    want = jax_get_model(sub_conf.name).from_conf(sub).conf.to_dict()
    got = get_model(sub_conf.name).resolve_conf(sub).to_dict()
    assert got == want
    assert all(k in got for k in SERVING_KEYS) == sub_conf.name.startswith("superpoint")
    # 64 slots: keypoints, or LoFTR's matches (its 8 x 12 coarse cells here hold fewer than 2048)
    cut = {comp: {"max_num_keypoints" if comp == "extractor" else "max_num_matches": 64}}
    sections = [conf] + [extract_benchmark_conf(conf, b) for b in conf.get("benchmarks", {})]
    for section in sections:
        mconf = merge(section.model, cut).to_dict()
        torch.manual_seed(0)
        model = get_model("two_view_pipeline").from_conf(
            {k: v for k, v in mconf.items() if k != "name"}, device="cpu").eval()
        rng = np.random.default_rng(0)
        views = {f"view{i}": {"image": torch.from_numpy(rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)),
                              "image_size": torch.tensor([[96.0, 64.0]])} for i in "01"}
        with torch.no_grad():
            pred = model(views)
        assert torch.isfinite(pred["keypoints0"]).all() and "matches0" in pred
        if comp == "extractor":
            assert model.extractor.conf.max_num_keypoints == 64
            assert pred["descriptors0"].shape == (1, 64, DESC_DIM[sub_conf.name])
            assert torch.isfinite(pred["descriptors0"]).all()
        else:
            assert pred["keypoints0"].shape == (1, 64, 2)
