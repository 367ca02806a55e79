"""`utils/benchmark.py` and `utils/patches.py` of the port against the JAX
package's on the CPU: patches and heatmaps bit-equal on seeded keypoints
(half-pixel ties, borders and points outside the image included), the
benchmark's dict and its CPU clock."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.utils import benchmark as jbench
from gluefactory_tpu.utils import patches as jpatches
from gluefactory_tpu_torch.utils import benchmark as tbench
from gluefactory_tpu_torch.utils import patches as tpatches

torch.set_num_threads(1)


def _keypoints(seed, B=2, N=40, H=30, W=40):
    rng = np.random.default_rng(seed)
    k = rng.uniform(-3, [W + 3, H + 3], (B, N, 2)).astype(np.float32)
    k[:, :6] = np.floor(k[:, :6]) + 0.5  # pixel centres: round(k - 0.5) on an integer
    k[:, 6:12] = np.floor(k[:, 6:12])  # half-way: round half to even
    return k


@pytest.mark.parametrize("radius", [1, 3])
def test_extract_patches_equals_jax(radius):
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, 30, 40, 3)).astype(np.float32)
    k = _keypoints(1)
    pj, vj = jax.jit(jpatches.extract_patches, static_argnums=2)(image, k, radius)
    pt, vt = tpatches.extract_patches(torch.from_numpy(image), torch.from_numpy(k), radius)
    assert pt.shape == (2, 40, 2 * radius + 1, 2 * radius + 1, 3)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert 0 < vt.float().mean() < 1


@pytest.mark.parametrize("with_scores", [False, True])
def test_build_heatmap_equals_jax(with_scores):
    k = _keypoints(2)
    k[0, 20:24] = k[0, 19]  # repeated keypoints add up
    scores = np.random.default_rng(3).uniform(0, 1, k.shape[:2]).astype(np.float32) if with_scores else None
    hj = jpatches.build_heatmap((2, 30, 40), jnp.asarray(k), None if scores is None else jnp.asarray(scores))
    ht = tpatches.build_heatmap((2, 30, 40), torch.from_numpy(k),
                                None if scores is None else torch.from_numpy(scores))
    # sums of up to five f32 scores a pixel, in another order
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6, atol=1e-7)
    assert ht.sum().item() == pytest.approx(40 * 2 if scores is None else float(scores.sum()), rel=1e-6)


def test_benchmark_returns_the_jax_dict_on_the_cpu():
    x = torch.ones(64, 64)
    calls = []
    out = tbench.benchmark(lambda a: calls.append(1) or a @ a, (x,), warmup=2, reps=5)
    want = jbench.benchmark(lambda a: a @ a, (jnp.ones((64, 64)),), warmup=2, reps=5)
    assert set(out) == set(want) == {"mean", "std", "reps"}
    assert out["reps"] == 5 and len(calls) == 7
    assert out["mean"] > 0 and out["std"] >= 0


def test_benchmark_finds_the_device_in_nested_inputs():
    assert tbench._first_device([1, {"a": [torch.zeros(1)]}]) == torch.device("cpu")
    assert tbench._first_device([1, "x"]) is None


def test_write_megadepth_scenes_equals_one_scene_at_a_time(tmp_path):
    """Several scenes rendered as one list of views (one pool of render
    processes on the card's host; in process here, since forking this
    JAX-threaded process can deadlock) write what `write_megadepth_scene`
    writes scene by scene."""
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scene, write_megadepth_scenes

    seeds = {"s0": 0, "s1": 5}
    together = write_megadepth_scenes(tmp_path / "a", seeds, n_views=3, size=(64, 48))
    for scene, seed in seeds.items():
        alone = write_megadepth_scene(tmp_path / "b", scene, n_views=3, size=(64, 48), seed=seed)
        assert together[scene] == alone
        a, b = (np.load(tmp_path / d / "scene_info" / f"{scene}.npz", allow_pickle=True) for d in "ab")
        for k in ("image_paths", "depth_paths", "poses", "intrinsics", "overlap_matrix"):
            np.testing.assert_array_equal(a[k], b[k])
