"""The port's on-device homography augmentation against the JAX package's
on the CPU: JAX's PRNG (`utils/threefry.py`), the corner sampler, both
warps, the photometric jitter, `generate_homography_pairs` and the
homography dataset's `emit_source` items. Inputs from numpy seeds; the JAX
functions jitted once each, as the trainer runs them; torch on one thread.

Tolerances:
- `split`, `fold_in`, `bits`, `uniform` (bounds included) and `permutation`
  bit-equal to `jax.random`; `normal` within 4 float32 ulps of its value
  (XLA's float32 log1p inside its erf_inv is not repeated);
- the sampler: the same convex candidate, rotation candidate and
  window-safety lambda for every item, the quads within 1e-3 px; an item
  whose deciding footprint lies within 1e-4 px of the window's limit may
  take the other lambda, and is counted and named, not dropped. H: the
  median item within 1e-5 relative (max |dH| / max |H|) and every item
  within 5e-4, because the DLT's float32 `eigh` leaves H off its float64
  value by up to 5e-5 in JAX itself (measured on these seeds);
- the warps on the same H: 1e-4 on white-noise images (a float32 ulp of a
  source coordinate, 3e-5 px at 320, times gradients of up to 1 a pixel),
  and the tiled warp's zeroed taps exactly where JAX's are; the jitter
  within 1e-5;
- `generate_homography_pairs`: H_0to1 within 1e-4 relative (two DLTs and an
  inverse); each view's pixels within 1e-4 plus twice the gap between the
  two packages' sampling points times the image's local slope (the float32
  DLTs' differences, median gap <= 1e-3 px, moved through the warp);
- `emit_source` items equal, the resized folder image within 1e-6.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.data import device_homography as J
from gluefactory_tpu.data.homographies import HomographyDataset as JaxDataset
from gluefactory_tpu.ops import warp as JW
from gluefactory_tpu_torch.data import device_homography as T
from gluefactory_tpu_torch.data.homographies import HomographyDataset, generate_synthetic_image
from gluefactory_tpu_torch.geometry.homography import warp_points
from gluefactory_tpu_torch.ops import warp as TW
from gluefactory_tpu_torch.ops.grid_sample import grid_sample_nd
from gluefactory_tpu_torch.utils import threefry

SEEDS = [0, 7, -3]
SOURCE, PATCH, BATCH = (320, 240), (160, 120), 16
NEAR = 1e-4  # px: a footprint this close to the window's limit may decide either way


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(5,), (2, 3, 5), (256, 64)]
BOUNDS = ((0.0, 1.0), (-0.3, 0.3), (2.0, 5.5))
SPLITS, FOLDS, PERMS = (1, 3, 32), (0, 7, 2**32 - 1), (1, 9, 5000)  # 5000: two sorting rounds


BASES = [np.linspace(-1, 1, n, dtype=np.float32) for n in PERMS]


@jax.jit
def _jax_draws(k, bases):
    """Every `jax.random` output the threefry test holds the port to, from
    one key (one compilation for all seeds)."""
    ks = jax.random.split(k, 5)
    kd = jax.random.key_data
    return {
        "split": [kd(jax.random.split(k, n)) for n in SPLITS],
        "fold_in": [kd(jax.random.fold_in(k, d)) for d in FOLDS],
        "bits": [jax.random.bits(ks[2], shape) for shape in SHAPES],
        "uniform": [[jax.random.uniform(ks[3], shape, minval=lo, maxval=hi) for lo, hi in BOUNDS]
                    for shape in SHAPES],
        "normal": [jax.random.normal(ks[4], shape) for shape in SHAPES],
        "vmap_bits": jax.vmap(lambda kk: jax.random.bits(kk, (3, 4)))(ks),
        "permutation": [jax.vmap(lambda kk, b=b: jax.random.permutation(kk, b))(ks) for b in bases],
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_draws(seed):
    want = jax.tree.map(lambda a: np.asarray(a), _jax_draws(jax.random.key(seed), BASES))
    for n, w in zip(SPLITS, want["split"]):
        np.testing.assert_array_equal(threefry.split(seed, n).numpy(), w.astype(np.int64))
    for d, w in zip(FOLDS, want["fold_in"]):
        np.testing.assert_array_equal(threefry.fold_in(seed, d).numpy(), w.astype(np.int64))
    kt = threefry.split(seed, 5)
    for i, shape in enumerate(SHAPES):
        np.testing.assert_array_equal(threefry.bits(kt[2], shape).numpy(), want["bits"][i].astype(np.int64))
        for (lo, hi), w in zip(BOUNDS, want["uniform"][i]):
            np.testing.assert_array_equal(threefry.uniform(kt[3], shape, minval=lo, maxval=hi).numpy(), w)
        got, w = threefry.normal(kt[4], shape).numpy(), want["normal"][i]
        assert (np.abs(got - w) <= 4 * np.spacing(np.abs(w))).all()
    # keys batched as jax.vmap batches them
    np.testing.assert_array_equal(threefry.bits(kt, (3, 4)).numpy(), want["vmap_bits"].astype(np.int64))
    for base, w in zip(BASES, want["permutation"]):
        np.testing.assert_array_equal(threefry.permutation(kt, torch.from_numpy(base)).numpy(), w)


def _jax_sampler_stages(rng, difficulty, max_angle):
    """The JAX sampler's outputs and decisions, by its own stages: quads and
    anchors, the convex and rotation candidates (-1: none), and each blend's
    homography of the window-safe sampler."""
    sw, sh = SOURCE
    norm = jnp.asarray([sw, sh], jnp.float32)
    k_pert, k_ang, _ = jax.random.split(rng, 3)
    frame = jnp.asarray(J.create_center_patch(SOURCE), jnp.float32)
    inner = jnp.asarray(J.create_center_patch(SOURCE, (sw * (1 - difficulty), sh * (1 - difficulty))),
                        jnp.float32)
    shrink = min(difficulty, 0.75)
    anchor = jnp.asarray(J.create_center_patch(SOURCE, (sw * (1 - shrink), sh * (1 - shrink))), jnp.float32)
    cands = frame + jax.random.uniform(k_pert, (4, BATCH, 4, 2)) * (inner - frame)
    ok = J._convex_mask(cands, norm)
    first = jnp.argmax(ok, 0)
    quad = jnp.where(ok.any(0)[:, None, None], jnp.take_along_axis(cands, first[None, :, None, None], 0)[0],
                     anchor)
    quad = quad + (inner.mean(0) - quad.mean(1))[:, None, :]
    limit = np.radians(max_angle) * difficulty
    base = jnp.linspace(-limit, limit, 10, dtype=jnp.float32)
    perm = jax.vmap(lambda k: jax.random.permutation(k, base)[:9])(jax.random.split(k_ang, BATCH))
    c = quad.mean(1, keepdims=True)
    d = quad - c
    cs, sn = jnp.cos(perm)[:, :, None], jnp.sin(perm)[:, :, None]
    rot = jnp.stack([d[:, None, :, 0] * cs + d[:, None, :, 1] * sn,
                     d[:, None, :, 1] * cs - d[:, None, :, 0] * sn], -1) + c[:, None]
    inside = jnp.all((rot / norm >= 0) & (rot / norm < 1), axis=(-2, -1))
    q, a = J.sample_corner_quads(rng, BATCH, SOURCE, difficulty, 1.0, max_angle=max_angle)
    corners = J._patch_corners(BATCH, PATCH)
    blends = [J.compute_homography_dlt(a + lam * (q - a), corners) for lam in T.LAMBDAS]
    return {"quad": q, "anchor": a, "convex": jnp.where(ok.any(0), first, -1),
            "rotation": jnp.where(inside.any(1), jnp.argmax(inside, 1), -1),
            "blends": jnp.stack(blends), "footprints": jnp.stack([jnp.stack(J._max_tile_footprint(h, PATCH))
                                                                   for h in blends]),
            "H": J.sample_corner_homographies(rng, BATCH, SOURCE, PATCH, difficulty, max_angle=max_angle)}


_jax_sampler = jax.jit(_jax_sampler_stages, static_argnums=(1, 2))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max(axis=(-2, -1)) / np.abs(b).max(axis=(-2, -1))


_window_safe = jax.jit(J._sample_window_safe_homography, static_argnums=(1, 2, 3, 4, 5, 6),
                       static_argnames=("max_angle",))
_corner_h = jax.jit(J.sample_corner_homographies, static_argnums=(1, 2, 3, 4),
                    static_argnames=("max_angle",))


# each difficulty and each max_angle (one JAX compilation a pair)
@pytest.mark.parametrize("difficulty,max_angle", [(0.5, 45.0), (0.7, 90.0), (1.0, 45.0), (1.0, 90.0)])
def test_sampler_matches_jax(difficulty, max_angle):
    window = T.tiled_window(SOURCE[::-1], PATCH)
    limits = np.asarray([window[0] - 3.0, window[1] - 3.0])[:, None]
    seed = 0
    ref = {k: np.asarray(v) for k, v in _jax_sampler(jax.random.key(seed), difficulty, max_angle).items()}
    picks = {}
    tq, ta = T.sample_corner_quads(seed, BATCH, SOURCE, difficulty, 1.0, max_angle=max_angle, picks=picks)
    np.testing.assert_array_equal(picks["convex"].numpy(), ref["convex"])
    np.testing.assert_array_equal(picks["rotation"].numpy(), ref["rotation"])
    np.testing.assert_allclose(tq.numpy(), ref["quad"], atol=1e-3)
    np.testing.assert_allclose(ta.numpy(), ref["anchor"], atol=1e-3)
    # JAX's lambda: the first blend whose footprints (fh, fw) fit the limits
    fits = (ref["footprints"] <= limits).all(1)  # (blends, B)
    lam_j = np.asarray(T.LAMBDAS)[fits.argmax(0)]
    margin = np.abs(ref["footprints"] - limits).min(1)  # each blend's closest margin
    tried = np.arange(len(T.LAMBDAS))[:, None] <= fits.argmax(0)  # the blends that decided
    near = ((margin <= NEAR) & tried).any(0)
    details = {}
    W_t = T._sample_window_safe_homography(seed, BATCH, SOURCE, PATCH, difficulty, 1.0, window,
                                           max_angle=max_angle, details=details).numpy()
    lam_t = details["lambda"].numpy()
    named = [(int(i), float(lam_j[i]), float(lam_t[i])) for i in np.flatnonzero(near)]
    print(f"difficulty {difficulty}, max_angle {max_angle}: lambdas {lam_t.tolist()}; {len(named)} items "
          f"within {NEAR} px of the window's limit (item, JAX lambda, port lambda): {named}")
    assert not ((lam_t != lam_j) & ~near).any(), (lam_j, lam_t)
    same = lam_t == lam_j
    W_j = ref["blends"][fits.argmax(0), np.arange(BATCH)]  # JAX's pick among its blends
    H_t = T.sample_corner_homographies(seed, BATCH, SOURCE, PATCH, difficulty, max_angle=max_angle).numpy()
    for got, want in ((H_t, ref["H"]), (W_t[same], W_j[same])):
        rel = _rel(got, want)
        assert np.median(rel) <= 1e-5 and rel.max() <= 5e-4, rel


def _noise(seed, shape=(2, 240, 320, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


_warp = jax.jit(JW.warp_perspective, static_argnums=2)
_warp_tiled = jax.jit(JW.warp_perspective_tiled, static_argnums=(2, 3, 4))
_jitter = jax.jit(JW.photometric_jitter, static_argnums=2)


@pytest.mark.parametrize("window", ["sampler", (24, 128)], ids=["sampler_window", "tight_window"])
def test_warps_match_jax(window):
    img = _noise(1)
    H = np.asarray(_corner_h(jax.random.key(3), 2, SOURCE, PATCH, 0.7))
    Ht = torch.from_numpy(H.copy())
    win = T.tiled_window(SOURCE[::-1], PATCH) if window == "sampler" else window
    gather = TW.warp_perspective(torch.from_numpy(img), Ht, PATCH).numpy()
    np.testing.assert_allclose(gather, np.asarray(_warp(jnp.asarray(img), H, PATCH)), atol=1e-4)
    got = TW.warp_perspective_tiled(torch.from_numpy(img), Ht, PATCH, window=win).numpy()
    want = np.asarray(_warp_tiled(jnp.asarray(img), H, PATCH, (16, 128), win))
    np.testing.assert_allclose(got, want, atol=1e-4)
    zeroed = np.abs(gather - want).max(-1) > 1e-3  # taps outside a tile's window
    if window == "sampler":
        assert not zeroed.any()
    else:  # the contract: a window too small drops the taps outside it, in both packages
        assert zeroed.mean() > 0.1
        np.testing.assert_array_equal(np.abs(gather - got).max(-1) > 1e-3, zeroed)


@pytest.mark.parametrize("strength", [0.5, 1.0])
def test_photometric_jitter_matches_jax(strength):
    img = _noise(2, (3, 48, 64, 3))
    got = TW.photometric_jitter(torch.from_numpy(img), 5, strength).numpy()
    np.testing.assert_allclose(got, np.asarray(_jitter(jnp.asarray(img), jax.random.key(5), strength)),
                               atol=1e-5)


def _sources(n=2, size=SOURCE):
    return np.stack([generate_synthetic_image(i, size) for i in range(n)]).astype(np.float32)


_pairs = jax.jit(J.generate_homography_pairs, static_argnums=(2, 3, 4, 5, 6),
                 static_argnames=("max_angle",))


@pytest.mark.parametrize("warp_impl", ["gather"])
def test_generate_homography_pairs_matches_jax(warp_impl):
    """The gather route here; the tiled route (the trainer's) is held to
    JAX's `apply_device_augment` in `tests/test_torch_device_augment_train.py`
    with the same checks."""
    src = _sources(3)
    want = _pairs(jnp.asarray(src), jax.random.key(4), PATCH, 0.7, 1.0, 0.5, warp_impl, max_angle=45.0)
    got = T.generate_homography_pairs(torch.from_numpy(src), 4, PATCH, 0.7, 1.0, 0.5, warp_impl,
                                      max_angle=45.0)
    assert _rel(got["H_0to1"].numpy(), want["H_0to1"]).max() <= 1e-4
    # each view's homography, to map its pixels: JAX's key chain gives k0 / k1
    k0, k1 = jax.random.split(jax.random.key(4), 4)[:2]
    win = T.tiled_window(SOURCE[::-1], PATCH)
    for view, k, tk in (("view0", k0, threefry.split(4, 4)[0]), ("view1", k1, threefry.split(4, 4)[1])):
        if warp_impl == "tiled":
            Hj = _window_safe(k, 3, SOURCE, PATCH, 0.7, 1.0, win, max_angle=45.0)
            Ht = T._sample_window_safe_homography(tk, 3, SOURCE, PATCH, 0.7, 1.0, win, max_angle=45.0)
        else:
            Hj = _corner_h(k, 3, SOURCE, PATCH, 0.7, max_angle=45.0)
            Ht = T.sample_corner_homographies(tk, 3, SOURCE, PATCH, 0.7, max_angle=45.0)
        xs, ys = np.meshgrid(np.arange(PATCH[0]) + 0.5, np.arange(PATCH[1]) + 0.5)
        pts = torch.from_numpy(np.stack([xs, ys], -1).reshape(1, -1, 2).astype(np.float32)).expand(3, -1, 2)
        gap = (warp_points(pts, Ht, inverse=True)
               - warp_points(pts, torch.from_numpy(np.asarray(Hj)), inverse=True)).norm(dim=-1)
        gap = gap.reshape(3, PATCH[1], PATCH[0], 1).numpy()
        a, b = got[view]["image"].numpy(), np.asarray(want[view]["image"])
        # first order: a pixel moves by its sampling point's gap times the
        # image's local slope (the largest step to a neighbour)
        pad = np.pad(b, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
        slope = np.max([np.abs(pad[:, 1:-1, 2:] - b), np.abs(pad[:, 1:-1, :-2] - b),
                        np.abs(pad[:, 2:, 1:-1] - b), np.abs(pad[:, :-2, 1:-1] - b)], axis=0)
        assert np.median(gap) <= 1e-3
        assert (np.abs(a - b) <= 1e-4 + 2 * gap * slope).all()
        np.testing.assert_array_equal(got[view]["image_size"].numpy(), np.asarray(want[view]["image_size"]))


def test_cross_view_photoconsistency():
    """A point of view0 mapped by H_0to1 sees the same content in view1 (no
    jitter): the median difference below 0.05."""
    src = _sources(2)
    batch = T.generate_homography_pairs(torch.from_numpy(src), 1, PATCH, 0.4, photometric_strength=0.0)
    pts0 = torch.from_numpy(np.random.default_rng(0).uniform(30, 90, (2, 200, 2)).astype(np.float32))
    pts1 = warp_points(pts0, batch["H_0to1"])
    inb = ((pts1[..., 0] > 2) & (pts1[..., 0] < 158) & (pts1[..., 1] > 2) & (pts1[..., 1] < 118)).numpy()
    v0 = grid_sample_nd(batch["view0"]["image"], pts0).numpy()
    v1 = grid_sample_nd(batch["view1"]["image"], pts1).numpy()
    assert inb.mean() > 0.5
    assert np.median(np.abs(v0 - v1)[inb]) < 0.05


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("sources")
    for i, size in enumerate(((200, 150), (160, 120), (90, 60))):  # larger, equal, smaller
        img = (generate_synthetic_image(20 + i, size) * 255).astype(np.uint8)[..., ::-1]
        cv2.imwrite(str(d / f"im{i}.png"), img)
    return d


@pytest.mark.parametrize("source", ["synthetic", "folder"])
def test_emit_source_items_match_jax(source, folder):
    conf = {"source_size": [160, 120], "train_size": 3, "val_size": 1, "emit_source": True}
    conf.update({"synthetic_images": 4} if source == "synthetic" else {"image_dir": str(folder), "val_size": 0})
    ours, theirs = HomographyDataset(conf).get_dataset("train"), JaxDataset(conf).get_dataset("train")
    assert len(ours) == len(theirs) == 3
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got.keys() == want.keys() == {"source_image", "idx", "name"}
        assert got["idx"] == want["idx"] and got["name"] == want["name"]
        assert got["source_image"].dtype == np.float32 and got["source_image"].shape == (120, 160, 3)
        assert np.abs(got["source_image"] - want["source_image"]).max() <= 1e-6
