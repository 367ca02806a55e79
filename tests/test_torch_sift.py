"""The port's SIFT (`ops/sift.py`, `models/extractors/sift.py`,
`sift_kornia.py`) against the JAX package's on the same seeded images.

Per stage, on the same inputs (the JAX stage's own inputs fed to both):
1e-5 absolute on [0, 1] images (float32 sums in another order); the
extremum mask equal wherever no deciding comparison lies within 1e-6 of a
tie, and patches equal. Whole `sift_detect`, from the image: the blur's
float32 sums differ by ~5e-7 between XLA and torch, and a DoG extremum's
Newton step carries that into its position, so the test asks at least
98% of JAX's valid keypoints to have a port keypoint within 1e-3 px; for
those, scales within 1e-3 relative, and scales (relative), orientations
(mod 2 pi) and descriptors within 1e-4 on at least 90% of them (the rest
are ill-conditioned extrema, or keypoints whose smoothed orientation
histogram has near-equal bins, where the blur's rounding moves the peak;
the test prints how many). The host
backend (cv2 5.0) is bit-equal to the JAX package's `extract_sift_host`.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.extractors import sift as jax_sift_model
from gluefactory_tpu.ops import sift_jax
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors import sift as port_sift_model
from gluefactory_tpu_torch.ops import sift as port_sift

TOL = 1e-5
SIZE = (160, 120)  # (w, h)
K = 256
THRESH = 0.0066  # the shipped configs' detection threshold


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this file's tests: the suite runs in several
    worker processes at once, where each process's default of one thread
    a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def textured(seed: int, w: int, h: int, n: int = 40) -> np.ndarray:
    """A grey [0, 1] image of random discs and boxes over a smooth noise
    texture: blobs and corners at every scale SIFT looks at."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 0.5, np.float32)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(n):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(2, min(w, h) / 6)
        if rng.random() < 0.5:
            m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        else:
            m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r * rng.uniform(0.3, 1))
        img[m] = rng.uniform(0, 1)
    noise = rng.normal(0, 1, (h // 4 + 2, w // 4 + 2))
    up = np.kron(noise, np.ones((4, 4)))[:h, :w]
    return np.clip(0.8 * img + 0.1 * up + 0.1, 0, 1).astype(np.float32)


def _images(B=2, size=SIZE):
    return np.stack([textured(s, *size) for s in range(B)])


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def octave():
    """JAX's first octave of image 0, the candidates of its extremum mask
    and their refinement, patches and gradient maps (each stage's inputs)."""
    img = _images()[:1]
    x = np.asarray(sift_jax.gaussian_blur(jnp.asarray(img), np.sqrt(1.6**2 - 0.25)))
    gauss, dogs = (np.asarray(a) for a in sift_jax.build_octave(jnp.asarray(x), 3, 1.6))
    mask = np.asarray(sift_jax.find_extrema_mask(jnp.asarray(dogs), 0.5 * THRESH / 3))
    _, s, y, xx = np.nonzero(mask)
    off, value, edge = (np.asarray(a) for a in sift_jax._quad_refine(
        jnp.asarray(dogs[0]), jnp.asarray(s), jnp.asarray(y), jnp.asarray(xx)))
    sig = (1.6 * 2.0 ** ((s + off[:, 2]) / 3)).astype(np.float32)
    patch = np.asarray(sift_jax._extract_patches(jnp.asarray(gauss[0]), jnp.asarray(s + 1),
                                                 jnp.asarray(y), jnp.asarray(xx), port_sift.RADIUS))
    mag, ang = (np.asarray(a) for a in sift_jax._patch_grads(jnp.asarray(patch)))
    theta = np.asarray(sift_jax._orientation(jnp.asarray(mag), jnp.asarray(ang), jnp.asarray(sig),
                                             port_sift.RADIUS))
    return {"x": x, "gauss": gauss, "dogs": dogs, "mask": mask, "s": s, "y": y, "xx": xx,
            "off": off, "value": value, "edge": edge, "sig": sig, "patch": patch, "mag": mag,
            "ang": ang, "theta": theta}


@pytest.mark.parametrize("sigma", [0.0, 1.2490, 2.2268, 3.0902])
def test_gaussian_blur(sigma):
    img = _images()
    want = np.asarray(sift_jax.gaussian_blur(jnp.asarray(img), sigma))
    got = port_sift.gaussian_blur(_t(img), sigma).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_build_octave(octave):
    gauss, dogs = port_sift.build_octave(_t(octave["x"]), 3, 1.6)
    np.testing.assert_allclose(gauss.numpy(), octave["gauss"], atol=TOL, rtol=0)
    np.testing.assert_allclose(dogs.numpy(), octave["dogs"], atol=TOL, rtol=0)


def test_find_extrema_mask(octave):
    dogs = octave["dogs"]
    got = port_sift.find_extrema_mask(_t(dogs), 0.5 * THRESH / 3).numpy()
    # a site whose deciding comparison (a neighbour or the threshold) is
    # within 1e-6 of a tie may go either way
    c = dogs[:, 1:-1]
    gap = np.abs(np.abs(c) - 0.5 * THRESH / 3)
    for ds in (-1, 0, 1):
        plane = dogs[:, 1 + ds:dogs.shape[1] - 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds or dy or dx:
                    gap = np.minimum(gap, np.abs(c - np.roll(plane, (-dy, -dx), (-2, -1))))
    near = gap <= 1e-6
    print(f"extremum mask: {int(octave['mask'].sum())} sites, {int(near.sum())} within 1e-6 of a tie")
    assert octave["mask"].sum() >= 20
    np.testing.assert_array_equal(got[~near], octave["mask"][~near])


def test_quad_refine(octave):
    off, value, edge = port_sift._quad_refine(_t(octave["dogs"][:1]), _t(octave["s"])[None],
                                              _t(octave["y"])[None], _t(octave["xx"])[None])
    np.testing.assert_allclose(off[0].numpy(), octave["off"], atol=TOL, rtol=0)
    np.testing.assert_allclose(value[0].numpy(), octave["value"], atol=TOL, rtol=0)
    np.testing.assert_array_equal(edge[0].numpy(), octave["edge"])


def test_quad_refine_singular_hessian():
    """A flat neighbourhood (H = 0): JAX's solve gives non-finite values that
    the |det| mask replaces by 0; torch's LU does likewise without raising."""
    dogs = np.zeros((1, 5, 8, 8), np.float32)
    dogs[0, 2, 4, 4] = 1e-3
    dogs[0, 2, 4, 3] = dogs[0, 2, 4, 5] = dogs[0, 2, 3, 4] = dogs[0, 2, 5, 4] = 1e-3
    dogs[0, 1, 4, 4] = dogs[0, 3, 4, 4] = 1e-3
    idx = [np.array([1]), np.array([4]), np.array([4])]
    want = sift_jax._quad_refine(jnp.asarray(dogs[0]), *(jnp.asarray(i) for i in idx))
    got = port_sift._quad_refine(_t(dogs), *(_t(i)[None] for i in idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert (got[0] == 0).all()


def test_extract_patches_and_grads(octave):
    lvl = _t(octave["s"] + 1)[None]
    patch = port_sift._extract_patches(_t(octave["gauss"][:1]), lvl, _t(octave["y"])[None],
                                       _t(octave["xx"])[None], port_sift.RADIUS)[0]
    np.testing.assert_array_equal(patch.numpy(), octave["patch"])
    # a window at the corner reaches into the zero padding
    corner = port_sift._extract_patches(_t(octave["gauss"][:1]), _t([[1]]), _t([[1]]), _t([[1]]), 20)
    want = np.asarray(sift_jax._extract_patches(jnp.asarray(octave["gauss"][0]), jnp.asarray([1]),
                                                jnp.asarray([1]), jnp.asarray([1]), 20))
    np.testing.assert_array_equal(corner[0].numpy(), want)
    mag, ang = port_sift._patch_grads(_t(octave["patch"]))
    np.testing.assert_allclose(mag.numpy(), octave["mag"], atol=TOL, rtol=0)
    np.testing.assert_allclose(ang.numpy(), octave["ang"], atol=TOL, rtol=0)


def test_orientation_and_descriptor(octave):
    mag, ang, sig = _t(octave["mag"]), _t(octave["ang"]), _t(octave["sig"])
    theta = port_sift._orientation(mag, ang, sig, port_sift.RADIUS)
    np.testing.assert_allclose(theta.numpy(), octave["theta"], atol=TOL, rtol=0)
    want = np.asarray(sift_jax._descriptor(jnp.asarray(octave["mag"]), jnp.asarray(octave["ang"]),
                                           jnp.asarray(octave["sig"]), jnp.asarray(octave["theta"]),
                                           port_sift.RADIUS))
    got = port_sift._descriptor(mag, ang, sig, _t(octave["theta"]), port_sift.RADIUS)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def _agreement(ref: dict, out: dict, label: str) -> None:
    """The whole-pipeline criteria of the module docstring, pooled over the
    batch, on valid slots only."""
    n_ref = n_hit = n_close = 0
    for b in range(ref["keypoints"].shape[0]):
        vj, vt = ref["keypoint_mask"][b], out["keypoint_mask"][b]
        kj, kt = ref["keypoints"][b][vj], out["keypoints"][b][vt]
        d = np.linalg.norm(kj[:, None] - kt[None], axis=-1)
        nn, dist = d.argmin(1), d.min(1)
        hit = dist <= 1e-3
        n_ref, n_hit = n_ref + len(kj), n_hit + int(hit.sum())
        sj, st = ref["scales"][b][vj][hit], out["scales"][b][vt][nn[hit]]
        np.testing.assert_allclose(st, sj, rtol=1e-3, atol=0, err_msg=f"{label} scales")
        dori = np.angle(np.exp(1j * (ref["oris"][b][vj][hit] - out["oris"][b][vt][nn[hit]])))
        ddesc = np.abs(ref["descriptors"][b][vj][hit] - out["descriptors"][b][vt][nn[hit]]).max(-1)
        close = (np.abs(st - sj) <= 1e-4 * sj) & (np.abs(dori) <= 1e-4) & (ddesc <= 1e-4)
        n_close += int(close.sum())
    print(f"{label}: {n_hit} of {n_ref} JAX keypoints within 1e-3 px, {n_close} of them with "
          f"scale, orientation and descriptor within 1e-4")
    assert n_ref >= 40 and n_hit >= 0.98 * n_ref
    assert n_close >= 0.9 * n_hit


@pytest.fixture(scope="module")
def jax_extractor():
    """The JAX SIFT model, device backend, raw descriptors, on RGB images."""
    conf = {"backend": "jax", "max_num_keypoints": K, "detection_threshold": THRESH,
            "rootsift": False}
    rgb = np.repeat(_images()[..., None], 3, axis=-1)
    model = jax_get_model("sift").from_conf(conf)
    out = jax.jit(model.apply)({"params": {}}, {"image": jnp.asarray(rgb)})
    return conf, rgb, {k: np.asarray(v) for k, v in out.items()}


def test_sift_detect_whole(jax_extractor):
    conf, rgb, ref = jax_extractor
    model = get_model("sift").from_conf(conf, device="cpu")
    with torch.no_grad():
        out = {k: v.numpy() for k, v in model({"image": _t(rgb)}).items()}
    assert out["descriptors"].shape == (2, K, 128) and out["keypoint_mask"].dtype == np.bool_
    _agreement(ref, out, "sift_detect")
    valid = out["keypoint_mask"]
    np.testing.assert_allclose(np.linalg.norm(out["descriptors"][valid], axis=-1), 1.0, atol=1e-5)
    assert (out["keypoint_scores"][~valid] == 0).all() and (out["scales"][valid] > 0).all()
    assert ((out["keypoints"][valid] >= 0) & (out["keypoints"][valid] <= np.array(SIZE))).all()


def test_signed_rootsift_and_threshold_floor():
    """The device branch's signed RootSIFT on `sift_detect`'s descriptors,
    the grey weights and the threshold's 1e-4 floor, as the JAX model's."""
    img = _images(1)
    rgb = np.repeat(img[..., None], 3, axis=-1)
    model = get_model("sift").from_conf({"backend": "jax", "max_num_keypoints": 64,
                                         "detection_threshold": 0.0}, device="cpu")
    with torch.no_grad():
        out = model({"image": _t(rgb)})
    grey = (_t(rgb) * torch.tensor([0.299, 0.587, 0.114])).sum(-1)
    raw = port_sift.sift_detect(grey, 64, contrast_thresh=1e-4)
    d = raw["descriptors"]
    want = torch.sqrt(d.abs() / d.abs().sum(-1, keepdim=True).clamp(min=1e-8)) * torch.sign(d)
    torch.testing.assert_close(out["descriptors"], want, rtol=0, atol=0)
    torch.testing.assert_close(out["keypoints"], raw["keypoints"], rtol=0, atol=0)


def test_double_image():
    """`double_image`: the bilinear 2x upsampling (half-pixel centres, as
    `jax.image.resize(..., "linear")`), then the pipeline on it."""
    img = _images(1, (64, 48))
    want = np.asarray(jax.image.resize(jnp.asarray(img), (1, 96, 128), "linear"))
    got = torch.nn.functional.interpolate(_t(img)[:, None], size=(96, 128), mode="bilinear",
                                          align_corners=False)[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    kw = {"contrast_thresh": THRESH, "double_image": True}
    ref = {k: np.asarray(v) for k, v in sift_jax.sift_detect(jnp.asarray(img), 128, **kw).items()}
    out = {k: v.numpy() for k, v in port_sift.sift_detect(_t(img), 128, **kw).items()}
    _agreement(ref, out, "double_image")


def test_force_num_keypoints_fills_from_the_generator():
    img = _images(2, (64, 48))
    conf = {"backend": "jax", "max_num_keypoints": 128, "detection_threshold": 0.02}
    plain = get_model("sift").from_conf(conf, device="cpu")
    forced = get_model("sift").from_conf({**conf, "force_num_keypoints": True}, device="cpu")
    size = torch.tensor([[60.0, 40.0], [64.0, 48.0]])
    data = {"image": _t(img)[..., None], "image_size": size}
    with torch.no_grad():
        a = plain(data)
        b = forced(data, generator=torch.Generator().manual_seed(3))
        c = forced(data, generator=torch.Generator().manual_seed(3))
    valid = a["keypoint_mask"]
    assert (~valid).any() and b["keypoint_mask"].all()
    torch.testing.assert_close(b["keypoints"][valid], a["keypoints"][valid], rtol=0, atol=0)
    fill = b["keypoints"][~valid]
    lim = size[:, None].expand(-1, 128, -1)[~valid]
    assert ((fill >= 0) & (fill <= lim)).all()
    torch.testing.assert_close(b["keypoints"], c["keypoints"], rtol=0, atol=0)


@pytest.mark.parametrize("rootsift,nms", [(True, 3), (False, 0)])
def test_host_backend_bit_equal(rootsift, nms):
    """cv2's SIFT through the port's copy of the host helpers and through
    the port's model: bit-equal to the JAX package's `extract_sift_host`."""
    imgs = np.repeat(_images()[..., None], 3, axis=-1)
    args = (imgs, 128, THRESH, nms, rootsift)
    want = jax_sift_model.extract_sift_host(*args)
    got = port_sift_model.extract_sift_host(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    model = get_model("sift").from_conf({"max_num_keypoints": 128, "nms_radius": nms,
                                         "rootsift": rootsift}, device="cpu")
    assert model.conf.backend == "opencv"
    with torch.no_grad():
        out = model({"image": _t(imgs)})
    for k, w in zip(("keypoints", "keypoint_scores", "scales", "oris", "descriptors", "keypoint_mask"),
                    want):
        np.testing.assert_array_equal(out[k].numpy(), w, err_msg=k)


def test_opencv_backend_without_cv2_raises(monkeypatch):
    """Where cv2 is absent (the card's machine) the opencv backend raises,
    naming cv2 and the device backend; it does not fall back."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    model = get_model("sift").from_conf({"max_num_keypoints": 16}, device="cpu")
    with pytest.raises(ImportError, match=r"cv2.*extractor\.backend=jax"):
        model({"image": _t(_images(1, (32, 24)))[..., None]})


def test_sift_kornia_pins_the_device_backend():
    cls = get_model("sift_kornia")
    conf = cls.resolve_conf({"max_num_keypoints": 32})
    assert conf.backend == "jax" and conf.rootsift and issubclass(cls, port_sift_model.SIFT)
    jax_conf = jax_get_model("sift_kornia").from_conf({"max_num_keypoints": 32}).conf
    assert cls.resolve_conf().to_dict() == {**jax_get_model("sift_kornia").from_conf({}).conf.to_dict()}
    assert conf.to_dict() == jax_conf.to_dict()
    with pytest.raises(ValueError, match="backend"):
        get_model("sift").from_conf({"backend": "pycolmap"}, device="cpu")
