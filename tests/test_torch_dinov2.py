"""The port's DINOv2 backbone (`models/backbones/dinov2.py`) against the JAX
package's on the same seeded images and weights: torch's seeded init
under the official torch-hub names (the LayerScales and LayerNorms drawn
away from their constant init), taken into the JAX package by its
`convert_dinov2` and back by `from_jax_params`.

Narrow widths (embed 32, 2 blocks, 2 heads; the pretraining grid of 37 x
37 kept). Tolerance 1e-5 on the features, cls token and descriptors
(float32 sums of up to 14 x 14 x 3 and 128 products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_dinov2
from gluefactory_tpu.models.backbones.dinov2 import DinoV2 as JaxDinoV2
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model

NARROW = {"embed_dim": 32, "depth": 2, "num_heads": 2}
CASES = {  # (registers, allow_resize, (H, W))
    "bicubic_grid": (0, False, (70, 98)),  # a 5 x 7 grid: the bicubic position path
    "allow_resize_registers": (4, True, (75, 101)),  # not multiples of 14: the nearest gather
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this file's tests: the suite runs in several
    worker processes at once, where each process's default of one thread
    a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(registers: int, allow_resize: bool):
    conf = {**NARROW, "num_register_tokens": registers, "allow_resize": allow_resize}
    torch.manual_seed(registers)
    port = get_model("backbones.dinov2").from_conf(conf, device="cpu").eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith("gamma"):  # LayerScale, 1e-5 at init
                p.copy_(0.5 + 0.2 * torch.randn(p.shape, generator=g))
            elif "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return conf, port


@pytest.mark.parametrize("case", list(CASES))
def test_weights_round_trip(case):
    """`convert_dinov2` of the port's state dict has the JAX model's tree
    (names and shapes, from `init` traced without running), and
    `from_jax_params` gives the state dict back tensor for tensor."""
    registers, allow_resize, hw = CASES[case]
    conf, port = _port(registers, allow_resize)
    sd = port.state_dict()
    params = convert_dinov2({k: v.numpy() for k, v in sd.items()})
    img = jnp.zeros((1, *hw, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxDinoV2.from_conf(conf).init(jax.random.key(0), {"image": img}))
    assert jax.tree.map(lambda a: a.shape, shapes["params"]) == jax.tree.map(np.shape, params)
    back = from_jax_params(params, "dinov2")
    assert set(back) == set(sd) and all(torch.equal(v, sd[k]) for k, v in back.items())
    port.load_state_dict(back, strict=True)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    registers, allow_resize, (H, W) = CASES[case]
    conf, port = _port(registers, allow_resize)
    params = convert_dinov2({k: v.numpy() for k, v in port.state_dict().items()})
    img = np.random.default_rng(3).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    ref = jax.jit(JaxDinoV2.from_conf(conf).apply)({"params": params}, {"image": jnp.asarray(img)})
    with torch.no_grad():
        out = port({"image": torch.from_numpy(img)})
    assert tuple(out["features"].shape) == (2, H // 14, W // 14, 32)
    for k in ("features", "global_descriptor", "descriptors"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=1e-5)
    # the position path the case is about moved the output: not the pretraining grid
    assert (H // 14, W // 14) != (port.grid0, port.grid0)


def test_grey_input_is_tiled():
    conf, port = _port(0, False)
    img = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (1, 42, 56, 1)).astype(np.float32))
    with torch.no_grad():
        a = port({"image": img})["features"]
        b = port({"image": img.expand(1, 42, 56, 3)})["features"]
    assert torch.equal(a, b)
