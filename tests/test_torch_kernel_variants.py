"""The kernel-variant timing tool (`scripts_dev/kernel_variants.py`): every
substitution it makes still finds its text in `csrc/` (a source edit that
moves it would make the tool fail on the card), and it refuses to run
without a CUDA device."""

import pytest

from gluefactory_tpu_torch.ops import _build
from gluefactory_tpu_torch.scripts_dev import kernel_variants


@pytest.mark.parametrize("kernel", sorted(kernel_variants.VARIANTS))
def test_substitutions_find_their_text(kernel):
    sources = {f.name: f.read_text() for f in _build.CSRC.iterdir()}
    for name, (source, subs) in kernel_variants.VARIANTS[kernel].items():
        assert source in sources, (name, source)
        for text, replacement in subs:
            assert any(text in s for s in sources.values()), (kernel, name, text)
            assert text != replacement


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(kernel_variants.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        kernel_variants.main()


def test_compare_trees_times_path_c_blocks():
    """The two-tree timing script times the blocks that chip_smoke.py holds
    to path C's shapes."""
    import chip_smoke
    from gluefactory_tpu_torch.scripts_dev import compare_trees

    assert compare_trees.VGG_BLOCKS == [tuple(b) for b in chip_smoke.VGG_BLOCKS]
