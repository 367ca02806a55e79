"""The host build of `ops/_build.py` (the LSD's C++ source): two processes
that build the library at once, into an empty build directory, both load
the same file, and the compiler's output comes back in a failed build's
error."""

import subprocess
import sys
from pathlib import Path

import pytest

from gluefactory_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]

_CHILD = """
import sys
from pathlib import Path
from gluefactory_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
lib = _build.load_host("lsd")
print(_build.host_library_path("lsd"), hasattr(lib, "gf_lsd"))
"""


def test_two_processes_build_and_load_the_same_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp_path / "b")], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = [o[0].strip() for o in outs]
    assert lines[0] == lines[1] and lines[0].endswith(" True")
    built = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert [n for n in built if n.endswith(".so")] == [Path(lines[0].split()[0]).name]
    assert not [n for n in built if n.endswith(".tmp")]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "lsd.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="(?s)host build of lsd failed.*error"):
        _build.build_host("lsd")
    assert not list((tmp_path / "b").glob("*.so"))
