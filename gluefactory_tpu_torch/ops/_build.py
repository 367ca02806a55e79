"""Build the port's CUDA kernels from the sources in `csrc/` at first use.

Each kernel source compiles with nvcc, for `sm_90a`, into a shared library
with a plain C interface that `ctypes` loads (no PyTorch headers, so a build
takes seconds). Libraries go to `build/torch_ext/` at the root of the
checkout, which `.gitignore` lists. A library's file name carries a hash of
its sources and flags: an edited source rebuilds, an unchanged one loads the
library already built. `build_all` starts one nvcc per source, all at once.
A build that fails raises with nvcc's output; nothing falls back.

Host code (`HOST_SOURCES`: the LSD line detector, the probabilistic
Hough and the LO-RANSAC estimators) is C++17 built by the host compiler
(`$CXX`, else `c++`) into the same directory under the same hash-named
scheme (`build_host`, `load_host`). Its flags keep the arithmetic as
written (`-ffp-contract=off`: no fused multiply-adds the source does not
ask for, no -ffast-math, no -march=native), so a library gives the same
results on every host. Several processes may build one library at once
(pytest-xdist workers): the build runs under a file lock and lands by
`os.replace` of a private temporary file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]
SOURCES = {
    "fused_attention": "fused_attention.cu",
    "fused_bidirectional_attention": "fused_bidirectional_attention.cu",
    "log_sinkhorn": "log_sinkhorn.cu",
    "fused_nms_tile_reduce": "nms_tile_reduce.cu",
    "fused_vgg_block": "vgg_block.cu",
    "stream_conv3x3": "conv3x3_stream.cu",
    "npack_conv3x3": "conv3x3_npack.cu",
    "int8_conv": "int8_conv.cu",
}
HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
HOST_SOURCES = {"lsd": "lsd.cpp", "hough": "hough.cpp", "fastransac": "fastransac.cpp"}
MAX_SHARED_BYTES = 232448  # opt-in shared memory per block on the H100 (227 KiB)

_libs: dict[str, ctypes.CDLL] = {}


def uses_kernel(device: torch.device) -> bool:
    """The dispatch rule of every kernel wrapper: tensors on a CUDA device go
    to the kernel, tensors on the CPU to its plain version."""
    return device.type == "cuda"


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the library of kernel `name` is built: hashed on its source,
    every header in csrc/ and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Build the named kernels (default: all) in parallel; return for each
    the build seconds and nvcc's log (ptxas register and spill report).
    Kernels already built are skipped (seconds 0, empty log)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    out = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(target))
    return lib


def function(name: str, argtypes: list):
    """The C entry point `gf_<name>` of kernel `name` (built and loaded at
    first use), typed with `argtypes`; it returns a cudaError_t."""
    fn = getattr(load(name), "gf_" + name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def host_compiler() -> str:
    """The host C++ compiler: $CXX, else `c++` on $PATH."""
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise FileNotFoundError("no host C++ compiler (set CXX or put c++ on PATH)")
    return cxx


def host_library_path(name: str) -> Path:
    """Where host library `name` is built: hashed on its source, the flags and
    the compiler."""
    h = hashlib.sha256(" ".join([host_compiler(), *HOST_FLAGS]).encode())
    src = CSRC / HOST_SOURCES[name]
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-host-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Build host library `name` unless it is built; returns its path. Raises
    with the compiler's output if the build fails."""
    target = host_library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}-host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / HOST_SOURCES[name])]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"host build of {name} failed ({' '.join(cmd)}):\n{proc.stdout}")
            os.replace(tmp, target)
    return target


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library `name`, built first if needed."""
    key = "host:" + name
    lib = _libs.get(key)
    if lib is None:
        lib = _libs[key] = ctypes.CDLL(str(build_host(name)))
    return lib
