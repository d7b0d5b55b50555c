"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, and loaded with ``ctypes``.
Nothing is built or loaded at import: the first call of ``load_function`` (or
an explicit ``build_all``) builds every source, one ``nvcc`` process each, all
started together. Libraries go to ``pl_convlstm_gan_tpu_torch/_build/`` under
a name that hashes the source, every header of ``csrc/`` (``*.cuh``, which
the sources include) and the flags, so an edited source or header is rebuilt
and an unchanged one is not.

Every kernel launches through ``launch``: the C entry (loaded once), the
device made current where it is not, the current stream's raw handle last
among the arguments, the returned error checked.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("convlstm_cell", "conv_head", "rollout_persistent", "tap_structure",
           "cell_backward", "st_lstm_gates", "traj_warp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# after the source: the driver API (cuTensorMapEncodeTiled, for TMA maps)
LINK_FLAGS = ("-lcuda",)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME, else the toolkit's default
    install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")]
    for cand in candidates:
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Content-addressed path of the built library for ``csrc/<name>.cu``:
    the hash covers the source, the headers of ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing, all in parallel.

    Returns {name: {"seconds": wall time of the build (0 if cached),
    "log": nvcc's output, including ptxas' register and spill report}}.
    Raises RuntimeError with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        target = library_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "log": "cached"}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu"), *LINK_FLAGS]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, target)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            if not all(library_path(n).exists() for n in SOURCES):
                build_all()
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def load_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared and an int (cudaError_t) result; built and loaded at first use."""
    key = (name, symbol)
    if key not in _functions:
        fn = getattr(_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


def check(err: int, name: str, what: str) -> None:
    """Raise if a C entry of ``csrc/<name>.cu`` returned a CUDA error."""
    if err != 0:
        describe = load_function(name, "cuda_error_string", [ctypes.c_int])
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({describe(err).decode()})")


def device_guard(device):
    """A context that makes the CUDA ``device`` current, or none where it
    is current already (autograd's thread for it; the main thread on one
    card), which saves the host a ``torch.cuda.device``."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch(name: str, symbol: str, argtypes, device, *args, what: str
           ) -> None:
    """Call the C entry ``symbol`` of ``csrc/<name>.cu`` (``load_function``)
    on ``device`` as ``fn(*args, stream)``: ``stream`` is the raw handle of
    ``device``'s current stream, whichever the caller made current (a graph
    capture's, autograd's backward's). Raises (``check``, naming ``what``)
    on a CUDA error."""
    fn = load_function(name, symbol, argtypes)
    with device_guard(device):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    check(err, name, what)
