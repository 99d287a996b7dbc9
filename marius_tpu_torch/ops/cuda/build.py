"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each source under ``marius_tpu_torch/csrc/`` is compiled on its own by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The library lands in ``_build/`` beside
this file (git-ignored), named by a hash of its source and flags, so an edit
to a source rebuilds it and an unchanged source is built once. Every failure
(no nvcc, a compile error, a library that does not load) raises.

Nothing here runs when the module is imported; the build starts at the first
call of :func:`library` or :func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("gather", "adagrad", "nbr_sum", "sampler")

_loaded: Dict[str, ctypes.CDLL] = {}
#: per (source, device index): (SM count, blocks of its kernels one SM keeps resident)
_configs: Dict[Tuple[str, int], Tuple[int, int]] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked under CUDA_HOME and PATH); "
                       "the port's CUDA kernels are built from source at first use")


def _target(name: str, nvcc: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + repr((NVCC_FLAGS, nvcc)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def _tmp(target: Path) -> Path:
    """Where nvcc writes, so that a half-written library never has the target's name."""
    return target.with_suffix(f".tmp{os.getpid()}.so")


def _start(name: str, nvcc: str, target: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(_tmp(target)), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source at once (one nvcc process each, all started
    together) and return each one's compiler log ('' if it was up to date).
    The ptxas lines report registers, shared memory and spills per kernel."""
    nvcc = nvcc_path()
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        target = _target(name, nvcc)
        if target.exists():
            logs[name] = ""
        else:
            procs[name] = (_start(name, nvcc, target), target)
    failed: List[str] = []
    for name, (proc, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        (BUILD_DIR / f"{target.stem}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(_tmp(target), target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if stale."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name, nvcc_path())))
        _loaded[name] = lib
    return lib


def device_config(name: str, entry: str, threads: int, index: int) -> Tuple[int, int]:
    """(SM count, resident blocks per SM) of device ``index`` for the kernels
    of ``csrc/<name>.cu``, from its ``entry(device, &threads, &sms, &blocks)``
    at the first call and cached. Raises unless the source's block size is
    ``threads`` and at least one block fits on an SM."""
    key = (name, index)
    if key not in _configs:
        import torch

        fn = getattr(library(name), entry)
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
        got, sms, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            rc = fn(index, ctypes.byref(got), ctypes.byref(sms), ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"{name}: reading the device's size failed: CUDA error {rc}")
        if got.value != threads or blocks.value < 1:
            raise RuntimeError(f"{name}: the kernel has {got.value} threads per block and "
                               f"{blocks.value} resident blocks per SM; expected {threads} "
                               "and at least 1")
        _configs[key] = (sms.value, blocks.value)
    return _configs[key]
