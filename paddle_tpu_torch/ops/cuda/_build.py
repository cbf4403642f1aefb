"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a file builds in seconds).
Libraries land in ``build/torch_kernels/`` at the repository root, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing is built at import time: the first
launch builds what it needs, and :func:`build` builds several sources at
once, one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["KERNEL_SOURCES", "DTYPE_CODES", "build", "load", "build_dir",
           "check_status", "smem_limit", "sm_count", "stream_ptr"]

#: every kernel library of the port, by csrc/ file stem
KERNEL_SOURCES = ("rms_norm", "paged_attention", "flash_attention",
                  "flash_attention_varlen", "tiled_mm")

#: element-type codes shared with csrc/common.cuh (enum DTypeCode)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/torch_kernels/`` beside the package (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled at first use "
        "and need the CUDA toolkit (nvcc on PATH or under CUDA_HOME)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once. Returns seconds per compiled library
    (0.0 for one already built). A failed build raises with nvcc's
    output; ptxas' register and shared-memory report is kept beside the
    library as ``<name>-<hash>.log``."""
    names = list(names)
    out = {n: 0.0 for n in names}
    todo = [(n, _target(n)) for n in names if not _target(n).is_file()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name, target in todo:
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                            f"{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)   # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check_status(status: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(
            f"{what}: CUDA error {status} (a cudaError_t value) at launch")


_smem_limits: Dict[int, int] = {}


def smem_limit(device: torch.device) -> int:
    """Dynamic shared memory one block may use on ``device`` (bytes)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _smem_limits:
        props = torch.cuda.get_device_properties(idx)
        # 227 KB on Hopper; older torch builds lack the attribute
        _smem_limits[idx] = int(getattr(
            props, "shared_memory_per_block_optin", 232448))
    return _smem_limits[idx]


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (132 on an H100 SXM)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def stream_ptr(device: torch.device) -> int:
    """The current PyTorch stream on ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
