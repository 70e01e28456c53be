"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them with ctypes.

Each ``*.cu`` file becomes one shared library with a plain C interface, compiled
for ``sm_90a`` at first use into ``build/repro_torch/`` at the repository root
(or ``$REPRO_TORCH_BUILD_DIR``), named by a hash of the sources so an edited
kernel is rebuilt and an unchanged one is reused. ``build_all`` starts one
``nvcc`` per source at once. A failed build raises with the compiler's output;
nothing falls back.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("flash_fwd", "flash_fwd_sm90", "flash_decode", "flash_decode_sm90")

_libs: Dict[str, ctypes.CDLL] = {}
last_build_seconds: float = 0.0      # wall time of the most recent compile, 0 if reused
last_build_log: str = ""             # nvcc's output of the most recent compile


class NvccError(RuntimeError):
    pass


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise NvccError("nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda): "
                     "the CUDA kernels cannot be built on this machine")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}_{_source_hash(name)}.so"


def _start(name: str, out: Path, extra: Iterable[str]):
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, cmd


def build_all(names: Iterable[str] = SOURCES, *, verbose_ptxas: bool = False) -> None:
    """Compile every missing library, all compilers started together."""
    global last_build_seconds, last_build_log
    todo = [(n, _lib_path(n)) for n in names if n not in _libs]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return
    build_dir().mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose_ptxas else []
    t0 = time.time()
    running = [(n, p) + _start(n, p, extra) for n, p in todo]
    logs, failed = [], []
    for n, p, proc, tmp, cmd in running:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(n)
            if tmp.exists():
                tmp.unlink()
        else:
            os.replace(tmp, p)
    last_build_seconds = time.time() - t0
    last_build_log = "\n".join(logs)
    if failed:
        raise NvccError(f"nvcc failed for {failed}:\n{last_build_log}")


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if need be."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def on_device(device):
    """Context in which ``device`` is the current CUDA device (free when it already is)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def tma_addressable(t) -> bool:
    """Whether TMA can read or write ``t`` in place, as the bf16 kernels do.

    The base must be 16-byte aligned, the last dim contiguous and every other
    stride a multiple of 16 bytes (below 2**40); a dim of extent 1 is never
    stepped along, so its stride does not matter.
    """
    st = t.stride()
    if not st or st[-1] != 1 or t.data_ptr() % 16:
        return False
    size = t.element_size()
    for n, step in zip(t.shape[:-1], st[:-1]):
        if n != 1 and (step <= 0 or step * size % 16 or step * size >= 2 ** 40):
            return False
    return True


def check(err: int, what: str) -> None:
    """Raise when a C entry point did not return 0 (cudaSuccess)."""
    if err != 0:
        detail = "bad argument" if err == -1 else f"CUDA error {err}"
        raise RuntimeError(f"{what}: launch failed ({detail})")
