"""Builds the port's CUDA C++ kernels with ``nvcc`` and loads them.

Each source ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and
compiles on its own into ``<name>-<hash>.so`` in ``BUILD_DIR``, where
``<hash>`` covers the source, every header ``csrc/*.cuh`` and the flags:
a library is rebuilt only when one of them changes.  ``BUILD_DIR`` is
``build/kernels/`` at the root of the checkout when the package sits
under its ``src/`` (``build/`` is git-ignored); for an installed package
it is ``$REPRO_TORCH_BUILD_DIR`` when set, else the user's cache,
``$XDG_CACHE_HOME/repro_torch/kernels`` (``~/.cache/...`` without it).
The library is loaded with ``ctypes``.  Nothing is built when this module
is imported; ``library(name)`` builds at first use, and ``build_all()``
starts one ``nvcc`` per source, all at once.  This is the one module that
knows about ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def build_dir(module: Path = Path(__file__)) -> Path:
    """Where the libraries go, for this module at ``module``: the
    checkout's ``build/kernels`` when the package lies in ``<root>/src/``
    beside a ``pyproject.toml``; else ``$REPRO_TORCH_BUILD_DIR``; else
    the user's cache directory."""
    root = module.resolve().parents[3]
    if (module.resolve().parents[2].name == "src"
            and (root / "pyproject.toml").is_file()):
        return root / "build" / "kernels"
    if os.environ.get("REPRO_TORCH_BUILD_DIR"):
        return Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "repro_torch" / "kernels"


BUILD_DIR = build_dir()
SOURCES = ("flash_attention", "flash_attention_bwd", "rwkv_wkv",
           "rwkv_wkv_bwd", "chol_update", "masked_aggregate", "grouped_matmul")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600.0


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``PATH``, else
    ``/usr/local/cuda/bin``; raises when there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` on one source into a temporary file; returns
    (process, temporary path, final path), or None when it is built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f".{name}-",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    try:
        log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        os.unlink(tmp)
        raise RuntimeError(f"nvcc on {name}.cu ran past {NVCC_TIMEOUT_S} s")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)        # atomic: concurrent builders agree
    return log


def build_all() -> dict:
    """Build every source that is not built yet, one ``nvcc`` each, all
    started together.  Returns {name: compiler log} ("" if it was
    already built)."""
    started = {name: _start(name) for name in SOURCES}
    return {name: ("" if s is None else _finish(name, s))
            for name, s in started.items()}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    return ctypes.CDLL(str(library_path(name)))


def check_launch(code: int, name: str):
    """Raise if a library's launch entry returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
