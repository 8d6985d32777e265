"""nvcc build of the port's CUDA sources into ctypes-loadable libraries, and
the dispatch rule every kernel wrapper follows.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into ``build/lib<name>.so`` on first use (``sm_90a``, ``--fmad=false``: nvcc
contracts no multiply-add on its own, so a kernel computes the same float32
operations as its plain PyTorch twin). The build directory is git-ignored.

A wrapper runs its kernel's plain twin when every tensor it is given lies on
the CPU (:func:`on_cpu`), and otherwise checks its CUDA tensors
(:func:`check_cuda`) and launches the kernel, or raises.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """The nvcc of ``$CUDA_HOME`` (default ``/usr/local/cuda``), else the
    one on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def library_path(source: str) -> Path:
    """``build/lib<stem>.so`` for ``csrc/<source>``."""
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def build(source: str, force: bool = False) -> Path:
    """Compile ``csrc/<source>`` unless an up-to-date library exists; returns
    the library's path. Raises ``RuntimeError`` with nvcc's output."""
    src = CSRC / source
    lib = library_path(source)
    if lib.exists() and not force and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name, then rename: concurrent processes never load
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU, False when every one is on a
    CUDA device; mixed devices raise ``ValueError``."""
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed devices: {sorted(devs)}")


def check_cuda(tensors, dtypes, shapes):
    """Raise ``ValueError`` unless each named tensor is a contiguous CUDA
    tensor of its dtype and shape (``{name: tensor}``, ``{name: dtype}``,
    ``{name: shape}``)."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != dtypes[name]:
            raise ValueError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} must have shape {tuple(shapes[name])}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
