"""nvcc build of the port's CUDA sources into ctypes-loadable libraries, and
the dispatch rule every kernel wrapper follows.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into ``build/lib<name>.so`` on first use (``sm_90a``, ``--fmad=false``: nvcc
contracts no multiply-add on its own, so a kernel computes the same float32
operations as its plain PyTorch twin). ptxas's resource report of each
kernel (``-Xptxas -v``) is kept beside the library as
``build/lib<name>.ptxas.txt`` (:func:`ptxas_usage` reads it). The build
directory is git-ignored.

A wrapper runs its kernel's plain twin when every tensor it is given lies on
the CPU (:func:`on_cpu`), and otherwise checks its CUDA tensors
(:func:`check_cuda`) and launches the kernel, or raises.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The nvcc of ``$CUDA_HOME`` (default ``/usr/local/cuda``), else the
    one on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def library_path(source: str) -> Path:
    """``build/lib<stem>.so`` for ``csrc/<source>``."""
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def build(source: str, force: bool = False, src: Path | None = None,
          lib: Path | None = None) -> Path:
    """Compile ``csrc/<source>`` (or the file ``src``, into ``lib``) unless
    an up-to-date library exists; returns the library's path. Raises
    ``RuntimeError`` with nvcc's output."""
    src = CSRC / source if src is None else Path(src)
    lib = library_path(source) if lib is None else Path(lib)
    if lib.exists() and not force and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a private name, then rename: concurrent processes never load
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}\n"
                           f"{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _kernel_label(mangled: str) -> str:
    """``name`` or ``name<a, ...>`` of an Itanium-mangled kernel with bool
    or int template arguments (``_Z12march_kernelILb0ELb1ELb0EEv...`` ->
    ``march_kernel<false, true, false>``, ``...ILi2ELi0EE...`` -> ``<2,
    0>``), else the mangled name."""
    m = re.match(r"_Z(\d+)", mangled)
    if m is None:
        return mangled
    end = m.end() + int(m.group(1))
    name, rest = mangled[m.end():end], mangled[end:]
    if not rest.startswith("I"):
        return name
    args = [("false", "true")[int(v)] if t == "b" else v for t, v in
            re.findall(r"L([bi])(\d+)E", rest[:rest.find("EE") + 2])]
    return f"{name}<{', '.join(args)}>"


def ptxas_usage(lib: Path) -> dict:
    """Per kernel of a library built by :func:`build`, from its ptxas
    report: ``{label: {"registers", "spill_stores", "spill_loads",
    "stack", "smem"}}`` (bytes but registers)."""
    text = Path(lib).with_suffix(".ptxas.txt").read_text()
    usage, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = usage.setdefault(_kernel_label(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(sm.group(1)) if sm else 0
    return usage


def cuobjdump() -> str:
    """The cuobjdump beside :func:`nvcc`, else the one on ``PATH``."""
    path = Path(nvcc()).parent / "cuobjdump"
    return str(path) if path.exists() else "cuobjdump"


_SASS_FN = re.compile(r"Function : (\S+)")
_SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);")


def parse_sass(text: str) -> dict:
    """cuobjdump's SASS listing -> ``{label: [(address, opcode,
    operands)]}`` per kernel, labelled as :func:`ptxas_usage` labels them
    (a branch's operand is its target address)."""
    kernels, current = {}, None
    for line in text.splitlines():
        m = _SASS_FN.search(line)
        if m:
            current = kernels.setdefault(_kernel_label(m.group(1)), [])
            continue
        m = _SASS_OP.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2),
                            m.group(3).strip()))
    return kernels


def sass_loops(instructions) -> list:
    """The innermost loops of one kernel's SASS (a branch back to an earlier
    address, with no such loop inside): ``[(start, end, ops, guarded)]``,
    ``ops`` a Counter of the loop's base opcodes (NOPs left out) and
    ``guarded`` those of its longest stretch a forward branch inside it can
    skip."""
    from collections import Counter

    def target(op, rest):
        m = re.search(r"0x([0-9a-f]+)", rest)
        return int(m.group(1), 16) if op.split(".")[0] == "BRA" and m else None

    def count(lo, hi):
        return Counter(o.split(".")[0] for a, o, _ in instructions
                       if lo <= a <= hi and not o.startswith("NOP"))

    spans = [(t, a) for a, o, r in instructions
             if (t := target(o, r)) is not None and t < a]
    loops = []
    for start, end in spans:
        if any(start <= s0 and e0 < end or start < s0 and e0 <= end
               for s0, e0 in spans):
            continue
        skips = [(a, t) for a, o, r in instructions
                 if start <= a < end and (t := target(o, r)) is not None
                 and a < t <= end]
        guarded = Counter()
        if skips:
            a, t = max(skips, key=lambda at: at[1] - at[0])
            guarded = count(a + 1, t - 1)
        loops.append((start, end, count(start, end), guarded))
    return loops


def sass(lib: Path) -> dict:
    """:func:`parse_sass` of ``cuobjdump -sass`` of a built library."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return parse_sass(out)


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
