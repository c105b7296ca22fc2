"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``swiftly_tpu_torch/_build/lib<name>_<digest>.so``, a plain C interface that
``ops/kernels.py`` loads with ``ctypes``. The digest covers the source, every
shared header (``csrc/*.cuh``) and the flags, so an edited source or header
builds anew and an unchanged one is loaded as it is. ``build_all`` starts one
``nvcc`` per source at once. Nothing is built at import: the CPU tests import
every module on hosts that have no ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "build_all", "find_nvcc"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: building the port's CUDA kernels needs the CUDA "
        "toolkit (nvcc on PATH or under /usr/local/cuda)"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}_{_digest(name)}.so"
    return src, out, out.with_suffix(".log")


def _start(name: str):
    """Start nvcc for one source; None when an up-to-date library exists."""
    src, out, _ = _paths(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, started) -> tuple[Path, str]:
    src, out, log = _paths(name)
    if started is None:
        return out, log.read_text() if log.exists() else ""
    proc, tmp = started
    report, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src.name}:\n{report}"
        )
    log.write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, report


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    :return: (path of the shared library, the compiler's report, which
        holds ``ptxas``'s registers / shared memory / spills per kernel)
    :raises RuntimeError: when nvcc is missing or the build fails
    """
    return _finish(name, _start(name))


def build_all(names) -> dict[str, tuple[Path, str]]:
    """``build`` for several sources, their ``nvcc`` runs started together.

    :return: {name: (library path, compiler report)}
    :raises RuntimeError: when nvcc is missing or any build fails (after
        every started build has ended)
    """
    names = list(names)
    started = {name: _start(name) for name in names}
    results, errors = {}, []
    for name in names:
        try:
            results[name] = _finish(name, started[name])
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
