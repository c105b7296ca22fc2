"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``swiftly_tpu_torch/_build/lib<name>_<digest>.so``, a plain C interface that
``ops/kernels.py`` loads with ``ctypes``. The digest covers the sources and
the flags, so an edited source builds anew and an unchanged one is loaded
as it is. Nothing is built at import: the CPU tests import every module on
hosts that have no ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "find_nvcc"]

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
    return h.hexdigest()[:16]


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    :return: (path of the shared library, the compiler's report, which
        holds ``ptxas``'s registers / shared memory / spills per kernel)
    :raises RuntimeError: when nvcc is missing or the build fails
    """
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}_{_digest(name)}.so"
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src.name}:\n{report}"
        )
    log.write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, report
