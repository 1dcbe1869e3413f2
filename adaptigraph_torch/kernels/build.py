"""Build and load the port's CUDA kernels.

`csrc/contact.cu` has a plain C interface. It is compiled by `nvcc` into a
shared library under `_build/` (named by a hash of the sources and flags,
so a changed source rebuilds) and loaded with `ctypes`. The library links
against the CUDA runtime only, not against PyTorch, so a build takes
seconds. Nothing builds when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "contact.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: no contraction of a * b + c into one rounding, so each kernel
# rounds as its plain PyTorch version does (see the note in contact.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of the library's C entries; every entry returns a cudaError_t
SIGNATURES = {
    "ag_block_sparse_contact": (_P,) * 7 + (_I,) * 5 + (_P,),
    "ag_block_sparse_contact_shapes": (_P,) * 9 + (_I,) * 7 + (_P,),
    "ag_dense_contact": (_P,) * 5 + (_I,) * 2 + (_P,),
    "ag_refine_blocks": (_P,) * 7 + (_I,) * 4 + (_P,),
    "ag_contact_geometry": (_I,) * 3 + (_P,),
}

# ag_contact_geometry's selector of the kernel whose launch it describes
_GEOMETRY_IDS = {"k1": 1, "k2": 2, "k3": 3}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _target() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [SOURCE]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"contact-{h.hexdigest()[:16]}.so"


def build(timeout: float = 600.0) -> str | None:
    """Compile the library unless a current one exists. Returns the
    compiler's output (register and shared-memory use per kernel, from
    -Xptxas -v), or None when nothing was compiled. Raises with the
    compiler's output when the build fails."""
    target = _target()
    if target.exists():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=timeout)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return log


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_target()))
        for fn, argtypes in SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.ag_error_string.argtypes = [ctypes.c_int]
        lib.ag_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_geometry(lib: ctypes.CDLL, kernel: str, n_pad: int,
                    maxb: int = 0) -> dict:
    """The launch geometry the library gives kernel "k1", "k2" or "k3" at
    these shapes: CTAs, cluster size (row-tile ranks), lanes per row,
    threads per CTA."""
    out = (ctypes.c_int * 4)()
    check(lib, lib.ag_contact_geometry(_GEOMETRY_IDS[kernel], n_pad, maxb,
                                       out), "ag_contact_geometry")
    return dict(zip(("ctas", "cluster", "lanes", "threads"), out))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.ag_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
