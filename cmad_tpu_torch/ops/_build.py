"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Every ``*.cu`` of ``csrc/`` is compiled with ``nvcc`` into one shared
library with a plain C interface, under ``build/cmad_tpu_torch/`` at the
root of the checkout, keyed by a hash of every file under ``csrc/``
(headers included) and the flags: a changed source builds anew, an
unchanged one is loaded from the build directory. Nothing is
built or imported when this module is imported; the first kernel launch
builds.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cmad_tpu_torch"

# no --use_fast_math: __expf would break the f32 tolerance
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of cmad_tpu_torch cannot be built")


def sources() -> list[Path]:
    """The translation units: every ``*.cu`` under ``csrc/``."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(CSRC)).encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"libj2_radial_return_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if the library for the current source is
    missing. Returns ``(path, compiler log)``; the log is empty when the
    library was already built."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        srcs = [str(p) for p in sources()]
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {srcs}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry's C signature declared
    (64-bit pointers, stream and sizes)."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    for name in ("j2_soa_step_f32", "j2_soa_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, ptr]
        fn.restype = ctypes.c_int
    for name in ("j2_soa_history_f32", "j2_soa_history_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr]
        fn.restype = ctypes.c_int
    for name in ("j2_aos_step_f32", "j2_aos_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr]
        fn.restype = ctypes.c_int
    for name in ("j2_total_step_f32", "j2_total_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, ptr]
        fn.restype = ctypes.c_int
    lib.j2_error_string.argtypes = [ctypes.c_int]
    lib.j2_error_string.restype = ctypes.c_char_p
    return lib
