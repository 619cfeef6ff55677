"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Every ``*.cu`` of ``csrc/`` is compiled with ``nvcc`` into an object, one
``nvcc`` per source, all started together, and the objects are linked into
one shared library with a plain C interface, under
``build/cmad_tpu_torch/`` at the root of the checkout, keyed by a hash of
every file under ``csrc/`` (headers included) and the flags: a changed
source builds anew, an unchanged one is loaded from the build directory.
Nothing is built or imported when this module is imported; the first
kernel launch builds.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    objdir = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc = _nvcc()
    try:
        procs = []
        for src in sources():
            obj = str(Path(objdir) / f"{src.stem}.o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = ""
        failed = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src}:"
                              f"\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", tmp, *(obj for _s, obj, _p in procs)],
            capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
        shutil.rmtree(objdir, ignore_errors=True)
    return path, log + link.stdout + link.stderr


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
    for name in ("j2_soa_history_f32_iters",):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    for name in ("segment_sum_tile_f32", "segment_sum_tile_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    for name in ("segment_sum_block_f32", "segment_sum_block_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
        fn.restype = ctypes.c_int
    for name in ("coarse_pair_sum_f32", "coarse_pair_sum_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i64, i64, ptr]
        fn.restype = ctypes.c_int
    for name in ("csr_matvec_f32", "csr_matvec_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [i64, i64, ptr]
        fn.restype = ctypes.c_int
    lib.j2_error_string.argtypes = [ctypes.c_int]
    lib.j2_error_string.restype = ctypes.c_char_p
    return lib
