"""Build and load the port's CUDA kernels.

The sources under ``protoclip_tpu_torch/csrc/`` have a plain C interface.
Each ``.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects are linked into
``build/kernels/libprotoclip_kernels.so`` at the repository root, which is
loaded with :mod:`ctypes`.  The build runs at first use and again whenever
the sources' hash changes; ``build/`` is git-ignored.  Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libprotoclip_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

c_int, c_ptr, c_float, c_i64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
# C signatures of csrc/*.cu: every pointer and the stream as c_void_p
_SIGNATURES = {
    "layernorm_rows": (c_int, [c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_float, c_ptr]),
    "layernorm_sub_rows": (
        c_int, [c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_float, c_ptr],
    ),
    "layernorm_residual_rows": (
        c_int, [c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_float, c_ptr],
    ),
    "gemm_bias_epilogue": (
        c_int, [c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_ptr],
    ),
    "gemm_bias_eva": (
        c_int,
        [c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int,
         c_int, c_int, c_ptr],
    ),
    "attention_packed": (
        c_int,
        [c_int, c_ptr, c_ptr, c_ptr, c_i64, c_i64, c_i64, c_ptr, c_i64, c_i64, c_i64,
         c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_float, c_ptr],
    ),
    "attention_int8": (
        c_int,
        [c_int, c_ptr, c_ptr, c_ptr, c_i64, c_i64, c_i64, c_ptr, c_i64, c_i64, c_i64,
         c_int, c_int, c_int, c_int, c_int, c_int, c_ptr, c_float, c_ptr],
    ),
    "quant_rows": (
        c_int,
        [c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_float, c_int, c_int, c_ptr],
    ),
    "qkv_sum": (c_int, [c_int, c_ptr, c_ptr, c_int, c_int, c_ptr]),
    "gemm_int8_epilogue": (
        c_int,
        [c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_ptr],
    ),
    "attention_packed_smem_bytes": (ctypes.c_size_t, [c_int, c_int, c_int]),
    "attention_int8_smem_bytes": (ctypes.c_size_t, [c_int, c_int]),
    "protoclip_error_string": (ctypes.c_char_p, [c_int]),
}

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's standard location
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set $CUDA_HOME to the CUDA toolkit")


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it is current."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = sources_hash()
    if not force and lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))

    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry's C signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = load_library().protoclip_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
