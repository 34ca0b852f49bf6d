"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build
runs at first use, never at import: the libraries land in
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused.  All sources compile in parallel, one ``nvcc`` each.

A build that fails raises; there is no fallback to the plain versions.
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
#: build/kernels at the repository root (listed in .gitignore)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention.cu", "flash_decode.cu", "ssd_scan.cu",
           "ssd_decode.cu", "attention_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_c_ptr, _c_int, _c_i64, _c_f32 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int64, ctypes.c_float)
#: argtypes of every C entry point, by library
SIGNATURES = {
    "flash_attention": {
        "repro_flash_attention": (
            [_c_ptr] * 4 + [_c_int] * 7 + [_c_i64] * 12 + [_c_f32, _c_ptr]),
    },
    "flash_decode": {
        "repro_flash_decode": (
            [_c_ptr] * 7 + [_c_int] * 9 + [_c_i64] * 10 + [_c_f32, _c_ptr]),
        "repro_flash_decode_paged": (
            [_c_ptr] * 8 + [_c_int] * 9 + [_c_i64] * 11 + [_c_f32, _c_ptr]),
    },
    "ssd_scan": {
        "repro_ssd_scan": (
            [_c_ptr] * 10 + [_c_int] * 7 + [_c_i64] * 16 + [_c_ptr]),
    },
    "ssd_decode": {
        "repro_ssd_decode_step": (
            [_c_ptr] * 8 + [_c_int] * 5 + [_c_i64] * 7 + [_c_ptr]),
    },
    "attention_bwd": {
        "repro_attention_bwd": (
            [_c_ptr] * 9 + [_c_int] * 6 + [_c_i64] * 21 + [_c_f32, _c_ptr]),
    },
}

_libs: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all(verbose: bool = False) -> dict:
    """Compile every source not yet built for the current hash and load
    all libraries.  Returns ``{name: ctypes.CDLL}``."""
    if len(_libs) == len(SOURCES):
        return _libs
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        name = Path(src).stem
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        # write to a private name, then rename: a concurrent build never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for lib, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    for src in SOURCES:
        name = Path(src).stem
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs


def library(name: str):
    """The loaded library ``name`` (building everything on first use)."""
    return build_all()[name]


def check(err: int, what: str):
    """Raise on a non-zero CUDA error code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def aligned(t) -> bool:
    """Are ``t``'s base pointer and the strides of its axes other than the
    last (those of length > 1) multiples of 16 bytes, as the kernels'
    16-byte copies need?"""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * size % 16 == 0
        for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)


def check_aligned(what: str, name: str, t) -> None:
    """Raise unless ``t`` is :func:`aligned`."""
    if not aligned(t):
        size = t.element_size()
        raise ValueError(
            f"{what}: {name} must be 16-byte aligned for the kernel's "
            f"16-byte loads: base pointer and the strides of every axis but "
            f"head_dim in multiples of 16 bytes; got base % 16 = "
            f"{t.data_ptr() % 16}, strides {tuple(t.stride())} of {size}-byte "
            "elements")
