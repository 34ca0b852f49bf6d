"""Build a CUDA kernel source of ``csrc/`` for the CPU, to rehearse it
without a card.

``g++`` compiles the source against the stand-in CUDA headers of
``host_emulation/`` (one host thread per CUDA thread, each block alone,
warp collectives and the PTX helpers of ``common.cuh`` written in C++ from
the PTX ISA's fragment layouts).  The library keeps the C interface of
the real build (``build.SIGNATURES``) and takes CPU pointers, so a
wrapper's own argument list drives it and its output can be held against
the plain version.  It says nothing about speed, and it cannot see what
only the device does: ``cp.async`` copies at once, so a missing wait does
not show, and ``nvcc`` may refuse what ``g++`` takes.

    lib = host_emulation.build("flash_decode", out_dir)

The source is rewritten on the way: each ``kernel<<<grid, block, smem,
stream>>>(args)`` becomes a call of the stand-in launcher, and each
``extern __shared__ T name[];`` a pointer into its shared-memory buffer.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

from repro_torch.kernels import build as _build

HEADERS = Path(__file__).resolve().parent / "host_emulation"

_LAUNCH = re.compile(
    r"([A-Za-z_][\w:]*(?:<[^<>;]*>)?)\s*<<<([^;]*?)>>>\(([^;]*?)\);")
_SHARED = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];")


def host_source(name: str) -> str:
    """The source ``csrc/<name>.cu`` as g++ takes it."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    src = _LAUNCH.sub(r"mock::launch(\1, \2, \3);", src)
    return _SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(mock::smem_buf);",
                       src)


def build(name: str, out_dir) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` for the host into ``out_dir`` and load
    it with the argument types of the real library."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cpp = out_dir / f"{name}_host.cpp"
    cpp.write_text(host_source(name))
    lib_path = out_dir / f"lib{name}_host.so"
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           "-Wno-unknown-pragmas", f"-I{HEADERS}", f"-I{_build.CSRC}",
           "-o", str(lib_path), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {name}.cu failed:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes in _build.SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
