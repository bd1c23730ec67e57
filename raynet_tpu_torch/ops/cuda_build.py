"""Build and load the port's CUDA kernels (``raynet_tpu_torch/csrc``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface and loaded with ``ctypes``. Nothing here runs at
import: the first kernel launch builds the library into
``csrc/build/<hash>/`` (the hash covers the sources and the flags, so an
edited source rebuilds) and prints how long the build took. A failed build
raises; there is no fallback.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"

# -fmad=false: no multiply-add contraction, so the kernels round every
# product and sum like PyTorch's separate elementwise ops. That keeps the
# integer outputs (feature cells, voxel sequences, counts) equal to the
# plain versions on the card. No --use_fast_math: the kernels need IEEE
# division, expf/logf/log1pf and denormals as PyTorch computes them.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-lineinfo",
)

# (C symbol, argtypes); every function returns cudaGetLastError() as int.
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "raynet_plane_sweep_scores": (
        _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "raynet_bp_sweep": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        # imported here: it looks for a CUDA install when imported
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home is None:
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(Path(home) / "bin" / "nvcc")


def build_command(output, nvcc=None):
    """The nvcc command line that builds the kernel library at ``output``."""
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    return [nvcc or nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
            str(output), *cu]


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


# Seconds the build of this process took (None: not built, or reused).
build_seconds = None


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built first if this source hash has no
    build yet."""
    global build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libraynet_kernels.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build into a temporary name and rename: concurrent builds
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = build_command(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                "nvcc failed (%d):\n%s\n%s\n%s"
                % (proc.returncode, " ".join(cmd), proc.stdout, proc.stderr)
            )
        os.replace(tmp, lib_path)
        build_seconds = time.perf_counter() - t0
        print(
            "raynet_tpu_torch: built %s in %.1f s" % (lib_path, build_seconds),
            file=sys.stderr,
        )
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err, name):
    """Raise if a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, err))


def stream_ptr(device):
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
