"""Build and load the port's CUDA kernels (``raynet_tpu_torch/csrc``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface and loaded with ``ctypes``. Nothing here runs at
import: the first kernel launch builds the library into
``csrc/build/<hash>/`` (the hash covers the sources and the flags, so an
edited source rebuilds) and prints how long the build took. Each ``.cu``
file is compiled by its own ``nvcc``, all started together, and the objects
are then linked. A failed build raises; there is no fallback.

Every op wrapper takes the same two steps: ``on_cuda`` sends a CUDA tensor
to the kernel and a CPU tensor to the plain version, and ``launch`` calls
the kernel's entry on the tensor's device and current stream.
"""
import contextlib
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    "raynet_voxel_traversal": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "raynet_voxel_argmax_depth": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    "raynet_cost_volume": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "raynet_transposed_conv3d": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "raynet_entry_conv3d": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "raynet_prob_conv3d": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "raynet_probe_tma_box": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "raynet_probe_tf32_dot": (_P, _P, _P, _I, _I, _I, _I, _P),
}


def sources(csrc=CSRC):
    csrc = Path(csrc)
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


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


def build_commands(output, nvcc=None, csrc=CSRC):
    """The nvcc command lines that build the kernel library of the sources
    in ``csrc`` at ``output``: one compile per ``.cu`` file (objects beside
    ``output``), which may run together, then the link."""
    nvcc = nvcc or nvcc_path()
    output, csrc = Path(output), Path(csrc)
    compiles, objects = [], []
    for cu in sorted(csrc.glob("*.cu")):
        obj = output.with_name("%s.%s.o" % (output.stem, cu.stem))
        compiles.append([nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", "-o",
                         str(obj), str(cu)])
        objects.append(str(obj))
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(output), *objects]
    return compiles, link


def _run_all(cmds):
    """Run the commands together; raise with the output of the first that
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s\n%s\n%s"
                               % (p.returncode, " ".join(cmd), out, err))


def source_hash(csrc=CSRC):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


# Seconds the build of this process took (None: not built, or reused).
build_seconds = None


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built first into ``BUILD_ROOT/<hash>/``
    if this source hash has no build yet."""
    global build_seconds
    lib, seconds = _load(CSRC, BUILD_ROOT / source_hash())
    if seconds is not None:
        build_seconds = seconds
    return lib


@functools.lru_cache(maxsize=None)
def load_library(csrc):
    """The kernel library of another checkout's sources in ``csrc`` (for a
    comparison), built first into ``BUILD_ROOT/other-<hash>/``: it reads
    ``csrc`` and writes nothing there."""
    csrc = Path(csrc)
    return _load(csrc, BUILD_ROOT / ("other-" + source_hash(csrc)))[0]


def _load(csrc, out_dir):
    """(library, build seconds) of the sources in ``csrc`` built at
    ``out_dir``; the seconds are None where that build already existed."""
    lib_path = out_dir / "libraynet_kernels.so"
    seconds = None
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build under a temporary name and rename: concurrent builds
        # never load a half-written library
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_lib = Path(tmp) / lib_path.name
            compiles, link = build_commands(tmp_lib, csrc=csrc)
            _run_all(compiles)
            _run_all([link])
            os.replace(tmp_lib, lib_path)
        seconds = time.perf_counter() - t0
        print(
            "raynet_tpu_torch: built %s in %.1f s" % (lib_path, seconds),
            file=sys.stderr,
        )
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, seconds


def check_tensor(op, name, t, dtype, shape=None):
    """Raise ValueError unless ``t`` is a contiguous CUDA tensor of
    ``dtype`` (and ``shape``), as kernel ``op`` takes it."""
    if t.device.type != "cuda":
        raise ValueError("%s: %s must be a CUDA tensor" % (op, name))
    if t.dtype != dtype:
        raise ValueError("%s: %s must be %s, got %s"
                         % (op, name, dtype, t.dtype))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("%s: %s must have shape %s, got %s"
                         % (op, name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: %s must be contiguous" % (op, name))


def check(err, name):
    """Raise if a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, err))


def on_cuda(op, t):
    """Whether op ``op`` runs its kernel on tensor ``t``: True on a CUDA
    device, False on the CPU (its plain version); ValueError on any other
    device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError("%s: unsupported device %s" % (op, t.device))


def launch(name, t, *args, lib=None):
    """Launch the kernel library's entry ``name`` (``lib``, by default
    ``library()``) with ``args`` on the device of CUDA tensor ``t``: under
    ``device_guard``, on that device's current stream, whose handle goes
    last; raise through ``check``."""
    index = t.get_device()
    fn = getattr(library() if lib is None else lib, name)
    with device_guard(index):
        err = fn(*args, raw_stream(index))
    check(err, name)


def raw_stream(index):
    """The current CUDA stream of device ``index`` as an integer handle,
    without building a ``torch.cuda.Stream`` (the call Triton's launcher
    makes)."""
    return torch._C._cuda_getCurrentRawStream(index)


_SAME_DEVICE = contextlib.nullcontext()


def device_guard(index, current=None):
    """A context that makes CUDA device ``index`` the current device:
    ``torch.cuda.device(index)`` when another device is current
    (``current``, by default the current device as the CUDA runtime reads
    it), else a context that does nothing, so that a launch on the current
    device pays for no switch."""
    if current is None:
        current = torch._C._cuda_getDevice()
    if index == current:
        return _SAME_DEVICE
    return torch.cuda.device(index)
