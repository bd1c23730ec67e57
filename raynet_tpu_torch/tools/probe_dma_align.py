"""Probes P1 and P2 on the card, and their plain versions.

Counterpart of ``tools/probe_dma_align.py``, whose two Pallas probes asked
the TPU what K1 and K2 had to design around. The same questions, asked of
an H100:

- **P1** (``tma_box_rows``, kernel ``csrc/probe_tma_box.cu``): one TMA copy
  of a (BWG, BH, 128) bf16 box from a (WG, HF, 128) bf16 source at
  offsets (y0, xg0), then rows [sub0 BH, (sub0 + 4) BH) of the box's
  (BWG BH, 128) flattening as f32. Does the copy engine take any offset?
  The eight cases are the JAX probe's variants A, B, C, D and D2; each must
  equal the plain version bit for bit.
- **P2** (``tensor_core_dot``, kernel ``csrc/probe_tf32_dot.cu``): an f32
  product on the tensor cores (``mma.sync`` with TF32 operands, f32
  accumulation). ``probe_f32_dot_truncation`` reports whether a diagonal
  comes back EXACT or which operand rounding it matches bit for bit.

    python -m raynet_tpu_torch.tools.probe_dma_align

needs a CUDA card and exits nonzero without one. It prints the report
lines and exits 0 when every P1 case is exact and the P2 verdicts name a
rounding. ``dot_equal_to_build`` holds P2 bit for bit against its build
from another checkout's sources (``chip_smoke.py --parent``).
"""
import argparse
import sys

import numpy as np
import torch

from ..ops import cuda_build

BH, BWG = 16, 12  # the box: BH rows (a multiple of 16), BWG x-groups
HF, WG = 64, 40  # the probe's source
WIDTH = 128
NSUB = 4  # x-groups of the box written out

# (variant, y0, xg0, sub0): the JAX probe's cases (tools/probe_dma_align.py
# main) and D2 at an 8-aligned y0
CASES = (
    ("A", 0, 0, 0), ("B", 0, 0, 0), ("C", 0, 0, 0), ("C", 0, 0, 2),
    ("C", 0, 0, 8), ("D", 3, 5, 2), ("D", 9, 1, 7), ("D2", 8, 1, 7),
)


def case_offsets(variant, y0, xg0, sub0):
    """(y0, xg0, sub0) a case reads: A and B copy at (0, 0) and take the
    first rows, C at (0, 0) from x-group sub0, D and D2 at (y0, xg0)."""
    if variant in ("A", "B"):
        return 0, 0, 0
    if variant == "C":
        return 0, 0, sub0
    return y0, xg0, sub0


def box_source(device, seed=0):
    """The probe's (WG, HF, 128) bf16 source: ``RandomState(seed).randn``
    in f32, rounded to bf16 (to nearest, ties to even)."""
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(WG, HF, WIDTH).astype(np.float32))
    return src.to(device=device, dtype=torch.bfloat16)


def _check_box_args(src, y0, xg0, sub0):
    if src.dtype != torch.bfloat16 or src.dim() != 3 or src.shape[2] != WIDTH:
        raise ValueError("tma_box_rows: src must be bfloat16 (WG, HF, %d), "
                         "got %s %s" % (WIDTH, src.dtype, tuple(src.shape)))
    wg, hf, _ = src.shape
    # TMA fills a box that leaves the tensor with zeros, without an error
    if not (0 <= y0 <= hf - BH and 0 <= xg0 <= wg - BWG
            and 0 <= sub0 <= BWG - NSUB):
        raise ValueError(
            "tma_box_rows: offsets (y0=%d, xg0=%d, sub0=%d) outside "
            "[0, %d] x [0, %d] x [0, %d]"
            % (y0, xg0, sub0, hf - BH, wg - BWG, BWG - NSUB))
    if not src.is_contiguous():
        raise ValueError("tma_box_rows: src must be contiguous")
    if src.data_ptr() % 16:
        raise ValueError("tma_box_rows: src must be 16-byte aligned")
    return wg, hf


def tma_box_rows_reference(src, y0, xg0, sub0):
    """Plain version of P1: (NSUB BH, 128) float32."""
    box = src[xg0:xg0 + BWG, y0:y0 + BH].reshape(BWG * BH, WIDTH)
    return box[sub0 * BH:(sub0 + NSUB) * BH].float()


def tma_box_rows(src, y0, xg0, sub0):
    """Rows [sub0 BH, (sub0 + 4) BH) of the (BWG, BH, 128) box of ``src``
    at (xg0, y0), flattened to (BWG BH, 128), as (64, 128) float32: the
    TMA kernel P1 for a CUDA tensor, the plain version for a CPU tensor.

    src: (WG, HF, 128) bfloat16, contiguous and 16-byte aligned; the box
    must lie inside it and sub0 <= BWG - 4.
    """
    y0, xg0, sub0 = int(y0), int(xg0), int(sub0)
    wg, hf = _check_box_args(src, y0, xg0, sub0)
    if not cuda_build.on_cuda("tma_box_rows", src):
        return tma_box_rows_reference(src, y0, xg0, sub0)
    out = src.new_empty((NSUB * BH, WIDTH), dtype=torch.float32)
    cuda_build.launch("raynet_probe_tma_box", src, src.data_ptr(),
                      out.data_ptr(), wg, hf, y0, xg0, sub0,
                      src.get_device())
    tma_box_rows.launches += 1
    return out


# Kernel launches since the last reset (the plain path never counts).
tma_box_rows.launches = 0


# operand roundings of the plain P2, with the names the report uses
ROUNDINGS = {"tf32_truncate": "tf32-truncate", "tf32_rna": "tf32-RNA",
             "bf16": "bf16"}
_EXP = 0x7F800000


def round_operand(x, rounding):
    """float32 ``x`` rounded in its bits: "none" as it is, "tf32_truncate"
    with the low 13 mantissa bits cleared, "tf32_rna" to 10 mantissa bits,
    nearest with ties away from zero, "bf16" to 7 mantissa bits, nearest
    with ties to even. Infinities and NaNs pass unchanged."""
    if rounding == "none":
        return x
    bits = x.contiguous().view(torch.int32)
    if rounding == "tf32_truncate":
        r = bits & ~0x1FFF
    elif rounding == "tf32_rna":
        # adding half an ulp to the magnitude rounds ties away from zero
        r = (bits + 0x1000) & ~0x1FFF
    elif rounding == "bf16":
        r = (bits + 0x7FFF + ((bits >> 16) & 1)) & ~0xFFFF
    else:
        raise ValueError("round_operand: unknown rounding %r" % (rounding,))
    r = torch.where((bits & _EXP) == _EXP, bits, r)
    return r.view(torch.float32)


def _check_dot_args(x, e):
    f32 = torch.float32
    if x.dtype is not f32 or e.dtype is not f32 or x.dim() != 2 or (
            e.dim() != 2):
        for name, t in (("x", x), ("e", e)):
            if t.dtype != f32 or t.dim() != 2:
                raise ValueError(
                    "tensor_core_dot: %s must be a float32 matrix, got %s %s"
                    % (name, t.dtype, tuple(t.shape)))
    (m, k), (k2, n) = x.shape, e.shape
    if k != k2 or m % 16 or n % 8 or k % 8:
        raise ValueError("tensor_core_dot: (M, K) x (K, N) with M %% 16, "
                         "N %% 8 and K %% 8 zero, got %s x %s"
                         % (tuple(x.shape), tuple(e.shape)))
    if x.device != e.device:
        raise ValueError("tensor_core_dot: x on %s, e on %s"
                         % (x.device, e.device))
    if not x.is_contiguous():
        raise ValueError("tensor_core_dot: x must be contiguous")
    if not e.is_contiguous():
        raise ValueError("tensor_core_dot: e must be contiguous")
    return m, n, k


def tensor_core_dot_reference(x, e, operand_rounding="none"):
    """Plain version of P2: the operands rounded by ``round_operand``,
    multiplied and summed in float64, returned as float32."""
    xr = round_operand(x, operand_rounding).double()
    er = round_operand(e, operand_rounding).double()
    return (xr @ er).float()


MODES = {"raw": "none", "rna": "tf32_rna"}
_RNA = {"raw": 0, "rna": 1}  # the kernel's rna argument


def tensor_core_dot(x, e, mode):
    """(M, K) x (K, N) float32 product: the tensor-core kernel P2 for CUDA
    tensors, the plain version for CPU tensors. ``mode`` "raw" hands the
    f32 bits to the tensor cores as they are (the plain version: no
    rounding); "rna" converts each operand to TF32 first, to nearest with
    ties away (the plain version: "tf32_rna")."""
    rna = _RNA.get(mode)
    if rna is None:
        raise ValueError("tensor_core_dot: mode must be 'raw' or 'rna', "
                         "got %r" % (mode,))
    m, n, k = _check_dot_args(x, e)
    if not cuda_build.on_cuda("tensor_core_dot", x):
        return tensor_core_dot_reference(x, e, MODES[mode])
    out = x.new_empty((m, n))
    cuda_build.launch("raynet_probe_tf32_dot", x, x.data_ptr(), e.data_ptr(),
                      out.data_ptr(), m, n, k, rna)
    tensor_core_dot.launches += 1
    return out


tensor_core_dot.launches = 0

N_DOT = 128
# the JAX probe's diagonal: 1 + k 2^-18 needs more than 10 mantissa bits,
# so every named rounding returns 1; 1 + k 2^-13 tells them apart (k % 8
# of 4 is a tie of TF32's last bit)
DIAGONALS = {"1 + k 2^-18": 2.0 ** -18, "1 + k 2^-13": 2.0 ** -13}


def dot_roundings(got, vals):
    """The operand roundings of ``vals`` that a diagonal ``got`` equals bit
    for bit: ["none"] when exact, else keys of ``ROUNDINGS`` (maybe none)."""
    if torch.equal(got, vals):
        return ["none"]
    return [r for r in ROUNDINGS if torch.equal(got, round_operand(vals, r))]


def dot_verdict(roundings):
    """The report's words for ``dot_roundings``."""
    if roundings == ["none"]:
        return "EXACT (full f32 operands)"
    names = [ROUNDINGS[r] for r in roundings]
    return "TRUNCATED (matches %s)" % (
        ", ".join(names) if names
        else "none of " + ", ".join(ROUNDINGS.values()))


def probe_f32_dot_truncation(device, mode="raw"):
    """Multiply diag(vals) by I with ``tensor_core_dot`` for each diagonal
    of ``DIAGONALS``; print the verdicts and return {diagonal:
    dot_roundings}."""
    eye = torch.eye(N_DOT, dtype=torch.float32, device=device)
    k = np.arange(N_DOT, dtype=np.float64)
    verdicts = {}
    for label, step in DIAGONALS.items():
        vals = torch.as_tensor((1.0 + k * step).astype(np.float32),
                               device=device)
        got = torch.diagonal(tensor_core_dot(torch.diag(vals), eye, mode))
        verdicts[label] = dot_roundings(got, vals)
        print("f32 dot (%s), diag(%s): %s"
              % (mode, label, dot_verdict(verdicts[label])))
    return verdicts


# the shapes on which P2 is held against another build of itself: the
# random inputs of chip_smoke.py and the card tests
DOT_SHAPES = ((128, 128, 128), (48, 40, 24), (80, 40, 56), (1024, 1024, 1024))


def dot_equal_to_build(csrc, device):
    """Whether P2 as built from the sources in ``csrc`` (another checkout's
    ``raynet_tpu_torch/csrc``, whose ``raynet_probe_tf32_dot`` takes the
    same arguments) gives this build's products bit for bit
    (``torch.equal``), on seeded random (M, K) x (K, N) inputs of each of
    ``DOT_SHAPES`` in both modes: {"<mode> MxKxN": bool}."""
    other = cuda_build.load_library(csrc)
    rng = np.random.RandomState(3)
    equal = {}
    for m, k, n in DOT_SHAPES:
        x = torch.as_tensor(rng.randn(m, k).astype(np.float32), device=device)
        e = torch.as_tensor(rng.randn(k, n).astype(np.float32), device=device)
        for mode, rna in _RNA.items():
            mine = tensor_core_dot(x, e, mode)
            theirs = torch.empty_like(mine)
            cuda_build.launch("raynet_probe_tf32_dot", x, x.data_ptr(),
                              e.data_ptr(), theirs.data_ptr(), m, n, k, rna,
                              lib=other)
            equal["%s %dx%dx%d" % (mode, m, k, n)] = bool(
                torch.equal(mine, theirs))
    return equal


def run(variant, y0, xg0, sub0, src):
    """One P1 case on ``src``: True when the wrapper's rows equal the plain
    version's bit for bit."""
    offs = case_offsets(variant, y0, xg0, sub0)
    return torch.equal(tma_box_rows(src, *offs),
                       tma_box_rows_reference(src, *offs))


def main(argv=None):
    argparse.ArgumentParser(
        description="P1 (TMA box copy) and P2 (f32 product on the tensor "
                    "cores) on a CUDA card").parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_dma_align: needs a CUDA card "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print("card:", torch.cuda.get_device_name(device))
    ok = True
    for mode in MODES:
        verdicts = probe_f32_dot_truncation(device, mode)
        ok &= all(verdicts.values())
    src = box_source(device)
    for case in CASES:
        exact = run(*case, src)
        ok &= exact
        print("%s y0=%d xg0=%d sub0=%d -> %s"
              % (*case, "EXACT" if exact else "WRONG VALUES"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
