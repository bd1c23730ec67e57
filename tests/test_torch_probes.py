"""The port's probes P1 and P2 against the JAX package's, on the CPU.

The JAX probes (``tools/probe_dma_align.py``) run their Pallas kernels in
interpret mode; the port's wrappers take their plain versions for CPU
tensors. P1 must equal the JAX probe's expected rows bit for bit; P2 with
no operand rounding must give a diagonal back exactly, as the JAX probe
does in interpret mode. The operand roundings are held to numpy bit
arithmetic written independently, ties included. The Python around the
kernels' launch is tested here too: which shapes P2 takes, the device
guard, and ``time_kernels``' host/device split with fake clocks.
"""
import contextlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raynet_tpu_torch.ops import cuda_build
from raynet_tpu_torch.tools import probe_dma_align as tp
from raynet_tpu_torch.tools import time_kernels

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_dma_align", REPO_ROOT / "tools" / "probe_dma_align.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_expected(variant, y0, xg0, sub0):
    """The JAX probe's expected rows (tools/probe_dma_align.py:81-88)."""
    rng = np.random.RandomState(0)
    src = jnp.asarray(rng.randn(tp.WG, tp.HF, 128).astype(np.float32),
                      jnp.bfloat16)
    y0, xg0 = (y0, xg0) if variant in ("D", "D2") else (0, 0)
    box = np.asarray(src[xg0:xg0 + tp.BWG, y0:y0 + tp.BH]
                     .astype(jnp.float32)).reshape(tp.BWG * tp.BH, 128)
    if variant in ("A", "B"):
        return box[:4 * tp.BH]
    return box[sub0 * tp.BH:(sub0 + 4) * tp.BH]


@pytest.mark.parametrize("case", tp.CASES, ids=lambda c: "%s-%d-%d-%d" % c)
def test_box_probe_meets_the_jax_probe(jax_probe, case):
    with pltpu.force_tpu_interpret_mode():
        assert jax_probe.run(*case)
    tp.tma_box_rows.launches = 0
    got = tp.tma_box_rows(tp.box_source("cpu"), *tp.case_offsets(*case))
    assert tp.tma_box_rows.launches == 0
    assert got.dtype == torch.float32 and got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), _jax_expected(*case))


def test_f32_dot_probe_exact_on_the_cpu(jax_probe, capsys):
    with pltpu.force_tpu_interpret_mode():
        jax_probe.probe_f32_dot_truncation()
    assert "EXACT" in capsys.readouterr().out
    verdicts = tp.probe_f32_dot_truncation("cpu", "raw")
    assert all(v == ["none"] for v in verdicts.values())
    assert "f32 dot (raw), diag(1 + k 2^-18): EXACT" in capsys.readouterr().out
    vals = torch.as_tensor(
        (1.0 + np.arange(128) * 2.0 ** -18).astype(np.float32))
    got = tp.tensor_core_dot(torch.diag(vals), torch.eye(128), "raw")
    assert torch.equal(torch.diagonal(got), vals)
    # the finer diagonal tells the TF32 roundings apart
    verdicts = tp.probe_f32_dot_truncation("cpu", "rna")
    assert verdicts["1 + k 2^-13"] == ["tf32_rna"]
    assert verdicts["1 + k 2^-18"] == ["tf32_truncate", "tf32_rna", "bf16"]
    out = capsys.readouterr().out
    assert "diag(1 + k 2^-13): TRUNCATED (matches tf32-RNA)\n" in out
    assert tp.dot_verdict([]) == (
        "TRUNCATED (matches none of tf32-truncate, tf32-RNA, bf16)")


def _numpy_round(bits, rounding):
    """Round f32 bit patterns (uint32) by magnitude, in uint64."""
    b = bits.astype(np.uint64)
    sign, mag = b & 0x80000000, b & 0x7FFFFFFF
    low_bits = {"tf32_truncate": 13, "tf32_rna": 13, "bf16": 16}[rounding]
    unit = np.uint64(1 << low_bits)
    low = mag & (unit - np.uint64(1))
    up = mag - low
    if rounding == "tf32_rna":
        up = np.where(low >= unit // 2, up + unit, up)
    elif rounding == "bf16":
        odd = (mag >> np.uint64(low_bits)) & np.uint64(1)
        half = unit // 2
        up = np.where((low > half) | ((low == half) & (odd == 1)),
                      up + unit, up)
    out = (sign | up).astype(np.uint32)
    return np.where((bits & 0x7F800000) == 0x7F800000, bits, out)


def _test_bits():
    rng = np.random.RandomState(5)
    bits = rng.randint(0, 2 ** 32, size=20000, dtype=np.uint64)
    bits = bits.astype(np.uint32)
    # exact ties of TF32's and bf16's last bit, of both signs and parities
    ties = rng.randint(0, 2 ** 32, size=4000, dtype=np.uint64)
    ties = ties.astype(np.uint32)
    tf32_ties = (ties[:2000] & ~np.uint32(0x1FFF)) | np.uint32(0x1000)
    bf16_ties = (ties[2000:] & ~np.uint32(0xFFFF)) | np.uint32(0x8000)
    special = np.array([0, 0x80000000, 1, 0x1000, 0x7F7FFFFF, 0xFF7FFFFF,
                        0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,
                        0x3F800000, 0x3F801000, 0x3F803000, 0xBF801000],
                       dtype=np.uint32)
    return np.concatenate([bits, tf32_ties, bf16_ties, special])


@pytest.mark.parametrize("rounding", ["tf32_truncate", "tf32_rna", "bf16"])
def test_operand_roundings_match_numpy_bits(rounding):
    bits = _test_bits()
    x = torch.from_numpy(bits.view(np.int32).copy()).view(torch.float32)
    got = tp.round_operand(x, rounding).view(torch.int32).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _numpy_round(bits, rounding))
    if rounding == "bf16":  # ties to even, as jnp and torch cast
        finite = (bits & 0x7F800000) != 0x7F800000
        xf = bits.view(np.float32)[finite]
        ref = np.asarray(jnp.asarray(xf, jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got.view(np.float32)[finite], ref)
    assert tp.round_operand(x, "none") is x


def test_tf32_rna_rounds_ties_away_from_zero():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + 3 * one_ulp / 2, 1 + one_ulp / 2 - 2.0 ** -23],
                     dtype=torch.float32)
    got = tp.round_operand(x, "tf32_rna").tolist()
    assert got == [1 + one_ulp, -(1 + one_ulp), 1 + 2 * one_ulp, 1.0]
    assert tp.round_operand(x, "tf32_truncate").tolist() == [
        1.0, -1.0, 1 + one_ulp, 1.0]


@pytest.mark.parametrize("mode", ["raw", "rna"])
def test_tensor_core_dot_plain_version(mode):
    rng = np.random.RandomState(2)
    x = torch.as_tensor(rng.randn(32, 24).astype(np.float32))
    e = torch.as_tensor(rng.randn(24, 16).astype(np.float32))
    got = tp.tensor_core_dot(x, e, mode)
    exact = x.double() @ e.double()
    tol = 2.0 ** -9 * (x.double().abs() @ e.double().abs())
    assert got.shape == (32, 16) and got.dtype == torch.float32
    assert bool(((got.double() - exact).abs() <= tol).all())
    if mode == "raw":
        assert torch.equal(got, exact.float())
    else:
        assert not torch.equal(got, exact.float())


def test_wrappers_reject_what_the_kernels_cannot_take():
    src = tp.box_source("cpu")
    for offs in ((tp.HF - tp.BH + 1, 0, 0), (0, -1, 0), (0, 0, 9),
                 (0, tp.WG - tp.BWG + 1, 0)):
        with pytest.raises(ValueError, match="outside"):
            tp.tma_box_rows(src, *offs)
    flat = torch.zeros(tp.WG * tp.HF * 128 + 8, dtype=torch.bfloat16)
    misaligned = flat[1:1 + tp.WG * tp.HF * 128].view(tp.WG, tp.HF, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tp.tma_box_rows(misaligned, 0, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tp.tma_box_rows(src.transpose(0, 1), 0, 0, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        tp.tma_box_rows(src.float(), 0, 0, 0)

    x = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="mode"):
        tp.tensor_core_dot(x, x, "tf32")
    with pytest.raises(ValueError, match="contiguous"):
        tp.tensor_core_dot(torch.zeros(128, 256)[:, ::2], x, "raw")
    with pytest.raises(ValueError, match="M % 16"):
        tp.tensor_core_dot(torch.zeros(100, 128), x, "raw")
    with pytest.raises(ValueError, match="float32"):
        tp.tensor_core_dot(x.double(), x, "raw")
    with pytest.raises(ValueError, match="unknown rounding"):
        tp.round_operand(x, "fp8")


@pytest.mark.parametrize("m, k, n", [(16, 8, 8), (48, 40, 24), (80, 40, 56),
                                     (128, 128, 128)])
def test_tensor_core_dot_accepts_every_multiple_of_its_tile(m, k, n):
    """M % 16, N % 8 and K % 8 zero, whatever the kernel's block tiles."""
    x, e = torch.ones(m, k), torch.ones(k, n)
    got = tp.tensor_core_dot(x, e, "raw")
    assert got.shape == (m, n) and bool((got == k).all())


@pytest.mark.parametrize("xs, es", [((40, 128), (128, 128)),
                                    ((128, 128), (128, 60)),
                                    ((128, 36), (36, 128)),
                                    ((128, 128), (120, 128))],
                         ids=["M", "N", "K", "K-mismatch"])
def test_tensor_core_dot_rejects_shapes_off_its_tile(xs, es):
    with pytest.raises(ValueError, match="M % 16"):
        tp.tensor_core_dot(torch.zeros(xs), torch.zeros(es), "rna")


def test_device_guard_switches_only_to_another_device():
    assert isinstance(cuda_build.device_guard(1, current=1),
                      contextlib.nullcontext)
    assert cuda_build.device_guard(1, current=1) is (
        cuda_build.device_guard(0, current=0))
    switch = cuda_build.device_guard(1, current=0)
    assert isinstance(switch, torch.cuda.device) and switch.idx == 1


def test_host_us_reads_the_clock_around_the_calls():
    ticks = iter([10.0, 10.5])
    calls, syncs = [], []
    us = time_kernels.host_us(lambda: calls.append(1), calls=100,
                              clock=lambda: next(ticks),
                              sync=lambda: syncs.append(len(calls)))
    # one call and a sync before the clock starts, one sync after it stops
    assert us == pytest.approx(0.5 / 100 * 1e6)
    assert len(calls) == 101 and syncs == [1, 101]


def test_kernel_device_ms_sums_the_named_intervals():
    intervals = [("void tf32_dot_kernel<true, 4>(float*)", 0.0, 3.0),
                 ("void tf32_dot_kernel<true, 4>(float*)", 10.0, 14.0),
                 ("Memset (Device)", 4.0, 5.0),
                 ("ampere_sgemm_128x64", 20.0, 26.0)]
    assert time_kernels.kernel_device_ms(intervals, 2, "tf32_dot_kernel") == (
        pytest.approx(0.0035))
    assert time_kernels.kernel_device_ms(intervals, 2) == pytest.approx(
        0.007)
    assert time_kernels.kernel_device_ms(intervals, 2, "missing") is None


def test_host_device_split_row_fields():
    kernel, library = object(), object()
    host = {kernel: 12.5, library: 20.0}
    device = {(kernel, "tf32_dot_kernel"): 0.003, (library, None): 0.004}
    split = time_kernels.host_device_split(
        kernel, library, "tf32_dot_kernel", host=host.__getitem__,
        device=lambda fn, name=None: device[fn, name])
    assert split == {"host_us": 12.5, "device_ms": 0.003,
                     "library_host_us": 20.0, "library_device_ms": 0.004}
    assert tuple(split) == time_kernels.SPLIT_KEYS
    rows = [{"name": "P2", "ms": 0.02, "bound_ms": 5.9e-5,
             "bound_by": "bytes", "plain_ms": None, "library_ms": 0.018,
             **split},
            {"name": "K1", "ms": 0.17, "bound_ms": 0.018,
             "bound_by": "operations", "plain_ms": None, "library_ms": None,
             **dict.fromkeys(time_kernels.SPLIT_KEYS)}]
    lines = time_kernels.format_rows(rows)
    assert len(lines) == 4  # header, P2 and its split, K1
    assert "host 12.50 us, device 0.00300 ms" in lines[2]
    assert "library host 20.00 us, device 0.00400 ms" in lines[2]
    # a trace that caught none of the library's work: not measured
    rows[0]["library_device_ms"] = None
    assert "library host 20.00 us, device - ms" in (
        time_kernels.format_rows(rows)[2])


def test_another_checkouts_build_goes_under_this_build_root(tmp_path,
                                                            monkeypatch):
    """``load_library`` reads another checkout's sources and builds them
    into this tree's ``BUILD_ROOT/other-<hash>/``, writing nothing beside
    those sources and leaving ``build_seconds`` to this package's build."""
    (tmp_path / "kernel.cu").write_text("// another checkout's kernel\n")
    loads = []
    monkeypatch.setattr(cuda_build, "_load",
                        lambda csrc, out: loads.append((csrc, out)) or (
                            "library", 1.5))
    monkeypatch.setattr(cuda_build, "build_seconds", None)
    assert cuda_build.load_library(tmp_path) == "library"
    assert loads == [(tmp_path, cuda_build.BUILD_ROOT / (
        "other-" + cuda_build.source_hash(tmp_path)))]
    assert [p.name for p in tmp_path.iterdir()] == ["kernel.cu"]
    assert cuda_build.build_seconds is None
