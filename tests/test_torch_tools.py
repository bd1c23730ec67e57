"""The port's measurement tools on the CPU: the roofline counts, the
profiler helpers, and the entry points' refusal to run without a card.

The byte totals and bounds are those ``chip_smoke.py`` printed for its
65,536-ray batch (V=5, D=32, F=32 bf16, M=384, grid 128x128x64) with that
batch's counts: 609,377 feature rows, 3,569,246 visits, 76,900 distinct
cells; and for one whole image (the 1,920,000 rays of view 0): 8,787,774
feature rows, 58,617,680 visits, all 1,048,576 cells.
"""
import os

import numpy as np
import pytest
import torch

from raynet_tpu_torch.tools import probe_dma_align, roofline, time_kernels
from raynet_tpu_torch.utils import profiling

N, V, D, F, M = 65536, 5, 32, 32, 384
ROWS, VISITS, CELLS = 609377, 3569246, 76900
N_IMG, ROWS_IMG, VISITS_IMG, CELLS_IMG = 1920000, 8787774, 58617680, 1048576


@pytest.mark.parametrize("cost, mb, bound_ms, bound_by", [
    (roofline.plane_sweep_cost(N, V, D, F, 2, ROWS), 49.0, 0.0182,
     "operations"),
    (roofline.bp_sweep_cost("first", N, D, VISITS, CELLS), 24.8, 0.0074,
     "bytes"),
    (roofline.bp_sweep_cost("message", N, D, VISITS, CELLS), 39.4, 0.0118,
     "bytes"),
    (roofline.bp_sweep_cost("depth", N, D, VISITS, CELLS), 25.1, 0.0075,
     "bytes"),
    (roofline.voxel_traversal_cost(N, M, VISITS), 102.5, 0.0306, "bytes"),
    (roofline.plane_sweep_cost(N_IMG, V, D, F, 2, ROWS_IMG), 854.3, 0.5319,
     "operations"),
    (roofline.bp_sweep_cost("first", N_IMG, D, VISITS_IMG, CELLS_IMG), 538.2,
     0.1607, "bytes"),
    (roofline.bp_sweep_cost("message", N_IMG, D, VISITS_IMG, CELLS_IMG),
     776.9, 0.2319, "bytes"),
    (roofline.bp_sweep_cost("depth", N_IMG, D, VISITS_IMG, CELLS_IMG), 545.9,
     0.1629, "bytes"),
    (roofline.voxel_traversal_cost(N_IMG, M, VISITS_IMG), 3002.9, 0.8964,
     "bytes"),
    (roofline.voxel_depth_cost(N, D, VISITS), 10.5, 0.0031, "bytes"),
    (roofline.voxel_depth_cost(N_IMG, D, VISITS_IMG), 307.2, 0.0917,
     "bytes"),
], ids=["K1", "K2-first", "K2-message", "K2-depth", "K3", "K1-image",
        "K2-first-image", "K2-message-image", "K2-depth-image", "K3-image",
        "K3-depth", "K3-depth-image"])
def test_roofline_reproduces_the_chip_smoke_bounds(cost, mb, bound_ms,
                                                   bound_by):
    assert round(cost.nbytes / 1e6, 1) == mb
    ms, by = roofline.bound(cost)
    assert round(ms, 4) == bound_ms and by == bound_by


def test_roofline_probe_costs():
    p1 = roofline.tma_box_cost()
    # the 4 x-groups of bf16 the rows come from, and the f32 rows
    assert p1.nbytes == 16384 + 32768
    assert roofline.bound(p1) == (49152 / 3.35e12 * 1e3, "bytes")
    p2 = roofline.tensor_core_dot_cost(128)
    assert p2.nbytes == 3 * 64 * 1024 and p2.ops == 2 * 128 ** 3
    assert p2.peak_ops == roofline.PEAK_TF32_FLOPS == 495e12
    assert roofline.bound(p2)[1] == "bytes"


def test_roofline_batch_counts_match_brute_force():
    rng = np.random.RandomState(0)
    shape = (3, 7, 9, 8)
    cells = rng.randint(0, 7, size=(50, 4, 3, 2))
    cells[..., 0] = rng.randint(0, 9, size=(50, 4, 3))
    rows = {(v, int(c[1]), int(c[0])) for r in cells for d in r
            for v, c in enumerate(d)}
    assert roofline.feature_rows(torch.as_tensor(cells), shape) == len(rows)

    idx = rng.randint(0, 40, size=(30, 12)).astype(np.int32)
    counts = rng.randint(0, 13, size=30).astype(np.int32)
    visits, distinct = roofline.march_counts(torch.as_tensor(idx),
                                             torch.as_tensor(counts))
    assert visits == counts.sum()
    assert distinct == len({int(v) for i, c in enumerate(counts)
                            for v in idx[i, :c]})


@pytest.mark.parametrize("intervals, window, share", [
    ([(0, 2), (1, 3), (5, 6), (9, 12)], (0, 10), 0.5),
    ([(2, 8), (3, 4), (4, 5)], (0, 10), 0.6),
    ([(-5, 1), (11, 20), (12, 13)], (0, 10), 0.1),
    ([], (0, 10), 0.0),
    ([(0, 10), (0, 10)], (0, 10), 1.0),
])
def test_device_busy_share_counts_overlaps_once(intervals, window, share):
    assert profiling.device_busy_share(intervals, window) == pytest.approx(
        share)


def test_trace_writes_phases_and_reads_back(tmp_path):
    timer = profiling.PhaseTimer()
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("outer"):
            with timer.phase("Plane sweep"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.summary()["Plane sweep"]["count"] == 1
    path = tmp_path / profiling.TRACE_NAME
    assert os.path.getsize(path) > 0
    events = profiling.read_trace(str(path))
    outer = profiling.annotation_window(events, "outer")
    inner = profiling.annotation_window(events, "Plane sweep")
    assert outer[0] <= inner[0] <= inner[1] <= outer[1]
    assert profiling.device_intervals(events) == []  # no card here
    with pytest.raises(KeyError):
        profiling.annotation_window(events, "missing")


@pytest.mark.parametrize("main", [time_kernels.main, probe_dma_align.main],
                         ids=["time_kernels", "probe_dma_align"])
def test_entry_points_exit_nonzero_without_a_card(main, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert main([]) != 0
    assert "needs a CUDA card" in capsys.readouterr().err


def test_round_orders_alternate():
    assert time_kernels.round_orders(["a", "b", "c"], 3) == [
        ["a", "b", "c"], ["c", "b", "a"], ["a", "b", "c"]]


def test_time_kernels_parent_needs_the_rig(capsys):
    with pytest.raises(SystemExit):
        time_kernels.main(["--probes", "--parent", "elsewhere"])
    assert "--parent" in capsys.readouterr().err


@pytest.mark.parametrize("case", probe_dma_align.CASES,
                         ids=lambda c: "%s-%d-%d-%d" % c)
def test_box_rows_library_computes_p1s_rows(case):
    src = probe_dma_align.box_source("cpu")
    offs = probe_dma_align.case_offsets(*case)
    assert torch.equal(time_kernels.box_rows_library(src, *offs),
                       probe_dma_align.tma_box_rows_reference(src, *offs))


def test_time_kernels_rig_parameters():
    gp = time_kernels.generation_params()
    assert (gp.depth_planes, gp.max_number_of_marched_voxels) == (D, M)
    assert tuple(gp.grid_shape) == time_kernels.GRID == (128, 128, 64)
    assert time_kernels.N_RAYS == N


def test_k2_rows_time_each_mode_with_and_without_stored_sums():
    """``_k2_rows`` (on the CPU its launches take the plain path): a row per
    mode that counts, then one per mode with the first sweep's stored ray
    sums, each launch returning what the counting launch returns."""
    import types

    gen = torch.Generator().manual_seed(0)
    n = 64
    bbox = torch.tensor([-3.0, -3.0, -3.0, 3.0, 3.0, 3.0])
    rs = -3.0 + 6.0 * torch.rand(n, 3, generator=gen)
    re = -3.0 + 6.0 * torch.rand(n, 3, generator=gen)
    S = torch.softmax(torch.randn(n, time_kernels.D, generator=gen), -1)
    rig = types.SimpleNamespace(center=torch.tensor([0.0, 0.0, -20.0]),
                                bbox=bbox)
    rows = {}

    def row(name, cost, kernel, reference, **counts):
        assert reference is None or name.endswith(("first", "message",
                                                   "depth"))
        rows[name] = [t.clone() if t is not None else None for t in kernel()]

    time_kernels._k2_rows(row, "", rig, rs, re, S, 100, 50)
    modes = ("first", "message", "depth")
    assert list(rows) == ["K2 " + m for m in modes] + [
        "K2 %s sums" % m for m in modes]
    for mode in modes:
        counted, stored = rows["K2 " + mode], rows["K2 %s sums" % mode]
        assert int(counted[1].max()) > 1
        assert torch.equal(counted[1], stored[1])
        if mode == "depth":
            assert torch.equal(counted[2], stored[2])
    assert torch.equal(rows["K2 first"][0], rows["K2 first sums"][0])
