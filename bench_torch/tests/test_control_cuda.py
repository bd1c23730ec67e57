"""On the card: the control of each cell (the plain reference in TF32 put
in the program's place) comes out not correct, at the cell's own size,
and the program on the same seed comes out correct. Skips without a card;
run on the card with ``python3 -m pytest bench_torch/tests -m cuda``."""
import pytest
import torch

from bench_torch import control, harness
from conftest import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["raynet.ring8_framed",
                                      "mvcnn_voxel.ring8_framed"])
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.Benchmark(REPO)
    limits = bench.config(bench.workload(workload)["config"])["limits"]
    r = control.readings(bench, workload, 2**31 + 101, True, "cuda")
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
