"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the test conftest, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

Tolerances: K1 feature cells exact and scores rtol=1e-5, atol=1e-6 (the
kernel sums features in another order); K2 counts exact, messages and
scatter rtol=1e-4, atol=1e-5 on short rays (M <= 64) with inputs that keep
the BP recurrence well conditioned (float atomics reorder the grid sums),
depth within 1e-5 relative on >= 0.999 of the rays; K3 indices and counts
exact; P1 equal to its plain version bit for bit; P2 within
2**-9 * (|x| @ |e|) of the float64 product (TF32 operands) and within
2**-16 * (|x| @ |e|) of the float64 product of its rounded operands ("rna":
only the f32 sums differ), its "rna" diagonal exact.
"""
import numpy as np
import pytest
import torch

from raynet_tpu_torch.common.ring_scene import RingScene
from raynet_tpu_torch.inference import (
    MultiViewCNNForwardPass,
    MultiViewCNNVoxelSpaceForwardPass,
    RayNetForwardPass,
)
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.ops import bp_sweep as bp
from raynet_tpu_torch.ops import planesweep as ps
from raynet_tpu_torch.ops import ray_marching as rm
from raynet_tpu_torch.ops.mrf import log_prior
from raynet_tpu_torch.ops.sampling import segments_in_bbox
from raynet_tpu_torch.tools import probe_dma_align as probes
from raynet_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

H, W, PAD = 60, 80, 11
PRIOR = float(log_prior(0.05))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the module "
                    "docstring)")
    return torch.device("cuda", 0)


def _rig(device, ref=1):
    scene = RingScene(6, H, W, 2750.0 / 1600 * W, angle_origin=1)
    cams = [scene.get_image(j).camera for j in scene.get_view_idxs(ref, 4)]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    P = f32(np.stack([c.P for c in cams]))
    P_pinv, center = f32(cams[0].P_pinv), f32(cams[0].center[:3, 0])
    bbox = f32(scene.bbox.reshape(-1))
    idxs = torch.arange(H * W, dtype=torch.int32, device=device)
    rs, re = segments_in_bbox(idxs, P_pinv, center, bbox, H)
    return P, center, bbox, rs, re


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D, F", [(8, 32), (32, 32), (40, 16), (3, 64)])
def test_plane_sweep_kernel_matches_plain(cuda, dtype, D, F):
    P, _, _, rs, re = _rig(cuda)
    g = torch.Generator(device="cpu").manual_seed(D * F)
    # scaled like the CNN's features: with N(0, 1) values and F=64 the
    # closed-form pair sum subtracts two ~300-sized sums and the
    # summation order alone moves the scores by ~1e-5
    feats = 0.25 * torch.randn((5, H + PAD + 1, W + PAD + 1, F), generator=g)
    feats = feats.to(device=cuda, dtype=dtype)
    ps.plane_sweep_scores.launches = 0
    S, cells = ps.plane_sweep_scores(feats, P, rs, re, PAD, H, W, D,
                                     return_cells=True)
    assert ps.plane_sweep_scores.launches == 1
    S_ref = ps.plane_sweep_scores_reference(feats, P, rs, re, PAD, H, W, D)
    cells_ref = ps.plane_sweep_cells_reference(P, rs, re, PAD, H, W, D)
    torch.cuda.synchronize()
    assert torch.equal(cells, cells_ref)
    torch.testing.assert_close(S, S_ref, rtol=1e-5, atol=1e-6)


def test_plane_sweep_kernel_rejects_what_it_cannot_take(cuda):
    P, _, _, rs, re = _rig(cuda)
    feats = torch.zeros((5, H + PAD + 1, W + PAD + 1, 12), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        ps.plane_sweep_scores(feats, P, rs, re, PAD, H, W, 8)
    feats = torch.zeros((5, H, W, 32), device=cuda)
    with pytest.raises(ValueError, match="cover"):
        ps.plane_sweep_scores(feats, P, rs, re, PAD, H, W, 8)
    feats = torch.zeros((5, H + PAD + 1, W + PAD + 1, 32), device=cuda)
    with pytest.raises(ValueError, match="P"):
        ps.plane_sweep_scores(feats, P.cpu(), rs, re, PAD, H, W, 8)


def _bp_inputs(device, grid, M, D=8, seed=0):
    P, center, bbox, rs, re = _rig(device)
    rng = np.random.RandomState(seed)
    n = rs.shape[0]
    G = int(np.prod(grid))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    S = torch.softmax(f32(rng.randn(n, D)), dim=-1)
    valid = torch.ones(n, dtype=torch.int32, device=device)
    valid[n - 100:] = 0
    grid_acc = f32(PRIOR + 2.0 + rng.randn(G))
    msgs = f32(0.5 * rng.randn(n, M))
    return rs, re, valid, S, msgs, grid_acc, center, bbox


@pytest.mark.parametrize("mode", ["first", "message", "depth"])
@pytest.mark.parametrize("grid, M", [((16, 16, 16), 32), ((32, 24, 16), 64)])
def test_bp_sweep_kernel_matches_plain(cuda, mode, grid, M):
    rs, re, valid, S, msgs, grid_acc, center, bbox = _bp_inputs(cuda, grid, M)
    G = int(np.prod(grid))
    gk = torch.full((G,), PRIOR, device=cuda)
    gp = gk.clone()
    args = (rs, re, valid, S, msgs, grid_acc)
    tail = (center, bbox, grid, M, PRIOR, mode)
    bp.bp_sweep.launches = 0
    mk, ck, dk = bp.bp_sweep(*args, gk, *tail)
    mp, cp, dp = bp.bp_sweep_reference(*args, gp, *tail)
    torch.cuda.synchronize()
    assert bp.bp_sweep.launches == 1
    assert torch.equal(ck, cp)
    assert int(cp.max()) > 1 and int(cp[-100:].max()) == 0
    if mode == "depth":
        assert mk is None and mp is None
        assert torch.equal(dk > 0, dp > 0)
        agree = ((dk - dp).abs() <= 1e-5 * dp.abs()).float().mean()
        assert float(agree) >= 0.999
    else:
        assert dk is None and dp is None
        torch.testing.assert_close(mk, mp, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-5)


def test_bp_sweep_kernel_single_voxel_rays(cuda):
    """One-voxel rays: zero messages, nothing scattered, and the depth of
    that voxel's centre in depth mode."""
    grid, M, G = (12, 12, 12), 24, 12 ** 3
    center = torch.tensor([0.0, 0.0, -20.0], device=cuda)
    bbox = torch.tensor([-3.0, -3, -3, 3, 3, 3], device=cuda)
    rs = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.3, 0.4]], device=cuda)
    re = torch.tensor([[0.4, 0.4, 0.4], [0.3, 0.2, 0.1]], device=cuda)
    S = torch.full((2, 8), 1.0 / 8, device=cuda)
    valid = torch.ones(2, dtype=torch.int32, device=cuda)
    grid_out = torch.zeros(G, device=cuda)
    msgs, counts, _ = bp.bp_sweep(rs, re, valid, S, None, None, grid_out,
                                  center, bbox, grid, M, PRIOR, "first")
    assert counts.tolist() == [1, 1]
    assert not msgs.any() and not grid_out.any()
    _, _, depth = bp.bp_sweep(
        rs, re, valid, S, torch.zeros((2, M), device=cuda),
        torch.full((G,), PRIOR, device=cuda), None, center, bbox, grid, M,
        PRIOR, "depth",
    )
    expect = torch.linalg.norm(torch.full((3,), 0.25, device=cuda) - center)
    torch.testing.assert_close(depth, expect.expand(2), rtol=1e-6, atol=0)


def test_forward_pass_on_the_card_matches_the_cpu(cuda):
    scene = RingScene(6, 36, 48, 400.0, angle_step=0.05)
    gp = type("GP", (), dict(
        depth_planes=8, neighbors=4, padding=PAD,
        grid_shape=np.array([12, 12, 12], np.int32),
        max_number_of_marched_voxels=24, gamma_mrf=0.05,
    ))()
    model = FeatureExtractor("simple_cnn", seed=0, device=cuda)
    ps.plane_sweep_scores.launches = 0
    bp.bp_sweep.launches = 0
    fp = RayNetForwardPass(model, gp, None, scene.image_shape, 700,
                           device=cuda)
    gpu = np.stack(list(fp.forward_pass(scene, (0, 2, 1))))
    assert ps.plane_sweep_scores.launches == 2 * 3
    assert bp.bp_sweep.launches == 2 * 3 * 4
    # the CPU pass reads the same features (computed on the card)
    fp_cpu = RayNetForwardPass(model, gp, None, scene.image_shape, 700,
                               device="cpu")
    cpu = np.stack(list(fp_cpu.forward_pass(scene, (0, 2, 1))))
    assert np.array_equal(gpu > 0, cpu > 0)
    assert np.mean(np.abs(gpu - cpu) <= 1e-3 * np.abs(cpu)) >= 0.999


def _traversal_inputs(device, geometry):
    """(bbox, ray_start, ray_end) of one test geometry, float32 on device."""
    rng = np.random.RandomState(3)
    if geometry == "ring":
        _, _, bbox, rs, re = _rig(device)
        return bbox, rs, re
    bbox = np.array([-2.0, -1.0, 0.5, 2.0, 3.0, 4.5], dtype=np.float32)
    n = 1000  # not a multiple of the kernel's 128-thread block
    lo, hi = bbox[:3], bbox[3:]
    if geometry == "misses":
        rs = np.tile(lo - 10.0, (n, 1))
        re = rs + 1.0
    else:  # opposite faces in both directions, exact diagonals first
        rs = rng.uniform(lo, hi, (n, 3))
        re = rng.uniform(lo, hi, (n, 3))
        flip = rng.rand(n) < 0.5
        rs[:, 2] = np.where(flip, hi[2], lo[2])
        re[:, 2] = lo[2] + hi[2] - rs[:, 2]
        rs[:8], re[:8] = lo, hi
        rs[8:16], re[8:16] = hi, lo

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return f32(bbox), f32(rs), f32(re)


@pytest.mark.parametrize("geometry, grid, M", [
    ("ring", (12, 12, 12), 24), ("ring", (128, 128, 64), 384),
    ("faces", (7, 11, 6), 40), ("faces", (7, 11, 6), 1),
    ("misses", (4, 4, 4), 8),
])
def test_traversal_kernel_matches_plain(cuda, geometry, grid, M):
    bbox, rs, re = _traversal_inputs(cuda, geometry)
    # leave garbage where the caching allocator will put the outputs: the
    # kernel must write every entry itself
    junk = torch.full((rs.shape[0], M + 1), -7, dtype=torch.int32,
                      device=cuda)
    del junk
    rm.voxel_traversal_flat.launches = 0
    idx, counts = rm.voxel_traversal_flat(bbox, rs, re, grid, M)
    assert rm.voxel_traversal_flat.launches == 1
    ref_idx, ref_counts = rm.voxel_traversal_flat_reference(
        bbox, rs, re, grid, M)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int32 and idx.shape == (rs.shape[0], M)
    assert torch.equal(counts, ref_counts)
    assert torch.equal(idx, ref_idx)
    if geometry == "misses":
        assert not counts.any()
    elif M > 1:
        assert int(counts.max()) > 1


def test_traversal_kernel_counts_equal_bp_sweep_counts(cuda):
    grid, M = (32, 24, 16), 64
    rs, re, valid, S, _, _, center, bbox = _bp_inputs(cuda, grid, M)
    valid.fill_(1)
    _, counts, _ = bp.bp_sweep(rs, re, valid, S, None, None,
                               torch.zeros(int(np.prod(grid)), device=cuda),
                               center, bbox, grid, M, PRIOR, "first")
    _, k3_counts = rm.voxel_traversal_flat(bbox, rs, re, grid, M)
    torch.cuda.synchronize()
    assert torch.equal(k3_counts, counts)


def test_traversal_kernel_rejects_what_it_cannot_take(cuda):
    bbox, rs, re = _traversal_inputs(cuda, "faces")
    with pytest.raises(ValueError, match="bbox"):
        rm.voxel_traversal_flat(bbox.cpu(), rs, re, (4, 4, 4), 8)
    with pytest.raises(ValueError, match="float32"):
        rm.voxel_traversal_flat(bbox, rs.double(), re, (4, 4, 4), 8)
    with pytest.raises(ValueError, match="contiguous"):
        rm.voxel_traversal_flat(bbox, rs.t().contiguous().t(), re,
                                (4, 4, 4), 8)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        rm.voxel_traversal_flat(bbox, rs, re, (2048, 1024, 1024), 8)


@pytest.mark.parametrize("cls, kernels", [
    (MultiViewCNNForwardPass, 1), (MultiViewCNNVoxelSpaceForwardPass, 2),
])
def test_mvcnn_passes_on_the_card_match_the_cpu(cuda, cls, kernels):
    scene = RingScene(6, 36, 48, 400.0, angle_step=0.05)
    gp = type("GP", (), dict(
        depth_planes=8, neighbors=4, padding=PAD,
        grid_shape=np.array([12, 12, 12], np.int32),
        max_number_of_marched_voxels=24, gamma_mrf=0.05,
    ))()
    model = FeatureExtractor("simple_cnn", seed=0, device=cuda)
    ps.plane_sweep_scores.launches = 0
    rm.voxel_traversal_flat.launches = 0
    fp = cls(model, gp, None, scene.image_shape, 700, device=cuda)
    gpu = np.stack(list(fp.forward_pass(scene, (0, 2, 1))))
    assert ps.plane_sweep_scores.launches == 2 * 3
    assert rm.voxel_traversal_flat.launches == (2 * 3 if kernels == 2 else 0)
    fp_cpu = cls(model, gp, None, scene.image_shape, 700, device="cpu")
    cpu = np.stack(list(fp_cpu.forward_pass(scene, (0, 2, 1))))
    assert np.array_equal(gpu > 0, cpu > 0)
    assert np.mean(np.abs(gpu - cpu) <= 1e-3 * np.abs(cpu)) >= 0.999


@pytest.mark.parametrize("case", probes.CASES, ids=lambda c: "%s-%d-%d-%d" % c)
def test_tma_box_kernel_matches_plain(cuda, case):
    src = probes.box_source(cuda)
    offs = probes.case_offsets(*case)
    probes.tma_box_rows.launches = 0
    got = probes.tma_box_rows(src, *offs)
    assert probes.tma_box_rows.launches == 1
    assert torch.equal(got, probes.tma_box_rows_reference(src, *offs))


def test_tma_box_kernel_reads_the_sources_own_shape(cuda):
    g = torch.Generator(device="cpu").manual_seed(7)
    src = torch.randn((57, 100, 128), generator=g).to(cuda, torch.bfloat16)
    for offs in ((100 - probes.BH, 57 - probes.BWG, 8), (13, 31, 5)):
        got = probes.tma_box_rows(src, *offs)
        assert torch.equal(got, probes.tma_box_rows_reference(src, *offs))


@pytest.mark.parametrize("mode", ["raw", "rna"])
@pytest.mark.parametrize("m, k, n", [(128, 128, 128), (48, 40, 24)])
def test_tensor_core_dot_kernel_matches_plain(cuda, mode, m, k, n):
    # the diagonal names the operand rounding; the random, non-symmetric
    # product is then held to its plain version (rounded operands' products
    # are exact in f32, only the sums round) and loosely to float64
    vals = torch.as_tensor((1 + np.arange(128) * 2.0 ** -13)
                           .astype(np.float32), device=cuda)
    diag = torch.diagonal(probes.tensor_core_dot(
        torch.diag(vals), torch.eye(128, device=cuda), mode))
    roundings = probes.dot_roundings(diag, vals)
    if mode == "rna":
        assert torch.equal(diag, probes.round_operand(vals, "tf32_rna"))
    assert roundings
    rng = np.random.RandomState(m + n)
    x = torch.as_tensor(rng.randn(m, k).astype(np.float32), device=cuda)
    e = torch.as_tensor(rng.randn(k, n).astype(np.float32), device=cuda)
    probes.tensor_core_dot.launches = 0
    got = probes.tensor_core_dot(x, e, mode)
    assert probes.tensor_core_dot.launches == 1
    scale = x.double().abs() @ e.double().abs()
    err = (got.double() - x.double() @ e.double()).abs()
    assert bool((err <= 2.0 ** -9 * scale).all())
    ref = probes.tensor_core_dot_reference(x, e, roundings[0]).double()
    assert bool(((got.double() - ref).abs() <= 2.0 ** -16 * scale).all())


def test_trace_holds_device_work(cuda, tmp_path):
    x = torch.randn((512, 512), device=cuda)
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("window"):
            for _ in range(4):
                x = x @ x / 512
            torch.cuda.synchronize()
    events = profiling.read_trace(str(tmp_path / profiling.TRACE_NAME))
    intervals = [iv[1:] for iv in profiling.device_intervals(events)]
    assert len(intervals) >= 4
    share = profiling.device_busy_share(
        intervals, profiling.annotation_window(events, "window"))
    assert 0.0 < share <= 1.0
