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
depth within 1e-5 relative on >= 0.999 of the rays.
"""
import numpy as np
import pytest
import torch

from raynet_tpu_torch.common.ring_scene import RingScene
from raynet_tpu_torch.inference import RayNetForwardPass
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.ops import bp_sweep as bp
from raynet_tpu_torch.ops import planesweep as ps
from raynet_tpu_torch.ops.mrf import log_prior
from raynet_tpu_torch.ops.sampling import segments_in_bbox

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
