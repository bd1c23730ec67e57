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
store entries the kernel must not write exact, NaN (from NaN grid cells)
in the same places as the plain version, depth within 1e-5 relative on
>= 0.999 of the rays; K2 reading stored ray sums equal to K2 counting them
bit for bit (messages, counts, depths; the grid within the atomics'
rtol 1e-4, atol 1e-5), its first sweep's totals equal to the plain float64
sums rounded to float32; K3 indices and counts
exact; K3's voxel-depth mode counts and zero masks exact, depth within
1e-3 relative on >= 0.999 of the rays and every other ray at a voxel whose
plain mapped score is within rtol 1e-5 of the ray's maximum (the plain
version divides the scores by their total, which can merge two an ulp
apart), zero-length rays at their first voxel; P1 equal to its plain
version bit for bit, whichever sources it was called on before; P2 (up
to 1024^3, on shapes that leave its block tiles partly empty, and on
operands off 16-byte alignment) within
2**-9 * (|x| @ |e|) of the float64 product (TF32 operands) and within
2**-16 * (|x| @ |e|) of the float64 product of its rounded operands ("rna":
only the f32 sums differ), its "rna" diagonal exact; the voxel-space and
raynet passes' depth maps bit for bit the numpy scatter of their depths,
in page-locked memory, and a call whose features are cached free of
synchronising operations; a 1600x1200 view's features, BatchNorm folded
into the convolutions, within rtol = atol = 1e-4 of the CPU's unfolded
stack on >= 0.999 of the elements, with no BatchNorm kernel; K4 (the
MVSNet cost volume) within rtol 1e-5, atol 1e-6 of its plain version on
>= 0.999 of the values, in its plane mode and in its per-pixel mode
(CasMVSNet's later stages), and the per-pixel mode at a centre of 0 equal
to the plane mode bit for bit; K5 (the U-Net's transposed convs) within 2**-18
of each output's sum of absolute terms of its plain version; K6 (the
U-Net's entry conv) within 2**-18 of each output's sum of absolute terms
of the float64 conv3d, bias and ReLU, and equal to itself bit for bit on
a second run; K7 (the U-Net's prob conv) within 2**-18 of each output's
sum of absolute terms of the float64 conv3d at seven planes and of its
plain version over the whole volume, with and without its bias, and
equal to itself bit for bit on a second run; and the
MVSNet pass's depths within 1e-3 of a plane interval of the CPU pass's on
>= 0.999 of the pixels, the CasMVSNet pass's within 5e-3 of its last
stage's interval (its first two stages' errors carry into the last stage's
hypotheses, see ``tests/test_torch_casmvsnet.py``); in a traced pass of
either at the cells' widths, each volume's 11 U-Net layer timers within 3%
of its "Cost regularization" phase, and the entry conv's and the prob
conv's timers each within 10% of K6's and K7's device time in the same
trace.
"""
import contextlib
import time
import warnings

import numpy as np
import pytest
import torch

from bench_torch.scene import cnn_weights
from raynet_tpu_torch.common.ring_scene import RingScene
from raynet_tpu_torch.inference import (
    CasMVSNetForwardPass,
    MultiViewCNNForwardPass,
    MultiViewCNNVoxelSpaceForwardPass,
    MVSNetForwardPass,
    RayNetForwardPass,
)
from raynet_tpu_torch.models import casmvsnet
from raynet_tpu_torch.models.casmvsnet import CasMVSNetModel
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.models.mvsnet import UNET_LABELS, MVSNetModel
from raynet_tpu_torch.ops import bp_sweep as bp
from raynet_tpu_torch.ops import cost_volume as cv
from raynet_tpu_torch.ops import entry_conv3d as ec
from raynet_tpu_torch.ops import fused
from raynet_tpu_torch.ops import planesweep as ps
from raynet_tpu_torch.ops import prob_conv3d as pc
from raynet_tpu_torch.ops import ray_marching as rm
from raynet_tpu_torch.ops import transposed_conv3d as tc
from raynet_tpu_torch.ops import voxel_depth as vd
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


def _rig(device, ref=1, shape=(H, W), n=None):
    """Cameras and the bbox segments of the first ``n`` rays (all by
    default) of a ring scene of ``shape``."""
    h, w = shape
    scene = RingScene(6, h, w, 2750.0 / 1600 * w, angle_origin=1)
    cams = [scene.get_image(j).camera for j in scene.get_view_idxs(ref, 4)]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    P = f32(np.stack([c.P for c in cams]))
    P_pinv, center = f32(cams[0].P_pinv), f32(cams[0].center[:3, 0])
    bbox = f32(scene.bbox.reshape(-1))
    idxs = torch.arange(h * w if n is None else n, dtype=torch.int32,
                        device=device)
    rs, re = segments_in_bbox(idxs, P_pinv, center, bbox, h)
    return P, center, bbox, rs, re


@pytest.mark.parametrize("segments", ["bbox", "shifted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V, D, F", [
    (5, 8, 32), (5, 32, 32), (5, 40, 16), (5, 3, 64), (5, 2, 8), (5, 33, 24),
    (5, 64, 56), (5, 128, 64), (2, 32, 32), (32, 32, 32), (32, 33, 8),
])
def test_plane_sweep_kernel_matches_plain(cuda, dtype, V, D, F, segments):
    """D past one warp's 32 planes, F whose rows take 1 to 16 lanes
    (rounded up to a power of two), 2 and 32 views (the rig's 5 cameras
    repeated). ``shifted`` moves the segments (4, -4, 0) off the bbox, so
    that ~45% of the cells take the both-zero sentinel (0-0.25% in the
    bbox)."""
    P, _, _, rs, re = _rig(cuda)
    P = P[torch.arange(V, device=cuda) % P.shape[0]].contiguous()
    if segments == "shifted":
        shift = torch.tensor([4.0, -4.0, 0.0], device=cuda)
        rs, re = rs + shift, re + shift
    g = torch.Generator(device="cpu").manual_seed(D * F)
    # scaled like the CNN's features: with N(0, 1) values and F=64 the
    # closed-form pair sum subtracts two ~300-sized sums and the
    # summation order alone moves the scores by ~1e-5
    feats = 0.25 * torch.randn((V, H + PAD + 1, W + PAD + 1, F), generator=g)
    feats = feats.to(device=cuda, dtype=dtype)
    ps.plane_sweep_scores.launches = 0
    S, cells = ps.plane_sweep_scores(feats, P, rs, re, PAD, H, W, D,
                                     return_cells=True)
    assert ps.plane_sweep_scores.launches == 1
    S_ref = ps.plane_sweep_scores_reference(feats, P, rs, re, PAD, H, W, D)
    cells_ref = ps.plane_sweep_cells_reference(P, rs, re, PAD, H, W, D)
    torch.cuda.synchronize()
    if segments == "shifted":
        sentinel = float((cells_ref == 0).all(dim=-1).float().mean())
        assert 0.1 < sentinel < 0.9
    assert torch.equal(cells, cells_ref)
    torch.testing.assert_close(S, S_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [65537, 65539])
def test_plane_sweep_kernel_on_a_ragged_batch(cuda, n):
    """n one and three past a multiple of the 4-ray block (a warp a ray)
    at the main path's D=32, F=32 bf16: the last block holds one ray, or
    all but one."""
    shape = (300, 400)
    P, _, _, rs, re = _rig(cuda, shape=shape, n=n)
    g = torch.Generator(device="cpu").manual_seed(11)
    feats = 0.25 * torch.randn((5, 300 + PAD + 1, 400 + PAD + 1, 32),
                               generator=g)
    feats = feats.to(device=cuda, dtype=torch.bfloat16)
    args = (feats, P, rs, re, PAD, 300, 400, 32)
    S, cells = ps.plane_sweep_scores(*args, return_cells=True)
    S_ref = ps.plane_sweep_scores_reference(*args)
    cells_ref = ps.plane_sweep_cells_reference(*args[1:])
    torch.cuda.synchronize()
    assert S.shape == (n, 32)
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


def _bp_inputs(device, grid, M, D=8, seed=0, shape=(H, W), n=None):
    P, center, bbox, rs, re = _rig(device, shape=shape, n=n)
    rng = np.random.RandomState(seed)
    n = rs.shape[0]
    G = int(np.prod(grid))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # the last 100 rays miss the grid: they visit no voxel
    rs, re = rs.clone(), re.clone()
    rs[n - 100:] = bbox[:3] - 10.0
    re[n - 100:] = bbox[:3] - 9.0
    S = torch.softmax(f32(rng.randn(n, D)), dim=-1)
    grid_acc = f32(PRIOR + 2.0 + rng.randn(G))
    msgs = f32(0.5 * rng.randn(n, M))
    return rs, re, S, msgs, grid_acc, center, bbox


@pytest.mark.parametrize("nan_every", [0, 97], ids=["finite", "nan-cells"])
@pytest.mark.parametrize("mode", ["first", "message", "depth"])
@pytest.mark.parametrize("grid, M", [((16, 16, 16), 32), ((32, 24, 16), 64)])
def test_bp_sweep_kernel_matches_plain(cuda, mode, grid, M, nan_every):
    """``nan_every``: every so many grid cells NaN, as the plain version
    (and the JAX package) leaves them where a zero-length segment marches
    two or more cells (its hat score is 0/0). The kernel then has NaN
    messages and grid cells in the same places, and in depth mode takes a
    ray's first cell wherever its posterior has a NaN, as the plain
    version's argmax of an all-NaN row does."""
    rs, re, S, msgs, grid_acc, center, bbox = _bp_inputs(cuda, grid, M)
    if nan_every:
        grid_acc[::nan_every] = float("nan")
    G = int(np.prod(grid))
    gk = torch.full((G,), PRIOR, device=cuda)
    gp = gk.clone()
    args = (rs, re, S, msgs, grid_acc)
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
        assert bool(torch.isnan(mp).any()) == (nan_every > 0
                                               and mode != "first")
        torch.testing.assert_close(mk, mp, rtol=1e-4, atol=1e-5,
                                   equal_nan=True)
        torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-5,
                                   equal_nan=True)


@pytest.mark.parametrize("mode", ["first", "message", "depth"])
@pytest.mark.parametrize("grid, M, shape, n", [
    ((16, 16, 16), 32, (H, W), None), ((32, 24, 16), 64, (H, W), None),
    ((32, 24, 16), 64, (450, 500), 200003),
], ids=["4800-M32", "4800-M64", "200003-M64"])
def test_bp_sweep_kernel_in_place_matches_plain(cuda, mode, grid, M, shape,
                                                n):
    """K2 updating a store in place (messages_in is messages_out), as the
    raynet pass does, against the plain version; 200,003 rays is not a
    multiple of the block. The store starts as random messages in every
    entry: the kernel writes each ray's k < count and leaves the rest, so
    the entries past a ray's count (and the rows of the 100 rays that miss
    the grid) keep their old values exactly."""
    rs, re, S, msgs, grid_acc, center, bbox = _bp_inputs(
        cuda, grid, M, shape=shape, n=n)
    G = int(np.prod(grid))
    gk = torch.zeros(G, device=cuda)
    gp = gk.clone()
    store = msgs.clone()
    tail = (center, bbox, grid, M, PRIOR, mode)
    msg_in = None if mode == "first" else store
    bp.bp_sweep.launches = 0
    mk, ck, dk = bp.bp_sweep(rs, re, S, msg_in, grid_acc, gk, *tail,
                             messages_out=None if mode == "depth" else store)
    assert bp.bp_sweep.launches == 1
    mp, cp, dp = bp.bp_sweep_reference(rs, re, S, msgs, grid_acc, gp, *tail)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp)
    assert int(cp.max()) > 1 and int(cp[-100:].max()) == 0
    if mode == "depth":
        assert torch.equal(store, msgs)
        assert torch.equal(dk > 0, dp > 0)
        agree = ((dk - dp).abs() <= 1e-5 * dp.abs()).float().mean()
        assert float(agree) >= 0.999
        return
    assert mk is store
    visited = torch.arange(M, device=cuda)[None, :] < cp[:, None]
    assert torch.equal(store[~visited], msgs[~visited])
    torch.testing.assert_close(store[visited], mp[visited], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["first", "message", "depth"])
@pytest.mark.parametrize("shape, n", [((H, W), None), ((450, 500), 200003)],
                         ids=["4800", "200003"])
def test_bp_sweep_kernel_stored_sums(cuda, mode, shape, n):
    """K2 with ``ray_sums``: the first sweep writes the counts a launch
    without them computes and the plain float64 totals, with its messages
    unchanged; a message or depth launch that reads them, on the same
    inputs and the same grid_acc, gives the counting launch's messages (in
    place), counts and depths bit for bit, and its grid within the float
    atomics' tolerance. ``sums_read`` counts the launches that read."""
    grid, M = (32, 24, 16), 64
    rs, re, S, msgs, grid_acc, center, bbox = _bp_inputs(
        cuda, grid, M, shape=shape, n=n)
    n, G = rs.shape[0], int(np.prod(grid))
    tail = (center, bbox, grid, M, PRIOR)
    sums = (torch.zeros(n, dtype=torch.int32, device=cuda),
            torch.zeros(n, device=cuda))
    bp.bp_sweep.launches = bp.bp_sweep.sums_read = 0
    m_sums, c_sums, _ = bp.bp_sweep(rs, re, S, None, None,
                                    torch.zeros(G, device=cuda), *tail,
                                    "first", ray_sums=sums)
    assert c_sums is sums[0] and bp.bp_sweep.sums_read == 0
    if mode == "first":
        m0, c0, _ = bp.bp_sweep(rs, re, S, None, None,
                                torch.zeros(G, device=cuda), *tail, "first")
        _, vox, cp, _ = vd.plain_voxel_scores(bbox, rs, re, S, grid, M)
        totals = bp.ray_totals(S, vox, cp, rs, re, bbox, grid)
        torch.cuda.synchronize()
        assert torch.equal(c0, sums[0]) and torch.equal(cp, sums[0])
        assert torch.equal(m0, m_sums)
        torch.testing.assert_close(sums[1], totals, rtol=0, atol=0,
                                   equal_nan=True)
        assert bp.bp_sweep.launches == 2 and bp.bp_sweep.sums_read == 0
        return
    out = []
    for ray_sums in (None, sums):
        store = msgs.clone()
        gk = torch.zeros(G, device=cuda) if mode == "message" else None
        read = bp.bp_sweep.sums_read
        m, c, d = bp.bp_sweep(
            rs, re, S, store, grid_acc, gk, *tail, mode,
            messages_out=store if mode == "message" else None,
            ray_sums=ray_sums)
        assert bp.bp_sweep.sums_read == read + (ray_sums is not None)
        out.append((store, c, d, gk))
    torch.cuda.synchronize()
    (m0, c0, d0, g0), (m1, c1, d1, g1) = out
    assert c1 is sums[0] and torch.equal(c0, c1)
    assert int(c1.max()) > 1 and int(c1[-100:].max()) == 0
    assert torch.equal(m0, m1)
    if mode == "message":
        assert not torch.equal(m1, msgs)
        torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-5)
    else:
        assert torch.equal(m1, msgs) and torch.equal(d0, d1)
        assert float(d1.max()) > 10.0
    assert bp.bp_sweep.launches == 3 and bp.bp_sweep.sums_read == 1


def test_bp_sweep_rejects_bad_ray_sums(cuda):
    rs, re, S, msgs, grid_acc, center, bbox = _bp_inputs(cuda, (16, 16, 16),
                                                         32)
    n = rs.shape[0]
    counts = torch.zeros(n, dtype=torch.int32, device=cuda)
    totals = torch.zeros(n, device=cuda)
    bp.bp_sweep.launches = bp.bp_sweep.sums_read = 0
    for sums, match in (
        ((counts, totals.double()), "totals must be torch.float32"),
        ((counts[:-1], totals), "counts must have shape"),
        ((counts, totals.cpu()), "totals must be on"),
        ((counts,), "pair"),
    ):
        with pytest.raises(ValueError, match=match):
            bp.bp_sweep(rs, re, S, msgs, grid_acc, None, center, bbox,
                        (16, 16, 16), 32, PRIOR, "depth", ray_sums=sums)
    assert bp.bp_sweep.launches == 0 and bp.bp_sweep.sums_read == 0


def test_bp_sweep_kernel_single_voxel_rays(cuda):
    """One-voxel rays: zero messages, nothing scattered, and the depth of
    that voxel's centre in depth mode."""
    grid, M, G = (12, 12, 12), 24, 12 ** 3
    center = torch.tensor([0.0, 0.0, -20.0], device=cuda)
    bbox = torch.tensor([-3.0, -3, -3, 3, 3, 3], device=cuda)
    rs = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.3, 0.4]], device=cuda)
    re = torch.tensor([[0.4, 0.4, 0.4], [0.3, 0.2, 0.1]], device=cuda)
    S = torch.full((2, 8), 1.0 / 8, device=cuda)
    grid_out = torch.zeros(G, device=cuda)
    msgs, counts, _ = bp.bp_sweep(rs, re, S, None, None, grid_out,
                                  center, bbox, grid, M, PRIOR, "first")
    assert counts.tolist() == [1, 1]
    assert not msgs.any() and not grid_out.any()
    _, _, depth = bp.bp_sweep(
        rs, re, S, torch.zeros((2, M), device=cuda),
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
    bp.bp_sweep.launches = bp.bp_sweep.sums_read = 0
    fp = RayNetForwardPass(model, gp, None, scene.image_shape, 700,
                           device=cuda)
    gpu = np.stack(list(fp.forward_pass(scene, (0, 2, 1))))
    # once per image, and once per image and sweep, whatever rays_batch;
    # every sweep after an image's first reads its stored sums
    assert ps.plane_sweep_scores.launches == 2
    assert bp.bp_sweep.launches == 2 * 4
    assert bp.bp_sweep.sums_read == 2 * 3
    # the CPU pass reads the same features (computed on the card)
    fp_cpu = RayNetForwardPass(model, gp, None, scene.image_shape, 700,
                               device="cpu")
    cpu = np.stack(list(fp_cpu.forward_pass(scene, (0, 2, 1))))
    assert np.array_equal(gpu > 0, cpu > 0)
    assert np.mean(np.abs(gpu - cpu) <= 1e-3 * np.abs(cpu)) >= 0.999


def test_feature_pass_launches_no_batch_norm_kernel(cuda):
    """``predict`` of one 1600x1200 view padded by 11 runs its BatchNorm
    folded into the convolutions: no BatchNorm op or kernel in its trace,
    and its features within 1e-4 (relative and absolute) of the CPU's
    unfolded stack on >= 0.999 of the elements."""
    weights = cnn_weights([(32, 3, 1)] * 5, 3, 11, torch.device("cpu"))
    fe = FeatureExtractor("simple_cnn", state_dict=weights, device=cuda)
    image = torch.randint(0, 256, (1222, 1622, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    fe.predict(image.to(cuda))  # cuDNN's plans
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = fe.predict(image.to(cuda))
        torch.cuda.synchronize()
    assert any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())
    names = [e.key for e in prof.key_averages()]
    assert [n for n in names if "bn_fw" in n or "batch_norm" in n] == []
    assert fe.fold_builds == 1 and fe.folded_layers == 2 * 5
    plain = FeatureExtractor("simple_cnn", state_dict=weights, device="cpu")
    x = image.permute(2, 0, 1)[None].to(torch.float32) / 255.0
    with torch.no_grad():
        want = plain.model(x)[0].permute(1, 2, 0)
    close = torch.isclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert close.float().mean().item() >= 0.999


def _tensor_of(array):
    """The tensor a numpy array's memory belongs to."""
    while isinstance(array, np.ndarray):
        array = array.base
    return array


@pytest.mark.parametrize("cls, op", [
    (MultiViewCNNVoxelSpaceForwardPass, "mvcnn_voxel_image_depth"),
    (RayNetForwardPass, "raynet_image_depth"),
], ids=["voxel", "raynet"])
def test_depth_maps_land_pinned_and_a_cached_call_never_syncs(cuda, cls, op,
                                                              monkeypatch):
    """Each map is the numpy scatter of the depths its op returned, bit
    for bit, in page-locked memory; the second call on the object (every
    feature, camera and the bbox cached) makes no synchronising call:
    each view's map arrives by its own event."""
    scene = RingScene(6, 36, 48, 400.0, angle_step=0.05)
    gp = type("GP", (), dict(
        depth_planes=8, neighbors=4, padding=PAD,
        grid_shape=np.array([12, 12, 12], np.int32),
        max_number_of_marched_voxels=24, gamma_mrf=0.05,
    ))()
    model = FeatureExtractor("simple_cnn", seed=0, device=cuda)
    produce = getattr(fused, op)
    depths = []

    def recorded(*args, **kw):
        depth = produce(*args, **kw)
        depths.append(depth.clone())
        return depth

    monkeypatch.setattr(fused, op, recorded)
    views = (0, 3, 1)
    n = len(range(*views))
    fp = cls(model, gp, None, scene.image_shape, 700, device=cuda)
    maps = list(fp.forward_pass(scene, views))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            maps += list(fp.forward_pass(scene, views))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [str(w.message) for w in caught
            if "synchroniz" in str(w.message)] == []
    assert fp.overlapped_views == 2 * (n - 1)
    H, W = scene.image_shape
    assert len(maps) == len(depths) == 2 * n
    for m, d in zip(maps, depths):
        want = np.zeros(H * W, dtype=np.float32)
        want[np.arange(H * W)] = d.cpu().numpy()
        want = want.reshape(W, H).T
        assert m.dtype == want.dtype and m.shape == want.shape
        assert m.strides == want.strides
        assert np.array_equal(np.ascontiguousarray(m).view(np.uint32),
                              np.ascontiguousarray(want).view(np.uint32))
        assert _tensor_of(m).is_pinned()


def _traversal_inputs(device, geometry):
    """(bbox, ray_start, ray_end) of one test geometry, float32 on device."""
    rng = np.random.RandomState(3)
    if geometry == "ring":
        _, _, bbox, rs, re = _rig(device)
        return bbox, rs, re
    bbox = np.array([-2.0, -1.0, 0.5, 2.0, 3.0, 4.5], dtype=np.float32)
    n = 1000  # not a multiple of a block; the last warp holds 8 rays
    lo, hi = bbox[:3], bbox[3:]
    if geometry == "misses":
        rs = np.tile(lo - 10.0, (n, 1))
        re = rs + 1.0
    elif geometry == "zero":
        # zero-length segments on a bbox face: the nudged ends fall in
        # different cells, so the march runs on with 0/0 hat scores; then
        # zero-length segments anywhere, then opposite faces
        rs = rng.uniform(lo, hi, (n, 3))
        rs[:300, 0] = lo[0]
        re = rs.copy()
        re[600:, 2] = lo[2] + hi[2] - rs[600:, 2]
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


# M < 32, M not a multiple of 32, M = 1, a grid whose flat index nears
# 2**31 - 1, rays that miss, and zero-length segments
GEOMETRIES = [
    ("ring", (12, 12, 12), 24), ("ring", (128, 128, 64), 384),
    ("faces", (7, 11, 6), 40), ("faces", (7, 11, 6), 1),
    ("faces", (1024, 1024, 2047), 100), ("misses", (4, 4, 4), 8),
    ("zero", (7, 11, 6), 40),
]


@pytest.mark.parametrize("geometry, grid, M", GEOMETRIES)
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
    if grid[0] == 1024:
        assert int(idx.max()) > 2 ** 30


def _plane_scores(n, D, device, seed=4):
    """Seeded softmax scores, two equal adjacent planes on every third ray
    (a plateau: the voxels between them score the same)."""
    rng = np.random.RandomState(seed)
    S = rng.randn(n, D).astype(np.float32)
    S[::3, 1] = S[::3, 0]
    return torch.softmax(torch.as_tensor(S, device=device), dim=-1)


def _check_voxel_depth(depth, counts, bbox, rs, re, S, center, grid, M):
    """K3's voxel-depth mode against its plain version (see the module
    docstring for the tolerances)."""
    ref_depth, ref_counts = vd.voxel_argmax_depth_reference(
        bbox, rs, re, S, center, grid, M)
    assert torch.equal(counts, ref_counts)
    assert torch.equal(depth > 0, ref_depth > 0)
    close = (depth - ref_depth).abs() <= 1e-3 * ref_depth.abs()
    assert float(close.float().mean()) >= 0.999
    # every other ray at a voxel the plain version scores as tied
    _, vox, _, S_vox = vd.plain_voxel_scores(bbox, rs, re, S, grid, M)
    # the distances as the plain version computes them
    dists = vd.distance_to(rm.voxel_centers(vox, bbox, grid).reshape(-1, 3),
                           center).reshape(vox.shape[:2])
    off = ~close
    best = S_vox[off].max(dim=1, keepdim=True).values
    tied = S_vox[off] >= best - 1e-5 * best.abs()
    hit = (dists[off] - depth[off, None]).abs() <= 1e-6 * dists[off]
    assert bool((tied & hit).any(dim=1).all())
    # zero-length segments that visit voxels: NaN scores, the first voxel
    ray = re - rs
    nan_rays = ((ray * ray).sum(1) == 0) & (ref_counts > 0)
    torch.testing.assert_close(depth[nan_rays], dists[nan_rays, 0],
                               rtol=1e-6, atol=0)
    return int(nan_rays.logical_and(ref_counts > 1).sum())


@pytest.mark.parametrize("D", [2, 8, 32, 128])
@pytest.mark.parametrize("geometry, grid, M", GEOMETRIES)
def test_voxel_depth_kernel_matches_plain(cuda, geometry, grid, M, D):
    bbox, rs, re = _traversal_inputs(cuda, geometry)
    S = _plane_scores(rs.shape[0], D, cuda)
    center = bbox[:3] - torch.tensor([3.0, 4.0, 5.0], device=cuda)
    vd.voxel_argmax_depth.launches = 0
    rm.voxel_traversal_flat.launches = 0
    depth, counts = vd.voxel_argmax_depth(bbox, rs, re, S, center, grid, M)
    assert vd.voxel_argmax_depth.launches == 1
    assert rm.voxel_traversal_flat.launches == 0
    assert depth.dtype == torch.float32 and counts.dtype == torch.int32
    n_nan = _check_voxel_depth(depth, counts, bbox, rs, re, S, center, grid,
                               M)
    if geometry == "zero" and M > 1:
        assert n_nan > 0
    if geometry == "misses":
        assert not counts.any() and not depth.any()


def test_voxel_depth_kernel_on_a_whole_image(cuda):
    """All 200,000 rays of a 400x500 ring view in one launch (a ragged last
    block), at the main path's D=32, M=384 and grid."""
    grid, M = (128, 128, 64), 384
    _, center, bbox, rs, re = _rig(cuda, shape=(400, 500))
    S = _plane_scores(rs.shape[0], 32, cuda)
    depth, counts = vd.voxel_argmax_depth(bbox, rs, re, S, center, grid, M)
    _check_voxel_depth(depth, counts, bbox, rs, re, S, center, grid, M)
    assert int(counts.max()) > 50


def test_voxel_depth_kernel_rejects_what_it_cannot_take(cuda):
    bbox, rs, re = _traversal_inputs(cuda, "faces")
    n = rs.shape[0]
    c = torch.zeros(3, device=cuda)
    S = _plane_scores(n, 8, cuda)
    with pytest.raises(ValueError, match="D <= 128"):
        vd.voxel_argmax_depth(bbox, rs, re, _plane_scores(n, 129, cuda), c,
                              (4, 4, 4), 8)
    with pytest.raises(ValueError, match="2 <= D"):
        vd.voxel_argmax_depth(bbox, rs, re, S[:, :1].contiguous(), c,
                              (4, 4, 4), 8)
    with pytest.raises(ValueError, match="float32"):
        vd.voxel_argmax_depth(bbox, rs, re, S.double(), c, (4, 4, 4), 8)
    with pytest.raises(ValueError, match="contiguous"):
        vd.voxel_argmax_depth(bbox, rs, re, S.t().contiguous().t(), c,
                              (4, 4, 4), 8)
    with pytest.raises(ValueError, match="camera_center"):
        vd.voxel_argmax_depth(bbox, rs, re, S, c.cpu(), (4, 4, 4), 8)
    with pytest.raises(ValueError, match="S_planes"):
        vd.voxel_argmax_depth(bbox, rs, re, S[:-1], c, (4, 4, 4), 8)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        vd.voxel_argmax_depth(bbox, rs, re, S, c, (2048, 1024, 1024), 8)


def test_traversal_kernel_counts_equal_bp_sweep_counts(cuda):
    grid, M = (32, 24, 16), 64
    rs, re, S, _, _, center, bbox = _bp_inputs(cuda, grid, M)
    _, counts, _ = bp.bp_sweep(rs, re, S, None, None,
                               torch.zeros(int(np.prod(grid)), device=cuda),
                               center, bbox, grid, M, PRIOR, "first")
    _, k3_counts = rm.voxel_traversal_flat(bbox, rs, re, grid, M)
    _, depth_counts = vd.voxel_argmax_depth(bbox, rs, re, S, center, grid, M)
    torch.cuda.synchronize()
    assert torch.equal(k3_counts, counts)
    assert torch.equal(depth_counts, counts)


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
    """Whatever rays_batch, K1 once per reference image, and in the
    voxel-space pass K3's voxel-depth mode once per image (no rows
    mode)."""
    scene = RingScene(6, 36, 48, 400.0, angle_step=0.05)
    gp = type("GP", (), dict(
        depth_planes=8, neighbors=4, padding=PAD,
        grid_shape=np.array([12, 12, 12], np.int32),
        max_number_of_marched_voxels=24, gamma_mrf=0.05,
    ))()
    model = FeatureExtractor("simple_cnn", seed=0, device=cuda)
    ps.plane_sweep_scores.launches = 0
    rm.voxel_traversal_flat.launches = 0
    vd.voxel_argmax_depth.launches = 0
    fp = cls(model, gp, None, scene.image_shape, 700, device=cuda)
    gpu = np.stack(list(fp.forward_pass(scene, (0, 2, 1))))
    assert ps.plane_sweep_scores.launches == 2
    assert rm.voxel_traversal_flat.launches == 0
    assert vd.voxel_argmax_depth.launches == (2 if kernels == 2 else 0)
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


def test_tma_box_map_cache_serves_no_stale_map(cuda):
    """The kernel keeps each tensor map by (device, address, WG, HF): two
    calls on one source, a source of another shape, then the first again,
    each give their own rows."""
    a = probes.box_source(cuda, seed=1)
    g = torch.Generator(device="cpu").manual_seed(8)
    b = torch.randn((57, 100, 128), generator=g).to(cuda, torch.bfloat16)
    d2 = probes.case_offsets(*probes.CASES[-1])
    for src, offs in ((a, d2), (a, (3, 5, 2)), (b, (13, 31, 5)), (a, d2),
                      (b, (100 - probes.BH, 57 - probes.BWG, 8))):
        got = probes.tma_box_rows(src, *offs)
        assert torch.equal(got, probes.tma_box_rows_reference(src, *offs))


def test_tma_box_source_reallocated_at_the_same_address(cuda):
    """A source freed and another of the same shape allocated in its
    place (the caching allocator hands the block back) gets the same map,
    which holds only the address and the shape, and its own rows."""
    shape = (probes.WG, probes.HF, probes.WIDTH)
    offs = probes.case_offsets(*probes.CASES[-1])
    first = torch.empty(shape, dtype=torch.bfloat16, device=cuda)
    first.copy_(probes.box_source("cpu", seed=1))
    assert torch.equal(probes.tma_box_rows(first, *offs),
                       probes.tma_box_rows_reference(first, *offs))
    address = first.data_ptr()
    del first
    second = torch.empty(shape, dtype=torch.bfloat16, device=cuda)
    assert second.data_ptr() == address
    second.copy_(probes.box_source("cpu", seed=2))
    got = probes.tma_box_rows(second, *offs)
    assert torch.equal(got, probes.tma_box_rows_reference(second, *offs))
    assert not torch.equal(got, probes.tma_box_rows_reference(
        probes.box_source(cuda, seed=1), *offs))


def _dot_rounding(cuda, mode):
    """The operand rounding that the kernel's diagonal names in ``mode``."""
    vals = torch.as_tensor((1 + np.arange(128) * 2.0 ** -13)
                           .astype(np.float32), device=cuda)
    diag = torch.diagonal(probes.tensor_core_dot(
        torch.diag(vals), torch.eye(128, device=cuda), mode))
    roundings = probes.dot_roundings(diag, vals)
    if mode == "rna":
        assert torch.equal(diag, probes.round_operand(vals, "tf32_rna"))
    assert roundings
    return roundings[0]


def _assert_dot_near_plain(got, x, e, rounding):
    # rounded operands' products are exact in f32, only the sums round
    scale = x.double().abs() @ e.double().abs()
    err = (got.double() - x.double() @ e.double()).abs()
    assert bool((err <= 2.0 ** -9 * scale).all())
    ref = probes.tensor_core_dot_reference(x, e, rounding).double()
    assert bool(((got.double() - ref).abs() <= 2.0 ** -16 * scale).all())


@pytest.mark.parametrize("mode", ["raw", "rna"])
@pytest.mark.parametrize("m, k, n", [(128, 128, 128), (48, 40, 24),
                                     (80, 40, 56), (1024, 1024, 1024)])
def test_tensor_core_dot_kernel_matches_plain(cuda, mode, m, k, n):
    # the diagonal names the operand rounding; the random, non-symmetric
    # product is then held to its plain version and loosely to float64
    rounding = _dot_rounding(cuda, mode)
    rng = np.random.RandomState(m + n)
    x = torch.as_tensor(rng.randn(m, k).astype(np.float32), device=cuda)
    e = torch.as_tensor(rng.randn(k, n).astype(np.float32), device=cuda)
    probes.tensor_core_dot.launches = 0
    got = probes.tensor_core_dot(x, e, mode)
    assert probes.tensor_core_dot.launches == 1
    _assert_dot_near_plain(got, x, e, rounding)


@pytest.mark.parametrize("mode", ["raw", "rna"])
@pytest.mark.parametrize("m, k, n", [(128, 128, 128), (80, 40, 56)])
def test_tensor_core_dot_kernel_takes_operands_off_16_bytes(cuda, mode, m, k,
                                                            n):
    """Contiguous operands that start 4 bytes past a 16-byte boundary take
    the kernel's 4-byte copies: the same product, bit for bit, as the same
    values 16-byte aligned, and within the plain version's tolerances."""
    rounding = _dot_rounding(cuda, mode)
    rng = np.random.RandomState(m + n + 1)

    def off_by_4(rows, cols):
        flat = torch.empty(rows * cols + 1, device=cuda)
        view = flat[1:].view(rows, cols)
        view.copy_(torch.as_tensor(rng.randn(rows, cols).astype(np.float32)))
        return view

    x, e = off_by_4(m, k), off_by_4(k, n)
    x16, e16 = x.clone(), e.clone()
    assert x.data_ptr() % 16 == 4 and e.data_ptr() % 16 == 4
    assert x16.data_ptr() % 16 == 0 and e16.data_ptr() % 16 == 0
    got = probes.tensor_core_dot(x, e, mode)
    assert torch.equal(got, probes.tensor_core_dot(x16, e16, mode))
    _assert_dot_near_plain(got, x, e, rounding)


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


def test_phase_time_from_events_matches_a_synced_wall_time(cuda,
                                                           monkeypatch):
    """A phase around one known kernel (20 float32 products of 4096^2,
    ~50 ms) reads within 5% of the host's wall time around the same work
    synced at both ends, and the phase itself never synchronises."""
    x = torch.randn((4096, 4096), device=cuda)
    y = torch.empty_like(x)
    for _ in range(2):  # cuBLAS's handle and workspace
        torch.matmul(x, x, out=y)
    sync = torch.cuda.synchronize
    sync()
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: synced.append(a))
    timer = profiling.PhaseTimer(device=cuda)
    t0 = time.perf_counter()
    with timer.phase("products"):
        for _ in range(20):
            torch.matmul(x, x, out=y)
    sync()
    wall = time.perf_counter() - t0
    assert synced == []
    assert timer.counts == {"products": 1}
    assert timer.totals["products"] == pytest.approx(wall, rel=0.05)


def _cost_volume_inputs(device, shape=(296, 400), D=64, C=32, seed=5,
                        stride=4):
    """Features of 5 views of a ring rig at 1 / ``stride`` of ``shape`` x
    ``stride`` (the reference first), their plane homographies and D plane
    depths: the geometry of the MVSNet pass (stride 4) or of a CasMVSNet
    stage, with taps off every map's edges."""
    h, w = shape
    scene = RingScene(6, stride * h, stride * w, 2750.0 / 1600 * stride * w,
                      angle_step=0.04, angle_origin=1, bbox_half=6.5)
    P = cv.feature_cameras([scene.get_image(j).camera.P
                            for j in scene.get_view_idxs(1, 4)], 0, 0,
                           stride)
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((5, h, w, C), generator=g).to(device)
    homs = torch.as_tensor(cv.homographies(P), device=device)
    depths = torch.as_tensor(cv.plane_depths(P[0], scene.bbox, D),
                             device=device)
    return feats, homs, depths


@pytest.mark.parametrize("shape, D, C", [((74, 100), 64, 32),
                                         ((37, 50), 16, 16),
                                         ((8, 24), 8, 8),
                                         ((9, 45), 8, 12)])
def test_cost_volume_kernel_matches_plain(cuda, shape, D, C):
    """K4 against its plain version on the card at a mid size (and at
    widths off its 32-pixel blocks and channel counts below 32): the same
    steps in the same order, so within rtol 1e-5, atol 1e-6 (the
    variance's difference of two sums cancels, and the two may round a
    division apart) on >= 0.999 of the values, and one launch counted."""
    feats, homs, depths = _cost_volume_inputs(cuda, shape, D, C)
    before = cv.cost_volume.launches
    got = cv.cost_volume(feats, homs, depths)
    assert cv.cost_volume.launches == before + 1
    want = cv.cost_volume_reference(feats, homs, depths)
    assert got.shape == want.shape == (1, C, D) + tuple(shape)
    close = torch.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert close.float().mean().item() >= 0.999
    assert torch.isfinite(got).all()


def test_cost_volume_kernel_rejects_what_it_cannot_take(cuda):
    feats, homs, depths = _cost_volume_inputs(cuda, (8, 24), 8, 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        cv.cost_volume(feats[..., :6].contiguous(), homs, depths)
    with pytest.raises(ValueError, match="contiguous"):
        cv.cost_volume(feats.transpose(1, 2), homs, depths)
    with pytest.raises(ValueError, match="homographies"):
        cv.cost_volume(feats, homs[:3], depths)
    with pytest.raises(ValueError, match="centre"):
        cv.cost_volume(feats, homs, depths,
                       torch.zeros((8, 23), device=cuda))


def _centre(depths, shape, device):
    """A smooth (H, W) float32 map of centre depths across the planes'
    range."""
    lo, hi = float(depths[0]), float(depths[-1])
    v = torch.arange(shape[0], dtype=torch.float64)[:, None]
    u = torch.arange(shape[1], dtype=torch.float64)
    t = 0.5 + 0.4 * torch.sin(u / 7.0) * torch.cos(v / 5.0)
    return (lo + (hi - lo) * t).to(torch.float32).to(device)


@pytest.mark.parametrize("shape, D, C, stride", [
    # CasMVSNet's three stages at DTU's 1600x1184 crop
    ((296, 400), 48, 32, 4), ((592, 800), 32, 16, 2),
    ((1184, 1600), 8, 8, 1)])
def test_cost_volume_per_pixel_kernel_matches_plain(cuda, shape, D, C,
                                                    stride):
    """K4's per-pixel mode against its plain version on the card at the
    cascade's stage sizes: within rtol 1e-5, atol 1e-6 on >= 0.999 of the
    values, as the plane mode, and one launch counted as per-pixel."""
    feats, homs, depths = _cost_volume_inputs(cuda, shape, D, C,
                                              stride=stride)
    centre = _centre(depths.cpu(), shape, cuda)
    offsets = depths - depths[D // 2]
    before = (cv.cost_volume.launches, cv.cost_volume.per_pixel_launches)
    got = cv.cost_volume(feats, homs, offsets, centre)
    assert (cv.cost_volume.launches, cv.cost_volume.per_pixel_launches) \
        == (before[0] + 1, before[1] + 1)
    want = cv.cost_volume_reference(feats, homs, offsets, centre)
    assert got.shape == want.shape == (1, C, D) + tuple(shape)
    close = torch.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert close.float().mean().item() >= 0.999
    assert torch.isfinite(got).all()


def test_cost_volume_plane_mode_is_the_per_pixel_mode_at_zero(cuda):
    """At MVSNet's size (296x400, D 256, C 32) the plane mode equals the
    per-pixel mode fed a centre of 0 and the planes as offsets, bit for
    bit: one body, one homography expression."""
    feats, homs, depths = _cost_volume_inputs(cuda, (296, 400), 256, 32)
    before = cv.cost_volume.per_pixel_launches
    planes = cv.cost_volume(feats, homs, depths)
    assert cv.cost_volume.per_pixel_launches == before
    zero = torch.zeros((296, 400), dtype=torch.float32, device=cuda)
    assert torch.equal(cv.cost_volume(feats, homs, depths, zero), planes)


def _transposed_conv_inputs(device, cin, cout, shape, seed=3):
    """A K5 layer's input, folded-like weight and bias and skip."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((1, cin) + shape, generator=g))
    w = torch.randn((cin, cout, 3, 3, 3), generator=g) * (2.0 / cin) ** 0.5
    b = torch.randn((cout,), generator=g) * 0.1
    skip = torch.relu(torch.randn((1, cout) + tuple(2 * n for n in shape),
                                  generator=g))
    return [t.to(device) for t in (x, w, b, skip)]


@pytest.mark.parametrize("cin, cout, shape", [
    # the U-Net's c7, c9 and c11 at D 256, 296x400 maps
    (64, 32, (32, 37, 50)), (32, 16, (64, 74, 100)), (16, 8, (128, 148, 200)),
    # odd sizes, columns off the warps' 32 and rows off the threads' 4
    (64, 32, (3, 37, 5)), (32, 16, (5, 3, 33)), (16, 8, (1, 1, 1)),
    (16, 8, (2, 6, 65)),
])
def test_transposed_conv3d_kernel_matches_plain(cuda, cin, cout, shape):
    """K5 against its plain version on the card: within 2**-18 of each
    output's sum of absolute terms (|b| + sum |x| |w| + |skip|; the kernel
    sums by fused multiply-adds, the plain version by a product and an
    add, each a few float32 ulps of it), written over the skip, and one
    launch counted."""
    x, w, b, skip = _transposed_conv_inputs(cuda, cin, cout, shape)
    plain_skip = skip.clone()
    scale = tc.transposed_conv3d_reference(x.abs(), w.abs(), b.abs(),
                                           skip.abs())
    before = tc.transposed_conv3d.launches
    got = tc.transposed_conv3d(x, w, b, skip)
    assert tc.transposed_conv3d.launches == before + 1
    assert got is skip
    want = tc.transposed_conv3d_reference(x, w, b, plain_skip)
    assert got.shape == want.shape == (1, cout) + tuple(2 * n for n in shape)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 2.0 ** -18 * scale).all()


def test_transposed_conv3d_kernel_rejects_what_it_cannot_take(cuda):
    x, w, b, skip = _transposed_conv_inputs(cuda, 16, 8, (2, 4, 6))
    with pytest.raises(ValueError, match="contiguous"):
        tc.transposed_conv3d(x.transpose(3, 4).contiguous().transpose(3, 4),
                             w, b, skip)
    with pytest.raises(ValueError, match="no kernel for 16 -> 16"):
        tc.transposed_conv3d(x, torch.cat([w, w], 1), torch.cat([b, b]),
                             torch.cat([skip, skip], 1))
    with pytest.raises(ValueError, match="float32"):
        tc.transposed_conv3d(x.double(), w, b, skip)


def _entry_conv_inputs(device, cin, shape, seed=5):
    """A K6 layer's input (non-negative, as a variance volume), folded-like
    weight and bias, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed + cin + sum(shape))
    x = torch.relu(torch.randn((1, cin) + shape, generator=g, device=device))
    w = torch.randn((8, cin, 3, 3, 3), generator=g, device=device) \
        * (2.0 / (27 * cin)) ** 0.5
    b = torch.randn((8,), generator=g, device=device) * 0.1
    return x, w, b


def _exact_planes(x, w, b, lo, hi, relu=True):
    """The float64 layer's output planes lo..hi - 1 (the ReLU where
    ``relu``, no bias where ``b`` is None) and the sum of their terms'
    magnitudes: conv3d of the planes lo - 1 .. hi, a zero plane past
    either end of the volume."""
    D = x.shape[2]
    xs = x[:, :, max(lo - 1, 0):min(hi + 1, D)].double()
    xs = torch.nn.functional.pad(
        xs, (0, 0, 0, 0, max(1 - lo, 0), max(hi + 1 - D, 0)))
    w = w.double()
    b = None if b is None else b.double()
    conv = torch.nn.functional.conv3d
    exact = conv(xs, w, b, padding=(0, 1, 1))
    if relu:
        exact = torch.relu(exact)
    scale = conv(xs.abs(), w.abs(), None if b is None else b.abs(),
                 padding=(0, 1, 1))
    return exact, scale


@pytest.mark.parametrize("cin, shape", [
    # c0 of MVSNet and of CasMVSNet's three stages, as the passes run it
    (32, (256, 296, 400)), (32, (48, 296, 400)), (16, (32, 592, 800)),
    (8, (8, 1184, 1600)),
    # off the block's 32 columns and 64 rows, W off a multiple of 4 (the
    # 4-byte copies), D = 1 and 2 (every output reads a zero plane)
    (32, (3, 67, 37)), (16, (1, 5, 9)), (8, (2, 9, 33)), (8, (5, 1, 1)),
    (16, (2, 70, 36)), (8, (3, 130, 100)),
])
def test_entry_conv3d_kernel_matches_float64(cuda, cin, shape):
    """K6 against the float64 conv3d, bias and ReLU: within 2**-18 of each
    output's sum of absolute terms (|b| + sum |x| |w|). The kernel sums at
    most 864 products in float32 by fused multiply-adds, each rounding off
    by at most an ulp (2**-24) of a partial sum no larger than that sum; a
    tap from the wrong input or weight, or a border read as anything but
    0, is off by about the whole of it. Checked at the first two, the
    middle and the last two planes of the published shapes (the float64
    volume of MVSNet's would take 7.8 GB), at every plane of the others;
    one launch counted, and a second run equal bit for bit."""
    x, w, b = _entry_conv_inputs(cuda, cin, shape)
    before = ec.entry_conv3d.launches
    got = ec.entry_conv3d(x, w, b)
    assert ec.entry_conv3d.launches == before + 1
    assert got.shape == (1, 8) + shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    D = shape[0]
    spans = ([(0, 2), (D // 2, D // 2 + 1), (D - 2, D)] if D > 8
             else [(0, D)])
    for lo, hi in spans:
        exact, scale = _exact_planes(x, w, b, lo, hi)
        err = (got[:, :, lo:hi].double() - exact).abs()
        assert (err <= 2.0 ** -18 * scale).all(), (lo, hi)
    assert torch.equal(ec.entry_conv3d(x, w, b), got)


def test_entry_conv3d_kernel_rejects_what_it_cannot_take(cuda):
    x, w, b = _entry_conv_inputs(cuda, 16, (2, 4, 6))
    with pytest.raises(ValueError, match="contiguous"):
        ec.entry_conv3d(x.transpose(3, 4).contiguous().transpose(3, 4), w, b)
    with pytest.raises(ValueError, match="no kernel for 16 -> 16"):
        ec.entry_conv3d(x, torch.cat([w, w]), torch.cat([b, b]))
    with pytest.raises(ValueError, match="float32"):
        ec.entry_conv3d(x.double(), w, b)
    with pytest.raises(ValueError, match="weight is on cpu"):
        ec.entry_conv3d(x, w.cpu(), b)


def _prob_conv_inputs(device, shape, seed=7):
    """A K7 layer's input (non-negative, as the skip sum before it),
    weight and bias, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed + sum(shape))
    x = torch.relu(torch.randn((1, 8) + shape, generator=g, device=device))
    w = torch.randn((1, 8, 3, 3, 3), generator=g, device=device) \
        * (1.0 / 216) ** 0.5
    b = torch.randn((1,), generator=g, device=device)
    return x, w, b


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", [
    # prob of MVSNet and of CasMVSNet's three stages, as the passes run it
    (256, 296, 400), (48, 296, 400), (32, 592, 800), (8, 1184, 1600),
    # runs along D of 3 planes and a last run of 1 (10 planes over 65
    # tiles); off the block's 32 columns and 64 rows, D = 1 and 2 (every
    # output reads a zero plane)
    (10, 296, 400), (3, 67, 36), (1, 5, 8), (2, 9, 36), (5, 1, 4),
    (2, 70, 36), (7, 130, 100),
])
def test_prob_conv3d_kernel_matches_float64(cuda, shape, with_bias):
    """K7 against the float64 conv3d, with MVSNet's bias and without
    (CasMVSNet's): within 2**-18 of each output's sum of absolute terms
    (|b| + sum |x| |w|), as K6. Checked at the first two, the middle three
    and the last two planes of shapes deeper than 8, at every plane of the
    others; at every plane of every shape against the plain version on the
    card, within 2**-18 of the same sum (MVSNet's runs break at planes 64,
    128 and 192, a wrong hand-off between runs or a raced stage shows
    anywhere); one launch counted, and a second run equal bit for bit."""
    x, w, b = _prob_conv_inputs(cuda, shape)
    b = b if with_bias else None
    before = pc.prob_conv3d.launches
    got = pc.prob_conv3d(x, w, b)
    assert pc.prob_conv3d.launches == before + 1
    assert got.shape == (1, 1) + shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    D = shape[0]
    spans = ([(0, 2), (D // 2 - 1, D // 2 + 2), (D - 2, D)] if D > 8
             else [(0, D)])
    for lo, hi in spans:
        exact, scale = _exact_planes(x, w, b, lo, hi, relu=False)
        err = (got[:, :, lo:hi].double() - exact).abs()
        assert (err <= 2.0 ** -18 * scale).all(), (lo, hi)
    del exact, scale, err
    want = pc.prob_conv3d_reference(x, w, b)
    scale = pc.prob_conv3d_reference(x, w.abs(),
                                     None if b is None else b.abs())
    assert ((got - want).abs() <= 2.0 ** -18 * scale).all()
    del want, scale
    assert torch.equal(pc.prob_conv3d(x, w, b), got)


def test_prob_conv3d_kernel_rejects_what_it_cannot_take(cuda):
    x, w, b = _prob_conv_inputs(cuda, (2, 4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        pc.prob_conv3d(x.transpose(3, 4).contiguous().transpose(3, 4), w, b)
    with pytest.raises(ValueError, match="no kernel for 8 -> 2"):
        pc.prob_conv3d(x, torch.cat([w, w]), torch.cat([b, b]))
    with pytest.raises(ValueError, match="no kernel for 16 -> 1"):
        pc.prob_conv3d(torch.cat([x, x], 1), torch.cat([w, w], 1), b)
    with pytest.raises(ValueError, match="float32"):
        pc.prob_conv3d(x.double(), w, b)
    with pytest.raises(ValueError, match="weight is on cpu"):
        pc.prob_conv3d(x, w.cpu(), b)
    with pytest.raises(ValueError, match="bias is on cpu"):
        pc.prob_conv3d(x, w, b.cpu())
    with pytest.raises(ValueError, match="W must be a multiple of 4"):
        pc.prob_conv3d(x[..., :6].contiguous(), w, b)
    with pytest.raises(ValueError, match="start on 16 bytes"):
        pc.prob_conv3d(x.flatten()[1:1 + 8 * 2 * 4 * 4].view(1, 8, 2, 4, 4),
                       w, b)


def test_mvsnet_pass_on_the_card_matches_the_cpu(cuda):
    """The MVSNet pass on a 128x96 ring rig (D = 16): one K4 launch, one
    volume, one K6 launch, three K5 launches and one K7 a view, the folded
    U-Net's
    depths within 1e-3 of a plane interval of the CPU pass's (cuDNN's and
    the CPU's convolutions sum in other orders) on >= 0.999 of the
    pixels."""
    scene = RingScene(4, 96, 128, 220.0, angle_origin=1, bbox_half=6.5)
    gp = type("GP", (), dict(depth_planes=16, neighbors=2))()
    maps, volumes = {}, {}
    before = cv.cost_volume.launches
    before_k5 = tc.transposed_conv3d.launches
    before_k6 = ec.entry_conv3d.launches
    before_k7 = pc.prob_conv3d.launches
    for dev in (cuda, torch.device("cpu")):
        model = MVSNetModel(seed=3, device=dev)
        fp = MVSNetForwardPass(model, gp, None, scene.image_shape,
                               device=dev)
        maps[dev.type] = np.stack(list(fp.forward_pass(scene, (0, 3, 1))))
        volumes[dev.type] = fp.volumes
    assert cv.cost_volume.launches == before + 3
    assert tc.transposed_conv3d.launches == before_k5 + 9
    assert ec.entry_conv3d.launches == before_k6 + 3
    assert pc.prob_conv3d.launches == before_k7 + 3
    assert volumes == {"cuda": 3, "cpu": 3}
    assert maps["cuda"].shape == (3, 24, 32)
    P = cv.feature_cameras([scene.get_image(0).camera.P], 0, 0)
    z = cv.plane_depths(P[0], scene.bbox, 16)
    gap = np.abs(maps["cuda"] - maps["cpu"]) / (z[1] - z[0])
    assert np.mean(gap <= 1e-3) >= 0.999


def test_casmvsnet_pass_on_the_card_matches_the_cpu(cuda):
    """The CasMVSNet pass on a 128x96 ring rig: K4 three times a view, the
    later two in the per-pixel mode, nine K5 launches, three K6 and three
    K7 a view (three U-Nets of three, of one and of one), three volumes a
    view, and the last
    stage's depths within 5e-3 of its interval of the CPU pass's on >=
    0.999 of the pixels."""
    scene = RingScene(4, 96, 128, 220.0, angle_origin=1, bbox_half=6.5)
    gp = type("GP", (), dict(neighbors=2))()
    maps, volumes = {}, {}
    before = (cv.cost_volume.launches, cv.cost_volume.per_pixel_launches,
              tc.transposed_conv3d.launches, ec.entry_conv3d.launches,
              pc.prob_conv3d.launches)
    for dev in (cuda, torch.device("cpu")):
        model = CasMVSNetModel(seed=3, device=dev)
        fp = CasMVSNetForwardPass(model, gp, None, scene.image_shape,
                                  device=dev)
        maps[dev.type] = np.stack(list(fp.forward_pass(scene, (0, 3, 1))))
        volumes[dev.type] = fp.volumes
    assert (cv.cost_volume.launches, cv.cost_volume.per_pixel_launches,
            tc.transposed_conv3d.launches, ec.entry_conv3d.launches,
            pc.prob_conv3d.launches) == (
        before[0] + 9, before[1] + 6, before[2] + 27, before[3] + 9,
        before[4] + 9)
    assert volumes == {"cuda": 9, "cpu": 9}
    assert maps["cuda"].shape == (3, 96, 128)
    P = cv.feature_cameras([scene.get_image(0).camera.P], 0, 0)
    near, far = cv.depth_range(P[0], scene.bbox)
    interval = (far - near) / casmvsnet.NUM_DEPTH
    gap = np.abs(maps["cuda"] - maps["cpu"]) / interval
    assert np.mean(gap <= 5e-3) >= 0.999


class _VolumeTimers:
    """Stands in for a pass's ``PhaseTimer``: each "Cost regularization"
    phase, with the phases and layer timers inside it, goes to a
    ``PhaseTimer`` of its own, one a volume (``volumes``); every other
    phase to ``rest``."""

    def __init__(self, device):
        self.rest = profiling.PhaseTimer(device)
        self.volumes = []
        self._inside = None

    @contextlib.contextmanager
    def phase(self, label):
        if label == "Cost regularization":
            self._inside = profiling.PhaseTimer(self.rest.device)
            self.volumes.append(self._inside)
            with self._inside.phase(label):
                yield
            self._inside = None
        else:
            with (self._inside or self.rest).phase(label):
                yield

    def layer(self, label):
        return self._inside.layer(label)


@pytest.mark.parametrize("cls, model_cls, volumes", [
    (MVSNetForwardPass, MVSNetModel, 1),
    (CasMVSNetForwardPass, CasMVSNetModel, 3)], ids=["mvsnet", "casmvsnet"])
def test_unet_layer_timers_sum_to_their_phase(cuda, cls, model_cls, volumes,
                                              tmp_path):
    """A traced pass of one reference view at the cells' widths (1600x1200,
    4 neighbours, D 256 in MVSNet): each volume's 11 layer timers, once
    each, sum to within 3% of its "Cost regularization" phase, and the
    entry conv's and the prob conv's timers to within 10% of K6's and
    K7's device time in the trace."""
    scene = RingScene(5, 1200, 1600, 2750.0, angle_origin=2, bbox_half=6.5)
    gp = type("GP", (), dict(depth_planes=256, neighbors=4))()
    model = model_cls(seed=3, device=cuda)
    for traced in (False, True):  # the first pass builds and warms up
        fp = cls(model, gp, None, scene.image_shape, device=cuda)
        fp.timer = _VolumeTimers(cuda)
        trace = profiling.trace(str(tmp_path)) if traced \
            else contextlib.nullcontext()
        with trace:
            maps = list(fp.forward_pass(scene, (2, 3, 1)))
            torch.cuda.synchronize()
    assert len(maps) == 1 and len(fp.timer.volumes) == volumes
    conv0 = prob = 0.0
    for timer in fp.timer.volumes:
        assert all(timer.counts[label] == 1 for label in UNET_LABELS)
        totals = timer.totals
        layers = sum(totals[label] for label in UNET_LABELS)
        assert layers == pytest.approx(totals["Cost regularization"],
                                       rel=0.03)
        conv0 += totals["unet.conv0"]
        prob += totals["unet.prob"]
    events = profiling.read_trace(str(tmp_path / profiling.TRACE_NAME))
    intervals = profiling.device_intervals(events)
    k6 = sum(e - s for name, s, e in intervals
             if "entry_conv3d_kernel" in name) * 1e-6
    k7 = sum(e - s for name, s, e in intervals
             if "prob_conv3d_kernel" in name) * 1e-6
    assert conv0 == pytest.approx(k6, rel=0.10)
    assert prob == pytest.approx(k7, rel=0.10)
