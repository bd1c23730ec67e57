"""K1's plain version against the JAX package's plane sweep
(``ops/similarities.compute_similarities``, the XLA path the JAX package
runs on the CPU), on projections from the mock rig and seeded features.

Tolerances: scores rtol=1e-5, atol=1e-6; feature cells equal except a
counted fraction <= 1e-4 (a projection within an f32 rounding of a .5 tie
may round the other way when XLA fuses the multiply-add chain differently).
The CUDA kernel against this plain version is in test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raynet_tpu.common.scene import RestrepoScene
from raynet_tpu.ops import sampling as jsamp
from raynet_tpu.ops import similarities as jsim
from raynet_tpu_torch.ops import planesweep, sampling as tsamp
from raynet_tpu_torch.ops import similarities as tsim
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)

BBOX = np.array([-3, -3, -3, 3, 3, 3], np.float32)
PAD = 11


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def rig(mock_scene_dir):
    scene = RestrepoScene(str(mock_scene_dir))
    cams = [scene.get_image(j).camera for j in scene.get_view_idxs(2, 4)]
    P = np.stack([c.P for c in cams]).astype(np.float32)
    P_pinv = np.asarray(cams[0].P_pinv, np.float32)
    center = np.asarray(cams[0].center[:3, 0], np.float32)
    idxs = np.arange(H * W, dtype=np.int32)
    rs, re = jsamp.segments_in_bbox(
        jnp.asarray(idxs), jnp.asarray(P_pinv), jnp.asarray(center),
        jnp.asarray(BBOX), H,
    )
    return P, np.asarray(rs), np.asarray(re)


def _features(dtype, seed=0, F=32):
    rng = np.random.RandomState(seed)
    f = rng.randn(5, H + PAD + 1, W + PAD + 1, F).astype(np.float32)
    if dtype == "bf16":
        # values exactly representable in bf16 on both sides
        f = np.asarray(jnp.asarray(f).astype(jnp.bfloat16).astype(jnp.float32))
    return f


def _jax_scores(f, P, rs, re, D, dtype):
    pts = jsamp.sample_points_along_segments(
        jnp.asarray(rs), jnp.asarray(re), D
    )
    jf = jnp.asarray(f)
    if dtype == "bf16":
        jf = jf.astype(jnp.bfloat16)
    S = jsim.compute_similarities(jf, jnp.asarray(P), pts, PAD, H, W)
    cells = jsim.project_to_feature_idx(jf, jnp.asarray(P), pts, PAD, H, W)
    return np.asarray(S), np.asarray(cells)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 32])
def test_plain_scores_match_jax(rig, dtype, D):
    P, rs, re = rig
    f = _features(dtype, seed=D)
    jS, jcells = _jax_scores(f, P, rs, re, D, dtype)
    tf = _t(f).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    tS = planesweep.plane_sweep_scores_reference(
        tf, _t(P), _t(rs), _t(re), PAD, H, W, D
    )
    tcells = planesweep.plane_sweep_cells_reference(
        _t(P), _t(rs), _t(re), PAD, H, W, D
    )
    assert tS.shape == (H * W, D) and tS.dtype == torch.float32
    assert tcells.shape == jcells.shape and tcells.dtype == torch.int32
    differ = (tcells.numpy() != jcells).any(-1)
    assert differ.mean() <= 1e-4, differ.sum()
    rows = ~differ.any(axis=(1, 2))  # rays whose cells all agree
    np.testing.assert_allclose(tS.numpy()[rows], jS[rows], rtol=1e-5, atol=1e-6)
    # the sentinel cell (0, 0) is reached: rays leave some views' images
    assert (tcells.numpy() == 0).all(-1).any()


def test_pixel_to_feature_idx_matches_jax():
    """Half-to-even rounding, the clamp to [0, W] x [0, H] and the
    both-zero sentinel, on hand-picked pixels."""
    px = np.array(
        [[0.5, 3.0], [1.5, 3.0], [2.5, 7.5], [-0.5, 4.0], [-7.0, 2.0],
         [3.0, -7.0], [1000.0, 5.0], [5.0, 1000.0], [47.5, 35.5],
         [-4.5, -4.5], [-4.49, 6.0], [58.6, 47.4]],
        np.float32,
    )
    for pad in (11, 1, 24):
        t = tsim.pixel_to_feature_idx(_t(px), pad, H, W)
        j = jsim.pixel_to_feature_idx(jnp.asarray(px), pad, H, W)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_compute_similarities_matches_pairwise_loop(rig):
    """The closed-form pair sum equals the explicit loop over view pairs."""
    P, rs, re = rig
    f = _features("f32", seed=5)
    pts = tsamp.sample_points_along_segments(_t(rs), _t(re), 8)
    S = tsim.compute_similarities(_t(f), _t(P), pts, PAD, H, W)
    Sj = jsim.compute_similarities_pairwise(
        jnp.asarray(f), jnp.asarray(P), jnp.asarray(pts.numpy()), PAD, H, W
    )
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-5, atol=1e-6)


def test_wrapper_takes_plain_path_on_cpu(rig):
    P, rs, re = rig
    f = _t(_features("f32", seed=6))
    planesweep.plane_sweep_scores.launches = 0
    S = planesweep.plane_sweep_scores(f, _t(P), _t(rs), _t(re), PAD, H, W, 8)
    S2, cells = planesweep.plane_sweep_scores(
        f, _t(P), _t(rs), _t(re), PAD, H, W, 8, return_cells=True
    )
    ref = planesweep.plane_sweep_scores_reference(
        f, _t(P), _t(rs), _t(re), PAD, H, W, 8
    )
    assert planesweep.plane_sweep_scores.launches == 0
    assert torch.equal(S, ref) and torch.equal(S2, ref)
    assert cells.shape == (H * W, 8, 5, 2)
    np.testing.assert_allclose(S.sum(-1).numpy(), 1.0, rtol=1e-5)
