"""K2's plain version (``bp_sweep_reference``, reached through the port's
``fused`` steps) against the JAX package's XLA path
(``fused.raynet_message_step`` with ``first_iteration`` True/False and
``fused.raynet_depth_step``) on the same segments, scores, messages and
grid.

Tolerances:
- counts exact;
- messages and scatter rtol=1e-4, atol=1e-5 where the recurrence is
  well-conditioned: the first iteration (mu = gamma), and later iterations
  on a grid and messages that keep mu inside (0.005, 0.7);
- on the grid a real first sweep leaves, mu sits at its clip 1 - 1e-4 on
  occupied voxels and ``(total - cumsum) / (1 - mu)`` turns float32
  rounding into pon errors of ~1e-2 in ANY float32 evaluation. There the
  port must be no less accurate than the JAX package: against a float64
  evaluation of the same formulas, its max and mean errors are at most
  twice JAX's (plus 1e-5 and 1e-6);
- depth within 1e-5 relative on >= 0.999 of the rays (an argmax near-tie
  may flip).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raynet_tpu.common.scene import RestrepoScene
from raynet_tpu.ops import fused as jfused
from raynet_tpu.ops import ray_marching as jrm
from raynet_tpu.ops import sampling as jsamp
from raynet_tpu.ops import similarities as jsim
from raynet_tpu_torch.ops import bp_sweep as tbp
from raynet_tpu_torch.ops import fused as tfused
from raynet_tpu_torch.ops import sampling as tsamp
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)

BBOX = np.array([-3, -3, -3, 3, 3, 3], np.float32)
PAD = 11
D = 8
PRIOR = float(np.log(np.float32(0.05)) - np.log(np.float32(0.95)))
CASES = [((12, 12, 12), 24), ((16, 16, 16), 32)]


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def rig(mock_scene_dir):
    scene = RestrepoScene(str(mock_scene_dir))
    cams = [scene.get_image(j).camera for j in scene.get_view_idxs(1, 4)]
    P = np.stack([c.P for c in cams]).astype(np.float32)
    P_pinv = np.asarray(cams[0].P_pinv, np.float32)
    center = np.asarray(cams[0].center[:3, 0], np.float32)
    idxs = np.arange(H * W, dtype=np.int32)
    rng = np.random.RandomState(0)
    feats = rng.randn(5, H + PAD + 1, W + PAD + 1, 32).astype(np.float32)
    rs, re = jsamp.segments_in_bbox(
        jnp.asarray(idxs), jnp.asarray(P_pinv), jnp.asarray(center),
        jnp.asarray(BBOX), H,
    )
    pts = jsamp.sample_points_along_segments(rs, re, D)
    S = np.asarray(jsim.compute_similarities(
        jnp.asarray(feats), jnp.asarray(P), pts, PAD, H, W
    ))
    return dict(P=P, P_pinv=P_pinv, center=center, idxs=idxs, feats=feats,
                S=S)


def _jax_msg(rig, msgs, grid_acc, grid, M, first, n_valid=H * W):
    m, scatter, _ = jfused.raynet_message_step(
        jnp.asarray(rig["idxs"]), jnp.asarray(rig["feats"]),
        jnp.asarray(rig["P"]), jnp.asarray(rig["P_pinv"]),
        jnp.asarray(rig["center"]), jnp.asarray(BBOX), jnp.asarray(msgs),
        jnp.asarray(grid_acc), n_valid, H, W, PAD, D, grid, M,
        first_iteration=first, S_planes=jnp.asarray(rig["S"]),
    )
    return np.asarray(m), np.asarray(scatter)


def _port_msg(rig, msgs, grid_acc, grid, M, first, n_valid=H * W,
              dtype=torch.float32):
    m, scatter, _ = tfused.raynet_message_step(
        _t(rig["idxs"]), _t(rig["feats"]), _t(rig["P"]), _t(rig["P_pinv"]),
        _t(rig["center"]), _t(BBOX),
        None if first else _t(msgs).to(dtype), _t(grid_acc).to(dtype),
        n_valid, H, W, PAD, D, grid, M, first_iteration=first,
        S_planes=_t(rig["S"]).to(dtype), prior=PRIOR,
    )
    return m.numpy(), scatter.numpy()


def _first_sweep(rig, grid, M):
    G = int(np.prod(grid))
    m, s = _jax_msg(rig, np.zeros((H * W, M), np.float32),
                    np.full(G, PRIOR, np.float32), grid, M, True)
    return m, (s + PRIOR).astype(np.float32)


def _moderate_inputs(grid, M, seed):
    """A grid and messages that keep mu = sigmoid(grid - msg) moderate."""
    rng = np.random.RandomState(seed)
    G = int(np.prod(grid))
    grid_acc = (PRIOR + 2.0 + rng.randn(G)).astype(np.float32)
    msgs = (0.5 * rng.randn(H * W, M)).astype(np.float32)
    return msgs, grid_acc


@pytest.mark.parametrize("grid, M", CASES)
def test_first_iteration_matches_jax(rig, grid, M):
    G = int(np.prod(grid))
    zeros = np.zeros((H * W, M), np.float32)
    prior_grid = np.full(G, PRIOR, np.float32)
    jm, js = _jax_msg(rig, zeros, prior_grid, grid, M, True)
    tm, ts = _port_msg(rig, zeros, prior_grid, grid, M, True)
    np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-5)
    assert np.abs(tm).max() > 1.0


@pytest.mark.parametrize("grid, M", CASES)
def test_message_mode_matches_jax(rig, grid, M):
    msgs, grid_acc = _moderate_inputs(grid, M, seed=M)
    jm, js = _jax_msg(rig, msgs, grid_acc, grid, M, False)
    tm, ts = _port_msg(rig, msgs, grid_acc, grid, M, False)
    np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("grid, M", CASES)
def test_message_mode_on_a_real_grid_is_as_accurate_as_jax(rig, grid, M):
    msgs, grid_acc = _first_sweep(rig, grid, M)
    jm, js = _jax_msg(rig, msgs, grid_acc, grid, M, False)
    tm, ts = _port_msg(rig, msgs, grid_acc, grid, M, False)
    m64, s64 = _port_msg(rig, msgs, grid_acc, grid, M, False,
                         dtype=torch.float64)
    for port, jax_, exact in ((tm, jm, m64), (ts, js, s64)):
        port_err = np.abs(port - exact)
        jax_err = np.abs(jax_ - exact)
        assert port_err.max() <= 2 * jax_err.max() + 1e-5
        assert port_err.mean() <= 2 * jax_err.mean() + 1e-6


@pytest.mark.parametrize("moderate", [False, True])
@pytest.mark.parametrize("grid, M", CASES)
def test_depth_matches_jax(rig, grid, M, moderate):
    if moderate:
        msgs, grid_acc = _moderate_inputs(grid, M, seed=M + 1)
    else:
        msgs, grid_acc = _first_sweep(rig, grid, M)
    _, jd = jfused.raynet_depth_step(
        jnp.asarray(rig["idxs"]), jnp.asarray(rig["feats"]),
        jnp.asarray(rig["P"]), jnp.asarray(rig["P_pinv"]),
        jnp.asarray(rig["center"]), jnp.asarray(BBOX), jnp.asarray(msgs),
        jnp.asarray(grid_acc), H, W, PAD, D, grid, M,
        S_planes=jnp.asarray(rig["S"]),
    )
    td = tfused.raynet_depth_step(
        _t(rig["idxs"]), _t(rig["feats"]), _t(rig["P"]), _t(rig["P_pinv"]),
        _t(rig["center"]), _t(BBOX), _t(msgs), _t(grid_acc), H, W, PAD, D,
        grid, M, S_planes=_t(rig["S"]),
    ).numpy()
    jd = np.asarray(jd)
    assert td.shape == (H * W,) and np.isfinite(td).all()
    assert np.array_equal(td > 0, jd > 0)
    assert np.mean(np.abs(td - jd) <= 1e-5 * np.abs(jd)) >= 0.999
    assert 10.0 <= td[td > 0].min() and td.max() <= 30.0


@pytest.mark.parametrize("grid, M", CASES)
def test_counts_match_jax_traversal(rig, grid, M):
    rs, re = tsamp.segments_in_bbox(
        _t(rig["idxs"]), _t(rig["P_pinv"]), _t(rig["center"]), _t(BBOX), H
    )
    valid = torch.ones(H * W, dtype=torch.int32)
    valid[::7] = 0
    _, counts, _ = tbp.bp_sweep(
        rs, re, valid, _t(rig["S"]), None, None,
        torch.zeros(int(np.prod(grid))), _t(rig["center"]), _t(BBOX), grid,
        M, PRIOR, "first",
    )
    _, jc = jrm.voxel_traversal_flat(
        jnp.asarray(BBOX), jnp.asarray(rs.numpy()), jnp.asarray(re.numpy()),
        grid, M,
    )
    expect = np.where(valid.numpy() != 0, np.asarray(jc), 0)
    np.testing.assert_array_equal(counts.numpy(), expect)


def test_single_voxel_rays(rig):
    """A ray that visits one voxel gets zero messages and scatters nothing,
    but its depth is that voxel's centre (depth_estimate is all zeros, so
    argmax picks index 0, and counts > 0)."""
    grid, M = (12, 12, 12), 24
    center = _t(rig["center"])
    # segments inside voxel (6, 6, 6), whose centre is (0.25, 0.25, 0.25)
    rs = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.3, 0.4]])
    re = torch.tensor([[0.4, 0.4, 0.4], [0.3, 0.2, 0.1]])
    S = torch.softmax(torch.randn(2, D, generator=torch.Generator().manual_seed(0)), -1)
    valid = torch.ones(2, dtype=torch.int32)
    G = int(np.prod(grid))
    grid_out = torch.zeros(G)
    msgs, counts, _ = tbp.bp_sweep(
        rs, re, valid, S, None, None, grid_out, center, _t(BBOX), grid, M,
        PRIOR, "first",
    )
    assert counts.tolist() == [1, 1]
    assert not msgs.any() and not grid_out.any()
    _, _, depth = tbp.bp_sweep(
        rs, re, valid, S, torch.zeros(2, M), torch.full((G,), PRIOR), None,
        center, _t(BBOX), grid, M, PRIOR, "depth",
    )
    expect = torch.linalg.norm(torch.full((3,), 0.25) - center)
    torch.testing.assert_close(depth, expect.expand(2), rtol=1e-6, atol=0)


def test_padded_rows_scatter_nothing(rig):
    """Rows >= n_valid (the padded tail of a batch) get zero messages and
    leave the grid as the valid rows alone would."""
    grid, M = CASES[0]
    G = int(np.prod(grid))
    msgs, grid_acc = _moderate_inputs(grid, M, seed=3)
    n_valid = 700
    for first in (True, False):
        # the first sweep's grid holds the prior
        g = np.full(G, PRIOR, np.float32) if first else grid_acc
        tm, ts = _port_msg(rig, msgs, g, grid, M, first, n_valid)
        assert not tm[n_valid:].any()
        jm, js = _jax_msg(rig, msgs, g, grid, M, first, n_valid)
        np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-5)
        assert ts.shape == (G,)


def test_wrapper_takes_plain_path_on_cpu(rig):
    grid, M = CASES[0]
    rs, re = tsamp.segments_in_bbox(
        _t(rig["idxs"]), _t(rig["P_pinv"]), _t(rig["center"]), _t(BBOX), H
    )
    valid = torch.ones(H * W, dtype=torch.int32)
    args = (rs, re, valid, _t(rig["S"]), None, None)
    tail = (_t(rig["center"]), _t(BBOX), grid, M, PRIOR, "first")
    tbp.bp_sweep.launches = 0
    g1 = torch.zeros(int(np.prod(grid)))
    g2 = torch.zeros(int(np.prod(grid)))
    m1, c1, d1 = tbp.bp_sweep(*args, g1, *tail)
    m2, c2, d2 = tbp.bp_sweep_reference(*args, g2, *tail)
    assert tbp.bp_sweep.launches == 0
    assert torch.equal(m1, m2) and torch.equal(c1, c2) and torch.equal(g1, g2)
    assert d1 is None and d2 is None
    with pytest.raises(ValueError, match="mode"):
        tbp.bp_sweep(*args, g1, *tail[:-1], "posterior")
