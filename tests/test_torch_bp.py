"""K2's plain version (``bp_sweep_reference``), reached through the raynet
pass's per-image sweeps (``fused.raynet_image_update``, which updates an
in-place message store, and ``fused.raynet_image_depth``; on the CPU they
run in ``rays_batch`` spans, here 700 rays: odd chunks of the 1,728), against
the JAX package's XLA path (``fused.raynet_message_step`` with
``first_iteration`` True/False and ``fused.raynet_depth_step``) on the same
segments, scores, messages and grid. The messages past each ray's count are
zero, as in the pass's store.

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


def _segments(rig, n=H * W):
    """The port's bbox segments of the first ``n`` mock rays."""
    return tsamp.segments_in_bbox(
        _t(rig["idxs"][:n]), _t(rig["P_pinv"]), _t(rig["center"]), _t(BBOX),
        H,
    )


def _port_msg(rig, msgs, grid_acc, grid, M, first, n=H * W,
              dtype=torch.float32):
    """One sweep of the port over the first ``n`` rays, in 700-ray spans,
    updating a copy of ``msgs`` in place (a zero store in the first
    iteration). Returns (messages, scatter)."""
    store = (torch.zeros((n, M), dtype=dtype) if first
             else _t(msgs[:n]).to(dtype))
    scatter = torch.zeros(int(np.prod(grid)), dtype=dtype)
    tfused.raynet_image_update(
        store, _t(rig["S"][:n]).to(dtype), scatter, _t(grid_acc).to(dtype),
        *_segments(rig, n), _t(rig["center"]), _t(BBOX), grid_shape=grid,
        max_voxels=M, first_iteration=first, prior=PRIOR, rays_batch=700,
    )
    return store.numpy(), scatter.numpy()


def _first_sweep(rig, grid, M):
    G = int(np.prod(grid))
    m, s = _jax_msg(rig, np.zeros((H * W, M), np.float32),
                    np.full(G, PRIOR, np.float32), grid, M, True)
    return m, (s + PRIOR).astype(np.float32)


def _moderate_inputs(rig, grid, M, seed):
    """A grid and messages that keep mu = sigmoid(grid - msg) moderate;
    the messages are zero past each ray's count, as in the pass's store."""
    rng = np.random.RandomState(seed)
    G = int(np.prod(grid))
    grid_acc = (PRIOR + 2.0 + rng.randn(G)).astype(np.float32)
    msgs = (0.5 * rng.randn(H * W, M)).astype(np.float32)
    rs, re = _segments(rig)
    _, counts = jrm.voxel_traversal_flat(
        jnp.asarray(BBOX), jnp.asarray(rs.numpy()), jnp.asarray(re.numpy()),
        grid, M,
    )
    msgs[np.arange(M)[None, :] >= np.asarray(counts)[:, None]] = 0.0
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
    msgs, grid_acc = _moderate_inputs(rig, grid, M, seed=M)
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
        msgs, grid_acc = _moderate_inputs(rig, grid, M, seed=M + 1)
    else:
        msgs, grid_acc = _first_sweep(rig, grid, M)
    _, jd = jfused.raynet_depth_step(
        jnp.asarray(rig["idxs"]), jnp.asarray(rig["feats"]),
        jnp.asarray(rig["P"]), jnp.asarray(rig["P_pinv"]),
        jnp.asarray(rig["center"]), jnp.asarray(BBOX), jnp.asarray(msgs),
        jnp.asarray(grid_acc), H, W, PAD, D, grid, M,
        S_planes=jnp.asarray(rig["S"]),
    )
    td = tfused.raynet_image_depth(
        _t(msgs), _t(rig["S"]), _t(grid_acc), *_segments(rig),
        _t(rig["center"]), _t(BBOX), grid_shape=grid, max_voxels=M,
        rays_batch=700,
    ).numpy()
    jd = np.asarray(jd)
    assert td.shape == (H * W,) and np.isfinite(td).all()
    assert np.array_equal(td > 0, jd > 0)
    assert np.mean(np.abs(td - jd) <= 1e-5 * np.abs(jd)) >= 0.999
    assert 10.0 <= td[td > 0].min() and td.max() <= 30.0


@pytest.mark.parametrize("grid, M", CASES)
def test_counts_match_jax_traversal(rig, grid, M):
    rs, re = _segments(rig)
    _, counts, _ = tbp.bp_sweep(
        rs, re, _t(rig["S"]), None, None,
        torch.zeros(int(np.prod(grid))), _t(rig["center"]), _t(BBOX), grid,
        M, PRIOR, "first",
    )
    _, jc = jrm.voxel_traversal_flat(
        jnp.asarray(BBOX), jnp.asarray(rs.numpy()), jnp.asarray(re.numpy()),
        grid, M,
    )
    assert int(counts.max()) > 1
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))


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
    G = int(np.prod(grid))
    grid_out = torch.zeros(G)
    msgs, counts, _ = tbp.bp_sweep(
        rs, re, S, None, None, grid_out, center, _t(BBOX), grid, M,
        PRIOR, "first",
    )
    assert counts.tolist() == [1, 1]
    assert not msgs.any() and not grid_out.any()
    _, _, depth = tbp.bp_sweep(
        rs, re, S, torch.zeros(2, M), torch.full((G,), PRIOR), None,
        center, _t(BBOX), grid, M, PRIOR, "depth",
    )
    expect = torch.linalg.norm(torch.full((3,), 0.25) - center)
    torch.testing.assert_close(depth, expect.expand(2), rtol=1e-6, atol=0)


def test_padded_rows_scatter_nothing(rig):
    """The JAX step's padded batch (rows >= n_valid visit no voxel: zero
    messages, nothing scattered) equals the port's sweep over the valid rows
    alone, which is how the port's per-image sweeps take a ragged image."""
    grid, M = CASES[0]
    G = int(np.prod(grid))
    msgs, grid_acc = _moderate_inputs(rig, grid, M, seed=3)
    n_valid = 700
    for first in (True, False):
        # the first sweep's grid holds the prior
        g = np.full(G, PRIOR, np.float32) if first else grid_acc
        tm, ts = _port_msg(rig, msgs, g, grid, M, first, n_valid)
        jm, js = _jax_msg(rig, msgs, g, grid, M, first, n_valid)
        assert tm.shape == (n_valid, M) and not jm[n_valid:].any()
        np.testing.assert_allclose(tm, jm[:n_valid], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-5)
        assert ts.shape == (G,)


def _chain_inputs(rig, n):
    """Segments and scores of the first ``n`` mock rays (1727: not a
    multiple of 32 or 128)."""
    return (*_segments(rig, n), _t(rig["S"][:n]))


def _sweep(rs, re, S, center, grid, M, mode, msgs, grid_acc, spans,
           in_place):
    """One sweep over ``spans`` of the rays: the in-place store ``msgs``
    updated row range by row range as the raynet pass does, or new
    messages out of place. Returns (messages, counts, scatter)."""
    scatter = torch.zeros(int(np.prod(grid)))
    out = msgs if in_place else torch.zeros_like(msgs)
    counts = torch.zeros(rs.shape[0], dtype=torch.int32)
    for lo, hi in spans:
        m, c, _ = tbp.bp_sweep(
            rs[lo:hi], re[lo:hi], S[lo:hi],
            None if mode == "first" else msgs[lo:hi],
            None if mode == "first" else grid_acc, scatter, center,
            _t(BBOX), grid, M, PRIOR, mode,
            messages_out=msgs[lo:hi] if in_place else None,
        )
        if not in_place:
            out[lo:hi] = m
        counts[lo:hi] = c
    return out, counts, scatter


@pytest.mark.parametrize("check", [
    "in_place_equals_out_of_place", "tails_stay_zero",
    "odd_chunks_equal_one_call",
])
@pytest.mark.parametrize("grid, M", CASES)
def test_in_place_store_over_first_message_message(rig, grid, M, check):
    """The raynet pass's store, swept first -> message -> message in place:
    equal to the out-of-place sweeps; zero past each ray's count after
    every sweep; and one call over all N rays equal to the same rays in odd
    chunks (per-ray results exact, the scatter within rtol 1e-4, atol
    1e-5: index_add_ sums the chunks in another order)."""
    n = H * W - 1
    rs, re, S = _chain_inputs(rig, n)
    center = _t(rig["center"])
    whole = [(0, n)]
    odd = [(0, 700), (700, 1033), (1033, n)]
    store = torch.zeros(n, M)
    grid_acc = None
    for mode in ("first", "message", "message"):
        before = store.clone()
        m, counts, scatter = _sweep(rs, re, S, center, grid, M, mode, store,
                                    grid_acc, whole, in_place=True)
        assert m is store
        if check == "in_place_equals_out_of_place":
            m2, c2, s2 = _sweep(rs, re, S, center, grid, M, mode, before,
                                grid_acc, whole, in_place=False)
            assert torch.equal(m2, store) and torch.equal(c2, counts)
            assert torch.equal(s2, scatter)
        elif check == "tails_stay_zero":
            tail = torch.arange(M)[None, :] >= counts[:, None]
            assert int(counts.max()) > 1 and not store[tail].any()
            assert store[~tail].abs().max() > 1.0
        else:
            m2, c2, s2 = _sweep(rs, re, S, center, grid, M, mode,
                                before.clone(), grid_acc, odd, in_place=True)
            assert torch.equal(c2, counts)
            np.testing.assert_allclose(m2.numpy(), store.numpy(), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(s2.numpy(), scatter.numpy(),
                                       rtol=1e-4, atol=1e-5)
        grid_acc = scatter + PRIOR


def test_wrapper_takes_plain_path_on_cpu(rig):
    grid, M = CASES[0]
    rs, re = _segments(rig)
    args = (rs, re, _t(rig["S"]), None, None)
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
