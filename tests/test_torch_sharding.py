"""The port's ray sharding (``raynet_tpu_torch/parallel/sharding.py``) on the
CPU: 2 and 3 ranks over gloo, each a spawned process, held to the JAX
package on one device, as ``tests/test_sharding.py`` holds the JAX package's
sharded pieces to its own single device.

- the sharded BP update and message / depth steps on the rig of
  ``tests/test_sharding.py:57-121`` (64 rays: not a multiple of 3; here
  through the middle of the image, where they cross the bbox), the
  first iteration and a later one, against ``raynet_tpu``'s ``mrf.bp_update``
  and ``fused.raynet_{message,depth}_step``. Bars: messages rtol 1e-5 /
  atol 1e-6, scatter rtol 1e-4 / atol 1e-5 (those of the JAX test), depth
  within 1e-5 relative with identical zero masks;
- ``RayNetForwardPass`` sharded, with its device store and with its host
  store (the budget lowered below each rank's need, memmap spill files),
  on the mock scene (3 reference views, D = 8, grid 12^3, M = 24) against
  the JAX pass with ``multichip = "off"`` and the port in one process.
  Bar: >= 0.999 of the pixels within 1e-3 relative, identical masks; every
  rank holds the whole maps; one grid all-reduce per image and sweep;
- one end-to-end training step on 64 rays split over the ranks against
  the JAX single-device step from the same weights and batch: loss rtol
  1e-5, gamma after the update rtol 1e-5 / atol 1e-7, every gradient leaf
  rtol 1e-4 / atol 1e-5 of the largest (``tests/test_sharding.py:252-278``),
  BatchNorm running statistics rtol 1e-5 / atol 1e-7, and every rank's
  parameters, gamma and optimizer state equal;
- ``raynet_forward_torch`` on 2 ranks: only rank 0 writes, under ``launch``
  and under ``torchrun``, its maps at the pass's bar of the one-process
  CLI's;
- a rank that raises fails the launch within its timeout.

The rank bodies below import neither ``jax`` nor ``raynet_tpu``: a spawned
rank imports this module to find them, so the JAX package is imported only
inside the tests and fixtures.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.multiprocessing.spawn import ProcessException

from raynet_tpu_torch.parallel import sharding

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_SIZES = [2, 3]
# the rig of tests/test_sharding.py:57-121
STEP_RIG = dict(h=24, w=32, v=3, d=4, padding=5, f=8, grid=(8, 8, 8), m=12,
                n=64)
# the mock scene's pass (tests/test_torch_forward_pass.py's flags)
VIEWS = (0, 3, 1)
PASS_BATCH = 700
# each rank's scores, segments and march sums fit, its messages do not
# (2 ranks: 165,888 + 248,832 bytes; 3 ranks: 110,592 + 165,888)
HOST_BUDGET = 200_000
# one process's: 331,776 + 497,664 (tests/test_torch_message_store.py's)
ONE_PROCESS_HOST_BUDGET = 700_000
CLI_FLAGS = [
    "--scene_idx", "0", "--forward_pass_factory", "raynet", "--rays_batch",
    str(PASS_BATCH), "--start_end", "0,2", "--depth_planes", "8",
    "--grid_shape", "12,12,12", "--maximum_number_of_marched_voxels", "24",
    "--patch_shape", "11,11,3",
]
# the end-to-end step: V, D, M and the batch of tests/test_torch_train_e2e.py's
# step (16 rays), held to the JAX step; and 64 rays, held to the port's step
# in one process and to float64 (test_sharded_step_gradients says why)
E2E = dict(v=4, d=6, m=12, rays=(16, 64))


def _agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a > 0, b > 0)
    return float(np.mean(np.abs(a - b) <= 1e-3 * np.abs(b)))


def _rank_file(out_dir, rank, ext="npz"):
    return os.path.join(out_dir, "rank%d.%s" % (rank, ext))


def _port_gp():
    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )

    return GenerationParameters(
        depth_planes=8, neighbors=4, patch_shape=(11, 11, 3),
        grid_shape=np.array([12, 12, 12], dtype=np.int32),
        max_number_of_marched_voxels=24, padding=11,
        sampling_type="sample_points_in_bbox", gamma_mrf=0.05)


# ---- rank bodies (spawned processes: no jax, no raynet_tpu) ----

def _steps_rank(group, rig_path, out_dir):
    """The sharded BP update and message / depth steps on this rank's span
    of the rig's rays; writes this rank's outputs and its span."""
    r = dict(np.load(rig_path))
    t = {k: torch.as_tensor(v) for k, v in r.items()}
    h, w, d = STEP_RIG["h"], STEP_RIG["w"], STEP_RIG["d"]
    pad, grid, m = STEP_RIG["padding"], STEP_RIG["grid"], STEP_RIG["m"]

    def mine(k):
        return sharding.shard(group, t[k])

    out = {"span": np.array(group.span(STEP_RIG["n"]))}
    msgs, scatter = sharding.sharded_bp_update(
        group, mine("bp_S"), mine("bp_flat_idx"), mine("bp_counts"),
        mine("bp_msgs"), t["bp_grid_acc"], 6 * 5 * 4)
    out.update(bp_msgs=msgs.numpy(), bp_scatter=scatter.numpy())
    cams = (t["feats"], t["P"], t["P_pinv"], t["center"], t["bbox"])
    step = (h, w, pad, d, grid, m)
    group.reset_counts()
    msgs, scatter = sharding.sharded_raynet_message_step(
        group, mine("idxs"), *cams, None, t["prior_grid"], *step,
        first_iteration=True)
    out.update(first_msgs=msgs.numpy(), first_scatter=scatter.numpy())
    msgs, scatter = sharding.sharded_raynet_message_step(
        group, mine("idxs"), *cams, mine("step_msgs"), t["step_grid"], *step)
    out.update(msg_msgs=msgs.numpy(), msg_scatter=scatter.numpy())
    out["depth"] = sharding.sharded_raynet_depth_step(
        group, mine("idxs"), *cams, mine("step_msgs"), t["step_grid"],
        *step).numpy()
    out["grid_all_reduces"] = group.grid_all_reduces
    np.savez(_rank_file(out_dir, group.rank), **out)


def _pass_rank(group, scene_dir, weights, out_dir, cli_data):
    """The raynet pass with the device store and with the host store, then
    the CLI on the scene in ``cli_data`` with an output directory of this
    rank's own; writes the maps, stores and collective counts."""
    from raynet_tpu_torch.common.scene import RestrepoScene
    from raynet_tpu_torch.inference import RayNetForwardPass
    from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
    from raynet_tpu_torch.scripts import forward_pass as cli

    scene = RestrepoScene(scene_dir, device="cpu")
    fe = FeatureExtractor("simple_cnn", state_dict=torch.load(weights),
                          device="cpu")
    out = {}
    for store in ("device", "host"):
        fp = RayNetForwardPass(fe, _port_gp(), None, scene.image_shape,
                               PASS_BATCH, device="cpu")
        if store == "host":
            fp.messages_device_budget = HOST_BUDGET
            fp.messages_memmap_threshold = 100
        group.reset_counts()
        out[store] = np.stack(list(fp.forward_pass(scene, VIEWS)))
        out[store + "_store"] = fp.message_store
        out[store + "_group"] = fp.ray_group is group
        out[store + "_grid_all_reduces"] = group.grid_all_reduces
        out[store + "_all_reduces"] = group.all_reduces
    cli.main([cli_data, os.path.join(out_dir, "cli%d" % group.rank)]
             + CLI_FLAGS + ["--weight_file", weights.replace(
                 ".pt", ".msgpack"), "--device", "cpu"])
    out["cli_group_open"] = sharding.current_ray_group() is group
    np.savez(_rank_file(out_dir, group.rank), **out)


def _e2e_rank(group, weights, out_dir):
    """For each batch ``batch<b>.npz`` of ``out_dir``: one sharded
    end-to-end step from ``weights`` on this rank's part of it, then
    ``eval_fn``; writes the metrics, gradients and the state."""
    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.train.train_e2e import build_end_to_end_training

    gp = GenerationParameters(
        depth_planes=E2E["d"], neighbors=E2E["v"] - 1,
        patch_shape=(11, 11, 3), grid_shape=np.array([6, 6, 6], np.int32),
        max_number_of_marched_voxels=E2E["m"])
    for b in E2E["rays"]:
        state, train, evaluate = build_end_to_end_training(
            1, gp, gp.grid_shape, lr=1e-3, gamma=0.031, bp_iterations=3,
            return_grads=True, device="cpu", ray_group=group)
        state.model.load_state_dict(torch.load(weights))
        part = sharding.shard_e2e_batch(group, dict(np.load(
            os.path.join(out_dir, "batch%d.npz" % b))))
        group.reset_counts()
        state, m = train(state, part)
        steps = group.grid_all_reduces
        ev = evaluate(state, part)
        torch.save({"loss": float(m["loss"]),
                    "gamma_used": float(m["gamma"]),
                    "gamma": state.gamma.item(), "grads": m["grads"],
                    "model": state.model.state_dict(),
                    "tx": state.tx.state_dict(),
                    "eval_loss": float(ev["loss"]),
                    "rows": part["y"].shape[0], "grid_all_reduces": steps},
                   _rank_file(out_dir, group.rank, "%d.pt" % b))


def _failing_rank(group):
    if group.rank == 1:
        raise RuntimeError("rank 1 fails before its collective")
    sharding.global_count(group, 1)  # waits for rank 1


# ---- the ray group's pieces without processes ----

@pytest.mark.parametrize("n", [0, 1, 2, 64, 65, 1728])
@pytest.mark.parametrize("world_size", [1, 2, 3, 8])
def test_spans_cover_every_row_once(n, world_size):
    spans = [sharding.RayGroup(r, world_size, torch.device("cpu")).span(n)
             for r in range(world_size)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [hi - lo for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1 and sorted(sizes, reverse=True) == sizes


def test_shard_e2e_batch_splits_rays():
    batch = {"X": np.arange(2 * 7 * 3).reshape(2, 7, 3),
             "y": np.arange(7 * 2).reshape(7, 2),
             "bbox": np.arange(6), "scene_idx": 4}
    parts = [sharding.shard_e2e_batch(
        sharding.RayGroup(r, 3, torch.device("cpu")), batch) for r in range(3)]
    np.testing.assert_array_equal(
        np.concatenate([p["X"] for p in parts], axis=1), batch["X"])
    np.testing.assert_array_equal(
        np.concatenate([p["y"] for p in parts]), batch["y"])
    assert [p["y"].shape[0] for p in parts] == [3, 2, 2]
    assert all(p["bbox"] is batch["bbox"] and p["scene_idx"] == 4
               for p in parts)


def test_a_cuda_group_without_a_card_raises(monkeypatch, tmp_path):
    """A rank that asks for CUDA where there is no card raises before it
    joins a process group; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        sharding.make_ray_group("cuda", init_method="file://%s" % (
            tmp_path / "rendezvous"), rank=0, world_size=1)
    assert not torch.distributed.is_initialized()
    assert sharding.current_ray_group() is None


def test_no_group_without_a_launcher(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert sharding.ray_group_from_env("cpu") is None
    assert sharding.current_ray_group() is None


# ---- 1. the BP update and the message / depth steps ----

def _step_rig():
    """tests/test_sharding.py's seeded inputs: each of its tests draws from
    a fresh RandomState(0), the BP update's (bp_*) and the message step's
    in these orders."""
    rng = np.random.RandomState(0)
    g, n, m = 6 * 5 * 4, 64, 10
    rig = dict(bp_flat_idx=rng.randint(0, g, size=(n, m)).astype(np.int32),
               bp_counts=rng.randint(2, m + 1, size=(n,)).astype(np.int32),
               bp_S=rng.uniform(0.01, 1.0, size=(n, m)).astype(np.float32),
               bp_msgs=(rng.randn(n, m) * 0.1).astype(np.float32),
               bp_grid_acc=(rng.randn(g) * 0.5).astype(np.float32))
    rng = np.random.RandomState(0)
    h, w, v, pad, f = (STEP_RIG[k] for k in ("h", "w", "v", "padding", "f"))
    m, n, g = STEP_RIG["m"], STEP_RIG["n"], int(np.prod(STEP_RIG["grid"]))
    K = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]])
    Ps, centers = [], []
    for i in range(v):
        ang = (i - v / 2) * 0.05
        c = np.array([15 * np.sin(ang), 0, -15 * np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Ps.append(K @ np.hstack([R, -R @ c.reshape(3, 1)]))
        centers.append(c)
    prior = np.log(np.float32(0.05)) - np.log(np.float32(0.95))
    rig.update(
        P=np.stack(Ps).astype(np.float32),
        P_pinv=np.linalg.pinv(Ps[0]).astype(np.float32),
        center=np.asarray(centers[0], np.float32),
        bbox=np.array([-2, -2, -2, 2, 2, 2], np.float32),
        feats=rng.randn(v, h + pad + 1, w + pad + 1, f).astype(np.float32),
        # 64 rays through the image's middle: the JAX test's first 64 rays
        # (columns 0-2) miss the bbox, and would scatter nothing
        idxs=np.arange(n, dtype=np.int32) + (h * w - n) // 2,
        step_msgs=(rng.randn(n, m) * 0.1).astype(np.float32),
        step_grid=(rng.randn(g) * 0.3).astype(np.float32),
        prior_grid=np.full(g, prior, np.float32))
    return rig


def _gather(out_dir, ws):
    """Every rank's outputs; ``cat(key)`` joins a per-rank key in rank
    order."""
    parts = [dict(np.load(_rank_file(out_dir, r))) for r in range(ws)]
    return parts, lambda key: np.concatenate([p[key] for p in parts])


@pytest.fixture(scope="module", params=WORLD_SIZES)
def steps(request, tmp_path_factory):
    """(world size, the JAX package's outputs, the ranks' outputs)."""
    import jax.numpy as jnp

    from raynet_tpu.ops import fused as jfused
    from raynet_tpu.ops import mrf as jmrf

    ws = request.param
    tmp = tmp_path_factory.mktemp("steps%d" % ws)
    rig = _step_rig()
    j = {k: jnp.asarray(v) for k, v in rig.items()}
    want = {}
    msgs, scatter = jmrf.bp_update(
        *(j["bp_" + k] for k in ("S", "flat_idx", "counts", "msgs",
                                 "grid_acc")), 6 * 5 * 4)
    want.update(bp_msgs=msgs, bp_scatter=scatter)
    cams = [j[k] for k in ("feats", "P", "P_pinv", "center", "bbox")]
    step = (STEP_RIG["h"], STEP_RIG["w"], STEP_RIG["padding"],
            STEP_RIG["d"], STEP_RIG["grid"], STEP_RIG["m"])
    n = jnp.int32(STEP_RIG["n"])
    zeros = jnp.zeros((STEP_RIG["n"], STEP_RIG["m"]), jnp.float32)
    msgs, scatter, _ = jfused.raynet_message_step(
        j["idxs"], *cams, zeros, j["prior_grid"], n, *step,
        first_iteration=True)
    want.update(first_msgs=msgs, first_scatter=scatter)
    msgs, scatter, _ = jfused.raynet_message_step(
        j["idxs"], *cams, j["step_msgs"], j["step_grid"], n, *step)
    want.update(msg_msgs=msgs, msg_scatter=scatter)
    _, want["depth"] = jfused.raynet_depth_step(
        j["idxs"], *cams, j["step_msgs"], j["step_grid"], *step)
    path = str(tmp / "rig.npz")
    np.savez(path, **rig)
    sharding.launch(_steps_rank, ws, "cpu", args=(path, str(tmp)))
    return ws, {k: np.asarray(v) for k, v in want.items()}, _gather(
        str(tmp), ws)


def test_sharded_bp_update_matches_jax(steps):
    ws, want, (parts, cat) = steps
    np.testing.assert_allclose(cat("bp_msgs"), want["bp_msgs"], rtol=1e-5,
                               atol=1e-6)
    for p in parts:  # every rank holds the whole scatter
        np.testing.assert_allclose(p["bp_scatter"], want["bp_scatter"],
                                   rtol=1e-4, atol=1e-5)
    assert [p["bp_msgs"].shape[0] for p in parts] == [
        hi - lo for lo, hi in (p["span"] for p in parts)]


@pytest.mark.parametrize("kind", ["first", "msg"])
def test_sharded_message_step_matches_jax(steps, kind):
    """The first iteration (zero messages, the prior's grid) and a later
    one (seeded messages and grid)."""
    ws, want, (parts, cat) = steps
    np.testing.assert_allclose(cat(kind + "_msgs"), want[kind + "_msgs"],
                               rtol=1e-5, atol=1e-6)
    for p in parts:
        np.testing.assert_allclose(p[kind + "_scatter"],
                                   want[kind + "_scatter"], rtol=1e-4,
                                   atol=1e-5)
    assert np.abs(want[kind + "_scatter"]).max() > 0.1


def test_sharded_depth_step_matches_jax(steps):
    ws, want, (parts, cat) = steps
    got = cat("depth")
    assert np.array_equal(got > 0, want["depth"] > 0) and (got > 0).any()
    np.testing.assert_allclose(got, want["depth"], rtol=1e-5)


def test_one_grid_all_reduce_per_message_step(steps):
    """Two message steps all-reduce the grid once each; the depth step
    reads it and makes no collective."""
    ws, _, (parts, _) = steps
    assert [int(p["grid_all_reduces"]) for p in parts] == [2] * ws
    spans = [tuple(p["span"]) for p in parts]
    assert spans[0][0] == 0 and spans[-1][1] == STEP_RIG["n"]


# ---- 2. the raynet pass and the CLI ----

def _one_process_maps(scene_dir, weights, **store):
    """The port's pass in this process (``multichip`` "off")."""
    from raynet_tpu_torch.common.scene import RestrepoScene
    from raynet_tpu_torch.inference import RayNetForwardPass
    from raynet_tpu_torch.models.feature_extractor import FeatureExtractor

    scene = RestrepoScene(scene_dir, device="cpu")
    fp = RayNetForwardPass(
        FeatureExtractor("simple_cnn", state_dict=torch.load(weights),
                         device="cpu"),
        _port_gp(), None, scene.image_shape, PASS_BATCH, device="cpu")
    fp.multichip = "off"
    for k, v in store.items():
        setattr(fp, k, v)
    return np.stack(list(fp.forward_pass(scene, VIEWS))), fp


@pytest.fixture(scope="module")
def pass_inputs(mock_scene_dir, tmp_path_factory):
    """The JAX CNN's weights for both packages (a torch state_dict and the
    JAX msgpack), the JAX pass's maps with ``multichip`` "off", the port's
    one-process maps with each store, and the one-process CLI's maps."""
    from raynet_tpu.common.generation_parameters import (
        GenerationParameters as JaxGenerationParameters,
    )
    from raynet_tpu.common.sampling_schemes import get_sampling_scheme
    from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
    from raynet_tpu.inference import get_forward_pass_factory as jax_factory
    from raynet_tpu.models.feature_extractor import (
        FeatureExtractor as JaxFeatureExtractor,
    )
    from raynet_tpu_torch.models.convert import state_dict_from_flax
    from raynet_tpu_torch.scripts import forward_pass as cli

    tmp = tmp_path_factory.mktemp("pass")
    jfe = JaxFeatureExtractor("simple_cnn", seed=0)
    weights = str(tmp / "cnn.pt")
    torch.save(state_dict_from_flax(jfe.variables), weights)
    jfe.save_weights(weights.replace(".pt", ".msgpack"))
    scene = JaxRestrepoScene(str(mock_scene_dir))
    jgp = JaxGenerationParameters(
        depth_planes=8, neighbors=4, patch_shape=(11, 11, 3),
        grid_shape=np.array([12, 12, 12], dtype=np.int32),
        max_number_of_marched_voxels=24, padding=11,
        sampling_type="sample_points_in_bbox", gamma_mrf=0.05)
    jfp = jax_factory("raynet")(jfe, jgp, get_sampling_scheme(
        "sample_in_bbox")(jgp), scene.image_shape, PASS_BATCH)
    jfp.multichip = "off"
    jax_maps = np.stack(list(jfp.forward_pass(scene, VIEWS)))
    one = {"device": _one_process_maps(str(mock_scene_dir), weights)[0],
           "host": _one_process_maps(
               str(mock_scene_dir), weights,
               messages_device_budget=ONE_PROCESS_HOST_BUDGET,
               messages_memmap_threshold=100)[0]}
    cli_out = str(tmp / "cli")
    cli.main([str(mock_scene_dir.parent), cli_out] + CLI_FLAGS
             + ["--weight_file", weights.replace(".pt", ".msgpack"),
                "--device", "cpu"])
    cli_maps = np.stack([np.load(os.path.join(cli_out, "depth_%03d.npy" % i))
                         for i in range(2)])
    return dict(scene_dir=str(mock_scene_dir), data=str(mock_scene_dir.parent),
                weights=weights, jax=jax_maps, one=one, cli=cli_maps)


@pytest.fixture(scope="module", params=WORLD_SIZES)
def passes(request, pass_inputs, tmp_path_factory):
    """(world size, every rank's outputs, their directory); each rank also
    runs the CLI into a directory of its own."""
    ws = request.param
    tmp = str(tmp_path_factory.mktemp("passes%d" % ws))
    sharding.launch(_pass_rank, ws, "cpu", args=(
        pass_inputs["scene_dir"], pass_inputs["weights"], tmp,
        pass_inputs["data"]))
    return ws, _gather(tmp, ws)[0], tmp


@pytest.mark.parametrize("store", ["device", "host"])
def test_sharded_pass_matches_jax(passes, pass_inputs, store):
    ws, parts, _ = passes
    maps = parts[0][store]
    assert maps.shape == pass_inputs["jax"].shape and np.isfinite(maps).all()
    assert _agree(maps, pass_inputs["jax"]) >= 0.999
    assert (maps > 0).mean() > 0.5


@pytest.mark.parametrize("store", ["device", "host"])
def test_sharded_pass_matches_one_process(passes, pass_inputs, store):
    ws, parts, _ = passes
    assert _agree(parts[0][store], pass_inputs["one"][store]) >= 0.999


def test_every_rank_holds_the_whole_maps(passes):
    ws, parts, _ = passes
    for p in parts[1:]:
        for store in ("device", "host"):
            assert np.array_equal(p[store], parts[0][store])


def test_stores_and_collectives_per_rank(passes):
    """Each rank sized its own store (the host store where its rows' messages
    pass the budget), and all-reduced the grid once per image and sweep,
    plus one gather of each image's depths."""
    ws, parts, _ = passes
    images, sweeps = len(range(*VIEWS)), 3
    for p in parts:
        assert str(p["device_store"]) == "device"
        assert str(p["host_store"]) == "memmap"
        for store in ("device", "host"):
            assert bool(p[store + "_group"])
            assert int(p[store + "_grid_all_reduces"]) == images * sweeps
            assert int(p[store + "_all_reduces"]) == images * (sweeps + 1)


def test_only_rank_zero_writes(passes, pass_inputs):
    """The CLI on the ranks: rank 0 writes the maps, the others nothing,
    and the CLI leaves the ray group that was open before it open."""
    ws, parts, tmp = passes
    for r in range(1, ws):
        assert not os.path.exists(os.path.join(tmp, "cli%d" % r))
    maps = np.stack([np.load(os.path.join(tmp, "cli0", "depth_%03d.npy" % i))
                     for i in range(2)])
    assert _agree(maps, pass_inputs["cli"]) >= 0.999
    assert all(bool(p["cli_group_open"]) for p in parts)


def test_torchrun_cli_matches_one_process(pass_inputs, tmp_path):
    """``raynet_forward_torch`` under ``torchrun --nproc_per_node 2`` on the
    CPU (gloo): its ranks set up the ray group from torchrun's variables,
    rank 0 alone prints and writes, and the maps agree with the
    one-process CLI's."""
    out = str(tmp_path / "out")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "raynet_tpu_torch.scripts.forward_pass",
         pass_inputs["data"], out] + CLI_FLAGS
        + ["--weight_file", pass_inputs["weights"].replace(".pt", ".msgpack"),
           "--device", "cpu"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("saved ") == 2, run.stdout
    maps = np.stack([np.load(os.path.join(out, "depth_%03d.npy" % i))
                     for i in range(2)])
    assert _agree(maps, pass_inputs["cli"]) >= 0.999


# ---- 3. the end-to-end training step ----

def _port_step(weights, batch):
    """The port's step in one process, and the float64 gradients of the
    same step."""
    from raynet_tpu_torch.common.generation_parameters import (
        GenerationParameters,
    )
    from raynet_tpu_torch.train.train_e2e import build_end_to_end_training
    from test_torch_train_e2e import _float64_grads

    gp = GenerationParameters(
        depth_planes=E2E["d"], neighbors=E2E["v"] - 1,
        patch_shape=(11, 11, 3), grid_shape=np.array([6, 6, 6], np.int32),
        max_number_of_marched_voxels=E2E["m"])
    state, train, evaluate = build_end_to_end_training(
        1, gp, gp.grid_shape, lr=1e-3, gamma=0.031, bp_iterations=3,
        return_grads=True, device="cpu")
    state.model.load_state_dict(torch.load(weights))
    g64, gamma64, _ = _float64_grads(state, batch)
    state, m = train(state, batch)
    return {"loss": float(m["loss"]), "gamma": state.gamma.item(),
            "grads": m["grads"], "grads64": dict(g64, gamma=gamma64),
            "model": state.model.state_dict(),
            "eval_loss": float(evaluate(state, batch)["loss"])}


@pytest.fixture(scope="module", params=WORLD_SIZES)
def e2e(request, tmp_path_factory):
    """(world size, {rays: (the reference, every rank's outputs)}): the
    reference of 16 rays is the JAX step's (loss, gamma after the update,
    gradients, state dict of the updated CNN, eval loss after the step),
    that of 64 rays the port's step in one process."""
    import jax

    from raynet_tpu.common.generation_parameters import (
        GenerationParameters as JaxGenerationParameters,
    )
    from raynet_tpu.train.train_e2e import build_end_to_end_training
    from raynet_tpu_torch.models.convert import state_dict_from_flax
    from test_torch_train_e2e import make_batch

    ws = request.param
    tmp = tmp_path_factory.mktemp("e2e%d" % ws)
    v, d, m = (E2E[k] for k in ("v", "d", "m"))
    jgp = JaxGenerationParameters(
        depth_planes=d, neighbors=v - 1, patch_shape=(11, 11, 3),
        grid_shape=np.array([6, 6, 6], dtype=np.int32),
        max_number_of_marched_voxels=m)
    jstate, jtrain, jeval = build_end_to_end_training(
        jax.random.PRNGKey(0), jgp, jgp.grid_shape, return_grads=True,
        lr=1e-3, gamma=0.031, bp_iterations=3)
    weights = str(tmp / "cnn.pt")
    torch.save(state_dict_from_flax({"params": jstate.params["cnn"],
                                     "batch_stats": jstate.batch_stats}),
               weights)
    refs = {}
    for b in E2E["rays"]:
        batch = make_batch(3, v, b, d, m, shift=0.5)
        np.savez(str(tmp / ("batch%d.npz" % b)), **batch)
        if b == 16:
            jstate2, jm = jtrain(jstate, batch)
            refs[b] = {
                "loss": float(jm["loss"]),
                "gamma": float(jstate2.params["gamma"]),
                "grads": {"cnn": state_dict_from_flax(
                    {"params": jm["grads"]["cnn"],
                     "batch_stats": jstate.batch_stats}),
                    "gamma": float(jm["grads"]["gamma"])},
                "model": state_dict_from_flax(
                    {"params": jstate2.params["cnn"],
                     "batch_stats": jstate2.batch_stats}),
                "eval_loss": float(jeval(jstate2, batch)["loss"]),
                "scale": max(float(np.abs(np.asarray(g)).max())
                             for g in jax.tree_util.tree_leaves(jm["grads"]))}
        else:
            refs[b] = _port_step(weights, batch)
            refs[b]["scale"] = max(float(g.abs().max())
                                   for g in refs[b]["grads"]["cnn"].values())
    sharding.launch(_e2e_rank, ws, "cpu", args=(weights, str(tmp)))
    return ws, {b: (refs[b], [torch.load(_rank_file(str(tmp), r, "%d.pt" % b))
                              for r in range(ws)]) for b in E2E["rays"]}


@pytest.mark.parametrize("rays", E2E["rays"])
def test_sharded_step_loss_and_gamma(e2e, rays):
    """Loss rtol 1e-5, gamma after the update rtol 1e-5 / atol 1e-7, on
    every rank."""
    ws, runs = e2e
    ref, parts = runs[rays]
    assert sum(p["rows"] for p in parts) == rays
    for p in parts:
        np.testing.assert_allclose(p["loss"], ref["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(p["gamma_used"], 0.031, rtol=1e-7)
        np.testing.assert_allclose(p["gamma"], ref["gamma"], rtol=1e-5,
                                   atol=1e-7)
        assert p["gamma"] != 0.031


@pytest.mark.parametrize("rays", E2E["rays"])
def test_sharded_step_gradients(e2e, rays):
    """16 rays: every gradient leaf of every rank within rtol 1e-4 / atol
    1e-5 of the largest of the JAX step's, gamma's included.

    64 rays: there float32 rounding alone puts the conv kernels' gradients
    of the one-process step 1.9e-5 to 7.9e-5 of the largest entry from the
    float64 gradient (and 3.7e-5 from the JAX step's), and gamma's 1.1e-4
    relative (the JAX step's 2.6e-4), so a sharded step, which sums in
    another order, cannot meet the bar against either. Each leaf is held
    to the float64 gradient instead: its error at most twice the
    one-process step's plus 1e-5 of the largest entry (the repo's rule for
    float32-bound deltas, ROADMAP Queue 3)."""
    ws, runs = e2e
    ref, parts = runs[rays]
    want, scale = dict(ref["grads"]["cnn"]), ref["scale"]
    want["gamma"] = torch.as_tensor(ref["grads"]["gamma"])
    for p in parts:
        assert set(p["grads"]["cnn"]) == {
            k for k in want if k != "gamma" and "running" not in k
            and "num_batches" not in k}
        got = dict(p["grads"]["cnn"], gamma=p["grads"]["gamma"])
        for name, g in got.items():
            if rays == 16:
                np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                           rtol=1e-4, atol=1e-5 * scale,
                                           err_msg=name)
                continue
            exact = ref["grads64"][name]
            err = float((g.double() - exact).abs().max())
            one = float((want[name].double() - exact).abs().max())
            assert err <= 2 * one + 1e-5 * scale, (name, err, one, scale)


@pytest.mark.parametrize("rays", E2E["rays"])
def test_sharded_step_batchnorm_statistics(e2e, rays):
    """The running statistics of all ranks' patches, rtol 1e-5 / atol
    1e-7: a rank that normalised with its own patches would miss the
    bar."""
    ws, runs = e2e
    ref, parts = runs[rays]
    names = [k for k in ref["model"] if "running" in k]
    assert len(names) == 10
    for p in parts:
        for k in names:
            np.testing.assert_allclose(p["model"][k].numpy(),
                                       ref["model"][k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("rays", E2E["rays"])
def test_sharded_eval(e2e, rays):
    ws, runs = e2e
    ref, parts = runs[rays]
    for p in parts:
        np.testing.assert_allclose(p["eval_loss"], ref["eval_loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("rays", E2E["rays"])
def test_ranks_hold_equal_state_after_the_step(e2e, rays):
    """Every rank's parameters, buffers, gamma and optimizer state are
    equal after the step, and each made the same grid all-reduces: BP's 3
    sweeps forward and their 3 backward (the recomputation of remat stops
    before the all-reduce, which saves nothing for the backward)."""
    ws, runs = e2e
    _, parts = runs[rays]
    for p in parts[1:]:
        assert p["gamma"] == parts[0]["gamma"]
        assert all(torch.equal(t, parts[0]["model"][k])
                   for k, t in p["model"].items())
        assert p["tx"]["count"] == parts[0]["tx"]["count"] == 1
        for k, ts in p["tx"]["state"].items():
            assert all(torch.equal(a, b)
                       for a, b in zip(ts, parts[0]["tx"]["state"][k]))
    assert [p["grid_all_reduces"] for p in parts] == [3 + 3] * ws


# ---- 4. failures ----

def test_a_failing_rank_fails_the_launch():
    """A rank that raises while the other waits in a collective: the launch
    raises within the group's timeout, with the failing rank's error or
    with the other rank's, whose peer closed or reset the connection
    (whichever the launcher saw first)."""
    timeout = 20.0
    t0 = time.perf_counter()
    with pytest.raises(ProcessException) as raised:
        sharding.launch(_failing_rank, 2, "cpu", timeout=timeout)
    assert time.perf_counter() - t0 < timeout
    msg = str(raised.value)
    assert ("rank 1 fails" in msg
            or (raised.value.error_index == 0 and "by peer" in msg)), msg
