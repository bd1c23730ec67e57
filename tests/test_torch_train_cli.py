"""The port's end-to-end training CLI (``raynet_train_torch``) on the mock
scene and the CPU: the twin of ``tests/test_train_cli.py`` (files, the
statistics header, line counts, kill and resume), its weight files read by
the JAX package and by ``raynet_forward_torch --weight_file``, a JAX
package's weight file read by the port, and the card guard.
"""
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raynet_tpu.models.cnn import cnn_factory as jax_cnn_factory
from raynet_tpu_torch.common.generation_parameters import (
    GenerationParameters,
)
from raynet_tpu_torch.models.cnn import cnn_factory
from raynet_tpu_torch.models.convert import (
    flax_from_cnn_state_dict,
    read_cnn_weights,
    read_flax_msgpack,
    state_dict_from_flax,
    write_cnn_weights,
)
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.scripts import forward_pass as forward_cli
from raynet_tpu_torch.scripts import train_raynet as train_cli
from raynet_tpu_torch.train.checkpointing import CheckpointManager
from raynet_tpu_torch.train.train_e2e import build_end_to_end_training
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)


def _train_args(mock_scene_dir, out, iters, extra=()):
    return [
        str(mock_scene_dir.parent),
        str(mock_scene_dir.parent),
        str(out),
        "--iterations", str(iters),
        "--validate_every", "100",
        "--snapshot_every", "100",
        "--rays_batch_size", "3",
        "--window", "2",
        "--depth_planes", "4",
        "--neighbors", "4",
        "--patch_shape", "11,11,3",
        "--grid_shape", "8,8,8",
        "--maximum_number_of_marched_voxels", "16",
        "--bp_iterations", "2",
        "--checkpoint_every", "1",
        "--device", "cpu",
    ] + list(extra)


def _experiment(out):
    (name,) = os.listdir(out)
    return out / name


def test_train_raynet_cli(mock_scene_dir, tmp_path, capsys):
    args = _train_args(mock_scene_dir, tmp_path, 2, [
        "--validate_every", "1", "--snapshot_every", "2",
        "--train_with_gamma"])
    train_cli.main(args)
    exp = _experiment(tmp_path)
    stats = (exp / "train_statistics.txt").read_text().strip().splitlines()
    assert stats[0] == "scene_idx loss gamma"
    assert len(stats) == 3  # header + 2 iterations
    loss, gamma = float(stats[1].split()[1]), float(stats[1].split()[2])
    assert np.isfinite(loss) and 0 < gamma < 1
    assert float(stats[2].split()[2]) != gamma  # gamma is trained
    val = (exp / "val_loss.txt").read_text().strip().splitlines()
    assert [v.split()[0] for v in val] == ["0", "1"]
    assert all(np.isfinite(float(v.split()[1])) for v in val)
    weight_files = os.listdir(exp / "weights")
    assert "weights.final.msgpack" in weight_files
    assert "weights.1.msgpack" in weight_files
    out = capsys.readouterr().out
    assert out.count("traversal call(s)), the step") == 2
    assert "WARNING: training end-to-end from random CNN weights" in out


def test_train_raynet_kill_and_resume(mock_scene_dir, tmp_path, capsys):
    """An interrupted run resumes from its checkpoint with the whole state
    (CNN, BatchNorm statistics, gamma, optimizer moments and step),
    continuing at the saved iteration and appending to its logs."""
    train_cli.main(_train_args(mock_scene_dir, tmp_path, 2,
                               ["--train_with_gamma"]))
    exp = _experiment(tmp_path)
    assert "2" in os.listdir(exp / "checkpoints")
    w_before = (exp / "weights" / "weights.final.msgpack").read_bytes()
    saved = CheckpointManager(str(exp / "checkpoints"))
    capsys.readouterr()

    train_cli.main(_train_args(mock_scene_dir, tmp_path, 4,
                               ["--train_with_gamma", "--resume", str(exp)]))
    out = capsys.readouterr().out
    assert "resumed from checkpoint at iteration 2" in out
    assert len(os.listdir(tmp_path)) == 1  # no new experiment directory
    stats = (exp / "train_statistics.txt").read_text().strip().splitlines()
    assert stats[0] == "scene_idx loss gamma"
    assert len(stats) == 5  # one header + 2 + 2 iterations, appended
    assert "4" in os.listdir(exp / "checkpoints")
    w_after = (exp / "weights" / "weights.final.msgpack").read_bytes()
    assert w_after != w_before

    # the checkpoint of step 2 holds the whole state
    sd = torch.load(os.path.join(saved._directory, "2", "state.pt"),
                    weights_only=True)
    assert sd["tx"]["count"] == 2 and sd["gamma"] is not None
    assert {"mu", "nu"} <= set(sd["tx"]["state"])
    assert any("running_var" in k for k in sd["model"])


def test_weight_files_cross_packages(mock_scene_dir, tmp_path):
    """The port's weights.final.msgpack restores into the JAX package's
    template of the CNN (as ``raynet_tpu/scripts/train_raynet.py`` reads
    ``--weight_file``) with the port's values; a JAX-written file starts
    the port's training; ``raynet_forward_torch``'s extractor reads the
    port's file."""
    train_cli.main(_train_args(mock_scene_dir, tmp_path / "run", 1))
    path = _experiment(tmp_path / "run") / "weights" / "weights.final.msgpack"
    port_sd = read_cnn_weights(str(path))

    model = jax_cnn_factory("simple_cnn")()
    variables = model.init(jax.random.PRNGKey(3),
                           jnp.zeros((1, 11, 11, 3), jnp.float32))
    template = {"params": variables["params"],
                "batch_stats": variables["batch_stats"]}
    restored = flax.serialization.from_bytes(template, path.read_bytes())
    back = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           restored))
    for k, v in port_sd.items():
        if "num_batches" not in k:
            assert torch.equal(back[k], v), k

    # a JAX-written weight file into the port
    jax_file = tmp_path / "jax.msgpack"
    jax_file.write_bytes(flax.serialization.to_bytes(template))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           template))
    gp = GenerationParameters(depth_planes=4, neighbors=4,
                              patch_shape=(11, 11, 3))
    state, _, _ = build_end_to_end_training(
        0, gp, (8, 8, 8), weight_file=str(jax_file), device="cpu")
    got = state.model.state_dict()
    for k, v in want.items():
        if "num_batches" not in k:
            assert torch.equal(got[k], v), k

    fe = FeatureExtractor.from_weights("simple_cnn", str(path), device="cpu")
    for k, v in fe.model.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(v, port_sd[k]), k
    pred = tmp_path / "pred"
    forward_cli.main([str(mock_scene_dir.parent), str(pred), "--scene_idx",
                      "0", "--start_end", "0,1", "--forward_pass_factory",
                      "multi_view_cnn", "--depth_planes", "4",
                      "--weight_file", str(path), "--device", "cpu"])
    dm = np.load(pred / "depth_000.npy")
    assert dm.shape == (H, W) and np.isfinite(dm).all() and (dm > 0).any()

    # the public pair round-trips every CNN layout, the file too
    for name in ("simple_cnn", "simple_cnn_ln", "hartmann_cnn"):
        m = cnn_factory(name)(3)
        m.reset_parameters(torch.Generator().manual_seed(1))
        sd = m.state_dict()
        tree = flax_from_cnn_state_dict(sd)
        assert set(tree) == {"params", "batch_stats"}
        f = tmp_path / ("%s.msgpack" % name)
        write_cnn_weights(str(f), sd)
        assert set(read_flax_msgpack(str(f))) == {"params", "batch_stats"}
        back = read_cnn_weights(str(f))
        for k, v in sd.items():
            if "num_batches" not in k:
                assert torch.equal(back[k], v), (name, k)


def test_train_cli_cuda_without_a_card_raises(mock_scene_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    flags = _train_args(mock_scene_dir, tmp_path, 1)
    flags[flags.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        train_cli.main(flags)
    assert not os.listdir(tmp_path)
