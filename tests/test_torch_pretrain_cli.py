"""The port's pretraining CLI (``raynet_pretrain_torch``) in its modes on
the mock scene, its checkpoints and resume, the weight files it writes
read by ``raynet_forward_torch --weight_file``, and
``raynet_forward_torch --forward_pass_factory hartmann_fp`` against the
JAX package's CLI, all on the CPU.

Tolerances: a resumed run's losses equal the uninterrupted run's exactly
(the CPU run is deterministic); the hartmann_fp CLIs' depth maps >= 0.999
of the pixels within 1e-3 relative, masks identical (the ROADMAP's depth
bar; the two CNNs sum in different orders).
"""
import os

import numpy as np
import pytest
import torch

from raynet_tpu.models.feature_extractor import (
    FeatureExtractor as JaxFeatureExtractor,
)
from raynet_tpu.scripts import forward_pass as jax_forward_cli
from raynet_tpu_torch.models.convert import (
    read_flax_msgpack,
    similarity_state_dict_from_flax,
)
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.scripts import forward_pass as forward_cli
from raynet_tpu_torch.scripts import pretrain_network as pretrain_cli
from raynet_tpu_torch.scripts.experiments_utils import Metrics
from raynet_tpu_torch.train.checkpointing import CheckpointManager
from raynet_tpu_torch.train.pretrain import (
    create_pretrain_state,
    make_pretrain_step,
)
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)


def _flags(scene_dir, out):
    root = str(scene_dir.parent)
    return [root, root, str(out), "--device", "cpu",
            "--steps_per_epoch", "2", "--training_cached_samples", "4",
            "--n_test_samples", "2", "--batch_size", "2",
            "--neighbors", "2", "--depth_planes", "4"]


def _experiment(out):
    (name,) = [d for d in os.listdir(out) if os.path.isdir(out / d)]
    return out / name


def _losses(exp):
    return Metrics(str(exp / "train.txt"), str(exp / "val.txt")).train["loss"]


def test_pretrain_cli_default_resume_and_weights(mock_scene_dir, tmp_path,
                                                 capsys):
    full, cut = tmp_path / "full", tmp_path / "cut"
    pretrain_cli.main(_flags(mock_scene_dir, full) + ["--epochs", "2"])
    exp = _experiment(full)
    assert sorted(os.listdir(exp / "weights")) == ["weights.00.msgpack",
                                                   "weights.01.msgpack"]
    assert sorted(os.listdir(exp / "checkpoints")) == ["1", "2"]
    assert np.load(exp / "results.npy").shape == (2, 3)
    losses = _losses(exp)
    assert losses.shape == (4,) and np.isfinite(losses).all()
    assert (full / "experiments.jsonl").exists()

    pretrain_cli.main(_flags(mock_scene_dir, cut) + ["--epochs", "1"])
    resumed = _experiment(cut)
    capsys.readouterr()
    pretrain_cli.main(_flags(mock_scene_dir, cut)
                      + ["--epochs", "2", "--resume", str(resumed)])
    assert "resumed from checkpoint after epoch 0" in capsys.readouterr().out
    val = (resumed / "val.txt").read_text().strip().splitlines()
    assert val[0].startswith("epoch") and len(val) == 3
    np.testing.assert_array_equal(_losses(resumed), losses)

    # the weight file is read by the forward CLI's FeatureExtractor
    weights = exp / "weights" / "weights.01.msgpack"
    sd = similarity_state_dict_from_flax(read_flax_msgpack(str(weights)))
    fe = FeatureExtractor("simple_cnn", device="cpu")
    fe.load_weights(str(weights))
    for k, v in fe.model.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(v, sd["cnn." + k]), k
    out = tmp_path / "maps"
    forward_cli.main([
        str(mock_scene_dir.parent), str(out), "--scene_idx", "0",
        "--forward_pass_factory", "multi_view_cnn", "--start_end", "0,1",
        "--depth_planes", "4", "--weight_file", str(weights),
        "--device", "cpu",
    ])
    dm = np.load(out / "depth_000.npy")
    assert dm.shape == (H, W) and np.isfinite(dm).all()


def test_pretrain_cli_hartmann_mode(mock_scene_dir, tmp_path, capsys):
    flags = _flags(mock_scene_dir, tmp_path) + [
        "--input_output_dimensionality", "hartmann", "--patch_shape",
        "32,32,3", "--step_depth", "1", "--optimizer", "SGD",
        "--expand_patch"]
    pretrain_cli.main(flags + ["--epochs", "1"])
    exp = _experiment(tmp_path)
    assert (exp / "train.txt").exists() and (exp / "parameters.json").exists()
    losses = _losses(exp)
    assert losses.shape == (2,) and np.isfinite(losses).all()
    capsys.readouterr()
    pretrain_cli.main(flags + ["--epochs", "2", "--resume", str(exp)])
    assert "resumed from checkpoint after epoch 0" in capsys.readouterr().out
    assert len(_losses(exp)) == 4
    # its weight file feeds the hartmann_fp pass through the CLI
    out = tmp_path / "maps"
    forward_cli.main([
        str(mock_scene_dir.parent), str(out), "--scene_idx", "0",
        "--forward_pass_factory", "hartmann_fp", "--cnn_factory",
        "hartmann_cnn", "--patch_shape", "32,32,3", "--start_end", "0,1",
        "--depth_planes", "2", "--rays_batch", "1024", "--device", "cpu",
        "--weight_file", str(exp / "weights" / "weights.01.msgpack"),
    ])
    dm = np.load(out / "depth_000.npy")
    assert dm.shape == (H, W) and np.isfinite(dm).all() and dm.max() <= 800


def test_pretrain_cli_cuda_without_card_raises(mock_scene_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    flags = _flags(mock_scene_dir, tmp_path)
    flags[flags.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        pretrain_cli.main(flags + ["--epochs", "1"])
    assert not os.listdir(tmp_path)


def test_checkpoint_manager_round_trip(tmp_path):
    """Resumed training equals uninterrupted training: parameters,
    BatchNorm statistics, Adam's moments and its step all come back."""
    shape = (4, 3, 11, 11, 3)
    rng = np.random.RandomState(0)
    batches = [(rng.rand(2, *shape).astype(np.float32),
                rng.rand(2, *shape).astype(np.float32),
                np.eye(4, dtype=np.float32)[rng.randint(0, 4, 2)])
               for _ in range(4)]

    def fresh():
        model, state, loss_fn, wd = create_pretrain_state(
            3, shape, optimizer="Adam", lr=1e-2, device="cpu")
        return state, make_pretrain_step(model, loss_fn, wd)[0]

    state, step = fresh()
    for b in batches:
        state, _ = step(state, *b)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}

    ckpt = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=2,
                             max_to_keep=2)
    state, step = fresh()
    assert ckpt.restore(state) == (state, None)
    for i, b in enumerate(batches[:2]):
        state, _ = step(state, *b)
        ckpt.save(i + 1, state)  # only step 2 is on the interval
    assert ckpt.all_steps() == [2]
    for s in (3, 4, 5):
        ckpt.save(s, state, force=True)
    assert ckpt.all_steps() == [4, 5] and ckpt.latest_step() == 5
    ckpt.wait()
    ckpt.close()

    ckpt = CheckpointManager(str(tmp_path / "ckpt2"))
    state, step = fresh()
    for b in batches[:2]:
        state, _ = step(state, *b)
    ckpt.save(2, state, force=True)
    resumed, step2 = fresh()
    resumed, at = CheckpointManager(str(tmp_path / "ckpt2")).restore(resumed)
    assert at == 2 and resumed.step == 2
    for b in batches[2:]:
        resumed, _ = step2(resumed, *b)
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_forward_cli_hartmann_fp_matches_jax(mock_scene_dir, tmp_path):
    """The JAX CLI's route: --cnn_factory hartmann_cnn hands the pass a
    FeatureExtractor; both CLIs read one weight file."""
    weights = tmp_path / "hartmann_cnn.msgpack"
    JaxFeatureExtractor("hartmann_cnn", seed=0).save_weights(str(weights))
    common = [
        str(mock_scene_dir.parent), "--scene_idx", "0",
        "--forward_pass_factory", "hartmann_fp", "--cnn_factory",
        "hartmann_cnn", "--patch_shape", "32,32,3", "--depth_planes", "2",
        "--start_end", "1,2", "--rays_batch", "1728",
        "--weight_file", str(weights),
    ]
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_forward_cli.main([common[0], str(jax_out)] + common[1:])
    forward_cli.main([common[0], str(port_out)] + common[1:]
                     + ["--device", "cpu"])
    a, b = (np.load(d / "depth_001.npy") for d in (port_out, jax_out))
    assert a.shape == b.shape == (H, W) and a.dtype == np.float32
    assert np.array_equal(a > 0, b > 0)
    assert np.mean(np.abs(a - b) <= 1e-3 * np.abs(b)) >= 0.999
