"""The port's training-quality bench (``raynet_tpu_torch.tools.
bench_training_quality``) on the CPU at reduced sizes, against the JAX
package's tool (``tools/bench_training_quality.py``) where both make the
same thing.

- ``make_textured_scene``: the PNGs decode to the JAX tool's pixels
  exactly; the camera files, ``scene_info.xml`` and ``gt_mesh.obj`` are
  byte-equal.
- ``pretrain_quality`` (20 steps, 64 training and 32 validation samples)
  and ``e2e_quality`` (3 iterations): every metric finite, gamma moved by
  more than 1e-4 (bench.py's rule).
- The end-to-end step lowers the loss (``chip_smoke.fixed_batch_losses``,
  phase 15b's check): on one fixed 8-ray batch of the same pipeline, the
  mean loss of the last 3 of 12 steps is below that of the first 3.
  bench.py's ratio itself compares fresh 8-ray batches, and there
  batch-to-batch noise outweighs 12 steps of learning, in the JAX tool as
  in the port (on a CPU, seeds 0 / 1 / 2: JAX 0.777 / 1.141 / 1.034, port
  1.053 / 0.891 / 0.965).
- ``main(["--device", "cpu", ...])`` prints bench.py's four metrics.
"""
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from raynet_tpu_torch.tools import bench_training_quality as bench

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_from_repo_root(name):
    sys.path.insert(0, REPO_ROOT)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(REPO_ROOT)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_textured_scene_is_the_jax_tool_s(tmp_path):
    pytest.importorskip("imageio")
    jax_make_textured_scene = _import_from_repo_root(
        "tools.bench_training_quality").make_textured_scene
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    bench.make_textured_scene(port)
    jax_make_textured_scene(ref)
    names = _files(port)
    assert names == _files(ref) and len(names) == 6 * 2 + 2
    for name in names:
        a, b = os.path.join(port, name), os.path.join(ref, name)
        if name.endswith(".png"):
            pa, pb = np.asarray(Image.open(a)), np.asarray(Image.open(b))
            assert pa.shape == (48, 64, 3) and pa.dtype == np.uint8
            assert np.array_equal(pa, pb), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_pretrain_quality_is_finite():
    q = bench.pretrain_quality(steps=20, n_train=64, n_val=32, device="cpu")
    assert set(q) == {"val_acc", "val_mde", "val_loss", "train_loss_first",
                      "train_loss_last"}
    assert all(np.isfinite(v) for v in q.values())
    assert 0.0 <= q["val_acc"] <= 1.0 and 0.0 <= q["val_mde"] <= 7.0


def test_e2e_quality_is_finite_and_moves_gamma():
    e = bench.e2e_quality(iterations=3, device="cpu")
    assert set(e) == {"loss_first", "loss_last", "gamma_delta"}
    assert all(np.isfinite(v) for v in e.values())
    assert e["gamma_delta"] > 1e-4


def test_e2e_step_lowers_the_loss_on_a_fixed_batch():
    # chip_smoke.py phase 15b's check, on the CPU
    losses = _import_from_repo_root("chip_smoke").fixed_batch_losses(
        torch.device("cpu"))
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_main_prints_the_four_metrics(capsys):
    assert bench.main(["--device", "cpu", "--steps", "2", "--n_train", "32",
                       "--n_val", "32", "--iterations", "3"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [l["metric"] for l in lines] == [
        "pretrain_val_acc", "pretrain_val_mde", "e2e_train_loss_ratio",
        "e2e_gamma_moved"]
    assert all(np.isfinite(l["value"]) and l["seconds"] > 0 for l in lines)
