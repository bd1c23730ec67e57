"""The port's raynet forward pass and CLI against the JAX package's, end to
end on the mock scene with the verify-skill flags (D=8, grid 12^3, M=24),
plus the port's guards: no JAX import, no CUDA request carried on without a
card, and the kernels' build from the repository's sources.

Both packages run the same CNN weights (the JAX extractor's flax variables,
converted). Agreement bar: >= 0.999 of the pixels within 1e-3 relative
depth, and identical zero/nonzero masks.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raynet_tpu.common.generation_parameters import GenerationParameters
from raynet_tpu.common.sampling_schemes import get_sampling_scheme
from raynet_tpu.common.scene import RestrepoScene
from raynet_tpu.inference import get_forward_pass_factory as jax_factory
from raynet_tpu.models.feature_extractor import (
    FeatureExtractor as JaxFeatureExtractor,
)
from raynet_tpu.scripts import forward_pass as jax_cli
from raynet_tpu_torch.inference import RayNetForwardPass, get_forward_pass_factory
from raynet_tpu_torch.models.convert import state_dict_from_flax
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.ops import bp_sweep, cuda_build, planesweep
from raynet_tpu_torch.scripts import forward_pass as port_cli
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = [
    "--depth_planes", "8", "--grid_shape", "12,12,12",
    "--maximum_number_of_marched_voxels", "24", "--patch_shape", "11,11,3",
]


def _agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a > 0, b > 0)
    return float(np.mean(np.abs(a - b) <= 1e-3 * np.abs(b)))


@pytest.fixture(scope="module")
def setup(mock_scene_dir):
    scene = RestrepoScene(str(mock_scene_dir))
    gp = GenerationParameters(
        depth_planes=8, neighbors=4, patch_shape=(11, 11, 3),
        grid_shape=np.array([12, 12, 12], dtype=np.int32),
        max_number_of_marched_voxels=24, padding=11,
        sampling_type="sample_points_in_bbox", gamma_mrf=0.05,
    )
    jfe = JaxFeatureExtractor("simple_cnn", seed=0)
    tfe = FeatureExtractor(
        "simple_cnn", state_dict=state_dict_from_flax(jfe.variables),
        device="cpu",
    )
    return scene, gp, jfe, tfe


@pytest.mark.parametrize("rays_batch", [H * W, 700])
def test_raynet_matches_jax(setup, rays_batch):
    scene, gp, jfe, tfe = setup
    jfp = jax_factory("raynet")(
        jfe, gp, get_sampling_scheme("sample_in_bbox")(gp), scene.image_shape,
        rays_batch,
    )
    jmaps = list(jfp.forward_pass(scene, (0, 3, 1)))
    planesweep.plane_sweep_scores.launches = 0
    bp_sweep.bp_sweep.launches = 0
    tfp = RayNetForwardPass(tfe, gp, None, scene.image_shape, rays_batch,
                            device="cpu")
    tmaps = list(tfp.forward_pass(scene, (0, 3, 1)))
    assert planesweep.plane_sweep_scores.launches == 0
    assert bp_sweep.bp_sweep.launches == 0
    assert len(tmaps) == 3
    for t, j in zip(tmaps, jmaps):
        assert t.shape == (H, W) and t.dtype == np.float32
        assert np.isfinite(t).all()
        assert _agree(t, j) >= 0.999
        nz = t[t > 0]
        assert nz.size > 0.5 * t.size
        assert nz.min() >= 10.0 and nz.max() <= 30.0
    assert set(tfp.timer.totals) == {
        "Features computation", "Plane sweep", "Message passing",
        "Per-pixel depth estimation",
    }


def test_odd_batches_match_whole_image(setup):
    """The padded tail batch scatters nothing: 700-ray batches give the
    whole-image result."""
    scene, gp, _, tfe = setup
    maps = {}
    for b in (H * W, 700):
        fp = RayNetForwardPass(tfe, gp, None, scene.image_shape, b,
                               device="cpu")
        maps[b] = np.stack(list(fp.forward_pass(scene, (0, 2, 1))))
    np.testing.assert_allclose(maps[700], maps[H * W], rtol=1e-5, atol=1e-5)


def test_cli_matches_jax_cli(mock_scene_dir, tmp_path):
    weights = tmp_path / "cnn.msgpack"
    JaxFeatureExtractor("simple_cnn", seed=0).save_weights(str(weights))
    common = [
        str(mock_scene_dir.parent), "--scene_idx", "0",
        "--forward_pass_factory", "raynet", "--rays_batch", "700",
        "--start_end", "0,2", "--weight_file", str(weights),
    ] + FLAGS
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_cli.main([common[0], str(jax_out)] + common[1:])
    port_cli.main([common[0], str(port_out)] + common[1:]
                  + ["--device", "cpu"])
    for i in range(2):
        name = "depth_%03d.npy" % (i,)
        a, b = np.load(port_out / name), np.load(jax_out / name)
        assert a.shape == (H, W) and a.dtype == np.float32
        assert _agree(a, b) >= 0.999


def test_cli_rejects_factories_not_ported(mock_scene_dir, tmp_path):
    # every factory of the JAX package is ported; a name that is none of
    # them is refused by the CLI and by the factory
    with pytest.raises(SystemExit):
        port_cli.main([
            str(mock_scene_dir.parent), str(tmp_path), "--scene_idx", "0",
            "--forward_pass_factory", "no_such_pass", "--device", "cpu",
        ] + FLAGS)
    with pytest.raises(KeyError):
        get_forward_pass_factory("no_such_pass")
    for name in ("raynet", "multi_view_cnn", "multi_view_cnn_voxel_space",
                 "hartmann_fp"):
        assert get_forward_pass_factory(name).__module__ == (
            "raynet_tpu_torch.inference.forward_pass")


def test_message_store_over_budget_raises(setup):
    scene, gp, _, tfe = setup
    fp = RayNetForwardPass(tfe, gp, None, scene.image_shape, 700,
                           device="cpu")
    fp.messages_device_budget = 1000
    with pytest.raises(RuntimeError, match="messages_device_budget"):
        next(fp.forward_pass(scene, (0, 2, 1)))


def test_cuda_request_raises_without_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene, gp, _, tfe = setup
    with pytest.raises(RuntimeError, match="is_available"):
        RayNetForwardPass(tfe, gp, None, scene.image_shape, 700,
                          device="cuda")


def test_package_imports_without_jax(mock_scene_dir, tmp_path):
    """Every module of the port imports with jax, flax, optax and the JAX
    package raynet_tpu blocked, and the CLI then reads the mock scene and
    writes its depth maps (a subprocess: this test process has imported
    them already)."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "raynet_tpu"):
    sys.modules[name] = None
import raynet_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    raynet_tpu_torch.__path__, "raynet_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from raynet_tpu_torch.scripts import forward_pass
forward_pass.main(sys.argv[1:])
print(len(mods))
"""
    argv = [
        str(mock_scene_dir.parent), str(tmp_path), "--scene_idx", "0",
        "--forward_pass_factory", "multi_view_cnn_voxel_space",
        "--start_end", "0,1", "--rays_batch", "700", "--device", "cpu",
    ] + FLAGS
    out = subprocess.run(
        [sys.executable, "-c", code] + argv, cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30
    assert np.load(tmp_path / "depth_000.npy").shape == (H, W)


def test_kernel_sources_and_build_command():
    names = {p.name for p in cuda_build.sources()}
    assert {"planesweep.cu", "bp_sweep.cu", "traversal.cu", "march.cuh",
            "hat.cuh", "probe_tma_box.cu", "probe_tf32_dot.cu"} <= names
    assert {"raynet_voxel_traversal", "raynet_voxel_argmax_depth",
            "raynet_probe_tma_box",
            "raynet_probe_tf32_dot"} <= set(cuda_build.SIGNATURES)
    compiles, link = cuda_build.build_commands("/x/lib.so", nvcc="nvcc")
    # one nvcc per .cu source, then one link of their objects
    cus = [c[-1] for c in compiles]
    assert sorted(os.path.basename(c) for c in cus) == sorted(
        n for n in names if n.endswith(".cu"))
    assert all(c.startswith(str(cuda_build.CSRC)) for c in cus)
    objects = [c[c.index("-o") + 1] for c in compiles]
    assert link[-len(objects):] == objects and "-shared" in link
    assert all(o.startswith("/x/") for o in objects)
    for cmd in compiles + [link]:
        joined = " ".join(cmd[1:])
        assert "arch=compute_90a,code=sm_90a" in joined
        assert "--use_fast_math" not in joined and "-fmad=false" in joined
    assert cuda_build.BUILD_ROOT.relative_to(cuda_build.CSRC)
    ignored = open(os.path.join(REPO_ROOT, ".gitignore")).read().split()
    assert "raynet_tpu_torch/csrc/build/" in ignored
    # the source hash keys the build: it changes with the sources
    assert len(cuda_build.source_hash()) == 16
