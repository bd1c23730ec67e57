"""The port's ``multi_view_cnn`` and ``multi_view_cnn_voxel_space`` passes
against the JAX package's, on the CPU: the fused steps on one batch, both
factories end to end on the mock scene (flags of the verify skill: D=8,
grid 12^3, M=24), and the CLI.

Tolerances: scores S and S_vox rtol=1e-5, atol=1e-6 (the bar of
``test_torch_planesweep.py``; the plain versions sum in another order);
voxel indices and counts exact; depths >= 0.999 of the rays within 1e-3
relative, with identical zero masks. For the voxel-space pass a ray also
agrees when the port's depth is that of a voxel the reference scores as
tied with its maximum (within the scores' tolerance). At this resolution
adjacent depth planes often project to the same feature cells and score
exactly the same, so the voxels between them tie in exact arithmetic: the
port takes the first of them, the JAX package whichever its rounding puts
ahead, and two compilations of the JAX mapping (alone, and inside the
fused step) already choose differently on some of those rays.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raynet_tpu.common.generation_parameters import (
    GenerationParameters as JaxGenerationParameters,
)
from raynet_tpu.common.sampling_schemes import get_sampling_scheme
from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
from raynet_tpu.inference import get_forward_pass_factory as jax_factory
from raynet_tpu.models.feature_extractor import (
    FeatureExtractor as JaxFeatureExtractor,
)
from raynet_tpu.ops import fused as jfused
from raynet_tpu.scripts import forward_pass as jax_cli
from raynet_tpu_torch.common.generation_parameters import GenerationParameters
from raynet_tpu_torch.common.scene import RestrepoScene
from raynet_tpu_torch.inference import get_forward_pass_factory
from raynet_tpu_torch.models.convert import state_dict_from_flax
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.ops import fused as tfused
from raynet_tpu_torch.ops import planesweep, ray_marching
from raynet_tpu_torch.scripts import forward_pass as port_cli
from conftest import MOCK_H as H, MOCK_W as W

torch.set_num_threads(2)

PAD, D, GRID, M = 11, 8, (12, 12, 12), 24
FACTORIES = ["multi_view_cnn", "multi_view_cnn_voxel_space"]
FLAGS = [
    "--depth_planes", "8", "--grid_shape", "12,12,12",
    "--maximum_number_of_marched_voxels", "24", "--patch_shape", "11,11,3",
]


def _agree(a, b):
    """Share of depths within 1e-3 relative; the zero masks must match."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a > 0, b > 0)
    return float(np.mean(np.abs(a - b) <= 1e-3 * np.abs(b)))


def _voxel_agree(port_depth, jax_depth, jS, jvox, jcounts, center, bbox):
    """Share of rays whose port depth is within 1e-3 relative of the
    reference depth or of the depth of a visited voxel whose reference
    score is within rtol 1e-5, atol 1e-6 of the ray's maximum. The zero
    masks must match."""
    port_depth, jax_depth = np.asarray(port_depth), np.asarray(jax_depth)
    assert np.array_equal(port_depth > 0, jax_depth > 0)
    jS, jvox = np.asarray(jS, np.float64), np.asarray(jvox)
    valid = np.arange(jS.shape[1])[None, :] < np.asarray(jcounts)[:, None]
    best = np.where(valid, jS, -np.inf).max(axis=1, keepdims=True)
    tied = valid & (jS >= best - (1e-5 * best + 1e-6))
    bbox = np.asarray(bbox, np.float64).reshape(6)
    bin_ = (bbox[3:] - bbox[:3]) / np.asarray(GRID)
    centers = bbox[:3] + (jvox + 0.5) * bin_
    dists = np.linalg.norm(centers - np.asarray(center)[None, None], axis=-1)
    tol = 1e-3 * np.abs(jax_depth)
    same = np.abs(port_depth - jax_depth) <= tol
    at_tie = (tied & (np.abs(dists - port_depth[:, None])
                      <= 1e-3 * dists)).any(axis=1)
    return float(np.mean(same | at_tie))


def _map_agree(factory, jfe, jscene, ref_idx, port_map, jax_map):
    """Agreement of one view's depth maps: ``_agree`` for multi_view_cnn;
    ``_voxel_agree`` for the voxel-space pass, on the scores of the JAX
    fused step over all the view's rays with the JAX pass's features."""
    if factory == "multi_view_cnn":
        return _agree(port_map, jax_map)
    jfp = jax_factory(factory)(
        jfe, _gp(JaxGenerationParameters), None, jscene.image_shape, H * W
    )
    feats, P, P_pinv, center = jfp._features_and_cameras(jscene, ref_idx)
    bbox = jnp.asarray(jscene.bbox.reshape(-1), jnp.float32)
    jS, jvox, jc, _ = jfused.mvcnn_voxel_depth_step(
        jnp.arange(H * W, dtype=jnp.int32), feats, P, P_pinv, center, bbox,
        H, W, PAD, D, GRID, M,
    )

    def rays(depth_map):  # (H, W) map -> depths in column-major ray order
        return np.asarray(depth_map).T.reshape(-1)

    return _voxel_agree(rays(port_map), rays(jax_map), jS, jvox, jc,
                        np.asarray(center), np.asarray(bbox))


def _gp(cls):
    return cls(
        depth_planes=D, neighbors=4, patch_shape=(11, 11, 3),
        grid_shape=np.array(GRID, dtype=np.int32),
        max_number_of_marched_voxels=M, padding=PAD,
        sampling_type="sample_points_in_bbox", gamma_mrf=0.05,
    )


@pytest.fixture(scope="module")
def setup(mock_scene_dir):
    jfe = JaxFeatureExtractor("simple_cnn", seed=0)
    tfe = FeatureExtractor(
        "simple_cnn", state_dict=state_dict_from_flax(jfe.variables),
        device="cpu",
    )
    return jfe, tfe


@pytest.fixture(scope="module")
def batch(mock_scene_dir):
    """One view set of the mock scene with seeded random features."""
    scene = JaxRestrepoScene(str(mock_scene_dir))
    cams = [scene.get_image(j).camera for j in scene.get_view_idxs(2, 4)]
    rng = np.random.RandomState(5)
    return dict(
        idxs=np.arange(H * W, dtype=np.int32),
        feats=rng.randn(5, H + PAD + 1, W + PAD + 1, 32).astype(np.float32),
        P=np.stack([c.P for c in cams]).astype(np.float32),
        P_pinv=np.asarray(cams[0].P_pinv, np.float32),
        center=np.asarray(cams[0].center[:3, 0], np.float32),
        bbox=scene.bbox.reshape(-1).astype(np.float32),
    )


def _args(b, to):
    return [to(b[k]) for k in ("idxs", "feats", "P", "P_pinv", "center",
                               "bbox")]


def test_mvcnn_depth_step_matches_jax(batch):
    jS, jd = jfused.mvcnn_depth_step(*_args(batch, jnp.asarray), H, W, PAD, D)
    planesweep.plane_sweep_scores.launches = 0
    tS, td = tfused.mvcnn_depth_step(*_args(batch, torch.as_tensor), H, W,
                                     PAD, D)
    assert planesweep.plane_sweep_scores.launches == 0
    assert tS.shape == (H * W, D) and td.shape == (H * W,)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=1e-5,
                               atol=1e-6)
    assert _agree(td.numpy(), np.asarray(jd)) >= 0.999
    assert 10.0 <= float(td.min()) and float(td.max()) <= 30.0


def test_mvcnn_voxel_depth_step_matches_jax(batch):
    jS, jvox, jc, jd = jfused.mvcnn_voxel_depth_step(
        *_args(batch, jnp.asarray), H, W, PAD, D, GRID, M,
    )
    ray_marching.voxel_traversal_flat.launches = 0
    tS, tvox, tc, td = tfused.mvcnn_voxel_depth_step(
        *_args(batch, torch.as_tensor), H, W, PAD, D, GRID, M,
    )
    assert ray_marching.voxel_traversal_flat.launches == 0
    assert tS.shape == (H * W, M) and tvox.shape == (H * W, M, 3)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tvox.numpy(), np.asarray(jvox))
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=1e-5,
                               atol=1e-6)
    assert _voxel_agree(td.numpy(), jd, jS, jvox, jc, batch["center"],
                        batch["bbox"]) >= 0.999
    assert _agree(td.numpy(), np.asarray(jd)) >= 0.95
    assert int(tc.max()) > 1
    nz = td[td > 0]
    assert 10.0 <= float(nz.min()) and float(nz.max()) <= 30.0


@pytest.mark.parametrize("rays_batch", [H * W, 700])
@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_jax(mock_scene_dir, setup, factory, rays_batch):
    jfe, tfe = setup
    jscene = JaxRestrepoScene(str(mock_scene_dir))
    jgp = _gp(JaxGenerationParameters)
    jfp = jax_factory(factory)(
        jfe, jgp, get_sampling_scheme("sample_in_bbox")(jgp),
        jscene.image_shape, rays_batch,
    )
    jmaps = list(jfp.forward_pass(jscene, (0, 3, 1)))
    scene = RestrepoScene(str(mock_scene_dir))
    planesweep.plane_sweep_scores.launches = 0
    ray_marching.voxel_traversal_flat.launches = 0
    tfp = get_forward_pass_factory(factory)(
        tfe, _gp(GenerationParameters), None, scene.image_shape, rays_batch,
        device="cpu",
    )
    tmaps = list(tfp.forward_pass(scene, (0, 3, 1)))
    assert planesweep.plane_sweep_scores.launches == 0
    assert ray_marching.voxel_traversal_flat.launches == 0
    assert len(tmaps) == len(jmaps) == 3
    for i, (t, j) in enumerate(zip(tmaps, jmaps)):
        assert t.shape == (H, W) and t.dtype == np.float32
        assert np.isfinite(t).all()
        assert _map_agree(factory, jfe, jscene, i, t, j) >= 0.999
        nz = t[t > 0]
        assert nz.size > 0.5 * t.size
        assert nz.min() >= 10.0 and nz.max() <= 30.0
    assert set(tfp.timer.totals) == {
        "Features computation", "Per-pixel depth estimation",
    }


@pytest.mark.parametrize("factory", FACTORIES)
def test_cli_matches_jax_cli(mock_scene_dir, setup, tmp_path, factory):
    jfe, _ = setup  # the weights the CLIs load: seed 0, as here
    weights = tmp_path / "cnn.msgpack"
    jfe.save_weights(str(weights))
    common = [
        str(mock_scene_dir.parent), "--scene_idx", "0",
        "--forward_pass_factory", factory, "--rays_batch", "700",
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
        jscene = JaxRestrepoScene(str(mock_scene_dir))
        assert _map_agree(factory, jfe, jscene, i, a, b) >= 0.999
