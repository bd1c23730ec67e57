"""The port's raynet pass against the JAX package's on a scene with
occlusion, on the CPU.

The mock scene of ``conftest.py`` and the ring rig of
``common/ring_scene.py`` show per-frame random noise that no geometry
explains, so on them belief propagation cannot do better than the plane
sweep. Here the images are rendered from geometry: two textured quads at
different depths, the nearer one hiding part of the farther one from the
reference views. Each pixel casts its ray, takes the nearer quad's hit and
shows that quad's seeded texture at the hit (nearest texel, fixed in the
quad's own coordinates), or a flat background where the ray misses both.

Both packages run the same CNN weights (the JAX extractor's, converted) on
the CPU, the JAX package through its XLA path with float32 messages.
Bars: >= 0.999 of the pixels within 1e-3 relative depth of the JAX
package's, with identical zero/nonzero masks; and the port's raynet depths
differ (by more than 1e-3 relative) from its ``multi_view_cnn`` depths and
from its ``multi_view_cnn_voxel_space`` depths on at least
``MIN_BP_SHARE`` of the nonzero pixels. The voxel-space case is the one
that guards against a belief propagation that collapsed to the plane
sweep: raynet and the voxel-space pass both give the distance to a voxel
centre, so only belief propagation sets them apart. ``multi_view_cnn``
gives the distance to a plane sample, which differs from any voxel
centre's on almost every pixel whatever belief propagation does.
"""
import numpy as np
import pytest
import torch

from raynet_tpu.common.generation_parameters import (
    GenerationParameters as JaxGenerationParameters,
)
from raynet_tpu.common.sampling_schemes import get_sampling_scheme
from raynet_tpu.common.scene import RestrepoScene as JaxRestrepoScene
from raynet_tpu.inference import get_forward_pass_factory as jax_factory
from raynet_tpu.models.feature_extractor import (
    FeatureExtractor as JaxFeatureExtractor,
)
from raynet_tpu_torch.common.generation_parameters import GenerationParameters
from raynet_tpu_torch.common.scene import RestrepoScene
from raynet_tpu_torch.inference import get_forward_pass_factory
from raynet_tpu_torch.models.convert import state_dict_from_flax
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from conftest import _make_ring_camera

torch.set_num_threads(2)

H, W = 36, 48
N_FRAMES = 6
ANGLE_STEP = 0.1  # radians between neighbouring cameras on the ring
D, GRID, M, PAD = 16, (24, 24, 24), 48, 11
VIEWS = (0, 2, 1)
TEXEL = 0.1  # world units per texel (about 2 pixels at the quads' depth)
BACKGROUND = 128
# (z, (x0, x1), (y0, y1), texture seed): planes z = const, facing the
# cameras (which look along +z); the near quad covers the lower left of
# the far one in every view
QUADS = (
    (1.0, (-0.9, 2.0), (-0.5, 2.0), 11),
    (-1.5, (-2.0, 0.15), (-2.0, 0.25), 12),
)
# on this scene 1.0 of the pixels differ from multi_view_cnn's depths (a
# plane's depth, not a voxel's: that share holds even with no belief
# propagation) and 0.97 from the voxel-space pass's (a collapsed belief
# propagation gives 0)
MIN_BP_SHARE = 0.5


def _texture(seed, quad):
    _, (x0, x1), (y0, y1), _ = quad
    shape = (int(np.ceil((y1 - y0) / TEXEL)), int(np.ceil((x1 - x0) / TEXEL)))
    return np.random.RandomState(seed).randint(0, 256, size=shape + (3,),
                                               dtype=np.uint8)


def render(K, R, t):
    """(H, W, 3) uint8 image of ``QUADS`` seen by the camera (K, R, t):
    for each pixel (x, y), the ray c + s R^T K^-1 (x, y, 1), s > 0, and the
    texel of the nearest quad it hits; ``BACKGROUND`` where it hits none.
    Also returns the (H, W) distance from the camera centre to the hit
    (0 on the background)."""
    K, R, t = (np.asarray(a, np.float64) for a in (K, R, t))
    c = -R.T @ t.reshape(3)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([x, y, np.ones_like(x)], axis=-1)
    d = pix @ np.linalg.inv(K).T @ R  # rows: R^T K^-1 (x, y, 1)
    image = np.full((H, W, 3), BACKGROUND, np.uint8)
    best = np.full((H, W), np.inf)
    for quad in QUADS:
        z, (x0, x1), (y0, y1), seed = quad
        s = (z - c[2]) / d[..., 2]
        p = c + s[..., None] * d
        hit = ((s > 0) & (s < best) & (p[..., 0] >= x0) & (p[..., 0] < x1)
               & (p[..., 1] >= y0) & (p[..., 1] < y1))
        tex = _texture(seed, quad)
        row = np.clip(((p[..., 1] - y0) / TEXEL).astype(int), 0,
                      tex.shape[0] - 1)
        col = np.clip(((p[..., 0] - x0) / TEXEL).astype(int), 0,
                      tex.shape[1] - 1)
        image[hit] = tex[row[hit], col[hit]]
        best[hit] = s[hit]
    dist = np.where(np.isfinite(best),
                    best * np.linalg.norm(d, axis=-1), 0.0)
    return image, dist


def _gt_mesh():
    lines, faces = [], []
    for q, (z, (x0, x1), (y0, y1), _) in enumerate(QUADS):
        for x, y in ((x0, y0), (x1, y0), (x1, y1), (x0, y1)):
            lines.append("v %r %r %r" % (x, y, z))
        b = 4 * q
        faces += ["f %d %d %d" % (b + 1, b + 2, b + 3),
                  "f %d %d %d" % (b + 1, b + 3, b + 4)]
    return "\n".join(lines + faces) + "\n"


@pytest.fixture(scope="module")
def occluding_scene(tmp_path_factory):
    """A Restrepo-format scene of ``QUADS`` seen from ``N_FRAMES`` ring
    cameras; returns the dataset's scene directory and each frame's true
    distance map."""
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("occlusion") / "scene_1"
    (root / "imgs").mkdir(parents=True)
    (root / "cams_krt").mkdir()
    dists = []
    for i in range(N_FRAMES):
        K, R, t = _make_ring_camera((i - N_FRAMES / 2) * ANGLE_STEP, H, W)
        image, dist = render(K, R, t)
        dists.append(dist)
        imageio.imwrite(root / "imgs" / ("frame%05d.png" % (i + 1,)), image)
        rows = ([" ".join("%.9g" % v for v in row) for row in K]
                + [" ".join("%.9g" % v for v in row) for row in R]
                + [" ".join("%.9g" % v for v in t.ravel())])
        (root / "cams_krt" / ("frame%05d_cam.txt" % (i + 1,))).write_text(
            "\n".join(rows) + "\n")
    (root / "scene_info.xml").write_text(
        '<?xml version="1.0"?>\n<info>\n'
        '  <bbox minx="-3" miny="-3" minz="-3" maxx="3" maxy="3" maxz="3"/>\n'
        '  <resolution val="0.01"/>\n</info>\n')
    (root / "gt_mesh.obj").write_text(_gt_mesh())
    return root, np.stack(dists)


def _gp(cls):
    return cls(
        depth_planes=D, neighbors=4, patch_shape=(11, 11, 3),
        grid_shape=np.array(GRID, dtype=np.int32),
        max_number_of_marched_voxels=M, padding=PAD,
        sampling_type="sample_points_in_bbox", gamma_mrf=0.05,
    )


@pytest.fixture(scope="module")
def depth_maps(occluding_scene):
    """The JAX package's raynet depth maps and the port's raynet,
    multi_view_cnn and multi_view_cnn_voxel_space maps of ``VIEWS``."""
    root, _ = occluding_scene
    jfe = JaxFeatureExtractor("simple_cnn", seed=0)
    tfe = FeatureExtractor("simple_cnn",
                           state_dict=state_dict_from_flax(jfe.variables),
                           device="cpu")
    jgp = _gp(JaxGenerationParameters)
    jscene = JaxRestrepoScene(str(root))
    jfp = jax_factory("raynet")(
        jfe, jgp, get_sampling_scheme("sample_in_bbox")(jgp),
        jscene.image_shape, H * W)
    maps = {"jax": np.stack(list(jfp.forward_pass(jscene, VIEWS)))}
    scene = RestrepoScene(str(root))
    for name in ("raynet", "multi_view_cnn", "multi_view_cnn_voxel_space"):
        fp = get_forward_pass_factory(name)(
            tfe, _gp(GenerationParameters), None, scene.image_shape, 700,
            device="cpu")
        maps[name] = np.stack(list(fp.forward_pass(scene, VIEWS)))
    return maps


def _differ(a, b):
    return np.abs(a - b) > 1e-3 * np.abs(b)


def test_rendered_views_show_the_occlusion(occluding_scene):
    """The near quad hides part of the far one in every reference view:
    each has pixels on both quads and on the background."""
    _, dists = occluding_scene
    for dist in dists[VIEWS[0]:VIEWS[1]]:
        near = (dist > 0) & (dist < 19.5)
        far = dist > 20.5
        assert near.mean() > 0.15 and far.mean() > 0.15
        assert (dist == 0).mean() > 0.02


def test_raynet_matches_jax_on_an_occluding_scene(depth_maps):
    port, ref = depth_maps["raynet"], depth_maps["jax"]
    assert port.shape == ref.shape == (VIEWS[1] - VIEWS[0], H, W)
    assert np.isfinite(port).all()
    assert np.array_equal(port > 0, ref > 0)
    agree = np.mean(np.abs(port - ref) <= 1e-3 * np.abs(ref))
    assert agree >= 0.999, agree
    nz = port[port > 0]
    assert nz.size > 0.5 * port.size
    assert nz.min() >= 10.0 and nz.max() <= 30.0


@pytest.mark.parametrize("other", ["multi_view_cnn",
                                   "multi_view_cnn_voxel_space"])
def test_belief_propagation_moves_depths(depth_maps, other):
    raynet, plain = depth_maps["raynet"], depth_maps[other]
    both = (raynet > 0) & (plain > 0)
    share = _differ(raynet[both], plain[both]).mean()
    assert share >= MIN_BP_SHARE, share
