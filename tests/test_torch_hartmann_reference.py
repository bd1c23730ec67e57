"""The ``hartmann_fp`` pass against the benchmark's plain reference of it
(``bench_torch/reference/hartmann_fp.py``) on the CPU, at the published
widths (32x32x3 patches, 5 views, 32 / 64 / 2048 / 2048 / 2) on a few
quintuples: a 16x12 ring framed so that every ray crosses the bbox, D = 4,
seeded weights; the pass on a scene that offers only what a ring scene
offers; the camera-built rays; the pass's spans and counters.

Tolerances: scores within 1e-6 absolute. They are softmax probabilities
of float32 convolutions summed over up to 2048 x 25 terms, which the pass
and the reference group in batches of other sizes; here they agree bit
for bit, and the bar leaves room for a convolution that blocks its sums
by the batch (a few float32 units of 0.5, ~1e-7), while the scores move
over the planes by ~2e-2. Depth maps: equal, or the pass's plane ties the
reference's best score within that tolerance.
"""
import numpy as np
import pytest
import torch

from bench_torch.drivers.patch_pass import net_weights
from bench_torch.reference import hartmann_fp as reference
from raynet_tpu_torch.common.generation_parameters import GenerationParameters
from raynet_tpu_torch.common.image import camera_rays
from raynet_tpu_torch.common.ring_scene import RingScene
from raynet_tpu_torch.common.sampling_schemes import get_sampling_scheme
from raynet_tpu_torch.common.scene import RestrepoScene, Scene
from raynet_tpu_torch.inference import HartmannForwardPass
from raynet_tpu_torch.models.feature_extractor import HartmannModel
from raynet_tpu_torch.utils import profiling

torch.set_num_threads(2)
D, PATCH = 4, (32, 32, 3)
SCORE_ATOL = 1e-6
CONFIG = {"depth_planes": D, "neighbors": 4, "patch_shape": list(PATCH),
          "net": {"branch": [[32, 5], [64, 5]], "pool": 2,
                  "head": [[2048, 5], [2048, 1], [2, 1]]}}
PASS = "pass"


def _ring(seed=3):
    # 16x12 views of the benchmark's framed ring (bbox +-6.5): every ray
    # crosses the bbox, so every pixel has D points to score
    return RingScene(8, 12, 16, 27.5, angle_step=0.04, bbox_half=6.5,
                     seed=seed)


def _params():
    return GenerationParameters(depth_planes=D, neighbors=4,
                                patch_shape=PATCH, padding=PATCH[0],
                                sampling_type="sample_in_bbox")


def _pass(model, rays_batch=256):
    gp = _params()
    return HartmannForwardPass(model, gp,
                               get_sampling_scheme("sample_in_bbox")(gp),
                               None, rays_batch=rays_batch, device="cpu")


class MeanAbsDeviation:
    """A cheap stand-in scorer: (B, V, ph, pw, C) -> (B, 1, 1, 2), minus
    the mean absolute deviation across views in channel 0."""

    def predict(self, patches):
        p = torch.as_tensor(patches, dtype=torch.float64)
        dev = (p - p.mean(dim=1, keepdim=True)).abs().mean(dim=(1, 2, 3, 4))
        return torch.stack([-dev, dev], dim=-1).float().reshape(-1, 1, 1, 2)


@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_pass_matches_the_plain_reference(seed):
    scene = _ring(seed)
    weights = net_weights(CONFIG, seed, "cpu")
    fp = _pass(HartmannModel(state_dict=weights, patch_shape=PATCH,
                             device="cpu"))
    ref = 3
    (depth_map,) = list(fp.forward_pass(scene, (ref, ref + 1, 1)))
    H, W = scene.image_shape

    # the points: the scheme's are the reference's, bit for bit
    pts = reference.sample_points(scene, ref, D)  # (N, D, 3)
    scheme_pts = np.asarray(fp._sampling_scheme.sample_points_across_rays(
        scene, ref))[:3]
    np.testing.assert_array_equal(np.moveaxis(scheme_pts, 0, -1), pts)

    views = scene.get_view_idxs(ref, 4)
    P = torch.as_tensor(np.stack([scene.get_image(j).camera.P
                                  for j in views])).to(torch.float64)
    wins = reference.windows(scene, views, PATCH, "cpu")
    pts_t = torch.as_tensor(pts)
    want = torch.cat([
        reference.scores(reference.patches(
            wins, P, pts_t[lo:lo + 50].reshape(-1, 3), PATCH), weights)
        for lo in range(0, H * W, 50)]).reshape(H * W, D)
    images = [scene.get_image(j) for j in views]
    got = fp.image_scores(images, scheme_pts)
    assert got.shape == want.shape == (H * W, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=SCORE_ATOL)
    # the scores move over the planes far beyond the tolerance
    assert float((want.max(1).values - want.min(1).values).median()) > 1e-3

    dist = np.linalg.norm(pts - scene.get_image(ref).camera.center[:3, 0],
                          axis=-1)
    best = want.argmax(dim=1).numpy()
    ref_depth = dist[np.arange(H * W), best].reshape(W, H).T
    depth = depth_map.T.reshape(-1)
    # the pass's plane: the one at its depth
    plane = np.abs(dist - depth[:, None]).argmin(axis=1)
    assert np.allclose(dist[np.arange(H * W), plane], depth, rtol=1e-6)
    tied = want.numpy()[np.arange(H * W), plane] \
        >= want.max(1).values.numpy() - SCORE_ATOL
    assert bool(tied.all())
    assert np.mean(depth_map == ref_depth) >= 0.99

    judge = reference.run(scene, weights, CONFIG,
                          {"images_range": [ref, ref + 1, 1]}, [[depth_map]],
                          "cpu", block=256)
    (reading,) = judge.readings()
    assert reading["max_gap"] <= 1e-5 and reading["mismatch_share"] <= 0.01


class _BareScene:
    """What a ring scene offers the passes: ``n_images``, ``bbox``,
    ``image_shape``, ``get_view_idxs`` and ``get_image``, whose images
    carry ``camera``, ``image`` and ``image_u8`` only (no ``rays()``)."""

    def __init__(self, scene):
        self._scene = scene
        self.n_images, self.bbox = scene.n_images, scene.bbox
        self.image_shape = scene.image_shape

    def get_view_idxs(self, i, neighbors=4):
        return self._scene.get_view_idxs(i, neighbors)

    def get_image(self, i):
        im = self._scene.get_image(i)
        return type("BareImage", (), {"camera": im.camera, "image": im.image,
                                      "image_u8": im.image_u8})()


def test_pass_on_a_bare_scene_equals_the_neighbour_route(mock_scene_dir):
    scene = RestrepoScene(str(mock_scene_dir), device="cpu")
    bare = _BareScene(scene)
    assert not hasattr(bare, "get_image_with_neighbors")
    assert not hasattr(bare.get_image(0), "rays")
    maps = list(_pass(MeanAbsDeviation(), 500).forward_pass(bare, (0, 2, 1)))
    full = list(_pass(MeanAbsDeviation(), 500).forward_pass(scene, (0, 2, 1)))
    H, W = scene.image_shape
    fp = _pass(MeanAbsDeviation(), 500)
    for i, (a, b) in enumerate(zip(maps, full)):
        np.testing.assert_array_equal(a, b)
        # the depths the seed's route gives: the view set through
        # get_image_with_neighbors, the rays through Image.rays()
        images = scene.get_image_with_neighbors(i, 4)
        center, rays = images[0].rays()
        directions = rays.T - center
        pts = fp._sampling_scheme._rays_to_points(
            center, directions, scene.bbox.reshape(-1))[:3]
        best = fp.image_scores(images, pts).argmax(dim=1).numpy()
        want = np.linalg.norm(pts[:, np.arange(H * W), best].T
                              - center[:3, 0][None], axis=-1)
        np.testing.assert_array_equal(
            a, np.minimum(want.reshape(W, H).T, 800))
    # a ring scene, which has no get_image_with_neighbors, runs as well
    ring = _ring()
    assert not hasattr(ring, "get_image_with_neighbors")
    (m,) = list(_pass(MeanAbsDeviation()).forward_pass(ring, (2, 3, 1)))
    assert m.shape == ring.image_shape and bool(np.isfinite(m).all())
    assert np.array_equal(
        m, list(_pass(MeanAbsDeviation()).forward_pass(
            _BareScene(ring), (2, 3, 1)))[0])
    assert Scene.get_image_with_neighbors(ring, 2, 4) == [
        ring.get_image(j) for j in ring.get_view_idxs(2, 4)]


def test_camera_rays_equal_image_rays(mock_scene_dir):
    scene = RestrepoScene(str(mock_scene_dir), device="cpu")
    for i in range(scene.n_images):
        im = scene.get_image(i)
        center, rays = camera_rays(im.camera, *scene.image_shape)
        # the seed's Image.rays(), spelled out
        u = np.repeat(np.arange(im.width), im.height)
        v = np.tile(np.arange(im.height), im.width)
        hom = np.dot(im.camera.P_pinv,
                     np.stack([u, v, np.ones_like(u)]).astype(np.float64)).T
        want = hom / hom[:, -1:]
        got_center, got = im.rays()
        assert rays.dtype == got.dtype == np.float64
        np.testing.assert_array_equal(rays, want)
        np.testing.assert_array_equal(got, want)
        assert center is got_center is im.camera.center


def _ranges(events):
    return [(ev["ts"], ev["ts"] + ev["dur"], ev["name"]) for ev in events
            if ev.get("cat") == "user_annotation"]


def _parent(ranges, child):
    s, e, _ = child
    around = [r for r in ranges if r is not child and r[0] <= s and e <= r[1]]
    return max(around, key=lambda r: (r[0], r[0] - r[1]))[2]


# the phase or the pass each span nests in
PARENTS = {"patch.sample": {"Sampling"}, "patch.project": {"Projection"},
           "patch.pad": {"Projection"}, "patch.gather": {"Patch gather"},
           "patch.net": {"Patch net"},
           "depth.download": {"Per-pixel depth estimation"},
           "patch.depth": {PASS}}


def test_traced_pass_nests_each_span_and_counts_its_work(tmp_path):
    ring = _ring()
    H, W = ring.image_shape
    views = (1, 3, 1)
    fp = _pass(MeanAbsDeviation(), rays_batch=100)
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function(PASS):
            maps = list(fp.forward_pass(ring, views))
    ranges = _ranges(profiling.read_trace(
        str(tmp_path / profiling.TRACE_NAME)))
    names = [name for _, _, name in ranges]
    assert set(names) == set(PARENTS) | set(fp.timer.counts) | {PASS}
    for r in ranges:
        if r[2] in PARENTS:
            assert _parent(ranges, r) in PARENTS[r[2]], r
    n_views = len(range(*views))
    assert len(maps) == n_views
    chunks = n_views * -(-H * W * D // 100)
    assert fp.quintuples == n_views * H * W * D
    assert fp.predict_calls == chunks and fp.quintuples_per_call == 100
    for span, phase in (("patch.gather", "Patch gather"),
                        ("patch.net", "Patch net")):
        assert names.count(span) == names.count(phase) == chunks
        assert fp.timer.counts[phase] == chunks
    for span in ("patch.sample", "patch.project", "patch.pad",
                 "depth.download", "patch.depth"):
        assert names.count(span) == n_views
    for phase in fp.timer.counts:
        assert names.count(phase) == fp.timer.counts[phase]


def test_untraced_pass_opens_no_range_and_never_syncs(monkeypatch):
    opened, synced = [], []
    real = torch.profiler.record_function

    def counting_range(*args, **kwargs):
        opened.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting_range)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: synced.append(a))
    ring = _ring()
    fp = _pass(MeanAbsDeviation())
    maps = list(fp.forward_pass(ring, (2, 4, 1)))
    assert len(maps) == 2 and fp.timer.counts["Patch net"] >= 2
    assert opened == [] and synced == []
