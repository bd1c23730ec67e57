"""The port's phase timer and host spans on the CPU: an untraced pass opens
no ``record_function`` range, never synchronises the device and times no
U-Net layer; a traced pass names each host step with a span nested in its
phase or in the pass, and the MVSNet and CasMVSNet passes time each U-Net
layer in its "Cost regularization" phase; a view set's ``views.*`` spans
open once a view set built; the timer sums ``perf_counter`` durations on
the CPU in the format it always had. The card's half (phase times from
CUDA events against a synced wall time, the layer timers against their
phase and K6's and K7's device time) is in
``tests/test_torch_cuda_kernels.py``."""

import numpy as np
import pytest
import torch

from raynet_tpu_torch.common.generation_parameters import GenerationParameters
from raynet_tpu_torch.common.ring_scene import RingScene
from raynet_tpu_torch.inference import get_forward_pass_factory
from raynet_tpu_torch.models.casmvsnet import CasMVSNetModel
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.models.mvsnet import UNET_LABELS, MVSNetModel
from raynet_tpu_torch.utils import profiling

RAYNET, VOXEL, MVCNN = "raynet", "multi_view_cnn_voxel_space", "multi_view_cnn"
MVSNET, CASMVSNET = "mvsnet", "casmvsnet"
PASS = "pass"
FEATURES, SWEEP, MESSAGES, DEPTH = (
    "Features computation", "Plane sweep", "Message passing",
    "Per-pixel depth estimation")
COSTREG, FINE = "Cost regularization", "Fine regularization"
VIEW_SET_SPANS = ("views.stack", "views.cameras")
# the phase or the pass (PASS) each span nests in
CNN_SPANS = {"cnn.pad": {PASS}, "cnn.upload": {FEATURES},
             "cnn.net": {FEATURES}, "rays.index": {PASS},
             "depth.download": {DEPTH}, "depth.scatter": {PASS},
             "pass.setup": {PASS}, "views.stack": {PASS},
             "views.cameras": {PASS}}
PARENTS = {
    RAYNET: dict(CNN_SPANS, **{
        "rays.upload": {SWEEP}, "rays.segments": {SWEEP}, "scores": {SWEEP},
        "messages.alloc": {PASS, MESSAGES}, "sweep.first": {MESSAGES},
        "sweep.message": {MESSAGES}, "sweep.depth": {DEPTH}}),
    VOXEL: dict(CNN_SPANS, **{
        "rays.upload": {DEPTH}, "rays.segments": {DEPTH},
        "voxel_depth": {DEPTH}}),
}
VIEWS = (0, 3, 1)


def _mvs_pass(factory):
    """An MVSNet or CasMVSNet pass on the 128x96 ring rig of their tests
    (D = 16 in MVSNet, 2 neighbours)."""
    scene = RingScene(4, 96, 128, 220.0, angle_origin=1, bbox_half=6.5)
    gp = type("GP", (), dict(depth_planes=16, neighbors=2))()
    model = (MVSNetModel if factory == MVSNET else CasMVSNetModel)(
        seed=3, device="cpu")
    fp = get_forward_pass_factory(factory)(model, gp, None,
                                           scene.image_shape, device="cpu")
    return fp, scene


def _pass(factory, host_store=False, filter_out_rays=False):
    if factory in (MVSNET, CASMVSNET):
        return _mvs_pass(factory)
    scene = RingScene(4, 24, 32, 55.0, angle_step=0.3, seed=1)
    gp = GenerationParameters(
        depth_planes=4, neighbors=2, patch_shape=(11, 11, 3),
        grid_shape=np.array([8, 8, 4], dtype=np.int32),
        max_number_of_marched_voxels=24, padding=11, gamma_mrf=0.05)
    model = FeatureExtractor("simple_cnn", seed=0, device="cpu")
    fp = get_forward_pass_factory(factory)(model, gp, None,
                                           scene.image_shape, 200,
                                           filter_out_rays=filter_out_rays,
                                           device="cpu")
    if factory == RAYNET:
        fp.bp_iterations = 2
        if host_store:
            # 3 views of 768 rays: scores, segments and the march sums
            # 110,592 bytes fit, with the messages 331,776 do not
            fp.messages_device_budget = 150_000
    return fp, scene


@pytest.mark.parametrize("factory", [RAYNET, VOXEL, MVCNN, MVSNET, CASMVSNET])
def test_untraced_pass_opens_no_range_and_never_syncs(factory, monkeypatch):
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
    fp, scene = _pass(factory)
    maps = list(fp.forward_pass(scene, VIEWS))
    assert len(maps) == len(range(*VIEWS))
    assert fp.timer.counts[FEATURES] >= 1
    assert opened == [] and synced == []
    # no U-Net layer is timed
    assert not [k for k in fp.timer.summary() if k.startswith("unet.")]


def _ranges(events):
    return [(ev["ts"], ev["ts"] + ev["dur"], ev["name"]) for ev in events
            if ev.get("cat") == "user_annotation"]


def _parent(ranges, child):
    """The innermost range around ``child``: the last started, the
    shorter on a tie."""
    s, e, _ = child
    around = [r for r in ranges if r is not child and r[0] <= s and e <= r[1]]
    return max(around, key=lambda r: (r[0], r[0] - r[1]))[2]


@pytest.mark.parametrize("factory, host_store", [
    (RAYNET, False), (RAYNET, True), (VOXEL, False)],
    ids=["raynet", "raynet-host-store", "voxel"])
def test_traced_pass_nests_each_span_in_its_phase(factory, host_store,
                                                  tmp_path):
    fp, scene = _pass(factory, host_store)
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function(PASS):
            maps = list(fp.forward_pass(scene, VIEWS))
    ranges = _ranges(profiling.read_trace(
        str(tmp_path / profiling.TRACE_NAME)))
    parents = PARENTS[factory]
    # the store's release is timed by ``add``, with no range
    phases = set(fp.timer.counts) - {"Message store release"}
    assert {name for _, _, name in ranges} == (
        set(parents) | phases | {PASS})
    for r in ranges:
        if r[2] in parents:
            assert _parent(ranges, r) in parents[r[2]], r
    names = [name for _, _, name in ranges]
    assert names.count("depth.scatter") == len(maps) == len(range(*VIEWS))
    assert names.count("cnn.upload") == fp.timer.counts[FEATURES] == len(
        {j for i in range(*VIEWS) for j in scene.get_view_idxs(i, 2)})
    for phase in phases:
        assert names.count(phase) == fp.timer.counts[phase]
    # one view set a reference view, each built once
    for name in VIEW_SET_SPANS:
        assert names.count(name) == len(range(*VIEWS))
    assert names.count("pass.setup") == 1
    if host_store:
        assert fp.message_store != "device"


@pytest.mark.parametrize("device", [None, "cpu"])
def test_phase_timer_sums_perf_counter_on_the_cpu(device, monkeypatch):
    clock = iter([1.0, 1.5, 2.0, 2.25, 3.0, 3.125])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.PhaseTimer(device=device)
    for label in ("A", "A", "B"):
        with timer.phase(label):
            pass
    timer.add("C", 0.5)
    assert timer.summary() == {
        "A": {"total_s": 0.75, "count": 2},
        "B": {"total_s": 0.125, "count": 1},
        "C": {"total_s": 0.5, "count": 1}}
    assert timer.totals == {"A": 0.75, "B": 0.125, "C": 0.5}
    assert timer.counts == {"A": 2, "B": 1, "C": 1}


def test_span_is_one_null_context_untraced_and_a_range_traced(tmp_path):
    assert profiling.span("a") is profiling.span("b")
    with profiling.trace(str(tmp_path)):
        with profiling.span("traced"):
            pass
    names = [n for _, _, n in _ranges(profiling.read_trace(
        str(tmp_path / profiling.TRACE_NAME)))]
    assert names == ["traced"]


def test_layer_timer_is_the_null_context_untraced(tmp_path):
    timer = profiling.PhaseTimer(device="cpu")
    assert timer.layer("a") is profiling.span("b")
    with timer.layer("a"):
        pass
    assert timer.summary() == {}
    with profiling.trace(str(tmp_path)):
        with timer.layer("a"):
            pass
    assert timer.counts == {"a": 1}
    names = [n for _, _, n in _ranges(profiling.read_trace(
        str(tmp_path / profiling.TRACE_NAME)))]
    assert names == ["a"]


@pytest.mark.parametrize("factory", [MVSNET, CASMVSNET])
def test_untraced_unet_creates_no_event_for_a_card_timer(factory,
                                                         monkeypatch):
    """A timer for a CUDA device (its phases time by events) times no
    layer of an untraced U-Net: no event, no range, no label."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(a))
    fp, _ = _mvs_pass(factory)
    timer = profiling.PhaseTimer(device="cuda")
    volume = torch.rand((1, 16 if factory == CASMVSNET else 32, 8, 8, 8))
    args = (1,) if factory == CASMVSNET else ()
    logits = fp._model.regularize(volume, *args, timer=timer)
    assert logits.shape == (1, 1, 8, 8, 8)
    assert made == [] and timer.summary() == {}


MVS_VIEWS = (0, 2, 1)


@pytest.mark.parametrize("factory", [MVSNET, CASMVSNET])
def test_traced_mvs_pass_times_each_unet_layer_in_its_phase(factory,
                                                            tmp_path):
    fp, scene = _mvs_pass(factory)
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function(PASS):
            maps = list(fp.forward_pass(scene, MVS_VIEWS))
    assert len(maps) == len(range(*MVS_VIEWS))
    ranges = _ranges(profiling.read_trace(
        str(tmp_path / profiling.TRACE_NAME)))
    names = [name for _, _, name in ranges]
    # the spans that repeated their phase's range are gone
    assert "mvs.cost_volume" not in names and "mvs.regularize" not in names
    volumes = fp.volumes
    assert volumes == len(maps) * (3 if factory == CASMVSNET else 1)
    # 11 layer ranges a volume, in the U-Net's order, each in its volume's
    # "Cost regularization" (and a last stage's in "Fine regularization")
    layers = sorted(r for r in ranges if r[2].startswith("unet."))
    assert [r[2] for r in layers] == list(UNET_LABELS) * volumes
    costreg = sorted(r for r in ranges if r[2] == COSTREG)
    fine = sorted(r for r in ranges if r[2] == FINE)
    assert len(costreg) == volumes
    assert len(fine) == (len(maps) if factory == CASMVSNET else 0)
    for k, r in enumerate(layers):
        volume = k // len(UNET_LABELS)
        outer = costreg[volume]
        assert outer[0] <= r[0] and r[1] <= outer[1], r
        last_stage = factory == CASMVSNET and volume % 3 == 2
        assert _parent(ranges, r) == (FINE if last_stage else COSTREG), r
        if last_stage:
            f = fine[volume // 3]
            assert f[0] <= r[0] and r[1] <= f[1], r
    # the timer counts each label once a volume
    summary = fp.timer.summary()
    for label in UNET_LABELS:
        assert summary[label]["count"] == volumes
        assert summary[label]["total_s"] > 0
    assert summary[COSTREG]["count"] == volumes


@pytest.mark.parametrize("factory", [RAYNET, VOXEL, MVCNN])
def test_view_set_spans_open_once_a_view_set_built(factory, tmp_path):
    """``views.stack`` and ``views.cameras`` open once for each view set
    built, after its images' features and outside their ``cnn.*`` spans,
    and never for a view set the pass object has cached."""
    fp, scene = _pass(factory)
    for call, cached in (("first", False), ("again", True)):
        with profiling.trace(str(tmp_path / call)):
            with torch.profiler.record_function(PASS):
                list(fp.forward_pass(scene, VIEWS))
        ranges = _ranges(profiling.read_trace(
            str(tmp_path / call / profiling.TRACE_NAME)))
        names = [name for _, _, name in ranges]
        for name in VIEW_SET_SPANS:
            assert names.count(name) == (0 if cached else len(range(*VIEWS)))
        views = [r for r in ranges if r[2] in VIEW_SET_SPANS]
        cnn = [r for r in ranges if r[2].startswith("cnn.")
               or r[2] == FEATURES]
        for v in views:
            for c in cnn:
                # disjoint: neither holds the other
                assert v[1] <= c[0] or c[1] <= v[0], (v, c)
        # a view set's stack follows the features of its last new image
        for (s, _, _), (t, _, _) in zip(
                sorted(r for r in views if r[2] == "views.stack"),
                sorted(r for r in views if r[2] == "views.cameras")):
            assert s < t
