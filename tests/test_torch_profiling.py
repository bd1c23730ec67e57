"""The port's phase timer and host spans on the CPU: an untraced pass opens
no ``record_function`` range and never synchronises the device; a traced
pass names each host step with a span nested in its phase or in the pass;
the timer sums ``perf_counter`` durations on the CPU in the format it
always had. The card's half (phase times from CUDA events against a synced
wall time) is in ``tests/test_torch_cuda_kernels.py``."""
import numpy as np
import pytest
import torch

from raynet_tpu_torch.common.generation_parameters import GenerationParameters
from raynet_tpu_torch.common.ring_scene import RingScene
from raynet_tpu_torch.inference import get_forward_pass_factory
from raynet_tpu_torch.models.feature_extractor import FeatureExtractor
from raynet_tpu_torch.utils import profiling

RAYNET, VOXEL = "raynet", "multi_view_cnn_voxel_space"
PASS = "pass"
FEATURES, SWEEP, MESSAGES, DEPTH = (
    "Features computation", "Plane sweep", "Message passing",
    "Per-pixel depth estimation")
# the phase or the pass (PASS) each span nests in
CNN_SPANS = {"cnn.pad": {PASS}, "cnn.upload": {FEATURES},
             "cnn.net": {FEATURES}, "rays.index": {PASS},
             "depth.download": {DEPTH}, "depth.scatter": {PASS}}
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


def _pass(factory, host_store=False, filter_out_rays=False):
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


@pytest.mark.parametrize("factory", [RAYNET, VOXEL])
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
