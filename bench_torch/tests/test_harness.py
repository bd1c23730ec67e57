"""The benchmark's harness on the CPU: names resolve to files, new files
are found without an edit, the generator is seeded, the run refuses to
run without a card, and a tiny run through the program's plain versions
is judged correct."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_torch import harness, scene
from conftest import REPO, TINY_TRAFFIC

RAYNET, MVCNN = "raynet.ring8_framed", "mvcnn_voxel.ring8_framed"


def test_every_cell_resolves_by_name():
    bench = harness.Benchmark(REPO)
    for cell in bench.spec["workloads"]:
        config = bench.config(cell["config"])
        assert config["name"] == cell["config"]
        assert bench.traffic(cell["traffic"])["name"] == cell["traffic"]
        assert callable(bench.driver(config).run)
        assert callable(bench.reference(config).run)
        for metric in bench.per_layer(cell["name"]):
            assert callable(bench.metric_reader(metric["name"]).read)
        names = {m["name"] for m in bench.end_to_end(cell["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert bench.per_layer(cell["name"])


def test_every_per_layer_metric_moves_what_its_cells_report():
    bench = harness.Benchmark(REPO)
    for metric in bench.spec["per_layer"]:
        for workload in metric["workloads"]:
            assert metric["moves"] in {
                m["name"] for m in bench.end_to_end(workload)}


def test_per_layer_metrics_only_in_their_cells():
    bench = harness.Benchmark(REPO)
    ray = {m["name"] for m in bench.per_layer(RAYNET)}
    mv = {m["name"] for m in bench.per_layer(MVCNN)}
    assert "k2_roofline" in ray and "k2_roofline" not in mv
    assert "k3_depth_roofline" in mv and "k3_depth_roofline" not in ray
    # a quantity split by cell is read by one reader
    assert "k1_roofline" in ray and "k1_roofline.mvcnn_voxel" in mv
    assert bench.metric_reader("k1_roofline.mvcnn_voxel") \
        is bench.metric_reader("k1_roofline")


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (REPO / "bench_torch" / "traffic").glob("*.json")))
def test_every_traffic_file_is_a_ring_the_generator_reads(name):
    # dtu8 (bbox +-3) is in no cell while the program fails on its grazing
    # rays; a later cell takes it by name
    traffic = harness.Benchmark(REPO).traffic(name)
    assert traffic["name"] == name and traffic["kind"] == "ring"
    small = dict(traffic, n_images=2, height=6, width=8)
    sc = scene.make_scene(small, 3, "cpu")
    assert sc.n_images == 2 and float(sc.bbox[0, 3]) == traffic["bbox_half"]
    assert len(range(*traffic["images_range"])) <= traffic["n_images"]


def _digests(root):
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_without_an_edit(checkout):
    # a new reader, and a new traffic file (the tiny one), in a checkout
    # run from its root, as a later cell adds them
    (checkout / "bench_torch" / "metrics" / "passes_seen.py").write_text(
        "def read(run):\n    return float(len(run.passes))\n")
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "passes_seen", "unit": "passes", "better": "higher",
        "source": "program_counter", "layer": "whole pass",
        "moves": "px_per_s.mvcnn_voxel",
        "workloads": ["tiny_mvcnn_voxel.tiny"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, time; from bench_torch import harness; "
            "r = harness.run_cell('tiny_mvcnn_voxel.tiny', 5, 0.2, True, "
            "'cpu', time.perf_counter()); "
            "print(json.dumps([harness.__file__, r['attempted'], "
            "r['metrics']['passes_seen']['value']]))")
    # the checkout's own bench_torch first, the program from the repo
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    where, attempted, seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert where.startswith(str(checkout))
    assert seen == attempted >= 1
    # the copy's files other than BENCHMARK.json are the repo's or new
    repo = _digests(REPO / "bench_torch")
    for rel, digest in _digests(checkout / "bench_torch").items():
        if rel in repo:
            assert repo[rel] == digest, rel


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_scene_is_the_seeds(seed):
    a = scene.make_scene(TINY_TRAFFIC, seed, "cpu")
    b = scene.make_scene(TINY_TRAFFIC, seed, "cpu")
    c = scene.make_scene(TINY_TRAFFIC, seed + 1, "cpu")
    for i in range(a.n_images):
        assert np.array_equal(a.get_image(i).image_u8, b.get_image(i).image_u8)
        assert not np.array_equal(a.get_image(i).image_u8,
                                  c.get_image(i).image_u8)
        np.testing.assert_array_equal(a.get_image(i).camera.P,
                                      c.get_image(i).camera.P)
    layers = [[32, 3, 1]] * 5
    wa = scene.cnn_weights(layers, 3, seed, "cpu")
    wb = scene.cnn_weights(layers, 3, seed, "cpu")
    wc = scene.cnn_weights(layers, 3, seed + 1, "cpu")
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert not torch.equal(wa["convs.0.weight"], wc["convs.0.weight"])


def _run_module(cwd, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "-m", "bench_torch.run", "--workload", RAYNET,
         "--seed", "1", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_exits_nonzero_without_a_card():
    out = _run_module(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copytree(REPO / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run_module(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("workload", ["tiny_raynet.tiny",
                                      "tiny_mvcnn_voxel.tiny"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(checkout, workload, trace):
    result = harness.run_cell(workload, 2**31 + 7, 0.2, trace, "cpu",
                              time.perf_counter(), root=checkout)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    names = set(result["metrics"])
    suffix = "" if workload == "tiny_raynet.tiny" else ".mvcnn_voxel"
    if trace:
        # no card, so no share of it: only the CNN's span
        assert names == {"cnn_ms_per_image" + suffix}
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert names == {"px_per_s" + suffix, "pass_p90_s" + suffix,
                         "peak_mem_GB", "setup_s"}
