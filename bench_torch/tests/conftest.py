"""A checkout of the benchmark at a size the CPU holds: ``BENCHMARK.json``
and ``bench_torch/`` copied into a temporary directory, with tiny
configurations and a tiny traffic file added as new files, and cells of
them added to the copy's ``BENCHMARK.json``."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_TRAFFIC = {
    "name": "tiny", "kind": "ring", "why": "4 views of 24x32",
    "n_images": 4, "height": 24, "width": 32, "focal": 55.0, "radius": 20.0,
    "angle_step": 0.3, "bbox_half": 3.0, "images_range": [0, 4, 1],
}


def tiny_config(name):
    config = json.loads((REPO / "bench_torch" / "configs"
                         / (name + ".json")).read_text())
    config.update(name="tiny_" + name, depth_planes=8, neighbors=2,
                  grid_shape=[8, 8, 4], max_marched_voxels=24,
                  rays_batch=200)
    return config


def add_cell(root, config, traffic):
    """Add ``config`` and ``traffic`` as new files of the checkout at
    ``root`` and a cell of them to its ``BENCHMARK.json``; returns the
    cell's name."""
    (root / "bench_torch" / "configs" / (config["name"] + ".json")).write_text(
        json.dumps(config))
    (root / "bench_torch" / "traffic" / (traffic["name"] + ".json")).write_text(
        json.dumps(traffic))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    name = "%s.%s" % (config["name"], traffic["name"])
    spec["configs"].append({
        "name": config["name"], "source": config["source"],
        "file": "bench_torch/configs/%s.json" % config["name"],
        "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": name, "config": config["name"],
                              "traffic": traffic["name"], "chips": 1,
                              "why": "tiny"})
    # the tiny cell reports what the cell of the configuration it shrinks
    # reports
    base = next(w["name"] for w in spec["workloads"]
                if "tiny_" + w["config"] == config["name"])
    for metric in spec["per_layer"] + spec["end_to_end"]:
        if base in metric.get("workloads", ()):
            metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return name


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files with the cells tiny_raynet.tiny and
    tiny_mvcnn_voxel.tiny added."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "bench_torch", root / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name in ("raynet", "mvcnn_voxel"):
        add_cell(root, tiny_config(name), TINY_TRAFFIC)
    return root
