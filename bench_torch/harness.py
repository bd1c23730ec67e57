"""What every cell shares: ``BENCHMARK.json``, the files it names, and the
run's one-line result.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own and is found by name:

- ``configs/<config>.json`` (the ``file`` of its ``configs`` entry): the
  sizes as run, the program's entry (``factory``), the cell's driver
  (module ``bench_torch.drivers.<driver>``: set-up, window, end-to-end
  metrics), its plain reference (``bench_torch.reference.<reference>``)
  and the limits of the numbers compared;
- ``traffic/<traffic>.json``: the parameters the generator reads;
- ``metrics/<reader>.py``: a reader ``read(run)`` of one per-layer
  quantity, which returns a number, or None where the run has nothing to
  read. A metric is read by the reader named by its name up to the first
  ".", so that a quantity split by cell (``k1_roofline`` and
  ``k1_roofline.mvcnn_voxel``) has one reader. Every ``per_layer`` entry
  lists the ``workloads`` it is read in. An end-to-end metric split by
  cell (``px_per_s.mvcnn_voxel``) is the driver's quantity of the name up
  to the first "." as well.

The data files are read from the checkout at ``root``; the code is this
package's. A later cell adds files and entries; no file here needs an
edit.
"""
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = "bench_torch"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def plugin(kind, name):
    """The module ``bench_torch.<kind>.<name>``."""
    return importlib.import_module("%s.%s.%s" % (HERE, kind, name))


class Benchmark:
    """``BENCHMARK.json`` of a checkout, and the files its names lead to."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def _entry(self, key, name):
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError("no %s entry named %r in BENCHMARK.json" % (key, name))

    def workload(self, name):
        return self._entry("workloads", name)

    def config(self, name):
        return load_json(self.root / self._entry("configs", name)["file"])

    def traffic(self, name):
        return load_json(self.root / HERE / "traffic" / (name + ".json"))

    def driver(self, config):
        return plugin("drivers", config["driver"])

    def reference(self, config):
        return plugin("reference", config["reference"])

    def metric_reader(self, name):
        return plugin("metrics", name.split(".")[0])

    def end_to_end(self, workload):
        """The end-to-end metric entries that ``workload`` reports."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload):
        """The per-layer metric entries read in ``workload``."""
        return [m for m in self.spec["per_layer"]
                if workload in m["workloads"]]


def run_cell(workload, seed, seconds, trace, device, t0, root=ROOT,
             err=sys.stderr):
    """Run one cell once; returns the result's dict, ``checks`` last."""
    bench = Benchmark(root)
    cell = bench.workload(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    driver = bench.driver(config)
    run = driver.run(bench, cell, config, traffic, seed, seconds, trace,
                     device, t0, err)
    if trace:
        metrics = {}
        for m in bench.per_layer(workload):
            value = bench.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = driver.end_to_end(run)
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in bench.end_to_end(workload)}
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": run.device}
    if trace:
        result["breakdown"] = run.breakdown
    result["checks"] = run.checks
    return result
