"""The readings that set the limits of ``correct``: the program's, and
the control's.

    python3 -m bench_torch.control --workload raynet.ring8_framed \
        --seeds 11,12,13 --control-seeds 11,12,13

For each seed, in one process: the cell's scene and weights, one pass of
the program (the timed path, at the cell's sizes) and the reference's
judgement of its depth maps. For a control seed also the control: the
reference put in the program's place in the nearest precision below the
configuration's (TF32 for float32 with TF32 off), whose own depth maps
the float32 reference judges as it judges the program's. One JSON line
per seed on standard output. The benchmark's runs do not run this.
"""
import argparse
import json
import sys
import time

import torch

from bench_torch import harness


def readings(bench, workload, seed, control, device, err=sys.stderr):
    """{"seed", "program": {number: reading}, "control": ... or None}."""
    cell_entry = bench.workload(workload)
    config = bench.config(cell_entry["config"])
    traffic = bench.traffic(cell_entry["traffic"])
    reference = bench.reference(config)
    cell = bench.driver(config).Cell(config, traffic, seed, device)
    maps, _ = cell.one_pass()
    del cell.model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    contenders = [maps]
    t0 = time.perf_counter()
    if control:
        H, W = cell.scene.image_shape
        ctl = reference.run(cell.scene, cell.weights, config, traffic, [],
                            device, tf32=True)
        contenders.append(ctl.reference_maps(H, W))
        del ctl
    t1 = time.perf_counter()
    judged = reference.run(cell.scene, cell.weights, config, traffic,
                           contenders, device).readings()
    print("seed %d: control %.1f s, reference %.1f s"
          % (seed, t1 - t0, time.perf_counter() - t1), file=err)
    return {"workload": workload, "seed": seed, "program": judged[0],
            "control": judged[1] if control else None}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m bench_torch.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch.control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.Benchmark()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(bench, args.workload, seed,
                                  seed in controls, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
