"""Run one cell of the benchmark once.

    python3 -m bench_torch.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It prints the numbers compared, each beside
its limit, as its last lines on standard error, and one JSON object as
the last line of standard output. Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits with 2.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m bench_torch.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from . import harness

    cell = harness.Benchmark().workload(args.workload)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print("bench_torch: %s needs %d cards, %d present"
              % (args.workload, cell["chips"], torch.cuda.device_count()),
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    for name, check in result["checks"].items():
        print("check %s %r limit %r" % (name, check["value"], check["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
