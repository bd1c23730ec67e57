"""k2_roofline: the share of K2's device time (``csrc/bp_sweep.cu``,
``bp_sweep_kernel``, its first, message and depth modes) that its bound
takes: the bound of the window's BP sweeps, counted by
``roofline.bp_sweep_cost`` from the closed-form visits, over the kernel's
device time in the trace, in %."""
from bench_torch import roofline

KERNEL = "bp_sweep_kernel"
MODES = ("first", "message", "depth")


def read(run):
    if run.trace is None or run.work is None:
        return None
    seconds = run.trace.device_seconds(KERNEL)
    if seconds <= 0:
        return None
    costs = roofline.sweep_costs(
        run.work, roofline.pass_sweeps(run.config), MODES)
    bound = sum(roofline.bound_seconds(c) for c in costs)
    return 100.0 * bound * len(run.passes) / seconds
