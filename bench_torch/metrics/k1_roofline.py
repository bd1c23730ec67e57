"""k1_roofline: the share of K1's device time (``csrc/planesweep.cu``,
``plane_sweep_kernel``) that its bound takes: the bound of the window's
plane sweeps, counted by ``roofline.plane_sweep_cost`` from the scene's
work, over the kernel's device time in the trace, in %."""
from bench_torch import roofline

KERNEL = "plane_sweep_kernel"


def read(run):
    if run.trace is None or run.work is None:
        return None
    seconds = run.trace.device_seconds(KERNEL)
    if seconds <= 0:
        return None
    bound = sum(roofline.bound_seconds(c)
                for c in roofline.plane_sweep_costs(run.work))
    return 100.0 * bound * len(run.passes) / seconds
