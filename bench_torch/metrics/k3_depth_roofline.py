"""k3_depth_roofline: the share of the device time of K3's voxel-depth
mode (``csrc/traversal.cu``, ``voxel_depth_kernel``) that its bound takes:
the bound of the window's voxel-depth sweeps, counted by
``roofline.voxel_depth_cost`` from the closed-form visits, over the
kernel's device time in the trace, in %."""
from bench_torch import roofline

KERNEL = "voxel_depth_kernel"


def read(run):
    if run.trace is None or run.work is None:
        return None
    seconds = run.trace.device_seconds(KERNEL)
    if seconds <= 0:
        return None
    costs = roofline.sweep_costs(
        run.work, roofline.pass_sweeps(run.config), ("voxel_depth",))
    bound = sum(roofline.bound_seconds(c) for c in costs)
    return 100.0 * bound * len(run.passes) / seconds
