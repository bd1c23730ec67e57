"""pass_mfu: the whole pass's share of the card's peak, in %: the
operations of a pass (``roofline.pass_flops``: the CNN's 2 x its
multiply-accumulates, the plane sweep's, and the sweeps over the march
from the closed-form visits) times the passes, over the window on the
host's clock (its start to the last pass's completion), over the peak of
the configuration's precision."""
from bench_torch import roofline


def read(run):
    if run.work is None or not run.passes or run.device["platform"] != "gpu":
        return None
    flops = roofline.pass_flops(run.work,
                               roofline.pass_sweeps(run.config))
    peak = roofline.PEAK_FLOPS[run.config["precision"]]
    return 100.0 * flops * len(run.passes) / run.passes[-1].end / peak
