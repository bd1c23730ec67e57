"""patch_pass_mfu: the Hartmann pass's share of the card's peak, in %: the
net's operations of a pass (``patch_roofline``: 2 x the convolutions'
multiply-accumulates of every quintuple) times the passes, over the
window on the host's clock (its start to the last pass's completion),
over the peak of the configuration's precision."""
from bench_torch import roofline


def read(run):
    if run.work is None or not run.passes or run.device["platform"] != "gpu":
        return None
    peak = roofline.PEAK_FLOPS[run.config["precision"]]
    return 100.0 * run.work["net"].ops * len(run.passes) \
        / run.passes[-1].end / peak
