"""idle_share: the share of the traced window in which no kernel, copy or
memset ran on the device, in % (1 - the union of the device intervals
over the window)."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
