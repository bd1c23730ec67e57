"""The device's idle time inside the traced window, charged to the host's
ranges by overlap.

The idle intervals are the window less the union of the device intervals
(``Trace.merged``). Each is cut at every boundary of a host range, and
each piece is charged to the innermost range open over it: of the ranges
that contain it, the one that started last (the shorter one on a tie).
A piece under no range is charged to "(no range)". So a gap that starts
at the end of one view's depth download and lasts through the host's
scatter is charged in part to each span, where ``Trace.idle_gaps`` names
all of it by the range open at its start.

The counts of a name are the ranges of that name that start inside the
window: the divisors of the per-span readers, taken at the boundaries of
the spans they divide.
"""
NO_RANGE = "(no range)"


def idle_intervals(trace):
    """Sorted disjoint (start, end) of the window in which the device ran
    nothing."""
    out, t = [], trace.lo
    for s, e in trace.merged():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < trace.hi:
        out.append((t, trace.hi))
    return out


def idle_by_range(trace):
    """{range name: device-idle seconds under it as its innermost range},
    over the window; the values sum to the window's idle time."""
    # boundaries in time order; at one time, idle edges, then range
    # starts (outer first), then range ends
    points = []
    for s, e in idle_intervals(trace):
        points.append((s, 0, 0, True))
        points.append((e, 0, 0, False))
    for k, (s, e, _) in enumerate(trace.ranges):
        s, e = max(s, trace.lo), min(e, trace.hi)
        if s < e:
            points.append((s, 1, -e, k))
            points.append((e, 2, 0, k))
    points.sort()
    by, stack = {}, []  # stack: open range ids, last started on top
    idle, now = False, trace.lo
    for t, kind, _, payload in points:
        if idle and t > now:
            name = trace.ranges[stack[-1]][2] if stack else NO_RANGE
            by[name] = by.get(name, 0.0) + (t - now) * 1e-6
        now = t
        if kind == 0:
            idle = payload
        elif kind == 1:
            stack.append(payload)
        else:
            stack.remove(payload)
    return by


def count(trace, name):
    """The ranges named ``name`` that start inside the window."""
    return sum(1 for s, _, n in trace.ranges
               if n == name and trace.lo <= s < trace.hi)


def idle_ms_per(run, names, divisor):
    """Device-idle milliseconds under the ranges ``names``, per range named
    ``divisor``; None without a device in the trace or where the program
    opens none of ``names`` (a program without these spans)."""
    trace = run.trace
    if trace is None or not trace.device:
        return None
    n = count(trace, divisor)
    if n == 0 or not any(name in names for _, _, name in trace.ranges):
        return None
    by = idle_by_range(trace)
    return sum(by.get(name, 0.0) for name in names) * 1e3 / n
