"""idle_share: the share of a request's wall in which no operation ran on
the device: 1 - (the traced request's device busy time) / (the untraced
window's wall a request).  The profiler's own host cost stretches the
traced request's wall (by about two thirds at tsx level 5), so its wall
would read the device idler than it is; the busy time is the device's and
does not stretch."""


def read(run, trace):
    w = run["window"]
    if trace is None or not w["requests"]:
        return None
    return 1.0 - (trace.busy_s / trace.requests) / (w["seconds"] / w["requests"])
