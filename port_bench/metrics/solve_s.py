"""solve_s: seconds a request, host clock: from the start of the window's
first request to the end of its last, each ended by a device sync, over the
number of requests."""


def read(run, trace):
    w = run["window"]
    return w["seconds"] / w["requests"] if w["requests"] else None
