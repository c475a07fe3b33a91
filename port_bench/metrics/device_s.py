"""device_s: device seconds a request, from the profiler's trace: the time
in which an operation ran on the card (the union of the device operations'
spans) over one whole request under the profiler after the window.  The
window's requests repeat bit for bit (the same counts, the same answers),
so one whole request stands for each; its host wall, which the profiler
stretches, is not read."""
PROFILED = True


def read(run, trace):
    return trace.busy_s / trace.requests if trace is not None else None
