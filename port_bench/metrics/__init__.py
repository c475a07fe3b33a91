"""One reader a metric: `metrics/<name>.py` (dots and dashes of the name as
underscores) with `read(run, trace)` -> the value, or None where it finds
nothing to read; `run` is the harness's record of the run, `trace` the
device trace of the traced requests (None in an untraced run).  A reader
may name functions of the port to wrap in spans during the traced requests
(`SPANS`, see `port_bench/trace.py`)."""
