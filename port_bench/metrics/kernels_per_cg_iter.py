"""kernels_per_cg_iter: device operations of the traced requests over
their CG iterations."""


def read(run, trace):
    cg = sum(c["cg"] for c in run["traced"]["counts"]) if run.get("traced") else 0
    if trace is None or not cg:
        return None
    return len(trace.ops) / cg
