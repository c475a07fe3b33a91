"""host_reads_per_cg_iter: the traced requests' reads of a single value
from the card (`aten::_local_scalar_dense`, each a stream sync) over their
CG iterations."""


def read(run, trace):
    cg = sum(c["cg"] for c in run["traced"]["counts"]) if run.get("traced") else 0
    if trace is None or not cg:
        return None
    return trace.host_reads / cg
