"""refresh_share: the share of the traced requests' device time spent in
the tangent refresh of a Newton iteration.

The refresh is known by where the host launches it: inside the port's
functions listed in REFRESH (the table of this metric), each wrapped in a
span during the traced requests.  The tsx scatters the plastic tangent
correction into a copy of the fine operator's values through a sorting
`index_put_` (`solve.newton.refreshed_values`); the footing rebuilds every
level of its tangent hierarchy (`solve.multigrid.tangent_vcycle`: the fine
element scatter, the Galerkin maps through K3's CSR kernel, the smoother
constants, the coarse cuSOLVER factor)."""

REFRESH = (
    ("fem_elastoplasticity_tpu_torch.solve.newton", "refreshed_values"),
    ("fem_elastoplasticity_tpu_torch.solve.multigrid", "tangent_vcycle"),
)
TAG = "refresh"
SPANS = [(mod, fn, lambda *a, **k: TAG) for mod, fn in REFRESH]


def read(run, trace):
    if trace is None or not trace.ops:
        return None
    inside = sum(op.dur_ns for op, _ in trace.in_span(TAG))
    if not inside:
        return None
    return inside / sum(op.dur_ns for op in trace.ops)
