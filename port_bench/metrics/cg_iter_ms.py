"""cg_iter_ms: host milliseconds a CG iteration, the untraced window's
wall over its requests' CG iterations (all of a request's work, Newton
level and refresh included, spread over its CG iterations)."""


def read(run, trace):
    w = run["window"]
    cg = sum(c["cg"] for c in w["counts"])
    return 1e3 * w["seconds"] / cg if cg else None
