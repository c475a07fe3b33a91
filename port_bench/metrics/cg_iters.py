"""cg_iters: the CG iterations of a request (the tangent solves), the mean
over the window's requests; the footing's banked count is not the
request's."""


def read(run, trace):
    counts = run["window"]["counts"]
    return sum(c["cg"] for c in counts) / len(counts) if counts else None
