"""Spans that tag each launch of the port's node-block kernels with its
operator's shape, and the roofline share over the tagged launches."""
from __future__ import annotations

from port_bench.roofline import bound_s, product_cost, sweep_cost

SPMV = "fem_elastoplasticity_tpu_torch.ops.spmv"


def _sweep_tag(B, aux, z, r, update=True, out=None):
    return (f"sweep {B.block_values.element_size()} {2 * B.n_nodes} "
            f"{B.block_cols.shape[0]} {int(bool(update))}")


def _product_tag(B, x, out=None):
    return (f"product {B.block_values.element_size()} {2 * B.n_nodes} "
            f"{B.block_cols.shape[0]} {x.shape[0]}")


SWEEP_SPAN = (SPMV, "block_jacobi_sweep_cuda", _sweep_tag)
PRODUCT_SPAN = (SPMV, "node_block_spmv_cuda", _product_tag)


def sweep_bound(tag: str) -> float:
    _, vb, n, blocks, update = tag.split()
    n, blocks = int(n), int(blocks)
    _, layout, ops = sweep_cost(n, 4 * blocks, blocks, int(vb), update == "1")
    return bound_s(layout, ops)


def product_bound(tag: str) -> float:
    _, vb, n, blocks, cols = tag.split()
    layout, ops = product_cost(int(n), int(cols), int(blocks), int(vb))
    return bound_s(layout, ops)


def share(trace, prefix: str, bound) -> float | None:
    """Percent: the tagged launches' bound time over their device time."""
    if trace is None:
        return None
    pairs = [(op, tag) for op, tag in trace.in_span(prefix) if "block_jacobi_sweep" in op.name]
    t = sum(op.dur_ns for op, _ in pairs) * 1e-9
    if not t:
        return None
    return 100.0 * sum(bound(tag) for _, tag in pairs) / t
