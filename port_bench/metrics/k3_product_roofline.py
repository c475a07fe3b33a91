"""k3_product_roofline: percent of its bound that K3's product on f32 node
blocks (`node_block_spmv`, the sweep kernel's product epilogue: the CG
operator, the criterion and the predictor on the fine level) reaches in
the traced requests, its layout bytes (`roofline.product_cost`) at 3.35
TB/s over its device time."""
from port_bench.metrics._node_blocks import PRODUCT_SPAN, product_bound, share

SPANS = [PRODUCT_SPAN]


def read(run, trace):
    return share(trace, "product 4 ", product_bound)
