"""The roofline arithmetic against hand counts at the level-5 tsx fine
level: 910,368 rows, 3,182,128 node blocks (bounds as the port's kernel
table gives them: K5 18.46 / 16.29 us, K3's product 21.72 us)."""
import pytest

from port_bench.metrics import _node_blocks
from port_bench.roofline import bound_s, product_cost, sweep_cost

N, BLOCKS = 910_368, 3_182_128


def test_k5_sweep_bytes():
    # 4 bf16 values and an int32 column a block, node offsets, 6 / 4 vectors
    blocks = (4 * 2 + 4) * BLOCKS + 4 * (N // 2 + 1)
    assert sweep_cost(N, 4 * BLOCKS, BLOCKS, 2, True)[1] == blocks + 4 * N * 6 == 61_855_108
    assert sweep_cost(N, 4 * BLOCKS, BLOCKS, 2, False)[1] == blocks + 4 * N * 4 == 54_572_164
    assert bound_s(61_855_108, 0) * 1e6 == pytest.approx(18.46, abs=0.005)
    assert bound_s(54_572_164, 0) * 1e6 == pytest.approx(16.29, abs=0.005)


def test_k3_product_bytes():
    layout, ops = product_cost(N, N, BLOCKS, 4)
    assert layout == (4 * 4 + 4) * BLOCKS + 4 * (N // 2 + 1) + 4 * 2 * N == 72_746_244
    assert bound_s(layout, ops) * 1e6 == pytest.approx(21.72, abs=0.005)


def test_tags_give_the_bounds():
    assert _node_blocks.sweep_bound(f"sweep 2 {N} {BLOCKS} 1") == pytest.approx(
        61_855_108 / 3.35e12)
    assert _node_blocks.sweep_bound(f"sweep 2 {N} {BLOCKS} 0") == pytest.approx(
        54_572_164 / 3.35e12)
    assert _node_blocks.product_bound(f"product 4 {N} {BLOCKS} {N}") == pytest.approx(
        72_746_244 / 3.35e12)
