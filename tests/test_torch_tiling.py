"""The port's tile planner (``repro_torch.core.tiling``) equals JAX's.

``plan_matmul_tiles`` picks the K tile of the NTX matmul, and the K tile
decides where that kernel rounds, so the copy must give JAX's plans exactly,
TPU constants included. Checked over a fixed grid of shapes.
"""

import dataclasses
import itertools

import pytest

from repro.core import tiling as jt
from repro_torch.core import tiling as tt

DIMS = [1, 7, 8, 100, 127, 128, 129, 333, 512, 576, 1000, 1728, 2048, 4097, 16384]


def test_constants_and_sublane_match_jax():
    for name in ("DEFAULT_VMEM_BUDGET", "LANE", "MIN_BURST_ELEMS"):
        assert getattr(tt, name) == getattr(jt, name), name
    for nbytes in (1, 2, 4, 8):
        assert tt.sublane(nbytes) == jt.sublane(nbytes)


@pytest.mark.parametrize("in_bytes", [1, 2, 4])
def test_plan_matmul_tiles_matches_jax(in_bytes):
    for m, n, k in itertools.product(DIMS, repeat=3):
        want = jt.plan_matmul_tiles(m, n, k, in_dtype_bytes=in_bytes)
        got = tt.plan_matmul_tiles(m, n, k, in_dtype_bytes=in_bytes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (m, n, k)
        assert got.arithmetic_intensity == want.arithmetic_intensity
    small = dict(vmem_budget=1 << 20, acc_bytes=8)
    assert dataclasses.asdict(tt.plan_matmul_tiles(4096, 4096, 4096, **small)) == \
        dataclasses.asdict(jt.plan_matmul_tiles(4096, 4096, 4096, **small))


@pytest.mark.parametrize("k", [1, 3, 7])
def test_plan_stencil_tiles_matches_jax(k):
    for h, w, cin, cout in itertools.product([4, 17, 64, 224], [4, 56, 230], [1, 3, 64, 512],
                                             [1, 64, 192]):
        want = jt.plan_stencil_tiles(h, w, cin, cout, k, k)
        got = tt.plan_stencil_tiles(h, w, cin, cout, k, k)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (h, w, cin, cout)
    assert dataclasses.asdict(tt.plan_stencil_tiles(224, 224, 512, 512, k, k, 2, 1 << 20)) == \
        dataclasses.asdict(jt.plan_stencil_tiles(224, 224, 512, 512, k, k, 2, 1 << 20))
