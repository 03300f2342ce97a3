"""On a card, at each cell's own size: the control (the plain reference
in the system's place, its float32 products in TF32) must come out not
correct by the cell's own comparison and limits."""

from __future__ import annotations

import pytest

from benchmark import common

CELLS = [w["name"] for w in common.load_json(
    common.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_comparison(name, cuda_device):
    from benchmark import control
    got = control.readings(name, 2 ** 31 + 101)
    limits = common.load_cell(name).limits
    read = {k: v for k, v in got.items() if k in limits}
    assert read, (got, limits)
    assert any(v is None or v > limits[k] for k, v in read.items()), (
        got, limits)
