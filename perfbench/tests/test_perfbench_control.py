"""The control of each cell's comparison: the reference with its products
in the precision below the configuration's, in the program's place, fails
the cell's limits. On the CPU at the tiny configuration here; at the cell's
own size on the card (``card``; ``perfbench/control.py`` runs it on three
seeds or more)."""
import pytest

from perfbench import control
from perfbench.harness import check, configs, registry

from .helpers import need_card, tiny_sizes

CELLS = [c for c in registry.names("workloads")]


def _fails(cell, numbers):
    limits = registry.load_json("workloads", cell)["check"]["limits"]
    return [k for k, limit in limits.items() if numbers[k] > limit]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_tiny(cell):
    numbers = control.readings(cell, 2147483701, "cpu",
                               cfg=tiny_sizes(cell), sample=3)
    assert _fails(cell, numbers), numbers


def test_tf32_rounding():
    import torch

    q = check.round_mantissa(10)
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12])
    assert q(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_on_the_card(cell):
    need_card()
    numbers = control.readings(cell, 2147483702, "cuda")
    assert _fails(cell, numbers), numbers
