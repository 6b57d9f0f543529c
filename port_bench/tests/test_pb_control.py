"""The control (port_bench/control.py) at a size the CPU runs: the
reference in the program's place, with one guarantee broken, is not
correct; on the chip it runs at each cell's own size."""

import pytest

from port_bench import control
from port_bench.tests.tiny import SEED, tiny_spec

CELLS = {
    "codex-bn254-p2.commit-dev-1g": "node_mismatches",
    "codex-gl-p2.commit-dev-1g": "node_mismatches",
    "codex-gl-p2.commit-host-1g": "node_mismatches",
    "codex-bn254-p2.prove-fresh-4x256m": "cell_mismatches",
}


@pytest.mark.parametrize("workload", list(CELLS))
def test_the_control_is_not_correct(workload):
    out = control.run_control(tiny_spec(workload), SEED, "cpu")
    assert out["correct"] is False
    c = out["checks"][CELLS[workload]]
    assert c["value"] > c["limit"]
