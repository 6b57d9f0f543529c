"""On the card: each cell of BENCHMARK.json, run by its command for two
seconds, prints a correct result line.  Skips without a CUDA device.

    python3 -m pytest port_bench/tests/test_pb_card.py -m cuda
"""

import json
import subprocess
import sys

import pytest

from port_bench.spec import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cells() -> list[str]:
    return [w["name"] for w in json.load(open(f"{ROOT}/BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", workload,
                          "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu", r
