"""The port's microbenchmark tools (tools_torch/microbench.py,
tools_torch/microbench2.py) on the CPU: each runs its plain versions at the
JAX tools' full shapes, exits 0 and prints a line a kernel; an unknown
kernel name exits non-zero naming it, and --device=cuda without a card
exits non-zero."""

import os
import subprocess
import sys

import pytest
import torch

from tools_torch import microbench as TMB
from tools_torch import microbench2 as TMB2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tools_on_the_cpu():
    # one torch thread a tool: the suite runs several workers at once, and a
    # thread a core each oversubscribes the host (the plain M1 took 64 s
    # under the suite's load against 2.7 s on an idle host, near the limit)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    for argv, labels in ((["tools_torch.microbench", "--device=cpu", "mul"], ["mul:"]),
                         (["tools_torch.microbench2", "--device=cpu", "conv", "dot64x32"],
                          ["u32<->f32 conv:", "dot (64,32):"])):
        r = subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        lines = r.stdout.splitlines()
        assert [line.split(" ")[0] for line in lines] == [lab.split(" ")[0] for lab in labels]
        assert all(line.startswith(lab) and "(cpu: the plain version, host clock)" in line
                   for line, lab in zip(lines, labels))


def test_tools_refuse_unknown_names_and_a_missing_card(capsys):
    for main, name in ((TMB.main, "montstep"), (TMB2.main, "dotmix")):
        with pytest.raises(SystemExit) as e:
            main(["--device=cpu", name])
        assert e.value.code != 0
        assert repr(name) in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device=cuda runs")
    for main in (TMB.main, TMB2.main):
        with pytest.raises(SystemExit) as e:
            main(["mul"] if main is TMB.main else ["conv"])
        assert e.value.code not in (0, None)
