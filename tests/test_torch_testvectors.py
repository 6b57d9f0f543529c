"""tools_torch/print_testvectors.py, the `GPU |` twin of
tools/print_testvectors.py: run on the CPU here, its output equals the
JAX package's tool's line for line once each line's prefix is masked."""

import importlib.util
import os
import re

from tools_torch import print_testvectors as gpu_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masked(text: str, prefix: str) -> list[str]:
    return [re.sub(f"^{prefix} ", "X ", line) for line in text.splitlines()]


def test_gpu_vectors_equal_the_tpu_tools(capsys):
    spec = importlib.util.spec_from_file_location(
        "tpu_print_testvectors", os.path.join(REPO, "tools", "print_testvectors.py"))
    tpu_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tpu_tool)
    assert tpu_tool.main() == 0
    tpu = capsys.readouterr().out
    assert gpu_tool.main(["--device=cpu"]) == 0
    gpu = capsys.readouterr().out
    assert len(gpu.splitlines()) == len(tpu.splitlines()) == 235
    assert _masked(gpu, "GPU") == _masked(tpu, "TPU")
