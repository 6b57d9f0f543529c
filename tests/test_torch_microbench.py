"""The port's microbenchmark kernels M1-M5 (ops/microbench_plain.py, and
ops/microbench_cuda.py on the CPU) against the TPU kernel bodies of
tools/microbench.py and tools/microbench2.py run by the Pallas interpreter,
bitwise, at one (16, 512) tile with each tool's input recipe (the port's
two tools: tests/test_torch_microbench_tools.py).

The JAX tools are loaded from their files (tools/ is no package); their
kernels run in a bare pallas_call(interpret=True), as tests/test_gl_pallas.py
runs its mini kernels.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from codex_storage_proofs_circuits_tpu_torch.ops import microbench_cuda as MC
from codex_storage_proofs_circuits_tpu_torch.ops import microbench_plain as MP
from tools_torch import microbench as TMB
from tools_torch import microbench2 as TMB2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "tools",
                                                                             f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JMB, JMB2 = _jax_tool("microbench"), _jax_tool("microbench2")

# case: (JAX kernel body, port kernel, input bits of the tool's recipe)
CASES = {
    "mul": (JMB._mul_kernel, MC.mul, 16),
    "add": (JMB._add_kernel, MC.add, 16),
    "mix": (JMB._mix_kernel, MC.mix, 16),
    "ilp4": (JMB2._ilp_kernel(4)[0], lambda a, b: MC.ilp(a, b, 4), 12),
    "ilp8": (JMB2._ilp_kernel(8)[0], lambda a, b: MC.ilp(a, b, 8), 12),
    "conv": (JMB2._conv_kernel, MC.conv, 12),
}


def test_constants_are_the_tools():
    assert (MP.ROWS, MP.COLS, MP.REPS) == (JMB.ROWS, JMB.COLS, JMB.REPS)
    assert (MP.ROWS, MP.COLS, MP.REPS2) == (JMB2.ROWS, JMB2.COLS, JMB2.REPS)
    # the ops an element each tool's rate counts
    assert {k: v[1] * JMB.REPS for k, v in JMB.KERNELS.items()} == {
        k: v[1] for k, v in TMB.KERNELS.items()}
    assert {k: v[2] for k, v in TMB2.ELEM.items()} == {
        "ilp4": JMB2._ilp_kernel(4)[1], "ilp8": JMB2._ilp_kernel(8)[1], "conv": JMB2.REPS}
    assert TMB2.DOTS == {"dot64x32": (64, 32, 64), "dot128x128": (128, 128, 16)}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_jax_interpret(name):
    body, port, bits = CASES[name]
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << bits, size=(MP.ROWS, MP.COLS), dtype=np.uint32)
    b = rng.integers(1, 1 << bits, size=(MP.ROWS, MP.COLS), dtype=np.uint32)
    want = np.asarray(jax.device_get(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((MP.ROWS, MP.COLS), jnp.uint32), interpret=True,
    )(a, b)))
    got = port(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.uint32 and got.shape == (MP.ROWS, MP.COLS)
    np.testing.assert_array_equal(got.numpy(), want)
