"""The port's M6 (ops/microbench_plain.dot, and ops/microbench_cuda.dot on
the CPU) against the TPU kernel body of tools/microbench2.py
(`_dot_kernel_factory`) run by the Pallas interpreter, at one 512-column
tile of the tool's shapes, (64, 32) with 64 products and (128, 128) with
16, and both against a float64 sum of the same bf16 products.

Tolerance, relative 2.5e-4 elementwise: n_dots x K = 2048 float32
roundings of at most 2^-24 each (1.2e-4), times 2 for the order of the
sums.  One more case pins the bf16 step A = bf16(A + 1), round to nearest
even: a column at 255 reaches 256 and stays there (257 rounds to 256).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from codex_storage_proofs_circuits_tpu_torch.ops import microbench_cuda as MC
from codex_storage_proofs_circuits_tpu_torch.ops import microbench_plain as MP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 2.5e-4


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_microbench2", os.path.join(REPO, "tools", "microbench2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JMB2 = _jax_tool()


def _jax_dot(a: np.ndarray, w: np.ndarray, n_dots: int) -> np.ndarray:
    m, k = w.shape
    body = JMB2._dot_kernel_factory(n_dots, K=k, M=m)
    out = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((m, a.shape[1]), jnp.float32),
                         interpret=True)(jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    return np.asarray(jax.device_get(out))


def _float64_sum(a: np.ndarray, w: np.ndarray, n_dots: int) -> np.ndarray:
    """sum over n_dots of W @ A_d in float64, A_{d+1} = bf16(A_d + 1)
    (ml_dtypes' round to nearest even)."""
    a = a.astype(ml_dtypes.bfloat16)
    w64 = w.astype(ml_dtypes.bfloat16).astype(np.float64)
    acc = np.zeros((w.shape[0], a.shape[1]), np.float64)
    for _ in range(n_dots):
        acc += w64 @ a.astype(np.float64)
        a = (a.astype(np.float32) + 1).astype(ml_dtypes.bfloat16)
    return acc


def _port(a: np.ndarray, w: np.ndarray, n_dots: int) -> np.ndarray:
    got = MC.dot(torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16),
                 n_dots)
    assert got.dtype == torch.float32
    return got.numpy()


def _within(got: np.ndarray, want: np.ndarray) -> bool:
    return got.shape == want.shape and bool((np.abs(got - want) <= RTOL * np.abs(want)).all())


@pytest.mark.parametrize("m,k,n_dots", [(64, 32, 64), (128, 128, 16)])
def test_dot_matches_jax_interpret(m, k, n_dots):
    rng = np.random.default_rng(0)  # the tool's recipe, one tile
    a = rng.integers(0, 256, size=(k, MP.COLS)).astype(np.float32)
    w = rng.integers(0, 256, size=(m, k)).astype(np.float32)
    want = _jax_dot(a, w, n_dots)
    got = _port(a, w, n_dots)
    ref = _float64_sum(a, w, n_dots)
    assert _within(got, want)
    assert _within(got, ref) and _within(want, ref)
    assert np.array_equal(got, MP.dot(torch.from_numpy(a).to(torch.bfloat16),
                                      torch.from_numpy(w).to(torch.bfloat16), n_dots).numpy())


def test_bf16_step_rounds_to_nearest_even():
    # columns at 255, 254 and 0 with W all ones (64, 32): after 4 products
    # each column's sum is 32 x (255 + 256 + 256 + 256), 32 x (254 + 255 +
    # 256 + 256) and 32 x (0 + 1 + 2 + 3); rounding 257 up would give 258
    a = np.zeros((32, MP.COLS), np.float32)
    a[:, 0], a[:, 1] = 255, 254
    w = np.ones((64, 32), np.float32)
    want = np.zeros((64, MP.COLS), np.float32)
    want[:, 0], want[:, 1], want[:, 2:] = 32 * 1023, 32 * 1021, 32 * 6
    np.testing.assert_array_equal(_port(a, w, 4), want)
    np.testing.assert_array_equal(_jax_dot(a, w, 4), want)
    np.testing.assert_array_equal(_float64_sum(a, w, 4), want)
