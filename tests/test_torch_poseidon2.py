"""Port Poseidon2 (plain torch and the K1/K2 kernel wrappers) against the
JAX package's plain reference ops/poseidon2_jnp.py, the oracle and the KAT.

All comparisons are bit-exact.  The JAX functions run jitted at one width
(B = 8) to bound XLA:CPU compile time; the Pallas kernels themselves are
held by the JAX package's own tests.  The kernels against the plain
versions: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.fields import bn254 as F
from codex_storage_proofs_circuits_tpu.ops import poseidon2_jnp as JP
from codex_storage_proofs_circuits_tpu.oracle import poseidon2 as OP
from codex_storage_proofs_circuits_tpu_torch import convert
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as TC
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_plain as TP

B = 8
NFELTS = 5  # odd: exercises the (1, 0) felt padding


def _felts(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n)]


@pytest.fixture(scope="module")
def states():
    """(3, 16, B) Montgomery states: the KAT input first, then random."""
    rng = np.random.default_rng(31)
    triples = [F.PERMUTATION_KAT_INPUT, (0, 0, 0), (F.P - 1,) * 3] + [
        tuple(_felts(rng, 3)) for _ in range(B - 3)
    ]
    state = torch.stack(
        [TL.pack([F.to_mont(t[i]) for t in triples]) for i in range(3)]
    )
    return triples, state


@pytest.fixture(scope="module")
def sponge_inputs():
    rng = np.random.default_rng(32)
    cols = [_felts(rng, NFELTS) for _ in range(B)]
    felts = torch.stack([TL.pack([F.to_mont(c[k]) for c in cols]) for k in range(NFELTS)])
    return cols, felts


def _from_mont_ints(planes):
    return [F.from_mont(v) for v in TL.unpack(planes)]


def test_tables_match_jax_via_convert():
    tables = convert.tables_from_numpy(
        JP.EXT_RC_MONT, JP.INT_RC_MONT, JP.KEY_MONT, JP.SPONGE2_IV_MONT, JP.ONE_MONT
    )
    assert torch.equal(tables["ext_rc"], TP.EXT_RC_MONT)
    assert torch.equal(tables["int_rc"], TP.INT_RC_MONT)
    assert torch.equal(tables["keys"], TP.KEY_MONT)
    assert torch.equal(tables["iv2"], TP.SPONGE2_IV_MONT)
    assert torch.equal(tables["one"], TP.ONE_MONT)


def test_permutation_kat_and_oracle(states):
    triples, state = states
    out = TP.permutation(state)
    assert out.dtype == torch.int32 and out.shape == state.shape
    outs = [_from_mont_ints(out[i]) for i in range(3)]
    got = [tuple(outs[i][j] for i in range(3)) for j in range(B)]
    assert got[0] == F.PERMUTATION_KAT_OUTPUT
    assert got == [OP.permutation(t) for t in triples]


def test_permutation_matches_jax(states):
    _, state = states
    want = np.asarray(jax.jit(JP.permutation)(jnp.asarray(state.numpy(), jnp.uint32)))
    assert np.array_equal(TP.permutation(state).numpy(), want.astype(np.int32))


def test_sponge2_matches_jax_and_oracle(sponge_inputs):
    cols, felts = sponge_inputs
    got = TP.sponge2_hash(felts)
    want = np.asarray(jax.jit(JP.sponge2_hash)(jnp.asarray(felts.numpy(), jnp.uint32)))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert _from_mont_ints(got) == [OP.sponge2(c) for c in cols]


def test_compress_matches_oracle(states):
    _, state = states
    xs, ys = (_from_mont_ints(state[i]) for i in range(2))
    for key in (0, 3):
        got = _from_mont_ints(TP.compress(state[0], state[1], TP.KEY_MONT[key]))
        assert got == [OP.keyed_compression(key, x, y) for x, y in zip(xs, ys)]


def test_wrappers_on_cpu_take_the_plain_versions(states, sponge_inputs):
    _, state = states
    _, felts = sponge_inputs
    before = dict(build.LAUNCHES)
    assert torch.equal(TC.permutation(state), TP.permutation(state))
    layer = state[0]  # (16, B): even and odd columns pair up
    assert torch.equal(
        TC.compress_layer(layer[:, 0::2], layer[:, 1::2], 1),
        TP.compress(layer[:, 0::2], layer[:, 1::2], TP.KEY_MONT[1]),
    )
    blocks = TP.pad_felts_rate2(felts)
    assert torch.equal(TC.sponge2_absorb(blocks), TP.sponge2_absorb(blocks))
    assert build.LAUNCHES == before  # nothing launched


def test_constants_header_matches_fields():
    hdr = build.constants_header()
    assert "#define FR_PINV 0xefffffffu" in hdr
    assert (-pow(F.P, -1, 1 << 32)) % (1 << 32) == 0xEFFFFFFF
    def words(x):
        return ", ".join(f"0x{(x >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(8))

    assert f"#define FR_P_WORDS {{{words(F.P)}}}" in hdr
    assert f"#define FR_2P_WORDS {{{words(2 * F.P)}}}" in hdr
    assert f"#define FR_ONE_WORDS {{{words(F.to_mont(1))}}}" in hdr
    assert f"#define FR_R2_WORDS {{{words(F.R2_MONT)}}}" in hdr
    assert F.R2_MONT == (1 << 512) % F.P
    assert hdr.count("0x") == 1 + 4 * 8 + 8 * 3 * 8 + 56 * 8 + 4 * 8 + 8
