"""codex_storage_proofs_circuits_tpu_torch — the PyTorch/CUDA port of the
storage-proof library, for NVIDIA Hopper (H100).

It does what codex_storage_proofs_circuits_tpu does on the BN254 and the
Goldilocks tracks, with torch tensors in place of jax arrays and
hand-written CUDA kernels in place of the Pallas TPU kernels.  Public
functions keep the JAX package's canonical layouts, so the two are compared
array for array:

  * a BN254 field batch is (16, B) int32 planes of 16-bit limbs
    (little-endian); a Poseidon2 state is (3, 16, B); sponge blocks are
    (nb, 2, 16, B); Montgomery form uses R = 2^256;
  * a Goldilocks felt batch is (4, B) int32 planes of 16-bit limbs; a state
    is (12, 4, B), a digest batch (4, 4, B), a felt sequence (n, 4, B).

Layer map:

  fields/   BN254 and Goldilocks constants (plain Python)
  oracle/   the bit-exact pure-Python oracle the port is judged against
  ops/      limb algebra, Poseidon2 (BN254), Poseidon2-GL and Monolith in
            plain torch + CUDA kernel wrappers, byte -> felt encodes,
            fake-data PRNG (plain + CUDA kernel)
  kernels/  nvcc build + ctypes loader for csrc/*.cu
  csrc/     the CUDA C++ kernels (sm_90a)
  native/   the threaded host C library (`--backend=native`, and the
            independent judge of the card's slot roots), built with $CC
  models/   slot trees, streaming slot builds, proof inputs, witness
  utils/    the `cspc-torch` command line, JSON export, circom writer
  convert   state carried across from the JAX package (tables, layers)

fields/, oracle/, models/data.py, models/witness.py, utils/json_export.py,
utils/circom.py and native/ are the port's own copies of the JAX package's
jax-free modules of the same names (native/ generates its constants
headers from the port's fields/).  Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"
