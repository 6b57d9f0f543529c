"""codex_storage_proofs_circuits_tpu_torch — the PyTorch/CUDA port of the
storage-proof library, for NVIDIA Hopper (H100).

It does what codex_storage_proofs_circuits_tpu does on the BN254 track,
with torch tensors in place of jax arrays and hand-written CUDA kernels in
place of the Pallas TPU kernels.  Public functions keep the JAX package's
canonical layouts, so the two are compared array for array:

  * a field batch is (16, B) int32 planes of 16-bit limbs (little-endian);
  * a Poseidon2 state is (3, 16, B); sponge blocks are (nb, 2, 16, B);
  * Montgomery form uses R = 2^256.

Layer map:

  ops/      limb algebra, Poseidon2 (plain torch + CUDA kernel wrappers),
            byte -> felt encoding, fake-data PRNG (plain + CUDA kernel)
  kernels/  nvcc build + ctypes loader for csrc/*.cu
  csrc/     the CUDA C++ kernels (sm_90a)
  models/   slot trees, streaming slot builds, proof inputs
  utils/    the `cspc-torch` command line
  convert   state carried across from the JAX package (tables, layers)

The jax-free modules of the JAX package (fields/, oracle/, models/data.py,
models/witness.py, utils/json_export.py, utils/circom.py) are shared as
they are.  Nothing here imports jax.
"""

__version__ = "0.1.0"
