"""Field definitions: BN254 Fr (bn254.py) and Goldilocks with its two hash
instances (goldilocks.py), plain Python integers.  The port's own copies of
the JAX package's modules of the same names."""
