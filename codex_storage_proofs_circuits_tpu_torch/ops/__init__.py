"""Batched field, hash, encode and PRNG ops on torch tensors."""
