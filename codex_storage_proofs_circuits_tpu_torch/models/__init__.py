"""Slot trees, streaming slot builds and proof inputs on torch tensors."""
