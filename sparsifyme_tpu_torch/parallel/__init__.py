"""Sharded 2:4 SpMMs over a mesh of ranks (devices), and the ring kernel
K7. Counterpart of ``sparsifyme_tpu.parallel``."""
