"""Device kernels: k-mer engine and wavefront Smith-Waterman.

This package replaces the reference's external native binaries
(SURVEY.md §2a): Jellyfish -> ops.kmer (XLA-level by design — see the
kmer module docstring); BLAT's alignment DP -> ops.sw (XLA scan) and
ops.sw_cuda (the GPU kernel).
"""
