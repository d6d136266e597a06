"""Device kernels: the numeric engines of the assembler.

- ``nw``           batched banded Needleman-Wunsch alignment DP (wavefront
                   oracle)
- ``nw_rowscan``   the production row-scan DP (consensus and extension)
- ``rowscan_gpu``  the row-scan DP as a CUDA kernel for Hopper
- ``consensus``    batched align-to-draft + weighted pileup consensus
- ``kmer``         k-mer counting (short-read side)

Every kernel has a pure-JAX path that runs on the CPU (used by the test
suite on the virtual device mesh); the CUDA kernel replaces it on the GPU
at the shapes ``nw_rowscan.kernel_applies`` names.
"""
