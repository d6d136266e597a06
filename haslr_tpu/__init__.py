"""haslr_tpu — a JAX hybrid de novo genome assembler for the GPU.

A from-scratch reimplementation of the capabilities of HASLR (vpc-ccg/haslr):
hybrid assembly of long reads (PacBio/Nanopore) + short reads (Illumina),
redesigned around batched device kernels:

- ``core/``     sequence primitives (2-bit DNA codec, CIGAR algebra, interval
                algorithms), FASTA/PAF/GFA I/O.
- ``kernels/``  device kernels: k-mer counting, the banded alignment DP
                (XLA and a CUDA kernel), and the batched consensus
                engine.
- ``sr/``       short-read side: k-mer counting + de Bruijn contigs
                (replaces minia), overlap trimming (replaces minia_nooverlap),
                read formatting/subsampling (replaces fastutils).
- ``aligner/``  long-read→contig mapper: minimizer index + seed-chain-extend
                with CIGAR output (replaces minimap2).
- ``assemble/`` the core assembler: PAF ingestion and filtering, alignment
                overlap fixing, compact long reads, backbone graph, cleaning,
                edge coordinates, consensus, and final stitching (replaces
                the C++ haslr_assemble).
- ``dist/``     multi-host scaling: device meshes, host-sharded long-read
                streams, psum-merged edge support.
- ``cli/``      the pipeline driver (same stage structure, artifact names and
                resume semantics as the reference bin/haslr.py).

Reference layout: see SURVEY.md at the repository root.
"""

__version__ = "0.1.0"

from haslr_tpu.config import AssembleConfig, PipelineConfig  # noqa: F401
