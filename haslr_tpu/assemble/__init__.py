"""The core assembler: PAF ingest → compact long reads → backbone graph →
cleaning → edge coordinates → consensus → stitching.

Python/numpy/JAX replacement for the reference's C++ ``haslr_assemble``
(``src/haslr_assemble/src/main.cpp``), with the consensus hot loop running
as batched device kernels (see ``haslr_tpu.kernels``).
"""
