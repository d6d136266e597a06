"""Assembly quality against a simulated ground truth: NG50 and interior
k-mer recall, plus the byte comparison the golden fixtures use."""

from __future__ import annotations

import numpy as np

from haslr_tpu.core import seq as cseq


def ng50(lengths, genome_len: int) -> int:
    """Length of the contig that brings the running total (longest first)
    to half the genome; 0 when the assembly never gets there."""
    half = genome_len / 2
    acc = 0
    for L in sorted(lengths, reverse=True):
        acc += L
        if acc >= half:
            return int(L)
    return 0


def canonical_kmers(seq: str, k: int = 31) -> np.ndarray:
    """Distinct canonical k-mers of ``seq`` as sorted uint64 values
    (2 bits per base, k <= 32)."""
    assert 0 < k <= 32
    codes = cseq.encode(seq).astype(np.uint64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    for i in range(k):
        window = codes[i : i + n]
        fwd = (fwd << np.uint64(2)) | window
        rev |= (np.uint64(3) - window) << np.uint64(2 * i)
    return np.unique(np.minimum(fwd, rev))


def interior_kmer_recall(genome: str, contigs, k: int = 31,
                         margin: int = 1500) -> float:
    """Share of the genome's canonical k-mers, ``margin`` bases in from
    either end, that occur in any contig."""
    want = canonical_kmers(genome[margin : len(genome) - margin], k)
    if len(want) == 0:
        return 1.0
    have = np.unique(
        np.concatenate(
            [canonical_kmers(c, k) for c in contigs]
            or [np.zeros(0, np.uint64)]
        )
    )
    return float(np.isin(want, have, assume_unique=True).mean())


def differing_files(want_dir: str, got_dir: str, names,
                    want_prefix: str = "") -> list[str]:
    """Names whose bytes differ (or are missing) between
    ``want_dir/<want_prefix><name>`` and ``got_dir/<name>``."""
    import os

    out = []
    for name in names:
        a = os.path.join(want_dir, want_prefix + name)
        b = os.path.join(got_dir, name)
        if not (os.path.isfile(a) and os.path.isfile(b)):
            out.append(name)
            continue
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                out.append(name)
    return out
