"""PLINK 1.x genotype IO (`genomic-data/src/plink.rs` equivalent).

.bed: magic 0x6c 0x1b 0x01 then SNP-major 2-bit codes per variant row
(00=hom A1 -> 2, 01=missing, 10=het -> 1, 11=hom A2 -> 0), padded to
byte per variant. .bim/.fam are TSVs.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class PlinkData:
    genotypes: np.ndarray  # [n_samples, n_variants] dosage of A1, NaN missing
    variant_ids: list[str]
    sample_ids: list[str]
    chrom: np.ndarray
    pos: np.ndarray


_CODE_TO_DOSE = np.asarray([2.0, np.nan, 1.0, 0.0], np.float32)


def read_plink(prefix: str) -> PlinkData:
    bed = Path(prefix + ".bed").read_bytes()
    if bed[:3] != b"\x6c\x1b\x01":
        raise ValueError("not a SNP-major PLINK .bed file")

    bim = [line.split() for line in open(prefix + ".bim") if line.strip()]
    fam = [line.split() for line in open(prefix + ".fam") if line.strip()]
    n_var, n_samp = len(bim), len(fam)
    bytes_per_var = (n_samp + 3) // 4

    raw = np.frombuffer(bed[3:], np.uint8).reshape(n_var, bytes_per_var)
    # unpack 2-bit codes, little-endian within byte
    shifts = np.arange(4) * 2
    codes = (raw[:, :, None] >> shifts[None, None, :]) & 0b11  # [V, B, 4]
    codes = codes.reshape(n_var, -1)[:, :n_samp]
    geno = _CODE_TO_DOSE[codes].T  # [n_samp, n_var]

    return PlinkData(
        genotypes=geno,
        variant_ids=[r[1] for r in bim],
        sample_ids=[r[1] for r in fam],
        chrom=np.asarray([r[0] for r in bim]),
        pos=np.asarray([int(r[3]) for r in bim], np.int64),
    )


def write_plink(prefix: str, genotypes: np.ndarray, variant_ids=None, sample_ids=None):
    """SNP-major .bed + minimal .bim/.fam (fixture writer)."""
    n_samp, n_var = genotypes.shape
    variant_ids = variant_ids or [f"rs{i}" for i in range(n_var)]
    sample_ids = sample_ids or [f"s{i}" for i in range(n_samp)]

    dose_to_code = {2.0: 0, 1.0: 2, 0.0: 3}
    out = bytearray(b"\x6c\x1b\x01")
    for v in range(n_var):
        byte, filled = 0, 0
        for s in range(n_samp):
            g = genotypes[s, v]
            code = 1 if np.isnan(g) else dose_to_code[float(g)]
            byte |= code << (2 * filled)
            filled += 1
            if filled == 4:
                out.append(byte)
                byte, filled = 0, 0
        if filled:
            out.append(byte)
    Path(prefix + ".bed").write_bytes(bytes(out))
    with open(prefix + ".bim", "w") as f:
        for i, vid in enumerate(variant_ids):
            f.write(f"1\t{vid}\t0\t{i + 1}\tA\tG\n")
    with open(prefix + ".fam", "w") as f:
        for sid in sample_ids:
            f.write(f"{sid}\t{sid}\t0\t0\t0\t-9\n")
