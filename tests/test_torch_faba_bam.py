"""faba's BAM layer in the port (`faba/bam.py`, `native/bamreader.cpp`)
against the JAX package's, on the CPU.

Both packages write the same BAM bytes (`write_bam`), read the same
records (`read_bam`, `read_bam_regions`: every column exactly equal) and
build the same `.bai` bytes on BAMs without a 65,536-byte BGZF block.
Ranged reads through the index equal a full scan's overlap filter. Two
faults of the reference are fixed in the port, each with a test here:
a `.bai` older than its BAM is rebuilt before a ranged fetch, and a
record that starts right after a full 65,536-byte block is indexed at
the next block's virtual offset.
"""

import os
import struct

import numpy as np
import pytest

from legume_tpu.faba import bam as jbam
from legume_tpu_torch.faba import bam as tbam

_COLS = ("ref_id", "pos", "end_pos", "flag", "mapq", "cb_id", "umi_id", "has_skip",
         "tail_len", "tail_frac", "gene_id", "mm_ref_id", "mm_pos", "mm_ref_base",
         "mm_read_base", "mm_cb_id", "mm_umi_id", "mm_base_qual", "mm_gene_id")


def _reads(seed=7, n_per=(1500, 700), tails=True):
    """Coordinate-sorted reads over two contigs: MD mismatches, GX tags,
    spliced CIGARs, soft-clipped polyA tails and a few filtered flags."""
    rng = np.random.default_rng(seed)
    reads, i = [], 0
    for rid, n, hi in ((0, n_per[0], 480_000), (1, n_per[1], 190_000)):
        for pos in np.sort(rng.integers(0, hi, size=n)):
            k = i % 5
            cig = ["48M", "20M300N28M", "40M8S" if tails else "48M", "48M", "10S38M"][k]
            seq = "ACGT" * 10 + ("AAAAAAAA" if k == 2 and tails else "ACGTACGT")
            reads.append(dict(
                name=f"r{i}", ref_id=rid, pos=int(pos), seq=seq, cigar=cig,
                cb=f"cell{i % 37}", ub=f"u{i % 91}", md="20A27" if k != 4 else "38",
                gx=f"G{i % 11}", mapq=int(10 + i % 60), flag=[0, 16, 0, 1024, 0][k],
            ))
            i += 1
    return reads


_REFS = [("chr1", 500_000), ("chr2", 200_000)]


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tbam")
    reads = _reads()
    jp, tp = str(tmp / "j.bam"), str(tmp / "t.bam")
    jbam.write_bam(jp, _REFS, reads)
    tbam.write_bam(tp, _REFS, iter(reads))  # a generator streams
    return dict(j=jp, t=tp, tmp=tmp)


def _assert_records_equal(a, b):
    for k in _COLS:
        x, y = getattr(a, k), getattr(b, k)
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.ref_names == b.ref_names and a.barcodes == b.barcodes
    assert a.gene_names == b.gene_names


def test_write_bam_bytes_equal_jax(bams):
    with open(bams["j"], "rb") as f, open(bams["t"], "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kw", [{}, {"gene_tag": "GX"}, {"cb_tag": "CB", "umi_tag": "UB", "chunk": 97}])
def test_read_bam_records_equal_jax(bams, kw):
    _assert_records_equal(tbam.read_bam(bams["t"], **kw), jbam.read_bam(bams["t"], **kw))


def test_header_reads_equal_jax(bams):
    assert tbam.read_bam_ref_names(bams["t"]) == jbam.read_bam_ref_names(bams["t"])
    assert tbam.read_bam_contigs(bams["t"]) == jbam.read_bam_contigs(bams["t"]) == _REFS


def test_bai_bytes_equal_jax(bams):
    tmp = bams["tmp"]
    jbam.build_bam_index(bams["t"], str(tmp / "j.bai"))
    tbam.build_bam_index(bams["t"], str(tmp / "t.bai"))
    assert (tmp / "j.bai").read_bytes() == (tmp / "t.bai").read_bytes()


def _overlap(rec, rid, beg, end):
    return (rec.ref_id == rid) & (rec.pos < end) & (rec.end_pos > beg)


@pytest.mark.parametrize("ref,beg,end", [("chr1", 100_000, 116_000), ("chr1", 0, 1_000),
                                         ("chr1", 479_000, 500_000), ("chr2", 50_000, 50_048),
                                         ("chr2", 0, 200_000)])
def test_region_reads_equal_full_scan_and_jax(bams, ref, beg, end):
    full = tbam.read_bam(bams["t"], gene_tag="GX")
    rid = full.ref_names.index(ref)
    m = _overlap(full, rid, beg, end)
    got = tbam.read_bam(bams["t"], region=(ref, beg, end), gene_tag="GX")
    np.testing.assert_array_equal(got.pos, full.pos[m])
    np.testing.assert_array_equal(got.end_pos, full.end_pos[m])
    assert [got.barcodes[j] for j in got.cb_id] == [full.barcodes[j] for j in full.cb_id[m]]
    assert got.blocks_read <= full.blocks_read
    _assert_records_equal(got, jbam.read_bam(bams["t"], region=(ref, beg, end), gene_tag="GX"))


def test_multi_region_reads_equal_jax(bams):
    windows = [("chr1", 10_000, 30_000), ("chr1", 25_000, 40_000), ("chr2", 100_000, 120_000),
               ("chrBogus", 0, 10), (1, 150_000, 151_000)]
    got = tbam.read_bam_regions(bams["t"], windows)
    _assert_records_equal(got, jbam.read_bam_regions(bams["t"], windows))
    full = tbam.read_bam(bams["t"])
    m = _overlap(full, 0, 10_000, 40_000)
    np.testing.assert_array_equal(got.pos[: m.sum()], full.pos[m])


def test_bad_inputs_raise(tmp_path, bams):
    with pytest.raises(KeyError):
        tbam.read_bam(bams["t"], region=("chrX", 0, 100))
    with pytest.raises(IOError):
        tbam.read_bam(str(tmp_path / "missing.bam"))
    unsorted = str(tmp_path / "unsorted.bam")
    tbam.write_bam(unsorted, [("chr1", 1000)], [
        dict(name="a", ref_id=0, pos=500, seq="ACGT", cigar="4M", cb="c", ub="u1"),
        dict(name="b", ref_id=0, pos=100, seq="ACGT", cigar="4M", cb="c", ub="u2")])
    with pytest.raises(IOError):
        tbam.build_bam_index(unsorted)
    with pytest.raises(ValueError):
        tbam.write_bam(unsorted, [("chr1", 1000)], [], block_size=70_000)


def _rewrite_after_index(path, index):
    """A small BAM indexed, then rewritten with more reads; the index is
    left older than the BAM."""
    tbam.write_bam(path, _REFS, _reads(seed=1, n_per=(300, 100)))
    index(path)
    tbam.write_bam(path, _REFS, _reads(seed=2, n_per=(1500, 50)))
    t = os.path.getmtime(path)
    os.utime(path + ".bai", (t - 10, t - 10))


def test_stale_index_is_rebuilt(tmp_path):
    """Fault fix 1. A BAM rewritten after its `.bai`: the port rebuilds
    the index before a ranged fetch and returns the new file's records.
    The JAX package reuses the stale index (the reference fault,
    recorded, not asserted)."""
    window = ("chr1", 0, 480_000)
    path = str(tmp_path / "x.bam")
    _rewrite_after_index(path, tbam.build_bam_index)
    full = tbam.read_bam(path)
    m = _overlap(full, 0, *window[1:])
    np.testing.assert_array_equal(tbam.read_bam(path, region=window).pos, full.pos[m])
    assert os.path.getmtime(path + ".bai") >= os.path.getmtime(path)
    _rewrite_after_index(path, tbam.build_bam_index)
    np.testing.assert_array_equal(tbam.read_bam_regions(path, [window]).pos, full.pos[m])
    jpath = str(tmp_path / "j.bam")
    _rewrite_after_index(jpath, jbam.build_bam_index)
    try:
        n = len(jbam.read_bam(jpath, region=window).pos)
        outcome = f"{n} of {int(m.sum())} records"
    except IOError as e:
        outcome = f"IOError ({e})"
    print(f"JAX package on a stale .bai: {outcome}")


def _record_size(r) -> int:
    """Bytes of one BAM record as `write_bam` lays it out (block_size
    word included)."""
    n_cig = len([c for c in r["cigar"] if c.isalpha()])
    tags = sum(3 + len(r[k]) + 1 for k in ("cb", "ub") if k in r)
    seq = len(r["seq"])
    return 4 + 32 + len(r["name"]) + 1 + 4 * n_cig + (seq + 1) // 2 + seq + tags


def _header_size(refs) -> int:
    text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs).encode()
    return 4 + 4 + len(text) + 4 + sum(4 + len(n) + 1 + 4 for n, _ in refs)


def _full_block_bam(path):
    """A BAM whose first BGZF block holds exactly 65,536 bytes and ends
    where chr1's records end: the last chr1 read's name is sized so that
    the records end at byte 65,536 of the stream. The first chr2 record
    then opens the second block and starts a new chunk of the index."""
    reads = _reads(seed=5, n_per=(1200, 300), tails=False)
    for r in reads:
        r.pop("md"), r.pop("gx")
    chr1 = [r for r in reads if r["ref_id"] == 0]
    chr2 = [r for r in reads if r["ref_id"] == 1]
    off = _header_size(_REFS)
    i = 0
    while (1 << 16) - off - _record_size(dict(chr1[i], name="")) > 200:
        off += _record_size(chr1[i])
        i += 1
    filler = dict(chr1[i])
    filler["name"] = "f" * ((1 << 16) - off - _record_size(dict(filler, name="")))
    assert 1 <= len(filler["name"]) < 255
    reads = chr1[:i] + [filler] + chr2
    tbam.write_bam(path, _REFS, reads, block_size=1 << 16)
    return reads, i + 1


def _block_starts(path) -> set[int]:
    out, off, data = set(), 0, open(path, "rb").read()
    while off < len(data):
        out.add(off)
        off += struct.unpack("<H", data[off + 16 : off + 18])[0] + 1
    return out


def _chunk_begs(bai) -> list[int]:
    data, off, begs = open(bai, "rb").read(), 8, []
    (n_ref,) = struct.unpack("<i", data[4:8])
    for _ in range(n_ref):
        (nb,) = struct.unpack("<i", data[off : off + 4])
        off += 4
        for _ in range(nb):
            _, nc = struct.unpack("<Ii", data[off : off + 8])
            off += 8
            for _ in range(nc):
                beg, end = struct.unpack("<QQ", data[off : off + 16])
                begs.append(beg)
                assert end >= beg
                off += 16
        (ni,) = struct.unpack("<i", data[off : off + 4])
        off += 4 + 8 * ni
    return begs


def test_full_block_offsets_are_valid_and_regions_equal_full_scan(tmp_path):
    """Fault fix 2. The record after a full 65,536-byte block starts at
    the next block's (offset << 16) | 0: every chunk of the port's `.bai`
    begins at a real block, and every window read through it equals the
    full scan. The JAX package ORs 65,536 into the in-block offset and
    names a byte that starts no block (recorded, not asserted)."""
    path = str(tmp_path / "full.bam")
    reads, boundary = _full_block_bam(path)
    starts = _block_starts(path)
    assert len(starts) >= 3
    full = tbam.read_bam(path)
    assert len(full.pos) == len(reads)
    tbam.build_bam_index(path)
    begs = _chunk_begs(path + ".bai")
    assert all((b >> 16) in starts and (b & 0xFFFF) < 1 << 16 for b in begs)
    pos_b = reads[boundary]["pos"]
    assert reads[boundary]["ref_id"] == 1
    for ref, beg, end in [("chr2", pos_b, pos_b + 1), ("chr2", 0, 200_000),
                          ("chr1", 470_000, 480_000), ("chr1", 0, 480_000)]:
        got = tbam.read_bam(path, region=(ref, beg, end))
        m = _overlap(full, _REFS.index(next(x for x in _REFS if x[0] == ref)), beg, end)
        np.testing.assert_array_equal(got.pos, full.pos[m])
        assert [got.barcodes[j] for j in got.cb_id] == [full.barcodes[j] for j in full.cb_id[m]]
    jbai = str(tmp_path / "j.bam")
    with open(path, "rb") as f, open(jbai, "wb") as g:
        g.write(f.read())
    jbam.build_bam_index(jbai)
    jbad = [b for b in _chunk_begs(jbai + ".bai") if (b >> 16) not in starts]
    try:
        n = len(jbam.read_bam(jbai, region=("chr2", 0, 200_000)).pos)
        outcome = f"{n} of {int(_overlap(full, 1, 0, 200_000).sum())} chr2 records"
    except IOError as e:
        outcome = f"IOError ({e})"
    print(f"JAX package: {len(jbad)} .bai chunks start at no block; its chr2 fetch: {outcome}")


def test_blocks_read_counts_blocks_with_a_header(bams):
    """`blocks_read` counts the blocks whose header was read: a full scan
    reads every block of the file once (the EOF probe is not a block)."""
    rec = tbam.read_bam(bams["t"])
    assert rec.blocks_read == len(_block_starts(bams["t"]))
