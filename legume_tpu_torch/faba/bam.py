"""BAM access for faba (the port's copy of the JAX package's
`faba/bam.py`, over its own `native/bamreader.cpp`).

The native reader implements BGZF + BAM directly against zlib and
streams records as columnar chunks over a C ABI (ctypes). It is built
at first use with `g++ -O2 -shared -fPIC -std=c++17 ... -lz` into the
git-ignored `legume_tpu_torch/_build/`, named by the source's hash.
There is no Python reader: a failed build raises. `write_bam` is a
pure-Python BGZF/BAM writer for fixtures and simulators.

Two faults of the reference are fixed here: a `.bai` older than its BAM
is rebuilt before a ranged fetch (`_fresh_index`, htslib's mtime check),
and a record that starts right after a full 65,536-byte BGZF block gets
the next block's virtual offset (`tell_voffset` in the native source).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "bamreader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def _build_native() -> Path:
    """The shared object for the current source, compiled if missing."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libbamreader_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o",
                            str(tmp), "-lz"], capture_output=True)
        if r.returncode != 0:
            raise RuntimeError(f"cannot build the BAM reader {_SRC}: "
                               f"{r.stderr.decode(errors='replace')[:500]}")
        tmp.replace(so)
    return so


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build_native()))
        lib.bam_open.restype = ctypes.c_void_p
        lib.bam_open.argtypes = [ctypes.c_char_p]
        lib.bam_num_refs.argtypes = [ctypes.c_void_p]
        lib.bam_ref_name.restype = ctypes.c_char_p
        lib.bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bam_next_chunk.restype = ctypes.c_long
        lib.bam_next_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            *(np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS") for dt in
              (np.int32, np.int32, np.int32, np.uint16, np.uint8, np.int64, np.int64)),
        ]
        lib.bam_next_chunk2.restype = ctypes.c_long
        lib.bam_next_chunk2.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            *(np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS") for dt in
              (np.int32, np.int32, np.int32, np.uint16, np.uint8, np.int64,
               np.int64, np.uint8)),
        ]
        lib.bam_next_chunk3.restype = ctypes.c_long
        lib.bam_next_chunk3.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            *(np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS") for dt in
              (np.int32, np.int32, np.int32, np.uint16, np.uint8, np.int64,
               np.int64, np.uint8, np.uint16, np.uint8)),
        ]
        lib.bam_next_chunk4.restype = ctypes.c_long
        lib.bam_next_chunk4.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            *(np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS") for dt in
              (np.int32, np.int32, np.int32, np.uint16, np.uint8, np.int64,
               np.int64, np.uint8, np.uint16, np.uint8, np.int64)),
        ]
        lib.bam_set_gene_tag.restype = None
        lib.bam_set_gene_tag.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.bam_num_genes.restype = ctypes.c_long
        lib.bam_num_genes.argtypes = [ctypes.c_void_p]
        lib.bam_gene_name.restype = ctypes.c_char_p
        lib.bam_gene_name.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.bam_take_mismatches.restype = ctypes.c_long
        lib.bam_take_mismatches.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            *(np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS") for dt in
              (np.int32, np.int32, np.uint8, np.uint8, np.int64, np.int64,
               np.uint8)),
        ]
        lib.bam_take_mismatches2.restype = ctypes.c_long
        lib.bam_take_mismatches2.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            *(np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS") for dt in
              (np.int32, np.int32, np.uint8, np.uint8, np.int64, np.int64,
               np.uint8, np.int64)),
        ]
        lib.bam_num_barcodes.restype = ctypes.c_long
        lib.bam_num_barcodes.argtypes = [ctypes.c_void_p]
        lib.bam_barcode.restype = ctypes.c_char_p
        lib.bam_barcode.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.bam_load_index.restype = ctypes.c_int
        lib.bam_load_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.bam_set_region.restype = ctypes.c_int
        lib.bam_set_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ]
        lib.bam_build_index.restype = ctypes.c_int
        lib.bam_build_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.bam_blocks_read.restype = ctypes.c_long
        lib.bam_blocks_read.argtypes = [ctypes.c_void_p]
        lib.bam_close.argtypes = [ctypes.c_void_p]
        lib.bam_set_tags.restype = None
        lib.bam_set_tags.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ]
        _lib = lib
    return _lib


@dataclass
class BamRecords:
    """Columnar read table: one row per alignment record."""

    ref_id: np.ndarray  # int32
    pos: np.ndarray  # int32 0-based start
    end_pos: np.ndarray  # int32 reference end (CIGAR span)
    flag: np.ndarray  # uint16
    mapq: np.ndarray  # uint8
    cb_id: np.ndarray  # int64 interned cell barcode (-1 = none)
    umi_id: np.ndarray  # int64 interned UMI (-1 = none)
    ref_names: list[str]
    barcodes: list[str]
    has_skip: np.ndarray | None = None  # uint8: CIGAR N op (spliced junction)
    # aligner-assigned gene keying (CellRanger GX; gene_barcode_tag):
    # interned id per record (-1 = untagged), names in gene_names
    gene_id: np.ndarray | None = None  # int64
    gene_names: list[str] | None = None
    # polyA-tail evidence (bam_next_chunk3): terminal soft-clip length
    # + its A/T fraction scaled by 255
    tail_len: np.ndarray | None = None  # uint16
    tail_frac: np.ndarray | None = None  # uint8
    # reference mismatches from MD tags (dartseq/editing paths)
    mm_ref_id: np.ndarray | None = None
    mm_pos: np.ndarray | None = None
    mm_ref_base: np.ndarray | None = None  # ASCII codes
    mm_read_base: np.ndarray | None = None
    mm_cb_id: np.ndarray | None = None
    mm_umi_id: np.ndarray | None = None
    mm_base_qual: np.ndarray | None = None  # phred at the read base
    mm_gene_id: np.ndarray | None = None  # gene tag of the read (-1 = none)
    # BGZF blocks decompressed serving this read (I/O-skip diagnostic:
    # ranged fetch should touch O(overlapping blocks), not O(file))
    blocks_read: int = 0


def read_bam_ref_names(path: str) -> list[str]:
    """Header-only contig-name read — opens the BAM, reads the
    reference dictionary, and closes without streaming any records
    (the full parse including mismatch extraction costs seconds per
    pass; callers that only need `ref_names` should use this)."""
    lib = _load()
    h = lib.bam_open(str(path).encode())
    if not h:
        raise IOError(f"cannot open BAM: {path}")
    try:
        return [lib.bam_ref_name(h, i).decode() for i in range(lib.bam_num_refs(h))]
    finally:
        lib.bam_close(h)


def read_bam_contigs(path: str) -> list[tuple[str, int]]:
    """Header-only (contig name, length) pairs — the BAM reference
    dictionary carries lengths, so VCF contig headers need no .fai."""
    lib = _load()
    h = lib.bam_open(str(path).encode())
    if not h:
        raise IOError(f"cannot open BAM: {path}")
    try:
        return [
            (lib.bam_ref_name(h, i).decode(), int(lib.bam_ref_len(h, i)))
            for i in range(lib.bam_num_refs(h))
        ]
    finally:
        lib.bam_close(h)


def _drain_records(lib, h, chunk: int, cols: dict, path) -> None:
    """Stream bam_next_chunk4 until EOF (or region exhaustion),
    appending each chunk's columnar arrays into `cols`."""
    while True:
        rid = np.empty(chunk, np.int32)
        pos = np.empty(chunk, np.int32)
        end = np.empty(chunk, np.int32)
        flag = np.empty(chunk, np.uint16)
        mapq = np.empty(chunk, np.uint8)
        cb = np.empty(chunk, np.int64)
        umi = np.empty(chunk, np.int64)
        skip = np.empty(chunk, np.uint8)
        t_len = np.empty(chunk, np.uint16)
        t_frac = np.empty(chunk, np.uint8)
        gx = np.empty(chunk, np.int64)
        n = lib.bam_next_chunk4(
            h, chunk, rid, pos, end, flag, mapq, cb, umi, skip, t_len,
            t_frac, gx,
        )
        if n < 0:
            raise IOError(f"BAM parse error in {path}")
        if n == 0:
            break
        cols["ref_id"].append(rid[:n].copy())
        cols["pos"].append(pos[:n].copy())
        cols["end_pos"].append(end[:n].copy())
        cols["flag"].append(flag[:n].copy())
        cols["mapq"].append(mapq[:n].copy())
        cols["cb"].append(cb[:n].copy())
        cols["umi"].append(umi[:n].copy())
        cols["skip"].append(skip[:n].copy())
        cols["tail_len"].append(t_len[:n].copy())
        cols["tail_frac"].append(t_frac[:n].copy())
        cols["gene"].append(gx[:n].copy())


def bai_path_for(path: str) -> str:
    """Companion index path: `<bam>.bai` (the htslib convention)."""
    return str(path) + ".bai"


def _fresh_index(path: str) -> str:
    """The BAM's `.bai`, built when missing or older than the BAM (a BAM
    rewritten after its index would otherwise be fetched through stale
    offsets)."""
    bai = bai_path_for(path)
    if not os.path.exists(bai) or os.path.getmtime(bai) < os.path.getmtime(path):
        build_bam_index(path, bai)
    return bai


def build_bam_index(path: str, bai_path: str | None = None) -> str:
    """Build a `.bai` for a coordinate-sorted BAM (the `samtools index`
    equivalent; the reference requires prebuilt indices —
    faba/src/m6a/run.rs:660-675 `check_all_bam_indices`). One native
    streaming pass; returns the index path."""
    lib = _load()
    out = bai_path or bai_path_for(path)
    if lib.bam_build_index(str(path).encode(), out.encode()) != 0:
        raise IOError(f"cannot index BAM (missing/corrupt/unsorted?): {path}")
    return out


def read_bam(
    path: str, *, chunk: int = 1 << 16, cb_tag: str = "CB", umi_tag: str = "UB",
    gene_tag: str | None = None,
    region: tuple[str | int, int, int] | None = None,
) -> BamRecords:
    """Stream the whole BAM into columnar arrays. `cb_tag`/`umi_tag`
    select the barcode Z tags (DartSeqCountArgs cell_barcode_tag;
    10x defaults). `gene_tag` (e.g. "GX", DartSeqCountArgs
    gene_barcode_tag; faba/src/m6a/run.rs:23-540) additionally interns
    the aligner-assigned gene tag per record into `gene_id`/
    `gene_names` — the CellRanger-conformant gene keying that GFF
    overlap cannot reproduce on multi-overlap reads.

    `region=(ref, beg, end)` (0-based half-open; ref by name or id)
    fetches only records overlapping the window via the `.bai` index —
    BGZF virtual-offset seeks, O(overlapping blocks) instead of
    O(file) (the rust-htslib `fetch` path the reference's per-gene
    loops use). Builds the index on first use if absent or older than
    the BAM."""
    lib = _load()
    h = lib.bam_open(str(path).encode())
    if not h:
        raise IOError(f"cannot open BAM: {path}")
    if cb_tag != "CB" or umi_tag != "UB":
        lib.bam_set_tags(h, cb_tag.encode(), umi_tag.encode())
    if gene_tag:
        lib.bam_set_gene_tag(h, gene_tag.encode())
    if region is not None:
        bai = _fresh_index(path)
        if lib.bam_load_index(h, bai.encode()) != 0:
            lib.bam_close(h)
            raise IOError(f"cannot parse BAM index: {bai}")
        ref, beg, end = region
        if isinstance(ref, str):
            names = [
                lib.bam_ref_name(h, i).decode()
                for i in range(lib.bam_num_refs(h))
            ]
            if ref not in names:
                lib.bam_close(h)
                raise KeyError(f"unknown reference {ref!r} in {path}")
            ref = names.index(ref)
        if lib.bam_set_region(h, int(ref), int(beg), int(end)) != 0:
            lib.bam_close(h)
            raise IOError(f"cannot set region on {path}")
    try:
        refs = [lib.bam_ref_name(h, i).decode() for i in range(lib.bam_num_refs(h))]
        cols = {
            k: []
            for k in ("ref_id", "pos", "end_pos", "flag", "mapq", "cb", "umi",
                      "skip", "tail_len", "tail_frac", "gene")
        }
        _drain_records(lib, h, chunk, cols, path)
        return _finish_records(lib, h, chunk, cols, refs, gene_tag, path)
    finally:
        lib.bam_close(h)


def read_bam_regions(
    path: str,
    regions: "list[tuple[str | int, int, int]]",
    *,
    chunk: int = 1 << 16,
    cb_tag: str = "CB",
    umi_tag: str = "UB",
    gene_tag: str | None = None,
) -> BamRecords:
    """Ranged fetch over MANY windows on one handle (the reference's
    per-gene `fetch` loop, faba/src/m6a/run.rs:660-675): one `.bai`
    load, one barcode/UMI interning table across all windows, one
    virtual-offset seek per merged window. Overlapping/adjacent query
    windows are merged per chromosome first, so each record is
    returned once per MERGED window it overlaps (a read spanning two
    disjoint windows appears twice — callers that need uniqueness
    dedup on (ref, pos, cb, umi), as depth_per_region does)."""
    lib = _load()
    h = lib.bam_open(str(path).encode())
    if not h:
        raise IOError(f"cannot open BAM: {path}")
    if cb_tag != "CB" or umi_tag != "UB":
        lib.bam_set_tags(h, cb_tag.encode(), umi_tag.encode())
    if gene_tag:
        lib.bam_set_gene_tag(h, gene_tag.encode())
    try:
        bai = _fresh_index(path)
        if lib.bam_load_index(h, bai.encode()) != 0:
            raise IOError(f"cannot parse BAM index: {bai}")
        refs = [lib.bam_ref_name(h, i).decode() for i in range(lib.bam_num_refs(h))]
        rmap = {n: i for i, n in enumerate(refs)}
        # resolve names, drop unknown contigs, merge per-ref windows
        by_ref: dict[int, list[list[int]]] = {}
        for ref, beg, end in regions:
            rid = rmap.get(ref) if isinstance(ref, str) else int(ref)
            if rid is None or not (0 <= rid < len(refs)) or end <= beg:
                continue
            by_ref.setdefault(rid, []).append([int(beg), int(end)])
        cols = {
            k: []
            for k in ("ref_id", "pos", "end_pos", "flag", "mapq", "cb", "umi",
                      "skip", "tail_len", "tail_frac", "gene")
        }
        for rid in sorted(by_ref):
            spans = sorted(by_ref[rid])
            merged = [spans[0]]
            for s, e in spans[1:]:
                if s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            for s, e in merged:
                if lib.bam_set_region(h, rid, s, e) != 0:
                    raise IOError(f"cannot set region on {path}")
                _drain_records(lib, h, chunk, cols, path)
        return _finish_records(lib, h, chunk, cols, refs, gene_tag, path)
    finally:
        lib.bam_close(h)


def _finish_records(lib, h, chunk, cols, refs, gene_tag, path) -> BamRecords:
    """Drain accumulated mismatches + interning tables off an open
    handle and assemble the columnar BamRecords."""
    mms = {k: [] for k in ("rid", "pos", "rb", "ab", "cb", "umi", "bq",
                           "gx")}
    while True:
        rid = np.empty(chunk, np.int32)
        pos = np.empty(chunk, np.int32)
        rb = np.empty(chunk, np.uint8)
        ab = np.empty(chunk, np.uint8)
        cb = np.empty(chunk, np.int64)
        umi = np.empty(chunk, np.int64)
        bq = np.empty(chunk, np.uint8)
        gx = np.empty(chunk, np.int64)
        nm = lib.bam_take_mismatches2(
            h, chunk, rid, pos, rb, ab, cb, umi, bq, gx
        )
        if nm == 0:
            break
        mms["rid"].append(rid[:nm].copy())
        mms["pos"].append(pos[:nm].copy())
        mms["rb"].append(rb[:nm].copy())
        mms["ab"].append(ab[:nm].copy())
        mms["cb"].append(cb[:nm].copy())
        mms["umi"].append(umi[:nm].copy())
        mms["bq"].append(bq[:nm].copy())
        mms["gx"].append(gx[:nm].copy())
    barcodes = [lib.bam_barcode(h, i).decode() for i in range(lib.bam_num_barcodes(h))]
    gene_names = (
        [lib.bam_gene_name(h, i).decode() for i in range(lib.bam_num_genes(h))]
        if gene_tag else None
    )
    nblocks = int(lib.bam_blocks_read(h))

    cat = lambda k: (
        np.concatenate(cols[k]) if cols[k] else np.zeros(0, np.int32)
    )
    catm = lambda k, dt: (
        np.concatenate(mms[k]).astype(dt) if mms[k] else np.zeros(0, dt)
    )
    return BamRecords(
        ref_id=cat("ref_id"),
        pos=cat("pos"),
        end_pos=cat("end_pos"),
        flag=cat("flag").astype(np.uint16),
        mapq=cat("mapq").astype(np.uint8),
        cb_id=cat("cb").astype(np.int64),
        umi_id=cat("umi").astype(np.int64),
        ref_names=refs,
        barcodes=barcodes,
        has_skip=cat("skip").astype(np.uint8),
        gene_id=cat("gene").astype(np.int64) if gene_tag else None,
        gene_names=gene_names,
        tail_len=cat("tail_len").astype(np.uint16),
        tail_frac=cat("tail_frac").astype(np.uint8),
        mm_ref_id=catm("rid", np.int32),
        mm_pos=catm("pos", np.int32),
        mm_ref_base=catm("rb", np.uint8),
        mm_read_base=catm("ab", np.uint8),
        mm_cb_id=catm("cb", np.int64),
        mm_umi_id=catm("umi", np.int64),
        mm_base_qual=catm("bq", np.uint8),
        mm_gene_id=catm("gx", np.int64) if gene_tag else None,
        blocks_read=nblocks,
    )


# ----------------------------------------------------------------------------
# pure-Python BGZF/BAM writer (fixtures + simulators)
# ----------------------------------------------------------------------------


def _bgzf_block(payload: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    # BSIZE = total block size - 1 = (header 18 + cdata + crc 4 + isize 4) - 1
    bsize = len(cdata) + 25
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<HH", 2, bsize)
    )
    return header + cdata + struct.pack("<II", zlib.crc32(payload), len(payload))


_SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_CIGAR_OP = {op: i for i, op in enumerate("MIDNSHP=X")}


def write_bam(
    path: str,
    refs: list[tuple[str, int]],
    reads,
    *,
    cb_tag: str = "CB",
    umi_tag: str = "UB",
    block_size: int = 60000,
):
    """Write an aligned BAM. Each read dict: {name, ref_id, pos, seq,
    cigar (e.g. '50M'), cb, ub, mapq?, flag?, md?, gx?, qual?}.
    `cb_tag`/`umi_tag` rename the barcode Z tags (testing non-10x tag
    layouts). `reads` may be any iterable (a generator streams: each
    BGZF block is written as it fills). The uncompressed stream is cut
    into blocks of `block_size` bytes (at most 65,536, the format's
    limit; the JAX package's writer uses 60,000)."""
    import re

    if not 0 < block_size <= 1 << 16:
        raise ValueError(f"block_size must lie in (0, 65536], got {block_size}")
    header_text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs).encode()
    body = bytearray(b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text)
    body += struct.pack("<i", len(refs))
    for n, l in refs:
        nm = n.encode() + b"\x00"
        body += struct.pack("<i", len(nm)) + nm + struct.pack("<i", l)

    cigar_re = re.compile(r"(\d+)([MIDNSHP=X])")
    cigar_memo: dict[str, tuple[int, bytes]] = {}
    seq_memo: dict[str, bytes] = {}
    core = struct.Struct("<iiiBBHHHiiii")
    cbk, umik = cb_tag.encode()[:2] + b"Z", umi_tag.encode()[:2] + b"Z"
    with open(path, "wb") as f:
        for r in reads:
            name = r["name"].encode() + b"\x00"
            cig = cigar_memo.get(r["cigar"])
            if cig is None:
                ops = cigar_re.findall(r["cigar"])
                cig = cigar_memo[r["cigar"]] = (len(ops), b"".join(
                    struct.pack("<I", (int(ln) << 4) | _CIGAR_OP[op]) for ln, op in ops))
            seq = r["seq"]
            packed = seq_memo.get(seq)
            if packed is None:
                sp = bytearray()
                for i in range(0, len(seq), 2):
                    hi = _SEQ_CODE.get(seq[i], 15) << 4
                    lo = _SEQ_CODE.get(seq[i + 1], 15) if i + 1 < len(seq) else 0
                    sp.append(hi | lo)
                packed = bytes(sp)
                if len(seq_memo) < 4096:
                    seq_memo[seq] = packed
            qual = bytes([int(r.get("qual", 30))]) * len(seq)
            tags = b""
            if "cb" in r:
                tags += cbk + r["cb"].encode() + b"\x00"
            if "ub" in r:
                tags += umik + r["ub"].encode() + b"\x00"
            if "md" in r:
                tags += b"MDZ" + r["md"].encode() + b"\x00"
            if "gx" in r:  # aligner gene assignment (CellRanger GX)
                tags += b"GXZ" + r["gx"].encode() + b"\x00"
            rest = name + cig[1] + packed + qual + tags
            body += core.pack(
                32 + len(rest),
                r["ref_id"],
                r["pos"],
                len(name),
                r.get("mapq", 60),
                4680,  # bin (unused by the reader)
                cig[0],
                r.get("flag", 0),
                len(seq),
                -1,
                -1,
                0,
            )
            body += rest
            while len(body) >= block_size:
                f.write(_bgzf_block(bytes(body[:block_size])))
                del body[:block_size]
        if body:
            f.write(_bgzf_block(bytes(body)))
        f.write(_bgzf_block(b""))  # EOF marker
