// Minimal BGZF/BAM reader for the faba feature-extraction layer.
//
// The reference links vendored htslib through rust-htslib
// (SURVEY.md section 2.6); this environment has no htslib, so the
// container formats are implemented directly against zlib:
//   - BGZF: concatenated gzip members, each with a BC extra subfield
//     carrying the compressed block size (SAM spec section 4.1).
//   - BAM: little-endian binary records per SAM spec section 4.2.
//
// Exposed as a C ABI consumed from Python via ctypes
// (legume_tpu_torch/faba/bam.py). Records stream out in fixed-size chunks of
// parallel arrays (columnar, NumPy-ready): refID, pos, end pos (CIGAR
// reference span), flag, mapq, and interned cell-barcode (CB) / UMI
// (UB) tag ids. Base-level data (SEQ + CIGAR walk) is exposed through
// a per-read callback used by the pileup path.

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct BgzfReader {
    FILE* f = nullptr;
    std::vector<uint8_t> buf;   // decompressed current block
    size_t pos = 0;             // cursor within buf
    bool eof = false;
    uint64_t block_coffset = 0;  // file offset of the block in `buf`
    uint64_t blocks_read = 0;    // decompressed-block counter (skip-ratio metric)

    bool open(const char* path) {
        f = std::fopen(path, "rb");
        return f != nullptr;
    }

    uint64_t next_coffset = 0;   // file offset just past the block in `buf`

    // BGZF virtual offset of the cursor: (block file offset << 16) |
    // offset within the decompressed block (SAM spec section 4.1.1).
    // The in-block offset has 16 bits, so a cursor at the end of a full
    // 65,536-byte block takes the next block's form, (next offset << 16)
    // | 0: OR-ing 65,536 in would carry into the file offset and name a
    // byte that starts no block. Monotone in file position either way.
    uint64_t tell_voffset() const {
        if (pos >= (size_t)(1u << 16)) return next_coffset << 16;
        return (block_coffset << 16) | (uint64_t)pos;
    }

    // Jump to a virtual offset (BAI chunk start). Clears EOF state so
    // regions can be fetched after a full-stream pass hit EOF.
    bool seek_voffset(uint64_t v) {
        uint64_t co = v >> 16;
        size_t uo = (size_t)(v & 0xffff);
        if (!f || std::fseek(f, (long)co, SEEK_SET) != 0) return false;
        eof = false;
        if (!next_block()) return false;
        if (uo > buf.size()) return false;
        pos = uo;
        return true;
    }

    // Read one BGZF block; returns false at clean EOF.
    bool next_block() {
        block_coffset = (uint64_t)std::ftell(f);
        uint8_t hdr[12];
        size_t n = std::fread(hdr, 1, 12, f);
        if (n == 0) { eof = true; return false; }
        if (n < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b) return false;
        blocks_read++;  // counts blocks whose header was read, not EOF probes
        uint16_t xlen = hdr[10] | (hdr[11] << 8);
        std::vector<uint8_t> extra(xlen);
        if (xlen && std::fread(extra.data(), 1, xlen, f) != xlen) return false;
        uint32_t bsize = 0;  // total block size - 1 (SAM spec 4.1)
        for (size_t i = 0; i + 4 <= extra.size();) {
            uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
            if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2) {
                if (i + 6 > extra.size()) return false;  // truncated BC payload
                bsize = extra[i + 4] | (extra[i + 5] << 8);
                break;
            }
            i += 4 + slen;
        }
        // guard the (bsize + 1) - 12 - xlen subtraction against underflow
        // on a corrupt BC value before computing the compressed remainder
        if (bsize == 0 || (size_t)bsize + 1 < 12 + (size_t)xlen) return false;
        size_t remaining = (size_t)bsize + 1 - 12 - xlen;
        std::vector<uint8_t> cdata(remaining);
        if (std::fread(cdata.data(), 1, remaining, f) != remaining) return false;
        next_coffset = (uint64_t)std::ftell(f);
        // cdata = deflate payload + CRC32 (4) + ISIZE (4)
        if (remaining < 8) return false;
        uint32_t isize = cdata[remaining - 4] | (cdata[remaining - 3] << 8) |
                         (cdata[remaining - 2] << 16) | ((uint32_t)cdata[remaining - 1] << 24);
        if (isize > 1u << 16) return false;  // BGZF blocks are <= 64 KiB (spec 4.1)
        buf.resize(isize);
        pos = 0;
        if (isize == 0) return true;  // EOF marker block
        z_stream zs{};
        inflateInit2(&zs, -15);  // raw deflate
        zs.next_in = cdata.data();
        zs.avail_in = (uInt)(remaining - 8);
        zs.next_out = buf.data();
        zs.avail_out = isize;
        int r = inflate(&zs, Z_FINISH);
        bool full = zs.total_out == isize;
        inflateEnd(&zs);
        return r == Z_STREAM_END && full;
    }

    // Read exactly n bytes across block boundaries; false at EOF.
    bool read(void* dst, size_t n) {
        uint8_t* out = (uint8_t*)dst;
        while (n > 0) {
            if (pos >= buf.size()) {
                if (!next_block()) return false;
                if (buf.empty()) continue;  // skip empty EOF block, try next
            }
            size_t take = std::min(n, buf.size() - pos);
            std::memcpy(out, buf.data() + pos, take);
            pos += take;
            out += take;
            n -= take;
        }
        return true;
    }

    void close() {
        if (f) std::fclose(f);
        f = nullptr;
    }
};

struct Interner {
    std::unordered_map<std::string, int64_t> map;
    std::vector<std::string> names;
    int64_t intern(const std::string& s) {
        auto it = map.find(s);
        if (it != map.end()) return it->second;
        int64_t id = (int64_t)names.size();
        map.emplace(s, id);
        names.push_back(s);
        return id;
    }
};

// ---------------------------------------------------------------------------
// BAI index (SAM spec section 5.2): R-tree binning over 5 levels plus a
// 16 KiB-window linear index. The reference requires indices for per-gene
// ranged reads (faba/src/m6a/run.rs:660-675 check_all_bam_indices;
// rust-htslib fetch); this is the from-scratch equivalent.
// ---------------------------------------------------------------------------

struct Chunk {
    uint64_t beg, end;  // virtual-offset half-open span
};

struct RefIndex {
    std::unordered_map<uint32_t, std::vector<Chunk>> bins;
    std::vector<uint64_t> linear;  // 16 KiB window -> min record voffset
};

// Bin number of the smallest bin fully containing [beg, end) (spec 5.3).
int reg2bin(int64_t beg, int64_t end) {
    end--;
    if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (int)(beg >> 14);
    if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (int)(beg >> 17);
    if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (int)(beg >> 20);
    if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (int)(beg >> 23);
    if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (int)(beg >> 26);
    return 0;
}

// All bins overlapping [beg, end) (spec 5.3).
void reg2bins(int64_t beg, int64_t end, std::vector<uint32_t>* bins) {
    if (beg < 0) beg = 0;
    end--;
    if (end < beg) end = beg;
    bins->push_back(0);
    for (int64_t k = 1 + (beg >> 26); k <= 1 + (end >> 26); k++) bins->push_back((uint32_t)k);
    for (int64_t k = 9 + (beg >> 23); k <= 9 + (end >> 23); k++) bins->push_back((uint32_t)k);
    for (int64_t k = 73 + (beg >> 20); k <= 73 + (end >> 20); k++) bins->push_back((uint32_t)k);
    for (int64_t k = 585 + (beg >> 17); k <= 585 + (end >> 17); k++) bins->push_back((uint32_t)k);
    for (int64_t k = 4681 + (beg >> 14); k <= 4681 + (end >> 14); k++) bins->push_back((uint32_t)k);
}

bool load_bai(const char* path, std::vector<RefIndex>* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    auto rd = [&](void* p, size_t n) { return std::fread(p, 1, n, f) == n; };
    char magic[4];
    bool ok = rd(magic, 4) && std::memcmp(magic, "BAI\1", 4) == 0;
    int32_t n_ref = 0;
    ok = ok && rd(&n_ref, 4) && n_ref >= 0;
    for (int r = 0; ok && r < n_ref; r++) {
        out->emplace_back();
        RefIndex& ri = out->back();
        int32_t n_bin = 0;
        ok = rd(&n_bin, 4) && n_bin >= 0;
        for (int bi = 0; ok && bi < n_bin; bi++) {
            uint32_t bin;
            int32_t n_chunk = 0;
            ok = rd(&bin, 4) && rd(&n_chunk, 4) && n_chunk >= 0;
            std::vector<Chunk> cs(ok ? (size_t)n_chunk : 0);
            for (auto& c : cs) ok = ok && rd(&c.beg, 8) && rd(&c.end, 8);
            if (ok && bin != 37450)  // 37450 = samtools metadata pseudo-bin
                ri.bins.emplace(bin, std::move(cs));
        }
        int32_t n_intv = 0;
        ok = ok && rd(&n_intv, 4) && n_intv >= 0;
        if (ok) {
            ri.linear.resize((size_t)n_intv);
            for (auto& v : ri.linear) ok = ok && rd(&v, 8);
        }
    }
    std::fclose(f);
    return ok;
}

// One reference-mismatch observation (from MD tag + SEQ).
struct Mismatch {
    int32_t ref_id;
    int32_t pos;       // 0-based reference position
    char ref_base;
    char read_base;
    int64_t cb_id;
    int64_t umi_id;
    uint8_t base_qual;  // phred at the read base (0xff = missing)
    int64_t gene_id;   // interned gene tag of the READ (-1 = untagged)
};

struct BamFile {
    BgzfReader bg;
    std::vector<std::string> ref_names;
    std::vector<int32_t> ref_lens;
    Interner cb;   // cell barcodes
    Interner umi;  // UMIs
    Interner gene;  // gene tags (CellRanger GX), only when gene_tag set
    // configurable Z-tag names (10x defaults; DartSeqCountArgs
    // cell_barcode_tag lets Smart-seq-style BAMs point elsewhere)
    char cb_tag[3] = {'C', 'B', 0};
    char umi_tag[3] = {'U', 'B', 0};
    // gene-keying Z tag (DartSeqCountArgs gene_barcode_tag): OFF by
    // default; bam_set_gene_tag enables aligner-assigned gene keying
    char gene_tag[3] = {0, 0, 0};
    std::vector<uint8_t> rec;  // scratch record buffer
    std::vector<Mismatch> mismatches;  // drained by bam_take_mismatches
    // BAI index + active ranged fetch (bam_load_index / bam_set_region)
    std::vector<RefIndex> index;
    bool has_index = false;
    bool region_active = false;
    std::vector<Chunk> region_chunks;  // merged, voffset-sorted
    size_t region_ci = 0;
    bool region_seeked = false;
    int32_t region_ref = -1;
    int64_t region_beg = 0, region_end = 0;

    bool open(const char* path) {
        if (!bg.open(path)) return false;
        char magic[4];
        if (!bg.read(magic, 4) || std::memcmp(magic, "BAM\1", 4) != 0) return false;
        int32_t l_text;
        if (!bg.read(&l_text, 4)) return false;
        std::vector<char> text(l_text);
        if (l_text && !bg.read(text.data(), l_text)) return false;
        int32_t n_ref;
        if (!bg.read(&n_ref, 4)) return false;
        for (int i = 0; i < n_ref; i++) {
            int32_t l_name;
            if (!bg.read(&l_name, 4)) return false;
            std::vector<char> nm(l_name);
            if (!bg.read(nm.data(), l_name)) return false;
            int32_t l_ref;
            if (!bg.read(&l_ref, 4)) return false;
            ref_names.emplace_back(nm.data());
            ref_lens.push_back(l_ref);
        }
        return true;
    }
};

// Parse a string-valued tag (type 'Z') with the given two-letter key
// from the tag region [p, end). Returns true + value.
bool find_z_tag(const uint8_t* p, const uint8_t* end, const char key[2], std::string* out) {
    while (p + 3 <= end) {
        char t0 = p[0], t1 = p[1], type = p[2];
        p += 3;
        size_t len = 0;
        switch (type) {
            case 'A': len = 1; break;
            case 'c': case 'C': len = 1; break;
            case 's': case 'S': len = 2; break;
            case 'i': case 'I': case 'f': len = 4; break;
            case 'Z': case 'H': {
                const uint8_t* q = p;
                while (q < end && *q) q++;
                if (t0 == key[0] && t1 == key[1]) {
                    out->assign((const char*)p, q - p);
                    return true;
                }
                p = q + 1;
                continue;
            }
            case 'B': {
                if (p + 5 > end) return false;
                char sub = (char)p[0];
                uint32_t cnt;
                std::memcpy(&cnt, p + 1, 4);
                size_t esz = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
                p += 5 + cnt * esz;
                continue;
            }
            default: return false;
        }
        p += len;
    }
    return false;
}

constexpr char SEQ_CHARS[] = "=ACMGRSVTWYHKDBN";

// Walk CIGAR + MD to emit reference mismatches (SAM optional-field
// spec: MD is the reference-base trace over aligned/deleted bases).
// `seq4` is the 4-bit packed SEQ. Only M/=/X ops consume both axes;
// insertions/clips consume the read, deletions consume MD's ^-runs.
void extract_mismatches(BamFile* b, int32_t rid, int32_t pos, const uint8_t* cigar,
                        int n_cigar, const uint8_t* seq4, const uint8_t* qual,
                        int32_t l_seq, const std::string& md, int64_t cb_id,
                        int64_t umi_id, int64_t gene_id) {
    // read offset of each aligned (reference-consuming) base, in order
    std::vector<int32_t> aligned_read_off;
    int32_t roff = 0;
    for (int c = 0; c < n_cigar; c++) {
        uint32_t op;
        std::memcpy(&op, cigar + 4 * c, 4);
        uint32_t len = op >> 4;
        switch (op & 0xf) {
            case 0: case 7: case 8:  // M = X
                for (uint32_t i = 0; i < len; i++) aligned_read_off.push_back(roff + i);
                roff += len;
                break;
            case 1: case 4: roff += len; break;  // I S consume read only
            default: break;                      // D N H P
        }
    }
    // MD walk: numbers = matches, letters = mismatches, ^ACGT = deletion
    size_t i = 0;
    size_t ai = 0;  // index into aligned_read_off
    int32_t ref_cursor = 0;  // aligned-base counter (ref positions via pos+ai? no: deletions advance ref but not aligned)
    // Track the reference coordinate separately: aligned base ai sits at
    // reference position = pos + (aligned bases consumed) + (deleted bases so far)
    int32_t deleted = 0;
    while (i < md.size()) {
        if (std::isdigit((unsigned char)md[i])) {
            int32_t n = 0;
            while (i < md.size() && std::isdigit((unsigned char)md[i]))
                n = n * 10 + (md[i++] - '0');
            ai += n;
        } else if (md[i] == '^') {
            i++;
            while (i < md.size() && std::isalpha((unsigned char)md[i])) { i++; deleted++; }
        } else {
            char ref_base = md[i++];
            // CIGAR may claim more read bases than SEQ carries on a
            // corrupt record; never index seq4 past (l_seq+1)/2
            if (ai < aligned_read_off.size() && aligned_read_off[ai] < l_seq) {
                int32_t ro = aligned_read_off[ai];
                uint8_t code = (ro % 2 == 0) ? (seq4[ro / 2] >> 4) : (seq4[ro / 2] & 0xf);
                char read_base = SEQ_CHARS[code];
                b->mismatches.push_back(Mismatch{
                    rid, pos + (int32_t)ai + deleted, ref_base, read_base, cb_id,
                    umi_id, qual[ro], gene_id});
            }
            ai++;
        }
    }
}

}  // namespace

extern "C" {

void* bam_open(const char* path) {
    auto* b = new BamFile();
    if (!b->open(path)) {
        delete b;
        return nullptr;
    }
    return b;
}

void bam_set_tags(void* h, const char* cb_tag, const char* umi_tag) {
    // must be called before the first bam_next_chunk* (interning starts
    // then); two-character Z tags only, extra characters ignored
    auto* b = (BamFile*)h;
    if (cb_tag && cb_tag[0] && cb_tag[1]) { b->cb_tag[0] = cb_tag[0]; b->cb_tag[1] = cb_tag[1]; }
    if (umi_tag && umi_tag[0] && umi_tag[1]) { b->umi_tag[0] = umi_tag[0]; b->umi_tag[1] = umi_tag[1]; }
}

int bam_num_refs(void* h) { return (int)((BamFile*)h)->ref_names.size(); }
const char* bam_ref_name(void* h, int i) { return ((BamFile*)h)->ref_names[i].c_str(); }
int bam_ref_len(void* h, int i) { return ((BamFile*)h)->ref_lens[i]; }

// Stream up to `cap` records into parallel arrays. Returns the count
// (0 at EOF, -1 on parse error). end_pos is pos + reference span from
// CIGAR (M/D/N/=/X consume reference).
//
// bam_next_chunk3 additionally emits polyA-tail evidence per record
// (CountApaArgs polya_* role): the terminal soft-clip length at each
// read end and the A-fraction (right clip) / T-fraction (left clip,
// the reverse-strand complement) of those clipped bases, scaled by
// 255. Untemplated A runs past the cleavage site land in the terminal
// S op, so tail_len/tail_frac gate genuine polyA-site reads.
// bam_next_chunk4 additionally emits the interned gene-tag id per
// record (CellRanger GX keying, DartSeqCountArgs gene_barcode_tag):
// -1 when the tag is absent or bam_set_gene_tag was never called.
long bam_next_chunk4(void* h, long cap, int32_t* ref_id, int32_t* pos, int32_t* end_pos,
                     uint16_t* flag, uint8_t* mapq, int64_t* cb_id, int64_t* umi_id,
                     uint8_t* has_skip, uint16_t* tail_len, uint8_t* tail_frac,
                     int64_t* gene_id) {
    auto* b = (BamFile*)h;
    long n = 0;
    while (n < cap) {
        if (b->region_active) {
            // position the cursor inside the next unexhausted chunk
            bool exhausted = false;
            for (;;) {
                if (b->region_ci >= b->region_chunks.size()) {
                    exhausted = true;
                    break;
                }
                const Chunk& c = b->region_chunks[b->region_ci];
                if (!b->region_seeked) {
                    if (!b->bg.seek_voffset(c.beg)) return -1;
                    b->region_seeked = true;
                }
                if (b->bg.tell_voffset() >= c.end) {
                    b->region_ci++;
                    b->region_seeked = false;
                    continue;
                }
                break;
            }
            if (exhausted) break;  // region fully read
        }
        int32_t block_size;
        if (!b->bg.read(&block_size, 4)) break;  // EOF
        if (block_size < 32 || block_size > (1 << 26)) return -1;  // corrupt
        b->rec.resize(block_size);
        if (!b->bg.read(b->rec.data(), block_size)) return -1;
        const uint8_t* p = b->rec.data();
        int32_t rid, rpos;
        std::memcpy(&rid, p, 4);
        std::memcpy(&rpos, p + 4, 4);
        uint8_t l_read_name = p[8];
        uint8_t mq = p[9];
        uint16_t n_cigar, flg;
        std::memcpy(&n_cigar, p + 12, 2);
        std::memcpy(&flg, p + 14, 2);
        int32_t l_seq;
        std::memcpy(&l_seq, p + 16, 4);
        // validate variable-length fields against the record size before
        // touching CIGAR/SEQ/tag pointers (corrupt input must parse-error,
        // not overread the heap buffer)
        if (l_seq < 0 ||
            32 + (int64_t)l_read_name + 4 * (int64_t)n_cigar +
                    ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq >
                (int64_t)block_size)
            return -1;
        const uint8_t* cigar = p + 32 + l_read_name;
        int32_t span = 0;
        uint8_t skip = 0;  // CIGAR N op = spliced-junction evidence
        for (int c = 0; c < n_cigar; c++) {
            uint32_t op;
            std::memcpy(&op, cigar + 4 * c, 4);
            uint32_t len = op >> 4;
            switch (op & 0xf) {
                case 3: skip = 1; span += len; break;           // N
                case 0: case 2: case 7: case 8: span += len; break;  // M D = X
                default: break;
            }
        }
        if (b->region_active) {
            // overlap filter BEFORE tag/MD work: skipped records must
            // not intern barcodes or emit mismatches. Zero-span reads
            // occupy one base for overlap purposes (htslib convention).
            int64_t rbeg = rpos, rend = rpos + (span ? span : 1);
            if (rid == b->region_ref && rbeg >= b->region_end) {
                // coordinate-sorted input: every later record starts
                // at or after this one -> nothing further can overlap
                b->region_ci = b->region_chunks.size();
                break;
            }
            if (rid != b->region_ref || rend <= b->region_beg) continue;
        }
        const uint8_t* seq4 = cigar + 4 * n_cigar;
        // terminal soft clips + their A/T content (seq4 nibbles:
        // A=1, C=2, G=4, T=8)
        uint16_t t_len = 0;
        uint8_t t_frac = 0;
        if (tail_len && n_cigar > 0 && l_seq > 0) {
            uint32_t op_first, op_last;
            std::memcpy(&op_first, cigar, 4);
            std::memcpy(&op_last, cigar + 4 * (n_cigar - 1), 4);
            auto nib = [&](int32_t i) -> uint8_t {
                uint8_t byte = seq4[i / 2];
                return (i % 2 == 0) ? (byte >> 4) : (byte & 0xf);
            };
            long hits = 0;
            uint32_t len = 0;
            if ((op_last & 0xf) == 4) {  // right soft clip: count A
                len = op_last >> 4;
                if ((int64_t)len > l_seq) len = (uint32_t)l_seq;
                for (uint32_t i = 0; i < len; i++)
                    if (nib(l_seq - 1 - (int32_t)i) == 1) hits++;
            }
            uint32_t llen = 0;
            long lhits = 0;
            if ((op_first & 0xf) == 4) {  // left soft clip: count T
                llen = op_first >> 4;
                if ((int64_t)llen > l_seq) llen = (uint32_t)l_seq;
                for (uint32_t i = 0; i < llen; i++)
                    if (nib((int32_t)i) == 8) lhits++;
            }
            // keep the LONGER candidate tail of the two ends
            if (llen > len) { len = llen; hits = lhits; }
            t_len = (uint16_t)std::min<uint32_t>(len, 65535);
            t_frac = len ? (uint8_t)((255 * hits) / len) : 0;
        }
        const uint8_t* tags = cigar + 4 * n_cigar + (l_seq + 1) / 2 + l_seq;
        const uint8_t* end = b->rec.data() + block_size;
        std::string cbv, umiv, mdv, gxv;
        int64_t cbi = -1, umii = -1, gxi = -1;
        if (find_z_tag(tags, end, b->cb_tag, &cbv)) cbi = b->cb.intern(cbv);
        if (find_z_tag(tags, end, b->umi_tag, &umiv)) umii = b->umi.intern(umiv);
        if (b->gene_tag[0] && find_z_tag(tags, end, b->gene_tag, &gxv) &&
            !gxv.empty())
            gxi = b->gene.intern(gxv);
        if (find_z_tag(tags, end, "MD", &mdv) && !mdv.empty())
            extract_mismatches(b, rid, rpos, cigar, n_cigar, seq4,
                               seq4 + (l_seq + 1) / 2, l_seq, mdv, cbi, umii,
                               gxi);
        ref_id[n] = rid;
        pos[n] = rpos;
        end_pos[n] = rpos + span;
        flag[n] = flg;
        mapq[n] = mq;
        cb_id[n] = cbi;
        umi_id[n] = umii;
        has_skip[n] = skip;
        if (tail_len) { tail_len[n] = t_len; tail_frac[n] = t_frac; }
        if (gene_id) gene_id[n] = gxi;
        n++;
    }
    return n;
}

long bam_next_chunk3(void* h, long cap, int32_t* ref_id, int32_t* pos, int32_t* end_pos,
                     uint16_t* flag, uint8_t* mapq, int64_t* cb_id, int64_t* umi_id,
                     uint8_t* has_skip, uint16_t* tail_len, uint8_t* tail_frac) {
    return bam_next_chunk4(h, cap, ref_id, pos, end_pos, flag, mapq, cb_id, umi_id,
                           has_skip, tail_len, tail_frac, nullptr);
}

long bam_next_chunk2(void* h, long cap, int32_t* ref_id, int32_t* pos, int32_t* end_pos,
                     uint16_t* flag, uint8_t* mapq, int64_t* cb_id, int64_t* umi_id,
                     uint8_t* has_skip) {
    return bam_next_chunk3(h, cap, ref_id, pos, end_pos, flag, mapq, cb_id, umi_id,
                           has_skip, nullptr, nullptr);
}

long bam_next_chunk(void* h, long cap, int32_t* ref_id, int32_t* pos, int32_t* end_pos,
                    uint16_t* flag, uint8_t* mapq, int64_t* cb_id, int64_t* umi_id) {
    std::vector<uint8_t> tmp(cap > 0 ? (size_t)cap : 1);
    return bam_next_chunk2(h, cap, ref_id, pos, end_pos, flag, mapq, cb_id, umi_id,
                           tmp.data());
}

// Drain up to `cap` accumulated mismatches into parallel arrays;
// returns the count. ref/read bases as ASCII codes.
long bam_take_mismatches2(void* h, long cap, int32_t* ref_id, int32_t* pos,
                          uint8_t* ref_base, uint8_t* read_base,
                          int64_t* cb_id, int64_t* umi_id, uint8_t* base_qual,
                          int64_t* gene_id) {
    auto* b = (BamFile*)h;
    long n = (long)std::min<size_t>(cap, b->mismatches.size());
    for (long i = 0; i < n; i++) {
        const Mismatch& m = b->mismatches[i];
        ref_id[i] = m.ref_id;
        pos[i] = m.pos;
        ref_base[i] = (uint8_t)m.ref_base;
        read_base[i] = (uint8_t)m.read_base;
        cb_id[i] = m.cb_id;
        umi_id[i] = m.umi_id;
        base_qual[i] = m.base_qual;
        if (gene_id) gene_id[i] = m.gene_id;
    }
    b->mismatches.erase(b->mismatches.begin(), b->mismatches.begin() + n);
    return n;
}

long bam_take_mismatches(void* h, long cap, int32_t* ref_id, int32_t* pos,
                         uint8_t* ref_base, uint8_t* read_base,
                         int64_t* cb_id, int64_t* umi_id, uint8_t* base_qual) {
    return bam_take_mismatches2(h, cap, ref_id, pos, ref_base, read_base,
                                cb_id, umi_id, base_qual, nullptr);
}

long bam_num_barcodes(void* h) { return (long)((BamFile*)h)->cb.names.size(); }
const char* bam_barcode(void* h, long i) { return ((BamFile*)h)->cb.names[i].c_str(); }

void bam_set_gene_tag(void* h, const char* tag) {
    // enable GX-style gene keying; must precede the first chunk read
    auto* b = (BamFile*)h;
    if (tag && tag[0] && tag[1]) { b->gene_tag[0] = tag[0]; b->gene_tag[1] = tag[1]; }
}

long bam_num_genes(void* h) { return (long)((BamFile*)h)->gene.names.size(); }
const char* bam_gene_name(void* h, long i) { return ((BamFile*)h)->gene.names[i].c_str(); }
long bam_num_umis(void* h) { return (long)((BamFile*)h)->umi.names.size(); }

// Load a .bai companion index; 0 on success, -1 on parse/open failure.
int bam_load_index(void* h, const char* bai_path) {
    auto* b = (BamFile*)h;
    std::vector<RefIndex> idx;
    if (!load_bai(bai_path, &idx)) return -1;
    b->index = std::move(idx);
    b->has_index = true;
    return 0;
}

// Restrict subsequent bam_next_chunk* calls to records overlapping
// [beg, end) on ref_id, via BAI chunk gathering + virtual-offset seeks
// (the rust-htslib `fetch` equivalent). ref_id < 0 clears the region
// (back to whole-file streaming from the current position). Returns 0,
// or -1 when no index is loaded / ref_id is out of range.
int bam_set_region(void* h, int ref_id, long long beg, long long end) {
    auto* b = (BamFile*)h;
    if (ref_id < 0) {
        b->region_active = false;
        b->region_chunks.clear();
        return 0;
    }
    if (!b->has_index || (size_t)ref_id >= b->index.size()) return -1;
    const RefIndex& ri = b->index[ref_id];
    b->region_chunks.clear();
    b->region_ci = 0;
    b->region_seeked = false;
    b->region_ref = ref_id;
    b->region_beg = beg;
    b->region_end = end;
    b->region_active = true;
    if (beg >= end) return 0;  // empty window -> no chunks
    // linear-index lower bound: chunks ending before the first possible
    // record of the 16 KiB window cannot contain overlapping reads
    uint64_t min_off = 0;
    size_t w = (size_t)(beg >> 14);
    if (!ri.linear.empty()) {
        if (w >= ri.linear.size()) return 0;  // past the last read
        min_off = ri.linear[w];
    }
    std::vector<uint32_t> bins;
    reg2bins(beg, end, &bins);
    for (uint32_t bin : bins) {
        auto it = ri.bins.find(bin);
        if (it == ri.bins.end()) continue;
        for (const Chunk& c : it->second)
            if (c.end > min_off) b->region_chunks.push_back(c);
    }
    std::sort(b->region_chunks.begin(), b->region_chunks.end(),
              [](const Chunk& a, const Chunk& c) { return a.beg < c.beg; });
    // coalesce overlapping/adjacent chunks so each byte is read once
    size_t out = 0;
    for (size_t i = 0; i < b->region_chunks.size(); i++) {
        if (out && b->region_chunks[i].beg <= b->region_chunks[out - 1].end) {
            if (b->region_chunks[i].end > b->region_chunks[out - 1].end)
                b->region_chunks[out - 1].end = b->region_chunks[i].end;
        } else {
            b->region_chunks[out++] = b->region_chunks[i];
        }
    }
    b->region_chunks.resize(out);
    return 0;
}

// Build a .bai for a coordinate-sorted BAM (the `samtools index`
// equivalent; the reference requires prebuilt indices, m6a/run.rs:660).
// Streams records once, tracking each record's start virtual offset.
// Returns 0, or -1 on open/parse failure (including out-of-order or
// out-of-range positions, which would produce a corrupt index).
int bam_build_index(const char* bam_path, const char* bai_path) {
    BamFile b;
    if (!b.open(bam_path)) return -1;
    size_t n_ref = b.ref_names.size();
    std::vector<RefIndex> idx(n_ref);
    std::vector<uint64_t> max_voff(n_ref, 0);
    int32_t last_rid = -2;
    int64_t last_pos = -1;
    std::vector<uint8_t> rec;
    for (;;) {
        uint64_t vstart = b.bg.tell_voffset();
        int32_t block_size;
        if (!b.bg.read(&block_size, 4)) break;  // EOF
        if (block_size < 32 || block_size > (1 << 26)) { b.bg.close(); return -1; }
        rec.resize(block_size);
        if (!b.bg.read(rec.data(), block_size)) { b.bg.close(); return -1; }
        uint64_t vend = b.bg.tell_voffset();
        const uint8_t* p = rec.data();
        int32_t rid, rpos;
        std::memcpy(&rid, p, 4);
        std::memcpy(&rpos, p + 4, 4);
        uint8_t l_read_name = p[8];
        uint16_t n_cigar;
        std::memcpy(&n_cigar, p + 12, 2);
        if (32 + (int64_t)l_read_name + 4 * (int64_t)n_cigar > (int64_t)block_size) {
            b.bg.close();
            return -1;
        }
        if (rid < 0) continue;  // unmapped tail: not indexed
        if ((size_t)rid >= n_ref || rpos < 0) { b.bg.close(); return -1; }
        if (rid == last_rid ? rpos < last_pos : rid < last_rid) {
            b.bg.close();
            return -1;  // not coordinate-sorted
        }
        last_rid = rid;
        last_pos = rpos;
        const uint8_t* cigar = p + 32 + l_read_name;
        int64_t span = 0;
        for (int c = 0; c < n_cigar; c++) {
            uint32_t op;
            std::memcpy(&op, cigar + 4 * c, 4);
            uint32_t len = op >> 4;
            int k = op & 0xf;
            if (k == 0 || k == 2 || k == 3 || k == 7 || k == 8) span += len;
        }
        int64_t rbeg = rpos, rend = rpos + (span ? span : 1);
        RefIndex& ri = idx[rid];
        uint32_t bin = (uint32_t)reg2bin(rbeg, rend);
        auto& cs = ri.bins[bin];
        if (!cs.empty() && cs.back().end == vstart)
            cs.back().end = vend;  // contiguous record: extend the chunk
        else
            cs.push_back(Chunk{vstart, vend});
        size_t w_end = (size_t)((rend - 1) >> 14);
        if (ri.linear.size() <= w_end) ri.linear.resize(w_end + 1, UINT64_MAX);
        for (size_t w = (size_t)(rbeg >> 14); w <= w_end; w++)
            if (vstart < ri.linear[w]) ri.linear[w] = vstart;
        if (vend > max_voff[rid]) max_voff[rid] = vend;
    }
    b.bg.close();
    // backfill empty linear windows with the preceding window's offset
    // (lower bound stays valid; leading empties become 0 = no bound)
    for (auto& ri : idx) {
        uint64_t prev = 0;
        for (auto& v : ri.linear) {
            if (v == UINT64_MAX) v = prev;
            else prev = v;
        }
    }
    FILE* f = std::fopen(bai_path, "wb");
    if (!f) return -1;
    auto wr = [&](const void* p, size_t n) { std::fwrite(p, 1, n, f); };
    wr("BAI\1", 4);
    int32_t nr = (int32_t)n_ref;
    wr(&nr, 4);
    for (const auto& ri : idx) {
        std::vector<uint32_t> bin_ids;
        for (const auto& kv : ri.bins) bin_ids.push_back(kv.first);
        std::sort(bin_ids.begin(), bin_ids.end());
        int32_t nb = (int32_t)bin_ids.size();
        wr(&nb, 4);
        for (uint32_t bin : bin_ids) {
            const auto& cs = ri.bins.at(bin);
            int32_t nc = (int32_t)cs.size();
            wr(&bin, 4);
            wr(&nc, 4);
            for (const Chunk& c : cs) {
                wr(&c.beg, 8);
                wr(&c.end, 8);
            }
        }
        int32_t ni = (int32_t)ri.linear.size();
        wr(&ni, 4);
        for (uint64_t v : ri.linear) wr(&v, 8);
    }
    std::fclose(f);
    return 0;
}

// BGZF blocks decompressed so far on this handle — the I/O-skip metric
// for ranged fetch (region reads touch O(overlapping blocks), not O(file)).
long bam_blocks_read(void* h) {
    return (long)((BamFile*)h)->bg.blocks_read;
}

void bam_close(void* h) {
    auto* b = (BamFile*)h;
    b->bg.close();
    delete b;
}

}  // extern "C"
