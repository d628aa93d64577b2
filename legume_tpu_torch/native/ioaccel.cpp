// Native IO accelerators for the data-loading layer.
//
// The reference's ingestion hot paths are compiled Rust end to end;
// here the Python builders call these C tokenizers through ctypes for
// the text-format hot loops (MatrixMarket bodies, ATAC fragments),
// which beat Python's per-line overhead at many-GB inputs. Gzip input is handled via
// zlib (the only library it links).
//
// Exposed C ABI (see legume_tpu_torch/data/ioaccel.py):
//   mtx_open / mtx_dims / mtx_next_chunk / mtx_close
//   frag_open / frag_next_chunk / frag_num_names / frag_name / frag_close

#include <zlib.h>

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Buffered line reader over plain or gzip files.
struct LineReader {
    gzFile gz = nullptr;
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    bool eof = false;

    bool open(const char* path) {
        gz = gzopen(path, "rb");  // zlib transparently reads plain files too
        if (!gz) return false;
        buf.resize(1 << 20);
        return true;
    }

    // Returns pointer to a NUL-terminated line (no newline) or nullptr.
    char* next_line(std::string& scratch) {
        scratch.clear();
        while (true) {
            if (pos >= len) {
                if (eof) return scratch.empty() ? nullptr : scratch.data();
                int n = gzread(gz, buf.data(), (unsigned)buf.size());
                if (n <= 0) {
                    eof = true;
                    continue;
                }
                len = (size_t)n;
                pos = 0;
            }
            char* nl = (char*)memchr(buf.data() + pos, '\n', len - pos);
            if (nl) {
                scratch.append(buf.data() + pos, nl - (buf.data() + pos));
                pos = (nl - buf.data()) + 1;
                return scratch.data();
            }
            scratch.append(buf.data() + pos, len - pos);
            pos = len;
        }
    }

    void close() {
        if (gz) gzclose(gz);
        gz = nullptr;
    }
};

struct MtxFile {
    LineReader lr;
    std::string scratch;
    int64_t nrow = 0, ncol = 0, nnz = 0;
    bool pattern = false;  // MatrixMarket "pattern" = no value column
};

struct Interner {
    std::unordered_map<std::string, int64_t> map;
    std::vector<std::string> names;
    int64_t intern(const char* s, size_t n) {
        std::string key(s, n);
        auto it = map.find(key);
        if (it != map.end()) return it->second;
        int64_t id = (int64_t)names.size();
        map.emplace(std::move(key), id);
        names.push_back(std::string(s, n));
        return id;
    }
};

struct FragFile {
    LineReader lr;
    std::string scratch;
    Interner chroms;
    Interner barcodes;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// MatrixMarket
// ---------------------------------------------------------------------------

void* mtx_open(const char* path) {
    auto* m = new MtxFile();
    if (!m->lr.open(path)) {
        delete m;
        return nullptr;
    }
    // header: %%MatrixMarket ... [pattern]; comments; then dims line
    char* line;
    bool first = true;
    while ((line = m->lr.next_line(m->scratch)) != nullptr) {
        if (line[0] == '%') {
            if (first && strstr(line, "pattern")) m->pattern = true;
            first = false;
            continue;
        }
        char* end;
        m->nrow = strtoll(line, &end, 10);
        m->ncol = strtoll(end, &end, 10);
        m->nnz = strtoll(end, &end, 10);
        return m;
    }
    delete m;
    return nullptr;
}

void mtx_dims(void* h, int64_t* nrow, int64_t* ncol, int64_t* nnz) {
    auto* m = (MtxFile*)h;
    *nrow = m->nrow;
    *ncol = m->ncol;
    *nnz = m->nnz;
}

// Parse up to `cap` entries into 0-BASED row/col + value arrays.
// Returns count (0 at EOF, -1 on parse error).
long mtx_next_chunk(void* h, long cap, int64_t* rows, int64_t* cols, float* vals) {
    auto* m = (MtxFile*)h;
    long n = 0;
    char* line;
    while (n < cap && (line = m->lr.next_line(m->scratch)) != nullptr) {
        if (line[0] == '\0' || line[0] == '%') continue;
        char* end;
        int64_t r = strtoll(line, &end, 10);
        if (end == line) return -1;
        int64_t c = strtoll(end, &end, 10);
        double v = m->pattern ? 1.0 : strtod(end, &end);
        rows[n] = r - 1;
        cols[n] = c - 1;
        vals[n] = (float)v;
        n++;
    }
    return n;
}

void mtx_close(void* h) {
    auto* m = (MtxFile*)h;
    m->lr.close();
    delete m;
}

// ---------------------------------------------------------------------------
// ATAC fragments (chrom TAB start TAB end TAB barcode [TAB count])
// ---------------------------------------------------------------------------

void* frag_open(const char* path) {
    auto* f = new FragFile();
    if (!f->lr.open(path)) {
        delete f;
        return nullptr;
    }
    return f;
}

long frag_next_chunk(void* h, long cap, int64_t* chrom_id, int64_t* start,
                     int64_t* end_pos, int64_t* barcode_id, int32_t* count) {
    auto* f = (FragFile*)h;
    long n = 0;
    char* line;
    while (n < cap && (line = f->lr.next_line(f->scratch)) != nullptr) {
        if (line[0] == '\0' || line[0] == '#') continue;
        // chrom
        char* p = line;
        char* tab = strchr(p, '\t');
        if (!tab) continue;
        int64_t cid = f->chroms.intern(p, tab - p);
        char* end;
        int64_t s = strtoll(tab + 1, &end, 10);
        int64_t e = strtoll(end, &end, 10);
        // barcode
        while (*end == '\t' || *end == ' ') end++;
        char* bstart = end;
        while (*end && *end != '\t' && *end != ' ' && *end != '\r') end++;
        if (end == bstart) continue;
        int64_t bid = f->barcodes.intern(bstart, end - bstart);
        long cnt = 1;
        if (*end) {
            cnt = strtol(end, nullptr, 10);
            if (cnt <= 0) cnt = 1;
        }
        chrom_id[n] = cid;
        start[n] = s;
        end_pos[n] = e;
        barcode_id[n] = bid;
        count[n] = (int32_t)cnt;
        n++;
    }
    return n;
}

long frag_num_chroms(void* h) { return (long)((FragFile*)h)->chroms.names.size(); }
const char* frag_chrom(void* h, long i) { return ((FragFile*)h)->chroms.names[i].c_str(); }
long frag_num_barcodes(void* h) { return (long)((FragFile*)h)->barcodes.names.size(); }
const char* frag_barcode(void* h, long i) { return ((FragFile*)h)->barcodes.names[i].c_str(); }

void frag_close(void* h) {
    auto* f = (FragFile*)h;
    f->lr.close();
    delete f;
}

}  // extern "C"
