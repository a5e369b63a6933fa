// Fast numeric-table parser for LAMMPS data files — the native-code path of
// read_data (reference: src/read_data.cpp does its parsing in C++ too;
// SURVEY.md §2.11 item 7 escalates host parsing to native when multi-million
// particle files bottleneck startup: numpy.loadtxt costs ~1-2 us/number,
// strtof ~50 ns).
//
// C ABI only (consumed via ctypes — no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -o libtpusph_datafile.so datafile.cpp

#include <charconv>
#include <cstdlib>
#include <cstring>
#include <cctype>

extern "C" {

// Parse up to `nrows` whitespace-separated numeric rows of `ncols` columns
// from buf[0:len). Lines starting with '#' (after whitespace) and blank
// lines are skipped; a trailing inline comment ends a row's parse (columns
// already read are kept). Returns the number of complete rows parsed, or
// -(1 + row_index) on a malformed row (wrong column count / bad number).
long tpusph_parse_table(const char* buf, long len, long nrows, int ncols,
                        float* out) {
    const char* p = buf;
    const char* end = buf + len;
    long row = 0;
    while (row < nrows && p < end) {
        // skip leading whitespace / blank lines
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
            ++p;
        if (p >= end) break;
        if (*p == '#') {  // comment line
            while (p < end && *p != '\n') ++p;
            continue;
        }
        const char* line_start = p;
        int col = 0;
        while (col < ncols) {
            while (p < end && (*p == ' ' || *p == '\t')) ++p;
            if (p >= end || *p == '\n' || *p == '#') break;
            float v;
            // std::from_chars: locale-free, no strlen scan — ~4x strtof
            auto res = std::from_chars(p, end, v);
            if (res.ec != std::errc()) return -(1 + row);
            out[row * ncols + col] = v;
            p = res.ptr;
            ++col;
        }
        if (col != ncols) return -(1 + row);
        // consume the rest of the line (inline comments, extra columns)
        while (p < end && *p != '\n') ++p;
        ++row;
        (void)line_start;
    }
    return row;
}

// Count data rows (non-blank, non-comment) in buf — used to pre-validate.
long tpusph_count_rows(const char* buf, long len) {
    const char* p = buf;
    const char* end = buf + len;
    long rows = 0;
    while (p < end) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
            ++p;
        if (p >= end) break;
        if (*p != '#') ++rows;
        while (p < end && *p != '\n') ++p;
    }
    return rows;
}

}  // extern "C"
