// Fast dump-row formatter — the native half of the dump writer
// (io/dump.py). The reference writes dump frames from C++ (src/dump.cpp
// Dump::write); Python "%.8g" row loops cost seconds per 1M-particle
// frame, so the hot formatting lives here. Bound via ctypes (see
// native/__init__.py); io/dump.py falls back to the Python loop when the
// toolchain is unavailable.
//
// Contract: data is row-major (nrows, ncols) float32; int_mask[c] != 0
// marks integer columns (formatted %lld via llround — matching the Python
// path, which also round-trips ids through float32). Returns bytes
// written, or -1 if out_cap would overflow (caller re-sizes).

#include <cstdint>
#include <cstdio>
#include <cmath>

extern "C" {

long tpusph_format_rows(const float* data, long nrows, int ncols,
                        const int* int_mask, char* out, long out_cap) {
    char* p = out;
    char* end = out + out_cap - 1;
    for (long r = 0; r < nrows; ++r) {
        const float* row = data + (long)r * ncols;
        for (int c = 0; c < ncols; ++c) {
            if (end - p < 32) return -1;
            if (c) *p++ = ' ';
            if (int_mask[c]) {
                p += std::snprintf(p, end - p, "%lld",
                                   (long long)llroundf(row[c]));
            } else {
                p += std::snprintf(p, end - p, "%.8g", (double)row[c]);
            }
        }
        if (end - p < 2) return -1;
        *p++ = '\n';
    }
    *p = '\0';
    return (long)(p - out);
}

}  // extern "C"
