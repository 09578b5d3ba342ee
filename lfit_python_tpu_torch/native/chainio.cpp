// Fast chain-file text IO: the native writer and reader of the port.
//
// A copy of lfit_python_tpu/native/chainio.cpp.  The fit's persistent
// output is the incrementally appended chain text file; at production
// scale (4096 walkers x ~30 parameters x 1e4 steps) formatting its rows
// in Python is slow next to the sampler on the card, so this C++ core
// formats and parses them.  It has a plain C interface, is built by g++
// and loaded with ctypes (lfit_python_tpu_torch/native/__init__.py).
//
// Row format (identical to lfit_python_tpu_torch/utils/chains.py):
// walker_index p0 ... pD lnp

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Append n_rows rows. data is row-major (n_rows x (n_cols)), where
// column 0 is the walker index (written as an integer) and the remaining
// columns are written as %.10e. Returns 0 on success, -1 on IO error.
int chainio_write(const char *path, const double *data, long n_rows,
                  long n_cols) {
    FILE *fh = std::fopen(path, "ab");
    if (!fh) return -1;
    // one formatted row: 4 (idx) + (n_cols-1) * 18 + newline, padded
    long bufcap = 32 + 20 * n_cols;
    char *buf = (char *)std::malloc(bufcap);
    if (!buf) { std::fclose(fh); return -1; }
    for (long r = 0; r < n_rows; ++r) {
        const double *row = data + r * n_cols;
        char *p = buf;
        p += std::snprintf(p, 16, "%ld", (long)row[0]);
        for (long c = 1; c < n_cols; ++c) {
            *p++ = ' ';
            p += std::snprintf(p, 20, "%.10e", row[c]);
        }
        *p++ = '\n';
        if (std::fwrite(buf, 1, (size_t)(p - buf), fh) != (size_t)(p - buf)) {
            std::free(buf);
            std::fclose(fh);
            return -1;
        }
    }
    std::free(buf);
    if (std::fclose(fh) != 0) return -1;
    return 0;
}

// Count data rows (non-empty, non-'#') in a chain file. Returns -1 on
// error. Used to pre-size the read buffer.
long chainio_count_rows(const char *path) {
    FILE *fh = std::fopen(path, "rb");
    if (!fh) return -1;
    long rows = 0;
    int c, prev = '\n';
    bool comment = false, has_data = false;
    while ((c = std::fgetc(fh)) != EOF) {
        if (prev == '\n') {
            comment = (c == '#');
            has_data = false;
        }
        if (c == '\n') {
            if (!comment && has_data) ++rows;
        } else if (!comment && c != ' ' && c != '\t' && c != '\r') {
            has_data = true;
        }
        prev = c;
    }
    if (prev != '\n' && !comment && has_data) ++rows;
    std::fclose(fh);
    return rows;
}

// Parse up to max_rows rows of n_cols doubles into out (row-major).
// Skips '#' comment lines. Returns rows parsed, or -1 on error.
long chainio_read(const char *path, double *out, long max_rows,
                  long n_cols) {
    FILE *fh = std::fopen(path, "rb");
    if (!fh) return -1;
    char line[1 << 16];
    long rows = 0;
    while (rows < max_rows && std::fgets(line, sizeof line, fh)) {
        char *p = line;
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '#' || *p == '\n' || *p == '\0') continue;
        double *row = out + rows * n_cols;
        long c = 0;
        char *end;
        while (c < n_cols) {
            double v = std::strtod(p, &end);
            if (end == p) break;
            row[c++] = v;
            p = end;
        }
        if (c == n_cols) ++rows;
    }
    std::fclose(fh);
    return rows;
}

}  // extern "C"
