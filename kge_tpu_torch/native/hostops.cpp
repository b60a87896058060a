// Host-side operations of kge_tpu_torch, in C++: the triple parser of
// the dataset loader and the stable counting sort of the R-GNN graph
// builders. Built at first use with g++ into kge_tpu_torch/_build/ and
// loaded with ctypes (kge_tpu_torch/native/__init__.py); every caller
// falls back to numpy, with the same results, where g++ is missing.

#include <cstdint>
#include <cstdio>
#include <cstdlib>

extern "C" {

// Parse whitespace-separated integer triples (the first three fields of
// each non-empty line; further fields ignored) into out[rows][3].
// Returns the rows parsed; -1 on an I/O error, -2 on a malformed line.
long parse_triples(const char* path, int32_t* out, long max_rows) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc((size_t)size + 1);
    if (!buf) {
        fclose(f);
        return -1;
    }
    long got = (long)fread(buf, 1, (size_t)size, f);
    fclose(f);
    buf[got] = 0;
    long rows = 0;
    const char* p = buf;
    const char* end = buf + got;
    while (p < end && rows < max_rows) {
        while (p < end && (*p == '\n' || *p == '\r')) p++;
        if (p >= end) break;
        int64_t vals[3] = {0, 0, 0};
        bool bad = false;
        for (int field = 0; field < 3; field++) {
            while (p < end && (*p == ' ' || *p == '\t')) p++;
            bool neg = false;
            if (p < end && *p == '-') {
                neg = true;
                p++;
            }
            if (p >= end || *p < '0' || *p > '9') {
                bad = true;
                break;
            }
            int64_t v = 0;
            while (p < end && *p >= '0' && *p <= '9') {
                v = v * 10 + (*p - '0');
                p++;
            }
            vals[field] = neg ? -v : v;
        }
        while (p < end && *p != '\n') p++;
        if (bad) {
            free(buf);
            return -2;
        }
        out[rows * 3 + 0] = (int32_t)vals[0];
        out[rows * 3 + 1] = (int32_t)vals[1];
        out[rows * 3 + 2] = (int32_t)vals[2];
        rows++;
    }
    free(buf);
    return rows;
}

// Stable counting sort of int32 keys in [0, N): writes the permutation
// that numpy's argsort(kind="stable") gives, in O(E + N). Returns 0;
// -1 when out of memory, -4 on a key outside [0, N).
long counting_argsort(const int32_t* keys, long E, long N,
                      int64_t* order_out) {
    int64_t* off = (int64_t*)calloc((size_t)N + 1, sizeof(int64_t));
    if (!off) return -1;
    for (long e = 0; e < E; e++) {
        if (keys[e] < 0 || keys[e] >= N) {
            free(off);
            return -4;
        }
        off[keys[e] + 1]++;
    }
    for (long i = 0; i < N; i++) off[i + 1] += off[i];
    for (long e = 0; e < E; e++) order_out[off[keys[e]]++] = e;
    free(off);
    return 0;
}

}  // extern "C"
