// Native host-side data plane for ivfhnsw_tpu.
//
// The reference engine is entirely C++ (SURVEY.md §2); in the JAX
// re-architecture the device compute is JAX/XLA/Pallas, and C++ carries the
// host-side hot paths that feed it at 10^9-vector scale:
//
//  - streaming xvec decode: strip 4-byte dim prefixes and promote u8 -> f32
//    in one pass (readXvecFvec equivalent, reference utils.h:112-127),
//    feeding host->device transfer buffers without intermediate numpy
//    copies;
//  - length-prefixed vector series parsing: the reference .index format
//    stores 3 x nc length-prefixed arrays (IndexIVF_HNSW.cpp:637-779); at
//    nc = 2^20 a per-vector Python loop is millions of object operations,
//    while this is one linear scan producing the flat arrays the device
//    store wants.
//
// Exposed as a plain C ABI consumed via ctypes (ivfhnsw_tpu/utils/native.py).

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Read n xvec records of dimension d starting at record `offset`, promoting
// payloads to f32. elem_kind: 0 = u8 (bvecs), 1 = f32 (fvecs), 2 = i32
// (ivecs). Returns number of records read, or -1 on error (bad dim prefix /
// IO error).
int64_t xvec_read_f32(const char* path, int64_t d, int64_t offset,
                      int64_t n, int32_t elem_kind, float* out) {
    const int64_t esize = (elem_kind == 0) ? 1 : 4;
    const int64_t rec = 4 + d * esize;
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    if (fseeko(f, offset * rec, SEEK_SET) != 0) { fclose(f); return -1; }

    // Read in ~4MB slabs and decode in-place.
    const int64_t recs_per_slab = (4 << 20) / rec > 0 ? (4 << 20) / rec : 1;
    char* slab = new char[recs_per_slab * rec];
    int64_t done = 0;
    while (done < n) {
        int64_t want = n - done < recs_per_slab ? n - done : recs_per_slab;
        size_t got = fread(slab, (size_t)rec, (size_t)want, f);
        if (got == 0) break;
        for (size_t i = 0; i < got; i++) {
            const char* p = slab + i * rec;
            uint32_t dim;
            memcpy(&dim, p, 4);
            if ((int64_t)dim != d) { delete[] slab; fclose(f); return -1; }
            float* dst = out + (done + (int64_t)i) * d;
            const char* payload = p + 4;
            if (elem_kind == 0) {
                const uint8_t* s = (const uint8_t*)payload;
                for (int64_t j = 0; j < d; j++) dst[j] = (float)s[j];
            } else if (elem_kind == 1) {
                memcpy(dst, payload, (size_t)d * 4);
            } else {
                const int32_t* s = (const int32_t*)payload;
                for (int64_t j = 0; j < d; j++) dst[j] = (float)s[j];
            }
        }
        done += (int64_t)got;
        if ((int64_t)got < want) break;
    }
    delete[] slab;
    fclose(f);
    return done;
}

// Scan a series of `n` length-prefixed vectors ([u32 count | count*esize])
// starting at byte `pos` in `buf`, concatenating payloads into `out_data`
// (caller-sized; pass capacity in bytes) and writing per-vector element
// counts into out_counts. Returns the byte position after the series, or -1
// on overflow/overrun.
int64_t lenvec_concat(const uint8_t* buf, int64_t buf_len, int64_t pos,
                      int64_t n, int64_t esize, uint8_t* out_data,
                      int64_t out_capacity, int64_t* out_counts) {
    int64_t written = 0;
    for (int64_t i = 0; i < n; i++) {
        if (pos + 4 > buf_len) return -1;
        uint32_t count;
        memcpy(&count, buf + pos, 4);
        pos += 4;
        const int64_t bytes = (int64_t)count * esize;
        if (pos + bytes > buf_len || written + bytes > out_capacity)
            return -1;
        memcpy(out_data + written, buf + pos, (size_t)bytes);
        pos += bytes;
        written += bytes;
        out_counts[i] = (int64_t)count;
    }
    return pos;
}

// Sum of payload element counts for a series of n length-prefixed vectors
// (sizing pass). Returns total elements, or -1 on overrun. Writes the end
// position to *end_pos.
int64_t lenvec_total(const uint8_t* buf, int64_t buf_len, int64_t pos,
                     int64_t n, int64_t esize, int64_t* end_pos) {
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) {
        if (pos + 4 > buf_len) return -1;
        uint32_t count;
        memcpy(&count, buf + pos, 4);
        pos += 4 + (int64_t)count * esize;
        if (pos > buf_len) return -1;
        total += (int64_t)count;
    }
    *end_pos = pos;
    return total;
}

// Inverse of lenvec_concat: interleave a flat payload (records concatenated
// in order) with u32 element-count prefixes, producing the serialized
// [u32 count | count*esize]* series in one pass. out must have capacity
// 4*n + payload_len bytes. Returns bytes written, or -1 if the counts sum
// to more than payload_len or any count exceeds u32 range.
int64_t lenvec_interleave(const uint8_t* payload, int64_t payload_len,
                          const int64_t* counts, int64_t n, int64_t esize,
                          uint8_t* out) {
    int64_t src = 0, dst = 0;
    for (int64_t i = 0; i < n; i++) {
        if (counts[i] < 0 || counts[i] > 0xffffffffLL) return -1;
        const uint32_t count = (uint32_t)counts[i];
        const int64_t bytes = (int64_t)count * esize;
        if (src + bytes > payload_len) return -1;
        memcpy(out + dst, &count, 4);
        memcpy(out + dst + 4, payload + src, (size_t)bytes);
        src += bytes;
        dst += 4 + bytes;
    }
    return dst;
}

}  // extern "C"
