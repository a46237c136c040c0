// Native FASTQ/FASTA fast path (reference SeqReader/SeqManager analog,
// SURVEY.md §1 L2): parse + base-encode + Phred decode in C++ so the host
// IO thread keeps up with the device.  The PWM quantization stays in
// NumPy/Python (vectorized, not the bottleneck); this file turns raw FASTQ
// bytes into fixed-shape code/qual arrays.
//
// Build: make -C gnumap_tpu/native

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

int8_t lut[256];
struct LutInit {
    LutInit() {
        memset(lut, 4, sizeof lut);
        lut[(int)'A'] = lut[(int)'a'] = 0;
        lut[(int)'C'] = lut[(int)'c'] = 1;
        lut[(int)'G'] = lut[(int)'g'] = 2;
        lut[(int)'T'] = lut[(int)'t'] = 3;
    }
} lut_init;

}  // namespace

extern "C" {

// Parse a FASTQ chunk (complete records only).  Writes up to max_reads
// records into fixed-shape buffers:
//   codes[max_reads][max_len]  int8, pad 4 (N)
//   quals[max_reads][max_len]  int16, pad 0
//   lens[max_reads]            int32
//   name_buf                   '\0'-joined names, name_off[max_reads]
// Returns number of reads parsed; *consumed = bytes of chunk consumed
// (callers carry the tail over to the next chunk); *n_truncated = reads in
// this chunk whose sequence exceeded max_len (truncated, caller logs).
int32_t parse_fastq_chunk(const char* buf, int64_t n, int32_t max_reads,
                          int32_t max_len, int32_t phred_offset,
                          int32_t is_final,
                          int8_t* codes, int16_t* quals, int32_t* lens,
                          char* name_buf, int64_t name_cap,
                          int64_t* name_off, int64_t* consumed,
                          int64_t* n_truncated) {
    int64_t pos = 0, nb = 0, trunc = 0;
    int32_t nr = 0;
    while (nr < max_reads) {
        int64_t rec_start = pos;
        // line 1: @name
        if (pos >= n || buf[pos] != '@') break;
        int64_t e1 = pos;
        while (e1 < n && buf[e1] != '\n') ++e1;
        if (e1 >= n) break;
        // line 2: sequence
        int64_t s2 = e1 + 1, e2 = s2;
        while (e2 < n && buf[e2] != '\n') ++e2;
        if (e2 >= n) break;
        // line 3: +
        int64_t s3 = e2 + 1, e3 = s3;
        while (e3 < n && buf[e3] != '\n') ++e3;
        if (e3 >= n) break;
        // line 4: qualities
        int64_t s4 = e3 + 1, e4 = s4;
        while (e4 < n && buf[e4] != '\n') ++e4;
        // a record whose qual line has no trailing newline is only complete
        // at end of file — otherwise wait for the next chunk
        if (e4 >= n && !is_final) break;

        int64_t L = e2 - s2;
        if (e4 - s4 < L) break;                        // truncated quals
        if (L > max_len) ++trunc;
        int32_t Lc = L > max_len ? max_len : (int32_t)L;
        int8_t* crow = codes + (int64_t)nr * max_len;
        int16_t* qrow = quals + (int64_t)nr * max_len;
        memset(crow, 4, max_len);
        memset(qrow, 0, (size_t)max_len * sizeof(int16_t));
        for (int32_t k = 0; k < Lc; ++k) {
            crow[k] = lut[(uint8_t)buf[s2 + k]];
            int16_t q = (int16_t)((uint8_t)buf[s4 + k] - phred_offset);
            qrow[k] = q < 0 ? 0 : q;
        }
        lens[nr] = Lc;
        // name: up to first whitespace after '@'
        int64_t ne = pos + 1;
        while (ne < e1 && buf[ne] != ' ' && buf[ne] != '\t') ++ne;
        int64_t nlen = ne - (pos + 1);
        if (nb + nlen + 1 > name_cap) break;
        memcpy(name_buf + nb, buf + pos + 1, nlen);
        name_off[nr] = nb;
        nb += nlen;
        name_buf[nb++] = '\0';
        ++nr;
        pos = e4 < n ? e4 + 1 : n;
        (void)rec_start;
    }
    *consumed = pos;
    *n_truncated = trunc;
    return nr;
}

}  // extern "C"

extern "C" {

// CSR k-mer index build (reference Genome::LoadGenome hash-build loop,
// SURVEY.md §3.2) as a two-pass counting sort: O(G) instead of the
// O(G log G) argsort fallback.  Produces byte-identical CSR arrays
// (positions ascending within each bucket).
//   codes: int8[G] (0..3, 4 = N)
//   bucket_start: int32[4^m + 1], caller-zeroed
//   positions: int32[G] capacity
// Returns number of indexed positions.
int64_t build_csr_index(const int8_t* codes, int64_t G, int32_t m,
                        int32_t* bucket_start, int32_t* positions) {
    const int64_t nb = (int64_t)1 << (2 * m);
    const uint32_t mask = (uint32_t)(nb - 1);
    // pass 1: counts (shifted by one: bucket_start[k+1] accumulates count k)
    uint32_t code = 0;
    int64_t last_n = -1;              // most recent N position
    for (int64_t p = 0; p < G; ++p) {
        int8_t b = codes[p];
        if (b > 3) { last_n = p; b = 0; }
        code = ((code << 2) | (uint32_t)b) & mask;
        int64_t start = p - m + 1;    // k-mer starting position
        if (start >= 0 && last_n < start)
            ++bucket_start[code + 1];
    }
    // prefix sum
    for (int64_t k = 0; k < nb; ++k)
        bucket_start[k + 1] += bucket_start[k];
    const int64_t total = bucket_start[nb];
    // pass 2: scatter in position order (keeps buckets ascending);
    // use a rolling write cursor per bucket stored in a scratch copy
    std::vector<int32_t> cursor(bucket_start, bucket_start + nb);
    code = 0;
    last_n = -1;
    for (int64_t p = 0; p < G; ++p) {
        int8_t b = codes[p];
        if (b > 3) { last_n = p; b = 0; }
        code = ((code << 2) | (uint32_t)b) & mask;
        int64_t start = p - m + 1;
        if (start >= 0 && last_n < start)
            positions[cursor[code]++] = (int32_t)start;
    }
    return total;
}

}  // extern "C"
