/* COCO RLE mask codec, called through ctypes.
 *
 * The reference framework does its mask boundary work in pycocotools' C
 * extension; this is the port's own codec for the COCO-JSON interchange
 * (``coco_to_tm`` / ``tm_to_coco``): encode and decode only, mask IoU stays a
 * dense product on the device. Built at first use with the system C compiler
 * (``cc -O2 -shared -fPIC``) by torchmetrics_tpu_torch.utilities.nvcc.load_c;
 * the pure-Python codec in functional/detection/_rle.py is its plain version
 * and the tests' reference.
 *
 * Conventions (COCO): column-major scan order; counts start with a zero
 * run; the string form packs counts as base-48 varints with 5-bit groups,
 * delta-coding counts[i>2] against counts[i-2].
 */

#include <stdint.h>
#include <stddef.h>

/* dense column-major-flattened mask (n bytes in {0,1}) -> counts.
 * counts_out must hold at least n+1 entries. Returns the run count. */
long tm_mask_to_counts(const uint8_t *flat, long n, long *counts_out) {
    long m = 0;
    if (n <= 0) return 0;
    if (flat[0] != 0) counts_out[m++] = 0; /* leading zero-run */
    uint8_t cur = flat[0];
    long run = 1;
    for (long i = 1; i < n; i++) {
        if (flat[i] == cur) {
            run++;
        } else {
            counts_out[m++] = run;
            cur = flat[i];
            run = 1;
        }
    }
    counts_out[m++] = run;
    return m;
}

/* counts -> dense column-major-flattened mask of n bytes. */
void tm_counts_to_mask(const long *counts, long m, uint8_t *flat, long n) {
    long pos = 0;
    uint8_t val = 0;
    for (long i = 0; i < n; i++) flat[i] = 0;
    for (long j = 0; j < m; j++) {
        long c = counts[j];
        if (val) {
            long end = pos + c;
            if (end > n) end = n;
            for (long i = pos; i < end; i++) flat[i] = 1;
        }
        pos += c;
        val ^= 1;
    }
}

/* counts -> compressed string (caller buffer: 13 bytes per count worst
 * case — a 64-bit negative delta emits 13 five-bit groups; the Python
 * caller allocates 16). Returns the encoded length. */
long tm_string_encode(const long *counts, long m, char *out) {
    long p = 0;
    for (long i = 0; i < m; i++) {
        long x = counts[i];
        if (i > 2) x -= counts[i - 2];
        int more = 1;
        while (more) {
            long chunk = x & 0x1f;
            x >>= 5;
            more = !((x == 0 && !(chunk & 0x10)) || (x == -1 && (chunk & 0x10)));
            if (more) chunk |= 0x20;
            out[p++] = (char)(chunk + 48);
        }
    }
    return p;
}

/* compressed string -> counts (counts_out sized >= string length).
 * Returns the run count, -1 on a truncated varint, -2 on an overlong
 * varint (>13 five-bit groups; no 64-bit value needs more). Accumulation
 * is unsigned so the 13th group's shift stays defined behavior. */
long tm_string_decode(const char *s, long len, long *counts_out) {
    long m = 0, p = 0;
    while (p < len) {
        unsigned long ux = 0;
        int k = 0, more = 1;
        while (more) {
            if (p >= len) return -1; /* continuation bit set on the last byte */
            if (k >= 13) return -2;  /* overlong varint */
            long c = (long)s[p] - 48;
            if (5 * k < 64) ux |= (unsigned long)(c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            p++;
            k++;
            if (!more && (c & 0x10) && 5 * k < 64) ux |= ~0UL << (5 * k);
        }
        long x = (long)ux;
        if (m > 2) x += counts_out[m - 2];
        counts_out[m++] = x;
    }
    return m;
}
