/* Native FASTQ/FASTA chunk parser + base encoder.
 *
 * The native-runtime counterpart of the reference's bseq.c/kseq.h I/O
 * layer (/root/reference/bseq.c, kseq.h): parses a buffer of 4-line
 * FASTQ (or 2-line FASTA) records and writes 2-bit-codable base codes
 * directly into a padded [max_reads, max_len] matrix, plus raw quality
 * bytes and name/comment/sequence offsets into the source buffer.
 *
 * Only single-line records take this fast path; on any deviation
 * (multi-line sequence, CR endings mid-record, malformed input) the
 * function returns -1 and the Python caller falls back to the general
 * parser in bfc_jax.io.fastq.  Build: see bfc_jax/native/build.py.
 */

#include <stdint.h>
#include <string.h>

static unsigned char BASE_CODE[256];
static int base_code_init = 0;

static void init_base_code(void) {
    if (base_code_init) return;
    memset(BASE_CODE, 4, 256);
    BASE_CODE['A'] = BASE_CODE['a'] = 0;
    BASE_CODE['C'] = BASE_CODE['c'] = 1;
    BASE_CODE['G'] = BASE_CODE['g'] = 2;
    BASE_CODE['T'] = BASE_CODE['t'] = 3;
    base_code_init = 1;
}

/* Parse records from buf[0..n).  Returns the number of complete records
 * parsed (stopping at max_reads, a sequence longer than max_len, or the
 * end of the last complete record), or -1 if the buffer deviates from
 * the single-line fast path.  *consumed is set to the byte offset just
 * past the last parsed record. */
long fastx_parse_range(
    const char *buf, long n, int is_final,
    long max_reads, long max_len,
    unsigned char *bases,      /* [max_reads * max_len], pre-filled with 4 */
    unsigned char *quals,      /* [max_reads * max_len], pre-filled with 0 */
    int32_t *lens,             /* [max_reads] */
    int64_t *name_off, int32_t *name_len,
    int64_t *comm_off, int32_t *comm_len,   /* len -1 = no comment */
    int64_t *seq_off,
    int64_t *qual_off,         /* -1 = FASTA record */
    int64_t *consumed,
    long decode_lo, long decode_hi)
    /* decode_lo/decode_hi: write the bases/quals matrices only for rows
     * in [decode_lo, decode_hi).  Record structure (lens + all offsets)
     * is always parsed for every row, so raw text stays accessible via
     * the offsets.  Multi-host readers pass their owned row range: the
     * byte scan is shared, the decode work is 1/n_hosts per host. */
{
    long i = 0, r = 0;
    init_base_code();
    *consumed = 0;
    while (r < max_reads) {
        long rec_start = i;
        /* skip blank lines */
        while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
        rec_start = i;
        if (i >= n) break;
        char h = buf[i];
        if (h != '@' && h != '>') return -1;
        /* header line */
        long hs = ++i;
        while (i < n && buf[i] != '\n') i++;
        if (i >= n) break;                       /* incomplete header */
        long he = i;
        if (he > hs && buf[he - 1] == '\r') he--;
        i++;
        /* name = up to first whitespace, comment = rest */
        long ns = hs, ne = hs;
        while (ne < he && buf[ne] != ' ' && buf[ne] != '\t') ne++;
        /* sequence line */
        long ss = i;
        while (i < n && buf[i] != '\n') i++;
        if (i >= n && !is_final) break;
        long se = i;
        if (se > ss && buf[se - 1] == '\r') se--;
        long slen = se - ss;
        if (slen > max_len) break;               /* caller re-pads and retries */
        long qs = -1, qe = -1;
        if (i < n) i++;
        if (h == '@') {
            /* '+' separator line */
            if (i >= n) { if (!is_final) break; return -1; }
            if (buf[i] != '+') return -1;        /* multi-line seq: slow path */
            while (i < n && buf[i] != '\n') i++;
            if (i >= n) break;
            i++;
            /* quality line */
            qs = i;
            while (i < n && buf[i] != '\n') i++;
            if (i >= n && !is_final) break;
            qe = i;
            if (qe > qs && buf[qe - 1] == '\r') qe--;
            if (qe - qs != slen) return -1;      /* multi-line qual: slow path */
            if (i < n) i++;
        } else {
            /* FASTA fast path: next line must be a header (single-line seq) */
            if (i < n && buf[i] != '>' && buf[i] != '@' && buf[i] != '\n')
                return -1;
        }
        /* commit the record */
        name_off[r] = ns; name_len[r] = (int32_t)(ne - ns);
        if (ne < he) { comm_off[r] = ne + 1; comm_len[r] = (int32_t)(he - ne - 1); }
        else { comm_off[r] = 0; comm_len[r] = -1; }
        seq_off[r] = ss;
        qual_off[r] = qs;
        lens[r] = (int32_t)slen;
        if (r >= decode_lo && r < decode_hi) {
            unsigned char *brow = bases + r * max_len;
            const unsigned char *src = (const unsigned char *)buf + ss;
            long j;
            for (j = 0; j < slen; j++) brow[j] = BASE_CODE[src[j]];
            if (qs >= 0)
                memcpy(quals + r * max_len, buf + qs, slen);
        }
        r++;
        *consumed = i;
        (void)rec_start;
    }
    return r;
}

long fastx_parse(
    const char *buf, long n, int is_final,
    long max_reads, long max_len,
    unsigned char *bases, unsigned char *quals, int32_t *lens,
    int64_t *name_off, int32_t *name_len,
    int64_t *comm_off, int32_t *comm_len,
    int64_t *seq_off, int64_t *qual_off,
    int64_t *consumed)
{
    return fastx_parse_range(buf, n, is_final, max_reads, max_len,
                             bases, quals, lens, name_off, name_len,
                             comm_off, comm_len, seq_off, qual_off,
                             consumed, 0, max_reads);
}

/* ------------------------------------------------------------------ */
/* Batch record formatter: the native counterpart of the reference's
 * per-read output loop (/root/reference/correct.c:596-611).  Emits n
 * corrected/filtered records into outp, replacing the per-read Python
 * string assembly on the hot path.
 *
 * mode[i] bits: 0-1 = source (0 corrected rows, 1 original text from
 * buf, 3 drop), bit 2 = FASTQ (emit qual).  aux/aux2 are the packed
 * stats exactly as worker_ec packs them (correct.c:552-553); the
 * header tag is "ec:Z:<code>" plus, when code==0, the underscore
 * stats suffix.  Returns bytes written, or -1 if cap would overflow
 * (caller sizes cap from an exact upper bound, so -1 is a bug). */

static char *fmt_u64(char *p, uint64_t v) {
    char tmp[20];
    int t = 0;
    if (v == 0) { *p++ = '0'; return p; }
    while (v) { tmp[t++] = (char)('0' + (v % 10)); v /= 10; }
    while (t) *p++ = tmp[--t];
    return p;
}

long fastx_format(
    long n,
    const char *buf,                       /* raw input block */
    const int64_t *name_off, const int32_t *name_len,
    const int64_t *seq_off, const int64_t *qual_off,
    const unsigned char *seq_rows,         /* [n * lrow] final ASCII */
    const unsigned char *qual_rows,        /* [n * lrow] final ASCII */
    long lrow,
    const int32_t *lens,
    const uint64_t *aux, const uint64_t *aux2,
    const unsigned char *mode,
    char *outp, long cap)
{
    char *p = outp, *end = outp + cap;
    long i;
    for (i = 0; i < n; i++) {
        int src = mode[i] & 3;
        int is_fq = (mode[i] >> 2) & 1;
        long len = lens[i];
        uint64_t code = aux[i] & 7;
        if (src == 3) continue;                     /* dropped (-D) */
        if (p + name_len[i] + 2 * len + 96 > end) return -1;
        *p++ = is_fq ? '@' : '>';
        memcpy(p, buf + name_off[i], (size_t)name_len[i]);
        p += name_len[i];
        *p++ = '\t'; *p++ = 'e'; *p++ = 'c'; *p++ = ':'; *p++ = 'Z'; *p++ = ':';
        p = fmt_u64(p, code);
        if (code == 0) {
            *p++ = '_';
            p = fmt_u64(p, aux2[i] >> 10);          /* n_absent */
            *p++ = ':';
            p = fmt_u64(p, aux2[i] & 0xFF);         /* max_heap */
            *p++ = '_';
            p = fmt_u64(p, (aux[i] >> 3) & 1);      /* brute */
            *p++ = '_';
            p = fmt_u64(p, (aux[i] >> 18) & 0x3FFF);  /* n_ec */
            *p++ = ':';
            p = fmt_u64(p, (aux[i] >> 4) & 0x3FFF);   /* n_ec_high */
            *p++ = '_';
            p = fmt_u64(p, (aux2[i] >> 8) & 3);     /* rf_code */
        }
        *p++ = '\n';
        if (src == 1) memcpy(p, buf + seq_off[i], (size_t)len);
        else          memcpy(p, seq_rows + i * lrow, (size_t)len);
        p += len;
        *p++ = '\n';
        if (is_fq) {
            *p++ = '+'; *p++ = '\n';
            if (src == 1) memcpy(p, buf + qual_off[i], (size_t)len);
            else          memcpy(p, qual_rows + i * lrow, (size_t)len);
            p += len;
            *p++ = '\n';
        }
    }
    return (long)(p - outp);
}

/* Filter/trim-mode batch formatter (correct.c:596-611 with
 * filter_mode semantics): kept reads emit name + the [start, start+len)
 * substring of the ORIGINAL text; mode[i] bit0 = keep, bit2 = FASTQ.
 * Comment-less records only (the caller falls back to Python when any
 * read in the batch carries a comment).  Returns bytes written or -1
 * on insufficient cap. */
long fastx_format_trim(
    long n,
    const char *buf,
    const int64_t *name_off, const int32_t *name_len,
    const int64_t *seq_off, const int64_t *qual_off,
    const int32_t *start, const int32_t *tlen,
    const unsigned char *mode,
    char *outp, long cap)
{
    char *p = outp, *end = outp + cap;
    long i;
    for (i = 0; i < n; i++) {
        if (!(mode[i] & 1)) continue;            /* dropped */
        int is_fq = (mode[i] >> 2) & 1;
        long len = tlen[i];
        if (p + name_len[i] + 2 * len + 8 > end) return -1;
        *p++ = is_fq ? '@' : '>';
        memcpy(p, buf + name_off[i], (size_t)name_len[i]);
        p += name_len[i];
        *p++ = '\n';
        memcpy(p, buf + seq_off[i] + start[i], (size_t)len);
        p += len;
        *p++ = '\n';
        if (is_fq) {
            *p++ = '+'; *p++ = '\n';
            memcpy(p, buf + qual_off[i] + start[i], (size_t)len);
            p += len;
            *p++ = '\n';
        }
    }
    return (long)(p - outp);
}

/* ---- incremental Bloom adjudication kernels ------------------------
 *
 * The first-occurrence verdict (count.c:71-87 via bbf.c:27-37) only
 * needs each probed Bloom bit's GLOBAL minimum arrival, which is
 * associative: LSM spans scatter their partial minima into one dense
 * u32 array as they spill, and the final adjudicate becomes a gather
 * instead of a sort over every (bit, arrival) probe key.  Random
 * scatter/gather over a multi-hundred-MB array is latency-bound; a C
 * loop issues the dependent loads without numpy's ufunc.at dispatch
 * overhead (~30x measured on ufunc.at). */

void bloom_scatter_min_u32(uint32_t *dense, const uint64_t *bits,
                           const uint32_t *arr, long n, int h)
{
    long i;
    int j;
    for (i = 0; i < n; i++) {
        uint32_t a = arr[i];
        const uint64_t *b = bits + (size_t)i * (size_t)h;
        for (j = 0; j < h; j++) {
            uint32_t *p = dense + b[j];
            if (*p > a) *p = a;
        }
    }
}

/* out[i] = 1 iff every probed bit's min arrival is strictly earlier
 * than row i's own first arrival (the row's own scatter contributed
 * exactly arr[i], so equality means "set first by this k-mer"). */
void bloom_gather_verdict_u32(const uint32_t *dense, const uint64_t *bits,
                              const uint32_t *arr, long n, int h,
                              unsigned char *out)
{
    long i;
    int j;
    for (i = 0; i < n; i++) {
        uint32_t a = arr[i];
        const uint64_t *b = bits + (size_t)i * (size_t)h;
        unsigned char ok = 1;
        for (j = 0; j < h; j++)
            if (dense[b[j]] >= a) { ok = 0; break; }
        out[i] = ok;
    }
}

/* Inverted-storage variants: dense holds ~min_arrival with 0 meaning
 * "no probe yet" (min = UINT32_MAX).  The table can then be allocated
 * with calloc/np.zeros, whose pages fault in lazily as probed - a
 * memset-to-0xFF init commits the whole multi-GiB array upfront
 * (8 GiB at bf_shift=31 on every builder construction). */

void bloom_scatter_imin_u32(uint32_t *dense, const uint64_t *bits,
                            const uint32_t *arr, long n, int h)
{
    long i;
    int j;
    for (i = 0; i < n; i++) {
        uint32_t a = ~arr[i];
        const uint64_t *b = bits + (size_t)i * (size_t)h;
        for (j = 0; j < h; j++) {
            uint32_t *p = dense + b[j];
            if (*p < a) *p = a;
        }
    }
}

/* out[i] = 1 iff every probed bit's min arrival < arr[i]; with the
 * inverted storage, min < a  <=>  dense > ~a (unset 0 is never >). */
void bloom_gather_verdict_inv_u32(const uint32_t *dense,
                                  const uint64_t *bits,
                                  const uint32_t *arr, long n, int h,
                                  unsigned char *out)
{
    long i;
    int j;
    for (i = 0; i < n; i++) {
        uint32_t na = ~arr[i];
        const uint64_t *b = bits + (size_t)i * (size_t)h;
        unsigned char ok = 1;
        for (j = 0; j < h; j++)
            if (dense[b[j]] <= na) { ok = 0; break; }
        out[i] = ok;
    }
}

/* Arrival-ordered Bloom bit-array replay: exact first-occurrence
 * verdicts with ONE BIT per Bloom slot instead of the 4-byte
 * min-arrival sketch (64 GiB at bf_shift=34) or the probe sort (the
 * single-host human-scale finalize wall, 738 s at 1.1 B probe keys).
 * order[] visits rows by ascending first arrival (unique per row: a
 * first occurrence owns its stream slot); for each row compute its
 * n_hashes probe bits (bbf.c:27-37 addressing, identical to
 * bloom_probe_bits_np incl. the z<8 skip walk and the h2&31 fixup),
 * report whether ALL bits were set by EARLIER rows (query-all first,
 * matching the sort adjudicate's min<own semantics even when a row's
 * own probe bits collide), then set them. */
void bloom_replay_verdict_u64(const uint64_t *ret, const int64_t *order,
                              long n, int bf_shift, int h,
                              uint64_t *bitarr, unsigned char *out)
{
    int x = bf_shift - 9;
    uint64_t xmask = (((uint64_t)1) << x) - 1;
    uint64_t bits[64];
    long ii;
    int j, cnt;
    for (ii = 0; ii < n; ii++) {
        long i = (long)order[ii];
        uint64_t r = ret[i];
        uint64_t block = r & xmask;
        uint64_t h1 = (r >> x) & 511;
        uint64_t h2 = (r >> bf_shift) & 511;
        uint64_t base = block << 9;
        uint64_t z;
        unsigned char allset = 1;
        if ((h2 & 31) == 0) h2 = (h2 + 1) & 511;
        z = h1;
        cnt = 0;
        while (cnt < h) {
            if (z >= 8) bits[cnt++] = base | z;
            z = (z + h2) & 511;
        }
        for (j = 0; j < h; j++) {
            uint64_t b = bits[j];
            if (!(bitarr[b >> 6] & (((uint64_t)1) << (b & 63))))
                allset = 0;
        }
        for (j = 0; j < h; j++) {
            uint64_t b = bits[j];
            bitarr[b >> 6] |= ((uint64_t)1) << (b & 63);
        }
        out[i] = allset;
    }
}
