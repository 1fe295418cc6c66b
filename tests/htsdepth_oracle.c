/* htsdepth: an in-image INDEPENDENT per-site depth oracle with
 * `samtools depth -aa` semantics, built against the reference tree's
 * prebuilt htslib (/root/reference/lib/libhts.a).
 *
 * Why it exists: the reference's accuracy claim is consistency with
 * samtools depth >= 1.10 (/root/reference/README.md:147), but this
 * image ships no samtools and has no egress. This tool closes that
 * loop with counting machinery that shares NOTHING with PanDepth's
 * CIGAR loops (src/PanDepth.cpp:436-460) or with pandepth_jax's event
 * sweeps: htslib's own pileup engine (bam_plp) derives per-position
 * read stacks, and depth is simply the count of non-deletion,
 * non-refskip entries — exactly samtools depth's counting rule
 * (samtools/bam2depth.c semantics).
 *
 * Usage: htsdepth <in.bam|in.cram> [minMapQ] [flagmask]
 *   - prints "chrom\tpos1\tdepth" for ALL positions of ALL contigs
 *     (the -aa contract), depth 0 where no reads pile.
 *   - minMapQ: drop records with mapq < minMapQ (samtools -Q). The
 *     default -1 disables the filter (mirrors pandepth's hidden -q
 *     default, quirk Q2).
 *   - flagmask: drop records with (flag & mask) != 0; default 1796 =
 *     UNMAP|SECONDARY|QCFAIL|DUP, both tools' default.
 *
 * tests/test_samtools_oracle.py builds this on demand (like the
 * reference binary) and uses it whenever real samtools is absent.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "hts.h"
#include "sam.h"

typedef struct {
    samFile *fp;
    sam_hdr_t *hdr;
    int min_mapq;
    int flagmask;
} aux_t;

static int read_rec(void *data, bam1_t *b) {
    aux_t *aux = (aux_t *)data;
    int ret;
    for (;;) {
        ret = sam_read1(aux->fp, aux->hdr, b);
        if (ret < 0) break;
        if (b->core.flag & aux->flagmask) continue;
        if (aux->min_mapq >= 0 && (int)b->core.qual < aux->min_mapq)
            continue;
        break;
    }
    return ret;
}

/* print zero rows for positions [from, to) of contig tid (1-based) */
static void fill_zeros(sam_hdr_t *hdr, int tid, long from, long to) {
    const char *name = sam_hdr_tid2name(hdr, tid);
    for (long p = from; p < to; p++)
        printf("%s\t%ld\t0\n", name, p + 1);
}

int main(int argc, char **argv) {
    if (argc < 2) {
        fprintf(stderr,
                "usage: htsdepth <in.bam> [minMapQ] [flagmask]\n");
        return 2;
    }
    aux_t aux;
    aux.min_mapq = argc > 2 ? atoi(argv[2]) : -1;
    aux.flagmask = argc > 3 ? atoi(argv[3]) : 1796;
    aux.fp = sam_open(argv[1], "r");
    if (!aux.fp) { perror(argv[1]); return 1; }
    aux.hdr = sam_hdr_read(aux.fp);
    if (!aux.hdr) { fprintf(stderr, "bad header\n"); return 1; }

    bam_plp_t plp = bam_plp_init(read_rec, &aux);
    bam_plp_set_maxcnt(plp, 2147483647); /* no depth truncation */

    int tid, pos, n;
    int cur_tid = 0;   /* -aa cursor: next (tid, pos) owed a row */
    long cur_pos = 0;
    const bam_pileup1_t *v;
    while ((v = bam_plp_auto(plp, &tid, &pos, &n)) != 0) {
        /* zero-fill everything between the cursor and this column */
        while (cur_tid < tid) {
            fill_zeros(aux.hdr, cur_tid, cur_pos,
                       (long)sam_hdr_tid2len(aux.hdr, cur_tid));
            cur_tid++;
            cur_pos = 0;
        }
        fill_zeros(aux.hdr, tid, cur_pos, pos);
        int depth = 0;
        for (int j = 0; j < n; j++)
            if (!v[j].is_del && !v[j].is_refskip) depth++;
        printf("%s\t%d\t%d\n", sam_hdr_tid2name(aux.hdr, tid),
               pos + 1, depth);
        cur_tid = tid;
        cur_pos = (long)pos + 1;
    }
    /* trailing contigs / tail of the last one */
    while (cur_tid < sam_hdr_nref(aux.hdr)) {
        fill_zeros(aux.hdr, cur_tid, cur_pos,
                   (long)sam_hdr_tid2len(aux.hdr, cur_tid));
        cur_tid++;
        cur_pos = 0;
    }
    bam_plp_destroy(plp);
    sam_hdr_destroy(aux.hdr);
    sam_close(aux.fp);
    return 0;
}
