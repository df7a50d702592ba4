/* ref_driver — thin test-harness around the *reference* libxeve.a.
 *
 * Purpose: generate golden bitstreams/reconstructions for conformance
 * tests with full control over XEVE_PARAM fields (the stock xeve_app
 * leaves the per-tool CLI options unbound — app/xeve_app_args.h:1097
 * `#if 0` block — so Main-profile tool subsets can only be selected by
 * setting param fields directly).  This file is OUR test tooling; it
 * links against the prebuilt reference static library and uses only the
 * public API in xeve/inc/xeve.h.
 *
 * Usage:
 *   ref_driver -i in.yuv -w W -h H -f N -o out.evc [-r rec.yuv]
 *              [--profile baseline|main] [--preset fast|medium|slow|placebo]
 *              [--tune none|zerolatency|psnr] [-p key=value]...
 *
 * -p pairs are applied after xeve_param_ppt via xeve_param_parse, in
 * order, so any XEVE_PARAM field in xeve_params_metadata can be set
 * (e.g. -p tool_eipd=0 -p btt=0 -p qp=32 -p keyint=1 -p bframes=0).
 * Recon is written 2-byte little-endian at codec bit depth, display order
 * (same convention as the reference app's imgb_write).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "xeve.h"

#define MAX_BS_BUF (16 * 1024 * 1024)
#define MAX_PEND   64

static int dummy_ref(XEVE_IMGB *imgb) { (void)imgb; return 1; }

typedef struct {
    int            used;
    long long      pts;
    unsigned char *data; /* packed planes, display write-out */
    int            size;
} PENDING_REC;

static int imgb_pack(XEVE_IMGB *imgb, int width, int height, unsigned char **out)
{
    int bd = (XEVE_CS_GET_BIT_DEPTH(imgb->cs) == 8) ? 1 : 2;
    int total = 0, i, j;
    int w[3] = { width, width / 2, width / 2 };
    int h[3] = { height, height / 2, height / 2 };
    for (i = 0; i < imgb->np; i++) total += w[i] * h[i] * bd;
    unsigned char *buf = malloc(total), *p = buf;
    for (i = 0; i < imgb->np; i++) {
        unsigned char *src = (unsigned char *)imgb->a[i];
        for (j = 0; j < h[i]; j++) {
            memcpy(p, src + j * imgb->s[i], w[i] * bd);
            p += w[i] * bd;
        }
    }
    *out = buf;
    return total;
}

int main(int argc, char **argv)
{
    const char *fin = NULL, *fout = NULL, *frec = NULL;
    int width = 0, height = 0, frames = 0, input_depth = 8;
    int profile = XEVE_PROFILE_BASELINE, preset = XEVE_PRESET_MEDIUM, tune = XEVE_TUNE_NONE;
    const char *kv[256];
    int nkv = 0, i;

    for (i = 1; i < argc; i++) {
        if (!strcmp(argv[i], "-i")) fin = argv[++i];
        else if (!strcmp(argv[i], "-o")) fout = argv[++i];
        else if (!strcmp(argv[i], "-r")) frec = argv[++i];
        else if (!strcmp(argv[i], "-w")) width = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-h")) height = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-f")) frames = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-d")) input_depth = atoi(argv[++i]);
        else if (!strcmp(argv[i], "--profile")) {
            i++;
            profile = strcmp(argv[i], "main") ? XEVE_PROFILE_BASELINE : XEVE_PROFILE_MAIN;
        }
        else if (!strcmp(argv[i], "--preset")) {
            i++;
            if (!strcmp(argv[i], "fast")) preset = XEVE_PRESET_FAST;
            else if (!strcmp(argv[i], "medium")) preset = XEVE_PRESET_MEDIUM;
            else if (!strcmp(argv[i], "slow")) preset = XEVE_PRESET_SLOW;
            else if (!strcmp(argv[i], "placebo")) preset = XEVE_PRESET_PLACEBO;
        }
        else if (!strcmp(argv[i], "--tune")) {
            i++;
            if (!strcmp(argv[i], "zerolatency")) tune = XEVE_TUNE_ZEROLATENCY;
            else if (!strcmp(argv[i], "psnr")) tune = XEVE_TUNE_PSNR;
        }
        else if (!strcmp(argv[i], "-p")) kv[nkv++] = argv[++i];
        else { fprintf(stderr, "unknown arg %s\n", argv[i]); return 2; }
    }
    if (!fin || !fout || !width || !height || !frames) {
        fprintf(stderr, "need -i -o -w -h -f\n");
        return 2;
    }

    XEVE_CDSC cdsc;
    memset(&cdsc, 0, sizeof(cdsc));
    XEVE_PARAM *param = &cdsc.param;
    if (XEVE_FAILED(xeve_param_default(param))) return 3;
    if (XEVE_FAILED(xeve_param_ppt(param, profile, preset, tune))) return 3;
    param->w = width;
    param->h = height;
    for (i = 0; i < nkv; i++) {
        char name[128], *eq;
        strncpy(name, kv[i], sizeof(name) - 1);
        name[sizeof(name) - 1] = 0;
        eq = strchr(name, '=');
        if (!eq) { fprintf(stderr, "bad -p %s\n", kv[i]); return 2; }
        *eq = 0;
        if (XEVE_FAILED(xeve_param_parse(param, name, eq + 1))) {
            fprintf(stderr, "param parse failed: %s\n", kv[i]);
            return 3;
        }
    }
    param->cs = XEVE_CS_SET(XEVE_CF_YCBCR420, param->codec_bit_depth, 0);
    cdsc.max_bs_buf_size = MAX_BS_BUF;

    int err = 0;
    XEVE id = xeve_create(&cdsc, &err);
    if (!id) { fprintf(stderr, "xeve_create failed err=%d\n", err); return 4; }

    unsigned char *bs_buf = malloc(MAX_BS_BUF);
    XEVE_BITB bitb;
    memset(&bitb, 0, sizeof(bitb));
    bitb.addr  = bs_buf;
    bitb.bsize = MAX_BS_BUF;

    /* input imgb: the library copies planes on push, so only plane ptrs needed */
    int in_bd = (input_depth == 8) ? 1 : 2;
    XEVE_IMGB imgb;
    memset(&imgb, 0, sizeof(imgb));
    imgb.cs = XEVE_CS_SET(XEVE_CF_YCBCR420, input_depth, 0);
    imgb.np = 3;
    for (i = 0; i < 3; i++) {
        int pw = i ? width / 2 : width, ph = i ? height / 2 : height;
        imgb.w[i] = imgb.aw[i] = pw;
        imgb.h[i] = imgb.ah[i] = ph;
        imgb.s[i] = pw * in_bd;
        imgb.e[i] = ph;
        imgb.a[i] = malloc(pw * ph * in_bd);
        imgb.baddr[i] = imgb.a[i];
        imgb.bsize[i] = pw * ph * in_bd;
    }
    imgb.addref = imgb.getref = imgb.release = dummy_ref;

    FILE *fp_in  = fopen(fin, "rb");
    FILE *fp_out = fopen(fout, "wb");
    FILE *fp_rec = frec ? fopen(frec, "wb") : NULL;
    if (!fp_in || !fp_out) { fprintf(stderr, "io open failed\n"); return 5; }

    PENDING_REC pend[MAX_PEND];
    memset(pend, 0, sizeof(pend));
    long long next_out_pts = 0;
    int pushed = 0, done_push = 0, bumping = 0;

    while (1) {
        if (!done_push) {
            size_t need = (size_t)width * height * in_bd * 3 / 2, got = 0;
            if (pushed < frames) {
                got = fread(imgb.a[0], 1, (size_t)width * height * in_bd, fp_in);
                got += fread(imgb.a[1], 1, (size_t)width * height * in_bd / 4, fp_in);
                got += fread(imgb.a[2], 1, (size_t)width * height * in_bd / 4, fp_in);
            }
            if (pushed >= frames || got < need) {
                done_push = 1;
                if (!bumping) {
                    int v = 1, s = sizeof(int);
                    xeve_config(id, XEVE_CFG_SET_FORCE_OUT, &v, &s);
                    bumping = 1;
                }
            }
            else {
                imgb.ts[XEVE_TS_PTS] = pushed;
                if (XEVE_FAILED(xeve_push(id, &imgb))) { fprintf(stderr, "push failed\n"); return 6; }
                pushed++;
            }
        }
        XEVE_STAT stat;
        int ret = xeve_encode(id, &bitb, &stat);
        if (XEVE_FAILED(ret)) { fprintf(stderr, "encode failed ret=%d\n", ret); return 7; }
        if (ret == XEVE_OK_NO_MORE_FRM) break;
        if (ret == XEVE_OK_OUT_NOT_AVAILABLE) continue;
        if (ret == XEVE_OK) {
            if (stat.write > 0) fwrite(bs_buf, 1, stat.write, fp_out);
            if (fp_rec) {
                XEVE_IMGB *rec = NULL;
                int sz = sizeof(XEVE_IMGB **);
                if (XEVE_FAILED(xeve_config(id, XEVE_CFG_GET_RECON, (void *)&rec, &sz))) {
                    fprintf(stderr, "get recon failed\n");
                    return 8;
                }
                for (i = 0; i < MAX_PEND && pend[i].used; i++) ;
                if (i == MAX_PEND) { fprintf(stderr, "pend overflow\n"); return 8; }
                pend[i].used = 1;
                pend[i].pts  = rec->ts[XEVE_TS_PTS];
                pend[i].size = imgb_pack(rec, width, height, &pend[i].data);
                int flushed = 1;
                while (flushed) {
                    flushed = 0;
                    for (i = 0; i < MAX_PEND; i++) {
                        if (pend[i].used && pend[i].pts == next_out_pts) {
                            fwrite(pend[i].data, 1, pend[i].size, fp_rec);
                            free(pend[i].data);
                            pend[i].used = 0;
                            next_out_pts++;
                            flushed = 1;
                        }
                    }
                }
            }
        }
    }
    fclose(fp_out);
    if (fp_rec) fclose(fp_rec);
    fclose(fp_in);
    xeve_delete(id);
    printf("ok pushed=%d\n", pushed);
    return 0;
}
