/* Shared declarations for the native decode core.
 *
 * The native tier implements the decoder's serial host work — MSAC
 * entropy decode, the block-mode walk (decode_sb/decode_b), ref-MV
 * prediction, and the pass-1 capture emission — with bit-exact parity
 * to the Python reference modules (dav1d_tpu/decode/tile.py,
 * dav1d_tpu/refmvs.py, dav1d_tpu/recon/coef.py).  Pixel math stays on
 * the device (JAX/XLA/Pallas) or in the batched host kernels.
 *
 * All multi-dimensional array strides here are FIXED by the shapes the
 * Python side allocates (asserted in native/decode_glue.py).
 */

#ifndef DTPU_H
#define DTPU_H

#include <stdint.h>
#include <stddef.h>

/* ---- MSAC --------------------------------------------------------------- */

typedef struct {
    const uint8_t *buf;
    uint64_t pos, end;
    uint64_t dif;
    uint32_t rng;
    int32_t cnt;
    int32_t allow_update_cdf;
} DtpuMsac;

void dtpu_msac_init(DtpuMsac *s, const uint8_t *buf, uint64_t start,
                    uint64_t end, int disable_cdf_update);
int dtpu_decode_bool_equi(DtpuMsac *s);
int dtpu_decode_bool(DtpuMsac *s, unsigned f);
int dtpu_decode_symbol_adapt(DtpuMsac *s, uint16_t *cdf, size_t n_symbols);
int dtpu_decode_bool_adapt(DtpuMsac *s, uint16_t *cdf);
int dtpu_decode_hi_tok(DtpuMsac *s, uint16_t *cdf);
unsigned dtpu_decode_bools(DtpuMsac *s, unsigned n);
int dtpu_decode_uniform(DtpuMsac *s, unsigned n);
int dtpu_decode_subexp(DtpuMsac *s, int ref, int n, unsigned k);

/* ---- coefficient decode -------------------------------------------------- */

typedef struct DtpuCoefCtx {
    /* per-tile CDF base pointers (numpy uint16, updated in place) */
    uint16_t *skip;          /* [5][13][2] */
    uint16_t *txtp_intra1;   /* [2][13][8] */
    uint16_t *txtp_intra2;   /* [3][13][8] */
    uint16_t *txtp_inter1;   /* [2][16] */
    uint16_t *txtp_inter2;   /* [16] */
    uint16_t *txtp_inter3;   /* [4][2] */
    uint16_t *eob_bin[7];    /* 16/32/64/128: [2][2][8]; 256: [2][2][16];
                                512/1024: [2][16] */
    uint16_t *eob_hi_bit;    /* [5][2][9][2] */
    uint16_t *eob_base_tok;  /* [5][2][4][4] */
    uint16_t *base_tok;      /* [5][2][41][4] */
    uint16_t *br_tok;        /* [4][2][21][4] */
    uint16_t *dc_sign;       /* [2][3][2] */
    /* static normative tables */
    const uint8_t *txfm_info;        /* [19][8]: w4,h4,lw,lh,min,max,sub,ctx */
    const uint8_t *block_dim;        /* [22][4] */
    const uint8_t *skip_ctx_tbl;     /* [5][5] */
    const uint8_t *txtp_from_uvmode; /* [14] */
    const uint8_t *tx_types_per_set; /* [40] */
    const uint8_t *tx_type_class;    /* [17] */
    const uint8_t *lo_ctx_offsets;   /* [3][5][5] */
    const uint16_t *scans[19];
    /* frame constants */
    int32_t layout;                  /* PixelLayout value */
    uint32_t cf_max;
} DtpuCoefCtx;

int dtpu_decode_coefs(
    DtpuCoefCtx *cx, DtpuMsac *s,
    const uint8_t *a, int a_off, const uint8_t *l, int l_off,
    int tx, int bs, int intra, int plane,
    int y_mode_nofilt, int uv_mode, int ytxtp,
    int lossless, int qidx_nonzero, int reduced_txtp_set,
    int dq0, int dq1, const uint8_t *qm,
    int32_t *cf, int *eob_out);

/* ---- deblock edge planes --------------------------------------------------
 * wd_v / wd_h are the frame-wide byte planes of per-cell edge width
 * classes (class+1; 0 = no filter), row stride `stride`.  See
 * recon/lf.py for the formulation. */

void dtpu_mask_edges_intra(uint8_t *wd_v, uint8_t *wd_h, int64_t stride,
                           int by, int bx, int w4, int h4,
                           int twl4c, int thl4c, int tw, int th,
                           uint8_t *a, uint8_t *l);
void dtpu_mask_edges_chroma(uint8_t *wd_v, uint8_t *wd_h, int64_t stride,
                            int cby, int cbx, int cw4, int ch4,
                            int skip_inter, int twl4c, int thl4c,
                            int tw, int th, uint8_t *a, uint8_t *l);
void dtpu_mask_edges_inter(uint8_t *wd_v, uint8_t *wd_h, int64_t stride,
                           int by, int bx, int w4, int h4,
                           int skip, int max_tx, uint32_t tx_split0,
                           uint32_t tx_split1, const uint8_t *ti_tbl,
                           uint8_t *a, uint8_t *l);
/* ---- ref-MV structures ---------------------------------------------------- */

/* Per-4x4 MV grid cell — layout must match refmvs.py RB_DT (12 bytes). */
typedef struct {
    int16_t mv[2][2]; /* [n][0]=y, [n][1]=x */
    int8_t ref[2];
    uint8_t bs;
    uint8_t mf; /* bit0: globalmv, bit1: newmv */
} RefMvsBlock;

/* Temporal MV cell — layout must match refmvs.py TMV_DT (5 bytes, packed). */
#pragma pack(push, 1)
typedef struct {
    int16_t mv[2]; /* y, x */
    int8_t ref;
} TmvBlock;
#pragma pack(pop)

/* Global-motion params per reference (subset of WarpedMotionParams). */
typedef struct {
    int32_t type;      /* 0 identity, 1 translation, 2 rot-zoom, 3 affine */
    int32_t matrix[6];
} DtpuGmv;

/* Frame-level ref-MV state (refmvs.py RefMvsFrame). */
typedef struct {
    RefMvsBlock *r;    /* (rh+1, r_stride) grid */
    TmvBlock *rp;      /* (rh>>1, rp_stride) current-frame tmvs */
    TmvBlock *rp_ref[7];  /* saved tmvs of the mfmv refs (or NULL) */
    TmvBlock *rp_proj; /* (rh>>1, rp_stride) projected motion field */
    int32_t r_stride, rp_stride;
    int32_t iw4, ih4, iw8, ih8;
    int32_t sign_bias[7], mfmv_sign[7], pocdiff[7];
    int32_t n_mfmvs;
    int32_t mfmv_ref[3], mfmv_ref2cur[3], mfmv_ref2ref[3][7];
    int32_t use_ref_frame_mvs;
    /* frame-header bits the MV math needs */
    int32_t force_integer_mv, hp, use_frame_ref_mvs_hdr;
    DtpuGmv gmv[7];
} DtpuRefMvsFrame;

typedef struct {
    int32_t mv[2][2]; /* [idx][y, x] */
    int32_t weight;
} DtpuMvCand;

int dtpu_refmvs_find(const DtpuRefMvsFrame *rf,
                     int tile_col_start4, int tile_col_end4,
                     int tile_row_start4, int tile_row_end4,
                     int ref0, int ref1, int bs, int edge_flags,
                     int by4, int bx4, const uint8_t *block_dim,
                     DtpuMvCand *mvstack /* [8+] */, int *out_ctx);

void dtpu_splat_mv(DtpuRefMvsFrame *rf, int by4, int bx4, int bw4, int bh4,
                   int mvy0, int mvx0, int mvy1, int mvx1,
                   int ref0, int ref1, int bs, int mf);

void dtpu_load_tmvs(const DtpuRefMvsFrame *rf, int col_start8, int col_end8,
                    int row_start8, int row_end8);

void dtpu_save_tmvs(const DtpuRefMvsFrame *rf, const uint8_t *mfmv_sign,
                    int col_start8, int col_end8, int row_start8,
                    int row_end8);

void dtpu_get_gmv_2d(const DtpuGmv *gm, int bx4, int by4, int bw4, int bh4,
                     int force_integer_mv, int hp, int *out_y, int *out_x);

/* ---- pass-1 capture records ----------------------------------------------- */

/* One decoded block — layout mirrored by decode_glue.py CAP_BLOCK_DT. */
typedef struct {
    uint16_t bx, by;
    uint8_t bs, bl, bp, kind; /* kind: 0 intra, 1 inter, 2 intrabc */
    uint8_t skip, skip_mode, seg_id, edge_flags;
    uint8_t y_mode, uv_mode, tx, uvtx;
    int8_t y_angle, uv_angle;
    int8_t cfl_alpha[2];
    uint8_t pal_sz[2], sm_flags, filter2d;
    uint8_t max_ytx, comp_type, inter_mode, motion_mode;
    uint8_t drl_idx, interintra_type, interintra_mode, wedge_idx;
    uint8_t mask_sign, tx_split0, pad0, pad1;
    uint16_t tx_split1, pad2;
    int16_t mv[2][2]; /* [idx][y, x] */
    int32_t warp_idx;               /* index into warp arena or -1 */
    int32_t obmc_start, obmc_count; /* into obmc arena */
    int32_t sub8x8;                 /* -1 or tl | left<<8 | top<<16 */
    int32_t coef_start, coef_count; /* into coef meta */
    int32_t pal_idx;     /* palette colors slot or -1 */
    int32_t pal_y_off;   /* offset into pal index arena or -1 */
    int32_t pal_uv_off;
} CapBlock; /* 76 bytes */

/* Coefficient meta row (int32 x 6): eob, txtp, plane | tx<<8, dst_y,
 * dst_x, cf_off (into the int32 cf arena; -1 when eob < 0). */
#define CAP_COEF_WORDS 6

/* OBMC neighbour task — mirrored by CAP_OBMC_DT. */
typedef struct {
    uint8_t kind; /* 0 top, 1 left */
    uint8_t off;
    int16_t mv[2];
    int8_t refidx;
    uint8_t f2d, step4, pad;
} CapObmc; /* 8 bytes */

/* Captured warp params — mirrored by CAP_WARP_DT. */
typedef struct {
    int32_t matrix[6];
    int16_t abcd[4];
    int32_t type;
} CapWarp; /* 36 bytes */

/* ---- block contexts -------------------------------------------------------- */

/* Above/left neighbour context — single-buffer layout mirrored by
 * tile.py BlockContext (624 bytes). */
typedef struct {
    uint8_t mode[32];
    uint8_t lcoef[32];
    uint8_t ccoef[2][32];
    uint8_t seg_pred[32];
    uint8_t skip[32];
    uint8_t skip_mode[32];
    uint8_t intra[32];
    uint8_t comp_type[32];
    int8_t ref[2][32];
    uint8_t filter[2][32];
    int8_t tx_intra[32];
    int8_t tx[32];
    uint8_t tx_lpf_y[32];
    uint8_t tx_lpf_uv[32];
    uint8_t partition[16];
    uint8_t uvmode[32];
    uint8_t pal_sz[32];
} BlockCtx;

/* Per-segment feature data (headers.py SegmentationData.d entries). */
typedef struct {
    int32_t delta_q, delta_lf_y_v, delta_lf_y_h, delta_lf_u, delta_lf_v;
    int32_t ref, skip, globalmv;
    int32_t lossless, qidx;
} DtpuSegData;

/* Loop-restoration unit (dense (sb128, 3 planes, 4 units) grid) —
 * mirrored by LR_UNIT_DT (18 bytes, packed int16). */
#pragma pack(push, 1)
typedef struct {
    int16_t type;
    int16_t filter_v[3], filter_h[3];
    int16_t sgr_weights[2];
} DtpuLrUnit;
#pragma pack(pop)

/* ---- intra-edge availability tree ----------------------------------------
 * Flattened by the Python glue from intra_edge.py INTRA_EDGE_TREE: branch
 * nodes' split[] hold child node indices; tip (8x8) nodes' split[] hold
 * edge-flag values directly (same convention as the Python tree). */
typedef struct {
    int32_t o, h[2], v[2], h4, v4;
    int32_t split[4];
} DtpuEdgeNode;

/* ---- frame context --------------------------------------------------------- */

typedef struct {
    /* geometry */
    int32_t bw, bh, w4, h4, sb128, sb_shift, sb_step, sbh;
    int32_t b4_stride, layout, ss_hor, ss_ver, bitdepth;
    int32_t frame_is_inter, frame_is_key_or_intra;

    /* frame-header scalars */
    int32_t seg_enabled, seg_update_map, seg_temporal, seg_preskip;
    int32_t seg_last_active;
    DtpuSegData seg_d[8];
    int32_t skip_mode_enabled, skip_mode_refs[2];
    int32_t delta_q_present, delta_q_res_log2;
    int32_t delta_lf_present, delta_lf_res_log2, delta_lf_multi;
    int32_t cdef_n_bits;
    int32_t allow_intrabc, allow_screen_content_tools;
    int32_t switchable_comp_refs, hp, force_integer_mv;
    int32_t switchable_motion_mode, warp_motion, reduced_txtp_set;
    int32_t txfm_mode; /* 0 only4x4 1 largest 2 switchable */
    int32_t subpel_filter_mode, dual_filter;
    int32_t seq_filter_intra, seq_inter_intra, seq_masked_compound;
    int32_t seq_jnt_comp, order_hint_n_bits, frame_offset;
    int32_t quant_yac, quant_ydc_d, quant_udc_d, quant_uac_d;
    int32_t quant_vdc_d, quant_vac_d;
    int32_t lf_level_y[2], lf_level_u, lf_level_v, lf_sharpness;
    int32_t lf_mode_ref_delta_enabled;
    int32_t lf_mode_deltas[2], lf_ref_deltas[8];
    int32_t loopfilter_any; /* level_y[0] || level_y[1] */
    int32_t have_prev_segmap;
    int32_t svc_scale[7], gmv_warp_allowed[7];
    int32_t jnt_offset[7][7]; /* 3 * (d0 == d1) per ref pair */
    int32_t refpoc_valid;     /* refs present (inter frame) */

    /* restoration */
    int32_t restore_planes, restoration_type[3];
    int32_t restoration_unit_size[2]; /* log2, [0] luma [1] chroma */
    int32_t frame_w0, frame_w1, frame_h, superres_denom, sr_sb128w;
    DtpuLrUnit *lr_units; /* (sb128h * sr_sb128w, 3, 4) dense */

    /* frame-level buffers */
    uint8_t *cur_segmap;        /* (bh, bw) or NULL */
    const uint8_t *prev_segmap; /* (bh, bw) or NULL */
    int32_t cur_segmap_stride, prev_segmap_stride;
    uint8_t *noskip;            /* (sb128h*16, sb128w*32) bool */
    int32_t noskip_stride;
    int32_t *cdef_idx;          /* (sb128h*2, sb128w*2) */
    int32_t cdef_idx_stride;
    uint8_t *lf_level;          /* (align32(bh), b4_stride, 4) */
    uint8_t *lf_mask_buf;       /* lf_wd_y base: (2, h4a, b4_stride) */
    int64_t lf_wd_y_plane;      /* h4a * b4_stride */
    uint8_t *lf_wd_uv;          /* (2, ch4a, cstride) */
    int64_t lf_wd_uv_plane;     /* ch4a * cstride */
    int32_t sb128w;
    uint16_t *dq_tbl;           /* (3, 256, 2) */
    int32_t dq_tbl_hbd;
    const uint8_t *qm_tbl[19][3]; /* per (rect tx, plane), or NULL */

    /* normative block-size masks (levels.py) */
    uint32_t cfl_allowed_mask, wedge_allowed_mask, interintra_allowed_mask;

    /* intra-edge tree (root at index 0) */
    const DtpuEdgeNode *edge_tree;
    int32_t root_bl; /* 0 = BL_128X128, 1 = BL_64X64 */

    /* static tables */
    const uint8_t *block_dim;        /* (22, 4) */
    const uint8_t *txfm_info;        /* (19, 8) */
    const uint8_t *al_part_ctx;      /* (2, 5, 10) */
    const uint8_t *block_sizes;      /* (5, 10, 2) */
    const uint8_t *partition_count;  /* (5,) */
    const uint8_t *ymode_size_ctx;   /* (22,) */
    const uint8_t *intra_mode_ctx;   /* (13,) */
    const uint8_t *max_tx_for_bs;    /* (22, 4) */
    const uint8_t *filter_2d_tbl;    /* (4, 4) */
    const uint8_t *comp_inter_modes; /* (8, 2) */
    const uint8_t *wedge_ctx_lut;    /* (22,) */
    const uint8_t *filter_mode_to_y; /* (5,) */
    const uint16_t *sgr_params;      /* (16, 2) */

    /* ref-MV state (NULL for intra frames without intrabc) */
    DtpuRefMvsFrame *rf;

    /* capture output (pass 1) */
    CapBlock *cap_blocks;
    int64_t cap_blocks_cap, n_blocks;
    int32_t *cap_coef_meta; /* (cap, CAP_COEF_WORDS) */
    int64_t cap_coef_cap, n_coef_meta;
    int32_t *cf_arena;
    int64_t cf_arena_cap, cf_used;
    CapObmc *cap_obmc;
    int64_t cap_obmc_cap, n_obmc;
    CapWarp *cap_warp;
    int64_t cap_warp_cap, n_warp;
    uint16_t *cap_pal;  /* (cap, 3, 8) */
    int64_t cap_pal_cap, n_pal;
    uint8_t *pal_arena; /* unpacked palette index maps */
    int64_t pal_arena_cap, pal_used;
    int32_t error; /* sticky: 1 capacity, 2 stream error */
} DtpuFrameCtx;

/* ---- tile context ----------------------------------------------------------- */

typedef struct {
    int16_t filter_v[3], filter_h[3], sgr_weights[2];
} DtpuLrRef;

typedef struct {
    DtpuMsac *msac;
    DtpuCoefCtx *coef;
    /* mode CDFs (pointers into the tile's numpy arrays) */
    uint16_t *partition;    /* (5, 4, 16) */
    uint16_t *seg_pred;     /* (3, 2) */
    uint16_t *seg_id;       /* (3, 8) */
    uint16_t *skip_mode;    /* (3, 2) */
    uint16_t *skip;         /* (3, 2) */
    uint16_t *delta_q;      /* (4,) */
    uint16_t *delta_lf;     /* (5, 4) */
    uint16_t *intra;        /* (4, 2) */
    uint16_t *intrabc;      /* (2,) */
    uint16_t *y_mode;       /* (4, 16) */
    uint16_t *kfym;         /* (5, 5, 16) */
    uint16_t *angle_delta;  /* (8, 8) */
    uint16_t *uv_mode;      /* (2, 13, 16) */
    uint16_t *cfl_sign;     /* (8,) */
    uint16_t *cfl_alpha;    /* (6, 16) */
    uint16_t *pal_y;        /* (7, 3, 2) */
    uint16_t *pal_uv;       /* (2, 2) */
    uint16_t *pal_sz;       /* (2, 7, 8) */
    uint16_t *color_map;    /* (2, 7, 5, 8) */
    uint16_t *use_filter_intra; /* (22, 2) */
    uint16_t *filter_intra; /* (8,) */
    uint16_t *txsz;         /* (4, 3, 4) */
    uint16_t *txpart;       /* (7, 3, 2) */
    uint16_t *comp;         /* (5, 2) */
    uint16_t *comp_dir;     /* (5, 2) */
    uint16_t *jnt_comp;     /* (6, 2) */
    uint16_t *mask_comp;    /* (6, 2) */
    uint16_t *wedge_comp;   /* (9, 2) */
    uint16_t *wedge_idx;    /* (9, 16) */
    uint16_t *interintra;   /* (7, 2) */
    uint16_t *interintra_mode;  /* (4, 4) */
    uint16_t *interintra_wedge; /* (7, 2) */
    uint16_t *ref;          /* (6, 3, 2) */
    uint16_t *comp_fwd_ref; /* (3, 3, 2) */
    uint16_t *comp_bwd_ref; /* (2, 3, 2) */
    uint16_t *comp_uni_ref; /* (3, 3, 2) */
    uint16_t *comp_inter_mode; /* (8, 8) */
    uint16_t *newmv_mode;   /* (6, 2) */
    uint16_t *globalmv_mode;/* (2, 2) */
    uint16_t *refmv_mode;   /* (6, 2) */
    uint16_t *drl_bit;      /* (3, 2) */
    uint16_t *motion_mode;  /* (22, 4) */
    uint16_t *obmc;         /* (22, 2) */
    uint16_t *filter;       /* (2, 8, 4) */
    uint16_t *restore_wiener;     /* (2,) */
    uint16_t *restore_sgrproj;    /* (2,) */
    uint16_t *restore_switchable; /* (4,) */
    uint16_t *mv_joint;     /* (4,) */
    /* per mv component [0]=y [1]=x */
    uint16_t *mv_classes[2];   /* (16,) */
    uint16_t *mv_sign[2];      /* (2,) */
    uint16_t *mv_class0[2];    /* (2,) */
    uint16_t *mv_class0_fp[2]; /* (2, 4) */
    uint16_t *mv_class0_hp[2]; /* (2,) */
    uint16_t *mv_classN[2];    /* (10, 2) */
    uint16_t *mv_classN_fp[2]; /* (4,) */
    uint16_t *mv_classN_hp[2]; /* (2,) */

    /* tile geometry */
    int32_t col_start, col_end, row_start, row_end;
    int32_t tiling_row, tiling_col;

    /* mutable per-tile state */
    int32_t last_qidx, last_delta_lf[4];
    uint16_t dq[8][3][2];          /* current dequant (delta-q aware) */
    uint8_t lflvl[8][4][8][2];     /* current deblock levels */
    DtpuLrRef lr_ref[3];
} DtpuTileCtx;

/* Per-superblock walk state (subset of TaskContext). */
typedef struct {
    DtpuFrameCtx *f;
    DtpuTileCtx *ts;
    int32_t bx, by;
    BlockCtx **a_list; /* f.a (all above ctxs, frame-wide) */
    int32_t a_base;    /* first f.a index of this tile row */
    BlockCtx *a;       /* current above ctx */
    BlockCtx *l;       /* left ctx */
    uint16_t *al_pal;  /* [2][32][3][8] */
    uint8_t *pal_sz_uv;/* [2][32] */
    int32_t tl_4x4_filter;
    uint8_t txtp_map[32][32];
    uint16_t scratch_pal[3][8];
    int32_t sb_cdef64_y, sb_cdef64_x; /* current superblock 64x64 origin */
    int32_t lf_idx;    /* current sb128 lf-mask index */
    int32_t cur_warp_valid;
    CapWarp cur_warp;
    int32_t pal_y_off, pal_uv_off; /* current block's palette idx maps */
} DtpuTaskCtx;

int dtpu_decode_tile_sbrow(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t);

/* ABI guard: fills sizes[0..5] = sizeof(CapBlock, CapObmc, CapWarp,
 * DtpuFrameCtx, DtpuTileCtx, DtpuTaskCtx) for the Python mirrors. */
void dtpu_abi_sizes(int64_t *sizes);

/* ---- pass-2 intra replay (replay.c) ---------------------------------------- */

/* cross-file kernels used by the replay drivers */
void dtpu_put_8tap(const int32_t *plane, int64_t stride, int vw, int vh,
                   int dy, int dx, int w, int h, const int64_t *fh,
                   const int64_t *fv, int ib, int maxp, int prep,
                   int prep_bias, int32_t *out);
void dtpu_put_8tap_into(const int32_t *plane, int64_t stride, int vw,
                        int vh, int dy, int dx, int w, int h,
                        const int64_t *fh, const int64_t *fv, int ib,
                        int maxp, int32_t *dst, int64_t dst_stride);
void dtpu_warp8x8(const int32_t *plane, int64_t stride, int vw, int vh,
                  int dy, int dx, const int32_t *abcd, int mx, int my,
                  int ib, int maxp, int prep, int prep_bias,
                  const int64_t *wf, int32_t *out);
void dtpu_ipred(int mode, const int32_t *edge, int ofs, int width,
                int height, int angle_in, int max_w, int max_h,
                int bitdepth, const uint8_t *sm_weights,
                const uint16_t *dr_deriv, const int8_t *filter_taps,
                int32_t *out, int64_t ostride);
void dtpu_add_residual(int32_t *plane, int64_t stride, int dy, int dx,
                       const int32_t *r, int h, int w, int maxp);
void dtpu_add_residual16(int32_t *plane, int64_t stride, int dy, int dx,
                         const int16_t *r, int h, int w, int maxp);

/* Replay context — mirrored by decode_glue.py CReplayCtx. */
typedef struct {
    int32_t *planes[3];
    int64_t stride[3];
    int32_t bw, bh; /* frame size in 4x4 blocks */
    int32_t ss_hor, ss_ver, layout, bitdepth;
    int32_t intra_edge_filter;
    int32_t resid_elsz; /* 2 (device int16) or 4 */
    const CapBlock *cap_blocks;
    const int32_t *coef_meta;      /* rows of CAP_COEF_WORDS */
    const uint64_t *resid_ptrs;    /* per meta row; 0 = none */
    const uint16_t *cap_pal;       /* (n, 3, 8) */
    const uint8_t *pal_arena;
    const int32_t *tile_of_block;  /* per capture block */
    const int32_t *tile_bounds;    /* (n_tiles, 4): col_s, col_e, row_s, row_e */
    const uint8_t *block_dim;      /* (22, 4) */
    const uint8_t *txfm_info;      /* (19, 8) */
    const uint8_t *sm_weights;
    const uint16_t *dr_deriv;
    const int8_t *filter_taps;
} DtpuReplayCtx;

int64_t dtpu_intra_replay(const DtpuReplayCtx *rc, int64_t start,
                          int64_t end);

/* ---- pass-2 inter replay (replay_inter.c) --------------------------------- */

/* Reference-frame + table context for the order-free phase-A inter
 * replay — mirrored by decode_glue.py CInterCtx. */
typedef struct {
    const int32_t *ref_planes[7][3];
    int64_t ref_stride[7][3];
    int32_t ref_w[7], ref_h[7]; /* ref frame_hdr.width[1], height */
    int32_t ref_ok[7];          /* slot present and unscaled */
    int32_t gmv_type[7];
    int32_t gmv_matrix[7][6];
    int32_t gmv_abcd[7][4];
    int32_t gmv_warp_allowed[7];
    int32_t jnt_weights[7][7];
    const uint8_t *rb;      /* refmvs r grid (RB_DT, 12 bytes/cell) */
    int64_t rb_stride;      /* cells per row */
    const CapObmc *cap_obmc;
    const CapWarp *cap_warp;
    const int8_t *subpel_filters; /* (6, 15, 8) */
    const uint8_t *obmc_masks;    /* (64,) */
    const uint8_t *masks_blob;
    const uint16_t *mask_offsets; /* (3, 11, 36) */
    const int64_t *warp_filter;   /* (193, 8) */
} DtpuInterCtx;

/* Replay every plain inter block (kind 1, no interintra) in
 * [start, end): prediction straight into the planes, plus (when
 * add_resid) the cached-residual adds.  Blocks needing the Python
 * fallback (scaled reference, missing residual) have their indices
 * appended to skipped[]; returns the skipped count. */
int64_t dtpu_inter_replay(const DtpuReplayCtx *rc, const DtpuInterCtx *ic,
                          int64_t start, int64_t end, int add_resid,
                          int64_t *skipped, const uint8_t *handled);

/* Deferred residual adds for plain inter blocks in [start, end) (device
 * tier: predictions ran while the residual batches were in flight).
 * skipped: sorted indices to leave to the Python fallback; handled:
 * optional per-block mask of blocks the device-MC stage owns. */
void dtpu_add_inter_residuals(const DtpuReplayCtx *rc, int64_t start,
                              int64_t end, const int64_t *skipped,
                              int64_t n_skipped, const uint8_t *handled);

void dtpu_add_block_residuals(const DtpuReplayCtx *rc, const int64_t *idxs,
                              int64_t n);

int64_t dtpu_mc_jobs(const DtpuReplayCtx *rc, const DtpuInterCtx *ic,
                     const int64_t *idxs, int64_t nb, const int32_t *ent,
                     const int64_t *base, const int64_t *stride,
                     int64_t n_out, int32_t *jobs, int32_t *tiles,
                     int64_t *n_pix);

/* ---- film grain (fg.c; headers.py FilmGrainData mirror) ----------------- */

typedef struct {
    int32_t seed, num_y_points, chroma_scaling_from_luma;
    int32_t num_uv_points[2];
    int32_t scaling_shift, ar_coeff_lag, ar_coeff_shift, grain_scale_shift;
    int32_t uv_mult[2], uv_luma_mult[2], uv_offset[2];
    int32_t overlap_flag, clip_to_restricted_range;
    uint8_t y_points[14][2];
    uint8_t uv_points[2][10][2];
    int32_t ar_coeffs_y[24];
    int32_t ar_coeffs_uv[2][28];
} DtpuFgData;

void dtpu_fg_gen_y(const DtpuFgData *d, const int16_t *gauss, int bitdepth,
                   int32_t *buf);
void dtpu_fg_gen_uv(const DtpuFgData *d, const int16_t *gauss,
                    const int32_t *buf_y, int uv, int subx, int suby,
                    int bitdepth, int32_t *buf);
void dtpu_fg_scaling(int bitdepth, const uint8_t *points, int num,
                     int32_t *out);
int dtpu_fg_apply_plane(int32_t *plane, int64_t stride,
                         const int32_t *lumap, int64_t lstride, int lw,
                         int pl, int w, int h, int subx, int suby,
                         const int32_t *lut, const int32_t *sc,
                         const DtpuFgData *d, int bitdepth, int is_id);

#endif /* DTPU_H */
