/* Fused dynamic-warp host precompute (single pass, C).
 *
 * Native form of lerf_torch/ops/resample.py::warp_serving_host_fused's
 * row-blocked numpy path: the rings (ops/resample.py::WarpRings: the
 * int32 corner, the float32 distances, the linear kernel's branch masks)
 * and the validity mask of one homography, every output in one pass per
 * pixel instead of numpy's ~25 elementwise passes over the frame.
 * lerf_torch/native/__init__.py builds it at first use.
 *
 * BIT-PARITY CONTRACT (tests/test_torch_warp_rings.py): every float64
 * expression mirrors ops/geometry.py term-for-term in IEEE double (same
 * order of operations, two separate divisions by den, ceil, min/max clips,
 * single final round-to-float32).  Compile WITHOUT -ffast-math and with
 * -ffp-contract=off: -O3 -march=native only changes scheduling and
 * vectorization, while a contracted multiply-add would move float64 bits
 * on a CPU that has FMA.
 *
 * Layout: the arithmetic runs over block-local contiguous arrays (BK
 * pixels) so gcc auto-vectorizes the fp-heavy stages (division, ceil,
 * min/max clips); only the final interleaved stores are scalar.
 *
 * Reference semantics mirrored (via the Python fused path):
 *   projection grid    resize_right2d_numpy.py:306-342 (rank-1 form)
 *   serving axis       ops/geometry.py::_serving_axis
 *   validity mask      ops/resample.py::_mask_from_grid (box*neigh==255
 *                      rewritten as pure arithmetic)
 */
#include <math.h>
#include <pthread.h>
#include <stdint.h>

#define BK 128
#define MAX_THREADS 64

static inline double clipd(double v, double lo, double hi) {
    /* numpy clip(a, lo, hi) == minimum(hi, maximum(lo, a)) for finite v */
    v = v > lo ? v : lo;
    return v < hi ? v : hi;
}

/* one axis: grid g[nb] -> left ring index, float32 distances, mask terms.
   Straight-line body (no branches, & instead of &&) so gcc vectorizes it;
   e0b/e1b keep the float64 distances for the optional linear-mask loop.  */
static void axis_block(
    int64_t nb, const double *restrict g, double p0, double pm,
    double top,                 /* in-1 clip bound                        */
    double white_lo, double white_hi, double eps,
    double *restrict lft, double *restrict e0b, double *restrict e1b,
    float *restrict d0, float *restrict d1, uint8_t *restrict ok,
    int linear, float *restrict mneg0, float *restrict mneg1,
    float *restrict mpos0, float *restrict mpos1)
{
    for (int64_t k = 0; k < nb; ++k) {
        const double l = ceil(g[k] - 1.0 - eps);
        const double sh = g[k] + p0;
        const double t0 = clipd(l + (0.0 + p0), 0.0, top);
        const double t1 = clipd(l + (1.0 + p0), 0.0, top);
        const double e0 = sh - t0, e1 = sh - t1;
        lft[k] = l;
        e0b[k] = e0;
        e1b[k] = e1;
        d0[k] = (float)e0;
        d1[k] = (float)e1;
        /* validity mask: support-1 box warp of the border-zeroed white
           image, as arithmetic (warp_serving_host_fused doc)             */
        const double lm = ceil(g[k] - 0.5 - eps);
        const double fm = clipd(lm + pm, 0.0, top);
        const double dm = (g[k] + pm) - fm;
        ok[k] = (uint8_t)((-1.0 <= dm) & (dm <= 1.0)
                          & (fm >= white_lo) & (fm <= white_hi));
    }
    if (linear) {   /* float64 branch masks (_branch_masks)               */
        for (int64_t k = 0; k < nb; ++k) {
            const double e0 = e0b[k], e1 = e1b[k];
            mneg0[k] = (float)((-1.0 <= e0) & (e0 < 0.0));
            mneg1[k] = (float)((-1.0 <= e1) & (e1 < 0.0));
            mpos0[k] = (float)((0.0 <= e0) & (e0 <= 1.0));
            mpos1[k] = (float)((0.0 <= e1) & (e1 <= 1.0));
        }
    }
}

/* everything a row range needs; shared read-only across worker threads  */
typedef struct {
    const double *inv;
    int64_t in_h, in_w, oh, ow;
    int64_t pad0x, pad0y, pad0mx, pad0my, border;
    int linear;
    int32_t *corner;
    float *dis_x, *dis_y;
    uint8_t *mask;
    float *mneg_x, *mpos_x, *mneg_y, *mpos_y;
    int64_t y_lo, y_hi;         /* this worker's row range [y_lo, y_hi)   */
} warp_args;

/* the per-pixel arithmetic for output rows [y_lo, y_hi) — byte-identical
   results for any row partition (rows are independent; every store below
   lands in this range's disjoint [y*ow ...] slots), so the threaded entry
   point is bit-equal to the single-thread one by construction            */
static void run_rows(const warp_args *restrict a)
{
    const double EPS = 1.1920928955078125e-07; /* float32 eps, exact      */
    const double *inv = a->inv;
    const double i00 = inv[0], i01 = inv[1], i02 = inv[2];
    const double i10 = inv[3], i11 = inv[4], i12 = inv[5];
    const double i20 = inv[6], i21 = inv[7], i22 = inv[8];
    const int64_t in_h = a->in_h, in_w = a->in_w, ow = a->ow;
    const int64_t pad0mx = a->pad0mx, pad0my = a->pad0my;
    const int64_t border = a->border;
    const int linear = a->linear;
    const double fh = (double)in_h, fw = (double)in_w;
    const double p0x = (double)a->pad0x, p0y = (double)a->pad0y;
    const double stride = (double)(in_w + 3);
    int32_t *restrict corner = a->corner;
    float *restrict dis_x = a->dis_x, *restrict dis_y = a->dis_y;
    uint8_t *restrict mask = a->mask;
    float *restrict mneg_x = a->mneg_x, *restrict mpos_x = a->mpos_x;
    float *restrict mneg_y = a->mneg_y, *restrict mpos_y = a->mpos_y;

    double gx[BK], gy[BK], lx[BK], ly[BK];
    double ex0[BK], ex1[BK], ey0[BK], ey1[BK];
    float dx0[BK], dx1[BK], dy0[BK], dy1[BK];
    float nx0[BK], nx1[BK], px0[BK], px1[BK];
    float ny0[BK], ny1[BK], py0[BK], py1[BK];
    uint8_t okx[BK], oky[BK];

    for (int64_t y = a->y_lo; y < a->y_hi; ++y) {
        const double yd = (double)y;
        const double ay = i01 * yd, by = i11 * yd, cy_ = i21 * yd;
        for (int64_t x0 = 0; x0 < ow; x0 += BK) {
            const int64_t nb = (ow - x0) < BK ? (ow - x0) : BK;
            const int64_t base = y * ow + x0;
            for (int64_t k = 0; k < nb; ++k) {       /* vectorizes: 2 div */
                const double xd = (double)(x0 + k);
                const double den = (i20 * xd + i22) + cy_;
                const double sx = ((i00 * xd + i02) + ay) / den;
                const double sy = ((i10 * xd + i12) + by) / den;
                gx[k] = clipd(sy, 0.0, fh);          /* row coordinate    */
                gy[k] = clipd(sx, 0.0, fw);          /* col coordinate    */
            }
            axis_block(nb, gx, p0x, (double)pad0mx, (double)(in_h - 1),
                       (double)(pad0mx + border),
                       (double)(pad0mx + in_h - 1 - border), EPS,
                       lx, ex0, ex1, dx0, dx1, okx, linear,
                       nx0, nx1, px0, px1);
            axis_block(nb, gy, p0y, (double)pad0my, (double)(in_w - 1),
                       (double)(pad0my + border),
                       (double)(pad0my + in_w - 1 - border), EPS,
                       ly, ey0, ey1, dy0, dy1, oky, linear,
                       ny0, ny1, py0, py1);
            for (int64_t k = 0; k < nb; ++k) {
                const int64_t i = base + k;
                dis_x[2 * i] = dx0[k];
                dis_x[2 * i + 1] = dx1[k];
                dis_y[2 * i] = dy0[k];
                dis_y[2 * i + 1] = dy1[k];
                /* packed-operand corner (WarpOperands.from_grid)         */
                corner[i] = (int32_t)((lx[k] + (p0x + 1.0)) * stride
                                      + (ly[k] + (p0y + 1.0)));
                mask[i] = (uint8_t)(okx[k] & oky[k]);
            }
            if (linear) {
                for (int64_t k = 0; k < nb; ++k) {
                    const int64_t i = base + k;
                    mneg_x[2 * i] = nx0[k];  mneg_x[2 * i + 1] = nx1[k];
                    mpos_x[2 * i] = px0[k];  mpos_x[2 * i + 1] = px1[k];
                    mneg_y[2 * i] = ny0[k];  mneg_y[2 * i + 1] = ny1[k];
                    mpos_y[2 * i] = py0[k];  mpos_y[2 * i + 1] = py1[k];
                }
            }
        }
    }
}

static void *worker(void *p)
{
    run_rows((const warp_args *)p);
    return 0;
}

int warp_operands_fused(
    const double *inv,          /* [9] row-major inverse homography       */
    int64_t in_h, int64_t in_w, /* input spatial size                     */
    int64_t oh, int64_t ow,     /* output spatial size                    */
    int64_t pad0x, int64_t pad0y,   /* support-2 pads (set by pixel 0,0)  */
    int64_t pad0mx, int64_t pad0my, /* support-1 (mask) pads              */
    int64_t border,             /* mask border shave (4)                  */
    int linear,                 /* also emit amplified-linear branch masks*/
    int threads,                /* worker count; <=1 runs inline          */
    int32_t *corner,            /* [oh*ow]                                */
    float *dis_x,               /* [oh*ow, 2]                             */
    float *dis_y,
    uint8_t *mask,              /* [oh*ow]                                */
    float *mneg_x,              /* [oh*ow, 2], linear only                */
    float *mpos_x,
    float *mneg_y, float *mpos_y)
{
    warp_args base = {inv, in_h, in_w, oh, ow, pad0x, pad0y, pad0mx,
                      pad0my, border, linear, corner, dis_x, dis_y, mask,
                      mneg_x, mpos_x, mneg_y, mpos_y, 0, oh};
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    if (threads > oh) threads = (int)oh;
    if (threads <= 1) {
        run_rows(&base);
        return 0;
    }
    warp_args args[MAX_THREADS];
    pthread_t tids[MAX_THREADS];
    int started = 0;
    for (int t = 0; t < threads; ++t) {
        args[t] = base;
        args[t].y_lo = oh * t / threads;       /* contiguous disjoint rows */
        args[t].y_hi = oh * (t + 1) / threads;
        if (t == threads - 1 ||
            pthread_create(&tids[t], 0, worker, &args[t]) != 0) {
            run_rows(&args[t]);                /* last chunk (or spawn
                                                  failure) runs inline     */
            if (t != threads - 1) {            /* spawn failed: finish the
                                                  tail serially, bit-equal */
                for (int u = t + 1; u < threads; ++u) {
                    args[u] = base;
                    args[u].y_lo = oh * u / threads;
                    args[u].y_hi = oh * (u + 1) / threads;
                    run_rows(&args[u]);
                }
                break;
            }
        } else {
            started = t + 1;
        }
    }
    for (int t = 0; t < started; ++t)
        pthread_join(tids[t], 0);
    return 0;
}
