// Semi-Lagrangian tap-sum, forward and backward: hand-written Hopper (sm_90a)
// kernels.
//
// The forward replaces the TPU kernel
// solver_in_the_loop_tpu/ops/pallas/advect_kernel.py `_fwd_kernel` (reached
// through `_tap_sum_fwd_impl`):
//
//   out[b,j,i] = sum_{sy,sx in [-m, m+1]} wy(sy) * wx(sx) * V[b, j+sy, i+sx]
//   wy(s) = max(0, 1 - |dy[b,j,i] - s|),   wx(s) = max(0, 1 - |dx[b,j,i] - s|)
//
// V[b, j+sy, i+sx] is read with its indices clamped to the edge for OPEN
// domains (the replicate shifts of ops/interp.py) and wrapped for PERIODIC
// ones. The caller clamps the offsets first (ops/interp.py), so for OPEN
// domains every tap with a non-zero weight reads inside the field.
//
// The window. wy(s) is non-zero only for s in {fy, fy+1}, fy = floor(dy):
// for s <= fy-1 the rounded |dy - s| is at least 1, for s >= fy+2 likewise
// (rounding is monotone and 1 is a float). Of the (2m+2)^2 taps, at most
// the 2x2 window {fy, fy+1} x {fx, fx+1}, clipped to [-m, m+1], carries a
// weight; the other taps add terms that are exactly +-0. The slopes wy'(s)
// of the backward are non-zero only for s in [fy-1, fy+2] (|dy - s| <= 1,
// where rounding can make a distance just above 1 read exactly 1).
//
// Forward design. One thread per output cell, blocks of 4 rows x 32 cells
// indexed by (column block, row block, batch), so a (3, 64, 32) field
// spreads over 48 blocks. Each thread computes fy and fx and sums only the
// 2x2 window, two hat weights per axis; neighbouring threads read
// neighbouring cells of each tap row, served by L1. Beside that, the block
// reads the whole window of V its cells' taps reach, for the check of
// Numerics, and decides after the sum.
//
// Backward. Replaces `_bwd_kernel` of the same Pallas file (reached through
// `_tap_sum_bwd`): for the output cotangent g,
//
//   ddy[b,j,i] = sum_taps g * V[b, j+sy, i+sx] * wy'(sy) * wx(sx)   (ddx alike)
//   dV[b,j,i]  = sum over the destinations (j', i') whose tap (sy, sx) reads
//                (j, i) of g[b,j',i'] * wy * wx, weights at (j', i')
//
// with w'(t) = -s * (|t| < 1 ? 1 : |t| == 1 ? 0.5 : 0), s = (t >= 0 ? 1 : -1):
// JAX's derivative of max(0, 1 - |t|), abs'(0) = +1 and half of each branch
// at the max's tie. Reading V with the forward's clamped (OPEN) or wrapped
// (PERIODIC) indices gives the edge value at OPEN tie taps, which the TPU
// kernel restores by re-rolling.
//
// Backward design. A block owns a tile of TILE_H x TILE_W = 4 x 32 output
// cells, one thread each (48 blocks at (3, 64, 32)); ragged tiles are
// masked. It stages V, g and, per cell, fy, fx and the two non-zero hat
// weights per axis of the tile and a halo of m+1 cells on each side in
// shared memory, each halo index clamped (OPEN) or wrapped (PERIODIC) as the
// forward reads it, so every weight is computed once per block and not once
// per tap. ddy and ddx loop over the 4x4 slope window of the thread's own
// cell. dV is a gather, no atomics: for each tap (sy, sx) in the twin's
// order the thread looks up the one destination (j - sy, i - sx) that reads
// its cell through that tap, and adds g * (wy * wx) where the tap lies in
// that destination's window, an integer compare against shared memory; the
// taps unroll (max_shift 1, 2 and 3 are compiled as constants) and every
// lookup is a load with no branch before it, so the loads overlap.
// An OPEN edge cell is also read through clamped indices, by destinations
// whose tap leaves the field. Those terms have weight 0 on the offsets the
// solver passes (clamped into the field, ops/interp.py), so each block
// checks while it stages whether any staged destination has a window tap of
// non-zero weight outside the field; only then do its edge cells walk every
// reader of each tap in the twin's order (columns, then rows, ascending),
// a slower loop that the solver's path never takes.
//
// What bounds it on the H100. The forward moves 16 bytes per cell, the
// backward 28; at (3, 64, 32) that is 98 KB and 172 KB, 29 ns and 51 ns at
// the H100's 3.35 TB/s, and the windows' arithmetic is less. Both are bound
// by latency: the launch, the dependent global loads (offsets, then values;
// the backward's staging), the block barrier of the non-finite check, and
// the backward's chain of (2m+2)^2 shared-memory lookups and adds per cell.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, back to back at (3, 64, 32) on the solver's clamped offsets:
// forward 0.0030 ms (F.grid_sample 0.0029), backward 0.0039 ms
// (grid_sampler_2d_backward 0.0056).
//
// Numerics. Every multiply and add is rounded on its own (__fmul_rn /
// __fadd_rn, and the file is built with --fmad=false), and each sum adds the
// same non-zero terms as the plain PyTorch twin (kernels/advect.py) in the
// same order: taps sy outer, sx inner; acc += v * (wy * wx) forward;
// gv = g * v, then gv * (wy' * wx) and gv * (wy * wx') backward; for dV per
// tap the rows of each column, then the columns, in index order. The terms
// that the window skips are exactly +-0 for finite inputs, and adding +-0 to
// a float sum that starts at +0 changes nothing (+0 + -0 = +0), so the
// kernels equal the twin bit for bit (tests/test_torch_advect_window.py
// emulates these loops on the CPU). That argument needs finite inputs: the
// twin's zero-weight terms are NaN where V or g is infinite or NaN (0 * inf),
// and its hat weights NaN where an offset is NaN. So a block that finds a
// non-finite value among the inputs its cells read sums every
// tap as the twin does, zero weights included, and its NaN and inf land
// where the twin's do, which is what the trainer's non-finite guard
// (GuardedAdam) reads. Both kernels check what they stage, and their
// staging barrier carries the answer.

#include <cuda_runtime.h>

namespace {

// The forward's block: FWD_ROWS rows of TILE_W cells; the backward's tile:
// TILE_H rows of TILE_W cells. One thread per output cell.
constexpr int TILE_W = 32;
constexpr int FWD_ROWS = 4;
constexpr int TILE_H = 4;
// The backward's shared-memory tile holds a halo of m+1 cells; at m = 32 it
// takes 192 KB of the 227 KB a block may have (kernels/advect.py MAX_SHIFT).
constexpr int MAX_SHIFT = 32;
// shared bytes per staged cell: four hat weights, g with the two floors, V
constexpr int STAGED_CELL_BYTES = 16 + 8 + 4;

// max(0, 1 - |d - s|) as the twin's clamp_min computes it: NaN stays NaN
__device__ __forceinline__ float hat(float d, int s) {
    const float t = __fsub_rn(1.0f, fabsf(__fsub_rn(d, static_cast<float>(s))));
    return isnan(t) ? t : fmaxf(0.0f, t);
}

__device__ __forceinline__ float hat_slope(float d, int s) {
    const float t = __fsub_rn(d, static_cast<float>(s));
    const float a = fabsf(t);
    const float neg_sign = t >= 0.0f ? -1.0f : 1.0f;
    return __fmul_rn(neg_sign, a < 1.0f ? 1.0f : (a == 1.0f ? 0.5f : 0.0f));
}

// floor(d) held within [-m-2, m+2]: a window that starts outside that range
// misses the taps [-m, m+1] either way, and the conversion to int stays
// defined (NaN gives -m-2; a block with a NaN offset takes the full loops).
__device__ __forceinline__ int window_floor(float d, int m) {
    return static_cast<int>(fminf(fmaxf(floorf(d), -m - 2.0f), m + 2.0f));
}

__device__ __forceinline__ int edge_index(int k, int n, bool periodic) {
    if (k >= 0 && k < n) return k;
    if (periodic) {
        if (k >= -n && k < 2 * n) return k < 0 ? k + n : k - n;  // no division
        k %= n;
        return k < 0 ? k + n : k;
    }
    return k < 0 ? 0 : n - 1;
}

// Whether any V in the block's window is not finite: the tile's FWD_ROWS x
// TILE_W cells and m before, m + 1 after, on both axes, at the clamped (OPEN)
// or wrapped (PERIODIC) indices. Warp y reads rows y, y + FWD_ROWS, ... two
// columns per lane (the second only on the lanes the window's 2m+1 extra
// columns need; WIDE, for m > 15, reads the rest), ORed without a branch so
// that the loads go out together, before and beside the offsets' and the
// window's.
template <bool PERIODIC, bool WIDE>
__device__ __forceinline__ bool fwd_window_odd(const float* vb, int i0, int j0, int h, int w,
                                               int m) {
    const int lane = static_cast<int>(threadIdx.x);
    const int rows = FWD_ROWS + 2 * m + 1;
    const int cols = TILE_W + 2 * m + 1;
    const int ca = edge_index(i0 - m + lane, w, PERIODIC);
    const int cb = edge_index(i0 - m + lane + (lane + TILE_W < cols ? TILE_W : 0), w, PERIODIC);
    bool odd = false;
#pragma unroll 4
    for (int t = static_cast<int>(threadIdx.y); t < rows; t += FWD_ROWS) {
        const float* row = vb + static_cast<long long>(edge_index(j0 - m + t, h, PERIODIC)) * w;
        odd |= !isfinite(row[ca]) | !isfinite(row[cb]);
    }
    if (WIDE) {
        for (int t = static_cast<int>(threadIdx.y); t < rows; t += FWD_ROWS) {
            const float* row = vb + static_cast<long long>(edge_index(j0 - m + t, h, PERIODIC)) * w;
            for (int u = lane + 2 * TILE_W; u < cols; u += TILE_W)
                odd |= !isfinite(row[edge_index(i0 - m + u, w, PERIODIC)]);
        }
    }
    return odd;
}

template <bool PERIODIC, bool WIDE>
__global__ void __launch_bounds__(TILE_W * FWD_ROWS)
tap_sum_fwd_kernel(const float* __restrict__ v, const float* __restrict__ dy,
                   const float* __restrict__ dx, float* __restrict__ out, int h, int w, int m) {
    const int i0 = blockIdx.x * TILE_W;
    const int j0 = blockIdx.y * FWD_ROWS;
    const int i = i0 + static_cast<int>(threadIdx.x);
    const int j = j0 + static_cast<int>(threadIdx.y);
    const bool inside = i < w && j < h;
    const long long base = static_cast<long long>(blockIdx.z) * h * w;
    const long long idx = base + static_cast<long long>(j) * w + i;
    const float* vb = v + base;
    bool odd = fwd_window_odd<PERIODIC, WIDE>(vb, i0, j0, h, w, m);
    const float ddy = inside ? dy[idx] : 0.0f;
    const float ddx = inside ? dx[idx] : 0.0f;
    odd |= !isfinite(ddy) | !isfinite(ddx);

    // the 2x2 window, while the block's check is in flight
    float acc = 0.0f;
    if (inside) {
        const int fy = window_floor(ddy, m);
        const int fx = window_floor(ddx, m);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            const int sy = fy + a;
            if (sy < -m || sy > m + 1) continue;
            const float wy = hat(ddy, sy);
            const float* row = vb + static_cast<long long>(edge_index(j + sy, h, PERIODIC)) * w;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int sx = fx + c;
                if (sx < -m || sx > m + 1) continue;
                const float val = row[edge_index(i + sx, w, PERIODIC)];
                acc = __fadd_rn(acc, __fmul_rn(val, __fmul_rn(wy, hat(ddx, sx))));
            }
        }
    }
    odd = __syncthreads_or(odd);
    if (!inside) return;
    if (odd) {  // every tap, as the twin: its zero weights carry NaN from V
        acc = 0.0f;
        for (int sy = -m; sy <= m + 1; ++sy) {
            const float wy = hat(ddy, sy);
            const float* row = vb + static_cast<long long>(edge_index(j + sy, h, PERIODIC)) * w;
            for (int sx = -m; sx <= m + 1; ++sx) {
                const float val = row[edge_index(i + sx, w, PERIODIC)];
                acc = __fadd_rn(acc, __fmul_rn(val, __fmul_rn(wy, hat(ddx, sx))));
            }
        }
    }
    out[idx] = acc;
}

// What the backward stages per cell of its tile and halo: the four hat
// weights hat(dy, fy), hat(dy, fy + 1), hat(dx, fx), hat(dx, fx + 1) in one
// float4, and g with the two floors in one 8-byte word.
struct __align__(8) Dest {
    float g;
    short fx;
    short fy;
};

// g * (wy * wx) of the destination staged at k for its tap (sy, sx), and
// whether the tap lies in its window (else the term is +-0).
__device__ __forceinline__ bool window_term(const float4* s_w, const Dest* s_d, int k, int sy,
                                            int sx, float* term) {
    const Dest d = s_d[k];
    const float4 wt = s_w[k];
    const unsigned ky = static_cast<unsigned>(sy - d.fy);
    const unsigned kx = static_cast<unsigned>(sx - d.fx);
    *term = __fmul_rn(d.g, __fmul_rn(ky ? wt.y : wt.x, kx ? wt.w : wt.z));
    return ky <= 1u && kx <= 1u;
}

// Whether a window tap f or f + 1 of non-zero weight (w0, w1), within the
// taps [-m, m+1], moves the index k of a destination outside [0, n).
__device__ __forceinline__ bool window_leaves(int f, float w0, float w1, int k, int n, int m) {
    const bool lo = f >= -m && f <= m + 1 && w0 > 0.0f && (k + f < 0 || k + f > n - 1);
    const bool hi = f + 1 >= -m && f + 1 <= m + 1 && w1 > 0.0f
                    && (k + f + 1 < 0 || k + f + 1 > n - 1);
    return lo || hi;
}

// g * (wy * wx) of the destination staged at k for its tap (sy, sx), with
// the weights the twin computes at every tap: the staged one inside the
// window, else +0, or NaN where the destination's offset is NaN (its staged
// weights are then NaN).
__device__ __forceinline__ float full_term(const float4* s_w, const Dest* s_d, int k, int sy,
                                           int sx) {
    const Dest d = s_d[k];
    const float4 wt = s_w[k];
    const int ky = sy - d.fy;
    const int kx = sx - d.fx;
    const float wy = ky == 0 ? wt.x : (ky == 1 ? wt.y : (isnan(wt.x) ? wt.x : 0.0f));
    const float wx = kx == 0 ? wt.z : (kx == 1 ? wt.w : (isnan(wt.z) ? wt.z : 0.0f));
    return __fmul_rn(d.g, __fmul_rn(wy, wx));
}

// dV of the cell (j, i) from every destination that reads it through a tap:
// for each tap the rows r and columns c whose clamped (OPEN) or wrapped
// (PERIODIC; one each, kept unwrapped since the staged halo is wrapped)
// r + sy and c + sx land on (j, i), columns outer, in index order. FULL adds
// every term, of zero weight too, as the twin does: for a block with a
// non-finite input, where those terms may be NaN. Else it adds the terms of
// the destinations' windows: for the OPEN edge cells of a block where some
// window leaves the field (never on the offsets the solver clamps).
template <bool FULL, bool PERIODIC>
__device__ __forceinline__ float dv_gather(const float4* s_w, const Dest* s_d, int j, int i,
                                           int h, int w, int m, int t0, int u0, int sw) {
    float acc_v = 0.0f;
#pragma unroll 1
    for (int sy = -m; sy <= m + 1; ++sy) {
        const int r0 = PERIODIC ? j - sy : max(j == 0 ? 0 : j - sy, 0);
        const int r1 = PERIODIC ? j - sy : min(j == h - 1 ? h - 1 : j - sy, h - 1);
#pragma unroll 1
        for (int sx = -m; sx <= m + 1; ++sx) {
            const int c0 = PERIODIC ? i - sx : max(i == 0 ? 0 : i - sx, 0);
            const int c1 = PERIODIC ? i - sx : min(i == w - 1 ? w - 1 : i - sx, w - 1);
            float tap = 0.0f;
            for (int c = c0; c <= c1; ++c) {
                float col = 0.0f;
                for (int r = r0; r <= r1; ++r) {
                    const int k = (r - t0) * sw + (c - u0);
                    float term;
                    if (FULL) {
                        col = __fadd_rn(col, full_term(s_w, s_d, k, sy, sx));
                    } else if (window_term(s_w, s_d, k, sy, sx, &term)) {
                        col = __fadd_rn(col, term);
                    }
                }
                tap = __fadd_rn(tap, col);
            }
            acc_v = __fadd_rn(acc_v, tap);
        }
    }
    return acc_v;
}

// M >= 0 fixes max_shift at compile time (the dV taps unroll); M = -1 reads
// it from m_arg.
template <int M, bool PERIODIC>
__global__ void __launch_bounds__(TILE_W * TILE_H)
tap_sum_bwd_kernel(const float* __restrict__ v, const float* __restrict__ dy,
                   const float* __restrict__ dx, const float* __restrict__ g,
                   float* __restrict__ dv, float* __restrict__ ddy, float* __restrict__ ddx,
                   int h, int w, int m_arg) {
    const int m = M >= 0 ? M : m_arg;
    const int halo = m + 1;
    const int sw = TILE_W + 2 * halo;
    const int cells = sw * (TILE_H + 2 * halo);
    extern __shared__ float4 smem[];
    float4* s_w = smem;
    Dest* s_d = reinterpret_cast<Dest*>(s_w + cells);
    float* s_v = reinterpret_cast<float*>(s_d + cells);

    const int i0 = blockIdx.x * TILE_W;
    const int j0 = blockIdx.y * TILE_H;
    const int t0 = j0 - halo;  // field row and column of staged index 0
    const int u0 = i0 - halo;
    const long long base = static_cast<long long>(blockIdx.z) * h * w;
    const int i = i0 + static_cast<int>(threadIdx.x) % TILE_W;
    const int j = j0 + static_cast<int>(threadIdx.x) / TILE_W;
    const bool inside = i < w && j < h;
    const long long idx = base + static_cast<long long>(j) * w + i;
    float dyc = 0.0f, dxc = 0.0f;
    if (inside) {
        dyc = dy[idx];
        dxc = dx[idx];
    }
    // leaves: a staged destination has a window tap of non-zero weight whose
    // index leaves the field (OPEN), so an edge cell gets that term through
    // a clamped index, besides its own reader's
    bool leaves = false;
    // odd: a staged input is not finite, so a term the windows skip may be
    // NaN in the twin (0 * inf); the block then takes the twin's full loops
    bool odd = false;
#pragma unroll 4
    for (int k = threadIdx.x; k < cells; k += TILE_W * TILE_H) {
        const int t = k / sw;
        const int r = edge_index(t0 + t, h, PERIODIC);
        const int c = edge_index(u0 + k - t * sw, w, PERIODIC);
        const long long gk = base + static_cast<long long>(r) * w + c;
        const float ey = dy[gk];
        const float ex = dx[gk];
        const int fy = window_floor(ey, m);
        const int fx = window_floor(ex, m);
        const float4 wt = make_float4(hat(ey, fy), hat(ey, fy + 1), hat(ex, fx), hat(ex, fx + 1));
        const float vv = v[gk];
        const float gv = g[gk];
        s_v[k] = vv;
        s_d[k] = Dest{gv, static_cast<short>(fx), static_cast<short>(fy)};
        s_w[k] = wt;
        odd |= !isfinite(vv) | !isfinite(gv) | !isfinite(ey) | !isfinite(ex);
        if (!PERIODIC) {
            leaves |= window_leaves(fy, wt.x, wt.y, r, h, m)
                      | window_leaves(fx, wt.z, wt.w, c, w, m);
        }
    }
    const bool fold = __syncthreads_or(leaves);
    odd = __syncthreads_or(odd);
    if (!inside) return;

    // the staged index of the own cell; (j + dj, i + di) is at own + dj * sw + di
    const int own = (j - t0) * sw + (i - u0);
    if (odd) {  // every tap, as the twin
        const float gc = s_d[own].g;
        float acc_y = 0.0f;
        float acc_x = 0.0f;
#pragma unroll 1
        for (int sy = -m; sy <= m + 1; ++sy) {
            const float wy = hat(dyc, sy);
            const float dwy = hat_slope(dyc, sy);
            const float* row = s_v + own + sy * sw;
#pragma unroll 1
            for (int sx = -m; sx <= m + 1; ++sx) {
                const float gv = __fmul_rn(gc, row[sx]);
                acc_y = __fadd_rn(acc_y, __fmul_rn(gv, __fmul_rn(dwy, hat(dxc, sx))));
                acc_x = __fadd_rn(acc_x, __fmul_rn(gv, __fmul_rn(wy, hat_slope(dxc, sx))));
            }
        }
        ddy[idx] = acc_y;
        ddx[idx] = acc_x;
        dv[idx] = dv_gather<true, PERIODIC>(s_w, s_d, j, i, h, w, m, t0, u0, sw);
        return;
    }

    // ddy, ddx: the 4x4 slope window of the own cell
    const float gc = s_d[own].g;
    const int fy = window_floor(dyc, m);
    const int fx = window_floor(dxc, m);
    float wxs[4], dwxs[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        wxs[c] = hat(dxc, fx - 1 + c);
        dwxs[c] = hat_slope(dxc, fx - 1 + c);
    }
    float acc_y = 0.0f;
    float acc_x = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int sy = fy - 1 + a;
        if (sy < -m || sy > m + 1) continue;
        const float wy = hat(dyc, sy);
        const float dwy = hat_slope(dyc, sy);
        const float* row = s_v + own + sy * sw;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int sx = fx - 1 + c;
            if (sx < -m || sx > m + 1) continue;
            const float gv = __fmul_rn(gc, row[sx]);
            acc_y = __fadd_rn(acc_y, __fmul_rn(gv, __fmul_rn(dwy, wxs[c])));
            acc_x = __fadd_rn(acc_x, __fmul_rn(gv, __fmul_rn(wy, dwxs[c])));
        }
    }
    ddy[idx] = acc_y;
    ddx[idx] = acc_x;

    // dV. Where no destination's window leaves the field, the one reader of
    // (j, i) through tap (sy, sx) is (j - sy, i - sx) (wrapped if PERIODIC;
    // none if it lies outside an OPEN field): a single term per tap, added
    // where the tap lies in that reader's window.
    if (!PERIODIC && fold && (j == 0 || j == h - 1 || i == 0 || i == w - 1)) {
        dv[idx] = dv_gather<false, false>(s_w, s_d, j, i, h, w, m, t0, u0, sw);
        return;
    }
    float acc_v = 0.0f;
#pragma unroll
    for (int sy = -m; sy <= m + 1; ++sy) {
#pragma unroll
        for (int sx = -m; sx <= m + 1; ++sx) {
            float term;
            bool hit = window_term(s_w, s_d, own - sy * sw - sx, sy, sx, &term);
            if (!PERIODIC) {
                hit = hit && static_cast<unsigned>(j - sy) < static_cast<unsigned>(h)
                      && static_cast<unsigned>(i - sx) < static_cast<unsigned>(w);
            }
            acc_v = hit ? __fadd_rn(acc_v, term) : acc_v;
        }
    }
    dv[idx] = acc_v;
}

using BwdKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                           float*, float*, int, int, int);

// The backward with max_shift fixed at compile time for 1, 2 and 3 (2 is
// the solvers' default --max-shift), else the one that reads it at run time.
template <bool PERIODIC>
BwdKernel bwd_kernel(int m) {
    switch (m) {
        case 1: return tap_sum_bwd_kernel<1, PERIODIC>;
        case 2: return tap_sum_bwd_kernel<2, PERIODIC>;
        case 3: return tap_sum_bwd_kernel<3, PERIODIC>;
        default: return tap_sum_bwd_kernel<-1, PERIODIC>;
    }
}

// grid, block and dynamic shared bytes of a launch
struct Config {
    dim3 grid;
    dim3 block;
    int smem;
};

Config fwd_config(int batch, int h, int w) {
    return {dim3((w + TILE_W - 1) / TILE_W, (h + FWD_ROWS - 1) / FWD_ROWS, batch),
            dim3(TILE_W, FWD_ROWS), 0};
}


Config bwd_config(int batch, int h, int w, int m) {
    const int halo = m + 1;
    return {dim3((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, batch),
            dim3(TILE_W * TILE_H),
            STAGED_CELL_BYTES * (TILE_W + 2 * halo) * (TILE_H + 2 * halo)};
}

}  // namespace

// values, dy, dx, out: contiguous float32 (batch, h, w) on the device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int silt_tap_sum_fwd(const float* values, const float* dy, const float* dx,
                                float* out, int batch, int h, int w, int max_shift,
                                int periodic, void* stream) {
    if (static_cast<long long>(batch) * h * w == 0) return 0;
    const Config cfg = fwd_config(batch, h, w);
    // a window wider than two warps' columns (max_shift > 15) is read by a
    // kernel of its own, so that the usual one carries no loop for it
    const bool wide = TILE_W + 2 * max_shift + 1 > 2 * TILE_W;
    const auto kernel = periodic ? (wide ? tap_sum_fwd_kernel<true, true>
                                         : tap_sum_fwd_kernel<true, false>)
                                 : (wide ? tap_sum_fwd_kernel<false, true>
                                         : tap_sum_fwd_kernel<false, false>);
    kernel<<<cfg.grid, cfg.block, 0, static_cast<cudaStream_t>(stream)>>>(
        values, dy, dx, out, h, w, max_shift);
    return static_cast<int>(cudaGetLastError());
}

// values, dy, dx, g (inputs) and dv, ddy, ddx (outputs): contiguous float32
// (batch, h, w) on the device; max_shift at most MAX_SHIFT. Returns the
// cudaError_t of the launch.
extern "C" int silt_tap_sum_bwd(const float* values, const float* dy, const float* dx,
                                const float* g, float* dv, float* ddy, float* ddx,
                                int batch, int h, int w, int max_shift, int periodic,
                                void* stream) {
    if (static_cast<long long>(batch) * h * w == 0) return 0;
    if (max_shift < 0 || max_shift > MAX_SHIFT) return static_cast<int>(cudaErrorInvalidValue);
    const Config cfg = bwd_config(batch, h, w, max_shift);
    const BwdKernel kernel = periodic ? bwd_kernel<true>(max_shift) : bwd_kernel<false>(max_shift);
    if (cfg.smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<cfg.grid, cfg.block, cfg.smem, static_cast<cudaStream_t>(stream)>>>(
        values, dy, dx, g, dv, ddy, ddx, h, w, max_shift);
    return static_cast<int>(cudaGetLastError());
}

// The launch configuration of silt_tap_sum_fwd (backward = 0) or
// silt_tap_sum_bwd (backward = 1) for a (batch, h, w) field: config[0..4] =
// grid x, y, z, threads per block, dynamic shared bytes.
extern "C" int silt_tap_sum_config(int backward, int batch, int h, int w, int max_shift,
                                   int* config) {
    const Config cfg = backward ? bwd_config(batch, h, w, max_shift) : fwd_config(batch, h, w);
    config[0] = static_cast<int>(cfg.grid.x);
    config[1] = static_cast<int>(cfg.grid.y);
    config[2] = static_cast<int>(cfg.grid.z);
    config[3] = static_cast<int>(cfg.block.x * cfg.block.y);
    config[4] = cfg.smem;
    return 0;
}
