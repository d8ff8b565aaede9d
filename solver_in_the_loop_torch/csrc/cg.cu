// Fused conjugate gradient without a preconditioner: hand-written Hopper
// (sm_90a) kernel.
//
// Replaces the TPU kernels solver_in_the_loop_tpu/ops/pallas/cg_kernel.py
// `_cg_kernel` (per-element grid, batch 1) and `_cg_kernel_folded` (whole
// batch in one instance), which the JAX package runs when the FD
// preconditioner is off. It solves, per batch element, A x = b with the
// operator of csrc/pcg.cu,
//
//   A(p) = fluid * -(me*E + mw*W + mn*N + ms*S - diag*p) + (1 - fluid) * p,
//
// E/W/N/S the neighbours with Dirichlet-0 ghosts outside the domain, me/mw/
// mn/ms the face masks face_u[j,i+1], face_u[j,i], face_v[j+1,i], face_v[j,i]
// and diag = me + mw + mn + ms (cg_kernel.py:296-300). The loop follows
// cg_kernel.py:86-108 and :249-273: warm start r0 = b - A x0, the p.Ap == 0
// guard on alpha and the r.r == 0 guard on beta, and the stopping rule
// r.r <= tol^2 max(b.b, 1e-30) with the threshold from b.
//
// Batch semantics. As in the folded TPU kernel and the port's PCG kernel, the
// whole batch stops together: one thread block per batch element, a batch of
// at most 8 one thread-block cluster, a larger one a cooperative grid of at
// most one block per SM (`batch_busy` in csrc/cg_common.cuh, which this
// kernel shares with csrc/pcg.cu, with the block reductions and the
// operator). At batch 1 this is the per-element `_cg_kernel`.
//
// Design. Without a preconditioner an iteration is one stencil, two dot
// products and three vector updates, about 26 operations per cell: at 64x32
// an element is 2,048 cells, 53 kFLOP per iteration, so neither HBM bytes nor
// FP32 peak bound it. What bounds it is the chain of each iteration times its
// ~110 cold iterations (about 4x the PCG's): three barriers (the block
// reduction of p.Ap, that of r.r, and the cluster or grid barrier of the stop
// test, which also publishes the new p), the shuffle trees of the two
// reductions, and each thread's stencil. So each thread owns a few cells (k =
// tid + threads * c) and keeps their x, r, p and A p in registers; only p,
// which the stencil reads across threads, lives in shared memory, in a halo
// of zeros so that the ghosts need no test. The block is fitted to the field:
// up to 2,048 cells (the karman 64x32) 256 threads, which also keep each
// cell's operator coefficients in registers, read once; up to 8,192 cells
// 1,024 threads, which read them from global memory (L1) each iteration, as
// 64 registers a thread do not hold them (CG_MAX_CELLS in kernels/cg.py).
// A larger field runs csrc/cg_cluster.cu, one element over a cluster of
// blocks (kernels/cg.py `cg_solve`). The two reductions alternate two
// scratch buffers, so no barrier only guards their reuse. On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py `kernels` and `--cg-split`, PERF.md) an
// iteration at (3,64,32) takes 1.4 us, the two reductions about 0.4 of it;
// as a cooperative grid (batch 9) 2.1 us.

#include <cuda_runtime.h>

#include "cg_common.cuh"

namespace {

using silt::Cell;

constexpr int kThreadCells = 8;  // per thread, at most: up to 1,024 * kThreadCells cells
constexpr int kSmallCells = 2048;  // fields up to this many cells take 256 threads

template <int kThreads, bool kRegCells, int kCells>
__global__ void __launch_bounds__(kThreads, 1) cg_kernel(const float* __restrict__ b_all,
                                                        const float* __restrict__ x0_all,
                                                        const float* __restrict__ fluid,
                                                        const float* __restrict__ face_u,
                                                        const float* __restrict__ face_v,
                                                        float* __restrict__ x_all,
                                                        int* __restrict__ iters,
                                                        int* __restrict__ flags, int batch,
                                                        int h, int w,
                                                        float tol2, int max_iter) {
    // p in its halo; its size is cg_smem_bytes in kernels/cg.py
    extern __shared__ float ps[];
    __shared__ float red_a[32];
    __shared__ float red_b[2 * 32];
    __shared__ int busy[2];  // the cluster's double-buffered "not converged" flag

    const int tid = threadIdx.x;
    const int n = h * w;
    const int stride = w + 1;
    const long long off = static_cast<long long>(blockIdx.x) * n;

    silt::stage_halo(ps, x0_all + off, h, w, stride);
    // each cell's index in the halo; a cell beyond the field (k >= n) takes
    // a word of the ring, row 0's column -1, whose neighbours are the ring
    // and cell (0, 0): with zero coefficients (kRegCells) its A p, and so its
    // r, p and x, stay 0, and the loops need no test
    int hk[kCells];
    float x[kCells], r[kCells], p[kCells], ap[kCells];
    Cell cell[kRegCells ? kCells : 1];
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
        const int k = tid + c * kThreads;
        const int j = k < n ? k / w : 0;
        hk[c] = k < n ? silt::halo_index(j, k - j * w, stride) : stride;
        if (kRegCells)
            cell[c] = k < n ? silt::load_cell(fluid, face_u, face_v, j, k - j * w, w)
                            : Cell{0, 0, 0, 0, 0, 0};
    }
    auto live = [&](int c) { return kRegCells || tid + c * kThreads < n; };
    // (A v) on cell c: v there from a register, its neighbours from the halo;
    // without kRegCells the coefficients from global memory (hk = k + j + w + 2)
    auto apply_a = [&](int c, float v) {
        const int k = tid + c * kThreads, h_k = hk[c];
        const int j = h_k - k - w - 2;
        const Cell cl = kRegCells ? cell[kRegCells ? c : 0]
                                  : silt::load_cell(fluid, face_u, face_v, j, k - j * w, w);
        return silt::apply_cell(cl, v, ps[h_k + 1], ps[h_k - 1], ps[h_k + stride], ps[h_k - stride]);
    };
    auto store_p = [&]() {
#pragma unroll
        for (int c = 0; c < kCells; ++c)
            if (live(c)) ps[hk[c]] = p[c];
    };
    __syncthreads();

    // r0 = b - A x0; the threshold from ||b||^2
    float sums[2] = {0.0f, 0.0f};  // b.b, r.r
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
        const int k = tid + c * kThreads;
        const float bk = k < n ? b_all[off + k] : 0.0f;
        x[c] = k < n ? x0_all[off + k] : 0.0f;
        r[c] = p[c] = ap[c] = 0.0f;
        if (live(c)) r[c] = bk - apply_a(c, x[c]);
        sums[0] += bk * bk;
        sums[1] += r[c] * r[c];
    }
    // its barrier also ends every read of x0 in the halo
    silt::block_sum(sums, red_b);
    const float thresh = tol2 * fmaxf(sums[0], 1e-30f);
    float rs = sums[1];
#pragma unroll
    for (int c = 0; c < kCells; ++c) p[c] = r[c];
    store_p();

    int it = 0;
    int parity = 0;
    while (true) {
        // whole-batch stop test; its barrier also makes the new p visible
        const bool any = silt::batch_busy(rs > thresh, busy, parity, flags, batch);
        if (it >= max_iter || !any) break;

        float pap[1] = {0.0f};
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
            if (live(c)) {
                ap[c] = apply_a(c, p[c]);
                pap[0] += p[c] * ap[c];
            }
        }
        silt::block_sum(pap, red_a);
        const float alpha = pap[0] == 0.0f ? 0.0f : rs / pap[0];
        float rs_new[1] = {0.0f};
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
            x[c] += alpha * p[c];
            r[c] -= alpha * ap[c];
            rs_new[0] += r[c] * r[c];
        }
        // its barrier also ends every read of p in the halo (the stencil's)
        silt::block_sum(rs_new, red_b);
        const float beta = rs_new[0] / (rs == 0.0f ? 1.0f : rs);
#pragma unroll
        for (int c = 0; c < kCells; ++c) p[c] = r[c] + beta * p[c];
        store_p();
        rs = rs_new[0];
        ++it;
    }

#pragma unroll
    for (int c = 0; c < kCells; ++c) {
        const int k = tid + c * kThreads;
        if (k < n) x_all[off + k] = x[c];
    }
    if (blockIdx.x == 0 && tid == 0) *iters = it;
    // no block of a cluster leaves while a peer may still read its flags
    if (flags == nullptr) silt::cgr::this_cluster().sync();
}

// the dynamic shared memory each instantiation is allowed so far, per device
int g_smem_allowed[2][silt::kMaxDevices] = {};

}  // namespace

// b, x0, x: (batch, h, w); fluid: (h, w); face_u: (h, w+1); face_v: (h+1, w);
// iters: one int; flags: 2 x batch ints of scratch, used (and required)
// only for a batch above kMaxCluster. All contiguous, on the current
// device. smem_bytes is the dynamic shared memory of one block
// (cg_smem_bytes in kernels/cg.py: p's halo, (h + 2) x (w + 1) floats).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int silt_cg_solve(const float* b, const float* x0, const float* fluid,
                             const float* face_u, const float* face_v, float* x, int* iters,
                             int* flags, int batch, int h, int w, float tol2, int max_iter,
                             int smem_bytes, void* stream) {
    if (h < 1 || w < 1 || batch < 1 || h * w > 1024 * kThreadCells ||
        smem_bytes < 4 * (h + 2) * (w + 1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch > silt::kMaxCluster && flags == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int* kflags = batch > silt::kMaxCluster ? flags : nullptr;
    const cudaError_t err =
        h * w <= kSmallCells
            ? silt::launch_batch(cg_kernel<256, true, kThreadCells>, g_smem_allowed[0], batch,
                                 256, smem_bytes, stream, b, x0, fluid, face_u, face_v, x, iters,
                                 kflags, batch, h, w, tol2, max_iter)
            : silt::launch_batch(cg_kernel<1024, false, kThreadCells>, g_smem_allowed[1], batch,
                                 1024, smem_bytes, stream, b, x0, fluid, face_u, face_v, x, iters,
                                 kflags, batch, h, w, tol2, max_iter);
    return static_cast<int>(err);
}
