// Fused FD-preconditioned conjugate gradient: hand-written Hopper (sm_90a) kernel.
//
// Replaces the TPU kernels solver_in_the_loop_tpu/ops/pallas/cg_kernel.py
// `_pcg_kernel` (per-element grid, batch 1) and `_pcg_kernel_folded` (whole
// batch in one instance). It solves, per batch element, A x = b with
//
//   A(p) = fluid * -(me*E + mw*W + mn*N + ms*S - diag*p) + (1 - fluid) * p
//
// where E/W/N/S are the neighbours p[j,i+1], p[j,i-1], p[j+1,i], p[j-1,i]
// with Dirichlet-0 ghosts outside the domain, me/mw/mn/ms the face masks
// face_u[j,i+1], face_u[j,i], face_v[j+1,i], face_v[j,i], and
// diag = me + mw + mn + ms. The preconditioner is the fast diagonalization
// of the obstacle-free operator, z = Vy ((Vy^T r Vx) * invd) Vx^T. The loop
// follows cg_kernel.py:159-171: warm start r0 = b - A x0, the p.Ap == 0 and
// r.z == 0 guards, and the true-residual stopping rule r.r <= tol^2 max(b.b, 1e-30).
//
// Batch semantics. Like the folded TPU kernel and the XLA reference, the
// whole batch stops together: iteration continues while ANY element's r.r is
// above its threshold, and converged elements keep iterating. One thread
// block owns one batch element; a batch of at most 8 is one thread-block
// cluster, a larger one (up to MAX_BATCH in kernels/cg.py, one block per SM)
// a cooperative grid (`batch_busy` in csrc/cg_common.cuh, which this kernel
// shares with csrc/cg.cu, with the block reductions and the operator). The
// iteration count is written to a device int.
//
// Design. The field is cut into 16x8 tiles, the tiles of the mma products,
// and each warp owns two tiles side by side in a 16-row stripe: lane 4g + t
// owns the four cells of each tile's C fragment, (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1), and keeps their x, r, p, A p, z, operator
// coefficients and invd in registers (at 64x32: 8 warps, 8 cells a thread).
// The four preconditioner products run on the tensor cores as
// `mma.sync.m16n8k8` TF32 tiles in 3xTF32 (csrc/tf32.cuh, the split of
// csrc/conv.cu), every operand read from shared memory: an output tile lands
// in the C fragment of the warp that owns those cells, so the fourth
// product's z is already in the registers that update p, and the second's
// epilogue (* invd) uses the owner's invd. A warp's two tiles share each A
// fragment, loaded and split once: per k-step 8 loads and 8 splits for 6
// mma, where one tile per warp took 6 and 6 for 3. One TF32 product
// (1xTF32) would save two thirds of the mma work, but the PCG then takes 24
// iterations where the twin takes 20 at 64x32 (a CPU emulation,
// tests/test_torch_pcg_tf32.py), beyond PCG_ITER_TOL; so 3xTF32, with no
// switch.
//
// The products pair up: t1 = ((Vy^T r) Vx) * invd, then z = (Vy t1) Vx^T.
// A 16-row stripe of Vy^T r is all that the same stripe of its product with
// Vx reads, so the warps of a stripe chain the two with a named barrier of
// their own (`bar.sync 1 + stripe`); only Vy t1, which reads every row of
// t1, needs a block barrier. An iteration is then four block barriers (the
// p.Ap sum, r complete in shared memory, the middle of the preconditioner,
// the paired r.z and r.r sums), two stripe barriers and the cluster (or grid)
// barrier of the stop test, which also publishes the new p. Shared memory holds p in a halo of zeros (so the
// operator reads its ghosts without a test), r, the two temporaries, and Vy
// and Vx twice each, in the orientations the products read, with row
// strides that put every fragment load on 32 banks.
//
// Shapes. The kernel takes a field whose sides are multiples of 16 and that
// has at most 16 tiles in at most 15 stripes (the karman 64x32); every
// other shape runs csrc/cg_cluster.cu, one element over a cluster of
// blocks (kernels/cg.py `pcg_solve`). pcg_smem_bytes in kernels/cg.py
// mirrors the layout's shared memory.
//
// What bounds it on the H100. One iteration is about 0.85 MFLOP per element
// at 64x32 (the four products 4*H*W*(H+W) = 786 kFLOP, 2.4 MFLOP of TF32
// mma work in 3xTF32, and ~28 operations per cell of operator, dots and
// updates), on one SM with every operand in shared memory: neither HBM
// bytes nor the tensor cores' peak bound it. On an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py `kernels` and `--cg-split`, PERF.md) an iteration at
// (3,64,32) takes 4.7 us: the products about 3.0 (the warps' fragment
// loads from shared memory and mma issue, not the splits: keeping Vy and Vx
// split in shared memory, 8 bytes an element, made the iteration slower,
// 4.9 us), the two block reductions about 0.6 and the rest (operator,
// updates, barriers, the stop test) about 1.1; set-up and write-back 0.016
// ms a launch.

#include <cuda_runtime.h>

#include "cg_common.cuh"
#include "tf32.cuh"

namespace {

using silt::Acc;
using silt::Cell;
using silt::split_tf32;

constexpr int kWarps = 8;  // two tiles each
constexpr int kFlushSteps = 4;  // k-steps of 8 between flushes of the accumulators

// The smallest stride >= n that is m modulo 32.
__host__ __device__ inline int stride_mod32(int n, int m) { return n + (((m - n) % 32) + 32) % 32; }

// Shared-memory layout in floats: strides and offsets. Each stride is padded
// so that a fragment's 32 lanes hit 32 banks: an A operand's lanes read
// (m + g, k + t), g < 8, t < 4, so its row stride is 4 mod 32; a B operand
// stored k-major reads (k + t, n + g), row stride 8 mod 32; so r and t1 (B
// operands) take 8, t0 (an A operand) 4, and Vy and Vx are kept twice, each
// copy in the orientation one product reads, with stride 4.
struct Layout {
    int ps, ldr, ld0, ldy, ldx;  // strides: p's halo, r and t1, t0, Vy, Vx
    int r, t0, t1, vy, vyt, vx, vxt, words;
};

__host__ __device__ inline Layout pcg_layout(int h, int w) {
    Layout l;
    l.ps = stride_mod32(w + 1, 8);
    l.ldr = stride_mod32(w, 8);
    l.ld0 = stride_mod32(w, 4);
    l.ldy = stride_mod32(h, 4);
    l.ldx = stride_mod32(w, 4);
    l.r = (h + 2) * l.ps;
    l.t0 = l.r + h * l.ldr;
    l.t1 = l.t0 + h * l.ld0;
    l.vy = l.t1 + h * l.ldr;
    l.vyt = l.vy + h * l.ldy;
    l.vx = l.vyt + h * l.ldy;
    l.vxt = l.vx + w * l.ldx;
    l.words = l.vxt + w * l.ldx;
    return l;
}

// Element (a, b) of a matrix in shared memory: p[a * s0 + b * s1].
struct View {
    const float* p;
    int s0, s1;
};

// The C fragments d[q] of kN 16x8 tiles side by side, at rows mb and
// columns nb + 8q, of A (m x k) times B (k x n), over k < klen, in 3xTF32:
// the tiles share each A fragment, loaded and split once. Every kFlushSteps
// k-steps the three accumulators are added into the total.
template <int kN>
__device__ __forceinline__ void tile_product(float (&d)[kN][4], const View& a, const View& b,
                                             int mb, int nb, int klen) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* pa = a.p + (mb + g) * a.s0 + t * a.s1;
    const float* pb = b.p + t * b.s0 + (nb + g) * b.s1;
    const int a8 = 8 * a.s0, a4 = 4 * a.s1, b4 = 4 * b.s0, b8 = 8 * b.s1;
    const int ak = 8 * a.s1, bk = 8 * b.s0;
    Acc acc[kN];
#pragma unroll
    for (int q = 0; q < kN; ++q) acc[q].zero();
    const int steps = (klen + 7) >> 3;
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
        unsigned ab[4], as[4];
        split_tf32(pa[0], ab[0], as[0]);
        split_tf32(pa[a8], ab[1], as[1]);
        split_tf32(pa[a4], ab[2], as[2]);
        split_tf32(pa[a8 + a4], ab[3], as[3]);
#pragma unroll
        for (int q = 0; q < kN; ++q) {
            unsigned bb[2], bs[2];
            split_tf32(pb[q * b8], bb[0], bs[0]);
            split_tf32(pb[q * b8 + b4], bb[1], bs[1]);
            acc[q].mma(ab, as, bb, bs);
            if (s % kFlushSteps == kFlushSteps - 1) acc[q].flush();
        }
        pa += ak;
        pb += bk;
    }
#pragma unroll
    for (int q = 0; q < kN; ++q) {
        acc[q].flush();
#pragma unroll
        for (int e = 0; e < 4; ++e) d[q][e] = acc[q].sum[e];
    }
}

// Waits for the warps of stripe `stripe` (two tiles per warp, the stripe's
// nq / 2 warps consecutive).
__device__ __forceinline__ void stripe_sync(int stripe, int nq) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + stripe), "r"(16 * nq) : "memory");
}

__global__ void __launch_bounds__(kWarps * 32, 1)
    pcg_kernel(const float* __restrict__ b_all, const float* __restrict__ x0_all,
               const float* __restrict__ fluid, const float* __restrict__ face_u,
               const float* __restrict__ face_v, const float* __restrict__ vy_g,
               const float* __restrict__ vx_g, const float* __restrict__ invd_g,
               float* __restrict__ x_all, int* __restrict__ iters, int* __restrict__ flags,
               int batch, int h, int w, float tol2, int max_iter) {
    constexpr int kTiles = 2;  // per warp
    constexpr int kC = 4 * kTiles;  // cells per thread
    extern __shared__ __align__(16) float smem[];
    __shared__ float red_a[32];
    __shared__ float red_b[3 * 32];
    __shared__ int busy[2];  // the cluster's double-buffered "not converged" flag

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n = h * w;
    const int nq = (w + 7) >> 3;
    const long long off = static_cast<long long>(blockIdx.x) * n;
    const Layout lay = pcg_layout(h, w);
    float* ps = smem;
    float* rs_ = smem + lay.r;
    float* t0 = smem + lay.t0;
    float* t1 = smem + lay.t1;
    float* vy = smem + lay.vy;
    float* vyt = smem + lay.vyt;
    float* vx = smem + lay.vx;
    float* vxt = smem + lay.vxt;

    silt::stage_halo(ps, x0_all + off, h, w, lay.ps);
#pragma unroll 4
    for (int k = tid; k < h * h; k += blockDim.x) {
        const int j = k / h, a = k - j * h;
        vy[j * lay.ldy + a] = vy_g[k];
        vyt[a * lay.ldy + j] = vy_g[k];
    }
#pragma unroll 4
    for (int k = tid; k < w * w; k += blockDim.x) {
        const int i = k / w, c = k - i * w;
        vx[i * lay.ldx + c] = vx_g[k];
        vxt[c * lay.ldx + i] = vx_g[k];
    }

    // this thread's cells: tile u of the warp is 2 * warp + u (two
    // neighbours in a stripe); cell 4u + e of the thread is element e of the
    // tile's C fragment
    int mb[kTiles], nb[kTiles];
    float x[kC], r[kC], p[kC], ap[kC], z[kC], inv[kC], bv[kC];
    Cell cell[kC];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
        const int tile = 2 * warp + u;
        mb[u] = 16 * (tile / nq);
        nb[u] = 8 * (tile - (tile / nq) * nq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = 4 * u + e;
            const int j = mb[u] + g + 8 * (e >> 1), i = nb[u] + 2 * t + (e & 1);
            cell[c] = silt::load_cell(fluid, face_u, face_v, j, i, w);
            inv[c] = invd_g[j * w + i];
            x[c] = x0_all[off + j * w + i];
            bv[c] = b_all[off + j * w + i];
        }
    }

    // row and column of element e of tile u's C fragment
    auto row = [&](int u, int e) { return mb[u] + g + 8 * (e >> 1); };
    auto col = [&](int u, int e) { return nb[u] + 2 * t + (e & 1); };
    // out = A(v) on this thread's cells: v in registers, its neighbours
    // from the halo in shared memory (a cell's partner in its row pair from
    // the partner's register)
    auto apply_a = [&](const float (&v)[kC], float (&out)[kC]) {
#pragma unroll
        for (int u = 0; u < kTiles; ++u) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 4 * u + e;
                const int k = silt::halo_index(row(u, e), col(u, e), lay.ps);
                const float pe = (e & 1) ? ps[k + 1] : v[c ^ 1];
                const float pw = (e & 1) ? v[c ^ 1] : ps[k - 1];
                out[c] = silt::apply_cell(cell[c], v[c], pe, pw, ps[k + lay.ps], ps[k - lay.ps]);
            }
        }
    };
    // the four cells of tile u (a C fragment) into a matrix of row stride ld
    auto store_tile = [&](float* dst, int ld, int u, const float (&d)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[row(u, e) * ld + col(u, e)] = d[e];
    };
    // a product on this warp's tiles, out(u, d) on tile u's fragment: both
    // tiles at once (they share the A fragments)
    auto product = [&](const View& a, const View& b, int klen, auto&& out) {
        float d[2][4];
        tile_product<2>(d, a, b, mb[0], nb[0], klen);
        out(0, d[0]);
        out(1, d[1]);
    };
    // z = Vy ((Vy^T r Vx) * invd) Vx^T, r in shared memory, z into this
    // thread's cells; one block barrier, in the middle
    const View a_vyt{vyt, lay.ldy, 1};  // (a, j) = Vy[j, a]
    const View a_vy{vy, lay.ldy, 1};
    const View a_t0{t0, lay.ld0, 1};
    const View b_r{rs_, lay.ldr, 1};
    const View b_t1{t1, lay.ldr, 1};
    const View b_vx{vxt, 1, lay.ldx};  // (i, c) = Vx[i, c]
    const View b_vxt{vx, 1, lay.ldx};  // (c, i) = Vx[i, c]
    auto minv = [&]() {
        product(a_vyt, b_r, h, [&](int u, const float (&d)[4]) { store_tile(t0, lay.ld0, u, d); });
        stripe_sync(mb[0] >> 4, nq);  // t0 = Vy^T r
        product(a_t0, b_vx, w, [&](int u, const float (&d)[4]) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = d[e] * inv[4 * u + e];
            store_tile(t1, lay.ldr, u, v);
        });
        __syncthreads();  // t1 = (t0 Vx) * invd
        product(a_vy, b_t1, h, [&](int u, const float (&d)[4]) { store_tile(t0, lay.ld0, u, d); });
        stripe_sync(mb[0] >> 4, nq);  // t0 = Vy t1
#pragma unroll
        for (int c = 0; c < kC; ++c) z[c] = 0.0f;
        product(a_t0, b_vxt, w, [&](int u, const float (&d)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) z[4 * u + e] = d[e];
        });  // z = t0 Vx^T
    };
    // r into its matrix for the first product, p into the halo for the operator
    auto store_r_p = [&](bool into_r) {
#pragma unroll
        for (int u = 0; u < kTiles; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 4 * u + e;
                if (into_r) rs_[row(u, e) * lay.ldr + col(u, e)] = r[c];
                else ps[silt::halo_index(row(u, e), col(u, e), lay.ps)] = p[c];
            }
    };
    __syncthreads();

    // r0 = b - A x0; the threshold from ||b||^2; z0 = M^-1 r0; p0 = z0
#pragma unroll
    for (int c = 0; c < kC; ++c) p[c] = x[c];
    apply_a(p, ap);
    float sums[3] = {0.0f, 0.0f, 0.0f};  // b.b, r.z, r.r
#pragma unroll
    for (int c = 0; c < kC; ++c) {
        r[c] = bv[c] - ap[c];
        sums[0] += bv[c] * bv[c];
    }
    store_r_p(true);
    __syncthreads();  // r complete; every read of x0 in the halo done
    minv();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
        sums[1] += r[c] * z[c];
        sums[2] += r[c] * r[c];
    }
    silt::block_sum(sums, red_b);
    const float thresh = tol2 * fmaxf(sums[0], 1e-30f);
    float rz = sums[1], rs = sums[2];
#pragma unroll
    for (int c = 0; c < kC; ++c) p[c] = z[c];
    store_r_p(false);

    int it = 0;
    int parity = 0;
    while (true) {
        // whole-batch stop test; its barrier also makes the new p visible
        const bool any = silt::batch_busy(rs > thresh, busy, parity, flags, batch);
        if (it >= max_iter || !any) break;

        apply_a(p, ap);
        float pap[1] = {0.0f};
#pragma unroll
        for (int c = 0; c < kC; ++c) pap[0] += p[c] * ap[c];
        silt::block_sum(pap, red_a);
        const float alpha = pap[0] == 0.0f ? 0.0f : rz / pap[0];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
            x[c] += alpha * p[c];
            r[c] -= alpha * ap[c];
        }
        store_r_p(true);
        __syncthreads();  // r complete
        minv();
        float rr[2] = {0.0f, 0.0f};  // r.z, r.r
#pragma unroll
        for (int c = 0; c < kC; ++c) {
            rr[0] += r[c] * z[c];
            rr[1] += r[c] * r[c];
        }
        // its barrier also ends every read of p in the halo (the operator's)
        silt::block_sum(rr, red_b);
        const float beta = rr[0] / (rz == 0.0f ? 1.0f : rz);
#pragma unroll
        for (int c = 0; c < kC; ++c) p[c] = z[c] + beta * p[c];
        store_r_p(false);
        rz = rr[0];
        rs = rr[1];
        ++it;
    }

#pragma unroll
    for (int u = 0; u < kTiles; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) x_all[off + row(u, e) * w + col(u, e)] = x[4 * u + e];
    if (blockIdx.x == 0 && tid == 0) *iters = it;
    // no block of a cluster leaves while a peer may still read its flags
    if (flags == nullptr) silt::cgr::this_cluster().sync();
}

// the dynamic shared memory the kernel is allowed so far, per device
int g_smem_allowed[silt::kMaxDevices] = {};

}  // namespace

// b, x0, x: (batch, h, w); fluid: (h, w); face_u: (h, w+1); face_v: (h+1, w);
// vy: (h, h); vx: (w, w); invd: (h, w); iters: one int; flags: 2 x batch
// ints of scratch, used (and required) only for a batch above kMaxCluster.
// All contiguous, on the current device. smem_bytes is the dynamic shared
// memory of one block (pcg_smem_bytes in kernels/cg.py), which the kernel's
// layout must fit. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a shape the layout does not take.
extern "C" int silt_pcg_solve(const float* b, const float* x0, const float* fluid,
                              const float* face_u, const float* face_v, const float* vy,
                              const float* vx, const float* invd, float* x, int* iters,
                              int* flags, int batch, int h, int w, float tol2, int max_iter,
                              int smem_bytes, void* stream) {
    if (h < 1 || w < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int stripes = (h + 15) / 16, tiles = stripes * ((w + 7) / 8);
    // both sides multiples of 16 (a warp owns two tiles side by side), a
    // named barrier per stripe (ids 1..15; 0 is __syncthreads)
    if (h % 16 != 0 || w % 16 != 0 || tiles > 2 * kWarps || stripes > 15 ||
        4 * pcg_layout(h, w).words > smem_bytes)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch > silt::kMaxCluster && flags == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int* kflags = batch > silt::kMaxCluster ? flags : nullptr;
    const cudaError_t err =
        silt::launch_batch(pcg_kernel, g_smem_allowed, batch, 32 * (tiles / 2), smem_bytes, stream,
                           b, x0, fluid, face_u, face_v, vy, vx, invd, x, iters, kflags, batch, h,
                           w, tol2, max_iter);
    return static_cast<int>(err);
}
