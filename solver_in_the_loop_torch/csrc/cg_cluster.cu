// Fused (P)CG with one batch element spread over a thread-block cluster:
// hand-written Hopper (sm_90a) kernel, the layout of every shape the fast
// 64x32 layouts of csrc/pcg.cu and csrc/cg.cu do not take.
//
// Replaces the TPU kernels solver_in_the_loop_tpu/ops/pallas/cg_kernel.py
// `_pcg_kernel_folded` and `_pcg_kernel` (kPrecon, the FD preconditioner)
// and `_cg_kernel_folded` and `_cg_kernel` (without it, z = r) at the shapes
// the JAX package's VMEM gate takes (ops/pallas/cg.py:29-60): up to
// (1, 534, 267) with the preconditioner and (1, 626, 313) without, and
// batches of a few elements at 256x128. It solves, per batch element,
// A x = b with the operator of csrc/cg_common.cuh (`apply_cell`) and the
// loop of csrc/pcg.cu: warm start r0 = b - A x0, the p.Ap == 0 and r.z == 0
// guards, the stop rule r.r <= tol^2 max(b.b, 1e-30), the whole batch
// stopping together.
//
// Layout. An element is cut into bands of whole 16-row stripes, one band
// per block of a cluster of up to 16 blocks (the non-portable cluster size):
// at 256x128, 16 bands of 16 rows; at 534x267, 12 of 48. kernels/cg.py
// `cluster_plan` sizes the cluster from the shape and the batch, and the
// launch passes its blocks and band rows. The element's vectors (p, r, A p
// and the preconditioner's t1) live in a scratch array in global memory,
// which stays in the 50 MB L2: at 534x267 a field is 570 KB and Vy alone
// 1.14 MB, more than the cluster's shared memory holds beside the rest. A
// block owns its band's cells: x, r, A p and p are read and written only by
// the thread that owns the cell, and read by the neighbours (p's stencil
// rows, r and t1 in the cross-band products) through L2 (`__ldcg`) after a
// cluster barrier, never from a stale L1 line.
//
// The preconditioner z = Vy ((Vy^T r Vx) * invd) Vx^T runs on the tensor
// cores as the fast layout's does (3xTF32 `mma.sync.m16n8k8`, csrc/tf32.cuh,
// with the same k-steps and flushes, which tests/test_torch_pcg_tf32.py
// emulates): each warp of a block takes 16x8 output tiles of its band in
// turn. Vy^T r and Vy t1 read every row of their right-hand operand, so r
// and t1 are published to the cluster before them; (.) Vx and (.) Vx^T stay
// within a band, their left operand in shared memory. Vy, Vx and invd are
// read through L1 (`__ldg`).
//
// Reductions. Each block sums its partials (`block_sum`), posts them in
// shared memory and, after one cluster barrier, every warp reads the
// cluster's posts through distributed shared memory, one block per lane,
// and adds them with a butterfly: every thread of the cluster holds the
// same bits. The posts alternate two slots, so no block overwrites a post a
// peer may still read. The dot products and the loop's scalars (alpha,
// beta, the stop test) are float64, a measured choice: on 46 cold and warm
// solves of karman fields up to 534x267, float32 and float64 reductions
// part from the CPU's float32 loop by more than one iteration about as
// often (7 and 8 times; the card's own float32 loop parts from it by up to
// 8, where float64 takes 25-30 % fewer iterations), and float64 holds
// every cold case of chip_smoke.py's `pressure_route` within one, float32
// all but (1,96,48) (34 against 32; PERF.md). An element's stop test then
// needs no exchange; a batch of several elements (several clusters) posts
// each cluster's answer in global memory and meets at a barrier of the
// whole grid (atomics on a counter), which needs every block resident at
// once: the launch checks that with cudaOccupancyMaxActiveClusters and
// fails where it does not hold.
//
// An iteration is five cluster barriers with the preconditioner (the stop
// test, which publishes p; p.Ap; r; t1; r.z and r.r) and three without (the
// stop test, p.Ap, r.r). What bounds it on the H100 is that chain and the
// L2 latency of the cross-band products' operands, not HBM bytes or the
// tensor cores' rate (PERF.md).

#include <cuda_runtime.h>

#include "cg_common.cuh"
#include "tf32.cuh"

namespace {

using silt::Acc;
using silt::Cell;
using silt::split_tf32;
namespace cgr = cooperative_groups;

constexpr int kThreads = 512;  // CLUSTER_THREADS in kernels/cg.py
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClusterWide = 16;  // CLUSTER_MAX in kernels/cg.py
constexpr int kFlushSteps = 4;  // k-steps of 8 between flushes, as csrc/pcg.cu

// The row stride of a band buffer in shared memory: 4 mod 32, so that an A
// fragment's 32 lanes, (row g, column t), g < 8, t < 4, hit 32 banks
// (kernels/cg.py `cluster_smem_bytes`).
__host__ __device__ inline int band_stride(int w) { return w + (((4 - w) % 32) + 32) % 32; }

// Where an operand of a product lives.
// shared memory; read-only global memory (through L1); global memory written
// in this launch (through L2 only)
enum Src { kShared, kConst, kLive };

template <int S>
__device__ __forceinline__ float load(const float* p) {
    if constexpr (S == kConst) return __ldg(p);
    else if constexpr (S == kLive) return __ldcg(p);
    else return *p;
}

// Element (a, b) of a matrix: p[a * s0 + b * s1].
struct View {
    const float* p;
    int s0, s1;
};

// The C fragment d of the 16x8 tile at rows mb and columns nb of A (m x k)
// times B (k x n), k < klen, in 3xTF32; elements beyond m, n or klen read as
// 0. The k-steps and flushes of csrc/pcg.cu `tile_product`.
template <int SA, int SB>
__device__ __forceinline__ void tile(float (&d)[4], const View& a, const View& b, int mb, int nb,
                                     int m, int n, int klen) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bool m0 = mb + g < m, m1 = mb + g + 8 < m, n0 = nb + g < n;
    const float* pa = a.p + (mb + g) * a.s0 + t * a.s1;
    const float* pb = b.p + t * b.s0 + (nb + g) * b.s1;
    const int a8 = 8 * a.s0, a4 = 4 * a.s1, b4 = 4 * b.s0, ak = 8 * a.s1, bk = 8 * b.s0;
    Acc acc;
    acc.zero();
    const int steps = (klen + 7) >> 3;
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
        const int k = 8 * s + t;
        const bool k0 = k < klen, k1 = k + 4 < klen;
        unsigned ab[4], as[4], bb[2], bs[2];
        split_tf32(m0 && k0 ? load<SA>(pa) : 0.0f, ab[0], as[0]);
        split_tf32(m1 && k0 ? load<SA>(pa + a8) : 0.0f, ab[1], as[1]);
        split_tf32(m0 && k1 ? load<SA>(pa + a4) : 0.0f, ab[2], as[2]);
        split_tf32(m1 && k1 ? load<SA>(pa + a8 + a4) : 0.0f, ab[3], as[3]);
        split_tf32(k0 && n0 ? load<SB>(pb) : 0.0f, bb[0], bs[0]);
        split_tf32(k1 && n0 ? load<SB>(pb + b4) : 0.0f, bb[1], bs[1]);
        acc.mma(ab, as, bb, bs);
        if (s % kFlushSteps == kFlushSteps - 1) acc.flush();
        pa += ak;
        pb += bk;
    }
    acc.flush();
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = acc.sum[e];
}

// Sums of N per-thread partials over the cluster, in float64, left in every
// thread of it with the same bits: the block's sums (`block_sum`, scratch
// `red`), its post in `post[par]`, a cluster barrier, and the posts of the
// cluster's blocks, lane q reading block q's, added by a butterfly.
template <int N>
__device__ __forceinline__ void cluster_sum(double (&v)[N], double* red, double (*post)[4],
                                            int& par) {
    cgr::cluster_group cluster = cgr::this_cluster();
    silt::block_sum(v, red);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) post[par][i] = v[i];
    }
    cluster.sync();
    const int lane = threadIdx.x & 31;
    const bool peer = lane < static_cast<int>(cluster.num_blocks());
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = peer ? *cluster.map_shared_rank(&post[par][i], lane) : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
    par ^= 1;
}

// A barrier of the whole grid, every block resident: each block adds one to
// `count` and waits until it reaches `target` (the barriers so far times the
// blocks). The fences make every write before the barrier, by any thread of
// the block, visible to every block after it. A wait of more than about ten
// seconds (a block that never came) traps, which fails the launch instead
// of hanging the card.
__device__ inline void grid_barrier(unsigned* count, unsigned target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(count, 1u);
        const long long start = clock64();
        unsigned seen = 0;
        while (true) {
            asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                         : "=r"(seen)
                         : "l"(count)
                         : "memory");
            if (seen >= target) break;
            if (clock64() - start > 20000000000LL) __trap();
        }
        __threadfence();
    }
    __syncthreads();
}

// grid: (blocks per element, batch), one cluster per element (clusterDim.x =
// gridDim.x); `band` rows per block, a multiple of 16; `work`: per element
// p, r, A p (and t1 with kPrecon), each h x w; `sync`: for a batch above
// one, a zeroed counter and 2 x batch flags (else nullptr).
template <bool kPrecon>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_cg_kernel(const float* __restrict__ b_all, const float* __restrict__ x0_all,
                      const float* __restrict__ fluid, const float* __restrict__ face_u,
                      const float* __restrict__ face_v, const float* __restrict__ vy,
                      const float* __restrict__ vx, const float* __restrict__ invd,
                      float* __restrict__ x_all, int* __restrict__ iters, float* __restrict__ work,
                      unsigned* __restrict__ sync, int batch, int h, int w, int band, float tol2,
                      int max_iter) {
    extern __shared__ __align__(16) float smem[];  // kPrecon: t0 (then t2) and z, band x ld each
    __shared__ double red[3 * 32];
    __shared__ double post[2][4];

    cgr::cluster_group cluster = cgr::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rank = static_cast<int>(cluster.block_rank()), elem = blockIdx.y;
    const int n = h * w;
    const int r0 = rank * band;
    const int rows = max(0, min(band, h - r0));  // this block's rows: r0 .. r0 + rows
    const int c0 = r0 * w, c1 = (r0 + rows) * w;  // and cells
    const long long off = static_cast<long long>(elem) * n;
    const float* b = b_all + off;
    float* x = x_all + off;
    float* p = work + static_cast<long long>(elem) * (kPrecon ? 4 : 3) * n;
    float* r = p + n;
    float* ap = r + n;
    float* t1 = ap + n;  // kPrecon only
    const int ld = band_stride(w);
    float* tb = smem;  // t0 = Vy^T r, then t2 = Vy t1, on this band
    float* zb = smem + band * ld;  // z on this band
    int par = 0;  // the slot of the next post
    int fpar = 0;  // the row of the next stop flags
    unsigned gen = 0;  // grid barriers so far
    const unsigned blocks = gridDim.x * gridDim.y;

    // (A v) on cell k, v there given; its neighbours' p from L2, Dirichlet-0
    // ghosts outside the domain
    auto apply_a = [&](int k, float v) {
        const int j = k / w, i = k - j * w;
        const Cell cl = silt::load_cell(fluid, face_u, face_v, j, i, w);
        const float pe = i + 1 < w ? __ldcg(p + k + 1) : 0.0f;
        const float pw = i > 0 ? __ldcg(p + k - 1) : 0.0f;
        const float pn = j + 1 < h ? __ldcg(p + k + w) : 0.0f;
        const float ps = j > 0 ? __ldcg(p + k - w) : 0.0f;
        return silt::apply_cell(cl, v, pe, pw, pn, ps);
    };
    // the element's answer `mine` (the same in every block of the cluster)
    // or, for a batch, whether any element's is true; either way a barrier
    // that publishes p to the cluster
    auto busy = [&](bool mine) {
        if (sync == nullptr) {
            cluster.sync();
            return mine;
        }
        int* flags = reinterpret_cast<int*>(sync + 1) + fpar * batch;
        if (rank == 0 && tid == 0) __stcg(flags + elem, mine ? 1 : 0);
        grid_barrier(sync, ++gen * blocks);
        int any = 0;
        for (int k = lane; k < batch; k += 32) any |= __ldcg(flags + k);
        fpar ^= 1;
        return __any_sync(0xffffffffu, any) != 0;
    };
    // this warp's 16x8 tiles of the band, in turn: fn(mb, nb), band rows mb
    const int nq = (w + 7) >> 3, ntiles = ((rows + 15) >> 4) * nq;
    auto for_tiles = [&](auto&& fn) {
        for (int tl = warp; tl < ntiles; tl += kWarps) fn(16 * (tl / nq), 8 * (tl % nq));
    };
    // visits element e of a tile's C fragment that lies in the band: fn(a, c, d[e])
    auto each_cell = [&](int mb, int nb, const float (&d)[4], auto&& fn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int a = mb + g + 8 * (e >> 1), c = nb + 2 * t + (e & 1);
            if (a < rows && c < w) fn(a, c, d[e]);
        }
    };
    // z = Vy ((Vy^T r Vx) * invd) Vx^T on this band into zb; r published
    auto minv = [&]() {
        for_tiles([&](int mb, int nb) {  // t0(a, i) = sum_j Vy[j, r0 + a] r[j, i]
            float d[4];
            tile<kConst, kLive>(d, View{vy + r0, 1, h}, View{r, w, 1}, mb, nb, rows, w, h);
            each_cell(mb, nb, d, [&](int a, int c, float v) { tb[a * ld + c] = v; });
        });
        __syncthreads();
        for_tiles([&](int mb, int nb) {  // t1 = (t0 Vx) * invd
            float d[4];
            tile<kShared, kConst>(d, View{tb, ld, 1}, View{vx, w, 1}, mb, nb, rows, w, w);
            each_cell(mb, nb, d, [&](int a, int c, float v) {
                const int k = (r0 + a) * w + c;
                t1[k] = v * __ldg(invd + k);
            });
        });
        cluster.sync();  // t1 complete in the cluster; every read of t0 done
        for_tiles([&](int mb, int nb) {  // t2(a, i) = sum_j Vy[r0 + a, j] t1[j, i]
            float d[4];
            tile<kConst, kLive>(d, View{vy + r0 * h, h, 1}, View{t1, w, 1}, mb, nb, rows, w, h);
            each_cell(mb, nb, d, [&](int a, int c, float v) { tb[a * ld + c] = v; });
        });
        __syncthreads();
        for_tiles([&](int mb, int nb) {  // z = t2 Vx^T
            float d[4];
            tile<kShared, kConst>(d, View{tb, ld, 1}, View{vx, 1, w}, mb, nb, rows, w, w);
            each_cell(mb, nb, d, [&](int a, int c, float v) { zb[a * ld + c] = v; });
        });
        __syncthreads();
    };
    auto z_at = [&](int k) { return zb[(k / w - r0) * ld + k % w]; };

    // r0 = b - A x0 (p holds x0 for the operator); the threshold from b.b
    for (int k = c0 + tid; k < c1; k += kThreads) {
        const float v = x0_all[off + k];
        x[k] = v;
        p[k] = v;
    }
    cluster.sync();
    double rz, rs, thresh;
    {
        double s[2] = {0.0, 0.0};  // b.b, r.r
        for (int k = c0 + tid; k < c1; k += kThreads) {
            const float bk = b[k], rk = bk - apply_a(k, p[k]);
            r[k] = rk;
            s[0] += static_cast<double>(bk) * bk;
            s[1] += static_cast<double>(rk) * rk;
        }
        // its barrier also publishes r and ends every read of x0 in p
        cluster_sum(s, red, post, par);
        thresh = tol2 * fmax(s[0], 1e-30);
        rs = rz = s[1];
    }
    if constexpr (kPrecon) {  // z0 = M^-1 r0; p0 = z0
        minv();
        double s[2] = {0.0, 0.0};  // r.z, r.r
        for (int k = c0 + tid; k < c1; k += kThreads) {
            const float z = z_at(k), rk = r[k];
            s[0] += static_cast<double>(rk) * z;
            s[1] += static_cast<double>(rk) * rk;
            p[k] = z;
        }
        cluster_sum(s, red, post, par);
        rz = s[0];
        rs = s[1];
    } else {  // p0 = r0
        for (int k = c0 + tid; k < c1; k += kThreads) p[k] = r[k];
    }

    int it = 0;
    while (true) {
        const bool any = busy(rs > thresh);
        if (it >= max_iter || !any) break;

        double pap[1] = {0.0};
        for (int k = c0 + tid; k < c1; k += kThreads) {
            const float pk = p[k], a = apply_a(k, pk);
            ap[k] = a;
            pap[0] += static_cast<double>(pk) * a;
        }
        // its barrier also ends every read of p by the operator
        cluster_sum(pap, red, post, par);
        const float alpha = pap[0] == 0.0 ? 0.0f : static_cast<float>(rz / pap[0]);
        double s[2] = {0.0, 0.0};  // r.z, r.r
        for (int k = c0 + tid; k < c1; k += kThreads) {
            const float rk = r[k] - alpha * ap[k];
            x[k] += alpha * p[k];
            r[k] = rk;
            s[1] += static_cast<double>(rk) * rk;
        }
        if constexpr (kPrecon) {
            cluster.sync();  // r complete in the cluster
            minv();
            for (int k = c0 + tid; k < c1; k += kThreads)
                s[0] += static_cast<double>(r[k]) * z_at(k);
            cluster_sum(s, red, post, par);
        } else {
            double rr[1] = {s[1]};
            cluster_sum(rr, red, post, par);
            s[0] = s[1] = rr[0];
        }
        const float beta = static_cast<float>(s[0] / (rz == 0.0 ? 1.0 : rz));
        for (int k = c0 + tid; k < c1; k += kThreads)
            p[k] = (kPrecon ? z_at(k) : r[k]) + beta * p[k];
        rz = s[0];
        rs = s[1];
        ++it;
    }

    if (elem == 0 && rank == 0 && tid == 0) *iters = it;
    cluster.sync();  // no block leaves while a peer may still read its posts
}

int g_smem_allowed[2][silt::kMaxDevices] = {};

template <bool kPrecon>
cudaError_t launch(const float* b, const float* x0, const float* fluid, const float* face_u,
                   const float* face_v, const float* vy, const float* vx, const float* invd,
                   float* x, int* iters, float* work, unsigned* sync, int batch, int h, int w,
                   int cluster, int band, float tol2, int max_iter, void* stream, int* resident) {
    auto kernel = cluster_cg_kernel<kPrecon>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    const int smem = kPrecon ? 4 * 2 * band * band_stride(w) : 0;
    err = silt::allow_smem(kernel, smem, g_smem_allowed[kPrecon ? 1 : 0]);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, batch, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (resident != nullptr) return cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
    if (batch > 1) {  // the grid barrier needs every cluster resident at once
        int most = 0;
        err = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
        if (err != cudaSuccess) return err;
        if (most < batch) return cudaErrorCooperativeLaunchTooLarge;
    }
    err = cudaLaunchKernelEx(&cfg, kernel, b, x0, fluid, face_u, face_v, vy, vx, invd, x, iters,
                             work, sync, batch, h, w, band, tol2, max_iter);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// b, x0, x: (batch, h, w); fluid: (h, w); face_u: (h, w+1); face_v: (h+1, w);
// with precon, vy: (h, h), vx: (w, w), invd: (h, w) (else unread); iters:
// one int; work: batch x (4 with precon, else 3) x h x w floats of scratch;
// sync: for a batch above one, 1 + 2 x batch zeroed ints (else nullptr).
// All contiguous, on the current device. cluster blocks of `band` rows
// each (a multiple of 16) cover the h rows, every block at least one
// (kernels/cg.py `cluster_plan`). Returns the cudaError_t of the launch (0
// on success); cudaErrorCooperativeLaunchTooLarge where the batch's
// clusters cannot all be resident at once.
extern "C" int silt_cg_cluster_solve(int precon, const float* b, const float* x0,
                                     const float* fluid, const float* face_u, const float* face_v,
                                     const float* vy, const float* vx, const float* invd, float* x,
                                     int* iters, float* work, unsigned* sync, int batch, int h,
                                     int w, int cluster, int band, float tol2, int max_iter,
                                     void* stream) {
    if (h < 1 || w < 1 || batch < 1 || cluster < 1 || cluster > kMaxClusterWide || band < 16 ||
        band % 16 != 0 || static_cast<long long>(cluster) * band < h || (cluster - 1) * band >= h ||
        (batch > 1) != (sync != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        precon ? launch<true>(b, x0, fluid, face_u, face_v, vy, vx, invd, x, iters, work, sync,
                              batch, h, w, cluster, band, tol2, max_iter, stream, nullptr)
               : launch<false>(b, x0, fluid, face_u, face_v, vy, vx, invd, x, iters, work, sync,
                               batch, h, w, cluster, band, tol2, max_iter, stream, nullptr);
    return static_cast<int>(err);
}

// The clusters of `cluster` blocks (band rows each, at width w) that can be
// resident at once on the current device (cudaOccupancyMaxActiveClusters),
// into *most; kernels/cg.py CLUSTER_RESIDENT holds them for an H100 SXM.
extern "C" int silt_cg_cluster_resident(int precon, int w, int cluster, int band, int* most) {
    if (cluster < 1 || cluster > kMaxClusterWide || band < 16 || band % 16 != 0 || w < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        precon ? launch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr, 2, band * cluster, w,
                              cluster, band, 0.0f, 0, nullptr, most)
               : launch<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, nullptr, nullptr, 2, band * cluster, w,
                               cluster, band, 0.0f, 0, nullptr, most);
    return static_cast<int>(err);
}
