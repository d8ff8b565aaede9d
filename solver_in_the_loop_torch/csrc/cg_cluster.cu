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
// `cluster_plan` sizes the cluster from the shape and the batch, and
// `cluster_on_chip` picks one of two variants of the same kernel (kOnChip):
//
// * On chip (every shape whose block fits 227 KB: 256x128 and 134x67 both
//   ways, 158x79 and 384x192 without the preconditioner). The band's x, r,
//   A p, z and p, p in two buffers that alternate by iteration, live in the
//   block's shared memory, each cell read and written only by the thread
//   that owns it (cell e = a * w + c of the band for threads e mod 512), or
//   by the tile that computes it. At launch the block stages its two Vy
//   slices (Vy[:, band] transposed and Vy[band, :], band x h each), split
//   into their TF32 parts once for all iterations, and Vx (w x w,
//   XOR-swizzled so that both Vx and Vx^T fragments hit 32 banks, by
//   cp.async): at 256x128 203 KB of shared memory a block (kernels/cg.py
//   `cluster_smem_bytes`). r (as the r update writes it) and t1 also go to
//   padded copies in global memory, which Vy^T r and Vy t1 read through L2.
// * In L2 (384x192 and 534x267 with the preconditioner, 534x267 and
//   626x313 without, where the band and Vx do not fit): the vectors in a
//   scratch array in global memory, which stays in the 50 MB L2, the
//   neighbours' cells read through it (`__ldcg`) after a cluster barrier,
//   Vy, Vx and invd through L1 (`__ldg`); z and t0 / t2 in shared memory;
//   the products, p (one buffer) and its five (three) barriers an
//   iteration those of the layout before (`tile`).
//
// On chip p's stencil reads the rows above and below the band from two halo
// rows in shared memory. No barrier publishes p: after the barrier that
// publishes z (r without the preconditioner) each block computes the
// neighbours' rows of the new p itself, z + beta p from the neighbour's z
// and old p, read over DSMEM, with the same fma as the neighbour's own
// update, so the halo holds the neighbour's bits; the old p stays readable
// because the update writes the other buffer.
//
// The preconditioner z = Vy ((Vy^T r Vx) * invd) Vx^T runs on the tensor
// cores as the fast layout's does (3xTF32 `mma.sync.m16n8k8`, csrc/tf32.cuh,
// with the same k-steps and flushes, which tests/test_torch_pcg_tf32.py
// emulates); each warp takes 16x8 output tiles of its band in turn. What
// bounds these products on the card is the instructions a k-step issues
// (splitting six operands into TF32 parts, masks, addresses), not where the
// operands live (`chip_smoke.py --cg-ablate`, PERF.md: read through L1
// instead of L2 they take the same time). So on chip the A operands (the Vy
// slices, and t0 / t2, split as they are stored) are read as split rows,
// one float4 a lane a row (`split_at`), every buffer a product reads is
// zero outside the cells, which takes the masks away, and only the two B
// operands are split in the loop. Vy^T r and Vy t1 read every row of r and
// t1: their B fragments come from the padded copies through L2, a flush's
// four k-steps of them loaded before the products; fragments read over
// DSMEM instead, k-step by k-step from the owning block, took 18 us more an
// iteration at 256x128 (PERF.md).
// (.) Vx and (.) Vx^T stay within a band, both operands in shared memory.
// The k order is j = 0..h-1 in steps of 8 in both variants, and the zeros
// add nothing, so the sums are the same bits as the layout before.
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
// needs no exchange and no barrier; a batch of several elements (several
// clusters) posts each cluster's answer in global memory and meets at a
// barrier of the whole grid (atomics on a counter), which needs every block
// resident at once: the launch checks that with
// cudaOccupancyMaxActiveClusters and fails where it does not hold.
//
// Barriers. On chip an iteration has four cluster barriers with the
// preconditioner (p.Ap; r.r, which publishes r; t1; r.z, which publishes z)
// and two without (p.Ap; r.r), against five and three in the layout before
// (which also published p at the stop test), as the L2 variant still does. The r.r barrier is split
// (`barrier.cluster.arrive.release` / `wait.acquire`) around the x update,
// which reads no peer's data. The bound on the H100 is the operations of
// the four products (pcg_bound_ms in chip_smoke.py); what holds the kernel
// far above it is the instructions of the products' k-steps and the chain
// of barriers (PERF.md).

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

// The smallest stride >= n that is m modulo 32 (kernels/cg.py _stride_mod32).
__host__ __device__ inline int stride_mod32(int n, int m) { return n + (((m - n) % 32) + 32) % 32; }

// The dynamic shared memory of a block, in floats from the start, and the row
// strides (kernels/cg.py `cluster_strides`, `cluster_smem_bytes`): `ldb`, 8
// mod 32, for the band vectors and the padded copies of r and t1, B
// operands of Vy^T r and Vy t1 on chip (lanes (t, g) at 8t + g); `lda`, 4
// mod 32, for t0 / t2 in the L2 variant, an A operand (lanes (g, t) at
// 4g + t); `lsw` and `lsh`, 16 mod 32, for the split rows (`split_at`) of
// t0 / t2 and of the Vy slices on chip, A operands read a float4 a lane (a
// quarter warp's 8 lanes on 32 banks); `ldx` for Vx on chip (`vx_at`), w
// rounded up to 8 rows of it. On chip every buffer a product reads is zero
// beyond the band's cells (rows to the band or to h rounded up to 8,
// columns to w rounded up to 8), so the products read whole k-steps with
// no mask.
struct Layout {
    int ldb, lda, lsw, lsh, ldx;
    int halo, p0, p1, r, ap, x, z, tb, vy1, vy2, vx, floats;
};

__host__ __device__ inline Layout layout(bool precon, bool onchip, int band, int h, int w) {
    Layout l = {};
    const int w8 = (w + 7) / 8 * 8, h8 = (h + 7) / 8 * 8;
    l.ldb = stride_mod32(w, 8);
    l.lda = stride_mod32(w, 4);
    l.lsw = stride_mod32(2 * w8, 16);
    l.lsh = stride_mod32(2 * h8, 16);
    l.ldx = stride_mod32((w + 15) / 16 * 16, 8);
    const int field = band * l.ldb;
    int at = 0;
    if (onchip) {
        l.halo = at;  // p's rows r0 - 1 and r0 + rows
        l.p0 = l.halo + 2 * l.ldb;
        l.p1 = l.p0 + field;
        l.r = l.p1 + field;
        l.ap = l.r + field;
        l.x = l.ap + field;
        at = l.x + field;
    }
    if (precon) {
        l.z = at;
        l.tb = l.z + field;
        at = l.tb + band * (onchip ? l.lsw : l.lda);
        if (onchip) {
            l.vy1 = at;
            l.vy2 = l.vy1 + band * l.lsh;
            l.vx = l.vy2 + band * l.lsh;
            at = l.vx + w8 * l.ldx;
        }
    }
    l.floats = at;
    return l;
}

// Floats of the global scratch a batch element takes (kernels/cg.py
// `cluster_work_shape`): on chip with the preconditioner padded copies of r
// and t1 (h8 x ldb each); in L2 p, r, A p and, with the preconditioner, t1
// (h x w each).
__host__ __device__ inline long long work_floats(bool precon, bool onchip, int band, int h, int w) {
    if (onchip) return precon ? 2LL * ((h + 7) / 8 * 8) * layout(true, true, band, h, w).ldb : 0;
    return (precon ? 4LL : 3LL) * h * w;
}

// Where element k of a split row lies: each k-step of 8 elements is 16
// floats, lane t's float4 holding the TF32 big parts of k = t and t + 4, then
// their small parts (csrc/tf32.cuh `split_tf32`), in the order an A fragment
// takes them (kernels/cg.py `split_index`).
__device__ __forceinline__ int split_at(int k) {
    return (k >> 3) * 16 + 4 * (k & 3) + ((k >> 2) & 1);
}

// Stores v split into TF32 big and small parts at element k of a split row.
__device__ __forceinline__ void split_store(float* row, int k, float v) {
    unsigned big, small;
    split_tf32(v, big, small);
    row[split_at(k)] = __uint_as_float(big);
    row[split_at(k) + 2] = __uint_as_float(small);
}

// Where Vx[i, j] lies in the staged copy: bits 2-3 of the column flipped by
// bits 2-3 of the row, so that both B = Vx (lanes read rows k + t, columns
// n + g) and B = Vx^T (rows n + g, columns k + t) hit 32 banks with ldx 8
// mod 32 (kernels/cg.py `vx_index`).
__device__ __forceinline__ int vx_at(int i, int j, int ldx) {
    return i * ldx + (j ^ (((i >> 2) & 3) << 2));
}

// Where an operand of an L2 variant's product lives: read-only global memory
// (through L1); global memory written in this launch (through L2 only);
// shared memory.
enum Src { kConst, kLive, kShared };

template <int S>
__device__ __forceinline__ float load(const float* p) {
    if constexpr (S == kConst) return __ldg(p);
    else if constexpr (S == kLive) return __ldcg(p);
    else return *p;
}

// The L2 variant's products: the C fragment of the 16x8 tile at rows mb and
// columns nb of A (m x k, element (i, j) at a[i * as0 + j * as1]) times B
// (k x n, at b[i * bs0 + j * bs1]), k < klen, in 3xTF32; elements beyond m,
// n or klen read as 0. The k-steps and flushes of csrc/pcg.cu
// `tile_product`, four k-steps of loads in flight.
template <int SA, int SB>
__device__ __forceinline__ float4 tile(const float* a, int as0, int as1, const float* b, int bs0,
                                    int bs1, int mb, int nb, int m, int n, int klen) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bool m0 = mb + g < m, m1 = mb + g + 8 < m, n0 = nb + g < n;
    const float* pa = a + (mb + g) * as0 + t * as1;
    const float* pb = b + t * bs0 + (nb + g) * bs1;
    const int a8 = 8 * as0, a4 = 4 * as1, b4 = 4 * bs0, ak = 8 * as1, bk = 8 * bs0;
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
    return make_float4(acc.sum[0], acc.sum[1], acc.sum[2], acc.sum[3]);
}

// One 3xTF32 k-step of a 16x8 tile whose A rows g and g + 8 are split rows
// (their float4s a0, a1 at this k-step) and whose B elements (t, g) and
// (t + 4, g) are b0 and b1: the fragments of `tile`, in its order.
__device__ __forceinline__ void split_step(Acc& acc, const float4& a0, const float4& a1, float b0,
                                           float b1) {
    const unsigned ab[4] = {__float_as_uint(a0.x), __float_as_uint(a1.x), __float_as_uint(a0.y),
                            __float_as_uint(a1.y)};
    const unsigned as[4] = {__float_as_uint(a0.z), __float_as_uint(a1.z), __float_as_uint(a0.w),
                            __float_as_uint(a1.w)};
    unsigned bb[2], bs[2];
    split_tf32(b0, bb[0], bs[0]);
    split_tf32(b1, bb[1], bs[1]);
    acc.mma(ab, as, bb, bs);
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The first half of a sum of N per-thread partials over the cluster: the
// block's sums (`block_sum`, scratch `red`), its post in `post[par]` and the
// arrival at a cluster barrier. Work that reads no peer's data may run before
// `cluster_collect`.
template <int N>
__device__ __forceinline__ void cluster_post(double (&v)[N], double* red, double (*post)[4],
                                             int par) {
    silt::block_sum(v, red);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) post[par][i] = v[i];
    }
    cluster_arrive();
}

// The second half: the wait at the barrier, then the posts of the cluster's
// blocks, lane q reading block q's, added by a butterfly; every thread of the
// cluster holds the same bits.
template <int N>
__device__ __forceinline__ void cluster_collect(double (&v)[N], double (*post)[4], int& par) {
    cgr::cluster_group cluster = cgr::this_cluster();
    cluster_wait();
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

template <int N>
__device__ __forceinline__ void cluster_sum(double (&v)[N], double* red, double (*post)[4],
                                            int& par) {
    cluster_post(v, red, post, par);
    cluster_collect(v, post, par);
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
// `work_floats` of scratch (nullptr where that is 0); `sync`: for a batch
// above one, a zeroed counter and 2 x batch flags (else nullptr).
template <bool kPrecon, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_cg_kernel(const float* __restrict__ b_all, const float* __restrict__ x0_all,
                      const float* __restrict__ fluid, const float* __restrict__ face_u,
                      const float* __restrict__ face_v, const float* __restrict__ vy,
                      const float* __restrict__ vx, const float* __restrict__ invd,
                      float* __restrict__ x_all, int* __restrict__ iters, float* __restrict__ work,
                      unsigned* __restrict__ sync, int batch, int h, int w, int band, float tol2,
                      int max_iter) {
    extern __shared__ __align__(16) float smem[];  // `Layout`
    __shared__ double red[3 * 32];
    __shared__ double post[2][4];

    cgr::cluster_group cluster = cgr::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rank = static_cast<int>(cluster.block_rank()), elem = blockIdx.y;
    const int n = h * w;
    const int r0 = rank * band;
    const int rows = max(0, min(band, h - r0));  // this block's rows: r0 .. r0 + rows
    const int cells = rows * w;
    const int w8 = (w + 7) / 8 * 8, h8 = (h + 7) / 8 * 8;
    const long long off = static_cast<long long>(elem) * n;
    const float* b = b_all + off;
    const float* x0 = x0_all + off;
    const Layout L = layout(kPrecon, kOnChip, band, h, w);
    float* wk = work + static_cast<long long>(elem) * work_floats(kPrecon, kOnChip, band, h, w);
    // the band vectors: row a of this band at v + a * ld (shared memory on
    // chip, else the element's scratch in global memory)
    const int ld = kOnChip ? L.ldb : w;
    float *P0, *P1, *R, *AP, *X;
    if constexpr (kOnChip) {
        P0 = smem + L.p0;
        P1 = smem + L.p1;
        R = smem + L.r;
        AP = smem + L.ap;
        X = smem + L.x;
    } else {  // one p, updated in place and published by a barrier
        P0 = P1 = wk + r0 * w;
        R = P0 + n;
        AP = R + n;
        X = x_all + off + r0 * w;
        wk += 3LL * n;
    }
    // kPrecon: on chip the padded copies of r and t1 (this block's row 0,
    // rows at L.ldb), else t1 a band vector; z (rows at L.ldb) and t0 / t2 (on
    // chip split rows at L.lsw, else L.lda) in shared memory
    float* RG = wk + r0 * L.ldb;  // on chip
    float* T1 = kOnChip ? RG + h8 * L.ldb : wk + r0 * w;
    const int ldt = kOnChip ? L.ldb : w;  // the row stride of T1
    float* vy1 = smem + L.vy1;  // on chip, split rows a: Vy[j, r0 + a] at j
    float* vy2 = smem + L.vy2;  // on chip, split rows a: Vy[r0 + a, j] at j
    float* Z = smem + L.z;
    float* tb = smem + L.tb;
    float* vxs = smem + L.vx;  // on chip
    float* halo = smem + L.halo;  // p's row r0 - 1, then (at L.ldb) row r0 + rows
    int par = 0;  // the slot of the next post
    int fpar = 0;  // the row of the next stop flags
    unsigned gen = 0;  // grid barriers so far
    const unsigned blocks = gridDim.x * gridDim.y;

    // fn(a, c) on this thread's cells of the band: e = a * w + c, e = tid mod 512
    auto each_cell = [&](auto&& fn) {
        for (int e = tid; e < cells; e += kThreads) {
            const int a = e / w;
            fn(a, e - a * w);
        }
    };
    // (A v) on cell (a, c) of the band from the band vector v, its rows -1
    // and `rows` from the halo on chip (zeros beyond the domain)
    auto apply_a = [&](const float* v, int a, int c) {
        const Cell cl = silt::load_cell(fluid, face_u, face_v, r0 + a, c, w);
        const float* row = v + a * ld;
        float pe, pw, pn, ps;
        if constexpr (kOnChip) {
            pe = c + 1 < w ? row[c + 1] : 0.0f;
            pw = c > 0 ? row[c - 1] : 0.0f;
            pn = a + 1 < rows ? row[ld + c] : halo[L.ldb + c];
            ps = a > 0 ? row[c - ld] : halo[c];
        } else {  // the neighbours' rows too, in L2 after the barrier that published p
            pe = c + 1 < w ? __ldcg(row + c + 1) : 0.0f;
            pw = c > 0 ? __ldcg(row + c - 1) : 0.0f;
            pn = r0 + a + 1 < h ? __ldcg(row + ld + c) : 0.0f;
            ps = r0 + a > 0 ? __ldcg(row + c - ld) : 0.0f;
        }
        return silt::apply_cell(cl, row[c], pe, pw, pn, ps);
    };
    // (A x0) on cell (a, c), x0 read-only in global memory
    auto apply_x0 = [&](int a, int c) {
        const int j = r0 + a, k = j * w + c;
        const Cell cl = silt::load_cell(fluid, face_u, face_v, j, c, w);
        const float pe = c + 1 < w ? x0[k + 1] : 0.0f;
        const float pw = c > 0 ? x0[k - 1] : 0.0f;
        const float pn = j + 1 < h ? x0[k + w] : 0.0f;
        const float ps = j > 0 ? x0[k - w] : 0.0f;
        return silt::apply_cell(cl, x0[k], pe, pw, pn, ps);
    };
    // on chip: p's halo rows, the neighbours' z (r without the
    // preconditioner) plus beta times their p[cur] over DSMEM, as each
    // computes its own (`first`: z alone)
    auto fill_halo = [&](const float* pc, bool first, float beta) {
        for (int e = tid; e < 2 * w; e += kThreads) {
            const int side = e >= w, c = e - side * w;
            const int j = side ? r0 + rows : r0 - 1;
            float v = 0.0f;
            if (j >= 0 && j < h) {
                const int q = j / band, a = j - q * band;
                const float zq = *(cluster.map_shared_rank(kPrecon ? Z : R, q) + a * L.ldb + c);
                v = first ? zq
                          : __fmaf_rn(beta, *(cluster.map_shared_rank(const_cast<float*>(pc), q) +
                                              a * L.ldb + c),
                                      zq);
            }
            halo[side * L.ldb + c] = v;
        }
    };
    // this warp's 16x8 tiles of the band, in turn: fn(mb, nb), band rows mb
    const int nq = (w + 7) >> 3, ntiles = ((rows + 15) >> 4) * nq;
    auto for_tiles = [&](auto&& fn) {
        for (int tl = warp; tl < ntiles; tl += kWarps) fn(16 * (tl / nq), 8 * (tl % nq));
    };
    // visits element e of a tile's C fragment that lies in the band: fn(a, c, d[e])
    auto each_frag = [&](int mb, int nb, const float (&d)[4], auto&& fn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int a = mb + g + 8 * (e >> 1), c = nb + 2 * t + (e & 1);
            if (a < rows && c < w) fn(a, c, d[e]);
        }
    };

    // on chip with kPrecon: the zeros beyond the cells of the padded copies
    // and of t0 / t2; the Vy slices split into TF32 parts once for all
    // iterations (zeros beyond the band's rows and h); Vx by cp.async (zeros
    // beyond w)
    if constexpr (kOnChip && kPrecon) {
        const int zr = min(band, h8 - r0);  // this band's rows of the padded copies
        for (int e = tid; e < zr * L.ldb; e += kThreads) {
            const int a = e / L.ldb, c = e - a * L.ldb;
            if (a >= rows || c >= w) RG[e] = T1[e] = 0.0f;
        }
        for (int e = tid; e < band * L.lsw; e += kThreads) tb[e] = 0.0f;
        for (int e = tid; e < band * h8; e += kThreads) {
            const int j = e / band, a = e - j * band;
            const bool in = a < rows && j < h;
            split_store(vy1 + a * L.lsh, j, in ? vy[j * h + r0 + a] : 0.0f);
            split_store(vy2 + a * L.lsh, j, in ? vy[(r0 + a) * h + j] : 0.0f);
        }
        for (int e = tid; e < w8 * w8; e += kThreads) {
            const int i = e / w8, j = e - i * w8;
            if (i < w && j < w) cp_async4(vxs + vx_at(i, j, L.ldx), vx + i * w + j);
            else vxs[vx_at(i, j, L.ldx)] = 0.0f;
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        __syncthreads();
    }

    // on chip: out(a, i) = sum_j A[a, j] V[j, i] for this warp's tiles, A
    // this block's Vy slice in split rows (rows x h), V the padded copy of r
    // or t1 (its row 0 at v) read through L2, a flush's kFlushSteps k-steps
    // of B fragments loaded together before their products; store(a, c,
    // value) on each cell of the band
    auto cross_product = [&](const float* A, const float* v, auto&& store) {
        const int steps = h8 >> 3;
        for_tiles([&](int mb, int nb) {
            const float* pa = A + (mb + g) * L.lsh + 4 * t;
            const float* pb = v + t * L.ldb + nb + g;
            Acc acc;
            acc.zero();
            for (int s0 = 0; s0 < steps; s0 += kFlushSteps) {
                float b0[kFlushSteps], b1[kFlushSteps];
#pragma unroll
                for (int u = 0; u < kFlushSteps; ++u) {
                    if (s0 + u < steps) {
                        b0[u] = __ldcg(pb + 8 * (s0 + u) * L.ldb);
                        b1[u] = __ldcg(pb + (8 * (s0 + u) + 4) * L.ldb);
                    }
                }
#pragma unroll
                for (int u = 0; u < kFlushSteps; ++u) {
                    if (s0 + u < steps) {
                        const int s = 16 * (s0 + u);
                        split_step(acc, *reinterpret_cast<const float4*>(pa + s),
                                   *reinterpret_cast<const float4*>(pa + 8 * L.lsh + s), b0[u],
                                   b1[u]);
                    }
                }
                if (s0 + kFlushSteps <= steps) acc.flush();
            }
            acc.flush();
            each_frag(mb, nb, acc.sum, store);
        });
    };
    // on chip: out = t B for this warp's tiles, t (t0 or t2) this band's
    // split rows in tb, B = Vx or (transposed) Vx^T in the staged copy
    auto local_product = [&](bool transposed, auto&& store) {
        const int steps = w8 >> 3;
        const auto lb = [&](int k, int c) {
            return transposed ? vxs[vx_at(c, k, L.ldx)] : vxs[vx_at(k, c, L.ldx)];
        };
        for_tiles([&](int mb, int nb) {
            const float* pa = tb + (mb + g) * L.lsw + 4 * t;
            Acc acc;
            acc.zero();
#pragma unroll 4
            for (int s = 0; s < steps; ++s) {
                const int k = 8 * s + t, c = nb + g;
                split_step(acc, *reinterpret_cast<const float4*>(pa + 16 * s),
                           *reinterpret_cast<const float4*>(pa + 8 * L.lsw + 16 * s), lb(k, c),
                           lb(k + 4, c));
                if (s % kFlushSteps == kFlushSteps - 1) acc.flush();
            }
            acc.flush();
            each_frag(mb, nb, acc.sum, store);
        });
    };
    const auto store_tb = [&](int a, int c, float v) {
        if constexpr (kOnChip) split_store(tb + a * L.lsw, c, v);
        else tb[a * L.lda + c] = v;
    };
    const auto store_t1 = [&](int a, int c, float v) {
        T1[a * ldt + c] = v * __ldg(invd + (r0 + a) * w + c);
    };
    const auto store_z = [&](int a, int c, float v) { Z[a * L.ldb + c] = v; };
    // z = Vy ((Vy^T r Vx) * invd) Vx^T on this band into Z; r published
    auto minv = [&]() {
        if constexpr (kOnChip) {
            // t0(a, i) = sum_j Vy[j, r0 + a] r[j, i]
            cross_product(vy1, RG - r0 * L.ldb, store_tb);
            __syncthreads();
            local_product(false, store_t1);  // t1 = (t0 Vx) * invd
            cluster.sync();  // t1 complete in the cluster; every read of t0 done
            // t2(a, i) = sum_j Vy[r0 + a, j] t1[j, i]
            cross_product(vy2, T1 - r0 * L.ldb, store_tb);
            __syncthreads();
            local_product(true, store_z);  // z = t2 Vx^T
        } else {
            const float* r_all = R - r0 * w;
            const float* t1_all = T1 - r0 * w;
            const auto each = [&](const float4& d4, int mb, int nb, auto&& store) {
                const float d[4] = {d4.x, d4.y, d4.z, d4.w};
                each_frag(mb, nb, d, store);
            };
            for_tiles([&](int mb, int nb) {  // t0 = Vy^T r
                each(tile<kConst, kLive>(vy + r0, 1, h, r_all, w, 1, mb, nb, rows, w, h), mb, nb,
                     store_tb);
            });
            __syncthreads();
            for_tiles([&](int mb, int nb) {  // t1 = (t0 Vx) * invd
                each(tile<kShared, kConst>(tb, L.lda, 1, vx, w, 1, mb, nb, rows, w, w), mb, nb,
                     store_t1);
            });
            cluster.sync();  // t1 complete in the cluster; every read of t0 done
            for_tiles([&](int mb, int nb) {  // t2 = Vy t1
                each(tile<kConst, kLive>(vy + r0 * h, h, 1, t1_all, w, 1, mb, nb, rows, w, h), mb,
                     nb, store_tb);
            });
            __syncthreads();
            for_tiles([&](int mb, int nb) {  // z = t2 Vx^T
                each(tile<kShared, kConst>(tb, L.lda, 1, vx, 1, w, mb, nb, rows, w, w), mb, nb,
                     store_z);
            });
        }
        __syncthreads();
    };
    // the element's answer `mine` (the same in every block of the cluster)
    // or, for a batch, whether any element's is true, at a grid barrier; in
    // L2 a barrier either way, which publishes p
    auto busy = [&](bool mine) {
        if (sync == nullptr) {
            if constexpr (!kOnChip) cluster.sync();
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

    // x = x0; r0 = b - A x0; the threshold from b.b
    double rz, rs, thresh;
    {
        double s[2] = {0.0, 0.0};  // b.b, r.r
        each_cell([&](int a, int c) {
            const int k = (r0 + a) * w + c;
            const float bk = b[k], rk = bk - apply_x0(a, c);
            X[a * ld + c] = x0[k];
            R[a * ld + c] = rk;
            if constexpr (kOnChip && kPrecon) RG[a * L.ldb + c] = rk;
            s[0] += static_cast<double>(bk) * bk;
            s[1] += static_cast<double>(rk) * rk;
        });
        cluster_sum(s, red, post, par);  // its barrier also publishes r
        thresh = tol2 * fmax(s[0], 1e-30);
        rs = rz = s[1];
    }
    int cur = 0;  // the buffer of p
    if constexpr (kPrecon) {  // z0 = M^-1 r0; p0 = z0
        if constexpr (kOnChip) {
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncthreads();
        }
        minv();
        double s[2] = {0.0, 0.0};  // r.z, r.r
        each_cell([&](int a, int c) {
            const float z = Z[a * L.ldb + c], rk = R[a * ld + c];
            s[0] += static_cast<double>(rk) * z;
            s[1] += static_cast<double>(rk) * rk;
            P0[a * ld + c] = z;
        });
        cluster_sum(s, red, post, par);  // its barrier also publishes z
        rz = s[0];
        rs = s[1];
    } else {  // p0 = r0
        each_cell([&](int a, int c) { P0[a * ld + c] = R[a * ld + c]; });
    }
    if constexpr (kOnChip) fill_halo(P0, true, 0.0f);
    __syncthreads();

    int it = 0;
    while (true) {
        const bool any = busy(rs > thresh);
        if (it >= max_iter || !any) break;
        const float* p = cur ? P1 : P0;

        double pap[1] = {0.0};
        each_cell([&](int a, int c) {
            const float pk = p[a * ld + c], av = apply_a(p, a, c);
            AP[a * ld + c] = av;
            pap[0] += static_cast<double>(pk) * av;
        });
        cluster_sum(pap, red, post, par);
        const float alpha = pap[0] == 0.0 ? 0.0f : static_cast<float>(rz / pap[0]);
        double rr[1] = {0.0};
        each_cell([&](int a, int c) {
            const float rk = R[a * ld + c] - alpha * AP[a * ld + c];
            R[a * ld + c] = rk;
            if constexpr (kOnChip && kPrecon) RG[a * L.ldb + c] = rk;
            rr[0] += static_cast<double>(rk) * rk;
        });
        // its barrier publishes r; the x update reads no peer's data
        cluster_post(rr, red, post, par);
        each_cell([&](int a, int c) { X[a * ld + c] += alpha * p[a * ld + c]; });
        cluster_collect(rr, post, par);
        double rz_new;
        if constexpr (kPrecon) {
            minv();
            double s[1] = {0.0};  // r.z
            each_cell([&](int a, int c) {
                s[0] += static_cast<double>(R[a * ld + c]) * Z[a * L.ldb + c];
            });
            cluster_sum(s, red, post, par);  // its barrier also publishes z
            rz_new = s[0];
        } else {
            rz_new = rr[0];
        }
        const float beta = static_cast<float>(rz_new / (rz == 0.0 ? 1.0 : rz));
        float* pn = cur ? P0 : P1;
        each_cell([&](int a, int c) {
            const float zk = kPrecon ? Z[a * L.ldb + c] : R[a * ld + c];
            pn[a * ld + c] = __fmaf_rn(beta, p[a * ld + c], zk);
        });
        if constexpr (kOnChip) fill_halo(p, false, beta);
        cur ^= 1;
        __syncthreads();
        rz = rz_new;
        rs = rr[0];
        ++it;
    }

    if (elem == 0 && rank == 0 && tid == 0) *iters = it;
    if constexpr (kOnChip)
        each_cell([&](int a, int c) { x_all[off + (r0 + a) * w + c] = X[a * ld + c]; });
    cluster.sync();  // no block leaves while a peer may still read its shared memory
}

int g_smem_allowed[2][2][silt::kMaxDevices] = {};

template <bool kPrecon, bool kOnChip>
cudaError_t launch(const float* b, const float* x0, const float* fluid, const float* face_u,
                   const float* face_v, const float* vy, const float* vx, const float* invd,
                   float* x, int* iters, float* work, unsigned* sync, int batch, int h, int w,
                   int cluster, int band, float tol2, int max_iter, void* stream, int* resident) {
    auto kernel = cluster_cg_kernel<kPrecon, kOnChip>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    const int smem = 4 * layout(kPrecon, kOnChip, band, h, w).floats;
    err = silt::allow_smem(kernel, smem, g_smem_allowed[kPrecon ? 1 : 0][kOnChip ? 1 : 0]);
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

template <class... Args>
cudaError_t dispatch(int precon, int onchip, Args... args) {
    if (precon) return onchip ? launch<true, true>(args...) : launch<true, false>(args...);
    return onchip ? launch<false, true>(args...) : launch<false, false>(args...);
}

bool plan_ok(int h, int w, int cluster, int band) {
    return h >= 1 && w >= 1 && cluster >= 1 && cluster <= kMaxClusterWide && band >= 16 &&
           band % 16 == 0 && static_cast<long long>(cluster) * band >= h &&
           (cluster - 1) * band < h;
}

}  // namespace

// b, x0, x: (batch, h, w); fluid: (h, w); face_u: (h, w+1); face_v: (h+1, w);
// with precon, vy: (h, h), vx: (w, w), invd: (h, w) (else unread); iters:
// one int; work: with onchip, batch x 2 x h8 x ldb floats with precon
// (kernels/cg.py `cluster_work_shape`; h8 = h and w rounded up to 8, ldb
// the row stride of `Layout`), unread (nullptr) without; else batch x (5
// with precon, else 4) x h x w floats of scratch; sync: for a batch above one,
// 1 + 2 x batch zeroed ints (else nullptr). All contiguous, on the current
// device. cluster blocks of `band` rows each (a multiple of 16) cover the h
// rows, every block at least one (kernels/cg.py `cluster_plan`); onchip as
// kernels/cg.py `cluster_on_chip`. Returns the cudaError_t of the launch (0
// on success); cudaErrorInvalidValue for a plan or a variant the kernel
// does not take (also where the block's shared memory is refused),
// cudaErrorCooperativeLaunchTooLarge where the batch's clusters cannot all
// be resident at once.
extern "C" int silt_cg_cluster_solve(int precon, int onchip, const float* b, const float* x0,
                                     const float* fluid, const float* face_u, const float* face_v,
                                     const float* vy, const float* vx, const float* invd, float* x,
                                     int* iters, float* work, unsigned* sync, int batch, int h,
                                     int w, int cluster, int band, float tol2, int max_iter,
                                     void* stream) {
    if (batch < 1 || !plan_ok(h, w, cluster, band) || (batch > 1) != (sync != nullptr) ||
        ((precon || !onchip) && work == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch(precon, onchip, b, x0, fluid, face_u, face_v, vy, vx, invd, x,
                                     iters, work, sync, batch, h, w, cluster, band, tol2, max_iter,
                                     stream, static_cast<int*>(nullptr)));
}

// The clusters of `cluster` blocks (band rows each, the shared memory of an
// h x w element, the variant onchip) that can be resident at once on the current device
// (cudaOccupancyMaxActiveClusters), into *most; kernels/cg.py
// CLUSTER_RESIDENT holds them for an H100 SXM.
extern "C" int silt_cg_cluster_resident(int precon, int onchip, int h, int w, int cluster,
                                        int band, int* most) {
    if (h < 1 || w < 1 || cluster < 1 || cluster > kMaxClusterWide || band < 16 || band % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch(precon, onchip, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     2, h, w, cluster, band, 0.0f, 0, nullptr, most));
}

// The dynamic shared memory of a block in bytes (`Layout`), which
// kernels/cg.py `cluster_smem_bytes` mirrors.
extern "C" int silt_cg_cluster_smem(int precon, int onchip, int h, int w, int band) {
    return 4 * layout(precon != 0, onchip != 0, band, h, w).floats;
}
