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
// whole batch stops together: one thread block per batch element. A batch
// of at most 8 is one thread-block cluster, and after each iteration every
// block publishes its "not yet converged" flag in its shared memory and reads
// its peers' through distributed shared memory after a cluster barrier; a
// larger batch is a cooperative grid of at most one block per SM, whose
// flags go through global memory after a grid barrier (`batch_busy`). At
// batch 1 this is the per-element `_cg_kernel`.
//
// Design. Without a preconditioner an iteration is one stencil, two dot
// products and three vector updates, about 26 operations per cell: at 64x32
// an element is 2,048 cells, 53 kFLOP per iteration, so neither HBM bytes
// nor FP32 peak bound it. What bounds it is the chain of barriers of each
// iteration times its ~110 cold iterations (about 4x the PCG's), so the
// kernel keeps that chain at three: the block reduction of p.Ap, that of
// r.r, and the cluster (or grid) barrier of the stop test, which also
// publishes the new p. Each of the 1,024 threads owns up to 8 cells (k = tid + 1024 i) and
// keeps their x, r, p and A p in registers; only p, which the stencil reads
// across threads, and the masks live in shared memory (p and fluid 8 KB
// each, both face masks 16.4 KB at 64x32). The two reductions use separate
// scratch, so no barrier guards their reuse.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 8;  // per thread: CG_MAX_CELLS / 1024 in kernels/cg.py
constexpr int kMaxDevices = 64;
constexpr int kMaxCluster = 8;  // the portable cluster size (MAX_CLUSTER in kernels/cg.py)

int g_smem_allowed[kMaxDevices] = {};

// Whether any element of the batch is still above its threshold, given this
// block's own answer `mine`. A batch of at most kMaxCluster elements is one
// cluster (flags == nullptr): each block publishes its answer in `busy` and
// reads its peers' through distributed shared memory after a cluster barrier.
// A larger batch is a cooperative grid of one block per element: each block
// writes its answer to its slot of `flags` in global memory (2 x batch ints,
// one row per parity) and reads every slot after a grid barrier, each lane
// of each warp a few of them. Either barrier also orders the block's own
// shared memory. Both rows alternate, so no block overwrites an answer a
// peer may still read.
__device__ inline bool batch_busy(bool mine, int* busy, int& parity, int* flags, int batch) {
    int any = 0;
    if (flags == nullptr) {
        cg::cluster_group cluster = cg::this_cluster();
        if (threadIdx.x == 0) busy[parity] = mine ? 1 : 0;
        cluster.sync();
        for (unsigned rank = 0; rank < cluster.num_blocks(); ++rank)
            any |= *cluster.map_shared_rank(&busy[parity], rank);
    } else {
        int* row = flags + parity * batch;
        if (threadIdx.x == 0) __stcg(row + blockIdx.x, mine ? 1 : 0);
        cg::this_grid().sync();
        for (int k = threadIdx.x & 31; k < batch; k += 32) any |= __ldcg(row + k);
        any = __any_sync(0xffffffffu, any);
    }
    parity ^= 1;
    return any != 0;
}

// Block-wide sum of a per-thread partial into `red` (kWarps floats); every
// thread gets the total, summed in the same order (deterministic). One
// barrier: the caller guarantees nobody still reads `red` from its last use.
__device__ inline float block_sum(float a, float* red) {
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
    __syncthreads();
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += red[k];
    return s;
}

// (A p)[k] from p in shared memory
__device__ inline float apply_a(const float* p, const float* fluid, const float* fu,
                                const float* fv, int k, int h, int w) {
    const int j = k / w, i = k - j * w;
    const float pe = i < w - 1 ? p[k + 1] : 0.0f;
    const float pw = i > 0 ? p[k - 1] : 0.0f;
    const float pn = j < h - 1 ? p[k + w] : 0.0f;
    const float ps = j > 0 ? p[k - w] : 0.0f;
    const float me = fu[j * (w + 1) + i + 1];
    const float mw = fu[j * (w + 1) + i];
    const float mn = fv[(j + 1) * w + i];
    const float ms = fv[j * w + i];
    const float diag = me + mw + mn + ms;
    const float lap = me * pe + mw * pw + mn * pn + ms * ps - diag * p[k];
    const float fl = fluid[k];
    return fl * (-lap) + (1.0f - fl) * p[k];
}

__global__ void __launch_bounds__(kThreads, 1) cg_kernel(const float* __restrict__ b_all,
                                                        const float* __restrict__ x0_all,
                                                        const float* __restrict__ fluid_g,
                                                        const float* __restrict__ face_u,
                                                        const float* __restrict__ face_v,
                                                        float* __restrict__ x_all,
                                                        int* __restrict__ iters,
                                                        int* __restrict__ flags, int batch,
                                                        int h, int w,
                                                        float tol2, int max_iter) {
    // p, fluid, face_u, face_v; its size is cg_smem_bytes in kernels/cg.py
    extern __shared__ float smem[];
    __shared__ float red_a[2 * kWarps];
    __shared__ float red_b[kWarps];
    __shared__ int busy[2];  // the cluster's double-buffered "not converged" flag

    const int tid = threadIdx.x;
    const int n = h * w;
    const long long off = static_cast<long long>(blockIdx.x) * n;
    float* ps = smem;
    float* fluid = ps + n;
    float* fu = fluid + n;
    float* fv = fu + h * (w + 1);

    float x[kCells], r[kCells], p[kCells], ap[kCells];
    for (int k = tid; k < n; k += kThreads) {
        fluid[k] = fluid_g[k];
        ps[k] = x0_all[off + k];  // A x0 reads x0's neighbours
    }
    for (int k = tid; k < h * (w + 1); k += kThreads) fu[k] = face_u[k];
    for (int k = tid; k < (h + 1) * w; k += kThreads) fv[k] = face_v[k];
    __syncthreads();

    // r0 = b - A x0; threshold from ||b||^2
    float bb = 0.0f, rs_part = 0.0f;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
        const int k = tid + c * kThreads;
        if (k < n) {
            const float bk = b_all[off + k];
            x[c] = ps[k];
            r[c] = bk - apply_a(ps, fluid, fu, fv, k, h, w);
            bb += bk * bk;
            rs_part += r[c] * r[c];
        }
    }
    // both sums in one pass over red_a; its barrier also ends every read of x0
    for (int o = 16; o > 0; o >>= 1) {
        bb += __shfl_xor_sync(0xffffffffu, bb, o);
        rs_part += __shfl_xor_sync(0xffffffffu, rs_part, o);
    }
    if ((tid & 31) == 0) {
        red_a[tid >> 5] = bb;
        red_a[kWarps + (tid >> 5)] = rs_part;
    }
    __syncthreads();
    bb = 0.0f;
    float rs = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
        bb += red_a[k];
        rs += red_a[kWarps + k];
    }
    const float thresh = tol2 * fmaxf(bb, 1e-30f);
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
        const int k = tid + c * kThreads;
        if (k < n) {
            p[c] = r[c];
            ps[k] = r[c];
        }
    }

    int it = 0;
    int parity = 0;
    while (true) {
        // whole-batch stop test; its barrier also makes the new p visible
        const bool any = batch_busy(rs > thresh, busy, parity, flags, batch);
        if (it >= max_iter || !any) break;

        float pap = 0.0f;
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
            const int k = tid + c * kThreads;
            if (k < n) {
                ap[c] = apply_a(ps, fluid, fu, fv, k, h, w);
                pap += p[c] * ap[c];
            }
        }
        pap = block_sum(pap, red_a);
        const float alpha = pap == 0.0f ? 0.0f : rs / pap;
        float rs_new = 0.0f;
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
            if (tid + c * kThreads < n) {
                x[c] += alpha * p[c];
                r[c] -= alpha * ap[c];
                rs_new += r[c] * r[c];
            }
        }
        // every read of p in shared memory is done: the barrier of the p.Ap sum
        rs_new = block_sum(rs_new, red_b);
        const float beta = rs_new / (rs == 0.0f ? 1.0f : rs);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
            const int k = tid + c * kThreads;
            if (k < n) {
                p[c] = r[c] + beta * p[c];
                ps[k] = p[c];
            }
        }
        rs = rs_new;
        ++it;
    }

#pragma unroll
    for (int c = 0; c < kCells; ++c) {
        const int k = tid + c * kThreads;
        if (k < n) x_all[off + k] = x[c];
    }
    if (blockIdx.x == 0 && tid == 0) *iters = it;
    // no block of a cluster leaves while a peer may still read its flags
    if (flags == nullptr) cg::this_cluster().sync();
}

}  // namespace

// b, x0, x: (batch, h, w); fluid: (h, w); face_u: (h, w+1); face_v: (h+1, w);
// iters: one int; flags: 2 x batch ints of scratch, used (and required)
// only for a batch above kMaxCluster. All contiguous, on the current
// device. smem_bytes is the
// dynamic shared memory of one block (cg_smem_bytes in kernels/cg.py).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int silt_cg_solve(const float* b, const float* x0, const float* fluid,
                             const float* face_u, const float* face_v, float* x, int* iters,
                             int* flags, int batch, int h, int w, float tol2, int max_iter,
                             int smem_bytes, void* stream) {
    if (h * w > kThreads * kCells) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (smem_bytes > g_smem_allowed[dev]) {
        err = cudaFuncSetAttribute(cg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        g_smem_allowed[dev] = smem_bytes;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cfg.stream = static_cast<cudaStream_t>(stream);
    // one cluster for a batch of at most kMaxCluster, else a cooperative
    // grid (the launch fails if the blocks cannot all be resident at once)
    const bool one_cluster = batch <= kMaxCluster;
    if (!one_cluster && flags == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr[1];
    if (one_cluster) {
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = batch;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
    } else {
        attr[0].id = cudaLaunchAttributeCooperative;
        attr[0].val.cooperative = 1;
    }
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, cg_kernel, b, x0, fluid, face_u, face_v, x, iters,
                             one_cluster ? nullptr : flags, batch, h, w, tol2, max_iter);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
