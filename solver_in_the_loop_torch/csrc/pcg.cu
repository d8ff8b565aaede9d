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
// block owns one batch element. A batch of at most 8 is one thread-block
// cluster: after each iteration every block publishes its "not yet
// converged" flag in its shared memory and reads its peers' flags through
// distributed shared memory after a cluster barrier. A larger batch (the
// folded TPU kernel takes it too) is a cooperative grid: the flags go
// through global memory after a grid barrier (`batch_busy`). One block needs
// a whole SM, so the batch is at most the SM count (MAX_BATCH in
// kernels/cg.py). The iteration count is written to a device int.
//
// Design. The whole CG loop runs inside one launch, with no host round trip
// per iteration: that is the point of the TPU kernel. At 64x32 one element is
// 2,048 cells (8 KB per vector); the nine vectors (x, r, p, z, Ap, two
// preconditioner temporaries, fluid, invd), both face masks, Vy, Vx and Vx^T
// take about 115 KB of the block's dynamic shared memory, so every iteration
// runs out of shared memory. The four preconditioner products are FP32 loops
// over shared memory, ordered so that a warp reads one broadcast operand and
// 32 consecutive words of the other (Vx^T is kept for the last product).
//
// What bounds it on the H100. One iteration is about 0.85 MFLOP per element
// (the four products are 4*H*W*(H+W) = 786 kFLOP at 64x32) and every operand
// lives in shared memory, so neither HBM bytes nor FP32 peak bound it: the
// iteration is a chain of about a dozen block barriers and one cluster
// barrier, with 1,024 threads each doing a few hundred dependent
// shared-memory multiply-adds in the products. The chain of barriers and the
// latency of those loops bound it; above a batch of 8 the grid barrier takes
// the cluster barrier's place (at batch 9 no slower than batch 5 on an
// NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py). Tensor-core products (the
// TPU kernel put them on its MXU) and fewer barriers are left to a later
// change.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kMaxCluster = 8;  // the portable cluster size (MAX_CLUSTER in kernels/cg.py)

// Dynamic shared memory the kernel is allowed per device so far; the
// attribute is raised only when a launch needs more, not on every launch.
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

// Block-wide sums of two per-thread partials; every thread gets both totals,
// summed in the same order (deterministic).
__device__ inline void block_sum2(float& a, float& b, float* red) {
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // the previous call's readers are done with red
    if (lane == 0) {
        red[warp] = a;
        red[kWarps + warp] = b;
    }
    __syncthreads();
    a = 0.0f;
    b = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
        a += red[k];
        b += red[kWarps + k];
    }
}

struct Element {
    int h, w, n;
    float *x, *r, *p, *z, *ap, *t0, *t1, *fluid, *invd, *fu, *fv, *vy, *vx, *vxt;
};

// out = A(p) on one element
__device__ inline void apply_a(const Element& e, const float* p, float* out) {
    const int w = e.w, h = e.h;
    for (int k = threadIdx.x; k < e.n; k += kThreads) {
        const int j = k / w, i = k - j * w;
        const float pe = i < w - 1 ? p[k + 1] : 0.0f;
        const float pw = i > 0 ? p[k - 1] : 0.0f;
        const float pn = j < h - 1 ? p[k + w] : 0.0f;
        const float ps = j > 0 ? p[k - w] : 0.0f;
        const float me = e.fu[j * (w + 1) + i + 1];
        const float mw = e.fu[j * (w + 1) + i];
        const float mn = e.fv[(j + 1) * w + i];
        const float ms = e.fv[j * w + i];
        const float diag = me + mw + mn + ms;
        const float lap = me * pe + mw * pw + mn * pn + ms * ps - diag * p[k];
        const float fl = e.fluid[k];
        out[k] = fl * (-lap) + (1.0f - fl) * p[k];
    }
}

// z = Vy ((Vy^T r Vx) * invd) Vx^T on one element; ends with a barrier
__device__ inline void minv(const Element& e, const float* r, float* z) {
    const int h = e.h, w = e.w;
    for (int k = threadIdx.x; k < e.n; k += kThreads) {  // t0 = Vy^T r
        const int a = k / w, i = k - a * w;
        float s = 0.0f;
        for (int j = 0; j < h; ++j) s += e.vy[j * h + a] * r[j * w + i];
        e.t0[k] = s;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < e.n; k += kThreads) {  // t1 = (t0 Vx) * invd
        const int a = k / w, c = k - a * w;
        float s = 0.0f;
        for (int i = 0; i < w; ++i) s += e.t0[a * w + i] * e.vx[i * w + c];
        e.t1[k] = s * e.invd[k];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < e.n; k += kThreads) {  // t0 = Vy t1
        const int j = k / w, c = k - j * w;
        float s = 0.0f;
        for (int a = 0; a < h; ++a) s += e.vy[j * h + a] * e.t1[a * w + c];
        e.t0[k] = s;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < e.n; k += kThreads) {  // z = t0 Vx^T
        const int j = k / w, i = k - j * w;
        float s = 0.0f;
        for (int c = 0; c < w; ++c) s += e.t0[j * w + c] * e.vxt[c * w + i];
        z[k] = s;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) pcg_kernel(const float* __restrict__ b_all, const float* __restrict__ x0_all,
                           const float* __restrict__ fluid, const float* __restrict__ face_u,
                           const float* __restrict__ face_v, const float* __restrict__ vy,
                           const float* __restrict__ vx, const float* __restrict__ invd,
                           float* __restrict__ x_all, int* __restrict__ iters,
                           int* __restrict__ flags, int batch, int h, int w, float tol2,
                           int max_iter) {
    // laid out as below; its size is pcg_smem_bytes in kernels/cg.py
    extern __shared__ float smem[];
    __shared__ float red[2 * kWarps];
    __shared__ int busy[2];  // the cluster's double-buffered "not converged" flag

    const int tid = threadIdx.x;
    const int n = h * w;
    const long long off = static_cast<long long>(blockIdx.x) * n;
    const float* b = b_all + off;

    Element e;
    e.h = h;
    e.w = w;
    e.n = n;
    float* s = smem;
    e.x = s; s += n;
    e.r = s; s += n;
    e.p = s; s += n;
    e.z = s; s += n;
    e.ap = s; s += n;
    e.t0 = s; s += n;
    e.t1 = s; s += n;
    e.fluid = s; s += n;
    e.invd = s; s += n;
    e.fu = s; s += h * (w + 1);
    e.fv = s; s += (h + 1) * w;
    e.vy = s; s += h * h;
    e.vx = s; s += w * w;
    e.vxt = s;

    for (int k = tid; k < n; k += kThreads) {
        e.x[k] = x0_all[off + k];
        e.fluid[k] = fluid[k];
        e.invd[k] = invd[k];
    }
    for (int k = tid; k < h * (w + 1); k += kThreads) e.fu[k] = face_u[k];
    for (int k = tid; k < (h + 1) * w; k += kThreads) e.fv[k] = face_v[k];
    for (int k = tid; k < h * h; k += kThreads) e.vy[k] = vy[k];
    for (int k = tid; k < w * w; k += kThreads) {
        e.vx[k] = vx[k];
        const int row = k / w, col = k - row * w;
        e.vxt[col * w + row] = vx[k];
    }
    __syncthreads();

    // threshold from ||b||^2; r0 = b - A x0
    float bb = 0.0f, unused = 0.0f;
    for (int k = tid; k < n; k += kThreads) bb += b[k] * b[k];
    block_sum2(bb, unused, red);
    const float thresh = tol2 * fmaxf(bb, 1e-30f);

    apply_a(e, e.x, e.ap);
    __syncthreads();
    for (int k = tid; k < n; k += kThreads) e.r[k] = b[k] - e.ap[k];
    __syncthreads();
    minv(e, e.r, e.z);
    float rz = 0.0f, rs = 0.0f;
    for (int k = tid; k < n; k += kThreads) {
        e.p[k] = e.z[k];
        rz += e.r[k] * e.z[k];
        rs += e.r[k] * e.r[k];
    }
    block_sum2(rz, rs, red);

    int it = 0;
    int parity = 0;
    while (true) {
        // whole-batch stop test: continue while any element is above its threshold
        const bool any = batch_busy(rs > thresh, busy, parity, flags, batch);
        if (it >= max_iter || !any) break;

        apply_a(e, e.p, e.ap);
        __syncthreads();
        float pap = 0.0f;
        for (int k = tid; k < n; k += kThreads) pap += e.p[k] * e.ap[k];
        block_sum2(pap, unused, red);
        const float alpha = pap == 0.0f ? 0.0f : rz / pap;
        for (int k = tid; k < n; k += kThreads) {
            e.x[k] += alpha * e.p[k];
            e.r[k] -= alpha * e.ap[k];
        }
        __syncthreads();
        minv(e, e.r, e.z);
        float rz_new = 0.0f;
        rs = 0.0f;
        for (int k = tid; k < n; k += kThreads) {
            rz_new += e.r[k] * e.z[k];
            rs += e.r[k] * e.r[k];
        }
        block_sum2(rz_new, rs, red);
        const float beta = rz_new / (rz == 0.0f ? 1.0f : rz);
        for (int k = tid; k < n; k += kThreads) e.p[k] = e.z[k] + beta * e.p[k];
        __syncthreads();
        rz = rz_new;
        ++it;
    }

    for (int k = tid; k < n; k += kThreads) x_all[off + k] = e.x[k];
    if (blockIdx.x == 0 && tid == 0) *iters = it;
    // no block of a cluster leaves while a peer may still read its flags
    if (flags == nullptr) cg::this_cluster().sync();
}

}  // namespace

// b, x0, x: (batch, h, w); fluid: (h, w); face_u: (h, w+1); face_v: (h+1, w);
// vy: (h, h); vx: (w, w); invd: (h, w); iters: one int; flags: 2 x batch
// ints of scratch, used (and required) only for a batch above kMaxCluster.
// All contiguous, on the current device. smem_bytes is the dynamic shared memory of one block
// (pcg_smem_bytes in kernels/cg.py). Returns the cudaError_t of the launch
// (0 on success).
extern "C" int silt_pcg_solve(const float* b, const float* x0, const float* fluid,
                              const float* face_u, const float* face_v, const float* vy,
                              const float* vx, const float* invd, float* x, int* iters,
                              int* flags, int batch, int h, int w, float tol2, int max_iter,
                              int smem_bytes, void* stream) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (smem_bytes > g_smem_allowed[dev]) {
        err = cudaFuncSetAttribute(pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
    err = cudaLaunchKernelEx(&cfg, pcg_kernel, b, x0, fluid, face_u, face_v, vy, vx, invd, x,
                             iters, one_cluster ? nullptr : flags, batch, h, w, tol2, max_iter);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
