// The loop skeleton that csrc/pcg.cu and csrc/cg.cu share: the whole-batch
// stop test, the block reductions, the operator on one cell, the halo layout
// of p in shared memory, and the launch as one cluster or a cooperative grid.
// csrc/cg_cluster.cu takes the block reductions, the operator and
// `allow_smem` from here.
//
// pcg.cu and cg.cu run one batch element per thread block and the standard
// (P)CG recurrence of the TPU kernels (solver_in_the_loop_tpu/ops/pallas/
// cg_kernel.py), all iterations in one launch. Per iteration each needs its
// dot products summed over the block and the whole batch's stop flag; the
// helpers here do each with as few barriers and serial steps as they can.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace silt {

namespace cgr = cooperative_groups;

constexpr int kMaxDevices = 64;
constexpr int kMaxCluster = 8;  // the portable cluster size (MAX_CLUSTER in kernels/cg.py)

// Whether any element of the batch is still above its threshold, given this
// block's own answer `mine`. A batch of at most kMaxCluster elements is one
// cluster (flags == nullptr): each block publishes its answer in `busy` and,
// after a cluster barrier, every warp reads its peers' answers through
// distributed shared memory, one peer per lane, all at once. A larger batch
// is a cooperative grid of one block per element: each block writes its
// answer to its slot of `flags` in global memory (2 x batch ints, one row
// per parity) and reads every slot after a grid barrier, each lane of each
// warp a few of them. Either barrier also orders the block's own shared
// memory. Both rows alternate, so no block overwrites an answer a peer may
// still read.
__device__ inline bool batch_busy(bool mine, int* busy, int& parity, int* flags, int batch) {
    const int lane = threadIdx.x & 31;
    int any = 0;
    if (flags == nullptr) {
        cgr::cluster_group cluster = cgr::this_cluster();
        if (threadIdx.x == 0) busy[parity] = mine ? 1 : 0;
        cluster.sync();
        if (lane < static_cast<int>(cluster.num_blocks()))
            any = *cluster.map_shared_rank(&busy[parity], lane);
    } else {
        const int* row = flags + parity * batch;
        if (threadIdx.x == 0) __stcg(flags + parity * batch + blockIdx.x, mine ? 1 : 0);
        cgr::this_grid().sync();
        for (int k = lane; k < batch; k += 32) any |= __ldcg(row + k);
    }
    parity ^= 1;
    return __any_sync(0xffffffffu, any) != 0;
}

// Block-wide sums of N per-thread partials (float or double), left in every
// thread. Each warp
// reduces its 32 partials with a shuffle tree; lane 0 writes the warp's sums
// to red (N x 32 floats) and, after one barrier, every warp reads the warps'
// sums one per lane (lanes beyond the warp count, rounded up to a power of
// two, repeat them) and reduces them with a second shuffle tree. Every warp
// adds the same numbers in the same order, and a butterfly leaves the same
// bits in every lane, so every thread gets the same totals on every launch.
// The caller guarantees that nobody still reads `red` from its previous use
// (each kernel alternates two scratch buffers).
template <int N, class T>
__device__ __forceinline__ void block_sum(T (&v)[N], T* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) red[32 * i + warp] = v[i];
    }
    __syncthreads();
    int span = 1;
    while (span < warps) span <<= 1;
    const int src = lane & (span - 1);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = src < warps ? red[32 * i + src] : T(0);
    for (int o = span >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
}

// p in shared memory with a ring of zeros: cell (j, i) at
// halo_index(j, i, stride), stride >= w + 1, so that the neighbours outside
// the domain (the Dirichlet-0 ghosts) are zeros of the ring and the operator
// reads them without a test: column -1 (and column w, which is the next
// row's column -1 when stride == w + 1), rows -1 and h. It takes
// (h + 2) * stride floats.
__host__ __device__ inline int halo_index(int j, int i, int stride) {
    return (j + 1) * stride + i + 1;
}

// Fills the halo layout (h + 2 rows of `stride`) with the (h, w) field `src`
// and zeros elsewhere; one pass, so no thread zeroes a word another writes.
// Unrolled, so that each thread has several loads in flight at once.
__device__ inline void stage_halo(float* dst, const float* __restrict__ src, int h, int w,
                                  int stride) {
#pragma unroll 4
    for (int k = threadIdx.x; k < (h + 2) * stride; k += blockDim.x) {
        const int j = k / stride - 1;
        const int i = k - (j + 1) * stride - 1;
        dst[k] = j >= 0 && j < h && i >= 0 && i < w ? src[j * w + i] : 0.0f;
    }
}

// The operator's coefficients on one cell, read once: the face masks
// me = face_u[j,i+1], mw = face_u[j,i], mn = face_v[j+1,i], ms = face_v[j,i],
// diag = me + mw + mn + ms, and the fluid indicator.
struct Cell {
    float me, mw, mn, ms, diag, fl;
};

__device__ inline Cell load_cell(const float* fluid, const float* face_u, const float* face_v,
                                 int j, int i, int w) {
    Cell c;
    c.me = face_u[j * (w + 1) + i + 1];
    c.mw = face_u[j * (w + 1) + i];
    c.mn = face_v[(j + 1) * w + i];
    c.ms = face_v[j * w + i];
    c.diag = c.me + c.mw + c.mn + c.ms;
    c.fl = fluid[j * w + i];
    return c;
}

// (A p) on one cell from p there and its four neighbours (Dirichlet-0
// ghosts outside the domain):
//   A(p) = fluid * -(me*E + mw*W + mn*N + ms*S - diag*p) + (1 - fluid) * p
// the expression of cg_kernel.py:296-300.
__device__ __forceinline__ float apply_cell(const Cell& c, float p, float pe, float pw, float pn,
                                            float ps) {
    const float lap = c.me * pe + c.mw * pw + c.mn * pn + c.ms * ps - c.diag * p;
    return c.fl * (-lap) + (1.0f - c.fl) * p;
}

// Raises a kernel's dynamic shared memory limit when a launch needs more than
// it was allowed so far on the current device (allowed: one int per device).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (bytes <= allowed[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) allowed[dev] = bytes;
    return err;
}

// Launches `kernel` with one block of `threads` per batch element: a batch of
// at most kMaxCluster is one cluster; a larger one a cooperative grid (the
// launch fails if its blocks cannot all be resident at once), which needs
// `flags`. The kernel's arguments follow; the caller passes flags in them
// only for a grid (nullptr for a cluster, as `batch_busy` expects).
template <class... Params, class... Args>
cudaError_t launch_batch(void (*kernel)(Params...), int* allowed, int batch, int threads,
                         int smem_bytes, void* stream, Args... args) {
    cudaError_t err = allow_smem(kernel, smem_bytes, allowed);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    if (batch <= kMaxCluster) {
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
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace silt
