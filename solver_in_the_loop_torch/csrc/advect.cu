// Semi-Lagrangian tap-sum, forward: hand-written Hopper (sm_90a) kernel.
//
// Replaces the TPU kernel solver_in_the_loop_tpu/ops/pallas/advect_kernel.py
// `_fwd_kernel` (reached through `_tap_sum_fwd_impl`):
//
//   out[b,j,i] = sum_{sy,sx in [-m, m+1]} wy(sy) * wx(sx) * V[b, j+sy, i+sx]
//   wy(s) = max(0, 1 - |dy[b,j,i] - s|),   wx(s) = max(0, 1 - |dx[b,j,i] - s|)
//
// V[b, j+sy, i+sx] is read with its indices clamped to the edge for OPEN
// domains (the replicate shifts of ops/interp.py) and wrapped for PERIODIC
// ones. The caller clamps the offsets first (ops/interp.py), so for OPEN
// domains every tap with a non-zero weight reads inside the field.
//
// Design. One thread computes one output cell: the TPU kernel's lane-folded
// (H, B*W) layout and its roll-and-zero-weight trick exist for the TPU's
// vector unit and are not carried over. Neighbouring threads read
// neighbouring cells, so every tap row is a coalesced load that the L1 cache
// serves to the 36 taps of the 36 neighbouring threads.
//
// What bounds it on the H100. At the karman apply shapes, (B, 64, 32) to
// (B, 65, 32), one launch moves about 32 KB per batch element (three inputs
// read, one output written) and does about 160 operations per cell: tens of
// nanoseconds of HBM time or arithmetic, far below the few microseconds a
// launch costs. The kernel is bound by launch latency; fusing the three
// launches of a solver step, or capturing the step in a CUDA graph, is what
// would move it, and is left to a later change.
//
// Numerics. The accumulation order is the JAX loop's (sy outer, sx inner,
// acc += v * (wy * wx)), and every multiply and add is rounded on its own
// (__fmul_rn / __fadd_rn, and the file is built with --fmad=false): the
// kernel equals its plain PyTorch twin (kernels/advect.py) bit for bit.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float hat(float d, int s) {
    return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(d, static_cast<float>(s)))));
}

__device__ __forceinline__ int edge_index(int k, int n, bool periodic) {
    if (periodic) {
        k %= n;
        return k < 0 ? k + n : k;
    }
    return k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
}

__global__ void tap_sum_fwd_kernel(const float* __restrict__ v,
                                   const float* __restrict__ dy,
                                   const float* __restrict__ dx,
                                   float* __restrict__ out,
                                   int batch, int h, int w, int m, bool periodic) {
    const long long n = static_cast<long long>(batch) * h * w;
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    const int i = static_cast<int>(idx % w);
    const int j = static_cast<int>((idx / w) % h);
    const long long b = idx / (static_cast<long long>(h) * w);
    const float* vb = v + b * h * w;
    const float ddy = dy[idx];
    const float ddx = dx[idx];
    float acc = 0.0f;
    for (int sy = -m; sy <= m + 1; ++sy) {
        const float wy = hat(ddy, sy);
        const float* row = vb + static_cast<long long>(edge_index(j + sy, h, periodic)) * w;
        for (int sx = -m; sx <= m + 1; ++sx) {
            const float wx = hat(ddx, sx);
            const float val = row[edge_index(i + sx, w, periodic)];
            acc = __fadd_rn(acc, __fmul_rn(val, __fmul_rn(wy, wx)));
        }
    }
    out[idx] = acc;
}

}  // namespace

// values, dy, dx, out: contiguous float32 (batch, h, w) on the device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int silt_tap_sum_fwd(const float* values, const float* dy, const float* dx,
                                float* out, int batch, int h, int w, int max_shift,
                                int periodic, void* stream) {
    const long long n = static_cast<long long>(batch) * h * w;
    if (n == 0) return 0;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    tap_sum_fwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        values, dy, dx, out, batch, h, w, max_shift, periodic != 0);
    return static_cast<int>(cudaGetLastError());
}
