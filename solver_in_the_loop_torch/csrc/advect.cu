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
// Design. One thread per cell computes all three cotangents of that cell.
// dV is a gather, not the TPU kernel's transposed rolls or a scatter: no
// atomics, so it is deterministic. For OPEN domains an edge cell gathers from
// every destination whose clamped index lands on it; those extra taps carry a
// weight of exactly 0 (the caller clamps the sample position into the field),
// so they change no finite sum. The order of every sum is the plain twin's
// (kernels/advect.py: taps sy outer, sx inner; per tap rows then columns, in
// index order), rounded on its own as in the forward: the kernel equals the
// twin bit for bit.
//
// What bounds it on the H100. One launch reads four (B, H, W) arrays and
// writes three, 28 bytes per cell, and does about three times the forward's
// operations; at the training shapes (3, 64, 32) that is 172 KB and ~1.7
// MFLOP, tens of nanoseconds at the card's peaks. Like the forward it is
// bound by launch latency and by the dependent chain of 36 taps per thread.

__device__ __forceinline__ float hat_slope(float d, int s) {
    const float t = __fsub_rn(d, static_cast<float>(s));
    const float a = fabsf(t);
    const float neg_sign = t >= 0.0f ? -1.0f : 1.0f;
    return __fmul_rn(neg_sign, a < 1.0f ? 1.0f : (a == 1.0f ? 0.5f : 0.0f));
}

// First and last destination row (or column) k' in [0, n) whose tap s reads
// k: clamp(k' + s) == k for OPEN, (k' + s) mod n == k for PERIODIC. Returns
// false if there is none.
__device__ __forceinline__ bool readers(int k, int s, int n, bool periodic, int* lo, int* hi) {
    if (periodic) {
        *lo = *hi = edge_index(k - s, n, true);
        return true;
    }
    int a = k == 0 ? 0 : k - s;
    int b = k == n - 1 ? n - 1 : k - s;
    a = a < 0 ? 0 : a;
    b = b > n - 1 ? n - 1 : b;
    *lo = a;
    *hi = b;
    return a <= b;
}

__global__ void tap_sum_bwd_kernel(const float* __restrict__ v,
                                   const float* __restrict__ dy,
                                   const float* __restrict__ dx,
                                   const float* __restrict__ g,
                                   float* __restrict__ dv,
                                   float* __restrict__ ddy,
                                   float* __restrict__ ddx,
                                   int batch, int h, int w, int m, bool periodic) {
    const long long n = static_cast<long long>(batch) * h * w;
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    const int i = static_cast<int>(idx % w);
    const int j = static_cast<int>((idx / w) % h);
    const long long base = (idx / (static_cast<long long>(h) * w)) * h * w;
    const float* vb = v + base;
    const float* dyb = dy + base;
    const float* dxb = dx + base;
    const float* gb = g + base;

    // ddy, ddx at (j, i)
    const float gc = g[idx];
    const float dyc = dy[idx];
    const float dxc = dx[idx];
    float acc_y = 0.0f;
    float acc_x = 0.0f;
    for (int sy = -m; sy <= m + 1; ++sy) {
        const float wy = hat(dyc, sy);
        const float dwy = hat_slope(dyc, sy);
        const float* row = vb + static_cast<long long>(edge_index(j + sy, h, periodic)) * w;
        for (int sx = -m; sx <= m + 1; ++sx) {
            const float wx = hat(dxc, sx);
            const float dwx = hat_slope(dxc, sx);
            const float gv = __fmul_rn(gc, row[edge_index(i + sx, w, periodic)]);
            acc_y = __fadd_rn(acc_y, __fmul_rn(gv, __fmul_rn(dwy, wx)));
            acc_x = __fadd_rn(acc_x, __fmul_rn(gv, __fmul_rn(wy, dwx)));
        }
    }
    ddy[idx] = acc_y;
    ddx[idx] = acc_x;

    // dV at (j, i): gather from the destinations that read it
    float acc_v = 0.0f;
    for (int sy = -m; sy <= m + 1; ++sy) {
        int r0, r1;
        const bool any_row = readers(j, sy, h, periodic, &r0, &r1);
        for (int sx = -m; sx <= m + 1; ++sx) {
            int c0, c1;
            float tap = 0.0f;
            if (any_row && readers(i, sx, w, periodic, &c0, &c1)) {
                for (int c = c0; c <= c1; ++c) {
                    float col = 0.0f;
                    for (int r = r0; r <= r1; ++r) {
                        const long long k = static_cast<long long>(r) * w + c;
                        const float wgt = __fmul_rn(hat(dyb[k], sy), hat(dxb[k], sx));
                        col = __fadd_rn(col, __fmul_rn(gb[k], wgt));
                    }
                    tap = __fadd_rn(tap, col);
                }
            }
            acc_v = __fadd_rn(acc_v, tap);
        }
    }
    dv[idx] = acc_v;
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

// values, dy, dx, g (inputs) and dv, ddy, ddx (outputs): contiguous float32
// (batch, h, w) on the device. Returns the cudaError_t of the launch.
extern "C" int silt_tap_sum_bwd(const float* values, const float* dy, const float* dx,
                                const float* g, float* dv, float* ddy, float* ddx,
                                int batch, int h, int w, int max_shift, int periodic,
                                void* stream) {
    const long long n = static_cast<long long>(batch) * h * w;
    if (n == 0) return 0;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    tap_sum_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        values, dy, dx, g, dv, ddy, ddx, batch, h, w, max_shift, periodic != 0);
    return static_cast<int>(cudaGetLastError());
}
