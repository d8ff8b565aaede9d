// Fused KxK SAME stride-1 convolution, NHWC, float32: hand-written Hopper
// (sm_90a) kernels for the forward (also the input gradient) and the weight
// gradient.
//
// `conv_fwd` replaces the TPU kernels
// solver_in_the_loop_tpu/ops/pallas/conv_kernel.py `_fwd_kernel` and
// `_fwd_kernel_taps` (reached through `_conv_rows`):
//
//   y[b,y,x,o] = act( bias[o] + skip[b,y,x,o]
//                     + sum_{ky,kx,c} x[b, y+ky-r, x+kx-r, c] * w(ky, kx, c, o) )
//
// with r = K/2 and a tap outside the image reading 0 (SAME zero padding; the
// batch index is explicit, so no tap reads across images, which the TPU
// kernel's y mask ensures). act is none, ReLU or LeakyReLU(slope), applied
// after the bias and the skip, as `_epilogue` does. The weight is read
// through four element strides (ky, kx, c, o) and an optional flip of both
// spatial axes, so one kernel takes PyTorch's (Cout, Cin, K, K) parameter in
// place and also the input gradient's flipped, channel-transposed kernel
// without a copy: dX = conv_fwd(dZ, flip(w) with c and o swapped), zero bias,
// no activation, as `_conv_same_bwd` computes it.
//
// `conv_wgrad` replaces `_wgrad_kernel` and `_wgrad_kernel_taps` (reached
// through `_conv_wgrad`):
//
//   dw(ky, kx, c, o) = sum_{b,y,x} x[b, y+ky-r, x+kx-r, c] * dz[b,y,x,o]
//
// written through four element strides, so the caller gets PyTorch's weight
// layout directly.
//
// Design. Forward: a block owns a tile of output pixels of one image and a
// tile of CT output channels. It loops over the input channels in chunks of
// 8: it stages the chunk's input patch (the tile plus its K-1 halo, zeros
// outside the image) and the chunk's K*K*8*CT weights in shared memory, then
// each thread accumulates 2 pixels x 4 output channels over the chunk's taps
// and channels in registers (one float4 weight load and two input loads per
// 8 multiply-adds). Chunking the input channels bounds the shared memory by
// K, not by the channel counts: at K=5 a block holds 30 KB for CT=32 (the
// whole 32->32 weight would be 102 KB, 64->64 410 KB, above the 227 KB a
// block can have); the 7x7 kernels the JAX gate admits take 56 KB, so the
// launch raises the block's dynamic shared memory limit when it is above 48
// KB. Two tile shapes: CT=32 over 8x8 pixels for the hidden convs, and CT=4
// over 16x32 pixels for the 2-channel head, which would leave 7/8 of the
// threads idle in the other.
// Weight gradient: each block owns one tap, 8 input channels and 32 output
// channels (256 outputs) and loops over all M = B*H*W rows in chunks of 128,
// staged in shared memory; its 256 threads are 4 row groups of 64 threads,
// each thread summing 4 outputs over every fourth row of a chunk. The four
// row groups' partial sums are added in a fixed order at the end: no
// atomics, so the result is the same on every run. The TPU kernel carries
// its sum across sequential grid steps; the block's row loop takes that role.
//
// What bounds it on the H100. The MarsMoon 32->32 conv at the Burgers
// training shape (5, 32, 32) is 2*M*K*K*Cin*Cout = 262 MFLOP over 1.4 MB:
// 3.9 us of fp32 work at 67 TFLOP/s against 0.4 us of HBM time, so it is
// bound by operations; the stem (4->32) and the head (32->2) are 8-16x
// smaller. These kernels run on the CUDA cores in fp32, one multiply-add per
// instruction, with 80 blocks (forward) or 100 blocks (weight gradient) for
// 132 SMs at that shape; the weight gradient also reads dz once per block
// (from L2). A faster design (tensor-core TF32 or 3xTF32 products, more
// blocks per conv, dz shared across the taps) is left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CI_CHUNK = 8;
constexpr int SMEM_STATIC_LIMIT = 48 * 1024;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

struct Weight {  // element (ky, kx, c, o) of a (K, K, Cin, Cout) weight
    const float* p;
    long long s_ky, s_kx, s_c, s_o;
    int flip;  // read (K-1-ky, K-1-kx)
};

template <int CT, int TW>
struct FwdTile {
    static constexpr int CG = CT / 4;         // groups of 4 output channels
    static constexpr int PG = THREADS / CG;   // groups of 2 vertically adjacent pixels
    static constexpr int TH = 2 * PG / TW;    // tile height
};

template <int CT, int TW>
int fwd_smem_bytes(int k) {
    using T = FwdTile<CT, TW>;
    return 4 * CI_CHUNK * ((T::TH + k - 1) * (TW + k - 1) + k * k * CT);
}

template <int CT, int TW>
__global__ void __launch_bounds__(THREADS)
conv_fwd_kernel(const float* __restrict__ x, Weight w, const float* __restrict__ bias,
                const float* __restrict__ skip, float* __restrict__ y, int h, int wd,
                int cin, int cout, int k, int act, float slope) {
    using T = FwdTile<CT, TW>;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int ph = T::TH + k - 1;
    const int pw = TW + k - 1;
    const int patch = ph * pw;
    float* xs = smem;                      // [CI_CHUNK][ph][pw]
    float* ws = smem + CI_CHUNK * patch;   // [k*k][CI_CHUNK][CT]; offset a multiple of 8

    const int tiles_x = (wd + TW - 1) / TW;
    const int tiles_y = (h + T::TH - 1) / T::TH;
    const int tx = blockIdx.x % tiles_x;
    const int ty = (blockIdx.x / tiles_x) % tiles_y;
    const long long b = blockIdx.x / (tiles_x * tiles_y);
    const int y0 = ty * T::TH;
    const int x0 = tx * TW;
    const int co0 = blockIdx.y * CT;
    const int r = k / 2;
    const int t = threadIdx.x;
    const int cg = t % T::CG;
    const int pg = t / T::CG;
    const int px = pg % TW;
    const int py = (pg / TW) * 2;
    const float* xb = x + b * h * wd * cin;

    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int c0 = 0; c0 < cin; c0 += CI_CHUNK) {
        // input patch, channel fastest in the global reads
        for (int i = t; i < CI_CHUNK * patch; i += THREADS) {
            const int c = i % CI_CHUNK;
            const int pos = i / CI_CHUNK;
            const int gy = y0 + pos / pw - r;
            const int gx = x0 + pos % pw - r;
            float v = 0.f;
            if (c0 + c < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd)
                v = xb[(static_cast<long long>(gy) * wd + gx) * cin + c0 + c];
            xs[c * patch + pos] = v;
        }
        // weights of this chunk and output tile, output channel fastest
        for (int i = t; i < k * k * CI_CHUNK * CT; i += THREADS) {
            const int o = i % CT;
            const int c = (i / CT) % CI_CHUNK;
            const int tap = i / (CT * CI_CHUNK);
            int ky = tap / k;
            int kx = tap % k;
            if (w.flip) {
                ky = k - 1 - ky;
                kx = k - 1 - kx;
            }
            float v = 0.f;
            if (c0 + c < cin && co0 + o < cout)
                v = w.p[ky * w.s_ky + kx * w.s_kx + (c0 + c) * w.s_c + (co0 + o) * w.s_o];
            ws[i] = v;
        }
        __syncthreads();
        for (int ky = 0; ky < k; ++ky) {
            for (int kx = 0; kx < k; ++kx) {
                const float* wrow = ws + (ky * k + kx) * CI_CHUNK * CT + cg * 4;
                const float* xrow = xs + (py + ky) * pw + px + kx;
#pragma unroll
                for (int c = 0; c < CI_CHUNK; ++c) {
                    const float4 wv = *reinterpret_cast<const float4*>(wrow + c * CT);
                    const float xa = xrow[c * patch];
                    const float xc = xrow[c * patch + pw];
                    acc[0][0] = fmaf(xa, wv.x, acc[0][0]);
                    acc[0][1] = fmaf(xa, wv.y, acc[0][1]);
                    acc[0][2] = fmaf(xa, wv.z, acc[0][2]);
                    acc[0][3] = fmaf(xa, wv.w, acc[0][3]);
                    acc[1][0] = fmaf(xc, wv.x, acc[1][0]);
                    acc[1][1] = fmaf(xc, wv.y, acc[1][1]);
                    acc[1][2] = fmaf(xc, wv.z, acc[1][2]);
                    acc[1][3] = fmaf(xc, wv.w, acc[1][3]);
                }
            }
        }
        __syncthreads();
    }

    // epilogue: + bias, + skip, activation (conv_kernel.py `_epilogue`)
    for (int i = 0; i < 2; ++i) {
        const int gy = y0 + py + i;
        const int gx = x0 + px;
        if (gy >= h || gx >= wd) continue;
        const long long row = ((b * h + gy) * wd + gx) * cout;
        for (int j = 0; j < 4; ++j) {
            const int o = co0 + cg * 4 + j;
            if (o >= cout) continue;
            float v = acc[i][j];
            if (bias != nullptr) v += bias[o];
            if (skip != nullptr) v += skip[row + o];
            if (act == ACT_RELU) v = fmaxf(v, 0.f);
            else if (act == ACT_LEAKY) v = v >= 0.f ? v : slope * v;
            y[row + o] = v;
        }
    }
}

template <int CT, int TW>
int launch_fwd(const float* x, Weight w, const float* bias, const float* skip, float* y,
               int batch, int h, int wd, int cin, int cout, int k, int act, float slope,
               cudaStream_t stream) {
    using T = FwdTile<CT, TW>;
    const int smem = fwd_smem_bytes<CT, TW>(k);
    if (smem > SMEM_STATIC_LIMIT) {
        const cudaError_t err = cudaFuncSetAttribute(
            conv_fwd_kernel<CT, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int tiles = ((h + T::TH - 1) / T::TH) * ((wd + TW - 1) / TW);
    const dim3 grid(static_cast<unsigned>(batch * tiles), static_cast<unsigned>((cout + CT - 1) / CT));
    conv_fwd_kernel<CT, TW><<<grid, THREADS, smem, stream>>>(x, w, bias, skip, y, h, wd, cin,
                                                             cout, k, act, slope);
    return static_cast<int>(cudaGetLastError());
}

constexpr int WG_CIT = 8;    // input channels per block
constexpr int WG_COT = 32;   // output channels per block
constexpr int WG_ROWS = 128; // rows staged per chunk
constexpr int WG_GROUPS = THREADS / (WG_CIT * WG_COT / 4);  // 4 row groups

__global__ void __launch_bounds__(THREADS)
conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dz, float* __restrict__ dw,
                  long long s_ky, long long s_kx, long long s_c, long long s_o, int batch, int h,
                  int wd, int cin, int cout, int k) {
    __shared__ float xs[WG_ROWS][WG_CIT];
    __shared__ __align__(16) float ds[WG_ROWS][WG_COT];
    const int tap = blockIdx.x;
    const int ky = tap / k;
    const int kx = tap % k;
    const int dy = ky - k / 2;
    const int dx = kx - k / 2;
    const int ci0 = blockIdx.y * WG_CIT;
    const int co0 = blockIdx.z * WG_COT;
    const int t = threadIdx.x;
    const int og = t % (WG_CIT * WG_COT / 4);
    const int rg = t / (WG_CIT * WG_COT / 4);
    const int ci = og / (WG_COT / 4);
    const int co4 = (og % (WG_COT / 4)) * 4;
    const long long rows = static_cast<long long>(batch) * h * wd;

    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long m0 = 0; m0 < rows; m0 += WG_ROWS) {
        for (int i = t; i < WG_ROWS * WG_CIT; i += THREADS) {
            const int rr = i / WG_CIT;
            const int c = i % WG_CIT;
            const long long m = m0 + rr;
            float v = 0.f;
            if (m < rows && ci0 + c < cin) {
                const int xx = static_cast<int>(m % wd) + dx;
                const int yy = static_cast<int>((m / wd) % h) + dy;
                if (yy >= 0 && yy < h && xx >= 0 && xx < wd)
                    v = x[(m + static_cast<long long>(dy) * wd + dx) * cin + ci0 + c];
            }
            xs[rr][c] = v;
        }
        for (int i = t; i < WG_ROWS * WG_COT; i += THREADS) {
            const int rr = i / WG_COT;
            const int o = i % WG_COT;
            const long long m = m0 + rr;
            ds[rr][o] = (m < rows && co0 + o < cout) ? dz[m * cout + co0 + o] : 0.f;
        }
        __syncthreads();
        for (int rr = rg; rr < WG_ROWS; rr += WG_GROUPS) {
            const float a = xs[rr][ci];
            const float4 d = *reinterpret_cast<const float4*>(&ds[rr][co4]);
            acc.x = fmaf(a, d.x, acc.x);
            acc.y = fmaf(a, d.y, acc.y);
            acc.z = fmaf(a, d.z, acc.z);
            acc.w = fmaf(a, d.w, acc.w);
        }
        __syncthreads();
    }

    // the row groups' partial sums, added in a fixed order
    float4* part = reinterpret_cast<float4*>(&ds[0][0]);  // WG_GROUPS x 64 float4 = 4 KB
    part[rg * (WG_CIT * WG_COT / 4) + og] = acc;
    __syncthreads();
    if (rg != 0) return;
    float4 sum = part[og];
    for (int g = 1; g < WG_GROUPS; ++g) {
        const float4 p = part[g * (WG_CIT * WG_COT / 4) + og];
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
    }
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
    if (ci0 + ci >= cin) return;
    for (int j = 0; j < 4; ++j) {
        const int o = co0 + co4 + j;
        if (o < cout) dw[ky * s_ky + kx * s_kx + (ci0 + ci) * s_c + o * s_o] = vals[j];
    }
}

}  // namespace

// x (batch, h, w, cin) and y (batch, h, w, cout): contiguous float32 on the
// device; skip is null or shaped as y; bias is null (zero) or (cout,). The
// weight element (ky, kx, c, o) is w[ky*s_ky + kx*s_kx + c*s_c + o*s_o], at
// (k-1-ky, k-1-kx) when flip is set. act: 0 none, 1 ReLU, 2 LeakyReLU(slope).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int silt_conv_fwd(const float* x, const float* w, long long s_ky, long long s_kx,
                             long long s_c, long long s_o, int flip, const float* bias,
                             const float* skip, float* y, int batch, int h, int wd, int cin,
                             int cout, int k, int act, float slope, void* stream) {
    if (batch * h * wd == 0 || cout == 0) return 0;
    const Weight wv{w, s_ky, s_kx, s_c, s_o, flip};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cout <= 4)
        return launch_fwd<4, 32>(x, wv, bias, skip, y, batch, h, wd, cin, cout, k, act, slope, s);
    return launch_fwd<32, 8>(x, wv, bias, skip, y, batch, h, wd, cin, cout, k, act, slope, s);
}

// x (batch, h, w, cin) and dz (batch, h, w, cout): contiguous float32 on the
// device. Writes dw(ky, kx, c, o) to dw[ky*s_ky + kx*s_kx + c*s_c + o*s_o].
// Returns the cudaError_t of the launch.
extern "C" int silt_conv_wgrad(const float* x, const float* dz, float* dw, long long s_ky,
                               long long s_kx, long long s_c, long long s_o, int batch, int h,
                               int wd, int cin, int cout, int k, void* stream) {
    if (cin == 0 || cout == 0) return 0;
    const dim3 grid(static_cast<unsigned>(k * k), static_cast<unsigned>((cin + WG_CIT - 1) / WG_CIT),
                    static_cast<unsigned>((cout + WG_COT - 1) / WG_COT));
    conv_wgrad_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, dz, dw, s_ky, s_kx, s_c, s_o, batch, h, wd, cin, cout, k);
    return static_cast<int>(cudaGetLastError());
}
