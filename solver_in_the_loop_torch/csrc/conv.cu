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
// Products: tensor cores in 3xTF32. Both kernels are matrix products in
// `mma.sync.m16n8k8` TF32 tiles. TF32 keeps 10 mantissa bits, too few for
// the port's tolerances (1e-5 of the output's max forward, 1e-4 for the
// weight gradient; tests/test_torch_conv.py shows one TF32 product missing
// both), so each operand a is split into big = tf32(a) and small =
// tf32(a - big), both rounded to nearest on the bits (an integer add and a
// mask), and a*b is accumulated as big*big + big*small + small*big, each
// product in its own accumulator. The tensor cores do not round their fp32
// sums to nearest, so a long chain of products drifts: every few products
// the three accumulators are added into an fp32 total and restarted. The
// split and the accumulators are csrc/tf32.cuh, which csrc/pcg.cu's
// preconditioner products share. The fragments are loaded from shared memory element by element, from layouts
// whose strides put the 32 lanes of each load on 32 different banks (the
// strides are chosen where each layout is defined). Channel and pixel
// counts are padded to the tiles in shared memory only, with zeros.
//
// Forward design. An implicit GEMM: rows are output pixels, depth is
// (tap, input channel), columns are output channels. A block owns a tile of
// 2 image rows x 16 pixels and 16 output channels, and has 2*K warps: warp
// (row, ky) sums one tap row for one image row of the tile, whose A tiles
// are the input patch read at a constant stride, one pixel per tile row. The
// block stages the input patch (the tile and its K-1 halo, 32 input channels
// at a time, zeros outside the image) and the weight for all K*K taps with
// cp.async, in two groups of channels: the second group loads while the
// first is multiplied. The weight is staged in its own memory order (taps,
// its unit-stride axes in the PyTorch parameter and in the input gradient's
// view, fastest; then whichever channel axis has the smaller stride), so a
// warp reads neighbouring words and writes neighbouring banks. The K
// tap-row sums of each image row are then added in a fixed order and the
// epilogue (+ bias, + skip, activation) is applied once as each output is
// written. 2x16-pixel, 16-channel tiles give 64 blocks for a 32->32 conv at
// 32x32 and batch 1, and 320 at batch 5, for 132 SMs.
//
// Weight-gradient design. dW for one tap row ky is the product of the
// shifted input rows (K*Cin x M) with dz (M x Cout) over all M = B*H*W pixels.
// The rows are split over a thread-block cluster of up to 8 blocks (the
// mechanism of csrc/pcg.cu): each block sums a fixed, contiguous share of the
// image rows (cut into segments of at most 64 pixels), and the partial sums
// are added through distributed shared memory in rank order, so the result is
// the same bits on every launch, with no atomics and no second launch. A
// block owns one tap row ky, 16 input and 16 output channels; its warps are
// the K taps kx of that row, twice (two groups that take alternate row
// segments and add their sums in a fixed order at the end), so each staged dz
// row and each staged input row (with its +-K/2 halo) serves all K taps.
// Rows are staged 256 pixels at a time with cp.async, double-buffered. At the
// Burgers block shape that is 20 clusters of 8 blocks (160 blocks of 10
// warps), each 3 stages long.
//
// What bounds them on the H100. The MarsMoon 32->32 conv at the Burgers
// training shape (5, 32, 32) is 2*M*K*K*Cin*Cout = 262 MFLOP over 1.4 MB; in
// 3xTF32 that is 786 MFLOP of tensor-core work, 1.6 us at 495 TFLOP/s,
// against 0.4 us of HBM time, so the bound is operations. `mma.sync` tiles
// issued by a few warps per SM do not reach that rate, and each product
// costs eight shared-memory loads and the splits of its operands in
// instructions; a block's time is those instructions, the latency of its
// staged loads, and for the weight gradient the cluster's reduction. The
// splits above keep the chains of dependent products short and the SMs
// busy at batch 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32.cuh"

namespace cg = cooperative_groups;

namespace {

using silt::Acc;
using silt::split_tf32;

constexpr int SMEM_STATIC_LIMIT = 48 * 1024;
constexpr int kMaxDevices = 64;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

struct Weight {  // element (ky, kx, c, o) of a (K, K, Cin, Cout) weight
    const float* p;
    long long s_ky, s_kx, s_c, s_o;
    int flip;  // read (K-1-ky, K-1-kx)
};

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

// The smallest stride >= n that is m modulo 32 (m = 4 or 8).
__host__ __device__ inline int stride_mod32(int n, int m) { return n + (((m - n) % 32) + 32) % 32; }

// cp.async of 4 or 16 bytes; when !valid nothing is read and zeros are written.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ int log2_of(int n) { return 31 - __clz(n); }

// Raises a kernel's dynamic shared memory limit when a launch needs more than
// the default 48 KB and more than it was allowed so far on this device.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
    if (bytes <= SMEM_STATIC_LIMIT) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (bytes <= allowed[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) allowed[dev] = bytes;
    return err;
}

// Per kernel instantiation: the dynamic shared memory allowed so far, per device.
template <class Tag, int K>
int* smem_allowed() {
    static int allowed[kMaxDevices] = {};
    return allowed;
}

// ---------------------------------------------------------------- forward

constexpr int FWD_TH = 2;   // tile rows
constexpr int FWD_TW = 16;  // tile width: the 16 rows of an A tile
constexpr int FWD_NT = 16;  // output channels per block: two 8-wide mma tiles
constexpr int FWD_CC = 32;  // input channels staged at once, at most

// Shared-memory geometry of one block, in floats. The weight tile is kept
// as [outer][inner][tap], inner the channel axis (c or o) with the smaller
// stride in memory: taps stride 1, inner stride K*K, outer stride s_out.
template <int K>
struct FwdShape {
    static constexpr int THREADS = 32 * FWD_TH * K;  // warp (row, ky)
    static constexpr int PH = FWD_TH + K - 1;
    static constexpr int PW = FWD_TW + K - 1;
    static constexpr int KK = K * K;
    int cc, cp, patch, so_c, so_o, wsz;

    __host__ __device__ FwdShape(int cin, bool c_inner)
        : cc(min(round8(cin), FWD_CC)), cp(cc + 4), patch(PH * PW * cp) {
        // an A fragment's lanes read (pixel + g, channel + t), g < 8, t < 4:
        // a pixel stride cp of 4 mod 8 puts them on 32 banks. A B fragment's lanes read (c + t, o + g), t < 4, g < 8: with the
        // channel inner, an outer (o) stride of 4 mod 32 puts them on 32
        // banks; with the output inner, an outer (c) stride of 8 mod 32
        const int s_out = c_inner ? stride_mod32(cc * KK, 4) : stride_mod32(FWD_NT * KK, 8);
        so_c = c_inner ? KK : s_out;
        so_o = c_inner ? s_out : KK;
        wsz = max((c_inner ? FWD_NT : cc) * s_out, FWD_TH * K * 256);
    }

    __host__ __device__ int floats() const { return patch + wsz; }
};

// Channels [c0 + cb0, c0 + cb1) of the input patch, channel fastest, into
// xs[pos][cb0..cb1) (zeros outside the image and beyond cin); cb1 - cb0 is 8 or 16.
template <int K>
__device__ void stage_patch(float* xs, const float* __restrict__ xb, const float* x, int c0,
                            int cb0, int cb1, int y0, int x0, int h, int wd, int cin, int cp,
                            int vec) {
    using S = FwdShape<K>;
    const int lg = log2_of((cb1 - cb0) / (vec ? 4 : 1));
    const int n = (S::PH * S::PW) << lg;
    for (int i = threadIdx.x; i < n; i += S::THREADS) {
        const int pos = i >> lg;
        const int c = cb0 + (i & ((1 << lg) - 1)) * (vec ? 4 : 1);
        const int gy = y0 + pos / S::PW - K / 2;
        const int gx = x0 + pos % S::PW - K / 2;
        const bool ok = c0 + c < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd;
        const float* src = ok ? xb + (static_cast<long long>(gy) * wd + gx) * cin + c0 + c : x;
        if (vec) cp_async16(xs + pos * cp + c, src, ok);
        else cp_async4(xs + pos * cp + c, src, ok);
    }
}

// Channels [cb0, cb1) (8 or 16) of the chunk at c0 and outputs co0..co0+15
// of the weight, every tap, into the block's weight tile (zeros beyond cin
// and cout), in memory order: the tap fastest across threads, then the
// inner channel axis, so neighbouring threads read neighbouring words and
// write neighbouring banks.
template <int K>
__device__ void stage_weight(float* ws, const FwdShape<K>& s, const Weight& w, bool c_inner,
                             int c0, int cb0, int cb1, int co0, int cin, int cout) {
    using S = FwdShape<K>;
    const int lg = log2_of(cb1 - cb0);
    const int n = (S::KK * FWD_NT) << lg;
    for (int i = threadIdx.x; i < n; i += S::THREADS) {
        const int tap = i % S::KK;
        const int pair = i / S::KK;
        const int c = cb0 + (c_inner ? pair & ((1 << lg) - 1) : pair / FWD_NT);
        const int o = c_inner ? pair >> lg : pair % FWD_NT;
        const int ky = w.flip ? K - 1 - tap / K : tap / K;
        const int kx = w.flip ? K - 1 - tap % K : tap % K;
        const bool ok = c0 + c < cin && co0 + o < cout;
        const float* src = ok ? w.p + ky * w.s_ky + kx * w.s_kx + (c0 + c) * w.s_c + (co0 + o) * w.s_o
                              : w.p;
        cp_async4(ws + c * s.so_c + o * s.so_o + tap, src, ok);
    }
}

template <int K>
__global__ void __launch_bounds__(FwdShape<K>::THREADS)
conv_fwd_kernel(const float* __restrict__ x, Weight w, const float* __restrict__ bias,
                const float* __restrict__ skip, float* __restrict__ y, int h, int wd, int cin,
                int cout, int act, float slope, int vec) {
    using S = FwdShape<K>;
    extern __shared__ __align__(16) float fwd_smem[];
    const bool c_inner = w.s_c <= w.s_o;
    const S s(cin, c_inner);
    float* xs = fwd_smem;      // [PH][PW][cp]: the input patch
    float* ws = xs + s.patch;  // the weight tile; at the end the tap-row sums

    const int tiles_x = (wd + FWD_TW - 1) / FWD_TW;
    const int tiles_y = (h + FWD_TH - 1) / FWD_TH;
    const int tx = blockIdx.x % tiles_x;
    const int ty = (blockIdx.x / tiles_x) % tiles_y;
    const long long b = blockIdx.x / (tiles_x * tiles_y);
    const int y0 = ty * FWD_TH;
    const int x0 = tx * FWD_TW;
    const int co0 = blockIdx.y * FWD_NT;
    const int warp = threadIdx.x / 32;
    const int row = warp % FWD_TH;
    const int ky = warp / FWD_TH;
    const int g = (threadIdx.x % 32) / 4;
    const int t = threadIdx.x % 4;
    const float* xb = x + b * h * wd * cin;

    Acc acc[2];  // output channels co0 + [0, 8) and [8, 16)
    acc[0].zero();
    acc[1].zero();
    // the chunk's channels in two groups of 8-wide blocks
    const int half = 8 * ((s.cc / 8 + 1) / 2);
    for (int c0 = 0; c0 < cin; c0 += s.cc) {
        if (c0 > 0) __syncthreads();  // the previous chunk's readers are done
        for (int grp = 0; grp < 2; ++grp) {
            const int cb0 = grp ? half : 0;
            const int cb1 = grp ? s.cc : half;
            if (cb1 > cb0) {
                stage_patch<K>(xs, xb, x, c0, cb0, cb1, y0, x0, h, wd, cin, s.cp, vec);
                stage_weight<K>(ws, s, w, c_inner, c0, cb0, cb1, co0, cin, cout);
            }
            cp_async_commit();
        }
        for (int grp = 0; grp < 2; ++grp) {
            if (grp == 0) cp_async_wait<1>();
            else cp_async_wait<0>();
            __syncthreads();
            const int cb0 = grp ? half : 0;
            const int cb1 = grp ? s.cc : half;
#pragma unroll
            for (int kx = 0; kx < K; ++kx) {
                // A (16 pixels x 8 channels): pixel i of the row at a + i*cp
                const float* a = xs + ((row + ky) * S::PW + kx) * s.cp + t;
                const float* bw = ws + (ky * K + kx) + t * s.so_c + g * s.so_o;
                for (int c = cb0; c < cb1; c += 8) {
                    unsigned a_big[4], a_small[4];
                    split_tf32(a[g * s.cp + c], a_big[0], a_small[0]);
                    split_tf32(a[(g + 8) * s.cp + c], a_big[1], a_small[1]);
                    split_tf32(a[g * s.cp + c + 4], a_big[2], a_small[2]);
                    split_tf32(a[(g + 8) * s.cp + c + 4], a_big[3], a_small[3]);
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) {
                        const float* bq = bw + c * s.so_c + 8 * nt * s.so_o;
                        unsigned b_big[2], b_small[2];
                        split_tf32(bq[0], b_big[0], b_small[0]);
                        split_tf32(bq[4 * s.so_c], b_big[1], b_small[1]);
                        acc[nt].mma(a_big, a_small, b_big, b_small);
                    }
                }
            }
            acc[0].flush();
            acc[1].flush();
        }
    }

    // the K tap-row sums of each tile row, added in order; epilogue: + bias,
    // + skip, activation (conv_kernel.py `_epilogue`)
    __syncthreads();  // every warp is done with the weight
    float* part = ws + (row * K + ky) * 256;  // [FWD_TH][K][FWD_TW pixels][FWD_NT]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
        const int o = 8 * nt + 2 * t;
        part[g * FWD_NT + o] = acc[nt].sum[0];
        part[g * FWD_NT + o + 1] = acc[nt].sum[1];
        part[(g + 8) * FWD_NT + o] = acc[nt].sum[2];
        part[(g + 8) * FWD_NT + o + 1] = acc[nt].sum[3];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < FWD_TH * 256; e += S::THREADS) {
        const int r = e / 256;
        const int i = e % 256;
        const int gy = y0 + r;
        const int gx = x0 + i / FWD_NT;
        const int o = co0 + i % FWD_NT;
        if (gy >= h || gx >= wd || o >= cout) continue;
        float v = ws[r * K * 256 + i];
        for (int q = 1; q < K; ++q) v += ws[(r * K + q) * 256 + i];
        const long long at = ((b * h + gy) * wd + gx) * cout + o;
        if (bias != nullptr) v += bias[o];
        if (skip != nullptr) v += skip[at];
        if (act == ACT_RELU) v = fmaxf(v, 0.f);
        else if (act == ACT_LEAKY) v = v >= 0.f ? v : slope * v;
        y[at] = v;
    }
}

struct FwdTag {};

template <int K>
int launch_fwd(const float* x, const Weight& w, const float* bias, const float* skip, float* y,
               int batch, int h, int wd, int cin, int cout, int act, float slope, int vec,
               cudaStream_t stream) {
    using S = FwdShape<K>;
    const int smem = 4 * S(cin, w.s_c <= w.s_o).floats();
    const cudaError_t err = allow_smem(conv_fwd_kernel<K>, smem, smem_allowed<FwdTag, K>());
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = ((h + FWD_TH - 1) / FWD_TH) * ((wd + FWD_TW - 1) / FWD_TW);
    const dim3 grid(static_cast<unsigned>(batch * tiles),
                    static_cast<unsigned>((cout + FWD_NT - 1) / FWD_NT));
    conv_fwd_kernel<K><<<grid, S::THREADS, smem, stream>>>(x, w, bias, skip, y, h, wd, cin, cout,
                                                           act, slope, vec);
    return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------- weight gradient

// A staged pixel holds 16 channels at a stride of 24 words: the A (x) and
// B (dz) fragments' lanes read (pixel + t, channel + g), t < 4, g < 8, on
// 32 different banks.
constexpr int WG_CS = 24;
constexpr int WG_SEG = 64;      // pixels of an image row per unit, at most
constexpr int WG_PIXELS = 256;  // pixels staged per stage
constexpr int WG_GROUPS = 2;    // warp groups, each taking alternate units
constexpr int WG_CLUSTER = 8;   // blocks that split the rows, at most

struct WgShape {  // units are (image row, segment) pairs of seg pixels
    int seg, pw, per_stage, xunit, dunit;

    __host__ __device__ WgShape(int seg_, int k)
        : seg(seg_), pw(seg_ + k - 1), per_stage(max(1, WG_PIXELS / seg_)), xunit(pw * WG_CS),
          dunit(seg_ * WG_CS) {}

    __host__ __device__ int stage_floats() const { return per_stage * (xunit + dunit); }
    __host__ int floats(int k) const { return max(2 * stage_floats(), WG_GROUPS * k * 256); }
};

// Stage `n` units from `u`: per unit the input row y+ky-r (pixels from the
// segment's first - r, with the halo) and the dz row, 16 channels each.
__device__ void stage_rows(float* buf, const WgShape& s, const float* __restrict__ x,
                           const float* __restrict__ dz, int u, int n, int segs, int h, int wd,
                           int cin, int cout, int ci0, int co0, int dy, int r, int vec_x,
                           int vec_dz) {
    float* xs = buf;
    float* ds = buf + s.per_stage * s.xunit;
    const int nthreads = blockDim.x;
    for (int j = 0; j < n; ++j, ++u) {
        const long long q = u / segs;  // image row b*h + y
        const int px0 = (u % segs) * s.seg;
        const int yy = static_cast<int>(q % h) + dy;
        const bool row_ok = yy >= 0 && yy < h;
        const float* xrow = row_ok ? x + (q + dy) * wd * cin : x;
        const float* drow = dz + q * wd * cout;
        const int xper = vec_x ? 4 : 16;
        for (int i = threadIdx.x; i < s.pw * xper; i += nthreads) {
            const int p = i / xper;
            const int c = (i % xper) * (vec_x ? 4 : 1);
            const int gx = px0 + p - r;
            const bool ok = row_ok && gx >= 0 && gx < wd && ci0 + c < cin;
            const float* src = ok ? xrow + static_cast<long long>(gx) * cin + ci0 + c : x;
            float* dst = xs + j * s.xunit + p * WG_CS + c;
            if (vec_x) cp_async16(dst, src, ok);
            else cp_async4(dst, src, ok);
        }
        const int dper = vec_dz ? 4 : 16;
        for (int i = threadIdx.x; i < s.seg * dper; i += nthreads) {
            const int p = i / dper;
            const int o = (i % dper) * (vec_dz ? 4 : 1);
            const int gx = px0 + p;
            const bool ok = gx < wd && co0 + o < cout;
            const float* src = ok ? drow + static_cast<long long>(gx) * cout + co0 + o : dz;
            float* dst = ds + j * s.dunit + p * WG_CS + o;
            if (vec_dz) cp_async16(dst, src, ok);
            else cp_async4(dst, src, ok);
        }
    }
}

template <int K>
__global__ void __launch_bounds__(32 * K * WG_GROUPS)
conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dz, float* __restrict__ dw,
                  long long s_ky, long long s_kx, long long s_c, long long s_o, int h, int wd,
                  int cin, int cout, int seg, int units, int vec_x, int vec_dz) {
    extern __shared__ __align__(16) float wg_smem[];
    constexpr int THREADS = 32 * K * WG_GROUPS;
    cg::cluster_group cluster = cg::this_cluster();
    const WgShape s(seg, K);
    const int rank = static_cast<int>(cluster.block_rank());
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int ky = blockIdx.y % K;
    const int cin_tiles = (cin + 15) / 16;
    const int ci0 = (blockIdx.y / K % cin_tiles) * 16;
    const int co0 = (blockIdx.y / K / cin_tiles) * 16;
    const int r = K / 2;
    const int warp = threadIdx.x / 32;
    const int kx = warp % K;     // warp (group, kx) owns tap (ky, kx)
    const int group = warp / K;  // and the units j of a stage with j % WG_GROUPS == group
    const int g = (threadIdx.x % 32) / 4;
    const int t = threadIdx.x % 4;
    const int segs = (wd + seg - 1) / seg;
    // this block's contiguous share of the units
    const int u0 = static_cast<int>(static_cast<long long>(units) * rank / ranks);
    const int u1 = static_cast<int>(static_cast<long long>(units) * (rank + 1) / ranks);
    const int stages = (u1 - u0 + s.per_stage - 1) / s.per_stage;
    const int stage_floats = s.stage_floats();

    Acc acc[2];  // dw(ky, kx, ci0 + [0, 16), co0 + [0, 8) and [8, 16))
    acc[0].zero();
    acc[1].zero();
    if (stages > 0) {
        stage_rows(wg_smem, s, x, dz, u0, min(s.per_stage, u1 - u0), segs, h, wd, cin, cout, ci0,
                   co0, ky - r, r, vec_x, vec_dz);
    }
    cp_async_commit();
    for (int st = 0; st < stages; ++st) {
        const int u = u0 + st * s.per_stage;
        if (st + 1 < stages) {
            const int un = u + s.per_stage;
            stage_rows(wg_smem + ((st + 1) & 1) * stage_floats, s, x, dz, un,
                       min(s.per_stage, u1 - un), segs, h, wd, cin, cout, ci0, co0, ky - r, r,
                       vec_x, vec_dz);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* xs = wg_smem + (st & 1) * stage_floats;
        const float* ds = xs + s.per_stage * s.xunit;
        const int n = min(s.per_stage, u1 - u);
        for (int j = group; j < n; j += WG_GROUPS) {
            // A (16 channels x 8 pixels): x(pixel p + kx - r, channel c) at a + p*WG_CS + c;
            // B (8 pixels x 8 outputs): dz(p, o) at bm + p*WG_CS + o
            const float* a = xs + j * s.xunit + (kx + t) * WG_CS + g;
            const float* bm = ds + j * s.dunit + t * WG_CS + g;
            const int valid = min(seg, wd - ((u + j) % segs) * seg);
            for (int p = 0; p < valid; p += 8) {
                unsigned a_big[4], a_small[4];
                split_tf32(a[p * WG_CS], a_big[0], a_small[0]);
                split_tf32(a[p * WG_CS + 8], a_big[1], a_small[1]);
                split_tf32(a[(p + 4) * WG_CS], a_big[2], a_small[2]);
                split_tf32(a[(p + 4) * WG_CS + 8], a_big[3], a_small[3]);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    unsigned b_big[2], b_small[2];
                    split_tf32(bm[p * WG_CS + 8 * nt], b_big[0], b_small[0]);
                    split_tf32(bm[(p + 4) * WG_CS + 8 * nt], b_big[1], b_small[1]);
                    acc[nt].mma(a_big, a_small, b_big, b_small);
                }
            }
        }
        acc[0].flush();
        acc[1].flush();
        __syncthreads();  // before the next prefetch overwrites this buffer
    }

    // the two groups' sums, then the cluster's, added in a fixed order; the
    // cluster's through distributed shared memory in rank order, each block
    // adding and writing its share of the K*256 sums
    float* part = wg_smem;  // [WG_GROUPS][K][16 c][16 o], over the drained stage buffers
    float* mine = part + warp * 256;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
        const int o = 8 * nt + 2 * t;
        mine[g * 16 + o] = acc[nt].sum[0];
        mine[g * 16 + o + 1] = acc[nt].sum[1];
        mine[(g + 8) * 16 + o] = acc[nt].sum[2];
        mine[(g + 8) * 16 + o + 1] = acc[nt].sum[3];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < K * 256; e += THREADS) part[e] += part[K * 256 + e];
    cluster.sync();
    const int total = K * 256;
    const int e0 = total * rank / ranks;
    const int e1 = total * (rank + 1) / ranks;
    for (int e = e0 + static_cast<int>(threadIdx.x); e < e1; e += THREADS) {
        float v = *cluster.map_shared_rank(part + e, 0);
        for (int q = 1; q < ranks; ++q) v += *cluster.map_shared_rank(part + e, q);
        const int tx = e / 256;
        const int c = ci0 + (e / 16) % 16;
        const int o = co0 + e % 16;
        if (c < cin && o < cout) dw[ky * s_ky + tx * s_kx + c * s_c + o * s_o] = v;
    }
    cluster.sync();  // no block leaves while a peer may still read its sums
}

struct WgradTag {};

template <int K>
int launch_wgrad(const float* x, const float* dz, float* dw, long long s_ky, long long s_kx,
                 long long s_c, long long s_o, int batch, int h, int wd, int cin, int cout,
                 int vec_x, int vec_dz, cudaStream_t stream) {
    const int seg = wd > 0 ? min(round8(wd), WG_SEG) : 8;
    const int units = wd > 0 ? batch * h * ((wd + seg - 1) / seg) : 0;
    const WgShape s(seg, K);
    const int smem = 4 * s.floats(K);
    cudaError_t err = allow_smem(conv_wgrad_kernel<K>, smem, smem_allowed<WgradTag, K>());
    if (err != cudaSuccess) return static_cast<int>(err);
    // at least one stage of rows per block
    const int ranks = max(1, min(WG_CLUSTER, (units + s.per_stage - 1) / s.per_stage));
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(ranks),
                       static_cast<unsigned>(K * ((cin + 15) / 16) * ((cout + 15) / 16)), 1);
    cfg.blockDim = dim3(32 * K * WG_GROUPS, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ranks);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, conv_wgrad_kernel<K>, x, dz, dw, s_ky, s_kx, s_c, s_o, h, wd,
                             cin, cout, seg, units, vec_x, vec_dz);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (batch, h, w, cin) and y (batch, h, w, cout): contiguous float32 on the
// device; skip is null or shaped as y; bias is null (zero) or (cout,). The
// weight element (ky, kx, c, o) is w[ky*s_ky + kx*s_kx + c*s_c + o*s_o], at
// (k-1-ky, k-1-kx) when flip is set. act: 0 none, 1 ReLU, 2 LeakyReLU(slope).
// k is 1, 3, 5 or 7. Returns the cudaError_t of the launch (0 on success).
extern "C" int silt_conv_fwd(const float* x, const float* w, long long s_ky, long long s_kx,
                             long long s_c, long long s_o, int flip, const float* bias,
                             const float* skip, float* y, int batch, int h, int wd, int cin,
                             int cout, int k, int act, float slope, void* stream) {
    if (batch * h * wd == 0 || cout == 0) return 0;
    const Weight wv{w, s_ky, s_kx, s_c, s_o, flip};
    const int vec = cin % 4 == 0 && aligned16(x);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SILT_FWD(K) launch_fwd<K>(x, wv, bias, skip, y, batch, h, wd, cin, cout, act, slope, vec, st)
    switch (k) {
        case 1: return SILT_FWD(1);
        case 3: return SILT_FWD(3);
        case 5: return SILT_FWD(5);
        case 7: return SILT_FWD(7);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SILT_FWD
}

// x (batch, h, w, cin) and dz (batch, h, w, cout): contiguous float32 on the
// device. Writes dw(ky, kx, c, o) to dw[ky*s_ky + kx*s_kx + c*s_c + o*s_o].
// k is 1, 3, 5 or 7. Returns the cudaError_t of the launch.
extern "C" int silt_conv_wgrad(const float* x, const float* dz, float* dw, long long s_ky,
                               long long s_kx, long long s_c, long long s_o, int batch, int h,
                               int wd, int cin, int cout, int k, void* stream) {
    if (cin == 0 || cout == 0) return 0;
    const int vx = cin % 4 == 0 && aligned16(x);
    const int vd = cout % 4 == 0 && aligned16(dz);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SILT_WGRAD(K) \
    launch_wgrad<K>(x, dz, dw, s_ky, s_kx, s_c, s_o, batch, h, wd, cin, cout, vx, vd, st)
    switch (k) {
        case 1: return SILT_WGRAD(1);
        case 3: return SILT_WGRAD(3);
        case 5: return SILT_WGRAD(5);
        case 7: return SILT_WGRAD(7);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SILT_WGRAD
}
