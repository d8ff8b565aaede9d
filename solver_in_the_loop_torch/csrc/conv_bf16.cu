// Fused KxK SAME stride-1 convolution, NHWC, bfloat16 operands: hand-written
// Hopper (sm_90a) kernels for the forward (also the input gradient) and the
// weight gradient of the nets under --bf16.
//
// They replace the TPU kernels of
// solver_in_the_loop_tpu/ops/pallas/conv_kernel.py on bfloat16 inputs, which
// the JAX package's `Conv.__call__` sends there under `compute_dtype =
// bfloat16` (models/networks.py: x, kernel, bias and skip cast to bf16):
//
// * `conv_fwd_bf16` replaces `_fwd_kernel` / `_fwd_kernel_taps` (through
//   `_conv_rows`): bf16 products summed in fp32 (`preferred_element_type`
//   fp32), then the epilogue `_epilogue` in fp32 (+ bias, + skip, ReLU or
//   LeakyReLU with the fp32 slope) and one rounding to bf16 at the store:
//
//     y[b,y,x,o] = bf16( act( bias[o] + skip[b,y,x,o]
//                             + sum_{ky,kx,c} x[b, y+ky-r, x+kx-r, c] * w(ky, kx, c, o) ) )
//
//   The weight is read through four element strides and an optional flip of
//   both spatial axes, as csrc/conv.cu reads it, so the input gradient is
//   the same kernel on the flipped, channel-transposed view (zero bias, no
//   activation), as `_conv_same_bwd` computes dX.
// * `conv_wgrad_bf16` replaces `_wgrad_kernel` / `_wgrad_kernel_taps`
//   (through `_conv_wgrad`): dw(ky, kx, c, o) = sum_{b,y,x} x[b, y+ky-r,
//   x+kx-r, c] * dz[b,y,x,o] from bf16 x and dz, summed and written in fp32
//   (the VJP rounds it to bf16 afterwards, kernels/conv.py).
//
// Products: `mma.sync.aligned.m16n8k16` with bf16 operands and fp32
// accumulators, one product per term (a bf16 x bf16 product is exact in
// fp32; only the order of the fp32 sum differs from the plain twin).
//
// Forward design. An implicit GEMM: rows are output pixels, depth is (tap,
// input channel), columns are output channels. A block owns FWD_TH image
// rows x 16 pixels and 16 output channels (two 8-wide mma tiles) and has one
// warp per image row, which runs every tap. The block stages the input patch
// (the tile and its K-1 halo, 32 input channels at a time, zeros outside the
// image and beyond Cin) as [pixel][channel] and the weight of all K*K taps
// as [tap][output][channel], so each lane's A and B fragments are 32-bit
// words (two neighbouring channels), and a pixel or output stride of 4 mod 8
// words puts the 32 lanes of a load on 32 banks. The weight is read 16 bytes
// at a time where its taps and inner channel axis are contiguous (the
// PyTorch parameter, and the input gradient's transposed view), the patch
// where Cin is a multiple of 8. The epilogue runs on the accumulators and
// stores bf16 directly.
//
// Weight-gradient design (the layout of csrc/conv.cu's): the B*H*W pixel
// rows are split over a thread-block cluster of up to 8 blocks, whose
// partial sums are added through distributed shared memory in rank order:
// one launch, no atomics, the same bits on every launch. A block owns one
// tap row ky, 16 input and 16 output channels; its warps are the K taps kx,
// twice (two groups that take alternate row segments). Rows are staged one
// stage of up to 256 pixels at a time, [pixel][16 channels], 16 bytes per
// load where the channel counts are multiples of 8; each fragment pairs two
// pixels of one channel, loaded as two 16-bit words.
//
// What bounds them on the H100. The MarsMoon 32->32 conv at the Burgers
// training shape (5, 32, 32) is 2*M*K*K*Cin*Cout = 262 MFLOP, 0.27 us at
// 989 TFLOP/s, over about 1 MB of bf16 operands, 0.3 us at 3.35 TB/s: the
// bytes bound it, barely. `mma.sync` from four warps per block over
// 160 blocks reaches neither; a block's time is its staged loads' latency
// and the chain of its warps' products (a first version read the weight 2
// bytes at a time and took 2.6x as long). No cp.async pipeline, no `wgmma`.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int SMEM_STATIC_LIMIT = 48 * 1024;
constexpr int kMaxDevices = 64;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

struct Weight {  // element (ky, kx, c, o) of a (K, K, Cin, Cout) weight
    const bf16* p;
    long long s_ky, s_kx, s_c, s_o;
    int flip;  // read (K-1-ky, K-1-kx)
};

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 out. Lane
// l = 4g + t holds a(g, 2t..2t+1), a(g+8, 2t..2t+1), a(g, 2t+8..2t+9),
// a(g+8, 2t+8..2t+9); b(2t..2t+1, g), b(2t+8..2t+9, g); d(g, 2t), d(g, 2t+1),
// d(g+8, 2t), d(g+8, 2t+1). Each 32-bit register holds two bf16, the lower
// index in the lower half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned word(const bf16* p) {
    return *reinterpret_cast<const unsigned*>(p);
}

// two bf16 from separate addresses as one register, lo in the lower half
__device__ __forceinline__ unsigned pack(const bf16* lo, const bf16* hi) {
    return static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(lo))
           | (static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(hi)) << 16);
}

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

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

template <class Tag, int K>
int* smem_allowed() {
    static int allowed[kMaxDevices] = {};
    return allowed;
}

// ---------------------------------------------------------------- forward

constexpr int FWD_TH = 4;   // image rows per block, one warp each
constexpr int FWD_TW = 16;  // pixels per row: the 16 rows of an A tile
constexpr int FWD_NT = 16;  // output channels per block: two 8-wide mma tiles
constexpr int FWD_CC = 32;  // input channels staged at once, at most

// Shared-memory geometry of one block, in bf16 elements: the patch
// [PH][PW][cs] and the weight [K*K][FWD_NT][cs], cs the chunk's channels
// (a multiple of 16) plus 8, so a pixel's or an output's stride is 4 mod 8
// 32-bit words.
template <int K>
struct FwdShape {
    static constexpr int THREADS = 32 * FWD_TH;
    static constexpr int PH = FWD_TH + K - 1;
    static constexpr int PW = FWD_TW + K - 1;
    static constexpr int KK = K * K;
    int cc, cs, patch, weight;

    __host__ __device__ explicit FwdShape(int cin)
        : cc(min(round_up(cin, 16), FWD_CC)), cs(cc + 8), patch(PH * PW * cs),
          weight(KK * FWD_NT * cs) {}

    __host__ __device__ int elems() const { return patch + weight; }
};

// Stage the weight of every tap for outputs co0 + [0, 16) and channels
// [c0, c0 + cc) into ws[(tap * FWD_NT + o) * cs + c], zeros beyond cin and
// cout. With `wvec` the weight is [outer][inner][tap] in memory, the taps
// and the inner channel axis contiguous (the PyTorch parameter, and the
// input gradient's transposed view), each outer index's run 16-byte aligned:
// the runs are read 8 elements at a time. Otherwise element by element, in
// memory order (the taps, then whichever channel axis has the smaller
// stride) so that neighbouring threads read neighbouring elements.
template <int K>
__device__ __forceinline__ void stage_weight(bf16* ws, const Weight& w, const FwdShape<K>& s,
                                             int c0, int co0, int cin, int cout, bool c_inner,
                                             int wvec) {
    constexpr int KK = K * K;
    constexpr int THREADS = FwdShape<K>::THREADS;
    const bf16 zero = __float2bfloat16(0.f);
    if (wvec) {
        const int n_in = c_inner ? s.cc : FWD_NT;  // the chunk's inner extent
        const int n_out = c_inner ? FWD_NT : s.cc;
        const int in0 = c_inner ? c0 : co0;
        const int out0 = c_inner ? co0 : c0;
        const int valid_in = min(n_in, (c_inner ? cin : cout) - in0);
        const int valid_out = min(n_out, (c_inner ? cout : cin) - out0);
        const long long s_out = c_inner ? w.s_o : w.s_c;
        if (valid_in < n_in || valid_out < n_out) {  // padding: zeros first
            for (int i = threadIdx.x; i < KK * FWD_NT * s.cs / 8; i += THREADS)
                reinterpret_cast<uint4*>(ws)[i] = make_uint4(0, 0, 0, 0);
            __syncthreads();
        }
        const int run = valid_in * KK;  // elements of one outer index's run
        const int vecs = (run + 7) / 8;
        for (int i = threadIdx.x; i < valid_out * vecs; i += THREADS) {
            const int q = i / vecs;
            const int e0 = (i % vecs) * 8;
            const bf16* src = w.p + (out0 + q) * s_out + static_cast<long long>(in0) * KK + e0;
            // element e of the run (inner e / KK, tap e % KK) to its place
            auto put = [&](int e, bf16 value) {
                const int t = e % KK;
                const int tap = w.flip ? KK - 1 - t : t;
                const int c = c_inner ? e / KK : q;
                const int o = c_inner ? q : e / KK;
                ws[(tap * FWD_NT + o) * s.cs + c] = value;
            };
            if (e0 + 8 <= run) {
                const uint4 raw = *reinterpret_cast<const uint4*>(src);
                const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    put(e0 + j, __ushort_as_bfloat16(
                                    static_cast<unsigned short>(words[j / 2] >> (16 * (j % 2)))));
            } else {
                for (int j = 0; j < run - e0; ++j) put(e0 + j, src[j]);
            }
        }
        return;
    }
    for (int i = threadIdx.x; i < KK * FWD_NT * s.cc; i += THREADS) {
        const int tap = i % KK;
        const int pair = i / KK;
        const int c = c_inner ? pair % s.cc : pair / FWD_NT;
        const int o = c_inner ? pair / s.cc : pair % FWD_NT;
        const int ky = w.flip ? K - 1 - tap / K : tap / K;
        const int kx = w.flip ? K - 1 - tap % K : tap % K;
        const bool ok = c0 + c < cin && co0 + o < cout;
        ws[(tap * FWD_NT + o) * s.cs + c] =
            ok ? w.p[ky * w.s_ky + kx * w.s_kx + (c0 + c) * w.s_c + (co0 + o) * w.s_o] : zero;
    }
}

template <int K>
__global__ void __launch_bounds__(FwdShape<K>::THREADS)
conv_fwd_bf16_kernel(const bf16* __restrict__ x, Weight w, const bf16* __restrict__ bias,
                     const bf16* __restrict__ skip, bf16* __restrict__ y, int h, int wd,
                     int cin, int cout, int act, float slope, int vec, int wvec) {
    using S = FwdShape<K>;
    extern __shared__ __align__(16) unsigned char fwd_smem_raw[];
    bf16* xs = reinterpret_cast<bf16*>(fwd_smem_raw);
    const S s(cin);
    bf16* ws = xs + s.patch;

    const int tiles_x = (wd + FWD_TW - 1) / FWD_TW;
    const int tiles_y = (h + FWD_TH - 1) / FWD_TH;
    const int tx = blockIdx.x % tiles_x;
    const int ty = (blockIdx.x / tiles_x) % tiles_y;
    const long long b = blockIdx.x / (tiles_x * tiles_y);
    const int y0 = ty * FWD_TH;
    const int x0 = tx * FWD_TW;
    const int co0 = blockIdx.y * FWD_NT;
    const int row = threadIdx.x / 32;  // this warp's image row in the tile
    const int g = (threadIdx.x % 32) / 4;
    const int t = threadIdx.x % 4;
    const bf16* xb = x + b * h * wd * cin;
    const bf16 zero = __float2bfloat16(0.f);
    const bool c_inner = w.s_c <= w.s_o;

    float acc[2][4] = {};  // output channels co0 + [0, 8) and [8, 16)
    for (int c0 = 0; c0 < cin; c0 += s.cc) {
        __syncthreads();  // the previous chunk's readers are done
        // the patch: channels [c0, c0 + cc), zeros outside the image and beyond cin
        if (vec) {  // 8 channels (16 bytes) per load; cin is a multiple of 8
            const int per = s.cc / 8;
            for (int i = threadIdx.x; i < S::PH * S::PW * per; i += S::THREADS) {
                const int pos = i / per;
                const int c = (i % per) * 8;
                const int gy = y0 + pos / S::PW - K / 2;
                const int gx = x0 + pos % S::PW - K / 2;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (c0 + c < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd)
                    v = *reinterpret_cast<const uint4*>(
                        xb + (static_cast<long long>(gy) * wd + gx) * cin + c0 + c);
                *reinterpret_cast<uint4*>(xs + pos * s.cs + c) = v;
            }
        } else {
            for (int i = threadIdx.x; i < S::PH * S::PW * s.cc; i += S::THREADS) {
                const int pos = i / s.cc;
                const int c = i % s.cc;
                const int gy = y0 + pos / S::PW - K / 2;
                const int gx = x0 + pos % S::PW - K / 2;
                const bool ok = c0 + c < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd;
                xs[pos * s.cs + c] =
                    ok ? xb[(static_cast<long long>(gy) * wd + gx) * cin + c0 + c] : zero;
            }
        }
        stage_weight<K>(ws, w, s, c0, co0, cin, cout, c_inner, wvec);
        __syncthreads();
        // the tap rows rolled above K = 3: unrolled, K = 5 and 7 spill
#pragma unroll (K <= 3 ? K : 1)
        for (int ky = 0; ky < K; ++ky) {
#pragma unroll
            for (int kx = 0; kx < K; ++kx) {
                // A (16 pixels x 16 channels): pixel i of the row at a + i*cs
                const bf16* a = xs + ((row + ky) * S::PW + kx) * s.cs + 2 * t;
                const bf16* bw = ws + (ky * K + kx) * FWD_NT * s.cs + g * s.cs + 2 * t;
                for (int c = 0; c < s.cc; c += 16) {
                    unsigned af[4];
                    af[0] = word(a + g * s.cs + c);
                    af[1] = word(a + (g + 8) * s.cs + c);
                    af[2] = word(a + g * s.cs + c + 8);
                    af[3] = word(a + (g + 8) * s.cs + c + 8);
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) {
                        const bf16* bq = bw + 8 * nt * s.cs + c;
                        const unsigned bf[2] = {word(bq), word(bq + 8)};
                        mma_bf16(acc[nt], af, bf);
                    }
                }
            }
        }
    }

    // epilogue in fp32 (conv_kernel.py `_epilogue`): + bias, + skip,
    // activation; one rounding to bf16 at the store
    const int gy = y0 + row;
    if (gy >= h) return;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int gx = x0 + g + (e >= 2 ? 8 : 0);
            const int o = co0 + 8 * nt + 2 * t + (e & 1);
            if (gx >= wd || o >= cout) continue;
            const long long at = ((b * h + gy) * wd + gx) * cout + o;
            float v = acc[nt][e];
            if (bias != nullptr) v += __bfloat162float(bias[o]);
            if (skip != nullptr) v += __bfloat162float(skip[at]);
            if (act == ACT_RELU) v = fmaxf(v, 0.f);
            else if (act == ACT_LEAKY) v = v >= 0.f ? v : slope * v;
            y[at] = __float2bfloat16_rn(v);
        }
    }
}

struct FwdTag {};

template <int K>
int launch_fwd(const bf16* x, const Weight& w, const bf16* bias, const bf16* skip, bf16* y,
               int batch, int h, int wd, int cin, int cout, int act, float slope, int vec,
               int wvec, cudaStream_t stream) {
    using S = FwdShape<K>;
    const int smem = 2 * S(cin).elems();
    const cudaError_t err =
        allow_smem(conv_fwd_bf16_kernel<K>, smem, smem_allowed<FwdTag, K>());
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = ((h + FWD_TH - 1) / FWD_TH) * ((wd + FWD_TW - 1) / FWD_TW);
    const dim3 grid(static_cast<unsigned>(batch * tiles),
                    static_cast<unsigned>((cout + FWD_NT - 1) / FWD_NT));
    conv_fwd_bf16_kernel<K><<<grid, S::THREADS, smem, stream>>>(x, w, bias, skip, y, h, wd, cin,
                                                                cout, act, slope, vec, wvec);
    return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------- weight gradient

// A staged pixel holds 16 channels (x) or 16 outputs (dz) at a stride of 24
// bf16 elements.
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

    __host__ __device__ int stage_elems() const { return per_stage * (xunit + dunit); }
    // bytes: the stage's bf16 rows, or the fp32 sums of the end, if more
    __host__ int bytes(int k) const { return max(2 * stage_elems(), 4 * WG_GROUPS * k * 256); }
};

template <int K>
__global__ void __launch_bounds__(32 * K * WG_GROUPS)
conv_wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dz,
                       float* __restrict__ dw, long long s_ky, long long s_kx, long long s_c,
                       long long s_o, int h, int wd, int cin, int cout, int seg, int units,
                       int vec_x, int vec_dz) {
    extern __shared__ __align__(16) unsigned char wg_smem_raw[];
    bf16* stage = reinterpret_cast<bf16*>(wg_smem_raw);
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
    const int u0 = static_cast<int>(static_cast<long long>(units) * rank / ranks);
    const int u1 = static_cast<int>(static_cast<long long>(units) * (rank + 1) / ranks);
    const bf16 zero = __float2bfloat16(0.f);
    bf16* xs = stage;
    bf16* ds = stage + s.per_stage * s.xunit;

    float acc[2][4] = {};  // dw(ky, kx, ci0 + [0, 16), co0 + [0, 8) and [8, 16))
    for (int u = u0; u < u1; u += s.per_stage) {
        const int n = min(s.per_stage, u1 - u);
        __syncthreads();  // the previous stage's readers are done
        // per unit: the input row y+ky-r from the segment's first pixel - r
        // (with the halo) and the dz row, 16 channels each, zeros outside;
        // 8 channels (16 bytes) per load where the channel counts allow
        if (vec_x) {
            for (int i = threadIdx.x; i < n * s.pw * 2; i += THREADS) {
                const int j = i / (s.pw * 2);
                const int p = (i / 2) % s.pw;
                const int c = (i % 2) * 8;
                const long long q = (u + j) / segs;
                const int yy = static_cast<int>(q % h) + ky - r;
                const int gx = ((u + j) % segs) * seg + p - r;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (yy >= 0 && yy < h && gx >= 0 && gx < wd && ci0 + c < cin)
                    v = *reinterpret_cast<const uint4*>(
                        x + ((q + ky - r) * wd + gx) * cin + ci0 + c);
                *reinterpret_cast<uint4*>(xs + j * s.xunit + p * WG_CS + c) = v;
            }
        } else {
            for (int i = threadIdx.x; i < n * s.pw * 16; i += THREADS) {
                const int j = i / (s.pw * 16);
                const int p = (i / 16) % s.pw;
                const int c = i % 16;
                const long long q = (u + j) / segs;  // image row b*h + y
                const int yy = static_cast<int>(q % h) + ky - r;
                const int gx = ((u + j) % segs) * seg + p - r;
                const bool ok = yy >= 0 && yy < h && gx >= 0 && gx < wd && ci0 + c < cin;
                xs[j * s.xunit + p * WG_CS + c] =
                    ok ? x[((q + ky - r) * wd + gx) * cin + ci0 + c] : zero;
            }
        }
        if (vec_dz) {
            for (int i = threadIdx.x; i < n * seg * 2; i += THREADS) {
                const int j = i / (seg * 2);
                const int p = (i / 2) % seg;
                const int o = (i % 2) * 8;
                const long long q = (u + j) / segs;
                const int gx = ((u + j) % segs) * seg + p;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (gx < wd && co0 + o < cout)
                    v = *reinterpret_cast<const uint4*>(dz + (q * wd + gx) * cout + co0 + o);
                *reinterpret_cast<uint4*>(ds + j * s.dunit + p * WG_CS + o) = v;
            }
        } else {
            for (int i = threadIdx.x; i < n * seg * 16; i += THREADS) {
                const int j = i / (seg * 16);
                const int p = (i / 16) % seg;
                const int o = i % 16;
                const long long q = (u + j) / segs;
                const int gx = ((u + j) % segs) * seg + p;
                const bool ok = gx < wd && co0 + o < cout;
                ds[j * s.dunit + p * WG_CS + o] = ok ? dz[(q * wd + gx) * cout + co0 + o] : zero;
            }
        }
        __syncthreads();
        for (int j = group; j < n; j += WG_GROUPS) {
            // A (16 channels x 16 pixels): x(pixel p + kx - r, channel c) at
            // a + p*WG_CS + c; B (16 pixels x 8 outputs): dz(p, o) at bm + p*WG_CS + o
            const bf16* a = xs + j * s.xunit + (kx + 2 * t) * WG_CS + g;
            const bf16* bm = ds + j * s.dunit + 2 * t * WG_CS + g;
            for (int p = 0; p < seg; p += 16) {
                unsigned af[4];
                af[0] = pack(a + p * WG_CS, a + (p + 1) * WG_CS);
                af[1] = pack(a + p * WG_CS + 8, a + (p + 1) * WG_CS + 8);
                af[2] = pack(a + (p + 8) * WG_CS, a + (p + 9) * WG_CS);
                af[3] = pack(a + (p + 8) * WG_CS + 8, a + (p + 9) * WG_CS + 8);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const bf16* bq = bm + p * WG_CS + 8 * nt;
                    const unsigned bf[2] = {pack(bq, bq + WG_CS),
                                            pack(bq + 8 * WG_CS, bq + 9 * WG_CS)};
                    mma_bf16(acc[nt], af, bf);
                }
            }
        }
    }

    // the two groups' sums, then the cluster's, added in a fixed order; the
    // cluster's through distributed shared memory in rank order, each block
    // adding and writing its share of the K*256 sums
    __syncthreads();  // every warp is done with the staged rows
    float* part = reinterpret_cast<float*>(wg_smem_raw);  // [WG_GROUPS][K][16 c][16 o]
    float* mine = part + warp * 256;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
        const int o = 8 * nt + 2 * t;
        mine[g * 16 + o] = acc[nt][0];
        mine[g * 16 + o + 1] = acc[nt][1];
        mine[(g + 8) * 16 + o] = acc[nt][2];
        mine[(g + 8) * 16 + o + 1] = acc[nt][3];
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
int launch_wgrad(const bf16* x, const bf16* dz, float* dw, long long s_ky, long long s_kx,
                 long long s_c, long long s_o, int batch, int h, int wd, int cin, int cout,
                 int vec_x, int vec_dz, cudaStream_t stream) {
    const int seg = wd > 0 ? min(round_up(wd, 16), WG_SEG) : 16;
    const int units = wd > 0 ? batch * h * ((wd + seg - 1) / seg) : 0;
    const WgShape s(seg, K);
    const int smem = s.bytes(K);
    cudaError_t err = allow_smem(conv_wgrad_bf16_kernel<K>, smem, smem_allowed<WgradTag, K>());
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
    err = cudaLaunchKernelEx(&cfg, conv_wgrad_bf16_kernel<K>, x, dz, dw, s_ky, s_kx, s_c, s_o, h,
                             wd, cin, cout, seg, units, vec_x, vec_dz);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (batch, h, w, cin) and y (batch, h, w, cout): contiguous bfloat16 on the
// device; skip is null or shaped as y; bias is null (zero) or (cout,), both
// bfloat16. The weight element (ky, kx, c, o) is w[ky*s_ky + kx*s_kx + c*s_c
// + o*s_o] (bfloat16), at (k-1-ky, k-1-kx) when flip is set. act: 0 none,
// 1 ReLU, 2 LeakyReLU(slope), in fp32. k is 1, 3, 5 or 7. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int silt_conv_fwd_bf16(const void* x, const void* w, long long s_ky, long long s_kx,
                                  long long s_c, long long s_o, int flip, const void* bias,
                                  const void* skip, void* y, int batch, int h, int wd, int cin,
                                  int cout, int k, int act, float slope, void* stream) {
    if (batch * h * wd == 0 || cout == 0) return 0;
    const Weight wv{static_cast<const bf16*>(w), s_ky, s_kx, s_c, s_o, flip};
    const int vec = cin % 8 == 0 && aligned16(x);
    // the weight as [outer][inner][tap], the runs over (inner, tap) 16-byte aligned
    const long long kk = static_cast<long long>(k) * k;
    const long long s_in = s_c < s_o ? s_c : s_o;
    const long long s_out = s_c < s_o ? s_o : s_c;
    const int wvec = s_kx == 1 && s_ky == k && s_in == kk && s_out % 8 == 0 && aligned16(w);
    const auto* xb = static_cast<const bf16*>(x);
    const auto* bb = static_cast<const bf16*>(bias);
    const auto* sb = static_cast<const bf16*>(skip);
    auto* yb = static_cast<bf16*>(y);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SILT_FWD(K) \
    launch_fwd<K>(xb, wv, bb, sb, yb, batch, h, wd, cin, cout, act, slope, vec, wvec, st)
    switch (k) {
        case 1: return SILT_FWD(1);
        case 3: return SILT_FWD(3);
        case 5: return SILT_FWD(5);
        case 7: return SILT_FWD(7);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SILT_FWD
}

// x (batch, h, w, cin) and dz (batch, h, w, cout): contiguous bfloat16 on the
// device. Writes dw(ky, kx, c, o), fp32, to dw[ky*s_ky + kx*s_kx + c*s_c +
// o*s_o]. k is 1, 3, 5 or 7. Returns the cudaError_t of the launch.
extern "C" int silt_conv_wgrad_bf16(const void* x, const void* dz, float* dw, long long s_ky,
                                    long long s_kx, long long s_c, long long s_o, int batch,
                                    int h, int wd, int cin, int cout, int k, void* stream) {
    if (cin == 0 || cout == 0) return 0;
    const auto* xb = static_cast<const bf16*>(x);
    const auto* db = static_cast<const bf16*>(dz);
    const int vx = cin % 8 == 0 && aligned16(x);
    const int vd = cout % 8 == 0 && aligned16(dz);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SILT_WGRAD(K) \
    launch_wgrad<K>(xb, db, dw, s_ky, s_kx, s_c, s_o, batch, h, wd, cin, cout, vx, vd, st)
    switch (k) {
        case 1: return SILT_WGRAD(1);
        case 3: return SILT_WGRAD(3);
        case 5: return SILT_WGRAD(5);
        case 7: return SILT_WGRAD(7);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SILT_WGRAD
}
