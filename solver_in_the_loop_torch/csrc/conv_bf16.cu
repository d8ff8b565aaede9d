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
// Weight-gradient design. dW for one tap row ky is the product of the
// shifted input rows (K*Cin x M) with dz (M x Cout) over all M = B*H*W
// pixels. A block owns one tap row ky, one tile of 16 input channels and
// one of 16 outputs; the M pixels, in units of one image row (segments of
// at most 64 pixels), are split over a thread-block cluster of up to 8
// blocks in contiguous shares. A block stages its share WG_PIXELS pixels at
// a time, both stages in flight at once (cp.async, 16 bytes per copy where
// the channel count allows), each unit by its own 16 threads: the dz rows
// [pixel][16 outputs] and the input rows [pixel][16 channels] with their
// +-r halo, zeros outside the image, at a stride of 48 bytes. Its 8 warps
// take the 16-pixel slices in turn; per slice a warp loads the dz tile (B)
// and each tap's input tile (A = x^T) with one `ldmatrix.x4.trans` each and
// runs both 8-output products per tap, every fragment of the slice loaded
// before its first product. Where Cin < 16 (the stems) the 16 rows of an
// A tile are taps/channel pairs, 16 / Cin taps of all Cin channels, so one
// product covers 4 taps at Cin = 4 and 5 at Cin = 3 where one product per
// tap would leave 12-13 of its 16 rows zero; those rows are built in shared
// memory from the image row, copied once as it lies. At the end the warps'
// sums are added in warp order, and each block writes them, 16 bytes at a
// time, into the shared memory of the rank that owns them; after one
// cluster barrier each rank adds its share in rank order and stores it: one
// launch, no atomics, the same bits on every launch.
//
// What bounds them on the H100. The MarsMoon 32->32 conv at the Burgers
// training shape (5, 32, 32) is 2*M*K*K*Cin*Cout = 262 MFLOP, 0.27 us at
// 989 TFLOP/s, over about 1 MB of bf16 operands, 0.3 us at 3.35 TB/s: the
// bytes bound it, barely. `mma.sync` from four warps per block over
// 160 blocks reaches neither; a forward block's time is its staged loads'
// latency and the chain of its warps' products (a first version read the
// weight 2 bytes at a time and took 2.6x as long). The weight gradient's
// 160 blocks (Burgers block conv) take about 10 us: the launch and an empty
// cluster of the same shape about 2.3, the end (partial sums, the cluster
// barrier, the sums through distributed shared memory) about 2.3, the
// staging about 3 and the products about 1.5 (chip_smoke.py --conv-split on
// variants with a part taken out). Each tap row and output tile stages the
// input rows again, each tap row and channel tile the dz rows: 10x the
// unique bytes through L2 at 32->32, K = 5; a
// block that owned all K tap rows (tried) stages each row once but leaves
// 32 blocks for 132 SMs and sums 5x as many partials per block through
// distributed shared memory: 25.4 us where this layout then took 14.9.
// No `wgmma`: the tiles are 16 channels wide.

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

// The weight gradient's tiling. kernels/conv.py `WGRAD_BF16` holds the same
// constants and `wgrad_bf16_plan` the same plan (WgPlan, launch_wgrad);
// tests/test_torch_conv_wgrad_bf16_tiles.py checks the two against each other
// and walks the partition on the CPU.
constexpr int WG_RS = 24;       // bf16 elements per staged row (16 used): 48 bytes,
                                // so 8 rows of an ldmatrix fall on 8 bank groups
constexpr int WG_SEG = 64;      // pixels of an image row per unit, at most
constexpr int WG_PIXELS = 512;  // pixels per stage
constexpr int WG_STAGES = 2;    // stages in the ring, all in flight at once
constexpr int WG_WARPS = 8;     // warps of a block, which take the slices in turn
constexpr int WG_CLUSTER = 8;   // blocks of a cluster, which split the units

// A unit is `seg` pixels of one image row. A staged input row s of a unit
// holds `taps` taps of `cin` channels, [tap * cin + c] = x(row y+ky-r, pixel
// x0 + s + tap - r, c), or (taps = 1) the 16 channels of the block's tile, so
// the 16 rows of an A tile are `taps` taps at once where cin < 16, and tap
// group q's A tile for the slice at pixel p0 is rows p0 + q * taps + [0, 16).
// Where cin < 16 a stage also has room for each unit's image row as it lies
// in memory (`raw`), which is copied once and spread into the tap rows.
struct WgPlan {
    int seg, segs, units, per_stage, taps, groups, pw, raw, stage_elems;

    __host__ __device__ WgPlan(int batch, int h, int wd, int cin, int k)
        : seg(wd > 0 ? min(round_up(wd, 16), WG_SEG) : 16),
          segs((wd + seg - 1) / seg),
          units(batch * h * segs),
          per_stage(max(1, WG_PIXELS / seg)),
          taps(cin < 16 ? 16 / cin : 1),
          groups((k + taps - 1) / taps),
          pw(seg + (groups - 1) * taps),
          raw(taps > 1 ? seg * cin : 0),
          stage_elems(per_stage * ((pw + seg) * WG_RS + raw)) {}
};

// cp.async of 4, 8 or 16 bytes (v = 2, 4 or 8 bf16); when !valid nothing is
// read and zeros are written. v = 1 is a plain load and store.
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* src, int v, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    switch (v) {
        case 8:
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                         :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
            break;
        case 4:
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                         :: "r"(d), "l"(src), "r"(valid ? 8 : 0) : "memory");
            break;
        case 2:
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                         :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
            break;
        default:
            *dst = valid ? *src : __float2bfloat16(0.f);
    }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8, and register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// log2 of the chunks of one staged row rounded up to a power of two (n <= 16):
// chunk k of a unit's rows is chunk k % 2^result of row k >> result
__device__ __forceinline__ int lanes_log2(int n) { return n <= 1 ? 0 : 32 - __clz(n - 1); }

// One slice's products for G tap groups: the dz tile (B, 16 pixels x 16
// outputs) at db, the A tile of group q at xa + q * step; every fragment
// loaded before the first product. TWO: outputs 8..15 too.
template <int K, int G, bool TWO>
__device__ __forceinline__ void slice_products(float (&acc)[K][2][4], const bf16* xa, int step,
                                               const bf16* db) {
    unsigned b[4];
    unsigned a[G][4];
    ldmatrix_x4_trans(b, db);
#pragma unroll
    for (int q = 0; q < G; ++q) ldmatrix_x4_trans(a[q], xa + q * step);
    const unsigned b0[2] = {b[0], b[1]};
    const unsigned b1[2] = {b[2], b[3]};
#pragma unroll
    for (int q = 0; q < G; ++q) {
        mma_bf16(acc[q][0], a[q], b0);
        if (TWO) mma_bf16(acc[q][1], a[q], b1);
    }
}

// slice_products for the block's `groups` (1 <= groups <= K), chosen at run time
template <int K, int G = K>
__device__ __forceinline__ void products(float (&acc)[K][2][4], const bf16* xa, int step,
                                         const bf16* db, int groups, bool two) {
    if constexpr (G > 1) {
        if (groups < G) {
            products<K, G - 1>(acc, xa, step, db, groups, two);
            return;
        }
    }
    if (two) slice_products<K, G, true>(acc, xa, step, db);
    else slice_products<K, G, false>(acc, xa, step, db);
}

template <int K>
__global__ void __launch_bounds__(32 * WG_WARPS)
conv_wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dz,
                       float* __restrict__ dw, long long s_ky, long long s_kx, long long s_c,
                       long long s_o, int batch, int h, int wd, int cin, int cout, int vx,
                       int vd) {
    // this block has started: peers may write into its shared memory once
    // every block of the cluster has arrived here (the wait before the sums)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    extern __shared__ __align__(16) unsigned char wg_smem_raw[];
    bf16* ring = reinterpret_cast<bf16*>(wg_smem_raw);
    constexpr int THREADS = 32 * WG_WARPS;
    constexpr int r = K / 2;
    cg::cluster_group cluster = cg::this_cluster();
    const WgPlan p(batch, h, wd, cin, K);
    const int rank = static_cast<int>(cluster.block_rank());
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int ky = blockIdx.y % K;
    const int cin_tiles = (cin + 15) / 16;
    const int ci0 = (blockIdx.y / K % cin_tiles) * 16;
    const int co0 = (blockIdx.y / K / cin_tiles) * 16;
    const int tid = static_cast<int>(threadIdx.x);
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int u0 = static_cast<int>(static_cast<long long>(p.units) * rank / ranks);
    const int u1 = static_cast<int>(static_cast<long long>(p.units) * (rank + 1) / ranks);
    const int n_st = (u1 - u0 + p.per_stage - 1) / p.per_stage;
    // Packed tap rows (cin < 16) repeat each pixel `taps` times: where each
    // image row is whole in one unit and 16-byte aligned, the row is copied
    // once as it lies, 16 bytes at a time, into the stage's `raw` room and
    // spread into the tap rows there; otherwise tap by tap, in chunks of vx
    // elements (plain loads for odd cin, vx = 1).
    const bool xraw = p.taps > 1 && p.segs == 1 && (wd * cin) % 8 == 0 &&
                      reinterpret_cast<unsigned long long>(x) % 16 == 0;
    const int xv = xraw ? 1 : vx;
    // The staged input and dz rows come in chunks of xv and vd elements,
    // xsubs and dsubs of them per row; the slots beyond are never written,
    // and only feed the rows and columns of products that are not stored
    // (channels >= cin, outputs >= cout). Each unit of a stage is staged by
    // its own 2^ush threads, chunk k of the unit's rows by thread k % 2^ush.
    const int xsubs = (p.taps > 1 ? p.taps * cin : min(16, cin - ci0)) / xv;
    const int dsubs = min(16, cout - co0) / vd;
    const int xsh = lanes_log2(xsubs);
    const int dsh = lanes_log2(dsubs);
    const int ush = 31 - __clz(THREADS / p.per_stage);
    const int uj = tid >> ush;  // this thread's unit of each stage
    const int uk = tid & ((1 << ush) - 1);

    // stage st into ring slot st % WG_STAGES
    auto stage_in = [&](int st) {
        const int u = u0 + st * p.per_stage + uj;
        if (uj >= p.per_stage || u >= u1) return;
        bf16* xs = ring + (st % WG_STAGES) * p.stage_elems + uj * p.pw * WG_RS;
        bf16* ds = ring + (st % WG_STAGES) * p.stage_elems + (p.per_stage * p.pw + uj * p.seg) * WG_RS;
        bf16* raw = ring + (st % WG_STAGES) * p.stage_elems + p.per_stage * (p.pw + p.seg) * WG_RS +
                    uj * p.raw;
        const int q = u / p.segs;  // image row b * h + y
        const int x0 = (u - q * p.segs) * p.seg;
        const int yy = q % h + ky - r;
        const bool row_ok = yy >= 0 && yy < h;
        const bf16* xrow = x + static_cast<long long>(q + ky - r) * wd * cin;
        if (xraw) {  // the image row, zeros outside the image
            for (int i = uk; i < wd * cin / 8; i += 1 << ush)
                stage_chunk(raw + 8 * i, row_ok ? xrow + 8 * i : x, 8, row_ok);
        } else {  // the tap rows, zeros outside the image
            for (int k = uk; k < p.pw << xsh; k += 1 << ush) {
                const int sub = k & ((1 << xsh) - 1);
                if (sub >= xsubs) continue;
                const int s = k >> xsh;
                const int e = sub * xv;  // the chunk's first slot, its tap and channel
                const int tap = p.taps > 1 ? e / cin : 0;
                const int gx = x0 + s + tap - r;
                const bool ok = row_ok && gx >= 0 && gx < wd;
                stage_chunk(xs + s * WG_RS + e,
                            ok ? xrow + gx * cin + (p.taps > 1 ? e - tap * cin : ci0 + e) : x, xv, ok);
            }
        }
        const bf16* drow = dz + static_cast<long long>(q) * wd * cout + co0;
        for (int k = uk; k < p.seg << dsh; k += 1 << ush) {
            const int sub = k & ((1 << dsh) - 1);
            if (sub >= dsubs) continue;
            const int s = k >> dsh;
            const bool ok = x0 + s < wd;
            stage_chunk(ds + s * WG_RS + sub * vd, ok ? drow + (x0 + s) * cout + sub * vd : dz, vd, ok);
        }
    };

    // ldmatrix rows of this lane: A (x^T, 16 channels x 16 pixels) from rows
    // [pixel][channel], B (16 pixels x 16 outputs) from rows [pixel][output]
    const int a_off = ((lane & 7) + (lane >> 4) * 8) * WG_RS + ((lane >> 3) & 1) * 8;
    const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * WG_RS + (lane >> 4) * 8;
    const int spu = p.seg / 16;  // slices per unit
    const bool two = cout - co0 > 8;
    float acc[K][2][4] = {};  // tap group q, outputs co0 + [0, 8) and [8, 16)

    for (int st = 0; st < WG_STAGES - 1; ++st) {
        if (st < n_st) stage_in(st);
        cp_async_commit();
    }
    for (int st = 0; st < n_st; ++st) {
        if (st + WG_STAGES - 1 < n_st) stage_in(st + WG_STAGES - 1);
        cp_async_commit();
        cp_async_wait<WG_STAGES - 1>();  // stage st has landed
        __syncthreads();
        const int n = min(p.per_stage, u1 - u0 - st * p.per_stage);
        bf16* xs = ring + (st % WG_STAGES) * p.stage_elems;
        const bf16* ds = xs + p.per_stage * p.pw * WG_RS;
        if (xraw) {  // spread each raw image row into its tap rows, a row per thread
            const bf16* raw = ds + p.per_stage * p.seg * WG_RS;
            for (int i = tid; i < n * p.pw; i += THREADS) {
                const int j = i / p.pw;
                const int g0 = i - j * p.pw - r;  // the row's first pixel
                const bf16* src = raw + j * p.raw + g0 * cin;
                unsigned short v[16];
                int gx = g0;  // the pixel of slot e: tap e / cin
                int c = 0;
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    v[e] = e < p.taps * cin && gx >= 0 && gx < wd
                               ? *reinterpret_cast<const unsigned short*>(src + e) : 0;
                    if (++c == cin) {
                        c = 0;
                        ++gx;
                    }
                }
                uint4* dst = reinterpret_cast<uint4*>(xs + i * WG_RS);
                dst[0] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                                    v[6] | v[7] << 16);
                dst[1] = make_uint4(v[8] | v[9] << 16, v[10] | v[11] << 16, v[12] | v[13] << 16,
                                    v[14] | v[15] << 16);
            }
            __syncthreads();
        }
        for (int sl = warp; sl < n * spu; sl += WG_WARPS) {
            const int j = sl / spu;
            const int p0 = (sl - j * spu) * 16;
            products<K>(acc, xs + (j * p.pw + p0) * WG_RS + a_off, p.taps * WG_RS,
                        ds + (j * p.seg + p0) * WG_RS + b_off, p.groups, two);
        }
        if (st + WG_STAGES < n_st) __syncthreads();  // slot st % WG_STAGES is staged again
    }

    // the warps' sums added in warp order, then the cluster's in rank order:
    // each block writes its sums into the shared memory of the rank that owns
    // them (a contiguous share, four at a time), past the ring, which a peer
    // may still be using; the owner adds them after one cluster barrier
    __syncthreads();  // every warp is done with the ring
    const int total = p.groups * 256;
    float* part = reinterpret_cast<float*>(wg_smem_raw);  // [WG_WARPS][group q][2 nt][4][32 lanes]
    float* recv = reinterpret_cast<float*>(
        wg_smem_raw + max(2 * WG_STAGES * p.stage_elems, 4 * WG_WARPS * total));  // [ranks][share]
#pragma unroll
    for (int q = 0; q < K; ++q) {
        if (q < p.groups) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
                part[warp * total + (q * 8 + i) * 32 + lane] = acc[q][i / 4][i % 4];
        }
    }
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer has started
    const int share = round_up((total + ranks - 1) / ranks, 4);
    for (int e = 4 * tid; e < total; e += 4 * THREADS) {
        float4 v = *reinterpret_cast<const float4*>(part + e);
        for (int w = 1; w < WG_WARPS; ++w) {
            const float4 u = *reinterpret_cast<const float4*>(part + w * total + e);
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
        }
        const int owner = e / share;
        *reinterpret_cast<float4*>(
            cluster.map_shared_rank(recv + rank * share + e - owner * share, owner)) = v;
    }
    cluster.sync();
    const int e0 = rank * share;
    const int e1 = min(total, e0 + share);
    for (int e = e0 + tid; e < e1; e += THREADS) {
        float v = recv[e - e0];
        for (int q = 1; q < ranks; ++q) v += recv[q * share + e - e0];
        // element (group, nt, i, lane) of the accumulators: A row d, output o
        const int i = (e / 32) % 8;
        const int d = (e % 32) / 4 + (i % 4 >= 2 ? 8 : 0);
        const int o = co0 + 8 * (i / 4) + 2 * (e % 4) + i % 2;
        const int tap = p.taps > 1 ? d / cin : 0;
        const int kx = (e / 256) * p.taps + tap;
        const int c = p.taps > 1 ? d - tap * cin : ci0 + d;
        if (tap < p.taps && kx < K && c < cin && o < cout)
            dw[ky * s_ky + kx * s_kx + c * s_c + o * s_o] = v;
    }
}

struct WgradTag {};

template <int K>
int launch_wgrad(const bf16* x, const bf16* dz, float* dw, long long s_ky, long long s_kx,
                 long long s_c, long long s_o, int batch, int h, int wd, int cin, int cout,
                 int vx, int vd, cudaStream_t stream) {
    const WgPlan p(batch, h, wd, cin, K);
    // at least one stage of units per block
    const int ranks = max(1, min(WG_CLUSTER, (p.units + p.per_stage - 1) / p.per_stage));
    const int total = p.groups * 256;
    const int smem = max(2 * WG_STAGES * p.stage_elems, 4 * WG_WARPS * total) +
                     4 * ranks * round_up((total + ranks - 1) / ranks, 4);
    cudaError_t err = allow_smem(conv_wgrad_bf16_kernel<K>, smem, smem_allowed<WgradTag, K>());
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(ranks),
                       static_cast<unsigned>(K * ((cin + 15) / 16) * ((cout + 15) / 16)), 1);
    cfg.blockDim = dim3(32 * WG_WARPS, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ranks);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, conv_wgrad_bf16_kernel<K>, x, dz, dw, s_ky, s_kx, s_c, s_o,
                             batch, h, wd, cin, cout, vx, vd);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// The widest chunk, in bf16 elements (8, 4, 2 or 1), that divides n and
// keeps every chunk of a tensor of rows of n elements at p aligned to its size.
int chunk_width(int n, const void* p) {
    for (int v = 8; v > 1; v /= 2)
        if (n % v == 0 && reinterpret_cast<std::uintptr_t>(p) % (2 * v) == 0) return v;
    return 1;
}

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
    const int vx = chunk_width(cin, x);
    const int vd = chunk_width(cout, dz);
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
