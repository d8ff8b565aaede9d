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
// input channel), columns are output channels. A block owns FWD_TH = 8
// image rows x 16 pixels and 16 output channels (two 8-wide mma tiles) and
// has 8 warps. Where Cin >= 16 it stages the input patch (the tile and its
// K-1 halo, 32 channels at a time, zeros outside the image and beyond Cin)
// as [pixel][channel] with 16-byte cp.async, and the weight of every tap as
// [tap][output][channel]: the weight's runs, [outer][inner][tap] as the
// PyTorch parameter and the input gradient's transposed view lie in
// memory, are copied as they lie (the forward's in one copy by the tensor
// memory accelerator, the input gradient's by cp.async) and turned into
// 32-bit words of two channels in shared memory while the patch lands.
// Where Cin < 16 (the stems; the heads' input gradients) the 16 slots of an
// A row are packed taps, 16 / Cin taps of all Cin channels, as the weight
// gradient packs them, so one product covers 5 taps at Cin = 3 where one
// product per tap would leave 13 of its 16 channels zero. A warp owns two
// image rows and every other k-step column (a tap, or tap group, and a
// 16-channel half) over all tap rows, its partner warp the others: the A
// tile of row 2 rp + 1 at tap row ky is that of row 2 rp at ky + 1, so a
// column's K tap rows take K + 1 A tiles and K B tiles (`ldmatrix.x4`, rows
// of 80 or 48 bytes: 8 rows on 8 bank groups) for 4K products, whose sums
// (two rows, two output tiles, two tap-row parities) are eight independent
// chains. The partners add their sums through shared memory, half 0's plus
// half 1's, and the epilogue runs in fp32 on them with the bias and skip
// loaded before the staging; it stores two outputs per 32-bit store.
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
// bytes bound it, barely. `mma.sync` reaches neither. The forward's 80
// blocks take about 7.2 us launch to launch: an empty launch of the same
// grid 1.7, the staging (25.6 KB of weight per block from L2) about 1.5,
// the products about 2.3, their `ldmatrix` traffic 0.55 loads per product
// (chip_smoke.py --conv-split fwd on variants with a part taken out); a
// version with one row per warp and the weight restaged through registers
// in 2-byte stores took 13.6, one that loaded both layouts' runs through a
// select (16 lanes on one bank) 11.2. The weight gradient's
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

// cp.async of 4, 8 or 16 bytes (v = 2, 4 or 8 bf16) of which the first
// `bytes` are read, the rest zeros
__device__ __forceinline__ void cp_async_part(bf16* dst, const bf16* src, int v, int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (v == 8)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(bytes) : "memory");
    else if (v == 4)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(d), "l"(src), "r"(bytes) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// cp.async of v = 2, 4 or 8 bf16; when !valid nothing is read and zeros are
// written. v = 1 is a plain load and store.
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* src, int v, bool valid) {
    if (v == 1)
        *dst = valid ? *src : __float2bfloat16(0.f);
    else
        cp_async_part(dst, src, v, valid ? 2 * v : 0);
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

// Four 8x8 bf16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// two bf16 in one 32-bit word, `lo` in the lower half
__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
           static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The tensor memory accelerator's copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(bf16* dst, const bf16* src, int bytes,
                                          unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Waits until phase `parity` of the mbarrier `bar` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---------------------------------------------------------------- forward

// The forward's tiling. kernels/conv.py `FWD_BF16` holds the same constants
// and `fwd_bf16_plan` the same plan (FwdPlan, launch_fwd);
// tests/test_torch_conv_fwd_bf16_tiles.py checks the two against each other
// and walks the partition on the CPU.
constexpr int FWD_TH = 8;   // image rows per block (and warps: two rows, half the k-steps each)
constexpr int FWD_TW = 16;  // pixels per row: the 16 rows of an A tile
constexpr int FWD_NT = 16;  // output channels per block: two 8-wide mma tiles
constexpr int FWD_CC = 32;  // input channels staged at once, at most
constexpr int FWD_RS = 24;  // bf16 elements per packed row (16 used): 48 bytes

// A block's shared memory, in bf16 elements, and its k-steps. Where cin >=
// 16 ("wide"): the patch [ph][pw][cs] (the tile and its K-1 halo, the cc
// channels of a chunk, then 8 of padding, so 8 pixels of an ldmatrix fall
// on 8 bank groups), the weight [K*K taps][FWD_NT outputs][cs] and room
// (`raw`) for the weight's runs as they lie in memory. Where cin < 16
// ("packed"): the A rows [ph][groups][FWD_TW][FWD_RS], row (ry, q, px)
// holding `taps` taps of all cin channels, [tap * cin + c] = x(row ry,
// pixel px + q * taps + tap, c), zero beyond taps * cin and beyond K, and
// the weight [K][groups][FWD_NT][FWD_RS] in the same order; so one product
// covers 5 taps at cin = 3 and 4 at cin = 4, where one product per tap
// would leave 12-13 of its 16 channels zero. A tap row has `nkx` columns of
// k-steps (taps, or tap groups) and `per_ky` k-steps (two per column where
// a wide chunk has 32 channels).
struct FwdPlan {
    int packed, taps, groups, cc, cs, ph, pw, nkx, per_ky, patch, weight, raw;

    __host__ __device__ FwdPlan(int cin, int k)
        : packed(cin < 16),
          taps(cin < 16 ? 16 / max(cin, 1) : 1),
          groups((k + taps - 1) / taps),
          cc(cin < 16 ? 16 : min(round_up(cin, 16), FWD_CC)),
          cs(cin < 16 ? FWD_RS : cc + 8),
          ph(FWD_TH + k - 1),
          pw(cin < 16 ? groups * FWD_TW : FWD_TW + k - 1),
          nkx(cin < 16 ? groups : k),
          per_ky(cin < 16 ? groups : k * (cc / 16)),
          patch(ph * pw * cs),
          weight(k * nkx * FWD_NT * cs),
          raw(cin < 16 ? 0 : max(FWD_NT * round_up(cc * k * k, 8), cc * round_up(FWD_NT * k * k, 8))) {}
};

// The bytes of a block's tiles, at least the room where the two halves of
// its warps exchange their sums; its mbarrier lies past them.
__host__ __device__ inline int fwd_smem_bytes(const FwdPlan& p) {
    return max(2 * (p.patch + p.weight + p.raw), 4 * FWD_TH * 8 * 32);
}

// The wide weight ws[(tap * FWD_NT + o) * cs + c] for the chunk's channels
// c < cc and the block's outputs o, in 32-bit words of channels (c, c + 1),
// zeros where c >= cin_left or o >= cout_left. elem(c, o, tap) is the
// weight element of tap `tap` (as the products read it: flipped already),
// channel c and output o of the chunk and block. A thread takes one (output,
// channel pair) at a time, over every tap, a tap row's loads before its
// stores; neighbouring threads take neighbouring inner indices of the
// source (`inner_c`: channel pairs, else outputs).
template <int K, class Elem>
__device__ __forceinline__ void weight_words(bf16* ws, int cs, int cc, int cin_left,
                                             int cout_left, bool inner_c, Elem elem) {
    constexpr int THREADS = 32 * FWD_TH;
    const bf16 zero = __float2bfloat16(0.f);
    const int pairs = cc / 2;
    unsigned* wsw = reinterpret_cast<unsigned*>(ws);
    for (int task = threadIdx.x; task < FWD_NT * pairs; task += THREADS) {
        const int o = inner_c ? task / pairs : task % FWD_NT;
        const int c = 2 * (inner_c ? task % pairs : task / FWD_NT);
        const bool ok0 = c < cin_left && o < cout_left;
        const bool ok1 = c + 1 < cin_left && o < cout_left;
        for (int ky = 0; ky < K; ++ky) {
            bf16 lo[K], hi[K];
#pragma unroll
            for (int kx = 0; kx < K; ++kx) {
                lo[kx] = ok0 ? elem(c, o, ky * K + kx) : zero;
                hi[kx] = ok1 ? elem(c + 1, o, ky * K + kx) : zero;
            }
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
                wsw[(((ky * K + kx) * FWD_NT + o) * cs + c) / 2] = pack2(lo[kx], hi[kx]);
        }
    }
}

// Stages one chunk of a wide block: the patch (channels [c0, c0 + cc),
// zeros outside the image and beyond cin), 16 bytes per cp.async with
// `vec`, and the weight of every tap for those channels and the block's
// outputs. Where the weight is [outer][inner][tap] in memory (the PyTorch
// parameter, and the input gradient's transposed view) and `wv` elements
// divide each outer index's run and its alignment, its runs are copied as
// they lie before the patch: in one copy by the tensor memory accelerator
// where they lie one after another, as the forward's do (phase `chunk` % 2
// of the mbarrier `bar`), else by cp.async; they are turned into words of
// two channels while the patch lands. Otherwise (wv = 1) the weight is read
// through its strides. Ends with both in place (the caller syncs).
template <int K>
__device__ __forceinline__ void stage_wide(bf16* xs, bf16* ws, bf16* raw,
                                           unsigned long long* bar, int chunk, const FwdPlan& p,
                                           const bf16* xb, const Weight& w, int h, int wd,
                                           int cin, int cout, int y0, int x0, int c0, int co0,
                                           int vec, int wv) {
    constexpr int KK = K * K;
    constexpr int R = K / 2;
    constexpr int PH = FWD_TH + K - 1;
    constexpr int PW = FWD_TW + K - 1;
    constexpr int THREADS = 32 * FWD_TH;
    const bf16 zero = __float2bfloat16(0.f);
    const bool c_inner = w.s_c <= w.s_o;
    const int n_in = c_inner ? p.cc : FWD_NT;  // the inner extent of a run
    const int stride = round_up(n_in * KK, 8);  // a run's room in `raw`
    const int in0 = c_inner ? c0 : co0;
    const int out0 = c_inner ? co0 : c0;
    const int run = min(n_in, (c_inner ? cin : cout) - in0) * KK;
    const int n_out = min(c_inner ? FWD_NT : p.cc, (c_inner ? cout : cin) - out0);
    const long long s_out = c_inner ? w.s_o : w.s_c;
    // the runs one after another in memory, 16-byte aligned, as they lie in `raw`
    const bool bulk = wv == 8 && run == stride && s_out == run;
    if (bulk) {  // one copy by the tensor memory accelerator, issued by one thread
        if (threadIdx.x == 0) {
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         :: "r"(smem_u32(bar)), "r"(2 * n_out * run) : "memory");
            bulk_copy(raw, w.p + out0 * s_out + static_cast<long long>(in0) * KK, 2 * n_out * run,
                      bar);
        }
    } else if (wv > 1) {
        const int vecs = (run + wv - 1) / wv;
        for (int i = threadIdx.x; i < n_out * vecs; i += THREADS) {
            const int q = i / vecs;
            const int e = (i - q * vecs) * wv;
            cp_async_part(raw + q * stride + e,
                          w.p + (out0 + q) * s_out + static_cast<long long>(in0) * KK + e, wv,
                          2 * min(wv, run - e));
        }
    }
    cp_async_commit();
    if (vec) {  // cin is a multiple of 8
        const int sh = p.cc == 32 ? 2 : 1;  // log2 of the 16-byte copies per pixel
        for (int i = threadIdx.x; i < PH * PW << sh; i += THREADS) {
            const int pos = i >> sh;
            const int c = (i & ((1 << sh) - 1)) * 8;
            const int gy = y0 + pos / PW - R;
            const int gx = x0 + pos % PW - R;
            const bool ok = c0 + c < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd;
            stage_chunk(xs + pos * p.cs + c,
                        ok ? xb + (static_cast<long long>(gy) * wd + gx) * cin + c0 + c : xb, 8, ok);
        }
    } else {  // element by element, each thread's 8 loads in flight before its stores
        const int n = PH * PW * p.cc;
        for (int i0 = threadIdx.x; i0 < n; i0 += 8 * THREADS) {
            bf16 v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int i = i0 + u * THREADS;
                const int pos = i / p.cc;
                const int c = i - pos * p.cc;
                const int gy = y0 + pos / PW - R;
                const int gx = x0 + pos % PW - R;
                const bool ok = i < n && c0 + c < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd;
                v[u] = ok ? __ldg(xb + (static_cast<long long>(gy) * wd + gx) * cin + c0 + c) : zero;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int i = i0 + u * THREADS;
                if (i < n) xs[i / p.cc * p.cs + i % p.cc] = v[u];
            }
        }
    }
    cp_async_commit();
    if (wv == 1) {
        weight_words<K>(ws, p.cs, p.cc, cin - c0, cout - co0, c_inner, [&](int c, int o, int t) {
            const int tap = w.flip ? KK - 1 - t : t;
            return __ldg(w.p + (tap / K) * w.s_ky + (tap % K) * w.s_kx + (c0 + c) * w.s_c +
                         (co0 + o) * w.s_o);
        });
    } else {
        if (bulk)
            mbar_wait(bar, chunk & 1);
        else
            cp_async_wait<1>();
        __syncthreads();  // the runs have landed
        // one accessor per layout: a select of the two would load both
        if (c_inner)
            weight_words<K>(ws, p.cs, p.cc, cin - c0, cout - co0, true, [&](int c, int o, int t) {
                return raw[o * stride + c * KK + (w.flip ? KK - 1 - t : t)];
            });
        else
            weight_words<K>(ws, p.cs, p.cc, cin - c0, cout - co0, false, [&](int c, int o, int t) {
                return raw[c * stride + o * KK + (w.flip ? KK - 1 - t : t)];
            });
    }
    cp_async_wait<0>();
}

// Stages a packed block (cin < 16): its A rows and its weight, element by
// element through the strides, each thread's loads in flight together.
template <int K>
__device__ __forceinline__ void stage_packed(bf16* xs, bf16* ws, const FwdPlan& p, const bf16* xb,
                                             const Weight& w, int h, int wd, int cin, int cout,
                                             int y0, int x0, int co0) {
    constexpr int R = K / 2;
    constexpr int THREADS = 32 * FWD_TH;
    const bf16 zero = __float2bfloat16(0.f);
    for (int row = threadIdx.x; row < p.ph * p.pw; row += THREADS) {
        const int px = row % FWD_TW;
        const int q = (row / FWD_TW) % p.groups;
        const int gy = y0 + row / p.pw - R;
        const bool row_ok = gy >= 0 && gy < h;
        const bf16* src = xb + static_cast<long long>(row_ok ? gy : 0) * wd * cin;
        unsigned v[16];
        int tap = 0;
        int c = 0;
#pragma unroll
        for (int d = 0; d < 16; ++d) {  // slot d: tap d / cin, channel d % cin
            const int kx = q * p.taps + tap;
            const int gx = x0 + px + kx - R;
            const bool ok = row_ok && tap < p.taps && kx < K && gx >= 0 && gx < wd;
            v[d] = ok ? __bfloat16_as_ushort(__ldg(src + gx * cin + c)) : 0u;
            if (++c == cin) {
                c = 0;
                ++tap;
            }
        }
        uint4* dst = reinterpret_cast<uint4*>(xs + row * FWD_RS);
        dst[0] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                            v[6] | v[7] << 16);
        dst[1] = make_uint4(v[8] | v[9] << 16, v[10] | v[11] << 16, v[12] | v[13] << 16,
                            v[14] | v[15] << 16);
    }
    // the weight [ky][q][o][d] in words of slots (d, d + 1)
    unsigned* wsw = reinterpret_cast<unsigned*>(ws);
    for (int i = threadIdx.x; i < K * p.groups * FWD_NT * 8; i += THREADS) {
        const int dp = i % 8;
        const int o = (i / 8) % FWD_NT;
        const int kq = i / (8 * FWD_NT);  // ky * groups + q
        const int ky = kq / p.groups;
        const int q = kq - ky * p.groups;
        bf16 e[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int tap = (2 * dp + u) / cin;
            const int c = 2 * dp + u - tap * cin;
            const int kx = q * p.taps + tap;
            const bool ok = tap < p.taps && kx < K && co0 + o < cout;
            const int wy = w.flip ? K - 1 - ky : ky;
            const int wx = w.flip ? K - 1 - kx : kx;
            e[u] = ok ? __ldg(w.p + wy * w.s_ky + wx * w.s_kx + c * w.s_c + (co0 + o) * w.s_o)
                      : zero;
        }
        wsw[(kq * FWD_NT + o) * FWD_RS / 2 + dp] = pack2(e[0], e[1]);
    }
}

template <int K>
__global__ void __launch_bounds__(32 * FWD_TH, 1)
conv_fwd_bf16_kernel(const bf16* __restrict__ x, Weight w, const bf16* __restrict__ bias,
                     const bf16* __restrict__ skip, bf16* __restrict__ y, int h, int wd,
                     int cin, int cout, int act, float slope, int vec, int wv) {
    extern __shared__ __align__(16) unsigned char fwd_smem_raw[];
    const FwdPlan p(cin, K);
    bf16* xs = reinterpret_cast<bf16*>(fwd_smem_raw);
    bf16* ws = xs + p.patch;
    bf16* raw = ws + p.weight;
    // the mbarrier of the weight's bulk copies, past everything else
    unsigned long long* bar = reinterpret_cast<unsigned long long*>(
        fwd_smem_raw + fwd_smem_bytes(p));
    if (!p.packed) {
        if (threadIdx.x == 0) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
    }

    const int tiles_x = (wd + FWD_TW - 1) / FWD_TW;
    const int tiles_y = (h + FWD_TH - 1) / FWD_TH;
    const int tx = blockIdx.x % tiles_x;
    const int ty = (blockIdx.x / tiles_x) % tiles_y;
    const long long b = blockIdx.x / (tiles_x * tiles_y);
    const int y0 = ty * FWD_TH;
    const int x0 = tx * FWD_TW;
    const int co0 = blockIdx.y * FWD_NT;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const bf16* xb = x + b * h * wd * cin;
    const bool two = cout - co0 > 8;

    // ldmatrix rows of this lane: A (16 pixels x 16 channels) from rows
    // [pixel][channel], B (16 outputs x 16 channels) from rows [output][channel]
    const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * p.cs + (lane >> 4) * 8;
    const int b_lane = ((lane & 7) + (lane >> 4) * 8) * p.cs + ((lane >> 3) & 1) * 8;
    // k-step column j of every tap row: tap (or tap group) j >> sh, 16-channel
    // half j & sh of the chunk
    const int sh = p.per_ky / p.nkx - 1;
    const int a_kx = p.packed ? FWD_TW * p.cs : p.cs;
    const int a_row = p.pw * p.cs;
    const int b_kx = FWD_NT * p.cs;
    const int b_ky = p.nkx * b_kx;
    // this warp's two image rows of the tile (2 rp, 2 rp + 1), and its half
    // of the columns: every other one; where their number is odd, the last
    // column's tap rows [0, (K + 1) / 2) to half 0 and the rest to half 1
    const int rp = warp % (FWD_TH / 2);
    const int half = warp / (FWD_TH / 2);
    const int n_even = p.per_ky & ~1;
    const int n_units = n_even / 2 + (p.per_ky & 1);

    // the epilogue's row, pixels (lane / 4 + 8 hf) and outputs (8 nt + 2 (lane % 4) + e),
    // and its bias and skip, loaded before the staging so that they are in
    // place when the sums are
    const int gy = y0 + 2 * rp + half;
    const int g = lane / 4;
    const int t = lane % 4;
    float pre_bias[2][2] = {}, pre_skip[2][2][2] = {};  // [nt][e], [nt][hf][e]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int o = co0 + 8 * nt + 2 * t + e;
            if (bias != nullptr && o < cout) pre_bias[nt][e] = __bfloat162float(bias[o]);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int gx = x0 + g + 8 * hf;
                if (skip != nullptr && o < cout && gy < h && gx < wd)
                    pre_skip[nt][hf][e] =
                        __bfloat162float(skip[((b * h + gy) * wd + gx) * cout + o]);
            }
        }
    }

    // [row 2 rp + r][bank: tap row parity][outputs co0 + [0, 8), [8, 16)]
    float acc[2][2][2][4] = {};
    for (int c0 = 0, chunk = 0; c0 < cin; c0 += p.cc, ++chunk) {
        if (c0 > 0) __syncthreads();  // the previous chunk's readers are done
        if (p.packed)
            stage_packed<K>(xs, ws, p, xb, w, h, wd, cin, cout, y0, x0, co0);
        else
            stage_wide<K>(xs, ws, raw, bar, chunk, p, xb, w, h, wd, cin, cout, y0, x0, c0, co0,
                          vec, wv);
        __syncthreads();
        // a unit is one column over tap rows [k0, k1): A tiles of image rows
        // 2 rp + k0 .. 2 rp + k1 (row 2 rp + 1 at tap row ky is row 2 rp at
        // ky + 1: loaded once), B tiles of tap rows k0 .. k1 - 1, all loaded
        // before the products; the sums of the two rows, the two output
        // tiles and the two banks are eight independent chains
        for (int u = 0; u < n_units; ++u) {
            const bool split = 2 * u == n_even;  // the odd last column
            const int j = split ? n_even : 2 * u + half;
            const int k0 = split && half == 1 ? (K + 1) / 2 : 0;
            const int k1 = split && half == 0 ? (K + 1) / 2 : K;
            const bf16* ak = xs + 2 * rp * a_row + (j >> sh) * a_kx + (j & sh) * 16 + a_lane;
            const bf16* bk = ws + (j >> sh) * b_kx + (j & sh) * 16 + b_lane;
            unsigned af[K + 1][4], bw[K][4];
#pragma unroll
            for (int i = 0; i <= K; ++i)
                if (i >= k0 && i <= k1) ldmatrix_x4(af[i], ak + i * a_row);
#pragma unroll
            for (int i = 0; i < K; ++i)
                if (i >= k0 && i < k1) ldmatrix_x4(bw[i], bk + i * b_ky);
#pragma unroll
            for (int i = 0; i < K; ++i) {
                if (i >= k0 && i < k1) {
                    const unsigned b0[2] = {bw[i][0], bw[i][1]};
                    const unsigned b1[2] = {bw[i][2], bw[i][3]};
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        mma_bf16(acc[r][i & 1][0], af[i + r], b0);
                        if (two) mma_bf16(acc[r][i & 1][1], af[i + r], b1);
                    }
                }
            }
        }
    }

    // the two halves' sums: each warp hands the sums of the row its partner
    // finishes (row 2 rp + 1 - half) through shared memory and finishes row
    // 2 rp + half, half 0's sums plus half 1's
    float own[2][4], other[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float r0 = acc[0][0][nt][e] + acc[0][1][nt][e];
            const float r1 = acc[1][0][nt][e] + acc[1][1][nt][e];
            own[nt][e] = half == 0 ? r0 : r1;
            other[nt][e] = half == 0 ? r1 : r0;
        }
    }
    __syncthreads();  // every warp is done with the staged tiles
    float* red = reinterpret_cast<float*>(fwd_smem_raw);  // [rp][half][8 sums][32 lanes]
#pragma unroll
    for (int i = 0; i < 8; ++i) red[((rp * 2 + half) * 8 + i) * 32 + lane] = other[i / 4][i % 4];
    __syncthreads();
    float v[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float peer = red[((rp * 2 + 1 - half) * 8 + i) * 32 + lane];
        v[i / 4][i % 4] = half == 0 ? own[i / 4][i % 4] + peer : peer + own[i / 4][i % 4];
    }

    // epilogue in fp32 (conv_kernel.py `_epilogue`): + bias, + skip,
    // activation; one rounding to bf16 at the store, two outputs per 32-bit
    // store where cout is even
    if (gy >= h) return;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
        const int o = co0 + 8 * nt + 2 * t;
        if (o >= cout) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int gx = x0 + g + 8 * hf;
            if (gx >= wd) continue;
            const long long at = ((b * h + gy) * wd + gx) * cout + o;
            bf16 out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float z = v[nt][2 * hf + e];
                if (bias != nullptr) z += pre_bias[nt][e];
                if (skip != nullptr) z += pre_skip[nt][hf][e];
                if (act == ACT_RELU) z = fmaxf(z, 0.f);
                else if (act == ACT_LEAKY) z = z >= 0.f ? z : slope * z;
                out[e] = __float2bfloat16_rn(z);
            }
            if (cout % 2 == 0) {
                *reinterpret_cast<unsigned*>(y + at) = pack2(out[0], out[1]);
            } else {
                y[at] = out[0];
                if (o + 1 < cout) y[at + 1] = out[1];
            }
        }
    }
}

struct FwdTag {};

template <int K>
int launch_fwd(const bf16* x, const Weight& w, const bf16* bias, const bf16* skip, bf16* y,
               int batch, int h, int wd, int cin, int cout, int act, float slope, int vec,
               int wv, cudaStream_t stream) {
    const FwdPlan p(cin, K);
    const int smem = fwd_smem_bytes(p) + 16;
    const cudaError_t err =
        allow_smem(conv_fwd_bf16_kernel<K>, smem, smem_allowed<FwdTag, K>());
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = ((h + FWD_TH - 1) / FWD_TH) * ((wd + FWD_TW - 1) / FWD_TW);
    const dim3 grid(static_cast<unsigned>(batch * tiles),
                    static_cast<unsigned>((cout + FWD_NT - 1) / FWD_NT));
    conv_fwd_bf16_kernel<K><<<grid, 32 * FWD_TH, smem, stream>>>(x, w, bias, skip, y, h, wd, cin,
                                                                 cout, act, slope, vec, wv);
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
    const Weight wt{static_cast<const bf16*>(w), s_ky, s_kx, s_c, s_o, flip};
    const int vec = cin % 8 == 0 && aligned16(x);
    // the weight as [outer][inner][tap]: copied as it lies, the widest chunk
    // (8, 4 or 2 elements) that divides the outer stride and the alignment
    const long long kk = static_cast<long long>(k) * k;
    const long long s_in = s_c <= s_o ? s_c : s_o;
    const long long s_out = s_c <= s_o ? s_o : s_c;
    const int wv = s_kx == 1 && s_ky == k && s_in == kk ? chunk_width(static_cast<int>(s_out % 8), w)
                                                        : 1;
    const auto* xb = static_cast<const bf16*>(x);
    const auto* bb = static_cast<const bf16*>(bias);
    const auto* sb = static_cast<const bf16*>(skip);
    auto* yb = static_cast<bf16*>(y);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SILT_FWD(K) \
    launch_fwd<K>(xb, wt, bb, sb, yb, batch, h, wd, cin, cout, act, slope, vec, wv, st)
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
