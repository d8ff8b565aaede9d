// 3xTF32 products on the tensor cores, shared by csrc/conv.cu and csrc/pcg.cu.
//
// TF32 keeps 10 mantissa bits. An fp32 operand a is split into
// big = tf32(a) and small = tf32(a - big), both rounded to nearest on the
// bits (an integer add and a mask), and a*b is accumulated as
// big*big + big*small + small*big, each product in its own accumulator. The
// tensor cores do not round their fp32 sums to nearest, so a long chain of
// products drifts: every few products the three accumulators are added into
// an fp32 total and restarted (`Acc::flush`). The CPU tests emulate this
// split bit for bit (tests/test_torch_conv.py `_tf32`, and
// tests/test_torch_pcg_tf32.py for the preconditioner's products).

#pragma once

namespace silt {

// a = big + small, each rounded to TF32 (10 mantissa bits) to nearest, ties
// away from zero; returned as the bits the mma reads.
__device__ __forceinline__ void split_tf32(float a, unsigned& big, unsigned& small) {
    big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
    small = (__float_as_uint(a - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// d += a (16x8, row-major) * b (8x8, column-major), TF32 in, fp32 out. Lane
// l = 4g + t holds a(g, t), a(g+8, t), a(g, t+4), a(g+8, t+4); b(t, g),
// b(t+4, g); d(g, 2t), d(g, 2t+1), d(g+8, 2t), d(g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 16x8 output tile in 3xTF32: the three products' accumulators and
// their fp32 total.
struct Acc {
    float bb[4], bs[4], sb[4], sum[4];

    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < 4; ++i) bb[i] = bs[i] = sb[i] = sum[i] = 0.f;
    }

    __device__ __forceinline__ void mma(const unsigned (&a_big)[4], const unsigned (&a_small)[4],
                                        const unsigned (&b_big)[2], const unsigned (&b_small)[2]) {
        mma_tf32(bs, a_big, b_small);
        mma_tf32(sb, a_small, b_big);
        mma_tf32(bb, a_big, b_big);
    }

    // adds the three accumulators into the total and restarts them
    __device__ __forceinline__ void flush() {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            sum[i] += bb[i] + (bs[i] + sb[i]);
            bb[i] = bs[i] = sb[i] = 0.f;
        }
    }
};

}  // namespace silt
