// The multigrid V-cycle of the masked pressure solve: hand-written Hopper
// (sm_90a) kernels, one launch per level and direction.
//
// Replaces no TPU kernel. The JAX package's V-cycle
// (solver_in_the_loop_tpu/ops/multigrid.py `_v_cycle`) is plain XLA ops, and
// so is the port's twin, ops/multigrid.py `_v_cycle`, which the CPU runs. On
// the card that twin is ~600 small elementwise and reduction kernels an
// apply at (6, 256, 128); these kernels do the same apply in 2 (L - 1) + 1
// launches for a hierarchy of L levels (9 at 256x128, 11 at 384x192).
//
// The cycle, from zero, for the right-hand side b_l of level l, with the
// damped-Jacobi sweep  x <- x + (omega * (b - A x)) / diag  (SWEEPS of them
// each way, 2):
//
//   mg_down  (each level l above the coarsest): x_l = SWEEPS sweeps from 0;
//            b_{l+1} = restrict(b_l - A x_l) * [fluid_{l+1} > 0]
//   mg_coarse (the coarsest): x = SWEEPS + COARSE_SWEEPS sweeps from 0
//   mg_up    (each level l, from the coarsest up): x = x_l + prolong(e) *
//            [fluid_l > 0], e the level below's result; then SWEEPS sweeps
//
// A x is ops/stencils.py `masked_laplacian` under the fluid mask:
// where(fluid > 0, -div(face_mask * grad x), x), with x = 0 outside the
// field (the OPEN boundary's Dirichlet-0 ghosts). restrict is the 2x2 sum
// in the order (r00 + r01) + (r10 + r11) (row, column); prolong repeats a
// coarse value into its 2x2 children.
//
// Design. mg_down and mg_up each take a TILE_Y x TILE_X tile of one batch
// element's level-l cells per block, its origin a multiple of the tile, so
// every 2x2 parent lies inside one tile (the levels above the coarsest have
// even sides). The block stages the tile and a halo of HALO = SWEEPS cells
// in shared memory: b, the smoother's diagonal, the fluid mask and the face
// masks around every staged cell. Each sweep shrinks the region it is exact
// on by one cell, and the halo is recomputed by every block that needs it,
// so the sweeps run between block barriers with no traffic to device memory:
// mg_down sweeps from zero on the whole staged region (the zero iterate
// needs no neighbour), then on the region less one cell, and forms the
// residual and its 2x2 sums on the tile; mg_up stages x + prolong(e) on the
// whole region and sweeps on the region less one cell, then on the tile.
// Cells outside the field stay 0. Ragged tiles are masked. mg_coarse holds
// the whole coarsest level of one batch element in one block (16x8 at
// 256x128, 12x6 at 384x192), its iterate in shared memory when two copies
// fit (else in scratch that the wrapper allocates), a block barrier between
// sweeps. The launch grids are the wrapper's plan (kernels/vcycle.py
// `level_plan`), which mirrors TILE_Y, TILE_X and COARSE_SMEM_MAX.
//
// What bounds it on the H100. An apply at (6, 256, 128) has to read b and
// every level's masks and diagonal and write its result: 2.3 MB, 0.68 us at
// 3.35 TB/s (chip_smoke.py `vcycle_bound_ms`); the nine passes move ~7 MB
// between them, all of it in L2, and ~60 operations a cell and sweep. It is
// bound by latency: nine dependent launches, each a chain of a staged load,
// SWEEPS barriers and a store. Measured by chip_smoke.py (`vcycle_kernel`)
// on an NVIDIA H100 80GB HBM3 at a 700 W power limit: 0.052 ms an apply
// replayed from its CUDA graph at (6, 256, 128), against 0.909 ms for a
// graph of the plain ops; 0.058 against 0.876 ms at (1, 384, 192).
//
// Numerics. Every multiply, add, subtract and divide is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; the file is built with
// --fmad=false) in the order of the plain ops of ops/multigrid.py: the face
// gradient, times the face mask, the two differences and their sum, its
// negation under the fluid mask, b minus it, omega times that, over the
// diagonal, plus x. So the kernels give the plain `_v_cycle` on the card bit
// for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_Y = 16;
constexpr int TILE_X = 32;
constexpr int SWEEPS = 2;  // pre- and post-smoothing sweeps of every level
constexpr int COARSE_SWEEPS = 8;  // the extra sweeps of the coarsest level
constexpr int HALO = SWEEPS;
constexpr int RY = TILE_Y + 2 * HALO;  // staged region: the tile and its halo
constexpr int RX = TILE_X + 2 * HALO;
constexpr int THREADS = 256;
// the most shared memory a block may take (the H100's 227 KB); a coarsest
// level whose two iterates need more is swept in the wrapper's scratch
constexpr int COARSE_SMEM_MAX = 232448;

struct Masks {
    const float* fluid;   // (ny, nx)
    const float* face_u;  // (ny, nx + 1)
    const float* face_v;  // (ny + 1, nx)
    const float* diag;    // (ny, nx), the smoother's diagonal
    int ny, nx;
};

// A x at one cell: where(fluid > 0, -div(mask * grad x), x), from the cell's
// value, its four neighbours' (west, east, north = row above, south) and the
// masks of its four faces.
__device__ __forceinline__ float apply_a(float xc, float xw, float xe, float xn, float xs,
                                         float fluid, float uw, float ue, float vn, float vs) {
    const float du = __fsub_rn(__fmul_rn(__fsub_rn(xe, xc), ue), __fmul_rn(__fsub_rn(xc, xw), uw));
    const float dv = __fsub_rn(__fmul_rn(__fsub_rn(xs, xc), vs), __fmul_rn(__fsub_rn(xc, xn), vn));
    const float lp = __fadd_rn(du, dv);
    return fluid > 0.0f ? -lp : xc;
}

// x + (omega * (b - ax)) / diag
__device__ __forceinline__ float relax(float x, float b, float ax, float diag, float omega) {
    return __fadd_rn(x, __fdiv_rn(__fmul_rn(omega, __fsub_rn(b, ax)), diag));
}

// A tile's staged region in shared memory: row ly, column lx of the region
// is cell (y0 - HALO + ly, x0 - HALO + lx) of the level.
struct Region {
    float b[RY][RX];
    float diag[RY][RX];
    float fluid[RY][RX];
    float u[RY][RX + 1];  // u[ly][lx] the west face of cell (ly, lx), u[ly][lx + 1] its east
    float v[RY + 1][RX];  // v[ly][lx] the north face, v[ly + 1][lx] the south
    float x[2][RY][RX];   // two iterates; 0 outside the field
};

__device__ __forceinline__ bool inside(int y, int x, int ny, int nx) {
    return y >= 0 && y < ny && x >= 0 && x < nx;
}

// Stage b, the diagonal and the masks of the tile at (y0, x0) and its halo;
// 0 outside the field.
__device__ void stage(Region& s, const float* b, const Masks& m, int y0, int x0) {
    const int ny = m.ny, nx = m.nx;
    for (int i = threadIdx.x; i < RY * RX; i += blockDim.x) {
        const int ly = i / RX, lx = i % RX, gy = y0 - HALO + ly, gx = x0 - HALO + lx;
        const bool in = inside(gy, gx, ny, nx);
        const int g = gy * nx + gx;
        s.b[ly][lx] = in ? b[g] : 0.0f;
        s.diag[ly][lx] = in ? __ldg(m.diag + g) : 1.0f;
        s.fluid[ly][lx] = in ? __ldg(m.fluid + g) : 0.0f;
    }
    for (int i = threadIdx.x; i < RY * (RX + 1); i += blockDim.x) {
        const int ly = i / (RX + 1), lx = i % (RX + 1), gy = y0 - HALO + ly, gx = x0 - HALO + lx;
        const bool in = gy >= 0 && gy < ny && gx >= 0 && gx <= nx;
        s.u[ly][lx] = in ? __ldg(m.face_u + gy * (nx + 1) + gx) : 0.0f;
    }
    for (int i = threadIdx.x; i < (RY + 1) * RX; i += blockDim.x) {
        const int ly = i / RX, lx = i % RX, gy = y0 - HALO + ly, gx = x0 - HALO + lx;
        const bool in = gy >= 0 && gy <= ny && gx >= 0 && gx < nx;
        s.v[ly][lx] = in ? __ldg(m.face_v + gy * nx + gx) : 0.0f;
    }
}

// A x at region cell (ly, lx) of iterate `it`, whose neighbours are staged
__device__ __forceinline__ float region_a(const Region& s, int it, int ly, int lx) {
    const auto& x = s.x[it];
    return apply_a(x[ly][lx], x[ly][lx - 1], x[ly][lx + 1], x[ly - 1][lx], x[ly + 1][lx],
                   s.fluid[ly][lx], s.u[ly][lx], s.u[ly][lx + 1], s.v[ly][lx], s.v[ly + 1][lx]);
}

// One sweep from iterate `from` into 1 - from on the region cells at most
// `reach` cells from the tile; cells outside the field stay 0.
__device__ void sweep(Region& s, int from, int reach, int y0, int x0, const Masks& m,
                      float omega) {
    const int h = RY - 2 * (HALO - reach), w = RX - 2 * (HALO - reach);
    for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
        const int ly = HALO - reach + i / w, lx = HALO - reach + i % w;
        float out = 0.0f;
        if (inside(y0 - HALO + ly, x0 - HALO + lx, m.ny, m.nx))
            out = relax(s.x[from][ly][lx], s.b[ly][lx], region_a(s, from, ly, lx),
                        s.diag[ly][lx], omega);
        s.x[1 - from][ly][lx] = out;
    }
}

// Down: SWEEPS sweeps from zero on level l, then the residual's 2x2 sums
// under the coarse fluid mask: x_l into x, b_{l+1} into bc.
__global__ void __launch_bounds__(THREADS) mg_down_kernel(const float* __restrict__ b,
        Masks m, const float* __restrict__ fluid_c, float* __restrict__ x,
        float* __restrict__ bc, float omega) {
    __shared__ Region s;
    const int y0 = blockIdx.y * TILE_Y, x0 = blockIdx.x * TILE_X;
    const size_t plane = static_cast<size_t>(m.ny) * m.nx;
    b += blockIdx.z * plane;
    x += blockIdx.z * plane;
    bc += blockIdx.z * plane / 4;
    stage(s, b, m, y0, x0);
    __syncthreads();
    // the first sweep from zero: A 0 needs no neighbour, so it covers the
    // whole staged region
    for (int i = threadIdx.x; i < RY * RX; i += blockDim.x) {
        const int ly = i / RX, lx = i % RX;
        float out = 0.0f;
        if (inside(y0 - HALO + ly, x0 - HALO + lx, m.ny, m.nx)) {
            const float ax = apply_a(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, s.fluid[ly][lx], s.u[ly][lx],
                                     s.u[ly][lx + 1], s.v[ly][lx], s.v[ly + 1][lx]);
            out = relax(0.0f, s.b[ly][lx], ax, s.diag[ly][lx], omega);
        }
        s.x[0][ly][lx] = out;
    }
    int it = 0;
    for (int k = 2; k <= SWEEPS; ++k) {
        __syncthreads();
        sweep(s, it, HALO + 1 - k, y0, x0, m, omega);
        it = 1 - it;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TILE_Y * TILE_X; i += blockDim.x) {
        const int ty = i / TILE_X, tx = i % TILE_X;
        if (inside(y0 + ty, x0 + tx, m.ny, m.nx))
            x[(y0 + ty) * m.nx + x0 + tx] = s.x[it][HALO + ty][HALO + tx];
    }
    const int cny = m.ny / 2, cnx = m.nx / 2;
    for (int i = threadIdx.x; i < (TILE_Y / 2) * (TILE_X / 2); i += blockDim.x) {
        const int cy = y0 / 2 + i / (TILE_X / 2), cx = x0 / 2 + i % (TILE_X / 2);
        if (!inside(cy, cx, cny, cnx)) continue;
        const int ly = HALO + 2 * cy - y0, lx = HALO + 2 * cx - x0;
        float r[2][2];
        for (int dy = 0; dy < 2; ++dy)
            for (int dx = 0; dx < 2; ++dx)
                r[dy][dx] = __fsub_rn(s.b[ly + dy][lx + dx], region_a(s, it, ly + dy, lx + dx));
        const float sum = __fadd_rn(__fadd_rn(r[0][0], r[0][1]), __fadd_rn(r[1][0], r[1][1]));
        bc[cy * cnx + cx] = __fmul_rn(sum, __ldg(fluid_c + cy * cnx + cx) > 0.0f ? 1.0f : 0.0f);
    }
}

// Up: x_l + prolong(e) under the fluid mask, then SWEEPS sweeps; into out.
__global__ void __launch_bounds__(THREADS) mg_up_kernel(const float* __restrict__ xl,
        const float* __restrict__ e, const float* __restrict__ b, Masks m,
        float* __restrict__ out, float omega) {
    __shared__ Region s;
    const int y0 = blockIdx.y * TILE_Y, x0 = blockIdx.x * TILE_X;
    const int cnx = m.nx / 2;
    const size_t plane = static_cast<size_t>(m.ny) * m.nx;
    xl += blockIdx.z * plane;
    b += blockIdx.z * plane;
    out += blockIdx.z * plane;
    e += blockIdx.z * plane / 4;
    stage(s, b, m, y0, x0);
    for (int i = threadIdx.x; i < RY * RX; i += blockDim.x) {
        const int ly = i / RX, lx = i % RX, gy = y0 - HALO + ly, gx = x0 - HALO + lx;
        float v = 0.0f;
        if (inside(gy, gx, m.ny, m.nx)) {
            const float mask = __ldg(m.fluid + gy * m.nx + gx) > 0.0f ? 1.0f : 0.0f;
            v = __fadd_rn(xl[gy * m.nx + gx], __fmul_rn(e[(gy / 2) * cnx + gx / 2], mask));
        }
        s.x[0][ly][lx] = v;
    }
    int it = 0;
    for (int k = 1; k < SWEEPS; ++k) {
        __syncthreads();
        sweep(s, it, HALO - k, y0, x0, m, omega);
        it = 1 - it;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TILE_Y * TILE_X; i += blockDim.x) {
        const int ty = i / TILE_X, tx = i % TILE_X, ly = HALO + ty, lx = HALO + tx;
        if (inside(y0 + ty, x0 + tx, m.ny, m.nx))
            out[(y0 + ty) * m.nx + x0 + tx] =
                relax(s.x[it][ly][lx], s.b[ly][lx], region_a(s, it, ly, lx), s.diag[ly][lx],
                      omega);
    }
}

// The coarsest level of one batch element per block: SWEEPS + COARSE_SWEEPS
// sweeps from zero, its two iterates in shared memory or, where `scratch` is
// given, in the batch element's 2 ny nx floats of it.
__global__ void mg_coarse_kernel(const float* __restrict__ b, Masks m, float* __restrict__ x,
                                 float* scratch, float omega) {
    extern __shared__ float smem[];
    const int ny = m.ny, nx = m.nx, cells = ny * nx;
    float* buf = scratch != nullptr ? scratch + 2 * static_cast<size_t>(cells) * blockIdx.x : smem;
    b += static_cast<size_t>(cells) * blockIdx.x;
    x += static_cast<size_t>(cells) * blockIdx.x;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) buf[i] = 0.0f;
    int from = 0;
    for (int k = 0; k < SWEEPS + COARSE_SWEEPS; ++k) {
        __syncthreads();
        const float* cur = buf + from * cells;
        float* next = buf + (1 - from) * cells;
        for (int i = threadIdx.x; i < cells; i += blockDim.x) {
            const int gy = i / nx, gx = i % nx;
            const float xc = cur[i];
            const float xw = gx > 0 ? cur[i - 1] : 0.0f, xe = gx + 1 < nx ? cur[i + 1] : 0.0f;
            const float xn = gy > 0 ? cur[i - nx] : 0.0f, xs = gy + 1 < ny ? cur[i + nx] : 0.0f;
            const float* u = m.face_u + gy * (nx + 1) + gx;
            const float* v = m.face_v + i;
            const float ax = apply_a(xc, xw, xe, xn, xs, __ldg(m.fluid + i), __ldg(u),
                                     __ldg(u + 1), __ldg(v), __ldg(v + nx));
            next[i] = relax(xc, b[i], ax, __ldg(m.diag + i), omega);
        }
        from = 1 - from;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) x[i] = buf[from * cells + i];
}

}  // namespace

// Level pointers: b, x (outputs) and the level's masks fluid (1, ny, nx),
// face_u (1, ny, nx + 1), face_v (1, ny + 1, nx), diag (1, ny, nx); fields
// (batch, ny, nx), the coarse ones (batch, ny / 2, nx / 2); all contiguous
// float32 on the device. The grid is the wrapper's plan: (ceil(nx / TILE_X),
// ceil(ny / TILE_Y), batch). Each returns the cudaError_t of its launch.
extern "C" int silt_mg_down(const float* b, const float* fluid, const float* face_u,
                            const float* face_v, const float* diag, const float* fluid_c,
                            float* x, float* bc, int batch, int ny, int nx, int grid_x,
                            int grid_y, float omega, void* stream) {
    if (ny % 2 != 0 || nx % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(grid_x, grid_y, batch);
    mg_down_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        b, Masks{fluid, face_u, face_v, diag, ny, nx}, fluid_c, x, bc, omega);
    return static_cast<int>(cudaGetLastError());
}

// e: the coarse level's result (batch, ny / 2, nx / 2); x: level l's
// pre-smoothed iterate; out: level l's result.
extern "C" int silt_mg_up(const float* x, const float* e, const float* b, const float* fluid,
                          const float* face_u, const float* face_v, const float* diag,
                          float* out, int batch, int ny, int nx, int grid_x, int grid_y,
                          float omega, void* stream) {
    if (ny % 2 != 0 || nx % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(grid_x, grid_y, batch);
    mg_up_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, e, b, Masks{fluid, face_u, face_v, diag, ny, nx}, out, omega);
    return static_cast<int>(cudaGetLastError());
}

// scratch: null where the level's two iterates fit in COARSE_SMEM_MAX bytes
// of shared memory, else 2 batch ny nx floats.
extern "C" int silt_mg_coarse(const float* b, const float* fluid, const float* face_u,
                              const float* face_v, const float* diag, float* x, float* scratch,
                              int batch, int ny, int nx, int threads, float omega,
                              void* stream) {
    const long long smem_ll = 2LL * ny * nx * static_cast<long long>(sizeof(float));
    if (scratch == nullptr && smem_ll > COARSE_SMEM_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = scratch == nullptr ? static_cast<int>(smem_ll) : 0;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            mg_coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    mg_coarse_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        b, Masks{fluid, face_u, face_v, diag, ny, nx}, x, scratch, omega);
    return static_cast<int>(cudaGetLastError());
}
