// Grouped expert SwiGLU FFN (the MoE layer's expert products) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `moe_gmm_kernel` of
// src/repro/kernels/moe_gmm/kernel.py (wrapper ops.py::expert_ffn). For every
// dispatch group ge (expert e = ge % E) and capacity slot c:
//
//     out[ge, c] = (silu(x[ge, c] . wg[e]) * (x[ge, c] . wu[e])) . wd[e]
//
// x [GE, C, d], wg, wu [E, d, f], wd [E, f, d], all of one type (f32 or bf16);
// out [GE, C, d] in that type. Expert weights are read at e = ge % E and never
// copied per group. Sums over d and over f are taken in f32.
//
// What bounds it on this card: operations, 6 C d f per group (three products
// of 2 C d f). At mixtral-8x22b's width (E = 8, d = 6144, f = 16384) that is
// 6.18e12 FLOP a layer for 8 x 512 prompt tokens (C = 1280, 6.25 ms at the bf16
// tensor-core peak) against 5.1 GB of weights and activations (1.5 ms); in
// decode (C = 8) the 4.83 GB of expert weights bound it (1.44 ms a layer).
//
// What the design does about it (a first, simple kernel: warp-level tensor
// cores through nvcuda::wmma for bf16, f32 FMA for f32; cp.async double
// buffering in the bf16 path; no wgmma, TMA or warp specialisation):
// - ONE BLOCK PER (64-slot tile of C, 256-wide slice of f, group). The block
//   computes act = silu(x wg) * (x wu) for its slice over the full d
//   contraction, keeps it in shared memory (never in device memory), then
//   multiplies it by the matching 256 rows of wd in 128-column chunks of d.
// - The TPU kernel carries the f32 accumulator over the sequential f grid
//   axis in VMEM. Blocks here run in no order, so each block adds its
//   partial product into an f32 buffer in device memory with atomic adds
//   (zeroed first); the bf16 output is that buffer rounded once. The sum
//   over the f slices is thus f32 but in no fixed order: results may differ
//   in the last f32 bit from run to run.
// - bf16: g and u accumulate in f32 in the tensor cores; act is rounded to
//   bf16 once, as the operand of the third product (its error against the
//   all-f32 oracle `expert_ffn_ref` is one bf16 rounding of act, well inside
//   the bf16 tolerance of 2e-2). f32: plain FMA in f32 throughout.
// - Any C (slots past C are loaded as zeros and never written); d and f must
//   be multiples of 8 (16-byte copies), checked by the launcher. There is no
//   C % 128 condition as in the TPU kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// --------------------------------------------------------------------------
// cp.async helpers (16-byte copies, zero-filled when `pred` is false)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + expf(-g)) * u; }

// --------------------------------------------------------------------------
// bf16: tensor cores (wmma 16x16x16, f32 accumulators)

namespace tc {

constexpr int BC = 64;        // capacity slots per block
constexpr int BF = 256;       // f columns per block (act tile in shared memory)
constexpr int BFS = 128;      // f columns per phase-1 pass
constexpr int BK = 32;        // d depth per phase-1 stage
constexpr int BN = 128;       // output columns per phase-2 chunk
constexpr int BK2 = 32;       // f depth per phase-2 stage
constexpr int THREADS = 256;  // 8 warps as 2 (rows) x 4 (columns), 32 x 32 each

// padded row strides (elements): multiples of 8 (16 bytes) as wmma needs
constexpr int XS_LD = BK + 8;
constexpr int WS_LD = BFS + 8;
constexpr int DS_LD = BN + 8;
constexpr int FS_LD = BN + 4;  // f32
constexpr int AS_LD = BF + 8;

constexpr size_t XS_BYTES = size_t(BC) * XS_LD * 2;    // one stage
constexpr size_t WS_BYTES = size_t(BK) * WS_LD * 2;    // one stage, wg or wu
constexpr size_t DS_BYTES = size_t(BK2) * DS_LD * 2;   // one stage of wd
constexpr size_t P1_BYTES = 2 * (XS_BYTES + 2 * WS_BYTES);
constexpr size_t P2_BYTES = 2 * DS_BYTES;
constexpr size_t FS_BYTES = size_t(BC) * FS_LD * 4;
// phase 1's stages and phase 2's (wd stages, then f32 staging at P2_BYTES)
// share one region; the act tile lies after it
constexpr size_t REGION_A = (P1_BYTES > P2_BYTES + FS_BYTES) ? P1_BYTES : P2_BYTES + FS_BYTES;
constexpr size_t AS_BYTES = size_t(BC) * AS_LD * 2;
constexpr size_t SMEM_BYTES = REGION_A + AS_BYTES;
static_assert(XS_BYTES % 128 == 0 && WS_BYTES % 128 == 0 && P2_BYTES % 128 == 0 &&
                  REGION_A % 128 == 0,
              "shared-memory sub-arrays must stay 128-byte aligned");
static_assert(BC * BK / 8 == THREADS, "one x chunk per thread and stage");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(THREADS, 2)
moe_gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                    const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                    float* __restrict__ acc, int E, int C, int d, int f) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xs = reinterpret_cast<bf16*>(smem);                                // [2][BC][XS_LD]
    bf16* gs = reinterpret_cast<bf16*>(smem + 2 * XS_BYTES);                 // [2][BK][WS_LD]
    bf16* us = reinterpret_cast<bf16*>(smem + 2 * XS_BYTES + 2 * WS_BYTES);  // [2][BK][WS_LD]
    bf16* ds = reinterpret_cast<bf16*>(smem);                                // [2][BK2][DS_LD]
    float* fs = reinterpret_cast<float*>(smem + P2_BYTES);                   // [BC][FS_LD]
    bf16* as = reinterpret_cast<bf16*>(smem + REGION_A);                     // [BC][AS_LD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wr = warp >> 2;  // rows wr*32 .. +32
    const int wc = warp & 3;   // columns wc*32 .. +32
    const int c0 = blockIdx.x * BC;
    const int f0 = blockIdx.y * BF;
    const int ge = blockIdx.z;
    const int e = ge % E;
    const bf16* xb = x + static_cast<size_t>(ge) * C * d;
    const bf16* wgb = wg + static_cast<size_t>(e) * d * f;
    const bf16* wub = wu + static_cast<size_t>(e) * d * f;
    const bf16* wdb = wd + static_cast<size_t>(e) * f * d;
    float* ob = acc + static_cast<size_t>(ge) * C * d;

    // ---- phase 1: act[:, s*BFS .. +BFS] = silu(x wg) * (x wu), two passes
    auto load_p1 = [&](int k0, int buf, int fc0) {
        {
            const int r = tid >> 2, c = (tid & 3) * 8;
            const int row = c0 + r, col = k0 + c;
            const bool ok = row < C && col < d;
            cp_async16(xs + buf * BC * XS_LD + r * XS_LD + c,
                       ok ? xb + static_cast<size_t>(row) * d + col : xb, ok);
        }
        for (int i = tid; i < BK * BFS / 8; i += THREADS) {
            const int r = i / (BFS / 8), c = (i % (BFS / 8)) * 8;
            const int krow = k0 + r, col = fc0 + c;
            const bool ok = krow < d && col < f;
            const size_t off = ok ? static_cast<size_t>(krow) * f + col : 0;
            cp_async16(gs + buf * BK * WS_LD + r * WS_LD + c, wgb + off, ok);
            cp_async16(us + buf * BK * WS_LD + r * WS_LD + c, wub + off, ok);
        }
    };

    const int nk = (d + BK - 1) / BK;
    for (int s = 0; s < BF / BFS; ++s) {
        const int fc0 = f0 + s * BFS;
        if (fc0 >= f) {  // past the end of f: act is zero there
            for (int i = tid; i < BC * BFS; i += THREADS)
                as[(i / BFS) * AS_LD + s * BFS + i % BFS] = __float2bfloat16_rn(0.f);
            continue;
        }
        FragC g[2][2], u[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fill_fragment(g[i][j], 0.f);
                wmma::fill_fragment(u[i][j], 0.f);
            }
        load_p1(0, 0, fc0);
        cp_async_commit();
        for (int kt = 0; kt < nk; ++kt) {
            if (kt + 1 < nk) {
                load_p1((kt + 1) * BK, (kt + 1) & 1, fc0);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const bf16* xt = xs + (kt & 1) * BC * XS_LD;
            const bf16* gt = gs + (kt & 1) * BK * WS_LD;
            const bf16* ut = us + (kt & 1) * BK * WS_LD;
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                FragA a[2];
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::load_matrix_sync(a[i], xt + (wr * 32 + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    FragB b;
                    wmma::load_matrix_sync(b, gt + kk * WS_LD + wc * 32 + j * 16, WS_LD);
#pragma unroll
                    for (int i = 0; i < 2; ++i) wmma::mma_sync(g[i][j], a[i], b, g[i][j]);
                    wmma::load_matrix_sync(b, ut + kk * WS_LD + wc * 32 + j * 16, WS_LD);
#pragma unroll
                    for (int i = 0; i < 2; ++i) wmma::mma_sync(u[i][j], a[i], b, u[i][j]);
                }
            }
            __syncthreads();  // this stage is consumed before it is refilled
        }
        // g and u fragments share one layout: the product is elementwise
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
#pragma unroll
                for (int t = 0; t < g[i][j].num_elements; ++t)
                    g[i][j].x[t] = silu_mul(g[i][j].x[t], u[i][j].x[t]);
                wmma::store_matrix_sync(fs + (wr * 32 + i * 16) * FS_LD + wc * 32 + j * 16,
                                        g[i][j], FS_LD, wmma::mem_row_major);
            }
        __syncthreads();
        for (int i = tid; i < BC * BFS; i += THREADS)
            as[(i / BFS) * AS_LD + s * BFS + i % BFS] =
                __float2bfloat16_rn(fs[(i / BFS) * FS_LD + i % BFS]);
        __syncthreads();  // fs lies over the stages the next pass refills
    }

    // ---- phase 2: acc[:, n0 .. n0+BN] += act . wd[f0 .. f0+BF, n0 .. n0+BN]
    auto load_p2 = [&](int n0, int k0, int buf) {
        for (int i = tid; i < BK2 * BN / 8; i += THREADS) {
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            const int frow = f0 + k0 + r, col = n0 + c;
            const bool ok = frow < f && col < d;
            const size_t off = ok ? static_cast<size_t>(frow) * d + col : 0;
            cp_async16(ds + buf * BK2 * DS_LD + r * DS_LD + c, wdb + off, ok);
        }
    };
    constexpr int NK2 = BF / BK2;
    for (int n0 = 0; n0 < d; n0 += BN) {
        FragC o[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(o[i][j], 0.f);
        load_p2(n0, 0, 0);
        cp_async_commit();
        for (int kt = 0; kt < NK2; ++kt) {
            if (kt + 1 < NK2) {
                load_p2(n0, (kt + 1) * BK2, (kt + 1) & 1);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const bf16* dt = ds + (kt & 1) * BK2 * DS_LD;
#pragma unroll
            for (int kk = 0; kk < BK2; kk += 16) {
                FragA a[2];
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::load_matrix_sync(a[i], as + (wr * 32 + i * 16) * AS_LD + kt * BK2 + kk,
                                           AS_LD);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    FragB b;
                    wmma::load_matrix_sync(b, dt + kk * DS_LD + wc * 32 + j * 16, DS_LD);
#pragma unroll
                    for (int i = 0; i < 2; ++i) wmma::mma_sync(o[i][j], a[i], b, o[i][j]);
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::store_matrix_sync(fs + (wr * 32 + i * 16) * FS_LD + wc * 32 + j * 16,
                                        o[i][j], FS_LD, wmma::mem_row_major);
        __syncthreads();
        for (int i = tid; i < BC * BN; i += THREADS) {
            const int r = i / BN, c = i % BN;
            const int row = c0 + r, col = n0 + c;
            if (row < C && col < d)
                atomicAdd(ob + static_cast<size_t>(row) * d + col, fs[r * FS_LD + c]);
        }
        __syncthreads();  // fs is rewritten by the next chunk
    }
}

}  // namespace tc

// --------------------------------------------------------------------------
// f32: plain FMA, register-blocked (16 x 16 threads, 4 x 4 outputs each)

namespace simt {

constexpr int BC = 64;        // capacity slots per block
constexpr int BF = 128;       // f columns per block (act tile in shared memory)
constexpr int BFS = 64;       // f columns per phase-1 pass
constexpr int BK = 16;        // d depth per phase-1 stage
constexpr int BN = 64;        // output columns per phase-2 chunk
constexpr int BK2 = 16;       // f depth per phase-2 stage
constexpr int THREADS = 256;

constexpr int XS_LD = BC + 4;   // x stored k-major: [BK][XS_LD]
constexpr int WS_LD = BFS + 4;  // [BK][WS_LD]
constexpr int DS_LD = BN + 4;   // [BK2][DS_LD]
constexpr int AS_LD = BF + 1;   // [BC][AS_LD]
constexpr size_t SMEM_BYTES =
    sizeof(float) * (size_t(BK) * XS_LD + 2 * size_t(BK) * WS_LD + size_t(BK2) * DS_LD +
                     size_t(BC) * AS_LD);

__global__ void __launch_bounds__(THREADS)
moe_gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                   const float* __restrict__ wu, const float* __restrict__ wd,
                   float* __restrict__ acc, int E, int C, int d, int f) {
    extern __shared__ __align__(16) float smf[];
    float* xs = smf;                  // [BK][XS_LD]
    float* gs = xs + BK * XS_LD;      // [BK][WS_LD]
    float* us = gs + BK * WS_LD;      // [BK][WS_LD]
    float* ds = us + BK * WS_LD;      // [BK2][DS_LD]
    float* as = ds + BK2 * DS_LD;     // [BC][AS_LD]

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int c0 = blockIdx.x * BC;
    const int f0 = blockIdx.y * BF;
    const int ge = blockIdx.z;
    const int e = ge % E;
    const float* xb = x + static_cast<size_t>(ge) * C * d;
    const float* wgb = wg + static_cast<size_t>(e) * d * f;
    const float* wub = wu + static_cast<size_t>(e) * d * f;
    const float* wdb = wd + static_cast<size_t>(e) * f * d;
    float* ob = acc + static_cast<size_t>(ge) * C * d;

    for (int s = 0; s < BF / BFS; ++s) {
        const int fc0 = f0 + s * BFS;
        float g[4][4], u[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.f;
        for (int k0 = 0; k0 < d; k0 += BK) {
            for (int i = tid; i < BC * BK; i += THREADS) {
                const int r = i / BK, k = i % BK;
                const int row = c0 + r, col = k0 + k;
                xs[k * XS_LD + r] =
                    (row < C && col < d) ? xb[static_cast<size_t>(row) * d + col] : 0.f;
            }
            for (int i = tid; i < BK * BFS; i += THREADS) {
                const int k = i / BFS, c = i % BFS;
                const int krow = k0 + k, col = fc0 + c;
                const bool ok = krow < d && col < f;
                const size_t off = static_cast<size_t>(krow) * f + col;
                gs[k * WS_LD + c] = ok ? wgb[off] : 0.f;
                us[k * WS_LD + c] = ok ? wub[off] : 0.f;
            }
            __syncthreads();
            // each stage's BK terms are summed apart, then added to the
            // running sums: d / BK additions there instead of d, which
            // keeps the rounding of a 6144-long sum near cuBLAS's
            float gp[4][4], up[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) gp[i][j] = up[i][j] = 0.f;
#pragma unroll 4
            for (int k = 0; k < BK; ++k) {
                float a[4], bg[4], bu[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = xs[k * XS_LD + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    bg[j] = gs[k * WS_LD + tx + 16 * j];
                    bu[j] = us[k * WS_LD + tx + 16 * j];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        gp[i][j] = fmaf(a[i], bg[j], gp[i][j]);
                        up[i][j] = fmaf(a[i], bu[j], up[i][j]);
                    }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    g[i][j] += gp[i][j];
                    u[i][j] += up[i][j];
                }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                as[(ty + 16 * i) * AS_LD + s * BFS + tx + 16 * j] = silu_mul(g[i][j], u[i][j]);
    }
    __syncthreads();

    for (int n0 = 0; n0 < d; n0 += BN) {
        float o[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
        for (int k0 = 0; k0 < BF; k0 += BK2) {
            for (int i = tid; i < BK2 * BN; i += THREADS) {
                const int k = i / BN, c = i % BN;
                const int frow = f0 + k0 + k, col = n0 + c;
                ds[k * DS_LD + c] =
                    (frow < f && col < d) ? wdb[static_cast<size_t>(frow) * d + col] : 0.f;
            }
            __syncthreads();
#pragma unroll 4
            for (int k = 0; k < BK2; ++k) {
                float a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * AS_LD + k0 + k];
#pragma unroll
                for (int j = 0; j < 4; ++j) b[j] = ds[k * DS_LD + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = c0 + ty + 16 * i;
            if (row >= C) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = n0 + tx + 16 * j;
                if (col < d) atomicAdd(ob + static_cast<size_t>(row) * d + col, o[i][j]);
            }
        }
    }
}

}  // namespace simt

__global__ void round_to_bf16_kernel(const float* __restrict__ in, bf16* __restrict__ out,
                                     size_t n) {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<size_t>(gridDim.x) * blockDim.x)
        out[i] = __float2bfloat16_rn(in[i]);
}

}  // namespace

extern "C" {

// x [GE, C, d], wg/wu [E, d, f], wd [E, f, d], out [GE, C, d]: contiguous
// device pointers of one type (is_bf16: bfloat16, else float32), 16-byte
// aligned; GE % E == 0, d % 8 == 0, f % 8 == 0. `acc` is f32 scratch of
// GE*C*d values for bf16 and `out` itself for f32. Zeroes acc, launches the
// kernel and, for bf16, rounds acc into out, all on `stream` without
// synchronising; returns the first cudaError_t.
int moe_gmm_launch(const void* x, const void* wg, const void* wu, const void* wd, void* out,
                   void* acc, int GE, int E, int C, int d, int f, int is_bf16, void* stream) {
    if (GE <= 0 || E <= 0 || GE % E != 0 || C <= 0 || d <= 0 || f <= 0 || d % 8 != 0 ||
        f % 8 != 0 || GE > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    const size_t n = static_cast<size_t>(GE) * C * d;
    cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (is_bf16) {
        err = cudaFuncSetAttribute(tc::moe_gmm_bf16_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(tc::SMEM_BYTES));
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid((C + tc::BC - 1) / tc::BC, (f + tc::BF - 1) / tc::BF, GE);
        tc::moe_gmm_bf16_kernel<<<grid, tc::THREADS, tc::SMEM_BYTES, s>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
            static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
            static_cast<float*>(acc), E, C, d, f);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        const size_t blocks = (n + 255) / 256;
        round_to_bf16_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
            static_cast<const float*>(acc), static_cast<bf16*>(out), n);
        return static_cast<int>(cudaGetLastError());
    }
    if (out != acc) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(simt::moe_gmm_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(simt::SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((C + simt::BC - 1) / simt::BC, (f + simt::BF - 1) / simt::BF, GE);
    simt::moe_gmm_f32_kernel<<<grid, simt::THREADS, simt::SMEM_BYTES, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<const float*>(wd),
        static_cast<float*>(acc), E, C, d, f);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
