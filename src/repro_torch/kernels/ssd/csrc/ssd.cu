// Mamba2 SSD (state-space duality), chunked, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `ssd_kernel` of
// src/repro/kernels/ssd/kernel.py (wrapper ops.py::ssd). Per (batch, head)
// row, per chunk c of L steps (la = -dt * A, cum = prefix sum of la over the
// chunk, seg = cum[L-1], xdt = x * dt):
//
//     y[t]  = sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s) xdt[s]     intra-chunk
//           + exp(cum_t) (c_t . h_in[c])                           carried state
//     h_in[c+1] = exp(seg) h_in[c] + s_c,
//     s_c   = sum_s b_s (exp(seg - cum_s) xdt[s])^T                h is [N, P]
//
// in f32 whatever the input type (cum in f64, below); y in x's type,
// h_final in f32.
//
// What bounds it on this card: bytes, at both of zamba2's shapes, as
// chip_smoke.py's `ssd_cost` counts them (C B^T once per batch row, b and
// c shared by the heads). At the long prefill (B = 1, S = 32768, H = 80,
// P = N = 64, L = 256): 8.7e10 FLOP (0.088 ms at the bf16 tensor-core
// peak) against 0.69 GB (0.21 ms). At the request shape (B = 8, S = 512):
// 1.1e10 FLOP (0.011 ms) against 97 MB (0.029 ms). The staged design
// moves more than that: its workspace (ssd_workspace_bytes, 199 MB at the
// long shape, of which the state scratch is 168 MB) goes through device
// memory about three times, and chunk_scan re-reads b, c and x tiles from
// L2 for every head and tile pair, which is what its load phase waits on.
//
// ONE LAUNCH OF THE WRAPPER IS THREE CUDA KERNELS, run in order on the
// caller's stream (the chunked algorithm of "Transformers are SSMs",
// arXiv:2405.21060 section 6, split as mamba_ssm's ssd_combined.py splits
// it), so that every chunk of every row runs in parallel and only an
// elementwise pass is sequential:
//
// - K3a chunk_state, one block per (batch, head, chunk): cum by a
//   block-wide prefix sum in f64 (the per-step log decays -dt*A are f32
//   products as in the reference, but with A up to 16 |cum| reaches the
//   thousands over a 256-step chunk, where an f32 sum would cost
//   exp(cum_t - cum_s) ~1e-4 of its value), kept with dt in the workspace
//   for K3c; s_c [N, P] f32 into the state scratch [B, H, nc, N, P], and
//   exp(seg) into [B, H, nc].
// - K3b state_pass, one block per (batch, head, 1024 floats of N P): walks
//   the chunks in order, elementwise in f32: h_in[c] = h; h = exp(seg_c) h
//   + s_c. h_in is written in place over s_c (h_in[0] = 0 is not stored:
//   K3c takes a row's first chunk as carrying no state), h_final to h_out.
//   128 steps over 64 x 64 floats a row at the long shape, bound by bytes.
// - K3c chunk_scan: y for two 64-step t tiles q and T - 1 - q of a (batch,
//   head, chunk), so the two blocks of a 256-step chunk carry 4 + 1 and
//   3 + 2 (t, s) tile pairs: the carried-state term exp(cum_t) (C_t h_in),
//   then for each s tile up to the diagonal scores = C_t B_s^T and
//   y += W x_s with W = scores exp(cum_t - cum_s) dt_s. The mask is on the
//   exponent: exp is never evaluated for s > t (a future delta is
//   positive and would overflow). Below the diagonal every s < t, and
//   exp(cum_t - cum_s) = exp(cum_t - cum_end) exp(cum_end - cum_s) with
//   cum_end at the s tile's last step: two factors <= 1, a per-row and a
//   per-column one. On the diagonal tile the exponent is taken from f32
//   offsets to the tile's first step (f64 differences, rounded once).
//
// bf16 inputs (`tc`): every product on mma.sync m16n8k16, bf16 in, f32
// accumulators, with the fragment machinery of flash_attention.cu: 8 warps
// a block, tiles copied by cp.async (16 bytes a copy, zero-filled past the
// chunk) into rows padded by 16 bytes; A fragments by ldmatrix, B
// fragments by ldmatrix (b as the B of C B^T) or ldmatrix.trans (x, h_in,
// and b^T as the A of K3a). K3a stages the whole chunk at once (x through
// registers, where it is scaled); K3c issues every load of a block at
// once (two c tiles, the b and x tiles up to its heavier diagonal, h_in,
// cum and dt), waits once, then runs its products without a barrier.
// N < 16 and P < 16 are zero-padded to 16. Where bf16 rounding happens
// (the plain version rounds nothing but its output):
//   - K3a: exp(seg - cum_s) dt_s x_s is formed in f32 and rounded to bf16
//     once, as the B operand of b^T (.) (b is bf16 already, exact);
//   - K3c: h_in (f32 in the scratch) is rounded to bf16 once, as the B
//     operand of C h_in; x enters W x as it is (exact), dt riding on W;
//     W is formed in f32 and enters as a pair of bf16 A operands in
//     registers (hi = W rounded, lo = the remainder rounded: 16 bits of
//     mantissa), two mma.sync per step. A single bf16 W (and xdt rounded
//     once) strayed 0.25 from the plain version at 1 x 4096 tokens, where
//     `_tol`'s elementwise 2e-2 does not allow it;
//   - y is rounded to bf16 once on the way out. s_c, h_in in the scratch,
//     h_final and exp(seg) stay f32.
// f32 inputs (`simt`): the same three stages with plain f32 FMA on staged
// shared-memory tiles (16 x 16 threads), a block per (batch, head, chunk,
// 64-step t tile), no rounding but the f32 products themselves; the f32
// in-situ checks hold them at 1e-5.
// Built without --use_fast_math: expf and exp2f, not __expf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_L = 256;    // longest chunk (one prefix-sum pass)
constexpr int TT = 64;        // steps per t tile and per s tile
constexpr int PASS_THREADS = 256;


// cum[t] = sum_{u<=t} -dt_u A in f64 for t < L, cum[t] = cum[L-1] above
// (finite padding for the rows of a tile past the chunk); dt_s[t] = dt_t
// (0 past the chunk). THREADS threads, each MAX_L / THREADS consecutive
// steps; ends with a barrier.
template <int THREADS>
__device__ void chunk_cum(const float* __restrict__ dtb, int H, float A, int L,
                          double* cum, double* wtot, float* dt_s) {
    constexpr int K = MAX_L / THREADS;
    static_assert(K * THREADS == MAX_L && THREADS <= 1024, "threads");
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    double v[K];
    double run = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int t = tid * K + k;
        const float d = t < L ? dtb[static_cast<size_t>(t) * H] : 0.f;
        dt_s[t] = d;
        if (t < L) run += static_cast<double>(-d * A);
        v[k] = run;
    }
    double tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
    }
    if (lane == 31) wtot[warp] = tot;
    __syncthreads();
    double excl = tot - run;
    for (int w = 0; w < warp; ++w) excl += wtot[w];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int t = tid * K + k;
        if (t < L) cum[t] = excl + v[k];
    }
    __syncthreads();
    const double last = cum[L - 1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int t = tid * K + k;
        if (t >= L) cum[t] = last;
    }
    __syncthreads();
}

// K3a keeps each chunk's cum and dt in the workspace ([rows * nc][L], f64
// and f32) for K3c, which reads them contiguously instead of summing the
// strided dt again
__device__ __forceinline__ void keep_cum(const double* cum, const float* dt_s, double* cum_out,
                                         float* dt_out, int L, int tid, int threads) {
    double* co = cum_out + static_cast<size_t>(blockIdx.x) * L;
    float* dto = dt_out + static_cast<size_t>(blockIdx.x) * L;
    for (int t = tid; t < L; t += threads) {
        co[t] = cum[t];
        dto[t] = dt_s[t];
    }
}

// --------------------------------------------------------------------------
// K3b: the state pass, shared by both types (the scratch is f32)

// s [rows, nc, NP] holds s_c on entry and h_in[c] on exit for c >= 1 (h_in[0]
// is 0, and chunk_scan takes it so without reading); eseg [rows, nc];
// h_out [rows, NP]. One thread per 4 floats of a row's N x P.
__global__ void __launch_bounds__(PASS_THREADS)
state_pass_kernel(float* __restrict__ s, const float* __restrict__ eseg,
                  float* __restrict__ h_out, int nc, int np4, int blocks_per_row) {
    const int row = blockIdx.x / blocks_per_row;
    const int i = (blockIdx.x - row * blocks_per_row) * PASS_THREADS + threadIdx.x;
    if (i >= np4) return;
    float4* sp = reinterpret_cast<float4*>(s) + static_cast<size_t>(row) * nc * np4 + i;
    const float* e = eseg + static_cast<size_t>(row) * nc;
    float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
    int c = 0;
    // UNROLL chunks' loads in flight at a time: they do not depend on h
    constexpr int UNROLL = 8;
    for (; c + UNROLL <= nc; c += UNROLL) {
        float4 v[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) v[k] = sp[static_cast<size_t>(c + k) * np4];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            if (c + k > 0) sp[static_cast<size_t>(c + k) * np4] = h;
            const float g = e[c + k];
            h = make_float4(h.x * g + v[k].x, h.y * g + v[k].y, h.z * g + v[k].z,
                            h.w * g + v[k].w);
        }
    }
    for (; c < nc; ++c) {
        const float4 v = sp[static_cast<size_t>(c) * np4];
        if (c > 0) sp[static_cast<size_t>(c) * np4] = h;
        const float g = e[c];
        h = make_float4(h.x * g + v.x, h.y * g + v.y, h.z * g + v.z, h.w * g + v.w);
    }
    reinterpret_cast<float4*>(h_out)[static_cast<size_t>(row) * np4 + i] = h;
}

// --------------------------------------------------------------------------
// f32: plain FMA on staged tiles

namespace simt {

constexpr int THREADS = 256;  // 16 x 16; also one thread per step of a chunk

template <int N, int P>
constexpr size_t state_smem_bytes() {
    return sizeof(double) * (MAX_L + 8) + sizeof(float) * MAX_L +
           sizeof(float) * (static_cast<size_t>(TT) * (N + 1) + static_cast<size_t>(TT) * P);
}

// K3a: s_c = sum_s (exp(seg - cum_s) b_s) xdt_s^T and exp(seg)
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ bm,
                   float* __restrict__ s_out, float* __restrict__ eseg_out,
                   double* __restrict__ cum_out, float* __restrict__ dt_out, int S, int H,
                   int L) {
    constexpr int NP = N + 1;
    constexpr int JP = (P + 15) / 16;
    constexpr int IN = (N + 15) / 16;
    extern __shared__ double smem[];
    double* cum = smem;                                    // [MAX_L]
    double* wtot = cum + MAX_L;                            // [8]
    float* dt_s = reinterpret_cast<float*>(wtot + 8);      // [MAX_L]
    float* b_s = dt_s + MAX_L;                             // [TT][NP]
    float* xdt_s = b_s + TT * NP;                          // [TT][P]

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int nc = S / L;
    const int row = blockIdx.x / nc, ci = blockIdx.x - row * nc;
    const int bi = row / H, hi = row - bi * H;
    const size_t s0 = static_cast<size_t>(ci) * L;
    const size_t xrow = static_cast<size_t>(H) * P;
    const float* xb = x + (static_cast<size_t>(bi) * S + s0) * xrow + static_cast<size_t>(hi) * P;
    const float* dtb = dt + (static_cast<size_t>(bi) * S + s0) * H + hi;
    const float* bb = bm + (static_cast<size_t>(bi) * S + s0) * N;

    chunk_cum<THREADS>(dtb, H, a[hi], L, cum, wtot, dt_s);
    const double seg = cum[L - 1];
    if (tid == 0) eseg_out[blockIdx.x] = expf(static_cast<float>(seg));
    keep_cum(cum, dt_s, cum_out, dt_out, L, tid, THREADS);

    float hacc[IN][JP];
#pragma unroll
    for (int i = 0; i < IN; ++i)
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) hacc[i][jj] = 0.f;
    for (int u0 = 0; u0 < L; u0 += TT) {
        const int ns = min(TT, L - u0);
        for (int i = tid; i < TT * N; i += THREADS) {
            const int r = i / N, n = i - (i / N) * N;
            b_s[r * NP + n] = r < ns ? bb[(u0 + r) * N + n] *
                                           expf(static_cast<float>(seg - cum[u0 + r]))
                                     : 0.f;
        }
        for (int i = tid; i < TT * P; i += THREADS) {
            const int r = i / P, p = i - (i / P) * P;
            xdt_s[r * P + p] = r < ns ? xb[(u0 + r) * xrow + p] * dt_s[u0 + r] : 0.f;
        }
        __syncthreads();
        for (int s = 0; s < ns; ++s) {
            float bv[IN];
#pragma unroll
            for (int i = 0; i < IN; ++i) {
                const int n = ty + 16 * i;
                bv[i] = n < N ? b_s[s * NP + n] : 0.f;
            }
#pragma unroll
            for (int jj = 0; jj < JP; ++jj) {
                const int p = tx + 16 * jj;
                const float xv = p < P ? xdt_s[s * P + p] : 0.f;
#pragma unroll
                for (int i = 0; i < IN; ++i) hacc[i][jj] = fmaf(bv[i], xv, hacc[i][jj]);
            }
        }
        __syncthreads();   // b_s / xdt_s are restaged by the next s tile
    }
    float* sb = s_out + static_cast<size_t>(blockIdx.x) * N * P;
#pragma unroll
    for (int i = 0; i < IN; ++i) {
        const int n = ty + 16 * i;
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) {
            const int p = tx + 16 * jj;
            if (n < N && p < P) sb[n * P + p] = hacc[i][jj];
        }
    }
}

template <int N, int P>
constexpr size_t scan_smem_bytes() {
    return sizeof(double) * (MAX_L + 8) + sizeof(float) * MAX_L +
           sizeof(float) * (static_cast<size_t>(N) * P +              // h_in
                            2 * static_cast<size_t>(TT) * (N + 1) +   // c, b tiles
                            static_cast<size_t>(TT) * P +             // xdt tile
                            static_cast<size_t>(TT) * (TT + 1));      // weight tile
}

// K3c: one 64-step t tile of y
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                  const float* __restrict__ cm, const double* __restrict__ cum_g,
                  const float* __restrict__ dt_g, const float* __restrict__ h_in,
                  float* __restrict__ y, int S, int H, int L) {
    constexpr int NP = N + 1;          // padded rows of the c / b tiles
    constexpr int WP = TT + 1;
    constexpr int JP = (P + 15) / 16;  // output columns per thread
    extern __shared__ double smem[];
    double* cum = smem;                                    // [MAX_L]
    double* wtot = cum + MAX_L;                            // [8]
    float* dt_s = reinterpret_cast<float*>(wtot + 8);      // [MAX_L]
    float* h_s = dt_s + MAX_L;                             // [N][P]
    float* c_s = h_s + N * P;                              // [TT][NP]
    float* b_s = c_s + TT * NP;                            // [TT][NP]
    float* xdt_s = b_s + TT * NP;                          // [TT][P]
    float* w_s = xdt_s + TT * P;                           // [TT][WP]

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int nc = S / L;
    const int rc = blockIdx.x;                             // row * nc + chunk
    const int row = rc / nc, ci = rc - row * nc;
    const int bi = row / H, hi = row - bi * H;
    const int t0 = (gridDim.y - 1 - blockIdx.y) * TT;     // heaviest tiles first
    const int nt = min(TT, L - t0);
    const size_t s0 = static_cast<size_t>(ci) * L;
    const size_t xrow = static_cast<size_t>(H) * P;
    const float* xb = x + (static_cast<size_t>(bi) * S + s0) * xrow + static_cast<size_t>(hi) * P;
    float* yb = y + (static_cast<size_t>(bi) * S + s0) * xrow + static_cast<size_t>(hi) * P;
    const float* bb = bm + (static_cast<size_t>(bi) * S + s0) * N;
    const float* cb = cm + (static_cast<size_t>(bi) * S + s0) * N;

    const float* hb = h_in + static_cast<size_t>(rc) * N * P;
    for (int i = tid; i < N * P; i += THREADS) h_s[i] = ci > 0 ? hb[i] : 0.f;
    for (int i = tid; i < TT * N; i += THREADS) {
        const int r = i / N, n = i - (i / N) * N;
        c_s[r * NP + n] = r < nt ? cb[(t0 + r) * N + n] : 0.f;
    }
    // cum and dt from K3a (past the chunk: cum's last value, dt 0)
    for (int t = tid; t < MAX_L; t += THREADS) {
        cum[t] = cum_g[static_cast<size_t>(rc) * L + min(t, L - 1)];
        dt_s[t] = t < L ? dt_g[static_cast<size_t>(rc) * L + t] : 0.f;
    }
    __syncthreads();

    // carried state: exp(cum_t) (c_t . h_in)
    float acc[4][JP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) acc[i][jj] = 0.f;
    for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) {
            const int p = tx + 16 * jj;
            const float hv = p < P ? h_s[n * P + p] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(cv[i], hv, acc[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float e = t < nt ? expf(static_cast<float>(cum[t0 + t])) : 0.f;
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) acc[i][jj] *= e;
    }

    // intra-chunk: s tiles up to and including the diagonal one
    for (int u0 = 0; u0 <= t0; u0 += TT) {
        const int ns = min(TT, L - u0);
        __syncthreads();   // b_s / xdt_s / w_s of the previous s tile are consumed
        for (int i = tid; i < TT * N; i += THREADS) {
            const int r = i / N, n = i - (i / N) * N;
            b_s[r * NP + n] = r < ns ? bb[(u0 + r) * N + n] : 0.f;
        }
        for (int i = tid; i < TT * P; i += THREADS) {
            const int r = i / P, p = i - (i / P) * P;
            xdt_s[r * P + p] = r < ns ? xb[(u0 + r) * xrow + p] * dt_s[u0 + r] : 0.f;
        }
        __syncthreads();

        float wv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) wv[i][k] = 0.f;
        for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NP + n];
#pragma unroll
            for (int k = 0; k < 4; ++k) bv[k] = b_s[(tx + 16 * k) * NP + n];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int k = 0; k < 4; ++k) wv[i][k] = fmaf(cv[i], bv[k], wv[i][k]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int t = t0 + ty + 16 * i;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int s = u0 + tx + 16 * k;
                // mask the exponent: exp is never taken of a future delta
                const float wgt =
                    (s <= t && t < L)
                        ? wv[i][k] * expf(static_cast<float>(cum[t] - cum[s]))
                        : 0.f;
                w_s[(ty + 16 * i) * WP + tx + 16 * k] = wgt;
            }
        }
        __syncthreads();

        for (int s = 0; s < ns; ++s) {
            float wr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) wr[i] = w_s[(ty + 16 * i) * WP + s];
#pragma unroll
            for (int jj = 0; jj < JP; ++jj) {
                const int p = tx + 16 * jj;
                const float xv = p < P ? xdt_s[s * P + p] : 0.f;
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(wr[i], xv, acc[i][jj]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= nt) continue;
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) {
            const int p = tx + 16 * jj;
            if (p < P) yb[(t0 + t) * xrow + p] = acc[i][jj];
        }
    }
}

}  // namespace simt

// --------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulators), cp.async

namespace tc {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
static_assert(THREADS == MAX_L, "K3c takes one step of cum a thread");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) as a bf16 pair `hi` and the bf16 pair of what rounding left, `lo`:
// hi + lo carries 16 bits of each value's mantissa
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = pack_bf16(a - hf.x, b - hf.y);
}

// per-lane ldmatrix offsets (elements) in a tile of row length ld:
// A fragments of a row-major [m][k] tile (16 rows from `row0`)
__device__ __forceinline__ int a_off(int lane, int ld) {
    return (lane & 15) * ld + (lane >> 4) * 8;
}
// B fragments of two 8-column tiles from a [n][k] tile (non-trans), or A
// fragments of a [k][m] tile read transposed
__device__ __forceinline__ int nk_off(int lane, int ld) {
    return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
// B fragments of two 8-column tiles from a [k][n] tile (trans)
__device__ __forceinline__ int kn_off(int lane, int ld) {
    return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;
}

template <int N, int P>
struct Dims {
    static constexpr int NPAD = N < 16 ? 16 : N;   // N, P are 4, 8 or multiples of 16
    static constexpr int PPAD = P < 16 ? 16 : P;
    static constexpr int LDN = NPAD + 8;           // padded rows (elements): 16 bytes
    static constexpr int LDP = PPAD + 8;
    static constexpr size_t HEAD = sizeof(double) * (MAX_L + 8) + sizeof(float) * 2 * MAX_L;
    static constexpr size_t BT = size_t(TT) * LDN;  // one 64-row b or c tile (elements)
    static constexpr size_t XT = size_t(TT) * LDP;  // one 64-row x tile
    static constexpr size_t HT = size_t(NPAD) * LDP;
    // K3a holds the whole chunk; K3c two c tiles, h_in, and the b and x
    // tiles up to its heavier diagonal (room for the whole chunk)
    static constexpr size_t STATE_SMEM = HEAD + sizeof(bf16) * (MAX_L / TT) * (BT + XT);
    static constexpr size_t SCAN_HEAD = (sizeof(double) + 3 * sizeof(float)) * MAX_L;
    static constexpr size_t SCAN_SMEM =
        SCAN_HEAD + sizeof(bf16) * (2 * BT + HT + (MAX_L / TT) * (BT + XT));
    static_assert(P % 8 == 0, "x rows are whole 16-byte chunks");
    static_assert(HEAD % 16 == 0 && SCAN_HEAD % 16 == 0, "tiles start 16-byte aligned");
};

// Copy rows [0, nrows) of a [rows][W] bf16 matrix (row stride `stride`
// elements) into a [ROWS][LD] tile, zero-filling rows nrows..ROWS-1;
// columns W..LD-1 are left as they are. cp.async where a row is whole
// 16-byte chunks (not committed here), else plain loads.
template <int W, int LD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride,
                                          int nrows, int tid) {
    if constexpr (W % 8 == 0) {
        constexpr int CPR = W / 8;
        for (int i = tid; i < ROWS * CPR; i += THREADS) {
            const int r = i / CPR, c = (i - r * CPR) * 8;
            const bool ok = r < nrows;
            cp_async16(smem_u32(dst + r * LD + c), src + (ok ? r * stride + c : 0), ok);
        }
    } else {
        for (int i = tid; i < ROWS * W; i += THREADS) {
            const int r = i / W, c = i - r * W;
            dst[r * LD + c] = r < nrows ? src[r * stride + c] : __float2bfloat16(0.f);
        }
    }
}

// zero columns [W, WPAD) of `rows` rows of a tile (the padding of N or P
// up to 16); they are never written by load_tile
template <int W, int WPAD, int LD>
__device__ __forceinline__ void zero_pad(bf16* dst, int rows, int tid) {
    if constexpr (W < WPAD) {
        for (int i = tid; i < rows * (WPAD - W); i += THREADS) {
            const int r = i / (WPAD - W), c = W + i - r * (WPAD - W);
            dst[r * LD + c] = __float2bfloat16(0.f);
        }
    }
}

// x rows [0, ROWS) of one tile into registers, 16 bytes at a time (rows
// at or past nrows read as zero); issued together, used later
template <int P, int ROWS>
struct XRegs {
    static constexpr int CPR = P / 8;
    static constexpr int CH = (ROWS * CPR + THREADS - 1) / THREADS;
    uint4 v[CH];
    __device__ __forceinline__ void load(const bf16* src, size_t stride, int nrows, int tid) {
#pragma unroll
        for (int k = 0; k < CH; ++k) {
            const int i = tid + k * THREADS;
            const int r = i / CPR, c = (i - r * CPR) * 8;
            v[k] = (i < ROWS * CPR && r < nrows)
                       ? *reinterpret_cast<const uint4*>(src + r * stride + c)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
    }
    // dst[r][c..c+7] = bf16(x * scale(r)), one rounding
    template <int LD, typename F>
    __device__ __forceinline__ void store(bf16* dst, int tid, F scale) const {
#pragma unroll
        for (int k = 0; k < CH; ++k) {
            const int i = tid + k * THREADS;
            if (i >= ROWS * CPR) continue;
            const int r = i / CPR, c = (i - r * CPR) * 8;
            const float f = scale(r);
            const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
            uint4 out;
            uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float2 x2 = __bfloat1622float2(in[q]);
                o[q] = pack_bf16(x2.x * f, x2.y * f);
            }
            *reinterpret_cast<uint4*>(dst + r * LD + c) = out;
        }
    }
};

// K3a: s_c [N, P] = b^T (exp(seg - cum) xdt), one (batch, head, chunk) a
// block: the whole chunk is staged at once (b by cp.async, x through
// registers, where it is scaled), then 8 warps share the 16 x 16 output
// units round-robin
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 2)
chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const bf16* __restrict__ bm,
                   float* __restrict__ s_out, float* __restrict__ eseg_out,
                   double* __restrict__ cum_out, float* __restrict__ dt_out, int S, int H,
                   int L) {
    using D = Dims<N, P>;
    constexpr int LDN = D::LDN, LDP = D::LDP;
    constexpr int NPP = D::PPAD / 16;
    constexpr int UNITS = (D::NPAD / 16) * NPP;
    constexpr int UPW = (UNITS + WARPS - 1) / WARPS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* cum = reinterpret_cast<double*>(smem_raw);    // [MAX_L]
    double* wtot = cum + MAX_L;                           // [8]
    float* dt_s = reinterpret_cast<float*>(wtot + 8);     // [MAX_L]
    float* w_s = dt_s + MAX_L;                            // [MAX_L] exp(seg - cum_s)
    bf16* b_s = reinterpret_cast<bf16*>(smem_raw + D::HEAD);   // [MAX_L][LDN]
    bf16* x_s = b_s + (MAX_L / TT) * D::BT;                    // [MAX_L][LDP]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nc = S / L;
    const int row = blockIdx.x / nc, ci = blockIdx.x - row * nc;
    const int bi = row / H, hi = row - bi * H;
    const size_t s0 = static_cast<size_t>(ci) * L;
    const size_t xrow = static_cast<size_t>(H) * P;
    const bf16* xb = x + (static_cast<size_t>(bi) * S + s0) * xrow + static_cast<size_t>(hi) * P;
    const float* dtb = dt + (static_cast<size_t>(bi) * S + s0) * H + hi;
    const bf16* bb = bm + (static_cast<size_t>(bi) * S + s0) * N;
    const int LK = (L + 15) & ~15;     // rows the products read: zero past L

    zero_pad<N, D::NPAD, LDN>(b_s, LK, tid);
    zero_pad<P, D::PPAD, LDP>(x_s, LK, tid);
    load_tile<N, LDN, MAX_L>(b_s, bb, N, L, tid);
    cp_async_commit();
    XRegs<P, MAX_L> xr;
    xr.load(xb, xrow, L, tid);
    chunk_cum<THREADS>(dtb, H, a[hi], L, cum, wtot, dt_s);
    const double seg = cum[L - 1];
    keep_cum(cum, dt_s, cum_out, dt_out, L, tid, THREADS);
    for (int t = tid; t < MAX_L; t += THREADS)
        w_s[t] = t < L ? expf(static_cast<float>(seg - cum[t])) : 0.f;
    if (tid == 0) eseg_out[blockIdx.x] = expf(static_cast<float>(seg));
    __syncthreads();
    // the B operand: exp(seg - cum_s) x_s dt_s in f32, rounded to bf16 once
    xr.template store<LDP>(x_s, tid, [&](int r) { return dt_s[r] * w_s[r]; });
    cp_async_wait_all();
    __syncthreads();

    float acc[UPW][2][4];
#pragma unroll
    for (int k = 0; k < UPW; ++k)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[k][j][i] = 0.f;
    const int ao = nk_off(lane, LDN), bo = kn_off(lane, LDP);
    for (int k0 = 0; k0 < LK; k0 += 16) {
#pragma unroll
        for (int k = 0; k < UPW; ++k) {
            const int u = warp + WARPS * k;
            if (u < UNITS) {
                const int mt = u / NPP, np = u - mt * NPP;
                uint32_t af[4], bfr[4];
                ldsm_x4_t(af, smem_u32(b_s + k0 * LDN + mt * 16 + ao));
                ldsm_x4_t(bfr, smem_u32(x_s + k0 * LDP + np * 16 + bo));
                mma16816(acc[k][0], af, bfr[0], bfr[1]);
                mma16816(acc[k][1], af, bfr[2], bfr[3]);
            }
        }
    }

    float* sb = s_out + static_cast<size_t>(blockIdx.x) * N * P;
#pragma unroll
    for (int k = 0; k < UPW; ++k) {
        const int u = warp + WARPS * k;
        if (u >= UNITS) continue;
        const int mt = u / NPP, np = u - mt * NPP;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                const int n = mt * 16 + (lane >> 2) + 8 * rr;
                const int p = np * 16 + j * 8 + 2 * (lane & 3);
                if (n < N && p < P)
                    *reinterpret_cast<float2*>(sb + n * P + p) =
                        make_float2(acc[k][j][2 * rr], acc[k][j][2 * rr + 1]);
            }
    }
}

// K3c: y for the t tiles q and T - 1 - q of one (batch, head, chunk), T the
// chunk's 64-step tiles: 8 warps of 16 rows, warps 0-3 on the heavier tile,
// 4-7 on the lighter (idle when both are one), so the two blocks of a
// 256-step chunk carry 4 + 1 and 3 + 2 s tiles. Every load is issued at
// once (the c tiles, the b and x tiles up to the heavier tile's diagonal by
// cp.async; cum, dt and h_in through registers), so a block waits for
// memory once; then x dt is formed in place and the products run without
// a barrier.
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 2)
chunk_scan_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bm,
                  const bf16* __restrict__ cm, const double* __restrict__ cum_g,
                  const float* __restrict__ dt_g, const float* __restrict__ h_in,
                  bf16* __restrict__ y, int S, int H, int L, int t_tiles) {
    using D = Dims<N, P>;
    constexpr int LDN = D::LDN, LDP = D::LDP;
    constexpr int KN = D::NPAD / 16;   // k-steps over the state
    constexpr int OT = D::PPAD / 8;    // 8-wide output tiles
    constexpr int HCH = (N * P / 4 + THREADS - 1) / THREADS;   // float4s of h_in a thread
    constexpr float LOG2E = 1.4426950408889634f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* cum = reinterpret_cast<double*>(smem_raw);    // [MAX_L]
    float* dt_s = reinterpret_cast<float*>(cum + MAX_L);  // [MAX_L]
    float* lc = dt_s + MAX_L;      // [MAX_L] (cum_s - cum at its tile's start) log2(e)
    float* dq = lc + MAX_L;        // [MAX_L] dt_s exp(cum at its tile's end - cum_s)
    bf16* c_s = reinterpret_cast<bf16*>(smem_raw + D::SCAN_HEAD);   // 2 x [TT][LDN]
    bf16* h_s = c_s + 2 * D::BT;                                    // [NPAD][LDP]
    bf16* b_s = h_s + D::HT;                    // s tile j at j * BT
    bf16* x_s = b_s + (MAX_L / TT) * D::BT;     // s tile j at j * XT

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int pairs = (t_tiles + 1) / 2;
    const int rc = blockIdx.x / pairs;                     // row * nc + chunk
    const int q = blockIdx.x - rc * pairs;
    const int nc = S / L;
    const int row = rc / nc, ci = rc - row * nc;
    const int bi = row / H, hi = row - bi * H;
    const int jhi = t_tiles - 1 - q;                       // warps 0-3
    const int g = warp >> 2;
    const int jt = g == 0 ? jhi : q;                       // this warp's t tile
    const bool active = g == 0 || q != jhi;
    const int span = (jhi + 1) * TT;                       // steps up to the heavier diagonal
    const size_t s0 = static_cast<size_t>(ci) * L;
    const size_t xrow = static_cast<size_t>(H) * P;
    const bf16* xb = x + (static_cast<size_t>(bi) * S + s0) * xrow + static_cast<size_t>(hi) * P;
    bf16* yb = y + (static_cast<size_t>(bi) * S + s0) * xrow + static_cast<size_t>(hi) * P;
    const bf16* bb = bm + (static_cast<size_t>(bi) * S + s0) * N;
    const bf16* cb = cm + (static_cast<size_t>(bi) * S + s0) * N;
    const double* cumb = cum_g + static_cast<size_t>(rc) * L;
    const float* dtb = dt_g + static_cast<size_t>(rc) * L;

    zero_pad<N, D::NPAD, LDN>(c_s, 2 * TT, tid);
    zero_pad<N, D::NPAD, LDN>(b_s, span, tid);
    zero_pad<P, D::PPAD, LDP>(x_s, span, tid);
    load_tile<N, LDN, TT>(c_s, cb + static_cast<size_t>(jhi) * TT * N, N,
                              min(TT, L - jhi * TT), tid);
    if (q != jhi)
        load_tile<N, LDN, TT>(c_s + D::BT, cb + static_cast<size_t>(q) * TT * N, N,
                                  min(TT, L - q * TT), tid);
    for (int j = 0; j <= jhi; ++j) {
        const int nr = min(TT, L - j * TT);
        load_tile<N, LDN, TT>(b_s + j * D::BT, bb + static_cast<size_t>(j) * TT * N, N,
                                  nr, tid);
        load_tile<P, LDP, TT>(x_s + j * D::XT, xb + static_cast<size_t>(j) * TT * xrow,
                                  xrow, nr, tid);
    }
    cp_async_commit();
    // cum up to the heavier diagonal (past the chunk: its last value, a
    // finite padding for rows past L), dt (0 past the chunk), h_in
    const int t = tid;   // MAX_L == THREADS: one step a thread
    const double cv = t < span ? cumb[min(t, L - 1)] : 0.0;
    const float dv = t < span && t < L ? dtb[t] : 0.f;
    // (a row's first chunk carries no state: h_in[0] = 0 is not read)
    const bool carried = ci > 0;
    const float* hb = h_in + static_cast<size_t>(rc) * N * P;
    float4 hv[HCH];
#pragma unroll
    for (int k = 0; k < HCH; ++k) {
        const int i = tid + k * THREADS;
        hv[k] = carried && i < N * P / 4 ? reinterpret_cast<const float4*>(hb)[i]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (t < span) {
        cum[t] = cv;
        dt_s[t] = dv;
    }
    // h_in rounded to bf16 once; rows and columns past N, P are zero
    if constexpr (N < D::NPAD || P < D::PPAD) {
        for (int i = tid; i < D::NPAD * D::PPAD; i += THREADS) {
            const int n = i / D::PPAD, p = i - n * D::PPAD;
            if (n >= N || p >= P) h_s[n * LDP + p] = __float2bfloat16(0.f);
        }
    }
#pragma unroll
    for (int k = 0; k < HCH; ++k) {
        const int i = tid + k * THREADS;
        if (i >= N * P / 4) continue;
        const int n = (4 * i) / P, p = 4 * i - n * P;   // P % 4 == 0: one row
        *reinterpret_cast<uint2*>(h_s + n * LDP + p) =
            make_uint2(pack_bf16(hv[k].x, hv[k].y), pack_bf16(hv[k].z, hv[k].w));
    }
    cp_async_wait_all();
    __syncthreads();
    // per step, relative to its own 64-step tile: the log2-scaled offset for
    // the diagonal weights, and the decay to the tile's end for the tiles
    // below a diagonal (all f64 differences, rounded to f32 once)
    if (t < span) {
        const int t_lo = t & ~(TT - 1), t_hi = min(t | (TT - 1), L - 1);
        lc[t] = static_cast<float>(cum[t] - cum[t_lo]) * LOG2E;
        dq[t] = dt_s[t] * expf(static_cast<float>(cum[t_hi] - cum[t]));
    }
    __syncthreads();
    if (!active) return;

    // rows this thread holds: tr0 and tr0 + 8 of its warp's 16 (chunk steps)
    const int w4 = warp & 3;
    const int t0 = jt * TT;
    const int tr0 = t0 + w4 * 16 + (lane >> 2);
    const double cum_t[2] = {cum[tr0], cum[tr0 + 8]};
    const float lc_t[2] = {lc[tr0], lc[tr0 + 8]};
    float yacc[OT][4];
#pragma unroll
    for (int i = 0; i < OT; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) yacc[i][k] = 0.f;

    // this warp's 16 rows of C as A fragments, then exp(cum_t) (C_t h_in)
    const int ko = nk_off(lane, LDN), vo = kn_off(lane, LDP);
    uint32_t cf[KN][4];
    {
        const bf16* cs = c_s + (g == 0 ? 0 : D::BT) + w4 * 16 * LDN + a_off(lane, LDN);
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) ldsm_x4(cf[ks], smem_u32(cs + ks * 16));
        if (carried) {
#pragma unroll
            for (int ks = 0; ks < KN; ++ks)
#pragma unroll
                for (int o = 0; o < OT; o += 2) {
                    uint32_t bv[4];
                    ldsm_x4_t(bv, smem_u32(h_s + ks * 16 * LDP + o * 8 + vo));
                    mma16816(yacc[o], cf[ks], bv[0], bv[1]);
                    mma16816(yacc[o + 1], cf[ks], bv[2], bv[3]);
                }
            const float e0 = expf(static_cast<float>(cum_t[0]));
            const float e1 = expf(static_cast<float>(cum_t[1]));
#pragma unroll
            for (int o = 0; o < OT; ++o) {
                yacc[o][0] *= e0;
                yacc[o][1] *= e0;
                yacc[o][2] *= e1;
                yacc[o][3] *= e1;
            }
        }
    }

    for (int j = 0; j <= jt; ++j) {
        // scores = C_t B_s^T (f32)
        const bf16* bs = b_s + j * D::BT;
        float sc[TT / 8][4];
#pragma unroll
        for (int i = 0; i < TT / 8; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) sc[i][k] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KN; ++ks)
#pragma unroll
            for (int i = 0; i < TT / 8; i += 2) {
                uint32_t bk[4];
                ldsm_x4(bk, smem_u32(bs + i * 8 * LDN + ks * 16 + ko));
                mma16816(sc[i], cf[ks], bk[0], bk[1]);
                mma16816(sc[i + 1], cf[ks], bk[2], bk[3]);
            }

        // W = scores exp(cum_t - cum_s) dt_s, formed in f32 (dt rides on W,
        // so x enters the product as it is, exact). On the diagonal tile
        // exp2(lc_t - lc_s), the mask on the exponent (s > t is never
        // exponentiated; past the chunk W = 0). Below it every s < t and
        // exp(cum_t - cum_s) = exp(cum_t - cum_end) exp(cum_end - cum_s),
        // cum_end at the s tile's last step: two factors <= 1.
        const int u0 = j * TT;
        if (j == jt) {
#pragma unroll
            for (int i = 0; i < TT / 8; ++i) {
                const int sl = u0 + i * 8 + 2 * (lane & 3);
                const float2 ls = *reinterpret_cast<const float2*>(lc + sl);
                const float2 ds = *reinterpret_cast<const float2*>(dt_s + sl);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int tl = tr0 + 8 * (k >> 1);
                    const int s = sl + (k & 1);
                    sc[i][k] = (s <= tl && s < L)
                                   ? sc[i][k] * exp2f(lc_t[k >> 1] - ((k & 1) ? ls.y : ls.x)) *
                                         ((k & 1) ? ds.y : ds.x)
                                   : 0.f;
                }
            }
        } else {
            const double end = cum[u0 + TT - 1];
            const float r0 = expf(static_cast<float>(cum_t[0] - end));
            const float r1 = expf(static_cast<float>(cum_t[1] - end));
#pragma unroll
            for (int i = 0; i < TT / 8; ++i) {
                const float2 qv = *reinterpret_cast<const float2*>(dq + u0 + i * 8 + 2 * (lane & 3));
                sc[i][0] *= r0 * qv.x;
                sc[i][1] *= r0 * qv.y;
                sc[i][2] *= r1 * qv.x;
                sc[i][3] *= r1 * qv.y;
            }
        }

        // y += W x: W as a pair of bf16 A operands in registers (hi, and the
        // f32 remainder lo), x by ldmatrix.trans as B
        const bf16* xs = x_s + j * D::XT;
#pragma unroll
        for (int kk = 0; kk < TT / 16; ++kk) {
            uint32_t hi[4], lo[4];
            split_bf16(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
            split_bf16(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
            split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
            split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int o = 0; o < OT; o += 2) {
                uint32_t bv[4];
                ldsm_x4_t(bv, smem_u32(xs + kk * 16 * LDP + o * 8 + vo));
                mma16816(yacc[o], hi, bv[0], bv[1]);
                mma16816(yacc[o + 1], hi, bv[2], bv[3]);
                mma16816(yacc[o], lo, bv[0], bv[1]);
                mma16816(yacc[o + 1], lo, bv[2], bv[3]);
            }
        }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int tl = tr0 + 8 * rr;
        if (tl >= L) continue;
        bf16* yr = yb + static_cast<size_t>(tl) * xrow + 2 * (lane & 3);
#pragma unroll
        for (int o = 0; o < OT; ++o)
            if (o * 8 + 2 * (lane & 3) < P)
                *reinterpret_cast<uint32_t*>(yr + o * 8) =
                    pack_bf16(yacc[o][2 * rr], yacc[o][2 * rr + 1]);
    }
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

size_t round256(size_t bytes) { return (bytes + 255) & ~static_cast<size_t>(255); }

// The workspace one launch uses, carved from one buffer: cum f64 and dt f32
// [rows * nc][L], s (s_c, then h_in) f32 [rows * nc][N][P], exp(seg) f32
// [rows * nc]; each region 256-byte aligned.
struct Workspace {
    double* cum;
    float* dt;
    float* s;
    float* eseg;
};

size_t workspace_bytes(size_t rc, int N, int P, int L) {
    return round256(8 * rc * L) + round256(4 * rc * L) + round256(4 * rc * N * P) +
           round256(4 * rc);
}

Workspace carve(void* base, size_t rc, int N, int P, int L) {
    unsigned char* p = static_cast<unsigned char*>(base);
    Workspace w;
    w.cum = reinterpret_cast<double*>(p);
    p += round256(8 * rc * L);
    w.dt = reinterpret_cast<float*>(p);
    p += round256(4 * rc * L);
    w.s = reinterpret_cast<float*>(p);
    p += round256(4 * rc * N * P);
    w.eseg = reinterpret_cast<float*>(p);
    return w;
}

template <typename T, int N, int P>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b,
                   const void* c, void* y, void* h, void* workspace, int B, int S, int H, int L,
                   cudaStream_t stream) {
    constexpr bool TC = sizeof(T) == 2;
    const int nc = S / L;
    const int rows = B * H;
    const long long rc = static_cast<long long>(rows) * nc;
    const int t_tiles = (L + TT - 1) / TT;
    if (rc * t_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    const float* dtp = static_cast<const float*>(dt);
    const float* ap = static_cast<const float*>(a);
    const Workspace ws = carve(workspace, static_cast<size_t>(rc), N, P, L);
    cudaError_t err;

    // K3a
    if constexpr (TC) {
        auto k = tc::chunk_state_kernel<N, P>;
        const size_t smem = tc::Dims<N, P>::STATE_SMEM;
        if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
        k<<<static_cast<int>(rc), tc::THREADS, smem, stream>>>(
            static_cast<const bf16*>(x), dtp, ap, static_cast<const bf16*>(b), ws.s, ws.eseg,
            ws.cum, ws.dt, S, H, L);
    } else {
        auto k = simt::chunk_state_kernel<N, P>;
        const size_t smem = simt::state_smem_bytes<N, P>();
        if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
        k<<<static_cast<int>(rc), simt::THREADS, smem, stream>>>(
            static_cast<const float*>(x), dtp, ap, static_cast<const float*>(b), ws.s, ws.eseg,
            ws.cum, ws.dt, S, H, L);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    // K3b
    const int np4 = N * P / 4;
    const int per_row = (np4 + PASS_THREADS - 1) / PASS_THREADS;
    state_pass_kernel<<<rows * per_row, PASS_THREADS, 0, stream>>>(
        ws.s, ws.eseg, static_cast<float*>(h), nc, np4, per_row);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    // K3c
    if constexpr (TC) {
        auto k = tc::chunk_scan_kernel<N, P>;
        const size_t smem = tc::Dims<N, P>::SCAN_SMEM;
        if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
        k<<<static_cast<int>(rc * ((t_tiles + 1) / 2)), tc::THREADS, smem, stream>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(b),
            static_cast<const bf16*>(c), ws.cum, ws.dt, ws.s, static_cast<bf16*>(y), S, H, L,
            t_tiles);
    } else {
        auto k = simt::chunk_scan_kernel<N, P>;
        const size_t smem = simt::scan_smem_bytes<N, P>();
        if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
        k<<<dim3(static_cast<unsigned>(rc), t_tiles), simt::THREADS, smem, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(b),
            static_cast<const float*>(c), ws.cum, ws.dt, ws.s, static_cast<float*>(y), S, H, L);
    }
    return cudaGetLastError();
}

#define SSD_SHAPES(X) X(4, 8) X(8, 16) X(16, 32) X(32, 64) X(64, 64) X(128, 64)

template <typename T>
cudaError_t dispatch(int N, int P, const void* x, const void* dt, const void* a,
                     const void* b, const void* c, void* y, void* h, void* workspace, int B,
                     int S, int H, int L, cudaStream_t stream) {
#define SSD_CASE(n_, p_) \
    if (N == n_ && P == p_) \
        return launch<T, n_, p_>(x, dt, a, b, c, y, h, workspace, B, S, H, L, stream);
    SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ssd_shape_supported(int N, int P) {
#define SSD_CASE(n_, p_) \
    if (N == n_ && P == p_) return 1;
    SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
    return 0;
}

int ssd_max_chunk() { return MAX_L; }

// Bytes of the workspace ssd_launch needs for these sizes (0 if invalid).
long long ssd_workspace_bytes(int B, int S, int H, int P, int N, int L) {
    if (B <= 0 || S <= 0 || H <= 0 || L <= 0 || S % L != 0) return 0;
    return static_cast<long long>(
        workspace_bytes(static_cast<size_t>(B) * H * (S / L), N, P, L));
}

// x [B, S, H, P], b/c [B, S, N] (bfloat16 if is_bf16, else float32),
// dt [B, S, H] and a [H] float32 -> y [B, S, H, P] (x's type),
// h [B, H, N, P] float32, through a workspace of ssd_workspace_bytes
// (256-byte aligned, overwritten). All contiguous device pointers, the
// bfloat16 ones 16-byte aligned; S % L == 0, 1 <= L <= 256. Launches the
// three stages on `stream` without synchronising; returns the first
// cudaError_t that is not cudaSuccess.
int ssd_launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
               void* y, void* h, void* workspace, int B, int S, int H, int P, int N, int L,
               int is_bf16, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || L <= 0 || L > MAX_L || S % L != 0 ||
        !ssd_shape_supported(N, P))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return static_cast<int>(
            dispatch<bf16>(N, P, x, dt, a, b, c, y, h, workspace, B, S, H, L, s));
    return static_cast<int>(
        dispatch<float>(N, P, x, dt, a, b, c, y, h, workspace, B, S, H, L, s));
}

}  // extern "C"
