// Mamba2 SSD (state-space duality), chunked, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `ssd_kernel` of
// src/repro/kernels/ssd/kernel.py (wrapper ops.py::ssd). Per (batch, head)
// row, per chunk of L steps (la = -dt * A, cum = prefix sum of la over the
// chunk, seg = cum[L-1], xdt = x * dt):
//
//     y[t]  = sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s) xdt[s]     intra-chunk
//           + exp(cum_t) (c_t . h)                                 carried state
//     h    <- exp(seg) h + sum_s exp(seg - cum_s) b_s xdt[s]^T     h is [N, P]
//
// in f32 whatever the input type (cum in f64, below); y in x's type,
// h_final in f32.
//
// What bounds it on this card: bytes, at both of zamba2's shapes, as
// chip_smoke.py's `ssd_cost` counts them (C B^T once per batch row, b and
// c shared by the heads). At the long prefill (B = 1, S = 32768, H = 80,
// P = N = 64, L = 256): 8.7e10 FLOP (0.088 ms at the bf16 tensor-core
// peak) against 0.69 GB (0.21 ms). At the request shape (B = 8, S = 512):
// 1.1e10 FLOP (0.011 ms) against 97 MB (0.029 ms). What holds this first
// version far above either bound is neither: the state recurrence makes
// the chunks of one row strictly sequential, so the parallel axis is
// batch x heads (80 rows for zamba2 at batch 1: fewer than the 132 SMs),
// and the FMAs run on the plain f32 units.
//
// What the design does about it (a first, simple kernel: plain f32 FMA,
// no tensor cores, no TMA):
// - ONE BLOCK PER (batch, head) ROW walks the row's chunks in order and
//   keeps h [N, P] in shared memory across them: the persistent block
//   the reference's own note names, in place of the TPU's sequential
//   chunk grid axis with h in VMEM scratch.
// - cum comes from a block-wide prefix sum (warp shuffles, then the warp
//   totals), one thread per step of the chunk (L <= 256), summed in f64:
//   the per-step log decays -dt*A are f32 products as in the reference,
//   but with A up to 16 |cum| reaches the thousands over a 256-step chunk,
//   where an f32 sum would cost exp(cum_t - cum_s) ~1e-4 of its value.
// - The TPU kernel materialises the L x L decay matrix in VMEM (256 KB in
//   f32 at L = 256), more than a block's 227 KB of shared memory. Here the
//   chunk is cut into 64-step tiles of t and s; for each pair with s-tile
//   <= t-tile the 64 x 64 weight tile (c_t . b_s) exp(cum_t - cum_s) is
//   computed on the fly into shared memory, and entries with s > t are set
//   to 0 WITHOUT evaluating exp (the mask on the exponent: a future delta
//   is positive and would overflow), then multiplied into the output tile
//   held in registers (each of 16 x 16 threads owns 4 rows x P/16 columns).
// - b and c are read once per batch row for all heads (indexed by the
//   row's batch): nothing is broadcast per head in device memory.
// Built without --use_fast_math: expf, not __expf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16; also one thread per step of a chunk
constexpr int TT = 64;        // steps per t tile and per s tile
constexpr int MAX_L = 256;    // longest chunk (one prefix-sum pass)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

template <int N, int P>
constexpr size_t smem_bytes() {
    return sizeof(double) * (MAX_L + 8) +                      // cum, warp totals
           sizeof(float) * (static_cast<size_t>(N) * P +       // h
                            2 * static_cast<size_t>(TT) * (N + 1) +  // c, b tiles
                            static_cast<size_t>(TT) * P +      // xdt tile
                            static_cast<size_t>(TT) * (TT + 1));     // weight tile
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ h_out,
           int S, int H, int L) {
    constexpr int NP = N + 1;          // padded rows of the c / b tiles
    constexpr int WP = TT + 1;
    constexpr int JP = (P + 15) / 16;  // output columns per thread
    constexpr int IN = (N + 15) / 16;  // state rows per thread
    extern __shared__ double smem[];
    double* cum = smem;                // [MAX_L]
    double* wtot = cum + MAX_L;        // [8]
    float* h_s = reinterpret_cast<float*>(wtot + 8);   // [N][P]
    float* c_s = h_s + N * P;          // [TT][NP]
    float* b_s = c_s + TT * NP;        // [TT][NP]
    float* xdt_s = b_s + TT * NP;      // [TT][P]
    float* w_s = xdt_s + TT * P;       // [TT][WP]

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int lane = tid & 31, warp = tid >> 5;
    const int row = blockIdx.x;        // batch * H + head
    const int bi = row / H;
    const int hi = row - bi * H;
    const float A = a[hi];

    const size_t xrow = static_cast<size_t>(H) * P;   // x / y elements per step
    const T* xb = x + static_cast<size_t>(bi) * S * xrow + static_cast<size_t>(hi) * P;
    T* yb = y + static_cast<size_t>(bi) * S * xrow + static_cast<size_t>(hi) * P;
    const float* dtb = dt + static_cast<size_t>(bi) * S * H + hi;   // step stride H
    const T* bb = bm + static_cast<size_t>(bi) * S * N;
    const T* cb = cm + static_cast<size_t>(bi) * S * N;

    for (int i = tid; i < N * P; i += THREADS) h_s[i] = 0.f;

    const int nc = S / L;
    for (int ci = 0; ci < nc; ++ci) {
        const size_t s0 = static_cast<size_t>(ci) * L;

        // 1. cum[t] = sum_{u<=t} -dt_u A over the chunk
        double val = tid < L ? static_cast<double>(-dtb[(s0 + tid) * H] * A) : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const double up = __shfl_up_sync(0xffffffffu, val, off);
            if (lane >= off) val += up;
        }
        __syncthreads();   // the previous chunk is done with cum, wtot and h_s
        if (lane == 31) wtot[warp] = val;
        __syncthreads();
        for (int w = 0; w < warp; ++w) val += wtot[w];
        if (tid < L) cum[tid] = val;
        __syncthreads();
        const double seg = cum[L - 1];

        // 2. y, one tile of 64 steps t at a time
        for (int t0 = 0; t0 < L; t0 += TT) {
            const int nt = min(TT, L - t0);
            for (int i = tid; i < TT * N; i += THREADS) {
                const int r = i / N, n = i - (i / N) * N;
                c_s[r * NP + n] = r < nt ? to_f32(cb[(s0 + t0 + r) * N + n]) : 0.f;
            }
            __syncthreads();

            // carried state: exp(cum_t) (c_t . h)
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
                    b_s[r * NP + n] = r < ns ? to_f32(bb[(s0 + u0 + r) * N + n]) : 0.f;
                }
                for (int i = tid; i < TT * P; i += THREADS) {
                    const int r = i / P, p = i - (i / P) * P;
                    xdt_s[r * P + p] = r < ns
                        ? to_f32(xb[(s0 + u0 + r) * xrow + p]) * dtb[(s0 + u0 + r) * H]
                        : 0.f;
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
                    if (p < P) yb[(s0 + t0 + t) * xrow + p] = from_f32<T>(acc[i][jj]);
                }
            }
            __syncthreads();   // c_s is restaged by the next t tile
        }

        // 3. h <- exp(seg) h + sum_s (exp(seg - cum_s) b_s) xdt[s]^T
        float hacc[IN][JP];
#pragma unroll
        for (int i = 0; i < IN; ++i)
#pragma unroll
            for (int jj = 0; jj < JP; ++jj) hacc[i][jj] = 0.f;
        for (int u0 = 0; u0 < L; u0 += TT) {
            const int ns = min(TT, L - u0);
            __syncthreads();
            for (int i = tid; i < TT * N; i += THREADS) {
                const int r = i / N, n = i - (i / N) * N;
                b_s[r * NP + n] = r < ns
                    ? to_f32(bb[(s0 + u0 + r) * N + n]) *
                          expf(static_cast<float>(seg - cum[u0 + r]))
                    : 0.f;
            }
            for (int i = tid; i < TT * P; i += THREADS) {
                const int r = i / P, p = i - (i / P) * P;
                xdt_s[r * P + p] = r < ns
                    ? to_f32(xb[(s0 + u0 + r) * xrow + p]) * dtb[(s0 + u0 + r) * H]
                    : 0.f;
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
        }
        // every read of the old h (step 2) lies behind the barriers above,
        // and each (n, p) is owned by one thread
        const float eseg = expf(static_cast<float>(seg));
#pragma unroll
        for (int i = 0; i < IN; ++i) {
            const int n = ty + 16 * i;
#pragma unroll
            for (int jj = 0; jj < JP; ++jj) {
                const int p = tx + 16 * jj;
                if (n < N && p < P) h_s[n * P + p] = h_s[n * P + p] * eseg + hacc[i][jj];
            }
        }
    }
    __syncthreads();
    float* hb = h_out + static_cast<size_t>(row) * N * P;
    for (int i = tid; i < N * P; i += THREADS) hb[i] = h_s[i];
}

template <typename T, int N, int P>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b,
                   const void* c, void* y, void* h, int B, int S, int H, int L,
                   cudaStream_t stream) {
    auto kernel = ssd_kernel<T, N, P>;
    const size_t smem = smem_bytes<N, P>();
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    kernel<<<B * H, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a), static_cast<const T*>(b), static_cast<const T*>(c),
        static_cast<T*>(y), static_cast<float*>(h), S, H, L);
    return cudaGetLastError();
}

#define SSD_SHAPES(X) X(4, 8) X(8, 16) X(16, 32) X(32, 64) X(64, 64) X(128, 64)

template <typename T>
cudaError_t dispatch(int N, int P, const void* x, const void* dt, const void* a,
                     const void* b, const void* c, void* y, void* h, int B, int S, int H,
                     int L, cudaStream_t stream) {
#define SSD_CASE(n_, p_) \
    if (N == n_ && P == p_) return launch<T, n_, p_>(x, dt, a, b, c, y, h, B, S, H, L, stream);
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

// x [B, S, H, P], b/c [B, S, N] (bfloat16 if is_bf16, else float32),
// dt [B, S, H] and a [H] float32 -> y [B, S, H, P] (x's type),
// h [B, H, N, P] float32; all contiguous device pointers; S % L == 0,
// 1 <= L <= 256. Launches on `stream` without synchronising; returns the
// cudaError_t.
int ssd_launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
               void* y, void* h, int B, int S, int H, int P, int N, int L, int is_bf16,
               void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || L <= 0 || L > MAX_L || S % L != 0 ||
        !ssd_shape_supported(N, P))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return static_cast<int>(
            dispatch<__nv_bfloat16>(N, P, x, dt, a, b, c, y, h, B, S, H, L, s));
    return static_cast<int>(dispatch<float>(N, P, x, dt, a, b, c, y, h, B, S, H, L, s));
}

}  // extern "C"
