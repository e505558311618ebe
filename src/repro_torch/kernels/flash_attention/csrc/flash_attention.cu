// Causal flash attention (optional sliding window, GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `flash_attention_kernel` of
// src/repro/kernels/flash_attention/kernel.py (wrapper ops.py::flash_attention).
// For each query row t of head h, with kv head h / G (GQA, K/V never
// expanded):
//
//     s_j  = (q_t * scale) . k_j          for keys j <= t (and j > t - window)
//     out_t = sum_j softmax(s)_j v_j
//
// computed as an online softmax over key tiles, in f32 whatever the input
// type: a running max m, a running sum l and an f32 accumulator, with the
// reference's constants (masked scores are NEG_INF = -1e30, not -inf, and
// the final division is by max(l, 1e-30)).
//
// What bounds it on this card depends on S (hd = 80, H = K = 32, as
// chip_smoke.py's `fa_cost` counts it: 4 hd FLOP per visible (query, key)
// pair against q, k, v read and o written once). At the long prefill
// (B = 1, S = 32768): operations, 5.5e12 FLOP (5.6 ms at the bf16
// tensor-core peak) against 0.67 GB (0.20 ms). At the request shape
// (B = 8, S = 512): bytes, 1.1e10 FLOP (0.011 ms) against 84 MB
// (0.025 ms), since a row sees 256 keys on average there.
//
// What the design does about it (a first, simple kernel: plain f32 FMA on
// staged shared-memory tiles, no tensor cores, no TMA, no pipelining):
// - ONE BLOCK PER (batch*head, 64-row query tile); the TPU kernel's
//   sequential kv grid axis becomes a loop inside the block whose bounds
//   are the causal / window limits, so fully masked tiles are never
//   visited (the `pl.when` skip). The heaviest query tiles (last rows)
//   are scheduled first.
// - 256 threads as 16 x 16: each thread computes a 4 x 4 block of the
//   64 x 64 score tile (register blocking: 8 shared-memory loads feed 16
//   FMAs) and owns 4 rows x hd/16 columns of the output accumulator.
// - The 16 threads that share a row reduce its max and sum with warp
//   shuffles; probabilities go through shared memory to the P.V product.
// - Q, K, V are read in the model layout [B, S, heads, hd] directly (no
//   transposes); padded rows beyond S are zero and masked.
// hd is a template parameter (16, 32, 64, 80, 128); other values are
// refused by the wrapper. Built without --use_fast_math: expf, not __expf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile of the inner loop
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) * (static_cast<size_t>(BQ) * (HD + 1) +   // q tile (scaled)
                            static_cast<size_t>(BKV) * (HD + 1) +  // k tile
                            static_cast<size_t>(BKV) * HD +        // v tile
                            static_cast<size_t>(BQ) * (BKV + 1));  // probabilities
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                       int H, int K, int window, float scale) {
    static_assert(HD % 16 == 0, "hd must be a multiple of 16");
    constexpr int HDP = HD + 1;   // padded rows: column walks hit distinct banks
    constexpr int PW = BKV + 1;
    constexpr int J = HD / 16;    // output columns per thread
    extern __shared__ float smem[];
    float* q_s = smem;                 // [BQ][HDP]
    float* k_s = q_s + BQ * HDP;       // [BKV][HDP]
    float* v_s = k_s + BKV * HDP;      // [BKV][HD]
    float* p_s = v_s + BKV * HD;       // [BQ][PW]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.x;                         // b * H + h
    const int b = bh / H;
    const int h = bh - b * H;
    const int kvh = h / (H / K);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first

    const size_t q_row = static_cast<size_t>(H) * HD;
    const size_t kv_row = static_cast<size_t>(K) * HD;
    const T* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * HD;
    const T* kb = k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * HD;
    const T* vb = v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * HD;
    T* ob = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * HD;

    for (int i = tid; i < BQ * HD; i += THREADS) {
        const int r = i / HD, d = i - (i / HD) * HD;
        const int s = q0 + r;
        q_s[r * HDP + d] = s < Sq ? to_f32(qb[static_cast<size_t>(s) * q_row + d]) * scale : 0.f;
    }

    float m[4], l[4], acc[4][J];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < J; ++jj) acc[i][jj] = 0.f;
    }

    // key tiles that hold any key some row of this tile may see
    const int q_last = min(q0 + BQ, Sq) - 1;
    const int kt_end = min(q_last, Skv - 1) / BKV;
    int kt_begin = 0;
    if (window > 0) {
        const int lo = q0 - window + 1;
        kt_begin = lo > 0 ? lo / BKV : 0;
    }

    for (int kt = kt_begin; kt <= kt_end; ++kt) {
        const int k0 = kt * BKV;
        __syncthreads();   // the previous tile's k_s / v_s / p_s are consumed
        for (int i = tid; i < BKV * HD; i += THREADS) {
            const int r = i / HD, d = i - (i / HD) * HD;
            const int s = k0 + r;
            float kk = 0.f, vv = 0.f;
            if (s < Skv) {
                kk = to_f32(kb[static_cast<size_t>(s) * kv_row + d]);
                vv = to_f32(vb[static_cast<size_t>(s) * kv_row + d]);
            }
            k_s[r * HDP + d] = kk;
            v_s[r * HD + d] = vv;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * HDP + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * HDP + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty + 16 * i;
            float rmax = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                bool ok = kpos <= qpos && kpos < Skv;
                if (window > 0) ok = ok && kpos > qpos - window;
                if (!ok) sc[i][j] = NEG_INF;
                rmax = fmaxf(rmax, sc[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
            const float m_new = fmaxf(m[i], rmax);
            float rsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(sc[i][j] - m_new);
                p_s[(ty + 16 * i) * PW + tx + 16 * j] = p;
                rsum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
            const float corr = expf(m[i] - m_new);
            l[i] = l[i] * corr + rsum;
            m[i] = m_new;
#pragma unroll
            for (int jj = 0; jj < J; ++jj) acc[i][jj] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BKV; ++c) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PW + c];
#pragma unroll
            for (int jj = 0; jj < J; ++jj) {
                const float vv = v_s[c * HD + tx + 16 * jj];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= Sq) continue;
        const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
            ob[static_cast<size_t>(row) * q_row + tx + 16 * jj] = from_f32<T>(acc[i][jj] / denom);
    }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int K, int window, float scale, cudaStream_t stream) {
    auto kernel = flash_attention_kernel<T, HD>;
    const size_t smem = smem_bytes<HD>();
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Sq, Skv, H, K, window, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Skv, int H, int K, int window, float scale,
                     cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, K, window, scale, stream);
        case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, K, window, scale, stream);
        case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, K, window, scale, stream);
        case 80: return launch<T, 80>(q, k, v, o, B, Sq, Skv, H, K, window, scale, stream);
        case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, K, window, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

int flash_attention_head_dim_supported(int hd) {
    return hd == 16 || hd == 32 || hd == 64 || hd == 80 || hd == 128;
}

// q [B, Sq, H, hd], k/v [B, Skv, K, hd], o [B, Sq, H, hd], all contiguous
// device pointers of one type (is_bf16: bfloat16, else float32); H % K == 0.
// Launches on `stream` without synchronising; returns the cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                           int Sq, int Skv, int H, int K, int hd, int window, float scale,
                           int is_bf16, void* stream) {
    if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
        !flash_attention_head_dim_supported(hd))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return static_cast<int>(dispatch<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, K,
                                                         window, scale, s));
    return static_cast<int>(dispatch<float>(hd, q, k, v, o, B, Sq, Skv, H, K, window,
                                            scale, s));
}

}  // extern "C"
