// Causal flash attention (optional sliding window, GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `flash_attention_kernel` of
// src/repro/kernels/flash_attention/kernel.py (wrapper ops.py::flash_attention).
// For each query row t of head h, with kv head h / G (GQA, K/V never
// expanded):
//
//     s_j  = scale * (q_t . k_j)          for keys j <= t (and j > t - window)
//     out_t = sum_j softmax(s)_j v_j
//
// computed as an online softmax over key tiles: a running max m, a running
// sum l and an f32 accumulator, with the reference's constants (masked
// scores are NEG_INF = -1e30, not -inf, and the final division is by
// max(l, 1e-30)). Q, K, V are read in the model layout [B, S, heads, hd]
// directly; rows past S load as zeros and are masked; key tiles that every
// row of a query tile masks are never visited (the `pl.when` skip); the
// heaviest query tiles (last rows) are scheduled first.
//
// What bounds it on this card (as chip_smoke.py's `fa_cost` counts it: 4 hd
// FLOP per visible (query, key) pair against q, k, v read and o written
// once, in bf16):
// - zamba2 (hd 80, H = K = 32), 1 x 32768: operations, 5.5e12 FLOP (5.6 ms
//   at the bf16 tensor-core peak) against 0.67 GB (0.20 ms);
// - mixtral (hd 128, 48/8, window 4096), 1 x 32768: operations, 3.1e12 FLOP
//   (3.1 ms) against 0.94 GB (0.28 ms);
// - both at 8 x 512: bytes (0.025 / 0.035 ms), a row sees ~256 keys.
//
// bf16 inputs (`tc`): a FlashAttention-2 design on the tensor cores.
// - ONE BLOCK PER (batch*head, 64-row query tile), 4 warps; each warp owns
//   16 query rows, and its Q fragments stay in registers for the whole key
//   loop (loaded once with ldmatrix).
// - Key tiles of 64 rows, double-buffered with cp.async (16-byte copies,
//   zero-filled past S) into shared memory whose rows are padded by 16
//   bytes, so ldmatrix's eight row addresses fall in distinct banks.
// - S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 out). The softmax scale is
//   applied to S in f32, folded with log2(e) so that exp2f gives the
//   exponentials; row max and row sum take two quad shuffles; the causal /
//   window / ragged-end mask is applied only on tiles that cross one of
//   those limits.
// - P is rounded to bf16 once in registers and reused directly as the A
//   operand of P V (the m16n8k16 accumulator layout of two adjacent 8-key
//   tiles is the A layout of one 16-key step), as in every FlashAttention-2;
//   V's B fragments come from ldmatrix.trans. P never goes to shared memory.
//   The row sums l are taken over the f32 P. The result differs from the
//   all-f32 plain version by that rounding of P (~2^-9 relative), inside
//   `_tol`'s bf16 2e-2.
// - hd in {16, 32, 64, 80, 128} is a template parameter: Q K^T takes hd/16
//   k-steps and P V hd/8 output tiles of 8, so hd = 80 needs no power of two.
//
// f32 inputs (`simt`) keep the first kernel unchanged: plain f32 FMA on
// staged shared-memory tiles (16 x 16 threads, each a 4 x 4 block of the
// 64 x 64 score tile), expf, probabilities through shared memory. The f32
// in-situ checks and the f32 model copies hold it at 1e-5, which neither
// bf16 nor TF32 tensor-core products would meet.
// Built without --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// --------------------------------------------------------------------------
// f32: plain FMA (the first kernel of this port, unchanged)

namespace simt {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile of the inner loop
constexpr int THREADS = 256;  // 16 x 16

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) * (static_cast<size_t>(BQ) * (HD + 1) +   // q tile (scaled)
                            static_cast<size_t>(BKV) * (HD + 1) +  // k tile
                            static_cast<size_t>(BKV) * HD +        // v tile
                            static_cast<size_t>(BQ) * (BKV + 1));  // probabilities
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
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
    const float* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * HD;
    const float* kb = k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * HD;
    const float* vb = v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * HD;
    float* ob = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * HD;

    for (int i = tid; i < BQ * HD; i += THREADS) {
        const int r = i / HD, d = i - (i / HD) * HD;
        const int s = q0 + r;
        q_s[r * HDP + d] = s < Sq ? qb[static_cast<size_t>(s) * q_row + d] * scale : 0.f;
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
                kk = kb[static_cast<size_t>(s) * kv_row + d];
                vv = vb[static_cast<size_t>(s) * kv_row + d];
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
            ob[static_cast<size_t>(row) * q_row + tx + 16 * jj] = acc[i][jj] / denom;
    }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int K, int window, float scale, cudaStream_t stream) {
    auto kernel = flash_attention_kernel<HD>;
    const size_t smem = smem_bytes<HD>();
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, K, window, scale);
    return cudaGetLastError();
}

}  // namespace simt

// --------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulators), cp.async

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;   // query rows per block, 16 per warp
constexpr int BKV = 64;          // keys per tile
constexpr int THREADS = 32 * WARPS;
constexpr int NT = BKV / 8;      // 8-key score tiles per warp and key tile

template <int HD>
struct Layout {
    static constexpr int LD = HD + 8;   // padded row (elements): HD/8 + 1 is odd
    static constexpr size_t Q_ELEMS = size_t(BQ) * LD;
    static constexpr size_t KV_ELEMS = size_t(BKV) * LD;
    // q tile, then two stages of (k tile, v tile)
    static constexpr size_t SMEM = 2 * (Q_ELEMS + 4 * KV_ELEMS);
};

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

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                            int Skv, int H, int K, int window, float scale_log2) {
    static_assert(HD % 16 == 0, "hd must be a multiple of 16");
    using L = Layout<HD>;
    constexpr int LD = L::LD;
    constexpr int KS = HD / 16;    // k-steps of Q K^T
    constexpr int OT = HD / 8;     // 8-wide output tiles of P V
    constexpr int CPR = HD / 8;    // 16-byte chunks per row
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
    bf16* kv_s = q_s + L::Q_ELEMS;   // stage s: k at (2s) * KV_ELEMS, v at (2s+1)

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh - b * H;
    const int kvh = h / (H / K);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first

    const size_t q_row = static_cast<size_t>(H) * HD;
    const size_t kv_row = static_cast<size_t>(K) * HD;
    const bf16* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * HD;
    const bf16* kb = k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * HD;
    const bf16* vb = v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * HD;
    bf16* ob = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * HD;

    const int q_last = min(q0 + BQ, Sq) - 1;
    const int kt_end = min(q_last, Skv - 1) / BKV;
    int kt_begin = 0;
    if (window > 0) {
        const int lo = q0 - window + 1;
        kt_begin = lo > 0 ? lo / BKV : 0;
    }

    auto load_kv = [&](int kt, int stage) {
        const int k0 = kt * BKV;
        bf16* ks = kv_s + (2 * stage) * L::KV_ELEMS;
        bf16* vs = ks + L::KV_ELEMS;
        for (int i = tid; i < BKV * CPR; i += THREADS) {
            const int r = i / CPR, c = (i - r * CPR) * 8;
            const bool ok = k0 + r < Skv;
            const size_t off = ok ? static_cast<size_t>(k0 + r) * kv_row + c : 0;
            cp_async16(smem_u32(ks + r * LD + c), kb + off, ok);
            cp_async16(smem_u32(vs + r * LD + c), vb + off, ok);
        }
    };

    for (int i = tid; i < BQ * CPR; i += THREADS) {
        const int r = i / CPR, c = (i - r * CPR) * 8;
        const bool ok = q0 + r < Sq;
        const size_t off = ok ? static_cast<size_t>(q0 + r) * q_row + c : 0;
        cp_async16(smem_u32(q_s + r * LD + c), qb + off, ok);
    }
    load_kv(kt_begin, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // this warp's 16 query rows as A fragments, one per k-step
    uint32_t qf[KS][4];
    {
        const bf16* base = q_s + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], smem_u32(base + ks * 16));
    }

    // rows this thread holds: r0 (lane / 4) and r0 + 8 of the warp's 16
    const int qpos0 = q0 + warp * 16 + (lane >> 2);
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};   // this thread's share of the row sums
    float acc[OT][4];
#pragma unroll
    for (int t = 0; t < OT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

    // per-lane ldmatrix offsets (elements) within a k / v tile
    const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
    const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

    for (int kt = kt_begin; kt <= kt_end; ++kt) {
        const int stage = (kt - kt_begin) & 1;
        if (kt < kt_end) {
            load_kv(kt + 1, stage ^ 1);
            cp_async_commit();
        }
        const bf16* ks = kv_s + (2 * stage) * L::KV_ELEMS;
        const bf16* vs = ks + L::KV_ELEMS;
        const int k0 = kt * BKV;

        // ---- S = Q K^T (f32)
        float s[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[t][i] = 0.f;
#pragma unroll
        for (int ksx = 0; ksx < KS; ++ksx) {
#pragma unroll
            for (int t = 0; t < NT; t += 2) {
                uint32_t bk[4];
                ldsm_x4(bk, smem_u32(ks + t * 8 * LD + ksx * 16 + k_off));
                mma16816(s[t], qf[ksx], bk[0], bk[1]);
                mma16816(s[t + 1], qf[ksx], bk[2], bk[3]);
            }
        }

        // ---- scale (log2 domain) and mask on the tiles that cross a limit
        const bool edge = (k0 + BKV - 1 > q0) || (k0 + BKV > Skv) ||
                          (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[t][i] *= scale_log2;
        if (edge) {
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int kpos = k0 + t * 8 + (lane & 3) * 2 + (i & 1);
                    const int qpos = qpos0 + (i >> 1) * 8;
                    bool ok = kpos <= qpos && kpos < Skv;
                    if (window > 0) ok = ok && kpos > qpos - window;
                    if (!ok) s[t][i] = NEG_INF;
                }
        }

        // ---- online softmax: row max over the quad, rescale, exponentials
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            corr[r] = exp2f(m[r] - mx[r]);
            m[r] = mx[r];
            l[r] *= corr[r];
        }
#pragma unroll
        for (int t = 0; t < OT; ++t) {
            acc[t][0] *= corr[0];
            acc[t][1] *= corr[0];
            acc[t][2] *= corr[1];
            acc[t][3] *= corr[1];
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            s[t][0] = exp2f(s[t][0] - m[0]);
            s[t][1] = exp2f(s[t][1] - m[0]);
            s[t][2] = exp2f(s[t][2] - m[1]);
            s[t][3] = exp2f(s[t][3] - m[1]);
            l[0] += s[t][0] + s[t][1];
            l[1] += s[t][2] + s[t][3];
        }

        // ---- O += P V: P (bf16, registers) as A, V by ldmatrix.trans as B
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
            const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                    pack_bf16(s[2 * j][2], s[2 * j][3]),
                                    pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                    pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
            for (int t = 0; t < OT; t += 2) {
                uint32_t bv[4];
                ldsm_x4_t(bv, smem_u32(vs + j * 16 * LD + t * 8 + v_off));
                mma16816(acc[t], pa, bv[0], bv[1]);
                mma16816(acc[t + 1], pa, bv[2], bv[3]);
            }
        }

        if (kt < kt_end) cp_async_wait_all();
        __syncthreads();   // this stage is consumed and the next one has landed
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = qpos0 + r * 8;
        if (row >= Sq) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        bf16* orow = ob + static_cast<size_t>(row) * q_row + (lane & 3) * 2;
#pragma unroll
        for (int t = 0; t < OT; ++t)
            *reinterpret_cast<uint32_t*>(orow + t * 8) =
                pack_bf16(acc[t][2 * r] * inv, acc[t][2 * r + 1] * inv);
    }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int K, int window, float scale, cudaStream_t stream) {
    auto kernel = flash_attention_bf16_kernel<HD>;
    const size_t smem = Layout<HD>::SMEM;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), Sq, Skv, H, K, window, scale * 1.4426950408889634f);
    return cudaGetLastError();
}

}  // namespace tc

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int K, int window, float scale, bool is_bf16,
                   cudaStream_t stream) {
    if (is_bf16) return tc::launch<HD>(q, k, v, o, B, Sq, Skv, H, K, window, scale, stream);
    return simt::launch<HD>(q, k, v, o, B, Sq, Skv, H, K, window, scale, stream);
}

cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Skv, int H, int K, int window, float scale, bool is_bf16,
                     cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<16>(q, k, v, o, B, Sq, Skv, H, K, window, scale, is_bf16, stream);
        case 32: return launch<32>(q, k, v, o, B, Sq, Skv, H, K, window, scale, is_bf16, stream);
        case 64: return launch<64>(q, k, v, o, B, Sq, Skv, H, K, window, scale, is_bf16, stream);
        case 80: return launch<80>(q, k, v, o, B, Sq, Skv, H, K, window, scale, is_bf16, stream);
        case 128: return launch<128>(q, k, v, o, B, Sq, Skv, H, K, window, scale, is_bf16, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

int flash_attention_head_dim_supported(int hd) {
    return hd == 16 || hd == 32 || hd == 64 || hd == 80 || hd == 128;
}

// q [B, Sq, H, hd], k/v [B, Skv, K, hd], o [B, Sq, H, hd], all contiguous
// device pointers of one type (is_bf16: bfloat16, else float32), 16-byte
// aligned; H % K == 0. Launches on `stream` without synchronising; returns
// the cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                           int Sq, int Skv, int H, int K, int hd, int window, float scale,
                           int is_bf16, void* stream) {
    if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
        !flash_attention_head_dim_supported(hd))
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch(hd, q, k, v, o, B, Sq, Skv, H, K, window, scale,
                                     is_bf16 != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
