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
// of 2 C d f). At mixtral-8x22b's width (E = 8, d = 6144, f = 16384):
// - the 1 x 32768-token prefill (C = 10240): 4.95e13 FLOP a layer, 50.0 ms at
//   the bf16 tensor-core peak, against 6.8 GB of weights and activations;
// - 8 x 512 prompt tokens (C = 1280): 6.18e12 FLOP, 6.25 ms, against 5.1 GB;
// - decode (C = 8): bytes, the 4.83 GB of expert weights (1.44 ms a layer).
//
// bf16 inputs (`wg`): two grouped GEMMs on wgmma, fed by TMA, one producer
// warpgroup (one thread issues the copies) and one or two consumer
// warpgroups of 64 rows each, over a ring of up to 192 KB of 128-byte swizzled
// shared memory guarded by full / empty mbarriers; one group of wgmmas
// stays in flight while the stage before it is released.
// - (a) GATE-UP: one block per (group, BM-slot tile of C, 128-wide tile of f).
//   Two f32 accumulators, g and u, share one x tile as their A operand
//   (K-major); each stage holds the x tile and two 64 x 64 boxes of each of
//   wg and wu, read MN-major straight from their [E, d, f] layout at
//   e = ge % E. m64n128k16 wgmmas. The epilogue writes silu(g) * u, rounded
//   to bf16 once (the third product's operand, as before), into an act
//   [GE, C, f] buffer the wrapper allocates.
// - (b) DOWN: one block per (group, BM-slot tile, BN-wide tile of d), BN = 256
//   (m64n256k16) with two consumers, 128 with one: act . wd[e] over the whole
//   f in registers, in one fixed order; the epilogue writes bf16 out
//   directly. No atomics, no f32 scratch, no memset, no rounding pass: two
//   calls on the same inputs give the same bits.
// - L2: the blocks of a group walk C within bands of 2 output-column tiles,
//   so the ~132 resident blocks share the weight tiles of a few bands and
//   the x or act tiles of most of C in L2, instead of each block reading
//   its expert's weights from device memory (C / 128 times over).
// - BM = 128 (two consumers) for C > 64, BM = 64 (one) for C <= 64: decode
//   (C = 8) streams each group's expert weights once at ~3 TB/s either way,
//   and the smaller tile halves the products spent on zero rows. TMA
//   zero-fills rows past C and columns or depth past d or f; stores past C
//   are masked. d and f must be multiples of 8 (16-byte rows).
// - The act round trip costs little: 2.68 GB written and read at
//   C = 10240 (~1.6 ms at 3.35 TB/s, ~3% of the 50 ms bound) and 0.34 GB at
//   C = 1280 (~0.2 ms). The f32 scratch it replaces was 2.01 GB at
//   C = 10240, so peak memory rises by 0.67 GB there.
// - Tensor maps come from cuTensorMapEncodeTiled, fetched through
//   cudaGetDriverEntryPoint, so the library needs no link to libcuda.
//   CUTLASS is not used.
//
// f32 inputs (`simt`) keep the first kernel unchanged: plain f32 FMA, each
// block (64 slots, 128 columns of f, one group) adding its partial down
// product into the zeroed f32 output with atomics. The f32 in-situ checks and
// the f32 model copies hold it at 1e-5 against an f64 oracle, which neither
// bf16 nor TF32 tensor-core products would meet.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + expf(-g)) * u; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialised (one producer warpgroup, NC consumers)

namespace wg {

constexpr int BK = 64;              // depth per stage: one 128-byte swizzle row
constexpr int BOX_B = 64 * BK * 2;  // bytes of one 64 x 64 weight box
// output-column tiles per band of blocks (chosen by timing widths from 1
// to 16 for each product at both prefill capacities on an H100 SXM)
constexpr int RASTER = 2;
constexpr int RING_BYTES = 192 * 1024;

template <int NC, bool GATED>
struct Cfg {
    static constexpr int BM = 64 * NC;
    // output columns per block: 128 for the gate-up (two accumulators make
    // it 256 wide in effect) and for one consumer; 256 for the down product
    static constexpr int BN = (!GATED && NC == 2) ? 256 : 128;
    static constexpr int THREADS = 128 * (NC + 1);
    static constexpr int A_BYTES = BM * BK * 2;
    static constexpr int B_BYTES = (BN / 64) * BOX_B;
    static constexpr int STAGE_BYTES = A_BYTES + (GATED ? 2 : 1) * B_BYTES;
    static constexpr int STAGES = RING_BYTES / STAGE_BYTES < 8 ? RING_BYTES / STAGE_BYTES : 8;
    // stages (1024-byte aligned for the swizzle), then full / empty barriers
    static constexpr size_t SMEM = size_t(STAGES) * STAGE_BYTES + 1024 + 2 * STAGES * 8;
    static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzle atoms");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spins until the phase of parity `parity` completes; a wait that outlasts
// ~2^35 cycles (~17 s) can only be a broken pipeline, and traps rather than hangs
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (!done && clock64() - t0 > (1LL << 35)) __trap();
    } while (!done);
}

// one box of a 3-D tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
           (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching the accumulators across the async wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] (K-major) . B[16 x 128] (MN-major), f32 accumulate
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// d[64 x 256] += A[64 x 16] (K-major) . B[16 x 256] (MN-major), f32 accumulate
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da, uint64_t db) {
    wgmma_m64n128k16(d, da, db);
}
__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t da, uint64_t db) {
    wgmma_m64n256k16(d, da, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// GATED: out = act [GE, C, N = f] = silu(x wg) * (x wu) over K = d, with
// tm_a = x {d, C, GE}, tm_b0 / tm_b1 = wg / wu {f, d, E}.
// Not GATED: out [GE, C, N = d] = act wd over K = f, with tm_a = act
// {f, C, GE}, tm_b0 = wd {d, f, E} (tm_b1 unused).
template <int NC, bool GATED>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
gmm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b0,
           const __grid_constant__ CUtensorMap tm_b1, bf16* __restrict__ out, int E, int C,
           int N, int K, int mt, int nt) {
    using Cf = Cfg<NC, GATED>;
    constexpr int STAGES = Cf::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cf::STAGE_BYTES);
    uint64_t* empty = full + STAGES;

    // block -> (group, row tile, column tile): bands of RASTER column tiles,
    // the row tiles walked within a band
    const int per_group = mt * nt;
    const int ge = blockIdx.x / per_group;
    int t = blockIdx.x - ge * per_group;
    const int band = t / (mt * RASTER);
    const int n_lo = band * RASTER;
    const int width = min(RASTER, nt - n_lo);
    t -= band * mt * RASTER;
    const int m0 = (t / width) * Cf::BM;
    const int n0 = (n_lo + t % width) * Cf::BN;
    const int e = ge % E;
    const int nk = (K + BK - 1) / BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], NC * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wgi = threadIdx.x >> 7;
    if (wgi == NC) {
        // ---- producer warpgroup: one thread keeps the ring of stages full
        if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == NC * 128) {
            int s = 0;
            uint32_t ph = 0;
            for (int kt = 0; kt < nk; ++kt) {
                mbar_wait(&empty[s], ph ^ 1);
                unsigned char* st = smem + s * Cf::STAGE_BYTES;
                mbar_expect_tx(&full[s], Cf::STAGE_BYTES);
                const int k0 = kt * BK;
                tma_load(st, &tm_a, &full[s], k0, m0, ge);
#pragma unroll
                for (int bx = 0; bx < Cf::BN / 64; ++bx) {
                    tma_load(st + Cf::A_BYTES + bx * BOX_B, &tm_b0, &full[s], n0 + 64 * bx, k0,
                             e);
                    if constexpr (GATED)
                        tma_load(st + Cf::A_BYTES + Cf::B_BYTES + bx * BOX_B, &tm_b1, &full[s],
                                 n0 + 64 * bx, k0, e);
                }
                if (++s == STAGES) {
                    s = 0;
                    ph ^= 1;
                }
            }
        }
    } else {
        // ---- consumer warpgroup wgi: rows wgi*64 .. +64 of the tile
        if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        constexpr int R = Cf::BN / 2;   // accumulator registers a thread holds
        float acc_g[R];
        float acc_u[GATED ? R : 1];
#pragma unroll
        for (int i = 0; i < R; ++i) acc_g[i] = 0.f;
        if constexpr (GATED) {
#pragma unroll
            for (int i = 0; i < R; ++i) acc_u[i] = 0.f;
        }
        // one group of wgmmas stays in flight: a stage is released once the
        // group of the stage after it has been issued
        int s = 0, prev = 0;
        uint32_t ph = 0;
        for (int kt = 0; kt < nk; ++kt) {
            mbar_wait(&full[s], ph);
            const uint32_t st = smem_u32(smem + s * Cf::STAGE_BYTES);
            const uint32_t a0 = st + wgi * 64 * 128;   // 64 rows of 128 bytes
            const uint32_t b0 = st + Cf::A_BYTES;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                // A: +32 bytes per k-step inside the swizzled row; B: +16 rows
                const uint64_t da = smem_desc(a0 + kk * 32, 16, 1024);
                wgmma_tile(acc_g, da, smem_desc(b0 + kk * 2048, BOX_B, 1024));
                if constexpr (GATED)
                    wgmma_tile(acc_u, da, smem_desc(b0 + Cf::B_BYTES + kk * 2048, BOX_B, 1024));
            }
            wgmma_commit();
            wgmma_wait<1>();
            if (kt > 0) mbar_arrive(&empty[prev]);
            prev = s;
            if (++s == STAGES) {
                s = 0;
                ph ^= 1;
            }
        }
        wgmma_wait<0>();
        fence_acc(acc_g);
        if constexpr (GATED) fence_acc(acc_u);

        // ---- epilogue: thread holds rows r, r + 8 and column pairs 8j + 2(lane % 4)
        const int lane = threadIdx.x & 31;
        const int row0 = m0 + wgi * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
        const int col0 = n0 + (lane & 3) * 2;
        bf16* ob = out + static_cast<size_t>(ge) * C * N;
#pragma unroll
        for (int j = 0; j < Cf::BN / 8; ++j) {
            const int col = col0 + 8 * j;
            if (col >= N) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int row = row0 + 8 * hh;
                if (row >= C) continue;
                float v0 = acc_g[4 * j + 2 * hh], v1 = acc_g[4 * j + 2 * hh + 1];
                if constexpr (GATED) {
                    v0 = silu_mul(v0, acc_u[4 * j + 2 * hh]);
                    v1 = silu_mul(v1, acc_u[4 * j + 2 * hh + 1]);
                }
                *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * N + col) =
                    pack_bf16(v0, v1);
            }
        }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
                cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a bf16 tensor [depth, rows, inner] (contiguous) read in boxes of
// 64 (inner) x box_rows x 1, 128-byte swizzled, zero-filled out of bounds
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, uint64_t inner,
              uint64_t rows, uint64_t depth, uint32_t box_rows) {
    const cuuint64_t dims[3] = {inner, rows, depth};
    const cuuint64_t strides[2] = {inner * 2, inner * rows * 2};
    const cuuint32_t box[3] = {64, box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, bool GATED>
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& b0, const CUtensorMap& b1,
                        bf16* out, int GE, int E, int C, int N, int K, cudaStream_t s) {
    using Cf = Cfg<NC, GATED>;
    auto kernel = gmm_kernel<NC, GATED>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Cf::SMEM));
    if (err != cudaSuccess) return err;
    const int mt = (C + Cf::BM - 1) / Cf::BM;
    const int nt = (N + Cf::BN - 1) / Cf::BN;
    const long long blocks = static_cast<long long>(GE) * mt * nt;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<unsigned>(blocks), Cf::THREADS, Cf::SMEM, s>>>(a, b0, b1, out, E, C, N,
                                                                       K, mt, nt);
    return cudaGetLastError();
}

template <int NC>
cudaError_t launch_ffn(EncodeTiled enc, const void* x, const void* wg, const void* wu,
                       const void* wd, void* out, void* act, int GE, int E, int C, int d,
                       int f, cudaStream_t s) {
    constexpr uint32_t BM = 64 * NC;
    CUtensorMap mx, mg, mu, ma, md;
    if (!make_map(enc, &mx, x, d, C, GE, BM) || !make_map(enc, &mg, wg, f, d, E, BK) ||
        !make_map(enc, &mu, wu, f, d, E, BK) || !make_map(enc, &ma, act, f, C, GE, BM) ||
        !make_map(enc, &md, wd, d, f, E, BK))
        return cudaErrorInvalidValue;
    cudaError_t err = launch_gemm<NC, true>(mx, mg, mu, static_cast<bf16*>(act), GE, E, C, f,
                                            d, s);
    if (err != cudaSuccess) return err;
    return launch_gemm<NC, false>(ma, md, md, static_cast<bf16*>(out), GE, E, C, d, f, s);
}

}  // namespace wg

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

}  // namespace

extern "C" {

// x [GE, C, d], wg/wu [E, d, f], wd [E, f, d], out [GE, C, d]: contiguous
// device pointers of one type (is_bf16: bfloat16, else float32), 16-byte
// aligned; GE % E == 0, d % 8 == 0, f % 8 == 0. `scratch` is the act buffer
// [GE, C, f] of bfloat16 for bf16 and unused for f32 (the f32 kernel adds
// into `out`, which it zeroes first). Launches on `stream` without
// synchronising; returns the first cudaError_t.
int moe_gmm_launch(const void* x, const void* wg, const void* wu, const void* wd, void* out,
                   void* scratch, int GE, int E, int C, int d, int f, int is_bf16,
                   void* stream) {
    if (GE <= 0 || E <= 0 || GE % E != 0 || C <= 0 || d <= 0 || f <= 0 || d % 8 != 0 ||
        f % 8 != 0 || GE > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        wg::EncodeTiled enc = wg::encoder();
        if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
        if (C <= 64)
            return static_cast<int>(
                wg::launch_ffn<1>(enc, x, wg, wu, wd, out, scratch, GE, E, C, d, f, s));
        return static_cast<int>(
            wg::launch_ffn<2>(enc, x, wg, wu, wd, out, scratch, GE, E, C, d, f, s));
    }
    const size_t n = static_cast<size_t>(GE) * C * d;
    cudaError_t err = cudaMemsetAsync(out, 0, n * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(simt::moe_gmm_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(simt::SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((C + simt::BC - 1) / simt::BC, (f + simt::BF - 1) / simt::BF, GE);
    simt::moe_gmm_f32_kernel<<<grid, simt::THREADS, simt::SMEM_BYTES, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<const float*>(wd),
        static_cast<float*>(out), E, C, d, f);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
