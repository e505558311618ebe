// FIFO service-time scan of the sweep simulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `sweep_scan_kernel` of
// src/repro/kernels/sweep_scan/kernel.py. Per candidate, ops in array
// order:
//
//     ready  = max_j end[dep_j]        (dep -1, or not yet served: 0.0)
//     start  = max(ready, avail[res])
//     fin    = start + dur
//     avail[res] = fin
//     end[i] = fin + lag
//     makespan = max(makespan, fin)
//
// What bounds it on this card: neither bytes nor arithmetic. One op-row
// moves 44 bytes (res 4, dur 8, lag 8, deps 16 read; end 8 written) and
// costs eight f64 max/add operations, but every step waits for the one
// before it through avail[res] and end[dep], so a candidate is a chain
// of N dependent steps whose length is set by the latency of one
// dependent load. The only parallel axis is the candidate axis.
//
// What the design does about it: the TPU kernel walks a sequential grid
// axis with its carry in scratch memory; thread blocks on a GPU run in
// no order, so here ONE BLOCK OWNS ONE CANDIDATE and a loop inside the
// block takes the place of that grid axis. The block zeroes avail[R]
// and end[N] (the unserved-dep-reads-0.0 rule), then walks the op rows
// in tiles of TILE_ROWS: all threads stage the tile's res/dur/lag/deps
// into shared memory with coalesced loads (deps as one 16-byte load per
// row), one thread walks the chain reading only shared memory for its
// operands, and all threads write the tile's completion times out.
// avail[R] always lives in shared memory. end[N] lives in shared memory
// too while it fits (END_IN_SMEM, a dependent load is then a shared
// memory access), and in the candidate's `end` output row in device
// memory above that, where the chain thread reads back what it wrote
// itself (program order makes that safe; most of those reads hit L2).
//
// Arithmetic is fmax and + in f64, in the reference's order; compile
// with -fmad=false so no later mul+add in this file can contract.

#include <cuda_runtime.h>

namespace {

constexpr int MAXD = 4;          // dependency slots per op row
constexpr int TILE_ROWS = 256;   // op rows staged per step of the block loop
constexpr int THREADS = 128;

template <bool END_IN_SMEM>
__global__ void __launch_bounds__(THREADS)
sweep_scan_kernel(const int* __restrict__ res, const double* __restrict__ dur,
                  const double* __restrict__ lag, const int* __restrict__ deps,
                  double* __restrict__ makespan, double* end_out, int N, int R) {
    // the 16-byte rows first, so every array keeps its natural alignment
    // whatever the parity of R and N
    extern __shared__ int4 smem[];
    int4* deps_s = smem;                                       // [TILE_ROWS]
    double* avail = reinterpret_cast<double*>(deps_s + TILE_ROWS);  // [R]
    double* end_s = avail + R;                                 // [N] if END_IN_SMEM
    double* dur_s = end_s + (END_IN_SMEM ? N : 0);             // [TILE_ROWS]
    double* lag_s = dur_s + TILE_ROWS;                         // [TILE_ROWS]
    int* res_s = reinterpret_cast<int*>(lag_s + TILE_ROWS);    // [TILE_ROWS]

    const int tid = threadIdx.x;
    const size_t row = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(N);
    res += row;
    dur += row;
    lag += row;
    const int4* deps4 = reinterpret_cast<const int4*>(deps) + row;
    end_out += row;
    double* end = END_IN_SMEM ? end_s : end_out;

    for (int i = tid; i < R; i += THREADS) avail[i] = 0.0;
    for (int i = tid; i < N; i += THREADS) end[i] = 0.0;

    double mk = 0.0;
    for (int base = 0; base < N; base += TILE_ROWS) {
        const int nb = min(TILE_ROWS, N - base);
        for (int i = tid; i < nb; i += THREADS) {
            res_s[i] = res[base + i];
            dur_s[i] = dur[base + i];
            lag_s[i] = lag[base + i];
            deps_s[i] = deps4[base + i];
        }
        // staged operands (and, first time round, the zeroed carry) are
        // visible to the chain thread after this barrier
        __syncthreads();
        if (tid == 0) {
            for (int i = 0; i < nb; ++i) {
                const int4 d = deps_s[i];
                const double e0 = d.x >= 0 ? end[d.x] : 0.0;
                const double e1 = d.y >= 0 ? end[d.y] : 0.0;
                const double e2 = d.z >= 0 ? end[d.z] : 0.0;
                const double e3 = d.w >= 0 ? end[d.w] : 0.0;
                double ready = fmax(0.0, e0);
                ready = fmax(ready, e1);
                ready = fmax(ready, e2);
                ready = fmax(ready, e3);
                const int r = res_s[i];
                const double start = fmax(ready, avail[r]);
                const double fin = start + dur_s[i];
                avail[r] = fin;
                end[base + i] = fin + lag_s[i];
                mk = fmax(mk, fin);
            }
        }
        __syncthreads();
        if (END_IN_SMEM) {
            for (int i = tid; i < nb; i += THREADS) end_out[base + i] = end_s[base + i];
        }
    }
    if (tid == 0) makespan[blockIdx.x] = mk;
}

template <bool END_IN_SMEM>
cudaError_t launch(const int* res, const double* dur, const double* lag, const int* deps,
                   double* makespan, double* end, int C, int N, int R, size_t smem_bytes,
                   cudaStream_t stream) {
    auto kernel = sweep_scan_kernel<END_IN_SMEM>;
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
        if (err != cudaSuccess) return err;
    }
    kernel<<<C, THREADS, smem_bytes, stream>>>(res, dur, lag, deps, makespan, end, N, R);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs besides end[N]: avail[R] plus one
// staged tile. The wrapper adds 8*N when it picks the shared-memory regime.
int sweep_scan_base_smem_bytes(int R) {
    return static_cast<int>(sizeof(double) * R +
                            TILE_ROWS * (2 * sizeof(double) + sizeof(int4) + sizeof(int)));
}

int sweep_scan_maxd() { return MAXD; }

// res i32[C,N], dur/lag f64[C,N], deps i32[C,N,MAXD] -> makespan f64[C],
// end f64[C,N]; all contiguous device pointers. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 = ok).
int sweep_scan_launch(const void* res, const void* dur, const void* lag, const void* deps,
                      void* makespan, void* end, int C, int N, int R, int end_in_smem,
                      void* stream) {
    if (C <= 0 || N <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t base = static_cast<size_t>(sweep_scan_base_smem_bytes(R));
    auto s = static_cast<cudaStream_t>(stream);
    if (end_in_smem) {
        return static_cast<int>(launch<true>(
            static_cast<const int*>(res), static_cast<const double*>(dur),
            static_cast<const double*>(lag), static_cast<const int*>(deps),
            static_cast<double*>(makespan), static_cast<double*>(end), C, N, R,
            base + sizeof(double) * static_cast<size_t>(N), s));
    }
    return static_cast<int>(launch<false>(
        static_cast<const int*>(res), static_cast<const double*>(dur),
        static_cast<const double*>(lag), static_cast<const int*>(deps),
        static_cast<double*>(makespan), static_cast<double*>(end), C, N, R, base, s));
}

}  // extern "C"
