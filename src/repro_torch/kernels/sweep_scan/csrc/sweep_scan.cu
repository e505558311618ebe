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
// Two float types, one schedule: T = double (the simulators' default) and
// T = float (REPRO_SIM_X64=0, the mode the TPU kernel ran in on its chip).
// Every function below that touches a time is a template on T, and the C
// interface at the end has an entry for each (`_f32` for float).
//
// What bounds it on this card: neither bytes nor arithmetic. One op-row
// moves 44 bytes in f64 (res 4, dur 8, lag 8, deps 16 read; end 8
// written; 32 in f32) and costs eight max/add operations, but every step
// waits for the one
// before it through avail[res] and end[dep], so a candidate is a chain
// of N dependent steps whose length is set by the latency of one
// dependent step. The only parallel axis is the candidate axis.
// chip_smoke.py times `chain_probe_kernel` below beside the chain: a
// dependent step through a shared-memory store and load, the step of a
// chain that forwards nothing in registers. The chain here forwards the
// row before in registers and skips that round trip, so the probe is a
// point of comparison, not a lower bound: this chain's own limit is the
// latency of its f64 select and add, and the issue of the instructions
// of a step by one thread.
//
// What the design does about it: ONE BLOCK OWNS ONE CANDIDATE (a loop in
// the block takes the place of the TPU's sequential grid axis), and the
// block is warp-specialised so that the chain's step touches nothing but
// shared memory and nothing it could have known earlier:
// - Lane 0 of warp 0 walks the chain. The other warps (STAGERS) stage the
//   op rows in tiles of TILE_ROWS into a ring of two tile buffers: tile
//   k + 1 is staged while the chain walks tile k. They load the rows
//   through registers (all of a thread's rows in flight at once), not by
//   cp.async, because they rewrite every row before the chain reads it.
// - Dependencies are resolved ahead of the chain. For a row i of tile
//   k + 1 (tile k, being walked, starts at base_k) a dep d is
//     d < 0 or d >= i:  not served yet (or none): reads 0.0, as the
//                       reference says (kernel.py:9-11); the stager points
//                       the slot at a shared 0.0;
//     d < base_k:       final, since the chain finished those rows before
//                       tile k began: the stager reads end[d] and folds it
//                       into the row's partial ready (`pre`) by a max;
//     base_k <= d < i:  left to the chain, which reads it from the window
//                       of the last two tiles' end values in shared memory
//                       that it writes itself as it goes.
//   A dep on row i - 1 itself is flagged instead, and so is a row whose
//   resource is row i - 1's (the stagers know both): the chain keeps the
//   last row's fin and lag in registers and forwards them (its end is
//   fin + lag, and fin is what avail[res] holds), and such a row loads
//   its avail from the shared 0.0. So no value the chain loads was
//   written by the step before: while row i is computed, row i + 1's
//   window values and avail are loaded (their addresses arrived a step
//   before), and row i + 2's staged operands. Only a flagged row waits
//   for the row before, through one +, one max and one + in f64; the
//   loads and stores ride beside the chain.
// - The stagers hand each row to the chain as addresses: of its window
//   values, of its own resolved max (`pre`) in a free slot, of a shared
//   0.0 for the rest, and of avail[res], so a step spends no instruction
//   on indexing and takes one max tree over four loaded values.
// - The chain keeps no makespan: a resource's fin only grows (fin >=
//   avail[res] + dur), so the max over the ops of fin is the max of the
//   final avail[R], which the stagers take once the chain is done.
// - end[N] lives in shared memory while it fits (END_IN_SMEM); the window
//   is then end itself. Above that, the window is a ring of 2 TILE_ROWS
//   values in shared memory. The chain writes only shared memory; the
//   stagers copy each tile's end values out to the candidate's `end`
//   row in device memory two tiles later (the last two once the chain is
//   done). avail[R] always lives in shared memory.
// - Handoff by named barriers, not __syncthreads: FULL[b] (the stagers
//   arrive when buffer b holds its tile, the chain waits) and EMPTY[b]
//   (the chain arrives when it has walked buffer b's tile, the stagers
//   wait before they stage the tile two ahead into it).
//
// Visibility invariant: a stager reads end[d] only for d < base_k, and
// only after it has passed EMPTY for tile k - 1, at which the chain
// arrives after its last write of tile k - 1. A barrier orders every
// memory access made before it against the threads that pass it, so those
// reads see the chain's values: from shared memory (end, or the ring for
// tile k - 1, which the chain overwrites only after the stagers hand it
// tile k + 1) or, below that, from device memory, where the stagers
// themselves copied the value out before an earlier EMPTY barrier that
// every stager passed (read through L2, ld.global.cg). The window the
// chain reads holds the last two tiles, written by the chain itself in
// program order (its loads and stores of shared memory are volatile, so
// they keep that order).
//
// Exactness: the result is the reference's to the bit on every input:
// negative values (a negative net_latency makes every lag negative),
// infinities and NaN included. Before the chain starts, the block reads
// its candidate's dur and lag once and picks one of two walks for the
// whole candidate (`__syncthreads_or`: one read of 16 bytes a row, no
// cost to a step of the chain):
// - every dur and lag >= 0 (-0.0 and +inf pass, NaN does not): the FAST
//   walk described above. Its maxes are a compare and a select (`dmax`)
//   in another grouping than the reference's; it drops the row before's
//   fin where that row's end (fin + lag) is also an operand, and it takes
//   the makespan from the final avail[R]. That is exact here: sums of
//   values >= 0 make no NaN, fin <= fin + lag, and a resource's fin only
//   grows (fin >= avail[res] + dur).
// - otherwise the GENERAL walk: the same schedule, with every max
//   propagating NaN (`nmax`), the ready time floored at the reference's
//   0.0, both the row before's fin and its end kept, and a running
//   makespan in the chain. A max regrouped is then exact unless an operand
//   is -0.0 (max(+0, -0) may return either).
// -0.0 arises in neither walk: a sum is -0.0 only when both operands are,
// and every fin is a max of values that are not -0.0 (the initial +0.0 of
// avail and of the end values, the 0.0 floor, and fins and ends before)
// plus a dur, every end a fin plus a lag. Every + is the reference's, on
// the same operands. Compile with -fmad=false so no later mul+add in this
// file can contract. All of this holds for T = float as for T = double:
// each + and max is one correctly rounded operation of T on the same
// operands as the reference's, which computes in T too.

#include <cuda_runtime.h>

namespace {

constexpr int MAXD = 4;          // dependency slots per op row
constexpr int TILE_ROWS = 256;   // op rows per tile
constexpr int WINDOW = 2 * TILE_ROWS;
constexpr int STAGER_WARPS = 7;
constexpr int THREADS = 32 * (1 + STAGER_WARPS);
constexpr int STAGERS = 32 * STAGER_WARPS;
constexpr int ROWS_PER_STAGER = (TILE_ROWS + STAGERS - 1) / STAGERS;
// named barriers 1..5 (0 is __syncthreads)
constexpr int BAR_FULL = 1;      // + buffer
constexpr int BAR_EMPTY = 3;     // + buffer
constexpr int BAR_DONE = 5;      // the chain has walked the last tile

__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}

// One staged op row, as the chain reads it: four shared-memory addresses
// whose values it takes the max of (its window values, `pre` when a slot
// is free, the shared 0.0 for the rest); `pre`, the max of the deps the
// stagers resolved (read through its slot); dur; lag; the address the
// chain loads avail[res] from (the 0.0 when the row before had the same
// resource, whose fin the chain forwards instead); and the address of
// avail[res] it stores fin to, with three flag bits: FWD, a dep on the
// row just before (whose end the chain forwards); SAME, the same resource
// as the row before (whose fin the chain forwards as avail); and DEP, FWD
// or SAME (start then waits for that row).
template <typename T>
struct Row {
    int4 slot;
    T pre, dur, lag;
    unsigned aload, astore;
};
// 48 bytes for both types (float's 36 pad to int4's 16-byte alignment)
static_assert(sizeof(Row<double>) == 48, "rows are 16-byte aligned");
static_assert(sizeof(Row<float>) == 48, "rows are 16-byte aligned");
constexpr unsigned FWD = 0x80000000u;
constexpr unsigned DEP = 0x40000000u;
constexpr unsigned SAME = 0x20000000u;
constexpr unsigned ADDR = 0x1fffffffu;
// each buffer holds two rows past a tile, which the chain reads (and never
// walks) when it loads two rows ahead
constexpr int ROWS_PER_BUF = TILE_ROWS + 2;

// the staged tile buffers; then avail[R], a 0.0, then the window / end
template <typename T>
struct Smem {
    Row<T>* rows;   // [2][ROWS_PER_BUF]
    T* avail;       // [R]
    T* W;           // W[-1] = 0.0; W[i] for END_IN_SMEM, else W[i % WINDOW]
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(void* raw, int R) {
    Smem<T> s;
    s.rows = static_cast<Row<T>*>(raw);
    s.avail = reinterpret_cast<T*>(s.rows + 2 * ROWS_PER_BUF);
    s.W = s.avail + R + 1;
    return s;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the chain's own loads and stores of avail and the window, by address;
// volatile keeps them in program order with each other
template <typename T>
__device__ __forceinline__ T lds(unsigned a);
template <>
__device__ __forceinline__ double lds<double>(unsigned a) {
    double v;
    asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a));
    return v;
}
template <>
__device__ __forceinline__ float lds<float>(unsigned a) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
    return v;
}
__device__ __forceinline__ void sts(unsigned a, double v) {
    asm volatile("st.shared.f64 [%0], %1;" ::"r"(a), "d"(v));
}
__device__ __forceinline__ void sts(unsigned a, float v) {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v));
}

// max of two values that are never NaN and never -0.0 (the fast walk,
// see the head note): a compare and a select, without fmax's NaN handling
template <typename T>
__device__ __forceinline__ T dmax(T a, T b) { return a > b ? a : b; }
// max that is NaN when either operand is, as the reference's maximum is
// (the general walk, and the stagers' resolved deps in both walks)
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
    return (a > b || a != a) ? a : b;
}

template <bool END_IN_SMEM>
__device__ __forceinline__ int widx(int i) {
    return END_IN_SMEM ? i : (i & (WINDOW - 1));
}

// The chain (warp 0; lane 0 walks, the warp takes part in the barriers).
// GENERAL picks the walk (see the head note); the general walk writes the
// makespan itself.
template <typename T, bool END_IN_SMEM, bool GENERAL>
__device__ __forceinline__ void walk(const Smem<T>& sm, int N, int n_tiles,
                                     T* __restrict__ makespan) {
    const int lane = threadIdx.x;
    const T zero = T(0);
    // the last row walked: its fin and lag; the running makespan (general)
    T fin_last = zero, l_last = zero, mk = zero;
    const unsigned w0 = smem_addr(sm.W);
    for (int k = 0; k < n_tiles; ++k) {
        const int b = k & 1;
        bar_sync(BAR_FULL + b);
        if (lane == 0) {
            const int base = k * TILE_ROWS;
            const int nb = min(TILE_ROWS, N - base);
            const Row<T>* rw = sm.rows + b * ROWS_PER_BUF;
            // row 0's operands and window values (every row a window slot
            // names was stored before this tile's barrier), row 1's operands
            T d = rw[0].dur, l = rw[0].lag;
            unsigned as = rw[0].astore;
            T e0, e1, e2, e3;
            {
                const int4 w = rw[0].slot;
                e0 = lds<T>(w.x), e1 = lds<T>(w.y), e2 = lds<T>(w.z),
                e3 = lds<T>(w.w);
            }
            T av = lds<T>(rw[0].aload);
            int4 w1 = rw[1].slot;
            T d1 = rw[1].dur, l1 = rw[1].lag;
            unsigned al1 = rw[1].aload, as1 = rw[1].astore;
#pragma unroll 2
            for (int li = 0; li < nb; ++li) {
                // row li + 2's staged operands, and row li + 1's window
                // values and avail, whose addresses arrived a step ago.
                // No slot names the row just before, and no avail load
                // its resource (both are forwarded in registers), so
                // every value loaded here was stored by an earlier step.
                const Row<T>& r2 = rw[li + 2];
                const int4 w2 = r2.slot;
                const T d2 = r2.dur, l2 = r2.lag;
                const unsigned al2 = r2.aload, as2 = r2.astore;
                const T f0 = lds<T>(w1.x), f1 = lds<T>(w1.y), f2 = lds<T>(w1.z),
                        f3 = lds<T>(w1.w);
                const T av1 = lds<T>(al1);
                T fin;
                if constexpr (GENERAL) {
                    // row li as the reference takes it: x, the ready time
                    // floored at 0.0 and avail when no row before forwards
                    // it; y, the row before's end (a dep on it), its fin
                    // (its resource), or the max of both
                    const T x = nmax(nmax(nmax(e0, e1), nmax(e2, e3)),
                                     nmax(av, zero));
                    const T end_last = fin_last + l_last;
                    const T y = (as & FWD)
                                         ? ((as & SAME) ? nmax(end_last, fin_last) : end_last)
                                         : fin_last;
                    fin = ((as & DEP) ? nmax(x, y) : x) + d;
                    mk = nmax(mk, fin);
                } else {
                    // row li. x: what start does not owe to the row just
                    // walked; y: what it does, its end (a dep on it) or its
                    // fin (its resource), and fin <= end since lag >= 0
                    const T x = dmax(dmax(dmax(e0, e1), dmax(e2, e3)), av);
                    const T y = fin_last + ((as & FWD) ? l_last : zero);
                    fin = ((as & DEP) ? dmax(x, y) : x) + d;
                }
                sts(as & ADDR, fin);
                sts(w0 + static_cast<unsigned>(sizeof(T)) *
                             static_cast<unsigned>(widx<END_IN_SMEM>(base + li)),
                    T(fin + l));
                fin_last = fin;
                l_last = l;
                d = d1, l = l1, as = as1;
                e0 = f0, e1 = f1, e2 = f2, e3 = f3, av = av1;
                w1 = w2;
                d1 = d2, l1 = l2, al1 = al2, as1 = as2;
            }
        }
        __syncwarp();
        if (k + 2 < n_tiles) bar_arrive(BAR_EMPTY + b);
    }
    if (GENERAL && lane == 0) makespan[blockIdx.x] = mk;
    bar_arrive(BAR_DONE);
}

template <typename T, bool END_IN_SMEM>
__global__ void __launch_bounds__(THREADS)
sweep_scan_kernel(const int* __restrict__ res, const T* __restrict__ dur,
                  const T* __restrict__ lag, const int* __restrict__ deps,
                  T* __restrict__ makespan, T* __restrict__ end_out, int N,
                  int R) {
    extern __shared__ int4 smem[];
    const Smem<T> sm = carve<T>(smem, R);
    const T zero_v = T(0);
    const int tid = threadIdx.x;
    const size_t row = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(N);
    res += row;
    dur += row;
    lag += row;
    const int4* deps4 = reinterpret_cast<const int4*>(deps) + row;
    end_out += row;

    for (int i = tid; i < R; i += THREADS) sm.avail[i] = zero_v;
    if (tid == 0) sm.W[-1] = zero_v;
    // rows never staged hold valid addresses too (the buffers' own start;
    // the chain loads through them two rows ahead and never walks them)
    for (int i = tid; i < 2 * ROWS_PER_BUF * 3; i += THREADS)
        reinterpret_cast<int4*>(sm.rows)[i] = make_int4(0, 0, 0, 0);
    // which walk (see the head note): general when any dur or lag is
    // negative or NaN. The one block-wide barrier: avail and the 0.0 are
    // set, and every thread knows the walk.
    bool off = false;
#pragma unroll 8
    for (int i = tid; i < N; i += THREADS)
        off |= !(__ldg(dur + i) >= zero_v) | !(__ldg(lag + i) >= zero_v);
    const bool general = __syncthreads_or(off) != 0;

    const int n_tiles = (N + TILE_ROWS - 1) / TILE_ROWS;
    if (tid < 32) {
        // ---- the chain: lane 0 walks, the warp takes part in the barriers
        if (general) walk<T, END_IN_SMEM, true>(sm, N, n_tiles, makespan);
        else walk<T, END_IN_SMEM, false>(sm, N, n_tiles, makespan);
    } else {
        // ---- the stagers
        const int st = tid - 32;
        const unsigned zero = smem_addr(sm.W - 1);
        // end values of tile t out to device memory, from shared memory
        // (end itself, or the window ring, which holds the last two tiles)
        auto copy_out = [&](int t) {
            const int base = t * TILE_ROWS, nb = min(TILE_ROWS, N - base);
            for (int li = st; li < nb; li += STAGERS)
                end_out[base + li] = sm.W[widx<END_IN_SMEM>(base + li)];
        };
        for (int k = 0; k < n_tiles; ++k) {
            const int b = k & 1;
            // buffer b held tile k - 2, and every end value below base_{k-1}
            // is final once the chain has walked tile k - 2
            if (k >= 2) {
                bar_sync(BAR_EMPTY + b);
                copy_out(k - 2);
            }
            const int base = k * TILE_ROWS;
            const int lo = base - TILE_ROWS;        // base of the tile being walked
            const int nb = min(TILE_ROWS, N - base);
            int4 dv[ROWS_PER_STAGER];
            int rv[ROWS_PER_STAGER], rp[ROWS_PER_STAGER];
            T duv[ROWS_PER_STAGER], lav[ROWS_PER_STAGER];
#pragma unroll
            for (int j = 0; j < ROWS_PER_STAGER; ++j) {
                const int li = st + j * STAGERS;
                if (li < nb) {
                    const int i = base + li;
                    dv[j] = deps4[i];
                    rv[j] = res[i];
                    rp[j] = i > 0 ? res[i - 1] : -1;
                    duv[j] = dur[i];
                    lav[j] = lag[i];
                }
            }
#pragma unroll
            for (int j = 0; j < ROWS_PER_STAGER; ++j) {
                const int li = st + j * STAGERS;
                if (li >= nb) continue;
                const int i = base + li;
                const int dd[MAXD] = {dv[j].x, dv[j].y, dv[j].z, dv[j].w};
                Row<T>& rw = sm.rows[b * ROWS_PER_BUF + li];
                unsigned slot[MAXD];
                bool fwd = false;
                T pre = zero_v;
#pragma unroll
                for (int q = 0; q < MAXD; ++q) {
                    const int d = dd[q];
                    slot[q] = zero;                     // not served yet / none: 0.0
                    if (d < 0 || d >= i) continue;
                    if (d == i - 1) {                   // forwarded by the chain
                        fwd = true;
                    } else if (d < lo) {                // final: resolved here
                        // tile k - 2 is still in the window; what lies below
                        // it was copied out before this tile's EMPTY barrier
                        const T e = (END_IN_SMEM || d >= lo - TILE_ROWS)
                                             ? sm.W[widx<END_IN_SMEM>(d)]
                                             : __ldcg(end_out + d);
                        pre = nmax(pre, e);
                    } else {                            // left to the chain
                        slot[q] = smem_addr(sm.W + widx<END_IN_SMEM>(d));
                    }
                }
                // pre goes in the first free slot (with four window deps
                // nothing was resolved here, and pre is 0.0)
                bool placed = false;
#pragma unroll
                for (int q = 0; q < MAXD; ++q)
                    if (!placed && slot[q] == zero) {
                        slot[q] = smem_addr(&rw.pre);
                        placed = true;
                    }
                const bool same = rp[j] == rv[j];
                const unsigned a = smem_addr(sm.avail + rv[j]);
                rw.slot = make_int4(slot[0], slot[1], slot[2], slot[3]);
                rw.pre = pre;
                rw.dur = duv[j];
                rw.lag = lav[j];
                rw.aload = same ? zero : a;
                rw.astore = a | (fwd ? FWD : 0u) | (same ? SAME : 0u) |
                            (fwd || same ? DEP : 0u);
            }
            bar_arrive(BAR_FULL + b);
        }
        // the last two tiles, once the chain is done with them; and, in
        // the fast walk, the makespan, max over the ops of fin: a
        // resource's fin only grows there (fin >= avail[res] + dur), so it
        // is the max of the final avail[R]
        bar_sync(BAR_DONE);
        for (int t = max(0, n_tiles - 2); t < n_tiles; ++t) copy_out(t);
        if (!general && st < 32) {
            T mk = zero_v;
            for (int r = st; r < R; r += 32) mk = dmax(mk, sm.avail[r]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mk = dmax(mk, __shfl_xor_sync(0xffffffffu, mk, off));
            if (st == 0) makespan[blockIdx.x] = mk;
        }
    }
}

template <typename T, bool END_IN_SMEM>
cudaError_t launch(const int* res, const T* dur, const T* lag, const int* deps, T* makespan,
                   T* end, int C, int N, int R, size_t smem_bytes, cudaStream_t stream) {
    auto kernel = sweep_scan_kernel<T, END_IN_SMEM>;
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
        if (err != cudaSuccess) return err;
    }
    kernel<<<C, THREADS, smem_bytes, stream>>>(res, dur, lag, deps, makespan, end, N, R);
    return cudaGetLastError();
}

// The latency of one dependent step through shared memory: one thread
// runs `steps` steps of the form of a chain without register forwarding
// (a window load that depends on the previous step's store, avail[r],
// max, two +, the stores) with one dependency on the row before and one
// resource. A point of comparison for the chain, not a bound under it
// (see the head note). Not on any path of the simulator; timed by
// chip_smoke.py.
__global__ void chain_probe_kernel(double* out, int steps) {
    __shared__ double W[WINDOW + 1];
    __shared__ double avail[2];
    if (threadIdx.x != 0) return;
    for (int i = 0; i <= WINDOW; ++i) W[i] = 0.0;
    avail[0] = avail[1] = 0.0;
    double mk = 0.0;
    for (int i = 0; i < steps; ++i) {
        const double e = W[(i + WINDOW - 1) & (WINDOW - 1)];
        const double fin = dmax(dmax(0.0, e), avail[0]) + 1.0;
        avail[0] = fin;
        W[i & (WINDOW - 1)] = fin + 0.5;
        mk = dmax(mk, fin);
    }
    out[0] = mk;
}

template <typename T>
int base_smem_bytes(int R) {
    return static_cast<int>(2 * ROWS_PER_BUF * sizeof(Row<T>) + sizeof(T) * (R + 1 + WINDOW));
}

template <typename T>
int launch_any(const void* res, const void* dur, const void* lag, const void* deps,
               void* makespan, void* end, int C, int N, int R, int end_in_smem, void* stream) {
    if (C <= 0 || N <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t base = static_cast<size_t>(base_smem_bytes<T>(R));
    auto s = static_cast<cudaStream_t>(stream);
    auto ri = static_cast<const int*>(res);
    auto di = static_cast<const int*>(deps);
    auto du = static_cast<const T*>(dur);
    auto la = static_cast<const T*>(lag);
    auto mk = static_cast<T*>(makespan);
    auto en = static_cast<T*>(end);
    if (end_in_smem)
        return static_cast<int>(launch<T, true>(ri, du, la, di, mk, en, C, N, R,
                                                base + sizeof(T) * static_cast<size_t>(N), s));
    return static_cast<int>(launch<T, false>(ri, du, la, di, mk, en, C, N, R, base, s));
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs besides end[N]: two staged tiles,
// avail[R], the 0.0 and the device-memory regime's window. The wrapper
// adds sizeof(T)*N when it picks the shared-memory regime.
int sweep_scan_base_smem_bytes(int R) { return base_smem_bytes<double>(R); }
int sweep_scan_base_smem_bytes_f32(int R) { return base_smem_bytes<float>(R); }

int sweep_scan_maxd() { return MAXD; }
int sweep_scan_tile_rows() { return TILE_ROWS; }

// res i32[C,N], dur/lag f64[C,N], deps i32[C,N,MAXD] -> makespan f64[C],
// end f64[C,N]; all contiguous device pointers. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 = ok).
int sweep_scan_launch(const void* res, const void* dur, const void* lag, const void* deps,
                      void* makespan, void* end, int C, int N, int R, int end_in_smem,
                      void* stream) {
    return launch_any<double>(res, dur, lag, deps, makespan, end, C, N, R, end_in_smem,
                              stream);
}

// The same in f32: dur/lag f32[C,N] -> makespan f32[C], end f32[C,N].
int sweep_scan_launch_f32(const void* res, const void* dur, const void* lag, const void* deps,
                          void* makespan, void* end, int C, int N, int R, int end_in_smem,
                          void* stream) {
    return launch_any<float>(res, dur, lag, deps, makespan, end, C, N, R, end_in_smem,
                             stream);
}

// One thread, `steps` dependent steps in shared memory (see
// chain_probe_kernel); out f64[1]. Launches on `stream`.
int sweep_scan_chain_probe(void* out, int steps, void* stream) {
    if (steps <= 0) return static_cast<int>(cudaErrorInvalidValue);
    chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<double*>(out), steps);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
