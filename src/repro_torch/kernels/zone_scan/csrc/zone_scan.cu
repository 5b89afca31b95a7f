// Dense per-zone scan (PTMT Phase 1) of a [Z, E] zone batch, for Hopper,
// sm_90a.
//
// Replaces the TPU kernel `zone_scan_pallas` of the JAX package
// (src/repro/kernels/zone_scan/zone_scan.py:245, body `_kernel` at :162),
// which `ops.scan_zones` vmaps over the zones of a batch
// (src/repro/kernels/zone_scan/ops.py:51), in both of its variants
// (`with_ts` is the template parameter WITH_TS here).  That kernel walks a
// grid of 512-candidate blocks by 256-edge blocks in order, carrying lane
// state in VMEM scratch across the edge axis, and skips a cell when its
// edges wholly precede the candidates (index skip, :195) or start after
// the block's last seed time plus l_max*delta (time skip, :196).  Its
// wrapper pads E to a multiple of 512 and fills pad times with the largest
// valid t only to keep those skips conservative.
//
// Here blocks run in parallel with no carried state, so the shape is the
// per-lane form of those skips:
//
// * one thread per (zone, slot) lane of the batch: grid ceil(Z*E /
//   kThreads) blocks, one launch per batch;
// * a thread whose slot is invalid writes length 0 and all-zero code (and
//   ts), exactly as the TPU kernel leaves a never-seeded lane;
// * a valid lane seeds at its own slot and sweeps only the later slots of
//   its own row (the index skip), stopping at the row's end or as soon as
//   it timed out or holds l_max edges — after which no edge changes its
//   outputs (the time skip, made exact per lane);
// * no padding of E and no fill of pad times: invalid slots gate nothing.
//
// What bounds it on this card: integer operations, and the idle lanes of
// a warp that runs as long as its longest lane.  Per visited slot a lane
// does ~2K compares for the node-table lookup plus the gap test; the bytes
// it must move are 4 int32 inputs and L + 1 (+ l_max with WITH_TS) int32
// outputs per slot.  At the full-size configuration the median lane visits
// 10 slots and the longest of a warp hundreds to thousands, so a warp of
// lanes that each sweep their own row keeps ~10% of its lane-steps busy.
// The row sweep is therefore ptmt::sweep_row_warp (edge_update.cuh): each
// lane sweeps at most kSoloSlots slots on its own, then the whole warp
// finishes the few lanes left open one at a time, 32 slots per step,
// jumping from event to event (a time-out or an extension; other slots
// change nothing), which is exact.  kSoloSlots = 32: at the full size 16
// leaves 2.3x as many lanes open (53,527 of 289,856 in the largest bucket
// against 22,794) for fewer warp-steps in all, but every open lane costs a
// broadcast of its state, and a cooperative step (32 loads and a ballot)
// costs more than a lone one (chip_smoke.py logs both counts; the two
// were not timed against each other).  kThreads = 128, from the registers ptxas gives the two lane
// states: at l_max 6 a thread takes 56 registers (70 with ts), so 9 (7)
// blocks of 128 are resident per SM and the largest full-size bucket
// (289,856 lanes) runs in 1.91 (2.45) waves; blocks of 256 fit 4 (3) per
// SM and leave a third wave 14% (86%) full.  Smaller blocks also free
// their slot as soon as their 4 warps end, which the unequal warps of the
// cooperative sweep need (chip_smoke.py logs the resident blocks and waves
// of every bucket).
//
// C interface (bound with ctypes):
//   int zone_scan_dense(u, v, t, valid, code, length, ts, n_zones, e_cap,
//                       delta, l_max, with_ts, stream)
// over row-major int32 [Z, E] inputs and code [Z, E, L], length [Z, E],
// ts [Z, E, l_max] outputs; returns cudaGetLastError() after the launch
// (0 on success), or -1 for an l_max this build does not instantiate.  ts
// is ignored (may be null) when with_ts is 0.
//   int zone_scan_dense_occupancy(l_max, with_ts, threads, blocks_per_sm)
// writes the block size and the resident blocks per SM of that
// instantiation; returns cudaGetLastError() (0 on success), or -1 for an
// l_max this build does not instantiate.

#include <cuda_runtime.h>

#include "edge_update.cuh"

namespace {

constexpr int kThreads = 128;

template <int LMAX, bool WITH_TS>
__global__ void __launch_bounds__(kThreads)
zone_scan_kernel(const int* __restrict__ u, const int* __restrict__ v,
                 const int* __restrict__ t, const int* __restrict__ valid,
                 int* __restrict__ code, int* __restrict__ length,
                 int* __restrict__ ts, long long n_lanes, int e_cap,
                 int delta) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  // every lane of a warp takes part in its sweep, past the batch too
  const bool in_batch = q < n_lanes;
  const bool live = in_batch && valid[q] != 0;
  const long long row_end = (in_batch ? q / e_cap + 1 : 0) * e_cap;

  ptmt::LaneState<LMAX, WITH_TS> s{};  // unseeded: all-zero outputs
  if (live) s.seed(u[q], v[q], t[q]);
  ptmt::sweep_row_warp<ptmt::kSoloSlots>(s, live, u, v, t, valid, q + 1,
                                         row_end, delta);
  if (in_batch) s.store(q, code, length, ts);
}

template <int LMAX, bool WITH_TS>
int launch(const int* u, const int* v, const int* t, const int* valid,
           int* code, int* length, int* ts, int n_zones, int e_cap,
           int delta, cudaStream_t stream) {
  const long long n_lanes = static_cast<long long>(n_zones) * e_cap;
  if (n_lanes > 0) {
    const long long grid = (n_lanes + kThreads - 1) / kThreads;
    zone_scan_kernel<LMAX, WITH_TS>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
            u, v, t, valid, code, length, ts, n_lanes, e_cap, delta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zone_scan_dense(const int* u, const int* v, const int* t,
                               const int* valid, int* code, int* length,
                               int* ts, int n_zones, int e_cap, int delta,
                               int l_max, int with_ts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTMT_CASE(L)                                                        \
  case L:                                                                   \
    return with_ts ? launch<L, true>(u, v, t, valid, code, length, ts,      \
                                     n_zones, e_cap, delta, s)              \
                   : launch<L, false>(u, v, t, valid, code, length, ts,     \
                                      n_zones, e_cap, delta, s);
  switch (l_max) {
    PTMT_CASE(1) PTMT_CASE(2) PTMT_CASE(3) PTMT_CASE(4) PTMT_CASE(5)
    PTMT_CASE(6) PTMT_CASE(7) PTMT_CASE(8) PTMT_CASE(9) PTMT_CASE(10)
    PTMT_CASE(11) PTMT_CASE(12) PTMT_CASE(13) PTMT_CASE(14)
    default:
      return -1;
  }
#undef PTMT_CASE
}

extern "C" int zone_scan_dense_occupancy(int l_max, int with_ts,
                                         int* threads, int* blocks_per_sm) {
  *threads = kThreads;
#define PTMT_CASE(L)                                                        \
  case L:                                                                   \
    if (with_ts)                                                            \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
          blocks_per_sm, zone_scan_kernel<L, true>, kThreads, 0);           \
    else                                                                    \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
          blocks_per_sm, zone_scan_kernel<L, false>, kThreads, 0);          \
    break;
  switch (l_max) {
    PTMT_CASE(1) PTMT_CASE(2) PTMT_CASE(3) PTMT_CASE(4) PTMT_CASE(5)
    PTMT_CASE(6) PTMT_CASE(7) PTMT_CASE(8) PTMT_CASE(9) PTMT_CASE(10)
    PTMT_CASE(11) PTMT_CASE(12) PTMT_CASE(13) PTMT_CASE(14)
    default:
      return -1;
  }
#undef PTMT_CASE
  return static_cast<int>(cudaGetLastError());
}
