// Fused flat zone scan (PTMT Phase 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel `fused_zone_scan_flat` of the JAX package
// (src/repro/kernels/zone_scan/zone_scan.py:429, body `_fused_kernel` at
// :336).  That kernel sweeps 512-lane blocks over whole [lo, hi) windows
// in order, with lane state in VMEM.  Here there is no sequential grid and
// state is scarce, so the shape follows the compiled JAX lowering instead:
//
// * one thread per slot q of the flat stream.  A thread whose slot is
//   invalid, or lies past its block's window, writes length 0 and code 0;
// * the thread seeds its candidate at slot q and sweeps the later slots of
//   its own zone row: rows are contiguous runs of equal zone_id, so the
//   row ends at the first slot of another zone (the stream pad has
//   zone_id -1), or at hi[q / blk] (the host-planned window end: zone
//   end, or the Lemma-4.1 horizon cut under bounds="live"), whichever
//   comes first.  Starting at q instead of the row start is exact: before
//   its seed a lane has length 0, so it is inactive and no edge touches it;
// * the sweep stops once the lane timed out or holds l_max edges.  After
//   either, no edge can change code or length (a time-out only sets
//   `done`, which the outputs never read), so the stop is exact.  It is the
//   per-lane form of the TPU kernel's chunk skip;
// * lane state (length, last_t, done, n_nodes, nodes[K], code[L], and
//   ts[l_max] with WITH_TS) lives in registers, l_max and WITH_TS are
//   template parameters (see edge_update.cuh).
//
// WITH_TS is the TPU kernel's `with_ts=True` variant (state and output at
// zone_scan.py:381, :425-426, :484-485): it also writes ts[S, l_max], the
// absorption time of each step, for the config-lattice co-mining fold.
//
// What bounds it on this card: integer operations, and the idle lanes of
// a warp that runs as long as its longest lane.  Each visited slot costs
// ~2K compares for the node-table lookup plus the gap test and ~5 loads;
// the bytes the function must move (5 int32 inputs per slot plus (L+1)
// int32 outputs) are a few MB per launch.  At the full-size configuration
// lanes of the one-zone bucket cross up to 8,193 slots while the median
// lane visits a handful, so lanes that each sweep their own row keep ~10%
// of a warp's lane-steps busy.  The row sweep is therefore the dense
// kernel's ptmt::sweep_row_warp (edge_update.cuh): each lane sweeps at
// most kSoloSlots = 32 slots on its own, then the warp finishes the lanes
// left open one at a time, 32 slots per step, jumping from event to event
// (a time-out or an extension), which is exact.
//
// Row ends: sweep_row_warp's ZONE_ROWS switch gives it the flat stream's
// row test.  A lane alone stops at the first slot of another zone; in a
// cooperative step every lane also tests its slot's zone_id, a second
// __ballot_sync gives the first slot past the row, and only an event
// before it is applied.  This adds no pass and no array: each lane passes
// only its block's hi, and the plain version's row ends (ref.lane_windows)
// stay independent of the kernel.  A warp may straddle several zones, a
// zone end, the stream pad and a block's hi; every lane in the grid takes
// part in its warp's sweep (in_batch), and only live lanes sweep their own
// row.
//
// kThreads = 128, from the registers ptxas gives the two lane states (the
// lane's own and the cooperative copy): at l_max 6 a thread takes 61
// registers (70 with ts), so 8 (7) blocks of 128 are resident per SM and
// the 376,832-slot full-size stream runs in 2.8 (3.2) waves.  Smaller
// blocks also free their slot as soon as their 4 warps end, which the
// unequal warps of the cooperative sweep need (chip_smoke.py logs the
// registers, the resident blocks and the waves).
//
// C interface (bound with ctypes):
//   int fused_zone_scan_flat(u, v, t, valid, zone_id, hi, code, length, ts,
//                            n_slots, blk, delta, l_max, with_ts, stream)
// returns cudaGetLastError() after the launch (0 on success), or -1 for
// an l_max this build does not instantiate.  ts is ignored (may be null)
// when with_ts is 0.
//   int fused_zone_scan_flat_occupancy(l_max, with_ts, threads,
//                                      blocks_per_sm)
// writes the block size and the resident blocks per SM of that
// instantiation; returns cudaGetLastError() (0 on success), or -1 for an
// l_max this build does not instantiate.

#include <cuda_runtime.h>

#include "edge_update.cuh"

namespace {

constexpr int kThreads = 128;

// No __launch_bounds__: with it ptxas holds this kernel at the dense
// kernel's 56 registers (l_max 6) and spills 20 bytes inside the solo
// loop, stored and loaded on every slot; without it, 61 registers and no
// spill, 8 blocks of 128 per SM.
template <int LMAX, bool WITH_TS>
__global__ void fused_zone_scan_kernel(
    const int* __restrict__ u, const int* __restrict__ v,
    const int* __restrict__ t, const int* __restrict__ valid,
    const int* __restrict__ zone_id, const int* __restrict__ hi,
    int* __restrict__ code, int* __restrict__ length, int* __restrict__ ts,
    int n_slots, int blk, int delta) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  // every lane of a warp takes part in its sweep, past the stream too
  const bool in_batch = q < n_slots;
  int end = 0, zid = 0;
  bool live = false;
  if (in_batch) {
    end = min(hi[q / blk], n_slots);
    zid = zone_id[q];
    live = valid[q] != 0 && q < end;
  }

  ptmt::LaneState<LMAX, WITH_TS> s{};  // unseeded: all-zero outputs
  if (live) s.seed(u[q], v[q], t[q]);
  ptmt::sweep_row_warp<ptmt::kSoloSlots, LMAX, WITH_TS, true>(
      s, live, u, v, t, valid, q + 1, end, delta, zone_id, zid);
  if (in_batch) s.store(q, code, length, ts);
}

template <int LMAX, bool WITH_TS>
int launch(const int* u, const int* v, const int* t, const int* valid,
           const int* zone_id, const int* hi, int* code, int* length, int* ts,
           int n_slots, int blk, int delta, cudaStream_t stream) {
  if (n_slots > 0) {
    const int grid = (n_slots + kThreads - 1) / kThreads;
    fused_zone_scan_kernel<LMAX, WITH_TS><<<grid, kThreads, 0, stream>>>(
        u, v, t, valid, zone_id, hi, code, length, ts, n_slots, blk, delta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_zone_scan_flat(const int* u, const int* v, const int* t,
                                    const int* valid, const int* zone_id,
                                    const int* hi, int* code, int* length,
                                    int* ts, int n_slots, int blk, int delta,
                                    int l_max, int with_ts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTMT_CASE(L)                                                        \
  case L:                                                                   \
    return with_ts ? launch<L, true>(u, v, t, valid, zone_id, hi, code,     \
                                     length, ts, n_slots, blk, delta, s)    \
                   : launch<L, false>(u, v, t, valid, zone_id, hi, code,    \
                                      length, ts, n_slots, blk, delta, s);
  switch (l_max) {
    PTMT_CASE(1) PTMT_CASE(2) PTMT_CASE(3) PTMT_CASE(4) PTMT_CASE(5)
    PTMT_CASE(6) PTMT_CASE(7) PTMT_CASE(8) PTMT_CASE(9) PTMT_CASE(10)
    PTMT_CASE(11) PTMT_CASE(12) PTMT_CASE(13) PTMT_CASE(14)
    default:
      return -1;
  }
#undef PTMT_CASE
}

extern "C" int fused_zone_scan_flat_occupancy(int l_max, int with_ts,
                                              int* threads,
                                              int* blocks_per_sm) {
  *threads = kThreads;
#define PTMT_CASE(L)                                                        \
  case L:                                                                   \
    if (with_ts)                                                            \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
          blocks_per_sm, fused_zone_scan_kernel<L, true>, kThreads, 0);     \
    else                                                                    \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
          blocks_per_sm, fused_zone_scan_kernel<L, false>, kThreads, 0);    \
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
