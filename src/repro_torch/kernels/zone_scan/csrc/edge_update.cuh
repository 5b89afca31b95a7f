// Per-lane Phase-1 transition rule (Definitions 2-5) for Hopper kernels.
//
// One candidate process lives in one thread's registers.  This is the
// scalar, per-lane form of the transition rule the plain PyTorch version
// applies to a block of lanes (`_edge_update` in ../ref.py), with every
// int32 expression carried over exactly:
//   gap_ok    = t > last_t && t - last_t <= delta
//   timed_out = active && t - last_t > delta && gate
//   extend    = active && !timed_out && gap_ok && length < LMAX
//               && (u in nodes || v in nodes) && gate
// On extension the two first-occurrence digits label+1 land at digit
// positions 2*length and 2*length+1, shifted by 4*(6 - pos%7) into limb
// pos/7; a seed resets the lane to nodes = {u, v} (one node if u == v) and
// code digits 1 then 1 (u == v) or 2.
//
// The node table and the code limbs are fixed-size arrays indexed only by
// compile-time constants inside fully unrolled loops (writes are
// predicated), so they stay in registers: a dynamic index would spill them
// to local memory.  LMAX is a template parameter, K = LMAX + 1 <= 15 nodes
// and L = ceil(2*LMAX / 7) <= 4 limbs.
//
// WITH_TS adds the absorption timestamps ts[LMAX] (the co-mining input,
// `_edge_update` at src/repro/kernels/zone_scan/zone_scan.py:155-158):
// ts[length] = t on an extension, before the increment, and ts[0] = t on a
// seed; a lane that is never seeded keeps zeros.  The array is written in
// the same unrolled, predicated way, so it stays in registers too.
//
// sweep_row() is the per-lane row sweep of the flat kernel: a seeded lane
// reads the later slots of its own zone row and stops at the row's end or
// as soon as no later slot can change its outputs.  sweep_row_warp() is
// the same sweep for a whole warp of lanes (the dense kernel): each lane
// sweeps at most W slots on its own, then the warp finishes the lanes left
// open one at a time, 32 slots per step.

#pragma once

namespace ptmt {

constexpr int kDigitsPerLimb = 7;

template <int LMAX, bool WITH_TS = false>
struct LaneState {
  static constexpr int K = LMAX + 1;
  static constexpr int L = (2 * LMAX + kDigitsPerLimb - 1) / kDigitsPerLimb;
  static_assert(LMAX >= 1 && LMAX <= 14, "4-bit digits hold l_max <= 14");

  int length;
  int last_t;
  bool done;
  int n_nodes;
  int nodes[K];
  int code[L];
  int ts[WITH_TS ? LMAX : 1];  // read only when WITH_TS

  // The outputs of a lane that holds no process: length 0, all-zero code
  // and timestamps.
  __device__ __forceinline__ void clear() {
    length = 0;
#pragma unroll
    for (int m = 0; m < L; ++m) code[m] = 0;
    if constexpr (WITH_TS) {
#pragma unroll
      for (int i = 0; i < LMAX; ++i) ts[i] = 0;
    }
  }

  // Reset the lane to the process seeded by edge (u, v, t).
  __device__ __forceinline__ void seed(int u, int v, int t) {
    const bool same_uv = u == v;
    length = 1;
    last_t = t;
    done = false;
    n_nodes = same_uv ? 1 : 2;
#pragma unroll
    for (int i = 0; i < K; ++i) nodes[i] = -1;
    nodes[0] = u;
    if (!same_uv) nodes[1] = v;
#pragma unroll
    for (int m = 0; m < L; ++m) code[m] = 0;
    code[0] = (1 << (4 * (kDigitsPerLimb - 1)))
              + ((same_uv ? 1 : 2) << (4 * (kDigitsPerLimb - 2)));
    if constexpr (WITH_TS) {
#pragma unroll
      for (int i = 0; i < LMAX; ++i) ts[i] = 0;
      ts[0] = t;
    }
  }

  // Add digit `digit` at global digit position `pos`.
  __device__ __forceinline__ void append_digit(int pos, int digit) {
    const int limb = pos / kDigitsPerLimb;
    const int shift = 4 * (kDigitsPerLimb - 1 - pos % kDigitsPerLimb);
#pragma unroll
    for (int m = 0; m < L; ++m)
      if (m == limb) code[m] += digit << shift;
  }

  // Apply one edge to an active lane.  `gate` is the edge's eligibility for
  // this lane (a valid edge of the lane's own zone).  Returns false once no
  // later edge can change `code` or `length`: the lane timed out (which
  // only sets `done`, never read by the outputs) or is full.
  __device__ __forceinline__ bool update(int u, int v, int t, bool gate,
                                         int delta) {
    const bool active = length > 0 && !done;
    const int gap = t - last_t;
    const bool gap_ok = t > last_t && gap <= delta;
    const bool timed_out = active && gap > delta && gate;

    int u_pos = K, v_pos = K;
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      if (nodes[i] == u) u_pos = i;
      if (nodes[i] == v) v_pos = i;
    }
    const bool u_in = u_pos < K;
    const bool v_in = v_pos < K;
    const bool extend = active && !timed_out && gap_ok && length < LMAX
                        && (u_in || v_in) && gate;
    done = done || timed_out;
    if (extend) {
      const bool same_uv = u == v;
      const int label_u = u_in ? u_pos : n_nodes;
      const int nn1 = n_nodes + (u_in ? 0 : 1);
      const int label_v = same_uv ? label_u : (v_in ? v_pos : nn1);
      const int nn2 = same_uv ? nn1 : nn1 + (v_in ? 0 : 1);
      const bool put_u = !u_in;
      const bool put_v = !v_in && !same_uv;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (put_u && i == n_nodes) nodes[i] = u;
        if (put_v && i == nn1) nodes[i] = v;
      }
      append_digit(2 * length, label_u + 1);
      append_digit(2 * length + 1, label_v + 1);
      if constexpr (WITH_TS) {
#pragma unroll
        for (int i = 0; i < LMAX; ++i)
          if (i == length) ts[i] = t;
      }
      length += 1;
      last_t = t;
      n_nodes = nn2;
    }
    return !done && length < LMAX;
  }

  // Write the lane's outputs for slot q: code[q, 0:L], length[q] and, with
  // WITH_TS, ts[q, 0:LMAX] (row-major, as the wrappers allocate them).
  __device__ __forceinline__ void store(long long q, int* __restrict__ code_out,
                                        int* __restrict__ length_out,
                                        int* __restrict__ ts_out) const {
    length_out[q] = length;
#pragma unroll
    for (int m = 0; m < L; ++m) code_out[q * L + m] = code[m];
    if constexpr (WITH_TS) {
#pragma unroll
      for (int i = 0; i < LMAX; ++i) ts_out[q * LMAX + i] = ts[i];
    }
  }
};

// Sweep a seeded lane over slots [begin, end) of its zone row.  The row is
// either known by its end alone (zone_id == nullptr: the dense [Z, E]
// batch) or is the run of slots whose zone_id equals zid (the flat
// stream), and the sweep then stops at the first slot of another zone.
// It also stops as soon as the lane timed out or holds LMAX edges: after
// either, no edge can change code, length or ts (a time-out only sets
// `done`, which the outputs never read), so the cut is exact.  Invalid
// (padding) slots gate nothing and are skipped.
template <int LMAX, bool WITH_TS>
__device__ __forceinline__ void sweep_row(
    LaneState<LMAX, WITH_TS>& s, const int* __restrict__ u,
    const int* __restrict__ v, const int* __restrict__ t,
    const int* __restrict__ valid, const int* __restrict__ zone_id, int zid,
    int begin, int end, int delta) {
  if (s.length >= LMAX) return;
  for (int j = begin; j < end; ++j) {
    if (zone_id != nullptr && zone_id[j] != zid) break;
    if (!valid[j]) continue;
    if (!s.update(u[j], v[j], t[j], true, delta)) break;
  }
}

// True when edge (u, v, t) of a valid slot changes an open lane (active,
// length < LMAX): it times it out (t - last_t > delta) or extends it
// (0 < t - last_t <= delta and u or v already in its node table).  Any
// other slot — ties and earlier times included — leaves every output and
// `done` as they are under update(), so a sweep may jump from event to
// event.
template <int LMAX, bool WITH_TS>
__device__ __forceinline__ bool is_event(const LaneState<LMAX, WITH_TS>& s,
                                         int u, int v, int t, int delta) {
  const int gap = t - s.last_t;
  bool hit = false;
#pragma unroll
  for (int i = 0; i < LMAX + 1; ++i)
    hit |= (s.nodes[i] == u) | (s.nodes[i] == v);
  return gap > delta || (t > s.last_t && gap <= delta && hit);
}

// Copy lane `src`'s state into every lane's `c` (compile-time indices
// only, so the arrays stay in registers).
template <int LMAX, bool WITH_TS>
__device__ __forceinline__ void broadcast(LaneState<LMAX, WITH_TS>& c,
                                          const LaneState<LMAX, WITH_TS>& s,
                                          int src) {
  constexpr unsigned kAll = 0xffffffffu;
  c.length = __shfl_sync(kAll, s.length, src);
  c.last_t = __shfl_sync(kAll, s.last_t, src);
  c.done = __shfl_sync(kAll, static_cast<int>(s.done), src) != 0;
  c.n_nodes = __shfl_sync(kAll, s.n_nodes, src);
#pragma unroll
  for (int i = 0; i < LMAX + 1; ++i)
    c.nodes[i] = __shfl_sync(kAll, s.nodes[i], src);
#pragma unroll
  for (int m = 0; m < LaneState<LMAX, WITH_TS>::L; ++m)
    c.code[m] = __shfl_sync(kAll, s.code[m], src);
  if constexpr (WITH_TS) {
#pragma unroll
    for (int i = 0; i < LMAX; ++i) c.ts[i] = __shfl_sync(kAll, s.ts[i], src);
  }
}

// The sweep of sweep_row() for the 32 lanes of a warp, which must all call
// it (converged).  A lane with `live` set is seeded and sweeps slots
// [begin, end) of its row (absolute indices into u, v, t, valid); the
// others only help.  Phase 1: each live lane applies at most W slots on
// its own, as sweep_row() does.  Phase 2: the lanes still open (not timed
// out, not full, slots left) are finished one at a time, in lane order: the
// warp holds a copy of the lane's state, each lane tests one of the next 32
// slots for an event (is_event), and the first event in slot order
// (__ballot_sync, __ffs) is applied by every lane to its copy; the search
// goes on after it until a time-out, a full lane or the row end.  Slots
// that are no event change nothing, so this is the sequential sweep, slot
// for slot, whether or not the row is sorted by time.  Invalid slots are
// no event.
template <int W, int LMAX, bool WITH_TS>
__device__ __forceinline__ void sweep_row_warp(
    LaneState<LMAX, WITH_TS>& s, bool live, const int* __restrict__ u,
    const int* __restrict__ v, const int* __restrict__ t,
    const int* __restrict__ valid, long long begin, long long end,
    int delta) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  bool open = live && s.length < LMAX;
  long long j = begin;
  const long long stop = min(end, begin + W);
  for (; open && j < stop; ++j)
    if (valid[j]) open = s.update(u[j], v[j], t[j], true, delta);
  open = open && j < end;
  unsigned pending = __ballot_sync(kAll, open);
  while (pending) {
    const int owner = __ffs(pending) - 1;
    pending &= pending - 1;
    LaneState<LMAX, WITH_TS> c;
    broadcast(c, s, owner);
    long long base = __shfl_sync(kAll, j, owner);
    const long long row_end = __shfl_sync(kAll, end, owner);
    bool going = true;
    while (going && base < row_end) {
      const long long k = base + lane;
      int uk = 0, vk = 0, tk = 0;
      bool event = false;
      if (k < row_end && valid[k]) {
        uk = u[k];
        vk = v[k];
        tk = t[k];
        event = is_event(c, uk, vk, tk, delta);
      }
      const unsigned hits = __ballot_sync(kAll, event);
      if (hits == 0) {
        base += 32;
        continue;
      }
      const int first = __ffs(hits) - 1;
      going = c.update(__shfl_sync(kAll, uk, first),
                       __shfl_sync(kAll, vk, first),
                       __shfl_sync(kAll, tk, first), true, delta);
      base += first + 1;
    }
    if (lane == owner) s = c;
  }
}

}  // namespace ptmt
