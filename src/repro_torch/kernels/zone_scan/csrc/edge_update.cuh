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
// sweep_row() is the one row sweep of every zone-scan kernel: a seeded
// lane reads the later slots of its own zone row and stops at the row's
// end or as soon as no later slot can change its outputs.

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

}  // namespace ptmt
