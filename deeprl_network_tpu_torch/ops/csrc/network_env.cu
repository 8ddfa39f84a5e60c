// One control step of the store-and-forward ATSC engine (TrafficNetworkEnv) for NVIDIA
// Hopper (sm_90a), auto-reset included, as one launch for all B env rows.
//
// Replaces TrafficNetworkEnv.step of deeprl_network_tpu/envs/network.py (:216). That is not
// a Pallas kernel: the JAX package unrolls the step's 1-second substeps with
// lax.scan(..., unroll=control_interval_sec) (:289-293), and XLA fuses the whole step into
// one computation. The port's plain twin (ops/network_env.py network_env_step_ref) runs the
// same step as some 320 PyTorch ops; this kernel runs it, with the auto-reset select of
// AutoResetEnv.step, in one.
//
// For each env row b it computes, with the twin's op order and rounding points:
//   act = clamp(action, 0, n_valid - 1); lane l of node m gets gate = lane_gate[l, act[m]]
//   and switch = (act[m] != prev_phase[m]); inflow = demand[min(t, T_dem - 1)] * entry;
//   then control_interval_sec substeps k:
//     arriving = transit[0]; transit moves up one row (the last row empties);
//     q += arriving; overflow = max(q - cap, 0); q -= overflow;
//     g = gate * (1 - [k < yellow] * switch);
//     space = route @ max(cap - (q + sum_d transit), 0), over route_out where it is
//       above 1e-6, else cap;
//     dq = min(q, g * sat_flow, space); q2 = q - dq;
//     transit[slot] += route^T @ dq; free = max(cap - (q2 + sum_d transit), 0);
//     accepted = min(inflow, free); transit[slot] += accepted;
//     dropped = (dropped + sum(inflow - accepted)) + sum(overflow);
//     w = (w + 1) [q2 > 0.1] (1 - [dq > 1e-4]); q = q2;
//     throughput += sum(dq), arrived += sum(dq * max(1 - route_out, 0)),
//     entered += sum(accepted);
//   then t + 1 and done; node sums of q and w (the reward by objective, info's averages);
//   with auto_reset, a row that is done takes the reset state (queues reset_q0, or 0);
//   the observation of the state returned: per node the gathered, clamped lane features
//   (wave = q + sum_d transit; queue; wait) and the phase one-hot.
// slot is lane_delay - 1: row d of transit joins the queue after d + 1 more substeps.
//
// Bound: bytes. A 5x5-grid row (L = 300, D = 10, M = 25, obs [25, 12]) reads and writes
// its state (queue, transit and wait: 3,600 f32, and prev_phase, t, done, dropped), reads
// its action and one demand row, and writes obs, reward and info: about 32 KB a row,
// 24.5 MB at B = 768, 0.0073 ms at 3.35 TB/s. Monaco-28 (L = 148, D = 18, obs [28, 12])
// about 21 MB at B = 768. The arithmetic, some 100 operations a lane a substep, is far
// under the card's rate. chip_smoke.py env_bytes_flops counts the bytes of a call.
//
// What holds a row back is not its bytes but the work between barriers: five substeps of
// three phases, each lane's two transit sums of D shared loads, the five sums over lanes,
// for 768 rows resident at once. chip_smoke.py's env kernel phase times it. The design:
//   * one block per env row; a thread owns `lanes` lanes tid, tid + blockDim, ...; the
//     wrapper picks (lanes, threads) (ops/network_env.py launch_shape): one lane a thread
//     up to 160 lanes (the 3x3 grid, Monaco: 128 and 160 threads), two up to 2,048 (the
//     5x5 grid: 160 threads; the 10x10 grid: 608), more beyond. Each shape has an
//     instance whose __launch_bounds__ let six blocks share an SM (64 registers a thread
//     at 160 threads), so the flagship's 768 rows fit the 132 SMs in one wave, and one
//     instance for each topology of the port, with D and L constants;
//   * every per-lane invariant lives in registers before the substeps: the gate, the
//     switch, the inflow, route_out, the delay slot, and the route row's and column's at
//     most 3 (index, value) pairs, padded with (0, 0.0) (a padded term adds an exact +0);
//     the lane's queue and wait stay in registers too;
//   * transit stays in shared memory as a ring of D rows with a head index (the shift is
//     an index step), each row kept twice (rows r and r + D), so a lane's D rows in
//     order are rows head..head + D - 1 at constant offsets; only the lane's owner reads or
//     writes its column. The free space (read across lanes by `space`) and dq (read
//     across lanes by `routed`) are the only values exchanged, with __syncthreads()
//     between the substep's three phases;
//   * the row's transit block [D, L], queue and wait rows come in as three 1-D bulk
//     copies (cp.async.bulk, completed on an mbarrier) while the block clamps the
//     actions and gathers the gates and inflow; transit leaves in its row order as one
//     bulk store of ring rows head..head + D - 1, queue and wait as one each. The launch
//     refuses (cudaErrorInvalidValue) rows or pointers that are not 16-byte aligned;
//     every topology the port has is (L a multiple of 4);
//   * sums over lanes (dropped, throughput, arrived, entered) are a fixed tree: a thread's
//     lanes in order, the shuffle tree of each warp (warp_sums: five sums in 8 shuffles),
//     then each (substep, sum) pair over the warps in order by its own thread, then the
//     substeps in order by thread 0; node sums walk each node's lane list in ascending
//     order, one thread a node. No atomics: the step is deterministic;
//   * the products that feed a sum are rounded before the add (__fmul_rn, __fadd_rn), so
//     no contraction into an FMA departs from the twin's separate ops;
//   * every output is a new buffer; the input state is read once and never written.
// At one lane a thread its outputs are those of the first design bit for bit; at two, the
// sums over lanes pair lanes differently, so dropped and info's four sums differ from it
// in the last bits.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

// ops/network_env.py _DIMS, field for field
struct Dims {
  int L, M, P, D, W, T_dem, use_queue, use_wait, use_phase;
  // offsets into the int32 tables
  int pair_row, pair_col, lane_slot, lane_node, node_ptr, node_lane, gather, phase_col,
      n_valid;
  // offsets into the f32 tables
  int pair_row_val, pair_col_val, route_out, entry, demand, lane_gate, gmask;
  // the configuration
  int episode_steps, substeps, yellow, objective;
};

// ops/network_env.py _SCALARS, field for field
struct Scalars {
  float cap, sat_flow, norm_wave, clip_wave, norm_wait, clip_wait, coef_wait;
};

struct Args {
  Dims d;
  Scalars s;
  const int* it;
  const float* ft;
  const float* q_in;         // [B, L]
  const float* tr_in;        // [B, D, L]
  const float* w_in;         // [B, L]
  const long long* prev_in;  // [B, M]
  const long long* t_in;     // [B]
  const float* drop_in;      // [B]
  const long long* action;   // [B, M]
  const float* q0;           // [B, L] or null
  float* q_out;              // [B, L]
  float* tr_out;             // [B, D, L]
  float* w_out;              // [B, L]
  float* drop_out;           // [B]
  long long* prev_out;       // [B, M]
  long long* t_out;          // [B]
  bool* done_state;          // [B]
  bool* done_out;            // [B]
  float* obs;                // [B, M, W]
  float* reward;             // [B, M]
  float* info;               // 6 x [B]
  int B, auto_reset;
};

constexpr int kSums = 5;   // inflow - accepted, overflow, dq, arrived, accepted
constexpr int kPairs = 3;  // nonzeros of a route row or column, at most

// Byte offsets into dynamic shared memory: the mbarrier, then 16-byte aligned rows (L is a
// multiple of 4). x holds the free space and dq during the substeps, the observation's
// lane features after them.
struct Layout {
  unsigned ring, q, w, x, part, sums, node, act, total;
};

__host__ __device__ inline Layout layout(const Dims& d, int warps) {
  Layout o;
  unsigned at = 16;
  o.ring = at;  // [2D][L]: every ring row twice, rows r and r + D
  at += 8u * d.D * d.L;
  o.q = at;
  at += 4u * d.L;
  o.w = at;
  at += 4u * d.L;
  o.x = at;
  at += 12u * d.L;
  o.part = at;  // [substeps][warps][kSums]
  at += 4u * d.substeps * warps * kSums;
  o.sums = at;  // [substeps][kSums]
  at += 4u * d.substeps * kSums;
  o.node = at;  // [2][M]: node queue, node wait
  at += 8u * d.M;
  o.act = at;  // [M]
  at += 4u * d.M;
  o.total = at;
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the one arrival, and the bytes the copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
// this thread's writes to shared memory, visible to the bulk copies issued after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The five sums over a warp's lanes in 8 shuffles instead of 25. Each is the xor butterfly
// (lane i adds lane i ^ 16, then i ^ 8, ..., i ^ 1), whose pairs at each level are those of
// the shuffle-down tree's lane 0 with the operands at most swapped, so each sum equals
// that tree's bit for bit; the levels halve the sums a lane carries: lanes 0-15 carry
// v0, v1, v2 past level 16 and lanes 16-31 v3, v4; past level 8 one each, but lanes 0-7
// two (v0, v1); past level 4 one each. Returns the sum of this lane's group, and in *id
// which: v0 on lanes 0-3, v1 on 4-7, v2 on 8-15, v3 on 16-23, v4 on 24-31.
__device__ __forceinline__ float warp_sums(const float (&v)[kSums], int lane, int* id) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool hi = lane & 16, b3 = lane & 8, b2 = lane & 4;
  // level 16: each lane sends what its partner keeps
  const float r0 = __shfl_xor_sync(kAll, hi ? v[0] : v[3], 16);
  const float r1 = __shfl_xor_sync(kAll, hi ? v[1] : v[4], 16);
  const float r2 = __shfl_xor_sync(kAll, v[2], 16);
  const float a0 = (hi ? v[3] : v[0]) + r0;  // v0 below 16, v3 above
  const float a1 = (hi ? v[4] : v[1]) + r1;  // v1, v4
  const float a2 = v[2] + r2;                // v2 below 16
  // level 8: below 16, bit 3 clear keeps v0 (c0) and v1 (c1), set keeps v2 (c0);
  // above 16, clear keeps v3, set v4
  const float first = b3 ? (hi ? a1 : a2) : a0;
  const float r3 = __shfl_xor_sync(kAll, b3 ? a0 : (hi ? a1 : a2), 8);
  const float c0 = first + r3;
  const float c1 = a1 + __shfl_xor_sync(kAll, a1, 8);
  // level 4: lanes 0-7 part v0 (bit 2 clear) from v1 (set); the rest keep c0
  const bool two = !hi && !b3;
  const float r4 = __shfl_xor_sync(kAll, two && !b2 ? c1 : c0, 4);
  float e = (two && b2 ? c1 : c0) + r4;
  e += __shfl_xor_sync(kAll, e, 2);
  e += __shfl_xor_sync(kAll, e, 1);
  *id = hi ? (b3 ? 4 : 3) : (b3 ? 2 : (b2 ? 1 : 0));
  return e;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// sum over d < n of transit row d of a lane's column (col = ring + l), rows in order: row d
// is ring row (head + d) % D, kept at row head + d of the doubled ring. KN: n where the
// instance knows it (0: read n). The first row starts the sum: 0 + x is x, since no value
// the step adds up is -0 (each is a max with 0, a min of such, or a sum or product of
// them), and so below.
template <int KN>
__device__ __forceinline__ float transit_sum(const float* col, int head, int n, int L) {
  const float* p = col + head * L;
  if constexpr (KN > 0) {
    float s = p[0];
#pragma unroll
    for (int r = 1; r < KN; ++r) s += p[r * L];
    return s;
  } else {
    float s = 0.f;
#pragma unroll 4
    for (int r = 0; r < n; ++r) s += p[r * L];
    return s;
  }
}

// A lane's invariants and state, in registers for the whole step: the route row's and
// column's (index, value) pairs, padded with (0, 0.0) (a padded term adds an exact +0),
// with the indices 16 bits each (row 0 | row 1 << 16, column 0 | column 1 << 16, row 2 |
// column 2 << 16).
struct Lane {
  float q, w, inflow, gate, ro;
  int slot;
  unsigned row01, col01, idx2;
  float rv[kPairs], cv[kPairs];
  bool sw;
};

// sum_j v_j x[i_j] in pair order, each product rounded before its add
__device__ __forceinline__ float pair_dot(const float* x, unsigned i01, unsigned i2,
                                          const float (&v)[kPairs]) {
  float s = __fmul_rn(v[0], x[i01 & 0xffffu]);
  s = __fadd_rn(s, __fmul_rn(v[1], x[i01 >> 16]));
  return __fadd_rn(s, __fmul_rn(v[2], x[i2]));
}

// PER: the most lanes a thread this instance takes; MAXT and MINB its launch bounds; KD
// and KL the transit depth D and the lanes L it is built for (0: any), which make the
// ring's row offsets constants.
template <int PER, int MAXT, int MINB, int KD, int KL>
__global__ void __launch_bounds__(MAXT, MINB) network_env_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims& d = a.d;
  const Scalars& c = a.s;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int L = KL > 0 ? KL : d.L, M = d.M, D = KD > 0 ? KD : d.D, W = d.W, S = d.substeps;
  const int warps = nt >> 5, warp = tid >> 5, lane = tid & 31;
  const Layout o = layout(d, warps);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + o.ring);  // [2D][L]
  float* q = reinterpret_cast<float*>(smem + o.q);        // [L]
  float* w = reinterpret_cast<float*>(smem + o.w);        // [L]
  float* fr = reinterpret_cast<float*>(smem + o.x);       // [L] max(cap - occ, 0)
  float* dqs = fr + L;                                    // [L]
  float* part = reinterpret_cast<float*>(smem + o.part);
  float* sums = reinterpret_cast<float*>(smem + o.sums);
  float* node = reinterpret_cast<float*>(smem + o.node);
  int* act = reinterpret_cast<int*>(smem + o.act);

  // the row's state arrives by bulk copy while the block reads the rest. Transit fills the
  // ring's rows 0..D-1 only: a sum reads row D + r only once ring row r has been written
  // (both copies: emptied, or written whole as a slot row, at substep r), since head
  // counts the substeps
  const uint32_t row_bytes = 4u * L;
  if (tid == 0) {
    mbar_init(bar);
    mbar_expect(bar, (D + 2) * row_bytes);
    bulk_load(ring, a.tr_in + (size_t)b * D * L, D * row_bytes, bar);
    bulk_load(q, a.q_in + (size_t)b * L, row_bytes, bar);
    bulk_load(w, a.w_in + (size_t)b * L, row_bytes, bar);
  }

  const int* lane_slot = a.it + d.lane_slot;
  const int* lane_node = a.it + d.lane_node;
  const int* n_valid = a.it + d.n_valid;
  const int* pair_row = a.it + d.pair_row;
  const int* pair_col = a.it + d.pair_col;
  const float* pair_row_val = a.ft + d.pair_row_val;
  const float* pair_col_val = a.ft + d.pair_col_val;
  const float* route_out = a.ft + d.route_out;
  const float* entry = a.ft + d.entry;
  const float* lane_gate = a.ft + d.lane_gate;
  const float cap = c.cap;

  const long long t_in = a.t_in[b];
  const float drop_in = tid == 0 ? a.drop_in[b] : 0.f;
  long long t_dem = t_in < d.T_dem - 1 ? t_in : d.T_dem - 1;
  t_dem = t_dem < 0 ? 0 : t_dem;  // t >= 0 in every state; kept in range all the same
  const float* demand = a.ft + d.demand + (size_t)t_dem * L;

  // the chosen phases, clamped to each node's valid ones
  for (int m = tid; m < M; m += nt) {
    long long x = a.action[(size_t)b * M + m];
    const long long top = n_valid[m] - 1;
    x = x < 0 ? 0 : x;
    act[m] = (int)(x < top ? x : top);
  }
  __syncthreads();  // act, and the mbarrier's init

  // the per-lane invariants, in registers for the whole step
  Lane ln[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int l = tid + i * nt;
    Lane& e = ln[i];
    e = Lane{};
    if (l < L) {
      const int m = lane_node[l];
      e.gate = lane_gate[l * d.P + act[m]];
      e.sw = act[m] != a.prev_in[(size_t)b * M + m];
      e.inflow = demand[l] * entry[l];
      e.ro = route_out[l];
      e.slot = lane_slot[l];
      unsigned ri[kPairs], ci[kPairs];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        ri[j] = (unsigned)__ldg(pair_row + j * L + l);
        ci[j] = (unsigned)__ldg(pair_col + j * L + l);
        e.rv[j] = __ldg(pair_row_val + j * L + l);
        e.cv[j] = __ldg(pair_col_val + j * L + l);
      }
      e.row01 = ri[0] | ri[1] << 16;
      e.col01 = ci[0] | ci[1] << 16;
      e.idx2 = ri[2] | ci[2] << 16;
    }
  }
  mbar_wait(bar, 0);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int l = tid + i * nt;
    if (l < L) {
      ln[i].q = q[l];
      ln[i].w = w[l];
    }
  }

  int head = 0;
  for (int k = 0; k < S; ++k) {
    const int old = head;
    head = head + 1 == D ? 0 : head + 1;
    // arrivals join the queue, overflow leaves it; the free space of every lane
    float p_ovf = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int l = tid + i * nt;
      if (l < L) {
        Lane& e = ln[i];
        float* cell = ring + old * L + l;
        float qv = e.q + *cell;
        // the emptied last row of the moved buffer (where it is the slot row, phase 3
        // writes it whole, and no sum reads it before)
        if (e.slot != D - 1) cell[0] = cell[D * L] = 0.f;
        const float ovf = fmaxf(qv - cap, 0.f);
        qv = qv - ovf;
        e.q = qv;
        p_ovf = i == 0 ? ovf : p_ovf + ovf;
        // transit rows 0..D-2: row D-1 is empty and adds an exact 0
        const float ts = transit_sum<KD ? KD - 1 : 0>(ring + l, head, D - 1, L);
        fr[l] = fmaxf(cap - (qv + ts), 0.f);
      }
    }
    __syncthreads();
    // downstream space and discharge
    const float yellow = k < d.yellow ? 1.f : 0.f;
    float dq[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int l = tid + i * nt;
      dq[i] = 0.f;
      if (l < L) {
        const Lane& e = ln[i];
        float sp = pair_dot(fr, e.row01, e.idx2 & 0xffffu, e.rv);
        sp = e.ro > 1e-6f ? sp / fmaxf(e.ro, 1e-6f) : cap;
        const float g = e.gate * __fsub_rn(1.f, __fmul_rn(yellow, e.sw ? 1.f : 0.f));
        dq[i] = fminf(fminf(e.q, g * c.sat_flow), sp);
        dqs[l] = dq[i];
      }
    }
    __syncthreads();
    // routing, entry, wait, and the sums of the substep
    float p_in = 0.f, p_dq = 0.f, p_arr = 0.f, p_acc = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int l = tid + i * nt;
      if (l < L) {
        Lane& e = ln[i];
        // the slot row (row D-1 empty) takes the routed flow, then the entering one
        int row = head + e.slot;
        row = row >= D ? row - D : row;
        float* cell = ring + row * L + l;
        float v = (e.slot == D - 1 ? 0.f : *cell) + pair_dot(dqs, e.col01, e.idx2 >> 16, e.cv);
        cell[0] = cell[D * L] = v;
        const float q2 = e.q - dq[i];
        const float fv = fmaxf(cap - (q2 + transit_sum<KD>(ring + l, head, D, L)), 0.f);
        const float acc = fminf(e.inflow, fv);
        v = v + acc;
        cell[0] = cell[D * L] = v;
        // a thread's first lane starts each of its sums
        const float arr = __fmul_rn(dq[i], fmaxf(1.f - e.ro, 0.f));
        p_in = i == 0 ? e.inflow - acc : p_in + (e.inflow - acc);
        p_dq = i == 0 ? dq[i] : p_dq + dq[i];
        p_arr = i == 0 ? arr : __fadd_rn(p_arr, arr);
        p_acc = i == 0 ? acc : p_acc + acc;
        const float served = dq[i] > 1e-4f ? 1.f : 0.f;
        e.w = (e.w + 1.f) * (q2 > 0.1f ? 1.f : 0.f) * (1.f - served);
        e.q = q2;
      }
    }
    const float pv[kSums] = {p_in, p_ovf, p_dq, p_arr, p_acc};
    int j;
    const float v = warp_sums(pv, lane, &j);
    // the first lane of each group: 0, 4, 8, 16, 24
    if ((lane & 3) == 0 && (lane < 8 || (lane & 7) == 0))
      part[(k * warps + warp) * kSums + j] = v;
  }

  const long long t_new = t_in + 1;
  const bool done = t_new >= d.episode_steps;
  const bool reset = a.auto_reset && done;
  const size_t row = (size_t)b * L;
  // the tail's table reads, issued here to land meanwhile: each thread's first obs
  // entries (gather map and mask) and its node's lane list bounds
  const int* node_ptr = a.it + d.node_ptr;
  const int* node_lane = a.it + d.node_lane;
  const int* gather = a.it + d.gather;
  const int* phase_col = a.it + d.phase_col;
  const float* gmask = a.ft + d.gmask;
  constexpr int kPre = 4;
  int pre_g[kPre];
  float pre_m[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int i = tid + u * nt;
    pre_g[u] = i < M * W ? __ldg(gather + i) : 0;
    pre_m[u] = i < M * W ? __ldg(gmask + i) : 0.f;
  }
  const int lo_own = tid < M ? __ldg(node_ptr + tid) : 0;
  const int hi_own = tid < M ? __ldg(node_ptr + tid + 1) : 0;
  __syncthreads();  // every substep's partials written, every dq read

  // the stepped queue and wait for the node sums and the bulk stores; the observation's
  // lane features of the state returned (the reset state where reset), written out
  // directly where reset
  float* feat = fr;  // [wave; queue?; wait?][L]
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int l = tid + i * nt;
    if (l < L) {
      q[l] = ln[i].q;
      w[l] = ln[i].w;
      float qv = 0.f, wv = 0.f, ts = 0.f;
      if (reset) {
        qv = a.q0 ? a.q0[row + l] : 0.f;
        a.q_out[row + l] = qv;
        a.w_out[row + l] = 0.f;
      } else {
        qv = ln[i].q;
        wv = ln[i].w;
        ts = transit_sum<KD>(ring + l, head, D, L);
      }
      feat[l] = clampf((qv + ts) / c.norm_wave, 0.f, c.clip_wave);
      int ch = 1;
      if (d.use_queue) feat[ch++ * L + l] = clampf(qv / c.norm_wave, 0.f, c.clip_wave);
      if (d.use_wait) feat[ch * L + l] = clampf(wv / c.norm_wait, 0.f, c.clip_wait);
    }
  }
  if (reset) {
    float4* tr = reinterpret_cast<float4*>(a.tr_out + row * D);
    for (int i = tid; i < D * L / 4; i += nt) tr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  fence_proxy_async();
  __syncthreads();

  // the state returned, transit in its row order: rows head..head + D - 1 of the ring
  if (tid == 0) {
    a.t_out[b] = reset ? 0 : t_new;
    a.done_state[b] = reset ? false : done;
    a.done_out[b] = done;
    if (!reset) {
      bulk_store(a.tr_out + row * D, ring + head * L, D * row_bytes);
      bulk_store(a.q_out + row, q, row_bytes);
      bulk_store(a.w_out + row, w, row_bytes);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // each (substep, sum) pair over the warps in order, by the last threads
  for (int u = nt - 1 - tid; u < S * kSums; u += nt) {
    const float* src = part + (u / kSums) * warps * kSums + u % kSums;
    float s = 0.f;
#pragma unroll 4
    for (int wp = 0; wp < warps; ++wp) s += src[wp * kSums];
    sums[u] = s;
  }
  // node sums and rewards of the stepped state; the phases returned
  for (int m = tid; m < M; m += nt) {
    const int lo = m == tid ? lo_own : node_ptr[m], hi = m == tid ? hi_own : node_ptr[m + 1];
    float nq = 0.f, nw = 0.f;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      const int l = node_lane[i];
      nq += q[l];
      nw += w[l];
    }
    node[m] = nq;
    node[M + m] = nw;
    const float r = d.objective == 0   ? -nq
                    : d.objective == 1 ? -nw
                                       : -__fadd_rn(nq, __fmul_rn(c.coef_wait, nw));
    a.reward[(size_t)b * M + m] = r;
    a.prev_out[(size_t)b * M + m] = reset ? 0 : act[m];
  }
  // the observation: gathered lane features, masked, and the phase one-hot
  auto obs_at = [&](int i, int g, float mask) {
    const int m = i / W;
    float v = feat[g] * mask;
    if (d.use_phase) {
      const int ph = reset ? 0 : act[m];
      if (ph < n_valid[m] && i - m * W == phase_col[m] + ph) v = v + 1.f;
    }
    a.obs[(size_t)b * M * W + i] = v;
  };
#pragma unroll
  for (int u = 0; u < kPre; ++u)
    if (tid + u * nt < M * W) obs_at(tid + u * nt, pre_g[u], pre_m[u]);
  for (int i = tid + kPre * nt; i < M * W; i += nt) obs_at(i, gather[i], gmask[i]);
  __syncthreads();

  // info, and dropped: the substeps in order
  const int B = a.B;
  if (tid == 0) {
    float dropped = drop_in, flows = 0.f, arrived = 0.f, entered = 0.f;
    for (int k = 0; k < S; ++k) {
      const float* s = sums + k * kSums;
      dropped = (dropped + s[0]) + s[1];
      flows += s[2];
      arrived += s[3];
      entered += s[4];
    }
    a.info[2 * (size_t)B + b] = flows;
    a.info[3 * (size_t)B + b] = arrived;
    a.info[4 * (size_t)B + b] = entered;
    a.info[5 * (size_t)B + b] = dropped;
    a.drop_out[b] = reset ? 0.f : dropped;
  }
  if (tid == (nt > 32 ? 32 : 0)) {
    float nq = 0.f, nw = 0.f;
#pragma unroll 8
    for (int m = 0; m < M; ++m) {
      nq += node[m];
      nw += node[M + m];
    }
    a.info[0 * (size_t)B + b] = nq / (float)M;
    a.info[1 * (size_t)B + b] = nw / (float)M;
  }
  // the shared memory the bulk stores read stays until they have read it
  if (tid == 0 && !reset) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

using KernelFn = void (*)(const Args);

// The instance for (lanes a thread, threads a block) and the row's (D, L): six blocks an
// SM up to 160 threads (at most 64 registers a thread), one instance built for each
// topology of the port and one for any.
KernelFn pick(int lanes, int threads, int D, int L) {
  if (lanes == 1 && threads <= 160) {
    if (D == 10 && L == 108) return network_env_kernel<1, 160, 6, 10, 108>;  // 3x3 grid
    if (D == 18 && L == 148) return network_env_kernel<1, 160, 6, 18, 148>;  // Monaco-28
    return network_env_kernel<1, 160, 6, 0, 0>;
  }
  const bool grid5 = D == 10 && L == 300, grid10 = D == 10 && L == 1200;
  if (lanes <= 2 && threads <= 160)
    return grid5 ? network_env_kernel<2, 160, 6, 10, 300> : network_env_kernel<2, 160, 6, 0, 0>;
  if (lanes <= 2)
    return grid10 ? network_env_kernel<2, 1024, 1, 10, 1200>
                  : network_env_kernel<2, 1024, 1, 0, 0>;
  if (lanes <= 8) return network_env_kernel<8, 1024, 1, 0, 0>;
  return nullptr;
}

// the kernel and its shared memory for a shape, or an error
cudaError_t plan(const Dims& d, int lanes, int threads, KernelFn* fn, size_t* smem) {
  if (d.L < 1 || d.M < 1 || d.P < 1 || d.D < 1 || d.W < 1 || d.T_dem < 1 || d.substeps < 0 ||
      d.L % 4 != 0 || lanes < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      (long long)lanes * threads < d.L)
    return cudaErrorInvalidValue;
  *fn = pick(lanes, threads, d.D, d.L);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  *smem = layout(d, threads / 32).total;
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One step of B rows: the state in (q_in ... drop_in), the actions, the reset queues
// (q0, or null), the state out (q_out ... done_state), the returned done, obs, reward and
// info [6, B].
extern "C" int network_env_step(const void* dims, const void* scalars, const void* itab,
                                const void* ftab, const void* q_in, const void* tr_in,
                                const void* w_in, const void* prev_in, const void* t_in,
                                const void* drop_in, const void* action, const void* q0,
                                void* q_out, void* tr_out, void* w_out, void* drop_out,
                                void* prev_out, void* t_out, void* done_state, void* done_out,
                                void* obs, void* reward, void* info, int B, int auto_reset,
                                int lanes, int threads, void* stream) {
  Args a;
  std::memcpy(&a.d, dims, sizeof(Dims));
  std::memcpy(&a.s, scalars, sizeof(Scalars));
  const Dims& d = a.d;
  if (B < 1) return (int)cudaErrorInvalidValue;
  KernelFn fn;
  size_t smem;
  const cudaError_t err = plan(d, lanes, threads, &fn, &smem);
  if (err != cudaSuccess) return (int)err;
  // the bulk copies take 16-byte aligned rows
  if (!aligned16(q_in) || !aligned16(tr_in) || !aligned16(w_in) || !aligned16(q_out) ||
      !aligned16(tr_out) || !aligned16(w_out))
    return (int)cudaErrorInvalidValue;
  a.it = static_cast<const int*>(itab);
  a.ft = static_cast<const float*>(ftab);
  a.q_in = static_cast<const float*>(q_in);
  a.tr_in = static_cast<const float*>(tr_in);
  a.w_in = static_cast<const float*>(w_in);
  a.prev_in = static_cast<const long long*>(prev_in);
  a.t_in = static_cast<const long long*>(t_in);
  a.drop_in = static_cast<const float*>(drop_in);
  a.action = static_cast<const long long*>(action);
  a.q0 = static_cast<const float*>(q0);
  a.q_out = static_cast<float*>(q_out);
  a.tr_out = static_cast<float*>(tr_out);
  a.w_out = static_cast<float*>(w_out);
  a.drop_out = static_cast<float*>(drop_out);
  a.prev_out = static_cast<long long*>(prev_out);
  a.t_out = static_cast<long long*>(t_out);
  a.done_state = static_cast<bool*>(done_state);
  a.done_out = static_cast<bool*>(done_out);
  a.obs = static_cast<float*>(obs);
  a.reward = static_cast<float*>(reward);
  a.info = static_cast<float*>(info);
  a.B = B;
  a.auto_reset = auto_reset;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(B), dim3(threads), args,
                               smem, static_cast<cudaStream_t>(stream));
}

// What the card makes of a launch shape: out = {registers a thread, blocks an SM, shared
// bytes a block, local (spilled) bytes a thread}.
extern "C" int network_env_occupancy(const void* dims, int lanes, int threads, int* out) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  KernelFn fn;
  size_t smem;
  cudaError_t err = plan(d, lanes, threads, &fn, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = (int)smem;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
