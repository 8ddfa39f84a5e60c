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
// under the card's rate. chip_smoke.py env_bytes counts the bytes of a call.
//
// The design, simple first:
//   * one block per env row; a thread owns lanes tid, tid + blockDim, ... (blockDim is
//     ceil(L / lanes a thread) rounded up to a warp, at most 1024: one lane a thread on the
//     5x5 grid (320 threads) and Monaco (160), two on the 10x10 grid);
//   * transit lives in shared memory as a ring of D rows with a head index, so the shift is
//     an index step; beside it q, w, the lanes' gates, switches and inflow, the clamped free
//     space (read across lanes by `space`) and dq (read across lanes by `routed`), and
//     __syncthreads() between the substep's three phases. 5x5 grid: 21.7 KB a block;
//     shared memory above 48 KB (the 10x10 grid, 84 KB) is requested at launch;
//   * route rows (CSR, for `space`) and columns (CSC, for `routed`) hold at most 3 nonzeros
//     on every topology the port has; each is summed in ascending index order;
//   * sums over lanes (dropped, throughput, arrived, entered) are a fixed tree: a thread's
//     lanes in order, a shuffle tree in each warp, the warps in order, the substeps in
//     order; node sums walk each node's lane list in ascending order. No atomics: the step
//     is deterministic;
//   * the products that feed a sum are rounded before the add (__fmul_rn, __fadd_rn), so
//     no contraction into an FMA departs from the twin's separate ops;
//   * every output is a new buffer; the input state is read once and never written.

#include <cuda_runtime.h>

#include <cstring>

namespace {

// ops/network_env.py _DIMS, field for field
struct Dims {
  int L, M, P, D, W, T_dem, use_queue, use_wait, use_phase;
  // offsets into the int32 tables
  int row_ptr, row_col, col_ptr, col_row, lane_slot, lane_node, node_ptr, node_lane, gather,
      phase_col, n_valid;
  // offsets into the f32 tables
  int row_val, col_val, route_out, entry, demand, lane_gate, gmask;
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
  const float* q_in;       // [B, L]
  const float* tr_in;      // [B, D, L]
  const float* w_in;       // [B, L]
  const long long* prev_in;  // [B, M]
  const long long* t_in;     // [B]
  const float* drop_in;    // [B]
  const long long* action;   // [B, M]
  const float* q0;         // [B, L] or null
  float* q_out;            // then transit [B, D, L], wait [B, L], dropped [B]
  long long* prev_out;     // then t [B]
  bool* done_state;        // [B]
  bool* done_out;          // [B]
  float* obs;              // [B, M, W], then reward [B, M], info [6, B]
  int B, auto_reset;
};

constexpr int kSums = 5;  // inflow - accepted, overflow, dq, arrived, accepted

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// sum over d of transit row d of lane l, rows in order, row d at ring row (head + d) % D
__device__ __forceinline__ float transit_sum(const float* ring, int head, int D, int L, int l) {
  float s = 0.f;
  int r = head;
  for (int d = 0; d < D; ++d) {
    s += ring[r * L + l];
    r = r + 1 == D ? 0 : r + 1;
  }
  return s;
}

size_t smem_bytes(const Dims& d, int threads) {
  const int warps = threads / 32;
  return sizeof(float) * ((size_t)d.D * d.L + 7 * (size_t)d.L +
                          (size_t)d.substeps * warps * kSums + 2 * d.M) +
         sizeof(int) * d.M;
}

__global__ void __launch_bounds__(1024) network_env_kernel(const Args a) {
  extern __shared__ float sm[];
  const Dims& d = a.d;
  const Scalars& c = a.s;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int L = d.L, M = d.M, D = d.D, W = d.W, B = a.B;
  const int warps = nt >> 5, warp = tid >> 5, lane = tid & 31;
  float* ring = sm;                // [D][L], ring row (head + d) % D is transit row d
  float* q = ring + D * L;         // [L]
  float* w = q + L;                // [L]
  float* fr = w + L;               // [L] max(cap - occ, 0); after the substeps, with dqs
  float* dqs = fr + L;             //   and gate, the obs features [wave; queue?; wait?]
  float* gate = dqs + L;           // [L]
  float* sw = gate + L;            // [L]
  float* inflow = sw + L;          // [L]
  float* part = inflow + L;        // [substeps][warps][kSums]
  float* node = part + d.substeps * warps * kSums;  // [2][M]: node queue, node wait
  int* act = reinterpret_cast<int*>(node + 2 * M);  // [M]

  const int* row_ptr = a.it + d.row_ptr;
  const int* row_col = a.it + d.row_col;
  const int* col_ptr = a.it + d.col_ptr;
  const int* col_row = a.it + d.col_row;
  const int* lane_slot = a.it + d.lane_slot;
  const int* lane_node = a.it + d.lane_node;
  const int* node_ptr = a.it + d.node_ptr;
  const int* node_lane = a.it + d.node_lane;
  const int* gather = a.it + d.gather;
  const int* phase_col = a.it + d.phase_col;
  const int* n_valid = a.it + d.n_valid;
  const float* row_val = a.ft + d.row_val;
  const float* col_val = a.ft + d.col_val;
  const float* route_out = a.ft + d.route_out;
  const float* entry = a.ft + d.entry;
  const float* lane_gate = a.ft + d.lane_gate;
  const float* gmask = a.ft + d.gmask;
  const float cap = c.cap;

  const long long t_in = a.t_in[b];
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
  __syncthreads();
  for (int l = tid; l < L; l += nt) {
    const size_t i = (size_t)b * L + l;
    q[l] = a.q_in[i];
    w[l] = a.w_in[i];
    for (int r = 0; r < D; ++r) ring[r * L + l] = a.tr_in[((size_t)b * D + r) * L + l];
    const int m = lane_node[l];
    gate[l] = lane_gate[l * d.P + act[m]];
    sw[l] = act[m] != a.prev_in[(size_t)b * M + m] ? 1.f : 0.f;
    inflow[l] = demand[l] * entry[l];
  }

  int head = 0;
  for (int k = 0; k < d.substeps; ++k) {
    const float yellow = k < d.yellow ? 1.f : 0.f;
    const int old = head;
    head = head + 1 == D ? 0 : head + 1;
    // arrivals join the queue, overflow leaves it; the free space of every lane
    float p_ovf = 0.f;
    for (int l = tid; l < L; l += nt) {
      const float arriving = ring[old * L + l];
      ring[old * L + l] = 0.f;  // the emptied last row of the moved buffer
      float qv = q[l] + arriving;
      const float ovf = fmaxf(qv - cap, 0.f);
      qv = qv - ovf;
      q[l] = qv;
      p_ovf += ovf;
      fr[l] = fmaxf(cap - (qv + transit_sum(ring, head, D, L, l)), 0.f);
    }
    __syncthreads();
    // downstream space and discharge
    for (int l = tid; l < L; l += nt) {
      float sp = 0.f;
      for (int i = row_ptr[l]; i < row_ptr[l + 1]; ++i)
        sp = __fadd_rn(sp, __fmul_rn(row_val[i], fr[row_col[i]]));
      const float ro = route_out[l];
      sp = ro > 1e-6f ? sp / fmaxf(ro, 1e-6f) : cap;
      const float g = gate[l] * __fsub_rn(1.f, __fmul_rn(yellow, sw[l]));
      dqs[l] = fminf(fminf(q[l], g * c.sat_flow), sp);
    }
    __syncthreads();
    // routing, entry, wait, and the sums of the substep
    float p_in = 0.f, p_dq = 0.f, p_arr = 0.f, p_acc = 0.f;
    for (int l = tid; l < L; l += nt) {
      float rt = 0.f;
      for (int i = col_ptr[l]; i < col_ptr[l + 1]; ++i)
        rt = __fadd_rn(rt, __fmul_rn(col_val[i], dqs[col_row[i]]));
      int slot = head + lane_slot[l];
      slot = slot >= D ? slot - D : slot;
      float* cell = ring + slot * L + l;
      *cell += rt;
      const float dq = dqs[l];
      const float q2 = q[l] - dq;
      const float fv = fmaxf(cap - (q2 + transit_sum(ring, head, D, L, l)), 0.f);
      const float acc = fminf(inflow[l], fv);
      *cell += acc;
      p_in += inflow[l] - acc;
      p_dq += dq;
      p_arr = __fadd_rn(p_arr, __fmul_rn(dq, fmaxf(1.f - route_out[l], 0.f)));
      p_acc += acc;
      const float served = dq > 1e-4f ? 1.f : 0.f;
      w[l] = (w[l] + 1.f) * (q2 > 0.1f ? 1.f : 0.f) * (1.f - served);
      q[l] = q2;
    }
    const float p[kSums] = {p_in, p_ovf, p_dq, p_arr, p_acc};
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
      const float v = warp_sum(p[j]);
      if (lane == 0) part[(k * warps + warp) * kSums + j] = v;
    }
  }
  __syncthreads();

  const long long t_new = t_in + 1;
  const bool done = t_new >= d.episode_steps;
  const bool reset = a.auto_reset && done;
  float* q_out = a.q_out;
  float* tr_out = q_out + (size_t)B * L;
  float* w_out = tr_out + (size_t)B * D * L;
  float* drop_out = w_out + (size_t)B * L;
  long long* t_out = a.prev_out + (size_t)B * M;
  float* reward = a.obs + (size_t)B * M * W;
  float* info = reward + (size_t)B * M;

  // node sums and rewards of the stepped state; the phases returned
  for (int m = tid; m < M; m += nt) {
    float nq = 0.f, nw = 0.f;
    for (int i = node_ptr[m]; i < node_ptr[m + 1]; ++i) {
      nq += q[node_lane[i]];
      nw += w[node_lane[i]];
    }
    node[m] = nq;
    node[M + m] = nw;
    const float r = d.objective == 0   ? -nq
                    : d.objective == 1 ? -nw
                                       : -__fadd_rn(nq, __fmul_rn(c.coef_wait, nw));
    reward[(size_t)b * M + m] = r;
    a.prev_out[(size_t)b * M + m] = reset ? 0 : act[m];
  }
  // the state returned (the reset state where reset), in transit's row order, and the
  // observation's lane features of it
  for (int l = tid; l < L; l += nt) {
    const size_t i = (size_t)b * L + l;
    float qv = 0.f, wv = 0.f, ts = 0.f;
    if (reset) {
      qv = a.q0 ? a.q0[i] : 0.f;
      for (int r = 0; r < D; ++r) tr_out[((size_t)b * D + r) * L + l] = 0.f;
    } else {
      qv = q[l];
      wv = w[l];
      int r = head;
      for (int dd = 0; dd < D; ++dd) {
        const float v = ring[r * L + l];
        tr_out[((size_t)b * D + dd) * L + l] = v;
        ts += v;
        r = r + 1 == D ? 0 : r + 1;
      }
    }
    q_out[i] = qv;
    w_out[i] = wv;
    fr[l] = clampf((qv + ts) / c.norm_wave, 0.f, c.clip_wave);
    int ch = 1;
    if (d.use_queue) fr[ch++ * L + l] = clampf(qv / c.norm_wave, 0.f, c.clip_wave);
    if (d.use_wait) fr[ch * L + l] = clampf(wv / c.norm_wait, 0.f, c.clip_wait);
  }
  if (tid == 0) {
    t_out[b] = reset ? 0 : t_new;
    a.done_state[b] = reset ? false : done;
    a.done_out[b] = done;
  }
  __syncthreads();

  // the observation: gathered lane features, masked, and the phase one-hot
  for (int i = tid; i < M * W; i += nt) {
    const int m = i / W;
    float v = fr[gather[i]] * gmask[i];
    if (d.use_phase) {
      const int ph = reset ? 0 : act[m];
      if (ph < n_valid[m] && i - m * W == phase_col[m] + ph) v = v + 1.f;
    }
    a.obs[(size_t)b * M * W + i] = v;
  }
  // info, and dropped: the substeps' sums in order, each over the warps in order
  if (tid == 0) {
    float dropped = a.drop_in[b], flows = 0.f, arrived = 0.f, entered = 0.f;
    for (int k = 0; k < d.substeps; ++k) {
      float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
      for (int wp = 0; wp < warps; ++wp)
        for (int j = 0; j < kSums; ++j) s[j] += part[(k * warps + wp) * kSums + j];
      dropped = (dropped + s[0]) + s[1];
      flows += s[2];
      arrived += s[3];
      entered += s[4];
    }
    float nq = 0.f, nw = 0.f;
    for (int m = 0; m < M; ++m) {
      nq += node[m];
      nw += node[M + m];
    }
    info[0 * (size_t)B + b] = nq / (float)M;
    info[1 * (size_t)B + b] = nw / (float)M;
    info[2 * (size_t)B + b] = flows;
    info[3 * (size_t)B + b] = arrived;
    info[4 * (size_t)B + b] = entered;
    info[5 * (size_t)B + b] = dropped;
    drop_out[b] = reset ? 0.f : dropped;
  }
}

}  // namespace

extern "C" int network_env_step(const void* dims, const void* scalars, const void* itab,
                                const void* ftab, const void* q_in, const void* tr_in,
                                const void* w_in, const void* prev_in, const void* t_in,
                                const void* drop_in, const void* action, const void* q0,
                                void* fstate, void* istate, void* done_state, void* done_out,
                                void* out, int B, int auto_reset, void* stream) {
  Args a;
  std::memcpy(&a.d, dims, sizeof(Dims));
  std::memcpy(&a.s, scalars, sizeof(Scalars));
  const Dims& d = a.d;
  if (B < 1 || d.L < 1 || d.M < 1 || d.P < 1 || d.D < 1 || d.W < 1 || d.T_dem < 1 ||
      d.substeps < 0)
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
  a.q_out = static_cast<float*>(fstate);
  a.prev_out = static_cast<long long*>(istate);
  a.done_state = static_cast<bool*>(done_state);
  a.done_out = static_cast<bool*>(done_out);
  a.obs = static_cast<float*>(out);
  a.B = B;
  a.auto_reset = auto_reset;
  const int per_thread = (d.L + 1023) / 1024;
  const int threads = ((d.L + per_thread - 1) / per_thread + 31) / 32 * 32;
  const size_t smem = smem_bytes(d, threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        network_env_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  network_env_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
