// One 0.1 s control step of the CACC platoon (CACCEnv) for NVIDIA Hopper (sm_90a), with the
// auto-reset of AutoResetEnv.step, as one launch for all B platoons.
//
// Replaces no TPU kernel. The JAX package's step (deeprl_network_tpu/envs/cacc.py CACCEnv.step)
// is plain jnp code that XLA fuses under jit, reset and select included. The port ran the same
// composition as PyTorch ops (ops/cacc_env.py cacc_env_step_ref: CACCEnv.step, a reset every
// step, a torch.where for each state leaf and the obs): about 96 small kernels a step, each a
// graph node of about 1.3 us on the card for [64, 8] tensors. This kernel was added to run
// them as one node.
//
// For each platoon b and vehicle i, with the ops' rounding points:
//   step:  (alpha, beta) = gain[action]; V(h) the OVM law; vp = v of vehicle i - 1, v_lead
//          for i = 0; u' = clamp(alpha (V(h) - v) + beta (vp - v), -u_max, u_max);
//          v' = clamp(v + dt u', 0, v_max); t' = t + 1; v_lead' = leader(t');
//          h' = h + dt (vp' - v') with vp' from v' and v_lead'; collision = min_i h' < h_min;
//          done = collision | t' >= episode_length; v_tgt = leader(t') (profile) or v_star;
//          reward = -(w_h (h' - h*)^2 + w_v (v' - v_tgt)^2 + w_u u'^2), or -penalty where
//          the platoon collided; info: collision, mean |h' - h*|, mean |v' - v_tgt|;
//   reset: noise = (2 u - 1) amp from the uniforms the wrapper drew (0 where amp is 0);
//          h0 = noise_h + (h0_first for i = 0, else h*); v0 = clamp(noise_v + v0_start,
//          0, v_max); u0 = 0; v_lead0 = v0_start; t0 = 0;
//   select: the reset's state and obs where done, the step's elsewhere; the state's done is
//          then false everywhere (a done platoon restarts); reward, done and info are the
//          step's. obs per vehicle: [(v - v_tgt) / v*, (vp - v) / 5, (h - h*) / h*, u / u_max].
// leader(t) is v_star, or on the slow-down ramp v0 + (v* - v0) clamp(t dt / T, 0, 1). Both
// scenarios and both velocity targets are one algorithm with other numbers: the wrapper
// passes them (Scalars) and two flags (Ints.ramp, Ints.profile) read from the config.
//
// Rounding: the kernel's outputs equal the ops' on the card bit for bit, so the kernel keeps
// each op's rounding:
//   * every product and sum is its own rounding (__fmul_rn, __fadd_rn, __fsub_rn): no FMA
//     contraction, which the separate ops never do;
//   * cosf, as PyTorch's CUDA cos calls it (no fast math);
//   * a tensor divided by a Python number is, on the card, a multiply by the f32 reciprocal
//     (PyTorch's div_true kernel): the wrapper passes 1 / span, 1 / v*, 1 / 5, 1 / h*,
//     1 / u_max and 1 / T rounded to f32 as PyTorch rounds them, and 1 / n for the means;
//   * x ** 2 is x * x; Python folds products of numbers (0.5 v_max, ratio h*) in double
//     before the one rounding to f32; clamp is fmin(fmax(x, lo), hi) with NaN passed on;
//   * the cost's three terms add in their written order;
//   * collision takes the min with NaN propagating (torch.min); the two info means add the
//     platoon's terms as a pairwise tree (lanes i ^ 1, then i ^ 2, ...), the order of
//     PyTorch's reduction over 8 columns, then scale by 1 / n. They are logged and reach no
//     loss, and are held within 2 ulp of torch.mean.
//
// Bound: launch latency. At B = 64, n = 8 a step reads h, v, the actions, t, v_lead and two
// uniforms and writes the state, obs, reward, done and info: about 31 KB, 0.009 us at 3.35
// TB/s, and a few hundred operations a vehicle. The launch itself (a few us) is the cost, so
// the design takes the whole step, reset and select into one launch and spends nothing on
// the arithmetic's speed:
//   * one thread a vehicle; a platoon is a segment of seg lanes (n rounded up to a power of
//     two, n <= 32) inside one warp, 128 / seg platoons a 128-thread block (4 blocks at
//     B = 64, n = 8); lanes i >= n of a segment hold no vehicle;
//   * the predecessor's velocity, before and after the update and at the reset, comes from
//     __shfl_up_sync inside the segment; the collision test and the info sums are xor
//     butterflies inside the segment (they never cross it: seg is a power of two);
//   * t, v_lead, done, collision and info are per platoon: lane 0 of a segment writes them;
//   * every output is a new buffer; the input state is read once and never written. The
//     previous control u and the input done flag are not read (the step does not use them).
// Actions: -4 to -1 count from the table's end, as the ops' indexing does. Any other action
// outside [0, 4), where the ops raise, gets NaN gains: the vehicle's control, velocity and
// reward and its follower's headway come out NaN (a kernel cannot raise without a sync).

#include <cuda_runtime.h>

#include <cmath>
#include <cstring>

namespace {

// ops/cacc_env.py _SCALARS, field for field
struct Scalars {
  float h_st, h_go, pi, inv_span, half_v_max, v_max, u_max, dt, h_min, v_star, h_star,
      inv_v_star, inv_5, inv_h_star, inv_u_max, inv_n, w_h, w_v, w_u, neg_penalty, ramp_v0,
      ramp_dv, inv_ramp_t, amp_h, amp_v, h0_first, v0_start;
  float gain[8];  // (alpha, beta) of actions 0..3
};

// ops/cacc_env.py _INTS, field for field
struct Ints {
  int n, episode_length, ramp, profile;
};

struct Args {
  Scalars c;
  Ints d;
  int seg, B;
  const float* h;            // [B, n]
  const float* v;            // [B, n]
  const float* v_lead;       // [B]
  const long long* t;        // [B]
  const long long* action;   // [B, n]
  const float* u_h;          // [B, n] or null (no draw where amp_h is 0)
  const float* u_v;          // [B, n] or null
  float* h_out;              // [B, n]
  float* v_out;              // [B, n]
  float* u_out;              // [B, n]
  float* vl_out;             // [B]
  long long* t_out;          // [B]
  bool* done_state;          // [B]
  bool* done;                // [B]
  bool* collision;           // [B]
  float* obs;                // [B, n, 4]
  float* reward;             // [B, n]
  float* info;               // [2, B]: headway_err, velocity_err
};

constexpr int kThreads = 128;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// the leader's velocity at step t
__device__ __forceinline__ float leader(const Scalars& c, int ramp, long long t) {
  if (!ramp) return c.v_star;
  const float frac = clampf(__fmul_rn(__fmul_rn(__ll2float_rn(t), c.dt), c.inv_ramp_t), 0.f, 1.f);
  return __fadd_rn(__fmul_rn(frac, c.ramp_dv), c.ramp_v0);
}

// the OVM headway law V(h)
__device__ __forceinline__ float ovm(const Scalars& c, float h) {
  const float x = __fmul_rn(__fmul_rn(__fsub_rn(h, c.h_st), c.pi), c.inv_span);
  const float mid = __fmul_rn(__fsub_rn(1.f, cosf(x)), c.half_v_max);
  return h < c.h_st ? 0.f : (h > c.h_go ? c.v_max : mid);
}

__global__ void __launch_bounds__(kThreads) cacc_env_kernel(const Args a) {
  const Scalars& c = a.c;
  const int n = a.d.n, seg = a.seg;
  const int i = threadIdx.x % seg;
  const int b = blockIdx.x * (kThreads / seg) + threadIdx.x / seg;
  const bool platoon = b < a.B, live = platoon && i < n;
  const size_t k = (size_t)b * n + i;
  float h = 0.f, v = 0.f, uh = 0.f, uv = 0.f, vl = 0.f;
  long long act = 0, t = 0;
  if (live) {
    h = a.h[k];
    v = a.v[k];
    act = a.action[k];
    if (a.u_h) uh = a.u_h[k];
    if (a.u_v) uv = a.u_v[k];
  }
  if (platoon) {
    t = a.t[b];
    vl = a.v_lead[b];
  }

  // the step
  const bool known = act >= -4 && act < 4;
  const int ai = (int)(act & 3);
  const float alpha = known ? c.gain[2 * ai] : NAN, beta = known ? c.gain[2 * ai + 1] : NAN;
  const float up = __shfl_up_sync(kAll, v, 1, seg);
  const float vp = i == 0 ? vl : up;
  const float un = clampf(__fadd_rn(__fmul_rn(alpha, __fsub_rn(ovm(c, h), v)),
                                    __fmul_rn(beta, __fsub_rn(vp, v))),
                          -c.u_max, c.u_max);
  const float vn = clampf(__fadd_rn(v, __fmul_rn(un, c.dt)), 0.f, c.v_max);
  const long long tn = t + 1;
  const float vln = leader(c, a.d.ramp, tn);
  const float upn = __shfl_up_sync(kAll, vn, 1, seg);
  const float vpn = i == 0 ? vln : upn;
  const float hn = __fadd_rn(h, __fmul_rn(__fsub_rn(vpn, vn), c.dt));
  const float vt = a.d.profile ? vln : c.v_star;
  const float eh = __fsub_rn(hn, c.h_star), ev = __fsub_rn(vn, vt);
  const float cost = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(eh, eh), c.w_h),
                                         __fmul_rn(__fmul_rn(ev, ev), c.w_v)),
                               __fmul_rn(__fmul_rn(un, un), c.w_u));
  // the platoon's least headway (NaN propagates) and the info sums
  float least = live ? hn : INFINITY;
  float se = live ? fabsf(eh) : 0.f, sv = live ? fabsf(ev) : 0.f;
  for (int o = 1; o < seg; o <<= 1) {
    const float q = __shfl_xor_sync(kAll, least, o);
    least = (isnan(least) || least < q) ? least : q;
    se = __fadd_rn(se, __shfl_xor_sync(kAll, se, o));
    sv = __fadd_rn(sv, __shfl_xor_sync(kAll, sv, o));
  }
  const bool collision = least < c.h_min;
  const bool done = collision || tn >= a.d.episode_length;

  // the reset
  const float nh = a.u_h ? __fmul_rn(__fsub_rn(__fmul_rn(uh, 2.f), 1.f), c.amp_h) : 0.f;
  const float nv = a.u_v ? __fmul_rn(__fsub_rn(__fmul_rn(uv, 2.f), 1.f), c.amp_v) : 0.f;
  const float h0 = __fadd_rn(nh, i == 0 ? c.h0_first : c.h_star);
  const float v0 = clampf(__fadd_rn(nv, c.v0_start), 0.f, c.v_max);
  const float up0 = __shfl_up_sync(kAll, v0, 1, seg);
  const float vp0 = i == 0 ? c.v0_start : up0;
  const float vt0 = a.d.profile ? leader(c, a.d.ramp, 0) : c.v_star;

  if (live) {
    const float hs = done ? h0 : hn, vs = done ? v0 : vn, us = done ? 0.f : un;
    a.h_out[k] = hs;
    a.v_out[k] = vs;
    a.u_out[k] = us;
    float* o = a.obs + 4 * k;
    o[0] = __fmul_rn(__fsub_rn(vs, done ? vt0 : vt), c.inv_v_star);
    o[1] = __fmul_rn(__fsub_rn(done ? vp0 : vpn, vs), c.inv_5);
    o[2] = __fmul_rn(__fsub_rn(hs, c.h_star), c.inv_h_star);
    o[3] = __fmul_rn(us, c.inv_u_max);
    a.reward[k] = collision ? c.neg_penalty : -cost;
    if (i == 0) {
      a.vl_out[b] = done ? c.v0_start : vln;
      a.t_out[b] = done ? 0 : tn;
      a.done_state[b] = false;
      a.done[b] = done;
      a.collision[b] = collision;
      a.info[b] = __fmul_rn(se, c.inv_n);
      a.info[a.B + b] = __fmul_rn(sv, c.inv_n);
    }
  }
}

}  // namespace

// One step of B platoons of n vehicles (scalars: the Scalars struct; ints: the Ints struct):
// the state in (h, v, v_lead, t), the actions, the reset's uniforms (u_h, u_v, or null), the
// state out (h_out ... done_state), the returned done, collision, obs, reward and info [2, B].
extern "C" int cacc_env_step(const void* scalars, const void* ints, const void* h, const void* v,
                             const void* v_lead, const void* t, const void* action,
                             const void* u_h, const void* u_v, void* h_out, void* v_out,
                             void* u_out, void* vl_out, void* t_out, void* done_state, void* done,
                             void* collision, void* obs, void* reward, void* info, int B,
                             void* stream) {
  Args a;
  std::memcpy(&a.c, scalars, sizeof(Scalars));
  std::memcpy(&a.d, ints, sizeof(Ints));
  if (B < 1 || a.d.n < 1 || a.d.n > 32) return (int)cudaErrorInvalidValue;
  a.seg = 1;
  while (a.seg < a.d.n) a.seg <<= 1;
  a.B = B;
  a.h = static_cast<const float*>(h);
  a.v = static_cast<const float*>(v);
  a.v_lead = static_cast<const float*>(v_lead);
  a.t = static_cast<const long long*>(t);
  a.action = static_cast<const long long*>(action);
  a.u_h = static_cast<const float*>(u_h);
  a.u_v = static_cast<const float*>(u_v);
  a.h_out = static_cast<float*>(h_out);
  a.v_out = static_cast<float*>(v_out);
  a.u_out = static_cast<float*>(u_out);
  a.vl_out = static_cast<float*>(vl_out);
  a.t_out = static_cast<long long*>(t_out);
  a.done_state = static_cast<bool*>(done_state);
  a.done = static_cast<bool*>(done);
  a.collision = static_cast<bool*>(collision);
  a.obs = static_cast<float*>(obs);
  a.reward = static_cast<float*>(reward);
  a.info = static_cast<float*>(info);
  const int per_block = kThreads / a.seg;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(&cacc_env_kernel),
                               dim3((B + per_block - 1) / per_block), dim3(kThreads), args, 0,
                               static_cast<cudaStream_t>(stream));
}
