// Fused per-agent LSTM cell, forward and backward, for NVIDIA Hopper (sm_90a):
// the general kernels, with the products in full f32 on the CUDA cores. They
// serve float32 (every configs/*.ini file, every B=1 eval and record episode,
// the compat agents) and bf16 at widths that lstm_cell_tc.cu (bf16 on the
// tensor cores, the flagship path) does not take. Any F and H.
//
// Replaces the Pallas TPU kernels of deeprl_network_tpu/ops/pallas_lstm.py:
//   lstm_fwd_kernel              <- _fwd_call's inner `kernel` (pallas_call at :108)
//   lstm_bwd_act_kernel,
//   lstm_bwd_dxdh_kernel and
//   lstm_bwd_weight_kernel       <- _bwd_call's inner `kernel` (pallas_call at :233)
// and computes the same function with the same rounding points:
//   forward:  h_in, c_in = (h, c) * (1 - done), rounded to the compute dtype T;
//             z = x @ wx[n] + h_in @ wh[n] + b[n], f32 accumulation;
//             gates (i, f, o, u) = (sig, sig, sig, tanh) of z, in f32;
//             c' = f c_in + i u, h' = o tanh(c'), stored in T.
//   backward: gates recomputed from (x, h_in, c_in); gz (the four gate grads)
//             in f32; dx = gz_T @ wx^T (unmasked); dh = (gz_T @ wh^T) * mask;
//             dc_prev = (dc f) * mask; dwx = x^T gz_T, dwh = h_in^T gz_T and
//             db = sum gz (f32 gz), all summed over the batch in f32.
//   gz_T is gz rounded to T, the operand of the [dx|dh] and weight products.
// Activations are [B, N, X] row-major, read in place; weights are [N, F, 4H],
// [N, H, 4H], [N, 4H]. T is float or __nv_bfloat16.
//
// Why f32 on the CUDA cores: TF32 keeps 10 mantissa bits and misses the f32
// bars (1e-5 forward, 1e-4 gradients) at K = 128. 3xTF32 split products
// would hold them but triple the tensor-core work and add two splits per
// operand; at the shapes that run these kernels (B = 1 and B = 32) the time
// is latency, not instruction rate, so the plain FMA path was chosen.
//
// Bounds on the H100 (3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores),
// bytes counted once per input and output (chip_smoke.py cell_bytes_flops):
//   Monaco .ini, B=32 N=28 F=H=64 f32: forward 5.3 MB, 58.7 MFLOP -> 0.00158 ms
//     (bytes); backward 9.4 MB, 176 MFLOP -> 0.00282 ms (bytes).
//   Flagship shape in f32, B=768 N=25 F=H=64: forward 1.26 GFLOP -> 0.0188 ms,
//     backward 3.77 GFLOP -> 0.0563 ms (operations).
//
// The design (each kernel 256 threads; the Python wrapper's general_plan picks
// the tiles from B, N, H and the SM count so that the grid fills the card):
//   * Gate kernels (forward, and backward pass 1): a block owns one agent, a
//     slice of JT hidden units with all four gates of each (the gate math
//     stays in registers) and a batch tile of BR rows; BR is 1 at B = 1, so
//     no padded row is computed there. Five tile shapes (BR x JT = 1x8, 4x8,
//     8x8, 16x16, 32x32). A thread owns RT rows x 4 gates of one unit; where
//     a tile has fewer outputs than threads, the block splits K over KS groups
//     of threads and sums the groups in a fixed order at the end.
//   * K = F + H is walked in chunks of KC rows through a three-stage ring in
//     shared memory: the weight slice [KC x 4 x JT] one chunk ahead of the
//     one computed, with 16-byte cp.async (zero-filled past K and H); the
//     activations [x | h_in] two chunks ahead, through two register sets
//     (loaded before a chunk's FMAs, stored after the next chunk's), masked
//     and rounded on the way. No width is bounded by shared memory: the loop
//     over chunks is the only thing K sets. The gate kernels are held to 128
//     registers (two blocks an SM) with the chunk loop unrolled by 4: without
//     that, ptxas spills in some of them. (A four-stage ring two chunks ahead
//     was 5 % slower in the backward; 16-row weight-gradient chunks, 32-row
//     weight-gradient tiles, 32 x 16 gate tiles at B=768, 32 x 64 [dx | dh]
//     tiles and caps of 85 or 255 registers were all slower.)
//   * Backward pass 1 writes gz_T [N, B, 4H], dc_prev and the f32 sums of gz
//     over each block's rows (db partials [N, tiles, 4H]).
//   * Backward pass 2 ([dx | dh] = gz_T @ [wx | wh]^T): a block owns an agent,
//     a batch tile and a slice of K; gz_T rows and weight rows are both
//     contiguous along 4H, so both stream through the ring with 16-byte
//     cp.async in chunks of 64 columns; a thread owns RT x CT outputs read as
//     float4 along the contraction. Three tile shapes (4x32, 16x32, 64x64).
//   * Backward pass 3 ([dwx; dwh] = [x | h_in]^T @ gz_T, db): a block owns a
//     64 x 64 tile of one agent's weight gradient in registers (4 x 4 a
//     thread) and walks the whole batch in order in chunks of 32 rows through
//     the ring; the blocks of the first K tile also sum the db partials in
//     tile order. Three launches per backward call.
//   * Widths whose rows are not whole 16-byte pieces (F or H not a multiple
//     of 16 / sizeof(T)), or weights not 16-byte aligned, take the same
//     kernels with element-wise copies into the ring (the `vec` flag).
//   * Determinism: every sum has a fixed order (k chunks in order, the KS
//     groups in order, batch chunks in order, db tiles in order). No float
//     atomics: the gradients are bitwise reproducible.
//
// Reached (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W, warm L2),
// forward / backward: Monaco .ini 0.0097 / 0.0245 ms, B=1 0.0051 / 0.0157 ms,
// flagship f32 0.083 / 0.202 ms (23 % / 28 % of the bound).
// What holds them back: at B = 1 and B = 32 a launch is a few microseconds of
// fixed cost (launch, the first chunk's load latency, the epilogue's stores)
// against bounds of one to three microseconds. At the flagship f32 shape,
// latency: the gate kernels run 16 warps an SM (128 registers, two blocks)
// with a barrier per chunk of K, and the weight pass has 200 blocks for 132
// SMs; next come shared-memory reads (one float4 of activations and four
// weight scalars per 16 FMAs in the gate kernels) and the FMA rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;  // ring depth
constexpr int kAhead = 1;   // chunks loaded ahead of the one computed (at most kStages - 2)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// round through the compute dtype: the value a T-typed intermediate holds
template <typename T> __device__ __forceinline__ float rd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float sigmoid_f(float z) { return 1.f / (1.f + expf(-z)); }

__device__ __forceinline__ size_t act_off(int b, int N, int n, int X, int k) {
  return ((size_t)b * N + n) * X + k;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; zeros when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive shared-memory elements as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
__host__ __device__ constexpr size_t up16(size_t a) { return (a + 15) / 16 * 16; }

// ---- gate kernels: forward and backward pass 1 ----

// A gate block: BR batch rows x JT hidden units (x 4 gates) of one agent; a
// thread owns RT rows (tr * RT + i) x 4 gates of unit tj, and K-split group
// ks of KS takes rows ks, ks + KS, ... of each chunk of KC rows of K.
template <typename T, int BR_, int JT_, int RT_, int KC_>
struct Act {
  static constexpr int BR = BR_, JT = JT_, RT = RT_, KC = KC_;
  static constexpr int TR = BR / RT;
  static constexpr int LANES = JT * TR;       // threads of one K-split group
  static constexpr int KS = kThreads / LANES;
  static constexpr int VE = 16 / sizeof(T);   // elements of a 16-byte piece
  static constexpr int WLD = 4 * JT + 2 * VE; // weight stage row (elements), padded 32 bytes
  static constexpr int ALD = BR + 4;          // activation stage row (floats)
  static constexpr int APT = (KC * BR + kThreads - 1) / kThreads;  // act. loads a thread
  static constexpr size_t w_stage = (size_t)KC * WLD * sizeof(T);
  static constexpr size_t a_stage = (size_t)KC * ALD * sizeof(float);
  static constexpr size_t ring = kStages * (w_stage + a_stage);
  static constexpr size_t red = KS > 1 ? (size_t)(KS - 1) * LANES * RT * 4 * sizeof(float) : 0;
  static constexpr size_t ms_bytes = up16(BR * sizeof(float));
  static constexpr size_t body = up16(cmax(ring, red));
  static constexpr size_t gz_bytes = (size_t)BR * 4 * JT * sizeof(float);
  static constexpr size_t smem_fwd = ms_bytes + body;
  static constexpr size_t smem_bwd = ms_bytes + body + gz_bytes;
  static_assert(BR % RT == 0 && kThreads % LANES == 0 && KC % KS == 0, "tile");
  static_assert(JT % VE == 0, "a gate's columns are whole 16-byte pieces");
};

// The weight slice of chunk k0: rows k0 .. k0 + KC of [wx[n]; wh[n]], columns
// g * H + j0 .. + JT of each gate g, into ws [KC][4][JT] (row pitch WLD).
template <class C, typename T>
__device__ __forceinline__ void load_w(T* ws, const T* __restrict__ wx_n,
                                       const T* __restrict__ wh_n, int k0, int j0, int F,
                                       int H, bool vec) {
  const int K = F + H;
  const size_t G = 4 * (size_t)H;
  if (vec) {
    constexpr int PR = C::JT / C::VE;  // pieces of one gate's JT columns
    for (int p = threadIdx.x; p < C::KC * 4 * PR; p += kThreads) {
      const int kk = p / (4 * PR), rem = p - kk * 4 * PR, g = rem / PR, v = rem - g * PR;
      const int k = k0 + kk, j = j0 + v * C::VE;
      const bool ok = k < K && j < H;
      const T* src = wx_n;
      if (ok) src = (k < F ? wx_n + k * G : wh_n + (k - F) * G) + (size_t)g * H + j;
      cp_async16(ws + kk * C::WLD + g * C::JT + v * C::VE, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < C::KC * 4 * C::JT; e += kThreads) {
      const int kk = e / (4 * C::JT), rem = e - kk * 4 * C::JT, g = rem / C::JT,
                jj = rem - g * C::JT;
      const int k = k0 + kk, j = j0 + jj;
      T v = from_f<T>(0.f);
      if (k < K && j < H)
        v = k < F ? wx_n[k * G + (size_t)g * H + j] : wh_n[(k - F) * G + (size_t)g * H + j];
      ws[kk * C::WLD + g * C::JT + jj] = v;
    }
  }
}

// The activations of chunk k0 into registers: element s of this thread is
// (row r, column kk) = divmod(tid + s * kThreads, KC) of [x | h]. With
// `mask`, h is the raw carry and is masked and rounded here (forward).
template <class C, typename T>
__device__ __forceinline__ void load_a(float (&a)[C::APT], const T* __restrict__ x,
                                       const T* __restrict__ h, const float* ms, bool mask,
                                       int k0, int b0, int rows, int N, int n, int F, int H) {
#pragma unroll
  for (int s = 0; s < C::APT; ++s) {
    const int i = threadIdx.x + s * kThreads;
    const int r = i / C::KC, k = k0 + i - r * C::KC;
    float v = 0.f;
    if (i < C::KC * C::BR && r < rows && k < F + H) {
      if (k < F) {
        v = to_f(x[act_off(b0 + r, N, n, F, k)]);
      } else {
        v = to_f(h[act_off(b0 + r, N, n, H, k - F)]);
        if (mask) v = rd<T>(v * ms[r]);
      }
    }
    a[s] = v;
  }
}

template <class C>
__device__ __forceinline__ void store_a(float* as, const float (&a)[C::APT]) {
#pragma unroll
  for (int s = 0; s < C::APT; ++s) {
    const int i = threadIdx.x + s * kThreads;
    if (i < C::KC * C::BR) {
      const int r = i / C::KC, kk = i - r * C::KC;
      as[kk * C::ALD + r] = a[s];
    }
  }
}

// z = [x | h_in] @ [wx[n]; wh[n]] + b[n] for the block's rows and units:
// complete in the threads of K-split group 0 (acc[i][g] for row tr * RT + i,
// gate g of unit j0 + tj); every thread of the block must call it.
template <class C, typename T>
__device__ void gate_preacts(unsigned char* body, const T* __restrict__ x,
                             const T* __restrict__ h, const float* ms, bool mask,
                             const T* __restrict__ wx, const T* __restrict__ wh,
                             const T* __restrict__ bias, int n, int j0, int b0, int rows,
                             int N, int F, int H, bool vec, float (&acc)[C::RT][4]) {
  const int K = F + H;
  const size_t G = 4 * (size_t)H;
  const T* wx_n = wx + (size_t)n * F * G;
  const T* wh_n = wh + (size_t)n * H * G;
  T* wring = reinterpret_cast<T*>(body);
  float* aring = reinterpret_cast<float*>(body + kStages * C::w_stage);
  constexpr int WS = C::KC * C::WLD, AS = C::KC * C::ALD;
  const int tid = threadIdx.x;
  const int tj = tid % C::JT, tr = (tid / C::JT) % C::TR, ks = tid / C::LANES;
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;

  const int j = j0 + tj;
  float bg[4] = {0.f, 0.f, 0.f, 0.f};  // the bias, read before the loop
  if (ks == 0 && j < H)
#pragma unroll
    for (int g = 0; g < 4; ++g) bg[g] = to_f(bias[(size_t)n * G + (size_t)g * H + j]);

  // The weights run kAhead chunks ahead through cp.async. The activations go
  // through two register sets: chunk c + 2 is loaded while chunk c is
  // computed, and chunk c + 1 (loaded one chunk earlier) is stored after it.
  const int nk = (K + C::KC - 1) / C::KC;
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    if (c < nk) load_w<C, T>(wring + c * WS, wx_n, wh_n, c * C::KC, j0, F, H, vec);
    cp_async_commit();
  }
  float ra[C::APT], rb[C::APT];
  load_a<C, T>(ra, x, h, ms, mask, 0, b0, rows, N, n, F, H);
  store_a<C>(aring, ra);
  if (nk > 1) load_a<C, T>(rb, x, h, ms, mask, C::KC, b0, rows, N, n, F, H);
  // chunk c; `cur` holds chunk c + 1, `nxt` is free
  auto step = [&](int c, float (&nxt)[C::APT], const float (&cur)[C::APT]) {
    if (c + kAhead < nk)
      load_w<C, T>(wring + ((c + kAhead) % kStages) * WS, wx_n, wh_n, (c + kAhead) * C::KC, j0,
                   F, H, vec);
    cp_async_commit();
    if (c + 2 < nk) load_a<C, T>(nxt, x, h, ms, mask, (c + 2) * C::KC, b0, rows, N, n, F, H);
    cp_async_wait<kAhead>();
    __syncthreads();
    const T* ws = wring + (c % kStages) * WS + tj;
    const float* as = aring + (c % kStages) * AS + tr * C::RT;
#pragma unroll 4
    for (int q = 0; q < C::KC / C::KS; ++q) {
      const int kk = ks + q * C::KS;
      float av[C::RT];
      if constexpr (C::RT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < C::RT; i += 4) {
          const float4 v = ld4(as + kk * C::ALD + i);
          av[i] = v.x, av[i + 1] = v.y, av[i + 2] = v.z, av[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < C::RT; ++i) av[i] = as[kk * C::ALD + i];
      }
      const T* w = ws + kk * C::WLD;
      const float w0 = to_f(w[0]), w1 = to_f(w[C::JT]), w2 = to_f(w[2 * C::JT]),
                  w3 = to_f(w[3 * C::JT]);
#pragma unroll
      for (int i = 0; i < C::RT; ++i) {
        acc[i][0] += av[i] * w0;
        acc[i][1] += av[i] * w1;
        acc[i][2] += av[i] * w2;
        acc[i][3] += av[i] * w3;
      }
    }
    if (c + 1 < nk) store_a<C>(aring + ((c + 1) % kStages) * AS, cur);
  };
  for (int c = 0; c < nk; c += 2) {
    step(c, ra, rb);
    if (c + 1 < nk) step(c + 1, rb, ra);
  }
  __syncthreads();  // the ring is free

  if constexpr (C::KS > 1) {  // the K-split groups, summed in group order
    float* red = reinterpret_cast<float*>(body);
    const int slot = tid % C::LANES;
    if (ks > 0)
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          red[(((ks - 1) * C::LANES + slot) * C::RT + i) * 4 + g] = acc[i][g];
    __syncthreads();
    if (ks == 0)
      for (int s = 0; s < C::KS - 1; ++s)
#pragma unroll
        for (int i = 0; i < C::RT; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[i][g] += red[((s * C::LANES + slot) * C::RT + i) * 4 + g];
  }
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] += bg[g];
}

// the block's agent, first unit, first row and live rows; the done mask of its
// rows into ms
template <class C, typename T>
__device__ __forceinline__ void gate_block(const T* __restrict__ done, float* ms, int B, int H,
                                           int& n, int& j0, int& b0, int& rows) {
  const int jtiles = (H + C::JT - 1) / C::JT;
  n = blockIdx.x / jtiles;
  j0 = (blockIdx.x - n * jtiles) * C::JT;
  b0 = blockIdx.y * C::BR;
  rows = min(C::BR, B - b0);
  for (int r = threadIdx.x; r < C::BR; r += kThreads)
    ms[r] = r < rows ? rd<T>(1.f - to_f(done[b0 + r])) : 0.f;
  __syncthreads();
}

// Forward. Grid (N * ceil(H / JT), ceil(B / BR)).
template <typename T, class C>
__global__ void __launch_bounds__(kThreads, 2)
lstm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ c,
                const T* __restrict__ done, const T* __restrict__ wx,
                const T* __restrict__ wh, const T* __restrict__ b, T* __restrict__ h_out,
                T* __restrict__ c_out, T* __restrict__ hin_out, T* __restrict__ cin_out,
                int B, int N, int F, int H, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ms = reinterpret_cast<float*>(smem);
  int n, j0, b0, rows;
  gate_block<C, T>(done, ms, B, H, n, j0, b0, rows);
  const int tid = threadIdx.x;
  const int j = j0 + tid % C::JT, tr = (tid / C::JT) % C::TR;
  const bool owner = tid / C::LANES == 0 && j < H;  // this thread's outputs exist
  float cv[C::RT], hv[C::RT];  // the epilogue's c and h, read before the product
#pragma unroll
  for (int i = 0; i < C::RT; ++i) {
    const int rr = tr * C::RT + i;
    cv[i] = hv[i] = 0.f;
    if (owner && rr < rows) {
      const size_t off = act_off(b0 + rr, N, n, H, j);
      cv[i] = to_f(c[off]);
      if (hin_out != nullptr) hv[i] = to_f(h[off]);
    }
  }
  float acc[C::RT][4];
  gate_preacts<C, T>(smem + C::ms_bytes, x, h, ms, true, wx, wh, b, n, j0, b0, rows, N, F, H,
                     vec != 0, acc);
  if (!owner) return;
#pragma unroll
  for (int i = 0; i < C::RT; ++i) {
    const int rr = tr * C::RT + i;
    if (rr >= rows) continue;
    const size_t off = act_off(b0 + rr, N, n, H, j);
    const float ig = sigmoid_f(acc[i][0]), fg = sigmoid_f(acc[i][1]);
    const float og = sigmoid_f(acc[i][2]), ug = tanhf(acc[i][3]);
    const float m = ms[rr];
    const float c_in = rd<T>(cv[i] * m);
    const float c_new = fg * c_in + ig * ug;
    h_out[off] = from_f<T>(og * tanhf(c_new));
    c_out[off] = from_f<T>(c_new);
    if (hin_out != nullptr) {  // masked carry residuals for the backward
      hin_out[off] = from_f<T>(hv[i] * m);
      cin_out[off] = from_f<T>(c_in);
    }
  }
}

// Backward, pass 1. Grid (N * ceil(H / JT), ceil(B / BR)). Recomputes the
// gates; writes dc_prev, gz_T [N][B][4H] and the f32 sums of gz over the
// block's rows, db_part [N][gridDim.y][4H].
template <typename T, class C>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_act_kernel(const T* __restrict__ x, const T* __restrict__ h_in,
                    const T* __restrict__ c_in, const T* __restrict__ c_new,
                    const T* __restrict__ dc_new, const T* __restrict__ dh_new,
                    const T* __restrict__ done, const T* __restrict__ wx,
                    const T* __restrict__ wh, const T* __restrict__ b,
                    T* __restrict__ dc_prev, T* __restrict__ gz_out,
                    float* __restrict__ db_part, int B, int N, int F, int H, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ms = reinterpret_cast<float*>(smem);
  float* gzs = reinterpret_cast<float*>(smem + C::ms_bytes + C::body);  // [BR][4][JT]
  int n, j0, b0, rows;
  gate_block<C, T>(done, ms, B, H, n, j0, b0, rows);
  const int tid = threadIdx.x;
  const int tj = tid % C::JT, tr = (tid / C::JT) % C::TR, j = j0 + tj;
  const size_t G = 4 * (size_t)H;
  const bool owner = tid / C::LANES == 0;
  // the epilogue's operands, read before the product
  float cn[C::RT], dhv[C::RT], dcv[C::RT], civ[C::RT];
#pragma unroll
  for (int i = 0; i < C::RT; ++i) {
    const int rr = tr * C::RT + i;
    cn[i] = dhv[i] = dcv[i] = civ[i] = 0.f;
    if (owner && rr < rows && j < H) {
      const size_t off = act_off(b0 + rr, N, n, H, j);
      cn[i] = to_f(c_new[off]);
      dhv[i] = to_f(dh_new[off]);
      dcv[i] = to_f(dc_new[off]);
      civ[i] = to_f(c_in[off]);
    }
  }
  float acc[C::RT][4];
  gate_preacts<C, T>(smem + C::ms_bytes, x, h_in, ms, false, wx, wh, b, n, j0, b0, rows, N,
                     F, H, vec != 0, acc);
  if (owner) {
#pragma unroll
    for (int i = 0; i < C::RT; ++i) {
      const int rr = tr * C::RT + i;
      float gz[4] = {0.f, 0.f, 0.f, 0.f};
      if (rr < rows && j < H) {
        const size_t off = act_off(b0 + rr, N, n, H, j);
        const float ig = sigmoid_f(acc[i][0]), fg = sigmoid_f(acc[i][1]);
        const float og = sigmoid_f(acc[i][2]), ug = tanhf(acc[i][3]);
        const float tc = tanhf(cn[i]);
        const float dhn = dhv[i];
        const float dc = dhn * og * (1.f - tc * tc) + dcv[i];
        gz[0] = (dc * ug) * ig * (1.f - ig);
        gz[1] = (dc * civ[i]) * fg * (1.f - fg);
        gz[2] = (dhn * tc) * og * (1.f - og);
        gz[3] = (dc * ig) * (1.f - ug * ug);
        dc_prev[off] = from_f<T>((dc * fg) * ms[rr]);
        T* out = gz_out + ((size_t)n * B + b0 + rr) * G + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) out[(size_t)g * H] = from_f<T>(gz[g]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) gzs[(rr * 4 + g) * C::JT + tj] = gz[g];
    }
  }
  __syncthreads();
  for (int t = tid; t < 4 * C::JT; t += kThreads) {
    const int g = t / C::JT, jj = t - g * C::JT;
    if (j0 + jj >= H) continue;
    float s = 0.f;
    for (int rr = 0; rr < rows; ++rr) s += gzs[(rr * 4 + g) * C::JT + jj];
    db_part[((size_t)n * gridDim.y + blockIdx.y) * G + (size_t)g * H + j0 + jj] = s;
  }
}

// ---- backward pass 2: [dx | dh] = gz_T @ [wx[n]; wh[n]]^T ----

// A block: BR batch rows x KT columns of [dx | dh] of one agent; a thread owns
// rows tr + i * TR (i < RT) x columns tk + c * TK (c < CT); K-split group ks
// takes 4-column groups ks, ks + KS, ... of each chunk of MC columns of 4H.
template <typename T, int BR_, int KT_, int RT_, int CT_, int MC_>
struct Dxdh {
  static constexpr int BR = BR_, KT = KT_, RT = RT_, CT = CT_, MC = MC_;
  static constexpr int TR = BR / RT, TK = KT / CT;
  static constexpr int LANES = TR * TK;
  static constexpr int KS = kThreads / LANES;
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int LD = MC + VE;  // stage row, elements: 16 bytes of padding
  static constexpr size_t stage = (size_t)(BR + KT) * LD * sizeof(T);
  static constexpr size_t ring = kStages * stage;
  static constexpr size_t red = KS > 1 ? (size_t)(KS - 1) * LANES * RT * CT * sizeof(float) : 0;
  static constexpr size_t smem = cmax(ring, red);
  static_assert(BR % RT == 0 && KT % CT == 0 && kThreads % LANES == 0 && (MC / 4) % KS == 0,
                "tile");
};

// chunk m0 of gz_T rows (stage rows [0, BR)) and of weight rows (rows [BR, BR + KT))
template <class C, typename T>
__device__ __forceinline__ void load_dxdh(T* st, const T* __restrict__ gz_n,
                                          const T* __restrict__ wx_n,
                                          const T* __restrict__ wh_n, int m0, int b0, int k0,
                                          int B, int F, int H, bool vec) {
  const int K = F + H, G = 4 * H;
  if (vec) {
    constexpr int PR = C::MC / C::VE;
    for (int p = threadIdx.x; p < (C::BR + C::KT) * PR; p += kThreads) {
      const int row = p / PR, v = p - row * PR, m = m0 + v * C::VE;
      const T* src = gz_n;
      bool ok;
      if (row < C::BR) {
        ok = b0 + row < B && m < G;
        if (ok) src = gz_n + (size_t)(b0 + row) * G + m;
      } else {
        const int k = k0 + row - C::BR;
        ok = k < K && m < G;
        if (ok) src = (k < F ? wx_n + (size_t)k * G : wh_n + (size_t)(k - F) * G) + m;
      }
      cp_async16(st + row * C::LD + v * C::VE, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < (C::BR + C::KT) * C::MC; e += kThreads) {
      const int row = e / C::MC, mm = e - row * C::MC, m = m0 + mm;
      T v = from_f<T>(0.f);
      if (row < C::BR) {
        if (b0 + row < B && m < G) v = gz_n[(size_t)(b0 + row) * G + m];
      } else {
        const int k = k0 + row - C::BR;
        if (k < K && m < G) v = k < F ? wx_n[(size_t)k * G + m] : wh_n[(size_t)(k - F) * G + m];
      }
      st[row * C::LD + mm] = v;
    }
  }
}

// Grid (N * ceil(K / KT), ceil(B / BR)).
template <typename T, class C>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_dxdh_kernel(const T* __restrict__ gz, const T* __restrict__ wx,
                     const T* __restrict__ wh, const T* __restrict__ done, T* __restrict__ dx,
                     T* __restrict__ dh, int B, int N, int F, int H, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  constexpr int SE = (C::BR + C::KT) * C::LD;  // elements of a stage
  const int K = F + H, G = 4 * H;
  const int ktiles = (K + C::KT - 1) / C::KT;
  const int n = blockIdx.x / ktiles, k0 = (blockIdx.x - n * ktiles) * C::KT;
  const int b0 = blockIdx.y * C::BR;
  const int tid = threadIdx.x;
  const int tk = tid % C::TK, tr = (tid / C::TK) % C::TR, ks = tid / C::LANES;
  const T* gz_n = gz + (size_t)n * B * G;
  const T* wx_n = wx + (size_t)n * F * G;
  const T* wh_n = wh + (size_t)n * H * G;
  float acc[C::RT][C::CT];
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
#pragma unroll
    for (int c = 0; c < C::CT; ++c) acc[i][c] = 0.f;

  const int nm = (G + C::MC - 1) / C::MC;
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    if (c < nm) load_dxdh<C, T>(ring + c * SE, gz_n, wx_n, wh_n, c * C::MC, b0, k0, B, F, H, vec);
    cp_async_commit();
  }
  for (int c = 0; c < nm; ++c) {
    const int ahead = c + kAhead;
    if (ahead < nm)
      load_dxdh<C, T>(ring + (ahead % kStages) * SE, gz_n, wx_n, wh_n, ahead * C::MC, b0, k0,
                      B, F, H, vec);
    cp_async_commit();
    cp_async_wait<kAhead>();
    __syncthreads();
    const T* gs = ring + (c % kStages) * SE;
    const T* ws = gs + C::BR * C::LD;
#pragma unroll
    for (int q = 0; q < C::MC / 4 / C::KS; ++q) {
      const int m4 = (ks + q * C::KS) * 4;
      float4 g[C::RT], w[C::CT];
#pragma unroll
      for (int i = 0; i < C::RT; ++i) g[i] = ld4(gs + (tr + i * C::TR) * C::LD + m4);
#pragma unroll
      for (int cc = 0; cc < C::CT; ++cc) w[cc] = ld4(ws + (tk + cc * C::TK) * C::LD + m4);
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
#pragma unroll
        for (int cc = 0; cc < C::CT; ++cc) {
          float s = acc[i][cc];
          s += g[i].x * w[cc].x;
          s += g[i].y * w[cc].y;
          s += g[i].z * w[cc].z;
          s += g[i].w * w[cc].w;
          acc[i][cc] = s;
        }
    }
  }
  __syncthreads();  // the ring is free

  if constexpr (C::KS > 1) {
    float* red = reinterpret_cast<float*>(smem);
    const int slot = tid % C::LANES;
    if (ks > 0)
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
#pragma unroll
        for (int cc = 0; cc < C::CT; ++cc)
          red[(((ks - 1) * C::LANES + slot) * C::RT + i) * C::CT + cc] = acc[i][cc];
    __syncthreads();
    if (ks == 0)
      for (int s = 0; s < C::KS - 1; ++s)
#pragma unroll
        for (int i = 0; i < C::RT; ++i)
#pragma unroll
          for (int cc = 0; cc < C::CT; ++cc)
            acc[i][cc] += red[((s * C::LANES + slot) * C::RT + i) * C::CT + cc];
  }
  if (ks != 0) return;
#pragma unroll
  for (int i = 0; i < C::RT; ++i) {
    const int bb = b0 + tr + i * C::TR;
    if (bb >= B) continue;
    const float m = rd<T>(1.f - to_f(done[bb]));
#pragma unroll
    for (int cc = 0; cc < C::CT; ++cc) {
      const int k = k0 + tk + cc * C::TK;
      if (k >= K) continue;
      if (k < F)
        dx[act_off(bb, N, n, F, k)] = from_f<T>(acc[i][cc]);
      else
        dh[act_off(bb, N, n, H, k - F)] = from_f<T>(acc[i][cc] * m);
    }
  }
}

// ---- backward pass 3: [dwx; dwh] = [x | h_in]^T @ gz_T and db ----

constexpr int kWK = 64;  // dW rows (over F + H) per block
constexpr int kWM = 64;  // dW columns (over 4H) per block
constexpr int kWB = 32;  // batch rows per chunk

template <typename T>
struct Wgt {
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int LDA = kWK + VE, LDG = kWM + VE;  // 16 bytes of padding
  static constexpr int SE = kWB * (LDA + LDG);          // elements of a stage
  static constexpr size_t smem = kStages * (size_t)SE * sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_wgt(T* st, const T* __restrict__ x,
                                         const T* __restrict__ h_in,
                                         const T* __restrict__ gz_n, int bb0, int k0, int m0,
                                         int B, int N, int n, int F, int H, bool vec) {
  using W = Wgt<T>;
  const int K = F + H, G = 4 * H;
  T* as = st;
  T* gs = st + kWB * W::LDA;
  if (vec) {
    constexpr int PA = kWK / W::VE, PG = kWM / W::VE;
    for (int p = threadIdx.x; p < kWB * (PA + PG); p += kThreads) {
      if (p < kWB * PA) {
        const int r = p / PA, v = p - r * PA, b = bb0 + r, k = k0 + v * W::VE;
        const bool ok = b < B && k < K;
        const T* src = x;
        if (ok) src = k < F ? x + act_off(b, N, n, F, k) : h_in + act_off(b, N, n, H, k - F);
        cp_async16(as + r * W::LDA + v * W::VE, src, ok);
      } else {
        const int q = p - kWB * PA, r = q / PG, v = q - r * PG, b = bb0 + r, m = m0 + v * W::VE;
        const bool ok = b < B && m < G;
        cp_async16(gs + r * W::LDG + v * W::VE, ok ? gz_n + (size_t)b * G + m : gz_n, ok);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kWB * (kWK + kWM); e += kThreads) {
      T v = from_f<T>(0.f);
      if (e < kWB * kWK) {
        const int r = e / kWK, kk = e - r * kWK, b = bb0 + r, k = k0 + kk;
        if (b < B && k < K)
          v = k < F ? x[act_off(b, N, n, F, k)] : h_in[act_off(b, N, n, H, k - F)];
        as[r * W::LDA + kk] = v;
      } else {
        const int q = e - kWB * kWK, r = q / kWM, mm = q - r * kWM, b = bb0 + r, m = m0 + mm;
        if (b < B && m < G) v = gz_n[(size_t)b * G + m];
        gs[r * W::LDG + mm] = v;
      }
    }
  }
}

// Grid (N, ceil((F + H) / kWK), ceil(4H / kWM)): one block per (agent, weight
// tile) in registers, kWK / 16 x 4 a thread, walking the whole batch in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ h_in,
                       const T* __restrict__ gz, const float* __restrict__ db_part,
                       int n_tiles, float* __restrict__ dwx, float* __restrict__ dwh,
                       float* __restrict__ db, int B, int N, int F, int H, int vec) {
  using W = Wgt<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int n = blockIdx.x, k0 = blockIdx.y * kWK, m0 = blockIdx.z * kWM;
  const int K = F + H, G = 4 * H;
  constexpr int RK = kWK / 16;  // dW rows a thread: tk * RK + i
  const int tid = threadIdx.x, tm = tid % 16, tk = tid / 16;
  const T* gz_n = gz + (size_t)n * B * G;
  float acc[RK][4];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  const int nb = (B + kWB - 1) / kWB;
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    if (c < nb) load_wgt<T>(ring + c * W::SE, x, h_in, gz_n, c * kWB, k0, m0, B, N, n, F, H, vec);
    cp_async_commit();
  }
  for (int c = 0; c < nb; ++c) {
    const int ahead = c + kAhead;
    if (ahead < nb)
      load_wgt<T>(ring + (ahead % kStages) * W::SE, x, h_in, gz_n, ahead * kWB, k0, m0, B, N,
                  n, F, H, vec);
    cp_async_commit();
    cp_async_wait<kAhead>();
    __syncthreads();
    const T* as = ring + (c % kStages) * W::SE + tk * RK;
    const T* gs = ring + (c % kStages) * W::SE + kWB * W::LDA + tm * 4;
#pragma unroll 4
    for (int r = 0; r < kWB; ++r) {
      const float4 g = ld4(gs + r * W::LDG);
      const float gv[4] = {g.x, g.y, g.z, g.w};
      float av[RK];
      if constexpr (RK == 4) {
        const float4 a = ld4(as + r * W::LDA);
        av[0] = a.x, av[1] = a.y, av[2] = a.z, av[3] = a.w;
      } else {
#pragma unroll
        for (int i = 0; i < RK; ++i) av[i] = to_f(as[r * W::LDA + i]);
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += av[i] * gv[jj];
    }
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int k = k0 + tk * RK + i;
    if (k >= K) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int m = m0 + tm * 4 + jj;
      if (m >= G) continue;
      if (k < F)
        dwx[((size_t)n * F + k) * G + m] = acc[i][jj];
      else
        dwh[((size_t)n * H + (k - F)) * G + m] = acc[i][jj];
    }
  }
  if (blockIdx.y == 0 && tid < kWM && m0 + tid < G) {
    const int m = m0 + tid;
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += db_part[((size_t)n * n_tiles + t) * G + m];
    db[(size_t)n * G + m] = s;
  }
}

// ---- launches ----

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The gate kernels' tile shapes by config index (general_plan in
// ops/lstm_cell.py holds the same table): BR, JT, RT, KC.
template <typename T, int I> struct ActCfg;
template <typename T> struct ActCfg<T, 0> { using type = Act<T, 1, 8, 1, 32>; };
template <typename T> struct ActCfg<T, 1> { using type = Act<T, 4, 8, 1, 32>; };
template <typename T> struct ActCfg<T, 2> { using type = Act<T, 8, 8, 2, 32>; };
template <typename T> struct ActCfg<T, 3> { using type = Act<T, 16, 16, 4, 32>; };
template <typename T> struct ActCfg<T, 4> { using type = Act<T, 32, 32, 4, 16>; };
constexpr int kActCfgs = 5;
// the [dx | dh] kernel's: BR, KT, RT, CT, MC
template <typename T, int I> struct DxdhCfg;
template <typename T> struct DxdhCfg<T, 0> { using type = Dxdh<T, 4, 32, 1, 1, 64>; };
template <typename T> struct DxdhCfg<T, 1> { using type = Dxdh<T, 16, 32, 2, 2, 64>; };
template <typename T> struct DxdhCfg<T, 2> { using type = Dxdh<T, 64, 64, 4, 4, 64>; };
constexpr int kDxdhCfgs = 3;

template <typename T, int I>
int launch_fwd(const void* x, const void* h, const void* c, const void* done, const void* wx,
               const void* wh, const void* b, void* h_out, void* c_out, void* hin_out,
               void* cin_out, int B, int N, int F, int H, int vec, cudaStream_t stream) {
  using C = typename ActCfg<T, I>::type;
  const dim3 grid(N * ((H + C::JT - 1) / C::JT), (B + C::BR - 1) / C::BR);
  cudaError_t err = allow_smem(lstm_fwd_kernel<T, C>, C::smem_fwd);
  if (err != cudaSuccess) return (int)err;
  lstm_fwd_kernel<T, C><<<grid, kThreads, C::smem_fwd, stream>>>(
      (const T*)x, (const T*)h, (const T*)c, (const T*)done, (const T*)wx, (const T*)wh,
      (const T*)b, (T*)h_out, (T*)c_out, (T*)hin_out, (T*)cin_out, B, N, F, H, vec);
  return (int)cudaGetLastError();
}

template <typename T, int I>
int launch_bwd_act(const void* x, const void* h_in, const void* c_in, const void* c_new,
                   const void* dc_new, const void* dh_new, const void* done, const void* wx,
                   const void* wh, const void* b, void* dc_prev, void* gz, void* db_part,
                   int B, int N, int F, int H, int vec, cudaStream_t stream, int* n_tiles) {
  using C = typename ActCfg<T, I>::type;
  const dim3 grid(N * ((H + C::JT - 1) / C::JT), (B + C::BR - 1) / C::BR);
  *n_tiles = (int)grid.y;
  cudaError_t err = allow_smem(lstm_bwd_act_kernel<T, C>, C::smem_bwd);
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_act_kernel<T, C><<<grid, kThreads, C::smem_bwd, stream>>>(
      (const T*)x, (const T*)h_in, (const T*)c_in, (const T*)c_new, (const T*)dc_new,
      (const T*)dh_new, (const T*)done, (const T*)wx, (const T*)wh, (const T*)b, (T*)dc_prev,
      (T*)gz, (float*)db_part, B, N, F, H, vec);
  return (int)cudaGetLastError();
}

template <typename T, int I>
int launch_bwd_dxdh(const void* gz, const void* wx, const void* wh, const void* done, void* dx,
                    void* dh, int B, int N, int F, int H, int vec, cudaStream_t stream) {
  using C = typename DxdhCfg<T, I>::type;
  const dim3 grid(N * ((F + H + C::KT - 1) / C::KT), (B + C::BR - 1) / C::BR);
  cudaError_t err = allow_smem(lstm_bwd_dxdh_kernel<T, C>, C::smem);
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_dxdh_kernel<T, C><<<grid, kThreads, C::smem, stream>>>(
      (const T*)gz, (const T*)wx, (const T*)wh, (const T*)done, (T*)dx, (T*)dh, B, N, F, H, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int act, const void* x, const void* h, const void* c, const void* done,
                 const void* wx, const void* wh, const void* b, void* h_out, void* c_out,
                 void* hin_out, void* cin_out, int B, int N, int F, int H, int vec,
                 cudaStream_t s) {
#define LSTM_FWD(I)                                                                          \
  case I:                                                                                    \
    return launch_fwd<T, I>(x, h, c, done, wx, wh, b, h_out, c_out, hin_out, cin_out, B, N, F, \
                            H, vec, s);
  switch (act) { LSTM_FWD(0) LSTM_FWD(1) LSTM_FWD(2) LSTM_FWD(3) LSTM_FWD(4) }
#undef LSTM_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_bwd(int act, int dxdh, const void* x, const void* h_in, const void* c_in,
                 const void* c_new, const void* dc_new, const void* dh_new, const void* done,
                 const void* wx, const void* wh, const void* b, void* dx, void* dh,
                 void* dc_prev, void* gz, void* db_part, void* dwx, void* dwh, void* db, int B,
                 int N, int F, int H, int vec, cudaStream_t s) {
  int n_tiles = 0, err = (int)cudaErrorInvalidValue;
#define LSTM_ACT(I)                                                                         \
  case I:                                                                                   \
    err = launch_bwd_act<T, I>(x, h_in, c_in, c_new, dc_new, dh_new, done, wx, wh, b,       \
                               dc_prev, gz, db_part, B, N, F, H, vec, s, &n_tiles);         \
    break;
  switch (act) { LSTM_ACT(0) LSTM_ACT(1) LSTM_ACT(2) LSTM_ACT(3) LSTM_ACT(4) }
#undef LSTM_ACT
  if (err != 0) return err;
  err = (int)cudaErrorInvalidValue;
#define LSTM_DXDH(I) \
  case I: err = launch_bwd_dxdh<T, I>(gz, wx, wh, done, dx, dh, B, N, F, H, vec, s); break;
  switch (dxdh) { LSTM_DXDH(0) LSTM_DXDH(1) LSTM_DXDH(2) }
#undef LSTM_DXDH
  if (err != 0) return err;
  const dim3 grid(N, (F + H + kWK - 1) / kWK, (4 * H + kWM - 1) / kWM);
  cudaError_t e = allow_smem(lstm_bwd_weight_kernel<T>, Wgt<T>::smem);
  if (e != cudaSuccess) return (int)e;
  lstm_bwd_weight_kernel<T><<<grid, kThreads, Wgt<T>::smem, s>>>(
      (const T*)x, (const T*)h_in, (const T*)gz, (const float*)db_part, n_tiles, (float*)dwx,
      (float*)dwh, (float*)db, B, N, F, H, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. Every
// pointer is a device pointer to a contiguous tensor; hin_out/cin_out may be
// null (no residuals). act (0-4) and dxdh (0-2) index the tile shapes above,
// as general_plan chooses them; vec = 1 when F and H are multiples of
// 16 / sizeof(T) and x, h, wx, wh are 16-byte aligned. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a bad argument).

extern "C" int lstm_cell_fwd(int dtype, const void* x, const void* h, const void* c,
                             const void* done, const void* wx, const void* wh, const void* b,
                             void* h_out, void* c_out, void* hin_out, void* cin_out, int B,
                             int N, int F, int H, int act, int vec, void* stream) {
  if (B < 1 || N < 1 || F < 1 || H < 1 || act < 0 || act >= kActCfgs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_fwd<float>(act, x, h, c, done, wx, wh, b, h_out, c_out, hin_out, cin_out, B,
                               N, F, H, vec, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(act, x, h, c, done, wx, wh, b, h_out, c_out, hin_out,
                                       cin_out, B, N, F, H, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_cell_bwd(int dtype, const void* x, const void* h_in, const void* c_in,
                             const void* c_new, const void* dc_new, const void* dh_new,
                             const void* done, const void* wx, const void* wh, const void* b,
                             void* dx, void* dh, void* dc_prev, void* gz, void* db_part,
                             void* dwx, void* dwh, void* db, int B, int N, int F, int H,
                             int act, int dxdh, int vec, void* stream) {
  if (B < 1 || N < 1 || F < 1 || H < 1 || act < 0 || act >= kActCfgs || dxdh < 0 ||
      dxdh >= kDxdhCfgs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_bwd<float>(act, dxdh, x, h_in, c_in, c_new, dc_new, dh_new, done, wx, wh, b,
                               dx, dh, dc_prev, gz, db_part, dwx, dwh, db, B, N, F, H, vec, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(act, dxdh, x, h_in, c_in, c_new, dc_new, dh_new, done, wx,
                                       wh, b, dx, dh, dc_prev, gz, db_part, dwx, dwh, db, B, N,
                                       F, H, vec, s);
  return (int)cudaErrorInvalidValue;
}
