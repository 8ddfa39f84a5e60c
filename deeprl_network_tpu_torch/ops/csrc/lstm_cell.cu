// Fused per-agent LSTM cell, forward and backward, for NVIDIA Hopper (sm_90a):
// the general kernels, with f32 products on the CUDA cores. They serve
// float32 (which TF32 tensor cores could not hold to 1e-5) and bf16 at widths
// that lstm_cell_tc.cu (bf16 on the tensor cores, the flagship path) does
// not take.
//
// Replaces the Pallas TPU kernels of deeprl_network_tpu/ops/pallas_lstm.py:
//   lstm_fwd_kernel             <- _fwd_call's inner `kernel` (pallas_lstm.py:52-117)
//   lstm_bwd_act_kernel and
//   lstm_bwd_weight_kernel      <- _bwd_call's inner `kernel` (pallas_lstm.py:138-243)
// and computes the same function with the same rounding points:
//   forward:  h_in, c_in = (h, c) * (1 - done), rounded to the compute dtype T;
//             z = x @ wx[n] + h_in @ wh[n] + b[n], f32 accumulation;
//             gates (i, f, o, u) = (sig, sig, sig, tanh) of z, in f32;
//             c' = f c_in + i u, h' = o tanh(c'), stored in T.
//   backward: gates recomputed from (x, h_in, c_in); gz (the four gate grads)
//             in f32; dx = gz_T @ wx^T (unmasked); dh = (gz_T @ wh^T) * mask;
//             dc_prev = (dc f) * mask; dwx = x^T gz_T, dwh = h_in^T gz_T and
//             db = sum gz (f32 gz), all summed over the batch in f32.
//   gz_T is gz rounded to T, the operand of the weight-gradient products.
//
// Layout: activations are [B, N, X] row-major, read in place with strides
// (the TPU kernel's transposes to agent-major existed for its BlockSpecs).
// Weights are [N, F, 4H], [N, H, 4H], [N, 4H]. T is float or __nv_bfloat16.
//
// Bound on the H100 at the flagship shape (B=768, N=25, F=H=64, bf16): one
// activation tensor [B, N, 64] is 2.46 MB and the weights 1.6 MB. The forward
// moves 5 to 7 such tensors (x, h, c in; h', c' out; h_in, c_in when a
// backward will follow) and does 1.26 GFLOP; the backward moves about 9 and
// does about 3.8 GFLOP. At 3.35 TB/s and 989 TFLOP/s (bf16 tensor cores) both
// are memory-bound, at roughly 4 to 8 microseconds.
//
// What this design does about that bound: every activation element is read
// once and written once, straight from the [B, N, X] layout (no transposes),
// the gates never leave the SM (the backward recomputes them instead of
// reading four stored gate tensors), and the weight-gradient reduction writes
// only gz_T once (one extra [N, B, 4H] tensor) instead of per-tile weight
// partials. The products run on CUDA cores from shared memory, so at this
// width the kernels are bound by issue rate, not by bytes; lstm_cell_tc.cu
// runs the same function on the tensor cores.
//
// Determinism: Hopper runs blocks in no order, so the TPU kernel's
// accumulation of dwx/dwh/db across sequential batch tiles becomes a second
// pass. lstm_bwd_act_kernel writes gz_T and per-tile f32 partial sums of gz;
// lstm_bwd_weight_kernel gives one block to each (agent, weight tile), loops
// over the whole batch in a fixed order, and sums the db partials in tile
// order. No float atomics: the gradients are bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 32;                              // batch rows per block
constexpr int kLanes = 64;                           // threads along H
constexpr int kRowGroups = kThreads / kLanes;        // 4
constexpr int kRowsPerThread = kBT / kRowGroups;     // 8
constexpr int kKMax = 256;                           // max F + H
constexpr int kMT = 32;                              // weight columns per staged tile
constexpr int kWK = 32;                              // dW rows (over F + H) per block
constexpr int kWM = 64;                              // dW columns (over 4H) per block
constexpr int kRB = 32;                              // batch rows per staged chunk

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

// Stage the block's rows of x [kBT][F] and h_in [kBT][H] as f32 in shared
// memory. With `mask`, h is the raw carry and is masked here (forward);
// without, it is the stored h_in residual (backward).
template <typename T>
__device__ void stage_inputs(const T* __restrict__ x, const T* __restrict__ h,
                             const float* ms, bool mask, float* xs, float* hs,
                             int b0, int rows, int N, int n, int F, int H) {
  for (int i = threadIdx.x; i < kBT * F; i += kThreads) {
    const int r = i / F, k = i - r * F;
    xs[i] = r < rows ? to_f(x[act_off(b0 + r, N, n, F, k)]) : 0.f;
  }
  for (int i = threadIdx.x; i < kBT * H; i += kThreads) {
    const int r = i / H, k = i - r * H;
    float v = 0.f;
    if (r < rows) {
      v = to_f(h[act_off(b0 + r, N, n, H, k)]);
      if (mask) v = rd<T>(v * ms[r]);
    }
    hs[i] = v;
  }
}

// z[row, g*H + j] for the thread's kRowsPerThread rows (ty + 4 r) and the
// four gates g of hidden unit j: x @ wx[n] + h_in @ wh[n] + b[n] in f32.
template <typename T>
__device__ __forceinline__ void gate_preacts(const float* xs, const float* hs,
                                             const T* __restrict__ wx_n,
                                             const T* __restrict__ wh_n,
                                             const T* __restrict__ b_n, int F, int H,
                                             int j, int ty,
                                             float acc[kRowsPerThread][4]) {
  const int G = 4 * H;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
  for (int k = 0; k < F; ++k) {
    const T* w = wx_n + (size_t)k * G + j;
    const float w0 = to_f(w[0]), w1 = to_f(w[H]), w2 = to_f(w[2 * H]), w3 = to_f(w[3 * H]);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float v = xs[(ty + r * kRowGroups) * F + k];
      acc[r][0] += v * w0;
      acc[r][1] += v * w1;
      acc[r][2] += v * w2;
      acc[r][3] += v * w3;
    }
  }
  for (int k = 0; k < H; ++k) {
    const T* w = wh_n + (size_t)k * G + j;
    const float w0 = to_f(w[0]), w1 = to_f(w[H]), w2 = to_f(w[2 * H]), w3 = to_f(w[3 * H]);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float v = hs[(ty + r * kRowGroups) * H + k];
      acc[r][0] += v * w0;
      acc[r][1] += v * w1;
      acc[r][2] += v * w2;
      acc[r][3] += v * w3;
    }
  }
  const float b0 = to_f(b_n[j]), b1 = to_f(b_n[H + j]), b2 = to_f(b_n[2 * H + j]),
              b3 = to_f(b_n[3 * H + j]);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    acc[r][0] += b0;
    acc[r][1] += b1;
    acc[r][2] += b2;
    acc[r][3] += b3;
  }
}

// Forward. Grid (N, ceil(B / kBT)): one block per (agent, batch tile).
// Shared memory: xs [kBT][F], hs [kBT][H], ms [kBT] (f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ c,
                const T* __restrict__ done, const T* __restrict__ wx,
                const T* __restrict__ wh, const T* __restrict__ b, T* __restrict__ h_out,
                T* __restrict__ c_out, T* __restrict__ hin_out, T* __restrict__ cin_out,
                int B, int N, int F, int H) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* hs = xs + kBT * F;
  float* ms = hs + kBT * H;
  const int n = blockIdx.x;
  const int b0 = blockIdx.y * kBT;
  const int rows = min(kBT, B - b0);
  const int G = 4 * H;
  const int tid = threadIdx.x;
  for (int r = tid; r < kBT; r += kThreads)
    ms[r] = r < rows ? rd<T>(1.f - to_f(done[b0 + r])) : 0.f;
  __syncthreads();
  stage_inputs<T>(x, h, ms, true, xs, hs, b0, rows, N, n, F, H);
  if (hin_out != nullptr) {  // masked carry residuals for the backward
    for (int i = tid; i < rows * H; i += kThreads) {
      const int r = i / H, k = i - r * H;
      const size_t off = act_off(b0 + r, N, n, H, k);
      hin_out[off] = from_f<T>(to_f(h[off]) * ms[r]);
      cin_out[off] = from_f<T>(to_f(c[off]) * ms[r]);
    }
  }
  __syncthreads();
  const int tx = tid % kLanes, ty = tid / kLanes;
  float acc[kRowsPerThread][4];
  for (int j = tx; j < H; j += kLanes) {
    gate_preacts<T>(xs, hs, wx + (size_t)n * F * G, wh + (size_t)n * H * G, b + (size_t)n * G,
                    F, H, j, ty, acc);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int rr = ty + r * kRowGroups;
      if (rr >= rows) continue;
      const size_t off = act_off(b0 + rr, N, n, H, j);
      const float ig = sigmoid_f(acc[r][0]), fg = sigmoid_f(acc[r][1]);
      const float og = sigmoid_f(acc[r][2]), ug = tanhf(acc[r][3]);
      const float c_in = rd<T>(to_f(c[off]) * ms[rr]);
      const float c_new = fg * c_in + ig * ug;
      const float h_new = og * tanhf(c_new);
      h_out[off] = from_f<T>(h_new);
      c_out[off] = from_f<T>(c_new);
    }
  }
}

// Backward, pass 1. Grid (N, ceil(B / kBT)). Recomputes the gates, writes
// dc_prev, gz_T [N][B][4H] and the f32 per-tile partial sums of gz
// [N][tiles][4H], then dx and dh from gz_T and the weights, which are staged
// in tiles of kMT columns.
// Shared memory: gzs [kBT][4H], ms [kBT], then a region used first for
// xs [kBT][F] + hs [kBT][H] and then for the weight tile [F + H][kMT + 1].
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_act_kernel(const T* __restrict__ x, const T* __restrict__ h_in,
                    const T* __restrict__ c_in, const T* __restrict__ c_new,
                    const T* __restrict__ dc_new, const T* __restrict__ dh_new,
                    const T* __restrict__ done, const T* __restrict__ wx,
                    const T* __restrict__ wh, const T* __restrict__ b, T* __restrict__ dx,
                    T* __restrict__ dh, T* __restrict__ dc_prev, T* __restrict__ gz_out,
                    float* __restrict__ db_part, int B, int N, int F, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int K = F + H;
  float* gzs = smem;
  float* ms = gzs + kBT * G;
  float* xs = ms + kBT;
  float* hs = xs + kBT * F;
  float* ws = xs;  // reused after the gate pass
  const int n = blockIdx.x;
  const int b0 = blockIdx.y * kBT;
  const int rows = min(kBT, B - b0);
  const int tid = threadIdx.x;
  for (int r = tid; r < kBT; r += kThreads)
    ms[r] = r < rows ? rd<T>(1.f - to_f(done[b0 + r])) : 0.f;
  for (int i = tid; i < kBT * G; i += kThreads) gzs[i] = 0.f;
  stage_inputs<T>(x, h_in, ms, false, xs, hs, b0, rows, N, n, F, H);
  __syncthreads();

  const int tx = tid % kLanes, ty = tid / kLanes;
  float acc[kRowsPerThread][4];
  for (int j = tx; j < H; j += kLanes) {
    gate_preacts<T>(xs, hs, wx + (size_t)n * F * G, wh + (size_t)n * H * G, b + (size_t)n * G,
                    F, H, j, ty, acc);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int rr = ty + r * kRowGroups;
      if (rr >= rows) continue;
      const size_t off = act_off(b0 + rr, N, n, H, j);
      const float ig = sigmoid_f(acc[r][0]), fg = sigmoid_f(acc[r][1]);
      const float og = sigmoid_f(acc[r][2]), ug = tanhf(acc[r][3]);
      const float tc = tanhf(to_f(c_new[off]));
      const float dhn = to_f(dh_new[off]);
      const float dc = dhn * og * (1.f - tc * tc) + to_f(dc_new[off]);
      const float cin = to_f(c_in[off]);
      gzs[rr * G + j] = (dc * ug) * ig * (1.f - ig);
      gzs[rr * G + H + j] = (dc * cin) * fg * (1.f - fg);
      gzs[rr * G + 2 * H + j] = (dhn * tc) * og * (1.f - og);
      gzs[rr * G + 3 * H + j] = (dc * ig) * (1.f - ug * ug);
      dc_prev[off] = from_f<T>((dc * fg) * ms[rr]);
    }
  }
  __syncthreads();

  for (int m = tid; m < G; m += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += gzs[r * G + m];
    db_part[((size_t)n * gridDim.y + blockIdx.y) * G + m] = s;
  }
  for (int i = tid; i < rows * G; i += kThreads) {
    const int r = i / G, m = i - r * G;
    gz_out[((size_t)n * B + b0 + r) * G + m] = from_f<T>(gzs[i]);
  }

  // [dx | dh][row, k] = sum_m gz_T[row, m] * [wx | wh][n, k, m]
  constexpr int kKK = kKMax / 32;
  const int lane = tid % 32, grp = tid / 32;  // 8 groups of 4 rows: grp + 8 q
  float acc2[4][kKK];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) acc2[q][kk] = 0.f;
  for (int m0 = 0; m0 < G; m0 += kMT) {
    const int mt = min(kMT, G - m0);
    __syncthreads();  // the previous tile (or xs/hs) is no longer read
    for (int i = tid; i < K * kMT; i += kThreads) {
      const int k = i / kMT, mm = i - k * kMT;
      float v = 0.f;
      if (mm < mt)
        v = to_f(k < F ? wx[((size_t)n * F + k) * G + m0 + mm]
                       : wh[((size_t)n * H + (k - F)) * G + m0 + mm]);
      ws[k * (kMT + 1) + mm] = v;
    }
    __syncthreads();
    for (int mm = 0; mm < mt; ++mm) {
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = rd<T>(gzs[(grp + 8 * q) * G + m0 + mm]);
#pragma unroll
      for (int kk = 0; kk < kKK; ++kk) {
        const int k = lane + 32 * kk;
        if (k < K) {
          const float w = ws[k * (kMT + 1) + mm];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc2[q][kk] += g[q] * w;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int rr = grp + 8 * q;
    if (rr >= rows) continue;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
      const int k = lane + 32 * kk;
      if (k >= K) continue;
      if (k < F)
        dx[act_off(b0 + rr, N, n, F, k)] = from_f<T>(acc2[q][kk]);
      else
        dh[act_off(b0 + rr, N, n, H, k - F)] = from_f<T>(acc2[q][kk] * ms[rr]);
    }
  }
}

// Backward, pass 2. Grid (N, ceil((F + H) / kWK), ceil(4H / kWM)): one block
// per (agent, weight tile), looping over the whole batch in order.
// [dwx; dwh][n, k, m] = sum_b [x | h_in][b, n, k] * gz_T[n, b, m] in f32;
// blocks of the first k tile also sum the db partials in tile order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ h_in,
                       const T* __restrict__ gz, const float* __restrict__ db_part,
                       int n_tiles, float* __restrict__ dwx, float* __restrict__ dwh,
                       float* __restrict__ db, int B, int N, int F, int H) {
  __shared__ float as[kRB][kWK + 1];
  __shared__ float gs[kRB][kWM];
  const int n = blockIdx.x, k0 = blockIdx.y * kWK, m0 = blockIdx.z * kWM;
  const int G = 4 * H, K = F + H;
  const int tid = threadIdx.x, tx = tid % kWM, ty = tid / kWM;  // ty in [0, 4)
  constexpr int kQ = kWK / (kThreads / kWM);                     // 8 rows of dW
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.f;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    __syncthreads();
    for (int i = tid; i < kRB * kWK; i += kThreads) {
      const int r = i / kWK, kk = i - r * kWK;
      const int k = k0 + kk, bb = r0 + r;
      float v = 0.f;
      if (bb < B && k < K)
        v = to_f(k < F ? x[act_off(bb, N, n, F, k)] : h_in[act_off(bb, N, n, H, k - F)]);
      as[r][kk] = v;
    }
    for (int i = tid; i < kRB * kWM; i += kThreads) {
      const int r = i / kWM, mm = i - r * kWM;
      const int m = m0 + mm, bb = r0 + r;
      gs[r][mm] = (bb < B && m < G) ? to_f(gz[((size_t)n * B + bb) * G + m]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRB; ++r) {
      const float g = gs[r][tx];
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[q] += as[r][ty + 4 * q] * g;
    }
  }
  const int m = m0 + tx;
  if (m >= G) return;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int k = k0 + ty + 4 * q;
    if (k >= K) continue;
    if (k < F)
      dwx[((size_t)n * F + k) * G + m] = acc[q];
    else
      dwh[((size_t)n * H + (k - F)) * G + m] = acc[q];
  }
  if (blockIdx.y == 0 && ty == 0) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += db_part[((size_t)n * n_tiles + t) * G + m];
    db[(size_t)n * G + m] = s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const void* x, const void* h, const void* c, const void* done, const void* wx,
               const void* wh, const void* b, void* h_out, void* c_out, void* hin_out,
               void* cin_out, int B, int N, int F, int H, cudaStream_t stream) {
  const dim3 grid(N, (B + kBT - 1) / kBT);
  const size_t smem = (size_t)(kBT * F + kBT * H + kBT) * sizeof(float);
  cudaError_t err = allow_smem(lstm_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)h, (const T*)c, (const T*)done, (const T*)wx, (const T*)wh,
      (const T*)b, (T*)h_out, (T*)c_out, (T*)hin_out, (T*)cin_out, B, N, F, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* h_in, const void* c_in, const void* c_new,
               const void* dc_new, const void* dh_new, const void* done, const void* wx,
               const void* wh, const void* b, void* dx, void* dh, void* dc_prev, void* gz,
               void* db_part, void* dwx, void* dwh, void* db, int B, int N, int F, int H,
               cudaStream_t stream) {
  const int G = 4 * H, K = F + H;
  const int n_tiles = (B + kBT - 1) / kBT;
  const int region = kBT * K > K * (kMT + 1) ? kBT * K : K * (kMT + 1);
  const size_t smem = (size_t)(kBT * G + kBT + region) * sizeof(float);
  cudaError_t err = allow_smem(lstm_bwd_act_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_act_kernel<T><<<dim3(N, n_tiles), kThreads, smem, stream>>>(
      (const T*)x, (const T*)h_in, (const T*)c_in, (const T*)c_new, (const T*)dc_new,
      (const T*)dh_new, (const T*)done, (const T*)wx, (const T*)wh, (const T*)b, (T*)dx,
      (T*)dh, (T*)dc_prev, (T*)gz, (float*)db_part, B, N, F, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(N, (K + kWK - 1) / kWK, (G + kWM - 1) / kWM);
  lstm_bwd_weight_kernel<T><<<grid2, kThreads, 0, stream>>>(
      (const T*)x, (const T*)h_in, (const T*)gz, (const float*)db_part, n_tiles, (float*)dwx,
      (float*)dwh, (float*)db, B, N, F, H);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. Every
// pointer is a device pointer to a contiguous tensor; hin_out/cin_out may be
// null (no residuals). Returns the cudaError_t of the launches.

extern "C" int lstm_cell_fwd(int dtype, const void* x, const void* h, const void* c,
                             const void* done, const void* wx, const void* wh, const void* b,
                             void* h_out, void* c_out, void* hin_out, void* cin_out, int B,
                             int N, int F, int H, void* stream) {
  if (F + H > kKMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd<float>(x, h, c, done, wx, wh, b, h_out, c_out, hin_out, cin_out, B, N, F,
                             H, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, h, c, done, wx, wh, b, h_out, c_out, hin_out, cin_out, B,
                                     N, F, H, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_cell_bwd(int dtype, const void* x, const void* h_in, const void* c_in,
                             const void* c_new, const void* dc_new, const void* dh_new,
                             const void* done, const void* wx, const void* wh, const void* b,
                             void* dx, void* dh, void* dc_prev, void* gz, void* db_part,
                             void* dwx, void* dwh, void* db, int B, int N, int F, int H,
                             void* stream) {
  if (F + H > kKMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(x, h_in, c_in, c_new, dc_new, dh_new, done, wx, wh, b, dx, dh,
                             dc_prev, gz, db_part, dwx, dwh, db, B, N, F, H, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, h_in, c_in, c_new, dc_new, dh_new, done, wx, wh, b, dx,
                                     dh, dc_prev, gz, db_part, dwx, dwh, db, B, N, F, H, s);
  return (int)cudaErrorInvalidValue;
}
