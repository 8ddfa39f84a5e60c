// The message head of the MA2C_DIAL policy over packed neighbour lists,
// forward and backward, for NVIDIA Hopper (sm_90a):
//
//   m[b,n] = m_b (h[b,n] W[n]) + bias[n]            m_b = 1 - done[b]
//
// for each agent n, h [B, N, H] the LSTM carry, W [N, H, D] and bias [N, D]
// the head's weights (W_dial, b_dial), and its gradient from dm [B, N, D]:
//
//   dh[b,n]  = m_b (dm[b,n] W[n]^T)
//   dW[n]    = sum_b (m_b h[b,n])^T dm[b,n]        dbias[n] = sum_b dm[b,n]
//
// The messages go to the comm-embedding kernels (comm_embed.cu), which read
// them as [B, N, D] rows; dm is the gradient those kernels write there.
//
// No TPU kernel is replaced: the JAX package writes the head as an einsum and
// a bias add (deeprl_network_tpu/models/policies.py `_embed`) and XLA fuses
// them. As PyTorch ops on the card each forward call was the done mask (a
// cast, a subtract, a broadcast multiply), a bmm over agents whose output is
// [agent, row] major, a bias add over that layout and a copy of the result
// into [B, N, D] rows; each backward, two bmms with their permute copies, the
// bias gradient's reduction over B and the mask's backward: about 16 kernels
// a control step, 20 us a forward call for a product whose bytes bound it at
// 1.5 us.
//
// Rounding points (the plain twins in ops/dial_head.py keep them): the
// operands in the compute dtype; the product accumulated in f32, masked and
// the bias added in f32, rounded once. (1 - done) is 0 or 1, so masking the
// row or the product gives the same number. The gradients accumulate in f32
// and are rounded once to the compute dtype: dh is multiplied by m_b in f32
// before its rounding, dW's operand m_b h is rounded in the compute dtype, as
// the forward's masked row would be.
//
// Bound on the H100 at the flagship shape (B=768, N=25, H=D=64, bf16): the
// forward reads h, done, W and the bias and writes m, 5.1 MB and 0.16 GFLOP:
// 1.5 us, by bytes. The backward reads h, done, W and dm and writes dh, dW and
// the bias gradient, 7.8 MB and 0.31 GFLOP: 2.3 us. The design:
//   * `tc` (bf16, H and D multiples of 16, at most 64): four-warp blocks, each
//     warp 16 rows of a 64-row tile, mma.sync.m16n8k16 with f32 accumulation
//     and operands by ldmatrix from rows padded by 16 bytes (free of bank
//     conflicts). The rows of h are read straight from the carry [B, N, H],
//     16 bytes a cp.async, and W[n] is staged beside them.
//   * Forward: a block per (agent, tile), 300 at the flagship, about two an
//     SM, all in flight at once; each moves 24 KB (W[n] from L2 after the
//     first of its agent's 12 blocks). The mask and the bias are applied in
//     the epilogue, the result rounded once and staged in shared memory, and
//     each warp stores its 16 rows with 16-byte stores into [B, N, D].
//   * Backward: one launch. The sums over B are split over a thread-block
//     cluster of C blocks per agent (C = 6 at the flagship: two tiles a
//     block, 150 blocks); each block streams its tiles two stages deep,
//     writes dh of each tile (16-byte stores, staged as the forward's) and
//     keeps its partial dW in registers and its partial bias gradient in one
//     thread a column. Then the cluster adds its C partial sums through
//     distributed shared memory, every element by one thread in rank order,
//     and rounds once.
//   * `general` (float32, and every other width): one thread per output, f32
//     FMAs on the CUDA cores in a fixed order (TF32 never enters); the
//     backward's threads take dh, dW or the bias gradient by their index.
//   * Determinism: no atomics. Every output is summed by one warp or thread in
//     a fixed order (mma's own, the tiles', the ranks'), so two backward calls
//     are bitwise equal and a CUDA graph's replay equals the eager call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kBT = 64;         // rows of a tile
constexpr int kPad = 8;         // bf16 elements (16 bytes) of padding per smem row
constexpr int kThreads = 128;   // four warps, warp w rows [16 w, 16 w + 16) of a tile
constexpr int kMaxCluster = 8;  // the portable cluster size

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `bytes` (0 or 16) global -> shared, bypassing L1; the rest of the 16 is zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) @ b (16x8, col), bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix.x4 addresses, lane l giving row (l & 7) of 8x8 matrix (l >> 3), over
// a smem image s with `pitch` elements a row.
// A (16 x 16) stored [m][k]: registers are the fragments a0..a3.
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int pitch, int m0, int k0,
                                              int lane) {
  return s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + k0 + (lane >> 4) * 8;
}
// A (16 x 16) stored [k][m], read with .trans.
__device__ __forceinline__ const bf16* at_addr(const bf16* s, int pitch, int m0, int k0,
                                               int lane) {
  return s + (k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0 + ((lane >> 3) & 1) * 8;
}
// B (16 x 16: two n-tiles) stored [k][n], read with .trans: registers {0,1}
// are n-tile 0, {2,3} n-tile 1.
__device__ __forceinline__ const bf16* bt_addr(const bf16* s, int pitch, int k0, int n0,
                                               int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 + (lane >> 4) * 8;
}
// B (16 x 16: two n-tiles) stored [n][k].
__device__ __forceinline__ const bf16* b_addr(const bf16* s, int pitch, int k0, int n0,
                                              int lane) {
  return s + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 + ((lane >> 3) & 1) * 8;
}

// acc (kNT16 pairs of n-tiles) += a @ the [k0, k0 + 16) rows of a B image
template <int kNT16, bool kTrans>
__device__ __forceinline__ void mma_k16(float (&acc)[2 * kNT16][4], const uint32_t (&a)[4],
                                        const bf16* s, int pitch, int k0, int lane) {
#pragma unroll
  for (int p = 0; p < kNT16; ++p) {
    uint32_t r[4];
    if (kTrans)
      ldsm_x4_t(r, bt_addr(s, pitch, k0, 16 * p, lane));
    else
      ldsm_x4(r, b_addr(s, pitch, k0, 16 * p, lane));
    mma_bf16(acc[2 * p], a, r[0], r[1]);
    mma_bf16(acc[2 * p + 1], a, r[2], r[3]);
  }
}

template <int kNT> __device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int q = 0; q < kNT; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
// v rounded to T and back
template <typename T> __device__ __forceinline__ float rd(float v) { return to_f(from_f<T>(v)); }

// the done mask of a row in the compute dtype, T(1 - done); 1 without done
template <typename T> __device__ __forceinline__ float row_mask(const T* done, int b) {
  return done != nullptr ? rd<T>(1.f - to_f(done[b])) : 1.f;
}

__device__ __forceinline__ uint32_t mul_bf162(uint32_t v, bf162 m) {
  bf162 r = __hmul2(*reinterpret_cast<bf162*>(&v), m);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ bf162 mask_pair(const bf16* ds, int r) {
  return __floats2bfloat162_rn(rd<bf16>(1.f - __bfloat162float(ds[r])),
                               rd<bf16>(1.f - __bfloat162float(ds[r + 1])));
}

// rows [b0, b0 + 64) of agent n of a [B, N, W] tensor into smem rows of pitch
// W + kPad, 16 bytes a request by the block's threads; rows at and past B
// become zeros (their request reads nothing)
template <int W>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int n, int N, int b0,
                                          int B, int t) {
  constexpr int cpr = W / 8;
#pragma unroll
  for (int q = t; q < kBT * cpr; q += kThreads) {
    const int r = q / cpr, v = q % cpr;
    const bool ok = b0 + r < B;
    cp_async16(dst + r * (W + kPad) + v * 8,
               ok ? src + ((size_t)(b0 + r) * N + n) * W + v * 8 : src, ok ? 16 : 0);
  }
}

// W[n] [H][D] into smem rows of pitch D + kPad
template <int H, int D>
__device__ __forceinline__ void copy_weights(bf16* ws, const bf16* w, int n, int t) {
  constexpr int cpr = D / 8;
  const bf16* wn = w + (size_t)n * H * D;
#pragma unroll
  for (int q = t; q < H * cpr; q += kThreads) {
    const int r = q / cpr, v = q % cpr;
    cp_async16(ws + r * (D + kPad) + v * 8, wn + r * D + v * 8, 16);
  }
}

// a warp's 16 staged rows [r0, r0 + 16) of width W (pitch W + kPad) to rows
// b0 + r0 + i of agent n of a [B, N, W] tensor, 16 bytes a store
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* ys, int n, int N, int b0,
                                           int r0, int B, int lane) {
  constexpr int cpr = W / 8;
#pragma unroll
  for (int q = lane; q < 16 * cpr; q += 32) {
    const int r = r0 + q / cpr, v = q % cpr;
    if (b0 + r < B)
      *reinterpret_cast<uint4*>(dst + ((size_t)(b0 + r) * N + n) * W + v * 8) =
          *reinterpret_cast<const uint4*>(ys + r * (W + kPad) + v * 8);
  }
}

// ------------------------------------------------------------ tc forward
//
// Grid (N, tiles): block (n, i) takes rows [64 i, 64 i + 64) of agent n.
// Static shared memory: ws [H][D+8] (W[n]), xs [64][H+8] (the rows of h),
// ys [64][D+8] (m, for the 16-byte stores).
template <int kKT, int kNT16>   // H / 16 and D / 16
__global__ void __launch_bounds__(kThreads)
dial_head_tc_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ done,
                        const bf16* __restrict__ w, const bf16* __restrict__ bias,
                        bf16* __restrict__ m, int B, int N) {
  constexpr int H = 16 * kKT, D = 16 * kNT16, HP = H + kPad, DP = D + kPad;
  __shared__ __align__(16) bf16 ws[H * DP];
  __shared__ __align__(16) bf16 xs[kBT * HP];
  __shared__ __align__(16) bf16 ys[kBT * DP];
  const int n = blockIdx.x, b0 = blockIdx.y * kBT, t = threadIdx.x;
  const int lane = t & 31, r0 = (t >> 5) * 16, g = lane >> 2, c2 = 2 * (lane & 3);
  copy_weights<H, D>(ws, w, n, t);
  copy_rows<H>(xs, h, n, N, b0, B, t);
  cp_async_commit();
  // while the copies fly: this lane's rows' masks and columns' bias
  const int ra = b0 + r0 + g, rb = ra + 8;
  const float mk0 = ra < B ? row_mask(done, ra) : 0.f;
  const float mk1 = rb < B ? row_mask(done, rb) : 0.f;
  float2 bv[2 * kNT16];
#pragma unroll
  for (int q = 0; q < 2 * kNT16; ++q)
    bv[q] = __bfloat1622float2(
        *reinterpret_cast<const bf162*>(bias + (size_t)n * D + 8 * q + c2));
  cp_async_wait<0>();
  __syncthreads();
  float acc[2 * kNT16][4];
  zero(acc);
#pragma unroll
  for (int k = 0; k < kKT; ++k) {
    uint32_t a[4];
    ldsm_x4(a, a_addr(xs, HP, r0, 16 * k, lane));
    mma_k16<kNT16, true>(acc, a, ws, DP, 16 * k, lane);
  }
  // m = mask acc + bias, rounded once, into ys: rows r0 + g (+ 8), columns
  // 8 q + c2 (+ 1); the warp then stores its own 16 rows
#pragma unroll
  for (int q = 0; q < 2 * kNT16; ++q) {
    *reinterpret_cast<bf162*>(ys + (r0 + g) * DP + 8 * q + c2) =
        __floats2bfloat162_rn(acc[q][0] * mk0 + bv[q].x, acc[q][1] * mk0 + bv[q].y);
    *reinterpret_cast<bf162*>(ys + (r0 + g + 8) * DP + 8 * q + c2) =
        __floats2bfloat162_rn(acc[q][2] * mk1 + bv[q].x, acc[q][3] * mk1 + bv[q].y);
  }
  __syncwarp();
  store_rows<D>(m, ys, n, N, b0, r0, B, lane);
}

// ------------------------------------------------------------ tc backward
//
// Grid (C, N), cluster (C, 1, 1): block (r, n) takes the tiles r, r + C, ...
// of agent n, two stages deep. For each tile: dW's partial sum (warp w rows
// [16 w, 16 w + 16) of W's H, while 16 w < H) and the bias gradient's (thread
// t < D column t) grow in registers; then dh = dm W^T of the tile, masked,
// rounded and staged in the tile's stage of h, and stored. Then the blocks
// leave their partial sums in shared memory `red` [H D + D] f32 (over the
// stages), and after the cluster's barrier thread t of rank r adds, for the
// float4 pieces r * 128 + t, r * 128 + t + 128 C, ..., the C ranks' pieces in
// rank order and stores them rounded; a second barrier keeps `red` alive
// until read.
__host__ __device__ constexpr int bwd_stage_bytes(int H, int D) {
  return kBT * (H + kPad) * 2 + kBT * (D + kPad) * 2 + kBT * 2;
}
__host__ __device__ constexpr int bwd_smem_bytes(int H, int D) {
  // W[n], then two stages, or `red` over them
  return H * (D + kPad) * 2 +
         (2 * bwd_stage_bytes(H, D) > (H * D + D) * 4 ? 2 * bwd_stage_bytes(H, D)
                                                       : (H * D + D) * 4);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// four floats of block `rank`'s shared memory at the address of p in this
// one's (not volatile: between the cluster's barriers the loads may all be in
// flight at once)
__device__ __forceinline__ float4 ld_peer4(const float* p, uint32_t rank) {
  uint32_t a;
  float4 v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  asm("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(a));
  return v;
}

template <int kKT, int kNT16>   // H / 16 and D / 16
__global__ void __launch_bounds__(kThreads)
dial_head_tc_bwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ done,
                        const bf16* __restrict__ w, const bf16* __restrict__ dm,
                        bf16* __restrict__ dh, bf16* __restrict__ dw, bf16* __restrict__ db,
                        int B, int N) {
  constexpr int H = 16 * kKT, D = 16 * kNT16, HP = H + kPad, DP = D + kPad;
  constexpr int kStage = bwd_stage_bytes(H, D);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  unsigned char* stages = smem + H * DP * 2;
  auto xs_of = [&](int s) { return reinterpret_cast<bf16*>(stages + s * kStage); };
  auto gs_of = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * kStage + kBT * HP * 2);
  };
  auto ds_of = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * kStage + kBT * HP * 2 + kBT * DP * 2);
  };
  const int C = gridDim.x, rank = blockIdx.x, n = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, r0 = warp * 16, g = lane >> 2, c2 = 2 * (lane & 3);
  const int tiles = (B + kBT - 1) / kBT;
  const int mine = rank < tiles ? (tiles - rank + C - 1) / C : 0;   // this block's tiles
  auto load = [&](int i, int s) {   // tile rank + i C into stage s
    const int b0 = (rank + i * C) * kBT;
    copy_rows<H>(xs_of(s), h, n, N, b0, B, t);
    copy_rows<D>(gs_of(s), dm, n, N, b0, B, t);
    if (done != nullptr && t < kBT / 8) {
      const int left = B - (b0 + t * 8);
      const int bytes = left <= 0 ? 0 : (left >= 8 ? 16 : left * 2);
      cp_async16(ds_of(s) + t * 8, bytes ? done + b0 + t * 8 : done, bytes);
    }
    cp_async_commit();
  };
  copy_weights<H, D>(ws, w, n, t);
  if (mine > 0) load(0, 0);
  else cp_async_commit();
  float acc_w[2 * kNT16][4];   // dW rows [r0, r0 + 16) (warps with r0 < H)
  zero(acc_w);
  float acc_b = 0.f;           // the bias gradient of column t (t < D)
  for (int i = 0; i < mine; ++i) {
    const int s = i & 1, b0 = (rank + i * C) * kBT;
    __syncthreads();   // the last tile's dh is stored from stage s ^ 1: reload it
    if (i + 1 < mine) {
      load(i + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bf16* xs = xs_of(s);
    const bf16 *gs = gs_of(s), *ds = ds_of(s);
    // dW[r0 + .., :] += (mask h)^T dm over the tile's 64 rows
    if (r0 < H) {
#pragma unroll
      for (int k = 0; k < kBT / 16; ++k) {
        uint32_t a[4];
        ldsm_x4_t(a, at_addr(xs, HP, r0, 16 * k, lane));
        if (done != nullptr) {
          const bf162 ma = mask_pair(ds, 16 * k + c2), mb = mask_pair(ds, 16 * k + 8 + c2);
          a[0] = mul_bf162(a[0], ma);
          a[1] = mul_bf162(a[1], ma);
          a[2] = mul_bf162(a[2], mb);
          a[3] = mul_bf162(a[3], mb);
        }
        mma_k16<kNT16, true>(acc_w, a, gs, DP, 16 * k, lane);
      }
    }
    if (t < D) {
#pragma unroll 8
      for (int r = 0; r < kBT; ++r) acc_b += __bfloat162float(gs[r * DP + t]);
    }
    // dh of rows [r0, r0 + 16) = dm W^T
    float acc_h[2 * kKT][4];
    zero(acc_h);
#pragma unroll
    for (int k = 0; k < kNT16; ++k) {
      uint32_t a[4];
      ldsm_x4(a, a_addr(gs, DP, r0, 16 * k, lane));
      mma_k16<kKT, false>(acc_h, a, ws, DP, 16 * k, lane);
    }
    const bool masked = done != nullptr;
    const float mk0 = masked ? rd<bf16>(1.f - __bfloat162float(ds[r0 + g])) : 1.f;
    const float mk1 = masked ? rd<bf16>(1.f - __bfloat162float(ds[r0 + g + 8])) : 1.f;
    __syncthreads();   // every warp has read the rows of h: stage dh over them
#pragma unroll
    for (int q = 0; q < 2 * kKT; ++q) {
      *reinterpret_cast<bf162*>(xs + (r0 + g) * HP + 8 * q + c2) =
          __floats2bfloat162_rn(acc_h[q][0] * mk0, acc_h[q][1] * mk0);
      *reinterpret_cast<bf162*>(xs + (r0 + g + 8) * HP + 8 * q + c2) =
          __floats2bfloat162_rn(acc_h[q][2] * mk1, acc_h[q][3] * mk1);
    }
    __syncwarp();
    store_rows<H>(dh, xs, n, N, b0, r0, B, lane);
  }
  // the cluster's sum of the partial dW and bias gradients
  cp_async_wait<0>();
  __syncthreads();   // the stages are read: `red` goes over them
  float* red = reinterpret_cast<float*>(stages);
  if (r0 < H) {
#pragma unroll
    for (int q = 0; q < 2 * kNT16; ++q) {
      *reinterpret_cast<float2*>(red + (r0 + g) * D + 8 * q + c2) =
          make_float2(acc_w[q][0], acc_w[q][1]);
      *reinterpret_cast<float2*>(red + (r0 + g + 8) * D + 8 * q + c2) =
          make_float2(acc_w[q][2], acc_w[q][3]);
    }
  }
  if (t < D) red[H * D + t] = acc_b;
  cluster_sync();
  constexpr int kPieces = (H * D + D) / 4;
  for (int p = rank * kThreads + t; p < kPieces; p += C * kThreads) {
    float4 part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C) part[q] = ld_peer4(red + 4 * p, q);
    float4 sum = part[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < C) sum.x += part[q].x, sum.y += part[q].y, sum.z += part[q].z, sum.w += part[q].w;
    const int e = 4 * p;
    bf16* dst = e < H * D ? dw + (size_t)n * H * D + e : db + (size_t)n * D + (e - H * D);
    const bf162 lo = __floats2bfloat162_rn(sum.x, sum.y), hi = __floats2bfloat162_rn(sum.z, sum.w);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = v;
  }
  cluster_sync();
}

// ------------------------------------------------------------ general
//
// One thread per output, f32 FMAs in a fixed order.

template <typename T>
__global__ void __launch_bounds__(256)
dial_head_fwd_kernel(const T* __restrict__ h, const T* __restrict__ done,
                     const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ m,
                     int B, int N, int H, int D) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * N * D) return;
  const int d = (int)(i % D), n = (int)((i / D) % N), b = (int)(i / ((size_t)D * N));
  const T* hr = h + ((size_t)b * N + n) * H;
  const T* wc = w + (size_t)n * H * D + d;
  float acc = 0.f;
  for (int j = 0; j < H; ++j) acc = fmaf(to_f(hr[j]), to_f(wc[(size_t)j * D]), acc);
  m[i] = from_f<T>(acc * row_mask(done, b) + to_f(bias[(size_t)n * D + d]));
}

// threads [0, B N H): dh[b, n, j]; then N H D threads: dW[n, j, d]; then N D
// threads: the bias gradient [n, d]
template <typename T>
__global__ void __launch_bounds__(256)
dial_head_bwd_kernel(const T* __restrict__ h, const T* __restrict__ done,
                     const T* __restrict__ w, const T* __restrict__ dm, T* __restrict__ dh,
                     T* __restrict__ dw, T* __restrict__ db, int B, int N, int H, int D) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_dh = (size_t)B * N * H, n_dw = (size_t)N * H * D;
  if (i < n_dh) {
    const int j = (int)(i % H), n = (int)((i / H) % N), b = (int)(i / ((size_t)H * N));
    const T* g = dm + ((size_t)b * N + n) * D;
    const T* wr = w + ((size_t)n * H + j) * D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(to_f(g[d]), to_f(wr[d]), acc);
    dh[i] = from_f<T>(acc * row_mask(done, b));
    return;
  }
  if (i < n_dh + n_dw) {
    const size_t q = i - n_dh;
    const int d = (int)(q % D), j = (int)((q / D) % H), n = (int)(q / ((size_t)D * H));
    float acc = 0.f;
    for (int b = 0; b < B; ++b)
      acc = fmaf(rd<T>(to_f(h[((size_t)b * N + n) * H + j]) * row_mask(done, b)),
                 to_f(dm[((size_t)b * N + n) * D + d]), acc);
    dw[q] = from_f<T>(acc);
    return;
  }
  const size_t q = i - n_dh - n_dw;
  if (q >= (size_t)N * D) return;
  const int d = (int)(q % D), n = (int)(q / D);
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += to_f(dm[((size_t)b * N + n) * D + d]);
  db[q] = from_f<T>(acc);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the instantiation for (H / 16, D / 16), each in 1..4
template <template <int, int> class Pick, int kKT = 4, typename Launch>
int dispatch(int kt, int nt, Launch launch) {
  if (kt != kKT) {
    if constexpr (kKT > 1) return dispatch<Pick, kKT - 1>(kt, nt, launch);
    return (int)cudaErrorInvalidValue;
  }
  switch (nt) {
    case 1: return launch(Pick<kKT, 1>::kernel());
    case 2: return launch(Pick<kKT, 2>::kernel());
    case 3: return launch(Pick<kKT, 3>::kernel());
    case 4: return launch(Pick<kKT, 4>::kernel());
    default: return (int)cudaErrorInvalidValue;
  }
}
template <int kKT, int kNT16> struct PickFwd {
  static auto kernel() { return dial_head_tc_fwd_kernel<kKT, kNT16>; }
};
template <int kKT, int kNT16> struct PickBwd {
  static auto kernel() { return dial_head_tc_bwd_kernel<kKT, kNT16>; }
};

bool tc_shape_ok(int H, int D) {
  return H % 16 == 0 && D % 16 == 0 && H > 0 && D > 0 && H <= 64 && D <= 64;
}

unsigned blocks_for(size_t threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

}  // namespace

// C interface, loaded with ctypes. Every pointer is a device pointer to a
// contiguous tensor of the dtype `code` gives (0 float32, 1 bfloat16): h
// [B, N, H], done [B] or null (no mask), w [N, H, D], bias [N, D], m and dm
// [B, N, D], dh [B, N, H], dw [N, H, D], db [N, D]. `variant` 0 is `general`,
// 1 `tc` (bfloat16, H and D multiples of 16 at most 64, every pointer 16-byte
// aligned). `cluster`: blocks per agent of the tc backward, 1 to 8 and at most
// ceil(B / 64). Returns the cudaError_t of the launch.

extern "C" int dial_head_fwd(int code, int variant, const void* h, const void* done,
                             const void* w, const void* bias, void* m, int B, int N, int H,
                             int D, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    const int tiles = (B + kBT - 1) / kBT;
    if (code != 1 || !tc_shape_ok(H, D) || tiles > 65535) return (int)cudaErrorInvalidValue;
    return dispatch<PickFwd>(H / 16, D / 16, [&](auto kernel) {
      kernel<<<dim3(N, tiles), kThreads, 0, st>>>((const bf16*)h, (const bf16*)done,
                                                  (const bf16*)w, (const bf16*)bias, (bf16*)m,
                                                  B, N);
      return (int)cudaGetLastError();
    });
  }
  const unsigned grid = blocks_for((size_t)B * N * D, 256);
  if (code == 0)
    dial_head_fwd_kernel<float><<<grid, 256, 0, st>>>((const float*)h, (const float*)done,
                                                      (const float*)w, (const float*)bias,
                                                      (float*)m, B, N, H, D);
  else
    dial_head_fwd_kernel<bf16><<<grid, 256, 0, st>>>((const bf16*)h, (const bf16*)done,
                                                     (const bf16*)w, (const bf16*)bias,
                                                     (bf16*)m, B, N, H, D);
  return (int)cudaGetLastError();
}

extern "C" int dial_head_bwd(int code, int variant, const void* h, const void* done,
                             const void* w, const void* dm, void* dh, void* dw, void* db,
                             int B, int N, int H, int D, int cluster, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    const int tiles = (B + kBT - 1) / kBT;
    if (code != 1 || !tc_shape_ok(H, D) || cluster < 1 || cluster > kMaxCluster ||
        cluster > tiles || N > 65535)
      return (int)cudaErrorInvalidValue;
    const size_t bytes = bwd_smem_bytes(H, D);
    return dispatch<PickBwd>(H / 16, D / 16, [&](auto kernel) {
      cudaError_t err = allow_smem(kernel, bytes);
      if (err != cudaSuccess) return (int)err;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(cluster, N);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = bytes;
      cfg.stream = st;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)h, (const bf16*)done, (const bf16*)w,
                               (const bf16*)dm, (bf16*)dh, (bf16*)dw, (bf16*)db, B, N);
      if (err != cudaSuccess) return (int)err;
      return (int)cudaGetLastError();
    });
  }
  const size_t threads = (size_t)B * N * H + (size_t)N * H * D + (size_t)N * D;
  const unsigned grid = blocks_for(threads, 256);
  if (code == 0)
    dial_head_bwd_kernel<float><<<grid, 256, 0, st>>>(
        (const float*)h, (const float*)done, (const float*)w, (const float*)dm, (float*)dh,
        (float*)dw, (float*)db, B, N, H, D);
  else
    dial_head_bwd_kernel<bf16><<<grid, 256, 0, st>>>(
        (const bf16*)h, (const bf16*)done, (const bf16*)w, (const bf16*)dm, (bf16*)dh,
        (bf16*)dw, (bf16*)db, B, N, H, D);
  return (int)cudaGetLastError();
}
