// The NeurComm input embedding of the multi-agent policy with packed
// neighbour lists, forward and backward, for NVIDIA Hopper (sm_90a):
//
//   e[b,n] = relu(obs[b,n] W_obs[n] + b_obs[n]
//                 + sum_k fp[b, nbr[n,k]] W_fp[n,k]
//                 + sum_k (m_b h[b, nbr[n,k]]) W_msg[n,k])      m_b = 1 - done[b]
//
// over the valid slots k of agent n (nbr[n,k] >= 0), and its gradient
//
//   g          = de * (e > 0)
//   dW_obs[n]  = sum_b obs[b,n]^T g[b,n]        db_obs[n] = sum_b g[b,n]
//   dW_fp[n,k] = sum_b fp[b,nbr]^T g[b,n]       dW_msg[n,k] = sum_b (m_b h[b,nbr])^T g[b,n]
//   dh[b,m]    = m_b sum_{(n,k) in rev[m]} g[b,n] W_msg[n,k]^T
//
// where rev[m] lists the (receiver, slot) pairs that read sender m.
//
// The MA2C_DIAL policy's call is the same sum with no fingerprint term (A = 0:
// no fp, no W_fp) and a sender feature that is its message, not a hidden state:
//
//   e[b,n] = relu(obs[b,n] W_obs[n] + b_obs[n] + sum_k x[b, nbr[n,k]] W_msg[n,k])
//
// with x = m = ((1 - done) h) W_dial + b_dial formed by the caller, so that no
// row is masked here (done is null: m_b = 1) and the gradient dx goes back to
// h and the head through the caller's autograd.
//
// No TPU kernel is replaced: the JAX package writes this as einsums over a
// gathered [B, N, K, X] tensor (deeprl_network_tpu/models/policies.py
// `_embed`) and XLA fuses the chain. The PyTorch ops of the same chain ran
// about 12 kernels forward and 16 backward a control step, materialised the
// gathered [B, N, K, 64] tensor and scattered its gradient back through a
// sorting index_put. Here the gather is read inside the per-agent product and
// the backward is a plain, deterministic sum over the reverse neighbour list.
//
// Rounding points (the plain twin in ops/comm_embed.py keeps them): the
// operands in the compute dtype, m_b h rounded once in it, one f32-accumulated
// product over the concatenated terms [obs | 1 | fp slots | h slots] (the bias
// is the weight row of the constant column), e rounded once, then relu. The
// gradients accumulate in f32 and are rounded once to the compute dtype; dh is
// multiplied by m_b in f32 before its rounding.
//
// Bound on the H100 at the flagship shape (B=768, N=25, S=12, A=5, K=4,
// F=H=64, bf16): the forward reads h, obs, fp, done and the packed weights and
// writes e, 6.5 MB and 0.57 GFLOP over the valid slots: 1.9 us, by bytes. The
// backward reads the same inputs, e and de and writes dh and the weight
// gradients, 12.2 MB: 3.6 us. Both are bound by bytes by two orders of
// magnitude over the tensor cores' rate. DIAL's call at the same shape (no
// fingerprints, no done flags) moves 6.1 and 11.8 MB: 1.8 and 3.5 us. What
// stands between a kernel and that bound is the gather: every row of h is read
// by its K receivers' blocks, and a block's copies go through one SM, which
// takes in 8 to 12 bytes a cycle when every SM asks at once. So the design moves each byte as few times as
// it can and keeps every SM's copies in flight:
//   * One launch forward, two backward (g = de * (e > 0) formed once, then one
//     kernel whose blocks take one of two roles), in place of the gather, the
//     einsums, the adds and relu and their backward.
//   * The gather happens in the copy into shared memory: a block owns one agent
//     (forward, weight gradients) or one sender (dh) and fetches its neighbours'
//     rows of h straight from [B, N, H] with 16-byte cp.async; nothing gathered
//     goes back to device memory, and nothing is scattered.
//   * Warp-specialised blocks, as lstm_cell_tc.cu's: warps that issue copies
//     wait there while the memory system is busy, so eight warps only compute,
//     loader warps only copy (four forward, two backward, with addresses that
//     step by a constant: a loader that divides to find its next address
//     issues at half the rate), and in the forward two drainer warps stage the
//     weights first and then store e, 16 bytes a store. mbarriers hand each
//     stage from role to role; cp.async arrive on them by themselves.
//   * `tc` (bf16, F and H multiples of 16, at most 64): mma.sync.m16n8k16 with
//     f32 accumulation, operands by ldmatrix from rows padded by 16 bytes (free
//     of bank conflicts), the next k step's fragments asked for before the
//     current step's mma. A forward block stages its agent's packed weights
//     [W_obs; b_obs; W_fp; 0; W_msg] once (an empty slot's rows as zeros,
//     unread) and walks 64-row batch tiles three stages deep; the obs and
//     fingerprint columns (rows of 24 and 10 bytes, no 16-byte pieces) are
//     copied element by element. The done mask multiplies the h fragments in
//     bf16, so there is no masking pass.
//   * Weight gradients: a pair of blocks per (agent, column block) - the
//     [obs | 1 | fp] columns, or one slot's h - each walks half the batch in
//     64-row chunks and keeps its [<= 64 x F] sum in registers; the pair is a
//     thread-block cluster, and each adds the other's partial sums from its
//     shared memory (no second pass, no f32 partials in device memory). dh: a
//     block per (sender, batch split) stages the W_msg blocks of its receivers
//     once and streams (tile, receiver) chunks of g, summing over receivers in
//     registers.
//   * `general` (float32, and every other width): one thread per output, f32
//     FMAs on the CUDA cores in a fixed order (TF32 never enters); the
//     backward's threads take dh or the weight gradients by their index.
//   * Determinism: no atomics. Every output is summed by one warp or thread in
//     a fixed order (mma's own, the k loop, batch order, receiver order, and
//     the pair's two halves, whose sum is the same in either order), so two
//     backward calls are bitwise equal and a CUDA graph's replay equals the
//     eager call.
//
// Reached at the flagship shape (NVIDIA H100 80GB HBM3, 700 W; replays of a
// CUDA graph of 20 launches, warm L2), in the order tried, forward / backward
// in us: four-warp blocks that load, multiply and store in turn, two stages
// 33.3 / 77.5; warp-specialised blocks (two loader warps) 34.0 / 59.0;
// division-free copy addresses 27.7 / 48.3; four loader warps forward, one
// instantiation per column count 21.5 / 42.9; the weights staged by the
// drainers, the weight gradients split over a cluster pair 20.2 / 49.5; g
// formed once by its own kernel, three stages 20.1 / 37.7 (34.3 with 6 dh
// blocks a sender). clock64() marks in one block: a forward block's loaders
// issue a tile's 32 KB of h in about 3,500 cycles, its obs and fingerprint
// columns in 1,800 more, and the eight warps multiply a tile in 2,800; the
// [obs | 1 | fp] weight-gradient pairs are the backward's longest blocks
// (about 30,000 cycles: their element-by-element copies).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kBT = 64;        // batch rows per tile or chunk
constexpr int kPad = 8;        // bf16 elements (16 bytes) of padding per smem row
constexpr int kMaxW = 64;      // largest F, H and padded [obs | 1 | fp] width of `tc`

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
// a smem image s with `pitch` elements a row (as in lstm_cell_tc.cu).
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
// v rounded to T and back
template <typename T> __device__ __forceinline__ float rd(float v) { return to_f(from_f<T>(v)); }

// the done mask of a row in the compute dtype: T(1 - done)
template <typename T> __device__ __forceinline__ float row_mask(const T* done, int b) {
  return rd<T>(1.f - to_f(done[b]));
}

__device__ __forceinline__ uint32_t mul_bf162(uint32_t v, bf162 m) {
  bf162 r = __hmul2(*reinterpret_cast<bf162*>(&v), m);
  return *reinterpret_cast<uint32_t*>(&r);
}

// (e > 0 ? de : 0) for the two bf16 halves of a register: a bf16 is > 0 when
// its bits lie in [0x0001, 0x7f80] (positive, subnormal to +inf).
__device__ __forceinline__ uint32_t relu_grad(uint32_t de, uint32_t e) {
  uint32_t keep = 0;
  if ((e & 0xffffu) - 1u < 0x7f80u) keep |= 0xffffu;
  if ((e >> 16) - 1u < 0x7f80u) keep |= 0xffff0000u;
  return de & keep;
}

__device__ __forceinline__ bf162 mask_pair(const bf16* ds, int r) {
  return __floats2bfloat162_rn(rd<bf16>(1.f - __bfloat162float(ds[r])),
                               rd<bf16>(1.f - __bfloat162float(ds[r + 1])));
}

// ---- mbarriers in shared memory hand the stages from role to role (as in
// lstm_cell_tc.cu): a loader's cp.async arrive on one by themselves when they
// have landed, so that a loader never waits for its own loads. Use number u
// of a barrier is waited for with parity u & 1.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive once all cp.async that this thread has issued so far have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
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
// a warp's arrival: its lanes' shared-memory accesses first, then one count
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ---- the two blocks of a cluster: their barrier (exited threads need not
// arrive), and two floats of the other block's shared memory
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float2 ld_peer2(const float* p, uint32_t rank) {
  uint32_t a;
  float2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a)
               : "memory");
  return v;
}

// A block: eight warps compute (warp w owns rows [16 (w & 3), +16) of a
// 64-row tile and the column half w >> 2 of its output), some warps only
// load, and in the forward two more only store. A thread that issues copies
// waits at the issue for as long as the memory system is busy, and a warp
// that waits there cannot compute, so no computing warp issues a copy.
constexpr int kCompute = 256;
constexpr int kFwdLoaders = 128;
constexpr int kBwdLoaders = 64;   // two backward blocks share an SM (96 registers a thread)
constexpr int kDrainers = 64;
constexpr int kFwdThreads = kCompute + kFwdLoaders + kDrainers;
constexpr int kBwdThreads = kCompute + kBwdLoaders;
constexpr int kFwdStages = 3;   // every tile of a flagship block in flight at once
constexpr int kBwdStages = 3;   // two blocks an SM still fit (109 KB each at the flagship)

// ---- copies issued by the kNL loaders (lt: the thread's index among them)

// `rows` rows (64 unless given) of `width` bf16 (a multiple of 8, at most 64)
// from device memory, row r at src + (b0 + r) * pitch, to smem rows of pitch
// `dpitch`, 16 bytes a request; rows at and past B become zeros (their request
// reads nothing at `any`). Loader lt copies piece lt % cpr of rows lt / cpr,
// + kNL / cpr, ...: its addresses step by a constant, so that no division or
// chain of dependent arithmetic stands between two requests (a loader that
// computes its addresses issues too slowly to keep the memory system busy).
template <int kNL>
__device__ __forceinline__ void copy_box(bf16* dst, int dpitch, const bf16* src, size_t pitch,
                                         int width, int b0, int B, int lt, const bf16* any,
                                         int rows = kBT) {
  const int cpr = width / 8, par = kNL / cpr;
  if (lt >= par * cpr) return;
  int r = lt / cpr;
  const int v = lt - r * cpr;
  bf16* d = dst + r * dpitch + v * 8;
  const bf16* g = src + (size_t)(b0 + r) * pitch + v * 8;
  const int dstep = par * dpitch;
  const size_t gstep = (size_t)par * pitch;
  for (; r < rows; r += par, d += dstep, g += gstep) {
    const bool ok = b0 + r < B;
    cp_async16(d, ok ? g : any, ok ? 16 : 0);
  }
}

// 64 rows of zeros, `width` bf16 wide, through the same requests (nothing is
// read at `any`), so that they land with the stage's other copies
template <int kNL>
__device__ __forceinline__ void zero_box(bf16* dst, int dpitch, int width, int lt,
                                         const bf16* any) {
  const int cpr = width / 8, par = kNL / cpr;
  if (lt >= par * cpr) return;
  const int v = lt % cpr;
  for (int r = lt / cpr; r < kBT; r += par) cp_async16(dst + r * dpitch + v * 8, any, 0);
}

// the raw done flags of rows [b0, b0 + 64) (zeros past B)
__device__ __forceinline__ void copy_done(bf16* ds, const bf16* done, int b0, int B, int lt,
                                          const bf16* any) {
  if (lt < kBT / 8) {
    const int left = B - (b0 + lt * 8);
    const int bytes = left <= 0 ? 0 : (left >= 8 ? 16 : left * 2);
    cp_async16(ds + lt * 8, bytes ? done + b0 + lt * 8 : any, bytes);
  }
}

// The [obs | 1 | fp slots | 0] columns [0, Pp) of a tile, element by element
// (their rows are 2S and 2A bytes, no whole 16-byte pieces): loader lt owns
// column lt % 64 (if < Pp) and rows (lt / 64) + kNL / 64 * i, 32 loads in
// flight at once.
template <int kNL>
__device__ __forceinline__ void copy_small(bf16* as, int AP, const bf16* obs, const bf16* fp,
                                           const int* nb, int n, int N, int S, int A, int K,
                                           int Pp, int b0, int B, int lt) {
  constexpr int kRows = kBT * 64 / kNL;   // rows a loader copies
  const int col = lt & 63, r0 = lt >> 6;
  if (col >= Pp) return;
  const int P = S + 1 + K * A;
  const bf16* src = nullptr;
  size_t pitch = 0;
  float one = 0.f;
  if (col < S) {
    src = obs + (size_t)n * S + col;
    pitch = (size_t)N * S;
  } else if (col == S) {
    one = 1.f;
  } else if (col < P) {
    const int q = col - S - 1, m = nb[q / A];
    if (m >= 0) {
      src = fp + (size_t)m * A + q % A;
      pitch = (size_t)N * A;
    }
  }
  const bf16 zero = __float2bfloat16(0.f), cst = __float2bfloat16(one);
  constexpr int kStep = kNL / 64, kBatch = kRows < 32 ? kRows : 32;
  const bf16* g = src + (size_t)(b0 + r0) * pitch;
  const size_t gstep = (size_t)kStep * pitch;
#pragma unroll 1
  for (int i0 = 0; i0 < kRows; i0 += kBatch) {
    bf16 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i, g += gstep) {
      const bool ok = b0 + r0 + kStep * (i0 + i) < B;
      v[i] = !ok ? zero : (src != nullptr ? *g : cst);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) as[(r0 + kStep * (i0 + i)) * AP + col] = v[i];
  }
}

// B fragments (k = rows [k0, k0+16), n = kNT n-tiles from n0) of a [k][n]
// image, read with .trans: pairs by x4, a last odd one by x2.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
template <int kNT>
__device__ __forceinline__ void frags_kn(uint32_t (&b)[kNT][2], const bf16* s, int pitch, int k0,
                                         int n0, int lane) {
#pragma unroll
  for (int p = 0; 2 * p < kNT; ++p) {
    if (2 * p + 1 < kNT) {
      uint32_t r[4];
      ldsm_x4_t(r, bt_addr(s, pitch, k0, n0 + 16 * p, lane));
      b[2 * p][0] = r[0], b[2 * p][1] = r[1], b[2 * p + 1][0] = r[2], b[2 * p + 1][1] = r[3];
    } else {
      ldsm_x2_t(b[2 * p], bt_addr(s, pitch, k0, n0 + 16 * p, lane));
    }
  }
}
// the same from an [n][k] image (no .trans)
template <int kNT>
__device__ __forceinline__ void frags_nk(uint32_t (&b)[kNT][2], const bf16* s, int pitch, int k0,
                                         int n0, int lane) {
#pragma unroll
  for (int p = 0; 2 * p < kNT; ++p) {
    if (2 * p + 1 < kNT) {
      uint32_t r[4];
      ldsm_x4(r, b_addr(s, pitch, k0, n0 + 16 * p, lane));
      b[2 * p][0] = r[0], b[2 * p][1] = r[1], b[2 * p + 1][0] = r[2], b[2 * p + 1][1] = r[3];
    } else {
      ldsm_x2(b[2 * p], b_addr(s, pitch, k0, n0 + 16 * p, lane));
    }
  }
}
template <int kNT>
__device__ __forceinline__ void mma_row(float (&acc)[kNT][4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[kNT][2]) {
#pragma unroll
  for (int q = 0; q < kNT; ++q) mma_bf16(acc[q], a, b[q][0], b[q][1]);
}
template <int kNT> __device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int q = 0; q < kNT; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
}

// ------------------------------------------------------------ tc forward
//
// Grid (N, splits): block (n, s) takes the 64-row tiles s, s + splits, ... of
// agent n; its tile i lives in stage i % 3. Shared memory: ws [D][F+8] (the
// packed weights, staged once); three stages of { a [64][D+8] (the gathered
// operand), es [64][F+8] (e, for the drainers), ds [64] (raw done) }; the
// neighbour list; the mbarriers. The loaders copy a tile's h slots and done
// flags by cp.async and its obs and fingerprint columns element by element;
// the computing warps run the product with the next k step's fragments loaded
// before the current step's mma, round, relu and leave e in `es`; the
// drainers store it, 16 bytes a store.
struct FwdBars {
  uint64_t full[kFwdStages];   // tile landed: each loader's copies and its stores
  uint64_t done[kFwdStages];   // e of the tile is in es: the eight computing warps
  uint64_t free_[kFwdStages];  // es is stored: the stage can be loaded again
  uint64_t wfull;              // the weights landed
};

struct FwdLayout {
  int P, Pp, D, WP, AP, EP;
  size_t ws, stage0, a, es, ds, stage_bytes, nb, bars, total;
  __host__ __device__ FwdLayout(int S, int A, int K, int F, int H) {
    P = S + 1 + K * A;
    Pp = (P + 15) / 16 * 16;
    D = Pp + K * H;
    WP = F + kPad;
    AP = D + kPad;
    EP = F + kPad;
    ws = 0;
    stage0 = (size_t)D * WP * 2;
    a = 0;
    es = (size_t)kBT * AP * 2;
    ds = es + (size_t)kBT * EP * 2;
    stage_bytes = ds + kBT * 2;
    nb = stage0 + kFwdStages * stage_bytes;
    bars = (nb + (size_t)K * 4 + 15) / 16 * 16;
    total = bars + sizeof(FwdBars);
  }
};

template <int kNT>   // F / 16: the n-tiles of a warp's column half
__global__ void __launch_bounds__(kFwdThreads, 1)
comm_embed_tc_fwd_kernel(const bf16* __restrict__ obs, const bf16* __restrict__ fp,
                         const bf16* __restrict__ h, const bf16* __restrict__ done,
                         const bf16* __restrict__ w_obs, const bf16* __restrict__ b_obs,
                         const bf16* __restrict__ w_fp, const bf16* __restrict__ w_msg,
                         const int* __restrict__ nbr, bf16* __restrict__ e, int B, int N, int S,
                         int A, int K, int F, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L(S, A, K, F, H);
  const int n = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tiles = (B + kBT - 1) / kBT, step = gridDim.y;
  const int m_tiles = (tiles - (int)blockIdx.y + step - 1) / step;   // this block's tiles
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  int* nb = reinterpret_cast<int*>(smem + L.nb);
  FwdBars* bars = reinterpret_cast<FwdBars*>(smem + L.bars);
  auto stage = [&](int s, size_t off) {
    return reinterpret_cast<bf16*>(smem + L.stage0 + s * L.stage_bytes + off);
  };
  if (t < K) nb[t] = nbr[(size_t)n * K + t];
  if (t == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&bars->full[s], 2 * kFwdLoaders);
      mbar_init(&bars->done[s], kCompute / 32);
      mbar_init(&bars->free_[s], kDrainers);
    }
    mbar_init(&bars->wfull, kDrainers);
    mbar_init_fence();
  }
  __syncthreads();

  if (t >= kCompute + kFwdLoaders) {
    // ---- drainers: first the weights (idle otherwise until the first tile
    // is computed), then e of each tile to device memory
    const int dt = t - kCompute - kFwdLoaders, cpr = F / 8;
    // rows [0, S) W_obs, S b_obs, [S+1, P) W_fp (K x A rows), [P, Pp) zeros,
    // [Pp, D) W_msg (K x H rows; an empty slot's are zeros, not read)
    copy_box<kDrainers>(ws, L.WP, w_obs + (size_t)n * S * F, F, F, 0, S, dt, w_obs, S);
    copy_box<kDrainers>(ws + S * L.WP, L.WP, b_obs + (size_t)n * F, F, F, 0, 1, dt, w_obs, 1);
    if (A > 0)
      copy_box<kDrainers>(ws + (S + 1) * L.WP, L.WP, w_fp + (size_t)n * K * A * F, F, F, 0,
                          K * A, dt, w_obs, K * A);
    copy_box<kDrainers>(ws + L.P * L.WP, L.WP, w_obs, F, F, 0, 0, dt, w_obs, L.Pp - L.P);
    for (int k = 0; k < K; ++k)
      copy_box<kDrainers>(ws + (L.Pp + k * H) * L.WP, L.WP, w_msg + ((size_t)n * K + k) * H * F, F,
                          F, 0, nb[k] >= 0 ? H : 0, dt, w_obs, H);
    mbar_arrive_on_copies(&bars->wfull);
    for (int i = 0; i < m_tiles; ++i) {
      const int s = i % kFwdStages, b0 = ((int)blockIdx.y + i * step) * kBT;
      mbar_wait(&bars->done[s], (i / kFwdStages) & 1);
      const bf16* es = stage(s, L.es);
      for (int q = dt; q < kBT * cpr; q += kDrainers) {
        const int r = q / cpr, v = q - r * cpr;
        if (b0 + r < B)
          *reinterpret_cast<uint4*>(e + ((size_t)(b0 + r) * N + n) * F + v * 8) =
              *reinterpret_cast<const uint4*>(es + r * L.EP + v * 8);
      }
      mbar_arrive(&bars->free_[s]);
    }
    return;
  }
  if (t >= kCompute) {
    // ---- loaders: each tile as soon as its stage is free
    const int lt = t - kCompute;
    for (int i = 0; i < m_tiles; ++i) {
      const int s = i % kFwdStages, b0 = ((int)blockIdx.y + i * step) * kBT;
      if (i >= kFwdStages) mbar_wait(&bars->free_[s], (i / kFwdStages - 1) & 1);
      bf16* as = stage(s, L.a);
      for (int k = 0; k < K; ++k) {
        if (nb[k] >= 0)
          copy_box<kFwdLoaders>(as + L.Pp + k * H, L.AP, h + (size_t)nb[k] * H, (size_t)N * H,
                                H, b0, B, lt, h);
        else
          zero_box<kFwdLoaders>(as + L.Pp + k * H, L.AP, H, lt, h);
      }
      if (done != nullptr) copy_done(stage(s, L.ds), done, b0, B, lt, h);
      mbar_arrive_on_copies(&bars->full[s]);
      copy_small<kFwdLoaders>(as, L.AP, obs, fp, nb, n, N, S, A, K, L.Pp, b0, B, lt);
      mbar_arrive(&bars->full[s]);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }

  // ---- computing warps (the h slots masked by done where it is given)
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * (F / 2), g = lane >> 2;
  const bool masked = done != nullptr;
  mbar_wait(&bars->wfull, 0);
  for (int i = 0; i < m_tiles; ++i) {
    const int s = i % kFwdStages;
    mbar_wait(&bars->full[s], (i / kFwdStages) & 1);
    const bf16* as = stage(s, L.a);
    const bf16* ds = stage(s, L.ds);
    bf162 mk0, mk1;
    if (masked) {
      mk0 = __float2bfloat162_rn(rd<bf16>(1.f - __bfloat162float(ds[r0 + g])));
      mk1 = __float2bfloat162_rn(rd<bf16>(1.f - __bfloat162float(ds[r0 + g + 8])));
    }
    float acc[kNT][4];
    zero(acc);
    // the fragments of step k0 + 16 are asked for before step k0's mma
    uint32_t a0[4], a1[4], b0f[kNT][2], b1f[kNT][2];
    auto load = [&](uint32_t (&a)[4], uint32_t (&b)[kNT][2], int k0) {
      ldsm_x4(a, a_addr(as, L.AP, r0, k0, lane));
      frags_kn<kNT>(b, ws, L.WP, k0, c0, lane);
    };
    auto use = [&](uint32_t (&a)[4], const uint32_t (&b)[kNT][2], int k0) {
      if (masked && k0 >= L.Pp) {
        a[0] = mul_bf162(a[0], mk0);
        a[1] = mul_bf162(a[1], mk1);
        a[2] = mul_bf162(a[2], mk0);
        a[3] = mul_bf162(a[3], mk1);
      }
      mma_row<kNT>(acc, a, b);
    };
    load(a0, b0f, 0);
#pragma unroll 1
    for (int k0 = 0; k0 < L.D; k0 += 32) {
      if (k0 + 16 < L.D) load(a1, b1f, k0 + 16);
      use(a0, b0f, k0);
      if (k0 + 16 >= L.D) break;
      if (k0 + 32 < L.D) load(a0, b0f, k0 + 32);
      use(a1, b1f, k0 + 16);
    }
    // e = relu(bf16(acc)) into es: rows r0 + g (+ 8), columns c0 + 8 q + 2 (lane & 3)
    bf16* es = stage(s, L.es);
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x = rd<bf16>(acc[q][2 * hf]), y = rd<bf16>(acc[q][2 * hf + 1]);
        *reinterpret_cast<bf162*>(es + (r0 + g + hf * 8) * L.EP + c0 + q * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(x < 0.f ? 0.f : x, y < 0.f ? 0.f : y);
      }
    }
    warp_arrive(&bars->done[s], lane);
  }
}

// ------------------------------------------------------------ tc backward
//
// First g = de * (e > 0), once (`comm_embed_tc_relu_grad_kernel`, 16 bytes a
// thread): the weight blocks read an agent's g once for each of its 1 + K
// column blocks and the dh blocks a receiver's once for each of its senders,
// so that reading de and e there instead would move twice the bytes.
__global__ void __launch_bounds__(256)
comm_embed_tc_relu_grad_kernel(const bf16* __restrict__ e, const bf16* __restrict__ de,
                               bf16* __restrict__ g, size_t n8) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  uint4 d = reinterpret_cast<const uint4*>(de)[i];
  const uint4 v = reinterpret_cast<const uint4*>(e)[i];
  d.x = relu_grad(d.x, v.x), d.y = relu_grad(d.y, v.y);
  d.z = relu_grad(d.z, v.z), d.w = relu_grad(d.w, v.w);
  reinterpret_cast<uint4*>(g)[i] = d;
}


//
// One launch, 1-D grid, two roles by block index:
//   [0, N (1 + K)): weight gradients of agent n = x / (1 + K), column block
//     j = x % (1 + K): j = 0 the [obs | 1 | fp] rows (dW_obs, db_obs, dW_fp),
//     j = k + 1 slot k's h rows (dW_msg[n, k]); it walks the whole batch, one
//     64-row chunk a stage, and keeps its [<= 64 x F] sum in registers;
//   then N x splits blocks of dh: sender m, the tiles s, s + splits, ...; it
//     stages the W_msg blocks of its receivers once and streams (tile,
//     receiver) chunks of de and e, summing over receivers in registers.
// A stage holds de and e [64][F+8] (rows of the agent, or of the receiver),
// the operand x [64][72] (weight blocks only) and the raw done flags.
struct BwdBars {
  uint64_t full[kBwdStages];   // chunk landed: each loader's copies and its stores
  uint64_t free_[kBwdStages];  // chunk used: the eight computing warps
  uint64_t wfull;              // dh: the receivers' W_msg blocks landed
};

struct BwdLayout {
  int P, Pp, GP, XP;
  size_t ws, stage0, g, x, ds, stage_bytes, red, idx, bars, total;
  __host__ __device__ BwdLayout(int S, int A, int K, int F, int H, int R) {
    P = S + 1 + K * A;
    Pp = (P + 15) / 16 * 16;
    GP = F + kPad;
    XP = kMaxW + kPad;
    ws = 0;
    stage0 = (size_t)R * H * GP * 2;
    g = 0;
    x = g + (size_t)kBT * GP * 2;
    ds = x + (size_t)kBT * XP * 2;
    stage_bytes = ds + kBT * 2;
    red = stage0 + kBwdStages * stage_bytes;
    idx = red + (size_t)kBT * kMaxW * 4;
    bars = (idx + (size_t)(K > R ? K : R) * 4 + 15) / 16 * 16;
    total = bars + sizeof(BwdBars);
  }
};

template <int kFT, int kHT>   // F / 16 and H / 16: the n-tiles of a column half
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kBwdThreads, 2)
comm_embed_tc_bwd_kernel(const bf16* __restrict__ obs, const bf16* __restrict__ fp,
                         const bf16* __restrict__ h, const bf16* __restrict__ done,
                         const bf16* __restrict__ w_msg, const int* __restrict__ nbr,
                         const int* __restrict__ rev, const bf16* __restrict__ gr,
                         bf16* __restrict__ dh,
                         bf16* __restrict__ dw_obs, bf16* __restrict__ db_obs,
                         bf16* __restrict__ dw_fp, bf16* __restrict__ dw_msg, int B, int N, int S,
                         int A, int K, int F, int H, int R, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L(S, A, K, F, H, R);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, g = lane >> 2;
  const int tiles = (B + kBT - 1) / kBT, n_wblocks = 2 * N * (1 + K);
  const bool wrole = (int)blockIdx.x < n_wblocks;
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  int* idx = reinterpret_cast<int*>(smem + L.idx);
  BwdBars* bars = reinterpret_cast<BwdBars*>(smem + L.bars);
  auto stage = [&](int s, size_t off) {
    return reinterpret_cast<bf16*>(smem + L.stage0 + s * L.stage_bytes + off);
  };
  // weight blocks: the pair (column block j, agent n), j = 0 first (the
  // longest), each half of the pair half of the batch; dh blocks: sender m,
  // split s0 (a last block past them, there to make the grid even, idles)
  const int pair = blockIdx.x >> 1, half = blockIdx.x & 1;
  const int j = wrole ? pair / N : 0, n = wrole ? pair % N : 0;
  const int m = wrole ? 0 : (blockIdx.x - n_wblocks) / splits;
  const int s0 = wrole ? 0 : (blockIdx.x - n_wblocks) % splits;
  if (!wrole && m >= N) return;
  if (wrole) {
    if (t < K) idx[t] = nbr[(size_t)n * K + t];
  } else if (t < R) {
    idx[t] = rev[(size_t)m * R + t];
  }
  if (t == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&bars->full[s], 2 * kBwdLoaders);
      mbar_init(&bars->free_[s], kCompute / 32);
    }
    mbar_init(&bars->wfull, kBwdLoaders);
    mbar_init_fence();
  }
  __syncthreads();
  const int r0 = (warp & 3) * 16, c0 = warp >> 2, lt = t - kCompute;

  if (wrole) {
    // ---- weight gradients of agent n, column block j
    const int k = j - 1, src_m = j > 0 ? idx[k] : 0;
    const int rows = j == 0 ? L.Pp : H;   // output rows of this block (<= 64)
    if (j > 0 && src_m < 0) {              // an empty slot: no gradient
      bf16* dst = dw_msg + ((size_t)n * K + k) * H * F;
      for (int q = t + half * kBwdThreads; q < H * F; q += 2 * kBwdThreads)
        dst[q] = __float2bfloat16(0.f);
      return;
    }
    // this half's tiles [i0, i1); the pair adds its two sums at the end
    const int i0 = half * ((tiles + 1) / 2), i1 = half ? tiles : (tiles + 1) / 2;
    if (t >= kCompute) {
      for (int i = i0; i < i1; ++i) {
        const int u = i - i0, s = u % kBwdStages, b0 = i * kBT;
        if (u >= kBwdStages) mbar_wait(&bars->free_[s], (u / kBwdStages - 1) & 1);
        copy_box<kBwdLoaders>(stage(s, L.g), L.GP, gr + (size_t)n * F, (size_t)N * F, F, b0, B,
                              lt, gr);
        if (j > 0)
          copy_box<kBwdLoaders>(stage(s, L.x), L.XP, h + (size_t)src_m * H, (size_t)N * H, H, b0,
                                B, lt, gr);
        if (done != nullptr) copy_done(stage(s, L.ds), done, b0, B, lt, gr);
        mbar_arrive_on_copies(&bars->full[s]);
        if (j == 0)
          copy_small<kBwdLoaders>(stage(s, L.x), L.XP, obs, fp, idx, n, N, S, A, K, L.Pp, b0, B,
                                  lt);
        mbar_arrive(&bars->full[s]);
      }
      cp_async_commit();
      cp_async_wait<0>();
      return;
    }
    // computing warps: rows [r0, r0 + 16) of the block's output, columns
    // [c0 F / 2, + F / 2); warps past `rows` only keep the barriers' counts
    const int n0 = c0 * (F / 2);
    const bool mine = r0 < rows, masked = j > 0 && done != nullptr;
    float acc[kFT][4];
    zero(acc);
    for (int u = 0; u < i1 - i0; ++u) {
      const int s = u % kBwdStages;
      mbar_wait(&bars->full[s], (u / kBwdStages) & 1);
      if (mine) {
        const bf16 *xs = stage(s, L.x), *gs = stage(s, L.g), *ds = stage(s, L.ds);
        uint32_t a[2][4], gd[2][kFT][2];
        auto load = [&](int u, int kk) {
          ldsm_x4_t(a[u], at_addr(xs, L.XP, r0, kk, lane));
          frags_kn<kFT>(gd[u], gs, L.GP, kk, n0, lane);
        };
        auto use = [&](int u, int kk) {
          if (masked) {
            const bf162 ma = mask_pair(ds, kk + 2 * (lane & 3));
            const bf162 mb = mask_pair(ds, kk + 8 + 2 * (lane & 3));
            a[u][0] = mul_bf162(a[u][0], ma);
            a[u][1] = mul_bf162(a[u][1], ma);
            a[u][2] = mul_bf162(a[u][2], mb);
            a[u][3] = mul_bf162(a[u][3], mb);
          }
          mma_row<kFT>(acc, a[u], gd[u]);
        };
        load(0, 0);
        load(1, 16);
        use(0, 0);
        load(0, 32);
        use(1, 16);
        load(1, 48);
        use(0, 32);
        use(1, 48);
      }
      warp_arrive(&bars->free_[s], lane);
    }
    if (!mine) return;
    // the pair's sum: each half leaves its partial sums in `red`; after the
    // cluster's barrier, half 0 writes rows r0 + g and half 1 rows r0 + g + 8
    // of its fragments, each as (its own + the other's), which is the same
    // sum in either order; a second barrier keeps `red` alive until read
    float* red = reinterpret_cast<float*>(smem + L.red);
#pragma unroll
    for (int q = 0; q < kFT; ++q)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(red + (r0 + g + hf * 8) * kMaxW + n0 + q * 8 + 2 * (lane & 3)) =
            make_float2(acc[q][2 * hf], acc[q][2 * hf + 1]);
    cluster_sync();
    const int c = r0 + g + half * 8;
    float2 sum[kFT];
#pragma unroll
    for (int q = 0; q < kFT; ++q) {
      const float2 o = ld_peer2(red + c * kMaxW + n0 + q * 8 + 2 * (lane & 3), half ^ 1);
      sum[q] = make_float2((half ? acc[q][2] : acc[q][0]) + o.x,
                           (half ? acc[q][3] : acc[q][1]) + o.y);
    }
    cluster_sync();
    bf16* dst = nullptr;
    if (j > 0) {
      if (c < H) dst = dw_msg + (((size_t)n * K + k) * H + c) * F;
    } else if (c < S) {
      dst = dw_obs + ((size_t)n * S + c) * F;
    } else if (c == S) {
      dst = db_obs + (size_t)n * F;
    } else if (c < L.P) {
      dst = dw_fp + ((size_t)n * K * A + (c - S - 1)) * F;
    }
    if (dst != nullptr) {
#pragma unroll
      for (int q = 0; q < kFT; ++q)
        *reinterpret_cast<bf162*>(dst + n0 + q * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(sum[q].x, sum[q].y);
    }
    return;
  }

  // ---- dh of sender m, tiles s0, s0 + splits, ...
  int Rm = 0;
  while (Rm < R && idx[Rm] >= 0) ++Rm;
  const int my_tiles = s0 < tiles ? (tiles - s0 + splits - 1) / splits : 0;
  if (Rm == 0) {                           // nobody reads m: dh is zero
    for (int i = 0; i < my_tiles; ++i) {
      const int b0 = (s0 + i * splits) * kBT;
      for (int q = t; q < kBT * H; q += kBwdThreads) {
        const int b = b0 + q / H;
        if (b < B) dh[((size_t)b * N + m) * H + q % H] = __float2bfloat16(0.f);
      }
    }
    return;
  }
  const int nq = my_tiles * Rm;
  if (t >= kCompute) {
    // the receivers' W_msg blocks [H][F] (the block idx[r] = receiver * K +
    // slot of w_msg), then the (tile, receiver) chunks
    for (int r = 0; r < Rm; ++r)
      copy_box<kBwdLoaders>(ws + (size_t)r * H * L.GP, L.GP, w_msg + (size_t)idx[r] * H * F, F, F,
                            0, H, lt, w_msg, H);
    mbar_arrive_on_copies(&bars->wfull);
    for (int q = 0; q < nq; ++q) {
      const int s = q % kBwdStages, b0 = (s0 + (q / Rm) * splits) * kBT;
      const int rcv = idx[q % Rm] / K;
      if (q >= kBwdStages) mbar_wait(&bars->free_[s], (q / kBwdStages - 1) & 1);
      copy_box<kBwdLoaders>(stage(s, L.g), L.GP, gr + (size_t)rcv * F, (size_t)N * F, F, b0, B,
                            lt, gr);
      if (done != nullptr) copy_done(stage(s, L.ds), done, b0, B, lt, gr);
      mbar_arrive_on_copies(&bars->full[s]);
      mbar_arrive(&bars->full[s]);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }
  // computing warps: rows [r0, r0 + 16) of a tile, columns [c0 H / 2, + H / 2)
  const int n0 = c0 * (H / 2);
  float acc[kHT][4];
  zero(acc);
  mbar_wait(&bars->wfull, 0);
  for (int q = 0; q < nq; ++q) {
    const int s = q % kBwdStages, r = q % Rm;
    mbar_wait(&bars->full[s], (q / kBwdStages) & 1);
    const bf16* gs = stage(s, L.g);
    const bf16* wr = ws + (size_t)r * H * L.GP;
    uint32_t a[2][4], bw[2][kHT][2];
    auto load = [&](int u, int kf) {
      ldsm_x4(a[u], a_addr(gs, L.GP, r0, kf, lane));
      frags_nk<kHT>(bw[u], wr, L.GP, kf, n0, lane);
    };
    load(0, 0);
#pragma unroll 1
    for (int kf = 0; kf < F; kf += 32) {
      if (kf + 16 < F) load(1, kf + 16);
      mma_row<kHT>(acc, a[0], bw[0]);
      if (kf + 16 >= F) break;
      if (kf + 32 < F) load(0, kf + 32);
      mma_row<kHT>(acc, a[1], bw[1]);
    }
    if (r == Rm - 1) {                     // the tile's last receiver: store dh
      const int b0 = (s0 + (q / Rm) * splits) * kBT;
      const bf16* ds = stage(s, L.ds);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + g + hf * 8, b = b0 + row;
        if (b >= B) continue;
        const float mk = done != nullptr ? rd<bf16>(1.f - __bfloat162float(ds[row])) : 1.f;
#pragma unroll
        for (int c = 0; c < kHT; ++c)
          *reinterpret_cast<bf162*>(dh + ((size_t)b * N + m) * H + n0 + c * 8 + 2 * (lane & 3)) =
              __floats2bfloat162_rn(acc[c][2 * hf] * mk, acc[c][2 * hf + 1] * mk);
      }
      zero(acc);
    }
    warp_arrive(&bars->free_[s], lane);
  }
}

// ------------------------------------------------------------ general
//
// One thread per output, f32 FMAs in the order of the concatenated terms.

template <typename T>
__global__ void __launch_bounds__(256)
comm_embed_fwd_kernel(const T* __restrict__ obs, const T* __restrict__ fp,
                      const T* __restrict__ h, const T* __restrict__ done,
                      const T* __restrict__ w_obs, const T* __restrict__ b_obs,
                      const T* __restrict__ w_fp, const T* __restrict__ w_msg,
                      const int* __restrict__ nbr, T* __restrict__ e, int B, int N, int S, int A,
                      int K, int F, int H) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * N * F) return;
  const int f = (int)(i % F), n = (int)((i / F) % N), b = (int)(i / ((size_t)F * N));
  const size_t bn = (size_t)b * N;
  float acc = 0.f;
  for (int s = 0; s < S; ++s)
    acc = fmaf(to_f(obs[(bn + n) * S + s]), to_f(w_obs[((size_t)n * S + s) * F + f]), acc);
  acc += to_f(b_obs[(size_t)n * F + f]);
  for (int k = 0; k < K; ++k) {
    const int m = nbr[n * K + k];
    if (m < 0) continue;
    for (int a = 0; a < A; ++a)
      acc = fmaf(to_f(fp[(bn + m) * A + a]),
                 to_f(w_fp[(((size_t)n * K + k) * A + a) * F + f]), acc);
  }
  const float mk = done != nullptr ? row_mask(done, b) : 1.f;
  for (int k = 0; k < K; ++k) {
    const int m = nbr[n * K + k];
    if (m < 0) continue;
    for (int j = 0; j < H; ++j)
      acc = fmaf(rd<T>(to_f(h[(bn + m) * H + j]) * mk),
                 to_f(w_msg[(((size_t)n * K + k) * H + j) * F + f]), acc);
  }
  const float v = rd<T>(acc);
  e[i] = from_f<T>(v < 0.f ? 0.f : v);
}

template <typename T>
__device__ __forceinline__ float relu_grad_f(const T* e, const T* de, size_t i) {
  return to_f(e[i]) > 0.f ? to_f(de[i]) : 0.f;
}

// threads [0, B N H): dh[b, m, j]; then N (P + K H) F threads: the weight
// gradient row c of agent n, column f (rows as the forward's terms)
template <typename T>
__global__ void __launch_bounds__(256)
comm_embed_bwd_kernel(const T* __restrict__ obs, const T* __restrict__ fp,
                      const T* __restrict__ h, const T* __restrict__ done,
                      const T* __restrict__ w_msg, const int* __restrict__ nbr,
                      const int* __restrict__ rev, const T* __restrict__ e,
                      const T* __restrict__ de, T* __restrict__ dh, T* __restrict__ dw_obs,
                      T* __restrict__ db_obs, T* __restrict__ dw_fp, T* __restrict__ dw_msg,
                      int B, int N, int S, int A, int K, int F, int H, int R) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_dh = (size_t)B * N * H;
  const int P = S + 1 + K * A;
  if (i < n_dh) {
    const int j = (int)(i % H), m = (int)((i / H) % N), b = (int)(i / ((size_t)H * N));
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      const int v = rev[(size_t)m * R + r];
      if (v < 0) break;
      const int n = v / K;
      const size_t row = ((size_t)b * N + n) * F;
      const T* w = w_msg + ((size_t)v * H + j) * F;
      for (int f = 0; f < F; ++f) acc = fmaf(relu_grad_f(e, de, row + f), to_f(w[f]), acc);
    }
    dh[i] = from_f<T>(done != nullptr ? acc * row_mask(done, b) : acc);
    return;
  }
  const size_t q = i - n_dh;
  const int D = P + K * H;
  if (q >= (size_t)N * D * F) return;
  const int f = (int)(q % F), c = (int)((q / F) % D), n = (int)(q / ((size_t)F * D));
  // the operand of row c at batch row b: obs, the constant, a fingerprint or
  // a masked hidden state of a neighbour (nothing for an empty slot)
  const T* src = nullptr;
  size_t pitch = 0;
  bool one = false, hid = false;
  T* dst;
  if (c < S) {
    src = obs + (size_t)n * S + c, pitch = (size_t)N * S;
    dst = dw_obs + ((size_t)n * S + c) * F;
  } else if (c == S) {
    one = true;
    dst = db_obs + (size_t)n * F;
  } else if (c < P) {
    const int k = (c - S - 1) / A, m = nbr[n * K + k];
    if (m >= 0) src = fp + (size_t)m * A + (c - S - 1) % A, pitch = (size_t)N * A;
    dst = dw_fp + ((size_t)n * K * A + (c - S - 1)) * F;
  } else {
    const int k = (c - P) / H, m = nbr[n * K + k];
    if (m >= 0) src = h + (size_t)m * H + (c - P) % H, pitch = (size_t)N * H;
    hid = true;
    dst = dw_msg + ((size_t)n * K * H + (c - P)) * F;
  }
  float acc = 0.f;
  if (src != nullptr || one) {
    for (int b = 0; b < B; ++b) {
      const float gv = relu_grad_f(e, de, ((size_t)b * N + n) * F + f);
      float x = one ? 1.f : to_f(src[(size_t)b * pitch]);
      if (hid && done != nullptr) x = rd<T>(x * row_mask(done, b));
      acc = fmaf(x, gv, acc);
    }
  }
  dst[f] = from_f<T>(acc);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the backward's instantiation for (F / 16, H / 16), each in 1..4
template <int kFT, typename Launch>
int launch_tc_bwd(int ft, int ht, Launch launch) {
  if (ft != kFT) {
    if constexpr (kFT > 1) return launch_tc_bwd<kFT - 1>(ft, ht, launch);
    return (int)cudaErrorInvalidValue;
  }
  switch (ht) {
    case 1: return launch(comm_embed_tc_bwd_kernel<kFT, 1>);
    case 2: return launch(comm_embed_tc_bwd_kernel<kFT, 2>);
    case 3: return launch(comm_embed_tc_bwd_kernel<kFT, 3>);
    default: return launch(comm_embed_tc_bwd_kernel<kFT, 4>);
  }
}

bool tc_shape_ok(int S, int A, int K, int F, int H) {
  return F % 16 == 0 && H % 16 == 0 && F > 0 && H > 0 && F <= kMaxW && H <= kMaxW &&
         S + 1 + K * A <= kMaxW;
}

unsigned blocks_for(size_t threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

}  // namespace

// C interface, loaded with ctypes. Every pointer is a device pointer to a
// contiguous tensor of the dtype `code` gives (0 float32, 1 bfloat16), but
// `nbr` [N, K] and `rev` [N, R] (int32, -1 marks an empty entry). `done` [B]
// masks the sender feature `h`, and null leaves it unmasked (DIAL's
// message); A = 0 takes no fingerprint term, and `fp`, `w_fp` and `dw_fp`
// null. `variant` 0 is `general`, 1 `tc` (bfloat16 only; h, de, e and the
// weights 16-byte aligned). `splits`: blocks per agent of the
// tc forward, or per sender of the tc dh, at least 1 and at most
// ceil(B / 64). Returns the cudaError_t of the launch.

extern "C" int comm_embed_smem(int which, int S, int A, int K, int F, int H, int R) {
  return which == 0 ? (int)FwdLayout(S, A, K, F, H).total
                    : (int)BwdLayout(S, A, K, F, H, R).total;
}

extern "C" int comm_embed_fwd(int code, int variant, const void* obs, const void* fp,
                              const void* h, const void* done, const void* w_obs,
                              const void* b_obs, const void* w_fp, const void* w_msg,
                              const void* nbr, void* e, int B, int N, int S, int A, int K,
                              int F, int H, int splits, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || A < 0 || K <= 0 || F <= 0 || H <= 0 ||
      (A > 0 && (fp == nullptr || w_fp == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    const int tiles = (B + kBT - 1) / kBT;
    if (code != 1 || !tc_shape_ok(S, A, K, F, H) || splits < 1 || splits > tiles)
      return (int)cudaErrorInvalidValue;
    const FwdLayout L(S, A, K, F, H);
    auto launch = [&](auto kernel) {
      cudaError_t err = allow_smem(kernel, L.total);
      if (err != cudaSuccess) return (int)err;
      kernel<<<dim3(N, splits), kFwdThreads, L.total, st>>>(
          (const bf16*)obs, (const bf16*)fp, (const bf16*)h, (const bf16*)done,
          (const bf16*)w_obs, (const bf16*)b_obs, (const bf16*)w_fp, (const bf16*)w_msg,
          (const int*)nbr, (bf16*)e, B, N, S, A, K, F, H);
      return (int)cudaGetLastError();
    };
    switch (F / 16) {
      case 1: return launch(comm_embed_tc_fwd_kernel<1>);
      case 2: return launch(comm_embed_tc_fwd_kernel<2>);
      case 3: return launch(comm_embed_tc_fwd_kernel<3>);
      default: return launch(comm_embed_tc_fwd_kernel<4>);
    }
  }
  const unsigned grid = blocks_for((size_t)B * N * F, 256);
  if (code == 0)
    comm_embed_fwd_kernel<float><<<grid, 256, 0, st>>>(
        (const float*)obs, (const float*)fp, (const float*)h, (const float*)done,
        (const float*)w_obs, (const float*)b_obs, (const float*)w_fp, (const float*)w_msg,
        (const int*)nbr, (float*)e, B, N, S, A, K, F, H);
  else
    comm_embed_fwd_kernel<bf16><<<grid, 256, 0, st>>>(
        (const bf16*)obs, (const bf16*)fp, (const bf16*)h, (const bf16*)done,
        (const bf16*)w_obs, (const bf16*)b_obs, (const bf16*)w_fp, (const bf16*)w_msg,
        (const int*)nbr, (bf16*)e, B, N, S, A, K, F, H);
  return (int)cudaGetLastError();
}

extern "C" int comm_embed_bwd(int code, int variant, const void* obs, const void* fp,
                              const void* h, const void* done, const void* w_msg,
                              const void* nbr, const void* rev, const void* e, const void* de,
                              void* g, void* dh, void* dw_obs, void* db_obs, void* dw_fp,
                              void* dw_msg, int B, int N, int S, int A, int K, int F, int H, int R,
                              int splits, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || A < 0 || K <= 0 || F <= 0 || H <= 0 || R <= 0 ||
      (A > 0 && (fp == nullptr || dw_fp == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    const int tiles = (B + kBT - 1) / kBT;
    if (code != 1 || !tc_shape_ok(S, A, K, F, H) || splits < 1 || splits > tiles)
      return (int)cudaErrorInvalidValue;
    const BwdLayout L(S, A, K, F, H, R);
    const size_t n8 = (size_t)B * N * F / 8;
    comm_embed_tc_relu_grad_kernel<<<blocks_for(n8, 256), 256, 0, st>>>(
        (const bf16*)e, (const bf16*)de, (bf16*)g, n8);
    auto launch = [&](auto kernel) {
      cudaError_t err = allow_smem(kernel, L.total);
      if (err != cudaSuccess) return (int)err;
      kernel<<<2 * N * (1 + K) + (N * splits + 1) / 2 * 2, kBwdThreads, L.total, st>>>(
          (const bf16*)obs, (const bf16*)fp, (const bf16*)h, (const bf16*)done,
          (const bf16*)w_msg, (const int*)nbr, (const int*)rev, (const bf16*)g, (bf16*)dh,
          (bf16*)dw_obs, (bf16*)db_obs, (bf16*)dw_fp, (bf16*)dw_msg, B, N, S, A, K, F, H, R,
          splits);
      return (int)cudaGetLastError();
    };
    return launch_tc_bwd<4>(F / 16, H / 16, launch);
  }
  const size_t threads = (size_t)B * N * H + (size_t)N * (S + 1 + K * A + K * H) * F;
  const unsigned grid = blocks_for(threads, 256);
  if (code == 0)
    comm_embed_bwd_kernel<float><<<grid, 256, 0, st>>>(
        (const float*)obs, (const float*)fp, (const float*)h, (const float*)done,
        (const float*)w_msg, (const int*)nbr, (const int*)rev, (const float*)e,
        (const float*)de, (float*)dh, (float*)dw_obs, (float*)db_obs, (float*)dw_fp,
        (float*)dw_msg, B, N, S, A, K, F, H, R);
  else
    comm_embed_bwd_kernel<bf16><<<grid, 256, 0, st>>>(
        (const bf16*)obs, (const bf16*)fp, (const bf16*)h, (const bf16*)done,
        (const bf16*)w_msg, (const int*)nbr, (const int*)rev, (const bf16*)e, (const bf16*)de,
        (bf16*)dh, (bf16*)dw_obs, (bf16*)db_obs, (bf16*)dw_fp, (bf16*)dw_msg, B, N, S, A, K, F,
        H, R);
  return (int)cudaGetLastError();
}
