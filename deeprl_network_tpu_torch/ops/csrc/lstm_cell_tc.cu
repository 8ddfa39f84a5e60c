// Fused per-agent LSTM cell for NVIDIA Hopper (sm_90a), bf16 on the tensor
// cores: the forward and the backward of the flagship path.
//
// Replaces the Pallas TPU kernels of deeprl_network_tpu/ops/pallas_lstm.py:
//   lstm_tc_fwd_kernel          <- _fwd_call's inner `kernel` (pallas_lstm.py:52-117)
//   lstm_tc_bwd_act_kernel and
//   lstm_tc_bwd_weight_kernel   <- _bwd_call's inner `kernel` (pallas_lstm.py:138-243)
// with the function and the rounding points that lstm_cell.cu states (that
// file holds the general kernels: f32, and widths that are no multiple of
// 16). This file takes bf16 with F and H multiples of 16, at most 64 each.
// The one numerical difference to the general kernels: sigmoid and tanh are
// the hardware's tanh.approx.f32 (relative error about 2^-11, below half a
// bf16 step), since precise expf/tanhf would cost as many issue slots as the
// products do on the tensor cores.
//
// Bound on the H100 at the flagship shape (B=768, N=25, F=H=64): the forward
// must move 18.8 MB and do 1.26 GFLOP, the backward 27 MB and 3.8 GFLOP. At
// 3.35 TB/s and 989 TFLOP/s both are bound by bytes: 5.6 and 8.1 microseconds.
//
// What the design does about it:
//   * Products: mma.sync.m16n8k16 (bf16 operands, f32 accumulation) fed by
//     ldmatrix from padded shared memory. Chosen over wgmma for all three
//     kernels: a warp's accumulator then holds the four gates of one hidden
//     unit for a free choice of columns (no permuted weight layout), units
//     of 32 rows per warp fit ragged batches, and the transposed products
//     (gz_T @ W^T, X^T @ gz_T) are ldmatrix with or without .trans on the
//     same shared-memory images.
//   * One pass over the weights per block: a block stages its agent's
//     [wx; wh] once (K x 4H bf16, 64 KB at the flagship width, rows padded
//     by 16 bytes so that ldmatrix is free of bank conflicts) and walks over
//     several 32-row batch tiles of that agent (grid N x splits). The
//     weights land in four pieces, and the first product starts on the first.
//   * 16-byte cp.async.cg straight from the [B, N, X] layout (a tile is a
//     2-D box: rows of 2X bytes at a pitch of 2NX) into a ring of four
//     stages. Rows past the batch are zero-filled by cp.async itself and
//     never stored; a zero row yields gate gradients of exactly 0, so it
//     adds nothing to dW and db.
//   * Warp-specialised blocks of twelve warps. A thread that issues a tile's
//     requests waits there for as long as the memory system is busy (all
//     blocks ask at once, and an SM gets 13 to 17 bytes a cycle), and so does
//     a thread whose request addresses hang on a chain of divisions and
//     multiplications; a warp that waits cannot compute. So two warps only
//     load, up to four tiles ahead, with request addresses that differ by a
//     constant step; two warps only store the results that the computing
//     warps leave in shared memory (16 bytes a store); eight warps only
//     compute, in two groups of four that take the block's tiles in turn and
//     so drift apart: one group's tensor-core phase meets the other's
//     special-function phase. mbarriers in shared memory hand a stage from
//     loaders (cp.async arrives on them by itself) to a group to the
//     drainers and back.
//   * No barrier among a group's warps in the forward: each runs fragments,
//     product and gate math of its own 32 rows x 16 hidden units. The
//     forward's done-mask is applied to h on the A fragments (bf16 multiply,
//     one rounding) and to c in the epilogue, so there is no masking pass.
//   * Backward, two passes, both on the tensor cores. Pass 1 recomputes the
//     gates, forms gz in f32, sums it for db (in registers across the
//     group's tiles), rounds it once to bf16 into the group's shared-memory
//     image, and, after a barrier of the group's four warps, computes
//     [dx | dh] = gz_T @ [wx; wh]^T from there; the drainers write gz_T out
//     once. Pass 2 is a per-agent [K x B] @ [B x 4H] product with a
//     three-stage cp.async ring over the batch that four loader warps keep
//     full; its blocks own 64 x 128 tiles of [dwx; dwh], so at the flagship
//     width x|h_in and gz_T are each read twice. A single pass that keeps dW
//     in registers per (agent, share of the batch) was rejected: at this
//     shape its f32 partials (25 x shares x 129 KB, written and read back)
//     are 26 MB for 4 shares, more than gz_T's 9.8 MB out and back, and
//     fewer shares leave most SMs idle.
//   * Determinism: no atomics. Every sum has a fixed order: mma's own, the
//     k loop, tile order and a fixed shuffle tree for db, the two groups in
//     order, pass 2's batch order, and the db partials summed in split order.
//
// Reached at the flagship shape (NVIDIA H100 80GB HBM3, 700 W; `python
// chip_smoke.py --tune`, replays of a CUDA graph of 20 launches, warm L2):
// forward 0.0116 ms, backward 0.0339 ms (pass 1 0.023, pass 2 0.011).
// Tried, in this order, with the forward / backward times in ms (64-row
// tiles, 3 a block, 256 threads unless said):
//   a barrier around every phase (mask, product, stores), divisions in the
//     copy loops                                           0.0186 / 0.0584
//   the same, one tile per block, two blocks per SM        0.0182 / 0.0617
//   per-warp phases, one barrier per tile                  0.0186 / 0.0554
//   + one bulk copy (cp.async.bulk) per 128-byte row       0.0507 / 0.1217
//   + a ninth warp that issues all loads (with divisions)  0.0194 / 0.0704
//   + division-free request addresses (no ninth warp)      0.0159 / 0.0408
//   + bias in registers, dx|dh units of 32 columns         0.0151 / 0.0402
//   + four warps that load and store, 384 threads, named
//     barriers, two stages                                 0.0136 / 0.0371
//   + k loops unrolled by 4, tile 1 asked for after tile 0 0.0133 / 0.0363
//   + the weights in four pieces                           0.0135 / 0.0361
//   + 32-row tiles, four stages, loaders and drainers
//     apart, two computing groups, mbarriers (this file)   0.0114 / 0.0345
//   + dx|dh without branches in its loop                   0.0114 / 0.0324
//   + dx|dh with two accumulator sets (spills)             0.0113 / 0.0391
//   + setmaxnreg 56 / 224 (ptxas then spills 3 KB)         0.0671 / 0.1125
//   + bias read per tile in pass 1 (no spill; this file)   0.0115 / 0.0334
//   + the gate k loop unrolled by 8, weights' second piece
//     before the second tile (not kept: no gain)           0.0115 / 0.0329
//   blocks per agent 4, 5, 6, 8, 10 (5 is the wrapper's rule: 125 blocks):
//     forward 0.0130, 0.0117, 0.0187, 0.0160, 0.0145; backward 0.0349,
//     0.0339, 0.0448, 0.0408, 0.0375
// What still holds them back, read from clock64() marks in block (0, 0) of
// pass 1: a group's 32-row tile takes 8,000 to 10,000 cycles (product 1,750
// alone to 2,450 beside the other group, gate math 2,150 to 3,300, dx|dh
// 3,400 to 4,200), the busier group has three tiles, and the first tile
// lands 3,700 cycles after the launch. A warp's chain of ldmatrix -> mma ->
// mma is what the time goes to: mma.sync with two or three warps per
// scheduler runs at a third to a half of its rate, and 168 registers a thread
// at 384 threads and 154 / 207 KB of shared memory allow no more warps. 125
// blocks leave 7 SMs idle. Pass 2 is bound by its loads (29 MB). wgmma
// (asynchronous, no ldmatrix traffic) with box-shaped TMA loads is what
// would lift these.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

// A block of the forward and of the backward's pass 1: eight warps compute, in
// two groups of four that take the block's tiles in turn; two warps only load
// tiles; two warps only store results.
constexpr int kGroupWarps = 4;
constexpr int kGroup = kGroupWarps * 32;   // threads of a computing group
constexpr int kCompute = 2 * kGroup;       // threads [0, 256)
constexpr int kLoaders = 64;               // threads [256, 320)
constexpr int kDrainers = 64;              // threads [320, 384)
constexpr int kThreads = kCompute + kLoaders + kDrainers;
constexpr int kBT = 32;     // batch rows per tile
constexpr int kStages = 4;  // tiles in flight: tile i lives in stage i % 4, group i % 2
constexpr int kPad = 8;     // bf16 elements (16 bytes) of padding per smem row
constexpr int kMaxFH = 64;  // largest F and largest H: H / 16 <= kGroupWarps
constexpr int kWRows = 32;  // the weights arrive in pieces of 32 rows of [wx; wh]
constexpr int kWPieces = 2 * kMaxFH / kWRows;
// pass 2: a block owns kWK x kWM of [dwx; dwh] and walks the batch in chunks;
// eight warps compute and four load
constexpr int kWK = 64;
constexpr int kWM = 128;
constexpr int kRB = 64;
constexpr int kRing = 3;
constexpr int kLoad2 = 128;
constexpr int kThreads2 = kCompute + kLoad2;

// Named barriers (id 0 is __syncthreads).
constexpr int kGroupBar = 1;     // + group: the four warps of a computing group
constexpr int kComputeAll = 3;   // all computing warps
constexpr int kFull = 4;         // pass 2, + stage: a chunk has landed
constexpr int kEmpty = 7;        // pass 2, + stage: a chunk is used up

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers in shared memory hand the stages from role to role: they
// can be waited for by any number of threads, and a thread's cp.async can
// arrive on one when they have landed, so that a loader never waits for its
// own loads. Use number u of a barrier is waited for with parity u & 1.
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

// The barriers of a forward / pass-1 block. Counts: full and wfull 64 (each
// loader's copies), done 4 (a group's warps), free and gzfree 64 (drainers).
struct Bars {
  uint64_t full[kStages];     // tile landed in the stage
  uint64_t done[kStages];     // the group has left its results in the stage
  uint64_t free_[kStages];    // the results are stored: the stage can be loaded again
  uint64_t wfull[kWPieces];   // a piece of the weights has landed
  uint64_t gzfree[2];         // pass 1: the group's gz_T image has been stored
};

__device__ __forceinline__ void bars_init(Bars* b) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&b->full[s], kLoaders);
      mbar_init(&b->done[s], kGroupWarps);
      mbar_init(&b->free_[s], kDrainers);
    }
    for (int p = 0; p < kWPieces; ++p) mbar_init(&b->wfull[p], kLoaders);
    mbar_init(&b->gzfree[0], kDrainers);
    mbar_init(&b->gzfree[1], kDrainers);
    mbar_init_fence();
  }
  __syncthreads();
}

// `bytes` (0..16) global -> shared, bypassing L1; the rest of the 16 is zeros
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

// Fragment addresses for ldmatrix.x4, lane l giving row (l & 7) of 8x8
// matrix (l >> 3), over a smem image s with `pitch` elements per row.
//
// A (16 x 16) stored [m][k]: matrices (m0,k0) (m8,k0) (m0,k8) (m8,k8).
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int pitch, int m0, int k0,
                                              int lane) {
  return s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + k0 + (lane >> 4) * 8;
}
// A (16 x 16) stored [k][m] (read with .trans): (k0,m0) (k0,m8) (k8,m0) (k8,m8).
__device__ __forceinline__ const bf16* at_addr(const bf16* s, int pitch, int m0, int k0,
                                               int lane) {
  return s + (k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0 + ((lane >> 3) & 1) * 8;
}
// B (16 x 16: two n-tiles) stored [k][n] (read with .trans): (k0,n0) (k8,n0)
// (k0,n8) (k8,n8) -> registers {0,1} are n-tile 0, {2,3} n-tile 1.
__device__ __forceinline__ const bf16* bt_addr(const bf16* s, int pitch, int k0, int n0,
                                               int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 + (lane >> 4) * 8;
}
// B (16 x 16: two n-tiles) stored [n][k]: (n0,k0) (n0,k8) (n8,k0) (n8,k8).
__device__ __forceinline__ const bf16* b_addr(const bf16* s, int pitch, int k0, int n0,
                                              int lane) {
  return s + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sigmoid_fast(float x) {
  return fmaf(0.5f, tanh_fast(0.5f * x), 0.5f);
}

__device__ __forceinline__ float rd_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The done-masks of the A fragments' rows 16 mt + 8 hf + lane / 4 as bf16
// pairs, from the tile's raw done flags: mask = bf16(1 - done). mk[mt][0]
// multiplies registers {0, 2}, mk[mt][1] registers {1, 3}.
__device__ __forceinline__ float row_mask(const bf16* ds, int row) {
  return rd_bf16(1.f - __bfloat162float(ds[row]));
}
__device__ __forceinline__ void row_masks(const bf16* ds, int lane, bf162 (&mk)[2][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      mk[mt][hf] = __float2bfloat162_rn(row_mask(ds, mt * 16 + hf * 8 + (lane >> 2)));
}

__device__ __forceinline__ uint32_t mul_bf162(uint32_t v, bf162 m) {
  bf162 r = __hmul2(*reinterpret_cast<bf162*>(&v), m);
  return *reinterpret_cast<uint32_t*>(&r);
}

// z (pre-activations, without bias) of the tile's 32 rows and the four gates
// of the 16 hidden units [j0, j0 + 16): acc[mt][gate * 2 + ns][.] is the
// m16n8 accumulator of rows 16 mt, columns gate * H + j0 + 8 ns.
// With kMask, the columns [F, K) of the A image hold the raw carry h, and its
// fragments are multiplied by the rows' done-masks in bf16 (one rounding, as
// h * mask in the compute dtype) before the product.
// With `wfull` (the group's first tile), each piece of the weights is waited
// for where the k loop first needs it.
template <bool kMask>
__device__ __forceinline__ void gate_product(const bf16* as, int AP, const bf16* ws, int WP,
                                             int F, int K, int H, int j0, int lane,
                                             const bf162 (&mk)[2][2], float (&acc)[2][8][4],
                                             uint64_t* wfull) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    if (wfull != nullptr && (k0 & (kWRows - 1)) == 0) mbar_wait(&wfull[k0 / kWRows], 0);
    uint32_t a[2][4];
    ldsm_x4(a[0], a_addr(as, AP, 0, k0, lane));
    ldsm_x4(a[1], a_addr(as, AP, 16, k0, lane));
    if (kMask && k0 >= F) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[mt][q] = mul_bf162(a[mt][q], mk[mt][q & 1]);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t bb[4];
      ldsm_x4_t(bb, bt_addr(ws, WP, k0, g * H + j0, lane));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][g * 2 + 0], a[mt], bb[0], bb[1]);
        mma_bf16(acc[mt][g * 2 + 1], a[mt], bb[2], bb[3]);
      }
    }
  }
}

__device__ __forceinline__ float2 ld_bf162(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}
__device__ __forceinline__ void st_bf162(bf16* p, float a, float b) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(a, b);
}

// The bias of this thread's columns of a unit (hidden units j0 + 8 ns +
// 2 (lane & 3) + {0, 1}, four gates), kept as bf16 pairs: bz[ns][gate].
__device__ __forceinline__ void unit_bias(const bf16* b_n, int H, int j0, int lane,
                                          bf162 (&bz)[2][4]) {
#pragma unroll
  for (int ns = 0; ns < 2; ++ns)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      bz[ns][g] = *reinterpret_cast<const bf162*>(b_n + g * H + j0 + ns * 8 + 2 * (lane & 3));
}
__device__ __forceinline__ float bias_of(bf162 v, int e) {
  return __bfloat162float(e ? v.y : v.x);
}

// ---- the loaders' and drainers' copies. kVec (a power of two) threads share
// a row, so a thread's addresses are its first one plus a constant step: no
// division and no chain of dependent address arithmetic between two requests.

// Box of `rows_total` rows of `width` bf16 (a multiple of 8, at most 8 * kVec)
// from device memory (row pitch `spitch` elements) to shared memory (row pitch
// `dpitch`), 16 bytes a request; rows at and past `rows_valid` become zeros.
// `t` is the thread's index among the `kNT` threads that copy.
template <int kVec, int kNT>
__device__ __forceinline__ void copy_box(bf16* dst, int dpitch, const bf16* src, size_t spitch,
                                         int width, int rows_valid, int rows_total, int t) {
  constexpr int kStep = kNT / kVec;
  const int v = t & (kVec - 1);
  if (v * 8 >= width) return;
  int r = t / kVec;
  bf16* d = dst + r * dpitch + v * 8;
  const bf16* g = src + (size_t)r * spitch + v * 8;
#pragma unroll 4
  for (; r < rows_total; r += kStep, d += kStep * dpitch, g += kStep * spitch) {
    const bool ok = r < rows_valid;
    cp_async16(d, ok ? g : src, ok ? 16 : 0);
  }
}

// Rows [0, rows) of a smem image to device memory, 16 bytes a store. With
// `ds` (the tile's done flags), each row is first multiplied by its mask in
// bf16 (h_in = h * mask).
template <int kVec, int kNT>
__device__ __forceinline__ void store_box(bf16* dst, size_t dpitch, const bf16* src, int spitch,
                                          int width, int rows, int t, const bf16* ds = nullptr) {
  constexpr int kStep = kNT / kVec;
  const int v = t & (kVec - 1);
  if (v * 8 >= width) return;
#pragma unroll 4
  for (int r = t / kVec; r < rows; r += kStep) {
    uint4 q = *reinterpret_cast<const uint4*>(src + r * spitch + v * 8);
    if (ds != nullptr) {
      const bf162 m = __float2bfloat162_rn(row_mask(ds, r));
      uint32_t* e = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
      for (int w = 0; w < 4; ++w) e[w] = mul_bf162(e[w], m);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * dpitch + v * 8) = q;
  }
}

// The tile's done flags [b0, b0 + 32) (raw, 64 bytes; zeros past the batch).
__device__ __forceinline__ void copy_done(bf16* ds, const bf16* done, int b0, int B, int t) {
  if (t < kBT / 8) {
    const int left = B - (b0 + t * 8);
    const int bytes = left <= 0 ? 0 : (left >= 8 ? 16 : left * 2);
    cp_async16(ds + t * 8, bytes ? done + b0 + t * 8 : done, bytes);
  }
}

// Piece p of agent n's [wx; wh] (rows [32 p, 32 p + 32) of K rows of G (+ pad)).
__device__ __forceinline__ void copy_weight_piece(bf16* ws, const bf16* wx, const bf16* wh,
                                                  int n, int F, int H, int p, int t) {
  const int G = 4 * H, WP = G + kPad, a = p * kWRows, b = a + kWRows;
  const int xa = min(a, F), xb = min(b, F), ha = max(a, F) - F, hb = max(min(b, F + H), F) - F;
  if (xb > xa)
    copy_box<32, kLoaders>(ws + xa * WP, WP, wx + ((size_t)n * F + xa) * G, G, G, xb - xa,
                           xb - xa, t);
  if (hb > ha)
    copy_box<32, kLoaders>(ws + (F + ha) * WP, WP, wh + ((size_t)n * H + ha) * G, G, G,
                           hb - ha, hb - ha, t);
}

// The loaders' schedule over the block's m tiles: the weights' first piece,
// tiles 0 and 1 (one for each computing group), the other pieces, tiles 2 and
// 3, and from then on tile i as soon as the drainers have freed its stage.
// Every load arrives on its barrier by itself when it has landed.
template <typename LoadTile>
__device__ __forceinline__ void loader_loop(Bars* bars, int m, bf16* ws, const bf16* wx,
                                            const bf16* wh, int n, int F, int H, int t,
                                            LoadTile load_tile) {
  copy_weight_piece(ws, wx, wh, n, F, H, 0, t);
  mbar_arrive_on_copies(&bars->wfull[0]);
  for (int i = 0; i < 2 && i < m; ++i) {
    load_tile(i);
    mbar_arrive_on_copies(&bars->full[i]);
  }
  for (int p = 1; p < kWPieces; ++p) {
    copy_weight_piece(ws, wx, wh, n, F, H, p, t);
    mbar_arrive_on_copies(&bars->wfull[p]);
  }
  for (int i = 2; i < m; ++i) {
    const int s = i % kStages;
    if (i >= kStages) mbar_wait(&bars->free_[s], (i / kStages - 1) & 1);
    load_tile(i);
    mbar_arrive_on_copies(&bars->full[s]);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- forward
//
// Grid (N, splits): block (n, s) takes the 32-row tiles s, s + splits, ... of
// agent n; its tile i lives in stage i % 4 and is computed by group i % 2.
// A thread that asks for a tile waits at the issue of its requests for as
// long as the memory system is busy (all blocks ask at once, and an SM gets
// 13 to 17 bytes a cycle), and a warp that waits there cannot compute. So the
// block is specialised: two warps only load, up to four tiles ahead; two
// warps only store the results that the computing warps leave in shared
// memory; and eight warps only compute, each the fragments, product and gate
// math of its own 32 rows x 16 hidden units, with no barrier among them, so
// that their tensor-core and special-function phases overlap too.
// Shared memory: ws [K][4H+8]; 4 x { xh [32][K+8], cs, ho, co [32][H+8],
// ds [32] }; the mbarriers.
struct FwdLayout {
  int WP, AP, HP;
  size_t ws, stage0, xh, cs, ho, co, ds, stage_bytes, bars, total;
  __host__ __device__ FwdLayout(int F, int H) {
    const int K = F + H, G = 4 * H;
    WP = G + kPad, AP = K + kPad, HP = H + kPad;
    const size_t hb = (size_t)kBT * HP * 2;
    ws = 0;
    stage0 = ws + (size_t)K * WP * 2;
    xh = 0;
    cs = xh + (size_t)kBT * AP * 2;
    ho = cs + hb;
    co = ho + hb;
    ds = co + hb;
    stage_bytes = ds + (size_t)kBT * 2;
    bars = stage0 + kStages * stage_bytes;
    total = bars + sizeof(Bars);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
lstm_tc_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                   const bf16* __restrict__ c, const bf16* __restrict__ done,
                   const bf16* __restrict__ wx, const bf16* __restrict__ wh,
                   const bf16* __restrict__ b, bf16* __restrict__ h_out,
                   bf16* __restrict__ c_out, bf16* __restrict__ hin_out,
                   bf16* __restrict__ cin_out, int B, int N, int F, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L(F, H);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  Bars* bars = reinterpret_cast<Bars*>(smem + L.bars);
  const int K = F + H;
  const int n = blockIdx.x, S = gridDim.y;
  const int n_tiles = (B + kBT - 1) / kBT;
  const int m = (n_tiles - (int)blockIdx.y + S - 1) / S;  // this block's tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t xp = (size_t)N * F, hp = (size_t)N * H;  // row pitches
  const bool res = hin_out != nullptr;
  auto stage_ptr = [&](int i) { return smem + L.stage0 + (i % kStages) * L.stage_bytes; };
  auto tile_b0 = [&](int i) { return ((int)blockIdx.y + i * S) * kBT; };
  bars_init(bars);

  if (tid >= kCompute + kLoaders) {  // ---- the drainers
    const int t = tid - kCompute - kLoaders;
    for (int i = 0; i < m; ++i) {
      const int s = i % kStages;
      unsigned char* sp = stage_ptr(i);
      const int b0 = tile_b0(i), rows = min(kBT, B - b0);
      const size_t o0 = (size_t)b0 * hp + (size_t)n * H;
      mbar_wait(&bars->done[s], (i / kStages) & 1);
      store_box<8, kDrainers>(h_out + o0, hp, reinterpret_cast<const bf16*>(sp + L.ho), L.HP, H,
                              rows, t);
      store_box<8, kDrainers>(c_out + o0, hp, reinterpret_cast<const bf16*>(sp + L.co), L.HP, H,
                              rows, t);
      if (res) {  // c_in was left over c; h_in = h * mask is formed here
        store_box<8, kDrainers>(cin_out + o0, hp, reinterpret_cast<const bf16*>(sp + L.cs), L.HP,
                                H, rows, t);
        store_box<8, kDrainers>(hin_out + o0, hp, reinterpret_cast<const bf16*>(sp + L.xh) + F,
                                L.AP, H, rows, t, reinterpret_cast<const bf16*>(sp + L.ds));
      }
      mbar_arrive(&bars->free_[s]);
    }
    return;
  }
  if (tid >= kCompute) {  // ---- the loaders
    const int t = tid - kCompute;
    auto load_tile = [&](int i) {
      unsigned char* sp = stage_ptr(i);
      bf16* xh = reinterpret_cast<bf16*>(sp + L.xh);
      const int b0 = tile_b0(i), rows = min(kBT, B - b0);
      const size_t o0 = (size_t)b0 * hp + (size_t)n * H;
      copy_box<8, kLoaders>(xh, L.AP, x + (size_t)b0 * xp + (size_t)n * F, xp, F, rows, kBT, t);
      copy_box<8, kLoaders>(xh + F, L.AP, h + o0, hp, H, rows, kBT, t);
      copy_box<8, kLoaders>(reinterpret_cast<bf16*>(sp + L.cs), L.HP, c + o0, hp, H, rows, kBT,
                            t);
      copy_done(reinterpret_cast<bf16*>(sp + L.ds), done, b0, B, t);
    };
    loader_loop(bars, m, ws, wx, wh, n, F, H, t, load_tile);
    return;
  }

  // ---- the computing warps: group g takes tiles g, g + 2, ...; warp q of
  // the group the hidden units [16 q, 16 q + 16)
  const int g = warp / kGroupWarps, j0 = (warp % kGroupWarps) * 16;
  const bool has_unit = j0 < H;
  bf162 bz[2][4];
  if (has_unit) unit_bias(b + (size_t)n * 4 * H, H, j0, lane, bz);
  for (int i = g; i < m; i += 2) {
    const int s = i % kStages;
    unsigned char* sp = stage_ptr(i);
    const bf16* xh = reinterpret_cast<const bf16*>(sp + L.xh);
    bf16* cs = reinterpret_cast<bf16*>(sp + L.cs);
    bf16* ho = reinterpret_cast<bf16*>(sp + L.ho);
    bf16* co = reinterpret_cast<bf16*>(sp + L.co);
    const bf16* ds = reinterpret_cast<const bf16*>(sp + L.ds);
    mbar_wait(&bars->full[s], (i / kStages) & 1);
    if (has_unit) {
      bf162 mk[2][2];
      row_masks(ds, lane, mk);
      float acc[2][8][4];
      gate_product<true>(xh, L.AP, ws, L.WP, F, K, H, j0, lane, mk, acc,
                         i == g ? bars->wfull : nullptr);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int ns = 0; ns < 2; ++ns)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = mt * 16 + hf * 8 + (lane >> 2);
            const int j = j0 + ns * 8 + 2 * (lane & 3);
            // c_in = c * mask in bf16, kept in place for the residual store
            bf162* cp = reinterpret_cast<bf162*>(cs + row * L.HP + j);
            const bf162 cin2 = __hmul2(*cp, mk[mt][hf]);
            *cp = cin2;
            const float2 cin = __bfloat1622float2(cin2);
            float cn[2], hn[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ig = sigmoid_fast(acc[mt][0 + ns][hf * 2 + e] + bias_of(bz[ns][0], e));
              const float fg = sigmoid_fast(acc[mt][2 + ns][hf * 2 + e] + bias_of(bz[ns][1], e));
              const float og = sigmoid_fast(acc[mt][4 + ns][hf * 2 + e] + bias_of(bz[ns][2], e));
              const float ug = tanh_fast(acc[mt][6 + ns][hf * 2 + e] + bias_of(bz[ns][3], e));
              cn[e] = fg * (e ? cin.y : cin.x) + ig * ug;
              hn[e] = og * tanh_fast(cn[e]);
            }
            st_bf162(co + row * L.HP + j, cn[0], cn[1]);
            st_bf162(ho + row * L.HP + j, hn[0], hn[1]);
          }
    }
    warp_arrive(&bars->done[s], lane);  // the stage's results are the drainers' to store
  }
}

// [dx | dh][row, k] = sum_m gz_T[row, m] * [wx; wh][k, m] for the tile's 32
// rows and the 8 kNT columns k from kc on, written as bf16 over the x|h_in
// image `xh`; dx (k < F) is unmasked, dh is multiplied by the row's mask.
template <int kNT>
__device__ __forceinline__ void dx_product(const bf16* gzs, int WP, const bf16* ws, bf16* xh,
                                           int AP, const bf16* ds, int F, int G, int kc,
                                           int lane) {
  float ad[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ns = 0; ns < kNT; ++ns)
#pragma unroll
      for (int e = 0; e < 4; ++e) ad[mt][ns][e] = 0.f;
#pragma unroll 4
  for (int m0 = 0; m0 < G; m0 += 16) {
    uint32_t a[2][4], bb[kNT / 2][4];
    ldsm_x4(a[0], a_addr(gzs, WP, 0, m0, lane));
    ldsm_x4(a[1], a_addr(gzs, WP, 16, m0, lane));
#pragma unroll
    for (int nb = 0; nb < kNT / 2; ++nb) ldsm_x4(bb[nb], b_addr(ws, WP, m0, kc + 16 * nb, lane));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ns = 0; ns < kNT; ++ns)
        mma_bf16(ad[mt][ns], a[mt], bb[ns >> 1][(ns & 1) * 2], bb[ns >> 1][(ns & 1) * 2 + 1]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = mt * 16 + hf * 8 + (lane >> 2);
      const float mrow = row_mask(ds, row);
#pragma unroll
      for (int ns = 0; ns < kNT; ++ns) {
        const int k = kc + ns * 8 + 2 * (lane & 3);
        const float mk = k < F ? 1.f : mrow;
        st_bf162(xh + row * AP + k, ad[mt][ns][hf * 2] * mk, ad[mt][ns][hf * 2 + 1] * mk);
      }
    }
}

// ------------------------------------------------------- backward, pass 1
//
// Grid (N, splits), tiles, stages and the roles of the warps as the forward.
// Per tile its computing group forms the gates from (x, h_in), the four gate
// gradients gz in f32, their column sums for db (kept in registers across the
// group's tiles), gz_T (bf16) in the group's own shared-memory image, dc_prev
// over dc_new, and, once the group's four warps have met, [dx | dh] = gz_T @
// [wx; wh]^T over the x|h_in image. The drainers store gz_T first and say so
// (gzfree), since the group's next gate gradients go to the same image.
// Shared memory: ws as the forward; 4 x { xh [32][K+8], ci, cn, dc, dh
// [32][H+8] each, ds [32] }; 2 x gzs [32][4H+8]; dbp [2][4H] f32; mbarriers.
struct BwdLayout {
  int WP, AP, HP;
  size_t ws, stage0, xh, ci, cn, dc, dh, ds, stage_bytes, gzs, gz_bytes, dbp, bars, total;
  __host__ __device__ BwdLayout(int F, int H) {
    const int K = F + H, G = 4 * H;
    WP = G + kPad, AP = K + kPad, HP = H + kPad;
    const size_t hb = (size_t)kBT * HP * 2;
    ws = 0;
    stage0 = ws + (size_t)K * WP * 2;
    xh = 0;
    ci = xh + (size_t)kBT * AP * 2;
    cn = ci + hb;
    dc = cn + hb;
    dh = dc + hb;
    ds = dh + hb;
    stage_bytes = ds + (size_t)kBT * 2;
    gzs = stage0 + kStages * stage_bytes;
    gz_bytes = (size_t)kBT * WP * 2;
    dbp = gzs + 2 * gz_bytes;
    bars = dbp + (size_t)2 * G * 4;
    total = bars + sizeof(Bars);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
lstm_tc_bwd_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h_in,
                       const bf16* __restrict__ c_in, const bf16* __restrict__ c_new,
                       const bf16* __restrict__ dc_new, const bf16* __restrict__ dh_new,
                       const bf16* __restrict__ done, const bf16* __restrict__ wx,
                       const bf16* __restrict__ wh, const bf16* __restrict__ b,
                       bf16* __restrict__ dx, bf16* __restrict__ dh_out,
                       bf16* __restrict__ dc_prev, bf16* __restrict__ gz_out,
                       float* __restrict__ db_part, int B, int N, int F, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L(F, H);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  float* dbp = reinterpret_cast<float*>(smem + L.dbp);
  Bars* bars = reinterpret_cast<Bars*>(smem + L.bars);
  const int K = F + H, G = 4 * H;
  const int n = blockIdx.x, S = gridDim.y;
  const int n_tiles = (B + kBT - 1) / kBT;
  const int m = (n_tiles - (int)blockIdx.y + S - 1) / S;  // this block's tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t xp = (size_t)N * F, hp = (size_t)N * H;
  auto stage_ptr = [&](int i) { return smem + L.stage0 + (i % kStages) * L.stage_bytes; };
  auto gz_ptr = [&](int g) { return reinterpret_cast<bf16*>(smem + L.gzs + g * L.gz_bytes); };
  auto tile_b0 = [&](int i) { return ((int)blockIdx.y + i * S) * kBT; };
  bars_init(bars);

  if (tid >= kCompute + kLoaders) {  // ---- the drainers
    const int t = tid - kCompute - kLoaders;
    for (int i = 0; i < m; ++i) {
      const int s = i % kStages;
      unsigned char* sp = stage_ptr(i);
      const bf16* xh = reinterpret_cast<const bf16*>(sp + L.xh);
      const int b0 = tile_b0(i), rows = min(kBT, B - b0);
      const size_t o0 = (size_t)b0 * hp + (size_t)n * H;
      mbar_wait(&bars->done[s], (i / kStages) & 1);
      store_box<32, kDrainers>(gz_out + ((size_t)n * B + b0) * G, G, gz_ptr(i & 1), L.WP, G,
                               rows, t);
      mbar_arrive(&bars->gzfree[i & 1]);
      store_box<8, kDrainers>(dc_prev + o0, hp, reinterpret_cast<const bf16*>(sp + L.dc), L.HP,
                              H, rows, t);
      store_box<8, kDrainers>(dx + (size_t)b0 * xp + (size_t)n * F, xp, xh, L.AP, F, rows, t);
      store_box<8, kDrainers>(dh_out + o0, hp, xh + F, L.AP, H, rows, t);
      mbar_arrive(&bars->free_[s]);
    }
    return;
  }
  if (tid >= kCompute) {  // ---- the loaders
    const int t = tid - kCompute;
    auto load_tile = [&](int i) {
      unsigned char* sp = stage_ptr(i);
      bf16* xh = reinterpret_cast<bf16*>(sp + L.xh);
      const int b0 = tile_b0(i), rows = min(kBT, B - b0);
      const size_t o0 = (size_t)b0 * hp + (size_t)n * H;
      copy_box<8, kLoaders>(xh, L.AP, x + (size_t)b0 * xp + (size_t)n * F, xp, F, rows, kBT, t);
      copy_box<8, kLoaders>(xh + F, L.AP, h_in + o0, hp, H, rows, kBT, t);
      copy_box<8, kLoaders>(reinterpret_cast<bf16*>(sp + L.ci), L.HP, c_in + o0, hp, H, rows,
                            kBT, t);
      copy_box<8, kLoaders>(reinterpret_cast<bf16*>(sp + L.cn), L.HP, c_new + o0, hp, H, rows,
                            kBT, t);
      copy_box<8, kLoaders>(reinterpret_cast<bf16*>(sp + L.dc), L.HP, dc_new + o0, hp, H, rows,
                            kBT, t);
      copy_box<8, kLoaders>(reinterpret_cast<bf16*>(sp + L.dh), L.HP, dh_new + o0, hp, H, rows,
                            kBT, t);
      copy_done(reinterpret_cast<bf16*>(sp + L.ds), done, b0, B, t);
    };
    loader_loop(bars, m, ws, wx, wh, n, F, H, t, load_tile);
    return;
  }

  // ---- the computing warps: group g takes tiles g, g + 2, ...; warp q of
  // the group the hidden units [16 q, 16 q + 16) and columns [32 q, ...) of dx | dh
  const int g = warp / kGroupWarps, q = warp % kGroupWarps, j0 = q * 16;
  const bool has_unit = j0 < H;
  bf16* gzs = gz_ptr(g);
  // db over the group's tiles, for this thread's rows and columns of the
  // warp's unit: [ns][gate][e]
  float db_reg[2][4][2];
#pragma unroll
  for (int ns = 0; ns < 2; ++ns)
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) db_reg[ns][gt][0] = db_reg[ns][gt][1] = 0.f;
  const bf162 no_mask[2][2] = {};

  for (int i = g; i < m; i += 2) {
    const int s = i % kStages;
    unsigned char* sp = stage_ptr(i);
    bf16* xh = reinterpret_cast<bf16*>(sp + L.xh);
    const bf16* ci = reinterpret_cast<const bf16*>(sp + L.ci);
    const bf16* cn = reinterpret_cast<const bf16*>(sp + L.cn);
    bf16* dcs = reinterpret_cast<bf16*>(sp + L.dc);
    const bf16* dhs = reinterpret_cast<const bf16*>(sp + L.dh);
    const bf16* ds = reinterpret_cast<const bf16*>(sp + L.ds);
    mbar_wait(&bars->full[s], (i / kStages) & 1);

    float acc[2][8][4];
    if (has_unit)
      gate_product<false>(xh, L.AP, ws, L.WP, F, K, H, j0, lane, no_mask, acc,
                          i == g ? bars->wfull : nullptr);
    // the group's last gz_T image has been stored (its tile before this one)
    if (i >= 2) mbar_wait(&bars->gzfree[g], ((i >> 1) - 1) & 1);
    if (has_unit) {
      bf162 bz[2][4];  // read per tile (it stays in L1): registers are short here
      unit_bias(b + (size_t)n * G, H, j0, lane, bz);
#pragma unroll
      for (int ns = 0; ns < 2; ++ns) {
        const int j = j0 + ns * 8 + 2 * (lane & 3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = mt * 16 + hf * 8 + (lane >> 2);
            const int off = row * L.HP + j;
            const float2 cin = ld_bf162(ci + off), cnw = ld_bf162(cn + off);
            const float2 dcn = ld_bf162(dcs + off), dhn2 = ld_bf162(dhs + off);
            const float mrow = row_mask(ds, row);
            float gz[4][2], dcp[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ig = sigmoid_fast(acc[mt][0 + ns][hf * 2 + e] + bias_of(bz[ns][0], e));
              const float fg = sigmoid_fast(acc[mt][2 + ns][hf * 2 + e] + bias_of(bz[ns][1], e));
              const float og = sigmoid_fast(acc[mt][4 + ns][hf * 2 + e] + bias_of(bz[ns][2], e));
              const float ug = tanh_fast(acc[mt][6 + ns][hf * 2 + e] + bias_of(bz[ns][3], e));
              const float tc = tanh_fast(e ? cnw.y : cnw.x);
              const float dhn = e ? dhn2.y : dhn2.x;
              const float dc = dhn * og * (1.f - tc * tc) + (e ? dcn.y : dcn.x);
              gz[0][e] = (dc * ug) * ig * (1.f - ig);
              gz[1][e] = (dc * (e ? cin.y : cin.x)) * fg * (1.f - fg);
              gz[2][e] = (dhn * tc) * og * (1.f - og);
              gz[3][e] = (dc * ig) * (1.f - ug * ug);
              dcp[e] = (dc * fg) * mrow;
            }
#pragma unroll
            for (int gt = 0; gt < 4; ++gt) {
              st_bf162(gzs + row * L.WP + gt * H + j, gz[gt][0], gz[gt][1]);
              db_reg[ns][gt][0] += gz[gt][0];  // db: the f32 gz, rows in tile order
              db_reg[ns][gt][1] += gz[gt][1];
            }
            st_bf162(dcs + off, dcp[0], dcp[1]);  // dc_prev over dc_new, same thread
          }
      }
    }
    bar_sync(kGroupBar + g, kGroup);  // the tile's gz_T is whole; its x|h_in image is free
    if (i == g)  // dx | dh needs every piece of the weights (a warp without a unit has not waited)
      for (int p = 0; p * kWRows < K; ++p) mbar_wait(&bars->wfull[p], 0);

    // [dx | dh] = gz_T @ [wx; wh]^T: a unit is 32 rows x 32 columns of k (16
    // at a ragged end), written over the x|h_in image
    for (int kc = q * 32; kc < K; kc += kGroupWarps * 32) {
      if (kc + 16 < K)
        dx_product<4>(gzs, L.WP, ws, xh, L.AP, ds, F, G, kc, lane);
      else
        dx_product<2>(gzs, L.WP, ws, xh, L.AP, ds, F, G, kc, lane);
    }
    warp_arrive(&bars->done[s], lane);  // the stage's results are the drainers' to store
  }

  // db partial of this block: each thread's sum over its rows of all tiles,
  // then the warp's eight row groups by a fixed shuffle tree, then the two
  // groups in order
  if (has_unit) {
#pragma unroll
    for (int ns = 0; ns < 2; ++ns)
#pragma unroll
      for (int gt = 0; gt < 4; ++gt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = db_reg[ns][gt][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) dbp[g * G + gt * H + j0 + ns * 8 + 2 * lane + e] = v;
        }
  }
  bar_sync(kComputeAll, kCompute);
  if (tid < G) db_part[((size_t)n * S + blockIdx.y) * G + tid] = dbp[tid] + dbp[G + tid];
}

// ------------------------------------------------------- backward, pass 2
//
// Grid (N, ceil(K / 64), ceil(4H / 128)): block (n, ky, my) owns rows
// [64 ky, +64) and columns [128 my, +128) of [dwx; dwh][n] = [x | h_in]^T @
// gz_T, summed over the whole batch in order, chunks of 64 rows through a
// three-stage cp.async ring that four loader warps keep full (named barriers
// kFull / kEmpty hand the stages over). Computing warp w:
// 32 rows (w & 1) x 32 columns (w >> 1). Blocks with ky == 0 also sum the db
// partials in split order.
constexpr int kXP = kWK + kPad;   // smem pitch of the x|h_in chunk
constexpr int kGP = kWM + kPad;   // smem pitch of the gz_T chunk
constexpr size_t kRingStage = (size_t)kRB * (kXP + kGP) * 2;

__global__ void __launch_bounds__(kThreads2, 1)
lstm_tc_bwd_weight_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h_in,
                          const bf16* __restrict__ gz, const float* __restrict__ db_part,
                          int n_splits, float* __restrict__ dwx, float* __restrict__ dwh,
                          float* __restrict__ db, int B, int N, int F, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = F + H, G = 4 * H;
  const int n = blockIdx.x, k0 = blockIdx.y * kWK, m0 = blockIdx.z * kWM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = (B + kRB - 1) / kRB;

  if (tid >= kCompute) {  // ---- the loaders
    // this thread's requests of a chunk: 4 of x|h_in (8 threads a row) and 8
    // of gz_T (16 threads a row), at fixed columns, so only the row moves
    const int t = tid - kCompute;
    const int xv = (t & 7) * 8, xk = k0 + xv, xr = t >> 3;
    const bool x_ok = xk < K;
    const size_t x_pitch = xk < F ? (size_t)N * F : (size_t)N * H;
    const bf16* x_col = xk < F ? x + (size_t)n * F + xk : h_in + (size_t)n * H + (xk - F);
    const int gv = (t & 15) * 8, gm = m0 + gv, gr = t >> 4;
    const bool g_ok = gm < G;
    const bf16* g_col = gz + (size_t)n * B * G + gm;
    for (int ch = 0; ch < n_chunks + 2; ++ch) {
      if (ch >= 2) {  // chunk ch - 2 has landed
        cp_async_wait<1>();
        bar_arrive(kFull + (ch - 2) % kRing, kThreads2);
      }
      if (ch < n_chunks) {
        const int st = ch % kRing;
        if (ch >= kRing) bar_sync(kEmpty + st, kThreads2);  // chunk ch - 3 is used up
        bf16* xs = reinterpret_cast<bf16*>(smem + st * kRingStage);
        bf16* gs = xs + kRB * kXP;
        const int b0 = ch * kRB;
#pragma unroll
        for (int i = 0; i < kRB / 16; ++i) {
          const int r = xr + 16 * i;
          const bool ok = x_ok && b0 + r < B;
          cp_async16(xs + r * kXP + xv, ok ? x_col + (size_t)(b0 + r) * x_pitch : x, ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < kRB / 8; ++i) {
          const int r = gr + 8 * i;
          const bool ok = g_ok && b0 + r < B;
          cp_async16(gs + r * kGP + gv, ok ? g_col + (size_t)(b0 + r) * G : gz, ok ? 16 : 0);
        }
      }
      cp_async_commit();
    }
    return;
  }

  // ---- the computing warps
  const int wk = (warp & 1) * 32, wm = (warp >> 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch % kRing;
    bar_sync(kFull + st, kThreads2);
    const bf16* xs = reinterpret_cast<const bf16*>(smem + st * kRingStage);
    const bf16* gs = xs + kRB * kXP;
#pragma unroll
    for (int r0 = 0; r0 < kRB; r0 += 16) {
      uint32_t a[2][4], bb[2][4];
      ldsm_x4_t(a[0], at_addr(xs, kXP, wk, r0, lane));
      ldsm_x4_t(a[1], at_addr(xs, kXP, wk + 16, r0, lane));
      ldsm_x4_t(bb[0], bt_addr(gs, kGP, r0, wm, lane));
      ldsm_x4_t(bb[1], bt_addr(gs, kGP, r0, wm + 16, lane));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], bb[nt >> 1][(nt & 1) * 2], bb[nt >> 1][(nt & 1) * 2 + 1]);
    }
    if (ch + kRing < n_chunks) bar_arrive(kEmpty + st, kThreads2);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = k0 + wk + mt * 16 + hf * 8 + (lane >> 2);
        const int m = m0 + wm + nt * 8 + 2 * (lane & 3);
        if (k >= K || m >= G) continue;
        float* dst = k < F ? dwx + ((size_t)n * F + k) * G + m
                           : dwh + ((size_t)n * H + (k - F)) * G + m;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[mt][nt][hf * 2], acc[mt][nt][hf * 2 + 1]);
      }
  if (blockIdx.y == 0 && tid < kWM && m0 + tid < G) {
    float s = 0.f;
    for (int t = 0; t < n_splits; ++t) s += db_part[((size_t)n * n_splits + t) * G + m0 + tid];
    db[(size_t)n * G + m0 + tid] = s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shape_ok(int B, int N, int F, int H) {
  return B > 0 && N > 0 && F > 0 && H > 0 && F % 16 == 0 && H % 16 == 0 && F <= kMaxFH &&
         H <= kMaxFH;
}

}  // namespace

// C interface, loaded with ctypes. Every pointer is a 16-byte aligned device
// pointer to a contiguous bf16 tensor (the weight gradients and db_part f32);
// hin_out/cin_out may be null (no residuals). `splits` is the number of
// blocks per agent, at most ceil(B / 32). Returns the cudaError_t of the launches.

extern "C" int lstm_cell_tc_fwd(const void* x, const void* h, const void* c, const void* done,
                                const void* wx, const void* wh, const void* b, void* h_out,
                                void* c_out, void* hin_out, void* cin_out, int B, int N, int F,
                                int H, int splits, void* stream) {
  const int n_tiles = (B + kBT - 1) / kBT;
  if (!shape_ok(B, N, F, H) || splits < 1 || splits > n_tiles)
    return (int)cudaErrorInvalidValue;
  const FwdLayout L(F, H);
  cudaError_t err = allow_smem(lstm_tc_fwd_kernel, L.total);
  if (err != cudaSuccess) return (int)err;
  lstm_tc_fwd_kernel<<<dim3(N, splits), kThreads, L.total, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)h, (const bf16*)c, (const bf16*)done, (const bf16*)wx,
      (const bf16*)wh, (const bf16*)b, (bf16*)h_out, (bf16*)c_out, (bf16*)hin_out,
      (bf16*)cin_out, B, N, F, H);
  return (int)cudaGetLastError();
}

// gz: scratch [N, B, 4H] bf16; db_part: scratch [N, splits, 4H] f32.
extern "C" int lstm_cell_tc_bwd(const void* x, const void* h_in, const void* c_in,
                                const void* c_new, const void* dc_new, const void* dh_new,
                                const void* done, const void* wx, const void* wh, const void* b,
                                void* dx, void* dh, void* dc_prev, void* gz, void* db_part,
                                void* dwx, void* dwh, void* db, int B, int N, int F, int H,
                                int splits, void* stream) {
  const int n_tiles = (B + kBT - 1) / kBT;
  if (!shape_ok(B, N, F, H) || splits < 1 || splits > n_tiles)
    return (int)cudaErrorInvalidValue;
  const int K = F + H, G = 4 * H;
  const BwdLayout L(F, H);
  cudaError_t err = allow_smem(lstm_tc_bwd_act_kernel, L.total);
  if (err != cudaSuccess) return (int)err;
  lstm_tc_bwd_act_kernel<<<dim3(N, splits), kThreads, L.total, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)h_in, (const bf16*)c_in, (const bf16*)c_new,
      (const bf16*)dc_new, (const bf16*)dh_new, (const bf16*)done, (const bf16*)wx,
      (const bf16*)wh, (const bf16*)b, (bf16*)dx, (bf16*)dh, (bf16*)dc_prev, (bf16*)gz,
      (float*)db_part, B, N, F, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t ring = kRing * kRingStage;
  err = allow_smem(lstm_tc_bwd_weight_kernel, ring);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(N, (K + kWK - 1) / kWK, (G + kWM - 1) / kWM);
  lstm_tc_bwd_weight_kernel<<<grid2, kThreads2, ring, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)h_in, (const bf16*)gz, (const float*)db_part, splits,
      (float*)dwx, (float*)dwh, (float*)db, B, N, F, H);
  return (int)cudaGetLastError();
}
