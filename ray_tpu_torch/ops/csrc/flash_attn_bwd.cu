// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Two kernels, the counterparts of the two TPU kernels that
// ray_tpu/ops/flash_attention.py's `_bwd_impl` launches through
// pl.pallas_call:
//   * dq  replaces `_dq_kernel`  (flash_attention.py:168, launch :308);
//   * dkv replaces `_dkv_kernel` (flash_attention.py:219, launch :326).
// Both recompute P = exp(Q K^T * scale - lse) from the forward's lse
// under the causal mask on global positions, (q_off + i) >= (kv_off + j),
// and use Delta = rowsum(dO * O). With dP = dO V^T and
// dS = P * (dP - Delta) * scale:
//   dQ = sum_j dS K,  dV = sum_i P^T dO,  dK = sum_i dS^T Q.
// As in the Pallas kernels, P is rounded to dO's type before P^T dO
// (:251) and dS to the input type before dS K and dS^T Q (:201, :256);
// the sums are f32. Delta, which `_bwd_impl` computes outside the
// kernels, is computed by the dq kernel, each block for its own rows
// before its kv loop, into a (B, H, Sq) f32 buffer that the dk/dv kernel
// reads: dk/dv runs after dq on the same stream.
//
// What bounds it on this card. Per visible (query, key) pair dq does
// three products of length D (Q K^T, dO V^T, dS K: 6*D FLOPs) and dkv
// four (8*D FLOPs), against bytes (q, k, v, dO, O, lse read once, dq /
// dk / dv written once) that grow only as S. At the training shape
// (llama-654m: 8 x 1024 tokens, 12 query over 4 KV heads, D 128) that is
// ~3.9e10 and ~5.2e10 FLOPs against ~40 MB: far above the ~295 bf16
// FLOPs per byte where the tensor cores (989 TFLOP/s), not the memory
// (3.35 TB/s), become the limit. Both kernels are bound by operations.
//
// What the design does about that:
//   * bf16 (the training path): the forward's structure
//     (flash_attn_fwd.cu) on hopper.cuh. A block of three warpgroups:
//     one producer thread starts TMA loads into shared memory, the
//     streamed operands through a 2-stage ring with full / empty
//     mbarriers, and the producer warpgroup gives its registers to the
//     consumers (setmaxnreg); two consumer warpgroups of 64 rows each run
//     every product on wgmma with f32 accumulators in registers. The
//     score tiles (S and dP, or their transposes) are 64 x 64 products
//     with both operands K-major in shared memory, as the tensors lie in
//     memory. P and dS are repacked from those accumulators into the
//     bf16 register A operands of the next products (the rounding the
//     Pallas kernels do), whose B operand (K for dS K; dO and Q for
//     P^T dO and dS^T Q) is read MN-major through the transpose bit: no
//     operand is copied transposed, and P and dS never leave the SM.
//   * dkv: one block per (KV head, batch, 128-row kv tile), the first
//     (heaviest) kv tiles first. K and V are loaded once; Q and dO tiles
//     of 64 rows stream through the ring, for each query head of the GQA
//     group and each q tile at or below the diagonal. A second producer
//     warp stages each q tile's lse (times log2 e) and Delta in shared
//     memory with plain loads: a (B, H, Sq) f32 row is not 16-byte
//     aligned when Sq is not a multiple of 4, as TMA would need. Each
//     consumer computes S^T = K Q^T and dP^T = V dO^T for its 64 kv rows
//     and accumulates dK and dV (64 x D f32 each) in registers. That
//     loop is the group sum that the gradient of `jnp.repeat` does in the
//     JAX package: in f32, in a fixed order and without atomics, so the
//     result is the same from run to run, and with no (B, Skv, H, D)
//     scratch.
//   * dq: one block per (head, batch, 128-row q tile), heaviest first.
//     Q and dO are loaded once; K and V tiles of 64 rows stream through
//     the ring up to the diagonal; the block reads KV head h / (H / KVH)
//     in place. Each consumer owns 64 q rows: S = Q K^T, dP = dO V^T,
//     dQ += dS K, with dQ (64 x D f32) in registers until the one store.
//   * exp2 with scale * log2(e) folded into one multiply. The mask is
//     evaluated only on tiles that straddle the diagonal or a ragged
//     edge, and a consumer skips the products of a tile it cannot see.
//   * f32 (the exact comparison): 4 threads a row on the CUDA cores with
//     f32 FMAs, so f32 results are not rounded to TF32.
//   * Masking is a select, never a multiply: exp of a masked score can be
//     inf (a row that sees no key has lse ~ -1e30), and inf * 0 is NaN.
//     Ragged rows load as zeros (TMA fills them, the f32 loads write
//     them), are masked out and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq): written by dq, read by dkv
  void* dq;
  void* dk;
  void* dv;
  int H, KVH, Sq, Skv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long o_sb, o_ss, o_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int q_off, kv_off, causal;
};

// qi in [0, Sq) space, kj in [0, Skv) space (either may be out of range).
__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  if (qi >= p.Sq || kj >= p.Skv) return false;
  return !p.causal || (p.q_off + qi >= p.kv_off + kj);
}

// Number of kv rows some query row of [0, q_end) may see.
__device__ __forceinline__ int kv_limit(const Params& p, int q_end) {
  if (!p.causal) return p.Skv;
  int n = p.q_off + q_end - 1 - p.kv_off + 1;
  return n < p.Skv ? n : p.Skv;
}

// First query row that may see kv row k0 (or a later one).
__device__ __forceinline__ int q_start(const Params& p, int k0) {
  if (!p.causal) return 0;
  int i = p.kv_off + k0 - p.q_off;
  return i > 0 ? i : 0;
}

__device__ __forceinline__ long long row_stat(const Params& p, int b, int h,
                                              int qi) {
  return ((long long)b * p.H + h) * p.Sq + qi;
}

// Whether some (query, key) pair of the 64 x 64 tile of query rows
// [qi, qi + 64) and kv rows [kj, kj + 64) is masked (the tile straddles
// the diagonal or a ragged edge), and whether all of them are.
__device__ __forceinline__ bool some_masked(const Params& p, int qi, int kj) {
  return qi + 64 > p.Sq || kj + 64 > p.Skv ||
         (p.causal && p.q_off + qi < p.kv_off + kj + 63);
}

__device__ __forceinline__ bool all_masked(const Params& p, int qi, int kj) {
  return qi >= p.Sq || kj >= p.Skv ||
         (p.causal && p.q_off + qi + 63 < p.kv_off + kj);
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised, TMA + wgmma
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// The product of depth step kk over D that a K-major operand of R-row
// tiles starts at (hopper.cuh's layout contract: D / 64 tiles of R rows
// x 128 bytes, one after the other).
template <int R>
__device__ __forceinline__ uint64_t k_major(uint32_t base, int kk) {
  return hopper::desc_sw128(base + (kk / 4) * (R * 128) + (kk % 4) * 32, 16,
                            1024);
}

// Depth step kk (rows 16 kk .. 16 kk + 15) of an MN-major B operand of
// R-row tiles, D wide.
template <int R>
__device__ __forceinline__ uint64_t mn_major(uint32_t base, int kk) {
  return hopper::desc_sw128(base + kk * 16 * 128, R * 128, 1024);
}

// acc (+)= A B for one depth step, N = D: A in registers, B MN-major.
template <int D>
__device__ __forceinline__ void rs_tb(float* acc, const uint32_t (&a)[4],
                                      uint64_t desc_b) {
  if constexpr (D == 128)
    hopper::wgmma_m64n128k16_rs_tb(acc, a, desc_b, 1);
  else
    hopper::wgmma_m64n64k16_rs_tb(acc, a, desc_b, 1);
}

// Stores this thread's part of a 64 x D f32 accumulator as bf16 rows
// row0 and row0 + 8 of `g` (row stride rs), those below `rows` only.
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, long long rs,
                                           const float* acc, int row0,
                                           int rows, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    bf16* x = g + row * rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(x + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// Shared-memory plan of the dk/dv kernel (byte offsets from a 1024-byte-
// aligned base): K, V, the Q ring, the dO ring, the ring's lse and Delta
// rows, the barriers.
template <int D>
struct DkvPlan {
  static constexpr int BK = 128, BQ = 64, STAGES = 2;
  static constexpr int KV_BYTES = BK * D * 2, Q_BYTES = BQ * D * 2;
  static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int STAT_OFF = DO_OFF + STAGES * Q_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
  static constexpr int N_BARS = 1 + 2 * STAGES;
  static constexpr int SMEM = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(384, 1)
dkv_bf16_wgmma(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map, Params p) {
  using P = DkvPlan<D>;
  constexpr int BK = P::BK, BQ = P::BQ, S = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + P::STAT_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BK;
  const int G = p.H / p.KVH;
  // The block's (query head, q tile) pairs, head-major, each q tile from
  // i_first on; the i-th pair takes ring slot i % S.
  const int i_first = q_start(p, k0) / BQ * BQ;
  const bool any = i_first < p.Sq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // TMA arrival + the stats warp
      hopper::mbar_init(&empty[s], 8);      // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: thread 0 starts the TMA loads, warp 1 stages
    // lse and Delta. 40 registers a thread (24 spill in warp 1's loop),
    // which leaves the consumers 232.
    hopper::regs_dec<40>();
    if (threadIdx.x == 0 && any) {
      hopper::prefetch_tmap(&q_map);
      hopper::prefetch_tmap(&k_map);
      hopper::prefetch_tmap(&v_map);
      hopper::prefetch_tmap(&do_map);
      hopper::mbar_expect_tx(kv_full, 2 * P::KV_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(smem + P::K_OFF + c * BK * 128, &k_map, kv_full,
                            c * 64, k0, kvh, b);
        hopper::tma_load_4d(smem + P::V_OFF + c * BK * 128, &v_map, kv_full,
                            c * 64, k0, kvh, b);
      }
      int it = 0;
      for (int h = kvh * G; h < kvh * G + G; ++h)
        for (int i0 = i_first; i0 < p.Sq; i0 += BQ, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* qs = smem + P::Q_OFF + s * P::Q_BYTES;
          uint8_t* dos = smem + P::DO_OFF + s * P::Q_BYTES;
          hopper::mbar_expect_tx(&full[s], 2 * P::Q_BYTES);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(qs + c * BQ * 128, &q_map, &full[s], c * 64,
                                i0, h, b);
            hopper::tma_load_4d(dos + c * BQ * 128, &do_map, &full[s],
                                c * 64, i0, h, b);
          }
        }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      const int lane = threadIdx.x - 32;
      int it = 0;
      for (int h = kvh * G; h < kvh * G + G; ++h) {
        const float* lse_row = p.lse + row_stat(p, b, h, 0);
        const float* dlt_row = p.delta + row_stat(p, b, h, 0);
        for (int i0 = i_first; i0 < p.Sq; i0 += BQ, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          float* st = stats + s * 2 * BQ;
#pragma unroll
          for (int j = lane; j < BQ; j += 32) {
            const bool in = i0 + j < p.Sq;  // past Sq: finite, and masked
            st[j] = in ? lse_row[i0 + j] * kLog2e : 0.f;
            st[BQ + j] = in ? dlt_row[i0 + j] : 0.f;
          }
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 kv rows each.
    hopper::regs_inc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int kf = k0 + cw * 64;               // first kv row of this group
    const int krow = kf + warp * 16 + g;       // rows krow and krow + 8
    const uint32_t k_base =
        hopper::smem_u32(smem + P::K_OFF) + cw * 64 * 128;
    const uint32_t v_base =
        hopper::smem_u32(smem + P::V_OFF) + cw * 64 * 128;
    const float sl2 = p.scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (any) hopper::mbar_wait(kv_full, 0);
    int it = 0;
    for (int gi = 0; gi < G; ++gi) {
      for (int i0 = i_first; i0 < p.Sq; i0 += BQ, ++it) {
        const int s = it % S;
        const uint32_t q_base =
            hopper::smem_u32(smem + P::Q_OFF + s * P::Q_BYTES);
        const uint32_t do_base =
            hopper::smem_u32(smem + P::DO_OFF + s * P::Q_BYTES);
        hopper::mbar_wait(&full[s], (it / S) & 1);
        if (!all_masked(p, i0, kf)) {
          // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x BQ q columns.
          float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
          hopper::fence_regs<BQ / 2>(st);
          hopper::fence_regs<BQ / 2>(dpt);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hopper::wgmma_m64n64k16_ss(st, k_major<BK>(k_base, kk),
                                       k_major<BQ>(q_base, kk), kk > 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hopper::wgmma_m64n64k16_ss(dpt, k_major<BK>(v_base, kk),
                                       k_major<BQ>(do_base, kk), kk > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs<BQ / 2>(st);
          hopper::fence_regs<BQ / 2>(dpt);

          // P^T in place of S^T, dS^T in place of dP^T. Element e of
          // 8-column slice n sits at kv row krow + 8 * (e / 2), q column
          // i0 + 8 * n + 2 * t4 + e % 2.
          const float* lse2 = stats + s * 2 * BQ;
          const float* dlt = lse2 + BQ;
          const bool mask = some_masked(p, i0, kf);
#pragma unroll
          for (int n = 0; n < BQ / 8; ++n) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(lse2 + 8 * n + 2 * t4);
            const float2 d2 =
                *reinterpret_cast<const float2*>(dlt + 8 * n + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * n + e;
              float pe = hopper::exp2_approx(
                  fmaf(st[i], sl2, -(e % 2 ? l2.y : l2.x)));
              if (mask && !visible(p, i0 + 8 * n + 2 * t4 + e % 2,
                                   krow + 8 * (e / 2)))
                pe = 0.f;
              dpt[i] = pe * (dpt[i] - (e % 2 ? d2.y : d2.x)) * p.scale;
              st[i] = pe;
            }
          }

          // dV += P^T dO (P rounded to dO's type), dK += dS^T Q (dS
          // rounded to Q's type), as `_dkv_kernel`; dO and Q are [q][D],
          // read MN-major.
          uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            hopper::acc_to_a(st, kk, pa[kk]);
            hopper::acc_to_a(dpt, kk, da[kk]);
          }
          hopper::fence_regs<D / 2>(dv);
          hopper::fence_regs<D / 2>(dk);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            rs_tb<D>(dv, pa[kk], mn_major<BQ>(do_base, kk));
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            rs_tb<D>(dk, da[kk], mn_major<BQ>(q_base, kk));
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs<D / 2>(dv);
          hopper::fence_regs<D / 2>(dk);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
    }

    store_rows<D>(static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh,
                  p.dk_ss, dk, krow, p.Skv, t4);
    store_rows<D>(static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh,
                  p.dv_ss, dv, krow, p.Skv, t4);
  }
}

// Shared-memory plan of the dq kernel: Q, dO, the K ring, the V ring, the
// barriers.
template <int D>
struct DqPlan {
  static constexpr int BQ = 128, BK = 64, STAGES = 2;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int Q_OFF = 0, DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;
  static constexpr int SMEM = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(384, 1)
dq_bf16_wgmma(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap do_map, Params p) {
  using P = DqPlan<D>;
  constexpr int BQ = P::BQ, BK = P::BK, S = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + S;
  uint64_t* empty = bars + 1 + 2 * S;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = h / (p.H / p.KVH);
  const int kv_end = kv_limit(p, min(q0 + BQ, p.Sq));
  const int n_kv = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    hopper::regs_dec<24>();
    if (threadIdx.x == 0 && n_kv > 0) {
      hopper::prefetch_tmap(&q_map);
      hopper::prefetch_tmap(&k_map);
      hopper::prefetch_tmap(&v_map);
      hopper::prefetch_tmap(&do_map);
      hopper::mbar_expect_tx(q_full, 2 * P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(smem + P::Q_OFF + c * BQ * 128, &q_map, q_full,
                            c * 64, q0, h, b);
        hopper::tma_load_4d(smem + P::DO_OFF + c * BQ * 128, &do_map,
                            q_full, c * 64, q0, h, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % S;
        if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        uint8_t* ks = smem + P::K_OFF + s * P::KV_BYTES;
        uint8_t* vs = smem + P::V_OFF + s * P::KV_BYTES;
        hopper::mbar_expect_tx(&k_full[s], P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_4d(ks + c * BK * 128, &k_map, &k_full[s], c * 64,
                              it * BK, kvh, b);
        hopper::mbar_expect_tx(&v_full[s], P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_4d(vs + c * BK * 128, &v_map, &v_full[s], c * 64,
                              it * BK, kvh, b);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    hopper::regs_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int q_first = q0 + cw * 64;          // first row of this group
    const int row0 = q_first + warp * 16 + g;  // rows row0 and row0 + 8
    const uint32_t q_base =
        hopper::smem_u32(smem + P::Q_OFF) + cw * 64 * 128;
    const uint32_t do_base =
        hopper::smem_u32(smem + P::DO_OFF) + cw * 64 * 128;
    const float sl2 = p.scale * kLog2e;

    // Prologue, while the loads fly: lse (times log2 e) and Delta =
    // rowsum(dO * O) of rows row0 and row0 + 8 in f32, the 4 threads of a
    // row reading 16 bytes at a time; Delta goes out for the dk/dv
    // kernel. Rows past Sq take 0 (finite, and masked).
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      const bool in = qi < p.Sq;
      float acc = 0.f;
      if (in) {
        const bf16* dor = static_cast<const bf16*>(p.dout) + b * p.do_sb +
                          h * p.do_sh + qi * p.do_ss;
        const bf16* orow = static_cast<const bf16*>(p.o) + b * p.o_sb +
                           h * p.o_sh + qi * p.o_ss;
#pragma unroll
        for (int c = t4; c < D / 8; c += 4) {
          const uint4 x = *reinterpret_cast<const uint4*>(dor + 8 * c);
          const uint4 y = *reinterpret_cast<const uint4*>(orow + 8 * c);
          const __nv_bfloat162* xs =
              reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* ys =
              reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 fx = __bfloat1622float2(xs[j]);
            const float2 fy = __bfloat1622float2(ys[j]);
            acc = fmaf(fx.x, fy.x, acc);
            acc = fmaf(fx.y, fy.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dlt[r] = acc;
      lse2[r] = in ? p.lse[row_stat(p, b, h, qi)] * kLog2e : 0.f;
      if (in && t4 == 0) p.delta[row_stat(p, b, h, qi)] = acc;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (n_kv > 0) hopper::mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % S;
      const uint32_t par = (it / S) & 1;
      const int k0 = it * BK;
      const uint32_t k_base =
          hopper::smem_u32(smem + P::K_OFF + s * P::KV_BYTES);
      const uint32_t v_base =
          hopper::smem_u32(smem + P::V_OFF + s * P::KV_BYTES);
      // Both waits even for a tile this group skips: a slot is refilled
      // only after both groups are done with it.
      hopper::mbar_wait(&k_full[s], par);
      hopper::mbar_wait(&v_full[s], par);
      if (!all_masked(p, q_first, k0)) {
        // S = Q K^T and dP = dO V^T: 64 q rows x BK kv columns.
        float sc[BK / 2], dp[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
        hopper::fence_regs<BK / 2>(sc);
        hopper::fence_regs<BK / 2>(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_ss(sc, k_major<BQ>(q_base, kk),
                                     k_major<BK>(k_base, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_ss(dp, k_major<BQ>(do_base, kk),
                                     k_major<BK>(v_base, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<BK / 2>(sc);
        hopper::fence_regs<BK / 2>(dp);

        // dS in place of dP. Element i sits at row row0 + 8 * ((i / 2) %
        // 2), column k0 + 8 * (i / 4) + 2 * t4 + i % 2.
        const bool mask = some_masked(p, q_first, k0);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i / 2) % 2;
          float pe = hopper::exp2_approx(fmaf(sc[i], sl2, -lse2[r]));
          if (mask && !visible(p, row0 + 8 * r, k0 + 8 * (i / 4) + 2 * t4 +
                                                    i % 2))
            pe = 0.f;
          dp[i] = pe * (dp[i] - dlt[r]) * p.scale;
        }

        // dQ += dS K, dS rounded to K's type (as `_dq_kernel`); K is
        // [kv][D], read MN-major.
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) hopper::acc_to_a(dp, kk, da[kk]);
        hopper::fence_regs<D / 2>(dq);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          rs_tb<D>(dq, da[kk], mn_major<BK>(k_base, kk));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<D / 2>(dq);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    store_rows<D>(static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh,
                  p.dq_ss, dq, row0, p.Sq, t4);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs (no TF32 rounding). 4 threads per owned row; the
// thread (r, c4) takes columns c4, c4 + 4, ... of every row-wise sweep.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_rows_f32(float* dst, int rs,
                                              const float* src, long long gs,
                                              int r_begin, int r_end,
                                              int rows, int D, int tid) {
  for (int c = tid; c < rows * D; c += 128) {
    int r = c / D, d = c % D;
    dst[r * rs + d] = (r_begin + r < r_end) ? src[(r_begin + r) * gs + d]
                                            : 0.f;
  }
}

struct DqF32 {
  static constexpr int BQ = 32, BK = 64;
  template <int D>
  static constexpr int smem() {
    // Qs, dOs [32][D + 1]; Ks, Vs [64][D + 1]; dS [32][64 + 1]
    return (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(128)
dq_f32_fma(Params p) {
  constexpr int BQ = DqF32::BQ, BK = DqF32::BK, RS = D + 1, SS = BK + 1;
  constexpr int NJ = BK / 4, ND = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQ][RS]
  float* dOs = Qs + BQ * RS;                   // [BQ][RS]
  float* Ks = dOs + BQ * RS;                   // [BK][RS]
  float* Vs = Ks + BK * RS;                    // [BK][RS]
  float* dSs = Vs + BK * RS;                   // [BQ][SS]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int qi = q0 + r;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_rows_f32(Qs, RS, qg, p.q_ss, q0, p.Sq, BQ, D, tid);
  load_rows_f32(dOs, RS, dog, p.do_ss, q0, p.Sq, BQ, D, tid);
  const bool in = qi < p.Sq;
  const float lse = in ? p.lse[row_stat(p, b, h, qi)] : 0.f;
  // Delta = rowsum(dO * O) of row qi, from the row's 4 threads; it goes
  // out for the dk/dv kernel.
  float dlt = 0.f;
  if (in) {
    const float* dor = dog + qi * p.do_ss;
    const float* orow = static_cast<const float*>(p.o) + b * p.o_sb +
                        h * p.o_sh + qi * p.o_ss;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      dlt = fmaf(dor[c4 + 4 * i], orow[c4 + 4 * i], dlt);
  }
  dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
  dlt += __shfl_xor_sync(0xffffffffu, dlt, 2);
  if (in && c4 == 0) p.delta[row_stat(p, b, h, qi)] = dlt;

  float dq[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dq[i] = 0.f;
  const int kv_end = kv_limit(p, min(q0 + BQ, p.Sq));

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_rows_f32(Ks, RS, kg, p.k_ss, k0, p.Skv, BK, D, tid);
    load_rows_f32(Vs, RS, vg, p.v_ss, k0, p.Skv, BK, D, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      int j = c4 + 4 * i;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[r * RS + d], Ks[j * RS + d], s);
        dp = fmaf(dOs[r * RS + d], Vs[j * RS + d], dp);
      }
      float pe = visible(p, qi, k0 + j) ? expf(s * p.scale - lse) : 0.f;
      dSs[r * SS + j] = pe * (dp - dlt) * p.scale;
    }
    __syncwarp();  // row r's dS comes from 4 lanes of this warp
    for (int j = 0; j < BK; ++j) {
      float ds = dSs[r * SS + j];
#pragma unroll
      for (int i = 0; i < ND; ++i)
        dq[i] = fmaf(ds, Ks[j * RS + c4 + 4 * i], dq[i]);
    }
  }

  if (in) {
    float* row = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
                 qi * p.dq_ss;
#pragma unroll
    for (int i = 0; i < ND; ++i) row[c4 + 4 * i] = dq[i];
  }
}

struct DkvF32 {
  static constexpr int BK = 32, BQ = 64;
  template <int D>
  static constexpr int smem() {
    // Ks, Vs [32][D + 1]; Qs, dOs [64][D + 1]; P, dS [32][64 + 1];
    // lse, Delta [64]
    return (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) +
            2 * BQ) * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(128)
dkv_f32_fma(Params p) {
  constexpr int BK = DkvF32::BK, BQ = DkvF32::BQ, RS = D + 1, SS = BQ + 1;
  constexpr int NJ = BQ / 4, ND = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [BK][RS]
  float* Vs = Ks + BK * RS;                    // [BK][RS]
  float* Qs = Vs + BK * RS;                    // [BQ][RS]
  float* dOs = Qs + BQ * RS;                   // [BQ][RS]
  float* Ps = dOs + BQ * RS;                   // [BK][SS]
  float* dSs = Ps + BK * SS;                   // [BK][SS]
  float* ls = dSs + BK * SS;                   // [BQ]
  float* dl = ls + BQ;                         // [BQ]

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int kj = k0 + r;

  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_rows_f32(Ks, RS, kg, p.k_ss, k0, p.Skv, BK, D, tid);
  load_rows_f32(Vs, RS, vg, p.v_ss, k0, p.Skv, BK, D, tid);

  float dk[ND], dv[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dk[i] = dv[i] = 0.f;
  const int i_first = q_start(p, k0) / BQ * BQ;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qg =
        static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dog =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int i0 = i_first; i0 < p.Sq; i0 += BQ) {
      __syncthreads();
      load_rows_f32(Qs, RS, qg, p.q_ss, i0, p.Sq, BQ, D, tid);
      load_rows_f32(dOs, RS, dog, p.do_ss, i0, p.Sq, BQ, D, tid);
      if (tid < BQ) {
        bool in = i0 + tid < p.Sq;
        ls[tid] = in ? p.lse[row_stat(p, b, h, i0 + tid)] : 0.f;
        dl[tid] = in ? p.delta[row_stat(p, b, h, i0 + tid)] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        int j = c4 + 4 * i;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(Ks[r * RS + d], Qs[j * RS + d], s);
          dp = fmaf(Vs[r * RS + d], dOs[j * RS + d], dp);
        }
        float pe = visible(p, i0 + j, kj) ? expf(s * p.scale - ls[j]) : 0.f;
        Ps[r * SS + j] = pe;
        dSs[r * SS + j] = pe * (dp - dl[j]) * p.scale;
      }
      __syncwarp();  // kv row r's P and dS come from 4 lanes of this warp
      for (int j = 0; j < BQ; ++j) {
        float pj = Ps[r * SS + j], dsj = dSs[r * SS + j];
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          dv[i] = fmaf(pj, dOs[j * RS + c4 + 4 * i], dv[i]);
          dk[i] = fmaf(dsj, Qs[j * RS + c4 + 4 * i], dk[i]);
        }
      }
    }
  }

  if (kj < p.Skv) {
    float* krow = static_cast<float*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh +
                  kj * p.dk_ss;
    float* vrow = static_cast<float*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh +
                  kj * p.dv_ss;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      krow[c4 + 4 * i] = dk[i];
      vrow[c4 + 4 * i] = dv[i];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A bf16 kernel: tensor maps over q, k, v and dO as they lie in memory,
// the q-side ones (q, dO) in boxes of `q_rows` rows and the kv-side ones
// in boxes of `kv_rows`; 384 threads a block.
template <typename Kernel>
int launch_bf16(Kernel kernel, int smem, dim3 grid, int q_rows, int kv_rows,
                const Params& p, int B, int D, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  // A length of 0 still needs a valid map; no tile of it is loaded.
  const int sq = p.Sq > 0 ? p.Sq : 1, skv = p.Skv > 0 ? p.Skv : 1;
  if (hopper::encode_bshd(&qm, p.q, B, sq, p.H, D, p.q_sb, p.q_ss, p.q_sh,
                          q_rows) ||
      hopper::encode_bshd(&dom, p.dout, B, sq, p.H, D, p.do_sb, p.do_ss,
                          p.do_sh, q_rows) ||
      hopper::encode_bshd(&km, p.k, B, skv, p.KVH, D, p.k_sb, p.k_ss,
                          p.k_sh, kv_rows) ||
      hopper::encode_bshd(&vm, p.v, B, skv, p.KVH, D, p.v_sb, p.v_ss,
                          p.v_sh, kv_rows))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 384, smem, stream>>>(qm, km, vm, dom, p);
  return cudaGetLastError();
}

template <int D>
int launch_dq_bf16(const Params& p, int B, cudaStream_t stream) {
  using P = DqPlan<D>;
  return launch_bf16(dq_bf16_wgmma<D>, P::SMEM,
                     dim3(p.H, B, ceil_div(p.Sq, P::BQ)), P::BQ, P::BK, p, B,
                     D, stream);
}

template <int D>
int launch_dkv_bf16(const Params& p, int B, cudaStream_t stream) {
  using P = DkvPlan<D>;
  return launch_bf16(dkv_bf16_wgmma<D>, P::SMEM,
                     dim3(p.KVH, B, ceil_div(p.Skv, P::BK)), P::BQ, P::BK, p,
                     B, D, stream);
}

}  // namespace

// Both entry points take the same arguments; dq uses `out` and `dq` and
// writes `delta`, dkv reads `delta` and uses `dk` and `dv`, so dkv is
// launched after dq on the same stream. dtype: 0 = float32,
// 1 = bfloat16. Strides are in elements; the last (head-dim) stride is 1;
// for bf16 the base pointers are 16-byte aligned and the other strides
// multiples of 8. lse and delta are contiguous (B, H, Sq) f32. Returns a
// cudaError_t (0 on success), -1 for a dtype / head size the kernels do
// not take, or -2 for bf16 operands that cuTensorMapEncodeTiled refuses
// as tensor maps.
#define BWD_ARGS                                                           \
  const void *q, const void *k, const void *v, const void *dout,           \
      const void *out, const float *lse, float *delta, void *dq, void *dk, \
      void *dv, int dtype, int B, int H, int KVH, int Sq, int Skv, int D,  \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,      \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,      \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,   \
      long long o_sb, long long o_ss, long long o_sh, long long dq_sb,     \
      long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,  \
      long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,  \
      float scale, int q_off, int kv_off, int causal, void *stream

#define BWD_PARAMS                                                         \
  Params p{q,     k,     v,     dout,  out,   lse,   delta, dq,    dk,     \
           dv,    H,     KVH,   Sq,    Skv,   q_sb,  q_ss,  q_sh,  k_sb,   \
           k_ss,  k_sh,  v_sb,  v_ss,  v_sh,  do_sb, do_ss, do_sh, o_sb,   \
           o_ss,  o_sh,  dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb,  \
           dv_ss, dv_sh, scale, q_off, kv_off, causal};                    \
  cudaStream_t s = static_cast<cudaStream_t>(stream)

extern "C" int flash_attn_bwd_dq(BWD_ARGS) {
  BWD_PARAMS;
  if (B == 0 || Sq == 0) return 0;
  if (dtype == 1) {
    if (D == 128) return launch_dq_bf16<128>(p, B, s);
    if (D == 64) return launch_dq_bf16<64>(p, B, s);
  } else if (dtype == 0) {
    dim3 grid(ceil_div(Sq, DqF32::BQ), H, B);
    if (D == 128)
      return launch(dq_f32_fma<128>, DqF32::smem<128>(), grid, p, s);
    if (D == 64)
      return launch(dq_f32_fma<64>, DqF32::smem<64>(), grid, p, s);
  }
  return -1;
}

extern "C" int flash_attn_bwd_dkv(BWD_ARGS) {
  BWD_PARAMS;
  if (B == 0 || Skv == 0) return 0;
  if (dtype == 1) {
    if (D == 128) return launch_dkv_bf16<128>(p, B, s);
    if (D == 64) return launch_dkv_bf16<64>(p, B, s);
  } else if (dtype == 0) {
    dim3 grid(ceil_div(Skv, DkvF32::BK), KVH, B);
    if (D == 128)
      return launch(dkv_f32_fma<128>, DkvF32::smem<128>(), grid, p, s);
    if (D == 64)
      return launch(dkv_f32_fma<64>, DkvF32::smem<64>(), grid, p, s);
  }
  return -1;
}
