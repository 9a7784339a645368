// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Two kernels, the counterparts of the two TPU kernels that
// ray_tpu/ops/flash_attention.py's `_bwd_impl` launches through
// pl.pallas_call:
//   * dq  replaces `_dq_kernel`  (flash_attention.py:168, launch :308);
//   * dkv replaces `_dkv_kernel` (flash_attention.py:219, launch :326).
// Both recompute P = exp(Q K^T * scale - lse) from the forward's lse
// under the causal mask on global positions, (q_off + i) >= (kv_off + j),
// and use Delta = rowsum(dO * O), which the wrapper computes (as
// `_bwd_impl` does, outside any kernel). With dP = dO V^T and
// dS = P * (dP - Delta) * scale:
//   dQ = sum_j dS K,  dV = sum_i P^T dO,  dK = sum_i dS^T Q.
// As in the Pallas kernels, P is rounded to dO's type before P^T dO
// (:251) and dS to the input type before dS K and dS^T Q (:201, :256);
// the sums are f32.
//
// What bounds it on this card. Per visible (query, key) pair dq does
// three products of length D (Q K^T, dO V^T, dS K: 6*D FLOPs) and dkv
// four (8*D FLOPs), against bytes (q, k, v, dO, lse, Delta read once,
// dq / dk / dv written once) that grow only as S. At the training shape
// (llama-654m: 8 x 1024 tokens, 12 query over 4 KV heads, D 128) that is
// ~3.9e10 and ~5.2e10 FLOPs against ~40 MB: far above the ~295 bf16
// FLOPs per byte where the tensor cores (989 TFLOP/s), not the memory
// (3.35 TB/s), become the limit. Both kernels are bound by operations.
//
// What the design does about that:
//   * bf16 (the training path): every product on the tensor cores with
//     mma.sync m16n8k16 and f32 accumulators; the score tiles stay in
//     registers and are re-packed there (rounded to bf16) as the A
//     operand of the next product, so P and dS never leave the SM.
//   * dq: one block of 4 warps per (batch, head, 64-row query tile),
//     16 rows a warp; a loop over 64-row kv tiles up to the diagonal
//     replaces the TPU's sequential kv grid axis, and dQ stays in f32
//     registers until the one store. The block reads KV head
//     h / (H / KVH) in place: no expanded copy of K or V.
//   * dkv: one block of 4 warps per (batch, KV head, 64-row kv tile). It
//     loops over the H / KVH query heads of its group and, per head,
//     over the 32-row query tiles at or below the diagonal, accumulating
//     dK and dV in f32 registers; it writes (B, Skv, KVH, D) directly.
//     That loop is the group sum that the gradient of `jnp.repeat` does
//     in the JAX package. It was chosen over per-head dK/dV followed by
//     a sum because it needs no (B, Skv, H, D) f32 scratch (3x the
//     output at GQA 12/4), no second pass and no atomics, and it sums
//     the group in f32 in a fixed order: the result is the same from
//     run to run. The price is that one block does G times the work of
//     a per-head block (fewer, longer blocks: 8 x 4 x 16 = 512 at the
//     training shape, ~4 waves on 132 SMs).
//   * Operands whose B fragment needs the reduction dimension
//     contiguous (K for dS K; Q and dO for dS^T Q and P^T dO) are also
//     staged transposed in shared memory, written with neighbouring
//     threads on neighbouring rows so the 2-byte stores do not collide.
//   * f32 (the exact comparison): the same tiling on the CUDA cores with
//     f32 FMAs, so f32 results are not rounded to TF32.
//   * Masking is a select, never a multiply: exp(s - lse) of a masked
//     score can be inf (a row that sees no key has lse ~ -1e30), and
//     inf * 0 is NaN. Ragged rows and columns load as zeros, are masked
//     out and are never stored.
// This is the simple first kernel; wgmma, TMA and a pipelined smem ring
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  int H, KVH, Sq, Skv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of a 16-row slice of a row-major smem tile (row stride rs),
// rows r0..r0+15, reduction columns kk..kk+15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int rs, int r0, int kk, int g,
                                       int t4) {
  const bf16* x = tile + (r0 + g) * rs + kk + t4 * 2;
  a[0] = ld32(x);
  a[1] = ld32(x + 8 * rs);
  a[2] = ld32(x + 8);
  a[3] = ld32(x + 8 * rs + 8);
}

// A fragment from the f32 C fragments of two neighbouring 8-column
// n-tiles (columns 16c..16c+15), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x0)[4],
                                       const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

// Copy `rows` rows of a (row stride gs) global bf16 tile starting at row
// r_begin into smem row-major (stride rs), zero-filling rows >= r_end.
template <int D, int NTHREADS>
__device__ __forceinline__ void load_rows(bf16* dst, int rs, const bf16* src,
                                          long long gs, int r_begin,
                                          int r_end, int rows, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < rows * CH; c += NTHREADS) {
    int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r_begin + r < r_end)
      val = *reinterpret_cast<const uint4*>(src + (r_begin + r) * gs + col);
    *reinterpret_cast<uint4*>(dst + r * rs + col) = val;
  }
}

// The same copy, also stored transposed (dst_t[d][r], stride ts). Threads
// walk rows fastest so the transposed 2-byte stores hit distinct banks.
template <int D, int NTHREADS>
__device__ __forceinline__ void load_rows_t(bf16* dst, int rs, bf16* dst_t,
                                            int ts, const bf16* src,
                                            long long gs, int r_begin,
                                            int r_end, int rows, int tid) {
  constexpr int CH = D / 8;
  for (int c = tid; c < rows * CH; c += NTHREADS) {
    int r = c % rows, col = (c / rows) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r_begin + r < r_end)
      val = *reinterpret_cast<const uint4*>(src + (r_begin + r) * gs + col);
    *reinterpret_cast<uint4*>(dst + r * rs + col) = val;
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst_t[(col + i) * ts + r] = e[i];
  }
}

struct DqBf16 {
  static constexpr int BQ = 64, BK = 64, PAD = 8;
  template <int D>
  static constexpr int smem() {
    // Qs, dOs [64][D + 8]; Ks, Vs [64][D + 8]; Kt [D][64 + 8]
    return (2 * BQ * (D + PAD) + 2 * BK * (D + PAD) + D * (BK + PAD)) * 2;
  }
};

template <int D>
__global__ void __launch_bounds__(128)
dq_bf16_mma(Params p) {
  constexpr int BQ = DqBf16::BQ, BK = DqBf16::BK, PAD = DqBf16::PAD;
  constexpr int RS = D + PAD, TS = BK + PAD;
  constexpr int NT = BK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][RS]
  bf16* dOs = Qs + BQ * RS;                  // [BQ][RS]
  bf16* Ks = dOs + BQ * RS;                  // [BK][RS]
  bf16* Vs = Ks + BK * RS;                   // [BK][RS]
  bf16* Kt = Vs + BK * RS;                   // [D][TS]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_rows<D, 128>(Qs, RS, qg, p.q_ss, q0, p.Sq, BQ, tid);
  load_rows<D, 128>(dOs, RS, dog, p.do_ss, q0, p.Sq, BQ, tid);
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int qi = q0 + row0 + 8 * r;
    bool in = qi < p.Sq;
    lse[r] = in ? p.lse[row_stat(p, b, h, qi)] : 0.f;
    dlt[r] = in ? p.delta[row_stat(p, b, h, qi)] : 0.f;
  }

  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const int kv_end = kv_limit(p, min(q0 + BQ, p.Sq));

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile consumed (and Q, dO stored)
    load_rows_t<D, 128>(Ks, RS, Kt, TS, kg, p.k_ss, k0, p.Skv, BK, tid);
    load_rows<D, 128>(Vs, RS, vg, p.v_ss, k0, p.Skv, BK, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BK columns.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ao[4];
      load_a(aq, Qs, RS, warp * 16, kk, g, t4);
      load_a(ao, dOs, RS, warp * 16, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kb = Ks + (nt * 8 + g) * RS + kk + t4 * 2;
        const bf16* vb = Vs + (nt * 8 + g) * RS + kk + t4 * 2;
        mma_bf16(s[nt], aq, ld32(kb), ld32(kb + 8));
        mma_bf16(dp[nt], ao, ld32(vb), ld32(vb + 8));
      }
    }

    // dS, in place of S. Element e of n-tile nt sits at row
    // row0 + 8*(e>>1), column k0 + nt*8 + t4*2 + (e&1).
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = e >> 1;
        int qi = q0 + row0 + 8 * r;
        int kj = k0 + nt * 8 + t4 * 2 + (e & 1);
        float pe = visible(p, qi, kj) ? expf(s[nt][e] * p.scale - lse[r])
                                      : 0.f;
        s[nt][e] = pe * (dp[nt][e] - dlt[r]) * p.scale;
      }

    // dQ += dS K, with dS rounded to bf16 (K's type, as `_dq_kernel`).
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[4];
      pack_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int nd = 0; nd < DT; ++nd) {
        const bf16* kb = Kt + (nd * 8 + g) * TS + c * 16 + t4 * 2;
        mma_bf16(dq[nd], a, ld32(kb), ld32(kb + 8));
      }
    }
  }

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int qi = q0 + row0 + 8 * r;
    if (qi >= p.Sq) continue;
    bf16* row = dqg + qi * p.dq_ss;
#pragma unroll
    for (int nd = 0; nd < DT; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(row + nd * 8 + t4 * 2) =
          __floats2bfloat162_rn(dq[nd][2 * r], dq[nd][2 * r + 1]);
  }
}

struct DkvBf16 {
  static constexpr int BK = 64, BQ = 32, PAD = 8;
  template <int D>
  static constexpr int smem() {
    // Ks, Vs [64][D + 8]; Qs, dOs [32][D + 8]; Qt, dOt [D][32 + 8];
    // lse, Delta [32] f32
    return (2 * BK * (D + PAD) + 2 * BQ * (D + PAD) + 2 * D * (BQ + PAD)) *
               2 + 2 * BQ * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(128)
dkv_bf16_mma(Params p) {
  constexpr int BK = DkvBf16::BK, BQ = DkvBf16::BQ, PAD = DkvBf16::PAD;
  constexpr int RS = D + PAD, TS = BQ + PAD;
  constexpr int NT = BQ / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BK][RS]
  bf16* Vs = Ks + BK * RS;                   // [BK][RS]
  bf16* Qs = Vs + BK * RS;                   // [BQ][RS]
  bf16* dOs = Qs + BQ * RS;                  // [BQ][RS]
  bf16* Qt = dOs + BQ * RS;                  // [D][TS]
  bf16* dOt = Qt + D * TS;                   // [D][TS]
  float* ls = reinterpret_cast<float*>(dOt + D * TS);  // [BQ]
  float* dl = ls + BQ;                                 // [BQ]

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int krow0 = warp * 16 + g;  // this thread's kv rows: +0, +8

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_rows<D, 128>(Ks, RS, kg, p.k_ss, k0, p.Skv, BK, tid);
  load_rows<D, 128>(Vs, RS, vg, p.v_ss, k0, p.Skv, BK, tid);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int i_first = q_start(p, k0) / BQ * BQ;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dog =
        static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int i0 = i_first; i0 < p.Sq; i0 += BQ) {
      __syncthreads();  // previous q tile consumed (and K, V stored)
      load_rows_t<D, 128>(Qs, RS, Qt, TS, qg, p.q_ss, i0, p.Sq, BQ, tid);
      load_rows_t<D, 128>(dOs, RS, dOt, TS, dog, p.do_ss, i0, p.Sq, BQ,
                          tid);
      if (tid < BQ) {
        bool in = i0 + tid < p.Sq;
        ls[tid] = in ? p.lse[row_stat(p, b, h, i0 + tid)] : 0.f;
        dl[tid] = in ? p.delta[row_stat(p, b, h, i0 + tid)] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 kv rows x BQ q.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ak[4], av[4];
        load_a(ak, Ks, RS, warp * 16, kk, g, t4);
        load_a(av, Vs, RS, warp * 16, kk, g, t4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* qb = Qs + (nt * 8 + g) * RS + kk + t4 * 2;
          const bf16* ob = dOs + (nt * 8 + g) * RS + kk + t4 * 2;
          mma_bf16(s[nt], ak, ld32(qb), ld32(qb + 8));
          mma_bf16(dp[nt], av, ld32(ob), ld32(ob + 8));
        }
      }

      // P^T in place of S^T, dS^T in place of dP^T. Element e of n-tile
      // nt sits at kv row k0 + krow0 + 8*(e>>1), q column
      // i0 + nt*8 + t4*2 + (e&1).
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int kj = k0 + krow0 + 8 * (e >> 1);
          int qc = nt * 8 + t4 * 2 + (e & 1);
          float pe = visible(p, i0 + qc, kj)
                         ? expf(s[nt][e] * p.scale - ls[qc]) : 0.f;
          s[nt][e] = pe;
          dp[nt][e] = pe * (dp[nt][e] - dl[qc]) * p.scale;
        }

      // dV += P^T dO (P rounded to dO's type), dK += dS^T Q (dS rounded
      // to Q's type), as `_dkv_kernel`.
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        uint32_t ap[4], ad[4];
        pack_a(ap, s[2 * c], s[2 * c + 1]);
        pack_a(ad, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
        for (int nd = 0; nd < DT; ++nd) {
          const bf16* ob = dOt + (nd * 8 + g) * TS + c * 16 + t4 * 2;
          const bf16* qb = Qt + (nd * 8 + g) * TS + c * 16 + t4 * 2;
          mma_bf16(dv[nd], ap, ld32(ob), ld32(ob + 8));
          mma_bf16(dk[nd], ad, ld32(qb), ld32(qb + 8));
        }
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int kj = k0 + krow0 + 8 * r;
    if (kj >= p.Skv) continue;
    bf16* krow = dkg + kj * p.dk_ss;
    bf16* vrow = dvg + kj * p.dv_ss;
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(krow + nd * 8 + t4 * 2) =
          __floats2bfloat162_rn(dk[nd][2 * r], dk[nd][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + nd * 8 + t4 * 2) =
          __floats2bfloat162_rn(dv[nd][2 * r], dv[nd][2 * r + 1]);
    }
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
  const float dlt = in ? p.delta[row_stat(p, b, h, qi)] : 0.f;

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

}  // namespace

// Both entry points take the same arguments; dq uses `dq`, dkv uses `dk`
// and `dv`. dtype: 0 = float32, 1 = bfloat16. Strides are in elements;
// the last (head-dim) stride is 1. lse and delta are contiguous
// (B, H, Sq) f32. Returns a cudaError_t (0 on success), or -1 for a
// dtype / head size the kernels do not take.
#define BWD_ARGS                                                           \
  const void *q, const void *k, const void *v, const void *dout,           \
      const float *lse, const float *delta, void *dq, void *dk, void *dv,  \
      int dtype, int B, int H, int KVH, int Sq, int Skv, int D,            \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,      \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,      \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,   \
      long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,  \
      long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,  \
      long long dv_sh, float scale, int q_off, int kv_off, int causal,     \
      void *stream

#define BWD_PARAMS                                                          \
  Params p{q,     k,     v,     dout,  lse,   delta, dq,    dk,    dv,     \
           H,     KVH,   Sq,    Skv,   q_sb,  q_ss,  q_sh,  k_sb,  k_ss,   \
           k_sh,  v_sb,  v_ss,  v_sh,  do_sb, do_ss, do_sh, dq_sb, dq_ss,  \
           dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale, q_off,  \
           kv_off, causal};                                                 \
  cudaStream_t s = static_cast<cudaStream_t>(stream)

extern "C" int flash_attn_bwd_dq(BWD_ARGS) {
  BWD_PARAMS;
  if (B == 0 || Sq == 0) return 0;
  if (dtype == 1) {
    dim3 grid(ceil_div(Sq, DqBf16::BQ), H, B);
    if (D == 128)
      return launch(dq_bf16_mma<128>, DqBf16::smem<128>(), grid, p, s);
    if (D == 64)
      return launch(dq_bf16_mma<64>, DqBf16::smem<64>(), grid, p, s);
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
    dim3 grid(ceil_div(Skv, DkvBf16::BK), KVH, B);
    if (D == 128)
      return launch(dkv_bf16_mma<128>, DkvBf16::smem<128>(), grid, p, s);
    if (D == 64)
      return launch(dkv_bf16_mma<64>, DkvBf16::smem<64>(), grid, p, s);
  } else if (dtype == 0) {
    dim3 grid(ceil_div(Skv, DkvF32::BK), KVH, B);
    if (D == 128)
      return launch(dkv_f32_fma<128>, DkvF32::smem<128>(), grid, p, s);
    if (D == 64)
      return launch(dkv_f32_fma<64>, DkvF32::smem<64>(), grid, p, s);
  }
  return -1;
}
