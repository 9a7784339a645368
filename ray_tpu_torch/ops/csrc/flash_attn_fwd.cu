// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of ray_tpu/ops/flash_attention.py
// (launched by `_fwd_impl` through pl.pallas_call). It computes the same
// function: online-softmax attention with a running row max m, row sum l
// and an f32 output accumulator; the causal mask is on global positions,
// (q_offset + i) >= (kv_offset + j); kv tiles wholly above the diagonal
// are skipped; masked probabilities are exactly 0 (a row that sees no key
// gives 0), l is clamped at 1e-30, and lse = m + log(l), in natural log.
//
// What bounds it on this card. The work is 4*B*H*Sq*Skv*D FLOPs, about
// halved by the causal mask, against bytes (q, k, v read once, o and lse
// written once) that grow only as S. The H100 needs ~295 bf16 FLOPs per
// byte before its tensor cores (989 TFLOP/s), not its memory (3.35 TB/s),
// are the limit. An 8-prompt prefill tile with 32 query heads over 8 KV
// heads at head dim 128 does ~204 FLOPs/byte at S=512 (bound by bytes,
// just) and ~410 at S=1024 (bound by operations); longer prompts are
// more and more bound by operations.
//
// What the design does about that:
//   * bf16 (serving and training): a warp-specialised block of three
//     warpgroups per (128-row query tile, head, batch). One thread of the
//     producer warpgroup issues TMA loads: Q once, then K and V tiles of
//     128 rows into a 2-stage ring in shared memory, each stage with full
//     barriers for K and V and an empty barrier the consumers release;
//     the producer gives its registers to the consumers (setmaxnreg).
//     Each of the two consumer warpgroups owns 64 query rows and runs
//     S = Q K^T as wgmma with both operands in shared memory (K in its
//     natural [kv][D] layout is the K-major B operand), the online
//     softmax in registers with exp2 and sm_scale*log2(e) folded into one
//     multiply, then O += P V as wgmma with P repacked from the score
//     accumulator into bf16 register A operands and V read MN-major
//     through the transpose bit (no transposed copy of V). Only tiles
//     that straddle the diagonal or the ragged kv edge evaluate the mask.
//     Query tiles run heaviest first (causal) to trim the tail.
//   * f32 (the exact comparison): a 32-row query tile on the CUDA cores
//     with f32 FMAs (4 threads a row), so f32 results are not rounded to
//     TF32.
//   * GQA without a repeat: the block reads KV head h / (H / KVH).
//   * Strided (B, S, H, D) operands are read in place: the bf16 tensor
//     maps carry the tensors' own strides, the f32 loads index them.
//   * Ragged Sq/Skv: out-of-range rows load as zeros (TMA fills them),
//     are masked out of the softmax, and are never stored.
// The Hopper building blocks (mbarriers, TMA, wgmma descriptors, the
// accumulator-to-A repack) are in hopper.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, KVH, Sq, Skv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int q_off, kv_off, causal;
};

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  // qi: query row in [0, Sq) space, kj: kv row (may be >= Skv).
  if (kj >= p.Skv) return false;
  return !p.causal || (p.q_off + qi >= p.kv_off + kj);
}

// Number of kv rows some query row of [q0, q_end) may see.
__device__ __forceinline__ int kv_limit(const Params& p, int q_end) {
  if (!p.causal) return p.Skv;
  int last_q = p.q_off + q_end - 1;
  int n = last_q - p.kv_off + 1;
  return n < p.Skv ? n : p.Skv;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised, TMA + wgmma
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory plan of the bf16 kernel (byte offsets from a 1024-byte-
// aligned base): Q, then the K ring, then the V ring, then the barriers.
template <int D>
struct Plan {
  static constexpr int BQ = 128, BK = 128, STAGES = 2;
  static constexpr int TILE = 128 * 128;  // bytes of 128 rows x 64 bf16
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;
  static constexpr int SMEM = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(384, 1)
fwd_bf16_wgmma(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, Params p) {
  using P = Plan<D>;
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
  const int q_end = min(q0 + BQ, p.Sq);
  const int kv_end = kv_limit(p, q_end);
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
    if (threadIdx.x == 0) {
      hopper::prefetch_tmap(&q_map);
      hopper::prefetch_tmap(&k_map);
      hopper::prefetch_tmap(&v_map);
      hopper::mbar_expect_tx(q_full, P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(smem + c * P::TILE, &q_map, q_full, c * 64, q0,
                            h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % S;
        if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        uint8_t* ks = smem + P::K_OFF + s * P::KV_BYTES;
        uint8_t* vs = smem + P::V_OFF + s * P::KV_BYTES;
        hopper::mbar_expect_tx(&k_full[s], P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_4d(ks + c * P::TILE, &k_map, &k_full[s], c * 64,
                              it * BK, kvh, b);
        hopper::mbar_expect_tx(&v_full[s], P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_4d(vs + c * P::TILE, &v_map, &v_full[s], c * 64,
                              it * BK, kvh, b);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    hopper::regs_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int q_first = q0 + cw * 64;   // first row of this warpgroup
    const int row0 = q_first + warp * 16 + g;  // rows row0 and row0 + 8
    const uint32_t q_base = hopper::smem_u32(smem) + cw * 64 * 128;
    const float sl2 = p.scale * kLog2e;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // Running max (in units of scale * log2(e)) and this thread's part of
    // the row sum (its quad holds the rest).
    float m2[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % S;
      const uint32_t par = (it / S) & 1;
      const int k0 = it * BK;
      const uint32_t k_base =
          hopper::smem_u32(smem + P::K_OFF + s * P::KV_BYTES);
      const uint32_t v_base =
          hopper::smem_u32(smem + P::V_OFF + s * P::KV_BYTES);

      // S = Q K^T: 64 x BK, depth D in steps of 16.
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      hopper::mbar_wait(&k_full[s], par);
      hopper::fence_regs<BK / 2>(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * P::TILE + (kk % 4) * 32;
        hopper::wgmma_m64n128k16_ss(sc, hopper::desc_sw128(q_base + off, 16,
                                                           1024),
                                    hopper::desc_sw128(k_base + off, 16,
                                                       1024),
                                    kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<BK / 2>(sc);

      // Mask only where the tile straddles the diagonal or the kv edge.
      // Element e of 8-column slice n sits at row row0 + 8 * (e / 2),
      // column k0 + 8 * n + 2 * t4 + e % 2.
      const bool edge = k0 + BK > p.Skv;
      const bool diag =
          p.causal && p.q_off + q_first < p.kv_off + k0 + BK - 1;
      if (edge || diag) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int qi = row0 + 8 * ((i / 2) % 2);
          const int kj = k0 + 8 * (i / 4) + 2 * t4 + i % 2;
          if (!visible(p, qi, kj)) sc[i] = kNegInf;
        }
      }

      // Online softmax. mu is the max the exponents subtract: 0 while a
      // row has seen no key, so masked scores give exp2(-huge) = 0 and
      // never exp2(0) = 1; nothing is ever -inf.
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = mx[r] == kNegInf ? m2[r]
                                          : fmaxf(m2[r], mx[r] * sl2);
        mu[r] = mn == kNegInf ? 0.f : mn;
        alpha[r] = hopper::exp2_approx(m2[r] - mu[r]);
        m2[r] = mn;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = hopper::exp2_approx(fmaf(sc[i], sl2, -mu[r]));
        ls[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) lsum[r] = alpha[r] * lsum[r] + ls[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // O += P V, P rounded to bf16 (as the TPU kernel casts p to v's
      // dtype), straight from the score registers; V is [kv][D], the
      // MN-major B operand: one product D wide a depth step, its 64-wide
      // column tiles P::TILE bytes apart.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hopper::acc_to_a(sc, kk, pa[kk]);
      hopper::mbar_wait(&v_full[s], par);
      hopper::fence_regs<D / 2>(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            hopper::desc_sw128(v_base + kk * 16 * 128, P::TILE, 1024);
        if constexpr (D == 128)
          hopper::wgmma_m64n128k16_rs_tb(o, pa[kk], dv, 1);
        else
          hopper::wgmma_m64n64k16_rs_tb(o, pa[kk], dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: O / l in bf16, lse = (m2 + log2 l) * ln 2.
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                        h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi >= p.Sq) continue;
      const float lr = fmaxf(lsum[r], 1e-30f);
      const float inv = 1.f / lr;
      __nv_bfloat16* orow = og + qi * p.o_ss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t4) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] * inv,
                                  o[4 * n + 2 * r + 1] * inv);
      if (t4 == 0)
        p.lse[((long long)b * p.H + h) * p.Sq + qi] =
            m2[r] == kNegInf ? kNegInf : (m2[r] + log2f(lr)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs (no TF32 rounding)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
fwd_f32_fma(Params p) {
  constexpr int BQ = 32, BK = 64, KS = D + 1, PS = BK + 1;
  constexpr int NJ = BK / 4, ND = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQ][KS]
  float* Ks = Qs + BQ * KS;                    // [BK][KS]
  float* Vs = Ks + BK * KS;                    // [BK][D]
  float* Ps = Vs + BK * D;                     // [BQ][PS]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int qi = q0 + r;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb +
                    kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb +
                    kvh * p.v_sh;

  for (int c = tid; c < BQ * D; c += 128) {
    int rr = c / D, d = c % D;
    Qs[rr * KS + d] = (q0 + rr < p.Sq) ? qg[(q0 + rr) * p.q_ss + d] : 0.f;
  }

  float o[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i] = 0.f;
  float m = kNegInf, l = 0.f;
  const int kv_end = kv_limit(p, min(q0 + BQ, p.Sq));

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int c = tid; c < BK * D; c += 128) {
      int rr = c / D, d = c % D;
      bool in = k0 + rr < p.Skv;
      Ks[rr * KS + d] = in ? kg[(k0 + rr) * p.k_ss + d] : 0.f;
      Vs[rr * D + d] = in ? vg[(k0 + rr) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[NJ];
    float mt = kNegInf;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      int j = c4 + 4 * i;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(Qs[r * KS + d], Ks[j * KS + d], acc);
      s[i] = visible(p, qi, k0 + j) ? acc * p.scale : kNegInf;
      mt = fmaxf(mt, s[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    float mn = fmaxf(m, mt);
    float alpha = expf(m - mn);
    m = mn;
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      int j = c4 + 4 * i;
      float pe = visible(p, qi, k0 + j) ? expf(s[i] - m) : 0.f;
      Ps[r * PS + j] = pe;
      ls += pe;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = alpha * l + ls;
    __syncwarp();  // row r's probabilities come from 4 lanes of this warp
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      float pj = Ps[r * PS + j];
#pragma unroll
      for (int i = 0; i < ND; ++i) o[i] = fmaf(pj, Vs[j * D + c4 + 4 * i], o[i]);
    }
  }

  if (qi < p.Sq) {
    float lr = fmaxf(l, 1e-30f);
    float inv = 1.f / lr;
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
                  qi * p.o_ss;
#pragma unroll
    for (int i = 0; i < ND; ++i) orow[c4 + 4 * i] = o[i] * inv;
    if (c4 == 0) p.lse[((long long)b * p.H + h) * p.Sq + qi] = m + logf(lr);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int bq, int smem, int B, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + bq - 1) / bq, p.H, B);
  kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// The bf16 kernel: tensor maps over q, k and v as they lie in memory, one
// block per (head, batch, query tile).
template <int D>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  using P = Plan<D>;
  CUtensorMap qm, km, vm;
  // A kv length of 0 still needs a valid map; no tile of it is loaded.
  const int skv = p.Skv > 0 ? p.Skv : 1;
  if (hopper::encode_bshd(&qm, p.q, B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh,
                          P::BQ) ||
      hopper::encode_bshd(&km, p.k, B, skv, p.KVH, D, p.k_sb, p.k_ss, p.k_sh,
                          P::BK) ||
      hopper::encode_bshd(&vm, p.v, B, skv, p.KVH, D, p.v_sb, p.v_ss, p.v_sh,
                          P::BK))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(p.H, B, (p.Sq + P::BQ - 1) / P::BQ);
  fwd_bf16_wgmma<D><<<grid, 384, P::SMEM, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// (head-dim) stride is 1; for bf16 the base pointers are 16-byte aligned
// and the other strides multiples of 8. Returns a cudaError_t (0 on
// success), -1 for a dtype / head size the kernel does not take, or -2
// for bf16 operands the driver cannot describe as tensor maps.
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int H, int KVH, int Sq, int Skv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int q_off, int kv_off, int causal, void* stream) {
  Params p{q, k, v, o, lse, H, KVH, Sq, Skv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, scale, q_off, kv_off, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return 0;
  if (dtype == 1) {
    if (D == 128) return launch_bf16<128>(p, B, s);
    if (D == 64) return launch_bf16<64>(p, B, s);
  } else if (dtype == 0) {
    if (D == 128)
      return launch(fwd_f32_fma<128>, 32,
                    (32 * 129 + 64 * 129 + 64 * 128 + 32 * 65) * 4, B, p, s);
    if (D == 64)
      return launch(fwd_f32_fma<64>, 32,
                    (32 * 65 + 64 * 65 + 64 * 64 + 32 * 65) * 4, B, p, s);
  }
  return -1;
}
