// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of ray_tpu/ops/flash_attention.py
// (launched by `_fwd_impl` through pl.pallas_call). It computes the same
// function: online-softmax attention with a running row max m, row sum l
// and an f32 output accumulator; the causal mask is on global positions,
// (q_offset + i) >= (kv_offset + j); kv tiles wholly above the diagonal
// are skipped; masked probabilities are exactly 0, l is clamped at 1e-30,
// and lse = m + log(l).
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
//   * bf16 (the serving path): products on the tensor cores with
//     mma.sync m16n8k16 (f32 accumulate). One block of 4 warps owns a
//     64-row query tile of one (batch, head); each warp owns 16 rows. A
//     loop over 64-row kv tiles replaces the TPU's sequential grid axis.
//     Q, K and V (transposed) are staged in shared memory; the scores,
//     m, l and the output accumulator stay in registers, and the score
//     fragments are re-packed in registers as the A operand of P*V, so
//     the score matrix never leaves the SM.
//   * f32 (the exact comparison): the same tiling on the CUDA cores with
//     f32 FMAs (32 query rows, 4 threads a row), so f32 results are not
//     rounded to TF32.
//   * GQA without a repeat: the block reads KV head h / (H / KVH).
//   * Strided (B, S, H, D) operands are read in place: no transpose.
//   * Ragged Sq/Skv: out-of-range rows load as zeros, are masked out of
//     the softmax, and are never stored.
// This is the simple first kernel; wgmma, TMA and a pipelined smem ring
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(128)
fwd_bf16_mma(Params p) {
  constexpr int BQ = 64, BK = 64, PAD = 8;
  constexpr int QS = D + PAD;   // row stride of Qs / Ks (elements)
  constexpr int VS = BK + PAD;  // row stride of Vt (elements)
  constexpr int NT = BK / 8;    // score n-tiles per warp
  constexpr int DT = D / 8;     // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][QS]
  __nv_bfloat16* Ks = Qs + BQ * QS;                            // [BK][QS]
  __nv_bfloat16* Vt = Ks + BK * QS;                            // [D][VS]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + kvh * p.v_sh;

  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < BQ * CH; c += 128) {
    int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.Sq)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_ss + col);
    *reinterpret_cast<uint4*>(Qs + r * QS + col) = val;
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int q_end = min(q0 + BQ, p.Sq);
  const int kv_end = kv_limit(p, q_end);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Q stored)
    for (int c = tid; c < BK * CH; c += 128) {
      int r = c / CH, col = (c % CH) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.Skv) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * QS + col) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * VS + r] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK columns.
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = Qs + row0 * QS + kk + t4 * 2;
      uint32_t a[4] = {ld32(qa), ld32(qa + 8 * QS), ld32(qa + 8),
                       ld32(qa + 8 * QS + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kb = Ks + (nt * 8 + g) * QS + kk + t4 * 2;
        mma_bf16(s[nt], a, ld32(kb), ld32(kb + 8));
      }
    }

    // Online softmax over the tile; element e of n-tile nt sits at row
    // row0 + 8*(e>>1), column k0 + nt*8 + t4*2 + (e&1).
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int qi = q0 + row0 + 8 * (e >> 1);
        int kj = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = visible(p, qi, kj) ? s[nt][e] * p.scale : kNegInf;
        s[nt][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      float mn = fmaxf(m[r], mt[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int qi = q0 + row0 + 8 * (e >> 1);
        int kj = k0 + nt * 8 + t4 * 2 + (e & 1);
        float pe = visible(p, qi, kj) ? expf(s[nt][e] - m[e >> 1]) : 0.f;
        s[nt][e] = pe;
        ls[e >> 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      l[r] = alpha[r] * l[r] + ls[r];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, with P (rounded to bf16, as the TPU kernel casts p to
    // v's dtype) taken straight from the score registers.
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                       pack_bf16(s[2 * c][2], s[2 * c][3]),
                       pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                       pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int nd = 0; nd < DT; ++nd) {
        const __nv_bfloat16* vb = Vt + (nd * 8 + g) * VS + c * 16 + t4 * 2;
        mma_bf16(o[nd], a, ld32(vb), ld32(vb + 8));
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int qi = q0 + row0 + 8 * r;
    if (qi >= p.Sq) continue;
    float lr = fmaxf(l[r], 1e-30f);
    float inv = 1.f / lr;
    __nv_bfloat16* orow = og + qi * p.o_ss;
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      __nv_bfloat162 v2 = __floats2bfloat162_rn(o[nd][2 * r] * inv,
                                                o[nd][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + t4 * 2) = v2;
    }
    if (t4 == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + qi] = m[r] + logf(lr);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// (head-dim) stride is 1. Returns a cudaError_t (0 on success), or -1
// for a dtype / head size the kernel does not take.
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
    if (D == 128)
      return launch(fwd_bf16_mma<128>, 64,
                    (64 * 136 * 2 + 128 * 72) * 2, B, p, s);
    if (D == 64)
      return launch(fwd_bf16_mma<64>, 64, (64 * 72 * 2 + 64 * 72) * 2, B,
                    p, s);
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
