// Flash-attention forward for Hopper (sm_90a): O = softmax(sm_scale*QK^T
// + causal mask) V, plus the per-row log-sum-exp.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::_fa_fwd_kernel
// (launched by _fa_forward_pallas).  Same function, same numerics contract:
// fp32 accumulation, online softmax with the max/sum/accumulator rescale of
// the Pallas body, l clamped at 1e-30, masked scores set to NEG_INF = -1e30
// (exp of it is exactly 0.0), offset-aware causal mask (query i sees key j
// iff i + (Lk - Lq) >= j), K tiles wholly above the diagonal skipped.  GQA is
// indexed (kv_head = h / (Hq / Hkv)), never materialised.  Ragged Lq / Lk are
// masked here, so any length works.
//
// What bounds it on the H100: at prefill shapes (L = 2048, Hq = 32, D = 128,
// causal) the work is ~34 GFLOP per call against ~42 MB of q/k/v/o, i.e.
// ~800 FLOP per byte, far above the card's ~295 FLOP/byte ridge: the bound is
// the tensor-core rate, not memory.  The design answers that as simply as is
// right for a first port:
//   * bf16: one block of 4 warps owns 64 query rows; K and V stream through
//     shared memory in 64-row tiles (the Pallas kernel kept the whole K/V row
//     in VMEM, which does not fit in 227 KB); both products run on the tensor
//     cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate).  The score
//     accumulators are re-packed in registers as the A operand of P.V, so the
//     L x L score matrix never leaves registers.  V is stored transposed in
//     shared memory so every B fragment is one 32-bit load; rows are padded
//     by 8 elements so fragment loads are free of bank conflicts.
//   * fp32: full fp32 (no TF32), scalar FMAs, 256 threads each owning a 4x4
//     piece of the 64x64 score tile and a 4 x D/16 piece of the accumulator.
// Causal blocks are launched longest first.  wgmma, TMA and warp
// specialisation are later work.
//
// Interface: plain C, loaded with ctypes.  Tensors are contiguous
// (B, H, L, D); outputs are allocated by the caller; the launch goes on the
// caller's stream, allocates nothing and does not synchronise.  Returns the
// cudaError_t of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per shared-memory tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int Hq, Hkv, Lq, Lk;
  int causal;
  float sm_scale;
};

// K tiles the query block starting at q0 has to visit: all of them, or, when
// causal, up to the tile holding the last key its last real row can see.
__device__ __forceinline__ int kv_tiles(const Params& p, int q0) {
  int n = (p.Lk + kBK - 1) / kBK;
  if (p.causal) {
    const int q_last = min(q0 + kBQ, p.Lq) - 1;
    n = min(n, (q_last + p.Lk - p.Lq) / kBK + 1);
  }
  return n;
}

__device__ __forceinline__ bool masked(const Params& p, int qr, int kc) {
  return kc >= p.Lk || (p.causal && qr + (p.Lk - p.Lq) < kc);
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs in full fp32.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256) fa_fwd_f32(Params p) {
  constexpr int QS = D + 1;   // padded row strides: conflict-free column reads
  constexpr int KS = D + 1;
  constexpr int VS = D;
  constexpr int PS = kBK + 1;
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;        // [kBQ][QS], pre-scaled by sm_scale
  float* Ks = Qs + kBQ * QS;   // [kBK][KS]
  float* Vs = Ks + kBK * KS;   // [kBK][VS]
  float* Ps = Vs + kBK * VS;   // [kBQ][PS]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qb * kBQ;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.Lq * D;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.Lk * D;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;

  for (int i = tid; i < kBQ * D; i += 256) {
    const int r = i / D, c = i % D;
    Qs[r * QS + c] =
        (q0 + r < p.Lq) ? q[(size_t)(q0 + r) * D + c] * p.sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nkt = kv_tiles(p, q0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += 256) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < p.Lk;
      Ks[r * KS + c] = ok ? k[(size_t)(k0 + r) * D + c] : 0.f;
      Vs[r * VS + c] = ok ? v[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 16 owners are 16 adjacent lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (masked(p, qr, k0 + tx + 16 * j)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * VS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= p.Lq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* o = static_cast<float*>(p.o) + ((size_t)bh * p.Lq + qr) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = acc[i][j] / li;
    if (tx == 0) p.lse[(size_t)bh * p.Lq + qr] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core mma.sync m16n8k16, fp32 accumulation.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += A(16x16, row-major) * B(16x8, col-major); fragments per the PTX ISA:
// lane = 4*g + t holds A rows g and g+8, B column g, C rows g and g+8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(128) fa_fwd_bf16(Params p) {
  constexpr int QS = D + 8;     // Q/K row stride (elements), 16-byte rows
  constexpr int VTS = kBK + 8;  // transposed-V row stride
  constexpr int VPR = D / 8;    // 16-byte vectors per row
  constexpr int NT = kBK / 8;   // score n-tiles per K tile
  constexpr int ND = D / 8;     // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);  // [kBQ][QS]
  __nv_bfloat16* Ks = Qs + kBQ * QS;                                // [kBK][QS]
  __nv_bfloat16* Vt = Ks + kBK * QS;                                // [D][VTS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qb * kBQ;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.Lq * D;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.Lk * D;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;

  for (int i = tid; i < kBQ * VPR; i += 128) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Lq)
      val = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = val;
  }

  const int rw = warp * 16;  // this warp's first row within the block
  const int qr0 = q0 + rw + g, qr1 = qr0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: lane partials
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  const int nkt = kv_tiles(p, q0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * VPR; i += 128) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u), vval = kval;
      if (k0 + r < p.Lk) {
        kval = *reinterpret_cast<const uint4*>(k + (size_t)(k0 + r) * D + c);
        vval = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * QS + c) = kval;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * VTS + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D; kd += 16) {
      const __nv_bfloat16* qa = Qs + (rw + g) * QS + kd + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * QS);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * QS + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * QS + kd + 2 * t;
        mma_bf16(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    // scale, mask, online softmax (a row's owners are the 4 lanes of a quad)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + j * 8 + 2 * t + e;
        s[j][e] = masked(p, qr0, kc) ? kNegInf : s[j][e] * p.sm_scale;
        s[j][2 + e] = masked(p, qr1, kc) ? kNegInf : s[j][2 + e] * p.sm_scale;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - mn0);
        s[j][2 + e] = expf(s[j][2 + e] - mn1);
        rs0 += s[j][e];
        rs1 += s[j][2 + e];
      }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= al0;
      oacc[n][1] *= al0;
      oacc[n][2] *= al1;
      oacc[n][3] *= al1;
    }

    // O += P V: two adjacent score n-tiles are one A fragment of P
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vb = Vt + (n * 8 + g) * VTS + kk * 16 + 2 * t;
        mma_bf16(oacc[n], a0, a1, a2, a3, ld32(vb), ld32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + (size_t)bh * p.Lq * D;
  if (qr0 < p.Lq) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)qr0 * D + n * 8 + 2 * t) =
          __floats2bfloat162_rn(oacc[n][0] / l0, oacc[n][1] / l0);
    if (t == 0) p.lse[(size_t)bh * p.Lq + qr0] = m0 + logf(l0);
  }
  if (qr1 < p.Lq) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)qr1 * D + n * 8 + 2 * t) =
          __floats2bfloat162_rn(oacc[n][2] / l1, oacc[n][3] / l1);
    if (t == 0) p.lse[(size_t)bh * p.Lq + qr1] = m1 + logf(l1);
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const Params& p, int B,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Lq + kBQ - 1) / kBQ, B * p.Hq);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
  return launch(fa_fwd_f32<D>, 256, smem, p, B, stream);
}

template <int D>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (kBQ * (D + 8) + kBK * (D + 8) + D * (kBK + 8));
  return launch(fa_fwd_bf16<D>, 128, smem, p, B, stream);
}

}  // namespace

extern "C" int mxt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Hq, int Hkv,
                                  int Lq, int Lk, int D, int causal,
                                  float sm_scale, int is_bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, static_cast<float*>(lse), Hq, Hkv, Lq, Lk,
                 causal, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (D) {
      case 32: return launch_bf16<32>(p, B, st);
      case 64: return launch_bf16<64>(p, B, st);
      case 128: return launch_bf16<128>(p, B, st);
      case 256: return launch_bf16<256>(p, B, st);
    }
  } else {
    switch (D) {
      case 32: return launch_f32<32>(p, B, st);
      case 64: return launch_f32<64>(p, B, st);
      case 128: return launch_f32<128>(p, B, st);
      case 256: return launch_f32<256>(p, B, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
