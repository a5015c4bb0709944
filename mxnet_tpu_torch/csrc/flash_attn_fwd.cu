// Flash-attention forward for Hopper (sm_90a): O = softmax(sm_scale*QK^T
// + causal mask) V, plus the per-row log-sum-exp.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::_fa_fwd_kernel
// (launched by _fa_forward_pallas).  Same function, same numerics contract:
// fp32 accumulation, online softmax with the max/sum/accumulator rescale of
// the Pallas body, l clamped at 1e-30, masked scores set to NEG_INF = -1e30
// (their exponential is exactly 0.0), offset-aware causal mask (query i sees
// key j iff i + (Lk - Lq) >= j), K tiles wholly above the diagonal skipped.
// GQA is indexed (kv_head = h / (Hq / Hkv)), never materialised.  Ragged Lq
// / Lk are masked here, so any length works.  lse is natural-log fp32
// (B, Hq, Lq).
//
// What bounds it on the H100: at prefill shapes (L = 2048, Hq = 32, D = 128,
// causal) the work is ~34 GFLOP per call against ~42 MB of q/k/v/o, ~800
// FLOP per byte against the card's ridge of ~295: the bound is the
// tensor-core rate, not memory.  So the bf16 kernel is built, in the shape
// of a Hopper GEMM, to keep the tensor cores fed.  Against what held the
// first (mma.sync) version of this kernel back:
//  1. mma.sync -> wgmma for both products.  S = Q K^T reads Q and K from
//     shared memory through matrix descriptors (both K-major, as they lie
//     in memory).  O += P V takes P from registers: the fp32 accumulator
//     fragment of S, rounded to bf16 pairs, is already the register-A
//     layout, so P never leaves the registers.
//  2. No copy/compute overlap -> TMA into a 2-stage ring.  One producer
//     thread loads the CTA's Q tile once, then streams K and V tiles; each
//     stage has a full and an empty mbarrier for K and for V, so the next
//     tile loads while this one is multiplied.  Tensor maps are encoded per
//     call from the tensors' element strides (any (B, H, L, D) view whose
//     head dim is dense and whose other strides are multiples of 16 bytes:
//     the projections' transposed outputs go in without a copy), with the
//     128-byte swizzle the descriptors name (64-byte at D = 32, whose rows
//     are 64 bytes).  A D = 128 or 256 row is 2 or 4 boxes of 64 columns;
//     the descriptors step between them.  TMA zero-fills rows past Lq /
//     Lk; key columns >= Lk are still masked to NEG_INF.
//  3. V transposed element by element -> V is wgmma's MN-major B operand
//     (transpose bit) and is read as TMA lays it down.
//  4. Masking every element -> masking by tile class.  K tiles are walked
//     from the diagonal down; only a tile that straddles a warpgroup's
//     causal diagonal or holds key Lk - 1 is masked element by element, and
//     a tile no row of a warpgroup can see is only released by it.
//  5. Small tiles -> 128 query rows per CTA in two consumer warpgroups of
//     64 rows, 128-key tiles; Q stays in shared memory for the CTA's life.
//     Warp specialisation: 384 threads, warpgroup 0 the producer
//     (setmaxnreg.dec), warpgroups 1 and 2 the consumers (setmaxnreg.inc),
//     each keeping m, l and its 64 x D fp32 O accumulator in registers.
//     One CTA per SM (~160 KB of shared memory at D = 128).  Within a
//     consumer, S, softmax and P V run in turn; the other consumer's
//     products fill the tensor cores meanwhile.  (Overlapping the next
//     tile's S with this tile's P V, or issuing both as one phase, needs
//     more than the launch's 168 registers a consumer thread; ptxas kept
//     the consumers at 168 despite setmaxnreg.inc, spilled, and those
//     schedules were slower: PERF.md.)
//  6. expf -> base 2: sm_scale * log2(e) folds into one FMA feeding
//     ex2.approx; lse = (m2 + log2 l) * ln 2 stays natural-log.
// Grid: x runs over (batch, head), y over query blocks from the longest
// causal block down, so every head's longest blocks start first and the q
// heads of one kv head run side by side (their K/V tiles are shared in L2).
// Head dims: every one the wrapper takes (32, 64, 128, 256) runs this
// kernel; there is no other bf16 kernel.  D = 256 uses one consumer
// warpgroup (a 64-row CTA of 256 threads) and 64-key tiles: its 64 x 256
// fp32 O accumulator alone is 128 registers a thread.
//
// fp32: full fp32 (no TF32), scalar FMAs, 256 threads each owning a 4x4
// piece of a 64x64 score tile and a 4 x D/16 piece of the accumulator.  It
// serves the fp32 checks only and is not tuned.
//
// Interface: plain C, loaded with ctypes.  q/k/v/o are (B, H, L, D) with the
// element strides the caller passes (the head dim dense); lse is contiguous.
// Outputs are allocated by the caller; the launch goes on the caller's
// stream, allocates nothing and does not synchronise.  Returns the
// cudaError_t of the launch (0 = success).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {  // element strides of a (B, H, L, D) tensor; D's is 1
  long long b, h, l;
};

// ---------------------------------------------------------------------------
// fp32: scalar FMAs in full fp32.
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per shared-memory tile

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  Strides qs, ks, vs, os;
  int Hq, Hkv, Lq, Lk;
  int causal;
  float sm_scale;
};

// K tiles the query block starting at q0 has to visit: all of them, or, when
// causal, up to the tile holding the last key its last real row can see.
__device__ __forceinline__ int kv_tiles(const F32Params& p, int q0) {
  int n = (p.Lk + kBK - 1) / kBK;
  if (p.causal) {
    const int q_last = min(q0 + kBQ, p.Lq) - 1;
    n = min(n, (q_last + p.Lk - p.Lq) / kBK + 1);
  }
  return n;
}

__device__ __forceinline__ bool masked(const F32Params& p, int qr, int kc) {
  return kc >= p.Lk || (p.causal && qr + (p.Lk - p.Lq) < kc);
}

template <int D>
__global__ void __launch_bounds__(256) fa_fwd_f32(F32Params p) {
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
  const float* q = p.q + b * p.qs.b + h * p.qs.h;
  const float* k = p.k + b * p.ks.b + hk * p.ks.h;
  const float* v = p.v + b * p.vs.b + hk * p.vs.h;

  for (int i = tid; i < kBQ * D; i += 256) {
    const int r = i / D, c = i % D;
    Qs[r * QS + c] =
        (q0 + r < p.Lq) ? q[(q0 + r) * p.qs.l + c] * p.sm_scale : 0.f;
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
      Ks[r * KS + c] = ok ? k[(k0 + r) * p.ks.l + c] : 0.f;
      Vs[r * VS + c] = ok ? v[(k0 + r) * p.vs.l + c] : 0.f;
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
    float* o = p.o + b * p.os.b + h * p.os.h + qr * p.os.l;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = acc[i][j] / li;
    if (tx == 0) p.lse[(size_t)bh * p.Lq + qr] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA into a shared-memory ring, warp-specialised.
// ---------------------------------------------------------------------------
constexpr int kStages = 2;  // K/V ring depth
// with two consumer warpgroups (384 threads, 168 registers a thread at
// launch) the producer gives back 128 and the consumers take 64 each
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// An mbarrier wait that spins this often is a deadlock: trap, so that the
// launch fails with an error instead of hanging the card.
constexpr uint32_t kSpinLimit = 1u << 26;

struct Bf16Params {
  CUtensorMap tm_q, tm_k, tm_v;  // (D, L, H, B) maps, boxes of Tile<D>
  __nv_bfloat16* o;
  float* lse;
  Strides os;
  int Hq, Hkv, Lq, Lk;
  int causal;
  float scale_log2;  // sm_scale * log2(e)
};

template <int D>
struct Tile {
  // consumer warpgroups of 64 query rows each: one at D = 256, where the
  // 64 x 256 fp32 O accumulator alone is 128 registers a thread and only a
  // 256-thread CTA lets a thread hold 255
  static constexpr int kConsumers = D == 256 ? 1 : 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBM = 64 * kConsumers;      // query rows per CTA
  static constexpr int kBN = D == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int kSw = D >= 64 ? 128 : 64;   // swizzle span = box row bytes
  static constexpr int kBoxCols = kSw / 2;         // bf16 columns per TMA box
  static constexpr int kBoxes = D / kBoxCols;      // boxes per row
  static constexpr int kNO = D < 128 ? D : 128;    // O columns per P.V wgmma
  static constexpr int kNOC = D / kNO;
  static constexpr uint32_t kQBytes = kBM * D * 2;
  static constexpr uint32_t kKVBytes = kBN * D * 2;
  static constexpr uint64_t kLayout = kSw == 128 ? 1 : 2;  // descriptor swizzle
  static constexpr uint32_t kBarOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOff + 128 + 1024;  // + barriers, alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}

// One TMA box of a (D, L, H, B) tensor map into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x N fp32) = [d +] A (64 x 16, smem, K-major) * B (N x 16, smem,
// K-major)^T
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// d (64 x N fp32) += A (64 x 16 bf16, registers) * B (16 x N, smem, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Issue S = Q K^T for a consumer's 64 rows (one k16 wgmma per 16 of D).
// Descriptors are built once per tile; each step adds its byte offset
// (>> 4) to the start-address field.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<D>::kBN / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
  using T = Tile<D>;
  const uint64_t da = gmma_desc(q_rows, 16, 8 * T::kSw, T::kLayout);
  const uint64_t db = gmma_desc(k_tile, 16, 8 * T::kSw, T::kLayout);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const uint32_t box = (kd * 16) / T::kBoxCols;
    const uint32_t col = (kd * 16) % T::kBoxCols * 2;  // bytes into the box
    wgmma_ss<T::kBN>(s, da + ((box * T::kBM * T::kSw + col) >> 4),
                     db + ((box * T::kBN * T::kSw + col) >> 4), kd > 0);
  }
}

// Issue O += P V: P from registers, V read MN-major (transpose bit).
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[Tile<D>::kNOC][Tile<D>::kNO / 2],
    const uint32_t (&pa)[Tile<D>::kBN / 16][4], uint32_t v_tile) {
  using T = Tile<D>;
  const uint64_t db =
      gmma_desc(v_tile, T::kBN * T::kSw, 8 * T::kSw, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < T::kBN / 16; ++kk)
#pragma unroll
    for (int n = 0; n < T::kNOC; ++n) {
      const uint32_t box = n * T::kNO / T::kBoxCols;
      wgmma_rs<T::kNO>(
          o[n], pa[kk],
          db + ((box * T::kBN * T::kSw + kk * 16 * T::kSw) >> 4));
    }
}

template <int D>
__device__ __forceinline__ void pin_o(
    float (&o)[Tile<D>::kNOC][Tile<D>::kNO / 2]) {
#pragma unroll
  for (int n = 0; n < Tile<D>::kNOC; ++n) pin(o[n]);
}

// The online-softmax state of a thread's two rows (row0 and row0 + 8).
struct RowState {
  float m0, m1, l0, l1;  // running max (raw scores) and lane-partial sums
};

// Mask (only where the tile needs it), then the online softmax in base 2:
// s becomes p, m and l move on, and al0 / al1 are the factors by which the
// O rows must be rescaled.  Accumulator entry i of a thread holds row
// row0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i / 4) + 2 * qd + (i & 1).
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], RowState& r,
                                             float& al0, float& al1,
                                             const Bf16Params& p, float c,
                                             int k0, int r0, int row0,
                                             int qd) {
  const int off = p.Lk - p.Lq;
  if (k0 + BN > p.Lk || (p.causal && k0 + BN - 1 > r0 + off)) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int key = k0 + (i / 4) * 8 + 2 * qd + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (key >= p.Lk || (p.causal && key > row + off)) s[i] = kNegInf;
    }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {  // a row's owners: the 4 lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  // a row with nothing visible yet keeps p = 0 for its masked scores
  const float ms0 = mx0 == kNegInf ? 0.f : mx0 * c;
  const float ms1 = mx1 == kNegInf ? 0.f : mx1 * c;
  al0 = ex2(fmaf(r.m0, c, -ms0));
  al1 = ex2(fmaf(r.m1, c, -ms1));
  r.m0 = mx0;
  r.m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 4) {
    s[i] = ex2(fmaf(s[i], c, -ms0));
    s[i + 1] = ex2(fmaf(s[i + 1], c, -ms0));
    s[i + 2] = ex2(fmaf(s[i + 2], c, -ms1));
    s[i + 3] = ex2(fmaf(s[i + 3], c, -ms1));
    rs0 += s[i] + s[i + 1];
    rs1 += s[i + 2] + s[i + 3];
  }
  r.l0 = r.l0 * al0 + rs0;
  r.l1 = r.l1 * al1 + rs1;
}

// P as bf16 register-A fragments: two adjacent n8 tiles per k16 step.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
    fa_fwd_wgmma(const __grid_constant__ Bf16Params p) {
  using T = Tile<D>;
  constexpr int BN = T::kBN, kBM = T::kBM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled TMA boxes and wgmma descriptors agree on 1024-byte atoms
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;            // kStages K tiles
  const uint32_t sV = sK + kStages * T::kKVBytes;  // kStages V tiles
  const uint32_t bars = sQ + T::kBarOff;
  // barriers: Q full, then per stage K full, V full, K empty, V empty
  const uint32_t full_q = bars;
#define FULL_K(s) (bars + 8u * (1 + (s)))
#define FULL_V(s) (bars + 8u * (1 + kStages + (s)))
#define EMPTY_K(s) (bars + 8u * (1 + 2 * kStages + (s)))
#define EMPTY_V(s) (bars + 8u * (1 + 3 * kStages + (s)))

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest causal first
  const int off = p.Lk - p.Lq;                        // causal diagonal offset
  int nkt = (p.Lk + BN - 1) / BN;
  if (p.causal) nkt = min(nkt, (min(q0 + kBM, p.Lq) - 1 + off) / BN + 1);

  // role indices through a lane broadcast, so the compiler can prove them
  // warp-uniform (measured faster than the plain division: PERF.md)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(FULL_K(s), 1);
      mbar_init(FULL_V(s), 1);
      mbar_init(EMPTY_K(s), 4 * T::kConsumers);  // one per consumer warp
      mbar_init(EMPTY_V(s), 4 * T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    if constexpr (T::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&p.tm_q))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&p.tm_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&p.tm_v))
                   : "memory");
      mbar_expect_tx(full_q, T::kQBytes);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x)
        tma_load(sQ + x * kBM * T::kSw, &p.tm_q, full_q, x * T::kBoxCols, q0,
                 h, b);
      for (int it = 0; it < nkt; ++it) {
        const int j = nkt - 1 - it, st = it % kStages;
        const uint32_t par = ((it / kStages) & 1) ^ 1;  // first round: free
        mbar_wait(EMPTY_K(st), par);
        mbar_expect_tx(FULL_K(st), T::kKVBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load(sK + st * T::kKVBytes + x * BN * T::kSw, &p.tm_k,
                   FULL_K(st), x * T::kBoxCols, j * BN, hk, b);
        mbar_wait(EMPTY_V(st), par);
        mbar_expect_tx(FULL_V(st), T::kKVBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load(sV + st * T::kKVBytes + x * BN * T::kSw, &p.tm_v,
                   FULL_V(st), x * T::kBoxCols, j * BN, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    if constexpr (T::kConsumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int warp = __shfl_sync(0xffffffffu, t / 32, 0);
    const int g = lane / 4, qd = lane % 4;
    const int r0 = q0 + 64 * w;           // this warpgroup's first row
    const int row0 = r0 + 16 * warp + g;  // this thread's rows: row0, row0+8
    // K tiles some row of this warpgroup sees (tiles >= nkt_w are skipped)
    int nkt_w = 0;
    if (r0 < p.Lq) {
      nkt_w = nkt;
      if (p.causal)
        nkt_w = min(nkt, (min(r0 + 64, p.Lq) - 1 + off) / BN + 1);
    }
    const float c = p.scale_log2;

    float o[T::kNOC][T::kNO / 2];
#pragma unroll
    for (int n = 0; n < T::kNOC; ++n)
#pragma unroll
      for (int i = 0; i < T::kNO / 2; ++i) o[n][i] = 0.f;
    RowState rs{kNegInf, kNegInf, 0.f, 0.f};
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    uint32_t pa[BN / 16][4];
    const uint32_t q_rows = sQ + w * 64 * T::kSw;

    mbar_wait(full_q, 0);
    // K tiles are walked from the last down.  Within a warpgroup the steps
    // run in turn (S, softmax, P V); the other consumer's steps fill the
    // tensor cores meanwhile.
    for (int it = 0; it < nkt; ++it) {
      const int j = nkt - 1 - it, st = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      if (j >= nkt_w) {  // wholly above this warpgroup's diagonal: release
        mbar_wait(FULL_K(st), par);
        if (lane == 0) mbar_arrive(EMPTY_K(st));
        mbar_wait(FULL_V(st), par);
        if (lane == 0) mbar_arrive(EMPTY_V(st));
        continue;
      }
      mbar_wait(FULL_K(st), par);
      pin(s);
      wg_fence();
      issue_qk<D>(s, q_rows, sK + st * T::kKVBytes);
      wg_commit();
      wg_wait<0>();
      pin(s);
      if (lane == 0) mbar_arrive(EMPTY_K(st));

      float al0, al1;
      softmax_tile<BN>(s, rs, al0, al1, p, c, j * BN, r0, row0, qd);
#pragma unroll
      for (int n = 0; n < T::kNOC; ++n)
#pragma unroll
        for (int i = 0; i < T::kNO / 2; i += 4) {
          o[n][i] *= al0;
          o[n][i + 1] *= al0;
          o[n][i + 2] *= al1;
          o[n][i + 3] *= al1;
        }
      pack_p<BN>(s, pa);

      mbar_wait(FULL_V(st), par);
      pin_o<D>(o);
      wg_fence();
      issue_pv<D>(o, pa, sV + st * T::kKVBytes);
      wg_commit();
      wg_wait<0>();
      pin_o<D>(o);
      if (lane == 0) mbar_arrive(EMPTY_V(st));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      rs.l0 += __shfl_xor_sync(0xffffffffu, rs.l0, x);
      rs.l1 += __shfl_xor_sync(0xffffffffu, rs.l1, x);
    }
    __nv_bfloat16* ob = p.o + b * p.os.b + h * p.os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Lq) continue;
      const float li = fmaxf(r ? rs.l1 : rs.l0, 1e-30f), inv = 1.f / li;
      __nv_bfloat16* orow = ob + row * p.os.l;
#pragma unroll
      for (int n = 0; n < T::kNOC; ++n)
#pragma unroll
        for (int jn = 0; jn < T::kNO / 8; ++jn)
          *reinterpret_cast<__nv_bfloat162*>(orow + n * T::kNO + 8 * jn +
                                             2 * qd) =
              __floats2bfloat162_rn(o[n][4 * jn + 2 * r] * inv,
                                    o[n][4 * jn + 2 * r + 1] * inv);
      if (qd == 0)
        p.lse[(size_t)bh * p.Lq + row] =
            ((r ? rs.m1 : rs.m0) * c + __log2f(li)) * 0.69314718056f;
    }
  }
#undef FULL_K
#undef FULL_V
#undef EMPTY_K
#undef EMPTY_V
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Hq, Hkv, Lq, Lk, causal;
  float sm_scale;
  Strides qs, ks, vs, os;
};

template <typename Kernel, typename P>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const P& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  if ((long long)a.B * a.Hq > 65535) return (int)cudaErrorInvalidValue;
  const F32Params p{static_cast<const float*>(a.q),
                    static_cast<const float*>(a.k),
                    static_cast<const float*>(a.v),
                    static_cast<float*>(a.o),
                    a.lse, a.qs, a.ks, a.vs, a.os, a.Hq, a.Hkv, a.Lq, a.Lk,
                    a.causal, a.sm_scale};
  const size_t smem =
      sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.Hq);
  return launch(fa_fwd_f32<D>, grid, 256, smem, p, stream);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (in libcuda), fetched through the runtime so the
// library links against nothing but cudart.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, H, L, D) bf16 tensor as a 4-d map (D, L, H, B), boxes of
// box_cols x box_rows, swizzled as the wgmma descriptors expect.
bool encode(CUtensorMap* map, const void* ptr, int B, int H, int L, int D,
            const Strides& s, int box_cols, int box_rows, int swizzle_bytes) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)s.l * 2, (cuuint64_t)s.h * 2,
                           (cuuint64_t)s.b * 2};
  cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using T = Tile<D>;
  const int nqb = (a.Lq + T::kBM - 1) / T::kBM;
  if (nqb > 65535) return (int)cudaErrorInvalidValue;
  Bf16Params p;
  if (!encode(&p.tm_q, a.q, a.B, a.Hq, a.Lq, D, a.qs, T::kBoxCols, T::kBM,
              T::kSw) ||
      !encode(&p.tm_k, a.k, a.B, a.Hkv, a.Lk, D, a.ks, T::kBoxCols, T::kBN,
              T::kSw) ||
      !encode(&p.tm_v, a.v, a.B, a.Hkv, a.Lk, D, a.vs, T::kBoxCols, T::kBN,
              T::kSw))
    return (int)cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.lse = a.lse;
  p.os = a.os;
  p.Hq = a.Hq;
  p.Hkv = a.Hkv;
  p.Lq = a.Lq;
  p.Lk = a.Lk;
  p.causal = a.causal;
  p.scale_log2 = a.sm_scale * 1.4426950408889634f;
  const dim3 grid(a.B * a.Hq, nqb);
  return launch(fa_fwd_wgmma<D>, grid, T::kThreads, T::kSmem, p, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and o in turn;
// each tensor's head dim is dense.
extern "C" int mxt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Hq, int Hkv,
                                  int Lq, int Lk, int D, int causal,
                                  float sm_scale, int is_bf16,
                                  const long long* strides, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  // TMA (bf16) and the fp32 loads alike take 16-byte aligned rows
  const long long align = is_bf16 ? 8 : 4;
  for (int i = 0; i < 12; ++i)
    if (strides[i] <= 0 || strides[i] % align) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, Lq, Lk,
               causal, sm_scale,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               Strides{strides[9], strides[10], strides[11]}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (D) {
      case 32: return launch_bf16<32>(a, st);
      case 64: return launch_bf16<64>(a, st);
      case 128: return launch_bf16<128>(a, st);
      case 256: return launch_bf16<256>(a, st);
    }
  } else {
    switch (D) {
      case 32: return launch_f32<32>(a, st);
      case 64: return launch_f32<64>(a, st);
      case 128: return launch_f32<128>(a, st);
      case 256: return launch_f32<256>(a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
