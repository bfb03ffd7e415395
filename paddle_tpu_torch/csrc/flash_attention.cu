// Flash attention for Hopper (sm_90a): forward, dq and dk/dv, with plain C
// entry points loaded through ctypes (paddle_tpu_torch/ops/flash_attention.py).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py: _fwd_kernel (forward:
// out, lse), _bwd_dq_kernel (dq) and _bwd_dkv_kernel (dk, dv).
//
// What each computes, per (b, h) with q/k/v read as (B, S, H, D) through
// their strides (the last dim contiguous), inputs float32 or bfloat16,
// all math float32:
//   forward  s = (q*scale) k^T, masked; online softmax over key tiles;
//            out = (m∘p) v / l with l from the UNdropped p; lse = m + log l;
//            a row with no visible key gives out = 0 and lse = 0.
//   dq       p = exp(s - lse); ds = p∘(m∘dp - delta), dp = do v^T;
//            dq = scale * ds k.
//   dk/dv    dv = (m∘p)^T do; dk = scale * ds^T q.
// delta = rowsum(do∘out) comes from the caller (PyTorch), as the reference
// computes it in jnp outside its kernels. out, dq, dk, dv are written
// contiguous (B, S, H, D) in the input dtype; lse and delta are float32
// (B, H, Sq).
//
// Semantics kept from the TPU kernels:
//   - masking uses the finite NEG_INF = -1e30; the forward zeroes p where
//     s <= NEG_INF/2, so a fully masked row gives l = 0, out = 0, lse = 0 and
//     zero K/V gradients, never NaN;
//   - key columns >= lens[b] (capped at Sk) and, when causal, columns > row
//     are masked; ragged tails are masked, not padded;
//   - causal tiles run only when k0 < q0 + BQ (forward, dq) and
//     q0 + BQ > k0 (dk/dv), the reference's block-skip rule at this tiling.
//     A skipped tile is fully masked for every row, so skipping it changes
//     no bit of the result (m, l and acc are left as they were); the same
//     holds for tiles past lens[b], which are skipped too;
//   - dropout is the reference's counter hash (_dropout_mask), keyed on
//     (seed, b*H + h, iq, ik, row-in-block, col-in-block) where
//     (iq, r) = divmod(row, drop_bq) and (ik, c) = divmod(col, drop_bk) on
//     GLOBAL positions and (drop_bq, drop_bk) are the reference's blocks for
//     the call, so the mask is bit-equal whatever tiles run here. The mask
//     scales P·V in the forward and dp in both backward kernels.
//
// Two forward kernels, picked by the wrapper (ops/flash_attention.py,
// fwd_route):
//
// flash_fwd_mma_kernel (route "mma": bfloat16, D = 64 or 128, rows on
//   16-byte boundaries). Bound on this card: the two products, 2*S*S*D
//   multiply-adds per (b, h) causal, on the tensor cores. One block of 8
//   warps per (b*h, q tile of 128 rows, 16 a warp), heavy tiles first.
//   (64 rows over 4 warps was slower at D = 64 and no faster at D = 128.) Q is read once by cp.async and held as mma A fragments
//   (ldmatrix) for the whole key loop. K/V tiles of 64 keys go through a
//   two-slot cp.async ring: tile j+1 loads while tile j computes; keys past
//   Sk are zero-filled without a read. S = Q K^T is mma.sync.m16n8k16 bf16
//   with float32 sums, K the [n][k] operand through ldmatrix; the online
//   softmax runs on the accumulators (row max and sum over the 4 lanes of a
//   row, m, l and O in registers, scores in the log2 domain), masks only on
//   tiles that cross the diagonal or lens[b]; p is rounded to bf16 and
//   packed straight into the A fragments of O += P V (V the [k][n] operand
//   through ldmatrix.trans), with no shared-memory round trip. The one new
//   rounding against the scalar kernel is that bf16 p. The output is
//   staged through the warp's Q rows for 16-byte stores. No wgmma, no TMA,
//   no warp specialisation yet.
//
// flash_fwd_kernel (route "scalar": float32, D = 256, unaligned rows) and
// the backward kernels: one block of 256 threads (16 x 16) per (q tile,
// b*h) for the forward and dq, per (k tile, b*h) for dk/dv; the TPU grid's
// sequential axis becomes a loop inside the block over the other side's
// tiles. Tiles are BQ = BK = 64 rows (32 at D = 256), staged as float32
// rows of stride D + 1 in shared memory so that 16 threads reading 16
// different rows at one d hit 16 different banks. Thread (ty, tx) owns the
// scores of rows ty + 16i and columns tx + 16j (a 4 x 4 register tile),
// and of the output the same rows and dims tx + 16d; the 16 threads of a
// row sit in one half warp and reduce the row max and sum with shuffles.
// The score tile goes through shared memory (stride BK + 16) between the
// two products. Each output element is summed in one thread in a fixed
// order: deterministic, no atomics.
//
// Bound on this card: the multiply-adds (about 2*S*S*D per (b, h) for the
// causal forward, 3 and 4 such products for dq and dk/dv). The scalar
// kernels do them as float32 FMAs fed from shared memory, two loads per two
// FMAs in the score loop, so they are bound by shared-memory bandwidth far
// below the tensor-core rate; the backward on the mma core is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// reductions over the 16 threads (tx) of one row: lanes 0-15 or 16-31
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int D>
struct Cfg {
  static constexpr int BQ = D >= 256 ? 32 : 64;  // query rows per tile
  static constexpr int BK = BQ;                  // key rows per tile
  static constexpr int RM = BQ / 16;             // score rows per thread
  static constexpr int CM = BK / 16;             // score cols per thread
  static constexpr int DM = D / 16;              // output dims per thread
  static constexpr int RS = D + 1;               // smem stride, D-wide rows
  static constexpr int PS = BK + 16;             // smem stride, score rows
  static constexpr int PT = BQ + 16;             // smem stride, transposed
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  long long st[12];  // (b, s, h) element strides of q, k, v, dout
  void* out;         // forward: (B, Sq, H, D)
  float* lse;        // (B, H, Sq): written by the forward, read by backward
  const float* delta;  // (B, H, Sq)
  void* dq;          // (B, Sq, H, D)
  void* dk;          // (B, Sk, H, D)
  void* dv;          // (B, Sk, H, D)
  const int* lens;   // (B,) valid keys per row, or null
  const int* seed;   // (1,) dropout seed
  int B, H, Sq, Sk;
  float scale;
  int causal;
  int dropout;
  unsigned thresh;   // keep when hash >= thresh
  float drop_scale;  // 1 / (1 - rate)
  int drop_bq, drop_bk;
};

// bit-equal to _dropout_mask: uint32 arithmetic wraps as jnp.uint32 does
__device__ __forceinline__ float drop_mult(const Params& p, unsigned seed,
                                           unsigned bh, int row, int col) {
  const unsigned iq = row / p.drop_bq, r = row % p.drop_bq;
  const unsigned ik = col / p.drop_bk, c = col % p.drop_bk;
  unsigned h = (seed * 2654435761u) ^ (bh * 0x9E3779B1u) ^
               (iq * 0x85EBCA77u) ^ (ik * 0xC2B2AE3Du);
  h = h ^ (r * 0x27D4EB2Fu) ^ (c + 0x165667B1u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= p.thresh ? p.drop_scale : 0.f;
}

// rows [row0, row0 + nrows) of one (b, h) slice into smem (stride RS),
// times mul; rows at or past limit are zero
template <typename T, int D, int RS>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int row0, int nrows,
                                          int limit, float mul) {
  for (int e = threadIdx.x; e < nrows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    dst[r * RS + c] =
        g < limit ? to_f32(src[static_cast<long long>(g) * ss + c]) * mul
                  : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ const T* slice(const void* base, const Params& p,
                                          int which, int b, int h) {
  return static_cast<const T*>(base) + b * p.st[3 * which] +
         h * p.st[3 * which + 2];
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float smem[];
  float* q_s = smem;                     // BQ * RS, pre-scaled
  float* k_s = q_s + C::BQ * C::RS;      // BK * RS
  float* v_s = k_s + C::BK * C::RS;      // BK * RS
  float* p_s = v_s + C::BK * C::RS;      // BQ * PS

  const int nq = (p.Sq + C::BQ - 1) / C::BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = iq * C::BQ;
  const int len = p.lens ? max(0, min(p.lens[b], p.Sk)) : p.Sk;
  const unsigned seed = p.dropout ? static_cast<unsigned>(p.seed[0]) : 0u;

  const T* q = slice<T>(p.q, p, 0, b, h);
  const T* k = slice<T>(p.k, p, 1, b, h);
  const T* v = slice<T>(p.v, p, 2, b, h);
  load_rows<T, D, C::RS>(q_s, q, p.st[1], q0, C::BQ, p.Sq, p.scale);

  float m[C::RM], l[C::RM], acc[C::RM][C::DM];
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < C::DM; ++d) acc[i][d] = 0.f;
  }

  int k_end = min(p.Sk, len);
  if (p.causal) k_end = min(k_end, q0 + C::BQ);
  for (int k0 = 0; k0 < k_end; k0 += C::BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D, C::RS>(k_s, k, p.st[4], k0, C::BK, p.Sk, 1.f);
    load_rows<T, D, C::RS>(v_s, v, p.st[7], k0, C::BK, p.Sk, 1.f);
    __syncthreads();

    float s[C::RM][C::CM];
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::CM; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[C::RM], kv[C::CM];
#pragma unroll
      for (int i = 0; i < C::RM; ++i) qv[i] = q_s[(ty + 16 * i) * C::RS + d];
#pragma unroll
      for (int j = 0; j < C::CM; ++j) kv[j] = k_s[(tx + 16 * j) * C::RS + d];
#pragma unroll
      for (int i = 0; i < C::RM; ++i)
#pragma unroll
        for (int j = 0; j < C::CM; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C::CM; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= len || (p.causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);  // NEG_INF start -> 0
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < C::CM; ++j) {
        float pij = s[i][j] > kNegInf * 0.5f ? expf(s[i][j] - m_new) : 0.f;
        rs += pij;  // the normalizer sees the undropped p
        if (p.dropout) pij *= drop_mult(p, seed, bh, row, k0 + tx + 16 * j);
        p_s[(ty + 16 * i) * C::PS + tx + 16 * j] = pij;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < C::DM; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < C::BK; ++c) {
      float vv[C::DM];
#pragma unroll
      for (int d = 0; d < C::DM; ++d) vv[d] = v_s[c * C::RS + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < C::RM; ++i) {
        const float pv = p_s[(ty + 16 * i) * C::PS + c];
#pragma unroll
        for (int d = 0; d < C::DM; ++d) acc[i][d] = fmaf(pv, vv[d], acc[i][d]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* o = out + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int d = 0; d < C::DM; ++d) store(o + tx + 16 * d, acc[i][d] / l_safe);
    if (tx == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + row] =
          l[i] == 0.f ? 0.f : m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// forward on the tensor cores (bfloat16, route "mma")
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kMmaWarps = 8;

template <int D>
struct MmaCfg {
  static constexpr int kThreadsM = 32 * kMmaWarps;
  static constexpr int BQ = 16 * kMmaWarps;  // query rows, 16 a warp
  static constexpr int BK = 64;          // keys per tile
  static constexpr int LD = D + 8;       // row pitch (bf16): 16 bytes past
                                         // a multiple of 128, conflict-free
  static constexpr int NS = BK / 8;      // n8 tiles of a warp's scores
  static constexpr int KQ = D / 16;      // k16 steps of Q K^T
  static constexpr int NO = D / 8;       // n8 tiles of a warp's output
  // Q, then a ring of two K tiles and two V tiles
  static constexpr size_t bytes = sizeof(bf16) * (BQ + 4 * BK) * LD;
};

// rows [r0, r0 + ROWS) of one (b, h) slice (row stride ss elements, D
// contiguous) into dst (pitch D + 8) by 16-byte cp.async; rows at or past
// limit are zero-filled without a read
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src,
                                        long long ss, int r0, int limit) {
  constexpr int CPR = D / 8;
  static_assert(ROWS * CPR % THREADS == 0, "row chunks");
#pragma unroll
  for (int u = 0; u < ROWS * CPR / THREADS; ++u) {
    const int c = threadIdx.x + u * THREADS;
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool in = r0 + r < limit;
    cp_async16(dst + r * (D + 8) + col,
               in ? src + static_cast<long long>(r0 + r) * ss + col : src,
               in ? 16 : 0);
  }
}

// two floats as one bf16x2 register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps)
    flash_fwd_mma_kernel(const Params p) {
  using C = MmaCfg<D>;
  constexpr int LD = C::LD, BQ = C::BQ, BK = C::BK, NT = C::kThreadsM;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // BQ * LD
  bf16* k_s = q_s + BQ * LD;                      // two slots of BK * LD
  bf16* v_s = k_s + 2 * BK * LD;                  // two slots of BK * LD

  const int bh = blockIdx.x;
  const int iq = gridDim.y - 1 - blockIdx.y;  // heavy tiles first
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = iq * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, lj = lane >> 3, l8 = lane & 7;
  const int qw = q0 + 16 * warp;  // the warp's first row
  const int len = p.lens ? max(0, min(p.lens[b], p.Sk)) : p.Sk;
  const unsigned seed = p.dropout ? static_cast<unsigned>(p.seed[0]) : 0u;
  const float sl2 = p.scale * kLog2e;  // scores in the log2 domain

  const bf16* q = slice<bf16>(p.q, p, 0, b, h);
  const bf16* k = slice<bf16>(p.k, p, 1, b, h);
  const bf16* v = slice<bf16>(p.v, p, 2, b, h);
  int k_end = len;
  if (p.causal) k_end = min(k_end, q0 + BQ);
  const int ntiles = (k_end + BK - 1) / BK;

  cp_rows<D, BQ, NT>(q_s, q, p.st[1], q0, p.Sq);
  if (ntiles > 0) {
    cp_rows<D, BK, NT>(k_s, k, p.st[4], 0, p.Sk);
    cp_rows<D, BK, NT>(v_s, v, p.st[7], 0, p.Sk);
  }
  cp_commit();

  unsigned qf[C::KQ][4];  // the warp's 16 Q rows as A fragments
  float o[C::NO][4];      // O: rows g and g + 8, cols 8n + 2t, +1
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // rows g and g + 8: running max (log2 domain) and this lane's part of l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    const bf16* kt = k_s + (j & 1) * BK * LD;
    const bf16* vt = v_s + (j & 1) * BK * LD;
    cp_wait_all();
    __syncthreads();  // tile j landed; the readers of tile j-1's slots are done
    if (j + 1 < ntiles) {
      cp_rows<D, BK, NT>(k_s + ((j + 1) & 1) * BK * LD, k, p.st[4], k0 + BK,
                         p.Sk);
      cp_rows<D, BK, NT>(v_s + ((j + 1) & 1) * BK * LD, v, p.st[7], k0 + BK,
                         p.Sk);
      cp_commit();
    }
    if (j == 0) {
      const bf16* pa =
          q_s + (16 * warp + (lj & 1) * 8 + l8) * LD + (lj >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < C::KQ; ++kk) ldsm_x4(qf[kk], pa + 16 * kk);
    }
    // every key of the tile lies right of the warp's rows: fully masked,
    // and skipping it leaves m, l and o as they were
    if (p.causal && k0 > qw + 15) continue;

    // S = Q K^T: 16 rows x 64 keys, K as the [n][k] operand
    float s[C::NS][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    {
      const bf16* pb = kt + ((lj >> 1) * 8 + l8) * LD + (lj & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < C::KQ; ++kk)
#pragma unroll
        for (int n = 0; n < C::NS; n += 2) {
          unsigned bk[4];
          ldsm_x4(bk, pb + n * 8 * LD + 16 * kk);
          mma_bf16(s[n], qf[kk], bk[0], bk[1]);
          mma_bf16(s[n + 1], qf[kk], bk[2], bk[3]);
        }
    }

    // online softmax on the accumulators; element e of tile n is row
    // qw + g + 8 (e >> 1), key k0 + 8n + 2t + (e & 1)
    const bool edge = k0 + BK > len || (p.causal && k0 + BK - 1 > qw);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int row = qw + g + 8 * (e >> 1);
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          if (col >= len || (p.causal && col > row)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);  // NEG_INF start -> 0
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // p, rounded to bf16, as the A fragments of P V: k16 step kk takes
    // tiles 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3])
    unsigned pf[BK / 16][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = exp2f(s[n][e] - m[e >> 1]);
        if (edge && s[n][e] <= kNegInf * 0.5f) pe[e] = 0.f;
        l[e >> 1] += pe[e];  // the normalizer sees the undropped p
        if (p.dropout)
          pe[e] *= drop_mult(p, seed, bh, qw + g + 8 * (e >> 1),
                             k0 + 8 * n + 2 * t + (e & 1));
      }
      pf[n >> 1][(n & 1) * 2] = pack_bf16(pe[0], pe[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
    }
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V, V as the [k][n] operand through ldmatrix.trans
    {
      const bf16* pv = vt + ((lj & 1) * 8 + l8) * LD + (lj >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < C::NO; n += 2) {
          unsigned bv[4];
          ldsm_x4_t(bv, pv + 16 * kk * LD + 8 * n);
          mma_bf16(o[n], pf[kk], bv[0], bv[1]);
          mma_bf16(o[n + 1], pf[kk], bv[2], bv[3]);
        }
    }
  }

  // l over the 4 lanes of each row; out = O / l through the warp's own Q
  // rows (no copy into them is in flight after the barrier), 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  cp_wait_all();
  __syncthreads();
  const float ls0 = l[0] == 0.f ? 1.f : l[0];
  const float ls1 = l[1] == 0.f ? 1.f : l[1];
  bf16* stage = q_s + 16 * warp * LD;
#pragma unroll
  for (int n = 0; n < C::NO; ++n) {
    const int col = 8 * n + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + col) =
        __floats2bfloat162_rn(o[n][0] / ls0, o[n][1] / ls0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[n][2] / ls1, o[n][3] / ls1);
  }
  __syncwarp();
  bf16* out = static_cast<bf16*>(p.out);
  constexpr int CPR = D / 8;
#pragma unroll
  for (int u = 0; u < 16 * CPR / 32; ++u) {
    const int c = lane + 32 * u;
    const int r = c / CPR, col = (c % CPR) * 8;
    const int row = qw + r;
    if (row < p.Sq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D +
          col) = *reinterpret_cast<const uint4*>(stage + r * LD + col);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw + g + 8 * r;
      if (row < p.Sq)
        p.lse[static_cast<long long>(bh) * p.Sq + row] =
            l[r] == 0.f ? 0.f : m[r] * kLn2 + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float smem[];
  float* q_s = smem;                     // BQ * RS, pre-scaled
  float* do_s = q_s + C::BQ * C::RS;     // BQ * RS
  float* k_s = do_s + C::BQ * C::RS;     // BK * RS
  float* v_s = k_s + C::BK * C::RS;      // BK * RS
  float* ds_s = v_s + C::BK * C::RS;     // BQ * PS
  float* lse_s = ds_s + C::BQ * C::PS;   // BQ
  float* dl_s = lse_s + C::BQ;           // BQ

  const int nq = (p.Sq + C::BQ - 1) / C::BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = iq * C::BQ;
  const int len = p.lens ? max(0, min(p.lens[b], p.Sk)) : p.Sk;
  const unsigned seed = p.dropout ? static_cast<unsigned>(p.seed[0]) : 0u;

  load_rows<T, D, C::RS>(q_s, slice<T>(p.q, p, 0, b, h), p.st[1], q0, C::BQ,
                         p.Sq, p.scale);
  load_rows<T, D, C::RS>(do_s, slice<T>(p.dout, p, 3, b, h), p.st[10], q0,
                         C::BQ, p.Sq, 1.f);
  for (int r = threadIdx.x; r < C::BQ; r += kThreads) {
    const bool in = q0 + r < p.Sq;
    const long long g = static_cast<long long>(bh) * p.Sq + q0 + r;
    lse_s[r] = in ? p.lse[g] : 0.f;
    dl_s[r] = in ? p.delta[g] : 0.f;
  }
  const T* k = slice<T>(p.k, p, 1, b, h);
  const T* v = slice<T>(p.v, p, 2, b, h);

  float acc[C::RM][C::DM];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int d = 0; d < C::DM; ++d) acc[i][d] = 0.f;

  int k_end = min(p.Sk, len);
  if (p.causal) k_end = min(k_end, q0 + C::BQ);
  for (int k0 = 0; k0 < k_end; k0 += C::BK) {
    __syncthreads();
    load_rows<T, D, C::RS>(k_s, k, p.st[4], k0, C::BK, p.Sk, 1.f);
    load_rows<T, D, C::RS>(v_s, v, p.st[7], k0, C::BK, p.Sk, 1.f);
    __syncthreads();

    float s[C::RM][C::CM], dp[C::RM][C::CM];
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::CM; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[C::RM], ov[C::RM], kv[C::CM], vv[C::CM];
#pragma unroll
      for (int i = 0; i < C::RM; ++i) {
        qv[i] = q_s[(ty + 16 * i) * C::RS + d];
        ov[i] = do_s[(ty + 16 * i) * C::RS + d];
      }
#pragma unroll
      for (int j = 0; j < C::CM; ++j) {
        kv[j] = k_s[(tx + 16 * j) * C::RS + d];
        vv[j] = v_s[(tx + 16 * j) * C::RS + d];
      }
#pragma unroll
      for (int i = 0; i < C::RM; ++i)
#pragma unroll
        for (int j = 0; j < C::CM; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < C::CM; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < len && !(p.causal && col > row);
        // a masked score is NEG_INF, and exp(NEG_INF - lse) is exactly 0
        const float pij = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
        float dpij = dp[i][j];
        if (p.dropout) dpij *= drop_mult(p, seed, bh, row, col);
        ds_s[r * C::PS + tx + 16 * j] = pij * (dpij - dl_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < C::BK; ++c) {
      float kv[C::DM];
#pragma unroll
      for (int d = 0; d < C::DM; ++d) kv[d] = k_s[c * C::RS + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < C::RM; ++i) {
        const float dsv = ds_s[(ty + 16 * i) * C::PS + c];
#pragma unroll
        for (int d = 0; d < C::DM; ++d) acc[i][d] = fmaf(dsv, kv[d], acc[i][d]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    T* o = dq + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int d = 0; d < C::DM; ++d) store(o + tx + 16 * d, p.scale * acc[i][d]);
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float smem[];
  float* k_s = smem;                     // BK * RS
  float* v_s = k_s + C::BK * C::RS;      // BK * RS
  float* q_s = v_s + C::BK * C::RS;      // BQ * RS, raw (unscaled)
  float* do_s = q_s + C::BQ * C::RS;     // BQ * RS
  float* pt_s = do_s + C::BQ * C::RS;    // BK * PT: (m∘p)^T
  float* dst_s = pt_s + C::BK * C::PT;   // BK * PT: ds^T
  float* lse_s = dst_s + C::BK * C::PT;  // BQ
  float* dl_s = lse_s + C::BQ;           // BQ

  const int ik = blockIdx.x;  // low key tiles see the most queries: first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = ik * C::BK;
  const int len = p.lens ? max(0, min(p.lens[b], p.Sk)) : p.Sk;
  const unsigned seed = p.dropout ? static_cast<unsigned>(p.seed[0]) : 0u;

  load_rows<T, D, C::RS>(k_s, slice<T>(p.k, p, 1, b, h), p.st[4], k0, C::BK,
                         p.Sk, 1.f);
  load_rows<T, D, C::RS>(v_s, slice<T>(p.v, p, 2, b, h), p.st[7], k0, C::BK,
                         p.Sk, 1.f);
  const T* q = slice<T>(p.q, p, 0, b, h);
  const T* dout = slice<T>(p.dout, p, 3, b, h);

  float adk[C::CM][C::DM], adv[C::CM][C::DM];
#pragma unroll
  for (int i = 0; i < C::CM; ++i)
#pragma unroll
    for (int d = 0; d < C::DM; ++d) adk[i][d] = adv[i][d] = 0.f;

  // columns at or past len are masked for every row: their grads stay 0
  const int q_begin = k0 >= len ? p.Sq : (p.causal ? (k0 / C::BQ) * C::BQ : 0);
  for (int q0 = q_begin; q0 < p.Sq; q0 += C::BQ) {
    __syncthreads();
    load_rows<T, D, C::RS>(q_s, q, p.st[1], q0, C::BQ, p.Sq, 1.f);
    load_rows<T, D, C::RS>(do_s, dout, p.st[10], q0, C::BQ, p.Sq, 1.f);
    for (int r = threadIdx.x; r < C::BQ; r += kThreads) {
      const bool in = q0 + r < p.Sq;
      const long long g = static_cast<long long>(bh) * p.Sq + q0 + r;
      lse_s[r] = in ? p.lse[g] : 0.f;
      dl_s[r] = in ? p.delta[g] : 0.f;
    }
    __syncthreads();

    // transposed tiles: key rows c = ty + 16i, query rows r = tx + 16j
    float s[C::CM][C::RM], dp[C::CM][C::RM];
#pragma unroll
    for (int i = 0; i < C::CM; ++i)
#pragma unroll
      for (int j = 0; j < C::RM; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[C::CM], vv[C::CM], qv[C::RM], ov[C::RM];
#pragma unroll
      for (int i = 0; i < C::CM; ++i) {
        kv[i] = k_s[(ty + 16 * i) * C::RS + d];
        vv[i] = v_s[(ty + 16 * i) * C::RS + d];
      }
#pragma unroll
      for (int j = 0; j < C::RM; ++j) {
        qv[j] = q_s[(tx + 16 * j) * C::RS + d];
        ov[j] = do_s[(tx + 16 * j) * C::RS + d];
      }
#pragma unroll
      for (int i = 0; i < C::CM; ++i)
#pragma unroll
        for (int j = 0; j < C::RM; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < C::CM; ++i) {
      const int c = ty + 16 * i;
      const int col = k0 + c;
#pragma unroll
      for (int j = 0; j < C::RM; ++j) {
        const int r = tx + 16 * j;
        const int row = q0 + r;
        const bool ok = row < p.Sq && col < len && !(p.causal && col > row);
        const float pij = ok ? expf(p.scale * s[i][j] - lse_s[r]) : 0.f;
        const float mult =
            p.dropout ? drop_mult(p, seed, bh, row, col) : 1.f;
        pt_s[c * C::PT + r] = pij * mult;
        dst_s[c * C::PT + r] = pij * (dp[i][j] * mult - dl_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < C::BQ; ++r) {
      float qv[C::DM], ov[C::DM];
#pragma unroll
      for (int d = 0; d < C::DM; ++d) {
        qv[d] = q_s[r * C::RS + tx + 16 * d];
        ov[d] = do_s[r * C::RS + tx + 16 * d];
      }
#pragma unroll
      for (int i = 0; i < C::CM; ++i) {
        const float pv = pt_s[(ty + 16 * i) * C::PT + r];
        const float dsv = dst_s[(ty + 16 * i) * C::PT + r];
#pragma unroll
        for (int d = 0; d < C::DM; ++d) {
          adv[i][d] = fmaf(pv, ov[d], adv[i][d]);
          adk[i][d] = fmaf(dsv, qv[d], adk[i][d]);
        }
      }
    }
  }

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < C::CM; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= p.Sk) continue;
    const long long o = ((static_cast<long long>(b) * p.Sk + col) * p.H + h) * D;
#pragma unroll
    for (int d = 0; d < C::DM; ++d) {
      store(dk + o + tx + 16 * d, p.scale * adk[i][d]);
      store(dv + o + tx + 16 * d, adv[i][d]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { kFwd = 0, kDq = 1, kDkv = 2, kFwdMma = 3 };

template <int D>
size_t smem_bytes(Which w) {
  using C = Cfg<D>;
  size_t f = 0;
  if (w == kFwd) f = (C::BQ + 2 * C::BK) * C::RS + C::BQ * C::PS;
  if (w == kDq) f = (2 * C::BQ + 2 * C::BK) * C::RS + C::BQ * C::PS + 2 * C::BQ;
  if (w == kDkv)
    f = (2 * C::BQ + 2 * C::BK) * C::RS + 2 * C::BK * C::PT + 2 * C::BQ;
  return f * sizeof(float);
}

template <typename T, int D>
cudaError_t launch(Which w, const Params& p, cudaStream_t stream) {
  using C = Cfg<D>;
  void (*kernel)(const Params) = w == kFwd   ? flash_fwd_kernel<T, D>
                                 : w == kDq  ? flash_dq_kernel<T, D>
                                             : flash_dkv_kernel<T, D>;
  const size_t smem = smem_bytes<D>(w);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int tiles = w == kDkv ? (p.Sk + C::BK - 1) / C::BK
                              : (p.Sq + C::BQ - 1) / C::BQ;
  const dim3 grid(tiles, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, Which w, const Params& p, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(w, p, s);
    case 128:
      return launch<T, 128>(w, p, s);
    case 256:
      return launch<T, 256>(w, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  using C = MmaCfg<D>;
  void (*kernel)(const Params) = flash_fwd_mma_kernel<D>;
  if (C::bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.B * p.H, (p.Sq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::kThreadsM, C::bytes, stream>>>(p);
  return cudaGetLastError();
}

// the mma forward's limits: D 64 or 128, q/k/v and their (b, s, h) strides
// on 16-byte boundaries (cp.async)
cudaError_t dispatch_mma(int D, const Params& p, cudaStream_t s) {
  const void* ptrs[3] = {p.q, p.k, p.v};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<std::uintptr_t>(ptr) % 16)
      return cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (p.st[i] % 8) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_mma<64>(p, s);
    case 128:
      return launch_mma<128>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Which w, Params& p, const long long* strides, int D, int bf16,
        void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Sq <= 0 || p.Sk <= 0) return 0;
  if (p.dropout && (p.drop_bq < 1 || p.drop_bk < 1 || p.seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (w == kFwdMma)
    e = bf16 ? dispatch_mma(D, p, s) : cudaErrorInvalidValue;
  else
    e = bf16 ? dispatch_d<__nv_bfloat16>(D, w, p, s)
             : dispatch_d<float>(D, w, p, s);
  return static_cast<int>(e);
}

Params make(const void* q, const void* k, const void* v, const void* dout,
            const void* lens, const void* seed, int B, int H, int Sq, int Sk,
            float scale, int causal, int dropout, unsigned thresh,
            float drop_scale, int drop_bq, int drop_bk) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lens = static_cast<const int*>(lens);
  p.seed = static_cast<const int*>(seed);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.thresh = thresh;
  p.drop_scale = drop_scale;
  p.drop_bq = drop_bq;
  p.drop_bk = drop_bk;
  return p;
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch.
// strides: 12 element strides, (b, s, h) of q, k, v, dout in that order
// (dout's are ignored by the forward). bf16: 0 for float32 inputs, 1 for
// bfloat16. lens may be null (every key valid); seed is a device int32
// read only when dropout is on.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const long long* strides, void* out, void* lse,
                        const void* lens, const void* seed, int B, int H,
                        int Sq, int Sk, int D, int bf16, float scale,
                        int causal, int dropout, unsigned thresh,
                        float drop_scale, int drop_bq, int drop_bk,
                        void* stream) {
  Params p = make(q, k, v, nullptr, lens, seed, B, H, Sq, Sk, scale, causal,
                  dropout, thresh, drop_scale, drop_bq, drop_bk);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  return run(kFwd, p, strides, D, bf16, stream);
}

// The forward on the tensor cores: bfloat16 only (bf16 must be 1), D 64 or
// 128; q, k, v and their (b, s, h) strides on 16-byte boundaries. Anything else returns
// cudaErrorInvalidValue without a launch.
int flash_attention_fwd_mma(const void* q, const void* k, const void* v,
                            const long long* strides, void* out, void* lse,
                            const void* lens, const void* seed, int B, int H,
                            int Sq, int Sk, int D, int bf16, float scale,
                            int causal, int dropout, unsigned thresh,
                            float drop_scale, int drop_bq, int drop_bk,
                            void* stream) {
  Params p = make(q, k, v, nullptr, lens, seed, B, H, Sq, Sk, scale, causal,
                  dropout, thresh, drop_scale, drop_bq, drop_bk);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  return run(kFwdMma, p, strides, D, bf16, stream);
}

int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* dout, const long long* strides,
                       const void* lse, const void* delta, void* dq,
                       const void* lens, const void* seed, int B, int H,
                       int Sq, int Sk, int D, int bf16, float scale,
                       int causal, int dropout, unsigned thresh,
                       float drop_scale, int drop_bq, int drop_bk,
                       void* stream) {
  Params p = make(q, k, v, dout, lens, seed, B, H, Sq, Sk, scale, causal,
                  dropout, thresh, drop_scale, drop_bq, drop_bk);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return run(kDq, p, strides, D, bf16, stream);
}

int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const long long* strides,
                        const void* lse, const void* delta, void* dk,
                        void* dv, const void* lens, const void* seed, int B,
                        int H, int Sq, int Sk, int D, int bf16, float scale,
                        int causal, int dropout, unsigned thresh,
                        float drop_scale, int drop_bq, int drop_bk,
                        void* stream) {
  Params p = make(q, k, v, dout, lens, seed, B, H, Sq, Sk, scale, causal,
                  dropout, thresh, drop_scale, drop_bq, drop_bk);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, p, strides, D, bf16, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
