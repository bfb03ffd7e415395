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
// Two kernels for each backward product, picked by the wrapper
// (ops/flash_attention.py, bwd_route, the forward's rule with dout's rows
// too): flash_dq_mma_kernel and flash_dkv_mma_kernel (route "mma", on the
// forward's mma.sync core: see each kernel's note) and flash_dq_kernel and
// flash_dkv_kernel (route "scalar"). The mma pair keeps the reference's
// two passes: dq over key tiles, dk/dv over query tiles, each output
// element with one owner and a fixed summation order (no atomics, repeat
// launches give the same bits); S and dP are recomputed in both (7
// products where one pass with atomics would take 5). Their new roundings
// against the scalar kernels: p and ds to bf16 before the products they
// feed.
//
// flash_fwd_kernel (route "scalar": float32, D = 256, unaligned rows) and
// the scalar backward kernels: one block of 256 threads (16 x 16) per
// (q tile, b*h) for the forward and dq, per (k tile, b*h) for dk/dv; the
// TPU grid's sequential axis becomes a loop inside the block over the
// other side's tiles. Tiles are BQ = BK = 64 rows (32 at D = 256), staged as float32
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
// below the tensor-core rate.

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

// the keep decision of _dropout_mask, bit-equal: uint32 arithmetic wraps
// as jnp.uint32 does
__device__ __forceinline__ bool drop_keep(const Params& p, unsigned seed,
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
  return h >= p.thresh;
}

// _dropout_mask itself: 1 / (1 - rate) where kept, else 0
__device__ __forceinline__ float drop_mult(const Params& p, unsigned seed,
                                           unsigned bh, int row, int col) {
  return drop_keep(p, seed, bh, row, col) ? p.drop_scale : 0.f;
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
    // tiles 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3]). Dropout zeroes the
    // dropped p; its 1 / (1 - rate) scales the output in float32, never
    // rounded into p
    unsigned pf[BK / 16][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = exp2f(s[n][e] - m[e >> 1]);
        if (edge && s[n][e] <= kNegInf * 0.5f) pe[e] = 0.f;
        l[e >> 1] += pe[e];  // the normalizer sees the undropped p
        if (p.dropout && !drop_keep(p, seed, bh, qw + g + 8 * (e >> 1),
                                    k0 + 8 * n + 2 * t + (e & 1)))
          pe[e] = 0.f;
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
  const float osc = p.dropout ? p.drop_scale : 1.f;
  bf16* stage = q_s + 16 * warp * LD;
#pragma unroll
  for (int n = 0; n < C::NO; ++n) {
    const int col = 8 * n + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + col) =
        __floats2bfloat162_rn(o[n][0] * osc / ls0, o[n][1] * osc / ls0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[n][2] * osc / ls1, o[n][3] * osc / ls1);
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
// dq and dk/dv on the tensor cores (bfloat16, route "mma")
// ---------------------------------------------------------------------------
template <int D>
struct MmaBwdCfg {
  static constexpr int kThreadsM = 32 * kMmaWarps;
  static constexpr int BR = 16 * kMmaWarps;  // a block's own rows, 16 a warp:
                                             // queries (dq), keys (dk/dv)
  static constexpr int BT = 32;              // streamed rows a tile
  static constexpr int LD = D + 8;           // row pitch (bf16), as MmaCfg
  static constexpr int NS = BT / 8;          // n8 tiles of a warp's scores
  static constexpr int KQ = D / 16;          // k16 steps over D
  static constexpr int NO = D / 8;           // n8 tiles of a warp's output
  static constexpr int KT = BT / 16;         // k16 steps over a tile
  // the warp's own rows as A fragments: held in registers (dq; dk/dv at
  // D = 128) or read from shared memory at each use (dk/dv at D = 64,
  // whose two D-wide sums leave no room for them in 128 registers). At
  // D = 64 both kernels are held to 128 registers for two blocks an SM
  // (dk/dv spills 36 bytes for it). Each choice here was timed against
  // its alternatives in turns on the H100 (tests/torch_flash_variants.py)
  static constexpr bool kHoldDq = true;
  static constexpr bool kHoldDkv = D > 64;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;  // __launch_bounds__
  // own rows of two operands (BR each), a ring of two tiles of two
  // operands (BT each); dk/dv adds two slots of a tile's lse and delta
  static constexpr size_t bf16_bytes = sizeof(bf16) * (2 * BR + 4 * BT) * LD;
  static constexpr size_t dq_bytes = bf16_bytes;
  static constexpr size_t dkv_bytes = bf16_bytes + sizeof(float) * 4 * BT;
};

// a warp's 16 own rows as mma A fragments, k16 step kk of D: held in
// registers (HOLD) or read by ldmatrix at each use; base is this lane's
// ldmatrix row address of step 0
template <int KQ, bool HOLD>
struct RowFrags {
  unsigned r[HOLD ? KQ : 1][4];
  const bf16* base;
  __device__ __forceinline__ void load(const bf16* p) {
    base = p;
    if constexpr (HOLD) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) ldsm_x4(r[kk], p + 16 * kk);
    }
  }
  __device__ __forceinline__ void at(unsigned (&a)[4], int kk) const {
    if constexpr (HOLD) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = r[kk][e];
    } else {
      ldsm_x4(a, base + 16 * kk);
    }
  }
};

// c (16 x 8 NS) = A B^T over D: A the warp's rows, B a tile's rows as the
// [n][k] operand (ldmatrix), pb this lane's address in the tile
template <int NS, int KQ, int LD, class A>
__device__ __forceinline__ void mma_rows_by_tile(float (&c)[NS][4],
                                                 const A& a, const bf16* pb) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    unsigned af[4];
    a.at(af, kk);
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      unsigned bk[4];
      ldsm_x4(bk, pb + n * 8 * LD + 16 * kk);
      mma_bf16(c[n], af, bk[0], bk[1]);
      mma_bf16(c[n + 1], af, bk[2], bk[3]);
    }
  }
}

// o (16 x D) += A B over a tile: A packed from score accumulators (KT k16
// steps), B the tile's rows as the [k][n] operand (ldmatrix.trans), pv
// this lane's address in the tile
template <int NO, int KT, int LD>
__device__ __forceinline__ void mma_scores_by_tile(float (&o)[NO][4],
                                                   unsigned (&a)[KT][4],
                                                   const bf16* pv) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      unsigned bv[4];
      ldsm_x4_t(bv, pv + 16 * kk * LD + 8 * n);
      mma_bf16(o[n], a[kk], bv[0], bv[1]);
      mma_bf16(o[n + 1], a[kk], bv[2], bv[3]);
    }
}

// ds = p∘(m∘dp − delta): the score gradient both backward kernels form
__device__ __forceinline__ float score_grad(float p, float dp, float delta) {
  return p * (dp - delta);
}

// a warp's 16 rows of a (16 x D) float32 sum, times mul, rounded to bf16,
// to rows [row0, row0 + 16) of a contiguous (B, S, H, D) output (rows at or
// past S are not written), through stage (the warp's 16 rows of shared
// memory, pitch D + 8) for 16-byte stores
template <int D, int NO>
__device__ __forceinline__ void store_rows(bf16* out, bf16* stage,
                                           float (&o)[NO][4],
                                           float mul, const Params& p,
                                           int b, int h, int row0, int S) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = 8 * n + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + col) =
        __floats2bfloat162_rn(o[n][0] * mul, o[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[n][2] * mul, o[n][3] * mul);
  }
  __syncwarp();
  constexpr int CPR = D / 8;
#pragma unroll
  for (int u = 0; u < 16 * CPR / 32; ++u) {
    const int c = lane + 32 * u;
    const int r = c / CPR, col = (c % CPR) * 8;
    const int row = row0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<long long>(b) * S + row) * p.H + h) * D +
          col) = *reinterpret_cast<const uint4*>(stage + r * LD + col);
  }
}

// dq. Bound on this card: 3 products of B*H*S*S*D/2 multiply-adds (causal)
// on the tensor cores. One block of 8 warps per (b*h, 128 query rows), 16
// a warp, heavy tiles first. Q and dO are read once by cp.async and serve
// as A fragments for the whole key loop (RowFrags); K/V tiles of BT keys
// go through a two-slot cp.async ring (tile j+1 loads while tile j
// computes). A tile:
// S = Q K^T and dP = dO V^T (K and V as the [n][k] operand), then
// p = exp2(s*scale*log2e - lse*log2e) and ds = p∘(m∘dp - delta) on the
// accumulators (lse and delta per row, in registers), ds rounded to bf16
// and packed straight into the A fragments of dQ += dS K (K as the [k][n]
// operand, ldmatrix.trans, from the same shared copy). Each dq element is
// summed by one thread over the key tiles in order: no atomics.
template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps, MmaBwdCfg<D>::kMinBlocks)
    flash_dq_mma_kernel(const Params p) {
  using C = MmaBwdCfg<D>;
  constexpr int LD = C::LD, BR = C::BR, BT = C::BT, NT = C::kThreadsM;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // BR * LD
  bf16* do_s = q_s + BR * LD;                     // BR * LD
  bf16* k_s = do_s + BR * LD;                     // two slots of BT * LD
  bf16* v_s = k_s + 2 * BT * LD;                  // two slots of BT * LD

  const int bh = blockIdx.x;
  const int iq = gridDim.y - 1 - blockIdx.y;  // heavy tiles first
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = iq * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, lj = lane >> 3, l8 = lane & 7;
  const int qw = q0 + 16 * warp;  // the warp's first row
  const int len = p.lens ? max(0, min(p.lens[b], p.Sk)) : p.Sk;
  const unsigned seed = p.dropout ? static_cast<unsigned>(p.seed[0]) : 0u;
  const float sl2 = p.scale * kLog2e;  // scores in the log2 domain

  const bf16* q = slice<bf16>(p.q, p, 0, b, h);
  const bf16* k = slice<bf16>(p.k, p, 1, b, h);
  const bf16* v = slice<bf16>(p.v, p, 2, b, h);
  const bf16* dout = slice<bf16>(p.dout, p, 3, b, h);
  int k_end = len;
  if (p.causal) k_end = min(k_end, q0 + BR);
  const int ntiles = (k_end + BT - 1) / BT;

  cp_rows<D, BR, NT>(q_s, q, p.st[1], q0, p.Sq);
  cp_rows<D, BR, NT>(do_s, dout, p.st[10], q0, p.Sq);
  if (ntiles > 0) {
    cp_rows<D, BT, NT>(k_s, k, p.st[4], 0, p.Sk);
    cp_rows<D, BT, NT>(v_s, v, p.st[7], 0, p.Sk);
  }
  cp_commit();

  // rows g and g + 8: lse (log2 domain) and delta; rows past Sq read 0
  // (their q and dO rows are zero, so their ds is 0; they are not stored)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    const long long i = static_cast<long long>(bh) * p.Sq + row;
    lse2[r] = row < p.Sq ? p.lse[i] * kLog2e : 0.f;
    dl[r] = row < p.Sq ? p.delta[i] : 0.f;
  }

  RowFrags<C::KQ, C::kHoldDq> qa, oa;
  float acc[C::NO][4];  // dQ / scale: rows g and g + 8, cols 8n + 2t, +1
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int nk = ((lj >> 1) * 8 + l8) * LD + (lj & 1) * 8;  // [n][k] address
  const int kn = ((lj & 1) * 8 + l8) * LD + (lj >> 1) * 8;  // [k][n] address

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BT;
    const bf16* kt = k_s + (j & 1) * BT * LD;
    const bf16* vt = v_s + (j & 1) * BT * LD;
    cp_wait_all();
    __syncthreads();  // tile j landed; the readers of tile j-1's slots are done
    if (j + 1 < ntiles) {
      cp_rows<D, BT, NT>(k_s + ((j + 1) & 1) * BT * LD, k, p.st[4], k0 + BT,
                         p.Sk);
      cp_rows<D, BT, NT>(v_s + ((j + 1) & 1) * BT * LD, v, p.st[7], k0 + BT,
                         p.Sk);
      cp_commit();
    }
    if (j == 0) {
      qa.load(q_s + 16 * warp * LD + kn);
      oa.load(do_s + 16 * warp * LD + kn);
    }
    // causal: the tile's first key lies right of the warp's last row, so
    // every p of the tile is 0 for the warp and it adds nothing
    if (p.causal && k0 >= qw + 16) continue;

    float s[C::NS][4], dp[C::NS][4];
    mma_rows_by_tile<C::NS, C::KQ, LD>(s, qa, kt + nk);
    mma_rows_by_tile<C::NS, C::KQ, LD>(dp, oa, vt + nk);

    // element e of tile n is row qw + g + 8 (e >> 1), key k0 + 8n + 2t +
    // (e & 1); masks only on tiles that cross lens[b] or the diagonal
    const bool edge = k0 + BT > len || (p.causal && k0 + BT - 1 > qw);
    unsigned dsf[C::KT][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qw + g + 8 * (e >> 1);
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        float pe = exp2f(fmaf(s[n][e], sl2, -lse2[e >> 1]));
        if (edge && (col >= len || (p.causal && col > row))) pe = 0.f;
        float dpe = dp[n][e];
        if (p.dropout) dpe *= drop_mult(p, seed, bh, row, col);
        ds[e] = score_grad(pe, dpe, dl[e >> 1]);
      }
      dsf[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_scores_by_tile<C::NO, C::KT, LD>(acc, dsf, kt + kn);
  }

  // out through the warp's own Q rows: no copy into them is in flight
  // after the wait and the barrier, and no warp reads them any more
  cp_wait_all();
  __syncthreads();
  store_rows<D, C::NO>(static_cast<bf16*>(p.dq), q_s + 16 * warp * LD, acc,
                       p.scale, p, b, h, qw, p.Sq);
}

// the lse and delta of queries [q0, q0 + BT) into dst[0, BT) and
// dst[BT, 2 BT) by 4-byte cp.async; queries at or past Sq read 0
template <int BT>
__device__ __forceinline__ void cp_stats(float* dst, const Params& p, int bh,
                                         int q0) {
  const int i = threadIdx.x;
  if (i < 2 * BT) {
    const int r = i % BT;
    const float* src =
        (i < BT ? p.lse : p.delta) + static_cast<long long>(bh) * p.Sq;
    const bool in = q0 + r < p.Sq;
    cp_async4(dst + i, in ? src + q0 + r : src, in ? 4 : 0);
  }
}

// dk/dv. Bound on this card: 4 products of B*H*S*S*D/2 multiply-adds
// (causal) on the tensor cores. One block of 8 warps per (b*h, 128 key
// rows), 16 a warp, low key tiles (which see the most queries when causal)
// first. K and V are read once and serve as A fragments; Q, dO, lse and
// delta tiles of BT queries go through a two-slot cp.async ring. The
// products are the transposed ones, so nothing round-trips through shared
// memory: S^T = K Q^T and dP^T = V dO^T (Q, dO as [n][k]); p^T and ds^T on
// the accumulators (lse and delta per column, from the tile's shared
// copy); m∘p and ds rounded to bf16 and packed into the A fragments of
// dV += (m∘p)^T dO and dK += ds^T Q (dO, Q as [k][n] through
// ldmatrix.trans from the same shared copy). A warp skips the query tiles
// that lie wholly above its keys (causal) and every tile once its keys are
// all at or past lens[b]. One owner per dk/dv element, a fixed order.
template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps, MmaBwdCfg<D>::kMinBlocks)
    flash_dkv_mma_kernel(const Params p) {
  using C = MmaBwdCfg<D>;
  constexpr int LD = C::LD, BR = C::BR, BT = C::BT, NT = C::kThreadsM;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(mma_smem);  // BR * LD
  bf16* v_s = k_s + BR * LD;                      // BR * LD
  bf16* q_s = v_s + BR * LD;                      // two slots of BT * LD
  bf16* do_s = q_s + 2 * BT * LD;                 // two slots of BT * LD
  float* stat_s = reinterpret_cast<float*>(do_s + 2 * BT * LD);  // two
                                        // slots of BT lse, then BT delta

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BR;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, lj = lane >> 3, l8 = lane & 7;
  const int kw = k0 + 16 * warp;  // the warp's first key
  const int len = p.lens ? max(0, min(p.lens[b], p.Sk)) : p.Sk;
  const unsigned seed = p.dropout ? static_cast<unsigned>(p.seed[0]) : 0u;
  const float osc = p.dropout ? p.drop_scale : 1.f;
  const float sl2 = p.scale * kLog2e;

  const bf16* q = slice<bf16>(p.q, p, 0, b, h);
  const bf16* dout = slice<bf16>(p.dout, p, 3, b, h);
  // causal: queries below k0 see none of the block's keys; keys at or past
  // len are masked for every query: their dk and dv are 0
  const int q_begin = p.causal ? k0 : 0;
  const int ntiles = k0 >= len ? 0 : max(0, (p.Sq - q_begin + BT - 1) / BT);

  cp_rows<D, BR, NT>(k_s, slice<bf16>(p.k, p, 1, b, h), p.st[4], k0, p.Sk);
  cp_rows<D, BR, NT>(v_s, slice<bf16>(p.v, p, 2, b, h), p.st[7], k0, p.Sk);
  if (ntiles > 0) {
    cp_rows<D, BT, NT>(q_s, q, p.st[1], q_begin, p.Sq);
    cp_rows<D, BT, NT>(do_s, dout, p.st[10], q_begin, p.Sq);
    cp_stats<BT>(stat_s, p, bh, q_begin);
  }
  cp_commit();

  RowFrags<C::KQ, C::kHoldDkv> ka, va;
  float dk[C::NO][4], dv[C::NO][4];  // keys g and g + 8, cols 8n + 2t, +1
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int nk = ((lj >> 1) * 8 + l8) * LD + (lj & 1) * 8;
  const int kn = ((lj & 1) * 8 + l8) * LD + (lj >> 1) * 8;

  for (int j = 0; j < ntiles; ++j) {
    const int q0 = q_begin + j * BT;
    const int slot = j & 1;
    const bf16* qt = q_s + slot * BT * LD;
    const bf16* ot = do_s + slot * BT * LD;
    const float* lse_t = stat_s + slot * 2 * BT;
    const float* dl_t = lse_t + BT;
    cp_wait_all();
    __syncthreads();
    if (j + 1 < ntiles) {
      cp_rows<D, BT, NT>(q_s + (slot ^ 1) * BT * LD, q, p.st[1], q0 + BT,
                         p.Sq);
      cp_rows<D, BT, NT>(do_s + (slot ^ 1) * BT * LD, dout, p.st[10],
                         q0 + BT, p.Sq);
      cp_stats<BT>(stat_s + (slot ^ 1) * 2 * BT, p, bh, q0 + BT);
      cp_commit();
    }
    if (j == 0) {
      ka.load(k_s + 16 * warp * LD + kn);
      va.load(v_s + 16 * warp * LD + kn);
    }
    // every query of the tile lies above the warp's keys (causal), or no
    // key of the warp is visible: every p of the tile is 0 for the warp
    if ((p.causal && q0 + BT <= kw) || kw >= len) continue;

    float s[C::NS][4], dp[C::NS][4];  // S^T, dP^T: keys x queries
    mma_rows_by_tile<C::NS, C::KQ, LD>(s, ka, qt + nk);
    mma_rows_by_tile<C::NS, C::KQ, LD>(dp, va, ot + nk);

    // element e of tile n is key kw + g + 8 (e >> 1), query q0 + 8n + 2t +
    // (e & 1); the dropout hash keys on (row = query, col = key). As in the
    // forward, the dropped p is zeroed before its bf16 rounding and the
    // 1 / (1 - rate) scales dv in float32 at the store
    const bool edge =
        q0 + BT > p.Sq || kw + 16 > len || (p.causal && kw + 15 > q0);
    unsigned pf[C::KT][4], dsf[C::KT][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      float pm[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw + g + 8 * (e >> 1);
        const int c = 8 * n + 2 * t + (e & 1);
        const int query = q0 + c;
        float pe = exp2f(fmaf(s[n][e], sl2, -lse_t[c] * kLog2e));
        if (edge && (query >= p.Sq || key >= len ||
                     (p.causal && key > query)))
          pe = 0.f;
        const bool keep = !p.dropout || drop_keep(p, seed, bh, query, key);
        pm[e] = keep ? pe : 0.f;
        ds[e] = score_grad(pe, keep ? dp[n][e] * osc : 0.f, dl_t[c]);
      }
      pf[n >> 1][(n & 1) * 2] = pack_bf16(pm[0], pm[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pm[2], pm[3]);
      dsf[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_scores_by_tile<C::NO, C::KT, LD>(dv, pf, ot + kn);
    mma_scores_by_tile<C::NO, C::KT, LD>(dk, dsf, qt + kn);
  }

  // out through the warp's own K and V rows (no copy in flight after the
  // wait and the barrier; no warp reads them any more); keys past Sk are
  // not written, keys at or past len get 0
  cp_wait_all();
  __syncthreads();
  store_rows<D, C::NO>(static_cast<bf16*>(p.dk), k_s + 16 * warp * LD, dk,
                       p.scale, p, b, h, kw, p.Sk);
  store_rows<D, C::NO>(static_cast<bf16*>(p.dv), v_s + 16 * warp * LD, dv,
                       osc, p, b, h, kw, p.Sk);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { kFwd = 0, kDq = 1, kDkv = 2, kFwdMma = 3, kDqMma = 4,
             kDkvMma = 5 };

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

template <int D>
cudaError_t launch_bwd_mma(Which w, const Params& p, cudaStream_t stream) {
  using C = MmaBwdCfg<D>;
  void (*kernel)(const Params) =
      w == kDqMma ? flash_dq_mma_kernel<D> : flash_dkv_mma_kernel<D>;
  const size_t bytes = w == kDqMma ? C::dq_bytes : C::dkv_bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const int rows = w == kDqMma ? p.Sq : p.Sk;
  const dim3 grid(p.B * p.H, (rows + C::BR - 1) / C::BR);
  kernel<<<grid, C::kThreadsM, bytes, stream>>>(p);
  return cudaGetLastError();
}

// the mma kernels' limits: D 64 or 128, q/k/v (and dout for the backward)
// and their (b, s, h) strides on 16-byte boundaries (cp.async)
cudaError_t dispatch_mma(int D, Which w, const Params& p, cudaStream_t s) {
  const int n = w == kFwdMma ? 3 : 4;
  const void* ptrs[4] = {p.q, p.k, p.v, p.dout};
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<std::uintptr_t>(ptrs[i]) % 16)
      return cudaErrorInvalidValue;
  for (int i = 0; i < 3 * n; ++i)
    if (p.st[i] % 8) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return w == kFwdMma ? launch_mma<64>(p, s) : launch_bwd_mma<64>(w, p, s);
    case 128:
      return w == kFwdMma ? launch_mma<128>(p, s)
                          : launch_bwd_mma<128>(w, p, s);
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
  if (w == kFwdMma || w == kDqMma || w == kDkvMma)
    e = bf16 ? dispatch_mma(D, w, p, s) : cudaErrorInvalidValue;
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

// dq and dk/dv on the tensor cores: bfloat16 only (bf16 must be 1), D 64
// or 128; q, k, v, dout and their (b, s, h) strides on 16-byte boundaries.
// Anything else returns cudaErrorInvalidValue without a launch.
int flash_attention_dq_mma(const void* q, const void* k, const void* v,
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
  return run(kDqMma, p, strides, D, bf16, stream);
}

int flash_attention_dkv_mma(const void* q, const void* k, const void* v,
                            const void* dout, const long long* strides,
                            const void* lse, const void* delta, void* dk,
                            void* dv, const void* lens, const void* seed,
                            int B, int H, int Sq, int Sk, int D, int bf16,
                            float scale, int causal, int dropout,
                            unsigned thresh, float drop_scale, int drop_bq,
                            int drop_bk, void* stream) {
  Params p = make(q, k, v, dout, lens, seed, B, H, Sq, Sk, scale, causal,
                  dropout, thresh, drop_scale, drop_bq, drop_bk);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return run(kDkvMma, p, strides, D, bf16, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
