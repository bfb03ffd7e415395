// Fused LM-head cross entropy for Hopper (sm_90a): forward (lse, target
// logit), dh and dw, with plain C entry points loaded through ctypes
// (paddle_tpu_torch/ops/fused_ce.py).
//
// Replaces paddle_tpu/ops/pallas/fused_ce.py: _ce_fwd_kernel (forward),
// _ce_bwd_dh_kernel (dh) and _ce_bwd_dw_kernel (dw).
//
// What each computes, with hid (N, H) contiguous, w (H, V) read through its
// element strides (sh, sv) (the tied head is the (V, H) embedding's .T view,
// sh = 1), labels (N,) int32, inputs float32 or bfloat16, logits float32:
//   forward  logits = hid @ w over vocab tiles; online logsumexp
//            (m, s, alpha rescaling); lse = m + log(s, with s == 0 read as
//            1); tgt = the label's logit, 0 for a label outside [0, V)
//            (ignore_index included). lse, tgt: (N,) float32.
//   dh       dl = (exp(logits - lse) - onehot(label)) * scale;
//            dh = dl @ w^T, (N, H) in hid's dtype.
//   dw       dw = hid^T @ dl, written as its transpose, a contiguous (V, H)
//            buffer in w's dtype (the wrapper hands back the (H, V) view).
// scale = g * valid / max(#valid, 1) comes from the caller, as the
// reference's host epilogue computes it; ignored and padded rows have
// scale 0 and give exact zeros. Columns >= V are masked as the reference's
// finite NEG_INF columns are: they enter no max, no sum and no pick.
//
// Design. The TPU kernels keep a (block_tokens, H) or (H, block_vocab)
// float32 sum in VMEM (768 KB and 6 MB at GPT-base with the DB's 256/2048
// blocks); a Hopper block has 227 KB. So the sums shrink along the other
// axis: a dh block owns a few tokens against all of H and loops over every
// vocab tile; a dw block owns a few vocab rows against all of H and loops
// over every token tile. Each (token, vocab) logit is recomputed once per
// kernel, as in the reference. Each sum is owned by one thread and summed
// in one fixed order: no atomics, bit-reproducible runs. hid and w are
// bfloat16 on the tensor-core paths, so every product hid*w is exact and
// the logits are the reference's up to summation order. The float32 dl of
// the gradient products is stored as two bfloat16 terms (hi = bf16(dl),
// lo = bf16(dl - hi), two MMAs, about 16 bits of dl). Bound on this card:
// the operations, 2*N*H*V for the forward and 4*N*H*V for each gradient
// kernel (logits recomputed, then the product), at the bf16 tensor-core
// rate. All products are mma.sync.m16n8k16 bf16 with float32 sums (or
// float32 FMAs on float32 inputs, no TF32 anywhere); no wgmma, no TMA.
//
// The backward has two routes, chosen by the wrapper from (dtype, H):
//
// tiled (bfloat16, H = 768 or 1024; ce_bwd_tiled_kernel): one template
//   serves dh and dw, which are mirror images. A block owns TR = 32 rows
//   (dh: tokens of hid, with their lse, scale and label; dw: vocab rows of
//   w) and streams TR-row tiles of the other operand (dh: vocab rows of w,
//   read through its h-contiguous strides; dw: token rows of hid, each
//   with its stats). The own rows sit in shared memory for the whole
//   kernel; each streamed tile is read from global memory once, by 16-byte
//   cp.async into a two-tile ring (the next tile loads while this one
//   computes), and feeds both products: the logits (own x tile^T, the tile
//   as mma's [n][k] operand through ldmatrix) and the gradient product
//   (dl x tile, the tile as the [k][n] operand through ldmatrix.trans).
//   The logits of a 32 x 32 tile are split over the warps along H and
//   summed in a fixed order through a small shared buffer. The (32 x H)
//   float32 sums stay in registers in mma's accumulator layout (each warp
//   all 32 rows x H/8 columns: 96 registers a thread at H = 768, 128 at
//   1024) and reach global memory once, through shared memory as 16-byte
//   rows. Against the streamed operand that is 2 * 32 FLOP per byte of
//   each kind of product, where the staged route re-read its tiles.
// staged (float32 inputs, other H up to the shared-memory limit;
//   ce_dh_kernel, ce_dw_kernel): the first design. The dh block owns 32
//   tokens (16 above H = 1024), the dw block 32 vocab rows (16 above
//   H = 1024); their float32 sums live in shared memory, round-tripping
//   through registers for each 64-wide H chunk. Every operand tile is
//   staged in shared memory in the inputs' dtype (zero past the edges) with
//   one stage of register prefetch, and each block re-reads its own rows
//   for every streamed tile and the streamed tile a second time for the
//   gradient product: a few tens of operations per byte.
//
// The forward has two routes too, chosen by the wrapper from (dtype, H):
//
// tiled (bfloat16, any H that is a multiple of 64; ce_fwd_tiled_kernel and
//   ce_fwd_merge_kernel): a plain mma.sync GEMM with the online logsumexp
//   on its accumulators. The grid is token tiles (128 tokens, 16 a warp)
//   x vocab splits, token tile fastest, so co-resident blocks share one
//   split's slice of w in L2. A block loops over its split's 128-column
//   vocab tiles; each tile's logits are summed over 64-wide H chunks of hid
//   and w that arrive through a three-stage ring of 16-byte cp.async (one
//   barrier a chunk) and are read by ldmatrix (w through its h-contiguous
//   rows as mma's [n][k] operand, as the flash forward reads K). Each warp
//   owns 16 full rows of a tile, so the row max and sum reduce within a
//   quad of lanes, and the running (m, s, t) of each row stays in
//   registers for the whole split; nothing is kept across all of H, so no
//   H is special. Each block writes its rows' (m, s, t) to a (3, splits, N)
//   float32 workspace; the merge kernel combines the splits in increasing
//   order (no atomics: repeat launches give the same bits). The splits
//   fill the card (ops/fused_ce.py: fwd_splits) where one block per token
//   tile would leave it half empty. Bound: the operations, 2*N*H*V at the
//   bf16 tensor-core rate.
// staged (float32, other H; ce_fwd_kernel): the first design, one block
//   per 64 tokens looping over all of V, its tiles staged as the staged
//   backward's are and its logits rescanned through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr int HC = 64;        // H chunk of a gradient product
constexpr int FWD_BT = 64;    // forward: tokens per block
constexpr int FWD_BV = 128;   // forward: vocab tile
constexpr int DH_BV = 128;    // dh: vocab tile (tokens per block 32 or 16)
constexpr int DW_BT = 64;     // dw: token tile (vocab rows per block 32 or 16)
constexpr size_t kSmemLimit = 232448;

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}
// H chunk of a logits product: 64 bf16 or 32 float32 (128 bytes a row)
template <typename T>
__host__ __device__ constexpr int kc() {
  return is_bf16<T>() ? 64 : 32;
}
// row stride of a staged tile of width w: 8 more elements, so that the
// rows of a fragment fall in different banks
__host__ __device__ constexpr int ld_of(int w) { return w + 8; }
__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}
__host__ __device__ constexpr int padded_h(int H) {
  return (H + HC - 1) / HC * HC + 8;  // stride of the float32 sums
}

struct Params {
  const void* hid;     // (N, H) contiguous
  const void* w;       // (H, V), element strides sh, sv
  long long sh, sv;
  const int* lbl;      // (N,)
  float* lse;          // (N,): written by the forward, read by the backward
  float* tgt;          // (N,): forward
  const float* scale;  // (N,): backward
  void* out;           // dh (N, H) or dw^T (V, H)
  float* work;         // tiled forward: (3, splits, N) partial m, s, t
  int N, H, V;
  int splits;          // tiled forward: vocab splits
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using P = float2;
  __device__ static P make(float a, float b) { return make_float2(a, b); }
  __device__ static float zero() { return 0.f; }
};
template <>
struct PairOf<__nv_bfloat16> {
  using P = __nv_bfloat162;
  __device__ static P make(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __halves2bfloat162(a, b);
  }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
};

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
// two bf16 as one register, the lower k index in the low half
__device__ __forceinline__ unsigned pack16(__nv_bfloat16 lo,
                                           __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// One k step of 16 of a warp's product: acc[j] (16 rows, columns
// 8j..8j+7) += A (16 x 16) B (16 x 8). A is row-major [m][k] at a (stride
// lda); B is [n][k] (kNK) or [k][n] at b (stride ldb). The accumulator
// layout is mma.sync's: lane (g, t) = (lane / 4, lane % 4) holds rows g and
// g + 8, columns 2t and 2t + 1. bf16: tensor-core MMAs, fragments read as
// bf16 pairs; kSplit adds a second A (a2, the lo half of a split float32
// operand) against the same B. float32: FMAs into the same layout.
template <typename T, int NT, bool kNK, bool kSplit>
__device__ __forceinline__ void kstep(float (&acc)[NT][4], const T* a,
                                      const T* a2, int lda, const T* b,
                                      int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (is_bf16<T>()) {
    unsigned hi[4], lo[4];
    hi[0] = ld32(a + g * lda + 2 * t);
    hi[1] = ld32(a + (g + 8) * lda + 2 * t);
    hi[2] = ld32(a + g * lda + 2 * t + 8);
    hi[3] = ld32(a + (g + 8) * lda + 2 * t + 8);
    if constexpr (kSplit) {
      lo[0] = ld32(a2 + g * lda + 2 * t);
      lo[1] = ld32(a2 + (g + 8) * lda + 2 * t);
      lo[2] = ld32(a2 + g * lda + 2 * t + 8);
      lo[3] = ld32(a2 + (g + 8) * lda + 2 * t + 8);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned b0, b1;
      if constexpr (kNK) {
        const T* bj = b + (8 * j + g) * ldb + 2 * t;
        b0 = ld32(bj);
        b1 = ld32(bj + 8);
      } else {
        const T* bj = b + 2 * t * ldb + 8 * j + g;
        b0 = pack16(bj[0], bj[ldb]);
        b1 = pack16(bj[8 * ldb], bj[9 * ldb]);
      }
      mma_bf16(acc[j], hi, b0, b1);
      if constexpr (kSplit) mma_bf16(acc[j], lo, b0, b1);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float a0 = a[g * lda + k], a1 = a[(g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + 2 * t;
        const float b0 = kNK ? b[n * ldb + k] : b[k * ldb + n];
        const float b1 = kNK ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
        acc[j][0] = fmaf(a0, b0, acc[j][0]);
        acc[j][1] = fmaf(a0, b1, acc[j][1]);
        acc[j][2] = fmaf(a1, b0, acc[j][2]);
        acc[j][3] = fmaf(a1, b1, acc[j][3]);
      }
    }
  }
}

// One operand tile, staged in two halves so that its global loads overlap
// the previous tile's products: fetch() loads src[(i0 + i) * si +
// (j0 + j) * sj] for i < I, j < J into registers, pairs along j (zero where
// i0 + i >= ni or j0 + j >= nj); put() stores them to dst[i * ld + j]. Where
// sj is the unit stride a pair is one load, and a warp walks j first;
// otherwise it walks i first (si the unit stride) and loads each element.
template <typename T, int I, int J>
struct Stage {
  using PO = PairOf<T>;
  using P = typename PO::P;
  static constexpr int JP = J / 2;
  static_assert(J % 2 == 0 && (I * JP) % kThreads == 0, "stage shape");
  static constexpr int PER = I * JP / kThreads;
  P v[PER];
  bool i_fast;

  __device__ __forceinline__ void fetch(const T* src, long long si,
                                        long long sj, int i0, int ni, int j0,
                                        int nj) {
    i_fast = sj != 1;
    const T z = PO::zero();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int i = i_fast ? e % I : e / JP;
      const int j = 2 * (i_fast ? e / I : e % JP);
      const int gi = i0 + i, gj = j0 + j;
      if (gi < ni) {
        const T* q = src + gi * si + gj * sj;
        if (!i_fast && gj + 1 < nj &&
            reinterpret_cast<uintptr_t>(q) % sizeof(P) == 0)
          v[u] = *reinterpret_cast<const P*>(q);
        else
          v[u] = PO::make(gj < nj ? q[0] : z, gj + 1 < nj ? q[sj] : z);
      } else {
        v[u] = PO::make(z, z);
      }
    }
  }

  __device__ __forceinline__ void put(T* dst, int ld) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int i = i_fast ? e % I : e / JP;
      const int j = 2 * (i_fast ? e / I : e % JP);
      *reinterpret_cast<P*>(dst + i * ld + j) = v[u];
    }
  }
};

// warp tiling of a (BT x BV) tile: BT/16 warp rows
template <int BT, int BV>
struct Tile {
  static constexpr int MW = BT / 16;
  static constexpr int NW = kWarps / MW;
  static constexpr int NT = BV / NW / 8;   // n tiles of 8 per warp
  static_assert(MW * NW == kWarps && NT * NW * 8 == BV, "tile shape");
};

// The staged operands of one logits tile: hid rows x an H chunk, and w
// columns x the same chunk (read through w's strides), both [row][k].
template <typename T, int BT, int BV>
struct LogitsStage {
  Stage<T, BT, kc<T>()> hid;
  Stage<T, BV, kc<T>()> w;

  __device__ __forceinline__ void fetch(const Params& p, int t0, int v0,
                                        int k0) {
    hid.fetch(static_cast<const T*>(p.hid), p.H, 1, t0, p.N, k0, p.H);
    w.fetch(static_cast<const T*>(p.w), p.sv, p.sh, v0, p.V, k0, p.H);
  }
};

// logits of tokens [t0, t0 + BT) x vocab [v0, v0 + BV) into the warp's
// accumulators (Tile's layout). st holds this tile's first H chunk,
// fetched; on return it holds the first chunk of the tile at (nt0, nv0)
// when has_next.
template <typename T, int BT, int BV>
__device__ __forceinline__ void logits_tile(float (&acc)[Tile<BT, BV>::NT][4],
                                            LogitsStage<T, BT, BV>& st,
                                            T* hid_s, T* w_s, const Params& p,
                                            int t0, int v0, bool has_next,
                                            int nt0, int nv0) {
  using L = Tile<BT, BV>;
  constexpr int KC = kc<T>(), KS = ld_of(KC);
  const int wi = threadIdx.x >> 5;
  const int r0 = (wi / L::NW) * 16, c0 = (wi % L::NW) * L::NT * 8;
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < p.H; k0 += KC) {
    __syncthreads();  // the previous chunk's readers are done
    st.hid.put(hid_s, KS);
    st.w.put(w_s, KS);
    __syncthreads();
    if (k0 + KC < p.H)
      st.fetch(p, t0, v0, k0 + KC);  // in flight while this chunk computes
    else if (has_next)
      st.fetch(p, nt0, nv0, 0);
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16)
      kstep<T, L::NT, true, false>(acc, hid_s + r0 * KS + ks, nullptr, KS,
                                   w_s + c0 * KS + ks, KS);
  }
}

// d loss / d logit of one logit x at (row, vocab column v)
__device__ __forceinline__ float dlogit(float x, int v, int V, float lse,
                                        int lbl, float scale) {
  if (v >= V) return 0.f;  // a masked column: p = 0, never the label
  const float pr = x > kNegInf * 0.5f ? expf(x - lse) : 0.f;
  return (pr - (v == lbl ? 1.f : 0.f)) * scale;
}

// dl as the gradient product's A operand: bf16 hi and lo halves, or
// float32 as it is (lo unused)
template <typename T>
__device__ __forceinline__ void put_dl(T* hi, T* lo, int i, float x) {
  if constexpr (is_bf16<T>()) {
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
  } else {
    hi[i] = x;
  }
}

// per-row inputs of the backward for tokens [t0, t0 + rows): zero scale
// (and no label) past N
__device__ __forceinline__ void load_stats(float* lse_s, float* sc_s,
                                           int* lbl_s, const Params& p, int t0,
                                           int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const bool in = t0 + r < p.N;
    lse_s[r] = in ? p.lse[t0 + r] : 0.f;
    sc_s[r] = in ? p.scale[t0 + r] : 0.f;
    lbl_s[r] = in ? p.lbl[t0 + r] : -1;
  }
}

// the (rows x HC) chunk [h0, h0 + HC) of float32 sums at acc_s (stride HP)
// in and out of a warp's mma layout
template <int NT>
__device__ __forceinline__ void sums_in(float (&c)[NT][4], const float* acc_s,
                                        int HP, int r2, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(
        &acc_s[(r2 + g) * HP + col]);
    const float2 hi = *reinterpret_cast<const float2*>(
        &acc_s[(r2 + g + 8) * HP + col]);
    c[j][0] = lo.x;
    c[j][1] = lo.y;
    c[j][2] = hi.x;
    c[j][3] = hi.y;
  }
}
template <int NT>
__device__ __forceinline__ void sums_out(const float (&c)[NT][4],
                                         float* acc_s, int HP, int r2,
                                         int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(&acc_s[(r2 + g) * HP + col]) =
        make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(&acc_s[(r2 + g + 8) * HP + col]) =
        make_float2(c[j][2], c[j][3]);
  }
}

// ---------------------------------------------------------------------------
// shared-memory layouts (bytes), one per kernel
// ---------------------------------------------------------------------------
template <typename T>
struct FwdSmem {
  static constexpr int KS = ld_of(kc<T>()), SS = FWD_BV + 8;
  __host__ __device__ static constexpr size_t hid() {
    return align16(sizeof(T) * FWD_BT * KS);
  }
  __host__ __device__ static constexpr size_t w() {
    return align16(sizeof(T) * FWD_BV * KS);
  }
  __host__ __device__ static constexpr size_t bytes() {
    return hid() + w() + sizeof(float) * FWD_BT * SS;
  }
};

// dh and dw share one shape: a logits tile of BT tokens x BV vocab, a dl
// tile (two bf16 halves or one float32 array) as the gradient product's A,
// a staged B chunk, the float32 sums of R rows against all of H, and the
// per-token statistics
template <typename T, int BT, int BV, int DL_ROWS, int DL_COLS, int B_ROWS,
          int R, int STATS>
struct BwdSmem {
  static constexpr int KS = ld_of(kc<T>()), DS = ld_of(DL_COLS),
                       BS = ld_of(HC);
  static constexpr int ND = is_bf16<T>() ? 2 : 1;
  __host__ __device__ static constexpr size_t hid() {
    return align16(sizeof(T) * BT * KS);
  }
  __host__ __device__ static constexpr size_t w() {
    return align16(sizeof(T) * BV * KS);
  }
  __host__ __device__ static constexpr size_t dl() {
    return align16(sizeof(T) * DL_ROWS * DS);
  }
  __host__ __device__ static constexpr size_t bop() {
    return align16(sizeof(T) * B_ROWS * BS);
  }
  __host__ __device__ static constexpr size_t sums(int H) {
    return align16(sizeof(float) * R * static_cast<size_t>(padded_h(H)));
  }
  __host__ __device__ static constexpr size_t bytes(int H) {
    return hid() + w() + ND * dl() + bop() + sums(H) + 3 * 4 * STATS;
  }
};
// dh: BT tokens; dl [BT][DH_BV]; w chunk [DH_BV v][HC h]; sums [BT][H]
template <typename T, int BT>
using DhSmem = BwdSmem<T, BT, DH_BV, BT, DH_BV, DH_BV, BT, BT>;
// dw: BV vocab rows; dl^T [BV][DW_BT]; hid chunk [DW_BT t][HC h];
// sums [BV][H]
template <typename T, int BV>
using DwSmem = BwdSmem<T, DW_BT, BV, BV, DW_BT, DW_BT, BV, DW_BT>;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(const Params p) {
  constexpr int BT = FWD_BT, BV = FWD_BV;
  using L = Tile<BT, BV>;
  using S = FwdSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* hid_s = reinterpret_cast<T*>(smem);
  T* w_s = reinterpret_cast<T*>(smem + S::hid());
  float* s_s = reinterpret_cast<float*>(smem + S::hid() + S::w());

  const int t0 = blockIdx.x * BT;
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (wi / L::NW) * 16, c0 = (wi % L::NW) * L::NT * 8;
  // TPR consecutive threads (lanes of one warp) own a row's running
  // statistics
  constexpr int TPR = kThreads / BT;
  static_assert(TPR <= 32 && (TPR & (TPR - 1)) == 0, "threads per row");
  const int row = threadIdx.x / TPR, q = threadIdx.x % TPR;
  const int grow = t0 + row;
  const int lbl = grow < p.N ? p.lbl[grow] : -1;
  float m = kNegInf, s = 0.f, tg = 0.f;

  LogitsStage<T, BT, BV> st;
  st.fetch(p, t0, 0, 0);
  for (int v0 = 0; v0 < p.V; v0 += BV) {
    float acc[L::NT][4];
    // its first barrier also orders the last tile's readers of s_s
    logits_tile<T, BT, BV>(acc, st, hid_s, w_s, p, t0, v0, v0 + BV < p.V,
                           t0, v0 + BV);
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_s[(r0 + g + 8 * (e >> 1)) * S::SS + c0 + 8 * j + 2 * t + (e & 1)] =
            acc[j][e];
    __syncthreads();

    float mx = kNegInf;
    for (int c = q; c < BV; c += TPR)
      if (v0 + c < p.V) mx = fmaxf(mx, s_s[row * S::SS + c]);
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(m, mx);
    float ps = 0.f, th = 0.f;
    for (int c = q; c < BV; c += TPR) {
      const int v = v0 + c;
      if (v < p.V) {
        const float x = s_s[row * S::SS + c];
        if (x > kNegInf * 0.5f) ps += expf(x - m_new);
        if (v == lbl) th += x;
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) {
      ps += __shfl_xor_sync(kFull, ps, o);
      th += __shfl_xor_sync(kFull, th, o);
    }
    s = expf(m - m_new) * s + ps;  // NEG_INF start -> alpha 0
    m = m_new;
    tg += th;
  }
  if (q == 0 && grow < p.N) {
    p.lse[grow] = m + logf(s == 0.f ? 1.f : s);
    p.tgt[grow] = tg;
  }
}

// ---------------------------------------------------------------------------
// dh: one block per BT tokens against all of H, looping over vocab tiles
// ---------------------------------------------------------------------------
template <typename T, int BT>
__global__ void __launch_bounds__(kThreads) ce_dh_kernel(const Params p) {
  constexpr int BV = DH_BV;
  using L = Tile<BT, BV>;
  using L2 = Tile<BT, HC>;   // the (BT x HC) chunks of dh
  using S = DhSmem<T, BT>;
  constexpr bool kSplit = is_bf16<T>();
  const int HP = padded_h(p.H);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* at = smem;
  T* hid_s = reinterpret_cast<T*>(at);
  T* w_s = reinterpret_cast<T*>(at += S::hid());
  T* dhi_s = reinterpret_cast<T*>(at += S::w());      // [BT][DS]
  T* dlo_s = reinterpret_cast<T*>(at += (S::ND - 1) * S::dl());
  T* wv_s = reinterpret_cast<T*>(at += S::dl());      // [BV v][BS]: w chunk
  float* acc_s = reinterpret_cast<float*>(at += S::bop());  // [BT][HP]
  float* lse_s = reinterpret_cast<float*>(at += S::sums(p.H));
  float* sc_s = lse_s + BT;
  int* lbl_s = reinterpret_cast<int*>(sc_s + BT);

  const int t0 = blockIdx.x * BT;
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (wi / L::NW) * 16, c0 = (wi % L::NW) * L::NT * 8;
  const int r2 = (wi / L2::NW) * 16, c2 = (wi % L2::NW) * L2::NT * 8;
  const T* w = static_cast<const T*>(p.w);
  for (int e = threadIdx.x; e < BT * HP; e += kThreads) acc_s[e] = 0.f;
  load_stats(lse_s, sc_s, lbl_s, p, t0, BT);

  LogitsStage<T, BT, BV> st;
  Stage<T, BV, HC> sw;   // w[h0.., v0..] as [v][h], the dh product's B
  st.fetch(p, t0, 0, 0);
  for (int v0 = 0; v0 < p.V; v0 += BV) {
    float acc[L::NT][4];
    sw.fetch(w, p.sv, p.sh, v0, p.V, 0, p.H);
    logits_tile<T, BT, BV>(acc, st, hid_s, w_s, p, t0, v0, v0 + BV < p.V,
                           t0, v0 + BV);
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
        put_dl(dhi_s, dlo_s, r * S::DS + c,
               dlogit(acc[j][e], v0 + c, p.V, lse_s[r], lbl_s[r], sc_s[r]));
      }
    for (int h0 = 0; h0 < p.H; h0 += HC) {
      __syncthreads();  // dl written; the last chunk's readers of wv_s done
      sw.put(wv_s, S::BS);
      __syncthreads();
      if (h0 + HC < p.H) sw.fetch(w, p.sv, p.sh, v0, p.V, h0 + HC, p.H);
      float c[L2::NT][4];
      sums_in(c, acc_s, HP, r2, h0 + c2);
#pragma unroll
      for (int ks = 0; ks < BV; ks += 16)
        kstep<T, L2::NT, false, kSplit>(
            c, dhi_s + r2 * S::DS + ks, dlo_s + r2 * S::DS + ks, S::DS,
            wv_s + ks * S::BS + c2, S::BS);
      sums_out(c, acc_s, HP, r2, h0 + c2);
    }
  }
  __syncthreads();
  T* dh = static_cast<T*>(p.out);
  for (int e = threadIdx.x; e < BT * p.H; e += kThreads) {
    const int r = e / p.H, h = e % p.H;
    if (t0 + r < p.N)
      store(dh + static_cast<long long>(t0 + r) * p.H + h, acc_s[r * HP + h]);
  }
}

// ---------------------------------------------------------------------------
// dw: one block per BV vocab rows against all of H, looping over tokens
// ---------------------------------------------------------------------------
template <typename T, int BV>
__global__ void __launch_bounds__(kThreads) ce_dw_kernel(const Params p) {
  constexpr int BT = DW_BT;
  using L = Tile<BT, BV>;
  using L2 = Tile<BV, HC>;   // the (BV x HC) chunks of dw^T
  using S = DwSmem<T, BV>;
  constexpr bool kSplit = is_bf16<T>();
  const int HP = padded_h(p.H);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* at = smem;
  T* hid_s = reinterpret_cast<T*>(at);
  T* w_s = reinterpret_cast<T*>(at += S::hid());
  T* dhi_s = reinterpret_cast<T*>(at += S::w());      // [BV][DS]: dl^T
  T* dlo_s = reinterpret_cast<T*>(at += (S::ND - 1) * S::dl());
  T* ht_s = reinterpret_cast<T*>(at += S::dl());      // [BT t][BS]: hid chunk
  float* acc_s = reinterpret_cast<float*>(at += S::bop());  // [BV][HP]
  float* lse_s = reinterpret_cast<float*>(at += S::sums(p.H));
  float* sc_s = lse_s + BT;
  int* lbl_s = reinterpret_cast<int*>(sc_s + BT);

  const int v0 = blockIdx.x * BV;
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (wi / L::NW) * 16, c0 = (wi % L::NW) * L::NT * 8;
  const int r2 = (wi / L2::NW) * 16, c2 = (wi % L2::NW) * L2::NT * 8;
  const T* hid = static_cast<const T*>(p.hid);
  for (int e = threadIdx.x; e < BV * HP; e += kThreads) acc_s[e] = 0.f;

  LogitsStage<T, BT, BV> st;
  Stage<T, BT, HC> sh;   // hid[t0.., h0..] as [t][h], the dw product's B
  st.fetch(p, 0, v0, 0);
  for (int t0 = 0; t0 < p.N; t0 += BT) {
    __syncthreads();  // the last block's readers of the stats and dl done
    load_stats(lse_s, sc_s, lbl_s, p, t0, BT);
    float acc[L::NT][4];
    sh.fetch(hid, p.H, 1, t0, p.N, 0, p.H);
    logits_tile<T, BT, BV>(acc, st, hid_s, w_s, p, t0, v0, t0 + BT < p.N,
                           t0 + BT, v0);
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
        put_dl(dhi_s, dlo_s, c * S::DS + r,
               dlogit(acc[j][e], v0 + c, p.V, lse_s[r], lbl_s[r], sc_s[r]));
      }
    for (int h0 = 0; h0 < p.H; h0 += HC) {
      __syncthreads();  // dl written; the last chunk's readers of ht_s done
      sh.put(ht_s, S::BS);
      __syncthreads();
      if (h0 + HC < p.H) sh.fetch(hid, p.H, 1, t0, p.N, h0 + HC, p.H);
      float c[L2::NT][4];
      sums_in(c, acc_s, HP, r2, h0 + c2);
#pragma unroll
      for (int ks = 0; ks < BT; ks += 16)
        kstep<T, L2::NT, false, kSplit>(
            c, dhi_s + r2 * S::DS + ks, dlo_s + r2 * S::DS + ks, S::DS,
            ht_s + ks * S::BS + c2, S::BS);
      sums_out(c, acc_s, HP, r2, h0 + c2);
    }
  }
  __syncthreads();
  T* dwt = static_cast<T*>(p.out);
  for (int e = threadIdx.x; e < BV * p.H; e += kThreads) {
    const int r = e / p.H, h = e % p.H;
    if (v0 + r < p.V)
      store(dwt + static_cast<long long>(v0 + r) * p.H + h, acc_s[r * HP + h]);
  }
}

// ---------------------------------------------------------------------------
// tiled backward (bfloat16): own rows resident, each streamed tile read once
// ---------------------------------------------------------------------------
constexpr int TR = 32;   // own rows per block, streamed rows per tile

template <int H>
struct TiledSmem {
  static constexpr int LD = H + 8;     // row pitch (bf16): 16 bytes past a
                                       // multiple of 128, conflict-free
  static constexpr int DLD = TR + 8;   // dl row pitch
  static constexpr size_t rows = sizeof(bf16) * TR * LD;   // one 32 x H tile
  static constexpr size_t red = sizeof(float) * kWarps * 16 * 32;
  static constexpr size_t dl = sizeof(bf16) * TR * DLD;
  static constexpr size_t stats = sizeof(float) * 3 * TR;
  // own rows, a ring of two streamed tiles, the logits' partial sums, dl
  // (hi, lo), two sets of (lse, scale, label)
  static constexpr size_t bytes = 3 * rows + red + 2 * dl + 2 * stats;
  static_assert(bytes <= kSmemLimit, "tiled smem");
};

// rows [r0, r0 + TR) of src (row stride ld, h contiguous) into dst (pitch
// H + 8) by cp.async; rows >= n are zeros
template <int H>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int r0, int n) {
  constexpr int CPR = H / 8, PER = TR * CPR / kThreads;
  static_assert(TR * CPR % kThreads == 0, "row chunks");
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * (H + 8) + col,
               in ? src + static_cast<long long>(r0 + r) * ld + col : src,
               in ? 16 : 0);
  }
}

// (lse, scale, label) of tokens [t0, t0 + TR) into st[0..3*TR) by cp.async;
// zeros past N (scale 0: no gradient)
__device__ __forceinline__ void load_stats_async(float* st, const Params& p,
                                                 int t0) {
  const int k = threadIdx.x / TR, r = threadIdx.x % TR;
  if (k < 3) {
    const bool in = t0 + r < p.N;
    const void* src = k == 0   ? static_cast<const void*>(p.lse + t0 + r)
                      : k == 1 ? static_cast<const void*>(p.scale + t0 + r)
                               : static_cast<const void*>(p.lbl + t0 + r);
    cp_async4(st + k * TR + r, in ? src : p.lse, in ? 4 : 0);
  }
}

// dh (kDw false): own rows = tokens of hid, streamed = vocab rows of w.
// dw (kDw true): own rows = vocab rows of w, streamed = tokens of hid.
// w is read as the (V, H) rows of its h-contiguous layout (sh == 1, row
// stride sv). out: (own rows, H) contiguous: dh, or dw^T.
template <int H, bool kDw>
__global__ void __launch_bounds__(kThreads, 1)
    ce_bwd_tiled_kernel(const Params p) {
  using S = TiledSmem<H>;
  constexpr int LD = S::LD, DLD = S::DLD;
  constexpr int KQ = H / 4;          // logits: a warp's quarter of H
  constexpr int HW = H / kWarps;     // product: a warp's columns of H
  constexpr int NT = HW / 8;
  static_assert(KQ % 16 == 0 && HW % 16 == 0, "H");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* own_s = reinterpret_cast<bf16*>(smem);
  bf16* ring = own_s + TR * LD;
  float* red_s = reinterpret_cast<float*>(smem + 3 * S::rows);
  bf16* dhi_s = reinterpret_cast<bf16*>(smem + 3 * S::rows + S::red);
  bf16* dlo_s = dhi_s + TR * DLD;
  float* st_s = reinterpret_cast<float*>(smem + 3 * S::rows + S::red +
                                         2 * S::dl);

  const bf16* hid = static_cast<const bf16*>(p.hid);
  const bf16* w = static_cast<const bf16*>(p.w);
  const int n_own = kDw ? p.V : p.N, n_str = kDw ? p.N : p.V;
  const bf16* own = kDw ? w : hid;
  const bf16* str = kDw ? hid : w;
  const long long ld_own = kDw ? p.sv : H, ld_str = kDw ? H : p.sv;
  const int o0 = blockIdx.x * TR;
  const int tid = threadIdx.x, wi = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lj = lane >> 3, l8 = lane & 7;

  load_rows<H>(own_s, own, ld_own, o0, n_own);
  load_rows<H>(ring, str, ld_str, 0, n_str);
  if (kDw) {
    load_stats_async(st_s, p, 0);
  } else if (tid < TR) {   // the own tokens' stats, read once
    const bool in = o0 + tid < p.N;
    st_s[tid] = in ? p.lse[o0 + tid] : 0.f;
    st_s[TR + tid] = in ? p.scale[o0 + tid] : 0.f;
    reinterpret_cast<int*>(st_s)[2 * TR + tid] = in ? p.lbl[o0 + tid] : -1;
  }
  cp_commit();

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int ntiles = (n_str + TR - 1) / TR;
  for (int i = 0; i < ntiles; ++i) {
    const int s0 = i * TR;
    const bf16* cur = ring + (i & 1) * TR * LD;
    const float* cst = st_s + (kDw ? (i & 1) * 3 * TR : 0);
    cp_wait_all();
    // tile i has landed; every reader of tile i - 1's slots is done
    __syncthreads();
    if (i + 1 < ntiles) {
      load_rows<H>(ring + ((i + 1) & 1) * TR * LD, str, ld_str, s0 + TR,
                   n_str);
      if (kDw) load_stats_async(st_s + ((i + 1) & 1) * 3 * TR, p, s0 + TR);
      cp_commit();
    }

    // logits of (32 own rows x 32 streamed rows): warp (mi, ki) takes own
    // rows 16 mi.. against all 32 streamed rows over H quarter ki
    {
      const int mi = wi & 1, ki = wi >> 1;
      float c[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
      const bf16* pa = own_s + (16 * mi + (lj & 1) * 8 + l8) * LD + ki * KQ +
                       (lj >> 1) * 8;
      const bf16* pb = cur + ((lj >> 1) * 8 + l8) * LD + ki * KQ +
                       (lj & 1) * 8;
#pragma unroll 4
      for (int k = 0; k < KQ; k += 16) {
        unsigned a[4], b0[4], b1[4];
        ldsm_x4(a, pa + k);
        ldsm_x4(b0, pb + k);             // streamed rows 0..15
        ldsm_x4(b1, pb + 16 * LD + k);   // streamed rows 16..31
        mma_bf16(c[0], a, b0[0], b0[1]);
        mma_bf16(c[1], a, b0[2], b0[3]);
        mma_bf16(c[2], a, b1[0], b1[1]);
        mma_bf16(c[3], a, b1[2], b1[3]);
      }
      float* rw = red_s + wi * 16 * 32 + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rw[(j * 4 + e) * 32] = c[j][e];
    }
    __syncthreads();

    // the four quarters summed in order, then dl as bf16 hi and lo
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + q * kThreads;
      const int mi = idx >> 9, e = (idx >> 5) & 15, ln = idx & 31;
      float x = 0.f;
#pragma unroll
      for (int ki = 0; ki < 4; ++ki)
        x += red_s[((ki * 2 + mi) * 16 + e) * 32 + ln];
      const int row = 16 * mi + (ln >> 2) + 8 * ((e & 3) >> 1);
      const int col = 8 * (e >> 2) + 2 * (ln & 3) + (e & 1);
      const int sr = kDw ? col : row;   // the token's stats
      const float d = dlogit(x, kDw ? o0 + row : s0 + col, p.V, cst[sr],
                             reinterpret_cast<const int*>(cst)[2 * TR + sr],
                             cst[TR + sr]);
      put_dl(dhi_s, dlo_s, row * DLD + col, d);
    }
    __syncthreads();

    // out[own rows][h] += dl (32 x 32) . tile (32 x H): warp wi takes all
    // 32 rows x columns [wi HW, (wi + 1) HW), the tile as [k][n] through
    // ldmatrix.trans
    {
      const bf16* pa = dhi_s + ((lj & 1) * 8 + l8) * DLD + (lj >> 1) * 8;
      const bf16* pb = cur + ((lj & 1) * 8 + l8) * LD + wi * HW +
                       (lj >> 1) * 8;
#pragma unroll
      for (int k = 0; k < TR; k += 16) {
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          ldsm_x4(ah[m], pa + m * 16 * DLD + k);
          ldsm_x4(al[m], pa + TR * DLD + m * 16 * DLD + k);
        }
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          unsigned b[4];
          ldsm_x4_t(b, pb + k * LD + n * 8);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][n], ah[m], b[0], b[1]);
            mma_bf16(acc[m][n], al[m], b[0], b[1]);
            mma_bf16(acc[m][n + 1], ah[m], b[2], b[3]);
            mma_bf16(acc[m][n + 1], al[m], b[2], b[3]);
          }
        }
      }
    }
  }

  // the sums, rounded to bf16, through the own rows' slot as 16-byte rows
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int r = 16 * m + g, col = wi * HW + 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(own_s + r * LD + col) =
          __floats2bfloat162_rn(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<__nv_bfloat162*>(own_s + (r + 8) * LD + col) =
          __floats2bfloat162_rn(acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.out);
  constexpr int CPR = H / 8;
  for (int c = tid; c < TR * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    if (o0 + r < n_own)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(o0 + r) * H +
                                col) =
          *reinterpret_cast<const uint4*>(own_s + r * LD + col);
  }
}

// ---------------------------------------------------------------------------
// tiled forward (bfloat16, H a multiple of 64): token tiles x vocab splits
// ---------------------------------------------------------------------------
constexpr int FT_BT = 16 * kWarps;   // tokens a block, 16 a warp
constexpr int FT_BV = 128;           // vocab columns a tile
constexpr int FT_KC = 64;            // H chunk a ring stage holds
constexpr int FT_LD = FT_KC + 8;     // row pitch (bf16): 144 bytes, so the
                                     // 8 rows of an ldmatrix hit 8 banks
constexpr int FT_STAGES = 3;
constexpr int FT_NT = FT_BV / 8;     // n8 tiles of a warp's 16 x 128 logits
constexpr float kLog2e = 1.4426950408889634f;

struct FwdTiledSmem {
  static constexpr int hid = FT_BT * FT_LD;          // elements a stage
  static constexpr int stage = hid + FT_BV * FT_LD;  // + the w chunk
  static constexpr size_t bytes = sizeof(bf16) * FT_STAGES * stage;
};

// rows [r0, r0 + ROWS) x columns [h0, h0 + FT_KC) of src (row stride ld,
// h contiguous) into dst (pitch FT_LD) by 16-byte cp.async; rows >= n are
// zero-filled without a read
template <int ROWS>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           long long ld, int r0, int n,
                                           int h0) {
  constexpr int CPR = FT_KC / 8;
  static_assert(ROWS * CPR % kThreads == 0, "chunk pieces");
#pragma unroll
  for (int u = 0; u < ROWS * CPR / kThreads; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * FT_LD + col,
               in ? src + static_cast<long long>(r0 + r) * ld + h0 + col : src,
               in ? 16 : 0);
  }
}

// Block (token tile x, split y): tokens [128 x, 128 x + 128) against the
// split's vocab tiles [y T / S, (y + 1) T / S) of the T = ceil(V / 128),
// writing each row's (m, s, t) over those columns to work[k][y][row].
__global__ void __launch_bounds__(kThreads, 2)
    ce_fwd_tiled_kernel(const Params p) {
  using S = FwdTiledSmem;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const bf16* hid = static_cast<const bf16*>(p.hid);
  const bf16* w = static_cast<const bf16*>(p.w);
  const int t0 = blockIdx.x * FT_BT, split = blockIdx.y;
  const long long nvt = (p.V + FT_BV - 1) / FT_BV;
  const int v_begin = static_cast<int>(split * nvt / p.splits) * FT_BV;
  const int v_end = static_cast<int>((split + 1) * nvt / p.splits) * FT_BV;
  const int nc = p.H / FT_KC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, lj = lane >> 3, l8 = lane & 7;
  const int rw = 16 * warp;   // the warp's first row in the block

  // rows g and g + 8 of the warp: label (-1 outside [0, V): never picked),
  // running max, this lane's part of the sum and of the target logit
  int lbl[2];
  float m[2] = {kNegInf, kNegInf}, s[2] = {0.f, 0.f}, tg[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + rw + g + 8 * r;
    const int l = row < p.N ? p.lbl[row] : -1;
    lbl[r] = l >= 0 && l < p.V ? l : -1;
  }

  // the ring: stage i holds the i-th (vocab tile, H chunk) of the split,
  // H chunks innermost; (lv0, lh0) is the next one to load
  int lv0 = v_begin, lh0 = 0;
  const auto load_next = [&](int slot) {
    if (lv0 < v_end) {
      bf16* st = ring + slot * S::stage;
      load_chunk<FT_BT>(st, hid, p.H, t0, p.N, lh0);
      load_chunk<FT_BV>(st + S::hid, w, p.sv, lv0, p.V, lh0);
      lh0 += FT_KC;
      if (lh0 == p.H) {
        lh0 = 0;
        lv0 += FT_BV;
      }
    }
    cp_commit();   // an empty group past the end keeps the count in step
  };
#pragma unroll
  for (int i = 0; i < FT_STAGES - 1; ++i) load_next(i);

  int slot = 0;
  for (int v0 = v_begin; v0 < v_end; v0 += FT_BV) {
    float acc[FT_NT][4];
#pragma unroll
    for (int n = 0; n < FT_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int c = 0; c < nc; ++c) {
      cp_wait<FT_STAGES - 2>();
      // this chunk has landed; every reader of the slot refilled next is done
      __syncthreads();
      load_next(slot == 0 ? FT_STAGES - 1 : slot - 1);
      const bf16* hs = ring + slot * S::stage;
      slot = slot + 1 == FT_STAGES ? 0 : slot + 1;
      // logits += hid chunk (the warp's 16 rows) . w chunk^T (128 columns)
      const bf16* pa = hs + (rw + (lj & 1) * 8 + l8) * FT_LD + (lj >> 1) * 8;
      const bf16* pb = hs + S::hid + ((lj >> 1) * 8 + l8) * FT_LD +
                       (lj & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < FT_KC / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, pa + 16 * kk);
#pragma unroll
        for (int n = 0; n < FT_NT; n += 2) {
          unsigned b[4];
          ldsm_x4(b, pb + n * 8 * FT_LD + 16 * kk);
          mma_bf16(acc[n], a, b[0], b[1]);
          mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
      }
    }

    // online logsumexp on the accumulators: element e of n8 tile n is row
    // rw + g + 8 (e >> 1), vocab column v0 + 8n + 2t + (e & 1)
    const bool edge = v0 + FT_BV > p.V;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < FT_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + 8 * n + 2 * t + (e & 1);
        float x = acc[n][e];
        if (col == lbl[e >> 1]) tg[e >> 1] += x;
        if (edge && col >= p.V) x = kNegInf;   // the reference's mask
        acc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float ml[2];   // the new max, prescaled for exp2f
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      s[r] *= exp2f((m[r] - m_new) * kLog2e);   // NEG_INF start -> 0
      m[r] = m_new;
      ml[r] = m_new * kLog2e;
    }
#pragma unroll
    for (int n = 0; n < FT_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = acc[n][e];
        float pe = exp2f(fmaf(x, kLog2e, -ml[e >> 1]));
        if (edge && x <= kNegInf * 0.5f) pe = 0.f;
        s[e >> 1] += pe;
      }
  }

  // the four lanes of each row, summed in a fixed order; lane t = 0 writes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s[r] += __shfl_xor_sync(kFull, s[r], 1);
    s[r] += __shfl_xor_sync(kFull, s[r], 2);
    tg[r] += __shfl_xor_sync(kFull, tg[r], 1);
    tg[r] += __shfl_xor_sync(kFull, tg[r], 2);
  }
  const long long plane = static_cast<long long>(p.splits) * p.N;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + rw + g + 8 * r;
      if (row < p.N) {
        float* out = p.work + static_cast<long long>(split) * p.N + row;
        out[0] = m[r];
        out[plane] = s[r];
        out[2 * plane] = tg[r];
      }
    }
  }
}

// one thread a token: the splits' (m, s, t) merged in increasing split
// order; lse = m + log(s, with s == 0 read as 1), tgt = sum of t
__global__ void __launch_bounds__(kThreads)
    ce_fwd_merge_kernel(const Params p) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= p.N) return;
  const long long plane = static_cast<long long>(p.splits) * p.N;
  float m = kNegInf, s = 0.f, tg = 0.f;
  for (int i = 0; i < p.splits; ++i) {
    const float* in = p.work + static_cast<long long>(i) * p.N + row;
    const float mi = in[0];
    const float m_new = fmaxf(m, mi);
    s = s * exp2f((m - m_new) * kLog2e) +
        in[plane] * exp2f((mi - m_new) * kLog2e);
    m = m_new;
    tg += in[2 * plane];
  }
  p.lse[row] = m + logf(s == 0.f ? 1.f : s);
  p.tgt[row] = tg;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
cudaError_t launch(void (*kernel)(const Params), dim3 grid, size_t smem,
                   const Params& p, cudaStream_t stream) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the tiled forward: bfloat16, H a multiple of 64, w h-contiguous (sh ==
// 1) with 16-byte aligned rows, hid 16-byte aligned, 1 <= splits <= the
// vocab tiles; anything else is refused. The main kernel, then the merge.
cudaError_t dispatch_fwd_tiled(const Params& p, cudaStream_t s) {
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  const int nvt = (p.V + FT_BV - 1) / FT_BV;
  if (p.H % FT_KC != 0 || p.sh != 1 || p.sv % 8 != 0 || misaligned(p.w) ||
      misaligned(p.hid) || p.splits < 1 || p.splits > nvt ||
      p.splits > 65535)
    return cudaErrorInvalidValue;
  // the largest shared-memory carveout, so that two blocks fit an SM
  cudaError_t e = cudaFuncSetAttribute(
      ce_fwd_tiled_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  e = launch(ce_fwd_tiled_kernel,
             dim3((p.N + FT_BT - 1) / FT_BT, p.splits), FwdTiledSmem::bytes,
             p, s);
  if (e != cudaSuccess) return e;
  return launch(ce_fwd_merge_kernel, (p.N + kThreads - 1) / kThreads, 0, p,
                s);
}

enum Which { kFwd = 0, kDh = 1, kDw = 2 };

template <typename T>
cudaError_t dispatch(Which w, const Params& p, cudaStream_t s) {
  if (w == kFwd)
    return launch(ce_fwd_kernel<T>, (p.N + FWD_BT - 1) / FWD_BT,
                  FwdSmem<T>::bytes(), p, s);
  if (w == kDh) {
    if (DhSmem<T, 32>::bytes(p.H) <= kSmemLimit)
      return launch(ce_dh_kernel<T, 32>, (p.N + 31) / 32,
                    DhSmem<T, 32>::bytes(p.H), p, s);
    return launch(ce_dh_kernel<T, 16>, (p.N + 15) / 16,
                  DhSmem<T, 16>::bytes(p.H), p, s);
  }
  if (DwSmem<T, 32>::bytes(p.H) <= kSmemLimit)
    return launch(ce_dw_kernel<T, 32>, (p.V + 31) / 32,
                  DwSmem<T, 32>::bytes(p.H), p, s);
  return launch(ce_dw_kernel<T, 16>, (p.V + 15) / 16,
                DwSmem<T, 16>::bytes(p.H), p, s);
}

// the tiled route: bfloat16, H = 768 or 1024, w h-contiguous (sh == 1)
// with 16-byte aligned rows, hid and out 16-byte aligned; anything else is
// refused (the wrapper routes by dtype and H and checks the rest)
template <bool kDw>
cudaError_t dispatch_tiled(const Params& p, cudaStream_t s) {
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (p.sh != 1 || p.sv % 8 != 0 || misaligned(p.w) || misaligned(p.hid) ||
      misaligned(p.out))
    return cudaErrorInvalidValue;
  const int blocks = ((kDw ? p.V : p.N) + TR - 1) / TR;
  if (p.H == 768)
    return launch(ce_bwd_tiled_kernel<768, kDw>, blocks,
                  TiledSmem<768>::bytes, p, s);
  if (p.H == 1024)
    return launch(ce_bwd_tiled_kernel<1024, kDw>, blocks,
                  TiledSmem<1024>::bytes, p, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int max_hidden() {
  int h = HC;
  while (DhSmem<T, 16>::bytes(h + HC) <= kSmemLimit &&
         DwSmem<T, 16>::bytes(h + HC) <= kSmemLimit)
    h += HC;
  return h;
}

int run(Which w, Params& p, int bf16, void* stream) {
  if (p.N <= 0 || p.H <= 0 || p.V <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(w, p, s) : dispatch<float>(w, p, s);
  return static_cast<int>(e);
}

Params make(const void* hid, const void* w, long long sh, long long sv,
            const void* lbl, int N, int H, int V) {
  Params p = {};
  p.hid = hid;
  p.w = w;
  p.sh = sh;
  p.sv = sv;
  p.lbl = static_cast<const int*>(lbl);
  p.N = N;
  p.H = H;
  p.V = V;
  return p;
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch.
// hid (N, H) contiguous; w (H, V) with element strides sh (along H) and sv
// (along V); labels (N,) int32; bf16: 0 for float32 inputs, 1 for bfloat16
// (hid and w of one dtype).
int fused_ce_fwd(const void* hid, const void* w, long long sh, long long sv,
                 const void* lbl, void* lse, void* tgt, int N, int H, int V,
                 int bf16, void* stream) {
  Params p = make(hid, w, sh, sv, lbl, N, H, V);
  p.lse = static_cast<float*>(lse);
  p.tgt = static_cast<float*>(tgt);
  return run(kFwd, p, bf16, stream);
}

// The tiled forward (bfloat16 only; bf16 must be 1): lse and tgt as
// fused_ce_fwd gives them, for H a multiple of 64, w h-contiguous (sh ==
// 1), over `splits` vocab splits (1 <= splits <= ceil(V / 128)); work: a
// float32 scratch of 3 * splits * N.
int fused_ce_fwd_tiled(const void* hid, const void* w, long long sh,
                       long long sv, const void* lbl, void* lse, void* tgt,
                       void* work, int N, int H, int V, int bf16, int splits,
                       void* stream) {
  if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || H <= 0 || V <= 0) return 0;
  Params p = make(hid, w, sh, sv, lbl, N, H, V);
  p.lse = static_cast<float*>(lse);
  p.tgt = static_cast<float*>(tgt);
  p.work = static_cast<float*>(work);
  p.splits = splits;
  return static_cast<int>(
      dispatch_fwd_tiled(p, static_cast<cudaStream_t>(stream)));
}

// The staged route: dh (N, H) in the inputs' dtype
int fused_ce_dh(const void* hid, const void* w, long long sh, long long sv,
                const void* lbl, const void* lse, const void* scale, void* dh,
                int N, int H, int V, int bf16, void* stream) {
  Params p = make(hid, w, sh, sv, lbl, N, H, V);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.scale = static_cast<const float*>(scale);
  p.out = dh;
  return run(kDh, p, bf16, stream);
}

// dw^T (V, H) contiguous in the inputs' dtype
int fused_ce_dw(const void* hid, const void* w, long long sh, long long sv,
                const void* lbl, const void* lse, const void* scale, void* dwt,
                int N, int H, int V, int bf16, void* stream) {
  Params p = make(hid, w, sh, sv, lbl, N, H, V);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.scale = static_cast<const float*>(scale);
  p.out = dwt;
  return run(kDw, p, bf16, stream);
}

// The tiled route (bfloat16 only; bf16 must be 1): dh (N, H) and dw^T (V, H)
// as fused_ce_dh and fused_ce_dw give them, for H = 768 or 1024, with w
// h-contiguous (sh == 1).
int fused_ce_dh_tiled(const void* hid, const void* w, long long sh,
                      long long sv, const void* lbl, const void* lse,
                      const void* scale, void* dh, int N, int H, int V,
                      int bf16, void* stream) {
  if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || H <= 0 || V <= 0) return 0;
  Params p = make(hid, w, sh, sv, lbl, N, H, V);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.scale = static_cast<const float*>(scale);
  p.out = dh;
  return static_cast<int>(
      dispatch_tiled<false>(p, static_cast<cudaStream_t>(stream)));
}

int fused_ce_dw_tiled(const void* hid, const void* w, long long sh,
                      long long sv, const void* lbl, const void* lse,
                      const void* scale, void* dwt, int N, int H, int V,
                      int bf16, void* stream) {
  if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || H <= 0 || V <= 0) return 0;
  Params p = make(hid, w, sh, sv, lbl, N, H, V);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.scale = static_cast<const float*>(scale);
  p.out = dwt;
  return static_cast<int>(
      dispatch_tiled<true>(p, static_cast<cudaStream_t>(stream)));
}

// the staged route's largest H (a multiple of 64) whose float32 sums fit a
// block's shared memory, for bfloat16 (bf16 = 1) or float32 inputs
int fused_ce_max_hidden(int bf16) {
  return bf16 ? max_hidden<__nv_bfloat16>() : max_hidden<float>();
}

const char* fused_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
