// Paged decode / verify attention for Hopper (sm_90a), with a plain C entry
// point loaded through ctypes (paddle_tpu_torch/ops/paged_attention.py).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py: _paged_decode_kernel
// (Tq == 1) and _paged_verify_kernel (1 < Tq <= 32). The two TPU kernels
// share one body; here each kernel takes Tq as a parameter.
//
// What it computes, per (batch row b, head h): for each of the Tq query rows
// an online softmax over the row's cached context, read through the block
// table, returning the UNNORMALIZED running stats
//   acc (B, H, Tq, D), m (B, H, Tq), l (B, H, Tq), all float32,
// exactly what _run_paged_kernel returns once the TPU padding (q_pad rows,
// STAT_LANES columns) is sliced away. The caller folds the chunk tokens'
// own self-attention term in and divides (the epilogue stays in PyTorch).
//
// Semantics kept from the TPU kernel:
//   - every table slot is clamped into [0, P-1] and lens is capped at W*ps;
//   - pages at or past ceil(len/ps) are never read;
//   - masking uses the finite NEG_INF = -1e30 and zeroes p where
//     s <= NEG_INF/2, so a row with len == 0 gives l == 0 and acc == 0,
//     never NaN;
//   - pools may be float32 or bfloat16; all math is float32 (FFMA: at
//     Tq <= 32 over float32 pools the work is at most 16 FLOP a byte, below
//     the card's float32 balance, and TF32 would miss the 1e-4 parity bar).
//
// What bounds it: the bytes of K/V, 2 * len * H * D * elem a row, read once.
// The TPU walked each row's pages in order on one core; on the H100 that
// bound is reached only with megabytes of loads in flight across all SMs.
//
// Two routes.
//
// "split" (paged_split_kernel + paged_merge_kernel, flash-decoding): the
// context of each (b, h) is cut into S splits of whole pages, S from the
// host's shapes only (ops/paged_attention.paged_splits); the page count a
// split owns is ceil(ceil(len/ps) / S), read from lens on the card, so the
// splits of a row share its real length evenly and splits that start past
// it read nothing and write the empty partial (m = NEG_INF, l = 0, acc = 0).
// Grid B*H*S blocks of 4 warps. A block first reads its row's page ids,
// queries (float32, pre-scaled by sm_scale, kept in shared memory) and
// length together, then streams its keys, about 8 KB of K and V at a time,
// through a ring of kStages shared-memory stages filled by 16-byte cp.async
// (one key's head slice is D*elem contiguous bytes), issuing the next stages
// before it computes on the current one; keys past the split's end are
// zero-filled and never scored. D/8 lanes share one key, 8 dims each, so a
// warp scores 256/D keys at once; every lane keeps q and acc of all its
// rows for its 8 dims and reuses each staged K/V chunk across them. A
// reduce-scatter sums the rows' dot products (RW shuffles a key, not RW *
// log2(D/8)) and leaves each lane owning a row's score, max, sum and p,
// which the other lanes read by shuffle. At Tq == 1 (and 2) the block's
// warps split each stage's keys, each keeping its own (m, l, acc), merged
// at the end in warp order; at Tq > 2 warps own query rows and every staged
// tile serves all of them. With S > 1 the partials go to a float32
// workspace (B, H, S, Tq, D + 2) and paged_merge_kernel (launched early as
// a programmatic dependent launch, waiting on the split grid) combines them
// in the fixed order 0..S-1 (m = max m_s, l = sum alpha_s l_s, acc = sum
// alpha_s acc_s, alpha_s = exp(m_s - m)); with S == 1 the split kernel
// writes the outputs and no merge runs. No atomics: repeats are
// bit-identical.
//
// Where the time goes (tests/torch_paged_variants.py): at Tq == 1 the
// launches and the loop's own latency (a block syncs once a stage) take
// about as long as the bytes; deeper rings or larger stages only cost
// occupancy. At Tq == 32 the FFMA work per key and row is the limit.
//
// "simple" (paged_attention_kernel, the first design): grid (B, H), each
// block walks its row alone with scalar, synchronous loads. It stays for a
// pool or query that does not start on a 16-byte boundary (cp.async needs
// one) and as the same-run yardstick of the split route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int D>
struct Tile {
  static constexpr int kKeys = D >= 256 ? 16 : 32;  // keys staged per tile
  static constexpr int kStride = D + 1;             // padded smem row
};

template <typename T, int D>
__global__ void __launch_bounds__(1024) paged_attention_kernel(
    const float* __restrict__ q,       // (B, Tq, H, D) float32
    const T* __restrict__ k_pool,      // (P, ps, H, D)
    const T* __restrict__ v_pool,      // (P, ps, H, D)
    const int* __restrict__ tables,    // (B, W)
    const int* __restrict__ lens,      // (B,)
    float* __restrict__ acc_out,       // (B, H, Tq, D)
    float* __restrict__ m_out,         // (B, H, Tq)
    float* __restrict__ l_out,         // (B, H, Tq)
    int Tq, int H, int P, int ps, int W, float sm_scale) {
  constexpr int TK = Tile<D>::kKeys;
  constexpr int RS = Tile<D>::kStride;
  constexpr int DL = D / 32;  // acc elements per lane
  extern __shared__ float smem[];
  float* k_s = smem;            // TK * RS
  float* v_s = k_s + TK * RS;   // TK * RS
  float* q_s = v_s + TK * RS;   // Tq * D, pre-scaled by sm_scale

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long hd = static_cast<long>(H) * D;

  const int len = max(0, min(lens[b], W * ps));

  for (int i = tid; i < Tq * D; i += nthreads) {
    const int r = i / D, c = i % D;
    q_s[i] = q[(static_cast<long>(b) * Tq + r) * hd + static_cast<long>(h) * D
               + c] * sm_scale;
  }

  const bool active = warp < Tq;
  const float* qrow = q_s + warp * D;
  float m = kNegInf;
  float l = 0.f;
  float acc[DL];
#pragma unroll
  for (int j = 0; j < DL; ++j) acc[j] = 0.f;

  const int npages = (len + ps - 1) / ps;
  for (int pi = 0; pi < npages; ++pi) {
    const int page = min(max(tables[static_cast<long>(b) * W + pi], 0), P - 1);
    const long page_off = static_cast<long>(page) * ps * hd
                          + static_cast<long>(h) * D;
    for (int kc = 0; kc < ps; kc += TK) {
      const int base = pi * ps + kc;
      if (base >= len) break;  // uniform across the block
      const int nk = min(TK, ps - kc);
      __syncthreads();  // the previous tile (and q_s writes) are done
      for (int e = tid; e < nk * D; e += nthreads) {
        const int r = e / D, c = e % D;
        const long g = page_off + static_cast<long>(kc + r) * hd + c;
        k_s[r * RS + c] = to_f32(k_pool[g]);
        v_s[r * RS + c] = to_f32(v_pool[g]);
      }
      __syncthreads();
      if (active) {
        float s = kNegInf;
        if (lane < nk && base + lane < len) {
          const float* kr = k_s + lane * RS;
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], kr[d], dot);
          s = dot;
        }
        // lane 0 always holds a valid key (base < len), so m_new is finite
        const float m_new = fmaxf(m, warp_max(s));
        const float p = s > kNegInf * 0.5f ? expf(s - m_new) : 0.f;
        const float alpha = expf(m - m_new);  // NEG_INF start underflows to 0
        l = alpha * l + warp_sum(p);
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[j] *= alpha;
        for (int t = 0; t < nk; ++t) {
          const float pt = __shfl_sync(kFull, p, t);
          const float* vr = v_s + t * RS + lane;
#pragma unroll
          for (int j = 0; j < DL; ++j) acc[j] = fmaf(pt, vr[32 * j], acc[j]);
        }
        m = m_new;
      }
    }
  }

  if (active) {
    const long row = (static_cast<long>(b) * H + h) * Tq + warp;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc_out[row * D + lane + 32 * j] = acc[j];
    if (lane == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// the split route
// ---------------------------------------------------------------------------

constexpr int kStages = 3;   // cp.async ring depth
constexpr int kWarps = 4;    // warps a block

// The split route's shape constants for one (pool type, head dim).
template <typename T, int D>
struct Split {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks a key
  // lanes on one key: each holds 8 of its dims (one bf16 chunk, two
  // float32 chunks), so a warp scores 256 / D keys at once and the dot
  // product's shuffle reduction takes log2(D / 8) rounds
  static constexpr int kGroup = D / 8;
  static constexpr int kChunksPerLane = kChunks / kGroup;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int kDimsPerLane = kChunksPerLane * kElems;
  static constexpr int kKeysPerStep = 32 / kGroup;    // keys a warp scores
  // keys a stage: about 8 KB of K and V, 8 to 32 keys
  static constexpr int kRawTile = 8192 / (2 * kRowBytes);
  static constexpr int kTile = kRawTile < 8 ? 8 : (kRawTile > 32 ? 32
                                                                 : kRawTile);
  static constexpr int kSteps = kTile / kKeysPerStep;
  static constexpr int kStageElems = 2 * kTile * D;   // K tile, then V tile
  static constexpr int kLoads = 2 * kTile * kChunks / (32 * kWarps);
  static_assert(kDimsPerLane == 8 && kGroup <= 32, "8 dims a lane");
  static_assert(kSteps % kWarps == 0, "a stage must split over the warps");
  static_assert(2 * kTile * kChunks % (32 * kWarps) == 0,
                "a stage must split over the block's threads");
};

// ring, queries, the warps' partials (when warps share a row) and the
// row's page ids
template <typename T, int D>
constexpr size_t split_smem(int Tq, int W) {
  return (static_cast<size_t>(kStages) * Split<T, D>::kStageElems * sizeof(T))
         + static_cast<size_t>(Tq) * D * sizeof(float)
         + (Tq <= 2 ? static_cast<size_t>(kWarps) * (D + 2) * sizeof(float)
                    : 0)
         + static_cast<size_t>(W) * sizeof(int);
}

// one 16-byte chunk of a staged key row, upcast to float32
__device__ __forceinline__ void load_chunk(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// The reduce-scatter of RW rows' partial dot products over the G lanes of
// a key: each round keeps half of the rows a lane holds (the upper half
// where the lane's bit O is set) and adds its partner's copy of that half;
// once a lane holds one row, plain xor rounds finish the sum. Afterwards a
// lane owns Scatter::kRowsPerLane rows, the first Scatter::base(lane % G);
// row i is owned by lane Scatter::owner(i) of the group. RW shuffles a key
// instead of RW * log2(G), and each p is computed once, by its owner.
template <int O, int N, int RW>
__device__ __forceinline__ void reduce_scatter(float (&v)[RW], int gl) {
  if constexpr (O >= 1 && N > 1) {
    constexpr int H = N / 2;
    const bool up = (gl & O) != 0;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float send = up ? v[k] : v[k + H];
      const float keep = up ? v[k + H] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, O);
    }
    reduce_scatter<O / 2, H, RW>(v, gl);
  } else if constexpr (O >= 1) {
    v[0] += __shfl_xor_sync(kFull, v[0], O);
    reduce_scatter<O / 2, 1, RW>(v, gl);
  }
}

template <int RW, int G>
struct Scatter {
  static constexpr int kRowsPerLane = RW > G ? RW / G : 1;
  __host__ __device__ static constexpr int base(int gl) {
    int row = 0;
    for (int o = G / 2, n = RW; o >= 1 && n > 1; o >>= 1, n >>= 1)
      if (gl & o) row += n / 2;
    return row;
  }
  __host__ __device__ static constexpr int owner(int i) {
    int gl = 0;
    for (int o = G / 2, n = RW; o >= 1 && n > 1; o >>= 1, n >>= 1)
      if (i >= n / 2) {
        gl += o;
        i -= n / 2;
      }
    return gl;
  }
};

// RW: query rows a warp holds (1 for Tq <= 4, 2 for Tq <= 8, 4 for Tq <= 16,
// else 8)
template <typename T, int D, int RW>
__global__ void __launch_bounds__(32 * kWarps) paged_split_kernel(
    const float* __restrict__ q,       // (B, Tq, H, D) float32
    const T* __restrict__ k_pool,      // (P, ps, H, D)
    const T* __restrict__ v_pool,      // (P, ps, H, D)
    const int* __restrict__ tables,    // (B, W)
    const int* __restrict__ lens,      // (B,)
    float* __restrict__ acc_out,       // (B, H, Tq, D)
    float* __restrict__ m_out,         // (B, H, Tq)
    float* __restrict__ l_out,         // (B, H, Tq)
    float* __restrict__ ws,            // (B, H, S, Tq, D + 2); null if S == 1
    int Tq, int H, int P, int ps, int W, int S, float sm_scale) {
  using C = Split<T, D>;
  constexpr int G = C::kGroup;
  constexpr int CPL = C::kChunksPerLane;
  constexpr int EPC = C::kElems;
  constexpr int DPL = C::kDimsPerLane;
  constexpr int KPS = C::kKeysPerStep;
  constexpr int TK = C::kTile;
  constexpr int NSTEP = C::kSteps;
  extern __shared__ __align__(16) unsigned char split_smem_raw[];
  T* ring = reinterpret_cast<T*>(split_smem_raw);
  float* q_s = reinterpret_cast<float*>(ring + kStages * C::kStageElems);
  float* red = q_s + Tq * D;   // (kWarps, D + 2), when warps share a row
  int* page_s = reinterpret_cast<int*>(red + (Tq <= 2 ? kWarps * (D + 2)
                                                      : 0));

  // let the merge kernel's blocks launch now; they wait for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  const int bh = blockIdx.x / S;
  const int split = blockIdx.x - bh * S;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane / G;   // which of the warp's KPS keys
  const int gl = lane % G;    // chunk gl (and gl + G, ...) of that key
  const long hd = static_cast<long>(H) * D;

  // the row's page ids (clamped into the pool), the queries (pre-scaled)
  // and the row's length: three independent reads in flight together
  const int* trow = tables + static_cast<long>(b) * W;
  for (int i = tid; i < W; i += 32 * kWarps)
    page_s[i] = min(max(trow[i], 0), P - 1);
  for (int i = tid; i < Tq * D; i += 32 * kWarps) {
    const int r = i / D, c = i - (i / D) * D;
    q_s[i] = q[(static_cast<long>(b) * Tq + r) * hd + static_cast<long>(h) * D
               + c] * sm_scale;
  }
  // this split's keys [kb, ke): whole pages, the row's pages shared evenly
  const int len = max(0, min(lens[b], W * ps));
  const int npages = (len + ps - 1) / ps;
  const int pps = (npages + S - 1) / S;
  const int kb = min(split * pps * ps, len);
  const int ke = min((split + 1) * pps * ps, len);
  const int ntiles = (ke - kb + TK - 1) / TK;
  __syncthreads();

  // stage the next tile into ring slot `slot`; keys at or past ke are
  // zero-filled and read nothing. Tiles are staged in order, so each of
  // this thread's rows keeps its (page, slot) and steps it TK keys a tile,
  // with no division. Its chunks: kLoads / 2 of K, the same of V.
  constexpr int NR = C::kLoads / 2;
  static_assert(2 * NR == C::kLoads, "a thread loads K and V alike");
  int pos[NR], pg[NR], sl[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    pos[i] = kb + (tid + i * 32 * kWarps) / C::kChunks;
    pg[i] = pos[i] / ps;
    sl[i] = pos[i] - pg[i] * ps;
  }
  auto load_tile = [&](int slot) {
    T* dst = ring + slot * C::kStageElems;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int e = tid + i * 32 * kWarps;
      const int r = e / C::kChunks;
      const int c = e - r * C::kChunks;
      long off = 0;
      int bytes = 0;
      if (pos[i] < ke) {
        off = (static_cast<long>(page_s[pg[i]]) * ps + sl[i]) * hd
              + static_cast<long>(h) * D + c * EPC;
        bytes = 16;
      }
      cp_async16(dst + r * D + c * EPC, k_pool + off, bytes);
      cp_async16(dst + (TK + r) * D + c * EPC, v_pool + off, bytes);
      pos[i] += TK;
      for (sl[i] += TK; sl[i] >= ps; sl[i] -= ps) ++pg[i];
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_commit();
  }

  // warps sharing one query row split the keys of every stage
  const int ksn = Tq == 1 ? kWarps : (Tq == 2 ? kWarps / 2 : 1);
  const int rgn = kWarps / ksn;
  const int rg = warp / ksn;
  const int kslot = warp - rg * ksn;
  const int nrows = rg < Tq ? (Tq - rg + rgn - 1) / rgn : 0;  // <= RW

  // a warp computes all RW rows (rows past Tq repeat the last one and are
  // never written): no branch between rows, so their chains interleave.
  // Every lane holds q and acc of all RW rows for its 8 dims; after the
  // reduce-scatter a lane owns RPL rows' scores, running max and sum.
  constexpr int RPL = Scatter<RW, G>::kRowsPerLane;
  const int gbase = lane & ~(G - 1);           // the key group's first lane
  const int own = Scatter<RW, G>::base(gl);    // the first row this lane owns
  float qr[RW][DPL], acc[RW][DPL], m[RPL], l[RPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = min(rg + i * rgn, Tq - 1);
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        qr[i][c * EPC + e] = q_s[row * D + (c * G + gl) * EPC + e];
        acc[i][c * EPC + e] = 0.f;
      }
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    m[k] = kNegInf;
    l[k] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<kStages - 2>();   // tile t has landed (this thread's part)
    __syncthreads();          // ... everyone's; slot (t-1) % kStages is free
    if (t + kStages - 1 < ntiles) load_tile((t + kStages - 1) % kStages);
    cp_commit();
    const T* kt = ring + (t % kStages) * C::kStageElems;
    const T* vt = kt + TK * D;
    const int base = kb + t * TK;

    // scores of this warp's keys of the tile, for the rows this lane owns
    float s[RPL][NSTEP];
#pragma unroll
    for (int j = 0; j < NSTEP; ++j) {
      const int key = j * KPS + grp;
      if (j % ksn != kslot) {
#pragma unroll
        for (int k = 0; k < RPL; ++k) s[k][j] = kNegInf;
        continue;
      }
      float kf[DPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        load_chunk(kt + key * D + (c * G + gl) * EPC, kf + c * EPC);
      float dot[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        dot[i] = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) dot[i] = fmaf(qr[i][e], kf[e], dot[i]);
      }
      reduce_scatter<G / 2, RW, RW>(dot, gl);
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        s[k][j] = base + key < ke ? dot[k] : kNegInf;
    }
    // the running max of each owned row over the warp's keys; rescale what
    // came before, every row's factor from the lane that owns it
    float alpha[RPL], ml[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      float mx = s[k][0];
#pragma unroll
      for (int j = 1; j < NSTEP; ++j) mx = fmaxf(mx, s[k][j]);
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[k], mx);
      // exp(x) as exp2(x log2 e): one MUFU op; NEG_INF start -> 0
      alpha[k] = exp2f((m[k] - m_new) * kLog2e);
      m[k] = m_new;
      ml[k] = m_new * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float a = __shfl_sync(kFull, alpha[i % RPL],
                                  gbase + Scatter<RW, G>::owner(i));
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= a;
    }
#pragma unroll
    for (int k = 0; k < RPL; ++k) l[k] *= alpha[k];
    // P . V: each owned row's p, then every row's p from its owner
#pragma unroll
    for (int j = 0; j < NSTEP; ++j) {
      if (j % ksn != kslot) continue;
      const int key = j * KPS + grp;
      float vf[DPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        load_chunk(vt + key * D + (c * G + gl) * EPC, vf + c * EPC);
      float p[RPL];
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        p[k] = s[k][j] > kNegInf * 0.5f
                   ? exp2f(fmaf(s[k][j], kLog2e, -ml[k])) : 0.f;
        l[k] += p[k];
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float pi = __shfl_sync(kFull, p[i % RPL],
                                     gbase + Scatter<RW, G>::owner(i));
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pi, vf[e], acc[i][e]);
      }
    }
  }

  // the warp's key groups share m: sum their l and acc
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < RPL; ++k) l[k] += __shfl_xor_sync(kFull, l[k], o);
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        acc[i][e] += __shfl_xor_sync(kFull, acc[i][e], o);
  }

  // where row r of this block goes: the outputs, or split `split` of ws
  const long stride = ws ? D + 2 : D;
  float* acc_dst = ws ? ws + (static_cast<long>(bh) * S + split) * Tq * stride
                      : acc_out + static_cast<long>(bh) * Tq * D;
  if (ksn == 1) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (i >= nrows) break;
      const int row = rg + i * rgn;
      float* a = acc_dst + row * stride;
      if (grp == 0) {
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            a[(c * G + gl) * EPC + e] = acc[i][c * EPC + e];
      }
      if (lane == Scatter<RW, G>::owner(i)) {
        if (ws) {
          a[D] = m[i % RPL];
          a[D + 1] = l[i % RPL];
        } else {
          m_out[static_cast<long>(bh) * Tq + row] = m[i % RPL];
          l_out[static_cast<long>(bh) * Tq + row] = l[i % RPL];
        }
      }
    }
    return;
  }
  // warps that shared a row: merge their partials in warp order
  float* mine = red + warp * (D + 2);
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        mine[(c * G + gl) * EPC + e] = acc[0][c * EPC + e];
  }
  if (lane == 0) {
    mine[D] = m[0];
    mine[D + 1] = l[0];
  }
  __syncthreads();
  for (int e = tid; e < Tq * D; e += 32 * kWarps) {
    const int row = e / D, d = e - (e / D) * D;
    const float* part = red + row * ksn * (D + 2);
    float mx = kNegInf;
    for (int k = 0; k < ksn; ++k) mx = fmaxf(mx, part[k * (D + 2) + D]);
    float a = 0.f, lsum = 0.f;
    for (int k = 0; k < ksn; ++k) {
      const float w = expf(part[k * (D + 2) + D] - mx);
      a = fmaf(w, part[k * (D + 2) + d], a);
      lsum = fmaf(w, part[k * (D + 2) + D + 1], lsum);
    }
    acc_dst[row * stride + d] = a;
    if (d == 0) {
      if (ws) {
        acc_dst[row * stride + D] = mx;
        acc_dst[row * stride + D + 1] = lsum;
      } else {
        m_out[static_cast<long>(bh) * Tq + row] = mx;
        l_out[static_cast<long>(bh) * Tq + row] = lsum;
      }
    }
  }
}

// Combine the S partials of each (b, h, query row) in the order 0..S-1; one
// thread an output element.
__global__ void __launch_bounds__(256) paged_merge_kernel(
    const float* __restrict__ ws,      // (B, H, S, Tq, D + 2)
    float* __restrict__ acc_out,       // (B, H, Tq, D)
    float* __restrict__ m_out,         // (B, H, Tq)
    float* __restrict__ l_out,         // (B, H, Tq)
    long rows, int Tq, int D, int S) {
  // launched early (programmatic dependent launch): wait until the split
  // grid has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const long row = i / D;
  const int d = static_cast<int>(i - row * D);
  const long bh = row / Tq;
  const int r = static_cast<int>(row - bh * Tq);
  const long stride = static_cast<long>(Tq) * (D + 2);  // split to split
  const float* base = ws + bh * S * stride + static_cast<long>(r) * (D + 2);
  float mx = kNegInf;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, base[s * stride + D]);
  float a = 0.f, lsum = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* part = base + s * stride;
    const float w = expf(part[D] - mx);   // an empty split: 0 (or 1 x 0)
    a = fmaf(w, part[d], a);
    lsum = fmaf(w, part[D + 1], lsum);
  }
  acc_out[i] = a;
  if (d == 0) {
    m_out[row] = mx;
    l_out[row] = lsum;
  }
}

template <typename T, int D, int RW>
cudaError_t launch_split_rw(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lens, void* acc, void* m, void* l,
                            void* ws, int B, int Tq, int H, int P, int ps,
                            int W, int S, float sm_scale,
                            cudaStream_t stream) {
  const size_t smem = split_smem<T, D>(Tq, W);
  auto kernel = paged_split_kernel<T, D, RW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long grid = static_cast<long>(B) * H * S;
  kernel<<<static_cast<unsigned>(grid), 32 * kWarps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l),
      S > 1 ? static_cast<float*>(ws) : nullptr, Tq, H, P, ps, W, S,
      sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  const long rows = static_cast<long>(B) * H * Tq;
  const long blocks = (rows * D + 255) / 256;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_merge_kernel,
                         static_cast<const float*>(ws),
                         static_cast<float*>(acc), static_cast<float*>(m),
                         static_cast<float*>(l), rows, Tq, D, S);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* lens, void* acc, void* m, void* l,
                         void* ws, int B, int Tq, int H, int P, int ps, int W,
                         int S, float sm_scale, cudaStream_t stream) {
  if (Tq <= 4)
    return launch_split_rw<T, D, 1>(q, k_pool, v_pool, tables, lens, acc, m,
                                    l, ws, B, Tq, H, P, ps, W, S, sm_scale,
                                    stream);
  if (Tq <= 8)
    return launch_split_rw<T, D, 2>(q, k_pool, v_pool, tables, lens, acc, m,
                                    l, ws, B, Tq, H, P, ps, W, S, sm_scale,
                                    stream);
  if (Tq <= 16)
    return launch_split_rw<T, D, 4>(q, k_pool, v_pool, tables, lens, acc, m,
                                    l, ws, B, Tq, H, P, ps, W, S, sm_scale,
                                    stream);
  return launch_split_rw<T, D, 8>(q, k_pool, v_pool, tables, lens, acc, m, l,
                                  ws, B, Tq, H, P, ps, W, S, sm_scale,
                                  stream);
}


// ---------------------------------------------------------------------------
// the simple route's launch, and the dispatch over D for both routes
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_simple(const void* q, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* lens, void* acc, void* m, void* l,
                          void* /*ws*/, int B, int Tq, int H, int P, int ps,
                          int W, int /*S*/, float sm_scale,
                          cudaStream_t stream) {
  const size_t smem =
      (2 * Tile<D>::kKeys * Tile<D>::kStride + static_cast<size_t>(Tq) * D)
      * sizeof(float);
  auto kernel = paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, H);
  const dim3 block(32 * (Tq > 4 ? Tq : 4));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), Tq, H, P, ps, W,
      sm_scale);
  return cudaGetLastError();
}

template <typename T, bool kSplit>
cudaError_t dispatch_d(int D, const void* q, const void* k_pool,
                       const void* v_pool, const void* tables,
                       const void* lens, void* acc, void* m, void* l,
                       void* ws, int B, int Tq, int H, int P, int ps, int W,
                       int S, float sm_scale, cudaStream_t stream) {
#define PAGED_CASE(DD)                                                      \
  case DD:                                                                  \
    return (kSplit ? launch_split<T, DD> : launch_simple<T, DD>)(           \
        q, k_pool, v_pool, tables, lens, acc, m, l, ws, B, Tq, H, P, ps, W, \
        S, sm_scale, stream);
  switch (D) {
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    PAGED_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_CASE
}

template <bool kSplit>
int run(const void* q, const void* k_pool, const void* v_pool,
        const void* tables, const void* lens, void* acc, void* m, void* l,
        void* ws, int B, int Tq, int H, int D, int P, int ps, int W,
        int pool_bf16, int S, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Tq < 1 || Tq > 32 || ps < 1 || P < 1 || W < 1 || S < 1 ||
      (S > 1 && ws == nullptr) ||
      static_cast<long>(B) * H * S > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      pool_bf16
          ? dispatch_d<__nv_bfloat16, kSplit>(D, q, k_pool, v_pool, tables,
                                              lens, acc, m, l, ws, B, Tq, H,
                                              P, ps, W, S, sm_scale, s)
          : dispatch_d<float, kSplit>(D, q, k_pool, v_pool, tables, lens,
                                      acc, m, l, ws, B, Tq, H, P, ps, W, S,
                                      sm_scale, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch.
// pool_bf16: 0 for float32 pools, 1 for bfloat16 pools. q is float32.

// The simple route (paged_attention_kernel).
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const void* tables, const void* lens, void* acc,
                        void* m, void* l, int B, int Tq, int H, int D, int P,
                        int ps, int W, int pool_bf16, float sm_scale,
                        void* stream) {
  return run<false>(q, k_pool, v_pool, tables, lens, acc, m, l, nullptr, B,
                    Tq, H, D, P, ps, W, pool_bf16, 1, sm_scale, stream);
}

// The split route: paged_split_kernel over `splits` splits a row, then
// paged_merge_kernel when splits > 1. ws: float32 (B, H, splits, Tq, D + 2),
// 16-byte aligned pools and q; ws may be null when splits == 1.
int paged_attention_split_fwd(const void* q, const void* k_pool,
                              const void* v_pool, const void* tables,
                              const void* lens, void* acc, void* m, void* l,
                              void* ws, int B, int Tq, int H, int D, int P,
                              int ps, int W, int pool_bf16, int splits,
                              float sm_scale, void* stream) {
  return run<true>(q, k_pool, v_pool, tables, lens, acc, m, l, ws, B, Tq, H,
                   D, P, ps, W, pool_bf16, splits, sm_scale, stream);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
