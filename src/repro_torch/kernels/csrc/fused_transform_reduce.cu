// Fused transform-aggregate on Hopper, SpMM + GEMM in one launch:
//
//   Y[s, :] = cast_io( reduce_{i : seg[i] == s} wt[i] * H[gidx[i], :] ) @ W     reduce in {sum, mean}
//
// Replaces the TPU kernel src/repro/kernels/fused_transform_reduce.py:
// _fused_transform_reduce_impl (body _body).
//
// What bounds it on the H100: bytes. A row reads its gather index and weight
// and one row of H; an output row is d_out io elements. At the served widths
// (32 -> 64 fp32 at the ogbn-arxiv bucket) the output write is two thirds of
// the bytes, and the product, 2 * d_in * d_out flops a segment, is far below
// any ridge point once it runs on the tensor cores. What the fusion saves is
// the (S, d_in) aggregate's round trip through device memory and a launch.
//
// Design: segment tiles over the plan's row offsets. Block b owns the TILE
// (a template argument: the config's S_b, one of FOR_TILES, picked at run
// time by ftr_launch) consecutive segments [b * TILE, b * TILE + TILE) and their rows
// [row_ptr[lo], row_ptr[hi]) of the sorted index; it reads no chunk ranges
// and no `seg` word (the row offsets say where each segment starts).
//  * A tile with no rows (the padded nodes of a bucket) writes its zeros
//    (0 @ W) in 16-byte stores and leaves.
//  * Aggregate. The tile's rows are split evenly into one run per lane
//    group (LPR lanes spanning a row of H with 16-byte loads where the row
//    allows: 32 groups of 8 lanes at d_in = 32 fp32). A group loads its
//    run's gather indices and weights cooperatively, one coalesced word a
//    lane, hands them out with __shfl_sync, and keeps U = 4 rows of H in
//    flight (swept below).
//    It walks its run in order with an fp32 running value and finds segment
//    ends from the row offsets, which the block keeps in shared memory. A
//    segment that lies wholly inside the run goes straight into the
//    (TILE, d_in) aggregate in shared memory, cast to the io dtype once
//    (mean divided by row_ptr[s+1] - row_ptr[s] first); the one or two
//    segments the run's ends cut leave fp32 partials in the group's two
//    slots (slot 0: the segment of its first row, slot 1: that of its last).
//    After a __syncthreads() the block folds each cut segment's partials in
//    group order, and writes the empty segments as 0. Every aggregate row is
//    written once, with no atomics, in an order that does not depend on
//    scheduling: the result is bitwise the same from launch to launch. A
//    row wider than one group's vectors (d_in > 128 fp32) takes the walk
//    once for each column stretch.
//  * Product. W (d_in x d_out, 8 KB at 32 -> 64 fp32) is loaded into shared
//    memory once a block, transposed so that each B fragment is one 32-bit
//    word a register, and stays resident. The aggregate, already in the io
//    dtype, runs through mma.sync (mma.cuh): bf16 m16n8k16, fp32 as 3xTF32
//    (as segment_matmul.cu), fp32 accumulators. The 8 warps cover the tile
//    in passes of BN = 64 output columns, a warp a 16-row slab by TILE / 2
//    columns.
//  * The (TILE, BN) result of a pass goes through a shared-memory stage in
//    the io dtype and out in 16-byte row stores (the tile's output rows are
//    one contiguous stretch of Y).
// Semantics as the reference: the fp32 aggregate is cast to the io dtype
// before the product, the product accumulates in fp32 and is written in the
// io dtype; mean divides by max(count, 1); a segment with no rows gives 0;
// rows past row_ptr[num_segments] (seg == num_segments, padding) are never
// read. The weight stays in the io dtype and multiplies in fp32.
//
// Shared memory (Geometry, mirrored by
// repro_torch.kernels.fused_transform_reduce.smem_bytes, which fusable
// checks against the 232,448 B a block may use): W transposed, n_pad rows
// of kstride words; the aggregate, TILE rows of kstride words (kstride =
// 4 mod 32, so the fragment loads of a warp hit 32 banks); the slots, two
// fp32 partials of a 16-byte vector a lane, and over them, once the fold is
// done, the output stage, TILE rows of BN columns (stride 8 mod 32 words
// fp32, 4 mod 32 bf16); the TILE + 1 row offsets and a fold plan of 8
// bytes a segment. At 32 -> 64: 37,904 B fp32, 35,856 B bf16.
//
// U = 4 and the default tile TILE = 64 are the sweep's choice (python -m
// repro_torch.kernel_variants; H100 80GB HBM3, 700 W; the measured PerfDB
// of repro_torch.core.autotune picks the tile per shape class): weighted
// sum fp32 32 -> 64 at the ogbn-arxiv bucket took 0.1154 / 0.0995 / 0.1068 ms at TILE 32 / 64 / 128 and 0.1132 / 0.0994 /
// 0.1110 ms at U 2 / 4 / 8; 64 and 4 were the fastest, or within 0.1 %,
// also at bf16 32 -> 64, fp32 64 -> 64 and 64 -> 16 and the mean (a larger
// U holds more registers, so fewer blocks fit an SM; a larger tile leaves
// fewer blocks for the card). Every edge reads its row of H through L2:
// 150 MB a launch at 32 -> 64 fp32 (ogbn-arxiv), 2.97 GB at gcn's reddit2
// request. Read alone in the same order (the read probe of the same sweep)
// they take 0.0283 and 0.3823 ms, against the kernel's 0.0994 and 0.7644:
// the walk, fold and product, not L2, hold the kernel (PERF.md).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BN = 64;             // output columns of one product pass
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may use
constexpr int SLAB = 16;           // rows of one mma fragment

// The tiles built (the S_b axis of repro_torch.core.config_space,
// TILE_SIZES there, which must list the same values): X(T) is expanded
// once for each. kernels/_build.py compiles one library a value, from a
// wrapper that defines this list as that value alone.
#ifndef FOR_TILES
#define FOR_TILES(X) X(32) X(64) X(128)
#endif

// Shared-memory geometry, in 32-bit words, for host and device.
struct Geometry {
  int kstep, k_pad, kstride, n_pad, ostride, rp_words, w_words, a_words, s_words, o_words;
  __host__ __device__ Geometry(bool f32, int d_in, int d_out, int tile) {
    kstep = f32 ? 8 : 16;
    k_pad = (d_in + kstep - 1) / kstep * kstep;
    const int kw = f32 ? k_pad : k_pad / 2;  // words of one row along k
    kstride = kw + (36 - kw % 32) % 32;
    n_pad = (d_out + 7) / 8 * 8;
    ostride = f32 ? BN + 8 : BN / 2 + 4;
    rp_words = (2 * (tile + 1) + 2 * tile + 3) / 4 * 4;  // row offsets, fold plan
    w_words = n_pad * kstride;
    a_words = tile * kstride;
    s_words = 2 * THREADS * (f32 ? 4 : 8);  // fp32 partials of a 16-byte vector
    o_words = tile * ostride;
  }
  // the output stage reuses the slots, which are dead once the fold is done
  __host__ __device__ int bytes() const {
    return 4 * (rp_words + w_words + a_words + (s_words > o_words ? s_words : o_words));
  }
};

template <typename T, int V, int LPR, int TILE>
__global__ void __launch_bounds__(THREADS)
ftr_tiles(const T* __restrict__ h, const T* __restrict__ wm, const int* __restrict__ gidx,
          const T* __restrict__ wt, const int64_t* __restrict__ row_ptr, T* __restrict__ out,
          int d_in, int d_out, int num_segments, int weighted, int mean, int vec_out) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int EPW = 4 / sizeof(T);          // io elements a word
  constexpr int GPW = 32 / LPR;               // lane groups a warp
  constexpr int G = WARPS * GPW;              // lane groups (runs) a block
  constexpr int CW = LPR * V;                 // columns one walk covers
  constexpr int NB = LPR > 8 ? LPR : 8;       // rows per index round
  constexpr int IPL = NB / LPR;               // index words a lane loads per round
  constexpr int U = 4;                        // H rows in flight per group
  constexpr int SLABS = TILE / SLAB;
  static_assert(TILE % SLAB == 0 && (WARPS % SLABS == 0 || SLABS % WARPS == 0),
                "TILE must be 16, 32, 64 or 128");
  extern __shared__ __align__(16) uint32_t smem[];
  const Geometry geo(F32, d_in, d_out, TILE);
  int64_t* rp = reinterpret_cast<int64_t*>(smem);
  int2* fold = reinterpret_cast<int2*>(rp + TILE + 1);     // per segment: see below
  uint32_t* ws = smem + geo.rp_words;                        // W^T, n_pad x kstride
  uint32_t* ag = ws + geo.w_words;                           // aggregate, TILE x kstride
  float* slots = reinterpret_cast<float*>(ag + geo.a_words);  // (G, 2, CW) fp32
  uint32_t* os = ag + geo.a_words;                           // output stage, over the slots
  T* agt = reinterpret_cast<T*>(ag);
  const int kse = geo.kstride * EPW;                         // aggregate row, elements

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = blockIdx.x * TILE;
  const int nseg = min(TILE, num_segments - lo);
  const int64_t r0 = row_ptr[lo], r1 = row_ptr[lo + nseg];
  T* yb = out + (int64_t)lo * d_out;

  if (r0 == r1) {  // no rows: 0 @ W
    const int64_t n = (int64_t)nseg * d_out;
    if (vec_out) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const int64_t pieces = n * (int64_t)sizeof(T) / 16;
      for (int64_t i = tid; i < pieces; i += THREADS) reinterpret_cast<uint4*>(yb)[i] = z;
    } else {
      for (int64_t i = tid; i < n; i += THREADS) yb[i] = from_f<T>(0.f);
    }
    return;
  }

  for (int i = tid; i <= nseg; i += THREADS) rp[i] = row_ptr[lo + i];
  const int64_t chunk = (r1 - r0 + G - 1) / G;  // rows of one run
  // the fold plan of each segment, from its row offsets: x = -2 empty, -1
  // whole inside one run (its walk writes it), else the slot of its first
  // run (2 * ka + 0 or 1); y = the run of its last row
  for (int s = tid; s < nseg; s += THREADS) {
    const int64_t a = row_ptr[lo + s], e = row_ptr[lo + s + 1];
    int2 f = make_int2(-2, 0);
    if (a < e) {
      const int ka = (int)((a - r0) / chunk), kb = (int)((e - 1 - r0) / chunk);
      f = ka == kb ? make_int2(-1, kb) : make_int2(2 * ka + (a == r0 + ka * chunk ? 0 : 1), kb);
    }
    fold[s] = f;
  }
  // W transposed: word (n, k-word) holds W[k][n] (bf16: W[2w][n], W[2w+1][n]);
  // zero past d_in and d_out, so the padding meets zeros
  for (int i = tid; i < geo.n_pad * geo.k_pad; i += THREADS) {
    const int k = i / geo.n_pad, n = i % geo.n_pad;
    const T v = (k < d_in && n < d_out) ? wm[(int64_t)k * d_out + n] : from_f<T>(0.f);
    reinterpret_cast<T*>(ws + n * geo.kstride)[k] = v;
  }
  // the aggregate's columns [d_in, k_pad) stay 0 (they meet W's zero rows)
  if (geo.k_pad > d_in) {
    const int pad = geo.k_pad - d_in;
    for (int i = tid; i < TILE * pad; i += THREADS)
      agt[(i / pad) * kse + d_in + i % pad] = from_f<T>(0.f);
  }
  __syncthreads();

  // -- aggregate -------------------------------------------------------------
  const int grp = warp * GPW + lane / LPR, sub = lane % LPR;
  const unsigned gmask = LPR == 32 ? 0xffffffffu : (((1u << LPR) - 1u) << ((lane / LPR) * LPR));
  const int64_t g0 = min(r0 + grp * chunk, r1), g1 = min(g0 + chunk, r1);

  for (int c0 = 0; c0 < d_in; c0 += CW) {
    const int col = c0 + sub * V;
    const bool col_ok = col < d_in;
    if (g0 < g1) {
      // the segment of the run's first row: rp[cur] <= g0 < rp[cur + 1]
      int cur = 0, hi_s = nseg;
      while (hi_s - cur > 1) {
        const int mid = (cur + hi_s) >> 1;
        if (rp[mid] <= g0) cur = mid; else hi_s = mid;
      }
      int64_t nxt = rp[cur + 1];
      bool first = true;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.f;

      // write segment `cur` whole into the aggregate, or as a partial
      auto flush = [&]() {
        if (!col_ok) return;
        const int64_t a = rp[cur], e = rp[cur + 1];
        if (a >= g0 && e <= g1) {
          float v[V];
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = mean ? acc[j] / (float)(e - a) : acc[j];
          store_vec<T, V>(agt + cur * kse + col, v);
        } else {
          float* p = slots + (grp * 2 + (first ? 0 : 1)) * CW + sub * V;
#pragma unroll
          for (int j = 0; j < V; ++j) p[j] = acc[j];
        }
      };

      auto load_idx = [&](int64_t i0, int (&gl)[IPL], float (&wl)[IPL]) {
#pragma unroll
        for (int q = 0; q < IPL; ++q) {
          const int64_t r = i0 + q * LPR + sub;
          const bool ok = r < g1;
          gl[q] = ok ? gidx[r] : 0;
          wl[q] = (weighted && ok) ? to_f(wt[r]) : 1.f;
        }
      };

      int gl[IPL];
      float wl[IPL];
      load_idx(g0, gl, wl);
      for (int64_t i0 = g0; i0 < g1; i0 += NB) {
        int gn[IPL];
        float wn[IPL];
        load_idx(i0 + NB, gn, wn);  // next round's indices load meanwhile
#pragma unroll
        for (int u0 = 0; u0 < NB; u0 += U) {
          float wu[U];
          RawVec<T, V> raw[U];  // rows stay in the io dtype until they are used
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int t = u0 + u;
            const int64_t hrow = __shfl_sync(gmask, gl[t / LPR], t % LPR, LPR);
            wu[u] = __shfl_sync(gmask, wl[t / LPR], t % LPR, LPR);
            raw[u] = RawVec<T, V>{};
            if (i0 + t < g1 && col_ok)
              raw[u] = __ldg(reinterpret_cast<const RawVec<T, V>*>(h + hrow * d_in + col));
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t r = i0 + u0 + u;
            if (r >= g1) break;
            if (r >= nxt) {  // segment `cur` ends before row r
              flush();
              first = false;
              do {
                ++cur;
                nxt = rp[cur + 1];
              } while (r >= nxt);
#pragma unroll
              for (int j = 0; j < V; ++j) acc[j] = 0.f;
            }
            float v[V];
            unpack<T, V>(raw[u], v);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] += v[j] * wu[u];
          }
        }
#pragma unroll
        for (int q = 0; q < IPL; ++q) {
          gl[q] = gn[q];
          wl[q] = wn[q];
        }
      }
      flush();
    }
    __syncthreads();
    // fold the cut segments' partials in run order; empty segments are 0
    const int cols = min(CW, d_in - c0);
    for (int i = tid; i < nseg * CW; i += THREADS) {
      const int s = i / CW, c = i % CW;
      const int2 f = fold[s];
      if (f.x == -1 || c >= cols) continue;  // whole: written by its walk
      float acc = 0.f;
      if (f.x >= 0) {
        acc = slots[f.x * CW + c];
        for (int k = f.x / 2 + 1; k <= f.y; ++k) acc += slots[k * 2 * CW + c];
        if (mean) acc /= (float)(rp[s + 1] - rp[s]);
      }
      agt[s * kse + c0 + c] = from_f<T>(acc);
    }
    __syncthreads();  // the slots are refilled by the next column stretch
  }

  // -- product: passes of BN output columns ------------------------------------
  constexpr int WPS = WARPS / SLABS > 0 ? WARPS / SLABS : 1;  // warps a slab
  constexpr int NTW = (BN / 8) / WPS;                          // n8 tiles a warp
  const int gq = lane >> 2, tq = lane & 3;
  const int ksteps = geo.k_pad / geo.kstep;
  for (int n0 = 0; n0 < d_out; n0 += BN) {
    for (int sl = warp % SLABS; sl < SLABS; sl += WARPS) {
      const int nt0 = (warp / SLABS) * NTW;
      float acc[NTW][4];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      const uint32_t* alo = ag + (sl * SLAB + gq) * geo.kstride;
      const uint32_t* ahi = alo + 8 * geo.kstride;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int kw = kb * 8 + tq;
        uint32_t a[4] = {alo[kw], ahi[kw], alo[kw + 4], ahi[kw + 4]};
        if constexpr (F32) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            const int n = n0 + (nt0 + j) * 8;
            if (n >= geo.n_pad) break;
            const uint32_t* wrow = ws + (n + gq) * geo.kstride + kw;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(wrow[0], bh0, bl0);
            split_tf32(wrow[4], bh1, bl1);
            mma_tf32(acc[j], al, bh0, bh1);
            mma_tf32(acc[j], ah, bl0, bl1);
            mma_tf32(acc[j], ah, bh0, bh1);
          }
        } else {
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            const int n = n0 + (nt0 + j) * 8;
            if (n >= geo.n_pad) break;
            const uint32_t* wrow = ws + (n + gq) * geo.kstride + kw;
            mma_bf16(acc[j], a, wrow[0], wrow[4]);
          }
        }
      }
      // into the output stage, in the io dtype
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int c = (nt0 + j) * 8 + tq * 2;  // column within the pass
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = sl * SLAB + gq + hh * 8;
          if constexpr (F32)
            *reinterpret_cast<float2*>(os + r * geo.ostride + c) =
                make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(os + r * geo.ostride + c / 2) =
                __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
        }
      }
    }
    __syncthreads();
    // the stage's rows out: 16-byte pieces where rows allow, else elements
    const int cols = min(BN, d_out - n0);
    const T* ost = reinterpret_cast<const T*>(os);
    const int oes = geo.ostride * EPW;  // stage row, elements
    if (vec_out) {
      const int ppr = cols * (int)sizeof(T) / 16;  // pieces a row
      for (int i = tid; i < nseg * ppr; i += THREADS) {
        const int r = i / ppr, p = i % ppr;
        *reinterpret_cast<uint4*>(yb + (int64_t)r * d_out + n0 + p * (16 / sizeof(T))) =
            *reinterpret_cast<const uint4*>(ost + r * oes + p * (16 / sizeof(T)));
      }
    } else {
      for (int i = tid; i < nseg * cols; i += THREADS) {
        const int r = i / cols, c = i % cols;
        yb[(int64_t)r * d_out + n0 + c] = ost[r * oes + c];
      }
    }
    __syncthreads();  // the stage is refilled by the next pass
  }
}

struct Args {
  const void *h, *wm, *gidx, *wt, *row_ptr;
  void* out;
  int d_in, d_out, num_segments, weighted, mean, vec_out;
};

template <typename T, int V, int LPR, int TILE>
int launch(const Args& a, cudaStream_t st) {
  const Geometry geo(sizeof(T) == 4, a.d_in, a.d_out, TILE);
  const int smem = geo.bytes();
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = ftr_tiles<T, V, LPR, TILE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((a.num_segments + TILE - 1) / TILE);
  kernel<<<grid, THREADS, smem, st>>>((const T*)a.h, (const T*)a.wm, (const int*)a.gidx,
                                      (const T*)a.wt, (const int64_t*)a.row_ptr, (T*)a.out,
                                      a.d_in, a.d_out, a.num_segments, a.weighted, a.mean,
                                      a.vec_out);
  return 0;
}

template <typename T, int V, int TILE>
int by_lanes(int lpr, const Args& a, cudaStream_t st) {
  switch (lpr) {
    case 4: return launch<T, V, 4, TILE>(a, st);
    case 8: return launch<T, V, 8, TILE>(a, st);
    case 16: return launch<T, V, 16, TILE>(a, st);
    case 32: return launch<T, V, 32, TILE>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int TILE>
int by_vec(int v, int lpr, const Args& a, cudaStream_t st) {
  switch (v) {
    case 1: return by_lanes<T, 1, TILE>(lpr, a, st);
    case 2: return by_lanes<T, 2, TILE>(lpr, a, st);
    case 4: return by_lanes<T, 4, TILE>(lpr, a, st);
    case 8:
      if constexpr (sizeof(T) == 2) return by_lanes<T, 8, TILE>(lpr, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int TILE>
int by_dtype(int dtype, int v, int lpr, const Args& a, cudaStream_t st) {
  return dtype == DT_F32 ? by_vec<float, TILE>(v, lpr, a, st)
                         : by_vec<__nv_bfloat16, TILE>(v, lpr, a, st);
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// `row_ptr` holds num_segments + 1 int64 row offsets of the sorted segment
// index; `wt` is read only when `weighted`; `tile_segments` is the tile,
// the config's S_b: one of the built FOR_TILES, any other is refused.
extern "C" int ftr_launch(int dtype, int mean, int weighted, const void* h, const void* wm,
                          const void* gidx, const void* wt, const void* row_ptr, void* out,
                          int d_in, int d_out, int num_segments, int tile_segments,
                          void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (d_in < 1 || d_out < 1 || num_segments < 1 ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == DT_F32 ? 4 : 2;
  // widest vector (at most 16 bytes) that divides a row and keeps H aligned
  int v = 16 / es;
  while (v > 1 && (d_in % v != 0 || ((uintptr_t)h % (v * es)) != 0)) v /= 2;
  // lane groups of 4 to 32; a row narrower than 4 vectors masks the rest
  int lpr = 4;
  while (lpr < 32 && lpr * v < d_in) lpr *= 2;
  const int vec_out = (d_out * es) % 16 == 0 && ((uintptr_t)out % 16) == 0;
  Args a{h, wm, gidx, wt, row_ptr, out, d_in, d_out, num_segments, weighted != 0,
         mean != 0, vec_out};
  cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaErrorInvalidValue;
  switch (tile_segments) {
#define FTR_TILE(T)                                 \
  case T:                                           \
    err = by_dtype<T>(dtype, v, lpr, a, st);        \
    break;
    FOR_TILES(FTR_TILE)
#undef FTR_TILE
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
