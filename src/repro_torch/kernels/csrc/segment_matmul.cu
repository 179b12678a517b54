// Grouped matmul on Hopper, one launch for every relation:
//
//   out[r, :] = X[r, :] @ W[g]      for the rows r of group g, [off[g], off[g+1])
//
// Rows past off[G] belong to no group and are written as 0.
//
// Replaces the TPU kernel src/repro/kernels/segment_matmul.py:
// segment_matmul_pallas (body _body).
//
// What bounds it on the H100: bytes. At the typed-GNN widths (K in {32, 64},
// N in {16 .. 128}) a row costs K + N io elements of traffic against
// 2 * K * N flops: 8 to 21 flops a byte in fp32, far below the tensor cores'
// ridge (495 TFLOP/s TF32, 989 bf16, against 3.35 TB/s). So X has to stream
// in, and `out` back, at HBM rate, with the arithmetic off the critical path.
// W (G x K x N, 2.2 MB at 133 x 64 x 64 fp32) stays in L2.
//
// Design: a block of 8 warps owns a contiguous range of 128-row tiles (a
// few blocks per SM, all tiles the same size, so the split is even) and all
// N columns up to 128 (wider N takes more column tiles), so X is read once.
// A warp computes 32 rows (two m16 slabs) by half the columns, so each B
// fragment it loads feeds two products.
//  * X tiles stream through two shared-memory stages with cp.async (16-byte
//    copies where the row allows), so the load of the next tile overlaps
//    the products and the epilogue of this one; rows past the end are
//    zero-filled by the copy.
//  * W[g] of the current group stays in shared memory while the group lasts
//    (it is reloaded only when a tile reaches a new group), transposed and
//    laid out so each thread reads its B fragment with one 16- or 8-byte
//    load, without bank conflicts.
//  * Products run on the tensor cores with mma.sync: bf16 as m16n8k16 with
//    fp32 accumulators; fp32 as m16n8k8 TF32 with the 3xTF32 split
//    (x = x_hi + x_lo, w = w_hi + w_lo, x_hi with its low 13 mantissa bits
//    cleared, x_lo = x - x_hi, which the tensor core truncates to TF32;
//    x_lo*w_hi + x_hi*w_lo + x_hi*w_hi), whose error is of the order of a
//    plain fp32 product's. W is split once when it is loaded, X per
//    fragment.
//  * A tile that spans several groups runs its product once per group it
//    overlaps, with the rows of other groups zeroed in the A fragments, into
//    one set of accumulators; a warp whose rows miss the group skips it.
//    The group walk starts from the plan's first_group and ends at the
//    group_count of the row block holding the tile's last row.
//  * The epilogue writes every row of the tile once (rows of no group kept
//    their 0): fp32 straight from the fragments, bf16 through a shared-
//    memory stage in 16-byte stores of whole rows. No atomics, and the
//    result does not depend on scheduling.
//  * A K too deep for two X stages and the W tile to fit in 227 KB of
//    shared memory (above about 110 to 200 in fp32, 250 to 380 in bf16,
//    by N) is cut into chunks of KC columns, a multiple of 16: a tile then
//    takes one pass per chunk, each streaming its X columns through the
//    same stages and reloading W[g]'s rows of the chunk, into the same
//    accumulators; the epilogue runs after the last chunk. At the typed
//    widths the whole K is one chunk and W stays resident.
// Row offsets are 64-bit: M * N reaches 7.7e8 at the AM graph.
#include "common.cuh"

namespace {

constexpr int SLAB = 16;               // rows of one mma fragment
constexpr int THREADS = 256;           // 8 warps: 4 row slabs x 2 column halves
constexpr int MS = 2;                  // m16 slabs a warp: 128-row tiles
constexpr int BM = 4 * SLAB * MS;      // rows of a tile
constexpr int MAX_SMEM = 232448;       // dynamic shared memory a block may use
// X stages: double buffering. On the H100 a ring of 3 or 4 stages ran
// slower at the typed widths (it leaves fewer blocks on an SM, and was no
// faster at equal occupancy); the next tile's copy still overlaps this
// one's products and epilogue.
constexpr int STAGES = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;  // 0: zero-fill, the source is not read
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 3xTF32 split of one fp32 value: hi keeps the top 10 mantissa bits, lo
// is the exact rest, of which the tensor core reads the top 10 (it
// truncates an operand to TF32)
__device__ __forceinline__ void split_tf32(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  hi = bits & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(bits) - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory geometry, in 32-bit words, shared by host and device, for
// a chunk of k_dim columns of K. X stage: BM rows of K_pad io elements, row stride = 4 (mod 32) words, so the
// A-fragment loads of a warp hit 32 different banks. W tile: per column n,
// one 16-word block per k8 step (fp32: hi and lo of k = t and t + 4 for each
// t < 4) or one 8-word block per k16 step (bf16: the pairs of k = 2t, 2t + 1
// and 2t + 8, 2t + 9), column stride = 16 resp. 8 (mod 32) words. Output
// stage (bf16 only, see the epilogue): BM rows of BN elements, row stride =
// 4 (mod 32) words, so the accumulator fragments are stored without
// conflicts.
struct Geometry {
  int kstep, k_pad, xw, ws, bn, bm, os;
  __host__ __device__ Geometry(bool f32, int k_dim, int bn_) : bn(bn_), bm(BM) {
    kstep = f32 ? 8 : 16;
    k_pad = (k_dim + kstep - 1) / kstep * kstep;
    const int kw = f32 ? k_pad : k_pad / 2;  // words of one X row
    xw = kw + (36 - kw % 32) % 32;
    const int wk = f32 ? 2 * k_pad : k_pad / 2;
    const int want = f32 ? 16 : 8;
    ws = wk + (want + 32 - wk % 32) % 32;
    os = f32 ? 0 : bn / 2 + (36 - (bn / 2) % 32) % 32;
  }
  __host__ __device__ int x_stage_words() const { return bm * xw; }
  __host__ __device__ int bytes() const {
    return 4 * (STAGES * x_stage_words() + bn * ws + bm * os);
  }
};

// NT: n8 tiles per warp, so a block covers BN = 16 * NT columns (each B
// fragment a warp loads feeds MS products). CHUNKED: K is taken in nkc_
// chunks of kc_ columns; else in one (a separate instance, so the chunk
// bookkeeping costs the typed widths no registers).
template <typename T, int NT, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
smm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ off,
           const int* __restrict__ fg, const int* __restrict__ gc, T* __restrict__ out,
           int64_t num_rows, int k_dim, int n_dim, int num_groups, int m_b,
           int64_t tiles_per_block, int64_t num_tiles, int cw, int kc_, int nkc_) {
  constexpr bool F32 = sizeof(T) == 4;
  const int kc = CHUNKED ? kc_ : k_dim, nkc = CHUNKED ? nkc_ : 1;
  constexpr int BN = 16 * NT;
  extern __shared__ __align__(16) uint32_t smem[];
  const Geometry geo(F32, kc, BN);
  uint32_t* xs = smem;
  uint32_t* ws = smem + STAGES * geo.x_stage_words();
  T* ob = reinterpret_cast<T*>(ws + BN * geo.ws);   // the output stage (bf16)
  const int ostride = geo.os * 2;                   // its row stride, elements
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;      // mma fragment coordinates
  const int slab = (warp & 3) * SLAB * MS;      // the warp's first row of a tile
  const int wn0 = (warp >> 2) * (BN / 2);       // the warp's first column
  const int n_base = blockIdx.y * BN;
  const int64_t tb = (int64_t)blockIdx.x * tiles_per_block;
  const int64_t te = min(tb + tiles_per_block, num_tiles);
  const int64_t items = (te - tb) * nkc;         // (tile, K chunk) pairs, in order
  const int row_bytes = k_dim * (int)sizeof(T);

  // padding columns of every stage stay 0: the copies write real columns only
  for (int i = tid; i < STAGES * geo.x_stage_words(); i += THREADS) xs[i] = 0u;
  __syncthreads();

  // the X columns [c0, c0 + len) of item `item`'s tile into `stage`
  auto issue = [&](int64_t item, int stage) {
    if (item < items) {
      char* dst0 = reinterpret_cast<char*>(xs + stage * geo.x_stage_words());
      const int64_t r_base = (tb + item / nkc) * BM;
      const int c0 = (int)(item % nkc) * kc, len = min(kc, k_dim - c0);
      const int src0 = c0 * (int)sizeof(T);
      if (cw > 0) {
        const int cpr = len * (int)sizeof(T) / cw;
        for (int i = tid; i < BM * cpr; i += THREADS) {
          const int r = i / cpr, c = i % cpr;
          const int64_t row = r_base + r;
          const bool ok = row < num_rows;
          const char* src = reinterpret_cast<const char*>(x) +
                            (ok ? row * row_bytes + src0 + c * cw : 0);
          char* dst = dst0 + r * geo.xw * 4 + c * cw;
          if (cw == 16) cp_async<16>(dst, src, ok);
          else if (cw == 8) cp_async<8>(dst, src, ok);
          else cp_async<4>(dst, src, ok);
        }
      } else {  // rows of an odd number of 2-byte elements: one element a load
        const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
        for (int i = tid; i < BM * len; i += THREADS) {
          const int r = i / len, c = i % len;
          const int64_t row = r_base + r;
          reinterpret_cast<unsigned short*>(dst0 + r * geo.xw * 4)[c] =
              row < num_rows ? xh[row * k_dim + c0 + c] : (unsigned short)0;
        }
      }
      // a last chunk shorter than kc: its columns up to the next k step held
      // an earlier chunk's values, which would meet W's zero rows
      const int pad = (len + geo.kstep - 1) / geo.kstep * geo.kstep - len;
      if (CHUNKED && pad > 0)
        for (int i = tid; i < BM * pad; i += THREADS)
          reinterpret_cast<T*>(dst0 + (i / pad) * geo.xw * 4)[len + i % pad] = from_f<T>(0.f);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  // W[g]'s column tile, rows [c0, c0 + kc) of K, into shared memory, zero
  // past K and N
  auto load_w = [&](int g, int c0) {
    const T* wg = w + ((int64_t)g * k_dim + c0) * n_dim;
    for (int i = tid; i < geo.k_pad * BN; i += THREADS) {
      const int k = i / BN, n = i % BN, col = n_base + n;
      const bool ok = c0 + k < k_dim && col < n_dim;
      if constexpr (F32) {
        const float v = ok ? wg[(int64_t)k * n_dim + col] : 0.f;
        uint32_t hi, lo;
        split_tf32(__float_as_uint(v), hi, lo);
        const int kk = k & 7;
        uint32_t* blk = ws + n * geo.ws + (k >> 3) * 16 + (kk & 3) * 4 + (kk >> 2);
        blk[0] = hi;
        blk[2] = lo;
      } else {
        const unsigned short v =
            ok ? reinterpret_cast<const unsigned short*>(wg)[(int64_t)k * n_dim + col]
               : (unsigned short)0;
        const int kk = k & 15;
        const int word = n * geo.ws + (k >> 4) * 8 + ((kk & 7) >> 1) * 2 + (kk >> 3);
        reinterpret_cast<unsigned short*>(ws + word)[kk & 1] = v;
      }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) issue(s, s);
  int g = tb < te ? max(fg[(tb * BM) / m_b], 0) : num_groups;
  int w_loaded = -1;  // group * nkc + chunk of the W tile in shared memory
  float acc[MS][NT][4];

  for (int64_t it = 0; it < items; ++it) {
    const int64_t tile = tb + it / nkc;
    const int chunk = (int)(it % nkc), c0 = chunk * kc;
    const int64_t t0 = tile * BM, t1 = min(t0 + BM, num_rows);
    const int stage = (int)(it % STAGES);
    issue(it + STAGES - 1, (int)((it + STAGES - 1) % STAGES));
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    if (chunk == 0) {
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[ms][j][q] = 0.f;
    }
    const int ksteps = (min(kc, k_dim - c0) + geo.kstep - 1) / geo.kstep;

    while (g < num_groups && off[g + 1] <= t0) ++g;
    const int64_t last_blk = (t1 - 1) / m_b;
    const int g_end = min(num_groups, fg[last_blk] + gc[last_blk]);
    const uint32_t* xsb = xs + stage * geo.x_stage_words();
    for (int gg = g; gg < g_end && off[gg] < t1; ++gg) {
      const int ra = (int)(max((int64_t)off[gg], t0) - t0);
      const int re = (int)(min((int64_t)off[gg + 1], t1) - t0);
      if (ra >= re) continue;  // an empty group
      if (gg * nkc + chunk != w_loaded) {  // uniform over the block
        __syncthreads();
        load_w(gg, c0);
        __syncthreads();
        w_loaded = gg * nkc + chunk;
      }
      if (re <= slab || ra >= slab + SLAB * MS) continue;  // none of this warp's rows
      bool m_lo[MS], m_hi[MS];
      const uint32_t* xlo[MS];
      const uint32_t* xhi[MS];
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) {
        const int r_lo = slab + ms * SLAB + gq, r_hi = r_lo + 8;
        m_lo[ms] = r_lo >= ra && r_lo < re;
        m_hi[ms] = r_hi >= ra && r_hi < re;
        xlo[ms] = xsb + r_lo * geo.xw;
        xhi[ms] = xsb + r_hi * geo.xw;
      }
#pragma unroll 2
      for (int kb = 0; kb < ksteps; ++kb) {
        // A fragments: (row gq, k tq), (gq + 8, tq), (gq, tq + 4), (gq + 8,
        // tq + 4) of each slab, in words of the X row (bf16: pairs of k)
        const int kw = kb * 8 + tq;
        uint32_t a[MS][4];
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          a[ms][0] = m_lo[ms] ? xlo[ms][kw] : 0u;
          a[ms][1] = m_hi[ms] ? xhi[ms][kw] : 0u;
          a[ms][2] = m_lo[ms] ? xlo[ms][kw + 4] : 0u;
          a[ms][3] = m_hi[ms] ? xhi[ms][kw + 4] : 0u;
        }
        if constexpr (F32) {
          uint32_t ah[MS][4], al[MS][4];
#pragma unroll
          for (int ms = 0; ms < MS; ++ms)
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(a[ms][q], ah[ms][q], al[ms][q]);
          uint4 b[NT];  // (w_hi, w_hi, w_lo, w_lo) of k = tq, tq + 4
#pragma unroll
          for (int j = 0; j < NT; ++j)
            b[j] = *reinterpret_cast<const uint4*>(ws + (wn0 + j * 8 + gq) * geo.ws +
                                                   kb * 16 + tq * 4);
          // three passes, so neighbouring products are independent:
          // x_lo * w_hi, x_hi * w_lo, then x_hi * w_hi
#pragma unroll
          for (int ms = 0; ms < MS; ++ms)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_tf32(acc[ms][j], al[ms], b[j].x, b[j].y);
#pragma unroll
          for (int ms = 0; ms < MS; ++ms)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_tf32(acc[ms][j], ah[ms], b[j].z, b[j].w);
#pragma unroll
          for (int ms = 0; ms < MS; ++ms)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_tf32(acc[ms][j], ah[ms], b[j].x, b[j].y);
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                ws + (wn0 + j * 8 + gq) * geo.ws + kb * 8 + tq * 2);
#pragma unroll
            for (int ms = 0; ms < MS; ++ms) mma_bf16(acc[ms][j], a[ms], b.x, b.y);
          }
        }
      }
    }

    if (chunk != nkc - 1) {  // more of K to come into these accumulators
      __syncthreads();       // this stage is refilled by the next issue
      continue;
    }
    // every row of the tile once (rows of no group kept their 0). fp32:
    // straight from the fragments, whose 8-byte stores fill whole 32-byte
    // sectors. bf16: a fragment store fills half a sector, so the
    // fragments go to the output stage and whole rows go out in 16-byte
    // stores where the row allows.
    if constexpr (F32) {
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n_base + wn0 + j * 8 + tq * 2;
        if (col >= n_dim) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = t0 + slab + ms * SLAB + gq + h * 8;
          if (row >= t1) continue;
          T* o = out + row * n_dim + col;
          if ((n_dim & 1) == 0) {  // col is even, so col + 1 < n_dim
            *reinterpret_cast<float2*>(o) = make_float2(acc[ms][j][2 * h], acc[ms][j][2 * h + 1]);
          } else {
            o[0] = acc[ms][j][2 * h];
            if (col + 1 < n_dim) o[1] = acc[ms][j][2 * h + 1];
          }
        }
      }
    } else {
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(ob + (slab + ms * SLAB + gq + h * 8) * ostride + wn0 +
                                             j * 8 + tq * 2) =
              __floats2bfloat162_rn(acc[ms][j][2 * h], acc[ms][j][2 * h + 1]);
      __syncthreads();
      const int rows = (int)(t1 - t0), cols = min(BN, n_dim - n_base);
      T* og = out + t0 * n_dim + n_base;
      if ((n_dim * (int)sizeof(T)) % 16 == 0) {
        const int cpr = cols * (int)sizeof(T) / 16;  // 16-byte pieces a row
        for (int i = tid; i < rows * cpr; i += THREADS) {
          const int r = i / cpr, c = i % cpr;
          *reinterpret_cast<uint4*>(reinterpret_cast<char*>(og + (int64_t)r * n_dim) + c * 16) =
              *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(ob + r * ostride) +
                                              c * 16);
        }
      } else {
        for (int i = tid; i < rows * cols; i += THREADS) {
          const int r = i / cols, c = i % cols;
          og[(int64_t)r * n_dim + c] = ob[r * ostride + c];
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's issue
  }
  cp_async_wait<0>();
}

// the widest K chunk, a multiple of 16, whose stages and W tile fit, or K
// itself where it fits
int chunk_cols(bool f32, int k_dim, int bn) {
  if (Geometry(f32, k_dim, bn).bytes() <= MAX_SMEM) return k_dim;
  int kc = (k_dim + 15) / 16 * 16;
  while (kc > 16 && Geometry(f32, kc, bn).bytes() > MAX_SMEM) kc -= 16;
  // as many chunks as that takes, evened out
  const int nkc = (k_dim + kc - 1) / kc;
  return ((k_dim + nkc - 1) / nkc + 15) / 16 * 16;
}

template <typename T, int NT, bool CHUNKED>
int launch_tile(const void* x, const void* w, const void* off, const void* fg, const void* gc,
                void* out, int64_t num_rows, int k_dim, int n_dim, int num_groups, int m_b,
                int kc, cudaStream_t st) {
  constexpr bool F32 = sizeof(T) == 4;
  const int nkc = (k_dim + kc - 1) / kc;
  const int smem = Geometry(F32, kc, 16 * NT).bytes();
  auto kernel = smm_kernel<T, NT, CHUNKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t num_tiles = (num_rows + BM - 1) / BM;
  const int64_t slots = (int64_t)per_sm * sms;
  const int64_t tpb = (num_tiles + slots - 1) / slots;
  const dim3 grid((unsigned)((num_tiles + tpb - 1) / tpb), (unsigned)((n_dim + 16 * NT - 1) / (16 * NT)));
  // widest cp.async copy that divides a row and a chunk and keeps the
  // source aligned
  const int row_bytes = k_dim * (int)sizeof(T);
  int cw = 16;
  while (cw >= 4 && (row_bytes % cw != 0 || (kc * (int)sizeof(T)) % cw != 0 ||
                     (uintptr_t)x % cw != 0))
    cw /= 2;
  if (cw < 4) cw = 0;
  kernel<<<grid, THREADS, smem, st>>>((const T*)x, (const T*)w, (const int*)off,
                                      (const int*)fg, (const int*)gc, (T*)out, num_rows,
                                      k_dim, n_dim, num_groups, m_b, tpb, num_tiles, cw, kc,
                                      nkc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* off, const void* fg, const void* gc,
           void* out, int64_t num_rows, int k_dim, int n_dim, int num_groups, int m_b,
           cudaStream_t st) {
  // a column tile of 16 * NT >= N columns, at most 128 (wider N: more tiles)
  const int nt = min((n_dim + 15) / 16, 8);
  const int kc = chunk_cols(sizeof(T) == 4, k_dim, 16 * nt);
#define SMM_NT(N)                                                                          \
  case N:                                                                                  \
    return kc == k_dim ? launch_tile<T, N, false>(x, w, off, fg, gc, out, num_rows, k_dim, \
                                                  n_dim, num_groups, m_b, kc, st)          \
                       : launch_tile<T, N, true>(x, w, off, fg, gc, out, num_rows, k_dim,  \
                                                 n_dim, num_groups, m_b, kc, st);
  switch (nt) {
    SMM_NT(1) SMM_NT(2) SMM_NT(3) SMM_NT(4) SMM_NT(5) SMM_NT(6) SMM_NT(7) SMM_NT(8)
  }
#undef SMM_NT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int smm_launch(int dtype, const void* x, const void* w, const void* off,
                          const void* fg, const void* gc, void* out, int64_t num_rows,
                          int k_dim, int n_dim, int num_groups, int m_b, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m_b < 1 || num_rows < 1 || k_dim < 1 || n_dim < 1 || num_groups < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch<float>(x, w, off, fg, gc, out, num_rows, k_dim, n_dim, num_groups, m_b, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, w, off, fg, gc, out, num_rows, k_dim, n_dim, num_groups,
                                 m_b, st);
  return (int)cudaErrorInvalidValue;
}
