// Fused whole-iteration IBP on Hopper (sm_90a): the forward error (K2) and
// the back-projection update (K3) of every frame, each in one launch.
//
//   K2  err[f] = lr[f] - sum_{(f,u,c)} (bandr[u] @ hr) @ bandc[c]^T
//   K3  hr'    = clip(hr + scale * sum_{(f,u,c)} (bandr[u] @ err[f]) @ bandc[c]^T)
//
// Replace the TPU kernels enph459_super_resolution_tpu/ops/pallas_fused_ibp.py
// `_fwd_body` (K2, launched by `_fwd_call`) and `_bwd_body` (K3, launched by
// `_bwd_call`).  Operands come from ops/fused_ibp.py: row operators packed
// as bandr [nb, n_u, blk_r, win_r] with one window start per row block (sr),
// column operators transposed as bandc [nt, n_c, win_c, tile_c] with one
// window start per column tile (sc), deduplicated by content, plus a plan
// that lists for each row product (input image, row operator) the column
// operators and outputs that consume it.  Every CUDA block owns a 64 x 64
// output tile (BM x TN) of one row block and one column tile, so blocks and
// tiles of any multiple of 64 (the port's 64/64 pack, the TPU's 128/256
// pack) map onto the same grid; any window start is taken.
//
// Two band types:
//
// * bfloat16 bands run the reference's bf16 dots on the tensor cores
//   (mma.sync m16n8k16, bf16 x bf16 summed in f32): the input window is
//   rounded to bf16, each row product ys is rounded to bf16 (nearest even)
//   before its column product; lr and err are bf16, hr and the update f32.
//   Both products of a tile form a chain of two GEMMs, as in flash
//   attention: the f32 C fragments of two adjacent n8 tiles of ys are,
//   once packed to bf16 pairs, the A fragment of one k16 step of the column
//   product, so ys never leaves the registers.  Each of the 8 warps owns 16
//   output rows.  K2 keeps one accumulator set per frame, so its warps
//   split the 64 columns in two and both warps of a row strip form the same
//   ys: 16 f32 accumulators per frame, 80 at 5 frames, two CTAs per SM.
//   K3 has one output: the two warps of a row strip take alternate plan
//   groups over all 64 columns (no ys is formed twice) and add their sums
//   through shared memory in the epilogue.  A CTA keeps its 64-row slice of
//   every unique row operator resident in shared memory (as many as fit; the
//   window is walked once per set where they do not) and walks the column
//   window in chunks of 16 (KS) intermediate columns, chunk outer and plan
//   inner, so each input chunk and column-operator chunk is staged once and
//   used by every group.  A ring filled by cp.async (16-byte copies,
//   zero-filled past the window and the image; element copies where a
//   window start is not 16-byte aligned; the port's pack aligns its column
//   starts) overlaps the next chunks' loads with this chunk's products.
//   K2's hr is f32 in memory: its chunk lands as f32 and is rounded to bf16
//   pairs once per CTA; K3's err is bf16 and lands as it is, every frame's
//   chunk in each stage.  A K3 CTA walks four adjacent column tiles with its
//   row operators resident and the ring running on from one tile into the
//   next.  Windows are zero-padded to multiples of 16 in shared memory, so
//   the last chunk wastes nothing beyond the pack's own padding; rows are
//   padded to odd multiples of 16 bytes, so the ldmatrix reads are
//   conflict-free.  The epilogue of a whole tile issues every load of lr
//   or hr before its first store.
// * float32 bands run strict f32 (CUDA-core FMA only: no tensor cores, no
//   TF32, no --use_fast_math).  K2 (fused_fwd_f32_kernel<NOUT>): a CUDA
//   block owns one 64 x 64 tile, every frame, with two warps per frame
//   (64 * NOUT threads), one per 32-column half, each lane on K1's 8 x 8
//   f32 register tile (64 accumulators whatever NOUT is).  Every row
//   operator stays resident, k-major, with its nonzero k range per 32-row
//   half.  The tile's column window, from a multiple of 4, is walked in
//   16-column chunks, one step per chunk and one more: step s forms every
//   plan group's row product bandr[u] @ hr of chunk s into one of two
//   k-major buffers, each 32-row half by one warp on 4 x 4 tiles over its
//   k range, while every warp adds its frame's terms ys_u @ bandc[c] of
//   chunk s - 1 from the other buffer, skipping a column operator whose
//   chunk is zero in its 32 columns; so the warps without a row task (4 of
//   10 at the mono pack) do their column products meanwhile, and one
//   barrier a step parts the buffers.  The row tasks go first to the
//   warps of the SM sub-partitions (warp % 4) that hold fewer of the
//   block's warps, which measured faster at the mono pack than dealing
//   them in warp order.  Each step's hr chunk and column-operator chunks
//   come through K3's ring of TMA boxes on mbarriers (by cp.async where hr's
//   rows are off 16 bytes); a plan whose row operators do not all fit is
//   walked one group per set, the frames' sums live across sets.  ptxas:
//   163 registers at NOUT 5 and 6, 203 at 4, 181 at 3, 203 at 1 and 2, no
//   spill; 128 at NOUT 7 and 8 (448 and 512 threads), which spill (204 /
//   360 bytes stored): slower, not wrong.
//   K3 (fused_bwd_f32_kernel): a CUDA block owns a strip of NT = 4 adjacent
//   64-column tiles of one 64-row strip and walks the union of their column
//   windows (176 LR columns at the mono pack, against 4 x 80 windows) in
//   chunks of 16, chunk outer and plan inner.  Each group's row product
//   bandr[u] @ err[f] is formed once per chunk into a k-major buffer by two
//   warps, one per 32-row half, on 4 x 4 register tiles over the k range
//   where that half of the operator is nonzero; then each tile's two warps,
//   one per 32-column half, add its product with bandc[c] on K1's 8 x 8 f32
//   register tile, for the chunks that overlap the tile's own window, and
//   skip a column operator whose chunk is zero in their half.  Every row
//   operator stays resident, k-major.  Each chunk of every frame's err and
//   of every column operator for the strip's tiles lands once per block in
//   a ring of TMA boxes (cp.async.bulk.tensor, a box per lane of warp 0,
//   completion counted on an mbarrier per stage); rows and columns outside
//   the image or a tile's window land as zeros.  Where the TMA cannot
//   describe err (rows off 16 bytes) the chunks come by cp.async.  A strip
//   whose windows spread wider than NT windows (unordered starts) takes
//   NT = 1; a plan whose operators do not all fit is walked one group at a
//   time.  The row product comes first, then the column product, as in the
//   reference; only the order within each sum differs.  NT = 4 measured
//   faster than 2, which is not built (PERF.md); ptxas: 230 registers at
//   NT 4, 178 at 1, no spill.
//
// What bounds it.  At LR 1536x2048 -> HR 3072x4096 with 5 frames and 3
// unique row operators, the bands' nonzeros need 2.7 GFLOP in K2 and 6.5
// in K3: at ~67 TFLOP/s of f32 FMA (SMs x 128 FMA/clk at 700 W) 0.040
// and 0.097 ms, against ~0.18 GB each launch moves at 3.35 TB/s (0.055
// ms), so the least time K2 could take is its bytes' and K3's its
// operations' (chip_smoke.py _fused_work).  Dense 64-row tiles over whole
// windows perform more.  K2's dense-window work is ~2 * 7.3 G FMA; the
// f32 K2 performs 8.9 GFLOP of it: 5.4 of row products over the k ranges
// of 11 chunks of 16 columns, 3.5 of column products after the zero
// chunks (chip_smoke.py _k2_f32_flops; the loop it replaced did 15.6 over
// 32-column chunks padded to 192 and whole windows).  It is held by the
// CUDA cores' FMA issue: 10 warps, one CTA per SM (209 KB of shared
// memory), row products 16 FMA per 2 shared loads, column products 64
// per 4, about a quarter of the f32 peak on that work and a tenth of its
// bound (PERF.md).  The f32 K3 forms 6.2 GFLOP of row products over the
// strips' union windows (less after the k ranges) and 10.1 of column
// products over the tiles' windows (less after the zero chunks), about
// 15 % of its bound.  Its 220 KB of shared memory leave one CTA, eight
// warps, per SM.  The row product's 4 x 4 tiles need one 16-byte shared
// load per 8 FMA, and the column product idles the warps of tiles whose
// window misses the chunk, about half of them (PERF.md gives the
// breakdown).  With bf16 bands the bound
// is the bytes (hr, lr and err, ~117 MB for K2 and ~135 MB for K3 at
// 3.35 TB/s: 0.035-0.040 ms); the products (~24 GFLOP each, with the
// padded windows and K2's doubled row product) take about as long at a
// third of the tensor cores' 989 TFLOP/s.  On an H100 at 700 W the bf16
// kernels are bound by neither: they run at 0.23-0.25 ms per launch at
// that size, held by the latency of their chains of dependent ldmatrix
// and mma.sync steps and of the staging between them.

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;        // output rows per CUDA block (fused_ibp.py ROWS)
constexpr int TN = 64;        // output columns per CUDA block (fused_ibp.py COLS)
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int MAX_OUT = 8;    // frames of one K2 launch (fused_ibp.py MAX_FRAMES)
constexpr int MAX_SMEM = 232448;

using bf16 = __nv_bfloat16;

template <typename BandT>
struct Ops {
  const BandT* bandr;  // [nb, n_u, blk_r, win_r]
  const int* sr;       // [nb] first input row of each row block's window
  const BandT* bandc;  // [nt, n_c, win_c, tile_c]
  const int* sc;       // [nt] first input column of each tile's window
  int n_u, blk_r, win_r, n_c, win_c, tile_c;
  const int* groups;   // [n_groups, 4]: input, row op, first consumer, end
  const int* cons;     // [n_cons, 2]: column op, output
  int n_groups;
  int src_rows, src_cols;  // one input image
};

// Which row block, row offset, column tile and column offset this CUDA
// block owns.
struct Tile {
  int b, r_off, j, c_off;
};

__device__ __forceinline__ Tile tile_of(int blk_r, int tile_c) {
  const int per_tile = tile_c / TN;
  const int per_blk = blk_r / BM;
  return {static_cast<int>(blockIdx.y) / per_blk,
          (static_cast<int>(blockIdx.y) % per_blk) * BM,
          static_cast<int>(blockIdx.x) / per_tile,
          (static_cast<int>(blockIdx.x) % per_tile) * TN};
}

// ---------------------------------------------------------------------------
// bfloat16 bands: both products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int KS = 16;       // intermediate columns per chunk: one k16 step
constexpr int XS = KS + 8;   // row stride of a staged bf16 input chunk (48 B)
constexpr int CS = TN + 8;   // row stride of a staged bandc chunk (144 B)
// Depth of the cp.async ring: K2's f32 chunk leaves room for two stages at
// two CTAs per SM; K3 takes three (two measured the same).
constexpr int FWD_STAGES = 2;
constexpr int BWD_STAGES = 3;
// 64-column tiles per CUDA block, whose row operators stay resident across
// them.  K2's 768 tiles at the mono pack are 2.9 waves of 264 CTAs as they
// are (two per block measured slower); K3's 3,072 are short, and four per
// block measured fastest of 1, 2, 4 and 8.
constexpr int FWD_TILES = 1;
constexpr int BWD_TILES = 4;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared-memory layout of the bf16 kernels, byte offsets from the base:
// n_res resident row operators [n_res][BM][wr]; for the f32 input (K2),
// one [kr][XS] buffer of its chunk rounded to bf16; then the ring of
// `stages` stages, each the input chunk (f32 input: [kr][KS] f32; bf16
// inputs: [n_src][kr][XS] bf16) followed by the column-operator chunk
// [n_c][KS][CS].  K3 also sums its two warp sets' accumulators through the
// stage just consumed, so its stages hold at least RED_BYTES.  kr is the row
// window padded to 16 and wr = kr + 8, so every row is an odd multiple of
// 16 bytes and the eight rows an ldmatrix reads fall in distinct banks.
constexpr int RED_BYTES = 4 * 32 * THREADS / 2;  // K3: 32 floats per thread

struct Layout {
  int kr, wr;
  size_t xb, ring, stage, bc, total;
};

__host__ __device__ inline Layout layout(int n_res, int win_r, int n_c,
                                         int n_src, bool f32_src,
                                         int stages) {
  Layout l;
  l.kr = round16(win_r);
  l.wr = l.kr + 8;
  l.xb = sizeof(bf16) * n_res * BM * l.wr;
  l.ring = l.xb + (f32_src ? sizeof(bf16) * l.kr * XS : 0);
  l.bc = f32_src ? sizeof(float) * l.kr * KS
                 : sizeof(bf16) * n_src * l.kr * XS;
  l.stage = l.bc + sizeof(bf16) * n_c * KS * CS;
  if (!f32_src && l.stage < static_cast<size_t>(RED_BYTES)) l.stage = RED_BYTES;
  l.total = l.ring + stages * l.stage;
  return l;
}

// The most row operators that stay resident together within MAX_SMEM (the
// kernel walks the plan once per such set); 0 if not even one fits.
inline int resident_ops(int n_u, int win_r, int n_c, int n_src, bool f32_src,
                        int stages) {
  int n = n_u;
  while (n > 0 && layout(n, win_r, n_c, n_src, f32_src, stages).total >
                      static_cast<size_t>(MAX_SMEM))
    --n;
  return n;
}

// rows x n bf16 elements (n a multiple of 8) from src (row stride ss) into
// dst (row stride ds); zero where row >= vrows or column >= vcols.  `vec`:
// 16-byte cp.async copies (src rows 16-byte aligned, vcols a multiple of
// 8); otherwise element by element.
__device__ __forceinline__ void stage_bf16(bf16* dst, int ds, const bf16* src,
                                           size_t ss, int rows, int n,
                                           int vrows, int vcols, bool vec) {
  const int per = n / 8;
  for (int e = threadIdx.x; e < rows * per; e += THREADS) {
    const int r = e / per;
    const int c = (e - r * per) * 8;
    bf16* d = dst + r * ds + c;
    if (vec) {
      const bool in = r < vrows && c < vcols;
      mma_bf16::cp_async16(d, in ? src + r * ss + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = r < vrows && c + i < vcols ? src[r * ss + c + i]
                                          : __float2bfloat16_rn(0.f);
    }
  }
}

// rows x KS floats, as stage_bf16 (`vec`: vcols a multiple of 4).
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          size_t ss, int rows, int vrows,
                                          int vcols, bool vec) {
  for (int e = threadIdx.x; e < rows * (KS / 4); e += THREADS) {
    const int r = e / (KS / 4);
    const int c = (e % (KS / 4)) * 4;
    float* d = dst + r * KS + c;
    if (vec) {
      const bool in = r < vrows && c < vcols;
      mma_bf16::cp_async16(d, in ? src + r * ss + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[i] = r < vrows && c + i < vcols ? src[r * ss + c + i] : 0.f;
    }
  }
}

// One k16 step of a 16 x 16 product: A from a row-major tile (ldmatrix),
// B from a k-major tile (ldmatrix.trans), into two n8 accumulators.
__device__ __forceinline__ void mma_k16(float (&y)[2][4], const bf16* a,
                                        const bf16* b) {
  uint32_t af[4], bf[4];
  mma_bf16::ldmatrix_x4(af, a);
  mma_bf16::ldmatrix_x4_trans(bf, b);
  mma_bf16::mma_16816(y[0], af, bf[0], bf[1]);
  mma_bf16::mma_16816(y[1], af, bf[2], bf[3]);
}

// The output tiles of one CUDA block: the 64-row strip r_off of row block b
// and n_tiles consecutive 64-column tiles from jt0 on, counted across the
// pack's column tiles (tile_c / TN each).
struct Strip {
  int b, r_off, jt0, n_tiles;
};

__device__ __forceinline__ Strip strip_of(int blk_r, int n_cols,
                                          int per_cta) {
  const int per_blk = blk_r / BM;
  const int y = blockIdx.y;
  const int jt0 = static_cast<int>(blockIdx.x) * per_cta;
  return {y / per_blk, (y % per_blk) * BM, jt0, min(per_cta, n_cols - jt0)};
}

// Walks this block's tiles and, for each, accumulates terms of the plan as
// mma C fragments, warp (wm, wn) = (warp % 4, warp / 4) holding rows
// wm*16..+15.  NT = 4 (K2): every term, columns wn*32 + nt*8 .. +7 (4 n8
// tiles); both warps of a row strip form the same row products, so each
// holds 16 accumulators per output.  NT = 8 (K3, one output): the terms of
// the groups g with g % 2 == wn, all 64 columns; the epilogue adds the two
// warps' sums.  After a tile's last chunk it calls epi(acc, j, c_off,
// scratch), scratch being the stage just consumed (free until the next
// chunk's loads are issued), and zeroes acc.  SrcT float: one input (hr),
// rounded to bf16 on the way in; bf16: n_src inputs (the err stack).  The
// row operators stay resident n_res at
// a time.  With one set (every pack of the solves) they are staged once
// and the ring runs on from one tile into the next; with more, each tile
// walks its column window once per set.
template <typename SrcT, int NOUT, int STAGES, int NT, typename Epi>
__device__ __forceinline__ void mma_tiles(const Ops<bf16>& p,
                                          const SrcT* __restrict__ src,
                                          int n_src, int n_res,
                                          const Strip& st, Epi&& epi) {
  using namespace mma_bf16;
  constexpr bool kF32 = std::is_same<SrcT, float>::value;
  constexpr int PER16 = 16 / static_cast<int>(sizeof(SrcT));
  extern __shared__ __align__(128) char mma_smem[];
  const Layout L = layout(n_res, p.win_r, p.n_c, n_src, kF32, STAGES);
  bf16* br_s = reinterpret_cast<bf16*>(mma_smem);
  bf16* xb_s = reinterpret_cast<bf16*>(mma_smem + L.xb);
  char* ring = mma_smem + L.ring;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  // ldmatrix lane addresses: lanes 8m..8m+7 give the rows of matrix m,
  // rows (m % 2) * 8 + lane % 8 at column (m / 2) * 8 of a 16 x 16 tile
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lc = (lane >> 4) * 8;

  const int row0 = p.sr[st.b];
  const size_t plane = static_cast<size_t>(p.src_rows) * p.src_cols;
  const int vrows = min(p.win_r, p.src_rows - row0);
  const int nk = (p.win_c + KS - 1) / KS;
  const int nks = L.kr / 16;
  const int per_tile = p.tile_c / TN;
  const int n_sets = (p.n_u + n_res - 1) / n_res;
  const int seg_tiles = n_sets == 1 ? st.n_tiles : 1;
  const bool x_vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                     p.src_cols % PER16 == 0 && p.win_c % PER16 == 0;
  const bool br_vec =
      (reinterpret_cast<uintptr_t>(p.bandr) & 15) == 0 && p.win_r % 8 == 0;
  const bool bc_vec =
      (reinterpret_cast<uintptr_t>(p.bandc) & 15) == 0 && p.tile_c % 8 == 0;

  float acc[NOUT][NT][4];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[o][n][c] = 0.f;

  // step (tile ti0 + step / nk, chunk step % nk): that chunk of every
  // column operator and of the input(s) into its stage of the ring
  auto load_step = [&](int step, int ti0) {
    const int jt = st.jt0 + ti0 + step / nk;
    const int j = jt / per_tile;
    const int c_off = (jt % per_tile) * TN;
    const int k0 = (step % nk) * KS;
    const int col0 = p.sc[j];
    char* stage = ring + (step % STAGES) * L.stage;
    bf16* bc = reinterpret_cast<bf16*>(stage + L.bc);
    for (int c = 0; c < p.n_c; ++c)
      stage_bf16(bc + c * KS * CS, CS,
                 p.bandc + ((static_cast<size_t>(j) * p.n_c + c) * p.win_c +
                            k0) * p.tile_c + c_off,
                 p.tile_c, KS, TN, p.win_c - k0, TN, bc_vec);
    const int vcols = min(p.win_c - k0, p.src_cols - col0 - k0);
    const bool vec = x_vec && col0 % PER16 == 0;
    const SrcT* x = src + static_cast<size_t>(row0) * p.src_cols + col0 + k0;
    if constexpr (kF32) {
      stage_f32(reinterpret_cast<float*>(stage), x, p.src_cols, L.kr, vrows,
                vcols, vec);
    } else {
      for (int in = 0; in < n_src; ++in)
        stage_bf16(reinterpret_cast<bf16*>(stage) + in * L.kr * XS, XS,
                   x + in * plane, p.src_cols, L.kr, KS, vrows, vcols, vec);
    }
  };

  for (int ti0 = 0; ti0 < st.n_tiles; ti0 += seg_tiles) {
    const int n_steps = seg_tiles * nk;
    for (int set = 0; set < n_sets; ++set) {
      const int u0 = set * n_res;
      const int u1 = min(p.n_u, u0 + n_res);
      if (n_sets > 1 || ti0 == 0) {
        __syncthreads();  // every reader of the previous set is done
        for (int u = u0; u < u1; ++u)
          stage_bf16(br_s + (u - u0) * BM * L.wr, L.wr,
                     p.bandr + ((static_cast<size_t>(st.b) * p.n_u + u) *
                                    p.blk_r + st.r_off) * p.win_r,
                     p.win_r, BM, L.kr, BM, p.win_r, br_vec);
      }
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_steps) load_step(s, ti0);
        cp_async_commit();
      }

      for (int step = 0; step < n_steps; ++step) {
        const int kc = step % nk;
        char* stage = ring + (step % STAGES) * L.stage;
        cp_async_wait<STAGES - 2>();
        // this step's chunk has landed for every thread, and every thread
        // is done with the previous step, whose stage is refilled next
        __syncthreads();
        if constexpr (kF32) {
          const float* xf = reinterpret_cast<const float*>(stage);
          for (int e = tid; e < L.kr * (KS / 2); e += THREADS) {
            const int r = e / (KS / 2);
            const int c = (e % (KS / 2)) * 2;
            const float2 v =
                *reinterpret_cast<const float2*>(xf + r * KS + c);
            *reinterpret_cast<uint32_t*>(xb_s + r * XS + c) =
                pack_bf16x2(v.x, v.y);
          }
        }
        if (step + STAGES - 1 < n_steps) load_step(step + STAGES - 1, ti0);
        cp_async_commit();
        if constexpr (kF32) __syncthreads();  // the rounded chunk is ready

        const bf16* xs = kF32 ? xb_s : reinterpret_cast<const bf16*>(stage);
        const bf16* bc = reinterpret_cast<const bf16*>(stage + L.bc);
        for (int g = NT == 8 ? wn : 0; g < p.n_groups;
             g += NT == 8 ? 2 : 1) {
          // (input, row op, first consumer, end) in one load
          const int4 gr = __ldg(reinterpret_cast<const int4*>(p.groups) + g);
          const int u = gr.y;
          if (u < u0 || u >= u1) continue;
          // ys (16 rows x 16 intermediate columns) over the row window,
          // with two accumulator sets for even and odd k16 steps
          const bf16* a = br_s + ((u - u0) * BM + wm * 16 + lr) * L.wr + lc;
          const bf16* x = xs + (kF32 ? 0 : gr.x * L.kr * XS) + lr * XS + lc;
          float y0[2][4] = {}, y1[2][4] = {};
          int ks = 0;
          for (; ks + 1 < nks; ks += 2) {
            mma_k16(y0, a + ks * 16, x + ks * 16 * XS);
            mma_k16(y1, a + ks * 16 + 16, x + (ks + 1) * 16 * XS);
          }
          if (ks < nks) mma_k16(y0, a + ks * 16, x + ks * 16 * XS);
          // rounded to bf16: the C fragments of the two n8 tiles are the A
          // fragment of the column product's k16 step
          uint32_t ya[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ya[h] = pack_bf16x2(y0[0][2 * h] + y1[0][2 * h],
                                y0[0][2 * h + 1] + y1[0][2 * h + 1]);
            ya[2 + h] = pack_bf16x2(y0[1][2 * h] + y1[1][2 * h],
                                    y0[1][2 * h + 1] + y1[1][2 * h + 1]);
          }
          for (int q = gr.z; q < gr.w; ++q) {
            // (column op, output)
            const int2 co = __ldg(reinterpret_cast<const int2*>(p.cons) + q);
            const int cop = co.x;
            const int o = co.y;
            const bf16* cb =
                bc + cop * KS * CS + lr * CS + (NT == 8 ? 0 : wn * 32) + lc;
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              uint32_t bq[4];
              ldmatrix_x4_trans(bq, cb + np * 16);
#pragma unroll
              for (int oo = 0; oo < NOUT; ++oo) {
                if (oo != o) continue;
                mma_16816(acc[oo][2 * np], ya, bq[0], bq[1]);
                mma_16816(acc[oo][2 * np + 1], ya, bq[2], bq[3]);
              }
            }
          }
        }

        if (kc == nk - 1 && set == n_sets - 1) {
          const int jt = st.jt0 + ti0 + step / nk;
          epi(acc, jt / per_tile, (jt % per_tile) * TN, stage);
#pragma unroll
          for (int o = 0; o < NOUT; ++o)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[o][n][c] = 0.f;
        }
      }
    }
  }
}

// Two CTAs per SM where the accumulators leave room (<= 128 registers).
template <int NOUT>
struct FwdBlocks {
  static constexpr int value = NOUT <= 5 ? 2 : 1;
};

template <int NOUT>
__global__ void __launch_bounds__(THREADS, FwdBlocks<NOUT>::value)
fused_fwd_mma_kernel(Ops<bf16> p, int n_res, int n_cols, int per_cta,
                     const float* __restrict__ hr,
                     const bf16* __restrict__ lr, bf16* __restrict__ err,
                     int h, int w) {
  const Strip st = strip_of(p.blk_r, n_cols, per_cta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this thread's first row and column in the mma C layout: lane l holds
  // rows g, g + 8 and columns 2t, 2t + 1 of each n8 tile
  const int tile_row0 = st.b * p.blk_r + st.r_off;
  const int row0 = tile_row0 + (warp & 3) * 16 + (lane >> 2);
  const bool pairs = w % 2 == 0;  // bf16 pairs 4-byte aligned
  auto epi = [&](float (&acc)[NOUT][4][4], int j, int c_off, char*) {
    const int col0 = j * p.tile_c + c_off + (warp >> 2) * 32 + 2 * (lane & 3);
    if (pairs && tile_row0 + BM <= h && j * p.tile_c + c_off + TN <= w) {
      // a whole tile: each frame's lr loads in flight at once, then the
      // stores
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        __nv_bfloat162 l[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            l[hh][n] = *reinterpret_cast<const __nv_bfloat162*>(
                lr + (static_cast<size_t>(o) * h + row0 + 8 * hh) * w + col0 +
                n * 8);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float2 v = __bfloat1622float2(l[hh][n]);
            *reinterpret_cast<__nv_bfloat162*>(
                err + (static_cast<size_t>(o) * h + row0 + 8 * hh) * w +
                col0 + n * 8) =
                __floats2bfloat162_rn(v.x - acc[o][n][2 * hh],
                                      v.y - acc[o][n][2 * hh + 1]);
          }
      }
      return;
    }
#pragma unroll
    for (int o = 0; o < NOUT; ++o)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= h) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = col0 + n * 8;
          const size_t at = (static_cast<size_t>(o) * h + row) * w + col;
          const float z0 = acc[o][n][2 * hh];
          const float z1 = acc[o][n][2 * hh + 1];
          if (pairs && col + 1 < w) {
            const float2 l = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(lr + at));
            *reinterpret_cast<__nv_bfloat162*>(err + at) =
                __floats2bfloat162_rn(l.x - z0, l.y - z1);
          } else {
            if (col < w)
              err[at] = __float2bfloat16_rn(__bfloat162float(lr[at]) - z0);
            if (col + 1 < w)
              err[at + 1] =
                  __float2bfloat16_rn(__bfloat162float(lr[at + 1]) - z1);
          }
        }
      }
  };
  mma_tiles<float, NOUT, FWD_STAGES, 4>(p, hr, 1, n_res, st, epi);
}

__global__ void __launch_bounds__(THREADS, 2)
fused_bwd_mma_kernel(Ops<bf16> p, int n_res, int n_cols, int per_cta,
                     const bf16* __restrict__ err, int n_src,
                     const float* __restrict__ hr, float* __restrict__ out,
                     int H, int W, float scale, float lo, float hi) {
  const Strip st = strip_of(p.blk_r, n_cols, per_cta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = (warp & 3) * 32 + lane;
  const int tile_row0 = st.b * p.blk_r + st.r_off;
  const int row0 = tile_row0 + (warp & 3) * 16 + (lane >> 2);
  const bool pairs = W % 2 == 0;  // float2 8-byte aligned
  auto epi = [&](float (&acc)[1][8][4], int j, int c_off, char* scratch) {
    // the two warps of a row strip summed alternate groups: the second
    // hands its sums to the first (lane-contiguous, so conflict-free),
    // which adds them and writes the tile
    float* red = reinterpret_cast<float*>(scratch);
    __syncthreads();  // every warp is done with the stage
    if (warp >= 4) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[(n * 4 + c) * 128 + slot] = acc[0][n][c];
    }
    __syncthreads();
    if (warp >= 4) return;
    const int col0 = j * p.tile_c + c_off + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[0][n][c] += red[(n * 4 + c) * 128 + slot];
    // hr + scale * z, rounded after each step as the plain version does
    auto update = [&](float x, float z) {
      return fminf(fmaxf(__fadd_rn(x, __fmul_rn(scale, z)), lo), hi);
    };
    if (pairs && tile_row0 + BM <= H && j * p.tile_c + c_off + TN <= W) {
      // a whole tile: every hr load in flight at once, then the stores
      float2 x[2][8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          x[hh][n] = *reinterpret_cast<const float2*>(
              hr + static_cast<size_t>(row0 + 8 * hh) * W + col0 + n * 8);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(
              out + static_cast<size_t>(row0 + 8 * hh) * W + col0 + n * 8) =
              make_float2(update(x[hh][n].x, acc[0][n][2 * hh]),
                          update(x[hh][n].y, acc[0][n][2 * hh + 1]));
      return;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= H) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + n * 8 + e;
          const size_t at = static_cast<size_t>(row) * W + col;
          if (col < W) out[at] = update(hr[at], acc[0][n][2 * hh + e]);
        }
    }
  };
  mma_tiles<bf16, 1, BWD_STAGES, 8>(p, err, n_src, n_res, st, epi);
}

// ---------------------------------------------------------------------------
// float32 bands, K3: a strip of NT column tiles over one union window
// ---------------------------------------------------------------------------

constexpr int K3_NT = 4;      // tiles per strip (fused_ibp.py K3_STRIP_TILES)
constexpr int K3_UNITS = 4;   // row products formed at once, 64 threads each
constexpr int YS = BM + 4;    // row stride of the k-major operator and ys
constexpr int K3_MAX_STAGES = 4;
constexpr int K3_BOX = KS * TN;  // floats of one column-operator chunk

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ constexpr size_t round128(size_t v) {
  return (v + 127) / 128 * 128;
}

// Shared-memory layout of the f32 K3, byte offsets from the base: the
// resident row operators [res][kr][YS] (k-major, the window padded to 4);
// the row products of one pass [K3_UNITS][KS][YS] (k-major); the ring of
// `stages` stages (128-byte aligned), each the err chunks of `frames`
// frames [frames][kr][KS] then the chunks of `cops` column operators for
// the strip's tiles [cops][nt][KS][TN]; one mbarrier per stage; then each
// resident op's nonzero k range for either half of its rows, and the row
// op, frame and column op of each slot (ints).  `whole`: every row op,
// frame and column op of the plan (res = n_u, frames = n_frames, cops =
// n_c, one set); else one of each, one plan group per set.
struct K3Layout {
  int kr, res, frames, cops, nt, stages, whole;
  size_t ys, ring, bc, stage, bar, tab, total;
};

__host__ __device__ inline K3Layout k3_layout(bool whole, int nt, int stages,
                                              int n_u, int n_frames, int n_c,
                                              int win_r) {
  K3Layout l;
  l.kr = round4(win_r);
  l.whole = whole;
  l.res = whole ? n_u : 1;
  l.frames = whole ? n_frames : 1;
  l.cops = whole ? n_c : 1;
  l.nt = nt;
  l.stages = stages;
  l.ys = sizeof(float) * l.res * l.kr * YS;
  l.ring = round128(l.ys + sizeof(float) * K3_UNITS * KS * YS);
  l.bc = sizeof(float) * l.frames * l.kr * KS;
  l.stage = l.bc + sizeof(float) * l.cops * nt * K3_BOX;
  l.bar = l.ring + stages * l.stage;
  l.tab = l.bar + sizeof(uint64_t) * stages;
  l.total = l.tab + sizeof(int2) * 2 * l.res +
            sizeof(int) * (l.res + l.frames + l.cops);
  return l;
}

// The layout the launch takes: K3_NT tiles per strip where the widest such
// strip's union window `union_w` is at most K3_NT * win_c (else 1), the
// whole plan in one set where that fits (else one plan group per set), the
// deepest ring of 2..K3_MAX_STAGES that fits MAX_SMEM; where no ring fits
// at that many tiles, 1 tile.  stages == 0 if none fits.
// ops/fused_ibp.py _k3_f32_layout mirrors it.
inline K3Layout k3_pick(int union_w, int n_u, int n_frames, int n_c,
                        int win_r, int win_c) {
  const int nt = union_w <= K3_NT * win_c ? K3_NT : 1;
  for (bool whole : {true, false})
    for (int t : {nt, 1})
      for (int s = K3_MAX_STAGES; s >= 2; --s) {
        const K3Layout l =
            k3_layout(whole, t, s, n_u, n_frames, n_c, win_r);
        if (l.total <= static_cast<size_t>(MAX_SMEM)) return l;
      }
  K3Layout none{};
  return none;
}

// The TMA (cp.async.bulk.tensor) and its mbarriers: a tensor map describes
// a global array and a box, one thread asks for the box at some element
// coordinates, the hardware copies it into shared memory (zeros where it
// lies outside the array) and counts its bytes on an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   mma_bf16::smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          mma_bf16::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "K3_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra K3_WAIT_%=;\n"
      "}\n" ::"r"(mma_bf16::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses (and, after a
// barrier, the block's) before its next TMA writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          mma_bf16::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(mma_bf16::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          mma_bf16::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(mma_bf16::smem_addr(bar))
      : "memory");
}

// rows x n floats from src (element offset off0, row stride ss) into dst
// (row stride ds) by cp.async, for packs the TMA cannot describe; rows
// outside [rlo, rhi) and columns >= vcols are zero-filled.  `vec`: 16-byte
// copies (n, vcols and off0 + r * ss multiples of 4, src 16-byte aligned);
// otherwise 4-byte ones.  NTH: the block's threads, which share the copies.
template <int NTH = THREADS>
__device__ __forceinline__ void k3_stage(float* dst, int ds, const float* src,
                                         ptrdiff_t off0, ptrdiff_t ss,
                                         int rows, int n, int rlo, int rhi,
                                         int vcols, bool vec) {
  using namespace mma_bf16;
  if (vec) {
    const int per = n / 4;
    for (int e = threadIdx.x; e < rows * per; e += NTH) {
      const int r = e / per;
      const int c = (e - r * per) * 4;
      const bool in = r >= rlo && r < rhi && c < vcols;
      cp_async16(dst + r * ds + c, in ? src + off0 + r * ss + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * n; e += NTH) {
      const int r = e / n;
      const int c = e - r * n;
      const bool in = r >= rlo && r < rhi && c < vcols;
      cp_async4(dst + r * ds + c, in ? src + off0 + r * ss + c : src,
                in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void cp_async_wait_n(int n) {
  using namespace mma_bf16;
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

// One CUDA block: the 64-row strip r_off of row block b and NT adjacent
// 64-column tiles (fewer at the end of a row).  The strip's union window
// [u0, u1) of err columns runs from the least of its tiles' window starts,
// moved back to a multiple of 4, to the greatest window end.  Chunk outer,
// plan inner: for each 16-column chunk of the union, every group's row
// product bandr[u] @ err[f] is formed once (K3_UNITS groups at a time,
// each by two warps, one per 32-row half, on 4 x 4 register tiles, over
// the k range where the half's rows are nonzero) into ys, and each warp of
// a tile adds ys @ bandc[c] over its TN / WPT columns of the tile for the
// chunks that overlap the tile's own window, unless bandc[c]'s chunk is
// zero in those columns (its rows outside the window land as zeros).
// Thread tile of the column product: 8 rows x 2*NT columns, summed over
// the whole union in registers.  Warp 0 asks the TMA for each chunk
// (tensor maps tm_err [n_frames, h, w] and tm_bc [nt, n_c, win_c, tile_c],
// `tma`); otherwise every thread copies its share by cp.async.  The plan
// is walked in one set (L.whole) or one group at a time, in which case
// each group must list one consumer, as K3's plan does.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
fused_bwd_f32_kernel(Ops<float> p, K3Layout L, int n_cols,
                     const float* __restrict__ err, int n_frames,
                     const float* __restrict__ hr, float* __restrict__ out,
                     int H, int W, float scale, float lo, float hi, int tma,
                     const __grid_constant__ CUtensorMap tm_err,
                     const __grid_constant__ CUtensorMap tm_bc) {
  constexpr int WPT = 8 / NT;          // warps per tile
  constexpr int TC = 2 * NT;           // columns per thread
  constexpr int V = TC < 4 ? TC : 4;   // columns per vector
  constexpr int NV = TC / V;           // vectors per thread row
  extern __shared__ __align__(128) char k3_smem[];
  float* a_s = reinterpret_cast<float*>(k3_smem);
  float* ys_s = reinterpret_cast<float*>(k3_smem + L.ys);
  char* ring = k3_smem + L.ring;
  uint64_t* bars = reinterpret_cast<uint64_t*>(k3_smem + L.bar);
  int2* krange = reinterpret_cast<int2*>(k3_smem + L.tab);  // [res][2]
  int* u_of = reinterpret_cast<int*>(krange + 2 * L.res);   // [res]
  int* f_of = u_of + L.res;                                 // [frames]
  int* c_of = f_of + L.frames;                              // [cops]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Strip st = strip_of(p.blk_r, n_cols, NT);
  const int per_tile = p.tile_c / TN;
  const int row0 = p.sr[st.b];
  const int vrows = min(p.win_r, p.src_rows - row0);
  const size_t plane = static_cast<size_t>(p.src_rows) * p.src_cols;
  const int4* groups = reinterpret_cast<const int4*>(p.groups);

  // the union window, from a multiple of 4 (16 bytes of err), and each
  // tile's window start in it
  int u0 = 1 << 30, u1 = -(1 << 30);
  for (int jx = 0; jx < st.n_tiles; ++jx) {
    const int s = p.sc[(st.jt0 + jx) / per_tile];
    u0 = min(u0, s);
    u1 = max(u1, s + p.win_c);
  }
  u0 = u0 / 4 * 4;
  const int n_chunks = (u1 - u0 + KS - 1) / KS;
  int toff[NT];
#pragma unroll
  for (int jx = 0; jx < NT; ++jx)
    toff[jx] = jx < st.n_tiles ? p.sc[(st.jt0 + jx) / per_tile] - u0 : 0;
  auto overlap = [&](int off, int t) {
    return t * KS < off + p.win_c && t * KS + KS > off;
  };
  auto active = [&](int jx, int t) {
    return jx < st.n_tiles && overlap(toff[jx], t);
  };

  // this thread's tile of the column product
  const int jj = warp / WPT;
  const bool has_tile = jj < st.n_tiles;
  const int jt = st.jt0 + jj;
  const int j = has_tile ? jt / per_tile : 0;
  const int c_off = (jt % per_tile) * TN;
  const int t_off = has_tile ? p.sc[j] - u0 : 0;  // own window in the union
  // a warp of the tile owns its TN / WPT adjacent columns from wcol: lane
  // (rg, cg) rows rg*4..+3 and 32 + rg*4..+3, columns wcol + cg*TC ..
  constexpr int WCOLS = TN / WPT;
  const int wcol = (warp % WPT) * WCOLS;
  const int rg = lane >> 2;
  const int cg = lane & 3;
  // this thread's tile of the row product: unit (a group of the pass),
  // rows half * 32 + rq * 4 .. +3, columns cq * 4 .. +3
  const int unit = warp >> 1;
  const int half = warp & 1;
  const int rq = lane >> 2;
  const int cq = lane & 3;

  const bool x_vec = (reinterpret_cast<uintptr_t>(err) & 15) == 0 &&
                     p.src_cols % 4 == 0;
  const bool bc_vec = (reinterpret_cast<uintptr_t>(p.bandc) & 15) == 0;

  if (tma && tid == 0) {
    for (int i = 0; i < L.stages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tm_err))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tm_bc))
                 : "memory");
  }

  float acc[8][TC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;

  int seq = 0;  // chunks loaded before this set: their stages and phases
  for (int g0 = 0, g1; g0 < p.n_groups; g0 = g1) {
    // the set: the whole plan, its slots the row op, frame and column op
    // indices; or plan group g0 alone, every slot 0
    g1 = L.whole ? p.n_groups : g0 + 1;
    const int s_nu = L.res, s_nf = L.frames, s_nc = L.cops;
    auto slot = [&](int i) { return L.whole ? i : 0; };
    __syncthreads();  // every reader of the previous set is done
    if (tid < 2 * s_nu) krange[tid] = make_int2(L.kr, -1);
    if (tid < s_nu) u_of[tid] = L.whole ? tid : groups[g0].y;
    if (tid < s_nf) f_of[tid] = L.whole ? tid : groups[g0].x;
    if (tid < s_nc) c_of[tid] = L.whole ? tid : p.cons[2 * groups[g0].z];
    __syncthreads();

    // chunk t of every err frame and column operator of the set
    auto load_chunk = [&](int t) {
      const int sq = seq + t;
      char* stage = ring + (sq % L.stages) * L.stage;
      float* bc = reinterpret_cast<float*>(stage + L.bc);
      const int k0 = t * KS;
      const int col = u0 + k0;
      if (tma) {
        // warp 0, one box per lane: every frame's err chunk, then each
        // column operator's chunk for each tile that reads this chunk
        if (warp != 0) return;
        int n_act = 0;
#pragma unroll
        for (int jx = 0; jx < NT; ++jx) n_act += active(jx, t);
        uint64_t* bar = bars + sq % L.stages;
        if (lane == 0)
          mbar_expect_tx(bar, sizeof(float) * (s_nf * L.kr * KS +
                                               n_act * s_nc * K3_BOX));
        for (int i = lane; i < s_nf + n_act * s_nc; i += 32) {
          if (i < s_nf) {
            tma_load_3d(reinterpret_cast<float*>(stage) + i * L.kr * KS,
                        &tm_err, col, row0, f_of[i], bar);
            continue;
          }
          const int s = (i - s_nf) % s_nc;
          int a = (i - s_nf) / s_nc, jx = 0, off = 0;
          for (;; ++jx) {
            off = p.sc[(st.jt0 + jx) / per_tile] - u0;
            if (overlap(off, t) && a-- == 0) break;
          }
          const int jtx = st.jt0 + jx;
          tma_load_4d(bc + (s * NT + jx) * K3_BOX, &tm_bc,
                      (jtx % per_tile) * TN, k0 - off, c_of[s],
                      jtx / per_tile, bar);
        }
        return;
      }
      for (int s = 0; s < s_nf; ++s)
        k3_stage(reinterpret_cast<float*>(stage) + s * L.kr * KS, KS, err,
                 f_of[s] * plane + static_cast<ptrdiff_t>(row0) * p.src_cols +
                     col,
                 p.src_cols, L.kr, KS, 0, vrows, p.src_cols - col, x_vec);
      for (int jx = 0; jx < st.n_tiles; ++jx) {
        const int jtx = st.jt0 + jx;
        const int off = p.sc[jtx / per_tile] - u0;
        if (!overlap(off, t)) continue;  // never read
        for (int s = 0; s < s_nc; ++s)
          k3_stage(bc + (s * NT + jx) * K3_BOX, TN, p.bandc,
                   ((static_cast<ptrdiff_t>(jtx / per_tile) * p.n_c +
                     c_of[s]) * p.win_c + k0 - off) * p.tile_c +
                       (jtx % per_tile) * TN,
                   p.tile_c, KS, TN, off - k0, off + p.win_c - k0, TN,
                   bc_vec);
      }
    };

    if (tma && warp == 0) fence_proxy_async();
#pragma unroll 1
    for (int s = 0; s < L.stages - 1; ++s) {
      if (s < n_chunks) load_chunk(s);
      mma_bf16::cp_async_commit();
    }

    // the set's row operators, resident and k-major for the whole union,
    // by coalesced loads sixteen at a time per thread, and the k range
    // where either half of each one's rows is nonzero; err is finite, so
    // the zeros skipped later add nothing
    for (int s = 0; s < s_nu; ++s) {
      const float* src =
          p.bandr + ((static_cast<size_t>(st.b) * p.n_u + u_of[s]) * p.blk_r +
                     st.r_off) * p.win_r;
      float* dst = a_s + s * L.kr * YS;
      const int n = BM * L.kr;
      int lo0 = L.kr, hi0 = -1, lo1 = L.kr, hi1 = -1;  // rows < 32, >= 32
      for (int e0 = tid; e0 < n; e0 += 16 * THREADS) {
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int e = e0 + i * THREADS;
          const int r = e / L.kr;
          const int k = e - r * L.kr;
          v[i] = e < n && k < p.win_r ? src[r * p.win_r + k] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int e = e0 + i * THREADS;
          if (e >= n) break;
          const int r = e / L.kr;
          const int k = e - r * L.kr;
          dst[k * YS + r] = v[i];
          if (v[i] != 0.f && r < 32) {
            lo0 = min(lo0, k);
            hi0 = max(hi0, k);
          } else if (v[i] != 0.f) {
            lo1 = min(lo1, k);
            hi1 = max(hi1, k);
          }
        }
      }
      lo0 = __reduce_min_sync(0xffffffffu, lo0);
      hi0 = __reduce_max_sync(0xffffffffu, hi0);
      lo1 = __reduce_min_sync(0xffffffffu, lo1);
      hi1 = __reduce_max_sync(0xffffffffu, hi1);
      if (lane == 0) {
        atomicMin(&krange[2 * s].x, lo0);
        atomicMax(&krange[2 * s].y, hi0);
        atomicMin(&krange[2 * s + 1].x, lo1);
        atomicMax(&krange[2 * s + 1].y, hi1);
      }
    }

#pragma unroll 1
    for (int t = 0; t < n_chunks; ++t) {
      const int sq = seq + t;
      if (tma)
        mbar_wait(bars + sq % L.stages, (sq / L.stages) & 1);
      else
        cp_async_wait_n(L.stages - 2);
      // chunk t has landed for every thread, and every thread is done with
      // chunk t - 1, whose stage is refilled next
      __syncthreads();
      if (tma && warp == 0) fence_proxy_async();
      if (t + L.stages - 1 < n_chunks) load_chunk(t + L.stages - 1);
      mma_bf16::cp_async_commit();
      const char* stage = ring + (sq % L.stages) * L.stage;
      const float* xs = reinterpret_cast<const float*>(stage);
      const float* bc = reinterpret_cast<const float*>(stage + L.bc);
      const bool overlaps = has_tile && overlap(t_off, t);
      // the column-op slots whose chunk is nonzero in this warp's columns
      unsigned nz = 0;
      if (overlaps) {
        for (int s = 0; s < s_nc && s < 32; ++s) {
          const float* blk = bc + (s * NT + jj) * K3_BOX + wcol;
          bool any = false;
#pragma unroll
          for (int e = lane; e < KS * WCOLS; e += 32)
            any |= blk[(e / WCOLS) * TN + e % WCOLS] != 0.f;
          if (__any_sync(0xffffffffu, any)) nz |= 1u << s;
        }
      }

#pragma unroll 1
      for (int gp = g0; gp < g1; gp += K3_UNITS) {
        if (gp > g0) __syncthreads();  // the last pass's ys readers are done
        const int gi = gp + unit;
        if (gi < g1) {
          // ys[unit] = bandr[u] @ err[f] over this chunk, this half's rows
          const int4 gr = groups[gi];
          const int us = slot(gr.y);
          const int2 kr = krange[2 * us + half];
          const float* a = a_s + us * L.kr * YS + half * 32 + rq * 4;
          const float* x = xs + slot(gr.x) * L.kr * KS + cq * 4;
          float y[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) y[i][c] = 0.f;
#pragma unroll 2
          for (int k = kr.x / 4 * 4; k <= kr.y; k += 4) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 av =
                  *reinterpret_cast<const float4*>(a + (k + kk) * YS);
              const float4 xv =
                  *reinterpret_cast<const float4*>(x + (k + kk) * KS);
              const float ai[4] = {av.x, av.y, av.z, av.w};
              const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  y[i][c] = fmaf(ai[i], xc[c], y[i][c]);
            }
          }
          float* yo = ys_s + unit * KS * YS + half * 32 + rq * 4;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            *reinterpret_cast<float4*>(yo + (cq * 4 + c) * YS) =
                make_float4(y[0][c], y[1][c], y[2][c], y[3][c]);
        }
        __syncthreads();  // ys ready
        if (!overlaps) continue;
        // acc += ys[k] @ bandc[c] for this warp's columns of its tile
        const int n_units = min(K3_UNITS, g1 - gp);
        for (int k = 0; k < n_units; ++k) {
          const int4 gr = groups[gp + k];
          const float* ya = ys_s + k * KS * YS + rg * 4;
          for (int q = gr.z; q < gr.w; ++q) {
            const int cs = slot(p.cons[2 * q]);
            if (cs < 32 && !(nz >> cs & 1u)) continue;  // adds zeros
            const float* cb =
                bc + (cs * NT + jj) * K3_BOX + wcol + cg * TC;
#pragma unroll
            for (int kc = 0; kc < KS; ++kc) {
              const float4 a0 =
                  *reinterpret_cast<const float4*>(ya + kc * YS);
              const float4 a1 =
                  *reinterpret_cast<const float4*>(ya + kc * YS + 32);
              const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                   a1.x, a1.y, a1.z, a1.w};
              float bv[TC];
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                const float* b = cb + kc * TN + v * V;
                if constexpr (V == 4) {
                  const float4 w4 = *reinterpret_cast<const float4*>(b);
                  bv[4 * v] = w4.x; bv[4 * v + 1] = w4.y;
                  bv[4 * v + 2] = w4.z; bv[4 * v + 3] = w4.w;
                } else {
                  const float2 w2 = *reinterpret_cast<const float2*>(b);
                  bv[2 * v] = w2.x; bv[2 * v + 1] = w2.y;
                }
              }
#pragma unroll
              for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int c = 0; c < TC; ++c)
                  acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
            }
          }
        }
      }
    }
    seq += n_chunks;
  }

  if (!has_tile) return;
  const bool out_vec = V == 4 && W % 4 == 0 &&
                       ((reinterpret_cast<uintptr_t>(hr) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int orow = st.b * p.blk_r + st.r_off;
  const int ocol = j * p.tile_c + c_off + wcol + cg * TC;
  // hr + scale * z, rounded after each step as the plain version does
  auto update = [&](float x, float z) {
    return fminf(fmaxf(__fadd_rn(x, __fmul_rn(scale, z)), lo), hi);
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = orow + (i / 4) * 32 + rg * 4 + i % 4;
    if (row >= H) continue;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = ocol + v * V;
      const size_t at = static_cast<size_t>(row) * W + col;
      if (out_vec && col + 3 < W) {
        const float4 x = *reinterpret_cast<const float4*>(hr + at);
        *reinterpret_cast<float4*>(out + at) =
            make_float4(update(x.x, acc[i][4 * v]),
                        update(x.y, acc[i][4 * v + 1]),
                        update(x.z, acc[i][4 * v + 2]),
                        update(x.w, acc[i][4 * v + 3]));
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (col + c < W) out[at + c] = update(hr[at + c], acc[i][V * v + c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 bands, K2: one 64 x 64 tile per CUDA block, two warps per frame
// ---------------------------------------------------------------------------

// Shared-memory layout of the f32 K2, byte offsets from the base: the
// resident row operators [res][kr][YS] (k-major, the window padded to 4);
// two buffers of one chunk's row products [2][ysn][KS][YS] (k-major); the
// ring of `stages` stages (128-byte aligned), each one step's hr chunk
// [kr][KS] and the chunks of `cops` column operators [cops][KS][TN] of the
// step before; one mbarrier per stage; then each resident op's nonzero k
// range for either half of its rows, the set's terms (row-product slot,
// column-op slot) frame by frame, each resident op's row op and each
// frame's first term.  `whole`: every row op, plan group and column op in
// one set (res = n_u, ysn = n_groups, cops = n_c); else one plan group per
// set (res = ysn = 1, cops = its consumers, at most max_cons).  The host
// picks `whole` and `stages` (ops/fused_ibp.py _k2_f32_layout, the one
// copy of that policy) and passes its byte count, which the launch checks
// against this one.
struct K2Layout {
  int kr, res, ysn, cops, terms, stages, whole;
  size_t ys, ring, stage, bar, tab, total;
};

__host__ __device__ inline K2Layout k2_layout(bool whole, int stages, int n_u,
                                              int n_groups, int n_c,
                                              int max_cons, int win_r) {
  K2Layout l;
  l.kr = round4(win_r);
  l.whole = whole;
  l.res = whole ? n_u : 1;
  l.ysn = whole ? n_groups : 1;
  l.cops = whole ? n_c : max_cons;
  l.terms = whole ? n_groups * max_cons : max_cons;
  l.stages = stages;
  l.ys = sizeof(float) * l.res * l.kr * YS;
  l.ring = round128(l.ys + sizeof(float) * 2 * l.ysn * KS * YS);
  l.stage = sizeof(float) * (l.kr * KS + l.cops * K3_BOX);
  l.bar = l.ring + stages * l.stage;
  l.tab = l.bar + sizeof(uint64_t) * stages;
  l.total = l.tab + sizeof(int2) * (2 * l.res + l.terms) +
            sizeof(int) * (l.res + MAX_OUT + 1);
  return l;
}

// One CUDA block: the 64 x 64 LR output tile of row block b (rows r_off..)
// and column tile j (columns c_off..), every frame; 2 * NOUT warps.  Warps
// 2f and 2f + 1 own frame f's tile, one 32-column half each: lane (rg, cg)
// sums rows rg*4..+3 and 32 + rg*4..+3, columns cg*8..+7 of the half, on
// K1's 8 x 8 register tile.  The tile's column window, from sc[j] moved
// back to a multiple of 4 (16 bytes of hr), is walked in chunks of KS hr
// columns, one step per chunk and one more.  Step s forms every plan
// group's row product bandr[u] @ hr of chunk s into ys[s % 2], each task
// (a group's 32-row half) by one warp on 4 x 4 register tiles over the k
// range where that half of the operator is nonzero; the tasks go first to
// the warps of the SM sub-partitions (warp % 4) that hold fewer of the
// block's warps.  In the same step every warp adds, for each of its
// frame's terms (u, c), ys_u @ bandc[c] of chunk s - 1 from the other
// buffer, unless bandc[c]'s chunk is zero in the warp's columns: the warps
// without a row task do their column products while the others form the
// row products, and one barrier a step separates the two buffers.  Every
// row operator stays resident, k-major; warp 0 asks the TMA for each
// step's hr chunk and column-operator chunks (tensor maps tm_hr [1, H, W]
// and tm_bc [nt, n_c, win_c, tile_c], `tma`), or every thread copies its
// share by cp.async where hr's rows are off 16 bytes; rows and columns
// past hr or the window land as zeros.  The plan is walked in one set
// (L.whole) or one group at a time; the accumulators live across sets.
template <int NOUT>
__global__ void __launch_bounds__(64 * NOUT, 1)
fused_fwd_f32_kernel(Ops<float> p, K2Layout L, const float* __restrict__ hr,
                     const float* __restrict__ lr, float* __restrict__ err,
                     int h, int w, int tma,
                     const __grid_constant__ CUtensorMap tm_hr,
                     const __grid_constant__ CUtensorMap tm_bc) {
  constexpr int NW = 2 * NOUT;
  constexpr int NTH = 32 * NW;
  extern __shared__ __align__(128) char k2_smem[];
  float* a_s = reinterpret_cast<float*>(k2_smem);
  float* ys_s = reinterpret_cast<float*>(k2_smem + L.ys);
  char* ring = k2_smem + L.ring;
  uint64_t* bars = reinterpret_cast<uint64_t*>(k2_smem + L.bar);
  int2* krange = reinterpret_cast<int2*>(k2_smem + L.tab);  // [res][2]
  int2* term = krange + 2 * L.res;                          // [terms]
  int* u_of = reinterpret_cast<int*>(term + L.terms);       // [res]
  int* first = u_of + L.res;                                // [NOUT + 1]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Tile t = tile_of(p.blk_r, p.tile_c);
  const int row0 = p.sr[t.b];
  const int vrows = min(L.kr, p.src_rows - row0);
  const int u0 = p.sc[t.j] / 4 * 4;  // the window from 16 bytes of hr
  const int off = p.sc[t.j] - u0;
  const int n_chunks = (off + p.win_c + KS - 1) / KS;
  const int n_steps = n_chunks + 1;
  const int4* groups = reinterpret_cast<const int4*>(p.groups);

  // this warp's frame and columns; lane (rg, cg) of its 8 x 8 tile, and
  // (rg, cg) = (rows rg*4..+3, columns cg*4..+3) of a row-product task
  const int f = warp >> 1;
  const int wcol = (warp & 1) * 32;
  const int rg = lane >> 2;
  const int cg = lane & 3;
  int rank = 0;  // this warp's place in the order the row tasks are dealt
#pragma unroll
  for (int v = 0; v < NW; ++v) {
    const int nv = (NW - (v & 3) + 3) / 4, nw = (NW - (warp & 3) + 3) / 4;
    rank += nv < nw || (nv == nw && v < warp);
  }

  const bool x_vec = (reinterpret_cast<uintptr_t>(hr) & 15) == 0 &&
                     p.src_cols % 4 == 0;
  const bool bc_vec = (reinterpret_cast<uintptr_t>(p.bandc) & 15) == 0;

  if (tma && tid == 0) {
    for (int i = 0; i < L.stages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tm_hr))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tm_bc))
                 : "memory");
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  int seq = 0;  // steps loaded before this set: their stages and phases
  for (int g0 = 0, g1; g0 < p.n_groups; g0 = g1) {
    g1 = L.whole ? p.n_groups : g0 + 1;
    const int4 gs = groups[g0];
    // column-op slots: every column op, or the consumers of group g0
    const int n_cs = L.whole ? p.n_c : gs.w - gs.z;
    __syncthreads();  // every reader of the previous set is done
    if (tid < 2 * L.res) krange[tid] = make_int2(L.kr, -1);
    if (tid < L.res) u_of[tid] = L.whole ? tid : gs.y;
    if (tid == 0) {
      // the set's terms, frame by frame: (row-product slot, column-op slot)
      int n = 0;
      for (int o = 0; o < NOUT; ++o) {
        first[o] = n;
        for (int g = g0; g < g1; ++g) {
          const int4 gr = groups[g];
          for (int q = gr.z; q < gr.w; ++q)
            if (p.cons[2 * q + 1] == o)
              term[n++] = L.whole ? make_int2(g, p.cons[2 * q])
                                  : make_int2(0, q - gr.z);
        }
      }
      first[NOUT] = n;
    }
    __syncthreads();

    // step s: hr chunk s (s < n_chunks) and every column-op slot's chunk
    // s - 1 (s >= 1) into the stage of step s
    auto load_step = [&](int s) {
      const int sq = seq + s;
      float* xs = reinterpret_cast<float*>(ring + (sq % L.stages) * L.stage);
      float* bc = xs + L.kr * KS;
      const bool has_x = s < n_chunks;
      const bool has_c = s >= 1;
      const int col = u0 + s * KS;          // first hr column of chunk s
      const int kc = (s - 1) * KS - off;    // chunk s - 1's first window row
      if (tma) {
        // warp 0, one box per lane
        if (warp != 0) return;
        uint64_t* bar = bars + sq % L.stages;
        if (lane == 0)
          mbar_expect_tx(bar, sizeof(float) * ((has_x ? L.kr * KS : 0) +
                                               (has_c ? n_cs * K3_BOX : 0)));
        if (has_x && lane == 0) tma_load_3d(xs, &tm_hr, col, row0, 0, bar);
        if (has_c)
          for (int i = lane; i < n_cs; i += 32)
            tma_load_4d(bc + i * K3_BOX, &tm_bc, t.c_off, kc,
                        L.whole ? i : p.cons[2 * (gs.z + i)], t.j, bar);
        return;
      }
      if (has_x)
        k3_stage<NTH>(xs, KS, hr,
                      static_cast<ptrdiff_t>(row0) * p.src_cols + col,
                      p.src_cols, L.kr, KS, 0, vrows, p.src_cols - col,
                      x_vec);
      if (has_c)
        for (int i = 0; i < n_cs; ++i) {
          const int c = L.whole ? i : p.cons[2 * (gs.z + i)];
          k3_stage<NTH>(bc + i * K3_BOX, TN, p.bandc,
                        ((static_cast<ptrdiff_t>(t.j) * p.n_c + c) * p.win_c +
                         kc) * p.tile_c + t.c_off,
                        p.tile_c, KS, TN, -kc, p.win_c - kc, TN, bc_vec);
        }
    };

    if (tma && warp == 0) fence_proxy_async();
#pragma unroll 1
    for (int s = 0; s < L.stages - 1; ++s) {
      if (s < n_steps) load_step(s);
      mma_bf16::cp_async_commit();
    }

    // the set's row operators, resident and k-major, by coalesced loads
    // sixteen at a time per thread, and the k range where either half of
    // each one's rows is nonzero; hr is finite, so the zeros skipped later
    // add nothing
    for (int s = 0; s < L.res; ++s) {
      const float* src =
          p.bandr + ((static_cast<size_t>(t.b) * p.n_u + u_of[s]) * p.blk_r +
                     t.r_off) * p.win_r;
      float* dst = a_s + s * L.kr * YS;
      const int n = BM * L.kr;
      int lo0 = L.kr, hi0 = -1, lo1 = L.kr, hi1 = -1;  // rows < 32, >= 32
      for (int e0 = tid; e0 < n; e0 += 16 * NTH) {
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int e = e0 + i * NTH;
          const int r = e / L.kr;
          const int k = e - r * L.kr;
          v[i] = e < n && k < p.win_r ? src[r * p.win_r + k] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int e = e0 + i * NTH;
          if (e >= n) break;
          const int r = e / L.kr;
          const int k = e - r * L.kr;
          dst[k * YS + r] = v[i];
          if (v[i] != 0.f && r < 32) {
            lo0 = min(lo0, k);
            hi0 = max(hi0, k);
          } else if (v[i] != 0.f) {
            lo1 = min(lo1, k);
            hi1 = max(hi1, k);
          }
        }
      }
      lo0 = __reduce_min_sync(0xffffffffu, lo0);
      hi0 = __reduce_max_sync(0xffffffffu, hi0);
      lo1 = __reduce_min_sync(0xffffffffu, lo1);
      hi1 = __reduce_max_sync(0xffffffffu, hi1);
      if (lane == 0) {
        atomicMin(&krange[2 * s].x, lo0);
        atomicMax(&krange[2 * s].y, hi0);
        atomicMin(&krange[2 * s + 1].x, lo1);
        atomicMax(&krange[2 * s + 1].y, hi1);
      }
    }

    const int n_tasks = 2 * (g1 - g0);
#pragma unroll 1
    for (int s = 0; s < n_steps; ++s) {
      const int sq = seq + s;
      if (tma)
        mbar_wait(bars + sq % L.stages, (sq / L.stages) & 1);
      else
        cp_async_wait_n(L.stages - 2);
      // step s has landed for every thread, and every thread is done with
      // step s - 1: its stage is refilled next, and the row products of
      // chunk s go where those of chunk s - 2 were read
      __syncthreads();
      if (tma && warp == 0) fence_proxy_async();
      if (s + L.stages - 1 < n_steps) load_step(s + L.stages - 1);
      mma_bf16::cp_async_commit();
      const float* xs =
          reinterpret_cast<const float*>(ring + (sq % L.stages) * L.stage);
      const float* bc = xs + L.kr * KS;

      if (s < n_chunks) {
        // ys[s % 2][slot] = bandr[u] @ hr over chunk s, one half's rows
        float* yb = ys_s + (s & 1) * L.ysn * KS * YS;
#pragma unroll 1
        for (int task = rank; task < n_tasks; task += NW) {
          const int gi = task >> 1;
          const int half = task & 1;
          const int us = L.whole ? groups[g0 + gi].y : 0;
          const int2 kr = krange[2 * us + half];
          const float* a = a_s + us * L.kr * YS + half * 32 + rg * 4;
          const float* x = xs + cg * 4;
          float y[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) y[i][c] = 0.f;
#pragma unroll 2
          for (int k = kr.x / 4 * 4; k <= kr.y; k += 4) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 av =
                  *reinterpret_cast<const float4*>(a + (k + kk) * YS);
              const float4 xv =
                  *reinterpret_cast<const float4*>(x + (k + kk) * KS);
              const float ai[4] = {av.x, av.y, av.z, av.w};
              const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  y[i][c] = fmaf(ai[i], xc[c], y[i][c]);
            }
          }
          float* yo = yb + gi * KS * YS + half * 32 + rg * 4;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            *reinterpret_cast<float4*>(yo + (cg * 4 + c) * YS) =
                make_float4(y[0][c], y[1][c], y[2][c], y[3][c]);
        }
      }

      if (s >= 1) {
        // acc += ys[(s - 1) % 2][slot] @ bandc[c] of chunk s - 1, for each
        // of this frame's terms, on this warp's 32 columns
        const float* yb = ys_s + ((s - 1) & 1) * L.ysn * KS * YS;
#pragma unroll 1
        for (int i = first[f]; i < first[f + 1]; ++i) {
          const int2 tm = term[i];
          const float* cb = bc + tm.y * K3_BOX + wcol;
          bool any = false;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = lane + 32 * r;  // float4 e of the 16 x 32 block
            const float4 v =
                *reinterpret_cast<const float4*>(cb + (e >> 3) * TN +
                                                 (e & 7) * 4);
            any |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
          }
          if (!__any_sync(0xffffffffu, any)) continue;  // adds zeros
          const float* ya = yb + tm.x * KS * YS + rg * 4;
          cb += cg * 8;
#pragma unroll
          for (int kc = 0; kc < KS; ++kc) {
            const float4 a0 = *reinterpret_cast<const float4*>(ya + kc * YS);
            const float4 a1 =
                *reinterpret_cast<const float4*>(ya + kc * YS + 32);
            const float4 b0 = *reinterpret_cast<const float4*>(cb + kc * TN);
            const float4 b1 =
                *reinterpret_cast<const float4*>(cb + kc * TN + 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int c = 0; c < 8; ++c)
                acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
          }
        }
      }
    }
    seq += n_steps;
  }

  // err = lr - z over the lane's 8 x 8 tile
  const int orow = t.b * p.blk_r + t.r_off;
  const int ocol = t.j * p.tile_c + t.c_off + wcol + cg * 8;
  const size_t plane = static_cast<size_t>(h) * w;
  const bool vec = w % 4 == 0 && ((reinterpret_cast<uintptr_t>(lr) |
                                   reinterpret_cast<uintptr_t>(err)) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = orow + (i / 4) * 32 + rg * 4 + i % 4;
    if (row >= h) continue;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = ocol + 4 * v;
      const size_t at = f * plane + static_cast<size_t>(row) * w + col;
      if (vec && col + 3 < w) {
        const float4 l = *reinterpret_cast<const float4*>(lr + at);
        *reinterpret_cast<float4*>(err + at) =
            make_float4(l.x - acc[i][4 * v], l.y - acc[i][4 * v + 1],
                        l.z - acc[i][4 * v + 2], l.w - acc[i][4 * v + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < w) err[at + c] = lr[at + c] - acc[i][4 * v + c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename BandT>
int check(const Ops<BandT>& p, int nb, int nt, size_t smem, dim3* grid) {
  if (nb <= 0 || nt <= 0 || p.n_u <= 0 || p.n_c <= 0 || p.win_r <= 0 ||
      p.win_c <= 0 || p.blk_r <= 0 || p.tile_c <= 0 || p.blk_r % BM != 0 ||
      p.tile_c % TN != 0 || p.n_groups <= 0 || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(nt * (p.tile_c / TN), nb * (p.blk_r / BM), 1);
  if (grid->y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename Kernel, typename... Args>
int launch_n(Kernel kernel, dim3 grid, int threads, size_t smem,
             cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);

  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
           Args... args) {
  return launch_n(kernel, grid, THREADS, smem, s, args...);
}

// bf16: grid.x counts CUDA blocks of FWD_TILES tiles
template <int NOUT>
int launch_fwd(const Ops<bf16>& p, int n_res, dim3 grid, size_t smem,
               cudaStream_t s, const float* hr, const void* lr, void* err,
               int h, int w) {
  const int n_cols = static_cast<int>(grid.x);
  grid.x = (n_cols + FWD_TILES - 1) / FWD_TILES;
  return launch(fused_fwd_mma_kernel<NOUT>, grid, smem, s, p, n_res, n_cols,
                FWD_TILES, hr,
                static_cast<const bf16*>(lr), static_cast<bf16*>(err), h, w);
}

int fwd(const Ops<bf16>& p, int nb, int nt, const float* hr, const void* lr,
        void* err, int n_frames, int h, int w, cudaStream_t s) {
  const int n_res = resident_ops(p.n_u, p.win_r, p.n_c, 1, true, FWD_STAGES);
  if (n_res == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(n_res, p.win_r, p.n_c, 1, true, FWD_STAGES).total;
  dim3 grid;
  const int rc = check(p, nb, nt, smem, &grid);
  if (rc != 0) return rc;
  switch (n_frames) {
    case 1: return launch_fwd<1>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 2: return launch_fwd<2>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 3: return launch_fwd<3>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 4: return launch_fwd<4>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 5: return launch_fwd<5>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 6: return launch_fwd<6>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 7: return launch_fwd<7>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case MAX_OUT:
      return launch_fwd<MAX_OUT>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The driver's cuTensorMapEncodeTiled, through the runtime; null where the
// driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &found);
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A float32 tensor map of `rank` dims (innermost first, densely strided)
// and box: 1 when built, 0 where the TMA cannot describe the array (a base
// not 16-byte aligned, a row not a multiple of 16 bytes, a box edge over
// 256), -1 where the driver gives no encoder or refuses the map.
int tensor_map(CUtensorMap* m, const void* base, int rank,
               const cuuint64_t* dims, const cuuint32_t* box) {
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0) return 0;
  cuuint64_t strides[4];
  cuuint64_t stride = sizeof(float);
  for (int i = 0; i < rank; ++i) {
    if (box[i] == 0 || box[i] > 256) return 0;
    if (i + 1 == rank) break;
    stride *= dims[i];
    if (stride % 16 != 0) return 0;
    strides[i] = stride;
  }
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (fn == nullptr ||
      fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -1;
  return 1;
}

template <int NOUT>
int launch_fwd_f32(const Ops<float>& p, const K2Layout& L, dim3 grid,
                   cudaStream_t s, const float* hr, const float* lr,
                   float* err, int h, int w, int tma,
                   const CUtensorMap& tm_hr, const CUtensorMap& tm_bc) {
  return launch_n(fused_fwd_f32_kernel<NOUT>, grid, 64 * NOUT, L.total, s, p,
                  L, hr, lr, err, h, w, tma, tm_hr, tm_bc);
}

// f32: the host's layout (whole, stages, smem bytes), two warps per frame;
// refused unless k2_layout gives the same bytes and they fit.  hr rows the
// TMA cannot describe come by cp.async.
int fwd(const Ops<float>& p, int nb, int nt, const float* hr, const void* lr,
        void* err, int n_frames, int h, int w, int max_cons, int whole,
        int stages, size_t smem, cudaStream_t s) {
  if (n_frames <= 0 || max_cons <= 0 || stages < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const K2Layout L = k2_layout(whole != 0, stages, p.n_u, p.n_groups, p.n_c,
                               max_cons, p.win_r);
  if (L.total != smem || L.total > static_cast<size_t>(MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  const int rc = check(p, nb, nt, L.total, &grid);
  if (rc != 0) return rc;
  // hr [1, H, W] in boxes of [kr][KS], bandc [nt, n_c, win_c, tile_c] in
  // boxes of [KS][TN]
  CUtensorMap tm_hr{}, tm_bc{};
  const cuuint64_t hr_dims[3] = {static_cast<cuuint64_t>(p.src_cols),
                                 static_cast<cuuint64_t>(p.src_rows), 1};
  const cuuint32_t hr_box[3] = {KS, static_cast<cuuint32_t>(L.kr), 1};
  const cuuint64_t bc_dims[4] = {static_cast<cuuint64_t>(p.tile_c),
                                 static_cast<cuuint64_t>(p.win_c),
                                 static_cast<cuuint64_t>(p.n_c),
                                 static_cast<cuuint64_t>(nt)};
  const cuuint32_t bc_box[4] = {TN, KS, 1, 1};
  int tma = tensor_map(&tm_hr, hr, 3, hr_dims, hr_box);
  if (tma == 1) tma = tensor_map(&tm_bc, p.bandc, 4, bc_dims, bc_box);
  if (tma < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lr);
  float* e = static_cast<float*>(err);
  switch (n_frames) {
    case 1: return launch_fwd_f32<1>(p, L, grid, s, hr, l, e, h, w, tma, tm_hr, tm_bc);
    case 2: return launch_fwd_f32<2>(p, L, grid, s, hr, l, e, h, w, tma, tm_hr, tm_bc);
    case 3: return launch_fwd_f32<3>(p, L, grid, s, hr, l, e, h, w, tma, tm_hr, tm_bc);
    case 4: return launch_fwd_f32<4>(p, L, grid, s, hr, l, e, h, w, tma, tm_hr, tm_bc);
    case 5: return launch_fwd_f32<5>(p, L, grid, s, hr, l, e, h, w, tma, tm_hr, tm_bc);
    case 6: return launch_fwd_f32<6>(p, L, grid, s, hr, l, e, h, w, tma, tm_hr, tm_bc);
    case 7: return launch_fwd_f32<7>(p, L, grid, s, hr, l, e, h, w, tma, tm_hr, tm_bc);
    case MAX_OUT:
      return launch_fwd_f32<MAX_OUT>(p, L, grid, s, hr, l, e, h, w, tma, tm_hr,
                                     tm_bc);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32: K3_NT adjacent 64-column tiles per CUDA block where the widest
// strip's union window union_w allows (k3_pick).  Err rows the TMA cannot
// describe come by cp.async.
int bwd(const Ops<float>& p, int nb, int nt, const void* err, int n_frames,
        const float* hr, float* out, int H, int W, float scale, float lo,
        float hi, int union_w, cudaStream_t s) {
  if (n_frames <= 0 || union_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const K3Layout L =
      k3_pick(union_w, p.n_u, n_frames, p.n_c, p.win_r, p.win_c);
  if (L.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  const int rc = check(p, nb, nt, L.total, &grid);
  if (rc != 0) return rc;
  const int n_cols = static_cast<int>(grid.x);
  grid.x = (n_cols + L.nt - 1) / L.nt;
  const float* e = static_cast<const float*>(err);
  // err [n_frames, h, w] in boxes of [kr][KS], bandc [nt, n_c, win_c,
  // tile_c] in boxes of [KS][TN]
  CUtensorMap tm_err{}, tm_bc{};
  const cuuint64_t err_dims[3] = {static_cast<cuuint64_t>(p.src_cols),
                                  static_cast<cuuint64_t>(p.src_rows),
                                  static_cast<cuuint64_t>(n_frames)};
  const cuuint32_t err_box[3] = {KS, static_cast<cuuint32_t>(L.kr), 1};
  const cuuint64_t bc_dims[4] = {static_cast<cuuint64_t>(p.tile_c),
                                 static_cast<cuuint64_t>(p.win_c),
                                 static_cast<cuuint64_t>(p.n_c),
                                 static_cast<cuuint64_t>(nt)};
  const cuuint32_t bc_box[4] = {TN, KS, 1, 1};
  int tma = tensor_map(&tm_err, e, 3, err_dims, err_box);
  if (tma == 1) tma = tensor_map(&tm_bc, p.bandc, 4, bc_dims, bc_box);
  if (tma < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L.nt == K3_NT)
    return launch(fused_bwd_f32_kernel<K3_NT>, grid, L.total, s, p, L,
                  n_cols, e, n_frames, hr, out, H, W, scale, lo, hi, tma,
                  tm_err, tm_bc);
  return launch(fused_bwd_f32_kernel<1>, grid, L.total, s, p, L, n_cols, e,
                n_frames, hr, out, H, W, scale, lo, hi, tma, tm_err, tm_bc);
}

int bwd(const Ops<bf16>& p, int nb, int nt, const void* err, int n_frames,
        const float* hr, float* out, int H, int W, float scale, float lo,
        float hi, int, cudaStream_t s) {
  const int n_res =
      n_frames > 0
          ? resident_ops(p.n_u, p.win_r, p.n_c, n_frames, false, BWD_STAGES)
          : 0;
  if (n_res == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      layout(n_res, p.win_r, p.n_c, n_frames, false, BWD_STAGES).total;
  dim3 grid;
  const int rc = check(p, nb, nt, smem, &grid);
  if (rc != 0) return rc;
  const int n_cols = static_cast<int>(grid.x);
  grid.x = (n_cols + BWD_TILES - 1) / BWD_TILES;
  return launch(fused_bwd_mma_kernel, grid, smem, s, p, n_res, n_cols,
                BWD_TILES, static_cast<const bf16*>(err), n_frames, hr, out, H, W, scale,
                lo, hi);
}

template <typename BandT>
Ops<BandT> ops(const void* bandr, const int* sr, int n_u, int blk_r,
               int win_r, const void* bandc, const int* sc, int n_c,
               int win_c, int tile_c, const int* groups, int n_groups,
               const int* cons, int src_rows, int src_cols) {
  return {static_cast<const BandT*>(bandr), sr, static_cast<const BandT*>(bandc),
          sc, n_u, blk_r, win_r, n_c, win_c, tile_c, groups, cons, n_groups,
          src_rows, src_cols};
}

}  // namespace

// K2 on `stream`.  `bf16` selects the band type, which is also the type of
// lr [n_frames, h, w] and err (same shape); hr [H, W] is float32.  The row
// pack's sr/bandr hold nb blocks of blk_r rows, the column pack's sc/bandc
// nt tiles of tile_c columns.  float32 bands: max_cons, the most consumers
// of one plan group, and the layout the host picked, whole (the plan in
// one set, else one group per set), stages and its smem bytes (the bf16
// kernel ignores the four).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for operands it does not take.
extern "C" int fused_fwd_launch(int bf16, const void* bandr, const int* sr,
                                int nb, int n_u, int blk_r, int win_r,
                                const void* bandc, const int* sc, int nt,
                                int n_c, int win_c, int tile_c,
                                const int* groups, int n_groups,
                                const int* cons, const float* hr, int H,
                                int W, const void* lr, void* err,
                                int n_frames, int h, int w, int max_cons,
                                int whole, int stages, size_t smem,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fwd(ops<__nv_bfloat16>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c,
                                  win_c, tile_c, groups, n_groups, cons, H, W),
               nb, nt, hr, lr, err, n_frames, h, w, s);
  return fwd(ops<float>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c, win_c,
                        tile_c, groups, n_groups, cons, H, W),
             nb, nt, hr, lr, err, n_frames, h, w, max_cons, whole, stages,
             smem, s);
}

// K3 on `stream`: err [n_frames, h, w] of the band type, hr and out [H, W]
// float32, out = clip(hr + scale * z, lo, hi).  Same packs and return code
// as fused_fwd_launch; the plan lists one consumer per group
// (FusedIBP.plan("bwd")).  float32 bands: union_w is the widest union
// window of a strip of K3_NT column tiles (the bf16 kernel walks BWD_TILES
// and ignores it).
extern "C" int fused_bwd_launch(int bf16, const void* bandr, const int* sr,
                                int nb, int n_u, int blk_r, int win_r,
                                const void* bandc, const int* sc, int nt,
                                int n_c, int win_c, int tile_c,
                                const int* groups, int n_groups,
                                const int* cons, const void* err,
                                int n_frames, int h, int w, const float* hr,
                                float* out, int H, int W, float scale,
                                float lo, float hi, int union_w,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bwd(ops<__nv_bfloat16>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c,
                                  win_c, tile_c, groups, n_groups, cons, h, w),
               nb, nt, err, n_frames, hr, out, H, W, scale, lo, hi,
               union_w, s);
  return bwd(ops<float>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c, win_c,
                        tile_c, groups, n_groups, cons, h, w),
             nb, nt, err, n_frames, hr, out, H, W, scale, lo, hi, union_w,
             s);
}
