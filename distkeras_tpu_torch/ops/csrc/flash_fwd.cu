// Flash-attention forward for Hopper (sm_90a): both products on the
// tensor cores, K / V streamed through an asynchronous ring.
//
// Replaces: distkeras_tpu/ops/attention.py::_flash_kernel (launcher
// _flash_pallas).  Same function: logits = q . k^T * scale in f32, masked
// with the finite NEG_INF (-1e30) for causal / sliding-window pairs and
// for pairs in different segments (packed documents, int32 segment ids
// [B, L] indexed by batch row), -inf past the ragged edge, online softmax
// over KV tiles with m / l / acc in f32, and O = acc / l with the
// `l == 0` guard.  The training variant also writes the per-row lse =
// m + log l (f32 [B, H, Lq], the `l == 0` guard again, NEG_INF kept for a
// fully masked row) that the backward kernels (flash_bwd.cu) rebuild the
// probabilities from; the inference launch passes no lse buffer and
// writes none.  The segment mask is a template switch, so the
// unsegmented launch carries no extra work.
//
// Translation of the TPU kernel:
// - The Pallas grid's sequential kv dimension (state carried in VMEM
//   scratch across grid steps) becomes a loop inside one CUDA block: the
//   m / l / acc state stays in registers for the whole KV sweep.
// - Causal runs stop at the diagonal tile, and a window starts at the
//   first tile inside the lookback (the counterpart of the banded grid,
//   _banded_kv), so K/V traffic stays O(window).
// - Tiles are the port's own (128 q rows per block; 64 kv rows in f32,
//   128 in bf16), not the TPU's 1024; the ragged edge is masked here.
// - Inputs keep the public [B, L, H, D] layout; the kernel takes the
//   b / l / h strides (unit stride on D), so no transpose copy is made.
//
// What bounds it on this card: 4 D FLOPs per live (query, key) pair
// against q / k / v read once and O written once.  At the training shape
// ([8, 1024, 8, 128], causal, f32) that is 17.2 GFLOP, bound by the
// tensor cores at the 3xTF32 rate (495 / 3 TFLOP/s: 0.104 ms); at the
// serving prefill ([8, 512, 8, 128], causal, bf16) 4.3 GFLOP against
// 33.6 MB, bound by HBM (0.010 ms) with the bf16 tensor cores (0.004 ms)
// close behind.
//
// Design:
// - Grid x is batch * head and y the q tile, walked from the last: the
//   causal blocks with the most live tiles start in the first wave and
//   the last wave holds short ones.
// - The softmax runs in registers on the S accumulators (rows spread over
//   the four threads of a quad): the running max m is kept over the raw
//   logits (scale > 0), so p = 2^(s * scale * log2 e - m * scale * log2 e)
//   is one FFMA and one ex2.approx per logit; a row that has seen only
//   masked logits (m = NEG_INF) takes p = 1 for them, as the reference's
//   exp(NEG_INF - NEG_INF).  P is then reused from registers as the A
//   operand of P . V: it never touches shared memory.
// - K / V stream through 2-stage rings with one barrier per tile: the
//   copies of the next tile are issued right after it, before the
//   products.  f32 fills its ring by cp.async, 16-byte copies (the ragged
//   edge zero-filled through cp.async's src-size operand); bf16 by TMA,
//   one thread issuing 64-column boxes that land 128-byte-swizzled, as
//   wgmma reads them, and complete on an mbarrier per stage.  Either
//   needs every q / k / v base 16-byte aligned and its b / l / h strides
//   whole 16-byte chunks; other views are loaded element by element into
//   the same layout.  Segment ids go by 4-byte cp.async.
// - O leaves in wide stores: f32 as column pairs of 8 bytes, bf16 staged
//   through shared memory and written in 16-byte row pieces.  Scattered
//   2-byte stores had cost a quarter of the bf16 kernel.
// - f32 (training): 8 warps of 16 q rows each over the full 64 columns of
//   a kv tile, both products as m16n8k8 tf32 mma.sync with 3xTF32 error
//   compensation (flash_common.cuh; Q's fragments read and split from
//   shared memory per k-step).  Q (128 rows) and the ring take 198.5 KiB
//   at D = 128: one block of 8 warps per SM.  A warp skips a tile that
//   lies wholly past its rows' diagonal or before their window (its p
//   would be exactly 0, or wiped by the correction once the row's first
//   live logit arrives).  A tf32 wgmma would need V K-major, which it is
//   not, so f32 stays on mma.sync.
// - bf16 (serving, bf16 training): two consumer warpgroups of 64 q rows
//   per block on wgmma, sharing 128-row K / V tiles.  S = Q . K^T is
//   m64n128k16 with both operands read by matrix descriptors from
//   128-byte-swizzled shared tiles (K-major as stored); O += P . V is
//   m64n{D}k16 with P converted to bf16 in registers as the A operand and
//   V read MN-major through the transpose bit.  Q, K and V use one
//   swizzled layout.  The sweep is pipelined by one tile:
//   S of tile j is issued with P . V of tile j - 1, and the softmax of
//   tile j runs while P . V still does; K runs one tile ahead of V in
//   their rings.  162 KiB and 221-241 registers per thread at D = 128:
//   one block of 8 warps per SM.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; kernel_inturns.py and
// chip_smoke.py, PERF.md): at [8, 1024, 8, 128] causal the f32 forward
// with lse takes 0.365 ms (the FMA version 1.27 ms, SDPA 0.91, bound
// 0.104) and bf16 0.062 ms (mma.sync with synchronous loads 0.177, SDPA
// 0.126); the serving prefill launch (bf16, [8, 512, 8, 128], causal)
// 0.023 ms (0.062; bound 0.010).  f32 stays issue-bound on the 3xTF32
// operand splits at one block of 8 warps per SM, as the backward does.

#include "flash_common.cuh"

#include <cudaTypedefs.h>

namespace {

constexpr int BN = 64;      // kv rows per tile
constexpr int STAGES = 2;   // ring depth of the K / V tiles

// Live kv tiles [lo, hi) of width BW of the q rows [row0, row0 + rows):
// causal stops at the diagonal; a window starts at the first tile reaching
// the lookback of the first row.
template <int BW>
__device__ __forceinline__ void tile_range(int row0, int rows, int Lq, int Lk, int causal,
                                           int window, int& lo, int& hi) {
  const int n_tiles = (Lk + BW - 1) / BW;
  lo = 0;
  hi = n_tiles;
  if (causal) {
    const int last_row = min(row0 + rows, Lq) - 1;
    hi = min(n_tiles, last_row / BW + 1);
    if (window > 0) lo = max(0, row0 - window + 1) / BW;
  }
}

// One online-softmax step of this thread's rows ra, ra + 8 over a tile of
// 8 NJ columns of raw logits s in the mma accumulator layout (s[j][e]: row
// ra + 8 (e >> 1), column col0 + 8j + 2t + (e & 1)): masks s, moves the
// row maxima m (raw logits), rescales l, and leaves p = 2^((s - m) * sl) in
// s (sl = scale * log2 e) and in corr the factor the O accumulator of each
// row still has to be rescaled by (rescale()).
template <int NJ, bool SEG>
__device__ __forceinline__ void softmax_step(float (&s)[NJ][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int ra, int col0, int Lk,
                                             int causal, int window, const int (&segq)[2],
                                             const int* segk, float sl) {
  const int t = threadIdx.x & 3;
  // col0 < Lk, so every row of the tile has a finite logit.
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, cl = j * 8 + 2 * t + (e & 1);
      s[j][e] = masked(s[j][e], ra + 8 * i, col0 + cl, Lk, causal, window,
                       SEG && segq[i] != segk[cl]);
      mx[i] = fmaxf(mx[i], s[j][e]);
    }
  float a[2], c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = exp2_fast((m[i] - m_new) * sl);
    m[i] = m_new;
    l[i] *= corr[i];
    // p = 2^(s * a + c): a row with no live logit yet (m = NEG_INF) takes
    // p = 1 for its NEG_INF logits (and 0 past the ragged edge).
    const bool dead = m_new == NEG_INF;
    a[i] = dead ? 1.f : sl;
    c[i] = dead ? -NEG_INF : -m_new * sl;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j][e] = exp2_fast(fmaf(s[j][e], a[i], c[i]));
      l[i] += s[j][e];
    }
}

template <int NT>
__device__ __forceinline__ void rescale(float (&acc)[NT][4], const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }
}

// The end of the sweep for rows ra, ra + 8: l summed over the quad, lse =
// m * scale + log l into lse_row (null: none; NEG_INF kept for a row with
// no live logit), and inv = 1 / l with the reference's l == 0 guard.
__device__ __forceinline__ void finish_rows(float (&l)[2], const float (&m)[2], float* lse_row,
                                            int ra, int Lq, float scale, float (&inv)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = l[i] == 0.f ? 1.f : l[i];
    const int r = ra + 8 * i;
    if (lse_row != nullptr && t == 0 && r < Lq)
      lse_row[r] = (m[i] == NEG_INF ? NEG_INF : m[i] * scale) + logf(denom);
    inv[i] = 1.f / denom;
  }
}

// ------------------------------------------------ f32: 3xTF32 mma.sync

constexpr int F32_ROWS = 128;     // q rows per block: 8 warps x 16
constexpr int F32_THREADS = 256;
constexpr int F32_NJ = BN / 8;    // n-tiles of S per warp: the whole kv tile

template <int D> struct F32Smem {
  // Q (two Tiles); STAGES x (K, V); STAGES x kv segment ids.
  static constexpr size_t bytes =
      sizeof(float) * (F32_ROWS / 64 + 2 * STAGES) * Tile<float, D>::ELEMS +
      sizeof(int) * STAGES * BN;
};

template <int D, bool SEG>
__global__ void __launch_bounds__(F32_THREADS, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ seg, int H, int Lq, int Lk, Strides sq, Strides sk,
                     Strides sv, Strides so, float scale, int causal, int window, int vec) {
  constexpr int NT = D / 8, EL = Tile<float, D>::ELEMS, QT = F32_ROWS / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* KVs = Qs + QT * EL;  // stage s: K at KVs + 2s EL, V at KVs + (2s + 1) EL
  int* segk_s = reinterpret_cast<int*>(KVs + 2 * STAGES * EL);  // [STAGES][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * F32_ROWS;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int* segb = SEG ? seg + static_cast<long long>(b) * Lq : nullptr;
  int lo, hi;
  tile_range<BN>(row0, F32_ROWS, Lq, Lk, causal, window, lo, hi);
  auto load_stage = [&](int tile) {
    const int s = (tile - lo) % STAGES, c0 = tile * BN;
    load_tile<float, D, F32_THREADS>(KVs + 2 * s * EL, kb, sk.l, c0, Lk, vec);
    load_tile<float, D, F32_THREADS>(KVs + (2 * s + 1) * EL, vb, sv.l, c0, Lk, vec);
    if (SEG) load_vec<F32_THREADS>(segk_s + s * BN, segb, c0, Lk);
  };

  // Q joins the first group of copies.
#pragma unroll
  for (int i = 0; i < QT; ++i)
    load_tile<float, D, F32_THREADS>(Qs + i * EL, q + b * sq.b + h * sq.h, sq.l, row0 + 64 * i,
                                     Lq, vec);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (lo + i < hi) load_stage(lo + i);
    cp_async_commit();
  }

  // This warp's rows [wr, wr + 16); this thread's rows ra, ra + 8.
  const int wr = row0 + warp * 16, ra = wr + (lane >> 2);
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) segq[i] = SEG && ra + 8 * i < Lq ? segb[ra + 8 * i] : -1;
  const float sl = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = lo; tile < hi; ++tile) {
    // Tile `tile` has landed for every thread, and every thread is done
    // with the stage refilled next (it held tile - 1).
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (tile + STAGES - 1 < hi) load_stage(tile + STAGES - 1);
    cp_async_commit();

    const int s = (tile - lo) % STAGES, col0 = tile * BN;
    if (causal && (col0 > wr + 15 || (window > 0 && wr - (col0 + BN - 1) >= window))) continue;
    const float* Ks = KVs + 2 * s * EL;
    float sc[F32_NJ][4];
#pragma unroll
    for (int j = 0; j < F32_NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    mma_rows<float, D, F32_NJ>(sc, Qs, warp * 16, Ks, 0);
    float corr[2];
    softmax_step<F32_NJ, SEG>(sc, m, l, corr, ra, col0, Lk, causal, window, segq, segk_s + s * BN,
                              sl);
    rescale(acc, corr);
    mma_acc_rows<float, D, F32_NJ>(acc, sc, Ks + EL, 0);
  }
  cp_async_wait<0>();

  // O = acc / l, each column pair in one 8-byte store (out is the
  // wrapper's contiguous tensor, so pairs are aligned).
  float inv[2];
  finish_rows(l, m, lse == nullptr ? nullptr : lse + static_cast<long long>(bh) * Lq, ra, Lq,
              scale, inv);
  float* ob = o + b * so.b + h * so.h;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (r >= Lq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(ob + r * so.l + n * 8 + 2 * t) =
          make_float2(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
  }
}

// ------------------------------------------------------- bf16: wgmma

constexpr int WGS = 2;                 // consumer warpgroups per block, 64 q rows each
constexpr int WG_ROWS = 64 * WGS;      // q rows per block
constexpr int WG_THREADS = 128 * WGS;
constexpr int WG_BN = 128;             // kv rows per tile (wgmma_ss_n128)
constexpr int WG_NJ = WG_BN / 8;       // n-tiles of S

// A ROWS-row bf16 tile of D columns in the layout wgmma reads with
// 128-byte swizzling: D / 64 panels of ROWS rows x 128 bytes; row r of a
// panel at r * 128 bytes, its 16-byte chunk c at chunk c ^ (r % 8).  The
// swizzle acts on address bits, so every tile starts 1024-byte aligned.
template <int ROWS, int D> struct SwTile {
  static constexpr int PANEL = ROWS * 128;
  static constexpr int BYTES = ROWS * D * 2;
};

// Rows [row0, row0 + ROWS) of a [L, D] bf16 slice (row stride ld) into a
// swizzled tile by element loads (strides TMA cannot take); rows at or
// past L are zero.
template <int ROWS, int D>
__device__ __forceinline__ void load_sw_tile(unsigned char* dst, const bf16* src, long long ld,
                                             int row0, int L) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += WG_THREADS) {
    const int r = e / CH, c = e % CH, gr = row0 + r;
    bf16* p = reinterpret_cast<bf16*>(dst + (c >> 3) * SwTile<ROWS, D>::PANEL + r * 128 +
                                      (((c & 7) ^ (r & 7)) << 4));
#pragma unroll
    for (int i = 0; i < 8; ++i) store(p + i, gr < L ? to_f32(src[gr * ld + c * 8 + i]) : 0.f);
  }
}

// wgmma matrix descriptor of a swizzled tile at p (128-byte swizzle):
// start address, leading and stride byte offsets, in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A . B^T, m64n128k16: A and B K-major through descriptors (S =
// Q . K^T); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B, m64n{N}k16: A (P) from registers, B (V) MN-major through a
// descriptor (the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 128, "head_dim 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// ------------------------------------------------ TMA and mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
}

// A box of the 4-d tensor map (d, row, head, batch) into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int d, int row, int h,
                                         int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(row), "r"(h), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

template <int D> struct WgSmem {
  // 1024 bytes of alignment slack; Q; two-stage rings of K and of V; two
  // stages of kv segment ids.
  static constexpr size_t bytes = 1024 + WGS * SwTile<64, D>::BYTES +
                                  4 * SwTile<WG_BN, D>::BYTES + sizeof(int) * 2 * WG_BN;
};

template <int D, bool SEG>
__global__ void __launch_bounds__(WG_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      const int* __restrict__ seg, int H, int Lq, int Lk, Strides sq,
                      Strides sk, Strides sv, Strides so, float scale, int causal, int window,
                      int tma, const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv) {
  constexpr int NT = D / 8, QB = SwTile<64, D>::BYTES, TB = SwTile<WG_BN, D>::BYTES;
  // tma: Q, K and V arrive by TMA, each completing on a barrier (Q, two
  // K stages, two V stages); else element loads.
  __shared__ __align__(8) uint64_t bars[5];
  if (tma && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Kr = Qs + WGS * QB;  // K ring: stage s at Kr + s TB
  unsigned char* Vr = Kr + 2 * TB;    // V ring: stage s at Vr + s TB
  int* segk_s = reinterpret_cast<int*>(Vr + 2 * TB);  // [2][WG_BN], beside K

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * WG_ROWS;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int* segb = SEG ? seg + static_cast<long long>(b) * Lq : nullptr;
  int lo, hi;
  tile_range<WG_BN>(row0, WG_ROWS, Lq, Lk, causal, window, lo, hi);
  // A stage's uses alternate its barrier's phase.
  auto phase = [&](int tile) { return ((tile - lo) >> 1) & 1; };
  auto tma_tile = [&](unsigned char* dst, const CUtensorMap* map, int row, uint64_t* bar) {
    mbar_expect(bar, TB);
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
      tma_load(dst + p * SwTile<WG_BN, D>::PANEL, map, 64 * p, row, h, b, bar);
  };
  auto load_k = [&](int tile) {
    if (!tma)
      load_sw_tile<WG_BN, D>(Kr + (tile & 1) * TB, kb, sk.l, tile * WG_BN, Lk);
    else if (threadIdx.x == 0)
      tma_tile(Kr + (tile & 1) * TB, &tk, tile * WG_BN, bars + 1 + (tile & 1));
    if (SEG)
#pragma unroll
      for (int i = 0; i < WG_BN / 64; ++i)
        load_vec<WG_THREADS>(segk_s + (tile & 1) * WG_BN + 64 * i, segb, tile * WG_BN + 64 * i,
                             Lk);
  };
  auto load_v = [&](int tile) {
    if (!tma)
      load_sw_tile<WG_BN, D>(Vr + (tile & 1) * TB, vb, sv.l, tile * WG_BN, Lk);
    else if (threadIdx.x == 0)
      tma_tile(Vr + (tile & 1) * TB, &tv, tile * WG_BN, bars + 3 + (tile & 1));
  };
  auto wait_k = [&](int tile) {
    if (tma) mbar_wait(bars + 1 + (tile & 1), phase(tile));
  };
  auto wait_v = [&](int tile) {
    if (tma) mbar_wait(bars + 3 + (tile & 1), phase(tile));
  };
  // The landed tiles handed to the tensor cores, once every thread is
  // done with the stages refilled next.
  auto sync_tiles = [] {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
  };

  // This warpgroup's Q tile; this thread's rows ra, ra + 8.
  const unsigned char* Qw = Qs + (warp >> 2) * QB;
  const int ra = row0 + warp * 16 + (lane >> 2);
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) segq[i] = SEG && ra + 8 * i < Lq ? segb[ra + 8 * i] : -1;
  const float sl = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // S = Q . K^T of one tile over D / 16 k-steps (32 bytes along a 128-byte
  // swizzled row, then the next 64-column panel); issued, not waited.
  float sc[WG_NJ][4];
  auto issue_s = [&](int tile) {
    const unsigned char* Ks = Kr + (tile & 1) * TB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk & 3) * 32;
      wgmma_ss_n128(sc, sw128_desc(Qw + (kk >> 2) * SwTile<64, D>::PANEL + off, 16, 1024),
                    sw128_desc(Ks + (kk >> 2) * SwTile<WG_BN, D>::PANEL + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P . V of one tile over k-steps of 16 kv rows (2 KiB of the tile
  // each); V is MN-major: 64-column panels a panel apart, 8-row groups
  // 1 KiB apart.  P is packed to bf16 before the first product, so no A
  // register of an issued wgmma is written while it runs.
  uint32_t pa[WG_BN / 16][4];
  auto pack_p = [&] {
#pragma unroll
    for (int kk = 0; kk < WG_BN / 16; ++kk) {
      pa[kk][0] = pack_f32(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack_f32(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack_f32(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack_f32(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
  };
  auto issue_pv = [&](int tile) {
    const unsigned char* Vs = Vr + (tile & 1) * TB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BN / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk], sw128_desc(Vs + kk * 2048, SwTile<WG_BN, D>::PANEL, 1024));
    wgmma_commit();
  };

  // The sweep is pipelined by one tile: S of tile j runs on the tensor
  // cores beside P . V of tile j - 1, and the softmax of tile j beside
  // P . V of tile j - 1.  K runs one tile ahead of V in the rings.
  if (!tma) {
#pragma unroll
    for (int w = 0; w < WGS; ++w)
      load_sw_tile<64, D>(Qs + w * QB, q + b * sq.b + h * sq.h, sq.l, row0 + 64 * w, Lq);
  } else if (threadIdx.x == 0) {
    mbar_expect(bars, WGS * QB);
#pragma unroll
    for (int w = 0; w < WGS; ++w)
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        tma_load(Qs + w * QB + p * SwTile<64, D>::PANEL, &tq, 64 * p, row0 + 64 * w, h, b, bars);
  }
  if (lo < hi) load_k(lo);
  cp_async_commit();
  if (lo < hi) {
    sync_tiles();
    if (tma) mbar_wait(bars, 0);
    wait_k(lo);
    if (lo + 1 < hi) load_k(lo + 1);
    load_v(lo);
    cp_async_commit();
    issue_s(lo);
    wgmma_wait<0>();
    softmax_step<WG_NJ, SEG>(sc, m, l, corr, ra, lo * WG_BN, Lk, causal, window, segq,
                             segk_s + (lo & 1) * WG_BN, sl);
    pack_p();
    for (int tile = lo + 1; tile < hi; ++tile) {
      sync_tiles();  // K of `tile` and V of `tile - 1` have landed
      wait_k(tile);
      wait_v(tile - 1);
      if (tile + 1 < hi) load_k(tile + 1);
      load_v(tile);
      cp_async_commit();
      issue_s(tile);
      issue_pv(tile - 1);
      wgmma_wait<1>();  // S is in, P . V may still run
      softmax_step<WG_NJ, SEG>(sc, m, l, corr, ra, tile * WG_BN, Lk, causal, window, segq,
                               segk_s + (tile & 1) * WG_BN, sl);
      wgmma_wait<0>();
      rescale(acc, corr);
      pack_p();
    }
    sync_tiles();
    wait_v(hi - 1);
    issue_pv(hi - 1);
    wgmma_wait<0>();
  }

  // O = acc / l through shared memory (every tile is consumed), then out
  // in 16-byte row pieces (out is the wrapper's contiguous tensor).
  float inv[2];
  finish_rows(l, m, lse == nullptr ? nullptr : lse + static_cast<long long>(bh) * Lq, ra, Lq,
              scale, inv);
  __syncthreads();
  constexpr int OS = D + 8;  // padded row stride (elements): conflict-free
  bf16* Os = reinterpret_cast<bf16*>(Qs);
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(Os + (ra + 8 * i - row0) * OS + n * 8 + 2 * t) =
          pack_f32(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
  __syncthreads();
  bf16* ob = o + b * so.b + h * so.h;
  for (int e = threadIdx.x; e < WG_ROWS * (D / 8); e += WG_THREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    if (row0 + r < Lq)
      *reinterpret_cast<uint4*>(ob + (row0 + r) * so.l + c) =
          *reinterpret_cast<const uint4*>(Os + r * OS + c);
  }
}

// ------------------------------------------------------------ launchers

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime (no
// link against libcuda); null if the driver has none.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The TMA map of a bf16 [B, L, H, D] tensor (b / l / h strides in
// elements, 16-byte multiples) in boxes of `rows` rows x 64 columns,
// 128-byte swizzled as SwTile lays them out; false if it cannot be made.
bool tensor_map(CUtensorMap* map, const void* base, const Strides& s, int B, int L, int H, int D,
                int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.l) * 2,
                                 static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* seg, int B, int H, int Lq, int Lk, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int rows = F32 ? F32_ROWS : WG_ROWS, threads = F32 ? F32_THREADS : WG_THREADS;
  auto kern = [] {
    if constexpr (F32) return flash_fwd_f32_kernel<D, SEG>;
    else return flash_fwd_bf16_kernel<D, SEG>;
  }();
  const int smem = static_cast<int>(F32 ? F32Smem<D>::bytes : WgSmem<D>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int vec = aligned16<T>(q, sq) && aligned16<T>(k, sk) && aligned16<T>(v, sv);
  const dim3 grid(B * H, (Lq + rows - 1) / rows);
  if constexpr (F32) {
    kern<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, seg, H, Lq, Lk, sq, sk, sv, so, scale, causal, window, vec);
  } else {
    // TMA takes 16-byte aligned bases and strides; other views take
    // element loads.
    CUtensorMap tq{}, tk{}, tv{};
    vec = vec && tensor_map(&tq, q, sq, B, Lq, H, D, 64) &&
          tensor_map(&tk, k, sk, B, Lk, H, D, WG_BN) && tensor_map(&tv, v, sv, B, Lk, H, D, WG_BN);
    kern<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, seg, H, Lq, Lk, sq, sk, sv, so, scale, causal, window, vec, tq,
        tk, tv);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// b / l / h axes of a [B, L, H, D] tensor whose D axis has unit stride.
// lse: f32 [B, H, Lq] or null (no lse written).  seg: contiguous int32
// [B, L] segment ids (Lq == Lk) or null (no segment mask).  window <= 0
// means no window; scale must be positive (the softmax keeps its running
// max over the raw logits).  Returns a cudaError_t (0 on success).
extern "C" int dkt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             const int* seg, int dtype, int B, int H, int Lq, int Lk, int D,
                             long long sqb, long long sql, long long sqh, long long skb,
                             long long skl, long long skh, long long svb, long long svl,
                             long long svh, long long sob, long long sol, long long soh,
                             float scale, int causal, int window, void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh}, so{sob, sol, soh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((seg != nullptr && Lq != Lk) || !(scale > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
#define DKT_LAUNCH(T, DIM)                                                                  \
  return static_cast<int>(                                                                  \
      seg != nullptr ? launch<T, DIM, true>(q, k, v, o, lse, seg, B, H, Lq, Lk, sq, sk, sv, \
                                            so, scale, causal, window, st)                  \
                     : launch<T, DIM, false>(q, k, v, o, lse, seg, B, H, Lq, Lk, sq, sk, sv, \
                                             so, scale, causal, window, st))
  if (dtype == 0 && D == 64) DKT_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) DKT_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) DKT_LAUNCH(bf16, 64);
  if (dtype == 1 && D == 128) DKT_LAUNCH(bf16, 128);
#undef DKT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* dkt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
