// Flash-attention backward (FA2) for Hopper (sm_90a): dQ and dK/dV on the
// tensor cores.
//
// Replaces: distkeras_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (launcher _flash_pallas_bwd).  Same function:
// the probabilities are rebuilt per tile from the forward's saved
// log-sum-exp, p = exp(s * scale - lse) with s masked as the forward
// masks it (finite NEG_INF for causal / window / segment-dead pairs, so
// they rebuild p = 0; -inf past the ragged edge; p = 0 for rows past Lq),
// and with delta = rowsum(dO * O) (computed by the launcher):
//   dS = p * (dO . V^T - delta) * scale
//   dQ = sum over kv tiles of dS . K
//   dV = sum over q tiles of p^T . dO,   dK = sum over q tiles of dS^T . Q
//
// Translation of the TPU kernels:
// - The Pallas grids carry dq (resp. dk / dv) in VMEM scratch across a
//   sequential inner grid axis.  Here the inner axis is a loop inside one
//   CUDA block and the accumulators stay in registers: the dQ kernel runs
//   one block per (64-row q tile, batch * head) and loops over the live
//   kv tiles; the dK/dV kernel runs one block per (64-row kv tile,
//   batch * head) and loops over the live q tiles.  That is the Pallas
//   grids' own split, so no two blocks write one output element: no
//   atomics, and the results are deterministic.
// - Live tiles: the dQ kernel walks the forward's range (stop at the
//   diagonal, start at the first tile inside the window); the dK/dV
//   kernel starts at the q tile holding row col0 (causal) and, with a
//   window, stops at the tile holding the last row whose window reaches
//   the kv tile (the mirror of _banded_q and the live test of
//   _flash_bwd_dkv_kernel).
// - Inputs keep the public [B, L, H, D] layout (b / l / h strides, unit
//   stride on D); lse / delta are contiguous f32 [B, H, Lq]; segment ids
//   are int32 [B, L] indexed by batch row.  Rows and columns past Lq / Lk
//   are zero-filled on load and never written.
//
// What bounds it on this card: per live (query, key) pair dQ does 6 * D
// FLOPs (S, dP, dS . K) and dK/dV 8 * D (S, dP, P^T . dO, dS^T . Q); at
// the training shape ([8, 1024, 8, 128], causal: 33.6M live pairs) that
// is ~26 and ~34 GFLOP against 134 MB of f32 inputs, so both kernels
// are bound by the tensor cores: 989 TFLOP/s in bf16, and for f32 the
// 3xTF32 rate, 495 / 3 = 165 TFLOP/s (the least time for f32-accurate
// products on this card: PyTorch's own f32 attention backward runs its
// GEMMs the same way, OpMultiplyAddFastF32 in
// ATen/native/transformers/cuda/mem_eff_attention/gemm_kernel_utils.h).
//
// Design:
// - All five products run as mma.sync with f32 accumulators in
//   registers.  bf16 inputs: m16n8k16 bf16, operands through ldmatrix
//   (.trans for the operands contracted over their rows).  f32 inputs:
//   m16n8k8 tf32 with error compensation (3xTF32): every operand x is
//   split into hi = tf32(x) (rounded to nearest) and lo = x - hi, and
//   a . b is summed as lo.hi + hi.lo, then hi.hi, into one f32
//   accumulator (the order of CUTLASS's mma_tensor_op_fast_f32.h).  The
//   tensor cores truncate lo to tf32; that and the dropped lo.lo term
//   leave ~2^-20 of each product, against ~2^-11 for one TF32 pass.
// - The dK/dV kernel computes S^T = K . Q^T and dP^T = V . dO^T, so that
//   both kernels hold P / dS (resp. P^T / dS^T) as mma accumulators whose
//   rows are the block's own rows, and reuse them from registers as the A
//   operand of the second product (dS . K, P^T . dO, dS^T . Q): no tile
//   of P or dS goes through shared memory.  bf16 rounds P and dS to bf16
//   there, as the forward rounds P; f32 splits them like any operand.  In
//   the f32 path the accumulator holds columns 2t, 2t+1 where the tf32
//   A fragment wants k = t, t + 4, so k = t is taken as column 2t and
//   k = t + 4 as 2t + 1, and B's rows are read in the same order.
// - 8 warps per block: 4 x 16 rows of the block's own 64-row tile, times
//   2 x 32 columns of the streamed 64-row tile.  Each warp pair sums its
//   two partial accumulators through shared memory at the end, in a fixed
//   order.
// - The streamed tiles (dQ: K, V and the kv segment ids; dK/dV: Q, dO,
//   lse, delta and the q segment ids) go through a ring of STAGES buffers
//   filled by cp.async: the copies of tile t + 1 are issued before the
//   products of tile t, with one barrier per tile.  16-byte copies (the
//   ragged edge zero-filled through cp.async's src-size operand) when
//   every q / k / v / dO base is 16-byte aligned and its b / l / h strides
//   are multiples of 16 bytes; otherwise the tiles are loaded element by
//   element (synchronously, into the same ring).  The 4-byte rows (lse,
//   delta, segment ids) always go by 4-byte cp.async.
// - Shared memory rows are padded by 16 bytes (bf16 D + 8, f32 D + 4), so
//   ldmatrix rows and the tf32 fragment reads are free of bank conflicts.
//   Per block at D = 128: 2 resident and 2 * STAGES streamed 64-row
//   tiles, 102.5-103.5 KiB in bf16 and 198.5-199.5 KiB in f32; ptxas
//   gives 164-248 registers (f32) and 140-240 (bf16), no spills.  One
//   block of 8 warps per SM: f32 tiles fit no second block, and for bf16
//   a second block per SM caps registers at 128, where ptxas spills (dQ
//   up to 152 bytes, ~20% faster all the same; dK/dV up to 728 bytes,
//   ~45% slower); a third stage gains nothing (PERF.md, PR 3).
// - p = 2^((s * scale - lse) * log2 e) runs on the special function unit
//   (ex2.approx, ~2^-22 relative).  Every tile takes the masked path: an
//   unmasked copy for tiles that cross no edge was within 2% in f32.
// - Grid x is batch * head and y the tile, ordered so that the causal
//   blocks with the most live tiles start first and the last wave holds
//   short ones (11% off f32 causal).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md): at
// the training shape, causal, f32 dQ 0.58 ms and dK/dV 0.73 ms (bounds
// 0.156 / 0.208; the f32 FMA version took 1.66 / 1.84; SDPA's whole f32
// backward 2.61), bf16 0.21 / 0.26 ms (bounds 0.026 / 0.035; FMA 1.56 /
// 1.77; SDPA 0.37).  Both are issue- and latency-bound at one block per
// SM: f32 spends ~8 instructions per tf32 mma (the operand splits, the
// fragment loads), bf16 stalls with 8 warps per SM.  wgmma / TMA with
// warp specialisation is the next step for bf16: a tf32 wgmma needs both
// operands K-major, which P^T . dO and dS^T . Q are not.

#include "flash_common.cuh"

namespace {

constexpr int BM = 64;        // q rows per tile
constexpr int BN = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 8 warps: 4 (own rows) x 2 (streamed columns)
constexpr int WCOLS = 32;     // streamed columns per warp
constexpr int NJ = WCOLS / 8; // mma n-tiles of S / dP per warp
constexpr int STAGES = 2;     // ring depth of the streamed tiles

// The warp pair (wm, 0), (wm, 1) holds two partial sums of one 16 x D
// accumulator.  Warp wn keeps n-tiles [wn * NT/2, (wn + 1) * NT/2) and
// adds the other's partials of them, handed over in `red` (64 * D
// floats).
template <int D>
__device__ __forceinline__ void pair_sum(float (&acc)[D / 8][4], float4* red, int wm, int wn) {
  constexpr int NT = D / 8, HALF = NT / 2;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if ((n >= HALF) == (wn == 0))
      red[(wm * NT + n) * 32 + lane] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if ((n < HALF) == (wn == 0)) {
      const float4 o = red[(wm * NT + n) * 32 + lane];
      acc[n][0] += o.x;
      acc[n][1] += o.y;
      acc[n][2] += o.z;
      acc[n][3] += o.w;
    }
}

// ------------------------------------------------------------------- dQ

template <typename T, int D> struct DqSmem {
  // Q, dO; STAGES x (K, V); STAGES x kv segment ids.
  static constexpr size_t bytes =
      sizeof(T) * (2 + 2 * STAGES) * Tile<T, D>::ELEMS + sizeof(int) * STAGES * BN;
  static_assert(bytes >= sizeof(float) * 64 * D, "pair_sum buffer");
};

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    T* __restrict__ dq, int H, int Lq, int Lk, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdq, float scale, int causal, int window,
                    int vec) {
  constexpr int NT = D / 8, EL = Tile<T, D>::ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + EL;
  T* KVs = dOs + EL;  // stage s: K at KVs + 2s EL, V at KVs + (2s + 1) EL
  int* segk_s = reinterpret_cast<int*>(KVs + 2 * STAGES * EL);  // [STAGES][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  // Heaviest tiles first: blocks start in index order, x fastest, and a
  // causal q tile's work grows with its row.
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int* segb = SEG ? seg + static_cast<long long>(b) * Lq : nullptr;

  // Live kv tiles: the forward's range.
  const int n_kt = (Lk + BN - 1) / BN;
  int lo = 0, hi = n_kt;
  if (causal) {
    const int last_row = min(row0 + BM, Lq) - 1;
    hi = min(n_kt, last_row / BN + 1);
    if (window > 0) lo = max(0, row0 - window + 1) / BN;
  }
  auto load_stage = [&](int tile) {
    const int s = (tile - lo) % STAGES, c0 = tile * BN;
    load_tile<T, D, THREADS>(KVs + 2 * s * EL, kb, sk.l, c0, Lk, vec);
    load_tile<T, D, THREADS>(KVs + (2 * s + 1) * EL, vb, sv.l, c0, Lk, vec);
    if (SEG) load_vec<THREADS>(segk_s + s * BN, segb, c0, Lk);
  };

  // Q and dO join the first group of copies.
  load_tile<T, D, THREADS>(Qs, q + b * sq.b + h * sq.h, sq.l, row0, Lq, vec);
  load_tile<T, D, THREADS>(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, row0, Lq, vec);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (lo + i < hi) load_stage(lo + i);
    cp_async_commit();
  }

  // This thread's q rows ra, ra + 8.
  const int ra = row0 + wm * 16 + g;
  float lse_r[2], dl_r[2];
  int segq_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    const bool in = r < Lq;
    lse_r[i] = in ? lse[static_cast<long long>(bh) * Lq + r] : 0.f;
    dl_r[i] = in ? delta[static_cast<long long>(bh) * Lq + r] : 0.f;
    segq_r[i] = SEG && in ? segb[r] : -1;
  }

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
    const T* Ks = KVs + 2 * s * EL;
    const T* Vs = Ks + EL;
    const int* segk = segk_s + s * BN;
    float sc[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_rows<T, D, NJ>(sc, Qs, wm * 16, Ks, wn * WCOLS);
    mma_rows<T, D, NJ>(dp, dOs, wm * 16, Vs, wn * WCOLS);

    // dS in place of S.  Rows past Lq are never stored.
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, cl = wn * WCOLS + j * 8 + 2 * t + (e & 1);
        const float x = masked(sc[j][e] * scale, ra + 8 * i, col0 + cl, Lk, causal, window,
                               SEG && segq_r[i] != segk[cl]);
        sc[j][e] = exp2_fast((x - lse_r[i]) * LOG2E) * (dp[j][e] - dl_r[i]) * scale;
      }
    mma_acc_rows<T, D, NJ>(acc, sc, Ks, wn * WCOLS);
  }

  cp_async_wait<0>();
  __syncthreads();  // the tiles are consumed: their memory takes the pair sums
  pair_sum<D>(acc, reinterpret_cast<float4*>(smem_raw), wm, wn);
  store_rows<T, D>(dq + b * sdq.b + h * sdq.h, sdq.l, acc, ra, Lq, wn * NT / 2, (wn + 1) * NT / 2);
}

// ---------------------------------------------------------------- dK/dV

template <typename T, int D> struct DkvSmem {
  // K, V; STAGES x (Q, dO); STAGES x (lse, delta, q segment ids).
  static constexpr size_t bytes =
      sizeof(T) * (2 + 2 * STAGES) * Tile<T, D>::ELEMS + sizeof(float) * 3 * STAGES * BM;
  static_assert(bytes >= sizeof(float) * 2 * 64 * D, "pair_sum buffers");
};

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale,
                     int causal, int window, int vec) {
  constexpr int NT = D / 8, EL = Tile<T, D>::ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + EL;
  T* QDs = Vs + EL;  // stage s: Q at QDs + 2s EL, dO at QDs + (2s + 1) EL
  float* rows_s = reinterpret_cast<float*>(QDs + 2 * STAGES * EL);  // stage s: 3 x BM at 3s BM

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  // Heaviest tiles first (a causal kv tile's work falls with its row).
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int col0 = blockIdx.y * BN;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + static_cast<long long>(bh) * Lq;
  const float* deltab = delta + static_cast<long long>(bh) * Lq;
  const int* segb = SEG ? seg + static_cast<long long>(b) * Lq : nullptr;

  // Live q tiles: causal starts at the tile holding row col0; a window
  // ends at the tile holding the last row r with r - c < window for some
  // column c of this tile.
  const int n_qt = (Lq + BM - 1) / BM;
  int lo = 0, hi = n_qt;
  if (causal) {
    lo = col0 / BM;
    if (window > 0) {
      const int c_max = min(col0 + BN, Lk) - 1;
      hi = min(n_qt, (c_max + window - 1) / BM + 1);
    }
  }
  auto load_stage = [&](int tile) {
    const int s = (tile - lo) % STAGES, r0 = tile * BM;
    load_tile<T, D, THREADS>(QDs + 2 * s * EL, qb, sq.l, r0, Lq, vec);
    load_tile<T, D, THREADS>(QDs + (2 * s + 1) * EL, dob, sdo.l, r0, Lq, vec);
    float* rows = rows_s + 3 * s * BM;
    load_vec<THREADS>(rows, lseb, r0, Lq);
    load_vec<THREADS>(rows + BM, deltab, r0, Lq);
    if (SEG) load_vec<THREADS>(reinterpret_cast<int*>(rows + 2 * BM), segb, r0, Lq);
  };

  // K and V join the first group of copies.
  load_tile<T, D, THREADS>(Ks, k + b * sk.b + h * sk.h, sk.l, col0, Lk, vec);
  load_tile<T, D, THREADS>(Vs, v + b * sv.b + h * sv.h, sv.l, col0, Lk, vec);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (lo + i < hi) load_stage(lo + i);
    cp_async_commit();
  }

  // This thread's kv rows ca, ca + 8.
  const int ca = col0 + wm * 16 + g;
  int segk_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) segk_r[i] = SEG && ca + 8 * i < Lk ? segb[ca + 8 * i] : -2;

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int tile = lo; tile < hi; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (tile + STAGES - 1 < hi) load_stage(tile + STAGES - 1);
    cp_async_commit();

    const int s = (tile - lo) % STAGES, row0 = tile * BM;
    const T* Qs = QDs + 2 * s * EL;
    const T* dOs = Qs + EL;
    const float* lse_s = rows_s + 3 * s * BM;
    const float* dl_s = lse_s + BM;
    const int* segq = reinterpret_cast<const int*>(lse_s + 2 * BM);

    // S^T = K . Q^T and dP^T = V . dO^T: rows are this block's kv rows.
    float sc[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_rows<T, D, NJ>(sc, Ks, wm * 16, Qs, wn * WCOLS);
    mma_rows<T, D, NJ>(dp, Vs, wm * 16, dOs, wn * WCOLS);

    // P^T in place of S^T, dS^T in place of dP^T.
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, rl = wn * WCOLS + j * 8 + 2 * t + (e & 1), r = row0 + rl;
        const float x = masked(sc[j][e] * scale, r, ca + 8 * i, Lk, causal, window,
                               SEG && segq[rl] != segk_r[i]);
        // Rows past Lq carry no query: p = 0.
        const float p = r < Lq ? exp2_fast((x - lse_s[rl]) * LOG2E) : 0.f;
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl_s[rl]) * scale;
      }
    mma_acc_rows<T, D, NJ>(dv_acc, sc, dOs, wn * WCOLS);
    mma_acc_rows<T, D, NJ>(dk_acc, dp, Qs, wn * WCOLS);
  }

  cp_async_wait<0>();
  __syncthreads();  // the tiles are consumed: their memory takes the pair sums
  // Warps wn = 0 keep dK and hand their dV partials over (red[4 + wm]),
  // warps wn = 1 keep dV and hand over dK (red[wm]).
  const bool keep_dk = wn == 0;
  float4* red = reinterpret_cast<float4*>(smem_raw) + lane;
  float4* give = red + ((keep_dk ? 4 : 0) + wm) * NT * 32;
  const float4* take = red + ((keep_dk ? 0 : 4) + wm) * NT * 32;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    give[n * 32] = keep_dk ? make_float4(dv_acc[n][0], dv_acc[n][1], dv_acc[n][2], dv_acc[n][3])
                           : make_float4(dk_acc[n][0], dk_acc[n][1], dk_acc[n][2], dk_acc[n][3]);
  __syncthreads();
  if (keep_dk) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 o = take[n * 32];
      dk_acc[n][0] += o.x;
      dk_acc[n][1] += o.y;
      dk_acc[n][2] += o.z;
      dk_acc[n][3] += o.w;
    }
    store_rows<T, D>(dk + b * sdk.b + h * sdk.h, sdk.l, dk_acc, ca, Lk, 0, NT);
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 o = take[n * 32];
      dv_acc[n][0] += o.x;
      dv_acc[n][1] += o.y;
      dv_acc[n][2] += o.z;
      dv_acc[n][3] += o.w;
    }
    store_rows<T, D>(dv + b * sdv.b + h * sdv.h, sdv.l, dv_acc, ca, Lk, 0, NT);
  }
}

// ------------------------------------------------------------- launchers

template <typename T, int D, bool SEG>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* seg, void* dq, int B,
                      int H, int Lq, int Lk, Strides sq, Strides sk, Strides sv, Strides sdo,
                      Strides sdq, float scale, int causal, int window, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D, SEG>;
  const int smem = static_cast<int>(DqSmem<T, D>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = aligned16<T>(q, sq) && aligned16<T>(k, sk) && aligned16<T>(v, sv) &&
                  aligned16<T>(dout, sdo);
  const dim3 grid(B * H, (Lq + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dq), H, Lq, Lk, sq, sk, sv,
      sdo, sdq, scale, causal, window, vec);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* seg, void* dk, void* dv,
                       int B, int H, int Lq, int Lk, Strides sq, Strides sk, Strides sv,
                       Strides sdo, Strides sdk, Strides sdv, float scale, int causal,
                       int window, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, D, SEG>;
  const int smem = static_cast<int>(DkvSmem<T, D>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = aligned16<T>(q, sq) && aligned16<T>(k, sk) && aligned16<T>(v, sv) &&
                  aligned16<T>(dout, sdo);
  const dim3 grid(B * H, (Lk + BN - 1) / BN);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dk), static_cast<T*>(dv), H,
      Lq, Lk, sq, sk, sv, sdo, sdk, sdv, scale, causal, window, vec);
  return cudaGetLastError();
}

}  // namespace

// Calling convention of both entries (as dkt_flash_fwd): dtype 0 =
// float32, 1 = bfloat16 (all of q, k, v, dO and the outputs); strides in
// elements for the b / l / h axes of [B, L, H, D] tensors with unit stride
// on D; lse and delta contiguous f32 [B, H, Lq]; seg contiguous int32
// [B, L] (Lq == Lk) or null; window <= 0 means no window.  Each returns a
// cudaError_t (0 on success).

#define DKT_DISPATCH(FN, ...)                                                 \
  do {                                                                        \
    const bool s = seg != nullptr;                                            \
    if (dtype == 0 && D == 64)                                                \
      return static_cast<int>(s ? FN<float, 64, true>(__VA_ARGS__)            \
                                : FN<float, 64, false>(__VA_ARGS__));         \
    if (dtype == 0 && D == 128)                                               \
      return static_cast<int>(s ? FN<float, 128, true>(__VA_ARGS__)           \
                                : FN<float, 128, false>(__VA_ARGS__));        \
    if (dtype == 1 && D == 64)                                                \
      return static_cast<int>(s ? FN<bf16, 64, true>(__VA_ARGS__)             \
                                : FN<bf16, 64, false>(__VA_ARGS__));          \
    if (dtype == 1 && D == 128)                                               \
      return static_cast<int>(s ? FN<bf16, 128, true>(__VA_ARGS__)            \
                                : FN<bf16, 128, false>(__VA_ARGS__));         \
    return static_cast<int>(cudaErrorInvalidValue);                           \
  } while (0)

extern "C" int dkt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* seg, void* dq,
                                int dtype, int B, int H, int Lq, int Lk, int D, long long sqb,
                                long long sql, long long sqh, long long skb, long long skl,
                                long long skh, long long svb, long long svl, long long svh,
                                long long sob, long long sol, long long soh, long long sdb,
                                long long sdl, long long sdh, float scale, int causal,
                                int window, void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh}, sdo{sob, sol, soh},
      sdq{sdb, sdl, sdh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seg != nullptr && Lq != Lk) return static_cast<int>(cudaErrorInvalidValue);
  DKT_DISPATCH(launch_dq, q, k, v, dout, lse, delta, seg, dq, B, H, Lq, Lk, sq, sk, sv, sdo, sdq,
               scale, causal, window, st);
}

extern "C" int dkt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* seg, void* dk,
                                 void* dv, int dtype, int B, int H, int Lq, int Lk, int D,
                                 long long sqb, long long sql, long long sqh, long long skb,
                                 long long skl, long long skh, long long svb, long long svl,
                                 long long svh, long long sob, long long sol, long long soh,
                                 long long skb2, long long skl2, long long skh2, long long svb2,
                                 long long svl2, long long svh2, float scale, int causal,
                                 int window, void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh}, sdo{sob, sol, soh},
      sdk{skb2, skl2, skh2}, sdv{svb2, svl2, svh2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seg != nullptr && Lq != Lk) return static_cast<int>(cudaErrorInvalidValue);
  DKT_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, seg, dk, dv, B, H, Lq, Lk, sq, sk, sv, sdo,
               sdk, sdv, scale, causal, window, st);
}

#undef DKT_DISPATCH

extern "C" const char* dkt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
