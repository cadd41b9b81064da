// Flash-attention backward (FA2) for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: distkeras_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (launcher _flash_pallas_bwd).  Same function:
// the probabilities are rebuilt per tile from the forward's saved
// log-sum-exp, p = exp(s * scale - lse) with s masked as the forward
// masks it (finite NEG_INF for causal / window / segment-dead pairs, so
// they rebuild p = 0; -inf past the ragged edge), and with
// delta = rowsum(dO * O) (computed by the launcher):
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
// What bounds it on this card: at the training shape ([8, 1024, 8, 128],
// causal, f32) dQ does 6 * D FLOPs and dK/dV 8 * D FLOPs per live
// (query, key) pair, ~26 and ~34 GFLOP, against ~100 MB of inputs: both
// are bound by arithmetic.  This version does all products as f32 FMAs
// on the CUDA cores for both dtypes (bf16 inputs are widened on load),
// which is exactly what the Pallas bodies compute (they convert every
// tile to f32), so its floor is the 67 TFLOP/s f32 rate; each thread
// holds a 4 x 4 block of the S / dP tiles and a 4 x D/16 block of its
// accumulators, reading operands out of padded (bank-conflict-free)
// shared memory.  Tensor cores (mma / wgmma), TMA and a pipelined tile
// stream are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // kv rows per tile
// 16 x 16 threads over a 64 x 64 tile.  The tiles take 150-168 KB of
// shared memory at D = 128, so one block fits an SM; the launch bounds
// say so (at least 1 block per SM), which leaves ptxas the whole register
// file of a thread (255) for the accumulators.
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, l, h;
};

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// The forward's mask: -inf past the ragged edge, the finite NEG_INF for
// causal / window-dead pairs and pairs of two segments.
__device__ __forceinline__ float masked(float x, int r, int c, int Lk, int causal, int window,
                                        bool seg_dead) {
  if (c >= Lk) return neg_infinity();
  if (causal && (r < c || (window > 0 && r - c >= window))) return NEG_INF;
  if (seg_dead) return NEG_INF;
  return x;
}

// Shared-memory row strides (floats).  Tiles read down a column by the
// two 16-thread halves of a warp (Q, dO) sit 16 banks apart (D + 4);
// tiles read along a row across tx (K, V) differ by one bank (D + 1).
template <int D> struct Pad {
  static constexpr int QS = D + 4;
  static constexpr int KS = D + 1;
  static constexpr int SS = BN + 1;
};

// 64 rows of a [L, D] slice (row stride ld) into f32 shared memory (row
// stride RS); rows at or past L are zero.
template <typename T, int D, int RS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ld, int row0,
                                          int L) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D, gr = row0 + r;
    dst[r * RS + c] = gr < L ? to_f32(src[gr * ld + c]) : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int L) {
  for (int r = threadIdx.x; r < 64; r += THREADS) dst[r] = row0 + r < L ? src[row0 + r] : 0.f;
}

__device__ __forceinline__ void load_segs(int* dst, const int* seg, int row0, int L, int pad) {
  for (int r = threadIdx.x; r < 64; r += THREADS) dst[r] = row0 + r < L ? seg[row0 + r] : pad;
}

// S = Q . K^T and dP = dO . V^T for q rows ty*4+i and kv columns tx+16j
// of the current tiles.
template <int D>
__device__ __forceinline__ void logits_and_dp(const float* Qs, const float* dOs, const float* Ks,
                                              const float* Vs, int ty, int tx, float (&s)[4][4],
                                              float (&dp)[4][4]) {
  using P = Pad<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty * 4 + i) * P::QS + d];
      gv[i] = dOs[(ty * 4 + i) * P::QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * P::KS + d];
      vv[j] = Vs[(tx + 16 * j) * P::KS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

// ------------------------------------------------------------------- dQ

template <int D> struct DqSmem {
  using P = Pad<D>;
  // Q, dO [BM][QS]; K, V [BN][KS]; dS [BM][SS]; lse, delta [BM]; segs.
  static constexpr int floats = 2 * BM * P::QS + 2 * BN * P::KS + BM * P::SS + 2 * BM + BM + BN;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    T* __restrict__ dq, int H, int Lq, int Lk, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdq, float scale, int causal, int window) {
  using P = Pad<D>;
  constexpr int DJ = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * P::QS;
  float* Ks = dOs + BM * P::QS;
  float* Vs = Ks + BN * P::KS;
  float* dSs = Vs + BN * P::KS;
  float* lse_s = dSs + BM * P::SS;
  float* dl_s = lse_s + BM;
  int* segq_s = reinterpret_cast<int*>(dl_s + BM);
  int* segk_s = segq_s + BM;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * BM;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int* segb = SEG ? seg + static_cast<long long>(b) * Lq : nullptr;

  load_tile<T, D, P::QS>(Qs, q + b * sq.b + h * sq.h, sq.l, row0, Lq);
  load_tile<T, D, P::QS>(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, row0, Lq);
  load_rows(lse_s, lse + static_cast<long long>(bh) * Lq, row0, Lq);
  load_rows(dl_s, delta + static_cast<long long>(bh) * Lq, row0, Lq);
  if (SEG) load_segs(segq_s, segb, row0, Lq, -1);

  // Live kv tiles: the forward's range.
  const int n_kt = (Lk + BN - 1) / BN;
  int lo = 0, hi = n_kt;
  if (causal) {
    const int last_row = min(row0 + BM, Lq) - 1;
    hi = min(n_kt, last_row / BN + 1);
    if (window > 0) lo = max(0, row0 - window + 1) / BN;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int col0 = t * BN;
    __syncthreads();  // the previous tile's K / dS are consumed
    load_tile<T, D, P::KS>(Ks, kb, sk.l, col0, Lk);
    load_tile<T, D, P::KS>(Vs, vb, sv.l, col0, Lk);
    if (SEG) load_segs(segk_s, segb, col0, Lk, -2);
    __syncthreads();

    float s[4][4], dp[4][4];
    logits_and_dp<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = tx + 16 * j;
        const float x = masked(s[i][j] * scale, row0 + ri, col0 + cj, Lk, causal, window,
                               SEG && segq_s[ri] != segk_s[cj]);
        const float p = expf(x - lse_s[ri]);
        dSs[ri * P::SS + cj] = p * (dp[i][j] - dl_s[ri]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS . K for rows ty*4+i, columns tx+16j.
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float dsv[4], kr[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * P::SS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kr[j] = Ks[kk * P::KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kr[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= Lq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(dqb + gr * sdq.l + tx + 16 * j, acc[i][j]);
  }
}

// ---------------------------------------------------------------- dK/dV

template <int D> struct DkvSmem {
  using P = Pad<D>;
  // K, V [BN][KS]; Q, dO [BM][QS]; P, dS [BM][SS]; lse, delta [BM]; segs.
  static constexpr int floats = 2 * BN * P::KS + 2 * BM * P::QS + 2 * BM * P::SS + 2 * BM + BM + BN;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale,
                     int causal, int window) {
  using P = Pad<D>;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * P::KS;
  float* Qs = Vs + BN * P::KS;
  float* dOs = Qs + BM * P::QS;
  float* Ps = dOs + BM * P::QS;
  float* dSs = Ps + BM * P::SS;
  float* lse_s = dSs + BM * P::SS;
  float* dl_s = lse_s + BM;
  int* segq_s = reinterpret_cast<int*>(dl_s + BM);
  int* segk_s = segq_s + BM;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int col0 = blockIdx.x * BN;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + static_cast<long long>(bh) * Lq;
  const float* deltab = delta + static_cast<long long>(bh) * Lq;
  const int* segb = SEG ? seg + static_cast<long long>(b) * Lq : nullptr;

  load_tile<T, D, P::KS>(Ks, k + b * sk.b + h * sk.h, sk.l, col0, Lk);
  load_tile<T, D, P::KS>(Vs, v + b * sv.b + h * sv.h, sv.l, col0, Lk);
  if (SEG) load_segs(segk_s, segb, col0, Lk, -2);

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

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int row0 = t * BM;
    __syncthreads();  // the previous tile's Q / dO / P / dS are consumed
    load_tile<T, D, P::QS>(Qs, qb, sq.l, row0, Lq);
    load_tile<T, D, P::QS>(dOs, dob, sdo.l, row0, Lq);
    load_rows(lse_s, lseb, row0, Lq);
    load_rows(dl_s, deltab, row0, Lq);
    if (SEG) load_segs(segq_s, segb, row0, Lq, -1);
    __syncthreads();

    float s[4][4], dp[4][4];
    logits_and_dp<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = tx + 16 * j;
        const float x = masked(s[i][j] * scale, row0 + ri, col0 + cj, Lk, causal, window,
                               SEG && segq_s[ri] != segk_s[cj]);
        // Rows past Lq carry no query: p = 0.
        const float p = row0 + ri < Lq ? expf(x - lse_s[ri]) : 0.f;
        Ps[ri * P::SS + cj] = p;
        dSs[ri * P::SS + cj] = p * (dp[i][j] - dl_s[ri]) * scale;
      }
    }
    __syncthreads();

    // dV += P^T . dO and dK += dS^T . Q for kv rows ty*4+i, columns
    // tx+16j.
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float pv[4], sv_[4], gv[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * P::SS + ty * 4 + i];
        sv_[i] = dSs[r * P::SS + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = dOs[r * P::QS + tx + 16 * j];
        qv[j] = Qs[r * P::QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sv_[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gc = col0 + ty * 4 + i;
    if (gc >= Lk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store(dkb + gc * sdk.l + tx + 16 * j, dk_acc[i][j]);
      store(dvb + gc * sdv.l + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

// ------------------------------------------------------------- launchers

template <typename T, int D, bool SEG>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* seg, void* dq, int B,
                      int H, int Lq, int Lk, Strides sq, Strides sk, Strides sv, Strides sdo,
                      Strides sdq, float scale, int causal, int window, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D, SEG>;
  const int smem = static_cast<int>(DqSmem<D>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dq), H, Lq, Lk, sq, sk, sv,
      sdo, sdq, scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* seg, void* dk, void* dv,
                       int B, int H, int Lq, int Lk, Strides sq, Strides sk, Strides sv,
                       Strides sdo, Strides sdk, Strides sdv, float scale, int causal,
                       int window, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, D, SEG>;
  const int smem = static_cast<int>(DkvSmem<D>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + BN - 1) / BN, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dk), static_cast<T*>(dv), H,
      Lq, Lk, sq, sk, sv, sdo, sdk, sdv, scale, causal, window);
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
