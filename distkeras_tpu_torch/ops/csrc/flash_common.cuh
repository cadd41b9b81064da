// Pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the reference's mask, 64-row shared-memory tiles filled
// by cp.async, and the mma.sync building blocks (bf16 through ldmatrix,
// f32 as error-compensated 3xTF32).  The tile shape a kernel gives its
// warps (threads per block, n-tiles per warp) is a template parameter of
// each helper, so every kernel keeps its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, l, h;
};

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// The reference's mask: -inf past the ragged edge (no key there, p = 0),
// the finite NEG_INF for causal / window-dead pairs and pairs of two
// segments.
__device__ __forceinline__ float masked(float x, int r, int c, int Lk, int causal, int window,
                                        bool seg_dead) {
  if (c >= Lk) return neg_infinity();
  if (causal && (r < c || (window > 0 && r - c >= window))) return NEG_INF;
  if (seg_dead) return NEG_INF;
  return x;
}

// 2^x on the special function unit (-inf gives 0; results under 2^-126
// flush to 0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 64-row tile of D elements per row in shared memory, rows padded by 16
// bytes.
template <typename T, int D> struct Tile {
  static constexpr int RS = D + 16 / static_cast<int>(sizeof(T));  // row stride (elements)
  static constexpr int ELEMS = 64 * RS;
};

// 16-byte copies need a 16-byte aligned base and b / l / h strides that
// are whole 16-byte chunks.
template <typename T> bool aligned16(const void* p, const Strides& s) {
  constexpr long long E = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % E == 0 && s.l % E == 0 &&
         s.h % E == 0;
}

// ------------------------------------------------------------ async copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (resp. 4) bytes global -> shared; bytes past `src_bytes` are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a [L, D] slice (row stride ld) into a Tile,
// by THREADS threads; rows at or past L are zero.  vec: 16-byte cp.async;
// else element loads.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld, int row0, int L,
                                          bool vec) {
  constexpr int RS = Tile<T, D>::RS, EPC = 16 / static_cast<int>(sizeof(T)), CH = D / EPC;
  for (int e = threadIdx.x; e < 64 * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * EPC, gr = row0 + r;
    T* d = dst + r * RS + c;
    if (vec) {
      cp_async16(d, gr < L ? src + gr * ld + c : src, gr < L ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < EPC; ++i) store(d + i, gr < L ? to_f32(src[gr * ld + c + i]) : 0.f);
    }
  }
}

// Entries [row0, row0 + 64) of a length-L vector of 4-byte values; entries
// at or past L are zero.
template <int THREADS, typename U>
__device__ __forceinline__ void load_vec(U* dst, const U* src, int row0, int L) {
  for (int r = threadIdx.x; r < 64; r += THREADS)
    cp_async4(dst + r, src + min(row0 + r, L - 1), row0 + r < L ? 4 : 0);
}

// ------------------------------------------------------------ tensor cores

// D += A . B for one m16n8k16 bf16 tile (A row-major 16x16, B col-major
// 16x8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A . B for one m16n8k8 tf32 tile.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds finite x, in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi = tf32(x) and lo = x - hi, exact in f32; the
// tensor cores read lo's top 19 bits only (truncating it to tf32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D += A . B at f32 accuracy (3xTF32): the small cross terms first, then
// the large one.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint32_t bhi0,
                                           uint32_t bhi1, uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[j] += A[m0 : m0 + 16, :] . B[n0 + 8j : n0 + 8j + 8, :]^T for j < NJ:
// two row-major Tiles contracted over D (S = Q . K^T and the like).
template <typename T, int D, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4], const T* A, int m0, const T* B,
                                         int n0) {
  constexpr int RS = Tile<T, D>::RS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, A + (m0 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, B + (n0 + jj * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * jj], a, b[0], b[1]);
        mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* pa = A + (m0 + g) * RS + kk * 8 + t;
      uint32_t ah[4], al[4];
      split_tf32(pa[0], ah[0], al[0]);
      split_tf32(pa[8 * RS], ah[1], al[1]);
      split_tf32(pa[4], ah[2], al[2]);
      split_tf32(pa[8 * RS + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* pb = B + (n0 + j * 8 + g) * RS + kk * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(pb[0], bh0, bl0);
        split_tf32(pb[4], bh1, bl1);
        mma_3xtf32(acc[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// acc[n] += P . B[k0 : k0 + 8 NJ, 8n : 8n + 8] for n < D / 8: P is the
// warp's 16 x 8 NJ tile held as mma accumulators (p[j]: columns 8j ..
// 8j + 7), used as the A operand from registers; B a row-major Tile
// contracted over its rows (P . V, dS . K, P^T . dO, dS^T . Q).  In the
// f32 path the accumulator holds columns 2t, 2t + 1 where the tf32 A
// fragment wants k = t, t + 4, so k = t is taken as column 2t and
// k = t + 4 as 2t + 1, and B's rows are read in the same order.
template <typename T, int D, int NJ>
__device__ __forceinline__ void mma_acc_rows(float (&acc)[D / 8][4], const float (&p)[NJ][4],
                                             const T* B, int k0) {
  constexpr int RS = Tile<T, D>::RS, NT = D / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      const uint32_t a[4] = {pack_f32(p[2 * kk][0], p[2 * kk][1]),
                             pack_f32(p[2 * kk][2], p[2 * kk][3]),
                             pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t b[4];
        ldsm_x4_trans(b, B + (k0 + kk * 16 + (lane & 15)) * RS + nn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * nn], a, b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(p[kk][0], ah[0], al[0]);
      split_tf32(p[kk][2], ah[1], al[1]);
      split_tf32(p[kk][1], ah[2], al[2]);
      split_tf32(p[kk][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* pb = B + (k0 + kk * 8 + 2 * t) * RS + n * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(pb[0], bh0, bl0);
        split_tf32(pb[RS], bh1, bl1);
        mma_3xtf32(acc[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// n-tiles [n_lo, n_hi) of rows r_lo, r_lo + 8 of the accumulator into out
// (row stride ld); rows at or past L are skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, long long ld, const float (&acc)[D / 8][4],
                                           int r_lo, int L, int n_lo, int n_hi) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n < n_lo || n >= n_hi) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      if (r >= L) continue;
      T* p = out + r * ld + n * 8 + 2 * t;
      store(p, acc[n][2 * i]);
      store(p + 1, acc[n][2 * i + 1]);
    }
  }
}

}  // namespace
