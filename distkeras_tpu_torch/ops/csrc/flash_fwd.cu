// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: distkeras_tpu/ops/attention.py::_flash_kernel (launcher
// _flash_pallas, inference variant with_lse=False).  Same function:
// logits = q . k^T * scale in f32, masked with the finite NEG_INF (-1e30)
// for causal / sliding-window pairs, online softmax over KV tiles with
// m / l / acc in f32, and O = acc / l with the `l == 0` guard.
//
// Translation of the TPU kernel:
// - The Pallas grid's sequential kv dimension (state carried in VMEM
//   scratch across grid steps) becomes a loop inside one CUDA block: the
//   m / l / acc state stays on chip (registers, shared memory) for the
//   whole KV sweep.
// - Blocks run over (64-row q tile, batch * head); they are independent.
// - Causal runs stop at the diagonal tile, and a window starts at the
//   first tile inside the lookback (the counterpart of the banded grid,
//   _banded_kv), so K/V traffic stays O(window).
// - Tiles are the port's own (64 q rows x 64 kv rows), not the TPU's
//   1024; the ragged edge (Lq, Lk not multiples of 64) is masked here.
// - Inputs keep the public [B, L, H, D] layout; the kernel takes the
//   b / l / h strides (unit stride on D), so no transpose copy is made.
//
// What bounds it on this card: at the prefill shape ([8, 512, 8, 128],
// causal, bf16) the work is ~4.3 GFLOP against ~34 MB of q / k / v / O,
// so its floor is the HBM time (~10 us) with the tensor-core time
// (~4.4 us) close behind; both products have to run on the tensor cores
// to get near it.  Two kernels:
// - bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16 q
//   rows each; Q's fragments stay in registers for the whole sweep, K / V
//   tiles go through padded shared memory (conflict-free fragment reads),
//   and the S accumulator is reused in registers as the A operand of P.V
//   (P rounded to bf16 there, as the tensor cores need).
// - f32: FMAs on the CUDA cores out of shared memory (register-tiled 4 x 4
//   for Q.K^T and 4 x D/16 for P.V): exact f32 products, which tensor
//   cores (TF32) would not give.
// wgmma / TMA and a pipelined KV stream are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // q rows per block
constexpr int BN = 64;  // kv rows per tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, l, h;
};

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

// Live KV tiles [lo, hi) of a q tile starting at row0: causal stops at the
// diagonal; a window starts at the first tile reaching the lookback of
// the tile's first row.
__device__ __forceinline__ void tile_range(int row0, int Lq, int Lk, int causal, int window,
                                           int* lo, int* hi) {
  const int n_tiles = (Lk + BN - 1) / BN;
  *lo = 0;
  *hi = n_tiles;
  if (causal) {
    const int last_row = min(row0 + BM, Lq) - 1;
    *hi = min(n_tiles, last_row / BN + 1);
    if (window > 0) *lo = max(0, row0 - window + 1) / BN;
  }
}

// The reference's mask: -inf past the ragged edge (no key there, p = 0),
// the finite NEG_INF for causal / window-dead pairs.
__device__ __forceinline__ float masked(float x, int r, int c, int Lk, int causal, int window) {
  if (c >= Lk) return neg_infinity();
  if (causal && (r < c || (window > 0 && r - c >= window))) return NEG_INF;
  return x;
}

// ------------------------------------------------------------------ f32

constexpr int F32_THREADS = 256;  // 16 x 16 threads over the 64 x 64 tile

// Shared-memory layout (floats).  Row paddings keep the inner-loop reads
// free of bank conflicts: Q rows read by the two 16-thread halves of a
// warp sit 16 banks apart, and K rows read across tx differ by one bank.
template <int D> struct F32Smem {
  static constexpr int QS = D + 4;
  static constexpr int KS = D + 1;
  static constexpr int VS = D;
  static constexpr int SS = BN + 1;
  static constexpr int floats = BM * QS + BN * KS + BN * VS + BM * SS + 3 * BM;
  static constexpr size_t bytes = sizeof(float) * floats;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H, int Lq, int Lk,
                     Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal,
                     int window) {
  using S = F32Smem<D>;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * S::QS;
  float* Vs = Ks + BN * S::KS;
  float* Ss = Vs + BN * S::VS;
  float* m_s = Ss + BM * S::SS;
  float* l_s = m_s + BM;
  float* c_s = l_s + BM;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row0 = blockIdx.x * BM;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  // Q tile, pre-scaled as the TPU kernel does (qi = q * scale).
  for (int e = tid; e < BM * D; e += F32_THREADS) {
    const int r = e / D, c = e % D, gr = row0 + r;
    Qs[r * S::QS + c] = gr < Lq ? qb[gr * sq.l + c] * scale : 0.f;
  }
  if (tid < BM) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  int lo, hi;
  tile_range(row0, Lq, Lk, causal, window, &lo, &hi);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int col0 = t * BN;
    __syncthreads();  // the previous tile's K / V / P are consumed
    for (int e = tid; e < BN * D; e += F32_THREADS) {
      const int r = e / D, c = e % D, gc = col0 + r;
      const bool in = gc < Lk;  // rows past Lk are zero, never NaN garbage
      Ks[r * S::KS + c] = in ? kb[gc * sk.l + c] : 0.f;
      Vs[r * S::VS + c] = in ? vb[gc * sv.l + c] : 0.f;
    }
    __syncthreads();

    // Logits for rows ty*4+i, columns tx+16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * S::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * S::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty * 4 + i) * S::SS + tx + 16 * j] =
            masked(s[i][j], row0 + ty * 4 + i, col0 + tx + 16 * j, Lk, causal, window);
    __syncthreads();

    // Online softmax: each warp owns 8 rows; lanes hold 2 of 64 columns.
#pragma unroll
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int r = warp * (BM / 8) + rr;
      const float x0 = Ss[r * S::SS + lane], x1 = Ss[r * S::SS + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      Ss[r * S::SS + lane] = p0;
      Ss[r * S::SS + lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V for rows ty*4+i, columns tx+16j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * S::SS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * S::VS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  // O = acc / l, with the reference's l == 0 guard.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, gr = row0 + r;
    if (gr >= Lq) continue;
    const float l = l_s[r];
    const float denom = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[gr * so.l + tx + 16 * j] = acc[i][j] / denom;
  }
}

// ----------------------------------------------------------------- bf16

using bf16 = __nv_bfloat16;
constexpr int MMA_THREADS = 128;  // 4 warps x 16 q rows

template <int D> struct MmaSmem {
  static constexpr int RS = D + 8;  // padded row stride (elements)
  static constexpr size_t bytes = sizeof(bf16) * 3 * 64 * RS;
};

// D += A . B for one m16n8k16 tile (A row-major 16x16, B col-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 rows of a [L, D] slice (row stride `ld`) into shared memory, rows at
// or past L zero-filled; 16-byte copies when `vec`, else element by
// element.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int row0, int L,
                                          int vec) {
  constexpr int RS = MmaSmem<D>::RS, CH = D / 8;
  for (int e = threadIdx.x; e < 64 * CH; e += MMA_THREADS) {
    const int r = e / CH, c = (e % CH) * 8, gr = row0 + r;
    bf16* d = dst + r * RS + c;
    if (gr >= L) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src + gr * ld + c);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = src[gr * ld + c + i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Lq, int Lk,
                      Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal,
                      int window, int vec) {
  constexpr int RS = MmaSmem<D>::RS;
  constexpr int KT = D / 16;  // k-steps of Q.K^T over head_dim
  constexpr int NT = D / 8;   // n-tiles of P.V over head_dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + 64 * RS;
  bf16* Vs = Ks + 64 * RS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row0 = blockIdx.x * BM;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.l, row0, Lq, vec);
  __syncthreads();
  // This warp's 16 q rows as A fragments, for the whole KV sweep.
  const int qr = warp * 16 + g;
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const bf16* p = Qs + qr * RS + kk * 16 + t * 2;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * RS);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * RS + 8);
  }
  // Rows r_lo = row0 + qr and r_lo + 8: their running max (log2 domain),
  // this thread's partial sums of p, and the O accumulator.
  const int r_lo = row0 + qr;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float scale_log2 = scale * LOG2E;

  int lo, hi;
  tile_range(row0, Lq, Lk, causal, window, &lo, &hi);
  for (int tile = lo; tile < hi; ++tile) {
    const int col0 = tile * BN;
    __syncthreads();  // the previous tile's K / V are consumed
    load_tile<D>(Ks, kb, sk.l, col0, Lk, vec);
    load_tile<D>(Vs, vb, sv.l, col0, Lk, vec);
    __syncthreads();

    // S = Q . K^T: 8 n-tiles of 8 kv columns.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const bf16* p = Ks + (j * 8 + g) * RS + kk * 16 + t * 2;
        mma_bf16(s[j], qf[kk], ld32(p), ld32(p + 8));
      }
    }
    // Scale into the log2 domain, mask, and take the row maxima (a row's
    // 64 columns are spread over the 4 threads of a quad).
    float mx[2] = {neg_infinity(), neg_infinity()};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + (e >> 1) * 8, c = col0 + j * 8 + t * 2 + (e & 1);
        s[j][e] = masked(s[j][e] * scale_log2, r, c, Lk, causal, window);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }

    // O += P . V: the S accumulator of n-tiles 2kk, 2kk+1 is the A
    // fragment of k-step kk; V's B fragments pair rows t*2, t*2+1.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* p = Vs + (kk * 16 + t * 2) * RS + n * 8 + g;
        mma_bf16(acc[n], a, pack_bf16(p[0], p[RS]), pack_bf16(p[8 * RS], p[9 * RS]));
      }
    }
  }

  // O = acc / l with the reference's l == 0 guard; l sums over the quad.
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r_lo + i * 8;
    if (r >= Lq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      bf16* p = ob + r * so.l + n * 8 + t * 2;
      p[0] = __float2bfloat16_rn(acc[n][2 * i] / denom);
      p[1] = __float2bfloat16_rn(acc[n][2 * i + 1] / denom);
    }
  }
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.l % 8 == 0 &&
         s.h % 8 == 0;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
                       int Lk, Strides sq, Strides sk, Strides sv, Strides so, float scale,
                       int causal, int window, cudaStream_t stream) {
  auto kern = flash_fwd_f32_kernel<D>;
  const int smem = static_cast<int>(F32Smem<D>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Lq, Lk, sq, sk, sv, so, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Lq, int Lk, Strides sq, Strides sk, Strides sv, Strides so,
                        float scale, int causal, int window, cudaStream_t stream) {
  auto kern = flash_fwd_bf16_kernel<D>;
  const int smem = static_cast<int>(MmaSmem<D>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv);
  const dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Lq, Lk, sq, sk, sv, so, scale, causal, window, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// b / l / h axes of a [B, L, H, D] tensor whose D axis has unit stride.
// window <= 0 means no window.  Returns a cudaError_t (0 on success).
extern "C" int dkt_flash_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                             int B, int H, int Lq, int Lk, int D, long long sqb, long long sql,
                             long long sqh, long long skb, long long skl, long long skh,
                             long long svb, long long svl, long long svh, long long sob,
                             long long sol, long long soh, float scale, int causal, int window,
                             void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh}, so{sob, sol, soh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKT_LAUNCH(FN, DIM) \
  return static_cast<int>(FN<DIM>(q, k, v, o, B, H, Lq, Lk, sq, sk, sv, so, scale, causal, window, st))
  if (dtype == 0 && D == 64) DKT_LAUNCH(launch_f32, 64);
  if (dtype == 0 && D == 128) DKT_LAUNCH(launch_f32, 128);
  if (dtype == 1 && D == 64) DKT_LAUNCH(launch_bf16, 64);
  if (dtype == 1 && D == 128) DKT_LAUNCH(launch_bf16, 128);
#undef DKT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* dkt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
