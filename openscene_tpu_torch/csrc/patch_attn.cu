// Serialized patch attention of Point Transformer V3 at head dimension 16,
// for Hopper (sm_90a): softmax(scale * Q K^T) V within each patch of a
// varlen layout, bf16 operands, fp32 products, softmax and sums.
//
// Layout (sparse/patch_attn.py):
//   qkv   (rows, 3C) bf16, row-major: head h's q, k and v are the 16
//         columns at h*16, C + h*16 and 2C + h*16 of a row;
//   out   (rows, C) bf16, head h at columns h*16;
//   lse   (rows, H) fp32, the natural log-sum-exp of each row's scaled
//         scores, which the backward recomputes P from;
//   cu    (n_patches + 1,) int32, ascending: patch p holds the rows
//         [cu[p], cu[p+1]), at most max_len of them; an empty patch
//         (cu[p] == cu[p+1]) does nothing.  Rows outside every patch
//         ([0, cu[0]) and [cu[n_patches], rows)) are written as zeros in
//         out, lse and dqkv, so the caller need not clear the buffers.
//
// Every kernel is one CTA of 4 warps per (patch, tile of 64 rows, head),
// and one more column of CTAs (blockIdx.x == n_patches) that writes the
// zeros of the rows outside every patch.
// A warp owns 16 rows of the tile as mma.sync m16n8k16 A fragments and
// walks the patch's other side 64 rows a step through shared memory: the
// rows row-major (B fragments of products that reduce over the 16 head
// dimensions) and transposed (B fragments of products that reduce over the
// 64 rows), each read by 32-bit loads free of bank conflicts.  The 16 x 64
// score tile of a warp stays in registers; its fp32 accumulator layout is
// the A fragment layout of the next product once packed to bf16, so P and
// dS never touch shared memory.
//   fwd: online softmax (exp2 of scores pre-scaled by scale * log2 e), O
//        and the log-sum-exp;
//   dq:  P from the log-sum-exp, dP = dO V^T, dS = P (dP - D),
//        dQ = scale dS K (D = rowsum(dO * O), made by the caller);
//   dkv: the transposed products for a tile of keys over all the patch's
//        queries: dV = P^T dO, dK = scale dS^T Q.
// The backward recomputes P in both of its kernels and so writes every
// gradient once, with no atomics: deterministic.

#include "mma_sm90.cuh"

#include <math_constants.h>

namespace pa {

using bf16 = __nv_bfloat16;
constexpr int D = 16;          // head dimension
constexpr int TILE = 64;       // rows of a CTA (4 warps x 16), rows a step
constexpr int THREADS = 128;
constexpr int LDR = D + 8;     // row-major tile stride (bf16): 12 words
constexpr int LDT = TILE + 8;  // transposed tile stride (bf16): 36 words
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// the 16 x 16 A fragment of rows [row0, row0 + 16) of a row-major slice
// (row stride ld elements); rows at or past `end` read as zeros
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* base,
                                       long ld, int row0, int end,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
  a[0] = r0 < end ? ld32(base + r0 * ld + 2 * t) : 0u;
  a[1] = r1 < end ? ld32(base + r1 * ld + 2 * t) : 0u;
  a[2] = r0 < end ? ld32(base + r0 * ld + 2 * t + 8) : 0u;
  a[3] = r1 < end ? ld32(base + r1 * ld + 2 * t + 8) : 0u;
}

// rows [row0, row0 + 64) of a slice into shared memory, row-major into
// `rm` ([64][LDR]) and/or transposed into `tr` ([16][LDT]); rows at or
// past `end` as zeros.  One 16-byte vector a thread.
__device__ __forceinline__ void load_tile(bf16* rm, bf16* tr,
                                          const bf16* base, long ld,
                                          int row0, int end, int tid) {
  const int r = tid >> 1, h = (tid & 1) * 8;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row0 + r < end)
    v = *reinterpret_cast<const uint4*>(base + (long)(row0 + r) * ld + h);
  if (rm) *reinterpret_cast<uint4*>(rm + r * LDR + h) = v;
  if (tr) {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) tr[(h + j) * LDT + r] = e[j];
  }
}

// s[n] (16 x 8, columns 8n..8n+7 of the step) = A * B^T, B the 64 rows of
// `rm` (row-major, the 16 head dimensions contiguous)
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const unsigned (&a)[4],
                                       const bf16* rm, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    const bf16* b = rm + (8 * n + g) * LDR + 2 * t;
    gg::mma_bf16(s[n], a, ld32(b), ld32(b + 8));
  }
}

// acc[d] (16 x 8, head dimensions 8d..8d+7) += P * B, P the 16 x 64 tile
// in score layout, B the step's 64 rows stored transposed in `tr`
__device__ __forceinline__ void accumulate(float (&acc)[2][4],
                                           const float (&p)[8][4],
                                           const bf16* tr, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned a[4] = {pack(p[2 * j][0], p[2 * j][1]),
                           pack(p[2 * j][2], p[2 * j][3]),
                           pack(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const bf16* b = tr + (8 * d + g) * LDT + 16 * j + 2 * t;
      gg::mma_bf16(acc[d], a, ld32(b), ld32(b + 8));
    }
  }
}

// rows g and g + 8 of a 16 x 16 fp32 tile (scaled) into a row-major bf16
// slice; rows at or past `end` are not written
__device__ __forceinline__ void store_rows(bf16* base, long ld, int row0,
                                           int end, const float (&acc)[2][4],
                                           float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= end) continue;
#pragma unroll
    for (int d = 0; d < 2; ++d)
      *reinterpret_cast<unsigned*>(base + r * ld + 8 * d + 2 * t) =
          pack(acc[d][2 * half] * scale, acc[d][2 * half + 1] * scale);
  }
}

// The zeros of the rows outside the n patches, [0, cu[0]) and
// [cu[n], rows), in head h's `parts` 16-column slices (at columns
// h*16 + j*c) of a row-major bf16 buffer of row stride ld, and in head h's
// fp32 entry of `f` (rows x heads) when given.  The grid's y blocks of the
// extra column share the rows; one row a thread, 32-byte stores.
__device__ __forceinline__ void zero_outside(bf16* a, long ld, int parts,
                                             int c, float* f, int heads,
                                             int h, const int* cu, int n,
                                             int rows) {
  const int lo = cu[0], hi = cu[n];
  const long outside = (long)rows - (hi - lo);
  const long stride = (long)gridDim.y * THREADS;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (long i = (long)blockIdx.y * THREADS + threadIdx.x; i < outside;
       i += stride) {
    const long r = i < lo ? i : hi + (i - lo);
    for (int j = 0; j < parts; ++j) {
      uint4* dst = reinterpret_cast<uint4*>(a + r * ld + (long)j * c +
                                            h * D);
      dst[0] = z;
      dst[1] = z;
    }
    if (f) f[r * heads + h] = 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
               float* __restrict__ lse, const int* __restrict__ cu, int c,
               int heads, int rows, float scale_log2) {
  const int p = blockIdx.x, h = blockIdx.z;
  if (p == gridDim.x - 1) {
    zero_outside(out, c, 1, c, lse, heads, h, cu, p, rows);
    return;
  }
  const int start = cu[p], end = cu[p + 1];
  const int tile0 = start + blockIdx.y * TILE;
  if (tile0 >= end) return;
  __shared__ __align__(16) unsigned short ks_s[TILE * LDR];
  bf16* ks = reinterpret_cast<bf16*>(ks_s);
  __shared__ __align__(16) unsigned short vt_s[D * LDT];
  bf16* vt = reinterpret_cast<bf16*>(vt_s);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long ld = 3L * c;
  const bf16* q = qkv + h * D;
  const bf16* k = qkv + c + h * D;
  const bf16* v = qkv + 2 * c + h * D;
  const int row0 = tile0 + 16 * w;
  unsigned qa[4];
  load_a(qa, q, ld, row0, end, lane);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  float o[2][4] = {};
  for (int k0 = start; k0 < end; k0 += TILE) {
    const int nk = min(TILE, end - k0);
    __syncthreads();
    load_tile(ks, nullptr, k, ld, k0, end, tid);
    load_tile(nullptr, vt, v, ld, k0, end, tid);
    __syncthreads();
    float s[8][4];
    scores(s, qa, ks, lane);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        s[n][e] = col < nk ? s[n][e] * scale_log2 : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);  // finite: nk >= 1
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int d = 0; d < 2; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] *= alpha[e >> 1];
    accumulate(o, s, vt, lane);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= end) continue;
    const float inv = 1.0f / l[half];
#pragma unroll
    for (int d = 0; d < 2; ++d)
      *reinterpret_cast<unsigned*>(out + (long)r * c + h * D + 8 * d +
                                   2 * t) =
          pack(o[d][2 * half] * inv, o[d][2 * half + 1] * inv);
    if (t == 0) lse[(long)r * heads + h] = (m[half] + log2f(l[half])) * LN2;
  }
}

__global__ void __launch_bounds__(THREADS)
    dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dqkv, const int* __restrict__ cu, int c,
              int heads, int rows, float scale_log2, float scale) {
  const int p = blockIdx.x, h = blockIdx.z;
  if (p == gridDim.x - 1) {  // dq, dk and dv of the rows outside
    zero_outside(dqkv, 3L * c, 3, c, nullptr, heads, h, cu, p, rows);
    return;
  }
  const int start = cu[p], end = cu[p + 1];
  const int tile0 = start + blockIdx.y * TILE;
  if (tile0 >= end) return;
  __shared__ __align__(16) unsigned short ks_s[TILE * LDR];
  bf16* ks = reinterpret_cast<bf16*>(ks_s);
  __shared__ __align__(16) unsigned short vs_s[TILE * LDR];
  bf16* vs = reinterpret_cast<bf16*>(vs_s);
  __shared__ __align__(16) unsigned short kt_s[D * LDT];
  bf16* kt = reinterpret_cast<bf16*>(kt_s);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long ld = 3L * c;
  const bf16* q = qkv + h * D;
  const bf16* k = qkv + c + h * D;
  const bf16* v = qkv + 2 * c + h * D;
  const int row0 = tile0 + 16 * w;
  unsigned qa[4], da[4];
  load_a(qa, q, ld, row0, end, lane);
  load_a(da, dout + h * D, c, row0, end, lane);
  float lrow[2], drow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    lrow[half] = r < end ? lse[(long)r * heads + h] * LOG2E : 0.0f;
    drow[half] = r < end ? delta[(long)r * heads + h] : 0.0f;
  }
  float dq[2][4] = {};
  for (int k0 = start; k0 < end; k0 += TILE) {
    const int nk = min(TILE, end - k0);
    __syncthreads();
    load_tile(ks, kt, k, ld, k0, end, tid);
    load_tile(vs, nullptr, v, ld, k0, end, tid);
    __syncthreads();
    float s[8][4], dp[8][4];
    scores(s, qa, ks, lane);
    scores(dp, da, vs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const float pr =
            col < nk ? exp2f(s[n][e] * scale_log2 - lrow[e >> 1]) : 0.0f;
        s[n][e] = pr * (dp[n][e] - drow[e >> 1]);
      }
    accumulate(dq, s, kt, lane);
  }
  store_rows(dqkv + h * D, ld, row0, end, dq, scale, lane);
}

__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dqkv,
               const int* __restrict__ cu, int c, int heads,
               float scale_log2, float scale) {
  const int p = blockIdx.x, h = blockIdx.z;
  if (p == gridDim.x - 1) return;  // the dq kernel zeroes the outside
  const int start = cu[p], end = cu[p + 1];
  const int tile0 = start + blockIdx.y * TILE;
  if (tile0 >= end) return;
  __shared__ __align__(16) unsigned short qs_s[TILE * LDR];
  bf16* qs = reinterpret_cast<bf16*>(qs_s);
  __shared__ __align__(16) unsigned short ds_s[TILE * LDR];
  bf16* ds = reinterpret_cast<bf16*>(ds_s);
  __shared__ __align__(16) unsigned short qt_s[D * LDT];
  bf16* qt = reinterpret_cast<bf16*>(qt_s);
  __shared__ __align__(16) unsigned short dt_s[D * LDT];
  bf16* dt = reinterpret_cast<bf16*>(dt_s);
  __shared__ float ls[TILE], dl[TILE];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int t = lane & 3;
  const long ld = 3L * c;
  const bf16* q = qkv + h * D;
  const bf16* k = qkv + c + h * D;
  const bf16* v = qkv + 2 * c + h * D;
  const bf16* dq = dout + h * D;
  const int row0 = tile0 + 16 * w;  // this warp's 16 keys
  unsigned ka[4], va[4];
  load_a(ka, k, ld, row0, end, lane);
  load_a(va, v, ld, row0, end, lane);
  float dk[2][4] = {}, dv[2][4] = {};
  for (int q0 = start; q0 < end; q0 += TILE) {
    const int nq = min(TILE, end - q0);
    __syncthreads();
    load_tile(qs, qt, q, ld, q0, end, tid);
    load_tile(ds, dt, dq, c, q0, end, tid);
    if (tid < TILE) {
      const int r = q0 + tid;
      ls[tid] = r < end ? lse[(long)r * heads + h] * LOG2E : 0.0f;
      dl[tid] = r < end ? delta[(long)r * heads + h] : 0.0f;
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    scores(s, ka, qs, lane);   // S^T: this warp's keys x the step's queries
    scores(dp, va, ds, lane);  // dP^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        s[n][e] = col < nq ? exp2f(s[n][e] * scale_log2 - ls[col]) : 0.0f;
        dp[n][e] = s[n][e] * (dp[n][e] - dl[col]);
      }
    accumulate(dv, s, dt, lane);
    accumulate(dk, dp, qt, lane);
  }
  store_rows(dqkv + c + h * D, ld, row0, end, dk, scale, lane);
  store_rows(dqkv + 2 * c + h * D, ld, row0, end, dv, 1.0f, lane);
}

bool bad(int n_patches, int max_len, int c, int heads, int rows) {
  return n_patches < 0 || n_patches > 2147483647 / 2 || max_len < 1 ||
         heads < 1 || heads > 65535 || c != heads * D || rows < 0;
}

}  // namespace pa

// qkv (rows, 3C), out (rows, C) bf16; lse (rows, H) fp32; cu (n_patches +
// 1) int32 on the card, within [0, rows]; every patch at most max_len
// rows.  1 launch.
extern "C" int patch_attn_fwd(const void* qkv, void* out, void* lse,
                              const void* cu, int n_patches, int max_len,
                              int c, int heads, int rows, float scale,
                              void* stream) {
  if (pa::bad(n_patches, max_len, c, heads, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const dim3 grid(n_patches + 1, (max_len + pa::TILE - 1) / pa::TILE,
                  heads);
  pa::fwd_kernel<<<grid, pa::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const pa::bf16*>(qkv), static_cast<pa::bf16*>(out),
      static_cast<float*>(lse), static_cast<const int*>(cu), c, heads, rows,
      scale * pa::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// dout (rows, C) bf16 contiguous; delta (rows, H) fp32 = rowsum(dO * O)
// per head; dqkv (rows, 3C) bf16, every row written (zeros outside every
// patch).  2 launches.
extern "C" int patch_attn_bwd(const void* qkv, const void* dout,
                              const void* lse, const void* delta, void* dqkv,
                              const void* cu, int n_patches, int max_len,
                              int c, int heads, int rows, float scale,
                              void* stream) {
  if (pa::bad(n_patches, max_len, c, heads, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const dim3 grid(n_patches + 1, (max_len + pa::TILE - 1) / pa::TILE,
                  heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pa::dq_kernel<<<grid, pa::THREADS, 0, st>>>(
      static_cast<const pa::bf16*>(qkv), static_cast<const pa::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<pa::bf16*>(dqkv), static_cast<const int*>(cu), c, heads,
      rows, scale * pa::LOG2E, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pa::dkv_kernel<<<grid, pa::THREADS, 0, st>>>(
      static_cast<const pa::bf16*>(qkv), static_cast<const pa::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<pa::bf16*>(dqkv), static_cast<const int*>(cu), c, heads,
      scale * pa::LOG2E, scale);
  return static_cast<int>(cudaGetLastError());
}
