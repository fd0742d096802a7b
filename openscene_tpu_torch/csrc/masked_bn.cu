// Training-mode masked BatchNorm, forward and backward, for Hopper (sm_90a),
// with an optional ReLU after it.
//
//   mean, var = batch statistics of x over the valid rows [0, num) (biased)
//   inv = 1 / sqrt(var + eps)
//   xhat = (x - mean) * inv,   y = xhat * gamma + beta,   out = relu?(y)
//   out = 0 at the padded rows [num, cap)
//   running_mean, running_var moved by momentum towards mean and the
//   unbiased variance var * n / max(n - 1, 1), in place (n = max(num, 1))
//
//   backward, g = dy (times y > 0 with the ReLU) on the valid rows:
//   dbeta = sum g,   dgamma = sum g * xhat
//   dx = gamma * inv * (g - dbeta / n - xhat * dgamma / n),  0 at padded rows
//
// x, out, dy, dx: (cap, C) row-major, bf16 or fp32 (dy may have a row
// stride ldy >= C); gamma, beta, the running buffers and every statistic
// fp32.  Every sum is fp32.
//
// Replaces no Pallas TPU kernel: the JAX package leaves BatchNorm to XLA,
// which fuses its elementwise ops.  On the card the same function ran as
// about 10 forward and 20 backward PyTorch ops with fp32 (cap, C)
// temporaries (sparse/ops.py:MaskedBatchNormFn, kept as the CPU path and
// the oracle).
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes.  A forward and a backward
// need at least 5 passes over (num, C) in x's dtype: x read and out written
// forward, x and dy read and dx written backward
// (benchmark/counts_bottleneck.py:norm_ms).  This design makes 3 forward
// passes (x read for the statistics, x read and out written) and 5 backward
// (x and dy read for the sums, x and dy read and dx written), so at best
// 5/8, about 62% of that bound; the padded rows add their writes.  What it
// does about the bound: it reads x in its own dtype (16-byte vectors where
// C and the pointers allow), keeps every fp32 intermediate in registers,
// recomputes xhat and the ReLU's mask from x and four per-channel numbers
// rather than saving any (cap, C) tensor, and makes 3 launches each way.
//
// Design.
//   * One algorithm for every width.  A thread owns V channels (8 bf16 or
//     4 fp32, one 16-byte vector; 1 where C or a pointer does not allow
//     it); a block of 256 threads is tx channel groups by 256 / tx row
//     lanes, and grid.x tiles C when it has more than 32 groups.  The host
//     picks tx from C and the number of row splits (grid.y) from num, so
//     that every level gives the card about four blocks an SM
//     (sparse/batch_norm.py:tiling).
//   * Statistics: each thread keeps Welford's (count, mean, M2) over its
//     rows of the split (no sum of squares: its cancellation is worse than
//     a two-pass variance), the row lanes are merged by Chan's formula in a
//     fixed tree in shared memory, and each split writes its partials.
//     A finalize launch merges the splits of each channel in a fixed order
//     (8 lanes of splits, then a fixed tree), writes mean and inv and moves
//     the running buffers.  No atomics: the result is the same bits from
//     run to run.
//   * Backward sums: the same shape with plain fp32 sums of g and g * xhat,
//     and the same fixed-order finalize into dgamma and dbeta.
//   * The elementwise passes (out, dx) walk every row of [0, cap) in a
//     grid-stride loop, four rows a thread in flight, and write exact zeros
//     at the padded rows; xhat and y are computed by the same rounded
//     intrinsics in both directions, so the backward's mask is the
//     forward's.
//
// The launchers allocate nothing (the wrapper passes the (2, splits, C)
// partials), run on the caller's stream, do not synchronise, and return
// cudaGetLastError() of their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int UNROLL = 4;      // rows a thread has in flight
constexpr int FIN_CH = 32;     // finalize: channels a block
constexpr int FIN_LANES = THREADS / FIN_CH;  // finalize: lanes of splits

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements: one 16-byte vector, or V scalar loads for V = 1
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f<T>(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f<T>(v[i]);
  }
}

// the same rounded operations forward and backward (no contraction), so
// the backward's y > 0 is the forward's
__device__ __forceinline__ float xhat_of(float x, float mean, float inv) {
  return __fmul_rn(__fsub_rn(x, mean), inv);
}
__device__ __forceinline__ float affine(float xh, float gamma, float beta) {
  return __fmaf_rn(xh, gamma, beta);
}

// Chan's merge of (nb, mb, qb) into (n, m, q): counts, means, M2
__device__ __forceinline__ void chan(float& n, float& m, float& q, float nb,
                                     float mb, float qb) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    m = mb;
    q = qb;
    return;
  }
  const float nn = n + nb;
  const float w = nb / nn;
  const float d = mb - m;
  m = m + d * w;
  q = q + qb + d * d * n * w;
  n = nn;
}

struct Tile {
  int cg, rl, rlanes, g;
  bool on;  // a channel group of C and a row lane of the block
};

__device__ __forceinline__ Tile tile_of(int tx, int groups) {
  Tile t;
  t.cg = threadIdx.x % tx;
  t.rl = threadIdx.x / tx;
  t.rlanes = THREADS / tx;
  t.g = blockIdx.x * tx + t.cg;
  t.on = t.rl < t.rlanes && t.g < groups;
  return t;
}

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the rows of split s: [s * rps, min(num, (s + 1) * rps))
__device__ __forceinline__ float split_count(int s, int rps, int num) {
  return (float)max(0, min(rps, num - s * rps));
}

// ---- forward pass 1: Welford partials of each split -------------------------
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int c,
                int num, int tx, int rps) {
  __shared__ float sh_n[THREADS];
  __shared__ float sh_m[V * THREADS];
  __shared__ float sh_q[V * THREADS];
  const Tile t = tile_of(tx, c / V);
  const int r0 = blockIdx.y * rps;
  const int r1 = min(num, r0 + rps);
  float n = 0.f, m[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = q[i] = 0.f;
  if (t.on) {
    const T* xc = x + (size_t)t.g * V;
    for (int r = r0 + t.rl; r < r1; r += UNROLL * t.rlanes) {
      float v[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int rr = r + u * t.rlanes;
        if (rr < r1) load_vec<T, V>(xc + (size_t)rr * c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * t.rlanes < r1) {
          n += 1.f;
          const float rn = 1.f / n;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float d = v[u][i] - m[i];
            m[i] += d * rn;
            q[i] += d * (v[u][i] - m[i]);
          }
        }
      }
    }
  }
  // the row lanes merged in a fixed tree
  const int slot = threadIdx.x;
  sh_n[slot] = n;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh_m[i * THREADS + slot] = m[i];
    sh_q[i * THREADS + slot] = q[i];
  }
  for (int s = pow2_ceil(t.rlanes) / 2; s >= 1; s >>= 1) {
    __syncthreads();
    if (t.on && t.rl < s && t.rl + s < t.rlanes) {
      const int o = slot + s * tx;
      const float nb = sh_n[o];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float ni = n;  // the lanes' counts are the same for every channel
        chan(ni, m[i], q[i], nb, sh_m[i * THREADS + o], sh_q[i * THREADS + o]);
        sh_m[i * THREADS + slot] = m[i];
        sh_q[i * THREADS + slot] = q[i];
      }
      n += nb;
      sh_n[slot] = n;
    }
  }
  if (t.on && t.rl == 0) {
    const size_t base = (size_t)blockIdx.y * c + (size_t)t.g * V;
    const size_t plane = (size_t)gridDim.y * c;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[base + i] = m[i];
      part[plane + base + i] = q[i];
    }
  }
}

// ---- backward pass 1: sums of g and g * xhat of each split ------------------
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy, int ldy,
                   const float* __restrict__ stats,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ part,
                   int c, int num, int tx, int rps) {
  __shared__ float sh_a[V * THREADS];
  __shared__ float sh_b[V * THREADS];
  const Tile t = tile_of(tx, c / V);
  const int r0 = blockIdx.y * rps;
  const int r1 = min(num, r0 + rps);
  float sg[V], sgx[V], mean[V], inv[V], ga[V], be[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sg[i] = sgx[i] = 0.f;
  if (t.on) {
    const int c0 = t.g * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = stats[c0 + i];
      inv[i] = stats[c + c0 + i];
      ga[i] = gamma[c0 + i];
      be[i] = beta[c0 + i];
    }
    for (int r = r0 + t.rl; r < r1; r += UNROLL * t.rlanes) {
      float v[UNROLL][V], d[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int rr = r + u * t.rlanes;
        if (rr < r1) {
          load_vec<T, V>(x + (size_t)rr * c + c0, v[u]);
          load_vec<T, V>(dy + (size_t)rr * ldy + c0, d[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * t.rlanes < r1) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xh = xhat_of(v[u][i], mean[i], inv[i]);
            float g = d[u][i];
            if (RELU && !(affine(xh, ga[i], be[i]) > 0.f)) g = 0.f;
            sg[i] += g;
            sgx[i] += g * xh;
          }
        }
      }
    }
  }
  const int slot = threadIdx.x;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh_a[i * THREADS + slot] = sg[i];
    sh_b[i * THREADS + slot] = sgx[i];
  }
  for (int s = pow2_ceil(t.rlanes) / 2; s >= 1; s >>= 1) {
    __syncthreads();
    if (t.on && t.rl < s && t.rl + s < t.rlanes) {
      const int o = slot + s * tx;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sg[i] += sh_a[i * THREADS + o];
        sgx[i] += sh_b[i * THREADS + o];
        sh_a[i * THREADS + slot] = sg[i];
        sh_b[i * THREADS + slot] = sgx[i];
      }
    }
  }
  if (t.on && t.rl == 0) {
    const size_t base = (size_t)blockIdx.y * c + (size_t)t.g * V;
    const size_t plane = (size_t)gridDim.y * c;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[base + i] = sg[i];
      part[plane + base + i] = sgx[i];
    }
  }
}

// ---- pass 2 of both directions: the splits merged in a fixed order ----------
// STATS: Chan's merge into mean and inv (stats = [mean | inv]) and the
// running buffers moved in place.  Otherwise plain sums into
// out = [dbeta | dgamma].
template <bool STATS>
__global__ void __launch_bounds__(THREADS)
bn_finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                   float* __restrict__ running_mean,
                   float* __restrict__ running_var, int c, int num,
                   int splits, int rps, float momentum, float eps) {
  __shared__ float sh_n[THREADS];
  __shared__ float sh_a[THREADS];
  __shared__ float sh_b[THREADS];
  const int lane = threadIdx.x % FIN_CH;
  const int sl = threadIdx.x / FIN_CH;
  const int ch = blockIdx.x * FIN_CH + lane;
  const size_t plane = (size_t)splits * c;
  float n = 0.f, a = 0.f, b = 0.f;
  if (ch < c) {
    for (int s = sl; s < splits; s += FIN_LANES) {
      const float pa = part[(size_t)s * c + ch];
      const float pb = part[plane + (size_t)s * c + ch];
      if (STATS) {
        chan(n, a, b, split_count(s, rps, num), pa, pb);
      } else {
        a += pa;
        b += pb;
      }
    }
  }
  sh_n[threadIdx.x] = n;
  sh_a[threadIdx.x] = a;
  sh_b[threadIdx.x] = b;
  for (int s = FIN_LANES / 2; s >= 1; s >>= 1) {
    __syncthreads();
    if (sl < s) {
      const int o = threadIdx.x + s * FIN_CH;
      if (STATS) {
        chan(n, a, b, sh_n[o], sh_a[o], sh_b[o]);
      } else {
        a += sh_a[o];
        b += sh_b[o];
      }
      sh_n[threadIdx.x] = n;
      sh_a[threadIdx.x] = a;
      sh_b[threadIdx.x] = b;
    }
  }
  if (sl != 0 || ch >= c) return;
  if (STATS) {
    const float nf = (float)max(num, 1);
    const float var = b / nf;  // biased; 0 without rows
    out[ch] = a;
    out[c + ch] = 1.f / sqrtf(var + eps);
    const float unbiased = var * nf / fmaxf(nf - 1.f, 1.f);
    running_mean[ch] = (1.f - momentum) * running_mean[ch] + momentum * a;
    running_var[ch] = (1.f - momentum) * running_var[ch] + momentum * unbiased;
  } else {
    out[ch] = a;
    out[c + ch] = b;
  }
}

// ---- forward pass 3: out = relu?(xhat * gamma + beta), 0 at padded rows -----
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_normalise_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const float* __restrict__ stats,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, int c, int num, int cap,
                    int tx) {
  const Tile t = tile_of(tx, c / V);
  if (!t.on) return;
  const int c0 = t.g * V;
  float mean[V], inv[V], ga[V], be[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = stats[c0 + i];
    inv[i] = stats[c + c0 + i];
    ga[i] = gamma[c0 + i];
    be[i] = beta[c0 + i];
  }
  const int step = gridDim.y * t.rlanes;
  for (int r = blockIdx.y * t.rlanes + t.rl; r < cap; r += UNROLL * step) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * step;
      if (rr < num) load_vec<T, V>(x + (size_t)rr * c + c0, v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * step;
      if (rr >= cap) continue;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float y = 0.f;
        if (rr < num) {
          y = affine(xhat_of(v[u][i], mean[i], inv[i]), ga[i], be[i]);
          if (RELU && !(y > 0.f)) y = 0.f;
        }
        o[i] = y;
      }
      store_vec<T, V>(out + (size_t)rr * c + c0, o);
    }
  }
}

// ---- backward pass 3: dx, 0 at padded rows ----------------------------------
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, int ldy,
             const float* __restrict__ stats, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ sums,
             T* __restrict__ dx, int c, int num, int cap, int tx) {
  const Tile t = tile_of(tx, c / V);
  if (!t.on) return;
  const int c0 = t.g * V;
  const float rn = 1.f / (float)max(num, 1);
  float mean[V], inv[V], ga[V], be[V], k1[V], k2[V], sc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = stats[c0 + i];
    inv[i] = stats[c + c0 + i];
    ga[i] = gamma[c0 + i];
    be[i] = beta[c0 + i];
    k1[i] = sums[c0 + i] * rn;      // dbeta / n
    k2[i] = sums[c + c0 + i] * rn;  // dgamma / n
    sc[i] = ga[i] * inv[i];
  }
  const int step = gridDim.y * t.rlanes;
  for (int r = blockIdx.y * t.rlanes + t.rl; r < cap; r += UNROLL * step) {
    float v[UNROLL][V], d[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * step;
      if (rr < num) {
        load_vec<T, V>(x + (size_t)rr * c + c0, v[u]);
        load_vec<T, V>(dy + (size_t)rr * ldy + c0, d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * step;
      if (rr >= cap) continue;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float res = 0.f;
        if (rr < num) {
          const float xh = xhat_of(v[u][i], mean[i], inv[i]);
          float g = d[u][i];
          if (RELU && !(affine(xh, ga[i], be[i]) > 0.f)) g = 0.f;
          res = sc[i] * (g - k1[i] - xh * k2[i]);
        }
        o[i] = res;
      }
      store_vec<T, V>(dx + (size_t)rr * c + c0, o);
    }
  }
}

struct Grid {
  dim3 reduce, elementwise, finalize;
};

Grid grids(int c, int v, int tx, int splits, int blocks) {
  const int nct = (c / v + tx - 1) / tx;
  return {dim3(nct, splits), dim3(nct, blocks),
          dim3((c + FIN_CH - 1) / FIN_CH)};
}

bool bad_shape(int c, int v, int tx, int splits, int rps, int blocks,
               int num, int cap) {
  return c <= 0 || c % v || tx <= 0 || tx > THREADS || splits <= 0 ||
         splits > 65535 || rps <= 0 || (long long)splits * rps < num ||
         blocks <= 0 || blocks > 65535 || num < 0 || num > cap;
}

template <typename T, int V>
int fwd_launch(const void* x, void* out, const void* gamma, const void* beta,
               void* running_mean, void* running_var, void* stats, void* part,
               int relu, int cap, int num, int c, int tx, int splits, int rps,
               int blocks, float momentum, float eps, cudaStream_t st) {
  const Grid gr = grids(c, V, tx, splits, blocks);
  const T* xt = static_cast<const T*>(x);
  float* pt = static_cast<float*>(part);
  float* sv = static_cast<float*>(stats);
  bn_stats_kernel<T, V><<<gr.reduce, THREADS, 0, st>>>(xt, pt, c, num, tx,
                                                       rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_finalize_kernel<true><<<gr.finalize, THREADS, 0, st>>>(
      pt, sv, static_cast<float*>(running_mean),
      static_cast<float*>(running_var), c, num, splits, rps, momentum, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* o = static_cast<T*>(out);
  if (relu)
    bn_normalise_kernel<T, V, true><<<gr.elementwise, THREADS, 0, st>>>(
        xt, o, sv, g, b, c, num, cap, tx);
  else
    bn_normalise_kernel<T, V, false><<<gr.elementwise, THREADS, 0, st>>>(
        xt, o, sv, g, b, c, num, cap, tx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool RELU>
int bwd_launch(const void* x, const void* dy, int ldy, const void* stats,
               const void* gamma, const void* beta, void* dx, void* sums,
               void* part, int cap, int num, int c, int tx, int splits,
               int rps, int blocks, cudaStream_t st) {
  const Grid gr = grids(c, V, tx, splits, blocks);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  const float* sv = static_cast<const float*>(stats);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* pt = static_cast<float*>(part);
  float* su = static_cast<float*>(sums);
  bn_bwd_sums_kernel<T, V, RELU><<<gr.reduce, THREADS, 0, st>>>(
      xt, dt, ldy, sv, g, b, pt, c, num, tx, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_finalize_kernel<false><<<gr.finalize, THREADS, 0, st>>>(
      pt, su, nullptr, nullptr, c, num, splits, rps, 0.f, 0.f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_dx_kernel<T, V, RELU><<<gr.elementwise, THREADS, 0, st>>>(
      xt, dt, ldy, sv, g, b, su, static_cast<T*>(dx), c, num, cap, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16; vec: 16-byte vectors (C a multiple of 16 / size,
// pointers and row strides aligned) or scalars.  stats: (2, C) fp32 out,
// [mean | inv]; part: (2, splits, C) fp32 scratch.
extern "C" int masked_bn_fwd(const void* x, void* out, const void* gamma,
                             const void* beta, void* running_mean,
                             void* running_var, void* stats, void* part,
                             int dtype, int vec, int relu, int cap, int num,
                             int c, int tx, int splits, int rps, int blocks,
                             float momentum, float eps, void* stream) {
  const int v = vec ? (dtype ? 8 : 4) : 1;
  if (bad_shape(c, v, tx, splits, rps, blocks, num, cap) || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BN_FWD(T, V)                                                        \
  fwd_launch<T, V>(x, out, gamma, beta, running_mean, running_var, stats, \
                   part, relu, cap, num, c, tx, splits, rps, blocks,      \
                   momentum, eps, st)
  if (dtype) return vec ? BN_FWD(bf16, 8) : BN_FWD(bf16, 1);
  return vec ? BN_FWD(float, 4) : BN_FWD(float, 1);
#undef BN_FWD
}

// sums: (2, C) fp32 out, [dbeta | dgamma]; dy's rows ldy elements apart.
extern "C" int masked_bn_bwd(const void* x, const void* dy, int ldy,
                             const void* stats, const void* gamma,
                             const void* beta, void* dx, void* sums,
                             void* part, int dtype, int vec, int relu,
                             int cap, int num, int c, int tx, int splits,
                             int rps, int blocks, void* stream) {
  const int v = vec ? (dtype ? 8 : 4) : 1;
  if (bad_shape(c, v, tx, splits, rps, blocks, num, cap) || ldy < c ||
      ldy % v || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BN_BWD(T, V, R)                                                   \
  bwd_launch<T, V, R>(x, dy, ldy, stats, gamma, beta, dx, sums, part, cap, \
                      num, c, tx, splits, rps, blocks, st)
  if (dtype) {
    if (vec) return relu ? BN_BWD(bf16, 8, true) : BN_BWD(bf16, 8, false);
    return relu ? BN_BWD(bf16, 1, true) : BN_BWD(bf16, 1, false);
  }
  if (vec) return relu ? BN_BWD(float, 4, true) : BN_BWD(float, 4, false);
  return relu ? BN_BWD(float, 1, true) : BN_BWD(float, 1, false);
#undef BN_BWD
}
