// Weight gradient of the sparse convolutions, for Hopper (sm_90a): a product
// whose reduction runs over the rows, with one operand gathered.
//
//   dw[k] = sum_{r < rows} a[r, :]^T  b[idx[k, r], :]          k in [0, K)
//
// a: (rows, Ca) bf16 row-major; b: (rows_b, Cb) bf16 row-major; idx: (K, rows)
// int32 (a negative entry contributes zero); dw: (K, Ca, Cb) fp32.  Every
// product of two bf16 values is exact in fp32 and the sums are kept in fp32.
//
// Together with the kernels that compute each backward's input gradient dx
// (csrc/gather_gemm_fwd.cu, csrc/up_conv_fwd.cu), this source replaces
// three Pallas TPU kernels of the JAX package:
//   * openscene_tpu/sparse/pallas_conv.py:447 make_bwd_kernel (k=3 stencil
//     backward, op _wconv_bwd :695-762).  With G_k = g[fwd[k]]:
//       dx = sum_k G_k @ W[flip k]^T       gather_gemm_fwd(g, W[flip]^T, fwd)
//       dW[flip k] = x^T @ G_k             this kernel, a = x, b = g, idx = fwd
//   * openscene_tpu/sparse/pallas_edge.py:374 make_down_bwd_kernel (up-conv
//     backward over parents, op _up_bwd_core :795-834):
//       dx[p] = sum_k g[fwd[k,p]] @ W[k]^T gather_gemm_fwd(g, W, down.fwd,
//                                          the edge's skip plan, w_nk)
//       dW[k] = sum over the children c of offset k of x[parent(c)]^T g[c]
//                                          this kernel in group mode, a =
//                                          x_parent, b = g_child
//   * openscene_tpu/sparse/pallas_edge.py:522 make_up_bwd_kernel (down-conv
//     backward over children, op _down_conv_bwd :727-756):
//       dx[c] = g[parent(c)] @ W[offset(c)]^T
//                                          csrc/up_conv_fwd.cu with W_NK over
//                                          the edge's groups
//       dW[k]^T = sum over the children c of offset k of g[parent(c)]^T x[c]
//                                          this kernel in group mode, a =
//                                          g_parent, b = x_child
// The TPU kernels' window plans, spill lists, pair packing and channel
// permutations are layouts of the TPU's memory system and are not carried
// over: both CUDA kernels read the plain index plans.
//
// Bound of one backward on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense
// bf16), dx and dW together, counted by the data (the (row, offset) pairs
// whose neighbour exists):
//   bytes = (rows_a*Ca + rows_b*Cb + rows_dx*Cdx)*2 + K*rows*4
//           + K*Ca*Cb*(2 + 4)
//   flops = 2 products of 2*pairs*Ca*Cb
// Bound by bytes at about 6 of 27 neighbours and for the K = 8 edges.
//
// Design.
//   * Skip mode (a ConvSkip of the plan, K <= 31): offset k reduces only
//     over its compacted rows pair_rows[k][0 .. pair_count[k]), the rows
//     whose neighbour exists, so no missing pair is gathered or multiplied.
//     Group mode (the edge convs, an EdgeGroups of the edge and amap =
//     child_parent): offset k reduces over its own children, the segment
//     of pair_rows that starts at seg_tile * sum_{j<k} ceil(pair_count[j] /
//     seg_tile); each entry is b's row (the child) and amap of it a's row
//     (the parent), so only the pairs that exist are read.  Dense mode (no
//     skip plan: the K = 125 stem): every row.
//   * Grid (Ca tile x Cb tile, k, split).  Split s covers pair positions
//     [s*per, (s+1)*per) of its offset; the splits are sized on the host
//     from a bound on every count (the level's rows), so no count is read
//     back, and a block whose split starts at or past its offset's count
//     exits at once.
//   * Tiles of 32..128 by 32..128 channels that fit Ca and Cb, one warp per
//     32 x 32 sub-tile; the rows are the reduction dimension: a's rows are
//     read as the transposed A operand (ldmatrix.trans, no transpose is
//     materialised), the gathered rows of b as B, 2 x 4 mma.sync m16n8k16
//     bf16 products per 16 rows.
//   * Pipeline: the block reads its rows' indices (a row, b's source row)
//     into shared memory 1,024 at a time, then streams 32-row steps through
//     a 3-stage cp.async ring of 16-byte copies.
//   * Reduction: each block writes its fp32 partial tile; a second kernel
//     adds the partials of every element in a fixed order, over the splits
//     that hold rows.  The result is deterministic, the same bits from run
//     to run (fp32 atomicAdd would not be), and differs from the plain
//     version only in the order of its fp32 sums.  With one split the first
//     kernel writes dw itself and the second does not run.
//   mma.sync rather than wgmma for the reason given in gather_gemm_fwd.cu:
//   the gathered rows land in a plain padded layout.
//
// The launcher allocates nothing, runs on the caller's stream, does not
// synchronise, and returns cudaGetLastError() of its launches.

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BR = 32;           // reduction rows per pipeline step
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int IDXN = 1024;       // row indices staged in shared memory
constexpr int MAX_THREADS = 512;

__global__ void __launch_bounds__(MAX_THREADS)
gather_wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ pair_rows,
                    const int32_t* __restrict__ pair_count,
                    const int32_t* __restrict__ amap,
                    float* __restrict__ dst, int rows, int K, int ca, int cb,
                    int per, int tiles_b, int bma, int bnb, int seg_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warps_n = bnb >> 5;
  const int wm = (tid >> 5) / warps_n;  // warp's 32 a-channels
  const int wn = (tid >> 5) % warps_n;  // warp's 32 b-channels
  const int lda = bma + 8;
  const int ldb = bnb + 8;
  const int m0 = (blockIdx.x / tiles_b) * bma;
  const int n0 = (blockIdx.x % tiles_b) * bnb;
  const int k = blockIdx.y;
  const int split = blockIdx.z;
  const int n_k = pair_count ? pair_count[k] : rows;
  const int r_begin = split * per;
  // an empty split leaves nothing to add; split 0 always writes its tile
  if (r_begin >= n_k && split != 0) return;

  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * BR * lda;
  int* ra = reinterpret_cast<int*>(Bs + STAGES * BR * ldb);  // a row
  int* rb = ra + IDXN;                                         // b row
  const int32_t* idx_k = amap ? nullptr : idx + (size_t)k * rows;
  // group mode: where offset k's segment starts
  int seg0 = 0;
  if (amap)
    for (int j = 0; j < k; ++j)
      seg0 += (pair_count[j] + seg_tile - 1) / seg_tile * seg_tile;

  float acc[2][4][4];
  gg::zero_acc(acc);
  const int r_end = min(n_k, r_begin + per);
  const int va = bma / 8;  // 16-byte vectors per staged row
  const int vb = bnb / 8;
  for (int c_begin = r_begin; c_begin < r_end; c_begin += IDXN) {
    const int n_c = min(IDXN, r_end - c_begin);
    __syncthreads();  // the previous chunk's ring and indices are consumed
    for (int v = tid; v < n_c; v += nthreads) {
      const int p = c_begin + v;
      if (amap) {
        const int c = pair_rows[seg0 + p];
        ra[v] = amap[c];
        rb[v] = c;
      } else {
        const int r = pair_rows ? pair_rows[(size_t)k * rows + p] : p;
        ra[v] = r;
        rb[v] = idx_k[r];
      }
    }
    __syncthreads();
    const int steps = (n_c + BR - 1) / BR;

    auto load = [&](int st) {
      const int slot = st % STAGES;
      const int q0 = st * BR;
      bf16* as = As + slot * BR * lda;
      bf16* bs = Bs + slot * BR * ldb;
      for (int v = tid; v < BR * va; v += nthreads) {
        const int i = v / va;
        const int cc = (v - i * va) * 8;
        const int q = q0 + i;
        const bool ok = q < n_c && m0 + cc < ca;
        gg::cp_async16(as + i * lda + cc,
                       ok ? a + (size_t)ra[q] * ca + m0 + cc : a, ok);
      }
      for (int v = tid; v < BR * vb; v += nthreads) {
        const int i = v / vb;
        const int nn = (v - i * vb) * 8;
        const int q = q0 + i;
        const int src = q < n_c ? rb[q] : -1;
        const bool ok = src >= 0 && n0 + nn < cb;
        gg::cp_async16(bs + i * ldb + nn,
                       ok ? b + (size_t)src * cb + n0 + nn : b, ok);
      }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) load(s);
      gg::cp_async_commit();
    }
    for (int st = 0; st < steps; ++st) {
      gg::cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (st + STAGES - 1 < steps) load(st + STAGES - 1);
      gg::cp_async_commit();
      const bf16* as = As + (st % STAGES) * BR * lda + wm * 32;
      const bf16* bs = Bs + (st % STAGES) * BR * ldb + wn * 32;
#pragma unroll
      for (int kk = 0; kk < BR; kk += 16) {
        // a^T: element (channel m, row q) sits at as[q * lda + m]
        unsigned af[2][4], bfr[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          gg::ldsm_x4_t(af[i], as + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                        lda +
                                    i * 16 + ((lane >> 3) & 1) * 8);
        gg::load_b(bfr, bs + kk * ldb, ldb, lane);
        gg::mma_tile(acc, af, bfr);
      }
    }
    gg::cp_async_wait<0>();
  }

  // this block's partial tile of dw[k]
  float* out = dst + ((size_t)split * K + k) * ca * cb;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int n = n0 + wn * 32 + t * 8 + tq * 2;
    if (n >= cb) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + h * 8;
        if (m < ca)
          *reinterpret_cast<float2*>(out + (size_t)m * cb + n) =
              make_float2(acc[i][t][2 * h], acc[i][t][2 * h + 1]);
      }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order, over the splits of
// element i's offset that hold rows
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, size_t n,
                                       int plane, int splits, int per,
                                       int rows,
                                       const int32_t* __restrict__ pair_count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int n_k = pair_count ? pair_count[i / plane] : rows;
  const int used = max(1, min(splits, (n_k + per - 1) / per));
  float s = 0.0f;
  for (int sp = 0; sp < used; ++sp) s += part[(size_t)sp * n + i];
  out[i] = s;
}

// the dynamic shared memory a launch needs; raised once per size
int ensure_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      gather_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return static_cast<int>(err);
}

}  // namespace

// pair_rows, pair_count: the skip plan, or both null (dense); with amap
// (group mode) the groups' rows and counts, segments padded to seg_tile,
// and idx unused.  rows: a's rows, a bound on every offset's pairs.  part:
// (splits, K, ca, cb) fp32 scratch, unused when splits == 1.  bma, bnb:
// multiples of 32, (bma/32)*(bnb/32) <= 16 warps.
extern "C" int gather_wgrad_bf16(const void* a, const void* b, const void* idx,
                                 const void* pair_rows, const void* pair_count,
                                 const void* amap, void* part, void* out,
                                 int rows, int K, int ca, int cb, int bma,
                                 int bnb, int per, int splits, int seg_tile,
                                 void* stream) {
  const int threads = (bma / 32) * (bnb / 32) * 32;
  if (bma <= 0 || bnb <= 0 || bma % 32 || bnb % 32 || threads > MAX_THREADS ||
      per <= 0 || splits <= 0 ||
      (amap && (!pair_rows || !pair_count || seg_tile <= 0)) ||
      (!amap && !idx))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)STAGES * BR * (bma + 8 + bnb + 8) * 2 +
                      (size_t)2 * IDXN * 4;
  const int serr = ensure_smem(smem);
  if (serr) return serr;
  const int tiles_a = (ca + bma - 1) / bma;
  const int tiles_b = (cb + bnb - 1) / bnb;
  const dim3 grid(tiles_a * tiles_b, K, splits);
  float* dst = static_cast<float*>(splits == 1 ? out : part);
  gather_wgrad_kernel<<<grid, threads, smem, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(pair_rows),
      static_cast<const int32_t*>(pair_count),
      static_cast<const int32_t*>(amap), dst, rows, K, ca, cb, per, tiles_b,
      bma, bnb, seg_tile);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)K * ca * cb;
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, ca * cb,
      splits, per, rows, static_cast<const int32_t*>(pair_count));
  return static_cast<int>(cudaGetLastError());
}
