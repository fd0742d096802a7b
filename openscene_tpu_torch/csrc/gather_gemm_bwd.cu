// Weight gradient of the sparse convolutions, for Hopper (sm_90a): a product
// whose reduction runs over the rows, with one operand gathered.
//
//   dw[k] = sum_{r < rows} a[r, :]^T  b[idx[k, r], :]          k in [0, K)
//
// a: (rows, Ca) bf16 row-major; b: (rows_b, Cb) bf16 row-major; idx: (K, rows)
// int32 (a negative entry contributes zero); dw: (K, Ca, Cb) fp32.  Every
// product of two bf16 values is exact in fp32 and the sums are kept in fp32.
//
// Together with the gather-GEMM-sum of csrc/gather_gemm_fwd.cu, which
// computes the input gradient dx of each backward from the same gathered
// operand, this source replaces three Pallas TPU kernels of the JAX package:
//   * openscene_tpu/sparse/pallas_conv.py:447 make_bwd_kernel (k=3 stencil
//     backward, op _wconv_bwd :695-762).  With G_k = g[fwd[k]]:
//       dx = sum_k G_k @ W[flip k]^T       gather_gemm_fwd(g, W[flip]^T, fwd)
//       dW[flip k] = x^T @ G_k             this kernel, a = x, b = g, idx = fwd
//   * openscene_tpu/sparse/pallas_edge.py:374 make_down_bwd_kernel (up-conv
//     backward over parents, op _up_bwd_core :795-834):
//       dx[p] = sum_k g[fwd[k,p]] @ W[k]^T gather_gemm_fwd(g, W^T, down.fwd)
//       dW[k] = x^T @ g[fwd[k]]            this kernel, a = x_parent, b = g_child
//   * openscene_tpu/sparse/pallas_edge.py:522 make_up_bwd_kernel (down-conv
//     backward over children, op _down_conv_bwd :727-756):
//       dx[c] = g[parent(c)] @ W[offset(c)]^T
//                                          gather_gemm_fwd over the index
//                                          where(offset(c) == k, parent(c), -1)
//       dW[k]^T = g^T @ x[fwd[k]]          this kernel, a = g_parent, b = x_child
// The TPU kernels' window plans, spill lists, pair packing and channel
// permutations are layouts of the TPU's memory system and are not carried
// over: both CUDA kernels read the plain index plans.
//
// Bound of one backward on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense
// bf16), dx and dW together:
//   bytes = (rows_a*Ca + rows_b*Cb + rows_dx*Cdx)*2 + K*rows*4
//           + K*Ca*Cb*(2 + 4)
//   flops = 2 products of 2*pairs*Ca*Cb
// Counted densely (all K offsets of every row, which is what these kernels
// multiply) the k=3 stencil backward is bound by operations; counted by the
// data (about 6 of 27 neighbours exist on 2 cm surface scans) and for the
// K = 8 edges it is bound by bytes.
//
// Reduction strategy.  The TPU kernel carries its (K*Cout, Cin) fp32
// accumulator across a sequential grid; CUDA blocks run in no order, so the
// long row dimension is split instead: block (tile, k, s) reduces rows
// [s*rows_per_split, (s+1)*rows_per_split) of one 64 x 64 tile of dw[k] into
// fp32 WMMA fragments and writes one partial tile; a second kernel adds the
// `splits` partials of every element in a fixed order.  The result is
// therefore deterministic: the same inputs give the same bits from run to
// run (fp32 atomicAdd would not), and it differs from the plain version only
// in the order of its fp32 sums.  With one split the first kernel writes dw
// itself and the second does not run.  The caller chooses the split so that
// small levels still fill the card while the partials stay small.
//
// Design (simple and correct first): 4 warps per block, each a 32 x 32 slab
// of the tile as 2 x 2 WMMA 16x16x16 bf16 products (mma.sync).  Per step of
// 32 rows the block stages a's rows (read as the transposed operand through a
// col_major fragment, so no transpose is materialised) and the gathered rows
// of b in shared memory with 16-byte loads (Ca, Cb multiples of 8).  TMA,
// wgmma, a cp.async ring and skipping row chunks whose neighbours are all
// missing are left to later work.
//
// The launcher allocates nothing, runs on the caller's stream, does not
// synchronise, and returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // a channels (rows of dw[k]) per block
constexpr int BN = 64;        // b channels (columns of dw[k]) per block
constexpr int BR = 32;        // reduction rows per step
constexpr int THREADS = 128;  // 4 warps, a 2 x 2 grid of 32 x 32 warp tiles
constexpr int LDA = BM + 8;   // padded shared-memory strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(THREADS)
gather_wgrad_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ part,
                    int rows, int K, int ca, int cb, int rows_per_split,
                    int tiles_b) {
  __shared__ __align__(128) __nv_bfloat16 As[BR * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BR * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // warp's 32-row slab of the tile
  const int wn = warp & 1;   // warp's 32-column slab
  const int m0 = (blockIdx.x / tiles_b) * BM;
  const int n0 = (blockIdx.x % tiles_b) * BN;
  const int k = blockIdx.y;
  const int split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  const int32_t* idx_k = idx + (size_t)k * rows;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int r0 = r_begin; r0 < r_end; r0 += BR) {
    // a tile: BR rows x BM channels, 8 channels per vector
    for (int v = tid; v < BR * (BM / 8); v += THREADS) {
      const int i = v / (BM / 8);
      const int cc = (v % (BM / 8)) * 8;
      const int r = r0 + i;
      uint4 val = zero;
      if (r < r_end && m0 + cc < ca)
        val = *reinterpret_cast<const uint4*>(a + (size_t)r * ca + m0 + cc);
      *reinterpret_cast<uint4*>(&As[i * LDA + cc]) = val;
    }
    // gathered b tile: BR rows x BN channels through idx[k]
    for (int v = tid; v < BR * (BN / 8); v += THREADS) {
      const int i = v / (BN / 8);
      const int nn = (v % (BN / 8)) * 8;
      const int r = r0 + i;
      const int src = r < r_end ? idx_k[r] : -1;
      uint4 val = zero;
      if (src >= 0 && n0 + nn < cb)
        val = *reinterpret_cast<const uint4*>(b + (size_t)src * cb + n0 + nn);
      *reinterpret_cast<uint4*>(&Bs[i * LDB + nn]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      // a^T: element (channel i, row j) sits at As[j * LDA + i] = col_major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[kk * LDA + wm * 32 + i * 16], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk * LDB + wn * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // this block's partial tile of dw[k], 4 columns (16 bytes) per store
  float* out = part + ((size_t)split * K + k) * ca * cb;
  for (int v = tid; v < BM * (BN / 4); v += THREADS) {
    const int i = v / (BN / 4);
    const int nn = (v % (BN / 4)) * 4;
    const int m = m0 + i;
    const int n = n0 + nn;
    if (m < ca && n < cb)
      *reinterpret_cast<float4*>(out + (size_t)m * cb + n) =
          *reinterpret_cast<const float4*>(&Cs[i * LDC + nn]);
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, size_t n,
                                       int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * n + i];
  out[i] = s;
}

}  // namespace

// part: (splits, K, ca, cb) fp32 scratch, unused when splits == 1.
extern "C" int gather_wgrad_bf16(const void* a, const void* b, const void* idx,
                                 void* part, void* out, int rows, int K,
                                 int ca, int cb, int rows_per_split,
                                 int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_a = (ca + BM - 1) / BM;
  const int tiles_b = (cb + BN - 1) / BN;
  const dim3 grid(tiles_a * tiles_b, K, splits);
  float* dst = static_cast<float*>(splits == 1 ? out : part);
  gather_wgrad_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const int32_t*>(idx),
      dst, rows, K, ca, cb, rows_per_split, tiles_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)K * ca * cb;
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
