// Forward of the k=2 s=2 transposed (up) convolution over the children, for
// Hopper (sm_90a).
//
//   out[c, :] = x[parent(c), :] @ W[offset(c)]         c in [0, child_cap)
//
// x: (parent_cap, Cin) bf16 row-major; W: (8, Cin, Cout) bf16; parent(c) =
// DownPlan.child_parent[c], offset(c) = DownPlan.child_offset[c]; out:
// (child_cap, Cout) bf16.  Products accumulate in fp32 and are rounded to
// bf16 once.
//
// Replaces the Pallas TPU kernel openscene_tpu/sparse/pallas_edge.py:
// make_up_kernel (the forward of windowed_up_conv).  That kernel gathers a
// parent window per child tile and fans every gathered row into an 8-offset
// masked stack before one GEMM: each row is nonzero in one of the 8 blocks,
// so it does 8x the products.  This kernel multiplies each child row once,
// by its own weight.
//
// Design (simple and correct first): the wrapper (sparse/edge_conv.py:
// up_conv_fwd) groups the child rows by offset with a stable sort into 8
// segments, each padded to a multiple of 64 rows, and passes the grouped
// child indices (tile_rows, -1 in the padding) and each 64-row tile's offset
// (tile_k, -1 past the last segment).  One block of 4 warps takes one tile
// and one 64-column slab of Cout: it gathers the tile's parent rows through
// child_parent into shared memory 32 channels at a time (16-byte loads, so
// Cin and Cout are multiples of 8), stages W[k]'s 32 x 64 chunk beside
// them, runs 2 x 2 WMMA 16x16x16 bf16 products (mma.sync) per warp into
// fp32 fragments, and writes each row to its child position.  Every child
// lies in exactly one tile, so each output row is written once: no atomics,
// and the result does not depend on the order of the blocks.  A padded child
// row points at a zero padding parent with offset 0, so its output is
// exactly 0.  Cout = 96 takes a full and a half-masked 64-column slab.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16), per call:
//   bytes = parent rows read once (parent_cap*Cin*2) + child rows written
//           (child_cap*Cout*2) + child_parent, child_offset and the grouped
//           index (3 x child_cap x 4) + W (8*Cin*Cout*2)
//   flops = 2*child_rows*Cin*Cout
// i.e. about Cin*Cout/(Cout + 6) flop per byte, under 100 for every edge of
// MinkUNet18A (Cin, Cout <= 256): bound by bytes.
//
// The launcher allocates nothing, runs on the caller's stream, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // child rows per tile
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // Cin chunk per step
constexpr int THREADS = 128;  // 4 warps, a 2 x 2 grid of 32 x 32 warp tiles
constexpr int LDA = BK + 8;   // padded shared-memory strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(THREADS)
up_conv_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const int32_t* __restrict__ child_parent,
                   const int32_t* __restrict__ tile_rows,
                   const int32_t* __restrict__ tile_k,
                   __nv_bfloat16* __restrict__ out, int cin, int cout) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ int32_t src_row[BM];
  __shared__ int32_t dst_row[BM];

  const int t = blockIdx.x;
  const int k = tile_k[t];
  if (k < 0) return;  // past the last segment: the whole block leaves
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // warp's 32-row slab
  const int wn = warp & 1;   // warp's 32-column slab
  const int n0 = blockIdx.y * BN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if (tid < BM) {
    const int c = tile_rows[(size_t)t * BM + tid];
    dst_row[tid] = c;
    src_row[tid] = c >= 0 ? child_parent[c] : -1;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  __syncthreads();

  const __nv_bfloat16* wk = w + (size_t)k * cin * cout;
  for (int c0 = 0; c0 < cin; c0 += BK) {
    // gathered A tile: BM parent rows x BK channels, 8 channels per vector
    for (int v = tid; v < BM * (BK / 8); v += THREADS) {
      const int i = v / (BK / 8);
      const int cc = (v % (BK / 8)) * 8;
      const int src = src_row[i];
      uint4 val = zero;
      if (src >= 0 && c0 + cc < cin)
        val = *reinterpret_cast<const uint4*>(x + (size_t)src * cin + c0 + cc);
      *reinterpret_cast<uint4*>(&As[i * LDA + cc]) = val;
    }
    // weight tile: BK rows of W[k] x BN columns
    for (int v = tid; v < BK * (BN / 8); v += THREADS) {
      const int i = v / (BN / 8);
      const int nn = (v % (BN / 8)) * 8;
      uint4 val = zero;
      if (c0 + i < cin && n0 + nn < cout)
        val = *reinterpret_cast<const uint4*>(wk + (size_t)(c0 + i) * cout + n0 + nn);
      *reinterpret_cast<uint4*>(&Bs[i * LDB + nn]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
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

  // epilogue: round to bf16 once, 8 columns (16 bytes) per store, each row
  // to its child position
  for (int v = tid; v < BM * (BN / 8); v += THREADS) {
    const int i = v / (BN / 8);
    const int nn = (v % (BN / 8)) * 8;
    const int c = dst_row[i];
    const int n = n0 + nn;
    if (c >= 0 && n < cout) {
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(Cs[i * LDC + nn + e]);
      *reinterpret_cast<uint4*>(out + (size_t)c * cout + n) =
          *reinterpret_cast<const uint4*>(o);
    }
  }
}

}  // namespace

extern "C" int up_conv_fwd_bf16(const void* x, const void* w,
                                const void* child_parent, const void* tile_rows,
                                const void* tile_k, void* out, int tiles,
                                int cin, int cout, void* stream) {
  const dim3 grid(tiles, (cout + BN - 1) / BN);
  up_conv_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int32_t*>(child_parent),
      static_cast<const int32_t*>(tile_rows), static_cast<const int32_t*>(tile_k),
      static_cast<__nv_bfloat16*>(out), cin, cout);
  return static_cast<int>(cudaGetLastError());
}
