// Gather-GEMM-sum forward of the sparse convolutions, for Hopper (sm_90a).
//
//   out[r, :] = sum_{k < K} x[idx[k, r], :] @ W[k]        r in [0, rows_out)
//
// x: (rows_in, Cin) bf16 row-major; W: (K, Cin, Cout) bf16; idx: (K, rows_out)
// int32; out: (rows_out, Cout) bf16.  Products accumulate in fp32 and the sum
// is rounded to bf16 once.
//
// Replaces two Pallas TPU kernels of the JAX package, which compute this same
// function:
//   * openscene_tpu/sparse/pallas_conv.py:make_fwd_kernel — the k=3 stencil
//     conv forward (K = 27, idx = ConvPlan.fwd); also serves K = 125 (the k=5
//     stem when the input carries colour);
//   * openscene_tpu/sparse/pallas_edge.py:make_down_kernel — the k=2 s=2
//     down-conv forward (K = 8, idx = DownPlan.fwd, rows_out = parent_cap).
// Their row windows, window plans, 128-lane crossbar gathers, bf16 pair
// packing and spill lists exist for the TPU's memory system and are not
// carried over: this kernel reads the plain index plan.  A missing neighbour
// already points into the all-zero padding rows [num, cap) of x, so the
// kernel needs no mask, and padded output rows come out exactly zero.  A
// negative index is read as a zero row.  The same kernel computes the input
// gradient dx of every conv backward, on the cotangent with transposed
// weights (csrc/gather_gemm_bwd.cu lists the three forms).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16):
//   bytes = (rows_in*Cin + rows_out*Cout)*2 + K*rows_out*4 + K*Cin*Cout*2
//   flops = 2*K*rows_out*Cin*Cout
// Counted densely (every row, all K offsets, the work this kernel does) the
// arithmetic intensity is about K*Cin*Cout/(Cin + Cout + 2K) flop/byte,
// >= 230 for the UNet's k=3 convs (Cin, Cout >= 32), near or above the
// card's ~295 ridge, so the wide stencil convs are bound by operations and
// the K = 8 down convs by bytes.  Counted by the data (only the offsets
// whose neighbour exists, about 6 of 27 on 2 cm surface scans) every call
// is bound by bytes: skipping missing neighbours is where a later design
// gains most.
//
// Design (simple and correct first): one block of 4 warps computes a
// 64-row x 64-column output tile.  It loops over the K offsets and over
// 32-wide Cin chunks; for each, the block gathers the 64 source rows'
// chunk through the index into shared memory (16-byte vector loads: Cin and
// Cout must be multiples of 8), stages W[k]'s 32 x 64 chunk beside it, and
// each warp runs 2 x 2 WMMA 16x16x16 bf16 products (mma.sync) into fp32
// register fragments.  Gathered rows are re-read once per 64-column tile of
// Cout; several resident blocks per SM (27 KB of shared memory each) overlap
// one block's loads with another's products.  TMA, wgmma, a multi-stage
// cp.async ring and warp specialisation are left to later work.
//
// The launcher allocates nothing, runs on the caller's stream, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // Cin chunk per step
constexpr int THREADS = 128;  // 4 warps, a 2 x 2 grid of 32 x 32 warp tiles
constexpr int LDA = BK + 8;   // padded shared-memory strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(THREADS)
gather_gemm_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const int32_t* __restrict__ idx,
                       __nv_bfloat16* __restrict__ out,
                       int rows_out, int K, int cin, int cout) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ int32_t src_row[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // warp's 32-row slab
  const int wn = warp & 1;   // warp's 32-column slab
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k = 0; k < K; ++k) {
    if (tid < BM) {
      const int r = r0 + tid;
      src_row[tid] = r < rows_out ? idx[(size_t)k * rows_out + r] : -1;
    }
    __syncthreads();
    const __nv_bfloat16* wk = w + (size_t)k * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      // gathered A tile: BM rows x BK channels, 8 channels per vector
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
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: round to bf16 once, 8 columns (16 bytes) per store
  for (int v = tid; v < BM * (BN / 8); v += THREADS) {
    const int i = v / (BN / 8);
    const int nn = (v % (BN / 8)) * 8;
    const int r = r0 + i;
    const int n = n0 + nn;
    if (r < rows_out && n < cout) {
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(Cs[i * LDC + nn + e]);
      *reinterpret_cast<uint4*>(out + (size_t)r * cout + n) =
          *reinterpret_cast<const uint4*>(o);
    }
  }
}

}  // namespace

extern "C" int gather_gemm_fwd_bf16(const void* x, const void* w,
                                    const void* idx, void* out, int rows_out,
                                    int K, int cin, int cout, void* stream) {
  const dim3 grid((rows_out + BM - 1) / BM, (cout + BN - 1) / BN);
  gather_gemm_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int32_t*>(idx), static_cast<__nv_bfloat16*>(out),
      rows_out, K, cin, cout);
  return static_cast<int>(cudaGetLastError());
}
