// Pair-packed transpose, for Hopper (sm_90a).
//
//   word[r, j] = bits(x[r, 2j]) | bits(x[r, 2j+1]) << 16     (even channel low)
//   o[t, j, r'] = word[128 t + r', j]
//
// x: (cap, C) bf16 row-major, C a multiple of 8, cap a multiple of 128;
// o: (cap/128, C/2, 128) 32-bit words.  Pure data movement: the result is
// bit-exact.
//
// Replaces the Pallas TPU kernel of scripts/dev_pack_bench.py:
// _pack_kernel_call, which transposes 128-row blocks of words that were
// paired beforehand by a separate pass (pack_pallas: u16 slices, widen, or,
// bitcast).  The TPU needs the pairing as its own step; here a bf16 row in
// memory already is its words, little-endian with the even channel in the
// low half, so reading it as 32-bit words is the pairing, fused into the
// load.
//
// Bound on an H100 SXM (3.35 TB/s HBM): 2 * cap * C * 2 bytes (x read once,
// o written once), no arithmetic: bound by bytes.  At (1,039,872, 128) that
// is 532 MB, 0.159 ms.
//
// Design: one block of 256 threads takes one 128-row group t and a chunk of
// 32 words.  It reads the 128 x 32 words with 16-byte loads (4 words per
// thread and load; 8 neighbouring threads cover 128 contiguous bytes of a
// row) into a shared tile whose rows are padded to 129 words, so both the
// column-wise writes of the load phase and the row-wise reads of the store
// phase are free of bank conflicts, then writes o[t, j, 0:128] for each of
// its words j as 512 contiguous bytes (one 32-bit word per thread, a warp
// writes 128 contiguous bytes).  C = 96 (48 words) takes a full and a
// half-masked chunk.
//
// The launcher allocates nothing, runs on the caller's stream, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS = 128;     // rows per group (the output's last axis)
constexpr int JW = 32;        // words per block
constexpr int THREADS = 256;
constexpr int LDS = ROWS + 1;  // padded shared-memory stride (words)

__global__ void __launch_bounds__(THREADS)
pack_pairs_t_kernel(const uint32_t* __restrict__ xw, uint32_t* __restrict__ o,
                    int cw) {
  __shared__ uint32_t tile[JW * LDS];
  const int t = blockIdx.x;
  const int j0 = blockIdx.y * JW;
  const int tid = threadIdx.x;

  // load: ROWS rows x JW words as uint4 (JW / 4 vectors per row)
  for (int v = tid; v < ROWS * (JW / 4); v += THREADS) {
    const int r = v / (JW / 4);
    const int q = (v % (JW / 4)) * 4;
    if (j0 + q < cw) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          xw + ((size_t)t * ROWS + r) * cw + j0 + q);
      tile[(q + 0) * LDS + r] = val.x;
      tile[(q + 1) * LDS + r] = val.y;
      tile[(q + 2) * LDS + r] = val.z;
      tile[(q + 3) * LDS + r] = val.w;
    }
  }
  __syncthreads();

  // store: o[t, j0 + jj, :] for each word jj of the chunk, row-contiguous
  for (int v = tid; v < JW * ROWS; v += THREADS) {
    const int jj = v / ROWS;
    const int r = v % ROWS;
    if (j0 + jj < cw)
      o[((size_t)t * cw + j0 + jj) * ROWS + r] = tile[jj * LDS + r];
  }
}

}  // namespace

extern "C" int pack_pairs_t_bf16(const void* x, void* o, int groups, int cw,
                                 void* stream) {
  const dim3 grid(groups, (cw + JW - 1) / JW);
  pack_pairs_t_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(o), cw);
  return static_cast<int>(cudaGetLastError());
}
