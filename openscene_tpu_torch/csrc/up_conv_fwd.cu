// Per-child product of a k=2 s=2 edge, for Hopper (sm_90a):
//
//   out[c, :] = x[parent(c), :] @ W[offset(c)]         c in [0, child_cap)
//
// x: (parent_cap, Cin) bf16 row-major; W: (8, Cin, Cout) bf16, or with W_NK
// (8, Cout, Cin), each W[k] then read as the transpose of what is stored;
// parent(c) = DownPlan.child_parent[c], offset(c) = DownPlan.child_offset[c];
// out: (child_cap, Cout) bf16.  Products accumulate in fp32 and are rounded
// to bf16 once.
//
// Replaces two Pallas TPU kernels of openscene_tpu/sparse/pallas_edge.py:
//   * make_up_kernel (the forward of windowed_up_conv), the up conv's
//     forward: x = the parents' activations, W as stored;
//   * make_up_bwd_kernel (_down_conv_bwd), the down conv's input gradient
//     dx[c] = g[parent(c)] @ W[offset(c)]^T: x = the parents' cotangent and
//     the down conv's own (8, Cin, Cout) weight read transposed (W_NK), so
//     no transposed copy is made.  Its dW is csrc/gather_gemm_bwd.cu in
//     group mode over the same groups.  At MinkUNet18A's edge 0 (32 -> 32,
//     a 263,063-voxel batch) dx and dW together are bound at 0.0128 ms and
//     take 0.0508 ms (dx alone 0.0171) on an NVIDIA H100 80GB HBM3 at
//     700 W, against 0.1968 for the design they replaced (PERF.md).
// The TPU kernels gather a window per tile and fan every gathered row into
// an 8-offset masked stack before one GEMM: each row is nonzero in one of
// the 8 blocks, so they do 8x the products.  This kernel multiplies each
// child row once, by its own weight.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16), per call:
//   bytes = parent rows read once (parent_num*Cin*2) + child rows written
//           (child_num*Cout*2) + the grouped child index and child_parent
//           (2 x child_num x 4) + W (8*Cin*Cout*2)
//   flops = 2*child_num*Cin*Cout
// i.e. about Cin*Cout/(Cout + 4) flop per byte, under 100 for every edge of
// MinkUNet18A (Cin, Cout <= 256): bound by bytes.
//
// Design.
//   * The rows come grouped: the edge's EdgeGroups (sparse/types.py, built
//     once per batch with the plans) hold the valid children stably sorted
//     by offset, each offset's segment padded with -1 to a multiple of
//     BM = 64 rows, and each 64-row tile's offset (tile_k, -1 past the last
//     segment).  Every tile's rows share one W[k].
//   * Block b takes tpb consecutive tiles and one bn-column slab of Cout
//     (bn a multiple of 32 fitted to Cout, so Cout = 96 is one slab; bn and
//     tpb from sparse/edge_conv.py:up_tiles, or down_dx_tiles for the down
//     conv's dx).  For each run of its tiles with one offset it stages
//     W[k]'s whole Cin x bn slab in shared memory once (with W_NK as bn rows
//     of Cin, read through ldmatrix without .trans), then streams the
//     tiles' gathered parent rows, 32 channels a step, through a 4-stage
//     cp.async ring of 16-byte copies; ldmatrix + mma.sync m16n8k16 (fp32
//     accumulators), one warp per 32 x 32 sub-tile.  The child and parent
//     indices of all its tiles are read into shared memory before the ring
//     starts.
//   * Each tile's rows are rounded once, staged in shared memory and
//     written to their children as 16-byte vectors, a row's slab by
//     neighbouring threads: the scattered child rows made the direct
//     4-byte stores from the mma fragments the kernel's bottleneck (about
//     half of its time at MinkUNet18A's edge 0 on an NVIDIA H100 80GB HBM3
//     at 700 W, PERF.md).  A valid child
//     lies in exactly one tile and the padded children (rows [num,
//     child_cap), num = sum of the groups' counts) are written zero, spread
//     over all blocks: every output row is written once, no atomics, and
//     the result is the same bits from launch to launch.
//   mma.sync rather than wgmma for the reason given in gather_gemm_fwd.cu:
//   the gathered rows land in a plain padded layout.
//
// The launcher allocates nothing, runs on the caller's stream, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;           // child rows per tile (EdgeGroups' tile)
constexpr int BK = 32;           // Cin chunk per pipeline step
constexpr int STAGES = 4;        // cp.async ring depth
constexpr int MAX_THREADS = 512;
constexpr int LDA = BK + 8;      // padded row stride of the gathered tile

// W_NK: W[k] stored (cout, cin) and read transposed.  A template argument:
// as a runtime flag the same mode slowed gather_gemm_fwd.cu's stencil
// forward by about a third (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
template <bool W_NK>
__global__ void __launch_bounds__(MAX_THREADS)
up_conv_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int32_t* __restrict__ child_parent,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ tile_k,
                   const int32_t* __restrict__ count, bf16* __restrict__ out,
                   int tiles, int child_cap, int cin, int cout, int bn,
                   int tpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warps_n = bn >> 5;
  const int wm = (tid >> 5) / warps_n;  // warp's 32-row slab
  const int wn = (tid >> 5) % warps_n;  // warp's 32-column slab
  const int ldb = bn + 8;
  const int n_chunks = (cin + BK - 1) / BK;
  const int ldw = W_NK ? n_chunks * BK + 8 : ldb;  // row stride of Ws
  const int n0 = blockIdx.y * bn;
  const int t0 = blockIdx.x * tpb;
  const int nt = min(tpb, tiles - t0);
  const int vpr = bn / 8;  // 16-byte vectors per slab row

  // W[k]'s slab: n_chunks*BK rows of bn, or with W_NK bn rows of
  // n_chunks*BK (row stride ldw)
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* As = Ws + (W_NK ? bn * ldw : n_chunks * BK * ldb);  // the ring
  bf16* Cs = As + STAGES * BM * LDA;                    // BM x ldb, the tile
  int* sdst = reinterpret_cast<int*>(Cs + BM * ldb);           // child row
  int* ssrc = sdst + tpb * BM;                                 // its parent
  int* stk = ssrc + tpb * BM;                                  // tile offset

  // the padded children, rows [num, child_cap), are written zero, spread
  // over the blocks
  {
    int num = 0;
    for (int j = 0; j < 8; ++j) num += count[j];
    const long long total = (long long)(child_cap - num) * vpr;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (long long v = (long long)blockIdx.x * nthreads + tid; v < total;
         v += (long long)gridDim.x * nthreads) {
      const int r = num + static_cast<int>(v / vpr);
      const int n = n0 + static_cast<int>(v % vpr) * 8;
      if (n < cout)
        *reinterpret_cast<uint4*>(out + (size_t)r * cout + n) = zero;
    }
  }

  for (int v = tid; v < nt * BM; v += nthreads) {
    const int c = rows[(size_t)t0 * BM + v];
    sdst[v] = c;
    ssrc[v] = c >= 0 ? child_parent[c] : -1;
  }
  for (int v = tid; v < nt; v += nthreads) stk[v] = tile_k[t0 + v];
  __syncthreads();

  float acc[2][4][4];
  const int g = lane >> 2;
  const int tq = lane & 3;
  int t = 0;
  while (t < nt) {
    const int k = stk[t];
    if (k < 0) break;  // past the last segment: so are the tiles after it
    int te = t + 1;
    while (te < nt && stk[te] == k) ++te;
    const int total = (te - t) * n_chunks;
    __syncthreads();  // the previous run is done with Ws and the ring

    // W[k]'s Cin x bn slab, zero past Cin and Cout: one commit group,
    // complete before the ring's first step is read
    if constexpr (W_NK) {  // row n: the Cin entries of column n
      const int vpw = n_chunks * BK / 8;
      for (int v = tid; v < bn * vpw; v += nthreads) {
        const int n = v / vpw;
        const int i = (v - n * vpw) * 8;
        const bool ok = i < cin && n0 + n < cout;
        gg::cp_async16(Ws + n * ldw + i,
                       ok ? w + ((size_t)k * cout + n0 + n) * cin + i : w,
                       ok);
      }
    } else {
      for (int v = tid; v < n_chunks * BK * vpr; v += nthreads) {
        const int i = v / vpr;
        const int nn = (v - i * vpr) * 8;
        const bool ok = i < cin && n0 + nn < cout;
        gg::cp_async16(Ws + i * ldb + nn,
                       ok ? w + ((size_t)k * cin + i) * cout + n0 + nn : w,
                       ok);
      }
    }
    gg::cp_async_commit();

    auto load = [&](int it) {
      const int c0 = (it % n_chunks) * BK;
      bf16* as = As + (it % STAGES) * BM * LDA;
      const int* src = ssrc + (t + it / n_chunks) * BM;
      for (int v = tid; v < BM * (BK / 8); v += nthreads) {
        const int j = v >> 2;
        const int cc = (v & 3) * 8;
        const int s = src[j];
        const bool ok = s >= 0 && c0 + cc < cin;
        gg::cp_async16(as + j * LDA + cc,
                       ok ? x + (size_t)s * cin + c0 + cc : x, ok);
      }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) load(s);
      gg::cp_async_commit();
    }
    gg::zero_acc(acc);
    for (int it = 0; it < total; ++it) {
      gg::cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (it + STAGES - 1 < total) load(it + STAGES - 1);
      gg::cp_async_commit();
      const int chunk = it % n_chunks;
      const bf16* as = As + (it % STAGES) * BM * LDA;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[2][4], bfr[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          gg::ldsm_x4(af[i], as + (wm * 32 + i * 16 + (lane & 15)) * LDA +
                                 kk + (lane >> 4) * 8);
        if constexpr (W_NK)
          gg::load_b_nk(bfr, Ws + wn * 32 * ldw + chunk * BK + kk, ldw,
                        lane);
        else
          gg::load_b(bfr, Ws + (chunk * BK + kk) * ldb + wn * 32, ldb,
                     lane);
        gg::mma_tile(acc, af, bfr);
      }
      if (chunk == n_chunks - 1) {
        // the tile is complete: each row rounded to bf16 once, staged, and
        // written to its child 16 bytes a thread
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<__nv_bfloat162*>(
                  Cs + (wm * 32 + i * 16 + g + h * 8) * ldb + wn * 32 +
                  q * 8 + tq * 2) =
                  __floats2bfloat162_rn(acc[i][q][2 * h],
                                        acc[i][q][2 * h + 1]);
        __syncthreads();
        const int* dst = sdst + (t + it / n_chunks) * BM;
        for (int v = tid; v < BM * vpr; v += nthreads) {
          const int j = v / vpr;
          const int nn = (v - j * vpr) * 8;
          const int c = dst[j];
          if (c >= 0 && n0 + nn < cout)
            *reinterpret_cast<uint4*>(out + (size_t)c * cout + n0 + nn) =
                *reinterpret_cast<const uint4*>(Cs + j * ldb + nn);
        }
        gg::zero_acc(acc);
      }
    }
    gg::cp_async_wait<0>();
    t = te;
  }
}

// the dynamic shared memory a launch needs; raised once per size
template <bool W_NK>
int ensure_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      up_conv_fwd_kernel<W_NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return static_cast<int>(err);
}

template <bool W_NK>
int launch(const void* x, const void* w, const void* child_parent,
           const void* rows, const void* tile_k, const void* count, void* out,
           int tiles, int child_cap, int cin, int cout, int bn, int tpb,
           cudaStream_t st) {
  const int threads = (BM / 32) * (bn / 32) * 32;
  const size_t cinp = (size_t)(cin + BK - 1) / BK * BK;
  const size_t w_elems = W_NK ? bn * (cinp + 8) : cinp * (bn + 8);
  const size_t smem = (w_elems + (size_t)BM * (bn + 8) +
                       (size_t)STAGES * BM * LDA) * 2 +
                      (size_t)(2 * tpb * BM + tpb) * 4;
  const int err = ensure_smem<W_NK>(smem);
  if (err) return err;
  const dim3 grid((tiles + tpb - 1) / tpb, (cout + bn - 1) / bn);
  up_conv_fwd_kernel<W_NK><<<grid, threads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int32_t*>(child_parent),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(tile_k),
      static_cast<const int32_t*>(count), static_cast<bf16*>(out), tiles,
      child_cap, cin, cout, bn, tpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows, tile_k, count: the edge's EdgeGroups (tiles tiles of 64 rows).
// bn: a multiple of 32, at most 256; tpb: tiles per block.  w_nk: w is
// (8, cout, cin), each W[k] read transposed.  The shared memory, (W's slab
// + (64*(bn+8) + 4*64*40))*2 + (2*tpb*64 + tpb)*4 bytes with the slab
// ceil(cin/32)*32*(bn+8) elements, or bn*(ceil(cin/32)*32+8) with w_nk, must
// fit the card's 227 KB (sparse/edge_conv.py:up_tiles sees to it).
extern "C" int up_conv_fwd_bf16(const void* x, const void* w,
                                const void* child_parent, const void* rows,
                                const void* tile_k, const void* count,
                                void* out, int tiles, int child_cap, int cin,
                                int cout, int bn, int tpb, int w_nk,
                                void* stream) {
  const int threads = (BM / 32) * (bn / 32) * 32;
  if (bn <= 0 || bn % 32 || threads > MAX_THREADS || tpb <= 0 ||
      tiles <= 0 || cin <= 0 || cin % 8 || cout <= 0 || cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_nk ? launch<true>(x, w, child_parent, rows, tile_k, count, out,
                             tiles, child_cap, cin, cout, bn, tpb, st)
              : launch<false>(x, w, child_parent, rows, tile_k, count, out,
                              tiles, child_cap, cin, cout, bn, tpb, st);
}
