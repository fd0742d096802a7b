// Gather-GEMM-sum forward of the sparse convolutions, for Hopper (sm_90a).
//
//   out[r, :] = sum_{k < K} x[idx[k, r], :] @ W[k]        r in [0, rows_out)
//
// x: (rows_in, Cin) bf16 row-major; W: (K, Cin, Cout) bf16, or with w_nk
// (K, Cout, Cin), each W[k] then read as the transpose of what is stored;
// idx: (K, rows_out) int32; out: (rows_out, Cout) bf16.  Products accumulate
// in fp32 and the sum is rounded to bf16 once.
//
// Replaces two Pallas TPU kernels of the JAX package, which compute this same
// function:
//   * openscene_tpu/sparse/pallas_conv.py:make_fwd_kernel — the k=3 stencil
//     conv forward (K = 27, idx = ConvPlan.fwd); also serves K = 125 (the k=5
//     stem when the input carries colour);
//   * openscene_tpu/sparse/pallas_edge.py:make_down_kernel — the k=2 s=2
//     down-conv forward (K = 8, idx = DownPlan.fwd, rows_out = parent_cap),
//     in skip mode on the edge's skip plan (sparse/types.py:EdgeSkip,
//     parents sorted by which children they hold): a parent holds about 2.4
//     of its 8 children on 2 cm scans, so a tile multiplies only the
//     offsets its parents hold.  At MinkUNet18A's edge 0 (32 -> 32) on a
//     120,695-voxel scene: bound 0.0035 ms, 0.0162 ms measured on an
//     NVIDIA H100 80GB HBM3 at 700 W (PERF.md), 0.0265 for every offset at
//     every parent.
// The same kernel computes the input gradient dx of the stencil conv and of
// the up conv, on the cotangent with transposed weights
// (csrc/gather_gemm_bwd.cu lists the forms); the up conv's dx reads the
// forward's W with w_nk, and the edge's skip plan in place of a ConvSkip.
// The TPU kernels' row windows, window plans, 128-lane crossbar gathers,
// bf16 pair packing and spill lists exist for the TPU's memory system and
// are not carried over: this kernel reads the plain index plan, and a
// missing neighbour points into the all-zero padding rows
// [num, cap) of x.  A negative index is read as a zero row.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16), counted by
// the data (only the (row, offset) pairs whose neighbour exists, about 6 of
// 27 on 2 cm surface scans):
//   bytes = (rows_in*Cin + rows_out*Cout)*2 + K*rows_out*4 + K*Cin*Cout*2
//   flops = 2*pairs*Cin*Cout
// so every call is bound by bytes; counted densely the wide k=3 convs would
// be bound by operations.  The design therefore spends its effort on not
// multiplying the missing pairs and on keeping the gathers in flight.
//
// Design.
//   * Skip mode (a ConvSkip of the plan: order, tile_mask, nbr_mask, K <=
//     31).  Block b owns the output rows order[b*BM .. b*BM+BM) — rows sorted
//     by their neighbour masks, so the rows of a tile share most offsets —
//     and loops only over the offsets set in the OR of its tile masks, in
//     ascending k.  A row whose own bit k is clear gathers zeros without a
//     read.  Every row is written exactly once, to out[order[j]], so rows
//     with no neighbour (padded rows included) come out exactly zero, and
//     each row's fp32 sum runs in a fixed order: the result is
//     deterministic, with no atomics.
//   * Dense mode (no skip plan: the K = 125 stem): the identity order and
//     every offset, indices read as the rows are loaded.
//   * Tiles: BM = 32, 64 or 128 rows by BN = 32..256 columns (a multiple of
//     32 chosen to fit Cout, so a block gathers each row once); one warp per
//     32 x 32 sub-tile, 2 x 4 mma.sync m16n8k16 bf16 products per 16-deep
//     step, fragments by ldmatrix.  In skip mode the gather indices of
//     every active offset are read once into shared memory before the loop.
//   * Pipeline: the (offset, 32-channel chunk) steps of the block flow
//     through a 4-stage cp.async ring (16-byte copies, the gathered rows
//     and the W[k] chunk), so the gathers of step s+3 are in flight while
//     step s multiplies.
//   * Small levels: where the row tiles alone give the card too few blocks
//     and each tile has many steps, the host-side chooser
//     (sparse/stencil_conv.py:fwd_tiles) splits each tile's offsets over
//     `groups` blocks (grid z); each writes an fp32 partial and a second
//     kernel adds the groups in order and rounds once, so the result stays
//     deterministic.
//   mma.sync rather than wgmma: a gathered tile would have to land in
//   wgmma's swizzled shared-memory layout row by row; mma.sync takes any
//   padded layout through ldmatrix, and at about 6 of 27 neighbours the
//   kernel is bound by the gathers, not by the tensor cores.
//
// The launcher allocates nothing, runs on the caller's stream, does not
// synchronise, and returns cudaGetLastError() of its launches.

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 32;           // Cin chunk per pipeline step
constexpr int STAGES = 4;        // cp.async ring depth
constexpr int MAX_THREADS = 512;
constexpr int LDA = BK + 8;      // padded row stride of the gathered tile

// W_NK: W[k] stored (cout, cin) and read transposed.  A template argument:
// as a runtime flag it slowed the plain layout's stencil forward by about a
// third at L0 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// STAGED: the finished tile is rounded, staged in shared memory and written
// as 16-byte row vectors, not from the mma fragments in 4-byte pieces (one
// offset group only).
template <bool W_NK, bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS)
gather_gemm_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ order,
                       const int32_t* __restrict__ tile_mask,
                       const int32_t* __restrict__ nbr_mask,
                       bf16* __restrict__ out, float* __restrict__ part,
                       int rows_out, int K, int cin, int cout, int bm, int bn,
                       int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warps_n = bn >> 5;
  const int wm = (tid >> 5) / warps_n;  // warp's 32-row slab
  const int wn = (tid >> 5) % warps_n;  // warp's 32-column slab
  const int ldb = bn + 8;
  const int r0 = blockIdx.x * bm;
  const int n0 = blockIdx.y * bn;
  const int group = blockIdx.z;
  const bool table = nbr_mask != nullptr;  // skip mode: gather index table

  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * bm * LDA;
  // a stage of B: BK x bn (stride ldb), or bn x BK (stride LDA) with W_NK
  const int b_stage = W_NK ? bn * LDA : BK * ldb;
  int* srow = reinterpret_cast<int*>(Bs + STAGES * b_stage);  // out row
  int* snbr = srow + bm;                                        // its mask
  int* klist = snbr + bm;                                       // offsets
  int* s_nact = klist + K;
  int* sidx = s_nact + 2;            // (active offset, row) -> source row

  if (tid < bm) {
    const int j = r0 + tid;
    int r = -1, m = 0;
    if (j < rows_out) {
      r = order ? order[j] : j;
      m = nbr_mask ? nbr_mask[r] : 0;
    }
    srow[tid] = r;
    snbr[tid] = m;
  }
  if (tid == 0) {
    int n = 0;
    if (tile_mask) {
      unsigned m = 0;
      const int t0 = r0 / tile_rows;
      const int n_tiles = (rows_out + tile_rows - 1) / tile_rows;
      for (int q = 0; q < bm / tile_rows && t0 + q < n_tiles; ++q)
        m |= static_cast<unsigned>(tile_mask[t0 + q]);
      while (m) {
        klist[n++] = __ffs(m) - 1;
        m &= m - 1;
      }
    } else {
      for (int k = 0; k < K; ++k) klist[n++] = k;
    }
    // offset group z of gridDim.z takes an equal share of the offsets
    s_nact[0] = group * n / gridDim.z;
    s_nact[1] = (group + 1) * n / gridDim.z;
  }
  __syncthreads();
  const int a0 = s_nact[0];
  const int n_act = s_nact[1] - a0;
  if (table) {
    for (int v = tid; v < n_act * bm; v += nthreads) {
      const int a = v / bm;
      const int j = v - a * bm;
      const int k = klist[a0 + a];
      const int r = srow[j];
      int s = -1;
      if (r >= 0 && ((snbr[j] >> k) & 1)) s = idx[(size_t)k * rows_out + r];
      sidx[v] = s;
    }
    __syncthreads();
  }

  float acc[2][4][4];
  gg::zero_acc(acc);
  const int n_chunks = (cin + BK - 1) / BK;
  const int total = n_act * n_chunks;
  const int vpr = bn / 8;  // 16-byte vectors per weight row

  auto load = [&](int it) {
    const int slot = it % STAGES;
    const int a = it / n_chunks;
    const int c0 = (it - a * n_chunks) * BK;
    const int k = klist[a0 + a];
    bf16* as = As + slot * bm * LDA;
    bf16* bs = Bs + slot * b_stage;
    const int* si = sidx + a * bm;
    const int32_t* idx_k = idx + (size_t)k * rows_out;
    for (int v = tid; v < bm * (BK / 8); v += nthreads) {
      const int j = v >> 2;
      const int cc = (v & 3) * 8;
      const int s = table ? si[j] : (srow[j] >= 0 ? idx_k[srow[j]] : -1);
      const bool ok = s >= 0 && c0 + cc < cin;
      gg::cp_async16(as + j * LDA + cc,
                     ok ? x + (size_t)s * cin + c0 + cc : x, ok);
    }
    if constexpr (W_NK) {  // stage row n: 32 reduction entries of column n
      for (int v = tid; v < bn * (BK / 8); v += nthreads) {
        const int n = v >> 2;
        const int cc = (v & 3) * 8;
        const bool ok = n0 + n < cout && c0 + cc < cin;
        gg::cp_async16(
            bs + n * LDA + cc,
            ok ? w + ((size_t)k * cout + n0 + n) * cin + c0 + cc : w, ok);
      }
    } else {
      for (int v = tid; v < BK * vpr; v += nthreads) {
        const int i = v / vpr;
        const int nn = (v - i * vpr) * 8;
        const bool ok = c0 + i < cin && n0 + nn < cout;
        gg::cp_async16(
            bs + i * ldb + nn,
            ok ? w + ((size_t)k * cin + c0 + i) * cout + n0 + nn : w, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    gg::cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    gg::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    gg::cp_async_commit();
    const bf16* as = As + (it % STAGES) * bm * LDA;
    const bf16* bs = Bs + (it % STAGES) * b_stage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        gg::ldsm_x4(af[i], as + (wm * 32 + i * 16 + (lane & 15)) * LDA + kk +
                               (lane >> 4) * 8);
      if constexpr (W_NK)
        gg::load_b_nk(bfr, bs + wn * 32 * LDA + kk, LDA, lane);
      else
        gg::load_b(bfr, bs + kk * ldb + wn * 32, ldb, lane);
      gg::mma_tile(acc, af, bfr);
    }
  }
  gg::cp_async_wait<0>();

  // epilogue: each row rounded to bf16 once and written to its own row,
  // or with offset groups its fp32 partial, added by reduce_groups_kernel
  const int g = lane >> 2;
  const int tq = lane & 3;
  if constexpr (STAGED) {
    // the tile (bm x ldb, over the ring, which every warp is done with)
    // rounded once, then each row's slab stored by neighbouring threads
    __syncthreads();
    bf16* Cs = reinterpret_cast<bf16*>(smem);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(
              Cs + (wm * 32 + i * 16 + g + h * 8) * ldb + wn * 32 + t * 8 +
              tq * 2) = __floats2bfloat162_rn(acc[i][t][2 * h],
                                              acc[i][t][2 * h + 1]);
    __syncthreads();
    for (int v = tid; v < bm * vpr; v += nthreads) {
      const int j = v / vpr;
      const int nn = (v - j * vpr) * 8;
      const int r = srow[j];
      if (r >= 0 && n0 + nn < cout)
        *reinterpret_cast<uint4*>(out + (size_t)r * cout + n0 + nn) =
            *reinterpret_cast<const uint4*>(Cs + j * ldb + nn);
    }
    return;
  }
  float* pg = part ? part + (size_t)group * rows_out * cout : nullptr;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int col = n0 + wn * 32 + t * 8 + tq * 2;
    if (col >= cout) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = srow[wm * 32 + i * 16 + g + h * 8];
        if (r < 0) continue;
        if (pg)
          *reinterpret_cast<float2*>(pg + (size_t)r * cout + col) =
              make_float2(acc[i][t][2 * h], acc[i][t][2 * h + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * cout + col) =
              __floats2bfloat162_rn(acc[i][t][2 * h], acc[i][t][2 * h + 1]);
      }
  }
}

// out[i] = bf16(part[0][i] + part[1][i] + ...), in that order
__global__ void reduce_groups_kernel(const float2* __restrict__ part,
                                     __nv_bfloat162* __restrict__ out,
                                     size_t n, int groups) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float2 s = part[i];
  for (int gr = 1; gr < groups; ++gr) {
    const float2 v = part[(size_t)gr * n + i];
    s.x += v.x;
    s.y += v.y;
  }
  out[i] = __floats2bfloat162_rn(s.x, s.y);
}

// the dynamic shared memory a launch needs; raised once per size
template <bool W_NK, bool STAGED>
int ensure_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      gather_gemm_fwd_kernel<W_NK, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return static_cast<int>(err);
}

template <bool W_NK, bool STAGED>
int launch(const void* x, const void* w, const void* idx, const void* order,
           const void* tile_mask, const void* nbr_mask, void* part, void* out,
           int rows_out, int K, int cin, int cout, int bm, int bn,
           int tile_rows, int groups, cudaStream_t st) {
  const int threads = (bm / 32) * (bn / 32) * 32;
  const int b_stage = W_NK ? bn * LDA : BK * (bn + 8);
  const size_t smem = (size_t)STAGES * (bm * LDA + b_stage) * 2 +
                      (size_t)(2 * bm + K + 2 + (nbr_mask ? K * bm : 0)) * 4;
  // the staged tile, bm x (bn+8), fits in the ring: bm <= STAGES*BK
  const int err = ensure_smem<W_NK, STAGED>(smem);
  if (err) return err;
  const dim3 grid((rows_out + bm - 1) / bm, (cout + bn - 1) / bn, groups);
  gather_gemm_fwd_kernel<W_NK, STAGED><<<grid, threads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(tile_mask),
      static_cast<const int32_t*>(nbr_mask), static_cast<bf16*>(out),
      groups > 1 ? static_cast<float*>(part) : nullptr, rows_out, K, cin,
      cout, bm, bn, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// order, tile_mask, nbr_mask: the skip plan, or all three null (dense).
// bm, bn: multiples of 32, (bm/32)*(bn/32) <= 16 warps; tile_rows divides bm.
// groups > 1 splits each tile's offsets over that many blocks, whose fp32
// partials go to part (groups, rows_out, cout) and are added in order.
// w_nk: w is (K, cout, cin), each W[k] read transposed.  staged: the
// staged 16-byte epilogue (groups == 1 only).
extern "C" int gather_gemm_fwd_bf16(const void* x, const void* w,
                                    const void* idx, const void* order,
                                    const void* tile_mask,
                                    const void* nbr_mask, void* part,
                                    void* out, int rows_out, int K, int cin,
                                    int cout, int bm, int bn, int tile_rows,
                                    int groups, int w_nk, int staged,
                                    void* stream) {
  const int threads = (bm / 32) * (bn / 32) * 32;
  if (bm <= 0 || bn <= 0 || bm % 32 || bn % 32 || threads > MAX_THREADS ||
      bm > STAGES * BK || tile_rows <= 0 || bm % tile_rows ||
      (tile_mask && K > 31) || groups < 1 || groups > 64 ||
      (groups > 1 && (!part || staged)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto fn) {
    return fn(x, w, idx, order, tile_mask, nbr_mask, part, out, rows_out, K,
              cin, cout, bm, bn, tile_rows, groups, st);
  };
  const int err = w_nk ? (staged ? run(launch<true, true>)
                                 : run(launch<true, false>))
                       : (staged ? run(launch<false, true>)
                                 : run(launch<false, false>));
  if (err || groups == 1) return err;
  const size_t n = (size_t)rows_out * cout / 2;
  reduce_groups_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float2*>(part), static_cast<__nv_bfloat162*>(out), n,
      groups);
  return static_cast<int>(cudaGetLastError());
}
