// What the f32 backward tile, field_bwd_f32_sm90.cuh's 3xTF32 tile (K3, K4,
// K6, K7, K8 and K9 with use_bf16=False), takes from the CUDA cores:
// - The composites of a tile's rays and their transposes (MarchComp32,
//   MergedComp32, merged_ray32 with merge_ranks), one warp per ray over the
//   tile's rows as CompTile points to them, K8's per-row cotangents
//   (RowComp32), and demb per ray (ray_demb).
// - The narrow dW jobs' FFMA pass (dw32_kernel over fixed row partitions,
//   summed in order by dw32_reduce) and the row sums' reduction
//   (sum_slots32).
// Every sum runs in a fixed order, so two calls give bit-identical results.

#pragma once

#include "bwd_tiles.cuh"

namespace danerf {
namespace f32 {

constexpr int MAX_TILES_PASS32 = MAX_TILES_PER_PASS / 2;  // 131,072 rows of residuals
constexpr int DRGB32 = 4;          // d_pre_rgb row: 3 used, 16 bytes
constexpr int DW32_TILE = 64;      // dW output tile edge
constexpr int DW32_SLAB = 32;      // rows a step of the dW pass
constexpr int DW32_PARTS = 16;     // most row partitions of the dW pass
constexpr int DW32_PART_ROWS = 4096;  // a partition's rows at least, where there are enough
constexpr int MAX_JOBS32 = 40;
constexpr int DW32_THREADS = 256;  // a block of dw32_kernel
constexpr int COMP_THREADS = 256;  // the threads that run a tile's composite: 8 warps

// Where a backward tile's composite reads the tile's rows (the depths z,
// the field's sigma and rgb, row j s + sample for ray j) and writes their
// cotangents and loss terms (bs); scr holds its per-warp alpha / T / w and
// each ray's merge arrays; sync is a barrier over the COMP_THREADS threads
// that run it.
template <class Sync>
struct CompTile {
  const float* z;
  const float* sigma;
  const float* rgb;
  BwdSmem& bs;
  float* scr;
  Sync sync;
};

// ---------------------------------------------------------------- composite

// The ranks of field.cuh merge_ray's stable merge, by one warp: rank_c[i] =
// i + #{z_f < z_c[i]}, rank_f[j] = j + #{z_c <= z_f[j]} (coarse first on
// ties).
__device__ __forceinline__ void merge_ranks(const float* zc, int Sc, const float* zf, int Sf,
                                            int* rank_c, int* rank_f) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < Sc; i += 32) {
    int cnt = 0;
    for (int k = 0; k < Sf; ++k) cnt += zf[k] < zc[i];
    rank_c[i] = i + cnt;
  }
  for (int i = lane; i < Sf; i += 32) {
    int cnt = 0;
    for (int k = 0; k < Sc; ++k) cnt += zc[k] <= zf[i];
    rank_f[i] = i + cnt;
  }
  __syncwarp();
}

// The ray march's composite: the forward over each ray's own S samples
// kept, its transpose under the cotangents of ray_cotangents<MSE> (K3: the
// caller's, plus the field's own cotangent g_field (R, 4, S), null for
// none; K7: the MSE's); one warp per ray, the per-warp alpha / T / w in
// the tile's composite scratch.
template <bool MSE_>
struct MarchComp32 {
  static constexpr bool MSE = MSE_;
  static constexpr bool ROWS = false;
  RayCot cot;
  const float* g_field;
  int S;
  template <class Sync>
  __device__ void operator()(const CompTile<Sync>& tl, long long ray0, int nvalid, int) const {
    BwdSmem& bs = tl.bs;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int j = warp; j < nvalid; j += COMP_THREADS / 32) {
      const long long r = ray0 + j;
      float* al = tl.scr + warp * 3 * S;
      float out[5], g[5];
      const float* gw;
      composite_keep(tl.z + j * S, tl.sigma + j * S, tl.rgb + j * S * 3, S, al, al + S,
                     al + 2 * S, out);
      ray_cotangents<MSE>(cot, r, S, out, g, &gw, bs.loss + j);
      composite_bwd(tl.z + j * S, tl.rgb + j * S * 3, S, al, al + S, al + 2 * S, out[3], out[4],
                    g[0], g[1], g[2], g[3], g[4], gw, bs.g_rgb + j * S * 3, bs.g_sig + j * S);
      if (!MSE && g_field != nullptr) {
        __syncwarp();
        const float* gf = g_field + r * 4 * S;
        for (int k = lane; k < S; k += 32) {
          const int row = j * S + k;
          bs.g_rgb[row * 3 + 0] += gf[k];
          bs.g_rgb[row * 3 + 1] += gf[S + k];
          bs.g_rgb[row * 3 + 2] += gf[2 * S + k];
          bs.g_sig[row] += gf[3 * S + k];
        }
      }
    }
  }
};

// K8's "composite": each of a row tile's rows (row0.., nvalid of them) takes
// the caller's cotangents g_rgb (N,3) and g_sigma (N).
struct RowComp32 {
  static constexpr bool MSE = false;
  static constexpr bool ROWS = true;
  const float* g_rgb;
  const float* g_sigma;
  template <class Sync>
  __device__ void operator()(const CompTile<Sync>& tl, long long row0, int nvalid, int) const {
    BwdSmem& bs = tl.bs;
    for (int r = threadIdx.x; r < nvalid; r += COMP_THREADS) {
      bs.g_rgb[r * 3 + 0] = g_rgb[(row0 + r) * 3 + 0];
      bs.g_rgb[r * 3 + 1] = g_rgb[(row0 + r) * 3 + 1];
      bs.g_rgb[r * 3 + 2] = g_rgb[(row0 + r) * 3 + 2];
      bs.g_sig[r] = g_sigma[row0 + r];
    }
  }
};

// One ray's merged composite by one warp (K4, K6, K9): the fine rows j Sf..
// of the tile's rgb / sigma (depths zf) merged by rank with the coarse field fc
// ((4, Sc), depths zc), the composite over Sa = Sc + Sf and its transpose
// under the cotangents of ray_cotangents<MSE> (the loss term to
// bs.loss[j]), the un-permute by the ranks to the coarse field's cotangent
// gf ((4, Sc)) and the fine rows' bs.g_rgb / bs.g_sig.  al: the alpha / T /
// w (3 Sa), m: the merged z, sigma, rgb and the ranks (6 Sa).
template <bool MSE>
__device__ __forceinline__ void merged_ray32(const float* rgb, const float* sigma, BwdSmem& bs,
                                             const RayCot& cot, long long r, int j,
                                             const float* zc, int Sc, const float* zf, int Sf,
                                             const float* fc, float* gf, float* al, float* m) {
  const int Sa = Sc + Sf, lane = threadIdx.x & 31;
  float* mz = m;
  float* msig = mz + Sa;
  float* mrgb = msig + Sa;
  int* rank_c = reinterpret_cast<int*>(mrgb + 3 * Sa);
  int* rank_f = rank_c + Sc;
  merge_ray(rgb, sigma, zc, Sc, zf, Sf, fc, j * Sf, mz, msig, mrgb);
  merge_ranks(zc, Sc, zf, Sf, rank_c, rank_f);
  float out[5], g[5];
  const float* gw;
  composite_keep(mz, msig, mrgb, Sa, al, al + Sa, al + 2 * Sa, out);
  ray_cotangents<MSE>(cot, r, Sa, out, g, &gw, bs.loss + j);
  // the transpose overwrites the merged rgb / sigma with their cotangents
  composite_bwd(mz, mrgb, Sa, al, al + Sa, al + 2 * Sa, out[3], out[4], g[0], g[1], g[2], g[3],
                g[4], gw, mrgb, msig);
  __syncwarp();
  for (int i = lane; i < Sc; i += 32) {
    const int k = rank_c[i];
    gf[i] = mrgb[k * 3 + 0];
    gf[Sc + i] = mrgb[k * 3 + 1];
    gf[2 * Sc + i] = mrgb[k * 3 + 2];
    gf[3 * Sc + i] = msig[k];
  }
  for (int i = lane; i < Sf; i += 32) {
    const int k = rank_f[i], row = j * Sf + i;
    bs.g_rgb[row * 3 + 0] = mrgb[k * 3 + 0];
    bs.g_rgb[row * 3 + 1] = mrgb[k * 3 + 1];
    bs.g_rgb[row * 3 + 2] = mrgb[k * 3 + 2];
    bs.g_sig[row] = msig[k];
  }
}

// The merged composite (K4: under the MSE's cotangents; K6: the caller's,
// g_w (R, Sc + Sf) in merged order): merged_ray32 for each ray with the
// coarse field fc (R, 4, Sc) at depths zc, its cotangent to g_field (R, 4,
// Sc).  Its arrays (the per-warp alpha / T / w, the coarse depths and each
// ray's merged z, sigma, rgb and ranks) in the tile's composite scratch.
template <bool MSE_>
struct MergedComp32 {
  static constexpr bool MSE = MSE_;
  static constexpr bool ROWS = false;
  RayCot cot;
  const float* zc;
  const float* fc;
  float* gfield;
  long long R;
  int Sc, Sf;
  template <class Sync>
  __device__ void operator()(const CompTile<Sync>& tl, long long ray0, int nvalid,
                             int rpc) const {
    const int Sa = Sc + Sf, warp = threadIdx.x >> 5;
    float* zc_s = tl.scr + (COMP_THREADS / 32) * 3 * Sa;  // rpc x Sc
    float* merge = zc_s + rpc * Sc;                        // rpc x 6 Sa
    for (int idx = threadIdx.x; idx < rpc * Sc; idx += COMP_THREADS) {
      const long long r = ray0 + idx / Sc;
      zc_s[idx] = r < R ? zc[r * Sc + idx % Sc] : 0.f;
    }
    tl.sync();
    for (int j = warp; j < nvalid; j += COMP_THREADS / 32) {
      const long long r = ray0 + j;
      merged_ray32<MSE>(tl.rgb, tl.sigma, tl.bs, cot, r, j, zc_s + j * Sc, Sc, tl.z + j * Sf, Sf,
                        fc + r * 4 * Sc, gfield + r * 4 * Sc, tl.scr + warp * 3 * Sa,
                        merge + j * 6 * Sa);
    }
  }
};

// Each of the tile's n rays' demb = (its rows' d_happ summed in bs.dsum) @
// Wapp (w: the packed f32 weights), after a barrier, by COMP_THREADS
// threads.
__device__ __forceinline__ void ray_demb(const FieldArgs& P, const float* w, const BwdSmem& bs,
                                         long long ray0, int n, float* __restrict__ demb) {
  const float* wapp = w + P.wapp_off;  // (HALF, E)
  const int E = P.emb_dim;
  for (int idx = threadIdx.x; idx < n * E; idx += COMP_THREADS) {
    const int j = idx / E, e = idx - j * E;
    float a = 0.f;
    for (int c = 0; c < HALF; ++c) a += bs.dsum[j * HALF + c] * wapp[c * E + e];
    demb[(ray0 + j) * E + e] = a;
  }
}

// ------------------------------------------------------------- dW pass

// C[n_out_store x n_k] (row stride ldc) += A^T B over the pass's rows, A
// (rows x lda) and B (rows x ldb) f32 row-major.
struct Dw32Job {
  const float* a;
  const float* b;
  float* c;
  int lda, n_out, n_out_store, ldb, n_k, ldc, tiles_k, tile0;
};

struct Dw32Jobs {
  Dw32Job job[MAX_JOBS32];
  int n;
  long long rows;
};

__device__ __forceinline__ int find_job32(const Dw32Jobs& J, int tile) {
  int ji = 0;
  while (ji + 1 < J.n && J.job[ji + 1].tile0 <= tile) ++ji;
  return ji;
}

// One block: one 64 x 64 tile of one job over the rows of partition
// blockIdx.y; thread (ty, tx) owns outputs 4 ty.. x 4 tx..; each 32-row
// slab of A and B lies in shared memory as in the stash, so a step reads
// one 16-byte A value (broadcast) and one B value; the partial tile goes to
// dwpart.
__global__ void __launch_bounds__(DW32_THREADS)
dw32_kernel(const Dw32Jobs J, float* __restrict__ dwpart, int n_tiles) {
  __shared__ __align__(16) float As[DW32_SLAB][DW32_TILE];  // [row][out]
  __shared__ __align__(16) float Bs[DW32_SLAB][DW32_TILE];  // [row][k]
  const int tile = blockIdx.x;
  const Dw32Job& jb = J.job[find_job32(J, tile)];
  const int local = tile - jb.tile0;
  const int out0 = (local / jb.tiles_k) * DW32_TILE, k0 = (local % jb.tiles_k) * DW32_TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long per =
      (J.rows + gridDim.y * (long long)DW32_SLAB - 1) / (gridDim.y * (long long)DW32_SLAB) * DW32_SLAB;
  const long long r_begin = blockIdx.y * per;
  const long long r_end = r_begin + per < J.rows ? r_begin + per : J.rows;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long r0 = r_begin; r0 < r_end; r0 += DW32_SLAB) {
    for (int idx = threadIdx.x; idx < DW32_SLAB * (DW32_TILE / 4); idx += DW32_THREADS) {
      const int r = idx / (DW32_TILE / 4), c = (idx % (DW32_TILE / 4)) * 4;
      const bool in = r0 + r < r_end;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (in && out0 + c < jb.n_out)
        va = *reinterpret_cast<const float4*>(jb.a + (r0 + r) * jb.lda + out0 + c);
      if (in && k0 + c < jb.n_k)
        vb = *reinterpret_cast<const float4*>(jb.b + (r0 + r) * jb.ldb + k0 + c);
      *reinterpret_cast<float4*>(&As[r][c]) = va;
      *reinterpret_cast<float4*>(&Bs[r][c]) = vb;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DW32_SLAB; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = dwpart + ((long long)blockIdx.y * n_tiles + tile) * DW32_TILE * DW32_TILE;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (4 * ty + i) * DW32_TILE + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// C += the sum of the partitions' partial tiles, in partition order.
__global__ void dw32_reduce(const Dw32Jobs J, const float* __restrict__ dwpart, int n_tiles,
                            int parts) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_tiles * DW32_TILE * DW32_TILE) return;
  const int tile = (int)(idx / (DW32_TILE * DW32_TILE));
  const int e = (int)(idx - (long long)tile * DW32_TILE * DW32_TILE);
  const Dw32Job& jb = J.job[find_job32(J, tile)];
  const int local = tile - jb.tile0;
  const int m = (local / jb.tiles_k) * DW32_TILE + e / DW32_TILE;
  const int n = (local % jb.tiles_k) * DW32_TILE + e % DW32_TILE;
  if (m >= jb.n_out_store || n >= jb.n_k) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p)
    s += dwpart[((long long)p * n_tiles + tile) * DW32_TILE * DW32_TILE + e];
  jb.c[(long long)m * jb.ldc + n] += s;
}

// gvecs[j] += the sum over the slots of part[slot * nv + j] (the last
// column: *loss), each of the 8 warps summing every 8th slot in order, then
// the warps in order (field_bwd_sm90.cuh reduce_slots' order).
__global__ void __launch_bounds__(256)
sum_slots32(const float* __restrict__ part, int slots, int nv, int n_vecs, float* gvecs,
            float* loss) {
  __shared__ float ws[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < nv)
    for (int t = w; t < slots; t += 8) s += part[(long long)t * nv + j];
  ws[w][lane] = s;
  __syncthreads();
  if (w == 0 && j < nv) {
    float a = 0.f;
    for (int k = 0; k < 8; ++k) a += ws[k][lane];
    if (j < n_vecs) gvecs[j] += a;
    else if (loss != nullptr) *loss += a;
  }
}

inline void add_job32(Dw32Jobs& J, int& tiles, const float* a, int lda, int n_out,
                      int n_out_store, const float* b, int ldb, int n_k, float* c, int ldc) {
  Dw32Job& j = J.job[J.n++];
  j.a = a; j.lda = lda; j.n_out = n_out; j.n_out_store = n_out_store;
  j.b = b; j.ldb = ldb; j.n_k = n_k; j.c = c; j.ldc = ldc;
  j.tiles_k = (n_k + DW32_TILE - 1) / DW32_TILE;
  j.tile0 = tiles;
  tiles += ((n_out + DW32_TILE - 1) / DW32_TILE) * j.tiles_k;
}


}  // namespace f32
}  // namespace danerf
