// Shared device code of the ray-march (march.cu) and merged-composite
// (merged.cu) kernels, the per-sample field kernel (mlp_fwd.cu), and the
// forward half of the backward kernels (field_bwd.cuh): the NeRF-W field on
// a tile of 128 samples, the counterpart of
// danerf_tpu/kernels/fused_mlp.py _encode + _field_from_enc.
//
// Numerics (use_bf16): encodings and activations are held in bf16, every
// matmul accumulates in f32 on the tensor cores (mma.sync m16n8k16 bf16),
// the density head is an f32 multiply-and-sum over the bf16 trunk output,
// and happ = relu(hdir_pre) + emb@Wapp + bapp is formed in f32 before the
// bf16 rgb matmul -- the same roundings as the JAX kernel, in another
// summation order.
//
// Two ways to fill a tile: rays of s samples (the ray kernels: per-ray
// origin, direction, embedding and time in Smem, a depth per row; emb@Wapp
// once per ray), or 128 independent rows (mlp_fwd.cu, mlp_bwd.cu: a point,
// direction, embedding and time per row in RowSmem; emb@Wapp a tensor-core
// product per row).  field_tile<ROWS> takes either; the trunk and heads are
// one code path.
//
// Time (use_time, the JAX kernels' has_time variants): the encoded time
// [t, sin(2^i t), cos(2^i t), ...] follows the encoded position in the
// position encoding's columns, so it enters the first layer and every skip
// layer with it; a null t pointer means a layout without time.  At the
// default widths that is kx = 80 instead of 64 (63 + 13 columns, padded to
// 16) and 534,528 MACs a sample instead of 527,872 (+1.3%).
//
// Layout: a CTA of 8 warps owns TILE_M = 128 rows (rays x samples).  Its
// activations live in shared memory (two 128 x 256 bf16 ping-pong buffers
// plus the encodings, ~170 KB).  Weights are not staged: each warp owns a
// 32-column (16 for the dir layer) slice of every layer's output and reads
// its B fragments straight from global memory, where the 1.1 MB of packed
// bf16 weights stay L2-resident; each weight is read once per CTA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace danerf {

constexpr int HID = 256;            // trunk width (kernel-supported value)
constexpr int HALF = HID / 2;       // dir-branch width
constexpr int TILE_M = 128;         // rows (samples) per CTA
constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int M_TILES = TILE_M / 16;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_RPC = 8;          // rays per CTA
constexpr int MAX_KX = 80;          // padded position (+ time) encoding width
constexpr int MAX_KD = 32;          // padded direction encoding width
constexpr int MAX_E = 64;           // appearance embedding width
// Row strides in bf16 elements; the +8 shifts consecutive rows by 16 bytes
// mod 128 so the 8 row addresses of an ldmatrix hit distinct banks (LDX =
// 88: 176 B a row, rows 0..7 at 0, 48, 96, 16, 64, 112, 32, 80 mod 128).
constexpr int LDH = HID + 8;
constexpr int LDX = MAX_KX + 8;
constexpr int LDD = MAX_KD + 8;
constexpr int LDE = MAX_E + 8;

struct FieldArgs {
  const __nv_bfloat16* mats;   // packed matrices, (out, K_pad) row-major
  const float* vecs;           // biases + density weight
  int num_layers, skip_mask, pos_levels, dir_levels, kx, kd, softplus, emb_dim;
  int time_levels;             // -1: no time input
  int nt;                      // time encoding width: 0, or 1 + 2 time_levels
  long long w_off[MAX_LAYERS], b_off[MAX_LAYERS];
  long long wd_off, bd_off, wdir_off, bdir_off, wapp_off, bapp_off, wrgb_off, brgb_off;
};

struct Smem {
  __nv_bfloat16 hA[TILE_M * LDH];
  __nv_bfloat16 hB[TILE_M * LDH];
  __nv_bfloat16 encx[TILE_M * LDX];
  __nv_bfloat16 encd[TILE_M * LDD];
  float rgb[TILE_M * 3];
  float sigma[TILE_M];
  float sigma_pre[TILE_M];     // density head before its activation
  float z[TILE_M];
  float app[MAX_RPC * HALF];   // per-ray emb@Wapp (f32)
  float o[MAX_RPC * 3], d[MAX_RPC * 3];
  float emb[MAX_RPC * MAX_E];
  float t[MAX_RPC];            // per-ray time (0 without time)
};

// The per-row inputs of a tile of independent rows (K1, K8), beside Smem;
// zeros past the last row.  The embedding is held in bf16 as the A operand
// of emb @ Wapp^T.
struct RowSmem {
  float x[TILE_M * 3];
  float d[TILE_M * 3];
  float t[TILE_M];             // per-row time (0 without time)
  __nv_bfloat16 emb[TILE_M * LDE];
};

// Where the backward kernels (field_bwd.cuh) want field_tile to leave its
// residuals in device memory: every trunk layer's output, the encodings,
// happ (bf16) and the dir layer's relu gate, at the tile's rows row0.. of
// (rows x width) row-major buffers.  The forward kernels pass none.
struct Stash {
  __nv_bfloat16* h;            // L x rows x HID, layer stride layer_stride
  __nv_bfloat16* encx;         // rows x kx
  __nv_bfloat16* encd;         // rows x kd
  __nv_bfloat16* happ;         // rows x HALF
  unsigned char* dirg;         // rows x HALF, 1 where the dir layer's input to relu > 0
  long long layer_stride;
  long long row0;
};

// Error codes below 0 are argument errors; codes >= 0 are cudaError_t.
constexpr int ERR_META = -1;      // packed layout record malformed
constexpr int ERR_SHAPE = -2;     // a width this kernel does not take

// Parse the integer layout record written by kernels/fused_mlp.py
// kernel_meta(): a head of META_HEAD values, L weight and L bias offsets, and
// the 8 offsets of the heads.
constexpr int META_HEAD = 10;
inline int parse_meta(const long long* meta, long long n_meta, const void* mats,
                      const float* vecs, long long emb_dim, FieldArgs* a) {
  if (n_meta < META_HEAD) return ERR_META;
  const int L = (int)meta[0];
  if (L < 1 || L > MAX_LAYERS || n_meta != META_HEAD + 2 * L + 8) return ERR_META;
  a->mats = static_cast<const __nv_bfloat16*>(mats);
  a->vecs = vecs;
  a->num_layers = L;
  a->skip_mask = (int)meta[1];
  a->pos_levels = (int)meta[2];
  a->dir_levels = (int)meta[3];
  a->kx = (int)meta[4];
  a->kd = (int)meta[5];
  const long long hidden = meta[6];
  a->softplus = (int)meta[7];
  a->emb_dim = (int)meta[8];
  a->time_levels = (int)meta[9];
  a->nt = a->time_levels < 0 ? 0 : 1 + 2 * a->time_levels;
  if (hidden != HID || a->emb_dim != emb_dim || a->emb_dim < 1 || a->emb_dim > MAX_E ||
      a->kx > MAX_KX || a->kd > MAX_KD || a->kx % 16 || a->kd % 16 || a->time_levels < -1 ||
      a->kx < 3 * (1 + 2 * a->pos_levels) + a->nt || a->kd < 3 * (1 + 2 * a->dir_levels))
    return ERR_SHAPE;
  for (int i = 0; i < L; ++i) {
    a->w_off[i] = meta[META_HEAD + i];
    a->b_off[i] = meta[META_HEAD + L + i];
  }
  const long long* t = meta + META_HEAD + 2 * L;
  a->wd_off = t[0]; a->bd_off = t[1]; a->wdir_off = t[2]; a->bdir_off = t[3];
  a->wapp_off = t[4]; a->bapp_off = t[5]; a->wrgb_off = t[6]; a->brgb_off = t[7];
  return 0;
}

// A time input where the layout has time columns, none where it has not.
inline int check_time(const FieldArgs& P, const float* t) {
  return (t != nullptr) == (P.nt > 0) ? 0 : ERR_SHAPE;
}

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[mt][nt] += X[128 x K] @ W^T for the warp's NT*8 output columns from
// n_base.  X is the concatenation of two shared-memory segments (widths ka,
// kb, multiples of 16); W is (N, ka + kb) row-major bf16 in global memory,
// which is exactly the mma "col" layout of B, so a B fragment is two 32-bit
// loads.
template <int NT>
__device__ __forceinline__ void gemm_tile(const __nv_bfloat16* seg_a, int lda, int ka,
                                          const __nv_bfloat16* seg_b, int ldb, int kb,
                                          const __nv_bfloat16* __restrict__ W, int n_base,
                                          float (&acc)[M_TILES][NT][4]) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kp = ka + kb;
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  const __nv_bfloat16* wrow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) wrow[nt] = W + (long long)(n_base + nt * 8 + gid) * kp + 2 * tig;

  for (int k0 = 0; k0 < kp; k0 += 16) {
    const __nv_bfloat16* src;
    int ld, kk;
    if (k0 < ka) { src = seg_a; ld = lda; kk = k0; }
    else         { src = seg_b; ld = ldb; kk = k0 - ka; }
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b[nt][0] = __ldg(reinterpret_cast<const unsigned int*>(wrow[nt] + k0));
      b[nt][1] = __ldg(reinterpret_cast<const unsigned int*>(wrow[nt] + k0 + 8));
    }
    const __nv_bfloat16* arow = src + (lane & 15) * ld + kk + (lane >> 4) * 8;
#pragma unroll
    for (int mt = 0; mt < M_TILES; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + mt * 16 * ld);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
    }
  }
}

// Copy a 128-row bf16 tile from shared memory (row stride lds) to device
// memory (row stride ldg), 16 bytes a thread; cols, lds and ldg are
// multiples of 8.
__device__ __forceinline__ void copy_tile_out(const __nv_bfloat16* s, int lds, int cols,
                                              __nv_bfloat16* g, long long ldg) {
  const int vec = cols / 8;
  for (int idx = threadIdx.x; idx < TILE_M * vec; idx += THREADS) {
    const int r = idx / vec, c = (idx - r * vec) * 8;
    *reinterpret_cast<uint4*>(g + r * ldg + c) = *reinterpret_cast<const uint4*>(s + r * lds + c);
  }
}

// ------------------------------------------------------------- tile stages

// Column c of an encoding of 3-vectors: [v, sin(2^0 v), cos(2^0 v), ...]
// -> the input dimension, the level and whether it is a cos column.
__device__ __forceinline__ void enc_col(int c, int* dim, int* lvl, bool* is_cos) {
  *dim = c;
  *lvl = 0;
  *is_cos = false;
  if (c >= 3) {
    const int q = c - 3;
    *lvl = q / 6;
    const int w = q - *lvl * 6;
    *dim = w % 3;
    *is_cos = w >= 3;
  }
}

// Column c of an encoding of a scalar: [v, sin(2^0 v), cos(2^0 v), ...] ->
// the level and whether it is a cos column (the JAX _encode_consts(levels,
// dim=1) order).
__device__ __forceinline__ void enc_col1(int c, int* lvl, bool* is_cos) {
  const int q = c > 0 ? c - 1 : 0;
  *lvl = q / 2;
  *is_cos = c > 0 && (q % 2) == 1;
}

// Fill sm.encx / sm.encd for the tile: y = pos(row, dim, 2^i), the input
// column for i = 0, else sin(y + phase) (cos columns carry phase pi/2), the
// TPU kernel's form; with time, columns nx .. nx + nt of encx likewise from
// y = tim(row) 2^i; the direction likewise from dir(row, dim) 2^i.  Padded
// columns and rows where valid(row) is false are 0.
template <class Pos, class Tim, class Dir, class Valid>
__device__ __forceinline__ void encode_cols(const FieldArgs& P, Smem& sm, Pos pos, Tim tim,
                                            Dir dir, Valid valid) {
  const int nx = 3 * (1 + 2 * P.pos_levels);
  const int nd = 3 * (1 + 2 * P.dir_levels);
  const float half_pi = 1.57079637f;
  for (int idx = threadIdx.x; idx < TILE_M * P.kx; idx += THREADS) {
    const int row = idx / P.kx, c = idx - row * P.kx;
    float v = 0.f;
    if (valid(row) && c < nx) {
      int dim, lvl;
      bool is_cos;
      enc_col(c, &dim, &lvl, &is_cos);
      const float y = pos(row, dim, (float)(1 << lvl));
      v = (c < 3) ? y : sinf(is_cos ? __fadd_rn(y, half_pi) : y);
    } else if (valid(row) && c < nx + P.nt) {
      int lvl;
      bool is_cos;
      enc_col1(c - nx, &lvl, &is_cos);
      const float y = tim(row) * (float)(1 << lvl);
      v = (c == nx) ? y : sinf(is_cos ? __fadd_rn(y, half_pi) : y);
    }
    sm.encx[row * LDX + c] = __float2bfloat16_rn(v);
  }
  for (int idx = threadIdx.x; idx < TILE_M * P.kd; idx += THREADS) {
    const int row = idx / P.kd, c = idx - row * P.kd;
    float v = 0.f;
    if (valid(row) && c < nd) {
      int dim, lvl;
      bool is_cos;
      enc_col(c, &dim, &lvl, &is_cos);
      const float y = dir(row, dim) * (float)(1 << lvl);
      v = (c < 3) ? y : sinf(is_cos ? __fadd_rn(y, half_pi) : y);
    }
    sm.encd[row * LDD + c] = __float2bfloat16_rn(v);
  }
}

// A tile of rays: row = ray j * s + sample, the position o + z d encoded as
// y = 2^i o + z (2^i d), without forming the point.
__device__ void encode_tile(const FieldArgs& P, Smem& sm, int s, int rpc) {
  encode_cols(
      P, sm,
      [&](int row, int dim, float f) {
        const int j = row / s;
        const float a = sm.o[j * 3 + dim] * f;
        const float b = sm.d[j * 3 + dim] * f;
        return __fadd_rn(a, __fmul_rn(sm.z[row], b));
      },
      [&](int row) { return sm.t[row / s]; },
      [&](int row, int dim) { return sm.d[(row / s) * 3 + dim]; },
      [&](int row) { return row / s < rpc; });
  // per-ray appearance term emb @ Wapp^T (bf16 inputs, f32 sum); bapp is
  // added after relu(hdir_pre) + this, in the JAX kernel's order
  const __nv_bfloat16* wapp = P.mats + P.wapp_off;
  for (int idx = threadIdx.x; idx < rpc * HALF; idx += THREADS) {
    const int j = idx / HALF, n = idx - j * HALF;
    float acc = 0.f;
    for (int k = 0; k < P.emb_dim; ++k)
      acc += bf16_round(sm.emb[j * P.emb_dim + k]) * __bfloat162float(wapp[n * P.emb_dim + k]);
    sm.app[j * HALF + n] = acc;
  }
}

// A tile of independent rows (after load_rows): y = 2^i x, the encoding of
// danerf_tpu's _encode(pts); rows from nvalid on are 0.  The appearance
// term is formed per row inside field_tile<true>.
__device__ void encode_rows(const FieldArgs& P, Smem& sm, const RowSmem& rs, int nvalid) {
  encode_cols(
      P, sm, [&](int row, int dim, float f) { return rs.x[row * 3 + dim] * f; },
      [&](int row) { return rs.t[row]; },
      [&](int row, int dim) { return rs.d[row * 3 + dim]; },
      [&](int row) { return row < nvalid; });
}

// The field on the tile: needs encode_tile's (encode_rows's for ROWS)
// output and a __syncthreads after it; leaves sm.rgb (128 x 3), sm.sigma and
// sm.sigma_pre (128) valid behind a __syncthreads.  Rays: s = samples per
// ray in the tile's rows, the appearance term from sm.app.  ROWS: the
// appearance term is embx (128 x E bf16, row stride LDE) @ Wapp^T on the
// tensor cores, in registers beside the dir layer's accumulator.  Returns
// the buffer (sm.hA or sm.hB) holding the last trunk layer's output; the
// other one holds happ.  With a stash, the residuals also go to it.
template <bool ROWS = false>
__device__ __nv_bfloat16* field_tile(const FieldArgs& P, Smem& sm, int s, int rpc,
                                     const Stash* st = nullptr,
                                     const __nv_bfloat16* embx = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* cur = sm.hA;
  __nv_bfloat16* nxt = sm.hB;
  if (st != nullptr) {
    copy_tile_out(sm.encx, LDX, P.kx, st->encx + st->row0 * P.kx, P.kx);
    copy_tile_out(sm.encd, LDD, P.kd, st->encd + st->row0 * P.kd, P.kd);
  }

  for (int i = 0; i < P.num_layers; ++i) {
    const __nv_bfloat16* W = P.mats + P.w_off[i];
    const float* bias = P.vecs + P.b_off[i];
    const int n_base = warp * 32;
    // layer 0 reads enc_x; a skip layer reads [h, enc_x]; the rest read h
    const bool skip = i > 0 && ((P.skip_mask >> i) & 1);
    float acc[M_TILES][4][4];
    gemm_tile<4>(i == 0 ? sm.encx : cur, i == 0 ? LDX : LDH, i == 0 ? P.kx : HID,
                 sm.encx, LDX, skip ? P.kx : 0, W, n_base, acc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n_base + nt * 8 + 2 * tig;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
      for (int mt = 0; mt < M_TILES; ++mt) {
        const int row = mt * 16 + gid;
        *reinterpret_cast<__nv_bfloat162*>(nxt + row * LDH + col) = __floats2bfloat162_rn(
            fmaxf(acc[mt][nt][0] + b0, 0.f), fmaxf(acc[mt][nt][1] + b1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(nxt + (row + 8) * LDH + col) = __floats2bfloat162_rn(
            fmaxf(acc[mt][nt][2] + b0, 0.f), fmaxf(acc[mt][nt][3] + b1, 0.f));
      }
    }
    __syncthreads();
    if (st != nullptr)
      copy_tile_out(nxt, LDH, HID, st->h + i * st->layer_stride + st->row0 * HID, HID);
    __nv_bfloat16* t = cur; cur = nxt; nxt = t;
  }

  // dir branch: happ = (relu([h, enc_d] @ Wdir^T + bdir) + emb@Wapp^T) + bapp
  {
    const int n_base = warp * 16;
    float acc[M_TILES][2][4];
    gemm_tile<2>(cur, LDH, HID, sm.encd, LDD, P.kd, P.mats + P.wdir_off, n_base, acc);
    float app_acc[M_TILES][2][4];
    if constexpr (ROWS)
      gemm_tile<2>(embx, LDE, P.emb_dim, embx, LDE, 0, P.mats + P.wapp_off, n_base, app_acc);
    const float* bdir = P.vecs + P.bdir_off;
    const float* bapp = P.vecs + P.bapp_off;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n_base + nt * 8 + 2 * tig;
      const float b0 = __ldg(bdir + col), b1 = __ldg(bdir + col + 1);
      const float a0 = __ldg(bapp + col), a1 = __ldg(bapp + col + 1);
#pragma unroll
      for (int mt = 0; mt < M_TILES; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + gid + 8 * h;
          float e0, e1;
          if constexpr (ROWS) {
            e0 = app_acc[mt][nt][2 * h];
            e1 = app_acc[mt][nt][2 * h + 1];
          } else {
            const float* app = sm.app + min(row / s, rpc - 1) * HALF;
            e0 = app[col];
            e1 = app[col + 1];
          }
          const float p0 = acc[mt][nt][2 * h] + b0, p1 = acc[mt][nt][2 * h + 1] + b1;
          const float v0 = (fmaxf(p0, 0.f) + e0) + a0;
          const float v1 = (fmaxf(p1, 0.f) + e1) + a1;
          *reinterpret_cast<__nv_bfloat162*>(nxt + row * LDH + col) = __floats2bfloat162_rn(v0, v1);
          if (st != nullptr) {
            unsigned char* g = st->dirg + (st->row0 + row) * HALF + col;
            g[0] = p0 > 0.f;
            g[1] = p1 > 0.f;
          }
        }
      }
    }
  }

  // density head on the final trunk output (cur, read-only here): f32
  // products of the bf16 activations with the f32 weight
  {
    const float* wd = P.vecs + P.wd_off;
    const float bd = __ldg(P.vecs + P.bd_off);
    for (int r = warp * (TILE_M / WARPS); r < (warp + 1) * (TILE_M / WARPS); ++r) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < HID / 32; ++q) {
        const int k = lane * (HID / 32) + q;
        acc += __bfloat162float(cur[r * LDH + k]) * __ldg(wd + k);
      }
      acc = warp_sum(acc) + bd;
      if (lane == 0) {
        sm.sigma_pre[r] = acc;
        float sg;
        if (P.softplus)
          sg = fmaxf(acc, 0.f) + log1pf(expf(-fabsf(acc)));
        else
          sg = fmaxf(acc, 0.f);
        sm.sigma[r] = sg;
      }
    }
  }
  __syncthreads();
  if (st != nullptr) copy_tile_out(nxt, LDH, HALF, st->happ + st->row0 * HALF, HALF);

  // rgb head: sigmoid(happ_bf16 @ Wrgb^T + brgb), N = 3
  {
    const __nv_bfloat16* wrgb = P.mats + P.wrgb_off;
    const float* brgb = P.vecs + P.brgb_off;
    for (int r = warp * (TILE_M / WARPS); r < (warp + 1) * (TILE_M / WARPS); ++r) {
      float c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
      for (int q = 0; q < HALF / 32; ++q) {
        const int k = lane * (HALF / 32) + q;
        const float h = __bfloat162float(nxt[r * LDH + k]);
        c0 += h * __bfloat162float(wrgb[k]);
        c1 += h * __bfloat162float(wrgb[HALF + k]);
        c2 += h * __bfloat162float(wrgb[2 * HALF + k]);
      }
      c0 = warp_sum(c0); c1 = warp_sum(c1); c2 = warp_sum(c2);
      if (lane == 0) {
        sm.rgb[r * 3 + 0] = 1.f / (1.f + expf(-(c0 + __ldg(brgb + 0))));
        sm.rgb[r * 3 + 1] = 1.f / (1.f + expf(-(c1 + __ldg(brgb + 1))));
        sm.rgb[r * 3 + 2] = 1.f / (1.f + expf(-(c2 + __ldg(brgb + 2))));
      }
    }
  }
  __syncthreads();
  return cur;
}

// Load a tile's per-ray inputs (zeros past R; t may be null) into shared
// memory.
__device__ void load_rays(Smem& sm, const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ emb, const float* __restrict__ t,
                          int emb_dim, long long ray0, int rpc, long long R) {
  for (int idx = threadIdx.x; idx < rpc * 3; idx += THREADS) {
    const long long r = ray0 + idx / 3;
    sm.o[idx] = r < R ? o[r * 3 + idx % 3] : 0.f;
    sm.d[idx] = r < R ? d[r * 3 + idx % 3] : 0.f;
  }
  for (int j = threadIdx.x; j < rpc; j += THREADS)
    sm.t[j] = (t != nullptr && ray0 + j < R) ? t[ray0 + j] : 0.f;
  for (int idx = threadIdx.x; idx < rpc * emb_dim; idx += THREADS) {
    const long long r = ray0 + idx / emb_dim;
    sm.emb[idx] = r < R ? emb[r * emb_dim + idx % emb_dim] : 0.f;
  }
}

// Load a tile's per-row inputs, rows row0 .. row0 + nvalid of x, d (N,3),
// emb (N,E) and t (N; may be null), into RowSmem; zeros on the tile's other
// rows.
__device__ void load_rows(RowSmem& rs, const float* __restrict__ x, const float* __restrict__ d,
                          const float* __restrict__ emb, const float* __restrict__ t,
                          int emb_dim, long long row0, int nvalid) {
  for (int idx = threadIdx.x; idx < TILE_M * 3; idx += THREADS) {
    const bool ok = idx / 3 < nvalid;
    rs.x[idx] = ok ? x[row0 * 3 + idx] : 0.f;
    rs.d[idx] = ok ? d[row0 * 3 + idx] : 0.f;
  }
  for (int r = threadIdx.x; r < TILE_M; r += THREADS)
    rs.t[r] = (t != nullptr && r < nvalid) ? t[row0 + r] : 0.f;
  for (int idx = threadIdx.x; idx < TILE_M * emb_dim; idx += THREADS) {
    const int r = idx / emb_dim, k = idx - r * emb_dim;
    rs.emb[r * LDE + k] = __float2bfloat16_rn(r < nvalid ? emb[(row0 + r) * emb_dim + k] : 0.f);
  }
}

// Stable rank merge of one ray's samples by one warp (K5, K4): the sorted
// coarse depths zc (Sc) with their field fc (the ray's (4, Sc) slice of
// K2's output) and the sorted fine depths zf (Sf) whose field is the tile's
// rows row0.. of sm.rgb / sm.sigma.  rank_c = i + #{z_f < z_c[i]}, rank_f =
// j + #{z_c <= z_f[j]} (coarse first on ties) replaces the TPU kernel's
// one-hot permutation matmuls.  Writes the merged z, sigma, rgb (Sc + Sf)
// and, when given, the ranks.
__device__ void merge_ray(const Smem& sm, const float* zc, int Sc, const float* zf, int Sf,
                          const float* __restrict__ fc, int row0, float* mz, float* msig,
                          float* mrgb, int* rank_c, int* rank_f) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < Sc; i += 32) {
    const float zv = zc[i];
    int cnt = 0;
    for (int k = 0; k < Sf; ++k) cnt += zf[k] < zv;
    const int k = i + cnt;
    if (rank_c != nullptr) rank_c[i] = k;
    mz[k] = zv;
    mrgb[k * 3 + 0] = fc[i];
    mrgb[k * 3 + 1] = fc[Sc + i];
    mrgb[k * 3 + 2] = fc[2 * Sc + i];
    msig[k] = fc[3 * Sc + i];
  }
  for (int i = lane; i < Sf; i += 32) {
    const float zv = zf[i];
    int cnt = 0;
    for (int k = 0; k < Sc; ++k) cnt += zc[k] <= zv;
    const int k = i + cnt;
    const int row = row0 + i;
    if (rank_f != nullptr) rank_f[i] = k;
    mz[k] = zv;
    mrgb[k * 3 + 0] = sm.rgb[row * 3 + 0];
    mrgb[k * 3 + 1] = sm.rgb[row * 3 + 1];
    mrgb[k * 3 + 2] = sm.rgb[row * 3 + 2];
    msig[k] = sm.sigma[row];
  }
  __syncwarp();
}

// Composite one ray with one warp: alpha = 1 - exp(-sigma * dist) (1e-3 tail
// distance), T = exclusive product of (1 - alpha + 1e-10) as a warp scan
// over per-lane chunks (the TPU kernel's triangular matmul becomes a scan),
// w = alpha T, depth = sum(w z) / (acc + 1e-10).  Writes w_out[0..n) and the
// ray's rgb/depth/acc.
__device__ void composite_ray(const float* z, const float* sig, const float* rgb, int n,
                              float* __restrict__ w_out, float* __restrict__ rgb_out,
                              float* __restrict__ depth_out, float* __restrict__ acc_out) {
  const int lane = threadIdx.x & 31;
  const int chunk = (n + 31) / 32;
  const int s0 = min(n, lane * chunk), s1 = min(n, s0 + chunk);
  float prod = 1.f;
  for (int s = s0; s < s1; ++s) {
    const float dist = (s + 1 < n) ? z[s + 1] - z[s] : 1e-3f;
    const float alpha = 1.f - expf(-sig[s] * dist);
    prod *= 1.f - alpha + 1e-10f;
  }
  float incl = prod;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl *= v;
  }
  float T = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) T = 1.f;
  float acc = 0.f, wz = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f;
  for (int s = s0; s < s1; ++s) {
    const float dist = (s + 1 < n) ? z[s + 1] - z[s] : 1e-3f;
    const float alpha = 1.f - expf(-sig[s] * dist);
    const float w = alpha * T;
    w_out[s] = w;
    acc += w;
    wz += w * z[s];
    r0 += w * rgb[s * 3 + 0];
    r1 += w * rgb[s * 3 + 1];
    r2 += w * rgb[s * 3 + 2];
    T *= 1.f - alpha + 1e-10f;
  }
  acc = warp_sum(acc); wz = warp_sum(wz);
  r0 = warp_sum(r0); r1 = warp_sum(r1); r2 = warp_sum(r2);
  if (lane == 0) {
    rgb_out[0] = r0; rgb_out[1] = r1; rgb_out[2] = r2;
    *depth_out = wz / (acc + 1e-10f);
    *acc_out = acc;
  }
}

}  // namespace danerf

extern "C" const char* danerf_error_string(int code) {
  if (code == danerf::ERR_META) return "malformed packed-parameter layout record";
  if (code == danerf::ERR_SHAPE) return "a width this kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
