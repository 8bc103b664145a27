// The scratch size of K8 (mlp_bwd.cu), the one backward kernel whose
// library answers field_bwd.cuh's layout; K3, K4, K6 and K7 answer
// field_bwd_sm90.cuh's, K9 its own.

#pragma once

#include "field_bwd.cuh"

// Bytes of scratch a call on field_bwd.cuh's layout needs for R rays of s
// samples per tile row group, or R rows for s = ROW_TILES (K8's call);
// negative on a malformed layout.
extern "C" long long danerf_bwd_scratch_bytes(const long long* meta, long long n_meta,
                                              long long R, long long s, long long n_vecs) {
  using namespace danerf;
  if (n_meta < META_HEAD) return ERR_META;
  FieldArgs P;
  const int err = parse_meta(meta, n_meta, nullptr, nullptr, meta[8], &P);
  if (err) return err;
  if (s < 0 || s > TILE_M || R < 0) return ERR_SHAPE;
  const int rpc = units_per_tile(s);
  long long tiles = (R + rpc - 1) / rpc;
  if (tiles > MAX_TILES_PER_PASS) tiles = MAX_TILES_PER_PASS;
  Scratch sc;
  return carve(nullptr, P, tiles, (int)n_vecs, &sc);
}
