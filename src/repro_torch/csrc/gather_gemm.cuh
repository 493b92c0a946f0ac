// Shared device body of the sparse-conv kernels: one gathered GEMM step.
//
// A block owns TILE_M gathered input rows (their indices already staged in
// shared memory, -1 = no neighbour) and BN = 64 output columns.  One call
// adds  rows(TILE_M x Cin) @ w_delta(Cin x BN)  into the per-thread fp32
// accumulator.  Input channels are staged through shared memory KC at a
// time; every product is an explicit fmaf in ascending channel order, so an
// output element sees the same sequence of fp32 operations whichever kernel
// (dense grid, worklist, fetch-on-demand) calls this body.  fp32 operands
// are multiplied in real fp32 (FFMA, never TF32); bf16 operands are widened
// exactly to fp32 first (a bf16 x bf16 product is exact in fp32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int BN = 64;   // output columns per block
constexpr int TN = 4;    // output columns per thread
constexpr int KC = 32;   // input channels staged per shared-memory step

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int TILE_M>
struct TileCfg {
  // rows per thread; 16 row-threads x 16 column-threads (fewer row-threads
  // for TILE_M = 8)
  static constexpr int RM = TILE_M >= 16 ? TILE_M / 16 : 1;
  static constexpr int ROW_THREADS = TILE_M / RM;
  static constexpr int COL_THREADS = BN / TN;
  static constexpr int THREADS = ROW_THREADS * COL_THREADS;
  static constexpr int ASTRIDE = TILE_M + 1;  // padded: conflict-free staging
};

template <int TILE_M>
struct SharedTiles {
  int idx[TILE_M];                         // gathered row indices (-1 = none)
  float a[KC * TileCfg<TILE_M>::ASTRIDE];  // staged rows, channel-major
  float b[KC * BN];                        // staged weight slice
};

// acc[i][j] += sum_k x[idx[r_i], k] * w_delta[k, n0 + c_j]   (fp32, k ascending)
// Caller has filled sm.idx and synchronised.  Block-uniform control flow.
template <int TILE_M, typename T>
__device__ __forceinline__ void gather_gemm_step(
    SharedTiles<TILE_M>& sm, const T* __restrict__ x, int cin,
    const T* __restrict__ w_delta, int cout, int n0,
    float (&acc)[TileCfg<TILE_M>::RM][TN]) {
  using C = TileCfg<TILE_M>;
  const int tid = threadIdx.x;
  const int tc = tid % C::COL_THREADS;
  const int tr = tid / C::COL_THREADS;
  for (int k0 = 0; k0 < cin; k0 += KC) {
    const int kmax = min(KC, cin - k0);
    for (int e = tid; e < KC * TILE_M; e += C::THREADS) {
      const int r = e / KC, k = e % KC;  // neighbouring threads: one row, adjacent channels
      const int idx = sm.idx[r];
      float v = 0.f;
      if (idx >= 0 && k < kmax) v = to_f32<T>(x[(size_t)idx * cin + k0 + k]);
      sm.a[k * C::ASTRIDE + r] = v;
    }
    for (int e = tid; e < KC * BN; e += C::THREADS) {
      const int k = e / BN, c = e % BN;
      float v = 0.f;
      if (k < kmax && n0 + c < cout) v = to_f32<T>(w_delta[(size_t)(k0 + k) * cout + n0 + c]);
      sm.b[k * BN + c] = v;
    }
    __syncthreads();
    for (int k = 0; k < kmax; ++k) {
      float a[C::RM], b[TN];
#pragma unroll
      for (int i = 0; i < C::RM; ++i) a[i] = sm.a[k * C::ASTRIDE + tr * C::RM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.b[k * BN + tc * TN + j];
#pragma unroll
      for (int i = 0; i < C::RM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace repro_torch
