// Output-stationary masked implicit GEMM for one split of a sparse conv.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * implicit_gemm_pallas           (src/repro/kernels/implicit_gemm/implicit_gemm.py:84)
//   * implicit_gemm_worklist_pallas  (same file, :175)
//
//   out[n] = sum_{delta in split} x[midx[n, delta]] @ w[delta]   (-1 adds nothing)
//
// On the TPU the delta axis is the innermost, sequential grid axis and an
// fp32 VMEM accumulator carries across it.  On the H100 blocks run in
// parallel and in no order, so one block owns an output tile (TILE_M rows x
// 64 columns) and walks the split's delta range in a loop, keeping the fp32
// accumulator in registers and writing the tile once in x's dtype.
//
// What bounds it on the H100: gathered rows are re-read once per occupied
// (tile, delta) pair, so at MinkUNet's channel widths (32..384) the kernel is
// bound by L2/HBM gather traffic and by FFMA issue (it runs on the fp32
// cores, 67 TFLOP/s, not the tensor cores).  This first version keeps the
// design simple: the per-(tile, delta) occupancy skips empty steps (the
// TPU's @pl.when gate), gathers are coalesced along channels, and nothing
// is pipelined; wgmma/TMA come in a later change.
//
// The dense kernel visits every delta and skips unoccupied ones; the
// worklist kernel visits only the occupied (tile, delta) pairs listed in a
// CSR worklist (tile-skipping).  Both call the same device body
// (gather_gemm_step) in the same delta order, so they are bit-identical.
// Tiles with no worklist entry are not launched; the wrapper zeroes them.
#include "gather_gemm.cuh"

namespace repro_torch {
namespace {

template <int TILE_M>
__device__ __forceinline__ void load_tile_indices(SharedTiles<TILE_M>& sm, const int* __restrict__ midx,
                                                  int kd, int tile, int delta) {
  for (int r = threadIdx.x; r < TILE_M; r += TileCfg<TILE_M>::THREADS)
    sm.idx[r] = midx[(size_t)(tile * TILE_M + r) * kd + delta];
  __syncthreads();
}

template <int TILE_M, typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out, int tile, int n0, int cout,
                                           const float (&acc)[TileCfg<TILE_M>::RM][TN]) {
  using C = TileCfg<TILE_M>;
  const int tc = threadIdx.x % C::COL_THREADS;
  const int tr = threadIdx.x / C::COL_THREADS;
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const size_t row = (size_t)tile * TILE_M + tr * C::RM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tc * TN + j;
      if (c < cout) out[row * cout + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <int TILE_M, typename T>
__global__ void __launch_bounds__(TileCfg<TILE_M>::THREADS)
igemm_dense_kernel(const int* __restrict__ midx, const int* __restrict__ occ,
                   const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   int kd, int cin, int cout) {
  __shared__ SharedTiles<TILE_M> sm;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  float acc[TileCfg<TILE_M>::RM][TN] = {};
  for (int delta = 0; delta < kd; ++delta) {
    if (occ[(size_t)tile * kd + delta] == 0) continue;  // block-uniform skip
    load_tile_indices<TILE_M>(sm, midx, kd, tile, delta);
    gather_gemm_step<TILE_M, T>(sm, x, cin, w + (size_t)delta * cin * cout, cout, n0, acc);
  }
  store_tile<TILE_M, T>(out, tile, n0, cout, acc);
}

template <int TILE_M, typename T>
__global__ void __launch_bounds__(TileCfg<TILE_M>::THREADS)
igemm_worklist_kernel(const int* __restrict__ wl_ptr, const int* __restrict__ wl_tile,
                      const int* __restrict__ wl_delta, const int* __restrict__ midx,
                      const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                      int kd, int cin, int cout) {
  __shared__ SharedTiles<TILE_M> sm;
  const int v = blockIdx.x;  // visited tile number
  const int tile = wl_tile[v];
  const int n0 = blockIdx.y * BN;
  float acc[TileCfg<TILE_M>::RM][TN] = {};
  const int end = wl_ptr[v + 1];
  for (int e = wl_ptr[v]; e < end; ++e) {
    const int delta = wl_delta[e];
    load_tile_indices<TILE_M>(sm, midx, kd, tile, delta);
    gather_gemm_step<TILE_M, T>(sm, x, cin, w + (size_t)delta * cin * cout, cout, n0, acc);
  }
  store_tile<TILE_M, T>(out, tile, n0, cout, acc);
}

template <int TILE_M, typename T>
cudaError_t launch_dense(const int* midx, const int* occ, const void* x, const void* w, void* out,
                         int n_rows, int kd, int cin, int cout, cudaStream_t stream) {
  dim3 grid(n_rows / TILE_M, (cout + BN - 1) / BN);
  igemm_dense_kernel<TILE_M, T><<<grid, TileCfg<TILE_M>::THREADS, 0, stream>>>(
      midx, occ, (const T*)x, (const T*)w, (T*)out, kd, cin, cout);
  return cudaGetLastError();
}

template <int TILE_M, typename T>
cudaError_t launch_worklist(const int* wl_ptr, const int* wl_tile, const int* wl_delta,
                            const int* midx, const void* x, const void* w, void* out,
                            int n_visited, int kd, int cin, int cout, cudaStream_t stream) {
  dim3 grid(n_visited, (cout + BN - 1) / BN);
  igemm_worklist_kernel<TILE_M, T><<<grid, TileCfg<TILE_M>::THREADS, 0, stream>>>(
      wl_ptr, wl_tile, wl_delta, midx, (const T*)x, (const T*)w, (T*)out, kd, cin, cout);
  return cudaGetLastError();
}

#define REPRO_TILE_DISPATCH(FN, T, ...)                  \
  switch (tile_m) {                                      \
    case 8: return (int)FN<8, T>(__VA_ARGS__);           \
    case 16: return (int)FN<16, T>(__VA_ARGS__);         \
    case 32: return (int)FN<32, T>(__VA_ARGS__);         \
    case 64: return (int)FN<64, T>(__VA_ARGS__);         \
    case 128: return (int)FN<128, T>(__VA_ARGS__);       \
    default: return (int)cudaErrorInvalidValue;          \
  }

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// Plain C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// midx: (n_rows, kd) int32 row-major; occ: (n_rows / tile_m, kd) int32;
// x: (n_in, cin); w: (kd, cin, cout); out: (n_rows, cout).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int igemm_dense(const void* midx, const void* occ, const void* x, const void* w,
                           void* out, int n_rows, int kd, int cin, int cout, int tile_m,
                           int dtype, void* stream) {
  if (n_rows <= 0 || n_rows % tile_m || kd <= 0 || cin <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* m = (const int*)midx;
  const int* o = (const int*)occ;
  if (dtype == 0) {
    REPRO_TILE_DISPATCH(launch_dense, float, m, o, x, w, out, n_rows, kd, cin, cout, s)
  }
  REPRO_TILE_DISPATCH(launch_dense, __nv_bfloat16, m, o, x, w, out, n_rows, kd, cin, cout, s)
}

// wl_ptr: (n_visited + 1,) CSR offsets into wl_delta; wl_tile: (n_visited,)
// tile of each visited tile; wl_delta: occupied deltas, ascending per tile.
extern "C" int igemm_worklist(const void* wl_ptr, const void* wl_tile, const void* wl_delta,
                              const void* midx, const void* x, const void* w, void* out,
                              int n_visited, int kd, int cin, int cout, int tile_m, int dtype,
                              void* stream) {
  if (n_visited <= 0 || kd <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)wl_ptr;
  const int* t = (const int*)wl_tile;
  const int* d = (const int*)wl_delta;
  const int* m = (const int*)midx;
  if (dtype == 0) {
    REPRO_TILE_DISPATCH(launch_worklist, float, p, t, d, m, x, w, out, n_visited, kd, cin, cout, s)
  }
  REPRO_TILE_DISPATCH(launch_worklist, __nv_bfloat16, p, t, d, m, x, w, out, n_visited, kd, cin,
                      cout, s)
}

extern "C" const char* igemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
