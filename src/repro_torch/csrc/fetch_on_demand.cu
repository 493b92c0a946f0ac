// Fused weight-stationary gather -> GEMM -> scatter-add (fetch-on-demand).
//
// Replaces the Pallas TPU kernel fetch_on_demand_pallas
// (src/repro/kernels/fetch_on_demand/fetch_on_demand.py:94):
//
//   for delta in 0..KD-1:  out[ws_out[delta, i]] += x[ws_in[delta, i]] @ w[delta]
//
// The TPU kernel is race-free only because its grid runs sequentially on
// one core.  H100 blocks run concurrently, but within one delta every
// output row appears at most once in ws_out (each fine/coarse pair is
// unique per offset), so this kernel runs the deltas one after another —
// one stream-ordered grid per delta, enqueued by the C entry point — and
// the pair tiles of one delta in parallel.  No atomics: the read-modify-
// write of an output row is owned by one thread, and each delta rounds the
// running row to out's dtype exactly as the TPU kernel does
// (fetch_on_demand.py:76), so results are deterministic and a batched
// forward equals the per-scene one bit for bit.
//
// What bounds it on the H100: every (pair, delta) reads and writes a whole
// output row (the dataflow's write amplification, sum_delta |M_delta| row
// writes) plus one gathered input row; at MinkUNet widths that traffic, not
// arithmetic, is the limit.  Blocks whose pair tile lies past the
// compacted end of a delta's list exit at once.
#include "gather_gemm.cuh"

namespace repro_torch {
namespace {

template <int TILE_R, typename T>
__global__ void __launch_bounds__(TileCfg<TILE_R>::THREADS)
fod_delta_kernel(const int* __restrict__ ws_in, const int* __restrict__ ws_out, int cap_pad,
                 int delta, const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int cin, int cout) {
  using C = TileCfg<TILE_R>;
  __shared__ SharedTiles<TILE_R> sm;
  __shared__ int s_out[TILE_R];
  const int r0 = blockIdx.x * TILE_R;
  const int* in_row = ws_in + (size_t)delta * cap_pad + r0;
  const int* out_row = ws_out + (size_t)delta * cap_pad + r0;
  // pair lists are compacted to the front (-1 after): an empty head means
  // the whole tile is padding
  if (out_row[0] < 0) return;
  for (int r = threadIdx.x; r < TILE_R; r += C::THREADS) {
    sm.idx[r] = in_row[r];
    s_out[r] = out_row[r];
  }
  __syncthreads();
  const int n0 = blockIdx.y * BN;
  float acc[C::RM][TN] = {};
  gather_gemm_step<TILE_R, T>(sm, x, cin, w + (size_t)delta * cin * cout, cout, n0, acc);
  const int tc = threadIdx.x % C::COL_THREADS;
  const int tr = threadIdx.x / C::COL_THREADS;
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const int o = s_out[tr * C::RM + i];
    if (o < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tc * TN + j;
      if (c < cout) {
        T* p = out + (size_t)o * cout + c;
        *p = from_f32<T>(to_f32<T>(*p) + acc[i][j]);
      }
    }
  }
}

template <int TILE_R, typename T>
cudaError_t launch_all(const int* ws_in, const int* ws_out, const void* x, const void* w,
                       void* out, int kd, int cap_pad, int cin, int cout, cudaStream_t stream) {
  dim3 grid(cap_pad / TILE_R, (cout + BN - 1) / BN);
  for (int delta = 0; delta < kd; ++delta) {
    fod_delta_kernel<TILE_R, T><<<grid, TileCfg<TILE_R>::THREADS, 0, stream>>>(
        ws_in, ws_out, cap_pad, delta, (const T*)x, (const T*)w, (T*)out, cin, cout);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

#define REPRO_TILE_DISPATCH(FN, T, ...)                  \
  switch (tile_r) {                                      \
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
// ws_in/ws_out: (kd, cap_pad) int32, cap_pad a multiple of tile_r, -1
// padded and compacted to the front; x: (n_in, cin); w: (kd, cin, cout);
// out: (n_out, cout), accumulated in place (pass zeros).  Enqueues kd
// stream-ordered grids; returns the first launch error (0 = success).
extern "C" int fod_forward(const void* ws_in, const void* ws_out, const void* x, const void* w,
                           void* out, int kd, int cap_pad, int cin, int cout, int tile_r,
                           int dtype, void* stream) {
  if (kd <= 0 || cap_pad <= 0 || cap_pad % tile_r || cin <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* wi = (const int*)ws_in;
  const int* wo = (const int*)ws_out;
  if (dtype == 0) {
    REPRO_TILE_DISPATCH(launch_all, float, wi, wo, x, w, out, kd, cap_pad, cin, cout, s)
  }
  REPRO_TILE_DISPATCH(launch_all, __nv_bfloat16, wi, wo, x, w, out, kd, cap_pad, cin, cout, s)
}

extern "C" const char* fod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
