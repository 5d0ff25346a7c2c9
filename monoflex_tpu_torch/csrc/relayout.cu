// The padded NHWC -> (C, W) relayout that feeds the TPU's v1.5/v3 DCN
// layouts, for sm_90a:
//
//   out[b, h, c, P + w] = x[b, h, w, c]   (c < C, w < W), 0 elsewhere
//
// with x (B,H,W,C) f32 and out (B,H,Cs,wp2f) f32, Cs = C rounded up to 8,
// wp2f = roundup(roundup(W, 128) + 2P, 128) and P = R + 1.
//
// Replaces the TPU kernels tools/transpose_ablate.py::pallasT_variant (body
// _trT_kernel, a Mosaic 3-D transpose) and ::pallas_variant (body
// _tr_kernel, the transpose as an MXU identity contraction per row); both
// compute this one function.  The JAX grid covers H // 8 * 8 rows and leaves
// the rest undefined; this kernel writes every row.
//
// Design: the classic shared-memory tiled transpose.  A block owns one (b, h)
// row and a 32 x 32 tile of (c, output column): it reads the tile's 32
// columns x 32 channels of x with channel fastest (coalesced), and writes
// the 32 channels x 32 columns of out with column fastest (coalesced), the
// tile padded by one column against bank conflicts.  Padding columns and
// channels are written as zeros in the same pass.
//
// What bounds it: bytes.  x is read once and out (with its zero padding)
// written once; no arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // 32 x 8 threads, 4 elements each

__global__ void __launch_bounds__(TILE * ROWS)
relayout_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int C,
                int Cs, int wp2f, int P) {
  __shared__ float tile[TILE][TILE + 1];  // [output column][channel]
  const int j0 = blockIdx.x * TILE;       // output column
  const int c0 = blockIdx.y * TILE;       // channel
  const long long bh = blockIdx.z;        // b * H + h
  const float* xr = x + bh * W * C;
  float* outr = out + bh * Cs * wp2f;
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const int w = j0 + i - P;
    const int c = c0 + threadIdx.x;
    tile[i][threadIdx.x] = (w >= 0 && w < W && c < C) ? xr[static_cast<long long>(w) * C + c]
                                                      : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const int c = c0 + i;
    const int j = j0 + threadIdx.x;
    if (c < Cs && j < wp2f) outr[static_cast<long long>(c) * wp2f + j] = tile[threadIdx.x][i];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, dtypes, devices and contiguity, that B * H fits the
// grid's z dimension (65535) and that every index fits in 32 bits.
extern "C" int relayout(const void* x, void* out, int B, int H, int W, int C, int Cs, int wp2f,
                        int P, void* stream) {
  const dim3 grid((wp2f + TILE - 1) / TILE, (Cs + TILE - 1) / TILE, B * H);
  relayout_kernel<<<grid, dim3(TILE, ROWS), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), H, W, C, Cs, wp2f, P);
  return static_cast<int>(cudaGetLastError());
}
