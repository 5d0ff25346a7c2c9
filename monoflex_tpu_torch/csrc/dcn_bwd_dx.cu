// Modulated deformable 3x3 convolution (DCNv2), input gradient dx, for sm_90a.
//
//   dx[b,q,c] = sum_k sum_p  corner_weight(p,k -> q) * m_k(p) * u_k(p)[c],
//   u_k(p)    = W_k g(p)      (W_k is (C, Co), g(p) the output gradient at p)
//
// Replaces the TPU kernel monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v5_bwd_dx
// (body _dx5_kernel; dx3 and dx4 compute the same function).  dx5 mirrors the
// forward's hat window onto g and contracts W_k after the window sum, because
// Mosaic cannot scatter.  Hopper can: this kernel is col2im.  Per block of TP
// pixels x TC input channels and per tap, it forms the u_k tile in registers
// from g and W_k staged in shared memory (the Co contraction is here, in the
// kernel's own body), then scatters each pixel's 4 bilinear corners, weighted
// by corner weight x mask, into dx with f32 atomicAdd.  The offsets are
// clamped to +-R as in the forward; g and dx are f32 (g is never rounded:
// dx5 always takes g in f32).
//
// Atomics make dx not bitwise reproducible: the order in which the up to
// 9 x (2R+2)^2 contributions to one dx element land varies from run to run.
// Each sum is f32 either way; tests compare with a tolerance that allows it.
//
// Layouts: offset (B,H,W,18) interleaved (dy_k, dx_k), mask (B,H,W,9),
// weight (9,C,Co), g (B,H,W,Co), dx (B,H,W,C), all f32 and contiguous; dx must
// be zeroed by the caller.
//
// What bounds it.  The u_k products are 2*9*C*Co FLOP per pixel, as in the
// forward (18 GFLOP at (8,96,320,64->64)), done as plain f32 FMAs from shared
// memory; the scatter is 36*C atomics per pixel (566 M at that shape), which
// land in L2 and contend little (neighbouring pixels hit different rows of dx
// except where their windows overlap).  Moving the u_k product onto wgmma and
// the scatter onto a deterministic mirrored gather are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;        // pixels per block
constexpr int TC = 64;        // input channels per block
constexpr int TK = 32;        // output channels per staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
dcn_bwd_dx_kernel(const float* __restrict__ offset, const float* __restrict__ mask,
                  const float* __restrict__ weight, const float* __restrict__ g,
                  float* __restrict__ dx, int B, int H, int W, int C, int Co, float R) {
  __shared__ int s_idx[TP][4];          // element offset of each corner's C run
  __shared__ float s_wt[TP][4];         // bilinear weight x mask, 0 outside the map
  __shared__ float s_g[TK][TP + 1];     // g chunk, [co][p]
  __shared__ float s_w[TK][TC + 1];     // W_k chunk, [co][c]
  __shared__ float s_u[TP][TC + 1];     // u_k tile, [p][c]

  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * TP;
  const int c0 = blockIdx.y * TC;
  const int tp = tid / 16;
  const int tc = tid % 16;

  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3 - 1;
    const int kx = k % 3 - 1;
    __syncthreads();  // the previous tap's scatter no longer reads s_idx/s_wt/s_u
    {
      // 256 threads = TP pixels x 4 corners
      const int p = tid / 4;
      const int corner = tid % 4;
      const int pix = p0 + p;
      int idx = 0;
      float wt = 0.f;
      if (pix < npix) {
        const int w = pix % W;
        const int h = (pix / W) % H;
        const int b = pix / (W * H);
        const float oy = fminf(fmaxf(offset[pix * 18 + 2 * k], -R), R);
        const float ox = fminf(fmaxf(offset[pix * 18 + 2 * k + 1], -R), R);
        const float py = h + ky + oy;
        const float px = w + kx + ox;
        const float fy = floorf(py);
        const float fx = floorf(px);
        const float ly = py - fy;
        const float lx = px - fx;
        const int dy = corner >> 1;
        const int dxc = corner & 1;
        const int yy = static_cast<int>(fy) + dy;
        const int xx = static_cast<int>(fx) + dxc;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          idx = ((b * H + yy) * W + xx) * C;
          wt = (dy ? ly : 1.f - ly) * (dxc ? lx : 1.f - lx) * mask[pix * 9 + k];
        }
      }
      s_idx[p][corner] = idx;
      s_wt[p][corner] = wt;
    }

    // u_k tile: acc[i][j] = u_k(p0 + tp + 16i)[c0 + tc + 16j]
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int co0 = 0; co0 < Co; co0 += TK) {
      for (int e = tid; e < TK * TP; e += THREADS) {
        const int co = e % TK;
        const int p = e / TK;
        s_g[co][p] = (p0 + p < npix && co0 + co < Co)
                         ? g[static_cast<long long>(p0 + p) * Co + co0 + co]
                         : 0.f;
      }
      for (int e = tid; e < TK * TC; e += THREADS) {
        const int co = e % TK;
        const int c = e / TK;
        s_w[co][c] = (c0 + c < C && co0 + co < Co)
                         ? weight[(static_cast<long long>(k) * C + c0 + c) * Co + co0 + co]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_g[kk][tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = s_w[kk][tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_u[tp + 16 * i][tc + 16 * j] = acc[i][j];
    __syncthreads();

    // col2im: channel fastest across threads, so a warp's atomics on one
    // corner hit one contiguous run of dx
    for (int e = tid; e < TP * TC; e += THREADS) {
      const int c = e % TC;
      const int p = e / TC;
      if (c0 + c >= C) continue;
      const float u = s_u[p][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wt = s_wt[p][j];
        if (wt != 0.f) atomicAdd(dx + s_idx[p][j] + c0 + c, wt * u);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, dtypes, devices and contiguity, that every index fits
// in 32 bits, and zeroes dx.
extern "C" int dcn_bwd_dx(const void* offset, const void* mask, const void* weight,
                          const void* g, void* dx, int B, int H, int W, int C, int Co,
                          float max_offset, void* stream) {
  const int npix = B * H * W;
  const dim3 grid((npix + TP - 1) / TP, (C + TC - 1) / TC);
  dcn_bwd_dx_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(offset), static_cast<const float*>(mask),
      static_cast<const float*>(weight), static_cast<const float*>(g), static_cast<float*>(dx),
      B, H, W, C, Co, max_offset);
  return static_cast<int>(cudaGetLastError());
}
