// Modulated deformable 3x3 convolution (DCNv2) forward, stride 1, for sm_90a.
//
//   y[b,p,:] = sum_k m_k(p) * bilinear0(x_b, p + (ky,kx) + clip(o_k(p), +-R)) . W_k  (+ bias)
//
// or, with the fused eval BN+ReLU epilogue (scale and shift given, bias
// ignored: the caller folds it into shift),
//
//   y[b,p,co] = max(acc[b,p,co] * scale[co] + shift[co], 0)
//
// Replaces the TPU kernel monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v3
// (body _fwd3_kernel, with its epilogue under TPU.DCN_FUSE_BN_RELU).  That
// kernel builds a (2R+1)^2 window of static shifts weighted by hat functions
// only because Mosaic cannot gather; the window sum is exactly bilinear
// sampling at the clamped point with zero padding.  Hopper can gather, so
// this kernel samples the 4 corners directly.
//
// Layouts (as the JAX package's public DCN op): x (B,H,W,C) NHWC in f32 or
// bf16 (the transfer dtype; math is f32 either way), offset (B,H,W,18)
// interleaved (dy_k, dx_k), mask (B,H,W,9) post-sigmoid, weight (9,C,Co) f32,
// bias (Co) f32 or null, scale and shift (Co) f32 or both null, out (B,H,W,Co)
// f32.  All contiguous.
//
// Design.  A block owns TP output pixels x TCO output channels and loops over
// the 9 taps and over C in chunks of TC.  Per tap it computes each pixel's 4
// corner addresses and (bilinear weight x mask) once; per chunk it gathers the
// corners' C runs (contiguous in NHWC, so a warp reads them coalesced) into a
// shared-memory im2col tile in f32, stages the matching W_k chunk, and
// accumulates the tile product in registers (4x4 outputs a thread).  The
// im2col tile never reaches device memory, as on the TPU it stays in VMEM, and
// the 9*C contraction happens here, in the kernel's own body.
//
// What bounds it.  The hot layer (8,96,320,64->64) is 2*8*96*320*576*64 =
// 18 GFLOP against 63 MB of f32 x (31 MB in bf16): ~290 FLOP/byte, so the
// layer is compute-bound; the epilogue reads two Co-vectors and saves the
// separate BN and ReLU passes over the output.  This first version does plain
// f32 FMAs from shared memory (no tensor cores), so it is bound by the FMA
// rate and shared-memory bandwidth, far below the card's bf16 tensor-core
// peak.  Moving the tile
// product onto wgmma with TMA-fed staging is the lever for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;        // output pixels per block
constexpr int TCO = 64;       // output channels per block
constexpr int TC = 32;        // input channels per chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const float* __restrict__ weight,
               const float* __restrict__ bias, const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ out,
               int B, int H, int W, int C, int Co, float R) {
  __shared__ int s_idx[TP][4];          // element offset of each corner's C run
  __shared__ float s_wt[TP][4];         // bilinear weight x mask, 0 outside the map
  __shared__ float s_col[TC][TP + 1];   // sampled im2col chunk (+1: no bank conflicts)
  __shared__ float s_w[TC][TCO];        // W_k chunk

  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * TP;
  const int co0 = blockIdx.y * TCO;
  const int tp = tid / 16;
  const int tco = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3 - 1;
    const int kx = k % 3 - 1;
    __syncthreads();  // the previous tap's corners are no longer read
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
        const int dx = corner & 1;
        const int yy = static_cast<int>(fy) + dy;
        const int xx = static_cast<int>(fx) + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          idx = ((b * H + yy) * W + xx) * C;
          wt = (dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) * mask[pix * 9 + k];
        }
      }
      s_idx[p][corner] = idx;
      s_wt[p][corner] = wt;
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += TC) {
      // gather: channel fastest across threads, so each corner's run is one
      // coalesced read; a corner outside the map has weight 0 and index 0
      for (int e = tid; e < TC * TP; e += THREADS) {
        const int c = e % TC;
        const int p = e / TC;
        float v = 0.f;
        if (c0 + c < C) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v += s_wt[p][j] * to_f32(x[s_idx[p][j] + c0 + c]);
        }
        s_col[c][p] = v;
      }
      for (int e = tid; e < TC * TCO; e += THREADS) {
        const int co = e % TCO;
        const int c = e / TCO;
        s_w[c][co] = (c0 + c < C && co0 + co < Co)
                         ? weight[(static_cast<long long>(k) * C + c0 + c) * Co + co0 + co]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < TC; ++c) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_col[c][tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = s_w[c][tco + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pix = p0 + tp + 16 * i;
    if (pix >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tco + 16 * j;
      if (co >= Co) continue;
      // the epilogue in the order of the TPU kernel: f32 accumulator, then
      // scale, shift and ReLU before the one write
      const float v = scale ? fmaxf(acc[i][j] * scale[co] + shift[co], 0.f)
                            : acc[i][j] + (bias ? bias[co] : 0.f);
      out[static_cast<long long>(pix) * Co + co] = v;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, dtypes, devices and contiguity, and that every index
// fits in 32 bits.  scale and shift are both given (the epilogue) or both null.
extern "C" int dcn_fwd(const void* x, int x_is_bf16, const void* offset, const void* mask,
                       const void* weight, const void* bias, const void* scale,
                       const void* shift, void* out, int B, int H, int W, int C, int Co,
                       float max_offset, void* stream) {
  const int npix = B * H * W;
  const dim3 grid((npix + TP - 1) / TP, (Co + TCO - 1) / TCO);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offset);
  const float* m = static_cast<const float*>(mask);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* y = static_cast<float*>(out);
  if (x_is_bf16) {
    dcn_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), off, m, w, b, sc, sh, y, B, H, W, C, Co, max_offset);
  } else {
    dcn_fwd_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), off, m, w, b, sc, sh, y, B, H, W, C, Co, max_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
