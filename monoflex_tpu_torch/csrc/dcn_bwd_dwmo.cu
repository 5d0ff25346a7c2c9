// Modulated deformable 3x3 convolution (DCNv2), the mask, weight and offset
// gradients, for sm_90a.  With S_k(p) the bilinear sample of x at tap k (the
// forward's im2col column before the mask), SY_k and SX_k its derivatives
// with respect to the tap's y and x offset, and u_k(p) = W_k g(p):
//
//   dmask[p,k]      = <S_k(p), u_k(p)>
//   doffset[p,2k]   = m_k(p) <SY_k(p), u_k(p)> * 1{|oy_k(p)| <= R}   (and SX for 2k+1)
//   dW_k            = sum_p m_k(p) S_k(p) g(p)^T                   (over all B*H*W pixels)
//
// Replaces the TPU kernel monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v3_bwd_dwmo
// (body _dwmo3_kernel).  That kernel sweeps a (2R+1)^2 window of static shifts
// with hat weights and their derivatives, because Mosaic cannot gather; here
// the 4 corners are gathered directly.  The offset derivative is the
// floor-based, one-sided derivative of bilinear sampling (the reference CUDA
// op's): at an integer offset it is the difference towards the next row or
// column, where the TPU kernel's hat derivative gives 0 (ROADMAP C1).
//
// Three __global__ kernels, all deterministic:
//  - dcn_bwd_mo_kernel: per block of TP pixels and per tap, the u_k tile is
//    formed in registers from g and W_k staged in shared memory (the Co
//    contraction is in this body); each thread gathers the corners for its
//    pixels and channels and accumulates the three channel dot products,
//    which a warp shuffle finishes.
//  - dcn_bwd_dw_kernel: a GEMM over pixels, A = m_k S_k gathered into shared
//    memory, B = g; each block sums its own slice of the pixels into a
//    partial dW tile (split-K over B*H*W, since one tap's reduction runs over
//    245,760 pixels at 384x1280, batch 8).
//  - dcn_bwd_dw_reduce_kernel: sums the partials in a fixed order.
//
// bf16 window math (kBf16Math, the compute_dtype=bfloat16 mode of
// monoflex_tpu/ops/dcn_pallas_bwd.py::dcn_pallas_bwd_dwm/_doff and the v2
// dwm/doff/dwmo kernels): x comes in bf16; W and g are rounded to bf16, and
// so, for dW, are each corner weight times the mask and each sampled value;
// every sum is f32.  dmask and doffset take the f32 samples S, SY, SX of
// the bf16 x (the gradients of the bf16-math forward, each rounding taken
// straight through).
//
// Layouts: x (B,H,W,C) in f32 or bf16 (the forward's transfer dtype: dW,
// dmask and doffset are evaluated at the rounded x, math in f32), offset
// (B,H,W,18) interleaved (dy_k, dx_k), mask (B,H,W,9), weight (9,C,Co),
// g (B,H,W,Co), dmask (B,H,W,9), doffset (B,H,W,18), dw (9,C,Co), dw_partial
// (nsplit,9,C,Co) scratch, all f32 but x, all contiguous.
//
// What bounds it.  Both u_k and dW are 2*9*C*Co FLOP per pixel (18 GFLOP each
// at (8,96,320,64->64)), plain f32 FMAs from shared memory; the gathers read
// x's 4 corners per tap twice (once per kernel), from L2 mostly, since
// neighbouring pixels share corners.  wgmma for both products is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;        // dmask/doffset: pixels per block
constexpr int TC = 64;        // input channels per tile
constexpr int TK = 32;        // output channels per staged chunk of u_k
constexpr int TPW = 32;       // dW: pixels per staged tile
constexpr int TCO = 64;       // dW: output channels per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to bf16 and back under bf16 window math; v itself otherwise
template <bool kRound>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kRound) return __bfloat162float(__float2bfloat16(v));
  return v;
}

// The 4 bilinear corners of pixel `pix` at tap k: element offset of the
// corner's C run, its weight (no mask) and the weight's derivative with
// respect to the clamped y and x offsets; all 0 for a corner off the map.
struct Corner {
  int idx;
  float ws, wy, wx;
};

__device__ __forceinline__ Corner corner_of(const float* __restrict__ offset, int pix, int k,
                                            int corner, int H, int W, int C, float R) {
  Corner out{0, 0.f, 0.f, 0.f};
  const int w = pix % W;
  const int h = (pix / W) % H;
  const int b = pix / (W * H);
  const float oy = fminf(fmaxf(offset[pix * 18 + 2 * k], -R), R);
  const float ox = fminf(fmaxf(offset[pix * 18 + 2 * k + 1], -R), R);
  const float py = h + (k / 3 - 1) + oy;
  const float px = w + (k % 3 - 1) + ox;
  const float fy = floorf(py);
  const float fx = floorf(px);
  const float ly = py - fy;
  const float lx = px - fx;
  const int dy = corner >> 1;
  const int dx = corner & 1;
  const int yy = static_cast<int>(fy) + dy;
  const int xx = static_cast<int>(fx) + dx;
  if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
    const float fyw = dy ? ly : 1.f - ly;
    const float fxw = dx ? lx : 1.f - lx;
    out.idx = ((b * H + yy) * W + xx) * C;
    out.ws = fyw * fxw;
    out.wy = (dy ? 1.f : -1.f) * fxw;
    out.wx = fyw * (dx ? 1.f : -1.f);
  }
  return out;
}

template <typename T, bool kBf16Math>
__global__ void __launch_bounds__(THREADS)
dcn_bwd_mo_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const float* __restrict__ weight,
                  const float* __restrict__ g, float* __restrict__ dmask,
                  float* __restrict__ doffset, int B, int H, int W, int C, int Co, float R) {
  __shared__ int s_idx[TP][4];
  __shared__ float s_ws[TP][4];
  __shared__ float s_wy[TP][4];
  __shared__ float s_wx[TP][4];
  __shared__ float s_g[TK][TP + 1];     // g chunk, [co][p]
  __shared__ float s_w[TK][TC + 1];     // W_k chunk, [co][c]

  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * TP;
  const int tp = tid / 16;  // pixels tp + 16i
  const int tc = tid % 16;  // channels tc + 16j of each tile; the 16 lanes of
                            // one pixel row are one half-warp

  for (int k = 0; k < 9; ++k) {
    __syncthreads();  // the previous tap no longer reads the corners
    {
      const int p = tid / 4;
      const int corner = tid % 4;
      Corner cn{0, 0.f, 0.f, 0.f};
      if (p0 + p < npix) cn = corner_of(offset, p0 + p, k, corner, H, W, C, R);
      s_idx[p][corner] = cn.idx;
      s_ws[p][corner] = cn.ws;
      s_wy[p][corner] = cn.wy;
      s_wx[p][corner] = cn.wx;
    }

    float dm[4] = {0.f, 0.f, 0.f, 0.f};
    float doy[4] = {0.f, 0.f, 0.f, 0.f};
    float dox[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < C; c0 += TC) {
      // u_k tile: acc[i][j] = u_k(p0 + tp + 16i)[c0 + tc + 16j]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int co0 = 0; co0 < Co; co0 += TK) {
        __syncthreads();  // s_g/s_w of the previous chunk are consumed
        for (int e = tid; e < TK * TP; e += THREADS) {
          const int co = e % TK;
          const int p = e / TK;
          s_g[co][p] = (p0 + p < npix && co0 + co < Co)
                           ? rnd<kBf16Math>(g[static_cast<long long>(p0 + p) * Co + co0 + co])
                           : 0.f;
        }
        for (int e = tid; e < TK * TC; e += THREADS) {
          const int co = e % TK;
          const int c = e / TK;
          s_w[co][c] = (c0 + c < C && co0 + co < Co)
                           ? rnd<kBf16Math>(
                                 weight[(static_cast<long long>(k) * C + c0 + c) * Co + co0 + co])
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
      }
      // the three samples at this thread's (pixel, channel) pairs, dotted with u
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tp + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tc + 16 * j;
          if (c >= C) continue;
          float s = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v = to_f32(x[s_idx[p][q] + c]);
            s = fmaf(s_ws[p][q], v, s);
            sy = fmaf(s_wy[p][q], v, sy);
            sx = fmaf(s_wx[p][q], v, sx);
          }
          dm[i] = fmaf(s, acc[i][j], dm[i]);
          doy[i] = fmaf(sy, acc[i][j], doy[i]);
          dox[i] = fmaf(sx, acc[i][j], dox[i]);
        }
      }
    }
    // finish the channel sums across the 16 lanes that share each pixel
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int s = 8; s > 0; s >>= 1) {
        dm[i] += __shfl_xor_sync(0xffffffffu, dm[i], s);
        doy[i] += __shfl_xor_sync(0xffffffffu, doy[i], s);
        dox[i] += __shfl_xor_sync(0xffffffffu, dox[i], s);
      }
    }
    if (tc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pix = p0 + tp + 16 * i;
        if (pix >= npix) continue;
        const float m = mask[pix * 9 + k];
        const float oy = offset[pix * 18 + 2 * k];
        const float ox = offset[pix * 18 + 2 * k + 1];
        dmask[pix * 9 + k] = dm[i];
        doffset[pix * 18 + 2 * k] = fabsf(oy) <= R ? m * doy[i] : 0.f;
        doffset[pix * 18 + 2 * k + 1] = fabsf(ox) <= R ? m * dox[i] : 0.f;
      }
    }
  }
}

// grid (nsplit, 9, c tiles x co tiles); block (s, k, tile) sums pixels
// [s*chunk, (s+1)*chunk) into dw_partial[s, k, c tile, co tile]
template <typename T, bool kBf16Math>
__global__ void __launch_bounds__(THREADS)
dcn_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const float* __restrict__ g,
                  float* __restrict__ dw_partial, int chunk, int B, int H, int W, int C,
                  int Co, float R) {
  __shared__ int s_idx[TPW][4];
  __shared__ float s_wt[TPW][4];        // bilinear weight x mask
  __shared__ float s_a[TPW][TC + 1];    // m_k S_k, [p][c]
  __shared__ float s_b[TPW][TCO];       // g, [p][co]

  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int k = blockIdx.y;
  const int n_co_tiles = (Co + TCO - 1) / TCO;
  const int c0 = (blockIdx.z / n_co_tiles) * TC;
  const int co0 = (blockIdx.z % n_co_tiles) * TCO;
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, npix);
  const int tcc = tid / 16;  // channels c0 + tcc + 16i
  const int tco = tid % 16;  // output channels co0 + tco + 16j

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = begin; q0 < end; q0 += TPW) {
    __syncthreads();  // the previous tile is consumed
    if (tid < TPW * 4) {
      const int p = tid / 4;
      const int corner = tid % 4;
      Corner cn{0, 0.f, 0.f, 0.f};
      float m = 0.f;
      if (q0 + p < end) {
        cn = corner_of(offset, q0 + p, k, corner, H, W, C, R);
        m = mask[(q0 + p) * 9 + k];
      }
      s_idx[p][corner] = cn.idx;
      s_wt[p][corner] = rnd<kBf16Math>(cn.ws * m);
    }
    __syncthreads();
    // gather with channel fastest: each corner's run is one coalesced read
    for (int e = tid; e < TPW * TC; e += THREADS) {
      const int c = e % TC;
      const int p = e / TC;
      float v = 0.f;
      if (c0 + c < C) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v += s_wt[p][q] * to_f32(x[s_idx[p][q] + c0 + c]);
      }
      s_a[p][c] = rnd<kBf16Math>(v);
    }
    for (int e = tid; e < TPW * TCO; e += THREADS) {
      const int co = e % TCO;
      const int p = e / TCO;
      s_b[p][co] = (q0 + p < end && co0 + co < Co)
                       ? rnd<kBf16Math>(g[static_cast<long long>(q0 + p) * Co + co0 + co])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < TPW; ++p) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_a[p][tcc + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_b[p][tco + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* out = dw_partial + (static_cast<long long>(blockIdx.x) * 9 + k) * C * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tcc + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tco + 16 * j;
      if (co < Co) out[static_cast<long long>(c) * Co + co] = acc[i][j];
    }
  }
}

__global__ void dcn_bwd_dw_reduce_kernel(const float* __restrict__ dw_partial,
                                         float* __restrict__ dw, int nsplit, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int t = 0; t < nsplit; ++t) s += dw_partial[static_cast<long long>(t) * n + i];
  dw[i] = s;
}

template <typename T, bool kBf16Math>
int launch(const void* x, const float* offset, const float* mask, const float* weight,
           const float* g, float* dmask, float* doffset, float* dw_partial, float* dw,
           int nsplit, int B, int H, int W, int C, int Co, float R, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int npix = B * H * W;
  dcn_bwd_mo_kernel<T, kBf16Math><<<(npix + TP - 1) / TP, THREADS, 0, s>>>(
      xt, offset, mask, weight, g, dmask, doffset, B, H, W, C, Co, R);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // a whole number of staged tiles per split
  const int chunk = ((npix + nsplit - 1) / nsplit + TPW - 1) / TPW * TPW;
  const dim3 grid(nsplit, 9, ((C + TC - 1) / TC) * ((Co + TCO - 1) / TCO));
  dcn_bwd_dw_kernel<T, kBf16Math><<<grid, THREADS, 0, s>>>(xt, offset, mask, g, dw_partial,
                                                            chunk, B, H, W, C, Co, R);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = 9 * C * Co;
  dcn_bwd_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(dw_partial, dw, nsplit, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success).  The caller checks shapes, dtypes,
// devices and contiguity, that every index fits in 32 bits, and allocates
// dw_partial as (nsplit, 9, C, Co); a split left with no pixels writes zeros.
// bf16_math needs x in bf16.
extern "C" int dcn_bwd_dwmo(const void* x, int x_is_bf16, int bf16_math, const void* offset,
                            const void* mask, const void* weight, const void* g, void* dmask,
                            void* doffset, void* dw_partial, void* dw, int nsplit, int B, int H,
                            int W, int C, int Co, float max_offset, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_math) {
    if (!x_is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch<__nv_bfloat16, true>(x, f(offset), f(mask), f(weight), f(g), m(dmask),
                                       m(doffset), m(dw_partial), m(dw), nsplit, B, H, W, C, Co,
                                       max_offset, s);
  }
  if (x_is_bf16)
    return launch<__nv_bfloat16, false>(x, f(offset), f(mask), f(weight), f(g), m(dmask),
                                        m(doffset), m(dw_partial), m(dw), nsplit, B, H, W, C,
                                        Co, max_offset, s);
  return launch<float, false>(x, f(offset), f(mask), f(weight), f(g), m(dmask), m(doffset),
                              m(dw_partial), m(dw), nsplit, B, H, W, C, Co, max_offset, s);
}
