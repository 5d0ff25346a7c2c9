// Ablations of the DCNv2 forward, for sm_90a: dcn_fwd stripped to one part,
// so that the card shows where dcn_fwd's time goes.
//
// Replaces the TPU kernels of the JAX package's diagnostics tools:
//   tools/kernel_diag.py::run_variant (body _kernel): dma, window, aligned,
//     matmul;
//   tools/fwd_ablate.py::build_variant (body _kernel): nomap, nobcast.
// With x (B,H,W,C) NHWC f32 and zero padding outside the map, R the offset
// clamp, o_k and m_k the tap's offset and mask, bil(x, q) bilinear sampling
// at q and hat(t) = max(0, 1 - |t|):
//
//   dma      out = x, copied through a staged halo tile of shared memory
//            (DTH rows + 2*GUARD guard rows, DTW columns + 2P, P = R + 1),
//            as the TPU kernel DMAs a (tile_h + 16)-row halo: it measures the
//            staging alone.  C out channels.
//   window   out = sum_k bil(x, p + (ky,kx) + clip(o_k, +-R)): the 4-corner
//            gather of dcn_fwd with no mask and no W.  C out channels.
//   aligned  out = sum_k sum_dy hat(oy_k + ky - dy) x[h + dy, w]: the window
//            with its column shifts dropped (the TPU kernel reads every dx
//            term at dx = 0, and the hats over dx sum to 1).  C out channels.
//   matmul   out = sum_k m_k x[p + (ky,kx)] W_k: dcn_fwd's im2col tile and
//            product with one aligned term per tap.  Co out channels.
//   nomap    out = sum_k 0.25 (sum_{e,f in [-R,R]} x[h+ky+e, w+kx+f]) W_k: the
//            (2R+1)^2 window of the TPU kernel with constant weights, no
//            mask, no offsets.  Co out channels.
//   nobcast  as the DCN's (2R+1)^2 hat window, but each hat map is replaced by
//            its maximum over the TPU kernel's row tile (tile_h rows x W, the
//            padded rows with offset 0 and mask 0): wx(k,f) = max hat(ox_k - f),
//            wy(k,e) = max hat(oy_k - e) m_k, out = sum_k sum_e wy(k,e)
//            sum_f wx(k,f) x[h+ky+e, w+kx+f] W_k.  Co out channels.
//
// One kernel, dcn_ablate_kernel<V>, templated on the variant, with three
// bodies: dma_body (staging), sum_body (window, aligned: dcn_fwd's corner
// tables and gather, summed over taps in registers) and gemm_body (matmul,
// nomap, nobcast: dcn_fwd's tile of TP pixels x TCO output channels, a
// shared-memory im2col chunk of TC channels and the 4 x 4 f32 FMA product per
// thread).  nobcast first runs tile_max_kernel, one block per (batch, row
// tile, tap), which reduces the hat maps to their tile maxima.
//
// What bounds each.  dma, window and aligned move bytes: x read once (plus
// the halo's re-reads, which mostly hit L2) and the output written once.
// matmul, nomap and nobcast do dcn_fwd's 2*9*C*Co FLOP per pixel as f32 FMAs
// from shared memory, the same bound as dcn_fwd; nomap and nobcast add
// (2R+1)^2 loads per sample, from L1/L2.  These are diagnostics: each keeps
// dcn_fwd's structure so that its time is a part of dcn_fwd's, not a faster
// design of the same function.
//
// Layouts: x (B,H,W,C), offset (B,H,W,18) interleaved (dy_k, dx_k), mask
// (B,H,W,9), weight (9,C,Co), out (B,H,W,C or Co), tilemax
// (B * ntiles * 9, 2, 2R+1) scratch (wy maxima, then wx maxima); all f32,
// contiguous.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

enum Variant : int { kDma = 0, kWindow = 1, kAligned = 2, kMatmul = 3, kNomap = 4, kNobcast = 5 };

constexpr int THREADS = 256;
constexpr int GUARD = 8;            // guard rows above and below a staged tile
constexpr int RMAX = GUARD - 1;     // P = R + 1 <= GUARD, as on the TPU
constexpr int MAXW = 2 * RMAX + 1;  // window terms per axis
// gemm_body: as dcn_fwd
constexpr int TP = 64;    // output pixels per block
constexpr int TCO = 64;   // output channels per block
constexpr int TC = 32;    // input channels per chunk
// sum_body
constexpr int TCW = 64;   // channels per block; 256 threads = 4 pixel lanes x 64
// dma_body
constexpr int DTH = 8;    // core rows per block
constexpr int DTW = 32;   // core columns per block
constexpr int DTC = 8;    // channels per block (one 32-byte sector per column)

struct Args {
  const float* x;
  const float* offset;
  const float* mask;
  const float* weight;
  const float* tilemax;
  float* out;
  int B, H, W, C, Co, tile_h, ntiles, R;
};

__device__ __forceinline__ float hat(float t) { return fmaxf(0.f, 1.f - fabsf(t)); }

__device__ __forceinline__ float clampR(float v, float R) { return fminf(fmaxf(v, -R), R); }

// float <-> unsigned keys that order like the floats, for atomicMax
__device__ __forceinline__ unsigned int to_key(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// grid (c tiles x column tiles, row tiles, B)
__device__ void dma_body(const Args& a) {
  __shared__ float s_x[DTH + 2 * GUARD][DTW + 2 * GUARD][DTC];
  const int P = a.R + 1;
  const int c_tiles = (a.C + DTC - 1) / DTC;
  const int c0 = (blockIdx.x % c_tiles) * DTC;
  const int w0 = (blockIdx.x / c_tiles) * DTW;
  const int h0 = blockIdx.y * DTH;
  const int b = blockIdx.z;
  const int rows = DTH + 2 * GUARD;
  const int cols = DTW + 2 * P;
  for (int e = threadIdx.x; e < rows * cols * DTC; e += THREADS) {
    const int c = e % DTC;
    const int j = (e / DTC) % cols;
    const int i = e / (DTC * cols);
    const int h = h0 - GUARD + i;
    const int w = w0 - P + j;
    float v = 0.f;
    if (h >= 0 && h < a.H && w >= 0 && w < a.W && c0 + c < a.C)
      v = a.x[((b * a.H + h) * a.W + w) * a.C + c0 + c];
    s_x[i][j][c] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < DTH * DTW * DTC; e += THREADS) {
    const int c = e % DTC;
    const int j = (e / DTC) % DTW;
    const int i = e / (DTC * DTW);
    const int h = h0 + i;
    const int w = w0 + j;
    if (h < a.H && w < a.W && c0 + c < a.C)
      a.out[((b * a.H + h) * a.W + w) * a.C + c0 + c] = s_x[GUARD + i][P + j][c];
  }
}

// grid (pixel tiles of TP, channel tiles of TCW)
template <int V>
__device__ void sum_body(const Args& a) {
  __shared__ int s_idx[TP][4];   // element offset of each corner's C run
  __shared__ float s_wt[TP][4];  // bilinear weight, 0 outside the map
  const int tid = threadIdx.x;
  const int npix = a.B * a.H * a.W;
  const int p0 = blockIdx.x * TP;
  const int c = blockIdx.y * TCW + tid % TCW;  // channel fastest: coalesced
  const int lane = tid / TCW;                  // pixels lane + 4i
  const float R = static_cast<float>(a.R);
  float acc[TP / 4];
#pragma unroll
  for (int i = 0; i < TP / 4; ++i) acc[i] = 0.f;

  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3 - 1;
    const int kx = k % 3 - 1;
    __syncthreads();  // the previous tap's corners are no longer read
    {
      const int p = tid / 4;
      const int corner = tid % 4;
      const int pix = p0 + p;
      int idx = 0;
      float wt = 0.f;
      if (pix < npix) {
        const int w = pix % a.W;
        const int h = (pix / a.W) % a.H;
        const int b = pix / (a.W * a.H);
        const float py = h + ky + clampR(a.offset[pix * 18 + 2 * k], R);
        // aligned drops the column shift: the sample column is w itself
        const float px = V == kAligned ? static_cast<float>(w)
                                       : w + kx + clampR(a.offset[pix * 18 + 2 * k + 1], R);
        const float fy = floorf(py);
        const float fx = floorf(px);
        const float ly = py - fy;
        const float lx = px - fx;
        const int dy = corner >> 1;
        const int dx = corner & 1;
        const int yy = static_cast<int>(fy) + dy;
        const int xx = static_cast<int>(fx) + dx;
        if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
          idx = ((b * a.H + yy) * a.W + xx) * a.C;
          wt = (dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx);
        }
      }
      s_idx[p][corner] = idx;
      s_wt[p][corner] = wt;
    }
    __syncthreads();
    if (c < a.C) {
#pragma unroll
      for (int i = 0; i < TP / 4; ++i) {
        const int p = lane + 4 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i] += s_wt[p][j] * a.x[s_idx[p][j] + c];
      }
    }
  }
  if (c >= a.C) return;
#pragma unroll
  for (int i = 0; i < TP / 4; ++i) {
    const int pix = p0 + lane + 4 * i;
    if (pix < npix) a.out[static_cast<long long>(pix) * a.C + c] = acc[i];
  }
}

// grid (pixel tiles of TP, output-channel tiles of TCO)
template <int V>
__device__ void gemm_body(const Args& a) {
  __shared__ int s_pix[TP][3];         // b, h, w; b = -1 past the last pixel
  __shared__ float s_wy[TP][MAXW];     // row weights (matmul: the mask in [0])
  __shared__ float s_wx[TP][MAXW];     // column weights
  __shared__ float s_col[TC][TP + 1];  // sampled im2col chunk (+1: no bank conflicts)
  __shared__ float s_w[TC][TCO];       // W_k chunk

  const int tid = threadIdx.x;
  const int npix = a.B * a.H * a.W;
  const int p0 = blockIdx.x * TP;
  const int co0 = blockIdx.y * TCO;
  const int tp = tid / 16;
  const int tco = tid % 16;
  const int n = 2 * a.R + 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3 - 1;
    const int kx = k % 3 - 1;
    __syncthreads();  // the previous tap's tables are no longer read
    if (tid < TP) {
      const int pix = p0 + tid;
      int b = -1, h = 0, w = 0;
      if (pix < npix) {
        w = pix % a.W;
        h = (pix / a.W) % a.H;
        b = pix / (a.W * a.H);
      }
      s_pix[tid][0] = b;
      s_pix[tid][1] = h;
      s_pix[tid][2] = w;
      if (b >= 0) {
        if constexpr (V == kMatmul) {
          s_wy[tid][0] = a.mask[pix * 9 + k];
        } else if constexpr (V == kNomap) {
          for (int i = 0; i < n; ++i) s_wy[tid][i] = s_wx[tid][i] = 0.5f;
        } else {
          const float* m = a.tilemax + ((b * a.ntiles + h / a.tile_h) * 9 + k) * 2 * n;
          for (int i = 0; i < n; ++i) {
            s_wy[tid][i] = m[i];
            s_wx[tid][i] = m[n + i];
          }
        }
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < a.C; c0 += TC) {
      for (int e = tid; e < TC * TP; e += THREADS) {
        const int c = e % TC;
        const int p = e / TC;
        const int b = s_pix[p][0];
        float v = 0.f;
        if (b >= 0 && c0 + c < a.C) {
          const int h = s_pix[p][1] + ky;
          const int w = s_pix[p][2] + kx;
          if constexpr (V == kMatmul) {
            if (h >= 0 && h < a.H && w >= 0 && w < a.W)
              v = s_wy[p][0] * a.x[((b * a.H + h) * a.W + w) * a.C + c0 + c];
          } else {
            for (int i = 0; i < n; ++i) {
              const int yy = h + i - a.R;
              if (yy < 0 || yy >= a.H) continue;
              const float* row = a.x + (b * a.H + yy) * a.W * a.C + c0 + c;
              float t = 0.f;
              for (int j = 0; j < n; ++j) {
                const int xx = w + j - a.R;
                if (xx >= 0 && xx < a.W) t += s_wx[p][j] * row[xx * a.C];
              }
              v += s_wy[p][i] * t;
            }
          }
        }
        s_col[c][p] = v;
      }
      for (int e = tid; e < TC * TCO; e += THREADS) {
        const int co = e % TCO;
        const int c = e / TCO;
        s_w[c][co] = (c0 + c < a.C && co0 + co < a.Co)
                         ? a.weight[(static_cast<long long>(k) * a.C + c0 + c) * a.Co + co0 + co]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < TC; ++c) {
        float x4[4], w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x4[i] = s_col[c][tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w4[j] = s_w[c][tco + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x4[i], w4[j], acc[i][j]);
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
      if (co < a.Co) a.out[static_cast<long long>(pix) * a.Co + co] = acc[i][j];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS) dcn_ablate_kernel(Args a) {
  if constexpr (V == kDma)
    dma_body(a);
  else if constexpr (V == kWindow || V == kAligned)
    sum_body<V>(a);
  else
    gemm_body<V>(a);
}

// nobcast's tile maxima: one block per (batch, row tile, tap) reduces the
// tile's tile_h x W hat maps, rows past H taken with offset 0 and mask 0 as
// the TPU kernel's padded rows
__global__ void __launch_bounds__(THREADS) tile_max_kernel(Args a, float* tilemax) {
  __shared__ unsigned int s_key[2][MAXW];
  const int tid = threadIdx.x;
  const int k = blockIdx.x % 9;
  const int t = (blockIdx.x / 9) % a.ntiles;
  const int b = blockIdx.x / (9 * a.ntiles);
  const int n = 2 * a.R + 1;
  const float R = static_cast<float>(a.R);
  if (tid < 2 * MAXW) s_key[tid / MAXW][tid % MAXW] = to_key(-CUDART_INF_F);
  float my[MAXW], mx[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) my[i] = mx[i] = -CUDART_INF_F;
  __syncthreads();
  for (int q = tid; q < a.tile_h * a.W; q += THREADS) {
    const int h = t * a.tile_h + q / a.W;
    const int w = q % a.W;
    float oy = 0.f, ox = 0.f, m = 0.f;
    if (h < a.H) {
      const int pix = (b * a.H + h) * a.W + w;
      oy = clampR(a.offset[pix * 18 + 2 * k], R);
      ox = clampR(a.offset[pix * 18 + 2 * k + 1], R);
      m = a.mask[pix * 9 + k];
    }
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < n) {
        const float f = static_cast<float>(i - a.R);
        my[i] = fmaxf(my[i], hat(oy - f) * m);
        mx[i] = fmaxf(mx[i], hat(ox - f));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < n) {
      atomicMax(&s_key[0][i], to_key(my[i]));
      atomicMax(&s_key[1][i], to_key(mx[i]));
    }
  }
  __syncthreads();
  if (tid < 2 * n) tilemax[blockIdx.x * 2 * n + tid] = from_key(s_key[tid / n][tid % n]);
}

template <int V>
int launch(const Args& a, cudaStream_t s) {
  const int npix = a.B * a.H * a.W;
  if constexpr (V == kDma) {
    const dim3 grid(((a.C + DTC - 1) / DTC) * ((a.W + DTW - 1) / DTW), (a.H + DTH - 1) / DTH,
                    a.B);
    dcn_ablate_kernel<V><<<grid, THREADS, 0, s>>>(a);
  } else if constexpr (V == kWindow || V == kAligned) {
    const dim3 grid((npix + TP - 1) / TP, (a.C + TCW - 1) / TCW);
    dcn_ablate_kernel<V><<<grid, THREADS, 0, s>>>(a);
  } else {
    if constexpr (V == kNobcast) {
      tile_max_kernel<<<a.B * a.ntiles * 9, THREADS, 0, s>>>(a, const_cast<float*>(a.tilemax));
      const int err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
    }
    const dim3 grid((npix + TP - 1) / TP, (a.Co + TCO - 1) / TCO);
    dcn_ablate_kernel<V><<<grid, THREADS, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the variant on `stream` and returns cudaGetLastError() (0 on
// success).  The caller checks shapes, devices and contiguity, that every
// index fits in 32 bits and that 0 <= R <= 7, and for nobcast allocates
// tilemax as (B * ntiles * 9, 2, 2R + 1) with ntiles = ceil(H / tile_h).
extern "C" int dcn_ablate(int variant, const void* x, const void* offset, const void* mask,
                          const void* weight, void* tilemax, void* out, int B, int H, int W,
                          int C, int Co, int tile_h, int ntiles, int R, void* stream) {
  if (R < 0 || R > RMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(offset),
               static_cast<const float*>(mask), static_cast<const float*>(weight),
               static_cast<const float*>(tilemax), static_cast<float*>(out),
               B, H, W, C, Co, tile_h, ntiles, R};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kDma: return launch<kDma>(a, s);
    case kWindow: return launch<kWindow>(a, s);
    case kAligned: return launch<kAligned>(a, s);
    case kMatmul: return launch<kMatmul>(a, s);
    case kNomap: return launch<kNomap>(a, s);
    case kNobcast: return launch<kNobcast>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
