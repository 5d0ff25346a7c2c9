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
// with hat weights and their derivatives, because Mosaic cannot gather, and
// contracts on the MXU at DEFAULT precision; here the 4 corners are gathered
// directly.  The offset derivative is the floor-based, one-sided derivative of
// bilinear sampling (the reference CUDA op's): at an integer offset it is the
// difference towards the next row or column, where the TPU kernel's hat
// derivative gives 0 (ROADMAP C1).
//
// Both products run on wgmma (sm90_mma.cuh), each f32-class product as three
// bf16 passes a_hi b_hi + a_hi b_lo + a_lo b_hi with f32 accumulators, one
// pass under bf16 window math, where the operands are bf16-exact.  Three
// __global__ kernels, all deterministic (no atomics; every sum in a fixed
// order, so two launches are bit-equal):
//  - dcn_bwd_mo_kernel: per block of 64 pixels, g's tile (64 x Co, split hi/lo)
//    is staged once in shared memory; per tap and 64-channel chunk a bulk copy
//    brings W_k's chunk (rows of channels, Co contiguous, split and laid out
//    by dwmo_weight_image_kernel, launched first)
//    into a double-buffered stage and warpgroup 0 forms u_k = g W_k^T on
//    wgmma and writes it to shared memory.  While the next stage's u is on
//    the tensor cores, all 256 threads gather the 4 corners, 8 threads a
//    pixel and 8 channels each (a warp reads whole corner runs), form S, SY
//    and SX in f32 and dot them with u; 8 lanes and the chunks finish each
//    pixel's sums in a fixed order.
//  - dcn_bwd_dw_kernel: dW_k = (m_k S_k)^T g over a slice of the pixels.  As
//    in the forward, all threads sample a stage into one of two buffers
//    while the tensor cores run the previous one's products.  The stage holds
//    the sampled tile (64 pixels x 64 channels) and g's tile (64 pixels x BN
//    output channels), both with pixels as rows, and wgmma reads both
//    transposed (MN-major): M = channels, N = output channels, K = pixels.  Each block writes its
//    partial dW tile (split-K over B*H*W: one tap's reduction runs over
//    245,760 pixels at 384x1280, batch 8).
//  - dcn_bwd_dw_reduce_kernel: sums the partials in a fixed order.
// Why two gathers: u_k is a per-pixel product (K = Co) and dW a reduction over
// pixels (K = pixels).  In one kernel a block would hold u's accumulators
// (64 x 64) beside dW's (64 x Co, 128 registers a thread at Co = 256) and
// reduce dmask/doffset across channel tiles in a second pass; two kernels
// keep each warpgroup's accumulators in registers without spills.
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
// (B,H,W,18) interleaved (dy_k, dx_k), mask (B,H,W,9), w_img
// (9, ceil(C/64), 2, ceil(Co/64), 64, 64) bf16 (ops/dcn_cuda.py::
// dwmo_weight_image), g (B,H,W,Co), dmask (B,H,W,9), doffset (B,H,W,18), dw
// (9,C,Co), dw_partial (nsplit,9,C,Co) scratch, all f32 but x and w_img, all
// contiguous.
//
// What bounds it.  u_k and dW are 2*9*C*Co FLOP per pixel each, 446 GFLOP
// per step over the neck's 16 layers at batch 8: at three bf16 passes on the
// tensor cores 1.29 ms, beside 0.578 ms of f32 sampling (30 operations per
// sample).  What holds it back after this design: the sampling, not the
// products: x's corners are gathered twice (once per kernel, from L2
// mostly), dW's sampling also splits g for every (tap, channel tile), and
// the mo kernel holds one block an SM at Co > 128 (g and two W stages fill
// its shared memory; it takes Co <= 256).

#include "sm90_mma.cuh"

namespace {

using sm90::kRowBytes;

constexpr int TP = 64;          // pixels per tile (one m64 warpgroup, or one K stage)
constexpr int TC = 64;          // channels per tile
constexpr int CHUNK = 64 * kRowBytes;  // one swizzled 64-row chunk: 8 KB

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ x, long long e, float* v);
template <>
__device__ __forceinline__ void load8<float>(const float* __restrict__ x, long long e, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x + e));
  const float4 b = __ldg(reinterpret_cast<const float4*>(x + e) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* __restrict__ x,
                                                     long long e, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + e));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
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

// The 4 corners' run offsets and weights (no mask) of pixel `pix` at tap k
// from one read of its offsets: corner_of's idx and ws for every corner.
__device__ __forceinline__ void corners4(const float* __restrict__ offset, int pix, int k, int H,
                                         int W, int C, float R, int* idx, float* ws) {
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
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int dy = q >> 1;
    const int dx = q & 1;
    const int yy = static_cast<int>(fy) + dy;
    const int xx = static_cast<int>(fx) + dx;
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    idx[q] = in ? ((b * H + yy) * W + xx) * C : 0;
    ws[q] = in ? (dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) : 0.f;
  }
}

// 8 values of g (row `pix`, columns co .. co+7) into the swizzled hi/lo
// chunks at (row, group j); 0 past the row's end or past npix
template <bool kLo>
__device__ __forceinline__ void stage_g8(const float* __restrict__ g, bool vec, int pix, int npix,
                                         int co, int Co, uint8_t* hi_chunk, uint8_t* lo_chunk,
                                         int row, int j) {
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (pix < npix) {
    const float* src = g + static_cast<long long>(pix) * Co + co;
    if (vec && co + 8 <= Co) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (co + e < Co) v[e] = src[e];
    }
  }
  uint4 hi, lo;
  sm90::split8<kLo>(v, hi, lo);
  *reinterpret_cast<uint4*>(hi_chunk + sm90::swz(row, j)) = hi;
  if constexpr (kLo) *reinterpret_cast<uint4*>(lo_chunk + sm90::swz(row, j)) = lo;
}

// ---------------------------------------------------------------------------
// dmask and doffset.  64 pixels a block, two warpgroups.  Shared memory: g hi
// and lo (KC chunks each), two W stages (hi and lo, KC chunks each), u of one
// stage in f32, the corners of three taps.  Per stage (tap, 64-channel tile)
// all threads dot the previous stage's u with its samples, then issue the
// loads of this stage's corner runs (8 threads a pixel, one 8-channel group
// each, so a warp reads whole runs), which stay in flight while warpgroup 0
// forms this stage's u on wgmma and until the next stage's dot.

constexpr int MO_THREADS = 256;
constexpr int U_STRIDE = 72;  // floats a row of u: 8 banks apart, no conflicts

__host__ __device__ constexpr int mo_smem_bytes(int kc) {
  return 2 * kc * CHUNK + 2 * 2 * kc * CHUNK + TP * U_STRIDE * 4 + 3 * TP * 4 * 16 + 2 * 8 +
         1024;
}

// two blocks an SM where shared memory allows and the prefetched runs are
// bf16 (32 registers); f32 runs take 64, which two blocks could not hold
template <typename T, bool kBf16Math, int KC>
__global__ void __launch_bounds__(MO_THREADS, KC <= 2 && sizeof(T) == 2 ? 2 : 1)
dcn_bwd_mo_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const __nv_bfloat16* __restrict__ w_img,
                  const float* __restrict__ g, float* __restrict__ dmask,
                  float* __restrict__ doffset, int B, int H, int W, int C, int Co, float R) {
  constexpr bool kLo = !kBf16Math;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* g_hi = smem;
  uint8_t* g_lo = g_hi + KC * CHUNK;
  uint8_t* w_stage = g_lo + KC * CHUNK;  // 2 stages x (hi, lo) x KC chunks
  float* s_u = reinterpret_cast<float*>(w_stage + 2 * 2 * KC * CHUNK);
  int* s_idx = reinterpret_cast<int*>(s_u + TP * U_STRIDE);  // [tap % 3][pixel][corner]
  float* s_ws = reinterpret_cast<float*>(s_idx + 3 * TP * 4);
  float* s_wy = s_ws + 3 * TP * 4;
  float* s_wx = s_wy + 3 * TP * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_wx + 3 * TP * 4);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * TP;
  const int n_ct = (C + TC - 1) / TC;
  const int n_stages = 9 * n_ct;
  const uint32_t w_bytes = (kLo ? 2 : 1) * KC * CHUNK;
  auto copy_w = [&](int s) {
    const int buf = s & 1;
    sm90::mbar_arrive_expect_tx(&full[buf], w_bytes);
    sm90::bulk_copy(w_stage + buf * 2 * KC * CHUNK,
                    w_img + static_cast<long long>(s) * 2 * KC * 64 * 64, w_bytes, &full[buf]);
  };

  if (tid == 0) {
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) copy_w(0);
  // g's tile, split once: rows = pixels, KC chunks of 64 output channels
  {
    const bool vec = (Co % 8 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0);
    for (int u = tid; u < TP * KC * 8; u += MO_THREADS) {
      const int row = u / (KC * 8);
      const int cg = u % (KC * 8);
      stage_g8<kLo>(g, vec, p0 + row, npix, 8 * cg, Co, g_hi + (cg >> 3) * CHUNK,
                    g_lo + (cg >> 3) * CHUNK, row, cg & 7);
    }
  }
  sm90::fence_proxy_async();

  // the dot products' mapping: pixels row0 + 32 pass, channel group j
  const int j = tid & 7;
  const int row0 = tid >> 3;
  const bool vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  constexpr int kVec = sizeof(T) / 2;  // 16-byte loads per 8 values
  auto corners_of_tap = [&](int k) {
    // into set k % 3: the dot products read the set of the stage before the
    // last while the next tap's corners are written
    const int set = (k % 3) * TP * 4;
    const int p = tid >> 2;
    Corner cn{0, 0.f, 0.f, 0.f};
    if (p0 + p < npix) cn = corner_of(offset, p0 + p, k, tid & 3, H, W, C, R);
    s_idx[set + tid] = cn.idx;
    s_ws[set + tid] = cn.ws;
    s_wy[set + tid] = cn.wy;
    s_wx[set + tid] = cn.wx;
  };
  corners_of_tap(0);
  __syncthreads();  // g's tile and tap 0's corners are in place

  float dm[2] = {0.f, 0.f}, doy[2] = {0.f, 0.f}, dox[2] = {0.f, 0.f};
  float u[32];
  uint4 xr[2][4][kVec];  // the next dot's corner runs, loaded a stage ahead

  for (int s = 0; s <= n_stages; ++s) {
    // buffer (s + 1) & 1 was last read by stage s - 1's product, waited for
    // before the last barrier
    if (tid == 0 && s + 1 < n_stages) copy_w(s + 1);
    // ---- stage s - 1: its samples dotted with its u ----
    if (s > 0) {
      const int k = (s - 1) / n_ct;
      const int ct = (s - 1) % n_ct;
      const int set = (k % 3) * TP * 4;
      const int c = ct * TC + 8 * j;
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const int p = row0 + 32 * pass;
        if (c >= C) continue;
        float sv[8], sy[8], sx[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) sv[e] = sy[e] = sx[e] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float xv[8];
          if (vec && c + 8 <= C) {
            if constexpr (kVec == 2) {
              const float* f = reinterpret_cast<const float*>(xr[pass][q]);
#pragma unroll
              for (int e = 0; e < 8; ++e) xv[e] = f[e];
            } else {
              const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(xr[pass][q]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(h[e]);
                xv[2 * e] = f.x;
                xv[2 * e + 1] = f.y;
              }
            }
          } else {
            const long long base = static_cast<long long>(s_idx[set + 4 * p + q]) + c;
#pragma unroll
            for (int e = 0; e < 8; ++e) xv[e] = c + e < C ? to_f32(x[base + e]) : 0.f;
          }
          const float ws = s_ws[set + 4 * p + q];
          const float wy = s_wy[set + 4 * p + q];
          const float wx = s_wx[set + 4 * p + q];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sv[e] = fmaf(ws, xv[e], sv[e]);
            sy[e] = fmaf(wy, xv[e], sy[e]);
            sx[e] = fmaf(wx, xv[e], sx[e]);
          }
        }
        const float4 ua = *reinterpret_cast<const float4*>(s_u + p * U_STRIDE + 8 * j);
        const float4 ub = *reinterpret_cast<const float4*>(s_u + p * U_STRIDE + 8 * j + 4);
        const float uv[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dm[pass] = fmaf(sv[e], uv[e], dm[pass]);
          doy[pass] = fmaf(sy[e], uv[e], doy[pass]);
          dox[pass] = fmaf(sx[e], uv[e], dox[pass]);
        }
      }
      if (ct == n_ct - 1) {
        // finish each pixel's channel sums across its 8 lanes
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
          for (int sh = 1; sh < 8; sh <<= 1) {
            dm[pass] += __shfl_xor_sync(0xffffffffu, dm[pass], sh);
            doy[pass] += __shfl_xor_sync(0xffffffffu, doy[pass], sh);
            dox[pass] += __shfl_xor_sync(0xffffffffu, dox[pass], sh);
          }
          const int pix = p0 + row0 + 32 * pass;
          if (j == 0 && pix < npix) {
            const float m = mask[pix * 9 + k];
            const float oy = offset[pix * 18 + 2 * k];
            const float ox = offset[pix * 18 + 2 * k + 1];
            dmask[pix * 9 + k] = dm[pass];
            doffset[pix * 18 + 2 * k] = fabsf(oy) <= R ? m * doy[pass] : 0.f;
            doffset[pix * 18 + 2 * k + 1] = fabsf(ox) <= R ? m * dox[pass] : 0.f;
          }
          dm[pass] = doy[pass] = dox[pass] = 0.f;
        }
      }
    }
    if (s < n_stages) {
      const int k = s / n_ct;
      // ---- stage s: its corner runs, in flight until the next dot ----
      {
        const int set = (k % 3) * TP * 4;
        const int c = (s % n_ct) * TC + 8 * j;
        if (vec && c + 8 <= C) {
#pragma unroll
          for (int pass = 0; pass < 2; ++pass)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const T* src = x + static_cast<long long>(s_idx[set + 4 * (row0 + 32 * pass) + q]) + c;
#pragma unroll
              for (int v = 0; v < kVec; ++v)
                xr[pass][q][v] = __ldg(reinterpret_cast<const uint4*>(src) + v);
            }
        }
      }
      // the next tap's corners, a stage before its first dot
      if ((s + 1) % n_ct == 0 && s + 1 < n_stages) corners_of_tap(k + 1);
      // ---- stage s: u = g W_k^T on wgmma ----
      if (wg == 0) {
        sm90::mbar_wait(&full[s & 1], (s >> 1) & 1);
        uint8_t* w_hi = w_stage + (s & 1) * 2 * KC * CHUNK;
        uint8_t* w_lo = w_hi + KC * CHUNK;
#pragma unroll
        for (int i = 0; i < 32; ++i) u[i] = 0.f;
        sm90::wgmma_fence();
#pragma unroll
        for (int q = 0; q < KC; ++q) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = q * CHUNK + 32 * kk;
            const uint64_t dgh = sm90::desc(sm90::smem_u32(g_hi) + off, 16, 1024);
            const uint64_t dwh = sm90::desc(sm90::smem_u32(w_hi) + off, 16, 1024);
            sm90::wgmma<64, 0, 0>(u, dgh, dwh);
            if constexpr (kLo) {
              const uint64_t dgl = sm90::desc(sm90::smem_u32(g_lo) + off, 16, 1024);
              const uint64_t dwl = sm90::desc(sm90::smem_u32(w_lo) + off, 16, 1024);
              sm90::wgmma<64, 0, 0>(u, dgh, dwl);
              sm90::wgmma<64, 0, 0>(u, dgl, dwh);
            }
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
      }
    }
    __syncthreads();  // u of stage s - 1 is read; stage s's W buffer is free
    if (wg == 0 && s < n_stages) {
      // u's fragment: register 4i + 2h + e holds row 16 warp + lane/4 + 8h,
      // column 8i + 2 (lane%4) + e
      sm90::fence_acc<32>(u);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(s_u + (16 * warp + (lane >> 2) + 8 * h) * U_STRIDE + 8 * i +
                                     2 * (lane & 3)) = make_float2(u[4 * i + 2 * h],
                                                                  u[4 * i + 2 * h + 1]);
    }
    __syncthreads();  // u of stage s and the next tap's corners are in place
  }
}

// ---------------------------------------------------------------------------
// dW.  grid (nsplit, 9, channel tiles x output-channel tiles); block (s, k,
// tile) sums pixels [s*chunk, (s+1)*chunk) into dw_partial[s, k, tile].  All
// 256 threads sample a stage (64 pixels) into one of two buffers while
// warpgroup 0's products of the previous stage run on wgmma.

constexpr int DW_THREADS = 256;

template <int BN>
struct DwSmem {
  static constexpr int kStage = 2 * CHUNK + 2 * (BN / 64) * CHUNK;  // A hi, lo; g hi, lo
  static constexpr int kBytes = 2 * kStage + 1024;
  static constexpr int kBlocksPerSm = BN == 256 ? 1 : BN == 128 ? 2 : 3;
};

template <typename T, bool kBf16Math, int BN>
__global__ void __launch_bounds__(DW_THREADS, DwSmem<BN>::kBlocksPerSm)
dcn_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const float* __restrict__ g,
                  float* __restrict__ dw_partial, int chunk, int B, int H, int W, int C, int Co,
                  float R) {
  constexpr bool kLo = !kBf16Math;
  using S = DwSmem<BN>;
  constexpr int NB = BN / 64;  // g chunks per stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int npix = B * H * W;
  const int k = blockIdx.y;
  const int n_nt = (Co + BN - 1) / BN;
  const int c0 = (blockIdx.z / n_nt) * TC;
  const int co0 = (blockIdx.z % n_nt) * BN;
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, npix);
  const int n_stages = end > begin ? (end - begin + TP - 1) / TP : 0;
  const int j = tid & 7;           // this thread's channel group
  const int row0 = tid >> 3;       // and its pixels row0, row0 + 32 of a stage
  const bool vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool gvec = (Co % 8 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    uint8_t* a_hi = smem + (s & 1) * S::kStage;
    uint8_t* a_lo = a_hi + CHUNK;
    uint8_t* b_hi = a_lo + CHUNK;
    uint8_t* b_lo = b_hi + NB * CHUNK;
    const int q0 = begin + s * TP;
    // ---- sample the stage: m_k S_k (64 pixels x 64 channels) and g ----
    {
      const int c = c0 + 8 * j;
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const int row = row0 + 32 * pass;
        const int pix = q0 + row;
        int idx[4] = {0, 0, 0, 0};
        float wt[4] = {0.f, 0.f, 0.f, 0.f};
        if (pix < end) {
          const float m = mask[pix * 9 + k];
          corners4(offset, pix, k, H, W, C, R, idx, wt);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wt[q] = kBf16Math ? sm90::bf16_round(wt[q] * m) : wt[q] * m;
        }
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
        if (vec && c + 8 <= C) {
          float xv[4][8];
#pragma unroll
          for (int q = 0; q < 4; ++q) load8<T>(x, static_cast<long long>(idx[q]) + c, xv[q]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = fmaf(wt[q], xv[q][e], v[e]);
        } else if (c < C) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c + e < C)
                v[e] = fmaf(wt[q], to_f32(x[static_cast<long long>(idx[q]) + c + e]), v[e]);
        }
        uint4 hi, lo;
        sm90::split8<kLo>(v, hi, lo);
        *reinterpret_cast<uint4*>(a_hi + sm90::swz(row, j)) = hi;
        if constexpr (kLo) *reinterpret_cast<uint4*>(a_lo + sm90::swz(row, j)) = lo;
      }
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int u = tid + DW_THREADS * i;
        const int grow = u / (NB * 8);
        const int cg = u % (NB * 8);
        const int gp = q0 + grow;
        stage_g8<kLo>(g, gvec, gp < end ? gp : npix, npix, co0 + 8 * cg, Co,
                      b_hi + (cg >> 3) * CHUNK, b_lo + (cg >> 3) * CHUNK, grow, cg & 7);
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();  // the stage is complete
    if (warp < 4) {
      // ---- D (64 channels x BN) += A^T (64 x 64 pixels) . G, left in flight ----
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TP / 16; ++kk) {
        // MN-major: 16 pixel rows per k-step, 8-row groups 1024 bytes apart,
        // g's 64-column chunks CHUNK apart
        const uint32_t off = 2048 * kk;
        const uint64_t dah = sm90::desc(sm90::smem_u32(a_hi) + off, CHUNK, 1024);
        const uint64_t dbh = sm90::desc(sm90::smem_u32(b_hi) + off, CHUNK, 1024);
        sm90::wgmma<BN, 1, 1>(acc, dah, dbh);
        if constexpr (kLo) {
          const uint64_t dal = sm90::desc(sm90::smem_u32(a_lo) + off, CHUNK, 1024);
          const uint64_t dbl = sm90::desc(sm90::smem_u32(b_lo) + off, CHUNK, 1024);
          sm90::wgmma<BN, 1, 1>(acc, dah, dbl);
          sm90::wgmma<BN, 1, 1>(acc, dal, dbh);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous stage's products are done
    }
    __syncthreads();  // so its buffer, the next stage's, is free
  }
  if (warp < 4) {
    sm90::wgmma_wait<0>();
    sm90::fence_acc<BN / 2>(acc);
    float* out = dw_partial + (static_cast<long long>(blockIdx.x) * 9 + k) * C * Co;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 16 * warp + (lane >> 2) + 8 * h;
        if (c >= C) continue;
        if (co < Co) out[static_cast<long long>(c) * Co + co] = acc[4 * j + 2 * h];
        if (co + 1 < Co) out[static_cast<long long>(c) * Co + co + 1] = acc[4 * j + 2 * h + 1];
      }
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

// W (9, C, Co) f32 -> w_img (9, n_ct, 2, KC, 64, 64) bf16: per (tap, channel
// tile) the hi then lo chunks, rows of channels with 64 output channels each,
// zero-padded and swizzled (ops/dcn_cuda.py::dwmo_weight_image is its plain
// version).  One thread per 16-byte group.
__global__ void dwmo_weight_image_kernel(const float* __restrict__ w,
                                         __nv_bfloat16* __restrict__ img, int C, int Co,
                                         int bf16_math) {
  const int n_ct = (C + TC - 1) / TC;
  const int kc = (Co + 63) / 64;
  const int total = 9 * n_ct * kc * 64 * 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int grp = t & 7;
  const int r = (t >> 3) & 63;
  const int q = (t >> 9) % kc;
  const int tile = (t >> 9) / kc;  // (k, ct)
  const int ct = tile % n_ct;
  const int k = tile / n_ct;
  const int c = ct * TC + r;
  const int co = q * 64 + 8 * grp;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = (c < C && co + e < Co) ? w[(static_cast<long long>(k) * C + c) * Co + co + e] : 0.f;
  uint4 hi, lo;
  sm90::split8<true>(v, hi, lo);
  if (bf16_math) lo = make_uint4(0u, 0u, 0u, 0u);
  uint8_t* base = reinterpret_cast<uint8_t*>(img) + static_cast<long long>(tile) * 2 * kc * CHUNK;
  *reinterpret_cast<uint4*>(base + q * CHUNK + sm90::swz(r, grp)) = hi;
  *reinterpret_cast<uint4*>(base + (kc + q) * CHUNK + sm90::swz(r, grp)) = lo;
}

template <typename T, bool kBf16Math, int KC>
int launch_mo(const void* x, const float* offset, const float* mask,
              const __nv_bfloat16* w_img, const float* g, float* dmask, float* doffset, int B,
              int H, int W, int C, int Co, float R, cudaStream_t s) {
  auto kernel = dcn_bwd_mo_kernel<T, kBf16Math, KC>;
  const int bytes = mo_smem_bytes(KC);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int npix = B * H * W;
  kernel<<<(npix + TP - 1) / TP, MO_THREADS, bytes, s>>>(static_cast<const T*>(x), offset, mask,
                                                         w_img, g, dmask, doffset, B, H, W, C,
                                                         Co, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBf16Math, int BN>
int launch_dw(const void* x, const float* offset, const float* mask, const float* g,
              float* dw_partial, int nsplit, int B, int H, int W, int C, int Co, float R,
              cudaStream_t s) {
  auto kernel = dcn_bwd_dw_kernel<T, kBf16Math, BN>;
  const int bytes = DwSmem<BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int npix = B * H * W;
  // a whole number of 64-pixel stages per split
  const int chunk = ((npix + nsplit - 1) / nsplit + TP - 1) / TP * TP;
  const dim3 grid(nsplit, 9, ((C + TC - 1) / TC) * ((Co + BN - 1) / BN));
  kernel<<<grid, DW_THREADS, bytes, s>>>(static_cast<const T*>(x), offset, mask, g, dw_partial,
                                         chunk, B, H, W, C, Co, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBf16Math>
int launch(const void* x, const float* offset, const float* mask, const float* weight,
           __nv_bfloat16* w_img, const float* g, float* dmask, float* doffset, float* dw_partial, float* dw,
           int nsplit, int dw_bn, int B, int H, int W, int C, int Co, float R, cudaStream_t s) {
  const int kc = (Co + 63) / 64;
  const int groups = 9 * ((C + TC - 1) / TC) * kc * 64 * 8;
  dwmo_weight_image_kernel<<<(groups + 255) / 256, 256, 0, s>>>(weight, w_img, C, Co,
                                                                kBf16Math ? 1 : 0);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  switch (kc) {
    case 1: err = launch_mo<T, kBf16Math, 1>(x, offset, mask, w_img, g, dmask, doffset, B, H, W, C, Co, R, s); break;
    case 2: err = launch_mo<T, kBf16Math, 2>(x, offset, mask, w_img, g, dmask, doffset, B, H, W, C, Co, R, s); break;
    case 3: err = launch_mo<T, kBf16Math, 3>(x, offset, mask, w_img, g, dmask, doffset, B, H, W, C, Co, R, s); break;
    case 4: err = launch_mo<T, kBf16Math, 4>(x, offset, mask, w_img, g, dmask, doffset, B, H, W, C, Co, R, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  switch (dw_bn) {
    case 64: err = launch_dw<T, kBf16Math, 64>(x, offset, mask, g, dw_partial, nsplit, B, H, W, C, Co, R, s); break;
    case 128: err = launch_dw<T, kBf16Math, 128>(x, offset, mask, g, dw_partial, nsplit, B, H, W, C, Co, R, s); break;
    case 256: err = launch_dw<T, kBf16Math, 256>(x, offset, mask, g, dw_partial, nsplit, B, H, W, C, Co, R, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int n = 9 * C * Co;
  dcn_bwd_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(dw_partial, dw, nsplit, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Lays out W (9, C, Co) f32 into w_img (scratch of 9 * ceil(C/64) * 2 *
// ceil(Co/64) * 64 * 64 bf16, ops/dcn_cuda.py::dwmo_image_numel), then
// launches the three kernels, all on `stream`; returns the first nonzero CUDA
// error (0 on success).  The caller checks shapes, dtypes, devices and
// contiguity, that every index fits in 32 bits and Co <= 256, and allocates
// dw_partial as (nsplit, 9, C, Co); a split left with no pixels writes zeros.
// dw_bn (64, 128 or 256) is the dW kernel's output-channel tile.  bf16_math
// needs x in bf16.
extern "C" int dcn_bwd_dwmo(const void* x, int x_is_bf16, int bf16_math, const void* offset,
                            const void* mask, const void* weight, void* w_img, const void* g,
                            void* dmask, void* doffset, void* dw_partial, void* dw, int nsplit,
                            int dw_bn, int B, int H, int W, int C, int Co, float max_offset,
                            void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  auto* wi = static_cast<__nv_bfloat16*>(w_img);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_math) {
    if (!x_is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch<__nv_bfloat16, true>(x, f(offset), f(mask), f(weight), wi, f(g), m(dmask),
                                       m(doffset), m(dw_partial), m(dw), nsplit, dw_bn, B, H, W,
                                       C, Co, max_offset, s);
  }
  if (x_is_bf16)
    return launch<__nv_bfloat16, false>(x, f(offset), f(mask), f(weight), wi, f(g), m(dmask),
                                        m(doffset), m(dw_partial), m(dw), nsplit, dw_bn, B, H, W,
                                        C, Co, max_offset, s);
  return launch<float, false>(x, f(offset), f(mask), f(weight), wi, f(g), m(dmask), m(doffset),
                              m(dw_partial), m(dw), nsplit, dw_bn, B, H, W, C, Co, max_offset, s);
}
