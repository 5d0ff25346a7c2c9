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
// only because Mosaic cannot gather, and contracts on the MXU with
// dot_general at DEFAULT precision.  The window sum is exactly bilinear
// sampling at the clamped point with zero padding; Hopper can gather, so this
// kernel samples the 4 corners directly.
//
// Design.  A block owns 128 output pixels x BN output channels (BN 64 or 128)
// and walks the 9 taps x C in stages of 64 channels, with four warpgroups
// (BN = 64) or two (BN = 128) that all sample; the first two also multiply:
//  - sampling: all threads, eight per pixel.  Per stage each thread
//    computes its pixels' 4 corner offsets and (bilinear weight x mask) for
//    the tap from the block's offsets and masks (staged once in shared
//    memory), gathers its 8-channel group of each corner's run in 16-byte
//    vectors (x is NHWC, a run is contiguous; the 8 threads of a pixel read
//    the whole run, one cache line in bf16, so a warp's load touches 4
//    pixels' lines, not 16 as with two threads a pixel), forms the
//    f32 sample and writes its three bf16 parts into swizzled shared-memory
//    tiles, the im2col tile A (128 pixels x 64 channels) in the layout wgmma
//    reads (sm90_mma.cuh).  Thread 0 starts a bulk copy of the W_k chunk B
//    (BN x 64, three parts) onto an mbarrier; a small kernel
//    launched first (fwd_weight_image_kernel) splits W and lays it out in
//    that same layout;
//  - products: after the stage's barrier warpgroups 0 and 1 issue their 64
//    rows' six products of parts on wgmma (m64 x BN x k16) into a fresh
//    accumulator, wait for them and add it into the f32 sum; meanwhile
//    warpgroups 2 and 3 (BN = 64) sample the next stage into the other of two
//    buffers.  One barrier a stage;
//  - the epilogue (bias, or scale, shift and ReLU) acts on the f32
//    accumulators before the one f32 store.
// One block an SM (two stages of three parts: 159 KB at BN = 64, 207 KB at
// 128), 16 warps gathering at BN = 64.  A first version with one sampling
// warpgroup feeding two wgmma warpgroups through a full/empty ring ran at
// 10.9 ms per forward: four warps per SM could not keep enough gathers in
// flight.  The products complete within their stage, so no accumulator is
// being written while the sampling code runs.
// The im2col tile never reaches device memory, as on the TPU it stays in VMEM.
//
// Precision.  Each operand is split into three bf16 parts (hi, mid, lo: the
// 24 bits of an f32) and the six products whose parts' orders sum to at most
// 2 are taken, so what is dropped is below about 2^-25 of each product.  The
// tensor cores truncate as they add, so each stage's products (64 channels
// of one tap) go into a fresh accumulator that is then added into the f32
// sum with round-to-nearest adds; over the whole 9 C depth in one
// accumulator the truncation's bias grows with it.  Both are needed for the
// f32 class: with two parts (about 2^-16), or with three and one
// accumulator, every kernel check held, but a training step's gradients
// moved by up to 1e-2 of their norm against the plain op's
// (STEP_GRAD_REL_L2 is 1e-2), where the earlier f32-FMA kernel and this
// design move them far less (tools/step_drift.py).  Under bf16 window math (kBf16Math: the compute_dtype=
// bfloat16 mode of the v1/v2 TPU kernels monoflex_tpu/ops/dcn_pallas.py::
// dcn_pallas and dcn_pallas_v2.py::dcn_pallas_v2) x, W, each corner weight
// times the mask and each sampled value are rounded to bf16, so the lower
// parts are 0: the kernel issues one pass.  With kRoundX the kernel takes f32
// x and rounds each corner value to bf16 as it loads it, bit-equal to casting
// x first (the bf16 transfer of pallas3b without a separate cast pass).
//
// Layouts (as the JAX package's public DCN op): x (B,H,W,C) NHWC in f32 or
// bf16, offset (B,H,W,18) interleaved (dy_k, dx_k), mask (B,H,W,9)
// post-sigmoid, w_img (9, ceil(C/64), Co_pad/BN, 3, BN, 64) bf16 (W_k's chunks
// transposed to rows of output channels, three parts, swizzled;
// ops/dcn_cuda.py::fwd_weight_image), bias (Co) f32 or null, scale and shift
// (Co) f32 or both null, out (B,H,W,Co) f32.  All contiguous.
//
// What bounds it.  The neck's 16 layers at batch 8 are 213 GFLOP of products
// per forward: at six bf16 passes on the tensor cores (989 TFLOP/s dense)
// 1.29 ms (three passes would be 0.646), beside 0.154 ms of f32 sampling (8
// operations per sample at 67 TFLOP/s) and 0.286 ms of bytes (bf16 x).  What holds it back after this
// design: the gather and split (about 10 instructions per sample, and the
// latency of 4 dependent corner loads) set the pace at Co = 64, where there
// are only 128 products per sample per pass; W's split and layout cost one
// small kernel per call; BN = 128 resamples the A tile once per
// output-channel tile.

#include "sm90_mma.cuh"

namespace {

using sm90::kRowBytes;

constexpr int BM = 128;       // output pixels per block (two m64 warpgroups)
constexpr int BK = 64;        // channels per stage (one swizzled chunk)
constexpr int PARTS = 3;      // bf16 parts of each f32 operand (hi, mid, lo)
constexpr int A_BYTES = BM * kRowBytes;  // one part of A

template <int BN>
struct Smem {
  // all warpgroups sample, the first two also issue wgmma: four at BN = 64,
  // two at BN = 128 (whose accumulators need the registers); one block an
  // SM, as two stages of three parts fill its shared memory
  static constexpr int kThreads = BN == 64 ? 512 : 256;
  static constexpr int kB = BN * kRowBytes;                    // one part of B
  static constexpr int kStage = PARTS * A_BYTES + PARTS * kB;  // A parts, B parts
  static constexpr int kOffset = 2 * kStage;                   // two stages, then the
  static constexpr int kMask = kOffset + BM * 18 * 4;          // block's offsets and masks
  static constexpr int kBar = kMask + BM * 9 * 4;
  static constexpr int kBytes = kBar + 2 * 8 + 1024;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive values of x at element e (16-byte aligned for the vector path)
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

template <typename T, bool kRoundX, bool kBf16Math, int BN>
__global__ void __launch_bounds__(Smem<BN>::kThreads, 1)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const __nv_bfloat16* __restrict__ w_img,
               const float* __restrict__ bias, const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ out, int B, int H, int W,
               int C, int Co, float R) {
  using S = Smem<BN>;
  constexpr int THREADS = S::kThreads;
  constexpr int kParts = kBf16Math ? 1 : PARTS;  // bf16 math: the operands are bf16
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* s_off = reinterpret_cast<float*>(smem + S::kOffset);
  float* s_mask = reinterpret_cast<float*>(smem + S::kMask);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBar);  // W of each stage

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * BM;
  const int nt = blockIdx.y;
  const int n_cc = (C + BK - 1) / BK;
  const int n_nt = gridDim.y;
  const int n_stages = 9 * n_cc;
  const uint32_t w_bytes = kParts * S::kB;

  auto copy_w = [&](int s) {
    const int buf = s & 1;
    const long long chunk = (static_cast<long long>(s / n_cc) * n_cc + s % n_cc) * n_nt + nt;
    uint8_t* b = smem + buf * S::kStage + PARTS * A_BYTES;
    sm90::mbar_arrive_expect_tx(&full[buf], w_bytes);
    sm90::bulk_copy(b, w_img + chunk * PARTS * BN * BK, w_bytes, &full[buf]);
  };

  if (tid == 0) {
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    sm90::mbar_init_fence();
  }
  // the block's offsets and masks, read once, coalesced
  const int nrows = min(BM, npix - p0);
  for (int e = tid; e < nrows * 18; e += THREADS) s_off[e] = offset[p0 * 18 + e];
  for (int e = tid; e < nrows * 9; e += THREADS) s_mask[e] = mask[p0 * 9 + e];
  __syncthreads();
  if (tid == 0) copy_w(0);

  // sampling: 8 threads per pixel, one 8-channel group each, so the 8 lanes
  // of a pixel read a corner's run of 64 channels in one go
  constexpr int kRowsPerPass = THREADS / 8;
  const int j = tid & 7;
  const int row0 = tid >> 3;
  const bool vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    uint8_t* a = smem + buf * S::kStage;  // A's parts, A_BYTES apart
    const int k = s / n_cc;
    const int c = (s % n_cc) * BK + 8 * j;
    // ---- sample stage s into buffer buf (its last reader, stage s - 2's
    // products, finished before the barrier of stage s - 1) ----
#pragma unroll
    for (int pass = 0; pass < BM / kRowsPerPass; ++pass) {
      const int row = row0 + kRowsPerPass * pass;
      const int pix = p0 + row;
      int idx[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (pix < npix) {
        const int pw = pix % W;
        const int ph = (pix / W) % H;
        const int pb = pix / (W * H);
        const float oy = fminf(fmaxf(s_off[row * 18 + 2 * k], -R), R);
        const float ox = fminf(fmaxf(s_off[row * 18 + 2 * k + 1], -R), R);
        const float py = ph + (k / 3 - 1) + oy;
        const float px = pw + (k % 3 - 1) + ox;
        const float fy = floorf(py);
        const float fx = floorf(px);
        const float ly = py - fy;
        const float lx = px - fx;
        const float m = s_mask[row * 9 + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int dy = q >> 1;
          const int dx = q & 1;
          const int yy = static_cast<int>(fy) + dy;
          const int xx = static_cast<int>(fx) + dx;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            idx[q] = ((pb * H + yy) * W + xx) * C;
            const float v = (dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) * m;
            wt[q] = kBf16Math ? sm90::bf16_round(v) : v;
          }
        }
      }
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (vec && c + 8 <= C) {
        float xv[4][8];
#pragma unroll
        for (int q = 0; q < 4; ++q) load8<T>(x, static_cast<long long>(idx[q]) + c, xv[q]);
        if constexpr (kRoundX) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              // two values rounded in one conversion
              const float2 r =
                  __bfloat1622float2(__floats2bfloat162_rn(xv[q][e], xv[q][e + 1]));
              xv[q][e] = r.x;
              xv[q][e + 1] = r.y;
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaf(wt[q], xv[q][e], v[e]);
      } else if (c < C) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (c + e < C) {
              const float xe = to_f32(x[static_cast<long long>(idx[q]) + c + e]);
              v[e] = fmaf(wt[q], kRoundX ? sm90::bf16_round(xe) : xe, v[e]);
            }
          }
        }
      }
      if constexpr (kBf16Math) {
        uint4 hi, unused;
        sm90::split8<false>(v, hi, unused);
        *reinterpret_cast<uint4*>(a + sm90::swz(row, j)) = hi;
      } else {
        uint4 parts[PARTS];
        sm90::split8x3(v, parts[0], parts[1], parts[2]);
#pragma unroll
        for (int p = 0; p < PARTS; ++p)
          *reinterpret_cast<uint4*>(a + p * A_BYTES + sm90::swz(row, j)) = parts[p];
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();  // stage s's A tile is complete, stage s - 1's products done
    // W of stage s + 1 into the other buffer, whose last reader, stage s - 1's
    // products, finished before the barrier
    if (tid == 0 && s + 1 < n_stages) copy_w(s + 1);
    // ---- products on wgmma; warpgroup wg < 2 takes rows 64 wg .. 64 wg +
    // 63, while warpgroups 2 and 3 (BN = 64) go on to sample the next stage
    // into the other buffer.  Each stage's passes go into a fresh accumulator
    // `part`, added into the f32 sum `acc` with round-to-nearest adds: the
    // tensor cores truncate as they add, and over the whole 9 C depth in one
    // accumulator that bias grows with it.  The products complete within the
    // stage: no accumulator is in flight while the sampling code runs ----
    if (wg < 2) {
      sm90::mbar_wait(&full[buf], (s >> 1) & 1);
      const uint32_t a0 = sm90::smem_u32(a) + wg * (A_BYTES / 2);
      const uint32_t b0 = sm90::smem_u32(a) + PARTS * A_BYTES;
      // part p of A or B at kk's 16 columns
      auto da = [&](int p, int kk) { return sm90::desc(a0 + p * A_BYTES + 32 * kk, 16, 1024); };
      auto db = [&](int p, int kk) { return sm90::desc(b0 + p * S::kB + 32 * kk, 16, 1024); };
      float part[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        sm90::wgmma<BN, 0, 0>(part, da(0, kk), db(0, kk));
        if constexpr (!kBf16Math) {
          // every product of parts whose orders sum to at most 2
          sm90::wgmma<BN, 0, 0>(part, da(0, kk), db(1, kk));
          sm90::wgmma<BN, 0, 0>(part, da(1, kk), db(0, kk));
          sm90::wgmma<BN, 0, 0>(part, da(0, kk), db(2, kk));
          sm90::wgmma<BN, 0, 0>(part, da(2, kk), db(0, kk));
          sm90::wgmma<BN, 0, 0>(part, da(1, kk), db(1, kk));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc<BN / 2>(part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
  }
  if (wg >= 2) return;  // the sampling-only warpgroups hold no sums

  // accumulator fragment of m64nBN: register 4j + r holds row
  // 16 warp + lane/4 + 8 (r/2), column 8j + 2 (lane%4) + r%2
  const bool pair = (Co % 2 == 0);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = nt * BN + 8 * j + 2 * (lane & 3);
    if (co >= Co) continue;
    const bool two = co + 1 < Co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int opix = p0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
      if (opix >= npix) continue;
      float v0 = acc[4 * j + 2 * h];
      float v1 = acc[4 * j + 2 * h + 1];
      // the epilogue in the order of the TPU kernel: f32 accumulator, then
      // scale, shift and ReLU before the one write
      if (scale) {
        v0 = fmaxf(v0 * scale[co] + shift[co], 0.f);
        if (two) v1 = fmaxf(v1 * scale[co + 1] + shift[co + 1], 0.f);
      } else if (bias) {
        v0 += bias[co];
        if (two) v1 += bias[co + 1];
      }
      float* dst = out + static_cast<long long>(opix) * Co + co;
      if (pair && two) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (two) dst[1] = v1;
      }
    }
  }
}

// W (9, C, Co) f32 -> w_img (9, n_cc, n_nt, 3, BN, 64) bf16: per (tap, channel
// chunk, output-channel tile) the hi, mid and lo tiles, rows of output channels
// with 64 channels each, zero-padded and swizzled (ops/dcn_cuda.py::
// fwd_weight_image is its plain version).  One thread per 16-byte group.
__global__ void fwd_weight_image_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ img,
                                        int C, int Co, int bn, int bf16_math) {
  const int n_cc = (C + BK - 1) / BK;
  const int n_nt = (Co + bn - 1) / bn;
  const int total = 9 * n_cc * n_nt * bn * 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int grp = t & 7;
  const int n = (t >> 3) % bn;
  const int tile = (t >> 3) / bn;  // (k, cc, nt)
  const int nt = tile % n_nt;
  const int cc = (tile / n_nt) % n_cc;
  const int k = tile / (n_nt * n_cc);
  const int co = nt * bn + n;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = cc * BK + 8 * grp + e;
    v[e] = (c < C && co < Co) ? w[(static_cast<long long>(k) * C + c) * Co + co] : 0.f;
  }
  uint4 parts[PARTS];
  sm90::split8x3(v, parts[0], parts[1], parts[2]);
  uint8_t* base =
      reinterpret_cast<uint8_t*>(img) + static_cast<long long>(tile) * PARTS * bn * kRowBytes;
#pragma unroll
  for (int p = 0; p < PARTS; ++p)
    *reinterpret_cast<uint4*>(base + p * bn * kRowBytes + sm90::swz(n, grp)) =
        (bf16_math && p > 0) ? make_uint4(0u, 0u, 0u, 0u) : parts[p];
}

template <typename T, bool kRoundX, bool kBf16Math, int BN>
int launch(const void* x, const float* off, const float* m, const __nv_bfloat16* w_img,
           const float* b, const float* sc, const float* sh, float* y, int B, int H, int W,
           int C, int Co, float R, cudaStream_t s) {
  auto kernel = dcn_fwd_kernel<T, kRoundX, kBf16Math, BN>;
  const int bytes = Smem<BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int npix = B * H * W;
  const dim3 grid((npix + BM - 1) / BM, (Co + BN - 1) / BN);
  kernel<<<grid, Smem<BN>::kThreads, bytes, s>>>(static_cast<const T*>(x), off, m, w_img, b, sc, sh, y, B,
                                      H, W, C, Co, R);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int dispatch(const void* x, int x_is_bf16, int round_x, int bf16_math, const float* off,
             const float* m, const __nv_bfloat16* w_img, const float* b, const float* sc,
             const float* sh, float* y, int B, int H, int W, int C, int Co, float R,
             cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (bf16_math) {
    if (!x_is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch<bf16, false, true, BN>(x, off, m, w_img, b, sc, sh, y, B, H, W, C, Co, R, s);
  }
  if (x_is_bf16)
    return launch<bf16, false, false, BN>(x, off, m, w_img, b, sc, sh, y, B, H, W, C, Co, R, s);
  if (round_x)
    return launch<float, true, false, BN>(x, off, m, w_img, b, sc, sh, y, B, H, W, C, Co, R, s);
  return launch<float, false, false, BN>(x, off, m, w_img, b, sc, sh, y, B, H, W, C, Co, R, s);
}

}  // namespace

// Lays out W (9, C, Co) f32 into w_img (scratch of 9 * ceil(C/64) *
// ceil(Co/bn) * parts * bn * 64 bf16, ops/dcn_cuda.py::fwd_image_numel,
// where parts must be this build's PARTS), then
// launches the forward, both on `stream`; returns the CUDA error (0 on
// success).  The caller checks shapes, dtypes, devices and contiguity and
// that every index fits in 32 bits; bn is 64 or 128.  scale and shift are both
// given (the epilogue) or both null.  bf16_math needs x in bf16; round_x (f32
// x rounded to bf16 as it is loaded) needs f32 x.
extern "C" int dcn_fwd(const void* x, int x_is_bf16, int round_x, int bf16_math,
                       const void* offset, const void* mask, const void* weight, void* w_img,
                       int parts, int bn, const void* bias, const void* scale, const void* shift,
                       void* out, int B, int H, int W, int C, int Co, float max_offset,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offset);
  const float* m = static_cast<const float*>(mask);
  auto* wi = static_cast<__nv_bfloat16*>(w_img);
  const float* b = static_cast<const float*>(bias);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* y = static_cast<float*>(out);
  if ((round_x && x_is_bf16) || (bn != 64 && bn != 128) || parts != PARTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = 9 * ((C + BK - 1) / BK) * ((Co + bn - 1) / bn) * bn * 8;
  fwd_weight_image_kernel<<<(groups + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(weight), wi, C, Co, bn, bf16_math);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (bn == 64)
    return dispatch<64>(x, x_is_bf16, round_x, bf16_math, off, m, wi, b, sc, sh, y, B, H, W, C,
                        Co, max_offset, s);
  return dispatch<128>(x, x_is_bf16, round_x, bf16_math, off, m, wi, b, sc, sh, y, B, H, W, C,
                       Co, max_offset, s);
}
