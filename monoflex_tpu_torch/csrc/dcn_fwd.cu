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
// Design: a warp-specialised ring (fwd_stages.cuh's run_ring).  A block
// owns 128 output pixels x BN output channels (BN 64 or 128), or at Co a
// multiple of 256 the wide tile of 64 pixels x 256 channels
// (ops/dcn_cuda.py::fwd_tile_n), and walks the 9 taps x C in stages of 32
// channels through a ring of four stages in shared memory (three at the
// wide tile), with 512 threads in two roles:
//  - producers, warpgroups 2 and 3, four threads a pixel: per stage each
//    thread waits for the stage's slot to be empty, thread 0 starts the bulk
//    copy of the W_k chunk B (BN x 32, three parts) onto the slot's full
//    mbarrier, and every thread forms the f32 samples of its 8-channel group
//    of its pixels and writes their three bf16 parts into the swizzled A tile
//    (pixels x 32 channels, the 64-byte mode wgmma reads, sm90_mma.cuh),
//    then arrives on the full barrier.  A tap's 4 corner offsets and weights
//    (bilinear weight x mask) come from the block's offsets and masks, staged
//    once in shared memory, at the tap's first stage; the corner runs (x is
//    NHWC, a run is contiguous: 16-byte vectors) of stage s + 1 are loaded
//    before stage s is split and stored, so the gathers' latency overlaps
//    the split;
//  - consumers, warpgroups 0 and 1 (64 rows each, or at the wide tile the
//    same 64 rows at 128 channels each): per stage they wait for the full
//    barrier, issue the six products of parts on wgmma (m64 x BN or 128 x
//    k16) into a fresh accumulator, wait for them, free the slot on its
//    empty barrier and add the accumulator into the f32 sums;
//  - no block-wide barrier after the start: the producers run up to four
//    stages ahead, so sampling, the W copies and the products of different
//    stages overlap;
//  - the epilogue (bias, or scale, shift and ReLU) acts on the f32 sums
//    before the one f32 store.
// A small kernel launched first (fwd_weight_image_kernel) splits W and lays
// it out as B.  The ablations with dcn_fwd's products (dcn_ablate.cu) run the
// same ring with other A-tile producers; this file holds the sampling
// producer.  One block an SM (158 KB at BN = 64, 206 KB at 128, 187 KB wide).
// It replaces a lock-step loop: two buffers of 64 channels, every thread
// sampling, one block barrier a stage, then warpgroups 0 and 1 multiplying
// and waiting (at BN = 128 nothing sampled meanwhile).  An older attempt
// with one sampling warpgroup feeding two wgmma warpgroups ran at 10.9 ms a
// forward: four warps could not keep enough gathers in flight.  Tried on
// the card and dropped (PERF.md): the two producer warpgroups on alternate
// stages (slower); 384 threads, one producer
// warpgroup (slower: sampling); 768 at BN = 64 (batch 8 faster, batch 1
// slower); two fresh accumulators in turn, stage s + 1 issued before stage
// s is waited for (ptxas serialises the wgmmas, C7515, and spills).
// ptxas gives every thread 128 registers whatever setmaxnreg moves, and the
// consumers at 128 columns (sums and a fresh accumulator: 128 floats) spill
// about 100 bytes; without the move they spill more.
// The im2col tile never reaches device memory, as on the TPU it stays in VMEM.
//
// Precision.  Each operand is split into three bf16 parts (hi, mid, lo: the
// 24 bits of an f32) and the six products whose parts' orders sum to at most
// 2 are taken, so what is dropped is below about 2^-25 of each product.  The
// tensor cores truncate as they add, so each stage's products (32 channels
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
// post-sigmoid, w_img (9, ceil(C/32), Co_pad/BN, 3, BN, 32) bf16 (W_k's
// 32-channel chunks transposed to rows of output channels, three parts,
// swizzled; ops/dcn_cuda.py::fwd_weight_image), bias (Co) f32 or null, scale
// and shift (Co) f32 or both null, out (B,H,W,Co) f32.  All contiguous.
//
// What bounds it.  The neck's 16 layers at batch 8 are 213 GFLOP of products
// per forward: at six bf16 passes on the tensor cores (989 TFLOP/s dense)
// 1.29 ms (three passes would be 0.646), beside 0.154 ms of f32 sampling (8
// operations per sample at 67 TFLOP/s) and 0.286 ms of bytes (bf16 x);
// FCOS3D's 36 calls (batch 6) 1505 GFLOP, 9.13 ms at six passes.  What holds
// it back after this design (card times in PERF.md section 6, row 1): a
// stage of the wide tile moves 204 KB through shared memory (the wgmmas'
// reads of A and B, the A tile, W's copy), 1632 cycles at 128 bytes a cycle
// against its 1536 tensor cycles, so shared memory, not the tensor cores,
// is the ceiling (the narrow 128 tile: 192 KB, 1536 cycles); each stage's
// products are waited for before the next is issued; the wide tile's 544
// blocks at FCOS3D's main shape fill 4.1 waves of 132 SMs.
// At Co = 64 the pipeline with a trivial producer (dcn_ablate's matmul) is
// as slow as dcn_fwd: 18 stages a block leave its start and drain, and the
// producers' loop, exposed.  W's split and layout cost one small kernel per
// call.

#include "fwd_stages.cuh"
#include "sm90_mma.cuh"

namespace {

constexpr int PARTS = 3;  // bf16 parts of each f32 operand (hi, mid, lo)
static_assert(PARTS == kImageParts, "W's layout (fwd_stages.cuh)");

// the ring (fwd_stages.cuh), the block's offsets and masks, 1024 bytes of
// alignment
template <int BN>
constexpr int kSmemBytes = FwdRing<BN>::kBytes + FwdTile<BN>::kRows * 27 * 4 + 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// a corner's run of 8 channels as loaded: 16 bytes of bf16 or 32 of f32
template <typename T>
struct Run;
template <>
struct Run<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* __restrict__ x, long long e) {
    a = __ldg(reinterpret_cast<const float4*>(x + e));
    b = __ldg(reinterpret_cast<const float4*>(x + e) + 1);
  }
  __device__ __forceinline__ void floats(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};
template <>
struct Run<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ x, long long e) {
    a = __ldg(reinterpret_cast<const uint4*>(x + e));
  }
  __device__ __forceinline__ void floats(float* v) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <typename T, bool kRoundX, bool kBf16Math, int BN>
__global__ void __launch_bounds__(kRingThreads, 1)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const __nv_bfloat16* __restrict__ w_img,
               const float* __restrict__ bias, const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ out, int B, int H, int W,
               int C, int Co, float R) {
  constexpr int BM = FwdTile<BN>::kRows;
  constexpr int kParts = kBf16Math ? 1 : PARTS;  // bf16 math: the operands are bf16
  constexpr int kA = FwdTile<BN>::kA;
  // 4 producer threads a pixel, one 8-channel group of the stage's 32 each
  constexpr int kRowsPerPass = kProducers / 4;
  constexpr int kPasses = BM / kRowsPerPass;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* s_off = reinterpret_cast<float*>(smem + FwdRing<BN>::kBytes);
  float* s_mask = s_off + BM * 18;

  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * BM;
  const int nt = blockIdx.y;
  const int n_cc = (C + kImageChunk - 1) / kImageChunk;  // 32-channel stages a tap
  const int n_nt = gridDim.y;
  const bool vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  // the block's offsets and masks, read once, coalesced (seen by the
  // producers after the ring's first barrier)
  const int nrows = min(BM, npix - p0);
  for (int e = tid; e < nrows * 18; e += kRingThreads)
    s_off[e] = offset[static_cast<long long>(p0) * 18 + e];
  for (int e = tid; e < nrows * 9; e += kRingThreads)
    s_mask[e] = mask[static_cast<long long>(p0) * 9 + e];

  // a producer thread's rows' 4 corners (element offsets) and weights
  // (bilinear weight x mask) at a tap, and its corner runs of the next stage
  // in its first kAhead rows, loaded while the current stage is split and
  // stored (one row of f32 x at the narrow tiles, where two would spill)
  constexpr int kAhead = sizeof(T) == 4 && FwdTile<BN>::kN == 128 ? 1 : kPasses;
  int idx[kPasses][4];
  float wt[kPasses][4];
  Run<T> runs[kAhead][4];
  auto set_tap = [&](int k, int ptid) {
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int row = (ptid >> 2) + kRowsPerPass * pass;
      const int pix = p0 + row;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        idx[pass][q] = 0;
        wt[pass][q] = 0.f;
      }
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
            idx[pass][q] = ((pb * H + yy) * W + xx) * C;
            const float v = (dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) * m;
            wt[pass][q] = kBf16Math ? sm90::bf16_round(v) : v;
          }
        }
      }
    }
  };
  // stage s: tap s / n_cc, 32-channel chunk s % n_cc; its channels of the
  // thread's 8-channel group start at chan(s, ptid)
  auto chan = [&](int s, int ptid) { return (s % n_cc) * kImageChunk + 8 * (ptid & 3); };
  auto load_runs = [&](int s, int ptid) {  // the vector path's loads
    const int c = chan(s, ptid);
    if (!vec || c + 8 > C) return;
#pragma unroll
    for (int pass = 0; pass < kAhead; ++pass)
#pragma unroll
      for (int q = 0; q < 4; ++q) runs[pass][q].load(x, static_cast<long long>(idx[pass][q]) + c);
  };

  auto w_of = [&](int s) { return StageW{static_cast<long long>(s) * n_nt + nt, 0}; };
  auto produce = [&](int s, uint8_t* a, int ptid) {
    const int j = ptid & 3;
    const int c = chan(s, ptid);
    if (s == 0) {
      set_tap(0, ptid);
      load_runs(0, ptid);
    }
    float v[kPasses][8];
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[pass][e] = 0.f;
      if (vec && c + 8 <= C) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float xv[8];
          if (pass < kAhead) {
            runs[pass][q].floats(xv);
          } else {
            Run<T> run;
            run.load(x, static_cast<long long>(idx[pass][q]) + c);
            run.floats(xv);
          }
          if constexpr (kRoundX) {
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              // two values rounded in one conversion
              const float2 r = __bfloat1622float2(__floats2bfloat162_rn(xv[e], xv[e + 1]));
              xv[e] = r.x;
              xv[e + 1] = r.y;
            }
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) v[pass][e] = fmaf(wt[pass][q], xv[e], v[pass][e]);
        }
      } else if (c < C) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (c + e < C) {
              const float xe = to_f32(x[static_cast<long long>(idx[pass][q]) + c + e]);
              v[pass][e] = fmaf(wt[pass][q], kRoundX ? sm90::bf16_round(xe) : xe, v[pass][e]);
            }
          }
        }
      }
    }
    // the next stage's corner runs, in flight while this one is split and
    // stored (its tap's corners first, at a tap's first stage)
    if (s + 1 < 9 * n_cc) {
      if ((s + 1) % n_cc == 0) set_tap((s + 1) / n_cc, ptid);
      load_runs(s + 1, ptid);
    }
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int row = (ptid >> 2) + kRowsPerPass * pass;
      if constexpr (kBf16Math) {
        uint4 hi, unused;
        sm90::split8<false>(v[pass], hi, unused);
        *reinterpret_cast<uint4*>(a + sm90::swz64(row, j)) = hi;
      } else {
        uint4 parts[PARTS];
        sm90::split8x3(v[pass], parts[0], parts[1], parts[2]);
#pragma unroll
        for (int p = 0; p < PARTS; ++p)
          *reinterpret_cast<uint4*>(a + p * kA + sm90::swz64(row, j)) = parts[p];
      }
    }
  };
  auto finish = [&](const float (&acc)[FwdTile<BN>::kN / 2]) {
    auto out_row = [&](int r) {
      return p0 + r < npix ? static_cast<long long>(p0 + r) * Co : -1ll;
    };
    store_tile<BN>(acc, out_row, out, Co, nt * BN, bias, scale, shift);
  };
  run_ring<BN, kParts, kImageChunk / 16>(smem, w_img, 9 * n_cc, w_of, produce, finish);
}

template <typename T, bool kRoundX, bool kBf16Math, int BN>
int launch(const void* x, const float* off, const float* m, const __nv_bfloat16* w_img,
           const float* b, const float* sc, const float* sh, float* y, int B, int H, int W,
           int C, int Co, float R, cudaStream_t s) {
  auto kernel = dcn_fwd_kernel<T, kRoundX, kBf16Math, BN>;
  const int bytes = kSmemBytes<BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int npix = B * H * W;
  constexpr int BM = FwdTile<BN>::kRows;
  const dim3 grid((npix + BM - 1) / BM, (Co + BN - 1) / BN);
  kernel<<<grid, kRingThreads, bytes, s>>>(static_cast<const T*>(x), off, m, w_img, b, sc, sh, y,
                                           B, H, W, C, Co, R);
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

// Lays out W (9, C, Co) f32 into w_img (scratch of 9 * ceil(C/32) *
// ceil(Co/bn) * parts * bn * 32 bf16, ops/dcn_cuda.py::fwd_image_numel,
// where parts must be this build's PARTS), then
// launches the forward, both on `stream`; returns the CUDA error (0 on
// success).  The caller checks shapes, dtypes, devices and contiguity and
// that every index fits in 32 bits; bn is 64, 128 or 256 (the wide tile,
// ops/dcn_cuda.py::fwd_tile_n).  scale and shift are both
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
  if ((round_x && x_is_bf16) || (bn != 64 && bn != 128 && bn != 256) || parts != PARTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = 9 * ((C + kImageChunk - 1) / kImageChunk) * ((Co + bn - 1) / bn) * bn * 4;
  fwd_weight_image_kernel<<<(groups + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(weight), wi, C, Co, bn, bf16_math);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (bn == 64)
    return dispatch<64>(x, x_is_bf16, round_x, bf16_math, off, m, wi, b, sc, sh, y, B, H, W, C,
                        Co, max_offset, s);
  if (bn == 128)
    return dispatch<128>(x, x_is_bf16, round_x, bf16_math, off, m, wi, b, sc, sh, y, B, H, W, C,
                         Co, max_offset, s);
  return dispatch<256>(x, x_is_bf16, round_x, bf16_math, off, m, wi, b, sc, sh, y, B, H, W, C,
                       Co, max_offset, s);
}
