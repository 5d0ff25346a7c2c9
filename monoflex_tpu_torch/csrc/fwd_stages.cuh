// dcn_fwd's staging, shared by csrc/dcn_fwd.cu and the ablations with its
// products (csrc/dcn_ablate.cu: matmul, nomap, nobcast), so that each
// ablation runs the forward's own pipeline with only its A-tile producer
// changed:
//  - fwd_weight_image_kernel: W laid out for wgmma in three bf16 parts, by a
//    small kernel that runs before every kernel that multiplies by it;
//  - run_stages: the stage loop.  A block owns 128 output rows (pixels) x BN
//    output channels; per stage every thread calls the producer, which
//    writes the stage's A tile (128 rows x up to 64 channels, three bf16
//    parts, swizzled) into one of two buffers; one barrier; thread 0 starts
//    the bulk copy of the next stage's W chunk into the other buffer; then
//    warpgroups 0 and 1 issue their 64 rows' six passes (one under bf16
//    math) on wgmma into a fresh accumulator, wait for them and add it into
//    the f32 sums, while at BN = 64 warpgroups 2 and 3 go on to the next
//    stage's producer;
//  - store_rows: the accumulators' one f32 store, with dcn_fwd's epilogue.

#pragma once

#include "sm90_mma.cuh"

namespace {

constexpr int kImageChunk = 64;  // input channels a tile row holds (one swizzled row)
constexpr int kImageParts = 3;   // bf16 parts (hi, mid, lo)

// W (9, C, Co) f32 -> w_img (9, n_cc, n_nt, 3, BN, 64) bf16: per (tap, channel
// chunk, output-channel tile) the hi, mid and lo tiles, rows of output channels
// with 64 channels each, zero-padded and swizzled (ops/dcn_cuda.py::
// fwd_weight_image is its plain version).  One thread per 16-byte group.
__global__ void fwd_weight_image_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ img,
                                        int C, int Co, int bn, int bf16_math) {
  const int n_cc = (C + kImageChunk - 1) / kImageChunk;
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
    const int c = cc * kImageChunk + 8 * grp + e;
    v[e] = (c < C && co < Co) ? w[(static_cast<long long>(k) * C + c) * Co + co] : 0.f;
  }
  uint4 parts[kImageParts];
  sm90::split8x3(v, parts[0], parts[1], parts[2]);
  uint8_t* base = reinterpret_cast<uint8_t*>(img) +
                  static_cast<long long>(tile) * kImageParts * bn * sm90::kRowBytes;
#pragma unroll
  for (int p = 0; p < kImageParts; ++p)
    *reinterpret_cast<uint4*>(base + p * bn * sm90::kRowBytes + sm90::swz(n, grp)) =
        (bf16_math && p > 0) ? make_uint4(0u, 0u, 0u, 0u) : parts[p];
}

// ------------------------------------------------------------ stages ----

constexpr int kStageRows = 128;                           // A's rows: two m64 warpgroups
constexpr int kStageA = kStageRows * sm90::kRowBytes;     // one part of A

template <int BN>
struct FwdStages {
  // all warpgroups produce, the first two also issue wgmma: four at BN =
  // 64, two at BN = 128 (whose accumulators need the registers)
  static constexpr int kThreads = BN == 64 ? 512 : 256;
  static constexpr int kB = BN * sm90::kRowBytes;                          // one part of B
  static constexpr int kStage = kImageParts * kStageA + kImageParts * kB;  // A parts, B parts
  static constexpr int kBytes = 2 * kStage;  // two stages; the caller's shared memory follows
};

// A stage's W: the chunk of w_img ((tap * n_cc + channel chunk) * n_nt +
// output-channel tile) and the first of the stage's kSteps 16-channel
// k-steps inside it (a stage may take part of a chunk's 64 channels)
struct StageW {
  long long chunk;
  int kk0;
};

// Runs n_stages stages into acc (zeroed here) of the warpgroups wg < 2, each
// holding 64 rows x BN columns as wgmma's m64nBN fragment.  smem: the two
// stages (FwdStages<BN>::kBytes, 1024-aligned); full: two mbarriers.
// w_of(s) gives stage s's StageW; produce(s, a) is called by every thread
// and writes stage s's A tile at a (part p at a + p * kStageA, row r,
// 16-byte group j at sm90::swz(r, j)); it may use __syncthreads, as every
// thread calls it for every stage.  Its buffer's last reader, stage s - 2's
// products, finished before stage s - 1's barrier.  kParts is 1 under bf16
// math (the lower parts are zero).  Caller's shared memory written before
// the call is visible to every producer.
template <int BN, int kParts, int kSteps, typename WOf, typename Produce>
__device__ __forceinline__ void run_stages(uint8_t* smem, uint64_t* full,
                                           const __nv_bfloat16* __restrict__ w_img, int n_stages,
                                           WOf w_of, Produce produce, float (&acc)[BN / 2]) {
  using S = FwdStages<BN>;
  constexpr int BK = kImageChunk;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t w_bytes = kParts * S::kB;
  auto copy_w = [&](int s) {
    const int buf = s & 1;
    uint8_t* b = smem + buf * S::kStage + kImageParts * kStageA;
    sm90::mbar_arrive_expect_tx(&full[buf], w_bytes);
    sm90::bulk_copy(b, w_img + w_of(s).chunk * kImageParts * BN * BK, w_bytes, &full[buf]);
  };
  if (tid == 0) {
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) copy_w(0);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    uint8_t* a = smem + buf * S::kStage;  // A's parts, kStageA apart
    produce(s, a);
    sm90::fence_proxy_async();
    __syncthreads();  // stage s's A tile is complete, stage s - 1's products done
    // W of stage s + 1 into the other buffer, whose last reader, stage s - 1's
    // products, finished before the barrier
    if (tid == 0 && s + 1 < n_stages) copy_w(s + 1);
    // ---- products on wgmma; warpgroup wg < 2 takes rows 64 wg .. 64 wg +
    // 63, while warpgroups 2 and 3 (BN = 64) go on to produce the next stage
    // into the other buffer.  Each stage's passes go into a fresh accumulator
    // `part`, added into the f32 sum `acc` with round-to-nearest adds: the
    // tensor cores truncate as they add, and over the whole 9 C depth in one
    // accumulator that bias grows with it.  The products complete within the
    // stage: no accumulator is in flight while the producer runs ----
    if (wg < 2) {
      sm90::mbar_wait(&full[buf], (s >> 1) & 1);
      const int kk0 = w_of(s).kk0;
      const uint32_t a0 = sm90::smem_u32(a) + wg * (kStageA / 2);
      const uint32_t b0 = sm90::smem_u32(a) + kImageParts * kStageA;
      // part p of A or B at kk's 16 columns
      auto da = [&](int p, int kk) { return sm90::desc(a0 + p * kStageA + 32 * kk, 16, 1024); };
      auto db = [&](int p, int kk) { return sm90::desc(b0 + p * S::kB + 32 * kk, 16, 1024); };
      float part[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const int kk = kk0 + i;
        sm90::wgmma<BN, 0, 0>(part, da(0, kk), db(0, kk));
        if constexpr (kParts > 1) {
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
}

// The f32 store of warpgroup wg < 2's accumulators (run_stages) for output
// channels nt * BN .. of Co.  out_row(r) gives the element of out where A's
// row r's outputs start, or -1 where the row has no output pixel.  The
// epilogue in the order of the TPU kernel: the f32 accumulator, then either
// scale, shift and ReLU or the bias, before the one write; all three may be
// null.
template <int BN, typename OutRow>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2], OutRow out_row,
                                           float* __restrict__ out, int Co, int nt,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
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
      const long long base = out_row(64 * wg + 16 * warp + (lane >> 2) + 8 * h);
      if (base < 0) continue;
      float v0 = acc[4 * j + 2 * h];
      float v1 = acc[4 * j + 2 * h + 1];
      if (scale) {
        v0 = fmaxf(v0 * scale[co] + shift[co], 0.f);
        if (two) v1 = fmaxf(v1 * scale[co + 1] + shift[co + 1], 0.f);
      } else if (bias) {
        v0 += bias[co];
        if (two) v1 += bias[co + 1];
      }
      float* dst = out + base + co;
      if (pair && two) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (two) dst[1] = v1;
      }
    }
  }
}

}  // namespace
