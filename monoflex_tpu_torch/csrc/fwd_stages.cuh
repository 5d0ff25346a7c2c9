// dcn_fwd's pipeline, shared by csrc/dcn_fwd.cu and the ablations with its
// products (csrc/dcn_ablate.cu: matmul, nomap, nobcast), so that each
// ablation runs the forward's own pipeline with only its A-tile producer
// changed:
//  - fwd_weight_image_kernel: W laid out for wgmma in three bf16 parts, by a
//    small kernel that runs before every kernel that multiplies by it;
//  - run_ring: a warp-specialised ring of stages in shared memory.
//    A block owns kRows output rows (pixels) x BN output channels and 512
//    threads.  Warpgroups 2 and 3 produce: per stage they wait for its slot
//    to be empty, one thread starts the bulk copy of the stage's W chunk onto
//    the slot's full barrier, and every producer thread writes its share of
//    the stage's A tile (kRows rows x 32 channels, three bf16 parts, 64-byte
//    swizzle) and arrives on the same barrier.  Warpgroups 0 and 1 consume:
//    they wait for the full barrier, issue the stage's six passes (one under
//    bf16 math) on wgmma into a fresh accumulator, wait for them, free the
//    slot on its empty barrier and add the accumulator into the f32 sums.
//    No block-wide barrier after the start: the producers run up to kSlots
//    stages ahead, so sampling, the W copies and the products of different
//    stages overlap;
//  - store_rows: the accumulators' one f32 store, with dcn_fwd's epilogue.

#pragma once

#include "sm90_mma.cuh"

namespace {

constexpr int kImageChunk = 32;  // input channels of a stage (one 64-byte swizzled row)
constexpr int kImageParts = 3;   // bf16 parts (hi, mid, lo)
constexpr int kChunkBytes = 64;  // bytes of a stage's row (kImageChunk bf16)

// W (9, C, Co) f32 -> w_img (9, n_cc, n_nt, 3, BN, 32) bf16 with n_cc =
// ceil(C/32): per (tap, 32-channel chunk, output-channel tile) the hi, mid
// and lo tiles, rows of output channels with 32 channels each, zero-padded
// and swizzled in the 64-byte mode (ops/dcn_cuda.py::fwd_weight_image is its
// plain version).  One thread per 16-byte group.
__global__ void fwd_weight_image_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ img,
                                        int C, int Co, int bn, int bf16_math) {
  const int n_cc = (C + kImageChunk - 1) / kImageChunk;
  const int n_nt = (Co + bn - 1) / bn;
  const int total = 9 * n_cc * n_nt * bn * 4;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int grp = t & 3;
  const int n = (t >> 2) % bn;
  const int tile = (t >> 2) / bn;  // (k, cc, nt)
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
                  static_cast<long long>(tile) * kImageParts * bn * kChunkBytes;
#pragma unroll
  for (int p = 0; p < kImageParts; ++p)
    *reinterpret_cast<uint4*>(base + p * bn * kChunkBytes + sm90::swz64(n, grp)) =
        (bf16_math && p > 0) ? make_uint4(0u, 0u, 0u, 0u) : parts[p];
}

// ------------------------------------------------------------- the ring ----

constexpr int kRingThreads = 512;
constexpr int kConsumers = 256;                        // warpgroups 0 and 1: wgmma
constexpr int kProducers = kRingThreads - kConsumers;  // warpgroups 2 and 3: A tiles
constexpr int kLaunchRegs = 65536 / kRingThreads;      // a thread's registers (128)
constexpr int kProducerBarrier = 1;                    // the producers' named barrier

// A block's shape at BN output channels: 128 rows, each consumer warpgroup
// on 64 of them at the full BN (64 or 128); or, at BN = 256 (the wide tile),
// 64 rows, each consumer warpgroup on all of them at 128 of the channels, so
// that a sampled A tile feeds 256 output channels.  Registers: a consumer
// holds its f32 sums and one fresh accumulator (2 x kN / 2 a thread); where
// kN = 128 setmaxnreg moves 32 a thread from the producers to the consumers
// (of the 128 that 512 threads an SM leave each)
template <int BN>
struct FwdTile {
  static constexpr bool kWide = BN == 256;
  static constexpr int kRows = kWide ? 64 : 128;  // A's rows
  static constexpr int kN = kWide ? 128 : BN;     // a consumer warpgroup's columns
  static constexpr int kMoveRegs = kN == 128 ? 32 : 0;
  static constexpr int kA = kRows * kChunkBytes;  // one part of A
  static constexpr int kB = BN * kChunkBytes;     // one part of W's chunk
  static constexpr int kStage = kImageParts * (kA + kB);
};

// dcn_fwd's ring depth at each tile width: four stages (144 KB at BN = 64,
// 192 KB at 128), three at the wide tile (180 KB)
template <int BN>
constexpr int kFwdSlots = BN == 256 ? 3 : 4;

template <int BN>
struct FwdRing {
  static constexpr int kSlots = kFwdSlots<BN>;
  static constexpr int kBar = kSlots * FwdTile<BN>::kStage;  // full[kSlots], empty[kSlots]
  static constexpr int kBytes = kBar + 128;  // the caller's shared memory follows, 128-aligned
  static_assert(2 * kSlots * 8 <= 128, "the ring's barriers");
};

// A stage's W: the chunk of w_img ((tap * n_cc + 32-channel chunk) * n_nt +
// output-channel tile) and the first of the stage's k-steps in it
struct StageW {
  long long chunk;
  int kk0;
};

// Runs n_stages stages through the ring at smem (FwdRing<BN>::kBytes,
// 1024-aligned).  w_of(s) gives stage s's StageW.  Every producer calls
// produce(s, a, ptid) for every stage in order, ptid its index 0 ..
// kProducers - 1: it writes stage s's A tile at a (part p at a + p *
// FwdTile<BN>::kA, row r, 16-byte group j at sm90::swz64(r, j)) and may use
// sm90::named_sync<kProducerBarrier, kProducers>(); the slot's last readers,
// the products kSlots stages back, are done when it is called.  Consumers
// take kSteps 16-channel k-steps a stage, from column 16 kk0 of A and of W's
// chunk, each stage's kParts-part passes (kParts 1 under bf16 math: the
// lower parts are zero) into a fresh accumulator that is added into the f32
// sums acc, and then call finish(acc), acc being kN / 2 floats of wgmma's
// m64nkN fragment of their rows (FwdTile).  Shared memory the caller writes
// before the call is visible to the producers.
template <int BN, int kParts, int kSteps, typename WOf, typename Produce, typename Finish>
__device__ __forceinline__ void run_ring(uint8_t* smem, const __nv_bfloat16* __restrict__ w_img,
                                         int n_stages, WOf w_of, Produce produce, Finish finish) {
  using T = FwdTile<BN>;
  using Ring = FwdRing<BN>;
  constexpr int kSlots = Ring::kSlots;
  constexpr int kN = T::kN;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Ring::kBar);
  uint64_t* empty = full + kSlots;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      sm90::mbar_init(&full[i], kProducers / 32 + 1);  // the producer warps and W's bytes
      sm90::mbar_init(&empty[i], kConsumers / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  auto slot_of = [&](int s) { return smem + (s % kSlots) * T::kStage; };

  if (tid >= kConsumers) {
    // ---- producers: W's bulk copy and the A tile of every stage ----
    if constexpr (T::kMoveRegs > 0) sm90::setmaxnreg_dec<kLaunchRegs - T::kMoveRegs>();
    const int ptid = tid - kConsumers;
    const uint32_t w_bytes = kParts * T::kB;
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % kSlots;
      // the slot's previous stage, s - kSlots: its products are done
      if (s >= kSlots) sm90::mbar_wait(&empty[slot], (s / kSlots - 1) & 1);
      uint8_t* a = slot_of(s);
      if (ptid == 0) {
        sm90::mbar_arrive_expect_tx(&full[slot], w_bytes);
        sm90::bulk_copy(a + kImageParts * T::kA,
                        w_img + w_of(s).chunk * kImageParts * BN * kImageChunk, w_bytes,
                        &full[slot]);
      }
      produce(s, a, ptid);
      sm90::fence_proxy_async();  // the A tile, to wgmma
      __syncwarp();
      if ((ptid & 31) == 0) sm90::mbar_arrive(&full[slot]);
    }
  } else {
    // ---- consumers: warpgroup wg's products (rows 64 wg .. at BN <= 128;
    // columns 128 wg .. at the wide tile).  Each stage's passes go into a
    // fresh accumulator `part`, added into the f32 sum `acc` with
    // round-to-nearest adds: the tensor cores truncate as they add, and over
    // the whole 9 C depth in one accumulator that bias grows with it ----
    if constexpr (T::kMoveRegs > 0) sm90::setmaxnreg_inc<kLaunchRegs + T::kMoveRegs>();
    const int wg = tid >> 7;
    const uint32_t a_off = T::kWide ? 0 : wg * (T::kA / 2);
    const uint32_t b_off = T::kWide ? wg * (T::kB / 2) : 0;
    float acc[kN / 2];
    float part[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < n_stages; ++s) {
      sm90::mbar_wait(&full[s % kSlots], (s / kSlots) & 1);
      const int kk0 = w_of(s).kk0;
      const uint32_t a0 = sm90::smem_u32(slot_of(s)) + a_off;
      const uint32_t b0 = sm90::smem_u32(slot_of(s)) + kImageParts * T::kA + b_off;
      // part p of A or B at kk's 16 columns
      auto da = [&](int p, int kk) { return sm90::desc64(a0 + p * T::kA + 32 * kk); };
      auto db = [&](int p, int kk) { return sm90::desc64(b0 + p * T::kB + 32 * kk); };
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const int kk = kk0 + i;
        // the stage's first product starts the fresh accumulator (scale-d 0)
        sm90::wgmma<kN, 0, 0>(part, da(0, kk), db(0, kk), i > 0);
        if constexpr (kParts > 1) {
          // every product of parts whose orders sum to at most 2
          sm90::wgmma<kN, 0, 0>(part, da(0, kk), db(1, kk));
          sm90::wgmma<kN, 0, 0>(part, da(1, kk), db(0, kk));
          sm90::wgmma<kN, 0, 0>(part, da(0, kk), db(2, kk));
          sm90::wgmma<kN, 0, 0>(part, da(2, kk), db(0, kk));
          sm90::wgmma<kN, 0, 0>(part, da(1, kk), db(1, kk));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc<kN / 2>(part);
      // the slot is read: free it for the producers
      if ((tid & 31) == 0) sm90::mbar_arrive(&empty[s % kSlots]);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] += part[i];
    }
    finish(acc);
  }
}

// The f32 store of consumer warpgroup wg's sums (run_ring) for output
// channels n0 .. n0 + kN - 1 of Co, its rows starting at A's row r0.
// out_row(r) gives the element of out where A's row r's outputs start, or -1
// where the row has no output pixel.  The epilogue in the order of the TPU
// kernel: the f32 accumulator, then either scale, shift and ReLU or the
// bias, before the one write; all three may be null.
template <int kN, typename OutRow>
__device__ __forceinline__ void store_rows(const float (&acc)[kN / 2], OutRow out_row,
                                           float* __restrict__ out, int Co, int r0, int n0,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift) {
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // accumulator fragment of m64nkN: register 4j + r holds row
  // 16 warp + lane/4 + 8 (r/2), column 8j + 2 (lane%4) + r%2
  const bool pair = (Co % 2 == 0);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int co = n0 + 8 * j + 2 * (lane & 3);
    if (co >= Co) continue;
    const bool two = co + 1 < Co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long base = out_row(r0 + 16 * warp + (lane >> 2) + 8 * h);
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

// store_rows for consumer warpgroup wg of a block whose output channels start
// at n_base: its rows and columns as run_ring gave them (FwdTile<BN>)
template <int BN, typename OutRow>
__device__ __forceinline__ void store_tile(const float (&acc)[FwdTile<BN>::kN / 2], OutRow out_row,
                                           float* __restrict__ out, int Co, int n_base,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift) {
  using T = FwdTile<BN>;
  const int wg = threadIdx.x >> 7;
  store_rows<T::kN>(acc, out_row, out, Co, T::kWide ? 0 : 64 * wg,
                    n_base + (T::kWide ? T::kN * wg : 0), bias, scale, shift);
}

}  // namespace
