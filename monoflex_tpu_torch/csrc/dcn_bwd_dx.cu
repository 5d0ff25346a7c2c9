// Modulated deformable 3x3 convolution (DCNv2), input gradient dx, for sm_90a.
//
//   z_k[q]   = sum_{e,f in [-R',R']} wt_k(p -> q) * g(p),  p = q - (ky + e, kx + f)
//   dx[q, :] = sum_k W_k z_k[q]                      (W_k is (C, Co))
//
// with wt_k(p -> q) the bilinear weight (times the mask m_k(p)) of the corner
// of p's tap-k sample that lands on q, 0 where none does, and R' = ceil(R).
//
// Replaces the TPU kernel monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v5_bwd_dx
// (body _dx5_kernel; dx3 and dx4 compute the same function, and so do the v1/v2
// dx kernels under their routes).  dx5 reassociates the contraction: the hat
// window is summed over g first, then W_k contracts the window sum.  This
// kernel takes that form as a mirrored gather: each output pixel q collects
// the corners of the source pixels whose samples land on it, with the corner
// weights taken at the source, and every sum runs in a fixed order (no
// atomics), so two launches are bit-equal, as on the TPU.
//
// Design.  A block owns an 8 x 16 tile of output pixels (128, two m64 wgmma
// row groups) x BN input channels (BN = 128 where C > 64, else 64), and walks
// the 64-channel chunks of Co and, per chunk, the 9 taps.  The offsets are
// clamped to +-R, so every source pixel the tile needs lies in the tile grown
// by P = R' + 1 on each side (ky adds one):
//  - staged once per block: the halo's offsets and masks (by cp.async), and
//    from them per (halo pixel, tap) the floor of the sample point relative
//    to the tap (two small ints), its fractional parts and the mask, from
//    which any corner weight is a subtract, a compare and two
//    multiplies; a halo pixel off the map gets a code no candidate matches;
//  - staged once per Co chunk: g's halo (f32, zero off the map), by
//    cp.async, serving all 9 taps.  Where 64 channels do not fit beside the
//    rest (R' >= 3), the chunk is taken in two halves of 32 channels, each a
//    stage of two k-steps;
//  - beyond R' = 4 (the clamp of TPU.DCN_MAX_OFFSET_PER_STAGE's first stage
//    is 8) the halo grows as (2R' + 10)(2R' + 18) pixels: g is staged in
//    16-channel slices (a stage of one k-step), the floors of one tap at a
//    time (two buffers: the next stage's are computed from the offsets in
//    device memory while this stage's are read), and the candidate table
//    holds (2R'+1)^2 entries, so the test count grows with it;
//  - the producer, all 16 warps, four output pixels a warp at a time, eight
//    lanes each: the lanes of a pixel test its (2R'+1)^2 candidate sources
//    against the staged floors, 32 at a time (four rounds of eight), a
//    ballot marks the ones whose corner lands on q and each hit leaves its
//    weight in the pixel's list; the pixel's lanes walk the list in
//    candidate order, two sources a step, each lane accumulating its 8
//    channels of z (4 at HC = 32) in f32 from g's halo (16-byte reads, a
//    pixel's 8 lanes one 128-byte row: no bank conflicts); z is split into
//    bf16 hi and lo and written into the swizzled A tile (128 pixels x 64
//    channels) that wgmma reads (sm90_mma.cuh);
//  - the products: after the stage's barrier, warpgroup wg < BN / 32 takes
//    rows 64 (wg % 2) .. + 63 and input channels 64 (wg / 2) .. + 63 on
//    wgmma into a fresh accumulator, waits and adds it into the f32 sum
//    with round-to-nearest adds; at BN = 64 warpgroups 2 and 3 meanwhile
//    sample the next stage into the other of two A buffers, as in
//    dcn_fwd.cu.  W's chunk (W_k^T's block, rows of input channels, laid
//    out by dx_weight_image_kernel, launched first) has one buffer: once
//    every product warpgroup is done with it (a named barrier), thread 0
//    bulk-copies the next stage's chunk onto the mbarrier, which lands while
//    the warps sample.  BN = 128 shares each gathered z between twice the
//    channels; that needs the W buffer the second A stage would not leave.
// Each output element is written once, so dx needs no zeroing.
//
// Precision.  z and W are split into two bf16 parts and a z W is taken as
// z_hi W_hi + z_hi W_lo + z_lo W_hi: three passes, within about 2^-16 of
// each product, the class of dcn_bwd_dwmo.  Each stage (64 channels of one
// tap) goes into a fresh accumulator.  Under bf16 window math (kBf16Math, the
// compute_dtype=bfloat16 mode of monoflex_tpu/ops/dcn_pallas_bwd.py::
// dcn_pallas_bwd_dx and the v2 dx kernels) g, W and each corner weight times
// the mask are rounded to bf16 and the sums are f32; W's lo part is then 0,
// but z, a sum of products, is not bf16-exact, so two passes remain
// (z_hi W + z_lo W).
//
// Layouts: offset (B,H,W,18) interleaved (dy_k, dx_k), mask (B,H,W,9),
// weight (9,C,Co) f32 (read only by the layout kernel), w_img
// (9, ceil(Co/64), ceil(C/BN), 2, BN, 64) bf16 scratch (ops/dcn_cuda.py::
// dx_weight_image), g (B,H,W,Co) f32, dx (B,H,W,C) f32.  All contiguous.
//
// What bounds it.  The products are 2*9*C*Co per pixel, 213 GFLOP per step
// over the neck's 16 layers at batch 8: at three bf16 passes on the tensor
// cores (989 TFLOP/s dense) 0.646 ms, beside about 0.15 ms of f32 sampling.
// What holds it back after this design: the producer, not the products.
// Each (pixel, tap, chunk) costs (2R'+1)^2 candidate tests over 8 lanes and
// about four shared-load + FMA steps, latency-bound at 16 warps an SM (one
// block fills an SM's shared memory); at BN = 64 the products of warpgroups
// 0 and 1 delay their sampling; the A tile is still rebuilt for each
// 128-channel tile of C (4 times at C = 512); a block stages its halo and
// floors before its first product.  Beyond R' = 4 the candidate tests (289
// at R' = 8) are paid for every 16-channel slice of g, four times as often
// as at R' = 3 and 4.

#include "sm90_mma.cuh"

namespace {

using sm90::kRowBytes;

constexpr int TH = 8;                    // output tile rows
constexpr int TW = 16;                   // output tile columns
constexpr int BM = TH * TW;              // 128 pixels: two m64 warpgroups
constexpr int BK = 64;                   // output-gradient channels per W chunk
constexpr int PARTS = 2;                 // bf16 parts of z and W (hi, lo)
constexpr int THREADS = 512;             // four warpgroups, all sample
constexpr int A_BYTES = BM * kRowBytes;  // one part of A
constexpr int NW = 64;                   // input channels a product warpgroup takes
constexpr int kSmemLimit = 232448;       // a block's dynamic shared memory on sm_90
constexpr int kNarrowReach = 4;          // R' <= 4: every tap's floors staged once
constexpr int kMaxCand = 96;             // candidates (2R'+1)^2 <= 96 at R' <= 4
constexpr uint16_t kNoSource = 0xFFFF;   // floor code of a halo pixel off the map

__host__ __device__ constexpr int align16(int v) { return (v + 15) & ~15; }

// The shared-memory layout for clamp reach R', halo channels HC and BN input
// channels a block; the launch is sized from it (halo_channels below), and
// ops/dcn_cuda.py::dx_smem_bytes mirrors it.  R' <= 4 stages the floors of
// all 9 taps and a table of kMaxCand candidates; beyond, the floors of two
// taps (this stage's and the next's) and (2R'+1)^2 candidates rounded up to
// a batch of 32.
struct Layout {
  int P, hw, nh, taps, ncand;         // halo margin, width, pixels; floor taps, candidates
  int a, w, halo, code, ly, lx, m, cand, list, bar, bytes;
  __host__ __device__ Layout(int reach, int hc, int bn) {
    P = reach + 1;
    hw = TW + 2 * P;
    nh = (TH + 2 * P) * hw;
    const int D = 2 * reach + 1;
    taps = reach <= kNarrowReach ? 9 : 2;
    ncand = reach <= kNarrowReach ? kMaxCand : (D * D + 31) / 32 * 32;
    a = 0;                                      // 2 stages x PARTS x A
    w = 2 * PARTS * A_BYTES;                    // PARTS x W chunk (bn rows)
    halo = w + PARTS * bn * kRowBytes;          // g: nh x hc f32
    code = halo + nh * hc * 4;                  // floors: taps x nh u16
    ly = code + align16(taps * nh * 2);         // fractional parts and mask:
    lx = ly + taps * nh * 4;                    // taps x nh f32 each
    m = lx + taps * nh * 4;
    cand = m + taps * nh * 4;                   // the candidates: ncand u32
    list = cand + ncand * 4;                    // per pixel in flight: 32 weights
    bar = list + THREADS / 8 * 32 * 4;          // the W chunk's mbarrier
    bytes = bar + 8 + 1024;                     // + the 1024-byte alignment
  }
};

// The floor of tap k's sample point at halo pixel (hy, hx) relative to the
// tap's integer point (dy0, dx0 in [-R', R'], stored + 128), its fractional
// parts and the mask, computed as the plain op computes them; a pixel off the
// map gets kNoSource, which no candidate matches, and weight 0
__device__ __forceinline__ void tap_floor(const float* raw_off, const float* raw_m, bool in,
                                          int hy, int hx, int k, float R, uint16_t& code,
                                          float& ly, float& lx, float& m) {
  code = kNoSource;
  ly = lx = m = 0.f;
  if (!in) return;
  const int ty = hy + k / 3 - 1;
  const int tx = hx + k % 3 - 1;
  const float oy = fminf(fmaxf(raw_off[2 * k], -R), R);
  const float ox = fminf(fmaxf(raw_off[2 * k + 1], -R), R);
  const float py = static_cast<float>(ty) + oy;
  const float px = static_cast<float>(tx) + ox;
  const float fy = floorf(py);
  const float fx = floorf(px);
  ly = py - fy;
  lx = px - fx;
  m = raw_m[k];
  code = static_cast<uint16_t>((static_cast<int>(fy) - ty + 128) |
                               ((static_cast<int>(fx) - tx + 128) << 8));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  // the bytes past src_bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kBf16Math, int HC, int BN>
__global__ void __launch_bounds__(THREADS, 1)
dcn_bwd_dx_kernel(const float* __restrict__ offset, const float* __restrict__ mask,
                  const __nv_bfloat16* __restrict__ w_img, const float* __restrict__ g,
                  float* __restrict__ dx, int H, int W, int C, int Co, float R, int reach) {
  constexpr int kHalves = BK / HC;   // stages per (chunk, tap)
  constexpr int kSteps = HC / 16;    // wgmma k-steps per stage
  constexpr int kZ = HC / 8;         // channels of z a lane holds
  constexpr int kZ0 = kZ < 4 ? kZ : 4;  // in runs of kZ0 at channel kZ0 j (+ 32)
  // HC = 16 is the layout of R' > 4 (halo_channels): the floors of one tap
  // at a time, in two buffers, computed from the offsets in device memory
  constexpr bool kPerTap = HC == 16;
  constexpr int kProd = BN / 32;     // warpgroups that multiply: 2 or 4
  constexpr int B_BYTES = BN * kRowBytes;  // one part of W's chunk
  const Layout L(reach, HC, BN);
  extern __shared__ uint8_t smem_raw[];
  // aligned to 1024 bytes by an offset from smem_raw, not by integer casts,
  // so the compiler keeps every access in the shared window (LDS/STS, 32-bit
  // addresses) instead of generic loads with 64-bit address arithmetic
  uint8_t* smem = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  float* s_halo = reinterpret_cast<float*>(smem + L.halo);
  uint16_t* s_code = reinterpret_cast<uint16_t*>(smem + L.code);
  float* s_ly = reinterpret_cast<float*>(smem + L.ly);
  float* s_lx = reinterpret_cast<float*>(smem + L.lx);
  float* s_m = reinterpret_cast<float*>(smem + L.m);
  uint32_t* s_cand = reinterpret_cast<uint32_t*>(smem + L.cand);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // W of the stage

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int wid = tid >> 5;
  const int lane = tid & 31;
  const int P = L.P, hw = L.hw, nh = L.nh;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = ((blockIdx.x / tiles_x) % tiles_y) * TH;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int ct = blockIdx.y;
  const int n_ct = gridDim.y;
  const int n_cc = (Co + BK - 1) / BK;
  const int n_stages = n_cc * kHalves * 9;
  const uint32_t w_bytes = (kBf16Math ? 1 : PARTS) * B_BYTES;

  // stage s = ((cc * kHalves) + half) * 9 + k; its W chunk completes phase
  // s % 2 of the mbarrier
  auto copy_w = [&](int s) {
    const int k = s % 9;
    const int cc = s / (9 * kHalves);
    const long long chunk = (static_cast<long long>(k) * n_cc + cc) * n_ct + ct;
    sm90::mbar_arrive_expect_tx(full, w_bytes);
    sm90::bulk_copy(smem + L.w, w_img + chunk * PARTS * BN * BK, w_bytes, full);
  };

  // g's halo for channels c0 .. c0 + HC - 1, zero off the map and past Co;
  // the caller waits for the copies (cp_async_wait_all) and syncs
  const bool gvec = (Co % 4 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  auto stage_halo = [&](int c0) {
    for (int u = tid; u < nh * (HC / 4); u += THREADS) {
      const int hp = u / (HC / 4);
      const int c = c0 + 4 * (u % (HC / 4));
      const int hy = y0 - P + hp / hw;
      const int hx = x0 - P + hp % hw;
      const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
      float* dst = s_halo + hp * HC + (c - c0);
      const long long src = (static_cast<long long>(b * H + hy) * W + hx) * Co + c;
      if (gvec && !kBf16Math) {
        const int bytes = in ? max(0, min(16, 4 * (Co - c))) : 0;
        cp_async16(dst, bytes ? g + src : g, bytes);
      } else {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (gvec && in && c + 4 <= Co) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(g + src));
          v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (in && c + e < Co) v[e] = g[src + e];
        }
        if constexpr (kBf16Math) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = sm90::bf16_round(v[e]);
        }
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  if (tid == 0) {
    sm90::mbar_init(full, 1);
    sm90::mbar_init_fence();
  }
  // the floors of tap k for every halo pixel into floor buffer fb, from the
  // offsets and masks in device memory (R' > 4)
  auto tap_floors = [&](int k, int fb) {
    for (int hp = tid; hp < nh; hp += THREADS) {
      const int hy = y0 - P + hp / hw;
      const int hx = x0 - P + hp % hw;
      const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
      const long long pix = in ? static_cast<long long>(b * H + hy) * W + hx : 0;
      tap_floor(offset + pix * 18, mask + pix * 9, in, hy, hx, k, R, s_code[fb * nh + hp],
                s_ly[fb * nh + hp], s_lx[fb * nh + hp], s_m[fb * nh + hp]);
    }
  };
  // R' <= 4: the halo's offsets and masks (raw, 27 a pixel, zero off the
  // map) into the A stages, which the first sampling overwrites; g's halo
  // beside them
  float* s_raw = reinterpret_cast<float*>(smem + L.a);
  if constexpr (!kPerTap) {
    for (int u = tid; u < nh * 27; u += THREADS) {
      const int hp = u / 27;
      const int t = u % 27;
      const int hy = y0 - P + hp / hw;
      const int hx = x0 - P + hp % hw;
      const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
      const long long pix = static_cast<long long>(b * H + hy) * W + hx;
      const float* src = t < 18 ? offset + pix * 18 + t : mask + pix * 9 + t - 18;
      cp_async4(s_raw + u, in ? src : offset, in ? 4 : 0);
    }
  }
  stage_halo(0);
  // the candidates: entry ci is the source p = q - (ky + e, kx + f), (e, f)
  // = (ci / D - R', ci % D - R'), as its halo offset from q - (ky, kx) - (P, P)
  // (low 16 bits), e + 128 and f + 128 (a byte each); past the last, the
  // centre with a code no floor matches
  const int D = 2 * reach + 1;
  const int n_cand = D * D;
  for (int ci = tid; ci < L.ncand; ci += THREADS) {
    const int e = ci / D - reach;
    const int f = ci % D - reach;
    s_cand[ci] = ci < n_cand ? static_cast<uint32_t>((P - e) * hw + (P - f)) |
                                   static_cast<uint32_t>(e + 128) << 16 |
                                   static_cast<uint32_t>(f + 128) << 24
                             : static_cast<uint32_t>(P * hw + P) | 0xFFFF0000u;
  }
  if constexpr (kPerTap) tap_floors(0, 0);
  cp_async_wait_all();
  __syncthreads();
  // R' <= 4: the floors of every (halo pixel, tap) from the staged offsets
  if constexpr (!kPerTap) {
    for (int u = tid; u < nh * 9; u += THREADS) {
      const int hp = u / 9;
      const int k = u % 9;
      const int hy = y0 - P + hp / hw;
      const int hx = x0 - P + hp % hw;
      const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
      tap_floor(s_raw + hp * 27, s_raw + hp * 27 + 18, in, hy, hx, k, R, s_code[k * nh + hp],
                s_ly[k * nh + hp], s_lx[k * nh + hp], s_m[k * nh + hp]);
    }
  }
  __syncthreads();  // barriers initialised; halo, floors and candidates in place
  if (tid == 0) copy_w(0);

  const int grp = lane >> 3;  // the warp's pixel this lane works on (4 a warp)
  const int j = lane & 7;     // and its channels 4j .. 4j + 3 (+ 32 at HC = 64; 2j, 2j + 1 at 16)
  // the weights of the hits of this lane's pixel, by candidate bit
  float* s_list = reinterpret_cast<float*>(smem + L.list) + (tid >> 3) * 32;
  const int batches = (n_cand + 31) / 32;

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    const int k = s % 9;
    const int half = (s / 9) % kHalves;
    const int cc = s / (9 * kHalves);
    if (k == 0 && s > 0) {
      // the next chunk's halo: the last reads of this one (stage s - 1's
      // sampling) finished before the last barrier, and no product reads it
      stage_halo(cc * BK + half * HC);
      cp_async_wait_all();
      __syncthreads();
    }
    uint8_t* a = smem + L.a + buf * PARTS * A_BYTES;
    const int ky = k / 3 - 1;
    const int kx = k % 3 - 1;
    // R' > 4: the next stage's floors into the other buffer, whose last
    // reader, stage s - 1's sampling, finished before the last barrier
    if constexpr (kPerTap) {
      if (s + 1 < n_stages) tap_floors((s + 1) % 9, (s + 1) & 1);
    }
    const int fk = kPerTap ? (s & 1) : k;   // this tap's floor buffer
    const uint16_t* code_k = s_code + fk * nh;
    const float* ly_k = s_ly + fk * nh;
    const float* lx_k = s_lx + fk * nh;
    const float* m_k = s_m + fk * nh;
    // ---- the producer: z_k of 128 pixels, 4 a warp at a time, 8 lanes each ----
    for (int pass = 0; pass < BM / 64; ++pass) {
      const int row = 64 * pass + 4 * wid + grp;
      const int ty = row / TW;
      const int tx = row % TW;
      const bool q_in = y0 + ty < H && x0 + tx < W;
      const int base = (ty - ky) * hw + (tx - kx);
      float z[kZ];
#pragma unroll
      for (int i = 0; i < kZ; ++i) z[i] = 0.f;
      for (int batch = 0; batch < batches; ++batch) {
        // test 32 candidates (4 rounds of 8 lanes); bit 8 i + j of `hits` is
        // this pixel's candidate 32 batch + 8 i + j, whose weight the lane
        // that found it leaves in the pixel's list
        unsigned hits = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t cand = s_cand[32 * batch + 8 * i + j];
          const int hp = base + static_cast<int>(cand & 0xFFFFu);  // always in the halo
          // 256 (f - dx0) + (e - dy0): the corner (dy, dx) of p that lands on
          // q where it is dy + 256 dx with dy, dx in {0, 1}.  Branch-free: the
          // weight is formed for every candidate and kept for the hits
          const int diff = static_cast<int>(cand >> 16) - code_k[hp];
          const float ly = ly_k[hp];
          const float lx = lx_k[hp];
          float w = ((diff & 1) ? ly : 1.f - ly) * ((diff & 0x100) ? lx : 1.f - lx) * m_k[hp];
          if constexpr (kBf16Math) w = sm90::bf16_round(w);
          const bool hit = q_in && (diff & ~0x101) == 0 && w != 0.f;
          if (hit) s_list[8 * i + j] = w;
          hits |= ((__ballot_sync(0xffffffffu, hit) >> (8 * grp)) & 0xFFu) << (8 * i);
        }
        __syncwarp();
        // the sources whose corner lands on q, in candidate order, two a
        // step (the second with weight 0 past the end of the list)
        const uint32_t* cand_b = s_cand + 32 * batch;
        while (hits) {
          const int b0 = __ffs(hits) - 1;
          hits &= hits - 1;
          const bool two = hits != 0;
          const int b1 = two ? __ffs(hits) - 1 : b0;
          hits &= hits - 1;
          const float w0 = s_list[b0];
          const float w1 = two ? s_list[b1] : 0.f;
          const float* g0 = s_halo + (base + static_cast<int>(cand_b[b0] & 0xFFFFu)) * HC + kZ0 * j;
          const float* g1 = s_halo + (base + static_cast<int>(cand_b[b1] & 0xFFFFu)) * HC + kZ0 * j;
          if constexpr (kZ == 2) {
            const float2 v0 = *reinterpret_cast<const float2*>(g0);
            const float2 v1 = *reinterpret_cast<const float2*>(g1);
            z[0] = fmaf(w0, v0.x, z[0]);
            z[1] = fmaf(w0, v0.y, z[1]);
            z[0] = fmaf(w1, v1.x, z[0]);
            z[1] = fmaf(w1, v1.y, z[1]);
          } else {
            float4 v0[kZ / 4], v1[kZ / 4];
#pragma unroll
            for (int h = 0; h < kZ / 4; ++h) {
              v0[h] = *reinterpret_cast<const float4*>(g0 + 32 * h);
              v1[h] = *reinterpret_cast<const float4*>(g1 + 32 * h);
            }
#pragma unroll
            for (int h = 0; h < kZ / 4; ++h) {
              z[4 * h] = fmaf(w0, v0[h].x, z[4 * h]);
              z[4 * h + 1] = fmaf(w0, v0[h].y, z[4 * h + 1]);
              z[4 * h + 2] = fmaf(w0, v0[h].z, z[4 * h + 2]);
              z[4 * h + 3] = fmaf(w0, v0[h].w, z[4 * h + 3]);
            }
#pragma unroll
            for (int h = 0; h < kZ / 4; ++h) {
              z[4 * h] = fmaf(w1, v1[h].x, z[4 * h]);
              z[4 * h + 1] = fmaf(w1, v1[h].y, z[4 * h + 1]);
              z[4 * h + 2] = fmaf(w1, v1[h].z, z[4 * h + 2]);
              z[4 * h + 3] = fmaf(w1, v1[h].w, z[4 * h + 3]);
            }
          }
        }
        __syncwarp();  // the list is read before the next batch writes it
      }
      // z split into bf16 hi and lo, 4 channels (8 bytes) at a time (2 at
      // HC = 16), into A's swizzled row at this stage's columns
      auto u32 = [](const __nv_bfloat162& v) { return *reinterpret_cast<const uint32_t*>(&v); };
      if constexpr (kZ == 2) {
        const int col = half * HC + 2 * j;
        const int off = sm90::swz(row, col >> 3) + 2 * (col & 7);
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(z[0], z[1]);
        const float2 f0 = __bfloat1622float2(h0);
        const __nv_bfloat162 l0 = __floats2bfloat162_rn(z[0] - f0.x, z[1] - f0.y);
        *reinterpret_cast<uint32_t*>(a + off) = u32(h0);
        *reinterpret_cast<uint32_t*>(a + A_BYTES + off) = u32(l0);
      } else {
#pragma unroll
        for (int h = 0; h < kZ / 4; ++h) {
          const int col = half * HC + 32 * h + 4 * j;
          const int off = sm90::swz(row, col >> 3) + 2 * (col & 7);
          const __nv_bfloat162 h0 = __floats2bfloat162_rn(z[4 * h], z[4 * h + 1]);
          const __nv_bfloat162 h1 = __floats2bfloat162_rn(z[4 * h + 2], z[4 * h + 3]);
          const float2 f0 = __bfloat1622float2(h0);
          const float2 f1 = __bfloat1622float2(h1);
          const __nv_bfloat162 l0 = __floats2bfloat162_rn(z[4 * h] - f0.x, z[4 * h + 1] - f0.y);
          const __nv_bfloat162 l1 = __floats2bfloat162_rn(z[4 * h + 2] - f1.x,
                                                          z[4 * h + 3] - f1.y);
          *reinterpret_cast<uint2*>(a + off) = make_uint2(u32(h0), u32(h1));
          *reinterpret_cast<uint2*>(a + A_BYTES + off) = make_uint2(u32(l0), u32(l1));
        }
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();  // stage s's A tile is complete, stage s - 1's products done
    // ---- products on wgmma: warpgroup wg < kProd takes rows 64 (wg % 2) ..
    // + 63 and input channels 64 (wg / 2) .. + 63 into a fresh accumulator,
    // added into the f32 sum; at BN = 64 warpgroups 2 and 3 go on to sample
    // the next stage ----
    if (wg < kProd) {
      sm90::mbar_wait(full, s & 1);
      const uint32_t a0 = sm90::smem_u32(a) + (wg & 1) * (A_BYTES / 2);
      const uint32_t b0 = sm90::smem_u32(smem + L.w) + (wg >> 1) * NW * kRowBytes;
      auto da = [&](int p, int kk) { return sm90::desc(a0 + p * A_BYTES + 32 * kk, 16, 1024); };
      auto db = [&](int p, int kk) { return sm90::desc(b0 + p * B_BYTES + 32 * kk, 16, 1024); };
      float part[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) part[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const int kk = half * kSteps + i;
        sm90::wgmma<NW, 0, 0>(part, da(0, kk), db(0, kk));
        if constexpr (!kBf16Math) sm90::wgmma<NW, 0, 0>(part, da(0, kk), db(1, kk));
        sm90::wgmma<NW, 0, 0>(part, da(1, kk), db(0, kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc<NW / 2>(part);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] += part[i];
      // every product warpgroup is done with W's one buffer: the next
      // stage's chunk flies while they sample
      asm volatile("bar.sync 1, %0;\n" ::"r"(kProd * 128) : "memory");
      if (tid == 0 && s + 1 < n_stages) copy_w(s + 1);
    }
  }
  if (wg >= kProd) return;  // sampling-only warpgroups (BN = 64) hold no sums

  // accumulator fragment of m64n64: register 4n + 2h + e holds row
  // 16 warp + lane/4 + 8h of the warpgroup's 64 (tile row 4 (wg % 2) + warp,
  // column lane/4 + 8h), column 8n + 2 (lane%4) + e of its 64 channels
  const int oy = y0 + 4 * (wg & 1) + warp;
  if (oy >= H) return;
  const bool pair = (C % 2 == 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ox = x0 + (lane >> 2) + 8 * h;
    if (ox >= W) continue;
    float* out = dx + (static_cast<long long>(b * H + oy) * W + ox) * C;
#pragma unroll
    for (int n = 0; n < NW / 8; ++n) {
      const int c = ct * BN + (wg >> 1) * NW + 8 * n + 2 * (lane & 3);
      if (c >= C) continue;
      const float v0 = acc[4 * n + 2 * h];
      const float v1 = acc[4 * n + 2 * h + 1];
      if (pair && c + 1 < C) {
        *reinterpret_cast<float2*>(out + c) = make_float2(v0, v1);
      } else {
        out[c] = v0;
        if (c + 1 < C) out[c + 1] = v1;
      }
    }
  }
}

// W (9, C, Co) f32 -> w_img (9, n_cc, n_ct, 2, bn, 64) bf16: per (tap, Co
// chunk, bn-channel tile of C) the hi then lo tiles of W_k^T's block, rows of
// input channels with 64 output-gradient channels each, zero-padded and
// swizzled (ops/dcn_cuda.py::dx_weight_image is its plain version).  One
// thread per 16-byte group.
__global__ void dx_weight_image_kernel(const float* __restrict__ w,
                                       __nv_bfloat16* __restrict__ img, int C, int Co, int bn,
                                       int bf16_math) {
  const int n_cc = (Co + BK - 1) / BK;
  const int n_ct = (C + bn - 1) / bn;
  const int total = 9 * n_cc * n_ct * bn * 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int grp = t & 7;
  const int r = (t >> 3) % bn;
  const int tile = (t >> 3) / bn;  // (k, cc, ct)
  const int ct = tile % n_ct;
  const int cc = (tile / n_ct) % n_cc;
  const int k = tile / (n_ct * n_cc);
  const int c = ct * bn + r;
  const int co = cc * BK + 8 * grp;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = (c < C && co + e < Co) ? w[(static_cast<long long>(k) * C + c) * Co + co + e] : 0.f;
  uint4 hi, lo;
  sm90::split8<true>(v, hi, lo);
  if (bf16_math) lo = make_uint4(0u, 0u, 0u, 0u);
  uint8_t* base = reinterpret_cast<uint8_t*>(img) +
                  static_cast<long long>(tile) * PARTS * bn * kRowBytes;
  *reinterpret_cast<uint4*>(base + sm90::swz(r, grp)) = hi;
  *reinterpret_cast<uint4*>(base + bn * kRowBytes + sm90::swz(r, grp)) = lo;
}

template <bool kBf16Math, int HC, int BN>
int launch(const float* off, const float* m, const __nv_bfloat16* w_img, const float* g,
           float* dx, int B, int H, int W, int C, int Co, float R, int reach, cudaStream_t s) {
  auto kernel = dcn_bwd_dx_kernel<kBf16Math, HC, BN>;
  const Layout L(reach, HC, BN);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW), (C + BN - 1) / BN);
  kernel<<<grid, THREADS, L.bytes, s>>>(off, m, w_img, g, dx, H, W, C, Co, R, reach);
  return static_cast<int>(cudaGetLastError());
}

// g's halo channels a block stages at once at clamp reach R': at R' <= 4, 64
// where the block's shared memory allows at either tile of C, else 32; beyond,
// 16 (the floors then staged per tap); 0 where nothing fits (R' > 11,
// ops/dcn_cuda.py::DX_MAX_REACH)
int halo_channels(int reach) {
  if (reach < 0) return 0;
  if (reach > kNarrowReach) return Layout(reach, 16, 128).bytes <= kSmemLimit ? 16 : 0;
  for (int hc = 64; hc >= 32; hc /= 2) {
    const Layout L(reach, hc, 128);
    // the shared memory, and the raw offsets and masks in the A stages
    if (L.bytes <= kSmemLimit && L.nh * 27 * 4 <= L.w) return hc;
  }
  return 0;
}

template <bool kBf16Math>
int dispatch(int hc, int bn, const float* off, const float* m, const __nv_bfloat16* w_img,
             const float* g, float* dx, int B, int H, int W, int C, int Co, float R, int reach,
             cudaStream_t s) {
  auto run = [&](auto kernel_launch) {
    return kernel_launch(off, m, w_img, g, dx, B, H, W, C, Co, R, reach, s);
  };
  if (hc == 64) return bn == 64 ? run(launch<kBf16Math, 64, 64>) : run(launch<kBf16Math, 64, 128>);
  if (hc == 32) return bn == 64 ? run(launch<kBf16Math, 32, 64>) : run(launch<kBf16Math, 32, 128>);
  return bn == 64 ? run(launch<kBf16Math, 16, 64>) : run(launch<kBf16Math, 16, 128>);
}

// ---------------------------------------------------------------------------
// The wide path: R' = ceil(R) > 11, where the halo of g no longer fits a
// block's shared memory (ops/dcn_cuda.py::DX_MAX_REACH).  No halo: three
// kernels, each sum in a fixed order, so two launches are bit-equal.
//
//  1. dx_wide_code_kernel: for every (source pixel p, tap k) the floor of the
//     sample point relative to the tap's integer point, (fy - ty, fx - tx) in
//     [-R', R'], one signed byte each (so R' <= 127, kWideMaxReach).
//  2. dx_wide_u_kernel: u[p, k, :] = W_k g(p) (u = g W^T over the (9 C, Co)
//     view of W), an f32 product on the CUDA cores, tiled 64 x 64 with 16
//     output-gradient channels a step, each sum over Co in order.  The plain
//     backward (ops/dcn.py::modulated_deform_conv_backward) contracts first
//     too; so does the plain version of this path,
//     ops/dcn.py::modulated_deform_conv_dx_wide.
//  3. dx_wide_gather_kernel: dx[q, c] = sum over the (k, e, f) in [0, 9) x
//     [-R', R']^2, in that order, of wt_k(p -> q) u[p, k, c], p = q - (ky +
//     e, kx + f).  A block owns 32 output pixels (4 x 8) x 128 input
//     channels.  Each warp tests its pixels' candidates 32 at a time straight
//     from the floor codes in device memory (one 2-byte load a candidate); a
//     ballot compacts the hits, in candidate order, into the pixel's list in
//     shared memory (weight formed at the source as the forward forms it,
//     and the row of u); a full list pauses the scan at a 32-candidate
//     boundary, the block walks the lists (each thread one channel of 16
//     pixels, u read 512 contiguous bytes a row) and the scan resumes, so a
//     pixel may take any number of hits.
//
// Under bf16 window math g, W and each corner weight times the mask are
// rounded to bf16 and the sums are f32, as in the halo path.
//
// What bounds it: the candidate tests, 9 (2R'+1)^2 a pixel for every
// 128-channel tile of C (9801 at R' = 16), from L1 and L2; the product is
// 2 * 9 * C * Co a pixel on the CUDA cores; u is 9 C floats a pixel, written
// once and read back once for each hit.

constexpr int kWideMaxReach = 127;   // the floor codes are signed bytes
constexpr int kWideTH = 4;           // gather tile rows
constexpr int kWideTW = 8;           // gather tile columns
constexpr int kWidePix = kWideTH * kWideTW;
constexpr int kWideCB = 128;         // input channels a gather block
constexpr int kWideThreads = 256;    // 8 warps: 4 pixels each in the scan
constexpr int kWideList = 64;        // a pixel's list: at least one batch of 32

__global__ void dx_wide_code_kernel(const float* __restrict__ offset,
                                    int16_t* __restrict__ code, int H, int W, long long n,
                                    float R) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= n) return;
  const long long pix = t / 9;
  const int k = static_cast<int>(t % 9);
  const int hy = static_cast<int>((pix / W) % H);
  const int hx = static_cast<int>(pix % W);
  const int ty = hy + k / 3 - 1;
  const int tx = hx + k % 3 - 1;
  const float oy = fminf(fmaxf(offset[pix * 18 + 2 * k], -R), R);
  const float ox = fminf(fmaxf(offset[pix * 18 + 2 * k + 1], -R), R);
  const int fy = static_cast<int>(floorf(static_cast<float>(ty) + oy)) - ty;
  const int fx = static_cast<int>(floorf(static_cast<float>(tx) + ox)) - tx;
  code[t] = static_cast<int16_t>((fy & 0xFF) | (fx << 8));
}

// u (npix, 9 C) = g (npix, Co) x W^T, W viewed as (9 C, Co); 256 threads a
// 64 x 64 tile of u, 4 x 4 a thread, 16 channels of Co a step
template <bool kBf16Math>
__global__ void __launch_bounds__(256)
dx_wide_u_kernel(const float* __restrict__ g, const float* __restrict__ w,
                 float* __restrict__ u, long long npix, int N, int Co) {
  __shared__ float sg[16][64 + 4];
  __shared__ float sw[16][64 + 4];
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * 64;
  const int n0 = blockIdx.y * 64;
  const int tm = tid / 16;   // rows 4 tm .. + 3 of the tile
  const int tn = tid % 16;   // columns 4 tn .. + 3
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Co; k0 += 16) {
    for (int i = tid; i < 64 * 16; i += 256) {
      const int r = i / 16;
      const int kk = i % 16;
      const long long m = m0 + r;
      const int n = n0 + r;
      float a = (m < npix && k0 + kk < Co) ? g[m * Co + k0 + kk] : 0.f;
      float b = (n < N && k0 + kk < Co) ? w[static_cast<long long>(n) * Co + k0 + kk] : 0.f;
      if constexpr (kBf16Math) {
        a = sm90::bf16_round(a);
        b = sm90::bf16_round(b);
      }
      sg[kk][r] = a;
      sw[kk][r] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sg[kk][4 * tm + i];
        b[i] = sw[kk][4 * tn + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + 4 * tm + i;
    if (m >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n < N) u[m * N + n] = acc[i][j];
    }
  }
}

template <bool kBf16Math>
__global__ void __launch_bounds__(kWideThreads)
dx_wide_gather_kernel(const int16_t* __restrict__ code, const float* __restrict__ offset,
                      const float* __restrict__ mask, const float* __restrict__ u,
                      float* __restrict__ dx, int H, int W, int C, float R, int reach) {
  __shared__ float s_w[kWidePix][kWideList];
  __shared__ int s_row[kWidePix][kWideList];   // (p * 9 + k): the row of u
  __shared__ int s_count[kWidePix];
  __shared__ int s_cursor[kWidePix];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_x = (W + kWideTW - 1) / kWideTW;
  const int tiles_y = (H + kWideTH - 1) / kWideTH;
  const int x0 = (blockIdx.x % tiles_x) * kWideTW;
  const int y0 = ((blockIdx.x / tiles_x) % tiles_y) * kWideTH;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int D = 2 * reach + 1;
  const int DD = D * D;
  const int n_cand = 9 * DD;
  if (tid < kWidePix) s_cursor[tid] = 0;
  // the walk: channel c of pixels 16 (tid / 128) .. + 15
  const int c = blockIdx.y * kWideCB + (tid % kWideCB);
  const int pix0 = (tid / kWideCB) * (kWidePix / 2);
  float acc[kWidePix / 2];
#pragma unroll
  for (int i = 0; i < kWidePix / 2; ++i) acc[i] = 0.f;
  __syncthreads();
  while (true) {
    // ---- the scan: warp w's pixels 4 w .. 4 w + 3, from where each paused ----
    bool paused = false;
    for (int i = 0; i < 4; ++i) {
      const int pi = 4 * warp + i;
      const int qy = y0 + pi / kWideTW;
      const int qx = x0 + pi % kWideTW;
      const bool q_in = qy < H && qx < W;
      int cursor = q_in ? s_cursor[pi] : n_cand;
      int count = 0;
      for (; cursor < n_cand; cursor += 32) {
        const int ci = cursor + lane;
        bool hit = false;
        float wt = 0.f;
        int row = 0;
        if (ci < n_cand) {
          const int k = ci / DD;
          const int r = ci - k * DD;
          const int e = r / D - reach;
          const int f = r - (r / D) * D - reach;
          const int py = qy - (k / 3 - 1) - e;
          const int px = qx - (k % 3 - 1) - f;
          if (py >= 0 && py < H && px >= 0 && px < W) {
            const long long p = (static_cast<long long>(b) * H + py) * W + px;
            const int cd = code[p * 9 + k];
            const int dy = e - static_cast<int>(static_cast<int8_t>(cd & 0xFF));
            const int dxc = f - (cd >> 8);
            if (((dy | dxc) & ~1) == 0) {
              // the corner (dy, dxc) of p's tap-k sample lands on q: its
              // weight as the forward forms it
              const int ty = py + k / 3 - 1;
              const int tx = px + k % 3 - 1;
              const float sy = static_cast<float>(ty) +
                               fminf(fmaxf(offset[p * 18 + 2 * k], -R), R);
              const float sx = static_cast<float>(tx) +
                               fminf(fmaxf(offset[p * 18 + 2 * k + 1], -R), R);
              const float ly = sy - floorf(sy);
              const float lx = sx - floorf(sx);
              wt = (dy ? ly : 1.f - ly) * (dxc ? lx : 1.f - lx) * mask[p * 9 + k];
              if constexpr (kBf16Math) wt = sm90::bf16_round(wt);
              hit = wt != 0.f;
              row = static_cast<int>(p * 9 + k);
            }
          }
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        const int n = __popc(ballot);
        if (count + n > kWideList) break;   // the list is full: resume here
        if (hit) {
          const int pos = count + __popc(ballot & ((1u << lane) - 1u));
          s_w[pi][pos] = wt;
          s_row[pi][pos] = row;
        }
        count += n;
      }
      if (lane == 0) {
        s_count[pi] = count;
        s_cursor[pi] = cursor;
      }
      paused |= cursor < n_cand;
    }
    // a pixel paused on a full list: the block scans again after the walk
    const bool more = __syncthreads_or(paused);
    // ---- the walk: each thread its channel of 16 pixels, in list order ----
    if (c < C) {
#pragma unroll 1
      for (int i = 0; i < kWidePix / 2; ++i) {
        const int pi = pix0 + i;
        const int n = s_count[pi];
        float a = acc[i];
        for (int j = 0; j < n; ++j)
          a = fmaf(s_w[pi][j], u[static_cast<long long>(s_row[pi][j]) * C + c], a);
        acc[i] = a;
      }
    }
    __syncthreads();   // the lists are read before the next scan writes them
    if (!more) break;
  }
  if (c >= C) return;
#pragma unroll
  for (int i = 0; i < kWidePix / 2; ++i) {
    const int pi = pix0 + i;
    const int qy = y0 + pi / kWideTW;
    const int qx = x0 + pi % kWideTW;
    if (qy < H && qx < W) dx[((static_cast<long long>(b) * H + qy) * W + qx) * C + c] = acc[i];
  }
}

template <bool kBf16Math>
int launch_wide(const float* off, const float* m, const float* w, const float* g,
                int16_t* code, float* u, float* dx, int B, int H, int W, int C, int Co,
                float R, int reach, cudaStream_t s) {
  const long long npix = static_cast<long long>(B) * H * W;
  const long long ncode = npix * 9;
  dx_wide_code_kernel<<<static_cast<unsigned>((ncode + 255) / 256), 256, 0, s>>>(
      off, code, H, W, ncode, R);
  const int N = 9 * C;
  dx_wide_u_kernel<kBf16Math><<<dim3(static_cast<unsigned>((npix + 63) / 64), (N + 63) / 64),
                                256, 0, s>>>(g, w, u, npix, N, Co);
  const dim3 grid(B * ((H + kWideTH - 1) / kWideTH) * ((W + kWideTW - 1) / kWideTW),
                  (C + kWideCB - 1) / kWideCB);
  dx_wide_gather_kernel<kBf16Math><<<grid, kWideThreads, 0, s>>>(code, off, m, u, dx, H, W, C,
                                                                 R, reach);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wide path (R' = ceil(max_offset) in 12 .. 127): the floor codes into
// `code` (scratch of B*H*W*9 int16), u into `u` (scratch of B*H*W*9*C f32),
// then dx, all on `stream`; returns the CUDA error (0 on success).  The
// caller checks shapes, dtypes, devices and contiguity, and that B*H*W*9
// fits in 32 bits; a reach outside 0 .. 127 returns cudaErrorInvalidValue
// before anything launches.
extern "C" int dcn_bwd_dx_wide(int bf16_math, const void* offset, const void* mask,
                               const void* weight, const void* g, void* code, void* u, void* dx,
                               int B, int H, int W, int C, int Co, float max_offset, int reach,
                               void* stream) {
  if (reach < 0 || reach > kWideMaxReach) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launch_fn) {
    return launch_fn(static_cast<const float*>(offset), static_cast<const float*>(mask),
                     static_cast<const float*>(weight), static_cast<const float*>(g),
                     static_cast<int16_t*>(code), static_cast<float*>(u),
                     static_cast<float*>(dx), B, H, W, C, Co, max_offset, reach, s);
  };
  return bf16_math ? run(launch_wide<true>) : run(launch_wide<false>);
}

// Lays out W (9, C, Co) f32 into w_img (scratch of 9 * ceil(Co/64) *
// ceil(C/bn) * parts * bn * 64 bf16, ops/dcn_cuda.py::dx_image_numel, where
// parts must be this build's PARTS), then launches dx, both on `stream`;
// returns the CUDA error (0 on success).  The caller checks shapes, dtypes,
// devices and contiguity, that every index fits in 32 bits and that the
// reach ceil(max_offset) fits (R' <= 11), picks the block's input channels
// bn (64 or 128, ops/dcn_cuda.py::dx_tile_c) and gives the block's shared
// memory as its mirror of Layout computes it (ops/dcn_cuda.py::
// dx_smem_bytes); where the reach does not fit or the count differs, this
// returns cudaErrorInvalidValue before it launches anything.
extern "C" int dcn_bwd_dx(int bf16_math, const void* offset, const void* mask,
                          const void* weight, void* w_img, int parts, int bn, int smem_bytes,
                          const void* g, void* dx, int B, int H, int W, int C, int Co,
                          float max_offset, int reach, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offset);
  const float* m = static_cast<const float*>(mask);
  auto* wi = static_cast<__nv_bfloat16*>(w_img);
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(dx);
  const int hc = halo_channels(reach);
  if (hc == 0 || parts != PARTS || (bn != 64 && bn != 128) ||
      Layout(reach, hc, bn).bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = 9 * ((Co + BK - 1) / BK) * ((C + bn - 1) / bn) * bn * 8;
  dx_weight_image_kernel<<<(groups + 255) / 256, 256, 0, s>>>(static_cast<const float*>(weight),
                                                              wi, C, Co, bn, bf16_math);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (bf16_math)
    return dispatch<true>(hc, bn, off, m, wi, gg, d, B, H, W, C, Co, max_offset, reach, s);
  return dispatch<false>(hc, bn, off, m, wi, gg, d, B, H, W, C, Co, max_offset, reach, s);
}
