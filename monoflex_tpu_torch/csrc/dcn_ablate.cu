// Ablations of the DCNv2 forward, for sm_90a: dcn_fwd.cu stripped to one
// part, so that the card shows where dcn_fwd's time goes.
//
// Replaces the TPU kernels of the JAX package's diagnostics tools:
//   tools/kernel_diag.py::run_variant (body _kernel): dma, window, aligned,
//     matmul;
//   tools/fwd_ablate.py::build_variant (body _kernel): nomap, nobcast.
// With x (B,H,W,C) NHWC f32 and zero padding outside the map, R the offset
// clamp, o_k and m_k the tap's offset and mask, bil(x, q) bilinear sampling
// at q and hat(t) = max(0, 1 - |t|):
//
//   dma      out = x, copied through a staged halo of P = R + 1 rows and
//            columns: it measures the staging alone.  C out channels.
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
// Design: each variant keeps one part of dcn_fwd.cu as it runs on this card.
//  - dma (dma_kernel): the halo staging of a tile, as a forward that staged
//    x would take it.  A block owns a tile of th rows x tw columns (chosen
//    at launch: the smallest halo overhead that still gives two blocks an SM)
//    and streams its th + 2P halo rows through a ring of four shared-memory
//    slots: one thread bulk-copies each row's run of (tw + 2P) pixels (NHWC,
//    contiguous) onto an mbarrier and bulk-stores the core tw pixels of
//    each core row back out, so no register touches the data.  The halo's
//    re-reads come from L2.  Where C is not a multiple of 4 (bulk copies move
//    16-byte units) the block's threads copy the same rows element by
//    element.
//  - window, aligned (sum_kernel): dcn_fwd's sampling producer.  A block owns
//    128 pixels x 64 channels, eight threads a pixel, each an 8-channel group;
//    the block's offsets are staged once; per tap each thread forms its
//    pixel's 4 corner offsets and weights and gathers each corner's 8
//    channels in 16-byte vectors.  The taps are summed in f32 registers and
//    stored once: no split and no products.
//  - matmul, nomap, nobcast: dcn_fwd's own pipeline (fwd_stages.cuh::
//    run_ring: a warp-specialised ring of 32-channel stages of A and W, W
//    by bulk copy from dcn_fwd's layout, which dcn_fwd's layout kernel
//    writes first; warpgroups 2 and 3 produce the A tiles, 0 and 1 issue
//    six wgmma passes a stage into a fresh accumulator, added into the f32
//    sums), with only the A-tile producer changed:
//      matmul (gemm_matmul_kernel): dcn_fwd's block (its consecutive pixels
//        x BN, BN and threads as dcn_fwd's, the wide tile included), stage
//        order and producer, with one aligned term a tap, m_k x[p + k], in
//        place of the 4 bilinear corners, loaded when the stage is made;
//      nomap, nobcast (gemm_window_kernel): an 8 x 16 tile of pixels at
//        BN = 64 (dcn_fwd's wider rings leave no room for a halo), stages
//        ordered (channel slice, tap), each slice's halo of x (P = R + 1,
//        f32, zero off the map) staged in shared memory by the producers at
//        its first stage (32 channels, or 16 where the halo does not fit).  Both
//        windows are separable: a thread takes 2 output rows x 2 columns of
//        a channel group and forms each row sum sum_f wx(k,f) x they read
//        once, from a register window sliding along the row, adding it
//        times wy(k,e) into every output row it reaches (window_tile).
//        nobcast's weights are its tile maxima, constant over the block's
//        rows (they lie in one row tile: the tile is a multiple of 16 rows
//        and the block's 8 rows start at a multiple of 8); nomap's are 0.5
//        a row and a column.
//    nobcast first runs tile_max_kernel, one block per (batch, row tile,
//    tap), which reduces the hat maps to their tile maxima.
// Every sum runs in a fixed order: two launches are bit-equal.
//
// What bounds each (chip_smoke.py::dcn_work).  dma, window and aligned move
// bytes: x read once and the output written once (the halo's re-reads hit
// L2).  matmul, nomap and nobcast do dcn_fwd's 2*9*C*Co products a pixel at
// six bf16 passes on the tensor cores, beside their f32 window sums (nomap's
// box counted once, as its least work; the kernel forms it per tap).  What
// holds them back: what holds dcn_fwd's ring back (dcn_fwd.cu), and for
// nomap and nobcast at Co = 64 the window's shared-memory reads too (a halo
// pixel read once per 2 output columns); the A tile is built for each
// BN-channel tile of Co, as in dcn_fwd.
//
// Layouts: x (B,H,W,C), offset (B,H,W,18) interleaved (dy_k, dx_k), mask
// (B,H,W,9), weight (9,C,Co), w_img (9, ceil(C/32), ceil(Co/BN), 3, BN, 32)
// bf16 scratch, out (B,H,W,C or Co), tilemax (B * ntiles * 9, 2, 2R+1)
// scratch (wy maxima, then wx maxima); f32 unless stated, all contiguous.

#include <math_constants.h>

#include "fwd_stages.cuh"
#include "sm90_mma.cuh"

namespace {

enum Variant : int { kDma = 0, kWindow = 1, kAligned = 2, kMatmul = 3, kNomap = 4, kNobcast = 5 };

constexpr int kSmemLimit = 232448;  // a block's dynamic shared memory on sm_90
constexpr int RMAX = 7;             // the TPU tools' limit: P = R + 1 <= their 8 guard rows
constexpr int MAXW = 2 * RMAX + 1;  // window terms per axis
constexpr int BK = 64;              // channels of a sum_kernel block
constexpr int PARTS = 3;            // bf16 parts of each operand, as dcn_fwd (hi, mid, lo)
static_assert(PARTS == kImageParts, "W's layout (fwd_stages.cuh)");
constexpr int BM = 128;             // pixels a sum_kernel or window block owns
constexpr int A_BYTES = FwdTile<64>::kA;  // one part of a window block's A
// sum_kernel
constexpr int THREADS = 512;        // 8 threads a pixel
// gemm_window_kernel's pixel tile
constexpr int TH = 8;               // tile rows
constexpr int TW = 16;              // tile columns
static_assert(TH * TW == BM, "the window tile fills A's rows");
// dma_kernel
constexpr int DMA_THREADS = 128;
constexpr int SLOTS = 4;                 // rows in flight per block, at most
constexpr int DMA_SLOT_MAX = 40960;      // bytes of a slot (one halo row's run)

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  // the bytes past src_bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- dma ----

// one bulk copy shared -> global, in the thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(sm90::smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's bulk groups are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// sm90::mbar_wait for one thread of a warp (it ends without __syncwarp)
__device__ __forceinline__ void mbar_wait1(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sm90::smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - start > (1ll << 35)) __trap();  // ~20 s at the boost clock
  }
}

// grid (B * row tiles * column tiles); the tile's halo rows y0 - P ..
// y0 + th + P - 1 (those on the map), each as its run of columns x0 - P ..
// x0 + tw + P - 1 (those on the map), through `slots` slots of slot_bytes:
// thread 0 bulk-copies the rows in and the core rows out
__global__ void __launch_bounds__(DMA_THREADS)
dma_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int C, int P,
           int th, int tw, int slot_bytes, int slots, int bulk) {
  extern __shared__ __align__(128) uint8_t dsmem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(dsmem);
  uint8_t* ring = dsmem + 128;
  const int tiles_x = (W + tw - 1) / tw;
  const int tiles_y = (H + th - 1) / th;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int y0 = ((blockIdx.x / tiles_x) % tiles_y) * th;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int r_lo = max(0, y0 - P), r_hi = min(H, y0 + th + P);
  const int c_lo = max(0, x0 - P), c_hi = min(W, x0 + tw + P);
  const int core_w = min(W, x0 + tw) - x0;
  const int nrows = r_hi - r_lo;
  const long long row_px = static_cast<long long>(W);
  auto src_row = [&](int h) { return x + ((b * H + h) * row_px + c_lo) * C; };
  auto dst_core = [&](int h) { return out + ((b * H + h) * row_px + x0) * C; };
  const int core_off = (x0 - c_lo) * C;  // the core's first element in a slot
  if (bulk) {
    if (threadIdx.x != 0) return;
    const uint32_t seg = static_cast<uint32_t>((c_hi - c_lo) * C * 4);
    const uint32_t core = static_cast<uint32_t>(core_w * C * 4);
    for (int i = 0; i < slots; ++i) sm90::mbar_init(&full[i], 1);
    sm90::mbar_init_fence();
    auto load = [&](int i) {  // halo row i into slot i % slots
      uint64_t* bar = &full[i % slots];
      sm90::mbar_arrive_expect_tx(bar, seg);
      sm90::bulk_copy(ring + (i % slots) * slot_bytes, src_row(r_lo + i), seg, bar);
    };
    for (int i = 0; i < min(slots, nrows); ++i) load(i);
    for (int i = 0; i < nrows; ++i) {
      mbar_wait1(&full[i % slots], (i / slots) & 1);
      const int h = r_lo + i;
      if (h >= y0 && h < y0 + th) {
        sm90::fence_proxy_async();
        bulk_store(dst_core(h), ring + (i % slots) * slot_bytes + core_off * 4, core);
      }
      bulk_commit();
      // the previous row's slot is free once its store has read it: refill
      // it with the row slots - 1 on
      if (i > 0 && i - 1 + slots < nrows) {
        bulk_wait_read<1>();
        load(i - 1 + slots);
      }
    }
    bulk_wait_read<0>();  // the stores have read the ring; they complete on their own
    return;
  }
  // C not a multiple of 4: the same rows through one slot, element by element
  float* slot = reinterpret_cast<float*>(ring);
  const int seg_n = (c_hi - c_lo) * C;
  for (int h = r_lo; h < r_hi; ++h) {
    const float* src = src_row(h);
    for (int e = threadIdx.x; e < seg_n; e += DMA_THREADS) slot[e] = src[e];
    __syncthreads();
    if (h >= y0 && h < y0 + th) {
      float* dst = dst_core(h);
      for (int e = threadIdx.x; e < core_w * C; e += DMA_THREADS) dst[e] = slot[core_off + e];
    }
    __syncthreads();
  }
}

// ------------------------------------------------------- window, aligned ----

// grid (pixel tiles of BM, channel chunks of 64); 8 threads a pixel
template <int V>
__global__ void __launch_bounds__(THREADS)
sum_kernel(const float* __restrict__ x, const float* __restrict__ offset, float* __restrict__ out,
           int B, int H, int W, int C, float R) {
  __shared__ float s_off[BM * 18];
  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * BM;
  const int nrows = min(BM, npix - p0);
  for (int e = tid; e < nrows * 18; e += THREADS) s_off[e] = offset[p0 * 18 + e];
  __syncthreads();
  constexpr int kRowsPerPass = THREADS / 8;
  const int j = tid & 7;
  const int c = blockIdx.y * BK + 8 * j;
  const bool vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
#pragma unroll
  for (int pass = 0; pass < BM / kRowsPerPass; ++pass) {
    const int row = (tid >> 3) + kRowsPerPass * pass;
    const int pix = p0 + row;
    if (pix >= npix || c >= C) continue;
    const int pw = pix % W;
    const int ph = (pix / W) % H;
    const int pb = pix / (W * H);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int k = 0; k < 9; ++k) {
      const float py = ph + (k / 3 - 1) + clampR(s_off[row * 18 + 2 * k], R);
      // aligned drops the column shift: the sample column is w itself
      const float px = V == kAligned ? static_cast<float>(pw)
                                     : pw + (k % 3 - 1) + clampR(s_off[row * 18 + 2 * k + 1], R);
      const float fy = floorf(py);
      const float fx = floorf(px);
      const float ly = py - fy;
      const float lx = px - fx;
      int idx[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int yy = static_cast<int>(fy) + (q >> 1);
        const int xx = static_cast<int>(fx) + (q & 1);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          idx[q] = ((pb * H + yy) * W + xx) * C;
          wt[q] = ((q >> 1) ? ly : 1.f - ly) * ((q & 1) ? lx : 1.f - lx);
        }
      }
      if (vec && c + 8 <= C) {
        float4 v[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4* src = reinterpret_cast<const float4*>(x + idx[q] + c);
          v[q][0] = __ldg(src);
          v[q][1] = __ldg(src + 1);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0] = fmaf(wt[q], v[q][0].x, acc[0]);
          acc[1] = fmaf(wt[q], v[q][0].y, acc[1]);
          acc[2] = fmaf(wt[q], v[q][0].z, acc[2]);
          acc[3] = fmaf(wt[q], v[q][0].w, acc[3]);
          acc[4] = fmaf(wt[q], v[q][1].x, acc[4]);
          acc[5] = fmaf(wt[q], v[q][1].y, acc[5]);
          acc[6] = fmaf(wt[q], v[q][1].z, acc[6]);
          acc[7] = fmaf(wt[q], v[q][1].w, acc[7]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c + e < C) acc[e] = fmaf(wt[q], x[idx[q] + c + e], acc[e]);
      }
    }
    float* dst = out + static_cast<long long>(pix) * C + c;
    if (vec && c + 8 <= C) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < C) dst[e] = acc[e];
    }
  }
}

// --------------------------------------------- matmul, nomap, nobcast ----

// 4 f32 values -> three bf16 parts (as sm90::split8x3) into A's row `row`
// at columns col .. + 3 (of a stage's 32)
__device__ __forceinline__ void put4(uint8_t* a, int row, int col, const float4& v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  uint32_t part[PARTS][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hb);
    const float r0 = x[2 * i] - hf.x, r1 = x[2 * i + 1] - hf.y;
    const __nv_bfloat162 mb = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(mb);
    const __nv_bfloat162 lb = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
    part[0][i] = *reinterpret_cast<const uint32_t*>(&hb);
    part[1][i] = *reinterpret_cast<const uint32_t*>(&mb);
    part[2][i] = *reinterpret_cast<const uint32_t*>(&lb);
  }
  const int off = sm90::swz64(row, col >> 3) + 2 * (col & 7);
#pragma unroll
  for (int p = 0; p < PARTS; ++p)
    *reinterpret_cast<uint2*>(a + p * A_BYTES + off) = make_uint2(part[p][0], part[p][1]);
}

__device__ __forceinline__ void fma4(float4& acc, const float4& v, float w) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
  acc.z = fmaf(v.z, w, acc.z);
  acc.w = fmaf(v.w, w, acc.w);
}

// nomap's or nobcast's A tile of tap (ky, kx) at columns col0 .. + HC - 1 of A, from
// the halo of x (HC channels, hw pixels a row): A[ty][t] = sum_e wy(e)
// sum_f wx(f) x[ty + ky + e][t + kx + f] (halo row ty + ky + e + R + 1,
// column t + kx + f + R + 1), items u0, u0 + step, .. < u_end of the tile's
// (TH / kRo) (TW / kCo) (HC / 4): each kRo output rows x kCo columns of one
// channel group.  A thread forms each row sum an item's rows
// read once (for its kCo columns together, sliding a window of kCo + 2R
// loads up to R = 2) and adds it, times wy(e), into every output row it
// reaches: a row pass and a column pass in registers, in the plain
// version's order of sums
template <int HC, int kRo, int kCo>
__device__ __forceinline__ void window_tile(uint8_t* a, const float* s_halo, int hw,
                                            const float* wy, int n, int R, int ky, int kx,
                                            int col0, int u0, int u_end, int step) {
  constexpr int kG = HC / 4;
  constexpr int kMaxN = 5;           // up to R = 2 every index below is known at compile time
  constexpr int kRows = kRo + kMaxN - 1;
  const float* wx = wy + n;
  float wyr[kMaxN], wxr[kMaxN];
#pragma unroll
  for (int e = 0; e < kMaxN; ++e) {
    wyr[e] = e < n ? wy[e] : 0.f;
    wxr[e] = e < n ? wx[e] : 0.f;
  }
  for (int u = u0; u < u_end; u += step) {
    const int g = u % kG;
    const int t0 = kCo * ((u / kG) % (TW / kCo));
    const int r0 = kRo * (u / (kG * (TW / kCo)));
    float4 o[kRo][kCo];
#pragma unroll
    for (int r = 0; r < kRo; ++r)
#pragma unroll
      for (int c = 0; c < kCo; ++c) o[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = s_halo + ((r0 + ky + 1) * hw + t0 + kx + 1) * HC + 4 * g;
    if (n <= kMaxN) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < kRo + n - 1) {
          const float* row = src + j * hw * HC;
          float4 v[kCo + kMaxN - 1];
#pragma unroll
          for (int i = 0; i < kCo + kMaxN - 1; ++i)
            if (i < kCo + n - 1) v[i] = *reinterpret_cast<const float4*>(row + i * HC);
          float4 rs[kCo];
#pragma unroll
          for (int c = 0; c < kCo; ++c) {
            rs[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int f = 0; f < kMaxN; ++f)
              if (f < n) fma4(rs[c], v[c + f], wxr[f]);
          }
          // output row r takes this row sum at e = j - r
#pragma unroll
          for (int r = 0; r < kRo; ++r) {
            if (j - r >= 0 && j - r < kMaxN && j - r < n) {
#pragma unroll
              for (int c = 0; c < kCo; ++c) fma4(o[r][c], rs[c], wyr[j - r]);
            }
          }
        }
      }
    } else {
      for (int j = 0; j < kRo + 2 * R; ++j) {
        const float* row = src + j * hw * HC;
        float4 rs[kCo];
#pragma unroll
        for (int c = 0; c < kCo; ++c) {
          rs[c] = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int f = 0; f < n; ++f)
            fma4(rs[c], *reinterpret_cast<const float4*>(row + (c + f) * HC), wx[f]);
        }
#pragma unroll
        for (int r = 0; r < kRo; ++r) {
          const int e = j - r;
          if (e >= 0 && e < n) {
#pragma unroll
            for (int c = 0; c < kCo; ++c) fma4(o[r][c], rs[c], wy[e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRo; ++r)
#pragma unroll
      for (int c = 0; c < kCo; ++c) put4(a, (r0 + r) * TW + t0 + c, col0 + 4 * g, o[r][c]);
  }
}

// matmul: dcn_fwd with its sampling producer reduced to one aligned term a
// tap.  The same block (dcn_fwd's rows x BN output channels and threads),
// stage order (tap, 32-channel chunk) and ring (fwd_stages.cuh); per stage
// four producer threads a pixel load their 8-channel group of the run at
// p + (ky, kx) in 16-byte vectors, scale it by the mask and write its three
// bf16 parts into A
template <int BN>
__global__ void __launch_bounds__(kRingThreads, 1)
gemm_matmul_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ w_img, float* __restrict__ out, int B, int H,
                   int W, int C, int Co) {
  constexpr int kRows = FwdTile<BN>::kRows;
  constexpr int kA = FwdTile<BN>::kA;
  constexpr int kRowsPerPass = kProducers / 4;
  extern __shared__ uint8_t smem_raw[];
  // aligned to 1024 bytes by an offset from smem_raw, as dcn_bwd_dx.cu
  uint8_t* smem = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  const int npix = B * H * W;
  const int p0 = blockIdx.x * kRows;
  const int nt = blockIdx.y;
  const int n_cc = (C + kImageChunk - 1) / kImageChunk;  // 32-channel stages a tap
  const int n_nt = gridDim.y;
  const bool vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  auto w_of = [&](int s) { return StageW{static_cast<long long>(s) * n_nt + nt, 0}; };
  auto produce = [&](int s, uint8_t* a, int ptid) {
    const int j = ptid & 3;
    const int k = s / n_cc;
    const int c = (s % n_cc) * kImageChunk + 8 * j;
#pragma unroll
    for (int pass = 0; pass < kRows / kRowsPerPass; ++pass) {
      const int row = (ptid >> 2) + kRowsPerPass * pass;
      const int pix = p0 + row;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (pix < npix && c < C) {
        const int yy = (pix / W) % H + k / 3 - 1;
        const int xx = pix % W + k % 3 - 1;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          const float m = __ldg(mask + static_cast<long long>(pix) * 9 + k);
          const float* src = x + (static_cast<long long>(pix / (W * H) * H + yy) * W + xx) * C + c;
          if (vec && c + 8 <= C) {
            const float4 p = __ldg(reinterpret_cast<const float4*>(src));
            const float4 q = __ldg(reinterpret_cast<const float4*>(src) + 1);
            v[0] = m * p.x; v[1] = m * p.y; v[2] = m * p.z; v[3] = m * p.w;
            v[4] = m * q.x; v[5] = m * q.y; v[6] = m * q.z; v[7] = m * q.w;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c + e < C) v[e] = m * src[e];
          }
        }
      }
      uint4 parts[PARTS];
      sm90::split8x3(v, parts[0], parts[1], parts[2]);
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
        *reinterpret_cast<uint4*>(a + p * kA + sm90::swz64(row, j)) = parts[p];
    }
  };
  auto finish = [&](const float (&acc)[FwdTile<BN>::kN / 2]) {
    auto out_row = [&](int r) {
      return p0 + r < npix ? static_cast<long long>(p0 + r) * Co : -1ll;
    };
    store_tile<BN>(acc, out_row, out, Co, nt * BN, nullptr, nullptr, nullptr);
  };
  run_ring<BN, PARTS, kImageChunk / 16>(smem, w_img, 9 * n_cc, w_of, produce, finish);
}

// nomap, nobcast: the shared-memory layout after dcn_fwd's ring at BN = 64
// for halo channels hc and reach R: x's halo (nh pixels x hc), the window
// weights, 1024 bytes of alignment
struct WindowLayout {
  int P, hw, nh;  // halo margin, width, pixels
  int halo, wts, bytes;
  __host__ __device__ WindowLayout(int hc, int R) {
    P = R + 1;
    hw = TW + 2 * P;
    nh = (TH + 2 * P) * hw;
    halo = FwdRing<64>::kBytes;
    wts = halo + nh * hc * 4;
    bytes = wts + 9 * 2 * MAXW * 4 + 1024;
  }
};

// nomap, nobcast: dcn_fwd's ring at BN = 64 on an 8 x 16 tile of pixels,
// stage s = (32-channel chunk, half, tap) taking HC channels (kSteps
// k-steps of the chunk's W) of tap s % 9.  The first
// stage of each channel slice stages x's halo for it (cp.async, zero off
// the map and past C) between two barriers of the producers; each stage's A
// tile is window_tile's row and column passes over the halo, with nobcast's
// tile-maximum weights or nomap's constant 0.5 (nomap's box is the same
// window at weight 0.5 a row and a column)
template <int HC>
__global__ void __launch_bounds__(kRingThreads, 1)
gemm_window_kernel(const float* __restrict__ x, const float* __restrict__ tilemax,
                   const __nv_bfloat16* __restrict__ w_img, float* __restrict__ out, int H, int W,
                   int C, int Co, int R, int tile_h, int ntiles) {
  constexpr int BN = 64;
  constexpr int kHalves = kImageChunk / HC;  // stages per (chunk, tap)
  constexpr int kSteps = HC / 16;            // wgmma k-steps per stage
  constexpr int kG = HC / 4;                 // float4 groups of a halo pixel
  const WindowLayout L(HC, R);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  float* s_halo = reinterpret_cast<float*>(smem + L.halo);
  float* s_wts = reinterpret_cast<float*>(smem + L.wts);  // (9, 2, n): wy then wx

  const int tid = threadIdx.x;
  const int P = L.P, hw = L.hw, nh = L.nh;
  const int n = 2 * R + 1;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = ((blockIdx.x / tiles_x) % tiles_y) * TH;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int nt = blockIdx.y;
  const int n_nt = gridDim.y;
  const int n_cc = (C + kImageChunk - 1) / kImageChunk;  // W's 32-channel chunks

  // the window weights of each tap, wy(k, e) then wx(k, f): nobcast's maxima
  // over the row tile that holds the block's rows, or nomap's 0.5
  for (int u = tid; u < 9 * 2 * n; u += kRingThreads)
    s_wts[u] = tilemax ? tilemax[(b * ntiles + y0 / tile_h) * 9 * 2 * n + u] : 0.5f;

  const bool xvec = (C % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  auto w_of = [&](int s) {
    const int cc = s / (9 * kHalves);
    return StageW{(static_cast<long long>(s % 9) * n_cc + cc) * n_nt + nt,
                  (s / 9) % kHalves * kSteps};
  };
  auto produce = [&](int s, uint8_t* a, int ptid) {
    const int k = s % 9;
    const int slice = s / 9;
    if (k == 0) {
      // a new channel slice: its halo, once every producer is done with the
      // old one
      sm90::named_sync<kProducerBarrier, kProducers>();
      const int c0 = slice * HC;
      for (int u = ptid; u < nh * kG; u += kProducers) {
        const int hp = u / kG;
        const int c = c0 + 4 * (u % kG);
        const int hy = y0 - P + hp / hw;
        const int hx = x0 - P + hp % hw;
        const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
        float* dst = s_halo + hp * HC + (c - c0);
        const long long src = (static_cast<long long>(b * H + hy) * W + hx) * C + c;
        if (xvec) {
          const int bytes = in ? max(0, min(16, 4 * (C - c))) : 0;
          cp_async16(dst, bytes ? x + src : x, bytes);
        } else {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (in && c + e < C) v[e] = x[src + e];
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      cp_async_wait_all();
      sm90::named_sync<kProducerBarrier, kProducers>();
    }
    window_tile<HC, 2, 2>(a, s_halo, hw, s_wts + k * 2 * n, n, R, k / 3 - 1, k % 3 - 1,
                          slice % kHalves * HC, ptid, (TH / 2) * (TW / 2) * kG, kProducers);
  };
  // A's row r is tile pixel (r / TW, r % TW)
  auto finish = [&](const float (&acc)[BN / 2]) {
    auto out_row = [&](int r) {
      const int y = y0 + r / TW, xx = x0 + r % TW;
      return y < H && xx < W ? (static_cast<long long>(b * H + y) * W + xx) * Co : -1ll;
    };
    store_tile<BN>(acc, out_row, out, Co, nt * BN, nullptr, nullptr, nullptr);
  };
  run_ring<BN, PARTS, kSteps>(smem, w_img, n_cc * kHalves * 9, w_of, produce, finish);
}

// nobcast's tile maxima: one block per (batch, row tile, tap) reduces the
// tile's tile_h x W hat maps, rows past H taken with offset 0 and mask 0 as
// the TPU kernel's padded rows
__global__ void __launch_bounds__(256)
tile_max_kernel(const float* __restrict__ offset, const float* __restrict__ mask,
                float* __restrict__ tilemax, int H, int W, int tile_h, int ntiles, int R) {
  __shared__ unsigned int s_key[2][MAXW];
  const int tid = threadIdx.x;
  const int k = blockIdx.x % 9;
  const int t = (blockIdx.x / 9) % ntiles;
  const int b = blockIdx.x / (9 * ntiles);
  const int n = 2 * R + 1;
  const float Rf = static_cast<float>(R);
  if (tid < 2 * MAXW) s_key[tid / MAXW][tid % MAXW] = to_key(-CUDART_INF_F);
  float my[MAXW], mx[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) my[i] = mx[i] = -CUDART_INF_F;
  __syncthreads();
  for (int q = tid; q < tile_h * W; q += 256) {
    const int h = t * tile_h + q / W;
    const int w = q % W;
    float oy = 0.f, ox = 0.f, m = 0.f;
    if (h < H) {
      const long long pix = (static_cast<long long>(b) * H + h) * W + w;
      const float2 o = *reinterpret_cast<const float2*>(offset + pix * 18 + 2 * k);
      oy = clampR(o.x, Rf);
      ox = clampR(o.y, Rf);
      m = mask[pix * 9 + k];
    }
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < n) {
        const float f = static_cast<float>(i - R);
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

// the dma tile: the smallest halo overhead ((th + 2P)(tw + 2P) / (th tw))
// whose blocks fill two an SM of an H100, else the most blocks; a slot holds
// one halo row's run, at most DMA_SLOT_MAX bytes where 8 columns allow
void dma_tile(int B, int H, int W, int C, int P, int& th, int& tw, int& slot) {
  double best = 1e30;
  long long best_blocks = -1;
  th = tw = 8;
  for (int h : {32, 16, 8}) {
    for (int w : {64, 32, 16, 8}) {
      if ((w + 2 * P) * C * 4 > DMA_SLOT_MAX && w > 8) continue;
      const long long blocks =
          static_cast<long long>(B) * ((H + h - 1) / h) * ((W + w - 1) / w);
      const double over = double(h + 2 * P) * (w + 2 * P) / (double(h) * w);
      const bool enough = blocks >= 2 * 132;
      const bool best_enough = best_blocks >= 2 * 132;
      if ((enough && (!best_enough || over < best)) ||
          (!enough && !best_enough && blocks > best_blocks)) {
        best = over;
        best_blocks = blocks;
        th = h;
        tw = w;
      }
    }
  }
  slot = ((tw + 2 * P) * C * 4 + 127) / 128 * 128;
}

template <typename Kernel, typename... Args>
int launch_on(Kernel kernel, dim3 grid, int threads, int bytes, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// x's halo channels a nomap or nobcast block stages at once: the larger of
// 32 and 16 whose layout fits, else 0
int halo_channels(int R) {
  for (int hc = 32; hc >= 16; hc /= 2)
    if (WindowLayout(hc, R).bytes <= kSmemLimit) return hc;
  return 0;
}

int launch_window(const float* x, const float* tm, const __nv_bfloat16* wi, float* y, int B, int H,
                  int W, int C, int Co, int R, int tile_h, int ntiles, cudaStream_t s) {
  const int hc = halo_channels(R);
  const dim3 grid(B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW), (Co + 63) / 64);
  const int threads = kRingThreads;
  const int bytes = WindowLayout(hc, R).bytes;
  if (hc == 32)
    return launch_on(gemm_window_kernel<32>, grid, threads, bytes, s, x, tm, wi, y, H, W, C, Co, R,
                     tile_h, ntiles);
  if (hc == 16)
    return launch_on(gemm_window_kernel<16>, grid, threads, bytes, s, x, tm, wi, y, H, W, C, Co, R,
                     tile_h, ntiles);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the variant on `stream` and returns the CUDA error (0 on success).
// The caller checks shapes, devices and contiguity, that every index fits in
// 32 bits and that 0 <= R <= 7; for matmul, nomap and nobcast it gives
// w_img (scratch of 9 * ceil(C/32) * ceil(Co/bn) * parts * bn * 32 bf16,
// ops/dcn_cuda.py::fwd_image_numel, parts this build's PARTS, bn 64, 128 or
// 256 as ops/dcn_cuda.py::fwd_tile_n for matmul, 64 for nomap and nobcast), which
// this lays W out into first, and for
// nobcast tilemax as (B * ntiles * 9, 2, 2R + 1) with ntiles =
// ceil(H / tile_h), tile_h a multiple of 8.
extern "C" int dcn_ablate(int variant, const void* x, const void* offset, const void* mask,
                          const void* weight, void* w_img, void* tilemax, void* out, int parts,
                          int bn, int B, int H, int W, int C, int Co, int tile_h, int ntiles,
                          int R, void* stream) {
  if (R < 0 || R > RMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* off = static_cast<const float*>(offset);
  const float* m = static_cast<const float*>(mask);
  float* y = static_cast<float*>(out);
  const int npix = B * H * W;
  if (variant == kDma) {
    int th, tw, slot;
    dma_tile(B, H, W, C, R + 1, th, tw, slot);
    const int bulk = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    // as many slots as fit, up to SLOTS; at least 2 (the ring refills the
    // slot of the row before the last)
    const int slots = bulk ? min(SLOTS, (kSmemLimit - 128) / slot) : 1;
    const int bytes = 128 + slots * slot;
    if (bulk && slots < 2) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = dma_kernel;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = B * ((H + th - 1) / th) * ((W + tw - 1) / tw);
    kernel<<<blocks, DMA_THREADS, bytes, s>>>(xf, y, H, W, C, R + 1, th, tw, slot, slots, bulk);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == kWindow || variant == kAligned) {
    const dim3 grid((npix + BM - 1) / BM, (C + BK - 1) / BK);
    if (variant == kWindow)
      sum_kernel<kWindow><<<grid, THREADS, 0, s>>>(xf, off, y, B, H, W, C, static_cast<float>(R));
    else
      sum_kernel<kAligned><<<grid, THREADS, 0, s>>>(xf, off, y, B, H, W, C, static_cast<float>(R));
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != kMatmul && variant != kNomap && variant != kNobcast)
    return static_cast<int>(cudaErrorInvalidValue);
  // matmul takes dcn_fwd's tile of output channels, nomap and nobcast 64
  if (parts != PARTS || (bn != 64 && bn != 128 && bn != 256) || (variant != kMatmul && bn != 64) ||
      (variant == kNobcast && tile_h % TH != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* wi = static_cast<__nv_bfloat16*>(w_img);
  const int groups = 9 * ((C + kImageChunk - 1) / kImageChunk) * ((Co + bn - 1) / bn) * bn * 4;
  fwd_weight_image_kernel<<<(groups + 255) / 256, 256, 0, s>>>(static_cast<const float*>(weight),
                                                              wi, C, Co, bn, 0);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (variant == kMatmul) {
    auto grid = [&](int rows) { return dim3((npix + rows - 1) / rows, (Co + bn - 1) / bn); };
    if (bn == 64)
      return launch_on(gemm_matmul_kernel<64>, grid(FwdTile<64>::kRows), kRingThreads,
                       FwdRing<64>::kBytes + 1024, s, xf, m, wi, y, B, H, W, C, Co);
    if (bn == 128)
      return launch_on(gemm_matmul_kernel<128>, grid(FwdTile<128>::kRows), kRingThreads,
                       FwdRing<128>::kBytes + 1024, s, xf, m, wi, y, B, H, W, C, Co);
    return launch_on(gemm_matmul_kernel<256>, grid(FwdTile<256>::kRows), kRingThreads,
                     FwdRing<256>::kBytes + 1024, s, xf, m, wi, y, B, H, W, C, Co);
  }
  float* tm = nullptr;
  if (variant == kNobcast) {
    tm = static_cast<float*>(tilemax);
    tile_max_kernel<<<B * ntiles * 9, 256, 0, s>>>(off, m, tm, H, W, tile_h, ntiles, R);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch_window(xf, tm, wi, y, B, H, W, C, Co, R, tile_h, ntiles, s);
}
