// Multi-scale deformable attention forward (BEVFormer's temporal
// self-attention, spatial cross-attention and decoder cross-attention).
//
// It replaces no TPU kernel: the JAX package runs no deformable attention.
// The op and its plain PyTorch version are described in ops/msda.py.
//
// What bounds it on an H100: gathers.  A sample reads four corners of a
// head's 32 channels from a value map that, at the spatial
// cross-attention, is larger than L2; the blending is a few FLOPs a byte.
// So the kernel keeps every gathered byte useful and writes nothing but
// its output: 8 lanes own one (query, head) pair, 4 channels a lane, and a
// corner is one 8-byte (bf16) or 16-byte (f32) load a lane, 64 or 128
// contiguous bytes a pair.  The sampling locations are formed here from
// the reference points and the offsets, a query's groups (cameras or BEV
// queues), levels and points are a loop, a group whose mask is clear is
// skipped, and the sum stays in registers in f32 until one store, in the
// value's dtype.
//
// Threads: 256 a block, 32 (query, head) pairs a block; the grid covers
// queries x heads x 8 lanes.  No atomics: two launches are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 32;             // channels a head
constexpr int kVec = 4;              // channels a lane
constexpr int kLanes = kDim / kVec;  // lanes a (query, head) pair
constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];   // each level's first key
  int count;
};

__device__ __forceinline__ void load4(const float* p, float v[kVec]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// four bf16 (little-endian pairs in two words) to f32: exact
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[kVec]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float v[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[kVec]) {
  uint2 t;
  t.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  t.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = t;
}

template <typename VT>
__device__ __forceinline__ void corner(const VT* level, int y, int x, int H, int W,
                                       long long key_stride, float c, float acc[kVec]) {
  if (y < 0 || x < 0 || y >= H || x >= W) return;
  float v[kVec];
  load4(level + (static_cast<long long>(y) * W + x) * key_stride, v);
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = fmaf(c, v[i], acc[i]);
}

template <typename VT>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const VT* __restrict__ value, long long value_group, Levels lv, int heads,
                int points, const float* __restrict__ ref, long long ref_group, int anchors,
                const float* __restrict__ offsets, int off_q, int off_h, int off_g,
                const float* __restrict__ weights, int w_q, int w_h, int w_g,
                const unsigned char* __restrict__ mask, int groups, int queries, float scale,
                VT* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long pair = t / kLanes;                  // (query, head)
  if (pair >= static_cast<long long>(queries) * heads) return;
  const int lane = static_cast<int>(t % kLanes);
  const int q = static_cast<int>(pair / heads);
  const int h = static_cast<int>(pair % heads);
  const long long key_stride = static_cast<long long>(heads) * kDim;
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
  int seen = 0;
  for (int g = 0; g < groups; ++g) {
    if (mask != nullptr && !mask[static_cast<long long>(g) * queries + q]) continue;
    ++seen;
    const VT* vg = value + g * value_group + h * kDim + lane * kVec;
    const float* rg = ref + g * ref_group + static_cast<long long>(q) * anchors * 2;
    const float* og = offsets + static_cast<long long>(q) * off_q + h * off_h + g * off_g;
    const float* wg = weights + static_cast<long long>(q) * w_q + h * w_h + g * w_g;
    for (int l = 0; l < lv.count; ++l) {
      const int H = lv.h[l], W = lv.w[l];
      const float fh = static_cast<float>(H), fw = static_cast<float>(W);
      const VT* vl = vg + static_cast<long long>(lv.start[l]) * key_stride;
      for (int p = 0; p < points; ++p) {
        const int k = l * points + p;
        const int a = p % anchors;
        // ref + offset / (W_l, H_l), then the pixel: x * W_l - 0.5 (align_corners=False)
        const float x = rg[2 * a] + og[2 * k] / fw;
        const float y = rg[2 * a + 1] + og[2 * k + 1] / fh;
        const float him = y * fh - 0.5f;
        const float wim = x * fw - 0.5f;
        if (!(him > -1.f && wim > -1.f && him < fh && wim < fw)) continue;
        const float wgt = wg[k];
        const int y0 = static_cast<int>(floorf(him));
        const int x0 = static_cast<int>(floorf(wim));
        const float ly = him - y0, lx = wim - x0, hy = 1.f - ly, hx = 1.f - lx;
        corner(vl, y0, x0, H, W, key_stride, wgt * (hy * hx), acc);
        corner(vl, y0, x0 + 1, H, W, key_stride, wgt * (hy * lx), acc);
        corner(vl, y0 + 1, x0, H, W, key_stride, wgt * (ly * hx), acc);
        corner(vl, y0 + 1, x0 + 1, H, W, key_stride, wgt * (ly * lx), acc);
      }
    }
  }
  const float s = mask != nullptr ? 1.f / static_cast<float>(seen > 0 ? seen : 1) : scale;
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] *= s;
  store4(out + pair * kDim + lane * kVec, acc);
}

template <typename VT>
void launch(const void* value, long long value_group, const Levels& lv, int heads, int points,
            const float* ref, long long ref_group, int anchors, const float* offsets, int off_q,
            int off_h, int off_g, const float* weights, int w_q, int w_h, int w_g,
            const unsigned char* mask, int groups, int queries, float scale, void* out,
            cudaStream_t stream) {
  const long long threads = static_cast<long long>(queries) * heads * kLanes;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  msda_fwd_kernel<VT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const VT*>(value), value_group, lv, heads, points, ref, ref_group, anchors,
      offsets, off_q, off_h, off_g, weights, w_q, w_h, w_g, mask, groups, queries, scale,
      static_cast<VT*>(out));
}

}  // namespace

// shapes: a host array of the levels' (H_l, W_l); strides in elements.
extern "C" int msda_fwd(const void* value, int value_bf16, long long value_group,
                        const int* shapes, int levels, int heads, int points, const void* ref,
                        long long ref_group, int anchors, const void* offsets, int off_q,
                        int off_h, int off_g, const void* weights, int w_q, int w_h, int w_g,
                        const void* mask, int groups, int queries, float scale, void* out,
                        cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels || queries < 0) return cudaErrorInvalidValue;
  if (queries == 0) return cudaSuccess;
  Levels lv;
  int start = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < levels;
    lv.h[l] = used ? shapes[2 * l] : 0;
    lv.w[l] = used ? shapes[2 * l + 1] : 0;
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  lv.count = levels;
  const float* r = static_cast<const float*>(ref);
  const float* o = static_cast<const float*>(offsets);
  const float* w = static_cast<const float*>(weights);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  if (value_bf16)
    launch<__nv_bfloat16>(value, value_group, lv, heads, points, r, ref_group, anchors, o, off_q,
                          off_h, off_g, w, w_q, w_h, w_g, m, groups, queries, scale, out, stream);
  else
    launch<float>(value, value_group, lv, heads, points, r, ref_group, anchors, o, off_q, off_h,
                  off_g, w, w_q, w_h, w_g, m, groups, queries, scale, out, stream);
  return static_cast<int>(cudaGetLastError());
}
