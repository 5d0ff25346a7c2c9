// Hopper (sm_90a) building blocks shared by the DCN kernels that run their
// products on the tensor cores: wgmma on bf16 operands in shared memory with
// f32 accumulators in registers, the 128-byte swizzled tile layout wgmma reads,
// the split of an f32 value into two bf16 parts, mbarriers and bulk copies.
//
// The tile layout.  A matrix stored for wgmma is cut into column chunks of 64
// bf16 (128 bytes, one swizzle row); a chunk of R rows occupies R * 128 bytes,
// row r at r * 128, its 16-byte group j at ((j ^ (r % 8)) * 16): the
// Swizzle<3,4,3> pattern of wgmma's 128B mode.  Chunk bases are 1024-byte
// aligned, so the pattern follows from the address bits as the hardware
// applies it.  Read with the rows as M or N and the 64 columns as K
// ("K-major", transpose flag 0), 8-row groups lie 1024 bytes apart (SBO) and
// the k-th 16-wide slice starts 32 k bytes in.  Read with the rows as K and
// the columns as M or N ("MN-major", flag 1), 8 K-rows lie 1024 bytes apart
// (SBO), the next 64 columns one chunk (R * 128 bytes) on (LBO), and the k-th
// 16-deep slice starts 2048 k bytes in.
//
// The 64-byte mode (dcn_fwd's stages: chunks of 32 bf16 columns, 64 bytes a
// row) is the same with 4 groups a row: group j of row r at ((j ^ ((r / 2) %
// 4)) * 16), the Swizzle<2,4,3> pattern; 8-row groups lie 512 bytes apart
// (SBO) and the k-th 16-wide slice of a K-major chunk starts 32 k bytes in.
//
// The split.  v = hi + lo with hi = bf16(v) and lo = bf16(v - hi), both
// rounded to nearest: hi + lo keeps about 16 significant bits of v (the rest
// is below 2^-17 |v|).  A product a b is taken as a_hi b_hi + a_hi b_lo +
// a_lo b_hi (three wgmma passes, f32 accumulation); what is dropped is below
// about 2^-16 |a b|.  The three-part split v = hi + mid + lo keeps about 24
// bits, and six passes (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid) drop
// less than about 2^-25 |a b|: the f32 class.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRowBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row r, 16-byte group j) inside a swizzled chunk
__device__ __forceinline__ int swz(int r, int j) { return r * kRowBytes + ((j ^ (r & 7)) << 4); }

// byte offset of (row r, 16-byte group j) inside a 64-byte swizzled chunk
__device__ __forceinline__ int swz64(int r, int j) { return r * 64 + ((j ^ ((r >> 1) & 3)) << 4); }

// wgmma shared-memory descriptor, 128-byte swizzle (mode 1) or, with
// kMode 2, 64-byte swizzle
template <int kMode = 1>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(kMode) << 62;
  return d;
}
// K-major, 64-byte swizzle: 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t desc64(uint32_t addr) { return desc<2>(addr, 16, 512); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// the accumulators as operands the compiler may not move across a wgmma
template <int kN>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// generic-proxy writes to shared memory made visible to wgmma and bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// one arrival on the barrier (release: the caller's shared-memory writes
// before it are seen by a thread whose wait sees the phase complete)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the warpgroup's registers a thread to kRegs (a multiple of 8 in 24..256);
// every thread of the warpgroup executes it
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// a barrier of kThreads threads (whole warps) under the named barrier kId
// (0 is __syncthreads')
template <int kId, int kThreads>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "n"(kThreads) : "memory");
}

// wait until the phase of parity `parity` has completed; traps (a launch
// error the host sees) instead of hanging if it never does.  Every lane of
// the calling warp must call it: the lanes leave the poll at different
// times and meet again before returning, as the .sync.aligned wgmma
// instructions that follow need a converged warp
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
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
  __syncwarp();
}

// one bulk copy global -> shared, completing `bytes` on the barrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 f32 values -> three bf16 parts, 16 bytes each: hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid), each rounded to nearest; hi + mid +
// lo keeps about 24 significant bits of v (all of an f32 but the last)
__device__ __forceinline__ void split8x3(const float* v, uint4& hi, uint4& mid, uint4& lo) {
  uint32_t h[4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hb);
    const float r0 = v[2 * i] - hf.x, r1 = v[2 * i + 1] - hf.y;
    const __nv_bfloat162 mb = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(mb);
    const __nv_bfloat162 lb = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
    h[i] = *reinterpret_cast<const uint32_t*>(&hb);
    m[i] = *reinterpret_cast<const uint32_t*>(&mb);
    l[i] = *reinterpret_cast<const uint32_t*>(&lb);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  mid = make_uint4(m[0], m[1], m[2], m[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// 8 f32 values -> their bf16 hi parts and (with kLo) lo parts, 16 bytes each
template <bool kLo>
__device__ __forceinline__ void split8(const float* v, uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    h[i] = *reinterpret_cast<const uint32_t*>(&hb);
    if constexpr (kLo) {
      const float2 hf = __bfloat1622float2(hb);
      const __nv_bfloat162 lb = __floats2bfloat162_rn(v[2 * i] - hf.x, v[2 * i + 1] - hf.y);
      l[i] = *reinterpret_cast<const uint32_t*>(&lb);
    } else {
      l[i] = 0u;
    }
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// D(64x64 f32, registers) += A(64x16) B(16x64), A and B bf16 in shared memory
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// D(64x128 f32, registers) += A(64x16) B(16x128), A and B bf16 in shared memory
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// D(64x256 f32, registers) += A(64x16) B(16x256), A and B bf16 in shared memory
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// D += A B, or with scale_d 0 D = A B (D's old values are not read)
template <int kN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma(float* d, uint64_t desc_a, uint64_t desc_b,
                                      int scale_d = 1) {
  static_assert(kN == 64 || kN == 128 || kN == 256, "wgmma width");
  if constexpr (kN == 64) wgmma_m64n64<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
  else if constexpr (kN == 128) wgmma_m64n128<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
  else wgmma_m64n256<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
}

}  // namespace sm90
