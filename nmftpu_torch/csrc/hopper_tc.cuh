// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (dual_numer.cu, mips_reservoir.cu, count_above.cu; the scans' staging
// steps are in tc_scan.cuh): shared-memory operand layout and
// wgmma descriptors, cp.async with zero fill, the async-proxy fence, and
// the three warpgroup matrix products the kernels issue.
//
// Operand layout. wgmma reads both operands from shared memory, K-major
// (the contracted index contiguous), in the no-swizzle "core matrix"
// layout: a core matrix is 8 rows x 16 bytes stored as 128 contiguous
// bytes; core matrices adjacent along K are 128 bytes apart (the
// descriptor's leading byte offset, LBO), and 8-row groups are
// 8 * kbytes apart (the stride byte offset, SBO), where kbytes is the
// tile's depth in bytes. A tile of `rows` x `kbytes` is rows * kbytes
// contiguous bytes; cm_offset gives the byte of (row, k). The first 64
// rows of a tile start at byte 0, the next 64 at 64 * kbytes, and one
// 32-byte step of depth (a k32 int8 or k16 bf16 product) is 256 bytes.
//
// Accumulator fragment of a 64 x N product (int32 or float32, N / 2
// registers a thread): register i of lane l in warp w of the warpgroup
// holds row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4)
// + i % 2.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nmftpu_tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ __forceinline__ uint32_t cm_offset(int row, int kb,
                                                       int kbytes) {
  return ((row >> 3) * (kbytes >> 4) + (kb >> 4)) * 128u + (row & 7) * 16u +
         (kb & 15);
}

// Descriptor of a K-major no-swizzle tile of depth `kbytes` whose first
// row and depth step start at shared address `saddr` (16-byte aligned).
// The next 32-byte depth step's descriptor is this one + DESC_STEP.
constexpr uint64_t DESC_STEP = 256 >> 4;

__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, int kbytes) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((8 * kbytes) >> 4) << 32);
}

// Copy N = 4, 8 or 16 bytes global -> shared; bytes at and beyond `valid`
// are written as zero and not read (valid = 0 reads nothing). src must
// be N-byte aligned.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int valid) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(valid)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the 16 bytes at src[0, 16) into shared dst (16-byte aligned),
// zero from `valid` on, with the widest copy the source alignment `g`
// allows (16, 8 or 4 bytes asynchronously; 1: byte loads and one
// synchronous 16-byte store). When valid = 0, src may be any readable
// address aligned to g.
__device__ __forceinline__ void copy16(uint8_t* dst, const int8_t* src,
                                       int valid, int g) {
  const uint32_t d = smem_u32(dst);
  if (g == 16) {
    cp_async<16>(d, src, valid);
  } else if (g == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = min(max(valid - 8 * h, 0), 8);
      cp_async<8>(d + 8 * h, v ? src + 8 * h : src, v);
    }
  } else if (g == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int v = min(max(valid - 4 * h, 0), 4);
      cp_async<4>(d + 4 * h, v ? src + 4 * h : src, v);
    }
  } else {
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      w[h] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * h + b;
        const uint32_t byte = e < valid ? static_cast<uint8_t>(src[e]) : 0u;
        w[h] |= byte << (8 * b);
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Shared-memory writes by threads (st.shared, cp.async) become visible to
// the tensor cores' async proxy only after this fence (then a barrier).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait (the products land there asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The products: d (64 x N) = A · Bᵀ (+ d when `accumulate`), A the 64-row
// tile at descriptor da, B the N-row tile at db, over one 32-byte depth
// step. No .satfinite: int32 sums wrap modulo 2^32, as XLA's do.

__device__ __forceinline__ void wgmma_s8_m64n256k32(
    int (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_m64n32k32(
    int (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_m64n64k16(
    float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

}  // namespace nmftpu_tc
