// Integer tensor-core building blocks shared by qmatmul.cu and fitness.cu.
//
// mma.sync.m16n8k32 on 8-bit operands (int32 accumulation, exact), the
// ldmatrix and cp.async forms that feed it from shared memory, and a 4 x 4
// byte transpose. Fragment layouts (PTX ISA, "Matrix fragments for
// mma.m16n8k32"), with g = lane / 4 and t = lane % 4:
//   A (16 x 32, row): a0 = A[g][4t..4t+3], a1 = A[g+8][4t..4t+3],
//                     a2 = A[g][16+4t..], a3 = A[g+8][16+4t..]
//   B (32 x 8, col):  b0 = B[4t..4t+3][g], b1 = B[16+4t..16+4t+3][g]
//   C (16 x 8):       c0, c1 = C[g][2t], C[g][2t+1]; c2, c3 = row g + 8
// Four consecutive k bytes of one row (A) or one column (B) form one 32-bit
// register, lowest k in the lowest byte, so an operand stored with k
// contiguous loads each register with one 32-bit read or, 16 bytes of k by
// 8 rows at a time, with ldmatrix (b16 view: lane l holds bytes 4(l%4)..+3
// of row l/4 of each 8 x 16-byte matrix).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `bytes` (0..16) are read and
// the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16 x 32 unsigned bytes) * b (32 x 8 signed bytes)
__device__ __forceinline__ void mma_u8s8(int32_t (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 32 signed bytes) * b (32 x 8 signed bytes)
__device__ __forceinline__ void mma_s8s8(int32_t (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// r[i] holds bytes (i, 0..3) of a 4 x 4 byte block; afterwards r[j] holds
// bytes (0..3, j): the block transposed.
__device__ __forceinline__ void transpose4x4(uint32_t (&r)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(lo01, lo23, 0x5410);
  r[1] = __byte_perm(lo01, lo23, 0x7632);
  r[2] = __byte_perm(hi01, hi23, 0x5410);
  r[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Four bytes p[0..3], the ones at or past `valid` read as zero.
__device__ __forceinline__ uint32_t load_bytes4(const uint8_t* p, int valid,
                                                int stride = 1) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < valid) v |= static_cast<uint32_t>(p[i * stride]) << (8 * i);
  return v;
}

}  // namespace repro
