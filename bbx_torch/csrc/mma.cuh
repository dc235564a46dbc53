// The tensor-core product of K8 (evaluator.cu): one k16 step of a warp's
// tile of mt x nt mma tiles, bf16 operands, float32 accumulators.
//
//   c[i][j][0..3] += A_i (16 x 16) . B_j (16 x 8),  i < mt <= MT, j < nt <= NT
//
// Thread `lane` of the warp (g = lane / 4, t = lane % 4) owns the outputs
// of rows g and g + 8 at columns 2t and 2t + 1, in mma's order: c[i][j][0]
// = (g, 2t), [1] = (g, 2t + 1), [2] = (g + 8, 2t), [3] = (g + 8, 2t + 1).
// The operands are given by where they lie, as bf16 bit patterns
// (unsigned short):
//   a(i, row, half): the 8 contiguous k values (half 0: k 0-7, 1: k 8-15)
//     of row `row` of A_i, in shared memory, 16-byte aligned;
//   b(j, half, col): the 8 contiguous k values of column `col` of B_j; with
//     B_LDM in shared memory and 16-byte aligned, otherwise anywhere and
//     4-byte aligned.
//
// On the card the operands are loaded with ldmatrix (A; B with B_LDM) or a
// 4-byte load a lane, then multiplied with `mma.sync.m16n8k16`.  With DEF
// the fragments of the tiles past mt and nt are set to 0 rather than left
// unwritten: ptxas cannot see that their products are skipped by the same
// bounds, and keeps an unwritten fragment's register live from the
// kernel's entry (the backward's kernel, at its register limit, spills for
// it).  Under
// BBX_EMULATE the CPU emulation computes the same sums from the same
// addresses in float32 (tests/cuda_emulation/mma_emulation.h): it checks
// the addressing of the operands but not mma's register fragments, which
// only the card-only tests check.
#pragma once

#ifdef BBX_EMULATE
#include "mma_emulation.h"
#else
__device__ __forceinline__ unsigned bbx_smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

template <int MT, int NT, bool B_LDM, bool DEF = false, class AF, class BF>
__device__ __forceinline__ void bbx_mma_k16(float (&c)[MT][NT][4], const AF& a, const BF& b,
                                            int mt, int nt) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    // A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
    // are mma's a0..a3; lane l gives row l % 16 of matrix l / 8.
    unsigned ar[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        if (i < mt) {
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                : "=r"(ar[i][0]), "=r"(ar[i][1]), "=r"(ar[i][2]), "=r"(ar[i][3])
                : "r"(bbx_smem_addr(a(i, lane & 15, lane >> 4)))
                : "memory");
        } else if constexpr (DEF) {
            ar[i][0] = ar[i][1] = ar[i][2] = ar[i][3] = 0;
        }
    }
    // B: b0 = (k 2t, 2t + 1; column g), b1 = (k 8 + 2t, 9 + 2t; column g).
    unsigned br[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        if (j < nt) {
            if (B_LDM) {
                if (j % 2 == 0) {
                    // Matrices (B_j, half 0), (B_j, 1), (B_j+1, 0), (B_j+1, 1);
                    // with no B_j+1, .x2 reads the first two (lanes 0-15).
                    const int m = lane >> 3;
                    const unsigned p = bbx_smem_addr(b(j + (m >> 1), m & 1, lane & 7));
                    unsigned r0, r1, r2 = 0, r3 = 0;
                    if (j + 1 < nt) {
                        asm volatile(
                            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                            : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                            : "r"(p)
                            : "memory");
                    } else {
                        asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                                     : "=r"(r0), "=r"(r1)
                                     : "r"(p)
                                     : "memory");
                    }
                    br[j][0] = r0;
                    br[j][1] = r1;
                    if (j + 1 < NT) {
                        br[j + 1][0] = r2;
                        br[j + 1][1] = r3;
                    }
                }
            } else {
                br[j][0] = *(const unsigned*)(b(j, 0, g) + 2 * t);
                br[j][1] = *(const unsigned*)(b(j, 1, g) + 2 * t);
            }
        } else if constexpr (DEF) {
            br[j][0] = br[j][1] = 0;
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            if (i < mt && j < nt) {
                asm volatile(
                    "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                    "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                    : "+f"(c[i][j][0]), "+f"(c[i][j][1]), "+f"(c[i][j][2]), "+f"(c[i][j][3])
                    : "r"(ar[i][0]), "r"(ar[i][1]), "r"(ar[i][2]), "r"(ar[i][3]),
                      "r"(br[j][0]), "r"(br[j][1]));
            }
        }
    }
}
#endif
