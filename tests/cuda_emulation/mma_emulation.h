// CPU emulation of `bbx_mma_k16` (bbx_torch/csrc/mma.cuh), the tensor-core
// product of K8: each thread computes its own four outputs of every tile --
// rows g and g + 8, columns 2t and 2t + 1 -- as float32 sums over k of the
// bf16 operands, read from the addresses the card loads them from.  It
// checks the kernel's operand addressing and weight layout, not mma's
// register fragments.
#pragma once

inline float bbx_emulated_bf16(unsigned short bits) {
    const unsigned u = (unsigned)bits << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

template <int MT, int NT, bool B_LDM, bool DEF = false, class AF, class BF>
inline void bbx_mma_k16(float (&c)[MT][NT][4], const AF& a, const BF& b, int mt, int nt) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    for (int i = 0; i < MT && i < mt; ++i) {
        for (int j = 0; j < NT && j < nt; ++j) {
            for (int h = 0; h < 2; ++h) {
                const unsigned short* lo = a(i, g, h);
                const unsigned short* hi = a(i, g + 8, h);
                const unsigned short* b0 = b(j, h, 2 * t);
                const unsigned short* b1 = b(j, h, 2 * t + 1);
                for (int k = 0; k < 8; ++k) {
                    const float x0 = bbx_emulated_bf16(lo[k]), x1 = bbx_emulated_bf16(hi[k]);
                    const float y0 = bbx_emulated_bf16(b0[k]), y1 = bbx_emulated_bf16(b1[k]);
                    c[i][j][0] += x0 * y0;
                    c[i][j][1] += x0 * y1;
                    c[i][j][2] += x1 * y0;
                    c[i][j][3] += x1 * y1;
                }
            }
        }
    }
}
