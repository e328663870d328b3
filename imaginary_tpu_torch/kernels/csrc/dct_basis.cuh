// The scaled IDCT bases of imaginary_tpu/ops/stages.py:_idct_basis(k) for
// k = 1, 2, 4, 8, bit for bit (the f32 words XLA's cos and sqrt give), at
// [log2 k][u * k + x]; kernels/reference.py `_IDCT_BASIS_BITS` holds the
// same words for the plain versions. K11 (from_dct.cu) reads all four,
// K12 (to_dct.cu) the 8-point one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__constant__ uint32_t kIdctBasisBits[4][64] = {
    // k = 1
    {
        0x3eb504f3u,
    },
    // k = 2
    {
        0x3eb504f3u, 0x3eb504f3u, 0x3eb504f3u, 0xbeb504f3u,
    },
    // k = 4
    {
        0x3eb504f3u, 0x3eb504f3u, 0x3eb504f3u, 0x3eb504f3u, 0x3eec835du, 0x3e43ef15u,
        0xbe43ef18u, 0xbeec835fu, 0x3eb504f2u, 0xbeb504f2u, 0xbeb504f1u, 0x3eb504f7u,
        0x3e43ef15u, 0xbeec835du, 0x3eec835fu, 0xbe43ef25u,
    },
    // k = 8
    {
        0x3eb504f3u, 0x3eb504f3u, 0x3eb504f3u, 0x3eb504f3u, 0x3eb504f3u, 0x3eb504f3u,
        0x3eb504f3u, 0x3eb504f3u, 0x3efb14beu, 0x3ed4db31u, 0x3e8e39d9u, 0x3dc7c5bcu,
        0xbdc7c5c2u, 0xbe8e39dcu, 0xbed4db32u, 0xbefb14bfu, 0x3eec835eu, 0x3e43ef15u,
        0xbe43ef18u, 0xbeec8360u, 0xbeec835eu, 0xbe43ef0bu, 0x3e43ef1bu, 0x3eec835fu,
        0x3ed4db31u, 0xbdc7c5c2u, 0xbefb14bfu, 0xbe8e39d6u, 0x3e8e39ddu, 0x3efb14beu,
        0x3dc7c5b1u, 0xbed4db34u, 0x3eb504f3u, 0xbeb504f3u, 0xbeb504f1u, 0x3eb504f7u,
        0x3eb504f3u, 0xbeb504fbu, 0xbeb504efu, 0x3eb504f4u, 0x3e8e39d9u, 0xbefb14bfu,
        0x3dc7c5c8u, 0x3ed4db2du, 0xbed4db34u, 0xbdc7c5bbu, 0x3efb14bfu, 0xbe8e39e4u,
        0x3e43ef15u, 0xbeec835eu, 0x3eec835fu, 0xbe43ef25u, 0xbe43ef06u, 0x3eec835bu,
        0xbeec8362u, 0x3e43ef25u, 0x3dc7c5bcu, 0xbe8e39d6u, 0x3ed4db2du, 0xbefb14bdu,
        0x3efb14c1u, 0xbed4db31u, 0x3e8e39e9u, 0xbdc7c614u,
    },
};

// _idct_basis(k)[u, x] for k = 1 << lk
__device__ __forceinline__ float idct_basis(int lk, int u, int x) {
  return __uint_as_float(kIdctBasisBits[lk][(u << lk) + x]);
}
