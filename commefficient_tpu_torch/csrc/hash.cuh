// Counter-based hashes of the rotation count sketch, shared by the
// sketch, sketch-and-quantize and estimates kernels. Bit-identical to the JAX package's
// ops/sketch.py (_mix, _signs_row) and to the plain PyTorch versions in
// ops/sketch.py of this package: uint32 arithmetic wraps mod 2^32 here
// natively.
#pragma once
#include <stdint.h>

// murmur3 fmix32 finalizer
__device__ __forceinline__ uint32_t cet_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// the one-mix flip of row `row` from h = cet_mix32(g ^ seed), the mix
// shared by all rows of one coordinate
__device__ __forceinline__ uint32_t cet_flip_from_mix(uint32_t h, int row) {
  return ((h >> (16 + row)) & 1u) << 31;
}

// the flip of row `row` (< 8) from the packed-sign byte of a coordinate,
// whose bit `row` is bit 16+row of its one mix (the reference's
// packed_signs stream)
__device__ __forceinline__ uint32_t cet_flip_from_byte(uint8_t b, int row) {
  return ((uint32_t)b << (31 - row)) & 0x80000000u;
}

// IEEE sign-bit mask (0 or 0x80000000) of row `row`'s sign for global
// coordinate `g`. XORing a float's bits with it is multiplication by
// the row's +-1 sign, exactly (including +-0).
//   one_mix (r <= 16): bit 16+row of one mix of g ^ seed;
//   otherwise: bit 16 of a mix salted per row.
__device__ __forceinline__ uint32_t cet_sign_flip(uint32_t g, int row,
                                                  uint32_t seed,
                                                  int one_mix) {
  if (one_mix) return cet_flip_from_mix(cet_mix32(g ^ seed), row);
  return ((cet_mix32(g ^ ((uint32_t)row * 0x9E3779B9u) ^ seed) >> 16) & 1u)
         << 31;
}

__device__ __forceinline__ float cet_apply_flip(float x, uint32_t flip) {
  return __uint_as_float(__float_as_uint(x) ^ flip);
}
