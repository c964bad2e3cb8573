// Shared definitions of the limb kernels: 16-bit limbs held in int64
// tensors, one thread per lane, lane rows addressed by an element stride
// (0 for a broadcast [1, w] constant row).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LIMB_MASK 0xFFFFu
#define LIMB_BITS 16
#define THREADS_PER_BLOCK 256

// BN254 scalar-field modulus p as 17 little-endian 16-bit limbs (top limb 0)
__constant__ uint32_t c_p17[17] = {
    0x0001, 0xf000, 0xf593, 0x43e1, 0x7091, 0x79b9, 0xe848, 0x2833, 0x585d,
    0x8181, 0x45b6, 0xb850, 0xa029, 0xe131, 0x4e72, 0x3064, 0x0000};

// Barrett constant mu = floor(2^512 / p), 259 bits, 17 limbs
__constant__ uint32_t c_mu17[17] = {
    0x9259, 0xe1de, 0x3a6b, 0x2070, 0x0ae6, 0x9e88, 0x5200, 0x1448, 0x0147,
    0x8073, 0xa586, 0xb074, 0x4a7a, 0x23a0, 0x4626, 0x4a47, 0x0005};

// limb k of a lane row of width n, zero beyond the row (the JAX package's
// pad_limbs)
__device__ __forceinline__ uint32_t limb_at(const int64_t* row, int k, int n) {
  return k < n ? (uint32_t)row[k] : 0u;
}

static inline unsigned int grid_for(long long batch) {
  return (unsigned int)((batch + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK);
}
