// Compressed-gossip passes for Hopper (sm_90a).
//
// Three elementwise kernels, each replacing one Pallas TPU kernel of
// repro/kernels/compress.py:
//
//   cmp_gamma_correct       gamma_correct (_gamma_correct_kernel): the
//                           CHOCO/EF post-exchange correction
//                           out = x + gamma*(mixed - anchor) over the packed
//                           tree; reads 3 and writes 1 fp32 per element,
//                           16 bytes
//   cmp_threshold_mask_group
//                           threshold_mask (_threshold_mask_kernel): top-k's
//                           mask and residual on each [rows, f] leaf of a
//                           message, q = x*[|x| >= thr_row], r = x - q;
//                           reads 1 and writes 2, 12 bytes per element
//   cmp_quantize_dequantize_group
//                           quantize_dequantize (_qdq_kernel): QSGD's
//                           stochastic quantize -> dequantize and residual on
//                           each [rows, f] leaf with uniform noise u; reads 2
//                           and writes 2, 16 bytes per element
//
// Bound on this card: device-memory bandwidth.  Each does a handful of
// fp32 operations per element (gamma_correct 3, threshold_mask 3,
// quantize_dequantize 9) against 12-16 bytes, far below the ~20
// operations per byte at which the card's fp32 rate would bind.  What the
// design does about it: one pass, each input read once and each output
// written once; the per-row scalar (threshold or scale) is read once per
// tile of a row, gamma rides as a launch argument.
//
// Design:
//   * gamma_correct is launch3 of elementwise.cuh (1-D grid-stride, masked
//     tail, float4 iff every pointer is 16-byte aligned);
//   * the two row-wise kernels are launch_rowwise_group: one launch takes
//     every leaf of a message (up to kMaxLeaves, the leaf table passed by
//     value), since most leaves of a model are too small to be more than a
//     launch's fixed cost; every row of a leaf whose streams share their
//     address modulo 16 bytes (any contiguous leaf from an aligned base)
//     runs on float4 between a head peeled to a 128-byte (or, to compare,
//     16-byte) boundary and a masked tail whatever its width, each thread
//     with two float4 of each input in flight, issued before the row's
//     scalar is bound; the grid fills the card over the whole group.
//     Nothing is padded to the reference's TILE;
//   * every product, sum and quotient is an explicit round-to-nearest
//     intrinsic in the Pallas body's order, and levels/s and s/levels are
//     true divisions (__fdiv_rn), as the plain PyTorch versions in
//     repro_torch/kernels/ref.py compute them;
//   * the scale is clamped to 1e-12 (a zero row quantizes to zero) and xi to
//     levels (u just under 1 cannot round past the top level).  sign(x) is
//     +1, -1 or +0, as torch.sign gives it.

#include "elementwise.cuh"

namespace {

struct GammaCorrect {
  float gamma;  // the resolved consensus step size, folded to fp32

  __device__ __forceinline__ void operator()(float x, float mixed,
                                             float anchor, float& out,
                                             float&) const {
    out = __fadd_rn(x, __fmul_rn(gamma, __fsub_rn(mixed, anchor)));
  }
  __device__ __forceinline__ GammaCorrect bind() const { return *this; }
};

struct ThresholdMask {
  struct Bound {
    float thr;
    __device__ __forceinline__ void operator()(float x, float, float& q,
                                               float& r) const {
      q = fabsf(x) >= thr ? x : 0.0f;  // ties at the threshold are kept
      r = __fsub_rn(x, q);
    }
  };
  __device__ __forceinline__ Bound bind(float thr) const { return {thr}; }
};

struct QuantizeDequantize {
  float levels;  // L = 2^bits - 1

  struct Bound {
    float up, down, levels;  // L/s and s/L
    __device__ __forceinline__ void operator()(float x, float u, float& q,
                                               float& r) const {
      const float y = __fmul_rn(fabsf(x), up);
      float xi = floorf(__fadd_rn(y, u));
      if (xi > levels) xi = levels;
      const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
      q = __fmul_rn(__fmul_rn(sgn, xi), down);
      r = __fsub_rn(x, q);
    }
  };
  __device__ __forceinline__ Bound bind(float scale) const {
    const float s = isnan(scale) ? scale : fmaxf(scale, 1e-12f);
    return {__fdiv_rn(levels, s), __fdiv_rn(s, levels), levels};
  }
};

}  // namespace

extern "C" {

// out = x + gamma*(mixed - anchor) over n elements.
int cmp_gamma_correct(const float* x, const float* mixed, const float* anchor,
                      float* out, int64_t n, float gamma, void* stream) {
  return launch3(x, mixed, anchor, out, nullptr, n, GammaCorrect{gamma},
                 stream);
}

// q = |x| >= thr[row] ? x : 0, r = x - q on each leaf x [rows, f] of a
// table of n leaves (launch_rowwise_group's layout; u is null).
int cmp_threshold_mask_group(const int64_t* table, int n, int64_t tiles,
                             void* stream) {
  return launch_rowwise_group(table, n, tiles, ThresholdMask{}, stream);
}

// QSGD on each leaf x, u [rows, f] with its scale [rows]; q the dequantized
// value, r = x - q.
int cmp_quantize_dequantize_group(const int64_t* table, int n, int64_t tiles,
                                  float levels, void* stream) {
  return launch_rowwise_group(table, n, tiles, QuantizeDequantize{levels},
                              stream);
}

// The row-wise launch geometry, for the wrapper to hold its own copy of it
// against: out = {kTileVecs, kTile, kMaxLeaves, kLeafFields}.
int cmp_rowwise_geometry(int64_t* out) {
  out[0] = kTileVecs;
  out[1] = kTile;
  out[2] = kMaxLeaves;
  out[3] = kLeafFields;
  return 0;
}

const char* cmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
