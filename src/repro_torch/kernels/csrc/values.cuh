// The value type of a build and what depends on it alone: the fold of two
// values in that type, the comparison of two values, and the
// delta-stepping bucket of a value (core/worklist.py bucket_index).  The
// relax kernels (relax_lanes.cuh) and the fused kernel (fused.cu) take
// these; nothing here depends on an operator's callables.
//
// The value type is int32_t in the base build and an int32 operator's;
// float where the lowered header (kernels/opgen.py) defines
// REPRO_OP_FLOAT; and the header's repro_op_val where it defines
// REPRO_OP_SUBWORD: int16_t, int8_t, uint8_t, or a bfloat16 or float16
// held as its bits (uint16_t; the header defines REPRO_OP_BF16 or
// REPRO_OP_F16 beside it and holds the conversions to and from float).
//
// Plain C++ with no CUDA header, so that the host's g++ compiles it with a
// lowered header and tests it against torch (tests/test_torch_opgen.py),
// with __host__/__device__ defined away.

#pragma once

#include <stdint.h>

#include <type_traits>

namespace relax_lanes {

#define REPRO_VALUE_FN __host__ __device__ __forceinline__

#if defined(REPRO_OP_SUBWORD)
using Val = repro_op_val;
#elif defined(REPRO_OP_FLOAT)
using Val = float;
#else
using Val = int32_t;
#endif

// combine codes (repro_torch.core.operators.KERNEL_COMBINES)
constexpr int COMB_MIN = 0;
constexpr int COMB_MAX = 1;
constexpr int COMB_ADD = 2;

constexpr int32_t VALUE_INF = 1073741823;     // core/graph.py INF

#if defined(REPRO_OP_BF16) || defined(REPRO_OP_F16)
#define REPRO_VALUE_HALF 1
// a 16-bit float to float32 (exact) and back (rounded to nearest even)
REPRO_VALUE_FN float to_float(Val v) {
#ifdef REPRO_OP_BF16
  return repro_op_bf2f(v);
#else
  return repro_op_h2f(v);
#endif
}
REPRO_VALUE_FN Val to_value(float a) {
#ifdef REPRO_OP_BF16
  return repro_op_f2bf(a);
#else
  return repro_op_f2h(a);
#endif
}
REPRO_VALUE_FN bool is_nan(Val v) {
#ifdef REPRO_OP_BF16
  return repro_op_bf_nan(v);
#else
  return repro_op_h_nan(v);
#endif
}
#elif defined(REPRO_OP_FLOAT)
REPRO_VALUE_FN float to_float(float v) { return v; }
REPRO_VALUE_FN float to_value(float a) { return a; }
#else
// int32 to the integer value type, modulo its width, as torch's .to wraps
template <class T = Val>
REPRO_VALUE_FN T wrap(int32_t a) {
  if constexpr (sizeof(T) == 4) {
    return a;
  } else {
    constexpr int32_t span = 1 << (8 * sizeof(T));
    const int32_t u = (int32_t)((uint32_t)a & (uint32_t)(span - 1));
    return (T)(std::is_signed_v<T> && u >= span / 2 ? u - span : u);
  }
}
// a // d rounded down (d > 0)
REPRO_VALUE_FN int32_t floor_div(int32_t a, int32_t d) {
  const int32_t q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}
#endif

// cur folded with cand in the value type: min and max (a 16-bit float's
// are IEEE 754-2019 minimum and maximum: -0.0 below +0.0, a NaN absorbing,
// as operators.FOLD_NAN_BITS[16]), add wrapping (integers) or rounding
// float(cur) + float(cand) to the type once (16-bit floats).  The
// sub-word fold's compare-and-swap (relax_lanes.cuh) takes it; a float32
// value folds by its atomics alone.
#ifndef REPRO_OP_FLOAT
template <int COMB>
REPRO_VALUE_FN Val fold_value(Val cur, Val cand) {
#ifdef REPRO_VALUE_HALF
  if (COMB == COMB_ADD)
    return to_value(repro_op_fadd(to_float(cur), to_float(cand)));
  if (is_nan(cur)) return cur;
  if (is_nan(cand)) return (Val)(COMB == COMB_MIN ? 0xffffu : 0x7fffu);
  const int32_t a = repro_op_key16(cand), b = repro_op_key16(cur);
  return (COMB == COMB_MIN ? a < b : a > b) ? cand : cur;
#else
  if (COMB == COMB_ADD) return wrap((int32_t)cur + (int32_t)cand);
  return (COMB == COMB_MIN ? cand < cur : cand > cur) ? cand : cur;
#endif
}
#endif

// two values differ as values: a float's -0.0 equals +0.0 and a NaN
// differs from itself
REPRO_VALUE_FN bool val_ne(Val a, Val b) {
#ifdef REPRO_VALUE_HALF
  return to_float(a) != to_float(b);
#else
  return a != b;
#endif
}

// worklist.bucket_index in the value type, as the reference computes it:
// the rank clipped to [0, INF], with INF converted to the type as the
// reference's weak-typed clip bound converts it (int32: INF; int16 and
// int8: -1, so every rank is -1 and every reflected rank 0; uint8: 255;
// float32 and bfloat16: 2^30; float16: inf); reflected as INF - rank for a
// max monoid, wrapping (integers) or rounded to the type (floats); then
// divided by delta rounding down: as int32, or by delta rounded to the
// float type, the quotient rounded to it (c10's div_floor_floating,
// repro_op_ffloordiv).  A float32 NaN rank gives INT32_MIN
// (repro_op_f2i); a 16-bit float quotient that is not finite gives 0.
template <int COMB>
REPRO_VALUE_FN int32_t bucket_of(Val v, int32_t delta) {
#if defined(REPRO_VALUE_HALF) || defined(REPRO_OP_FLOAT)
  const float hi = to_float(to_value(repro_op_i2f(VALUE_INF)));
  float r = to_float(v);
  r = r < 0.0f ? 0.0f : (r > hi ? hi : r);      // a NaN stays NaN
  if (COMB == COMB_MAX) r = to_float(to_value(repro_op_fsub(hi, r)));
  const float d = to_float(to_value(repro_op_i2f(delta)));
  const float q = to_float(to_value(repro_op_ffloordiv(r, d)));
#ifdef REPRO_VALUE_HALF
  if (repro_op_fsub(q, q) != 0.0f) return 0;
#endif
  return repro_op_f2i(q);
#else
  const int32_t hi = (int32_t)wrap(VALUE_INF);
  int32_t r = (int32_t)v < 0 ? 0 : (int32_t)v;
  r = r > hi ? hi : r;
  if (COMB == COMB_MAX) r = (int32_t)wrap(hi - r);
  return floor_div(r, delta);
#endif
}

}  // namespace relax_lanes
