// Every native bf16 step that K1's and K5's bf16 instances run, checked on
// the card against the plain twin's step over all 2^32 pairs of bf16 bit
// patterns.
//
// The twin (PyTorch's elementwise ops on bf16 tensors, and lerf_tpu's on
// bf16 arrays) computes each +, - and x in float32 and rounds the result to
// bf16: __float2bfloat16_rn(float(a) op float(b)).  Float32 has 24 bits of
// precision and bf16 8, and 24 >= 2 * 8 + 2, so that double rounding gives
// the correctly rounded bf16 result, which is what the native
// round-to-nearest-even instructions give in one step (add.rn.bf16x2,
// sub.rn.bf16x2, mul.rn.bf16x2 on sm_90, reached through the _rn
// intrinsics, which also forbid contraction into an FMA).  This check
// settles it on the hardware, subnormals and signed zeros included: each
// step against the twin's, bit for bit, two NaNs counting as equal.  The
// packed forms run x = (a, b), y = (b, a), so both lanes see every ordered
// pair.  ptxas emits some of the kernels' pair adds as HFMA2 with the
// multiplier 1 and some pair products as HFMA2 with the addend -0; the
// check runs those forms too (__hfma2 with a (1, 1) and a (-0, -0) operand
// read at run time, so the compiler cannot fold them): a x 1 + b and a x b
// + (-0), each one rounding, against the twin's add and product.
//
// C entry lerf_bf16_steps_exhaustive: counts [kSteps] (uint64, zeroed by
// the caller), firsts [kSteps, kMaxFirst, 4] (uint32: a, b, got, want bit
// patterns of the first mismatches found, in no fixed order), nfirst
// [kSteps] (uint32, zeroed: mismatches recorded, at most kMaxFirst).
// Step order: hadd, hsub, hmul, then lanes 0 and 1 of hadd2, hsub2, hmul2,
// hfma2 (a, 1, b) and hfma2 (a, b, -0).  Built on its own (outside the
// kernel library) by chip_smoke.py (whose BF16_STEP_NAMES name the steps)
// for its phase 50, the card tests and
// lerf_torch/tools/probe_lut_kernels.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 13;
constexpr int kMaxFirst = 8;
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ unsigned short bits(bf16 v) {
  return __bfloat16_as_ushort(v);
}

__device__ __forceinline__ bool is_nan(unsigned short v) {
  return (v & 0x7fffu) > 0x7f80u;
}

// The twin's step: float32, then rounded to bf16.
__device__ __forceinline__ unsigned short twin(int op, unsigned short a,
                                               unsigned short b) {
  const float x = __bfloat162float(__ushort_as_bfloat16(a));
  const float y = __bfloat162float(__ushort_as_bfloat16(b));
  const float r = op == 0 ? __fadd_rn(x, y)
                          : (op == 1 ? __fsub_rn(x, y) : __fmul_rn(x, y));
  return bits(__float2bfloat16_rn(r));
}

__device__ __forceinline__ void note(int step, unsigned short a,
                                     unsigned short b, unsigned short got,
                                     unsigned short want,
                                     unsigned long long& count,
                                     unsigned* firsts, unsigned* nfirst) {
  if (got == want || (is_nan(got) && is_nan(want))) return;
  ++count;
  const unsigned k = atomicAdd(nfirst + step, 1u);
  if (k < kMaxFirst) {
    unsigned* f = firsts + (step * kMaxFirst + k) * 4;
    f[0] = a;
    f[1] = b;
    f[2] = got;
    f[3] = want;
  }
}

// Block a: operand a = blockIdx.x, b over all 65536 patterns.
// one_bits, neg_zero_bits: the pairs (1, 1) and (-0, -0), as kernel
// parameters.
__global__ void __launch_bounds__(kThreads) steps_kernel(
    unsigned long long* counts, unsigned* firsts, unsigned* nfirst,
    unsigned one_bits, unsigned neg_zero_bits) {
  const bf162 one = __halves2bfloat162(__ushort_as_bfloat16(one_bits),
                                       __ushort_as_bfloat16(one_bits >> 16));
  const bf162 neg_zero = __halves2bfloat162(
      __ushort_as_bfloat16(neg_zero_bits),
      __ushort_as_bfloat16(neg_zero_bits >> 16));
  const unsigned short a = (unsigned short)blockIdx.x;
  const bf16 ha = __ushort_as_bfloat16(a);
  unsigned long long n[kSteps] = {};
  for (unsigned bb = threadIdx.x; bb < 65536u; bb += kThreads) {
    const unsigned short b = (unsigned short)bb;
    const bf16 hb = __ushort_as_bfloat16(b);
    const unsigned short ab[3] = {twin(0, a, b), twin(1, a, b),
                                  twin(2, a, b)};
    const unsigned short ba[3] = {twin(0, b, a), twin(1, b, a),
                                  twin(2, b, a)};
    note(0, a, b, bits(__hadd_rn(ha, hb)), ab[0], n[0], firsts, nfirst);
    note(1, a, b, bits(__hsub_rn(ha, hb)), ab[1], n[1], firsts, nfirst);
    note(2, a, b, bits(__hmul_rn(ha, hb)), ab[2], n[2], firsts, nfirst);
    const bf162 x = __halves2bfloat162(ha, hb);
    const bf162 y = __halves2bfloat162(hb, ha);
    const bf162 r[5] = {__hadd2_rn(x, y), __hsub2_rn(x, y),
                        __hmul2_rn(x, y), __hfma2(x, one, y),
                        __hfma2(x, y, neg_zero)};
    const int twin_op[5] = {0, 1, 2, 0, 2};
#pragma unroll
    for (int op = 0; op < 5; ++op) {
      note(3 + 2 * op, a, b, bits(__low2bfloat16(r[op])), ab[twin_op[op]],
           n[3 + 2 * op], firsts, nfirst);
      note(4 + 2 * op, b, a, bits(__high2bfloat16(r[op])), ba[twin_op[op]],
           n[4 + 2 * op], firsts, nfirst);
    }
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    unsigned long long v = n[s];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(counts + s, v);
  }
}

}  // namespace

extern "C" int lerf_bf16_steps_exhaustive(void* counts, void* firsts,
                                          void* nfirst, void* stream) {
  steps_kernel<<<65536, kThreads, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)counts, (unsigned*)firsts, (unsigned*)nfirst,
      0x3f803f80u, 0x80008000u);
  return (int)cudaGetLastError();
}
