// K3's bf16 instance: the SRUnit (micro-net) ensemble of one stage in
// lerf_tpu's bf16 compute type — every mode x 4 rotations, sampling
// included — on Hopper's wgmma, for sm_90a.
//
// Replaces: lerf_tpu/ops/pallas/srnet_kernel.py, _ensemble_sum_flat (the
// pl.pallas_call at :94) with _make_kernel at compute_dtype = bfloat16,
// which lerf_tpu/models/srnet.py:223-227 takes for bf16 heads. For each
// pixel it computes  sum_m rint(tanh(W6.[h1..h5] + b6) * half)  with
// h1 = bf16(relu(W1.x4_m + b1)), hk = bf16(relu(Wk.[h1..hk-1] + bk)),
// x4_m the member's 4 edge-clamped samples rounded to bf16 (to nearest
// even), products of bf16 values summed in float32, and the biases, tanh,
// rint and the member sum in float32.
//
// What bounds it on the H100: the multiply-adds, one bf16 tensor-core pass:
// 6.9e11 flop a 3 x 360 x 640 stage at nf 64 (12 members), 0.70 ms at 989
// Tflop/s. The image, the weights and the sums are a few MB.
//
// What the design does about it:
// - Warp roles. A block is three warpgroups: warpgroup 0 the producer (one
//   thread issues the weight copies; setmaxnreg lowers it to 40 registers a
//   thread), warpgroups 1 and 2 the consumers (setmaxnreg raises them to
//   232 at run time; ptxas still holds each thread's code to the launch
//   bound's 168, which is why the wide sums below take two passes). A
//   consumer owns half the tile's pixel rows for the whole chain: layer
//   l + 1 reads only what its own warpgroup wrote, so a 128-thread named
//   barrier orders them, not the block.
// - Tile. 256 pixels where the activations fit (padded nf <= 64): 128 rows
//   a warpgroup, two m64 wgmmas a k-step sharing B; 128 pixels above (one
//   m64 a warpgroup). The weight ring takes what shared memory the tile
//   leaves, in 16 KB slots (at most 8). At nf 64: activations 256 x 320 x
//   2 B = 160 KB, samples 8 KB, 3 slots (48 KB), 1 KB to align, barriers:
//   222,256 B; at nf 128: 160 KB + 4 KB + 3 slots: 218,160 B; under the
//   232,448-byte opt-in (Shape::kSmem; smem_bytes on the host).
// - Products. wgmma.mma_async m64nNk16 bf16 x bf16 -> float32, A (the
//   activations) and B (a weight chunk) both read from shared memory
//   through descriptors: N = the layer's outputs (n128 / n64 / n32 / n16 /
//   n8 pieces where it is no power of two), N = 8 for the head (oC 1 or 3,
//   zero-padded), layer 1's 4 inputs padded to one k16 step.
// - Layouts. Both operands K-major with a swizzle. The activation tile is
//   k-blocks of WB feature columns, each block all the tile's rows in
//   8-row atoms: WB = 64 (128-byte swizzle) where padded nf is a multiple
//   of 64 (nf 64, 128), 32 (64-byte) where it is a multiple of 32, else 16
//   (32-byte). Each layer's segment is whole blocks, so no width pads its
//   segments to the 128-byte atom (no extra multiply-adds); the smaller
//   swizzles cost bank conflicts in the epilogue's stores (nf 16-48 and
//   80-112 only). The samples are one 32-byte-swizzled block of 16
//   columns, 4 used.
// - Epilogue. Bias, then ReLU and bf16 in one conversion
//   (cvt.rn.relu.bf16x2), from the accumulator registers into segment l
//   with stmatrix (four 8 x 8 matrices a store), then
//   fence.proxy.async.shared::cta and the warpgroup's barrier before the
//   next wgmma reads the tile: without the fence the tensor core may read
//   stale activations.
// - Weights. The host lays out each (member, layer) as the exact shared
//   memory image the B descriptor reads, swizzle applied (StackedHeads.
//   frags, bf16_images). A chunk is whole k-blocks of one layer (of one
//   pass's rows: contiguous in the image), at most 16 KB; the producer
//   brings it in with bulk copies (cp.async.bulk ... mbarrier::complete_tx
//   ::bytes, no tensor map) into the ring, with full and empty mbarriers.
//   A layer's chunks are multiplied as they land; a slot goes back once
//   the products of its chunk are done.
// - No cluster. Two blocks a cluster, each chunk multicast to both, would
//   halve the weight bytes read from L2, but the copies do not bound the
//   kernel (without them it runs 2 % faster) and the cluster measured
//   slower at every width (PERF.md): each block copies its own.
// - Sums. Up to nf 64 the tensor core sums a layer's whole fan-in. Above,
//   where the fan-in reaches 512, that sum drifts further from float32's:
//   more activations land on the other side of a bf16 rounding edge than
//   the callers' bound allows. There each hidden layer runs in two passes
//   over halves of its outputs (acc: 32 registers), and each chunk's
//   products (8 k-steps at nf 128) are summed from zero into a second set
//   (32 registers) and added to acc with IEEE adds.
// - Sampling. Each consumer thread gathers its pixel's 4 samples of the
//   next member while this member's layers run and stores them after
//   layer 5.
// - A barrier wait longer than 2 s traps, so a lost arrive fails the launch
//   instead of hanging the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 20;          // 5 modes x 4 rotations
constexpr int kSlotBytes = 16384;        // a weight ring slot
constexpr int kMaxStages = 8;            // ring slots, as shared memory allows
constexpr int kWideTile = 256;           // pixels a block up to nf 64
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr unsigned long long kWaitLimitNs = 2000000000ull;

// The choices made by padded nf (lerf_torch/tools/probe_srnet_kernels.py
// --bf16 times the others, and the kernel with each part taken out).
constexpr int kPassesWide = 2;           // hidden layers above nf 64: passes
                                         //   over halves of the outputs
constexpr bool kChunkSumsNarrow = false; // each chunk's products summed from
constexpr bool kChunkSumsWide = true;    //   zero ("Sums"), up to nf 64 / above

struct Members {
  int n;
  int off[kMaxMembers][8];               // (row, col) x 4 roles, rotated
};

struct Weights {  // layer k: the images bf16_images lays out, b [M, out]
  const __nv_bfloat16* w[6];
  const float* b[6];
};

// One instance's layout; NFP = nf padded to 16.
template <int NFP>
struct Shape {
  static constexpr int kTile = NFP <= 64 ? kWideTile : 128;  // pixels
  static constexpr int kPasses = NFP <= 64 ? 1 : kPassesWide;
  static constexpr int kNp = NFP / kPasses;             // outputs a pass
  static constexpr bool kChunkSums =
      NFP <= 64 ? kChunkSumsNarrow : kChunkSumsWide;
  static constexpr int kRows = kTile / 2;               // a consumer's
  static constexpr int kMt = kRows / 64;                // its m64 tiles
  static constexpr int kWb = NFP % 64 == 0 ? 64 : NFP % 32 == 0 ? 32 : 16;
  static constexpr int kRowB = 2 * kWb;                 // bytes a block row
  static constexpr int kSegBlocks = NFP / kWb;          // blocks a segment
  static constexpr int kActBlock = kTile * kRowB;       // bytes a block
  static constexpr int kAct = 5 * kSegBlocks * kActBlock;
  static constexpr int kX4 = kTile * 32;
  // the ring takes what the tile leaves of the opt-in (232,448 B), less
  // 1 KB to align and the barriers
  static constexpr int kFree = 232448 - 1024 - kAct - kX4 - 16 * kMaxStages;
  static constexpr int kStages =
      kFree / kSlotBytes < kMaxStages ? kFree / kSlotBytes : kMaxStages;
  static constexpr int kSmem =
      1024 + kStages * kSlotBytes + kAct + kX4 + 16 * kStages;

  // layer l (0..4 hidden, 5 the head) as B: the width of a k-block, its
  // rows (N), the k-blocks and the bytes of one; its passes, the rows and
  // bytes of a k-block a pass reads (the pass's rows are contiguous, in
  // 8-row atoms), and how many such parts fill a chunk
  __host__ __device__ static constexpr int wb(int l) {
    return l == 0 ? 16 : kWb;
  }
  __host__ __device__ static constexpr int rows(int l) {
    return l < 5 ? NFP : 8;
  }
  __host__ __device__ static constexpr int blocks(int l) {
    return l == 0 ? 1 : l * NFP / kWb;
  }
  __host__ __device__ static constexpr int block_bytes(int l) {
    return rows(l) * 2 * wb(l);
  }
  __host__ __device__ static constexpr int passes(int l) {
    return l < 5 ? kPasses : 1;
  }
  __host__ __device__ static constexpr int part_bytes(int l) {
    return rows(l) / passes(l) * 2 * wb(l);
  }
  __host__ __device__ static constexpr int per_chunk(int l) {
    return kSlotBytes / part_bytes(l);
  }
  // the swizzle code of a k-block of width w (descriptor bits 62-63)
  __host__ __device__ static constexpr int swz(int w) {
    return w == 64 ? 1 : w == 32 ? 2 : 3;
  }
};

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<I>{}), .., f(Int<N - 1>{})
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Int<I>{});
    static_for<I + 1, N>(f);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait for the completion of the barrier's phase of this parity; trap
// after kWaitLimitNs: a lost arrive ends in __trap(), a sticky error that
// ends the process's CUDA context (every later call in it fails), not a
// hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  unsigned long long start = 0;
  for (unsigned spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 1024 == 0) {
      const unsigned long long now = global_ns();
      if (start == 0)
        start = now;
      else if (now - start > kWaitLimitNs)
        __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive, and expect this many bytes of copies before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// bytes from global memory to shared memory, the barrier told of their
// arrival
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void proxy_fence() {
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

// keep the compiler from moving accesses of accumulators across the
// asynchronous products
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int MT, int K>
__device__ __forceinline__ void fence_regs(float (&d)[MT][K]) {
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[t][i])::"memory");
}

// A shared-memory matrix descriptor: start address, stride between 8-row
// groups (SBO), swizzle; the leading offset is unused by the swizzled
// K-major layouts (one k16 step never crosses a swizzle atom).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo,
                                              int swz) {
  return (uint64_t)(addr >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swz << 62);
}

// D[64 x n] (+)= A[64 x 16] . B[16 x n], registers as the PTX accumulator
// fragment: d[v] is row 16 warp + lane / 4 + 8 ((v / 2) % 2), column
// 8 (v / 4) + 2 (lane % 4) + v % 2 of the warpgroup's 64 rows.
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x N] from output column OFF on, as pieces of 128, 64, 32, 16 or 8
// columns; b8 is the B descriptor's step for 8 of its rows (outputs).
template <int N, int OFF = 0, int ND>
__device__ __forceinline__ void mma(float (&d)[ND], uint64_t a, uint64_t b,
                                    uint64_t b8, int scale_d) {
  constexpr int P = N >= 128 ? 128 : N >= 64 ? 64 : N >= 32 ? 32
                                               : N >= 16 ? 16 : 8;
  auto& part = *reinterpret_cast<float(*)[P / 2]>(&d[OFF / 2]);
  if constexpr (P == 128)
    wgmma_n128(part, a, b, scale_d);
  else if constexpr (P == 64)
    wgmma_n64(part, a, b, scale_d);
  else if constexpr (P == 32)
    wgmma_n32(part, a, b, scale_d);
  else if constexpr (P == 16)
    wgmma_n16(part, a, b, scale_d);
  else
    wgmma_n8(part, a, b, scale_d);
  if constexpr (N > P) mma<N - P, OFF + P>(d, a, b + (P / 8) * b8, b8, scale_d);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16(relu(lo)), bf16(relu(hi)) (to nearest even; lo in the low half) in
// one conversion: the ReLU of the rounded value is the rounded ReLU
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// four (x4) or two (x2) 8 x 8 bf16 matrices, each in the accumulator
// fragment's layout (lane l: row l / 4, columns 2 (l % 4) ..), to the rows
// whose addresses lanes 8 k .. 8 k + 7 give for matrix k
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(a), "r"(b), "r"(c), "r"(d)
      : "memory");
}

__device__ __forceinline__ void stmatrix_x2(uint32_t addr, uint32_t a,
                                            uint32_t b) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(
          addr),
      "r"(a), "r"(b)
      : "memory");
}

// NFP: nf padded to 16
template <int OC, int NFP>
__global__ void __launch_bounds__(kThreads, 1) srnet_bf16_wgmma_kernel(
    const float* __restrict__ img,       // [C, H, W] float32
    float* __restrict__ out,             // [C, H, W, OC] float32
    const Members mem, const Weights wt, int C, int H, int W, int nf,
    float half) {
  using S = Shape<NFP>;
  constexpr int kTile = S::kTile, kRows = S::kRows, kMt = S::kMt;
  constexpr int kStages = S::kStages;
  constexpr int kRowB = S::kRowB, kWb = S::kWb;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // the swizzles' atoms
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t ring = base;                    // [kStages][kSlotBytes]
  const uint32_t act = ring + kStages * kSlotBytes;  // [5 NFP / WB] blocks
  const uint32_t x4 = act + S::kAct;             // [kTile][16] bf16
  const uint32_t bars = x4 + S::kX4;             // full[kStages], empty[..]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const long long total = (long long)C * H * W;
  const long long base_px = (long long)blockIdx.x * kTile;

  // the samples' block: columns 4..15 stay zero
  for (int i = threadIdx.x; i < S::kX4 / 16; i += kThreads)
    *reinterpret_cast<uint4*>(smem + (x4 - base) + 16 * i) =
        make_uint4(0u, 0u, 0u, 0u);
  proxy_fence();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);                     // the producer's arrive
      mbar_init(empty(s), 8);                    // every consumer warp's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: the weight chunks in the order the consumers take
    // them (member, layer, first k-block); one warp, lane 0 issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const bool issuer = threadIdx.x == 0;
      int c = 0;
      for (int m = 0; m < mem.n; ++m)
        for (int l = 0; l < 6; ++l) {
          const int bb = S::block_bytes(l), nb = S::blocks(l);
          const int pb = S::part_bytes(l), per = S::per_chunk(l);
          const uint8_t* src = reinterpret_cast<const uint8_t*>(wt.w[l]) +
                               (size_t)m * nb * bb;
          for (int p = 0; p < S::passes(l); ++p)
            for (int kb0 = 0; kb0 < nb; kb0 += per, ++c) {
              const int slot = c % kStages;
              if (c >= kStages)
                mbar_wait(empty(slot), (c / kStages - 1) & 1);
              const int n = min(per, nb - kb0);
              if (issuer) {
                mbar_expect_tx(full(slot), n * pb);
                // the chunk: one contiguous range for a single pass, else
                // the pass's part of each of its k-blocks
                const bool whole = S::passes(l) == 1;
                for (int k = 0; k < (whole ? 1 : n); ++k)
                  bulk_copy(ring + slot * kSlotBytes + k * pb,
                            src + (size_t)(kb0 + k) * bb + p * pb,
                            whole ? n * pb : pb, full(slot));
              }
              __syncwarp();
            }
        }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = (threadIdx.x >> 7) - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
    const int row0 = w * kRows;                  // the warpgroup's rows
    const uint32_t bar_id = 1 + w;
    auto wg_sync = [&]() {
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    };

    // the samples: thread t < kRows gathers tile row row0 + t (a pixel
    // past the end repeats the last one and is not written)
    const bool sampler = t < kRows;
    const int xr = row0 + (sampler ? t : 0);
    const long long n = min(base_px + xr, total - 1);
    const int j = (int)(n % W);
    const long long ci = n / W;
    const int i = (int)(ci % H);
    const float* xc = img + (ci / H) * (long long)H * W;
    float xv[4];
    auto gather = [&](int m) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = min(max(i + mem.off[m][2 * k], 0), H - 1);
        const int cc = min(max(j + mem.off[m][2 * k + 1], 0), W - 1);
        xv[k] = xc[r * W + cc];
      }
    };
    // row xr's first 16 bytes (columns 0..7) in the 32-byte swizzle
    uint4* const x4_row = reinterpret_cast<uint4*>(
        smem + (x4 - base) + (xr >> 3) * 256 + (xr & 7) * 32 +
        (((xr & 7) >> 2) << 4));
    auto put_samples = [&]() {          // rounded to bf16, as lerf_tpu casts
      if (sampler)
        *x4_row = make_uint4(bf16x2_bits(xv[0], xv[1]),
                             bf16x2_bits(xv[2], xv[3]), 0u, 0u);
    };

    // the epilogue's stmatrix: this lane gives the address of row lane % 8
    // of matrix lane / 8 (its h = bit 0, its second column block = bit 1),
    // rows row0 + 64 tt + 16 warp + 8 h + lane % 8; the row's offset in a
    // k-block and its swizzle
    const int sm_h = (lane >> 3) & 1, sm_j = lane >> 4, sm_r = lane & 7;
    uint32_t sm_rowoff[kMt];
#pragma unroll
    for (int tt = 0; tt < kMt; ++tt) {
      const int r = row0 + 64 * tt + 16 * warp + 8 * sm_h + sm_r;
      sm_rowoff[tt] = (r >> 3) * 8 * kRowB + (r & 7) * kRowB;
    }
    const uint32_t sm_sw = ((sm_r * kRowB) >> 7) & (kRowB / 16 - 1);

    // give a ring slot back: every consumer warp arrives
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(slot));
    };

    int c = 0;                                   // chunks taken so far
    // layer l's products for a pass (N outputs; the chunks hold that
    // pass's rows of B) into acc[kMt][N / 2], chunk by chunk as they land
    auto products = [&](auto& acc, auto n_tag, int l) {
      constexpr int N = decltype(n_tag)::value;
      // each chunk summed from zero, then added with IEEE adds (not the
      // head's 8 outputs: its sums round rarely to another level)
      constexpr bool kSums = S::kChunkSums && N != 8;
      const int nb = S::blocks(l), per = S::per_chunk(l);
      const int wbl = S::wb(l), ks = wbl / 16;
      const uint32_t pb = S::part_bytes(l), sbo = 16 * wbl;
      const int swz = S::swz(wbl);
      const uint64_t b8 = sbo >> 4;
      // A: the samples for layer 1, else the tile's k-blocks
      const uint32_t a0 = l == 0 ? x4 + (row0 >> 3) * 256
                                 : act + (row0 >> 3) * 8 * kRowB;
      const uint32_t a_block = l == 0 ? 0 : S::kActBlock;
      const uint32_t a_mt = 8 * sbo;             // 64 rows further
      float tmp[kMt][N / 2];
      int prev = -1;
      for (int kb0 = 0; kb0 < nb; kb0 += per) {
        const int slot = c % kStages;
        mbar_wait(full(slot), (c / kStages) & 1);
        const uint32_t chunk = ring + slot * kSlotBytes;
        const int nbk = min(per, nb - kb0);
        if (kSums || kb0 == 0) wgmma_fence();
        for (int b = 0; b < nbk; ++b)
          for (int s = 0; s < ks; ++s) {
            const uint64_t bd = make_desc(chunk + b * pb + 32 * s, sbo, swz);
            const uint32_t aa = a0 + (kb0 + b) * a_block + 32 * s;
#pragma unroll
            for (int tt = 0; tt < kMt; ++tt) {   // scale-d 0: a sum's first
              const uint64_t ad = make_desc(aa + tt * a_mt, sbo, swz);
              if constexpr (kSums)
                mma<N>(tmp[tt], ad, bd, b8, b | s);
              else
                mma<N>(acc[tt], ad, bd, b8, (kb0 + b) | s);
            }
          }
        wgmma_commit();
        if constexpr (kSums) {
          wgmma_wait<0>();
          fence_regs(tmp);
          fence_regs(acc);
#pragma unroll
          for (int tt = 0; tt < kMt; ++tt)
#pragma unroll
            for (int v = 0; v < N / 2; ++v)
              acc[tt][v] = kb0 == 0 ? tmp[tt][v] : acc[tt][v] + tmp[tt][v];
          fence_regs(acc);
          release(slot);
        } else {
          // the slot goes back once the next chunk's products are issued
          // and its own are done
          if (prev >= 0) {
            wgmma_wait<1>();
            release(prev);
          }
          prev = slot;
        }
        ++c;
      }
      if constexpr (!kSums) {
        wgmma_wait<0>();
        fence_regs(acc);
        release(prev);
      }
    };

    float sum[kMt][4];                           // member sums, head layout
#pragma unroll
    for (int tt = 0; tt < kMt; ++tt)
#pragma unroll
      for (int v = 0; v < 4; ++v) sum[tt][v] = 0.0f;

    gather(0);
    put_samples();
    proxy_fence();
    wg_sync();
    for (int m = 0; m < mem.n; ++m) {
      if (m + 1 < mem.n) gather(m + 1);
      for (int l = 0; l < 5; ++l) {
        static_for<0, S::kPasses>([&](auto p_tag) {
          constexpr int p = decltype(p_tag)::value, kNp = S::kNp;
          // the biases of the columns this thread writes (p kNp + 8 jj +
          // 2 q + e), loaded before the products; after them where the
          // sums take a second accumulator set (registers)
          float bv[kNp / 8][2];
          auto load_biases = [&]() {
#pragma unroll
            for (int jj = 0; jj < kNp / 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = p * kNp + 8 * jj + 2 * q + e;
                bv[jj][e] = col < nf ? __ldg(wt.b[l] + m * nf + col) : 0.0f;
              }
          };
          if constexpr (!S::kChunkSums) load_biases();
          float acc[kMt][kNp / 2];
          products(acc, Int<kNp>{}, l);
          if constexpr (S::kChunkSums) load_biases();
          // bias, ReLU, bf16 (to nearest even) into segment l: the 8 x 8
          // matrix (h, jj) is rows 8 h .. of the warp's 16, columns
          // p kNp + 8 jj .., as stmatrix takes it from the accumulators
          auto packed = [&](int tt, int jj, int h) {
            return relu_bf16x2(acc[tt][4 * jj + 2 * h] + bv[jj][0],
                               acc[tt][4 * jj + 2 * h + 1] + bv[jj][1]);
          };
#pragma unroll
          for (int tt = 0; tt < kMt; ++tt)
#pragma unroll
            for (int jj = 0; jj < kNp / 8; jj += 2) {
              const int cb = p * kNp + 8 * (jj + sm_j);
              const uint32_t addr =
                  act + l * S::kSegBlocks * S::kActBlock +
                  (cb / kWb) * S::kActBlock + sm_rowoff[tt] +
                  ((((cb % kWb) >> 3) ^ sm_sw) << 4);
              if (jj + 1 < kNp / 8)
                stmatrix_x4(addr, packed(tt, jj, 0), packed(tt, jj, 1),
                            packed(tt, jj + 1, 0), packed(tt, jj + 1, 1));
              else
                stmatrix_x2(addr, packed(tt, jj, 0), packed(tt, jj, 1));
            }
        });
        if (l == 4) put_samples();      // the next member's, for its layer 1
        proxy_fence();                  // generic stores -> the tensor core
        wg_sync();
      }
      // the head: columns 2 q, 2 q + 1 of rows g, g + 8
      float hb[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        hb[e] = 2 * q + e < OC ? __ldg(wt.b[5] + m * OC + 2 * q + e) : 0.0f;
      float hacc[kMt][4];
      products(hacc, Int<8>{}, 5);
#pragma unroll
      for (int tt = 0; tt < kMt; ++tt)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (2 * q + (v & 1) < OC)
            sum[tt][v] += rintf(tanhf(hacc[tt][v] + hb[v & 1]) * half);
    }
#pragma unroll
    for (int tt = 0; tt < kMt; ++tt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int col = 2 * q + (v & 1);
        const long long p =
            base_px + row0 + 64 * tt + 16 * warp + g + 8 * (v >> 1);
        if (col < OC && p < total) out[p * OC + col] = sum[tt][v];
      }
  }
}

template <int OC, int NFP>
int launch(const float* img, float* out, const Members& mem,
           const Weights& wt, int C, int H, int W, int nf, float half,
           cudaStream_t stream) {
  using S = Shape<NFP>;
  static_assert(S::kStages >= 2 && S::kSmem <= 232448,
                "a block's shared memory over the opt-in");
  const auto kernel = srnet_bf16_wgmma_kernel<OC, NFP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)C * H * W;
  const long long blocks = (total + S::kTile - 1) / S::kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, S::kSmem, stream>>>(
      img, out, mem, wt, C, H, W, nf, half);
  return (int)cudaGetLastError();
}

template <int OC>
int launch_nf(const float* img, float* out, const Members& mem,
              const Weights& wt, int C, int H, int W, int nf, float half,
              cudaStream_t stream) {
#define LERF_NFP(n) \
  case n:           \
    return launch<OC, n>(img, out, mem, wt, C, H, W, nf, half, stream);
  switch ((nf + 15) & ~15) {
    LERF_NFP(16)
    LERF_NFP(32)
    LERF_NFP(48)
    LERF_NFP(64)
    LERF_NFP(80)
    LERF_NFP(96)
    LERF_NFP(112)
    LERF_NFP(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LERF_NFP
}

}  // namespace

// members: host int32 [M, 8] rotated offsets; w*: device bf16 weight images
// (StackedHeads.frags, bf16_images); b*: device float32 [M, out].
extern "C" int lerf_srnet_ensemble_bf16(
    const void* img, void* out, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* w5, const void* w6,
    const void* b1, const void* b2, const void* b3, const void* b4,
    const void* b5, const void* b6, const void* members, int M, int C, int H,
    int W, int nf, int oc, float half, void* stream) {
  if (M < 1 || M > kMaxMembers || nf < 1 || nf > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * H * W == 0) return 0;
  Members mem = {};
  mem.n = M;
  const int* src = (const int*)members;
  for (int m = 0; m < M; ++m)
    for (int k = 0; k < 8; ++k) mem.off[m][k] = src[m * 8 + k];
  const void* ws[6] = {w1, w2, w3, w4, w5, w6};
  const void* bs[6] = {b1, b2, b3, b4, b5, b6};
  Weights wt;
  for (int k = 0; k < 6; ++k) {
    wt.w[k] = (const __nv_bfloat16*)ws[k];
    wt.b[k] = (const float*)bs[k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (oc) {
    case 1:
      return launch_nf<1>((const float*)img, (float*)out, mem, wt, C, H, W,
                          nf, half, s);
    case 3:
      return launch_nf<3>((const float*)img, (float*)out, mem, wt, C, H, W,
                          nf, half, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
