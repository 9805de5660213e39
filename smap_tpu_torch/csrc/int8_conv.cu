// int8_conv_kernel: one convolution of the int8 serving forward, the whole
// int8 branch of the JAX package's Conv2D in one launch:
//   xq  = clip(round_half_even(float(x) / s_x), -127, 127)   (x bf16 or f32)
//   acc = sum over taps and channels of xq * wq               (exact, int32)
//   out = relu?(cast(float(acc) * (s_x * kscale[co]) + bias[co]))
// NHWC activations in, int8 weights, bf16 or float32 NHWC out. An int8
// instance of the same kernel takes activations already quantized (x int8)
// and skips the quantize.
//
// This is not a port of a TPU kernel: the JAX package runs this convolution
// outside Pallas, as lax.conv_general_dilated with int8 operands and int32
// sums (smap_tpu/models/layers.py, Conv2D's int8 branch). PyTorch has no
// int8 convolution on CUDA, so the port brings its own. The quantize of the
// input lives here too: the kernel reads the bf16 activation as the previous
// layer wrote it, and no int8 copy of it is ever stored.
//
// What bounds it on an H100: at the forward's shapes, bytes: the bf16 input
// (2 bytes an element, read once), the int8 weights and the bf16 output,
// 8.3 ms a forward at 3.35 TB/s (chip_smoke.py phase 7); only the 3x3
// convs with 256-512 channels at the smallest maps and the 2048-wide 1x1
// convs are bound by int8 operations (1,979 TOPS). Inside the kernel the
// quantize is the costly part: each element of the implicit GEMM's A (9 per
// input element for a 3x3 conv, once per tile of N) is rounded on the CUDA
// cores. The design:
//
// - An implicit GEMM: M = output pixels, N = output channels, K = taps x
//   channels (tap-major, channel-minor, Cin padded to a multiple of 4 by
//   the wrapper). A block computes 128 x BN of the output, BN = 8, 16, 48,
//   64, 128 or 256 chosen from Cout (the heads' 1, 14 and 43 take 8, 16 and
//   48; the wide convs 256), and walks its tiles persistently (one block an
//   SM, tiles N-fastest), so that one tile's epilogue overlaps the next
//   tile's loads.
// - Two producer warps and two consumer warpgroups around a 4-stage ring,
//   a stage 128 rows of 128 bytes of A (64 bf16 channels, 32 float, 128
//   int8) with the 16-byte chunks of row r at chunk ^ (r & 7), and the
//   stage's weights. When a stage lies inside one tap (Cin a multiple of
//   128 bytes: every conv of the forward but the stem) one thread brings it
//   with one TMA load in im2col mode: 128 consecutive output pixels'
//   128-byte pieces at the tap's offset, zeros outside the image (the
//   padding) and past the last image (ragged M), the conv's stride as the
//   traversal stride. Else (the stem: 3 channels padded to 4, 8 bytes a
//   pixel in bf16, below TMA's 16-byte pieces) both warps gather A with
//   cp.async through a table, built once per block, of each piece of K's
//   tap and channel, neighbouring threads on neighbouring bytes. The
//   weights come by one bulk copy. All complete on the stage's mbarrier.
// - The consumers quantize as they load: each warpgroup owns 64 rows; each
//   thread reads its wgmma A fragment (rows g and g + 8 of its warp's 16,
//   4 + 4 bytes of K at 4q and 16 + 4q of each 32-byte K step) from the
//   staged bf16, quantizes it in registers and runs register-A
//   `wgmma.mma_async.m64nBNk32.s32.s8.s8` against the weights in shared
//   memory; the two warpgroups overlap one's quantize with the other's
//   product. Register A rather than an int8 tile in shared memory: the
//   quantized values never go back to shared memory, and no barrier stands
//   between quantize and product. Within a warpgroup the two do not
//   overlap: a register-A product in flight pins registers the compiler
//   may reuse, and a double-buffered int8 tile in shared memory costs more
//   in stores and barriers than the overlap saves.
// - The quantize is bit-equal to the plain version's IEEE division: t =
//   x * fl(1 / s_x) lies within 3 ulps of fl(x / s_x), so their roundings
//   agree unless t lies within |t| / 2^19 of a half-integer below 256; only
//   there does the lane divide (__fdiv_rn). Beyond 256 both clip. The rounding to an
//   integer, half to even, is an add of 1.5 * 2^23 (exact below 2^22), the
//   clip a min and max in that shifted range, and the int8 value its low
//   byte: no conversion instructions.
// - The weights are packed once on the host (ops/int8_conv.py,
//   pack_int8_weights) as [Cout / BN][K / 32][BN][32] int8 blocks, rows
//   past Cout and K past kh kw Cin zero, the two 16-byte halves of a row
//   swapped every 4 rows: the 32-byte swizzle that the K-major wgmma
//   descriptor reads (SBO 256 bytes), so a stage's weights are one
//   contiguous bulk copy. Every K step of a stage is multiplied: past K, A
//   is zero.
// - The epilogue dequantizes in the JAX package's order, each step rounded
//   on its own: float(acc) (round to nearest), times s_x * kscale[co], plus
//   bias[co], cast with round to nearest even (two outputs a conversion),
//   then the ReLU, and stores straight from the registers. s_x is read from
//   the device: no host round trip for the dynamic scale. The result is bit-equal to
//   int8_conv2d_plain(quantize_activation(x, s_x), ...).
// - Built without fast math (-fmad=false too): the divisions, products and
//   sums stay IEEE round-to-nearest.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // output pixels a tile
constexpr int kRowBytes = 128;           // bytes of A a row and stage
constexpr int kAStage = kBM * kRowBytes;
constexpr int kStages = 4;
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kProducers = 64;           // two warps
constexpr int kThreads = kConsumers + kProducers;
constexpr int kMaxSmem = 232448;         // an H100 block's limit

template <int BN>
struct Acc {
  int d[BN / 2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A K-major wgmma descriptor for the weights: 32-byte swizzle, 8-row groups
// 256 bytes apart (the leading offset is unused with a swizzle).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16)
       | (16ull << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// (accumulators, register A) across the fence and the wait that order them.
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs4(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// Waits for the phase of parity `parity` of `bar` to complete. A load that
// never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// cp.async of G bytes (4, 8 or 16); ok == false fills zeros, reads nothing.
template <int G>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const int n = ok ? G : 0;
  if (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(n) : "memory");
  else if (G == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 ::"r"(dst), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(dst), "l"(src), "r"(n) : "memory");
}
// One arrival on `bar` once this thread's earlier cp.asyncs have landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}
// Expect `bytes` more on `bar` (one arrival).
__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// One bulk copy of `bytes` contiguous bytes, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// One TMA load in im2col mode: 128 pixels of 128 bytes, from byte c of the
// pixel, the traversal starting at (w, h, n) and read at the tap's offsets
// (dw, dh); zeros outside the tensor. Completes on `bar`.
__device__ __forceinline__ void tma_im2col(uint32_t dst,
                                           const CUtensorMap* map,
                                           uint32_t bar, int c, int w, int h,
                                           int n, uint16_t dw, uint16_t dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], "
      "{%7, %8};\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(dw), "h"(dh)
      : "memory");
}

// Register-A wgmma, s8 x s8 -> s32, m64 x N x k32: a[0..3] is the
// thread's A fragment (rows g and g + 8 of its warp's 16, bytes 4q and
// 16 + 4q of K), db the weights' descriptor; `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_rs_s8(Acc<8>& c, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  int* d = c.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_s8(Acc<16>& c, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  int* d = c.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_s8(Acc<48>& c, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  int* d = c.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_s8(Acc<64>& c, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  int* d = c.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_s8(Acc<128>& c, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  int* d = c.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_s8(Acc<256>& c, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  int* d = c.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// 1.5 * 2^23: for |t| < 2^22, t + kShift is kShift + t rounded to an
// integer, half to even, and its low byte is that integer's.
constexpr float kShift = 12582912.0f;

// clip(round_half_even(q), -127, 127) as the low byte of the result, from
// tm = q + kShift.
__device__ __forceinline__ int clip_byte(float tm) {
  return __float_as_int(fminf(fmaxf(tm, kShift - 127.0f), kShift + 127.0f));
}

// Four values v quantized into one register (v[0] in the low byte): by
// t = v * r, r = fl(1 / s), unless t lies within |t| / 2^19 of a tie below
// 256, where the lane divides (see the header note). Rounding by adding
// kShift keeps the conversion units out of it; past |t| = 2^22 the sum is
// no longer exact, but it still clips.
__device__ __forceinline__ uint32_t quantize4(const float* v, float s,
                                              float r) {
  int b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = __fmul_rn(v[i], r);
    const float tm = __fadd_rn(t, kShift);
    const float d = __fsub_rn(t, __fsub_rn(tm, kShift));     // t - rint(t)
    const float at = fabsf(t);
    b[i] = clip_byte(tm);
    if (at < 256.0f &&
        fabsf(__fsub_rn(fabsf(d), 0.5f)) <= __fmul_rn(at, 0x1p-19f))
      b[i] = clip_byte(__fadd_rn(__fdiv_rn(v[i], s), kShift));
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// The four values of A at bytes [off, off + 4 sizeof(T)) of stage row `row`
// (off a multiple of 4 sizeof(T)), as floats (T bf16 or float).
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* stage, int row,
                                      int off, float* v) {
  const int chunk = (off >> 4) ^ (row & 7);
  const unsigned char* p = stage + row * kRowBytes + (chunk << 4) + (off & 15);
  if constexpr (sizeof(T) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// One register of the A fragment: the four int8 values at bytes [off, off +
// 4 sizeof(T)) of stage row `row`, quantized unless T is int8.
template <typename T>
__device__ __forceinline__ uint32_t load_a(const unsigned char* stage,
                                           int row, int off, float s,
                                           float r) {
  if constexpr (sizeof(T) == 1) {
    const int chunk = (off >> 4) ^ (row & 7);
    return *reinterpret_cast<const uint32_t*>(
        stage + row * kRowBytes + (chunk << 4) + (off & 15));
  } else {
    float v[4];
    load4<T>(stage, row, off, v);
    return quantize4(v, s, r);
  }
}

// The dequantized value of one sum, before the cast: float(acc) (round to
// nearest), times s_x * kscale, plus bias, each rounded on its own.
__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// Two neighbouring outputs as bf16x2: the cast (round to nearest even),
// then the ReLU as fmaxf on the cast value, as PyTorch's relu on CUDA
// (clamp_min) computes it.
__device__ __forceinline__ uint32_t to_bf16x2(float v0, float v1,
                                              bool relu) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  if (relu) {
    const float lo = fmaxf(__uint_as_float(u << 16), 0.0f);
    const float hi = fmaxf(__uint_as_float(u & 0xffff0000u), 0.0f);
    u = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
  return u;
}

struct Params {
  const unsigned char* x;     // [B, H, W, cin] NHWC of T
  const int8_t* w;            // pack_int8_weights
  const float* kscale;
  const float* sx;
  const float* bias;
  void* out;                  // [M, cout] f32 or bf16
  int M, B, H, W, cin_bytes, Ho, Wo, cout, kh, kw, stride, pad;
  int kpad;                   // K of the weights, a multiple of 32
  int ktrue_bytes;            // kh * kw * cin bytes of A
  int nst;                    // stages of K a tile
  int piece;                  // bytes of a gathered piece
  int fast;                   // a stage lies inside one tap
  int ntn, tiles, relu, out_f32;
};

template <typename T, int BN>
struct Cfg {
  static constexpr int kCh = kRowBytes / sizeof(T);  // K a stage
  static constexpr int kSteps = kCh / 32;            // wgmma K steps a stage
  static constexpr int kBStage = kSteps * BN * 32;
  static constexpr int kBars = kStages * (kAStage + kBStage);
  static constexpr int kRows = kBars + 2 * kStages * 8;  // 2 row tables
  static constexpr int kTable = kRows + 2 * kBM * 16;
};

// The pieces of one stage of A that producer thread t brings: piece u = t %
// (128 / G) of rows t / (128 / G) + k (64 G / 128), all 128 rows in all,
// so that neighbouring threads read neighbouring bytes of a row. e is the
// piece's (dh << 24) | (dw << 16) | byte offset in the pixel, or -1 past K;
// rows holds each row's (top input row, left input column, first pixel of
// its image).
template <int G>
__device__ __forceinline__ void gather_stage(const Params& p, uint32_t dst,
                                             const int4* rows, int e, int t) {
  constexpr int kPerRow = kRowBytes / G, kStep = kProducers / kPerRow;
  const int u = t % kPerRow, off = u * G;
  const int dh = e >> 24, dw = (e >> 16) & 0xff, cb = e & 0xffff;
#pragma unroll 4
  for (int row = t / kPerRow; row < kBM; row += kStep) {
    const int4 ri = rows[row];
    const int hi = ri.x + dh, wi = ri.y + dw;
    const bool ok = e >= 0 && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
    const unsigned char* src =
        ok ? p.x + ((long long)ri.z + (long long)hi * p.W + wi) * p.cin_bytes
                 + cb
           : p.x;
    cp_async<G>(dst + row * kRowBytes
                    + ((((off >> 4) ^ (row & 7)) << 4) | (off & 15)),
                src, ok);
  }
}

// The producer warps, stage after stage, tile after tile, as far ahead as
// the ring allows. One tap a stage: thread 0 alone, A by one TMA im2col
// load and the weights by one bulk copy. Else both warps gather A by
// cp.async, and thread 0 brings the weights.
template <typename T, int BN>
__device__ __forceinline__ void produce(const CUtensorMap* amap,
                                        const Params& p, unsigned char* smem,
                                        uint32_t s0, const int* tab, int t) {
  using C = Cfg<T, BN>;
  const uint32_t a_s = s0, b_s = s0 + kStages * kAStage, bar_s = s0 + C::kBars;
  const int per_row = kRowBytes / p.piece;
  if (p.fast && t != 0) return;
  int L = 0, parity = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, parity ^= 1) {
    const int mt = tile / p.ntn, nt = tile - mt * p.ntn;
    int4* rows = reinterpret_cast<int4*>(smem + C::kRows) + parity * kBM;
    int w0 = 0, h0 = 0, b0 = 0;
    if (p.fast) {              // the traversal's first pixel
      const int m = mt * kBM, hw = p.Ho * p.Wo;
      b0 = m / hw;
      const int ho = (m - b0 * hw) / p.Wo, wo = m - b0 * hw - ho * p.Wo;
      h0 = ho * p.stride - p.pad;
      w0 = wo * p.stride - p.pad;
    } else {
      // The tile's row table; the other one may still be read for the
      // last tile, and this one was last read two tiles ago (the barrier).
      for (int r = t; r < kBM; r += kProducers) {
        const int m = mt * kBM + r;
        int4 ri = make_int4(-0x40000000, 0, 0, 0);   // past M: outside
        if (m < p.M) {
          const int hw = p.Ho * p.Wo, b = m / hw, rr = m - b * hw;
          const int ho = rr / p.Wo, wo = rr - ho * p.Wo;
          ri = make_int4(ho * p.stride - p.pad, wo * p.stride - p.pad,
                         b * p.H * p.W, 0);
        }
        rows[r] = ri;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
    }
    const int8_t* wtile = p.w + (long long)nt * (p.kpad / 32) * BN * 32;
    for (int st = 0; st < p.nst; ++st, ++L) {
      const int slot = L % kStages;
      const uint32_t full = bar_s + slot * 8, empty = full + kStages * 8;
      mbar_wait(empty, ((L / kStages) & 1) ^ 1);
      const uint32_t dst = a_s + slot * kAStage;
      const int k0 = st * C::kSteps;
      const int bbytes = min(C::kSteps, p.kpad / 32 - k0) * BN * 32;
      const int8_t* bsrc = wtile + (long long)k0 * BN * 32;
      if (p.fast) {
        const int kb = st * kRowBytes, tap = kb / p.cin_bytes;
        const int dh = tap / p.kw, dw = tap - dh * p.kw;
        expect_tx(full, kAStage + bbytes);
        tma_im2col(dst, amap, full, kb - tap * p.cin_bytes, w0, h0, b0,
                   (uint16_t)dw, (uint16_t)dh);
        bulk_copy(b_s + slot * C::kBStage, bsrc, bbytes, full);
        continue;
      }
      const int e = tab[st * per_row + t % per_row];
      if (p.piece == 16)
        gather_stage<16>(p, dst, rows, e, t);
      else if (p.piece == 8)
        gather_stage<8>(p, dst, rows, e, t);
      else
        gather_stage<4>(p, dst, rows, e, t);
      cp_async_arrive(full);
      if (t == 0) {
        expect_tx(full, bbytes);
        bulk_copy(b_s + slot * C::kBStage, bsrc, bbytes, full);
      }
    }
  }
}

// Writes the outputs of one thread's row at columns n and n + 1 (n + 1
// when has1): v0, v1 as float32, or `packed` (bf16x2) as bf16.
__device__ __forceinline__ void store_pair(const Params& p, long long o,
                                           float v0, float v1,
                                           uint32_t packed, bool has1) {
  if (p.out_f32) {
    float* d = reinterpret_cast<float*>(p.out) + o;
    if (has1 && (p.cout % 2) == 0) {
      *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
    } else {
      d[0] = v0;
      if (has1) d[1] = v1;
    }
  } else {
    unsigned short* d = reinterpret_cast<unsigned short*>(p.out) + o;
    if (has1 && (p.cout % 2) == 0) {
      *reinterpret_cast<uint32_t*>(d) = packed;
    } else {
      d[0] = (unsigned short)(packed & 0xffffu);
      if (has1) d[1] = (unsigned short)(packed >> 16);
    }
  }
}

// Waits for stage L of the ring and reads this thread's A fragment of each
// K step of 32 from it (bytes 4q and 16 + 4q of K, rows row0 and row0 + 8),
// quantized unless T is int8.
template <typename T, int KS>
__device__ __forceinline__ void fetch_a(const unsigned char* smem,
                                        uint32_t bar_s, int L, int row0,
                                        int q, float s, float r,
                                        uint32_t (&f)[KS][4]) {
  const int slot = L % kStages;
  mbar_wait(bar_s + slot * 8, (L / kStages) & 1);
  const unsigned char* a = smem + slot * kAStage;
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[j][i] = load_a<T>(a, row0 + 8 * (i & 1),
                          (32 * j + 16 * (i >> 1) + 4 * q) * (int)sizeof(T),
                          s, r);
}

// A consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile. Every K
// step of a stage is multiplied: past K, A is zero.
template <typename T, int BN>
__device__ __forceinline__ void consume(const Params& p,
                                        unsigned char* smem, uint32_t s0,
                                        int wg, int warp, int lane) {
  using C = Cfg<T, BN>;
  const uint32_t b_s = s0 + kStages * kAStage, bar_s = s0 + C::kBars;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = 64 * wg + 16 * warp + g;      // and row0 + 8
  const float s = __ldg(p.sx);
  const float r = __frcp_rn(s);
  int L = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int mt = tile / p.ntn, nt = tile - mt * p.ntn;
    Acc<BN> acc;
    for (int st = 0; st < p.nst; ++st, ++L) {
      const int slot = L % kStages;
      uint32_t af[C::kSteps][4];
      fetch_a<T>(smem, bar_s, L, row0, q, s, r, af);
#pragma unroll
      for (int j = 0; j < C::kSteps; ++j) fence_regs4(af[j]);
      fence_regs<BN / 2>(acc.d);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < C::kSteps; ++j)
        wgmma_rs_s8(acc, af[j],
                    desc_sw32(b_s + slot * C::kBStage + j * BN * 32),
                    st | j);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BN / 2>(acc.d);
#pragma unroll
      for (int j = 0; j < C::kSteps; ++j) fence_regs4(af[j]);
      if (lane == 0) mbar_arrive(bar_s + (kStages + slot) * 8);
    }

    // Epilogue: thread (g, q) holds rows row0 and row0 + 8, columns
    // 8 j + 2 q and 8 j + 2 q + 1 of each 8-column group j.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = nt * BN + 8 * j + 2 * q;
      if (n >= p.cout) continue;
      const bool has1 = n + 1 < p.cout;
      const float sc0 = __fmul_rn(s, __ldg(p.kscale + n));
      const float bi0 = __ldg(p.bias + n);
      const float sc1 = has1 ? __fmul_rn(s, __ldg(p.kscale + n + 1)) : 0.0f;
      const float bi1 = has1 ? __ldg(p.bias + n + 1) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * kBM + row0 + 8 * h;
        if (m >= p.M) continue;
        float v0 = dequant(acc.d[4 * j + 2 * h], sc0, bi0);
        float v1 = dequant(acc.d[4 * j + 2 * h + 1], sc1, bi1);
        uint32_t packed = 0;
        if (p.out_f32) {
          if (p.relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
        } else {
          packed = to_bf16x2(v0, v1, p.relu);
        }
        store_pair(p, (long long)m * p.cout + n, v0, v1, packed, has1);
      }
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap amap, const Params p) {
  using C = Cfg<T, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(smem);
  int* tab = reinterpret_cast<int*>(smem + C::kTable);
  const int tid = threadIdx.x;

  // The K table (table path only): piece i of a row of A, p.piece bytes,
  // is (dh << 24) | (dw << 16) | byte offset in the pixel, or -1 past K.
  if (!p.fast) {
    const int n = p.nst * kRowBytes / p.piece;
    const int cin_bytes = p.cin_bytes;
    for (int i = tid; i < n; i += kThreads) {
      const int k = i * p.piece;
      int e = -1;
      if (k < p.ktrue_bytes) {
        const int tap = k / cin_bytes, cb = k - tap * cin_bytes;
        const int dh = tap / p.kw, dw = tap - dh * p.kw;
        e = (dh << 24) | (dw << 16) | cb;
      }
      tab[i] = e;
    }
  }
  if (tid == 0) {
    const uint32_t bar_s = s0 + C::kBars;
    for (int i = 0; i < kStages; ++i) {
      // TMA: one expect_tx arrival; cp.async: the producers' and the
      // weights' bulk copy's.
      mbar_init(bar_s + i * 8, p.fast ? 1 : kProducers + 1);
      mbar_init(bar_s + (kStages + i) * 8, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers)
    produce<T, BN>(&amap, p, smem, s0, tab, tid - kConsumers);
  else
    consume<T, BN>(p, smem, s0, tid / 128, (tid / 32) % 4, tid % 32);
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeIm2col lives in libcuda: it is looked up through the
// runtime's entry-point query, so the library needs no -lcuda.
EncodeIm2col encode_im2col() {
  static EncodeIm2col fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeIm2col", &f, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &f, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeIm2col)f;
  }
  return fn;
}

// The im2col tensor map of x as bytes [B, H, W, cin_bytes]: 128-byte pixel
// pieces, 128 pixels a load, the 128-byte swizzle the consumers read; the
// traversal covers the top-left tap's positions, -pad .. W + pad - kw in
// steps of the stride (pad - (kw - 1) past the last column), as each
// output row needs; zeros outside the tensor.
bool im2col_map(CUtensorMap* map, const Params& p) {
  EncodeIm2col encode = encode_im2col();
  if (encode == nullptr) return false;
  const cuuint64_t cb = (cuuint64_t)p.cin_bytes;
  const cuuint64_t dims[4] = {cb, (cuuint64_t)p.W, (cuuint64_t)p.H,
                              (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {cb, cb * p.W, cb * p.W * p.H};
  const int lower[2] = {-p.pad, -p.pad};
  const int upper[2] = {p.pad - (p.kw - 1), p.pad - (p.kh - 1)};
  const cuuint32_t estr[4] = {1, (cuuint32_t)p.stride, (cuuint32_t)p.stride,
                              1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<unsigned char*>(p.x), dims, strides, lower, upper,
                kRowBytes, kBM, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN>
int launch(Params p, cudaStream_t stream) {
  using C = Cfg<T, BN>;
  p.nst = (p.kpad + C::kCh - 1) / C::kCh;
  CUtensorMap map = {};
  // One tap a stage (Cin a multiple of 128 bytes, no K past the taps) and a
  // map the CUDA driver encodes: TMA; else the cp.async gather.
  p.fast = p.cin_bytes % kRowBytes == 0 &&
           (long long)p.kpad * (long long)sizeof(T) == p.ktrue_bytes &&
           p.stride <= 8 && p.pad <= 127 && im2col_map(&map, p);
  const long long tab = p.fast ? 0 : (long long)p.nst * kRowBytes / p.piece;
  const long long smem = 1024LL + C::kTable + 4 * tab;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_conv_kernel<T, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  int8_conv_kernel<T, BN><<<grid, kThreads, (int)smem, stream>>>(map, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bn(const Params& p, int bn, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    case 48: return launch<T, 48>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [B, H, W, cin] NHWC of elem_bytes 1 (int8, quantized), 2 (bf16) or 4
// (float32), 16-byte aligned, cin a multiple of 4; w the image of
// pack_int8_weights for tile width bn and K = kpad (a multiple of 32,
// >= kh * kw * cin), 16-byte aligned; kscale, bias [cout] f32; sx a f32
// scalar on the device; out [B, Ho, Wo, cout] f32 (out_f32) or bf16.
extern "C" int int8_conv_launch(const void* x, const void* w,
                                const float* kscale, const float* sx,
                                const float* bias, void* out, int B, int H,
                                int W, int cin, int elem_bytes, int cout,
                                int kh, int kw, int stride, int pad,
                                int kpad, int bn, int relu, int out_f32,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || kh > 127 || kw > 255 || stride <= 0 || pad < 0 ||
      cin % 4 || kpad % 32 || kpad <= 0 ||
      (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4) ||
      (long long)cin * elem_bytes > 0xffff)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - kh) / stride + 1;
  const int Wo = (W + 2 * pad - kw) / stride + 1;
  const long long ktrue = (long long)kh * kw * cin;
  const long long M = (long long)B * Ho * Wo;
  const long long ntn = (cout + bn - 1) / (long long)bn;
  const long long tiles = (M + kBM - 1) / kBM * ntn;
  if (Ho <= 0 || Wo <= 0 || ktrue > kpad || M > 0x7fffffffLL ||
      tiles > 0x7fffffffLL || ktrue * elem_bytes > 0x7fffffffLL ||
      (long long)B * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const unsigned char*)x;
  p.w = (const int8_t*)w;
  p.kscale = kscale;
  p.sx = sx;
  p.bias = bias;
  p.out = out;
  p.M = (int)M;
  p.B = B;
  p.H = H;
  p.W = W;
  p.cin_bytes = cin * elem_bytes;
  p.Ho = Ho;
  p.Wo = Wo;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.kpad = kpad;
  p.ktrue_bytes = (int)(ktrue * elem_bytes);
  p.piece = p.cin_bytes % 16 == 0 ? 16 : p.cin_bytes % 8 == 0 ? 8 : 4;
  p.ntn = (int)ntn;
  p.tiles = (int)tiles;
  p.relu = relu;
  p.out_f32 = out_f32;
  const cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 1) return launch_bn<int8_t>(p, bn, st);
  if (elem_bytes == 2) return launch_bn<bf16>(p, bn, st);
  return launch_bn<float>(p, bn, st);
}
