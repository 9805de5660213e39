// associate_kernel: the whole depth-aware greedy association of a batch,
// one launch, one CTA per image.
//
// Replaces the TPU kernel `associate_limb` (smap_tpu/ops/pallas_kernels.py:208,
// both its per-image and its batched body) together with the loop around it
// in `associate` (smap_tpu/ops/association.py:138-211): the root-depth read,
// the stable depth sort of the persons, and per limb the adjusted scores,
// the sequential greedy, the pick gathers and the bodies / remap updates.
// The plain PyTorch version is `associate_plain`
// (smap_tpu_torch/ops/association.py); this kernel gives the same bits.
//
// What bounds it on an H100: the chain of dependent greedy steps, not bytes
// or flops (a [16, 14, 127, 127] table is 3.6 MB). Person p of a limb sees
// the used-mask left by person p - 1, so a limb is K steps long. The design
// cuts the chain and the latency of each step:
//
// - Limb l reads only its src joint's column of `bodies` / `remap` and writes
//   only its dst joint's column; every joint but the root is the dst of one
//   limb. So the limbs form a tree, and the host hands the kernel its levels
//   ("waves", `limb_waves()`): a table of (limb, src, dst, flip) rows in wave
//   order and the wave starts. The limbs of a wave run at once, with a CTA
//   barrier between waves: 4 waves, so 4 x K steps, not 14 x K.
// - The image's state stays in shared memory: bodies [K, J, 4], remap
//   [J, K], the sorted depths. bodies goes out coalesced at the end.
// - Only the used-mask carries from step to step. A person's adjusted
//   scores (a table load, two IEEE divisions and a square root per dst
//   slot) do not, and they are most of a step's latency. So each limb of a
//   wave gets one chain warp and a team of helper warps (24 warps in all):
//   the helpers compute the persons' scores ahead of the chain, as
//   order-preserving keys, into a ring of rows in shared memory, and
//   publish each row with a flag; the chain warp waits for row p, masks it
//   with the used bits, takes the argmax with two `redux.sync` (max of the
//   key, then min of the index among the lanes that hold it) and writes the
//   pick. Lane c owns dst slots c + 32 m (m < 4, K <= 128).
//
// Numerics: every value is the plain version's, in its order of f32
// operations (the library builds with -fmad=false and without fast math):
// sqrt(dx*dx + dy*dy); (bone_factor * bone_len) / depth / limb_dist, times
// the reciprocal of ds_scale (PyTorch divides a CUDA tensor by a Python
// scalar that way), minus 1; clamped at 0 with NaN passing through, as
// torch.clamp; added only where the raw score is > 0; -inf for invalid dst
// slots and for persons whose src joint is missing. The argmax follows
// torch.argmax: NaN is the largest value, the lowest index wins a tie, and a
// pick needs a score strictly > 0. The sort follows torch.sort(stable=True):
// NaN after everything, equal keys (-0 and +0 too) in index order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 768;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kSlots = kMaxK / 32;   // dst slots per lane
constexpr int kMaxWave = 8;          // limbs of one wave
constexpr int kRing = 16;            // rows of keys per limb in flight

struct Args {
  const float* xy;          // [B, J, K, 2], coordinate stride 1
  long long xy_sb, xy_sj, xy_sk;
  const float* score;       // [B, J, K]
  long long sc_sb, sc_sj, sc_sk;
  const int* count;         // [B, J]
  const float* table;       // [B, L, K, K]
  const float* depth_map;   // [B, H, W]
  const int* steps;         // [L, 4]: limb, src, dst, flip; in wave order
  const int* wave_starts;   // [n_waves + 1]
  const float* bone;        // [L]: bone_factor * bone_length, by limb
  float* bodies;            // [B, K, J, 4]
  float* root_depth;        // [B, K]
  int J, K, L, H, W, root, n_waves;
  float inv_ds;
};

// Order-preserving key of a float: NaN above +inf, -0 equal to +0. Key 0
// is below every float's: a used slot.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (isnan(v)) return 0xffffffffu;
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
constexpr unsigned kKeyZero = 0x80000000u;   // order_key(0.0f)
constexpr unsigned kKeyNaN = 0xffffffffu;

// torch.sort's order: a before b.
__device__ __forceinline__ bool sorts_before(float a, float b) {
  return (!isnan(a) && isnan(b)) || a < b;
}

// The image's state and the wave's rings, in shared memory.
struct Shared {
  float4* bodies;           // [K, J]
  unsigned* ring;           // [kMaxWave, kRing, kp] keys
  volatile int* ready;      // [kMaxWave, kRing]: 1 + the person in the row
  volatile int* consumed;   // [kMaxWave]: persons the chain has taken
  const float* sdepth;      // [kp]
  unsigned char* remap;     // [J, kp]
  int kp, n_person;
};

struct Limb {
  const float* tab;         // the limb's [K, K] table
  const float* dxy;         // the dst joint's peaks
  int limb, src, dst, dst_n;
  bool flip;
};

__device__ __forceinline__ Limb limb_at(const Args& a, int b, int e) {
  const int* s = a.steps + 4 * e;
  Limb l;
  l.limb = s[0];
  l.src = s[1];
  l.dst = s[2];
  l.flip = s[3] != 0;
  l.tab = a.table + ((long long)b * a.L + l.limb) * a.K * a.K;
  l.dst_n = min(max(a.count[b * a.J + l.dst], 0), a.K);
  l.dxy = a.xy + b * a.xy_sb + l.dst * a.xy_sj;
  return l;
}

// Helper warp h of the n_help of ring i: the keys of persons h,
// h + n_help, ... of limb e.
__device__ __forceinline__ void score_rows(const Args& a, const Shared& sh,
                                           int b, int e, int i, int h,
                                           int n_help, int lane) {
  const Limb l = limb_at(a, b, e);
  const float bone = a.bone[l.limb], inv_ds = a.inv_ds;
  const int K = a.K, kp = sh.kp;
  float px[kSlots], py[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int c = lane + 32 * m;
    px[m] = py[m] = 0.0f;
    if (c < l.dst_n) {
      px[m] = l.dxy[c * a.xy_sk];
      py[m] = l.dxy[c * a.xy_sk + 1];
    }
  }
  for (int p = h; p < sh.n_person; p += n_help) {
    const float4 s = sh.bodies[p * a.J + l.src];
    const bool ok = s.w >= 1e-5f;   // src joint missing: takes nothing
    const int r = sh.remap[l.src * kp + p];
    const float bone_dist = bone / sh.sdepth[p];
    unsigned key[kSlots];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int c = lane + 32 * m;
      float v = -INFINITY;
      if (ok && c < l.dst_n) {
        const float raw = l.flip ? l.tab[(long long)c * K + r]
                                 : l.tab[(long long)r * K + c];
        const float dx = s.x - px[m];
        const float dy = s.y - py[m];
        const float dist = sqrtf(dx * dx + dy * dy);
        float pen = bone_dist / dist * inv_ds - 1.0f;
        pen = pen > 0.0f ? 0.0f : pen;   // NaN passes, as torch.clamp
        v = raw > 0.0f ? raw + pen : raw;
      }
      key[m] = order_key(v);
    }
    // The row's slot is free once the chain has taken person p - kRing.
    while (p - sh.consumed[i] >= kRing) __nanosleep(32);
    unsigned* row = sh.ring + (i * kRing + p % kRing) * kp;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int c = lane + 32 * m;
      if (c < kp) row[c] = key[m];
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      sh.ready[i * kRing + p % kRing] = p + 1;
    }
  }
}

// The chain warp of ring i, limb e: persons in depth order take the best
// unused dst slot of their row.
__device__ __forceinline__ void run_chain(const Args& a, const Shared& sh,
                                          int b, int e, int i, int lane) {
  const Limb l = limb_at(a, b, e);
  const int kp = sh.kp;
  const float* dsc = a.score + b * a.sc_sb + l.dst * a.sc_sj;
  float px[kSlots], py[kSlots], ps[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int c = lane + 32 * m;
    px[m] = py[m] = ps[m] = 0.0f;
    if (c < l.dst_n) {
      px[m] = l.dxy[c * a.xy_sk];
      py[m] = l.dxy[c * a.xy_sk + 1];
      ps[m] = dsc[c * a.sc_sk];
    }
  }
  unsigned used = 0u;   // bit m: slot lane + 32 m is taken
  for (int p = 0; p < sh.n_person; ++p) {
    const int slot = i * kRing + p % kRing;
    while (sh.ready[slot] != p + 1) {
    }
    __threadfence_block();
    const unsigned* row = sh.ring + slot * kp;
    unsigned best_key = 0u;
    int best_c = lane;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int c = lane + 32 * m;
      const unsigned k = (c < kp && !((used >> m) & 1u)) ? row[c] : 0u;
      if (k > best_key) {   // strict: the lower slot keeps ties
        best_key = k;
        best_c = c;
      }
    }
    const unsigned top = __reduce_max_sync(0xffffffffu, best_key);
    if (top > kKeyZero && top != kKeyNaN) {   // best score > 0
      const unsigned pick = __reduce_min_sync(
          0xffffffffu, best_key == top ? (unsigned)best_c : 0xffffffffu);
      if ((int)(pick & 31u) == lane) {
#pragma unroll
        for (int m = 0; m < kSlots; ++m) {
          if ((int)(pick >> 5) == m) {
            used |= 1u << m;
            sh.bodies[p * a.J + l.dst] =
                make_float4(px[m], py[m], 0.0f, ps[m]);
          }
        }
        sh.remap[l.dst * kp + p] = (unsigned char)pick;
      }
    }
    __syncwarp();
    if (lane == 0) sh.consumed[i] = p + 1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
associate_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int K = a.K, J = a.J, b = blockIdx.x;
  const int kp = (K + 31) & ~31;
  float4* bodies = smem4;                                           // [K, J]
  unsigned* ring = reinterpret_cast<unsigned*>(bodies + K * J);
  int* flags = reinterpret_cast<int*>(ring + kMaxWave * kRing * kp);
  float* key = reinterpret_cast<float*>(flags + kMaxWave * (kRing + 1));
  float* sdepth = key + kp;                                         // [kp]
  int* sidx = reinterpret_cast<int*>(sdepth + kp);                  // [kp]
  unsigned char* remap = reinterpret_cast<unsigned char*>(sidx + kp);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_person = min(max(a.count[b * J + a.root], 0), K);
  const Shared sh{bodies, ring, flags, flags + kMaxWave * kRing, sdepth,
                  remap, kp, n_person};
  const float* rxy = a.xy + b * a.xy_sb + a.root * a.xy_sj;

  // Root depth per root peak, at the truncated, clamped coordinates; the
  // sort key is +inf past the person count.
  for (int k = t; k < K; k += kThreads) {
    const int x = min(max(__float2int_rz(rxy[k * a.xy_sk]), 0), a.W - 1);
    const int y = min(max(__float2int_rz(rxy[k * a.xy_sk + 1]), 0), a.H - 1);
    const float d = a.depth_map[((long long)b * a.H + y) * a.W + x];
    key[k] = k < n_person ? d : INFINITY;
  }
  __syncthreads();
  // Stable sort by rank.
  for (int k = t; k < K; k += kThreads) {
    const float v = key[k];
    int rank = 0;
    for (int i = 0; i < K; ++i) {
      const float u = key[i];
      rank += sorts_before(u, v) || (i < k && !sorts_before(v, u));
    }
    sdepth[rank] = v;
    sidx[rank] = k;
  }
  __syncthreads();

  // Seed: the root joint of every person, zeros elsewhere; remap[j][p] = p
  // except the root's, which is the sort order.
  const float* rsc = a.score + b * a.sc_sb + a.root * a.sc_sj;
  for (int i = t; i < K * J; i += kThreads) {
    const int p = i / J, j = i - p * J;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j == a.root && p < n_person) {
      const int k = sidx[p];
      v = make_float4(rxy[k * a.xy_sk], rxy[k * a.xy_sk + 1], 0.0f,
                      rsc[k * a.sc_sk]);
    }
    bodies[i] = v;
  }
  for (int i = t; i < J * kp; i += kThreads) {
    const int j = i / kp, p = i - j * kp;
    remap[i] = (unsigned char)((j == a.root && p < K) ? sidx[p] : p);
  }
  for (int p = t; p < K; p += kThreads)
    a.root_depth[(long long)b * K + p] = p < n_person ? sdepth[p] : 0.0f;

  // The waves: warps 0 .. n-1 run the chains of the wave's n limbs, the
  // other warps split into n teams of helpers, one team per limb.
  for (int w = 0; w < a.n_waves; ++w) {
    const int e0 = a.wave_starts[w], n = a.wave_starts[w + 1] - e0;
    for (int i = t; i < kMaxWave * (kRing + 1); i += kThreads) flags[i] = 0;
    __syncthreads();
    const int n_help = (kWarps - n) / n;
    if (warp < n) {
      run_chain(a, sh, b, e0 + warp, warp, lane);
    } else if (warp < n + n * n_help) {
      const int i = (warp - n) / n_help;
      score_rows(a, sh, b, e0 + i, i, (warp - n) % n_help, n_help, lane);
    }
    __syncthreads();
  }

  float4* out = reinterpret_cast<float4*>(a.bodies) + (long long)b * K * J;
  for (int i = t; i < K * J; i += kThreads) out[i] = bodies[i];
}

size_t smem_bytes(int K, int J) {
  const int kp = (K + 31) & ~31;
  return (size_t)K * J * 16 + (size_t)kMaxWave * kRing * kp * 4 +
         (size_t)kMaxWave * (kRing + 1) * 4 + (size_t)3 * kp * 4 +
         (size_t)J * kp;
}

}  // namespace

extern "C" int associate_launch(
    const float* xy, long long xy_sb, long long xy_sj, long long xy_sk,
    const float* score, long long sc_sb, long long sc_sj, long long sc_sk,
    const int* count, const float* table, const float* depth_map,
    const int* steps, const int* wave_starts, const float* bone,
    float* bodies, float* root_depth, int B, int J, int K, int L, int H,
    int W, int root, int n_waves, int max_wave, float inv_ds,
    void* stream) {
  if (K < 1 || K > kMaxK || max_wave < 1 || max_wave > kMaxWave)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(K, J);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        associate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const Args a{xy, xy_sb, xy_sj, xy_sk, score, sc_sb, sc_sj, sc_sk, count,
               table, depth_map, steps, wave_starts, bone, bodies,
               root_depth, J, K, L, H, W, root, n_waves, inv_ds};
  associate_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
