// Particle-particle contact kernels of the XPBD rope frame, for Hopper (sm_90a).
//
// Two kernels replace the two Pallas TPU kernels that carry the block
// contact mode of adaptigraph_tpu/engine/solver.py:
//
//   K1 ag_block_sparse_contact  <- adaptigraph_tpu/engine/pallas_kernels.py,
//      block_sparse_contact_deltas_packed (kernel _make_block_sparse_kernel).
//      Runs on every solver iteration.
//   K2 ag_refine_blocks         <- adaptigraph_tpu/engine/pallas_kernels.py,
//      refine_overlap_blocks_packed (kernel _make_refine_kernel, plus the
//      stable top_k compaction of its flags). Runs once per frame.
//
// Both read the packed attribute tables of pack_contact_tables:
//   rows (n_pad, 16) and cols (16, n_pad) float32, attribute a of particle p
//   at rows[p * 16 + a] == cols[a * n_pad + p]. Attributes: 0-2 pos,
//   3-5 pos_prev, 6 group, 7 inv_mass, 8 self_collide, 9-11 rest_pos,
//   12 active (13-15 unused).
// block_idx (nb, maxb) int32 lists, for each 128-particle row tile, the
// col blocks (tile_j particles wide) to sweep; block_cnt (nb,) how many.
//
// Layout: one CTA per row tile, 128 threads, one row particle per thread
// (its attributes in registers). For each listed col block the CTA stages
// the block's 13 used attribute rows (13 x tile_j floats: 6.5 KB at
// tile_j 128, 13 KB at 256) into shared memory with coalesced loads; every
// thread then reads the same col entry at once (a shared-memory broadcast).
//
// What bounds them on this card: neither is bound by the HBM rate or by the
// float32 rate. At the rope design point (n = 5,120: 40 row tiles, a few
// listed col blocks each) a sweep moves under 1 MB and does a few tens of
// MFLOP, so its floor is around a microsecond and the time goes to launch
// latency and to the serial dependency chain inside a CTA (stage, barrier,
// 128 or 256 dependent pair steps per block). Only 40 CTAs run on the 132
// SMs: a known weakness of this first version, left for a later change
// (split each row tile's block list over several CTAs and sum their partial
// rows in a second pass, or give a warp to each block).
//
// What the design does about it: the detection stage (~20 flops a pair)
// runs on every listed block; the projection stage (~60 flops a contact)
// runs only for blocks where __syncthreads_or finds a contact, and inside it
// only for contact pairs, as the Pallas kernel's lax.cond does. Each thread
// sums its own row in registers, in col order, and writes once: no atomics,
// so runs repeat bit for bit.
//
// Numerics: build with -fmad=false. The detection stage then rounds every
// product and sum as the plain PyTorch version does, op for op, so contact
// decisions (and hence counts and K2's block lists) match it exactly.
// rsqrtf is the hardware reciprocal square root, as lax.rsqrt is on the TPU;
// deltas agree with the plain version to float32 rounding.
//
// Every entry returns cudaGetLastError() (0 on success) after its launch, or
// cudaErrorInvalidValue for a shape it does not take; it never synchronizes.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;      // row tile: particles per CTA
constexpr int kAttrs = 13;      // attribute rows the contact math reads
constexpr int kMaxBlocks = 128; // widest block list (solver's maxb rule)
constexpr float kEps = 1e-9f;

struct RowAttrs {
  float x, y, z, px, py, pz, g, w, sc, rx, ry, rz, a;
};

__device__ __forceinline__ RowAttrs load_row(const float* __restrict__ rows,
                                             int p) {
  const float4* q = reinterpret_cast<const float4*>(rows + (size_t)p * 16);
  const float4 a = q[0], b = q[1], c = q[2], d = q[3];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, d.x};
}

template <int TJ>
__device__ __forceinline__ void stage_block(float (*s)[TJ],
                                            const float* __restrict__ cols,
                                            int n_pad, int j) {
  const size_t base = (size_t)j * TJ;
  for (int e = threadIdx.x; e < kAttrs * TJ; e += kTile) {
    const int a = e / TJ, c = e - a * TJ;
    s[a][c] = cols[(size_t)a * n_pad + base + c];
  }
}

// Pair eligibility, the detection stage shared by K1 and K2: closer than
// `dist` (dist2 = dist * dist), not the same particle, both active, some
// inverse mass, and either different groups or both self-colliding and at
// least filter_dist apart at rest.
template <int TJ, bool REST_FILTER>
__device__ __forceinline__ bool eligible(const RowAttrs& r, float (*s)[TJ],
                                         int c,
                                         float dist2, float filt2, float& dx,
                                         float& dy, float& dz, float& d2) {
  dx = r.x - s[0][c];
  dy = r.y - s[1][c];
  dz = r.z - s[2][c];
  d2 = dx * dx + dy * dy + dz * dz;
  const bool same_group = fabsf(r.g - s[6][c]) < 0.5f;
  bool collide;
  if (REST_FILTER) {
    const bool pair_sc = (r.sc > 0.5f) && (s[8][c] > 0.5f);
    const float rdx = r.rx - s[9][c];
    const float rdy = r.ry - s[10][c];
    const float rdz = r.rz - s[11][c];
    const bool rest_near = rdx * rdx + rdy * rdy + rdz * rdz < filt2;
    collide = !same_group || (pair_sc && !rest_near);
  } else {
    collide = !same_group;
  }
  return (d2 < dist2) && (d2 > 1e-14f) && collide && (r.w + s[7][c] > 0.0f) &&
         (r.a > 0.5f) && (s[12][c] > 0.5f);
}

// K1. scal = [rest_dist, particle_friction, filter_dist].
template <int TJ, bool REST_FILTER>
__global__ void __launch_bounds__(kTile)
    block_sparse_contact_kernel(const float* __restrict__ rows,
                                const float* __restrict__ cols,
                                const int* __restrict__ block_idx,
                                const int* __restrict__ block_cnt,
                                const float* __restrict__ scal,
                                float* __restrict__ delta,
                                float* __restrict__ count, int n, int n_pad,
                                int maxb) {
  __shared__ float s[kAttrs][TJ];
  const int i = blockIdx.x;
  const int p = i * kTile + threadIdx.x;
  const RowAttrs r = load_row(rows, p);
  const float rest_dist = scal[0], friction = scal[1], filter_dist = scal[2];
  const float dist2 = rest_dist * rest_dist;
  const float filt2 = filter_dist * filter_dist;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, ac = 0.0f;
  const int cnt = min(block_cnt[i], maxb);
  for (int k = 0; k < cnt; ++k) {
    const int j = block_idx[i * maxb + k];
    __syncthreads();  // the previous block's shared reads are done
    stage_block<TJ>(s, cols, n_pad, j);
    __syncthreads();
    bool any = false;
    float dx, dy, dz, d2;
    for (int c = 0; c < TJ && !any; ++c)
      any = eligible<TJ, REST_FILTER>(r, s, c, dist2, filt2, dx, dy, dz, d2);
    if (!__syncthreads_or(any)) continue;  // no contact in the block
    for (int c = 0; c < TJ; ++c) {
      if (!eligible<TJ, REST_FILTER>(r, s, c, dist2, filt2, dx, dy, dz, d2))
        continue;
      const float wi = r.w, wj = s[7][c];
      const float inv_dist = rsqrtf(d2 + kEps);
      const float dist = d2 * inv_dist;
      const float overlap = rest_dist - dist;
      const float share = wi * (1.0f / (wi + wj + kEps));
      const float mag = share * overlap * inv_dist;
      const float mx = (r.x - r.px) - (s[0][c] - s[3][c]);
      const float my = (r.y - r.py) - (s[1][c] - s[4][c]);
      const float mz = (r.z - r.pz) - (s[2][c] - s[5][c]);
      const float rel_n = (mx * dx + my * dy + mz * dz) * (inv_dist * inv_dist);
      const float tx = mx - rel_n * dx;
      const float ty = my - rel_n * dy;
      const float tz = mz - rel_n * dz;
      const float inv_tnorm = rsqrtf(tx * tx + ty * ty + tz * tz + kEps);
      const float max_slide = fmaxf(friction * overlap, 0.0f);
      const float fscale = fminf(1.0f, max_slide * inv_tnorm) * share;
      ax += dx * mag - tx * fscale;
      ay += dy * mag - ty * fscale;
      az += dz * mag - tz * fscale;
      ac += 1.0f;
    }
  }
  if (p < n) {
    delta[(size_t)p * 3 + 0] = ax;
    delta[(size_t)p * 3 + 1] = ay;
    delta[(size_t)p * 3 + 2] = az;
    count[p] = ac;
  }
}

// K2. scal = [keep_dist, filter_dist]. Flags each listed block holding an
// eligible pair closer than keep_dist, then writes the row's list with the
// flagged blocks first and the rest after, each in slot order (the stable
// top_k of the JAX version), and the number flagged.
template <int TJ, bool REST_FILTER>
__global__ void __launch_bounds__(kTile)
    refine_blocks_kernel(const float* __restrict__ rows,
                         const float* __restrict__ cols,
                         const int* __restrict__ block_idx,
                         const int* __restrict__ block_cnt,
                         const float* __restrict__ scal,
                         int* __restrict__ new_idx, int* __restrict__ new_cnt,
                         int n_pad, int maxb) {
  __shared__ float s[kAttrs][TJ];
  __shared__ bool flag[kMaxBlocks];
  const int i = blockIdx.x;
  const RowAttrs r = load_row(rows, i * kTile + threadIdx.x);
  const float keep_dist = scal[0], filter_dist = scal[1];
  const float dist2 = keep_dist * keep_dist;
  const float filt2 = filter_dist * filter_dist;
  const int cnt = min(block_cnt[i], maxb);
  for (int k = 0; k < cnt; ++k) {
    const int j = block_idx[i * maxb + k];
    __syncthreads();
    stage_block<TJ>(s, cols, n_pad, j);
    __syncthreads();
    bool any = false;
    float dx, dy, dz, d2;
    for (int c = 0; c < TJ && !any; ++c)
      any = eligible<TJ, REST_FILTER>(r, s, c, dist2, filt2, dx, dy, dz, d2);
    const int hit = __syncthreads_or(any);
    if (threadIdx.x == 0) flag[k] = hit != 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int* src = block_idx + (size_t)i * maxb;
    int* dst = new_idx + (size_t)i * maxb;
    int out = 0;
    for (int k = 0; k < cnt; ++k)
      if (flag[k]) dst[out++] = src[k];
    new_cnt[i] = out;
    for (int k = 0; k < maxb; ++k)
      if (k >= cnt || !flag[k]) dst[out++] = src[k];
  }
}

template <int TJ, bool RF>
int launch_contact(const float* rows, const float* cols, const int* block_idx,
                   const int* block_cnt, const float* scal, float* delta,
                   float* count, int n, int n_pad, int maxb,
                   cudaStream_t stream) {
  block_sparse_contact_kernel<TJ, RF><<<n_pad / kTile, kTile, 0, stream>>>(
      rows, cols, block_idx, block_cnt, scal, delta, count, n, n_pad, maxb);
  return (int)cudaGetLastError();
}

template <int TJ, bool RF>
int launch_refine(const float* rows, const float* cols, const int* block_idx,
                  const int* block_cnt, const float* scal, int* new_idx,
                  int* new_cnt, int n_pad, int maxb, cudaStream_t stream) {
  refine_blocks_kernel<TJ, RF><<<n_pad / kTile, kTile, 0, stream>>>(
      rows, cols, block_idx, block_cnt, scal, new_idx, new_cnt, n_pad, maxb);
  return (int)cudaGetLastError();
}

bool shapes_ok(int n_pad, int maxb, int tile_j) {
  return n_pad > 0 && n_pad % tile_j == 0 && maxb > 0 && maxb <= kMaxBlocks &&
         (tile_j == 128 || tile_j == 256);
}

}  // namespace

extern "C" {

int ag_block_sparse_contact(const float* rows, const float* cols,
                            const int* block_idx, const int* block_cnt,
                            const float* scal, float* delta, float* count,
                            int n, int n_pad, int maxb, int tile_j,
                            int rest_filter, void* stream) {
  if (!shapes_ok(n_pad, maxb, tile_j) || n > n_pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_j == 128)
    return rest_filter
               ? launch_contact<128, true>(rows, cols, block_idx, block_cnt,
                                           scal, delta, count, n, n_pad, maxb, st)
               : launch_contact<128, false>(rows, cols, block_idx, block_cnt,
                                            scal, delta, count, n, n_pad, maxb, st);
  return rest_filter
             ? launch_contact<256, true>(rows, cols, block_idx, block_cnt, scal,
                                         delta, count, n, n_pad, maxb, st)
             : launch_contact<256, false>(rows, cols, block_idx, block_cnt,
                                          scal, delta, count, n, n_pad, maxb, st);
}

int ag_refine_blocks(const float* rows, const float* cols,
                     const int* block_idx, const int* block_cnt,
                     const float* scal, int* new_idx, int* new_cnt, int n_pad,
                     int maxb, int tile_j, int rest_filter, void* stream) {
  if (!shapes_ok(n_pad, maxb, tile_j)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_j == 128)
    return rest_filter
               ? launch_refine<128, true>(rows, cols, block_idx, block_cnt,
                                          scal, new_idx, new_cnt, n_pad, maxb, st)
               : launch_refine<128, false>(rows, cols, block_idx, block_cnt,
                                           scal, new_idx, new_cnt, n_pad, maxb, st);
  return rest_filter
             ? launch_refine<256, true>(rows, cols, block_idx, block_cnt, scal,
                                        new_idx, new_cnt, n_pad, maxb, st)
             : launch_refine<256, false>(rows, cols, block_idx, block_cnt, scal,
                                         new_idx, new_cnt, n_pad, maxb, st);
}

const char* ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
