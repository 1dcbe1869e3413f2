// Particle contact kernels of the XPBD frame, for Hopper (sm_90a).
//
// Four kernels replace the Pallas TPU kernels of
// adaptigraph_tpu/engine/pallas_kernels.py:
//
//   K1 ag_block_sparse_contact  <- block_sparse_contact_deltas_packed
//      (kernel _make_block_sparse_kernel). The `block` contact mode's
//      sweep; runs on every solver iteration.
//   K2 ag_refine_blocks         <- refine_overlap_blocks_packed (kernel
//      _make_refine_kernel, plus the stable top_k compaction of its flags).
//      Runs once per frame.
//   K3 ag_dense_contact         <- dense_contact_deltas (kernel
//      _contact_kernel + _pair_block). The `dense` contact mode's all-pairs
//      sweep (scenes of 2,048 particles or fewer); every solver iteration.
//   K4 ag_block_sparse_contact_shapes <- _shape_stage, fused into K1's
//      kernel when shape tables are passed: each row particle against every
//      kinematic shape (box, capsule, plane, convex polytope), added to its
//      pair sums.
//
// All read the packed attribute tables of pack_contact_tables:
//   rows (n_pad, 16) and cols (16, n_pad) float32, attribute a of particle p
//   at rows[p * 16 + a] == cols[a * n_pad + p]. Attributes: 0-2 pos,
//   3-5 pos_prev, 6 group, 7 inv_mass, 8 self_collide, 9-11 rest_pos,
//   12 active (13-15 unused).
// block_idx (nb, maxb) int32 lists, for each 128-particle row tile, the
// col blocks (tile_j particles wide) to sweep; block_cnt (nb,) how many.
// K3 sweeps every 128-wide col block instead: K1 over a full list.
//
// What bounds K1 and K3 on this card: operations. A sweep reads a few MB at
// most, and does 26 float32 operations on every listed pair (detection) and
// 52 more on each contact (projection and friction); with -fmad=false none
// of them fuse. That floor is microseconds; what keeps a sweep from it is
// occupancy and latency: there are few row tiles for 132 SMs (16 at 2,048
// particles), a row's pairs form one dependent chain if one thread takes
// them, and a block must be staged before it is swept.
//
// The sweep kernel of K1 and K3 (contact_sweep_kernel), and what it does
// about that:
// - A thread block cluster of S CTAs per row tile. Rank s sweeps the list
//   slots s, s + S, s + 2S, ... below the tile's count: lists are short
//   and front-loaded, so strided slots spread a long list over every rank
//   where contiguous ranges would leave it to rank 0. S comes from the
//   shapes and the SM count alone (split_ranks), never from the counts on
//   the device, so the host never waits for the device: the largest power
//   of two up to 8 with at most one CTA an SM. On the H100 (132 SMs) that
//   is S = 8 for K3 at 2,048 particles (16 row tiles, 128 CTAs), 2 for K1
//   at the rope's 5,120 (80 CTAs) and 1 at the granular 32,768 (256 CTAs,
//   each a cluster of one): past one CTA an SM the ranks' fixed cost
//   (launch, staging, barriers) outweighed the shorter sweeps there.
// - 512 threads a CTA: L = 4 lanes for each of the 128 rows, the lanes of
//   a row side by side in one warp. Lane l takes the columns
//   16 t + 4 l + q of each staged block (t ascending, then q = 0..3) and
//   reads four columns' x, y, z with three float4 shared-memory loads, so
//   the loads neither conflict nor bound the loop. 16 warps a row tile,
//   and each thread's chain of pair steps a quarter of the row's.
// - One pass a block, detection once a pair: the distance test runs on
//   every pair; the rest of the detection, then projection and friction,
//   run in a per-thread branch for the pairs that pass it, in column
//   order. A block with no contact costs no more than its distance tests.
// - Staging by cp.async into two buffers of 13 attribute rows x tile_j
//   floats (26 KB at tile_j 256): the next listed block is on its way
//   while the current one is swept.
// - The sums, in a fixed order, with no atomics: each thread adds its
//   contact terms in its column order, starting from 0; the lanes of a row
//   combine by warp shuffles as (l0 + l1) + (l2 + l3); each CTA keeps its
//   128 partial rows (float4: delta, count) in shared memory; after a
//   cluster barrier rank s adds up rows [128 s / S, 128 (s + 1) / S) over
//   the ranks that had a slot, in rank order, through distributed shared
//   memory, and writes them. Two launches on the same inputs give the same
//   bits. The order differs from the plain versions', so deltas agree with
//   them to float32 rounding (2e-5 is the gate) and counts exactly.
// - K4: the shape and plane tables in dynamic shared memory; the threads
//   that finish the rank's rows run the shape stage before the sweep, one
//   row each, and add it last (`pair + shape`, one rounding each, as the
//   Pallas wrapper adds them). The sweep's first barrier waits for them, so
//   the stage overlaps only the first block's staging copy.
// - No tensor cores. An MMA form of |xi - xj|^2 (|xi|^2 + |xj|^2 - 2 xi.xj)
//   rounds otherwise than the plain version's differences and squares; it
//   would flip contact decisions and break the exact counts that K2's lists
//   and the checks rely on. The pair math stays float32 CUDA-core work.
//
// K2 keeps the first layout: one CTA of 128 threads per row tile, one row a
// thread, each listed block staged (stage_block) and scanned to its first
// eligible pair, a block-wide vote, an in-order compaction.
//
// Numerics: build with -fmad=false. Detection and the shape stage then
// round every product and sum as the plain PyTorch versions do, op for op,
// so contact decisions (and hence counts and K2's block lists) match them
// exactly. rsqrtf is the hardware reciprocal square root, as lax.rsqrt is
// on the TPU; `share` takes an exact reciprocal and K4's friction scale an
// IEEE division.
//
// Every entry returns the launch's CUDA error (0 on success), or
// cudaErrorInvalidValue for a shape it does not take; it never synchronizes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;      // row tile: 128 particles
constexpr int kAttrs = 13;      // attribute rows the contact math reads
constexpr int kMaxBlocks = 128; // widest block list (solver's maxb rule)
constexpr int kMaxShapeFloats = 8192;  // K4 shape + plane tables (32 KB)
constexpr int kLanes = 4;              // sweep threads per row (K1, K3)
constexpr int kSweepThreads = kTile * kLanes;
constexpr int kMaxSplit = 8;           // the portable cluster size
constexpr float kEps = 1e-9f;
constexpr float kEps2 = 1e-18f;  // _EPS * _EPS of the shape stage

// shape kinds (engine/state.py)
constexpr float kBox = 0.0f, kCapsule = 1.0f, kConvex = 3.0f;

struct RowAttrs {
  float x, y, z, px, py, pz, g, w, sc, rx, ry, rz, a;
};

__device__ __forceinline__ RowAttrs load_row(const float* __restrict__ rows,
                                             int p) {
  const float4* q = reinterpret_cast<const float4*>(rows + (size_t)p * 16);
  const float4 a = q[0], b = q[1], c = q[2], d = q[3];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, d.x};
}

// K2's staging: col block j's 13 attribute rows into s (kAttrs x TJ).
template <int TJ>
__device__ __forceinline__ void stage_block(float* s,
                                            const float* __restrict__ cols,
                                            int n_pad, int j) {
  const size_t base = (size_t)j * TJ;
  for (int e = threadIdx.x; e < kAttrs * TJ; e += kTile) {
    const int a = e / TJ, c = e - a * TJ;
    s[a * TJ + c] = cols[(size_t)a * n_pad + base + c];
  }
}

// The same, as 16-byte cp.async copies that land while the caller works;
// the caller commits them as one group.
template <int TJ>
__device__ __forceinline__ void stage_block_async(
    float* s, const float* __restrict__ cols, int n_pad, int j) {
  constexpr int kChunks = TJ / 4;  // 16-byte chunks per attribute row
  const float* src = cols + (size_t)j * TJ;
  for (int e = threadIdx.x; e < kAttrs * kChunks; e += kSweepThreads) {
    const int a = e / kChunks, q = e - a * kChunks;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(s + a * TJ + q * 4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + (size_t)a * n_pad + q * 4)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Pair detection, shared by K1, K2 and K3, in two parts: the distance test
// (closer than `dist`, dist2 = dist * dist, and not the same particle) and
// the rest (both active, some inverse mass, and either different groups or
// both self-colliding and at least filter_dist apart at rest). s is a
// staged block, attribute a of column c at s[a * TJ + c].
__device__ __forceinline__ float pair_d2(const RowAttrs& r, float xj, float yj,
                                         float zj, float& dx, float& dy,
                                         float& dz) {
  dx = r.x - xj;
  dy = r.y - yj;
  dz = r.z - zj;
  return dx * dx + dy * dy + dz * dz;
}

__device__ __forceinline__ bool within(float d2, float dist2) {
  return (d2 < dist2) && (d2 > 1e-14f);
}

template <int TJ, bool REST_FILTER>
__device__ __forceinline__ bool admitted(const RowAttrs& r, const float* s,
                                         int c, float filt2) {
  const bool same_group = fabsf(r.g - s[6 * TJ + c]) < 0.5f;
  bool collide;
  if (REST_FILTER) {
    const bool pair_sc = (r.sc > 0.5f) && (s[8 * TJ + c] > 0.5f);
    const float rdx = r.rx - s[9 * TJ + c];
    const float rdy = r.ry - s[10 * TJ + c];
    const float rdz = r.rz - s[11 * TJ + c];
    const bool rest_near = rdx * rdx + rdy * rdy + rdz * rdz < filt2;
    collide = !same_group || (pair_sc && !rest_near);
  } else {
    collide = !same_group;
  }
  return collide && (r.w + s[7 * TJ + c] > 0.0f) && (r.a > 0.5f) &&
         (s[12 * TJ + c] > 0.5f);
}

template <int TJ, bool REST_FILTER>
__device__ __forceinline__ bool eligible(const RowAttrs& r, const float* s,
                                         int c, float dist2, float filt2) {
  float dx, dy, dz;
  const float d2 = pair_d2(r, s[c], s[TJ + c], s[2 * TJ + c], dx, dy, dz);
  return within(d2, dist2) && admitted<TJ, REST_FILTER>(r, s, c, filt2);
}

struct PairParams {
  float rest_dist, friction, dist2, filt2;
};

__device__ __forceinline__ PairParams pair_params(const float* scal) {
  const float rest_dist = scal[0], friction = scal[1], filter_dist = scal[2];
  return {rest_dist, friction, rest_dist * rest_dist,
          filter_dist * filter_dist};
}

// Column c of a staged block, already within the contact distance of the
// row: the rest of the detection, then, for a contact, its projection and
// friction added to acc (delta xyz, count).
template <int TJ, bool REST_FILTER>
__device__ __forceinline__ void add_contact(const RowAttrs& r, const float* s,
                                         int c, const PairParams& pp,
                                         float4& acc) {
  if (!admitted<TJ, REST_FILTER>(r, s, c, pp.filt2)) return;
  float dx, dy, dz;  // the values of the distance test, recomputed
  const float d2 = pair_d2(r, s[c], s[TJ + c], s[2 * TJ + c], dx, dy, dz);
  const float wi = r.w, wj = s[7 * TJ + c];
  const float inv_dist = rsqrtf(d2 + kEps);
  const float dist = d2 * inv_dist;
  const float overlap = pp.rest_dist - dist;
  const float share = wi * (1.0f / (wi + wj + kEps));
  const float mag = share * overlap * inv_dist;
  const float mx = (r.x - r.px) - (s[c] - s[3 * TJ + c]);
  const float my = (r.y - r.py) - (s[TJ + c] - s[4 * TJ + c]);
  const float mz = (r.z - r.pz) - (s[2 * TJ + c] - s[5 * TJ + c]);
  const float rel_n = (mx * dx + my * dy + mz * dz) * (inv_dist * inv_dist);
  const float tx = mx - rel_n * dx;
  const float ty = my - rel_n * dy;
  const float tz = mz - rel_n * dz;
  const float inv_tnorm = rsqrtf(tx * tx + ty * ty + tz * tz + kEps);
  const float max_slide = fmaxf(pp.friction * overlap, 0.0f);
  const float fscale = fminf(1.0f, max_slide * inv_tnorm) * share;
  acc.x += dx * mag - tx * fscale;
  acc.y += dy * mag - ty * fscale;
  acc.z += dz * mag - tz * fscale;
  acc.w += 1.0f;
}

// One staged col block against the thread's row. Lane `lane` takes the
// columns 16 t + 4 lane + q: the distance test on four columns from three
// float4 loads, then add_contact for those within the distance, in column
// order.
template <int TJ, bool REST_FILTER>
__device__ __forceinline__ void sweep_staged(const RowAttrs& r, const float* s,
                                             int lane, const PairParams& pp,
                                             float4& acc) {
#pragma unroll 2
  for (int c0 = 4 * lane; c0 < TJ; c0 += 4 * kLanes) {
    const float4 X = *reinterpret_cast<const float4*>(s + c0);
    const float4 Y = *reinterpret_cast<const float4*>(s + TJ + c0);
    const float4 Z = *reinterpret_cast<const float4*>(s + 2 * TJ + c0);
    float dx, dy, dz;
    unsigned near = 0;
    near |= within(pair_d2(r, X.x, Y.x, Z.x, dx, dy, dz), pp.dist2) ? 1u : 0u;
    near |= within(pair_d2(r, X.y, Y.y, Z.y, dx, dy, dz), pp.dist2) ? 2u : 0u;
    near |= within(pair_d2(r, X.z, Y.z, Z.z, dx, dy, dz), pp.dist2) ? 4u : 0u;
    near |= within(pair_d2(r, X.w, Y.w, Z.w, dx, dy, dz), pp.dist2) ? 8u : 0u;
    while (near) {
      const int q = __ffs(near) - 1;
      near &= near - 1;
      add_contact<TJ, REST_FILTER>(r, s, c0 + q, pp, acc);
    }
  }
}

// jnp.sign: -1, 0 or 1, and the zero itself for a zero.
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// K4's stage, op for op as _shape_stage: the particle at (x, y, z), which
// started the substep at (px, py, pz), against each of n_shapes rows of
// shp [kind, valid, size3, pos3, quat4 (xyzw), vel3, 0] and, for a convex
// shape, its n_planes local halfspaces [n3, d] in planes. Returns the
// summed corrections and the number of shapes in contact. Only the branch
// of the shape's own kind is computed; the Pallas stage computes all and
// selects one, which gives the same values. shape_collision_margin is not
// read, as the Pallas stage does not read it.
__device__ __forceinline__ void shape_stage(const RowAttrs& r,
                                            const float* shp,
                                            const float* planes, int n_shapes,
                                            int n_planes, float cd,
                                            float dyn_friction, float dt,
                                            float& ax, float& ay, float& az,
                                            float& cnt) {
  const float ux = r.x - r.px;
  const float uy = r.y - r.py;
  const float uz = r.z - r.pz;
  ax = ay = az = cnt = 0.0f;
  for (int m = 0; m < n_shapes; ++m) {
    const float* q = shp + m * 16;
    const float kind = q[0], valid = q[1];
    const float hx = q[2], hy = q[3], hz = q[4];
    const float sx = q[5], sy = q[6], sz = q[7];
    const float qx = q[8], qy = q[9], qz = q[10], qw = q[11];
    const float vx = q[12], vy = q[13], vz = q[14];
    // rotation matrix R from the quaternion; world->local uses R^T
    const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float r01 = 2.0f * (qx * qy - qz * qw);
    const float r02 = 2.0f * (qx * qz + qy * qw);
    const float r10 = 2.0f * (qx * qy + qz * qw);
    const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    const float r12 = 2.0f * (qy * qz - qx * qw);
    const float r20 = 2.0f * (qx * qz - qy * qw);
    const float r21 = 2.0f * (qy * qz + qx * qw);
    const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    const float wx = r.x - sx, wy = r.y - sy, wz = r.z - sz;
    const float qxp = r00 * wx + r10 * wy + r20 * wz;
    const float qyp = r01 * wx + r11 * wy + r21 * wz;
    const float qzp = r02 * wx + r12 * wy + r22 * wz;

    float sd, nlx, nly, nlz;
    if (kind == kBox) {
      const float dxb = fabsf(qxp) - hx;
      const float dyb = fabsf(qyp) - hy;
      const float dzb = fabsf(qzp) - hz;
      const float ox = fmaxf(dxb, 0.0f);
      const float oy = fmaxf(dyb, 0.0f);
      const float oz = fmaxf(dzb, 0.0f);
      const float d2o = ox * ox + oy * oy + oz * oz;
      const float inv_out = rsqrtf(d2o + kEps2);
      const float dist_out = d2o * inv_out;
      const float max_d = fmaxf(dxb, fmaxf(dyb, dzb));
      sd = dist_out + fminf(max_d, 0.0f);
      if (max_d > 0.0f) {  // outside: gradient of |max(d, 0)|
        nlx = ox * sgn(qxp) * inv_out;
        nly = oy * sgn(qyp) * inv_out;
        nlz = oz * sgn(qzp) * inv_out;
      } else {  // inside: face of least penetration, first axis on ties
        const bool is_x = (dxb >= dyb) && (dxb >= dzb);
        const bool is_y = !is_x && (dyb >= dzb);
        const bool is_z = !(is_x || is_y);
        nlx = is_x ? sgn(qxp) : 0.0f;
        nly = is_y ? sgn(qyp) : 0.0f;
        nlz = is_z ? sgn(qzp) : 0.0f;
      }
    } else if (kind == kCapsule) {  // axis +x; size = radius, half_len, _
      const float a_c = fminf(fmaxf(qxp, -hy), hy);
      const float cdx = qxp - a_c;
      const float d2c = cdx * cdx + qyp * qyp + qzp * qzp;
      const float inv_dc = rsqrtf(d2c + kEps2);
      sd = d2c * inv_dc - hx;
      nlx = cdx * inv_dc;
      nly = qyp * inv_dc;
      nlz = qzp * inv_dc;
    } else {  // plane (local y-up), and a convex shape's default
      sd = qyp;
      nlx = 0.0f;
      nly = 1.0f;
      nlz = 0.0f;
    }
    if (n_planes > 0 && kind == kConvex) {
      // running max over the halfspaces; the strict > keeps the first
      // plane of a tie, as argmax does
      float sd_cx = -3e37f, nxx = 0.0f, nxy = 0.0f, nxz = 0.0f;
      bool any_valid = false;
      const float* pl = planes + (size_t)m * n_planes * 4;
      for (int k = 0; k < n_planes; ++k) {
        const float n0 = pl[4 * k], n1 = pl[4 * k + 1], n2 = pl[4 * k + 2];
        const float pd = pl[4 * k + 3];
        const bool pv = n0 * n0 + n1 * n1 + n2 * n2 > 0.25f;
        float sp = qxp * n0 + qyp * n1 + qzp * n2 - pd;
        sp = pv ? sp : -3e37f;
        if (sp > sd_cx) {
          sd_cx = sp;
          nxx = n0;
          nxy = n1;
          nxz = n2;
        }
        any_valid = any_valid || pv;
      }
      sd = any_valid ? sd_cx : 3e37f;
      nlx = nxx;
      nly = nxy;
      nlz = nxz;
    }
    // local->world normal (R @ n)
    const float nwx = r00 * nlx + r01 * nly + r02 * nlz;
    const float nwy = r10 * nlx + r11 * nly + r12 * nlz;
    const float nwz = r20 * nlx + r21 * nly + r22 * nlz;

    const float pen = cd - sd;
    const float cf = (pen > 0.0f && valid > 0.5f) ? 1.0f : 0.0f;
    // Coulomb friction on the tangential relative displacement; the shape
    // velocity is the frame's, the time step the substep's
    const float rx = ux - vx * dt;
    const float ry = uy - vy * dt;
    const float rz = uz - vz * dt;
    const float rel_n = rx * nwx + ry * nwy + rz * nwz;
    const float tx = rx - nwx * rel_n;
    const float ty = ry - nwy * rel_n;
    const float tz = rz - nwz * rel_n;
    const float t2 = tx * tx + ty * ty + tz * tz;
    const float inv_t = rsqrtf(t2 + kEps2);
    const float t_norm = t2 * inv_t;
    const float max_slide = dyn_friction * fabsf(pen);
    const float scale = fminf(1.0f, max_slide / (t_norm + kEps)) * cf;
    ax = ax + nwx * (pen * cf) - tx * scale;
    ay = ay + nwy * (pen * cf) - ty * scale;
    az = az + nwz * (pen * cf) - tz * scale;
    cnt = cnt + cf;
  }
}

struct ContactArgs {
  const float* rows;
  const float* cols;
  const int* block_idx;
  const int* block_cnt;
  // [rest_dist, particle_friction, filter_dist] and, with shapes,
  // [collision_distance, shape_collision_margin, dynamic_friction, dt]
  const float* scal;
  const float* shp;     // (n_shapes, 16), K4 only
  const float* planes;  // (n_shapes * n_planes, 4), K4 only
  float* delta;
  float* count;
  int n, n_pad, maxb, n_shapes, n_planes;
};

// Ranks per row tile (the cluster size S) of the sweep, from the shapes
// and the card alone: the largest power of two up to kMaxSplit that gives
// every rank a slot of a full list of `slots` and keeps the grid (n_tiles x
// S CTAs) within one CTA an SM. A power of two divides the 128 rows the
// ranks finish. Past one CTA an SM the ranks' fixed cost (launch, barriers,
// the partial rows) outweighs the shorter sweeps (PERF.md, section 5).
// Built with -DAG_SPLIT=S (1, 2, 4 or 8), every sweep takes S instead: the
// variants tools/kernel_turns.py times.
int split_ranks(int n_tiles, int slots) {
#ifdef AG_SPLIT
  static_assert(AG_SPLIT == 1 || AG_SPLIT == 2 || AG_SPLIT == 4 ||
                    AG_SPLIT == 8,
                "AG_SPLIT divides the 128 rows and is a portable cluster");
  (void)n_tiles;
  (void)slots;
  return AG_SPLIT;
#else
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
    if (sms <= 0) return 1;
  }
  int s = 1;
  while (2 * s <= kMaxSplit && 2 * s <= slots && n_tiles * 2 * s <= sms)
    s *= 2;
  return s;
#endif
}

template <int TJ>
__host__ __device__ constexpr size_t stage_floats() {
  return (size_t)2 * kAttrs * TJ;  // two staging buffers
}

template <int TJ>
size_t sweep_smem_bytes(int shape_floats) {
  return stage_floats<TJ>() * 4 + kTile * sizeof(float4) +
         (size_t)shape_floats * 4;
}

// K1 (DENSE false; K4 when SHAPES) and K3 (DENSE true: slot k is col block
// k, TJ 128, the rest filter on). A cluster of `split` CTAs per row tile;
// see the header for the layout and the order of the sums.
template <int TJ, bool REST_FILTER, bool SHAPES, bool DENSE>
__global__ void __launch_bounds__(kSweepThreads, 2)
    contact_sweep_kernel(const ContactArgs g, int split) {
  extern __shared__ float4 smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float4* partial = smem + stage_floats<TJ>() / 4;  // kTile rows
  float* shapes = reinterpret_cast<float*>(partial + kTile);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.x / split;  // the row tile
  const int tid = threadIdx.x;
  const int row = tid / kLanes, lane = tid % kLanes;
  const PairParams pp = pair_params(g.scal);
  // this rank finishes rows [share * rank, share * (rank + 1)) of the tile,
  // one a thread
  const int share = kTile / split;
  const int q = rank * share + tid;
  const int p = i * kTile + q;
  const bool finish = tid < share && p < g.n;
  float4 sh = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (SHAPES) {
    const int ns = g.n_shapes * 16;
    const int nf = ns + g.n_shapes * g.n_planes * 4;
    for (int e = tid; e < nf; e += kSweepThreads)
      shapes[e] = e < ns ? g.shp[e] : g.planes[e - ns];
    __syncthreads();
    // K4's stage first; it overlaps the first staging copy only, as the
    // sweep's first barrier waits for it
    if (finish)
      shape_stage(load_row(g.rows, p), shapes, shapes + g.n_shapes * 16,
                  g.n_shapes, g.n_planes, g.scal[3], g.scal[5], g.scal[6],
                  sh.x, sh.y, sh.z, sh.w);
  }
  const int cnt = DENSE ? g.n_pad / TJ : min(g.block_cnt[i], g.maxb);
  // this rank's slots: rank, rank + split, ... below cnt
  const int mine = rank < cnt ? (cnt - rank + split - 1) / split : 0;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (mine > 0) {
    const int* list = DENSE ? nullptr : g.block_idx + (size_t)i * g.maxb;
    const RowAttrs r = load_row(g.rows, i * kTile + row);
    // an inactive row has no eligible pair: its sums stay 0
    const bool row_on = r.a > 0.5f;
    stage_block_async<TJ>(stage, g.cols, g.n_pad, DENSE ? rank : list[rank]);
    cp_async_commit();
    for (int m = 0; m < mine; ++m) {
      if (m + 1 < mine) {
        const int k = rank + (m + 1) * split;
        stage_block_async<TJ>(stage + ((m + 1) & 1) * kAttrs * TJ, g.cols,
                              g.n_pad, DENSE ? k : list[k]);
      }
      cp_async_commit();  // maybe empty: slot m's group is then complete
      cp_async_wait_one();
      __syncthreads();
      if (row_on)
        sweep_staged<TJ, REST_FILTER>(r, stage + (m & 1) * kAttrs * TJ, lane,
                                      pp, acc);
      __syncthreads();  // before the next copy lands in this buffer
    }
  }
  // the lanes of a row: (l0 + l1) + (l2 + l3), the same value on each lane
  for (int o = 1; o < kLanes; o <<= 1) {
    acc.x = acc.x + __shfl_xor_sync(0xffffffffu, acc.x, o);
    acc.y = acc.y + __shfl_xor_sync(0xffffffffu, acc.y, o);
    acc.z = acc.z + __shfl_xor_sync(0xffffffffu, acc.z, o);
    acc.w = acc.w + __shfl_xor_sync(0xffffffffu, acc.w, o);
  }
  if (lane == 0) partial[row] = acc;
  cluster.sync();  // every rank's partial rows are in place
  if (finish) {
    // the ranks that had a slot, in rank order (the others hold zeros)
    float4 tot = cluster.map_shared_rank(partial, 0)[q];
    const int used = min(split, cnt);
    for (int k = 1; k < used; ++k) {
      const float4 v = cluster.map_shared_rank(partial, k)[q];
      tot.x = tot.x + v.x;
      tot.y = tot.y + v.y;
      tot.z = tot.z + v.z;
      tot.w = tot.w + v.w;
    }
    if (SHAPES) {  // the Pallas wrapper's `pair + shape`, one rounding each
      tot.x = tot.x + sh.x;
      tot.y = tot.y + sh.y;
      tot.z = tot.z + sh.z;
      tot.w = tot.w + sh.w;
    }
    g.delta[(size_t)p * 3 + 0] = tot.x;
    g.delta[(size_t)p * 3 + 1] = tot.y;
    g.delta[(size_t)p * 3 + 2] = tot.z;
    g.count[p] = tot.w;
  }
  cluster.sync();  // no CTA leaves while another reads its partial rows
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
  __shared__ float s[kAttrs * TJ];
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
    for (int c = 0; c < TJ && !any; ++c)
      any = eligible<TJ, REST_FILTER>(r, s, c, dist2, filt2);
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

template <int TJ, bool RF, bool SH, bool DENSE>
int launch_sweep(const ContactArgs& g, int split, cudaStream_t stream) {
  auto kernel = contact_sweep_kernel<TJ, RF, SH, DENSE>;
  const int shape_floats =
      SH ? g.n_shapes * 16 + g.n_shapes * g.n_planes * 4 : 0;
  const size_t smem = sweep_smem_bytes<TJ>(shape_floats);
  static size_t opted_in = 48 * 1024;  // the default dynamic limit
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = split;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.n_pad / kTile) * split);
  cfg.blockDim = dim3(kSweepThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, g, split);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool SH>
int dispatch_contact(const ContactArgs& g, int tile_j, int rest_filter,
                     cudaStream_t st) {
  const int split = split_ranks(g.n_pad / kTile, g.maxb);
  if (tile_j == 128)
    return rest_filter ? launch_sweep<128, true, SH, false>(g, split, st)
                       : launch_sweep<128, false, SH, false>(g, split, st);
  return rest_filter ? launch_sweep<256, true, SH, false>(g, split, st)
                     : launch_sweep<256, false, SH, false>(g, split, st);
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

// The sweep stages with 16-byte copies and loads rows as float4.
bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

}  // namespace

extern "C" {

int ag_block_sparse_contact(const float* rows, const float* cols,
                            const int* block_idx, const int* block_cnt,
                            const float* scal, float* delta, float* count,
                            int n, int n_pad, int maxb, int tile_j,
                            int rest_filter, void* stream) {
  if (!shapes_ok(n_pad, maxb, tile_j) || n > n_pad || !aligned16(rows, cols))
    return (int)cudaErrorInvalidValue;
  const ContactArgs g{rows,  cols,  block_idx, block_cnt, scal, nullptr,
                      nullptr, delta, count, n, n_pad, maxb, 0, 0};
  return dispatch_contact<false>(g, tile_j, rest_filter,
                                 static_cast<cudaStream_t>(stream));
}

int ag_block_sparse_contact_shapes(const float* rows, const float* cols,
                                   const int* block_idx, const int* block_cnt,
                                   const float* scal, const float* shp,
                                   const float* planes, float* delta,
                                   float* count, int n, int n_pad, int maxb,
                                   int tile_j, int rest_filter, int n_shapes,
                                   int n_planes, void* stream) {
  if (!shapes_ok(n_pad, maxb, tile_j) || n > n_pad || n_shapes <= 0 ||
      n_planes < 0 || !aligned16(rows, cols) ||
      n_shapes * 16 + n_shapes * n_planes * 4 > kMaxShapeFloats ||
      (n_planes > 0 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  const ContactArgs g{rows,   cols,  block_idx, block_cnt, scal,
                      shp,    planes, delta,    count,     n,
                      n_pad,  maxb,  n_shapes,  n_planes};
  return dispatch_contact<true>(g, tile_j, rest_filter,
                                static_cast<cudaStream_t>(stream));
}

int ag_dense_contact(const float* rows, const float* cols, const float* scal,
                     float* delta, float* count, int n, int n_pad,
                     void* stream) {
  if (n_pad <= 0 || n_pad % kTile != 0 || n > n_pad || !aligned16(rows, cols))
    return (int)cudaErrorInvalidValue;
  const ContactArgs g{rows,  cols,  nullptr, nullptr, scal, nullptr,
                      nullptr, delta, count, n, n_pad, 0, 0, 0};
  return launch_sweep<kTile, true, false, true>(
      g, split_ranks(n_pad / kTile, n_pad / kTile),
      static_cast<cudaStream_t>(stream));
}

// The launch geometry of K1, K2 or K3 (kernel = 1, 2 or 3) at these shapes,
// as their launches set it: out = [CTAs, cluster size S, lanes per row,
// threads per CTA].
int ag_contact_geometry(int kernel, int n_pad, int maxb, int* out) {
  if (kernel < 1 || kernel > 3 || n_pad <= 0 || n_pad % kTile != 0 ||
      (kernel != 3 && maxb <= 0))
    return (int)cudaErrorInvalidValue;
  const int tiles = n_pad / kTile;
  if (kernel == 2) {  // launch_refine: a CTA of kTile threads per row tile
    out[0] = tiles;
    out[1] = 1;
    out[2] = 1;
    out[3] = kTile;
    return 0;
  }
  const int split = split_ranks(tiles, kernel == 3 ? tiles : maxb);
  out[0] = tiles * split;
  out[1] = split;
  out[2] = kLanes;
  out[3] = kSweepThreads;
  return 0;
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
             : launch_refine<256, false>(rows, cols, block_idx, block_cnt,
                                         scal, new_idx, new_cnt, n_pad, maxb, st);
}

const char* ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
