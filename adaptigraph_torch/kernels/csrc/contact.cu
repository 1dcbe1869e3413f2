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
//      Runs once per frame, over the frame's AABB block lists.
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
// What bounds them on this card: a kernel reads a few MB at most.
// Detection costs 26 float32 operations a pair it must test (K1 and K3
// every listed pair, so operations bound them; K2 only the pairs within
// its keep distance, which no culling can skip, so bytes bound it),
// projection and friction 52 more a contact (K1, K3), K4's stage about 100
// a particle and shape (bytes bound it); with -fmad=false none of them
// fuse. Those floors are microseconds; what keeps a kernel from them is
// occupancy and latency: few row tiles for 132 SMs (16 at 2,048 particles,
// 40 at the rope's 5,120), a row's pairs as one dependent chain if one
// thread takes them, a block that must be staged before it is tested, and,
// for K2, lists several times longer than K1's (up to ~20 blocks a row tile
// at the granular design point), most of whose blocks hold no pair within
// the keep distance, which a test of every pair reads in full.
//
// One layout serves K1, K2 and K3:
// - A thread block cluster of S CTAs per row tile. Rank s takes the list
//   slots s, s + S, s + 2S, ... below the tile's count: strided slots
//   spread a front-loaded list over every rank where contiguous ranges
//   would leave it to rank 0. S comes from the shapes and the SM count
//   alone, never from the counts on the device, so the host never waits
//   for the device (split_ranks for the sweeps, refine_ranks for K2).
// - 512 threads a CTA: L = 4 lanes for each of the 128 rows, the lanes of
//   a row side by side in one warp. Lane l takes the columns 16 t + 4 l + q
//   of each staged block (t ascending, then q = 0..3) and reads four
//   columns' x, y, z with three float4 shared-memory loads, so the loads
//   neither conflict nor bound the loop. 16 warps a row tile, and each
//   thread's chain of pair steps a quarter of the row's.
// - The distance test runs on every pair (K2: of the groups it does not
//   cull); the rest of the detection runs in a per-thread branch for the
//   pairs that pass it, in column order.
// - Staging by cp.async into two buffers of 13 attribute rows x tile_j
//   floats (26 KB at tile_j 256): the next listed block is on its way
//   while the current one is tested.
//
// The sweep (contact_sweep_kernel: K1, K3, and K4 fused into K1):
// - One pass a block: projection and friction run in the same branch as
//   the rest of the detection. A block with no contact costs no more than
//   its distance tests.
// - S: the largest power of two up to 8 with at most one CTA an SM. On the
//   H100 (132 SMs) 8 for K3 at 2,048 particles (128 CTAs), 2 for K1 at the
//   rope (80 CTAs) and 1 at the granular 32,768 (256 CTAs): lists after K2
//   are short, and past one CTA an SM the ranks' fixed cost (launch,
//   staging, barriers) outweighed the shorter sweeps.
// - The sums, in a fixed order, with no atomics: each thread adds its
//   contact terms in its column order, starting from 0; the lanes of a row
//   combine by warp shuffles as (l0 + l1) + (l2 + l3); each CTA keeps its
//   128 partial rows (float4: delta, count) in shared memory; after a
//   cluster barrier thread t of rank s adds up row 128 s / S + t of its
//   share [128 s / S, 128 (s + 1) / S) over the ranks that had a slot, in
//   rank order, through distributed shared memory, and writes it. Two
//   launches on the same inputs give the same bits. The order differs from
//   the plain versions', so deltas agree with them to float32 rounding
//   (2e-5 is the gate) and counts exactly.
// - K4. Its stage is a chain of about 100 dependent operations a shape,
//   with a reciprocal square root and an IEEE division, on every CTA's
//   critical path. The lanes of a row split the shapes (lane l takes
//   shapes l, l + 4, ...), so every thread works and the chain at the
//   design point's 4 valid shapes is one shape long. An invalid slot (the
//   design point passes 8 slots, 4 of them valid) adds exactly nothing in
//   the plain stage, so it is skipped. The shape and plane tables land in
//   dynamic shared memory with the first block's cp.async group, so the
//   stage waits on no barrier of its own: it runs after the sweep, where
//   the loop's barriers have made the tables visible (over an empty list,
//   after one wait and barrier). The lanes' partials combine by the same
//   shuffle tree, (l0 + l1) + (l2 + l3), into a shared row of shape sums
//   that the finishing thread adds last as `pair + shape`, one rounding
//   each, as the Pallas wrapper adds them.
//   Counts stay exact (sums of 0 and 1); deltas change only by the
//   association across shapes.
//
// K2 (refine_blocks_kernel), what it does about its long lists:
// - Cull, then test: a warp spans its 8 rows once (their box, their
//   groups, whether one self-collides), and the CTA spans each staged
//   block's column groups (16 columns, the warp's step) into shared
//   memory, one thread a column, by shuffles. The distance tests run only
//   on the groups whose box lies within the keep distance of the rows'
//   box, with a margin (kCullSlack) far above float32 rounding, and whose
//   particles are not all of the rows' one group (where no pair collides
//   unless the rest filter lets self-colliding pairs through). No pair the
//   plain version admits is culled. Inactive rows and columns are left
//   out: they have no eligible pair. In a granular pile a granule is one
//   group, and most of a listed block's groups are culled; PERF.md,
//   section 5, has where K2's time goes.
// - Vote, then leave: each warp votes (__any_sync) once a column group;
//   the first eligible pair sets the block's flag in shared memory, and
//   every warp leaves the block at its next vote. A kept block stops
//   early. A warp whose 8 rows are all inactive skips the tile's blocks.
// - Flags are independent per slot, so the slots are split over the S
//   ranks of a cluster like the sweep's; each rank writes its slots' flags
//   into rank 0's shared memory (distributed shared memory), and after a
//   cluster barrier one warp of rank 0 compacts the list: flagged slots
//   first, then the rest including the slots at or past the count, each in
//   slot order (the stable top_k of the JAX version), by ballots and
//   population counts. No atomics decide the order.
// - S (refine_ranks): 2 where maxb >= 2, else 1. That is what the times
//   at each S (PERF.md, section 5) support: K2's lists are several times
//   longer than K1's, so a second rank pays for its fixed cost, and after
//   culling 4 and 8 did not. On the H100 that is 512 CTAs at the granular
//   design point, two waves of two CTAs an SM (registers allow no more),
//   and 80 at the rope.
// - Detection is op for op the plain version's, so its lists are equal to
//   refine_blocks_plain's (torch.equal), and K1 over them equals K1 over
//   the unrefined lists.
//
// No tensor cores. An MMA form of |xi - xj|^2 (|xi|^2 + |xj|^2 - 2 xi.xj)
// rounds otherwise than the plain version's differences and squares; it
// would flip contact decisions and break the exact counts and K2's exact
// lists. The pair math stays float32 CUDA-core work.
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
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifdef AG_SPLIT
static_assert(AG_SPLIT == 1 || AG_SPLIT == 2 || AG_SPLIT == 4 || AG_SPLIT == 8,
              "AG_SPLIT divides the 128 rows and is a portable cluster");
#endif

namespace {

constexpr int kTile = 128;      // row tile: 128 particles
constexpr int kAttrs = 13;      // attribute rows the contact math reads
constexpr int kMaxBlocks = 128; // widest block list (solver's maxb rule)
constexpr int kMaxShapeFloats = 8192;  // K4 shape + plane tables (32 KB)
constexpr int kLanes = 4;              // threads per row
constexpr int kThreads = kTile * kLanes;
constexpr int kMaxSplit = 8;           // the portable cluster size
constexpr unsigned kWarp = 0xffffffffu;
constexpr int kGroup = 16;  // columns a warp tests in one step (4 lanes x 4)
// K2 culls a column group by distance only when its box lies farther from
// the warp's rows than the keep distance by this relative margin on the
// squares, far above the ~1e-6 by which float32 rounding can move a pair's
// d2 below the box distance: such a group holds no pair the distance test
// passes
constexpr float kCullSlack = 1.001f;
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

// Col block j's 13 attribute rows into s (kAttrs x TJ), as 16-byte
// cp.async copies that land while the caller works; the caller commits
// them as one group.
template <int TJ>
__device__ __forceinline__ void stage_block_async(
    float* s, const float* __restrict__ cols, int n_pad, int j) {
  constexpr int kChunks = TJ / 4;  // 16-byte chunks per attribute row
  const float* src = cols + (size_t)j * TJ;
  for (int e = threadIdx.x; e < kAttrs * kChunks; e += kThreads) {
    const int a = e / kChunks, q = e - a * kChunks;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(s + a * TJ + q * 4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + (size_t)a * n_pad + q * 4)
                 : "memory");
  }
}

// One float, asynchronously (K4's tables, whose rows need not be 16-byte
// aligned).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// The distance test on lane `lane`'s four columns c0 .. c0 + 3 of a staged
// block (three float4 loads): bit q set when column c0 + q is within.
template <int TJ>
__device__ __forceinline__ unsigned near_four(const RowAttrs& r,
                                              const float* s, int c0,
                                              float dist2) {
  const float4 X = *reinterpret_cast<const float4*>(s + c0);
  const float4 Y = *reinterpret_cast<const float4*>(s + TJ + c0);
  const float4 Z = *reinterpret_cast<const float4*>(s + 2 * TJ + c0);
  float dx, dy, dz;
  unsigned near = 0;
  near |= within(pair_d2(r, X.x, Y.x, Z.x, dx, dy, dz), dist2) ? 1u : 0u;
  near |= within(pair_d2(r, X.y, Y.y, Z.y, dx, dy, dz), dist2) ? 2u : 0u;
  near |= within(pair_d2(r, X.z, Y.z, Z.z, dx, dy, dz), dist2) ? 4u : 0u;
  near |= within(pair_d2(r, X.w, Y.w, Z.w, dx, dy, dz), dist2) ? 8u : 0u;
  return near;
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

// One staged col block against the thread's row (K1, K3): the distance
// test on lane `lane`'s columns, then add_contact for those within the
// distance, in column order.
template <int TJ, bool REST_FILTER>
__device__ __forceinline__ void sweep_staged(const RowAttrs& r, const float* s,
                                             int lane, const PairParams& pp,
                                             float4& acc) {
#pragma unroll 2
  for (int c0 = 4 * lane; c0 < TJ; c0 += 4 * kLanes) {
    unsigned near = near_four<TJ>(r, s, c0, pp.dist2);
    while (near) {
      const int q = __ffs(near) - 1;
      near &= near - 1;
      add_contact<TJ, REST_FILTER>(r, s, c0 + q, pp, acc);
    }
  }
}

// What K2's culling knows of a set of particles: the box of the active
// ones (lo, hi), the least and the greatest of their groups, and whether
// one of them self-collides (sc 1). Empty: lo and glo +inf, hi and ghi
// -inf, sc 0.
struct Span {
  float lx, ly, lz, hx, hy, hz, glo, ghi, sc;
};

__device__ __forceinline__ Span point_span(float x, float y, float z,
                                           float group, float sc, bool on) {
  const float inf = CUDART_INF_F;
  return on ? Span{x, y, z, x, y, z, group, group, sc > 0.5f ? 1.0f : 0.0f}
            : Span{inf, inf, inf, -inf, -inf, -inf, inf, -inf, 0.0f};
}

__device__ __forceinline__ void grow(Span& a, const Span& o) {
  a.lx = fminf(a.lx, o.lx);
  a.ly = fminf(a.ly, o.ly);
  a.lz = fminf(a.lz, o.lz);
  a.hx = fmaxf(a.hx, o.hx);
  a.hy = fmaxf(a.hy, o.hy);
  a.hz = fmaxf(a.hz, o.hz);
  a.glo = fminf(a.glo, o.glo);
  a.ghi = fmaxf(a.ghi, o.ghi);
  a.sc = fmaxf(a.sc, o.sc);
}

// The span of the lanes whose index differs from this one's only in the
// bits from `first` up to (not including) `last`.
__device__ __forceinline__ Span warp_span(Span a, int first, int last) {
  for (int o = first; o < last; o <<= 1)
    grow(a, Span{__shfl_xor_sync(kWarp, a.lx, o),
                 __shfl_xor_sync(kWarp, a.ly, o),
                 __shfl_xor_sync(kWarp, a.lz, o),
                 __shfl_xor_sync(kWarp, a.hx, o),
                 __shfl_xor_sync(kWarp, a.hy, o),
                 __shfl_xor_sync(kWarp, a.hz, o),
                 __shfl_xor_sync(kWarp, a.glo, o),
                 __shfl_xor_sync(kWarp, a.ghi, o),
                 __shfl_xor_sync(kWarp, a.sc, o)});
  return a;
}

// K2's culling, in two steps. First the spans of the TJ / 16 column
// groups (columns 16 g .. 16 g + 15, the warp's step) of staged block s,
// once for the CTA: thread c < TJ spans column c, the 16 lanes of a group
// combine by shuffles, and the first writes the group's span to
// spans[3 g .. 3 g + 2] (lo and least group, hi and greatest group, sc).
template <int TJ>
__device__ __forceinline__ void span_groups(const float* s, float4* spans) {
  const int c = threadIdx.x;
  if (c >= TJ) return;  // whole warps: TJ is a multiple of 32
  Span b = warp_span(point_span(s[c], s[TJ + c], s[2 * TJ + c], s[6 * TJ + c],
                                s[8 * TJ + c], s[12 * TJ + c] > 0.5f),
                     1, kGroup);
  if ((c & (kGroup - 1)) == 0) {
    float4* o = spans + 3 * (c / kGroup);
    o[0] = make_float4(b.lx, b.ly, b.lz, b.glo);
    o[1] = make_float4(b.hx, b.hy, b.hz, b.ghi);
    o[2] = make_float4(b.sc, 0.0f, 0.0f, 0.0f);
  }
}

// Then, for a warp whose rows span `rows`: bit g set when column group g
// may hold an eligible pair with one of them (lane g tests group g). A
// group is culled
// - when the squared gap between the boxes exceeds dist2 * kCullSlack, or
// - when the rows and the columns all lie in one group, the same, and
//   cannot collide within it: without the rest filter, or with it when
//   the rows or the columns hold no self-colliding particle.
// Inactive rows and columns are left out of the spans: they have no
// eligible pair.
template <int TJ, bool REST_FILTER>
__device__ __forceinline__ unsigned near_groups(const Span& rows,
                                                const float4* spans,
                                                float dist2) {
  const int g = threadIdx.x & 31;
  bool near = false;
  if (g < TJ / kGroup) {
    const float4 lo = spans[3 * g], hi = spans[3 * g + 1];
    const float sc = spans[3 * g + 2].x;
    const float gx = fmaxf(fmaxf(lo.x - rows.hx, rows.lx - hi.x), 0.0f);
    const float gy = fmaxf(fmaxf(lo.y - rows.hy, rows.ly - hi.y), 0.0f);
    const float gz = fmaxf(fmaxf(lo.z - rows.hz, rows.lz - hi.z), 0.0f);
    const bool far = gx * gx + gy * gy + gz * gz > dist2 * kCullSlack;
    const bool one_group = rows.glo == rows.ghi && lo.w == hi.w &&
                           rows.glo == lo.w &&
                           !(REST_FILTER && rows.sc > 0.5f && sc > 0.5f);
    near = !far && !one_group;
  }
  return __ballot_sync(kWarp, near);
}

// One staged col block against the thread's row (K2), over the column
// groups `groups` left after culling: the distance test on lane `lane`'s
// four columns of the group, the rest of the detection on those within,
// until the first eligible pair. The warp votes once a group: when one of
// its threads has a hit, or another warp has flagged the block (`found`),
// it sets the flag and leaves. `groups` is the same on every lane, so
// every thread of the warp reaches each vote.
template <int TJ, bool REST_FILTER>
__device__ __forceinline__ void scan_staged(const RowAttrs& r, const float* s,
                                            int lane, unsigned groups,
                                            float dist2, float filt2,
                                            volatile int* found) {
  while (groups) {
    const int c0 = kGroup * (__ffs(groups) - 1) + 4 * lane;
    groups &= groups - 1;
    unsigned near = near_four<TJ>(r, s, c0, dist2);
    bool hit = false;
    while (near && !hit) {
      const int q = __ffs(near) - 1;
      near &= near - 1;
      hit = admitted<TJ, REST_FILTER>(r, s, c0 + q, filt2);
    }
    if (__any_sync(kWarp, hit || *found)) {
      if (hit) *found = 1;
      return;
    }
  }
}

// The lanes of a row: (l0 + l1) + (l2 + l3), the same value on each lane.
__device__ __forceinline__ float4 sum_lanes(float4 v) {
  for (int o = 1; o < kLanes; o <<= 1) {
    v.x = v.x + __shfl_xor_sync(kWarp, v.x, o);
    v.y = v.y + __shfl_xor_sync(kWarp, v.y, o);
    v.z = v.z + __shfl_xor_sync(kWarp, v.z, o);
    v.w = v.w + __shfl_xor_sync(kWarp, v.w, o);
  }
  return v;
}

// jnp.sign: -1, 0 or 1, and the zero itself for a zero.
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// K4's stage, op for op as _shape_stage: the particle at (x, y, z), which
// started the substep at (px, py, pz), against the shapes first, first +
// kLanes, ... of n_shapes rows of shp [kind, valid, size3, pos3, quat4
// (xyzw), vel3, 0] and, for a convex shape, its n_planes local halfspaces
// [n3, d] in planes. Returns the summed corrections and the number of
// shapes in contact, added from 0 in shape order. Only the branch of the
// shape's own kind is computed; the Pallas stage computes all and selects
// one, which gives the same values. shape_collision_margin is not read, as
// the Pallas stage does not read it.
__device__ __forceinline__ float4 shape_stage(const RowAttrs& r,
                                              const float* shp,
                                              const float* planes, int first,
                                              int n_shapes, int n_planes,
                                              float cd, float dyn_friction,
                                              float dt) {
  const float ux = r.x - r.px;
  const float uy = r.y - r.py;
  const float uz = r.z - r.pz;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, cnt = 0.0f;
  for (int m = first; m < n_shapes; m += kLanes) {
    const float* q = shp + m * 16;
    const float kind = q[0], valid = q[1];
    // the plain stage adds an invalid slot's terms times cf = 0, which
    // leaves the sums as they are (to the sign of a zero) for the finite
    // rows make_shapes pads with: skip it
    if (!(valid > 0.5f)) continue;
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
    const float cf = pen > 0.0f ? 1.0f : 0.0f;
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
  return make_float4(ax, ay, az, cnt);
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

struct RefineArgs {
  const float* rows;
  const float* cols;
  const int* block_idx;
  const int* block_cnt;
  const float* scal;  // [keep_dist, filter_dist]
  int* new_idx;
  int* new_cnt;
  int n_pad, maxb;
};

// The card's SM count, read once (0 when it cannot be read).
int sm_count() {
  static int sms = -1;
  if (sms < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// The sweep's ranks: the largest power of two S up to 8 and up to `slots`
// (so every rank has a slot of a full list) with at most one CTA an SM.
// Past that the ranks' fixed cost (launch, barriers, the partial rows)
// outweighs the shorter sweeps of K1's short lists (PERF.md, section 5). A
// power of two divides the 128 rows the ranks finish. Built with
// -DAG_SPLIT=S (1, 2, 4 or 8), every kernel takes S instead: the variants
// tools/kernel_turns.py times.
int split_ranks(int n_tiles, int slots) {
#ifdef AG_SPLIT
  (void)n_tiles;
  (void)slots;
  return AG_SPLIT;
#else
  const int sms = sm_count();
  int s = 1;
  while (2 * s <= kMaxSplit && 2 * s <= slots && n_tiles * 2 * s <= sms)
    s *= 2;
  return s;
#endif
}

// K2's ranks: 2 where a list has two slots, as measured at S = 1, 2, 4
// and 8 (PERF.md, section 5, K2 at each S).
int refine_ranks(int maxb) {
#ifdef AG_SPLIT
  (void)maxb;
  return AG_SPLIT;
#else
  return maxb >= 2 ? 2 : 1;
#endif
}

template <int TJ>
__host__ __device__ constexpr size_t stage_floats() {
  return (size_t)2 * kAttrs * TJ;  // two staging buffers
}

// K4 adds its per-row shape sums and its tables (shape_floats > 0).
template <int TJ>
size_t sweep_smem_bytes(int shape_floats) {
  return stage_floats<TJ>() * 4 + kTile * sizeof(float4) +
         (shape_floats > 0 ? kTile * sizeof(float4) : 0) +
         (size_t)shape_floats * 4;
}

template <int TJ>
constexpr size_t refine_smem_bytes() {
  return stage_floats<TJ>() * 4 + 3 * (TJ / kGroup) * sizeof(float4) +
         kMaxBlocks * sizeof(int);
}

// K1 (DENSE false; K4 when SHAPES) and K3 (DENSE true: slot k is col block
// k, TJ 128, the rest filter on). A cluster of `split` CTAs per row tile;
// see the header for the layout and the order of the sums.
template <int TJ, bool REST_FILTER, bool SHAPES, bool DENSE>
__global__ void __launch_bounds__(kThreads, 2)
    contact_sweep_kernel(const ContactArgs g, int split) {
  extern __shared__ float4 smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float4* partial = smem + stage_floats<TJ>() / 4;  // kTile rows
  float4* shape_sum = partial + kTile;              // kTile rows, K4 only
  float* shapes = reinterpret_cast<float*>(shape_sum + (SHAPES ? kTile : 0));
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
  const int cnt = DENSE ? g.n_pad / TJ : min(g.block_cnt[i], g.maxb);
  // this rank's slots: rank, rank + split, ... below cnt
  const int mine = rank < cnt ? (cnt - rank + split - 1) / split : 0;
  const int* list = DENSE ? nullptr : g.block_idx + (size_t)i * g.maxb;
  if (SHAPES) {  // K4's tables, in the first block's cp.async group
    const int ns = g.n_shapes * 16;
    const int nf = ns + g.n_shapes * g.n_planes * 4;
    for (int e = tid; e < nf; e += kThreads)
      cp_async4(shapes + e, e < ns ? g.shp + e : g.planes + (e - ns));
  }
  if (mine > 0)
    stage_block_async<TJ>(stage, g.cols, g.n_pad, DENSE ? rank : list[rank]);
  cp_async_commit();
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (mine > 0) {
    const RowAttrs r = load_row(g.rows, i * kTile + row);
    // an inactive row has no eligible pair: its sums stay 0
    const bool row_on = r.a > 0.5f;
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
  } else if (SHAPES) {
    cp_async_wait_all();
    __syncthreads();
  }
  acc = sum_lanes(acc);
  if (lane == 0) partial[row] = acc;
  if (SHAPES) {  // the tables are in place: the loop's barriers passed
    // the 4 lanes of each row this rank finishes split the shapes
    const int pr = i * kTile + row;
    float4 sh = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row / share == rank && pr < g.n)
      sh = shape_stage(load_row(g.rows, pr), shapes, shapes + g.n_shapes * 16,
                       lane, g.n_shapes, g.n_planes, g.scal[3], g.scal[5],
                       g.scal[6]);
    sh = sum_lanes(sh);
    if (lane == 0) shape_sum[row] = sh;
  }
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
      const float4 sh = shape_sum[q];
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
// eligible pair closer than keep_dist, then writes the row tile's list
// with the flagged blocks first and the rest after, each in slot order
// (the stable top_k of the JAX version), and the number flagged. A cluster
// of `split` CTAs per row tile; see the header.
template <int TJ, bool REST_FILTER>
__global__ void __launch_bounds__(kThreads, 2)
    refine_blocks_kernel(const RefineArgs g, int split) {
  extern __shared__ float4 smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float4* spans = smem + stage_floats<TJ>() / 4;  // 3 a column group
  int* flag = reinterpret_cast<int*>(spans + 3 * (TJ / kGroup));  // slots
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.x / split;  // the row tile
  const int tid = threadIdx.x;
  const int row = tid / kLanes, lane = tid % kLanes;
  const float keep_dist = g.scal[0], filter_dist = g.scal[1];
  const float dist2 = keep_dist * keep_dist;
  const float filt2 = filter_dist * filter_dist;
  const int cnt = min(g.block_cnt[i], g.maxb);
  // this rank's slots: rank, rank + split, ... below cnt
  const int mine = rank < cnt ? (cnt - rank + split - 1) / split : 0;
  const int* list = g.block_idx + (size_t)i * g.maxb;
  for (int m = tid; m < mine; m += kThreads) flag[rank + m * split] = 0;
  cluster.sync();  // every rank runs before one writes to rank 0's flags
  if (mine > 0) {
    const RowAttrs r = load_row(g.rows, i * kTile + row);
    // what culling knows of the warp's 8 rows (the lanes of a row hold the
    // same one); a warp whose rows are all inactive has no eligible pair
    const Span rows_span = warp_span(
        point_span(r.x, r.y, r.z, r.g, r.sc, r.a > 0.5f), kLanes, 32);
    const bool warp_on = __any_sync(kWarp, r.a > 0.5f);
    stage_block_async<TJ>(stage, g.cols, g.n_pad, list[rank]);
    cp_async_commit();
    for (int m = 0; m < mine; ++m) {
      const int k = rank + m * split;
      if (m + 1 < mine)
        stage_block_async<TJ>(stage + ((m + 1) & 1) * kAttrs * TJ, g.cols,
                              g.n_pad, list[k + split]);
      cp_async_commit();  // maybe empty: slot m's group is then complete
      cp_async_wait_one();
      __syncthreads();
      const float* sb = stage + (m & 1) * kAttrs * TJ;
      span_groups<TJ>(sb, spans);
      __syncthreads();
      if (warp_on)
        scan_staged<TJ, REST_FILTER>(
            r, sb, lane, near_groups<TJ, REST_FILTER>(rows_span, spans, dist2),
            dist2, filt2, flag + k);
      __syncthreads();  // before the next copy lands in this buffer
    }
  }
  // this rank's slots of the whole list (flagged: listed and hit) into
  // rank 0's flags; rank 0 writes its own in place
  int* flag0 = cluster.map_shared_rank(flag, 0);
  for (int k = rank + tid * split; k < g.maxb; k += kThreads * split)
    flag0[k] = (k < cnt && flag[k]) ? 1 : 0;
  cluster.sync();  // every slot's flag is in rank 0
  if (rank != 0 || tid >= 32) return;
  // one warp compacts: a flagged slot goes to the number of flagged slots
  // before it, any other to the number flagged plus the unflagged before it
  const unsigned below = (1u << tid) - 1u;
  int kept = 0;
  for (int c = 0; c < g.maxb; c += 32)
    kept += __popc(__ballot_sync(kWarp, c + tid < g.maxb && flag[c + tid]));
  int* dst = g.new_idx + (size_t)i * g.maxb;
  int front = 0, back = kept;
  for (int c = 0; c < g.maxb; c += 32) {
    const int k = c + tid;
    const bool in = k < g.maxb;
    const bool f = in && flag[k];
    const unsigned bf = __ballot_sync(kWarp, f);
    const unsigned br = __ballot_sync(kWarp, in && !f);
    if (in)
      dst[f ? front + __popc(bf & below) : back + __popc(br & below)] =
          list[k];
    front += __popc(bf);
    back += __popc(br);
  }
  if (tid == 0) g.new_cnt[i] = kept;
}

// Launch `kernel` over n_tiles clusters of `split` CTAs of kThreads.
template <typename Args>
int launch_clusters(void (*kernel)(Args, int), const Args& g, int n_tiles,
                    int split, size_t smem, cudaStream_t stream) {
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = split;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, g, split);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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
  return launch_clusters(kernel, g, g.n_pad / kTile, split, smem, stream);
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
int launch_refine(const RefineArgs& g, cudaStream_t stream) {
  return launch_clusters(refine_blocks_kernel<TJ, RF>, g, g.n_pad / kTile,
                         refine_ranks(g.maxb), refine_smem_bytes<TJ>(),
                         stream);
}

bool shapes_ok(int n_pad, int maxb, int tile_j) {
  return n_pad > 0 && n_pad % tile_j == 0 && maxb > 0 && maxb <= kMaxBlocks &&
         (tile_j == 128 || tile_j == 256);
}

// The kernels stage with 16-byte copies and load rows as float4.
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
  const int split = kernel == 2   ? refine_ranks(maxb)
                    : kernel == 3 ? split_ranks(tiles, tiles)
                                  : split_ranks(tiles, maxb);
  out[0] = tiles * split;
  out[1] = split;
  out[2] = kLanes;
  out[3] = kThreads;
  return 0;
}

int ag_refine_blocks(const float* rows, const float* cols,
                     const int* block_idx, const int* block_cnt,
                     const float* scal, int* new_idx, int* new_cnt, int n_pad,
                     int maxb, int tile_j, int rest_filter, void* stream) {
  if (!shapes_ok(n_pad, maxb, tile_j) || !aligned16(rows, cols))
    return (int)cudaErrorInvalidValue;
  const RefineArgs g{rows,    cols,    block_idx, block_cnt, scal,
                     new_idx, new_cnt, n_pad,     maxb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_j == 128)
    return rest_filter ? launch_refine<128, true>(g, st)
                       : launch_refine<128, false>(g, st);
  return rest_filter ? launch_refine<256, true>(g, st)
                     : launch_refine<256, false>(g, st);
}

const char* ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
