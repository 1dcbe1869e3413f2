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
//      kernel when shape tables are passed: K1's sweep, then each thread's
//      particle against every kinematic shape (box, capsule, plane, convex
//      polytope), added to its outputs.
//
// All read the packed attribute tables of pack_contact_tables:
//   rows (n_pad, 16) and cols (16, n_pad) float32, attribute a of particle p
//   at rows[p * 16 + a] == cols[a * n_pad + p]. Attributes: 0-2 pos,
//   3-5 pos_prev, 6 group, 7 inv_mass, 8 self_collide, 9-11 rest_pos,
//   12 active (13-15 unused).
// block_idx (nb, maxb) int32 lists, for each 128-particle row tile, the
// col blocks (tile_j particles wide) to sweep; block_cnt (nb,) how many.
// K3 sweeps every 128-wide col block in index order instead.
//
// Layout: one CTA per row tile, 128 threads, one row particle per thread
// (its attributes in registers). For each col block the CTA stages the
// block's 13 used attribute rows (13 x tile_j floats: 6.5 KB at tile_j
// 128, 13 KB at 256) into shared memory with coalesced loads; every thread
// then reads the same col entry at once (a shared-memory broadcast). K4
// stages the shape table (M x 16 floats) and the convex planes (M*P x 4)
// into dynamic shared memory once per CTA.
//
// What bounds them on this card: none is bound by the HBM rate or by the
// float32 rate. A sweep moves at most a few MB and does tens to hundreds of
// MFLOP, so its floor is a few microseconds; the time goes to launch
// latency and to the serial dependency chain inside a CTA (stage, barrier,
// 128 or 256 dependent pair steps per block). Only n_pad / 128 CTAs run on
// the 132 SMs (40 at the rope design point, 256 at the granular one, 16 at
// the dense band): a known weakness of this first version, left for a
// later change (split each row tile's block list over several CTAs and sum
// their partial rows in a second pass, or give a warp to each block).
//
// What the design does about it: the detection stage (~20 flops a pair)
// runs on every swept block; the projection stage (~60 flops a contact)
// runs only for blocks where __syncthreads_or finds a contact, and inside it
// only for contact pairs, as the Pallas kernel's lax.cond does. Each thread
// sums its own row in registers, in col order, and writes once: no atomics,
// so runs repeat bit for bit. K4's shape stage is ~150 flops per particle
// per shape, computed only for the shape's own kind.
//
// Numerics: build with -fmad=false. The detection stage and the shape
// stage then round every product and sum as the plain PyTorch versions do,
// op for op, so contact decisions (and hence counts and K2's block lists)
// match them exactly. rsqrtf is the hardware reciprocal square root, as
// lax.rsqrt is on the TPU; `share` takes an exact reciprocal and K4's
// friction scale an IEEE division. Deltas agree with the plain versions to
// float32 rounding.
//
// Every entry returns cudaGetLastError() (0 on success) after its launch, or
// cudaErrorInvalidValue for a shape it does not take; it never synchronizes.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;      // row tile: particles per CTA
constexpr int kAttrs = 13;      // attribute rows the contact math reads
constexpr int kMaxBlocks = 128; // widest block list (solver's maxb rule)
constexpr int kMaxShapeFloats = 8192;  // K4 shape + plane tables (32 KB)
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

// Pair eligibility, the detection stage shared by K1, K2 and K3: closer
// than `dist` (dist2 = dist * dist), not the same particle, both active,
// some inverse mass, and either different groups or both self-colliding
// and at least filter_dist apart at rest.
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

// The pair math of K1 and K3 over one staged col block: detection, and the
// projection + friction of each contact pair, summed into the thread's
// row in col order. Holds a barrier: every thread of the CTA calls it.
template <int TJ, bool REST_FILTER>
__device__ __forceinline__ void sweep_block(const RowAttrs& r, float (*s)[TJ],
                                            float rest_dist, float friction,
                                            float dist2, float filt2,
                                            float& ax, float& ay, float& az,
                                            float& ac) {
  bool any = false;
  float dx, dy, dz, d2;
  for (int c = 0; c < TJ && !any; ++c)
    any = eligible<TJ, REST_FILTER>(r, s, c, dist2, filt2, dx, dy, dz, d2);
  if (!__syncthreads_or(any)) return;  // no contact in the block
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

// K1, and K4 when SHAPES.
template <int TJ, bool REST_FILTER, bool SHAPES>
__global__ void __launch_bounds__(kTile)
    block_sparse_contact_kernel(const ContactArgs g) {
  __shared__ float s[kAttrs][TJ];
  extern __shared__ float shapes[];  // K4: shape rows, then planes
  const int i = blockIdx.x;
  const int p = i * kTile + threadIdx.x;
  const RowAttrs r = load_row(g.rows, p);
  const float rest_dist = g.scal[0], friction = g.scal[1];
  const float filter_dist = g.scal[2];
  const float dist2 = rest_dist * rest_dist;
  const float filt2 = filter_dist * filter_dist;
  if (SHAPES) {
    const int nf = g.n_shapes * 16 + g.n_shapes * g.n_planes * 4;
    for (int e = threadIdx.x; e < nf; e += kTile)
      shapes[e] = e < g.n_shapes * 16 ? g.shp[e] : g.planes[e - g.n_shapes * 16];
    __syncthreads();
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f, ac = 0.0f;
  const int cnt = min(g.block_cnt[i], g.maxb);
  for (int k = 0; k < cnt; ++k) {
    const int j = g.block_idx[i * g.maxb + k];
    __syncthreads();  // the previous block's shared reads are done
    stage_block<TJ>(s, g.cols, g.n_pad, j);
    __syncthreads();
    sweep_block<TJ, REST_FILTER>(r, s, rest_dist, friction, dist2, filt2, ax,
                                 ay, az, ac);
  }
  if (p >= g.n) return;
  if (SHAPES) {
    float sx, sy, sz, sc;
    shape_stage(r, shapes, shapes + g.n_shapes * 16, g.n_shapes, g.n_planes,
                g.scal[3], g.scal[5], g.scal[6], sx, sy, sz, sc);
    // the Pallas wrapper's `pair + shape`, one rounding each
    ax = ax + sx;
    ay = ay + sy;
    az = az + sz;
    ac = ac + sc;
  }
  g.delta[(size_t)p * 3 + 0] = ax;
  g.delta[(size_t)p * 3 + 1] = ay;
  g.delta[(size_t)p * 3 + 2] = az;
  g.count[p] = ac;
}

// K3: every 128-wide col block in index order, the rest filter always on
// (as _pair_block). The same pair math, in the same order per row, as K1
// over a full block list.
__global__ void __launch_bounds__(kTile)
    dense_contact_kernel(const ContactArgs g) {
  __shared__ float s[kAttrs][kTile];
  const int p = blockIdx.x * kTile + threadIdx.x;
  const RowAttrs r = load_row(g.rows, p);
  const float rest_dist = g.scal[0], friction = g.scal[1];
  const float filter_dist = g.scal[2];
  const float dist2 = rest_dist * rest_dist;
  const float filt2 = filter_dist * filter_dist;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, ac = 0.0f;
  for (int j = 0; j < g.n_pad / kTile; ++j) {
    __syncthreads();
    stage_block<kTile>(s, g.cols, g.n_pad, j);
    __syncthreads();
    sweep_block<kTile, true>(r, s, rest_dist, friction, dist2, filt2, ax, ay,
                             az, ac);
  }
  if (p < g.n) {
    g.delta[(size_t)p * 3 + 0] = ax;
    g.delta[(size_t)p * 3 + 1] = ay;
    g.delta[(size_t)p * 3 + 2] = az;
    g.count[p] = ac;
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

template <int TJ, bool RF, bool SH>
int launch_contact(const ContactArgs& g, cudaStream_t stream) {
  const size_t smem =
      SH ? (size_t)(g.n_shapes * 16 + g.n_shapes * g.n_planes * 4) * 4 : 0;
  block_sparse_contact_kernel<TJ, RF, SH>
      <<<g.n_pad / kTile, kTile, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool SH>
int dispatch_contact(const ContactArgs& g, int tile_j, int rest_filter,
                     cudaStream_t st) {
  if (tile_j == 128)
    return rest_filter ? launch_contact<128, true, SH>(g, st)
                       : launch_contact<128, false, SH>(g, st);
  return rest_filter ? launch_contact<256, true, SH>(g, st)
                     : launch_contact<256, false, SH>(g, st);
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
      n_planes < 0 ||
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
  if (n_pad <= 0 || n_pad % kTile != 0 || n > n_pad)
    return (int)cudaErrorInvalidValue;
  const ContactArgs g{rows,  cols,  nullptr, nullptr, scal, nullptr,
                      nullptr, delta, count, n, n_pad, 0, 0, 0};
  dense_contact_kernel<<<n_pad / kTile, kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
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
