"""Ray-cast renderer: analytic shape ray casts + particle point splatting.

The port of adaptigraph_tpu/sim/render.py. It produces (H, W, 5) frames,
RGB in [0, 1], alpha and metric depth (0 = background), with plain torch
ops on the device of its inputs:

  * kinematic shapes (table boxes, floor, tool capsule or board, the arm's
    convex link hulls) by exact per-pixel ray intersection, a Python loop
    over the shape slots with a running depth minimum (the JAX version's
    scan);
  * particles as screen-space discs, merged through a z-buffer: a
    scatter-min of the fragments' depths, then each pixel takes the colour
    of the last fragment (in fragment order) whose depth is within 1e-6 of
    the pixel's minimum, as the JAX version's ordered scatter does on the
    CPU. The port picks that fragment with a scatter-max of fragment
    indices, so the result does not depend on the order a GPU scatters in;
  * cloth scenes add a shaded triangle-mesh raster of the particle grid
    (ADAPTIGRAPH_CLOTH_MESH=0 keeps the shaded splats only).

Lambert shading from a fixed light direction keeps images contrastful for
the colour-difference action gate. Every product runs in full float32
(TF32 off): the ray and camera transforms set depths to the millimetre.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from adaptigraph_torch.engine.state import (
    SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CONVEX, ShapeSet)
from adaptigraph_torch.utils import geometry as geo
from adaptigraph_torch.utils.device import full_f32_matmul

_FAR = 1e9
_LIGHT = (0.3, 0.8, 0.5)
_BG = (0.9, 0.9, 0.9)
_SHAPE_COLOR = 160.0 / 255
_MESH_TILE = 8  # rasterization tile half-quad triangles fit into (pixels)


def _vec(vals, like):
    return torch.tensor(vals, dtype=torch.float32, device=like.device)


def _light_dir(like):
    light = _vec(_LIGHT, like)
    return light, torch.linalg.vector_norm(light)


def _ray_box(ro, rd, half):
    """Slab test: origin/dir in box local frame. Returns (t, normal)."""
    tiny = torch.where(rd >= 0, 1e-9, -1e-9)
    inv = 1.0 / torch.where(torch.abs(rd) < 1e-9, tiny, rd)
    t0 = (-half - ro) * inv
    t1 = (half - ro) * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    t_enter = torch.amax(tmin, dim=-1)
    t_exit = torch.amin(tmax, dim=-1)
    hit = t_exit >= torch.clamp(t_enter, min=0.0)
    t = torch.where(hit, torch.where(t_enter > 0, t_enter, t_exit), _FAR)
    # normal: axis of the entering slab (first maximum on ties, like JAX)
    axis = torch.argmax(tmin, dim=-1)
    n = -torch.sign(rd) * torch.nn.functional.one_hot(axis, 3).to(ro.dtype)
    return t, n


def _ray_capsule(ro, rd, radius, half_len):
    """Capsule along local x: the infinite-cylinder hit clamped to the
    segment, and the two cap spheres (which take |rd| = 1, as the JAX
    version does)."""
    oy = ro[..., 1:]
    dy = rd[..., 1:]
    a = torch.sum(dy * dy, dim=-1)
    b = 2 * torch.sum(oy * dy, dim=-1)
    c = torch.sum(oy * oy, dim=-1) - radius ** 2
    disc = b * b - 4 * a * c
    t_cyl = torch.where(
        disc >= 0,
        (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a + 1e-12), _FAR)
    px = ro[..., 0] + t_cyl * rd[..., 0]
    cyl_ok = (t_cyl > 0) & (torch.abs(px) <= half_len)
    t = torch.where(cyl_ok, t_cyl, _FAR)

    def sphere_t(center_x):
        zero = torch.zeros_like(ro[..., 0])
        oc = ro - torch.stack([center_x.expand(zero.shape), zero, zero], -1)
        b2 = 2 * torch.sum(oc * rd, dim=-1)
        c2 = torch.sum(oc * oc, dim=-1) - radius ** 2
        d2 = b2 * b2 - 4 * c2
        ts = torch.where(
            d2 >= 0, (-b2 - torch.sqrt(torch.clamp(d2, min=0.0))) / 2, _FAR)
        return torch.where(ts > 0, ts, _FAR)

    t = torch.minimum(t, torch.minimum(sphere_t(half_len), sphere_t(-half_len)))
    p = ro + t[..., None] * rd
    zero = torch.zeros_like(p[..., 0])
    closest = torch.stack([torch.clamp(p[..., 0], -half_len, half_len), zero,
                           zero], -1)
    n = p - closest
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    return torch.where(t < _FAR, t, _FAR), n


def _ray_convex(ro, rd, planes):
    """Convex polytope (intersection of halfspaces n.x <= d) ray cast, the
    render path of SHAPE_CONVEX shapes (the arm's link hulls). Generalised
    slab test: entering planes (n.rd < 0) set t_enter = max, exiting
    planes set t_exit = min. Zero-normal rows are padding."""
    n = planes[..., :3]  # (P, 3)
    d = planes[..., 3]
    pvalid = torch.sum(n * n, dim=-1) > 0.25
    denom = rd @ n.T  # (..., P)
    num = d - ro @ n.T
    tiny = torch.where(denom >= 0, 1e-9, -1e-9)
    parallel = torch.abs(denom) < 1e-9
    t = num / torch.where(parallel, tiny, denom)
    entering = denom < 0
    # parallel rays outside a plane never hit: force a miss via t_enter=inf
    outside_parallel = parallel & (num < 0) & pvalid
    t_in = torch.where(entering & pvalid, t, -_FAR)
    t_in = torch.where(outside_parallel, _FAR, t_in)
    t_out = torch.where((~entering) & pvalid & ~parallel, t, _FAR)
    t_enter = torch.amax(t_in, dim=-1)
    t_exit = torch.amin(t_out, dim=-1)
    hit = ((t_exit >= torch.clamp(t_enter, min=0.0)) & (t_enter < _FAR)
           & torch.any(pvalid))
    thit = torch.where(hit, torch.where(t_enter > 0, t_enter, _FAR), _FAR)
    best = torch.argmax((t_in == t_enter[..., None]).to(torch.float32), dim=-1)
    return thit, n[best]


def _ray_plane(ro, rd):
    t = -ro[..., 1] / torch.where(torch.abs(rd[..., 1]) < 1e-9, 1e-9,
                                  rd[..., 1])
    t = torch.where(t > 0, t, _FAR)
    n = torch.zeros_like(ro)
    n[..., 1] = 1.0
    return t, n


def cloth_vertex_normals(pos, dimx: int, dimz: int):
    """Per-vertex normals for a dimz x dimx cloth grid laid out row-major
    (build_cloth's gid = z * dimx + x). Central differences inside the
    grid, one-sided at the borders. Returns (N, 3) with zero rows past the
    grid, so non-grid and padding particles shade neutrally."""
    grid = pos[: dimx * dimz].reshape(dimz, dimx, 3)

    def diff(g, axis):
        m = g.shape[axis]
        lo = g.narrow(axis, 1, 1) - g.narrow(axis, 0, 1)
        hi = g.narrow(axis, m - 1, 1) - g.narrow(axis, m - 2, 1)
        mid = (g.narrow(axis, 2, m - 2) - g.narrow(axis, 0, m - 2)) * 0.5
        return torch.cat([lo, mid, hi], dim=axis)

    dx = diff(grid, 1)  # along x (columns)
    dz = diff(grid, 0)  # along z (rows)
    n = torch.linalg.cross(dz, dx, dim=-1)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    out = torch.zeros_like(pos)
    out[: dimx * dimz] = n.reshape(-1, 3)
    return out


def _cloth_grid_faces(dimx: int, dimz: int):
    """Triangle index array (T, 3) for the dimz x dimx row-major cloth grid:
    two triangles per quad, the topology the reference's mesh path draws.
    Host-side numpy: the dims are fixed for a scene."""
    z, x = np.meshgrid(np.arange(dimz - 1), np.arange(dimx - 1), indexing="ij")
    v00 = (z * dimx + x).ravel()
    v01 = v00 + 1
    v10 = v00 + dimx
    v11 = v10 + 1
    tris = np.concatenate([
        np.stack([v00, v10, v01], axis=-1),
        np.stack([v01, v10, v11], axis=-1)], axis=0)
    return tris.astype(np.int32)


def _mesh_enabled() -> bool:
    """ADAPTIGRAPH_CLOTH_MESH=0 drops the mesh fragments and keeps the
    shaded splats, as in the JAX package (read at each call here; at trace
    time there)."""
    return os.environ.get("ADAPTIGRAPH_CLOTH_MESH", "1") != "0"


def _cloth_mesh_fragments(pos, base_colors, faces, rot, cam_pos, intrinsics,
                          width: int, height: int):
    """Rasterize the cloth triangle mesh into z-buffer fragments: each
    triangle tests a fixed _MESH_TILE^2 pixel tile anchored at its screen
    bbox corner (barycentric inside test, linear screen-space z, two-sided
    Lambert face shading). Returns (pix, z, col, ok): (T*K,), (T*K,),
    (T*K, 3), (T*K,), ready to join the splat fragments."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    tv = pos[faces]  # (T, 3, 3) world verts
    tcol = torch.mean(base_colors[faces], dim=1)  # (T, 3)

    p_cam = (tv - cam_pos) @ rot.T
    z = -p_cam[..., 2]  # (T, 3)
    valid = torch.all(z > 0.01, dim=-1)
    zs = torch.clamp(z, min=1e-6)
    u = p_cam[..., 0] * fx / zs + cx  # (T, 3)
    v = -p_cam[..., 1] * fy / zs + cy

    # face normal -> two-sided Lambert (a sheet lights from either side)
    n = torch.linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0], dim=-1)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    light, light_norm = _light_dir(pos)
    lam = torch.abs(n @ (light / light_norm))
    shade = (0.35 + 0.65 * lam)[:, None] * tcol  # (T, 3)

    # tile anchored at the bbox min pixel
    u0 = torch.floor(torch.amin(u, dim=-1))  # (T,)
    v0 = torch.floor(torch.amin(v, dim=-1))
    offs = torch.arange(_MESH_TILE, dtype=torch.float32, device=pos.device)
    du, dv = torch.meshgrid(offs, offs, indexing="ij")
    du, dv = du.reshape(-1), dv.reshape(-1)  # (K,)
    px = u0[:, None] + du[None, :] + 0.5  # pixel centers, (T, K)
    py = v0[:, None] + dv[None, :] + 0.5

    def edge(ax, ay, bx, by):
        return ((bx - ax)[:, None] * (py - ay[:, None])
                - (by - ay)[:, None] * (px - ax[:, None]))

    w0 = edge(u[:, 1], v[:, 1], u[:, 2], v[:, 2])
    w1 = edge(u[:, 2], v[:, 2], u[:, 0], v[:, 0])
    w2 = edge(u[:, 0], v[:, 0], u[:, 1], v[:, 1])
    area = w0 + w1 + w2  # 2x signed area, (T, K) constant per T
    denom = torch.where(torch.abs(area) < 1e-9, 1e-9, area)
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    inside = ((b0 >= -1e-6) & (b1 >= -1e-6) & (b2 >= -1e-6)
              & (torch.abs(area) > 1e-9))
    zf = b0 * z[:, 0:1] + b1 * z[:, 1:2] + b2 * z[:, 2:3]  # (T, K)

    ipx = torch.round(px - 0.5).to(torch.int64)
    ipy = torch.round(py - 0.5).to(torch.int64)
    in_img = (ipx >= 0) & (ipx < width) & (ipy >= 0) & (ipy < height)
    ok = inside & in_img & valid[:, None] & (zf > 0.01)
    pix = torch.where(ok, ipy * width + ipx, 0)
    zfrag = torch.where(ok, zf, _FAR)
    col = shade[:, None, :].expand(pix.shape + (3,))
    return (pix.reshape(-1), zfrag.reshape(-1), col.reshape(-1, 3),
            ok.reshape(-1))


def _camera_rot(cam_fwd):
    """World -> camera rotation (rows are the camera axes) for a camera
    looking along `cam_fwd` with world y up."""
    up = _vec((0.0, 1.0, 0.0), cam_fwd)
    z_axis = -cam_fwd
    x_axis = torch.linalg.cross(up, z_axis, dim=-1)
    x_axis = x_axis / (torch.linalg.vector_norm(x_axis) + 1e-9)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    return torch.stack([x_axis, y_axis, z_axis], dim=0)


def _shape_hits(shapes: ShapeSet, cam_pos, dirs_world):
    """Nearest shape hit per ray: (t (H, W), world normal (H, W, 3)), a
    loop over the shape slots keeping a running depth minimum. The slots'
    kinds and valid flags are read to the host once a call, and each valid
    slot casts its own kind only (the JAX scan casts every kind and
    selects; an invalid slot there never wins)."""
    h, w = dirs_world.shape[:2]
    t_best = torch.full((h, w), _FAR, device=dirs_world.device)
    n_best = torch.zeros((h, w, 3), device=dirs_world.device)
    has_planes = shapes.planes.shape[-2] > 0
    for m, (kind, valid) in enumerate(zip(shapes.kind.tolist(),
                                          shapes.valid.tolist())):
        if not valid:
            continue
        size, squat = shapes.size[m], shapes.quat[m]
        q_inv = geo.quat_conjugate(squat)
        ro = geo.quat_rotate(q_inv, cam_pos - shapes.pos[m])
        rd = geo.quat_rotate(q_inv, dirs_world)
        ro = ro.expand(rd.shape)
        if kind == SHAPE_BOX:
            t, n = _ray_box(ro, rd, size)
        elif kind == SHAPE_CAPSULE:
            t, n = _ray_capsule(ro, rd, size[0], size[1])
        elif kind == SHAPE_CONVEX and has_planes:
            t, n = _ray_convex(ro, rd, shapes.planes[m])
        else:
            t, n = _ray_plane(ro, rd)
        n_world = geo.quat_rotate(squat, n)
        take = t < t_best
        t_best = torch.where(take, t, t_best)
        n_best = torch.where(take[..., None], n_world, n_best)
    return t_best, n_best


def render_frame(pos, colors, active, shapes: ShapeSet, cam_pos, cam_angle_fwd,
                 intrinsics, width: int = 720, height: int = 720,
                 splat_px: int = 2, point_radius: float = 0.04,
                 cloth_dims=None):
    """Render one camera frame on the device of `pos`.

    Args:
      pos: (N, 3) particle positions; colors: (N, 3); active: (N,) bool.
      shapes: kinematic shapes at their current pose.
      cam_pos: (3,); cam_angle_fwd: (3,) camera forward vector (unit).
      intrinsics: (4,) [fx, fy, cx, cy].
      splat_px: half-extent of the particle splat neighborhood in pixels.
      cloth_dims: optional (dimx, dimz): the particles form a cloth grid,
        rasterized as a shaded triangle mesh with the shaded particle
        splats as hole-fill.

    Returns: (H, W, 5) float32, RGB in [0, 1], alpha, metric depth (0 = bg).
    """
    full_f32_matmul()
    dev = pos.device
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    rot = _camera_rot(cam_angle_fwd)

    # ---- shape ray cast ----
    uu = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5 - cx) / fx
    vv = -(torch.arange(height, dtype=torch.float32, device=dev) + 0.5 - cy) / fy
    dirs_cam = torch.stack(
        [uu[None, :].expand(height, width), vv[:, None].expand(height, width),
         -torch.ones((height, width), device=dev)], dim=-1)
    dirs_world = dirs_cam @ rot  # rows are axes -> rot.T @ v == v @ rot
    t_hit, n_hit = _shape_hits(shapes, cam_pos, dirs_world)
    light, light_norm = _light_dir(pos)
    shade = 0.45 + 0.55 * torch.clamp(
        torch.sum(n_hit * light / light_norm, dim=-1), 0.0, 1.0)
    hit_mask = t_hit < _FAR
    # dirs_cam z = -1, so t is directly the metric depth along camera forward
    color = torch.where(hit_mask[..., None], _SHAPE_COLOR * shade[..., None],
                        _vec(_BG, pos))

    # ---- particle splat ----
    base_colors = colors
    if cloth_dims is not None:
        dimx, dimz = cloth_dims
        vn = cloth_vertex_normals(pos, dimx, dimz)
        # two-sided Lambert: a sheet lights from either side
        lam = torch.abs(vn @ (light / light_norm))
        has_n = torch.sum(vn * vn, dim=-1) > 1e-6
        colors = colors * torch.where(has_n, 0.35 + 0.65 * lam, 1.0)[:, None]
    p_cam = (pos - cam_pos) @ rot.T
    z = -p_cam[..., 2]
    vis = active & (z > 0.01)
    zc = torch.clamp(z, min=1e-6)
    u = p_cam[..., 0] * fx / zc + cx
    v = -p_cam[..., 1] * fy / zc + cy
    r_px = torch.clamp(point_radius * fx / zc, 0.5, float(splat_px) + 0.5)

    offs = torch.arange(-splat_px, splat_px + 1, dtype=torch.float32,
                        device=dev)
    du, dv = torch.meshgrid(offs, offs, indexing="ij")
    du, dv = du.reshape(-1), dv.reshape(-1)  # (S,)
    pu = torch.round(u[:, None] + du[None, :]).to(torch.int64)
    pv = torch.round(v[:, None] + dv[None, :]).to(torch.int64)
    in_disc = (du[None, :] ** 2 + dv[None, :] ** 2) <= (r_px[:, None] ** 2)
    in_img = (pu >= 0) & (pu < width) & (pv >= 0) & (pv < height)
    ok = vis[:, None] & in_disc & in_img
    pix = torch.where(ok, pv * width + pu, 0)
    zsplat = torch.where(ok, z[:, None].expand(pix.shape), _FAR)

    frag_pix = pix.reshape(-1)
    frag_z = zsplat.reshape(-1)
    frag_col = colors[:, None, :].expand(pix.shape + (3,)).reshape(-1, 3)
    frag_ok = ok.reshape(-1)
    if cloth_dims is not None and _mesh_enabled():
        # mesh fragments join the same z-buffer; splats remain as hole-fill
        faces = torch.as_tensor(_cloth_grid_faces(*cloth_dims),
                                dtype=torch.int64, device=dev)
        mpix, mz, mcol, mok = _cloth_mesh_fragments(
            pos, base_colors, faces, rot, cam_pos, intrinsics, width, height)
        frag_pix = torch.cat([frag_pix, mpix])
        frag_z = torch.cat([frag_z, mz])
        frag_col = torch.cat([frag_col, mcol])
        frag_ok = torch.cat([frag_ok, mok])

    n_pix = width * height
    zbuf = torch.where(hit_mask, t_hit, _FAR).reshape(-1).scatter_reduce(
        0, frag_pix, frag_z, "amin")
    # second pass: of the fragments within 1e-6 of the pixel's depth, the
    # last one (the JAX CPU scatter's last write) gives the colour; losers
    # are routed to a dummy slot past the image
    own = (frag_z <= zbuf[frag_pix] + 1e-6) & frag_ok
    pix_safe = torch.where(own, frag_pix, n_pix)
    winner = torch.full((n_pix + 1,), -1, dtype=torch.int64,
                        device=dev).scatter_reduce(
        0, pix_safe, torch.arange(frag_pix.shape[0], device=dev), "amax")[
        :n_pix]
    img = torch.where((winner >= 0)[:, None],
                      frag_col[torch.clamp(winner, min=0)],
                      color.reshape(-1, 3)).reshape(height, width, 3)
    depth = torch.where(zbuf < _FAR, zbuf, 0.0).reshape(height, width)
    alpha = torch.ones((height, width, 1), device=dev)
    return torch.cat([img, alpha, depth[..., None]], dim=-1)


def silhouette_pixels(depth, jump: float = 0.05):
    """(H, W) bool numpy mask of the pixels on a depth discontinuity: those
    whose 3 x 3 neighbourhood spans more than `jump` in depth (background
    reads 0). A ray there grazes a surface or meets an edge, so one ulp in
    the ray's arithmetic can change what it hits; frames from two
    arithmetics are compared outside these pixels."""
    d = np.pad(np.asarray(depth, np.float64), 1, mode="edge")
    h, w = d.shape[0] - 2, d.shape[1] - 2
    win = np.stack([d[i:i + h, j:j + w] for i in range(3) for j in range(3)])
    return (win.max(0) - win.min(0)) > jump


def render_frames_batch(pos, colors, active, shapes: ShapeSet, shape_pos,
                        shape_quat, cam_pos, cam_fwd, intrinsics,
                        width: int = 720, height: int = 720,
                        splat_px: int = 2, point_radius: float = 0.04,
                        cloth_dims=None):
    """Render F frames x C cameras: pos (F, N, 3); colors (N, 3); active
    (F, N); shapes: a shape set whose per-frame poses come from shape_pos
    (F, M, 3) / shape_quat (F, M, 4); cam_pos / cam_fwd (C, 3);
    intrinsics (4,). Returns (F, C, H, W, 5)."""
    frames = []
    for f in range(pos.shape[0]):
        sh = shapes._replace(pos=shape_pos[f], quat=shape_quat[f])
        frames.append(torch.stack([
            render_frame(pos[f], colors, active[f], sh, cam_pos[c],
                         cam_fwd[c], intrinsics, width=width, height=height,
                         splat_px=splat_px, point_radius=point_radius,
                         cloth_dims=cloth_dims)
            for c in range(cam_pos.shape[0])]))
    return torch.stack(frames)


def quantize_frames(f):
    """(color uint8 RGB, depth uint16 mm) numpy arrays of float frames
    (..., 5), quantised on their device: colour through a clip to [0, 1]
    and a truncation of x 255, depth through a truncation of x 1000 to
    int32 (torch's uint16 has little CUDA support), handed to numpy as
    uint16."""
    color = (torch.clamp(f[..., :3], 0.0, 1.0) * 255).to(torch.uint8)
    depth = (f[..., 4] * 1000).to(torch.int32)
    return color.cpu().numpy(), depth.cpu().numpy().astype(np.uint16)


def render_frames_store(pos, colors, active, shapes: ShapeSet, shape_pos,
                        shape_quat, cam_pos, cam_fwd, intrinsics,
                        width: int = 720, height: int = 720,
                        splat_px: int = 2, point_radius: float = 0.04,
                        cloth_dims=None):
    """render_frames_batch quantised on the device to the episode dtypes:
    numpy (color (F, C, H, W, 3) uint8 RGB, depth (F, C, H, W) uint16 mm)."""
    return quantize_frames(render_frames_batch(
        pos, colors, active, shapes, shape_pos, shape_quat, cam_pos, cam_fwd,
        intrinsics, width=width, height=height, splat_px=splat_px,
        point_radius=point_radius, cloth_dims=cloth_dims))
