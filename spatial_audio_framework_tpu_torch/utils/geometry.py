"""Geometry (counterpart of ``spatial_audio_framework_tpu/utils/geometry.py``):
spherical/cartesian conversion, Euler rotations and spherical Voronoi
weights in host numpy for the design stack, and the conversions and
batched rotation a per-chunk path needs as torch functions
(``*_torch``), which run on their inputs' device.

Conventions match the reference (saf_utility_geometry.c): spherical
triplets are (azimuth, elevation, radius) with elevation up from the
horizontal plane; ``euler2rotation_matrix`` composes R = R3 @ R2 @ R1 from
row-vector style Rz/Ry/Rx.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# Euler conventions (saf_utility_geometry.h:77-90)
EULER_ROTATION_Y_CONVENTION = 0     # Rz(a) Ry(b) Rz(g)
EULER_ROTATION_X_CONVENTION = 1     # Rz(a) Rx(b) Rz(g)
EULER_ROTATION_YAW_PITCH_ROLL = 2   # Rz(yaw) Ry(pitch) Rx(roll)
EULER_ROTATION_ROLL_PITCH_YAW = 3   # Rx(roll) Ry(pitch) Rz(yaw)


def sph2cart(sph, degrees: bool = False):
    """(..., 3) [azi, elev, r] → (..., 3) [x, y, z]  (saf_utility_geometry.c:272)."""
    azi, elev, r = sph[..., 0], sph[..., 1], sph[..., 2]
    if degrees:
        azi = azi * (np.pi / 180.0)
        elev = elev * (np.pi / 180.0)
    ce = np.cos(elev)
    return np.stack([r * ce * np.cos(azi), r * ce * np.sin(azi),
                     r * np.sin(elev)], axis=-1)


def cart2sph(cart, degrees: bool = False):
    """(..., 3) [x, y, z] → (..., 3) [azi, elev, r]  (saf_utility_geometry.c:304)."""
    cart = np.asarray(cart)
    x, y, z = cart[..., 0], cart[..., 1], cart[..., 2]
    hypot_xy = np.sqrt(x * x + y * y)
    r = np.sqrt(x * x + y * y + z * z)
    azi = np.arctan2(y, x)
    elev = np.arctan2(z, hypot_xy)
    if degrees:
        azi = azi * (180.0 / np.pi)
        elev = elev * (180.0 / np.pi)
    return np.stack([azi, elev, r], axis=-1)


def unit_sph2cart(dirs, degrees: bool = False):
    """(..., 2) [azi, elev] → unit vectors (..., 3)."""
    dirs = np.asarray(dirs)
    r = np.ones_like(dirs[..., :1])
    return sph2cart(np.concatenate([dirs, r], axis=-1), degrees=degrees)


def unit_cart2sph(cart, degrees: bool = False):
    """Unit vectors (..., 3) → (..., 2) [azi, elev]."""
    return cart2sph(cart, degrees=degrees)[..., :2]


def unit_sph2cart_torch(dirs_deg: torch.Tensor) -> torch.Tensor:
    """:func:`unit_sph2cart` in degrees on a tensor, in the same op order:
    (..., 2) [azi, elev] → unit vectors (..., 3) on dirs_deg's device."""
    azi = dirs_deg[..., 0] * (math.pi / 180.0)
    elev = dirs_deg[..., 1] * (math.pi / 180.0)
    ce = torch.cos(elev)
    return torch.stack([ce * torch.cos(azi), ce * torch.sin(azi),
                        torch.sin(elev)], dim=-1)


def unit_cart2sph_torch(cart: torch.Tensor) -> torch.Tensor:
    """:func:`unit_cart2sph` in degrees on a tensor: unit vectors (..., 3)
    → (..., 2) [azi, elev] on cart's device."""
    x, y, z = cart[..., 0], cart[..., 1], cart[..., 2]
    azi = torch.atan2(y, x) * (180.0 / math.pi)
    elev = torch.atan2(z, torch.sqrt(x * x + y * y)) * (180.0 / math.pi)
    return torch.stack([azi, elev], dim=-1)


def yaw_pitch_roll2_rzyx_torch(ypr: torch.Tensor,
                               roll_pitch_yaw: bool = False) -> torch.Tensor:
    """Batched :func:`yaw_pitch_roll2_rzyx` on a tensor: ypr (..., 3)
    [yaw, pitch, roll] radians → (..., 3, 3) R = Rx(roll) @ Ry(pitch) @
    Rz(yaw) of the row-vector style _rot_x/_rot_y/_rot_z, or with
    ``roll_pitch_yaw`` R = Rz(roll) @ Ry(pitch) @ Rx(yaw) (the reference's
    EULER_ROTATION_ROLL_PITCH_YAW takes the three angles in the same
    argument order), multiplied out (no matmul, so no reduced-precision
    mode applies) on ypr's device."""
    cy, cp, cr = torch.cos(ypr).unbind(-1)
    sy, sp, sr = torch.sin(ypr).unbind(-1)
    if roll_pitch_yaw:
        rows = [
            cr * cp, cr * sp * sy + sr * cy, sr * sy - cr * sp * cy,
            -sr * cp, cr * cy - sr * sp * sy, sr * sp * cy + cr * sy,
            sp, -cp * sy, cp * cy,
        ]
    else:
        rows = [
            cp * cy, cp * sy, -sp,
            sr * sp * cy - cr * sy, sr * sp * sy + cr * cy, sr * cp,
            cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp,
        ]
    return torch.stack(rows, dim=-1).unflatten(-1, (3, 3))


def _rot_x(theta):
    c, s = np.cos(theta), np.sin(theta)
    one, zero = np.ones_like(c), np.zeros_like(c)
    return np.stack([np.stack([one, zero, zero], -1),
                     np.stack([zero, c, s], -1),
                     np.stack([zero, -s, c], -1)], -2)


def _rot_y(theta):
    c, s = np.cos(theta), np.sin(theta)
    one, zero = np.ones_like(c), np.zeros_like(c)
    return np.stack([np.stack([c, zero, -s], -1),
                     np.stack([zero, one, zero], -1),
                     np.stack([s, zero, c], -1)], -2)


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    one, zero = np.ones_like(c), np.zeros_like(c)
    return np.stack([np.stack([c, s, zero], -1),
                     np.stack([-s, c, zero], -1),
                     np.stack([zero, zero, one], -1)], -2)


def euler2rotation_matrix(alpha, beta, gamma, degrees: bool = False,
                          convention: int = EULER_ROTATION_YAW_PITCH_ROLL):
    """R = R3(gamma) @ R2(beta) @ R1(alpha)  (saf_utility_geometry.c:213-255).
    Scalars or batched angle arrays; returns (..., 3, 3)."""
    alpha, beta, gamma = np.asarray(alpha), np.asarray(beta), np.asarray(gamma)
    if degrees:
        d = np.pi / 180.0
        alpha, beta, gamma = alpha * d, beta * d, gamma * d
    if convention == EULER_ROTATION_Y_CONVENTION:
        R1, R2, R3 = _rot_z(alpha), _rot_y(beta), _rot_z(gamma)
    elif convention == EULER_ROTATION_X_CONVENTION:
        R1, R2, R3 = _rot_z(alpha), _rot_x(beta), _rot_z(gamma)
    elif convention == EULER_ROTATION_YAW_PITCH_ROLL:
        R1, R2, R3 = _rot_z(alpha), _rot_y(beta), _rot_x(gamma)
    elif convention == EULER_ROTATION_ROLL_PITCH_YAW:
        R1, R2, R3 = _rot_x(alpha), _rot_y(beta), _rot_z(gamma)
    else:
        raise ValueError(convention)
    return R3 @ R2 @ R1


def yaw_pitch_roll2_rzyx(yaw, pitch, roll, roll_pitch_yaw: bool = False):
    """saf_utility_geometry.c:257-270 (radians)."""
    conv = (EULER_ROTATION_ROLL_PITCH_YAW if roll_pitch_yaw
            else EULER_ROTATION_YAW_PITCH_ROLL)
    return euler2rotation_matrix(yaw, pitch, roll, degrees=False,
                                 convention=conv)


def sph_delaunay(dirs_deg):
    """Delaunay triangulation of points on the sphere == their convex hull
    (saf_utility_geometry.c ``sphDelaunay``).  dirs_deg: (nDirs, 2) [azi, elev]
    → (faces (nF, 3) int, vertices (nDirs, 3))."""
    from scipy.spatial import ConvexHull

    verts = unit_sph2cart(np.asarray(dirs_deg, np.float64), degrees=True)
    hull = ConvexHull(verts)
    return hull.simplices.astype(int), verts


def sph_voronoi(faces, vertices):
    """Spherical Voronoi diagram from a spherical Delaunay triangulation
    (saf_utility_geometry.c:693-868 ``sphVoronoi``): each triangle's
    circumcentre on the unit sphere — its outward unit normal — is a
    Voronoi vertex; each input direction's cell is the ring of its incident
    triangles' vertices, ordered by angle in the direction's tangent plane.

    faces: (nF, 3) int; vertices: (nDirs, 3) unit →
    (vor_verts (nF, 3), cells: list of nDirs index lists into vor_verts)."""
    faces = np.asarray(faces, int)
    verts = np.asarray(vertices, np.float64)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    normal = np.cross(v1 - v0, v2 - v0)
    vor = normal / np.linalg.norm(normal, axis=-1, keepdims=True)
    # orient outward, judged against an interior point of the hull (its
    # vertex centroid): scipy's simplices have arbitrary winding
    centroid = verts.mean(axis=0)
    flip = (vor * (v0 - centroid)).sum(-1) < 0.0
    vor[flip] = -vor[flip]
    # global duplicate canonicalisation (C:731-746): an unclaimed vertex n
    # claims every m within 1e-5 componentwise; index 0 doubles as "not a
    # duplicate" in the C, so vertices claimed by vertex 0 are not remapped
    n_vert = vor.shape[0]
    dup = np.zeros(n_vert, int)
    for n in range(n_vert):
        if dup[n] == 0:
            close = (np.abs(vor - vor[n]) < 1e-5).all(axis=1)
            close[n] = False
            dup[close] = n
    cells = []
    for m in range(verts.shape[0]):
        inc = np.nonzero((faces == m).any(axis=1))[0]
        d = verts[m]
        a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 \
            else np.array([0.0, 1.0, 0.0])
        t1 = np.cross(d, a)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(d, t1)
        ang = np.arctan2(vor[inc] @ t2, vor[inc] @ t1)
        ring = inc[np.argsort(ang)]
        # remap to canonical vertices, keep first occurrences in ring order
        # (C:842-858)
        keep, seen = [], set()
        for i in ring:
            i = int(dup[i]) if dup[i] != 0 else int(i)
            if i not in seen:
                seen.add(i)
                keep.append(i)
        cells.append(keep)
    return vor, cells


def sph_voronoi_areas(vor_verts, cells):
    """Areas of spherical Voronoi polygons via the spherical excess
    Σ interior angles − (N−2)π (saf_utility_geometry.c:870-945
    ``sphVoronoiAreas``).  → (nDirs,) float32, summing to 4π."""
    vor = np.asarray(vor_verts, np.float64)
    areas = np.empty(len(cells), np.float32)
    for m, cell in enumerate(cells):
        N = len(cell)
        if N < 3:
            areas[m] = 0.0
            continue
        theta = 0.0
        for n in range(N):
            p0 = vor[cell[n - 1]]
            p1 = vor[cell[n]]
            p2 = vor[cell[(n + 1) % N]]
            # tangents at p1 toward p0 and p2 along the great circles
            t10 = np.cross(np.cross(p1, p0), p1)
            t12 = np.cross(np.cross(p1, p2), p1)
            t10 /= np.linalg.norm(t10)
            t12 /= np.linalg.norm(t12)
            theta += np.arccos(np.clip(t10 @ t12, -1.0, 1.0))
        areas[m] = theta - (N - 2) * np.pi
    return areas


def get_voronoi_weights(dirs_deg):
    """Spherical Voronoi cell areas per direction, summing to 4π
    (saf_utility_geometry.c:930-990 ``getVoronoiWeights``):
    sphDelaunay → sphVoronoi → sphVoronoiAreas.  → (nDirs,)."""
    faces, verts = sph_delaunay(dirs_deg)
    vor, cells = sph_voronoi(faces, verts)
    return sph_voronoi_areas(vor, cells)


# -- quaternions, cross products, norms: numpy or torch, whichever comes in
#    (the JAX package's functions take numpy or jax arrays the same way) ----

def _is_torch(*arrays) -> bool:
    return any(isinstance(a, torch.Tensor) for a in arrays)


def quaternion2rotation_matrix(q):
    """q: (..., 4) [w, x, y, z] → (..., 3, 3)  (saf_utility_geometry.c:89-104)."""
    xp = torch if _is_torch(q) else np
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return xp.stack([
        xp.stack([2 * (w * w + z * z) - 1, 2 * (z * y - w * x), 2 * (z * x + w * y)], -1),
        xp.stack([2 * (z * y + w * x), 2 * (w * w + y * y) - 1, 2 * (y * x - w * z)], -1),
        xp.stack([2 * (z * x - w * y), 2 * (y * x + w * z), 2 * (w * w + x * x) - 1], -1),
    ], -2)


def rotation_matrix2quaternion(R):
    """(..., 3, 3) → (..., 4) [w,x,y,z]  (saf_utility_geometry.c:107-121)."""
    xp = torch if _is_torch(R) else np

    def root(v):
        return xp.sqrt(v.clamp(min=0.0) if xp is torch
                       else np.maximum(0.0, v)) / 2

    w = root(1 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])
    z = root(1 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2])
    y = root(1 - R[..., 0, 0] + R[..., 1, 1] - R[..., 2, 2])
    x = root(1 - R[..., 0, 0] - R[..., 1, 1] + R[..., 2, 2])
    z = xp.where(R[..., 2, 1] - R[..., 1, 2] < 0, -z, z)
    y = xp.where(R[..., 0, 2] - R[..., 2, 0] < 0, -y, y)
    x = xp.where(R[..., 1, 0] - R[..., 0, 1] < 0, -x, x)
    return xp.stack([w, x, y, z], -1)


def euler2quaternion(alpha, beta, gamma, degrees: bool = False,
                     convention: int = EULER_ROTATION_YAW_PITCH_ROLL):
    """Euler angles → quaternion (..., 4) [w, x, y, z]
    (saf_utility_geometry.c:123-161 ``euler2Quaternion``)."""
    xp = torch if _is_torch(alpha, beta, gamma) else np
    if convention == EULER_ROTATION_YAW_PITCH_ROLL:
        a_y, a_p, a_r = alpha, beta, gamma
    elif convention == EULER_ROTATION_ROLL_PITCH_YAW:
        a_y, a_p, a_r = gamma, beta, alpha
    else:
        raise ValueError(f"convention {convention!r} not supported "
                         "(saf: saf_print_error)")
    if degrees:
        rad = torch.deg2rad if xp is torch else np.radians
        a_y, a_p, a_r = rad(a_y), rad(a_p), rad(a_r)
    cy, sy = xp.cos(a_y * 0.5), xp.sin(a_y * 0.5)
    cp, sp = xp.cos(a_p * 0.5), xp.sin(a_p * 0.5)
    cr, sr = xp.cos(a_r * 0.5), xp.sin(a_r * 0.5)
    return xp.stack([cy * cr * cp + sy * sr * sp,
                     cy * sr * cp - sy * cr * sp,
                     cy * cr * sp + sy * sr * cp,
                     sy * cr * cp - cy * sr * sp], -1)


def quaternion2euler(q, degrees: bool = False,
                     convention: int = EULER_ROTATION_YAW_PITCH_ROLL):
    """Quaternion (..., 4) [w, x, y, z] → (alpha, beta, gamma)
    (saf_utility_geometry.c:163-213 ``quaternion2euler``)."""
    xp = torch if _is_torch(q) else np
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    sinp = 2.0 * (w * y - z * x)
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    beta = xp.where(xp.abs(sinp) >= 1.0,
                    xp.sign(sinp) * (np.pi / 2.0),
                    xp.arcsin(xp.clip(sinp, -1.0, 1.0)))
    if convention == EULER_ROTATION_YAW_PITCH_ROLL:
        gamma = xp.arctan2(sinr_cosp, cosr_cosp)
        alpha = xp.arctan2(siny_cosp, cosy_cosp)
    elif convention == EULER_ROTATION_ROLL_PITCH_YAW:
        alpha = xp.arctan2(sinr_cosp, cosr_cosp)
        gamma = xp.arctan2(siny_cosp, cosy_cosp)
    else:
        raise ValueError(f"convention {convention!r} not supported "
                         "(saf: saf_print_error)")
    if degrees:
        deg = torch.rad2deg if xp is torch else np.degrees
        alpha, beta, gamma = deg(alpha), deg(beta), deg(gamma)
    return alpha, beta, gamma


def crossProduct3(a, b):
    if _is_torch(a, b):
        return torch.linalg.cross(a, b)
    return np.cross(a, b)


def L2_norm(v):
    return ((v * v).sum(-1)) ** 0.5 if _is_torch(v) else np.sqrt(
        (v * v).sum(-1))


def rodrigues(axis, theta):
    """Rotation about a unit axis by theta (general helper)."""
    if _is_torch(axis):
        axis = axis.to(torch.float64) if not axis.is_floating_point() \
            else axis
        zero = torch.zeros_like(axis[..., 0])
        K = torch.stack([
            torch.stack([zero, -axis[..., 2], axis[..., 1]], -1),
            torch.stack([axis[..., 2], zero, -axis[..., 0]], -1),
            torch.stack([-axis[..., 1], axis[..., 0], zero], -1)], -2)
        theta = torch.as_tensor(theta, dtype=K.dtype, device=K.device)
        eye = torch.eye(3, dtype=K.dtype, device=K.device)
        return eye + torch.sin(theta) * K + (1 - torch.cos(theta)) * (K @ K)
    axis = np.asarray(axis, dtype=float)
    zero = np.zeros_like(axis[..., 0])
    K = np.stack([
        np.stack([zero, -axis[..., 2], axis[..., 1]], -1),
        np.stack([axis[..., 2], zero, -axis[..., 0]], -1),
        np.stack([-axis[..., 1], axis[..., 0], zero], -1)], -2)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def convhull_nd(points):
    """N-dimensional convex hull (saf_utility_geometry.h ``convhullnd`` via
    convhull_3d/qhull) → simplex vertex indices (nFaces, d), on the host."""
    from scipy.spatial import ConvexHull

    return ConvexHull(np.asarray(points, np.float64)).simplices


def delaunay_nd(points):
    """N-dimensional Delaunay triangulation (``delaunaynd``) → (nSimplices,
    d+1) vertex indices, on the host."""
    from scipy.spatial import Delaunay

    return Delaunay(np.asarray(points, np.float64)).simplices
