"""Vectorized sampling helpers and pdfs.

Re-expression of ``Core/Math/SamplingHelpers.{h,cpp}`` and the pdf helpers
in ``Core/Math/Geometry.h:17-43``.  All functions map arrays of uniform [0,1)
samples to points/directions, fully branchless.
"""

from __future__ import annotations

import jax.numpy as jnp

from .vec import Vec3, cross, dot, normalize

PI = jnp.pi
INV_PI = 1.0 / jnp.pi
TWO_PI = 2.0 * jnp.pi


# --- pdfs (Geometry.h:17-43) -------------------------------------------------
def uniform_hemisphere_pdf():
    return 1.0 / (2.0 * PI)


def uniform_sphere_pdf():
    return 1.0 / (4.0 * PI)


def uniform_circle_pdf(radius):
    return 1.0 / (PI * radius * radius)


def sphere_cap_pdf(cos_theta_max):
    # guarded: cos_theta_max == 1 would give an inf primal (and a 0*inf NaN
    # cotangent through masked-out lanes, e.g. non-sphere lights)
    return 1.0 / (TWO_PI * jnp.maximum(1.0 - cos_theta_max, 1e-7))


def cos_hemisphere_pdf(cos_theta):
    return jnp.maximum(cos_theta, 0.0) * INV_PI


def pdf_area_to_solid_angle(pdf_a, distance, cos_there):
    """PdfAtoW (`PathTracerMIS.cpp:26-29`)."""
    return pdf_a * distance * distance / jnp.maximum(jnp.abs(cos_there), 1e-4)


# --- mappings ----------------------------------------------------------------
def sample_circle(u1, u2) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform point on the unit disc (`SamplingHelpers.cpp` GetCircle)."""
    theta = TWO_PI * u1
    r = jnp.sqrt(u2)
    return r * jnp.sin(theta), r * jnp.cos(theta)


def sample_hexagon(u1, u2, u3) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform point on a regular hexagon (GetHexagon)."""
    hx = jnp.array([-1.0, 0.5, 0.5, -1.0])
    hy = jnp.array([0.0, 0.8660254, -0.8660254, 0.0])
    i = jnp.clip((3.0 * u3).astype(jnp.int32), 0, 2)
    ax, ay = hx[i], hy[i]
    bx, by = hx[i + 1], hy[i + 1]
    return u1 * ax + u2 * bx, u1 * ay + u2 * by


def sample_regular_polygon(n_blades, u1, u2, u3) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform point on a regular n-gon (bokeh shapes, `Camera.h:21-50`)."""
    n = jnp.maximum(n_blades, 3).astype(jnp.float32)
    # pick a triangular sector, then sample the triangle
    sector = jnp.floor(u3 * n)
    a0 = TWO_PI * sector / n
    a1 = TWO_PI * (sector + 1.0) / n
    t = jnp.sqrt(u1)
    b0, b1 = 1.0 - t, u2 * t
    x = b0 * jnp.cos(a0) + b1 * jnp.cos(a1)
    y = b0 * jnp.sin(a0) + b1 * jnp.sin(a1)
    return x, y


def sample_square(u1, u2) -> tuple[jnp.ndarray, jnp.ndarray]:
    return 2.0 * u1 - 1.0, 2.0 * u2 - 1.0


def sample_triangle_barycentric(u1, u2) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(u, v) barycentric coords, uniform over the triangle (GetTriangle)."""
    t = jnp.sqrt(u1)
    return 1.0 - t, u2 * t


def sample_sphere(u1, u2) -> Vec3:
    """Uniform direction on the unit sphere (GetSphere)."""
    z = 2.0 * u2 - 1.0
    t = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    theta = PI * (2.0 * u1 - 1.0)
    return Vec3(t * jnp.cos(theta), t * jnp.sin(theta), z)


def sample_hemisphere(u1, u2) -> Vec3:
    """Uniform direction on the +Z hemisphere (GetHemishpere)."""
    z = u2
    t = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    theta = TWO_PI * u1
    return Vec3(t * jnp.cos(theta), t * jnp.sin(theta), z)


def sample_hemisphere_cos(u1, u2) -> Vec3:
    """Cosine-weighted direction on the +Z hemisphere (GetHemishpereCos)."""
    theta = TWO_PI * u1
    r = jnp.sqrt(u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u2))
    return Vec3(r * jnp.cos(theta), r * jnp.sin(theta), z)


def sample_gaussian2(u1, u2) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Box-Muller 2D normal (GetFloatNormal2) — used for AA jitter."""
    r = jnp.sqrt(jnp.maximum(0.0, -2.0 * jnp.log(jnp.maximum(u1, 1e-12))))
    theta = TWO_PI * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def sample_cone(cos_theta_max, u1, u2) -> Vec3:
    """Uniform direction in a +Z cone of half-angle acos(cos_theta_max).

    AD-safe at cos_theta_max == 1 (degenerate cone): sqrt'(0) = inf would turn
    a masked-out zero cotangent into NaN (0*inf), so the sqrt argument is
    double-where'd — the derivative at the apex becomes 0 instead of inf.
    """
    cos_theta = 1.0 + u1 * (cos_theta_max - 1.0)
    s2 = 1.0 - cos_theta * cos_theta
    pos = s2 > 0.0
    sin_theta = jnp.where(pos, jnp.sqrt(jnp.where(pos, s2, 1.0)), 0.0)
    phi = TWO_PI * u2
    return Vec3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)


# --- orthonormal basis ---------------------------------------------------------
def build_onb(n: Vec3) -> tuple[Vec3, Vec3]:
    """Build tangent/bitangent for normal ``n`` (BuildOrthonormalBasis).

    Branchless Duff et al. construction; safe at n.z = -1.
    """
    sign = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = Vec3(b, sign + n.y * n.y * a, -n.y)
    return t, bt


def local_to_world(v_local: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    return t * v_local.x + b * v_local.y + n * v_local.z


def spherical_quad_prepare(s: Vec3, ex: Vec3, ey: Vec3, ref: Vec3):
    """Precompute the Urena spherical-rectangle frame for sampling a quad by
    solid angle ("An Area-Preserving Parametrization for Spherical
    Rectangles", Urena, Fajardo & King 2013 — the method behind the
    reference's `Core/Math/SphericalQuad.h`).

    ``s``: quad corner, ``ex``/``ey``: full edge vectors, ``ref``: shading
    point.  Returns an opaque tuple for :func:`spherical_quad_sample` /
    its ``S`` solid-angle entry (index -1) for the MIS pdf (pdf_w = 1/S).
    All ops are AD- and masked-lane-safe (clamped acos/sqrt arguments).
    """
    exl = jnp.sqrt(jnp.maximum(dot(ex, ex), 1e-20))
    eyl = jnp.sqrt(jnp.maximum(dot(ey, ey), 1e-20))
    x = ex * (1.0 / exl)
    y = ey * (1.0 / eyl)
    z = cross(x, y)
    d = s - ref
    z0 = dot(d, z)
    flip = z0 > 0.0
    sign = jnp.where(flip, -1.0, 1.0)
    z = z * sign
    z0 = z0 * sign
    x0 = dot(d, x)
    y0 = dot(d, y)
    x1 = x0 + exl
    y1 = y0 + eyl

    def edge_normal(ax, ay, bx, by):
        # cross of (ax, ay, z0) x (bx, by, z0), normalized
        nx = ay * z0 - z0 * by
        ny = z0 * bx - ax * z0
        nz = ax * by - ay * bx
        inv = 1.0 / jnp.sqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-20))
        return nx * inv, ny * inv, nz * inv

    n0 = edge_normal(x0, y0, x1, y0)
    n1 = edge_normal(x1, y0, x1, y1)
    n2 = edge_normal(x1, y1, x0, y1)
    n3 = edge_normal(x0, y1, x0, y0)

    def acos_c(v):
        return jnp.arccos(jnp.clip(v, -1.0 + 1e-7, 1.0 - 1e-7))

    g0 = acos_c(-(n0[0] * n1[0] + n0[1] * n1[1] + n0[2] * n1[2]))
    g1 = acos_c(-(n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2]))
    g2 = acos_c(-(n2[0] * n3[0] + n2[1] * n3[1] + n2[2] * n3[2]))
    g3 = acos_c(-(n3[0] * n0[0] + n3[1] * n0[1] + n3[2] * n0[2]))
    b0 = n0[2]
    b1 = n2[2]
    k = 2.0 * jnp.pi - g2 - g3
    big_s = jnp.maximum(g0 + g1 - k, 1e-7)
    return (x, y, z, z0, x0, y0, x1, y1, b0, b1, k, big_s)


def spherical_quad_sample(quad, ref: Vec3, u, v):
    """Sample the quad uniformly by solid angle. Returns (world point,
    pdf_w = 1/S)."""
    x, y, z, z0, x0, y0, x1, y1, b0, b1, k, big_s = quad
    au = u * big_s + k
    sin_au = jnp.sin(au)
    fu = (jnp.cos(au) * b0 - b1) / jnp.where(jnp.abs(sin_au) > 1e-7, sin_au, 1e-7)
    cu = jnp.sign(fu) / jnp.sqrt(jnp.maximum(fu * fu + b0 * b0, 1e-20))
    cu = jnp.clip(cu, -1.0 + 1e-7, 1.0 - 1e-7)
    xu = -(cu * z0) / jnp.sqrt(1.0 - cu * cu)
    xu = jnp.clip(xu, x0, x1)
    d2 = xu * xu + z0 * z0
    d = jnp.sqrt(jnp.maximum(d2, 1e-20))
    h0 = y0 / jnp.sqrt(jnp.maximum(d2 + y0 * y0, 1e-20))
    h1 = y1 / jnp.sqrt(jnp.maximum(d2 + y1 * y1, 1e-20))
    hv = h0 + v * (h1 - h0)
    hv2 = hv * hv
    yv = jnp.where(
        hv2 < 1.0 - 1e-6,
        hv * d / jnp.sqrt(jnp.maximum(1.0 - hv2, 1e-12)),
        y1,
    )
    p = ref + x * xu + y * yv + z * z0
    return p, 1.0 / big_s


def world_to_local(v_world: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    return Vec3(dot(v_world, t), dot(v_world, b), dot(v_world, n))


def spherical_to_cartesian(phi, cos_theta) -> Vec3:
    # AD-safe at |cos_theta| == 1 (see sample_cone)
    s2 = 1.0 - cos_theta * cos_theta
    pos = s2 > 0.0
    sin_theta = jnp.where(pos, jnp.sqrt(jnp.where(pos, s2, 1.0)), 0.0)
    return Vec3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)


def cartesian_to_spherical_uv(d: Vec3) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Direction -> lat-long texture coords, matching
    ``CartesianToSphericalCoordinates`` (`Core/Math/Geometry.cpp`)."""
    theta = jnp.arccos(jnp.clip(d.y, -1.0, 1.0))
    phi = jnp.arctan2(d.z, d.x)
    u = phi / TWO_PI + 0.5
    v = theta * INV_PI
    return u, v
