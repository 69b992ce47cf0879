// SPH particle <-> Cartesian grid mapping kernels (native host-side path).
//
// Native equivalent of the reference's SPHArrayInterface mapping machinery
// (/root/reference/src/SPHArrayInterface.cpp — M-over-V, centroid and
// kernel-weighted mappings over an Octree neighbor search): the gridding of
// large particle sets is host-side, branchy, scatter-heavy work that neither
// XLA nor numpy's add.at handle well, so it lives in C++ like the
// reference's does.  Exposed through ctypes (see native/__init__.py);
// cmacionize_tpu.api falls back to a numpy implementation when the shared
// library has not been built.
//
// All functions use SI units and C-contiguous double arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

// Nearest-cell mass deposition: grid[cell] += m; density = mass / V_cell.
void deposit_m_over_v(const double *positions, const double *masses,
                      int64_t n_part, const double *anchor,
                      const double *sides, const int64_t *dims,
                      double *grid /* [nx*ny*nz], pre-zeroed */) {
  const double inv_dx = dims[0] / sides[0];
  const double inv_dy = dims[1] / sides[1];
  const double inv_dz = dims[2] / sides[2];
  const double cell_volume =
      (sides[0] / dims[0]) * (sides[1] / dims[1]) * (sides[2] / dims[2]);
  const double inv_cell_volume = 1.0 / cell_volume;
  for (int64_t i = 0; i < n_part; ++i) {
    int64_t ix = (int64_t)((positions[3 * i] - anchor[0]) * inv_dx);
    int64_t iy = (int64_t)((positions[3 * i + 1] - anchor[1]) * inv_dy);
    int64_t iz = (int64_t)((positions[3 * i + 2] - anchor[2]) * inv_dz);
    ix = std::max<int64_t>(0, std::min(ix, dims[0] - 1));
    iy = std::max<int64_t>(0, std::min(iy, dims[1] - 1));
    iz = std::max<int64_t>(0, std::min(iz, dims[2] - 1));
    grid[(ix * dims[1] + iy) * dims[2] + iz] += masses[i] * inv_cell_volume;
  }
}

// Cubic-spline (M4) kernel value for q = r/h, normalized in 3D.
static inline double cubic_spline(double q, double h) {
  const double sigma = 1.0 / (M_PI * h * h * h);
  if (q < 1.0) {
    return sigma * (1.0 - 1.5 * q * q * (1.0 - 0.5 * q));
  } else if (q < 2.0) {
    const double two_minus_q = 2.0 - q;
    return sigma * 0.25 * two_minus_q * two_minus_q * two_minus_q;
  }
  return 0.0;
}

// Kernel-weighted density deposition: for each particle, distribute its mass
// over the cells within 2h using the cubic-spline kernel (the "centroid"-
// style mapping of the reference, evaluated at cell centers, normalized per
// particle so total mass is conserved exactly).
void deposit_sph_kernel(const double *positions, const double *masses,
                        const double *smoothing_lengths, int64_t n_part,
                        const double *anchor, const double *sides,
                        const int64_t *dims,
                        double *grid /* pre-zeroed */) {
  const double dx = sides[0] / dims[0];
  const double dy = sides[1] / dims[1];
  const double dz = sides[2] / dims[2];
  const double cell_volume = dx * dy * dz;
  for (int64_t i = 0; i < n_part; ++i) {
    const double px = positions[3 * i];
    const double py = positions[3 * i + 1];
    const double pz = positions[3 * i + 2];
    const double h = smoothing_lengths[i];
    const double support = 2.0 * h;
    int64_t ix0 = (int64_t)std::floor((px - support - anchor[0]) / dx);
    int64_t ix1 = (int64_t)std::floor((px + support - anchor[0]) / dx);
    int64_t iy0 = (int64_t)std::floor((py - support - anchor[1]) / dy);
    int64_t iy1 = (int64_t)std::floor((py + support - anchor[1]) / dy);
    int64_t iz0 = (int64_t)std::floor((pz - support - anchor[2]) / dz);
    int64_t iz1 = (int64_t)std::floor((pz + support - anchor[2]) / dz);
    ix0 = std::max<int64_t>(ix0, 0);
    iy0 = std::max<int64_t>(iy0, 0);
    iz0 = std::max<int64_t>(iz0, 0);
    ix1 = std::min(ix1, dims[0] - 1);
    iy1 = std::min(iy1, dims[1] - 1);
    iz1 = std::min(iz1, dims[2] - 1);
    // first pass: kernel weights + normalization
    double wsum = 0.0;
    for (int64_t ix = ix0; ix <= ix1; ++ix) {
      const double cx = anchor[0] + (ix + 0.5) * dx - px;
      for (int64_t iy = iy0; iy <= iy1; ++iy) {
        const double cy = anchor[1] + (iy + 0.5) * dy - py;
        for (int64_t iz = iz0; iz <= iz1; ++iz) {
          const double cz = anchor[2] + (iz + 0.5) * dz - pz;
          const double r = std::sqrt(cx * cx + cy * cy + cz * cz);
          wsum += cubic_spline(r / h, h);
        }
      }
    }
    if (wsum <= 0.0) {
      // support smaller than a cell: nearest-cell fallback
      int64_t ix = (int64_t)((px - anchor[0]) / dx);
      int64_t iy = (int64_t)((py - anchor[1]) / dy);
      int64_t iz = (int64_t)((pz - anchor[2]) / dz);
      ix = std::max<int64_t>(0, std::min(ix, dims[0] - 1));
      iy = std::max<int64_t>(0, std::min(iy, dims[1] - 1));
      iz = std::max<int64_t>(0, std::min(iz, dims[2] - 1));
      grid[(ix * dims[1] + iy) * dims[2] + iz] += masses[i] / cell_volume;
      continue;
    }
    const double m_over_wsum_v = masses[i] / (wsum * cell_volume);
    for (int64_t ix = ix0; ix <= ix1; ++ix) {
      const double cx = anchor[0] + (ix + 0.5) * dx - px;
      for (int64_t iy = iy0; iy <= iy1; ++iy) {
        const double cy = anchor[1] + (iy + 0.5) * dy - py;
        for (int64_t iz = iz0; iz <= iz1; ++iz) {
          const double cz = anchor[2] + (iz + 0.5) * dz - pz;
          const double r = std::sqrt(cx * cx + cy * cy + cz * cz);
          const double w = cubic_spline(r / h, h);
          if (w > 0.0) {
            grid[(ix * dims[1] + iy) * dims[2] + iz] += w * m_over_wsum_v;
          }
        }
      }
    }
  }
}

// Inverse mapping: nearest-cell sampling of a grid field at positions.
void sample_grid(const double *grid, const int64_t *dims,
                 const double *anchor, const double *sides,
                 const double *positions, int64_t n_part, double *out) {
  const double inv_dx = dims[0] / sides[0];
  const double inv_dy = dims[1] / sides[1];
  const double inv_dz = dims[2] / sides[2];
  for (int64_t i = 0; i < n_part; ++i) {
    int64_t ix = (int64_t)((positions[3 * i] - anchor[0]) * inv_dx);
    int64_t iy = (int64_t)((positions[3 * i + 1] - anchor[1]) * inv_dy);
    int64_t iz = (int64_t)((positions[3 * i + 2] - anchor[2]) * inv_dz);
    ix = std::max<int64_t>(0, std::min(ix, dims[0] - 1));
    iy = std::max<int64_t>(0, std::min(iy, dims[1] - 1));
    iz = std::max<int64_t>(0, std::min(iz, dims[2] - 1));
    out[i] = grid[(ix * dims[1] + iy) * dims[2] + iz];
  }
}


}  // extern "C"

// ---------------------------------------------------------------------------
// Petkova, Laibe & Bonnell (2018) exact kernel-overlap mapping
// ---------------------------------------------------------------------------
//
// Native equivalent of the reference's SPHARRAY_MAPPING_PETKOVA path
// (/root/reference/src/SPHArrayInterface.cpp:533-930): the mass fraction of
// a cubic-spline kernel (support 2h) inside an axis-aligned cell is the sum
// over the 6 faces of signed wall integrals, each decomposed into per-edge
// right-triangle vertex integrals with the published closed-form
// antiderivatives.  The implementation below re-derives the face/edge sign
// bookkeeping for axis-aligned boxes (orientation triple products against
// the outward face normal) and shares one I_n evaluation helper; the
// analytic formulas themselves are the published ones.

namespace petkova {

struct InSet {
  double i0, i1, im2, im3, im4, im5;
};

// Angular moment integrals I_n(phi) for the right triangle with half-angle
// phi (cos phi given) and aspect a = R0/r0 (Petkova et al. 2018, App. A).
static InSet angular_moments(double phi, double cosphi, double a) {
  InSet s;
  const double a2 = a * a;
  const double sinphi = std::sqrt(std::max(0.0, (1.0 - cosphi) * (1.0 + cosphi)));
  const double cosp2 = cosphi * cosphi;
  const double mu = cosphi / std::sqrt(a2 + cosp2);
  const double tanp = sinphi / cosphi;
  s.i0 = phi;
  s.im2 = phi + a2 * tanp;
  s.im4 = phi + 2.0 * a2 * tanp +
          (1.0 / 3.0) * a2 * a2 * tanp * (2.0 + 1.0 / cosp2);
  const double u = sinphi * std::sqrt(std::max(0.0, (1.0 - mu) * (1.0 + mu)));
  const double u2 = u * u;
  const double logs = std::log((1.0 + u) / (1.0 - u));
  s.i1 = std::atan2(u, a);
  const double im1 = 0.5 * a * logs + s.i1;
  s.im3 = im1 + 0.25 * a * (1.0 + a2) * (2.0 * u / (1.0 - u2) + logs);
  s.im5 = s.im3 + a * (1.0 + a2) * (1.0 + a2) / 16.0 *
                      ((10.0 * u - 6.0 * u * u2) / ((1.0 - u2) * (1.0 - u2)) +
                       3.0 * logs);
  return s;
}

// Column integral of the (unit-mass, support-2h) cubic spline over the
// infinite pyramid from the particle through a right triangle on a plane at
// distance r0, with foot distance R0 and opening angle phi.
static double vertex_integral(double phi, double cosphi, double r0, double R0,
                              double h) {
  if (r0 <= 0.0 || R0 <= 0.0 || phi <= 0.0) {
    return 0.0;
  }
  const double h2 = h * h;
  const double r02 = r0 * r0;
  const double r03 = r02 * r0;
  const double q = r0 / h;           // r0 in kernel units
  const double q2 = q * q, q3 = q2 * q;
  const double qi2 = 1.0 / q2, qi3 = qi2 / q;

  // Integration constants matching the kernel's three radial branches.
  double b1 = 0.0, b2 = 0.0, b3 = 0.0;
  if (r0 >= 2.0 * h) {
    b3 = 0.25 * h2 * h;
  } else if (r0 > h) {
    b3 = 0.25 * r03 * (-4.0 / 3.0 + q - 0.3 * q2 + q3 / 30.0 - qi3 / 15.0 +
                       1.6 * qi2);
    b2 = 0.25 * r03 * (-4.0 / 3.0 + q - 0.3 * q2 + q3 / 30.0 - qi3 / 15.0);
  } else {
    b3 = 0.25 * r03 * (-2.0 / 3.0 + 0.3 * q2 - 0.1 * q3 + 1.4 * qi2);
    b2 = 0.25 * r03 * (-2.0 / 3.0 + 0.3 * q2 - 0.1 * q3 - 0.2 * qi2);
    b1 = 0.25 * r03 * (-2.0 / 3.0 + 0.3 * q2 - 0.1 * q3);
  }

  const double a = R0 / r0;
  const double linedist2 = r02 + R0 * R0;
  double d2 = 0.0, d3 = 0.0;
  if (linedist2 <= h2) {
    // the h-sphere intersects the foot line: phi_1 correction
    const double cp1 = R0 / std::sqrt(h2 - r02);
    const InSet s1 = angular_moments(std::acos(cp1), cp1, a);
    d2 = -s1.im2 / 6.0 + 0.25 * q * s1.im3 - 0.15 * q2 * s1.im4 +
         q3 / 30.0 * s1.im5 - qi3 / 60.0 * s1.i1 + (b1 - b2) / r03 * s1.i0;
  }
  if (linedist2 <= 4.0 * h2) {
    // the 2h-sphere intersects the foot line: phi_2 correction
    const double cp2 = R0 / std::sqrt(4.0 * h2 - r02);
    const InSet s2 = angular_moments(std::acos(cp2), cp2, a);
    d3 = s2.im2 / 3.0 - 0.25 * q * s2.im3 + 0.075 * q2 * s2.im4 -
         q3 / 120.0 * s2.im5 + 4.0 / 15.0 * qi3 * s2.i1 +
         (b2 - b3) / r03 * s2.i0 + d2;
  }

  const InSet s = angular_moments(phi, cosphi, a);
  const double rr = R0 / cosphi;  // distance from foot axis to far vertex
  const double r2 = r02 + rr * rr;
  double val;
  if (r2 < h2) {
    val = s.im2 / 6.0 - 0.075 * q2 * s.im4 + 0.025 * q3 * s.im5 +
          b1 / r03 * s.i0;
  } else if (r2 < 4.0 * h2) {
    val = 0.25 * (4.0 / 3.0 * s.im2 - q * s.im3 + 0.3 * q2 * s.im4 -
                  q3 / 30.0 * s.im5 + qi3 / 15.0 * s.i1) +
          b2 / r03 * s.i0 + d2;
  } else {
    val = -0.25 * qi3 * s.i1 + b3 / r03 * s.i0 + d3;
  }
  return q3 * val / M_PI;
}

// Wall integral for one rectangular face with outward normal axis `ax`,
// plane coordinate `w`, spanning [lo_u,hi_u]x[lo_v,hi_v] on the other two
// axes (u = (ax+1)%3, v = (ax+2)%3), vertices ordered counterclockwise as
// seen from outside.  Returns the SIGNED contribution to the cell mass.
static double wall_integral(const double *p, double h, int ax, double w,
                            double lo_u, double hi_u, double lo_v,
                            double hi_v, double sgn_n) {
  const int axu = (ax + 1) % 3, axv = (ax + 2) % 3;
  const double r0s = (w - p[ax]) * sgn_n;  // signed distance along outward n
  const double ar0 = std::fabs(r0s);
  if (ar0 < 1e-300) {
    return 0.0;  // particle in the face plane: zero solid angle
  }
  // projected particle in face (u, v) coordinates; the per-edge sign
  // decomposition is purely two-dimensional in the face plane, so one
  // counterclockwise-in-(u,v) ordering serves both normal directions
  const double pu = p[axu], pv = p[axv];
  const double vu[4] = {lo_u, hi_u, hi_u, lo_u};
  const double vv[4] = {lo_v, lo_v, hi_v, hi_v};
  double wall = 0.0;
  for (int e = 0; e < 4; ++e) {
    const double au = vu[e] - pu, av = vv[e] - pv;
    const double bu = vu[(e + 1) % 4] - pu, bv = vv[(e + 1) % 4] - pv;
    const double eu = bu - au, ev = bv - av;
    const double elen2 = eu * eu + ev * ev;
    if (elen2 < 1e-300) {
      continue;
    }
    const double elen = std::sqrt(elen2);
    // foot of perpendicular from p' to the edge line, as edge parameter
    const double t = -(au * eu + av * ev) / elen2;
    const double R0 = std::fabs(au * (ev / elen) - av * (eu / elen));
    const double ra = std::sqrt(au * au + av * av);
    const double rb = std::sqrt(bu * bu + bv * bv);
    if (R0 < 1e-14 * h) {
      continue;  // p' on the edge line: degenerate triangle
    }
    const double cpa = std::min(1.0, R0 / std::max(ra, R0));
    const double cpb = std::min(1.0, R0 / std::max(rb, R0));
    const double phia = std::acos(cpa);
    const double phib = std::acos(cpb);
    // orientation: positive when (a x b) points along +normal in (u,v)
    const double orient = au * bv - av * bu;
    const double edge_sign = (orient > 0.0) ? 1.0 : -1.0;
    double tri;
    if (t >= 0.0 && t <= 1.0) {
      // foot inside the segment: two right triangles add
      tri = vertex_integral(phia, cpa, ar0, R0, h) +
            vertex_integral(phib, cpb, ar0, R0, h);
    } else {
      // foot outside: difference of enclosing and excess triangles
      tri = std::fabs(vertex_integral(phia, cpa, ar0, R0, h) -
                      vertex_integral(phib, cpb, ar0, R0, h));
    }
    wall += edge_sign * tri;
  }
  return (r0s > 0.0 ? 1.0 : -1.0) * wall;
}

// Mass fraction of a unit cubic-spline kernel (support 2h) at `p` inside
// the axis-aligned box [lo, hi].
static double box_fraction(const double *p, double h, const double *lo,
                           const double *hi) {
  double m = 0.0;
  for (int ax = 0; ax < 3; ++ax) {
    const int axu = (ax + 1) % 3, axv = (ax + 2) % 3;
    m += wall_integral(p, h, ax, hi[ax], lo[axu], hi[axu], lo[axv], hi[axv],
                       1.0);
    m += wall_integral(p, h, ax, lo[ax], lo[axu], hi[axu], lo[axv], hi[axv],
                       -1.0);
  }
  return std::max(m, 0.0);
}

}  // namespace petkova

extern "C" {

// Exact mass fraction of one kernel inside one box (exposed for testing).
double petkova_box_fraction(const double *position, double h,
                            const double *lo, const double *hi) {
  return petkova::box_fraction(position, h, lo, hi);
}

// Petkova mass-conserving deposit onto the Cartesian grid.  `h` is the
// cubic-spline smoothing length (support 2h), matching the h/2 convention
// the reference applies to SPH smoothing lengths
// (SPHArrayInterface.cpp:985).  With normalize != 0, each particle's
// in-box contributions are rescaled to deposit its full mass (exact global
// mass conservation even at the box edge).
void petkova_deposit(const double *positions, const double *masses,
                     const double *smoothing_lengths, int64_t n_part,
                     const double *anchor, const double *sides,
                     const int64_t *dims, int normalize,
                     double *grid /* pre-zeroed, adds DENSITY */) {
  const double dx = sides[0] / dims[0];
  const double dy = sides[1] / dims[1];
  const double dz = sides[2] / dims[2];
  const double cell_volume = dx * dy * dz;
  for (int64_t i = 0; i < n_part; ++i) {
    const double *p = positions + 3 * i;
    const double h = smoothing_lengths[i];
    const double sup = 2.0 * h;
    int64_t c0[3], c1[3];
    const double dxyz[3] = {dx, dy, dz};
    for (int ax = 0; ax < 3; ++ax) {
      c0[ax] = (int64_t)std::floor((p[ax] - sup - anchor[ax]) / dxyz[ax]);
      c1[ax] = (int64_t)std::floor((p[ax] + sup - anchor[ax]) / dxyz[ax]);
      c0[ax] = std::max<int64_t>(0, std::min(c0[ax], dims[ax] - 1));
      c1[ax] = std::max<int64_t>(0, std::min(c1[ax], dims[ax] - 1));
    }
    double total = 0.0;
    for (int pass = 0; pass < 2; ++pass) {
      const double scale =
          (pass == 0) ? 0.0
                      : masses[i] / ((normalize && total > 0.0) ? total : 1.0);
      for (int64_t ix = c0[0]; ix <= c1[0]; ++ix) {
        for (int64_t iy = c0[1]; iy <= c1[1]; ++iy) {
          for (int64_t iz = c0[2]; iz <= c1[2]; ++iz) {
            const double lo[3] = {anchor[0] + ix * dx, anchor[1] + iy * dy,
                                  anchor[2] + iz * dz};
            const double hi[3] = {lo[0] + dx, lo[1] + dy, lo[2] + dz};
            const double frac = petkova::box_fraction(p, h, lo, hi);
            if (pass == 0) {
              total += frac;
            } else if (frac > 0.0) {
              grid[(ix * dims[1] + iy) * dims[2] + iz] +=
                  scale * frac / cell_volume;
            }
          }
        }
      }
      if (pass == 0 && !normalize) {
        // reference behaviour: deposit raw fractions (edge mass truncated)
        continue;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Octree point locator
// ---------------------------------------------------------------------------
//
// Native equivalent of Octree.hpp / PointLocations.hpp (neighbor searches
// behind the SPH interface): a pool-allocated octree over particle
// positions with sphere and k-nearest queries.

namespace octree {

struct Node {
  double cx, cy, cz, half;
  int32_t children[8];  // -1 = none
  std::vector<int32_t> points;  // leaf payload
  bool leaf;
};

struct Tree {
  std::vector<Node> nodes;
  std::vector<double> pos;  // copy, [n*3]
  int64_t n;
  static const size_t LEAF_SIZE = 16;

  int32_t new_node(double cx, double cy, double cz, double half) {
    Node nd;
    nd.cx = cx; nd.cy = cy; nd.cz = cz; nd.half = half;
    for (int k = 0; k < 8; ++k) nd.children[k] = -1;
    nd.leaf = true;
    nodes.push_back(nd);
    return (int32_t)nodes.size() - 1;
  }

  void insert(int32_t ni, int32_t pi, int depth) {
    Node &nd = nodes[ni];
    if (nd.leaf) {
      nd.points.push_back(pi);
      if (nd.points.size() > LEAF_SIZE && depth < 32) {
        std::vector<int32_t> pts;
        pts.swap(nodes[ni].points);
        nodes[ni].leaf = false;
        for (int32_t q : pts) {
          insert_child(ni, q, depth);
        }
      }
      return;
    }
    insert_child(ni, pi, depth);
  }

  void insert_child(int32_t ni, int32_t pi, int depth) {
    const double x = pos[3 * pi], y = pos[3 * pi + 1], z = pos[3 * pi + 2];
    Node &nd = nodes[ni];
    const int oct = (x >= nd.cx ? 1 : 0) | (y >= nd.cy ? 2 : 0) |
                    (z >= nd.cz ? 4 : 0);
    if (nd.children[oct] < 0) {
      const double h2 = nd.half * 0.5;
      const double cx = nd.cx + (oct & 1 ? h2 : -h2);
      const double cy = nd.cy + (oct & 2 ? h2 : -h2);
      const double cz = nd.cz + (oct & 4 ? h2 : -h2);
      const int32_t ci = new_node(cx, cy, cz, h2);
      nodes[ni].children[oct] = ci;  // nd may be dangling after push_back
    }
    insert(nodes[ni].children[oct], pi, depth + 1);
  }
};

static double sq(double v) { return v * v; }

// squared distance from a point to a node's cube
static double node_dist2(const Node &nd, double x, double y, double z) {
  double d2 = 0.0;
  d2 += sq(std::max(0.0, std::fabs(x - nd.cx) - nd.half));
  d2 += sq(std::max(0.0, std::fabs(y - nd.cy) - nd.half));
  d2 += sq(std::max(0.0, std::fabs(z - nd.cz) - nd.half));
  return d2;
}

static void radius_query(const Tree *t, int32_t ni, double x, double y,
                         double z, double r2, int64_t *out, int64_t cap,
                         int64_t *count) {
  const Node &nd = t->nodes[ni];
  if (node_dist2(nd, x, y, z) > r2) {
    return;
  }
  if (nd.leaf) {
    for (int32_t pi : nd.points) {
      const double d2 = sq(t->pos[3 * pi] - x) + sq(t->pos[3 * pi + 1] - y) +
                        sq(t->pos[3 * pi + 2] - z);
      if (d2 <= r2) {
        if (*count < cap) {
          out[*count] = pi;
        }
        ++(*count);
      }
    }
    return;
  }
  for (int k = 0; k < 8; ++k) {
    if (nd.children[k] >= 0) {
      radius_query(t, nd.children[k], x, y, z, r2, out, cap, count);
    }
  }
}

static void knn_query(const Tree *t, int32_t ni, double x, double y, double z,
                      int64_t k,
                      std::priority_queue<std::pair<double, int32_t> > *heap) {
  const Node &nd = t->nodes[ni];
  if ((int64_t)heap->size() >= k &&
      node_dist2(nd, x, y, z) > heap->top().first) {
    return;
  }
  if (nd.leaf) {
    for (int32_t pi : nd.points) {
      const double d2 = sq(t->pos[3 * pi] - x) + sq(t->pos[3 * pi + 1] - y) +
                        sq(t->pos[3 * pi + 2] - z);
      if ((int64_t)heap->size() < k) {
        heap->push(std::make_pair(d2, pi));
      } else if (d2 < heap->top().first) {
        heap->pop();
        heap->push(std::make_pair(d2, pi));
      }
    }
    return;
  }
  // visit children nearest-first
  std::pair<double, int> order[8];
  int nc = 0;
  for (int c = 0; c < 8; ++c) {
    if (nd.children[c] >= 0) {
      order[nc++] = std::make_pair(
          node_dist2(t->nodes[nd.children[c]], x, y, z), nd.children[c]);
    }
  }
  std::sort(order, order + nc);
  for (int c = 0; c < nc; ++c) {
    knn_query(t, order[c].second, x, y, z, k, heap);
  }
}

}  // namespace octree

extern "C" {

void *octree_create(const double *positions, int64_t n) {
  octree::Tree *t = new octree::Tree();
  t->n = n;
  t->pos.assign(positions, positions + 3 * n);
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i) {
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = std::min(lo[ax], positions[3 * i + ax]);
      hi[ax] = std::max(hi[ax], positions[3 * i + ax]);
    }
  }
  const double half = 0.5 * std::max(1e-300,
      std::max(hi[0] - lo[0], std::max(hi[1] - lo[1], hi[2] - lo[2]))) *
      1.0000001;
  t->new_node(0.5 * (lo[0] + hi[0]), 0.5 * (lo[1] + hi[1]),
              0.5 * (lo[2] + hi[2]), half);
  for (int64_t i = 0; i < n; ++i) {
    t->insert(0, (int32_t)i, 0);
  }
  return t;
}

// All points within radius r of center; returns the TOTAL count (the
// caller re-queries with a larger buffer if count > cap).
int64_t octree_radius(void *handle, const double *center, double r,
                      int64_t *out, int64_t cap) {
  octree::Tree *t = (octree::Tree *)handle;
  int64_t count = 0;
  octree::radius_query(t, 0, center[0], center[1], center[2], r * r, out, cap,
                       &count);
  return count;
}

// k nearest neighbors of center, ascending by distance.
int64_t octree_knn(void *handle, const double *center, int64_t k,
                   int64_t *out_idx, double *out_dist) {
  octree::Tree *t = (octree::Tree *)handle;
  std::priority_queue<std::pair<double, int32_t> > heap;
  octree::knn_query(t, 0, center[0], center[1], center[2], k, &heap);
  int64_t m = (int64_t)heap.size();
  for (int64_t i = m - 1; i >= 0; --i) {
    out_idx[i] = heap.top().second;
    out_dist[i] = std::sqrt(heap.top().first);
    heap.pop();
  }
  return m;
}

void octree_free(void *handle) { delete (octree::Tree *)handle; }

}  // extern "C"
