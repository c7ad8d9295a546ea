// Host kernels of the DB decode's quad route, plain C interface.
//
// The port's own copy of the JAX package's native/ctdnative.cpp, with the
// same algorithms and the same order of floating-point operations, so that
// its doubles equal the JAX extension's bit for bit:
//
//   ctd_label_components
//       two-pass union-find connected components (4- or 8-connected);
//       components numbered 1..n in raster order of their first pixel
//   ctd_component_min_area_rects
//       one pass over a label map gathering each component's boundary
//       pixels, area and probability sum; then per component its convex
//       hull (monotone chain), min-area rect (rotating calipers), corner
//       order, closed-form unclip by d = w * h * ratio / (2 (w + h)) and the
//       corner order again
//
// The interface is the change: extern "C" functions on raw pointers, no
// CPython or NumPy headers, as the port's .cu libraries.  The caller
// allocates the outputs; growable buffers (the union-find's parent array,
// the boundary lists) stay inside.  comic_text_detector_tpu_torch/native.py
// builds it with the host C++ compiler (-O3 -std=c++17 -fno-exceptions
// -ffp-contract=off -shared -fPIC: no -march=native, no -ffast-math, no
// fused multiply-adds) and binds it with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// ---------- union-find ----------
struct DSU {
  std::vector<int32_t> parent;
  explicit DSU(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = (int32_t)i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  }
};

// ---------- geometry ----------
struct Pt {
  double x, y;
};

static double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain; returns CCW hull.
static std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(),
                        [](const Pt& a, const Pt& b) { return a.x == b.x && a.y == b.y; }),
            pts.end());
  size_t n = pts.size();
  if (n <= 2) return pts;
  std::vector<Pt> h(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {
    while (k >= 2 && cross(h[k - 2], h[k - 1], pts[i]) <= 0) k--;
    h[k++] = pts[i];
  }
  size_t lower = k + 1;
  for (size_t i = n - 1; i-- > 0;) {
    while (k >= lower && cross(h[k - 2], h[k - 1], pts[i]) <= 0) k--;
    h[k++] = pts[i];
  }
  h.resize(k - 1);
  return h;
}

// rotating calipers: min-area enclosing rect of a hull.
// out: 4 corners + (w, h)
static void min_area_rect(const std::vector<Pt>& hull, Pt out[4], double* w_out, double* h_out) {
  size_t n = hull.size();
  if (n == 0) {
    for (int i = 0; i < 4; ++i) out[i] = {0, 0};
    *w_out = *h_out = 0;
    return;
  }
  if (n == 1) {
    for (int i = 0; i < 4; ++i) out[i] = hull[0];
    *w_out = *h_out = 0;
    return;
  }
  if (n == 2) {
    out[0] = hull[0];
    out[1] = hull[1];
    out[2] = hull[1];
    out[3] = hull[0];
    *w_out = std::hypot(hull[1].x - hull[0].x, hull[1].y - hull[0].y);
    *h_out = 0;
    return;
  }
  double best_area = 1e300, best_a = 0, bmnx = 0, bmny = 0, bmxx = 0, bmxy = 0;
  for (size_t i = 0; i < n; ++i) {
    size_t j = (i + 1) % n;
    double a = std::atan2(hull[j].y - hull[i].y, hull[j].x - hull[i].x);
    a = std::fmod(a, M_PI / 2);
    if (a < 0) a += M_PI / 2;
    double c = std::cos(a), s = std::sin(a);
    double mnx = 1e300, mny = 1e300, mxx = -1e300, mxy = -1e300;
    for (const Pt& p : hull) {
      double rx = p.x * c + p.y * s;
      double ry = -p.x * s + p.y * c;
      mnx = std::min(mnx, rx);
      mny = std::min(mny, ry);
      mxx = std::max(mxx, rx);
      mxy = std::max(mxy, ry);
    }
    double area = (mxx - mnx) * (mxy - mny);
    if (area < best_area - 1e-12) {
      best_area = area;
      best_a = a;
      bmnx = mnx;
      bmny = mny;
      bmxx = mxx;
      bmxy = mxy;
    }
  }
  double c = std::cos(best_a), s = std::sin(best_a);
  double cx[4] = {bmnx, bmxx, bmxx, bmnx};
  double cy[4] = {bmny, bmny, bmxy, bmxy};
  for (int i = 0; i < 4; ++i) {
    out[i].x = cx[i] * c - cy[i] * s;
    out[i].y = cx[i] * s + cy[i] * c;
  }
  *w_out = bmxx - bmnx;
  *h_out = bmxy - bmny;
}

// order corners [tl, tr, br, bl] via the reference's x-sort rule
// (db_utils.py get_mini_boxes :176-195).
static void order_rect(Pt box[4]) {
  Pt p[4] = {box[0], box[1], box[2], box[3]};
  std::sort(p, p + 4, [](const Pt& a, const Pt& b) { return a.x < b.x || (a.x == b.x && a.y < b.y); });
  int i1, i2, i3, i4;
  if (p[1].y > p[0].y) {
    i1 = 0;
    i4 = 1;
  } else {
    i1 = 1;
    i4 = 0;
  }
  if (p[3].y > p[2].y) {
    i2 = 2;
    i3 = 3;
  } else {
    i2 = 3;
    i3 = 2;
  }
  box[0] = p[i1];
  box[1] = p[i2];
  box[2] = p[i3];
  box[3] = p[i4];
}

// inflate an ordered rect outward by d on every side (closed-form unclip).
static void inflate_rect(Pt box[4], double d) {
  double cx = 0, cy = 0;
  for (int i = 0; i < 4; ++i) {
    cx += box[i].x / 4;
    cy += box[i].y / 4;
  }
  Pt out[4];
  for (int i = 0; i < 4; ++i) {
    const Pt& prv = box[(i + 3) % 4];
    const Pt& nxt = box[(i + 1) % 4];
    const Pt& p = box[i];
    double n1x = p.y - prv.y, n1y = -(p.x - prv.x);
    double n2x = nxt.y - p.y, n2y = -(nxt.x - p.x);
    double l1 = std::hypot(n1x, n1y), l2 = std::hypot(n2x, n2y);
    if (l1 > 1e-12) {
      n1x /= l1;
      n1y /= l1;
      if (n1x * (p.x - cx) + n1y * (p.y - cy) < 0) {
        n1x = -n1x;
        n1y = -n1y;
      }
    } else {
      n1x = n1y = 0;
    }
    if (l2 > 1e-12) {
      n2x /= l2;
      n2y /= l2;
      if (n2x * (p.x - cx) + n2y * (p.y - cy) < 0) {
        n2x = -n2x;
        n2y = -n2y;
      }
    } else {
      n2x = n2y = 0;
    }
    out[i].x = p.x + (n1x + n2x) * d;
    out[i].y = p.y + (n1y + n2y) * d;
  }
  for (int i = 0; i < 4; ++i) box[i] = out[i];
}

}  // namespace

extern "C" {

// mask: (h, w) uint8, nonzero = foreground.  labels: (h, w) int32, written
// whole (0 = background).  Returns the number of components, or -1 for a
// connectivity other than 4 or 8.
int32_t ctd_label_components(const uint8_t* m, int64_t h, int64_t w, int32_t connectivity, int32_t* labels) {
  if (connectivity != 4 && connectivity != 8) return -1;
  std::fill(labels, labels + (size_t)h * w, 0);

  // pass 1: provisional labels + unions
  std::vector<int32_t> prov((size_t)h * w, 0);
  int32_t next = 1;
  DSU dsu((size_t)h * w / 2 + 2);
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      size_t idx = (size_t)y * w + x;
      if (!m[idx]) continue;
      int32_t left = (x > 0 && m[idx - 1]) ? prov[idx - 1] : 0;
      int32_t up = (y > 0 && m[idx - w]) ? prov[idx - w] : 0;
      int32_t ul = (connectivity == 8 && y > 0 && x > 0 && m[idx - w - 1]) ? prov[idx - w - 1] : 0;
      int32_t ur = (connectivity == 8 && y > 0 && x + 1 < w && m[idx - w + 1]) ? prov[idx - w + 1] : 0;
      int32_t lab = 0;
      for (int32_t nb : {left, up, ul, ur}) {
        if (nb) lab = lab ? std::min(lab, nb) : nb;
      }
      if (!lab) {
        lab = next++;
        if ((size_t)next >= dsu.parent.size()) dsu.parent.resize(dsu.parent.size() * 2 + 16);
        for (size_t k = dsu.parent.size(); k-- > 0 && dsu.parent[k] == 0;) dsu.parent[k] = (int32_t)k;
      }
      for (int32_t nb : {left, up, ul, ur})
        if (nb && nb != lab) dsu.unite(nb, lab);
      prov[idx] = lab;
    }
  }
  // resolve + compact
  std::vector<int32_t> remap(next, 0);
  int32_t count = 0;
  for (int32_t i = 1; i < next; ++i) {
    int32_t r = dsu.find(i);
    if (!remap[r]) remap[r] = ++count;
    remap[i] = remap[r];
  }
  for (size_t i = 0; i < (size_t)h * w; ++i)
    if (prov[i]) labels[i] = remap[dsu.find(prov[i])];
  return count;
}

// labels: (h, w) int32; labels outside 1..n_comp are background.  prob:
// (h, w) float32 or null (scores 0).  Outputs, written whole: boxes (n_comp,
// 4, 2) float64 [tl, tr, br, bl] after the unclip, ssides (n_comp,) the
// rect's short side before it, scores (n_comp,) the mean probability; a
// component without pixels gives zeros.
void ctd_component_min_area_rects(const int32_t* L, int64_t h, int64_t w, int32_t n_comp, const float* P,
                                  double unclip_ratio, double* B, double* S, double* SC) {
  std::fill(B, B + (size_t)n_comp * 8, 0.0);
  std::fill(S, S + n_comp, 0.0);
  std::fill(SC, SC + n_comp, 0.0);

  // single pass: boundary points per component, prob sums, areas
  std::vector<std::vector<Pt>> boundary((size_t)n_comp + 1);
  std::vector<double> psum((size_t)n_comp + 1, 0.0);
  std::vector<int64_t> area((size_t)n_comp + 1, 0);
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      int32_t lab = L[(size_t)y * w + x];
      if (lab <= 0 || lab > n_comp) continue;
      area[lab]++;
      if (P) psum[lab] += P[(size_t)y * w + x];
      bool edge = x == 0 || y == 0 || x == w - 1 || y == h - 1 ||
                  L[(size_t)y * w + x - 1] != lab || L[(size_t)y * w + x + 1] != lab ||
                  L[(size_t)(y - 1) * w + x] != lab || L[(size_t)(y + 1) * w + x] != lab;
      if (edge) boundary[lab].push_back({(double)x, (double)y});
    }
  }

  for (int i = 1; i <= n_comp; ++i) {
    if (boundary[i].empty()) continue;
    std::vector<Pt> hull = convex_hull(boundary[i]);
    Pt box[4];
    double rw, rh;
    min_area_rect(hull, box, &rw, &rh);
    double per = 2 * (rw + rh);
    double d = per > 0 ? rw * rh * unclip_ratio / per : 0;
    order_rect(box);
    inflate_rect(box, d);
    order_rect(box);
    for (int k = 0; k < 4; ++k) {
      B[((size_t)(i - 1) * 4 + k) * 2] = box[k].x;
      B[((size_t)(i - 1) * 4 + k) * 2 + 1] = box[k].y;
    }
    S[i - 1] = std::min(rw, rh);
    SC[i - 1] = area[i] > 0 && P ? psum[i] / (double)area[i] : 0.0;
  }
}

}  // extern "C"
