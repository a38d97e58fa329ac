// Object geometry on the host from a foreground grouping: the second half
// of native/src/fusionhost.cpp fh_assemble_objects with its three passes
// over the dense label grid gone.
//
// fh_assemble_objects counts the cells of every (object, layer) group,
// finds each component's first pixel and scatters the groups' (x, y) by
// passing over all Z x H x W labels, then fits the geometry. Here the
// grouping comes in already made (mapping/segmentation.py
// group_foreground, on the card): group starts, the groups' (x, y) in
// raster order, and the components with their first pixels. What is left
// is the geometry, over the foreground alone: each group's convex hull and
// its 16 shape numbers, each object's top view, and each component's
// Moore contour, traced on the dense host labels, with its shapes.
//
// The helpers (PD, hull_chain, fit_shapes16, trace_label_contour) are
// fusionhost.cpp's own, included unchanged, and this file is built with
// native/Makefile's flags (utils/native.py), so every number is the native
// call's bit for bit. Groups, top views and components are independent and
// each is computed whole by one thread of an OpenMP team, so the numbers
// do not depend on the team: at the node's ~220 items (~190 groups and
// top views, ~90 contours) a team of four took the call from 1.39 to 0.64
// ms warm and from 1.94 to 1.09 ms with cold caches on the 8-core host of
// an H100 machine (serially the shape fits, a few us an item, were most
// of it).
#include "fusionhost.cpp"

namespace {

bool same_point(const PD& a, const PD& b) {
  return a.x == b.x && a.y == b.y;
}

// One stable counting sort of p (integer coordinates) by x (by_x) or y,
// through tmp.
void counting_pass(std::vector<PD>& p, std::vector<PD>& tmp,
                   std::vector<int64_t>& cnt, bool by_x) {
  double lo = by_x ? p[0].x : p[0].y, hi = lo;
  for (const PD& q : p) {
    const double v = by_x ? q.x : q.y;
    lo = std::min(lo, v);
    hi = std::max(hi, v);
  }
  cnt.assign((size_t)(hi - lo) + 2, 0);
  for (const PD& q : p) ++cnt[(size_t)((by_x ? q.x : q.y) - lo) + 1];
  for (size_t k = 1; k < cnt.size(); ++k) cnt[k] += cnt[k - 1];
  tmp.resize(p.size());
  for (const PD& q : p) tmp[cnt[(size_t)((by_x ? q.x : q.y) - lo)]++] = q;
  p.swap(tmp);
}

// p in lex (x, y) order, as fusionhost.cpp's std::sort leaves it (the
// order of distinct points is unique, and equal points are equal): two
// stable counting sorts, by y then by x, in O(n + extent) where a group's
// hundreds of points would pay n log n comparisons.
void lex_sort(std::vector<PD>& p, std::vector<PD>& tmp,
              std::vector<int64_t>& cnt) {
  if (p.size() < 2) return;
  counting_pass(p, tmp, cnt, false);
  counting_pass(p, tmp, cnt, true);
}

void put_xy(const std::vector<PD>& v, int32_t* out) {
  for (size_t i = 0; i < v.size(); ++i) {
    out[2 * i] = (int32_t)v[i].x;
    out[2 * i + 1] = (int32_t)v[i].y;
  }
}

}  // namespace

// labels: the dense [Z, H, W] u16 labels; M merged ids (0: background);
// group_start [M * Z + 1] and pts_xy [2 * fg]: the grouping (group (m, z)
// of rows [group_start[m * Z + z], group_start[m * Z + z + 1]), raster
// order within); comps [nc, 4]: (z, l, m, first raster index) in
// ascending (z, l). Outputs as fh_assemble_objects' (sized by the caller
// as utils/native.py assemble_objects sizes them); returns nc, or -1 if
// contour_cap was insufficient.
extern "C" int32_t fg_assemble_grouped(
    const uint16_t* labels, int32_t Z, int32_t H, int32_t W, int32_t M,
    double sx, double sy, double ox, double oy, const int64_t* group_start,
    const int32_t* pts_xy, const int32_t* comps, int32_t nc,
    int64_t* hull_start, int32_t* hull_xy, double* layer_shapes,
    int64_t* tv_start, int32_t* tv_xy, int64_t* tv_hull_start,
    int32_t* tv_hull_xy, double* tv_shapes, int32_t* comp_zlm,
    int64_t* contour_start, int32_t* contour_xy, int64_t contour_cap,
    double* comp_shapes) {
  const int64_t hw = (int64_t)H * W;
  const int64_t ng = (int64_t)M * Z;
  std::vector<std::vector<PD>> hulls(ng), tv(M), tv_hull(M);
  std::vector<std::vector<int32_t>> contours(nc);
#pragma omp parallel
  {
    std::vector<PD> pts, tmp, hull;
    std::vector<int64_t> cnt;
    // --- per-(m, z) hull + shapes
#pragma omp for schedule(dynamic) nowait
    for (int64_t g = 0; g < ng; ++g) {
      std::fill(layer_shapes + 16 * g, layer_shapes + 16 * (g + 1), 0.0);
      const int64_t lo = group_start[g], hi = group_start[g + 1];
      if (hi == lo) continue;
      pts.resize((size_t)(hi - lo));
      for (int64_t i = lo; i < hi; ++i)
        pts[i - lo] = PD{(double)pts_xy[2 * i], (double)pts_xy[2 * i + 1]};
      lex_sort(pts, tmp, cnt);
      hull_chain(pts, hulls[g]);
      fit_shapes16(hulls[g], sx, sy, ox, oy, layer_shapes + 16 * g);
    }
    // --- topview per m: unique (x, y) over all layers, lex-sorted
#pragma omp for schedule(dynamic) nowait
    for (int32_t m = 1; m < M; ++m) {
      std::fill(tv_shapes + 16 * m, tv_shapes + 16 * (m + 1), 0.0);
      std::vector<PD>& p = tv[m];
      for (int64_t i = group_start[(int64_t)m * Z];
           i < group_start[(int64_t)(m + 1) * Z]; ++i)
        p.push_back(PD{(double)pts_xy[2 * i], (double)pts_xy[2 * i + 1]});
      if (p.empty()) continue;
      lex_sort(p, tmp, cnt);
      p.erase(std::unique(p.begin(), p.end(), same_point), p.end());
      hull_chain(p, tv_hull[m]);
      fit_shapes16(tv_hull[m], sx, sy, ox, oy, tv_shapes + 16 * m);
    }
    // --- components: Moore contour + shapes
#pragma omp for schedule(dynamic)
    for (int32_t c = 0; c < nc; ++c) {
      const int32_t* cz = comps + 4 * c;
      trace_label_contour(labels + (size_t)cz[0] * hw, H, W,
                          (uint16_t)cz[1], cz[3] / W, cz[3] % W,
                          contours[c]);
      const std::vector<int32_t>& xy = contours[c];
      pts.resize(xy.size() / 2);
      for (size_t i = 0; i < pts.size(); ++i)
        pts[i] = PD{(double)xy[2 * i], (double)xy[2 * i + 1]};
      lex_sort(pts, tmp, cnt);
      pts.erase(std::unique(pts.begin(), pts.end(), same_point), pts.end());
      hull_chain(pts, hull);
      fit_shapes16(hull, sx, sy, ox, oy, comp_shapes + 16 * c);
    }
  }
  hull_start[0] = 0;
  for (int64_t g = 0; g < ng; ++g) {
    hull_start[g + 1] = hull_start[g] + (int64_t)hulls[g].size();
    put_xy(hulls[g], hull_xy + 2 * hull_start[g]);
  }
  std::fill(tv_shapes, tv_shapes + 16, 0.0);  // background stub
  tv_start[0] = tv_hull_start[0] = 0;
  for (int32_t m = 0; m < M; ++m) {
    tv_start[m + 1] = tv_start[m] + (int64_t)tv[m].size();
    tv_hull_start[m + 1] = tv_hull_start[m] + (int64_t)tv_hull[m].size();
    put_xy(tv[m], tv_xy + 2 * tv_start[m]);
    put_xy(tv_hull[m], tv_hull_xy + 2 * tv_hull_start[m]);
  }
  contour_start[0] = 0;
  for (int32_t c = 0; c < nc; ++c) {
    contour_start[c + 1] = contour_start[c] + (int64_t)contours[c].size() / 2;
    if (contour_start[c + 1] > contour_cap) return -1;
    std::memcpy(contour_xy + 2 * contour_start[c], contours[c].data(),
                contours[c].size() * sizeof(int32_t));
    for (int k = 0; k < 3; ++k) comp_zlm[3 * c + k] = comps[4 * c + k];
  }
  return nc;
}
