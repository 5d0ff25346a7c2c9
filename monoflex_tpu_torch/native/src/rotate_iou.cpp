// Native evaluator kernels: rotated-rectangle overlap via convex polygon
// clipping, axis-aligned 2D overlap, and camera-frame 3D overlap.
//
// C++ replacement for the reference's numba-CUDA evaluation kernels
// (reference: data/datasets/evaluation/kitti_object_eval_python/rotate_iou.py:18-333,
// eval.py:84-152).  Exposed via a plain C ABI and loaded with ctypes
// (monoflex_tpu_torch/native/__init__.py); semantics match the numpy
// implementation in monoflex_tpu_torch/eval/rotate_iou.py, which is the test
// oracle.  A copy of the JAX package's monoflex_tpu/native/src/rotate_iou.cpp.
//
// Box format: (cx, cy, w, h, angle).  Criterion: -1 IoU, 0 inter/area_a,
// 1 inter/area_b, 2 raw intersection area.

#include <algorithm>
#include <cmath>
#include <cstddef>

namespace {

struct Pt {
  double x, y;
};

constexpr int kMaxVerts = 16;

void box_corners(const double* b, Pt out[4]) {
  const double cx = b[0], cy = b[1], w = b[2], h = b[3], ang = b[4];
  const double c = std::cos(ang), s = std::sin(ang);
  const double dx[4] = {-w / 2, w / 2, w / 2, -w / 2};
  const double dy[4] = {-h / 2, -h / 2, h / 2, h / 2};
  for (int i = 0; i < 4; ++i) {
    // KITTI ry rotates about the camera y-axis: CLOCKWISE in the BEV (x, z)
    // plane (x' = x cos + z sin, z' = -x sin + z cos) — must match
    // eval/rotate_iou.py::box_corners and the reference rbbox_to_corners.
    out[i].x = cx + c * dx[i] + s * dy[i];
    out[i].y = cy - s * dx[i] + c * dy[i];
  }
}

double signed_area(const Pt* p, int n) {
  double a = 0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return 0.5 * a;
}

// Sutherland-Hodgman: clip convex polygon (pts, n) by the half-plane left of
// the directed edge a->b.  Returns the new vertex count.
int clip_halfplane(const Pt* in, int n, Pt a, Pt b, Pt* out) {
  const double ex = b.x - a.x, ey = b.y - a.y;
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    const double si = ex * (in[i].y - a.y) - ey * (in[i].x - a.x);
    const double sj = ex * (in[j].y - a.y) - ey * (in[j].x - a.x);
    if (si >= 0) out[m++] = in[i];
    if ((si >= 0) != (sj >= 0)) {
      const double denom = si - sj;
      const double t = denom != 0 ? si / denom : 0.0;
      out[m].x = in[i].x + (in[j].x - in[i].x) * t;
      out[m].y = in[i].y + (in[j].y - in[i].y) * t;
      ++m;
    }
  }
  return m;
}

double intersection_area(const Pt a_in[4], const Pt b_in[4]) {
  Pt a[4], b[4];
  for (int i = 0; i < 4; ++i) { a[i] = a_in[i]; b[i] = b_in[i]; }
  // ensure CCW winding of the clip polygon
  if (signed_area(b, 4) < 0) std::swap(b[0], b[3]), std::swap(b[1], b[2]);
  Pt buf1[kMaxVerts], buf2[kMaxVerts];
  int n = 4;
  for (int i = 0; i < 4; ++i) buf1[i] = a[i];
  Pt* cur = buf1;
  Pt* nxt = buf2;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_halfplane(cur, n, b[e], b[(e + 1) % 4], nxt);
    std::swap(cur, nxt);
  }
  if (n < 3) return 0.0;
  return std::abs(signed_area(cur, n));
}

}  // namespace

extern "C" {

// boxes (n, 5), qboxes (k, 5) -> out (n, k)
void rotate_iou_eval(const double* boxes, long n, const double* qboxes, long k,
                     int criterion, double* out) {
  for (long i = 0; i < n; ++i) {
    Pt ca[4];
    box_corners(boxes + i * 5, ca);
    double axmin = ca[0].x, axmax = ca[0].x, aymin = ca[0].y, aymax = ca[0].y;
    for (int v = 1; v < 4; ++v) {
      axmin = std::min(axmin, ca[v].x); axmax = std::max(axmax, ca[v].x);
      aymin = std::min(aymin, ca[v].y); aymax = std::max(aymax, ca[v].y);
    }
    const double area_a = boxes[i * 5 + 2] * boxes[i * 5 + 3];
    for (long j = 0; j < k; ++j) {
      Pt cb[4];
      box_corners(qboxes + j * 5, cb);
      double bxmin = cb[0].x, bxmax = cb[0].x, bymin = cb[0].y, bymax = cb[0].y;
      for (int v = 1; v < 4; ++v) {
        bxmin = std::min(bxmin, cb[v].x); bxmax = std::max(bxmax, cb[v].x);
        bymin = std::min(bymin, cb[v].y); bymax = std::max(bymax, cb[v].y);
      }
      double val = 0.0;
      if (!(axmax < bxmin || bxmax < axmin || aymax < bymin || bymax < aymin)) {
        const double inter = intersection_area(ca, cb);
        const double area_b = qboxes[j * 5 + 2] * qboxes[j * 5 + 3];
        if (criterion == -1) {
          const double denom = area_a + area_b - inter;
          val = denom > 0 ? inter / denom : 0.0;
        } else if (criterion == 0) {
          val = area_a > 0 ? inter / area_a : 0.0;
        } else if (criterion == 1) {
          val = area_b > 0 ? inter / area_b : 0.0;
        } else {
          val = inter;
        }
      }
      out[i * k + j] = val;
    }
  }
}

// boxes (n, 7) [x y z l h w ry] camera coords -> out (n, k)
void d3_box_overlap(const double* boxes, long n, const double* qboxes, long k,
                    int criterion, double* out) {
  for (long i = 0; i < n; ++i) {
    const double* bi = boxes + i * 7;
    const double bev_i[5] = {bi[0], bi[2], bi[3], bi[5], bi[6]};
    Pt ca[4];
    box_corners(bev_i, ca);
    const double vol_a = bi[3] * bi[4] * bi[5];
    for (long j = 0; j < k; ++j) {
      const double* bj = qboxes + j * 7;
      const double bev_j[5] = {bj[0], bj[2], bj[3], bj[5], bj[6]};
      Pt cb[4];
      box_corners(bev_j, cb);
      double val = 0.0;
      const double rinc = intersection_area(ca, cb);
      if (rinc > 0) {
        const double iw = std::min(bi[1], bj[1]) -
                          std::max(bi[1] - bi[4], bj[1] - bj[4]);
        if (iw > 0) {
          const double vol_b = bj[3] * bj[4] * bj[5];
          const double inc = iw * rinc;
          if (criterion == -1) {
            const double denom = vol_a + vol_b - inc;
            val = denom > 0 ? inc / denom : 0.0;
          } else if (criterion == 0) {
            val = vol_a > 0 ? inc / vol_a : 0.0;
          } else if (criterion == 1) {
            val = vol_b > 0 ? inc / vol_b : 0.0;
          } else {
            val = inc;
          }
        }
      }
      out[i * k + j] = val;
    }
  }
}

// boxes (n, 4), qboxes (k, 4) -> out (n, k); criterion as above
void image_box_overlap(const double* boxes, long n, const double* qboxes,
                       long k, int criterion, double* out) {
  for (long i = 0; i < n; ++i) {
    const double* a = boxes + i * 4;
    const double area_a = (a[2] - a[0]) * (a[3] - a[1]);
    for (long j = 0; j < k; ++j) {
      const double* b = qboxes + j * 4;
      const double iw = std::min(a[2], b[2]) - std::max(a[0], b[0]);
      const double ih = std::min(a[3], b[3]) - std::max(a[1], b[1]);
      double val = 0.0;
      if (iw > 0 && ih > 0) {
        const double inter = iw * ih;
        const double area_b = (b[2] - b[0]) * (b[3] - b[1]);
        double denom;
        if (criterion == -1) denom = area_a + area_b - inter;
        else if (criterion == 0) denom = area_a;
        else if (criterion == 1) denom = area_b;
        else { out[i * k + j] = inter; continue; }
        val = denom > 0 ? inter / denom : 0.0;
      }
      out[i * k + j] = val;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// AP matching statistics: the evaluator's hot loop
// (reference: kitti_object_eval_python/eval.py:155-337, numba CPU kernels).
// For one image, accumulate tp/fp/fn/similarity for every score threshold.
// ---------------------------------------------------------------------------

extern "C" void compute_statistics_thresholds(
    const double* overlaps,      // (n_dt, n_gt) row-major
    const double* dt_scores,     // (n_dt)
    const double* dt_alphas,     // (n_dt)
    const double* gt_alphas,     // (n_gt)
    const double* dt_bboxes,     // (n_dt, 4)
    const long* ignored_gt,      // (n_gt)  0 valid / 1 ignore / -1 skip
    const long* ignored_det,     // (n_dt)
    const double* dc_bboxes,     // (n_dc, 4)
    long n_dt, long n_gt, long n_dc,
    int metric, double min_overlap,
    const double* thresholds, long n_thresh,
    int compute_aos,
    double* pr) {                // (n_thresh, 4) accumulated in place
  constexpr double kNoDetection = -10000000.0;
  for (long t = 0; t < n_thresh; ++t) {
    const double thresh = thresholds[t];
    bool assigned[4096];
    bool ignored_threshold[4096];
    for (long j = 0; j < n_dt; ++j) {
      assigned[j] = false;
      ignored_threshold[j] = dt_scores[j] < thresh;
    }
    long tp = 0, fp = 0, fn = 0;
    double similarity = 0.0;
    long delta_count = 0;
    double delta[4096];

    for (long i = 0; i < n_gt; ++i) {
      if (ignored_gt[i] == -1) continue;
      long det_idx = -1;
      double valid_detection = kNoDetection;
      double max_overlap = 0.0;
      bool assigned_ignored_det = false;
      for (long j = 0; j < n_dt; ++j) {
        if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j]) continue;
        const double overlap = overlaps[j * n_gt + i];
        if (overlap > min_overlap &&
            (overlap > max_overlap || assigned_ignored_det) &&
            ignored_det[j] == 0) {
          max_overlap = overlap;
          det_idx = j;
          valid_detection = 1.0;
          assigned_ignored_det = false;
        } else if (overlap > min_overlap && valid_detection == kNoDetection &&
                   ignored_det[j] == 1) {
          det_idx = j;
          valid_detection = 1.0;
          assigned_ignored_det = true;
        }
      }
      if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
        ++fn;
      } else if (valid_detection != kNoDetection &&
                 (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
        assigned[det_idx] = true;
      } else if (valid_detection != kNoDetection) {
        ++tp;
        if (compute_aos) delta[delta_count++] = gt_alphas[i] - dt_alphas[det_idx];
        assigned[det_idx] = true;
      }
    }

    for (long j = 0; j < n_dt; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_threshold[j])) {
        ++fp;
      }
    }
    long nstuff = 0;
    if (metric == 0 && n_dc > 0) {
      for (long d = 0; d < n_dc; ++d) {
        const double* dc = dc_bboxes + d * 4;
        const double dc_area = (dc[2] - dc[0]) * (dc[3] - dc[1]);
        (void)dc_area;
        for (long j = 0; j < n_dt; ++j) {
          if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
              ignored_threshold[j]) continue;
          const double* b = dt_bboxes + j * 4;
          const double iw = std::min(b[2], dc[2]) - std::max(b[0], dc[0]);
          const double ih = std::min(b[3], dc[3]) - std::max(b[1], dc[1]);
          if (iw > 0 && ih > 0) {
            const double area_b = (b[2] - b[0]) * (b[3] - b[1]);
            const double ov = area_b > 0 ? iw * ih / area_b : 0.0;  // criterion 0
            if (ov > min_overlap) {
              assigned[j] = true;
              ++nstuff;
            }
          }
        }
      }
    }
    fp -= nstuff;
    if (compute_aos) {
      if (tp > 0 || fp > 0) {
        for (long d = 0; d < delta_count; ++d) {
          similarity += (1.0 + std::cos(delta[d])) / 2.0;
        }
      } else {
        similarity = -1.0;
      }
    }
    pr[t * 4 + 0] += tp;
    pr[t * 4 + 1] += fp;
    pr[t * 4 + 2] += fn;
    if (compute_aos && similarity != -1.0) pr[t * 4 + 3] += similarity;
  }
}
