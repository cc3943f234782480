// Native KITTI AP statistics kernels.
//
// The per-image greedy matching loop runs num_images x 41 thresholds x
// (num_dt x num_gt) times per metric/class/difficulty — the hot path the
// reference accelerates with numba JIT (core/evaluation/kitti_utils/
// eval.py:161-288). numba isn't in this image; this C++ translation unit
// provides the same semantics behind a C ABI consumed via ctypes, with a
// pure-numpy fallback when the shared library isn't built.
//
// Built at first use by eval/_native/__init__.py (g++ -O2 -shared -fPIC)
// into the repository's build/native/.
//
// Lineage: the matching algorithm follows the official KITTI devkit /
// kitti-object-eval-python protocol — the branch structure is the spec.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr float kNoDetection = -10000000.0f;

inline float box_overlap_ioa(const float* a, const float* b) {
  // intersection over area(a) — DontCare absorption criterion
  const float iw =
      std::fmin(a[2], b[2]) - std::fmax(a[0], b[0]);
  const float ih =
      std::fmin(a[3], b[3]) - std::fmax(a[1], b[1]);
  if (iw <= 0.0f || ih <= 0.0f) return 0.0f;
  const float area = (a[2] - a[0]) * (a[3] - a[1]);
  return area > 1e-8f ? iw * ih / area : 0.0f;
}

// One (image, threshold) statistics pass. Mirrors the matching rules:
// * detections below the score threshold are invisible,
// * each counted GT greedily claims the best-overlap unassigned detection
//   (preferring non-ignored detections),
// * matches to ignored GTs / by ignored detections are neither TP nor FP,
// * unassigned non-ignored detections above the threshold are FPs, minus
//   those absorbed by DontCare regions (bbox metric only).
void stats_one(const float* overlaps,  // (num_dt, num_gt) row-major
               int num_dt, int num_gt,
               const float* dt_scores, const float* dt_alphas,
               const float* gt_alphas, const float* dt_bboxes,
               const float* dc_bboxes, int num_dc,
               const int* ignored_gt, const int* ignored_det,
               int metric, float min_overlap, float thresh,
               bool compute_fp, bool compute_aos,
               float* tp, float* fp, float* fn, float* sim,
               float* tp_scores, int* num_tp_scores,
               bool* assigned /* scratch, size num_dt */) {
  std::memset(assigned, 0, sizeof(bool) * num_dt);
  *tp = 0; *fp = 0; *fn = 0; *sim = 0;
  if (num_tp_scores) *num_tp_scores = 0;

  for (int i = 0; i < num_gt; ++i) {
    if (ignored_gt[i] == -1) continue;
    int det_idx = -1;
    float valid_detection = kNoDetection;
    float max_overlap = 0.0f;
    bool assigned_ignored_det = false;

    for (int j = 0; j < num_dt; ++j) {
      if (ignored_det[j] == -1 || assigned[j]) continue;
      if (compute_fp && dt_scores[j] < thresh) continue;
      const float overlap = overlaps[j * num_gt + i];
      const float score = dt_scores[j];
      if (!compute_fp) {
        if (overlap > min_overlap && score > valid_detection) {
          det_idx = j;
          valid_detection = score;
        }
      } else if (overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1.0f;
        assigned_ignored_det = false;
      } else if (overlap > min_overlap &&
                 valid_detection == kNoDetection && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1.0f;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
      *fn += 1;
    } else if (valid_detection != kNoDetection &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = true;
    } else if (valid_detection != kNoDetection) {
      *tp += 1;
      if (tp_scores && num_tp_scores) {
        tp_scores[(*num_tp_scores)++] = dt_scores[det_idx];
      }
      if (compute_aos) {
        *sim += (1.0f + std::cos(gt_alphas[i] - dt_alphas[det_idx])) / 2.0f;
      }
      assigned[det_idx] = true;
    }
  }

  if (compute_fp) {
    for (int j = 0; j < num_dt; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            dt_scores[j] < thresh)) {
        *fp += 1;
      }
    }
    if (metric == 0 && num_dc > 0) {
      for (int d = 0; d < num_dc; ++d) {
        for (int j = 0; j < num_dt; ++j) {
          if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
              dt_scores[j] < thresh) {
            continue;
          }
          if (box_overlap_ioa(&dt_bboxes[j * 4], &dc_bboxes[d * 4]) >
              min_overlap) {
            assigned[j] = true;
            *fp -= 1;
          }
        }
      }
    }
    // devkit edge case (reference eval.py:276-279): no TPs and no FPs in
    // an image contributes -1 (not 0) to the AOS numerator
    if (compute_aos && *tp == 0 && *fp == 0) {
      *sim = -1.0f;
    }
  }
}

}  // namespace

extern "C" {

// First pass: TP scores for threshold construction. Returns count.
int kitti_tp_scores(const float* overlaps, int num_dt, int num_gt,
                    const float* dt_scores, const int* ignored_gt,
                    const int* ignored_det, float min_overlap,
                    float* tp_scores_out) {
  float tp, fp, fn, sim;
  int n = 0;
  bool* assigned = new bool[num_dt > 0 ? num_dt : 1];
  stats_one(overlaps, num_dt, num_gt, dt_scores, nullptr, nullptr, nullptr,
            nullptr, 0, ignored_gt, ignored_det, 0, min_overlap, 0.0f,
            /*compute_fp=*/false, /*compute_aos=*/false, &tp, &fp, &fn, &sim,
            tp_scores_out, &n, assigned);
  delete[] assigned;
  return n;
}

// Second pass: accumulate (tp, fp, fn, similarity) per threshold into
// out4 (num_thr, 4), ADDING to existing values (caller accumulates over
// images).
void kitti_stats_thresholds(
    const float* overlaps, int num_dt, int num_gt, const float* dt_scores,
    const float* dt_alphas, const float* gt_alphas, const float* dt_bboxes,
    const float* dc_bboxes, int num_dc, const int* ignored_gt,
    const int* ignored_det, int metric, float min_overlap,
    const float* thresholds, int num_thr, int compute_aos, float* out4) {
  bool* assigned = new bool[num_dt > 0 ? num_dt : 1];
  for (int t = 0; t < num_thr; ++t) {
    float tp, fp, fn, sim;
    stats_one(overlaps, num_dt, num_gt, dt_scores, dt_alphas, gt_alphas,
              dt_bboxes, dc_bboxes, num_dc, ignored_gt, ignored_det, metric,
              min_overlap, thresholds[t], /*compute_fp=*/true,
              compute_aos != 0, &tp, &fp, &fn, &sim, nullptr, nullptr,
              assigned);
    out4[t * 4 + 0] += tp;
    out4[t * 4 + 1] += fp;
    out4[t * 4 + 2] += fn;
    out4[t * 4 + 3] += sim;
  }
  delete[] assigned;
}

}  // extern "C"
