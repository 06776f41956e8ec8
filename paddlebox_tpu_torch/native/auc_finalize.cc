// The AUC calculator's host finalisation over its float64 bucket tables
// (metrics/auc.py's AucCalculator): the bucket-error walk and the fold to
// coarse buckets, each one call instead of a Python loop per bucket.
//
// Both keep the Python code's operations in its order, so their results
// are bit-identical to it (tests/test_torch_auc_native.py).  That needs
// floating-point contraction off, which native/build.py's -ffp-contract=off
// gives: with -march=native, g++ would otherwise fuse `ctr * show` into the
// running sum (and the like) as one multiply-add, which rounds once
// instead of twice and moves the last bits.

#include <cmath>
#include <cstdint>

extern "C" {

// ≙ calculate_bucket_error (metrics.cc:373-410): merge adjacent non-empty
// buckets until the adjusted-ctr estimate is statistically tight, then
// accumulate the relative error of actual vs adjusted ctr.  Empty buckets
// (pos + neg == 0, as np.nonzero sees them) are skipped.  Writes the
// bucket error to *out and returns 0, or returns 1 where the Python loop's
// math.sqrt would raise (a negative argument, from negative weights).
int pbox_auc_bucket_error(const double *pos, const double *neg,
                          int64_t table_size, double max_span,
                          double relative_error_bound, double *out) {
  double last_ctr = -1.0;
  double impression_sum = 0.0, ctr_sum = 0.0, click_sum = 0.0;
  double error_sum = 0.0, error_count = 0.0;
  const double size = static_cast<double>(table_size);
  for (int64_t i = 0; i < table_size; ++i) {
    const double show = pos[i] + neg[i];
    if (show == 0.0) continue;
    const double click = pos[i];
    const double ctr = static_cast<double>(i) / size;
    if (std::fabs(ctr - last_ctr) > max_span) {
      last_ctr = ctr;
      impression_sum = ctr_sum = click_sum = 0.0;
    }
    impression_sum += show;
    ctr_sum += ctr * show;
    click_sum += click;
    const double adjust_ctr = ctr_sum / impression_sum;
    if (adjust_ctr <= 0 || adjust_ctr >= 1) continue;
    const double arg = (1 - adjust_ctr) / (adjust_ctr * impression_sum);
    if (arg < 0) return 1;
    const double relative_error = std::sqrt(arg);
    if (relative_error < relative_error_bound) {
      const double actual = click_sum / impression_sum;
      error_sum += std::fabs(actual / adjust_ctr - 1) * impression_sum;
      error_count += impression_sum;
      last_ctr = -1.0;
    }
  }
  *out = error_count > 0 ? error_sum / error_count : 0.0;
  return 0;
}

// The tables folded to `bins` coarse buckets: bucket i adds into
// (i * bins) / table_size, in ascending i from 0.0, as np.add.at does.
// Coarse bucket b holds the i with b * table_size <= i * bins <
// (b + 1) * table_size: one contiguous range, summed in order.
void pbox_auc_fold(const double *pos, const double *neg, int64_t table_size,
                   int64_t bins, double *out_pos, double *out_neg) {
  for (int64_t b = 0; b < bins; ++b) {
    const int64_t lo = (b * table_size + bins - 1) / bins;
    const int64_t hi = ((b + 1) * table_size + bins - 1) / bins;
    double p = 0.0, q = 0.0;
    for (int64_t i = lo; i < hi; ++i) {
      p += pos[i];
      q += neg[i];
    }
    out_pos[b] = p;
    out_neg[b] = q;
  }
}

}  // extern "C"
