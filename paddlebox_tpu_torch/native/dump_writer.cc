// Native xbox-dump TSV writer — the serving-dump IO hot path.
//
// ≙ the reference's native dump stack (SaveBase/SaveDelta write through
// boxps::PaddleFileMgr + thread pools, box_wrapper.cc:1286): formatting
// millions of "key\tshow\tclick\tembed_w\tmf..." lines in a Python loop
// is ~100k rows/s; this C++ writer formats into a grow-only buffer and
// writes once per call.  Loaded via ctypes (see io/checkpoint.py) with
// graceful Python fallback.
//
// API (C ABI):
//   pbox_dump_xbox(path, append, keys[n], show[n], click[n], embed_w[n],
//                  mf[n*d], n, d) -> rows written, or -1 on IO error.
//   show/click/embed_w are double so the ctr_double accessor's f64 stats
//   format exactly like the Python fallback (f32 inputs convert exactly).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cctype>
#include <cerrno>
#include <cmath>
#include <string>
#include <vector>

namespace {

// %.6g-compatible float formatting (matches the Python writer's "%.6g")
inline void append_g6(std::string &out, double v) {
  char buf[32];
  int k = snprintf(buf, sizeof(buf), "%.6g", v);
  out.append(buf, k);
}

}  // namespace

extern "C" {

long long pbox_dump_xbox(const char *path, int append,
                         const uint64_t *keys, const double *show,
                         const double *click, const double *embed_w,
                         const float *mf, long long n, long long d) {
  FILE *f = fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  std::string buf;
  buf.reserve(1 << 22);
  char tmp[32];
  for (long long i = 0; i < n; ++i) {
    int k = snprintf(tmp, sizeof(tmp), "%llu",
                     static_cast<unsigned long long>(keys[i]));
    buf.append(tmp, k);
    buf.push_back('\t');
    append_g6(buf, show[i]);
    buf.push_back('\t');
    append_g6(buf, click[i]);
    buf.push_back('\t');
    append_g6(buf, embed_w[i]);
    buf.push_back('\t');
    const float *row = mf + i * d;
    for (long long j = 0; j < d; ++j) {
      if (j) buf.push_back(' ');
      append_g6(buf, row[j]);
    }
    buf.push_back('\n');
    if (buf.size() > (1u << 22)) {
      if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        fclose(f);
        return -1;
      }
      buf.clear();
    }
  }
  if (!buf.empty() &&
      fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return -1;
  }
  if (fclose(f) != 0) return -1;
  return n;
}

}  // extern "C"

extern "C" {

// Parse an xbox dump buffer into preallocated column arrays.
// buf[len] is the whole file (NUL-terminated by the caller); rows were
// counted host-side (one per newline-terminated, non-empty line).
// Returns rows parsed, or -(line_index+1) on a malformed line (wrong
// field/mf count, bad or out-of-range number) so the caller can report
// the exact line.  The strto* family skips leading whitespace INCLUDING
// newlines — every field start is checked against that (a truncated
// line must fail loud, never silently consume the next line), and every
// parse end is bounds-checked against the line.
long long pbox_load_xbox(const char *buf, long long len, uint64_t *keys,
                         double *show, double *click, double *embed_w,
                         float *mf, long long n_rows, long long d) {
  const char *p = buf;
  const char *end = buf + len;
  long long row = 0;
  while (p < end && row < n_rows) {
    const char *line_end = static_cast<const char *>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    {  // skip blank lines, including whitespace-only separators, exactly
       // like the Python fallback's `if not line.strip(): continue`
      const char *q = p;
      while (q < line_end && isspace(static_cast<unsigned char>(*q))) ++q;
      if (q == line_end) {
        p = line_end + 1;
        continue;
      }
    }
    char *cur = const_cast<char *>(p);
    char *nxt = nullptr;
    const char *le = line_end;
    auto field_ok = [&](char *c) {
      return c < le && !isspace(static_cast<unsigned char>(*c));
    };
    // a leading '-' would silently wrap through strtoull; the fallback
    // rejects negative keys, so reject here too
    if (!field_ok(cur) || *cur == '-') return -(row + 1);
    errno = 0;
    keys[row] = strtoull(cur, &nxt, 10);
    if (nxt == cur || nxt > le || errno == ERANGE || *nxt != '\t')
      return -(row + 1);
    cur = nxt + 1;
    // ERANGE on *underflow* (subnormal/zero result) is accepted: %.6g of a
    // raw f32 training value can legitimately emit e.g. 1e-42, and Python's
    // float() loads it fine.  Non-finite results reject — both overflow
    // (1e999 -> HUGE_VAL with ERANGE) and literal inf/nan tokens (parsed
    // with errno==0) — matching the Python fallback's isfinite gate.
    double *cols[3] = {show, click, embed_w};
    for (int c3 = 0; c3 < 3; ++c3) {
      if (!field_ok(cur)) return -(row + 1);
      cols[c3][row] = strtod(cur, &nxt);
      if (nxt == cur || nxt > le || !std::isfinite(cols[c3][row]) ||
          *nxt != '\t')
        return -(row + 1);
      cur = nxt + 1;
    }
    float *out = mf + row * d;
    for (long long j = 0; j < d; ++j) {
      if (!field_ok(cur)) return -(row + 1);
      out[j] = strtof(cur, &nxt);
      if (nxt == cur || nxt > le || !std::isfinite(out[j]))
        return -(row + 1);
      cur = nxt;
      if (j + 1 < d) {
        if (*cur != ' ') return -(row + 1);
        ++cur;
      }
    }
    if (cur < line_end && *cur != '\r') return -(row + 1);
    p = line_end + 1;
    ++row;
  }
  return row;
}

}  // extern "C"
