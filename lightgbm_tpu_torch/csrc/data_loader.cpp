// Native data-loading runtime for lightgbm_tpu_torch: the host loader.
//
// The torch port's own copy of the JAX package's csrc/data_loader.cpp,
// with the same C ABI (lgbt_parse_file, lgbt_free, lgbt_values_to_bins)
// and the same arithmetic, so a clean file reads to the same bits in both
// packages.  The reference implements its parser/loader stack in C++
// (src/io/parser.{cpp,hpp}: CSV/TSV/LibSVM ParseOneLine; dataset_loader.cpp:
// two-round streaming + feature extraction; text_reader.h: chunked parallel
// reads).  This file is a multithreaded text parser producing a dense
// row-major float64 matrix (dense because the data layer bins into dense
// feature-major arrays), plus the binning hot loop (value->bin binary
// search, bin.h:385-407) that turns raw columns into bin codes without
// holding the GIL.  Host code only (no CUDA), built with the host C++
// compiler at first use and bound through ctypes
// (lightgbm_tpu_torch/io/native.py).
//
// Format auto-detection mirrors Parser::CreateParser (parser.cpp:10-72):
// count ',' '\t' ':' occurrences in the probe lines; ':' dominance means
// LibSVM, else the more frequent of comma/tab.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <limits>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// fast float parse (strtod is locale-dependent and slow; this is the usual
// hand-rolled parser, ~4x faster, matching Common::Atof behavior)
// ---------------------------------------------------------------------------
inline const char* skip_space(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  return p;
}

// Case-insensitive match of [b, e) against one of the NA / infinity
// spellings (the Python guard helpers' vocabulary, io/guard.py
// NA_TOKENS) — anything else starting with an alpha char is a
// *malformed* token, reported through first_bad_row so the guarded
// Python path re-parses with full diagnostics.
inline bool word_matches(const char* b, const char* e, const char* w) {
  while (b < e && *w) {
    if (std::tolower(static_cast<unsigned char>(*b)) != *w) return false;
    ++b;
    ++w;
  }
  return b == e && *w == '\0';
}

inline bool is_na_word(const char* b, const char* e) {
  return word_matches(b, e, "na") || word_matches(b, e, "nan") ||
         word_matches(b, e, "null") || word_matches(b, e, "none");
}

inline bool is_inf_word(const char* b, const char* e) {
  return word_matches(b, e, "inf") || word_matches(b, e, "infinity");
}

inline double parse_double(const char* p, const char* end, const char** out) {
  p = skip_space(p, end);
  const char* token_start = p;  // rewind point for degenerate tokens
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  double value = 0.0;
  bool consumed = false;
  while (p < end && *p >= '0' && *p <= '9') {
    value = value * 10.0 + (*p - '0');
    consumed = true;
    ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    double frac = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      value += (*p - '0') * frac;
      frac *= 0.1;
      consumed = true;
      ++p;
    }
  }
  if (consumed && p < end && (*p == 'e' || *p == 'E')) {
    const char* exp_start = p;
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    int ex = 0;
    bool edigits = false;
    while (p < end && *p >= '0' && *p <= '9') {
      ex = ex * 10 + (*p - '0');
      edigits = true;
      ++p;
    }
    if (!edigits) {
      // "1e" / "2e+": not an exponent — leave the 'e' unconsumed so
      // the caller's whole-token check flags the row (Python
      // float("1e") is a classified bad token; parity)
      p = exp_start;
    } else {
      double scale = 1.0;
      double base = 10.0;
      int e = ex;
      while (e) {             // pow10 by squaring
        if (e & 1) scale *= base;
        base *= base;
        e >>= 1;
      }
      value = eneg ? value / scale : value * scale;
    }
  }
  // Word spellings: na/nan/null/none -> NaN (missing, the reference's
  // NA semantics — io/guard.py feature_value mirrors this), inf /
  // infinity -> inf.  Only the EXACT spellings consume; any other
  // alpha run is left unconsumed so the callers' whole-token checks
  // flag the row as malformed.
  if (!consumed && p < end &&
      (*p == 'n' || *p == 'N' || *p == 'i' || *p == 'I')) {
    const char* w = p;
    while (w < end && std::isalpha(static_cast<unsigned char>(*w))) ++w;
    if (is_na_word(p, w)) {
      value = std::numeric_limits<double>::quiet_NaN();
      consumed = true;
      p = w;
    } else if (is_inf_word(p, w)) {
      value = std::numeric_limits<double>::infinity();
      consumed = true;
      p = w;
    }
  }
  // Degenerate tokens ("-", "+", ".", "-."): nothing numeric was
  // consumed — rewind to the token start so the callers' whole-token
  // checks see leftover chars and flag the row instead of accepting
  // a phantom 0.0 (Python classifies these; parity).
  *out = consumed ? p : token_start;
  return neg ? -value : value;
}

inline long parse_long(const char* p, const char* end, const char** out) {
  p = skip_space(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  long v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  *out = p;
  return neg ? -v : v;
}

// Does the first whitespace-delimited token contain ':'?  LibSVM rows whose
// first token is an index:value pair have no label (parser.py:67-71).
inline bool first_token_has_colon(const char* p, const char* e) {
  p = skip_space(p, e);
  while (p < e && *p != ' ' && *p != '\t') {
    if (*p == ':') return true;
    ++p;
  }
  return false;
}

struct LineIndex {
  std::vector<const char*> begin;
  std::vector<const char*> end;
};

// Split the buffer into lines (dropping \r), single pass.
LineIndex index_lines(const char* data, size_t size) {
  LineIndex idx;
  idx.begin.reserve(size / 64 + 1);
  idx.end.reserve(size / 64 + 1);
  const char* p = data;
  const char* bufend = data + size;
  while (p < bufend) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(bufend - p)));
    const char* e = nl ? nl : bufend;
    const char* line_end = e;
    if (line_end > p && line_end[-1] == '\r') --line_end;
    if (line_end > p) {  // skip empty lines like TextReader does
      idx.begin.push_back(p);
      idx.end.push_back(line_end);
    }
    p = nl ? nl + 1 : bufend;
  }
  return idx;
}

int detect_format(const LineIndex& idx, size_t probe) {
  // 0 = csv, 1 = tsv, 2 = libsvm (parser.cpp:10-72)
  size_t n = std::min(probe, idx.begin.size());
  long commas = 0, tabs = 0, colons = 0;
  for (size_t i = 0; i < n; ++i) {
    for (const char* p = idx.begin[i]; p < idx.end[i]; ++p) {
      commas += (*p == ',');
      tabs += (*p == '\t');
      colons += (*p == ':');
    }
  }
  if (colons > 0 && colons >= std::max(commas, tabs)) return 2;
  if (tabs >= commas) return 1;
  return 0;
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = static_cast<int>(std::max(1u, hw));
  if (n < 4096 || nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Parse a delimited/libsvm text file into a dense row-major [num_rows,
// num_cols] float64 matrix (caller-owned via lgbt_free) with the label
// column split out.  Returns 0 on success.
//   fmt_out: detected format (0 csv / 1 tsv / 2 libsvm)
//   num_cols = feature columns (label excluded)
//   first_bad_row_out: 1-based ordinal (among parsed data rows) of the
//     first malformed row — unparseable token, ragged field count, or a
//     bad LibSVM column index — or -1 when the file is clean.  The
//     native loader only *flags* dirt; the Python wrapper re-parses
//     flagged files through io/guard.py for classification, per-line
//     diagnostics, and the fail-fast/quarantine policy.
int lgbt_parse_file(const char* path, int has_header, int label_idx,
                    double** data_out, double** label_out,
                    int64_t* num_rows_out, int64_t* num_cols_out,
                    int* fmt_out, int64_t* first_bad_row_out) {
  *first_bad_row_out = -1;
  FILE* fh = fopen(path, "rb");
  if (!fh) return 1;
  fseek(fh, 0, SEEK_END);
  long fsize = ftell(fh);
  fseek(fh, 0, SEEK_SET);
  // +1 terminator: strtod in parse_double must not scan past the buffer
  std::vector<char> buf(static_cast<size_t>(fsize) + 1, '\0');
  if (fsize > 0 && fread(buf.data(), 1, static_cast<size_t>(fsize), fh) !=
                       static_cast<size_t>(fsize)) {
    fclose(fh);
    return 2;
  }
  fclose(fh);

  // Index only the true file bytes — buf has a +1 NUL terminator for the
  // float parser, and including it would turn the terminator into a phantom
  // 1-char final line (a bogus all-zero row on every newline-terminated file).
  LineIndex idx = index_lines(buf.data(), static_cast<size_t>(fsize));
  size_t first_row = has_header ? 1 : 0;
  if (idx.begin.size() <= first_row) {
    *num_rows_out = 0;
    *num_cols_out = 0;
    return 3;
  }
  int fmt = detect_format(idx, first_row + 32);
  *fmt_out = fmt;
  int64_t nrows = static_cast<int64_t>(idx.begin.size() - first_row);
  char delim = fmt == 0 ? ',' : '\t';

  // ---- column count from a probe pass (max over first rows + libsvm full
  // max-index scan, dataset_loader SetHeader role) ------------------------
  int64_t ncols = 0;
  if (fmt == 2) {
    std::atomic<int64_t> max_idx{-1};
    parallel_for(nrows, [&](int64_t lo, int64_t hi) {
      int64_t local = -1;
      for (int64_t r = lo; r < hi; ++r) {
        const char* p = idx.begin[first_row + r];
        const char* e = idx.end[first_row + r];
        const char* q;
        // A first token containing ':' is an index:value pair — the row has
        // no label (standard predict-time LibSVM; parser.py:67-71).
        if (!first_token_has_colon(p, e)) {
          const char* tok = skip_space(p, e);
          const char* tok_end = tok;
          while (tok_end < e && *tok_end != ' ' && *tok_end != '\t')
            ++tok_end;
          parse_double(tok, tok_end, &q);  // skip label
          p = tok_end;
        }
        while (p < e) {
          p = skip_space(p, e);
          if (p >= e) break;
          const char* tok_end = p;
          while (tok_end < e && *tok_end != ' ' && *tok_end != '\t')
            ++tok_end;
          // Only a FULLY valid digits:value token may raise the column
          // count — a malformed row must not inflate the matrix
          // allocation (the fill pass flags it for the Python path).
          const char* d = p;
          long k = 0;
          bool digits = false;
          while (d < tok_end && *d >= '0' && *d <= '9') {
            k = k * 10 + (*d - '0');
            digits = true;
            ++d;
            if (k > (1L << 31)) {  // absurd index: corrupt, not a column
              digits = false;
              break;
            }
          }
          if (digits && d < tok_end && *d == ':' && d + 1 < tok_end) {
            parse_double(d + 1, tok_end, &q);
            if (q == tok_end && k > local) local = k;
          }
          p = tok_end;
        }
      }
      int64_t cur = max_idx.load();
      while (local > cur && !max_idx.compare_exchange_weak(cur, local)) {
      }
    });
    ncols = max_idx.load() + 1;
  } else {
    // delimiter count on the first data line
    const char* p = idx.begin[first_row];
    const char* e = idx.end[first_row];
    int64_t fields = 1;
    for (; p < e; ++p) fields += (*p == delim);
    if (label_idx >= fields) return 5;  // caller falls back to Python
    ncols = fields - (label_idx >= 0 ? 1 : 0);
  }
  if (ncols < 0) ncols = 0;

  double* data =
      static_cast<double*>(malloc(sizeof(double) * nrows * ncols));
  double* label = static_cast<double*>(malloc(sizeof(double) * nrows));
  if (!data || !label) {
    free(data);
    free(label);
    return 4;
  }
  // label_idx < 0 means "no label column": leave labels at zero
  memset(label, 0, sizeof(double) * nrows);

  // first malformed data row (1-based ordinal), min across threads
  std::atomic<int64_t> first_bad{-1};
  auto flag_bad = [&first_bad](int64_t r) {
    int64_t ord = r + 1;
    int64_t cur = first_bad.load();
    while ((cur < 0 || ord < cur) &&
           !first_bad.compare_exchange_weak(cur, ord)) {
    }
  };
  // A numeric token must consume its WHOLE field — leftover chars
  // (after trailing spaces) mean garbage like "1.5x" or "abc".
  auto fully_parsed = [](const char* q, const char* fe) {
    q = skip_space(q, fe);
    return q == fe;
  };

  if (fmt == 2) {
    parallel_for(nrows, [&](int64_t lo, int64_t hi) {
      for (int64_t r = lo; r < hi; ++r) {
        const char* p = idx.begin[first_row + r];
        const char* e = idx.end[first_row + r];
        double* row = data + r * ncols;
        memset(row, 0, sizeof(double) * ncols);
        const char* q;
        bool bad = false;
        if (first_token_has_colon(p, e)) {
          label[r] = 0.0;  // label-less row (predict-time LibSVM)
        } else {
          const char* tok = skip_space(p, e);
          const char* tok_end = tok;
          while (tok_end < e && *tok_end != ' ' && *tok_end != '\t')
            ++tok_end;
          label[r] = parse_double(tok, tok_end, &q);
          bad = bad || (tok_end > tok && q != tok_end);
          p = tok_end;
        }
        while (p < e && !bad) {
          p = skip_space(p, e);
          if (p >= e) break;
          const char* tok_end = p;
          while (tok_end < e && *tok_end != ' ' && *tok_end != '\t')
            ++tok_end;
          // index: one or more bare digits (a leading '-' is the
          // negative-column corruption the guard classifies)
          const char* d = p;
          long k = 0;
          bool digits = false;
          while (d < tok_end && *d >= '0' && *d <= '9') {
            k = k * 10 + (*d - '0');
            digits = true;
            ++d;
            if (k > (1L << 31)) {  // absurd index: corrupt, not a column
              digits = false;
              break;
            }
          }
          if (!digits || d >= tok_end || *d != ':' || k >= ncols) {
            bad = true;
            break;
          }
          double v = parse_double(d + 1, tok_end, &q);
          if (d + 1 == tok_end || q != tok_end) {
            bad = true;  // empty or partially-consumed value token
            break;
          }
          row[k] = v;
          p = tok_end;
        }
        if (bad) flag_bad(r);
      }
    });
  } else {
    // expected field count: from the first data line (the probe above)
    const int64_t fields_expected =
        ncols + (label_idx >= 0 ? 1 : 0);
    parallel_for(nrows, [&](int64_t lo, int64_t hi) {
      for (int64_t r = lo; r < hi; ++r) {
        const char* p = idx.begin[first_row + r];
        const char* e = idx.end[first_row + r];
        double* row = data + r * ncols;
        int64_t col = 0;       // column in file incl. label position
        int64_t feat = 0;      // feature column
        bool bad = false;
        while (p <= e) {
          const char* field_end = static_cast<const char*>(
              memchr(p, delim, static_cast<size_t>(e - p)));
          if (!field_end) field_end = e;
          const char* fs = skip_space(p, field_end);
          const char* q;
          double v;
          if (fs == field_end) {
            // empty field: missing value (io/guard.py feature_value)
            v = std::numeric_limits<double>::quiet_NaN();
          } else {
            v = parse_double(fs, field_end, &q);
            if (!fully_parsed(q, field_end)) bad = true;
          }
          if (col == label_idx) {
            label[r] = v;
          } else if (feat < ncols) {
            row[feat++] = v;
          }
          ++col;
          p = field_end + 1;
          if (field_end == e) break;
        }
        if (col != fields_expected) bad = true;  // ragged row
        while (feat < ncols) row[feat++] = 0.0;
        if (bad) flag_bad(r);
      }
    });
  }

  *data_out = data;
  *label_out = label;
  *num_rows_out = nrows;
  *num_cols_out = ncols;
  *first_bad_row_out = first_bad.load();
  return 0;
}

void lgbt_free(void* p) { free(p); }

// Vectorized ValueToBin for a numerical feature (bin.h:385-407): for each
// value, the index of the first upper bound >= value (bounds[num_bin-1] is
// +inf).  Multithreaded over rows; writes uint8 or uint16 depending on
// out_is_u16.
void lgbt_values_to_bins(const double* values, int64_t n,
                         const double* upper_bounds, int num_bin,
                         uint8_t* out8, uint16_t* out16, int out_is_u16) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double v = values[i];
      // binary search: first bound >= v among bounds[0..num_bin-2]
      int l = 0, r = num_bin - 1;  // bounds[num_bin-1] = +inf catches rest
      while (l < r) {
        int m = (l + r) / 2;
        if (upper_bounds[m] < v) {
          l = m + 1;
        } else {
          r = m;
        }
      }
      if (out_is_u16) {
        out16[i] = static_cast<uint16_t>(l);
      } else {
        out8[i] = static_cast<uint8_t>(l);
      }
    }
  });
}

}  // extern "C"
