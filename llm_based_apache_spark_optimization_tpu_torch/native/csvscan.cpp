// CSV schema-inference scanner: the native data-loader core.
//
// Role parity: the reference loads CSVs with Spark's `inferSchema=True`,
// which costs a dedicated native type-inference pass over the whole file
// before the data pass (SURVEY.md §3.1 "TWO file scans"). Here that scan is
// this C++ pass; the Python side (sql/sqlite_backend.py) keeps the data
// pass. Classification rules replicate `_infer_dtype` exactly — the Python
// implementation is the behavioral reference, asserted equal in
// tests/test_torch_native.py:
//
//   per value: int (incl. +/- sign, surrounding blanks) -> int, else float
//   (strtod: accepts inf/nan like Python float()) -> double, else ISO
//   date/datetime -> timestamp, else the column is terminally string.
//   Column verdict: any float => double; ints only => bigint iff
//   |v| > INT32_MAX ever, else int; timestamps only => timestamp.
//
// CSV parsing is RFC 4180: quoted fields, "" escapes, embedded
// commas/newlines; rows with more columns than the header are an error
// (-2), matching the loader's strictness.

#include "text.h"

#include <cctype>
#include <cinttypes>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ColState {
  bool saw_int = false, saw_float = false, saw_ts = false, is_string = false;
  bool big = false; // |int| exceeded INT32_MAX
};

bool all_blank(const char *s, size_t n) {
  for (size_t i = 0; i < n; ++i)
    if (!isspace(static_cast<unsigned char>(s[i]))) return false;
  return true;
}

bool parse_int(const std::string &v, bool *big) {
  const char *s = v.c_str();
  char *end = nullptr;
  errno = 0;
  long long x = strtoll(s, &end, 10);
  if (end == s) return false;
  while (*end && isspace(static_cast<unsigned char>(*end))) ++end;
  if (*end) return false;
  // Python's threshold is |v| > 2**31-1, so -2147483648 already counts big.
  if (errno == ERANGE || x > 2147483647LL || x < -2147483647LL) *big = true;
  return true;
}

bool parse_float(const std::string &v) {
  const char *s = v.c_str();
  char *end = nullptr;
  strtod(s, &end);
  if (end == s) return false;
  while (*end && isspace(static_cast<unsigned char>(*end))) ++end;
  return *end == '\0';
}

bool digits(const char *&p, int n) {
  for (int i = 0; i < n; ++i)
    if (!isdigit(static_cast<unsigned char>(*p++))) return false;
  return true;
}

// ^\d{4}-\d{2}-\d{2}([ T]\d{2}:\d{2}(:\d{2}(\.\d+)?)?)?$ on the trimmed value.
bool parse_timestamp(const std::string &v) {
  size_t a = 0, b = v.size();
  while (a < b && isspace(static_cast<unsigned char>(v[a]))) ++a;
  while (b > a && isspace(static_cast<unsigned char>(v[b - 1]))) --b;
  std::string t = v.substr(a, b - a);
  const char *p = t.c_str();
  if (!digits(p, 4) || *p++ != '-' || !digits(p, 2) || *p++ != '-' ||
      !digits(p, 2))
    return false;
  if (*p == '\0') return true;
  if (*p != ' ' && *p != 'T') return false;
  ++p;
  if (!digits(p, 2) || *p++ != ':' || !digits(p, 2)) return false;
  if (*p == '\0') return true;
  if (*p++ != ':') return false;
  if (!digits(p, 2)) return false;
  if (*p == '\0') return true;
  if (*p++ != '.') return false;
  if (!isdigit(static_cast<unsigned char>(*p))) return false;
  while (isdigit(static_cast<unsigned char>(*p))) ++p;
  return *p == '\0';
}

void classify(const std::string &v, ColState &c) {
  if (c.is_string || v.empty() || all_blank(v.c_str(), v.size())) {
    // Python: "" skips; int(" ")/float(" ") raise and " " isn't a timestamp,
    // so an all-blank non-empty value is string. Match that exactly:
    if (!v.empty() && all_blank(v.c_str(), v.size())) c.is_string = true;
    return;
  }
  if (parse_int(v, &c.big)) {
    c.saw_int = true;
    return;
  }
  if (parse_float(v)) {
    c.saw_float = true;
    return;
  }
  if (parse_timestamp(v)) {
    c.saw_ts = true;
    return;
  }
  c.is_string = true;
}

// Dtype codes shared with the Python side (sql/sqlite_backend.py).
enum { DT_STRING = 0, DT_INT = 1, DT_BIGINT = 2, DT_DOUBLE = 3, DT_TS = 4 };

int32_t verdict(const ColState &c) {
  // Mirrors _infer_dtype's verdict order exactly: timestamps win only when
  // the column is timestamps-only; a ts+numeric mix falls through to the
  // numeric verdicts (Python's branch order does the same).
  if (c.is_string) return DT_STRING;
  if (c.saw_ts && !(c.saw_int || c.saw_float)) return DT_TS;
  if (c.saw_float) return DT_DOUBLE;
  if (c.saw_int) return c.big ? DT_BIGINT : DT_INT;
  return DT_STRING;
}

} // namespace

extern "C" {

/* Scan `path`: infer per-column dtypes over all data rows (header skipped).
 * Writes up to max_cols codes into dtypes and the data-row count into
 * n_rows. Returns the column count, -1 on I/O error, -2 on a row wider
 * than the header, -3 if the header alone exceeds max_cols. */
int32_t lsot_csv_scan(const char *path, int32_t *dtypes, int32_t max_cols,
                      int64_t *n_rows) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;

  std::vector<ColState> cols;
  std::string field;
  int32_t n_cols = -1; // set after the header record
  int col = 0;
  bool in_quotes = false, header_done = false, row_has_data = false;
  int64_t rows = 0;
  bool too_wide = false;

  auto end_field = [&]() {
    if (header_done) {
      if (col < static_cast<int>(cols.size())) classify(field, cols[col]);
      else too_wide = true;
    }
    field.clear();
    ++col;
  };
  auto end_record = [&]() {
    end_field();
    if (!header_done) {
      n_cols = col;
      header_done = true;
      cols.resize(n_cols);
    } else {
      ++rows;
    }
    col = 0;
    row_has_data = false;
  };

  int ci;
  while ((ci = fgetc(f)) != EOF && !too_wide) {
    char c = static_cast<char>(ci);
    if (in_quotes) {
      if (c == '"') {
        int nxt = fgetc(f);
        if (nxt == '"') {
          field += '"';
        } else {
          in_quotes = false;
          if (nxt != EOF) ungetc(nxt, f);
        }
      } else {
        field += c;
      }
      continue;
    }
    switch (c) {
    case '"':
      in_quotes = true;
      row_has_data = true;
      break;
    case ',':
      end_field();
      row_has_data = true;
      break;
    case '\r':
      break; // CRLF: handled at the \n
    case '\n':
      if (row_has_data || !field.empty() || col > 0) end_record();
      break;
    default:
      field += c;
      row_has_data = true;
    }
  }
  if (row_has_data || !field.empty() || col > 0) end_record();
  fclose(f);

  if (too_wide) return -2;
  if (n_cols < 0) return -1; // empty file
  if (n_cols > max_cols) return -3;
  for (int i = 0; i < n_cols; ++i) dtypes[i] = verdict(cols[i]);
  *n_rows = rows;
  return n_cols;
}

} // extern "C"
